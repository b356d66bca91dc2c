"""Config tree: defaults, dotted-key overrides and a lazy YAML load.

Same keys and defaults as the JAX package's config (reference
`crowdsam/utils.py:31-58`).  `yaml` is imported only when a file is given,
so the port runs where PyYAML is absent.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import torch

DEFAULTS: Dict[str, Any] = {
    "environ": {
        "seed": 42,
        "device": "tpu",
        "output_dir": "./outputs/crowdsam_vis",
    },
    "data": {
        "dataset": "crowdhuman",
        "dataset_root": "./dataset/crowdhuman",
        "json_file": "./dataset/crowdhuman/val_visible.json",
        "train_file": "./dataset/crowdhuman/train_crowdhuman_10shot.json",
        "odgt_file": "./dataset/crowdhuman/annotation_val.odgt",
    },
    "model": {
        "dino_checkpoint": "./weights/dinov2_vitl14_pretrain.pth",
        "dino_model": "dinov2_vitl14",
        "sam_checkpoint": "./weights/sam_vit_l_0b3195.pth",
        "sam_model": "vit_l",
        "sam_arch": "crowdsam",
        "sam_adapter_checkpoint": "./adapter_weights/10_shot.pth",
        "n_class": 1,
        "max_size": 1024,
        "trainfree": False,
        "ref_feature": "",
        "score_fusion": 0.25,
    },
    "train": {
        "n_shot": 10,
        "seed": 1,
        "samples_per_batch": 30,
        "neg_factor": 1,
        "steps": 2000,
        "lr": 0.00001,
        "optimizer": "adamw",
        "weight_decay": 0.0001,
        "save_path": "adapter_weights/10_shot.msgpack",
    },
    "test": {
        "output_rles": True,
        "crop_n_layers": 0,
        "crop_nms_thresh": 0.7,
        "crop_overlap_ratio": 0.341,
        "pos_sim_thresh": 0.5,
        "apply_box_offsets": False,
        "grid_size": 192,
        "max_prompts": 500,
        "filter_thresh": 0.7,
        "points_per_batch": 32,
        "mask_selection": "max_iou",
        "max_size": 1024,
        "fuse_simmap": False,
        "min_mask_region_area": 100,
        "box_nms_thresh": 0.65,
        "stability_score_thresh": 0.8,
        "stability_score_offset": 1,
        "pred_iou_thresh": 0.1,
    },
    "vis": {"vis_thresh": 0.6},
    # Knobs without a reference equivalent (section name kept from the JAX
    # package so one config file drives both).
    "tpu": {
        "compute_dtype": "bfloat16",
        "param_dtype": "float32",
        "accumulate_occupy": False,
        "mesh_data": 1,
        "mesh_model": 1,
        "cc_max_iters": 256,
        "rect_encode": False,
    },
}


def _deep_update(base: Dict[str, Any], upd: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_config(config_file: str | None = None) -> Dict[str, Any]:
    """Defaults, overlaid with a YAML file when one is given."""
    config = copy.deepcopy(DEFAULTS)
    if config_file:
        import yaml

        with open(config_file, "r") as f:
            user = yaml.safe_load(f) or {}
        _deep_update(config, user)
    return config


def convert_value(value: str) -> Any:
    """Coerce a CLI string to bool/int/float/str."""
    if value.lower() in {"true", "false"}:
        return value.lower() == "true"
    try:
        return int(value)
    except ValueError:
        try:
            return float(value)
        except ValueError:
            return value


def modify_config(config: Dict[str, Any], options: List[str]) -> Dict[str, Any]:
    """Apply ``key.subkey value`` override pairs."""
    if len(options) % 2:
        raise ValueError("options must come in key/value pairs")
    for key, value in zip(options[0::2], options[1::2]):
        parts = key.split(".")
        d = config
        for k in parts[:-1]:
            d = d.setdefault(k, {})
        d[parts[-1]] = convert_value(value)
    return config


def resolve_device(device=None, index=None) -> torch.device:
    """The entry points' device: CUDA (card `index` where given) unless
    the caller names another.

    With no device given and no CUDA present this raises; the CPU is used
    only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda", index)
    return torch.device(device)


def dtype_from_str(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
