"""10-shot adapter training from the command line:

    python -m crowdsam_tpu_torch.train [--config_file FILE] [--device DEV]
                                       [key value ...]

The counterpart of the JAX package's `tools/train.py`, with its flags: the
model of the config without the adapter (the SAM and DINOv2 checkpoints
where they exist, else the JAX package's random weights; DINOv2 drawn from
seed 0, as that CLI draws it), trained on `data.train_file` (the
synthetic 10-shot set when the file is absent), the whole mask decoder
saved to `train.save_path` as the JAX package saves it (flax msgpack).
Runs on CUDA unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="CrowdSAM adapter training")
    parser.add_argument("--config_file", default="configs/crowdhuman.yaml")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--device", default=None)
    parser.add_argument("options", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from crowdsam_tpu_torch.config import (
        load_config,
        modify_config,
        resolve_device,
    )
    from crowdsam_tpu_torch.pipeline.crowdsam import build_models
    from crowdsam_tpu_torch.pipeline.predictor import SamPredictor
    from crowdsam_tpu_torch.train.dataset import CrowdHumanDataset
    from crowdsam_tpu_torch.train.trainer import (
        AdapterTrainer,
        split_adapter_params,
    )
    from crowdsam_tpu_torch.utils import msgpack_io
    from crowdsam_tpu_torch.utils.fixtures import ten_shot_dataset

    config = modify_config(load_config(args.config_file), args.options)
    np.random.seed(config["train"]["seed"])
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    logger = logging.getLogger("crowdsam_tpu_torch")
    device = resolve_device(args.device)
    sam, dino = build_models(config, device, dino_seed=0, load_adapter=False,
                             logger=logger)
    trainer = AdapterTrainer(config, SamPredictor(sam, dino, device), logger)
    adapter, _ = split_adapter_params(dict(sam.mask_decoder.state_dict()))
    print("total learnable parameters:",
          sum(v.numel() for v in adapter.values()))

    train_file = config["data"]["train_file"]
    if os.path.exists(train_file):
        dataset = CrowdHumanDataset(config["data"]["dataset_root"],
                                    train_file)
    else:
        dataset = ten_shot_dataset(logger)
    trainer.train(dataset)
    msgpack_io.save(config["train"]["save_path"], trainer.decoder_tree())
    logger.info("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
