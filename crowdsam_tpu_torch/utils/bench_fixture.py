"""The trained bench fixture: the whole mask decoder trained on the
synthetic 10-shot set over the frozen random encoders.

Counterpart of the JAX package's `utils/bench_fixture.py`.  Random-weight
models give degenerate detections; a decoder trained with
`train.full_decoder` learns prompt-conditioned person masks through the
random encoders and gives a CrowdHuman-like load at the reference
thresholds.  The JAX package committed such decoders under
`adapter_weights/` (keyed by recipe, `committed_path_for`), trained on the
encoders that `utils/init.py` draws here too, so they load as they are;
`train_or_load_decoder` trains one on a miss and caches it under `data/`
(machine-local).  The rect encode (`tpu.rect_encode`) changes the features
the decoder trains on, so a model whose predictor encodes rectangles keys
its decoder with `tpu.rect_encode=True` appended to the recipe, as the JAX
package keys it.
"""

from __future__ import annotations

import copy
import hashlib
import os

from crowdsam_tpu_torch.config import modify_config
from crowdsam_tpu_torch.utils import msgpack_io
from crowdsam_tpu_torch.utils.synthetic import crowd_scene  # noqa: F401
from crowdsam_tpu_torch.utils.weights import mask_decoder_state_dict

CACHE_PATH = os.path.join("data", "bench_trained_decoder.msgpack")


def _keyed_name(steps: int, lr: float, recipe: str) -> str:
    tag = "_" + hashlib.sha1(recipe.encode()).hexdigest()[:8] if recipe \
        else ""
    return f"bench_trained_decoder_s{steps}_lr{lr:g}{tag}.msgpack"


def cache_path_for(steps: int, lr: float, recipe: str = "") -> str:
    """The machine-local cache of a recipe; the default (800 steps, lr
    2e-4, no extras) keeps the unkeyed name."""
    if steps == 800 and abs(lr - 2e-4) < 1e-12 and not recipe:
        return CACHE_PATH
    return os.path.join("data", _keyed_name(steps, lr, recipe))


def committed_path_for(steps: int, lr: float, recipe: str = "") -> str:
    """The committed decoder of a recipe, keyed as the cache is."""
    return os.path.join("adapter_weights", _keyed_name(steps, lr, recipe))


def sparse_scene(seed: int, h: int = 683, w: int = 1024):
    """A background-only scene (no drawn people)."""
    img, _ = crowd_scene(seed, h, w, people=(0, 1))
    return img


def mid_scene(seed: int, h: int = 683, w: int = 1024):
    """A mid-density scene of 12-17 drawn people: (image, boxes)."""
    return crowd_scene(seed, h, w, people=(12, 18))


def load_decoder(model, path: str) -> None:
    """Load a `{"mask_decoder": tree}` file into a CrowdSAM's decoder."""
    from crowdsam_tpu_torch.pipeline.crowdsam import _float_leaves

    tree = _float_leaves(msgpack_io.load(path)["mask_decoder"])
    model.sam.mask_decoder.load_state_dict(mask_decoder_state_dict(tree),
                                           strict=False)


def train_or_load_decoder(model, steps: int = 800, lr: float = 2e-4,
                          cache_path: str = None, logger=None,
                          recipe: str = "", dataset=None,
                          train: bool = True) -> dict:
    """Install into `model` (a CrowdSAM) the full decoder of a recipe: the
    committed file first, then the `data/` cache, else train it on the
    10-shot set (`dataset`, default `fixtures.ten_shot_dataset()`) and
    save it to the cache.  `recipe`: comma-separated extra train overrides
    ("train.hard_neg_frac=0.5,train.neg_hinge_weight=16"), part of the key,
    with `tpu.rect_encode=True` appended when the model's predictor
    encodes rectangles and the recipe does not name it.  `train` false:
    raise where there is neither file, in place of training.
    Returns the fixture's metadata."""
    key = recipe
    if getattr(model.predictor, "rect_encode", False) and \
            "tpu.rect_encode" not in key:
        key = (key + "," if key else "") + "tpu.rect_encode=True"
    if cache_path is None:
        cache_path = cache_path_for(steps, lr, key)
    meta = {"trained_steps": steps, "trained_lr": lr}
    if key:
        meta["trained_recipe"] = key
    committed = committed_path_for(steps, lr, key)
    for path, provenance in ((committed, "committed"), (cache_path, "hit")):
        if path and os.path.exists(path):
            load_decoder(model, path)
            meta["trained_cache"] = provenance
            return meta
    if not train:
        raise RuntimeError(
            f"no committed or cached trained decoder ({committed}, "
            f"{cache_path}), and training is refused")

    from crowdsam_tpu_torch.train.trainer import AdapterTrainer
    from crowdsam_tpu_torch.utils.fixtures import ten_shot_dataset

    overrides = ["train.full_decoder", "True", "train.steps", str(steps),
                 "train.lr", str(lr)]
    for pair in filter(None, recipe.split(",")):
        k, _, v = pair.partition("=")
        overrides += [k.strip(), v.strip()]
    cfg = modify_config(copy.deepcopy(model.config), overrides)
    trainer = AdapterTrainer(cfg, model.predictor, logger=logger)
    trainer.train(dataset if dataset is not None else ten_shot_dataset(
        logger))
    if cache_path:
        msgpack_io.save(cache_path, {"mask_decoder": trainer.decoder_tree()})
    meta["trained_cache"] = "miss"
    return meta
