"""The full-width configuration and the seeded synthetic frames that
`chip_smoke.py` runs.

The configuration is the JAX package's `configs/crowdhuman.yaml` (SAM ViT-L,
DINOv2 ViT-L/14, PWD-Net, bf16; its knobs equal the DEFAULTS, among them
`test.output_rles true` and `tpu.fused_decode true`) with seeded random
weights: no checkpoints ship with the repository.

`crowd_scene` is this package's copy of the JAX bench fixture's crowd scene
(`crowdsam_tpu/utils/bench_fixture.py`): smooth background noise with drawn
person silhouettes.  Its background upsample is PIL's 8-bit BILINEAR
written out in numpy (`ops/transforms.stretch_bilinear`), so a frame
equals the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.ops.transforms import stretch_bilinear

# CrowdHuman-like frames (h, w): landscape 3:2, portrait 4:3, landscape
# 4:3, square.
FRAME_SIZES = ((683, 1024), (1024, 768), (768, 1024), (1024, 1024))


def full_width_config() -> Dict:
    return modify_config(load_config(None), [
        "model.sam_checkpoint", "", "model.dino_checkpoint", "",
        "model.sam_adapter_checkpoint", "",
    ])


def synthetic_images(seed: int, n: int = len(FRAME_SIZES)) -> List[np.ndarray]:
    """Smooth uint8 frames: 32-px blocks of seeded colour plus noise."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in FRAME_SIZES[:n]:
        coarse = rng.integers(0, 255, (h // 32 + 2, w // 32 + 2, 3))
        img = np.repeat(np.repeat(coarse, 32, axis=0), 32, axis=1)[:h, :w]
        img = img + rng.integers(-20, 20, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _draw_person(img: np.ndarray, x: int, y: int, w: int, h: int,
                 rng: np.random.Generator) -> None:
    """Paint a head circle and a body ellipse in one seeded colour."""
    hh, ww = img.shape[:2]
    color = rng.integers(40, 255, size=3)
    yy, xx = np.mgrid[0:hh, 0:ww]
    hr = max(2, w // 4)
    hcx, hcy = x + w // 2, y + hr + 1
    head = (xx - hcx) ** 2 + (yy - hcy) ** 2 <= hr * hr
    tcy = y + 2 * hr + (h - 2 * hr) // 2
    a, b = max(2, w // 2), max(2, (h - 2 * hr) // 2)
    body = ((xx - hcx) / a) ** 2 + ((yy - tcy) / b) ** 2 <= 1.0
    m = head | body
    img[m] = (0.85 * color + 0.15 * img[m]).astype(np.uint8)


def crowd_scene(seed: int, h: int = 683, w: int = 1024,
                people: Tuple[int, int] = (22, 30)):
    """A seeded crowd scene of `people` drawn persons (the upper bound
    exclusive).  Returns (HWC uint8 image, [(x, y, w, h), ...])."""
    rng = np.random.default_rng(seed)
    base = rng.integers(60, 180, size=(h // 64 + 2, w // 64 + 2, 3))
    img = stretch_bilinear(base.astype(np.uint8), (h, w)).astype(np.float32)
    img += rng.normal(0, 6.0, size=img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    n = int(rng.integers(*people))
    boxes = []
    for _ in range(n):
        ph = int(rng.integers(max(40, h // 12), max(60, h // 3)))
        pw = max(12, int(ph * rng.uniform(0.34, 0.52)))
        x = int(rng.integers(0, max(1, w - pw)))
        y = int(rng.integers(0, max(1, h - ph)))
        _draw_person(img, x, y, pw, ph, rng)
        boxes.append((x, y, pw, ph))
    return img, boxes
