"""The synthetic 10-shot training set.

Counterpart of the JAX package's `utils/fixtures.py`: ten CrowdHuman-sized
frames of textured background with person-shaped blobs, their boxes drawn
to the statistics of the reference's bundled 10-shot set, in the
reference's COCO schema.  `ten_shot_arrays` gives, with numpy alone, the
exact arrays and boxes that the JAX package's `generate_ten_shot` hands to
PIL; `generate_ten_shot` / `ensure_ten_shot` write them as JPEGs (PIL
imported only there).  The committed decoders were trained on the JPEG
frames, which differ from the arrays by the JPEG round trip; the arrays
are the stand-in on machines without PIL.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

from crowdsam_tpu_torch.utils.synthetic import _draw_person

ANNOT_NAME = "train_crowdhuman_10shot.json"
DEFAULT_ROOT = os.path.join("data", "crowdhuman_train")

# CrowdHuman-like (width, height) pairs.
_SIZES = [
    (1280, 720), (1024, 681), (1360, 907), (900, 675), (1280, 853),
    (1200, 800), (1024, 768), (1152, 864), (1280, 960), (1361, 768),
]


def ten_shot_arrays(seed: int = 0, n_images: int = 10,
                    people_per_image: tuple = (9, 47)
                    ) -> Tuple[List[np.ndarray], List[List[Tuple]]]:
    """(HWC uint8 frames, [[(x, y, w, h), ...] per frame]) from one seeded
    stream: boxes per frame uniform in `people_per_image`, heights
    lognormal around 0.16 of the frame, aspect 0.31-0.52, every third box a
    companion jittered around the previous one (crowding)."""
    rng = np.random.default_rng(seed)
    images, boxes = [], []
    for idx in range(n_images):
        W, H = _SIZES[idx % len(_SIZES)]
        base = rng.integers(60, 180, size=(H // 32 + 2, W // 32 + 2, 3))
        img = np.kron(base, np.ones((32, 32, 1))).astype(np.float32)
        img = img[:H, :W]
        img += rng.normal(0, 6.0, size=img.shape)
        img = np.clip(img, 0, 255).astype(np.uint8)
        n_people = int(rng.integers(*people_per_image))
        prev = None
        frame_boxes = []
        for pi in range(n_people):
            if prev is not None and pi % 3 == 1:
                px, py, pw, ph = prev
                h = max(24, int(ph * rng.uniform(0.85, 1.15)))
                w = max(10, int(h * rng.uniform(0.31, 0.52)))
                x = int(np.clip(px + rng.integers(-pw, pw + 1),
                                0, max(1, W - w)))
                y = int(np.clip(py + rng.integers(-ph // 6, ph // 6 + 1),
                                0, max(1, H - h)))
            else:
                rel_h = float(np.clip(rng.lognormal(np.log(0.16), 0.72),
                                      0.05, 0.6))
                h = max(24, int(rel_h * H))
                w = max(10, int(h * rng.uniform(0.31, 0.52)))
                x = int(rng.integers(0, max(1, W - w)))
                y = int(rng.integers(0, max(1, H - h)))
            prev = (x, y, w, h)
            _draw_person(img, x, y, w, h, rng)
            frame_boxes.append((x, y, w, h))
        images.append(img)
        boxes.append(frame_boxes)
    return images, boxes


def generate_ten_shot(root: str, n_images: int = 10, seed: int = 0,
                      people_per_image: tuple = (9, 47)) -> str:
    """Write Images/*.jpg and the COCO json of `ten_shot_arrays` under
    `root`; returns `root`."""
    from PIL import Image

    img_dir = os.path.join(root, "Images")
    os.makedirs(img_dir, exist_ok=True)
    frames, boxes = ten_shot_arrays(seed, n_images, people_per_image)
    images, annotations = [], []
    ann_id = 1
    for idx, (img, frame_boxes) in enumerate(zip(frames, boxes)):
        for x, y, w, h in frame_boxes:
            annotations.append({"category_id": 1, "bbox": [x, y, w, h],
                                "image_id": idx, "iscrowd": False,
                                "area": int(w * h), "id": ann_id,
                                "ignore": 0})
            ann_id += 1
        fname = f"synthetic_{idx:02d}.jpg"
        Image.fromarray(img).save(os.path.join(img_dir, fname), quality=90)
        images.append({"file_name": fname, "height": img.shape[0],
                       "width": img.shape[1], "id": idx})
    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [
            {"supercategory": "person", "id": 1, "name": "person"},
            {"supercategory": "mask", "id": 2, "name": "mask"},
        ],
    }
    with open(os.path.join(root, ANNOT_NAME), "w") as f:
        json.dump(coco, f)
    return root


def ensure_ten_shot(root: str = DEFAULT_ROOT, logger=None) -> str:
    """Generate the set under `root` unless its json exists; returns
    `root`."""
    if not os.path.exists(os.path.join(root, ANNOT_NAME)):
        if logger is not None:
            logger.warning("dataset not found; generating synthetic 10-shot "
                           "fixtures under %s", root)
        generate_ten_shot(root)
    return root


def ten_shot_dataset(logger=None):
    """The 10-shot set: the JPEGs under `DEFAULT_ROOT` (written first if
    absent) where PIL is installed, else the arrays in memory."""
    import importlib.util

    from crowdsam_tpu_torch.train.dataset import ArrayDataset, \
        CrowdHumanDataset

    if importlib.util.find_spec("PIL") is None:
        return ArrayDataset(*ten_shot_arrays(0))
    root = ensure_ten_shot(logger=logger)
    return CrowdHumanDataset(root, os.path.join(root, ANNOT_NAME))
