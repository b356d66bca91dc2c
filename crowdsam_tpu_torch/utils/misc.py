"""Miscellaneous helpers from the reference utility surface.

Contracts: reference `crowdsam/utils.py` — select_box (:396-408),
is_validbox (:392-394), average_metric (:614-616), mask2coord/coords2mask
(:411-420), clustering_matched_points / composite_clustering (:252-263,
314-320; k-means prompt clustering, an alternative prompt-selection scheme
referenced by the EPS code path).  Implemented in numpy (no sklearn
dependency; plain Lloyd iterations with a fixed seed).  This package's own
copy of the JAX package's `utils/misc.py`.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def is_validbox(box) -> bool:
    return box[2] > box[0] and box[3] > box[1]


def select_box(boxes: np.ndarray, mode: str = "big") -> int:
    wh = boxes[:, 2:] - boxes[:, :2]
    area = wh[:, 0] * wh[:, 1]
    if mode == "big":
        return int(area.argmax())
    if mode == "small":
        return int(area.argmin())
    if mode == "random":
        return int(np.random.choice(np.arange(len(area)), 1)[0])
    raise NotImplementedError(mode)


def average_metric(result: Sequence[dict], key: str) -> float:
    metrics = [item[key] for item in result]
    return round(float(sum(metrics) / len(metrics)), 3)


def mask2coord(mask: np.ndarray) -> np.ndarray:
    """(H, W) bool -> (N, 2) row/col indices of nonzero pixels."""
    return np.stack(np.nonzero(mask), axis=-1)


def coords2mask(coords: np.ndarray) -> np.ndarray:
    """(N, 2) xy coords -> bool mask sized to the max coordinate."""
    coords = np.asarray(coords, dtype=np.int64)
    width, height = coords.max(axis=0)
    mask = np.zeros((int(height) + 1, int(width) + 1), dtype=bool)
    mask[coords[:, 1], coords[:, 0]] = True
    return mask


def kmeans(coords: np.ndarray, k: int, iters: int = 50, seed: int = 9):
    """Plain Lloyd k-means -> (centroids (k,2), labels (N,))."""
    rng = np.random.default_rng(seed)
    coords = np.asarray(coords, dtype=np.float64)
    centroids = coords[rng.choice(len(coords), k, replace=False)]
    labels = np.zeros(len(coords), dtype=np.int64)
    for _ in range(iters):
        d = ((coords[:, None, :] - centroids[None]) ** 2).sum(-1)
        new_labels = d.argmin(axis=1)
        if (new_labels == labels).all():
            break
        labels = new_labels
        for j in range(k):
            sel = coords[labels == j]
            if len(sel):
                centroids[j] = sel.mean(axis=0)
    return centroids, labels


def clustering_matched_points(coords: np.ndarray, num_cluster: int) -> np.ndarray:
    """Cluster candidate points into centroids (reference :252-263)."""
    assert num_cluster >= 1
    coords = np.asarray(coords, dtype=np.float64)
    if len(coords) == 0:
        return np.zeros((0, 2))
    num_cluster = min(len(coords), num_cluster)
    centroids, labels = kmeans(coords, num_cluster)
    out = [coords[labels == i].mean(axis=0) for i in range(labels.max() + 1)]
    return np.stack(out, axis=0)


def composite_clustering(coords: np.ndarray, num_prompts: List[int]):
    """Centroid sets at multiple cluster counts (reference :314-320)."""
    return [clustering_matched_points(coords, n) for n in num_prompts]
