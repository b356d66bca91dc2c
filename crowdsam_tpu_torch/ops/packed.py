"""Packed mask layout: the decoder's 4x upscaled masks without transposes.

Counterpart of the JAX package's `ops/packed.py`.  The mask head upscales
the (h, w) image embedding by 2x twice (2x2 transposed convolutions).  In
the packed layout the two depth-to-space steps stay folded into the last
axis:

    packed[(yb*w + xb), (q1y*2 + q1x)*4 + (q2y*2 + q2x)]
        == spatial[4*yb + 2*q1y + q2y, 4*xb + 2*q1x + q2x]

Axis -2 is the base pixel, axis -1 the first 2x2 quadrant (major) and the
second (minor).  Everything the EPS loop does with masks is either
permutation-invariant (stability score, softmax pooling) or remappable
(boxes, occupancy lookups), so masks stay packed through the loop and only
the rows kept after NMS are unpacked.  Pure index work: exact.
"""

from __future__ import annotations

from typing import Tuple

import torch


def packed_coord_maps(h: int, w: int, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xmap, ymap), each (h*w, 16) int32: the spatial coordinate, in the
    (4h, 4w) frame, of every packed element."""
    b = torch.arange(h * w, dtype=torch.int32, device=device)
    yb, xb = b // w, b % w
    q = torch.arange(4, dtype=torch.int32, device=device)
    qy, qx = q // 2, q % 2
    y = 4 * yb[:, None, None] + 2 * qy[None, :, None] + qy[None, None, :]
    x = 4 * xb[:, None, None] + 2 * qx[None, :, None] + qx[None, None, :]
    return x.reshape(h * w, 16), y.reshape(h * w, 16)


def pack_spatial(x: torch.Tensor) -> torch.Tensor:
    """(..., 4h, 4w) -> (..., h*w, 16) packed."""
    *lead, hh, ww = x.shape
    h, w = hh // 4, ww // 4
    x = x.reshape(*lead, h, 2, 2, w, 2, 2)
    # (yb, q1y, q2y, xb, q1x, q2x) -> (yb, xb, q1y, q1x, q2y, q2x)
    nd = len(lead)
    perm = tuple(range(nd)) + tuple(nd + i for i in (0, 3, 1, 4, 2, 5))
    return x.permute(perm).reshape(*lead, h * w, 16)


def unpack_spatial(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., h*w, 16) packed -> (..., 4h, 4w) spatial."""
    lead = x.shape[:-2]
    x = x.reshape(*lead, h, w, 2, 2, 2, 2)
    # (yb, xb, q1y, q1x, q2y, q2x) -> (yb, q1y, q2y, xb, q1x, q2x)
    nd = len(lead)
    perm = tuple(range(nd)) + tuple(nd + i for i in (0, 2, 4, 1, 3, 5))
    return x.permute(perm).reshape(*lead, 4 * h, 4 * w)


def packed_flat_index(py: torch.Tensor, px: torch.Tensor,
                      w: int) -> torch.Tensor:
    """Spatial pixel coordinates (in the 4h x 4w frame) -> index into the
    (h*w*16,) ravel of the packed layout."""
    b = (py // 4) * w + px // 4
    q1 = ((py // 2) % 2) * 2 + (px // 2) % 2
    q2 = (py % 2) * 2 + px % 2
    return (b * 4 + q1) * 4 + q2


def packed_mask_to_box(masks: torch.Tensor, xmap: torch.Tensor,
                       ymap: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`batched_mask_to_box` on packed bool masks (..., h*w, 16): inclusive
    XYXY edges, [0, 0, 0, 0] for an empty mask."""
    big = 4 * max(h, w)
    lead = masks.shape[:-2]
    act = masks.reshape(*lead, -1)
    xm, ym = xmap.reshape(-1), ymap.reshape(-1)
    neg = torch.full_like(xm, -1)
    far = torch.full_like(xm, big)
    bottom = torch.where(act, ym, neg).amax(dim=-1)
    top = torch.where(act, ym, far).amin(dim=-1)
    right = torch.where(act, xm, neg).amax(dim=-1)
    left = torch.where(act, xm, far).amin(dim=-1)
    out = torch.stack([left, top, right, bottom], dim=-1)
    return out * act.any(dim=-1)[..., None].to(out.dtype)
