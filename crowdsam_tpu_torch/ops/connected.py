"""Connected components and the small-region cleanup, on tensors.

Counterpart of the JAX package's `ops/connected.py`, replicated with its hop
caps, since they decide the answers wherever they bind: an exact labeller
(scipy, cv2) would differ there.

- Area thresholds up to `_MAX_RADIUS + 1` pixels (the main path: 100 px at
  1024^2 is 6.25 px at 256^2) take the bounded-hop window test: radius+1
  local 3x3 max-label hops, then per-pixel same-label counts and a
  convergence check inside an L-inf window of `radius`.
- Larger thresholds label components by sweeps of row/column segmented max
  scans plus a 3x3 hop, stopping when nothing changes or after `max_iters`
  sweeps (`tpu.cc_max_iters`), then count component areas.

Labels are each pixel's linear index + 1, the component taking the largest.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MAX_RADIUS = 8


def _local_hop(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One 8-connected 3x3 max-label hop, masked to the foreground.  Labels
    stay below 2^24, so the float max pool is exact."""
    pooled = F.max_pool2d(labels.float()[:, None], 3, stride=1, padding=1)
    return torch.where(mask, pooled[:, 0].to(torch.int32), 0)


def _initial_labels(mask: torch.Tensor) -> torch.Tensor:
    b, h, w = mask.shape
    idx = torch.arange(1, h * w + 1, dtype=torch.int32,
                       device=mask.device).reshape(1, h, w)
    return torch.where(mask, idx, 0)


def label_components_local(mask: torch.Tensor, hops: int) -> torch.Tensor:
    """Labels after a fixed number of 3x3 max hops: exact for components of
    graph diameter <= hops, partial labels for larger ones."""
    labels = _initial_labels(mask)
    for _ in range(hops):
        labels = _local_hop(labels, mask)
    return labels


def _shift(x: torch.Tensor, s: int, axis: int, fill) -> torch.Tensor:
    """The value from s positions earlier along `axis` (edge filled)."""
    n = x.shape[axis]
    pad_shape = list(x.shape)
    pad_shape[axis] = min(s, n)
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x.narrow(axis, 0, n - pad_shape[axis])], dim=axis)


def _seg_scan(labels: torch.Tensor, fg: torch.Tensor, axis: int,
              reverse: bool) -> torch.Tensor:
    """Hillis-Steele segmented max scan along `axis` (log-depth shifts)."""
    if reverse:
        labels, fg = labels.flip(axis), fg.flip(axis)
    v = labels
    reach = fg & _shift(fg, 1, axis, False)
    s = 1
    while s < labels.shape[axis]:
        v = torch.maximum(v, torch.where(reach, _shift(v, s, axis, 0), 0))
        reach = reach & _shift(reach, s, axis, False)
        s *= 2
    return v.flip(axis) if reverse else v


def label_components(mask: torch.Tensor, max_iters: int = 256) -> torch.Tensor:
    """8-connected labels of (B, H, W) bool masks by sweeps (row scans,
    column scans, one 3x3 hop) until no label changes or `max_iters` sweeps
    have run; components not converged by then keep partial labels."""
    labels = _initial_labels(mask)
    for _ in range(max_iters):
        new = torch.maximum(_seg_scan(labels, mask, 2, False),
                            _seg_scan(labels, mask, 2, True))
        new = torch.maximum(_seg_scan(new, mask, 1, False),
                            _seg_scan(new, mask, 1, True))
        new = _local_hop(new, mask)
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    return labels


def _label_counts(labels: torch.Tensor) -> torch.Tensor:
    """(B, H*W + 1) pixel count of every label value."""
    b, h, w = labels.shape
    flat = labels.reshape(b, h * w).long()
    counts = torch.zeros((b, h * w + 1), dtype=torch.int32,
                         device=labels.device)
    return counts.scatter_add_(1, flat, torch.ones_like(flat,
                                                        dtype=torch.int32))


def component_areas(labels: torch.Tensor) -> torch.Tensor:
    """(B, H, W) labels -> per-pixel area of its component (0 off it)."""
    b, h, w = labels.shape
    flat = labels.reshape(b, h * w).long()
    areas = torch.gather(_label_counts(labels), 1, flat).reshape(b, h, w)
    return torch.where(labels > 0, areas, 0)


def _window_slice(padded: torch.Tensor, radius: int, dy: int, dx: int,
                  h: int, w: int) -> torch.Tensor:
    return padded[:, radius + dy:radius + dy + h, radius + dx:radius + dx + w]


def _windowed_count_and_ok(labels: torch.Tensor, working: torch.Tensor,
                           radius: int):
    """(count, converged): same-label pixels within L-inf `radius`, and
    whether every one of them has only same-label or background 8-neighbours
    (then the centre's label region is a complete component inside the
    window and `count` is its exact area)."""
    h, w = labels.shape[-2:]
    pad1 = F.pad(labels, (1, 1, 1, 1))
    ok = working.clone()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                nb = _window_slice(pad1, 1, dy, dx, h, w)
                ok &= (nb == labels) | (nb == 0)
    padded = F.pad(labels, (radius,) * 4)
    padded_ok = F.pad(ok, (radius,) * 4)
    count = torch.zeros(labels.shape, dtype=torch.int32, device=labels.device)
    okc = torch.zeros_like(count)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            same = _window_slice(padded, radius, dy, dx, h, w) == labels
            count += same
            okc += same & _window_slice(padded_ok, radius, dy, dx, h, w)
    count = torch.where(working, count, 0)
    return count, working & (okc == count)


def remove_small_regions(masks: torch.Tensor, area_thresh: float, mode: str,
                         max_iters: int = 256):
    """(B, H, W) bool -> (cleaned (B, H, W) bool, changed (B,) bool).

    "holes": fill background components smaller than the threshold;
    "islands": drop foreground components smaller than it, keeping the
    largest one when that would remove everything."""
    if mode not in ("holes", "islands"):
        raise ValueError(f"mode {mode!r}")
    holes = mode == "holes"
    working = masks ^ holes
    radius = max(int(-(-area_thresh // 1)) - 1, 1)
    use_window = radius <= _MAX_RADIUS
    if use_window:
        labels = label_components_local(working, radius + 1)
        count, converged = _windowed_count_and_ok(labels, working, radius)
        small = working & (count < area_thresh) & converged
    else:
        labels = label_components(working, max_iters)
        small = working & (component_areas(labels) < area_thresh)
    changed = small.any(dim=(1, 2))
    if holes:
        return masks | small, changed

    out = masks & ~small
    b, h, w = masks.shape
    if use_window:
        flatc = count.reshape(b, h * w)
        is_max = working.reshape(b, h * w) & (
            flatc == flatc.max(dim=1, keepdim=True).values)
        sel = torch.where(is_max, labels.reshape(b, h * w),
                          h * w + 1).min(dim=1).values
    else:
        counts = _label_counts(labels)
        counts[:, 0] = 0
        sel = counts.argmax(dim=1)
    fallback = labels == sel[:, None, None]
    all_removed = ~out.any(dim=(1, 2)) & masks.any(dim=(1, 2))
    out = torch.where(all_removed[:, None, None], fallback, out)
    return out, changed
