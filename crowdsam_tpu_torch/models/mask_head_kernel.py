"""The packed mask head of the fused decode as one kernel (K6):
`csrc/mask_head.cu`, its wrapper `mask_head` and its plain PyTorch version
`mask_head_plain`.

Replaces the JAX package's Pallas `mask_head_pallas`
(crowdsam_tpu/models/mask_head_kernel.py:165).  Per prompt and image row:
the first 2x2 transposed convolution as a dense product to 4 sub-pixels x c1
channels, LayerNorm over each sub-pixel's c1 channels (eps 1e-6), erf GELU,
the second transposed convolution (c1 -> 4 sub-pixels x c2), GELU, and the
dot of every sub-pixel's c2 channels with the prompt's K hypernetwork
vectors: packed masks (P, K, M, 16), the layout of `ops/packed.py`.  With
`emit_exp` also e = exp(mask - tile max) in the same layout and the tile
maxes, from which `fused_decode._pooled_from_exp` forms the PWD pooling
without another pass over the masks.

The TPU kernel's block-diagonal second weight and its (512, 16 K)
hypernetwork matrix only serve its matrix unit; here the second weight is
used as it is, (c1, 4 c2) seen as [out][in], and `hyper_in` as (P, K, c2).

Numerics, the same in the kernel and the plain version: keys2, the weights
and the hypernetwork vectors in the working dtype (bf16 on the card), f32
accumulation, f32 values between the products (LayerNorm, GELU), the two
GELU outputs entering the next product as two working-dtype terms, hi =
rnd(y) and lo = rnd(y - hi); masks rounded from the f32 products, e from the
unrounded f32 masks.  With a rounding after each stage instead, a step
that two computations take on two sides of a rounding boundary, times
hypernetwork weights of tens, moved a mask by ~0.06 and e by twice its
bound.  The plain version's GELU uses the exact erf; the kernel's is a
polynomial within 1.7e-7 max(|x|, 1) of it, far below the split's 2^-17.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from crowdsam_tpu_torch.kernels import _build

ROW_TILE = 64           # rows per kernel tile: the `emit_exp` maxes' tile
NUM_MASKS = 4
LN_EPS = 1e-6

_ARGTYPES = ((ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 3
             + (ctypes.c_void_p,))


def _subpixel_weight(conv) -> torch.Tensor:
    """A `ConvTranspose2x2`'s (C_in, C_out, 2, 2) weight as the dense
    [out][in] matrix (4 C_out, C_in) with the sub-pixel index (dy*2 + dx)
    major in `out`, the order `ops/packed.py` folds into the last axis."""
    w = conv.weight.detach()
    return w.permute(2, 3, 1, 0).reshape(4 * w.shape[1], w.shape[0])


def build_mask_head_weights(decoder, dtype: torch.dtype
                            ) -> Dict[str, torch.Tensor]:
    """The mask head's weights from the port's `MaskDecoder`: w0t (4 c1, C),
    w2t (4 c2, c1) in `dtype`; b0 (4 c1), b2 (4 c2), ln_w/ln_b (c1) f32."""
    up = decoder.output_upscaling
    return {
        "w0t": _subpixel_weight(up[0]).to(dtype).contiguous(),
        "b0": up[0].bias.detach().float().contiguous(),
        "ln_w": up[1].weight.detach().float().contiguous(),
        "ln_b": up[1].bias.detach().float().contiguous(),
        "w2t": _subpixel_weight(up[3]).to(dtype).contiguous(),
        "b2": up[3].bias.detach().float().contiguous(),
    }


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _group_ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """LayerNorm over the last axis (one sub-pixel's channels), f32."""
    u = x.mean(-1, keepdim=True)
    s = (x - u).square().mean(-1, keepdim=True)
    return (x - u) * torch.rsqrt(s + LN_EPS) * w + b


def mask_head_plain(keys2: torch.Tensor, hyper_in: torch.Tensor,
                    weights: Dict[str, torch.Tensor], emit_exp: bool = False,
                    tile_m: int = ROW_TILE
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain version of `mask_head` (same contract), in f32 with the
    kernel's rounding points; the working dtype is keys2's."""
    dt = keys2.dtype
    p, m, _ = keys2.shape
    k = hyper_in.shape[1]

    def rnd(x):
        return x.to(dt).float()

    w0t, w2t = weights["w0t"].float(), weights["w2t"].float()
    c1 = weights["ln_w"].shape[0]
    def split(y):                 # y as two working-dtype terms, hi + lo
        hi = rnd(y)
        return hi, rnd(y - hi)

    up = keys2.float() @ w0t.T + weights["b0"]
    up = up.reshape(p, m, 4, c1)                          # (P, M, q1, c1)
    hi, lo = split(F.gelu(_group_ln(up, weights["ln_w"], weights["ln_b"])))
    up = F.gelu(hi @ w2t.T + lo @ w2t.T + weights["b2"])  # (P, M, q1, 4 c2)
    hi, lo = split(up.reshape(p, m, 16, -1))              # (P, M, q1 q2, c2)
    hyper = rnd(hyper_in.float())
    masks32 = (torch.einsum("pkc,pmqc->pkmq", hyper, hi)
               + torch.einsum("pkc,pmqc->pkmq", hyper, lo))
    masks = masks32.to(dt)
    if not emit_exp:
        return masks
    nblk = m // tile_m
    tiles = masks32.reshape(p, k, nblk, tile_m * 16)
    mx = tiles.amax(dim=(1, 3))                           # (P, nblk)
    e = torch.exp(tiles - mx[:, None, :, None]).to(dt)
    return masks, e.reshape(p, k, m, 16), mx


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    _build.require_operand("mask_head", t, name, shape, dtype, device)


def mask_head(keys2: torch.Tensor, hyper_in: torch.Tensor,
              weights: Dict[str, torch.Tensor], emit_exp: bool = False
              ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The packed mask head (K6).

    keys2 (P, M, 256): the two-way transformer's image tensor; hyper_in
    (P, K, 32): the hypernetwork vectors; weights:
    `build_mask_head_weights`.  Returns packed masks (P, K, M, 16) in the
    working dtype; with `emit_exp` also e (P, K, M, 16) = exp(mask - tile
    max) and mx (P, M / ROW_TILE) f32, the maxes over each tile of ROW_TILE
    rows (all K masks, all 16 sub-pixels).

    CPU: the plain version.  CUDA: the kernel (bf16, M a multiple of
    ROW_TILE, K = 4, widths 256 -> 64 -> 32), or an error."""
    _build.refuse_grad("mask_head", keys2, hyper_in, weights)
    if keys2.device.type == "cpu":
        return mask_head_plain(keys2, hyper_in, weights, emit_exp)
    if keys2.device.type != "cuda":
        raise ValueError(f"mask_head: unsupported device {keys2.device}")
    dev, bf, f32 = keys2.device, torch.bfloat16, torch.float32
    if keys2.dim() != 3 or hyper_in.dim() != 3:
        raise ValueError("mask_head: keys2 (P, M, C) and hyper_in (P, K, c2)")
    p, m, c = keys2.shape
    k, c2 = hyper_in.shape[1:]
    c1 = weights["ln_w"].shape[0]
    if (c, c1, c2, k) != (256, 64, 32, NUM_MASKS) or m == 0 or m % ROW_TILE \
            or p == 0:
        raise ValueError(
            f"mask_head: unsupported shape: keys2 {tuple(keys2.shape)}, "
            f"hyper_in {tuple(hyper_in.shape)}, c1 {c1} (rows a multiple of "
            f"{ROW_TILE}, widths 256 -> 64 -> 32, {NUM_MASKS} masks)")
    _check(keys2, "keys2", (p, m, c), bf, dev)
    _check(hyper_in, "hyper_in", (p, k, c2), bf, dev)
    for name, shape, dt in (("w0t", (4 * c1, c), bf), ("b0", (4 * c1,), f32),
                            ("ln_w", (c1,), f32), ("ln_b", (c1,), f32),
                            ("w2t", (4 * c2, c1), bf), ("b2", (4 * c2,), f32)):
        _check(weights[name], name, shape, dt, dev)
    masks = torch.empty((p, k, m, 16), dtype=bf, device=dev)
    e = mx = None
    if emit_exp:
        e = torch.empty_like(masks)
        mx = torch.empty((p, m // ROW_TILE), dtype=f32, device=dev)
    fn = _build.function("mask_head", "mask_head_forward", _ARGTYPES)
    status = fn(keys2.data_ptr(), hyper_in.data_ptr(),
                weights["w0t"].data_ptr(), weights["b0"].data_ptr(),
                weights["ln_w"].data_ptr(), weights["ln_b"].data_ptr(),
                weights["w2t"].data_ptr(), weights["b2"].data_ptr(),
                masks.data_ptr(), e.data_ptr() if emit_exp else None,
                mx.data_ptr() if emit_exp else None, p, m, int(emit_exp),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "mask_head")
    mask_head.launches += 1
    return (masks, e, mx) if emit_exp else masks


mask_head.launches = 0
