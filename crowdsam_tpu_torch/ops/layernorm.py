"""Row-wise LayerNorm: the CUDA kernel K1 (`csrc/layernorm.cu`) and its
plain PyTorch version.

Replaces the JAX package's Pallas `layer_norm_2d`
(crowdsam_tpu/ops/layernorm.py:34).  On a CUDA tensor every LayerNorm and
ChannelLayerNorm of the port goes through the kernel, at any row count and
any width up to `MAX_WIDTH` (the port's widest is 1024); a CPU tensor takes
the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from crowdsam_tpu_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 1024        # a lane keeps its D/32 values of the row in registers


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with f32 two-pass statistics; output in
    x's dtype (the JAX `_ln_impl` f32 semantics)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) / torch.sqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of a contiguous (..., D) tensor.

    CPU: the plain version.  CUDA: kernel K1, or an error."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm: dtype {x.dtype} (float32/bfloat16 only)")
    if not x.is_contiguous():
        raise ValueError("layer_norm: x must be contiguous")
    d = x.shape[-1]
    if not 0 < d <= MAX_WIDTH:
        raise ValueError(f"layer_norm: width {d} outside (0, {MAX_WIDTH}]")
    if weight.numel() != d or bias.numel() != d:
        raise ValueError(f"layer_norm: affine size {weight.numel()} != {d}")
    w = weight.detach().float().contiguous()
    b = bias.detach().float().contiguous()
    if w.device != x.device or b.device != x.device:
        raise ValueError("layer_norm: weights on another device")
    y = torch.empty_like(x)
    fn = _build.function("layernorm", "ln_forward", _ARGTYPES)
    status = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                x.numel() // d, d, float(eps), _DTYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "layer_norm")
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
