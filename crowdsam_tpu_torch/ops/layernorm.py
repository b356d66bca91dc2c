"""Row-wise LayerNorm: the CUDA kernel K1 (`csrc/layernorm.cu`) and its
plain PyTorch version.

Replaces the JAX package's Pallas `layer_norm_2d`
(crowdsam_tpu/ops/layernorm.py:34).  On a CUDA tensor every LayerNorm and
ChannelLayerNorm of the port goes through the kernel, at any row count and
any width up to `MAX_WIDTH` (1280, SAM ViT-H's, the port's widest); a CPU
tensor takes the plain version.  Where autograd needs a gradient (the full-decoder
training step), K1 runs as an autograd function whose backward is the
kernel `ln_backward` of the same source, which takes widths up to
`MAX_BWD_WIDTH` (1024: no training path is wider); its plain version is
autograd of `layer_norm_plain` (`layer_norm_grads_plain`).
"""

from __future__ import annotations

import collections
import ctypes

import torch
from torch.autograd.function import once_differentiable

from crowdsam_tpu_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_STATS_ARGTYPES = (ctypes.c_void_p,) * 6 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 10 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 1280        # a lane keeps its D/32 values of the row in registers
MAX_BWD_WIDTH = 1024    # the backward kernel's register ladder ends here


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with f32 two-pass statistics; output in
    x's dtype (the JAX `_ln_impl` f32 semantics)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) / torch.sqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm_grads_plain(dy: torch.Tensor, x: torch.Tensor,
                           weight: torch.Tensor, bias: torch.Tensor,
                           eps: float):
    """The plain version of the backward: (dx, dw, db) by autograd of
    `layer_norm_plain` (dx in x's dtype, dw and db in the weights')."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        wr = weight.detach().requires_grad_()
        br = bias.detach().requires_grad_()
        y = layer_norm_plain(xr, wr, br, eps)
        return torch.autograd.grad(y, (xr, wr, br), dy)


def _affine(fn: str, x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor, max_width: int = MAX_WIDTH):
    """Check what K1 (forward, or the backward with its own `max_width`)
    takes; the affine weights as contiguous f32."""
    d = x.shape[-1]
    if not 0 < d <= max_width:
        raise ValueError(f"{fn}: width {d} outside (0, {max_width}]")
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {x.dtype} (float32/bfloat16 only)")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: x must be contiguous")
    if weight.numel() != d or bias.numel() != d:
        raise ValueError(f"{fn}: affine size {weight.numel()} != {d}")
    w = weight.detach().float().contiguous()
    b = bias.detach().float().contiguous()
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"{fn}: weights on another device")
    return w, b


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float, stats: bool):
    """Launch K1.  Returns y and, with `stats`, each row's f32 mean and
    rstd (else None, None)."""
    w, b = _affine("layer_norm", x, weight, bias)
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    mean = rstd = None
    if stats:
        mean = torch.empty(rows, dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
        fn = _build.function("layernorm", "ln_forward_stats",
                             _STATS_ARGTYPES)
        status = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), rows, d, float(eps),
                    _DTYPES[x.dtype], stream)
    else:
        fn = _build.function("layernorm", "ln_forward", _ARGTYPES)
        status = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                    rows, d, float(eps), _DTYPES[x.dtype], stream)
    _build.check(status, "layer_norm")
    layer_norm.launches += 1
    layer_norm.launches_by_width[d] += 1
    return y, mean, rstd


def layer_norm_backward(dy: torch.Tensor, x: torch.Tensor,
                        weight: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor):
    """K1's backward kernel: (dx in x's dtype, dw f32, db f32) from the
    forward's input x, the output gradient dy and the row statistics that
    `ln_forward_stats` wrote.  CUDA only."""
    w, _ = _affine("layer_norm_backward", x, weight, weight,  # no bias here
                   MAX_BWD_WIDTH)
    d = x.shape[-1]
    rows = x.numel() // d
    dev = x.device
    for name, t, shape, dtype in (("dy", dy, x.shape, x.dtype),
                                  ("mean", mean, (rows,), torch.float32),
                                  ("rstd", rstd, (rows,), torch.float32)):
        _build.require_operand("layer_norm_backward", t, name, shape, dtype,
                               dev)
    blocks = _build.function("layernorm", "ln_backward_blocks",
                             (ctypes.c_longlong,))(rows)
    parts = torch.empty((2, max(blocks, 1), d), dtype=torch.float32,
                        device=dev)
    dx = torch.empty_like(x)
    dwb = torch.empty((2, d), dtype=torch.float32, device=dev)
    fn = _build.function("layernorm", "ln_backward", _BWD_ARGTYPES)
    status = fn(x.data_ptr(), dy.data_ptr(), w.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), dx.data_ptr(), parts[0].data_ptr(),
                parts[1].data_ptr(), dwb[0].data_ptr(), dwb[1].data_ptr(),
                rows, d, _DTYPES[x.dtype],
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "layer_norm_backward")
    layer_norm_backward.launches += 1
    return dx, dwb[0], dwb[1]


class _KernelLayerNorm(torch.autograd.Function):
    """K1 forward, K1 backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = _forward(x, weight, bias, eps, stats=True)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_backward(dy.contiguous(), x, weight, mean,
                                         rstd)
        need = ctx.needs_input_grad
        return (dx if need[0] else None,
                dw.to(weight.dtype) if need[1] else None,
                db.to(ctx.bias_dtype) if need[2] else None, None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of a contiguous (..., D) tensor.

    CPU: the plain version.  CUDA: kernel K1, or an error; when autograd
    needs a gradient of x, weight or bias, K1 as an autograd function whose
    backward is K1's backward kernel (`layer_norm_backward`)."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _KernelLayerNorm.apply(x, weight, bias, eps)
    return _forward(x, weight, bias, eps, stats=False)[0]


layer_norm.launches = 0
# The launches by row width (SAM ViT-H's 1280 among them), counted with
# `launches`.
layer_norm.launches_by_width = collections.Counter()
layer_norm_backward.launches = 0
