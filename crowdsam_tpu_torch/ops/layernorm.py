"""Row-wise LayerNorm: the CUDA kernel K1 (`csrc/layernorm.cu`) and its
plain PyTorch version.

Replaces the JAX package's Pallas `layer_norm_2d`
(crowdsam_tpu/ops/layernorm.py:34).  On a CUDA tensor every LayerNorm and
ChannelLayerNorm of the port goes through the kernel, at any row count and
any width up to `MAX_WIDTH` (1280, SAM ViT-H's, the port's widest); a CPU
tensor takes the plain version.  K1 is the op
`torch.ops.crowdsam_tpu_torch.layer_norm` (`torch.library`, with a fake
version), so `torch.export` traces a module that runs it and the exported
program launches the kernel (`utils/export.py`).  Where autograd needs a
gradient (the full-decoder training step), the op `layer_norm_stats` runs
instead, whose backward is the kernel `ln_backward` of the same source,
which takes widths up to `MAX_BWD_WIDTH` (1024: no training path is wider);
its plain version is autograd of `layer_norm_plain`
(`layer_norm_grads_plain`).

`vector_arm`, `forward_plan` and `backward_plan` say how the kernels lay a
call's rows out (the source's `ln_plan` gives the same on the card): which
arm takes a width, the rows a chunk of the ring and the blocks.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from crowdsam_tpu_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_STATS_ARGTYPES = (ctypes.c_void_p,) * 6 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 9 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 1280        # the forward's widest vector arm: 5 / 10 a lane
MAX_BWD_WIDTH = 1024    # the backward's: 4 / 8 vectors a lane

# The kernels' layout constants (`csrc/layernorm.cu`).
STAGES = 3              # chunks in a block's ring
WARPS = 8               # warps a block (the backward at 8 vectors a lane: 4)
BWD_MIN_ROWS = 32       # rows a backward block, at least
BWD_BLOCKS_PER_SM = 2
DIRECT_BLOCKS_PER_SM = 2  # the direct forward's grid, and
DIRECT_GROUPS = 2         # its row groups a warp at most
GROUP = 16              # backward blocks a ticket group
MAX_GROUPS = 64


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
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"{fn}: weights on another device")
    return w, b


def _raw_stream(device: torch.device) -> int:
    """The current stream's raw handle: a `torch.cuda.Stream` object a
    call is host time on every LayerNorm of the host-bound main path."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# The backward's scratch by (device index, stream): the blocks' partials
# and the ticket words, which the kernel leaves zero after each call.  One
# a stream, so that calls on two streams never share the tickets.
_SCRATCH = {}


def _backward_scratch(device: torch.device) -> torch.Tensor:
    floats = _build.function("layernorm", "ln_backward_scratch_floats", (),
                             ctypes.c_longlong)()
    return torch.zeros(floats, dtype=torch.float32, device=device)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def vector_arm(d: int, dtype: torch.dtype):
    """(lanes a row, 16-byte vectors a lane) of the kernels' vector arm at
    width d, or None where the scalar arm takes it (d not a multiple of
    one vector: 8 bf16, 4 f32).  A row of up to 16 vectors spans the power
    of two of lanes that covers them (32 / lanes rows a warp); wider rows
    one warp, with 2, 4, 5 (bf16) or 8, 10 (f32) vectors a lane."""
    vec = 16 // dtype.itemsize
    if d % vec:
        return None
    nv = d // vec
    if nv <= 16:
        return 1 << (nv - 1).bit_length(), 1
    need = _cdiv(nv, 32)
    for vpl in (1, 2, 4) + ((5,) if vec == 8 else (8, 10)):
        if need <= vpl:
            return 32, vpl
    raise ValueError(f"width {d} past the widest arm")


def _arm_config(lanes: int, vpl: int, backward: bool):
    """(warps a block, row groups a warp a chunk, rows a warp at once) of
    a vector-arm instantiation (`Cfg` in the source)."""
    warps = 4 if backward and vpl >= 8 else WARPS
    return warps, max(1, (2 if backward else 4) // vpl), 32 // lanes


def forward_plan(rows: int, d: int, dtype: torch.dtype, sms: int,
                 blocks_per_sm: int) -> dict:
    """How K1's forward lays out `rows` rows of width d (the source's
    `forward_plan`): blocks walk the chunks b, b + grid, ... of `chunk_rows`
    contiguous rows through the ring of shared memory; where no block
    would walk more than two chunks, the direct kernel takes one row group
    a warp, or two where a lane holds two vectors or fewer and one would
    launch more than two blocks an SM (`direct`: a chunk is a block's
    rows, one a block).  `blocks_per_sm`: the instantiation's resident
    blocks (the card's occupancy; the scalar arm ignores it)."""
    arm = vector_arm(d, dtype)
    if arm is None:
        grid = _cdiv(rows, WARPS)
        return dict(arm=None, rows_per_group=1, chunk_rows=WARPS, grid=grid,
                    chunks=grid, direct=True)
    warps, gpw, rpw = _arm_config(*arm, backward=False)
    want = sms * blocks_per_sm
    groups = _cdiv(_cdiv(rows, rpw), want)
    if groups > warps:
        groups = min(_cdiv(groups, warps) * warps, warps * gpw)
    ch = groups * rpw
    chunks = _cdiv(rows, ch)
    if chunks <= 2 * want:
        # The direct kernel: G row groups a warp, a block of them a chunk.
        g = _cdiv(_cdiv(rows, warps * rpw), DIRECT_BLOCKS_PER_SM * sms)
        ch = min(g, DIRECT_GROUPS if arm[1] <= 2 else 1) * warps * rpw
        chunks = _cdiv(rows, ch)
        return dict(arm=arm, rows_per_group=rpw, chunk_rows=ch,
                    grid=chunks, chunks=chunks, direct=True)
    return dict(arm=arm, rows_per_group=rpw, chunk_rows=ch,
                grid=want, chunks=chunks, direct=False)


def backward_blocks(rows: int, sms: int) -> int:
    """The backward's blocks for `rows` rows on a card of `sms` SMs (the
    source's `ln_backward_blocks`): block k takes rows [k per, (k + 1) per)
    of per = ceil(rows / blocks)."""
    if rows <= 0:
        return 0
    return min(_cdiv(rows, BWD_MIN_ROWS), BWD_BLOCKS_PER_SM * sms,
               GROUP * MAX_GROUPS)


def backward_plan(rows: int, d: int, dtype: torch.dtype, sms: int) -> dict:
    """How K1's backward lays out `rows` rows of width d: `backward_blocks`
    contiguous ranges of `rows_per_block`, each read in chunks of
    `chunk_rows` through the ring (`direct` False: the forward's key)."""
    blocks = backward_blocks(rows, sms)
    per = _cdiv(rows, blocks) if blocks else 0
    arm = vector_arm(d, dtype)
    if arm is None:
        return dict(arm=None, rows_per_group=1, chunk_rows=WARPS,
                    grid=blocks, rows_per_block=per, direct=True)
    warps, gpw, rpw = _arm_config(*arm, backward=True)
    groups = _cdiv(max(per, 1), rpw)
    if groups > warps:
        groups = min(_cdiv(groups, warps) * warps, warps * gpw)
    ch = groups * rpw
    return dict(arm=arm, rows_per_group=rpw, chunk_rows=ch, grid=blocks,
                rows_per_block=per, direct=False)


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float, stats: bool):
    """Launch K1.  Returns y and, with `stats`, each row's f32 mean and
    rstd (else None, None)."""
    w, b = _affine("layer_norm", x, weight, bias)
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    stream = _raw_stream(x.device)
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
    stream = _raw_stream(dev)
    scratch = _SCRATCH.get((dev.index, stream))
    if scratch is None:
        scratch = _SCRATCH[dev.index, stream] = _backward_scratch(dev)
    dx = torch.empty_like(x)
    dwb = torch.empty((2, d), dtype=torch.float32, device=dev)
    fn = _build.function("layernorm", "ln_backward", _BWD_ARGTYPES)
    status = fn(x.data_ptr(), dy.data_ptr(), w.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), dx.data_ptr(), dwb[0].data_ptr(),
                dwb[1].data_ptr(), scratch.data_ptr(), rows, d,
                _DTYPES[x.dtype], stream)
    _build.check(status, "layer_norm_backward")
    layer_norm_backward.launches += 1
    return dx, dwb[0], dwb[1]


# K1 as an operator of the port's namespace, so that `torch.export` traces
# through it (the fake version gives the output's shape and dtype) and an
# exported program launches the kernel: `layer_norm` for inference,
# `layer_norm_stats` (y and each row's f32 mean and rstd) where autograd
# needs a gradient, its backward K1's backward kernel.  CUDA: the kernels;
# CPU: the plain version; any other device has no implementation.
_LIB = torch.library.Library("crowdsam_tpu_torch", "DEF")
_LIB.define("layer_norm(Tensor x, Tensor weight, Tensor bias, float eps) "
            "-> Tensor")
_LIB.define("layer_norm_stats(Tensor x, Tensor weight, Tensor bias, "
            "float eps) -> (Tensor, Tensor, Tensor)")


def _plain_stats(x, weight, bias, eps):
    xf = x.float()
    mean = xf.mean(-1)
    rstd = torch.rsqrt((xf - mean[..., None]).square().mean(-1) + eps)
    return (layer_norm_plain(x, weight, bias, eps), mean.reshape(-1),
            rstd.reshape(-1))


def _fake_stats(x, weight, bias, eps):
    rows = x.numel() // x.shape[-1]
    return (torch.empty_like(x),
            x.new_empty(rows, dtype=torch.float32),
            x.new_empty(rows, dtype=torch.float32))


_LIB.impl("layer_norm", lambda x, weight, bias, eps: _forward(
    x, weight, bias, eps, stats=False)[0], "CUDA")
_LIB.impl("layer_norm", layer_norm_plain, "CPU")
_LIB.impl("layer_norm_stats", lambda x, weight, bias, eps: _forward(
    x, weight, bias, eps, stats=True), "CUDA")
_LIB.impl("layer_norm_stats", _plain_stats, "CPU")
torch.library.register_fake("crowdsam_tpu_torch::layer_norm",
                            lambda x, weight, bias, eps: torch.empty_like(x),
                            lib=_LIB)
torch.library.register_fake("crowdsam_tpu_torch::layer_norm_stats",
                            _fake_stats, lib=_LIB)


def _save_for_backward(ctx, inputs, output):
    x, weight, bias, eps = inputs
    _, mean, rstd = output
    ctx.save_for_backward(x, weight, bias, mean, rstd)
    ctx.eps = eps
    ctx.mark_non_differentiable(mean, rstd)


def _backward(ctx, dy, _dmean, _drstd):
    """K1's backward kernel on CUDA; on the CPU the plain version
    (autograd of `layer_norm_plain`, as if the op were not there)."""
    x, weight, bias, mean, rstd = ctx.saved_tensors
    if x.device.type == "cpu":
        dx, dw, db = layer_norm_grads_plain(dy, x, weight, bias, ctx.eps)
    else:
        dx, dw, db = layer_norm_backward(dy.contiguous(), x, weight, mean,
                                         rstd)
        dw, db = dw.to(weight.dtype), db.to(bias.dtype)
    need = ctx.needs_input_grad
    return (dx if need[0] else None, dw if need[1] else None,
            db if need[2] else None, None)


torch.library.register_autograd("crowdsam_tpu_torch::layer_norm_stats",
                                _backward, setup_context=_save_for_backward,
                                lib=_LIB)
LAYER_NORM = torch.ops.crowdsam_tpu_torch.layer_norm.default
_LAYER_NORM_STATS = torch.ops.crowdsam_tpu_torch.layer_norm_stats.default


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of a contiguous (..., D) tensor, through
    the op `crowdsam_tpu_torch::layer_norm`.

    CPU: the plain version.  CUDA: kernel K1, or an error.  When autograd
    needs a gradient of x, weight or bias, the op `layer_norm_stats`, whose
    backward is K1's backward kernel on CUDA (`layer_norm_backward`) and
    autograd of the plain version on the CPU."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LAYER_NORM_STATS(x, weight, bias, eps)[0]
    return LAYER_NORM(x, weight, bias, eps)


layer_norm.launches = 0
# The launches by row width (SAM ViT-H's 1280 among them), counted with
# `launches`.
layer_norm.launches_by_width = collections.Counter()
layer_norm_backward.launches = 0
