"""Shared layers: exact GELU, MLP heads, LayerNorms, and Linear/Conv layers
that cast their input to their weight's dtype.

Counterpart of the JAX package's `models/common.py`.  flax's `Dense(dtype=)`
casts both the input and the f32 parameters to the compute dtype; here the
Linear/Conv weights themselves are stored in the compute dtype
(`cast_compute_params`) and the layers cast their input to it, while raw
parameters (LayerNorm affine, embeddings, tables) stay f32 and are cast at
use, as flax does.  Tensors are NHWC / (..., C) at every public function.

A layer whose weight is float32 computes in full float32 whatever the
caller set (`exact_float32`): PyTorch leaves cuDNN's TF32 on for float32
convolutions by default, and a caller may lower the float32 matmul
precision.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from crowdsam_tpu_torch.ops.layernorm import layer_norm


class exact_float32:
    """Inside the block, float32 products on CUDA run in full float32:
    cuDNN's TF32 off and the float32 matmul precision "highest"; the
    caller's settings come back on exit.  With `dtype` other than float32
    (a bf16 model) it changes nothing.  Used by the layers with float32
    weights, the float32 arms' bias terms and the entry points of a float32
    model (`CrowdSAM.generate`, `ShardedPipeline.generate_batch`, the
    AMG's `generate`, the trainer's `cache_features` and
    `loss_and_grads`, whose backward runs inside)."""

    def __init__(self, dtype: Optional[torch.dtype] = torch.float32):
        self.on = dtype == torch.float32
        self.saved = None

    def __enter__(self):
        if self.on:
            self.saved = (torch.backends.cudnn.allow_tf32,
                          torch.get_float32_matmul_precision())
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc) -> bool:
        if self.on:
            torch.backends.cudnn.allow_tf32 = self.saved[0]
            torch.set_float32_matmul_precision(self.saved[1])
        return False


def float32_entry(dtype_of):
    """Decorator of an entry point's method: the method runs inside
    `exact_float32(dtype_of(self))`, so that a float32 model's every
    product, backward included, is full float32 on the card."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(self, *args, **kwargs):
            with exact_float32(dtype_of(self)):
                return fn(self, *args, **kwargs)
        return run
    return wrap


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


class Linear(nn.Linear):
    """nn.Linear that casts its input to the weight dtype (flax Dense)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with exact_float32(self.weight.dtype):
            return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on NHWC tensors, casting the input to the weight dtype.

    A batch goes through image by image: cuDNN picks a convolution's
    algorithm by the batch size, and the one picked for a batch may round
    an image otherwise than the one picked for it alone (SAM's 3x3 neck
    convolution at batch 2 on the H100), so a batched encode would not give
    each image the features of its single encode."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._nhwc(x, self.padding)

    def _nhwc(self, x: torch.Tensor, padding) -> torch.Tensor:
        x = x.to(self.weight.dtype).permute(0, 3, 1, 2)
        with exact_float32(self.weight.dtype):
            y = [F.conv2d(x[i:i + 1], self.weight, self.bias, self.stride,
                          padding, self.dilation, self.groups)
                 for i in range(x.shape[0])]
        y = torch.cat(y) if len(y) > 1 else y[0]
        return y.permute(0, 2, 3, 1).contiguous()

    def rows_read(self, lo: int, hi: int, h_in: int) -> Tuple[int, int]:
        """The input rows that output rows [lo, hi) read, cut to the
        input's h_in rows (past its edges lies the zero padding)."""
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]
        return max(lo * s - p, 0), min((hi - 1) * s - p + k, h_in)

    def forward_rows(self, x: torch.Tensor, x0: int, h_in: int, lo: int,
                     hi: int) -> torch.Tensor:
        """Output rows [lo, hi) of this convolution of an input of h_in
        rows, of which x (B, n, W, C) holds rows [x0, x0 + n), at least
        those `rows_read` names: the same values as those rows of the whole
        output, the zero padding added only past the input's edges."""
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]
        r0, r1 = lo * s - p, (hi - 1) * s - p + k
        a, b = self.rows_read(lo, hi, h_in)
        if a < x0 or b > x0 + x.shape[1]:
            raise ValueError(f"rows [{lo}, {hi}) read input rows [{a}, {b})"
                             f"; x holds [{x0}, {x0 + x.shape[1]})")
        x = F.pad(x[:, a - x0:b - x0], (0, 0, 0, 0, a - r0, r1 - b))
        return self._nhwc(x, (0, self.padding[1]))


class ConvTranspose2x2(nn.ConvTranspose2d):
    """ConvTranspose2d(kernel 2, stride 2) on NHWC tensors, computed as one
    dense product to 4*out channels plus depth-to-space:
    out[2i+di, 2j+dj, o] = sum_c x[i, j, c] * W[c, o, di, dj]
                           + b[(2 di + dj) out + o].

    The bias has one value per sub-pixel and channel (4*out), as the JAX
    package's dense layer holds it: full-decoder training makes the four
    copies differ.  A reference checkpoint's (out,) bias loads tiled 4x."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, kernel_size=2, stride=2)
        self.bias = nn.Parameter(torch.zeros(4 * out_channels))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "bias"
        if key in state_dict and tuple(state_dict[key].shape) == (
                self.out_channels,):
            state_dict[key] = state_dict[key].repeat(4)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        cout = self.out_channels
        wmat = self.weight.permute(0, 2, 3, 1).reshape(self.in_channels,
                                                       4 * cout)
        with exact_float32(wmat.dtype):
            y = x.to(wmat.dtype) @ wmat + self.bias
        y = y.reshape(b, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(b, 2 * h, 2 * w, cout)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, f32 statistics, output in the input's
    dtype.  On a CUDA tensor it runs kernel K1 (`ops/layernorm.py`)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.contiguous(), self.weight, self.bias, self.eps)


class ChannelLayerNorm(LayerNorm):
    """The reference's LayerNorm2d (channel LN on NCHW) under the NHWC
    layout: a LayerNorm over the last axis with eps 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps)


class MLPBlock(nn.Module):
    """lin1 -> act -> lin2."""

    def __init__(self, dim: int, mlp_dim: int, act=gelu):
        super().__init__()
        self.lin1 = Linear(dim, mlp_dim)
        self.lin2 = Linear(mlp_dim, dim)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


class MLP(nn.Module):
    """ReLU MLP head.  Also serves the reference's DropMLP heads at
    inference, where their dropout is inactive (same state-dict keys)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, sigmoid_output: bool = False):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


def cast_compute_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store the Linear/Conv weights in `dtype`; every other parameter
    (LayerNorm affine, embeddings, rel-pos tables, LayerScale) stays f32."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            for p in m.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return module


def compute_dtype(module: nn.Module) -> torch.dtype:
    """The compute dtype `cast_compute_params` gave `module`: that of its
    first Linear/Conv weight."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            return m.weight.dtype
    raise ValueError("module has no Linear or Conv layer")
