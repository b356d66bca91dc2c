"""Shared layers: exact GELU, MLP heads, LayerNorms, and Linear/Conv layers
that cast their input to their weight's dtype.

Counterpart of the JAX package's `models/common.py`.  flax's `Dense(dtype=)`
casts both the input and the f32 parameters to the compute dtype; here the
Linear/Conv weights themselves are stored in the compute dtype
(`cast_compute_params`) and the layers cast their input to it, while raw
parameters (LayerNorm affine, embeddings, tables) stay f32 and are cast at
use, as flax does.  Tensors are NHWC / (..., C) at every public function.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from crowdsam_tpu_torch.ops.layernorm import layer_norm


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


class Linear(nn.Linear):
    """nn.Linear that casts its input to the weight dtype (flax Dense)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on NHWC tensors, casting the input to the weight dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(x.to(self.weight.dtype).permute(0, 3, 1, 2),
                               self.weight, self.bias)
        return y.permute(0, 2, 3, 1).contiguous()


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
