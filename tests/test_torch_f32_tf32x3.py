"""The numerics of the float32 attention arm (`csrc/attention_f32.cu`,
3xTF32 on wgmma), written out in PyTorch by
`attention.f32_attention_tf32x3_model`: TF32 rounding by integer ops on the
float32 bits, the three products with lo.lo dropped, V^T's key order within
each 8-key group, the online softmax over 64-key tiles and the P V product
summed a tile at a time.

At small shapes of each arm (K4 with `valid_len` < S; K3 on square, rect
and band grids at head dims 64 and 80; K2 on a 28x28 grid of 14x14
windows), on the arms' own host-side preparation, the model's max and mean
absolute error from a float64 evaluation are held to the kernel's bound on
the card (chip_smoke.py phases `K2/K3/K4 float32`): at most 2x the plain
float32 version's (`f32_attention_plain`), floor 1e-7 of max |out|.  Each
fault of the design (lo.hi dropped, V's keys unpermuted, a tile's lo part
from the previous tile) breaks that bound 8-fold.  The model also agrees
with the JAX package's dense float32 path (1e-5 relative, plus 1e-5 of the
output's largest magnitude, as `tests/test_torch_float32_arms.py`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdsam_tpu_torch.models import attention
from crowdsam_tpu_torch.models import image_encoder as enc


def _normal(rng, shape, scale=1.0):
    return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))


def _k4(seed, hd=64, s=300, valid=290):
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, (1, 2, s, hd)) for _ in range(3))
    return attention.flash_f32_attention(q, k, v, hd ** -0.5, valid)


def _k3(seed, hw, hd, band=None):
    rng = np.random.default_rng(seed)
    h, w = hw
    q, k, v = (_normal(rng, (1, 2, h * w, hd)) for _ in range(3))
    rel_h = _normal(rng, (2 * h - 1, hd), 0.3)
    rel_w = _normal(rng, (2 * w - 1, hd), 0.3)
    lo, hi = band or (0, h)
    return attention.relpos_f32_attention(
        q[:, :, lo * w:hi * w], k, v, hd ** -0.5,
        enc._rel_pos_table(rel_h, h), enc._rel_pos_table(rel_w, w), hw, lo)


def _k2(seed, hd=64):
    rng = np.random.default_rng(seed)
    heads, ws = 2, 14
    qkv = _normal(rng, (1, 28, 28, 3 * heads * hd))
    rel_h, rel_w = (_normal(rng, (2 * ws - 1, hd), 0.3) for _ in range(2))
    return attention.window_f32_attention(
        qkv, enc._rel_pos_table(rel_h, ws), enc._rel_pos_table(rel_w, ws),
        heads, hd ** -0.5, ws)


CASES = {
    "K4-valid-290-of-300": lambda: _k4(1),
    "K3-16x16-hd64": lambda: _k3(2, (16, 16), 64),
    "K3-16x16-hd80": lambda: _k3(3, (16, 16), 80),
    "K3-rect-12x16-hd64": lambda: _k3(4, (12, 16), 64),
    "K3-rect-16x12-hd80": lambda: _k3(5, (16, 12), 80),
    "K3-band-10-16-hd64": lambda: _k3(6, (16, 16), 64, (10, 16)),
    "K3-band-6-12-hd80": lambda: _k3(7, (12, 16), 80, (6, 12)),
    "K2-28x28-hd64": lambda: _k2(8),
}


def _as_float64(a):
    return dataclasses.replace(a, **{
        k: getattr(a, k).double() for k in ("q", "k", "v", "fh", "fw")
        if getattr(a, k) is not None})


def _bound(a):
    """The error statistics of x from float64, and the bound's ratio:
    max(max err / tol_max, mean err / tol_mean)."""
    want = attention.f32_attention_plain(_as_float64(a))
    plain = attention.f32_attention_plain(a)
    floor = 1e-7 * float(want.abs().max())

    def errs(x):
        d = (x.double() - want).abs()
        return float(d.max()), float(d.mean())

    pl_max, pl_mean = errs(plain)
    tol = (max(2 * pl_max, floor), max(2 * pl_mean, floor))

    def over(x):
        mx, mn = errs(x)
        return max(mx / tol[0], mn / tol[1])

    return over


@pytest.mark.parametrize("case", list(CASES))
def test_model_within_the_kernels_bound(case):
    """The model's max and mean error from float64 within 2x the plain
    float32 version's (floor 1e-7 of max |out|)."""
    a = CASES[case]()
    over = _bound(a)
    got = attention.f32_attention_tf32x3_model(a)
    assert got.shape == attention.f32_attention_plain(a).shape
    assert over(got) <= 1.0, over(got)


@pytest.mark.parametrize("fault", attention.TF32X3_FAULTS)
@pytest.mark.parametrize("case", ["K4-valid-290-of-300", "K3-16x16-hd80",
                                  "K2-28x28-hd64"])
def test_model_faults_break_the_bound(case, fault):
    """Each fault of the design breaks the bound at least 8-fold."""
    a = CASES[case]()
    over = _bound(a)
    assert over(attention.f32_attention_tf32x3_model(a, fault)) > 8.0


def test_tf32_round_is_rna_on_the_bits():
    """TF32 rounding keeps 10 stored mantissa bits, to nearest with ties
    away from zero in magnitude, on both signs; x = hi + lo within 2^-22
    |x|."""
    step = 2.0 ** -10
    x = torch.tensor([1 + step / 2, 1 + step / 2 - 2 ** -23, 1 + 1.5 * step,
                      -(1 + step / 2), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + step, 1.0, 1 + 2 * step, -(1 + step), 3.0, 0.0])
    assert torch.equal(attention.tf32_round(x), want)
    y = _normal(np.random.default_rng(9), (4096,))
    hi = attention.tf32_round(y)
    lo = attention.tf32_round(y - hi)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert float(((hi.double() + lo.double() - y.double()).abs()
                  / y.double().abs()).max()) <= 2.0 ** -22


def test_model_matches_jax_dense():
    """The model against the JAX package's dense float32 path of DINOv2's
    attention over the first `valid_len` keys (the float32 arms' tolerance,
    `tests/test_torch_float32_arms.py`)."""
    a = CASES["K4-valid-290-of-300"]()
    q, k, v = (jnp.asarray(x.numpy()) for x in (a.q, a.k, a.v))
    logits = jnp.einsum("bhqc,bhkc->bhqk", q, k[:, :, :a.valid]) * a.scale
    want = np.asarray(jnp.einsum("bhqk,bhkc->bhqc",
                                 jax.nn.softmax(logits, axis=-1),
                                 v[:, :, :a.valid]))
    got = attention.f32_attention_tf32x3_model(a).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
