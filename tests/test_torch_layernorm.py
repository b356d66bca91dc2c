"""K1 and the shared layers: the port's plain LayerNorm against the JAX
package's Pallas `layer_norm_2d` (interpret mode) and `_ln_impl`'s f32 path,
and `models/common.py` against its JAX counterpart.

Tolerance 1e-4 abs / 1e-4 rel: float32 statistics on both sides; the Pallas
kernel takes E[x^2] - mu^2 in one pass where the port takes two."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from crowdsam_tpu.models import common as jcommon
from crowdsam_tpu.ops import layernorm as jln
from crowdsam_tpu.utils.checkpoint import jax_tree_to_numpy

from crowdsam_tpu_torch.models import common
from crowdsam_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain
from crowdsam_tpu_torch.utils.weights import _t

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.3, 1.5, (n, d)).astype(np.float32),
            rng.normal(1.0, 0.1, (d,)).astype(np.float32),
            rng.normal(0.0, 0.1, (d,)).astype(np.float32))


@pytest.mark.parametrize("n,d,eps", [(70, 256, 1e-6), (300, 1024, 1e-5),
                                     (33, 256, 1e-5), (64, 1280, 1e-6)])
def test_plain_matches_pallas_interpret(monkeypatch, n, d, eps):
    """Widths of the port's LayerNorms, SAM ViT-H's 1280 among them."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    x, w, b = _inputs(n, d)
    want = jln.layer_norm_2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             eps=eps, block_rows=16)
    got = layer_norm_plain(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d,eps", [(256, 1e-6), (1024, 1e-5), (64, 1e-6)])
def test_wrapper_on_cpu_matches_ln_impl(d, eps):
    x, w, b = _inputs(37, d, seed=1)
    x3 = x.reshape(37, 1, d)
    want = jcommon._ln_impl(jnp.asarray(x3), jnp.asarray(w), jnp.asarray(b),
                            eps, jnp.float32)
    got = layer_norm(torch.from_numpy(x3), torch.from_numpy(w),
                     torch.from_numpy(b), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_keeps_bf16_on_cpu():
    x, w, b = _inputs(8, 128)
    y = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                   torch.from_numpy(b), 1e-6)
    assert y.dtype == torch.bfloat16


def _run_flax(module, x, seed=0):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed + 7)
    params = jax.tree.map(
        lambda p: jnp.asarray(rng.normal(0, 0.2, p.shape).astype(np.float32)),
        params)
    return params, np.asarray(module.apply({"params": params},
                                           jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["mlp_block", "mlp", "channel_ln",
                                  "conv_t", "gelu"])
def test_common_layers_match_jax(kind):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 5, 6, 16)).astype(np.float32)
    xt = torch.from_numpy(x)
    if kind == "gelu":
        np.testing.assert_allclose(common.gelu(xt).numpy(),
                                   np.asarray(jcommon.gelu(x)), **TOL)
        return
    if kind == "mlp_block":
        jm, tm = jcommon.MLPBlock(mlp_dim=32, out_dim=16), common.MLPBlock(
            16, 32)
    elif kind == "mlp":
        jm = jcommon.MLP(hidden_dim=24, output_dim=8, num_layers=3,
                         sigmoid_output=True)
        tm = common.MLP(16, 24, 8, 3, sigmoid_output=True)
    elif kind == "channel_ln":
        jm, tm = jcommon.ChannelLayerNorm(), common.ChannelLayerNorm(16)
    else:
        jm, tm = jcommon.ConvTranspose2x2(out_features=4), \
            common.ConvTranspose2x2(16, 4)
    params, want = _run_flax(jm, x)
    p = jax_tree_to_numpy(params)
    sd = {}
    if kind == "mlp_block":
        for n in ("lin1", "lin2"):
            sd[f"{n}.weight"] = _t(p[n]["kernel"].T)
            sd[f"{n}.bias"] = _t(p[n]["bias"])
    elif kind == "mlp":
        for i in range(3):
            sd[f"layers.{i}.weight"] = _t(p[f"layers_{i}"]["kernel"].T)
            sd[f"layers.{i}.bias"] = _t(p[f"layers_{i}"]["bias"])
    elif kind == "channel_ln":
        sd = {"weight": _t(p["weight"]), "bias": _t(p["bias"])}
    else:
        k = p["dense"]["kernel"]
        sd = {"weight": _t(k.reshape(16, 2, 2, 4).transpose(0, 3, 1, 2)),
              "bias": _t(p["dense"]["bias"][:4])}
        # ConvTranspose2x2's bias is tiled 4x in the JAX layout.
        params["dense"]["bias"] = jnp.tile(params["dense"]["bias"][:4], 4)
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(xt).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cast_compute_params_keeps_norms_f32():
    m = torch.nn.Sequential(common.Linear(8, 8), common.LayerNorm(8))
    common.cast_compute_params(m, torch.bfloat16)
    assert m[0].weight.dtype == torch.bfloat16
    assert m[1].weight.dtype == torch.float32
    y = m(torch.randn(3, 8))
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("n,d,eps", [(37, 256, 1e-5), (130, 64, 1e-6),
                                     (9, 1024, 1e-5)])
def test_plain_backward_matches_jax_grad(n, d, eps):
    """K1's plain backward (autograd of the plain version: dx, dw, db)
    against jax.grad of the JAX package's float32 `_ln_impl`, on one
    output gradient: within 1e-4 (float32 sums in another order)."""
    from crowdsam_tpu_torch.ops.layernorm import layer_norm_grads_plain

    x, w, b = _inputs(n, d, seed=2)
    g = np.random.default_rng(3).normal(size=(n, d)).astype(np.float32)

    def f(x, w, b):
        return jnp.sum(jcommon._ln_impl(x, w, b, eps, jnp.float32) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b))
    got = layer_norm_grads_plain(torch.from_numpy(g), torch.from_numpy(x),
                                 torch.from_numpy(w), torch.from_numpy(b),
                                 eps)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(e).max()))


def test_layer_norm_on_cpu_passes_gradients():
    """On the CPU the wrapper is the plain version, autograd included:
    the same gradients as layer_norm_grads_plain."""
    from crowdsam_tpu_torch.ops.layernorm import layer_norm_grads_plain

    x, w, b = (torch.from_numpy(a) for a in _inputs(20, 128, seed=4))
    g = torch.randn(20, 128, generator=torch.Generator().manual_seed(0))
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    (layer_norm(xr, wr, br, 1e-5) * g).sum().backward()
    for got, want in zip((xr.grad, wr.grad, br.grad),
                         layer_norm_grads_plain(g, x, w, b, 1e-5)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_backward_refuses_rows_wider_than_its_kernel():
    """K1's forward takes SAM ViT-H's 1280, its backward kernel stops at
    1024 (no training path is wider): a wider row is refused by name, before
    anything reaches the card."""
    from crowdsam_tpu_torch.ops import layernorm as ln

    assert (ln.MAX_WIDTH, ln.MAX_BWD_WIDTH) == (1280, 1024)
    x = torch.zeros((4, 1280))
    w = torch.ones(1280)
    stats = torch.zeros(4)
    with pytest.raises(ValueError, match=r"layer_norm_backward: width 1280 "
                                         r"outside \(0, 1024\]"):
        ln.layer_norm_backward(x, x, w, stats, stats)
    with pytest.raises(ValueError, match=r"layer_norm: width 1281"):
        ln._forward(torch.zeros((4, 1281)), torch.ones(1281),
                    torch.zeros(1281), 1e-6, stats=False)
