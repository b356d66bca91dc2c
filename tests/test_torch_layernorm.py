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


# How K1's kernels lay rows out (`forward_plan`, `backward_plan`: the
# source's `ln_plan` gives the same on the card, `tests/test_torch_cuda.py`
# holds the two together).  H100 figures: 132 SMs, 2-4 resident blocks.

@pytest.mark.parametrize("d,dtype,arm", [
    (4, torch.bfloat16, None), (4, torch.float32, (1, 1)),
    (8, torch.bfloat16, (1, 1)), (16, torch.bfloat16, (2, 1)),
    (16, torch.float32, (4, 1)), (64, torch.bfloat16, (8, 1)),
    (64, torch.float32, (16, 1)), (72, torch.bfloat16, (16, 1)),
    (72, torch.float32, (32, 1)), (100, torch.bfloat16, None),
    (100, torch.float32, (32, 1)), (256, torch.bfloat16, (32, 1)),
    (256, torch.float32, (32, 2)), (512, torch.bfloat16, (32, 2)),
    (1024, torch.bfloat16, (32, 4)), (1024, torch.float32, (32, 8)),
    (1280, torch.bfloat16, (32, 5)), (1280, torch.float32, (32, 10))])
def test_vector_arm_by_width(d, dtype, arm):
    """Widths that are a multiple of a 16-byte vector take the vector arm:
    up to 16 vectors a row on a power of two of lanes, wider rows one warp
    with 2-10 vectors a lane; the others (the serving head's width 4 in
    bf16) the scalar arm."""
    from crowdsam_tpu_torch.ops.layernorm import vector_arm

    assert vector_arm(d, dtype) == arm
    if arm is not None:
        lanes, vpl = arm
        vec = 16 // dtype.itemsize
        assert d // vec <= lanes * vpl            # every vector has a lane
        assert lanes == 32 or d // vec > lanes // 2


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 33, 420, 2111, 5330, 245760,
                                  983040, 10 ** 7 + 3])
def test_backward_blocks_take_every_row_once(rows, sms):
    """`backward_blocks` splits the rows into contiguous ranges of
    ceil(rows / blocks): every row lands in exactly one block, no block
    holds more than its share, and the grid stays within two blocks an SM
    (all resident at once: the last block's tickets never wait)."""
    from crowdsam_tpu_torch.ops import layernorm as ln

    blocks = ln.backward_blocks(rows, sms)
    assert 1 <= blocks <= min(ln.BWD_BLOCKS_PER_SM * sms,
                              ln.GROUP * ln.MAX_GROUPS)
    per = -(-rows // blocks)
    seen = np.zeros(rows, dtype=np.int64)
    for k in range(blocks):
        lo, hi = k * per, min((k + 1) * per, rows)
        if hi > lo:
            seen[lo:hi] += 1
    assert (seen == 1).all()
    assert ln.backward_blocks(0, sms) == 0


@pytest.mark.parametrize("occ", [1, 3, 4])
@pytest.mark.parametrize("rows,d,dtype", [
    (1, 64, torch.bfloat16), (37, 256, torch.bfloat16),
    (4096, 16, torch.bfloat16), (4096, 256, torch.bfloat16),
    (5330, 1024, torch.bfloat16), (4096, 1280, torch.bfloat16),
    (131072, 256, torch.bfloat16), (524288, 64, torch.bfloat16),
    (70001, 64, torch.float32), (1000, 1280, torch.float32),
    (16384, 4, torch.bfloat16)])
def test_forward_plan_takes_every_row_once(rows, d, dtype, occ):
    """The forward's chunks tile the rows (the last one ragged), the
    blocks walk chunks b, b + grid, ... so each chunk has one block; the
    ring's chunk is whole row groups of every warp at most GPW deep and
    fits (3 stages in 227 KB), its grid the resident blocks, each with
    more than two chunks; else the direct kernel, a row group a warp."""
    from crowdsam_tpu_torch.ops import layernorm as ln

    sms = 132
    plan = ln.forward_plan(rows, d, dtype, sms, occ)
    ch, chunks, grid = plan["chunk_rows"], plan["chunks"], plan["grid"]
    assert (chunks - 1) * ch < rows <= chunks * ch
    owner = np.full(chunks, -1)
    for b in range(grid):
        assert (owner[b::grid] == -1).all()
        owner[b::grid] = b
    assert (owner >= 0).all()
    if plan["arm"] is None:
        assert grid == chunks == -(-rows // ln.WARPS)
        return
    lanes, vpl = plan["arm"]
    assert plan["rows_per_group"] == 32 // lanes
    groups = ch // plan["rows_per_group"]
    assert groups * plan["rows_per_group"] == ch
    if plan["direct"]:          # G row groups a warp, a chunk a block
        g = groups // ln.WARPS
        assert g * ln.WARPS == groups and grid == chunks
        assert 1 <= g <= (ln.DIRECT_GROUPS if vpl <= 2 else 1)
        assert g == 1 or (-(-rows // (ln.WARPS * plan["rows_per_group"]))
                          > ln.DIRECT_BLOCKS_PER_SM * sms)
        return
    assert grid == sms * occ < chunks / 2
    assert groups <= ln.WARPS * max(1, 4 // vpl)
    assert groups <= ln.WARPS or groups % ln.WARPS == 0
    ring = ln.STAGES * ch * d * dtype.itemsize + 8 * d + 8 * ln.STAGES
    assert ring <= 227 * 1024


@pytest.mark.parametrize("rows,d,dtype", [
    (983040, 64, torch.bfloat16), (245760, 256, torch.bfloat16),
    (420, 256, torch.bfloat16), (5330, 1024, torch.float32),
    (1, 4, torch.bfloat16), (100003, 64, torch.float32),
    (1500, 1024, torch.bfloat16), (7, 100, torch.float32)])
def test_backward_plan_chunks_fit_a_block(rows, d, dtype):
    """A backward block reads its range in chunks of whole row groups (at
    most 2 / VPL deep a warp; 4 warps a block at 8 vectors a lane), the
    three stages of x and dy in 96 KB or less (two blocks an SM); the
    main path's shapes take the vector arm."""
    from crowdsam_tpu_torch.ops import layernorm as ln

    plan = ln.backward_plan(rows, d, dtype, 132)
    assert plan["grid"] == ln.backward_blocks(rows, 132)
    assert plan["rows_per_block"] == -(-rows // plan["grid"])
    if plan["arm"] is None:
        assert (d * dtype.itemsize) % 16 != 0
        return
    lanes, vpl = plan["arm"]
    warps = 4 if vpl >= 8 else ln.WARPS
    groups = plan["chunk_rows"] // plan["rows_per_group"]
    assert groups <= warps * max(1, 2 // vpl)
    assert ln.STAGES * 2 * plan["chunk_rows"] * d * dtype.itemsize \
        <= 96 * 1024
    assert not plan["direct"]


def test_plans_at_the_main_paths_shapes():
    """The unfused decoder's upscaling LayerNorm runs the 8-lane arm over
    a ring of 128-row chunks on every resident block; DINOv2's blocks the
    direct kernel, a row a warp (two ring chunks a block or fewer); the
    training step's backward 264 blocks of 3724 rows."""
    from crowdsam_tpu_torch.ops import layernorm as ln

    up = ln.forward_plan(524288, 64, torch.bfloat16, 132, 4)
    assert (up["arm"], up["rows_per_group"], up["chunk_rows"], up["grid"],
            up["chunks"], up["direct"]) == ((8, 1), 4, 128, 528, 4096, False)
    enc = ln.forward_plan(5330, 1024, torch.bfloat16, 132, 3)
    assert (enc["arm"], enc["chunk_rows"], enc["grid"], enc["direct"]) == (
        (32, 4), 8, 667, True)
    bwd = ln.backward_plan(983040, 64, torch.bfloat16, 132)
    assert (bwd["grid"], bwd["rows_per_block"], bwd["chunk_rows"]) == (
        264, 3724, 64)
