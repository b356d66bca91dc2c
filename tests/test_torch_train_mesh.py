"""The trainer's mesh step (`AdapterTrainer.loss_and_grads(..., mesh=...)`)
against the JAX `_build_step(cache, mesh=create_mesh(shape))` on the CPU.

The vit_tiny + dinov2_vits14 setup of `tests/test_torch_train.py` in
float32 (2 shots; JAX's cache handed to the port, so that only the step
is compared; the full-decoder trainer's cache for every case),
`samples_per_batch = 2 * data` as `dryrun_multichip` sets it, on (2, 2)
and (4, 2) meshes, head-only and full-decoder, two steps
each with JAX's own draws; and one uneven prompt split: 3 + 3 prompts
over 4 data ranks (2 / 2 / 1 / 1, one rank holding a positive and a
negative), head-only.  The port's ranks are gloo processes spawned once
for the file (importing only the port); the JAX side runs on the 8 host
devices of `conftest.py`.

The JAX mesh step runs on every case, one compile each; so does the
port's one-process step.

Tolerances, as `tests/test_torch_train.py` states them: the loss terms
within 1e-5 relative; the gradients within 1e-5 of the global gradient
norm; the leaves after the steps within 1e-2 lr steps.  The same bounds
against the port's one-process step on the same draws; every rank's
terms, gradients and leaves equal to rank 0's bit for bit; the all-reduces
counted: one a step for the pooled DINO features over `model`, one each
for the gradients over `model` and `data`, one for the loss terms over
`data`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_train import (
    _as_port,
    _grad_err,
    _jax_predictor,
    _numpy_tree,
    _rel,
    dataset,  # noqa: F401 (module fixture)
)

import crowdsam_tpu.train.trainer as jax_trainer
from crowdsam_tpu.config import load_config as jax_load_config
from crowdsam_tpu.config import modify_config as jax_modify_config
from crowdsam_tpu.parallel.mesh import create_mesh as jax_create_mesh
from torch_ranks import train_mesh_rank

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.models.build import sam_model_registry
from crowdsam_tpu_torch.models.dinov2 import dino_model_registry
from crowdsam_tpu_torch.parallel.launch import run_ranks
from crowdsam_tpu_torch.pipeline.predictor import SamPredictor
from crowdsam_tpu_torch.train.trainer import AdamW, AdapterTrainer
from crowdsam_tpu_torch.utils import init

STEPS = 2
LR = {False: 1e-3, True: 1e-5}
# (mesh shape, full decoder, positives): positives 2 * data but for the
# uneven split.
CASES = [((2, 2), False, 4), ((2, 2), True, 4), ((4, 2), False, 8),
         ((4, 2), True, 8), ((4, 2), False, 3)]
IDS = ["2x2-head", "2x2-full", "4x2-head", "4x2-full", "4x2-head-uneven"]
# The cases also run by the JAX mesh step (each a compile of ~12-27 s).
JAX_CASES = list(range(len(CASES)))


def _opts(full, pos):
    out = ["train.n_shot", "2", "train.steps", str(STEPS),
           "train.samples_per_batch", str(pos), "train.lr", str(LR[full]),
           "tpu.compute_dtype", "float32"]
    return out + (["train.full_decoder", "True"] if full else [])


def _jax_cache(dataset):
    """JAX's cache of the full-decoder trainer (the boxes as filled
    rectangles), for every case: the step reads only the cache."""
    cfg = jax_modify_config(jax_load_config(None), _opts(True, 4))
    jt = jax_trainer.AdapterTrainer(cfg, _jax_predictor())
    return jt.cache_features(dataset), jt


def _jax_run(jt, cache, shape, full, pos, run=True):
    """JAX's draws of each step and, with `run`, the JAX mesh step: each
    step's loss terms, gradients (caught inside the jitted step) and the
    adapter after the steps."""
    cfg = jax_modify_config(jax_load_config(None), _opts(full, pos))
    jt = jax_trainer.AdapterTrainer(cfg, jt.predictor)
    adapter, frozen = jax_trainer.split_adapter_params(
        jt.sam.params["mask_decoder"], full=full)
    grads = []
    real = jax.value_and_grad

    def value_and_grad(fn, **kw):
        inner = real(fn, **kw)

        def wrapped(*a):
            out = inner(*a)
            jax.debug.callback(lambda g: grads.append(_numpy_tree(g)),
                               out[1])
            return out
        return wrapped

    mesh = jax_create_mesh(shape)
    key = jax.random.PRNGKey(jt.seed)
    r = jt.low_res
    out = {"draws": [], "losses": [], "start": _numpy_tree(adapter)}
    with mesh:
        tx, step_fn = jt._build_step(cache, mesh=mesh)
        state = tx.init(adapter)
        for step in range(STEPS):
            shot = step % 2
            sk = jax.random.fold_in(key, step)
            k1, k2, k3 = jax.random.split(sk, 3)
            nb = int(cache["n_boxes"][shot])
            out["draws"].append(tuple(torch.from_numpy(np.array(a)) for a in (
                jax.random.randint(k1, (pos,), 0, nb),
                jax.random.gumbel(k2, (pos, r * r)),
                jax.random.gumbel(k3, (r * r,)))))
            if not run:
                continue
            jax_trainer.jax.value_and_grad = value_and_grad
            try:
                adapter, state, _, ls = step_fn(adapter, frozen, state,
                                                jnp.int32(shot), sk)
                jax.effects_barrier()
            finally:
                jax_trainer.jax.value_and_grad = real
            out["losses"].append({k: float(v) for k, v in ls.items()})
    out["grads"], out["params"] = grads, _numpy_tree(adapter)
    return out


def _port_cache(cache, sam):
    return {"features": torch.from_numpy(np.array(cache["features"])),
            "dino_feats": torch.from_numpy(np.array(cache["dino_feats"])),
            "target_masks": torch.from_numpy(np.array(
                cache["target_masks"])),
            "fg_mask": torch.from_numpy(np.array(cache["fg_mask"])),
            "n_boxes": [int(n) for n in cache["n_boxes"]],
            "img_hw": torch.from_numpy(np.array(cache["img_hw"])),
            "dense_pe": sam.prompt_encoder.get_dense_pe().detach()}


def _port_sam():
    sam = sam_model_registry["vit_tiny"](n_class=1, dino_dim=384)
    sam.load_state_dict(init.sam_state_dict("vit_tiny", 0, None, 1, 384),
                        strict=False)
    return sam


def _one_process(sam, case):
    """The port's one-process steps of a case: per step (total, terms,
    gradients), and the leaves after them."""
    trainer = AdapterTrainer(
        modify_config(load_config(None), list(case["opts"])),
        SamPredictor(sam, dino_model_registry["dinov2_vits14"](),
                     device="cpu"))
    trainer.cache = case["cache"]
    params = {k: v.clone() for k, v in case["params"].items()}
    opt = AdamW(trainer.lr, trainer.weight_decay, trainer.clip_grad)
    state = opt.init(params)
    steps = []
    for shot, draws in case["steps"]:
        steps.append(trainer.loss_and_grads(params, shot, draws))
        opt.step(params, steps[-1][2], state)
    return steps, params


@pytest.fixture(scope="module")
def mesh_runs(dataset, tmp_path_factory):  # noqa: F811
    """Per case: the JAX run, the port's one-process steps and its ranks'
    mesh steps (one spawn of 8 ranks for every case)."""
    sam = _port_sam()
    cache, jt = _jax_cache(dataset)
    jax_runs, cases = [], []
    for i, (shape, full, pos) in enumerate(CASES):
        ref = _jax_run(jt, cache, shape, full, pos, i in JAX_CASES)
        jax_runs.append(ref)
        cases.append(dict(
            mesh=shape, opts=_opts(full, pos),
            cache=_port_cache(cache, sam),
            params={k: torch.from_numpy(np.array(v)) for k, v in
                    _as_port(ref["start"], full).items()},
            steps=[(s % 2, d) for s, d in enumerate(ref["draws"])]))
    one = [_one_process(sam, case) for case in cases]
    ranks = run_ranks(train_mesh_rank, 8, (sam.state_dict(), cases),
                      join_timeout_s=240.0,
                      workdir=str(tmp_path_factory.mktemp("ranks")))
    return jax_runs, one, ranks


@pytest.mark.parametrize("i", JAX_CASES, ids=[IDS[i] for i in JAX_CASES])
def test_mesh_step_matches_jax_mesh_step(mesh_runs, i):
    """Rank 0's loss terms and gradients of each step, and its leaves
    after the steps, against the JAX mesh step on the same mesh shape."""
    jax_runs, _, ranks = mesh_runs
    shape, full, _ = CASES[i]
    ref, got = jax_runs[i], ranks[0][i]
    assert len(ref["grads"]) == STEPS
    for s, step in enumerate(got["steps"]):
        want = ref["losses"][s]
        assert set(step["terms"]) == set(want)
        assert full == ("mask_dice_loss" in want)
        for k, v in want.items():
            assert _rel(step["terms"][k], v) <= 1e-5, (s, k)
        assert _grad_err(step["grads"], ref["grads"][s], full) <= 1e-5, s
    want = _as_port(ref["params"], full)
    start = _as_port(ref["start"], full)
    for k, v in want.items():
        assert float((got["params"][k] - v).abs().max()) <= \
            1e-2 * LR[full] * STEPS, k
    assert all(float((got["params"][k] - start[k]).abs().max()) > 0
               for k in start), "a trainable leaf did not move"


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_mesh_step_matches_one_process(mesh_runs, i):
    """The same bounds against the port's one-process step; each rank's
    prompt share, as `split_rows` cuts the step's prompts over `data`."""
    _, one, ranks = mesh_runs
    shape, full, pos = CASES[i]
    steps, params = one[i]
    got = ranks[0][i]
    for (total, terms, grads), step in zip(steps, got["steps"]):
        norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                    for g in grads.values())))
        assert _rel(step["total"], float(total)) <= 1e-5
        for k, v in terms.items():
            assert _rel(step["terms"][k], float(v)) <= 1e-5, k
        assert max(float((step["grads"][k] - g).abs().max())
                   for k, g in grads.items()) <= 1e-5 * norm
    for k, v in params.items():
        assert float((got["params"][k] - v).abs().max()) <= \
            1e-2 * LR[full] * STEPS, k
    d = shape[0]
    n = 2 * pos
    sizes = [n // d + (j < n % d) for j in range(d)]
    for rank, r in enumerate(ranks[:d * shape[1]]):
        lo = sum(sizes[:rank // shape[1]])
        assert r[i]["steps"][0]["prompts"] == (lo, lo + sizes[rank
                                                               // shape[1]])


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_every_rank_equals_rank_zero(mesh_runs, i):
    """Loss terms, gradients and leaves bit for bit alike on every rank of
    the mesh; ranks outside it skip the case; four all-reduces a step:
    the pooled features and the gradients over `model`, the gradients and
    the loss terms over `data`, with the bytes they reduce."""
    _, _, ranks = mesh_runs
    shape, full, pos = CASES[i]
    n_ranks = shape[0] * shape[1]
    first = ranks[0][i]
    n_grad = sum(g.numel() for g in first["steps"][0]["grads"].values())
    n_terms = len(first["steps"][0]["terms"])
    for r in ranks[n_ranks:]:
        assert r[i] is None
    for rank, r in enumerate(ranks[:n_ranks]):
        got = r[i]
        for a, b in zip(got["steps"], first["steps"]):
            assert a["terms"] == b["terms"] and a["total"] == b["total"]
            for k in b["grads"]:
                assert torch.equal(a["grads"][k], b["grads"][k]), (rank, k)
        for k, v in first["params"].items():
            assert torch.equal(got["params"][k], v), (rank, k)
        lo, hi = got["steps"][0]["prompts"]
        pooled = 4 * (hi - lo) * 4 * 256          # (P, K, 256) float32
        for step in got["steps"]:
            assert step["all_reduces"] == (2, 2)
            assert step["bytes"] == (4 * n_grad + 4 * n_terms,
                                     pooled + 4 * n_grad)
