"""The port's trainer against the JAX package's on the CPU.

The vit_tiny + dinov2_vits14 setup of `tests/test_trainer.py` in float32
(2 shots, 4 positive and 4 negative prompts), with the same weights (the
JAX package's numpy draws on both sides), the same frames (the first two
of the synthetic 10-shot set, resized once to the model's 256 long side so
that neither package resizes them again) and JAX's own draws fed to the
port: `fold_in(PRNGKey(seed), step)` split into k1, k2, k3 as the JAX
trainer splits it.

Tolerances:
- the cache: features within 1e-4, targets equal;
- every loss term of every step within 1e-5 relative: 6 head-only steps
  at lr 1e-3, 4 full-decoder steps at lr 1e-5 (the config's), and each
  full-decoder step again from JAX's own parameters of that step;
- the gradients of those steps within 1e-5 of the global gradient norm;
- the trained leaves within 1e-2 lr steps of JAX's (an Adam step moves a
  leaf by about lr);
- bf16 compute: the first step's loss terms within 2e-2 of the step's
  total loss (bf16 rounds at other places in the two frameworks);
- the frozen leaves bit for bit unchanged; a resumed run equal to an
  uninterrupted one bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import crowdsam_tpu.train.trainer as jax_trainer
from crowdsam_tpu.config import load_config as jax_load_config
from crowdsam_tpu.config import modify_config as jax_modify_config
from crowdsam_tpu.models.build import sam_model_registry as jax_registry
from crowdsam_tpu.models.dinov2 import dino_model_registry as jax_dinos
from crowdsam_tpu.pipeline.predictor import SamPredictor as JaxPredictor
from crowdsam_tpu.train import losses as jax_losses
from crowdsam_tpu.utils.init import fast_random_init

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.models.build import sam_model_registry
from crowdsam_tpu_torch.models.dinov2 import dino_model_registry
from crowdsam_tpu_torch.ops.transforms import ResizeLongestSide
from crowdsam_tpu_torch.pipeline.predictor import SamPredictor
from crowdsam_tpu_torch.train import losses
from crowdsam_tpu_torch.train.dataset import ArrayDataset
from crowdsam_tpu_torch.train.trainer import (
    AdamW,
    AdapterTrainer,
    merge_params,
    split_adapter_params,
)
from crowdsam_tpu_torch.utils import init
from crowdsam_tpu_torch.utils.fixtures import ten_shot_arrays
from crowdsam_tpu_torch.utils.weights import mask_decoder_state_dict

POS = 4


def _opts(full, lr, dtype="float32", steps=6):
    out = ["train.n_shot", "2", "train.steps", str(steps),
           "train.samples_per_batch", str(POS), "train.lr", str(lr),
           "tpu.compute_dtype", dtype]
    return out + (["train.full_decoder", "True"] if full else [])


@pytest.fixture(scope="module")
def dataset():
    imgs, boxes = ten_shot_arrays(0, n_images=2)
    return ArrayDataset([ResizeLongestSide(256).apply_image(i)
                         for i in imgs], boxes)


def _jax_predictor(dtype=jnp.float32):
    sam = jax_registry["vit_tiny"](n_class=1, dtype=dtype, dino_dim=384)
    dino = jax_dinos["dinov2_vits14"](dtype=dtype)
    params = fast_random_init(dino, jnp.zeros((1, 28, 28, 3)), seed=0)
    return JaxPredictor(sam, dino, params)


def _port_predictor(dtype=torch.float32):
    from crowdsam_tpu_torch.models.common import cast_compute_params

    sam = sam_model_registry["vit_tiny"](n_class=1, dino_dim=384)
    sam.load_state_dict(init.sam_state_dict("vit_tiny", 0, None, 1, 384),
                        strict=False)
    dino = dino_model_registry["dinov2_vits14"]()
    dino.load_state_dict(init.dino_state_dict("dinov2_vits14", 0))
    return SamPredictor(cast_compute_params(sam, dtype),
                        cast_compute_params(dino, dtype), device="cpu")


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_jax(dataset, full, lr, steps, dtype=jnp.float32):
    """JAX's trainer step by step: per step its draws, loss terms,
    gradients (captured from inside the jitted step) and adapter after the
    update; also its cache."""
    pred = _jax_predictor(dtype)
    cfg = jax_modify_config(jax_load_config(None),
                            _opts(full, lr, steps=steps))
    jt = jax_trainer.AdapterTrainer(cfg, pred)
    cache = jt.cache_features(dataset)
    adapter, frozen = jax_trainer.split_adapter_params(
        pred.model.params["mask_decoder"], full=full)
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

    tx, step_fn = jt._build_step(cache)
    state = tx.init(adapter)
    key = jax.random.PRNGKey(jt.seed)
    r = jt.low_res
    out = {"draws": [], "losses": [], "params": [_numpy_tree(adapter)],
           "cache": cache, "frozen": frozen}
    for step in range(steps):
        shot = step % 2
        sk = jax.random.fold_in(key, step)
        k1, k2, k3 = jax.random.split(sk, 3)
        nb = int(cache["n_boxes"][shot])
        out["draws"].append(tuple(torch.from_numpy(np.array(a)) for a in (
            jax.random.randint(k1, (POS,), 0, nb),
            jax.random.gumbel(k2, (POS, r * r)),
            jax.random.gumbel(k3, (r * r,)))))
        # The step traces (and reads jax.value_and_grad) at its first call.
        jax_trainer.jax.value_and_grad = value_and_grad
        try:
            adapter, state, _, ls = step_fn(adapter, frozen, state,
                                            jnp.int32(shot), sk)
            jax.effects_barrier()
        finally:
            jax_trainer.jax.value_and_grad = real
        out["losses"].append({k: float(v) for k, v in ls.items()})
        out["params"].append(_numpy_tree(adapter))
    out["grads"] = grads
    return out


def _as_port(tree, full):
    """A JAX adapter tree -> the port's trainable names (f32 tensors)."""
    if not full:
        tree = {k: tree[k] for k in ("parallel_iou_head", "point_classifier",
                                     "dino_proj")}
        sd = {}
        from crowdsam_tpu_torch.utils import weights
        weights._lin(sd, "dino_proj", tree["dino_proj"])
        weights._mlp(sd, "parallel_iou_head", tree["parallel_iou_head"])
        weights._mlp(sd, "point_classifier", tree["point_classifier"])
        return sd
    return mask_decoder_state_dict(tree)


def _port_trainer(dataset, full, lr, steps, dtype=torch.float32):
    pred = _port_predictor(dtype)
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    cfg = modify_config(load_config(None), _opts(full, lr, dname, steps))
    trainer = AdapterTrainer(cfg, pred)
    trainer.cache_features(dataset)
    return trainer


def _grad_err(port_grads, jax_grads, full):
    want = _as_port(jax_grads, full)
    norm = float(np.sqrt(sum(float((v.double() ** 2).sum())
                             for v in want.values())))
    err = max(float((port_grads[k] - want[k]).abs().max()) for k in want)
    assert set(port_grads) == set(want)
    return err / norm


def _recorder(history):
    """An `on_step` callback that keeps each step's loss terms as floats."""
    return lambda step, ls: history.append({k: float(v)
                                            for k, v in ls.items()})


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.fixture(scope="module")
def head_only(dataset):
    steps = 6
    ref = _run_jax(dataset, False, 1e-3, steps)
    trainer = _port_trainer(dataset, False, 1e-3, steps)
    before = {k: v.clone() for k, v in
              trainer.sam.mask_decoder.state_dict().items()}
    first = trainer.loss_and_grads(trainer.trainable_params(), 0,
                                   ref["draws"][0])
    history = []
    params = trainer.train(dataset, draws=lambda s: ref["draws"][s],
                           on_step=_recorder(history))
    return dict(ref=ref, trainer=trainer, history=history, params=params,
                first=first, before=before)


def test_cache_matches_jax(head_only):
    ref, trainer = head_only["ref"], head_only["trainer"]
    np.testing.assert_allclose(trainer.cache["features"].numpy(),
                               np.asarray(ref["cache"]["features"]),
                               atol=1e-4)
    np.testing.assert_array_equal(trainer.cache["target_masks"].numpy(),
                                  np.asarray(ref["cache"]["target_masks"]))
    assert trainer.cache["n_boxes"] == [int(n) for n in
                                        ref["cache"]["n_boxes"]]


def test_head_only_steps_match_jax(head_only):
    ref, history = head_only["ref"], head_only["history"]
    assert len(history) == 6
    for got, want in zip(history, ref["losses"]):
        assert set(got) == set(want)
        for k in want:
            assert _rel(got[k], want[k]) <= 1e-5, (k, got[k], want[k])


def test_head_only_first_gradients_match_jax(head_only):
    _, _, grads = head_only["first"]
    assert _grad_err(grads, head_only["ref"]["grads"][0], False) <= 1e-5


def test_head_only_leaves_and_frozen(head_only):
    ref, params, trainer = (head_only["ref"], head_only["params"],
                            head_only["trainer"])
    want = _as_port(ref["params"][-1], False)
    lr, steps = 1e-3, 6
    for k, v in want.items():
        assert float((params[k] - v).abs().max()) <= 1e-2 * lr * steps, k
    start = _as_port(ref["params"][0], False)
    assert all(float((params[k] - start[k]).abs().max()) > 0
               for k in start), "a trainable leaf did not move"
    after = trainer.sam.mask_decoder.state_dict()
    for k, v in head_only["before"].items():
        if k not in params:
            assert torch.equal(after[k], v), k
        else:
            assert torch.equal(after[k], params[k]), k


@pytest.fixture(scope="module")
def full_decoder(dataset):
    steps, lr = 4, 1e-5
    ref = _run_jax(dataset, True, lr, steps)
    trainer = _port_trainer(dataset, True, lr, steps)
    forced = [trainer.loss_and_grads(
        {k: torch.from_numpy(np.array(v)) for k, v in
         _as_port(ref["params"][s], True).items()}, s % 2, ref["draws"][s])
        for s in range(steps)]
    history = []
    params = trainer.train(dataset, draws=lambda s: ref["draws"][s],
                           on_step=_recorder(history))
    return dict(ref=ref, forced=forced, history=history, params=params,
                steps=steps, lr=lr)


def test_full_decoder_steps_match_jax(full_decoder):
    """Each step from JAX's parameters of that step (teacher-forced)."""
    ref = full_decoder["ref"]
    for s, (_, got, grads) in enumerate(full_decoder["forced"]):
        want = ref["losses"][s]
        assert set(got) == set(want) and "mask_dice_loss" in got
        for k in want:
            assert _rel(float(got[k]), want[k]) <= 1e-5, (s, k)
        assert _grad_err(grads, ref["grads"][s], True) <= 1e-5, s


def test_full_decoder_run_matches_jax(full_decoder):
    ref, params = full_decoder["ref"], full_decoder["params"]
    steps, lr = full_decoder["steps"], full_decoder["lr"]
    for got, want in zip(full_decoder["history"], ref["losses"]):
        for k, v in want.items():
            assert _rel(got[k], v) <= 1e-5, k
    want = _as_port(ref["params"][-1], True)
    assert set(params) == set(want)
    for k, v in want.items():
        assert float((params[k] - v).abs().max()) <= 1e-2 * lr * steps, k
    start = _as_port(ref["params"][0], True)
    moved = [k for k in start if float((params[k] - start[k]).abs().max())
             > 0]
    assert len(moved) == len(start)


def test_bf16_first_step_near_jax(dataset):
    """bf16 compute on both sides, one full-decoder step."""
    ref = _run_jax(dataset, True, 1e-5, 1, dtype=jnp.bfloat16)
    trainer = _port_trainer(dataset, True, 1e-5, 1, dtype=torch.bfloat16)
    _, got, _ = trainer.loss_and_grads(trainer.trainable_params(), 0,
                                       ref["draws"][0])
    want = ref["losses"][0]
    total = sum(want.values())
    for k in want:
        assert abs(float(got[k]) - want[k]) <= 2e-2 * total, k


def test_resume_equals_uninterrupted(dataset, tmp_path):
    a = _port_trainer(dataset, True, 1e-4, 4)
    whole = a.train(dataset)
    b = _port_trainer(dataset, True, 1e-4, 4)
    b.train(dataset, checkpoint_dir=str(tmp_path), checkpoint_every=2,
            stop_after=2)
    assert os.path.exists(tmp_path / "trainer_state.msgpack")
    c = _port_trainer(dataset, True, 1e-4, 4)
    resumed = c.train(dataset, checkpoint_dir=str(tmp_path),
                      checkpoint_every=2)
    for k in whole:
        assert torch.equal(whole[k], resumed[k]), k


def test_adamw_matches_optax():
    """Three steps, clipped (norm above 0.1) and not: within 1e-6."""
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(5, 3)).astype(np.float32),
         "b": rng.normal(size=(7,)).astype(np.float32)}
    tx = optax.chain(optax.clip_by_global_norm(0.1),
                     optax.adamw(1e-3, weight_decay=1e-4))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    opt = AdamW(1e-3, 1e-4, 0.1)
    ts = opt.init(tp)
    for scale in (1.0, 1e-3, 0.5):
        g = {k: (scale * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in p.items()}
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)
    assert int(ts["count"]) == 3


def test_split_merge_roundtrip():
    tree = {"dino_proj.weight": 1, "parallel_iou_head.layers.0.weight": 2,
            "point_classifier.layers.0.bias": 3,
            "transformer.layers.0.norm1.weight": 4, "iou_token.weight": 5,
            "output_hypernetworks_mlps.4.layers.0.weight": 6}
    adapter, frozen = split_adapter_params(tree)
    assert set(adapter) == {"dino_proj.weight",
                            "parallel_iou_head.layers.0.weight",
                            "point_classifier.layers.0.bias"}
    assert merge_params(adapter, frozen) == tree
    full, rest = split_adapter_params(tree, full=True)
    assert set(rest) == {"output_hypernetworks_mlps.4.layers.0.weight"}
    assert len(full) == 5


def test_losses_match_jax():
    """Every term of `adapter_loss` (mask dice and hinge included), dice,
    mIoU and the focal loss: within 1e-6 relative."""
    p, k, r = 6, 4, 16
    rng = np.random.default_rng(0)
    args = (rng.normal(size=(p, k, r, r)).astype(np.float32),
            rng.uniform(size=(p, k)).astype(np.float32),
            rng.normal(size=(1, r, r)).astype(np.float32),
            rng.uniform(size=(3, r, r)) > 0.5,
            (rng.uniform(size=(r, r)) > 0.5).astype(np.float32),
            (rng.uniform(size=(r, r)) > 0.2).astype(np.float32))
    kw = dict(num_pos=3, mask_loss=True, neg_hinge_weight=4.0,
              neg_hinge_margin=0.05)
    want = jax_losses.adapter_loss(*(jnp.asarray(a) for a in args), **kw)
    got = losses.adapter_loss(*(torch.from_numpy(np.asarray(a)).float()
                                for a in args), **kw)
    assert set(got) == set(want) and len(got) == 5
    for key in want:
        assert _rel(float(got[key]), float(want[key])) <= 1e-6, key
    x = torch.from_numpy(args[0])
    t = torch.from_numpy(args[3][:, None].astype(np.float32))
    np.testing.assert_allclose(
        losses.dice_loss(x[:3], t).numpy(),
        np.asarray(jax_losses.dice_loss(jnp.asarray(args[0][:3]),
                                        jnp.asarray(t.numpy()))), rtol=1e-6)
    np.testing.assert_allclose(
        losses.miou(x[:3], t).numpy(),
        np.asarray(jax_losses.miou(jnp.asarray(args[0][:3]),
                                   jnp.asarray(t.numpy()))), rtol=1e-6)
    tgt = (rng.uniform(size=(6, 5)) > 0.5).astype(np.float32)
    pr = rng.normal(size=(6, 5)).astype(np.float32)
    assert _rel(float(losses.sigmoid_focal_loss(torch.from_numpy(pr),
                                                torch.from_numpy(tgt))),
                float(jax_losses.sigmoid_focal_loss(jnp.asarray(pr),
                                                    jnp.asarray(tgt)))) \
        <= 1e-6


def test_ten_shot_arrays_match_jax(monkeypatch, tmp_path):
    """The arrays the JAX package's generate_ten_shot hands to PIL (caught
    at Image.fromarray) and its boxes, equal to `ten_shot_arrays`."""
    import json

    from PIL import Image

    from crowdsam_tpu.utils.fixtures import ANNOT_NAME, generate_ten_shot

    seen = []
    real = Image.fromarray

    def catch(a, *args, **kw):
        seen.append(np.array(a))
        return real(a, *args, **kw)

    monkeypatch.setattr(Image, "fromarray", catch)
    generate_ten_shot(str(tmp_path), n_images=3, seed=4)
    monkeypatch.setattr(Image, "fromarray", real)
    imgs, boxes = ten_shot_arrays(4, n_images=3)
    assert len(seen) == len(imgs) == 3
    for a, b in zip(seen, imgs):
        np.testing.assert_array_equal(a, b)
    with open(tmp_path / ANNOT_NAME) as f:
        ann = json.load(f)["annotations"]
    assert [tuple(a["bbox"]) for a in ann] == [tuple(b) for fb in boxes
                                               for b in fb]


def test_generate_ten_shot_writes_the_jax_set(tmp_path):
    """The port's JPEG writer gives the JAX package's json and images."""
    import json

    from PIL import Image

    from crowdsam_tpu.utils.fixtures import generate_ten_shot as jax_gen
    from crowdsam_tpu_torch.utils.fixtures import ANNOT_NAME, \
        generate_ten_shot

    jax_gen(str(tmp_path / "jax"), n_images=2, seed=1)
    generate_ten_shot(str(tmp_path / "port"), n_images=2, seed=1)
    load = [json.load(open(tmp_path / d / ANNOT_NAME)) for d in ("jax",
                                                                 "port")]
    assert load[0] == load[1]
    for img in load[0]["images"]:
        a, b = (np.array(Image.open(tmp_path / d / "Images" /
                                    img["file_name"]))
                for d in ("jax", "port"))
        np.testing.assert_array_equal(a, b)


def test_bench_fixture_matches_jax():
    """Cache keys equal; the scenes' boxes equal and their frames within
    one grey level (PIL's bilinear upsample written out in numpy)."""
    from crowdsam_tpu.utils import bench_fixture as jbf
    from crowdsam_tpu_torch.utils import bench_fixture as bf

    for steps, lr, recipe in ((800, 2e-4, ""), (800, 2e-4, "a=1"),
                              (50, 1e-3, "")):
        assert bf.cache_path_for(steps, lr, recipe) == \
            jbf.cache_path_for(steps, lr, recipe)
        assert bf.committed_path_for(steps, lr, recipe) == \
            jbf.committed_path_for(steps, lr, recipe)
    img, boxes = bf.mid_scene(7)
    jimg, jboxes = jbf.mid_scene(7)
    assert boxes == jboxes
    assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1
    assert np.abs(bf.sparse_scene(7).astype(int)
                  - jbf.sparse_scene(7).astype(int)).max() <= 1


def _tiny_model(tmp_path):
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM

    cfg = modify_config(load_config(None), [
        "model.sam_model", "vit_tiny", "model.dino_model", "dinov2_vits14",
        "model.sam_checkpoint", "", "model.dino_checkpoint", "",
        "model.sam_adapter_checkpoint", "", "tpu.compute_dtype", "float32",
        "train.n_shot", "2", "train.samples_per_batch", "4"])
    return CrowdSAM(cfg, device="cpu")


def test_train_or_load_decoder_trains_saves_and_loads(dataset, tmp_path,
                                                      monkeypatch):
    """A miss trains the full decoder into the model and saves it (read
    by the JAX package's load_pytree); the next call loads the same
    decoder from the cache."""
    from crowdsam_tpu.utils.checkpoint import load_pytree
    from crowdsam_tpu_torch.utils import bench_fixture as bf

    monkeypatch.chdir(tmp_path)
    model = _tiny_model(tmp_path)
    before = {k: v.clone() for k, v in
              model.sam.mask_decoder.state_dict().items()}
    meta = bf.train_or_load_decoder(model, steps=2, lr=1e-3,
                                    dataset=dataset)
    assert meta["trained_cache"] == "miss"
    trained = model.sam.mask_decoder.state_dict()
    assert not torch.equal(trained["output_upscaling.0.weight"],
                           before["output_upscaling.0.weight"])
    path = bf.cache_path_for(2, 1e-3)
    tree = load_pytree(path)["mask_decoder"]
    assert "hyper_mlps_0" in tree and "hyper_mlps_4" not in tree
    other = _tiny_model(tmp_path)
    meta = bf.train_or_load_decoder(other, steps=2, lr=1e-3)
    assert meta["trained_cache"] == "hit"
    for k, v in trained.items():
        assert torch.equal(other.sam.mask_decoder.state_dict()[k], v), k


def test_train_cli_saves_a_jax_decoder(tmp_path, monkeypatch):
    """`python -m crowdsam_tpu_torch.train` on the CPU with a tiny model:
    no dataset file, so the synthetic 10-shot set; the saved decoder loads
    with the JAX package's load_adapter_checkpoint, with the JAX decoder's
    structure."""
    from crowdsam_tpu.models.build import build_sam_vit_tiny
    from crowdsam_tpu.utils.checkpoint import load_adapter_checkpoint
    from crowdsam_tpu_torch.train.__main__ import main

    from crowdsam_tpu_torch.utils.fixtures import DEFAULT_ROOT, \
        generate_ten_shot

    monkeypatch.chdir(tmp_path)
    # The fallback set, written small beforehand (two frames) to keep the
    # test short; the CLI finds it where ensure_ten_shot puts it.
    generate_ten_shot(DEFAULT_ROOT, n_images=2)
    out = tmp_path / "adapter.msgpack"
    assert main(["--config_file", "", "--device", "cpu",
                 "model.sam_model", "vit_tiny",
                 "model.dino_model", "dinov2_vits14",
                 "model.sam_checkpoint", "", "model.dino_checkpoint", "",
                 "tpu.compute_dtype", "float32",
                 "data.train_file", str(tmp_path / "absent.json"),
                 "train.n_shot", "2", "train.steps", "2",
                 "train.samples_per_batch", "4",
                 "train.save_path", str(out)]) == 0
    got = load_adapter_checkpoint(str(out))
    want = build_sam_vit_tiny(dtype=jnp.float32, dino_dim=384).params[
        "mask_decoder"]
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    assert (tmp_path / "data" / "crowdhuman_train").is_dir()
