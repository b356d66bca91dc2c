"""The port's deviation probe (`crowdsam_tpu_torch/utils/deviation_probe.py`)
and its driver (`crowdsam_tpu_torch/tools/probe_deviations.py`) against the
JAX package's on the CPU.

The model is the amplified tiny CrowdSAM of `tests/test_deviation_probe.py`
(vit_tiny + dinov2_vits14 in float32, unfused decode, the prompt
encoder's Fourier matrix and point embeddings x8, the hypernetwork MLPs x6,
the last upscaling conv x8, mask threshold 28), the same weights on both
sides through the weight bridge, and JAX's `jax.random.uniform(sub, (N,))`
as the port's noise.  The bound recipe of that file (filters off, mask
threshold 20) runs the variants whose image-resolution stability leaves no
detection at the strict filters (`upfilter`, `padcrop`, `exact_all`).

Tolerances: `num_consumed`, `n_prenms`, `n_changed`, `n_dropped_renms`,
detection counts and categories equal; scores and stability within 1e-4;
boxes within 0.5 px, 1.0 px in modes with `upfilter` or `cleanup` (as the
JAX probe's own test allows there).  Every image must give a detection, so
that no case holds vacuously."""

import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import crowdsam_tpu.pipeline.crowdsam as jax_crowdsam
import crowdsam_tpu.utils.bench_fixture as jax_fixture
import crowdsam_tpu.utils.deviation_probe as jax_probe
from crowdsam_tpu.pipeline.engine import (
    ENGINE_BLOB_KEYS,
    fetch_host_blob,
    make_eps_engine,
)
from crowdsam_tpu.utils.checkpoint import jax_tree_to_numpy

from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
from crowdsam_tpu_torch.tools import probe_deviations
from crowdsam_tpu_torch.tools.probe_deviations import VARIANTS, run_probe
from crowdsam_tpu_torch.utils.bench_fixture import train_or_load_decoder
from crowdsam_tpu_torch.utils.deviation_probe import DeviationProbe
from crowdsam_tpu_torch.utils.weights import (
    dino_state_dict_from_jax,
    sam_state_dict_from_jax,
)

from test_deviation_probe import _amp
from test_e2e_oracle import _structured_image, oracle_config

ROOT = Path(__file__).resolve().parent.parent
# Variants run on the bound recipe: at the strict filters their
# image-resolution stability leaves no detection on the random masks.
ON_BOUND = ("exact_upfilter", "exact_padcrop", "exact_all")
SLAB = 32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """Both packages' models with the same amplified weights, the
    images, the JAX key and the noise JAX draws from it."""
    jm = jax_crowdsam.CrowdSAM(oracle_config())
    jm.sam.params["prompt_encoder"] = _amp(
        jm.sam.params["prompt_encoder"],
        [("pe_gaussian", 8.0), ("point_embeddings", 8.0)])
    jm.sam.params["mask_decoder"] = _amp(
        jm.sam.params["mask_decoder"],
        [("hyper_mlps", 6.0), ("upscale_3", 8.0)])
    jm.engine_cfg = dataclasses.replace(jm.engine_cfg, mask_threshold=28.0)
    jm.engine = make_eps_engine(
        jm.sam.prompt_encoder, jm.sam.mask_decoder, jm.engine_cfg,
        spec_with_masks=jm.output_rles)
    jm._build_survivor_programs()
    # Two images of one shape, so that JAX compiles each program once.
    rng = np.random.default_rng(0)
    images = [_structured_image(rng, 176, 256) for _ in range(2)]

    pm = CrowdSAM(copy.deepcopy(oracle_config()), device="cpu")
    missing, unexpected = pm.sam.load_state_dict(
        sam_state_dict_from_jax(jax_tree_to_numpy(jm.sam.params)),
        strict=False)
    assert not unexpected and {k.split(".layers.")[0] for k in missing} == {
        "mask_decoder.output_hypernetworks_mlps.4"}
    pm.dino.load_state_dict(dino_state_dict_from_jax(
        jax_tree_to_numpy(jm.predictor.dino_params)), strict=True)
    pm.engine_cfg = dataclasses.replace(pm.engine_cfg, mask_threshold=28.0)
    key0 = jm._key
    sub = jax.random.split(key0)[1]
    n = jm.engine_cfg.grid_size ** 2
    return SimpleNamespace(
        jm=jm, pm=pm, key0=key0, sub=sub,
        noise=np.asarray(jax.random.uniform(sub, (n,))),
        images=images)


def _regime(models, **changes):
    """The models under the engine settings `changes` (none: the strict
    filters of the amplified model), with a probe of each package kept
    for the whole file (SLAB 32), so that JAX compiles each program
    once."""
    side = SimpleNamespace(**vars(models))
    side.cfg_j = dataclasses.replace(models.jm.engine_cfg, **changes)
    side.cfg_p = dataclasses.replace(models.pm.engine_cfg, **changes)
    side.jp = jax_probe.DeviationProbe(models.jm)
    side.pp = DeviationProbe(models.pm)
    side.jp.SLAB = side.pp.SLAB = SLAB
    return side


@pytest.fixture(scope="module")
def strict(models):
    return _regime(models)


@pytest.fixture(scope="module")
def bound(models):
    """The bound recipe of `tests/test_deviation_probe.py`: the predicted
    IoU and stability filters off, mask threshold 20."""
    return _regime(models, pred_iou_thresh=0.0, stability_score_thresh=0.0,
                   mask_threshold=20.0)


@contextlib.contextmanager
def _installed(side, **changes):
    """The regime's engine settings (and `changes`) on both models, the
    models' own restored on exit."""
    saved = side.jm.engine_cfg, side.pm.engine_cfg
    side.jm.engine_cfg = dataclasses.replace(side.cfg_j, **changes)
    side.pm.engine_cfg = dataclasses.replace(side.cfg_p, **changes)
    try:
        yield
    finally:
        side.jm.engine_cfg, side.pm.engine_cfg = saved


def _beside(jax_fn, port_fn):
    """(jax_fn(), port_fn()), the JAX half in a thread of its own while the
    port's runs here: each package's time hides the other's."""
    with ThreadPoolExecutor(1) as ex:
        want = ex.submit(jax_fn)
        got = port_fn()
        return want.result(), got


def _order(scores):
    return np.argsort(-np.asarray(scores), kind="stable")


def _assert_matches(got, want, tag, box_atol):
    for k in ("num_consumed", "n_prenms", "n_changed", "n_dropped_renms"):
        assert got[k] == want[k], f"{tag}: {k} {got[k]}, JAX {want[k]}"
    n = len(got["boxes"])
    assert n == len(want["boxes"]), \
        f"{tag}: {n} detections, JAX {len(want['boxes'])}"
    gi, wi = _order(got["scores"]), _order(want["scores"])
    np.testing.assert_allclose(
        np.asarray(got["scores"])[gi], np.asarray(want["scores"])[wi],
        atol=1e-4, rtol=0, err_msg=f"{tag}: scores")
    np.testing.assert_array_equal(
        np.asarray(got["categories"])[gi],
        np.asarray(want["categories"])[wi], err_msg=f"{tag}: categories")
    np.testing.assert_allclose(
        np.asarray(got["stability"])[gi], np.asarray(want["stability"])[wi],
        atol=1e-4, rtol=0, err_msg=f"{tag}: stability")
    np.testing.assert_allclose(
        np.asarray(got["boxes"])[gi], np.asarray(want["boxes"])[wi],
        atol=box_atol, rtol=0, err_msg=f"{tag}: boxes")
    return n


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_jax(variant, request):
    """Each of the driver's nine variants, on two images, against the JAX
    probe.  `cand_cleanup512` cleans at 512^2, which needs an engine frame
    above 512 (at the tiny model's 256 the JAX probe fails on it and the
    port refuses it): there both probes are told the frame is 1024, so the
    decoder's 64^2 logits are upsampled 16-fold and the 512^2 cleanup runs
    as at full width."""
    side = request.getfixturevalue(
        "bound" if variant in ON_BOUND else "strict")
    parts = VARIANTS[variant]
    atol = 1.0 if parts & {"upfilter", "cleanup"} else 0.5
    frame = {"img_size": 1024} if variant == "cand_cleanup512" else {}
    with _installed(side, **frame):
        for t, image in enumerate(side.images):
            want, got = _beside(
                lambda: side.jp.generate(image, side.sub, parts=parts),
                lambda: side.pp.generate(image, side.noise, parts=parts))
            n = _assert_matches(got, want, f"{variant} image {t}", atol)
            assert n > 0, f"{variant} image {t}: no detection, vacuous"


def _pair_gaps(engine, probe):
    """How far the engine's detections are from the probe's parity mode:
    (same count, largest box gap in px, largest score gap), sorted by
    score."""
    if len(engine["boxes"]) != len(probe["boxes"]):
        return False, None, None
    ei, pi = _order(engine["scores"]), _order(probe["scores"])
    box = np.abs(np.asarray(engine["boxes"])[ei]
                 - np.asarray(probe["boxes"])[pi])
    score = np.abs(np.asarray(engine["scores"])[ei]
                   - np.asarray(probe["scores"])[pi])
    return True, float(box.max(initial=0.0)), float(score.max(initial=0.0))


def test_parity_against_unfused_engine(strict, monkeypatch):
    """Parity mode against the port's unfused `generate` on the same noise.
    In the probe's own re-NMS order (the JAX probe's: detection order),
    held to the agreement of the same pair in JAX (the JAX probe against
    the JAX unfused engine): the same count where JAX has it, boxes and
    scores no further apart than there (plus 0.5 px and 1e-4), the same
    consumed count wherever JAX's agree.  In the engine's order
    (`renms_order="score"`), equal to the engine: count, consumed, boxes
    within 0.5 px, scores within 1e-4.  (The tiny model drops no mask in
    the re-NMS, so both orders agree here; at full width on the card they
    do not, and `chip_smoke.py` holds the engine's order.)"""
    consumed = []
    real = strict.jm._finalize_crop

    def spy(res, meta):
        consumed.append(int(fetch_host_blob(res, ENGINE_BLOB_KEYS)[
            "summary"][0, 5]))
        return real(res, meta)

    monkeypatch.setattr(strict.jm, "_finalize_crop", spy)
    assert not strict.pm.engine_cfg.fused_decode
    for t, image in enumerate(strict.images):
        def jax_pair():
            strict.jm._key = strict.key0
            return (strict.jm.generate(image),
                    strict.jp.generate(image, strict.sub, parts=()))

        def port_pair():
            engine = strict.pm.generate(image, noise=[strict.noise])
            return (engine, strict.pm.last_engine["num_consumed"],
                    strict.pp.generate(image, strict.noise, parts=()),
                    strict.pp.generate(image, strict.noise, parts=(),
                                       renms_order="score"))

        with _installed(strict):
            (jax_engine, jax_parity), (engine, port_consumed, parity,
                                       by_score) = _beside(jax_pair,
                                                           port_pair)
        j_same, j_box, j_score = _pair_gaps(jax_engine, jax_parity)
        p_same, p_box, p_score = _pair_gaps(engine, parity)
        tag = f"image {t}"
        if j_same:
            assert p_same, f"{tag}: {len(engine['boxes'])} engine " \
                           f"detections, parity {len(parity['boxes'])}"
            assert p_box <= j_box + 0.5, f"{tag}: boxes {p_box}, JAX {j_box}"
            assert p_score <= j_score + 1e-4, \
                f"{tag}: scores {p_score}, JAX {j_score}"
        if consumed[-1] == jax_parity["num_consumed"]:
            assert port_consumed == parity["num_consumed"], tag
        same, box, score = _pair_gaps(engine, by_score)
        assert same and box <= 0.5 and score <= 1e-4, (tag, box, score)
        assert port_consumed == by_score["num_consumed"], tag
        assert len(parity["boxes"]) > 0, f"{tag}: no detection, vacuous"


def test_refusals(strict):
    """What the JAX probe asserts, the port refuses with a ValueError,
    under the same conditions: the HQ decoder, crop layers, fuse_simmap,
    an unknown part, two cleanup modes, more NMS survivors than SLAB (never
    truncated); also a noise vector of the wrong length and cleanup512
    below a 1024 frame (where the JAX probe fails on a shape)."""
    pm, jm, image = strict.pm, strict.jm, strict.images[0]
    hq = SimpleNamespace(predictor=SimpleNamespace(is_hq=True))
    with pytest.raises(ValueError, match="HQ"):
        DeviationProbe(hq)
    with pytest.raises(AssertionError):
        jax_probe.DeviationProbe(hq)

    def both_refuse(port_model, jax_model, parts=(), match=None):
        with pytest.raises(ValueError, match=match):
            DeviationProbe(port_model).generate(image, strict.noise, parts)
        with pytest.raises(AssertionError):
            jax_probe.DeviationProbe(jax_model).generate(image, strict.sub,
                                                         parts)

    for attr, value in (("crop_n_layers", 1), ("engine_cfg", None)):
        p2, j2 = copy.copy(pm), copy.copy(jm)
        if value is None:        # fuse_simmap
            p2.engine_cfg = dataclasses.replace(pm.engine_cfg,
                                                fuse_simmap=True)
            j2.engine_cfg = dataclasses.replace(jm.engine_cfg,
                                                fuse_simmap=True)
        else:
            setattr(p2, attr, value)
            setattr(j2, attr, value)
        both_refuse(p2, j2, match="single-crop")
    both_refuse(pm, jm, {"exact"}, match="unknown")
    both_refuse(pm, jm, {"cleanup", "cleanup512"}, match="exclusive")
    both_refuse(pm, jm, {"cleanup_fullarea", "cleanup512"}, match="exclusive")
    with pytest.raises(ValueError, match="noise"):
        DeviationProbe(pm).generate(image, strict.noise[:-1])
    with pytest.raises(ValueError, match="renms_order"):
        DeviationProbe(pm).generate(image, strict.noise, (), "random")
    # The driver refuses to train a decoder it cannot load.
    with pytest.raises(RuntimeError, match="training is refused"):
        train_or_load_decoder(pm, recipe="train.no_such=1", train=False)
    with pytest.raises(ValueError, match="cleanup512"):
        DeviationProbe(pm).generate(image, strict.noise, {"cleanup512"})

    # The first image has survivors at parity (the variant test holds it):
    # a slab of none must raise.
    for probe, arg in ((strict.pp, strict.noise), (strict.jp, strict.sub)):
        probe.SLAB = 0
        try:
            with _installed(strict), pytest.raises(
                    ValueError, match="exceed probe slab 0"):
                probe.generate(image, arg, ())
        finally:
            probe.SLAB = SLAB


def test_driver_report_matches_jax(bound, monkeypatch, capsys, tmp_path):
    """`run_probe` on the tiny model (bound recipe, one image, every
    variant but cand_cleanup512, which needs a frame above 512) against the JAX
    driver's `main` replaying the same detections: equal reports, keys,
    counts, diagnostics, cross-AP (the JAX driver's `_cross_ap` on the same
    records) and records; then `tools/analyze_probe_pairs.py` reads it."""
    variants = {k: v for k, v in VARIANTS.items() if k != "cand_cleanup512"}
    image, noise, pm = bound.images[0], bound.noise, bound.pm
    meta = {"trained_cache": "committed", "trained_steps": 800}
    engine_out, probe_out = [], {}
    real_generate = DeviationProbe.generate

    def recorded(self, img, nz, parts=frozenset()):
        out = real_generate(self, img, nz, parts)
        probe_out[frozenset(parts)] = out
        return out

    monkeypatch.setattr(probe_deviations.DeviationProbe, "generate",
                        recorded)
    real_engine = pm.generate

    def engine(img, noise=None):
        out = real_engine(img, noise=noise)
        engine_out.append(out)
        return out

    monkeypatch.setattr(pm, "generate", engine)
    seconds = {}
    with _installed(bound):
        report = run_probe(pm, [image], [noise], variants=variants,
                           fixture=meta, seconds=seconds)
    assert set(seconds) == set(variants) | {"engine"}

    # The JAX driver's main on the same detections.
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import probe_deviations_trained as jax_driver
    finally:
        sys.path.remove(str(ROOT / "tools"))

    class Model:
        def __init__(self, cfg):
            self._key = jax.random.PRNGKey(0)

        def generate(self, img):
            return engine_out[0]

    class Probe:
        def __init__(self, model):
            pass

        def generate(self, img, sub, parts):
            return probe_out[frozenset(parts)]

    monkeypatch.setattr(jax_driver, "VARIANTS", dict(variants))
    monkeypatch.setattr(jax_crowdsam, "CrowdSAM", Model)
    monkeypatch.setattr(jax_fixture, "crowd_scene", lambda t: (image, []))
    monkeypatch.setattr(jax_fixture, "train_or_load_decoder",
                        lambda *a, **k: dict(meta))
    monkeypatch.setattr(jax_probe, "DeviationProbe", Probe)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["probe_deviations_trained.py", "1"])
    monkeypatch.chdir(ROOT)
    capsys.readouterr()
    jax_driver.main()
    want = json.loads(capsys.readouterr().out)
    report = json.loads(json.dumps(report))
    assert list(report) == list(want)
    for key in want:
        assert report[key] == want[key], key
    assert report["detections"]["exact_all"][0] > 0

    path = tmp_path / "probe.json"
    path.write_text(json.dumps(report))
    done = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "analyze_probe_pairs.py"),
         str(path)], capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    pairs = json.loads(done.stdout)["pairs"]
    assert "parity_vs_exact_all" in pairs
