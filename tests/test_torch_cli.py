"""The port's command-line tools against the JAX package's, in-process
(`main(argv)`; the JAX tools read `sys.argv`), on a tiny synthetic
CrowdHuman-style dataset (PNG frames, COCO json, odgt) with the tiny
CrowdSAM config (vit_tiny + dinov2_vits14, float32, `test.output_rles`
true) on the CPU.  Both packages draw the same weights from the config;
the port's engine noise replays the JAX engine's draws (the key of
`environ.seed`, split once a crop, as `CrowdSAM._dispatch_crop` splits it).

`tools.test`'s result.json matches the JAX one's: the same images, num_gt,
detection counts and categories, boxes within 0.5 px, scores within 1e-4,
RLE strings equal.  `tools.crowdhuman_eval` and `tools.batch_eval --inline`
print the JAX CLIs' metric lines (the evaluator is the same numpy code);
the JAX batch_eval's shard is the JAX test CLI's own result, copied, not
recomputed.  `tools.batch_eval`'s one-process-a-card path runs here with
`torch.cuda.device_count` patched to 2 and each shard's device given as
`--device cpu`: its merged result equals `--inline`'s."""

import contextlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
from crowdsam_tpu_torch.tools import batch_eval, crowdhuman2coco, \
    crowdhuman_eval, demo
from crowdsam_tpu_torch.tools import test as test_cli

ROOT = Path(__file__).resolve().parent.parent
CONFIG = str(ROOT / "configs" / "crowdhuman.yaml")
TINY = [
    "model.sam_model", "vit_tiny", "model.dino_model", "dinov2_vits14",
    "model.sam_checkpoint", "", "model.dino_checkpoint", "",
    "model.sam_adapter_checkpoint", "",
    "test.max_size", "256", "test.grid_size", "48", "test.max_prompts", "64",
    "test.points_per_batch", "8", "test.pred_iou_thresh", "0.0",
    "test.stability_score_thresh", "0.0", "test.pos_sim_thresh", "0.3",
    "tpu.compute_dtype", "float32",
]
SIZES = [(192, 256), (256, 200), (150, 256)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: the test runner's workers share the
    machine's cores, and the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Images/*.png, val.json (COCO) and val.odgt (fbox = vbox) of three
    seeded frames; returns (root, dotted overrides of the data paths)."""
    root = tmp_path_factory.mktemp("crowd")
    (root / "Images").mkdir()
    rng = np.random.default_rng(3)
    images, annots, odgt = [], [], []
    for i, (h, w) in enumerate(SIZES):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "Images" / f"f{i}.png"), img[..., ::-1])
        images.append({"file_name": f"f{i}.png", "id": i, "height": h,
                       "width": w})
        boxes = [[10, 20, 40, 80], [100, 30, 50, 100], [60, 60, 30, 50]]
        for b in boxes[: 2 + i % 2]:
            annots.append({"image_id": i, "bbox": b, "id": len(annots),
                           "category_id": 1, "ignore": 0, "iscrowd": False,
                           "area": b[2] * b[3]})
        odgt.append({"ID": f"f{i}", "width": w, "height": h, "gtboxes": [
            {"tag": "person", "fbox": b, "vbox": b, "extra": {}}
            for b in boxes[: 2 + i % 2]]})
    (root / "val.json").write_text(json.dumps({
        "images": images, "annotations": annots,
        "categories": [{"id": 1, "name": "person",
                        "supercategory": "person"}]}))
    (root / "val.odgt").write_text("\n".join(json.dumps(r) for r in odgt))
    data = ["data.dataset_root", str(root),
            "data.json_file", str(root / "val.json"),
            "data.odgt_file", str(root / "val.odgt"),
            "environ.output_dir", str(root / "out")]
    return root, data


@pytest.fixture()
def jax_noise(monkeypatch):
    """The port's engine noise: the JAX engine's draws from the key of
    `environ.seed` (42), one split a crop, restarted for each test."""
    state = {"key": jax.random.PRNGKey(42)}

    def draw_noise(self):
        state["key"], sub = jax.random.split(state["key"])
        n = self.engine_cfg.grid_size ** 2
        return torch.tensor(np.asarray(jax.random.uniform(sub, (n,))))

    monkeypatch.setattr(CrowdSAM, "draw_noise", draw_noise)


@pytest.fixture(scope="module")
def jax_result(dataset):
    """The JAX `tools/test.py` on the dataset: its result.json path."""
    root, data = dataset
    out = str(root / "jax_result.json")
    argv = ["test.py", "-c", CONFIG, "-s", out] + TINY + data
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", argv)
        _jax_tool("test").main()
    return out


def _same_results(got, want):
    assert len(got) == len(want) == len(SIZES)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["image_id"], g["num_gt"]) == (w["image_id"], w["num_gt"])
        assert len(g["boxes"]) == len(w["boxes"])
        assert g["categories"] == w["categories"]
        if w["boxes"]:
            np.testing.assert_allclose(g["boxes"], w["boxes"], atol=0.5)
            np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)
        assert g["rles"] == w["rles"]
    assert sum(len(w["boxes"]) for w in want) > 0


def test_test_cli_matches_jax(dataset, jax_result, jax_noise):
    root, data = dataset
    out = str(root / "port_result.json")
    assert test_cli.main(["-c", CONFIG, "-s", out, "--device", "cpu"]
                         + TINY + data) == 0
    with open(out) as f, open(jax_result) as g:
        _same_results(json.load(f), json.load(g))


def _printed(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return buf.getvalue()


def _metric_lines(text):
    return [line for line in text.splitlines()
            if line.split(":")[0] in ("AP", "MR", "Recall", "tp", "fp")]


def test_crowdhuman_eval_cli_matches_jax(dataset, jax_result, tmp_path,
                                         monkeypatch):
    from crowdsam_tpu.evallib.coco_convert import convert_to_coco

    root, _ = dataset
    with open(jax_result) as f, open(root / "val.json") as g:
        coco = convert_to_coco(json.load(f), json.load(g))
    det = tmp_path / "det.json"
    det.write_text(json.dumps(coco))
    args = ["-d", str(det), "-g", str(root / "val.odgt"), "-f", "-v"]
    got = _printed(crowdhuman_eval.main,
                   args + ["-o", str(tmp_path / "port.txt")])
    monkeypatch.setattr(sys, "argv", ["crowdhuman_eval.py"] + args + [
        "-o", str(tmp_path / "jax.txt")])
    want = _printed(_jax_tool("crowdhuman_eval").main)
    assert len(_metric_lines(got)) == 5
    assert got == want
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()


def test_batch_eval_inline_matches_jax(dataset, jax_result, jax_noise,
                                       tmp_path, monkeypatch):
    root, data = dataset
    monkeypatch.chdir(tmp_path)
    got = _printed(batch_eval.main, ["-c", CONFIG, "--inline", "--device",
                                     "cpu"] + TINY + data)
    assert not list(tmp_path.iterdir())      # temp files removed
    jax_batch = _jax_tool("batch_eval")

    def run_script(start_idx, end_idx, rank, exec_file, config_file,
                   options):
        assert (start_idx, end_idx, rank) == (0, len(SIZES), 0)
        shutil.copy(jax_result, f"temp_result_{rank}.json")

    monkeypatch.setattr(jax_batch, "run_script", run_script)
    monkeypatch.setattr(sys, "argv", ["batch_eval.py", "-c", CONFIG,
                                      "--inline"] + TINY + data)
    want = _printed(jax_batch.main)
    assert len(_metric_lines(got)) == 5
    assert _metric_lines(got) == _metric_lines(want)
    assert got.rstrip().endswith("All processes done")


def _multi_process(monkeypatch, extra=()):
    """`batch_eval`'s one-process-a-card path reached on the CPU: two
    "cards", each shard's `tools.test` given `--device cpu` (and `extra`),
    one torch thread a shard; returns the list of merged results."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    real_argv, real_merge = batch_eval.test_argv, batch_eval.merge_json
    merged = []

    def test_argv(*a, **kw):
        assert kw.get("device") is None
        return list(extra) + real_argv(*a, device="cpu")

    def merge_json(files):
        merged.append(real_merge(files))
        return merged[-1]

    monkeypatch.setattr(batch_eval, "test_argv", test_argv)
    monkeypatch.setattr(batch_eval, "merge_json", merge_json)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return merged


def test_batch_eval_multi_process_matches_inline(dataset, tmp_path,
                                                 monkeypatch):
    """Two `tools.test` processes (images [0, 1) and [1, 3), each with
    `--local_rank`), then the merge: the same merged result.json, bit for
    bit, and the same metric lines as `--inline` (the shard from image 1
    draws past image 0's noise, as the inline run has)."""
    root, data = dataset
    monkeypatch.chdir(tmp_path)
    inline_merged = []
    real_merge = batch_eval.merge_json
    monkeypatch.setattr(batch_eval, "merge_json", lambda files: (
        inline_merged.append(real_merge(files)) or inline_merged[-1]))
    want = _printed(batch_eval.main, ["-c", CONFIG, "--inline", "--device",
                                      "cpu"] + TINY + data)
    merged = _multi_process(monkeypatch)
    got = _printed(batch_eval.main, ["-c", CONFIG] + TINY + data)
    assert "--local_rank 1" in got and "--start_idx 1" in got
    assert not list(tmp_path.iterdir())      # temp files removed
    assert merged[0] == inline_merged[0]
    assert [r["image_id"] for r in merged[0]] == list(range(len(SIZES)))
    assert sum(len(r["boxes"]) for r in merged[0]) > 0
    assert len(_metric_lines(got)) == 5
    assert _metric_lines(got) == _metric_lines(want)


def test_batch_eval_fails_when_a_shard_fails(dataset, tmp_path,
                                             monkeypatch):
    """A shard that exits non-zero fails the run (the JAX tool would merge
    what it finds)."""
    root, data = dataset
    monkeypatch.chdir(tmp_path)
    _multi_process(monkeypatch, extra=["--mode", "not-a-mode"])
    with pytest.raises(subprocess.CalledProcessError):
        _printed(batch_eval.main, ["-c", CONFIG] + TINY + data)


def test_crowdhuman2coco_cli_writes_the_converted_json(dataset, tmp_path):
    from crowdsam_tpu.evallib.coco_convert import crowdhuman2coco as jax_fn

    root, _ = dataset
    (tmp_path / "Images").mkdir()
    for i in range(len(SIZES)):
        img = cv2.imread(str(root / "Images" / f"f{i}.png"))
        cv2.imwrite(str(tmp_path / "Images" / f"f{i}.jpg"), img)
    shutil.copy(root / "val.odgt", tmp_path / "ann.odgt")
    assert crowdhuman2coco.main(["-d", str(tmp_path), "-o", "ann.odgt",
                                 "-s", "val.json", "-v"]) == 0
    want = jax_fn(str(tmp_path / "ann.odgt"), "", str(tmp_path / "Images"),
                  visible=True, full=True)
    assert json.loads((tmp_path / "val.json").read_text()) == want
    assert [im["height"] for im in want["images"]] == [h for h, _ in SIZES]


def test_demo_cli_writes_results_and_images(dataset, tmp_path):
    root, _ = dataset
    out = tmp_path / "demo"
    assert demo.main(["-i", str(root / "Images"), "-o", str(out),
                      "--device", "cpu"] + TINY) == 0
    results = json.loads((out / "result.json").read_text())
    assert [os.path.basename(r["image_file"]) for r in results] == [
        f"f{i}.png" for i in range(len(SIZES))]
    for r in results:
        assert set(r) == {"image_file", "boxes", "scores", "categories",
                          "rles"}
        assert len(r["rles"]) == len(r["boxes"])
    for i in range(len(SIZES)):
        assert cv2.imread(str(out / f"f{i}.jpg")) is not None

    empty = tmp_path / "none"
    assert demo.main(["-i", str(tmp_path / "nothing_*.png"), "-o",
                      str(empty), "--device", "cpu"] + TINY) == 0
    assert json.loads((empty / "result.json").read_text()) == []
    logs = "".join(p.read_text() for p in (empty / "log").iterdir())
    assert "matched no files" in logs


@pytest.mark.parametrize("main", [test_cli.main, demo.main, batch_eval.main],
                         ids=["test", "demo", "batch_eval"])
def test_clis_need_cuda_unless_given_a_device(main, dataset, tmp_path,
                                              monkeypatch):
    root, data = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    argv = ["-c", CONFIG] + TINY + data
    if main is demo.main:
        argv = ["-i", str(root / "Images"), "-o", str(tmp_path)] + argv
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
