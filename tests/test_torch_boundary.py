"""Import boundary of the PyTorch port: `crowdsam_tpu_torch`,
`chip_smoke.py`, `chip_ab_relpos.py`, `chip_ab_layernorm.py`,
`chip_ab_attention_f32.py` and `chip_ab_decode_f32.py` import neither JAX, flax, msgpack nor the JAX
package (flax msgpack checkpoints go through the port's own reader), and
the entry points refuse to fall back to the CPU silently."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "crowdsam_tpu")


def _port_files():
    return sorted((ROOT / "crowdsam_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "chip_ab_relpos.py",
        ROOT / "chip_ab_layernorm.py", ROOT / "chip_ab_attention_f32.py",
        ROOT / "chip_ab_decode_f32.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.name} imports {bad}"


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, crowdsam_tpu_torch, crowdsam_tpu_torch.pipeline.crowdsam,"
        " crowdsam_tpu_torch.utils.weights, crowdsam_tpu_torch.ops.packed,"
        " crowdsam_tpu_torch.models.fused_decode,"
        " crowdsam_tpu_torch.models.decode_tail_kernel,"
        " crowdsam_tpu_torch.models.mask_head_kernel,"
        " crowdsam_tpu_torch.ops.rle, crowdsam_tpu_torch.ops.survivor_kernel,"
        " crowdsam_tpu_torch.utils.msgpack_io, crowdsam_tpu_torch.utils.export"
        "\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_port_files_include_the_fused_decode_slice():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"crowdsam_tpu_torch/ops/packed.py",
            "crowdsam_tpu_torch/models/fused_decode.py",
            "crowdsam_tpu_torch/models/decode_tail_kernel.py",
            "crowdsam_tpu_torch/models/mask_head_kernel.py",
            "chip_smoke.py"} <= names


def test_port_files_include_the_batched_pipeline():
    """The batched pipeline (`parallel/`) is the port's own package
    (covered by `test_no_jax_imports`), imports nothing of JAX, and K5's
    source offsets each prompt's image-side rows by its image."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"crowdsam_tpu_torch/parallel/__init__.py",
            "crowdsam_tpu_torch/parallel/eval_shard.py"} <= names
    code = ("import sys, crowdsam_tpu_torch.parallel.eval_shard\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    text = (ROOT / "crowdsam_tpu_torch" / "csrc" /
            "decode_tail.cu").read_text()
    assert "image_row(a, q)" in text and "image_row(a, p)" in text


def test_port_files_include_the_multi_device_slice():
    """The mesh, the collectives, the prompt-sharded engine and the rank
    launcher are the port's own (covered by `test_no_jax_imports`); with
    the tests' rank functions (`tests/torch_ranks.py`, which spawned ranks
    import) they leave JAX out of `sys.modules`, and the collectives use
    `all_reduce` alone."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    parallel = ("mesh", "collectives", "prompt_shard", "launch")
    assert {f"crowdsam_tpu_torch/parallel/{n}.py" for n in parallel} <= names
    ranks = ROOT / "tests" / "torch_ranks.py"
    assert not {m for m in _imported_roots(ranks) if m in FORBIDDEN}
    code = ("import sys; sys.path.insert(0, 'tests')\n"
            "import torch_ranks, crowdsam_tpu_torch.parallel.launch\n"
            + "".join(f"import crowdsam_tpu_torch.parallel.{n}\n"
                      for n in parallel) +
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    text = (ROOT / "crowdsam_tpu_torch" / "parallel" /
            "collectives.py").read_text()
    calls = set(re.findall(r"dist\.(\w+)\(", text))
    assert calls == {"all_reduce"}, calls


def test_port_files_include_the_serving_export():
    """The serving export is the port's own module (covered by
    `test_no_jax_imports`); importing it alone leaves JAX out of
    `sys.modules` and registers K1's op, so a fresh process can load an
    exported program without building a model."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert "crowdsam_tpu_torch/utils/export.py" in names
    code = ("import sys, torch, crowdsam_tpu_torch.utils.export\n"
            "torch.ops.crowdsam_tpu_torch.layer_norm.default\n"
            "torch.ops.crowdsam_tpu_torch.layer_norm_stats.default\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_port_files_include_the_msgpack_reader():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert "crowdsam_tpu_torch/utils/msgpack_io.py" in names


def test_port_files_include_the_other_archs():
    """TinyViT and the HQ decoder are the port's own modules (covered by
    `test_no_jax_imports`); the rel-pos kernels carry their head-dim-80
    slab in the shared header, and K4's source keeps head dim 64."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"crowdsam_tpu_torch/models/tiny_vit.py",
            "crowdsam_tpu_torch/models/mask_decoder_hq.py"} <= names
    csrc = ROOT / "crowdsam_tpu_torch" / "csrc"
    header = (csrc / "sm90.cuh").read_text()
    assert "CU_TENSOR_MAP_SWIZZLE_32B" in header and "m64n16k16" in header
    assert "D_WIDE" in (csrc / "attention.cu").read_text()
    assert "D_WIDE" not in (csrc / "flash_sm90.cu").read_text()


def test_port_files_include_the_survivor_rle_slice():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"crowdsam_tpu_torch/ops/rle.py",
            "crowdsam_tpu_torch/ops/survivor_kernel.py"} <= names
    csrc = ROOT / "crowdsam_tpu_torch" / "csrc"
    assert (csrc / "survivor.cu").is_file()
    assert (csrc / "rle_codec.cpp").is_file()


@pytest.mark.parametrize("name", ["decode_tail.cu", "mask_head.cu"])
def test_decode_kernels_are_cuda_sources_without_library_calls(name):
    """K5 and K6 are CUDA C++ built by `kernels/_build.py`: their sources
    hold the products themselves (wgmma in both, K6's hypernetwork
    contraction on mma.sync) and call no library."""
    text = (ROOT / "crowdsam_tpu_torch" / "csrc" / name).read_text()
    assert "__global__" in text
    assert "mma.sync" in text or "wgmma.mma_async" in text
    for lib in ("cublas", "cutlass", "cudnn", "torch/"):
        assert lib not in text.lower()


def test_twoway_tail_is_a_wgmma_cluster_kernel_without_libcuda():
    """K5 is CUDA C++ for sm_90a: its products are wgmma (operands in
    swizzled shared memory or registers), the row phases' weight chunks come
    by TMA behind mbarriers, the token stages run as clusters that exchange
    rows through distributed shared memory, and the kernels follow each
    other as programmatic dependent launches; no mma.sync, no library, the
    tensor maps encoded through the runtime's driver entry point."""
    text = (ROOT / "crowdsam_tpu_torch" / "csrc" / "decode_tail.cu"
            ).read_text()
    for needle in ("cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity",
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16",
                   "__cluster_dims__", "st.shared::cluster",
                   "ld.shared::cluster", "barrier.cluster.arrive",
                   "griddepcontrol.wait", "cudaGetDriverEntryPoint"):
        assert needle in text, needle
    assert "mma.sync.aligned.m16n8k16" not in text and "ldmatrix" not in text
    # No atomics: the split softmaxes and the MLP's K-split sum in a fixed
    # order, so that two runs agree bit for bit.
    assert not re.search(r"\batomic[A-Z]|\batom\.(global|shared)", text)
    for lib in ("cublas", "cutlass", "cute/", "cudnn", "torch/"):
        assert lib not in text.lower()


def test_survivor_kernel_is_a_cuda_source_without_library_calls():
    """K7 is CUDA C++ built for sm_90a: its own scan, warp bit transposes
    (shuffles) and reductions, no library; the host codec is plain C++ (no
    CUDA)."""
    csrc = ROOT / "crowdsam_tpu_torch" / "csrc"
    text = (csrc / "survivor.cu").read_text()
    assert "__global__" in text and "__shfl_xor_sync" in text
    # The bands merge in band order in shared memory: no atomics, so that
    # two runs agree bit for bit.
    assert not re.search(r"\batomic[A-Z]|\batom\.(global|shared)", text)
    includes = [ln for ln in text.splitlines() if ln.startswith("#include")]
    assert includes == ["#include <cuda_bf16.h>", "#include <cuda_runtime.h>",
                        "#include <stdint.h>"]
    codec = (csrc / "rle_codec.cpp").read_text()
    assert "__global__" not in codec and "cuda_" not in codec


def _with_headers(name):
    """A CUDA source's text with the shared headers it includes."""
    csrc = ROOT / "crowdsam_tpu_torch" / "csrc"
    text = (csrc / name).read_text()
    for inc in re.findall(r'#include "([^"]+)"', text):
        text += (csrc / inc).read_text()
    return text


def test_flash_sm90_is_a_tma_wgmma_kernel_without_libcuda():
    """K4 is CUDA C++ for sm_90a: TMA tensor loads behind mbarriers and
    wgmma for both products, no mma.sync and no library; the tensor maps
    are encoded through the runtime's driver entry point, so no source is
    linked against libcuda; `attention.cu` keeps only the rel-pos kernel."""
    from crowdsam_tpu_torch.kernels import _build

    csrc = ROOT / "crowdsam_tpu_torch" / "csrc"
    text = _with_headers("flash_sm90.cu")
    for needle in ("cp.async.bulk.tensor.4d", "mbarrier.try_wait.parity",
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                   "setmaxnreg", "cudaGetDriverEntryPoint"):
        assert needle in text, needle
    assert "mma.sync" not in text and "ldmatrix" not in text
    for lib in ("cublas", "cutlass", "cute/", "cudnn", "torch/"):
        assert lib not in text.lower()
    assert not any("cuda" in f and f.startswith("-l")
                   for f in _build.NVCC_FLAGS)
    attn = (csrc / "attention.cu").read_text()
    assert "flash_attn_relpos" in attn and "template <bool" not in attn


def test_mask_head_is_a_persistent_tma_wgmma_kernel():
    """K6 is CUDA C++ for sm_90a: a grid of at most one block an SM (the
    device's SM count read at launch) walking the row tiles, both weights
    loaded once a block and keys2 through a ring by TMA behind full/empty
    mbarriers, wgmma for both products, the tile max over the warpgroup by
    a named barrier; no weight streamed by cp.async, no ldmatrix, no
    atomics and no library."""
    text = _with_headers("mask_head.cu")
    for needle in ("cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity",
                   "mbarrier.arrive.shared",
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                   "cudaDevAttrMultiProcessorCount", "bar.sync",
                   "cudaGetDriverEntryPoint"):
        assert needle in text, needle
    assert "cp.async.cg" not in (ROOT / "crowdsam_tpu_torch" / "csrc"
                                 / "mask_head.cu").read_text()
    assert "ldmatrix" not in text
    assert not re.search(r"\batomic[A-Z]|\batom\.(global|shared)", text)
    for lib in ("cublas", "cutlass", "cute/", "cudnn", "torch/"):
        assert lib not in text.lower()


def test_mask_head_gelu_polynomial_is_within_its_bound():
    """K6's GELU, relu(x) - |x| 2^g(min(|x|, c)) with g a polynomial, read
    from the source and evaluated as the kernel does in float32 (each fmaf
    rounded once, 2^g exact here; the chip smoke test sweeps the compiled
    form with ex2.approx), stays within 2^-22 max(|x|, 1) of the exact-erf
    GELU over [-12, 12] and around the clamp."""
    text = (ROOT / "crowdsam_tpu_torch" / "csrc" / "mask_head.cu").read_text()
    body = text[text.index("float gelu(float x)"):]
    body = body[:body.index("\n}\n")]
    clamp = np.float32(re.search(r"fminf\(fabsf\(x\), ([-+.e\d]+)f\)",
                                 body).group(1))
    coef = [np.float32(re.search(r"float g = ([-+.e\d]+)f;", body).group(1))]
    coef += [np.float32(c) for c in
             re.findall(r"g = fmaf\(g, a, ([-+.e\d]+)f\);", body)]
    assert len(coef) == 7 and "ex2.approx" in body

    def fma32(a, b, c):          # a * b + c rounded once to float32
        return (a.astype(np.float64) * b + c).astype(np.float32)

    x = np.concatenate([np.linspace(-12, 12, 400_001, dtype=np.float32),
                        np.float32(clamp) + np.arange(-64, 64) * 4.8e-7,
                        -np.float32(clamp) + np.arange(-64, 64) * 4.8e-7
                        ]).astype(np.float32)
    a = np.minimum(np.abs(x), clamp)
    g = np.full_like(a, coef[0])
    for c in coef[1:]:
        g = fma32(g, a, c)
    e = np.exp2(g.astype(np.float64)).astype(np.float32)
    y = fma32(-np.abs(x), e, np.maximum(x, np.float32(0)))
    xd = torch.from_numpy(x.astype(np.float64))
    want = (0.5 * xd * (1 + torch.erf(xd / np.sqrt(2.0)))).numpy()
    rel = np.abs(y - want) / np.maximum(np.abs(x), 1.0)
    assert rel.max() <= 2.0 ** -22, (rel.max(), x[rel.argmax()])


def test_relpos_attention_is_a_tma_wgmma_kernel_without_libcuda():
    """K2 and K3 are CUDA C++ for sm_90a on the pipeline of K4: TMA tensor
    loads (the windows through 5-d maps of the qkv projection, the rel-pos
    tables through 3-d maps) behind mbarriers, wgmma for every product (the
    folded bias and the fh/fw products included), no mma.sync, no ldmatrix
    and no library."""
    text = _with_headers("attention.cu")
    for needle in ("cp.async.bulk.tensor.4d", "cp.async.bulk.tensor.5d",
                   "cp.async.bulk.tensor.3d", "cp.async.bulk.tensor.2d",
                   "mbarrier.try_wait.parity", "setmaxnreg",
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16",
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                   "cudaGetDriverEntryPoint", "fence.proxy.async"):
        assert needle in text, needle
    assert "mma.sync" not in text and "ldmatrix" not in text
    for lib in ("cublas", "cutlass", "cute/", "cudnn", "torch/"):
        assert lib not in text.lower()


def test_shared_headers_are_part_of_a_cuda_build_key(monkeypatch, tmp_path):
    """A change to a shared header (`csrc/*.cuh`) names a new library for
    every CUDA source, so no stale build is loaded; host sources do not
    depend on the headers."""
    from crowdsam_tpu_torch.kernels import _build

    for name in ("a.cu", "b.cpp", "h.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    cu, cpp = _build._target(tmp_path / "a.cu"), _build._target(
        tmp_path / "b.cpp")
    (tmp_path / "h.cuh").write_text("// changed\n")
    assert _build._target(tmp_path / "a.cu") != cu
    assert _build._target(tmp_path / "b.cpp") == cpp


def test_host_sources_build_with_gxx_and_never_nvcc(monkeypatch):
    """A `.cpp` source is built by g++; asking for it never looks for
    nvcc, so the CPU-only tests build the codec."""
    from crowdsam_tpu_torch.kernels import _build

    def no_nvcc():
        raise AssertionError("nvcc asked for a host source")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    src = _build.sources()["rle_codec"]
    cmd = _build._command(src, Path("out.so"), ptxas_verbose=True)
    assert cmd[0] == "g++" and "-fPIC" in cmd and "-std=c++17" in cmd
    assert _build.library("rle_codec") is not None


def test_codec_build_failure_raises(monkeypatch, tmp_path):
    """The codec has no fallback: a failed g++ build raises."""
    from crowdsam_tpu_torch.kernels import _build

    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        _build.library("broken")


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from crowdsam_tpu_torch.config import load_config, resolve_device
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CrowdSAM(load_config(None))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_files_include_the_training_slice():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"crowdsam_tpu_torch/train/losses.py",
            "crowdsam_tpu_torch/train/trainer.py",
            "crowdsam_tpu_torch/train/dataset.py",
            "crowdsam_tpu_torch/train/__main__.py",
            "crowdsam_tpu_torch/utils/init.py",
            "crowdsam_tpu_torch/utils/fixtures.py",
            "crowdsam_tpu_torch/utils/bench_fixture.py"} <= names
    assert (ROOT / "crowdsam_tpu_torch" / "utils" /
            "init_manifest.json").is_file()


USER_SURFACE = (
    "crowdsam_tpu_torch/coco_names.py",
    "crowdsam_tpu_torch/segment_anything_cs.py",
    "crowdsam_tpu_torch/evallib/crowdhuman.py",
    "crowdsam_tpu_torch/evallib/coco_convert.py",
    "crowdsam_tpu_torch/utils/data.py",
    "crowdsam_tpu_torch/utils/logging.py",
    "crowdsam_tpu_torch/utils/misc.py",
    "crowdsam_tpu_torch/utils/visualize.py",
    "crowdsam_tpu_torch/pipeline/amg_generator.py",
    "crowdsam_tpu_torch/tools/test.py",
    "crowdsam_tpu_torch/tools/demo.py",
    "crowdsam_tpu_torch/tools/batch_eval.py",
    "crowdsam_tpu_torch/tools/crowdhuman_eval.py",
    "crowdsam_tpu_torch/tools/crowdhuman2coco.py",
)


def test_port_files_include_the_user_facing_surface():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert set(USER_SURFACE) <= names


def test_user_facing_surface_leaves_jax_out_of_sys_modules():
    mods = ", ".join(p[:-3].replace("/", ".") for p in USER_SURFACE)
    code = (f"import sys, {mods}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_port_files_include_the_deviation_probe(monkeypatch):
    """The deviation probe and its driver are the port's own modules
    (covered by `test_no_jax_imports`); importing them leaves JAX out of
    `sys.modules`, and the driver's entry point needs CUDA unless asked
    for another device."""
    probe = ("crowdsam_tpu_torch/utils/deviation_probe.py",
             "crowdsam_tpu_torch/tools/probe_deviations.py")
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert set(probe) <= names
    mods = ", ".join(p[:-3].replace("/", ".") for p in probe)
    code = (f"import sys, {mods}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    from crowdsam_tpu_torch.tools import probe_deviations

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(ROOT)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe_deviations.main(["1"])


def test_layernorm_source_holds_its_backward_without_library_calls():
    """K1's backward is in its source (the vector and scalar arms, and the
    last block's sum of the partials that replaced a second launch), calls
    no library, and takes no atomic on a sum: its only atomics count the
    blocks' tickets, so dw and db are the same bit for bit from call to
    call."""
    src = (ROOT / "crowdsam_tpu_torch" / "csrc" / "layernorm.cu").read_text()
    for name in ("ln_bwd_rows", "ln_bwd_vec", "finish_partials",
                 "ln_backward", "ln_forward_stats"):
        assert name in src, name
    code = re.sub(r"//[^\n]*", "", src)
    includes = set(re.findall(r"#include\s*<([^>]+)>", code))
    assert includes <= {"cuda_runtime.h", "cuda_bf16.h", "stdint.h",
                        "string.h"}, includes
    assert set(re.findall(r'#include\s*"([^"]+)"', code)) <= {"sm90.cuh"}
    for lib in ("cublas", "cub::", "DeviceReduce", "thrust", "cudnn"):
        assert lib not in code, lib
    assert not re.findall(r"\batomic\w*\s*\(", code)
    ptx = re.findall(r'"\s*((?:atom|red)\.[\w.]+)', code)
    assert ptx == ["atom.acq_rel.gpu.global.add.u32"], ptx
    tickets = re.findall(r"take_ticket\(([^)]*)\)", code)
    assert tickets[0] == "unsigned* word", tickets
    assert len(tickets) > 1 and all(
        t.startswith("&a.tickets[") for t in tickets[1:]), tickets


def _guard_cases():
    from crowdsam_tpu_torch.models import attention
    from crowdsam_tpu_torch.models.decode_tail_kernel import twoway_tail
    from crowdsam_tpu_torch.models.mask_head_kernel import mask_head
    from crowdsam_tpu_torch.ops.survivor_kernel import survivor_rle

    def t(*shape):
        return torch.zeros(shape)

    return {
        "window_attention": lambda g: attention.window_attention(
            t(1, 14, 14, 3 * 64), g(14, 14, 64), t(14, 14, 64), 1, 0.125,
            14),
        "flash_mha_decomposed_relpos": lambda g:
            attention.flash_mha_decomposed_relpos(
                t(1, 1, 4, 64), t(1, 1, 4, 64), t(1, 1, 4, 64), 0.125,
                g(2, 2, 64), t(2, 2, 64), (2, 2)),
        "flash_mha": lambda g: attention.flash_mha(
            g(1, 1, 4, 64), t(1, 1, 4, 64), t(1, 1, 4, 64), 0.125),
        "twoway_tail": lambda g: twoway_tail(
            t(64, 256), t(64, 128), t(64, 128), t(64, 128), t(1, 7, 256),
            {"w": g(4)}),
        "mask_head": lambda g: mask_head(t(1, 64, 256), t(1, 4, 32),
                                         {"w0t": g(4)}),
        "survivor_rle": lambda g: survivor_rle(
            g(1, 32, 32), torch.zeros((1, 32, 32), dtype=torch.int8),
            torch.tensor([128, 128], dtype=torch.int32)),
    }


@pytest.mark.parametrize("name", ["window_attention",
                                  "flash_mha_decomposed_relpos", "flash_mha",
                                  "twoway_tail", "mask_head", "survivor_rle"])
def test_kernels_without_backward_refuse_grad(name):
    """K2-K7 have no backward: with grad mode on and an input or weight
    that requires grad, the wrapper raises (on the CPU route as on the
    card) instead of returning a tensor with no graph."""
    call = _guard_cases()[name]

    def needs_grad(*shape):
        return torch.zeros(shape, requires_grad=True)

    with pytest.raises(RuntimeError, match="no backward"):
        call(needs_grad)
    with torch.no_grad():
        try:
            call(needs_grad)
        except RuntimeError as e:
            assert "no backward" not in str(e)
        except (ValueError, TypeError, KeyError):
            pass
