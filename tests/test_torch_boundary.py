"""Import boundary of the PyTorch port: `crowdsam_tpu_torch` and
`chip_smoke.py` import neither JAX, flax nor the JAX package, and the entry
points refuse to fall back to the CPU silently."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "crowdsam_tpu")


def _port_files():
    return sorted((ROOT / "crowdsam_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


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
        " crowdsam_tpu_torch.utils.weights\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from crowdsam_tpu_torch.config import load_config, resolve_device
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CrowdSAM(load_config(None))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
