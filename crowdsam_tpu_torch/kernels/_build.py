"""Build the sources in `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` (a CUDA kernel, compiled by nvcc for `sm_90a`, which
may include the shared headers `csrc/*.cuh`) or `csrc/<name>.cpp` (host
code, compiled by g++) exposes a plain C interface and is compiled on its
own into `build/kernels/lib<name>_<hash>.so` under
the repository root (listed in .gitignore), the first time a function of it
is called.  `build_all` starts one compiler per source at once, so the build
costs the slowest file, not the sum.  Nothing is compiled when a module is
imported, and a host source never calls nvcc: the CPU tests build the host
codec with g++ alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}
# ptxas reports (registers, shared memory, spills) of the last build.
BUILD_LOGS: Dict[str, str] = {}


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))
            + sorted(CSRC_DIR.glob("*.cpp"))}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _command(src: Path, out: Path, ptxas_verbose: bool) -> list:
    if src.suffix == ".cpp":
        return ["g++", *GXX_FLAGS, "-o", str(out), str(src)]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    if ptxas_verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def _target(src: Path) -> Path:
    """The library of `src`, named by a hash of the source and of the
    shared headers (`csrc/*.cuh`) a CUDA source may include."""
    h = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(src.parent.glob("*.cuh")):
            h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None,
              ptxas_verbose: bool = False) -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load the named sources; all by default.
    Raises when a compiler fails: no caller goes on without its library."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            out = _target(srcs[n])
            if out.exists() and not ptxas_verbose:
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = _command(srcs[n], tmp, ptxas_verbose)
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        failed = []
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOGS[n] = log
            if proc.returncode != 0:
                failed.append(f"{srcs[n].name}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("build failed\n" + "\n".join(failed))
        for n in todo:
            _LIBS[n] = ctypes.CDLL(str(_target(srcs[n])))
        return {n: _LIBS[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = build_all([name])[name]
    return lib


def function(lib_name: str, fn_name: str, argtypes,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """A C entry point of `csrc/<lib_name>.*` with its argtypes declared
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""
    fn = _FUNCS.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(library(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FUNCS[(lib_name, fn_name)] = fn
    return fn


def require_operand(fn_name: str, t, name: str, shape, dtype,
                    device) -> None:
    """Raise unless tensor `t` is what a kernel's C entry point takes: on
    `device`, of `dtype`, of `shape`, contiguous."""
    if t.device != device:
        raise ValueError(f"{fn_name}: {name} on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn_name}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn_name}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn_name}: {name} must be contiguous")


def refuse_grad(fn_name: str, *tensors) -> None:
    """Raise when autograd would want a gradient through a kernel that has
    no backward (K2-K7): grad mode on and a tensor (or a dict of them)
    that requires grad.  Such a call would otherwise return a tensor with
    no graph and cut the gradient without a word; on both devices, so the
    CPU route shows what the card would do.  Serving runs under
    `torch.no_grad()`."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        for u in (t.values() if isinstance(t, dict) else (t,)):
            if isinstance(u, torch.Tensor) and u.requires_grad:
                raise RuntimeError(
                    f"{fn_name}: the kernel has no backward and an input "
                    "requires grad; call it under torch.no_grad()")


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
