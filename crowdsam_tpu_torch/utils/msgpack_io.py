"""Read and write flax msgpack checkpoints without flax or the `msgpack`
package.

The JAX package saves parameter trees (the trained adapters under
`adapter_weights/`) with `flax.serialization.msgpack_serialize` and reads
them with `msgpack_restore`.  This module decodes the subset of MessagePack
that those files use and returns the same tree, with torch tensors for the
array leaves:

- maps (str keys), arrays, str, bin, int, float, bool and nil;
- ext type 1, an ndarray: its payload is itself MessagePack, the tuple
  (shape, dtype name, raw C-order bytes);
- ext type 3, a numpy scalar, packed as a 0-d ndarray (a 0-d tensor here);
- arrays larger than flax's chunk size, which flax writes as a map
  `{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}` and
  joins back on reading.

Tensors are built with `torch.frombuffer` from little-endian bytes, as
numpy writes them on the hosts that produce and read these files.  A dtype
name of `bfloat16` maps to `torch.bfloat16` (numpy has no bf16).

`dump`/`save` write a tree of dicts, lists, tuples, scalars and tensors (or
numpy arrays) the way `flax.serialization.msgpack_serialize` does, with the
same bytes for the same tree: each array as ext type 1 (a numpy scalar as
ext type 3), arrays above flax's chunk size in its chunked form, the
smallest MessagePack type for each int, str and container, floats as
float64, map keys sorted.  So the trainer's checkpoints and decoders load with the JAX
package's `utils/checkpoint.load_pytree` / `load_adapter_checkpoint`.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30           # bytes; flax chunks larger arrays

_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}


class _Reader:
    """A cursor over one MessagePack buffer; `ext` decodes ext payloads."""

    def __init__(self, data: bytes, ext: Callable[[int, bytes], Any]):
        self.data = memoryview(data)
        self.pos = 0
        self.ext = ext

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("bin", "B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", "B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", "B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            code = self.unpack("b")
            return self.ext(code, bytes(self.take(n)))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:                       # fixext 1, 2, 4, 8, 16
            code = self.unpack("b")
            return self.ext(code, bytes(self.take(1 << (b - 0xD4))))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes, ext: Callable[[int, bytes], Any]) -> Any:
    """Decode one MessagePack object (the whole buffer); ext payloads go to
    `ext(code, payload)`."""
    r = _Reader(data, ext)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes after the object")
    return out


def _tensor(shape: Tuple[int, ...], dtype_name: str, raw: bytes):
    if dtype_name not in _DTYPES:
        raise ValueError(f"msgpack: unsupported dtype {dtype_name!r}")
    dtype = _DTYPES[dtype_name]
    if not raw:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(tuple(shape))


def _ext(code: int, payload: bytes) -> Any:
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack: unsupported ext type {code}")
    shape, name, raw = unpackb(payload, _ext)
    if isinstance(name, bytes):
        name = name.decode()
    return _tensor(tuple(shape), name, raw)


def _unchunk(tree: Any) -> Any:
    """Join flax's chunked array leaves back into one tensor each."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The tree that `flax.serialization.msgpack_restore` returns, with
    torch tensors for its array leaves."""
    return _unchunk(unpackb(data, _ext))


def load(path: str) -> Any:
    """`msgpack_restore` of a file."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A size header: the fix form below `fix_max`, else the 8/16/32-bit
    form in `codes` (None where MessagePack has none)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, ("B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: object of size {n} too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, "B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: int {v} too large")
    else:
        for code, fmt, limit in ((0xD0, "b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: int {v} too small")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack("b", code)
    out += payload


def _array_payload(a: np.ndarray, name: str) -> bytes:
    out = bytearray()
    _pack(out, (tuple(a.shape), name, a.tobytes("C")))
    return bytes(out)


def _numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor's C-order bytes as a numpy array, and its dtype name."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def _pack(out: bytearray, v: Any) -> None:
    if v is None:
        out.append(0xC0)
    elif isinstance(v, bool):
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(v, (bytes, bytearray)):
        _head(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 16, (None, 0xDE, 0xDF))
        # flax's tree_map sorts a tree's keys; its chunked-array maps keep
        # their order.
        items = v.items() if isinstance(v, _Chunked) else sorted(v.items())
        for k, item in items:
            _pack(out, k)
            _pack(out, item)
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif isinstance(v, torch.Tensor):
        a, name = _numpy(v)
        _pack_ext(out, EXT_NDARRAY, _array_payload(a, name))
    elif isinstance(v, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _array_payload(v, v.dtype.name))
    elif isinstance(v, np.generic):
        a = np.asarray(v)
        _pack_ext(out, EXT_NPSCALAR, _array_payload(a, a.dtype.name))
    else:
        raise TypeError(f"msgpack: cannot write {type(v).__name__}")


class _Chunked(dict):
    """A map written in insertion order (flax's chunked-array form)."""


def _chunk(tree: Any) -> Any:
    """Arrays above MAX_CHUNK_SIZE bytes in flax's chunked form."""
    if isinstance(tree, dict):
        return {k: _chunk(v) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        nbytes = (tree.numel() * tree.element_size()
                  if isinstance(tree, torch.Tensor) else tree.nbytes)
        if nbytes > MAX_CHUNK_SIZE:
            flat = tree.reshape(-1)
            size = max(1, MAX_CHUNK_SIZE // (nbytes // flat.shape[0]))
            chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
            return _Chunked({
                _CHUNKED: True,
                "shape": _Chunked((str(i), n) for i, n in enumerate(
                    tree.shape)),
                "chunks": _Chunked((str(i), c) for i, c in enumerate(
                    chunks))})
    return tree


def dump(tree: Any) -> bytes:
    """`flax.serialization.msgpack_serialize` of a tree whose array leaves
    are torch tensors or numpy arrays."""
    out = bytearray()
    _pack(out, _chunk(tree))
    return bytes(out)


def save(path: str, tree: Any) -> None:
    """`dump` to a file (its directory made first), as the JAX package's
    `save_pytree` writes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(dump(tree))
