"""Read flax msgpack checkpoints without flax or the `msgpack` package.

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
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, Tuple

import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"

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
