"""flax.serialization's msgpack format, in pure Python.

The JAX package writes its checkpoints with `flax.serialization.to_bytes`:
a msgpack map of string keys (a tuple or list becomes a map keyed '0',
'1', ...; a namedtuple a map of its fields) whose array leaves are msgpack
extensions:
  ext 1  an ndarray: a packed (shape, dtype name, C-order bytes) triple;
  ext 2  a complex: a packed (real, imag) pair;
  ext 3  a numpy scalar: as ext 1, read back as a scalar.
An array above MAX_CHUNK_SIZE bytes is written as
{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}} of
flat pieces. `packb` / `dump` write that subset with the encodings that
msgpack-python's packb(use_bin_type=True, strict_types=True) chooses (the
smallest int, float64 for a Python float, the shortest str, bin and
container headers), so the bytes equal flax's for the same tree; `unpackb`
reads it back as nested dicts of numpy arrays. Payloads are sliced out of
one memoryview, never copied byte by byte. bfloat16 has no numpy dtype
here: such a leaf is read into a torch.bfloat16 tensor, and a
torch.bfloat16 tensor is written with dtype name 'bfloat16'.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO, Callable, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ writer

def _int(n: int) -> bytes:
    """msgpack-python's choice: a fixint, else the smallest unsigned form
    of a positive and the smallest signed form of a negative number."""
    if 0 <= n < 0x80 or -0x20 <= n < 0:
        return struct.pack("b" if n < 0 else "B", n)
    forms = ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")) if n > 0 \
        else ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q"))
    for code, fmt in forms:
        try:
            return struct.pack(">B" + fmt, code, n)
        except struct.error:
            continue
    raise OverflowError(f"integer {n} out of msgpack's range")


_LENGTHS = (("B", 0xFF), ("H", 0xFFFF), ("I", 0xFFFFFFFF))


def _sized(n: int, codes, fix: int = 0, fix_max: int = -1) -> bytes:
    """The header of a str / bin / array / map / ext of length n: the fix
    form (fix | n) up to fix_max, else the first of `codes` (the 8-, 16-
    and 32-bit length forms, or the last two of them) that holds n."""
    if n <= fix_max:
        return struct.pack("B", fix | n)
    for code, (fmt, limit) in zip(codes, _LENGTHS[3 - len(codes):]):
        if n <= limit:
            return struct.pack(">B" + fmt, code, n)
    raise ValueError(f"length {n} is too large for msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), (0xD9, 0xDA, 0xDB), 0xA0, 0x1F) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, (0xC4, 0xC5, 0xC6))


def _array_header(n: int) -> bytes:
    return _sized(n, (0xDC, 0xDD), 0x90, 0x0F)


def _map_header(n: int) -> bytes:
    return _sized(n, (0xDE, 0xDF), 0x80, 0x0F)


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _ext_header(code: int, n: int) -> bytes:
    head = struct.pack("B", _FIXEXT[n]) if n in _FIXEXT \
        else _sized(n, (0xC7, 0xC8, 0xC9))
    return head + struct.pack("b", code)


def _leaf_bytes(x) -> Tuple[Tuple[int, ...], str, memoryview]:
    """(shape, dtype name, C-order bytes) of an array or tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return (tuple(x.shape), "bfloat16",
                    memoryview(x.view(torch.int16).numpy().reshape(-1)
                               .view(np.uint8)))
        x = x.numpy()
    a = np.asarray(x, order="C")     # (ascontiguousarray makes 0-d 1-d)
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"cannot serialize an array of dtype {a.dtype}")
    return tuple(a.shape), a.dtype.name, memoryview(a.reshape(-1).view(np.uint8))


def _ndarray_parts(code: int, x) -> List[Any]:
    """An ext `code` leaf: its headers and its payload's raw bytes."""
    shape, name, raw = _leaf_bytes(x)
    inner = (_array_header(3) + _array_header(len(shape))
             + b"".join(_int(int(d)) for d in shape) + _str(name)
             + _bin_header(raw.nbytes))
    return [_ext_header(code, len(inner) + raw.nbytes), inner, raw]


def _chunk(a: np.ndarray) -> dict:
    """flax's chunked form of an array above MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / a.dtype.itemsize))
    flat = a.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(a.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.size, size))}}


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _too_big(x) -> bool:
    return isinstance(x, np.ndarray) and x.size * x.dtype.itemsize \
        > MAX_CHUNK_SIZE


def _state(x):
    """flax's to_state_dict: containers -> dicts of string keys."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _state(getattr(x, k)) for k in x._fields}
    if type(x) in (list, tuple):
        return {str(i): _state(v) for i, v in enumerate(x)}
    if type(x) is dict:
        return {str(k): _state(v) for k, v in x.items()}
    return x


def _parts(x, out: List[Any]) -> None:
    if x is None:
        out.append(b"\xc0")
    elif type(x) is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif type(x) is str:
        out.append(_str(x))
    elif type(x) is bytes:
        out += [_bin_header(len(x)), x]
    elif type(x) is dict:
        out.append(_map_header(len(x)))
        for k, v in x.items():
            out.append(_str(k))
            if _too_big(v):
                v = _chunk(v)
            _parts(v, out)
    elif _is_array(x):
        out += _ndarray_parts(EXT_NDARRAY, x)
    elif isinstance(x, np.generic):
        out += _ndarray_parts(EXT_NPSCALAR, np.asarray(x))
    elif type(x) is complex:
        body = _array_header(2) + struct.pack(">Bd", 0xCB, x.real) \
            + struct.pack(">Bd", 0xCB, x.imag)
        out += [_ext_header(EXT_COMPLEX, len(body)), body]
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def _tree_parts(tree) -> List[Any]:
    tree = _state(tree)
    if _too_big(tree):
        tree = _chunk(tree)
    out: List[Any] = []
    _parts(tree, out)
    return out


def packb(tree) -> bytes:
    """`flax.serialization.to_bytes(tree)` for a tree of dicts, lists,
    tuples and namedtuples with numpy arrays, torch tensors, numpy
    scalars and Python scalars at the leaves."""
    return b"".join(_tree_parts(tree))


def dump(tree, f: BinaryIO) -> None:
    """`packb(tree)` written to the binary file `f` piece by piece (each
    array's bytes straight from its buffer)."""
    for part in _tree_parts(tree):
        f.write(part)


# ------------------------------------------------------------------ reader

_LENGTH_FORMS = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        value = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return value[0]

    def read(self, raw: bool = False):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.read(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
                0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        if b in _LENGTH_FORMS:
            kind, fmt = _LENGTH_FORMS[b]
            n = self.unpack(fmt)
            if kind == "bin":            # a view inside an ext payload
                return self.take(n) if raw else bytes(self.take(n))
            if kind == "str":
                return self.text(n, raw)
            if kind == "array":
                return [self.read(raw) for _ in range(n)]
            if kind == "map":
                return self.map(n, raw)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"msgpack byte 0x{b:02x} is not in flax's format")

    def text(self, n: int, raw: bool):
        view = self.take(n)
        return bytes(view) if raw else str(view, "utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.read(raw)
            out[k] = self.read(raw)
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        body = _Reader(self.take(n))
        if code == EXT_COMPLEX:
            re, im = body.read()
            return complex(re, im)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            shape, name, raw = body.read(raw=True)
            a = _array(bytes(name).decode(), raw, tuple(shape))
            return a[()] if code == EXT_NPSCALAR else a
        raise ValueError(f"msgpack extension type {code} is not flax's")


def _array(name: str, raw: memoryview, shape: Tuple[int, ...]):
    if name == "bfloat16":
        if raw.readonly:
            raw = bytearray(raw)
        if len(raw) == 0:
            return torch.zeros(shape, dtype=torch.bfloat16)
        return torch.frombuffer(raw, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data) -> Any:
    """`flax.serialization.msgpack_restore(data)`: nested dicts (lists for
    msgpack arrays) of numpy arrays (read-only views of `data` when it is
    read-only), torch.bfloat16 tensors and Python scalars."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def map_leaves(fn: Callable, tree):
    """`fn` applied to every non-dict leaf of nested dicts."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)
