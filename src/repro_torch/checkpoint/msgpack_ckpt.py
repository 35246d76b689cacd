"""Checkpointing: a tree <-> msgpack, compressed; the reference's file
format (``repro/checkpoint/msgpack_ckpt.py``), so either package reads
the other's files.

A tensor is stored as ``{"__array__": True, "dtype", "shape", "data"}``
(its numpy dtype name, its shape, its raw little-endian bytes), a Python
scalar or string as ``{"__scalar__": True, "value"}``, a dict as
``{"__dict__": {...}}`` and a list or tuple as ``{"__list__": [...],
"tuple": bool}``.  bfloat16 is named ``"bfloat16"``, as ml_dtypes names
it, and its bytes are read and written through an int16 view.  The
payload is msgpack, written by this module's own encoder of the subset
the format uses (map, array, str, bin, int, float, bool, nil) in the
encoding ``msgpack.packb(..., use_bin_type=True)`` gives, so the payload
bytes equal the reference's for the same tree.  It is compressed with
zstd (level 3) when the ``zstandard`` module imports, else with zlib
(level 6); reading sniffs the zstd frame magic, and a zstd file without
``zstandard`` raises the reference's ``RuntimeError``.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from repro_torch.device import resolve_device

try:
    import zstandard
except ImportError:  # a host without the zstd wheel writes zlib
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_ARRAY_KEY = "__array__"
_SCALAR_KEY = "__scalar__"


# --------------------------------------------------------------------------
# msgpack: the subset of the format
# --------------------------------------------------------------------------

def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"),
                                 (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack")
    else:
        for limit, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                                 (-0x80000000, 0xD2, ">i"),
                                 (-0x8000000000000000, 0xD3, ">q")):
            if v >= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_len(n: int, fix, fix_max: int, codes, out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    (``codes`` one per width, ``None`` where the type has no such form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (dict, list, tuple, str, bytes, int, float,
    bool, None), as ``msgpack.packb(obj, use_bin_type=True)``."""
    out = bytearray()

    def pack(o):
        if o is None:
            out.append(0xC0)
        elif o is True:
            out.append(0xC3)
        elif o is False:
            out.append(0xC2)
        elif isinstance(o, int):
            _pack_int(o, out)
        elif isinstance(o, float):
            out.append(0xCB)
            out.extend(struct.pack(">d", o))
        elif isinstance(o, str):
            raw = o.encode("utf-8")
            _pack_len(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
            out.extend(raw)
        elif isinstance(o, (bytes, bytearray, memoryview)):
            raw = bytes(o)
            _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), out)
            out.extend(raw)
        elif isinstance(o, dict):
            _pack_len(len(o), 0x80, 16, (None, 0xDE, 0xDF), out)
            for k, v in o.items():
                pack(k)
                pack(v)
        elif isinstance(o, (list, tuple)):
            _pack_len(len(o), 0x90, 16, (None, 0xDC, 0xDD), out)
            for v in o:
                pack(v)
        else:
            raise TypeError(f"cannot msgpack {type(o)}")

    pack(obj)
    return bytes(out)


def unpackb(data: bytes):
    """The object of msgpack bytes (maps as dicts, arrays as lists, str as
    str, bin as bytes); the inverse of :func:`packb` and of the reference's
    ``msgpack.unpackb(..., raw=False)`` for this format."""
    view = memoryview(data)
    pos = 0

    def take(n):
        nonlocal pos
        chunk = view[pos:pos + n]
        if len(chunk) != n:
            raise ValueError("truncated msgpack payload")
        pos += n
        return chunk

    def num(fmt):
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    def unpack():
        b = take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [unpack() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(take(b & 0x1F)).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return num(ints[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if b in lens:
            n = num(lens[b])
            if b in (0xC4, 0xC5, 0xC6):
                return bytes(take(n))
            if b in (0xD9, 0xDA, 0xDB):
                return bytes(take(n)).decode("utf-8")
            if b in (0xDC, 0xDD):
                return [unpack() for _ in range(n)]
            return mapping(n)
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the "
                         f"checkpoint format")

    def mapping(n):
        out = {}
        for _ in range(n):
            k = unpack()
            out[k] = unpack()
        return out

    obj = unpack()
    if pos != len(data):
        raise ValueError("trailing bytes after the msgpack payload")
    return obj


# --------------------------------------------------------------------------
# tree <-> format nodes
# --------------------------------------------------------------------------

def _array_node(t: torch.Tensor):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        dtype, arr = "bfloat16", t.view(torch.int16).numpy()
    else:
        arr = t.numpy()
        dtype = str(arr.dtype)
    return {_ARRAY_KEY: True, "dtype": dtype, "shape": list(arr.shape),
            "data": arr.tobytes()}


def _encode(node):
    if isinstance(node, torch.Tensor):
        return _array_node(node)
    if isinstance(node, np.ndarray):
        return _array_node(torch.from_numpy(np.ascontiguousarray(node)))
    if isinstance(node, (int, float, bool, str)) or node is None:
        return {_SCALAR_KEY: True, "value": node}
    if isinstance(node, dict):
        return {"__dict__": {k: _encode(v) for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"__list__": [_encode(v) for v in node],
                "tuple": isinstance(node, tuple)}
    raise TypeError(f"cannot checkpoint node of type {type(node)}")


def _decode(node, device):
    if _ARRAY_KEY in node:
        shape = tuple(node["shape"])
        if node["dtype"] == "bfloat16":
            arr = np.frombuffer(node["data"], dtype="<i2").copy()
            t = torch.from_numpy(arr).view(torch.bfloat16)
        else:
            arr = np.frombuffer(node["data"], dtype=np.dtype(node["dtype"]))
            t = torch.from_numpy(arr.copy())
        return t.reshape(shape).to(device)
    if _SCALAR_KEY in node:
        return node["value"]
    if "__dict__" in node:
        return {k: _decode(v, device) for k, v in node["__dict__"].items()}
    if "__list__" in node:
        items = [_decode(v, device) for v in node["__list__"]]
        return tuple(items) if node["tuple"] else items
    raise TypeError(f"bad checkpoint node: {node.keys()}")


def save_checkpoint(path: str, tree) -> None:
    """Write ``tree`` (nested dicts / lists / tuples of tensors, numpy
    arrays and Python scalars) to ``path``, atomically."""
    payload = packb(_encode(tree))
    if zstandard is not None:
        comp = zstandard.ZstdCompressor(level=3).compress(payload)
    else:
        comp = zlib.compress(payload, level=6)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(comp)
    os.replace(tmp, path)  # atomic on POSIX


def load_checkpoint(path: str, *, device=None):
    """The tree of a checkpoint file, its tensors on ``device`` (``None``
    means ``cuda``, which raises without CUDA: pass ``"cpu"``)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        comp = f.read()
    if comp[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError(
                f"{path} is zstd-compressed but the zstandard module is "
                "unavailable in this environment"
            )
        payload = zstandard.ZstdDecompressor().decompress(comp)
    else:
        payload = zlib.decompress(comp)
    return _decode(unpackb(payload), device)
