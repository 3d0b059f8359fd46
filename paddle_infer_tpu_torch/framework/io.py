"""The ``.pits`` tensor store and the ``.pdparams`` pickle, in plain
Python.

The reference writes and reads ``.pits`` through its native library
(``native/tensor_store.cc``); this is the same format over ``np.memmap``,
with no build.  Little-endian:

    magic "PITS" | uint32 version (1) | uint32 count
    per tensor: uint32 name_len | name (utf-8) | uint32 dtype_code |
                uint32 ndim | int64 dims[ndim] | uint64 nbytes | data

The dtype codes are the reference's (``paddle_infer_tpu/native``).
bfloat16 payloads never pass through a numpy dtype (numpy has none
without ``ml_dtypes``): they are read as ``uint16`` and viewed as
``torch.bfloat16``, and written from the same view, so a round trip is
bitwise.  ``load_tensors`` returns CPU tensors over a copy-on-write
mapping of the file: nothing is read until a tensor is used, and moving
one to the card is its one copy.

``save`` and ``load`` are the reference's ``paddle.save`` /
``paddle.load`` (``paddle_infer_tpu/framework/io.py``): a ``.pits`` path
holds a flat ``{name: tensor}`` dict in the tensor store; any other path
a pickle in which every tensor became a numpy array (a bfloat16 one
widened to float32, which numpy can hold), so a ``.pdparams`` or
``.pdopt`` file written by either package loads in the other.
"""
from __future__ import annotations

import os
import pickle
import struct
from typing import Dict

import numpy as np
import torch

MAGIC = b"PITS"
VERSION = 1
PITS_SUFFIX = ".pits"

# the reference's wire codes (paddle_infer_tpu/native/__init__.py)
DTYPE_CODES = {
    "float32": 0, "float64": 1, "float16": 2, "bfloat16": 3,
    "int8": 4, "uint8": 5, "int16": 6, "int32": 7, "int64": 8, "bool": 9,
}
_CODE_NAMES = {v: k for k, v in DTYPE_CODES.items()}
_TORCH_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
}


def _payload(t: torch.Tensor):
    """``(dtype name, shape, contiguous numpy array of the raw bytes)``
    of a tensor; bfloat16 travels as its 16-bit pattern."""
    t = t.detach()
    name = _TORCH_NAMES.get(t.dtype)
    if name is None:
        raise TypeError(f"unsupported dtype {t.dtype}")
    shape = tuple(t.shape)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return name, shape, t.contiguous().cpu().numpy()


def save_tensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write named tensors to a ``.pits`` store."""
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack("<II", VERSION, len(tensors)))
        for name, value in tensors.items():
            try:
                dt, shape, data = _payload(value)
            except TypeError as e:
                raise TypeError(f"{e} for '{name}'") from None
            key = name.encode()
            f.write(struct.pack("<I", len(key)) + key)
            f.write(struct.pack("<II", DTYPE_CODES[dt], len(shape)))
            f.write(struct.pack(f"<{len(shape)}q", *shape))
            f.write(struct.pack("<Q", data.nbytes))
            f.write(data.reshape(-1).view(np.uint8).data)


def load_tensors(path: str) -> Dict[str, torch.Tensor]:
    """Map a ``.pits`` store; returns ``{name: CPU tensor}`` views of the
    file.  Raises ``FileNotFoundError`` for a missing file and
    ``ValueError`` for a corrupt or truncated one."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"cannot open tensor store {path}")
    size = os.path.getsize(path)
    if size < 12:
        raise ValueError(f"corrupt/truncated tensor store {path}")
    # copy-on-write: the arrays are writable (torch wants that) and
    # nothing written to them reaches the file
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    head = mm[:12].tobytes()
    magic, (version, count) = head[:4], struct.unpack("<II", head[4:])
    if magic != MAGIC or version != VERSION:
        raise ValueError(f"corrupt/truncated tensor store {path}")
    out: Dict[str, torch.Tensor] = {}
    off = 12

    def take(n):
        nonlocal off
        if off + n > size:
            raise ValueError(f"corrupt/truncated tensor store {path}")
        b = mm[off:off + n]
        off += n
        return b

    for _ in range(count):
        (name_len,) = struct.unpack("<I", take(4).tobytes())
        name = take(name_len).tobytes().decode()
        code, ndim = struct.unpack("<II", take(8).tobytes())
        shape = struct.unpack(f"<{ndim}q", take(8 * ndim).tobytes())
        (nbytes,) = struct.unpack("<Q", take(8).tobytes())
        data = take(nbytes)
        dt = _CODE_NAMES.get(code)
        if dt is None:
            raise ValueError(f"unknown dtype code {code} for '{name}' in "
                             f"{path}")
        np_dt = np.dtype("uint16" if dt == "bfloat16" else dt)
        if nbytes != np_dt.itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"corrupt/truncated tensor store {path}")
        t = torch.from_numpy(data.view(np_dt).reshape(shape))
        out[name] = t.view(torch.bfloat16) if dt == "bfloat16" else t
    return out


def load(path: str):
    """A ``.pits`` store as ``{name: tensor}``, anything else as the
    reference's ``.pdparams`` pickle (``{name: np.ndarray}``)."""
    if path.endswith(PITS_SUFFIX):
        return load_tensors(path)
    with open(path, "rb") as f:
        return pickle.load(f)


def _to_saveable(obj):
    """``obj`` with every tensor as a CPU numpy array (bfloat16 widened
    to float32); containers recurse."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj) if type(obj) in (list, tuple) else list
        return t(_to_saveable(v) for v in obj)
    return obj


def save(obj, path: str, protocol: int = 4):
    """Write ``obj``: a flat ``{name: tensor}`` dict to a ``.pits`` store,
    anything else as a pickle of numpy arrays (``paddle.save``)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if path.endswith(PITS_SUFFIX):
        if not (isinstance(obj, dict) and all(
                isinstance(v, (torch.Tensor, np.ndarray))
                for v in obj.values())):
            raise TypeError(
                f"{PITS_SUFFIX} format stores flat name->tensor dicts; "
                "use a .pdparams pickle path for nested objects")
        save_tensors(path, {k: torch.as_tensor(v) for k, v in obj.items()})
        return
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)
