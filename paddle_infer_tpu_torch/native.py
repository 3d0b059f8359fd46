"""ctypes binding to the paged-KV block allocator (``native/kv_allocator.cc``).

Port of the pool half of ``paddle_infer_tpu/native/__init__.py``
(``KVBlockPool``, with the block-level operations the prefix cache
uses).  The C++ source is shared with the JAX package and
read as it is; this module compiles it alone (it needs only the C++
standard library) with ``g++ -O3 -fPIC -shared -std=c++17`` into the
port's git-ignored build directory at first use, so a clean checkout
builds everything from the repository's sources.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "kv_allocator.cc")
_LIB_PATH = os.path.join(BUILD_DIR, "libkvpool.so")

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile the allocator if the library is missing or older than its
    source; returns the library path.  The compiler writes to a temporary
    name that is renamed into place, so concurrent processes (test
    workers) never load a half-written file."""
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SOURCE)):
        return _LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                        "-o", tmp, _SOURCE],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB_PATH)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building {_SOURCE} failed:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB_PATH


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        c = ctypes
        sigs = {
            "kv_pool_create": ([c.c_int32, c.c_int32], c.c_void_p),
            "kv_pool_destroy": ([c.c_void_p], None),
            "kv_pool_free_blocks": ([c.c_void_p], c.c_int32),
            "kv_seq_reserve": ([c.c_void_p, c.c_int64, c.c_int32],
                               c.c_int32),
            "kv_seq_table": ([c.c_void_p, c.c_int64, c.POINTER(c.c_int32),
                              c.c_int32], c.c_int32),
            "kv_seq_length": ([c.c_void_p, c.c_int64], c.c_int32),
            "kv_seq_fork": ([c.c_void_p, c.c_int64, c.c_int64], c.c_int32),
            "kv_seq_cow_last": ([c.c_void_p, c.c_int64,
                                 c.POINTER(c.c_int32),
                                 c.POINTER(c.c_int32)], c.c_int32),
            "kv_seq_free": ([c.c_void_p, c.c_int64], None),
            "kv_block_alloc": ([c.c_void_p], c.c_int32),
            "kv_block_ref": ([c.c_void_p, c.c_int32], c.c_int32),
            "kv_block_unref": ([c.c_void_p, c.c_int32], c.c_int32),
            "kv_block_refcount": ([c.c_void_p, c.c_int32], c.c_int32),
            "kv_seq_assign": ([c.c_void_p, c.c_int64, c.POINTER(c.c_int32),
                               c.c_int32, c.c_int32], c.c_int32),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return lib


class KVBlockPool:
    """Paged-KV page-table manager: tracks which blocks of the device
    pools ``[num_blocks, heads, block_size, head_dim]`` belong to which
    sequence.  Same allocator, same block order as the JAX package's
    pool, so both hand out identical tables for identical call
    sequences."""

    def __init__(self, num_blocks: int, block_size: int):
        self._lib = _load()
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._h = self._lib.kv_pool_create(self.num_blocks, self.block_size)
        if not self._h:
            raise ValueError("kv_pool_create failed")

    @property
    def free_blocks(self) -> int:
        return int(self._lib.kv_pool_free_blocks(self._h))

    def reserve(self, seq_id: int, num_tokens: int) -> int:
        """Grow ``seq_id`` to hold ``num_tokens``; returns its block
        count.  Raises MemoryError when the pool is exhausted."""
        n = self._lib.kv_seq_reserve(self._h, seq_id, num_tokens)
        if n < 0:
            raise MemoryError(
                f"KV pool exhausted ({self.num_blocks} blocks)")
        return int(n)

    def block_table(self, seq_id: int) -> np.ndarray:
        buf = (ctypes.c_int32 * self.num_blocks)()
        n = self._lib.kv_seq_table(self._h, seq_id, buf, self.num_blocks)
        return np.ctypeslib.as_array(buf)[:n].copy()

    def length(self, seq_id: int) -> int:
        return int(self._lib.kv_seq_length(self._h, seq_id))

    def fork(self, parent: int, child: int) -> int:
        """Copy-on-write fork: ``child`` shares ``parent``'s blocks."""
        n = self._lib.kv_seq_fork(self._h, parent, child)
        if n < 0:
            raise KeyError(f"unknown parent sequence {parent}")
        return int(n)

    def cow_last_block(self, seq_id: int) -> Optional[Tuple[int, int]]:
        """If the sequence's last block is shared, give it a private
        copy; returns ``(src_block, dst_block)`` for the caller's device
        copy, or None when the block was already exclusive."""
        src = ctypes.c_int32()
        dst = ctypes.c_int32()
        rc = self._lib.kv_seq_cow_last(self._h, seq_id, ctypes.byref(src),
                                       ctypes.byref(dst))
        if rc < 0:
            raise MemoryError("cow failed (unknown seq or pool exhausted)")
        return (int(src.value), int(dst.value)) if rc == 1 else None

    def free(self, seq_id: int):
        self._lib.kv_seq_free(self._h, seq_id)

    # block-level operations: the prefix cache holds its own reference on
    # each retained block, independent of any live sequence
    def alloc_block(self) -> int:
        """Allocate one block outside any sequence (refcount 1)."""
        b = self._lib.kv_block_alloc(self._h)
        if b < 0:
            raise MemoryError(
                f"KV pool exhausted ({self.num_blocks} blocks)")
        return int(b)

    def ref_block(self, block: int) -> int:
        """Take one more reference on a live block; returns the new
        refcount.  Raises on a free or out-of-range block."""
        rc = self._lib.kv_block_ref(self._h, block)
        if rc < 0:
            raise ValueError(f"ref of free/out-of-range block {block}")
        return int(rc)

    def unref_block(self, block: int) -> int:
        """Drop one reference (the block is freed at zero); returns the
        new refcount.  Raises on a free or out-of-range block."""
        rc = self._lib.kv_block_unref(self._h, block)
        if rc < 0:
            raise ValueError(f"unref of free/out-of-range block {block}")
        return int(rc)

    def block_refcount(self, block: int) -> int:
        """The block's refcount (0 = free)."""
        rc = self._lib.kv_block_refcount(self._h, block)
        if rc < 0:
            raise ValueError(f"block {block} out of range")
        return int(rc)

    def assign(self, seq_id: int, blocks, num_tokens: int) -> int:
        """Make ``blocks`` (each ref'd once more) ``seq_id``'s table, its
        previous blocks released, and its length ``num_tokens``;
        ``reserve`` grows from there.  Raises, changing nothing, when a
        block is free or out of range."""
        blocks = [int(b) for b in blocks]
        arr = (ctypes.c_int32 * len(blocks))(*blocks)
        n = self._lib.kv_seq_assign(self._h, seq_id, arr, len(blocks),
                                    num_tokens)
        if n < 0:
            raise ValueError(f"assign with free/out-of-range block in "
                             f"{blocks}")
        return int(n)

    def close(self):
        if self._h:
            self._lib.kv_pool_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
