"""ctypes bindings to the paged-KV block allocator
(``native/kv_allocator.cc``) and the multi-slot data feed
(``native/datafeed.cc``).

Port of ``paddle_infer_tpu/native/__init__.py``'s ``KVBlockPool`` (with
the block-level operations the prefix cache uses) and
``MultiSlotDataFeed`` (the parameter server's slot datasets,
``distributed/compat.py``).  The C++ sources are shared with the JAX
package and read as they are; this module compiles each alone (they
need only the C++ standard library) with ``g++ -O3 -fPIC -shared
-std=c++17`` into the port's git-ignored build directory at first use,
so a clean checkout builds everything from the repository's sources.
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
_FEED_SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native",
                            "datafeed.cc")
_FEED_LIB_PATH = os.path.join(BUILD_DIR, "libdatafeed.so")

_lock = threading.Lock()
_lib = None


def build(source: str = _SOURCE, lib_path: str = _LIB_PATH) -> str:
    """Compile ``source`` (default: the allocator) if its library is
    missing or older than it; returns the library path.  The compiler
    writes to a temporary name that is renamed into place, so concurrent
    processes (test workers) never load a half-written file."""
    if (os.path.exists(lib_path)
            and os.path.getmtime(lib_path) >= os.path.getmtime(source)):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                        "-pthread", "-o", tmp, source],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, lib_path)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building {source} failed:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


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


# ------------------------------------------------------------ data feed
_feed_lib = None


def _load_feed():
    global _feed_lib
    with _lock:
        if _feed_lib is not None:
            return _feed_lib
        lib = ctypes.CDLL(build(_FEED_SOURCE, _FEED_LIB_PATH))
        c = ctypes
        sigs = {
            "datafeed_create": ([c.POINTER(c.c_char_p), c.c_int32,
                                 c.POINTER(c.c_uint8), c.c_int32, c.c_int32,
                                 c.c_int32, c.c_int32, c.c_uint64,
                                 c.POINTER(c.c_int32)], c.c_void_p),
            "datafeed_destroy": ([c.c_void_p], None),
            "datafeed_size": ([c.c_void_p], c.c_int64),
            "datafeed_reset": ([c.c_void_p, c.c_uint64], None),
            "datafeed_next": ([c.c_void_p], c.c_int32),
            "datafeed_slot_len": ([c.c_void_p, c.c_int32], c.c_int64),
            "datafeed_slot_float": ([c.c_void_p, c.c_int32],
                                    c.POINTER(c.c_float)),
            "datafeed_slot_int": ([c.c_void_p, c.c_int32],
                                  c.POINTER(c.c_int64)),
            "datafeed_slot_lod": ([c.c_void_p, c.c_int32],
                                  c.POINTER(c.c_int64)),
            "datafeed_slot_lod_len": ([c.c_void_p, c.c_int32], c.c_int64),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _feed_lib = lib
        return lib


class MultiSlotDataFeed:
    """Threaded multi-slot text reader (the reference's
    ``MultiSlotDataFeed``): each line holds one ``<n> v1 ... vn`` group
    per slot.  ``slots`` is a list of ``(name, kind)``, kind ``"float"``
    (dense values) or ``"int"`` (int64 ids); iterating yields dicts
    ``name -> (values ndarray, lod ndarray[batch + 1])``."""

    def __init__(self, files, slots, batch_size: int = 32,
                 num_threads: int = 4, shuffle: bool = False, seed: int = 0):
        lib = _load_feed()
        self._lib = lib
        self._slots = list(slots)
        self._epoch = 0
        self._seed = seed
        self._iterating = False
        arr = (ctypes.c_char_p * len(files))(
            *[os.fsencode(f) for f in files])
        flags = (ctypes.c_uint8 * len(slots))(
            *[1 if kind == "float" else 0 for _, kind in slots])
        err = ctypes.c_int32(0)
        self._h = lib.datafeed_create(arr, len(files), flags, len(slots),
                                      batch_size, num_threads,
                                      1 if shuffle else 0, seed,
                                      ctypes.byref(err))
        if not self._h:
            if err.value == 1:
                raise FileNotFoundError(
                    f"datafeed: cannot open one of {list(files)}")
            raise ValueError("datafeed: malformed slot record")

    def __len__(self):
        return int(self._lib.datafeed_size(self._h))

    def __iter__(self):
        # one cursor per feed: two live iterators would interleave
        if self._iterating:
            raise RuntimeError(
                "MultiSlotDataFeed supports one live iterator at a time; "
                "finish (or discard) the previous epoch's iterator first")
        self._iterating = True
        try:
            self._lib.datafeed_reset(self._h, self._seed + self._epoch)
            self._epoch += 1
            while True:
                if self._lib.datafeed_next(self._h) <= 0:
                    return
                out = {}
                for i, (name, kind) in enumerate(self._slots):
                    ln = self._lib.datafeed_slot_len(self._h, i)
                    if kind == "float":
                        ptr = self._lib.datafeed_slot_float(self._h, i)
                        vals = np.ctypeslib.as_array(ptr, (ln,)).copy() \
                            if ln else np.empty((0,), np.float32)
                    else:
                        ptr = self._lib.datafeed_slot_int(self._h, i)
                        vals = np.ctypeslib.as_array(ptr, (ln,)).copy() \
                            if ln else np.empty((0,), np.int64)
                    lod_len = self._lib.datafeed_slot_lod_len(self._h, i)
                    lod_ptr = self._lib.datafeed_slot_lod(self._h, i)
                    lod = np.ctypeslib.as_array(lod_ptr, (lod_len,)).copy()
                    out[name] = (vals, lod)
                yield out
        finally:
            self._iterating = False

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and getattr(self, "_lib", None) is not None:
            self._lib.datafeed_destroy(h)
            self._h = None
