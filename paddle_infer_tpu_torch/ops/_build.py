"""Build and bind the port's hand-written CUDA kernels.

Route (b) of the Hopper guide: each ``csrc/*.cu`` source is compiled by
``nvcc`` alone into a shared library with a plain C interface, at first
use, into the git-ignored ``_build/`` directory of the package, and
loaded with ctypes (``c_void_p`` for every pointer and the stream).
Every ``nvcc`` process starts at once: one per translation unit of
every source (the same file compiled with each of its ``PARTS``' macros
into an object), whose objects are then linked into the source's
library.  ``BUILD_TIMES`` holds each process's wall seconds.  Nothing
here runs at import: the CPU tests import every module on a machine
with no ``nvcc`` and no card.

Each C entry point launches on PyTorch's current stream, allocates
nothing and returns ``cudaGetLastError()``; ``CudaKernel.__call__``
raises on a non-zero code and otherwise counts the launch.  A launch
made while a CUDA graph is being captured runs nothing yet: it counts
into the capture's tally (``capture_launches``) instead, and each replay
of that graph adds the tally (``add_launches``), so a kernel's count
stays the number of times it ran.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List

import torch

from ..native import BUILD_DIR

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# each source's translation units: (part name, macros);
# flash_attention.cu holds three kernel families in three dtypes, one
# unit each, and a unit with its C entry points; paged_attention.cu one
# unit per entry point, the ragged kernels split by query dtype
PARTS = {
    "flash_attention.cu": [
        (f"{kind}_{dt}", [f"-DPIT_FLASH_KIND={k}", f"-DPIT_FLASH_DTYPE={d}"])
        for k, kind in enumerate(("fwd", "dkdv", "dq"))
        for d, dt in enumerate(("f32", "bf16", "f16"))] + [
        ("entry", ["-DPIT_FLASH_ENTRY"])],
    "paged_attention.cu": [
        (name, [f"-DPIT_PAGED_PART={i}"])
        for i, name in enumerate(("decode", "verify", "ragged_f32",
                                  "ragged_bf16", "ragged_f16"))]}

_lock = threading.Lock()
# launch counts move under their own lock: a fleet's replicas launch and
# replay from threads of their own, and ``+=`` on an attribute is not
# atomic
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report per source, from the last build
BUILD_LOG: Dict[str, str] = {}
# wall seconds of each nvcc process of the last build, by source (and
# ``source:part`` for a unit, ``source:link`` for its link)
BUILD_TIMES: Dict[str, float] = {}
# the launch tally of the graph being captured, if any: process-wide,
# since a captured backward launches from autograd's device thread
_tally = None


def require_cuda():
    """The kernel route's first step: without a card, raise — a wrapper
    handed a CUDA tensor never falls back to its plain version."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA kernel launch requested but no CUDA "
                           "device is available")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _lib_path(source: str) -> str:
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}.so")


def _run(key, cmd, out):
    """Run one nvcc command; ``out[key] = (returncode, log, seconds)``."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    out[key] = (proc.returncode, proc.stdout,
                time.perf_counter() - t0)


def _parallel(cmds):
    """Run ``{key: cmd}`` all at once; returns ``{key: (rc, log, s)}``."""
    out = {}
    threads = [threading.Thread(target=_run, args=(k, c, out))
               for k, c in cmds.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def build(sources: List[str]) -> float:
    """Compile every stale source, every unit of each at once, and link
    each source's units into its library; returns wall seconds."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs, cmds = [], {}
    for src in sources:
        path = os.path.join(_CSRC, src)
        out = _lib_path(src)
        if (os.path.exists(out)
                and os.path.getmtime(out) >= os.path.getmtime(path)):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        objs = []
        for name, macros in PARTS[src]:
            obj = f"{tmp}.{name}.o"
            objs.append(obj)
            cmds[f"{src}:{name}"] = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS,
                                     *macros, "-c", "-o", obj, path]
        jobs.append((src, tmp, out, objs))
    done = _parallel(cmds)
    errors = []
    links = {}
    for src, tmp, out, objs in jobs:
        keys = [k for k in done if k.startswith(src + ":")]
        BUILD_LOG[src] = "".join(done[k][1] for k in keys)
        for k in keys:
            BUILD_TIMES[k] = done[k][2]
        bad = [k for k in keys if done[k][0] != 0]
        if bad:
            errors.append(f"nvcc {bad} failed:\n{BUILD_LOG[src]}")
        else:
            links[src + ":link"] = [_nvcc(), *ARCH_FLAGS, "-shared", "-o",
                                    tmp, *objs]
    linked = _parallel(links)
    for k, (rc, log, secs) in linked.items():
        BUILD_TIMES[k] = secs
        if rc != 0:
            errors.append(f"nvcc link {k} failed:\n{log}")
    for src, tmp, out, objs in jobs:
        if not errors:
            os.replace(tmp, out)
        elif os.path.exists(tmp):
            os.unlink(tmp)
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(_lib_path(source))
            lib.pit_cuda_error_string.argtypes = [ctypes.c_int]
            lib.pit_cuda_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


class CudaKernel:
    """One C entry point of a ``csrc`` source plus its launch counter.

    ``launches`` goes up by one per successful launch and nowhere else
    (a launch recorded into a CUDA graph counts once per replay), so a
    run can show which kernels its path went through."""

    def __init__(self, name: str, source: str, symbol: str, argtypes,
                 replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args):
        require_cuda()
        rc = self._bind()(*args)
        if rc != 0:
            msg = load(self.source).pit_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc} ({msg})")
        if _tally is None:
            with _count_lock:
                self.launches += 1
        else:
            _tally[self] = _tally.get(self, 0) + 1


@contextlib.contextmanager
def capture_launches():
    """While open, launches are being recorded into a CUDA graph (a
    capture holds the card to itself): they count into the yielded
    ``{kernel: launches}`` tally, not into ``launches``."""
    global _tally
    prev, _tally = _tally, {}
    try:
        yield _tally
    finally:
        _tally = prev


def add_launches(tally: Dict["CudaKernel", int]):
    """One replay of a graph whose capture recorded ``tally``."""
    with _count_lock:
        for kernel, n in tally.items():
            kernel.launches += n


# every kernel of the port, by name (chip_smoke.py enumerates these)
KERNELS: Dict[str, CudaKernel] = {}


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS[kernel.name] = kernel
    return kernel


def sources() -> List[str]:
    """Every CUDA source of the port (``csrc/*.cu``)."""
    return sorted(f for f in os.listdir(_CSRC) if f.endswith(".cu"))


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
