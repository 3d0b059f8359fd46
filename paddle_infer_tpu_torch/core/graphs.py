"""One CUDA graph per program key.

The JAX package compiles each serving program once per deployment key
and the whole train step once per batch signature; after warm-up no
step compiles again.  The port's counterpart on the card is a CUDA
graph: ``ProgramCache.run`` runs a key's first call eagerly on a side
stream (the call's own execution doubles as the warm-up that
``torch.cuda.graph`` requires, and initialises every kernel's lazy
statics), captures the same call into a graph, and replays the graph on
every later call with the same argument signature.  Each capture is
recorded in the compile log (``observability/compilelog.py``) with the
wall time of the call that made it.

A graph bakes in the addresses of everything it touches.  Its static
inputs are the ``StagedInputs`` device tensors it was given, which the
owner rewrites before each replay, and its own copies of every other
tensor argument, into which each replay copies that call's tensors: a
caller's tensor is never written.  Whatever the program reads besides
its arguments (parameters, KV pools, optimizer state) must stay where
it was, and its owner calls ``ProgramCache.clear()`` when it moves.

The CPU runs every program eagerly, as does the card inside
``disable_graphs()`` (the counterpart of ``jax.disable_jit``): there the
log records the first execution of each new argument signature, which is
exactly the event the JAX log counts.  A failed capture or replay raises;
nothing falls back to eager on its own.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref

import numpy as np
import torch

from ..observability.compilelog import (get_compile_log,
                                        instrument_first_calls,
                                        signature_of)
from ..ops import _build

_lock = threading.Lock()
_disabled = 0
# id -> device tensor of a live StagedInputs: a graph keeps these as its
# static inputs and clones every other argument
_staged = weakref.WeakValueDictionary()


@contextlib.contextmanager
def disable_graphs():
    """Run every program eagerly while open (process-wide, nestable) —
    on the card the only way to skip the graphs."""
    global _disabled
    with _lock:
        _disabled += 1
    try:
        yield
    finally:
        with _lock:
            _disabled -= 1


def graphs_enabled(device) -> bool:
    """True on a CUDA device outside ``disable_graphs()``."""
    return torch.device(device).type == "cuda" and _disabled == 0


def _flat_tensors(tree, out=None):
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _flat_tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flat_tensors(v, out)
    return out


def _is_staged(t) -> bool:
    return _staged.get(id(t)) is t


def _with_tensors(tree, it):
    """``tree`` with its tensors replaced, in ``_flat_tensors`` order, by
    the items of ``it``."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _with_tensors(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_tensors(v, it) for v in tree)
    return tree


class StagedInputs:
    """A program's per-step host inputs in one buffer, moved by one copy.

    ``fields`` is a sequence of ``(name, shape, numpy dtype)``.  The
    caller fills ``begin()``'s numpy arrays in place each step — on the
    card they lie in one pinned buffer — and ``upload()`` returns the
    device tensors after one non-blocking copy of the whole buffer into
    a device buffer of the same layout.  The device tensors are the
    same objects every step, so a graph captured on them reads each
    step's values.  On the CPU the device tensors are the host arrays
    themselves and nothing is copied."""

    def __init__(self, fields, device):
        device = torch.device(device)
        layout, size = [], 0
        for name, shape, dtype in fields:
            dtype = np.dtype(dtype)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            layout.append((name, tuple(shape), dtype, size, nbytes))
            size += -(-nbytes // 16) * 16          # 16-byte aligned fields
        cuda = device.type == "cuda"
        self._host = torch.zeros(max(size, 16), dtype=torch.uint8,
                                 pin_memory=cuda)
        raw = self._host.numpy()
        self.host = {n: raw[o:o + nb].view(dt).reshape(shape)
                     for n, shape, dt, o, nb in layout}
        self._dev = None
        self._copied = None
        if cuda:
            self._dev = torch.zeros_like(self._host, device=device)
            self.device = {
                n: self._dev[o:o + nb].view(
                    torch.from_numpy(np.empty(0, dt)).dtype).view(shape)
                for n, shape, dt, o, nb in layout}
            for t in self.device.values():
                _staged[id(t)] = t
        else:
            self.device = {n: torch.from_numpy(a)
                           for n, a in self.host.items()}

    def begin(self) -> dict:
        """The host arrays, zeroed, once the previous step's copy has
        left them."""
        if self._copied is not None:
            self._copied.synchronize()
        self._host.numpy().fill(0)
        return self.host

    def upload(self) -> dict:
        """One non-blocking copy of every field to the device (on the
        current stream); returns the device tensors."""
        if self._dev is not None:
            self._dev.copy_(self._host, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()
        return self.device


class _Graph:
    """A captured graph with its static inputs, outputs and launch
    tally."""

    def __init__(self, graph, inputs, outputs, tally):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.tally = tally

    def replay(self, args):
        for static, a in zip(self.inputs, _flat_tensors(args)):
            if a is static:
                continue
            if _is_staged(static):
                raise ValueError("a graph's staged input was replaced by "
                                 "another tensor; pass the same "
                                 "StagedInputs tensors every call")
            static.copy_(a, non_blocking=True)
        self.graph.replay()
        _build.add_launches(self.tally)
        return self.outputs


def _capture(fn, args, site, key, sig):
    """Run ``fn(*args)`` eagerly on a side stream (this call's result and
    the warm-up), then capture it into a graph on its static inputs (the
    staged tensors and clones of the rest); record the call."""
    t0 = time.perf_counter()
    inputs = [a if _is_staged(a) else a.clone()
              for a in _flat_tensors(args)]
    static_args = _with_tensors(args, iter(inputs))
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn(*args)
    cur.wait_stream(side)
    for t in _flat_tensors(out):
        t.record_stream(cur)
    graph = torch.cuda.CUDAGraph()
    with _build.capture_launches() as tally:
        with torch.cuda.graph(graph):
            static_out = fn(*static_args)
    wall = time.perf_counter() - t0
    get_compile_log().record(site, key, sig, wall)
    return out, _Graph(graph, inputs, static_out, dict(tally))


class ProgramCache:
    """The programs of one owner (an engine, a train step).

    ``run(site, key, make_fn, args, device)`` builds ``make_fn()`` once
    per ``key``; then, on the CPU or inside ``disable_graphs()``, calls
    it eagerly (the log records each new argument signature's first
    call), and otherwise replays the graph of ``(key, signature)``,
    capturing it on the first call.  A replay returns the graph's static
    outputs: the caller reads them before the next call."""

    def __init__(self):
        self._fns = {}
        self._graphs = {}

    def clear(self):
        """Drop every graph (an address it baked in has moved)."""
        self._graphs.clear()

    def run(self, site, key, make_fn, args, device):
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = instrument_first_calls(make_fn(), site,
                                                         key)
        if not graphs_enabled(device):
            return fn(*args)
        sig = signature_of(args)
        g = self._graphs.get((key, sig))
        if g is None:
            out, self._graphs[(key, sig)] = _capture(fn.__wrapped__, args,
                                                     site, key, sig)
            return out
        return g.replay(args)
