"""Distributed checkpoints that reshard on load.

Port of ``paddle_infer_tpu/distributed/checkpoint.py``, on the same
on-disk format, so a checkpoint written by either package loads in the
other: ``manifest.json`` with, per array, ``shape``, ``dtype`` (numpy
names, ``bfloat16`` included), ``spec`` (one entry per dim: an axis
name, a list of names or null) and ``chunks`` (``file``, ``starts``,
``shape``), plus one raw C-order ``.bin`` file per distinct shard
region, named ``<name>@<starts joined by _>.bin``.

The port's mesh holds each tensor whole on its device, so the shard
regions come from the recorded specs (``FleetTrainStep.param_specs`` /
``opt_specs``): a dim split over axes of total size ``s`` has ``s``
blocks, and every combination of blocks is one region, written once
(replicas share it).  Loading assembles each region of the new spec
from memory-mapped chunks (``_ChunkReader.region``) and copies it into
the whole tensor on the device; ``_restore_spec`` filters a saved spec
to the new mesh's axes, so a state saved at pp=2 x mp=2 resumes at
dp=8.  bfloat16 chunks are read and written as 16-bit words and viewed
as ``torch.bfloat16`` (the reference uses ``ml_dtypes``, which the port
does without).

In a job of several processes (``distributed.init_parallel_env``) each
process writes the regions it is primary for (process 0: every
process holds the replicated state) and a manifest fragment
``manifest.<rank>.json``; process 0 merges the fragments into
``manifest.json``.
"""
from __future__ import annotations

import itertools
import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

_MANIFEST = "manifest.json"

_TORCH_TO_NAME = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_NAME_TO_TORCH = {v: k for k, v in _TORCH_TO_NAME.items()}


def _file_dtype(name: str) -> np.dtype:
    """The numpy dtype of a chunk's words (bfloat16: 16-bit words)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _safe(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.\-]", "_", name)


def _axes(entry):
    if entry is None:
        return []
    return list(entry) if isinstance(entry, (list, tuple)) else [entry]


def _spec_list(spec, ndim) -> list:
    spec = list(spec or ())[:ndim]
    out = []
    for e in spec:
        axes = _axes(e)
        out.append(None if not axes else
                   axes[0] if len(axes) == 1 else list(axes))
    return out + [None] * (ndim - len(out))


def _blocks(mesh, spec, shape):
    """Per dim, the number of blocks the spec splits it into."""
    out = []
    for i, n in enumerate(shape):
        size = 1
        if mesh is not None and spec is not None and i < len(spec):
            for a in _axes(spec[i]):
                size *= mesh.shape.get(a, 1)
        if n % size:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"in {size} blocks (spec {spec})")
        out.append(size)
    return out


def _regions(mesh, spec, shape):
    """Every distinct shard region ``(starts, stops)`` of ``shape``
    under ``spec`` on ``mesh``."""
    nb = _blocks(mesh, spec, shape)
    sizes = [n // b for n, b in zip(shape, nb)]
    for combo in itertools.product(*[range(b) for b in nb]):
        starts = [c * s for c, s in zip(combo, sizes)]
        yield starts, [a + s for a, s in zip(starts, sizes)]


# ------------------------------------------------------------------- save

def _save_array(name, arr, dirpath, mesh, spec, primary) -> Dict[str, Any]:
    """Write ``arr``'s shard regions (if this process is primary for
    them); returns its manifest entry."""
    arr = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(arr)
    dname = _TORCH_TO_NAME[arr.dtype]
    meta = {"shape": list(arr.shape), "dtype": dname,
            "spec": _spec_list(spec, arr.dim()), "chunks": []}
    if not primary:
        return meta
    host = _to_numpy(arr)
    for starts, stops in _regions(mesh, spec, tuple(arr.shape)):
        key = "_".join(map(str, starts)) or "0"
        data = host[tuple(slice(a, b) for a, b in zip(starts, stops))]
        fname = f"{_safe(name)}@{key}.bin"
        np.ascontiguousarray(data).tofile(os.path.join(dirpath, fname))
        meta["chunks"].append({"file": fname, "starts": starts,
                               "shape": list(data.shape)})
    return meta


def save_distributed(state: Dict[str, Any], path: str,
                     extra: Optional[dict] = None, mesh=None,
                     specs: Optional[dict] = None) -> None:
    """Save a (one level nested) dict of tensors: per array its shard
    regions under ``specs[name]`` on ``mesh`` (one whole chunk without
    a spec) and the manifest.  A one-process save first clears the
    directory's earlier chunks; a multi-process one refuses a directory
    that holds a checkpoint."""
    from . import env

    os.makedirs(path, exist_ok=True)
    procs, pid = env.process_count(), env.process_index()
    if procs == 1:
        for f in os.listdir(path):
            if f.endswith(".bin") or f.startswith("manifest"):
                os.remove(os.path.join(path, f))
    elif os.path.exists(os.path.join(path, _MANIFEST)):
        raise ValueError(
            f"{path} already holds a checkpoint; multi-process saves "
            "cannot safely overwrite in place — use a fresh directory")
    arrays = {}
    for name, v in state.items():
        if isinstance(v, dict):
            for k, a in v.items():
                arrays[f"{name}/{k}"] = a
        else:
            arrays[name] = v
    specs = specs or {}
    manifest = {"arrays": {}, "extra": extra or {}}
    for name, arr in arrays.items():
        manifest["arrays"][name] = _save_array(
            name, arr, path, mesh if name in specs else None,
            specs.get(name), primary=pid == 0)
    if procs > 1:
        frag = os.path.join(path, f"manifest.{pid}.json")
        tmp = frag + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, frag)
        if pid == 0:
            _merge_fragments(path, manifest, procs)
    else:
        with open(os.path.join(path, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)


def _merge_fragments(path: str, base: dict, want: int) -> None:
    import glob as _glob
    import time

    deadline = time.time() + float(
        os.environ.get("PIT_CKPT_MERGE_TIMEOUT", "600"))
    while True:
        frags = sorted(f for f in _glob.glob(
            os.path.join(path, "manifest.*.json"))
            if not f.endswith(".tmp"))
        if len(frags) >= want:
            break
        if time.time() > deadline:
            raise TimeoutError(
                f"checkpoint merge: only {len(frags)}/{want} manifest "
                f"fragments appeared in {path} — a truncated manifest "
                "would corrupt the checkpoint, refusing to write it")
        time.sleep(0.5)
    merged = {n: dict(m, chunks=list(m["chunks"]))
              for n, m in base["arrays"].items()}
    for frag in frags:
        with open(frag) as f:
            other = json.load(f)
        for n, m in other["arrays"].items():
            entry = merged.setdefault(n, dict(m, chunks=[]))
            have = {c["file"] for c in entry["chunks"]}
            entry["chunks"].extend(c for c in m["chunks"]
                                   if c["file"] not in have)
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump({"arrays": merged, "extra": base["extra"]}, f, indent=1)


# ------------------------------------------------------------------- load

class _ChunkReader:
    def __init__(self, path: str, meta: dict):
        self.path = path
        self.meta = meta
        self.dtype = _file_dtype(meta["dtype"])
        self._mmaps: dict = {}

    def _mm(self, chunk):
        mm = self._mmaps.get(chunk["file"])
        if mm is None:
            shape = tuple(chunk["shape"])
            if int(np.prod(shape)) == 0:
                mm = np.empty(shape, self.dtype)
            else:
                mm = np.memmap(os.path.join(self.path, chunk["file"]),
                               dtype=self.dtype, mode="r", shape=shape)
            self._mmaps[chunk["file"]] = mm
        return mm

    def region(self, starts, stops) -> np.ndarray:
        """The half-open global region ``[starts, stops)`` assembled from
        the stored chunks."""
        shape = tuple(b - a for a, b in zip(starts, stops))
        out = np.empty(shape, self.dtype)
        filled = 0
        for c in self.meta["chunks"]:
            cs = c["starts"]
            ce = [s + n for s, n in zip(cs, c["shape"])]
            lo = [max(a, s) for a, s in zip(starts, cs)]
            hi = [min(b, e) for b, e in zip(stops, ce)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            src = tuple(slice(a - s, b - s) for a, s, b in zip(lo, cs, hi))
            dst = tuple(slice(a - s, b - s)
                        for a, s, b in zip(lo, starts, hi))
            out[dst] = self._mm(c)[src]
            filled += int(np.prod([b - a for a, b in zip(lo, hi)]))
        if filled < int(np.prod(shape)):
            raise ValueError(
                f"checkpoint chunks do not cover region {starts}..{stops} "
                "(incomplete multi-process checkpoint?)")
        return out


def _load_array(reader: _ChunkReader, mesh, spec, device, out=None):
    """The array whole on ``device`` (or copied into ``out``), each
    region of ``spec`` on ``mesh`` read from the chunks and copied in
    once."""
    name = reader.meta["dtype"]
    shape = tuple(reader.meta["shape"])
    if out is None:
        out = torch.empty(shape, dtype=_NAME_TO_TORCH[name], device=device)
    elif tuple(out.shape) != shape:
        raise ValueError(f"checkpoint shape {shape} != {tuple(out.shape)}")
    with torch.no_grad():
        for starts, stops in _regions(mesh, spec, shape):
            block = _from_numpy(reader.region(starts, stops), name)
            dst = out[tuple(slice(a, b) for a, b in zip(starts, stops))] \
                if shape else out
            dst.copy_(block.reshape(dst.shape).to(out.dtype),
                      non_blocking=False)
    return out


def load_distributed(path: str, mesh=None, specs: Optional[dict] = None,
                     device=None, into: Optional[dict] = None):
    """Load a checkpoint; returns ``(state, extra)``.  Without a mesh
    each array comes back whole (on ``device``, default the CPU).  With
    a mesh each array is assembled region by region under
    ``specs[name]`` (default: the saved spec filtered to the new mesh,
    ``_restore_spec``) onto ``device`` (default the mesh's controller):
    the resharding path.  ``into`` maps names to existing tensors that
    receive the values in place."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if device is None:
        device = mesh.controller if mesh is not None else torch.device("cpu")
    state: Dict[str, Any] = {}
    for name, meta in manifest["arrays"].items():
        reader = _ChunkReader(path, meta)
        spec = None
        if mesh is not None:
            if specs is not None and name in specs:
                spec = specs[name]
            else:
                spec = _restore_spec(meta.get("spec"), mesh,
                                     tuple(meta["shape"]))
        arr = _load_array(reader, mesh, spec, device,
                          out=(into or {}).get(name))
        if "/" in name:
            outer, inner = name.split("/", 1)
            state.setdefault(outer, {})[inner] = arr
        else:
            state[name] = arr
    return state, manifest.get("extra", {})


def _restore_spec(saved, mesh, shape) -> tuple:
    """The saved spec filtered to axes the new mesh has (size > 1) and
    dims they divide; anything else replicated."""
    if saved is None:
        return (None,) * len(shape)
    sizes = dict(mesh.shape)
    out = []
    for i, s in enumerate(saved):
        axes = s if isinstance(s, list) else ([s] if s else [])
        keep = [a for a in axes if sizes.get(a, 1) > 1]
        size = int(np.prod([sizes[a] for a in keep])) if keep else 1
        if keep and i < len(shape) and shape[i] % size == 0:
            out.append(tuple(keep) if len(keep) > 1 else keep[0])
        else:
            out.append(None)
    return tuple(out[:len(shape)]) + (None,) * (len(shape) - len(out))


# -------------------------------------------------- FleetTrainStep facade

def _ensure_opt_state(step):
    if step.opt_state is None:
        step.opt_state = step.optimizer.functional_init(step.params)
        step._record_slot_specs()


def save_train_state(step, path: str) -> None:
    """Checkpoint a ``FleetTrainStep``'s parameters and optimizer slots,
    each as the shard regions of its recorded spec on the step's mesh."""
    mesh = step.hcg.mesh
    state = {f"param/{n}": a for n, a in step.params.items()}
    specs = {f"param/{n}": step.param_specs[n] for n in step.params}
    if step.opt_state is not None:
        for n, slots in step.opt_state.items():
            for k, a in slots.items():
                state[f"opt/{n}/{k}"] = a
                specs[f"opt/{n}/{k}"] = step.opt_specs[n][k]
    save_distributed(state, path,
                     extra={"step_count": int(step._step_count)},
                     mesh=mesh, specs=specs)


def load_train_state(step, path: str) -> None:
    """Resume a ``FleetTrainStep`` from ``path`` onto its own mesh and
    specs, which may factorize differently from the saving step's.  The
    values are copied into the step's tensors in place, so its captured
    graphs stay valid."""
    _ensure_opt_state(step)
    mesh = step.hcg.mesh
    specs, into = {}, {}
    for n, p in step.params.items():
        specs[f"param/{n}"] = step.param_specs[n]
        into[f"param/{n}"] = p
    for n, slots in step.opt_state.items():
        for k, a in slots.items():
            specs[f"opt/{n}/{k}"] = step.opt_specs[n][k]
            into[f"opt/{n}/{k}"] = a
    with open(os.path.join(path, _MANIFEST)) as f:
        names = set(json.load(f)["arrays"])
    missing = [n for n in into if n.startswith("param/") and n not in names]
    if missing:
        raise KeyError(f"checkpoint missing params {missing[:4]}")
    into = {n: t for n, t in into.items() if n in names}
    _, extra = load_distributed(path, mesh=mesh, specs=specs,
                                device=step.device, into=into)
    step._step_count = int(extra.get("step_count", step._step_count))
    step.sync_params_to_model()


__all__ = ["save_distributed", "load_distributed", "save_train_state",
           "load_train_state"]
