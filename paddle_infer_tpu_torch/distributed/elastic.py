"""Elastic fault tolerance: membership, restart policy and relaunch.

Port of ``paddle_infer_tpu/distributed/elastic.py`` (the reference's
``ElasticManager``: level 1 restarts failed workers, level 2 resizes
within ``[min_np, max_np]``).  Membership rides a ``FileStore``, a
shared directory of per-node heartbeat files; the manager watches the
heartbeats and decides restart or resize; ``ElasticLauncher`` starts the
workers and relaunches one that exits non-zero (or with
``ELASTIC_AUTO_PARALLEL_EXIT_CODE``) as a fresh process.

Start method: the reference forks its workers.  A child forked from a
process that holds a CUDA context cannot use the card, so the port's
default is ``"fork"`` only while CUDA is not initialised in the parent
and ``"spawn"`` once it is; an explicit ``start_method="fork"`` in a
parent with CUDA initialised raises.  A CUDA parent is never forked.
Under ``"spawn"`` the worker function must be importable (module level).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

ELASTIC_TIMEOUT = 30.0
ELASTIC_LEVEL_FAULT_TOLERANCE = 1
ELASTIC_LEVEL_ELASTIC = 2

# reference manager.py ELASTIC_AUTO_PARALLEL_EXIT_CODE — a worker exiting
# with this code requests a relaunch rather than a job failure
ELASTIC_AUTO_PARALLEL_EXIT_CODE = 101


class FileStore:
    """Heartbeat registry over a shared directory."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def heartbeat(self, node_id: str, info: Optional[dict] = None):
        p = os.path.join(self.path, f"{node_id}.hb")
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"ts": time.time(), "info": info or {}}, f)
        os.replace(tmp, p)

    def nodes(self, timeout: float) -> Dict[str, dict]:
        """Live nodes: heartbeat newer than ``timeout`` seconds."""
        now = time.time()
        out = {}
        for fn in os.listdir(self.path):
            if not fn.endswith(".hb"):
                continue
            try:
                with open(os.path.join(self.path, fn)) as f:
                    rec = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if now - rec.get("ts", 0) <= timeout:
                out[fn[:-3]] = rec
        return out

    def leave(self, node_id: str):
        try:
            os.remove(os.path.join(self.path, f"{node_id}.hb"))
        except FileNotFoundError:
            pass


class ElasticManager:
    """Watches membership; decides healthy/restart/resize (reference
    manager.py: levels at :173-184, watch loop relaunching at :100-115).

    ``np`` spec "min:max" (or int) sets the elastic range; the manager is
    level 2 (elastic) when min != max, level 1 otherwise.
    """

    def __init__(self, node_id: str, np_spec, store: FileStore,
                 timeout: float = ELASTIC_TIMEOUT,
                 on_change: Optional[Callable[[List[str]], None]] = None):
        if isinstance(np_spec, int):
            self.min_np = self.max_np = np_spec
        else:
            parts = str(np_spec).split(":")
            self.min_np = int(parts[0])
            self.max_np = int(parts[-1])
        self.level = (ELASTIC_LEVEL_ELASTIC
                      if self.min_np != self.max_np
                      else ELASTIC_LEVEL_FAULT_TOLERANCE)
        self.node_id = node_id
        self.store = store
        self.timeout = timeout
        self.on_change = on_change
        self._last_set: Optional[List[str]] = None

    # -------------------------------------------------------------- state
    def register(self, info: Optional[dict] = None):
        self.store.heartbeat(self.node_id, info)

    def exit(self):
        self.store.leave(self.node_id)

    def current_nodes(self) -> List[str]:
        return sorted(self.store.nodes(self.timeout))

    def healthy(self) -> bool:
        """Enough live nodes to run (reference: np within [min, max])."""
        n = len(self.current_nodes())
        return self.min_np <= n <= self.max_np

    # -------------------------------------------------------------- watch
    def poll(self) -> Optional[List[str]]:
        """One watch step: heartbeat self, detect membership change.
        Returns the new node list when it changed (and fires on_change),
        else None."""
        self.register()
        nodes = self.current_nodes()
        if self._last_set is None:
            self._last_set = nodes
            return None
        if nodes != self._last_set:
            self._last_set = nodes
            if self.on_change is not None:
                self.on_change(nodes)
            return nodes
        return None

    def should_restart(self, exit_code: int) -> bool:
        """Reference watcher semantics: nonzero exits restart under fault
        tolerance; the auto-parallel exit code always requests relaunch."""
        if exit_code == ELASTIC_AUTO_PARALLEL_EXIT_CODE:
            return True
        return exit_code != 0 and self.healthy()


def resolve_start_method(method: Optional[str] = None) -> str:
    """``method``, or the default (see the module docstring); raises on
    ``"fork"`` once this process has initialised CUDA."""
    import torch

    cuda = torch.cuda.is_initialized()
    if method is None:
        return "spawn" if cuda else "fork"
    if method == "fork" and cuda:
        raise RuntimeError(
            "start_method='fork' in a process that has initialised CUDA: "
            "a forked child cannot use the card; use 'spawn'")
    return method


def _elastic_entry(func, args, replica, attempt):
    # module level, so a spawned child can unpickle it
    os.environ["PTI_REPLICA_ID"] = str(replica)
    os.environ["PTI_ATTEMPT"] = str(attempt)
    func(*args)


class ElasticLauncher:
    """Start, watch and relaunch worker processes (the reference's
    launch watcher).

    ``run(func, args)`` starts ``nprocs`` worker processes, heartbeats the
    store, and on a worker death applies ``ElasticManager.should_restart``:
    nonzero exits (and the auto-parallel exit code) get the worker process
    actually re-executed — a fresh OS process, new pid — up to
    ``max_restarts`` times; exit 0 marks the replica done.
    """

    def __init__(self, nprocs: int, np_spec=None, store: Optional[FileStore]
                 = None, node_id: str = "node0", max_restarts: int = 3,
                 start_method: Optional[str] = None,
                 poll_interval: float = 0.05,
                 timeout: float = ELASTIC_TIMEOUT):
        import tempfile

        self.nprocs = nprocs
        self.max_restarts = max_restarts
        self.poll_interval = poll_interval
        self.start_method = start_method
        store = store or FileStore(tempfile.mkdtemp(prefix="pit_elastic_"))
        # membership is per NODE (this launcher heartbeats as one node);
        # nprocs is the per-node worker count, not the np spec
        self.manager = ElasticManager(node_id, np_spec or 1, store,
                                      timeout=timeout)

    def _start(self, ctx, func, args, replica, attempt):
        p = ctx.Process(target=_elastic_entry,
                        args=(func, args, replica, attempt), daemon=True)
        p.start()
        return p

    def run(self, func, args=()):
        """Returns {"restarts", "attempts" (per replica), "pids" (history
        per replica)}; raises if a replica exhausts max_restarts or exits
        unrestartably."""
        import multiprocessing as mp

        ctx = mp.get_context(resolve_start_method(self.start_method))
        self.manager.register()
        procs = {i: self._start(ctx, func, args, i, 1)
                 for i in range(self.nprocs)}
        attempts = {i: 1 for i in range(self.nprocs)}
        pids = {i: [procs[i].pid] for i in range(self.nprocs)}
        done = set()
        restarts = 0
        try:
            while len(done) < self.nprocs:
                self.manager.poll()
                for i, p in list(procs.items()):
                    if i in done or p.is_alive():
                        continue
                    code = p.exitcode
                    # killed-by-signal exitcodes are negative (reference
                    # watcher treats them as failures too)
                    if code == 0:
                        done.add(i)
                        continue
                    if (self.manager.should_restart(code if code >= 0
                                                    else 1)
                            and attempts[i] <= self.max_restarts):
                        attempts[i] += 1
                        restarts += 1
                        procs[i] = self._start(ctx, func, args, i,
                                               attempts[i])
                        pids[i].append(procs[i].pid)
                    else:
                        raise RuntimeError(
                            f"replica {i} failed (exit {code}) after "
                            f"{attempts[i]} attempts")
                time.sleep(self.poll_interval)
        finally:
            for p in procs.values():
                if p.is_alive():
                    p.terminate()
            self.manager.exit()
        return {"restarts": restarts, "attempts": attempts, "pids": pids}


__all__ = ["ElasticManager", "ElasticLauncher", "FileStore",
           "ELASTIC_AUTO_PARALLEL_EXIT_CODE",
           "ELASTIC_LEVEL_FAULT_TOLERANCE", "ELASTIC_LEVEL_ELASTIC"]
