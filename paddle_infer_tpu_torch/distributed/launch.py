"""Launching a job's processes.

Port of ``paddle_infer_tpu/distributed/launch.py``: ``spawn`` starts
``nprocs`` worker processes with the rendezvous variables that
``distributed/env.py::init_parallel_env`` reads, and ``main`` is the
``python -m paddle_infer_tpu_torch.distributed.launch`` command line.

Workers start from the ``spawn`` context, always: a child forked after
the parent has touched CUDA cannot use the card.  A spawned child
re-imports the module of the function it runs, so that function lives
at a module's top level.  A worker that exits non-zero makes ``spawn``
(with ``join=True``) raise with every failed exit code, as in the
reference.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import runpy
import sys


def _worker(fn, args, env, rank, local_rank):
    os.environ.update(env)
    os.environ["PTI_PROCESS_ID"] = str(rank)
    os.environ["PTI_LOCAL_RANK"] = str(local_rank)
    fn(*args)


def spawn(func, args=(), nprocs: int = 1, join: bool = True,
          coordinator_port: int = 12355, coordinator_addr=None,
          world_size=None, base_rank: int = 0, **options):
    """Run ``func(*args)`` in ``nprocs`` processes (one process runs it
    here, unless a multi-node rendezvous is given).  Multi-node jobs pass
    ``coordinator_addr`` (the shared rendezvous), ``world_size`` (nodes x
    processes per node) and ``base_rank`` (this node's first rank).
    Returns the processes."""
    if nprocs == 1 and coordinator_addr is None:
        func(*args)
        return None
    ctx = mp.get_context("spawn")
    env = {
        "PTI_COORDINATOR_ADDR": coordinator_addr
        or f"127.0.0.1:{coordinator_port}",
        "PTI_NUM_PROCESSES": str(world_size or nprocs),
        "PTI_LOCAL_WORLD_SIZE": str(nprocs),
    }
    procs = []
    for i in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(func, args, env, base_rank + i, i))
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode]
        if bad:
            raise RuntimeError(f"spawned workers failed: exit codes {bad}")
    return procs


def main(argv=None):
    """The command line::

      python -m paddle_infer_tpu_torch.distributed.launch \\
          [--nproc_per_node N] [--master HOST:PORT] [--nnodes N] \\
          [--rank R] [--job_id ID] script.py [args...]

    ``--nproc_per_node`` > 1 spawns this node's workers with ranks
    ``[rank * N, (rank + 1) * N)`` of ``nnodes * N``; with one process
    per node, ``--master / --nnodes / --rank`` are exported for
    ``init_parallel_env`` and the script runs here."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m paddle_infer_tpu_torch.distributed.launch")
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument("--master", type=str, default=None,
                        help="rendezvous HOST:PORT (multi-node)")
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--rank", type=int, default=0,
                        help="this node's rank")
    parser.add_argument("--job_id", type=str, default="default")
    parser.add_argument("--devices", type=str, default=None,
                        help="accepted for the reference's command line; "
                        "a rank's card is its local rank")
    parser.add_argument("training_script")
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))

    os.environ["PTI_JOB_ID"] = args.job_id
    if args.nproc_per_node > 1:
        spawn(_run_script,
              (args.training_script, list(args.training_script_args)),
              nprocs=args.nproc_per_node,
              coordinator_addr=args.master,
              world_size=args.nnodes * args.nproc_per_node,
              base_rank=args.rank * args.nproc_per_node)
    else:
        if args.master:
            os.environ["PTI_COORDINATOR_ADDR"] = args.master
            os.environ["PTI_NUM_PROCESSES"] = str(args.nnodes)
            os.environ["PTI_PROCESS_ID"] = str(args.rank)
        _run_script(args.training_script,
                    list(args.training_script_args))
    return 0


def _run_script(script, script_args):
    """At module level, so a spawned child can unpickle it."""
    sys.argv = [script] + list(script_args)
    runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    sys.exit(main())
