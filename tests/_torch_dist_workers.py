"""Worker functions for the port's multi-process tests.

A spawned child re-imports the module of the function it runs, so they
live here, in a module that imports nothing at its top: torch and the
port are imported inside each worker, the JAX package never.
"""
import json
import os


def mlp(state):
    """The reference's ``tests/dist_worker.py`` MLP (16 -> 32 -> 8, gelu)
    in the port, with the JAX model's weights."""
    import torch

    from paddle_infer_tpu_torch import nn as tnn
    from paddle_infer_tpu_torch.core.random import KeyStream
    from paddle_infer_tpu_torch.weights import from_jax_state_dict

    class MLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = tnn.Linear(16, 32, device="cpu")
            self.fc2 = tnn.Linear(32, 8, device="cpu")
            self.keys = KeyStream(0)

        def forward(self, x):
            return self.fc2(torch.nn.functional.gelu(self.fc1(x)))

    m = MLP()
    from_jax_state_dict(m, state)
    m.requires_grad_(True)
    return m


def mse(m, x, y):
    d = m(x) - y
    return (d * d).mean()


def train(model, batches, devices, local=None):
    """Three AdamW steps of the MLP at dp=8 through ``FleetTrainStep``;
    ``local`` slices each batch to this process's rows."""
    from paddle_infer_tpu_torch.optimizer import AdamW
    from paddle_infer_tpu_torch.parallel import (DistributedStrategy,
                                                 FleetTrainStep, fleet)

    st = DistributedStrategy()
    st.hybrid_configs = dict(st.hybrid_configs, dp_degree=8)
    hcg = fleet.init(strategy=st, devices=devices)
    step = FleetTrainStep(model, mse, AdamW(learning_rate=1e-2,
                                            parameters=model.parameters()),
                          strategy=st)
    losses = []
    for x, y in batches:
        if local is not None:
            x, y = x[local], y[local]
        losses.append(float(step(x, y).item()))
    return losses, hcg


def dp_train_worker(out_dir, state, batches, device="cpu"):
    """One of two processes: ``init_parallel_env`` over gloo, a local mesh
    of 4 devices, this process's half of every batch; writes its losses,
    its final parameters and what the process group reported."""
    import numpy as np
    import torch

    from paddle_infer_tpu_torch.distributed import (compat, env,
                                                    get_rank,
                                                    get_world_size)

    torch.set_num_threads(1)
    backend = env.init_parallel_env(backend="gloo")
    rank, world = get_rank(), get_world_size()
    model = mlp(state)
    if device != "cpu":
        model = model.to(device)
    local = slice(rank * 4, (rank + 1) * 4)
    losses, hcg = train(model, batches, [device] * 4, local=local)
    gathered = []
    compat.all_gather_object(gathered, {"rank": rank})
    params = {n: p.detach().cpu().numpy().tolist()
              for n, p in model.named_parameters()}
    with open(os.path.join(out_dir, f"proc{rank}.json"), "w") as f:
        json.dump({"losses": losses, "backend": backend, "world": world,
                   "dp_world": hcg.get_data_parallel_world_size(),
                   "dp_rank": hcg.get_data_parallel_rank(),
                   "local_dp": hcg.mesh.shape["dp"],
                   "gathered": gathered, "params": params}, f)
    env.shutdown()
    assert not np.isnan(losses).any()


def data_parallel_worker(out_dir, state, x, y):
    """``DataParallel.apply_collective_grads`` across two gloo processes:
    each process's gradient of its half batch, averaged."""
    import torch

    from paddle_infer_tpu_torch.distributed import DataParallel, env

    torch.set_num_threads(1)
    env.init_parallel_env(backend="gloo")
    rank = env.get_rank()
    model = DataParallel(mlp(state))
    loss = mse(model, torch.from_numpy(x[rank * 4:(rank + 1) * 4]),
               torch.from_numpy(y[rank * 4:(rank + 1) * 4]))
    loss.backward()
    model.apply_collective_grads()
    grads = {n: p.grad.numpy().tolist() for n, p in model.named_parameters()}
    with open(os.path.join(out_dir, f"grads{rank}.json"), "w") as f:
        json.dump(grads, f)
    env.shutdown()


def flaky_worker(state_dir):
    """Exits 101 (relaunch requested) on replica 1's first attempt, and
    succeeds after."""
    import sys

    replica = os.environ["PTI_REPLICA_ID"]
    attempt = int(os.environ["PTI_ATTEMPT"])
    with open(os.path.join(state_dir, f"r{replica}_a{attempt}_"
                           f"{os.getpid()}"), "w"):
        pass
    if replica == "1" and attempt == 1:
        sys.exit(101)


def suicide_worker(state_dir):
    """Dies by SIGKILL on replica 0's first attempt."""
    import signal

    replica = os.environ["PTI_REPLICA_ID"]
    attempt = int(os.environ["PTI_ATTEMPT"])
    with open(os.path.join(state_dir, f"r{replica}_a{attempt}"), "w"):
        pass
    if replica == "0" and attempt == 1:
        os.kill(os.getpid(), signal.SIGKILL)


def always_fail_worker():
    import sys

    sys.exit(3)


def noop_worker(state_dir):
    pass
