"""Port parity: processes.  ``launch.spawn`` of two gloo CPU processes
training the reference's MLP job at dp=8 (two processes of four local
devices, each feeding its half of every batch) equals one process over
eight devices and the JAX package's own single-process run
(``tests/dist_worker.py``), as ``tests/test_multiprocess.py`` holds
JAX's; ``DataParallel`` across processes; the backend choice; elastic
membership, restart policy and relaunch (``tests/test_aux.py``'s cases);
the launch command line.
"""
import json
import os
import socket
import sys

import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from paddle_infer_tpu_torch.distributed import env, launch
from paddle_infer_tpu_torch.parallel import fleet, topology

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _reset():
    yield
    from paddle_infer_tpu.parallel import fleet as jfleet
    from paddle_infer_tpu.parallel import topology as jtopo

    jtopo.set_current_mesh(None)
    jfleet._state.initialized = False
    jfleet._state.hcg = jfleet._state.strategy = None
    jtopo._CURRENT_HCG = None
    topology.set_hybrid_communicate_group(None)
    fleet._state.hcg = fleet._state.strategy = fleet._state.device = None


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job():
    """The JAX MLP's weights and batches (``dist_worker._model_and_data``)
    and the JAX single-process losses over eight devices."""
    import jax

    sys.path.insert(0, TESTS)
    import dist_worker

    model, batches = dist_worker._model_and_data()
    state = {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}
    jax_losses = dist_worker._train(model, batches)
    assert len(jax.devices()) >= 8
    return state, batches, jax_losses


def test_two_gloo_processes_equal_one_process_and_jax(job, tmp_path):
    state, batches, jax_losses = job
    out = str(tmp_path)
    launch.spawn(W.dp_train_worker, (out, state, batches), nprocs=2,
                 coordinator_port=_free_port())
    res = []
    for r in (0, 1):
        with open(os.path.join(out, f"proc{r}.json")) as f:
            res.append(json.load(f))
    for r, got in enumerate(res):
        assert got["backend"] == "gloo" and got["world"] == 2
        assert got["dp_world"] == 8 and got["local_dp"] == 4
        assert got["dp_rank"] == 4 * r
        assert got["gathered"] == [{"rank": 0}, {"rank": 1}]
    # every rank sees the same loss and holds the same parameters, bits
    assert res[0]["losses"] == res[1]["losses"]
    assert res[0]["params"] == res[1]["params"]
    single, _ = W.train(W.mlp(state), batches, ["cpu"] * 8)
    np.testing.assert_allclose(res[0]["losses"], single, rtol=1e-5)
    np.testing.assert_allclose(res[0]["losses"], jax_losses, rtol=1e-5)


def test_data_parallel_averages_gradients_across_processes(job, tmp_path):
    state, batches, _ = job
    x, y = batches[0]
    out = str(tmp_path)
    launch.spawn(W.data_parallel_worker, (out, state, x, y), nprocs=2,
                 coordinator_port=_free_port())
    g = []
    for r in (0, 1):
        with open(os.path.join(out, f"grads{r}.json")) as f:
            g.append({n: np.asarray(v) for n, v in json.load(f).items()})
    m = W.mlp(state)
    W.mse(m, torch.from_numpy(x), torch.from_numpy(y)).backward()
    for n, p in m.named_parameters():
        np.testing.assert_array_equal(g[0][n], g[1][n])
        np.testing.assert_allclose(g[0][n], p.grad.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_data_parallel_on_one_controller_keeps_whole_grads(job):
    from paddle_infer_tpu_torch.distributed import DataParallel

    state, batches, _ = job
    st = fleet.DistributedStrategy()
    st.hybrid_configs = dict(st.hybrid_configs, dp_degree=2)
    fleet.init(strategy=st, devices=["cpu"] * 2)
    x, y = (torch.from_numpy(a) for a in batches[0])
    dp = DataParallel(W.mlp(state))
    W.mse(dp, x, y).backward()
    want = {n: p.grad.clone() for n, p in dp.named_parameters()}
    dp.apply_collective_grads()
    assert dp._dp_group().nranks == 2
    for n, p in dp.named_parameters():
        assert torch.equal(p.grad, want[n])
    assert dp.state_dict().keys() == dp._layers.state_dict().keys()


def test_spawn_raises_on_a_failed_worker():
    with pytest.raises(RuntimeError, match=r"exit codes \[3, 3\]"):
        launch.spawn(W.always_fail_worker, nprocs=2,
                     coordinator_port=_free_port())


def test_backend_is_chosen_not_switched(monkeypatch):
    assert env.choose_backend(None, 2) == "gloo"       # no card here
    assert env.choose_backend("gloo", 2) == "gloo"
    with pytest.raises(RuntimeError, match="nccl"):
        env.choose_backend("nccl", 2)
    with pytest.raises(ValueError):
        env.choose_backend("mpi", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("PTI_LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        env.choose_backend(None, 2)
    assert env.choose_backend("gloo", 2) == "gloo"
    monkeypatch.setenv("PTI_LOCAL_WORLD_SIZE", "1")
    assert env.choose_backend(None, 2) == "nccl"


def test_one_process_env_and_override(monkeypatch):
    from paddle_infer_tpu_torch.distributed import ParallelEnv, fleet as dfl

    assert env.get_rank() == 0 and env.get_world_size() == 1
    assert dfl.worker_num() == 1 and dfl.worker_index() == 0
    monkeypatch.setenv("PTI_DP_WORLD_SIZE", "4")
    assert env.get_world_size() == 4 and ParallelEnv().nranks == 4
    monkeypatch.delenv("PTI_COORDINATOR_ADDR", raising=False)
    monkeypatch.delenv("PADDLE_MASTER", raising=False)
    monkeypatch.setattr(env, "_initialized", False)
    assert env.init_parallel_env() is None     # one process: no group
    assert env.is_initialized()
    env.shutdown()
    assert not env.is_initialized()


def test_a_cross_process_axis_raises(monkeypatch):
    from paddle_infer_tpu_torch.serving import ShardedConfigError

    monkeypatch.setattr(env, "process_count", lambda: 2)
    st = fleet.DistributedStrategy()
    st.hybrid_configs = dict(st.hybrid_configs, dp_degree=1, pp_degree=2)
    with pytest.raises(ShardedConfigError, match="step 8"):
        fleet.init(strategy=st, devices=["cpu"])
    st.hybrid_configs = dict(st.hybrid_configs, dp_degree=3, pp_degree=1)
    with pytest.raises(ShardedConfigError, match="step 8"):
        fleet.init(strategy=st, devices=["cpu"] * 3)


def test_launch_cli_runs_the_script(tmp_path):
    import subprocess

    script = tmp_path / "job.py"
    script.write_text(
        "import os, sys\n"
        f"open(os.path.join({str(tmp_path)!r}, 'ran_' + "
        "os.environ['PTI_JOB_ID'] + '_' + sys.argv[1]), 'w').close()\n")
    repo = os.path.dirname(TESTS)
    envv = dict(os.environ, PYTHONPATH=repo)
    subprocess.run([sys.executable, "-m",
                    "paddle_infer_tpu_torch.distributed.launch",
                    "--job_id", "j7", str(script), "x"],
                   check=True, env=envv, cwd=repo, timeout=120)
    assert (tmp_path / "ran_j7_x").exists()


# ------------------------------------------------------------- elastic

def test_membership_and_health(tmp_path):
    from paddle_infer_tpu_torch.distributed.elastic import (ElasticManager,
                                                            FileStore)

    store = FileStore(str(tmp_path))
    changes = []
    m1 = ElasticManager("node-0", "2:4", store, timeout=5.0,
                        on_change=changes.append)
    m2 = ElasticManager("node-1", "2:4", store, timeout=5.0)
    assert m1.level == 2
    m1.register()
    m2.register()
    assert m1.current_nodes() == ["node-0", "node-1"]
    assert m1.healthy()
    m1.poll()
    m2.exit()
    assert m1.poll() == ["node-0"]
    assert changes == [["node-0"]]
    assert not m1.healthy()


def test_restart_policy(tmp_path):
    from paddle_infer_tpu_torch.distributed.elastic import (
        ELASTIC_AUTO_PARALLEL_EXIT_CODE, ElasticManager, FileStore)

    m = ElasticManager("n0", 1, FileStore(str(tmp_path)), timeout=5.0)
    assert m.level == 1
    m.register()
    assert m.should_restart(1)
    assert not m.should_restart(0)
    assert m.should_restart(ELASTIC_AUTO_PARALLEL_EXIT_CODE)


@pytest.mark.parametrize("method", [None, "spawn"])
def test_exit_101_relaunches_a_fresh_process(tmp_path, method):
    from paddle_infer_tpu_torch.distributed.elastic import ElasticLauncher

    el = ElasticLauncher(nprocs=2, max_restarts=2, start_method=method)
    stats = el.run(W.flaky_worker, (str(tmp_path),))
    assert stats["restarts"] == 1
    assert stats["attempts"] == {0: 1, 1: 2}
    assert len(stats["pids"][1]) == 2
    assert stats["pids"][1][0] != stats["pids"][1][1]
    markers = sorted(p.name for p in tmp_path.iterdir())
    a2 = [m for m in markers if m.startswith("r1_a2_")][0]
    assert int(a2.split("_")[-1]) == stats["pids"][1][1]
    assert any(m.startswith("r1_a1_") for m in markers)


def test_sigkill_crash_is_restarted(tmp_path):
    from paddle_infer_tpu_torch.distributed.elastic import ElasticLauncher

    stats = ElasticLauncher(nprocs=2, max_restarts=2).run(
        W.suicide_worker, (str(tmp_path),))
    assert stats["restarts"] == 1
    assert len(stats["pids"][0]) == 2
    assert (tmp_path / "r0_a1").exists() and (tmp_path / "r0_a2").exists()


def test_max_restarts_exhausted_raises():
    from paddle_infer_tpu_torch.distributed.elastic import ElasticLauncher

    with pytest.raises(RuntimeError, match="replica 0 failed"):
        ElasticLauncher(nprocs=1, max_restarts=1).run(W.always_fail_worker)


def test_clean_run_no_restarts(tmp_path):
    from paddle_infer_tpu_torch.distributed.elastic import ElasticLauncher

    stats = ElasticLauncher(nprocs=3).run(W.noop_worker, (str(tmp_path),))
    assert stats["restarts"] == 0
    assert all(len(v) == 1 for v in stats["pids"].values())


def test_a_cuda_parent_is_never_forked(monkeypatch):
    from paddle_infer_tpu_torch.distributed import elastic

    assert elastic.resolve_start_method(None) == "fork"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert elastic.resolve_start_method(None) == "spawn"
    with pytest.raises(RuntimeError, match="fork"):
        elastic.resolve_start_method("fork")


def test_chip_smoke_dist_phase_on_cpu():
    """``chip_smoke``'s dist phase, (a)-(e), at tiny sizes on the CPU
    (the wrappers take their plain versions, so no flash launch is
    counted): every gate of the card's run holds."""
    import chip_smoke
    from paddle_infer_tpu_torch.models.ernie import ErnieConfig

    assert "dist" in chip_smoke.PHASES
    cfg = ErnieConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=128,
                      max_position_embeddings=64)
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = chip_smoke.dist_phase(
            torch.device("cpu"), "cpu", cfg=cfg, batch=4, seq=32,
            table=dict(rows=1000, dim=8, shards=4, pushes=3, n_ids=256),
            launches_per_step=0)
    finally:
        torch.set_num_threads(saved)
    assert out["launches"] == {"flash_fwd": 0, "flash_dkdv": 0,
                               "flash_dq": 0}
    assert out["c"]["gb"] > 0 and out["d"]["unique_p50"] > 0
