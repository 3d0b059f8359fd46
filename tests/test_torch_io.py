"""Port parity: ``paddle_infer_tpu_torch/io`` against
``paddle_infer_tpu/io``.

* Samplers, ``random_split`` and the datasets give the reference's
  indices and items under one ``np.random.seed``; the ``DataLoader``'s
  batches equal the reference loader's with 0 and 2 workers, in process
  and thread mode, shared memory on and off, shuffled and not.
* ``tests/test_dataloader_mp.py:43-120`` on the port: workers are
  processes, delivery is in order and complete, an error in a worker
  propagates, ``worker_init_fn`` and ``get_worker_info`` work, the
  per-worker seed is ``(seed + worker_id) % 2**31``.  Its CPU throughput
  bar is left out (a timing gate flakes under a loaded test run); the
  card's smoke prints the loader's batches/s instead.
* An epoch that ends early (a ``break``, an error in a worker) leaves no
  shared-memory segment of the loader behind.
"""
import glob
import os

import numpy as np
import pytest
import torch

from paddle_infer_tpu import io as jio
from paddle_infer_tpu_torch import io as tio
from paddle_infer_tpu_torch.io import dataset as tds
from paddle_infer_tpu_torch.io.worker import SHM_PREFIX, get_worker_info


def _seeded(fn, seed=11):
    np.random.seed(seed)
    return fn()


def _np(batch):
    """A batch (tensors or arrays, nested) as numpy arrays."""
    if isinstance(batch, torch.Tensor):
        return batch.numpy()
    if isinstance(batch, (tuple, list)):
        return [_np(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _np(v) for k, v in batch.items()}
    return np.asarray(batch)


def _equal(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_all_equals_reference():
    assert tio.__all__ == jio.__all__
    for name in tio.__all__:
        assert hasattr(tio, name), name


# -------------------------------------------------------------- samplers

class Seq:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((3,), i, np.int64), np.float32(i) / 4


SAMPLERS = {
    "sequence": lambda m, ds: m.SequenceSampler(ds),
    "random": lambda m, ds: m.RandomSampler(ds),
    "random_replacement": lambda m, ds: m.RandomSampler(
        ds, replacement=True, num_samples=30),
    "random_subset": lambda m, ds: m.RandomSampler(ds, num_samples=9),
    "weighted": lambda m, ds: m.WeightedRandomSampler(
        np.arange(1, 24), 40),
    "weighted_no_replacement": lambda m, ds: m.WeightedRandomSampler(
        np.arange(1, 24), 12, replacement=False),
}


@pytest.mark.parametrize("kind", sorted(SAMPLERS))
def test_sampler_order_equals_reference(kind):
    ds = Seq(23)
    want = _seeded(lambda: list(SAMPLERS[kind](jio, ds)))
    got = _seeded(lambda: list(SAMPLERS[kind](tio, ds)))
    assert got == want
    assert len(SAMPLERS[kind](tio, ds)) == len(SAMPLERS[kind](jio, ds))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_sampler_equals_reference(shuffle, drop_last):
    ds = Seq(23)
    kw = dict(dataset=ds, shuffle=shuffle, batch_size=5, drop_last=drop_last)
    j, t = jio.BatchSampler(**kw), tio.BatchSampler(**kw)
    assert _seeded(lambda: list(t)) == _seeded(lambda: list(j))
    assert len(t) == len(j)
    sampler_kw = dict(sampler=tio.SequenceSampler(ds), batch_size=4)
    assert list(tio.BatchSampler(**sampler_kw)) == list(jio.BatchSampler(
        sampler=jio.SequenceSampler(ds), batch_size=4))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("rank", [0, 1, 2])
def test_distributed_batch_sampler_equals_reference(shuffle, rank):
    ds = Seq(23)
    kw = dict(batch_size=3, num_replicas=3, rank=rank, shuffle=shuffle)
    j = jio.DistributedBatchSampler(ds, **kw)
    t = tio.DistributedBatchSampler(ds, **kw)
    for _ in range(2):                  # the epoch advances per pass
        assert list(t) == list(j)
    j.set_epoch(7)
    t.set_epoch(7)
    assert list(t) == list(j) and len(t) == len(j)
    dl = dict(kw, drop_last=True)
    assert list(tio.DistributedBatchSampler(ds, **dl)) == \
        list(jio.DistributedBatchSampler(ds, **dl))


def test_distributed_sampler_world_size_defaults_to_one(monkeypatch):
    monkeypatch.delenv("PTI_DP_WORLD_SIZE", raising=False)
    s = tio.DistributedBatchSampler(Seq(10), batch_size=4)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert list(s) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    monkeypatch.setenv("PTI_DP_WORLD_SIZE", "2")
    assert tio.DistributedBatchSampler(Seq(10), batch_size=4).nranks == 2


# -------------------------------------------------------------- datasets

def test_random_split_equals_reference():
    ds = Seq(20)
    want = _seeded(lambda: jio.random_split(ds, [7, 13]))
    got = _seeded(lambda: tio.random_split(ds, [7, 13]))
    assert [s.indices for s in got] == [s.indices for s in want]
    _equal(got[1][4], want[1][4])


def test_datasets_equal_reference():
    rng = np.random.RandomState(3)
    a = rng.randn(10, 4).astype(np.float32)
    b = rng.randint(0, 5, (10,)).astype(np.int64)
    jt = jio.TensorDataset([a, b])
    tt = tio.TensorDataset([torch.tensor(a), torch.tensor(b)])
    assert len(tt) == len(jt) == 10
    for i in (0, 7):
        _equal(tt[i], jt[i])
    js, ts = jio.Subset(jt, [3, 1, 8]), tio.Subset(tt, [3, 1, 8])
    assert len(ts) == len(js)
    _equal(ts[2], js[2])
    jc = jio.ComposeDataset([jt, Seq(8)])
    tc = tio.ComposeDataset([tt, Seq(8)])
    assert len(tc) == len(jc) == 8
    _equal(tc[5], jc[5])
    from paddle_infer_tpu.io.dataset import ConcatDataset as JConcat

    jk, tk = JConcat([jt, Seq(4)]), tds.ConcatDataset([tt, Seq(4)])
    assert len(tk) == len(jk) == 14
    for i in (0, 9, 10, 13):
        _equal(tk[i], jk[i])


class Stream(tio.IterableDataset):
    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi

    def __iter__(self):
        for i in range(self.lo, self.hi):
            yield np.full((2,), i, np.int32)


def test_iterable_datasets():
    chain = tio.ChainDataset([Stream(0, 3), Stream(10, 12)])
    assert [int(x[0]) for x in chain] == [0, 1, 2, 10, 11]
    with pytest.raises(RuntimeError):
        chain[0]
    dl = tio.DataLoader(chain, batch_size=2)
    got = [b[:, 0].tolist() for b in dl]
    want = [b[:, 0].tolist() for b in jio.DataLoader(
        jio.ChainDataset([Stream(0, 3), Stream(10, 12)]), batch_size=2,
        to_tensor=False)]
    assert got == want == [[0, 1], [2, 10], [11]]
    assert len([b for b in tio.DataLoader(chain, batch_size=2,
                                          drop_last=True)]) == 2
    with pytest.raises(TypeError):
        len(dl)


def test_default_collate_fn_equals_reference():
    samples = [{"a": np.full((2,), i, np.float32), "b": i, "c": i / 2,
                "d": (np.int32(i), [np.float64(i)])} for i in range(3)]
    _equal(tio.default_collate_fn(samples), jio.default_collate_fn(samples))


# ------------------------------------------------------------ DataLoader

LOADER_MODES = [dict(num_workers=0), dict(num_workers=2),
                dict(num_workers=2, use_shared_memory=False),
                dict(num_workers=2, worker_mode="thread")]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("mode", range(len(LOADER_MODES)),
                         ids=["single", "process", "process_noshm",
                              "thread"])
def test_loader_batches_equal_reference(mode, shuffle):
    kw = dict(batch_size=8, shuffle=shuffle, **LOADER_MODES[mode])
    want = _seeded(lambda: list(jio.DataLoader(Seq(44), to_tensor=False,
                                               **kw)))
    dl = tio.DataLoader(Seq(44), **kw)
    got = _seeded(lambda: list(dl))
    assert len(got) == len(want) == len(dl) == 6
    for g, w in zip(got, want):
        assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
                   for x in g)
        _equal(g, w)


class PidDataset(tio.Dataset):
    def __len__(self):
        return 64

    def __getitem__(self, i):
        return np.full((4,), os.getpid(), np.int64)


def test_workers_are_processes():
    dl = tio.DataLoader(PidDataset(), batch_size=8, num_workers=4,
                        to_tensor=False)
    pids = set()
    for batch in dl:
        pids.update(int(p) for p in batch[:, 0])
    assert os.getpid() not in pids
    assert len(pids) > 1
    assert dl.last_worker_pids == pids


class TokenDataset(tio.Dataset):
    def __init__(self, n=64, seq=16):
        self.n, self.seq = n, seq

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        ids = np.random.RandomState(i).randint(0, 40000, self.seq)
        return ids.astype(np.int32), np.int64(i)


def test_in_order_and_complete():
    dl = tio.DataLoader(TokenDataset(), batch_size=8, num_workers=3,
                        to_tensor=False)
    seen = []
    for ids, idx in dl:
        assert ids.shape == (8, 16)
        seen.extend(int(i) for i in idx)
    assert seen == list(range(64))


def test_matches_single_process():
    ds = TokenDataset(n=48, seq=32)
    a = list(tio.DataLoader(ds, batch_size=8, num_workers=0))
    b = list(tio.DataLoader(ds, batch_size=8, num_workers=2))
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        _equal(x, y)


class BoomDataset(tio.Dataset):
    def __len__(self):
        return 32

    def __getitem__(self, i):
        if i == 17:
            raise ValueError("boom at 17")
        return np.zeros(4, np.float32)


def _segments():
    return glob.glob(f"/dev/shm/{SHM_PREFIX}{os.getpid()}_*")


@pytest.mark.parametrize("mode", ["process", "thread"])
def test_worker_error_propagates(mode):
    dl = tio.DataLoader(BoomDataset(), batch_size=8, num_workers=2,
                        worker_mode=mode)
    with pytest.raises(ValueError, match="boom at 17"):
        list(dl)
    assert _segments() == []


def test_early_end_unlinks_every_segment():
    """A ``break`` after one batch, with the workers running ahead: the
    reorder window and the queue are drained and unlinked."""
    dl = tio.DataLoader(TokenDataset(n=64, seq=256), batch_size=4,
                        num_workers=2, prefetch_factor=4)
    for i, _ in enumerate(dl):
        if i == 1:
            break
    assert _segments() == []
    assert len(list(dl)) == 16          # the loader starts over cleanly
    assert _segments() == []


def test_worker_init_fn_worker_info_and_seed():
    class InfoDataset(tio.Dataset):
        def __len__(self):
            return 16

        def __getitem__(self, i):
            info = get_worker_info()
            assert info is not None and 0 <= info.id < info.num_workers
            return np.array([info.id, info.seed, np.random.randint(1 << 30),
                             int(os.environ.get("PIT_TEST_WORKER", -1))],
                            np.int64)

    def init(worker_id):
        os.environ["PIT_TEST_WORKER"] = str(worker_id)

    assert get_worker_info() is None
    dl = tio.DataLoader(InfoDataset(), batch_size=4, num_workers=2,
                        worker_init_fn=init, to_tensor=False)
    rows = np.concatenate(list(dl))
    assert set(rows[:, 0].tolist()) <= {0, 1}
    assert (rows[:, 0] == rows[:, 3]).all()         # init ran in each
    for wid in set(rows[:, 0].tolist()):
        seed = int(rows[rows[:, 0] == wid][0, 1])
        first = np.random.RandomState((seed + wid) % 2 ** 31).randint(
            1 << 30)
        assert first in rows[rows[:, 0] == wid][:, 2].tolist()


def test_forkserver_workers():
    """The start method a process with a CUDA context takes: workers
    forked from a fresh server, the dataset pickled to them; batches
    equal the single-process ones and every segment is unlinked."""
    from paddle_infer_tpu_torch.io import worker

    assert worker.default_start_method() == (
        "forkserver" if torch.cuda.is_initialized() else "fork")
    ds = tio.TensorDataset([np.arange(40, dtype=np.int64).reshape(20, 2)])
    want = list(tio.DataLoader(ds, batch_size=6, to_tensor=False))
    it = worker.MultiprocessIter(
        ds, tio.default_collate_fn,
        list(tio.BatchSampler(dataset=ds, batch_size=6)), num_workers=2,
        prefetch_factor=2, start_method="forkserver")
    got = list(it)
    assert os.getpid() not in it.worker_pids and len(it.worker_pids) >= 1
    for g, w in zip(got, want):
        _equal(g, w)
    assert len(got) == len(want) == 4
    assert _segments() == []
