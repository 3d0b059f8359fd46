"""Port parity: the flash-attention kernels' plain versions, the dropout
hash and ``sdpa`` of ``paddle_infer_tpu_torch`` against the JAX package.

The JAX side runs the Pallas kernels in interpret mode and ``_xla_sdpa``
(as ``tests/test_flash_masks_dropout.py`` does); the port runs its
wrappers on CPU tensors, which take the kernels' plain versions.  Inputs
come from numpy seeds.  Tolerance 2e-5, the JAX tests' own.  The
dropout hash and the dropout op are compared bit for bit.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

from paddle_infer_tpu.ops import activation as JACT
from paddle_infer_tpu.ops.attention import _xla_sdpa
from paddle_infer_tpu.ops.pallas import flash_attention as JFA
from paddle_infer_tpu_torch.core import random as R
from paddle_infer_tpu_torch.nn import functional as PF
from paddle_infer_tpu_torch.ops import attention as TA
from paddle_infer_tpu_torch.ops import flash_attention as TFA

TOL = 2e-5


def _qkv(b, s, h, d, seed, sk=None):
    rng = np.random.RandomState(seed)
    mk = lambda n: (rng.randn(b, n, h, d) * 0.3).astype(np.float32)
    return mk(s), mk(sk or s), mk(sk or s), rng.randn(b, s, h, d).astype(
        np.float32)


def _pad_segments(b, s, n_pad, seed):
    rng = np.random.RandomState(seed)
    seg = np.ones((b, s), np.int32)
    for i in range(b):
        seg[i, s - rng.randint(1, n_pad + 1):] = 0
    return seg


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix32_and_dropout_keep_bitwise(seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 2 ** 32, (4096,), dtype=np.uint64).astype(np.uint32)
    got = TFA._mix32(torch.tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JFA._mix32(jnp.asarray(x))).astype(np.int64))
    s = int(rng.randint(0, 2 ** 32, dtype=np.uint64))
    bh, rows, cols = (rng.randint(0, 2 ** 31 - 1, (4096,)) for _ in range(3))
    for p in (0.1, 0.5, 0.9):
        want = np.asarray(JFA.dropout_keep(jnp.uint32(s), jnp.asarray(bh),
                                           jnp.asarray(rows),
                                           jnp.asarray(cols), p))
        got = TFA.dropout_keep(s, torch.tensor(bh), torch.tensor(rows),
                               torch.tensor(cols), p).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(7,), (3, 5, 64), (2, 16, 96)])
def test_dropout_op_bitwise(shape):
    key = jax.random.fold_in(jax.random.key(3), 11)
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    want = np.asarray(JACT._dropout(jnp.asarray(x), key, p=0.1))
    tkey = torch.tensor(np.asarray(jax.random.key_data(key)).astype(
        np.int64))
    got = PF._dropout(torch.tensor(x), tkey, p=0.1).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _jax_fwd_bwd(q, k, v, co, seg, p, causal, impl=JFA.flash_attention):
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, dropout_p=p,
              dropout_seed=jnp.uint32(1234) if p else None,
              is_causal=causal, interpret=True)

    def loss(q, k, v):
        return jnp.sum(impl(q, k, v, **kw) * co)

    o = impl(q, k, v, **kw)
    return o, jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _port_fwd_bwd(q, k, v, co, seg, p, causal, impl=TFA.flash_attention):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    ts = None if seg is None else torch.tensor(seg)
    o = impl(tq, tk, tv, q_segment_ids=ts, kv_segment_ids=ts, dropout_p=p,
             dropout_seed=1234 if p else None, is_causal=causal)
    (o * torch.tensor(co)).sum().backward()
    return o.detach(), (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_values_and_grads_match_jax(causal, segments, dropout):
    b, s, h, d = 2, 128, 2, 64
    q, k, v, co = _qkv(b, s, h, d, seed=1)
    seg = _pad_segments(b, s, 40, seed=5) if segments else None
    o_j, g_j = _jax_fwd_bwd(q, k, v, co, seg, dropout, causal)
    o_t, g_t = _port_fwd_bwd(q, k, v, co, seg, dropout, causal)
    _close(o_t, o_j)
    for a, w in zip(g_t, g_j):
        _close(a, w)


@pytest.mark.parametrize("segments", [False, True])
def test_forward_lse_matches_jax_kernel(segments):
    """``flash_fwd``'s (o, lse) against the Pallas ``_fwd`` in interpret
    mode, folded layout, Sq < Sk causal (the offset)."""
    b, h, d, sq, sk = 1, 2, 64, 128, 256
    q, k, v, _ = _qkv(b, sq, h, d, seed=2, sk=sk)
    fold = lambda x: np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], d))
    qf, kf, vf = fold(q), fold(k), fold(v)
    seg_q = seg_k = None
    jq = jk = None
    if segments:
        seg_q = np.ones((b, sq), np.int32)
        seg_k = np.ones((b, sk), np.int32)
        seg_k[:, -30:] = 0
        jq, jk = JFA._prep_segments(seg_q, seg_k, b, sq, sk)
    o_j, lse_j = JFA._fwd(jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf),
                          jq, jk, jnp.uint32(9), True, 0.125, 0.1, 64, 64,
                          True, h)
    o_t, lse_t = TFA.flash_fwd(
        torch.tensor(qf), torch.tensor(kf), torch.tensor(vf),
        None if seg_q is None else torch.tensor(seg_q),
        None if seg_k is None else torch.tensor(seg_k), 9, True, 0.125, 0.1,
        h)
    _close(o_t, o_j)
    _close(lse_t, np.asarray(lse_j)[..., 0])


def test_fully_masked_rows_zero_output_and_grads():
    """Unique pad ids on the q side: those rows see no key, give 0 and
    pass no gradient (the kernels' dead-row convention)."""
    b, s, h, d = 1, 128, 2, 64
    q, k, v, co = _qkv(b, s, h, d, seed=3)
    seg_q = np.ones((b, s), np.int32)
    seg_q[:, -16:] = 7
    seg_k = np.ones((b, s), np.int32)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = TFA.flash_attention(tq, tk, tv, q_segment_ids=torch.tensor(seg_q),
                            kv_segment_ids=torch.tensor(seg_k),
                            dropout_p=0.1, dropout_seed=5)
    (o * torch.tensor(co)).sum().backward()
    assert torch.all(o[:, -16:] == 0)
    assert torch.all(tq.grad[:, -16:] == 0)
    ref = _xla_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                    jnp.uint32(5), 0.1, False, None,
                    q_segment_ids=jnp.asarray(seg_q),
                    kv_segment_ids=jnp.asarray(seg_k))
    _close(o.detach(), ref)


def test_hybrid_matches_jax():
    b, s, h, d = 1, 128, 2, 64
    q, k, v, co = _qkv(b, s, h, d, seed=4)
    seg = _pad_segments(b, s, 30, seed=6)
    o_j, g_j = _jax_fwd_bwd(q, k, v, co, seg, 0.1, False,
                            impl=JFA.hybrid_attention)
    o_t, g_t = _port_fwd_bwd(q, k, v, co, seg, 0.1, False,
                             impl=TFA.hybrid_attention)
    _close(o_t, o_j)
    for a, w in zip(g_t, g_j):
        _close(a, w)


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_matches_jax(causal):
    lens = [40, 70, 18]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    total, h, d = int(cu[-1]), 2, 64
    rng = np.random.RandomState(7)
    q, k, v = ((rng.randn(total, h, d) * 0.3).astype(np.float32)
               for _ in range(3))
    want = JFA.flash_attn_varlen(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(cu),
                                 dropout_p=0.1, dropout_seed=jnp.uint32(3),
                                 is_causal=causal, block_q=128,
                                 block_k=128, interpret=True)
    got = TFA.flash_attn_varlen(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), torch.tensor(cu),
                                dropout_p=0.1, dropout_seed=3,
                                is_causal=causal)
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_takes_the_plain_path_on_cpu_and_matches_jax(masked,
                                                          monkeypatch):
    b, s, h, d = 2, 64, 2, 64
    q, k, v, _ = _qkv(b, s, h, d, seed=8)
    seg = _pad_segments(b, s, 10, seed=9)
    calls = []
    monkeypatch.setattr(TFA, "flash_attention",
                        lambda *a, **kw: calls.append(1))
    assert TA._attn_impl_choice(torch.tensor(q), torch.tensor(k),
                                None) == "xla"
    mask = np.tril(np.ones((s, s), bool)) if masked else None
    key = jax.random.fold_in(jax.random.key(1), 2)
    tkey = torch.tensor(np.asarray(jax.random.key_data(key)).astype(
        np.int64))
    got = TA.sdpa(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                  None if mask is None else torch.tensor(mask), tkey,
                  torch.tensor(seg), torch.tensor(seg), dropout_p=0.1)
    seed = jax.random.bits(key, dtype=jnp.uint32)
    want = _xla_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     None if mask is None else jnp.asarray(mask), seed, 0.1,
                     False, None, q_segment_ids=jnp.asarray(seg),
                     kv_segment_ids=jnp.asarray(seg))
    assert not calls
    _close(got, want)


def test_dense_mask_raises_in_flash():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(NotImplementedError):
        TFA.flash_attention(q, q, q, mask=torch.ones(8, 8, dtype=torch.bool))


def _fake_cuda(shapes, dtypes):
    with FakeTensorMode(allow_non_fake_inputs=True):
        return [torch.zeros(s, dtype=d, device="cuda")
                for s, d in zip(shapes, dtypes)]


def test_wrappers_raise_on_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q, k, v, do = _fake_cuda([(4, 64, 64)] * 4, [torch.bfloat16] * 4)
    lse, delta = _fake_cuda([(4, 64)] * 2, [torch.float32] * 2)
    before = {n: kern.launches for n, kern in
              (("f", TFA._FWD), ("k", TFA._DKDV), ("q", TFA._DQ))}
    with pytest.raises(RuntimeError, match="CUDA"):
        TFA.flash_fwd(q, k, v, None, None, None, False, 0.125, 0.0, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TFA.flash_dkdv(q, k, v, do, lse, delta, None, None, None, False,
                       0.125, 0.0, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TFA.flash_dq(q, k, v, do, lse, delta, None, None, None, False,
                     0.125, 0.0, 2)
    assert before == {"f": TFA._FWD.launches, "k": TFA._DKDV.launches,
                      "q": TFA._DQ.launches}


@pytest.mark.parametrize("d", [64, 128, 256, 96])
def test_sdpa_choice_on_cuda_tensors(d):
    """On a CUDA tensor ``sdpa`` takes the kernels for every head_dim they
    take and raises for any other; only a dense mask goes plain."""
    q, mask = _fake_cuda([(1, 8, 2, d), (8, 8)],
                         [torch.bfloat16, torch.bool])
    assert TA._attn_impl_choice(q, q, mask) == "xla"
    if d in TFA.HEAD_DIMS:
        assert TA._attn_impl_choice(q, q, None) == "flash"
    else:
        with pytest.raises(NotImplementedError, match="head_dim 96"):
            TA._attn_impl_choice(q, q, None)


@pytest.mark.parametrize("entry", ["flash", "hybrid", "sdpa"])
def test_entry_points_raise_on_cuda_without_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q, k, v = _fake_cuda([(2, 64, 2, 64)] * 3, [torch.bfloat16] * 3)
    fn = {"flash": TFA.flash_attention, "hybrid": TFA.hybrid_attention,
          "sdpa": TA.sdpa}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(q, k, v)


def test_key_drawn_seed_is_jax_bits():
    key = jax.random.split(jax.random.key(4))[1]
    tkey = torch.tensor(np.asarray(jax.random.key_data(key)).astype(
        np.int64))
    assert R.seed_from_key(tkey) == int(jax.random.bits(key,
                                                        dtype=jnp.uint32))
