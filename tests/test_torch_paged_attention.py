"""Port parity: the paged-attention kernels' plain PyTorch versions and
the page utilities of ``paddle_infer_tpu_torch.ops`` against the JAX
package (Pallas kernels in interpret mode, XLA writers), on the same
numpy-seeded inputs.

Tolerance 2e-5 (rtol = atol) is the reference's own for its ragged
kernel against its reference composition (tests/test_ragged_serving.py):
float32 sums in another order.  The page writers move values and must
be bitwise equal.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_infer_tpu.ops.pallas import paged_attention as JPA
from paddle_infer_tpu.ops.pallas import ragged_paged_attention as JRPA
from paddle_infer_tpu_torch.ops import paged_attention as PA
from paddle_infer_tpu_torch.ops import ragged_paged_attention as RPA

TOL = dict(rtol=2e-5, atol=2e-5)
P, H, PAGE, D, MAX_PAGES = 17, 2, 4, 8, 3


@pytest.fixture(scope="module", autouse=True)
def _meshless():
    """The JAX decode kernel consults the current mesh at call time:
    clear any mesh another module leaked."""
    from paddle_infer_tpu.parallel import topology

    prev = topology.get_current_mesh()
    topology.set_current_mesh(None)
    yield
    topology.set_current_mesh(prev)


def _pools(seed):
    rs = np.random.RandomState(seed)
    k = rs.randn(P, H, PAGE, D).astype(np.float32)
    v = rs.randn(P, H, PAGE, D).astype(np.float32)
    return k, v


def _tables(seed, b):
    rs = np.random.RandomState(seed)
    return rs.permutation(P - 1)[:b * MAX_PAGES].reshape(
        b, MAX_PAGES).astype(np.int32)


def _both(k, v, quantized):
    """(jax pools, torch pools) holding the same values; int8 pools are
    quantized by the JAX package and carried over bit for bit."""
    if not quantized:
        return ((jnp.asarray(k), jnp.asarray(v)),
                (torch.tensor(k), torch.tensor(v)))
    jk, jv = JPA.quantize_pages(jnp.asarray(k)), JPA.quantize_pages(
        jnp.asarray(v))
    tk = tuple(torch.tensor(np.asarray(a)) for a in jk)
    tv = tuple(torch.tensor(np.asarray(a)) for a in jv)
    return (jk, jv), (tk, tv)


def test_quantize_pages_bitwise():
    k, _ = _pools(0)
    jp, js = JPA.quantize_pages(jnp.asarray(k))
    tp, ts = PA.quantize_pages(torch.tensor(k))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        PA.dequantize_pages((tp, ts)).numpy(),
        np.asarray(JPA.dequantize_pages((jp, js))))
    assert PA.is_quantized((tp, ts)) and not PA.is_quantized(tp)


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_plain_matches_jax_kernel(quantized):
    k, v = _pools(1)
    (jk, jv), (tk, tv) = _both(k, v, quantized)
    tables = _tables(2, 4)
    lengths = np.asarray([1, 5, 12, 0], np.int32)
    q = np.random.RandomState(3).randn(4, H, D).astype(np.float32)
    want = JPA.paged_attention_decode(jnp.asarray(q), jk, jv,
                                      jnp.asarray(tables),
                                      jnp.asarray(lengths), interpret=True)
    got = PA.paged_attention_decode(torch.tensor(q), tk, tv,
                                    torch.tensor(tables),
                                    torch.tensor(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _source_split_pages():
    """The kernels' one ``kSplitPages``, read from their source (the CPU
    has no built library to ask ``PA.split_pages()``)."""
    src = os.path.join(os.path.dirname(PA.__file__), "csrc",
                       "paged_attention.cu")
    with open(src) as f:
        return int(re.search(r"constexpr int kSplitPages = (\d+);",
                             f.read()).group(1))


# The card kernels split a row's pages into blocks of kSplitPages pages
# (csrc/paged_attention.cu) and change their control flow at page and
# split boundaries; at a split of 8, a table of 20 pages of 4 spans two
# whole splits and part of a third.  These lengths sit on each side of
# every boundary.
SPLIT = _source_split_pages()
B_PAGES, B_PAGE = 2 * SPLIT + SPLIT // 2, 4
BOUNDARY_LENS = (0, 1, B_PAGE - 1, B_PAGE, B_PAGE + 1,
                 SPLIT * B_PAGE - 1, SPLIT * B_PAGE, SPLIT * B_PAGE + 1,
                 2 * SPLIT * B_PAGE - 1, 2 * SPLIT * B_PAGE,
                 2 * SPLIT * B_PAGE + 1, B_PAGES * B_PAGE)


def boundary_case(seed, quantized, rows=len(BOUNDARY_LENS)):
    """Pools and distinct-page tables for ``rows`` rows of a
    ``B_PAGES``-page table of 4-slot pages (h=2, d=8), as (jax pools,
    torch pools, tables)."""
    rs = np.random.RandomState(seed)
    num_pages = rows * B_PAGES + 1
    k = rs.randn(num_pages, H, B_PAGE, D).astype(np.float32)
    v = rs.randn(num_pages, H, B_PAGE, D).astype(np.float32)
    tables = rs.permutation(num_pages)[:rows * B_PAGES].reshape(
        rows, B_PAGES).astype(np.int32)
    return (*_both(k, v, quantized), tables)


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_plain_matches_jax_kernel_at_split_boundaries(quantized):
    """Lengths 0, 1, page +- 1, the split boundaries +- 1 and the full
    table: where the card kernel's split walk and combine change course,
    the plain version (its yardstick) still equals the Pallas kernel."""
    (jk, jv), (tk, tv), tables = boundary_case(30, quantized)
    lengths = np.asarray(BOUNDARY_LENS, np.int32)
    q = np.random.RandomState(31).randn(len(lengths), H, D).astype(
        np.float32)
    want = JPA.paged_attention_decode(jnp.asarray(q), jk, jv,
                                      jnp.asarray(tables),
                                      jnp.asarray(lengths), interpret=True)
    got = PA.paged_attention_decode(torch.tensor(q), tk, tv,
                                    torch.tensor(tables),
                                    torch.tensor(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[0].any()                       # length 0: zeros


def _ragged_inputs(seed):
    rs = np.random.RandomState(seed)
    c = 6
    ctx = np.asarray([3, 6, 0, 4, 11], np.int32)
    qlens = np.asarray([0, 1, 6, 3, 1], np.int32)
    q = rs.randn(len(ctx), c, H, D).astype(np.float32)
    return q, ctx, qlens


@pytest.mark.parametrize("quantized", [False, True])
def test_ragged_plain_matches_jax_kernel_and_reference(quantized):
    k, v = _pools(4)
    (jk, jv), (tk, tv) = _both(k, v, quantized)
    q, ctx, qlens = _ragged_inputs(5)
    tables = _tables(6, len(ctx))
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(ctx),
             jnp.asarray(qlens))
    targs = (torch.tensor(q), tk, tv, torch.tensor(tables),
             torch.tensor(ctx), torch.tensor(qlens))
    got = RPA.ragged_paged_attention(*targs, use_kernel=True).numpy()
    valid = np.arange(q.shape[1])[None] < qlens[:, None]
    kern = np.asarray(JRPA._ragged_kernel_call(*jargs, interpret=True))
    np.testing.assert_allclose(got[valid], kern[valid], **TOL)
    ref = np.asarray(JRPA._ragged_reference(*jargs))
    np.testing.assert_allclose(got[valid], ref[valid], **TOL)
    # positions past query_lens come back as zeros from the kernel path
    assert not np.any(got[~valid])


@pytest.mark.parametrize("quantized", [False, True])
def test_ragged_reference_matches_jax_reference(quantized):
    k, v = _pools(7)
    (jk, jv), (tk, tv) = _both(k, v, quantized)
    q, ctx, qlens = _ragged_inputs(8)
    tables = _tables(9, len(ctx))
    want = np.asarray(JRPA.ragged_paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(ctx),
        jnp.asarray(qlens)))
    got = RPA.ragged_paged_attention(
        torch.tensor(q), tk, tv, torch.tensor(tables), torch.tensor(ctx),
        torch.tensor(qlens)).numpy()
    valid = np.arange(q.shape[1])[None] < qlens[:, None]
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


def test_ragged_decode_row_matches_decode():
    """A qlen == 1 row of the ragged kernel's plain version equals the
    decode plain version at lengths = ctx + 1."""
    k, v = _pools(10)
    q, ctx, qlens = _ragged_inputs(11)
    tables = torch.tensor(_tables(12, len(ctx)))
    tk, tv = torch.tensor(k), torch.tensor(v)
    rag = RPA.ragged_kernel(torch.tensor(q), tk, tv, tables,
                            torch.tensor(ctx), torch.tensor(qlens))
    dec = PA.paged_attention_decode(torch.tensor(q[:, 0]), tk, tv, tables,
                                    torch.tensor(ctx + 1))
    one = qlens == 1
    np.testing.assert_allclose(rag[:, 0].numpy()[one], dec.numpy()[one],
                               **TOL)


def test_verify_rows_not_ported():
    """Verify rows ride the reference composition only: the single-launch
    ragged kernel refuses them, as the JAX package's does."""
    k, v = _pools(0)
    q, ctx, qlens = _ragged_inputs(0)
    with pytest.raises(NotImplementedError):
        RPA.ragged_paged_attention(
            torch.tensor(q), torch.tensor(k), torch.tensor(v),
            torch.tensor(_tables(0, len(ctx))), torch.tensor(ctx),
            torch.tensor(qlens), verify_rows=torch.ones(len(ctx), dtype=bool),
            verify_window=2, use_kernel=True)


def test_write_ragged_pages_bitwise_with_scratch_routing():
    k, _ = _pools(13)
    rs = np.random.RandomState(14)
    q, ctx, qlens = _ragged_inputs(15)
    kv = rs.randn(*q.shape).astype(np.float32)
    tables = _tables(16, len(ctx))
    scratch = P - 1
    want = JRPA.write_ragged_pages(jnp.asarray(k), jnp.asarray(tables),
                                   jnp.asarray(kv), jnp.asarray(ctx),
                                   jnp.asarray(qlens), scratch)
    got = RPA.write_ragged_pages(torch.tensor(k), torch.tensor(tables),
                                 torch.tensor(kv), torch.tensor(ctx),
                                 torch.tensor(qlens), scratch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # pads really went to the scratch page (inactive row 0 wrote there)
    assert not np.array_equal(got.numpy()[scratch], k[scratch])


def test_write_chunk_and_token_pages_bitwise():
    k, _ = _pools(17)
    rs = np.random.RandomState(18)
    tables = _tables(19, 3)
    offsets = np.asarray([0, 3, 6], np.int32)
    chunk = rs.randn(3, 5, H, D).astype(np.float32)
    want = JPA.write_chunk_pages(jnp.asarray(k), jnp.asarray(tables),
                                 jnp.asarray(chunk), jnp.asarray(offsets))
    got = PA.write_chunk_pages(torch.tensor(k), torch.tensor(tables),
                               torch.tensor(chunk), torch.tensor(offsets))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tok = rs.randn(3, H, D).astype(np.float32)
    pos = np.asarray([0, 7, 11], np.int32)
    want = JPA.write_token_page(jnp.asarray(k), jnp.asarray(tables),
                                jnp.asarray(tok), jnp.asarray(pos))
    got = PA.write_token_page(torch.tensor(k), torch.tensor(tables),
                              torch.tensor(tok), torch.tensor(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quantized", [False, True])
def test_prefix_prefill_attention_matches_jax(quantized):
    k, v = _pools(20)
    (jk, jv), (tk, tv) = _both(k, v, quantized)
    rs = np.random.RandomState(21)
    q = rs.randn(3, 4, H, D).astype(np.float32)
    tables = _tables(22, 3)
    offsets = np.asarray([0, 5, 8], np.int32)
    want = JPA.prefix_prefill_attention(jnp.asarray(q), jk, jv,
                                        jnp.asarray(tables),
                                        jnp.asarray(offsets))
    got = PA.prefix_prefill_attention(torch.tensor(q), tk, tv,
                                      torch.tensor(tables),
                                      torch.tensor(offsets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_TOL = {"fp32": 1e-4, "bf16": 2e-2, "f16": 2e-2, "int8": 2e-2}
CARD_Q = {"fp32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
          "int8": torch.bfloat16}


def _card_pools(kind, k, v):
    """(kernel pools, float32 pools holding the same stored values)."""
    if kind == "fp32":
        return (k, v), (k, v)
    if kind in ("bf16", "f16"):
        kb, vb = k.to(CARD_Q[kind]), v.to(CARD_Q[kind])
        return (kb, vb), (kb.float(), vb.float())
    kq, vq = PA.quantize_pages(k), PA.quantize_pages(v)
    return (kq, vq), (kq, vq)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256, 8])
def test_decode_and_verify_kernels_on_card(cuda_device, d):
    """The split decode and verify kernels at lengths on each side of
    every page and split boundary (page 16, a table of 2.5 splits; the
    split from ``PA.split_pages()``), fp32, bf16, f16 and int8 pools
    (tensor-core walk for 16-bit queries at head dims 64-256, CUDA-core
    walk for fp32 and at head dim 8, which int8 pools do not take): each
    allclose to its plain version (fp32 1e-4, bf16 / f16 / int8 2e-2:
    16-bit queries, pages and weights, sums in another order); every
    verify lane EQUAL to the decode kernel at its length; each kernel
    bit-equal across two launches; each row bit-equal whether run in the
    batch or alone."""
    split, page = PA.split_pages(), 16
    assert split == SPLIT
    max_pages = 2 * split + split // 2
    t = split * page
    lens = [0, 1, page - 1, page, page + 1, t - 1, t, t + 1, 2 * t - 1,
            2 * t, 2 * t + 1, max_pages * page]
    b, h, w = len(lens), 4, 5
    rs = np.random.RandomState(d)
    num_pages = b * max_pages + 1
    mk = lambda *shape: torch.tensor(rs.randn(*shape).astype(np.float32),
                                     device=cuda_device)
    k, v = mk(num_pages, h, page, d), mk(num_pages, h, page, d)
    tables = torch.tensor(rs.permutation(num_pages)[:b * max_pages].reshape(
        b, max_pages).astype(np.int32), device=cuda_device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    vlens = torch.clamp(lengths[:, None] - (w - 1)
                        + torch.arange(w, device=cuda_device)[None],
                        min=0).int().contiguous()
    q32, qv32 = mk(b, h, d), mk(b, w, h, d)
    for kind in ("fp32", "bf16", "f16", "int8")[:4 if d % 16 == 0 else 3]:
        (kp, vp), (kr, vr) = _card_pools(kind, k, v)
        q, qv = q32.to(CARD_Q[kind]), qv32.to(CARD_Q[kind])
        tol = CARD_TOL[kind]
        dec = [PA.paged_attention_decode(q, kp, vp, tables, lengths)
               for _ in range(2)]
        ver = [PA.paged_attention_verify(qv, kp, vp, tables, vlens)
               for _ in range(2)]
        torch.cuda.synchronize()
        torch.testing.assert_close(
            dec[0].float(), PA._decode_plain(q.float(), kr, vr, tables,
                                             lengths), atol=tol, rtol=tol)
        torch.testing.assert_close(
            ver[0].float(), PA._verify_plain(qv.float(), kr, vr, tables,
                                             vlens), atol=tol, rtol=tol)
        assert torch.equal(dec[0], dec[1]) and torch.equal(ver[0], ver[1])
        assert not dec[0][0].any()                 # length 0: zeros
        for lane in range(w):
            assert torch.equal(ver[0][:, lane], PA.paged_attention_decode(
                qv[:, lane].contiguous(), kp, vp, tables,
                vlens[:, lane].contiguous())), (kind, lane)
        for row in range(b):
            one = slice(row, row + 1)
            assert torch.equal(dec[0][one], PA.paged_attention_decode(
                q[one], kp, vp, tables[one], lengths[one])), (kind, row)
            assert torch.equal(ver[0][one], PA.paged_attention_verify(
                qv[one], kp, vp, tables[one], vlens[one])), (kind, row)
