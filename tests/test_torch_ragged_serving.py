"""The serving composition of ``ragged_paged_attention``: chunk rows
through the ragged kernel, decode rows through the decode kernel,
verify rows through the verify kernel.

On the CPU every kernel wrapper runs its plain version, and the
composition must be bitwise the port's copy of the reference
composition (``_ragged_reference``, every position through the plain
fp32 window attention) on valid positions, in float32 and bfloat16;
against the JAX package's ``ragged_paged_attention`` it is allclose at
2e-5 (rtol = atol, the reference's own tolerance for its ragged kernel:
float32 sums in another order).

On a card (``gpu`` marker) the ragged kernel is held to its plain
version on the same 16-bit-rounded inputs at atol = rtol = 1e-2 for
bf16 / f16 queries over 16-bit or int8 pages (the bf16 output's own
rounding reaches 2^-9 of its magnitude) and 1e-4 for float32, and a
prompt's outputs must not depend on how it was chunked.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_infer_tpu.ops.pallas import paged_attention as JPA
from paddle_infer_tpu.ops.pallas import ragged_paged_attention as JRPA
from paddle_infer_tpu_torch.ops import paged_attention as PA
from paddle_infer_tpu_torch.ops import ragged_paged_attention as RPA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-5, atol=2e-5)
H, PAGE, D, MAX_PAGES, C, W = 2, 4, 8, 6, 6, 4
# (ctx, query_len, verify): chunks from 0 and mid-context (one reaching
# the window's last page), decode rows, inactive rows, verify rows with
# drafts, without and past the window
ROWS = [(0, 6, False), (7, 5, False), (3, 1, False), (10, 0, False),
        (9, 3, True), (12, 1, True), (15, 1, False), (18, 6, False),
        (0, 0, False), (4, 4, True), (2, 6, True)]


def _case(seed, quantized=False, dtype=torch.float32):
    """(jax args, torch args, verify flags, valid mask) for ROWS."""
    rs = np.random.RandomState(seed)
    b = len(ROWS)
    num_pages = b * MAX_PAGES + 1
    k = rs.randn(num_pages, H, PAGE, D).astype(np.float32)
    v = rs.randn(num_pages, H, PAGE, D).astype(np.float32)
    tables = rs.permutation(num_pages - 1)[:b * MAX_PAGES].reshape(
        b, MAX_PAGES).astype(np.int32)
    ctx = np.asarray([r[0] for r in ROWS], np.int32)
    qlens = np.asarray([r[1] for r in ROWS], np.int32)
    verify = np.asarray([r[2] for r in ROWS])
    q = rs.randn(b, C, H, D).astype(np.float32)
    if quantized:
        jk, jv = JPA.quantize_pages(jnp.asarray(k)), JPA.quantize_pages(
            jnp.asarray(v))
        tk = tuple(torch.tensor(np.asarray(a)) for a in jk)
        tv = tuple(torch.tensor(np.asarray(a)) for a in jv)
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk = torch.tensor(k).to(dtype)
        tv = torch.tensor(v).to(dtype)
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(ctx),
             jnp.asarray(qlens))
    targs = (torch.tensor(q).to(dtype), tk, tv, torch.tensor(tables),
             torch.tensor(ctx), torch.tensor(qlens))
    valid = np.arange(C)[None] < qlens[:, None]
    return jargs, targs, verify, valid


@pytest.mark.parametrize("with_verify", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_serving_composition_bitwise_reference(dtype, with_verify):
    """Chunk rows through the ragged kernel's plain version give the
    very bits of the reference composition's plain window attention;
    decode and verify rows take the same kernels in both."""
    _, targs, verify, valid = _case(1, dtype=dtype)
    kw = dict(verify_rows=torch.tensor(verify), verify_window=W) \
        if with_verify else {}
    got = RPA.ragged_paged_attention(*targs, **kw)
    want = RPA._ragged_reference(*targs, **kw)
    assert got.dtype == dtype
    mask = torch.tensor(valid)
    assert torch.equal(got[mask], want[mask])


@pytest.mark.parametrize("quantized", [False, True])
def test_serving_composition_matches_jax(quantized):
    jargs, targs, verify, valid = _case(2, quantized)
    want = np.asarray(JRPA.ragged_paged_attention(
        *jargs, verify_rows=jnp.asarray(verify), verify_window=W))
    got = RPA.ragged_paged_attention(
        *targs, verify_rows=torch.tensor(verify), verify_window=W).numpy()
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


@pytest.mark.parametrize("with_verify", [False, True])
def test_serving_composition_pads(with_verify):
    """Pad positions of chunk rows (and of decode and inactive rows) come
    back as zeros; every position of the output is finite."""
    _, targs, verify, valid = _case(3)
    kw = dict(verify_rows=torch.tensor(verify), verify_window=W) \
        if with_verify else {}
    out = RPA.ragged_paged_attention(*targs, **kw)
    assert torch.isfinite(out).all()
    for b, (_, n, ver) in enumerate(ROWS):
        if with_verify and ver:
            assert not out[b, max(n, W):].any()
        else:
            assert not out[b, n:].any(), b
    assert out[torch.tensor(valid)].abs().sum() > 0


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_Q = {"fp32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
          "int8": torch.bfloat16}
CARD_TOL = {"fp32": 1e-4, "bf16": 1e-2, "f16": 1e-2, "int8": 1e-2}


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
@pytest.mark.parametrize("d,page", [(64, 16), (128, 16), (256, 16),
                                    (64, 32), (32, 16), (64, 8)])
def test_ragged_kernel_on_card(cuda_device, d, page):
    """The ragged kernel against its plain version in fp32, bf16, f16 and
    int8 pools (tensor-core walk for 16-bit queries at head dims 64-256
    and pages of a multiple of 16, the CUDA-core walk otherwise and for
    fp32): chunks that are not tile multiples, contexts that are not
    page-aligned, a chunk reaching the window's last page, decode and
    inactive rows, a C that is not a multiple of the query tile.  Pads
    are zeros; two launches are bit-equal; each row alone equals the
    row in the batch."""
    max_pages = 320 // page
    window = max_pages * page
    rows = [(0, 150), (37, 100), (window - 150, 150), (133, 37), (5, 1),
            (250, 0), (window - 1, 1), (17, 64)]
    b, h, c = len(rows), 4, 150
    g = torch.Generator(device=cuda_device)
    g.manual_seed(d * 1000 + page)
    num_pages = b * max_pages + 1
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device)
    k, v = mk(num_pages, h, page, d), mk(num_pages, h, page, d)
    perm = torch.randperm(num_pages, generator=g, device=cuda_device)
    tables = perm[:b * max_pages].reshape(b, max_pages).int().contiguous()
    ctx = torch.tensor([r[0] for r in rows], dtype=torch.int32,
                       device=cuda_device)
    qlens = torch.tensor([r[1] for r in rows], dtype=torch.int32,
                         device=cuda_device)
    q32 = mk(b, c, h, d)
    valid = (torch.arange(c, device=cuda_device)[None] < qlens[:, None])
    kinds = ("fp32", "bf16", "f16") + (("int8",) if d % 16 == 0 else ())
    for kind in kinds:
        (kp, vp), (kr, vr) = _card_pools(kind, k, v)
        q = q32.to(CARD_Q[kind])
        tol = CARD_TOL[kind]
        got = [RPA.ragged_kernel(q, kp, vp, tables, ctx, qlens)
               for _ in range(2)]
        torch.cuda.synchronize()
        ref = RPA._ragged_plain(q.float(), kr, vr, tables, ctx, qlens)
        torch.testing.assert_close(got[0].float()[valid], ref[valid],
                                   atol=tol, rtol=tol)
        assert not got[0][~valid].any(), kind
        assert torch.equal(got[0], got[1]), kind
        for row in (0, 2, 3):
            one = slice(row, row + 1)
            alone = RPA.ragged_kernel(q[one].contiguous(), kp, vp,
                                      tables[one].contiguous(),
                                      ctx[one].contiguous(),
                                      qlens[one].contiguous())
            assert torch.equal(alone, got[0][one]), (kind, row)


@pytest.mark.gpu
def test_ragged_chunk_independence_on_card(cuda_device, monkeypatch):
    """One 700-token prompt through the ragged kernel as one chunk and as
    chunks of 100 + 600 and 333 + 367, each in a batch with other rows
    and a C of its own: equal bits at every position (bf16, int8 and
    fp32 pools)."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    chip_smoke.check_chunk_independence(cuda_device, H=4, D=128)


@pytest.mark.gpu
def test_serving_composition_on_card(cuda_device):
    """The serving composition on the card against the reference
    composition (plain window attention for chunk rows, the same decode
    and verify kernels): allclose in bf16, decode and verify rows
    bit-equal, one ragged launch a call."""
    rs = np.random.RandomState(4)
    b, h, d, page, max_pages, c, w = 6, 4, 128, 16, 12, 70, 5
    num_pages = b * max_pages + 1
    k = torch.tensor(rs.randn(num_pages, h, page, d).astype(np.float32),
                     device=cuda_device).to(torch.bfloat16)
    v = torch.tensor(rs.randn(num_pages, h, page, d).astype(np.float32),
                     device=cuda_device).to(torch.bfloat16)
    tables = torch.tensor(rs.permutation(num_pages)[:b * max_pages].reshape(
        b, max_pages).astype(np.int32), device=cuda_device)
    ctx = torch.tensor([0, 40, 100, 7, 150, 0], dtype=torch.int32,
                       device=cuda_device)
    qlens = torch.tensor([70, 33, 1, 4, 2, 0], dtype=torch.int32,
                         device=cuda_device)
    verify = torch.tensor([False, False, False, True, True, False],
                          device=cuda_device)
    q = torch.tensor(rs.randn(b, c, h, d).astype(np.float32),
                     device=cuda_device).to(torch.bfloat16)
    before = RPA._RAGGED.launches
    got = RPA.ragged_paged_attention(q, k, v, tables, ctx, qlens,
                                     verify_rows=verify, verify_window=w)
    assert RPA._RAGGED.launches == before + 1
    want = RPA._ragged_reference(q, k, v, tables, ctx, qlens,
                                 verify_rows=verify, verify_window=w)
    torch.cuda.synchronize()
    valid = torch.arange(c, device=cuda_device)[None] < qlens[:, None]
    torch.testing.assert_close(got.float()[valid], want.float()[valid],
                               atol=1e-2, rtol=1e-2)
    assert torch.equal(got[2, 0], want[2, 0])
    assert torch.equal(got[3:5, :w], want[3:5, :w])
    assert torch.isfinite(got.float()).all()
