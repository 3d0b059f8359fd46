"""The port stands alone and never falls back.

* No module of ``paddle_infer_tpu_torch`` and not ``chip_smoke.py``
  imports ``jax`` or the JAX package (``paddle_infer_tpu`` — matched
  with the dot, since ``paddle_infer_tpu_torch`` shares its prefix).
* Importing the port leaves ``jax`` out of ``sys.modules``.
* A CUDA tensor reaching a kernel wrapper without a card raises; it
  never takes the plain version.  Fake CUDA tensors (no storage) stand
  in for real ones here.
* On a card (``gpu`` marker; skipped without one) each kernel agrees
  with its plain version at a small shape (the flash kernels too).
"""
import ast
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_infer_tpu_torch import default_device
from paddle_infer_tpu_torch.ops import paged_attention as PA
from paddle_infer_tpu_torch.ops import ragged_paged_attention as RPA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_infer_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, files in os.walk(PKG):
        dirs[:] = [x for x in dirs if x != "_build"]    # build outputs
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return any(name == m or name.startswith(m + ".")
               for m in ("jax", "jaxlib", "paddle_infer_tpu"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_prefix_rule_tells_the_packages_apart():
    assert _forbidden("paddle_infer_tpu.ops")
    assert _forbidden("jax.numpy")
    assert not _forbidden("paddle_infer_tpu_torch.ops")


def test_importing_the_port_loads_no_jax():
    # modules a site hook may have loaded before the import do not count
    code = ("import sys; before = set(sys.modules); "
            "import paddle_infer_tpu_torch.serving, "
            "paddle_infer_tpu_torch.models, paddle_infer_tpu_torch.weights, "
            "paddle_infer_tpu_torch.parallel, "
            "paddle_infer_tpu_torch.optimizer; "
            "bad = [m for m in set(sys.modules) - before if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_infer_tpu' or "
            "m.startswith('paddle_infer_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _fake_cuda(shapes, dtypes):
    with FakeTensorMode(allow_non_fake_inputs=True):
        return [torch.zeros(s, dtype=d, device="cuda")
                for s, d in zip(shapes, dtypes)]


def test_decode_wrapper_raises_on_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q, k, v, t, ln = _fake_cuda(
        [(2, 4, 32), (5, 4, 8, 32), (5, 4, 8, 32), (2, 3), (2,)],
        [torch.float32] * 3 + [torch.int32] * 2)
    before = PA._DECODE.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        PA.paged_attention_decode(q, k, v, t, ln)
    assert PA._DECODE.launches == before


def test_ragged_wrapper_raises_on_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q, k, v, t, c, ql = _fake_cuda(
        [(2, 6, 4, 32), (5, 4, 8, 32), (5, 4, 8, 32), (2, 3), (2,), (2,)],
        [torch.float32] * 3 + [torch.int32] * 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        RPA.ragged_paged_attention(q, k, v, t, c, ql, use_kernel=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        RPA.ragged_kernel(q, k, v, t, c, ql)


def test_verify_wrapper_raises_on_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q, k, v, t, ln = _fake_cuda(
        [(2, 5, 4, 32), (5, 4, 8, 32), (5, 4, 8, 32), (2, 3), (2, 5)],
        [torch.float32] * 3 + [torch.int32] * 2)
    before = PA._VERIFY.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        PA.paged_attention_verify(q, k, v, t, ln)
    assert PA._VERIFY.launches == before


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda_device, monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    case = chip_smoke.make_case(cuda_device, B=4, H=4, D=128, page=16,
                                max_pages=8, C=32)
    chip_smoke.check_kernels(case, timed=False)


@pytest.mark.gpu
def test_verify_kernel_lanes_equal_decode_on_card(cuda_device, monkeypatch):
    """Each verify lane EQUAL to the decode kernel at its length, and
    allclose to the plain version, for W = 5 and W = 11 (two lane
    groups)."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    for w in (5, 11):
        case = chip_smoke.make_case(cuda_device, B=4, H=4, D=128, page=16,
                                    max_pages=8, C=32, W=w)
        chip_smoke.check_verify(case, timed=False)


@pytest.mark.gpu
def test_flash_kernels_match_plain_on_card(cuda_device, monkeypatch):
    """Forward, dK/dV and dQ against their plain versions, fp32 and bf16,
    with and without dropout, at shapes with ragged tile tails (S = 100,
    160, 192, 200), a causal Sq < Sk case and head_dim 64, 128 and
    256."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    shapes = {"s": dict(B=2, H=2, Sq=192, Sk=192, D=64, causal=False,
                        pad=20),
              "c": dict(B=1, H=2, Sq=100, Sk=160, D=128, causal=True,
                        pad=0),
              "w": dict(B=2, H=2, Sq=200, Sk=200, D=256, causal=True,
                        pad=30)}
    runs = tuple((t, kind, p) for t in shapes for kind in ("fp32", "bf16")
                 for p in (0.0, 0.1))
    chip_smoke.flash_kernels_phase(cuda_device, shapes, runs, ())
