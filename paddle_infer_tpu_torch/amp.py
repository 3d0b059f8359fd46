"""Automatic mixed precision, level O2, as an explicit compute dtype.

Port of the O2 rule of ``paddle_infer_tpu/core/dispatch.py``
(``_amp_cast_arrays`` with its ``AMP_BLACK_OPS``): parameters stay float32
and are cast to the compute dtype where they are used, every float op
computes in that dtype (bf16), the black-listed ops (exp, log, softmax,
cross-entropy's reductions, mean, sum, norm, logsumexp, erf) compute in
float32, and LayerNorm keeps float32 statistics with bf16 in and out.

The JAX package applies the rule inside its op dispatcher; the port's
modules apply it themselves, calling ``cast`` on the float operands of
an op that computes in the compute dtype and ``black`` on those of a
black-listed op.  Outside ``amp_scope`` both return their input, so the
serving models keep their own dtype.  O1 (white lists) waits for
``amp.auto_cast`` (ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def compute_dtype():
    """The O2 compute dtype, or None outside ``amp_scope``."""
    return getattr(_state, "dtype", None)


@contextlib.contextmanager
def amp_scope(enabled=True, dtype=torch.bfloat16, level="O2"):
    """Run the enclosed forward under the O2 rule in ``dtype``."""
    if enabled and level != "O2":
        raise NotImplementedError(
            f"AMP level {level!r}: only O2 is ported (O1 and auto_cast wait; "
            "see ROADMAP.md)")
    prev = compute_dtype()
    _state.dtype = dtype if enabled else None
    try:
        yield
    finally:
        _state.dtype = prev


def cast(x):
    """A float tensor in the compute dtype (an op under the O2 rule);
    anything else, or anything outside ``amp_scope``, unchanged."""
    dt = compute_dtype()
    if dt is None or x is None or not torch.is_floating_point(x):
        return x
    return x.to(dt)


def black(x):
    """A float tensor in float32 (a black-listed op's operand) under
    ``amp_scope``; unchanged outside it."""
    if compute_dtype() is None or x is None or not torch.is_floating_point(x):
        return x
    return x.float()
