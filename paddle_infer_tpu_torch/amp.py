"""Automatic mixed precision: the O1 and O2 rules, ``auto_cast``,
``decorate`` and ``GradScaler``.

Port of the AMP rule of ``paddle_infer_tpu/core/dispatch.py``
(``AMP_WHITE_OPS``, ``AMP_BLACK_OPS``, ``_amp_cast_arrays``) and of
``paddle_infer_tpu/amp/__init__.py``.  The JAX package applies the rule
inside its op dispatcher; the port's modules apply it themselves: every
float operand of an op goes through ``cast(x, op)``, where ``op`` is the
name of the reference's dispatch op at that site (``linear`` is
``matmul`` then ``add``).  Under the rule a black-listed op computes in
float32; under O1 a white-listed op (``matmul``, ``sdpa``, ...) computes
in the low dtype and every other op keeps its operands' dtypes, so the
usual promotion applies (a bf16 product plus a float32 bias is float32);
under O2 every other op computes in the low dtype too.  Outside
``amp_scope`` / ``auto_cast`` ``cast`` returns its input, so the serving
models keep their own dtype.

``GradScaler`` keeps the reference's dynamic loss scaling and its
good / bad step counters; ``unscale_`` reads one flag back from the
device per call (the reference reads one per parameter).
"""
from __future__ import annotations

import contextlib
import threading

import torch

# the reference's op lists (``paddle_infer_tpu/core/dispatch.py``)
AMP_WHITE_OPS = {
    "matmul", "conv2d", "conv2d_transpose", "einsum", "bmm", "mm",
    "flash_attention", "sdpa", "depthwise_conv2d", "addmm",
}
AMP_BLACK_OPS = {
    "exp", "log", "softmax", "log_softmax", "cross_entropy",
    "mean", "sum", "norm",
    "batch_norm", "cumsum", "pow", "rsqrt",
    "sigmoid_cross_entropy_with_logits", "erf", "logsumexp",
}
white_list = AMP_WHITE_OPS
black_list = AMP_BLACK_OPS

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_state = threading.local()


def _dtype(dtype) -> torch.dtype:
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def compute_dtype():
    """The low dtype of the current rule, or None outside it."""
    return getattr(_state, "dtype", None)


@contextlib.contextmanager
def amp_scope(enabled=True, dtype=torch.bfloat16, level="O2"):
    """Run the enclosed forward under the ``level`` rule in ``dtype``
    (``torch.bfloat16`` / ``torch.float16`` or their names)."""
    if enabled and level not in ("O1", "O2"):
        raise ValueError(f"AMP level {level!r}: O1 or O2")
    prev = (compute_dtype(), getattr(_state, "level", None))
    _state.dtype = _dtype(dtype) if enabled else None
    _state.level = level
    try:
        yield
    finally:
        _state.dtype, _state.level = prev


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """``paddle.amp.auto_cast``: the rule at ``level`` in ``dtype``, with
    ops added to the white and black lists while open (removed on
    exit)."""
    added_w = {op for op in custom_white_list or () if op not in
               AMP_WHITE_OPS}
    added_b = {op for op in custom_black_list or () if op not in
               AMP_BLACK_OPS}
    AMP_WHITE_OPS.update(added_w)
    AMP_BLACK_OPS.update(added_b)
    try:
        with amp_scope(enable, dtype, level):
            yield
    finally:
        AMP_WHITE_OPS.difference_update(added_w)
        AMP_BLACK_OPS.difference_update(added_b)


amp_guard = auto_cast


def cast(x, op):
    """Operand ``x`` of the reference's dispatch op ``op`` under the
    current rule (``_amp_cast_arrays``): float32 for a black-listed op,
    the low dtype for a white-listed one (for every op at O2), else
    unchanged; non-float values and anything outside the rule pass
    through."""
    dt = compute_dtype()
    if dt is None or x is None or not torch.is_floating_point(x):
        return x
    if op in AMP_BLACK_OPS:
        return x.float()
    if op in AMP_WHITE_OPS or _state.level == "O2":
        return x.to(dt)
    return x


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' parameters to the low dtype and give the
    optimizers float32 master weights (``multi_precision``); O1 returns
    its arguments unchanged."""
    if level == "O1":
        return (models, optimizers) if optimizers is not None else models
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for m in model_list:
        m.to(dtype=_dtype(dtype))
    if optimizers is None:
        return model_list[0] if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    for opt in opt_list:
        opt._multi_precision = True
    return (model_list[0] if single else model_list,
            opt_list[0] if opt_single else opt_list)


class GradScaler:
    """Dynamic loss scaling (``amp/grad_scaler.py`` of the reference):
    ``scale`` multiplies the loss by the scale; ``step`` unscales the
    optimizer's gradients to float32 values and skips the update when
    any is not finite; ``update`` halves the scale after
    ``decr_every_n_nan_or_inf`` bad steps in a row (never below 1) and
    doubles it after ``incr_every_n_steps`` good ones.

    A parameter of a 16-bit dtype keeps its unscaled gradient in its own
    dtype (PyTorch holds a gradient in its parameter's dtype), where the
    reference keeps a float32 one; the optimizer casts the gradient to
    the parameter's dtype before using it in both, so only a clip
    between ``unscale_`` and the update sees the rounding."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return cast(loss, "scale") * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Every gradient times 1 / scale (in float32), and whether any
        is not finite: one flag per gradient reduced on the device, one
        read back."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        finite = []
        for p in optimizer._parameters:
            if p.grad is None:
                continue
            g = p.grad.float() * inv
            finite.append(torch.isfinite(g).all())
            if p.grad.dtype == torch.float32:
                p.grad.copy_(g)
            else:
                p.grad = g.to(p.grad.dtype)
        self._found_inf = bool(finite) and \
            not bool(torch.stack(finite).all())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good": self._good_steps,
                "bad": self._bad_steps}

    def set_state_dict(self, st):
        self._scale = st.get("scale", self._scale)
        self._good_steps = st.get("good", 0)
        self._bad_steps = st.get("bad", 0)
