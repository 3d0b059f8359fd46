"""Optimizers: ``Adam`` and ``AdamW``.

Port of ``paddle_infer_tpu/optimizer/optimizer.py`` (``Optimizer``,
``Adam``, ``AdamW``).  The JAX package defines each optimizer by a pure
rule that its compiled train step calls on whole pytrees
(``functional_update``); here ``functional_update`` keeps the rule and
its order of operations but updates the parameter and slot tensors in
place under ``no_grad``, so no second copy of the model's state is made.

Order, as the reference: AdamW's decoupled decay ``w * (1 - lr * wd)``
first (``wd = 0`` for a parameter ``apply_decay_param_fun`` excludes),
then the Adam step with bias correction at step ``t``; Adam's own
``weight_decay`` is L2 folded into the gradient.  ``multi_precision``
keeps a float32 master copy of every non-float32 parameter.  Scalars
enter each product in the operand's dtype, as JAX's weakly typed Python
scalars do.  ``lr`` and ``step`` may be device scalars (a CUDA graph of
the train step reads them from buffers written before each replay);
every constant is filled on the device, so an update copies nothing from
the host.  Gradient clipping and LR schedulers are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

import torch


def _s(x, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar in ``like``'s dtype (JAX's weak typing)."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _f32(x, device) -> torch.Tensor:
    """A float32 scalar on ``device``: a tensor is cast (not read back),
    a Python number filled."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if grad_clip is not None:
            raise NotImplementedError(
                "gradient clipping (optimizer/clip.py) is not ported yet; "
                "see ROADMAP.md")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "LR schedulers (optimizer/lr.py) are not ported yet; see "
                "ROADMAP.md")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError(
                "regularizer objects are not ported yet; see ROADMAP.md")
        self._lr = float(learning_rate)
        self._parameters = list(parameters) if parameters else []
        self._weight_decay = float(weight_decay or 0.0)
        self._multi_precision = multi_precision

    def get_lr(self) -> float:
        return self._lr

    # rule ----------------------------------------------------------------
    def _init_state(self, param: torch.Tensor) -> dict:
        return {}

    def _update(self, param, grad, state, lr, step, wd):
        raise NotImplementedError

    def _decay_into_grad(self) -> bool:
        """L2 decay folded into the gradient (Adam); AdamW decouples."""
        return True

    def _named_weight_decay(self, name: str) -> float:
        return self._weight_decay

    # functional bridge ---------------------------------------------------
    def functional_init(self, params: Dict[str, torch.Tensor]) -> dict:
        """``{name: param}`` → ``{name: {slot: tensor}}``."""
        return {n: self._init_state(p.detach()) for n, p in params.items()}

    @torch.no_grad()
    def functional_update(self, params, grads, state, lr=None, step=0):
        """One update of every ``params[n]`` from ``grads[n]`` (None: a
        zero gradient) and ``state[n]``, in place; returns ``(params,
        state)``.  ``step`` is the 1-based step count of the bias
        correction; it and ``lr`` may be Python numbers or device
        scalars."""
        lr = self.get_lr() if lr is None else lr
        dev = {}                        # per device: (lr, step) float32
        for n, p in params.items():
            if p.device not in dev:
                dev[p.device] = (_f32(lr, p.device), _f32(step, p.device))
            lr_d, step_d = dev[p.device]
            g = grads.get(n)
            g = torch.zeros_like(p) if g is None else g.to(p.dtype)
            if self._weight_decay and self._decay_into_grad():
                g = g + _s(self._weight_decay, p) * p
            wd = 0.0 if self._decay_into_grad() else \
                self._named_weight_decay(n)
            self._update(p, g, state[n], lr_d, step_d, _f32(wd, p.device))
        return params, state


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False):
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _init_state(self, p):
        dt = torch.float32 if self._multi_precision else p.dtype
        st = {"m": torch.zeros(p.shape, dtype=dt, device=p.device),
              "v": torch.zeros(p.shape, dtype=dt, device=p.device)}
        if self._multi_precision and p.dtype != torch.float32:
            st["master"] = p.float().clone()
        return st

    def _adam(self, param, work, grad, state, lr, step):
        """The Adam step on ``work`` (the parameter or its master), in
        place; a master's new value is copied into the parameter."""
        b1, b2, eps = self._beta1, self._beta2, self._eps
        m, v = state["m"], state["v"]
        g = grad.to(work.dtype)
        m.copy_(_s(b1, m) * m + _s(1 - b1, g) * g)
        v.copy_(_s(b2, v) * v + _s(1 - b2, g) * (g * g))
        mhat = m / (1 - _f32(b1, m.device) ** step)
        vhat = v / (1 - _f32(b2, m.device) ** step)
        work.copy_(work - lr.to(work.dtype) * mhat / (torch.sqrt(vhat)
                                                      + _s(eps, vhat)))
        if work is not param:
            param.copy_(work)

    def _update(self, param, grad, state, lr, step, wd):
        master = state.get("master")
        self._adam(param, master if master is not None else param, grad,
                   state, lr, step)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, lr_ratio=None, apply_decay_param_fun=None,
                 multi_precision=False):
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported yet; see "
                                      "ROADMAP.md")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_into_grad(self):
        return False

    def _named_weight_decay(self, name):
        if self._apply_decay_param_fun is not None \
                and not self._apply_decay_param_fun(name):
            return 0.0
        return self._weight_decay

    def _update(self, param, grad, state, lr, step, wd):
        # decoupled weight decay first (wd = 0 skips it per parameter)
        master = state.get("master")
        work = master if master is not None else param
        work.mul_(1 - lr.to(work.dtype) * wd.to(work.dtype))
        self._adam(param, work, grad, state, lr, step)
