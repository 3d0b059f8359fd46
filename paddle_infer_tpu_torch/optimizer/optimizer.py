"""Optimizers: ``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adagrad``,
``RMSProp``, ``Lamb``, ``Lars``, ``Adadelta`` and ``Adamax``.

Port of ``paddle_infer_tpu/optimizer/optimizer.py``.  The JAX package
defines each optimizer by a pure rule that its compiled train step calls
on whole pytrees (``functional_update``) and its eager ``step()`` calls
per parameter; here ``_update`` keeps the rule and its order of
operations but updates the parameter and slot tensors in place under
``no_grad``, so no second copy of the model's state is made.

Order, as the reference: the gradient clip over all gradients
(``grad_clip``), then per parameter the gradient cast to its dtype, L2
decay folded into it (``weight_decay`` as a float or ``L2Decay``, for
the optimizers that do not decouple it), L1 decay as ``coeff *
sign(p)`` (``L1Decay``, skipped where a decay exclusion names the
parameter), then the rule; AdamW, Lamb and Lars take their decay inside
the rule (``wd = 0`` for an excluded parameter).  ``multi_precision``
keeps a float32 master copy of every non-float32 parameter (Adam,
AdamW).  Scalars enter each product in the operand's dtype, as JAX's
weakly typed Python scalars do.  ``lr`` and ``step`` may be device
scalars (a CUDA graph of the train step reads them from buffers written
before each replay); every constant is filled on the device, so an
update copies nothing from the host.  ``learning_rate`` may be an
``lr.LRScheduler``: ``get_lr()`` reads it, and the train step ticks it.

The eager ``step()`` names a parameter by the name it was given with
(``parameters=model.named_parameters()``, the names ``functional_update``
sees), or "" (a bare tensor); the reference's eager names are its
layers' ``"{layer}.{attr}"``.  ``lr_ratio`` is refused: the reference
accepts it and ignores it (ROADMAP.md §3).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .lr import LRScheduler


def _s(x, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar in ``like``'s dtype (JAX's weak typing)."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _f32(x, device) -> torch.Tensor:
    """A float32 scalar on ``device``: a tensor is cast (not read back),
    a Python number filled."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(sum(x * x))`` over every element, float32."""
    return torch.sqrt(torch.sum(x * x))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        self._lr = learning_rate
        self._parameters: List[torch.Tensor] = []
        self._names: Dict[int, str] = {}
        for item in parameters or ():
            name, p = item if isinstance(item, tuple) else ("", item)
            self._parameters.append(p)
            self._names[id(p)] = name
        # regularizer objects are normalized here; plain floats mean L2
        self._l1_decay = 0.0
        if weight_decay is not None and hasattr(weight_decay, "coeff"):
            from ..regularizer import L1Decay

            if isinstance(weight_decay, L1Decay):
                self._l1_decay = float(weight_decay.coeff)
                weight_decay = 0.0
            else:
                weight_decay = float(weight_decay.coeff)
        self._weight_decay = float(weight_decay or 0.0)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._state: Dict[int, dict] = {}
        self._step_count = 0

    # lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, lr: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = lr

    @property
    def parameters(self):
        return self._parameters

    # rule ----------------------------------------------------------------
    def _init_state(self, param: torch.Tensor, name: str = "") -> dict:
        return {}

    def _update(self, param, grad, state, lr, step, wd):
        raise NotImplementedError

    def _decay_into_grad(self) -> bool:
        """L2 decay folded into the gradient; the optimizers with a
        decoupled decay (AdamW, Lamb, Lars) override."""
        return True

    def _param_weight_decay(self, param) -> float:
        """Per-parameter decoupled decay of the eager step (0 when
        excluded)."""
        return self._weight_decay

    def _named_weight_decay(self, name: str) -> float:
        return self._weight_decay

    def _decay_excluded(self, param) -> bool:
        """Whether the eager step excludes ``param`` from every decay
        (L1 too)."""
        return False

    def _named_decay_excluded(self, name: str) -> bool:
        return False

    def _name(self, param) -> str:
        return self._names.get(id(param), "")

    def _grad_in(self, param, grad):
        """The gradient in the parameter's dtype (None: a zero gradient)
        with L2 decay folded in where the optimizer does not decouple
        it."""
        g = torch.zeros_like(param) if grad is None else grad.to(param.dtype)
        if self._weight_decay and self._decay_into_grad():
            g = g + _s(self._weight_decay, param) * param
        return g

    def _l1(self, param, g):
        return g + _s(self._l1_decay, param) * torch.sign(param)

    # eager step ------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient (the eager
        loop: ``loss.backward(); opt.step(); opt.clear_grad()``)."""
        self._step_count += 1
        lr = self.get_lr()
        pg = [(p, p.grad) for p in self._parameters
              if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
            for p, g in pg:
                p.grad = g
        for p, g in pg:
            st = self._state.get(id(p))
            if st is None:
                st = self._state[id(p)] = self._init_state(p, self._name(p))
            g = self._grad_in(p, g)
            if self._l1_decay and not self._decay_excluded(p):
                g = self._l1(p, g)
            plr = lr * getattr(p, "optimize_attr", {}).get("learning_rate",
                                                           1.0)
            wd = 0.0 if self._decay_into_grad() else \
                self._param_weight_decay(p)
            self._update(p, g, st, _f32(plr, p.device),
                         _f32(self._step_count, p.device),
                         _f32(wd, p.device))

    def clear_grad(self):
        for p in self._parameters:
            p.grad = None

    clear_gradients = clear_grad

    # state dict -----------------------------------------------------------
    def state_dict(self):
        """``{"step", "states": [(index, {slot: CPU tensor})], "lr"}``,
        the scheduler's state under ``lr``."""
        out = {"step": self._step_count, "states": []}
        for i, p in enumerate(self._parameters):
            st = self._state.get(id(p))
            if st is not None:
                out["states"].append(
                    (i, {k: v.detach().cpu().clone() for k, v in st.items()}))
        if isinstance(self._lr, LRScheduler):
            out["lr"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state):
        self._step_count = state.get("step", 0)
        for i, st in state.get("states", []):
            p = self._parameters[i]
            self._state[id(p)] = {
                k: torch.as_tensor(v).to(p.device).clone()
                for k, v in st.items()}
        if "lr" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["lr"])

    # functional bridge ---------------------------------------------------
    def functional_init(self, params: Dict[str, torch.Tensor]) -> dict:
        """``{name: param}`` → ``{name: {slot: tensor}}``."""
        return {n: self._init_state(p.detach(), n) for n, p in params.items()}

    @torch.no_grad()
    def functional_update(self, params, grads, state, lr=None, step=0):
        """One update of every ``params[n]`` from ``grads[n]`` (None: a
        zero gradient) and ``state[n]``, in place; returns ``(params,
        state)``.  ``step`` is the 1-based step count of the bias
        correction; it and ``lr`` may be Python numbers or device
        scalars."""
        lr = self.get_lr() if lr is None else lr
        if self._grad_clip is not None:
            grads = self._grad_clip.functional_clip(grads)
        dev = {}                        # per device: (lr, step) float32
        for n, p in params.items():
            if p.device not in dev:
                dev[p.device] = (_f32(lr, p.device), _f32(step, p.device))
            lr_d, step_d = dev[p.device]
            g = self._grad_in(p, grads.get(n))
            if self._l1_decay and not self._named_decay_excluded(n):
                g = self._l1(p, g)
            wd = 0.0 if self._decay_into_grad() else \
                self._named_weight_decay(n)
            self._update(p, g, state[n], lr_d, step_d, _f32(wd, p.device))
        return params, state


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _update(self, param, grad, state, lr, step, wd):
        param.copy_(param - lr.to(param.dtype) * grad)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None):
        self._momentum = momentum
        self._nesterov = use_nesterov
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p, name=""):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, param, grad, state, lr, step, wd):
        v = state["velocity"]
        v.copy_(_s(self._momentum, v) * v + grad)
        upd = grad + _s(self._momentum, v) * v if self._nesterov else v
        param.copy_(param - lr.to(param.dtype) * upd)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False):
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _init_state(self, p, name=""):
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
            raise NotImplementedError(
                "AdamW(lr_ratio=...): the reference accepts lr_ratio and "
                "ignores it, so the port refuses it rather than ignore it "
                "too (ROADMAP.md §3)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_into_grad(self):
        return False

    def _named_decay_excluded(self, name):
        return (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(name))

    def _decay_excluded(self, param):
        return self._named_decay_excluded(self._name(param))

    def _named_weight_decay(self, name):
        return 0.0 if self._named_decay_excluded(name) else \
            self._weight_decay

    def _param_weight_decay(self, param):
        return self._named_weight_decay(self._name(param))

    def _update(self, param, grad, state, lr, step, wd):
        # decoupled weight decay first (wd = 0 skips it per parameter)
        master = state.get("master")
        work = master if master is not None else param
        work.mul_(1 - lr.to(work.dtype) * wd.to(work.dtype))
        self._adam(param, work, grad, state, lr, step)


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0):
        self._eps = epsilon
        self._init_acc = initial_accumulator_value
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p, name=""):
        return {"moment": torch.full_like(p, self._init_acc)}

    def _update(self, param, grad, state, lr, step, wd):
        mom = state["moment"]
        mom.copy_(mom + grad * grad)
        param.copy_(param - lr.to(param.dtype) * grad /
                    (torch.sqrt(mom) + _s(self._eps, mom)))


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None):
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p, name=""):
        st = {"mean_square": torch.zeros_like(p),
              "momentum": torch.zeros_like(p)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(p)
        return st

    def _update(self, param, grad, state, lr, step, wd):
        rho = self._rho
        ms = state["mean_square"]
        ms.copy_(_s(rho, ms) * ms + _s(1 - rho, grad) * grad * grad)
        if self._centered:
            mg = state["mean_grad"]
            mg.copy_(_s(rho, mg) * mg + _s(1 - rho, grad) * grad)
            denom = torch.sqrt(ms - mg * mg + _s(self._eps, ms))
        else:
            denom = torch.sqrt(ms + _s(self._eps, ms))
        mom = state["momentum"]
        mom.copy_(_s(self._momentum, mom) * mom
                  + lr.to(param.dtype) * grad / denom)
        param.copy_(param - mom)


class Lamb(Optimizer):
    """LAMB: Adam's direction plus decay, scaled per parameter by the
    trust ratio ``||w|| / ||r||``."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None):
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn
        super().__init__(learning_rate, parameters, None, grad_clip)

    def _init_state(self, p, name=""):
        return {"m": torch.zeros_like(p, dtype=torch.float32),
                "v": torch.zeros_like(p, dtype=torch.float32)}

    def _decay_into_grad(self):
        return False

    def _param_weight_decay(self, param):
        if self._exclude_fn is not None and self._exclude_fn(param):
            return 0.0
        return float(self._lamb_decay)

    def _named_weight_decay(self, name):
        # the reference's compiled path applies the decay to every
        # parameter (its exclusion function takes a parameter object)
        return float(self._lamb_decay)

    def _update(self, param, grad, state, lr, step, wd):
        b1, b2 = self._beta1, self._beta2
        g = grad.float()
        p32 = param.float()
        m, v = state["m"], state["v"]
        m.copy_(_s(b1, m) * m + _s(1 - b1, g) * g)
        v.copy_(_s(b2, v) * v + _s(1 - b2, g) * g * g)
        mhat = m / (1 - _f32(b1, m.device) ** step)
        vhat = v / (1 - _f32(b2, m.device) ** step)
        r = mhat / (torch.sqrt(vhat) + _s(self._eps, vhat)) + wd * p32
        w_norm, r_norm = _norm(p32), _norm(r)
        one = torch.ones((), dtype=torch.float32, device=param.device)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            one)
        param.copy_((p32 - lr * trust * r).to(param.dtype))


class Lars(Optimizer):
    """LARS momentum: the learning rate scaled per parameter by
    ``coeff * ||w|| / (||g|| + wd * ||w|| + eps)``; parameters whose name
    contains a pattern of ``exclude_from_weight_decay`` take plain
    momentum with no decay (the flag travels in the state, as in the
    reference)."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, epsilon=1e-8,
                 exclude_from_weight_decay=None):
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon
        self._exclude = tuple(exclude_from_weight_decay or ())
        super().__init__(learning_rate, parameters, None, grad_clip)

    def _excluded(self, name: str) -> bool:
        return any(pat in name for pat in self._exclude)

    def _init_state(self, p, name=""):
        return {"velocity": torch.zeros_like(p),
                "lars_on": torch.full((), 0.0 if self._excluded(name)
                                      else 1.0, dtype=torch.float32,
                                      device=p.device)}

    def _param_weight_decay(self, param) -> float:
        return self._named_weight_decay(self._name(param))

    def _named_weight_decay(self, name: str) -> float:
        return 0.0 if self._excluded(name) else self._lars_wd

    def _decay_into_grad(self):
        return False

    def _update(self, param, grad, state, lr, step, wd):
        g32 = grad.float()
        p32 = param.float()
        p_norm, g_norm = _norm(p32), _norm(g32)
        one = torch.ones((), dtype=torch.float32, device=param.device)
        denom = g_norm + wd * p_norm + self._eps
        ratio = torch.where(p_norm > 0.0,
                            self._lars_coeff * p_norm / denom, one)
        lars_on = state.get("lars_on")
        if lars_on is not None:
            ratio = torch.where(lars_on > 0.0, ratio, one)
        local_lr = lr * ratio
        vel = state["velocity"]
        v = _s(self._momentum, p32) * vel.float() + local_lr * (g32
                                                               + wd * p32)
        vel.copy_(v.to(vel.dtype))
        param.copy_((p32 - v).to(param.dtype))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None):
        self._eps, self._rho = epsilon, rho
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p, name=""):
        return {"avg_sq_grad": torch.zeros_like(p),
                "avg_sq_update": torch.zeros_like(p)}

    def _update(self, param, grad, state, lr, step, wd):
        rho, eps = self._rho, self._eps
        asg, asu = state["avg_sq_grad"], state["avg_sq_update"]
        asg.copy_(_s(rho, asg) * asg + _s(1 - rho, grad) * grad * grad)
        upd = (torch.sqrt(asu + _s(eps, asu)) /
               torch.sqrt(asg + _s(eps, asg))) * grad
        asu.copy_(_s(rho, asu) * asu + _s(1 - rho, upd) * upd * upd)
        param.copy_(param - lr.to(param.dtype) * upd)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p, name=""):
        return {"m": torch.zeros_like(p), "u": torch.zeros_like(p)}

    def _update(self, param, grad, state, lr, step, wd):
        b1, b2 = self._beta1, self._beta2
        m, u = state["m"], state["u"]
        m.copy_(_s(b1, m) * m + _s(1 - b1, grad) * grad)
        u.copy_(torch.maximum(_s(b2, u) * u, torch.abs(grad)))
        lr_t = (lr / (1 - _f32(b1, lr.device) ** step)).to(param.dtype)
        param.copy_(param - lr_t * m / (u + _s(self._eps, u)))
