"""Port parity: the training recipe's host pieces of ``paddle_infer_tpu_torch``
against the JAX package — LR schedulers, optimizers and regularizers,
gradient clipping, ``GradScaler``, ``auto_cast`` and ``decorate``.

* Each scheduler's learning rate over 30 steps equals JAX's within 1e-12
  relative (both are host Python float math), and its state dict
  restores the sequence.
* Each optimizer and regularizer over three ``functional_update`` calls
  and, separately, three eager ``step()`` calls lies within atol / rtol
  1e-6 of JAX's, parameters and slots, as
  ``test_adamw_functional_update_matches_jax`` holds AdamW.
* Each clip within 1e-6 of JAX's, functional and eager (``need_clip``).
* ``GradScaler`` over a run with one inf gradient: found-inf flags,
  scales, counters and parameters equal JAX's.

Inputs come from numpy seeds; parameters are named alike on both sides
(the port takes ``(name, tensor)`` pairs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_infer_tpu as pit
from paddle_infer_tpu import amp as jamp
from paddle_infer_tpu import regularizer as jreg
from paddle_infer_tpu.core.tensor import Parameter as JParameter
from paddle_infer_tpu.optimizer import lr as jlr
from paddle_infer_tpu_torch import amp as tamp
from paddle_infer_tpu_torch import optimizer as topt
from paddle_infer_tpu_torch import regularizer as treg
from paddle_infer_tpu_torch.optimizer import lr as tlr

# ------------------------------------------------------------- schedulers

SCHEDULERS = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                  learning_rate=1.0),
    "piecewise": lambda m: m.PiecewiseDecay([5, 12, 20],
                                            [0.1, 0.05, 0.01, 0.001]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, gamma=0.1),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, gamma=0.2),
    "polynomial": lambda m: m.PolynomialDecay(0.1, 20, end_lr=0.001,
                                              power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(0.1, 7, end_lr=0.001,
                                                    cycle=True),
    "linear_warmup": lambda m: m.LinearWarmup(
        m.PolynomialDecay(0.1, 20, end_lr=0.0), warmup_steps=6,
        start_lr=0.0, end_lr=0.1),
    "linear_warmup_float": lambda m: m.LinearWarmup(0.05, 6, 0.0, 0.1),
    "exponential": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "multistep": lambda m: m.MultiStepDecay(0.1, [5, 15], gamma=0.5),
    "step": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.5),
    "lambda": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "cosine": lambda m: m.CosineAnnealingDecay(0.1, T_max=20,
                                               eta_min=0.001),
    "one_cycle": lambda m: m.OneCycleLR(0.1, total_steps=30),
    "multiplicative": lambda m: m.MultiplicativeDecay(0.1, lambda e: 0.9),
    "cyclic": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4),
    "cyclic2": lambda m: m.CyclicLR(0.01, 0.1, 3, 5, mode="triangular2"),
    "cyclic_exp": lambda m: m.CyclicLR(0.01, 0.1, 4, mode="exp_range",
                                       exp_gamma=0.9),
    "plateau": lambda m: m.ReduceOnPlateau(0.1, factor=0.5, patience=2,
                                           cooldown=1),
}
# the metric sequence ReduceOnPlateau steps on: better, flat, worse
METRICS = [1.0, 0.9, 0.8, 0.8, 0.85, 0.9, 0.79, 0.8, 0.81, 0.82, 0.83,
           0.6, 0.61, 0.62, 0.63, 0.64, 0.65, 0.5, 0.5, 0.5, 0.5, 0.5,
           0.4, 0.41, 0.42, 0.43, 0.44, 0.45, 0.46, 0.47]


def _tick(s, i):
    if isinstance(s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        s.step(METRICS[i])
    else:
        s.step()


def _run(s, n, start=0):
    out = []
    for i in range(start, start + n):
        out.append(s())
        _tick(s, i)
    return out


def _same(got, want):
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-12 * max(abs(w), 1e-30), (g, w)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax_and_round_trips(name):
    want = _run(SCHEDULERS[name](jlr), 30)
    got = _run(SCHEDULERS[name](tlr), 30)
    _same(got, want)
    a = SCHEDULERS[name](tlr)
    _run(a, 12)
    b = SCHEDULERS[name](tlr)
    b.set_state_dict(a.state_dict())
    _same(_run(b, 18, start=12), want[12:])


def test_sixteen_scheduler_classes():
    names = {n for n in vars(jlr) if isinstance(getattr(jlr, n), type)
             and issubclass(getattr(jlr, n), jlr.LRScheduler)}
    assert len(names) == 16
    assert all(issubclass(getattr(tlr, n), tlr.LRScheduler) for n in names)


# ------------------------------------------------------------- optimizers

SHAPES = {"w": (8, 4), "norm.bias": (4,)}
no_bias = lambda n: not n.endswith("bias")

# (port optimizer, JAX optimizer) factories; ``m`` is the optimizer
# module, ``r`` the regularizer module, ``lr`` the LR of the case
OPTIMIZERS = {
    "sgd": lambda m, r, lr: m.SGD(lr),
    "sgd_l2": lambda m, r, lr: m.SGD(lr, weight_decay=r.L2Decay(0.05)),
    "sgd_l1_global_clip": lambda m, r, lr: m.SGD(
        lr, weight_decay=r.L1Decay(0.05),
        grad_clip=m.ClipGradByGlobalNorm(0.5)),
    "momentum": lambda m, r, lr: m.Momentum(lr, momentum=0.9),
    "momentum_nesterov_norm_clip": lambda m, r, lr: m.Momentum(
        lr, momentum=0.9, use_nesterov=True, weight_decay=0.01,
        grad_clip=m.ClipGradByNorm(0.3)),
    "adam_l2_value_clip": lambda m, r, lr: m.Adam(
        lr, weight_decay=0.01, grad_clip=m.ClipGradByValue(0.8)),
    "adam_l1": lambda m, r, lr: m.Adam(lr, weight_decay=r.L1Decay(0.01)),
    "adamw_l1_excluded": lambda m, r, lr: m.AdamW(
        lr, weight_decay=r.L1Decay(0.02), apply_decay_param_fun=no_bias),
    "adamw_schedule": lambda m, r, lr: m.AdamW(
        r.sched, weight_decay=0.1, apply_decay_param_fun=no_bias),
    "adagrad": lambda m, r, lr: m.Adagrad(lr, initial_accumulator_value=0.1),
    "rmsprop": lambda m, r, lr: m.RMSProp(lr),
    "rmsprop_centered": lambda m, r, lr: m.RMSProp(lr, momentum=0.9,
                                                   centered=True),
    "lamb": lambda m, r, lr: m.Lamb(lr, lamb_weight_decay=0.01),
    "lars": lambda m, r, lr: m.Lars(lr, lars_coeff=0.01,
                                    exclude_from_weight_decay=["bias"]),
    "adadelta": lambda m, r, lr: m.Adadelta(1.0),
    "adamax": lambda m, r, lr: m.Adamax(lr, weight_decay=0.01),
}


class _Mods:
    """An optimizer module plus a regularizer module and a fresh LR
    schedule: what the factories above read."""

    def __init__(self, opt, reg, lrmod):
        self.opt, self.reg = opt, reg
        self.L1Decay, self.L2Decay = reg.L1Decay, reg.L2Decay
        self.sched = lrmod.LinearWarmup(
            lrmod.PolynomialDecay(0.05, 5, end_lr=0.01), warmup_steps=2,
            start_lr=0.01, end_lr=0.05)


def _make(name):
    """(JAX optimizer, port optimizer, their schedules) of a case."""
    jm, tm = _Mods(pit.optimizer, jreg, jlr), _Mods(topt, treg, tlr)
    return (OPTIMIZERS[name](pit.optimizer, jm, 0.05),
            OPTIMIZERS[name](topt, tm, 0.05), (jm.sched, tm.sched))


def _init_params(seed=0):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}


def _grads(rng):
    return {n: (rng.randn(*s) * 2).astype(np.float32)
            for n, s in SHAPES.items()}


def _check_state(tstate, jstate):
    assert set(tstate) == set(jstate)
    for k in tstate:
        np.testing.assert_allclose(np.asarray(tstate[k].float()),
                                   np.asarray(jstate[k], np.float32),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_functional_update_matches_jax(name):
    init = _init_params()
    jo, to, (jsched, tsched) = _make(name)
    jp = {n: jnp.asarray(a) for n, a in init.items()}
    tp = {n: torch.tensor(a) for n, a in init.items()}
    js, ts = jo.functional_init(jp), to.functional_init(tp)
    rng = np.random.RandomState(1)
    for step in (1, 2, 3):
        g = _grads(rng)
        jp, js = jo.functional_update(
            jp, {n: jnp.asarray(a) for n, a in g.items()}, js, step=step)
        to.functional_update(tp, {n: torch.tensor(a) for n, a in g.items()},
                             ts, step=step)
        jsched.step()
        tsched.step()
    for n in init:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   atol=1e-6, rtol=1e-6)
        _check_state(ts[n], js[n])


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_eager_step_matches_jax(name):
    """``loss.backward(); opt.step(); opt.clear_grad()`` with the
    gradients set by hand; one parameter takes ``optimize_attr``'s
    per-parameter learning rate."""
    init = _init_params(2)
    jparams = [JParameter(jnp.asarray(a), name=n) for n, a in init.items()]
    tparams = [(n, torch.nn.Parameter(torch.tensor(a)))
               for n, a in init.items()]
    jparams[0].optimize_attr = {"learning_rate": 0.5}
    tparams[0][1].optimize_attr = {"learning_rate": 0.5}
    jm, tm = _Mods(pit.optimizer, jreg, jlr), _Mods(topt, treg, tlr)
    fac = OPTIMIZERS[name]
    jo = _rebuild(fac, pit.optimizer, jm, jparams)
    to = _rebuild(fac, topt, tm, tparams)
    rng = np.random.RandomState(3)
    for _ in range(3):
        g = _grads(rng)
        for p in jparams:
            p.grad = pit.Tensor(jnp.asarray(g[p.name]))
        for n, p in tparams:
            p.grad = torch.tensor(g[n])
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        jm.sched.step()
        tm.sched.step()
    assert all(p.grad is None for _, p in tparams)
    for jp_, (n, tp_) in zip(jparams, tparams):
        np.testing.assert_allclose(tp_.detach().numpy(),
                                   np.asarray(jp_._data), atol=1e-6,
                                   rtol=1e-6)
        _check_state(to._state[id(tp_)], jo._state[id(jp_)])
    sd = to.state_dict()
    assert sd["step"] == 3
    back = _rebuild(fac, topt, _Mods(topt, treg, tlr), tparams)
    back.set_state_dict(sd)
    for _, p in tparams:
        _check_state(back._state[id(p)], to._state[id(p)])
    if name == "adamw_schedule":
        assert back._lr.last_epoch == to._lr.last_epoch


def _rebuild(fac, mod, mods, params):
    """The factory's optimizer with ``parameters`` (keyword arguments
    differ per class, so the instance is built and then given them)."""
    opt = fac(mod, mods, 0.05)
    if mod is topt:
        opt._parameters = [p for _, p in params]
        opt._names = {id(p): n for n, p in params}
    else:
        opt._parameters = list(params)
    return opt


def test_set_lr_and_scheduler_reads():
    s = tlr.StepDecay(0.1, step_size=1, gamma=0.5)
    o = topt.SGD(s)
    assert o.get_lr() == 0.1
    s.step()
    assert o.get_lr() == 0.05
    with pytest.raises(RuntimeError, match="LRScheduler"):
        o.set_lr(0.3)
    o2 = topt.SGD(0.1)
    o2.set_lr(0.3)
    assert o2.get_lr() == 0.3


def test_lr_ratio_is_refused():
    with pytest.raises(NotImplementedError, match="ignores it"):
        topt.AdamW(0.1, lr_ratio=lambda p: 0.5)


# ------------------------------------------------------------------- clips

CLIPS = {"global": lambda m: m.ClipGradByGlobalNorm(1.5),
         "norm": lambda m: m.ClipGradByNorm(1.0),
         "value": lambda m: m.ClipGradByValue(0.7, min=-0.4)}


@pytest.mark.parametrize("kind", sorted(CLIPS))
def test_clip_matches_jax(kind):
    rng = np.random.RandomState(4)
    grads = {n: (rng.randn(*s) * 3).astype(np.float32)
             for n, s in dict(SHAPES, b2=(5,)).items()}
    want = CLIPS[kind](pit.optimizer).functional_clip(
        {n: jnp.asarray(g) for n, g in grads.items()})
    got = CLIPS[kind](topt).functional_clip(
        {n: torch.tensor(g) for n, g in grads.items()})
    for n in grads:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   atol=1e-6, rtol=1e-6)
    # eager: the second parameter opts out of clipping
    jpg, tpg = [], []
    for i, (n, g) in enumerate(grads.items()):
        jp_ = JParameter(jnp.zeros(g.shape), name=n)
        tp_ = torch.nn.Parameter(torch.zeros(g.shape))
        jp_.need_clip = tp_.need_clip = i != 1
        jpg.append((jp_, pit.Tensor(jnp.asarray(g))))
        tpg.append((tp_, torch.tensor(g)))
    jout = CLIPS[kind](pit.optimizer)(jpg)
    tout = CLIPS[kind](topt)(tpg)
    for (_, jg), (_, tg) in zip(jout, tout):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg._data),
                                   atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(tout[1][1].numpy(), tpg[1][1].numpy())


def test_clips_reexported_in_nn():
    from paddle_infer_tpu_torch import nn as tnn

    assert tnn.ClipGradByGlobalNorm is topt.ClipGradByGlobalNorm
    assert tnn.ClipGradByNorm is topt.ClipGradByNorm
    assert tnn.ClipGradByValue is topt.ClipGradByValue


# ------------------------------------------------------------- GradScaler

def test_grad_scaler_sequence_matches_jax():
    """Six steps of scaled gradients, the third holding an inf: that step
    is skipped (parameters bitwise unchanged), the scale halves, then the
    good steps count up and double it every two."""
    init = _init_params(5)
    jparams = [JParameter(jnp.asarray(a), name=n) for n, a in init.items()]
    tparams = [(n, torch.nn.Parameter(torch.tensor(a)))
               for n, a in init.items()]
    jo = pit.optimizer.SGD(0.1, parameters=jparams)
    to = topt.SGD(0.1, parameters=tparams)
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    rng = np.random.RandomState(6)
    seq = []
    for step in range(6):
        g = _grads(rng)
        for p in jparams:
            p.grad = pit.Tensor(jnp.asarray(g[p.name] * js._scale))
        for n, p in tparams:
            p.grad = torch.tensor(g[n] * ts._scale)
        if step == 2:
            jparams[0].grad = pit.Tensor(
                jparams[0].grad._data.at[0, 0].set(jnp.inf))
            tparams[0][1].grad[0, 0] = float("inf")
        before = [p.detach().clone() for _, p in tparams]
        js.minimize(jo, None)
        ts.minimize(to, None)
        seq.append((ts._found_inf, ts.get_loss_scaling(), ts._good_steps,
                    ts._bad_steps))
        assert (js._found_inf, js.get_loss_scaling(), js._good_steps,
                js._bad_steps) == seq[-1]
        if step == 2:
            assert ts._found_inf
            assert all(torch.equal(b, p) for b, (_, p) in
                       zip(before, tparams))
        for jp_, (_, tp_) in zip(jparams, tparams):
            np.testing.assert_allclose(tp_.detach().numpy(),
                                       np.asarray(jp_._data), atol=1e-6,
                                       rtol=1e-6)
        jo.clear_grad()
        to.clear_grad()
    assert [s[1] for s in seq] == [1024.0, 2048.0, 1024.0, 1024.0, 2048.0,
                                   2048.0]
    assert ts.state_dict() == js.state_dict()
    back = tamp.GradScaler()
    back.set_state_dict(ts.state_dict())
    assert back.get_loss_scaling() == 2048.0
    assert float(ts.scale(torch.tensor(3.0))) == 3.0 * 2048.0


# --------------------------------------------------------- auto_cast etc.

def test_auto_cast_lists_and_rule():
    x = torch.ones(2, 2)
    with tamp.auto_cast(custom_white_list={"gelu"},
                        custom_black_list={"tanh"}, dtype="float16"):
        assert tamp.cast(x, "gelu").dtype == torch.float16
        assert tamp.cast(x, "matmul").dtype == torch.float16
        assert tamp.cast(x.half(), "tanh").dtype == torch.float32
        assert tamp.cast(x, "add") is x              # O1: unruled op
    assert "gelu" not in tamp.AMP_WHITE_OPS
    assert "tanh" not in tamp.AMP_BLACK_OPS
    assert tamp.cast(x, "matmul") is x               # outside the rule
    with tamp.auto_cast(level="O2"):
        assert tamp.cast(x, "add").dtype == torch.bfloat16
        assert tamp.cast(x.bfloat16(), "sum").dtype == torch.float32
    assert jamp.white_list == tamp.AMP_WHITE_OPS
    assert jamp.black_list == tamp.AMP_BLACK_OPS


def test_decorate_o2_casts_and_sets_master_weights():
    m = torch.nn.Linear(4, 4)
    o = topt.AdamW(0.1, parameters=m.parameters())
    m2, o2 = tamp.decorate(m, o, level="O2", dtype="bfloat16")
    assert m2 is m and o2 is o and o._multi_precision
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    assert tamp.decorate(m, level="O1") is m
