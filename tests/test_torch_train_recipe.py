"""Port parity: ``FleetTrainStep`` with the training recipe — an LR schedule
with gradient clipping, recompute, gradient merge and AMP O1 — against
the JAX package's step on the tiny ERNIE config of
``tests/test_torch_ernie.py`` (2 layers, hidden 64, 2 heads).

* Three fp32 steps with dropout 0.1 on a padded batch per recipe: both
  sides draw the same keys, so the runs follow one trajectory — losses
  within 1e-5 relative and the learning rate equal at every step,
  parameters after three steps within 1e-5, or 3 x LR where a gradient
  was at rounding level (``test_three_fp32_steps_match_jax``'s rule for
  the key bias, stated for every element).  Gradient merge splits the
  batch into two micro-batches, each under ``fold_in(key, i)``.
* One O1 bf16 step: the loss within 1e-2 relative of JAX's, and the
  forward's dtypes: every linear product in bf16 with the bias add
  promoting it to float32, attention in bf16, the logits and the loss
  float32.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

import paddle_infer_tpu as pit
from paddle_infer_tpu.models import ErnieConfig as JErnieConfig
from paddle_infer_tpu.models import ErnieForPretraining as JErnie
from paddle_infer_tpu.models.ernie import ernie_pretrain_loss as j_loss
from paddle_infer_tpu.parallel import DistributedStrategy as JStrategy
from paddle_infer_tpu.parallel import FleetTrainStep as JStep
from paddle_infer_tpu.parallel import fleet as jfleet
from paddle_infer_tpu_torch import amp
from paddle_infer_tpu_torch import optimizer as topt
from paddle_infer_tpu_torch.core.random import KeyStream
from paddle_infer_tpu_torch.models.ernie import (ErnieConfig,
                                                 ErnieForPretraining,
                                                 ernie_pretrain_loss)
from paddle_infer_tpu_torch.ops import attention as TA
from paddle_infer_tpu_torch.optimizer import lr as tlr
from paddle_infer_tpu_torch.parallel import (DistributedStrategy,
                                             FleetTrainStep, fleet)
from paddle_infer_tpu_torch.weights import from_jax_state_dict

CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.1,
           attention_probs_dropout_prob=0.1)
LR = 1e-3
decay = lambda n: not (n.endswith("bias") or "norm" in n)


def _batch(b=4, s=32, pad=4, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG["vocab_size"], (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[:, s - pad:] = 0
    labels = rng.randint(0, CFG["vocab_size"], (b, s)).astype(np.int32)
    labels[:, s - pad:] = -100
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    return ids, mask, labels, nsp


def _schedule(m):
    return m.LinearWarmup(m.PolynomialDecay(LR, 10, end_lr=1e-4),
                          warmup_steps=2, start_lr=1e-4, end_lr=LR)


# recipe -> (strategy fields, schedule + clip)
RECIPES = {
    "schedule_clip": ({}, True),
    "recompute": ({"recompute": True}, False),
    "merge": ({"gradient_merge": True,
               "gradient_merge_configs": {"k_steps": 2}}, False),
    "merge_recompute_schedule": ({"recompute": True, "gradient_merge": True,
                                  "gradient_merge_configs": {"k_steps": 2}},
                                 True),
}


def _steps(fields, schedule, amp_cfg=None):
    """(JAX step, port step) on one set of weights, keys seeded alike."""
    jm = JErnie(JErnieConfig(**CFG))
    jm.train()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ErnieForPretraining(ErnieConfig(**CFG), device="cpu",
                             keys=KeyStream(5))
    from_jax_state_dict(tm, state)
    js, ts = JStrategy(), DistributedStrategy()
    for st in (js, ts):
        for k, v in fields.items():
            setattr(st, k, v)
        if amp_cfg:
            st.amp = True
            st.amp_configs = dict(amp_cfg)
    jfleet.init(is_collective=True, strategy=js, devices=jax.devices()[:1])
    fleet.init(strategy=ts, devices=["cpu"])

    def jl(m, ids, mask, labels, nsp):
        mlm, nsp_logits = m(ids, attention_mask=mask)
        return j_loss(mlm, nsp_logits, labels, nsp)

    def tl(m, ids, mask, labels, nsp):
        mlm, nsp_logits = m(ids, attention_mask=mask)
        return ernie_pretrain_loss(mlm, nsp_logits, labels, nsp)

    kw = dict(apply_decay_param_fun=decay)
    if schedule:
        jopt = pit.optimizer.AdamW(
            learning_rate=_schedule(pit.optimizer.lr),
            grad_clip=pit.optimizer.ClipGradByGlobalNorm(0.5), **kw)
        topt_ = topt.AdamW(learning_rate=_schedule(tlr),
                           grad_clip=topt.ClipGradByGlobalNorm(0.5), **kw)
    else:
        jopt = pit.optimizer.AdamW(learning_rate=LR, **kw)
        topt_ = topt.AdamW(learning_rate=LR, **kw)
    jstep = JStep(jm, jl, jopt, strategy=js)
    tstep = FleetTrainStep(tm, tl, topt_, strategy=ts)
    pit.seed(7)
    tm.keys.seed(7)
    return jstep, tstep


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_three_fp32_steps_match_jax(recipe):
    """Losses within 1e-5 relative and the learning rate equal at every
    step; parameters after three steps within 1e-5, except elements whose
    gradient at some step lies within 1e-5 of that tensor's max-abs of
    zero: such a gradient is at rounding level in both runs (the key third
    of each ``qkv_proj.bias`` is zero in exact arithmetic; a micro-batch
    of two rows leaves a few pooler and projection elements near zero),
    and Adam, dividing it by its own running RMS, moves the element by up
    to the learning rate per step either way, so those agree within
    ``3 * LR``, as ``test_three_fp32_steps_match_jax`` holds the key
    bias."""
    fields, schedule = RECIPES[recipe]
    jstep, tstep = _steps(fields, schedule)
    batch = _batch()
    tiny = {n: torch.zeros_like(p, dtype=torch.bool)
            for n, p in tstep.params.items()}
    for i in range(3):
        assert tstep.optimizer.get_lr() == jstep.optimizer.get_lr(), i
        lj = float(jstep(*batch).numpy())
        lt = float(tstep(*batch))
        assert abs(lj - lt) <= 1e-5 * abs(lj), (i, lj, lt)
        for n, p in tstep.params.items():
            g = p.grad.abs()
            tiny[n] |= g <= 1e-5 * g.max()
    assert tstep.optimizer.get_lr() == jstep.optimizer.get_lr()
    h = CFG["hidden_size"]
    for n, p in tstep.params.items():
        diff = np.abs(p.detach().numpy() - np.asarray(jstep.params[n]))
        if n.endswith("qkv_proj.bias"):
            assert tiny[n][h:2 * h].all(), n
        t = tiny[n].numpy()
        assert diff[t].max(initial=0.0) <= 3 * LR, n
        assert diff[~t].max(initial=0.0) <= 1e-5, (n, float(diff.max()))


class _NoHostReads(TorchDispatchMode):
    """Raise on any op that reads a device value back to the host or
    makes a host tensor (what a CUDA graph cannot hold), as
    ``tests/test_torch_graphs.py`` checks the plain step."""

    FORBID = ("aten._local_scalar_dense", "aten.nonzero",
              "aten.is_nonzero", "aten.lift_fresh")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func.overloadpacket) in self.FORBID:
            raise AssertionError(f"{func} inside a step")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("opt", ["AdamW", "SGD", "Momentum", "Adagrad",
                                 "RMSProp", "Lamb", "Lars", "Adadelta",
                                 "Adamax"])
def test_recipe_step_body_reads_nothing_back(opt):
    """The step's body with every recipe switch on (a schedule, a global
    clip, L1 decay where the optimizer folds decay into the gradient,
    recompute, gradient merge, O1) makes no host read and no host tensor,
    so the card can capture it; the rate reaches it as the staged
    buffer."""
    from paddle_infer_tpu_torch.regularizer import L1Decay

    _, tstep = _steps(RECIPES["merge_recompute_schedule"][0], False,
                      {"level": "O1", "dtype": "bfloat16"})
    kw = dict(learning_rate=_schedule(tlr),
              grad_clip=topt.ClipGradByGlobalNorm(0.5))
    if opt in ("SGD", "Momentum", "Adagrad", "RMSProp", "Adadelta",
               "Adamax"):
        kw["weight_decay"] = L1Decay(1e-3)
    tstep.optimizer = getattr(topt, opt)(**kw)
    batch = [torch.tensor(a) for a in _batch()]
    tstep(*batch)
    d = tstep._scalars.upload()
    tstep._grad_sets = []
    with _NoHostReads():
        loss = tstep._body(d["key"], d["lr"], d["step"], *batch)
    tstep._grad_sets = None
    assert torch.isfinite(loss)


def test_merge_needs_a_divisible_batch():
    _, tstep = _steps(RECIPES["merge"][0], False)
    with pytest.raises(ValueError, match="k_steps=2"):
        tstep(*_batch(b=3))


class _MatmulDtypes(TorchDispatchMode):
    """The input dtypes of every ``aten.mm`` (the linear products)."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.seen.add((args[0].dtype, args[1].dtype))
        return func(*args, **(kwargs or {}))


def test_o1_bf16_step_matches_jax(monkeypatch):
    """One O1 step within 1e-2 relative of JAX's (both round the products
    and attention to bf16 and keep the rest float32, each framework in
    its own order), then the forward's dtypes under the O1 rule."""
    jstep, tstep = _steps({}, False, {"level": "O1", "dtype": "bfloat16"})
    batch = _batch()
    lj = float(jstep(*batch).numpy())
    lt = float(tstep(*batch))
    assert np.isfinite(lt)
    assert abs(lj - lt) <= 1e-2 * abs(lj), (lj, lt)
    for p in tstep.params.values():
        assert p.dtype == torch.float32 and torch.isfinite(p).all()

    model = tstep.model
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: seen.update({name: out.dtype}))
        for name, m in (("qkv_proj", model.ernie.layers[0].self_attn.qkv_proj),
                        ("self_attn", model.ernie.layers[0].self_attn),
                        ("fc1", model.ernie.layers[0].mlp.fc1),
                        ("norm1", model.ernie.layers[0].norm1),
                        ("pooler", model.ernie.pooler))]
    sdpa = TA.sdpa

    def spy(*a, **k):
        out = sdpa(*a, **k)
        seen.update(sdpa_in=a[0].dtype, sdpa_out=out.dtype)
        return out

    monkeypatch.setattr(TA, "sdpa", spy)
    ids, mask, labels, nsp = (torch.tensor(a) for a in batch)
    mm = _MatmulDtypes()
    with model.keys.trace_key_scope(torch.tensor([0, 3])), \
            amp.amp_scope(True, torch.bfloat16, "O1"), mm:
        mlm, nsp_logits = model(ids, attention_mask=mask)
        loss = ernie_pretrain_loss(mlm, nsp_logits, labels, nsp)
    for h in hooks:
        h.remove()
    assert mm.seen == {(torch.bfloat16, torch.bfloat16)}
    assert seen == {"qkv_proj": torch.float32, "self_attn": torch.float32,
                    "fc1": torch.float32, "norm1": torch.float32,
                    "pooler": torch.float32, "sdpa_in": torch.bfloat16,
                    "sdpa_out": torch.bfloat16}
    assert mlm.dtype == nsp_logits.dtype == loss.dtype == torch.float32


def test_chip_smoke_recipe_runs_on_cpu(monkeypatch):
    """``chip_smoke``'s training-recipe runs at a tiny config on the CPU
    (the wrappers take their plain versions, no flash launch, every
    graph run eager): fine-tuning with its schedule, recompute EQUAL to
    plain, gradient merge within the O2 limits, O1 against fp32, the
    float16 scaler loop with its skipped step, and the other
    optimizers."""
    import os

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    cfg = ErnieConfig(**dict(CFG, vocab_size=256))
    cpu = torch.device("cpu")
    ft = chip_smoke.train_ft(cpu, "cpu", cfg, batch=4, seq=32, warmup=1,
                             steps=8, peak_lr=5e-3)
    assert len(ft["lrs"]) == 9 and ft["lrs"][0] == 0.0
    rc = chip_smoke.recompute_pair(cpu, "cpu", cfg, batch=2, seq=32,
                                   steps=2)
    assert rc["recompute"]["losses"] == rc["plain"]["losses"]
    chip_smoke.merge_run(cpu, "cpu", cfg, batch=4, seq=32, steps=2)
    chip_smoke.o1_run(cpu, "cpu", cfg, batch=2, seq=32)
    rows = chip_smoke.scaler_run(cpu, "cpu", cfg, batch=4, seq=32, lr=1e-3)
    assert [r[1] for r in rows] == [False, False, True, False, False, False]
    chip_smoke.optimizers_run(cpu, "cpu", cfg, layers=1, batch=2, seq=32)
