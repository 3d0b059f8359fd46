"""Port parity: ERNIE pretraining of ``paddle_infer_tpu_torch`` against the
JAX package on a tiny config (2 layers, hidden 64, 2 heads).

* Logits in eval within 1e-4 of JAX on the JAX model's ``state_dict()``.
* Three ``FleetTrainStep`` steps in fp32 with dropout 0.1 and a padded
  batch: both sides draw the same keys (``pit.seed`` / ``KeyStream``
  pinned to one seed) and the dropout masks are bitwise equal, so the
  runs follow one trajectory — losses within 1e-5 relative at every
  step, first-step gradients within 1e-4 of each tensor's max-abs,
  parameters after three steps as ``test_three_fp32_steps_match_jax``
  states.
* One O2 bf16 step, and AdamW's ``functional_update`` over 3 steps with
  and without ``multi_precision``.
* The fine-tuning heads ``ErnieForMaskedLM`` (tied to the word
  embedding) and ``ErnieForSequenceClassification``: eval logits within
  1e-4 and first-step gradients (dropout 0.1) within 1e-4 of each
  tensor's max-abs of JAX's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_infer_tpu as pit
from paddle_infer_tpu.models import ErnieConfig as JErnieConfig
from paddle_infer_tpu.models import ErnieForMaskedLM as JErnieMLM
from paddle_infer_tpu.models import ErnieForPretraining as JErnie
from paddle_infer_tpu.models import \
    ErnieForSequenceClassification as JErnieCls
from paddle_infer_tpu.models.losses import masked_lm_loss as j_mlm_loss
from paddle_infer_tpu.models.ernie import ernie_pretrain_loss as j_loss
from paddle_infer_tpu.parallel import DistributedStrategy as JStrategy
from paddle_infer_tpu.parallel import FleetTrainStep as JStep
from paddle_infer_tpu.parallel import fleet as jfleet
from paddle_infer_tpu_torch import amp
from paddle_infer_tpu_torch.core.random import KeyStream
from paddle_infer_tpu_torch.models.ernie import (
    ErnieConfig, ErnieForMaskedLM, ErnieForPretraining,
    ErnieForSequenceClassification, ernie_pretrain_loss)
from paddle_infer_tpu_torch.models.losses import masked_lm_loss
from paddle_infer_tpu_torch.nn.layers import Embedding, LayerNorm
from paddle_infer_tpu_torch.optimizer import AdamW
from paddle_infer_tpu_torch.parallel import (DistributedStrategy,
                                             FleetTrainStep, fleet)
from paddle_infer_tpu_torch.weights import from_jax_state_dict

CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.1,
           attention_probs_dropout_prob=0.1)
LR = 1e-3


def _pair(seed=5):
    jm = JErnie(JErnieConfig(**CFG))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ErnieForPretraining(ErnieConfig(**CFG), device="cpu",
                             keys=KeyStream(seed))
    from_jax_state_dict(tm, state)
    return jm, tm, state


def _batch(b=2, s=32, pad=4, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG["vocab_size"], (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[:, s - pad:] = 0
    labels = rng.randint(0, CFG["vocab_size"], (b, s)).astype(np.int32)
    labels[:, s - pad:] = -100
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    return ids, mask, labels, nsp


def _steps(amp_o2=False):
    jm, tm, _ = _pair()
    jm.train()
    js, ts = JStrategy(), DistributedStrategy()
    if amp_o2:
        for st in (js, ts):
            st.amp = True
            st.amp_configs = {"level": "O2", "dtype": "bfloat16"}
    jfleet.init(is_collective=True, strategy=js, devices=jax.devices()[:1])
    fleet.init(strategy=ts, devices=["cpu"])

    def jl(m, ids, mask, labels, nsp):
        mlm, nsp_logits = m(ids, attention_mask=mask)
        return j_loss(mlm, nsp_logits, labels, nsp)

    def tl(m, ids, mask, labels, nsp):
        mlm, nsp_logits = m(ids, attention_mask=mask)
        return ernie_pretrain_loss(mlm, nsp_logits, labels, nsp)

    jstep = JStep(jm, jl, pit.optimizer.AdamW(learning_rate=LR,
                                              parameters=jm.parameters()),
                  strategy=js)
    tstep = FleetTrainStep(tm, tl, AdamW(learning_rate=LR,
                                         parameters=tm.parameters()),
                           strategy=ts)
    pit.seed(7)
    tm.keys.seed(7)
    return jstep, tstep


def test_state_dict_maps_both_tied_names():
    jm, tm, state = _pair()
    assert "cls._tied_weight" in state
    assert tm.cls._tied_weight is tm.ernie.embeddings.word_embeddings.weight
    np.testing.assert_array_equal(tm.cls._tied_weight.detach().numpy(),
                                  state["ernie.embeddings.word_embeddings."
                                        "weight"])
    bad = dict(state)
    bad["cls._tied_weight"] = bad["cls._tied_weight"] + 1.0
    with pytest.raises(ValueError, match="tied"):
        from_jax_state_dict(tm, bad)


def test_eval_logits_match_jax():
    jm, tm, _ = _pair()
    jm.eval()
    tm.eval()
    ids, mask, _, _ = _batch()
    jmlm, jnsp = jm(pit.Tensor(ids), attention_mask=pit.Tensor(mask))
    with torch.no_grad():
        tmlm, tnsp = tm(torch.tensor(ids), attention_mask=torch.tensor(mask))
    np.testing.assert_allclose(tmlm.numpy(), jmlm.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tnsp.numpy(), jnsp.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_first_step_grads_match_jax():
    """The first step's gradients: the JAX step's are taken with
    ``jax.grad`` of its pure loss under the same key."""
    jstep, tstep = _steps()
    batch = _batch()
    key = pit.core.random.next_key()
    pure = jstep._pure_loss({})
    arrays = tuple(jnp.asarray(a) for a in batch)
    jg = jax.grad(lambda p: pure(p, jstep.buffers, key, arrays)[0])(
        jstep.params)
    tkey = tstep.keys.next_key()
    np.testing.assert_array_equal(
        tkey.numpy(), np.asarray(jax.random.key_data(key)).astype(np.int64))
    with tstep.keys.trace_key_scope(tkey):
        loss = tstep.loss_fn(tstep.model, *(torch.tensor(a) for a in batch))
    loss.backward()
    assert set(jg) == set(tstep.params)
    for n, p in tstep.params.items():
        want = np.asarray(jg[n])
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= 1e-4 * scale, (n, err, scale)


def test_three_fp32_steps_match_jax():
    """Losses within 1e-5 relative at every step.  Parameters after three
    steps within 1e-5, except the key third of each ``qkv_proj.bias``:
    adding a constant to every key of a row leaves its softmax unchanged,
    so that gradient is zero in exact arithmetic and at rounding level in
    both runs; Adam divides it by its own running RMS, which moves each
    such element by up to ``lr`` per step either way, so those agree
    within ``3 * lr``."""
    jstep, tstep = _steps()
    batch = _batch()
    for i in range(3):
        lj = float(jstep(*batch).numpy())
        lt = float(tstep(*batch))
        assert abs(lj - lt) <= 1e-5 * abs(lj), (i, lj, lt)
    h = CFG["hidden_size"]
    for n, p in tstep.params.items():
        diff = np.abs(p.detach().numpy() - np.asarray(jstep.params[n]))
        if n.endswith("qkv_proj.bias"):
            assert diff[h:2 * h].max() <= 3 * LR, n
            diff = np.concatenate([diff[:h], diff[2 * h:]])
        assert diff.max() <= 1e-5, (n, float(diff.max()))


def test_o2_bf16_step_matches_jax():
    """One O2 step: both sides round the forward to bf16 at the same ops,
    but each framework rounds its bf16 products and reductions in its own
    order; the loss (itself a bf16 sum of two bf16 terms, an ulp of 2^-8
    relative) agrees within 1e-2 relative."""
    jstep, tstep = _steps(amp_o2=True)
    batch = _batch()
    lj = float(jstep(*batch).numpy())
    lt = float(tstep(*batch))
    assert np.isfinite(lt)
    assert abs(lj - lt) <= 1e-2 * abs(lj), (lj, lt)
    for p in tstep.params.values():
        assert p.dtype == torch.float32 and torch.isfinite(p).all()


def test_layer_norm_and_embedding_keep_fp32_statistics_under_o2():
    ln = LayerNorm(64, epsilon=1e-12, device="cpu")
    ln.reset_parameters()
    emb = Embedding(10, 64, device="cpu")
    emb.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(4, 64) * 3 + 100.0       # a large mean: bf16 stats lose it
    with amp.amp_scope(True):
        y = ln(x)
        e = emb(torch.tensor([1, 2]))
    assert y.dtype == torch.bfloat16 and e.dtype == torch.bfloat16
    want = torch.nn.functional.layer_norm(x.to(torch.bfloat16).float(),
                                          (64,), eps=1e-12)
    torch.testing.assert_close(y.float(), want.to(torch.bfloat16).float())
    torch.testing.assert_close(e, emb.weight[[1, 2]].to(torch.bfloat16))


@pytest.mark.parametrize("multi_precision", [False, True])
def test_adamw_functional_update_matches_jax(multi_precision):
    """Three updates of two parameters (one excluded from decay by
    ``apply_decay_param_fun``); ``multi_precision`` runs bf16 params
    with float32 masters."""
    rng = np.random.RandomState(0)
    dt = jnp.bfloat16 if multi_precision else jnp.float32
    tdt = torch.bfloat16 if multi_precision else torch.float32
    init = {"w": rng.randn(8, 4).astype(np.float32),
            "norm.bias": rng.randn(4).astype(np.float32)}
    decay = lambda n: not n.endswith("bias")
    jopt = pit.optimizer.AdamW(learning_rate=1e-2, weight_decay=0.1,
                               apply_decay_param_fun=decay,
                               multi_precision=multi_precision)
    topt = AdamW(learning_rate=1e-2, weight_decay=0.1,
                 apply_decay_param_fun=decay,
                 multi_precision=multi_precision)
    jp = {n: jnp.asarray(a, dt) for n, a in init.items()}
    tp = {n: torch.tensor(a).to(tdt) for n, a in init.items()}
    js, ts = jopt.functional_init(jp), topt.functional_init(tp)
    assert set(js["w"]) == set(ts["w"])
    for step in (1, 2, 3):
        grads = {n: rng.randn(*a.shape).astype(np.float32)
                 for n, a in init.items()}
        jp, js = jopt.functional_update(
            jp, {n: jnp.asarray(g, dt) for n, g in grads.items()}, js,
            step=step)
        topt.functional_update(
            tp, {n: torch.tensor(g).to(tdt) for n, g in grads.items()}, ts,
            step=step)
    for n in init:
        got = tp[n].float().numpy()
        want = np.asarray(jp[n]).astype(np.float32)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        if multi_precision:
            np.testing.assert_allclose(ts[n]["master"].numpy(),
                                       np.asarray(js[n]["master"]),
                                       atol=1e-6, rtol=1e-6)


HEADS = {
    "mlm": (lambda: JErnieMLM(JErnieConfig(**CFG)),
            lambda keys: ErnieForMaskedLM(ErnieConfig(**CFG), device="cpu",
                                          keys=keys)),
    "cls": (lambda: JErnieCls(JErnieConfig(**CFG), num_classes=3),
            lambda keys: ErnieForSequenceClassification(
                ErnieConfig(**CFG), num_classes=3, device="cpu", keys=keys)),
}


def _head_pair(head):
    jm = HEADS[head][0]()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = HEADS[head][1](KeyStream(5))
    from_jax_state_dict(tm, state)
    return jm, tm, state


def _head_losses(head):
    """(JAX loss fn, port loss fn, labels) of a head: the masked LM loss
    over the padded batch's labels, or cross-entropy over 3 classes."""
    ids, mask, labels, _ = _batch()
    if head == "cls":
        labels = np.array([2, 0], np.int32)

        def jl(m, ids, mask, labels):
            return pit.nn.functional.cross_entropy(
                m(ids, attention_mask=mask), labels)

        def tl(m, ids, mask, labels):
            from paddle_infer_tpu_torch.nn import functional as PF

            return PF.cross_entropy(m(ids, attention_mask=mask), labels)
        return jl, tl, (ids, mask, labels)

    def jl(m, ids, mask, labels):
        return j_mlm_loss(m(ids, attention_mask=mask), labels)

    def tl(m, ids, mask, labels):
        return masked_lm_loss(m(ids, attention_mask=mask), labels)
    return jl, tl, (ids, mask, labels)


@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_eval_logits_match_jax(head):
    jm, tm, state = _head_pair(head)
    if head == "mlm":
        assert tm.cls._tied_weight is \
            tm.ernie.embeddings.word_embeddings.weight
        assert "cls._tied_weight" in state
    jm.eval()
    tm.eval()
    ids, mask, _, _ = _batch()
    want = jm(pit.Tensor(ids), attention_mask=pit.Tensor(mask))
    with torch.no_grad():
        got = tm(torch.tensor(ids), attention_mask=torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_first_step_grads_match_jax(head):
    """The first step's gradients with dropout 0.1, the JAX side by
    ``jax.grad`` of its step's pure loss under the same key; the tied MLM
    weight's gradient sums its two uses on both sides.  The MLM head
    leaves the pooler out of its loss: JAX's gradient there is zeros, the
    port's None (which the update takes as zeros)."""
    jm, tm, _ = _head_pair(head)
    jm.train()
    jl, tl, batch = _head_losses(head)
    jfleet.init(is_collective=True, strategy=JStrategy(),
                devices=jax.devices()[:1])
    fleet.init(strategy=DistributedStrategy(), devices=["cpu"])
    jstep = JStep(jm, jl, pit.optimizer.AdamW(learning_rate=LR,
                                              parameters=jm.parameters()))
    tstep = FleetTrainStep(tm, tl, AdamW(learning_rate=LR))
    pit.seed(9)
    tm.keys.seed(9)
    key = pit.core.random.next_key()
    arrays = tuple(jnp.asarray(a) for a in batch)
    pure = jstep._pure_loss({})
    jg = jax.grad(lambda p: pure(p, jstep.buffers, key, arrays)[0])(
        jstep.params)
    with tstep.keys.trace_key_scope(tstep.keys.next_key()):
        loss = tstep.loss_fn(tstep.model, *(torch.tensor(a) for a in batch))
    loss.backward()
    assert set(jg) == set(tstep.params)
    for n, p in tstep.params.items():
        want = np.asarray(jg[n])
        if p.grad is None:
            assert n.startswith("ernie.pooler.") and head == "mlm", n
            assert not want.any(), n
            continue
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= 1e-4 * scale, (n, err, scale)


def test_unported_strategy_raises():
    for knob in ("localsgd", "dgc"):
        st = DistributedStrategy()
        setattr(st, knob, True)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fleet.init(strategy=st, devices=["cpu"])
    with pytest.raises(NotImplementedError, match="not a knob"):
        DistributedStrategy(fuse_all_reduce_ops=True)


def test_training_without_keys_raises():
    from paddle_infer_tpu_torch.nn import functional as PF

    with pytest.raises(ValueError, match="KeyStream"):
        PF.dropout(torch.ones(4), p=0.1, training=True)


def test_chip_smoke_train_phase_on_cpu(monkeypatch):
    """``chip_smoke``'s train and step-parity phases at a tiny config on
    the CPU (the wrappers take their plain versions)."""
    import os

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    cfg = ErnieConfig(**dict(CFG, vocab_size=256))
    st = chip_smoke.train_phase(torch.device("cpu"), cfg, batch=2, seq=32,
                                warmup=1, steps=6, amp_o2=False,
                                launches_per_step=0)
    assert len(st["losses"]) == 6
    chip_smoke.step_parity_phase(torch.device("cpu"), cfg, batch=2, seq=32,
                                 layers=2)
