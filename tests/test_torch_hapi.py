"""Port parity: ``paddle_infer_tpu_torch/hapi`` (``Model``, callbacks,
``summary``) and ``framework/io.py``'s ``save`` against the JAX package.

* ``tests/test_hapi.py:30-96`` on the port: fit / evaluate / predict,
  save / load, the checkpoint directory, early stopping.
* With the JAX MLP's weights (``from_jax_state_dict``) on a sequence
  loader: ``fit``'s history, every batch's and epoch's logs,
  ``evaluate`` and ``predict`` within 1e-5 of JAX's ``Model`` (fp32);
  ``EarlyStopping.stopped_epoch`` and the rates ``LRSchedulerCallback``
  leaves equal to JAX's; a ``.pdparams`` written by either package loads
  into the other's ``Model`` with the same predictions; ``summary``'s
  rows (names, types, shapes, counts) equal.
* The slice as a whole: a tiny ``ErnieForSequenceClassification`` at
  dropout 0 fit for 3 batches of an ``io.DataLoader`` through both
  ``Model``s, losses within 1e-5.
"""
import os

import numpy as np
import pytest
import torch

import paddle_infer_tpu as pit
from paddle_infer_tpu.hapi import Callback as JCallback
from paddle_infer_tpu.hapi import EarlyStopping as JEarlyStopping
from paddle_infer_tpu.hapi import LRSchedulerCallback as JLRCallback
from paddle_infer_tpu.hapi import Model as JModel
from paddle_infer_tpu.hapi import summary as jsummary
from paddle_infer_tpu.metric import Accuracy as JAccuracy
from paddle_infer_tpu.models import ErnieConfig as JErnieConfig
from paddle_infer_tpu.models import \
    ErnieForSequenceClassification as JErnieCls
from paddle_infer_tpu_torch import io as tio
from paddle_infer_tpu_torch import nn as tnn
from paddle_infer_tpu_torch import optimizer as topt
from paddle_infer_tpu_torch.core.random import KeyStream
from paddle_infer_tpu_torch.framework import load as tload
from paddle_infer_tpu_torch.framework import save as tsave
from paddle_infer_tpu_torch.hapi import (Callback, EarlyStopping,
                                         LRSchedulerCallback, Model,
                                         ModelCheckpoint, ProgBarLogger,
                                         summary)
from paddle_infer_tpu_torch.metric import Accuracy
from paddle_infer_tpu_torch.models import (ErnieConfig,
                                           ErnieForSequenceClassification)
from paddle_infer_tpu_torch.weights import from_jax_state_dict

TOL = dict(rtol=1e-5, atol=1e-5)


def _toy_loader(n=64, batch=16, seed=0, dim=8, classes=3):
    """``tests/test_hapi.py``'s toy data: a list of (x, y) batches."""
    rng = np.random.RandomState(seed)
    w = rng.randn(dim, classes)
    x = rng.randn(n, dim).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.randn(n, classes), axis=1)
    return [(x[i:i + batch], y[i:i + batch].astype(np.int64))
            for i in range(0, n, batch)]


def _jax_mlp(seed):
    pit.seed(seed)
    return pit.nn.Sequential(pit.nn.Linear(8, 32), pit.nn.ReLU(),
                             pit.nn.Linear(32, 3))


def _port_of(jnet):
    net = tnn.Sequential(tnn.Linear(8, 32, device="cpu"), tnn.ReLU(),
                         tnn.Linear(32, 3, device="cpu"))
    from_jax_state_dict(net, {k: np.asarray(v.numpy())
                              for k, v in jnet.state_dict().items()})
    return net.requires_grad_(True)


def _mlp(seed):
    """A trainable port MLP with a JAX MLP's initial weights."""
    return _port_of(_jax_mlp(seed))


# ------------------------------------------- tests/test_hapi.py on the port

def test_fit_evaluate_predict():
    net = _mlp(0)
    model = Model(net)
    model.prepare(optimizer=topt.AdamW(learning_rate=5e-2,
                                       parameters=net.parameters()),
                  loss=tnn.CrossEntropyLoss(), metrics=Accuracy())
    data = _toy_loader()
    hist = model.fit(data, eval_data=data, epochs=6, verbose=0)
    assert hist["loss"][-1] < hist["loss"][0] * 0.7
    logs = model.evaluate(data)
    assert logs["acc"] > 0.7
    assert "loss" in logs
    preds = model.predict(data)
    assert len(preds) == len(data)
    assert preds[0].shape == (16, 3)


def test_save_load_roundtrip(tmp_path):
    net = _mlp(1)
    model = Model(net)
    model.prepare(optimizer=topt.AdamW(learning_rate=1e-2,
                                       parameters=net.parameters()),
                  loss=tnn.CrossEntropyLoss())
    data = _toy_loader(32, 16, seed=2)
    model.fit(data, epochs=1, verbose=0)
    path = str(tmp_path / "ckpt" / "model")
    model.save(path)
    assert os.path.exists(path + ".pdparams")
    assert os.path.exists(path + ".pdopt")
    x = data[0][0]
    want = model.predict_batch([x])
    m2 = Model(_mlp(5))
    m2.prepare(loss=tnn.CrossEntropyLoss())
    m2.load(path, reset_optimizer=True)
    np.testing.assert_array_equal(m2.predict_batch([x]), want)
    # the optimizer's state comes back too
    net3 = _mlp(6)
    opt3 = topt.AdamW(learning_rate=1e-2, parameters=net3.parameters())
    m3 = Model(net3).prepare(optimizer=opt3, loss=tnn.CrossEntropyLoss())
    m3.load(path)
    assert opt3._step_count == model._optimizer._step_count == 2
    for p, q in zip(opt3._parameters, model._optimizer._parameters):
        for k, v in model._optimizer._state[id(q)].items():
            torch.testing.assert_close(opt3._state[id(p)][k], v)


def test_fit_checkpoint_dir(tmp_path):
    net = _mlp(2)
    model = Model(net)
    model.prepare(optimizer=topt.SGD(learning_rate=1e-2,
                                     parameters=net.parameters()),
                  loss=tnn.CrossEntropyLoss())
    model.fit(_toy_loader(32), epochs=2, verbose=0, save_dir=str(tmp_path))
    assert os.path.exists(str(tmp_path / "0.pdparams"))
    assert os.path.exists(str(tmp_path / "final.pdparams"))


def _stopping_pair(patience):
    out = []
    for model_cls, mlp, sgd, loss, stop in (
            (JModel, _jax_mlp, pit.optimizer.SGD, pit.nn.CrossEntropyLoss,
             JEarlyStopping),
            (Model, _mlp, topt.SGD, tnn.CrossEntropyLoss, EarlyStopping)):
        net = mlp(3)
        model = model_cls(net)
        model.prepare(optimizer=sgd(learning_rate=0.0,
                                    parameters=net.parameters()),
                      loss=loss())
        cb = stop(monitor="loss", patience=patience, min_delta=1e-9)
        hist = model.fit(_toy_loader(32), epochs=10, verbose=0,
                         callbacks=[cb])
        out.append((cb, hist))
    return out


@pytest.mark.parametrize("patience", [0, 1, 3])
def test_early_stopping_equals_jax(patience):
    """``tests/test_hapi.py::test_early_stopping`` (no progress at rate 0)
    on both packages: the same stopped epoch and history."""
    (jcb, jh), (tcb, th) = _stopping_pair(patience)
    assert tcb.stopped_epoch is not None and tcb.stopped_epoch < 9
    assert tcb.stopped_epoch == jcb.stopped_epoch == patience + 1
    np.testing.assert_allclose(th["loss"], jh["loss"], **TOL)


# ------------------------------------------------------- parity with JAX

class _Rec:
    """Every batch's and epoch's logs and the rate at each batch."""

    def __init__(self):
        self.batches, self.epochs, self.rates = [], [], []

    def on_train_batch_begin(self, step, logs=None):
        self.rates.append(self.model._optimizer.get_lr())

    def on_train_batch_end(self, step, logs=None):
        self.batches.append(dict(logs))

    def on_epoch_end(self, epoch, logs=None):
        self.epochs.append(dict(logs))


class JRec(_Rec, JCallback):
    pass


class TRec(_Rec, Callback):
    pass


def _logs_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)


def _fit_pair(sched=None, by_step=False, epochs=3):
    """The JAX and port Models on one MLP's weights, fit on the toy
    loader (with ``LRSchedulerCallback`` when ``sched`` builds a
    schedule from an ``lr`` module)."""
    data = _toy_loader()
    out = []
    for model_cls, net, opt, loss, acc, rec, lrcb, lrmod in (
            (JModel, _jax_mlp(0), pit.optimizer.AdamW,
             pit.nn.CrossEntropyLoss, JAccuracy, JRec, JLRCallback,
             pit.optimizer.lr),
            (Model, _mlp(0), topt.AdamW, tnn.CrossEntropyLoss, Accuracy,
             TRec, LRSchedulerCallback, topt.lr)):
        lr = sched(lrmod) if sched else 5e-2
        model = model_cls(net)
        model.prepare(optimizer=opt(learning_rate=lr,
                                    parameters=net.parameters()),
                      loss=loss(), metrics=acc(topk=(1, 2)))
        r = rec()
        cbs = [r] + ([lrcb(by_step=by_step)] if sched else [])
        hist = model.fit(data, eval_data=data, epochs=epochs, verbose=0,
                         callbacks=cbs)
        out.append((model, hist, r))
    return data, out


def test_fit_evaluate_predict_equal_jax():
    data, ((jm, jh, jr), (tm, th, tr)) = _fit_pair()
    np.testing.assert_allclose(th["loss"], jh["loss"], **TOL)
    _logs_close(tr.batches, jr.batches)
    _logs_close(tr.epochs, jr.epochs)
    assert set(tr.epochs[0]) == {"loss", "acc", "eval_acc", "eval_loss"}
    _logs_close([tm.evaluate(data)], [jm.evaluate(data)])
    for got, want in zip(tm.predict(data), jm.predict(data)):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("by_step", [False, True])
def test_lr_scheduler_callback_rates_equal_jax(by_step):
    def sched(m):
        return m.LinearWarmup(m.PiecewiseDecay([3, 6], [5e-2, 2e-2, 1e-2]),
                              warmup_steps=2, start_lr=1e-3, end_lr=5e-2)

    _, ((_, jh, jr), (tm, th, tr)) = _fit_pair(sched, by_step)
    assert tr.rates == jr.rates
    assert len(set(tr.rates)) > 2
    assert tm._optimizer.get_lr() == jr.model._optimizer.get_lr()
    np.testing.assert_allclose(th["loss"], jh["loss"], **TOL)


def test_pdparams_load_across_packages(tmp_path):
    data = _toy_loader(32, 16, seed=2)
    x = data[0][0]
    jnet = _jax_mlp(4)
    jm = JModel(jnet)
    jm.prepare(optimizer=pit.optimizer.AdamW(learning_rate=1e-2,
                                             parameters=jnet.parameters()),
               loss=pit.nn.CrossEntropyLoss())
    jm.fit(data, epochs=1, verbose=0)
    jm.save(str(tmp_path / "jax"))
    tm = Model(_mlp(5)).prepare(loss=tnn.CrossEntropyLoss())
    tm.load(str(tmp_path / "jax"), reset_optimizer=True)
    np.testing.assert_allclose(tm.predict_batch([x]), jm.predict_batch([x]),
                               **TOL)
    # and back: the port trains on, saves; JAX loads it
    tnet = tm.network
    tm.prepare(optimizer=topt.AdamW(learning_rate=1e-2,
                                    parameters=tnet.parameters()),
               loss=tnn.CrossEntropyLoss())
    tm.fit(data, epochs=1, verbose=0)
    tm.save(str(tmp_path / "torch"))
    jm2 = JModel(_jax_mlp(6))
    jm2.prepare(loss=pit.nn.CrossEntropyLoss())
    jm2.load(str(tmp_path / "torch"), reset_optimizer=True)
    np.testing.assert_allclose(jm2.predict_batch([x]), tm.predict_batch([x]),
                               **TOL)
    state = tload(str(tmp_path / "torch") + ".pdparams")
    assert all(isinstance(v, np.ndarray) for v in state.values())


def test_save_formats(tmp_path):
    """``save``: a ``.pits`` path takes a flat dict of tensors, read back
    bitwise (bf16 too); a pickle holds numpy arrays, bf16 widened to
    float32; nested objects refuse ``.pits``."""
    t = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    tsave(t, str(tmp_path / "sub" / "w.pits"))
    back = tload(str(tmp_path / "sub" / "w.pits"))
    assert back.keys() == t.keys()
    for k in t:
        assert back[k].dtype == t[k].dtype and torch.equal(back[k], t[k])
    tsave({"x": t, "n": 3, "l": [t["a"]]}, str(tmp_path / "o.pdopt"))
    o = tload(str(tmp_path / "o.pdopt"))
    assert o["n"] == 3 and o["x"]["b"].dtype == np.float32
    np.testing.assert_array_equal(o["l"][0], t["a"].numpy())
    with pytest.raises(TypeError, match="flat"):
        tsave({"x": t}, str(tmp_path / "n.pits"))


@pytest.mark.parametrize("traced", [False, True])
def test_summary_rows_equal_jax(traced, capsys):
    jnet = _jax_mlp(0)
    tnet = _port_of(jnet)
    kw = dict(input_size=(16, 8)) if traced else {}
    want = jsummary(jnet, **kw)
    got = Model(tnet).summary(**kw)
    assert got["total_params"] == want["total_params"] == 387
    assert got["trainable_params"] == want["trainable_params"]
    assert [(n, c, tuple(s) if s is not None else None, k)
            for n, c, s, k in got["layers"]] == \
        [(n, c, tuple(s) if s is not None else None, k)
         for n, c, s, k in want["layers"]]
    assert "Total params: 387" in capsys.readouterr().out
    tnet[0].requires_grad_(False)
    assert summary(tnet)["trainable_params"] == 99


def test_callbacks_and_progbar(capsys, tmp_path):
    """``ProgBarLogger`` prints per ``log_freq`` batches and per epoch;
    ``ModelCheckpoint`` saves every ``save_freq`` epochs; prepare
    refuses a metric that is not one; train needs a loss."""
    net = _mlp(7)
    model = Model(net)
    model.prepare(optimizer=topt.SGD(learning_rate=1e-2,
                                     parameters=net.parameters()),
                  loss=tnn.CrossEntropyLoss(), metrics=[Accuracy()])
    model.fit(_toy_loader(), epochs=2, log_freq=2,
              callbacks=[ModelCheckpoint(2, str(tmp_path))])
    out = capsys.readouterr().out
    assert "Epoch 2/2" in out and "step 2:" in out and "acc:" in out
    assert os.path.exists(str(tmp_path / "0.pdparams"))
    assert not os.path.exists(str(tmp_path / "1.pdparams"))
    assert isinstance(ProgBarLogger(), Callback)
    with pytest.raises(TypeError):
        Model(net).prepare(metrics=["acc"])
    with pytest.raises(RuntimeError, match="prepare"):
        Model(net).train_batch(*_toy_loader()[0])


# --------------------------------------------------- the slice as a whole

ERNIE = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=64,
             max_position_embeddings=32, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)


class _Marked(tio.Dataset):
    """Token rows whose label is set by the token at position 0."""

    def __init__(self, n=12, s=16, seed=0):
        rng = np.random.RandomState(seed)
        self.ids = rng.randint(2, ERNIE["vocab_size"], (n, s))
        self.labels = rng.randint(0, 2, (n,))
        self.ids[:, 0] = self.labels

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.ids[i].astype(np.int64), np.int64(self.labels[i])


def test_ernie_classifier_fit_equals_jax():
    """A tiny ``ErnieForSequenceClassification`` at dropout 0: 3 batches
    of a worker-process ``DataLoader`` through both ``Model``s (AdamW,
    cross-entropy, accuracy); every batch's loss within 1e-5."""
    pit.seed(0)
    jnet = JErnieCls(JErnieConfig(**ERNIE), num_classes=2)
    jnet.train()
    tnet = ErnieForSequenceClassification(ErnieConfig(**ERNIE),
                                          num_classes=2, device="cpu",
                                          keys=KeyStream(1))
    from_jax_state_dict(tnet, {k: np.asarray(v.numpy())
                               for k, v in jnet.state_dict().items()})
    jdata = [(ids, lab) for ids, lab in tio.DataLoader(
        _Marked(), batch_size=4, to_tensor=False)]
    tdata = tio.DataLoader(_Marked(), batch_size=4, num_workers=2)
    recs = []
    for model_cls, net, opt, loss, acc, rec, data in (
            (JModel, jnet, pit.optimizer.AdamW, pit.nn.CrossEntropyLoss,
             JAccuracy, JRec, jdata),
            (Model, tnet, topt.AdamW, tnn.CrossEntropyLoss, Accuracy, TRec,
             tdata)):
        model = model_cls(net)
        model.prepare(optimizer=opt(learning_rate=1e-3,
                                    parameters=net.parameters()),
                      loss=loss(), metrics=acc())
        r = rec()
        model.fit(data, epochs=1, verbose=0, callbacks=[r])
        recs.append(r)
    assert len(recs[1].batches) == 3
    _logs_close(recs[1].batches, recs[0].batches)
    assert len(tdata.last_worker_pids) >= 1
    assert os.getpid() not in tdata.last_worker_pids


def test_chip_smoke_hapi_phase_on_cpu(monkeypatch):
    """``chip_smoke``'s ``[hapi]`` phase at a tiny ERNIE on the CPU (the
    wrappers take their plain versions, no flash launch): the fit, the
    held-out accuracy bar, save / load EQUAL, the worker processes."""
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    cfg = ErnieConfig(**dict(ERNIE, max_position_embeddings=64))
    res = chip_smoke.hapi_phase(torch.device("cpu"), "cpu", cfg=cfg,
                                train_rows=128, eval_rows=32, batch=16,
                                seq=16, peak_lr=3e-3)
    assert res["launches"] == {"flash_fwd": 0, "flash_dkdv": 0,
                               "flash_dq": 0}
