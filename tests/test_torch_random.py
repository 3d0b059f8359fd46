"""Port parity: the threefry-2x32 keys of ``paddle_infer_tpu_torch.core.
random`` against ``jax.random`` — key words and uniform bits EQUAL, and
categorical draws equal on fixed logits (the serving plane's per-row
sampling streams depend on all three)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_infer_tpu_torch.core import random as R


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 1234, -1, 2 ** 31 - 1])
def test_prng_key_equal(seed):
    np.testing.assert_array_equal(R.PRNGKey(seed).numpy(),
                                  _np(jax.random.PRNGKey(seed)))


def test_prng_key_rejects_64bit_seed():
    with pytest.raises(ValueError):
        R.PRNGKey(2 ** 40)


@pytest.mark.parametrize("data", [0, 1, 7, 12345, 2 ** 31, 2 ** 32 - 1])
def test_fold_in_equal(data):
    k = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(R.fold_in(R.PRNGKey(3), data).numpy(),
                                  _np(jax.random.fold_in(k, data)))


def test_fold_in_batched_equals_vmap():
    """The serving step folds per-row steps into per-row keys."""
    base = jax.random.PRNGKey(0)
    keys = jax.vmap(jax.random.fold_in)(jnp.stack([base] * 5),
                                        jnp.arange(100, 105))
    steps = jnp.asarray([0, 3, 9, 31, 2], jnp.int32)
    want = jax.vmap(jax.random.fold_in)(keys, steps)
    got = R.fold_in(torch.tensor(_np(keys)), torch.tensor(np.asarray(steps)))
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (1000,)])
def test_uniform_bits_equal(shape):
    k = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    want = np.asarray(jax.random.uniform(k, shape))
    got = R.uniform(torch.tensor(_np(k)), shape).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_minval_maxval_equal():
    k = jax.random.PRNGKey(5)
    tiny = float(jnp.finfo(jnp.float32).tiny)
    want = np.asarray(jax.random.uniform(k, (64,), minval=tiny, maxval=1.0))
    got = R.uniform(R.PRNGKey(5), (64,), minval=tiny, maxval=1.0).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_categorical_draws_equal(seed):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(6, 96) * 2).astype(np.float32)
    logits[:, ::7] = -1e9                        # masked entries
    keys = jax.vmap(jax.random.fold_in)(
        jnp.stack([jax.random.PRNGKey(seed)] * 6), jnp.arange(6))
    want = np.asarray(jax.vmap(
        lambda k, row: jax.random.categorical(k, row))(keys, logits))
    got = R.categorical(torch.tensor(_np(keys)),
                        torch.tensor(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def test_categorical_single_key():
    logits = np.random.RandomState(9).randn(40).astype(np.float32)
    k = jax.random.PRNGKey(9)
    want = int(jax.random.categorical(k, logits))
    got = int(R.categorical(R.PRNGKey(9), torch.tensor(logits)))
    assert got == want


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
@pytest.mark.parametrize("num", [2, 5])
def test_split_equal(seed, num):
    k = jax.random.key(seed)
    want = _np(jax.random.key_data(jax.random.split(k, num)))
    np.testing.assert_array_equal(R.split(R.PRNGKey(seed), num).numpy(),
                                  want)


@pytest.mark.parametrize("seed", [0, 9, 77])
def test_scalar_bits_equal(seed):
    k = jax.random.fold_in(jax.random.key(seed), 5)
    want = int(jax.random.bits(k, dtype=jnp.uint32))
    tk = torch.tensor(_np(jax.random.key_data(k)))
    assert int(R.bits(tk)) == want == R.seed_from_key(tk)


def test_key_stream_follows_the_jax_global_key():
    """``KeyStream`` against the JAX package's ``core/random.py``: global
    splits, then ``fold_in(base, counter)`` inside a trace scope."""
    from paddle_infer_tpu.core import random as JR

    JR.seed(21)
    ks = R.KeyStream(21)
    for _ in range(3):
        np.testing.assert_array_equal(
            ks.next_key().numpy(), _np(jax.random.key_data(JR.next_key())))
    base = JR.next_key()
    tbase = ks.next_key()
    with JR.trace_key_scope(base), ks.trace_key_scope(tbase):
        for _ in range(4):
            np.testing.assert_array_equal(
                ks.next_key().numpy(),
                _np(jax.random.key_data(JR.next_key())))
    np.testing.assert_array_equal(ks.next_key().numpy(),
                                  _np(jax.random.key_data(JR.next_key())))
