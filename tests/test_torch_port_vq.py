"""The port's VQ state transitions against ``vq_gnn_tpu.nn.vq`` on the same
numpy inputs: ``feature_update``, ``vq_update`` (live, BN seeded or not) and
``lookup``, for the plain ('xla') and kernel ('pallas') backends."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu.nn import vq as jvq
from vq_gnn_tpu_torch.convert import vq_state_from_numpy
from vq_gnn_tpu_torch.nn import vq as tvq

NB, N, B, M, D = 4, 500, 300, 16, 4
B_REAL = 260  # rows [B_REAL, B) are padding (dustbin id N, invalid)
ATOL = 1e-5  # f32 statistics summed in another order


def _params(mod, backend):
    return mod.VQParams(num_M=M, num_D=D, warm_up_flag=True, backend=backend)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(NB, B, D).astype(np.float32) * 2 + 0.5
    G = rng.randn(NB, B, D).astype(np.float32) * 1e-3
    ids = np.full(B, N, np.int64)
    ids[:B_REAL] = rng.choice(N, B_REAL, replace=False)
    valid = np.arange(B) < B_REAL
    return X, G, ids, valid


def _jax_state(backend, bn_inited):
    s = jvq.init_vq_state(jax.random.PRNGKey(0), NB, N, _params(jvq, backend))
    if bn_inited:
        rng = np.random.RandomState(9)
        s = s.replace(
            bn_inited=jnp.asarray(True),
            bn_feat_mean=jnp.asarray(rng.randn(NB, D).astype(np.float32)),
            bn_feat_var=jnp.asarray(rng.rand(NB, D).astype(np.float32) + 0.5),
            bn_grad_mean=jnp.asarray(rng.randn(NB, D).astype(np.float32) * 1e-3),
            bn_grad_var=jnp.asarray(rng.rand(NB, D).astype(np.float32) * 1e-6),
            embedding_output=jnp.asarray(rng.randn(NB, M, 2 * D).astype(np.float32)),
        )
    return s


def _assert_states_match(js, ts):
    for f in dataclasses.fields(tvq.VQState):
        a = np.asarray(getattr(js, f.name))
        b = getattr(ts, f.name).numpy()
        if f.name == "c_indices":
            # the dustbin row N receives one of the padded slots' rows, in an
            # unspecified order
            np.testing.assert_array_equal(a[:N], b[:N])
        elif a.dtype == bool:
            assert a == b, f.name
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=ATOL, err_msg=f.name)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_feature_update_matches_jax(backend):
    X, _, ids, valid = _inputs(1)
    js = _jax_state(backend, False)
    ts = vq_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    js2, jidx = jvq.feature_update(
        js, jnp.asarray(X), jnp.asarray(ids, jnp.int32), _params(jvq, backend),
        valid=jnp.asarray(valid),
    )
    ts2, tidx = tvq.feature_update(
        ts, torch.as_tensor(X), torch.as_tensor(ids), _params(tvq, backend),
        valid=torch.as_tensor(valid),
    )
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _assert_states_match(js2, ts2)


@pytest.mark.parametrize("bn_inited", [False, True])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_vq_update_matches_jax(backend, bn_inited):
    X, G, ids, valid = _inputs(2)
    js = _jax_state(backend, bn_inited)
    ts = vq_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    for step in range(2):  # the second step reads the first one's state
        js, jidx = jvq.vq_update(
            js, jnp.asarray(X), jnp.asarray(G), jnp.asarray(ids, jnp.int32),
            _params(jvq, backend), valid=jnp.asarray(valid),
        )
        ts, tidx = tvq.vq_update(
            ts, torch.as_tensor(X), torch.as_tensor(G), torch.as_tensor(ids),
            _params(tvq, backend), valid=torch.as_tensor(valid),
        )
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        _assert_states_match(js, ts)
        X = X[:, ::-1].copy()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_lookup_matches_jax(backend):
    js = _jax_state(backend, True)
    ts = vq_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    ids = np.random.RandomState(5).randint(0, N + 1, 333)
    jf, jg = jvq.lookup(js, jnp.asarray(ids, jnp.int32), _params(jvq, backend))
    tf, tg = tvq.lookup(ts, torch.as_tensor(ids), _params(tvq, backend))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
