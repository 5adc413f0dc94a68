"""The port's VQ state transitions against ``vq_gnn_tpu.nn.vq`` on the same
numpy inputs: ``feature_update``, ``vq_update`` (live, BN seeded or not) and
``lookup``, for the plain ('xla') and kernel ('pallas') backends; and the
masked BN moments bit for bit against the two-pass formula."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu.nn import vq as jvq
from vq_gnn_tpu_torch.convert import vq_state_from_numpy
from vq_gnn_tpu_torch.nn import vq as tvq
from vq_gnn_tpu_torch.ops.vq_kernels import lookup_codewords, lookup_codewords_plain
from vq_gnn_tpu_torch.ops.vq_ops import masked_moments
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

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


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("K,D", [(8, 4), (9, 4)])
def test_lookup_plain_split_equals_slices(K, D, fast):
    """``split=D`` gives the [n, nb, K] table's two halves, each contiguous,
    from the plain version and from the wrapper (which runs it on the CPU);
    a split outside (0, K) is refused."""
    rng = np.random.RandomState(11)
    c_idx = torch.as_tensor(rng.randint(0, M, (N + 1, NB)).astype(np.int16))
    ids = torch.as_tensor(rng.randint(0, N + 1, 333))
    emb = torch.as_tensor(rng.randn(NB, M, K).astype(np.float32))
    table = lookup_codewords_plain(c_idx, ids, emb, fast)
    n = ids.shape[0]
    halves = (table[:, :, :D].reshape(n, NB * D), table[:, :, D:].reshape(n, NB * (K - D)))
    for fn in (lookup_codewords_plain, lookup_codewords):
        out = fn(c_idx, ids, emb, fast, split=D)
        for o, r in zip(out, halves, strict=True):
            assert o.is_contiguous() and torch.equal(o, r)
    for bad in (0, K):
        with pytest.raises(ValueError):
            lookup_codewords(c_idx, ids, emb, fast, split=bad)


@pytest.mark.parametrize("add_flag", [False, True])
@pytest.mark.parametrize("backend", ["pallas", "pallas_fast"])
def test_lookup_kernel_backends_match_jax(backend, add_flag):
    """``lookup`` on the kernel backends (the kernel writes the two halves
    apart) against the JAX ``lookup`` (``lookup_branches`` in interpret
    mode): bit-equal at K = 2D = 8 and, with ``add_flag``, K = 2D + 1 = 9."""
    kw = dict(num_M=M, num_D=D, warm_up_flag=True, backend=backend, add_flag=add_flag)
    jp, tp = jvq.VQParams(**kw), tvq.VQParams(**kw)
    js = jvq.init_vq_state(jax.random.PRNGKey(0), NB, N, jp)
    rng = np.random.RandomState(12)
    K = js.embedding_output.shape[2]
    assert K == 2 * D + add_flag
    js = js.replace(
        embedding_output=jnp.asarray(rng.randn(NB, M, K).astype(np.float32)),
        c_indices=jnp.asarray(rng.randint(0, M, js.c_indices.shape).astype(np.int16)),
    )
    ts = vq_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    ids = rng.randint(0, N + 1, 333)
    jf, jg = jvq.lookup(js, jnp.asarray(ids, jnp.int32), jp)
    tf, tg = tvq.lookup(ts, torch.as_tensor(ids), tp)
    assert tg.shape == (len(ids), NB * (K - D))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_vq_update_add_flag_matches_jax(backend):
    """The B + M GAT layers quantize the ones-column gradient too
    (``add_flag``): K = 2D + 1, and index 2D takes grad_scale[1] in the init
    scale, the normalised input and the de-normalisation."""
    X, G, ids, valid = _inputs(4)
    G1 = np.concatenate([G, np.random.RandomState(6).randn(NB, B, 1).astype(np.float32)], 2)
    kw = dict(num_M=M, num_D=D, warm_up_flag=True, backend=backend, add_flag=True,
              grad_scale=(0.7, 0.3))
    jp, tp = jvq.VQParams(**kw), tvq.VQParams(**kw)
    js = jvq.init_vq_state(jax.random.PRNGKey(0), NB, N, jp)
    ts = vq_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert ts.embedding.shape == (NB, M, 2 * D + 1) and tp.grad_dim == D + 1
    for step in range(2):
        js, jidx = jvq.vq_update(js, jnp.asarray(X), jnp.asarray(G1),
                                 jnp.asarray(ids, jnp.int32), jp, valid=jnp.asarray(valid))
        ts, tidx = tvq.vq_update(ts, torch.as_tensor(X), torch.as_tensor(G1),
                                 torch.as_tensor(ids), tp, valid=torch.as_tensor(valid))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        _assert_states_match(js, ts)
    jf, jg = jvq.lookup(js, jnp.asarray(ids, jnp.int32), jp)
    tf, tg = tvq.lookup(ts, torch.as_tensor(ids), tp)
    assert tg.shape == (B, NB * (D + 1))
    # the tables after two updates agree to the state tolerance, not bitwise
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=ATOL)


def test_init_add_flag_matches_jax():
    """init_vq_state's grad-half scaling with the ones-column dim: the port
    draws its own random numbers, so compare the scale it applies."""
    p = tvq.VQParams(num_M=M, num_D=D, warm_up_flag=True, add_flag=True, grad_scale=(0.5, 0.0))
    s = tvq.init_vq_state(torch.Generator().manual_seed(0), NB, N, p, torch.device("cpu"))
    assert s.embedding.shape == (NB, M, 2 * D + 1)
    assert (s.embedding[:, :, 2 * D] == 0).all() and (s.ema_w[:, :, 2 * D] == 0).all()
    assert (s.embedding[:, :, :D] != 0).all() and s.bn_grad_mean.shape == (NB, D + 1)


def _two_pass(x, valid, ddof):
    """The masked mean and variance as two separate passes per ddof (the
    form ``masked_moments`` replaces)."""
    if valid is None:
        n = float(x.shape[-2])
        mean = x.mean(-2)
        return mean, ((x - mean.unsqueeze(-2)) ** 2).sum(-2) / max(n - ddof, 1.0)
    v = valid.to(x.dtype)[:, None]
    n = torch.clamp(v.sum(), min=1.0)
    mean = (x * v).sum(-2) / n
    var = (((x - mean.unsqueeze(-2)) ** 2) * v).sum(-2) / torch.clamp(n - ddof, min=1.0)
    return mean, var


def _mask(kind, rows, rng):
    if kind == "none":
        return None
    if kind == "all-invalid":
        return torch.zeros(rows, dtype=torch.bool)
    if kind == "one-valid":
        return torch.as_tensor(np.arange(rows) == rng.randint(rows))
    return torch.as_tensor(rng.rand(rows) < rng.uniform(0.2, 0.95))


@pytest.mark.parametrize("kind", ["random-0", "random-1", "random-2", "all-invalid",
                                  "one-valid", "none"])
@pytest.mark.parametrize("shape", [(NB, B, D), (B, 40)])
def test_masked_moments_bit_equal_two_pass(shape, kind):
    """Each of (mean, biased var, unbiased var) equals the two-pass formula's
    bits, for a [nb, B, d] pair (the VQ update's [X_B || grad]) and a [B, C]
    activation (the inter-layer BN)."""
    rng = np.random.RandomState(sum(map(ord, kind)) + len(shape))
    xs = [torch.as_tensor(rng.randn(*shape).astype(np.float32) * s + o)
          for s, o in ((2.0, 0.5), (1e-3, 0.0))]
    valid = _mask(kind, shape[-2], rng)
    for x, (mean, var, var_u) in zip(xs, masked_moments(xs, valid), strict=True):
        ref_mean, ref_var = _two_pass(x, valid, 0)
        _, ref_var_u = _two_pass(x, valid, 1)
        for got, ref in ((mean, ref_mean), (var, ref_var), (var_u, ref_var_u)):
            assert torch.equal(got, ref)


@pytest.mark.parametrize("kind", ["random-0", "one-valid", "all-invalid"])
def test_masked_moments_summed_over_shards(kind):
    """Two row shards in lock step (threads), each with a ``stats_reduce``
    that sums both shards' lists as an all-reduce does: every shard gets the
    moments of all rows, the one transition of the data-parallel step
    (summation order differs, so within f32 rounding)."""
    rng = np.random.RandomState(3)
    xs = [torch.as_tensor(rng.randn(NB, B, D).astype(np.float32) * 2 + 0.5),
          torch.as_tensor(rng.randn(NB, B, D).astype(np.float32) * 1e-3)]
    valid = _mask(kind, B, rng)
    cut = (0, 120, B)
    posted = [None, None]
    barrier = threading.Barrier(2)
    got = [None, None]

    def rank(r):
        def all_reduce(tensors):
            posted[r] = tensors
            barrier.wait()
            out = [a + b for a, b in zip(*posted, strict=True)]
            barrier.wait()  # both have read this round before the next posts
            return out

        a, b = cut[r], cut[r + 1]
        got[r] = masked_moments([x[:, a:b] for x in xs], valid[a:b], stats_reduce=all_reduce)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    whole = masked_moments(xs, valid)
    for g in got:
        for g3, w3 in zip(g, whole, strict=True):
            for a, w in zip(g3, w3, strict=True):
                torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-7)
