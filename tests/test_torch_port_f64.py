"""float64 through the port's plain versions, on the CPU: a diagnostic, not a
compute dtype (``vq_gnn_tpu_torch/config.py:sum_dtype``, ``stream_dtype``).

A state and features cast to float64 (``convert.py:state_as``,
``predictor_as``, ``batch_as``) run the plain versions in float64, where a
sum in another order moves a value by about 2^-29 of what it moves in f32;
``tests/test_torch_port_mesh.py`` (l) holds the sharded steps to the whole
batch's that way, and ``tools/link_hold_probe_torch.py --f64`` the card's
states.  Here:

- float64 is no compute dtype: ``config.torch_dtype`` and ``model_static``
  raise by name, ``COMPUTE_DTYPES`` holds the JAX package's three;
- each plain version on the path (kernel 1 through ``ops/spmm.py``, kernel
  8, ``take_rows``' backward, ``sum_at``, kernel 2, the plain assignment
  statistics, kernel 3) keeps float64 inputs float64, against a float64
  numpy reference to 1e-12 of its largest value, and f32 ones f32;
- the cast helpers carry every value (integers and flags unchanged);
- the whole batch's link step in float64 against the JAX package's f32
  ``make_link_step`` from one state on the JAX negatives, at
  ``tests/test_torch_port_link.py``'s tolerances (f32 rounding is all that
  parts them).

On the card every kernel's wrapper refuses float64 by name
(``tests/test_torch_port_kernels.py::test_cuda_wrappers_refuse_float64``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.convert import (
    batch_as,
    predictor_as,
    predictor_from_numpy,
    predictor_to_numpy,
    state_as,
    state_from_numpy,
    state_to_numpy,
)
from vq_gnn_tpu_torch.nn import model as tmodel
from vq_gnn_tpu_torch.ops.segsum import segment_sum_sorted, sum_at, take_rows
from vq_gnn_tpu_torch.ops.spmm import Edges, rows_aggregate
from vq_gnn_tpu_torch.ops.vq_kernels import fused_assign_branches, lookup_codewords
from vq_gnn_tpu_torch.ops.vq_ops import assignment_stats
from vq_gnn_tpu_torch.sampler import samplers as tsamplers
from vq_gnn_tpu_torch.train import link as tlink
from vq_gnn_tpu_torch.train.loop import device_features
from vq_gnn_tpu_torch.train.optim import make_rmsprop, rmsprop_nu
from vq_gnn_tpu_torch.train.state import init_train_state
from tests.test_torch_port_mesh import (
    LR,
    _jax_batch,
    _jax_dst_neg,
    _jax_setup,
    _plain,
    _port_graph,
)
from tests.test_torch_port_native import steady_native
from vq_gnn_tpu.train import link as jlink
from vq_gnn_tpu.train.loop import device_features as j_device_features
from vq_gnn_tpu.train.optim import init_rmsprop as j_init_rmsprop

steady_native()  # one native host library on both sides (that file says why)

REL64 = 1e-12  # float64 against numpy's float64, of the largest value


def test_float64_is_not_a_compute_dtype():
    """``config.torch_dtype('float64')`` raises by name, as ``check_ported``
    (through ``model_static``) does for a Config that asks for it; the
    compute dtypes are the JAX package's three.  ``stream_dtype`` keeps
    float64 rows only under f32 compute."""
    assert set(tcfg.COMPUTE_DTYPES) == {"float32", "bfloat16", "float16"}
    with pytest.raises(NotImplementedError, match="compute_dtype='float64'"):
        tcfg.torch_dtype("float64")
    cfg = tcfg.Config(compute_dtype="float64", num_layers=2, hidden_channels=16, num_D=4,
                      num_M=8)
    with pytest.raises(NotImplementedError, match="compute_dtype='float64'"):
        tmodel.model_static(cfg, 16, 4, torch.device("cpu"))
    assert tcfg.sum_dtype(torch.float64) == torch.float64
    assert all(tcfg.sum_dtype(d) == torch.float32
               for d in (torch.float32, torch.bfloat16, torch.float16))
    assert tcfg.stream_dtype("float32", torch.float64) == torch.float64
    assert tcfg.stream_dtype("bfloat16", torch.float64) == torch.bfloat16
    assert tcfg.stream_dtype("float32", torch.float32) == torch.float32
    with pytest.raises(NotImplementedError, match="compute_dtype='float64'"):
        tcfg.stream_dtype("float64", torch.float64)


def _ell(rng, rows=40, cols=60, S=90, K=4):
    """A sorted slot-ELL [S, K] over ``rows`` rows, padding slots at ``rows``."""
    row = np.sort(rng.integers(0, rows + 1, S)).astype(np.int32)
    col = rng.integers(0, cols, (S, K)).astype(np.int32)
    val = rng.standard_normal((S, K)).astype(np.float32)
    return row, col, val


def _ell_ref(row, col, val, x, rows):
    out = np.zeros((rows + 1, x.shape[1]))
    np.add.at(out, row, np.einsum("sk,skc->sc", val.astype(np.float64), x[col]))
    return out[:rows]


def _held(got, want, dtype):
    assert got.dtype == dtype, (got.dtype, dtype)
    tol = REL64 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("fn", ["ell_aggregate", "segment_sum", "take_rows", "sum_at",
                                "assign", "assignment_stats", "lookup"])
def test_plain_versions_keep_float64(fn, dtype):
    """Each plain version on the GCN link path keeps float64 inputs float64
    (f32 ones f32), against numpy's float64 to 1e-12 of the largest value
    (f32: 1e-5).  Kernel 1 is reached as the step reaches it, through
    ``ops/spmm.py:rows_aggregate``: its wrapper takes its kernel's row
    dtypes alone (``tests/test_torch_port_kernels.py::
    test_wrappers_refuse_float16``)."""
    rng = np.random.default_rng(64)
    if fn == "ell_aggregate":
        row, col, val = _ell(rng)
        x = rng.standard_normal((60, 8))
        e = Edges(ell_row=torch.as_tensor(row), ell_col=torch.as_tensor(col),
                  ell_val=torch.as_tensor(val), num_rows=40)
        _held(rows_aggregate(e, torch.as_tensor(x, dtype=dtype)),
              _ell_ref(row, col, val, x, 40), dtype)
    elif fn == "segment_sum":
        seg = np.sort(rng.integers(0, 31, 200)).astype(np.int32)
        part = rng.standard_normal((200, 5))
        want = np.zeros((31, 5))
        np.add.at(want, seg, part)
        _held(segment_sum_sorted(torch.as_tensor(part, dtype=dtype), torch.as_tensor(seg), 30),
              want[:30], dtype)
    elif fn == "take_rows":
        table = torch.tensor(rng.standard_normal((30, 6)), dtype=dtype, requires_grad=True)
        idx = [rng.integers(0, 30, 50) for _ in range(3)]
        cot = [rng.standard_normal((50, 6)) for _ in idx]
        rows = take_rows(table, *(torch.as_tensor(i) for i in idx))
        sum((r * torch.as_tensor(c, dtype=dtype)).sum() for r, c in zip(rows, cot)).backward()
        want = np.zeros((30, 6))
        for i, c in zip(idx, cot):
            np.add.at(want, i, c)
        _held(table.grad, want, dtype)
    elif fn == "sum_at":
        keys = rng.integers(0, 25, 300)
        vals = rng.standard_normal(300)
        want = np.zeros(25)
        np.add.at(want, keys, vals)
        _held(sum_at(torch.as_tensor(keys), torch.as_tensor(vals, dtype=dtype), 25), want, dtype)
    elif fn in ("assign", "assignment_stats"):
        nb, B, M, K = 3, 700, 16, 8
        xn, emb = rng.standard_normal((nb, B, K)), rng.standard_normal((nb, M, K))
        valid = rng.random(B) < 0.9
        d = (emb * emb).sum(-1)[:, None, :] - 2 * np.einsum("nbk,nmk->nbm", xn, emb)
        idx = d.argmin(2)
        args = (torch.as_tensor(xn, dtype=dtype), torch.as_tensor(emb, dtype=dtype),
                torch.as_tensor(valid))
        if fn == "assign":
            got_idx, counts, sums = fused_assign_branches(*args)
            assert (got_idx.numpy() == idx).mean() > 0.999
            idx = got_idx.numpy()
        else:
            counts, sums = assignment_stats(args[0], torch.as_tensor(idx), M, args[2])
        want_c, want_s = np.zeros((nb, M)), np.zeros((nb, M, K))
        for b in range(nb):
            np.add.at(want_c[b], idx[b], valid.astype(np.float64))
            np.add.at(want_s[b], idx[b], xn[b] * valid[:, None])
        _held(counts, want_c, dtype)
        _held(sums, want_s, dtype)
    else:
        nb, M, K, N = 4, 8, 9, 50
        emb = rng.standard_normal((nb, M, K))
        c = rng.integers(0, M, (N + 1, nb)).astype(np.int16)
        ids = rng.integers(0, N + 1, 20)
        feats, grads = lookup_codewords(torch.as_tensor(c), torch.as_tensor(ids),
                                        torch.as_tensor(emb, dtype=dtype), split=4)
        table = emb[np.arange(nb)[None, :], c[ids].astype(np.int64)]
        _held(feats, table[:, :, :4].reshape(20, -1), dtype)
        _held(grads, table[:, :, 4:].reshape(20, -1), dtype)


def _port_state(seed=0):
    cfg = tcfg.Config(dataset="synthetic", num_layers=2, hidden_channels=16, num_D=4,
                      num_M=8, skip=True)
    ms = tmodel.model_static(cfg, 16, 16, torch.device("cpu"))
    gen = torch.Generator().manual_seed(seed)
    state = init_train_state(gen, ms, 100, LR, "cpu")
    for p in state.model.parameters():  # a square average to carry
        state.optimizer.state[p] = {"step": torch.tensor(1.0),
                                    "square_avg": torch.rand(p.shape, generator=gen)}
    pred = tlink.init_predictor(gen, 16, 16, 1, 2)
    pred_opt = make_rmsprop(pred.parameters(), LR)
    return state, pred, pred_opt


def test_cast_helpers_carry_every_value():
    """``state_as`` / ``predictor_as`` to float64 and back: every floating
    leaf (parameters, their RMSprop square averages, codebooks, BN
    statistics) float64 and then its own f32 bits again; ``c_indices`` and
    the flags keep their dtype and values; the learning rate and step
    carry.  ``batch_as`` casts a batch's and its adjacency's values, not its
    indices."""
    state, pred, pred_opt = _port_state()
    s64 = state_as(state, torch.float64)
    p64, o64 = predictor_as(pred, pred_opt, torch.float64)
    for p in list(s64.model.parameters()) + list(p64.parameters()):
        assert p.dtype == torch.float64
    for nu in rmsprop_nu(s64.optimizer, list(s64.model.parameters())):
        assert nu.dtype == torch.float64
    assert all(v.dtype == torch.float64 for v in s64.bn_state.mean + s64.bn_state.var)
    for s in s64.vq_states:
        assert s.embedding.dtype == s.ema_w.dtype == torch.float64
        assert s.c_indices.dtype == torch.int16 and s.bn_inited.dtype == torch.bool
    assert s64.step == state.step and o64.defaults["lr"] == pred_opt.defaults["lr"]
    back = state_to_numpy(state_as(s64, torch.float32))
    ref = state_to_numpy(state)
    np.testing.assert_equal(_plain(back), _plain(ref))
    pb, pref = (predictor_to_numpy(*predictor_as(p64, o64, torch.float32)),
                predictor_to_numpy(pred, pred_opt))
    np.testing.assert_equal(pb, pref)

    row, col, val = _ell(np.random.default_rng(1))
    e = Edges(ell_row=torch.as_tensor(row), ell_col=torch.as_tensor(col),
              ell_val=torch.as_tensor(val), num_rows=40)
    e64 = batch_as(e, torch.float64)
    assert e64.ell_val.dtype == torch.float64 and e64.ell_row.dtype == torch.int32
    assert e64.num_rows == 40 and np.array_equal(e64.ell_val.numpy(), val)


def test_link_step_float64_matches_jax():
    """The whole batch's link step, GCN with the inter-layer BN off (the
    biases ahead of it have a round-off gradient, ``tests/
    test_torch_port_link.py``), from the JAX package's initial state cast to
    float64, against JAX ``make_link_step`` (f32) on JAX's negatives: the
    losses to rtol 1e-4, the parameters and the predictor after the RMSprop
    step to atol 1e-4, the codebooks to 1e-5, ``c_indices[:N]`` equal; the
    state stays float64."""
    kw = dict(bn_flag=False)
    cfg, g, c, ms, jstate = _jax_setup(kw, dict(num_nodes=400, num_features=16, seed=0),
                                       link=True)
    jbatch = _jax_batch(cfg, g, link=True)
    key = jax.random.PRNGKey(3)
    pp = jlink.init_predictor(jax.random.PRNGKey(1), c, c, 1, cfg.num_layers)
    pnu = j_init_rmsprop(pp)
    # numpy copies first: the JAX step donates its inputs
    jstate, pp, pnu = jax.tree.map(lambda a: np.array(a, copy=True), (jstate, pp, pnu))
    new, jpp, _, jm = jlink.make_link_step(ms, cfg)[0](
        *jax.tree.map(jnp.asarray, (jstate, pp, pnu)), j_device_features(g.x), jbatch,
        jnp.float32(1.0), jnp.float32(LR), jnp.float32(1.0), key)

    tc = tcfg.Config(**dataclasses.asdict(cfg))
    cpu = torch.device("cpu")
    tms = tmodel.model_static(tc, g.num_features, c, cpu)
    state = state_as(state_from_numpy(jstate, tms, LR, cpu), torch.float64)
    pred, opt = predictor_as(*predictor_from_numpy(pp, pnu, LR, cpu), torch.float64)
    tg = _port_graph(dict(num_nodes=400, num_features=16, seed=0), tc)
    batch = next(tsamplers.BatchLoader(tg, tc, train_flag=True, shuffle=False, seed=0,
                                       device="cpu", with_link_edges=True)._epoch_iter())[0][0]
    m = tlink.make_link_step(tms, tc)[0](
        state, pred, opt, device_features(tg.x, cpu).double(),
        batch_as(batch.to(cpu), torch.float64), 1.0, LR, 1.0,
        dst_neg=torch.tensor(_jax_dst_neg(jbatch, key)))
    for k in ("loss", "loss_pre"):
        assert m[k].dtype == torch.float64
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    got, want = _plain(state_to_numpy(state)), _plain(jax.tree.map(np.asarray, new))
    for l, (gl, wl) in enumerate(zip(got["params"], want["params"])):
        for name in gl:
            for leaf in ("w", "b"):
                assert gl[name][leaf].dtype == np.float64
                np.testing.assert_allclose(gl[name][leaf], wl[name][leaf], atol=1e-4,
                                           err_msg=f"layer {l} {name} {leaf}")
    N = g.num_nodes
    for gs, ws in zip(got["vq_states"], want["vq_states"]):
        np.testing.assert_allclose(gs["embedding"], ws["embedding"], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(gs["c_indices"][:N], ws["c_indices"][:N])
    for lin, jlin in zip(predictor_to_numpy(pred, opt)[0], jax.tree.map(np.asarray, jpp)):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(lin[leaf], jlin[leaf], atol=1e-4)
