"""The port's two other adjacency layouts against the JAX package, on the CPU:
COO (``spmm_backend='coo'``) and mixed-K slot-ELL (``ell_Kt > 0``).

Host side, exactly: ``build_mixed_ell_host``; whole loader batches under
each layout (cluster and cont samplers, B + B' and B + M), the truncation
prefixes, ``tperm`` and the raw B + M reverse list included, and the lists
of row offsets and long rows the port's kernels read.

Device side, on the same numpy inputs: ``spmm`` over each layout (values,
dx, and d``val`` under COO), the fused GAT conv over the mixed layout
(values and the gradients of x, att_l, att_r and scale), ``layer_forward``
and ``layer_forward_bm`` under COO for GCN, SAGE and GAT (B + M SAGE and
GAT take the recovery term's grid path), live-VQ training from one carried
state, the bf16 compute path on each layout, and the link step on mixed-K.
The JAX side runs its XLA paths (``VQ_GNN_REV`` unset: its grid path runs
under COO).

Tolerances, as the earlier slices hold them: f32 sums in another order, so
1e-5 x the largest |ref| for one op or one layer; per-step training losses
to rtol 1e-4; bf16 at the tolerances of ``tests/test_torch_port_bf16.py``.
"""

import dataclasses
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.nn import model as jmodel
from vq_gnn_tpu.ops import gat as jgat
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu.train import link as jlink
from vq_gnn_tpu.train.loop import device_features as j_device_features
from vq_gnn_tpu.train.state import init_train_state as j_init_train_state
from vq_gnn_tpu.train.step import make_step_fns as j_make_step_fns
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.convert import predictor_from_numpy, state_from_numpy
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.nn import model as tmodel
from vq_gnn_tpu_torch.ops import gat as tgat
from vq_gnn_tpu_torch.ops import spmm as tspmm
from vq_gnn_tpu_torch.sampler import batch as tbatch
from vq_gnn_tpu_torch.sampler import samplers as tsamplers
from vq_gnn_tpu_torch.train import link as tlink
from vq_gnn_tpu_torch.train.loop import NodeTrainer
from vq_gnn_tpu_torch.train.step import masked_ce
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

jspmm = importlib.import_module("vq_gnn_tpu.ops.spmm")  # the package exports a function `spmm`

RTOL_SUM = 1e-5  # x the largest |ref|: f32 sums in another order
RTOL_STEP = 1e-4  # per-step losses over a few live-VQ steps
BM_TRAIN_BATCHES = 2  # B + M training cases: six live-VQ steps (three windows a batch)
LR = 0.005
# tests/test_torch_port_bf16.py
LOSS_TOL, LEAF_RTOL = 5e-3, 2e-2

CFG = dict(num_layers=2, hidden_channels=16, num_D=4, num_M=8, test_batch_size=256,
           pad_multiple_nodes=64, pad_multiple_edges=512, vq_update_mode="live", skip=True,
           lr=LR, seed=0)
CLUSTER = dict(sampler_type="cluster", num_parts=8, batch_size=3)
CONT = dict(sampler_type="cont", walk_length=2, batch_size=128)
MIXED = dict(ell_Kt=2)
COO = dict(spmm_backend="coo")
# the fields of each layout that the loaders must build alike
MIXED_FIELDS = ("head_rowc", "head_col", "head_val", "head_inv", "head_rowg", "tail_row",
                "tail_col", "tail_val", "t_head_rowc", "t_head_col", "t_head_val", "t_head_inv",
                "t_head_rowg", "t_tail_row", "t_tail_col", "t_tail_val")
COO_FIELDS = ("row", "col", "val", "tperm")


@pytest.fixture(scope="module", autouse=True)
def _vml_first_call():
    """A throwaway first torch.exp of the process: the first call of MKL's
    vector exp can return a chunk at a lower accuracy
    (tests/test_torch_port_kernels.py:_vml_first_call says more)."""
    torch.exp(torch.zeros(1 << 16))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(out, ref, rtol, name=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


def _graphs(conv, nodes=300, **kw):
    """(cfg, graph, num_classes, cluster_indices) prepared by each package
    from one SBM."""
    out = []
    for cfg_mod, data in ((jcfg, jdata), (tcfg, tdata)):
        cfg = cfg_mod.Config(conv_type=conv, **{**CFG, **kw})
        g, c = data.synthetic_sbm(num_nodes=nodes, num_classes=5, num_features=16, seed=5)
        out.append((cfg,) + tuple(data.prepare(g, cfg, c)))
    return out


def _loaders(conv, train_flag=True, **kw):
    (jc, jg, _, jci), (tc, tg, _, tci) = _graphs(conv, **kw)
    lkw = dict(train_flag=train_flag, seed=3)
    if not train_flag:
        lkw.update(batch_size=jc.test_batch_size, shuffle=False)
    return (jsamplers.BatchLoader(jg, jc, cluster_indices=jci, **lkw),
            tsamplers.BatchLoader(tg, tc, cluster_indices=tci, device="cpu", **lkw))


def _coo_arrays(rng, n, nnz):
    row = rng.randint(0, n, nnz).astype(np.int32)
    col = rng.randint(0, n, nnz).astype(np.int32)
    val = rng.randn(nnz).astype(np.float32)
    order = np.argsort(row, kind="stable")
    return row[order], col[order], val[order]


# ---------------------------------------------------------------------------
# host side: exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K,Kt", [(4, 2), (8, 2), (4, 1)])
def test_build_mixed_ell_host_matches_jax(K, Kt):
    row, col, val = _coo_arrays(np.random.RandomState(11), 60, 700)
    deg = np.bincount(row, minlength=60)
    Sh = int((deg // K).sum()) + 7  # with padding slots of both families
    St2 = int(np.maximum((deg % K + Kt - 1) // Kt, 1).sum()) + 5
    ref = jspmm.build_mixed_ell_host(row, col, val, 60, K, Kt, Sh, St2)
    out = tspmm.build_mixed_ell_host(row, col, val, 60, K, Kt, Sh, St2)
    assert len(out) == len(ref) == 10
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def _check_lists(ptr, long_rows, rows, num_rows, live=None):
    """The lists of an ascending slot-row array: row r owns the slots
    [ptr[r], ptr[r+1]); slots from index ``live`` on, and rows >=
    num_rows, belong to none; the long rows are those of more than 16
    slots, most slots first."""
    rows = np.minimum(np.asarray(rows, np.int64), num_rows)
    if live is not None:
        rows = np.where(np.arange(len(rows)) < live, rows, num_rows)
    np.testing.assert_array_equal(ptr, np.searchsorted(rows, np.arange(num_rows + 1)))
    slots = np.diff(ptr)
    want = np.flatnonzero(slots > 16)
    assert long_rows[0] == 16
    assert sorted(long_rows[1:].tolist()) == want.tolist()
    assert (np.diff(slots[long_rows[1:]]) <= 0).all()


def _check_mixed_lists(e, gat):
    R = e.num_rows
    live = int((e.head_rowg < R).sum())  # the head's padding slots carry a real row
    _check_lists(e.head_ptr, e.head_long_rows, e.head_rowc, R, live)
    _check_lists(e.tail_ptr, e.tail_long_rows, e.tail_row, R)
    t_live = int((e.t_head_rowg < R).sum())
    if tspmm.mixed_truncated(e):
        b = e.b_rows
        _check_lists(e.t_head_ptr, e.t_head_long_rows, e.t_head_rowc[:e.t_head_b_slots], R,
                     t_live)
        _check_lists(e.t_tail_ptr, e.t_tail_long_rows,
                     np.minimum(e.t_tail_row[:e.t_tail_b_slots], b), b)
    else:
        _check_lists(e.t_head_ptr, e.t_head_long_rows, e.t_head_rowc, R, t_live)
        _check_lists(e.t_tail_ptr, e.t_tail_long_rows, e.t_tail_row, R)
    if gat:
        _check_lists(e.t_head_all_ptr, e.t_head_all_long_rows, e.t_head_rowc, R, t_live)
        _check_lists(e.t_tail_all_ptr, e.t_tail_all_long_rows, e.t_tail_row, R)
    else:
        assert e.t_head_all_ptr is None and e.t_tail_all_ptr is None


BATCH_CASES = [
    pytest.param("GCN", "bbprime", CLUSTER, MIXED, True, id="GCN-bbprime-cluster-mixed"),
    pytest.param("GAT", "bbprime", CLUSTER, MIXED, True, id="GAT-bbprime-cluster-mixed"),
    pytest.param("GCN", "bm", CONT, MIXED, True, id="GCN-bm-cont-mixed"),
    pytest.param("SAGE", "bm", CONT, MIXED, True, id="SAGE-bm-cont-mixed"),
    pytest.param("GCN", "bbprime", CONT, MIXED, False, id="GCN-bbprime-eval-mixed"),
    pytest.param("GCN", "bbprime", CLUSTER, COO, True, id="GCN-bbprime-cluster-coo"),
    pytest.param("GAT", "bbprime", CONT, COO, True, id="GAT-bbprime-cont-coo"),
    pytest.param("SAGE", "bm", CONT, COO, True, id="SAGE-bm-cont-coo"),
    pytest.param("GAT", "bm", CONT, COO, True, id="GAT-bm-cont-coo"),
    pytest.param("GAT", "bm", CONT, COO, False, id="GAT-bm-eval-coo"),
]


@pytest.mark.parametrize("conv,formulation,sampler,layout,train_flag", BATCH_CASES)
def test_batches_match_jax(conv, formulation, sampler, layout, train_flag):
    """Two epochs of loader batches (the second exercises the monotone
    buckets): every layout field, the truncation bounds, the raw reverse
    list beside COO, and the port's own row lists."""
    jl, tl = _loaders(conv, train_flag, formulation=formulation, **sampler, **layout)
    mixed = "ell_Kt" in layout
    n = truncated = 0
    for _ in range(2):
        for (jw, _), (tw, _) in zip(jl._epoch_iter(), tl._epoch_iter(), strict=True):
            for jb, tb in zip(jw, tw, strict=True):
                n += 1
                for f in ("batch_idx", "fo_ids", "valid_B", "valid_fo", "y", "train_mask"):
                    np.testing.assert_array_equal(getattr(jb, f), getattr(tb, f), err_msg=f)
                je, te = jb.edges, tb.edges
                assert te.num_rows == je.num_rows and te.ell_row is None
                for f in MIXED_FIELDS if mixed else COO_FIELDS:
                    np.testing.assert_array_equal(getattr(je, f), getattr(te, f), err_msg=f)
                    assert getattr(te, f).dtype == getattr(je, f).dtype, f
                if mixed:
                    assert (je.b_rows, je.t_head_b_slots, je.t_tail_b_slots) == (
                        te.b_rows, te.t_head_b_slots, te.t_tail_b_slots)
                    truncated += tspmm.mixed_truncated(te)
                    _check_mixed_lists(te, conv == "GAT")
                else:
                    assert te.row.shape[0] % 512 == 0 and je.tail_row is None
                    _check_lists(te.row_ptr, te.row_long_rows, te.row, te.num_rows)
                    _check_lists(te.t_row_ptr, te.t_row_long_rows, te.col[te.tperm],
                                 te.num_rows)
                # the reverse list: raw beside COO, as rev-ELL beside mixed-K
                # (the JAX package keeps the raw list beside both)
                has_rev = formulation == "bm" and conv != "GCN" and train_flag
                assert (jb.bm_rev_row is not None) == has_rev
                assert (tb.bm_rev_row is not None) == (has_rev and not mixed)
                assert (tb.rev_slot_row is not None) == (jb.rev_slot_row is not None) == (
                    has_rev and mixed)
                if tb.rev_slot_row is not None:
                    np.testing.assert_array_equal(jb.rev_slot_val, tb.rev_slot_val)
                if tb.bm_rev_row is not None:
                    for f in ("bm_rev_row", "bm_rev_col", "bm_rev_val"):
                        np.testing.assert_array_equal(getattr(jb, f), getattr(tb, f), err_msg=f)
    assert n > 2
    if mixed and train_flag and formulation == "bbprime":
        assert truncated > 0  # the truncated dx is exercised


def test_bm_gat_keeps_single_k_under_ell_kt():
    """B + M GAT with ell_Kt > 0 builds single-K batches, as the JAX package
    does (``vq_gnn_tpu/sampler/samplers.py:488-492``): its per-branch conv
    mirrors per-cell values through f_from_t, a map of the single-K ELL."""
    jl, tl = _loaders("GAT", formulation="bm", **CONT, **MIXED)
    (jw, _), (tw, _) = next(jl._epoch_iter()), next(tl._epoch_iter())
    for jb, tb in zip(jw, tw, strict=True):
        assert jb.edges.tail_row is None and not tb.edges.mixed
        for f in ("ell_row", "ell_col", "ell_val", "t_ell_row", "f_from_t"):
            np.testing.assert_array_equal(getattr(jb.edges, f), getattr(tb.edges, f))
        np.testing.assert_array_equal(jb.rev_slot_val, tb.rev_slot_val)


# ---------------------------------------------------------------------------
# spmm over each layout
# ---------------------------------------------------------------------------
def _mixed_pair(n, nnz, K, Kt, b_rows, seed):
    """One mixed layout built by the port's batch builder (with its
    truncation bucket when ``b_rows``), and the JAX Edges of the same
    arrays."""
    row, col, val = _coo_arrays(np.random.RandomState(seed), n, nnz)
    deg, degc = np.bincount(row, minlength=n), np.bincount(col, minlength=n)
    pads = tuple(max(int((d // K).sum()), 1) for d in (deg,)) + (
        int(np.maximum((deg % K + Kt - 1) // Kt, 1).sum()), max(int((degc // K).sum()), 1),
        int(np.maximum((degc % K + Kt - 1) // Kt, 1).sum()))
    te = tbatch._mixed_edges(row, col, val, n, K, Kt, pads, b_rows or n,
                             {"multiple": 64} if b_rows else None, True)
    je = jspmm.Edges(**{f: jnp.asarray(getattr(te, f)) for f in MIXED_FIELDS}, num_rows=n,
                     dense_rows=True, b_rows=te.b_rows, t_head_b_slots=te.t_head_b_slots,
                     t_tail_b_slots=te.t_tail_b_slots)
    return te.to("cpu"), je


@pytest.mark.parametrize("K,Kt,b_rows", [(8, 2, 0), (4, 1, 0), (4, 2, 200)])
def test_mixed_spmm_matches_jax(K, Kt, b_rows):
    """Values and dx (truncated to the rows < b_rows where the bucket sets
    it) against ``vq_gnn_tpu/ops/spmm.py`` on the same layout
    (``tests/test_ops.py:208, 223``)."""
    n = 400
    te, je = _mixed_pair(n, 3000, K, Kt, b_rows, seed=12)
    assert tspmm.mixed_truncated(te) == bool(b_rows)
    rng = np.random.RandomState(1)
    x = rng.randn(n, 8).astype(np.float32)
    g = rng.randn(n, 8).astype(np.float32)

    def out_and_dx(xx, gg):
        out, vjp = jax.vjp(lambda a: jspmm.spmm(je, a), xx)
        return out, vjp(gg)[0]

    ref, ref_dx = jax.jit(out_and_dx)(jnp.asarray(x), jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    out = tspmm.spmm(te, xt)
    _close(out.detach(), ref, RTOL_SUM, "out")
    (dx,) = torch.autograd.grad(out, xt, _t(g))
    _close(dx, ref_dx, RTOL_SUM, "dx")
    if b_rows:
        assert (dx[b_rows:] == 0).all()


def test_coo_spmm_matches_jax():
    """COO values, dx (the tperm-sorted transpose) and d val (the SDDMM),
    padding sentinels included (``tests/test_ops.py:51, 79``)."""
    n, E, pad = 60, 400, 37
    row, col, val = _coo_arrays(np.random.RandomState(2), n, E)
    row = np.concatenate([row, np.full(pad, n, np.int32)])
    col = np.concatenate([col, np.full(pad, n, np.int32)])
    val = np.concatenate([val, np.zeros(pad, np.float32)])
    je = jspmm.make_edges(row, col, val, n)
    te = tspmm.make_edges(row, col, val, n).to("cpu")
    for f in COO_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(je, f)), getattr(te, f).numpy())
    rng = np.random.RandomState(3)
    x = rng.randn(n, 6).astype(np.float32)
    g = rng.randn(n, 6).astype(np.float32)
    ref, vjp = jax.vjp(lambda v, xx: jspmm.spmm(je.replace(val=v), xx), je.val, jnp.asarray(x))
    ref_dv, ref_dx = vjp(jnp.asarray(g))
    xt, vt = _t(x).requires_grad_(True), te.val.clone().requires_grad_(True)
    out = tspmm.spmm(dataclasses.replace(te, val=vt), xt)
    _close(out.detach(), ref, RTOL_SUM, "out")
    dv, dx = torch.autograd.grad(out, [vt, xt], _t(g))
    _close(dx, ref_dx, RTOL_SUM, "dx")
    _close(dv, ref_dv, RTOL_SUM, "dval")  # the padding's clips to the last row, as JAX's


def test_coo_spmm_branches_matches_a_vmap():
    """The per-branch COO spmm of the B + M GAT fallback against JAX's vmap
    of ``spmm`` over branch values: values and the gradients of x and the
    values."""
    n, nb, Dc = 50, 3, 5
    row, col, val = _coo_arrays(np.random.RandomState(4), n, 300)
    je = jspmm.make_edges(row, col, val, n)
    te = tspmm.make_edges(row, col, val, n).to("cpu")
    rng = np.random.RandomState(5)
    vals = rng.rand(nb, 300).astype(np.float32)
    x = rng.randn(nb, n, Dc).astype(np.float32)
    g = rng.randn(nb, n, Dc).astype(np.float32)
    ref, vjp = jax.vjp(lambda v, xx: jax.vmap(
        lambda vi, xi: jspmm.spmm(je.replace(val=vi), xi))(v, xx), jnp.asarray(vals),
        jnp.asarray(x))
    ref_dv, ref_dx = vjp(jnp.asarray(g))
    vt, xt = _t(vals).requires_grad_(True), _t(x).requires_grad_(True)
    out = tspmm.spmm_branches(te, vt, xt)
    _close(out.detach(), ref, RTOL_SUM, "out")
    dv, dx = torch.autograd.grad(out, [vt, xt], _t(g))
    _close(dx, ref_dx, RTOL_SUM, "dx")
    _close(dv, ref_dv, RTOL_SUM, "dval")


# ---------------------------------------------------------------------------
# the fused GAT conv over the mixed layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K,Kt", [(4, 2)])
def test_mixed_gat_conv_matches_jax(K, Kt):
    """(agg, rowsum) and the gradients of x, att_l, att_r and scale against
    ``vq_gnn_tpu/ops/gat.py:gat_conv_ell`` on the same mixed layout
    (``tests/test_ops.py:238``)."""
    n, C = 300, 8
    te, je = _mixed_pair(n, 2500, K, Kt, 0, seed=13)
    rng = np.random.RandomState(6)
    x = rng.randn(n, C).astype(np.float32)
    att_l = (0.5 * rng.randn(C + 1)).astype(np.float32)
    att_r = (0.5 * rng.randn(C + 1)).astype(np.float32)
    scale = np.float32(2.5)
    g_agg = rng.randn(n, C).astype(np.float32)
    g_rs = rng.randn(n, 1).astype(np.float32)
    def conv_vjp(args, g):
        out, vjp = jax.vjp(lambda *a: jgat.gat_conv_ell(je, *a), *args)
        return out, vjp(g)

    ref, ref_grads = jax.jit(conv_vjp)(tuple(jnp.asarray(a) for a in (x, att_l, att_r, scale)),
                                       (jnp.asarray(g_agg), jnp.asarray(g_rs)))
    leaves = [_t(a).requires_grad_(True) for a in (x, att_l, att_r, scale)]
    out = tgat.gat_conv_ell(te, *leaves)
    _close(out[0].detach(), ref[0], RTOL_SUM, "agg")
    _close(out[1].detach(), ref[1], RTOL_SUM, "rowsum")
    grads = torch.autograd.grad(out, leaves, (_t(g_agg), _t(g_rs)))
    for name, g, r in zip(("dx", "d_att_l", "d_att_r", "d_scale"), grads, ref_grads):
        _close(g, r, RTOL_SUM, name)
    with torch.no_grad():  # the forward without a gradient skips the masked channels
        agg, rs = tgat.gat_conv_ell(te, *(t.detach() for t in leaves))
    _close(agg, ref[0], RTOL_SUM, "agg no-grad")


def test_mixed_gat_conv_bf16_matches_jax():
    """The mixed GAT conv on bf16 x (the 14b path of ``chip_smoke.py``):
    values and the gradients of x, att_l, att_r and scale against the JAX
    conv compiled without XLA's excess precision (each op rounds where its
    code says, as run op by op; by default the CPU backend keeps some of the
    conv's bf16 logit dots in f32), at the layer tolerance of
    ``tests/test_torch_port_bf16.py`` (rtol 2e-2, atol 1e-2 x the largest
    |ref|)."""
    n, C = 300, 8
    te, je = _mixed_pair(n, 2500, 4, 2, 0, seed=13)
    rng = np.random.RandomState(7)
    x = rng.randn(n, C).astype(np.float32)
    att_l = (0.5 * rng.randn(C + 1)).astype(np.float32)
    att_r = (0.5 * rng.randn(C + 1)).astype(np.float32)
    scale = np.float32(2.5)
    g_agg = rng.randn(n, C).astype(np.float32)
    g_rs = rng.randn(n, 1).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)

    def conv_vjp(args, g):
        out, vjp = jax.vjp(lambda *a: jgat.gat_conv_ell(je, *a), *args)
        return out, vjp(g)

    args = (xb,) + tuple(jnp.asarray(a) for a in (att_l, att_r, scale))
    g = (jnp.asarray(g_agg), jnp.asarray(g_rs))
    ref, ref_grads = jax.jit(conv_vjp).lower(args, g).compile(
        compiler_options={"xla_allow_excess_precision": False})(args, g)
    leaves = [_t(x).to(torch.bfloat16).requires_grad_(True)] + [
        _t(a).requires_grad_(True) for a in (att_l, att_r, scale)]
    out = tgat.gat_conv_ell(te, *leaves)
    grads = torch.autograd.grad(out, leaves, (_t(g_agg), _t(g_rs)))
    assert grads[0].dtype == torch.bfloat16
    for name, o, r in zip(("agg", "rowsum", "dx", "d_att_l", "d_att_r", "d_scale"),
                          list(out) + list(grads), list(ref) + list(ref_grads)):
        o = o.detach().float().numpy()
        r = np.asarray(jnp.asarray(r, jnp.float32))
        np.testing.assert_allclose(o, r, rtol=2e-2, atol=1e-2 * max(1.0, float(np.abs(r).max())),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# one layer under COO
# ---------------------------------------------------------------------------
def _batch_pair(conv, formulation, sampler, layout, **kw):
    (jc, jg, c, jci), (tc, tg, _, tci) = _graphs(conv, formulation=formulation, **sampler,
                                                  **layout, **kw)
    jb = next(jsamplers.BatchLoader(jg, jc, train_flag=True, cluster_indices=jci,
                                    seed=1)._epoch_iter())[0][-1]
    tb = next(tsamplers.BatchLoader(tg, tc, train_flag=True, cluster_indices=tci, seed=1,
                                    device="cpu")._epoch_iter())[0][-1]
    return (jc, jg, c, jax.tree.map(jnp.asarray, jb)), (tc, tg, tb.to("cpu"))


LAYER_CASES = [pytest.param(conv, form, id=f"{conv}-{form}")
               for form in ("bbprime", "bm") for conv in ("GCN", "SAGE", "GAT")]


@pytest.mark.parametrize("conv,formulation", LAYER_CASES)
def test_layer_forward_coo_matches_jax(conv, formulation):
    """One layer over a COO batch with probes, warm-up rate 0.7, random
    codebooks and codeword table: output, info_backward (B + M SAGE and
    GAT: the exact reverse term by the grid path) and the gradients of every
    parameter, the probe and x (``tests/test_bm.py:305, 374``)."""
    sampler = CONT if formulation == "bm" else CLUSTER
    (jc, jg, c, jb), (tc, tg, tb) = _batch_pair(conv, formulation, sampler, COO)
    assert tb.edges.row is not None and tb.edges.ell_row is None
    assert (tb.bm_rev_row is not None) == (formulation == "bm" and conv != "GCN")
    ms_j = jmodel.model_static(jc, jg.num_features, c)
    ms_t = tmodel.model_static(tc, tg.num_features, c, torch.device("cpu"))
    jstate = j_init_train_state(jax.random.PRNGKey(0), ms_j, jg.num_nodes)
    rng = np.random.RandomState(8)
    vq = jstate.vq_states[0]
    M = vq.embedding_output.shape[1]
    vq = vq.replace(
        embedding_output=jnp.asarray(rng.randn(*vq.embedding_output.shape).astype(np.float32)),
        c_indices=jnp.asarray(rng.randint(0, M, vq.c_indices.shape).astype(np.int16)),
    )
    jstate = jstate.replace(vq_states=[vq] + list(jstate.vq_states[1:]))
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, LR, "cpu")
    B_pad, C = tb.B_pad, jg.num_features
    x = rng.randn(B_pad, C).astype(np.float32)
    w_out = rng.randn(B_pad, ms_j.channels[1]).astype(np.float32)
    probe0 = np.zeros(jmodel.probe_shapes(ms_j, B_pad)[0], np.float32)
    warm = 0.7
    fwd = jmodel.layer_forward_bm if formulation == "bm" else jmodel.layer_forward

    def j_loss(lp, xx, probe):
        out, info = fwd(lp, vq, ms_j, xx, jb, probe, warm, True)
        return jnp.sum(out * w_out) + info, (out, info)

    (_, (j_out, j_info)), (j_glp, j_gx, j_gp) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1, 2), has_aux=True))(jstate.params[0], jnp.asarray(x),
                                                  jnp.asarray(probe0))
    layer = state.model.layers[0]
    xx = _t(x).requires_grad_(True)
    probe = _t(probe0).requires_grad_(True)
    out, info = tmodel.layer_forward(layer, state.vq_states[0], ms_t, xx, tb, probe, warm)
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad((out * _t(w_out)).sum() + info,
                                [p for _, p in layer.named_parameters()] + [xx, probe])
    _close(out.detach(), j_out, RTOL_SUM, "x_out")
    _close(info.detach(), j_info, RTOL_SUM, "info_backward")
    assert abs(float(j_info)) > 0
    _close(grads[-1], j_gp, RTOL_SUM, "d_probe")
    _close(grads[-2], j_gx, RTOL_SUM, "dx")
    for name, g in zip(names, grads):
        mod, _, key = name.partition(".")
        ref = j_glp[mod] if not key else j_glp[mod][{"weight": "w", "bias": "b"}[key]]
        ref = np.asarray(ref).T if key == "weight" else ref
        _close(g, ref, RTOL_SUM, name)


# ---------------------------------------------------------------------------
# live-VQ training from one carried state
# ---------------------------------------------------------------------------
TRAIN_CASES = [
    pytest.param("GCN", "bbprime", MIXED, id="GCN-bbprime-mixed"),
    pytest.param("GAT", "bbprime", MIXED, id="GAT-bbprime-mixed"),
    pytest.param("GAT", "bbprime", COO, id="GAT-bbprime-coo"),
    pytest.param("SAGE", "bm", COO, id="SAGE-bm-coo"),
    pytest.param("GAT", "bm", COO, id="GAT-bm-coo"),
    pytest.param("GCN", "bm", MIXED, id="GCN-bm-mixed"),
]


@pytest.mark.parametrize("conv,formulation,layout", TRAIN_CASES)
def test_training_matches_jax(conv, formulation, layout):
    """Init sweep and one epoch of live-VQ steps (B + M: its first two
    batches on the cont sampler, three windows a batch, the first without an
    optimizer step), from one state: the per-step losses and info_backward
    to rtol 1e-4, and the codeword assignments after those steps
    (``tests/test_torch_port_bm.py:351-391``)."""
    sampler = CONT if formulation == "bm" else CLUSTER
    (jc, jg, c, jci), (tc, tg, _, tci) = _graphs(conv, formulation=formulation, bn_flag=False,
                                                 **sampler, **layout)
    N = jg.num_nodes
    ms = jmodel.model_static(jc, jg.num_features, c)
    jstate = j_init_train_state(jax.random.PRNGKey(0), ms, N)
    fns = j_make_step_fns(ms, jc, multilabel=False)
    X = j_device_features(jg.x)
    j_train = jsamplers.BatchLoader(jg, jc, train_flag=True, cluster_indices=jci, seed=jc.seed)
    # the test loader NodeTrainer builds
    j_test = jsamplers.BatchLoader(jg, jc, train_flag=False, cluster_indices=jci,
                                   sampler_type="node" if jci is None else "cluster",
                                   batch_size=jc.test_batch_size, shuffle=False,
                                   seed=jc.seed + 1)
    j_test_batches = [jax.tree.map(jnp.asarray, w[0]) for w, _ in j_test._epoch_iter()]

    tr = NodeTrainer(tg, tc, c, tci, device="cpu")
    tr.state = state_from_numpy(jax.tree.map(np.asarray, jstate), tr.ms, LR, "cpu")
    for layer_idx in range(1, ms.num_layers + 1):
        step = fns.init_step_for(layer_idx)
        for b in j_test_batches:
            vq, _ = step(jstate.vq_states, [], jstate.params, X, b)
            jstate = jstate.replace(vq_states=vq)
    tr.run_init_sweep()

    steps = 0
    n_batches = BM_TRAIN_BATCHES if formulation == "bm" else None
    for (jw, _), (tw, _) in itertools.islice(zip(j_train._epoch_iter(), tr.train_loader,
                                                 strict=True), n_batches):
        for j, (jb, tb) in enumerate(zip(jw, tw, strict=True)):
            assert tb.edges.mixed == ("ell_Kt" in layout)
            do_opt = 0.0 if (len(jw) > 1 and j == 0) else 1.0
            jstate, jm = fns.train_step(
                jstate, X, jax.tree.map(jnp.asarray, jb), jnp.float32(1.0), jnp.float32(LR),
                jnp.float32(do_opt), jax.random.PRNGKey(1),
            )
            tr.state, tm = tr.fns.train_step(tr.state, tr.X_dev, tb, 1.0, LR, do_opt)
            for k in ("loss", "loss_cls", "info_backward"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL_STEP,
                                           atol=1e-7, err_msg=f"step {steps} {k}")
            steps += 1
    assert steps >= 3
    for js, ts in zip(jstate.vq_states, tr.state.vq_states):
        agree = (ts.c_indices.numpy()[:N] == np.asarray(js.c_indices)[:N]).mean()
        assert agree > 0.99, agree
    for jb, (tw, _) in zip(j_test_batches, tr.test_batches()):
        out = tr.fns.eval_step(tr.state, tr.X_dev, tw[0]).numpy()
        ref = np.asarray(fns.eval_step(jstate, X, jb))
        np.testing.assert_allclose(out, ref, atol=1e-4)


def test_link_step_on_mixed_matches_jax():
    """One link training step over a mixed-K batch from one carried state,
    the JAX negatives fed to both: the loss before and after the live VQ
    update, and the parameters the RMSprop step leaves."""
    kw = dict(CFG, conv_type="GCN", sampler_type="cont", walk_length=2, batch_size=150,
              test_batch_size=400, bn_flag=False, vq_backend="xla", ell_Kt=2)
    jc, tc = jcfg.Config(**kw), tcfg.Config(**kw)
    graphs = []
    for data, cfg in ((jdata, jc), (tdata, tc)):
        g, c = data.synthetic_sbm(num_nodes=400, num_features=16, seed=2)
        graphs.append(data.prepare(g, cfg, c)[0])
    jg, tg = graphs
    coo = jg.adj.tocoo()
    e = np.stack([coo.row, coo.col], 1)
    e = e[e[:, 0] != e[:, 1]][np.random.RandomState(0).permutation(int((coo.row != coo.col).sum()))]
    rng = np.random.RandomState(1)
    split = dict(train_pos=e[:-100], valid_pos=e[-100:-50], valid_neg=rng.randint(0, 400, (200, 2)),
                 test_pos=e[-50:], test_neg=rng.randint(0, 400, (200, 2)))
    jtr = jlink.LinkTrainer(jg, jc, jlink.SplitEdges(**split))
    tr = tlink.LinkTrainer(tg, tc, tlink.SplitEdges(**split), device="cpu")

    def carry():
        tr.state = state_from_numpy(jax.tree.map(np.asarray, jtr.state), tr.ms, LR, "cpu")
        tr.predictor, tr.pred_opt = predictor_from_numpy(
            jax.tree.map(np.asarray, jtr.pred_params), jax.tree.map(np.asarray, jtr.pred_nu),
            LR, "cpu")

    carry()
    jtr.run_init_sweep()
    tr.run_init_sweep()
    jw = [jax.tree.map(jnp.asarray, w) for w, _ in jtr.train_loader._epoch_iter()][0]
    tw = [w for w, _ in tr.train_loader][0]
    jb, tb = jw[-1], tw[-1]
    assert tb.edges.mixed and jb.edges.tail_row is not None
    key = jax.random.PRNGKey(11)
    _, r_neg, _ = jax.random.split(key, 3)  # vq_gnn_tpu/train/link.py:67-71
    dst_neg = jax.random.randint(r_neg, jb.link_src.shape, 0, jnp.maximum(jb.num_B, 1))
    step, _ = jlink.make_link_step(jtr.ms, jtr.cfg)
    jst, _, _, jm = step(jtr.state, jtr.pred_params, jtr.pred_nu, jtr.X_dev, jb,
                         jnp.float32(0.5), jnp.float32(LR), jnp.float32(1.0), key)
    tm = tr.step_fn(tr.state, tr.predictor, tr.pred_opt, tr.X_dev, tb, 0.5, LR, 1.0,
                    dst_neg=torch.as_tensor(np.array(dst_neg), dtype=torch.int64))
    for k in ("loss", "loss_pre"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL_STEP, err_msg=k)
    for pname, p in tr.state.model.named_parameters():
        _, l, rest = pname.split(".", 2)
        name, _, key_ = rest.partition(".")
        ref = jst.params[int(l)][name]
        ref = np.asarray(ref if not key_ else ref[{"weight": "w", "bias": "b"}[key_]])
        ref = ref.T if key_ == "weight" else ref
        np.testing.assert_allclose(p.detach().numpy(), ref, atol=1e-4, err_msg=pname)


# ---------------------------------------------------------------------------
# bf16 compute on each layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("conv,layout", [("GCN", MIXED), ("GAT", COO)],
                         ids=["GCN-mixed", "GAT-coo"])
def test_bf16_model_matches_jax(conv, layout):
    """The whole B + B' model at bf16 compute on the first training batch
    of each layout: masked CE + info_backward and its gradients with respect
    to every parameter and every probe against the JAX package under
    ``jax.jit``, at the tolerances of
    ``tests/test_torch_port_bf16.py:test_model_loss_and_grads_match_jax``.
    (The mixed GAT conv at bf16: ``test_mixed_gat_conv_bf16_matches_jax``.)"""
    (jc, jg, c, jb), (tc, tg, tb) = _batch_pair(conv, "bbprime", CLUSTER, layout,
                                                compute_dtype="bfloat16")
    ms_j = jmodel.model_static(jc, jg.num_features, c)
    ms_t = tmodel.model_static(tc, tg.num_features, c, torch.device("cpu"))
    jstate = j_init_train_state(jax.random.PRNGKey(0), ms_j, jg.num_nodes)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, LR, "cpu")
    X = j_device_features(jg.x)

    def j_loss(params, probes):
        x_B = jnp.take(X, jb.batch_idx, axis=0)
        out, info_b, _, _ = jmodel.model_forward(
            params, jstate.vq_states, jstate.bn_state, ms_j, x_B, jb, probes=probes,
            warm_up_rate=1.0, training=True, rng=jax.random.PRNGKey(1))
        m = (jb.train_mask & jb.valid_B).astype(out.dtype)
        ll = jnp.take_along_axis(jax.nn.log_softmax(out), jb.y[:, None].astype(jnp.int32),
                                 axis=1)[:, 0]
        return -jnp.sum(ll * m) / jnp.maximum(jnp.sum(m), 1.0) + info_b

    j_val, (j_gp, j_gprobe) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(
        jstate.params, jmodel.zero_probes(ms_j, jb.B_pad))
    X_t = _t(np.concatenate([tg.x, np.zeros((1, tg.x.shape[1]), tg.x.dtype)]))
    params, refs = [], []
    for l, layer in enumerate(state.model.layers):
        for name, p in layer.named_parameters():
            mod, _, key = name.partition(".")
            ref = np.asarray(j_gp[l][mod] if not key else j_gp[l][mod][key[0]])
            params.append(p)
            refs.append((f"layer {l} {name}", ref.T if key == "weight" else ref))
    refs += [(f"probe {l}", np.asarray(g)) for l, g in enumerate(j_gprobe)]
    probes = tmodel.zero_probes(ms_t, tb.B_pad, "cpu")
    out, info_b, _, _ = tmodel.model_forward(
        state.model, state.vq_states, state.bn_state, ms_t, X_t.index_select(0, tb.batch_idx),
        tb, probes=probes, warm_up_rate=1.0, training=True)
    loss = masked_ce(out, tb.y, tb.train_mask & tb.valid_B) + info_b
    grads = torch.autograd.grad(loss, params + probes)
    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=LOSS_TOL, atol=LOSS_TOL)
    for (name, ref), g in zip(refs, grads, strict=True):
        tol = max(2e-3 * float(np.abs(ref).max()), 3e-5)
        np.testing.assert_allclose(g.numpy(), ref, rtol=LEAF_RTOL, atol=tol, err_msg=name)
