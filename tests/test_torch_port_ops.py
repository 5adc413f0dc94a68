"""The port's kernel modules (plain versions, CPU) against the JAX package's
functions on the same numpy inputs.  Pallas kernels run in interpret mode,
as the JAX package's own tests run them on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.ops.pallas_ell import ell_aggregate_fused
from vq_gnn_tpu.ops.pallas_vq import fused_assign_branches as j_assign
from vq_gnn_tpu.ops.pallas_vq import lookup_branches as j_lookup
from vq_gnn_tpu.ops.spmm import build_ell_host as j_build_ell
from vq_gnn_tpu.ops.spmm import spmm as j_spmm
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.ops.ell_aggregate import (
    LONG_SLOTS,
    PANEL_MAX,
    PANEL_MAX_BF16,
    ell_aggregate,
    panel_width,
    row_offsets_plain,
)
from vq_gnn_tpu_torch.ops.spmm import build_ell_host, long_rows_host, row_offsets_host, spmm
from vq_gnn_tpu_torch.ops.vq_kernels import (
    ASSIGN_FAST_STEP,
    assign_mismatch,
    fast_rows_per_block,
    fused_assign_branches,
    fused_assign_branches_plain,
    lookup_codewords,
)
from vq_gnn_tpu_torch.sampler import samplers as tsamplers
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

# f32 sums in another order (segment sums vs index_add_): rtol/atol 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("num_rows,E,K", [(300, 2000, 8), (97, 700, 4)])
def test_ell_plain_matches_pallas(num_rows, E, K):
    rng = np.random.RandomState(0)
    C = 128
    row = np.sort(rng.randint(0, num_rows, E))
    col = rng.randint(0, num_rows, E)
    val = rng.randn(E).astype(np.float32)
    er, ec, ev = build_ell_host(row, col, val, num_rows, K)
    jer, jec, jev = j_build_ell(row, col, val, num_rows, K)
    np.testing.assert_array_equal(er, jer)
    S_pad = ((len(er) + 127) // 128) * 128
    er = np.concatenate([er, np.full(S_pad - len(er), num_rows, np.int32)])
    ec = np.concatenate([ec, np.full((S_pad - len(ec), K), num_rows, np.int32)])
    ev = np.concatenate([ev, np.zeros((S_pad - len(ev), K), np.float32)])
    x = rng.randn(num_rows, C).astype(np.float32)
    nbrs = jnp.take(jnp.asarray(x), jnp.asarray(ec).reshape(-1), axis=0, mode="clip")
    ref = ell_aggregate_fused(nbrs, jnp.asarray(er), jnp.asarray(ev), num_rows, interpret=True)
    out = ell_aggregate(_t(x), _t(er), _t(ec), _t(ev), num_rows)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _batch_pair(seed=0):
    """One cluster-sampled training batch from each package (same arrays)."""
    kw = dict(num_layers=2, hidden_channels=16, num_D=4, num_M=8, sampler_type="cluster",
              num_parts=8, batch_size=3, pad_multiple_nodes=64, pad_multiple_edges=512)
    out = []
    for cfg_mod, data, samplers, extra in (
        (jcfg, jdata, jsamplers, {}), (tcfg, tdata, tsamplers, {"device": "cpu"})
    ):
        cfg = cfg_mod.Config(**kw)
        g, c = data.synthetic_sbm(num_nodes=600, num_classes=5, num_features=12, seed=seed)
        g, c, ci = data.prepare(g, cfg, c)
        ld = samplers.BatchLoader(g, cfg, train_flag=True, cluster_indices=ci, **extra)
        (w, _), = [next(ld._epoch_iter())]
        out.append(w[0])
    return out


@pytest.mark.parametrize("truncated", [True, False])
def test_spmm_forward_and_dx_match_jax(truncated):
    jb, tb = _batch_pair()
    je = jax.tree.map(jnp.asarray, jb.edges)
    te = tb.edges.to("cpu")
    assert je.b_rows > 0 and je.t_b_slots > 0  # the truncation is live here
    if not truncated:
        je = je.replace(b_rows=0, t_b_slots=0)
        te = dataclasses.replace(te, b_rows=0, t_b_slots=0)
    rng = np.random.RandomState(1)
    R, C = je.num_rows, 16
    x = rng.randn(R, C).astype(np.float32)
    g = rng.randn(R, C).astype(np.float32)
    out_j, vjp = jax.vjp(lambda xx: j_spmm(je, xx), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    out_t = spmm(te, xt)
    (dx_t,) = torch.autograd.grad(out_t, xt, _t(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), **TOL)
    if truncated:
        assert not dx_t[tb.B_pad :].any()


@pytest.mark.parametrize("C", [128, 256, 40, 36, 7, 3, 200, 130, 1024])
def test_panel_width(C):
    """Kernel 1's channel panels: a multiple of 4 when C is (float4 lanes),
    equal panels that cover C, none wider than PANEL_MAX channels, the
    widest such, and one panel at the flagship width (C = 128)."""
    Cp = panel_width(C)
    unit = 4 if C % 4 == 0 else 1
    assert Cp % unit == 0 and 0 < Cp <= min(C, PANEL_MAX) and C % Cp == 0
    wider = [w for w in range(Cp + unit, min(C, PANEL_MAX) + 1, unit) if C % w == 0]
    assert not wider
    if C <= PANEL_MAX:
        assert Cp == C


@pytest.mark.parametrize("C", [128, 256, 40, 36, 7, 200, 520, 1000])
def test_panel_width_bf16(C):
    """The bf16-row mode's panels: a multiple of 8 when C is (8 bf16 values
    a 16-byte lane load), none wider than PANEL_MAX_BF16, the widest such,
    and one panel up to 256 channels (C = 128 and the GAT hidden 256)."""
    Cp = panel_width(C, torch.bfloat16)
    unit = 8 if C % 8 == 0 else 1
    assert Cp % unit == 0 and 0 < Cp <= min(C, PANEL_MAX_BF16) and C % Cp == 0
    assert not [w for w in range(Cp + unit, min(C, PANEL_MAX_BF16) + 1, unit) if C % w == 0]
    if C <= PANEL_MAX_BF16:
        assert Cp == C
    assert panel_width(C) == panel_width(C, torch.float32)  # f32 keeps its panels


def _row_offsets_cases():
    """(slot rows, num_rows) of one training batch (forward ELL with its
    dustbin padding; the truncated transposed prefix with its ride-over
    slots clamped to b_rows) and of rows with gaps and rows past the end."""
    _, tb = _batch_pair()
    e = tb.edges
    tp = np.minimum(e.t_ell_row[: e.t_b_slots], e.b_rows)
    assert (e.ell_row == e.num_rows).any() and (tp == e.b_rows).any()
    gaps = np.array([0, 0, 2, 2, 2, 5, 9, 9, 11, 12, 12], np.int32)
    return {
        "forward": (e.ell_row, e.num_rows, (e.ell_ptr, e.ell_long_rows)),
        "dx prefix": (tp, e.b_rows, (e.t_ell_ptr, e.t_ell_long_rows)),
        "gaps": (gaps, 10, None),
    }


@pytest.mark.parametrize("case", ["forward", "dx prefix", "gaps"])
def test_long_rows_host(case):
    """The rows kernel 1 starts first: the threshold, then exactly the rows
    of more than that many slots, most slots first, ties in index order; and
    what build_padded_batch stored."""
    row, num_rows, built = _row_offsets_cases()[case]
    ptr = row_offsets_host(row, num_rows)
    slots = np.diff(ptr)
    for t in (0, 1, 2, LONG_SLOTS):
        listed = long_rows_host(ptr, t)
        assert listed.dtype == np.int32 and listed[0] == t  # the list carries its threshold
        rows = listed[1:]
        assert sorted(rows.tolist()) == np.flatnonzero(slots > t).tolist()
        key = [(-slots[r], r) for r in rows]
        assert key == sorted(key)
    if built is not None:
        np.testing.assert_array_equal(built[1], long_rows_host(ptr))
    with pytest.raises(ValueError):
        long_rows_host(ptr, -1)


@pytest.mark.parametrize("case", ["forward", "dx prefix", "gaps"])
def test_row_offsets_host_match_the_kernel_rule(case):
    """The batch's host-built row offsets against the device rule's plain
    version (first slot whose clamped row is >= r)."""
    row, num_rows, built = _row_offsets_cases()[case]
    host = row_offsets_host(row, num_rows)
    ref = row_offsets_plain(torch.as_tensor(np.asarray(row, np.int32)), num_rows)
    np.testing.assert_array_equal(host, ref.numpy())
    if built is not None:  # what build_padded_batch stored
        np.testing.assert_array_equal(built[0], host)


def test_spmm_dval_matches_jax():
    jb, tb = _batch_pair()
    je = jax.tree.map(jnp.asarray, jb.edges)
    te = tb.edges.to("cpu")
    rng = np.random.RandomState(2)
    x = rng.randn(je.num_rows, 16).astype(np.float32)
    g = rng.randn(je.num_rows, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda v: j_spmm(je.replace(ell_val=v), jnp.asarray(x)), je.ell_val)
    (dv_j,) = vjp(jnp.asarray(g))
    v = te.ell_val.clone().requires_grad_(True)
    out = spmm(te, _t(x), ell_val=v)
    (dv_t,) = torch.autograd.grad(out, v, _t(g))
    np.testing.assert_allclose(dv_t.numpy(), np.asarray(dv_j), **TOL)


def _near_tie_ok(xn, emb, idx_a, idx_b):
    """Where two assignments differ, their distances must tie to within
    1e-5 of the row's distance scale; such rows must be < 0.1%."""
    diff = idx_a != idx_b
    if not diff.any():
        return
    assert diff.mean() < 1e-3, diff.mean()
    b, i = np.nonzero(diff)
    x = xn[b, i].astype(np.float64)
    d = lambda m: ((x - emb[b, m].astype(np.float64)) ** 2).sum(-1)  # noqa: E731
    da, db = d(idx_a[b, i]), d(idx_b[b, i])
    scale = np.abs((x[:, None, :] - emb[b].astype(np.float64)) ** 2).sum(-1).max(-1)
    assert np.all(np.abs(da - db) < 1e-5 * scale)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("nb,B,M,K", [(4, 2048, 64, 8), (1, 1000, 16, 4)])
def test_assign_plain_matches_pallas(nb, B, M, K, fast):
    rng = np.random.RandomState(3)
    xn = rng.randn(nb, B, K).astype(np.float32)
    emb = rng.randn(nb, M, K).astype(np.float32)
    valid = rng.rand(B) < 0.9
    idx_j, cnt_j, sums_j = [
        np.asarray(a)
        for a in j_assign(jnp.asarray(xn), jnp.asarray(emb), jnp.asarray(valid),
                          interpret=True, fast=fast)
    ]
    idx_t, cnt_t, sums_t = [
        a.numpy() for a in fused_assign_branches(_t(xn), _t(emb), _t(valid), fast=fast)
    ]
    _near_tie_ok(xn, emb, idx_j, idx_t)
    if np.array_equal(idx_j, idx_t):
        np.testing.assert_array_equal(cnt_t, cnt_j)
        # summation order only: each sum within 1e-5 of the sum of the |x| it adds
        _, _, abs_sums = fused_assign_branches_plain(
            _t(np.abs(xn)), _t(emb), _t(valid), fast=fast, idx=torch.as_tensor(idx_t))
        assert np.all(np.abs(sums_t - sums_j) <= 1e-5 * abs_sums.numpy())
    else:
        assert np.abs(cnt_t - cnt_j).sum() <= 2 * (idx_j != idx_t).sum()


def _mismatch_case(K, seed=7):
    """Random rows and a codebook whose codeword 1 copies codeword 0 and
    codeword 3 lies far from every row."""
    rng = np.random.RandomState(seed)
    xn = rng.randn(2, 300, K).astype(np.float32)
    emb = rng.randn(2, 16, K).astype(np.float32)
    emb[:, 1] = emb[:, 0]
    emb[:, 3] = 50.0
    return _t(xn), _t(emb)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("K", [4, 9, 17])
def test_assign_mismatch_accepts_exact_tie(K, fast):
    xn, emb = _mismatch_case(K)
    idx_ref = torch.zeros((2, 300), dtype=torch.int64)
    idx = idx_ref.clone()
    idx[:, ::7] = 1  # the copy of codeword 0: the same distance
    n_diff, worst = assign_mismatch(xn, emb, idx, idx_ref, fast=fast)
    assert n_diff == int((idx != idx_ref).sum()) and worst == 0.0
    assert assign_mismatch(xn, emb, idx_ref, idx_ref, fast=fast) == (0, 0.0)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("K", [4, 9, 17])
def test_assign_mismatch_rejects_a_pick_beyond_tol(K, fast):
    xn, emb = _mismatch_case(K)
    idx_ref, _, _ = fused_assign_branches_plain(xn, emb, torch.ones(300, dtype=torch.bool),
                                                fast=fast)
    idx = idx_ref.clone()
    idx[1, 5] = 3  # far from every row
    n_diff, worst = assign_mismatch(xn, emb, idx, idx_ref, fast=fast)
    assert n_diff == 1 and worst > 1.0
    # the reverse pick is closer: negative ratio
    assert assign_mismatch(xn, emb, idx_ref, idx, fast=fast)[1] < 0.0


@pytest.mark.parametrize("fast", [False, True])
def test_assign_mismatch_holds_plain_against_pallas(fast):
    """The plain version's assignment against the Pallas kernel's (interpret
    mode) passes the near-tie rule that holds the fast CUDA kernel."""
    rng = np.random.RandomState(8)
    nb, B, M, K = 4, 2048, 64, 9
    xn = rng.randn(nb, B, K).astype(np.float32)
    emb = rng.randn(nb, M, K).astype(np.float32)
    valid = np.ones(B, bool)
    idx_j = np.asarray(j_assign(jnp.asarray(xn), jnp.asarray(emb), jnp.asarray(valid),
                                interpret=True, fast=fast)[0])
    idx_t, _, _ = fused_assign_branches_plain(_t(xn), _t(emb), _t(valid), fast=fast)
    n_diff, worst = assign_mismatch(_t(xn), _t(emb), idx_t, torch.from_numpy(np.array(idx_j)).long(),
                                    fast=fast)
    assert worst <= 1.0 and n_diff < 1e-3 * nb * B


@pytest.mark.parametrize("nb,B", [(32, 90112), (32, 12288), (1, 90112), (2, 700), (3, 0)])
def test_fast_rows_per_block_fills_the_card_in_one_wave(nb, B):
    """The fast kernel's grid: whole 512-row steps per block, every row
    covered, at most two blocks per SM of a 132-SM card (or one per branch)."""
    rows = fast_rows_per_block(nb, B, 132)
    nblk = -(-B // rows)
    assert rows % ASSIGN_FAST_STEP == 0 and nblk * rows >= B
    assert nb * nblk <= max(2 * 132, nb)
    if B >= 2 * 132 * ASSIGN_FAST_STEP // nb:  # enough rows: the grid is nearly full
        assert nb * nblk > 132


@pytest.mark.parametrize("fast", [False, True])
def test_lookup_plain_matches_pallas(fast):
    rng = np.random.RandomState(4)
    N, nb, M, K, n = 700, 4, 64, 8, 500
    c_idx = rng.randint(0, M, (N + 1, nb)).astype(np.int16)
    ids = rng.randint(0, N + 1, n).astype(np.int64)
    emb_out = rng.randn(nb, M, K).astype(np.float32)
    c = jnp.asarray(c_idx[ids].astype(np.int32).T)
    ref = np.asarray(j_lookup(c, jnp.asarray(emb_out), interpret=True, fast=fast))
    out = lookup_codewords(_t(c_idx), _t(ids), _t(emb_out), fast=fast).numpy()
    np.testing.assert_array_equal(out, ref)  # a gather: bit-equal in both modes


def test_uncounted_leaves_every_counter_as_it_was():
    """Launches inside ``ops.uncounted()`` (here set by hand: CPU tensors
    launch nothing) leave every counter, the per-width ones included, as it
    was; outside it they count."""
    from vq_gnn_tpu_torch import ops

    ops.reset_launch_counts()
    ops.KERNELS["segment_sum"].launches = 2
    ops.KERNELS["gat_backward"].by_width[(128, "float32")] = 1
    before = ops.launch_counts()
    widths = {k: dict(ops.KERNELS[k].by_width) for k in ("gat_backward", "vq_assign")}
    with ops.uncounted():
        for name, fn in ops.KERNELS.items():
            fn.launches += 1
        for fn in ops.BF16_MODES.values():
            fn.launches_bf16 += 1
        for fn in ops.SCALAR_MODES.values():
            fn.launches_scalar += 1
        ops.KERNELS["gat_backward"].by_width[(256, "bfloat16")] += 1
        ops.KERNELS["vq_assign"].by_width[9] += 1
    assert ops.launch_counts() == before
    assert {k: dict(ops.KERNELS[k].by_width) for k in widths} == widths
    ops.KERNELS["segment_sum"].launches += 1
    assert ops.launch_counts()["segment_sum"] == 3
    ops.reset_launch_counts()
    assert not any(ops.launch_counts().values())
