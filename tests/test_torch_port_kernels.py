"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the plain versions of kernels 8-10 against the JAX package's Pallas
kernels in interpret mode, on the CPU.

The tests marked ``cuda`` need an NVIDIA GPU and nvcc and skip without them;
the JAX comparisons skip where JAX is not installed.  On a machine with a GPU
but without JAX, run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py -q
"""

import numpy as np
import pytest
import torch

from vq_gnn_tpu_torch.ops import _build
from vq_gnn_tpu_torch.ops.ell_aggregate import (
    LONG_SLOTS,
    ell_aggregate,
    ell_aggregate_plain,
    row_offsets_plain,
)
from vq_gnn_tpu_torch.ops.gat_kernels import (
    gat_aggregate,
    gat_aggregate_plain,
    gat_backward,
    gat_backward_plain,
)
from vq_gnn_tpu_torch.ops.rev_ell import (
    REV_LONG_SLOTS,
    build_rev_ell,
    pad_rev_ell,
    rev_long_rows_host,
)
from vq_gnn_tpu_torch.ops.rev_kernels import (
    rev_backward,
    rev_forward,
    rev_recovery_info,
    rev_recovery_info_plain,
)
from vq_gnn_tpu_torch.ops.segsum import segment_sum_sorted, segment_sum_sorted_plain, take_rows
from vq_gnn_tpu_torch.ops.spmm import build_ell_host, long_rows_host, row_offsets_host
from vq_gnn_tpu_torch.ops.vq_kernels import (
    assign_mismatch,
    fused_assign_branches,
    fused_assign_branches_plain,
    lookup_codewords,
    lookup_codewords_plain,
)

cuda = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _vml_first_call():
    """torch's CPU exp (an MKL build) runs MKL's vector math in chunks of
    2,048 values on the intra-op threads.  The first such call of a process,
    in a process that has run the JAX side, at times returns a chunk or two
    at a lower accuracy (1.48e-4 relative, the same wrong value for the same
    input in every faulty run); every later call is right.  This throwaway
    call takes the first one before any value is checked.  The same fixture
    stands in each port test file that reaches torch.exp."""
    torch.exp(torch.zeros(1 << 16))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.nvcc()  # raises when the toolkit is missing
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ell_case(num_rows, E, K, C, seed, x_rows=None, S_extra=37):
    rng = np.random.RandomState(seed)
    x_rows = num_rows if x_rows is None else x_rows
    row = np.sort(rng.randint(0, num_rows, E))
    col = rng.randint(0, x_rows, E)
    val = rng.randn(E).astype(np.float32)
    er, ec, ev = build_ell_host(row, col, val, num_rows, K)
    pad = S_extra
    er = np.concatenate([er, np.full(pad, num_rows, np.int32)])
    ec = np.concatenate([ec, np.full((pad, K), x_rows, np.int32)])  # one past x
    ev = np.concatenate([ev, np.zeros((pad, K), np.float32)])
    x = rng.randn(x_rows, C).astype(np.float32)
    return er, ec, ev, x


# ELL aggregate: summation order differs (per-lane sequential vs einsum +
# index_add_), so f32 round-off: rtol 1e-5 and atol 1e-5 x the row's scale.
@cuda
@pytest.mark.parametrize(
    "num_rows,E,K,C",
    [(3000, 40000, 8, 128), (517, 3000, 4, 36), (129, 900, 8, 7), (200, 0, 8, 128),
     (3000, 40000, 8, 32), (2000, 20000, 8, 64), (700, 6000, 8, 256)],
)
def test_ell_aggregate_matches_plain(dev, num_rows, E, K, C):
    er, ec, ev, x = _ell_case(num_rows, E, K, C, 0)
    args = [torch.as_tensor(a).to(dev) for a in (x, er, ec, ev)]
    out = ell_aggregate(*args, num_rows)
    ref = ell_aggregate_plain(*args, num_rows)
    torch.cuda.synchronize()
    assert out.shape == (num_rows, C)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * max(1.0, float(ref.abs().max())))


@cuda
def test_ell_aggregate_truncated_rows(dev):
    """The backward's form: a prefix of the transposed slots with rows
    clamped to b_rows (dropped), out rows = b_rows, x longer than out."""
    num_rows, b_rows = 2000, 700
    er, ec, ev, x = _ell_case(num_rows, 20000, 8, 128, 1)
    tb = int((er < b_rows).sum()) + 5  # a few ride-over slots inside the bound
    er_t = np.minimum(er[:tb], b_rows)
    args = [torch.as_tensor(a).to(dev) for a in (x, er_t, ec[:tb].copy(), ev[:tb].copy())]
    out = ell_aggregate(*args, b_rows)
    ref = ell_aggregate_plain(*args, b_rows)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


def _ell_variants(x, er, ec, ev, num_rows):
    """Kernel 1 on the same inputs: at panel counts 1, 2, 4 and the default,
    with the host's row offsets and long rows, with long-row lists of other
    thresholds than the default, or without either (offsets built on the
    device, every row in index order), and a second call."""
    ptr = row_offsets_host(er, num_rows)
    host = dict(ptr=torch.as_tensor(ptr).to(x.device),
                long_rows=torch.as_tensor(long_rows_host(ptr)).to(x.device))
    args = [torch.as_tensor(a).to(x.device) for a in (er, ec, ev)]
    outs = {f"P={P}": ell_aggregate(x, *args, num_rows, panels=P, **host) for P in (1, 2, 4)}
    outs["default"] = ell_aggregate(x, *args, num_rows, **host)
    for t in (0, 4):  # the kernel skips in index order by the list's own threshold
        lr = torch.as_tensor(long_rows_host(ptr, t)).to(x.device)
        outs[f"rows of more than {t} slots first"] = ell_aggregate(
            x, *args, num_rows, ptr=host["ptr"], long_rows=lr)
    outs["device offsets"] = ell_aggregate(x, *args, num_rows)
    outs["device offsets, P=4"] = ell_aggregate(x, *args, num_rows, panels=4)
    outs["default again"] = ell_aggregate(x, *args, num_rows, **host)
    ref = ell_aggregate_plain(x, *args, num_rows)
    torch.cuda.synchronize()
    return outs, ref


def _hold_ell_variants(outs, ref):
    """Every variant the same bits (each (row, channel) sums its cells in slot
    order whatever the panels, the long rows or the run), and all
    within f32 round-off of the plain version."""
    first = outs["P=1"]
    assert torch.isfinite(first).all()
    for name, o in outs.items():
        assert torch.equal(o, first), name
    torch.testing.assert_close(first, ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(ref.abs().max())))


@cuda
@pytest.mark.parametrize("C", [7, 32, 36, 64, 128, 256])
def test_ell_aggregate_same_bits_across_panels(dev, C):
    """C = 7, 32, 36, 64, 128, 256: one vector per lane at 8, 16 and 32
    lanes, float4 and single-channel lanes, one and two panels."""
    er, ec, ev, x = _ell_case(3000, 40000, 8, C, 9)
    _hold_ell_variants(*_ell_variants(torch.as_tensor(x).to(dev), er, ec, ev, 3000))


@cuda
def test_ell_aggregate_ragged_rows(dev):
    """One row with ~2,000 cells (250 slots), the rest with 0-2: the long
    row takes a warp of its own (the host's list) or goes in index order;
    its sum crosses many windows and many gather batches."""
    rng = np.random.RandomState(10)
    num_rows, C = 4000, 128
    row = np.concatenate([np.full(2000, 1234), rng.randint(0, num_rows, 4000)])
    row.sort(kind="stable")
    col = rng.randint(0, num_rows, len(row))
    val = rng.randn(len(row)).astype(np.float32)
    er, ec, ev = build_ell_host(row, col, val, num_rows, 8)
    x = torch.as_tensor(rng.randn(num_rows, C).astype(np.float32)).to(dev)
    outs, ref = _ell_variants(x, er, ec, ev, num_rows)
    _hold_ell_variants(outs, ref)
    assert float(ref[1234].abs().max()) > 0


@cuda
@pytest.mark.parametrize("x_rows,layout", [(5000, "aligned"), (700, "aligned"),
                                           (3000, "unaligned")])
def test_ell_aggregate_x_rows_and_alignment(dev, x_rows, layout):
    """x with more rows than the output (the dx's form) and with fewer
    (columns past its end clamp to its last row), and an x whose start is
    not 16-byte aligned (the kernel's one-channel lanes)."""
    num_rows, C = 3000, 64
    er, ec, ev, x = _ell_case(num_rows, 30000, 8, C, 11, x_rows=x_rows)
    if x_rows < num_rows:  # a tenth of the live cells point past the end of x
        rng = np.random.RandomState(12)
        past = (ev != 0) & (rng.rand(*ec.shape) < 0.1)
        ec[past] = rng.randint(x_rows, num_rows + 1, int(past.sum()))
    xt = torch.as_tensor(x).to(dev)
    if layout == "unaligned":
        buf = torch.empty(xt.numel() + 1, device=dev)
        xt = buf[1:].view(x_rows, C)
        xt.copy_(torch.as_tensor(x).to(dev))
        assert xt.data_ptr() % 16 != 0 and xt.is_contiguous()
    _hold_ell_variants(*_ell_variants(xt, er, ec, ev, num_rows))


@cuda
def test_ell_aggregate_offsets_past_the_slots(dev):
    """Row offsets built for more slots than the kernel is given: each row
    sums only its slots among those given (the kernel clamps the offsets to
    the slots), as the plain version of the shortened ELL does."""
    num_rows = 3000
    er, ec, ev, x = _ell_case(num_rows, 30000, 8, 128, 14)
    ptr = torch.as_tensor(row_offsets_host(er, num_rows)).to(dev)
    S = len(er) // 2
    args = [torch.as_tensor(np.ascontiguousarray(a[:S])).to(dev) for a in (er, ec, ev)]
    xt = torch.as_tensor(x).to(dev)
    out = ell_aggregate(xt, *args, num_rows, ptr=ptr)
    ref = ell_aggregate_plain(xt, *args, num_rows)
    assert int(ptr[-1]) > S
    _close_to_ref(out, ref)


@cuda
def test_ell_aggregate_rows_without_slots(dev):
    """Rows that own no slot at all (every third row, and a run of 40 at the
    end) come out 0; their neighbours' sums are unaffected."""
    num_rows = 3000
    er, ec, ev, x = _ell_case(num_rows, 30000, 8, 128, 13, S_extra=0)
    keep = (er % 3 != 1) & (er < num_rows - 40)
    er, ec, ev = er[keep], ec[keep], ev[keep]
    outs, ref = _ell_variants(torch.as_tensor(x).to(dev), er, ec, ev, num_rows)
    _hold_ell_variants(outs, ref)
    assert not outs["default"][1::3].any() and not outs["default"][-40:].any()


def _close_to_ref(out, ref):
    """f32 sums in another order: rtol 1e-5 and atol 1e-5 x the largest |ref|."""
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * max(1.0, float(ref.abs().max())))


# GAT aggregate: the plain version's einsum + index_add_ against the kernel's
# per-lane sequential sums (exp of the same logits on both sides).  C = 256
# takes two float4 a lane, 1000 the chunked walk, 36 and 7 narrow lane
# groups; with the host's row offsets and long rows, and without them
@cuda
@pytest.mark.parametrize("lists", [False, True])
@pytest.mark.parametrize("with_neg", [True, False])
@pytest.mark.parametrize(
    "num_rows,E,K,C",
    [(3000, 40000, 8, 128), (300, 2000, 8, 256), (300, 2000, 8, 1000), (517, 3000, 4, 36),
     (129, 900, 8, 7), (200, 0, 8, 128)],
)
def test_gat_aggregate_matches_plain(dev, num_rows, E, K, C, with_neg, lists):
    er, ec, ev, x = _ell_case(num_rows, E, K, C, 4)
    rng = np.random.RandomState(5)
    al = (rng.randn(x.shape[0]) * 0.7).astype(np.float32)
    ar = (rng.randn(num_rows) * 0.7).astype(np.float32)
    args = [torch.as_tensor(a).to(dev) for a in (x, er, ec, ev, al, ar)]
    kw = {}
    if lists:
        ptr = row_offsets_host(er, num_rows)
        kw = dict(ptr=torch.as_tensor(ptr).to(dev),
                  long_rows=torch.as_tensor(long_rows_host(ptr, 2)).to(dev))
    out = gat_aggregate(*args, num_rows, with_neg=with_neg, **kw)
    ref = gat_aggregate_plain(*args, num_rows, with_neg=with_neg)
    torch.cuda.synchronize()
    assert out[0].shape == (num_rows, C) and out[1].shape == (num_rows,)
    for o, r in zip(out, ref):
        if r is None:
            assert o is None
        else:
            _close_to_ref(o, r)


# Kernel 4 with the row offsets and long-row lists a batch carries, on a
# ragged ELL (a 700-cell row, rows without a slot, zero cells, padding
# columns one past x): the plain version (tolerance as above), and the same
# bits in two calls and across the lists.  C = 7 and 36 take 8 and 16 lanes a
# row, 128 and 256 a warp with one and two float4 a lane, 1000 the chunked
# walk.
@cuda
@pytest.mark.parametrize("C", [7, 36, 128, 256, 1000])
def test_gat_aggregate_row_lists_and_same_bits(dev, C):
    R = 900
    er, ec, ev, x, _, _, al, ar = _gat_bwd_cut_case(R, C, 12, long_cells=(150, 700))
    live = np.bincount(np.minimum(er, R), (ev != 0).sum(1), R + 1)[:R]
    assert live.max() >= 600
    ptr_h = row_offsets_host(er, R)
    assert (np.diff(ptr_h) == 0).sum() >= R // 5  # rows without a slot
    args = [torch.as_tensor(a).to(dev) for a in (x, er, ec, ev, al, ar)]
    ptr = torch.as_tensor(ptr_h).to(dev)
    lists = {
        "offsets built on the device": {},
        "offsets, rows in index order": dict(ptr=ptr),
        f"rows of more than {LONG_SLOTS} slots first": dict(
            ptr=ptr, long_rows=torch.as_tensor(long_rows_host(ptr_h)).to(dev)),
        "every row with a slot first": dict(
            ptr=ptr, long_rows=torch.as_tensor(long_rows_host(ptr_h, 0)).to(dev)),
    }
    for with_neg in (True, False):
        ref = gat_aggregate_plain(*args, R, with_neg=with_neg)
        first = None
        for label, kw in lists.items():
            out = gat_aggregate(*args, R, with_neg=with_neg, **kw)
            again = gat_aggregate(*args, R, with_neg=with_neg, **kw)
            torch.cuda.synchronize()
            for o, r in zip(out, ref):
                if r is None:
                    assert o is None
                else:
                    _close_to_ref(o, r)
            first = out if first is None else first
            for o, a, f in zip(out, again, first):
                assert o is a is f is None or (torch.equal(a, o) and torch.equal(f, o)), label
        empty = torch.as_tensor(np.flatnonzero(np.diff(ptr_h) == 0)).to(dev)
        assert not first[0][empty].any() and not first[1][empty].any()


@cuda
def test_gat_aggregate_offsets_past_the_slots(dev):
    """Row offsets built for more slots than the kernel is given: each row
    sums only its slots among those given (the kernel clamps the offsets to
    the slots), as the plain version of the shortened ELL does."""
    num_rows = 3000
    er, ec, ev, x = _ell_case(num_rows, 30000, 8, 128, 15)
    rng = np.random.RandomState(16)
    al, ar = ((rng.randn(num_rows) * 0.7).astype(np.float32) for _ in range(2))
    ptr = torch.as_tensor(row_offsets_host(er, num_rows)).to(dev)
    S = len(er) // 2
    ell = [torch.as_tensor(np.ascontiguousarray(a[:S])).to(dev) for a in (er, ec, ev)]
    xt, alt, art = (torch.as_tensor(a).to(dev) for a in (x, al, ar))
    out = gat_aggregate(xt, *ell, alt, art, num_rows, ptr=ptr)
    ref = gat_aggregate_plain(xt, *ell, alt, art, num_rows)
    assert int(ptr[-1]) > S
    for o, r in zip(out, ref):
        _close_to_ref(o, r)


# GAT backward over a transposed ELL; C = 2000 takes the chunked walk of
# wide rows, C = 7 and 36 narrow lane groups (7 one channel a lane)
@cuda
@pytest.mark.parametrize(
    "num_rows,E,K,C",
    [(3000, 40000, 8, 128), (700, 6000, 8, 256), (517, 3000, 4, 36), (129, 900, 8, 7),
     (300, 2000, 8, 2000)],
)
def test_gat_backward_matches_plain(dev, num_rows, E, K, C):
    er, ec, ev, x = _ell_case(num_rows, E, K, C, 6)
    rng = np.random.RandomState(7)
    g = rng.randn(num_rows, C).astype(np.float32)
    g_rs = rng.randn(num_rows).astype(np.float32)
    al = (rng.randn(num_rows) * 0.7).astype(np.float32)
    ar = (rng.randn(num_rows) * 0.7).astype(np.float32)
    args = [torch.as_tensor(a).to(dev) for a in (x, er, ec, ev, g, g_rs, al, ar)]
    dx, d_al = gat_backward(*args, num_rows)
    dx_r, d_al_r = gat_backward_plain(*args, num_rows)
    torch.cuda.synchronize()
    assert gat_backward.by_width[(C, "float32")] > 0
    _close_to_ref(dx, dx_r)
    _close_to_ref(d_al, d_al_r)


def _gat_bwd_cut_case(num_rows, C, seed, long_cells=(150, 400)):
    """A transposed ELL with two long rows (by default 150 and 400 cells),
    rows that own no slot (every fifth, and the last 20), zero cells among
    the live ones (so live counts are rarely multiples of 8) and padding
    slots whose columns point one past g_agg's end; random x, g_agg,
    g_rowsum, al, ar."""
    rng = np.random.RandomState(seed)
    R = num_rows
    row = np.concatenate([rng.randint(0, R, 10 * R), np.full(long_cells[0], 3),
                          np.full(long_cells[1], R // 2)])
    row = np.sort(row)
    col = rng.randint(0, R, row.shape[0])
    val = rng.randn(row.shape[0]).astype(np.float32)
    val[rng.rand(row.shape[0]) < 0.15] = 0.0
    er, ec, ev = build_ell_host(row, col, val, R, 8)
    keep = (er % 5 != 1) & (er < R - 20)
    pad = 37
    er = np.concatenate([er[keep], np.full(pad, R, np.int32)])
    ec = np.concatenate([ec[keep], np.full((pad, 8), R, np.int32)])
    ev = np.concatenate([ev[keep], np.zeros((pad, 8), np.float32)])
    x, g = (rng.randn(R, C).astype(np.float32) for _ in range(2))
    g_rs, al, ar = ((rng.randn(R) * 0.7).astype(np.float32) for _ in range(3))
    return er, ec, ev, x, g, g_rs, al, ar


# Kernel 5 at every dx_rows, with the row offsets and long-row lists a batch
# carries: the plain version at the same dx_rows (tolerance as above), zeros
# above dx_rows, and the same bits in two calls and across dx_rows.  C = 7
# and 36 take 8 and 16 lanes a row, 128 and 256 a warp with one and two
# float4 a lane, 1000 the chunked walk.
@cuda
@pytest.mark.parametrize("C", [7, 36, 128, 256, 1000])
def test_gat_backward_dx_rows_and_row_lists(dev, C):
    R = 900
    er, ec, ev, x, g, g_rs, al, ar = _gat_bwd_cut_case(R, C, 11)
    live = np.bincount(np.minimum(er, R), (ev != 0).sum(1), R + 1)[:R]
    assert live.max() > 100 and (live % 8 != 0).sum() > R // 2
    ptr_h = row_offsets_host(er, R)
    assert (np.diff(ptr_h) == 0).sum() >= R // 5  # rows without a slot
    args = [torch.as_tensor(a).to(dev) for a in (x, er, ec, ev, g, g_rs, al, ar)]
    ptr = torch.as_tensor(ptr_h).to(dev)
    lists = {
        "offsets built on the device": {},
        "offsets, rows in index order": dict(ptr=ptr),
        f"rows of more than {LONG_SLOTS} slots first": dict(
            ptr=ptr, long_rows=torch.as_tensor(long_rows_host(ptr_h)).to(dev)),
        "every row with a slot first": dict(
            ptr=ptr, long_rows=torch.as_tensor(long_rows_host(ptr_h, 0)).to(dev)),
    }
    for label, kw in lists.items():
        full = None
        for dx_rows in (R, 0, 1, R // 3):
            dx, d_al = gat_backward(*args, R, dx_rows=dx_rows, **kw)
            again = gat_backward(*args, R, dx_rows=dx_rows, **kw)
            dx_r, d_al_r = gat_backward_plain(*args, R, dx_rows=dx_rows)
            torch.cuda.synchronize()
            _close_to_ref(d_al, d_al_r)
            assert torch.equal(again[1], d_al), (label, dx_rows)
            if full is None:
                full = dx, d_al
            assert torch.equal(d_al, full[1]), (label, dx_rows)
            if dx_rows == 0:
                assert dx is None and dx_r is None and again[0] is None
                continue
            _close_to_ref(dx, dx_r)
            assert not dx[dx_rows:].any()
            assert torch.equal(again[0], dx), (label, dx_rows)
            assert torch.equal(dx[:dx_rows], full[0][:dx_rows]), (label, dx_rows)


# A cell of value 0 is padding to the kernels of rows 1-4: they skip it, where
# the plain versions (and the JAX package) multiply it.  The two differ only
# where a non-finite row of the gathered table (x; g_agg in the backward) is
# read through zero cells alone: the kernel then gives what the plain version
# gives on the ELL without those cells, the plain version NaN.  No sampler
# emits a real edge of value 0 (ROADMAP.md queue 3), so this is the accepted
# reading.
@cuda
@pytest.mark.parametrize("kernel", ["ell_aggregate", "gat_aggregate", "gat_backward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_zero_cells_are_padding(dev, kernel, dtype):
    R, C, nan_row = 900, 128, 7
    rng = np.random.RandomState(21)
    row = np.sort(rng.randint(0, R, 10 * R))
    col = rng.randint(0, R, row.shape[0])
    col[col == nan_row] = nan_row + 1  # no real cell reads nan_row
    val = rng.randn(row.shape[0]).astype(np.float32)
    zero = rng.choice(row.shape[0], 40, replace=False)
    col[zero], val[zero] = nan_row, 0.0  # zero cells do
    keep = val != 0
    table = rng.randn(R, C).astype(np.float32)
    table[nan_row] = np.nan
    x, g = (rng.randn(R, C).astype(np.float32) for _ in range(2))
    g_rs, al, ar = ((rng.randn(R) * 0.7).astype(np.float32) for _ in range(3))

    def rows(a):  # the tensors the 16-bit-row modes take in 16 bits
        return torch.as_tensor(a).to(dev).to(dtype)

    def args(sel):
        ell = [torch.as_tensor(a).to(dev) for a in build_ell_host(row[sel], col[sel], val[sel],
                                                                   R, 8)]
        al_t = torch.as_tensor(al).to(dev)
        if kernel == "gat_backward":
            ins = (rows(x), *ell, rows(table), rows(g_rs), al_t, rows(ar))
        elif kernel == "gat_aggregate":
            ins = (rows(table), *ell, al_t, torch.as_tensor(ar).to(dev))
        else:
            ins = (rows(table), *ell)
        return list(ins) + [R]

    fn, plain = {"ell_aggregate": (ell_aggregate, ell_aggregate_plain),
                 "gat_aggregate": (gat_aggregate, gat_aggregate_plain),
                 "gat_backward": (gat_backward, gat_backward_plain)}[kernel]
    with_zeros = args(slice(None))
    out, ref_nan, ref = fn(*with_zeros), plain(*with_zeros), plain(*args(keep))
    torch.cuda.synchronize()
    if kernel == "ell_aggregate":
        out, ref_nan, ref = (out,), (ref_nan,), (ref,)
    for o, rn, r in zip(out, ref_nan, ref):
        if r is None:
            assert o is None and rn is None
            continue
        assert torch.isfinite(o).all()
        _close_to_ref(o, r)
    assert any(rn is not None and not torch.isfinite(rn).all() for rn in ref_nan)


@cuda
def test_gat_wrappers_refuse_bad_input(dev):
    er, ec, ev, x = _ell_case(50, 300, 8, 16, 8)
    x, er, ec, ev = [torch.as_tensor(a).to(dev) for a in (x, er, ec, ev)]
    al = torch.zeros(50, device=dev)
    with pytest.raises(ValueError):  # ar must have one entry per output row
        gat_aggregate(x, er, ec, ev, al, al[:10], 50)
    ptr = torch.as_tensor(row_offsets_host(er.cpu().numpy(), 50)).to(dev)
    with pytest.raises(ValueError):  # row offsets for another row count
        gat_aggregate(x, er, ec, ev, al, al, 50, ptr=ptr[:-1].contiguous())
    with pytest.raises(ValueError):  # long rows without the offsets they were taken from
        gat_aggregate(x, er, ec, ev, al, al, 50,
                      long_rows=torch.as_tensor(long_rows_host(ptr.cpu().numpy(), 2)).to(dev))
    with pytest.raises(ValueError):  # float64 cotangent
        gat_backward(x, er, ec, ev, x.double(), al, al, al, 50)
    with pytest.raises(ValueError):  # dx_rows past the rows
        gat_backward(x, er, ec, ev, x, al, al, al, 50, dx_rows=51)


# ---- the 16-bit-row modes of kernels 1, 4 and 5 (compute_dtype='bfloat16'
# or 'float16') ----
# The kernel and its plain version read the same 16-bit values and sum them
# in f32, so only the order of the f32 sums differs: the f32 tests'
# tolerance (rtol 1e-5, atol 1e-5 x the largest |ref|).  C = 128 takes 16
# lanes a row of 8 16-bit values each, 256 a warp, 512 two vectors a lane,
# 1000 and 2000 the chunked walk, 36 and 7 (not multiples of 8) and a
# misaligned x one value a lane.  Each mode counts its own launches.
ROWS16 = {torch.bfloat16: "launches_bf16", torch.float16: "launches_f16"}


def _bf16(*arrays, dev, offset=False, dtype=torch.bfloat16):
    """Each array on the card in ``dtype`` (a 16-bit one); with ``offset`` x
    starts 2 bytes into its buffer, so its rows are not 16-byte aligned."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a).to(dev).to(dtype)
        if offset and t.dim() == 2:
            buf = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
            buf[1:] = t.reshape(-1)
            t = buf[1:].view(t.shape)
        out.append(t)
    return out


def _launches(fn, dtype):
    return fn.launches, getattr(fn, ROWS16[dtype])


ELL16_CASES = [
    (3000, 40000, 8, 128, False), (3000, 40000, 8, 128, True), (700, 6000, 8, 256, False),
    (300, 2000, 8, 1000, False), (517, 3000, 4, 36, False), (129, 900, 8, 7, False),
    (200, 0, 8, 128, False)]


def _hold_ell_aggregate16(dev, dtype, num_rows, E, K, C, offset):
    er, ec, ev, x = _ell_case(num_rows, E, K, C, 0)
    (xb,) = _bf16(x, dev=dev, offset=offset, dtype=dtype)
    ell = [torch.as_tensor(a).to(dev) for a in (er, ec, ev)]
    before = _launches(ell_aggregate, dtype)
    out = ell_aggregate(xb, *ell, num_rows)
    ref = ell_aggregate_plain(xb, *ell, num_rows)
    ptr = torch.as_tensor(row_offsets_host(er, num_rows)).to(dev)
    lr = torch.as_tensor(long_rows_host(ptr.cpu().numpy(), 2)).to(dev)
    same = [ell_aggregate(xb, *ell, num_rows, panels=P, ptr=ptr, long_rows=lr) for P in (1, 2)]
    torch.cuda.synchronize()
    assert _launches(ell_aggregate, dtype) == (before[0], before[1] + 3)
    assert out.dtype == torch.float32 and out.shape == (num_rows, C)
    _close_to_ref(out, ref)
    assert all(torch.equal(o, out) for o in same)  # the same bits at any panel count


@cuda
@pytest.mark.parametrize("num_rows,E,K,C,offset", ELL16_CASES)
def test_ell_aggregate_bf16_matches_plain(dev, num_rows, E, K, C, offset):
    _hold_ell_aggregate16(dev, torch.bfloat16, num_rows, E, K, C, offset)


@cuda
@pytest.mark.parametrize("num_rows,E,K,C,offset", ELL16_CASES)
def test_ell_aggregate_f16_matches_plain(dev, num_rows, E, K, C, offset):
    _hold_ell_aggregate16(dev, torch.float16, num_rows, E, K, C, offset)


GAT_AGG16_CASES = [(3000, 40000, 8, 128), (300, 2000, 8, 256), (300, 2000, 8, 512),
                   (300, 2000, 8, 1000), (517, 3000, 4, 36), (129, 900, 8, 7)]


def _hold_gat_aggregate16(dev, dtype, num_rows, E, K, C, with_neg):
    er, ec, ev, x = _ell_case(num_rows, E, K, C, 4)
    rng = np.random.RandomState(5)
    al = (rng.randn(x.shape[0]) * 0.7).astype(np.float32)
    ar = (rng.randn(num_rows) * 0.7).astype(np.float32)
    (xb,) = _bf16(x, dev=dev, dtype=dtype)
    args = [xb] + [torch.as_tensor(a).to(dev) for a in (er, ec, ev, al, ar)]
    ptr = row_offsets_host(er, num_rows)
    lists = dict(ptr=torch.as_tensor(ptr).to(dev),
                 long_rows=torch.as_tensor(long_rows_host(ptr, 2)).to(dev))
    before = _launches(gat_aggregate, dtype)
    out = gat_aggregate(*args, num_rows, with_neg=with_neg, **lists)
    again = gat_aggregate(*args, num_rows, with_neg=with_neg)
    ref = gat_aggregate_plain(*args, num_rows, with_neg=with_neg)
    torch.cuda.synchronize()
    assert _launches(gat_aggregate, dtype) == (before[0], before[1] + 2)
    for o, a, r in zip(out, again, ref):
        if r is None:
            assert o is None and a is None
            continue
        assert o.dtype == torch.float32
        _close_to_ref(o, r)
        assert torch.equal(o, a)  # the same bits with or without the lists


@cuda
@pytest.mark.parametrize("with_neg", [True, False])
@pytest.mark.parametrize("num_rows,E,K,C", GAT_AGG16_CASES)
def test_gat_aggregate_bf16_matches_plain(dev, num_rows, E, K, C, with_neg):
    _hold_gat_aggregate16(dev, torch.bfloat16, num_rows, E, K, C, with_neg)


@cuda
@pytest.mark.parametrize("with_neg", [True, False])
@pytest.mark.parametrize("num_rows,E,K,C", GAT_AGG16_CASES)
def test_gat_aggregate_f16_matches_plain(dev, num_rows, E, K, C, with_neg):
    _hold_gat_aggregate16(dev, torch.float16, num_rows, E, K, C, with_neg)


GAT_BWD16_CASES = [(3000, 40000, 8, 128), (700, 6000, 8, 256), (300, 2000, 8, 512),
                   (300, 2000, 8, 2000), (517, 3000, 4, 36), (129, 900, 8, 7)]


def _hold_gat_backward16(dev, dtype, num_rows, E, K, C):
    er, ec, ev, x = _ell_case(num_rows, E, K, C, 6)
    rng = np.random.RandomState(7)
    g = rng.randn(num_rows, C).astype(np.float32)
    g_rs = rng.randn(num_rows).astype(np.float32)
    al = (rng.randn(num_rows) * 0.7).astype(np.float32)
    ar = (rng.randn(num_rows) * 0.7).astype(np.float32)
    xb, gb, g_rsb, arb = _bf16(x, g, g_rs, ar, dev=dev, dtype=dtype)
    ell = [torch.as_tensor(a).to(dev) for a in (er, ec, ev)]
    args = [xb, *ell, gb, g_rsb, torch.as_tensor(al).to(dev), arb]
    ptr = row_offsets_host(er, num_rows)
    lists = dict(ptr=torch.as_tensor(ptr).to(dev),
                 long_rows=torch.as_tensor(long_rows_host(ptr, 2)).to(dev))
    before = _launches(gat_backward, dtype)
    for dx_rows in (num_rows, num_rows // 3, 0):
        dx, d_al = gat_backward(*args, num_rows, dx_rows=dx_rows, **lists)
        again = gat_backward(*args, num_rows, dx_rows=dx_rows, **lists)
        dx_r, d_al_r = gat_backward_plain(*args, num_rows, dx_rows=dx_rows)
        torch.cuda.synchronize()
        assert d_al.dtype == torch.float32
        _close_to_ref(d_al, d_al_r)
        assert all(a is b or torch.equal(a, b) for a, b in zip((dx, d_al), again))
        if dx_rows == 0:
            assert dx is None and dx_r is None
        else:
            assert dx.dtype == torch.float32 and not dx[dx_rows:].any()
            _close_to_ref(dx, dx_r)
    assert _launches(gat_backward, dtype) == (before[0], before[1] + 6)
    assert gat_backward.by_width[(C, str(dtype).removeprefix("torch."))] >= 6


@cuda
@pytest.mark.parametrize("num_rows,E,K,C", GAT_BWD16_CASES)
def test_gat_backward_bf16_matches_plain(dev, num_rows, E, K, C):
    _hold_gat_backward16(dev, torch.bfloat16, num_rows, E, K, C)


@cuda
@pytest.mark.parametrize("num_rows,E,K,C", GAT_BWD16_CASES)
def test_gat_backward_f16_matches_plain(dev, num_rows, E, K, C):
    _hold_gat_backward16(dev, torch.float16, num_rows, E, K, C)


@cuda
def test_gat_backward_bf16_wants_its_rows_in_bf16(dev):
    """In the bf16-row mode g_agg, g_rowsum and ar come in bf16 beside x;
    a mix of f32 and bf16 is refused, not cast."""
    er, ec, ev, x = _ell_case(50, 300, 8, 16, 8)
    (xb,) = _bf16(x, dev=dev)
    ell = [torch.as_tensor(a).to(dev) for a in (er, ec, ev)]
    v = torch.zeros(50, device=dev)
    with pytest.raises(ValueError, match="g_agg"):
        gat_backward(xb, *ell, xb.float(), v.bfloat16(), v, v.bfloat16(), 50)
    with pytest.raises(ValueError, match="ar"):
        gat_backward(xb, *ell, xb, v.bfloat16(), v, v, 50)


@cuda
def test_gat_backward_f16_wants_its_rows_in_f16(dev):
    """In the f16-row mode g_agg, g_rowsum and ar come in f16 beside x; a
    mix of f16 with bf16 or f32 is refused, not cast."""
    er, ec, ev, x = _ell_case(50, 300, 8, 16, 8)
    (xh,) = _bf16(x, dev=dev, dtype=torch.float16)
    ell = [torch.as_tensor(a).to(dev) for a in (er, ec, ev)]
    v = torch.zeros(50, device=dev)
    with pytest.raises(ValueError, match="g_agg"):
        gat_backward(xh, *ell, xh.bfloat16(), v.half(), v, v.half(), 50)
    with pytest.raises(ValueError, match="g_rowsum"):
        gat_backward(xh, *ell, xh, v.bfloat16(), v, v.half(), 50)
    with pytest.raises(ValueError, match="ar"):
        gat_backward(xh, *ell, xh, v.half(), v, v, 50)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=cuda)])
@pytest.mark.parametrize("kernel", ["ell_aggregate", "gat_aggregate", "gat_backward"])
def test_wrappers_refuse_float16(kernel, device, request):
    """Kernels 1, 4 and 5 take f32, bf16 or f16 rows (float16 no longer
    refused: f16 x runs, with f32 outputs); any other dtype (float64) is
    refused by name, on the card and on the CPU alike (no cast to any)."""
    dev = request.getfixturevalue("dev") if device == "cuda" else torch.device("cpu")
    er, ec, ev, x = _ell_case(50, 300, 8, 16, 8)
    ell = [torch.as_tensor(a).to(dev) for a in (er, ec, ev)]
    v = torch.zeros(50, device=dev)

    def call(xt):
        return {"ell_aggregate": lambda: ell_aggregate(xt, *ell, 50),
                "gat_aggregate": lambda: gat_aggregate(xt, *ell, v, v, 50),
                "gat_backward": lambda: gat_backward(xt, *ell, xt, v.to(xt.dtype), v,
                                                     v.to(xt.dtype), 50)}[kernel]()

    out = call(torch.as_tensor(x).to(dev).half())
    out = out if isinstance(out, tuple) else (out,)
    assert all(o is None or o.dtype == torch.float32 for o in out)
    with pytest.raises(ValueError, match=f"{kernel}: x must be float32, bfloat16 or float16, "
                                         "got torch.float64"):
        call(torch.as_tensor(x).to(dev).double())


def _assign_case(nb, B, M, K, seed):
    rng = np.random.RandomState(seed)
    xn = rng.randn(nb, B, K).astype(np.float32)
    emb = rng.randn(nb, M, K).astype(np.float32)
    valid = rng.rand(B) < 0.9
    return xn, emb, valid


def _hold_assign(args, fast, out):
    """Kernel 2's (idx, counts, sums) against its plain version.  Exact mode:
    idx and counts equal (the kernel repeats the plain arithmetic).  Fast
    mode: the tensor cores sum in their own order, so idx may differ at near
    ties only (``assign_mismatch``: worst ratio <= 1 on < 1e-3 of the rows),
    and counts and sums are held at the kernel's own idx.  Sums differ only
    by summation order: each by at most 1e-5 of the sum of the |x| it adds."""
    idx, counts, sums = out
    idx_r, counts_r, sums_r = fused_assign_branches_plain(*args, fast=fast)
    if fast:
        n_diff, worst = assign_mismatch(args[0], args[1], idx, idx_r, fast=True)
        assert worst <= 1.0 and n_diff < 1e-3 * idx.numel(), (n_diff, worst)
        _, counts_r, sums_r = fused_assign_branches_plain(*args, fast=True, idx=idx)
    else:
        assert torch.equal(idx, idx_r)
    assert torch.equal(counts, counts_r)
    _, _, abs_sums = fused_assign_branches_plain(args[0].abs(), *args[1:], fast=fast, idx=idx)
    assert ((sums - sums_r).abs() <= 1e-5 * abs_sums).all()


ASSIGN_SHAPES = [(32, 5000, 256, 8), (32, 3000, 256, 4), (1, 4097, 64, 8), (3, 1500, 100, 9),
                 (2, 700, 8000, 8), (32, 3000, 1024, 9)]


@cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("nb,B,M,K", ASSIGN_SHAPES)
def test_assign_matches_plain(dev, nb, B, M, K, fast):
    xn, emb, valid = _assign_case(nb, B, M, K, 2)
    args = [torch.as_tensor(a).to(dev) for a in (xn, emb, valid)]
    out = fused_assign_branches(*args, fast=fast)
    torch.cuda.synchronize()
    _hold_assign(args, fast, out)


@cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("nb,B,M,K", [(32, 5000, 256, 8), (2, 3000, 2500, 17), (32, 3000, 1024, 9)])
def test_assign_is_run_to_run_identical(dev, nb, B, M, K, fast):
    """No float atomics: two calls give the same bits (the EMA state carries
    these sums from step to step)."""
    xn, emb, valid = _assign_case(nb, B, M, K, 5)
    args = [torch.as_tensor(a).to(dev) for a in (xn, emb, valid)]
    first = fused_assign_branches(*args, fast=fast)
    second = fused_assign_branches(*args, fast=fast)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("layout", ["adjacent", "far"])
@pytest.mark.parametrize("nb,B,M,K", [(2, 3000, 256, 8), (1, 2000, 2500, 9), (2, 1000, 64, 17)])
def test_assign_exact_ties_take_the_lower_index(dev, nb, B, M, K, layout, fast):
    """Codewords that are exact copies tie exactly; the lower index must win.
    ``adjacent``: codeword 2i + 1 copies 2i (same lane's two columns);
    ``far``: codeword M/2 + i copies i (other n8 tiles and, at M = 2,500,
    another shared-memory chunk)."""
    xn, emb, valid = _assign_case(nb, B, M, K, 6)
    half = M // 2
    if layout == "adjacent":
        emb[:, 1::2] = emb[:, 0:2 * half:2]
        ok = lambda i: i % 2 == 0  # noqa: E731
    else:
        emb[:, half:2 * half] = emb[:, :half]
        ok = lambda i: (i < half) | (i >= 2 * half)  # noqa: E731
    args = [torch.as_tensor(a).to(dev) for a in (xn, emb, valid)]
    out = fused_assign_branches(*args, fast=fast)
    torch.cuda.synchronize()
    assert bool(ok(out[0]).all())
    _hold_assign(args, fast, out)


@cuda
@pytest.mark.parametrize("fast", [False, True])
def test_lookup_matches_plain(dev, fast):
    rng = np.random.RandomState(3)
    N, nb, M, K, n = 5000, 32, 256, 8, 3000
    c = rng.randint(0, M, (N + 1, nb)).astype(np.int16)
    ids = rng.randint(0, N + 1, n).astype(np.int64)
    emb_out = rng.randn(nb, M, K).astype(np.float32)
    args = [torch.as_tensor(a).to(dev) for a in (c, ids, emb_out)]
    out = lookup_codewords(*args, fast=fast)
    ref = lookup_codewords_plain(*args, fast=fast)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)  # a gather: bit-identical in both modes


@cuda
@pytest.mark.parametrize("split", [None, "half"])
@pytest.mark.parametrize("K", [3, 8, 9, 16])
@pytest.mark.parametrize("nb", [1, 7, 32, 33, 64])
def test_lookup_shapes_match_plain(dev, nb, K, split):
    """Branches in one round of the warp's lanes and in two (33, 64), rows
    of float4 pieces (K = 8, 16) and of single floats (3, 9), whole and split
    at D = K // 2 (halves of 1 to 8 floats, float4 or not); node ids past
    both ends of the table and codeword ids past both ends of [0, M) clip.
    Bit-equal to the plain version in both modes."""
    rng = np.random.RandomState(nb * 100 + K)
    N, M, n = 600, 50, 1001
    c = rng.randint(-5, M + 5, (N + 1, nb)).astype(np.int16)
    ids = rng.randint(-3, N + 4, n).astype(np.int64)
    emb_out = rng.randn(nb, M, K).astype(np.float32)
    args = [torch.as_tensor(a).to(dev) for a in (c, ids, emb_out)]
    D = None if split is None else K // 2
    for fast in (False, True):
        out = lookup_codewords(*args, fast=fast, split=D)
        ref = lookup_codewords_plain(*args, fast=fast, split=D)
        torch.cuda.synchronize()
        outs, refs = ((out,), (ref,)) if D is None else (out, ref)
        for o, r in zip(outs, refs, strict=True):
            assert o.is_contiguous() and torch.equal(o, r)


@cuda
@pytest.mark.parametrize("split", [None, 4])
def test_lookup_no_nodes(dev, split):
    """n = 0: empty outputs of the right shapes, and no launch."""
    c = torch.zeros((10, 32), dtype=torch.int16, device=dev)
    emb_out = torch.zeros((32, 8, 9), device=dev)
    before = lookup_codewords.launches
    out = lookup_codewords(c, torch.zeros(0, dtype=torch.int64, device=dev), emb_out,
                           split=split)
    shapes = [tuple(t.shape) for t in ((out,) if split is None else out)]
    assert shapes == ([(0, 32, 9)] if split is None else [(0, 128), (0, 160)])
    assert lookup_codewords.launches == before


@cuda
def test_wrappers_refuse_bad_input(dev):
    x = torch.zeros((10, 8), device=dev, dtype=torch.float64)
    er = torch.zeros(2, dtype=torch.int32, device=dev)
    ec = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    ev = torch.zeros((2, 8), device=dev)
    with pytest.raises(ValueError):
        ell_aggregate(x, er, ec, ev, 10)
    xf = x.float()
    with pytest.raises(ValueError):  # row offsets for another row count
        ell_aggregate(xf, er, ec, ev, 10, ptr=torch.zeros(10, dtype=torch.int32, device=dev))
    ptr = torch.tensor([0, 1, 2] + [2] * 8, dtype=torch.int32, device=dev)
    rows = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # int64 long rows
        ell_aggregate(xf, er, ec, ev, 10, ptr=ptr, long_rows=rows.long())
    with pytest.raises(ValueError):  # long rows without their row offsets
        ell_aggregate(xf, er, ec, ev, 10, long_rows=rows)
    with pytest.raises(ValueError):  # a long-row list without its threshold
        ell_aggregate(xf, er, ec, ev, 10, ptr=ptr, long_rows=rows[:0])
    with pytest.raises(ValueError):  # more panels than channels
        ell_aggregate(xf, er, ec, ev, 10, panels=9)
    with pytest.raises(ValueError):
        fused_assign_branches(
            torch.zeros((1, 4, 18), device=dev), torch.zeros((1, 4, 18), device=dev),
            torch.ones(4, dtype=torch.bool, device=dev),
        )


# ---------------------------------------------------------------------------
# kernel 8: sorted segment sum
# ---------------------------------------------------------------------------
def _jax_package(module):
    """A module of the JAX package's ops; skips where JAX or its
    dependencies are not installed (the GPU machine)."""
    return pytest.importorskip(f"vq_gnn_tpu.ops.{module}")


def _segsum_case(num_rows, S, C, pad, seed, gaps=False):
    """Ascending seg over [0, num_rows) (every row owns a slot unless
    ``gaps``), ``pad`` padding slots of row num_rows with zero partials."""
    rng = np.random.default_rng(seed)
    dense = np.array([], np.int64) if gaps else np.arange(num_rows)
    seg = np.sort(np.concatenate([dense, rng.integers(0, num_rows, S - len(dense))]))
    if gaps:
        seg = seg[(seg % 3) != 1]  # rows 1, 4, 7, ... own no slot
    seg = np.concatenate([seg, np.full(pad, num_rows)]).astype(np.int32)
    live = (seg < num_rows)
    part = (rng.standard_normal((len(seg), C)) * live[:, None]).astype(np.float32)
    scal = (rng.standard_normal(len(seg)) * live).astype(np.float32)
    return part, scal, seg


# (num_rows, S, C, pad): the bm GAT widths 128 and nb = 32, a narrow odd
# width, a row spanning many slots
SEGSUM_CASES = [(300, 1000, 128, 37), (300, 1000, 32, 21), (50, 2600, 128, 1),
                (7, 1030, 256, 99), (1500, 1501, 128, 0)]


@pytest.mark.parametrize("scalar", [False, True])
@pytest.mark.parametrize("num_rows,S,C,pad", SEGSUM_CASES)
def test_segment_sum_plain_matches_pallas(num_rows, S, C, pad, scalar):
    """Plain version against ``segment_sum_sorted(..., interpret=True)``, as
    tests/test_pallas_segsum.py runs it (f32 sums in another order)."""
    j_segsum = _jax_package("pallas_segsum").segment_sum_sorted
    import jax.numpy as jnp

    part, scal, seg = _segsum_case(num_rows, S, C, pad, 0)
    sp = scal if scalar else None
    ref = j_segsum(jnp.asarray(part), jnp.asarray(seg), num_rows,
                   scalar_partials=None if sp is None else jnp.asarray(sp), interpret=True)
    out = segment_sum_sorted_plain(torch.as_tensor(part), torch.as_tensor(seg), num_rows,
                                   scalar_partials=None if sp is None else torch.as_tensor(sp))
    refs, outs = (ref, out) if scalar else ((ref,), (out,))
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4)


def test_segment_sum_plain_scalar_only_matches_pallas():
    j_segsum = _jax_package("pallas_segsum").segment_sum_sorted
    import jax.numpy as jnp

    _, scal, seg = _segsum_case(300, 1000, 8, 3, 6)
    ref = j_segsum(None, jnp.asarray(seg), 300, scalar_partials=jnp.asarray(scal),
                   interpret=True)
    out = segment_sum_sorted_plain(None, torch.as_tensor(seg), 300,
                                   scalar_partials=torch.as_tensor(scal))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("num_rows,S,C,pad", SEGSUM_CASES)
def test_segment_sum_plain_with_offsets_matches_pallas(num_rows, S, C, pad):
    """The plain version given the row offsets (and the long-row list) the
    kernel takes, against the JAX kernel in interpret mode: the lists are
    checked and change nothing."""
    j_segsum = _jax_package("pallas_segsum").segment_sum_sorted
    import jax.numpy as jnp

    part, scal, seg = _segsum_case(num_rows, S, C, pad, 2)
    ref, ref_s = j_segsum(jnp.asarray(part), jnp.asarray(seg), num_rows,
                          scalar_partials=jnp.asarray(scal), interpret=True)
    seg_t = torch.as_tensor(seg)
    ptr = row_offsets_plain(seg_t, num_rows)
    lists = torch.as_tensor(long_rows_host(ptr.numpy(), 4))
    out, out_s = segment_sum_sorted_plain(torch.as_tensor(part), seg_t, num_rows,
                                          scalar_partials=torch.as_tensor(scal), ptr=ptr,
                                          long_rows=lists)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out_s.numpy(), np.asarray(ref_s), rtol=1e-5, atol=1e-4)


def test_segment_sum_refuses_bad_row_lists():
    """Row offsets of another row count or type, and a long-row list
    without its offsets, are refused (the plain version checks them too)."""
    part, _, seg = _segsum_case(300, 1000, 8, 3, 7)
    part, seg = torch.as_tensor(part), torch.as_tensor(seg)
    ptr = row_offsets_plain(seg, 300)
    with pytest.raises(ValueError):  # offsets for 299 rows
        segment_sum_sorted(part, seg, 300, ptr=ptr[:-1])
    with pytest.raises(ValueError):  # int64 offsets
        segment_sum_sorted(part, seg, 300, ptr=ptr.long())
    with pytest.raises(ValueError):  # long rows without their offsets
        segment_sum_sorted(part, seg, 300, long_rows=torch.tensor([4], dtype=torch.int32))


@cuda
@pytest.mark.parametrize("channels", ["matrix", "both", "scalar"])
@pytest.mark.parametrize("num_rows,S,C,pad,gaps",
                         [(n, s, c, p, False) for n, s, c, p in SEGSUM_CASES]
                         + [(3000, 40000, 128, 500, True), (900, 5000, 7, 0, True)])
def test_segment_sum_matches_plain(dev, num_rows, S, C, pad, gaps, channels):
    part, scal, seg = _segsum_case(num_rows, S, C, pad, 1, gaps)
    p = torch.as_tensor(part).to(dev) if channels != "scalar" else None
    sp = torch.as_tensor(scal).to(dev) if channels != "matrix" else None
    seg = torch.as_tensor(seg).to(dev)
    out = segment_sum_sorted(p, seg, num_rows, scalar_partials=sp)
    ref = segment_sum_sorted_plain(p, seg, num_rows, scalar_partials=sp)
    torch.cuda.synchronize()
    outs, refs = (out, ref) if channels == "both" else ((out,), (ref,))
    for o, r in zip(outs, refs):
        _close_to_ref(o, r)


def _segsum_plain64(part, seg, num_rows, scal):
    """The plain segment sum of ``part`` [S, C] and ``scal`` [S] in float64
    (``index_add_`` into num_rows + 1 rows, the last collecting the
    padding)."""
    idx = seg.long().clamp(0, num_rows)
    return tuple(p.new_zeros((num_rows + 1,) + tuple(p.shape[1:]), dtype=torch.float64)
                 .index_add_(0, idx, p.double())[:num_rows] for p in (part, scal))


@cuda
@pytest.mark.parametrize("C", [7, 32, 128, 256])
def test_segment_sum_row_lists_same_bits(dev, C):
    """Rows of 0 to ~2,600 slots: one very long row, every fifth row and a
    run of 40 at the end without a slot, padding slots past the last row.
    With the host's row offsets and long-row lists of three thresholds (0:
    every row with a slot is long), with the offsets alone and with them
    built on the device: within the tolerance of the plain version, and the
    same bits in every form and over two calls."""
    rng = np.random.default_rng(C)
    num_rows = 3000
    seg = np.sort(np.concatenate([np.full(2600, 1234), rng.integers(0, num_rows, 9000)]))
    seg = seg[(seg % 5 != 2) & (seg < num_rows - 40)]
    seg = np.concatenate([seg, np.full(77, num_rows)]).astype(np.int32)
    live = seg < num_rows
    part = torch.as_tensor((rng.standard_normal((len(seg), C)) * live[:, None])
                           .astype(np.float32)).to(dev)
    scal = torch.as_tensor((rng.standard_normal(len(seg)) * live).astype(np.float32)).to(dev)
    ptr_h = row_offsets_host(seg, num_rows)
    ptr = torch.as_tensor(ptr_h).to(dev)
    seg = torch.as_tensor(seg).to(dev)
    forms = {f"lists t={t}": dict(ptr=ptr, long_rows=torch.as_tensor(
        long_rows_host(ptr_h, t)).to(dev)) for t in (16, 4, 0)}
    forms.update({"again": forms["lists t=16"], "offsets only": dict(ptr=ptr),
                  "offsets built": {}})
    outs = {k: segment_sum_sorted(part, seg, num_rows, scalar_partials=scal, **kw)
            for k, kw in forms.items()}
    # the reference in float64, then cast: index_add_'s float atomics sum in
    # another order each run, and in f32 that order moved the long row's
    # sums by up to 9.3e-5 against the 8.0e-5 tolerance
    ref = tuple(r.float() for r in _segsum_plain64(part, seg, num_rows, scal))
    torch.cuda.synchronize()
    first = outs["lists t=16"]
    for o, r in zip(first, ref, strict=True):
        _close_to_ref(o, r)
    for k, o in outs.items():
        assert all(torch.equal(a, b) for a, b in zip(o, first, strict=True)), k
    assert not first[0][2::5].any() and not first[0][-40:].any()
    assert float(first[0][1234].abs().max()) > 0


@cuda
def test_segment_sum_offsets_past_the_slots(dev):
    """Row offsets built for more slots than the kernel is given: each row
    sums only its slots among those given (the kernel clamps the offsets to
    the slots), as the plain version of the shortened input does."""
    part, _, seg = _segsum_case(3000, 40000, 128, 500, 8)
    ptr = torch.as_tensor(row_offsets_host(seg, 3000)).to(dev)
    S = len(seg) // 2
    part, seg = (torch.as_tensor(np.ascontiguousarray(a[:S])).to(dev) for a in (part, seg))
    out = segment_sum_sorted(part, seg, 3000, ptr=ptr)
    ref = segment_sum_sorted_plain(part, seg, 3000)
    assert int(ptr[-1]) > S
    _close_to_ref(out, ref)


# ---------------------------------------------------------------------------
# kernels 9 and 10: the rev-ELL recovery term
# ---------------------------------------------------------------------------
def _rev_case(B_pad, num_N, M, nb, Dg, R, seed, heavy_rows=0):
    """A reverse list with duplicate (row, col) pairs of opposite sign, a
    random codeword table and inputs; ``heavy_rows`` rows get 100 extra
    cells each (more than one warp's worth)."""
    rng = np.random.default_rng(seed)
    rows = B_pad - B_pad // 4
    rr = rng.integers(0, rows, R)
    rc = rng.integers(0, num_N, R)
    rv = rng.normal(size=R).astype(np.float32)
    if heavy_rows:
        rr = np.concatenate([rr, np.repeat(np.arange(heavy_rows), 100)])
        rc = np.concatenate([rc, rng.integers(0, num_N, 100 * heavy_rows)])
        rv = np.concatenate([rv, rng.normal(size=100 * heavy_rows).astype(np.float32)])
    nd = len(rr) // 3
    rr = np.concatenate([rr, rr[:nd]])
    rc = np.concatenate([rc, rc[:nd]])
    rv = np.concatenate([rv, -0.5 * rv[:nd]])
    c_tab = rng.integers(0, M, (num_N + 1, nb)).astype(np.int16)
    xb = rng.normal(size=(nb, B_pad, Dg)).astype(np.float32)
    al = (0.5 * rng.normal(size=(nb, B_pad))).astype(np.float32)
    arcb = (0.5 * rng.normal(size=(nb, M))).astype(np.float32)
    gbar = rng.normal(size=(nb, M, Dg)).astype(np.float32)
    return (rr, rc, rv), c_tab, xb, al, arcb, gbar


def _rev_slots(rev, B_pad, num_N, extra=64):
    slots = build_rev_ell(*rev, B_pad, num_N)
    return pad_rev_ell(*slots, slots[0].shape[0] + extra, B_pad, num_N)


@pytest.mark.parametrize("case", ["padded", "unpadded", "empty", "heavy"])
def test_rev_row_offsets_and_long_rows(case):
    """The recovery kernels' host lists: the row offsets are the slots' row
    boundaries (pad slots, of row B_pad, in no row; rows without cells own
    no slot), and the long-row list holds its threshold, then exactly the
    rows of more slots, in index order."""
    B_pad, num_N = 300, 500
    R = 0 if case == "empty" else 2000
    rev = _rev_case(B_pad, num_N, 8, 1, 1, R, 4, heavy_rows=9 if case == "heavy" else 0)[0]
    if case == "unpadded":
        col, val, row = build_rev_ell(*rev, B_pad, num_N)
    else:
        col, val, row = _rev_slots(rev, B_pad, num_N)
    ptr = row_offsets_host(row, B_pad)
    np.testing.assert_array_equal(ptr, np.searchsorted(row, np.arange(B_pad + 1)))
    assert ptr.dtype == np.int32 and ptr[-1] == int((row < B_pad).sum())
    live = np.bincount(np.minimum(row, B_pad), (val != 0).sum(1), B_pad + 1)[:B_pad]
    assert (live[np.diff(ptr) == 0] == 0).all()  # rows without slots have no cells
    if case == "empty":
        assert (ptr == 0).all()
    lr = rev_long_rows_host(ptr)
    want = [b for b in range(B_pad) if ptr[b + 1] - ptr[b] > REV_LONG_SLOTS]
    assert lr.dtype == np.int32 and lr[0] == REV_LONG_SLOTS
    assert lr[1:].tolist() == want
    assert REV_LONG_SLOTS * val.shape[1] <= 32  # a row left out holds at most a warp of cells
    if case == "heavy":  # rows 0-8 have 100+ cells each
        assert set(range(9)) <= set(lr[1:].tolist())


def test_rev_recovery_plain_matches_pallas():
    """Plain version (values and gradients of a weighted sum of the
    per-branch infos) against ``rev_recovery_info(..., mode='highest',
    interpret=True)`` on the same reverse list (f32 sums in another order)."""
    jrev = _jax_package("pallas_rev")
    j_build, j_pad, j_rev = jrev.build_rev_ell, jrev.pad_rev_ell, jrev.rev_recovery_info
    import jax
    import jax.numpy as jnp

    B_pad, num_N, M, nb, Dg = 256, 3000, 32, 2, 5
    rev, c_tab, xb, al, arcb, gbar = _rev_case(B_pad, num_N, M, nb, Dg, 900, 0)
    T_s, TB, Dp = 128, jrev.rev_tb(B_pad), 8
    d = j_build(*rev, B_pad, num_N, K=8, T_s=T_s, TB=TB)
    S, P = d["slot_row"].shape[0], d["tile_of"].shape[0]
    d = j_pad(d, -(-S // T_s) * T_s, -(-P // 128) * 128, B_pad, num_N, T_s=T_s, TB=TB)
    w = jnp.arange(1.0, nb + 1)

    def j_fn(x, a_l, a_r):
        c_flat = jnp.take(jnp.asarray(c_tab), jnp.asarray(d["slot_col"].reshape(-1)), axis=0,
                          mode="clip").astype(jnp.int32)
        xp = jnp.pad(x, ((0, 0), (0, 0), (0, Dp - Dg)))
        gT = jnp.pad(jnp.transpose(jnp.asarray(gbar), (0, 2, 1)), ((0, 0), (0, Dp - Dg), (0, 0)))
        info = j_rev(c_flat, jnp.asarray(d["slot_val"]), jnp.asarray(d["slot_row"]),
                     jnp.asarray(d["tile_of"]), jnp.asarray(d["blk_of"]),
                     jnp.asarray(d["flags"]), xp, a_l[:, :, None], a_r, gT, T_s, TB,
                     "highest", True)
        return jnp.sum(info * w), info

    args = [jnp.asarray(a) for a in (xb, al, arcb)]
    (_, ref), ref_grads = jax.value_and_grad(j_fn, argnums=(0, 1, 2), has_aux=True)(*args)
    col, val, row = (torch.as_tensor(a) for a in _rev_slots(rev, B_pad, num_N))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (xb, al, arcb)]
    info = rev_recovery_info_plain(torch.as_tensor(c_tab), col, val, row, *leaves,
                                   torch.as_tensor(gbar))
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    np.testing.assert_allclose(info.detach().numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * scale)
    grads = torch.autograd.grad((info * torch.arange(1.0, nb + 1)).sum(), leaves)
    for name, g, r in zip(("d_xb", "d_al", "d_arcb"), grads, ref_grads):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(np.abs(r).max())), err_msg=name)


def _rev_bound(c_tab, col, val, row, xb, al, arcb, gbar, g):
    """Sums of |terms| of info and of each gradient: the plain version on
    |xb| and |gbar| (then |G| <= sum |x| |g|), the scale of the f32 round-off
    of any summation order."""
    leaves = [xb.abs().requires_grad_(True), al.clone().requires_grad_(True),
              arcb.clone().requires_grad_(True)]
    info = rev_recovery_info_plain(c_tab, col, val, row, *leaves, gbar.abs())
    return (info.detach(), *torch.autograd.grad((info * g.abs()).sum(), leaves))


def _rev_lists(row, B_pad, dev, thr=REV_LONG_SLOTS):
    """The batch's row offsets and long rows of the slots ``row``, on
    ``dev``; a threshold other than the batch's gives a list built here."""
    ptr = row_offsets_host(row.cpu().numpy(), B_pad)
    if thr == REV_LONG_SLOTS:
        lr = rev_long_rows_host(ptr)
    else:
        lr = np.concatenate([[thr], np.flatnonzero(np.diff(ptr) > thr)]).astype(np.int32)
    return torch.as_tensor(ptr).to(dev), torch.as_tensor(lr).to(dev)


@cuda
@pytest.mark.parametrize(
    "B_pad,num_N,M,nb,Dg,R,heavy,thr",
    [(2048, 20000, 1024, 32, 5, 30000, 0, REV_LONG_SLOTS),
     (2048, 20000, 1024, 32, 4, 30000, 0, REV_LONG_SLOTS),
     (512, 3000, 4, 3, 5, 4000, 0, REV_LONG_SLOTS),
     (512, 3000, 64, 32, 5, 2000, 7, REV_LONG_SLOTS),
     (256, 100, 16, 1, 1, 0, 0, REV_LONG_SLOTS),
     (2048, 20000, 1024, 40, 5, 30000, 5, REV_LONG_SLOTS),
     (1024, 20000, 256, 64, 5, 20000, 3, REV_LONG_SLOTS),
     (256, 5000, 64, 8, 5, 1000, 256, REV_LONG_SLOTS),
     (512, 3000, 20000, 32, 5, 6000, 7, REV_LONG_SLOTS),
     (512, 3000, 16, 40, 2, 4000, 2, 0)],
)
def test_rev_recovery_matches_plain(dev, B_pad, num_N, M, nb, Dg, R, heavy, thr):
    """Kernels 9 and 10 against the plain version and autograd through it.
    M = 4 makes most cells of a row share a codeword, so opposite-sign
    cells cancel before the relu; ``heavy`` rows have > 32 cells (all of
    them at heavy = B_pad); nb = 40 and 64 take more than one warp of
    branches; M = 20,000 leaves room for two [M] histograms a block; a
    list of threshold ``thr`` = 0 makes every row with cells long.  Each
    value to 1e-5 of the sum of |terms| it adds up (f32 sums in another
    order), and every output bit-identical over two calls."""
    rev, c_tab, xb, al, arcb, gbar = _rev_case(B_pad, num_N, M, nb, Dg, R, 2, heavy)
    col, val, row = (torch.as_tensor(a).to(dev) for a in _rev_slots(rev, B_pad, num_N))
    ptr, lr = _rev_lists(row, B_pad, dev, thr)
    if heavy == B_pad:
        assert lr.shape[0] == B_pad + 1  # every row is long
    c_tab, xb, al, arcb, gbar = (torch.as_tensor(a).to(dev) for a in (c_tab, xb, al, arcb, gbar))
    g = torch.linspace(-1.0, 2.0, nb, device=dev)

    def run():
        return (rev_forward(c_tab, col, val, ptr, lr, xb, al, arcb, gbar),
                *rev_backward(c_tab, col, val, ptr, lr, xb, al, arcb, gbar, g))

    outs, again = run(), run()
    leaves = [t.clone().requires_grad_(True) for t in (xb, al, arcb)]
    ref = rev_recovery_info_plain(c_tab, col, val, row, *leaves, gbar)
    ref_grads = torch.autograd.grad((ref * g).sum(), leaves)
    bounds = _rev_bound(c_tab, col, val, row, xb, al, arcb, gbar, g)
    torch.cuda.synchronize()
    for name, o, o2, r, b in zip(("info", "d_xb", "d_al", "d_arcb"), outs, again,
                                 (ref.detach(), *ref_grads), bounds):
        assert o.shape == r.shape and torch.isfinite(o).all(), name
        assert ((o - r).abs() <= 1e-5 * b + 1e-6).all(), (name, float((o - r).abs().max()))
        assert torch.equal(o, o2), f"{name} differs between two calls"
    # the autograd Function takes the kernels on both passes
    leaves = [t.clone().requires_grad_(True) for t in (xb, al, arcb)]
    before = (rev_forward.launches, rev_backward.launches)
    out = rev_recovery_info(c_tab, col, val, row, *leaves, gbar, row_ptr=ptr, long_rows=lr)
    torch.autograd.grad((out * g).sum(), leaves)
    assert (rev_forward.launches, rev_backward.launches) == (before[0] + 1, before[1] + 1)


@cuda
@pytest.mark.parametrize(
    "B_pad,num_N,M,nb,Dg,R,heavy,long_cells",
    [(2048, 20000, 1024, 32, 5, 30000, 5, 2600),
     (512, 3000, 4, 3, 5, 4000, 7, 0),
     (256, 6000, 16, 2, 5, 1500, 0, 2600),
     (512, 3000, 64, 40, 2, 4000, 2, 300)],
)
def test_rev_recovery_fold_bf16_matches_plain(dev, B_pad, num_N, M, nb, Dg, R, heavy,
                                              long_cells):
    """Kernels 9 and 10 under the bf16 fold (``fold='fast'``) against the
    plain 'fast' version: the same bf16 roundings (each value, then each add
    of a codeword's cells within a K-cell slot), so each value to 1e-5 of
    the sum of |terms| it adds up (the f32 sums of the slot parts and of the
    contraction in another order); every output bit-identical over two
    calls; and apart from the f32 fold's outputs.  ``long_cells`` adds a row
    of that many cells (2,600: 325 slots), walked by the long-row warps in
    32-cell chunks, each holding four whole slots; M = 4 and 16 put several
    cells of one codeword in a slot.  The 'fast' launches count apart."""
    rev, c_tab, xb, al, arcb, gbar = _rev_case(B_pad, num_N, M, nb, Dg, R, 5, heavy)
    if long_cells:
        rng = np.random.default_rng(6)
        rr, rc, rv = rev
        rev = (np.concatenate([rr, np.full(long_cells, 3)]),
               np.concatenate([rc, rng.choice(num_N, long_cells, replace=False)]),
               np.concatenate([rv, rng.normal(size=long_cells).astype(np.float32)]))
    col, val, row = (torch.as_tensor(a).to(dev) for a in _rev_slots(rev, B_pad, num_N))
    ptr, lr = _rev_lists(row, B_pad, dev)
    if long_cells:
        assert int(ptr[4] - ptr[3]) >= long_cells // 8 and 3 in lr[1:].tolist()
    c_tab, xb, al, arcb, gbar = (torch.as_tensor(a).to(dev) for a in (c_tab, xb, al, arcb, gbar))
    g = torch.linspace(-1.0, 2.0, nb, device=dev)

    def run(fold):
        return (rev_forward(c_tab, col, val, ptr, lr, xb, al, arcb, gbar, fold=fold),
                *rev_backward(c_tab, col, val, ptr, lr, xb, al, arcb, gbar, g, fold=fold))

    before = (rev_forward.launches_bf16, rev_backward.launches_bf16)
    outs, again = run("fast"), run("fast")
    assert (rev_forward.launches_bf16, rev_backward.launches_bf16) == (before[0] + 2,
                                                                       before[1] + 2)
    f32 = run("x2")
    leaves = [t.clone().requires_grad_(True) for t in (xb, al, arcb)]
    ref = rev_recovery_info_plain(c_tab, col, val, row, *leaves, gbar, fold="fast")
    ref_grads = torch.autograd.grad((ref * g).sum(), leaves)
    bounds = _rev_bound(c_tab, col, val, row, xb, al, arcb, gbar, g)
    torch.cuda.synchronize()
    for name, o, o2, r, b in zip(("info", "d_xb", "d_al", "d_arcb"), outs, again,
                                 (ref.detach(), *ref_grads), bounds):
        assert o.shape == r.shape and torch.isfinite(o).all(), name
        assert ((o - r).abs() <= 1e-5 * b + 1e-6).all(), (name, float((o - r).abs().max()))
        assert torch.equal(o, o2), f"{name} differs between two calls"
    assert not torch.equal(outs[0], f32[0]), "the bf16 fold gave the f32 fold's info"


@cuda
def test_new_wrappers_refuse_bad_input(dev):
    seg = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # float64 partials
        segment_sum_sorted(torch.zeros((4, 8), dtype=torch.float64, device=dev), seg, 2)
    with pytest.raises(ValueError):  # seg must be int32
        segment_sum_sorted(torch.zeros((4, 8), device=dev), seg.long(), 2)
    rev, c_tab, xb, al, arcb, gbar = _rev_case(128, 100, 8, 2, 5, 50, 3)
    col, val, row = (torch.as_tensor(a).to(dev) for a in _rev_slots(rev, 128, 100))
    c_tab, xb, al, arcb, gbar = (torch.as_tensor(a).to(dev) for a in (c_tab, xb, al, arcb, gbar))
    ptr, lr = _rev_lists(row, 128, dev)
    with pytest.raises(ValueError):  # int32 codeword table
        rev_forward(c_tab.int(), col, val, ptr, lr, xb, al, arcb, gbar)
    with pytest.raises(ValueError):  # Dg above a table row
        wide = torch.zeros((2, 128, 17), device=dev)
        rev_forward(c_tab, col, val, ptr, lr, wide, al, arcb, torch.zeros((2, 8, 17), device=dev))
    with pytest.raises(ValueError):  # M whose [M] histograms do not fit a block
        rev_forward(c_tab, col, val, ptr, lr, xb, al, torch.zeros((2, 30000), device=dev),
                    torch.zeros((2, 30000, 5), device=dev))
    with pytest.raises(ValueError):  # K = 16: a row the list leaves out may pass a warp of cells
        rev_forward(c_tab, torch.cat([col, col], 1), torch.cat([val, val], 1), ptr, lr, xb, al,
                    arcb, gbar)
    with pytest.raises(ValueError):  # no row offsets: the kernel does not build them
        rev_forward(c_tab, col, val, None, None, xb, al, arcb, gbar)
    with pytest.raises(ValueError):  # row offsets of another row count
        rev_forward(c_tab, col, val, ptr[:-1], lr, xb, al, arcb, gbar)
    with pytest.raises(ValueError):  # a fold mode the JAX package does not have
        rev_forward(c_tab, col, val, ptr, lr, xb, al, arcb, gbar, fold="bf16")
    col6, val6 = col[:, :6].contiguous(), val[:, :6].contiguous()
    rev_forward(c_tab, col6, val6, ptr, lr, xb, al, arcb, gbar)  # K = 6: the f32 fold takes it
    with pytest.raises(ValueError):  # the bf16 fold needs K dividing 32
        rev_forward(c_tab, col6, val6, ptr, lr, xb, al, arcb, gbar, fold="fast")


@cuda
def test_link_step_same_bits_and_row_8(dev):
    """The whole-batch link step (``train/link.py:link_train_step``, at 3,000
    nodes and the collab tool's configuration scaled to them) twice from one
    state on the card: the same bits (its pair gathers' gradient summed by
    kernel 8 in a fixed order, not by ``index_add_``'s atomics), and kernel
    8 launched once a step on the link path.  (Here, not in
    tests/test_torch_port_link.py: that file imports the JAX package, which
    the card's machine lacks.)"""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
    import link_experiment_torch as tool
    from vq_gnn_tpu_torch.convert import (
        predictor_from_numpy,
        predictor_to_numpy,
        state_like,
        state_to_numpy,
    )
    from vq_gnn_tpu_torch.graph.datasets import prepare
    from vq_gnn_tpu_torch.train.checkpoint import named_leaves
    from vq_gnn_tpu_torch.train.link import LinkTrainer

    g, split = tool.build_graph_and_split(nodes=3000)
    cfg = tool.scaled_config(tool.vq_config("GCN", 1), 3000)
    g, _, _ = prepare(g, cfg, 0, symmetrize_adj=False)
    tr = LinkTrainer(g, cfg, split, device=dev)
    tr.run_init_sweep()
    loader = tr.train_loader
    b0 = loader._to_device(next(loader._epoch_iter()))[0][0]
    snap, pred_np = state_to_numpy(tr.state), predictor_to_numpy(tr.predictor, tr.pred_opt)
    leaves = []
    for _ in range(2):
        st, pred = state_like(tr.state, snap), predictor_from_numpy(*pred_np, cfg.lr, dev)
        before = segment_sum_sorted.launches
        tr.step_fn(st, *pred, tr.X_dev, b0, 1.0, cfg.lr, 1.0,
                   torch.Generator(device=dev).manual_seed(3))
        torch.cuda.synchronize()
        assert segment_sum_sorted.launches - before == 1
        # c_indices but its padding dustbin row N (which padded slot writes
        # it is unspecified)
        leaves.append([(x[:-1] if name.endswith("c_indices") else x).detach().cpu().numpy()
                       if torch.is_tensor(x) else np.asarray(x) for name, x in named_leaves(st)]
                      + [p.detach().cpu().numpy() for p in pred[0].parameters()])
    assert all(np.array_equal(a, b) for a, b in zip(*leaves))


@cuda
def test_cuda_wrappers_refuse_float64(dev):
    """float64 is the plain versions' diagnostic on the CPU
    (``config.sum_dtype``, ``tests/test_torch_port_f64.py``); on the card
    each wrapper on the GCN link path refuses it by name: kernel 1 (its
    rows), kernel 8 (its partials, also as ``take_rows``' backward sums
    them), kernel 2 (its inputs) and kernel 3 (its table).  Nothing casts
    or falls back to a plain version there."""
    er, ec, ev, x = _ell_case(40, 60, 8, 16, 8)
    ell = [torch.as_tensor(a).to(dev) for a in (er, ec, ev)]
    x = torch.as_tensor(x, dtype=torch.float64, device=dev)
    rng = np.random.default_rng(3)
    with pytest.raises(ValueError, match="ell_aggregate: x must be float32, bfloat16 or "
                                         "float16, got torch.float64"):
        ell_aggregate(x, *ell, 40)
    seg = torch.as_tensor(np.sort(rng.integers(0, 30, 50)).astype(np.int32), device=dev)
    with pytest.raises(ValueError, match="segment_sum_sorted: partials must be contiguous "
                                         "float32"):
        segment_sum_sorted(torch.zeros((50, 4), dtype=torch.float64, device=dev), seg, 30)
    table = torch.zeros((30, 4), dtype=torch.float64, device=dev, requires_grad=True)
    (r,) = take_rows(table, torch.zeros(5, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="segment_sum_sorted: partials must be contiguous "
                                         "float32"):
        r.sum().backward()
    xn = torch.zeros((2, 64, 8), dtype=torch.float64, device=dev)
    emb = torch.zeros((2, 16, 8), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="fused_assign_branches: xn must be contiguous "
                                         "torch.float32"):
        fused_assign_branches(xn, emb, torch.ones(64, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError, match="lookup_codewords: emb_out must be contiguous "
                                         "torch.float32"):
        lookup_codewords(torch.zeros((10, 2), dtype=torch.int16, device=dev),
                         torch.zeros(3, dtype=torch.int64, device=dev), emb)
