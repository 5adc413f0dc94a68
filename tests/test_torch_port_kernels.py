"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them.  On a
machine with a GPU but without JAX, run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py -q
"""

import numpy as np
import pytest
import torch

from vq_gnn_tpu_torch.ops import _build
from vq_gnn_tpu_torch.ops.ell_aggregate import ell_aggregate, ell_aggregate_plain
from vq_gnn_tpu_torch.ops.gat_kernels import (
    gat_aggregate,
    gat_aggregate_plain,
    gat_backward,
    gat_backward_plain,
)
from vq_gnn_tpu_torch.ops.spmm import build_ell_host
from vq_gnn_tpu_torch.ops.vq_kernels import (
    fused_assign_branches,
    fused_assign_branches_plain,
    lookup_codewords,
    lookup_codewords_plain,
)

pytestmark = pytest.mark.cuda


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
@pytest.mark.parametrize(
    "num_rows,E,K,C",
    [(3000, 40000, 8, 128), (517, 3000, 4, 36), (129, 900, 8, 7), (200, 0, 8, 128)],
)
def test_ell_aggregate_matches_plain(dev, num_rows, E, K, C):
    er, ec, ev, x = _ell_case(num_rows, E, K, C, 0)
    args = [torch.as_tensor(a).to(dev) for a in (x, er, ec, ev)]
    out = ell_aggregate(*args, num_rows)
    ref = ell_aggregate_plain(*args, num_rows)
    torch.cuda.synchronize()
    assert out.shape == (num_rows, C)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * max(1.0, float(ref.abs().max())))


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


def _close_to_ref(out, ref):
    """f32 sums in another order: rtol 1e-5 and atol 1e-5 x the largest |ref|."""
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * max(1.0, float(ref.abs().max())))


# GAT aggregate: the plain version's einsum + index_add_ against the kernel's
# per-lane sequential sums (exp of the same logits on both sides)
@pytest.mark.parametrize("with_neg", [True, False])
@pytest.mark.parametrize(
    "num_rows,E,K,C",
    [(3000, 40000, 8, 128), (300, 2000, 8, 256), (517, 3000, 4, 36), (129, 900, 8, 7),
     (200, 0, 8, 128)],
)
def test_gat_aggregate_matches_plain(dev, num_rows, E, K, C, with_neg):
    er, ec, ev, x = _ell_case(num_rows, E, K, C, 4)
    rng = np.random.RandomState(5)
    al = (rng.randn(x.shape[0]) * 0.7).astype(np.float32)
    ar = (rng.randn(num_rows) * 0.7).astype(np.float32)
    args = [torch.as_tensor(a).to(dev) for a in (x, er, ec, ev, al, ar)]
    out = gat_aggregate(*args, num_rows, with_neg=with_neg)
    ref = gat_aggregate_plain(*args, num_rows, with_neg=with_neg)
    torch.cuda.synchronize()
    assert out[0].shape == (num_rows, C) and out[1].shape == (num_rows,)
    for o, r in zip(out, ref):
        if r is None:
            assert o is None
        else:
            _close_to_ref(o, r)


# GAT backward over a transposed ELL; C = 2000 needs more than 48 KB of
# shared memory per block, C = 7 and 36 take the scalar path
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
    assert gat_backward.by_width[C] > 0
    _close_to_ref(dx, dx_r)
    _close_to_ref(d_al, d_al_r)


def test_gat_wrappers_refuse_bad_input(dev):
    er, ec, ev, x = _ell_case(50, 300, 8, 16, 8)
    x, er, ec, ev = [torch.as_tensor(a).to(dev) for a in (x, er, ec, ev)]
    al = torch.zeros(50, device=dev)
    with pytest.raises(ValueError):  # ar must have one entry per output row
        gat_aggregate(x, er, ec, ev, al, al[:10], 50)
    with pytest.raises(ValueError):  # float64 cotangent
        gat_backward(x, er, ec, ev, x.double(), al, al, al, 50)
    with pytest.raises(ValueError):  # wider than the shared-memory limit
        wide = torch.zeros((50, 8000), device=dev)
        gat_backward(wide, er, ec, ev, wide, al, al, al, 50)


def _assign_case(nb, B, M, K, seed):
    rng = np.random.RandomState(seed)
    xn = rng.randn(nb, B, K).astype(np.float32)
    emb = rng.randn(nb, M, K).astype(np.float32)
    valid = rng.rand(B) < 0.9
    return xn, emb, valid


# idx and counts must be equal: the kernel repeats the plain version's
# arithmetic (separately rounded products and sums, same order).  Sums differ
# only by summation order: each by at most 1e-5 of the sum of the |x| it adds.
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize(
    "nb,B,M,K",
    [(32, 5000, 256, 8), (32, 3000, 256, 4), (1, 4097, 64, 8), (3, 1500, 100, 9),
     (2, 700, 8000, 8)],
)
def test_assign_matches_plain(dev, nb, B, M, K, fast):
    xn, emb, valid = _assign_case(nb, B, M, K, 2)
    args = [torch.as_tensor(a).to(dev) for a in (xn, emb, valid)]
    idx, counts, sums = fused_assign_branches(*args, fast=fast)
    idx_r, counts_r, sums_r = fused_assign_branches_plain(*args, fast=fast)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_r)
    assert torch.equal(counts, counts_r)
    _, _, abs_sums = fused_assign_branches_plain(args[0].abs(), *args[1:], fast=fast, idx=idx_r)
    assert ((sums - sums_r).abs() <= 1e-5 * abs_sums).all()


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


def test_wrappers_refuse_bad_input(dev):
    x = torch.zeros((10, 8), device=dev, dtype=torch.float64)
    er = torch.zeros(2, dtype=torch.int32, device=dev)
    ec = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    ev = torch.zeros((2, 8), device=dev)
    with pytest.raises(ValueError):
        ell_aggregate(x, er, ec, ev, 10)
    with pytest.raises(ValueError):
        fused_assign_branches(
            torch.zeros((1, 4, 18), device=dev), torch.zeros((1, 4, 18), device=dev),
            torch.ones(4, dtype=torch.bool, device=dev),
        )
