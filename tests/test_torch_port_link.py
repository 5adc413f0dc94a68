"""The port's link prediction (``train/link.py``, ``main_link_torch.py``,
``tools/link_experiment_torch.py``) against the JAX package on the CPU, at a
small size (2 layers x 16, num_M = 8, a few hundred nodes).

Tolerances: host arrays (graphs, splits, batches) exactly; losses to rtol
1e-4 and gradients and states to atol 1e-5 (f32 sums in another order, one
step from one carried state); parameters after an RMSprop step to atol
1e-4, as in tests/test_torch_port_slice.py (its first step divides by
sqrt(nu) ~ |g| / 10, so a gradient at round-off size moves its parameter
by up to ~lr either way); predictor outputs and scores to rtol 1e-5 (atol
1e-6); Hits@K and MRR equal, or apart by no more than the positives
whose order against a negative the score tolerance leaves open.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu.train import link as jlink
from vq_gnn_tpu.train import optim as joptim
from vq_gnn_tpu.utils import metrics as jmetrics
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.convert import predictor_from_numpy, state_from_numpy
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.ops.segsum import take_rows
from vq_gnn_tpu_torch.sampler import samplers as tsamplers
from vq_gnn_tpu_torch.train import link as tlink
from vq_gnn_tpu_torch.train import optim as toptim
from vq_gnn_tpu_torch.utils import metrics as tmetrics

import main_link  # noqa: E402  (the repo root is on sys.path, see conftest)
import main_link_torch  # noqa: E402
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)
import link_experiment as jtool  # noqa: E402
import link_experiment_torch as ttool  # noqa: E402

LR = 0.005
RTOL_LOSS = 1e-4
ATOL_GRAD = 1e-5
ATOL_STATE = 1e-4  # parameters after an RMSprop step
RTOL_SCORE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _vml_first_call():
    """A throwaway first torch.exp of the process: the first call of MKL's
    vector exp can return a chunk at a lower accuracy
    (tests/test_torch_port_kernels.py:_vml_first_call says more)."""
    torch.exp(torch.zeros(1 << 16))


def _cfg_kw(**kw):
    base = dict(dataset="synthetic", conv_type="GCN", num_layers=2, hidden_channels=16,
                num_D=4, num_M=8, batch_size=200, test_batch_size=400, skip=True,
                pad_multiple_nodes=64, pad_multiple_edges=512, lr=LR, vq_backend="xla")
    base.update(kw)
    return base


def _split(g, rng, n_valid=50, n_test=50, SplitEdges=tlink.SplitEdges):
    """tests/test_link.py:make_split."""
    coo = g.adj.tocoo()
    edges = np.stack([coo.row, coo.col], axis=1)
    e = edges[edges[:, 0] != edges[:, 1]]
    e = e[rng.permutation(len(e))]

    def rand(n):
        return np.stack([rng.randint(0, g.num_nodes, n), rng.randint(0, g.num_nodes, n)], 1)

    return SplitEdges(
        train_pos=e[: len(e) - n_valid - n_test],
        valid_pos=e[len(e) - n_valid - n_test : len(e) - n_test],
        valid_neg=rand(200), test_pos=e[len(e) - n_test :], test_neg=rand(200),
    )


def _graphs(kw, nodes=400, seed=2):
    jc, tc = jcfg.Config(**kw), tcfg.Config(**kw)
    jg, c = jdata.synthetic_sbm(num_nodes=nodes, num_features=16, seed=seed)
    jg, c, _ = jdata.prepare(jg, jc, c)
    tg, _ = tdata.synthetic_sbm(num_nodes=nodes, num_features=16, seed=seed)
    tg, _, _ = tdata.prepare(tg, tc, c)
    return jc, tc, jg, tg


def _trainers(kw, nodes=400, seed=2, per_source=False):
    """A JAX LinkTrainer and the port's on the same graph and split, the
    port starting from the JAX trainer's state and predictor."""
    jc, tc, jg, tg = _graphs(kw, nodes, seed)
    split = _split(jg, np.random.RandomState(0))
    if per_source:
        rng = np.random.RandomState(4)
        split = dataclasses.replace(
            split, train_pos=split.valid_pos, valid_neg=rng.randint(0, nodes, (50, 20)),
            test_neg=rng.randint(0, nodes, (50, 20)), neg_per_source=True)
    jsplit = jlink.SplitEdges(**dataclasses.asdict(split))
    jtr = jlink.LinkTrainer(jg, jc, jsplit)
    tr = tlink.LinkTrainer(tg, tc, split, device="cpu")
    _carry(jtr, tr)
    return jtr, tr


def _carry(jtr, tr):
    tr.state = state_from_numpy(jax.tree.map(np.asarray, jtr.state), tr.ms, LR, "cpu")
    tr.predictor, tr.pred_opt = predictor_from_numpy(
        jax.tree.map(np.asarray, jtr.pred_params), jax.tree.map(np.asarray, jtr.pred_nu),
        LR, "cpu")


def _jax_leaf(tree, l, pname):
    """The JAX array of the port parameter ``pname`` of layer ``l`` (a
    linear's w transposed to [out, in])."""
    name, _, key = pname.partition(".")
    leaf = tree[l][name]
    if key:
        leaf = leaf[{"weight": "w", "bias": "b"}[key]]
    leaf = np.asarray(leaf)
    return leaf.T if key == "weight" else leaf


def _pred_leaves(pred_tree):
    return [a for lin in pred_tree for a in (np.asarray(lin["w"]).T, np.asarray(lin["b"]))]


# ---------------- metrics ----------------
def test_hits_and_mrr_match_jax():
    rng = np.random.RandomState(0)
    for k in (1, 5, 50, 500):
        pos, neg = rng.randn(300), rng.randn(400)
        assert tmetrics.hits_at_k(pos, neg, k) == jmetrics.hits_at_k(pos, neg, k)
    pos, neg = rng.randn(50), rng.randn(50, 20)
    neg[:, 3] = pos  # ties count half
    assert tmetrics.mrr(pos, neg) == jmetrics.mrr(pos, neg)


# ---------------- the graph and the tool's builders ----------------
def test_synthetic_dot_product_matches_jax():
    for kw in (dict(num_nodes=700, seed=3), dict(num_nodes=300, num_features=8, avg_degree=6.0,
                                                num_blocks=4, candidates=50, seed=1)):
        jg, jc = jdata.synthetic_dot_product(**kw)
        tg, tc = tdata.synthetic_dot_product(**kw)
        assert tc == jc
        assert (tg.adj != jg.adj).nnz == 0 and tg.adj.dtype == jg.adj.dtype
        for name in ("x", "y", "train_mask", "val_mask", "test_mask"):
            np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name), err_msg=name)


@pytest.mark.parametrize("conv", ["GCN", "GAT"])
def test_link_tool_builders_match_jax(conv):
    """tools/link_experiment_torch.py: the graph, split and configurations
    of the JAX tool at a small ``nodes``."""
    jg, js = jtool.build_graph_and_split(nodes=1500)
    tg, ts = ttool.build_graph_and_split(nodes=1500)
    assert (tg.adj != jg.adj).nnz == 0
    np.testing.assert_array_equal(tg.x, jg.x)
    for f in dataclasses.fields(ts):
        np.testing.assert_array_equal(getattr(ts, f.name), getattr(js, f.name), err_msg=f.name)
    jc = jtool.vq_config(conv, 7)
    assert dataclasses.asdict(ttool.vq_config(conv, 7)) == dataclasses.asdict(jc)
    assert ttool.scaled_config(ttool.vq_config(conv, 7), ttool.N_COLLAB) == ttool.vq_config(
        conv, 7)
    ex = jtool.exact_cfg_from(jc, 1500, 1e-2, 9)
    assert dataclasses.asdict(ttool.exact_cfg_from(ttool.vq_config(conv, 7), 1500, 1e-2, 9)) \
        == dataclasses.asdict(ex)


# ---------------- the link batch ----------------
@pytest.mark.parametrize("sampler", ["cont", "node"])
def test_link_batches_match_jax(sampler):
    """BatchLoader(with_link_edges=True): the in-batch positive edges (both
    local endpoints < B), their mask and the L_pad bucket, exactly."""
    kw = _cfg_kw(sampler_type=sampler, walk_length=3, batch_size=120)
    jc, tc, jg, tg = _graphs(kw)
    jl = jsamplers.BatchLoader(jg, jc, train_flag=True, seed=0, with_link_edges=True)
    tl = tsamplers.BatchLoader(tg, tc, train_flag=True, seed=0, with_link_edges=True,
                               device="cpu")
    n = 0
    for (jw, _), (tw, _) in zip(jl._epoch_iter(), tl._epoch_iter()):
        assert len(jw) == len(tw)
        for jb, tb in zip(jw, tw):
            for name in ("batch_idx", "link_src", "link_dst", "link_mask"):
                np.testing.assert_array_equal(getattr(tb, name), np.asarray(getattr(jb, name)),
                                              err_msg=name)
            assert tb.link_mask.any() and tb.link_src[tb.link_mask].max() < tb.num_B
            n += 1
    assert n >= 3
    tb = tb.to("cpu")
    assert tb.link_src.dtype == torch.int64 and tb.link_mask.dtype == torch.bool


# ---------------- the predictor ----------------
@pytest.mark.parametrize("num_layers,p", [(3, 0.0), (3, 0.5), (1, 0.0)])
def test_predictor_forward_matches_jax(num_layers, p):
    """From the JAX predictor carried over; with dropout the JAX masks (the
    split of its key, one per hidden layer) given to the port."""
    pp = jlink.init_predictor(jax.random.PRNGKey(3), 16, 16, 1, num_layers)
    pred, _ = predictor_from_numpy(jax.tree.map(np.asarray, pp),
                                   jax.tree.map(np.zeros_like, pp), LR, "cpu")
    rng = np.random.RandomState(5)
    xi, xj = rng.randn(2, 300, 16).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jlink.predictor_forward(pp, xi, xj, p, True, key))
    keep = None
    if p > 0:
        keep, k = [], key
        for _ in range(num_layers - 1):
            k, sub = jax.random.split(k)
            keep.append(torch.as_tensor(np.array(jax.random.bernoulli(sub, 1.0 - p, (300, 16)))))
    out = tlink.predictor_forward(pred, torch.as_tensor(xi), torch.as_tensor(xj), keep, p)
    assert out.shape == (300, 1)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=RTOL_SCORE, atol=1e-6)
    # the port's own masks: the same counts of units kept as drawn
    if p > 0:
        masks = tlink.dropout_masks(pred, 300, p, torch.Generator().manual_seed(0), "cpu")
        assert len(masks) == num_layers - 1 and masks[0].shape == (300, 16)


# ---------------- the gradient clip ----------------
@pytest.mark.parametrize("max_norm", [0.05, 1.0, 100.0])
def test_clip_grads_by_norm_matches_jax(max_norm):
    rng = np.random.RandomState(1)
    grads = [rng.randn(16, 8).astype(np.float32), rng.randn(8).astype(np.float32) * 0.1]
    ref = joptim.clip_grads_by_norm({"w": grads[0], "b": grads[1]}, max_norm)
    out = toptim.clip_grads_by_norm([torch.as_tensor(g) for g in grads], max_norm)
    for o, r in zip(out, (ref["w"], ref["b"])):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


# ---------------- one link step from one state ----------------
def _capture(monkeypatch, module, store):
    """Replace ``module.rmsprop_update``: the JAX one returns the gradients in
    place of the new parameters (so the jitted step hands them out), the
    port's records them and then steps."""
    real = module.rmsprop_update
    if module is jlink:
        monkeypatch.setattr(module, "rmsprop_update", lambda p, g, nu, lr, do: (g, nu))
    else:
        def record(opt, params, grads, lr, do_step):
            store.append([g.detach().clone() for g in grads])
            return real(opt, params, grads, lr, do_step)

        monkeypatch.setattr(module, "rmsprop_update", record)


@pytest.mark.parametrize("conv,clip", [("GCN", None), ("GAT", (0.05, 0.02))],
                         ids=["GCN", "GAT-clip"])
def test_link_step_matches_jax(conv, clip, monkeypatch):
    """One link train step from one carried state, the JAX negatives fed to
    both: the loss, every gradient of the GNN (after the per-layer clip) and
    of the predictor, the VQ states after the live update; then a real step
    (RMSprop on the GNN and the predictor) and the parameters it leaves.
    BN off (the bias under BN has a round-off gradient, see
    tests/test_torch_port_slice.py); dropout 0 (the masks come from each
    package's own generator)."""
    kw = _cfg_kw(conv_type=conv, sampler_type="cont", walk_length=2, batch_size=150,
                 bn_flag=False, clip=clip)
    jtr, tr = _trainers(kw)
    jtr.run_init_sweep()
    tr.run_init_sweep()
    jw = [jax.tree.map(jnp.asarray, w) for w, _ in jtr.train_loader._epoch_iter()][0]
    tw = [w for w, _ in tr.train_loader][0]
    jb, tb = jw[-1], tw[-1]
    np.testing.assert_array_equal(tb.link_src.numpy(), np.asarray(jb.link_src))
    key = jax.random.PRNGKey(11)
    _, r_neg, _ = jax.random.split(key, 3)  # link.py:67-71
    dst_neg = jax.random.randint(r_neg, jb.link_src.shape, 0, jnp.maximum(jb.num_B, 1))
    args = (jnp.float32(0.5), jnp.float32(LR), jnp.float32(1.0), key)

    # the gradients
    grads = []
    with monkeypatch.context() as mp:
        _capture(mp, jlink, None)
        _capture(mp, tlink, grads)
        step, _ = jlink.make_link_step(jtr.ms, jtr.cfg)
        st0 = jax.tree.map(lambda a: jnp.array(a, copy=True), jtr.state)
        pp0 = jax.tree.map(lambda a: jnp.array(a, copy=True), jtr.pred_params)
        jst, g_pred, _, jm = step(st0, pp0, jtr.pred_nu, jtr.X_dev, jb, *args)
        tstate = state_from_numpy(jax.tree.map(np.asarray, jtr.state), tr.ms, LR, "cpu")
        tm = tr.step_fn(tstate, tr.predictor, tr.pred_opt, tr.X_dev, tb, 0.5, LR, 1.0,
                        dst_neg=torch.as_tensor(np.array(dst_neg), dtype=torch.int64))
    for k in ("loss", "loss_pre"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL_LOSS, err_msg=k)
    params = list(tstate.model.named_parameters())
    assert len(grads) == 2 and len(grads[0]) == len(params)
    for (pname, _), g in zip(params, grads[0]):
        _, l, rest = pname.split(".", 2)
        np.testing.assert_allclose(g.numpy(), _jax_leaf(jst.params, int(l), rest),
                                   atol=ATOL_GRAD, err_msg=pname)
    for g, r in zip(grads[1], _pred_leaves(g_pred)):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL_GRAD)
    if clip is not None:  # the clip bound: every clipped group's norm <= its max
        g0 = grads[0]
        assert float(torch.sqrt(g0[0].square().sum() + g0[1].square().sum())) <= clip[0] * 1.0001
    for js, ts in zip(jst.vq_states, tstate.vq_states):
        for f in ("embedding", "embedding_output", "ema_cluster_size", "bn_grad_mean",
                  "bn_grad_var"):
            np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=1e-5, atol=ATOL_GRAD, err_msg=f)
        np.testing.assert_array_equal(ts.c_indices.numpy()[:-1], np.asarray(js.c_indices)[:-1])

    # a real step: RMSprop on both networks
    step, _ = jlink.make_link_step(jtr.ms, jtr.cfg)
    _carry(jtr, tr)
    jst, jpp, jnu, _ = step(jtr.state, jtr.pred_params, jtr.pred_nu, jtr.X_dev, jb, *args)
    tr.step_fn(tr.state, tr.predictor, tr.pred_opt, tr.X_dev, tb, 0.5, LR, 1.0,
               dst_neg=torch.as_tensor(np.array(dst_neg), dtype=torch.int64))
    for pname, p in tr.state.model.named_parameters():
        _, l, rest = pname.split(".", 2)
        np.testing.assert_allclose(p.detach().numpy(), _jax_leaf(jst.params, int(l), rest),
                                   atol=ATOL_STATE, err_msg=pname)
    for p, r in zip(tr.predictor.parameters(), _pred_leaves(jpp)):
        np.testing.assert_allclose(p.detach().numpy(), r, atol=ATOL_STATE)
    for p, r in zip(tr.predictor.parameters(), _pred_leaves(jnu)):
        np.testing.assert_allclose(tr.pred_opt.state[p]["square_avg"].numpy(), r, atol=1e-7)


# ---------------- the pair gathers: their gradient in a fixed order ----------------
def _pair_case(case, rng, n=300, L=400):
    """(src, dst, dst_neg, live) [L] of one case: duplicates everywhere; one
    row gathered hundreds of times; rows never gathered; padding pairs
    (row 0, no cotangent), as the batches pad them."""
    src, dst, neg = (rng.integers(0, n, L) for _ in range(3))
    live = np.ones(L, bool)
    if case == "hub":
        src[: L // 2] = 7
        neg[::3] = 7
    elif case == "unreached":
        src, dst, neg = (rng.integers(0, n // 3, L) for _ in range(3))
    elif case == "padding":
        live[L - 90:] = False
        src[~live] = dst[~live] = 0
    return src, dst, neg, live


@pytest.mark.parametrize("case", ["duplicates", "hub", "unreached", "padding"])
def test_take_rows_matches_index_select_and_jax(case):
    """``ops/segsum.py:take_rows`` as the link step gathers its pairs' rows
    (``train/link.py:link_loss_parts``: three index tensors, the backward
    summing each row's contributions in a fixed order through kernel 8's
    plain version here) against ``index_select``'s autograd and
    ``jax.vjp`` of ``jnp.take`` on the same numpy inputs: the rows exactly,
    the gradient to rtol 1e-6 and atol 1e-5 (f32 sums in another order; a
    row gathered hundreds of times sums ~700 terms of size ~1), the rows no
    pair reaches exactly 0.  Padding pairs carry a zero cotangent, as the
    step's masked loss gives them."""
    rng = np.random.default_rng(26)
    n, C = 300, 16
    out = rng.standard_normal((n, C)).astype(np.float32)
    src, dst, neg, live = _pair_case(case, rng, n)
    idx = (src, dst, neg)
    cot = (rng.standard_normal((3, len(src), C)) * live[None, :, None]).astype(np.float32)

    t = torch.tensor(out, requires_grad=True)
    rows = take_rows(t, *(torch.as_tensor(i) for i in idx))
    for r, i in zip(rows, idx):
        np.testing.assert_array_equal(r.detach().numpy(), out[i])
    sum((r * torch.as_tensor(c)).sum() for r, c in zip(rows, cot)).backward()
    g = t.grad.numpy()

    t2 = torch.tensor(out, requires_grad=True)
    sum((t2.index_select(0, torch.as_tensor(i)) * torch.as_tensor(c)).sum()
        for i, c in zip(idx, cot)).backward()
    _, vjp = jax.vjp(lambda o: tuple(jnp.take(o, jnp.asarray(i), axis=0) for i in idx),
                     jnp.asarray(out))
    (g_jax,) = vjp(tuple(jnp.asarray(c) for c in cot))
    np.testing.assert_allclose(g, t2.grad.numpy(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(g, np.asarray(g_jax), rtol=1e-6, atol=1e-5)
    unreached = np.setdiff1d(np.arange(n), np.concatenate(idx))
    assert len(unreached) > 0 or case != "unreached"
    assert (g[unreached] == 0).all()
    if case == "hub":
        assert (np.concatenate(idx) == 7).sum() >= 300


def test_take_rows_gradient_keeps_the_dtype():
    """A bf16 table's gradient comes back bf16: the contributions summed in
    f32 (kernel 8 sums in f32) in their fixed order (the sources', the
    destinations', the negatives', each in pair order), then rounded once:
    exactly the f32 sum of the bf16 cotangents in that order, rounded."""
    rng = np.random.default_rng(27)
    out = torch.tensor(rng.standard_normal((50, 8)), dtype=torch.bfloat16, requires_grad=True)
    src, dst, neg, _ = _pair_case("hub", rng, 50, 120)
    idx = [torch.as_tensor(i) for i in (src, dst, neg)]
    cot = [torch.tensor(rng.standard_normal((120, 8)), dtype=torch.bfloat16) for _ in idx]
    sum((r * c).float().sum() for r, c in zip(take_rows(out, *idx), cot)).backward()
    want = torch.zeros(50, 8)
    for i, c in zip(idx, cot):
        want.index_add_(0, i, c.float())
    assert out.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.grad.float().numpy(), want.bfloat16().float().numpy())


# ---------------- evaluation from one state ----------------
def _hits_slack(pos, neg, k, rtol):
    """Positives whose order against the k-th best negative the score
    tolerance leaves open."""
    if len(neg) < k:
        return 0
    kth = np.sort(neg)[-k]
    return int((np.abs(pos - kth) <= rtol * 2 * np.maximum(np.abs(pos), abs(kth)) + 2e-6).sum())


@pytest.mark.parametrize("per_source", [False, True], ids=["hits", "mrr"])
def test_evaluate_matches_jax(per_source):
    """After the JAX init sweep and one epoch, the port carries the state and
    predictor over: the embeddings and the scores of every split to rtol
    1e-5; Hits@50 (collab) or MRR (citation2) equal, or apart by no more
    than the comparisons the score tolerance leaves open (counted on the
    JAX scores)."""
    jtr, tr = _trainers(_cfg_kw(), per_source=per_source)
    jtr.run_init_sweep()
    jtr.train_epoch(1)
    _carry(jtr, tr)
    jh, th = np.asarray(jtr.embeddings()), tr.embeddings()
    np.testing.assert_allclose(th.numpy(), jh, rtol=RTOL_SCORE, atol=1e-5)
    s = tr.split
    for name in ("train_pos", "valid_pos", "test_pos"):
        e = getattr(s, name)
        np.testing.assert_allclose(tr._scores(th, e), jtr._scores(jtr.embeddings(), e),
                                   rtol=RTOL_SCORE, atol=1e-6, err_msg=name)
    j_res = jtr.evaluate_mrr() if per_source else jtr.evaluate_hits()
    t_res = tr.evaluate_mrr() if per_source else tr.evaluate_hits()
    jh = jtr.embeddings()
    for (pos, neg), a, b in zip(((s.train_pos, s.valid_neg), (s.valid_pos, s.valid_neg),
                                 (s.test_pos, s.test_neg)), t_res, j_res):
        p = jtr._scores(jh, pos)
        if per_source:
            n = jtr._scores(jh, np.stack([np.repeat(pos[:, 0], neg.shape[1]), neg.reshape(-1)],
                                         1)).reshape(len(pos), -1)
            tied = (np.abs(n - p[:, None]) <= 2 * RTOL_SCORE * np.abs(p)[:, None] + 2e-6).any(1)
            assert abs(a - b) <= tied.sum() / len(pos), (a, b, tied.sum())
        else:
            n_open = _hits_slack(p, jtr._scores(jh, neg), 50, RTOL_SCORE)
            assert abs(a - b) * len(pos) <= n_open + 1e-9, (a, b, n_open)


# ---------------- short runs that learn (tests/test_link.py's floors) ----------------
def test_link_trainer_learns_on_the_cpu():
    kw = _cfg_kw(lr=0.003)
    _, tc, _, tg = _graphs(kw)
    tr = tlink.LinkTrainer(tg, tc, _split(tg, np.random.RandomState(0)), device="cpu")
    tr.run_init_sweep()
    for epoch in range(1, 9):
        loss = tr.train_epoch(epoch)
    assert np.isfinite(loss)
    _, valid_h, test_h = tr.evaluate_hits(k=50)
    assert 0.0 <= valid_h <= 1.0 and test_h > 0.3, test_h


def test_citation2_mrr_learns_on_the_cpu():
    """tests/test_link.py:test_citation2_mrr_end_to_end on the port."""
    kw = _cfg_kw(dataset="citation2", lr=0.003)
    tc = tcfg.Config(**kw)
    rng = np.random.RandomState(4)
    g, c = tdata.synthetic_sbm(num_nodes=400, num_features=16, seed=5)
    g, c, _ = tdata.prepare(g, tc, c)
    coo = g.adj.tocoo()
    edges = np.stack([coo.row, coo.col], axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]][rng.permutation(coo.nnz // 2)]
    nv, nt, kn = 40, 40, 20
    split = tlink.SplitEdges(
        train_pos=edges[:nv], valid_pos=edges[nv : 2 * nv],
        valid_neg=rng.randint(0, g.num_nodes, (nv, kn)),
        test_pos=edges[2 * nv : 2 * nv + nt], test_neg=rng.randint(0, g.num_nodes, (nt, kn)),
        neg_per_source=True,
    )
    tr = tlink.LinkTrainer(g, tc, split, device="cpu")
    tr.run_init_sweep()
    for epoch in range(1, 6):
        loss = tr.train_epoch(epoch)
    assert np.isfinite(loss)
    res = tr.evaluate_mrr()
    assert all(0.0 < m <= 1.0 for m in res) and res[2] > 0.3, res


def test_link_fit_checkpoints(tmp_path):
    """``fit(ckpt_dir)`` writes ``link_run0.npz`` after the epoch (before its
    evaluation), ``resume`` without an archive starts at epoch 1, and with
    one goes on after it with the predictor restored bit for bit."""
    from vq_gnn_tpu_torch.convert import predictor_to_numpy

    _, tc, _, tg = _graphs(_cfg_kw(epochs=1), nodes=200)
    split = _split(tg, np.random.RandomState(0), 20, 20)
    tr = tlink.LinkTrainer(tg, tc, split, device="cpu")
    tr.fit(verbose=False, resume=True)
    assert len(tr.logger.results[0]) == 1
    tr = tlink.LinkTrainer(tg, tc, split, device="cpu")
    tr.fit(verbose=False, ckpt_dir=str(tmp_path / "ck"), ckpt_every=1)
    assert os.listdir(tmp_path / "ck") == ["link_run0.npz"]
    tc2 = dataclasses.replace(tc, epochs=2)
    tr2 = tlink.LinkTrainer(tg, tc2, split, device="cpu")
    tr2.fit(verbose=False, ckpt_dir=str(tmp_path / "ck"), resume=True, ckpt_every=5)
    assert len(tr2.logger.results[0]) == 1
    tr3 = tlink.LinkTrainer(tg, tc2, split, device="cpu")
    tr3.fit(verbose=False, ckpt_dir=str(tmp_path / "ck"), resume=True)
    for a, b in zip(predictor_to_numpy(tr2.predictor, tr2.pred_opt),
                    predictor_to_numpy(tr3.predictor, tr3.pred_opt)):
        for la, lb in zip(a, b):
            for k in ("w", "b"):
                np.testing.assert_array_equal(la[k], lb[k])
    assert tr2.logger.results == tr3.logger.results


# ---------------- the CLI ----------------
class _Built(Exception):
    pass


@pytest.mark.parametrize("argv", [
    [],
    ["--dataset", "citation2", "--conv-type", "GAT", "--clip", "1.0", "0.1", "--sche",
     "--ce-only", "--warm-up", "--warm-up-epochs", "3", "--grad-scale", "1", "2",
     "--sampler-type", "rw", "--vq-backend", "pallas", "--compute-dtype", "bfloat16",
     "--ell-K", "4", "--seed", "3", "--runs", "2", "--dropout", "0.2"],
    ["--ckpt-dir", "x", "--ckpt-every", "5", "--resume", "--vq-update-mode", "reference"],
], ids=["default", "flags", "ckpt"])
def test_main_link_parser_matches_jax(argv, monkeypatch, capsys):
    """Every main_link.py flag under the same name and default, and the same
    Config, plus --device."""
    seen = {}

    def stop(cfg):
        seen["cfg"] = cfg
        raise _Built

    monkeypatch.setattr(sys, "argv", ["main_link.py"] + argv)
    monkeypatch.setattr(main_link, "load_link_data", stop)
    with pytest.raises(_Built):
        main_link.main()
    jv = vars(main_link.parse_args())
    ta = main_link_torch.parse_args(argv)
    tv = vars(ta)
    assert set(tv) == set(jv) | {"device"} and tv["device"] == "cuda:0"
    assert {k: v for k, v in tv.items() if k != "device"} == jv
    assert dataclasses.asdict(main_link_torch.config_from_args(ta)) == dataclasses.asdict(
        seen["cfg"])
    assert main_link_torch.parse_args(argv + ["--device", "cpu"]).device == "cpu"


# one epoch of two node-sampler batches on the 2,000-node fallback graph
LINK_CLI = ["--epochs", "1", "--num-layers", "2", "--hidden-channels", "16", "--num-M", "8",
            "--sampler-type", "node", "--batch-size", "1000", "--test-batch-size", "2000",
            "--lr", "0.01", "--data-root", "NONE"]


def test_main_link_cli_on_the_cpu(tmp_path, capsys):
    """``main_link_torch.py --device cpu`` on its synthetic fallback (not
    symmetrized for collab) finishes and prints Hits@50 for train, valid and
    test; the fallback graph and split are main_link.py's."""
    argv = [str(tmp_path) if a == "NONE" else a for a in LINK_CLI]
    tr = main_link_torch.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "not found; using a synthetic graph" in out
    assert "Run: 1, Epoch: 1, Loss: " in out and "Train: " in out and "Test: " in out
    assert "Run 01:" in out and "All runs:" in out
    (res,) = tr.logger.results[0]
    assert all(0.0 <= v <= 1.0 for v in res)
    jc = jcfg.Config(**dataclasses.asdict(tr.cfg))
    jg, jsplit = main_link.load_link_data(jc)
    assert (tr.graph.adj != jg.adj).nnz == 0
    for f in dataclasses.fields(jsplit):
        np.testing.assert_array_equal(getattr(tr.split, f.name), getattr(jsplit, f.name))


def test_main_link_cli_checkpoints(tmp_path, monkeypatch, capsys):
    """``--ckpt-dir D --ckpt-every 1`` writes ``D/link_run0.npz``; a run with
    ``--resume`` and ``--epochs 2`` prints where it resumed and trains epoch
    2 alone, and a second such run ends with the same statistics;
    main_link.py resumes from the same archive (its negatives come from
    another generator, so its statistics are its own)."""
    argv = [str(tmp_path) if a == "NONE" else a for a in LINK_CLI]
    ckpt = ["--ckpt-dir", str(tmp_path / "ck")]
    main_link_torch.main(argv + ckpt + ["--ckpt-every", "1", "--device", "cpu"])
    path = tmp_path / "ck" / "link_run0.npz"
    assert os.path.exists(path)
    argv2 = argv[:argv.index("--epochs")] + ["--epochs", "2"] + argv[argv.index("--epochs") + 2:]

    def stats(o):
        return [ln for ln in o.splitlines() if ln.strip().startswith(("Highest", "Final"))]

    outs = []
    for _ in range(2):
        capsys.readouterr()
        tr = main_link_torch.main(argv2 + ckpt + ["--resume", "--device", "cpu"])
        out = capsys.readouterr().out
        assert f"resumed from {path} at epoch 2" in out and "Run: 1, Epoch: 2," in out
        assert len(tr.logger.results[0]) == 1
        outs.append(stats(out))
    assert outs[0] == outs[1] and outs[0]
    monkeypatch.setattr(sys, "argv", ["main_link.py"] + argv2 + ckpt + ["--resume"])
    main_link.main()
    j_out = capsys.readouterr().out
    assert f"resumed from {path} at epoch 2" in j_out and "Run: 1, Epoch: 2," in j_out
