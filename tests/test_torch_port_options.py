"""The port's model options (``transformer_flag``, ``dropbranch``,
``alpha_dropout_flag``) against the JAX package on the CPU, at a small size
(2 layers x 16, num_D = 4, num_M = 8, a 300-node SBM).

The port cannot reproduce ``jax.random``: where JAX draws (the dropbranch
permutations, the alpha-dropout masks), the test rebuilds JAX's masks from
its key with JAX's own splits (``vq_gnn_tpu/train/step.py:98-107``,
``nn/model.py:870-876``, ``train/link.py:67-81``) and hands them to the
port.

Tolerances: alpha dropout exactly; a dropped branch's VQ state and
``c_indices`` column bit-identical to before; one layer, the transformer
branch and the VQ update 1e-5 relative to the largest |ref| (f32 sums in
another order, as ``tests/test_torch_port_bm.py``'s ``RTOL_SUM``); training
losses to rtol 1e-4 over the steps and the codeword assignments after an
epoch to > 99 %, evaluation logits to atol 1e-4, as
``test_bm_training_matches_jax``; the bf16 layer at the tolerances of
``tests/test_torch_port_bf16.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.nn import model as jmodel
from vq_gnn_tpu.nn.vq import vq_update as j_vq_update
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu.train import link as jlink
from vq_gnn_tpu.train.loop import device_features as j_device_features
from vq_gnn_tpu.train.state import init_train_state as j_init_train_state
from vq_gnn_tpu.train.step import make_step_fns as j_make_step_fns
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.convert import predictor_from_numpy, state_from_numpy, vq_state_from_numpy
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.nn import model as tmodel
from vq_gnn_tpu_torch.nn.vq import vq_update
from vq_gnn_tpu_torch.sampler import samplers as tsamplers
from vq_gnn_tpu_torch.train import link as tlink
from vq_gnn_tpu_torch.train.loop import NodeTrainer
from vq_gnn_tpu_torch.train.step import draw_branch_masks
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

RTOL_SUM = 1e-5  # x the largest |ref|: f32 sums in another order
RTOL_STEP = 1e-4  # per-step losses over an epoch of live-VQ steps
LAYER_RTOL, LAYER_ATOL = 2e-2, 1e-2  # tests/test_torch_port_bf16.py, one bf16 layer
LR = 0.005

CFG = dict(num_layers=2, hidden_channels=16, num_D=4, num_M=8, sampler_type="cont",
           walk_length=2, batch_size=128, test_batch_size=256, pad_multiple_nodes=64,
           pad_multiple_edges=512, vq_update_mode="live", skip=True, lr=LR, seed=0)
VQ_FIELDS = ("embedding", "embedding_output", "ema_cluster_size", "ema_w", "bn_feat_mean",
             "bn_feat_var", "bn_grad_mean", "bn_grad_var")


@pytest.fixture(scope="module", autouse=True)
def _vml_first_call():
    """A throwaway first torch.exp of the process: the first call of MKL's
    vector exp can return a chunk at a lower accuracy
    (tests/test_torch_port_kernels.py:_vml_first_call says more)."""
    torch.exp(torch.zeros(1 << 16))


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(out, ref, rtol, name=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


def _graphs(**kw):
    """(cfg, graph, num_classes) prepared by each package from one SBM."""
    out = []
    for cfg_mod, data in ((jcfg, jdata), (tcfg, tdata)):
        cfg = cfg_mod.Config(**{**CFG, **kw})
        g, c = data.synthetic_sbm(num_nodes=300, num_classes=5, num_features=16, seed=5)
        g, c, _ = data.prepare(g, cfg, c)
        out.append((cfg, g, c))
    return out


def _setup(**kw):
    """Each package's static model, the first training batch, and one JAX
    state (random codebooks and codeword tables in layer 0, so that the
    lookups and the recovery terms carry values) with the port's copy."""
    (jc, jg, c), (tc, tg, _) = _graphs(**kw)
    jb = next(jsamplers.BatchLoader(jg, jc, train_flag=True, seed=1)._epoch_iter())[0][0]
    tb = next(tsamplers.BatchLoader(tg, tc, train_flag=True, seed=1,
                                    device="cpu")._epoch_iter())[0][0]
    ms_j = jmodel.model_static(jc, jg.num_features, c)
    ms_t = tmodel.model_static(tc, tg.num_features, c, torch.device("cpu"))
    jstate = j_init_train_state(jax.random.PRNGKey(0), ms_j, jg.num_nodes)
    rng = np.random.RandomState(8)

    def randomized(vq):
        M = vq.embedding_output.shape[1]
        return vq.replace(
            embedding_output=jnp.asarray(rng.randn(*vq.embedding_output.shape)
                                         .astype(np.float32)),
            c_indices=jnp.asarray(rng.randint(0, M, vq.c_indices.shape).astype(np.int16)))

    jstate = jstate.replace(vq_states=[randomized(jstate.vq_states[0])]
                            + list(jstate.vq_states[1:]))
    if ms_j.transformer_flag:
        jstate = jstate.replace(vq_states_tr=[randomized(jstate.vq_states_tr[0])]
                                + list(jstate.vq_states_tr[1:]))
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, LR, "cpu")
    return (ms_j, jstate, jax.tree.map(jnp.asarray, jb)), (ms_t, state, tb.to("cpu")), rng


def _jax_grad_of(tree, pname):
    """The JAX leaf of a port parameter name (``gnn_transform.weight`` ->
    tree['gnn_transform']['w'].T; ``transformer_k.w`` as it is)."""
    mod, _, key = pname.partition(".")
    leaf = tree[mod]
    if key:
        leaf = leaf[{"weight": "w", "bias": "b"}.get(key, key)]
    leaf = np.asarray(leaf)
    return leaf.T if key == "weight" else leaf


def _jax_step_masks(key, ms_j, B_pad):
    """The dropbranch keep masks and the (alpha) dropout keep masks that
    JAX's train_step draws from ``key`` (``vq_gnn_tpu/train/step.py:94-107``
    and ``nn/model.py:870-876``), as torch tensors."""
    rng = key
    masks = None
    if ms_j.dropbranch > 0:
        rng, kd = jax.random.split(rng)
        masks = []
        for nb in ms_j.num_branches:
            kd, sub = jax.random.split(kd)
            perm = np.asarray(jax.random.permutation(sub, nb))
            keep = np.zeros(nb, bool)
            keep[perm[: int(nb * (1.0 - ms_j.dropbranch))]] = True
            masks.append(torch.as_tensor(keep))
    keeps = None
    if ms_j.dropout > 0:
        keeps = []
        for l in range(ms_j.num_layers - 1):
            rng, sub = jax.random.split(rng)
            keeps.append(_t(jax.random.bernoulli(sub, 1.0 - ms_j.dropout,
                                                 (B_pad, ms_j.channels[l + 1]))))
    return masks, keeps


# ---------------------------------------------------------------------------
# alpha dropout, the mask draw, validation
# ---------------------------------------------------------------------------
def test_alpha_dropout_matches_jax():
    """On one key's mask the port's alpha dropout is JAX's, bit for bit; off
    in eval and at p = 0; and its affine constants are torch's AlphaDropout
    (a constant input takes exactly the two values of
    ``torch.nn.functional.alpha_dropout``, as tests/test_torch_parity.py:57
    checks JAX's)."""
    assert tmodel.ALPHA_DROPOUT_ALPHA == jmodel.ALPHA_DROPOUT_ALPHA
    key, p = jax.random.PRNGKey(3), 0.3
    x = np.random.RandomState(0).randn(64, 16).astype(np.float32)
    ref = np.asarray(jmodel.alpha_dropout(key, jnp.asarray(x), p, training=True))
    keep = _t(jax.random.bernoulli(key, 1.0 - p, x.shape))
    out = tmodel.alpha_dropout(_t(x), p, True, keep=keep)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert tmodel.alpha_dropout(_t(x), p, False) is not None
    np.testing.assert_array_equal(tmodel.alpha_dropout(_t(x), p, False).numpy(), x)
    np.testing.assert_array_equal(tmodel.alpha_dropout(_t(x), 0.0, True).numpy(), x)
    c = torch.full((20_000,), 1.7)
    y = tmodel.alpha_dropout(c, p, True, generator=torch.Generator().manual_seed(0))
    ty = torch.nn.functional.alpha_dropout(c, p, training=True)
    np.testing.assert_allclose(np.unique(y.numpy().round(5)), np.unique(ty.numpy().round(5)),
                               rtol=1e-4)
    assert abs(float((y == y.min()).float().mean()) - p) < 0.02


@pytest.mark.parametrize("p", [0.25, 0.5, 0.7])
def test_branch_mask_draw_keeps_exactly(p):
    """Each layer keeps exactly int(nb * (1 - p)) branches, and the draws
    vary from step to step."""
    (_, _, _), (tc, tg, c) = _graphs(dropbranch=p, hidden_channels=40)
    ms = tmodel.model_static(tc, tg.num_features, c, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    draws = [draw_branch_masks(ms, gen) for _ in range(4)]
    for masks in draws:
        assert [int(m.sum()) for m in masks] == [int(nb * (1 - p)) for nb in ms.num_branches]
        assert [m.dtype for m in masks] == [torch.bool] * len(masks)
    assert len({tuple(m.tolist()) for masks in draws for m in masks[1:]}) > 1


@pytest.mark.parametrize("kw,error,match", [
    (dict(dropbranch=1.0), ValueError, r"dropbranch must be in \[0, 1\)"),
    (dict(dropbranch=0.8), ValueError, "dropbranch too large: a layer would keep zero branches"),
    (dict(transformer_flag=True), NotImplementedError,
     "transformer_flag requires formulation='bm'"),
], ids=["dropbranch-1", "zero-branches", "transformer-bbprime"])
def test_option_validation_matches_jax(kw, error, match):
    """The port refuses what the JAX package refuses, with its messages
    (``vq_gnn_tpu/nn/model.py:121-131``; nb = 4 at layer 0, so p = 0.8
    leaves int(0.8) = 0)."""
    (jc, jg, c), (tc, tg, _) = _graphs()
    with pytest.raises(error, match=match):
        jmodel.model_static(dataclasses.replace(jc, **kw), jg.num_features, c)
    with pytest.raises(error, match=match):
        tmodel.model_static(dataclasses.replace(tc, **kw), tg.num_features, c,
                            torch.device("cpu"))


def test_link_step_refuses_bm_gat():
    """The JAX link step cannot update a B + M GAT model's codebooks (its
    [nb, B, D + 1] probe against the 2-D slice of ``train/link.py:137``):
    the port raises by name instead of inventing a path."""
    (_, _, _), (tc, tg, c) = _graphs(formulation="bm", conv_type="GAT")
    ms = tmodel.model_static(tc, tg.num_features, c, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="the JAX package has no such path"):
        tlink.make_link_step(ms, tc)


# ---------------------------------------------------------------------------
# vq_update with a keep mask (tests/test_dropbranch.py's cases)
# ---------------------------------------------------------------------------
def _vq_inputs(seed=3):
    (ms_j, jstate, _), (ms_t, state, _), _ = _setup()
    st_j = jstate.vq_states[0]
    nb, B = ms_j.num_branches[0], 64
    rng = np.random.RandomState(seed)
    Xb = rng.randn(nb, B, ms_j.num_D).astype(np.float32)
    Gb = rng.randn(nb, B, ms_j.vq.grad_dim).astype(np.float32)
    bidx = np.arange(B, dtype=np.int32)
    return ms_j, ms_t, st_j, Xb, Gb, bidx


def _port_update(ms_t, st_j, Xb, Gb, bidx, keep=None):
    st = vq_state_from_numpy(jax.tree.map(np.asarray, st_j), "cpu")
    new, idx = vq_update(st, _t(Xb), _t(Gb), torch.as_tensor(bidx, dtype=torch.int64), ms_t.vq,
                         branch_keep=None if keep is None else torch.as_tensor(keep))
    return st, new, idx


def test_vq_update_all_keep_is_no_mask():
    """An all-True keep mask reproduces the unmasked update exactly, and both
    equal the JAX package's."""
    ms_j, ms_t, st_j, Xb, Gb, bidx = _vq_inputs()
    nb = Xb.shape[0]
    _, plain, idx0 = _port_update(ms_t, st_j, Xb, Gb, bidx)
    _, masked, idx1 = _port_update(ms_t, st_j, Xb, Gb, bidx, np.ones(nb, bool))
    ref, _ = j_vq_update(st_j, jnp.asarray(Xb), jnp.asarray(Gb), jnp.asarray(bidx), ms_j.vq,
                         branch_keep=jnp.ones((nb,), bool))
    assert torch.equal(idx0, idx1)
    for f in VQ_FIELDS + ("c_indices", "bn_inited", "bad_init"):
        assert torch.equal(getattr(plain, f), getattr(masked, f)), f
        if f in VQ_FIELDS:
            _close(getattr(masked, f).numpy(), np.asarray(getattr(ref, f)), RTOL_SUM, f)
        else:
            np.testing.assert_array_equal(getattr(masked, f).numpy(), np.asarray(getattr(ref, f)))


def test_vq_update_dropped_branch_untouched():
    """A dropped branch's codebook, EMA accumulators, BN statistics and
    c_indices column stay bit-identical to before; the kept ones equal the
    JAX package's; the shared bn_inited still flips."""
    ms_j, ms_t, st_j, Xb, Gb, bidx = _vq_inputs()
    nb = Xb.shape[0]
    keep = np.array([b % 2 == 0 for b in range(nb)])
    old, new, _ = _port_update(ms_t, st_j, Xb, Gb, bidx, keep)
    old_c = np.asarray(st_j.c_indices)  # the port updates its table in place
    ref, _ = j_vq_update(st_j, jnp.asarray(Xb), jnp.asarray(Gb), jnp.asarray(bidx), ms_j.vq,
                         branch_keep=jnp.asarray(keep))
    for f in VQ_FIELDS:
        a, o, r = getattr(new, f).numpy(), np.asarray(getattr(st_j, f)), np.asarray(getattr(ref, f))
        for b in range(nb):
            if keep[b]:
                _close(a[b], r[b], RTOL_SUM, f"{f}[{b}]")
            else:
                np.testing.assert_array_equal(a[b], o[b], err_msg=f"{f}[{b}]")
    c_new = new.c_indices.numpy()
    for b in range(nb):
        tgt = np.asarray(ref.c_indices)[:, b] if keep[b] else old_c[:, b]
        np.testing.assert_array_equal(c_new[:-1, b], tgt[:-1])
    assert bool(new.bn_inited) and bool(ref.bn_inited) and not bool(st_j.bn_inited)


@pytest.mark.parametrize("formulation", ["bbprime", "bm"])
def test_dropped_branch_kills_codebook_columns(formulation):
    """A dropped branch's codewords never reach the layer: moving branch 0's
    whole codebook leaves the output and info_backward as they were, and both
    equal the JAX layer's."""
    (ms_j, jstate, jb), (ms_t, state, tb), rng = _setup(formulation=formulation)
    x = rng.randn(tb.B_pad, ms_t.channels[0]).astype(np.float32)
    nb = ms_t.num_branches[0]
    keep = np.array([b != 0 for b in range(nb)])
    layer, st = state.model.layers[0], state.vq_states[0]
    moved = dataclasses.replace(st, embedding_output=st.embedding_output.clone())
    moved.embedding_output[0] += 100.0
    with torch.no_grad():
        outs = [tmodel.layer_forward(layer, s, ms_t, _t(x), tb, None, 0.7,
                                     branch_keep=torch.as_tensor(keep)) for s in (st, moved)]
    assert torch.equal(outs[0][0], outs[1][0]) and float(outs[0][1]) == float(outs[1][1])
    j_layer = jmodel.layer_forward_bm if formulation == "bm" else jmodel.layer_forward
    j_out, j_info = j_layer(jstate.params[0], jstate.vq_states[0], ms_j, jnp.asarray(x), jb,
                            None, 0.7, True, branch_keep=jnp.asarray(keep))
    _close(outs[0][0], j_out, RTOL_SUM, "x_out")
    _close(float(outs[0][1]), float(j_info), RTOL_SUM, "info_backward")


# ---------------------------------------------------------------------------
# one layer with a keep mask, the transformer branch
# ---------------------------------------------------------------------------
def _layer_grads(conv, formulation, keep, transformer=False):
    """One layer with probes (and the transformer's), warm-up rate 0.7,
    random codebooks: output, info_backward and the gradients of every
    parameter, x and the probes, of the JAX layer and the port's."""
    kw = dict(conv_type=conv, formulation=formulation, transformer_flag=transformer)
    (ms_j, jstate, jb), (ms_t, state, tb), rng = _setup(**kw)
    B_pad, C = tb.B_pad, ms_t.channels[0]
    nb, D = C // 4, 4
    x = rng.randn(B_pad, C).astype(np.float32)
    w_out = rng.randn(B_pad, ms_t.channels[1]).astype(np.float32)
    probe0 = np.zeros(tmodel.probe_shapes(ms_t, B_pad)[0], np.float32)
    ptr0 = np.zeros((nb, B_pad, D + 1), np.float32)
    jkeep = None if keep is None else jnp.asarray(keep)
    vq_tr_j = jstate.vq_states_tr[0] if transformer else None

    def j_loss(lp, xx, probe, ptr):
        if formulation == "bm":
            out, info = jmodel.layer_forward_bm(lp, jstate.vq_states[0], ms_j, xx, jb, probe, 0.7,
                                                True, vq_tr=vq_tr_j,
                                                probe_tr=ptr if transformer else None,
                                                branch_keep=jkeep)
        else:
            out, info = jmodel.layer_forward(lp, jstate.vq_states[0], ms_j, xx, jb, probe, 0.7,
                                             True, branch_keep=jkeep)
        return jnp.sum(out * w_out) + info, (out, info)

    (_, (j_out, j_info)), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3),
                                                       has_aux=True)(
        jstate.params[0], jnp.asarray(x), jnp.asarray(probe0), jnp.asarray(ptr0))
    layer = state.model.layers[0]
    leaves = [_t(a).requires_grad_(True) for a in (x, probe0, ptr0)]
    out, info = tmodel.layer_forward(
        layer, state.vq_states[0], ms_t, leaves[0], tb, leaves[1], 0.7,
        branch_keep=None if keep is None else torch.as_tensor(keep),
        vq_tr=state.vq_states_tr[0] if transformer else None,
        probe_tr=leaves[2] if transformer else None)
    named = list(layer.named_parameters())
    grads = torch.autograd.grad((out * _t(w_out)).sum() + info, [p for _, p in named] + leaves,
                                allow_unused=True)
    return (out, info, named, grads), (j_out, j_info, j_grads)


def _check_layer(port, ref, transformer):
    (out, info, named, grads), (j_out, j_info, (j_glp, j_gx, j_gp, j_gptr)) = port, ref
    _close(out.detach(), j_out, RTOL_SUM, "x_out")
    _close(info.detach(), j_info, RTOL_SUM, "info_backward")
    assert abs(float(j_info)) > 0
    _close(grads[-3], j_gx, RTOL_SUM, "dx")
    _close(grads[-2], j_gp, RTOL_SUM, "d_probe")
    if transformer:
        _close(grads[-1], j_gptr, RTOL_SUM, "d_probe_tr")
    for (name, _), g in zip(named, grads):
        _close(g, _jax_grad_of(j_glp, name), RTOL_SUM, name)


@pytest.mark.parametrize("conv,formulation", [
    ("GCN", "bbprime"), ("SAGE", "bbprime"), ("GAT", "bbprime"), ("GCN", "bm"), ("GAT", "bm"),
])
def test_layer_forward_with_branch_keep_matches_jax(conv, formulation):
    """One layer with branch 1 of 4 dropped: output, info_backward and the
    gradients of every parameter, x and the probe, against the JAX layer
    with the same keep mask; the dropped branch's probe gradient is 0 where
    the layer zeroes its slice (B + M)."""
    keep = np.array([True, False, True, True])
    port, ref = _layer_grads(conv, formulation, keep)
    _check_layer(port, ref, False)
    if formulation == "bm":
        g_probe = port[3][-2]
        dropped = g_probe[1] if g_probe.dim() == 3 else g_probe[:, 4:8]
        assert not dropped.any()


@pytest.mark.parametrize("conv", ["GCN", "GAT"])
@pytest.mark.parametrize("keep", [None, [False, True, True, False]], ids=["all", "keep"])
def test_layer_forward_bm_transformer_matches_jax(conv, keep):
    """The B + M layer with the transformer branch (with and without a keep
    mask): output, info_backward (the conv's term and the transformer's)
    and the gradients of every parameter (transformer_k, _v, _res among
    them), x, the probe and the transformer's probe."""
    port, ref = _layer_grads(conv, "bm", None if keep is None else np.array(keep), True)
    _check_layer(port, ref, True)
    names = [n for n, _ in port[2]]
    assert {"transformer_k.w", "transformer_k.b", "transformer_v.weight",
            "transformer_res.weight"} <= set(names)


@pytest.mark.parametrize("keep", [None, [True, False, True, False]], ids=["all", "keep"])
def test_transformer_branch_matches_jax(keep):
    """The transformer branch alone (warm-up rate 0.7, a random codebook):
    its output, info_backward and the gradients of transformer_k, x and
    probe_tr against ``vq_gnn_tpu/nn/model.py:transformer_branch``; a dropped
    branch has no output and no recovery."""
    (ms_j, jstate, jb), (ms_t, state, tb), rng = _setup(formulation="bm", transformer_flag=True)
    B_pad, C = tb.B_pad, ms_t.channels[0]
    nb, D = C // 4, 4
    x = rng.randn(B_pad, C).astype(np.float32)
    ptr = (0.1 * rng.randn(nb, B_pad, D + 1)).astype(np.float32)
    w_out = rng.randn(B_pad, C).astype(np.float32)
    jkeep = None if keep is None else jnp.asarray(keep)

    def j_loss(tk, xx, pp):
        lp = dict(jstate.params[0], transformer_k=tk)
        out, info = jmodel.transformer_branch(lp, jstate.vq_states_tr[0], ms_j, xx, jb, pp, 0.7,
                                              branch_keep=jkeep)
        return jnp.sum(out * w_out) + info, (out, info)

    (_, (j_out, j_info)), (j_gtk, j_gx, j_gp) = jax.value_and_grad(
        j_loss, argnums=(0, 1, 2), has_aux=True)(
        jstate.params[0]["transformer_k"], jnp.asarray(x), jnp.asarray(ptr))
    layer = state.model.layers[0]
    xx, pp = _t(x).requires_grad_(True), _t(ptr).requires_grad_(True)
    out, info = tmodel.transformer_branch(
        layer, state.vq_states_tr[0], ms_t, xx, tb, pp, 0.7,
        branch_keep=None if keep is None else torch.as_tensor(keep))
    tk = layer.transformer_k
    grads = torch.autograd.grad((out * _t(w_out)).sum() + info, [tk.w, tk.b, xx, pp])
    _close(out.detach(), j_out, RTOL_SUM, "x_out_tr")
    _close(info.detach(), j_info, RTOL_SUM, "info_backward")
    assert abs(float(j_info)) > 0
    for name, g, r in zip(("d_w", "d_b", "dx", "d_probe_tr"), grads,
                          (j_gtk["w"], j_gtk["b"], j_gx, j_gp)):
        _close(g, r, RTOL_SUM, name)
    if keep is not None:
        dropped = [b for b in range(nb) if not keep[b]]
        assert not out.detach().reshape(B_pad, nb, D)[:, dropped].any()
        assert not grads[3][dropped].any()


def test_transformer_layer_at_bf16_matches_jax():
    """The B + M GAT layer with the transformer branch under bf16 compute
    (only the GAT conv streams bf16; the transformer stays f32) against the
    JAX layer at bf16, at tests/test_torch_port_bf16.py's one-layer
    tolerance."""
    (ms_j, jstate, jb), (ms_t, state, tb), rng = _setup(
        formulation="bm", conv_type="GAT", transformer_flag=True, compute_dtype="bfloat16")
    assert ms_t.compute_dtype == "bfloat16"
    x = rng.randn(tb.B_pad, ms_t.channels[0]).astype(np.float32)
    j_out, j_info = jmodel.layer_forward_bm(jstate.params[0], jstate.vq_states[0], ms_j,
                                            jnp.asarray(x), jb, None, 0.7, True,
                                            vq_tr=jstate.vq_states_tr[0])
    with torch.no_grad():
        out, info = tmodel.layer_forward(state.model.layers[0], state.vq_states[0], ms_t, _t(x),
                                         tb, None, 0.7, vq_tr=state.vq_states_tr[0])
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=LAYER_RTOL, atol=LAYER_ATOL)
    np.testing.assert_allclose(float(info), float(j_info), rtol=LAYER_RTOL, atol=LAYER_ATOL)


# ---------------------------------------------------------------------------
# training epochs from one state
# ---------------------------------------------------------------------------
def _epoch_against_jax(kw, masks_from_key):
    """The init sweep, one epoch of live-VQ steps (cont sampler, three
    windows a batch, the first without an optimizer step) and eval, from one
    JAX state carried into a NodeTrainer: per-step loss, loss_cls and
    info_backward to rtol 1e-4, the codeword assignments of both codebook
    lists after the epoch to > 99 %, evaluation logits to atol 1e-4.  With
    ``masks_from_key`` each step's JAX key is fold_in(PRNGKey(1), step) and
    the port is handed the masks JAX draws from it."""
    (jc, jg, c), (tc, tg, _) = _graphs(bn_flag=False, **kw)
    N = jg.num_nodes
    ms = jmodel.model_static(jc, jg.num_features, c)
    jstate = j_init_train_state(jax.random.PRNGKey(0), ms, N)
    fns = j_make_step_fns(ms, jc, multilabel=False)
    X = j_device_features(jg.x)
    j_train = jsamplers.BatchLoader(jg, jc, train_flag=True, seed=jc.seed)
    j_test = jsamplers.BatchLoader(jg, jc, train_flag=False, sampler_type="node",
                                   batch_size=jc.test_batch_size, shuffle=False,
                                   seed=jc.seed + 1)
    j_test_batches = [jax.tree.map(jnp.asarray, w[0]) for w, _ in j_test._epoch_iter()]

    tr = NodeTrainer(tg, tc, c, device="cpu")
    tr.state = state_from_numpy(jax.tree.map(np.asarray, jstate), tr.ms, LR, "cpu")
    for layer_idx in range(1, ms.num_layers + 1):
        step = fns.init_step_for(layer_idx)
        for b in j_test_batches:
            vq, vq_tr = step(jstate.vq_states, jstate.vq_states_tr or [], jstate.params, X, b)
            jstate = jstate.replace(vq_states=vq, vq_states_tr=vq_tr or None)
    tr.run_init_sweep()

    def lists():  # each package's codebook lists, as they stand
        out = [("vq_states", jstate.vq_states, tr.state.vq_states)]
        if ms.transformer_flag:
            out.append(("vq_states_tr", jstate.vq_states_tr, tr.state.vq_states_tr))
        return out

    for name, js_list, ts_list in lists():  # the init sweep, state by state
        for js, ts in zip(js_list, ts_list, strict=True):
            _close(ts.embedding_output.numpy(), np.asarray(js.embedding_output), RTOL_SUM, name)
    tr_before = [s.embedding_output.clone() for s in tr.state.vq_states_tr or []]

    steps, dropped = 0, 0
    for (jw, _), (tw, _) in zip(j_train._epoch_iter(), tr.train_loader, strict=True):
        for j, (jb, tb) in enumerate(zip(jw, tw, strict=True)):
            do_opt = 0.0 if (len(jw) > 1 and j == 0) else 1.0
            key = jax.random.fold_in(jax.random.PRNGKey(1), steps)
            masks, keeps = _jax_step_masks(key, ms, tb.B_pad) if masks_from_key else (None, None)
            before = [dataclasses.replace(s, **{f: getattr(s, f).clone()
                                                 for f in VQ_FIELDS + ("c_indices",)})
                      for s in tr.state.vq_states]
            jstate, jm = fns.train_step(
                jstate, X, jax.tree.map(jnp.asarray, jb), jnp.float32(1.0), jnp.float32(LR),
                jnp.float32(do_opt), key,
            )
            tr.state, tm = tr.fns.train_step(tr.state, tr.X_dev, tb, 1.0, LR, do_opt,
                                             branch_masks=masks, dropout_keeps=keeps)
            for k in ("loss", "loss_cls", "info_backward"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL_STEP,
                                           atol=1e-7, err_msg=f"step {steps} {k}")
            if masks is not None:  # a dropped branch's state: the same bits
                rows = tb.batch_idx.numpy()
                for l, (s0, s1) in enumerate(zip(before, tr.state.vq_states)):
                    for b in np.flatnonzero(~masks[l].numpy()):
                        for f in VQ_FIELDS:
                            assert torch.equal(getattr(s1, f)[b], getattr(s0, f)[b]), f
                        assert torch.equal(s1.c_indices[rows, b], s0.c_indices[rows, b])
                        dropped += 1
            steps += 1
    assert steps >= 3 and (dropped > 0) == masks_from_key
    for name, js_list, ts_list in lists():
        for js, ts in zip(js_list, ts_list, strict=True):
            agree = (ts.c_indices.numpy()[:N] == np.asarray(js.c_indices)[:N]).mean()
            assert agree > 0.99, (name, agree)
    if ms.transformer_flag:  # the live update moved every transformer codebook
        for s, s0 in zip(tr.state.vq_states_tr, tr_before):
            assert not torch.equal(s.embedding_output, s0)
    for jb, (tw, _) in zip(j_test_batches, tr.test_batches()):
        out = tr.fns.eval_step(tr.state, tr.X_dev, tw[0]).numpy()
        ref = np.asarray(fns.eval_step(jstate, X, jb))
        np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("conv", ["GCN", "GAT"])
def test_bm_transformer_training_matches_jax(conv):
    """A B + M epoch with the transformer branch: the init sweep's
    feature_update of both codebook lists, the steps' three autograd targets
    (parameters, probes, the transformer's probes) and both lists' live
    updates, and eval through both codebooks."""
    _epoch_against_jax(dict(conv_type=conv, formulation="bm", transformer_flag=True), False)


def test_dropbranch_alpha_dropout_training_matches_jax():
    """A B + B' GCN epoch with dropbranch 0.5 and alpha dropout 0.5, the JAX
    masks of each step's key handed to the port: the losses, the dropped
    branches' states bit-identical through each step, the assignments, and
    eval (no dropout)."""
    _epoch_against_jax(dict(conv_type="GCN", dropbranch=0.5, alpha_dropout_flag=True,
                            dropout=0.5), True)


# ---------------------------------------------------------------------------
# the link step
# ---------------------------------------------------------------------------
def _link_trainers(**kw):
    """A JAX LinkTrainer and the port's on one SBM and split, the port
    starting from the JAX state and predictor."""
    base = dict(CFG, dataset="synthetic", batch_size=150, bn_flag=False, vq_backend="xla")
    jc, tc = jcfg.Config(**{**base, **kw}), tcfg.Config(**{**base, **kw})
    rng = np.random.RandomState(0)
    out = []
    for data, link, cfg in ((jdata, jlink, jc), (tdata, tlink, tc)):
        g, c = data.synthetic_sbm(num_nodes=300, num_features=16, seed=2)
        g, _, _ = data.prepare(g, cfg, c)
        coo = g.adj.tocoo()
        e = np.stack([coo.row, coo.col], 1)
        e = e[e[:, 0] != e[:, 1]][:200]
        neg = rng.randint(0, 300, (100, 2))
        split = link.SplitEdges(train_pos=e, valid_pos=e[:50], valid_neg=neg, test_pos=e[50:100],
                                test_neg=neg)
        out.append(link.LinkTrainer(g, cfg, split) if link is jlink
                   else link.LinkTrainer(g, cfg, split, device="cpu"))
    jtr, tr = out
    tr.state = state_from_numpy(jax.tree.map(np.asarray, jtr.state), tr.ms, LR, "cpu")
    tr.predictor, tr.pred_opt = predictor_from_numpy(
        jax.tree.map(np.asarray, jtr.pred_params), jax.tree.map(np.asarray, jtr.pred_nu), LR,
        "cpu")
    return jtr, tr


@pytest.mark.parametrize("kw", [
    dict(dropbranch=0.5, alpha_dropout_flag=True, dropout=0.5),
    dict(formulation="bm", transformer_flag=True),
], ids=["dropbranch-alpha-dropout", "bm-transformer"])
def test_link_step_options_match_jax(kw):
    """One link step from one carried state after each package's init sweep,
    every draw of JAX's key handed to the port (negatives, the predictor's
    dropout masks, the dropbranch and alpha-dropout masks): the loss and
    the VQ states after the live update.  With the transformer the link
    step takes no gradient of its hook points, so the transformer's
    codebooks stay as the init sweep left them, as in the JAX package."""
    jtr, tr = _link_trainers(**kw)
    jtr.run_init_sweep()
    tr.run_init_sweep()
    jb = [jax.tree.map(jnp.asarray, w) for w, _ in jtr.train_loader._epoch_iter()][0][-1]
    tb = [w for w, _ in tr.train_loader][0][-1]
    np.testing.assert_array_equal(tb.link_src.numpy(), np.asarray(jb.link_src))
    key = jax.random.PRNGKey(11)
    rng, r_neg, r_drop = jax.random.split(key, 3)  # vq_gnn_tpu/train/link.py:67-81
    dst_neg = jax.random.randint(r_neg, jb.link_src.shape, 0, jnp.maximum(jb.num_B, 1))
    pred_keep = None
    if jtr.cfg.dropout > 0:
        pred_keep, r = [], r_drop
        shape = (jb.link_src.shape[0], jtr.cfg.hidden_channels)
        for _ in jtr.pred_params[:-1]:
            r, sub = jax.random.split(r)
            pred_keep.append(_t(jax.random.bernoulli(sub, 1.0 - jtr.cfg.dropout, shape)))
    masks, keeps = _jax_step_masks(rng, jtr.ms, tb.B_pad)
    step, _ = jlink.make_link_step(jtr.ms, jtr.cfg)
    tr_before = [s.embedding_output.clone() for s in tr.state.vq_states_tr or []]
    jst, _, _, jm = step(jtr.state, jtr.pred_params, jtr.pred_nu, jtr.X_dev, jb,
                         jnp.float32(0.5), jnp.float32(LR), jnp.float32(1.0), key)
    tm = tr.step_fn(tr.state, tr.predictor, tr.pred_opt, tr.X_dev, tb, 0.5, LR, 1.0,
                    dst_neg=_t(dst_neg).long(), pred_keep=pred_keep, branch_masks=masks,
                    dropout_keeps=keeps)
    for k in ("loss", "loss_pre"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL_STEP, err_msg=k)
    for js, ts in zip(jst.vq_states, tr.state.vq_states, strict=True):
        for f in ("embedding", "embedding_output", "ema_cluster_size", "bn_grad_mean",
                  "bn_grad_var"):
            _close(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), RTOL_SUM, f)
        np.testing.assert_array_equal(ts.c_indices.numpy()[:-1], np.asarray(js.c_indices)[:-1])
    if jtr.ms.transformer_flag:
        for ts, js, s0 in zip(tr.state.vq_states_tr, jst.vq_states_tr, tr_before, strict=True):
            assert torch.equal(ts.embedding_output, s0)
            _close(ts.embedding_output.numpy(), np.asarray(js.embedding_output), RTOL_SUM, "tr")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_link_trainer_trains_with_options(dtype):
    """LinkTrainer with dropbranch 0.5 and alpha dropout 0.5 (its masks and
    the predictor's from the trainer's generator): the init sweep, two
    epochs with finite losses, and Hits@50 in [0, 1], in f32 and at bf16
    compute."""
    _, tr = _link_trainers(dropbranch=0.5, alpha_dropout_flag=True, dropout=0.5,
                           compute_dtype=dtype)
    tr.run_init_sweep()
    losses = [tr.train_epoch(epoch) for epoch in (1, 2)]
    assert all(np.isfinite(v) for v in losses), losses
    assert all(0.0 <= h <= 1.0 for h in tr.evaluate_hits(50))
