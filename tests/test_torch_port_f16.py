"""The port's float16 compute path (``compute_dtype='float16'``) against the
JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(``VQ_GNN_ELL_FUSED=interpret``), as ``tests/test_torch_port_bf16.py`` runs
them; the port runs the plain versions of its kernels.  Both sides round to
f16 at the same points (x_input after the concatenation, the f16 logit
dots, the gathered cotangents, dx) and sum in f32; unlike bf16 compute, the
lookup stays f32 (``vq_gnn_tpu/nn/model.py:295-298`` streams bf16 alone).

(a) the lookup at f16: f32, the JAX package's values exactly, and kernel 3
    not forced into its fast mode;
(b) one layer (GCN, SAGE and GAT at B + B', GAT at B + M) at the size of
    ``tests/test_bf16_fused_seam.py``, from a random codebook: the output
    and info_backward to rtol 2e-3, atol 1e-3 (bf16's are 2e-2 and 1e-2;
    measured: the output within 5.0e-6 of its largest |ref|, info_backward
    within 9.4e-4 relative, both GAT B + M's, the worst), and the roundings
    where JAX's are;
(c) the whole model's loss and its gradients with respect to every
    parameter and probe against JAX under ``jax.jit``, from a random
    codebook: the loss to rtol 5e-4, atol 5e-4 (bf16: 5e-3), each
    gradient to rtol 2e-3 and atol max(2e-4 x its largest |ref|, 3e-5)
    (bf16: 2e-2 and 2e-3 x; measured: the loss within 2.5e-6 relative,
    each gradient within 1.2e-5 of its largest |ref|);
(d) five training steps under ``vq_update_mode='reference'`` (the
    codebooks frozen) at ``tests/test_multichip.py``'s configuration, on
    its first batch, GCN, SAGE, GAT, GCN B + M and GAT B + M: each loss
    against the JAX package's f16 losses on the same steps (rtol 1e-5) and
    against the figures the JAX package gave when this path was traced
    (``REFERENCE_LOSSES``, rtol 1e-3), the final state against JAX's;
(e) live mode: step 1 finite and held to JAX, and after it the feature
    half of layer 0's codebook above float16's largest value (65,504) on
    both sides, in f32 as well: step 2 casts it into x_input and its loss
    is nonfinite on both sides.  The port adds no clamp and no f32 detour.
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
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu.train.loop import device_features as j_device_features
from vq_gnn_tpu.train.state import init_train_state as j_init_train_state
from vq_gnn_tpu.train.step import make_step_fns as j_make_step_fns
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.convert import state_from_numpy
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.nn import model as tmodel
from vq_gnn_tpu_torch.nn import vq as tvq
from vq_gnn_tpu_torch.ops.ell_aggregate import panel_width
from vq_gnn_tpu_torch.sampler import samplers as tsamplers
from vq_gnn_tpu_torch.train import link as tlink
from vq_gnn_tpu_torch.train.loop import NodeTrainer, device_features
from vq_gnn_tpu_torch.train.optim import rmsprop_nu
from vq_gnn_tpu_torch.train.step import make_step_fns
from tests.test_torch_port_bf16 import (
    MODEL_CASES,
    SEAM,
    _j_layer,
    _model_grads,
    _random_codebook,
    _setup,
    _spy,
    _t,
)
from tests.test_torch_port_link import _cfg_kw as _link_cfg_kw
from tests.test_torch_port_link import _split as _link_split

F16 = dict(compute_dtype="float16")
F16_MAX = 65504.0  # float16's largest finite value
LAYER_RTOL, LAYER_ATOL = 2e-3, 1e-3
LOSS_TOL = 5e-4
LEAF_RTOL, LEAF_BAND = 2e-3, 2e-4
# tests/test_multichip.py's configuration, its graph and the step's scalars
TIER1 = dict(dataset="synthetic", conv_type="GCN", num_layers=2, hidden_channels=16, num_D=4,
             num_M=8, batch_size=128, skip=True, pad_multiple_nodes=64, pad_multiple_edges=512,
             vq_update_mode="reference", **F16)
LR = 0.01
STEPS = 5
# the JAX package's f16 losses of those five steps (its first batch each
# step, PRNGKey(3 + step)), as it gave them when this path was traced
REFERENCE_LOSSES = {
    ("GCN", "bbprime"): [2.149, 1.068, 0.6117, 0.4173, 0.3104],
    ("GAT", "bbprime"): [2.153, 1.096, 0.6242, 0.426, 0.3157],
    ("SAGE", "bbprime"): [2.2904, 0.89963, 0.39948, 0.21988, 0.14446],
    ("GCN", "bm"): [2.2711, 1.0319, 0.58096, 0.41091, 0.31076],
    ("GAT", "bm"): [2.1534, 1.0844, 0.6215, 0.42408, 0.31294],
}
# the state after five steps: the inter-layer BN is on, so the biases ahead
# of it have a gradient of rounding noise that RMSprop turns into moves of
# up to lr a step (tests/test_multichip.py's atol 1e-2 for one step; over
# five, 5 lr: measured 9.2e-3); every other parameter to ATOL_PARAMS
# (measured: 2.5e-4, GAT's layer-0 att_r), RMSprop's square averages to
# NU_RTOL of the largest (measured: 1.2e-3, the same att_r), and the BN's
# running variance to 1e-4
ATOL_NOISE_BIAS = STEPS * LR
ATOL_PARAMS = 1e-3
NU_RTOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _vml_first_call():
    """A throwaway first torch.exp of the process: the first call of MKL's
    vector exp can return a chunk at a lower accuracy
    (tests/test_torch_port_kernels.py:_vml_first_call says more)."""
    torch.exp(torch.zeros(1 << 16))


@pytest.fixture(autouse=True)
def _fused(monkeypatch):
    """The JAX side runs its Pallas kernels, interpreted, as the seam test."""
    monkeypatch.setenv("VQ_GNN_ELL_FUSED", "interpret")


# ---------------------------------------------------------------------------
# (a) the lookup
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("formulation", ["bbprime", "bm"])
def test_lookup_stays_f32_at_f16(formulation, backend, monkeypatch):
    """At f16 neither package passes the lookup a stream: the codewords stay
    f32, equal to the JAX package's, and on 'pallas' kernel 3 runs in its
    exact mode (bf16 compute forces the fast one)."""
    (jc, jg, ms_j, jstate, jb), (tc, tg, ms_t, tb) = _setup(
        formulation=formulation, vq_backend=backend, **F16)
    jstate, rng = _random_codebook(jstate, 1)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, 0.01, "cpu")
    j_seen, t_seen, fast = [], [], []
    _spy(monkeypatch, jmodel, j_seen)
    _spy(monkeypatch, tmodel, t_seen)
    real = tvq.lookup_codewords

    def spy_kernel(*a, **kw):
        fast.append(kw["fast"])
        return real(*a, **kw)

    monkeypatch.setattr(tvq, "lookup_codewords", spy_kernel)
    x = rng.randn(tb.B_pad, jg.num_features).astype(np.float32)
    _j_layer(formulation)(jstate.params[0], jstate.vq_states[0], ms_j, jnp.asarray(x), jb, None,
                          1.0, True)
    with torch.no_grad():
        tmodel.layer_forward(state.model.layers[0], state.vq_states[0], ms_t, _t(x), tb, None,
                             1.0)
    (j_stream, j_out), = j_seen
    (t_stream, t_out), = t_seen
    assert j_stream is None and t_stream is None
    assert fast == ([False] if backend == "pallas" else [])
    for a, b in zip(t_out, j_out, strict=True):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    feats = _t(t_out[0])
    assert not torch.equal(feats.half().float(), feats)  # not rounded to f16
    assert not torch.equal(feats.bfloat16().float(), feats)  # nor to bf16


# ---------------------------------------------------------------------------
# (b) one layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("conv,formulation", [("GCN", "bbprime"), ("SAGE", "bbprime"),
                                              ("GAT", "bbprime"), ("GAT", "bm")])
def test_layer_forward_matches_jax_f16(conv, formulation):
    """One layer at f16 with a random codebook and warm-up rate 0.7: the
    output and info_backward against the JAX ``layer_forward`` (B + B')
    and ``layer_forward_bm`` (B + M), to LAYER_RTOL and LAYER_ATOL.  And
    the roundings sit where JAX's do: 99 % of the output's values are
    within 1e-6 x its largest |ref| of JAX's, and the port's own f32 and
    bf16 layers are not (they differ by the f16 roundings)."""
    (jc, jg, ms_j, jstate, jb), (tc, tg, ms_t, tb) = _setup(conv, formulation, **F16)
    jstate, rng = _random_codebook(jstate, 2)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, 0.01, "cpu")
    x = rng.randn(tb.B_pad, jg.num_features).astype(np.float32)
    j_out, j_info = _j_layer(formulation)(jstate.params[0], jstate.vq_states[0], ms_j,
                                          jnp.asarray(x), jb, None, 0.7, True)
    j_out = np.asarray(j_out)
    outs = {}
    for cd in ("float16", "bfloat16", "float32"):
        with torch.no_grad():
            outs[cd] = tmodel.layer_forward(
                state.model.layers[0], state.vq_states[0],
                dataclasses.replace(ms_t, compute_dtype=cd), _t(x), tb, None, 0.7)
    out, info = outs["float16"]
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), j_out, rtol=LAYER_RTOL, atol=LAYER_ATOL)
    np.testing.assert_allclose(float(info), float(j_info), rtol=LAYER_RTOL, atol=LAYER_ATOL)
    assert abs(float(j_info)) > 0
    tol = 1e-6 * np.abs(j_out).max()
    near = {cd: float((np.abs(o.numpy() - j_out) <= tol).mean()) for cd, (o, _) in outs.items()}
    print(f"near {conv} {formulation}: {near}")  # the readings, with pytest -s
    assert near["float16"] >= 0.99 and near["float32"] < 0.99 and near["bfloat16"] < 0.99, near


# ---------------------------------------------------------------------------
# (c) the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("conv,formulation", MODEL_CASES)
def test_model_loss_and_grads_match_jax_f16(conv, formulation):
    """The whole model at f16 on the first training batch, from layer 0's
    codebook at random: the loss and its gradients with respect to every
    parameter and every probe against the JAX package under ``jax.jit``,
    to LOSS_TOL, LEAF_RTOL and LEAF_BAND (each tighter than bf16's)."""
    j_val, refs, ports = _model_grads(conv, formulation, jit=True, dtypes=("float16",),
                                      codebook_seed=1, **F16)
    loss, grads = ports["float16"]
    assert np.isfinite(loss) and np.isfinite(j_val)
    np.testing.assert_allclose(loss, j_val, rtol=LOSS_TOL, atol=LOSS_TOL)
    for (name, ref), g in zip(refs, grads):
        assert g.shape == ref.shape and g.dtype == torch.float32, name
        assert torch.isfinite(g).all(), name
        tol = max(LEAF_BAND * float(np.abs(ref).max()), 3e-5)
        np.testing.assert_allclose(g.numpy(), ref, rtol=LEAF_RTOL, atol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# (d), (e) training steps at tests/test_multichip.py's configuration
# ---------------------------------------------------------------------------
def _tier1(conv, formulation, mode):
    """(JAX: ms, state, step fns, X, first batch), (port: ms, state, step
    fns, X, first batch), N, from one SBM and one JAX state."""
    kw = {**TIER1, "conv_type": conv, "formulation": formulation, "vq_update_mode": mode}
    jc, tc = jcfg.Config(**kw), tcfg.Config(**kw)
    jg, c = jdata.synthetic_sbm(num_nodes=400, num_features=16, seed=0)
    jg, c, _ = jdata.prepare(jg, jc, c)
    tg, _ = tdata.synthetic_sbm(num_nodes=400, num_features=16, seed=0)
    tg, _, _ = tdata.prepare(tg, tc, c)
    ms_j = jmodel.model_static(jc, jg.num_features, c)
    ms_t = tmodel.model_static(tc, tg.num_features, c, torch.device("cpu"))
    jstate = j_init_train_state(jax.random.PRNGKey(0), ms_j, jg.num_nodes)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, LR, "cpu")
    (jw, _), = [next(jsamplers.BatchLoader(jg, jc, train_flag=True)._epoch_iter())]
    (tw, _), = [next(tsamplers.BatchLoader(tg, tc, train_flag=True, device="cpu")._epoch_iter())]
    return ((ms_j, jstate, j_make_step_fns(ms_j, jc, multilabel=False),
             j_device_features(jg.x), jax.tree.map(jnp.asarray, jw[0])),
            (ms_t, tstate, make_step_fns(ms_t, tc), device_features(tg.x, "cpu"),
             tw[0].to("cpu")), jg.num_nodes)


def _j_step(fns, state, X, b, s):
    return fns.train_step(state, X, b, jnp.float32(1.0), jnp.float32(LR), jnp.float32(1.0),
                          jax.random.PRNGKey(3 + s))


@pytest.mark.parametrize("conv,formulation", list(REFERENCE_LOSSES))
def test_reference_mode_steps_match_jax_f16(conv, formulation):
    """Five steps at f16 with the codebooks frozen: every loss finite and
    the JAX package's, and the state after them JAX's: the parameters (the
    biases ahead of the BN to ATOL_NOISE_BIAS, the others to ATOL_PARAMS),
    RMSprop's square averages, the BN's running variance, the codebooks and
    their assignments."""
    (ms_j, jstate, jfns, jX, jb), (ms_t, tstate, tfns, tX, tb), N = _tier1(
        conv, formulation, "reference")
    j_losses, t_losses = [], []
    for s in range(STEPS):
        jstate, jm = _j_step(jfns, jstate, jX, jb, s)
        tstate, tm = tfns.train_step(tstate, tX, tb, 1.0, LR, 1.0)
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
    assert all(np.isfinite(t_losses)) and all(np.isfinite(j_losses))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    np.testing.assert_allclose(t_losses, REFERENCE_LOSSES[conv, formulation], rtol=1e-3)
    # the state: the port's layout of JAX's, beside the port's own
    ref = state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, LR, "cpu")
    params = list(tstate.model.parameters())
    ref_params = list(ref.model.parameters())
    names = [n for n, _ in tstate.model.named_parameters()]
    nus = rmsprop_nu(tstate.optimizer, params)
    ref_nus = rmsprop_nu(ref.optimizer, ref_params)
    last = f"layers.{ms_t.num_layers - 1}."
    for name, p, r, nu, rnu in zip(names, params, ref_params, nus, ref_nus, strict=True):
        # a bias of a layer the BN follows (every layer but the last)
        ahead_of_bn = name.endswith(".bias") and not name.startswith(last)
        np.testing.assert_allclose(p.detach().numpy(), r.detach().numpy(), rtol=0,
                                   atol=ATOL_NOISE_BIAS if ahead_of_bn else ATOL_PARAMS,
                                   err_msg=name)
        if not ahead_of_bn:
            np.testing.assert_allclose(nu.numpy(), rnu.numpy(), rtol=NU_RTOL,
                                       atol=NU_RTOL * float(rnu.abs().max()),
                                       err_msg=f"nu {name}")
    # the BN's running variance (its running mean follows the biases ahead
    # of it, as tests/test_torch_port_slice.py says)
    for a, b in zip(tstate.bn_state.var, ref.bn_state.var, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)
    for ts, rs in zip(tstate.vq_states, ref.vq_states, strict=True):
        np.testing.assert_array_equal(ts.embedding_output.numpy(), rs.embedding_output.numpy())
        np.testing.assert_array_equal(ts.c_indices.numpy()[:N], rs.c_indices.numpy()[:N])


@pytest.mark.parametrize("conv", ["GCN", "GAT"])
def test_live_mode_goes_nonfinite_at_step_2(conv):
    """Live VQ updates at f16, as the JAX package runs them: step 1 finite
    and held to JAX; after it the feature half of layer 0's codebook holds
    values above F16_MAX on both sides (the same values: the update is f32),
    so step 2's cast of x_input makes them inf and its loss is nonfinite on
    both sides."""
    (ms_j, jstate, jfns, jX, jb), (ms_t, tstate, tfns, tX, tb), N = _tier1(
        conv, "bbprime", "live")
    jstate, jm = _j_step(jfns, jstate, jX, jb, 0)
    tstate, tm = tfns.train_step(tstate, tX, tb, 1.0, LR, 1.0)
    assert np.isfinite(float(jm["loss"])) and np.isfinite(float(tm["loss"]))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    D = ms_t.num_D
    j_feat = np.asarray(jstate.vq_states[0].embedding_output)[:, :, :D]
    t_feat = tstate.vq_states[0].embedding_output[:, :, :D].numpy()
    np.testing.assert_allclose(t_feat, j_feat, rtol=1e-4)
    assert np.abs(j_feat).max() > F16_MAX and np.abs(t_feat).max() > F16_MAX
    jstate, jm = _j_step(jfns, jstate, jX, jb, 1)
    tstate, tm = tfns.train_step(tstate, tX, tb, 1.0, LR, 1.0)
    assert not np.isfinite(float(jm["loss"])) and not np.isfinite(float(tm["loss"]))


# ---------------------------------------------------------------------------
# the trainer and the kernels' panels at f16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("conv,formulation", [("GCN", "bbprime"), ("GAT", "bbprime"),
                                              ("GAT", "bm")])
def test_trainer_epoch_at_f16(conv, formulation, monkeypatch):
    """``NodeTrainer`` at f16 under 'reference' mode on the CPU (the plain
    versions): the init sweep, one epoch and an evaluation, with finite
    losses, the f16 stream reaching the conv and every gradient and state
    f32."""
    cfg = tcfg.Config(**{**SEAM, **F16, "conv_type": conv, "formulation": formulation,
                         "hidden_channels": 16, "num_M": 8, "test_batch_size": 160,
                         "vq_update_mode": "reference"})
    g, c = tdata.synthetic_sbm(num_nodes=320, num_features=16, num_classes=6, seed=3)
    g, c, ci = tdata.prepare(g, cfg, c)
    tr = NodeTrainer(g, cfg, c, ci, device="cpu")
    assert tr.ms.compute_dtype == "float16"
    tr.run_init_sweep()
    streamed = []
    conv_fn = "gat_conv_ell_mh" if formulation == "bm" else (
        "gat_conv_ell" if conv == "GAT" else "spmm")
    real = getattr(tmodel, conv_fn)

    def spy(edges, x, *a, **kw):
        streamed.append(x.dtype)
        return real(edges, x, *a, **kw)

    monkeypatch.setattr(tmodel, conv_fn, spy)
    loss, loss_cls = tr.train_epoch(1)
    assert np.isfinite(loss) and np.isfinite(loss_cls)
    assert streamed and set(streamed) == {torch.float16}
    assert all(p.dtype == torch.float32 for p in tr.state.model.parameters())
    assert all(s.embedding.dtype == torch.float32 for s in tr.state.vq_states)
    acc = tr.evaluate()
    assert all(0.0 <= a <= 1.0 for a in acc)


@pytest.mark.parametrize("C", [128, 256, 40, 36, 7, 200, 520, 1000])
def test_panel_width_f16(C):
    """The f16-row mode's panels are the bf16-row mode's: both load 8
    16-bit values a lane."""
    assert panel_width(C, torch.float16) == panel_width(C, torch.bfloat16)


def test_link_trainer_at_f16():
    """``LinkTrainer`` at f16 under 'reference' mode on the CPU: the init
    sweep, two epochs with finite losses, and Hits@50 on each split."""
    kw = _link_cfg_kw(lr=0.003, vq_update_mode="reference", **F16)
    tc = tcfg.Config(**kw)
    g, c = tdata.synthetic_sbm(num_nodes=400, num_features=16, seed=2)
    g, c, _ = tdata.prepare(g, tc, c)
    tr = tlink.LinkTrainer(g, tc, _link_split(g, np.random.RandomState(0)), device="cpu")
    assert tr.ms.compute_dtype == "float16"
    tr.run_init_sweep()
    for epoch in (1, 2):
        loss = tr.train_epoch(epoch)
        assert np.isfinite(loss)
    hits = tr.evaluate_hits(k=50)
    assert all(0.0 <= h <= 1.0 for h in hits)
