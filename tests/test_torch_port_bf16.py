"""The port's bf16 compute path (``compute_dtype='bfloat16'``) against the JAX
package, on the CPU, at the size of ``tests/test_bf16_fused_seam.py`` (320
nodes, 128 features, hidden 128, 2 layers, M = 16).

The JAX side runs its Pallas kernels as that test runs them, in interpret
mode (``VQ_GNN_ELL_FUSED=interpret``); the port runs the plain versions of
its kernels.  Both sides round to bf16 at the same points (the lookup's
codewords, x_input, the bf16 logit dots, the gathered cotangents, dx) and
sum in f32, so what differs is the order of the f32 sums, and the bf16
roundings it moves by one unit:

- the lookup: exact (the same f32 values rounded once);
- one layer: outputs to rtol 2e-2, atol 1e-2, the bf16 tolerance of
  ``tests/test_pallas_ell.py:123``;
- the whole model: the loss to rtol 5e-3, atol 5e-3, and each gradient (of
  the parameters and of the probes) to rtol 2e-2 and atol max(2e-3 x its
  largest |ref|, 3e-5), the tolerances ``tests/test_bf16_fused_seam.py``
  holds the JAX package's fused and unfused bf16 paths to.
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
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.convert import state_from_numpy
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.nn import model as tmodel
from vq_gnn_tpu_torch.sampler import samplers as tsamplers
from vq_gnn_tpu_torch.train.loop import NodeTrainer
from vq_gnn_tpu_torch.train.step import masked_ce
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

# tests/test_bf16_fused_seam.py:BASE
SEAM = dict(dataset="synthetic", conv_type="GAT", num_layers=2, hidden_channels=128, num_D=4,
            num_M=16, sampler_type="node", batch_size=256, test_batch_size=320,
            vq_update_mode="live", skip=True, compute_dtype="bfloat16", pad_multiple_nodes=64,
            pad_multiple_edges=2048)
LAYER_RTOL, LAYER_ATOL = 2e-2, 1e-2
LOSS_TOL = 5e-3
LEAF_RTOL = 2e-2


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


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _setup(conv="GAT", formulation="bbprime", **kw):
    """Each package's config, graph, first training batch and train state,
    from one SBM and one JAX state (``convert.state_from_numpy``)."""
    out = []
    for cfg_mod, data, samplers, extra in (
        (jcfg, jdata, jsamplers, {}), (tcfg, tdata, tsamplers, {"device": "cpu"})
    ):
        cfg = cfg_mod.Config(**{**SEAM, "conv_type": conv, "formulation": formulation, **kw})
        g, c = data.synthetic_sbm(num_nodes=320, num_features=128, num_classes=6, seed=3)
        g, c, _ = data.prepare(g, cfg, c)
        ld = samplers.BatchLoader(g, cfg, train_flag=True, shuffle=False, seed=0, **extra)
        (windows, _), = [next(ld._epoch_iter())]
        out.append((cfg, g, c, windows[0]))
    (jc, jg, c, jb), (tc, tg, _, tb) = out
    ms_j = jmodel.model_static(jc, jg.num_features, c)
    ms_t = tmodel.model_static(tc, tg.num_features, c, torch.device("cpu"))
    jstate = j_init_train_state(jax.random.PRNGKey(0), ms_j, jg.num_nodes)
    return (jc, jg, ms_j, jstate, jax.tree.map(jnp.asarray, jb)), (tc, tg, ms_t, tb.to("cpu"))


def _random_codebook(jstate, seed):
    """Layer 0's codeword table and assignments at random (the init state's
    are zeros), so that the lookup and the recovery term carry values."""
    rng = np.random.RandomState(seed)
    vq = jstate.vq_states[0]
    M = vq.embedding_output.shape[1]
    vq = vq.replace(
        embedding_output=jnp.asarray(rng.randn(*vq.embedding_output.shape).astype(np.float32)),
        c_indices=jnp.asarray(rng.randint(0, M, vq.c_indices.shape).astype(np.int16)),
    )
    return jstate.replace(vq_states=[vq] + list(jstate.vq_states[1:])), rng


def _j_layer(formulation):
    """The JAX layer of a formulation (the port's ``layer_forward`` takes
    both)."""
    return jmodel.layer_forward_bm if formulation == "bm" else jmodel.layer_forward


def _spy(monkeypatch, module, seen):
    real = module.lookup

    def spy(state, ids, p, stream=None):
        out = real(state, ids, p, stream=stream)
        seen.append((stream, [np.asarray(o, np.float32) for o in out]))
        return out

    monkeypatch.setattr(module, "lookup", spy)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("formulation", ["bbprime", "bm"])
def test_lookup_stream_matches_jax(formulation, backend, monkeypatch):
    """The layer's codebook lookup: B + B' passes the bf16 stream, which
    rounds the codewords to bf16 (and forces the fast mode on 'pallas'); B +
    M passes none and stays f32, as ``vq_gnn_tpu/nn/model.py:294-298, 602``.
    The values are the JAX package's exactly."""
    (jc, jg, ms_j, jstate, jb), (tc, tg, ms_t, tb) = _setup(
        formulation=formulation, vq_backend=backend)
    jstate, rng = _random_codebook(jstate, 1)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, 0.01, "cpu")
    j_seen, t_seen = [], []
    _spy(monkeypatch, jmodel, j_seen)
    _spy(monkeypatch, tmodel, t_seen)
    x = rng.randn(tb.B_pad, jg.num_features).astype(np.float32)
    _j_layer(formulation)(jstate.params[0], jstate.vq_states[0], ms_j, jnp.asarray(x), jb, None,
                          1.0, True)
    with torch.no_grad():
        tmodel.layer_forward(state.model.layers[0], state.vq_states[0], ms_t, _t(x), tb, None,
                             1.0)
    (j_stream, j_out), = j_seen
    (t_stream, t_out), = t_seen
    assert (j_stream is None) == (t_stream is None) == (formulation == "bm")
    if formulation == "bbprime":
        assert j_stream == jnp.bfloat16 and t_stream == torch.bfloat16
    for a, b in zip(t_out, j_out, strict=True):
        np.testing.assert_array_equal(a, b)
    feats = _t(t_out[0])
    representable = torch.equal(feats.to(torch.bfloat16).float(), feats)
    assert representable == (formulation == "bbprime")


@pytest.mark.parametrize("conv,formulation", [("GCN", "bbprime"), ("SAGE", "bbprime"),
                                              ("GAT", "bbprime"), ("GAT", "bm")])
def test_layer_forward_matches_jax(conv, formulation):
    """One layer at bf16 with a random codebook and warm-up rate 0.7: the
    output and info_backward against the JAX ``layer_forward`` (B + B') and
    ``layer_forward_bm`` (B + M), to the bf16 tolerance.  And the roundings
    sit where JAX's do: 99 % of the output's values are within 1e-5 x its
    largest |ref| of JAX's (a rounding point moved, such as al rounded to
    bf16, puts 14 % of them beyond it; a bf16 rounding that a sum in another
    order moves by one unit shifts a few rows), and the port's own f32 layer
    is not (it differs by the bf16 roundings)."""
    (jc, jg, ms_j, jstate, jb), (tc, tg, ms_t, tb) = _setup(conv, formulation)
    jstate, rng = _random_codebook(jstate, 2)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, 0.01, "cpu")
    x = rng.randn(tb.B_pad, jg.num_features).astype(np.float32)
    j_out, j_info = _j_layer(formulation)(jstate.params[0], jstate.vq_states[0], ms_j,
                                          jnp.asarray(x), jb, None, 0.7, True)
    j_out = np.asarray(j_out)
    outs = {}
    for cd in ("bfloat16", "float32"):
        with torch.no_grad():
            outs[cd] = tmodel.layer_forward(
                state.model.layers[0], state.vq_states[0],
                dataclasses.replace(ms_t, compute_dtype=cd), _t(x), tb, None, 0.7)
    out, info = outs["bfloat16"]
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), j_out, rtol=LAYER_RTOL, atol=LAYER_ATOL)
    np.testing.assert_allclose(float(info), float(j_info), rtol=LAYER_RTOL, atol=LAYER_ATOL)
    assert abs(float(j_info)) > 0
    tol = 1e-5 * np.abs(j_out).max()
    near = {cd: float((np.abs(o.numpy() - j_out) <= tol).mean()) for cd, (o, _) in outs.items()}
    assert near["bfloat16"] >= 0.99 and near["float32"] < 0.99, near


# each conv of B + B' and the B + M GAT; the GAT cases keep their first ids
MODEL_CASES = [pytest.param("GCN", "bbprime", id="GCN-bbprime"),
               pytest.param("SAGE", "bbprime", id="SAGE-bbprime"),
               pytest.param("GAT", "bbprime", id="bbprime"),
               pytest.param("GAT", "bm", id="bm")]


def _model_grads(conv, formulation, jit, dtypes=("bfloat16",), codebook_seed=None, **kw):
    """The whole model on the first training batch: masked CE +
    info_backward and its gradients with respect to every parameter and
    every probe (what the VQ update reads).  Returns JAX's loss, its
    gradients as (name, array) beside the port's order, and the port's
    (loss, gradients) at each compute dtype of ``dtypes``.  ``jit=False``
    runs the JAX side op by op (``jax.disable_jit``), each op rounding
    where the code says; under ``jax.jit`` XLA fuses the GAT glue around
    the bf16 values and rounds some of it elsewhere.  ``kw`` (Config
    fields over ``SEAM``, such as another compute_dtype) goes to the JAX
    side's config; ``codebook_seed`` starts from layer 0's codebook at
    random (:func:`_random_codebook`), else from the initial state."""
    (jc, jg, ms_j, jstate, jb), (tc, tg, ms_t, tb) = _setup(conv, formulation, **kw)
    if codebook_seed is not None:
        jstate, _ = _random_codebook(jstate, codebook_seed)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, 0.01, "cpu")
    X = j_device_features(jg.x)
    j_probes = jmodel.zero_probes(ms_j, jb.B_pad)

    def j_loss(params, probes):
        x_B = jnp.take(X, jb.batch_idx, axis=0)
        out, info_b, _, _ = jmodel.model_forward(
            params, jstate.vq_states, jstate.bn_state, ms_j, x_B, jb, probes=probes,
            warm_up_rate=1.0, training=True, rng=jax.random.PRNGKey(1))
        m = (jb.train_mask & jb.valid_B).astype(out.dtype)
        ll = jnp.take_along_axis(jax.nn.log_softmax(out), jb.y[:, None].astype(jnp.int32),
                                 axis=1)[:, 0]
        return -jnp.sum(ll * m) / jnp.maximum(jnp.sum(m), 1.0) + info_b

    if jit:
        j_val, (j_gp, j_gprobe) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(
            jstate.params, j_probes)
    else:
        with jax.disable_jit():
            j_val, (j_gp, j_gprobe) = jax.value_and_grad(j_loss, argnums=(0, 1))(
                jstate.params, j_probes)
    assert any(np.abs(np.asarray(g)).max() > 0 for g in j_gprobe)

    X_t = _t(np.concatenate([tg.x, np.zeros((1, tg.x.shape[1]), tg.x.dtype)]))
    # each parameter beside its JAX gradient (a linear's weight is [in, out]
    # there, [out, in] here)
    params, refs = [], []
    for l, layer in enumerate(state.model.layers):
        for name, p in layer.named_parameters():
            mod, _, key = name.partition(".")
            ref = np.asarray(j_gp[l][mod] if not key else j_gp[l][mod][key[0]])
            params.append(p)
            refs.append((f"layer {l} {name}", ref.T if key == "weight" else ref))
    refs += [(f"probe {l}", np.asarray(g)) for l, g in enumerate(j_gprobe)]
    ports = {}
    for cd in dtypes:
        ms = dataclasses.replace(ms_t, compute_dtype=cd)
        probes = tmodel.zero_probes(ms, tb.B_pad, "cpu")
        out, info_b, _, _ = tmodel.model_forward(
            state.model, state.vq_states, state.bn_state, ms, X_t.index_select(0, tb.batch_idx),
            tb, probes=probes, warm_up_rate=1.0, training=True)
        loss = masked_ce(out, tb.y, tb.train_mask & tb.valid_B) + info_b
        grads = torch.autograd.grad(loss, params + probes)
        assert len(refs) == len(grads)
        ports[cd] = (float(loss.detach()), grads)
    return float(j_val), refs, ports


@pytest.mark.parametrize("conv,formulation", MODEL_CASES)
def test_model_loss_and_grads_match_jax(conv, formulation):
    """The whole model at bf16 on the first training batch, GCN, SAGE and
    GAT at B + B' and GAT at B + M: the loss and its gradients with respect
    to every parameter and every probe against the JAX package running its
    Pallas kernels under ``jax.jit``; the tolerances of
    ``tests/test_bf16_fused_seam.py``."""
    j_val, refs, ports = _model_grads(conv, formulation, jit=True)
    loss, grads = ports["bfloat16"]
    assert np.isfinite(loss) and np.isfinite(j_val)
    np.testing.assert_allclose(loss, j_val, rtol=LOSS_TOL, atol=LOSS_TOL)
    for (name, ref), g in zip(refs, grads):
        assert g.shape == ref.shape and g.dtype == torch.float32, name
        tol = max(2e-3 * float(np.abs(ref).max()), 3e-5)
        np.testing.assert_allclose(g.numpy(), ref, rtol=LEAF_RTOL, atol=tol, err_msg=name)


def _near(g, ref, band):
    """The share of a gradient's values within band x its largest |ref| of
    JAX's."""
    return float((np.abs(g.numpy() - ref) <= band * np.abs(ref).max()).mean())


@pytest.mark.parametrize("conv,formulation", MODEL_CASES)
def test_model_grads_round_where_jax_rounds(conv, formulation):
    """The backward's rounding points sit where JAX's do: against the JAX
    model run op by op, every gradient leaf above the seam's absolute floor
    of 3e-5 (the layer-0 biases, which batch norm cancels, are noise below
    it) has at least 95 % of its values, and all leaves together 99 %,
    within 1e-5 x its largest |ref| (the port: 0.998-1.0 pooled, its worst
    leaf 0.981).  The port's own f32 model does not (0.26-0.48 pooled: it
    misses the bf16 roundings); nor does a port whose backward streams the
    cotangents, or the GAT ar, in f32, or rounds the GAT dx before adding
    the logit terms (0.50-0.88 pooled, its worst leaf 0.24 or less)."""
    _, refs, ports = _model_grads(conv, formulation, jit=False, dtypes=("bfloat16", "float32"))
    near = {}
    for cd, (_, grads) in ports.items():
        leaves = [(name, _near(g, ref, 1e-5), ref.size) for (name, ref), g in zip(refs, grads)
                  if np.abs(ref).max() > 3e-5]
        pooled = sum(f * n for _, f, n in leaves) / sum(n for _, _, n in leaves)
        near[cd] = (pooled, min(leaves, key=lambda t: t[1]))
    print(f"near {conv} {formulation}: {near}")  # the readings, with pytest -s
    pooled, (worst, worst_near, _) = near["bfloat16"]
    assert pooled >= 0.99 and worst_near >= 0.95, near
    assert near["float32"][0] < 0.9, near


@pytest.mark.parametrize("conv,formulation", [("GCN", "bbprime"), ("SAGE", "bbprime"),
                                              ("GAT", "bbprime"), ("GAT", "bm")])
def test_trainer_epoch_at_bf16(conv, formulation, monkeypatch):
    """``NodeTrainer`` at bf16 on the CPU (the plain versions): the init
    sweep, one epoch and an evaluation, with finite losses, the bf16 stream
    reaching the conv and every gradient and state f32."""
    cfg = tcfg.Config(**{**SEAM, "conv_type": conv, "formulation": formulation,
                         "hidden_channels": 16, "num_M": 8, "test_batch_size": 160})
    g, c = tdata.synthetic_sbm(num_nodes=320, num_features=16, num_classes=6, seed=3)
    g, c, ci = tdata.prepare(g, cfg, c)
    tr = NodeTrainer(g, cfg, c, ci, device="cpu")
    assert tr.ms.compute_dtype == "bfloat16"
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
    assert streamed and set(streamed) == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in tr.state.model.parameters())
    assert all(s.embedding.dtype == torch.float32 for s in tr.state.vq_states)
    acc = tr.evaluate()
    assert all(0.0 <= a <= 1.0 for a in acc)


def test_other_compute_dtypes_raise():
    """float32, bfloat16 and float16, the JAX package's three, are ported;
    any other dtype (float64) raises by name."""
    assert tcfg.torch_dtype("bfloat16") == torch.bfloat16
    assert tcfg.torch_dtype("float32") == torch.float32
    assert tcfg.torch_dtype("float16") == torch.float16
    with pytest.raises(NotImplementedError, match="compute_dtype='float64'.*no such path"):
        tcfg.check_ported(tcfg.Config(compute_dtype="float64"))
    with pytest.raises(NotImplementedError, match="compute_dtype='float64'"):
        tcfg.torch_dtype("float64")
    tcfg.check_ported(tcfg.Config(compute_dtype="bfloat16"))
    tcfg.check_ported(tcfg.Config(compute_dtype="float16"))


def test_rev_fold_fast_raises(monkeypatch):
    """The B + M recovery fold in bf16 (``VQ_GNN_REV_FOLD=fast``) no longer
    raises: it runs where it applies, B + M GAT at bf16 compute (the model
    hands fold='fast' to the recovery term each training step, and the
    epoch's losses are finite), and an unknown mode means 'x2', as in the
    JAX package (``vq_gnn_tpu/ops/pallas_rev.py:56-58``)."""
    from vq_gnn_tpu_torch.ops.rev_kernels import rev_fold_mode

    bm = tcfg.Config(formulation="bm", conv_type="GAT")
    for mode, want in (("x2", "x2"), ("highest", "highest"), ("fast", "fast"), ("bf16", "x2")):
        monkeypatch.setenv("VQ_GNN_REV_FOLD", mode)
        tcfg.check_ported(bm)
        assert rev_fold_mode() == want
    monkeypatch.delenv("VQ_GNN_REV_FOLD")
    assert rev_fold_mode() == "x2"
    cfg = tcfg.Config(**{**SEAM, "formulation": "bm", "hidden_channels": 16, "num_M": 8,
                         "test_batch_size": 160})
    g, c = tdata.synthetic_sbm(num_nodes=320, num_features=16, num_classes=6, seed=3)
    g, c, ci = tdata.prepare(g, cfg, c)
    tr = NodeTrainer(g, cfg, c, ci, device="cpu")
    tr.run_init_sweep()
    folds = []
    real = tmodel.rev_recovery_info

    def spy(*a, fold, **kw):
        folds.append(fold)
        return real(*a, fold=fold, **kw)

    monkeypatch.setattr(tmodel, "rev_recovery_info", spy)
    for mode in ("fast", "unknown"):
        monkeypatch.setenv("VQ_GNN_REV_FOLD", mode)
        folds.clear()
        loss, loss_cls = tr.train_epoch(1)
        assert np.isfinite(loss) and np.isfinite(loss_cls)
        assert folds and set(folds) == {"fast" if mode == "fast" else "x2"}
