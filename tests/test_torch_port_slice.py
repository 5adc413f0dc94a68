"""The port's training slice against the JAX package, end to end on the CPU:
the JAX-initialised state carried over by ``convert.state_from_numpy``, one
layerwise init sweep, three training steps on identical batches, then eval.
GCN, SAGE and GAT with skip, 2 layers, hidden 16, num_D=4, num_M=8, cluster
sampler on a 600-node SBM, dropout and dropbranch 0.  GAT's parameters include
the attention vectors and their RMSprop ``nu``; its backward's closed-form
d_ar holds to rtol 2e-4 on random data (``vq_gnn_tpu/ops/gat.py:120-124``),
well inside the tolerances below.

With the inter-layer BatchNorm on, the bias of a linear that feeds it has an
exact gradient of 0 (BN subtracts the batch mean), so what each package
computes for it is f32 round-off, which RMSprop's 1/(sqrt(nu)+eps) blows up
into steps of up to ~lr: the two packages move that bias differently, and
the BN running mean and the eval logits follow it.  The training losses, the
VQ states and every other parameter are invariant to it.  So those three are
compared with BN off, and everything else with BN on too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.nn.model import model_static as j_model_static
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu.train.loop import device_features as j_device_features
from vq_gnn_tpu.train.state import init_train_state as j_init_train_state
from vq_gnn_tpu.train.step import make_step_fns as j_make_step_fns
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.convert import state_from_numpy
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.train.loop import NodeTrainer
from vq_gnn_tpu_torch.train.optim import rmsprop_nu
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

LR = 0.005
RTOL_STEP = 1e-4  # per-step scalars: f32 sums in another order, over 3 steps
ATOL_STATE = 1e-4  # params, nu, BN state and eval logits after 3 steps
ATOL_VQ = 1e-5  # VQState fields, as in test_torch_port_vq


@pytest.fixture(scope="module", autouse=True)
def _vml_first_call():
    """A throwaway first torch.exp of the process: the first call of MKL's
    vector exp can return a chunk at a lower accuracy
    (tests/test_torch_port_kernels.py:_vml_first_call says more)."""
    torch.exp(torch.zeros(1 << 16))


def _cfg_kw(conv, backend, bn):
    return dict(
        bn_flag=bn, skip=True,
        conv_type=conv, num_layers=2, hidden_channels=16, num_D=4, num_M=8,
        sampler_type="cluster", num_parts=8, batch_size=3, test_batch_size=4, lr=LR,
        dropout=0.0, dropbranch=0.0, vq_backend=backend, pad_multiple_nodes=64,
        pad_multiple_edges=512, seed=0,
    )


def _vq_close(js, ts, N):
    for name in ("embedding", "embedding_output", "ema_cluster_size", "ema_w",
                 "bn_feat_mean", "bn_feat_var", "bn_grad_mean", "bn_grad_var"):
        np.testing.assert_allclose(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)), rtol=1e-5,
            atol=ATOL_VQ, err_msg=name,
        )
    np.testing.assert_array_equal(ts.c_indices.numpy()[:N], np.asarray(js.c_indices)[:N])
    assert bool(ts.bad_init) == bool(js.bad_init) and bool(ts.bn_inited) == bool(js.bn_inited)


@pytest.mark.parametrize(
    "conv,backend,bn",
    [("GCN", "xla", True), ("GCN", "xla", False), ("SAGE", "xla", False),
     ("GCN", "pallas", True), ("GAT", "xla", False), ("GAT", "pallas", False)],
)
def test_slice_matches_jax(conv, backend, bn):
    jc = jcfg.Config(**_cfg_kw(conv, backend, bn))
    tc = tcfg.Config(**_cfg_kw(conv, backend, bn))
    jg, c = jdata.synthetic_sbm(num_nodes=600, num_classes=5, num_features=12, seed=0)
    jg, c, jci = jdata.prepare(jg, jc, c)
    tg, _ = tdata.synthetic_sbm(num_nodes=600, num_classes=5, num_features=12, seed=0)
    tg, _, tci = tdata.prepare(tg, tc, c)
    N = jg.num_nodes

    # ---- JAX reference: state, step functions, loaders as its NodeTrainer builds them
    ms = j_model_static(jc, jg.num_features, c)
    jstate = j_init_train_state(jax.random.PRNGKey(0), ms, N)
    fns = j_make_step_fns(ms, jc, multilabel=False)
    X = j_device_features(jg.x)
    j_train = jsamplers.BatchLoader(jg, jc, train_flag=True, cluster_indices=jci, seed=jc.seed)
    j_test = jsamplers.BatchLoader(
        jg, jc, train_flag=False, sampler_type="cluster", cluster_indices=jci,
        batch_size=jc.test_batch_size, shuffle=False, seed=jc.seed + 1,
    )
    j_test_batches = [jax.tree.map(jnp.asarray, w[0]) for w, _ in j_test._epoch_iter()]

    # ---- the port, through its trainer, starting from the same state
    tr = NodeTrainer(tg, tc, c, tci, device="cpu")
    tr.state = state_from_numpy(jax.tree.map(np.asarray, jstate), tr.ms, LR, "cpu")
    assert len(tr.test_batches()) == len(j_test_batches) == 2

    # layerwise init sweep
    for layer_idx in range(1, ms.num_layers + 1):
        step = fns.init_step_for(layer_idx)
        for b in j_test_batches:
            vq, _ = step(jstate.vq_states, [], jstate.params, X, b)
            jstate = jstate.replace(vq_states=vq)
    tr.run_init_sweep()
    for js, ts in zip(jstate.vq_states, tr.state.vq_states):
        _vq_close(js, ts, N)

    # three training steps on identical batches
    j_batches = [jax.tree.map(jnp.asarray, w[0]) for w, _ in j_train._epoch_iter()]
    t_batches = [w[0] for w, _ in tr.train_loader]
    assert len(j_batches) == len(t_batches) == 3
    for jb, tb in zip(j_batches, t_batches):
        jstate, jm = fns.train_step(
            jstate, X, jb, jnp.float32(1.0), jnp.float32(LR), jnp.float32(1.0),
            jax.random.PRNGKey(1),
        )
        tr.state, tm = tr.fns.train_step(tr.state, tr.X_dev, tb, 1.0, LR, 1.0)
        for k in ("loss", "loss_cls", "info_backward"):
            np.testing.assert_allclose(
                float(tm[k]), float(jm[k]), rtol=RTOL_STEP, atol=1e-7, err_msg=k
            )
        assert not bool(tm["bad_init"]) and not bool(jm["bad_init"])

    params = list(tr.state.model.parameters())
    nus = rmsprop_nu(tr.state.optimizer, params)
    expected = {"gnn_transform", "linear_skip"} | (
        {"fc_sage"} if conv == "SAGE" else {"att_l", "att_r"} if conv == "GAT" else set())
    i = 0
    for l, layer in enumerate(tr.state.model.layers):
        seen = set()
        for pname, p in layer.named_parameters():  # parameters() order
            name, _, key = pname.partition(".")
            seen.add(name)
            key = {"weight": "w", "bias": "b"}.get(key)
            ref, ref_nu = jstate.params[l][name], jstate.opt_nu[l][name]
            if key is not None:  # a linear: JAX keeps w as [in, out]
                ref, ref_nu = ref[key], ref_nu[key]
            ref, ref_nu = np.asarray(ref), np.asarray(ref_nu)
            if key == "w":
                ref, ref_nu = ref.T, ref_nu.T
            assert p is params[i]
            feeds_bn = bn and key == "b" and l < ms.num_layers - 1
            if not feeds_bn:
                np.testing.assert_allclose(p.detach().numpy(), ref, atol=ATOL_STATE,
                                           err_msg=pname)
            np.testing.assert_allclose(nus[i].numpy(), ref_nu, atol=ATOL_STATE, err_msg=pname)
            i += 1
        assert seen == expected
    assert i == len(params)
    bn_pairs = list(zip(tr.state.bn_state.var, jstate.bn_state.var))
    if not bn:
        bn_pairs += list(zip(tr.state.bn_state.mean, jstate.bn_state.mean))
    for a, b in bn_pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL_STATE)
    for js, ts in zip(jstate.vq_states, tr.state.vq_states):
        _vq_close(js, ts, N)

    # eval on the test loader
    for jb, (tw, _) in zip(j_test_batches, tr.test_batches()):
        ref = np.asarray(fns.eval_step(jstate, X, jb))
        out = tr.fns.eval_step(tr.state, tr.X_dev, tw[0]).numpy()
        assert out.shape == ref.shape and np.isfinite(out).all()
        if not bn:
            np.testing.assert_allclose(out, ref, atol=ATOL_STATE)
    acc = tr.evaluate()
    assert all(0.0 <= a <= 1.0 for a in acc)
