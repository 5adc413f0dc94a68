"""Checkpoint / resume (port of ``vq_gnn_tpu/train/checkpoint.py``).

The whole train state (parameters, the VQ codebooks with ``c_indices`` and
their BN running stats, the RMSprop square averages, the step counter) goes
into one ``.npz`` archive in the JAX package's own format, so that an archive
written by either package restores in the other:

- each leaf is stored under ``"leaf:" + its pytree path``, rendered as
  ``jax.tree_util.keystr`` renders it: ``.field`` for a dataclass field,
  ``[i]`` for a list item, ``['key']`` for a dict key;
- the leaves come in the JAX flatten order: dataclass fields in declaration
  order, dict keys sorted, None dropped;
- a port :class:`TrainState` is written as the JAX package's ``TrainState``
  (``convert.state_to_numpy``: a Linear's ``w`` [fan_in, fan_out],
  ``c_indices`` int16, ``step`` an int32 scalar); plain nested dicts, lists
  and tuples of numpy arrays or tensors are written as they are.

Restore matches leaves by name, so a template that flattens in another order
still restores each leaf to its own name; missing or extra names raise with
the names listed, and a leaf whose shape differs from the template's raises.
Archives of the older flatten-order format (``leaf_<i>`` keys) are matched by
the JAX flatten order.  The archive is written to ``path + ".tmp"`` and moved
over ``path`` once complete.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from vq_gnn_tpu_torch.train.state import TrainState


def _walk(tree: Any, path: str, on_leaf, rebuild: bool):
    """Calls ``on_leaf(path, leaf)`` at each leaf of ``tree`` in the JAX
    flatten order; with ``rebuild``, returns ``tree`` rebuilt with the
    results.  A :class:`TrainState` is walked as the JAX package's and
    rebuilt as a port state of the same structure and device
    (``convert.state_like``)."""
    from vq_gnn_tpu_torch.convert import Fields, state_like, state_to_numpy

    def walk(t, p):
        return _walk(t, p, on_leaf, rebuild)

    if tree is None:
        return None
    if isinstance(tree, TrainState):
        inner = walk(state_to_numpy(tree), path)
        return state_like(tree, inner) if rebuild else None
    if isinstance(tree, Fields):
        return Fields((k, walk(v, f"{path}.{k}")) for k, v in tree.items())
    if isinstance(tree, Mapping):
        done = {k: walk(tree[k], f"{path}[{k!r}]") for k in sorted(tree)}
        return type(tree)((k, done[k]) for k in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(walk(v, f"{path}[{i}]") for i, v in enumerate(tree))
    return on_leaf(path, tree)


def named_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """[(path string, leaf)] in the JAX flatten order."""
    out = []
    _walk(tree, "", lambda name, leaf: out.append((name, leaf)), rebuild=False)
    return out


def _numpy(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, step: int | None = None) -> None:
    arrays = {}
    for name, leaf in named_leaves(tree):
        key = "leaf:" + name
        if key in arrays:
            raise ValueError(f"duplicate pytree path {name!r}")
        arrays[key] = _numpy(leaf)
    if step is not None:
        arrays["__step__"] = np.asarray(step)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_step(path: str) -> int:
    with np.load(path) as z:
        return int(z["__step__"]) if "__step__" in z else 0


def restore_checkpoint(path: str, template: Any) -> Any:
    """The archive's values in the structure of ``template``.  Each leaf
    takes the template leaf's kind: a tensor on that tensor's device, or a
    numpy array; a :class:`TrainState` comes back as a new port state on the
    template's device."""
    named = named_leaves(template)
    with np.load(path) as z:
        legacy = "leaf_0" in z.files and not any(k.startswith("leaf:") for k in z.files)
        if legacy:
            picked = {name: z[f"leaf_{i}"] for i, (name, _) in enumerate(named)}
        else:
            have = {k for k in z.files if k.startswith("leaf:")}
            want = {"leaf:" + name for name, _ in named}
            if have != want:
                missing = sorted(want - have)
                extra = sorted(have - want)
                raise ValueError(
                    f"checkpoint/template leaf mismatch: missing={missing[:5]} "
                    f"extra={extra[:5]} (of {len(missing)}/{len(extra)})"
                )
            picked = {name: z["leaf:" + name] for name, _ in named}
    loaded: Dict[str, Any] = {}
    for name, leaf in named:
        a, shape = picked[name], tuple(np.shape(leaf))
        if tuple(a.shape) != shape:
            raise ValueError(f"checkpoint leaf {name!r} shape {a.shape} != template {shape}")
        loaded[name] = (torch.as_tensor(a).to(leaf.device) if isinstance(leaf, torch.Tensor)
                        else a)
    return _walk(template, "", lambda name, _: loaded[name], rebuild=True)
