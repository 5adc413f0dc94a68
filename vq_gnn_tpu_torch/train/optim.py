"""RMSprop with the reference's semantics (port of ``vq_gnn_tpu/train/optim.py``).

The reference trains with ``torch.optim.RMSprop(lr, alpha=0.99)``
(``main_node.py v2:244``): ``nu <- alpha*nu + (1-alpha)*g^2``,
``p <- p - lr*g/(sqrt(nu) + eps)`` with eps outside the sqrt.  The port uses
that optimizer itself.  ``do_step`` gates the whole update: on skipped
windows neither the parameters nor ``nu`` move (``main_node.py
v2:113-116``), which is what not calling ``step()`` does.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

ALPHA = 0.99
EPS = 1e-8


def make_rmsprop(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.RMSprop:
    return torch.optim.RMSprop(params, lr=lr, alpha=ALPHA, eps=EPS)


def rmsprop_update(
    opt: torch.optim.RMSprop,
    params: Sequence[torch.nn.Parameter],
    grads: Sequence[torch.Tensor],
    lr: float,
    do_step: bool,
) -> None:
    """One gated RMSprop step with the given gradients and learning rate."""
    if not do_step:
        return
    for p, g in zip(params, grads):
        p.grad = g
    for group in opt.param_groups:
        group["lr"] = float(lr)
    opt.step()
    opt.zero_grad(set_to_none=True)


def rmsprop_nu(opt: torch.optim.RMSprop, params: Sequence[torch.nn.Parameter]):
    """The square averages ``nu`` per parameter (zeros before the first step)."""
    return [
        opt.state[p]["square_avg"] if "square_avg" in opt.state[p] else torch.zeros_like(p)
        for p in params
    ]
