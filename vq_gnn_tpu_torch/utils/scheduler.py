"""Learning-rate schedules (port of ``vq_gnn_tpu/utils/scheduler.py``).

``linear_ramp`` is the schedule the reference uses (``--sche``,
``main_node.py v2:249-251``): lr rises linearly to ``base_lr`` over
``ramp_epochs``.  ``gradual_warmup`` mirrors the reference's
GradualWarmupScheduler (``utils/scheduler.py:5-64``, imported by the v1
mains but never used): lr = base_lr * ((multiplier - 1) * epoch /
total_epoch + 1) up to ``total_epoch``, then base_lr * multiplier.
"""

from __future__ import annotations


def linear_ramp(base_lr: float, epoch: int, ramp_epochs: int = 200) -> float:
    return base_lr * epoch / ramp_epochs if epoch < ramp_epochs else base_lr


def gradual_warmup(base_lr: float, epoch: int, multiplier: float, total_epoch: int) -> float:
    if multiplier < 1.0:
        raise ValueError("multiplier should be >= 1.")
    if epoch > total_epoch:
        return base_lr * multiplier
    return base_lr * ((multiplier - 1.0) * epoch / total_epoch + 1.0)
