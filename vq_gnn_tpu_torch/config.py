"""Configuration for the PyTorch/CUDA port of VQ-GNN.

A copy of ``vq_gnn_tpu/config.py``: the same fields, defaults and
validation, so one ``Config`` means the same run in both packages.  Two
additions are the port's own:

- ``resolve_device``: entry points run on ``cuda`` unless the caller asks
  for the CPU; with no GPU and no explicit CPU request they raise.
- ``apply_matmul_precision``: ``matmul_precision`` maps onto PyTorch's TF32
  switches ('highest' = exact f32, 'default' = TF32 allowed).
- ``torch_dtype``: the ``torch.dtype`` of ``compute_dtype`` ('float32',
  'bfloat16' or 'float16', the three the JAX package computes in).
- ``sum_dtype`` and ``stream_dtype``: the dtypes the plain versions sum
  and the convs stream rows at.  Both keep float64 rows float64: a state
  and features cast to float64 (``convert.py:state_as``) run the plain
  versions on the CPU in float64, a diagnostic that tells a sum's order
  from a fault (``tools/link_hold_probe_torch.py --f64``).  float64 is not
  a compute dtype: ``COMPUTE_DTYPES`` has no entry for it, and the CUDA
  kernels refuse it by name.

``vq_backend`` keeps the JAX package's values: 'pallas'/'pallas_fast' select
the hand-written CUDA kernels (exact / bf16-operand mode), 'xla'/'xla_fast'
the plain PyTorch path, 'scan' the plain assignment over row chunks (no
[nb, B, M] tile), and 'auto' resolves to 'pallas_fast' on CUDA and 'xla' on
the CPU (mirroring ``vq_gnn_tpu/nn/model.py:91-98``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

VQ_BACKENDS = ("auto", "xla", "xla_fast", "scan", "pallas", "pallas_fast")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- model ----
    num_layers: int = 3
    hidden_channels: int = 128
    conv_type: str = "GCN"  # GCN | SAGE | GAT
    skip: bool = False
    act: str = "leaky_gelu"  # relu | elu | leaky_gelu
    bn_flag: bool = True
    dropout: float = 0.0
    alpha_dropout_flag: bool = False
    dropbranch: float = 0.0
    transformer_flag: bool = False

    # ---- VQ ----
    num_M: int = 256
    num_D: int = 4
    grad_scale: Tuple[float, float] = (1.0, 1.0)
    momentum: float = 0.1  # grad-BN running-stat momentum
    commitment_cost: float = 0.0
    ema_decay: float = 0.99
    ema_epsilon: float = 1e-24
    warm_up_flag: bool = True  # Laplace smoothing of EMA cluster sizes
    kmeans_init: bool = False
    kmeans_iter: int = 100
    split: bool = True
    ema_flag: bool = True
    # 'reference' freezes codebooks after the init sweep (the reference's
    # dead hooks); 'live' runs the joint feature+grad EMA update every step
    vq_update_mode: str = "live"
    # 'bbprime' (v2 "B + B'") or 'bm' (v1 "B + M")
    formulation: str = "bbprime"
    recovery_flag: bool = True

    # ---- sampler ----
    sampler_type: str = "node"  # node | edge | rw | cont | cluster
    batch_size: int = 10000
    test_batch_size: int = 60000
    num_parts: int = 1
    walk_length: int = 5
    cont_sliding_window: int = 1

    # ---- training ----
    lr: float = 0.01
    epochs: int = 500
    warm_up: bool = True
    warm_up_epochs: float = 0.0
    sche: bool = False
    clip: Optional[Sequence[float]] = None
    ce_only: bool = False
    exact_eval_train_edges: bool = False
    exact_minibatch: bool = False
    runs: int = 1
    log_steps: int = 1
    seed: int = 0

    # ---- data ----
    dataset: str = "arxiv"
    data_root: str = "./datasets"

    # ---- static-shape padding and kernel selection ----
    pad_multiple_nodes: int = 4096
    pad_multiple_edges: int = 16384
    spmm_backend: str = "ell"  # ell | coo
    ell_K: int = 8
    ell_Kt: int = 0  # mixed-K tail width (0 = single-K layout)
    vq_backend: str = "auto"
    compute_dtype: str = "float32"
    matmul_precision: str = "highest"  # highest | default
    # data-parallel ranks (parallel/multihost.py): 0 = every rank of the
    # process group; another value must equal the group's size
    mesh_data: int = 0
    # fixed pad sizes (0 = monotone high-water buckets); every rank of a
    # data-parallel run sets them, so that all batches share one B_pad
    fixed_B_pad: int = 0
    fixed_Bp_pad: int = 0
    fixed_E_pad: int = 0

    def __post_init__(self):
        if self.conv_type not in ("GCN", "SAGE", "GAT"):
            raise ValueError(f"conv_type {self.conv_type!r} not supported")
        if self.act not in ("relu", "elu", "leaky_gelu"):
            raise ValueError("Activation not supported!")
        if self.sampler_type not in ("node", "edge", "rw", "cont", "cluster"):
            raise ValueError("Sampler type not supported!")
        if self.vq_update_mode not in ("reference", "live"):
            raise ValueError("vq_update_mode must be 'reference' or 'live'")
        if self.formulation not in ("bbprime", "bm"):
            raise ValueError("formulation must be 'bbprime' or 'bm'")
        if self.num_M > 32767:
            # c_indices is int16 (reference models.py v2:27-28)
            raise ValueError("num_M must fit int16 (<= 32767)")
        if self.hidden_channels % self.num_D != 0:
            raise ValueError("Cannot fully split hidden features")
        if self.vq_backend not in VQ_BACKENDS:
            raise ValueError(f"vq_backend must be one of {VQ_BACKENDS}")
        if self.matmul_precision not in ("highest", "default"):
            raise ValueError("matmul_precision must be 'highest' or 'default'")


def num_branches(channels: int, num_D: int) -> int:
    if channels % num_D != 0:
        raise ValueError("Cannot fully split")
    return channels // num_D


def no_reference_path(what: str) -> NotImplementedError:
    """The error of a combination the JAX package cannot run either: the
    port has no path of its own for it."""
    return NotImplementedError(f"{what}: the JAX package has no such path, nor has the port")


def check_ported(cfg: Config) -> None:
    """Raise for any setting the port has no path for, so that no option is
    silently ignored: a compute dtype other than the JAX package's three."""
    torch_dtype(cfg.compute_dtype)


def torch_dtype(compute_dtype: str) -> torch.dtype:
    """The ``torch.dtype`` of a ``Config.compute_dtype``; any other than
    'float32', 'bfloat16' and 'float16' raises by name."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise no_reference_path(f"compute_dtype={compute_dtype!r}")
    return COMPUTE_DTYPES[compute_dtype]


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain versions sum values of ``dtype`` in: f32 for
    f32, bf16 and f16, float64 for float64 (the module docstring)."""
    return torch.promote_types(dtype, torch.float32)


def stream_dtype(compute_dtype: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype a conv streams its input rows of ``dtype`` at:
    ``compute_dtype``'s, or float64 where f32 compute meets float64 rows
    (the module docstring)."""
    if dtype == torch.float64 and compute_dtype == "float32":
        return dtype
    return torch_dtype(compute_dtype)


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None`` means ``cuda``.  Asking for CUDA without a GPU raises: the
    port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_vq_backend(backend: str, device: torch.device) -> str:
    """'auto' -> 'pallas_fast' (the CUDA kernels, bf16 operands) on CUDA,
    'xla' (the plain exact path) on the CPU."""
    if backend != "auto":
        return backend
    return "pallas_fast" if device.type == "cuda" else "xla"


def apply_matmul_precision(cfg: Config) -> None:
    """'highest' keeps f32 matmuls and convolutions exact (TF32 off, the
    counterpart of JAX's 'highest'); 'default' lets both use TF32."""
    allow = cfg.matmul_precision == "default"
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
