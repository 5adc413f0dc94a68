from vq_gnn_tpu_torch.train.state import TrainState
from vq_gnn_tpu_torch.train.step import StepFns, make_step_fns

__all__ = ["TrainState", "StepFns", "make_step_fns"]
