from vq_gnn_tpu_torch.nn.vq import VQParams, VQState, feature_update, init_vq_state, lookup, vq_update

__all__ = ["VQParams", "VQState", "init_vq_state", "feature_update", "vq_update", "lookup"]
