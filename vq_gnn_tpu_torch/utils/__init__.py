"""Host-side utilities: run logging, the evaluation metrics, the step profile
and the VQ-health diagnostics."""
