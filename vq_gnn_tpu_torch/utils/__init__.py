"""Host-side utilities: run logging, the evaluation metrics, the step profile,
the VQ-health diagnostics and the learning-rate schedules."""
