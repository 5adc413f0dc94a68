"""Host-side utilities: run logging, the step profile and the VQ-health
diagnostics."""
