"""Host-side utilities: run logging and the step profile."""
