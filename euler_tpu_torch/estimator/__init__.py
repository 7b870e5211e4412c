"""Estimator of the port (the inference half in this slice)."""
