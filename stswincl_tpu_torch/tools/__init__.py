"""Measurement scripts for the port; each needs a CUDA card."""
