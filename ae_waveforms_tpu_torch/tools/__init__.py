"""Measurement tools for the port's kernels, run on a machine with the card."""
