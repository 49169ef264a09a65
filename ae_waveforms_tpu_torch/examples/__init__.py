"""Runnable examples of the port (``python -m ae_waveforms_tpu_torch.examples.run_e2e``)."""
