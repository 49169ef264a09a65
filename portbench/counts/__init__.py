"""The benchmark's frozen counts: model FLOPs, the kernels' least times,
the GBT fit's operations and the card's peaks.  Copies, not imports, of
the program's own arithmetic (``core/flops.py``, ``chip_smoke.py``), so a
change to the program cannot move the yardstick."""
