"""kernel_call_host_ms.gbt: mean host milliseconds of the program's
``gbt.hist`` and ``gbt.route`` spans, one call of the histogram or the
routing kernel (checks, plan, launch), over the traced trees' levels."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms("gbt.hist", "gbt.route")
