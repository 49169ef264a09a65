"""split_host_ms.gbt: mean host milliseconds of the program's ``gbt.split``
span, the issue of a level's split epilogue (sibling subtraction, prefix
sums, gains, argmax, the split decision), over the traced trees' levels."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms("gbt.split")
