"""step_ms.dl: mean host milliseconds of the program's ``dl.step`` span,
one stacked step of the DL classifier's seeds (each seed's forward and
backward, then the foreach Adam), over the steps of the traced
sub-window."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms("dl.step")
