"""epoch_extras_share.dl: the host seconds of the program's spans between
the DL classifier's epochs (``dl.validate``, the AUC pass and its one wait
for the device; ``dl.select``, the best snapshot and the early-stopping
counters) over the traced sub-window's wall seconds, in %."""

from portbench.spans import share_of_window


def read(run):
    return share_of_window(run, "dl.validate", "dl.select")
