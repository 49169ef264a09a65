"""step_host_ms.train: mean host milliseconds of the program's
``train.step`` span, one training step's issue on the host (forward,
backward and optimizer), over the steps of the traced sub-window."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms("train.step")
