"""chunk_extras_share.train: the host seconds of the program's spans
between chunks of steps (``train.readback``, the chunk's one wait for its
losses; ``train.log``; ``train.validate``; ``train.checkpoint``) over the
traced sub-window's wall seconds, in %."""

from portbench.spans import share_of_window


def read(run):
    return share_of_window(run, "train.readback", "train.log", "train.validate", "train.checkpoint")
