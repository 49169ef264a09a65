"""The device's idle share in the traced sub-windows, in %."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)
