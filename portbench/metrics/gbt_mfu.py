"""gbt_mfu: the operations the grid search's fits need for these inputs
(``counts/gbt.py``: histogram adds, split scoring over bins, routing
compares) over the calls' wall time, as a % of the card's float32 peak."""

from portbench.readers import mfu


def read(run):
    return mfu(run, "ops")
