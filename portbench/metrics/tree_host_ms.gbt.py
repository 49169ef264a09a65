"""tree_host_ms.gbt: host milliseconds a tree of the program's per-tree
spans: the Σ host seconds of ``gbt.masks`` (where the program has it),
``gbt.grad`` and ``gbt.leaves`` over the count of ``gbt.leaves``, the
traced trees (a sub-window opens after a tree's ``gbt.grad`` and closes
after the next tree's, so each span counts once a traced tree)."""

from portbench.spans import span_stats

NAMES = ("gbt.masks", "gbt.grad", "gbt.leaves")


def read(run):
    stats = span_stats()
    trees = stats["gbt.leaves"].count if "gbt.leaves" in stats else 0
    if trees <= 0:
        return None
    return 1e3 * sum(stats[name].total_s for name in NAMES if name in stats) / trees
