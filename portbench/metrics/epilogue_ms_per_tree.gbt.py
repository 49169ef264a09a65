"""epilogue_ms_per_tree.gbt: device milliseconds a tree (of a chunk of
fits) of every kernel in the fit other than K1 (histograms) and K2
(routing): the subsample masks, g and h, the float64 split epilogue and
the leaf sums, over the traced trees."""

K1, K2 = "gbt_hist_kernel", "gbt_route_kernel"


def read(run):
    trees = run.records.get("profiled_trees")
    if not trees or run.trace is None:
        return None
    seconds = run.trace.device_seconds(lambda name: K1 not in name and K2 not in name)
    return 1e3 * seconds / trees if seconds > 0 else None
