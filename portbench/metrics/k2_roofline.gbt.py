"""k2_roofline.gbt: K2's least time over its traced device time in the
fit, in % (``counts/kernels.k2_route`` a launch)."""

from portbench.counts.kernels import k2_route
from portbench.readers import roofline


def read(run):
    return roofline(run, run.records.get("k2_launches"), "gbt_route_kernel", k2_route)
