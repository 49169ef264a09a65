"""k1_roofline.gbt: K1's least time over its traced device time, in %: each
traced launch's bytes and operations (``counts/kernels.k1_hist``) at the
card's peaks."""

from portbench.counts.kernels import k1_hist
from portbench.readers import roofline


def read(run):
    return roofline(run, run.records.get("k1_launches"), "gbt_hist_kernel", k1_hist)
