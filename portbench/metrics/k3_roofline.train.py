"""k3_roofline.train: K3's least time (``counts/kernels.k3_encoder`` at each
traced launch's rows: the validation batches of the traced sub-window)
over its traced device time, in %."""

from portbench.counts.kernels import k3_encoder
from portbench.readers import roofline


def read(run):
    rows = run.records.get("k3_rows")
    return roofline(run, [dict(B=b) for b in rows] if rows else None, "lstm_encoder_kernel", k3_encoder)
