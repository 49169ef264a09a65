"""train_mfu: model FLOPs of the beats the timed ``main_train`` call trained
(3x the forward a beat, ``counts/flops.py``) over the call's wall time, as a
% of the card's float32 peak."""

from portbench.readers import mfu


def read(run):
    return mfu(run)
