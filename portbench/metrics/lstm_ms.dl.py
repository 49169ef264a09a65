"""lstm_ms.dl: device milliseconds of cuDNN's RNN kernels a stacked step,
over the traced sub-window: its persistent LSTM kernels, forward and
backward (``RNN_blockPersist``), and the elementwise kernels of its RNN
calls, whose names carry cuDNN's RNN types (``cudnnRNN``), over the
stacked steps the sub-window holds (the driver's ``traced_steps``); None
where the trace holds no device time.  The
sub-window holds an epoch's validation too, whose forward passes count
with the steps'."""

NAMES = ("RNN_blockPersist", "cudnnRNN")


def read(run):
    steps = run.records.get("traced_steps")
    if run.trace is None or not steps or run.trace.device_seconds() <= 0:
        return None
    return 1e3 * run.trace.device_seconds(lambda name: any(n in name for n in NAMES)) / steps
