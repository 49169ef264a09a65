"""Model FLOPs a beat of the end-to-end LSTM classifier (a frozen copy of
``core/flops.py``'s ``dl_classifier_fwd_flops_per_sample``): a
multiply-add is 2 FLOPs, only the LSTMs' and the dense layers' products
count, a training step is 3x the forward."""

from portbench.counts.flops import lstm_layer_fwd


def fwd_per_beat(config: dict) -> int:
    """LSTMs 1 -> h1 -> h2 -> h3 over T steps, the attention's score a step
    (h3 -> 1), FC h3 -> f -> 1."""
    T = config["beat_length"]
    h1, h2, h3 = config["hidden_sizes"]
    f = config["fc_sizes"][1]
    return (lstm_layer_fwd(T, 1, h1) + lstm_layer_fwd(T, h1, h2) + lstm_layer_fwd(T, h2, h3) + 2 * T * h3
            + 2 * h3 * f + 2 * f)


def train_per_beat(config: dict) -> int:
    return 3 * fwd_per_beat(config)
