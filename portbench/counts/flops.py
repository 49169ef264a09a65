"""Model FLOPs a beat (a frozen copy of ``core/flops.py``'s counts): a
multiply-add is 2 FLOPs, only matmuls and convolutions count, a training
step is 3x the forward."""


def lstm_layer_fwd(T: int, d_in: int, d_h: int) -> int:
    return 2 * T * 4 * d_h * (d_in + d_h)


def lstm_ae_fwd(T: int = 320, latent: int = 10, h1: int = 128, h2: int = 64) -> int:
    """Encoder 1 -> h1 -> h2 -> latent, decoder latent -> h2 -> h1 -> 1, the
    1 x 1 output layer."""
    return (lstm_layer_fwd(T, 1, h1) + lstm_layer_fwd(T, h1, h2) + lstm_layer_fwd(T, h2, latent)
            + lstm_layer_fwd(T, latent, h2) + lstm_layer_fwd(T, h2, h1) + lstm_layer_fwd(T, h1, 1) + 2 * T)


def _conv(k: int, c_in: int, c_out: int, l_out: int) -> int:
    return 2 * k * c_in * c_out * l_out


def conv_ae_fwd(latent: int = 10, channels=(16, 32, 64, 128)) -> int:
    """The conv AE at T = 320 with the encoder's ``channels`` (the decoder
    mirrors them); transposed convolutions over their input length."""
    c0, c1, c2, c3 = channels
    enc = (_conv(3, 1, c0, 160) + _conv(3, c0, c1, 40) + _conv(3, c1, c2, 10) + _conv(3, c2, c3, 3)
           + _conv(1, c3, latent, 1))
    dec = (_conv(1, latent, c3, 1) + _conv(3, c3, c2, 3) + _conv(3, c2, c1, 10) + _conv(3, c1, c0, 40)
           + _conv(3, c0, 1, 160))
    return enc + dec


def fwd_per_beat(config: dict) -> int:
    if config["model_class"] == "LSTMAutoencoder":
        h1, h2 = config["hidden_sizes"]
        return lstm_ae_fwd(config["beat_length"], config["latent_size"], h1, h2)
    return conv_ae_fwd(config["latent_size"], tuple(config["channels"]))


def train_per_beat(config: dict) -> int:
    return 3 * fwd_per_beat(config)
