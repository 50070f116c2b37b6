"""Reference-API facade for signaltrain.loss_functions."""

from .training.loss import calc_loss, freq_scale, logcosh, mae, mse  # noqa: F401
