"""Reference-API facade for signaltrain.learningrate (learningrate.py)."""

from .training.schedule import one_cycle_fn, one_cycle_lut  # noqa: F401


def get_1cycle_schedule(lr_max=1e-3, n_data_points=8000, epochs=200, batch_size=40):
    """The learning-rate and momentum look-up tables (learningrate.py:14-52)."""
    return one_cycle_lut(lr_max=lr_max, n_data_points=n_data_points, epochs=epochs,
                         batch_size=batch_size)
