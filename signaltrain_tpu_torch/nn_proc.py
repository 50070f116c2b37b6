"""Reference-API facade for signaltrain.nn_proc: model construction.

``st_model`` keeps the reference's signature (nn_proc.py:344-393:
scale_factor, shrink_factor, num_knobs, sr) and returns the ``STModel``
(``nn.Module``) on ``device``, the card by default.
"""

from .models.autoencoder import AsymAutoEncoder  # noqa: F401
from .models.mpaec import AsymMPAEC  # noqa: F401
from .models.st_model import ModelSpec, STModel, compute_spec, st_model  # noqa: F401
