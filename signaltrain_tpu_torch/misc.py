"""Reference-API facade for signaltrain.misc (misc.py): checkpoint
save / load, the JAX package's parameter-tree mappings under its names, and
the console banner."""

from .training.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .training.checkpoint import params_to_state_dict as params_to_torch_state_dict  # noqa: F401
from .training.checkpoint import state_dict_to_params as torch_state_dict_to_params  # noqa: F401
from .utils.banner import print_choochoo  # noqa: F401
