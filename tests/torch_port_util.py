"""Helpers shared by the tests of the PyTorch port (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and handed to both packages; the JAX
package runs on the CPU, the port with device="cpu" (its kernels' plain
versions).
"""

import numpy as np
import torch

# flagship and small front-end geometries (tests/test_pallas_frontend.py)
SMALL = dict(ft=64, hop=24, chunk=512)
FLAGSHIP = dict(ft=1024, hop=384, chunk=8192)


def t(a) -> torch.Tensor:
    """numpy/JAX array -> float32 CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def n(a) -> np.ndarray:
    """tensor or JAX array -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_phase_close(got, want, atol: float, rtol: float):
    """Phases compared as the wrapped difference ((d + pi) mod 2pi) - pi,
    held to atol + rtol*|want| like assert_allclose. Where im ~ 0 and
    re + 1e-7 < 0, a 1-ulp difference in im flips atan2 between +pi and -pi:
    the same angle, 2pi apart in raw value."""
    want = np.asarray(want, np.float64)
    d = np.asarray(got, np.float64) - want
    wrapped = np.abs(np.mod(d + np.pi, 2 * np.pi) - np.pi)
    excess = wrapped - (atol + rtol * np.abs(want))
    assert excess.max() <= 0, (wrapped.max(), excess.max())
