"""signaltrain_tpu_torch: the PyTorch + CUDA port of signaltrain_tpu.

The JAX package (`signaltrain_tpu`) is the reference; this package computes
the same functions with PyTorch for the plain tensor code and hand-written
CUDA C++ kernels (built for Hopper, `sm_90a`) wherever the JAX package used a
Pallas TPU kernel. It imports neither JAX nor anything of `signaltrain_tpu`.

Every entry point takes an explicit `device` and defaults to ``"cuda"``; the
plain PyTorch versions of the kernels run only for tensors on the CPU
(``device="cpu"``), never as a fallback for a CUDA tensor.

What is ported: serving (checkpoint loading, the model, long-audio
inference), training on synthesized data for every synthesized effect and on
audio-file datasets (`data.file_data`, `cli.gen_dataset` with its device and
host backends), the dataset tools, the DCT and FNN front-ends, and the
visualization and demo tools; ROADMAP.md lists what is not.

The reference's package surface (`import signaltrain as st; st.audio...`)
is mirrored as the JAX package mirrors it: st.audio, st.datasets,
st.io_methods, st.learningrate, st.loss_functions, st.nn_proc, st.misc and
st.train resolve lazily (PEP 562), so a bare import stays light.
"""

import importlib

__version__ = "0.1.0"

_SUBMODULES = (
    "audio", "datasets", "io_methods", "learningrate", "loss_functions",
    "nn_proc", "misc", "train",
)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
