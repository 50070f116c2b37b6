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
audio-file datasets (`data.file_data`, `cli.gen_dataset`), and the dataset
tools; ROADMAP.md lists what is not.
"""

__version__ = "0.1.0"
