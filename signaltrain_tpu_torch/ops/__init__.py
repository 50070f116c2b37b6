"""Front-end operators and the CUDA kernels with their plain versions."""
