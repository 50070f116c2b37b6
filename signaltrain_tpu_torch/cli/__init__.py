"""Command-line tools, run as ``python -m signaltrain_tpu_torch.cli.<tool>``."""
