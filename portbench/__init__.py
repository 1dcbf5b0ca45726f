"""Benchmark of the PyTorch + CUDA port (``pyimsegm_tpu_torch``) on one
NVIDIA H100; see ``portbench/README.md``."""
