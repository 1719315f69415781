"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``) with their
plain torch versions."""
