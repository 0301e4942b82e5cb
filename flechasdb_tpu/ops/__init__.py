"""Device compute kernels (JAX/XLA, one Pallas kernel for NVIDIA GPUs)."""
