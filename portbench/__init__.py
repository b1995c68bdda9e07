"""Benchmark of the PyTorch and CUDA port (meshdqn_tpu_torch)."""
