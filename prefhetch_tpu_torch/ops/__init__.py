"""Tensor ops of the triage search and their hand-written CUDA kernels."""
