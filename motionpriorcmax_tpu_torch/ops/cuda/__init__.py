"""Wrappers of the hand-written CUDA kernels (JAX: ops/pallas/).

Each wrapper launches its kernel on a CUDA tensor, runs its plain PyTorch
version on a CPU tensor, and counts its launches.  Kernels are built with
nvcc on first use (`build.py`), never at import.
"""
