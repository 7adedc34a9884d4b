"""PyTorch/CUDA port of the repro package for one NVIDIA H100.

It imports torch, numpy and the standard library, never jax and never
repro.  See README.md, section "The PyTorch/H100 port".
"""
