"""PyTorch/CUDA port of the µP reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports none of it.
"""
