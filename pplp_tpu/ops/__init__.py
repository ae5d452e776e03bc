"""Compute kernels: modular arithmetic, NTT engines, prime chains."""
