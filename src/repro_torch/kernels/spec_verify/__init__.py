"""Spec-verify flash-decode attention (CUDA kernel + plain version)."""
