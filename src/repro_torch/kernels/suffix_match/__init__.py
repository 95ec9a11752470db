"""Batched suffix-match drafting over a packed forest (CUDA kernel +
plain version)."""
