"""Memory-bounded causal flash attention (CUDA kernels, forward and backward, and plain versions)."""
