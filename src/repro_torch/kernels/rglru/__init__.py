"""RG-LRU linear-recurrence scan (CUDA kernel + plain version)."""
