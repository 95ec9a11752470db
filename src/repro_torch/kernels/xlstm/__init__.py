"""xLSTM mLSTM and sLSTM recurrences (CUDA kernels, forward and backward, and plain versions)."""
