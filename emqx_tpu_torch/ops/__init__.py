"""Host encoders, device state and the hand-written CUDA kernels of the
batched match path."""
