"""Elementwise losses and the hand-written device kernels with their plain
PyTorch versions."""
