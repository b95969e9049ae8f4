"""Kernel wrappers with their plain PyTorch versions, and the bicubic resize."""
