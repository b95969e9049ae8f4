"""Plain PyTorch references for the benchmark's check: float32, TF32 off,
``torch.nn`` layers and written-out attention; nothing of the program."""
