"""The plain PyTorch reference of the benchmark; it imports nothing of the port."""
