"""Model building blocks and the dense transformer (PyTorch)."""
