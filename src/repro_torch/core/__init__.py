"""Paper core: fleet, allocation policies and billing (PyTorch)."""
