"""Multi-agent serving engine (PyTorch)."""
