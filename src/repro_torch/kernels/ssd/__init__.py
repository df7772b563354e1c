"""Mamba-2 SSD scan: a CUDA kernel for Hopper, its plain versions, and the dispatch."""
