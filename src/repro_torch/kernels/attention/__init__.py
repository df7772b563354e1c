"""GQA attention: CUDA kernels for Hopper, their plain versions, and the dispatch."""
