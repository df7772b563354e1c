"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The layout mirrors ``src/repro`` file for file: ``repro_torch/models/attention.py``
is the counterpart of ``repro/models/attention.py``.  The port imports
``torch``, ``numpy`` and the standard library only, never ``jax`` and never a
module of ``repro``.  Its entry points (``launch.serve.build_engine``,
``build_model(cfg).init``, ``serving.engine.FleetEngine``) run on ``cuda``
unless the caller passes ``device="cpu"``; without a CUDA device they raise.
"""
