"""PyTorch/CUDA port of the AFarePart reproduction.

Mirrors ``src/repro/`` module for module (``quant/``, ``kernels/``,
``core/``, ``models/``, ``data/``); the JAX package stays the reference
the port is tested against.  Every entry point takes an explicit
``device`` that defaults to ``"cuda"`` and raises when no card is
present; tests pass ``device="cpu"``.  The three fault kernels are
hand-written CUDA C++ for Hopper (``csrc/``), built by ``nvcc`` at first
use (``kernels/_build.py``).
"""
