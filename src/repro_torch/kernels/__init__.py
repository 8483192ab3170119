"""Kernels of the port.

``window_reduce`` and ``fused_tick`` each pair a hand-written CUDA
kernel for Hopper (``csrc/``, built by ``build.py``) with a plain
PyTorch version; ``dedupe_window`` is plain PyTorch on both devices,
as its reference has no Pallas kernel.
"""
