"""Kernels of the port.

``window_reduce``, ``fused_tick``, ``hilbert``, ``armatch`` and
``decode_attn`` each pair a hand-written CUDA kernel for Hopper
(``csrc/``, built by ``build.py``) with a plain PyTorch version;
``dedupe_window`` is plain PyTorch on both devices, as its reference
has no Pallas kernel.  ``stage_mark`` replaces no kernel of the
reference: it is the tracer's device time stamp, built only when a
tracer marks.

  window_reduce — sliding-window reduction (staged stream tick)
  fused_tick    — window + features + rule sweep (fused stream tick)
  hilbert       — batched Hilbert SFC index (content routing)
  armatch       — Associative-Rendezvous profile matching
  decode_attn   — GQA decode attention against a KV cache (serving)
  stage_mark    — a stage's device time stamp in a captured tick (obs)
"""
