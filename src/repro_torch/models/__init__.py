"""The model substrate, ported from ``repro.models`` (dense layers only).

  layers      — norms, dense init, the four dense FFN kinds
  positional  — RoPE, M-RoPE, sinusoidal embeddings
  attention   — GQA projections, causal attention, cached decode step
  transformer — the decoder stack: init, forward, prefill, decode_step

The MoE, RWKV6 and RG-LRU layers are not ported yet (ROADMAP item 13).
"""
