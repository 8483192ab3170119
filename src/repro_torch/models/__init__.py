"""The model substrate, ported from ``repro.models``.

  layers      — norms, dense init, the four dense FFN kinds, chunked scan
  positional  — RoPE, M-RoPE, sinusoidal embeddings
  attention   — GQA projections, causal attention, cached decode step
  moe         — the MoE FFN and its sort-based dispatch plan
  rwkv        — RWKV-6 time mix and channel mix
  griffin     — the RG-LRU recurrent block (RecurrentGemma)
  transformer — the decoder stack: init, forward, prefill, decode_step

Training (``loss_fn`` and the optimizer) waits for ROADMAP item 13b.
"""
