"""The model substrate, ported from ``repro.models``.

  layers      — norms, dense init, the four dense FFN kinds, chunked scan
  positional  — RoPE, M-RoPE, sinusoidal embeddings
  attention   — GQA projections, causal attention, cached decode step
  moe         — the MoE FFN and its sort-based dispatch plan
  rwkv        — RWKV-6 time mix and channel mix
  griffin     — the RG-LRU recurrent block (RecurrentGemma)
  transformer — the decoder stack: init (serving and trainable builds),
                forward, loss_fn, prefill, decode_step

The optimizer lives in ``repro_torch.optim``, the train step in
``repro_torch.launch.steps``.
"""
