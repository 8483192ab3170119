"""Mixtral-8x7B [arXiv:2401.04088; hf]: 8-expert top-2 MoE + SWA.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, window 4096.
SWA bounds the KV cache -> long_500k RUNS (windowed cache)."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=14336, vocab=32000,
        ffn="moe", moe=MoEConfig(num_experts=8, top_k=2, d_ff=14336),
        window=4096, rope="rope", rope_theta=1e6, subquadratic=True)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
        ffn="moe", moe=MoEConfig(num_experts=4, top_k=2, d_ff=128),
        window=32, chunk_q=16)
