"""Kimi K2 1T-A32B [arXiv:2501.kimi2; unverified, paper-table]:
trillion-parameter MoE.  61L d_model=7168 64H (GQA kv=8) per-expert
d_ff=2048, vocab=163840, 384 experts top-8 (+1 shared), first layer
dense (DeepSeek-V3-style).  bf16 params."""
import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
        n_kv_heads=8, d_head=128, d_ff=2048, vocab=163840,
        ffn="moe",
        moe=MoEConfig(num_experts=384, top_k=8, d_ff=2048,
                      num_shared_experts=1),
        first_k_dense=1, rope="rope", rope_theta=5e7,
        param_dtype=torch.bfloat16, subquadratic=False)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=32, vocab=256,
        ffn="moe",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=32, num_shared_experts=1),
        first_k_dense=1, chunk_q=16)
