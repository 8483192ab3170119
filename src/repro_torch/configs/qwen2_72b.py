"""Qwen2-72B [arXiv:2407.10671; hf]: GQA with QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064."""
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-72b", n_layers=80, d_model=8192, n_heads=64,
        n_kv_heads=8, d_head=128, d_ff=29568, vocab=152064,
        ffn="swiglu", qkv_bias=True, rope="rope", rope_theta=1e6,
        subquadratic=False)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-72b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=160, vocab=256,
        ffn="swiglu", qkv_bias=True, chunk_q=16)
