"""Nemotron-4-15B [arXiv:2402.16819; unverified]: GQA, squared-ReLU FFN,
LayerNorm.  32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000."""
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-15b", n_layers=32, d_model=6144, n_heads=48,
        n_kv_heads=8, d_head=128, d_ff=24576, vocab=256000,
        ffn="sq_relu", norm="layernorm", rope="rope", subquadratic=False)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-15b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=256, vocab=512,
        ffn="sq_relu", norm="layernorm", chunk_q=16)
