"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064; M-RoPE,
dynamic-resolution vision frontend STUBBED (input_specs provides
precomputed patch embeddings merged at masked positions)."""
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b", n_layers=28, d_model=3584, n_heads=28,
        n_kv_heads=4, d_head=128, d_ff=18944, vocab=152064,
        ffn="swiglu", qkv_bias=True, rope="mrope",
        mrope_sections=(16, 24, 24), rope_theta=1e6,
        vlm=True, modality="vision", subquadratic=False)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
        ffn="swiglu", qkv_bias=True, rope="mrope", mrope_sections=(2, 3, 3),
        vlm=True, modality="vision", chunk_q=16)
