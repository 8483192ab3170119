"""Yi-6B [arXiv:2403.04652; hf]: llama-arch GQA.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000."""
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="yi-6b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=4, d_head=128, d_ff=11008, vocab=64000,
        ffn="swiglu", rope="rope", rope_theta=5e6, subquadratic=False)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="yi-6b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
        ffn="swiglu", chunk_q=16)
