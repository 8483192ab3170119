"""Yi-34B [arXiv:2403.04652; hf]: llama-arch GQA.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000."""
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="yi-34b", n_layers=60, d_model=7168, n_heads=56,
        n_kv_heads=8, d_head=128, d_ff=20480, vocab=64000,
        ffn="swiglu", rope="rope", rope_theta=5e6, subquadratic=False)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="yi-34b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
        ffn="swiglu", chunk_q=16)
