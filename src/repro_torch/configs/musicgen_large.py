"""MusicGen-large [arXiv:2306.05284; hf]: decoder-only over EnCodec
tokens (EnCodec frontend is the STUB — inputs are codec token ids).

48L d_model=2048 32H (kv=32 -> MHA) d_ff=8192 vocab=2048; sinusoidal
positions, plain GELU FFN, LayerNorm (audiocraft decoder conventions)."""
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=32, d_head=64, d_ff=8192, vocab=2048,
        ffn="gelu", norm="layernorm", rope="none", pos_emb="sinusoidal",
        modality="audio", subquadratic=False)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=128,
        ffn="gelu", norm="layernorm", rope="none", pos_emb="sinusoidal",
        modality="audio", chunk_q=16)
