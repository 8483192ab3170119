"""RecurrentGemma-2B [arXiv:2402.19427; hf]: Griffin — RG-LRU + local
attention, 2:1 pattern.  26L d_model=2560 10H (MQA kv=1, d_head=256)
d_ff=7680 vocab=256000, local window 2048, GeGLU.
Sub-quadratic (recurrence + bounded window) -> long_500k RUNS."""
from repro_torch.models.griffin import RGLRUConfig
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-2b", n_layers=26, d_model=2560, n_heads=10,
        n_kv_heads=1, d_head=256, d_ff=7680, vocab=256000,
        pattern=("rec", "rec", "attn"), ffn="geglu",
        window=2048, rope="rope",
        rglru=RGLRUConfig(d_rnn=2560),
        subquadratic=True)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-2b-smoke", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=1, d_head=16, d_ff=128, vocab=256,
        pattern=("rec", "rec", "attn"), ffn="geglu", window=16,
        rglru=RGLRUConfig(d_rnn=64, chunk=8), chunk_q=16)
