"""RWKV-6 "Finch" 7B [arXiv:2404.05892; hf]: attention-free,
data-dependent decay.  32L d_model=4096 d_ff=14336 vocab=65536.
64 heads x 64 head-dim (head_size 64, RWKV convention).
Sub-quadratic: O(1)-state decode -> long_500k RUNS."""
from repro_torch.models.rwkv import RWKVConfig
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b", n_layers=32, d_model=4096, n_heads=64,
        n_kv_heads=64, d_head=64, d_ff=14336, vocab=65536,
        pattern=("rwkv",), ffn="swiglu", rope="none",
        rwkv=RWKVConfig(n_heads=64, d_head=64),
        subquadratic=True)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=256,
        pattern=("rwkv",), rope="none",
        rwkv=RWKVConfig(n_heads=4, d_head=16, decay_lora=8, chunk=8),
        chunk_q=16)
