"""Architecture registry: the reference's 10 assigned configs, each
with its reduced smoke twin.

Port of ``repro.configs.registry``.  Each config is a copy of the
reference's file (``repro/configs/<name>.py``), its dtypes as
``torch.dtype``.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen2_vl_7b", "yi_34b", "qwen2_72b", "nemotron_4_15b", "yi_6b",
    "rwkv6_7b", "mixtral_8x7b", "kimi_k2_1t_a32b", "musicgen_large",
    "recurrentgemma_2b",
]
#: the architectures the port runs: all of them
PORTED = list(ARCH_IDS)

# shape set shared by all LM archs (assignment):
SHAPES = {
    "train_4k":    {"seq_len": 4096,   "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768,  "global_batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq_len": 32768,  "global_batch": 128, "kind": "decode"},
    "long_500k":   {"seq_len": 524288, "global_batch": 1,   "kind": "decode"},
}


def _module(arch_id: str):
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str):
    return _module(arch_id).config()


def smoke_config(arch_id: str):
    return _module(arch_id).smoke()


def shape_applicable(cfg, shape_name: str) -> bool:
    """long_500k needs sub-quadratic attention."""
    if shape_name == "long_500k":
        return cfg.subquadratic
    return True
