"""Abstract inputs of each (architecture x shape) cell: ``meta`` tensors.

Port of ``repro.launch.specs``, whose ``ShapeDtypeStruct``s are
``meta`` tensors here: shapes and dtypes, no storage.  Modality
frontends are stubs, as in the reference: the VLM cell takes
precomputed patch embeddings and a merge mask.
"""
from __future__ import annotations

import torch

from repro_torch.configs.registry import SHAPES
from repro_torch.models import transformer as T

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_batch_spec(cfg, batch: int, seq: int) -> dict:
    spec = {"tokens": _spec((batch, seq), torch.int32),
            "labels": _spec((batch, seq), torch.int32)}
    if cfg.vlm:
        spec["vision_embeds"] = _spec((batch, seq, cfg.d_model),
                                      cfg.compute_dtype)
        spec["vision_mask"] = _spec((batch, seq), torch.bool)
        spec["mrope_positions"] = _spec((3, batch, seq), torch.int32)
    return spec


def prefill_batch_spec(cfg, batch: int, seq: int) -> dict:
    spec = train_batch_spec(cfg, batch, seq)
    del spec["labels"]
    return spec


def decode_specs(cfg, batch: int, seq: int):
    """(tokens, caches, lengths) for the serve step."""
    return (_spec((batch, 1), torch.int32),
            T.init_caches(cfg, batch, seq, META),
            _spec((batch,), torch.int32))


def input_specs(cfg, shape_name: str):
    """(kind, the step's arguments after the parameters, as ``meta``
    tensors)."""
    sh = SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    if sh["kind"] == "train":
        return "train", (train_batch_spec(cfg, b, s),)
    if sh["kind"] == "prefill":
        return "prefill", (prefill_batch_spec(cfg, b, s),)
    return "decode", decode_specs(cfg, b, s)


def params_spec(cfg) -> T.Transformer:
    """The model on ``meta``, every parameter in ``param_dtype``, as the
    reference's ``eval_shape`` of ``init_params`` gives them (the
    trainable build; the serving build casts its layers)."""
    return T.init_params(cfg, device=META, trainable=True)
