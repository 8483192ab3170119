"""``obs.costmodel.analyze`` on ``meta`` tensors, as the dry run uses it.

* A composite operation that reaches the counter whole (``matmul`` and
  ``einsum`` under ``torch.inference_mode()``, where autograd does not
  decompose them) is counted by its decomposition: the same FLOPs as
  outside inference mode.
* On ``meta`` tensors the counter runs a call once for each key of
  operation, shapes, strides, dtypes and other arguments and rebuilds a
  repeat's results: a whole step counted on ``meta`` gives the FLOPs,
  bytes and transcendentals of the same step run on CPU tensors, for a
  dense, a MoE and both recurrent families, train, prefill and decode.
"""
import pytest
import torch

from repro_torch import optim
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as T
from repro_torch.obs import costmodel

#: (kind, batch, sequence) of the small steps
STEPS = (("train", 2, 16), ("prefill", 2, 32), ("decode", 2, 24))
KEYS = ("flops", "bytes_accessed", "transcendentals")


@pytest.mark.parametrize("op", ["matmul", "einsum"])
def test_composites_count_the_same_under_inference_mode(op):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, generator=g)
    w = torch.randn(8, 16, generator=g)

    def f():
        return x @ w if op == "matmul" else torch.einsum("md,dn->mn", x, w)

    with torch.inference_mode():
        inside = costmodel.analyze(f)
    outside = costmodel.analyze(f)
    assert inside["flops"] == outside["flops"] == 2 * 4 * 8 * 16


def _on_cpu(tree, gen):
    """``tree``'s ``meta`` tensors as CPU tensors: floats drawn from
    ``gen``, integers and flags zero."""
    if isinstance(tree, dict):
        return {k: _on_cpu(v, gen) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_cpu(v, gen) for v in tree)
    if tree.is_floating_point():
        return torch.randn(tree.shape, generator=gen).to(tree.dtype)
    return torch.zeros(tree.shape, dtype=tree.dtype)


def _cost(cfg, kind: str, b: int, s: int, device: str) -> dict:
    args = {"train": lambda: (SP.train_batch_spec(cfg, b, s),),
            "prefill": lambda: (SP.prefill_batch_spec(cfg, b, s),),
            "decode": lambda: SP.decode_specs(cfg, b, s)}[kind]()
    if device == "meta":
        model = SP.params_spec(cfg)
    else:
        args = _on_cpu(args, torch.Generator().manual_seed(1))
        model = T.init_params(cfg, seed=0, device="cpu", trainable=True)
    if kind == "train":
        opt_cfg = optim.AdamWConfig()
        step = steps_mod.build_train_step(cfg, opt_cfg)
        c = costmodel.analyze(step, model, optim.init(model, opt_cfg), *args)
    elif kind == "prefill":
        c = costmodel.analyze(steps_mod.build_prefill_step(cfg), model, *args)
    else:
        c = costmodel.analyze(steps_mod.build_serve_step(cfg), model, *args)
    return {k: c[k] for k in KEYS}


@pytest.mark.parametrize("arch", ["yi_6b", "mixtral_8x7b", "rwkv6_7b",
                                  "recurrentgemma_2b"])
def test_meta_counts_equal_cpu_counts(arch):
    cfg = smoke_config(arch)
    for kind, b, s in STEPS:
        meta = _cost(cfg, kind, b, s, "meta")
        cpu = _cost(cfg, kind, b, s, "cpu")
        assert meta == cpu, (kind, meta, cpu)
        assert meta["flops"] > 0 and meta["bytes_accessed"] > 0
