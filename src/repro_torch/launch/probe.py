"""Loop-free roofline probes: a step's work as a sum over layer kinds.

Port of ``repro.launch.probe``.  The reference lowers loop-free twins of
a step because XLA's ``cost_analysis`` counts a while-loop body once.
The port counts with ``obs.costmodel.analyze``, which runs the step on
``meta`` tensors and sees every operation of every loop iteration, so
the decomposition is exact by construction; it is kept because it is
cheap.  A full-depth step is tens of layers of the same kind, and a
recurrence at full sequence length is thousands of eager steps a layer.

  - layers:        per-kind decomposition -- P0 (0 layers) + one-layer
                   probes per layer kind; total = P0 + sum_k (Pk - P0) * n_k
                   (exact: the layers of a kind cost the same)
  - microbatches:  K=1 (gradient accumulation adds are negligible)
  - recurrences:   cfg.probe=True -- FLOP-isomorphic, scan-free stand-in

Work is counted for the whole (unsharded) program.  Collective bytes
are not counted (``launch.dryrun`` says why): the roofline's collective
term is 0 and marked uncounted.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import torch

from repro_torch import optim
from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.launch import hlo as hlo_mod
from repro_torch.launch import specs as specs_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (HBM_BW, ICI_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.obs import costmodel

METRICS = ("flops", "bytes")


def kind_counts(cfg) -> Counter:
    c: Counter = Counter()
    for kinds, repeat in cfg.stacks():
        for k in kinds:
            c[k] += repeat
    return c


def probe_cfg(cfg, kind: str | None, seq_len: int):
    """Config of a probe of 0 layers (``kind`` None) or 1 layer of
    ``kind``, with the recurrences in probe mode.  Attention chunks stay
    at their deploy value (``seq_len`` changes nothing, as in the
    reference)."""
    upd = dict()
    if kind is None:
        upd["n_layers"] = 0
        upd["pattern"] = ("attn",)
        upd["first_k_dense"] = 0
    elif kind == "attn+dense":
        upd.update(n_layers=1, pattern=("attn",), first_k_dense=1
                   if cfg.ffn == "moe" else 0)
    elif kind == "attn+moe":
        upd.update(n_layers=1, pattern=("attn",), first_k_dense=0)
    elif kind == "rwkv":
        upd.update(n_layers=1, pattern=("rwkv",),
                   rwkv=cfg.rwkv._replace(probe=True))
    elif kind == "rec":
        upd.update(n_layers=1, pattern=("rec",),
                   rglru=cfg.rglru._replace(probe=True))
    else:
        raise ValueError(kind)
    return dataclasses.replace(cfg, **upd)


def opt_spec(cfg, pspec):
    """AdamW state of ``pspec`` on ``meta`` (moments in bfloat16 for
    bfloat16 parameters, float32 otherwise) and its config."""
    opt_cfg = optim.AdamWConfig(
        moment_dtype=torch.bfloat16 if cfg.param_dtype == torch.bfloat16
        else torch.float32)
    return optim.init(pspec, opt_cfg), opt_cfg


def _lower_cost(cfg, kind: str, args: tuple, mesh, *, sequence_shard: bool,
                num_microbatches: int = 1) -> dict:
    """``analyze`` of one step of ``kind`` on ``args`` (the step's
    arguments after the parameters, ``meta`` tensors, written in place)
    with ``cfg``'s parameters on ``meta``: its flops and bytes, and
    ``collective_bytes`` (``None``: not counted)."""
    pspec = specs_mod.params_spec(cfg)
    if kind == "train":
        ospec, opt_cfg = opt_spec(cfg, pspec)
        step = steps_mod.build_train_step(
            cfg, opt_cfg, num_microbatches=num_microbatches, mesh=mesh,
            sequence_shard=sequence_shard)
        ca = costmodel.analyze(step, pspec, ospec, *args)
    elif kind == "prefill":
        step = steps_mod.build_prefill_step(cfg, mesh=mesh,
                                            sequence_shard=sequence_shard)
        ca = costmodel.analyze(step, pspec, *args)
    else:
        step = steps_mod.build_serve_step(cfg, mesh=mesh)
        ca = costmodel.analyze(step, pspec, *args)
    return {"flops": ca["flops"], "bytes": ca["bytes_accessed"],
            "collective_bytes": None}


def decompose(cfg, seq_len: int, cost, verbose: bool = False):
    """(P0, {kind: {"count", flops, bytes}}, total) of ``cost(c)`` (a
    dict with :data:`METRICS`) over ``cfg``'s probe configs:
    total = P0 + sum_k (Pk - P0) * n_k."""
    p0 = cost(probe_cfg(cfg, None, seq_len))
    if verbose:
        print(f"  probe P0: flops={p0['flops']:.3e}", flush=True)
    total = {m: p0[m] for m in METRICS}
    per_kind = {}
    for k, n in kind_counts(cfg).items():
        pk = cost(probe_cfg(cfg, k, seq_len))
        delta = {m: pk[m] - p0[m] for m in METRICS}
        per_kind[k] = {"count": n, **delta}
        for m in METRICS:
            total[m] += delta[m] * n
        if verbose:
            print(f"  probe {k} x{n}: layer flops={delta['flops']:.3e}",
                  flush=True)
    return p0, per_kind, total


def roofline(flops: float, nbytes: float, n_chips: int) -> dict:
    """``hlo.roofline_terms`` at the H100 constants with the collective
    term uncounted (0, ``collective_counted`` False)."""
    terms = hlo_mod.roofline_terms(
        flops, nbytes, 0.0, n_chips, peak_flops=PEAK_FLOPS_BF16,
        hbm_bw=HBM_BW, ici_bw=ICI_BW)
    terms["collective_counted"] = False
    return terms


def probe_roofline(arch: str, shape_name: str, *, multi_pod: bool = False,
                   sequence_shard: bool = True, verbose: bool = True) -> dict:
    """Roofline terms for (arch x shape) on the production mesh, from
    the per-kind probes."""
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    seq = SHAPES[shape_name]["seq_len"]

    def cost(c):
        return _lower_cost(c, *specs_mod.input_specs(c, shape_name), mesh,
                           sequence_shard=sequence_shard)

    p0, per_kind, total = decompose(cfg, seq, cost, verbose)
    return {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "flops": total["flops"], "bytes": total["bytes"],
            "collective_bytes": None, "per_kind": per_kind, "base": p0,
            "roofline": roofline(total["flops"], total["bytes"], mesh.size)}
