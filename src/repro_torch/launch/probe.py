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

Work is counted for the whole (unsharded) program.  Collectives are
counted by ``launch.partition`` in the same pass, from the seeds
``launch.sharding`` gives the parameters, the AdamW state, the batch and
the caches: per device, and times the mesh's devices for the whole
program (the reference's ``collective_bytes``).
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import torch

from repro_torch import optim
from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.launch import hlo as hlo_mod
from repro_torch.launch import partition as part_mod
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as specs_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (HBM_BW, ICI_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.obs import costmodel

METRICS = ("flops", "bytes", "collective_bytes")


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
                num_microbatches: int = 1, carry: tuple | None = None
                ) -> dict:
    """``analyze`` of one step of ``kind`` on ``args`` (the step's
    arguments after the parameters, ``meta`` tensors, written in place)
    with ``cfg``'s parameters on ``meta``, under a partition pass on
    ``mesh`` seeded with ``launch.sharding``'s specs: its flops and
    bytes, ``collective_bytes`` (the whole program's: per device times
    the devices), ``collectives`` (the kinds counted, per device) and
    ``groups`` (``Partition.groups``).
    Decode runs unconstrained: the layers' carry enters with ``carry``,
    or else with the placement a first pass sees it leave with
    (``shardctx.scan_carry``), returned as ``carry``."""
    pspec = specs_mod.params_spec(cfg)
    psh = shd.param_shardings(cfg, mesh, pspec)

    def seeded(carry=None):
        part = part_mod.Partition(mesh, carry)
        for name, p in pspec.named_parameters():
            part.seed(p, psh[name])
        if kind == "train":
            osh = shd.opt_shardings(psh)
            part.seed_tree(ospec.m, osh.m)
            part.seed_tree(ospec.v, osh.v)
        if kind in ("train", "prefill"):
            part.seed_tree(args[0], shd.batch_shardings(cfg, mesh, args[0]))
        else:
            tokens, caches, lengths = args
            part.seed_tree(caches, shd.cache_shardings(cfg, mesh, caches))
            bsh = shd.batch_shardings(cfg, mesh, {"tokens": tokens,
                                                  "lengths": lengths})
            part.seed(tokens, bsh["tokens"])
            part.seed(lengths, bsh["lengths"])
        return part

    if kind == "train":
        ospec, opt_cfg = opt_spec(cfg, pspec)
        step = steps_mod.build_train_step(
            cfg, opt_cfg, num_microbatches=num_microbatches, mesh=mesh,
            sequence_shard=sequence_shard)
        part = seeded()
        ca = costmodel.analyze(step, pspec, ospec, *args, partition=part)
    elif kind == "prefill":
        step = steps_mod.build_prefill_step(cfg, mesh=mesh,
                                            sequence_shard=sequence_shard)
        part = seeded()
        ca = costmodel.analyze(step, pspec, *args, partition=part)
    else:
        step = steps_mod.build_serve_step(cfg, mesh=mesh)
        if carry is None:
            first = seeded()
            costmodel.analyze(step, pspec, *args, partition=first)
            carry = first.carry_exit
        part = seeded(carry)
        ca = costmodel.analyze(step, pspec, *args, partition=part)
    coll = ca["collectives"]
    return {"flops": ca["flops"], "bytes": ca["bytes_accessed"],
            "collective_bytes": float(coll["total_bytes"]) * part.n_devices,
            "collectives": {k: v for k, v in coll.items()
                            if isinstance(v, dict) and v["count"]},
            "groups": part.groups(), "carry": carry}


def decompose(cfg, seq_len: int, cost, verbose: bool = False):
    """(P0, {kind: {"count", flops, bytes, collective_bytes}}, total) of
    ``cost(c)`` (a dict with :data:`METRICS`) over ``cfg``'s probe
    configs: total = P0 + sum_k (Pk - P0) * n_k.  Where ``cost`` gives
    ``collectives`` (per device, by kind), ``total`` has them too, each
    kind's count and bytes decomposed the same way.  Where it gives a
    ``carry`` (decode), the probe of the last layer's kind runs first and
    every probe gets its carry (``cost(c, carry=...)``), so that what
    the layers hand on is the same in each probe and in the whole step,
    and the decomposition stays exact."""
    counts = kind_counts(cfg)
    last = cfg.layer_kinds()[-1] if cfg.n_layers else None
    first = cost(probe_cfg(cfg, last, seq_len)) if last in counts else None
    carry = None if first is None else first.get("carry")

    def run(kind):
        if kind == last and first is not None:
            return first
        c = probe_cfg(cfg, kind, seq_len)
        return cost(c) if carry is None else cost(c, carry=carry)

    p0 = run(None)
    if verbose:
        print(f"  probe P0: flops={p0['flops']:.3e}", flush=True)
    total = {m: p0[m] for m in METRICS}
    coll = {k: dict(v) for k, v in p0.get("collectives", {}).items()}
    per_kind = {}
    for k, n in counts.items():
        pk = run(k)
        delta = {m: pk[m] - p0[m] for m in METRICS}
        per_kind[k] = {"count": n, **delta}
        for m in METRICS:
            total[m] += delta[m] * n
        for kind in set(pk.get("collectives", {})) | set(
                p0.get("collectives", {})):
            a = pk.get("collectives", {}).get(kind, {"count": 0, "bytes": 0})
            b = p0["collectives"].get(kind, {"count": 0, "bytes": 0})
            c = coll.setdefault(kind, {"count": 0, "bytes": 0})
            for f in ("count", "bytes"):
                c[f] += (a[f] - b[f]) * n
        if verbose:
            print(f"  probe {k} x{n}: layer flops={delta['flops']:.3e}",
                  flush=True)
    if "collectives" in p0:
        total["collectives"] = coll
    return p0, per_kind, total


def roofline(flops: float, nbytes: float, collective_bytes: float,
             n_chips: int) -> dict:
    """``hlo.roofline_terms`` at the H100 constants, the collective term
    counted (``collective_counted`` True)."""
    terms = hlo_mod.roofline_terms(
        flops, nbytes, collective_bytes, n_chips,
        peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW, ici_bw=ICI_BW)
    terms["collective_counted"] = True
    return terms


def probe_roofline(arch: str, shape_name: str, *, multi_pod: bool = False,
                   sequence_shard: bool = True, verbose: bool = True) -> dict:
    """Roofline terms for (arch x shape) on the production mesh, from
    the per-kind probes."""
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    seq = SHAPES[shape_name]["seq_len"]

    def cost(c, **kw):
        return _lower_cost(c, *specs_mod.input_specs(c, shape_name), mesh,
                           sequence_shard=sequence_shard, **kw)

    p0, per_kind, total = decompose(cfg, seq, cost, verbose)
    return {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "flops": total["flops"], "bytes": total["bytes"],
            "collective_bytes": total["collective_bytes"],
            "collectives": total["collectives"],
            "per_kind": per_kind,
            "base": {m: p0[m] for m in METRICS + ("collectives",)},
            "roofline": roofline(total["flops"], total["bytes"],
                                 total["collective_bytes"], mesh.size)}
