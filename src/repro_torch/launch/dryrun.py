"""Multi-pod dry run: what each (architecture x input shape x mesh) cell
would hold and do on a 16 x 16 (or 2 x 16 x 16) mesh of H100s.

Port of ``repro.launch.dryrun``, analytic where the reference lowers
and compiles:

* per-device bytes of the parameters, the AdamW state (train) and the
  decode caches (decode), from ``launch.sharding``'s rules and each
  tensor's shard on the mesh (``sharding.shard_shape``), exact;
* ``flops`` and ``bytes``: ``obs.costmodel.analyze`` of the step on
  ``meta`` tensors, the whole (unsharded) program -- the deploy step
  with ``num_microbatches``, or with ``--probe`` the per-kind probes
  of ``launch.probe`` (one microbatch);
* ``collectives`` (per device, by kind), ``collective_bytes`` (the
  whole program's) and ``collective_groups`` (the mesh axes each kind
  runs over): ``launch.partition``'s collectives, counted in the same
  pass from ``launch.sharding``'s specs;
* ``model_flops`` (6*N*D train, 2*N*D otherwise, N the active
  parameters), the roofline at the H100 constants of ``launch.mesh``
  (all three terms) and ``useful_flops_ratio``.

Nothing here runs on a card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_34b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --probe
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

from repro_torch.configs.registry import (ARCH_IDS, SHAPES, get_config,
                                          shape_applicable)
from repro_torch.launch import probe as probe_mod
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.probe import opt_spec as _opt_spec

NOTES = ("flops and bytes: obs.costmodel.analyze of the whole (unsharded) "
         "step on meta tensors; collectives: launch.partition's placements, "
         "seeded from launch.sharding's specs and propagated forward through "
         "the same pass, each collective counted on its own in launch.hlo's "
         "operand convention, where XLA propagates both ways and merges "
         "independent collectives into one op")


def model_flops(cfg, shape_name: str) -> float:
    """6*N*D (dense) / 6*N_active*D for MoE; decode: D = batch tokens."""
    pspec = specs_mod.params_spec(cfg)
    total = sum(p.numel() for p in pspec.parameters())
    active = total
    if cfg.ffn == "moe":
        sizes = dict(pspec.named_parameters())
        expert = sum(sizes[n].numel()
                     for n, (path, _) in shd.param_paths(cfg, pspec).items()
                     if "['moe']['w_" in path)
        active = total - expert + expert * cfg.moe.top_k / cfg.moe.num_experts
    sh = SHAPES[shape_name]
    tokens = sh["global_batch"] * (sh["seq_len"] if sh["kind"] != "decode"
                                   else 1)
    mult = 6.0 if sh["kind"] == "train" else 2.0
    return mult * active * tokens


def _device_bytes(tensors: dict, specs: dict, mesh) -> int:
    """Bytes one device holds of ``tensors`` laid out by ``specs``."""
    return sum(math.prod(shd.shard_shape(tuple(t.shape), specs[k], mesh))
               * t.element_size() for k, t in tensors.items())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix, tree


def device_bytes(cfg, shape_name: str, mesh) -> dict:
    """Per-device bytes of the cell's parameters, AdamW state (train)
    and decode caches (decode) under ``launch.sharding``'s rules."""
    kind, args = specs_mod.input_specs(cfg, shape_name)
    pspec = specs_mod.params_spec(cfg)
    psh = shd.param_shardings(cfg, mesh, pspec)
    out = {"param_bytes_per_device": _device_bytes(
        dict(pspec.named_parameters()), psh, mesh)}
    if kind == "train":
        ospec, _ = _opt_spec(cfg, pspec)
        osh = shd.opt_shardings(psh)
        out["opt_bytes_per_device"] = (
            _device_bytes(ospec.m, osh.m, mesh)
            + _device_bytes(ospec.v, osh.v, mesh)
            + _device_bytes({"step": ospec.step}, {"step": osh.step}, mesh))
    if kind == "decode":
        out["cache_bytes_per_device"] = _device_bytes(
            dict(_flat(args[1])),
            dict(_flat(shd.cache_shardings(cfg, mesh, args[1]))), mesh)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             *, num_microbatches: int = 8, sequence_shard: bool = True,
             probe: bool = False, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not shape_applicable(cfg, shape_name):
        rec["status"] = "SKIP"
        rec["reason"] = "full-attention arch: long_500k needs sub-quadratic"
        return rec
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        rec.update(device_bytes(cfg, shape_name, mesh))
        kind, args = specs_mod.input_specs(cfg, shape_name)
        mf = model_flops(cfg, shape_name)
        rec["model_flops"] = mf
        if probe and not multi_pod:
            rec["probe"] = probe_mod.probe_roofline(
                arch, shape_name, multi_pod=False,
                sequence_shard=sequence_shard, verbose=verbose)
            cost = rec["probe"]
        else:
            cost = probe_mod._lower_cost(
                cfg, kind, args, mesh, sequence_shard=sequence_shard,
                num_microbatches=num_microbatches)
            cost["roofline"] = probe_mod.roofline(
                cost["flops"], cost["bytes"], cost["collective_bytes"],
                mesh.size)
        rec["flops"], rec["bytes"] = cost["flops"], cost["bytes"]
        rec["collectives"] = cost["collectives"]
        rec["collective_bytes"] = cost["collective_bytes"]
        if "groups" in cost:
            rec["collective_groups"] = cost["groups"]
        rec["roofline"] = cost["roofline"]
        rec["analyze_s"] = round(time.time() - t0, 1)
        rec["notes"] = NOTES
        rec["useful_flops_ratio"] = mf / rec["flops"] if rec["flops"] else None
        rec["status"] = "OK"
    except Exception as e:
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-3000:]
    if verbose:
        flat = {k: rec.get(k) for k in
                ("arch", "shape", "mesh", "status", "analyze_s", "flops",
                 "collective_bytes")}
        print(json.dumps(flat), flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--no-sequence-shard", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="count with the per-kind probes (single-pod only)")
    ap.add_argument("--out", default="reports/dryrun")
    args = ap.parse_args()

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp,
                               num_microbatches=args.microbatches,
                               sequence_shard=not args.no_sequence_shard,
                               probe=args.probe)
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "FAIL":
                    print(rec["error"])
                    print(rec.get("traceback", "")[-1500:])


if __name__ == "__main__":
    main()
