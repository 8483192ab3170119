"""Partition rules: parameters, batches and caches -> partition specs.

Port of ``repro.launch.sharding``.  Rules are (regex over the
reference's tree path, spec) -- first match wins.  A spec is a tuple
with one entry a dim: ``None``, a mesh axis name, or a tuple of names
(a ``PartitionSpec`` as a tuple).  The port names a parameter as its
module does (``layers.3.attn.p.wq``) and keeps one tensor a layer;
``convert`` maps each name to the reference's path
(``['stacks'][0]['pos0']['attn']['wq']``, row 3), which the rules
match.  The reference stacks a stack's layers on a leading dim that
takes a ``None`` entry; :func:`_fit` runs on that stacked shape, so
divisibility is decided as the reference decides it, and the port's
spec is the stacked one less its leading entry.  MoE expert placement
is decided per config: expert-parallel over "model" when E divides it,
else TP inside the expert FFN; the 1T-class config additionally shards
experts over "data" (ZeRO-style).

:func:`placements` turns a spec into ``DTensor`` placements on a
``DeviceMesh``; :func:`shard_shape` gives a tensor's shard on a mesh
(what the dry run's per-device bytes count).  :func:`batch_share` gives
one data rank its rows of a global batch, as :func:`batch_shardings`
lays the batch over the data axes (the train step across ranks).
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch import convert
from repro_torch.launch.mesh import (axis_sizes, data_group, data_rank,
                                     dp_axes, dp_size, model_axis)
from repro_torch.launch.shardctx import entry
from repro_torch.optim import AdamWState


def moe_axes(cfg, mesh) -> tuple:
    """Expert-parallel layout: (expert_dim_axes, ffn_dim_axes).

    - E divides model and per-chip share fits: EP over "model".
    - 1T-class (Kimi): E over "data" (ZeRO-style) x d_ff over "model".
    - few big experts (Mixtral): TP inside the expert FFN only.
    """
    sizes = axis_sizes(mesh)
    mdl = model_axis(mesh)
    dp = dp_axes(mesh)
    tp = sizes[mdl]
    e = cfg.moe.num_experts
    dp_last = dp[-1] if dp else None
    dsize = sizes[dp_last] if dp_last else 1
    if e % tp == 0 and e >= tp:
        if (dp_last and e % dsize == 0 and cfg.moe.d_ff % tp == 0
                and cfg.name.startswith("kimi")):
            return (dp_last, mdl)
        return (mdl, None)
    return (None, mdl)


def moe_compute_axes(cfg, mesh) -> tuple:
    """Expert-parallel COMPUTE layout: (expert_axes, capacity_axes) for
    the grouped bucket tensors [G, E, C, ...]: E over "model" when
    divisible, else the per-group capacity dim goes over "model"."""
    mdl = model_axis(mesh)
    if cfg.moe.num_experts % axis_sizes(mesh)[mdl] == 0:
        return (mdl, None)
    return (None, mdl)


def _param_rules(cfg, mesh) -> list[tuple[str, tuple]]:
    mdl = model_axis(mesh)
    rules: list[tuple[str, tuple]] = [
        (r"\['embed'\]$", (mdl, None)),
        (r"\['unembed'\]$", (None, mdl)),
        (r"norm.*\['scale'\]$", (None,)),
        (r"norm.*\['bias'\]$", (None,)),
        # attention
        (r"\['attn'\]\['w[qkv]'\]$", (None, mdl)),
        (r"\['attn'\]\['wo'\]$", (mdl, None)),
        (r"\['attn'\]\['b[qkv]'\]$", (mdl,)),
        # dense ffn (+ moe shared expert)
        (r"\['(ffn|shared)'\]\['w_(in|gate)'\]$", (None, mdl)),
        (r"\['(ffn|shared)'\]\['w_out'\]$", (mdl, None)),
        # rwkv
        (r"\['tmix'\]\['w[rkvg]'\]$", (None, mdl)),
        (r"\['tmix'\]\['wo'\]$", (mdl, None)),
        (r"\['tmix'\]\['w_lora_a'\]$", (None, None)),
        (r"\['tmix'\]\['w_lora_b'\]$", (None, mdl)),
        (r"\['tmix'\]\['(bonus_u|ln_scale)'\]$", (mdl, None)),
        (r"\['tmix'\]\['w_base'\]$", (mdl,)),
        (r"\['tmix'\]\['mu_.'\]$", (None,)),
        (r"\['cmix'\]\['w[kr]'\]$", (None, mdl)),
        (r"\['cmix'\]\['wv'\]$", (mdl, None)),
        (r"\['cmix'\]\['mu_.'\]$", (None,)),
        # rg-lru
        (r"\['rec'\]\['w_(gate|x)'\]$", (None, mdl)),
        (r"\['rec'\]\['conv_w'\]$", (None, mdl)),
        (r"\['rec'\]\['conv_b'\]$", (mdl,)),
        (r"\['rec'\]\['rg_w[ax]'\]$", (None, mdl)),
        (r"\['rec'\]\['rg_lambda'\]$", (mdl,)),
        (r"\['rec'\]\['w_out'\]$", (mdl, None)),
        # moe router
        (r"\['moe'\]\['router'\]$", (None, None)),
    ]
    if cfg.moe is not None:
        e_ax, f_ax = moe_axes(cfg, mesh)
        rules += [
            (r"\['moe'\]\['w_(in|gate)'\]$", (e_ax, None, f_ax)),
            (r"\['moe'\]\['w_out'\]$", (e_ax, f_ax, None)),
        ]
    rules.append((r".*", ()))     # default: replicate
    return rules


def _match(path: str, rules) -> tuple:
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return ()


def _fit(mesh, spec: tuple, shape: tuple) -> tuple:
    """Null out spec entries whose mesh-axes product doesn't divide the
    dim (explicit shardings must divide evenly -- no padding)."""
    sizes = axis_sizes(mesh)
    out = []
    for i, e in enumerate(tuple(spec)[: len(shape)]):
        if e is None:
            out.append(None)
            continue
        axes = e if isinstance(e, tuple) else (e,)
        size = 1
        for a in axes:
            size *= sizes[a]
        out.append(entry(e) if shape[i] % size == 0 else None)
    return tuple(out)


def keystr(path: tuple) -> str:
    """A reference tree path as ``jax.tree_util.keystr`` writes it:
    ``['stacks'][0]['pos0']['attn']['wq']``."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']"
                   for k in path)


def param_paths(cfg, model) -> dict:
    """Parameter name -> (the reference's path string, its stack's
    repeat or ``None`` outside the stacks), through ``convert``'s map."""
    repeats = [r for _, r in cfg.stacks()]
    names = [n for n, _ in model.named_parameters()]
    return {name: (keystr(path), None if row is None else repeats[path[1]])
            for name, path, row in convert._ref_slots(cfg, names)}


def param_shardings(cfg, mesh, params_shape) -> dict:
    """Parameter name -> spec of the port's tensor.  ``params_shape``:
    a model (``specs.params_spec``'s ``meta`` one will do)."""
    rules = _param_rules(cfg, mesh)
    shapes = {n: tuple(p.shape) for n, p in params_shape.named_parameters()}
    out = {}
    for name, (path, repeat) in param_paths(cfg, params_shape).items():
        spec = _match(path, rules)
        if repeat is None:
            out[name] = _fit(mesh, spec, shapes[name])
        else:     # the reference's stacked leaf: a leading repeat dim
            out[name] = _fit(mesh, (None,) + tuple(spec),
                             (repeat,) + shapes[name])[1:]
    return out


def opt_shardings(param_sh: dict) -> AdamWState:
    """AdamW state: moments shard like params, step replicated."""
    return AdamWState(m=param_sh, v=param_sh, step=())


def batch_shardings(cfg, mesh, batch_shape: dict) -> dict:
    dp = dp_axes(mesh)
    out = {}
    for k, v in batch_shape.items():
        if k == "mrope_positions":
            spec = (None, dp, None)
        else:
            spec = (dp,) + (None,) * (v.dim() - 1)
        out[k] = _fit(mesh, spec, tuple(v.shape))
    return out


def _batch_rows(batch: dict) -> int:
    """The rows (sequences) of a batch: axis 0 of each leaf, axis 1 of
    the ``[3, B, T]`` M-RoPE position streams; every leaf must agree."""
    rows = {k: v.shape[1 if k == "mrope_positions" else 0]
            for k, v in batch.items()}
    if len(set(rows.values())) != 1:
        raise ValueError(f"a batch's leaves disagree on its rows: {rows}")
    return next(iter(rows.values()))


def batch_splits(batch: dict, mesh, microbatches: int = 1) -> bool:
    """Whether ``batch`` splits over the mesh's data ranks
    (:func:`batch_share`): more than one data rank, and N x K dividing
    its rows.  A batch that does not split replicates, as ``_fit`` drops
    a batch spec that does not divide."""
    if data_group(mesh) is None:
        return False
    return _batch_rows(batch) % (dp_size(mesh) * microbatches) == 0


def batch_share(batch: dict, mesh, microbatches: int = 1) -> dict:
    """This data rank's rows of a global ``batch`` (numpy arrays or
    tensors), laid out as :func:`batch_shardings` lays the batch over
    the data axes: leaves split on axis 0, ``mrope_positions`` on axis 1.

    The rows respect ``microbatched_grads``' split: microbatch m of K is
    global rows ``[m B / K, (m + 1) B / K)``, and data rank r of N holds
    the r-th of N equal parts of every microbatch, so that slice m of
    its share is its part of the same global microbatch.  A batch that
    does not split (:func:`batch_splits`) is returned whole: every rank
    takes it."""
    if not batch_splits(batch, mesh, microbatches):
        return batch
    n, k, r = dp_size(mesh), microbatches, data_rank(mesh)
    b = _batch_rows(batch)
    part = b // (n * k)
    idx = (np.arange(k)[:, None] * (b // k) + r * part
           + np.arange(part)[None, :]).reshape(-1)
    out = {}
    for key, a in batch.items():
        ax = 1 if key == "mrope_positions" else 0
        if isinstance(a, np.ndarray):
            out[key] = np.take(a, idx, axis=ax)
        else:
            out[key] = a.index_select(ax, torch.as_tensor(idx,
                                                          device=a.device))
    return out


def cache_paths(cfg) -> list:
    """Each layer's cache path prefix in the reference's stacked caches
    (``[0]['pos1']``, then ``['attn']`` for an attention layer), and its
    stack's repeat."""
    repeats = [r for _, r in cfg.stacks()]
    out = []
    for (si, _, key), kind in zip(convert._layer_slices(cfg),
                                  cfg.layer_kinds()):
        prefix = keystr((si, key)) + ("['attn']" if kind.startswith("attn")
                                      else "")
        out.append((prefix, repeats[si]))
    return out


def cache_shardings(cfg, mesh, caches_shape: list) -> list:
    """Decode caches (one a layer, as ``transformer.init_caches`` lays
    them out) -> the same nesting with a spec a tensor: batch over dp;
    heads/width over model."""
    dp = dp_axes(mesh)
    mdl = model_axis(mesh)

    def assign(path: str, leaf, repeat: int):
        if "['attn']" in path:                 # [R, B, S, Hkv, dh]
            # S over model (split-KV decode): Hkv is rarely divisible by tp
            spec = (None, dp, mdl, None, None)
        elif "['wkv']" in path:                # [R, B, H, dk, dv]
            spec = (None, dp, mdl, None, None)
        elif "['conv']" in path:               # [R, B, W-1, Dr]
            spec = (None, dp, None, mdl)
        elif "['h']" in path:                  # [R, B, Dr]
            spec = (None, dp, mdl)
        elif "shift" in path or "['cmix']" in path:   # [R, B, D]
            spec = (None, dp, None)
        else:
            spec = ()
        shape = (repeat,) + tuple(leaf.shape)
        return _fit(mesh, spec[: len(shape)], shape)[1:]

    def walk(tree, path, repeat):
        if isinstance(tree, dict):
            return {k: walk(v, path + keystr((k,)), repeat)
                    for k, v in tree.items()}
        return assign(path, tree, repeat)

    return [walk(c, prefix, repeat)
            for c, (prefix, repeat) in zip(caches_shape, cache_paths(cfg))]


def placements(spec: tuple, mesh) -> list:
    """``DTensor`` placements of ``spec`` on a ``DeviceMesh``: each mesh
    dim shards the tensor dim whose entry names it, and replicates
    where none does."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(axis_sizes(mesh))
    names = list(axis_sizes(mesh))
    for dim, e in enumerate(spec):
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            out[names.index(a)] = Shard(dim)
    return out


def shard_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor laid out by
    ``spec`` on ``mesh`` (``_fit`` specs divide evenly)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for dim, e in enumerate(spec):
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            out[dim] //= sizes[a]
    return tuple(out)


def place(model, shardings: dict, mesh):
    """Lay ``model``'s parameters out by ``shardings`` on ``mesh``.  On
    the host mesh every shard is the whole tensor: the parameters stay
    plain tensors where they are, and the kernels and graph capture see
    them as they would without a mesh.  The data ranks are replicas, so
    an entry naming a data axis (Kimi-K2's experts, ZeRO-style over
    "data") holds the whole tensor on every rank.  A layout that would
    cut a parameter over "model" raises: it needs a mesh of more
    ranks."""
    dp = set(dp_axes(mesh))

    def model_only(e):
        axes = () if e is None else e if isinstance(e, tuple) else (e,)
        axes = tuple(a for a in axes if a not in dp)
        return entry(axes) if axes else None
    for name, p in model.named_parameters():
        spec = tuple(model_only(e) for e in shardings[name])
        if shard_shape(tuple(p.shape), spec, mesh) != tuple(p.shape):
            raise ValueError(f"{name}: spec {shardings[name]} cuts "
                             f"{tuple(p.shape)} on mesh {axis_sizes(mesh)}")
    return model
