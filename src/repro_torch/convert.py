"""Carry state and parameters between the JAX reference and the port.

Works on numpy: the caller turns the reference's state into numpy
first (``jax.device_get``), so this module imports neither package.
The reference's objects are read by attribute name only.

Representation differences handled here:

* the ring: the port's ``RingBuffer.store`` has one discard row past
  the reference's ``buf`` (zero, never read);
* the dedupe window: the reference keeps uint32 hashes, the port int64
  values in ``[0, 2^32)``;
* the DHT shard: the port's ``ShardStore`` tensors have one discard row
  past the reference's capacity (stamp -1, never read);
* the model: the reference stacks the layers of a kind along a leading
  ``repeat`` dim (``stacks``, one ``{pos<i>: ...}`` group a stack), the
  port keeps one layer module a layer; the decode caches likewise
  (``[repeat, B, S, Hkv, D]`` a stack against ``[B, S, Hkv, D]`` a
  layer), and an attention layer's ``{"attn": {k, v}}`` is the port's
  ``{k, v}`` (the recurrent kinds' states keep their nesting);
* the training state: the port names a parameter as its module does
  (``layers.3.attn.p.wq``) and keys the AdamW moments by those names;
  the reference's ``(params, AdamWState)`` tree nests them by group and
  stacks each stack's layers (``['stacks'][0]['pos0']['attn']['wq']``,
  row 3).  ``train_state_tree`` lays the port's state out as the
  reference's tree (so a checkpoint of it is the reference's), and
  ``train_model_from_numpy`` with ``adamw_state_from_numpy`` builds the
  port's state from such a tree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.store import ShardStore
from repro_torch.data.ringbuffer import RingBuffer
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWState
from repro_torch.stream.executor import StreamMetrics, StreamState
from repro_torch.stream.fleet.executor import FleetState
from repro_torch.stream.ingest import AdmissionState


def _t(a, device, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(resolve_device(device), dtype or a.dtype,
                             copy=True)
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":      # ml_dtypes' type, from a JAX array
        return torch.as_tensor(a.astype(np.float32),
                               device=resolve_device(device)).to(
                                   dtype or torch.bfloat16)
    return torch.as_tensor(a, device=resolve_device(device), dtype=dtype)


def state_from_numpy(ref_state, device: str | torch.device | None = None
                     ) -> StreamState:
    """A reference ``StreamState`` with numpy leaves -> the port's."""
    return _stream_state(ref_state, device, lead=0)


def _stream_state(ref_state, device, lead: int) -> StreamState:
    """``state_from_numpy`` for a state whose leaves carry ``lead``
    leading dims (1: a fleet's shard dim)."""
    buf = np.asarray(ref_state.rb.buf)
    store = np.concatenate([buf, np.zeros_like(buf[..., :1, :])], axis=lead)
    m = ref_state.metrics
    return StreamState(
        rb=RingBuffer(_t(store, device), _t(ref_state.rb.head, device),
                      _t(ref_state.rb.tail, device)),
        carry=_t(ref_state.carry, device),
        carry_valid=_t(ref_state.carry_valid, device),
        max_ts=_t(ref_state.max_ts, device),
        metrics=StreamMetrics(*(_t(getattr(m, f), device)
                                for f in StreamMetrics._fields)),
        adm=AdmissionState(
            seen=_t(np.asarray(ref_state.adm.seen, np.uint32)
                    .astype(np.int64), device),
            seen_pos=_t(ref_state.adm.seen_pos, device)),
    )


def state_to_numpy(state: StreamState) -> dict:
    """The port's ``StreamState`` -> nested dict of numpy arrays, keyed
    by the reference's field names, with the reference's ``buf`` and
    uint32 ``seen``.  Leading dims (a fleet's shards) stay.  The arrays
    are copies: the ring is written in place by later ticks."""
    return {
        "rb": {"buf": _np(state.rb.store[..., :-1, :]),
               "head": _np(state.rb.head), "tail": _np(state.rb.tail)},
        "carry": _np(state.carry),
        "carry_valid": _np(state.carry_valid),
        "max_ts": _np(state.max_ts),
        "metrics": {f: _np(getattr(state.metrics, f))
                    for f in StreamMetrics._fields},
        "adm": {"seen": _np(state.adm.seen).astype(np.uint32),
                "seen_pos": _np(state.adm.seen_pos)},
    }


#: the fleet state's per-shard counter leaves past ``shard``/``fleet``
_FLEET_LEAVES = ("escalations_sent", "fog_shed", "core_received",
                 "core_processed", "fleet_core_overflow", "late_excluded",
                 "watermark", "region_watermark")


def fleet_state_from_numpy(ref_state,
                           device: str | torch.device | None = None
                           ) -> FleetState:
    """A reference ``FleetState`` with numpy leaves (each with its
    leading ``[S]`` shard dim, as the reference's ``init_state`` lays
    it out) -> the port's, so a reference fleet can be carried across
    whole after any number of ticks."""
    m = ref_state.fleet
    return FleetState(
        shard=_stream_state(ref_state.shard, device, lead=1),
        fleet=StreamMetrics(*(_t(getattr(m, f), device)
                              for f in StreamMetrics._fields)),
        **{k: _t(getattr(ref_state, k), device) for k in _FLEET_LEAVES})


def fleet_state_to_numpy(state) -> dict:
    """The port's ``FleetState`` -> nested dict of numpy arrays keyed by
    the reference's field names (see :func:`state_to_numpy`)."""
    out = {"shard": state_to_numpy(state.shard),
           "fleet": {f: _np(getattr(state.fleet, f))
                     for f in StreamMetrics._fields}}
    out.update({k: _np(getattr(state, k)) for k in _FLEET_LEAVES})
    return out


def histograms_from_numpy(lat_hist, lineage,
                          device: str | torch.device | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Latency histogram and lineage bank (int32 counts) -> tensors."""
    return (_t(lat_hist, device, torch.int32),
            _t(lineage, device, torch.int32))


def histograms_to_numpy(lat_hist: torch.Tensor, lineage: torch.Tensor
                        ) -> tuple[np.ndarray, np.ndarray]:
    return lat_hist.cpu().numpy(), lineage.cpu().numpy()


def params_from_numpy(params, device: str | torch.device | None = None):
    """Stage parameters (arrays, or dicts/lists/tuples of them) ->
    tensors on ``device`` with the same structure and dtypes."""
    if isinstance(params, dict):
        return {k: params_from_numpy(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_from_numpy(v, device) for v in params)
    if params is None:
        return None
    return _t(params, device)


def store_from_numpy(ref_store, device: str | torch.device | None = None
                     ) -> ShardStore:
    """A reference ``ShardStore`` with numpy leaves -> the port's, with
    the discard row appended."""
    keys, values = np.asarray(ref_store.keys), np.asarray(ref_store.values)
    return ShardStore(
        keys=_t(np.concatenate([keys, np.zeros_like(keys[:1])]), device),
        values=_t(np.concatenate([values, np.zeros_like(values[:1])]),
                  device),
        stamps=_t(np.concatenate([np.asarray(ref_store.stamps, np.int32),
                                  [-1]]).astype(np.int32), device),
        cursor=_t(ref_store.cursor, device, torch.int32))


def store_to_numpy(st: ShardStore) -> dict:
    """The port's ``ShardStore`` -> dict of numpy arrays keyed by the
    reference's field names, without the discard row."""
    keys, values, stamps = st.log()
    return {"keys": keys.cpu().numpy(), "values": values.cpu().numpy(),
            "stamps": stamps.cpu().numpy(), "cursor": st.cursor.cpu().numpy()}


def _layer_slices(cfg):
    """(stack index, repeat index, group key) of each layer, in order."""
    for si, (kinds, repeat) in enumerate(cfg.stacks()):
        for r in range(repeat):
            for i in range(len(kinds)):
                yield si, r, f"pos{i}"


def model_from_numpy(cfg, tree, device: str | torch.device | None = None
                     ) -> T.Transformer:
    """The reference's ``init_params`` tree (numpy leaves, layers stacked
    a stack) -> the port's serving ``Transformer`` on ``device``, its
    layers cast to ``cfg.compute_dtype`` as the model casts them."""
    return _model(cfg, tree, device, trainable=False)


def train_model_from_numpy(cfg, tree,
                           device: str | torch.device | None = None
                           ) -> T.Transformer:
    """The reference's ``init_params`` tree -> the port's trainable
    ``Transformer`` on ``device``: every leaf in its own dtype
    (``param_dtype``), taking a gradient.  Leaves may be numpy arrays
    or tensors (a restored checkpoint's)."""
    return _model(cfg, tree, device, trainable=True)


def _model(cfg, tree, device, trainable: bool) -> T.Transformer:
    dev = resolve_device(device)

    def tens(a):
        return _t(a, dev)

    def group(g):
        return {k: group(v) if isinstance(v, dict) else tens(v)
                for k, v in g.items()}

    layers = [T.make_layer(cfg, kind,
                           group(_index(tree["stacks"][si][key], r)),
                           trainable=trainable)
              for (si, r, key), kind in zip(_layer_slices(cfg),
                                            cfg.layer_kinds())]
    unembed = None if cfg.tie_embeddings else tens(tree["unembed"])
    return T.Transformer(cfg, tens(tree["embed"]), group(tree["final_norm"]),
                         unembed, layers, trainable=trainable)


def _index(g, r):
    if not isinstance(g, dict):
        return g[r] if isinstance(g, torch.Tensor) else np.asarray(g)[r]
    return {k: _index(v, r) for k, v in g.items()}


def _ref_slots(cfg, names):
    """(port name, path in the reference's params tree, row) of each
    parameter name (``named_parameters()`` order); the row is the layer's
    index in its stack, ``None`` outside the stacks."""
    slices = list(_layer_slices(cfg))
    for name in names:
        head, *rest = name.split(".")
        if head != "layers":
            yield name, tuple(name.split(".")), None
            continue
        si, r, key = slices[int(rest[0])]
        # module attributes ``p`` hold a group's leaves: not a tree level
        yield name, ("stacks", si, key) + tuple(
            k for k in rest[1:] if k != "p"), r


def _ref_tree(cfg, named: dict) -> dict:
    """Port-named leaves -> the reference's params tree, each stack's
    layers stacked (``torch.stack``) on a leading row dim."""
    tree: dict = {"stacks": [{} for _ in cfg.stacks()]}
    rows: dict = {}
    for name, path, r in _ref_slots(cfg, named):
        if r is None:
            _put(tree, path, named[name])
        else:
            rows.setdefault(path, []).append(named[name])
    for path, leaves in rows.items():
        _put(tree, path, torch.stack(leaves))
    return tree


def _put(tree, path: tuple, leaf) -> None:
    for k in path[:-1]:
        tree = tree[k] if isinstance(tree, list) else tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def train_state_tree(cfg, model: T.Transformer, opt_state: AdamWState):
    """The port's training state as the reference's ``(params,
    AdamWState(m, v, step))`` tree of tensors (copies, on the model's
    device), layers stacked per ``cfg.stacks()``: what
    ``CheckpointManager.save`` writes, leaf for leaf the reference's."""
    with torch.no_grad():
        params = _ref_tree(cfg, {n: p.detach()
                                 for n, p in model.named_parameters()})
        return params, AdamWState(_ref_tree(cfg, opt_state.m),
                                  _ref_tree(cfg, opt_state.v),
                                  opt_state.step.clone())


def train_state_to_numpy(cfg, model: T.Transformer, opt_state: AdamWState):
    """:func:`train_state_tree` with numpy leaves (bfloat16 as float32),
    to compare with the reference's state leaf for leaf."""
    with torch.no_grad():
        params = _ref_tree(cfg, {n: p.detach()
                                 for n, p in model.named_parameters()})
    return _map(_np, params), adamw_state_to_numpy(cfg, opt_state)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def adamw_state_from_numpy(cfg, model: T.Transformer, ref_state,
                           device: str | torch.device | None = None
                           ) -> AdamWState:
    """The reference's ``AdamWState`` (numpy or tensor leaves: a
    restored checkpoint's) -> the port's, keyed by ``model``'s parameter
    names, on ``device``, each moment in its leaf's dtype."""
    dev = resolve_device(device)
    names = [n for n, _ in model.named_parameters()]

    def moments(tree):
        return {name: _t(_get(tree, path) if r is None
                         else _index(_get(tree, path), r), dev)
                for name, path, r in _ref_slots(cfg, names)}

    return AdamWState(moments(ref_state.m), moments(ref_state.v),
                      _t(ref_state.step, dev, torch.int32))


def adamw_state_to_numpy(cfg, state: AdamWState) -> AdamWState:
    """The port's ``AdamWState`` -> the reference's layout, numpy leaves
    (bfloat16 as float32)."""
    return AdamWState(_map(_np, _ref_tree(cfg, state.m)),
                      _map(_np, _ref_tree(cfg, state.v)), _np(state.step))


def caches_from_numpy(cfg, caches, device: str | torch.device | None = None
                      ) -> list[dict]:
    """The reference's decode caches (one ``{pos<i>: state}`` a stack,
    each leaf with a leading ``repeat`` dim) -> the port's per-layer
    caches: ``{k, v}`` for attention, the recurrent states as nested."""
    def layer(state, r):
        if isinstance(state, dict):
            return {k: layer(v, r) for k, v in state.items()}
        return _t(np.asarray(state)[r], device)

    out = []
    for si, r, key in _layer_slices(cfg):
        state = caches[si][key]
        out.append(layer(state["attn"] if "attn" in state else state, r))
    return out


def caches_to_numpy(cfg, caches: list[dict]) -> list[dict]:
    """The port's per-layer caches -> the reference's stacked layout, as
    numpy arrays (bfloat16 as float32: numpy has no bfloat16)."""
    def stack(states):
        if isinstance(states[0], dict):
            return {k: stack([s[k] for s in states]) for k in states[0]}
        return np.stack([_np(s) for s in states])

    out, it = [], iter(zip(cfg.layer_kinds(), caches))
    for kinds, repeat in cfg.stacks():
        layers = [[next(it) for _ in kinds] for _ in range(repeat)]
        group = {}
        for i, kind in enumerate(kinds):
            states = stack([rep[i][1] for rep in layers])
            group[f"pos{i}"] = {"attn": states} if kind.startswith("attn") \
                else states
        out.append(group)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as a numpy array (bfloat16 as float32)."""
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())
