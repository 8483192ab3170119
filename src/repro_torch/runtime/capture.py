"""Compile-once steps: a fixed-shape step built once for each signature
and, on the card, captured as a CUDA graph and replayed.

No module of the JAX package corresponds to this one.  It is the
port's private counterpart of ``jax.jit`` for the steps the reference
jits once and counts: the stream tick and the fleet tick
(``trace_count``, ``_compile_count``) and the decode step the function
registry compiles ahead of time (``start_function``).  PyTorch runs
eagerly; on one CUDA card, "traced once, compiled once, replayed" is a
CUDA graph captured once for each signature and replayed every call.

:class:`Step` wraps ``fn(*args) -> outputs``:

* **Signature.**  The arguments' tree structure, each tensor's shape,
  dtype and device, each :class:`Scalar`'s dtype, every other leaf (a
  module, a config, ``None``, an int) by value or, where it has no
  hash, by identity, and the caller's ``static_key``.  ``trace_count``
  counts the signatures a step was built for; ``compile_count`` the
  graphs captured (on the CPU, where nothing is captured, it equals
  ``trace_count``).
* **First call of a signature** (``__call__``): ``fn`` runs eagerly on
  the caller's arguments -- the warm-up, which builds the kernels and
  sets their attributes -- and its results are the call's results.
  Then the signature's static buffers are made and, on the card, the
  step is captured on a side stream with a private memory pool.
  :meth:`Step.prepare` is the ahead-of-time form: it warms up on copies
  of the donated arguments, keeps nothing of that run, and captures,
  so that the first real call replays.
* **Later calls** copy the arguments into the static buffers, replay
  the graph (on the CPU: run ``fn`` on the static buffers, eagerly) and
  copy the outputs out.  A capture that fails raises; nothing falls
  back to eager.
* :func:`disable` is the counterpart of ``jax.disable_jit()``: inside
  it every step runs ``fn`` eagerly on the caller's arguments and
  counts nothing.  Parity checks use it; no path switches on it.

``donate_argnums`` names the arguments that are the step's state, as
the reference donates them: ``fn`` returns their new values as its
last outputs, in that order and with the same structure.  A donated
tensor that ``fn`` writes in place (its output is its input, as the
stream ring and the KV caches are) is bound by identity: the caller's
tensor is the static buffer.  Every other donated tensor lives in one
static *carry slab*, which the step rewrites inside the graph.

The copy-in and copy-out rules (:func:`layout`, :func:`pack`,
:func:`unpack` and the rules in ``_replay``) are plain tensor code and
run on the CPU as on the card:

* **Copy-in.**  A tensor argument is copied into its static buffer
  unless it is that buffer, or unless it is the tensor the step handed
  out for that argument on its last call, unchanged since (its version
  counter says so).  A foreign state -- a ``clone_state`` copy, a
  checkpoint -- is therefore copied in, never trusted by address.  A
  :class:`Scalar` is filled in.
* **Copy-out.**  Every output that is not a donated tensor written in
  place is packed, inside the graph, into one output slab of bytes;
  after each replay the slab is cloned once and the outputs handed out
  as views of the clone, so the next replay never overwrites what an
  earlier call returned.  Outputs written in place come back as the
  static buffer itself (the caller's ring or caches).
* **Launch accounting.**  The kernels' wrappers count launches in
  Python when they are called, and a replay calls no Python.  The
  capture records each counter's change (``launches``,
  ``simple_launches``, ``generic_launches``), takes it back (a capture
  launches nothing) and adds it on every replay.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Any, Callable, NamedTuple

import torch


class Scalar(NamedTuple):
    """A 0-dim operand of a step: a host number, filled into its static
    buffer each call, or a 0-dim tensor, copied in; its dtype is part
    of the signature, its value never is."""
    value: Any
    dtype: torch.dtype


_DISABLED = [0]


@contextlib.contextmanager
def disable():
    """Run every step eagerly on the caller's arguments while open: no
    capture, no replay, nothing counted (``jax.disable_jit()``)."""
    _DISABLED[0] += 1
    try:
        yield
    finally:
        _DISABLED[0] -= 1


def disabled() -> bool:
    return _DISABLED[0] > 0


# -- the kernels' launch counters ----------------------------------------------

def _counters() -> tuple:
    """(wrapper, counter names) of the five kernel wrappers."""
    from repro_torch.kernels.armatch import armatch
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.fused_tick import fused_tick
    from repro_torch.kernels.hilbert import hilbert_xy2d
    from repro_torch.kernels.window_reduce import window_reduce
    return ((window_reduce, ("launches", "simple_launches")),
            (fused_tick, ("launches", "simple_launches")),
            (hilbert_xy2d, ("launches",)),
            (armatch, ("launches", "simple_launches")),
            (decode_attention, ("launches", "generic_launches")))


def read_counters() -> tuple[int, ...]:
    return tuple(getattr(w, n) for w, names in _counters() for n in names)


def add_counters(delta) -> None:
    it = iter(delta)
    for w, names in _counters():
        for n in names:
            setattr(w, n, getattr(w, n) + next(it))


# -- trees ---------------------------------------------------------------------

_TENSOR, _SCALAR = "tensor", "scalar"


def _const_key(x):
    try:
        hash(x)
    except TypeError:
        return ("id", id(x))
    return x


def _flat(x, leaves: list, key: list):
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        key.append((tuple(x.shape), x.dtype, x.device))
        return _TENSOR
    if isinstance(x, Scalar):
        leaves.append(x)
        key.append(("scalar", x.dtype))
        return _SCALAR
    if isinstance(x, (tuple, list)):
        key.append((type(x), len(x)))
        return (type(x), tuple(_flat(v, leaves, key) for v in x))
    if isinstance(x, dict):
        key.append((dict, tuple(x)))
        return (dict, tuple(x), tuple(_flat(v, leaves, key)
                                      for v in x.values()))
    leaves.append(x)
    key.append(("const", _const_key(x)))
    return None


def flatten(tree) -> tuple[list, Any, tuple]:
    """(leaves, treedef, signature key) of a tree of tuples, named
    tuples, lists and dicts; tensors, scalars and constants are leaves."""
    leaves, key = [], []
    treedef = _flat(tree, leaves, key)
    return leaves, treedef, tuple(key)


def _unflat(d, it):
    if d is None or d is _TENSOR or d is _SCALAR:
        return next(it)
    if d[0] is dict:
        return dict(zip(d[1], (_unflat(k, it) for k in d[2])))
    typ, kids = d
    vals = [_unflat(k, it) for k in kids]
    if typ is list:
        return vals
    return typ(*vals) if hasattr(typ, "_fields") else typ(vals)


def unflatten(treedef, leaves):
    return _unflat(treedef, iter(leaves))


# -- copy-out: one slab of bytes -----------------------------------------------

_ALIGN = 16


class Slot(NamedTuple):
    off: int                # byte offset in the slab (16-byte aligned)
    nbytes: int
    shape: tuple
    dtype: torch.dtype


def layout(tensors) -> tuple[list, int]:
    """Each tensor's slot in a slab, in order, and the slab's bytes."""
    slots, off = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        slots.append(Slot(off, n, tuple(t.shape), t.dtype))
        off += -(-n // _ALIGN) * _ALIGN
    return slots, off


def pack(tensors, slots, nbytes: int, pad: torch.Tensor) -> torch.Tensor:
    """The tensors' bytes, each at its slot, as one new uint8 tensor;
    ``pad`` is at least 16 zero bytes on the tensors' device, made
    outside any capture (so the graph holds no fill for the gaps)."""
    parts = []
    for t, s in zip(tensors, slots):
        if tuple(t.shape) != s.shape or t.dtype != s.dtype:
            raise RuntimeError(f"step output {tuple(t.shape)} {t.dtype}, "
                               f"captured as {s.shape} {s.dtype}")
        parts.append(t.contiguous().reshape(-1).view(torch.uint8))
        gap = -(-s.nbytes // _ALIGN) * _ALIGN - s.nbytes
        if gap:
            parts.append(pad[:gap])
    if not parts:
        return pad.new_zeros(nbytes)
    return torch.cat(parts)


def unpack(slab: torch.Tensor, slots) -> list:
    """Views of ``slab``, one a slot, in each slot's shape and dtype."""
    return [slab[s.off:s.off + s.nbytes].view(s.dtype).view(s.shape)
            for s in slots]


def _aliases(o, s) -> bool:
    """``o`` is ``s``, or the same elements of the same storage."""
    if o is s:
        return True
    return (isinstance(o, torch.Tensor) and isinstance(s, torch.Tensor)
            and o.numel() > 0 and o.device == s.device
            and o.dtype == s.dtype and o.shape == s.shape
            and o.stride() == s.stride() and o.data_ptr() == s.data_ptr())


def _version(t: torch.Tensor):
    try:
        return t._version
    except RuntimeError:                # an inference tensor keeps none
        return None


# -- the step ------------------------------------------------------------------

class _Entry:
    """One signature's static buffers, graph and bookkeeping."""

    def __init__(self, treedef, kinds, statics, out_def, out_src, slots,
                 nbytes, pad, carry_bytes, carry_slab, carry_out, handed):
        self.treedef = treedef
        self.kinds = kinds          # a leaf: "operand", "scalar", "carry",
        self.statics = statics      # "inplace" or None (a constant)
        self.out_def = out_def
        self.out_src = out_src      # ("arg", i) | ("slot", j) | ("const", v)
        self.slots = slots          # the output slab's slots
        self.nbytes = nbytes
        self.pad = pad
        self.carry_bytes = carry_bytes
        self.carry_slab = carry_slab
        self.carry_out = carry_out  # (arg leaf, slot) of each carried leaf
        self.handed = handed        # arg leaf -> (tensor, its version)
        self.graph = None
        self.slab = None
        self.delta = None
        self.pool_bytes = 0


class Step:
    """``fn`` built once for each signature; on a CUDA ``device``
    captured as a CUDA graph and replayed (see the module docstring).

    ``device``: where the step runs; only a CUDA device captures.
    ``donate_argnums``: the arguments that are the step's state, whose
    new values ``fn`` returns as its last outputs, in order."""

    def __init__(self, fn: Callable, *, device, donate_argnums=(),
                 name: str = "step"):
        self.fn = fn
        self.device = torch.device(device)
        self.donate = tuple(donate_argnums)
        self.name = name
        self._entries: dict = {}
        self._traces = 0
        self._compiles = 0

    @property
    def trace_count(self) -> int:
        """Signatures the step was built for: 1 after the first call of
        a fixed feed, and 1 more for each new signature."""
        return self._traces

    @property
    def compile_count(self) -> int:
        """Graphs captured (on the CPU, the signatures built)."""
        return self._compiles

    @property
    def pool_bytes(self) -> int:
        """Device memory the live graphs' private pools reserved."""
        return sum(e.pool_bytes for e in self._entries.values())

    def clear(self) -> None:
        """Drop every signature's graph and buffers; the next call of
        any signature builds anew and counts one more trace."""
        self._entries.clear()

    # -- calls ---------------------------------------------------------------
    def __call__(self, *args, static_key=()):
        leaves, treedef, key = flatten(args)
        if disabled():
            return self.fn(*unflatten(
                treedef, [self._materialize(x) for x in leaves]))
        key = (key, static_key)
        e = self._entries.get(key)
        if e is None:
            self._traces += 1
            eager = [self._materialize(x) for x in leaves]
            outs = self.fn(*unflatten(treedef, eager))
            e = self._build(args, treedef, eager, leaves, outs, True)
            self._compile(key, e)
            return outs
        return self._replay(e, leaves)

    def prepare(self, *args, static_key=()) -> "Step":
        """Build and capture the signature of ``args`` ahead of time, on
        the card: warm up on copies of the donated arguments (nothing
        of that run is kept), then capture, so that the first call with
        these arguments replays.  Elsewhere, or for abstract (``meta``)
        arguments, nothing is built until the first call."""
        leaves, treedef, key = flatten(args)
        key = (key, static_key)
        if disabled() or self.device.type != "cuda" or key in self._entries \
                or any(isinstance(x, torch.Tensor) and x.is_meta
                       for x in leaves):
            return self
        self._traces += 1
        warm = [self._materialize(x) for x in leaves]
        starts = _starts(args)
        for d in self.donate:
            for i in range(starts[d], starts[d + 1]):
                if isinstance(warm[i], torch.Tensor):
                    warm[i] = warm[i].clone()
        outs = self.fn(*unflatten(treedef, warm))
        e = self._build(args, treedef, warm, leaves, outs, False)
        del outs, warm
        self._compile(key, e)
        return self

    # -- building ------------------------------------------------------------
    def _materialize(self, x):
        if not isinstance(x, Scalar):
            return x
        if isinstance(x.value, torch.Tensor):
            return x.value.to(device=self.device, dtype=x.dtype)
        return torch.full((), x.value, dtype=x.dtype, device=self.device)

    def _build(self, args, treedef, warm, real, outs, first_call: bool):
        """The signature's entry from a warm-up run: ``warm`` the leaves
        the warm-up ran on, ``real`` the caller's; after a first call
        the carried statics hold the outputs (the next call's inputs),
        ahead of time the caller's donated arguments."""
        out_leaves, out_def, _ = flatten(outs)
        n = len(real)
        kinds, statics = [None] * n, [None] * n
        out_src = [None] * len(out_leaves)
        carry_vals, carry_args, carry_outs = [], [], []
        if self.donate:
            if not isinstance(outs, tuple) or len(outs) < len(self.donate):
                raise TypeError(f"{self.name}: donated arguments "
                                f"{self.donate} need a tuple of outputs "
                                "ending in their new values")
            a_start, o_start = _starts(args), _starts(outs)
            first_out = len(outs) - len(self.donate)
            for j, d in enumerate(self.donate):
                p = first_out + j
                if flatten(args[d])[2] != flatten(outs[p])[2]:
                    raise ValueError(
                        f"{self.name}: output {p} does not match donated "
                        f"argument {d} leaf for leaf (structure, shapes, "
                        "dtypes)")
                for ai, oi in zip(range(a_start[d], a_start[d + 1]),
                                  range(o_start[p], o_start[p + 1])):
                    w, o = warm[ai], out_leaves[oi]
                    if not isinstance(w, torch.Tensor):
                        continue
                    if _aliases(o, w):
                        kinds[ai], statics[ai] = "inplace", real[ai]
                        out_src[oi] = ("arg", ai)
                    else:
                        kinds[ai] = "carry"
                        out_src[oi] = ("slot", len(carry_vals))
                        carry_vals.append(o if first_call else real[ai])
                        carry_args.append(ai)
                        carry_outs.append(oi)
        emitted = []
        for oi, o in enumerate(out_leaves):
            if out_src[oi] is not None:
                continue
            if isinstance(o, torch.Tensor):
                out_src[oi] = ("slot", len(carry_vals) + len(emitted))
                emitted.append(o)
            else:
                out_src[oi] = ("const", o)
        slots, nbytes = layout(carry_vals + emitted)
        carry_bytes = slots[len(carry_vals)].off \
            if len(carry_vals) < len(slots) else nbytes
        carry_slots = slots[:len(carry_vals)]
        pad = torch.zeros(_ALIGN, dtype=torch.uint8, device=self.device)
        carry_slab = pack(carry_vals, carry_slots, carry_bytes, pad)
        for ai, view in zip(carry_args, unpack(carry_slab, carry_slots)):
            statics[ai] = view
        for i, x in enumerate(warm):
            if kinds[i] is not None:
                continue
            if isinstance(real[i], Scalar):
                kinds[i] = "scalar"
                statics[i] = x.clone()
            elif isinstance(x, torch.Tensor):
                kinds[i] = "operand"
                statics[i] = x.clone()
            else:
                statics[i] = x
        handed = {}
        for ai, oi in zip(carry_args, carry_outs):
            t = out_leaves[oi] if first_call else real[ai]
            handed[ai] = (t, _version(t))
        return _Entry(treedef, kinds, statics, out_def, out_src, slots,
                      nbytes, pad, carry_bytes, carry_slab,
                      [(ai, out_src[oi][1])
                       for ai, oi in zip(carry_args, carry_outs)], handed)

    def _body(self, e: _Entry) -> torch.Tensor:
        """The captured region: ``fn`` on the static buffers, its
        outputs packed into the output slab, the carried ones written
        back into the carry slab."""
        outs = self.fn(*unflatten(e.treedef, e.statics))
        out_leaves = flatten(outs)[0]
        packed = [None] * len(e.slots)
        for o, src in zip(out_leaves, e.out_src):
            if src[0] == "arg":
                if not _aliases(o, e.statics[src[1]]):
                    raise RuntimeError(
                        f"{self.name}: a donated tensor the warm-up wrote "
                        "in place is not written in place on the static "
                        "buffers")
            elif src[0] == "slot":
                packed[src[1]] = o
        slab = pack(packed, e.slots, e.nbytes, e.pad)
        if e.carry_bytes:
            e.carry_slab.copy_(slab[:e.carry_bytes])
        return slab

    def _compile(self, key, e: _Entry) -> None:
        if self.device.type == "cuda":
            before = read_counters()
            # what torch.cuda.graph does before it begins, done first so
            # that the reserved memory's growth is the private pool's
            torch.cuda.synchronize(self.device)
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            # no finalizer of this thread may run a CUDA call mid-capture
            # (torch.cuda.graph collects once before it begins), and
            # another thread's calls (a profiler's) do not concern a
            # capture on this thread's side stream
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    e.slab = self._body(e)
            finally:
                if collecting:
                    gc.enable()
            e.delta = tuple(b - a for a, b in zip(before, read_counters()))
            add_counters(tuple(-d for d in e.delta))
            e.graph = graph
            e.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._compiles += 1
        self._entries[key] = e

    # -- replay --------------------------------------------------------------
    def _replay(self, e: _Entry, leaves):
        for i, (kind, x) in enumerate(zip(e.kinds, leaves)):
            if kind is None:
                continue
            s = e.statics[i]
            if kind == "scalar":
                if isinstance(x.value, torch.Tensor):
                    s.copy_(x.value)
                else:
                    s.fill_(x.value)
                continue
            if x is s:
                continue
            h = e.handed.get(i)
            if h is not None and h[0] is x and h[1] is not None \
                    and _version(x) == h[1]:
                continue
            s.copy_(x)
        if e.graph is not None:
            e.graph.replay()
            add_counters(e.delta)
            slab = e.slab.clone()
        else:
            slab = self._body(e)
        views = unpack(slab, e.slots)
        out = [e.statics[src[1]] if src[0] == "arg"
               else views[src[1]] if src[0] == "slot" else src[1]
               for src in e.out_src]
        for ai, j in e.carry_out:
            e.handed[ai] = (views[j], _version(views[j]))
        return unflatten(e.out_def, out)


def _starts(top: tuple) -> list[int]:
    """The first leaf index of each top-level element, and the total."""
    starts = [0]
    for x in top:
        starts.append(starts[-1] + len(flatten(x)[0]))
    return starts
