"""A placement-propagating partitioner on ``meta`` tensors: the port's
counterpart of what XLA's SPMD partitioner decides for a step on a mesh,
reduced to the collectives it would insert.

The reference jits a step with shardings on the parameters, the AdamW
state, the batch and the caches, lets XLA propagate them and reads the
collectives from the partitioned HLO (``launch.hlo.collective_stats``).
Here a :class:`Partition` rides along ``obs.costmodel.analyze``'s
dispatch mode (one pass counts FLOPs, bytes and collectives) and keeps a
*placement* for every tensor the step makes:

* a spec as ``launch.sharding`` writes it -- one entry a dim, each a
  tuple of mesh axes -- kept as *factors* so that a dim merged by a
  reshape (``[B, T] -> [B*T]``) splits back to the dims it came from;
* ``partial``: the mesh axes over which the tensor is a pending sum (a
  contraction over a sharded dim, a ``sum`` over one, a scatter of
  sharded updates).  It stays pending through linear operations and is
  all-reduced where an operation needs the whole value, on the shard
  that operation wants.

The seeds are the parameters', the moments', the batch's and the
caches' specs (:meth:`Partition.seed`); ``shardctx.constrain`` moves a
tensor to the spec its template resolves to (:meth:`constrain`), in the
forward pass and on the cotangent in the backward pass, as
``with_sharding_constraint`` does.  Each operation class has one rule
(:data:`_RULES`): pointwise and broadcast, the matmuls (a contraction
over a sharded dim is all-reduced at once; two operands sharded on
different dims by one axis gather the cheaper one, as XLA gathers the
weight of a sequence-parallel projection), views and reshapes,
reductions and the softmaxes (stat all-reduces), sorts and scans (an
all-gather of the sorted dim), the gathers and scatters (a masked
lookup summed, or the table gathered where a use shards the summed
axis), and the operations that move rows along a sharded dim: a
``slice`` or ``split`` whose rows change owner sends them by
collective-permute, one a distinct shift, and a ``cat`` moves its
pieces by all-to-all (or gathers them, where the result does not split
evenly).  An operation it has no rule for is taken to need its inputs
whole: they are all-gathered, and :attr:`Partition.unknown` names it.

XLA propagates shardings both ways; this pass only forwards, so three
of XLA's backward decisions are made where they show: the layers' scan
carry enters with the sharding it leaves with (``shardctx``), a sum into
a fresh buffer lays its rows over the axes its updates leave free (a
gradient laid out like its parameter), and the embedding lookup above.
A reshape that splits a sharded dim unevenly (2 KV heads over 4 ranks)
splits the mesh axis into sub-axes (``"model:1:2"`` and
``"model:2:2"``), as XLA does; other uneven shards are padded to the
ceiling, and the padding counts.  Each collective is an event ``(kind,
result bytes, group size, axes)`` of the per-device program;
``hlo.stats_from_events`` reads them in the reference's operand
convention.  Every collective is counted on its own (XLA's combiners
merge independent ones into one op: the bytes are the same, the count
is not), and a bfloat16 product moves bfloat16 (XLA on the CPU computes
it in float32).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.launch import hlo as hlo_mod
from repro_torch.launch.mesh import axis_sizes

#: the partition passes in progress (at most one)
_ACTIVE: list = []


def active():
    """The partition pass in progress, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class Pl(NamedTuple):
    """A tensor's placement: one entry a dim -- a tuple of factors
    ``(size, axes)`` whose sizes multiply to the dim's -- and the axes
    of a pending sum."""
    dims: tuple
    partial: tuple = ()
    #: a masked lookup's other way, the table's all-gather (its result
    #: bytes), taken instead of the sum where a use shards a summed axis
    alt: int = 0


def _axes(entry) -> tuple:
    return tuple(a for _, ax in entry for a in ax)


def _entry(n: int, axes=()) -> tuple:
    return ((n, tuple(axes)),)


def replicated(shape) -> Pl:
    return Pl(tuple(_entry(n) for n in shape))


def _spec_axes(e) -> tuple:
    return () if e is None else tuple(e) if isinstance(e, tuple) else (e,)


class Partition:
    """One partition pass over a step on ``mesh`` (an ``AbstractMesh``
    or a ``DeviceMesh``): seed the inputs' specs, run the step under
    ``costmodel.analyze(..., partition=self)``, read :meth:`stats`."""

    def __init__(self, mesh, carry: tuple | None = None):
        #: the layers' carry: the spec it enters with (an earlier pass's
        #: ``carry_exit``) and the one this pass saw it leave with
        self.carry_entry = carry
        self.carry_exit = None
        self.sizes = axis_sizes(mesh)
        self.n_devices = math.prod(self.sizes.values())
        self.events: list = []
        self.unknown: set = set()
        self.memo: dict = {}
        self._token = object()
        self._effects: list = []

    # -- placements ------------------------------------------------------
    def _size(self, axes) -> int:
        return math.prod(self._span(a)[2] // self._span(a)[1] for a in axes)

    def _span(self, a: str) -> tuple:
        """``(base axis, lo, hi)``: the part of a mesh axis ``a`` covers,
        as a range of strides (a sub-axis ``"model:2:2"`` is the minor
        half of "model", ``"model:1:2"`` the major half)."""
        if ":" in a:
            base, pre, size = a.split(":")
            return base, int(pre), int(pre) * int(size)
        return a, 1, self.sizes[a]

    def clash(self, axes, used) -> bool:
        """Whether an axis of ``axes`` overlaps one of ``used`` (an axis
        and its sub-axes overlap)."""
        for a in axes:
            b, lo, hi = self._span(a)
            for u in used:
                ub, ulo, uhi = self._span(u)
                if ub == b and lo < uhi and ulo < hi:
                    return True
        return False

    def split(self, a: str, r: int) -> tuple:
        """The sub-axes ``a`` splits into when a dim it shards splits
        into an outer dim of ``r``: its major ``r`` and the rest."""
        b, lo, hi = self._span(a)
        return f"{b}:{lo}:{r}", f"{b}:{lo * r}:{hi // (lo * r)}"

    def get(self, t: torch.Tensor) -> Pl:
        got = getattr(t, "_repro_pl", None)
        if got is not None and got[0] is self._token \
                and len(got[1].dims) == t.dim():
            return got[1]
        return replicated(t.shape)

    def _set(self, t: torch.Tensor, pl: Pl) -> None:
        t._repro_pl = (self._token, pl)

    def _set_pieces(self, t: torch.Tensor, d: int, pieces) -> None:
        t._repro_cat = (self._token, d, tuple(pieces))

    def piece(self, t: torch.Tensor, d: int, lo: int, hi: int):
        """The placement of the piece of a concatenation ``t`` that
        ``[lo, hi)`` along ``d`` is exactly, or None."""
        got = getattr(t, "_repro_cat", None)
        if got is None or got[0] is not self._token or got[1] != d:
            return None
        return next((pl for o, n, pl in got[2] if (o, o + n) == (lo, hi)),
                    None)

    def seed(self, t: torch.Tensor, spec: tuple) -> None:
        """Lay ``t`` out by ``spec`` (``launch.sharding``'s form)."""
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        self._set(t, Pl(tuple(_entry(n, _spec_axes(e))
                               for n, e in zip(t.shape, spec))))

    def seed_tree(self, tensors, specs) -> None:
        """:meth:`seed` over matching nests of dicts and lists."""
        if isinstance(tensors, dict):
            for k, v in tensors.items():
                self.seed_tree(v, specs[k])
        elif isinstance(tensors, (list, tuple)):
            for v, s in zip(tensors, specs):
                self.seed_tree(v, s)
        else:
            self.seed(tensors, specs)

    def shard_numel(self, pl: Pl) -> int:
        return math.prod(-(-n // self._size(ax)) for e in pl.dims
                         for n, ax in e)

    def _bytes(self, pl: Pl, itemsize: int) -> int:
        return self.shard_numel(pl) * itemsize

    # -- collectives -----------------------------------------------------
    def _event(self, kind: str, nbytes: int, axes: tuple) -> None:
        if nbytes > 0 and axes:
            self.events.append((kind, int(nbytes), self._size(axes),
                                tuple(axes)))

    def stats(self) -> dict:
        """``hlo.collective_stats``'s dict of this pass, per device."""
        return hlo_mod.stats_from_events(
            (k, b, g) for k, b, g, _ in self.events)

    def groups(self) -> dict:
        """Kind -> the distinct mesh-axes groups its collectives ran
        over, sorted."""
        out: dict = {}
        for kind, _, _, axes in self.events:
            out.setdefault(kind, set()).add(tuple(axes))
        return {k: sorted(v) for k, v in sorted(out.items())}

    def reshard(self, pl: Pl, target: tuple, itemsize: int,
                together: bool = False) -> Pl:
        """Move ``pl`` to ``target`` (a tuple of axes a dim), counting
        what the move needs: the pending sum all-reduced on the target
        shard, an all-to-all for an axis that changes dims, an
        all-gather for one that goes (a dim at a time, innermost first;
        ``together``: the sub-axes one axis was split into at once, as
        XLA gathers a dim before the reshape that split it); an axis that
        comes is a local slice."""
        dims = list(pl.dims)
        if pl.partial:
            want = Pl(tuple(_entry(self._dims_len(e), tuple(
                a for a in t if a not in pl.partial)) for e, t in
                zip(dims, target)))
            have = Pl(tuple(_entry(self._dims_len(e), tuple(
                a for a in _axes(e) if a not in pl.partial))
                for e in dims))
            ar = min(self._bytes(want, itemsize), self._bytes(have, itemsize))
            if pl.alt and any(a in pl.partial for t in target for a in t) \
                    and pl.alt // self._size(pl.partial) < ar:
                self._event("all-gather", pl.alt, pl.partial)
            else:
                self._event("all-reduce", ar, pl.partial)
        cur = {a: i for i, e in enumerate(dims) for a in _axes(e)}
        tgt = {a: i for i, t in enumerate(target) for a in t}
        moved = tuple(a for a, i in cur.items() if a in tgt and tgt[a] != i)
        gone = tuple(a for a in cur if a not in tgt)
        if moved:
            self._event("all-to-all", self._bytes(Pl(tuple(dims)), itemsize),
                        moved)
        if gone:
            mid = [e if not set(_axes(e)) & set(moved) else _entry(
                self._dims_len(e), tuple(a for a in _axes(e)
                                         if a not in moved))
                   for e in dims]
            for a in moved:
                i = tgt[a]
                mid[i] = _entry(self._dims_len(mid[i]),
                                _axes(mid[i]) + (a,))
            # one all-gather a dim (a factor of a merged one), innermost
            # first, each counting the shard it starts from
            for i in reversed(range(len(mid))):
                for f in reversed(range(len(mid[i]))):
                    out_ax = tuple(a for a in mid[i][f][1] if a in gone)
                    if not out_ax:
                        continue
                    if together:
                        bases = {a.split(":")[0] for a in out_ax if ":" in a}
                        out_ax += tuple(
                            a for e in mid for _, ax in e for a in ax
                            if a in gone and a not in out_ax
                            and a.split(":")[0] in bases)
                    size = self._bytes(Pl(tuple(mid)), itemsize)
                    self._event("all-gather", size * self._size(out_ax),
                                out_ax)
                    mid = [tuple((n, tuple(a for a in ax if a not in out_ax))
                                 for n, ax in e) for e in mid]
        out = []
        for e, t in zip(dims, target):
            if set(_axes(e)) == set(t):
                out.append(e)
            else:
                out.append(self._retile(e, t))
        return Pl(tuple(out))

    @staticmethod
    def _dims_len(entry) -> int:
        return math.prod(n for n, _ in entry)

    def _retile(self, entry, axes) -> tuple:
        """``entry`` sharded by ``axes`` instead: the factors keep the
        axes they keep; one that comes goes to the outermost factor it
        divides (else the outermost)."""
        keep = [(n, tuple(a for a in ax if a in axes)) for n, ax in entry]
        have = {a for _, ax in keep for a in ax}
        for a in axes:
            if a in have:
                continue
            for i, (n, ax) in enumerate(keep):
                if n % (self._size(ax) * self._size((a,))) == 0:
                    keep[i] = (n, ax + (a,))
                    break
            else:
                n, ax = keep[0]
                keep[0] = (n, ax + (a,))
        return tuple(keep)

    def use(self, t: torch.Tensor, target: tuple) -> Pl:
        """:meth:`reshard` ``t`` to ``target`` for one use; a pending sum
        it resolves is resolved for the tensor's later uses too (XLA
        all-reduces a value once)."""
        pl = self.get(t)
        out = self.reshard(pl, target, t.element_size())
        if pl.partial:
            done = Pl(pl.dims) if self._bytes(out, 1) >= \
                self._bytes(Pl(pl.dims), 1) else out
            self._effects.append((t, done))
            self._set(t, done)
        return out

    def resolved(self, t: torch.Tensor) -> Pl:
        """``t``'s placement with its pending sum all-reduced."""
        return self.use(t, tuple(_axes(e) for e in self.get(t).dims))

    def finish(self, out) -> None:
        """Take the step's results whole: their pending sums are
        all-reduced, as a jitted function's results are whole values."""
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.resolved(t)

    def move_rows(self, axes: tuple, src_len: int, dst_len: int,
                  pieces, row_bytes: int) -> None:
        """Count the collective-permutes that move rows along a dim
        sharded by ``axes``: ``pieces`` are ``(lo, hi, offset)``, source
        rows ``[lo, hi)`` landing at ``lo + offset``.  A row changes
        owner when its source and destination shards differ; one
        permute a piece and a shift carries the most rows any pair of
        that shift exchanges."""
        g = self._size(axes)
        if g == 1 or not axes:
            return
        s, t = -(-src_len // g), -(-dst_len // g)
        for lo, hi, off in pieces:
            shifts: dict = {}
            for i in range(lo // s, min(g, -(-hi // s))):
                a, b = max(lo, i * s), min(hi, (i + 1) * s)
                j0, j1 = (a + off) // t, (b - 1 + off) // t
                for j in range(j0, j1 + 1):
                    if j == i:
                        continue
                    c = min(b + off, (j + 1) * t) - max(a + off, j * t)
                    if c > 0:
                        d = (j - i) % g
                        shifts[d] = max(shifts.get(d, 0), c)
            for c in shifts.values():
                self._event("collective-permute", c * row_bytes, axes)

    # -- the pass --------------------------------------------------------
    def propagate(self, func, args, kwargs, out) -> None:
        """Give ``out`` its placements and count what ``func`` needs."""
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        if not outs:
            return
        leaves = [x for x in pytree.tree_leaves((args, kwargs))
                  if isinstance(x, torch.Tensor)]
        key = self._key(func, args, kwargs)
        hit = None if key is None else self.memo.get(key)
        if hit is not None:
            pls, events, effects, pieces = hit
            self.events.extend(events)
            for i, pl in effects:
                self._set(leaves[i], pl)
            if pieces is not None:
                self._set_pieces(outs[0], *pieces)
        else:
            n0 = len(self.events)
            self._effects = []
            rule = _RULES.get(func.overloadpacket.__name__)
            if rule is None:
                rule = _pointwise if _is_pointwise(func, args, outs) \
                    else _unknown
            pls = rule(self, func, args, kwargs, outs)
            if key is not None:
                ids = {id(x): i for i, x in enumerate(leaves)}
                effects = [(ids[id(t)], pl) for t, pl in self._effects
                           if id(t) in ids]
                got = getattr(outs[0], "_repro_cat", None)
                pieces = got[1:] if got and got[0] is self._token else None
                self.memo[key] = (pls, self.events[n0:], effects, pieces)
        for o, pl in zip(outs, pls):
            if pl is not None and len(pl.dims) == o.dim():
                self._set(o, pl)
        if func.overloadpacket.__name__ in _RESHAPES and any(
                ":" in a for e in pls[0].dims for a in _axes(e)) and not any(
                ":" in a for e in self.get(args[0]).dims for a in _axes(e)):
            outs[0]._repro_split = self._token     # split an axis just now

    def _key(self, func, args, kwargs):
        """The memo key of a call: the operation, each tensor's shape,
        dtype and placement (and, for a concatenation, its pieces),
        each other argument by value; None for any other call."""
        key = [func]
        for x in pytree.tree_leaves((args, kwargs)):
            if isinstance(x, torch.Tensor):
                cat = getattr(x, "_repro_cat", None)
                key.append((tuple(x.shape), x.dtype, self.get(x),
                            cat[1:] if cat and cat[0] is self._token
                            else None))
            elif isinstance(x, (bool, int, float, str, type(None),
                                torch.dtype, torch.device, torch.layout,
                                torch.memory_format)):
                key.append((type(x), x))
            else:
                return None
        return tuple(key)

    def constrain(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        """``x`` moved to ``spec`` (a resolved template), and its
        cotangent moved to it in the backward pass."""
        return _Constrain.apply(x, tuple(_spec_axes(e) for e in spec))

    def carry(self, x: torch.Tensor, leaving: bool) -> torch.Tensor:
        """``shardctx.scan_carry``'s pass side."""
        if leaving:
            self.carry_exit = tuple(_axes(e) for e in self.get(x).dims)
            return x
        self.resolved(x)        # the value the scan starts from is whole
        if self.carry_entry is None:
            return x
        return self.constrain(x, self.carry_entry)

    def _to(self, t: torch.Tensor, axes: tuple) -> torch.Tensor:
        y = t.view(t.shape)
        axes = tuple(axes) + ((),) * (t.dim() - len(axes))
        fresh = getattr(t, "_repro_split", None) is self._token
        self._set(y, self.reshard(self.get(t), axes, t.element_size(),
                                  together=fresh))
        return y


class _Constrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return active()._to(x, axes)

    @staticmethod
    def backward(ctx, g):
        part = active()
        return (g if part is None else part._to(g, ctx.axes)), None


# ---------------------------------------------------------------------------
# rules: (partition, func, args, kwargs, outs) -> a placement an output
# ---------------------------------------------------------------------------

def _is_pointwise(func, args, outs) -> bool:
    if torch.Tag.pointwise in func.tags:
        return True
    ins = [a for a in pytree.tree_leaves(args)
           if isinstance(a, torch.Tensor)]
    if not ins:
        return False
    try:
        shape = torch.broadcast_shapes(*(t.shape for t in ins))
    except RuntimeError:
        return False
    return all(tuple(o.shape) == tuple(shape) for o in outs)


def _tensors(args) -> list:
    return [a for a in pytree.tree_leaves(args) if isinstance(a, torch.Tensor)]


#: pointwise operations linear in every tensor argument (the copies and
#: views that keep a pending sum have rules of their own)
_LINEAR = frozenset({"add", "sub", "neg"})
#: operations linear in their first argument when only it is partial
_LINEAR_FIRST = frozenset({"mul", "div"})


def _pointwise(P: Partition, func, args, kwargs, outs):
    ins = _tensors((args, kwargs))
    out = outs[0]
    nd = out.dim()
    name = func.overloadpacket.__name__.rstrip("_")
    inplace = bool(ins) and ins[0] is out

    def mapped(t):
        pl = P.get(t)
        off = nd - t.dim()
        dims = [None] * nd
        for i, e in enumerate(pl.dims):
            if t.shape[i] == out.shape[i + off] and t.shape[i] != 1:
                dims[i + off] = e
        return dims, pl

    cands = [(mapped(t), t) for t in ins if t.dim() <= nd]
    if not cands:
        return [replicated(out.shape)] * len(outs)

    def rank(c):
        (dims, _), t = c
        return (P._size(tuple(a for e in dims if e for a in _axes(e))),
                t.numel())

    base = cands[0] if inplace else max(cands, key=rank)
    entries = list(base[0][0])
    used = {a for e in entries if e for a in _axes(e)}
    if not inplace:
        for (dims, _), _t in cands:
            for i, e in enumerate(dims):
                if entries[i] is None or not _axes(entries[i]):
                    ax = _axes(e) if e else ()
                    if ax and not P.clash(ax, used):
                        entries[i] = e
                        used |= set(ax)
    entries = [e if e is not None else _entry(out.shape[i])
               for i, e in enumerate(entries)]
    partials = {tuple(sorted(P.get(t).partial)) for t in ins}
    partial = ()
    if name in _LINEAR and len(partials) == 1:
        partial = next(iter(partials))
    elif name in _LINEAR_FIRST and ins and P.get(ins[0]).partial and all(
            not P.get(t).partial for t in ins[1:]):
        partial = P.get(ins[0]).partial
    for t in ins:
        if t.dim() > nd:
            continue
        pl = P.get(t)
        off = nd - t.dim()
        target = tuple(() if t.shape[i] == 1 and out.shape[i + off] != 1
                       else _axes(entries[i + off]) for i in range(t.dim()))
        if partial:
            P.reshard(Pl(pl.dims), target, t.element_size())
        else:
            P.use(t, target)
    pl = Pl(tuple(entries), tuple(partial))
    return [pl if o.dim() == nd and tuple(o.shape) == tuple(out.shape)
            else replicated(o.shape) for o in outs]


def _unknown(P: Partition, func, args, kwargs, outs):
    P.unknown.add(str(func))
    for t in _tensors((args, kwargs)):
        P.use(t, ((),) * t.dim())
    return [replicated(o.shape) for o in outs]


def _same(P, func, args, kwargs, outs):
    """Views and copies that keep the layout: alias, detach, clone,
    _to_copy, fill_, zero_, the *_like factories (no pending sum)."""
    pl = P.get(args[0])
    if func.overloadpacket.__name__.endswith("_like") or \
            func.overloadpacket.__name__ in ("fill_", "zero_"):
        pl = Pl(pl.dims)
    return [pl] * len(outs)


def _factory(P, func, args, kwargs, outs):
    return [replicated(o.shape) for o in outs]


def _copy_(P, func, args, kwargs, outs):
    dst, src = args[0], args[1]
    pl = P.get(dst)
    target = tuple(_axes(e) for e in pl.dims)
    off = dst.dim() - src.dim()
    P.use(src, tuple(target[i + off] if src.shape[i] != 1 else ()
                     for i in range(src.dim())))
    return [Pl(pl.dims)]


def _reshape_entries(P, pl: Pl, in_shape, out_shape):
    """The factors of ``pl`` regrouped to ``out_shape``: ``(entries,
    ())``, or ``(None, axes)`` with the axes to gather first (a factor
    split unevenly: XLA gathers it before the reshape; ``axes`` empty:
    the dims do not regroup at all)."""
    factors = [f for e, n in zip(pl.dims, in_shape) if n != 1 for f in e
               if f[0] != 1]
    out = []
    for m in out_shape:
        if m == 1:
            out.append(_entry(1))
            continue
        acc, got = 1, []
        while acc < m:
            if not factors:
                return None, ()
            n, ax = factors.pop(0)
            if m % (acc * n) == 0:
                got.append((n, ax))
                acc *= n
            elif n % (m // acc) == 0:
                r = m // acc
                g = P._size(ax)
                if r % g == 0:
                    got.append((r, ax))
                    factors.insert(0, (n // r, ()))
                elif len(ax) == 1 and g % r == 0 and (n // r) % (g // r) == 0:
                    # XLA splits the axis: its major part shards the outer
                    # dim, the rest the inner one
                    outer, inner = P.split(ax[0], r)
                    got.append((r, (outer,)))
                    factors.insert(0, (n // r, (inner,)))
                else:
                    return None, ax
                acc = m
            else:
                return None, ()
        out.append(tuple(got))
    if factors:
        return None, ()
    return out, ()


def _view(P, func, args, kwargs, outs):
    x, out = args[0], outs[0]
    pl = P.get(x)
    while True:
        ents, bad = _reshape_entries(P, pl, tuple(x.shape), tuple(out.shape))
        if ents is not None:
            return [Pl(tuple(ents), pl.partial)]
        target = tuple(tuple(a for a in _axes(e) if a not in bad) if bad
                       else () for e in pl.dims)
        pl = Pl(P.reshard(Pl(pl.dims), target, x.element_size()).dims,
                pl.partial)


def _expand(P, func, args, kwargs, outs):
    x, out = args[0], outs[0]
    pl = P.resolved(x)      # a sum is cheaper before the broadcast
    off = out.dim() - x.dim()
    dims = [_entry(n) for n in out.shape]
    for i, e in enumerate(pl.dims):
        if x.shape[i] == out.shape[i + off]:
            dims[i + off] = e
    return [Pl(tuple(dims))]


def _permute(P, func, args, kwargs, outs):
    x = args[0]
    pl = P.get(x)
    nd = x.dim()
    name = func.overloadpacket.__name__
    if name == "permute":
        order = [d % nd for d in args[1]]
    elif name == "t":
        order = list(range(nd))[::-1]
    else:
        order = list(range(nd))
        a, b = args[1] % nd, args[2] % nd
        order[a], order[b] = order[b], order[a]
    return [Pl(tuple(pl.dims[i] for i in order), pl.partial)]


def _unsqueeze(P, func, args, kwargs, outs):
    x, out = args[0], outs[0]
    pl = P.get(x)
    d = args[1] % out.dim()
    dims = list(pl.dims)
    dims.insert(d, _entry(1))
    return [Pl(tuple(dims), pl.partial)]


def _squeeze(P, func, args, kwargs, outs):
    x = args[0]
    pl = P.get(x)
    if len(args) > 1:
        ds = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
        ds = {d % max(x.dim(), 1) for d in ds}
    else:
        ds = set(range(x.dim()))
    dims = [e for i, e in enumerate(pl.dims)
            if not (i in ds and x.shape[i] == 1)]
    return [Pl(tuple(dims), pl.partial)]


def _select(P, func, args, kwargs, outs):
    x, out = args[0], outs[0]
    d = args[1] % x.dim()
    pl = P.get(x)
    dims = list(pl.dims)
    ax = _axes(dims[d])
    del dims[d]
    res = Pl(tuple(dims), pl.partial)
    if ax:      # the row lives on one shard: a permute, then a masked sum
        P._event("collective-permute", P._bytes(res, x.element_size()), ax)
        res = Pl(tuple(dims), tuple(pl.partial) + ax)
    return [res]


def _slice_pl(P, x, pl: Pl, d: int, lo: int, hi: int, step: int = 1):
    """The placement of ``x[..., lo:hi:step, ...]`` along dim ``d``,
    counting the rows that change owner."""
    n = x.shape[d]
    lo, hi = max(0, min(lo, n)), max(0, min(hi, n))
    m = max(0, -(-(hi - lo) // step))
    e = pl.dims[d]
    ax = _axes(e)
    dims = list(pl.dims)
    if not ax or m == n:
        dims[d] = e if m == n else _entry(m)
        return Pl(tuple(dims), pl.partial)
    if step != 1:
        dims = list(P.reshard(Pl(pl.dims), tuple(
            () if i == d else _axes(f) for i, f in enumerate(pl.dims)),
            x.element_size()).dims)
        dims[d] = _entry(m)
        return Pl(tuple(dims), pl.partial)
    g = P._size(ax)
    if m < g:    # fewer rows than shards: a permute, a masked sum
        dims[d] = _entry(m)
        P._event("collective-permute", P._bytes(Pl(tuple(dims)),
                                                x.element_size()), ax)
        return Pl(tuple(dims), tuple(pl.partial) + ax)
    dims[d] = _entry(m, ax)
    row = P._bytes(Pl(tuple(dims)), x.element_size()) // -(-m // g)
    P.move_rows(ax, n, m, [(lo, hi, -lo)], row)
    return Pl(tuple(dims), pl.partial)


def _slice(P, func, args, kwargs, outs):
    x = args[0]
    d = (args[1] if len(args) > 1 else 0) % x.dim()
    lo = args[2] if len(args) > 2 and args[2] is not None else 0
    hi = args[3] if len(args) > 3 and args[3] is not None else x.shape[d]
    step = args[4] if len(args) > 4 else 1
    n = x.shape[d]
    lo = lo + n if lo < 0 else lo
    hi = min(hi + n if hi < 0 else hi, n)
    whole = P.piece(x, d, lo, hi) if step == 1 else None
    if whole is not None:
        return [whole]
    return [_slice_pl(P, x, P.get(x), d, lo, hi, step)]


def _split(P, func, args, kwargs, outs):
    x = args[0]
    name = func.overloadpacket.__name__
    d = (args[2] if len(args) > 2 else kwargs.get("dim", 0)) % x.dim()
    if name == "unbind":
        d = (args[1] if len(args) > 1 else 0) % x.dim()
        return [_select(P, func, (x, d, i), {}, [o])[0]
                for i, o in enumerate(outs)]
    pl = P.get(x)
    res, lo = [], 0
    for o in outs:
        m = o.shape[d]
        res.append(_slice_pl(P, x, pl, d, lo, lo + m))
        lo += m
    return res


def _cat(P, func, args, kwargs, outs):
    ts = [t for t in args[0] if t.numel() or t.dim() > 1]
    out = outs[0]
    d = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) % out.dim()
    if not ts:
        return [replicated(out.shape)]
    # the other dims: as a pointwise op would lay them out
    best = max(ts, key=lambda t: (P._size(_axes(P.get(t).dims[d])),
                                  t.numel()))
    ax = _axes(P.get(best).dims[d])
    entries, used = [], set(ax)
    for i in range(out.dim()):
        if i == d:
            entries.append(_entry(out.shape[d], ax))
            continue
        e = max((P.get(t).dims[i] for t in ts),
                key=lambda e: P._size(_axes(e)))
        if P.clash(_axes(e), used):
            e = _entry(out.shape[i])
        used |= set(_axes(e))
        entries.append(e)
    g = P._size(ax)
    off, pieces, moves = 0, [], False
    for t in ts:
        tax = _axes(P.get(t).dims[d])
        target = tuple(_axes(entries[i]) if i != d else
                       (tax if set(tax) == set(ax) else ())
                       for i in range(t.dim()))
        pl = P.use(t, target)
        sharded = bool(ax) and set(tax) == set(ax)
        moves |= sharded and _moves(g, t.shape[d], out.shape[d], off)
        pieces.append((off, t.shape[d], pl, sharded, t.element_size()))
        off += t.shape[d]
    res = Pl(tuple(entries))
    if moves and out.shape[d] % g:
        # a result that does not split evenly is put together whole: the
        # sharded pieces are gathered (and the result sliced, locally)
        for _, _, pl, sharded, size in pieces:
            if sharded:
                P._event("all-gather", P._bytes(pl, size) * g, ax)
    elif moves:
        # XLA moves each piece off the dim with an all-to-all,
        # concatenates, and moves the result back with another
        for _, _, pl, _, size in pieces:
            P._event("all-to-all", P._bytes(pl, size), ax)
        P._event("all-to-all", P._bytes(res, out.element_size()), ax)
    # a slice that takes back one piece whole is that piece
    P._set_pieces(outs[0], d, [(o, n, pl) for o, n, pl, _, _ in pieces])
    return [res]


def _moves(g: int, n: int, m: int, off: int) -> bool:
    """Whether some of ``n`` rows sharded ``g`` ways change owner when
    they land at ``off`` in ``m`` rows sharded ``g`` ways."""
    s, t = -(-n // g), -(-m // g)
    return any(r // s != (r + off) // t for r in range(n))


def _stack(P, func, args, kwargs, outs):
    ts = args[0]
    out = outs[0]
    d = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) % out.dim()
    fake = []
    for t in ts:
        pl = P.get(t)
        dims = list(pl.dims)
        dims.insert(d, _entry(1))
        fake.append(Pl(tuple(dims), pl.partial))
    entries = [_entry(n) for n in out.shape]
    used: set = set()
    for pl in sorted(fake, key=lambda p: -P.shard_numel(p)):
        for i, e in enumerate(pl.dims):
            if i != d and _axes(e) and not P.clash(_axes(e), used) \
                    and not _axes(entries[i]):
                entries[i] = e
                used |= set(_axes(e))
    for t in ts:
        tgt = tuple(_axes(entries[i if i < d else i + 1])
                    for i in range(t.dim()))
        P.use(t, tgt)
    return [Pl(tuple(entries))]


def _pad(P, func, args, kwargs, outs):
    x, out = args[0], outs[0]
    pad = list(args[1])
    pl = P.resolved(x)
    dims = list(pl.dims)
    for k in range(len(pad) // 2):
        d = x.dim() - 1 - k
        left, right = pad[2 * k], pad[2 * k + 1]
        if left == 0 and right == 0:
            continue
        ax = _axes(dims[d])
        dims[d] = _entry(out.shape[d], ax)
        if ax:
            g = P._size(ax)
            row = P._bytes(Pl(tuple(dims)), x.element_size()) \
                // -(-out.shape[d] // g)
            lo = max(0, -left)
            hi = x.shape[d] - max(0, -right)
            P.move_rows(ax, x.shape[d], out.shape[d], [(lo, hi, left)], row)
    return [Pl(tuple(dims))]


def _slice_backward(P, func, args, kwargs, outs):
    g, sizes, d, lo, hi, step = args[:6]
    out = outs[0]
    d %= out.dim()
    n = sizes[d]
    lo = lo + n if lo < 0 else lo
    pl = P.get(g)
    ax = _axes(pl.dims[d])
    dims = list(pl.dims)
    dims[d] = _entry(n, ax)
    if ax and step == 1:
        # XLA gathers the piece and pads it where it lies
        if _moves(P._size(ax), g.shape[d], n, lo):
            P._event("all-gather", P._bytes(Pl(pl.dims), g.element_size())
                     * P._size(ax), ax)
    elif ax:
        dims = list(P.reshard(Pl(pl.dims), tuple(
            () if i == d else _axes(e) for i, e in enumerate(pl.dims)),
            g.element_size()).dims)
        dims[d] = _entry(n)
    return [Pl(tuple(dims), pl.partial)]


def _select_backward(P, func, args, kwargs, outs):
    g, sizes, d, _ = args[:4]
    out = outs[0]
    d %= out.dim()
    pl = P.get(g)
    dims = list(pl.dims)
    dims.insert(d, _entry(sizes[d]))
    return [Pl(tuple(dims), pl.partial)]


def _reduced_dims(x, args, kwargs) -> tuple:
    dim = args[1] if len(args) > 1 else kwargs.get("dim")
    if dim is None or (isinstance(dim, (list, tuple)) and not dim):
        return tuple(range(x.dim()))
    if isinstance(dim, int):
        dim = [dim]
    return tuple(sorted(d % max(x.dim(), 1) for d in dim))


def _keepdim(args, kwargs) -> bool:
    if len(args) > 2 and isinstance(args[2], bool):
        return args[2]
    return bool(kwargs.get("keepdim", False))


def _reduction(P, func, args, kwargs, outs, linear: bool):
    x = args[0]
    pl = P.get(x) if linear else P.resolved(x)
    rd = _reduced_dims(x, args, kwargs) if x.dim() else ()
    keep = _keepdim(args, kwargs) and x.dim() == outs[0].dim()
    red_axes = tuple(a for d in rd for a in _axes(pl.dims[d]))
    dims = []
    for i, e in enumerate(pl.dims):
        if i in rd:
            if keep:
                dims.append(_entry(1))
        else:
            dims.append(e)
    res = Pl(tuple(dims), tuple(pl.partial) + red_axes)
    if not linear and red_axes:
        for o in outs:
            P._event("all-reduce", P._bytes(Pl(res.dims), o.element_size()),
                     red_axes)
        res = Pl(res.dims)
    return [res] * len(outs)


def _sum(P, func, args, kwargs, outs):
    return _reduction(P, func, args, kwargs, outs, linear=True)


def _max(P, func, args, kwargs, outs):
    return _reduction(P, func, args, kwargs, outs, linear=False)


def _logsumexp(P, func, args, kwargs, outs):
    res = _reduction(P, func, args, kwargs, outs, linear=False)
    x = args[0]
    rd = _reduced_dims(x, args, kwargs)
    ax = tuple(a for d in rd for a in _axes(P.get(x).dims[d]))
    if ax:      # the max, then the sum of exponentials
        P._event("all-reduce", P._bytes(res[0], outs[0].element_size()), ax)
    return res


def _softmax(P, func, args, kwargs, outs):
    """softmax / log_softmax (x, dim, ...) and their backward (grad,
    out, dim, ...): a sharded dim costs a stat all-reduce a pass (two
    forward: max and sum; one backward)."""
    name = func.overloadpacket.__name__
    ins = [t for t in args if isinstance(t, torch.Tensor)]
    d = next(a for a in args[1:] if isinstance(a, int) and
             not isinstance(a, bool)) % ins[0].dim()
    res = _pointwise(P, func, tuple(ins), {}, outs)
    pl = res[0]
    ax = _axes(pl.dims[d])
    if ax:
        dims = list(pl.dims)
        dims[d] = _entry(1)
        stat = P._bytes(Pl(tuple(dims)), 4)
        for _ in range(1 if "backward" in name else 2):
            P._event("all-reduce", stat, ax)
    return [Pl(pl.dims)] * len(outs)


def _along(P, func, args, kwargs, outs):
    """sort, argsort, topk, cumsum, cummax, ...: the dim they run along
    is gathered."""
    x = args[0]
    name = func.overloadpacket.__name__
    if name == "topk":
        d = args[2] if len(args) > 2 else kwargs.get("dim", -1)
    else:
        d = args[1] if len(args) > 1 and isinstance(args[1], int) \
            and not isinstance(args[1], bool) else kwargs.get("dim", -1)
    d %= x.dim()
    pl = P.use(x, tuple(() if i == d else _axes(e)
                        for i, e in enumerate(P.get(x).dims)))
    res = []
    for o in outs:
        dims = list(pl.dims)
        dims[d] = _entry(o.shape[d])
        res.append(Pl(tuple(dims)))
    return res


def _dot(P, A, B, la, lb, lo, out):
    """A contraction of ``A`` (labels ``la``) with ``B`` (``lb``) into
    ``lo``: the axes each operand keeps, the gathers, the partial
    sum."""
    pa, pb = P.get(A), P.get(B)
    if pa.partial and pb.partial:
        pb = P.resolved(B)
    ea, eb = dict(zip(la, pa.dims)), dict(zip(lb, pb.dims))
    ta = {k: list(_axes(e)) for k, e in ea.items()}
    tb = {k: list(_axes(e)) for k, e in eb.items()}
    batch = set(la) & set(lb) & set(lo)
    contr = (set(la) & set(lb)) - set(lo)
    shape = {**dict(zip(lb, B.shape)), **dict(zip(la, A.shape))}

    def where(t, x):
        return next((k for k, v in t.items() if x in v), None)

    def nbytes(t, labels, itemsize):
        return math.prod(-(-shape[k] // P._size(tuple(t[k])))
                         for k in labels) * itemsize

    def out_bytes():
        return math.prod(-(-shape[k] // P._size(tuple(
            ta.get(k, tb.get(k, []))))) for k in lo) * out.element_size()

    # one axis split differently by the operands (the axis on one, its
    # sub-axes on the other) clashes: the cheaper operand gathers it
    for _ in range(2):
        ca = [x for v in ta.values() for x in v if any(
            y != x and P.clash((x,), (y,)) for w in tb.values() for y in w)]
        cb = [y for w in tb.values() for y in w if any(
            y != x and P.clash((x,), (y,)) for v in ta.values() for x in v)]
        if not ca:
            break
        if nbytes(tb, lb, B.element_size()) <= \
                nbytes(ta, la, A.element_size()):
            tb = {k: [a for a in v if a not in cb] for k, v in tb.items()}
        else:
            ta = {k: [a for a in v if a not in ca] for k, v in ta.items()}
    axes = list(dict.fromkeys([a for v in ta.values() for a in v]
                              + [a for v in tb.values() for a in v]))
    for x in axes:
        ka, kb = where(ta, x), where(tb, x)
        if ka == kb:
            continue
        if ka is not None and kb is not None:
            if nbytes(tb, lb, B.element_size()) <= \
                    nbytes(ta, la, A.element_size()):
                tb[kb].remove(x)
                kb = None
            else:
                ta[ka].remove(x)
                ka = None
        for k, t, o, op, ob in ((ka, ta, tb, A, la), (kb, tb, ta, B, lb)):
            if k is None:
                continue
            if k in batch:
                o[k].append(x)
            elif k in contr:
                if out_bytes() <= nbytes(t, ob, op.element_size()):
                    o[k].append(x)
                else:
                    t[k].remove(x)
    partial = tuple(a for k in contr for a in ta[k] if a in tb[k])
    P.reshard(Pl(pa.dims), tuple(tuple(ta[k]) for k in la),
              A.element_size())
    P.reshard(Pl(pb.dims), tuple(tuple(tb[k]) for k in lb),
              B.element_size())
    dims = []
    for k in lo:
        src = ea if k in ta else eb
        t = ta if k in ta else tb
        e = src[k]
        dims.append(e if set(_axes(e)) == set(t[k]) else
                    _entry(shape[k], tuple(t[k])))
    res = Pl(tuple(dims), tuple(pa.partial) + tuple(pb.partial))
    if partial:     # XLA all-reduces a contraction's partial sum at once
        P._event("all-reduce", P._bytes(res, out.element_size()), partial)
    return res


def _mm(P, func, args, kwargs, outs):
    name = func.overloadpacket.__name__
    out = outs[0]
    if name in ("addmm", "baddbmm"):
        bias, A, B = args[0], args[1], args[2]
    else:
        bias, A, B = None, args[0], args[1]
    if A.dim() == 3:
        pl = _dot(P, A, B, "bmk", "bkn", "bmn", out)
    elif A.dim() == 2 and B.dim() == 2:
        pl = _dot(P, A, B, "mk", "kn", "mn", out)
    elif A.dim() == 2:
        pl = _dot(P, A, B, "mk", "k", "m", out)
    else:
        pl = _dot(P, A, B, "k", "k", "", out)
    if bias is not None:
        if pl.partial:
            pl = P.reshard(pl, tuple(_axes(e) for e in pl.dims),
                           out.element_size())
        off = out.dim() - bias.dim()
        P.use(bias, tuple(() if bias.shape[i] == 1 else
                          _axes(pl.dims[i + off]) for i in range(bias.dim())))
    return [pl]


def _index(P, func, args, kwargs, outs):
    """``x[idx...]`` (aten.index): the indexed dims of ``x`` replaced by
    the broadcast index shape."""
    x, idx, out = args[0], list(args[1]), outs[0]
    pos = [i for i, t in enumerate(idx) if t is not None]
    its = [idx[i] for i in pos]
    bshape = torch.broadcast_shapes(*(t.shape for t in its))
    nb = len(bshape)
    pl = P.resolved(x)
    # the indices' layout: as a pointwise op over them
    ient = [_entry(n) for n in bshape]
    used: set = set()
    for t in its:
        off = nb - t.dim()
        for i, e in enumerate(P.get(t).dims):
            if t.shape[i] == bshape[i + off] and _axes(e) and \
                    not P.clash(_axes(e), used) and not _axes(ient[i + off]):
                ient[i + off] = e
                used |= set(_axes(e))
    consecutive = pos == list(range(pos[0], pos[0] + len(pos)))
    lead = pos[0] if consecutive else 0
    rest = [i for i in range(x.dim()) if i not in pos]
    before = [i for i in rest if i < lead] if consecutive else []
    after = [i for i in rest if i not in before]
    idx_ax = tuple(a for i in pos for a in _axes(pl.dims[i]))
    # the other dims keep x's axes unless the indices use them
    keep = {i: tuple(a for a in _axes(pl.dims[i]) if not P.clash((a,), used))
            for i in rest}
    dims = ([_entry(x.shape[i], keep[i]) if set(keep[i]) != set(
        _axes(pl.dims[i])) else pl.dims[i] for i in before] + ient
        + [_entry(x.shape[i], keep[i]) if set(keep[i]) != set(
            _axes(pl.dims[i])) else pl.dims[i] for i in after])
    if idx_ax:
        # GSPMD's way: a masked lookup into the local rows, summed; where
        # a use wants the summed axis on a dim, the table is gathered
        tgt = tuple(_axes(pl.dims[i]) if i in pos else keep[i]
                    for i in range(x.dim()))
        P.reshard(pl, tgt, x.element_size())
        return [Pl(tuple(dims), idx_ax,
                   P._bytes(pl, x.element_size()) * P._size(idx_ax))]
    P.reshard(pl, tuple(() if i in pos else keep[i]
                        for i in range(x.dim())), x.element_size())
    return [Pl(tuple(dims))]


def _embedding(P, func, args, kwargs, outs):
    w, ids = args[0], args[1]
    return _index(P, func, (w, [ids]), {}, outs)


def _index_select(P, func, args, kwargs, outs):
    x, d, ids = args[0], args[1] % args[0].dim(), args[2]
    idx = [None] * d + [ids]
    return _index(P, func, (x, idx), {}, outs)


def _gather(P, func, args, kwargs, outs):
    x, d, ids = args[0], args[1] % args[0].dim(), args[2]
    out = outs[0]
    pl = P.resolved(x)
    ip = P.get(ids)
    dims = []
    for i in range(out.dim()):
        ia, xa = _axes(ip.dims[i]), _axes(pl.dims[i]) if i != d else ()
        dims.append(ip.dims[i] if ia or not xa or ids.shape[i] != x.shape[i]
                    else pl.dims[i])
    used = {a for e in dims for a in _axes(e)}
    xd = tuple(a for a in _axes(pl.dims[d]) if not P.clash((a,), used))
    res = Pl(tuple(dims))
    tgt = [(_axes(dims[i]) if x.shape[i] == ids.shape[i] else ())
           for i in range(x.dim())]
    if xd and P._bytes(res, out.element_size()) < P._bytes(
            pl, x.element_size()):
        # a masked gather from the local rows, summed at once
        tgt[d] = xd
        P._event("all-reduce", P._bytes(res, out.element_size()), xd)
    else:
        tgt[d] = ()
    P.reshard(pl, tuple(tgt), x.element_size())
    P.use(ids, tuple(_axes(e) for e in dims))
    return [res]


def _scatter(P, func, args, kwargs, outs):
    """scatter / scatter_add (self, dim, index, src) and index_add
    (self, dim, index, source): ``self``'s layout; updates sharded along
    the scattered dim by axes ``self`` does not use there are a pending
    sum."""
    name = func.overloadpacket.__name__.rstrip("_")
    x = args[0]
    d = args[1] % x.dim()
    ids = args[2]
    src = args[3] if len(args) > 3 and isinstance(args[3], torch.Tensor) \
        else None
    pl = P.resolved(x)
    dims = list(pl.dims)
    ups = [t for t in (ids, src) if t is not None and t.dim() == x.dim()]
    # the other dims: the updates' axes where self has none
    for i in range(x.dim()):
        if i == d or _axes(dims[i]):
            continue
        for t in ups:
            e = P.get(t).dims[i]
            used = {a for f in dims for a in _axes(f)}
            if _axes(e) and t.shape[i] == x.shape[i] and \
                    not P.clash(_axes(e), used):
                dims[i] = e
                break
    if name == "index_add" and src is not None and not _axes(dims[d]):
        # a sum into a fresh buffer from blocks of rows (groups flattened
        # in): the blocks' axes stay, as XLA's batched scatter keeps them
        f0 = P.get(ids).dims[0]
        used = {a for f in dims for a in _axes(f)}
        if len(f0) > 1 and f0[0][1] and not P.clash(f0[0][1], used) and \
                P.get(src).dims[d][0][1] == f0[0][1] and \
                x.shape[d] % P._size(f0[0][1]) == 0:
            dims[d] = _entry(x.shape[d], f0[0][1])
    used = {a for f in dims for a in _axes(f)}
    partial: tuple = ()
    for t in ([ids, src] if name == "index_add" else ups):
        if t is None:
            continue
        tp = P.get(t)
        if tp.partial:
            tp = P.resolved(t)
        if name == "index_add":
            dd = 0 if t is ids else d
            pax = tuple(a for a in _axes(tp.dims[dd])
                        if not P.clash((a,), used))
            kept = tuple(a for a in _axes(tp.dims[dd])
                         if a in pax or a in _axes(dims[d]))
            tgt = tuple(_axes(dims[i]) if i != dd else kept
                        for i in range(t.dim())) if t is src else (kept,)
        else:
            pax = tuple(a for a in _axes(tp.dims[d])
                        if not P.clash((a,), used))
            tgt = tuple(_axes(dims[i]) if i != d else pax
                        for i in range(t.dim()))
        partial = tuple(dict.fromkeys(partial + pax))
        P.use(t, tgt)
    return [Pl(tuple(dims), partial)]


def _index_put(P, func, args, kwargs, outs):
    """index_put(self, indices, values, accumulate): ``self``'s layout;
    the values' index dims sharded by axes that shard none of ``self``'s
    indexed dims are a pending sum."""
    x, idx, vals = args[0], list(args[1]), args[2]
    pl = P.resolved(x)
    pos = [i for i, t in enumerate(idx) if t is not None]
    its = [idx[i] for i in pos]
    nb = len(torch.broadcast_shapes(*(t.shape for t in its)))
    rest = [i for i in range(x.dim()) if i not in pos]
    xin = {a for i in pos for a in _axes(pl.dims[i])}
    vp = P.resolved(vals)
    vdim = vals.dim()
    full = nb + len(rest)
    off = full - vdim
    tgt, partial = [], []
    for j in range(vdim):
        k = j + off
        if k < nb:
            ax = _axes(vp.dims[j])
            partial += [a for a in ax if a not in xin]
            tgt.append(ax)
        else:
            tgt.append(_axes(pl.dims[rest[k - nb]]))
    for t in its:
        P.resolved(t)
    P.use(vals, tuple(tgt))
    dims = list(pl.dims)
    accumulate = len(args) > 3 and bool(args[3])
    if accumulate and not any(_axes(e) for e in dims):
        # a sum into a fresh buffer: its rows go over the axes the
        # updates leave free, each device adding into its own (as XLA
        # lays a gradient out like its parameter)
        used = {a for t in tgt for a in t}
        spare = tuple(a for a in P.sizes if not P.clash((a,), used))
        d = pos[0]
        if spare and x.shape[d] % P._size(spare) == 0:
            dims[d] = _entry(x.shape[d], spare)
    return [Pl(tuple(dims), tuple(dict.fromkeys(partial)))]


def _embedding_backward(P, func, args, kwargs, outs):
    g, ids = args[0], args[1]
    out = outs[0]
    pl = P.get(g)
    ax = tuple(a for e in pl.dims[:-1] for a in _axes(e))
    dims = (_entry(out.shape[0]), pl.dims[-1])
    return [Pl(dims, tuple(pl.partial) + ax)]


#: rule a the operation name (``func.overloadpacket.__name__``)
_RULES = {}
for _n in ("alias", "detach", "clone", "_to_copy", "lift_fresh",
           "lift_fresh_copy", "contiguous", "fill_", "zero_", "zeros_like",
           "ones_like", "empty_like", "full_like", "rand_like",
           "randn_like"):
    _RULES[_n] = _same
for _n in ("zeros", "ones", "full", "empty", "empty_strided", "arange",
           "scalar_tensor", "new_zeros", "new_ones", "new_empty",
           "new_full", "randn", "rand", "randint", "eye", "linspace"):
    _RULES[_n] = _factory
_RESHAPES = ("view", "_unsafe_view", "reshape", "_reshape_alias")
for _n in _RESHAPES:
    _RULES[_n] = _view
for _n in ("permute", "transpose", "t"):
    _RULES[_n] = _permute
for _n in ("sum", "mean", "nansum"):
    _RULES[_n] = _sum
for _n in ("amax", "amin", "max", "min", "argmax", "argmin", "prod", "any",
           "all", "var", "std", "norm", "linalg_vector_norm",
           "count_nonzero"):
    _RULES[_n] = _max
for _n in ("_softmax", "_log_softmax", "_softmax_backward_data",
           "_log_softmax_backward_data"):
    _RULES[_n] = _softmax
for _n in ("sort", "argsort", "topk", "cumsum", "cumprod", "cummax",
           "cummin", "kthvalue", "msort"):
    _RULES[_n] = _along
for _n in ("mm", "bmm", "addmm", "baddbmm", "mv", "dot"):
    _RULES[_n] = _mm
for _n in ("scatter", "scatter_", "scatter_add", "scatter_add_",
           "index_add", "index_add_"):
    _RULES[_n] = _scatter
for _n in ("index_put", "index_put_", "_index_put_impl_"):
    _RULES[_n] = _index_put
for _n in ("split", "split_with_sizes", "unbind", "unsafe_split"):
    _RULES[_n] = _split
_RULES.update({
    "copy_": _copy_, "expand": _expand, "unsqueeze": _unsqueeze,
    "squeeze": _squeeze, "select": _select, "slice": _slice,
    "narrow": lambda P, f, a, k, o: _slice(
        P, f, (a[0], a[1], a[2], a[2] + a[3]), {}, o),
    "cat": _cat, "stack": _stack, "constant_pad_nd": _pad,
    "slice_backward": _slice_backward, "select_backward": _select_backward,
    "logsumexp": _logsumexp, "index": _index, "embedding": _embedding,
    "index_select": _index_select, "gather": _gather,
    "embedding_dense_backward": _embedding_backward,
})
