"""Device cost accounting of one tick: FLOPs and bytes a stage, and the
roofline against declared machine peaks.

Port of ``repro.obs.costmodel``.  The reference lowers the jitted tick
and reads XLA's ``cost_analysis()`` and the compiled HLO's
``named_scope`` metadata; PyTorch runs eagerly and has neither, so
:func:`analyze` runs the function ONCE under a
``TorchDispatchMode`` that sees every aten operation it executes:

* FLOPs: ``torch.utils.flop_counter``'s formula where it has one (the
  matmuls), one a result element for a pointwise operation, one an
  input element for a reduction; transcendental pointwise operations
  (``tanh``, ``exp``, ...) count as ``transcendentals`` instead, as XLA
  counts them;
* bytes: what each operation must move -- its inputs read once and its
  results written once -- except that a gather reads only what it
  gathers (its index and as many elements as it returns), an operation
  that writes into a tensor in place (not pointwise) writes only as
  much as it is given, and a view moves nothing.  The tick's ring is
  2^22 rows a shard, of which a tick touches a micro-batch;
* a composite operation with no formula of its own (``matmul``,
  ``einsum``: under ``torch.inference_mode()`` they reach the dispatch
  mode whole) is counted by the operations it decomposes into, as
  autograd would have decomposed it;
* on ``meta`` tensors (the dry run's) a call that returns new tensors
  runs once for each operation, shapes, strides, dtypes and other
  arguments: a repeat rebuilds its results from their shapes (and is
  counted as the first was);
* the hand kernels launch through ``ctypes``, which no dispatch mode
  sees: each wrapper reports its function's bytes and operations
  (``kernels.cost``, the counts ``chip_smoke.py`` bounds the kernels
  with) and the operations of its own body are not counted, so a call
  costs the same on the card and on the CPU (where the body is the
  plain version).  Its operations count as FLOPs.

Given a ``launch.partition.Partition``, the same pass gives every
tensor a placement on a mesh and counts the collectives the step would
need there (the dry run's); a kernel wrapper's plain body is propagated
through, though not counted.

Each count lands on the innermost ``obs:*`` span open at that moment on
the given recording ``Tracer`` (the executors' stage spans,
:data:`repro_torch.obs.trace.DEVICE_STAGES`), as the reference
attributes an HLO op to its innermost ``obs:*`` scope.

:func:`roofline` and :func:`stage_table` are the reference's, copied.
"""
from __future__ import annotations

import os

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

#: the analysis in progress (at most one), which kernel wrappers report to
_ACTIVE: list = []

#: pointwise operations XLA counts as transcendentals
_TRANSCENDENTAL = frozenset({
    "tanh", "exp", "exp2", "expm1", "log", "log2", "log10", "log1p",
    "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh",
    "sigmoid", "erf", "erfc", "erfinv", "sqrt", "rsqrt", "pow", "silu",
    "gelu", "_softmax", "_log_softmax"})
#: reductions: one FLOP an input element
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum",
    "cummax", "cummin", "cumprod", "any", "all", "argmax", "argmin",
    "logsumexp", "var", "std", "norm", "nansum", "count_nonzero"})
#: gathers: read their index and as many elements as they return
_GATHERS = frozenset({"index", "index_select", "gather", "take",
                      "embedding"})
#: operations that allocate or read a scalar and move no data
_FREE = frozenset({"empty", "empty_like", "empty_strided", "lift_fresh",
                   "_local_scalar_dense"})


def _cost(func, args, kwargs, out):
    """``(flops, transcendentals, bytes)`` of one aten operation (see the
    module's rules), or ``None`` for a view, metadata or a profiler
    range."""
    name = func.overloadpacket.__name__
    base = name.rstrip("_")
    if func.namespace != "aten" or func.is_view or base in _FREE:
        return None
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    from torch.utils.flop_counter import flop_registry
    pointwise = torch.Tag.pointwise in func.tags
    formula = flop_registry.get(func.overloadpacket)
    flops = trans = 0
    if formula is not None:
        flops = formula(*args, **kwargs, out_val=out)
    elif base in _TRANSCENDENTAL:
        trans = sum(o.numel() for o in outs)
    elif pointwise:
        flops = sum(o.numel() for o in outs)
    elif base in _REDUCTIONS and ins:
        flops = ins[0].numel()
    if base in _GATHERS:
        idx = [t for t in ins if not t.is_floating_point()
               and t.dtype != torch.bool]
        nbytes = sum(_nbytes(t) for t in idx[-1:]) \
            + 2 * sum(_nbytes(o) for o in outs)
    elif func._schema.is_mutable and not pointwise:
        written = {id(o) for o in outs}
        nbytes = 2 * sum(_nbytes(t) for t in ins if id(t) not in written)
    else:
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(o) for o in outs)
    return flops, trans, nbytes


#: leaf types a memo key takes by value
_KEY_TYPES = (bool, int, float, str, type(None), torch.dtype, torch.device,
              torch.layout, torch.memory_format)


def _meta_key(func, args, kwargs):
    """A key of a call on ``meta`` tensors whose result is new tensors (no
    view, nothing written in place): the operation, each tensor's shape,
    strides and dtype, each other argument by value; ``None`` for any
    other call."""
    if func.is_view or func._schema.is_mutable:
        return None
    key = [func, len(args), tuple(kwargs)]
    for x in pytree.tree_leaves((args, kwargs)):
        if isinstance(x, torch.Tensor):
            if not x.is_meta:
                return None
            key.append((tuple(x.shape), x.stride(), x.dtype))
        elif isinstance(x, _KEY_TYPES):
            key.append((type(x), x))
        else:
            return None
    return tuple(key)


def _spec(out):
    """The metadata to rebuild ``out`` (a ``meta`` tensor, or a tuple or
    list of them) from, or ``None``."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype) if out.is_meta \
            else None
    if isinstance(out, (tuple, list)) and out and all(
            isinstance(o, torch.Tensor) and o.is_meta for o in out):
        return type(out), [_spec(o) for o in out]
    return None


def _rebuild(spec):
    if isinstance(spec[0], tuple):
        shape, stride, dtype = spec
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    kind, parts = spec
    return kind(_rebuild(p) for p in parts)


def active():
    """The analysis in progress, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


class _Analysis:
    """The running totals of one :func:`analyze` pass."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.stages: dict = {}
        self.kernels: dict = {}
        self.paused = 0

    def _stage(self, nbytes: int) -> None:
        stage = None if self.tracer is None else self.tracer.open_stage()
        if stage is not None:
            agg = self.stages.setdefault(stage, {"ops": 0, "bytes": 0})
            agg["ops"] += 1
            agg["bytes"] += int(nbytes)

    def count(self, func, args, kwargs, out) -> None:
        """Add one operation's cost (:func:`_cost`)."""
        cost = _cost(func, args, kwargs, out)
        if cost is None:
            return
        flops, trans, nbytes = cost
        self.flops += flops
        self.transcendentals += trans
        self.bytes += nbytes
        self._stage(nbytes)

    def pause(self):
        """A context inside which operations are not counted."""
        return _Paused(self)

    def kernel(self, name: str, nbytes: int, ops: int):
        """Record one hand-kernel call; returns :meth:`pause` for its
        body."""
        self.flops += ops
        self.bytes += nbytes
        self._stage(nbytes)
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0, "ops": 0})
        k["calls"] += 1
        k["bytes"] += int(nbytes)
        k["ops"] += int(ops)
        return self.pause()

    def result(self) -> dict:
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes),
                "transcendentals": float(self.transcendentals),
                "stages": self.stages, "kernels": self.kernels}


class _Paused:
    def __init__(self, an: _Analysis):
        self.an = an

    def __enter__(self):
        self.an.paused += 1

    def __exit__(self, *exc):
        self.an.paused -= 1


#: operation -> whether it is counted by its decomposition
_COMPOSITES: dict = {}


def _composite(func) -> bool:
    """Whether ``func`` has no FLOP formula of its own and a composite
    (decomposing) kernel; decided once an operation."""
    c = _COMPOSITES.get(func)
    if c is None:
        from torch.utils.flop_counter import flop_registry
        c = _COMPOSITES[func] = (
            func.overloadpacket not in flop_registry
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd))
    return c


class _Counter(TorchDispatchMode):
    """Counts each operation.  A call on ``meta`` tensors that returns
    new tensors runs once for each key (``_meta_key``): a repeat
    rebuilds its results from their shapes, so a step's thousands of
    identical recurrence steps skip PyTorch's shape functions."""

    def __init__(self, an: _Analysis, partition=None):
        super().__init__()
        self.an = an
        self.part = partition
        self.memo: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        key = _meta_key(func, args, kwargs)
        spec = None if key is None else self.memo.get(key)
        if spec is not None:
            out = _rebuild(spec)
        else:
            out = func(*args, **kwargs)
            spec = None if key is None else _spec(out)
            if spec is not None:
                self.memo[key] = spec
        if not self.an.paused:
            self.an.count(func, args, kwargs, out)
        if self.part is not None:
            self.part.propagate(func, args, kwargs, out)
        return out


def analyze(fn, *args, tracer=None, partition=None, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its cost; returns::

        {"flops": float, "bytes_accessed": float, "transcendentals":
         float, "stages": {"obs:window": {"ops": int, "bytes": int},
         ...}, "kernels": {"fused_tick": {"calls": int, "bytes": int,
         "ops": int}, ...}}

    ``tracer``: the recording ``obs.trace.Tracer`` whose spans ``fn``
    opens; each operation lands on the innermost ``obs:*`` span open at
    the time (stage keys appear only for stages that ran).  ``kernels``
    holds what each hand-kernel wrapper reported.  ``fn`` really runs:
    hand it copies of any state it writes in place.  ``partition``: a
    ``launch.partition.Partition`` whose seeds ``args`` carry; the
    result then adds its ``"collectives"`` (``hlo.collective_stats``'s
    dict, per device)."""
    if _ACTIVE:
        raise RuntimeError("analyze() does not nest")
    an = _Analysis(tracer)
    _ACTIVE.append(an)
    if partition is not None:
        from repro_torch.launch import partition as part_mod
        part_mod._ACTIVE.append(partition)
    try:
        with _Counter(an, partition):
            out = fn(*args, **kwargs)
        if partition is not None:
            partition.finish(out)
    finally:
        _ACTIVE.pop()
        if partition is not None:
            part_mod._ACTIVE.pop()
    res = an.result()
    if partition is not None:
        res["collectives"] = partition.stats()
    return res


def roofline(flops: float, bytes_accessed: float, seconds: float,
             peak_flops: float | None = None,
             peak_bw: float | None = None) -> dict:
    """Roofline coordinates for one tick: achieved rates, arithmetic
    intensity, and utilization against declared peaks.

    ``peak_flops``/``peak_bw`` default from ``$REPRO_PEAK_FLOPS`` /
    ``$REPRO_PEAK_BW`` (FLOP/s, bytes/s); unset or 0 reports 0.0
    utilization -- "unknown", never a fabricated roof."""
    if peak_flops is None:
        peak_flops = float(os.environ.get("REPRO_PEAK_FLOPS", 0) or 0)
    if peak_bw is None:
        peak_bw = float(os.environ.get("REPRO_PEAK_BW", 0) or 0)
    seconds = max(float(seconds), 1e-12)
    fps = float(flops) / seconds
    bps = float(bytes_accessed) / seconds
    return {
        "gflops": fps / 1e9,
        "gbs": bps / 1e9,
        "ai": float(flops) / max(float(bytes_accessed), 1.0),
        "flops_util": fps / peak_flops if peak_flops > 0 else 0.0,
        "bw_util": bps / peak_bw if peak_bw > 0 else 0.0,
    }


def stage_table(analysis: dict) -> list[tuple[str, int, int]]:
    """``analysis["stages"]`` as rows sorted by descending bytes:
    ``[(stage, ops, bytes), ...]`` -- the printable breakdown."""
    return sorted(((k, v["ops"], v["bytes"])
                   for k, v in analysis.get("stages", {}).items()),
                  key=lambda r: -r[2])
