"""Collective accounting and the roofline's terms: the port's counterpart
of ``repro.launch.hlo_analysis``.

The reference sums the collectives of XLA's optimized HLO text
(``parse_collectives``).  The port has no compiled graph to read, so that
parser has no counterpart here; instead ``record_collectives`` is a
context manager that counts every collective the port's own code issues
(``parallel.overlap``, ``parallel.pipeline``, ``parallel.collectives``):
kind, bytes, count, under the reference's kind names.  Bytes are each
call's tensor bytes on the issuing rank: for a P2P hop the block sent,
for an all-gather the gathered output (as the reference's parser counts
output shapes).  A collective that moves a parameter (the FSDP gather
of a sharded lookup plan or train weight, and its reduce-scatter in the
backward) is counted again under ``param_count`` and ``param_bytes``.
The collectives that a backward issues (``parallel.collectives``'
autograd forms) are counted with the rest and again under
``backward_count_by_kind`` and ``backward_bytes_by_kind``.

``Roofline`` keeps the reference's fields and properties.  Its hardware
model is an argument; the default is the NVIDIA H100 SXM data sheet for
"NVIDIA H100 80GB HBM3, 700 W" (dense rates, not measurements):
    peak bf16   989 TFLOP/s
    HBM         3.35 TB/s
    NVLink      450 GB/s each way (900 GB/s bidirectional)
``V5E`` holds the reference's TPU v5e constants.

``trace_step(fn, *args, donated=...)`` runs one step under
``record_collectives`` and a ``TorchDispatchMode`` that reads what the
reference reads from XLA's compiled step (``memory_analysis()``,
``cost_analysis()``): on ``meta`` tensors it is the dry run's abstract
evaluation of the step (no value is computed), on real tensors a count of
the run itself.  Its cost follows XLA's ``HloCostAnalysis`` conventions:

- ``flops``: ``2 M N K`` for each product (``torch.utils.flop_counter``'s
  formulas: mm, bmm, addmm, baddbmm, convolutions, attention), plus one
  for each output element of an op torch tags pointwise that is not a
  transcendental (arithmetic, comparisons, selects), plus each kernel's
  noted operations;
- ``bytes accessed``: for each op that is not a view (nor an ``empty``,
  an ``_unsafe_view`` or a copy between devices: a constant made on the
  host, which XLA folds into its program),
  its tensor operands' bytes plus its outputs' bytes, plus each kernel's
  noted bytes.  An eager step launches every op on its own, so this is
  the traffic it moves, not a fusion's;
- ``transcendentals``: the output elements of exp, exp2, expm1, log,
  log2, log10, log1p, tanh, sigmoid, erf, erfc, rsqrt, sqrt, pow, sin and
  cos (and their in-place forms).

A hand-written kernel's wrapper notes its own cost (``note_kernel``), the
same on every device: the CUDA kernel, its plain twin on the CPU, and the
shape-only path on ``meta``; the ops that run inside the note (the twin's)
are not counted again.  Nor are those a collective's backend runs
(``collective_call``): a collective's bytes are under the collectives.
The memory side keeps every storage that an op of the step makes and is
not an argument's: its live bytes, their peak, and which of them the
outputs hold at the end (``StepTrace``).

``roofline_from_trace`` is the counterpart of the reference's
``roofline_from_compiled``.  The reference's ``parse_collectives`` has no
counterpart: the port has no HLO text, and its collectives are counted
where they are issued.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]
    param_count: int = 0       # of the above, collectives moving params
    param_bytes: int = 0
    # of the above, those a backward issued
    backward_count_by_kind: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in _COLLECTIVES})
    backward_bytes_by_kind: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in _COLLECTIVES})

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


# the open recorders: process-wide, not a context variable, so that a
# backward that autograd runs on its device thread is counted too
_RECORDERS = []


@contextlib.contextmanager
def record_collectives():
    """Yields a ``CollectiveStats`` that counts every collective the
    port's code issues inside the block (nested blocks all count), its
    backward's included."""
    stats = CollectiveStats({k: 0 for k in _COLLECTIVES},
                            {k: 0 for k in _COLLECTIVES})
    _RECORDERS.append(stats)
    try:
        yield stats
    finally:
        del _RECORDERS[next(i for i, r in enumerate(_RECORDERS)
                            if r is stats)]


def note_collective(kind: str, tensor: torch.Tensor,
                    param: bool = False, backward: bool = False) -> None:
    """Count one collective of ``kind`` moving ``tensor``'s bytes
    (``param``: the tensor is a parameter's or its gradient's;
    ``backward``: a backward issued it)."""
    if kind not in _COLLECTIVES:
        raise ValueError(f"collective kind {kind!r} not in {_COLLECTIVES}")
    nbytes = tensor.numel() * tensor.element_size()
    for stats in _RECORDERS:
        stats.bytes_by_kind[kind] += nbytes
        stats.count_by_kind[kind] += 1
        if param:
            stats.param_count += 1
            stats.param_bytes += nbytes
        if backward:
            stats.backward_count_by_kind[kind] += 1
            stats.backward_bytes_by_kind[kind] += nbytes


# ---------------------------------------------------------------------------
# one step's cost and memory (the counterpart of XLA's compiled analyses)
# ---------------------------------------------------------------------------

_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "erf", "erfc", "rsqrt", "sqrt", "pow", "sin", "cos"))
# the open traces, process-wide as ``_RECORDERS`` (a backward on autograd's
# device thread is traced too), and how deep the blocks whose ops are not
# counted (kernel notes, collective calls) are open now
_TRACES = []
_UNCOUNTED = [0]
# products: flop_counter's formulas, and the int8 GEMM as an ``mm``
_PRODUCTS = {**flop_registry,
             torch.ops.aten._int_mm: flop_registry[torch.ops.aten.mm]}


@dataclasses.dataclass
class StepTrace:
    """What ``trace_step`` read of one step (on this rank)."""
    collectives: CollectiveStats
    flops: float = 0.0
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0     # most bytes of the step's own storages alive
    temp_bytes: int = 0     # the same, less the storages the outputs hold
    outputs: Any = None
    seconds: float = 0.0
    donated_storages: frozenset = frozenset()   # their ``_cdata``

    def aliased(self, t: torch.Tensor) -> bool:
        """Whether ``t`` (an output) lies in a donated argument's storage."""
        return _storage(t) in self.donated_storages

    def cost(self) -> dict:
        """The reference's ``cost_analysis`` keys."""
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed,
                "transcendentals": self.transcendentals}


def leaves(tree, path=()):
    """``(path, tensor)`` of a tree of dicts, lists, tuples and
    ``ParamTree``s (any object with ``tree()``), depth first."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    elif hasattr(tree, "tree"):
        yield from leaves(tree.tree(), path)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def note_kernel(name: str, flops: float, nbytes: float):
    """A hand-written kernel's call: its operations and the bytes it must
    move are added to every open trace, and the ops run inside the block
    (a plain twin's) are not counted again.  Storages made inside are
    tracked as any other."""
    for tr in _TRACES:
        tr.flops += flops
        tr.bytes_accessed += nbytes
        tr.kernels[name] = tr.kernels.get(name, 0) + 1
    with _uncounted():
        yield


@contextlib.contextmanager
def _uncounted():
    _UNCOUNTED[0] += 1
    try:
        yield
    finally:
        _UNCOUNTED[0] -= 1


def collective_call():
    """The block of one ``torch.distributed`` collective: the ops its
    backend runs (gloo's copies; a fake group's placeholders) are not the
    step's cost, since the collective is counted by ``note_collective``.
    Storages made inside are tracked as any other."""
    return _uncounted()


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _flat(x, out=None) -> list:
    """The tensors of an op's operands or outputs (lists, tuples, dicts),
    in order."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _flat(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _flat(v, out)
    return out


def _meta_key(x):
    """A hashable key of an op's operand: a ``meta`` tensor's metadata, a
    scalar's type and value, a sequence's keys; None where there is none
    (another device, another type)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            return None
        return (tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, _SCALARS):
        return (type(x), x)
    if isinstance(x, (list, tuple)):
        keys = tuple(map(_meta_key, x))
        return None if None in keys else keys
    return None


class _MetaOps:
    """The outputs of ``meta`` ops, made anew from their metadata by op and
    operand metadata: many of torch's meta kernels are Python (about a
    millisecond an op), and a step repeats one op on the same shapes
    thousands of times (each attention block, each step of a scan).  The
    first call of a key runs the op; where every output is a fresh
    ``meta`` tensor (no operand, no view of one), later calls make them
    with ``empty_strided``.  Only ``aten`` ops that return tensors and
    neither write nor view an operand are kept."""

    def __init__(self):
        self.records = {}

    def __call__(self, func, args, kwargs):
        schema = func._schema
        key = None
        if (func.namespace == "aten" and schema.returns and all(
                str(r.type) == "Tensor" for r in schema.returns) and not any(
                a.alias_info is not None for a in schema.arguments)):
            key = _meta_key((args, tuple(sorted(kwargs.items()))))
            rec = self.records.get((func, key), False)
            if rec:
                outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                            device="meta")
                        for shape, stride, dtype in rec]
                return outs[0] if len(outs) == 1 else tuple(outs)
        out = func(*args, **kwargs)
        if key is not None:
            self.records[(func, key)] = self._record(
                out, {_storage(t) for t in _flat((args, kwargs))})
        return out

    @staticmethod
    def _record(out, stores):
        """Each output's ``(shape, stride, dtype)``, or None where one is
        off ``meta`` or in an operand's storage."""
        rec = []
        for o in (out if isinstance(out, tuple) else (out,)):
            if o.device.type != "meta" or _storage(o) in stores:
                return None
            rec.append((tuple(o.shape), o.stride(), o.dtype))
        return rec


class _Tracer(TorchDispatchMode):
    """Counts each op's cost into ``trace`` (outside kernel notes and
    collective calls) and keeps the live bytes of the storages the ops
    make, each watched by a finalizer until ``close``."""

    def __init__(self, trace: StepTrace, known: set):
        super().__init__()
        self.trace = trace
        self.meta_ops = _MetaOps()
        self.known = known          # argument storages: not the step's
        self.live = {}              # storage -> (serial, bytes)
        self.events = []            # (serial, +bytes / -bytes) in order
        self.serial = 0
        self.now = 0
        self.finalizers = []

    def close(self):
        """Stop watching the storages (the outputs outlive the step)."""
        for f in self.finalizers:
            f.detach()

    def _free(self, key):
        serial, n = self.live.pop(key)
        self.events.append((serial, -n))
        self.now -= n

    def _track(self, out, inputs):
        for t in out:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known or key in self.live or key in inputs:
                continue
            n = st.nbytes()
            self.serial += 1
            self.live[key] = (self.serial, n)
            self.events.append((self.serial, n))
            self.now += n
            self.trace.peak_bytes = max(self.trace.peak_bytes, self.now)
            self.finalizers.append(weakref.finalize(st, self._free, key))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self.meta_ops(func, args, kwargs)
        flat_in = _flat((args, kwargs))
        flat_out = _flat(out)
        if not func.is_view:
            self._track(flat_out, {_storage(t) for t in flat_in})
        if _UNCOUNTED[0] or func.is_view:
            return out
        name = func._overloadpacket.__name__
        if name.startswith("empty") or name == "_unsafe_view" or (
                name in ("_to_copy", "copy_") and {t.device for t in flat_in}
                != {t.device for t in flat_out}):
            return out
        tr = self.trace
        tr.bytes_accessed += sum(map(_nbytes, flat_in)) + sum(
            map(_nbytes, flat_out))
        formula = _PRODUCTS.get(func._overloadpacket)
        if formula is not None:
            tr.flops += formula(*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags:
            n = sum(t.numel() for t in flat_out)
            if name.rstrip("_") in _TRANSCENDENTAL:
                tr.transcendentals += n
            else:
                tr.flops += n
        return out


def trace_step(fn, *args, donated=()):
    """Run ``fn(*args)`` once, traced: its collectives
    (``record_collectives``), its cost (the module docstring's
    conventions), the peak bytes of the storages its ops make
    (``peak_bytes``), that peak less the storages its outputs hold
    (``temp_bytes``, XLA's temp allocation), and its outputs.  ``donated``:
    the indices of the arguments the reference donates (their storages
    give ``StepTrace.aliased``)."""
    known = {_storage(t) for _, t in leaves(args)}
    trace = StepTrace(CollectiveStats({k: 0 for k in _COLLECTIVES},
                                      {k: 0 for k in _COLLECTIVES}))
    tracer = _Tracer(trace, known)
    t0 = time.perf_counter()
    _TRACES.append(trace)
    try:
        with record_collectives() as trace.collectives, tracer:
            out = fn(*args)
    finally:
        _TRACES.remove(trace)
    trace.seconds = time.perf_counter() - t0
    tracer.close()
    trace.outputs = out
    trace.donated_storages = frozenset(
        _storage(t) for i in donated for _, t in leaves(args[i]))
    held = {tracer.live[_storage(t)][0] for _, t in leaves(out)
            if _storage(t) in tracer.live}
    now = 0
    for serial, n in tracer.events:
        if serial not in held:
            now += n
            trace.temp_bytes = max(trace.temp_bytes, now)
    return trace


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float      # dense bf16 FLOP/s a chip
    hbm_bw: float          # bytes/s a chip
    link_bw: float         # collective bytes/s a chip


H100 = Hardware("NVIDIA H100 80GB HBM3, 700 W (data sheet)",
                peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)
# the reference's hardware model (hlo_analysis.py: TPU v5e per chip)
V5E = Hardware("TPU v5e (the reference's constants)",
               peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


@dataclasses.dataclass
class Roofline:
    flops: float               # total flops (all devices)
    hbm_bytes: float           # total bytes accessed (all devices)
    collective_bytes: float    # total collective bytes (all devices)
    n_chips: int
    model_flops: float = 0.0   # 6*N*D analytic
    hardware: Hardware = H100

    @property
    def t_compute(self) -> float:
        return self.flops / (self.n_chips * self.hardware.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.n_chips * self.hardware.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.n_chips * self.hardware.link_bw)

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "n_chips": self.n_chips,
            "hardware": self.hardware.name,
        }


def roofline_from_trace(trace: StepTrace, n_chips: int,
                        model_flops: float = 0.0,
                        hardware: Hardware = H100) -> Roofline:
    """The counterpart of the reference's ``roofline_from_compiled``: the
    traced step's flops, bytes accessed and collective bytes (one rank's,
    as the compiled SPMD program's are one device's)."""
    return Roofline(flops=trace.flops, hbm_bytes=trace.bytes_accessed,
                    collective_bytes=float(trace.collectives.total_bytes),
                    n_chips=n_chips, model_flops=model_flops,
                    hardware=hardware)
