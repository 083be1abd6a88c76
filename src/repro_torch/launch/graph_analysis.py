"""What a served step runs, against the plan's model FLOPs.

The port's counterpart of the serving half of the JAX package's
``launch/hlo_analysis.py`` (``analyze_engine``, ``hlo_overhead``).  There a
served step is a compiled XLA executable whose HLO text is parsed; here it
is a captured CUDA graph (``kernels/graph.py``), whose kernels are ctypes
launches that neither ``torch.utils.flop_counter.FlopCounterMode`` nor
``torch.profiler`` sees.  So a step's arithmetic is read from two sources:

* the kernels' work records (``ops.work_counts``): each wrapper adds the
  FLOPs and bytes of its launch, from its shapes, where it launches its
  CUDA kernel, and a captured graph keeps what its capture recorded
  (``StepGraph.work``); a call priced on fake tensors adds to the pricing
  route's own record (``ops.priced_counts``) instead;
* the aten ops of one eager run of the same step, counted by
  ``FlopCounterMode`` (FLOPs) and by :class:`_AtenBytes` (each op's tensor
  operands read once and results written once, views excluded).  On the CPU
  the kernels' plain versions are aten ops, which are counted here and
  nowhere else: a wrapper records nothing on a CPU tensor.

The dry run (:mod:`repro_torch.launch.dryrun`) counts one rank of a fake
world with :class:`RankCounter`, the counterpart of the reference's
``analyze_hlo``.  The port has no compiled program whose text could be
parsed, so the counter sits in the dispatcher instead: it sees each aten op
one rank runs on its local tensors, each collective (the functional ones a
``DTensor`` redistribution issues and the c10d calls of
:mod:`repro_torch.collectives`) with its group, and the kernels' work
records, and reports them under the reference's cell keys
(:meth:`RankCounter.cell`).
"""

from __future__ import annotations

import weakref

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.kernels import ops

# Ops that allocate or rename storage and move no data.
_NO_DATA = frozenset({"empty", "empty_strided", "empty_like", "detach",
                      "alias", "lift_fresh", "_local_scalar_dense",
                      "wait_tensor"})

# The reference's five collective kinds (``hlo_analysis._COLLECTIVES``).
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# Collective ops by name: the functional ones (``_c10d_functional``, which a
# DTensor redistribution issues; their result is the op's output) and the
# c10d ones (``torch.distributed``'s calls, which write their first
# argument).  A ``send`` is one rank's part of a ``ppermute``.
_FUNCTIONAL = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "_allgather_base_": "all-gather", "allgather_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
         "send": "collective-permute"}


def collective_bytes(kind: str, result_bytes: int,
                     group: int) -> tuple[int, int]:
    """(operand, wire) bytes of one collective of ``kind`` whose result is
    ``result_bytes`` over a group of ``group`` ranks: the reference's
    formulas (``hlo_analysis.analyze_hlo``), ring wire bytes included."""
    rb, g = result_bytes, max(1, group)
    if kind == "all-gather":
        return rb // g, rb * (g - 1) // g
    if kind == "reduce-scatter":
        return rb * g, rb * (g - 1)
    if kind == "all-reduce":
        return rb, 2 * rb * (g - 1) // g
    if kind == "all-to-all":
        return rb, rb * (g - 1) // g
    if kind == "collective-permute":
        return rb, rb
    raise ValueError(f"collective kind {kind!r} is not one of {COLLECTIVES}")


def _tensor_bytes(tree) -> int:
    return sum(t.nbytes for t in _pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _collective(func, args, out):
    """(kind, result bytes, group size) of a collective op, else None."""
    ns, _, name = func._schema.name.partition("::")
    if ns.startswith("_c10d_functional") and name in _FUNCTIONAL:
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(
            [a for a in args if isinstance(a, str)][-1]).size()
        return _FUNCTIONAL[name], _tensor_bytes(out), group
    if ns == "c10d" and name in _C10D:
        from torch.distributed import ProcessGroup
        i = next(i for i, a in enumerate(func._schema.arguments)
                 if "ProcessGroup" in str(a.type))
        return (_C10D[name], _tensor_bytes(args[0]),
                ProcessGroup.unbox(args[i]).size())
    return None


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class RankCounter(TorchDispatchMode):
    """What one rank of a step runs, counted in the dispatcher.

    For every op on this rank's own tensors (real ones, or fakes of
    ``fake_mode``): its FLOPs (``torch.utils.flop_counter``'s registry),
    its bytes (:class:`_AtenBytes`'s rule: tensor operands read once,
    results written once, views and allocations excluded), each
    collective's operand and wire bytes by kind and group
    (:func:`collective_bytes`), and the live bytes of the storages ops
    made, whose peak (:attr:`peak_bytes`) estimates the step's temporary
    memory with no allocator rounding.  An op with a ``DTensor`` operand
    runs with the fake mode set aside and a :class:`_Child` of this
    counter on the mode stack: the ``DTensor``'s local op (on fakes of
    ``fake_mode``) is counted, its sharding propagation's own tensors
    (real, or fakes of its own mode) are not.  The kernels' work is read
    around the step from the launches' records (:func:`ops.work_counts`)
    and the pricing route's (:func:`ops.priced_counts`, whose calls by
    kernel are :attr:`priced_calls`)."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0
        self.collectives: dict[str, dict] = {}
        self.live = 0
        self.peak_bytes = 0
        self._tracked: set[int] = set()
        self._before = None
        self.kernel_work: dict = {}
        self.priced_calls: dict[str, int] = {}

    def __enter__(self):
        self._before = ops.work_counts(), ops.priced_counts()
        return super().__enter__()

    def __exit__(self, *exc):
        launched = ops.work_since(self._before[0])
        priced = ops.priced_since(self._before[1])
        work = {name: {key: w[key] + priced[name][key] for key in w}
                for name, w in launched.items()}
        self.kernel_work = {name: w for name, w in work.items()
                            if w["flops"] or w["bytes"]}
        self.priced_calls = {name: int(rec["calls"])
                             for name, rec in priced.items() if rec["calls"]}
        return super().__exit__(*exc)

    def _ours(self, leaves) -> bool:
        """This rank's own tensors: fakes of ``fake_mode`` where one is
        given, else real ones (never meta)."""
        if not leaves:
            return False
        for t in leaves:
            if t.device.type == "meta":
                return False
            if (is_fake(t) and t.fake_mode is self.fake_mode) != (
                    self.fake_mode is not None):
                return False
        return True

    def _track(self, out_leaves, in_leaves) -> None:
        ins = {_storage(t) for t in in_leaves}
        for t in out_leaves:
            key = _storage(t)
            if key in ins or key in self._tracked:
                continue
            n = t.untyped_storage().nbytes()
            self._tracked.add(key)
            self.live += n
            self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(t, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._tracked.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self._dispatch(func, args, kwargs or {})

    def _dispatch(self, func, args, kwargs, child: bool = False):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        leaves = [t for t in _pytree.tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)]
        if any(isinstance(t, DTensor) for t in leaves):
            if child:
                return NotImplemented
            # The DTensor runs its local op, which the child counts; its
            # sharding propagation makes real tensors (the fake mode set
            # aside), which are not this rank's work.
            with unset_fake_temporarily(), _Child(self):
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = [t for t in _pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if func.namespace == "prim" or not self._ours(leaves or outs):
            return out      # a fake tensor's metadata query moves nothing
        coll = _collective(func, args, out)
        if coll is not None:
            kind, rb, group = coll
            operand, wire = collective_bytes(kind, rb, group)
            s = self.collectives.setdefault(
                kind, {"count": 0.0, "operand_bytes": 0.0,
                       "wire_bytes": 0.0, "groups": {}})
            s["count"] += 1
            s["operand_bytes"] += operand
            s["wire_bytes"] += wire
            s["groups"][group] = s["groups"].get(group, 0) + 1
        flop = flop_registry.get(func._overloadpacket)
        if flop is not None:
            self.flops += float(flop(*args, **kwargs, out_val=out))
        if not func.is_view and func._opname not in _NO_DATA:
            self.bytes += _tensor_bytes((args, kwargs, out))
            self._track(outs, leaves)
        return out

    def cell(self) -> dict:
        """The reference's cell keys (``dryrun.analyze``) for what was
        counted: ``flops`` and ``hlo_bytes`` take the kernels' work records
        beside the aten ops, ``temp_size_in_bytes`` the live peak."""
        kflops = sum(w["flops"] for w in self.kernel_work.values())
        kbytes = sum(w["bytes"] for w in self.kernel_work.values())
        colls = {k: dict(s) for k, s in self.collectives.items()}
        return {
            "flops": self.flops + kflops,
            "hlo_bytes": float(self.bytes + kbytes),
            "aten_flops": self.flops, "aten_bytes": float(self.bytes),
            "kernel_flops": kflops, "kernel_bytes": float(kbytes),
            "kernels": self.kernel_work,
            "collectives": colls,
            "collective_operand_bytes": sum(
                s["operand_bytes"] for s in colls.values()),
            "collective_wire_bytes": sum(
                s["wire_bytes"] for s in colls.values()),
            "temp_size_in_bytes": int(self.peak_bytes),
        }


class _AtenBytes(TorchDispatchMode):
    """Counts the bytes of every aten op's tensor operands and results, views
    and allocations excluded: an estimate of the traffic eager aten ops move
    (the counterpart of the HLO analysis's ``bytes_est``)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func._opname not in _NO_DATA:
            self.bytes += _tensor_bytes((args, kwargs, out))
        return out


class _Child(TorchDispatchMode):
    """Its parent counter on the mode stack inside a ``DTensor``'s
    dispatch, where the parent's own handler has set it aside."""

    def __init__(self, parent: RankCounter):
        super().__init__()
        self.parent = parent

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.parent._dispatch(func, args, kwargs or {}, child=True)


def analyze_step(step, kernel_work: dict | None = None) -> dict:
    """FLOPs and bytes of one eager run of ``step`` (no arguments): the
    kernels' work records the run adds (or ``kernel_work``, a captured
    graph's record of the same step) plus its aten ops."""
    before = ops.work_counts()
    with FlopCounterMode(display=False) as flop_counter, \
            _AtenBytes() as aten_bytes:
        step()
    if kernel_work is None:
        kernel_work = ops.work_since(before)
    kernels = {name: w for name, w in kernel_work.items()
               if w["flops"] or w["bytes"]}
    kernel_flops = sum(w["flops"] for w in kernels.values())
    kernel_bytes = sum(w["bytes"] for w in kernels.values())
    aten_flops = float(flop_counter.get_total_flops())
    return {"flops": kernel_flops + aten_flops,
            "bytes": kernel_bytes + aten_bytes.bytes,
            "kernel_flops": kernel_flops, "kernel_bytes": kernel_bytes,
            "aten_flops": aten_flops, "aten_bytes": aten_bytes.bytes,
            "kernels": kernels}


def analyze_engine(engine) -> dict:
    """What a serving engine's steps run.

    For each step ``engine.eager_steps()`` gives (the current rung at the
    plan's batch first, then every captured graph ``graph_report()``
    shows; the batcher's decode tick), one eager run is counted
    (:func:`analyze_step`).  A captured step also carries its graph's nodes
    by type, its kernels by function name, its launches and replays, and
    its kernel FLOPs and bytes are the graph's own work record.  Returns
    ``{"steps": {label: ...}, "step": the first label, "flops", "bytes"}``,
    the last two of the first step."""
    report = engine.graph_report()
    if report is not None and "launches" in report:     # the batcher's tick
        report = {"decode_tick": report}
    report = report or {}
    steps = {}
    for label, step in engine.eager_steps().items():
        graph = report.get(label)
        row = analyze_step(step, None if graph is None else graph["work"])
        if graph is not None:
            row.update(types=graph["nodes"]["types"],
                       functions=graph["nodes"]["kernels"],
                       launches=graph["launches"], replays=graph["replays"])
        steps[label] = row
    first = next(iter(steps))
    return {"steps": steps, "step": first, "flops": steps[first]["flops"],
            "bytes": steps[first]["bytes"]}


def graph_overhead(model_flops: float, engine) -> dict:
    """Model FLOPs against what the engine's served step runs.

    ``model_flops`` is the plan's arithmetic per step
    (``DeploymentPlan.work()["flops"]``, times the batcher's slots); the
    step spends more (masking, per-slot state work, layout ops) or less.
    ``useful_fraction`` is model over graph; an edge step that runs exactly
    its planned GEMMs reads 1.  One card has no collectives."""
    step = analyze_engine(engine)
    graph_flops = step["flops"]
    return {"model_flops": model_flops, "graph_flops": graph_flops,
            "graph_bytes": step["bytes"],
            "useful_fraction": (model_flops / graph_flops
                                if graph_flops else None)}
