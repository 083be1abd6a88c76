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
  (``StepGraph.work``);
* the aten ops of one eager run of the same step, counted by
  ``FlopCounterMode`` (FLOPs) and by :class:`_AtenBytes` (each op's tensor
  operands read once and results written once, views excluded).  On the CPU
  the kernels' plain versions are aten ops, which are counted here and
  nowhere else: a wrapper records nothing on a CPU tensor.

The HLO text parser of ``hlo_analysis.py`` and ``launch/roofline.py`` read
the dry run's compiled programs; they are not ported.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops

# Ops that allocate or rename storage and move no data.
_NO_DATA = frozenset({"empty", "empty_strided", "empty_like", "detach",
                      "alias", "lift_fresh", "_local_scalar_dense"})


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
            self.bytes += sum(
                t.nbytes for t in _pytree.tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out


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
