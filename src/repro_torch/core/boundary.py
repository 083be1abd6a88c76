"""Boundary-crossing cost models and the planners over them (paper DR7).

On the card the two sides of a layer boundary are *inside one fused kernel*
(the int8 activation stays in shared memory) and *separate launches through
device memory*.  An un-fused boundary costs the activation's round trip
through HBM plus one more launch (:func:`crossing_cost`); a fused one costs
the epilogue requantize.  :func:`plan_fusion` groups a chain of stages to
minimise the total, subject to the shared memory one block may hold.

The paper's own crossing, between the VEK280's programmable logic and its
AI-Engine array, is the JAX package's copy: :func:`crossing_cost_aie` (the
PLIO transfer and sync of Fig. 7) and :func:`plan_hybrid_split`, the DR7
domain DP over stages that carry a time per domain (``Stage.domain_s``).
The ``"aie"`` target of the planner reads them; no plan of the card does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch import hw as hwlib


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    compute_s: float            # pure compute; each group charges its launch
    out_bytes: int              # activation bytes handed to the next stage
    smem_bytes: int = 0         # working set if fused (default group pricing)
    # Compute inside the fused kernel, which computes only its live row tile
    # where the per-layer kernel computes its whole block; None means "same".
    fused_compute_s: float | None = None
    # For plan_hybrid_split: time in each domain (e.g. {'aie':..., 'pl':...}).
    domain_s: dict | None = None

    @property
    def in_group_compute_s(self) -> float:
        return (self.fused_compute_s if self.fused_compute_s is not None
                else self.compute_s)


def crossing_cost(act_bytes: int, hw: hwlib.H100 = hwlib.H100_SXM) -> float:
    """DR7' per-boundary cost: HBM round trip + one launch."""
    return 2.0 * act_bytes / hw.hbm_bw + hw.kernel_overhead_s


def crossing_cost_aie(act_bytes: int, base_latency_s: float,
                      aie: hwlib.AieMl = hwlib.AIE_ML) -> float:
    """Paper-faithful PL<->AIE crossing: PLIO transfer + sync, calibrated so a
    16-layer batch-8 model sees ~3.9% of baseline per crossing (Fig. 7)."""
    transfer = act_bytes / aie.plio_bw
    sync = 0.039 * base_latency_s - transfer
    return transfer + max(sync, 0.0)


def fused_group_cost(stages: Sequence[Stage],
                     hw: hwlib.H100 = hwlib.H100_SXM) -> float:
    """One launch, the members' compute, and a fused-epilogue requantize at
    every boundary kept inside the kernel.  A singleton is a plain per-layer
    launch."""
    if len(stages) == 1:
        return hw.kernel_overhead_s + stages[0].compute_s
    return (hw.kernel_overhead_s
            + sum(s.in_group_compute_s for s in stages)
            + hw.fused_epilogue_s * (len(stages) - 1))


def chain_latency(stages: Sequence[Stage], groups: Sequence[int],
                  hw: hwlib.H100 = hwlib.H100_SXM) -> float:
    """Total time of a stage chain under a grouping (``groups[i]`` is stage
    i's non-decreasing group id): each group's cost plus the HBM round trip
    of every activation handed between groups."""
    total = 0.0
    i, n = 0, len(stages)
    while i < n:
        j = i
        while j + 1 < n and groups[j + 1] == groups[i]:
            j += 1
        total += fused_group_cost(stages[i:j + 1], hw)
        if j + 1 < n:
            total += 2.0 * stages[j].out_bytes / hw.hbm_bw
        i = j + 1
    return total


def plan_fusion(stages: Sequence[Stage], *,
                hw: hwlib.H100 = hwlib.H100_SXM,
                smem_budget: int | None = None,
                group_bytes: Callable[[int, int], int] | None = None
                ) -> list[int]:
    """Optimal fusion grouping of a chain (DP over split points).

    A group ``stages[i..j]`` is feasible iff ``group_bytes(i, j)`` fits the
    budget (one block's shared memory by default).  ``group_bytes`` prices a
    group as the fused kernel really holds it; without it, the members'
    ``smem_bytes`` are summed.  Returns a group id per stage."""
    n = len(stages)
    budget = smem_budget if smem_budget is not None else hw.smem_bytes
    if group_bytes is None:
        def group_bytes(i: int, j: int) -> int:
            return sum(s.smem_bytes for s in stages[i:j + 1])
    inf = float("inf")
    best = [inf] * (n + 1)          # best[j] = min cost of stages[0:j]
    choice = [0] * (n + 1)
    best[0] = 0.0
    for j in range(1, n + 1):
        for i in range(j):
            if group_bytes(i, j - 1) > budget:
                continue
            c = best[i] + fused_group_cost(stages[i:j], hw)
            if i > 0:
                c += 2.0 * stages[i - 1].out_bytes / hw.hbm_bw
            if c < best[j]:
                best[j], choice[j] = c, i
    if n and best[n] == inf:
        raise ValueError("no stage fits the shared-memory budget")
    bounds = []
    j = n
    while j > 0:
        bounds.append((choice[j], j))
        j = choice[j]
    groups = [0] * n
    for gid, (i, j) in enumerate(reversed(bounds)):
        for t in range(i, j):
            groups[t] = gid
    return groups


def plan_hybrid_split(stages: Sequence[Stage], domains: Sequence[str], *,
                      crossing_s: float) -> tuple[list[str], float]:
    """Paper DR7 decision: assign each stage to a domain; each adjacent pair in
    different domains pays ``crossing_s``.  DP over (stage, domain)."""
    n = len(stages)
    inf = float("inf")
    cost = {d: [inf] * n for d in domains}
    prev: dict[str, list[str | None]] = {d: [None] * n for d in domains}
    for d in domains:
        cost[d][0] = (stages[0].domain_s or {}).get(d, stages[0].compute_s)
    for i in range(1, n):
        for d in domains:
            t = (stages[i].domain_s or {}).get(d, stages[i].compute_s)
            for p in domains:
                c = cost[p][i - 1] + t + (crossing_s if p != d else 0.0)
                if c < cost[d][i]:
                    cost[d][i], prev[d][i] = c, p
    end = min(domains, key=lambda d: cost[d][n - 1])
    assign = [end]
    for i in range(n - 1, 0, -1):
        assign.append(prev[assign[-1]][i])
    assign.reverse()
    return assign, cost[end][n - 1]
