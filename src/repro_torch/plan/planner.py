"""The deployment planner for the ``"h100"`` target.

Every layer runs ``tiled``: one ``gemm_int8`` launch with the block shape
:func:`repro_torch.core.tiling.plan_api` picks, unless the DR7' fusion DP
puts it in a multi-layer group, which runs as one ``fused_mlp_q8`` launch.
The pipelined-spatial regime (layers spread over cores) is not offered on
this target yet, so every layer carries ``lare = -1``.

A fusion group's working set is priced by
:func:`repro_torch.kernels.fused_mlp.fused_smem_bytes`, the same function
that sizes the fused kernel's shared memory, against one block's budget.

An LM graph (:func:`~repro_torch.plan.graph.model_graph`, a decode step) is
priced as the port runs it: each GEMM one bf16 ``torch.matmul`` at the
graph's batch, ``max(weight bytes / hbm_bw, ops / peak_bf16_ops)`` plus the
launch term, each node its own group (a repeat- and regime-uniform
partition, as the reference's ``_plan_tpu`` makes it).  Its tile is the one
``gemm_int8`` would take for the shape, the kernel the plan's
``quantize_weights`` points at.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch import hw as hwlib
from repro_torch.core import boundary, tiling
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_mlp import ROWS, fused_smem_bytes
from repro_torch.plan.artifact import (BoundaryPlan, DeploymentPlan,
                                       FusionGroup, LayerPlan, default_cache,
                                       plan_key)
from repro_torch.plan.graph import DataflowGraph, edge_graph, model_graph

TARGET = "h100"


def as_graph(cfg, *, batch: int | None = None) -> DataflowGraph:
    """Accept an EdgeConfig, a ModelConfig or an already-built graph."""
    if isinstance(cfg, DataflowGraph):
        return cfg
    if hasattr(cfg, "layer_shapes") and hasattr(cfg, "dims"):
        return edge_graph(cfg, batch=batch)
    if hasattr(cfg, "family"):
        return model_graph(cfg, batch=batch or 1)
    raise TypeError(f"cannot build a dataflow graph from {type(cfg)!r}")


def _plan_lm(graph: DataflowGraph, *, hw: hwlib.H100,
             key: str) -> DeploymentPlan:
    """One group per GEMM node of a decode step (see the module doc)."""
    batch = graph.batch
    layers, groups, quantize = [], [], False
    for node in graph:
        compute_s = max(node.weight_bytes() / hw.hbm_bw,
                        2.0 * batch * node.macs / hw.peak_bf16_ops)
        est = hw.kernel_overhead_s + compute_s
        api = tiling.plan_api(batch, node.n_in, node.n_out, hw=hw)
        rules = ["regime=tiled", "bf16 torch.matmul",
                 f"DR7'(fuse_group={node.index})"]
        if node.macs >= 1 << 16:
            quantize = True
        layers.append(LayerPlan(
            index=node.index, name=node.name, n_in=node.n_in,
            n_out=node.n_out, regime="tiled", lare=-1.0, p_k=1, p_n=1,
            band=1, api_tile=api.blocks, fuse_group=node.index,
            est_latency_s=est, est_interval_s=est, act=node.act,
            repeat=node.repeat, rules=tuple(rules)))
        groups.append(FusionGroup(id=node.index, layers=(node.index,),
                                  est_latency_s=est * node.repeat,
                                  vmem_bytes=api.smem_bytes))
    boundaries = [
        BoundaryPlan(after_layer=prev.index, from_regime="tiled",
                     to_regime="tiled",
                     crossing_s=2.0 * prev.out_bytes(batch) / hw.hbm_bw)
        for prev in graph.nodes[:-1]]
    est_latency = sum(g.est_latency_s for g in groups) \
        + sum(b.crossing_s for b in boundaries) + hw.kernel_overhead_s
    return DeploymentPlan(
        network=graph.name, target=TARGET, batch=batch, key=key,
        layers=tuple(layers), boundaries=tuple(boundaries),
        est_latency_s=est_latency, est_interval_s=est_latency,
        serve={"quantize_weights": quantize, "prefill_chunk": None,
               "decode_regime": "tiled"},
        kind=graph.kind, fusion_groups=tuple(groups))


def _plan_h100(graph: DataflowGraph, *, hw: hwlib.H100,
               key: str) -> DeploymentPlan:
    if graph.kind == "lm":
        return _plan_lm(graph, hw=hw, key=key)
    batch = graph.batch
    dims = [graph.nodes[0].n_in] + [n.n_out for n in graph]
    layers: list[LayerPlan] = []
    stages: list[boundary.Stage] = []
    quantize = False
    for node in graph:
        api = tiling.plan_api(batch, node.n_in, node.n_out, hw=hw)
        # The fused kernel computes ceil(batch / ROWS) row tiles where the
        # per-layer kernel computes ceil(batch / block_m) blocks of block_m.
        row_trim = min(1.0, math.ceil(batch / ROWS) * ROWS
                       / (math.ceil(batch / api.block_m) * api.block_m))
        rules = ["regime=tiled", f"DR1'(block={api.blocks})"]
        if api.block_n >= api.block_k:
            rules.append("DR2'(N-favored)")
        if node.macs >= 1 << 16:
            quantize = True
        layers.append(LayerPlan(
            index=node.index, name=node.name, n_in=node.n_in,
            n_out=node.n_out, regime="tiled", lare=-1.0, p_k=1, p_n=1,
            band=1, api_tile=api.blocks, fuse_group=0,
            est_latency_s=api.est_s, est_interval_s=api.est_s,
            act=node.act, repeat=node.repeat, rules=tuple(rules)))
        compute_s = max(api.est_s - hw.kernel_overhead_s, 0.0)
        stages.append(boundary.Stage(
            name=node.name, compute_s=compute_s,
            fused_compute_s=compute_s * row_trim,
            out_bytes=node.out_bytes(batch), smem_bytes=api.smem_bytes))

    def group_bytes(i: int, j: int) -> int:
        # A singleton runs gemm_int8; a longer group runs fused_mlp_q8.
        if i == j:
            return stages[i].smem_bytes
        return fused_smem_bytes(dims[i:j + 2])

    groups = boundary.plan_fusion(stages, hw=hw, group_bytes=group_bytes)
    layers = [dataclasses.replace(l, fuse_group=g,
                                  rules=l.rules + (f"DR7'(fuse_group={g})",))
              for l, g in zip(layers, groups)]

    fusion_groups: list[FusionGroup] = []
    for gid in dict.fromkeys(groups):
        members = [i for i, g in enumerate(groups) if g == gid]
        group_stages = [stages[i] for i in members]
        group_cost = boundary.fused_group_cost(group_stages, hw)
        fusion_groups.append(FusionGroup(
            id=gid, layers=tuple(members), est_latency_s=group_cost,
            vmem_bytes=group_bytes(members[0], members[-1])))
        # Per-layer estimates share the group's launch and epilogue costs,
        # so the layer estimates plus the crossings plus the entry launch sum
        # to the plan's latency.
        base = ([s.compute_s for s in group_stages] if len(members) == 1
                else [s.in_group_compute_s for s in group_stages])
        share = (group_cost - sum(base)) / len(members)
        for i, b in zip(members, base):
            layers[i] = dataclasses.replace(layers[i], est_latency_s=b + share,
                                            est_interval_s=b + share)

    boundaries = [
        BoundaryPlan(after_layer=prev.index, from_regime=prev.regime,
                     to_regime=nxt.regime,
                     crossing_s=2.0 * graph.nodes[prev.index].out_bytes(batch)
                     / hw.hbm_bw)
        for prev, nxt in zip(layers, layers[1:])
        if prev.fuse_group != nxt.fuse_group]
    est_latency = sum(g.est_latency_s for g in fusion_groups) \
        + sum(b.crossing_s for b in boundaries) + hw.kernel_overhead_s
    return DeploymentPlan(
        network=graph.name, target=TARGET, batch=batch, key=key,
        layers=tuple(layers), boundaries=tuple(boundaries),
        est_latency_s=est_latency, est_interval_s=est_latency,
        serve={"quantize_weights": quantize, "prefill_chunk": None,
               "decode_regime": "tiled"},
        kind=graph.kind, fusion_groups=tuple(fusion_groups))


def _key_for(graph: DataflowGraph, target: str, hw: hwlib.H100) -> str:
    if target != TARGET:
        raise ValueError(f"unknown target {target!r} (want {TARGET!r})")
    # An LM plan also reads the bf16 rate, which edge plans leave out.
    extra = {"peak_bf16_ops": hw.peak_bf16_ops} if graph.kind == "lm" \
        else None
    return plan_key(graph, target, (hw,), extra)


def plan_deployment(cfg, *, target: str = TARGET, batch: int | None = None,
                    hw: hwlib.H100 = hwlib.H100_SXM,
                    device=None) -> DeploymentPlan:
    """Plan one deployment of an EdgeConfig, a ModelConfig (its decode
    step) or a graph for the card.

    ``device`` is where the plan will run: ``None`` means the GPU and raises
    when there is none (the plan itself does not depend on it)."""
    resolve_device(device)
    graph = as_graph(cfg, batch=batch)
    return _plan_h100(graph, hw=hw, key=_key_for(graph, target, hw))


def get_or_plan(cfg, *, target: str = TARGET, batch: int | None = None,
                hw: hwlib.H100 = hwlib.H100_SXM, cache=None,
                device=None) -> DeploymentPlan:
    """Cache-aware :func:`plan_deployment`."""
    resolve_device(device)
    cache = cache if cache is not None else default_cache()
    graph = as_graph(cfg, batch=batch)
    key = _key_for(graph, target, hw)
    hit = cache.get(key)
    if hit is not None:
        return hit
    return cache.put(_plan_h100(graph, hw=hw, key=key))
