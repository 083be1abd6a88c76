"""The deployment planner for the ``"h100"`` target (the card) and the
paper's ``"aie"`` target (the VEK280's AIE-vs-PL decision): dataflow
graphs in, serializable :class:`DeploymentPlan` / :class:`FleetPlan`
out."""

from repro_torch.plan.artifact import (BoundaryPlan, DeploymentPlan,
                                       FusionGroup, LayerPlan, PlanCache,
                                       default_cache, plan_key)
from repro_torch.plan.graph import (DataflowGraph, LayerNode, edge_graph,
                                    model_graph)
from repro_torch.plan.multinet import FleetPlan, TenantPlan, plan_fleet
from repro_torch.plan.planner import as_graph, get_or_plan, plan_deployment

__all__ = [
    "BoundaryPlan", "DataflowGraph", "DeploymentPlan", "FleetPlan",
    "FusionGroup", "LayerNode", "LayerPlan", "PlanCache", "TenantPlan",
    "as_graph", "default_cache", "edge_graph", "get_or_plan", "model_graph",
    "plan_deployment", "plan_fleet", "plan_key",
]
