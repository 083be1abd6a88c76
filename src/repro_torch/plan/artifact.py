"""DeploymentPlan, the serializable planner output, and the plan cache.

The JSON schema is the JAX package's schema 3: ``layers``, ``boundaries``,
``fusion_groups``, ``totals`` and a free-form ``serve`` section, with
``target: "h100"``.  ``plan_key`` hashes everything the planner's answer
depends on (layer shapes, batch, target, every machine-model constant, the
planner version), so a cache hit is the same question asked again.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib

PLAN_SCHEMA_VERSION = 3
PLANNER_VERSION = "h100-plan-1"     # bump on any search or cost-model change


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    index: int
    name: str
    n_in: int
    n_out: int
    regime: str                  # "tiled" on the h100 target
    lare: float                  # -1: no pipelined-spatial regime offered
    p_k: int
    p_n: int
    band: int
    api_tile: tuple[int, int, int]   # gemm_int8 (block_m, block_k, block_n)
    fuse_group: int
    est_latency_s: float
    est_interval_s: float
    act: str = "none"
    repeat: int = 1
    rules: tuple[str, ...] = ()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["api_tile"] = list(self.api_tile)
        d["rules"] = list(self.rules)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LayerPlan":
        d = dict(d)
        d["api_tile"] = tuple(d["api_tile"])
        d["rules"] = tuple(d.get("rules", ()))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FusionGroup:
    """One DR7' launch group: the layers one fused kernel runs."""
    id: int
    layers: tuple[int, ...]
    est_latency_s: float
    vmem_bytes: int = 0          # shared memory the fused kernel holds

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["layers"] = list(self.layers)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FusionGroup":
        d = dict(d)
        d["layers"] = tuple(d["layers"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class BoundaryPlan:
    after_layer: int
    from_regime: str
    to_regime: str
    crossing_s: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BoundaryPlan":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class DeploymentPlan:
    network: str
    target: str
    batch: int
    key: str
    layers: tuple[LayerPlan, ...]
    boundaries: tuple[BoundaryPlan, ...]
    est_latency_s: float
    est_interval_s: float
    serve: dict = dataclasses.field(default_factory=dict)
    kind: str = "edge"
    fusion_groups: tuple[FusionGroup, ...] = ()
    schema: int = PLAN_SCHEMA_VERSION

    @property
    def inferences_per_s(self) -> float:
        return self.batch / self.est_interval_s if self.est_interval_s else 0.0

    def layer(self, index: int) -> LayerPlan:
        return self.layers[index]

    def groups(self) -> list[list[int]]:
        """Executable launch groups as layer-index lists."""
        return [list(g.layers) for g in self.fusion_groups]

    def to_dict(self) -> dict:
        return {
            "schema": self.schema,
            "kind": self.kind,
            "network": self.network,
            "target": self.target,
            "batch": self.batch,
            "key": self.key,
            "layers": [l.to_dict() for l in self.layers],
            "boundaries": [b.to_dict() for b in self.boundaries],
            "fusion_groups": [g.to_dict() for g in self.fusion_groups],
            "totals": {
                "est_latency_s": self.est_latency_s,
                "est_interval_s": self.est_interval_s,
                "inferences_per_s": self.inferences_per_s,
            },
            "serve": dict(self.serve),
        }

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "DeploymentPlan":
        if d.get("schema") != PLAN_SCHEMA_VERSION:
            raise ValueError(f"unsupported plan schema: {d.get('schema')!r}")
        return cls(
            network=d["network"], target=d["target"], batch=d["batch"],
            key=d["key"],
            layers=tuple(LayerPlan.from_dict(l) for l in d["layers"]),
            boundaries=tuple(BoundaryPlan.from_dict(b)
                             for b in d["boundaries"]),
            est_latency_s=d["totals"]["est_latency_s"],
            est_interval_s=d["totals"]["est_interval_s"],
            serve=dict(d.get("serve", {})),
            kind=d.get("kind", "edge"),
            fusion_groups=tuple(FusionGroup.from_dict(g)
                                for g in d["fusion_groups"]),
        )

    @classmethod
    def from_json(cls, s: str) -> "DeploymentPlan":
        return cls.from_dict(json.loads(s))

    def save(self, path: str | os.PathLike) -> pathlib.Path:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_json() + "\n")
        return p

    @classmethod
    def load(cls, path: str | os.PathLike) -> "DeploymentPlan":
        return cls.from_json(pathlib.Path(path).read_text())


def _hw_fingerprint(hw_obj) -> dict:
    """The machine model's fields, less those the planner never reads
    (marked ``plan_key: False``)."""
    out = {"class": type(hw_obj).__name__}
    for f in dataclasses.fields(hw_obj):
        if f.metadata.get("plan_key", True):
            out[f.name] = getattr(hw_obj, f.name)
    return out


def plan_key(graph, target: str, hw_objs: tuple,
             extra: dict | None = None) -> str:
    """sha256 over everything the planner's answer depends on."""
    payload = {
        "planner": PLANNER_VERSION,
        "network": graph.name,
        "kind": graph.kind,
        "batch": graph.batch,
        "target": target,
        "layers": [[n.name, n.n_in, n.n_out, n.act, n.repeat, n.itemsize]
                   for n in graph.nodes],
        "hw": [_hw_fingerprint(h) for h in hw_objs],
        "extra": extra or {},
    }
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()
                          ).hexdigest()


class PlanCache:
    """In-memory plan and fleet cache keyed on :func:`plan_key`."""

    def __init__(self):
        self._plans: dict[str, DeploymentPlan] = {}
        self._fleets: dict[str, object] = {}

    def get(self, key: str) -> DeploymentPlan | None:
        return self._plans.get(key)

    def put(self, plan: DeploymentPlan) -> DeploymentPlan:
        self._plans[plan.key] = plan
        return plan

    def get_fleet(self, key: str):
        return self._fleets.get(key)

    def put_fleet(self, fleet, *, key: str):
        self._fleets[key] = fleet
        return fleet


_DEFAULT_CACHE: PlanCache | None = None


def default_cache() -> PlanCache:
    """The process-wide cache."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        _DEFAULT_CACHE = PlanCache()
    return _DEFAULT_CACHE
