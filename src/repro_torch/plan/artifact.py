"""DeploymentPlan, the serializable planner output, and the plan cache.

The JSON schema is the JAX package's schema 3: ``layers``, ``boundaries``,
``fusion_groups``, ``totals`` and a free-form ``serve`` section, with
``target: "h100"``.  ``plan_key`` hashes everything the planner's answer
depends on (layer shapes, batch, target, every machine-model constant, the
planner version), so a cache hit is the same question asked again.
:class:`PlanCache` keeps plans and fleets in memory and, given a directory,
on disk (``<key>.json``, ``<key>.fleet.json``), written atomically.  The
port's default directory is ``REPRO_TORCH_PLAN_CACHE_DIR``: its artifacts
(target ``h100``) never share a directory with the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import warnings

PLAN_SCHEMA_VERSION = 3
PLANNER_VERSION = "h100-plan-3"     # bump on any search or cost-model change


def atomic_write_text(path: str | os.PathLike, text: str) -> pathlib.Path:
    """Write through a temporary file in the same directory and
    ``os.replace``: a process killed mid-write leaves the old artifact, not
    a truncated one."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(f"{p.name}.tmp.{os.getpid()}")
    try:
        tmp.write_text(text)
        os.replace(tmp, p)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    return p


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


def _derive_fusion_groups(layers) -> tuple[FusionGroup, ...]:
    """Fusion groups from the layers' ``fuse_group`` ids, for a plan
    without a ``fusion_groups`` section (a hand-built plan): consecutive
    layers sharing an id form one group, whose estimate is the members'
    summed estimate."""
    groups: list[FusionGroup] = []
    for l in layers:
        if groups and l.fuse_group == groups[-1].id:
            g = groups[-1]
            groups[-1] = FusionGroup(
                id=g.id, layers=g.layers + (l.index,),
                est_latency_s=g.est_latency_s + l.est_latency_s * l.repeat,
                vmem_bytes=g.vmem_bytes)
        else:
            groups.append(FusionGroup(
                id=l.fuse_group, layers=(l.index,),
                est_latency_s=l.est_latency_s * l.repeat))
    return tuple(groups)


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
        """Executable launch groups as layer-index lists (a plan without a
        ``fusion_groups`` section: its layers' ``fuse_group`` ids)."""
        gs = self.fusion_groups or _derive_fusion_groups(self.layers)
        return [list(g.layers) for g in gs]

    @property
    def itemsize(self) -> int:
        """Bytes of a deployed weight: int8 for an edge net, bf16 for an
        LM (a ``--quant8`` LM's plan too, as in the JAX package: the plan's
        ``quantize_weights`` is not applied)."""
        return 1 if self.kind == "edge" else 2

    def work(self) -> dict:
        """The roofline work of one planned inference (edge: the whole
        pipeline; LM: one decode step, which an LM plan's graph is), as the
        JAX package's ``DeploymentPlan.work`` counts it.

        Per layer, times its ``repeat``: ``2 x batch x n_in x n_out``
        FLOPs, ``n_in x n_out x itemsize`` weight bytes, and activations in
        at ``itemsize`` and out in f32.  ``launches`` is one a fusion group
        (times the group's repeat), what the boundary cost model charges
        ``kernel_overhead_s`` for.  The profiler
        (:mod:`repro_torch.obs.profile`) divides these by measured span
        time."""
        its = self.itemsize
        by_index = {l.index: l for l in self.layers}

        def layer_work(l) -> dict:
            flops = 2.0 * self.batch * l.n_in * l.n_out * l.repeat
            weight_bytes = l.n_in * l.n_out * its * l.repeat
            act_bytes = (self.batch * l.n_in * its
                         + self.batch * l.n_out * 4) * l.repeat
            return {"flops": flops, "weight_bytes": weight_bytes,
                    "act_bytes": act_bytes}

        groups = self.fusion_groups or _derive_fusion_groups(self.layers)
        per_group = []
        totals = {"flops": 0.0, "weight_bytes": 0, "act_bytes": 0}
        launches = 0
        for g in groups:
            members = [by_index[i] for i in g.layers if i in by_index]
            gw = {"flops": 0.0, "weight_bytes": 0, "act_bytes": 0}
            for l in members:
                lw = layer_work(l)
                for k in gw:
                    gw[k] += lw[k]
            g_launches = max((l.repeat for l in members), default=1)
            launches += g_launches
            per_group.append({
                "id": g.id, "layers": list(g.layers),
                "est_latency_s": g.est_latency_s, "launches": g_launches,
                **gw,
            })
            for k in totals:
                totals[k] += gw[k]
        return {
            **totals,
            "bytes": totals["weight_bytes"] + totals["act_bytes"],
            "launches": launches,
            "itemsize": its,
            "per_group": per_group,
        }

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
        return atomic_write_text(path, self.to_json() + "\n")

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
    """Plan and fleet cache keyed on :func:`plan_key`: in memory, and on
    disk under ``directory`` when one is given (``<key>.json`` holds
    ``DeploymentPlan.to_json()``, ``<key>.fleet.json`` a fleet's), so the
    cached files double as the CLI's artifacts.  A corrupt or truncated file
    is a miss (a warning, then a fresh plan), never an error."""

    def __init__(self, directory: str | os.PathLike | None = None):
        self._plans: dict[str, DeploymentPlan] = {}
        self._fleets: dict[str, object] = {}
        self.directory = pathlib.Path(directory) if directory else None
        # Fault hook (repro_torch.faults): an armed injector's
        # "cache_corruption" makes a disk read corrupt, the path a
        # truncated file takes.
        self.injector = None
        self.corrupt_reads = 0

    def _read_artifact(self, path: pathlib.Path, loader, what: str):
        if self.injector is not None:
            spec = self.injector.fire("cache.read", tenant=what)
            if spec is not None and spec.kind == "cache_corruption":
                self.corrupt_reads += 1
                warnings.warn(f"injected corrupt {what} artifact "
                              f"{path.name}; treating as cache miss",
                              RuntimeWarning, stacklevel=3)
                return None
        try:
            return loader(path)
        except (KeyError, ValueError, TypeError, AttributeError,
                OSError) as exc:
            self.corrupt_reads += 1
            warnings.warn(f"corrupt {what} artifact {path} "
                          f"({exc.__class__.__name__}: {exc}); treating as "
                          f"cache miss", RuntimeWarning, stacklevel=3)
            return None

    def _get(self, mem: dict, key: str, suffix: str, loader, what: str):
        if key in mem:
            return mem[key]
        if self.directory is None:
            return None
        p = self.directory / f"{key}{suffix}"
        if not p.exists():
            return None
        hit = self._read_artifact(p, loader, what)
        if hit is not None:
            mem[key] = hit
        return hit

    def get(self, key: str) -> DeploymentPlan | None:
        return self._get(self._plans, key, ".json", DeploymentPlan.load,
                         "plan")

    def put(self, plan: DeploymentPlan) -> DeploymentPlan:
        self._plans[plan.key] = plan
        if self.directory is not None:
            plan.save(self.directory / f"{plan.key}.json")
        return plan

    def get_fleet(self, key: str):
        from repro_torch.plan.multinet import FleetPlan
        return self._get(self._fleets, key, ".fleet.json", FleetPlan.load,
                         "fleet")

    def put_fleet(self, fleet, *, key: str):
        self._fleets[key] = fleet
        if self.directory is not None:
            fleet.save(self.directory / f"{key}.fleet.json")
        return fleet

    def clear(self):
        self._plans.clear()
        self._fleets.clear()

    def __len__(self) -> int:
        return len(self._plans) + len(self._fleets)


_DEFAULT_CACHE: PlanCache | None = None


def default_cache() -> PlanCache:
    """The process-wide cache; ``REPRO_TORCH_PLAN_CACHE_DIR`` set keeps it
    on disk there too."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        _DEFAULT_CACHE = PlanCache(
            os.environ.get("REPRO_TORCH_PLAN_CACHE_DIR"))
    return _DEFAULT_CACHE
