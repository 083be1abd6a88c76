"""Logical-axis sharding rules (MaxText-style).

Port of the JAX package's ``sharding.py``.  Model code annotates values with
*logical* axis names (``shard(x, "batch", "seq", "embed")``); a rule set
active in context maps logical names to mesh dims.  With no context active
every annotation is a no-op, and so it is for a plain local tensor: only a
``DTensor`` is laid out anew, to the placements of the fitted spec.

A spec (:class:`P`) is a tuple with one entry per tensor dim: ``None``, a
mesh dim name, or a tuple of names (the dim is split over those mesh dims,
the first most major), the reference's ``PartitionSpec`` entry for entry.
The spec functions read only a mesh's dim names and sizes, so they take a
``DeviceMesh`` or a :class:`MeshShape` alike.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim names and sizes without devices or groups, read the
    way a ``DeviceMesh`` is (``mesh_dim_names``, ``shape``)."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def axis_sizes(mesh) -> dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh`` or a :class:`MeshShape`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"))``."""

    def __new__(cls, *entries):
        # A one-name tuple is that name and an empty one None, as JAX
        # normalises them.
        return super().__new__(cls, (
            (None if not e else e[0] if len(e) == 1 else e)
            if isinstance(e, tuple) else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh dims of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def fit_spec(shape, spec_entries, mesh) -> P:
    """``spec_entries`` for a tensor of ``shape``: each dim keeps the mapped
    mesh dims whose running product divides it, in order, and drops the
    others (kv_heads = 1 cannot shard over a 16-way model dim), so one
    model definition is valid on every mesh.  Missing trailing entries
    are ``None``."""
    sizes = axis_sizes(mesh)
    entries = tuple(spec_entries) + (None,) * (len(shape) - len(spec_entries))
    fixed = []
    for dim, entry in zip(shape, entries):
        kept, prod = [], 1
        for a in entry_axes(entry):
            if dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        fixed.append(tuple(kept) if len(kept) > 1 else
                     (kept[0] if kept else None))
    return P(*fixed)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: what the reference's ``NamedSharding`` holds."""
    mesh: object
    spec: P

    @property
    def placements(self):
        from repro_torch import collectives
        return collectives.placements(self.spec, self.mesh)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: object
    rules: Mapping[str, tuple[str, ...] | str | None]

    def spec(self, *logical: str | None) -> P:
        names = tuple(self.mesh.mesh_dim_names)
        axes = []
        used: set[str] = set()
        for name in logical:
            mapped = None if name is None else self.rules.get(name)
            # A mesh dim may appear at most once in a spec.
            mapped_t = tuple(a for a in entry_axes(mapped)
                             if a not in used and a in names)
            used.update(mapped_t)
            axes.append(None if not mapped_t else
                        (mapped_t[0] if len(mapped_t) == 1 else mapped_t))
        return P(*axes)

    def sharding(self, *logical: str | None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(*logical))


_CTX: contextvars.ContextVar[ShardCtx | None] = contextvars.ContextVar(
    "repro_torch_shard_ctx", default=None)


def current() -> ShardCtx | None:
    return _CTX.get()


@contextlib.contextmanager
def use_rules(mesh, rules: Mapping[str, tuple[str, ...] | str | None]):
    tok = _CTX.set(ShardCtx(mesh, dict(rules)))
    try:
        yield _CTX.get()
    finally:
        _CTX.reset(tok)


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """``x`` laid out by the mapped spec: a ``DTensor`` is redistributed to
    the fitted spec's placements (non-dividing mesh dims dropped, as the
    reference drops them); without a context, and for a plain local
    tensor, ``x`` itself."""
    ctx = current()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch import collectives
    return collectives.redistribute(
        x, fit_spec(x.shape, ctx.spec(*logical), ctx.mesh))


def spec(*logical: str | None) -> P:
    ctx = current()
    if ctx is None:
        return P()
    return ctx.spec(*logical)


# ---------------------------------------------------------------------------
# Canonical rule sets
# ---------------------------------------------------------------------------

def dp_axes(mesh) -> tuple[str, ...]:
    """All data-parallel dims present in the mesh ('pod' folds into DP)."""
    names = tuple(mesh.mesh_dim_names)
    return tuple(a for a in ("pod", "data") if a in names)


def train_rules(mesh, *, fsdp: bool = True, seq_shard: bool = True) -> dict:
    """FSDP over data + TP over model (+ SP on the residual stream)."""
    dp = dp_axes(mesh)
    return {
        "batch": dp,
        "seq": "model" if seq_shard else None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "lru": "model",
        "fsdp": dp if fsdp else None,
        "zero": dp,
    }


def serve_rules(mesh, *, seq_shard: bool = False) -> dict:
    """Pure TP; batch over data; no FSDP (weights replicated over data).
    ``seq_shard`` shards the residual stream's sequence over ``model``."""
    dp = dp_axes(mesh)
    return {
        "batch": dp,
        "seq": "model" if seq_shard else None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "lru": "model",
        "fsdp": None,
        "zero": None,
    }


def edge_rules(mesh) -> dict:
    """Extreme-edge low-latency path: everything replicated."""
    return {k: None for k in ("batch", "seq", "embed", "heads", "kv_heads",
                              "mlp", "vocab", "expert", "lru", "fsdp", "zero")}
