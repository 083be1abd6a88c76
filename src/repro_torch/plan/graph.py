"""Per-layer dataflow graphs, the planner's input (edge nets only)."""

from __future__ import annotations

import dataclasses
from typing import Iterator


@dataclasses.dataclass(frozen=True)
class LayerNode:
    """One dense layer of the pipeline."""
    index: int
    name: str
    n_in: int
    n_out: int
    act: str = "none"            # activation applied after the GEMM
    repeat: int = 1
    itemsize: int = 1            # int8 deployment

    @property
    def macs(self) -> int:
        return self.n_in * self.n_out

    def out_bytes(self, batch: int) -> int:
        # Activations hand off in f32 before requantization.
        return batch * self.n_out * 4


@dataclasses.dataclass(frozen=True)
class DataflowGraph:
    name: str
    batch: int
    nodes: tuple[LayerNode, ...]
    kind: str = "edge"

    def __iter__(self) -> Iterator[LayerNode]:
        return iter(self.nodes)


def edge_graph(cfg, *, batch: int | None = None) -> DataflowGraph:
    """Graph of an ``EdgeConfig`` dense pipeline (one node per layer)."""
    last = len(cfg.layer_shapes) - 1
    nodes = tuple(
        LayerNode(index=i, name=f"dense{i}", n_in=n_in, n_out=n_out,
                  act=cfg.act if i != last else "none")
        for i, (n_in, n_out) in enumerate(cfg.layer_shapes))
    return DataflowGraph(name=cfg.name, batch=batch or cfg.batch,
                         nodes=nodes)
