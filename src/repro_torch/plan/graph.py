"""Per-layer dataflow graphs, the planner's input.

Two front-ends, as in the JAX package's ``plan/graph.py``:
:func:`edge_graph` (an ``EdgeConfig``: one int8 node per dense layer) and
:func:`model_graph` (a ``ModelConfig`` decode step: one bf16 node per
distinct GEMM of a block, with the block's repeat count).
"""

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

    def weight_bytes(self) -> int:
        return self.n_in * self.n_out * self.itemsize

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


def model_graph(cfg, *, batch: int = 1) -> DataflowGraph:
    """Graph of a ``ModelConfig`` decode step: the distinct per-block GEMMs
    (``repeat`` = the layer count) and the unembedding, in bf16.  An MoE
    config's MLP nodes are one expert's (``d_ff_expert``), as the
    reference prices them."""
    d, layers = cfg.d_model, cfg.num_layers
    n_mlp_in = 2 if cfg.mlp_gated else 1
    d_ff = cfg.moe.d_ff_expert if cfg.moe is not None else cfg.d_ff
    nodes = (
        LayerNode(0, "attn.wq", d, cfg.q_dim, repeat=layers, itemsize=2),
        LayerNode(1, "attn.wk", d, cfg.kv_dim, repeat=layers, itemsize=2),
        LayerNode(2, "attn.wv", d, cfg.kv_dim, repeat=layers, itemsize=2),
        LayerNode(3, "attn.wo", cfg.q_dim, d, repeat=layers, itemsize=2),
        LayerNode(4, "mlp.in", d, d_ff * n_mlp_in, repeat=layers,
                  itemsize=2),
        LayerNode(5, "mlp.out", d_ff, d, repeat=layers, itemsize=2),
        LayerNode(6, "unemb", d, cfg.padded_vocab, itemsize=2),
    )
    return DataflowGraph(name=cfg.name, batch=batch, nodes=nodes, kind="lm")
