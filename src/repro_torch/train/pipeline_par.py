"""GPipe-style pipeline parallelism over a mesh dim (``shard_map`` +
``ppermute``).

Port of the JAX package's ``train/pipeline_par.py``: the stacked layer
params (L, ...) are split over the stage dim (L = n_stages *
layers_per_stage); microbatches flow through the stages with ``ppermute``
hand-offs on a ring, the classic schedule of ``n_micro + n_stages - 1``
ticks (bubble fraction (S-1)/(M+S-1)).  Every stage runs its layers on
every tick, as the reference's SPMD program does.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import collectives as coll
from repro_torch.models import tree
from repro_torch.sharding import P, axis_sizes


def pipeline_apply(layer_fn: Callable, stacked_params, x: torch.Tensor, *,
                   mesh, axis: str = "pod",
                   microbatches: int | None = None) -> torch.Tensor:
    """``x`` through L stacked layers pipelined over ``axis``; returns the
    global output (the same on every rank).

    layer_fn(params_slice, x_micro) -> x_micro; stacked_params leaves:
    (L, ...) with L % n_stages == 0, each stage holding its L / n_stages;
    x: (B, ...) with B % microbatches == 0, the same on every rank."""
    n_stages = axis_sizes(mesh)[axis]
    n_micro = microbatches or n_stages
    b = x.shape[0]
    assert b % n_micro == 0, (b, n_micro)
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def staged(params_local, x_all):
        stage = coll.axis_index(axis)
        micro = x_all.reshape((n_micro, b // n_micro) + tuple(x_all.shape[1:]))
        n_local = tree.leaves(params_local)[0].shape[0]
        layers = tree.unstack(params_local, n_local)

        def run_stage(h):
            for pl in layers:
                h = layer_fn(pl, h)
            return h

        buf = torch.zeros_like(micro[0])
        done: list = [torch.zeros_like(micro[0])] * n_micro
        for t in range(n_micro + n_stages - 1):
            # Stage 0 takes in microbatch t while any remain.
            injected = micro[t] if stage == 0 and t < n_micro else buf
            passed = coll.ppermute(run_stage(injected), axis, ring)
            # Microbatch m comes back round to stage 0 at tick
            # m + n_stages - 1.
            m_done = t - (n_stages - 1)
            if stage == 0 and m_done >= 0:
                done[m_done] = passed
            buf = passed
        outs = torch.stack(done)
        # Only stage 0's outputs are meaningful; broadcast them.
        outs = coll.psum(outs if stage == 0 else torch.zeros_like(outs),
                         axis)
        return outs.reshape(x_all.shape)

    out = coll.shard_map(staged, mesh, (P(axis), P()), P())(
        stacked_params, x)
    return out.to_local()
