"""Layer 2: kernel contracts.

Port of the JAX package's ``check/kernel_contracts.py``.  Where the JAX
package abstract-evaluates each Pallas entry point with ``jax.eval_shape``,
the port puts each planned launch's arguments, as meta tensors, through the
kernel wrapper's own contract function (``*_contract`` in
``kernels/*.py``), the one its CUDA wrapper calls before launching: no
device work.  Rules:

* ``kernel.contract``: a planned launch's arguments (shape, dtype, tile)
  are refused by the kernel's contract.  Checked for every layer on
  ``gemm_int8`` (its singleton group, or the per-layer rung) with the
  plan's tile, for every layer on ``fused_dense`` (the calibration pass of
  every engine build) with the planner's tile, and for every multi-layer
  group on ``fused_mlp_q8``.
* ``kernel.dtype-contract``: a contract returns another shape or dtype than
  the engine consumes, or ``gemm_int8`` accepts a float activation (the
  int8 path must refuse it, never up-cast it).
* ``kernel.smem-scratch``: a fusion group's shared memory, recomputed with
  ``fused_smem_bytes`` (the function the fused kernel is sized by), over
  one block's budget (error) or over the plan's ``vmem_bytes`` estimate
  (warning: the planner under-charges the group).

:func:`verify_kernel_library` is the self-check of ``python -m repro_torch
check``: it launches each of the nine kernels once on a canonical
case on a device (the card by default) and checks what comes back.
"""

from __future__ import annotations

import torch

from repro_torch import hw as hwlib
from repro_torch.check import Finding
from repro_torch.core import tiling
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as _rw
from repro_torch.kernels.fused_dense import fused_dense_contract
from repro_torch.kernels.fused_mlp import (fused_mlp_q8_contract,
                                           fused_smem_bytes)
from repro_torch.kernels.gemm_int8 import gemm_int8_contract

F32 = torch.float32


def _meta(*shape, dtype=F32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _contract(fs, what, tenant, layer, want, contract, *args, **kw) -> None:
    """Run one contract; append a finding if it refuses the arguments or
    returns another ``(shape, dtype)`` than ``want``."""
    try:
        shape, dtype = contract(*args, **kw)
    except ValueError as e:
        fs.append(Finding(rule="kernel.contract", severity="error",
                          tenant=tenant, layer=layer,
                          detail=f"{what}: {e}"))
        return
    if (tuple(shape), dtype) != want:
        fs.append(Finding(
            rule="kernel.dtype-contract", severity="error", tenant=tenant,
            layer=layer,
            detail=f"{what} returns {tuple(shape)}/{dtype}, the engine "
                   f"consumes {want[0]}/{want[1]}"))


def verify_plan_kernels(plan, *, tenant: str | None = None,
                        hw=None) -> list:
    """The contracts of every launch an h100 edge plan makes, with the
    plan's own tiles and groups, on meta tensors."""
    tenant = tenant if tenant is not None else plan.network
    hw = hw if hw is not None else hwlib.H100_SXM
    if plan.kind != "edge":
        return []
    fs: list = []
    m = plan.batch
    last = len(plan.layers) - 1
    for pos, l in enumerate(plan.layers):
        want = ((m, l.n_out), F32)
        if len(l.api_tile) == 3:          # else plan.tile-legal reports it
            bm, bk, bn = l.api_tile
            _contract(fs, f"gemm_int8 on {l.name!r}", tenant, l.index, want,
                      gemm_int8_contract,
                      _meta(m, l.n_in, dtype=torch.int8),
                      _meta(l.n_in, l.n_out, dtype=torch.int8),
                      _meta(l.n_out), block_m=bm, block_k=bk, block_n=bn,
                      out_dtype=F32)
        # The tile ops.fused_dense launches: planned for the card the
        # kernel is built for, whatever machine model the plan was given.
        api = tiling.plan_fused_dense(m, l.n_in, l.n_out, itemsize=4)
        _contract(fs, f"fused_dense (calibration) on {l.name!r}", tenant,
                  l.index, want, fused_dense_contract, _meta(m, l.n_in),
                  _meta(l.n_in, l.n_out), _meta(l.n_out),
                  act="relu" if pos != last else "none",
                  block_m=api.block_m, block_k=api.block_k,
                  block_n=api.block_n)
    by_index = {l.index: l for l in plan.layers}
    for g in plan.fusion_groups:
        ls = [by_index[i] for i in g.layers if i in by_index]
        if len(ls) < 2 or len(ls) != len(g.layers):
            continue                     # singletons: gemm_int8 above
        widths = [ls[0].n_in] + [l.n_out for l in ls]
        actual = fused_smem_bytes(widths)
        if actual > hw.smem_bytes:
            fs.append(Finding(
                rule="kernel.smem-scratch", severity="error", tenant=tenant,
                layer=g.layers[0],
                detail=f"group {g.id} fused kernel holds {actual} B of "
                       f"shared memory (widths {widths}) - over one block's "
                       f"{hw.smem_bytes} B; the launch is refused"))
        elif actual > g.vmem_bytes:
            fs.append(Finding(
                rule="kernel.smem-scratch", severity="warning",
                tenant=tenant, layer=g.layers[0],
                detail=f"group {g.id} fused kernel holds {actual} B but the "
                       f"plan charged vmem_bytes={g.vmem_bytes} B"))
        _contract(fs, f"fused_mlp_q8 on group {g.id}", tenant, g.layers[0],
                  ((m, widths[-1]), F32), fused_mlp_q8_contract,
                  _meta(m, widths[0]), widths)
    fs += _verify_int8_rejects_float(tenant)
    return fs


def _verify_int8_rejects_float(tenant) -> list:
    """The quantized path's input contract: a float activation is refused,
    not silently up-cast (which would skip the requantization)."""
    try:
        gemm_int8_contract(_meta(8, 128), _meta(128, 128, dtype=torch.int8),
                           _meta(128), block_m=8, block_k=32, block_n=32,
                           out_dtype=F32)
    except ValueError:
        return []
    return [Finding(
        rule="kernel.dtype-contract", severity="error", tenant=tenant,
        detail="gemm_int8 accepted a float32 activation operand - the "
               "int8-in contract is no longer enforced")]


# ---------------------------------------------------------------------------
# The library self-check
# ---------------------------------------------------------------------------

def _rwkv_bwd_case(r, k, v, w, u, do):
    """The backward from the forward's chunk states, taken on the card by
    the plain forward (so that only the backward counts a launch); the
    CPU's plain backward reads none."""
    states = None
    if r.device.type != "cpu":
        _, states = _rw.rwkv6_scan_plain(r, k, v, w, u,
                                         return_chunk_states=True)
    return ops.rwkv6_scan_bwd(r, k, v, w, u, do, states)


def _library_cases(gen: torch.Generator, device: torch.device):
    """(kernel, call, expected shape, expected dtype) per kernel: the JAX
    package's four canonical cases as they are, one each for the edge
    kernels at the paper's batch of 8, and the backwards of flash and of
    rwkv6_scan on their forwards' cases (dq, dr)."""
    def randn(*shape, dtype=F32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device, dtype)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8).to(device)

    def decay(*shape):                   # in (0.45, 0.95)
        return (torch.rand(shape, generator=gen) * 0.5 + 0.45).to(device)

    bf16 = torch.bfloat16
    dims = (16, 64, 32, 32, 5)           # jet_tagger, one fused group
    return (
        ("tiled_gemm", lambda: ops.tiled_gemm(
            randn(64, 256, dtype=bf16), randn(256, 512, dtype=bf16)),
         (64, 512), bf16),
        ("flash_attention", lambda: ops.flash_attention(
            randn(1, 8, 256, 64, dtype=bf16),
            randn(1, 2, 256, 64, dtype=bf16),
            randn(1, 2, 256, 64, dtype=bf16), causal=True),
         (1, 8, 256, 64), bf16),
        ("flash_attention_bwd", lambda: ops.flash_attention_bwd(
            *(randn(1, h, 256, 64, dtype=bf16) for h in (8, 2, 2, 8, 8)),
            randn(1, 8, 256) + 5.0, causal=True)[0],
         (1, 8, 256, 64), bf16),
        ("rwkv6_scan", lambda: ops.rwkv6_scan(
            randn(4, 128, 64, scale=0.5), randn(4, 128, 64, scale=0.5),
            randn(4, 128, 64, scale=0.5), decay(4, 128, 64),
            randn(64, scale=0.3)),
         (4, 128, 64), F32),
        ("rwkv6_scan_bwd", lambda: _rwkv_bwd_case(
            randn(4, 128, 64, scale=0.5), randn(4, 128, 64, scale=0.5),
            randn(4, 128, 64, scale=0.5), decay(4, 128, 64),
            randn(64, scale=0.3), randn(4, 128, 64))[0],
         (4, 128, 64), F32),
        ("linear_scan", lambda: ops.linear_scan(
            decay(2, 256, 128), randn(2, 256, 128)),
         (2, 256, 128), F32),
        ("fused_mlp_q8", lambda: ops.fused_mlp_q8(
            randn(8, dims[0]), [int8(a, b) for a, b in zip(dims, dims[1:])],
            [randn(b).abs() * 0.01 for b in dims[1:]],
            [randn(b) for b in dims[1:]], [0.05] * (len(dims) - 1)),
         (8, dims[-1]), F32),
        ("gemm_int8", lambda: ops.gemm_int8(
            int8(8, 128), int8(128, 128), randn(128).abs() * 0.01, 0.05,
            out_dtype=F32),
         (8, 128), F32),
        ("fused_dense", lambda: ops.fused_dense(
            randn(8, 192), randn(192, 256, scale=192 ** -0.5), randn(256),
            act="relu"),
         (8, 256), F32),
    )


def verify_kernel_library(device=None) -> list:
    """Launch each ported kernel once on its canonical case on ``device``
    (``None``: the card, raising when there is none; ``"cpu"`` runs the
    plain versions) and check the shape and dtype that come back, and on a
    card that the kernel itself ran (its launch counter moved)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    fs = []
    for name, call, shape, dtype in _library_cases(gen, device):
        before = ops.launch_counts()[name]
        try:
            out = call()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except (ValueError, RuntimeError) as e:
            fs.append(Finding(
                rule="kernel.library", severity="error", tenant="library",
                detail=f"{name} fails on its canonical case on {device}: "
                       f"{e.__class__.__name__}: "
                       f"{str(e).splitlines()[0][:160]}"))
            continue
        ran = ops.launch_counts()[name] - before
        if (tuple(out.shape), out.dtype) != (shape, dtype):
            fs.append(Finding(
                rule="kernel.library", severity="error", tenant="library",
                detail=f"{name} returns {tuple(out.shape)}/{out.dtype} on "
                       f"its canonical case, the contract says "
                       f"{shape}/{dtype}"))
        elif device.type == "cuda" and ran != 1:
            fs.append(Finding(
                rule="kernel.library", severity="error", tenant="library",
                detail=f"{name} launched its kernel {ran} times on its "
                       f"canonical case, want 1"))
    return fs
