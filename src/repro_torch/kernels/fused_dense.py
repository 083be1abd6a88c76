"""Fused dense layer: GEMM + bias + activation (+ residual) in one launch.

Port of the JAX package's ``kernels/fused_dense.py::fused_dense``, the DR7'
boundary eliminator: ``act(x @ w + b)``, then ``+ residual`` when one is
given, accumulated in f32 and cast to ``out_dtype`` (default ``x.dtype``).
The bias is added in f32 before the activation and the residual after it,
as the reference's flush does.  ``act`` is one of :data:`ACTS`; ``gelu`` is
the tanh approximation, ``jax.nn.gelu``'s default.  x, w and the residual
share one dtype, f32 or bf16; the bias is f32; M, K and N may be
ragged.

The CUDA kernel is ``csrc/fused_dense.cu``, with the block shape from
``core/tiling.py``'s :func:`plan_fused_dense`: a ``(block_m, block_n)``
output strip per CTA, its K strip staged in ``block_k`` chunks and split
over the warps.  :func:`fused_dense_plain` is the same function in plain
PyTorch, used for CPU tensors and as the kernel's oracle on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch import hw as hwlib
from repro_torch.core import tiling
from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset (plain int)
flops = 0.0           # their work record (``work``): FLOPs and bytes,
bytes_moved = 0.0     # added where ``launches`` is

_DTYPES = (torch.float32, torch.bfloat16)
# In the order of csrc/fused_dense.cu's Act codes.
_ACTIVATE = {
    "none": lambda y: y,
    "relu": lambda y: torch.clamp_min(y, 0.0),
    "gelu": lambda y: F.gelu(y, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}
ACTS = tuple(_ACTIVATE)


def _check_act(act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"fused_dense: act {act!r} is not one of {ACTS}")


def work(m: int, k: int, n: int, itemsize: int, bias_itemsize: int,
         out_itemsize: int, residual: bool) -> tuple[float, int]:
    """FLOPs and bytes of one (m, k, n) launch: ``2mkn`` (the bias, the
    activation and the residual are not counted); x, w, the bias and the
    residual read once, the output written once."""
    nbytes = (itemsize * (m * k + k * n) + bias_itemsize * n
              + out_itemsize * m * n * (2 if residual else 1))
    return 2.0 * m * k * n, nbytes


def fused_dense_contract(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         residual: torch.Tensor | None = None, *,
                         act: str, block_m: int, block_k: int, block_n: int,
                         out_dtype: torch.dtype | None = None):
    """The kernel's argument checks on shapes, dtypes, ``act`` and the tile
    alone (meta tensors do): returns the output's ``(shape, dtype)`` or
    raises ``ValueError``.  The tile must be one of
    :func:`tiling.fused_dense_tile_ok`'s set and fit one block's shared
    memory at this depth."""
    _check_act(act)
    if not tiling.fused_dense_tile_ok(block_m, block_k, block_n):
        raise ValueError(f"fused_dense: tile {(block_m, block_k, block_n)} "
                         f"is not one the kernel takes (block_m in "
                         f"{tiling.FD_BLOCK_M}, block_k in "
                         f"{tiling.FD_BLOCK_K}, block_n in "
                         f"{tiling.FD_BLOCK_N}, at most "
                         f"{tiling.FD_MAX_OUTPUTS} outputs)")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or x.dim() != 2 \
            or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_dense: want (M, K) @ (K, N), both f32 or "
                         f"both bf16, got {x.dtype} {tuple(x.shape)} @ "
                         f"{w.dtype} {tuple(w.shape)}")
    m, n = x.shape[0], w.shape[1]
    smem = tiling.fused_dense_smem_bytes(block_m, block_k, block_n,
                                         x.shape[1], x.element_size())
    if smem > hwlib.H100_SXM.smem_bytes:
        raise ValueError(f"fused_dense: tile {(block_m, block_k, block_n)} "
                         f"at K = {x.shape[1]} needs {smem} bytes of shared "
                         f"memory, over one block's "
                         f"{hwlib.H100_SXM.smem_bytes}")
    if b.dtype != torch.float32 or tuple(b.shape) != (n,):
        raise ValueError(f"fused_dense: want an f32 bias ({n},), got "
                         f"{b.dtype} {tuple(b.shape)}")
    if residual is not None and (residual.dtype != x.dtype
                                 or tuple(residual.shape) != (m, n)):
        raise ValueError(f"fused_dense: want a {x.dtype} residual "
                         f"({m}, {n}), got {residual.dtype} "
                         f"{tuple(residual.shape)}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"fused_dense: out_dtype must be one of {_DTYPES}")
    return (m, n), out_dtype


def fused_dense_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      residual: torch.Tensor | None = None, *,
                      act: str = "relu",
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the dot of the operands
    widened to f32, the bias, the activation and the residual in f32."""
    _check_act(act)
    y = _ACTIVATE[act](x.float() @ w.float() + b.float())
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype or x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("fused_dense")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.repro_fused_dense.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                      ci, ci, ci, ci, ci, vp]
    lib.repro_fused_dense.restype = ci
    return lib


def fused_dense_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     residual: torch.Tensor | None = None, *,
                     act: str = "relu", block_m: int, block_k: int,
                     block_n: int,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch ``csrc/fused_dense.cu`` on ``x``'s device and stream."""
    global launches, flops, bytes_moved
    shape, out_dtype = fused_dense_contract(
        x, w, b, residual, act=act, block_m=block_m, block_k=block_k,
        block_n=block_n, out_dtype=out_dtype)
    tensors = (x, w, b) + (() if residual is None else (residual,))
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("fused_dense_cuda: every tensor must lie on one "
                         "CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_dense_cuda: every tensor must be contiguous")
    m, k = x.shape
    n = shape[1]
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().repro_fused_dense(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        ACTS.index(act), m, k, n, block_m, block_k, block_n,
        tiling.fused_dense_smem_bytes(block_m, block_k, block_n, k,
                                      x.element_size()), stream)
    if err != 0:
        raise RuntimeError(f"fused_dense: CUDA error {err}")
    launches += 1
    f, nb = work(m, k, n, x.element_size(), b.element_size(),
                 out.element_size(), residual is not None)
    flops, bytes_moved = flops + f, bytes_moved + nb
    return out
