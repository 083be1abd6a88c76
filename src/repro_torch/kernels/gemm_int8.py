"""int8 x int8 -> int32 GEMM with a fused dequantization flush.

Port of the JAX package's ``kernels/gemm_int8.py::gemm_int8``:
``out = (x @ w accumulated in int32) * (x_scale * w_scale[n])`` in
``out_dtype`` (bf16 by default, f32 on the edge path).  The CUDA kernel is
``csrc/gemm_int8.cu``; :func:`gemm_int8_plain` is the same function in plain
PyTorch, used for CPU tensors and as the kernel's oracle on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import tiling
from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset (plain int)
flops = 0.0           # their work record (``work``): FLOPs and bytes,
bytes_moved = 0.0     # added where ``launches`` is

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def gemm_int8_plain(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                    x_scale: float = 1.0, *,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch.  The dot is taken in float64,
    exact for int8 operands, and rounded to f32 as the kernel converts its
    int32 accumulator; the scale is ``x_scale * w_scale`` in f32."""
    acc = (x.double() @ w.double()).float()
    scale = torch.full((), x_scale, dtype=torch.float32, device=x.device) \
        * w_scale.to(torch.float32)
    return (acc * scale).to(out_dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("gemm_int8")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.repro_gemm_int8.argtypes = [vp, vp, vp, ctypes.c_float, vp, ci, ci,
                                    ci, ci, ci, ci, ci, vp]
    lib.repro_gemm_int8.restype = ci
    return lib


def work(m: int, k: int, n: int, out_itemsize: int) -> tuple[float, int]:
    """FLOPs and bytes of one (m, k, n) launch: ``2mkn``; x and w read
    once (int8), the f32 scales once, the output written once."""
    return 2.0 * m * k * n, m * k + k * n + 4 * n + out_itemsize * m * n


def gemm_int8_contract(x: torch.Tensor, w: torch.Tensor,
                       w_scale: torch.Tensor, *, block_m: int, block_k: int,
                       block_n: int, out_dtype: torch.dtype = torch.bfloat16):
    """The kernel's argument checks on shapes, dtypes and the tile alone
    (meta tensors do): returns the output's ``(shape, dtype)`` or raises
    ``ValueError``.  A float activation is refused, never up-cast."""
    if not tiling.tile_ok(block_m, block_k, block_n):
        raise ValueError(f"gemm_int8: tile {(block_m, block_k, block_n)} is "
                         f"not one the kernel takes (block_m in "
                         f"{tiling.BLOCK_M}, block_k in {tiling.BLOCK_K}, "
                         f"block_n in {tiling.BLOCK_N})")
    if x.dtype != torch.int8 or w.dtype != torch.int8 or x.dim() != 2 \
            or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm_int8: want int8 (M, K) @ (K, N), got "
                         f"{x.dtype} {tuple(x.shape)} @ {w.dtype} "
                         f"{tuple(w.shape)}")
    n = w.shape[1]
    if w_scale.dtype != torch.float32 or tuple(w_scale.shape) != (n,):
        raise ValueError("gemm_int8: w_scale must be f32 (N,)")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"gemm_int8: out_dtype must be one of {_OUT_DTYPES}")
    return (x.shape[0], n), out_dtype


def gemm_int8_cuda(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                   x_scale: float = 1.0, *, block_m: int, block_k: int,
                   block_n: int,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Launch ``csrc/gemm_int8.cu`` on ``x``'s device and stream."""
    global launches, flops, bytes_moved
    shape, out_dtype = gemm_int8_contract(
        x, w, w_scale, block_m=block_m, block_k=block_k, block_n=block_n,
        out_dtype=out_dtype)
    if not all(t.is_cuda and t.device == x.device for t in (x, w, w_scale)):
        raise ValueError("gemm_int8_cuda: every tensor must lie on one CUDA "
                         "device")
    if not all(t.is_contiguous() for t in (x, w, w_scale)):
        raise ValueError("gemm_int8_cuda: x, w and w_scale must be "
                         "contiguous")
    m, k = x.shape
    n = shape[1]
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().repro_gemm_int8(
        x.data_ptr(), w.data_ptr(), w_scale.data_ptr(), float(x_scale),
        out.data_ptr(), int(out_dtype == torch.bfloat16), m, k, n,
        block_m, block_k, block_n, stream)
    if err != 0:
        raise RuntimeError(f"gemm_int8: CUDA error {err}")
    launches += 1
    f, nb = work(m, k, n, out.element_size())
    flops, bytes_moved = flops + f, bytes_moved + nb
    return out
