"""Two-level tiled GEMM: paper Algorithm 2's API-level tile on the card.

Port of the JAX package's ``kernels/tiled_gemm.py::tiled_gemm``: ``x @ w``
over an (M/bm, N/bn, K/bk) grid of blocks with K innermost.  int8 operands
accumulate in int32 and give int32, exactly; f32 and bf16 operands
accumulate in f32 and keep their dtype in the output.  The CUDA kernel is
``csrc/tiled_gemm.cu`` (tensor cores for int8 and bf16, CUDA cores for f32),
with the block shape from ``core/tiling.py``'s :func:`plan_tiled`;
:func:`tiled_gemm_plain` is the same function in plain PyTorch, used for CPU
tensors and as the kernel's oracle on the card.
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

_DTYPE_CODE = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def out_dtype(dtype: torch.dtype) -> torch.dtype:
    """int8 operands give int32; f32 and bf16 keep their dtype."""
    return torch.int32 if dtype == torch.int8 else dtype


def work(m: int, k: int, n: int, itemsize: int,
         out_itemsize: int) -> tuple[float, int]:
    """FLOPs and bytes of one (m, k, n) launch: ``2mkn``; x and w read
    once, the output written once."""
    return 2.0 * m * k * n, itemsize * (m * k + k * n) + out_itemsize * m * n


def tiled_gemm_contract(x: torch.Tensor, w: torch.Tensor, *, block_m: int,
                        block_k: int, block_n: int):
    """The kernel's argument checks on shapes, dtypes and the tile alone
    (meta tensors do): returns the output's ``(shape, dtype)`` or raises
    ``ValueError``.  The tile must be one of the set for x's dtype: the
    tensor-core set for int8 and bf16, the CUDA-core set for f32."""
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype or x.dim() != 2 \
            or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"tiled_gemm: want (M, K) @ (K, N) of one dtype in "
                         f"{tuple(_DTYPE_CODE)}, got {x.dtype} "
                         f"{tuple(x.shape)} @ {w.dtype} {tuple(w.shape)}")
    size = x.element_size()
    if not tiling.tiled_tile_ok(block_m, block_k, block_n, size):
        want = (f"block_m in {tiling.TILED_BLOCK_M}, block_k in "
                f"{tiling.TILED_BLOCK_K}, block_n in {tiling.TILED_BLOCK_N}"
                if size == 4 else
                f"block_m in {tiling.TC_BLOCK_M}, block_k "
                f"{tiling.tc_block_k(size)}, block_n in {tiling.TC_BLOCK_N}")
        raise ValueError(f"tiled_gemm: tile {(block_m, block_k, block_n)} is "
                         f"not one the kernel takes for {x.dtype} ({want})")
    return (x.shape[0], w.shape[1]), out_dtype(x.dtype)


def tiled_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch.  int8: the dot in float64,
    exact for int8 operands (|acc| < 2**53), as int32.  f32/bf16: the dot of
    the operands widened to f32, then cast back."""
    if x.dtype == torch.int8:
        return (x.double() @ w.double()).to(torch.int32)
    return (x.float() @ w.float()).to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("tiled_gemm")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.repro_tiled_gemm.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                     vp]
    lib.repro_tiled_gemm.restype = ci
    return lib


def tiled_gemm_cuda(x: torch.Tensor, w: torch.Tensor, *, block_m: int,
                    block_k: int, block_n: int) -> torch.Tensor:
    """Launch ``csrc/tiled_gemm.cu`` on ``x``'s device and stream."""
    global launches, flops, bytes_moved
    shape, dtype = tiled_gemm_contract(x, w, block_m=block_m,
                                       block_k=block_k, block_n=block_n)
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("tiled_gemm_cuda: x and w must lie on one CUDA "
                         "device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("tiled_gemm_cuda: x and w must be contiguous")
    m, k = x.shape
    n = shape[1]
    out = torch.empty(shape, dtype=dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().repro_tiled_gemm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype], m,
        k, n, block_m, block_k, block_n, stream)
    if err != 0:
        raise RuntimeError(f"tiled_gemm: CUDA error {err}")
    launches += 1
    f, nb = work(m, k, n, x.element_size(), out.element_size())
    flops, bytes_moved = flops + f, bytes_moved + nb
    return out
