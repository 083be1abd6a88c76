"""The RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t`` (Griffin).

Port of the JAX package's ``kernels/rglru.py::linear_scan``: a, b
``(B, T, D)``, the scan along T from ``h = 0`` with an f32 state, the result
in a's dtype.  There is no initial-state argument, as in the reference: a
caller with a state folds it into ``b[:, 0]``.  The CUDA kernel is
``csrc/linear_scan.cu``; :func:`linear_scan_plain` is the same function in
plain PyTorch, used for CPU tensors and as the kernel's oracle on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset (plain int)

_DTYPES = (torch.float32, torch.bfloat16)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"linear_scan: want a, b of one shape (B, T, D), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")


def linear_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A loop over T in f32; each step multiplies, then adds, as the kernel
    does."""
    _check(a, b)
    a32, b32 = a.float(), b.float()
    h = torch.zeros_like(a32[:, 0])
    out = torch.empty_like(a32)
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out.to(a.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("linear_scan")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.repro_linear_scan.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.repro_linear_scan.restype = ci
    return lib


def linear_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/linear_scan.cu`` on a's device and stream."""
    global launches
    _check(a, b)
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("linear_scan_cuda: a and b must lie on one CUDA "
                         "device")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"linear_scan_cuda: want a, b both f32 or both "
                         f"bf16, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("linear_scan_cuda: a and b must be contiguous")
    bsz, t, d = a.shape
    if bsz > 65535:
        raise ValueError(f"linear_scan_cuda: batch {bsz} exceeds the grid "
                         f"limit 65535")
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().repro_linear_scan(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   int(a.dtype == torch.bfloat16), bsz, t, d,
                                   stream)
    if err != 0:
        raise RuntimeError(f"linear_scan: CUDA error {err}")
    launches += 1
    return out
