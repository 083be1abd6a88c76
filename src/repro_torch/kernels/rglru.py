"""The RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t`` (Griffin).

Port of the JAX package's ``kernels/rglru.py::linear_scan``: a, b
``(B, T, D)``, the scan along T from ``h = 0`` with an f32 state, the result
in a's dtype.  There is no initial-state argument, as in the reference: a
caller with a state folds it into ``b[:, 0]``.  The CUDA kernels are in
``csrc/linear_scan.cu``: the sequential scan for short T (the decode tick)
and the two-pass chunked scan for longer T, which no longer matches the
sequential walk bit for bit after its second chunk (each chunk's carry is
rounded along another path; see the source).  :func:`linear_scan_plain` is
the same function in plain PyTorch, used for CPU tensors and as the
kernels' oracle on the card.  The gradient is another such scan, run
backwards in time: :func:`linear_scan_bwd_cuda` launches the same kernel
on flipped inputs, :func:`linear_scan_bwd_plain` is its reversed loop.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset (plain int)
flops = 0.0           # their work record (``work``): FLOPs and bytes,
bytes_moved = 0.0     # added where ``launches`` is

_DTYPES = (torch.float32, torch.bfloat16)
# T from which a launch takes the two-pass chunked scan.  Shorter T (the
# decode tick) keeps the sequential kernel: at B = 1, D = 2560 it is as fast
# up to T = 128, where a second chunk costs the chunked scan a second walk
# (chip_smoke.py's threshold sweep; PERF.md).
CHUNKED_MIN_T = 256


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"linear_scan: want a, b of one shape (B, T, D), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")


def work(numel: int, itemsize: int) -> tuple[float, int]:
    """FLOPs and bytes of one launch over ``numel`` elements: a multiply
    and an add each; a and b read once, h written once."""
    return 2.0 * numel, 3 * itemsize * numel


def linear_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A loop over T in f32; each step multiplies, then adds, as the
    kernels do.  The sequential kernel equals it bit for bit; the chunked
    scan equals it to f32 rounding of the carried state."""
    _check(a, b)
    a32, b32 = a.float(), b.float()
    h = torch.zeros_like(a32[:, 0])
    out = torch.empty_like(a32)
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def _next(a: torch.Tensor) -> torch.Tensor:
    """``a_{t+1}`` at step t, 0 at the last step."""
    return torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)


def _grads(a, h, lam) -> tuple[torch.Tensor, torch.Tensor]:
    """(da, db) from the adjoint ``lam``: db = lam, da_t = lam_t h_{t-1}
    with h_{-1} = 0."""
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return (lam.float() * h_prev.float()).to(a.dtype), lam.to(a.dtype)


def linear_scan_bwd_plain(a: torch.Tensor, h: torch.Tensor,
                          g: torch.Tensor) -> tuple:
    """The gradient of ``h = scan(a, b)`` for the upstream ``g``: the
    adjoint runs backwards in time, ``lam_t = a_{t+1} lam_{t+1} + g_t``
    from ``lam_{T-1} = g_{T-1}``, as a reversed loop in f32 (multiply, then
    add); ``db = lam``, ``da_t = lam_t h_{t-1}``.  Returns (da, db) in a's
    dtype."""
    _check(a, h)
    a_next, g32 = _next(a.float()), g.float()
    lam = torch.zeros_like(g32[:, 0])
    out = torch.empty_like(g32)
    for t in range(a.shape[1] - 1, -1, -1):
        lam = a_next[:, t] * lam + g32[:, t]
        out[:, t] = lam
    return _grads(a, h, out)


def linear_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor,
                         g: torch.Tensor) -> tuple:
    """:func:`linear_scan_bwd_plain` on the card: the adjoint is the
    ``linear_scan`` kernel itself (one counted launch) over flipped
    contiguous copies of ``(a_{t+1}, g)``; the products are elementwise
    torch."""
    _check(a, h)
    lam = linear_scan_cuda(torch.flip(_next(a), [1]),
                           torch.flip(g.to(a.dtype), [1]))
    return _grads(a, h, torch.flip(lam, [1]))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("linear_scan")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.repro_linear_scan.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.repro_linear_scan.restype = ci
    lib.repro_linear_scan_chunked.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                              vp]
    lib.repro_linear_scan_chunked.restype = ci
    lib.repro_linear_scan_workspace.argtypes = [ci, ci, ci]
    lib.repro_linear_scan_workspace.restype = ctypes.c_longlong
    return lib


def linear_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/linear_scan.cu`` on a's device and stream: the
    two-pass chunked scan when T >= ``CHUNKED_MIN_T`` (its workspace from
    the caching allocator, no host sync), else the sequential kernel."""
    global launches, flops, bytes_moved
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
    lib = _lib()
    is_bf16 = int(a.dtype == torch.bfloat16)
    if t >= CHUNKED_MIN_T:
        ws = torch.empty(lib.repro_linear_scan_workspace(bsz, t, d),
                         dtype=torch.float32, device=a.device)
        err = lib.repro_linear_scan_chunked(a.data_ptr(), b.data_ptr(),
                                            ws.data_ptr(), out.data_ptr(),
                                            is_bf16, bsz, t, d, stream)
    else:
        err = lib.repro_linear_scan(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), is_bf16, bsz, t, d,
                                    stream)
    if err != 0:
        raise RuntimeError(f"linear_scan: CUDA error {err}")
    launches += 1
    f, nb = work(out.numel(), out.element_size())
    flops, bytes_moved = flops + f, bytes_moved + nb
    return out
