"""Blocked online-softmax (flash) attention with causal masking, a sliding
window, logit soft-capping and GQA.

Port of the JAX package's ``kernels/flash_attention.py::flash_attention``:
q ``(B, Hq, S, D)``, k/v ``(B, Hkv, Sk, D)`` in f32 or bf16, query head ``h``
reading KV head ``h // (Hq // Hkv)``, the result in q's dtype.  Masked logits
are ``-0.7 * f32max`` with their probabilities zeroed, and a row with zero
mass is 0.  Keys at positions ``>= Sk`` never carry mass, in any mode.
``q_offset`` places query row ``i`` at key position ``q_offset + i`` (a
chunk of a prompt after ``q_offset`` cached keys), as the reference's
``models/layers.py::chunked_attention`` does; the TPU kernel has no offset.
The CUDA kernel is ``csrc/flash_attention.cu``;
:func:`flash_attention_plain` is the same function in plain PyTorch, used
for CPU tensors and as the kernel's oracle on the card.  With
``return_lse=True`` both also return each query row's log-sum-exp ``(B,
Hq, S)`` in f32, natural-log units (``+inf`` for a row with zero mass, so
that ``exp(x - lse)`` gives it no probability): the statistics the
backward (:mod:`flash_attention_bwd`) forms P from.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset (plain int)
flops = 0.0           # their work record (``work``): FLOPs and bytes,
bytes_moved = 0.0     # added where ``launches`` is

NEG = -0.7 * torch.finfo(torch.float32).max
MAX_HEAD_DIM = 256
MAX_POSITION = 2 ** 30   # q_offset + S at most; csrc/flash_attention.cu's
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, *, window, softcap, q_offset) -> None:
    """Shape and option checks shared by both versions, so an argument the
    kernel refuses is refused on the CPU as well."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: want q (B, Hq, S, D) and k, v "
                         "(B, Hkv, Sk, D)")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if hq % k.shape[1] != 0:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={k.shape[1]}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    if type(q_offset) is not int \
            or not 0 <= q_offset <= MAX_POSITION - q.shape[2]:
        raise ValueError(f"flash_attention: q_offset must be an int in "
                         f"[0, {MAX_POSITION} - S], got {q_offset!r}")


@functools.lru_cache(maxsize=256)
def band_pairs(s: int, sk: int, *, causal: bool, window: int | None,
               q_offset: int) -> int:
    """The (query, key) pairs of one head the mask keeps: query i at
    position ``q_offset + i`` sees key j when ``j <= q_offset + i``
    (causal) and ``j > q_offset + i - window``."""
    total = 0
    for p in range(q_offset, q_offset + s):
        hi = min(sk - 1, p) if causal else sk - 1
        lo = max(0, p - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def work(b: int, hq: int, hkv: int, s: int, sk: int, d: int, itemsize: int,
         *, causal: bool, window: int | None,
         q_offset: int) -> tuple[float, int]:
    """FLOPs and bytes of one launch: ``4 D`` a kept (query, key) pair and
    query head (Q.K^T and P.V, :func:`band_pairs`); q read once, the output
    written once, and k and v read once up to the causal edge (a prompt
    over a ``max_len`` buffer needs no key past ``q_offset + S``)."""
    pairs = band_pairs(s, sk, causal=causal, window=window,
                       q_offset=q_offset)
    keys = min(sk, q_offset + s) if causal else sk
    nbytes = itemsize * (2 * b * hq * s * d + 2 * b * hkv * keys * d)
    return 4.0 * d * pairs * b * hq, nbytes


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          softcap: float | None = None,
                          scale: float | None = None, q_offset: int = 0,
                          return_lse: bool = False):
    """The kernel's function as one dense masked softmax in f32: the same
    constants, the zero-mass rule, and no key past ``Sk`` (the dense form
    has no padding to mask).  ``return_lse``: ``(out, lse)``."""
    _check(q, k, v, window=window, softcap=softcap, q_offset=q_offset)
    s_q, d = q.shape[2], q.shape[3]
    s_k = k.shape[2]
    group = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kx = k.float().repeat_interleave(group, dim=1)
    vx = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kx.transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset + torch.arange(s_q, device=q.device)[:, None]
    k_pos = torch.arange(s_k, device=q.device)[None, :]
    mask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    den = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p, vx) / torch.where(den == 0.0, 1.0, den)).to(
        q.dtype)
    if not return_lse:
        return out
    lse = torch.where(den == 0.0, torch.inf, m + torch.log(den))
    return out, lse.squeeze(-1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_flash_attention.argtypes = (
        [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci] + [ll] * 9
        + [ctypes.c_float, ci, ci, ctypes.c_float, ci, vp, vp])
    lib.repro_flash_attention.restype = ci
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None, q_offset: int = 0,
                         return_lse: bool = False):
    """Launch ``csrc/flash_attention.cu`` on q's device and stream.  q, k, v
    may be strided views (the model passes head-transposed projections)
    as long as the last dimension is contiguous and every stride is a
    multiple of 8 elements; the output is contiguous.  ``return_lse``:
    ``(out, lse)``, the kernel writing the statistics as it goes (without
    it no statistics are written)."""
    global launches, flops, bytes_moved
    _check(q, k, v, window=window, softcap=softcap, q_offset=q_offset)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: q, k, v must lie on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda: want q, k, v all f32 or all "
                         f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM or d % 8 != 0:
        raise ValueError(f"flash_attention_cuda: head dim {d} is not a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} needs a "
                             f"contiguous last dimension, strides that are "
                             f"multiples of 8 and 16-byte alignment, got "
                             f"strides {t.stride()}")
    if b * hq > 65535:
        raise ValueError(f"flash_attention_cuda: B*Hq={b * hq} exceeds the "
                         f"grid limit 65535")
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0 or sk == 0:
        return (out.zero_(), lse.fill_(torch.inf)) if return_lse \
            else out.zero_()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, hq, hkv, s, sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale),
        int(causal), 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), q_offset,
        None if lse is None else lse.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA error {err}")
    launches += 1
    f, nb = work(b, hq, hkv, s, sk, d, q.element_size(), causal=causal,
                 window=window, q_offset=q_offset)
    flops, bytes_moved = flops + f, bytes_moved + nb
    return (out, lse) if return_lse else out
