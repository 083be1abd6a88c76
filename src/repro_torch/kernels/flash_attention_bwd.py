"""The gradient of :mod:`flash_attention`: dq, dk, dv from q, k, v, the
forward's output o, its row statistics lse (``return_lse=True``) and the
upstream dO.

The JAX package has no such kernel: it trains through plain attention
(``models/layers.py::chunked_attention``) under ``jax.grad``.  The port's
training forward runs the flash kernel, so its backward is a kernel as
well: ``csrc/flash_attention_bwd.cu`` (two or three launches a call, no
atomics, the same bits on every run; bf16 with D a multiple of 32 on the
tensor cores, P from the forward's statistics, with P and dS rounded to
bf16 before their products and a KV head's query heads split over CTAs
where the card would sit idle (:func:`dkdv_splits`); f32 and other D on
the CUDA cores in f32, which recompute the statistics).
:func:`flash_attention_bwd_plain` is the same function as one dense f32
computation written out (not autograd), used for CPU tensors and as the
kernel's oracle on the card.  Both take every option of the forward but a
query offset, which no training caller passes: ``q_offset != 0`` raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _fa

launches = 0          # wrapper calls that launched the kernel (plain int)
flops = 0.0           # their work record (``work``): FLOPs and bytes,
bytes_moved = 0.0     # added where ``launches`` is


def _check(q, k, v, o, do, lse, *, window, softcap, q_offset) -> None:
    _fa._check(q, k, v, window=window, softcap=softcap, q_offset=q_offset)
    if q_offset != 0:
        raise ValueError(f"flash_attention_bwd: q_offset must be 0 (no "
                         f"training caller offsets its queries), got "
                         f"{q_offset}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and dO "
                         f"{tuple(do.shape)} must be shaped as q "
                         f"{tuple(q.shape)}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be f32 shaped "
                         f"{tuple(q.shape[:3])}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")


def work(b: int, hq: int, hkv: int, s: int, sk: int, d: int, itemsize: int,
         *, causal: bool, window: int | None) -> tuple[float, int]:
    """FLOPs and bytes of one call: ``10 D`` a kept (query, key) pair and
    query head, the five products a backward needs (S again, dV, dP, dQ,
    dK; what a kernel executes beyond them, S^T twice at D = 256 on the
    tensor cores or the CUDA cores' statistics pass, is its overhead and
    is not counted); q, k, v, o and dO read once, dq, dk and dv written
    once, and the two f32 row statistics written once."""
    pairs = _fa.band_pairs(s, sk, causal=causal, window=window, q_offset=0)
    nbytes = itemsize * (4 * b * hq * s * d + 4 * b * hkv * sk * d) \
        + 4 * 2 * b * hq * s
    return 10.0 * d * pairs * b * hq, nbytes


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                              window: int | None = None,
                              softcap: float | None = None,
                              scale: float | None = None,
                              q_offset: int = 0) -> tuple:
    """(dq, dk, dv) in the inputs' dtypes, from one dense f32 computation:
    P = exp(x - lse) on the kept pairs (x the masked, capped logits, lse
    the forward's statistics), dV = P^T dO, dP = dO V^T, D = rowsum(dO o),
    dS = P (dP - D), through the softcap's ``1 - t^2`` and the scale,
    dQ = dS K and dK = dS^T Q; dk and dv of a KV head sum over its group's
    query heads."""
    _check(q, k, v, o, do, lse, window=window, softcap=softcap,
           q_offset=q_offset)
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q32, o32, do32 = q.float(), o.float(), do.float()
    kx = k.float().repeat_interleave(group, dim=1)
    vx = v.float().repeat_interleave(group, dim=1)
    x = torch.matmul(q32, kx.transpose(-1, -2)) * scale
    t = None
    if softcap is not None:
        t = torch.tanh(x / softcap)
        x = softcap * t
    q_pos = torch.arange(s_q, device=q.device)[:, None]
    k_pos = torch.arange(s_k, device=q.device)[None, :]
    mask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    p = torch.where(mask, torch.exp(x - lse[..., None]), 0.0)
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, vx.transpose(-1, -2))
    ds = p * (dp - (do32 * o32).sum(dim=-1, keepdim=True))
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dq = torch.matmul(ds, kx)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    dk = dk.reshape(b, hkv, group, s_k, d).sum(dim=2)
    dv = dv.reshape(b, hkv, group, s_k, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention_bwd")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_flash_attention_bwd.argtypes = (
        [vp] * 11 + [ci] * 9 + [ll] * 15
        + [ctypes.c_float, ci, ci, ctypes.c_float, vp])
    lib.repro_flash_attention_bwd.restype = ci
    lib.repro_flash_bwd_keys.argtypes = (ci,)
    lib.repro_flash_bwd_keys.restype = ci
    return lib


# Below about two waves of dkdv CTAs on the card the tensor cores split a
# KV head's group of query heads over CTAs, each split's dK and dV summed
# in split order afterwards.
SPLIT_WAVES = 2


def dkdv_splits(b: int, hq: int, hkv: int, sk: int, keys: int,
                sms: int) -> int:
    """Query-head splits of the tensor-core dkdv launch of CTAs of
    ``keys`` keys on a card of ``sms`` SMs: 1 where ``B * Hkv * ceil(Sk /
    keys)`` CTAs fill ``SPLIT_WAVES`` waves, else the smallest divisor of
    the group ``Hq / Hkv`` that does (the whole group where none does)."""
    ctas = b * hkv * -(-sk // keys)
    want = SPLIT_WAVES * sms
    group = hq // hkv
    if ctas >= want:
        return 1
    need = -(-want // ctas)
    return next((n for n in range(need, group + 1) if group % n == 0), group)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def card_splits(b: int, hq: int, hkv: int, sk: int, d: int,
                device: torch.device) -> int:
    """:func:`dkdv_splits` of a bf16 call at head dim ``d`` on ``device``:
    the library's dkdv CTA at that D and the card's SMs; 1 where the call
    runs on the CUDA cores (D not a multiple of 32)."""
    if d % 32:
        return 1
    return dkdv_splits(b, hq, hkv, sk, _lib().repro_flash_bwd_keys(d),
                       _sms(device.index))


def strides_ok(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` as it is: a contiguous last dimension,
    the other strides multiples of 8 elements, a 16-byte-aligned base."""
    return t.stride(3) == 1 and not any(st % 8 for st in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int | None = None,
                             softcap: float | None = None,
                             scale: float | None = None,
                             q_offset: int = 0) -> tuple:
    """Launch ``csrc/flash_attention_bwd.cu`` on q's device and stream.
    q, k, v, o and dO may be strided views (:func:`strides_ok`), lse is
    contiguous; dq, dk and dv come back contiguous."""
    global launches, flops, bytes_moved
    _check(q, k, v, o, do, lse, window=window, softcap=softcap,
           q_offset=q_offset)
    ts = (("q", q), ("k", k), ("v", v), ("o", o), ("dO", do))
    if not all(t.is_cuda and t.device == q.device for _, t in ts + (
            ("lse", lse),)):
        raise ValueError("flash_attention_bwd_cuda: q, k, v, o, dO, lse must "
                         "lie on one CUDA device")
    if not lse.is_contiguous():
        raise ValueError("flash_attention_bwd_cuda: lse must be contiguous")
    if q.dtype not in _fa._DTYPES or any(t.dtype != q.dtype for _, t in ts):
        raise ValueError(f"flash_attention_bwd_cuda: want q, k, v, o, dO all "
                         f"f32 or all bf16, got "
                         f"{[str(t.dtype) for _, t in ts]}")
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > _fa.MAX_HEAD_DIM or d % 8 != 0:
        raise ValueError(f"flash_attention_bwd_cuda: head dim {d} is not a "
                         f"multiple of 8 up to {_fa.MAX_HEAD_DIM}")
    for name, t in ts:
        if not strides_ok(t):
            raise ValueError(f"flash_attention_bwd_cuda: {name} needs a "
                             f"contiguous last dimension, strides that are "
                             f"multiples of 8 and 16-byte alignment, got "
                             f"strides {t.stride()}")
    if b * hq > 65535:
        raise ValueError(f"flash_attention_bwd_cuda: B*Hq={b * hq} exceeds "
                         f"the grid limit 65535")
    dq = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hkv, sk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    tensor_cores = q.dtype == torch.bfloat16 and d % 32 == 0
    # D_i, and on the CUDA cores each row's log-sum-exp beside it.
    ws = torch.empty((1 if tensor_cores else 2, b * hq * s),
                     dtype=torch.float32, device=q.device)
    nsplit = card_splits(b, hq, hkv, sk, d, q.device) if tensor_cores else 1
    part = torch.empty((nsplit, 2, b * hkv * sk * d), dtype=torch.float32,
                       device=q.device) if nsplit > 1 else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), ws.data_ptr(),
        None if part is None else part.data_ptr(), nsplit,
        _sms(q.device.index), int(q.dtype == torch.bfloat16), b, hq, hkv, s,
        sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], float(scale), int(causal),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd: CUDA error {err}")
    launches += 1
    f, nb = work(b, hq, hkv, s, sk, d, q.element_size(), causal=causal,
                 window=window)
    flops, bytes_moved = flops + f, bytes_moved + nb
    return dq, dk, dv
