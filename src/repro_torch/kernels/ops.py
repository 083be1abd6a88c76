"""Public entry points for the port's kernels, dispatched on the device.

A CPU tensor runs the kernel's plain PyTorch version; any other tensor runs
the CUDA kernel, which raises on what it cannot take.  There is no fallback
from the kernel to the plain version.

Autograd sees three kernels: where grad is enabled and an input requires
it, ``flash_attention``, ``linear_scan`` and ``rwkv6_scan`` run as a
``torch.autograd.Function`` whose forward is the dispatch above and whose
backward is the same dispatch of the backward (``flash_attention_bwd``;
``linear_scan`` run backwards in time; ``rwkv6_scan_bwd``), so the CPU runs
the same Function, saved tensors and formulas as the card.  The other
kernels have no backward and raise a ``RuntimeError`` naming the kernel
for such inputs, on every device.  With grad off (serving) nothing is
recorded and every call runs as before.

**The pricing route.**  Where every tensor argument of a wrapper is a fake
tensor (``torch._subclasses.fake_tensor.is_fake``, which also sees through
a ``DTensor``'s local tensor), the wrapper runs neither the kernel nor its
plain version: it adds the call and its work record (the module's
``work(...)`` at the local shapes) to the pricing route's own record
(:func:`priced_counts`), never to a launch counter, and returns empty
outputs of the shapes, dtypes and placements the kernel gives.  The dry run
(:mod:`repro_torch.launch.dryrun`) prices a step this way; a plain scan's
loop over T would otherwise trace every step.  A ``DTensor`` argument is
first laid out where the kernel's local call is the global one (the
sequence dims whole, k and v split as q), as the reference's GSPMD would
place it.  A real tensor, on the CPU or the card, never takes this route.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core import tiling
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fb
from repro_torch.kernels import fused_dense as _fd
from repro_torch.kernels import fused_mlp as _fm
from repro_torch.kernels import gemm_int8 as _g8
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import rwkv6 as _rw
from repro_torch.kernels import tiled_gemm as _tg
from repro_torch.kernels.fused_mlp import FusedGroup, pack_group


# Each kernel's module, which holds its launch counter (``launches``) and
# beside it its work record (``flops``, ``bytes_moved``: the module's
# ``work`` of each launch's shapes).  A wrapper adds to both where it
# launches its CUDA kernel, never on the CPU branch (the plain versions are
# aten ops, which ``torch.utils.flop_counter`` counts itself); a replayed
# CUDA graph adds the launches and the work its capture recorded
# (kernels/graph.py).  The kernels are ctypes launches, which neither
# ``FlopCounterMode`` nor ``torch.profiler`` sees: the record is what makes
# a captured step's arithmetic visible.
_COUNTERS = {"fused_mlp_q8": _fm, "gemm_int8": _g8, "flash_attention": _fa,
             "linear_scan": _rg, "rwkv6_scan": _rw, "tiled_gemm": _tg,
             "fused_dense": _fd, "flash_attention_bwd": _fb,
             "rwkv6_scan_bwd": _rw.bwd}


def reset_launches() -> None:
    """Zero every kernel's launch counter and work record."""
    set_launches(dict.fromkeys(_COUNTERS, 0))
    set_work({name: {"flops": 0.0, "bytes": 0.0} for name in _COUNTERS})


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in _COUNTERS.items()}


def set_launches(counts: dict[str, int]) -> None:
    """Set every kernel's launch counter to ``counts[kernel]``."""
    for name, mod in _COUNTERS.items():
        mod.launches = counts[name]


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts[kernel]`` to each kernel's launch counter."""
    for name, n in counts.items():
        _COUNTERS[name].launches += n


def work_counts() -> dict[str, dict[str, float]]:
    """Each kernel's work record: ``{kernel: {"flops", "bytes"}}``."""
    return {name: {"flops": mod.flops, "bytes": mod.bytes_moved}
            for name, mod in _COUNTERS.items()}


def set_work(work: dict[str, dict[str, float]]) -> None:
    """Set every kernel's work record to ``work[kernel]``."""
    for name, mod in _COUNTERS.items():
        mod.flops, mod.bytes_moved = work[name]["flops"], work[name]["bytes"]


def add_work(work: dict[str, dict[str, float]]) -> None:
    """Add ``work[kernel]`` to each kernel's work record."""
    for name, w in work.items():
        mod = _COUNTERS[name]
        mod.flops += w["flops"]
        mod.bytes_moved += w["bytes"]


def work_since(before: dict[str, dict[str, float]]) -> dict:
    """The work recorded since ``before`` (a :func:`work_counts`)."""
    return {name: {key: w[key] - before[name][key] for key in w}
            for name, w in work_counts().items()}


# The pricing route's record, by kernel: ``{"calls", "flops", "bytes"}`` of
# the calls priced on fake tensors.  A priced call launches nothing, so it
# adds to no launch counter or work record above; the dry run's counter
# (``launch.graph_analysis.RankCounter``) reads this record beside them.
_PRICED = {name: {"calls": 0, "flops": 0.0, "bytes": 0.0}
           for name in _COUNTERS}


def priced_counts() -> dict[str, dict[str, float]]:
    """The pricing route's record: ``{kernel: {"calls", "flops",
    "bytes"}}``."""
    return {name: dict(rec) for name, rec in _PRICED.items()}


def priced_since(before: dict[str, dict[str, float]]) -> dict:
    """The calls priced since ``before`` (a :func:`priced_counts`)."""
    return {name: {key: rec[key] - before[name][key] for key in rec}
            for name, rec in _PRICED.items()}


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in tensors)


def _refuse_grad(kernel: str, *tensors) -> None:
    """Raise when autograd would have to differentiate ``kernel``, which has
    no backward."""
    if _wants_grad(*tensors):
        raise RuntimeError(f"{kernel}: the kernel has no backward; call it "
                           f"under torch.no_grad() or with inputs that do "
                           f"not require grad")


def _priced(*tensors) -> bool:
    """Every tensor argument is fake: the call is priced, not run.  A plain
    ``torch.Tensor`` is never fake, so a real call pays one type test."""
    for t in tensors:
        if type(t) is torch.Tensor:
            return False
    ts = [t for t in tensors if torch.is_tensor(t)]
    return bool(ts) and all(is_fake(t) for t in ts)


def _record(kernel: str, work: tuple[float, int]) -> None:
    """One priced call of ``kernel`` and its work record, in the pricing
    route's own record: nothing was launched."""
    rec = _PRICED[kernel]
    rec["calls"] += 1
    rec["flops"] += work[0]
    rec["bytes"] += work[1]


def _dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _local(t) -> torch.Tensor:
    return t.to_local() if _dtensor(t) else t


def _keep(placements, dims) -> list:
    """``placements`` with every ``Shard`` of a dim outside ``dims``
    replaced by ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in placements]


def _laid_out(t, placements):
    """``t`` redistributed to ``placements`` (a plain tensor as is)."""
    if not _dtensor(t) or list(t.placements) == list(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def _empty(ref, shape, dtype, dims=None, placements=None):
    """An empty output of global ``shape``: a ``DTensor`` split as ``ref``
    on the dims ``dims`` (default: every dim below ``len(shape)``), or laid
    out by ``placements``, where ``ref`` is one, else a plain tensor on
    ``ref``'s device."""
    if not _dtensor(ref):
        return torch.empty(shape, dtype=dtype, device=ref.device)
    from torch.distributed.tensor import DTensor
    from repro_torch.collectives import local_shape
    dims = range(len(shape)) if dims is None else dims
    pl = (_keep(ref.placements, set(dims)) if placements is None
          else list(placements))
    local = local_shape(tuple(shape), ref.device_mesh, pl)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device=_local(ref).device),
        ref.device_mesh, pl, run_check=False, shape=torch.Size(shape),
        stride=stride)


def _attention_layout(q, k):
    """q's and k's placements for an attention-shaped call (B, H, S, D):
    the batch and head splits q has, the sequence and feature dims whole;
    k split as q where its head count divides the split, else whole on
    that mesh dim (each rank's q heads read their k heads from it)."""
    pq = _keep(q.placements, {0, 1})
    mesh = q.device_mesh
    pk = [_keep([p], ())[0]
          if getattr(p, "dim", None) == 1 and k.shape[1] % mesh.size(i)
          else p for i, p in enumerate(pq)]
    return pq, pk


def _kv_heads(q, k) -> int:
    """The k heads one rank's q heads read (GQA: a group of q heads a k
    head)."""
    return max(1, _local(q).shape[1] * k.shape[1] // q.shape[1])


def _priced_flash(q, k, v, *, causal, window, softcap, scale, q_offset,
                  return_lse=False):
    if _dtensor(q):
        pq, pk = _attention_layout(q, k)
        q, k, v = _laid_out(q, pq), _laid_out(k, pk), _laid_out(v, pk)
    lq = _local(q)
    b, hq, s, d = lq.shape
    _record("flash_attention", _fa.work(
        b, hq, _kv_heads(q, k), s, k.shape[2], d, lq.element_size(),
        causal=causal, window=window, q_offset=q_offset))
    out = _empty(q, q.shape, q.dtype)
    if not return_lse:
        return out
    return out, _empty(q, q.shape[:3], torch.float32)


def _priced_flash_bwd(q, k, v, o, do, *, causal, window):
    pk = None
    if _dtensor(q):
        from torch.distributed.tensor import Partial
        pq, pk = _attention_layout(q, k)
        q, o, do = (_laid_out(t, pq) for t in (q, o, do))
        k, v = _laid_out(k, pk), _laid_out(v, pk)
        # A k head whole on a mesh dim that splits q's heads gathers its
        # gradient from every rank there: a partial sum, as GSPMD leaves it.
        pk = [Partial() if p != p_k else p_k for p, p_k in zip(pq, pk)]
    lq = _local(q)
    b, hq, s, d = lq.shape
    _record("flash_attention_bwd", _fb.work(
        b, hq, _kv_heads(q, k), s, k.shape[2], d, lq.element_size(),
        causal=causal, window=window))
    return (_empty(q, q.shape, q.dtype),
            _empty(k, k.shape, k.dtype, placements=pk),
            _empty(k, k.shape, k.dtype, placements=pk))


def _time_whole(*ts):
    """Scan operands (B, T, D) laid out with T whole, each as the first."""
    if not _dtensor(ts[0]):
        return ts
    pl = _keep(ts[0].placements, {0, 2})
    return tuple(_laid_out(t, pl) for t in ts)


def _rows_whole(*ts):
    """RWKV operands (BH, T, D) laid out with T and D whole."""
    if not _dtensor(ts[0]):
        return ts
    pl = _keep(ts[0].placements, {0})
    return tuple(_laid_out(t, pl) for t in ts)


def _priced_rwkv(r, k, v, w, u, *, state0=None, return_state=False,
                 return_chunk_states=False):
    r, k, v, w = _rows_whole(r, k, v, w)
    bh, t, d = _local(r).shape
    _record("rwkv6_scan", _rw.work(bh, t, d, _local(u).shape[0],
                                   r.element_size(),
                                   state_in=state0 is not None,
                                   state_out=return_state))
    out = _empty(r, r.shape, r.dtype)
    s_fin = _empty(r, (r.shape[0], d, d), torch.float32, dims=(0,)) \
        if return_state else None
    n_st = _rw.n_chunk_states(t, d) if d in _rw.CHUNK else 0
    states = _empty(r, (r.shape[0], n_st, d, d), torch.float32, dims=(0,)) \
        if return_chunk_states else None
    return _rw._outputs(out, s_fin, states, return_state,
                        return_chunk_states)


def fused_group(x: torch.Tensor, g: FusedGroup) -> torch.Tensor:
    """Run a packed fusion group (see :func:`pack_group`) on ``x``."""
    _refuse_grad("fused_mlp_q8", x, g.pack, g.xs)
    if _priced(x, g.pack, g.xs):
        shape, dtype = _fm.fused_mlp_q8_contract(x, g.dims)
        _record("fused_mlp_q8", _fm.work(x.shape[0], g.dims))
        return _empty(x, shape, dtype)
    if x.device.type == "cpu":
        return _fm.fused_mlp_q8_plain(x, g)
    return _fm.fused_mlp_q8_cuda(x, g)


def fused_mlp_q8(x, weights, w_scales, biases, x_scales, *,
                 act: str = "relu", act_last: bool = False) -> torch.Tensor:
    """A whole DR7' fusion group (N int8 dense layers) in one launch; packs
    the group on every call (the serving path packs once)."""
    return fused_group(x, pack_group(weights, w_scales, biases, x_scales,
                                     act=act, act_last=act_last))


def _blocks(what: str, plan, tile_ok, block_m, block_k, block_n):
    """The caller's blocks, the rest from ``plan()`` (a tile planner of
    :mod:`tiling`); a tile the kernel does not take (``tile_ok``) is
    refused on every device, so a plan cannot pass on the CPU and fail on
    the card."""
    if block_m is None or block_k is None or block_n is None:
        api = plan()
        block_m = block_m if block_m is not None else api.block_m
        block_k = block_k if block_k is not None else api.block_k
        block_n = block_n if block_n is not None else api.block_n
    if not tile_ok(block_m, block_k, block_n):
        raise ValueError(f"{what}: tile {(block_m, block_k, block_n)} is not "
                         f"one the kernel takes")
    return block_m, block_k, block_n


def gemm_int8(x, w, w_scale, x_scale: float = 1.0, *,
              block_m: int | None = None, block_k: int | None = None,
              block_n: int | None = None,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 GEMM with the dequantizing flush, over the caller's blocks or
    those of :func:`tiling.plan_api`."""
    block_m, block_k, block_n = _blocks(
        "gemm_int8", lambda: tiling.plan_api(x.shape[0], x.shape[1],
                                             w.shape[1]),
        tiling.tile_ok, block_m, block_k, block_n)
    _refuse_grad("gemm_int8", x, w, w_scale, x_scale)
    if _priced(x, w, w_scale, x_scale):
        shape, dtype = _g8.gemm_int8_contract(
            x, w, w_scale, block_m=block_m, block_k=block_k,
            block_n=block_n, out_dtype=out_dtype)
        _record("gemm_int8", _g8.work(x.shape[0], x.shape[1], shape[1],
                                      dtype.itemsize))
        return _empty(x, shape, dtype)
    if x.device.type == "cpu":
        return _g8.gemm_int8_plain(x, w, w_scale, x_scale,
                                   out_dtype=out_dtype)
    return _g8.gemm_int8_cuda(x, w, w_scale, x_scale, block_m=block_m,
                              block_k=block_k, block_n=block_n,
                              out_dtype=out_dtype)


class _FlashAttention(torch.autograd.Function):
    """flash_attention with its gradient: the forward asks for its row
    statistics and saves q, k, v, the output and the statistics; the
    backward is ``flash_attention_bwd`` (the CUDA kernel, or its plain
    version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.opts = {"causal": causal, "window": window, "softcap": softcap,
                    "scale": scale}
        out, lse = _flash(q, k, v, q_offset=0, return_lse=True, **ctx.opts)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, do, lse, **ctx.opts),
                None, None, None, None)


def _flash(q, k, v, **kw) -> torch.Tensor:
    if _priced(q, k, v):
        return _priced_flash(q, k, v, **kw)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, **kw)
    return _fa.flash_attention_cuda(q, k, v, **kw)


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Blocked attention, q ``(B, Hq, S, D)`` against k, v ``(B, Hkv, Sk,
    D)``; the queries sit at positions ``q_offset..q_offset+S-1`` of the
    key timeline.  Differentiable (at ``q_offset`` 0) where grad is on."""
    if _wants_grad(q, k, v):
        if q_offset != 0:
            raise ValueError(f"flash_attention: q_offset must be 0 where "
                             f"grad is on (no training caller offsets its "
                             f"queries), got {q_offset}")
        return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    return _flash(q, k, v, causal=causal, window=window, softcap=softcap,
                  scale=scale, q_offset=q_offset)


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None) -> tuple:
    """(dq, dk, dv) of :func:`flash_attention` for its output ``o``, the
    upstream ``do`` and the forward's row statistics ``lse``, as the
    autograd Function's backward computes them."""
    kw = {"causal": causal, "window": window, "softcap": softcap,
          "scale": scale}
    if _priced(q, k, v, o, do, lse):
        return _priced_flash_bwd(q, k, v, o, do, causal=causal,
                                 window=window)
    if q.device.type == "cpu":
        return _fb.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    if not _fb.strides_ok(do):
        do = do.contiguous()
    return _fb.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)


class _LinearScan(torch.autograd.Function):
    """linear_scan with its gradient, the same scan backwards in time."""

    @staticmethod
    def forward(ctx, a, b):
        h = _scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        if _priced(a, h, g):
            # linear_scan_bwd_cuda's composition, its scan priced.
            lam = _scan(torch.flip(_rg._next(a), [1]),
                        torch.flip(g.to(a.dtype), [1]))
            return _rg._grads(a, h, torch.flip(lam, [1]))
        if a.device.type == "cpu":
            return _rg.linear_scan_bwd_plain(a, h, g)
        return _rg.linear_scan_bwd_cuda(a, h, g)


def _scan(a, b) -> torch.Tensor:
    if _priced(a, b):
        a, b = _time_whole(a, b)
        _record("linear_scan", _rg.work(_local(a).numel(),
                                        a.element_size()))
        return _empty(a, a.shape, a.dtype)
    if a.device.type == "cpu":
        return _rg.linear_scan_plain(a, b)
    return _rg.linear_scan_cuda(a, b)


def linear_scan(a, b) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` along axis 1 from ``h = 0``;
    differentiable where grad is on."""
    if _wants_grad(a, b):
        return _LinearScan.apply(a, b)
    return _scan(a, b)


class _RWKV6Scan(torch.autograd.Function):
    """rwkv6_scan from zeros with its gradient: the forward saves r, k, v,
    w, u and, on the card, the state at every chunk start
    (``return_chunk_states``); the backward is ``rwkv6_scan_bwd`` (the
    CUDA kernel from those states, or the plain version on the CPU, which
    rebuilds S itself and is given none)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        if r.is_cuda:
            out, states = _rwkv(r, k, v, w, u, return_chunk_states=True)
        else:
            out, states = _rwkv(r, k, v, w, u), None
        ctx.save_for_backward(r, k, v, w, u, states)
        return out

    @staticmethod
    def backward(ctx, do):
        *ins, states = ctx.saved_tensors
        return rwkv6_scan_bwd(*ins, do, states)


def _rwkv(r, k, v, w, u, **kw):
    if _priced(r, k, v, w, u, kw.get("state0")):
        return _priced_rwkv(r, k, v, w, u, **kw)
    if r.device.type == "cpu":
        return _rw.rwkv6_scan_plain(r, k, v, w, u, **kw)
    return _rw.rwkv6_scan_cuda(r, k, v, w, u, **kw)


def rwkv6_scan(r, k, v, w, u, *, state0=None, return_state: bool = False):
    """The RWKV-6 recurrence over r, k, v, w ``(BH, T, D)`` with the bonus
    u ``(H, D)``, from ``state0`` (or zeros); with ``return_state`` returns
    (output, final f32 state).  Differentiable (from zeros, no state out)
    where grad is on."""
    if _wants_grad(r, k, v, w, u, state0):
        if state0 is not None or return_state:
            raise ValueError("rwkv6_scan: state0 and return_state must be "
                             "unset where grad is on (no training caller "
                             "carries a state)")
        return _RWKV6Scan.apply(r, k, v, w, u)
    return _rwkv(r, k, v, w, u, state0=state0, return_state=return_state)


def rwkv6_scan_bwd(r, k, v, w, u, do, states) -> tuple:
    """(dr, dk, dv, dw, du) of :func:`rwkv6_scan` from zeros for the
    upstream ``do``, as the autograd Function's backward computes them;
    ``states`` are the forward's chunk states on the card
    (``rwkv6_scan_cuda(..., return_chunk_states=True)``), and on the CPU,
    whose plain version reads none, may be None."""
    if _priced(r, k, v, w, u, do, states):
        r, k, v, w, do = _rows_whole(r, k, v, w, do)
        bh, t, d = _local(r).shape
        _record("rwkv6_scan_bwd", _rw.work_bwd(bh, t, d, _local(u).shape[0],
                                               r.element_size()))
        return (*(_empty(r, r.shape, r.dtype) for _ in range(3)),
                _empty(r, r.shape, torch.float32),
                _empty(u, u.shape, torch.float32))
    if r.device.type == "cpu":
        return _rw.rwkv6_scan_bwd_plain(r, k, v, w, u, do)
    return _rw.rwkv6_scan_bwd_cuda(r, k, v, w, u, do, states)


def tiled_gemm(x, w, *, block_m: int | None = None,
               block_k: int | None = None,
               block_n: int | None = None) -> torch.Tensor:
    """``x @ w`` over the caller's blocks or those of
    :func:`tiling.plan_tiled` (the tensor-core tile set for int8 and bf16,
    the CUDA-core one for f32): int8 -> int32 exactly, f32/bf16 keep their
    dtype."""
    size = x.element_size()
    bm, bk, bn = _blocks(
        "tiled_gemm",
        lambda: tiling.plan_tiled(x.shape[0], x.shape[1], w.shape[1],
                                  itemsize=size),
        lambda *t: tiling.tiled_tile_ok(*t, size), block_m, block_k, block_n)
    _refuse_grad("tiled_gemm", x, w)
    if _priced(x, w):
        shape, dtype = _tg.tiled_gemm_contract(x, w, block_m=bm, block_k=bk,
                                               block_n=bn)
        _record("tiled_gemm", _tg.work(*x.shape, shape[1], x.element_size(),
                                       dtype.itemsize))
        return _empty(x, shape, dtype)
    if x.device.type == "cpu":
        return _tg.tiled_gemm_plain(x, w)
    return _tg.tiled_gemm_cuda(x, w, block_m=bm, block_k=bk, block_n=bn)


def fused_dense(x, w, b, residual=None, *, act: str = "relu",
                block_m: int | None = None, block_k: int | None = None,
                block_n: int | None = None,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``act(x @ w + b) (+ residual)`` in one launch, f32 accumulation,
    over the caller's blocks or those of :func:`tiling.plan_fused_dense`."""
    bm, bk, bn = _blocks(
        "fused_dense",
        lambda: tiling.plan_fused_dense(x.shape[0], x.shape[1], w.shape[1],
                                        itemsize=x.element_size()),
        tiling.fused_dense_tile_ok, block_m, block_k, block_n)
    _refuse_grad("fused_dense", x, w, b, residual)
    if _priced(x, w, b, residual):
        shape, dtype = _fd.fused_dense_contract(
            x, w, b, residual, act=act, block_m=bm, block_k=bk, block_n=bn,
            out_dtype=out_dtype)
        _record("fused_dense", _fd.work(*x.shape, shape[1], x.element_size(),
                                        b.element_size(), dtype.itemsize,
                                        residual is not None))
        return _empty(x, shape, dtype)
    if x.device.type == "cpu":
        return _fd.fused_dense_plain(x, w, b, residual, act=act,
                                     out_dtype=out_dtype)
    return _fd.fused_dense_cuda(x, w, b, residual, act=act, block_m=bm,
                                block_k=bk, block_n=bn, out_dtype=out_dtype)
