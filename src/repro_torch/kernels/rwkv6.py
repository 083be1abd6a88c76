"""The RWKV-6 ("Finch") recurrence with data-dependent decay.

Per head of size D, along T, with a D x D f32 state S:

    o_t = r_t . (S + diag(u) . k_t v_t^T)
    S  <- diag(w_t) . S + k_t v_t^T

Port of the JAX package's ``kernels/rwkv6.py::rwkv6_scan``, widened to the
function the model needs (``models/rwkv.py::rwkv6_chunked``): a per-head
``u`` of shape ``(H, D)`` (row ``bh % H`` serves row ``bh``; a ``(D,)`` u
is ``H = 1``), an optional initial state and an optional final state.  At
``state0=None`` and ``H = 1`` it is exactly the TPU kernel's function.

Contract: r, k, v ``(BH, T, D)``, all f32 or all bf16; w ``(BH, T, D)`` f32;
u f32; state0 ``(BH, D, D)`` f32 (``S[i][j]`` pairs key channel ``i`` with
value channel ``j``) or None for zeros.  The output is ``(BH, T, D)`` in r's
dtype, the final state f32.  The CUDA kernels are in ``csrc/rwkv6_scan.cu``:
the sequential recurrence for short T (the decode tick) and the chunked
form for longer T (the forward, a prefill, a later chunk from a carried
state), chosen by ``CHUNKED_MIN_T``.  Both take r, k, v, w as strided views
(any batch-head and time strides, a contiguous last axis), so the model's
head-transposed projections need no copy where they form a ``(BH, T, D)``
view.  :func:`rwkv6_scan_plain` is the same function in plain PyTorch, used
for CPU tensors and as the kernels' oracle on the card.

The gradient (r, k, v, w and u; no state in or out) is the kernel of
``csrc/rwkv6_scan_bwd.cu`` (:func:`rwkv6_scan_bwd_cuda`, counted in
:data:`bwd`), beside its plain version :func:`rwkv6_scan_bwd_plain`: the
state S forward, then the adjoint G backwards beside each kept S, so that
dw is summed from S and G of one step.  The kernel is chunked on the
forward's chunks (:data:`CHUNK`): training's forward returns the state at
every chunk start but the first (``return_chunk_states``), and the
backward takes them, so it never runs S over T again.
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset (plain int)
flops = 0.0           # their work record (``work``): FLOPs and bytes,
bytes_moved = 0.0     # added where ``launches`` is

HEAD_DIMS = (32, 64, 128)       # the head sizes the CUDA kernel is built for
_DTYPES = (torch.float32, torch.bfloat16)
F32 = torch.float32
# T from which a launch takes the chunked kernel, and its chunk length per
# head size (D = 128 has shared memory for 32 steps only).  Shorter T (the
# decode tick) keeps the sequential kernel: at B = 1, 64 heads of 64, bf16,
# it is the faster one up to T = 16 and the chunked one from T = 32
# (chip_smoke.py's threshold sweep; PERF.md).
CHUNKED_MIN_T = 32
CHUNK = {32: 64, 64: 64, 128: 32}
# The backward's launch counter and work record (``work_bwd``), beside the
# forward's: a kernel of its own in the port's counts.
bwd = types.SimpleNamespace(launches=0, flops=0.0, bytes_moved=0.0)


def n_chunk_states(t: int, d: int) -> int:
    """Chunk states of a T-step forward: one at every chunk start but
    the first."""
    return -(-t // CHUNK[d]) - 1


def bwd_scratch_bytes(bh: int, t: int, d: int) -> int:
    """Device scratch of one backward call: the adjoint G at every chunk
    end but the last (shaped as the chunk states) and D floats a row."""
    return 4 * bh * d * (n_chunk_states(t, d) * d + 1)


def _check(r, k, v, w, u, state0) -> int:
    """Shape checks shared by both versions; returns H."""
    if r.dim() != 3 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"rwkv6_scan: want r, k, v, w of one shape (BH, T, "
                         f"D), got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    bh, t_len, d = r.shape
    if bh == 0 or t_len == 0:
        raise ValueError(f"rwkv6_scan: empty input {tuple(r.shape)}")
    if u.dim() == 1:
        u = u[None]
    if u.dim() != 2 or u.shape[1] != d or u.shape[0] < 1 \
            or bh % u.shape[0] != 0:
        raise ValueError(f"rwkv6_scan: want u (D,) or (H, D) with H dividing "
                         f"BH={bh}, D={d}; got {tuple(u.shape)}")
    if state0 is not None and tuple(state0.shape) != (bh, d, d):
        raise ValueError(f"rwkv6_scan: want state0 ({bh}, {d}, {d}), got "
                         f"{tuple(state0.shape)}")
    return u.shape[0]


def work(bh: int, t: int, d: int, heads: int, itemsize: int, *,
         state_in: bool, state_out: bool) -> tuple[float, int]:
    """FLOPs and bytes of one launch over ``(bh, t, d)``: ``5 D^2 + 5 D``
    a row and step (r.S, r.(u*k), the bonus, the decay and the k v^T
    update); r, k, v read and the output written at ``itemsize``, w read in
    f32, u once a head, and the f32 state read and written when carried."""
    n = bh * t * d
    nbytes = 4 * n * itemsize + 4 * n + 4 * heads * d
    nbytes += 4 * bh * d * d * (int(state_in) + int(state_out))
    return bh * t * (5.0 * d * d + 5.0 * d), nbytes


def work_bwd(bh: int, t: int, d: int, heads: int,
             itemsize: int) -> tuple[float, int]:
    """FLOPs and bytes of one backward call over ``(bh, t, d)``: ``10 D^2
    + 12 D`` a row and step (S rebuilt, S do, the G update, G v and G^T k
    at 2 D^2 each; v.do, r.(u k), the bonus terms of dr, dk, dv and du at
    2 D each); r, k, v and do read and dr, dk, dv written at ``itemsize``,
    w read and dw written in f32, u read and du written once a head.  The
    kernel's own extra products, the chunk states it reads and the G
    states it keeps are not counted."""
    n = bh * t * d
    nbytes = 7 * n * itemsize + 8 * n + 8 * heads * d
    return bh * t * (10.0 * d * d + 12.0 * d), nbytes


def _outputs(out, s_fin, states, return_state, return_chunk_states):
    """The output, then the final state and the chunk states if asked."""
    extra = ((s_fin,) if return_state else ()) + (
        (states,) if return_chunk_states else ())
    return (out, *extra) if extra else out


def rwkv6_scan_plain(r, k, v, w, u, *, state0=None,
                     return_state: bool = False,
                     return_chunk_states: bool = False):
    """A loop over T in f32.  Returns the output, then the final state
    when ``return_state``, then the chunk states (the state before every
    chunk of :data:`CHUNK` steps but the first, ``(BH,
    n_chunk_states, D, D)`` f32) when ``return_chunk_states``."""
    h = _check(r, k, v, w, u, state0)
    bh, t_len, d = r.shape
    r32, k32, v32, w32 = r.float(), k.float(), v.float(), w.float()
    u32 = u.float().reshape(h, d).repeat(bh // h, 1)        # (BH, D)
    s = (torch.zeros((bh, d, d), dtype=F32, device=r.device)
         if state0 is None else state0.float().clone())
    out = torch.empty((bh, t_len, d), dtype=F32, device=r.device)
    c_len, kept = CHUNK[d] if return_chunk_states else 0, []
    for t in range(t_len):
        rt, kt, vt = r32[:, t], k32[:, t], v32[:, t]
        bonus = (rt * u32 * kt).sum(-1, keepdim=True)       # (BH, 1)
        out[:, t] = torch.bmm(rt[:, None], s)[:, 0] + bonus * vt
        s = w32[:, t, :, None] * s + kt[:, :, None] * vt[:, None, :]
        if return_chunk_states and (t + 1) % c_len == 0 and t + 1 < t_len:
            kept.append(s)
    states = (torch.stack(kept, 1) if kept else
              torch.zeros((bh, 0, d, d), dtype=F32, device=r.device)) \
        if return_chunk_states else None
    return _outputs(out.to(r.dtype), s, states, return_state,
                    return_chunk_states)


def rwkv6_scan_bwd_plain(r, k, v, w, u, do):
    """(dr, dk, dv, dw, du) of :func:`rwkv6_scan_plain` from zeros, no state
    out, for the upstream ``do``: loops over T in f32, S forward keeping
    every S_{t-1}, then the adjoint G backwards:

        dr_t = S_{t-1} do_t + u k_t (v_t . do_t)
        dk_t = G_t v_t + u r_t (v_t . do_t)
        dv_t = G_t^T k_t + (r_t . u k_t) do_t
        dw_t = rowsum(G_t * S_{t-1})
        G_{t-1} = diag(w_t) G_t + r_t do_t^T
        du = sum_t r_t k_t (v_t . do_t)

    dr, dk, dv in r's dtype, dw and du (u's shape) in f32; du sums the rows
    of each head."""
    h = _check(r, k, v, w, u, None)
    if do.shape != r.shape:
        raise ValueError(f"rwkv6_scan_bwd: want do shaped as r "
                         f"{tuple(r.shape)}, got {tuple(do.shape)}")
    bh, t_len, d = r.shape
    r32, k32, v32, w32, do32 = (x.float() for x in (r, k, v, w, do))
    u32 = u.float().reshape(h, d).repeat(bh // h, 1)[:, None]   # (BH,1,D)
    hist = [torch.zeros((bh, d, d), dtype=F32, device=r.device)]
    for t in range(t_len - 1):
        hist.append(w32[:, t, :, None] * hist[-1]
                    + k32[:, t, :, None] * v32[:, t, None, :])
    drs, dks, dvs, dw = (torch.empty((bh, t_len, d), dtype=F32,
                                     device=r.device) for _ in range(4))
    g = torch.zeros((bh, d, d), dtype=F32, device=r.device)
    for t in reversed(range(t_len)):
        s_prev = hist.pop()
        drs[:, t] = torch.bmm(s_prev, do32[:, t, :, None])[..., 0]
        dks[:, t] = torch.bmm(g, v32[:, t, :, None])[..., 0]
        dvs[:, t] = torch.bmm(k32[:, t, None, :], g)[:, 0]
        dw[:, t] = (g * s_prev).sum(-1)
        g = w32[:, t, :, None] * g + r32[:, t, :, None] * do32[:, t, None, :]
    vdo = (v32 * do32).sum(-1, keepdim=True)
    dr = drs + u32 * k32 * vdo
    dk = dks + u32 * r32 * vdo
    dv = dvs + (r32 * u32 * k32).sum(-1, keepdim=True) * do32
    du = (r32 * k32 * vdo).sum(1).reshape(bh // h, h, d).sum(0)
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw,
            du.reshape(u.shape))


def _aligned16(t: torch.Tensor) -> bool:
    """Whether every row of t starts on a 16-byte boundary."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (t.stride(i) * es) % 16 == 0 for i in (0, 1))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("rwkv6_scan")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_rwkv6_scan.argtypes = (
        [vp] * 8 + [ci] * 5 + [ll] * 8 + [vp])
    lib.repro_rwkv6_scan.restype = ci
    lib.repro_rwkv6_scan_chunked.argtypes = (
        [vp] * 9 + [ci] * 6 + [ll] * 8 + [vp])
    lib.repro_rwkv6_scan_chunked.restype = ci
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.library("rwkv6_scan_bwd")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_rwkv6_scan_bwd.argtypes = (
        [vp] * 13 + [ci] * 7 + [ll] * 10 + [vp])
    lib.repro_rwkv6_scan_bwd.restype = ci
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rwkv6_scan_cuda(r, k, v, w, u, *, state0=None,
                    return_state: bool = False,
                    return_chunk_states: bool = False):
    """Launch ``csrc/rwkv6_scan.cu`` on r's device and stream: the chunked
    kernel when T >= ``CHUNKED_MIN_T`` (or when chunk states are asked and
    there is more than one chunk), else the sequential one; one launch
    either way, no workspace, no host sync.  r, k, v, w may be strided
    views with a contiguous last axis; u and state0 are made contiguous
    (state0 also 16-byte aligned).  The output, the final state and the
    chunk states (as :func:`rwkv6_scan_plain` returns them; the chunked
    kernel stores them only when asked) are new contiguous tensors."""
    global launches, flops, bytes_moved
    h = _check(r, k, v, w, u, state0)
    ts = (r, k, v, w, u) + (() if state0 is None else (state0,))
    if not all(t.is_cuda and t.device == r.device for t in ts):
        raise ValueError("rwkv6_scan_cuda: every input must lie on one CUDA "
                         "device")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"rwkv6_scan_cuda: want r, k, v all f32 or all "
                         f"bf16, got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != F32 or u.dtype != F32 \
            or (state0 is not None and state0.dtype != F32):
        raise ValueError("rwkv6_scan_cuda: w, u and state0 must be f32")
    bh, t_len, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan_cuda: head dim {d} is not one the "
                         f"kernel takes {HEAD_DIMS}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(2) != 1:
            raise ValueError(f"rwkv6_scan_cuda: {name} needs a contiguous "
                             f"last axis, got strides {t.stride()}")
    if bh > 2 ** 31 - 1:
        raise ValueError(f"rwkv6_scan_cuda: BH={bh} exceeds the grid limit")
    u = u.reshape(h, d).contiguous()
    s0 = None
    if state0 is not None:
        # The kernel reads the state as 16-byte vectors.
        s0 = state0.contiguous()
        if s0.data_ptr() % 16:
            s0 = s0.clone()
    out = torch.empty((bh, t_len, d), dtype=r.dtype, device=r.device)
    s_fin = (torch.empty((bh, d, d), dtype=F32, device=r.device)
             if return_state else None)
    n_st = n_chunk_states(t_len, d) if return_chunk_states else 0
    states = (torch.empty((bh, n_st, d, d), dtype=F32, device=r.device)
              if return_chunk_states else None)
    chunked = t_len >= CHUNKED_MIN_T or n_st > 0
    if chunked:
        # The chunked kernel copies rows in 16-byte pieces: a view whose
        # rows are not so aligned is copied (the model's views are).
        r, k, v, w = (t if _aligned16(t)
                      else t.clone(memory_format=torch.contiguous_format)
                      for t in (r, k, v, w))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), 0 if s0 is None else s0.data_ptr(), out.data_ptr(),
            0 if s_fin is None else s_fin.data_ptr(),
            int(r.dtype == torch.bfloat16), bh, h, t_len, d)
    strides = (r.stride(0), r.stride(1), k.stride(0), k.stride(1),
               v.stride(0), v.stride(1), w.stride(0), w.stride(1))
    if chunked:
        err = _lib().repro_rwkv6_scan_chunked(
            *ptrs[:8], states.data_ptr() if n_st else 0, *ptrs[8:], CHUNK[d],
            *strides, stream)
    else:
        err = _lib().repro_rwkv6_scan(*ptrs, *strides, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan: CUDA error {err}")
    launches += 1
    f, nb = work(bh, t_len, d, h, r.element_size(), state_in=s0 is not None,
                state_out=return_state)
    flops, bytes_moved = flops + f, bytes_moved + nb
    return _outputs(out, s_fin, states, return_state, return_chunk_states)


def rwkv6_scan_bwd_cuda(r, k, v, w, u, do, states):
    """Launch ``csrc/rwkv6_scan_bwd.cu`` on r's device and stream: the
    gradient of :func:`rwkv6_scan_cuda` from zeros, as
    :func:`rwkv6_scan_bwd_plain` returns it, from the forward's chunk
    states (``rwkv6_scan_cuda(..., return_chunk_states=True)``).  r, k, v,
    w and do may be strided views with a contiguous last axis and 16-byte
    aligned rows (others are copied); the outputs are new contiguous
    tensors.  Three launches (G's carry over chunks, every chunk at once,
    du's sum), no host sync; its scratch is :func:`bwd_scratch_bytes`."""
    h = _check(r, k, v, w, u, None)
    ts = (r, k, v, w, u, do, states)
    if not all(t.is_cuda and t.device == r.device for t in ts):
        raise ValueError("rwkv6_scan_bwd_cuda: every input must lie on one "
                         "CUDA device")
    if do.shape != r.shape:
        raise ValueError(f"rwkv6_scan_bwd: want do shaped as r "
                         f"{tuple(r.shape)}, got {tuple(do.shape)}")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, do)):
        raise ValueError(f"rwkv6_scan_bwd_cuda: want r, k, v, do all f32 or "
                         f"all bf16, got {r.dtype}, {k.dtype}, {v.dtype}, "
                         f"{do.dtype}")
    if w.dtype != F32 or u.dtype != F32:
        raise ValueError("rwkv6_scan_bwd_cuda: w and u must be f32")
    bh, t_len, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan_bwd_cuda: head dim {d} is not one the "
                         f"kernel takes {HEAD_DIMS}")
    n_st = n_chunk_states(t_len, d)
    if tuple(states.shape) != (bh, n_st, d, d) or states.dtype != F32 \
            or not states.is_contiguous() or states.data_ptr() % 16:
        raise ValueError(f"rwkv6_scan_bwd_cuda: want the forward's chunk "
                         f"states, contiguous ({bh}, {n_st}, {d}, {d}) f32; "
                         f"got {tuple(states.shape)} {states.dtype}")
    if bh * (n_st + 1) > 2 ** 31 - 1:
        raise ValueError(f"rwkv6_scan_bwd_cuda: BH={bh} x {n_st + 1} chunks "
                         f"exceeds the grid limit")
    r, k, v, w, do = (
        t if t.stride(2) == 1 and _aligned16(t)
        else t.clone(memory_format=torch.contiguous_format)
        for t in (r, k, v, w, do))
    u_in = u.reshape(h, d).contiguous()
    dev = r.device
    dr, dk, dv = (torch.empty((bh, t_len, d), dtype=r.dtype, device=dev)
                  for _ in range(3))
    dw = torch.empty((bh, t_len, d), dtype=F32, device=dev)
    du = torch.empty((h, d), dtype=F32, device=dev)
    work = torch.empty(bwd_scratch_bytes(bh, t_len, d) // 4, dtype=F32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd_lib().repro_rwkv6_scan_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u_in.data_ptr(), do.data_ptr(), states.data_ptr() if n_st else 0,
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        du.data_ptr(), work.data_ptr(), int(r.dtype == torch.bfloat16), bh, h,
        t_len, d, CHUNK[d], _sms(dev.index if dev.index is not None
                                 else torch.cuda.current_device()),
        r.stride(0), r.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), w.stride(0), w.stride(1), do.stride(0), do.stride(1),
        stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_bwd: CUDA error {err}")
    bwd.launches += 1
    f, nb = work_bwd(bh, t_len, d, h, r.element_size())
    bwd.flops, bwd.bytes_moved = bwd.flops + f, bwd.bytes_moved + nb
    return dr, dk, dv, dw, du.reshape(u.shape)
