"""Fused-group int8 MLP: a whole DR7' fusion group in one launch.

Port of the JAX package's ``kernels/fused_mlp.py::fused_mlp_q8``.  Per layer
``i`` of a group of ``L``::

    h = act(clip(round(h / xs_i), -127, 127) @ w_i * (ws_i * xs_i) + b_i)

with the activation on every layer but the last unless ``act_last``.  The
CUDA kernel (``csrc/fused_mlp_q8.cu``) keeps the int8 activations in shared
memory between layers; :func:`fused_mlp_q8_plain` is the same function in
plain PyTorch, used for CPU tensors and as the kernel's oracle on the card.

A group is packed once (:func:`pack_group`) into the layout the kernel
reads: every layer's weights transposed to ``(N_i, kp_i)`` with ``kp_i`` the
input width padded to a multiple of 4 with zeros (exact), concatenated; the
folded scale rows ``s_i = ws_i * xs_i`` (f32, folded on the host as the
reference does) and the bias rows concatenated the same way.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

ROWS = 8              # rows of M per CTA; csrc/fused_mlp_q8.cu's kRows
MAX_LAYERS = 16       # csrc/fused_mlp_q8.cu's kMaxLayers
K_MULTIPLE = 4        # __dp4a consumes 4 int8 values at a time

launches = 0          # kernel launches since the last reset (plain int)


def _ceil_to(x: int, q: int) -> int:
    return -(-x // q) * q


def padded_widths(dims) -> list[int]:
    return [_ceil_to(d, K_MULTIPLE) for d in dims]


def buffer_stride(dims) -> int:
    """Row stride of each int8 activation buffer: the widest layer input."""
    return max(padded_widths(dims[:-1]))


def fused_smem_bytes(dims, rows: int = ROWS) -> int:
    """Shared memory the kernel holds for a group with layer widths ``dims``
    (input first): two int8 activation buffers of ``rows`` rows, read by one
    layer while the next layer's input is written.  The planner prices a
    fusion group with this same function."""
    return 2 * rows * buffer_stride(dims)


@dataclasses.dataclass(frozen=True)
class FusedGroup:
    """One fusion group, packed for the kernel (see the module doc)."""
    dims: tuple[int, ...]          # true widths, input first
    wt: torch.Tensor               # int8, concatenated (N_i, kp_i) blocks
    s: torch.Tensor                # f32, concatenated ws_i * xs_i
    b: torch.Tensor                # f32, concatenated biases
    xs: torch.Tensor               # f32 (L,), per-layer input scales
    relu: bool
    act_last: bool

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def layer_views(self):
        """Per layer ``(wt_i (N_i, kp_i), s_i, b_i)`` views into the pack."""
        kp = padded_widths(self.dims)
        w_off = s_off = 0
        for i in range(self.n_layers):
            n = self.dims[i + 1]
            wt_i = self.wt[w_off:w_off + n * kp[i]].view(n, kp[i])
            yield wt_i, self.s[s_off:s_off + n], self.b[s_off:s_off + n]
            w_off += n * kp[i]
            s_off += n


def pack_group(weights, w_scales, biases, x_scales, *, act: str = "relu",
               act_last: bool = False) -> FusedGroup:
    """Pack a group's int8 weights ``(K_i, N_i)``, weight scales, biases and
    per-layer input scales (a sequence of floats or an f32 tensor)."""
    if act not in ("relu", "none"):
        raise ValueError(f"unsupported fused activation {act!r}")
    n_layers = len(weights)
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"a fused group holds 1..{MAX_LAYERS} layers, "
                         f"got {n_layers}")
    if not len(w_scales) == len(biases) == n_layers:
        raise ValueError("weights, w_scales and biases differ in length")
    device = weights[0].device
    xs = torch.as_tensor(x_scales, dtype=torch.float32).to(device)
    xs = xs.reshape(n_layers)
    dims = [weights[0].shape[0]] + [w.shape[1] for w in weights]
    kp = padded_widths(dims)
    wts, ss, bs = [], [], []
    for i, (w, ws, b) in enumerate(zip(weights, w_scales, biases)):
        if w.dtype != torch.int8 or w.shape[0] != dims[i]:
            raise ValueError(f"layer {i}: want int8 ({dims[i]}, N), got "
                             f"{w.dtype} {tuple(w.shape)}")
        wt = torch.zeros((dims[i + 1], kp[i]), dtype=torch.int8,
                         device=device)
        wt[:, :dims[i]] = w.t()
        wts.append(wt.reshape(-1))
        ss.append(ws.to(torch.float32) * xs[i])
        bs.append(b.to(torch.float32))
    return FusedGroup(dims=tuple(dims), wt=torch.cat(wts), s=torch.cat(ss),
                      b=torch.cat(bs), xs=xs, relu=act == "relu",
                      act_last=act_last)


def _quantize(h: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # Division by a 0-d tensor is a true IEEE division on every device;
    # torch.round rounds half to even like jnp.round.
    return torch.clamp(torch.round(h / scale), -127, 127)


def fused_mlp_q8_plain(x: torch.Tensor, g: FusedGroup) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``(M, K0)`` f32 in, ``(M,
    N_L)`` f32 out.  The int8 dot is taken in float64, exact for int8
    operands (|acc| < 2**53), and rounded to f32 as the kernel converts its
    int32 accumulator."""
    h = x.to(torch.float32)
    last = g.n_layers - 1
    for i, (wt_i, s_i, b_i) in enumerate(g.layer_views()):
        hq = _quantize(h, g.xs[i])
        acc = (hq.double() @ wt_i[:, :g.dims[i]].t().double()).float()
        h = acc * s_i + b_i
        if g.relu and (i != last or g.act_last):
            h = torch.clamp_min(h, 0.0)
    return h


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("fused_mlp_q8")
    vp = ctypes.c_void_p
    lib.repro_fused_mlp_q8.argtypes = [
        vp, vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, vp]
    lib.repro_fused_mlp_q8.restype = ctypes.c_int
    lib.repro_fused_rows.argtypes = []
    lib.repro_fused_rows.restype = ctypes.c_int
    lib.repro_empty_launch.argtypes = [vp]
    lib.repro_empty_launch.restype = ctypes.c_int
    if lib.repro_fused_rows() != ROWS:
        raise RuntimeError("csrc/fused_mlp_q8.cu and fused_mlp.py disagree "
                           "on the row tile")
    return lib


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def fused_mlp_q8_contract(x: torch.Tensor, dims):
    """The kernel's argument checks on the input and the group's widths
    ``dims`` (input first) alone (meta tensors do): returns the output's
    ``(shape, dtype)`` or raises ``ValueError``."""
    if not 1 <= len(dims) - 1 <= MAX_LAYERS:
        raise ValueError(f"fused_mlp_q8: a fused group holds 1..{MAX_LAYERS} "
                         f"layers, got {len(dims) - 1}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != dims[0]:
        raise ValueError(f"fused_mlp_q8: want f32 (M, {dims[0]}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    return (x.shape[0], dims[-1]), torch.float32


def fused_mlp_q8_cuda(x: torch.Tensor, g: FusedGroup) -> torch.Tensor:
    """Launch ``csrc/fused_mlp_q8.cu`` on ``x``'s device and stream."""
    global launches
    shape, dtype = fused_mlp_q8_contract(x, g.dims)
    tensors = (x, g.wt, g.s, g.b, g.xs)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("fused_mlp_q8_cuda: every tensor must lie on one "
                         "CUDA device")
    if not x.is_contiguous():
        raise ValueError("fused_mlp_q8_cuda: x must be contiguous")
    m = x.shape[0]
    out = torch.empty(shape, dtype=dtype, device=x.device)
    if m == 0:
        return out
    dims = (ctypes.c_int * len(g.dims))(*g.dims)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().repro_fused_mlp_q8(
        x.data_ptr(), g.wt.data_ptr(), g.s.data_ptr(), g.b.data_ptr(),
        g.xs.data_ptr(), out.data_ptr(), m, g.n_layers, dims,
        buffer_stride(g.dims), int(g.relu), int(g.act_last), stream)
    _check(err, "fused_mlp_q8")
    launches += 1
    return out


def empty_launch(device) -> None:
    """Launch an empty kernel: the floor under any launch on this card."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _check(_lib().repro_empty_launch(stream), "empty kernel")
