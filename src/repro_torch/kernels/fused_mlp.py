"""Fused-group int8 MLP: a whole DR7' fusion group in one launch.

Port of the JAX package's ``kernels/fused_mlp.py::fused_mlp_q8``.  Per layer
``i`` of a group of ``L``::

    h = act(clip(round(h / xs_i), -127, 127) @ w_i * (ws_i * xs_i) + b_i)

with the activation on every layer but the last unless ``act_last``.  The
CUDA kernel (``csrc/fused_mlp_q8.cu``) copies every layer's weights into
shared memory at entry and keeps the int8 activations there between layers;
:func:`fused_mlp_q8_plain` is the same function in plain PyTorch, used for
CPU tensors and as the kernel's oracle on the card.

A group is packed once (:func:`pack_group`) into the layout the kernel
reads (:func:`layer_layout`): one int8 ``pack`` holding, per layer, one
contiguous 16-byte-aligned block of the weights transposed to ``(np_i,
kp_i)`` rows of ``kp_i + SKEW`` bytes (``kp_i`` the input width padded to
``K_MULTIPLE``, ``np_i`` the output width padded to ``N_MULTIPLE``, all
padding zero, which is exact), then the folded scale row ``s_i = ws_i *
xs_i`` (f32, folded on the host as the reference does), then the bias row
(``np_i`` f32 each, zero past the true width).  The kernel copies each
block into shared memory with one bulk copy.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

ROWS = 8              # rows of M per CTA; csrc/fused_mlp_q8.cu's kRows
MAX_LAYERS = 16       # csrc/fused_mlp_q8.cu's kMaxLayers
K_MULTIPLE = 32       # the int8 mma's k: input widths pad to this
N_MULTIPLE = 16       # the int8 mma's m: output widths pad to this
SKEW = 16             # bytes added to each int8 row against bank conflicts
HEAD_BYTES = 36 * MAX_LAYERS   # per layer: mbarrier, input scale, record
MAX_SMEM = 232_448    # dynamic shared memory one block may use (H100)

launches = 0          # kernel launches since the last reset (plain int)
flops = 0.0           # their work record (``work``): FLOPs and bytes,
bytes_moved = 0.0     # added where ``launches`` is


def _ceil_to(x: int, q: int) -> int:
    return -(-x // q) * q


@dataclasses.dataclass(frozen=True)
class LayerBlock:
    """Where one layer lies in the pack (and in the kernel's shared
    memory): ``np`` weight rows of ``stride`` bytes at ``offset``, then
    ``np`` f32 scales, then ``np`` f32 biases; ``nbytes`` in all."""
    n: int            # true output width
    kp: int           # input width padded to K_MULTIPLE
    np: int           # output width padded to N_MULTIPLE
    stride: int       # weight row stride in bytes, kp + SKEW
    offset: int
    nbytes: int

    @property
    def scale_offset(self) -> int:
        return self.offset + self.np * self.stride

    @property
    def bias_offset(self) -> int:
        return self.scale_offset + 4 * self.np


def layer_layout(dims) -> list[LayerBlock]:
    """The pack's blocks for a group with layer widths ``dims`` (input
    first); ``csrc/fused_mlp_q8.cu``'s ``layout`` computes the same."""
    blocks, offset = [], 0
    for k, n in zip(dims[:-1], dims[1:]):
        kp, np_ = _ceil_to(k, K_MULTIPLE), _ceil_to(n, N_MULTIPLE)
        stride = kp + SKEW
        nbytes = np_ * (stride + 8)
        blocks.append(LayerBlock(n, kp, np_, stride, offset, nbytes))
        offset += nbytes
    return blocks


def buffer_stride(dims) -> int:
    """Row stride of each int8 activation buffer: the widest padded layer
    input plus the skew."""
    return max(_ceil_to(d, K_MULTIPLE) for d in dims[:-1]) + SKEW


def fused_smem_bytes(dims, rows: int = ROWS) -> int:
    """Shared memory the kernel holds for a group with layer widths
    ``dims`` (input first), and launches with: the head (per layer a
    barrier, an input scale and its block's record), two int8 activation
    buffers of ``rows`` rows, read by one layer while the next layer's input
    is written, and every layer's block of the pack.  The planner prices a
    fusion group with this same function, and the verify stage checks it."""
    return _smem_bytes(tuple(dims), rows)


@functools.lru_cache(maxsize=1024)
def _smem_bytes(dims: tuple, rows: int) -> int:
    return (HEAD_BYTES + 2 * rows * buffer_stride(dims)
            + sum(b.nbytes for b in layer_layout(dims)))


@dataclasses.dataclass(frozen=True)
class FusedGroup:
    """One fusion group, packed for the kernel (see the module doc)."""
    dims: tuple[int, ...]          # true widths, input first
    pack: torch.Tensor             # int8, the layers' blocks back to back
    xs: torch.Tensor               # f32 (L,), per-layer input scales
    relu: bool
    act_last: bool
    smem_bytes: int                # fused_smem_bytes(dims)
    c_dims: ctypes.Array = dataclasses.field(repr=False, compare=False)

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def layer_views(self):
        """Per layer ``(wt_i (np_i, kp_i), s_i (np_i,), b_i (np_i,))``
        views into the pack, padding included."""
        for blk in layer_layout(self.dims):
            w = self.pack[blk.offset:blk.scale_offset]
            wt = w.view(blk.np, blk.stride)[:, :blk.kp]
            s = self.pack[blk.scale_offset:blk.bias_offset].view(torch.float32)
            b = self.pack[blk.bias_offset:blk.offset + blk.nbytes] \
                .view(torch.float32)
            yield wt, s, b


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
    layout = layer_layout(dims)
    pack = torch.zeros(layout[-1].offset + layout[-1].nbytes,
                       dtype=torch.int8, device=device)
    for i, (w, ws, b, blk) in enumerate(zip(weights, w_scales, biases,
                                            layout)):
        if w.dtype != torch.int8 or w.shape[0] != dims[i]:
            raise ValueError(f"layer {i}: want int8 ({dims[i]}, N), got "
                             f"{w.dtype} {tuple(w.shape)}")
        rows = pack[blk.offset:blk.scale_offset].view(blk.np, blk.stride)
        rows[:blk.n, :dims[i]] = w.t()
        s = pack[blk.scale_offset:blk.bias_offset].view(torch.float32)
        s[:blk.n] = ws.to(torch.float32) * xs[i]
        pack[blk.bias_offset:blk.offset + blk.nbytes].view(
            torch.float32)[:blk.n] = b.to(torch.float32)
    return FusedGroup(dims=tuple(dims), pack=pack, xs=xs,
                      relu=act == "relu", act_last=act_last,
                      smem_bytes=fused_smem_bytes(dims),
                      c_dims=(ctypes.c_int * len(dims))(*dims))


def _quantize(h: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # Division by a 0-d tensor is a true IEEE division on every device;
    # torch.round rounds half to even like jnp.round.  NaN quantizes to 0
    # and +-inf to +-127, as the reference's clip-then-int8 cast gives.
    q = torch.clamp(torch.round(h / scale), -127, 127)
    return torch.where(torch.isnan(q), 0.0, q)


def fused_mlp_q8_plain(x: torch.Tensor, g: FusedGroup) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``(M, K0)`` f32 in, ``(M,
    N_L)`` f32 out.  The int8 dot is taken in float64, exact for int8
    operands (|acc| < 2**53), and rounded to f32 as the kernel converts its
    int32 accumulator."""
    h = x.to(torch.float32)
    last = g.n_layers - 1
    for i, (wt_i, s_i, b_i) in enumerate(g.layer_views()):
        k, n = g.dims[i], g.dims[i + 1]
        hq = _quantize(h, g.xs[i])
        acc = (hq.double() @ wt_i[:n, :k].t().double()).float()
        h = acc * s_i[:n] + b_i[:n]
        if g.relu and (i != last or g.act_last):
            h = torch.clamp_min(h, 0.0)
    return h


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("fused_mlp_q8")
    vp = ctypes.c_void_p
    lib.repro_fused_mlp_q8.argtypes = [
        vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
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


@functools.lru_cache(maxsize=256)
def work(m: int, dims: tuple[int, ...]) -> tuple[float, int]:
    """FLOPs and bytes of one launch of ``m`` rows through the group of
    widths ``dims``: ``2 m k n`` a layer; x read in f32, the int8 weights,
    each layer's f32 scales and biases and its input scale read once, the
    f32 output written once.  Memoised: every served launch asks again."""
    shapes = list(zip(dims[:-1], dims[1:]))
    macs = sum(k * n for k, n in shapes)
    nbytes = (4 * m * dims[0] + macs + sum(2 * 4 * n for n in dims[1:])
              + 4 * len(shapes) + 4 * m * dims[-1])
    return 2.0 * m * macs, nbytes


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
    smem = fused_smem_bytes(dims)
    if smem > MAX_SMEM:
        raise ValueError(f"fused_mlp_q8: the group holds {smem} B of shared "
                         f"memory, over one block's {MAX_SMEM} B")
    return (x.shape[0], dims[-1]), torch.float32


def fused_mlp_q8_cuda(x: torch.Tensor, g: FusedGroup) -> torch.Tensor:
    """Launch ``csrc/fused_mlp_q8.cu`` on ``x``'s device and stream."""
    global launches, flops, bytes_moved
    shape, dtype = fused_mlp_q8_contract(x, g.dims)
    tensors = (x, g.pack, g.xs)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("fused_mlp_q8_cuda: every tensor must lie on one "
                         "CUDA device")
    if not x.is_contiguous():
        raise ValueError("fused_mlp_q8_cuda: x must be contiguous")
    m = x.shape[0]
    out = torch.empty(shape, dtype=dtype, device=x.device)
    if m == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().repro_fused_mlp_q8(
        x.data_ptr(), g.pack.data_ptr(), g.xs.data_ptr(), out.data_ptr(), m,
        g.n_layers, g.c_dims, g.smem_bytes, int(g.relu), int(g.act_last),
        stream)
    _check(err, "fused_mlp_q8")
    launches += 1
    f, nb = work(m, g.dims)
    flops, bytes_moved = flops + f, bytes_moved + nb
    return out


def empty_launch(device) -> None:
    """Launch an empty kernel: the floor under any launch on this card."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _check(_lib().repro_empty_launch(stream), "empty kernel")
