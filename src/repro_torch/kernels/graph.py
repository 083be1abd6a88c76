"""The served steps as CUDA graphs: the port's counterpart of ``jax.jit``.

A :class:`StepGraph` runs a step that takes no arguments: it reads its
inputs from tensors the caller refills in place (static inputs), may write
tensors it owns in place (a decode state), and returns its outputs (a
tensor or a tuple of tensors).  Its first call runs the step eagerly on a
side stream, which also sets up what PyTorch and the kernels initialise
lazily (libraries, module loads, shared-memory opt-ins), and then captures
the step into one ``torch.cuda.CUDAGraph``.  Every later call replays the
graph and returns the same output tensors, refilled: one host call in place
of one Python launch per kernel.  A capture or replay that fails raises;
nothing falls back to the eager step.

:func:`graph_nodes` reads a captured graph's nodes through ``libcuda``:
their types, and the kernel nodes by function name.  It is the port's
counterpart of the JAX package's ``hlo_text()``: what the replayed step
really runs.

The kernel wrappers count their launches in Python, which a replay never
reaches.  So a graph's launches per replay are read off its own kernel
nodes (:data:`KERNEL_FUNCTIONS`), and each replay adds them to the
counters, which keep meaning "kernels run".  The wrappers also count the
launches they issue into a capture, which runs nothing: the capture puts
the counters back.  The kernels' work records (FLOPs and bytes,
:func:`ops.work_counts`) follow them: the capture keeps what the wrappers
recorded into it as the graph's ``work`` and puts the records back, and
each replay adds ``work``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import gc

import torch

from repro_torch.kernels import ops

# CUgraphNodeType (cuda.h).
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
               5: "empty", 6: "wait_event", 7: "event_record",
               8: "semaphore_signal", 9: "semaphore_wait", 10: "mem_alloc",
               11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h), with room to spare."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p),
                ("_spare", ctypes.c_byte * 64)]


@functools.cache
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    vp, sp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    lib.cuGraphGetNodes.argtypes = [vp, ctypes.POINTER(vp), sp]
    lib.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphKernelNodeGetParams_v2.argtypes = [
        vp, ctypes.POINTER(_KernelNodeParams)]
    for fn in ("cuFuncGetName", "cuKernelGetName"):
        getattr(lib, fn).argtypes = [ctypes.POINTER(ctypes.c_char_p), vp]
    for fn in ("cuGraphGetNodes", "cuGraphNodeGetType",
               "cuGraphKernelNodeGetParams_v2", "cuFuncGetName",
               "cuKernelGetName"):
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUresult {err}")


def _kernel_name(lib, node) -> str:
    params = _KernelNodeParams()
    _check(lib.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
           "cuGraphKernelNodeGetParams")
    name = ctypes.c_char_p()
    if params.func:
        _check(lib.cuFuncGetName(ctypes.byref(name), params.func),
               "cuFuncGetName")
    else:
        _check(lib.cuKernelGetName(ctypes.byref(name), params.kern),
               "cuKernelGetName")
    return name.value.decode()


def graph_nodes(graph: torch.cuda.CUDAGraph) -> dict:
    """The nodes of a graph captured with ``keep_graph=True``:
    ``{"types": {type: count}, "kernels": {function name: count}}``."""
    lib = _libcuda()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
    types: collections.Counter = collections.Counter()
    kernels: collections.Counter = collections.Counter()
    for node in nodes[:n.value]:
        kind = ctypes.c_int()
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
               "cuGraphNodeGetType")
        types[_NODE_TYPES.get(kind.value, str(kind.value))] += 1
        if kind.value == 0:
            kernels[_kernel_name(lib, node)] += 1
    return {"types": dict(types), "kernels": dict(kernels)}


# Each counted kernel's CUDA functions, one of which every wrapper call
# launches (``chunk_aggregate_kernel`` runs before ``chunk_scan_kernel``
# and is not counted).  A kernel node's function name is mangled, so a
# name matches as the mangled identifier ``<length><name>``.
KERNEL_FUNCTIONS = {
    "fused_mlp_q8": ("fused_mlp_q8_kernel",),
    "gemm_int8": ("gemm_int8_kernel",),
    "flash_attention": ("flash_kernel", "flash_tc_kernel"),
    "linear_scan": ("linear_scan_kernel", "chunk_scan_kernel"),
    "rwkv6_scan": ("rwkv6_kernel", "rwkv6_chunk_kernel"),
    "tiled_gemm": ("tiled_gemm_f32_kernel", "tc_gemm_kernel"),
    "fused_dense": ("fused_dense_kernel",),
    # One node of its two per call, so that a node counts a call.
    "flash_attention_bwd": ("flash_bwd_dkdv_kernel",
                            "flash_bwd_wg_dkdv_kernel"),
    # One node of its three per call (``rwkv6_bwd_carry_kernel``, absent
    # when T fits one chunk, and ``du_sum_kernel`` are the others).
    "rwkv6_scan_bwd": ("rwkv6_bwd_chunk_kernel",),
}


def kernel_launches(kernels: dict) -> dict[str, int]:
    """The counted launches in ``{function name: nodes}`` (the
    ``"kernels"`` of :func:`graph_nodes`), by counter name."""
    out = dict.fromkeys(KERNEL_FUNCTIONS, 0)
    for fn, n in kernels.items():
        for name, funcs in KERNEL_FUNCTIONS.items():
            if any(fn == f or f"{len(f)}{f}" in fn for f in funcs):
                out[name] += n
    return out


def _tensors(out):
    return out if isinstance(out, tuple) else (out,)


class StepGraph:
    """``step`` (no arguments, static inputs) on ``device``, captured at its
    first call and replayed after (see the module doc).

    ``launches`` is the kernel launches one replay makes, ``work`` the
    work records one replay adds to the kernels it launches
    (:func:`ops.work_counts`), ``nodes`` what :func:`graph_nodes` read
    from the captured graph; all are None until the capture."""

    def __init__(self, step, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self.step = step
        self.device = device
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] | None = None
        self.work: dict[str, dict[str, float]] | None = None
        self.nodes: dict | None = None
        self.replays = 0
        self._out = None

    def __call__(self):
        if self.graph is None:
            return self._capture()
        self.graph.replay()
        ops.add_launches(self.launches)
        ops.add_work(self.work)
        self.replays += 1
        return self._out

    def _capture(self):
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.step()
        current.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(current)
        before, work_before = ops.launch_counts(), ops.work_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # An unreachable graph, event or pinned buffer that the cyclic
        # collector frees during the capture would call into CUDA from
        # inside it and invalidate it: collect first, and not during.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._out = self.step()
        finally:
            if collecting:
                gc.enable()
        ops.set_launches(before)
        # Only the kernels the step launches: a replay adds each entry.
        self.work = {k: w for k, w in ops.work_since(work_before).items()
                     if w["flops"] or w["bytes"]}
        ops.set_work(work_before)
        self.nodes = graph_nodes(graph)
        self.launches = kernel_launches(self.nodes["kernels"])
        graph.instantiate()
        self.graph = graph
        return out


def finite_guard(y: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor that is finite exactly when every element of ``y`` is:
    its largest magnitude, which a NaN or an infinity makes non-finite.
    One reduction, where ``isfinite(y).all()`` launches five kernels."""
    return torch.linalg.vector_norm(y.float(), float("inf"))


class GraphedForward:
    """``fn`` of one ``shape``/``dtype`` input as a :class:`StepGraph`, called
    as a served forward is: ``x`` is copied into the graph's static input,
    the graph replays, and the output comes back cloned out of the graph's
    memory with its :func:`finite_guard` as a float.  The graph itself
    copies the guard into pinned host memory, so one stream synchronize is
    the call's one wait for the card."""

    def __init__(self, fn, shape, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        self.static = torch.empty(tuple(shape), dtype=dtype, device=device)
        self._guard = torch.empty((), dtype=torch.float32, pin_memory=True)
        self._guard_np = self._guard.numpy()

        def step():
            y = fn(self.static)
            self._guard.copy_(finite_guard(y), non_blocking=True)
            return y
        self.graph = StepGraph(step, device)

    def __call__(self, x: torch.Tensor) -> tuple[torch.Tensor, float]:
        self.static.copy_(x)
        y = self.graph().clone()
        # infer's contract is a ready tensor: this is the call's one wait.
        torch.cuda.current_stream(self.static.device).synchronize()  # repro: check-ok(lint.host-sync)
        return y, float(self._guard_np)
