"""Serving engines: the edge-net executor and LM continuous batching.

Port of the JAX package's ``serve/engine.py``, two surfaces:

* **Edge serving** (:class:`EdgeEngine`) executes an h100
  :class:`DeploymentPlan` for an edge net.  The engine owns the quantized
  weights and the planned forward, built once at construction (groups,
  tiles, packed weights and scales fixed), and times every request.  Its
  degradation ladder has two rungs: level 0 runs the plan's fused groups
  (``fused_mlp_q8``), level 1 the per-layer path (``gemm_int8``,
  ``fused=False``).  Both give the same answers to 1e-5, so degrading never
  changes a result.
* **LM serving** (:func:`build_serve_steps`, :class:`ContinuousBatcher`):
  prefill (whole-prompt, or chunked as the plan's ``serve`` section says)
  and decode steps of any ported LM family (the transformer, the
  encoder-decoder, Griffin, RWKV-6), and a fixed-slot continuous batcher that advances
  every slot at its own position in one batched decode step, under the
  plan's :class:`BatchPolicy`.
* **int8 LM weights** (:func:`quantize_params`): per-output-channel
  symmetric int8 for the large weight leaves, as ``{"q8", "scale"}``
  marker dicts the models expand a layer at a time
  (:func:`repro_torch.runtime.maybe_dequant`).

On the card both served steps run as CUDA graphs
(:class:`~repro_torch.kernels.graph.StepGraph`), where the reference
``jax.jit``s them: the edge forward of each rung, captured once per input
shape, and the batcher's decode tick, captured once per batcher.  A graph
reads its inputs from static tensors that each call refills, so a request
or a tick costs one replay and one read-back.  ``graphs=False`` runs the
same steps eagerly, one Python launch per kernel; the CPU always does.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import queue
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.faults import InjectedFault, NonFiniteOutput
from repro_torch.kernels.graph import GraphedForward, StepGraph, finite_guard
from repro_torch.models import api
from repro_torch.models import edge as edge_lib
from repro_torch.models import tree
from repro_torch.models.config import ModelConfig
from repro_torch.obs import NULL_TRACER, summarize


def _use_graphs(graphs: bool | None, device: torch.device) -> bool:
    """CUDA graphs on the card unless the caller turns them off; the CPU
    runs eagerly, and asking it for graphs raises."""
    if graphs is None:
        return device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
    return bool(graphs)


def _rung_label(level: int, shape) -> str:
    """``"<rung> <shape>"``: how an edge engine's reports name a forward."""
    return f"{'fused' if level == 0 else 'per_layer'} {list(shape)}"


class EdgeEngine:
    """Serve one edge net on ``device`` (``None``: the GPU, raising when
    there is none).

    Weights: ``qparams`` as given (layers without a calibrated
    ``x_scale`` use the ``x_scale`` argument); else ``params`` (float) are
    quantized with activation scales calibrated on ``calib_x`` (default: a
    seeded normal batch); else params are drawn from ``seed``.

    ``graphs``: ``None`` replays each rung's forward as a CUDA graph on the
    card and runs it eagerly on the CPU; ``False`` runs it eagerly on the
    card too.  A graph is captured per rung and input shape, on the request
    that first brings them (one eager run and the capture), and holds its
    own static buffers and memory pool; the engine keeps the
    :attr:`MAX_GRAPHS` it used last and frees the others, so a tenant of
    ragged batch sizes pays a capture per new size but never accumulates
    card memory.
    """

    MAX_GRAPHS = 8

    def __init__(self, cfg, params=None, *, plan=None, x_scale: float = 0.05,
                 seed: int = 0, qparams=None, calib_x=None, tracer=None,
                 device=None, graphs: bool | None = None):
        self.device = resolve_device(device)
        self.graphs = _use_graphs(graphs, self.device)
        self.cfg = cfg
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.trace_label = cfg.name
        self.plan = plan if plan is not None else edge_lib.deployment_plan(
            cfg, device=self.device)
        if qparams is None:
            if params is None:
                gen = torch.Generator().manual_seed(seed)
                params = edge_lib.init_edge(cfg, generator=gen,
                                            device=self.device)
            if calib_x is None:
                gen = torch.Generator().manual_seed(seed + 7)
                calib_x = torch.randn((cfg.batch, cfg.dims[0]),
                                      generator=gen, dtype=torch.float32)
            params = [{k: v.to(self.device) for k, v in p.items()}
                      for p in params]
            qparams = edge_lib.quantize_edge(
                params, calib_x=torch.as_tensor(calib_x).to(self.device),
                act=cfg.act)
        self.qparams = [{k: v.to(self.device) if torch.is_tensor(v) else v
                         for k, v in q.items()} for q in qparams]
        self.x_scale = x_scale
        self._fwd = edge_lib.build_forward_q8(self.qparams, cfg,
                                              x_scale=x_scale, plan=self.plan)
        self.degrade_level = 0
        self._fwd_fallback = None
        # (rung, input shape) -> the captured forward, oldest use first
        self._graphs: collections.OrderedDict[tuple, GraphedForward] = \
            collections.OrderedDict()
        # Fault hooks (repro_torch.faults): ``injector`` is armed by
        # Router.arm_faults; ``faults`` counts failed calls (injected, or a
        # real non-finite output).
        self.injector = None
        self.faults = 0
        self.reset_measurements()

    def _fallback(self):
        """The per-layer (``fused=False``) forward, built on first use."""
        if self._fwd_fallback is None:
            self._fwd_fallback = edge_lib.build_forward_q8(
                self.qparams, self.cfg, x_scale=self.x_scale, plan=self.plan,
                fused=False)
        return self._fwd_fallback

    def degrade(self) -> bool:
        """Step down to the per-layer rung; True if a demotion happened."""
        if self.degrade_level == 0:
            self.degrade_level = 1
            return True
        return False

    def restore(self) -> bool:
        """Re-promote to the fused rung; True on change."""
        if self.degrade_level > 0:
            self.degrade_level = 0
            return True
        return False

    def graph_report(self) -> dict:
        """What each captured forward the engine holds runs: per ``"<rung>
        <shape>"`` the launches one replay makes and the kernels' work it
        records, the graph's nodes (types, and kernels by function name) and
        the replays so far.  The counterpart of the reference's
        ``hlo_text()``."""
        return {_rung_label(level, shape): {
                    "launches": f.graph.launches, "work": f.graph.work,
                    "nodes": f.graph.nodes, "replays": f.graph.replays}
                for (level, shape), f in self._graphs.items()}

    def eager_steps(self) -> dict:
        """One eager run of each forward the engine serves, by the labels of
        :meth:`graph_report`: the current rung at the plan's batch first,
        then each captured (rung, shape); each a no-argument callable on
        zeros of its shape.  What ``launch.graph_analysis`` counts."""
        keys = [(self.degrade_level, (self.plan.batch, self.cfg.dims[0]))]
        keys += [k for k in self._graphs if k != keys[0]]
        steps = {}
        for level, shape in keys:
            fwd = self._fwd if level == 0 else self._fallback()
            x = torch.zeros(shape, dtype=torch.float32, device=self.device)
            steps[_rung_label(level, shape)] = functools.partial(fwd, x)
        return steps

    def infer(self, x) -> torch.Tensor:
        """One request: ``(batch, dims[0])`` in, a ready ``(batch,
        dims[-1])`` f32 tensor on the engine's device out."""
        t0 = time.perf_counter()
        spec = None
        if self.injector is not None:
            spec = self.injector.fire("engine.infer", tenant=self.trace_label)
        if spec is not None:
            if spec.kind == "engine_exception":
                self.faults += 1
                raise InjectedFault(
                    f"injected engine fault on {self.trace_label}")
            if spec.kind == "latency_spike" and spec.magnitude_s > 0:
                time.sleep(spec.magnitude_s)   # inside [t0, t1]: visible
        x = torch.as_tensor(x, dtype=torch.float32)
        fwd = self._fwd if self.degrade_level == 0 else self._fallback()
        if self.graphs:
            # The rung's forward at this shape, captured at its first call.
            key = (self.degrade_level, tuple(x.shape))
            if key in self._graphs:
                self._graphs.move_to_end(key)
            else:
                if len(self._graphs) == self.MAX_GRAPHS:
                    self._graphs.popitem(last=False)
                self._graphs[key] = GraphedForward(fwd, x.shape, self.device)
            y, guard = self._graphs[key](x)
        else:
            y = fwd(x.to(self.device))
            guard = finite_guard(y)
        if spec is not None and spec.kind == "non_finite_output":
            # Poison this call's own output (on the card, the clone of the
            # graph's), never a graph's static buffer; the guard, taken
            # before, is taken again from the poisoned tensor.
            y = torch.full_like(y, float("nan"))
            guard = finite_guard(y)
        # The finiteness guard reads one value back to the host, which also
        # waits for the forward: infer returns a ready result by contract.
        if not math.isfinite(float(guard)):
            t1 = time.perf_counter()
            self.faults += 1
            if self.tracer.enabled:
                self.tracer.add("fault/non_finite", t0, t1,
                                tenant=self.trace_label)
            raise NonFiniteOutput(f"{self.trace_label}: non-finite output")
        t1 = time.perf_counter()
        self.calls += 1
        self.total_s += t1 - t0
        self._latencies.append(t1 - t0)
        if self.tracer.enabled:
            self.tracer.add("infer", t0, t1, trace=self.calls,
                            tenant=self.trace_label)
        return y

    def span_stats(self) -> dict:
        """The edge path's one span kind, ``infer``, over the window."""
        if not self._latencies:
            return {}
        agg = summarize(self._latencies)
        agg["total_count"] = self.calls
        return {"infer": agg}

    @property
    def measured_mean_s(self) -> float:
        return self.total_s / self.calls if self.calls else 0.0

    @property
    def measured_p50_s(self) -> float:
        """Median over the recent-call window."""
        if not self._latencies:
            return 0.0
        xs = sorted(self._latencies)
        return xs[len(xs) // 2]

    def reset_measurements(self):
        """Drop accumulated timings (e.g. after warmup)."""
        self.calls, self.total_s = 0, 0.0
        self._latencies = collections.deque(maxlen=256)

    def record_calibration(self, cache=None):
        """Write the measured mean latency back into the plan cache
        (:func:`repro_torch.plan.calibrate.feedback`) and adopt the
        calibrated plan; tiles and groups stay, only the costs move."""
        from repro_torch.plan import calibrate
        if not self.calls:
            raise RuntimeError("no measurements recorded yet")
        self.plan = calibrate.feedback(self.plan, self.measured_mean_s,
                                       cache=cache)
        return self.plan


# ---------------------------------------------------------------------------
# int8 LM weights
# ---------------------------------------------------------------------------

_QUANT_MIN_SIZE = 1 << 16      # only quantize big matmul weights

# Embeddings are gathered directly; norm scales and biases stay exact.
_QUANT_EXCLUDE = ("emb", "unemb", "pos_emb", "scale", "bias",
                  "ln0", "ln1", "ln2", "ln_x", "post_ln1", "post_ln2",
                  "final_norm", "gn", "q_norm", "kv_norm", "norm_h", "norm_e",
                  "enc_final", "dec_final")


# The subtrees whose leaves carry a leading layer axis.
_STACKED = ("blocks", "dense_blocks", "enc_blocks", "dec_blocks")


def _quantize_leaf(w: torch.Tensor) -> dict:
    """One >=2-D float leaf as ``{"q8", "scale"}``: ``scale = max|w| / 127
    + 1e-12`` over axis -2 (one scale per output channel), ``q8 =
    clip(round(w / scale), -127, 127)``, in f32 and rounded half to even,
    as the reference computes it.  A leaf of more than two axes (a stacked
    layer axis) is quantized slice by slice along its first axis (the
    reduction is over axis -2, so the result is the same), so the f32 copy
    is one layer's, not the leaf's."""
    if w.dim() > 2:
        q8 = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty(w.shape[:-2] + (1, w.shape[-1]),
                            dtype=torch.float32, device=w.device)
        for i in range(w.shape[0]):
            part = _quantize_leaf(w[i])
            q8[i].copy_(part["q8"])
            scale[i].copy_(part["scale"])
        return {"q8": q8, "scale": scale}
    w = w.float()
    # A divisor on the device, not a Python scalar: CUDA divides by a host
    # scalar as a multiply by its reciprocal, which is not always the
    # quotient the reference rounds.
    div = torch.full((), 127.0, dtype=torch.float32, device=w.device)
    scale = torch.div(w.abs().amax(dim=-2, keepdim=True), div) + 1e-12
    q8 = torch.clamp(torch.round(torch.div(w, scale)), -127, 127)
    return {"q8": q8.to(torch.int8), "scale": scale}


def quantize_params(params, *, min_size: int = _QUANT_MIN_SIZE):
    """Per-output-channel symmetric int8 for the >=2-D float weight leaves
    of at least ``min_size`` elements, outside :data:`_QUANT_EXCLUDE`.
    Each becomes a ``{"q8", "scale"}`` marker dict that
    :func:`repro_torch.runtime.maybe_dequant` expands at the top of each
    layer, so at rest the card holds int8.  The q8 and scale equal the
    reference's bit for bit on the same f32 leaf.

    A leaf under ``blocks``, ``dense_blocks``, ``enc_blocks`` or
    ``dec_blocks`` is stacked on a leading layer axis, so its rank is
    counted without that axis: a stacked vector
    (a bias, a gate's decay, a router's selection bias) stays as it is.
    The reference quantizes it over the layer axis, into a scale that no
    longer stacks, and its own layer scan then refuses the tree whenever
    there is more than one layer."""

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, keys + (str(i),))
                              for i, v in enumerate(node))
        if any(k in _QUANT_EXCLUDE for k in keys) \
                or not isinstance(node, torch.Tensor):
            return node
        rank = node.dim() - any(k in _STACKED for k in keys)
        if rank < 2 or node.numel() < min_size \
                or not node.is_floating_point():
            return node
        return _quantize_leaf(node)

    return walk(params, ())


def quantized_bytes(params) -> tuple[int, int]:
    """(bytes before, assuming bf16; bytes after) for reporting."""
    before = after = 0
    for leaf in tree.leaves(params):
        n = leaf.numel()
        before += 2 * n
        after += n if leaf.dtype == torch.int8 else 2 * n
    return before, after


def prepare_params(params, *, plan=None, quantize: bool = False):
    """Apply the plan's weight-format decision (int8 or not) to params.
    Nothing calls it on the serving path, as in the reference: its batcher
    never applies the plan's ``quantize_weights``."""
    if plan is not None:
        quantize = bool(plan.serve.get("quantize_weights", quantize))
    return quantize_params(params) if quantize else params


# ---------------------------------------------------------------------------
# LM serving: step builders and the continuous batcher
# ---------------------------------------------------------------------------

def build_serve_steps(cfg: ModelConfig, *, max_len: int | None = None,
                      plan=None):
    """Returns (prefill_fn, decode_fn) over a state from
    :func:`~repro_torch.models.api.init_decode_state` (``max_len`` is the
    state's; the steps read it from the state itself).

    prefill_fn(params, tokens, state, extras=None)      -> (logits_last, state)
    decode_fn(params, tokens, state, pos, extras=None)  -> (logits, state)

    ``extras`` are the family's extra inputs (the transformer's
    ``mrope_positions`` and ``embeddings``), passed to every step as the
    reference passes them.  An encoder-decoder's state carries the cross
    K/V (``encdec.whisper_init_cache``; zeros from ``init_decode_state``),
    which every step reads.  Prefill takes the whole prompt in one step from
    position 0, or, when ``plan.serve["prefill_chunk"]`` is set and the
    prompt is longer, one multi-token step per chunk at its offset.  A
    transformer or Griffin chunk runs the ``flash_attention`` kernel with
    its queries at that offset, against the cache's earlier keys (on a ring
    cache too, where the reference attends over the chunk alone); an RWKV-6
    chunk continues from the carried state.
    """
    chunk = None if plan is None else plan.serve.get("prefill_chunk")

    def prefill_fn(params, tokens, state, extras=None):
        s = tokens.shape[1]
        if chunk is None or s <= chunk:
            logits, state = api.decode_step(params, cfg, tokens, state, 0,
                                            extras=extras)
            return logits[:, -1:], state
        for off in range(0, s, chunk):
            logits, state = api.decode_step(
                params, cfg, tokens[:, off:off + chunk], state, off,
                extras=extras)
        return logits[:, -1:], state

    def decode_fn(params, tokens, state, pos, extras=None):
        return api.decode_step(params, cfg, tokens, state, pos,
                               extras=extras)

    return prefill_fn, decode_fn


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    filled: int = 0                  # prompt tokens prefilled so far
    # Trace bookkeeping (perf_counter clock); ``rid`` is the trace id of
    # every span the request produces.
    t_submit: float | None = None    # stamped by ContinuousBatcher.submit
    t_admit: float | None = None     # stamped when a slot is assigned
    t_done: float | None = None      # stamped when the request completes
    # Set (e.g. "non_finite_output") when the request FAILED: done with
    # error set means the slot was freed and ``out`` must not be trusted.
    error: str | None = None


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Continuous-batching policy, read from a plan's ``serve`` section
    (:meth:`from_plan`).  ``None`` keeps the permissive default."""
    slots: int = 4
    prefill_chunk: int | None = None   # prompt tokens prefilled per tick
    admit_per_tick: int | None = None  # admissions per tick at most
    max_new_cap: int | None = None     # eviction: cap on generated tokens

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        for name in ("prefill_chunk", "admit_per_tick", "max_new_cap"):
            v = getattr(self, name)
            # A zero chunk would stall prefill forever.
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1 or None, got {v}")

    @classmethod
    def from_plan(cls, plan, **overrides) -> "BatchPolicy":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(overrides) - fields
        if unknown:
            raise TypeError(
                f"unknown BatchPolicy override(s): {sorted(unknown)} "
                f"(valid: {sorted(fields)})")
        serve = dict(getattr(plan, "serve", None) or {})
        slots = serve.get("slots")
        kw = {
            # `is None`, not truthiness: a 0 in a plan must reach the
            # validation, not become the default.
            "slots": cls.slots if slots is None else slots,
            "prefill_chunk": serve.get("prefill_chunk"),
            "admit_per_tick": serve.get("admit_per_tick"),
            "max_new_cap": serve.get("max_new_cap"),
        }
        kw.update(overrides)
        return cls(**kw)


def _batch_axes(cfg: ModelConfig, max_len: int):
    """The batch axis of every state leaf (1 where the leaf is stacked on a
    leading layer axis, as whisper's self and cross K/V are, 0 in Griffin's
    unstacked ``tail``), found by diffing the specs at two batch sizes."""
    def axis(a, b):
        for ax, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return ax
        return 0
    return tree.tree_map(axis, api.decode_state_specs(cfg, 1, max_len),
                         api.decode_state_specs(cfg, 2, max_len))


class ContinuousBatcher:
    """Fixed-slot continuous batching over one batched decode step.

    Slots hold independent sequences, each at its own position; finished
    slots admit queued requests (greedy sampling).  Admission, eviction and
    the prefill chunk come from a :class:`BatchPolicy`: ``policy=``, or the
    ``serve`` section of ``plan=`` (``slots=`` outranks either).  Prompts
    are prefilled token by token through the decode step, at most
    ``prefill_chunk`` tokens a tick (the whole prompt when it is None).
    Every tick runs ONE decode step over all slots with a per-slot position
    tensor; a ``live`` mask keeps the state of idle slots byte-identical
    (``torch.where(live, new, old)``).  Runs on ``device`` (``None``: the
    device the parameters lie on; otherwise they are moved there).  An
    encoder-decoder's slots start, and start again, from zero cross K/V,
    as the reference's batcher does: it admits no encoder frames.

    The step reads its tokens, positions and ``live`` mask from one static
    ``(3, slots)`` tensor, refilled by one copy a step, and writes the new
    state into the state tensors in place, which are never rebound.  So on
    the card it runs as a CUDA graph captured at the first step (``graphs=
    None``); ``graphs=False`` runs it eagerly, as the CPU always does.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int | None = None,
                 max_len: int = 256, plan=None,
                 policy: BatchPolicy | None = None, tracer=None,
                 device=None, graphs: bool | None = None):
        if device is not None:
            device = resolve_device(device)
            params = tree.tree_map(lambda t: t.to(device), params)
        self.cfg, self.params = cfg, params
        if policy is None:
            policy = (BatchPolicy.from_plan(plan) if plan is not None
                      else BatchPolicy())
        if slots is not None:           # explicit arg outranks the plan
            policy = dataclasses.replace(policy, slots=slots)
        self.policy = policy
        self.plan = plan
        self.slots, self.max_len = policy.slots, max_len
        self.device = params["emb"].device
        # Per-kind service-time windows are always kept (decode-step p50
        # exists with tracing off); the tracer also gets per-request spans.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.trace_label = cfg.name
        self._windows: dict[str, collections.deque] = {}
        self._span_totals: dict[str, int] = {}
        self.state = api.init_decode_state(cfg, self.slots, max_len,
                                           device=self.device)
        self._axes = _batch_axes(cfg, max_len)
        # The step's static inputs: rows tokens, positions, live (0/1).
        self._inputs = torch.zeros((3, self.slots), dtype=torch.long,
                                   device=self.device)
        self._graph = (StepGraph(self._step, self.device)
                       if _use_graphs(graphs, self.device) else None)
        self.pos = np.zeros((self.slots,), np.int32)
        self.active: list[Request | None] = [None] * self.slots
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._steps = 0
        # Fault hooks, as the edge engine's: ``faults`` counts failed
        # requests and ticks.
        self.injector = None
        self.faults = 0

    def submit(self, req: Request):
        req.t_submit = time.perf_counter()
        self.queue.put(req)

    # -- span recording ----------------------------------------------------
    def _record(self, kind: str, t0: float, t1: float, *, trace=None,
                emit: bool = True, **attrs):
        """One observed interval: window (always) + tracer (when enabled).
        ``emit=False`` skips the tracer where the caller emits per-request
        spans for the same interval."""
        win = self._windows.get(kind)
        if win is None:
            win = self._windows[kind] = collections.deque(maxlen=512)
            self._span_totals[kind] = 0
        win.append(t1 - t0)
        self._span_totals[kind] += 1
        if emit and self.tracer.enabled:
            self.tracer.add(kind, t0, t1, trace=trace,
                            tenant=self.trace_label, **attrs)

    def span_stats(self) -> dict:
        """Windowed per-kind service-time aggregates (count/mean/p50/p95
        over the recent window, plus the lifetime observation count)."""
        out = {}
        for kind, win in self._windows.items():
            agg = summarize(win)
            agg["total_count"] = self._span_totals[kind]
            out[kind] = agg
        return out

    @property
    def measured_decode_p50_s(self) -> float:
        """Median decode-step service time over the recent window: queue
        wait and prefill excluded, so it compares with the LM plan's
        ``est_latency_s`` (an LM plan models one decode step).  The router's
        drift watcher reads it."""
        win = self._windows.get("decode_step")
        return summarize(win)["p50_s"] if win else 0.0

    @property
    def decode_steps_observed(self) -> int:
        return self._span_totals.get("decode_step", 0)

    # -- the batched step --------------------------------------------------
    def _step(self) -> torch.Tensor:
        """The decode step over the static inputs, the state written in
        place; idle slots write their old state back.  Returns the logits
        (slots, 1, padded_vocab)."""
        tokens = self._inputs[0].unsqueeze(1)
        live = self._inputs[2].bool()
        # Each slot is its own sequence: an MoE layer routes it alone, with
        # its own capacity, as the reference steps each slot alone.
        logits, new_state = api.decode_step(self.params, self.cfg, tokens,
                                            self.state, self._inputs[1],
                                            rows_alone=True)

        def keep_idle(old, new, ax):
            mask = live.reshape((-1,) + (1,) * (old.dim() - ax - 1))
            old.copy_(torch.where(mask, new, old))

        tree.tree_map(keep_idle, self.state, new_state, self._axes)
        return logits

    def _decode_masked(self, tok: np.ndarray,
                       live: np.ndarray) -> torch.Tensor:
        """One decode step of every slot at its own position; the state of
        slots not ``live`` stays as it was.  Returns the logits (slots, 1,
        padded_vocab) on the device: on the card, the graph's own output,
        which the next step overwrites."""
        self._inputs.copy_(torch.from_numpy(
            np.stack([tok[:, 0], self.pos, live]).astype(np.int64)))
        return self._step() if self._graph is None else self._graph()

    def graph_report(self) -> dict | None:
        """The captured decode tick: the launches one replay makes and the
        kernels' work it records, the graph's nodes (types, and kernels by
        function name) and the replays so far; None when the tick runs
        eagerly or is not captured yet."""
        if self._graph is None or self._graph.graph is None:
            return None
        return {"launches": self._graph.launches, "work": self._graph.work,
                "nodes": self._graph.nodes, "replays": self._graph.replays}

    def eager_steps(self) -> dict:
        """One eager decode step over every slot with none live, so the
        state is written back as it was: ``{"decode_tick": callable}``, what
        ``launch.graph_analysis`` counts beside the captured tick."""
        def step():
            saved = self._inputs.clone()
            self._inputs[2].zero_()
            try:
                return self._step()
            finally:
                self._inputs.copy_(saved)
        return {"decode_tick": step}

    @staticmethod
    def _pick(logits: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        """Per slot: whether its last logits row is finite, and its argmax.
        Deliberate sync: sampled tokens and the finiteness guard must reach
        the host; only two (slots,) vectors cross."""
        last = logits[:, -1]
        finite = torch.isfinite(last).all(dim=-1).cpu().numpy()  # repro: check-ok(lint.host-sync)
        return finite, last.argmax(dim=-1).cpu().numpy()  # repro: check-ok(lint.host-sync)

    def _reset_slot(self, i: int):
        """Fresh state + position for a re-used slot (no stale cache or
        recurrent state); zeroed in place."""
        tree.tree_map(lambda v, ax: v.select(ax, i).zero_(), self.state,
                      self._axes)
        self.pos[i] = 0

    @property
    def n_active(self) -> int:
        """Occupied slots."""
        return sum(1 for r in self.active if r is not None)

    def _max_new(self, req: Request) -> int:
        """Eviction policy: the plan's cap bounds every request's budget."""
        cap = self.policy.max_new_cap
        return req.max_new if cap is None else min(req.max_new, cap)

    def _prefill_tick(self, i: int, req: Request):
        """Advance slot ``i``'s prefill by at most ``prefill_chunk`` tokens
        (the whole prompt when the policy sets no chunk), one token per
        decode step; emit the first generated token once the prompt is
        consumed."""
        chunk = self.policy.prefill_chunk
        limit = (len(req.prompt) if chunk is None
                 else min(len(req.prompt), req.filled + chunk))
        if req.filled >= limit:
            return
        t0 = time.perf_counter()
        first = req.filled
        tok = np.zeros((self.slots, 1), np.int32)
        live = np.zeros((self.slots,), bool)
        live[i] = True
        logits = None
        for t in req.prompt[req.filled:limit]:
            tok[i, 0] = t
            logits = self._decode_masked(tok, live)
            self.pos[i] += 1
        req.filled = limit
        if req.filled == len(req.prompt):
            finite, best = self._pick(logits)
            if not finite[i]:
                self._fail_request(i, req, "non_finite_output")
            else:
                req.out.append(int(best[i]))
        self._record("prefill_chunk", t0, time.perf_counter(), trace=req.rid,
                     tokens=limit - first, slot=i)

    def _admit(self, admit_cap: int | None = None) -> int:
        """Fill free slots from the queue, at most the policy's
        ``admit_per_tick``.  ``admit_cap`` tightens this tick's bound (the
        router's SLO deferral passes 0 to hold a lower-priority tenant's
        queue; live slots keep decoding either way)."""
        caps = [c for c in (self.policy.admit_per_tick, admit_cap)
                if c is not None]
        cap = min(caps) if caps else None
        if cap is not None and cap <= 0:
            return 0
        admitted = 0
        for i in range(self.slots):
            if self.active[i] is not None:
                continue
            if cap is not None and admitted >= cap:
                break
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                break
            now = time.perf_counter()
            req.t_admit = now
            if req.t_submit is not None:
                self._record("queue", req.t_submit, now, trace=req.rid)
            if len(req.prompt) == 0:     # nothing to prefill or decode
                req.done = True
                req.t_done = now
                self._finish(req)
                continue
            self._reset_slot(i)
            req.filled = 0
            self.active[i] = req
            admitted += 1
        return admitted

    def _finish(self, req: Request):
        """Close a completed (or failed) request's trace span."""
        if self.tracer.enabled and req.t_submit is not None:
            extra = {"error": req.error} if req.error else {}
            self.tracer.add("request", req.t_submit, req.t_done,
                            trace=req.rid, tenant=self.trace_label,
                            tokens_out=len(req.out), **extra)

    def _fail_request(self, i: int, req: Request, kind: str):
        """A poisoned output FAILS the request instead of emitting garbage:
        the slot is freed and the fault counted."""
        now = time.perf_counter()
        self.faults += 1
        req.error = kind
        req.done = True
        req.t_done = now
        self.active[i] = None
        if self.tracer.enabled:
            self.tracer.add("fault/non_finite", now, now, trace=req.rid,
                            tenant=self.trace_label, slot=i)
        self._finish(req)

    def step(self, *, admit_cap: int | None = None) -> int:
        """One tick: admit, advance chunked prefills, decode live slots.
        Returns #active.  ``admit_cap`` tightens this tick's admissions (0:
        defer the queue, keep decoding).  Admission is host work before the
        decode, so the tick's graph is the same either way.  An injected
        ``batcher_stall`` skips the tick (no admission, no decode, the state
        untouched)."""
        if self.injector is not None:
            spec = self.injector.fire("batcher.tick", tenant=self.trace_label)
            if spec is not None:
                if spec.kind == "batcher_stall":
                    if spec.magnitude_s > 0:
                        time.sleep(spec.magnitude_s)
                    return self.n_active
                if spec.kind == "engine_exception":
                    self.faults += 1
                    raise InjectedFault(
                        f"injected batcher fault on {self.trace_label}")
                if spec.kind == "latency_spike" and spec.magnitude_s > 0:
                    time.sleep(spec.magnitude_s)
        self._admit(admit_cap=admit_cap)
        for i, req in enumerate(self.active):
            if req is not None and req.filled < len(req.prompt):
                self._prefill_tick(i, req)
        if not any(self.active):
            return 0
        tok = np.zeros((self.slots, 1), np.int32)
        live = np.zeros((self.slots,), bool)
        for i, req in enumerate(self.active):
            if req is not None and req.out and req.filled >= len(req.prompt):
                tok[i, 0] = req.out[-1]
                live[i] = True
        if live.any():
            t0 = time.perf_counter()
            logits = self._decode_masked(tok, live)
            if self.injector is not None:
                spec = self.injector.fire("batcher.decode",
                                          tenant=self.trace_label)
                if spec is not None and spec.kind == "non_finite_output":
                    # A new tensor: on the card the logits are the graph's
                    # own buffer, which a poison must not touch.
                    logits = torch.full_like(logits, float("nan"))
            finite, best = self._pick(logits)
            self._steps += 1
            stepped = []                 # (slot, request) pairs that decoded
            done_reqs = []
            for i, req in enumerate(self.active):
                if req is None or not live[i]:
                    continue
                self.pos[i] += 1
                if not finite[i]:
                    self._fail_request(i, req, "non_finite_output")
                    continue
                stepped.append((i, req))
                req.out.append(int(best[i]))
                if len(req.out) >= self._max_new(req):
                    req.done = True      # completion or max_new_cap
                    done_reqs.append(req)
                    self.active[i] = None
            # _pick read the results back, so [t0, t1] is the whole
            # batched service interval.
            t1 = time.perf_counter()
            self._record("decode_step", t0, t1, batch=len(stepped),
                         emit=False)
            if self.tracer.enabled:
                for i, req in stepped:   # per-request view of the shared step
                    self.tracer.add("decode_step", t0, t1, trace=req.rid,
                                    tenant=self.trace_label, slot=i)
            for req in done_reqs:
                req.t_done = t1
                self._finish(req)
        return self.n_active

    def run_until_drained(self, max_ticks: int = 10_000):
        while (not self.queue.empty() or any(self.active)) \
                and self._steps < max_ticks:
            self.step()
