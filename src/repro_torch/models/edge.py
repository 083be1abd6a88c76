"""The paper's extreme-edge workloads (Section V / Table I) in PyTorch.

Port of the JAX package's ``models/edge.py``.  ``edge_forward`` is the float
reference, one ``fused_dense`` launch per layer (the calibration pass of
``quantize_edge`` runs the same launches); ``edge_forward_q8`` is the int8
serving path, one kernel launch per DR7' fusion group read from the plan:
``fused_mlp_q8`` for multi-layer groups and ``gemm_int8`` (with the plan's
block shape) for singletons or when the caller forces the per-layer path.

``params_from_numpy`` / ``qparams_from_numpy`` carry weights made elsewhere
(for example by the JAX package, converted with ``np.asarray``) into the
port's form, so both implementations can run on the same numbers.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

F32 = torch.float32

# Layer widths as the JAX package reconstructs them from Table I.
EDGE_NETS: dict[str, dict] = {
    "jet_tagger": {"dims": [16, 64, 32, 32, 5], "act": "relu"},
    "tau_select": {"dims": [27, 32, 16, 2], "act": "relu"},
    "vae": {"dims": [64, 104, 104, 104, 64, 16], "act": "relu"},
    "qubit": {"dims": [250, 96, 128, 128, 128, 96, 5], "act": "relu"},
    "autoencoder": {"dims": [136, 136, 136, 136, 8, 136, 136, 136, 136],
                    "act": "relu"},
}


@dataclasses.dataclass(frozen=True)
class EdgeConfig:
    name: str
    dims: tuple[int, ...]
    act: str = "relu"
    batch: int = 8          # the paper's extreme-edge batch size

    @property
    def layer_shapes(self) -> list[tuple[int, int]]:
        return list(zip(self.dims[:-1], self.dims[1:]))


def edge_config(name: str) -> EdgeConfig:
    spec = EDGE_NETS[name]
    return EdgeConfig(name=name, dims=tuple(spec["dims"]), act=spec["act"])


def init_edge(cfg: EdgeConfig, *, generator: torch.Generator,
              device=None) -> list[dict]:
    """Random weights ``N(0, 1/n_in)`` and zero biases, drawn from
    ``generator`` (a CPU generator) and placed on ``device``."""
    device = resolve_device(device)
    params = []
    for n_in, n_out in cfg.layer_shapes:
        w = torch.randn((n_in, n_out), generator=generator, dtype=F32) \
            / math.sqrt(n_in)
        params.append({"w": w.to(device),
                       "b": torch.zeros((n_out,), dtype=F32, device=device)})
    return params


def params_from_numpy(params, *, device=None) -> list[dict]:
    """Float params (``[{"w", "b"}]`` of arrays) as the port's tensors."""
    device = resolve_device(device)
    return [{"w": torch.as_tensor(p["w"], dtype=F32).to(device),
             "b": torch.as_tensor(p["b"], dtype=F32).to(device)}
            for p in params]


def qparams_from_numpy(qparams, *, device=None) -> list[dict]:
    """Quantized params (``w_q``, ``w_scale``, ``b`` and, when calibrated,
    ``x_scale``) as the port's tensors."""
    device = resolve_device(device)
    out = []
    for p in qparams:
        q = {"w_q": torch.as_tensor(p["w_q"], dtype=torch.int8).to(device),
             "w_scale": torch.as_tensor(p["w_scale"], dtype=F32).to(device),
             "b": torch.as_tensor(p["b"], dtype=F32).to(device)}
        if "x_scale" in p:
            q["x_scale"] = float(p["x_scale"])
        out.append(q)
    return out


def _dense_act(i: int, last: int, act: str) -> str:
    """A layer's ``fused_dense`` activation: ReLU on all but the last."""
    return "relu" if i != last and act == "relu" else "none"


def edge_forward(params: list[dict], cfg: EdgeConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """Float reference forward ``(B, dims[0]) -> (B, dims[-1])``: one
    ``fused_dense`` launch per layer."""
    h = x.to(F32).contiguous()
    last = len(params) - 1
    for i, p in enumerate(params):
        h = ops.fused_dense(h, p["w"], p["b"], act=_dense_act(i, last,
                                                              cfg.act))
    return h


def quantize_edge(params: list[dict], *, calib_x: torch.Tensor | None = None,
                  act: str = "relu") -> list[dict]:
    """Per-output-channel symmetric int8 weights; with ``calib_x``, each layer
    also gets its calibrated input scale ``max|h_i| / 127`` from one float
    forward, one ``fused_dense`` launch per layer as in :func:`edge_forward`.
    Runs on the params' device; every division by a constant is by a 0-d
    tensor, which is a true IEEE division on every device."""
    qparams = []
    h = None if calib_x is None else calib_x.to(F32).contiguous()
    last = len(params) - 1
    for i, p in enumerate(params):
        w = p["w"]
        c127 = torch.tensor(127.0, dtype=F32, device=w.device)
        scale = w.abs().amax(dim=0) / c127 + 1e-12
        qw = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
        q = {"w_q": qw.to(torch.int8), "w_scale": scale, "b": p["b"]}
        if h is not None:
            q["x_scale"] = max(float(h.abs().max()) / 127.0, 1e-8)
            h = ops.fused_dense(h, w, p["b"], act=_dense_act(i, last, act))
        qparams.append(q)
    return qparams


def deployment_plan(cfg: EdgeConfig, *, device=None):
    """The net's cached h100 :class:`DeploymentPlan`."""
    from repro_torch.plan import planner
    return planner.get_or_plan(cfg, device=device)


def _layer_step(p: dict, scale: float, blocks: tuple, relu: bool):
    """One singleton group: host-side quantize, ``gemm_int8``, bias, ReLU."""
    divisor = torch.tensor(scale, dtype=F32, device=p["w_q"].device)
    bm, bk, bn = blocks

    def step(h: torch.Tensor) -> torch.Tensor:
        hq = torch.clamp(torch.round(h / divisor), -127, 127).to(torch.int8)
        y = ops.gemm_int8(hq, p["w_q"], p["w_scale"], scale, block_m=bm,
                          block_k=bk, block_n=bn, out_dtype=F32)
        y = y + p["b"][None, :]
        return torch.clamp_min(y, 0.0) if relu else y
    return step


def build_forward_q8(qparams: list[dict], cfg: EdgeConfig, *,
                     x_scale: float = 0.05, plan=None,
                     block_m: int | None = None, block_k: int | None = None,
                     block_n: int | None = None, fused: bool | None = None):
    """The int8 forward as a callable, with groups, tiles, packed weights and
    scales fixed once here so the hot path never reads the plan.

    Explicit ``block_*`` arguments force the per-layer kernel, as does
    ``fused=False``; without a plan, the net's cached h100 plan is used.
    Per-layer input scales come from each layer's calibrated ``x_scale``,
    else from the ``x_scale`` argument."""
    n = len(qparams)
    last = n - 1
    explicit_blocks = not (block_m is None and block_k is None
                           and block_n is None)
    if plan is None and (block_m is None or block_k is None or block_n is None):
        plan = deployment_plan(cfg, device=qparams[0]["w_q"].device)
    scales = [float(p.get("x_scale", x_scale)) for p in qparams]
    act = cfg.act if cfg.act in ("relu",) else "none"
    if plan is not None and fused is not False and not explicit_blocks:
        groups = plan.groups()
    else:
        groups = [[i] for i in range(n)]
    if plan is not None:
        tiles = [plan.layer(i).api_tile for i in range(n)]
    else:
        tiles = [(block_m, block_k, block_n)] * n

    steps = []
    for grp in groups:
        if len(grp) > 1:
            g = ops.pack_group(
                [qparams[i]["w_q"] for i in grp],
                [qparams[i]["w_scale"] for i in grp],
                [qparams[i]["b"] for i in grp],
                [scales[i] for i in grp], act=act, act_last=grp[-1] != last)
            steps.append(lambda h, g=g: ops.fused_group(h, g))
            continue
        i = grp[0]
        tm, tk, tn = tiles[i]
        # `is not None`: an explicit block overrides the plan's, and a plan
        # tile is never shadowed by a falsy 0.
        blocks = (block_m if block_m is not None else tm,
                  block_k if block_k is not None else tk,
                  block_n if block_n is not None else tn)
        steps.append(_layer_step(qparams[i], scales[i], blocks,
                                 relu=i != last and act == "relu"))

    def forward(x: torch.Tensor) -> torch.Tensor:
        h = x.to(F32).contiguous()
        for step in steps:
            h = step(h)
        return h
    return forward


def edge_forward_q8(qparams: list[dict], cfg: EdgeConfig, x: torch.Tensor,
                    **kw) -> torch.Tensor:
    """int8 deployment path, compiled from a plan (see
    :func:`build_forward_q8` for the keywords)."""
    return build_forward_q8(qparams, cfg, **kw)(x)
