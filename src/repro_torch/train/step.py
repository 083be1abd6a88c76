"""The train step: remat, microbatching, the chunked loss, clipping.

Port of the JAX package's ``train/step.py`` for one card.
``build_train_step`` returns ``(init_fn(generator), step_fn(state,
batch))``.  The state is ``{"params", "opt", "step"}``: params are leaf
tensors that require grad, ``step`` an int32 scalar on the params' device.
``step_fn`` runs the loss's forward and backward (its kernels' gradients
included: ``ops.flash_attention`` and ``ops.linear_scan`` are autograd
Functions), clips by the global norm through ``opt.update(scale=)``, and
updates the params and the optimizer state in place (the reference donates
its state to the jitted step); it returns the state and the metrics.
:func:`state_shardings` lays a state out on a mesh: params by
:func:`repro_torch.partition.param_shardings`, each optimizer moment like
the param it belongs to.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import partition, runtime
from repro_torch.device import resolve_device
from repro_torch.models import (api, encdec, griffin, rwkv, transformer,
                                tree)
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import NamedSharding, P
from repro_torch.train import loss as loss_lib
from repro_torch.train.optimizer import Optimizer

F32 = torch.float32
_NORM_CHUNK = 1 << 24     # elements widened to f32 at a time


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    remat: str = "block"            # "none" | "block" | "dots"
    microbatches: int = 1
    clip_norm: float = 1.0
    chunked_loss: bool = False      # vocab-chunked CE (transformer family)
    acc_dtype: str = "float32"      # the microbatch gradient accumulator
    mtp_weight: float = 0.3
    aux_weight: float = 1.0         # MoE load-balance loss weight
    z_loss: float = 0.0


def global_norm(tree_) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, accumulated in f32.  A bf16
    leaf is widened ``_NORM_CHUNK`` elements at a time, never whole (the
    tied embedding of gemma2-2b is 590 M elements).  A ``DTensor`` leaf
    sums its own block, then the blocks over the mesh dims that split it
    (one all-reduce of a scalar, as GSPMD reduces a sharded norm)."""
    total = None
    for leaf in tree.leaves(tree_):
        for sq in _squares(leaf):
            total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=F32)
    return torch.sqrt(total)


def _squares(leaf: torch.Tensor):
    """The f32 sums of squares of ``leaf``'s chunks, in order."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if isinstance(leaf, DTensor):
        if any(p.is_partial() for p in leaf.placements):
            leaf = leaf.redistribute(leaf.device_mesh, [
                Replicate() if p.is_partial() else p
                for p in leaf.placements])
        local = None
        for sq in _squares(leaf.to_local()):
            local = sq if local is None else local + sq
        if local is not None:
            yield DTensor.from_local(
                local, leaf.device_mesh,
                [Partial() if isinstance(p, Shard) else Replicate()
                 for p in leaf.placements], run_check=False).full_tensor()
        return
    flat = leaf.reshape(-1)
    for i in range(0, flat.numel(), _NORM_CHUNK):
        c = flat[i:i + _NORM_CHUNK].to(F32)
        yield torch.dot(c, c)


def clip_by_global_norm(tree_, max_norm: float):
    """(the tree scaled by ``min(1, max_norm / (norm + 1e-9))``, norm)."""
    norm = global_norm(tree_)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return tree.tree_map(lambda l: (l * scale.to(l.dtype)).to(l.dtype),
                         tree_), norm


def _batch_on(batch: dict, device) -> dict:
    return {k: tree.as_tensor(v, device) for k, v in batch.items()}


def make_loss_fn(cfg: ModelConfig, opts: TrainOptions) -> Callable:
    """``loss_fn(params, batch) -> (total, {"ce", "aux"})``."""
    def loss_fn(params, batch):
        with runtime.remat_policy(opts.remat):
            if opts.chunked_loss and cfg.family == "transformer":
                out = transformer.lm_forward(
                    params, cfg, batch["tokens"],
                    mrope_positions=batch.get("mrope_positions"),
                    embeddings=batch.get("embeddings"), want_hidden=True)
                ce = loss_lib.chunked_xent(params, cfg, out["hidden"],
                                           batch["labels"],
                                           z_loss=opts.z_loss)
            else:
                out = api.forward(params, cfg, batch)
                ce = loss_lib.softmax_xent(out["logits"], batch["labels"],
                                           z_loss=opts.z_loss)
            aux = out.get("aux_loss")
            if aux is None:
                aux = torch.zeros((), dtype=F32, device=ce.device)
            total = ce + opts.aux_weight * aux
            if cfg.mtp and "mtp_hidden" in out and opts.mtp_weight:
                # Token t+2 from (h_t, emb(label_t)); the whole sequence
                # goes through the MTP layer and the loss drops the last.
                mtp_lg = transformer.mtp_logits(params, cfg,
                                                out["mtp_hidden"],
                                                batch["labels"])
                labels = tree.as_tensor(batch["labels"], mtp_lg.device)
                total = total + opts.mtp_weight * loss_lib.softmax_xent(
                    mtp_lg[:, :-1], labels[:, 1:])
        return total, {"ce": ce.detach(), "aux": aux.detach()}
    return loss_fn


def _split(batch: dict, mb: int) -> list[dict]:
    """``mb`` microbatches along the batch axis (axis 1 of
    ``mrope_positions``, which leads with its (3,) axis)."""
    out = [dict() for _ in range(mb)]
    for k, v in batch.items():
        axis = 1 if k == "mrope_positions" else 0
        for i, part in enumerate(torch.chunk(v, mb, dim=axis)):
            out[i][k] = part
    return out


def build_train_step(cfg: ModelConfig, opt: Optimizer,
                     opts: TrainOptions = TrainOptions(), *, device=None):
    """(init_fn(generator) -> state, step_fn(state, batch) -> (state,
    metrics)).  ``init_fn`` draws the params from ``generator`` onto
    ``device`` (``None``: the GPU, raising when there is none)."""
    loss_fn = make_loss_fn(cfg, opts)

    def init_fn(generator: torch.Generator) -> dict:
        params = api.init(cfg, generator, device=resolve_device(device))
        return train_state(params, opt)

    def step_fn(state: dict, batch: dict):
        params = state["params"]
        leaves = _trainable(params)
        dev = leaves[0].device
        batch = _batch_on(batch, dev)
        if opts.microbatches > 1:
            mb = opts.microbatches
            acc_dt = getattr(torch, opts.acc_dtype)
            grads = [torch.zeros_like(p, dtype=acc_dt,
                                      memory_format=torch.contiguous_format)
                     for p in leaves]
            total = torch.zeros((), dtype=F32, device=dev)
            metrics = {"ce": torch.zeros((), dtype=F32, device=dev),
                       "aux": torch.zeros((), dtype=F32, device=dev)}
            for part in _split(batch, mb):
                l, m = loss_fn(params, part)
                for acc, g in zip(grads, _grad(l, leaves)):
                    acc += (g / mb).to(acc_dt)
                total = total + l.detach() / mb
                metrics = {k: metrics[k] + m[k] / mb for k in metrics}
        else:
            total, metrics = loss_fn(params, batch)
            grads = _grad(total, leaves)
            total = total.detach()
        grad_tree = _like(params, grads)
        # The clip's scale goes into the optimizer's update (a per-leaf
        # transient), not a rewrite of the whole gradient tree.
        gnorm = global_norm(grad_tree)
        scale = torch.clamp_max(opts.clip_norm / (gnorm + 1e-9), 1.0)
        del grads
        opt.update(grad_tree, state["opt"], params, state["step"],
                   scale=scale)
        del grad_tree
        metrics = dict(metrics, loss=total, grad_norm=gnorm,
                       step=state["step"].to(F32))
        state["step"] = state["step"] + 1
        return state, metrics

    return init_fn, step_fn


def _grad(loss: torch.Tensor, leaves: list) -> list:
    """d loss / d leaf for every leaf; zeros for a leaf the loss does not
    use, as ``jax.grad`` gives."""
    return list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True))


def _trainable(params) -> list:
    """The params' leaves, each made to require grad (a restored state's
    leaves come back without it)."""
    out = tree.leaves(params)
    for p in out:
        if not p.requires_grad:
            p.requires_grad_(True)
    return out


def _like(params, flat: list):
    it = iter(flat)
    return tree.tree_map(lambda _: next(it), params)


def train_state(params, opt: Optimizer, step: int = 0) -> dict:
    """``{"params", "opt", "step"}`` for params (made to require grad)."""
    _trainable(params)
    return {"params": params, "opt": opt.init(params),
            "step": torch.full((), step, dtype=torch.int32,
                               device=tree.leaves(params)[0].device)}


_FROM_NUMPY = {"transformer": transformer.params_from_numpy,
               "griffin": griffin.params_from_numpy,
               "encdec": encdec.params_from_numpy,
               "rwkv": rwkv.params_from_numpy}


def train_state_from_numpy(cfg: ModelConfig, state: dict, *,
                           device=None) -> dict:
    """The JAX package's train state (its ``init_fn(key)`` or a later
    state, leaves as numpy arrays, bfloat16 included) as the port's on
    ``device`` (``None``: the GPU, raising when there is none): the params
    through the family's ``params_from_numpy``, the optimizer's slots
    (AdamW's ``m``/``v``, int8 ``{"q", "s"}`` pairs among them,
    Adafactor's ``vr``/``vc``/``v``, SGD's ``mu``) leaf by leaf, and the
    step as an int32 scalar."""
    device = resolve_device(device)
    params = _FROM_NUMPY[cfg.family](cfg, state["params"], device=device)
    _trainable(params)
    return {"params": params,
            "opt": tree.tree_map(lambda a: tree.as_tensor(a, device),
                                 state["opt"]),
            "step": tree.as_tensor(state["step"], device).to(torch.int32)}


def state_shardings(state, cfg: ModelConfig, mesh, *, regime: str = "train"):
    """Shardings for the whole train state (ZeRO: moments follow params).

    A moment (an optimizer leaf whose path, less one or two leading keys,
    is a param's) takes that param's sharding; Adafactor's factored
    ``vr``/``vc`` take it less the dim they reduce; everything else, and
    ``step``, is replicated."""
    param_sh = partition.param_shardings(state["params"], cfg, mesh,
                                         regime=regime)
    flat_p = {}
    partition.map_with_path(
        lambda path, sh: flat_p.__setitem__(tuple(path.split("/")), sh),
        param_sh)

    def match_moment(path, _leaf):
        keys = tuple(path.split("/"))
        for skip in (1, 2):      # drop leading "m"/"v"/"mu" keys
            cand = keys[skip:]
            if cand in flat_p:
                return flat_p[cand]
            # Adafactor's factored slots: vr = param less its last dim,
            # vc = less its second-to-last.
            if cand and cand[-1] in ("vr", "vc") and cand[:-1] in flat_p:
                new = list(flat_p[cand[:-1]].spec)
                drop = -1 if cand[-1] == "vr" else -2
                if len(new) >= abs(drop):
                    del new[drop]
                return NamedSharding(mesh, P(*new))
        return NamedSharding(mesh, P())

    return {"params": param_sh,
            "opt": partition.map_with_path(match_moment, state["opt"]),
            "step": NamedSharding(mesh, P())}
