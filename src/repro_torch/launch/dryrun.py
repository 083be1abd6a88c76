"""The dry run: one step of every (arch x shape x mesh) cell, counted on
one rank of a fake world, no memory allocated.

Port of the JAX package's ``launch/dryrun.py``.  There, 512 placeholder
host devices let ``make_production_mesh`` build the 16x16 single-pod and
2x16x16 multi-pod meshes, and each cell's step is lowered and compiled on
sharded ``ShapeDtypeStruct``s.  Here the world is the ``"fake"``
process-group backend with 256 or 512 ranks in this one process
(``torch.testing._internal.distributed.fake_pg``), the mesh a
``DeviceMesh`` over it, and each cell's step runs once on fake tensors
(``FakeTensorMode``): parameters, optimizer state, batches and caches are
``DTensor``s laid out by ``param_shardings``, ``state_shardings`` and
``cache_shardings`` whose local tensors hold no memory.  The step is the
one the port runs (the train step, or ``api.decode_step`` for a prefill or
a decode) under ``use_rules(mesh, train_rules|serve_rules)``.

The tensors are fake CUDA tensors on a CUDA-typed mesh, so the model takes
the card's branches (``layers.mm``'s f32 product of bf16 operands, the
kernels' autograd Functions with their chunk states and row statistics).
The kernels are priced, not run (``ops``' pricing route): each adds its
launch and work record at the local shapes.  :class:`~repro_torch.launch.
graph_analysis.RankCounter` counts rank 0's aten ops, kernels and
collectives, and the cell records them under the reference's keys.
Donation has no counterpart: ``alias_size_in_bytes`` stays 0.  Where
``DTensor`` would not place an op, or would place it badly, the dry run
places it as GSPMD would (:class:`_Reshard`; a cell's
``placed_by_fallback`` names the ops that needed a gather).  The count is
loop-aware (:func:`lower_cell`).

One op the card's branch runs has no sharding strategy in ``DTensor``: the
16-bit GEMM with an f32 result (``aten.mm.dtype``).  The dry run registers
``aten.mm``'s strategy for it, which is where the reference's GSPMD places
that dot (and ``detach``'s for ``detach_`` where a torch release lacks
one).

CLI:
  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch

:func:`lower_cell` with no mesh counts one rank with no world (no
``DTensor``, no collectives): the step one card runs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs, partition, sharding as shlib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.graph_analysis import RankCounter
from repro_torch.models import api, tree
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib


def default_device() -> str:
    """The fake tensors' device: ``"cuda"`` where a card is visible (the
    card's branches), else ``"cpu"``: a CPU-only build's autograd engine
    aborts on a CUDA tensor, fake or not."""
    return "cuda" if torch.cuda.is_available() else "cpu"


RANKS = {"single": 256, "multi": 512}
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


# ---------------------------------------------------------------------------
# The fake world and its tensors
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(ranks: int):
    """A ``"fake"`` process world of ``ranks`` ranks in this process, this
    process rank 0, closed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    mesh_lib.close_world()
    dist.init_process_group("fake", rank=0, world_size=ranks,
                            store=FakeStore())
    try:
        yield
    finally:
        mesh_lib.close_world()


def production_mesh(mesh_kind: str, device: str):
    """The cell's mesh: ``make_production_mesh``'s shape over the fake
    world, with a process group per mesh dim (``DTensor`` redistributes
    over them), typed ``device``."""
    from torch.distributed.device_mesh import init_device_mesh
    multi = mesh_kind == "multi"
    shape = (2, 16, 16) if multi else (16, 16)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    mesh_lib.make_production_mesh(multi_pod=multi)      # refuses the world
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def _register_strategies() -> None:
    """Sharding strategies ``DTensor`` lacks for ops the card's branch runs
    (each as its twin's): ``aten.mm.dtype``, the 16-bit GEMM writing f32,
    as ``aten.mm``; and, where a torch release has none, ``detach_`` as
    ``detach``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import OpSchema
    prop = DTensor._op_dispatcher.sharding_propagator
    aten = torch.ops.aten
    for op, like, n_args in ((aten.mm.dtype, aten.mm.default, 2),
                             (aten.detach_.default, aten.detach.default, 1)):
        if op in prop.op_strategy_funcs or like not in prop.op_strategy_funcs:
            continue
        twin = prop.op_strategy_funcs[like]

        def strategy(schema, twin=twin, like=like, n_args=n_args):
            # The twin's strategy over its own arguments (mm.dtype's
            # out_dtype is no tensor's).
            return twin(OpSchema(like, schema.args_schema[:n_args], {}))
        prop.register_op_strategy(op, strategy)


class _Reshard(TorchDispatchMode):
    """Places the ops ``DTensor`` would not, or would place badly, as the
    reference's GSPMD places them:

    * a microbatch split of a batch split over data, and a view that folds
      or unfolds split dims, are taken on each rank's block
      (:func:`_split_local`, :func:`_local_view`);
    * a product's pending partial sums are reduced first;
    * an in-place update's operands come to its target's layout;
    * a lookup into a split dim (``gather``, ``embedding``) gives a masked
      partial sum, reduced at once (a later op would carry the mask at
      the wrong rank);
    * an op ``DTensor`` cannot shard as its operands lie (a head split
      that does not divide an unflattened dim, no sharding strategy) runs
      with every operand's splits past the batch dim gathered, and failing
      that on whole operands, replicated, as GSPMD runs what it cannot
      partition.  ``placed`` counts the ops these fallbacks took.

    Every move is a ``DTensor`` redistribution, counted as a collective."""

    def __init__(self):
        super().__init__()
        self.placed: dict[str, int] = {}

    def _took(self, how: str, func) -> None:
        key = f"{how} {func._schema.name}"
        self.placed[key] = self.placed.get(key, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        kwargs = kwargs or {}
        if func == torch.ops.aten.split.Tensor and isinstance(args[0],
                                                              DTensor):
            pieces = _split_local(args[0], args[1],
                                  args[2] if len(args) > 2
                                  else kwargs.get("dim", 0))
            if pieces is not None:
                return pieces
        if func in _VIEWS and isinstance(args[0], DTensor):
            out = _local_view(args[0], list(args[1]))
            if out is not None:
                return out
        if func in _GEMMS:
            # A pending partial sum is reduced before a product reads it,
            # as GSPMD reduces a dot's output before the next dot; carried
            # through the product, it would gather the weight whole.
            args = tuple(_reduced(t) for t in args)
        if func._schema.is_mutable and args and isinstance(args[0], DTensor):
            # An in-place update keeps its target's layout: the operands
            # come to it (a gradient's partial sum reduce-scattered onto
            # its parameter's split, as GSPMD's out-sharding puts it).
            dst = args[0]
            args = (dst,) + tuple(
                t.redistribute(dst.device_mesh, dst.placements)
                if isinstance(t, DTensor) and t.shape == dst.shape
                and t.placements != dst.placements else t
                for t in args[1:])
        try:
            return _pytree.tree_map(_reduce_masked, func(*args, **kwargs))
        except (RuntimeError, NotImplementedError) as e:
            if not _sharding_failure(e):
                raise

        def gathered(t):
            if not isinstance(t, DTensor):
                return t
            pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                  for p in t.placements]
            return t.redistribute(t.device_mesh, pl)

        a2, k2 = _pytree.tree_map(gathered, (args, kwargs))
        try:
            out = func(*a2, **k2)
            self._took("gathered", func)
            return out
        except (RuntimeError, NotImplementedError) as e:
            if not _sharding_failure(e):
                raise
        mesh = next(t.device_mesh for t in _pytree.tree_leaves((args, kwargs))
                    if isinstance(t, DTensor))
        a3, k3 = _pytree.tree_map(
            lambda t: t.full_tensor() if isinstance(t, DTensor) else t,
            (args, kwargs))
        out = func(*a3, **k3)
        self._took("whole", func)
        return _pytree.tree_map(
            lambda t: DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                         run_check=False)
            if isinstance(t, torch.Tensor) else t, out)


@contextlib.contextmanager
def _placement(mesh, placed: dict):
    """Over a mesh: a plain tensor the model makes (rope tables, masks) is
    the same on every rank, so replicated, as GSPMD takes a constant; and
    :class:`_Reshard` above the counter, its fallbacks added to
    ``placed``."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    reshard = _Reshard()
    try:
        with implicit_replication(), reshard:
            yield
    finally:
        placed.update(reshard.placed)


_GEMMS = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype,
          torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _reduced(t):
    """A ``DTensor``'s partial sums reduced (all-reduced to replicas)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor) or not any(
            p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
          torch.ops.aten.reshape.default)


def _groups(a, b):
    """Aligned groups of dims of shapes ``a`` and ``b`` (equal numel):
    ``[(dims of a, dims of b), ...]`` whose products match."""
    out, i, j = [], 0, 0
    while i < len(a) or j < len(b):
        gi, gj = [i] if i < len(a) else [], [j] if j < len(b) else []
        pa = a[i] if i < len(a) else 1
        pb = b[j] if j < len(b) else 1
        i, j = i + bool(gi), j + bool(gj)
        while pa != pb:
            if pa < pb and i < len(a):
                pa *= a[i]
                gi.append(i)
                i += 1
            elif j < len(b):
                pb *= b[j]
                gj.append(j)
                j += 1
            else:
                return None
        out.append((gi, gj))
    return out


def _local_view(t, shape: list[int]):
    """A view that folds or unfolds split dims, taken on each rank's block:
    the tokens of a batch split over data and a sequence split over model
    fold into one dim split over both (and unfold back), each rank keeping
    its rows, as GSPMD keeps a token-parallel product local.  The rows'
    global order is the ranks' (no data moves; every count is a local
    op's).  None where the view needs no such handling (DTensor takes it)
    or the blocks do not divide."""
    from torch.distributed.tensor import DTensor, Shard
    if -1 in shape:
        rest = math.prod(d for d in shape if d != -1)
        shape = [t.numel() // rest if d == -1 else d for d in shape]
    split = {}                    # tensor dim -> mesh dims, major first
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard):
            split.setdefault(p.dim, []).append(m)
        elif not p.is_replicate():
            return None
    groups = _groups(list(t.shape), shape)
    if groups is None or not any(
            len([d for d in gi if d in split]) > 1 or
            (len(gi) > 1 and any(d in split for d in gi[1:])) or
            (len(gj) > 1 and any(d in split for d in gi))
            for gi, gj in groups):
        return None
    mesh = t.device_mesh
    placements = list(t.placements)
    local = list(t.to_local().shape)
    out_local = list(shape)
    for gi, gj in groups:
        meshes = [m for d in gi for m in split.get(d, [])]
        if not meshes:
            continue
        if len(gj) == 1:                      # fold: one dim, nested splits
            for m in meshes:
                placements[m] = Shard(gj[0])
            out_local[gj[0]] = math.prod(local[d] for d in gi)
            continue
        # unfold: each mesh dim takes the first out dim it divides
        rest = {d: shape[d] for d in gj}
        for m in meshes:
            n = mesh.size(m)
            d = next((d for d in gj if rest[d] % n == 0), None)
            if d is None:
                return None
            rest[d] //= n
            placements[m] = Shard(d)
        for d in gj:
            out_local[d] = rest[d]
    from repro_torch.collectives import local_shape
    if math.prod(out_local) != math.prod(local) or \
            tuple(out_local) != local_shape(shape, mesh, placements):
        return None     # uneven blocks: DTensor's own chunking differs
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t.to_local().reshape(out_local), mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _split_local(t, size: int, dim: int):
    """Pieces of ``size`` along a split dim ``dim`` (the train step's
    microbatches of a batch split over data) taken from each rank's own
    block, as GSPMD keeps a microbatch's rows on the ranks that hold them;
    None where the blocks do not divide evenly."""
    from torch.distributed.tensor import DTensor, Shard
    dim = dim % t.dim()
    if not any(isinstance(p, Shard) and p.dim == dim for p in t.placements):
        return None
    n = -(-t.shape[dim] // size)
    local = t.to_local()
    if t.shape[dim] % size or local.shape[dim] % n:
        return None
    shape = list(t.shape)
    shape[dim] = size
    stride = torch.empty(shape, device="meta").stride()
    return [DTensor.from_local(p, t.device_mesh, t.placements,
                               run_check=False, shape=torch.Size(shape),
                               stride=stride)
            for p in local.split(local.shape[dim] // n, dim)]


def _reduce_masked(t):
    """A ``DTensor`` with a masked partial placement, reduced there."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor) or not any(
            hasattr(p, "mask_buffer") for p in t.placements):
        return t
    pl = [Replicate() if hasattr(p, "mask_buffer") else p
          for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


def _sharding_failure(e: Exception) -> bool:
    msg = str(e)
    return ("Sharding propagation failed" in msg
            or "sharding strategy" in msg or "unevenly sharded" in msg)


def _placed(t: torch.Tensor, mesh, placements, *, grad: bool = False):
    """A fake ``DTensor`` shaped as ``t`` under ``placements`` (its local
    tensor this rank's block), or ``t``'s fake twin without a mesh."""
    if mesh is None:
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    else:
        from torch.distributed.tensor import DTensor
        from repro_torch.collectives import local_shape
        local = local_shape(tuple(t.shape), mesh, list(placements))
        out = DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device=t.device), mesh,
            list(placements), run_check=False, shape=t.shape,
            stride=torch.empty(t.shape, device="meta").stride())
    if not grad:
        return out
    out.requires_grad_(True)
    if mesh is not None:
        # The gradient comes laid out as its parameter (a partial sum
        # reduce-scattered onto the parameter's split), as GSPMD's
        # out-sharding of a gradient places it.
        from torch.distributed.tensor import DTensor
        out.register_hook(
            lambda g: g.redistribute(mesh, out.placements)
            if isinstance(g, DTensor) and g.placements != out.placements
            else g)
    return out


def _place_tree(abstract, shardings, mesh, *, grad: bool = False):
    """Every leaf of ``abstract`` as :func:`_placed` under its sharding."""
    if mesh is None:
        return tree.tree_map(lambda t: _placed(t, None, None, grad=grad),
                             abstract)
    flat = tree.leaves(shardings)
    it = iter(flat)
    return tree.tree_map(
        lambda t: _placed(t, mesh, next(it).placements, grad=grad), abstract)


def local_bytes(tree_) -> int:
    """Bytes of this rank's blocks of a tree of tensors."""
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in tree.leaves(tree_) if torch.is_tensor(t))


# ---------------------------------------------------------------------------
# input_specs: fake stand-ins for every model input
# ---------------------------------------------------------------------------

def _prod(mesh, axes):
    sizes = shlib.axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def input_specs(arch: configs.Arch, shape_name: str, mesh, *,
                device: str = "cuda") -> dict:
    """Fake inputs of one (arch, shape) cell, split over the mesh's data
    dims where the batch divides them."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = arch.config
    sh = arch.shapes[shape_name]
    b, s = sh.global_batch, sh.seq_len
    dp = shlib.dp_axes(mesh) if mesh is not None else ()
    dp_ok = bool(dp) and b % _prod(mesh, dp) == 0

    def spec(shape, dtype, batch_dim=0):
        t = torch.empty(shape, dtype=dtype, device=device)
        if mesh is None:
            return _placed(t, None, None)
        pl = [Shard(batch_dim) if dp_ok and name in dp else Replicate()
              for name in mesh.mesh_dim_names]
        return _placed(t, mesh, pl)

    out: dict = {}
    if sh.phase == "train":
        out["tokens"] = spec((b, s), torch.int32)
        out["labels"] = spec((b, s), torch.int32)
    elif sh.phase == "prefill":
        out["tokens"] = spec((b, s), torch.int32)
    else:  # decode: one new token against a seq_len-deep state
        out["tokens"] = spec((b, 1), torch.int32)
    if cfg.family == "encdec" and sh.phase != "decode":
        out["encoder_frames"] = spec((b, cfg.encdec.encoder_len, cfg.d_model),
                                     torch.float32)
    if cfg.mrope_sections is not None:
        s_eff = s if sh.phase != "decode" else 1
        out["mrope_positions"] = spec((3, b, s_eff), torch.int32,
                                      batch_dim=1)
    return out


def decode_state_specs(cfg: ModelConfig, batch: int, max_len: int, mesh, *,
                       ring_local: bool = False, device: str = "cuda"):
    """The decode state as fake tensors laid out by ``cache_shardings``."""
    if ring_local and cfg.family == "transformer":
        from repro_torch.models import transformer as _tr
        abstract = _tr.lm_cache_specs(cfg, batch, max_len, ring_local=True)
    else:
        abstract = api.decode_state_specs(cfg, batch, max_len)
    abstract = tree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device=device),
        abstract)
    shards = (partition.cache_shardings(abstract, mesh)
              if mesh is not None else None)
    return _place_tree(abstract, shards, mesh)


# Per-arch training optimizer defaults, the reference's: f32 AdamW where it
# fits; the 671B MoE needs Adafactor.
_OPT_FOR_ARCH = {
    "deepseek_v3_671b": ("adafactor", {}),
    "mixtral_8x22b": ("adamw", {"state_dtype": "bfloat16"}),
    "qwen2_vl_72b": ("adamw", {"state_dtype": "bfloat16"}),
}

# Per-arch train-step defaults, the reference's: the chunked vocab loss
# everywhere, microbatches sized for a 16 GiB chip.
_TRAIN_FOR_ARCH = {
    "gemma2_2b": {"microbatches": 2},
    "gemma2_9b": {"microbatches": 4},
    "gemma2_27b": {"microbatches": 4},
    "qwen2_5_3b": {"microbatches": 2},
    "whisper_medium": {"microbatches": 2},
    "mixtral_8x22b": {"microbatches": 8, "acc_dtype": "bfloat16"},
    "deepseek_v3_671b": {"microbatches": 8, "acc_dtype": "bfloat16"},
    "rwkv6_7b": {"microbatches": 2},
    "recurrentgemma_2b": {"microbatches": 4},
    "qwen2_vl_72b": {"microbatches": 8, "acc_dtype": "bfloat16"},
}


def train_options_for(arch_name: str, overrides: dict | None = None):
    opts = dict(remat="block", chunked_loss=True, microbatches=1)
    opts.update(_TRAIN_FOR_ARCH.get(arch_name, {}))
    opts.update(overrides or {})
    return step_lib.TrainOptions(**opts)


# ---------------------------------------------------------------------------
# Trace and count one cell
# ---------------------------------------------------------------------------

def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _per_shard(opt: opt_lib.Optimizer) -> opt_lib.Optimizer:
    """``opt`` run on each rank's blocks, as GSPMD runs an elementwise
    update: each gradient laid out as its parameter first (a partial sum
    reduce-scattered onto the parameter's split, a counted collective),
    the clip scale reduced, then ``opt.update`` on the local tensors.  Its
    state holds each rank's blocks (the moments follow the parameters, as
    ``state_shardings`` lays them out)."""
    from torch.distributed.tensor import DTensor, Replicate

    def laid_out(g, p):
        if not isinstance(g, DTensor) or g.placements == p.placements:
            return g
        return g.redistribute(p.device_mesh, p.placements)

    def update(grads, state, params, step, scale=None):
        grads = tree.tree_map(laid_out, grads, params)
        if isinstance(scale, DTensor):
            scale = scale.redistribute(
                scale.device_mesh, [Replicate()] * scale.device_mesh.ndim)
        return opt.update(tree.tree_map(_local, grads), state,
                          tree.tree_map(_local, params), _local(step),
                          scale=None if scale is None else _local(scale))

    return dataclasses.replace(opt, update=update)


def _abstract_params(cfg: ModelConfig, device: str):
    """The params' shapes and dtypes as fake tensors on ``device``."""
    meta = api.init(cfg, torch.Generator(), device=torch.device("meta"))
    return tree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), meta)


def _trace(arch: configs.Arch, cfg: ModelConfig, shape_name: str, mesh, *,
           device: str, opt_overrides: dict | None,
           train_overrides: dict | None, ring_local: bool, quant8: bool,
           serve_sp: bool) -> dict:
    """Run the cell's step of ``cfg`` once on fake tensors and count rank
    0: the counter's cell keys, the kernels' priced calls (``launches``)
    and the argument bytes."""
    sh = arch.shapes[shape_name]
    if mesh is not None:
        _register_strategies()
        rules = (shlib.train_rules(mesh) if sh.phase == "train"
                 else shlib.serve_rules(mesh, seq_shard=serve_sp))
        ctx = shlib.use_rules(mesh, rules)
    else:
        ctx = contextlib.nullcontext()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    counter = RankCounter(fake_mode=fake)
    with fake, ctx:
        specs = input_specs(arch, shape_name, mesh, device=device)
        abstract = _abstract_params(cfg, device)
        if sh.phase == "train":
            name, okw = _OPT_FOR_ARCH.get(arch.name, ("adamw", {}))
            if opt_overrides:
                name = opt_overrides.get("name", name)
                okw = opt_overrides.get("kw", okw)
            opt = opt_lib.make(name, lr=3e-4, **okw)
            _, step_fn = step_lib.build_train_step(
                cfg, _per_shard(opt),
                train_options_for(arch.name, train_overrides),
                device=device)
            p_sh = (partition.param_shardings(abstract, cfg, mesh)
                    if mesh is not None else None)
            params = _place_tree(abstract, p_sh, mesh, grad=True)
            state = {"params": params,
                     "opt": opt.init(tree.tree_map(_local, params)),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=device)}
            args_bytes = local_bytes(state) + local_bytes(specs)

            def run():
                step_fn(state, specs)
        else:
            if quant8:
                from repro_torch.serve import engine as _eng
                abstract = _eng.quantize_params(abstract)
            p_sh = (partition.param_shardings(abstract, cfg, mesh,
                                              regime="serve")
                    if mesh is not None else None)
            params = _place_tree(abstract, p_sh, mesh)
            state = decode_state_specs(cfg, sh.global_batch, sh.seq_len,
                                       mesh, ring_local=ring_local,
                                       device=device)
            extras = {k: v for k, v in specs.items() if k != "tokens"}
            pos = 0 if sh.phase == "prefill" else sh.seq_len - 1
            args_bytes = (local_bytes(params) + local_bytes(state)
                          + local_bytes(specs))

            def run():
                with torch.no_grad():
                    logits, _ = api.decode_step(
                        params, cfg, specs["tokens"], state, pos,
                        extras=extras)
                    if sh.phase == "prefill":
                        logits[:, -1:]
        placed: dict = {}
        with counter, _placement(mesh, placed):
            run()
    out = counter.cell()
    out["launches"] = counter.priced_calls
    out["placed_by_fallback"] = placed
    out["argument_size_in_bytes"] = args_bytes
    return out


def depth_units(cfg: ModelConfig):
    """``(n, at)``: the repeating layer blocks of ``cfg`` and ``at(k)``,
    ``cfg`` with ``k`` of them (its dense prefix and tail kept); None
    where the depth has no single repeating unit."""
    if cfg.family == "encdec":
        e = cfg.encdec
        if e.encoder_layers != e.decoder_layers:
            return None
        return e.encoder_layers, lambda k: dataclasses.replace(
            cfg, num_layers=k, encdec=dataclasses.replace(
                e, encoder_layers=k, decoder_layers=k))
    if cfg.family == "griffin":
        u = len(cfg.griffin.pattern)
        first = 0
    elif cfg.family == "rwkv":
        u, first = 1, 0
    else:
        u = len(cfg.attn_pattern)
        first = cfg.moe.first_k_dense if cfg.moe is not None else 0
    n, tail = divmod(cfg.num_layers - first, u)
    return n, lambda k: dataclasses.replace(cfg,
                                            num_layers=first + k * u + tail)


def _extrapolate(one, two, n: int):
    """``one + (n - 1) (two - one)``, number by number through nested
    dicts: the counts of ``n`` blocks from those of one and two."""
    if isinstance(one, dict):
        keys = list(one) + [k for k in two if k not in one]
        return {k: _extrapolate(one.get(k, 0), two.get(k, 0), n)
                for k in keys}
    if isinstance(one, bool) or not isinstance(one, (int, float)):
        return one
    v = one + (n - 1) * (two - one)
    return type(one)(v) if isinstance(one, int) else v


def lower_cell(arch: configs.Arch, shape_name: str, mesh, *,
               device: str | None = None, full_depth: bool = False,
               opt_overrides: dict | None = None,
               train_overrides: dict | None = None,
               moe_impl: str | None = None,
               ring_local: bool = False,
               quant8: bool = False,
               serve_sp: bool = False):
    """Count one cell; returns ``(counts, meta)``.

    Loop-aware, as the reference's HLO analysis multiplies a scanned layer
    stack's body by its trip count: the step is traced with one and with
    two of the architecture's repeating layer blocks (its dense prefix,
    tail, embedding and head whole), and every count (FLOPs, bytes,
    kernels, collectives, launches, argument bytes) is extended linearly
    to the published depth, which is exact where the blocks are alike;
    the live-bytes peak is extended the same way, an estimate.
    ``full_depth`` traces every layer instead."""
    device = device or default_device()
    cfg = arch.config
    if moe_impl and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=moe_impl))
    sh = arch.shapes[shape_name]
    kw = dict(device=device, opt_overrides=opt_overrides,
              train_overrides=train_overrides, ring_local=ring_local,
              quant8=quant8, serve_sp=serve_sp)
    units = None if full_depth else depth_units(cfg)
    if units is None or units[0] <= 2:
        counts = _trace(arch, cfg, shape_name, mesh, **kw)
        depth = {"traced": "full"}
    else:
        n, at = units
        one = _trace(arch, at(1), shape_name, mesh, **kw)
        two = _trace(arch, at(2), shape_name, mesh, **kw)
        counts = _extrapolate(one, two, n)
        depth = {"traced": "blocks 1 and 2", "blocks": n}
    meta = {"arch": arch.name, "shape": shape_name, "phase": sh.phase,
            "mesh": (dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
                     if mesh is not None else {}),
            "ranks": math.prod(tuple(mesh.shape)) if mesh is not None else 1,
            "device": device, "depth": depth}
    return counts, meta


def analyze(counts: dict, meta: dict) -> dict:
    """The cell: ``meta`` with the counts under the reference's cell keys
    (``temp_size_in_bytes`` is the live-bytes peak, an estimate; donation
    has no counterpart, so ``alias_size_in_bytes`` is 0)."""
    out = dict(meta)
    out.update(counts)
    out["argument_size_in_bytes"] = int(out["argument_size_in_bytes"])
    out["temp_size_in_bytes"] = int(out["temp_size_in_bytes"])
    out["alias_size_in_bytes"] = 0
    out["temp_size_is_estimate"] = True
    return out


def run_cell(arch_name: str, shape_name: str, mesh_kind: str, *,
             device: str | None = None, train_overrides: dict | None = None,
             moe_impl: str | None = None, ring_local: bool = False,
             quant8: bool = False, serve_sp: bool = False) -> dict:
    arch = configs.get(arch_name)
    sh = arch.shapes[shape_name]
    if sh.skip:
        return {"arch": arch.name, "shape": shape_name, "mesh": mesh_kind,
                "skipped": sh.skip}
    device = device or default_device()
    t0 = time.time()
    with fake_world(RANKS[mesh_kind]):
        mesh = production_mesh(mesh_kind, device)
        counts, meta = lower_cell(
            arch, shape_name, mesh, device=device,
            train_overrides=train_overrides, moe_impl=moe_impl,
            ring_local=ring_local, quant8=quant8, serve_sp=serve_sp)
    result = analyze(counts, meta)
    result["mesh_kind"] = mesh_kind
    result["compile_s"] = round(time.time() - t0, 1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", type=str, default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="results/dryrun_torch")
    ap.add_argument("--chunked-loss", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--cell", action="append", default=[],
                    metavar="ARCH:SHAPE:MESH",
                    help="one cell (repeatable), in place of --arch, "
                         "--shape and --mesh")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = configs.all_archs() if args.all or not args.arch else [args.arch]
    shapes = (list(SHAPE_NAMES) if args.all or not args.shape
              else [args.shape])
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    overrides = {}
    if args.chunked_loss:
        overrides["chunked_loss"] = True
    if args.microbatches:
        overrides["microbatches"] = args.microbatches

    cells = [tuple(c.split(":")) for c in args.cell] or [
        (an, sn, mk) for an in archs for sn in shapes for mk in meshes]
    failures = 0
    for an, sn, mk in cells:
        tag = f"{an.replace('-', '_')}.{sn}.{mk}"
        path = os.path.join(args.out, tag + ".json")
        try:
            res = run_cell(an, sn, mk, train_overrides=overrides or None)
            status = ("SKIP " + res["skipped"]) if "skipped" in res \
                else (f"ok flops={res['flops']:.3e} "
                      f"temp={res['temp_size_in_bytes']/2**30:.2f}GiB "
                      f"coll={res['collective_operand_bytes']/2**20:.0f}MiB "
                      f"({res['compile_s']}s)")
        except Exception as e:  # noqa: BLE001 — record and continue
            failures += 1
            res = {"arch": an, "shape": sn, "mesh": mk,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()}
            status = f"FAIL {type(e).__name__}: {str(e)[:300]}"
        with open(path, "w") as f:
            json.dump(res, f, indent=1, default=str)
        print(f"[dryrun] {tag:45s} {status}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
