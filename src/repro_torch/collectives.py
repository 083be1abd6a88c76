"""``shard_map`` and the mesh collectives of the multi-device paths.

JAX provides what this module holds: ``shard_map`` and the ``jax.lax``
collectives over named mesh axes (``psum``, ``pmax``, ``pmean``,
``all_gather``, ``all_to_all``, ``ppermute``, ``axis_index``).  Here they
run on ``torch.distributed``; every call the port makes into it for its
multi-device paths is in this module.

* A **group of mesh dims** (``"model"``, or ``("pod", "data")``, major
  first, in mesh order) maps to one process group per line of the mesh
  through the other dims, built once (every rank builds every line, in the
  same order) and cached.  A rank's index in its group is its mixed-radix
  coordinate over those dims, JAX's ``axis_index`` of the tuple; the
  group's ranks are in that order, so ``all_to_all`` and ``all_gather``
  order their blocks as JAX does.
* **shard_map(fn, mesh, in_specs, out_specs)** gives ``fn`` each input's
  local block (a plain tensor is the global value, of which each rank
  takes its block with no communication; a ``DTensor`` is laid out anew to
  the in-spec first) and returns ``fn``'s outputs as ``DTensor``s with the
  out-spec's placements.  A spec entry split over several mesh dims is
  ``Shard`` on each of them, the first most major, as JAX orders the
  blocks.
* **Composed forms.**  Gloo carries few collectives on CUDA tensors and
  none from a rank to itself.  Where it does not carry an op, the op is
  composed from one ``all_reduce`` over a zero-filled byte buffer: each
  rank writes its bytes into its slot, the sum is each slot's one nonzero
  writer, bit for bit (any dtype, any value: the bytes are summed as
  ``uint8`` with zeros).  NCCL always takes the native op.
  :data:`COMPOSED` records which ops were composed.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.sharding import P, axis_sizes, entry_axes

# The collectives gloo carries on CUDA tensors in the card's torch 2.11:
# all_reduce (every dtype), all_gather_into_tensor and all_to_all_single;
# its send/recv refuses a CUDA tensor, so ppermute is composed there.
# ``chip_smoke.py`` phase 18 holds each of these against its composed form.
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather", "all_to_all"})
COMPOSED: set[str] = set()          # ops that took the composed form
_FORCE_COMPOSED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_force_composed", default=False)
_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_shard_map_mesh", default=None)
_GROUPS: dict = {}


@contextlib.contextmanager
def force_composed():
    """Every op on gloo takes its composed form (tests hold the two
    forms bit-equal)."""
    tok = _FORCE_COMPOSED.set(True)
    try:
        yield
    finally:
        _FORCE_COMPOSED.reset(tok)


def forget_groups() -> None:
    _GROUPS.clear()


def is_writer() -> bool:
    """Whether this process writes what every rank holds (rank 0, or no
    world)."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# Specs, placements and local blocks
# ---------------------------------------------------------------------------

def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _check_order(mesh, axes: tuple[str, ...]) -> list[int]:
    names = tuple(mesh.mesh_dim_names)
    idx = [names.index(a) for a in axes]
    if idx != sorted(idx) or len(set(idx)) != len(idx):
        raise ValueError(f"mesh dims {axes} must be distinct and in the "
                         f"mesh's order {names}")
    return idx


def placements(spec, mesh) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(i)`` on
    each mesh dim that splits tensor dim ``i``, ``Replicate`` on the
    rest."""
    out: list = [Replicate()] * len(mesh.mesh_dim_names)
    for i, entry in enumerate(spec):
        for j in _check_order(mesh, entry_axes(entry)):
            out[j] = Shard(i)
    return out


def local_shape(shape, mesh, placements) -> tuple[int, ...]:
    """This rank's block shape of a tensor of ``shape`` under
    ``placements``, as ``DTensor`` chunks it (``torch.chunk`` along each
    split dim, mesh dims in order), from the mesh coordinate alone."""
    out = list(shape)
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n, c = mesh.size(i), coord[i]
            size = -(-out[pl.dim] // n)
            out[pl.dim] = max(0, min(size, out[pl.dim] - c * size))
    return tuple(out)


def spec_of(x: DTensor) -> P:
    """The spec of a ``DTensor``'s placements."""
    entries: list[list[str]] = [[] for _ in range(x.dim())]
    names = x.device_mesh.mesh_dim_names
    for name, pl in zip(names, x.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"spec_of: placement {pl} has no spec")
    return P(*(None if not e else (e[0] if len(e) == 1 else tuple(e))
               for e in entries))


def axis_index(axes, mesh=None) -> int:
    """This rank's index along the mesh dims ``axes`` (mixed radix, the
    first dim most major)."""
    mesh = mesh or _MESH.get()
    axes = _axes(axes)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx


def _size(axes, mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _axes(axes))


def local_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``."""
    for i, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = _size(axes, mesh)
        if x.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n})")
        step = x.shape[i] // n
        x = x.narrow(i, axis_index(axes, mesh) * step, step)
    return x


def gather(x) -> torch.Tensor:
    """The global value of a ``DTensor`` as a plain tensor (each sharded
    dim gathered over its mesh dims, where they hold more than one rank:
    a block of one rank is the whole dim); a plain tensor is returned as
    is."""
    if not isinstance(x, DTensor):
        return x
    mesh, spec = x.device_mesh, spec_of(x)
    y = x.to_local()
    for i, entry in enumerate(spec):
        if entry_axes(entry) and _size(entry, mesh) > 1:
            y = all_gather(y, entry, dim=i, tiled=True, mesh=mesh)
    return y


def distribute(x: torch.Tensor, spec, mesh) -> DTensor:
    """The global tensor ``x`` (the same on every rank) as a ``DTensor``
    laid out by ``spec``: each rank keeps its block, no communication."""
    spec = P(*spec) + P(*(None,) * (x.dim() - len(spec)))
    return from_local(local_block(x, spec, mesh).clone(), spec, mesh)


def from_local(local: torch.Tensor, spec, mesh) -> DTensor:
    """A ``DTensor`` of this rank's block ``local`` under ``spec``."""
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False)


def redistribute(x, spec) -> DTensor:
    """A ``DTensor`` laid out anew by ``spec``: by ``DTensor.redistribute``
    on a mesh with a process group per dim, else gathered, then each
    rank's block taken.  A pending partial sum (a ``DTensor`` op's ``Partial``
    output, which only a mesh with a process group per dim makes) is
    reduced first."""
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    if spec_of(x) == tuple(spec) + (None,) * (x.dim() - len(spec)):
        return x
    if _dim_groups(x.device_mesh):
        # DTensor's own move: differentiable, and only what the new layout
        # needs (a local slice where a replicated dim is split).
        spec = P(*spec) + P(*(None,) * (x.dim() - len(spec)))
        return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))
    return distribute(gather(x), spec, x.device_mesh)


def _dim_groups(mesh) -> bool:
    """The mesh holds a process group per dim (``init_device_mesh``; the
    dry run's meshes do, :func:`repro_torch.launch.mesh.make_mesh`'s do
    not: this module builds its own groups for those)."""
    try:
        mesh.get_group(0)
    except RuntimeError:
        return False
    return True


# ---------------------------------------------------------------------------
# Groups and collectives
# ---------------------------------------------------------------------------

def _group(axes, mesh):
    """(process group, its ranks in group order) of this rank's line
    along ``axes``."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    idx = _check_order(mesh, axes)
    with unset_fake_temporarily():     # the ranks are host data, never fake
        grid = mesh.mesh
        key = (tuple(grid.shape), tuple(grid.flatten().tolist()),
               tuple(mesh.mesh_dim_names), axes)
        rest = [d for d in range(grid.dim()) if d not in idx]
        n = math.prod(grid.shape[d] for d in idx)
        lines = grid.permute(*rest, *idx).reshape(-1, n).tolist()
    if key not in _GROUPS:
        me = dist.get_rank()
        mine = None
        for line in lines:          # every rank builds every line
            g = dist.new_group(line)
            if me in line:
                mine = (g, line)
        _GROUPS[key] = mine
    return _GROUPS[key]


def _native(op: str, group, t: torch.Tensor) -> bool:
    if dist.get_backend(group) != "gloo":
        return True
    if _FORCE_COMPOSED.get():
        return False
    return not t.is_cuda or op in GLOO_CUDA_OPS


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _slots_sum(slots: dict[int, torch.Tensor], n: int, like: torch.Tensor,
               group) -> torch.Tensor:
    """(n, *like.shape): slot ``i`` holds ``slots[i]`` where this rank
    writes it, and the one writer's bytes of every other rank's slots
    after the sum (the composed collectives' one ``all_reduce``)."""
    nb = like.numel() * like.element_size()
    buf = torch.zeros((n, nb), dtype=torch.uint8, device=like.device)
    for i, v in slots.items():
        buf[i] = _bytes(v)
    dist.all_reduce(buf, group=group)
    return buf.view(like.dtype).reshape((n,) + tuple(like.shape))


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    mesh = mesh or _MESH.get()
    g, _ = _group(_axes(axes), mesh)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=g)
    return y


def pmax(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    mesh = mesh or _MESH.get()
    g, _ = _group(_axes(axes), mesh)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=g)
    return y


def pmean(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    mesh = mesh or _MESH.get()
    return psum(x, axes, mesh) / _size(axes, mesh)


def all_gather(x: torch.Tensor, axes, *, dim: int = 0, tiled: bool = False,
               mesh=None) -> torch.Tensor:
    """Every rank's ``x`` along the mesh dims ``axes``, in group order:
    stacked on a new dim ``dim``, or concatenated along ``dim`` when
    ``tiled``."""
    mesh = mesh or _MESH.get()
    axes = _axes(axes)
    g, line = _group(axes, mesh)
    n = len(line)
    xt = x.movedim(dim, 0).contiguous() if tiled else x.contiguous()
    if _native("all_gather", g, x):
        out = torch.empty((n,) + tuple(xt.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, xt.unsqueeze(0), group=g)
    else:
        COMPOSED.add("all_gather")
        out = _slots_sum({axis_index(axes, mesh): xt}, n, xt, g)
    if tiled:
        return out.reshape((n * xt.shape[0],) + tuple(xt.shape[1:])
                           ).movedim(0, dim)
    return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, axes, *, split_axis: int, concat_axis: int,
               mesh=None) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` split in ``n`` blocks along
    ``split_axis``, block ``j`` sent to group rank ``j``; the blocks
    received concatenated along ``concat_axis`` in group order."""
    mesh = mesh or _MESH.get()
    axes = _axes(axes)
    g, line = _group(axes, mesh)
    n = len(line)
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    if _native("all_to_all", g, x):
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=g)
    else:
        COMPOSED.add("all_to_all")
        me = axis_index(axes, mesh)
        recv = _slots_sum({me: send}, n, send, g)[:, me]
    return torch.cat(list(recv.unbind(0)), dim=concat_axis)


def ppermute(x: torch.Tensor, axes, perm, mesh=None) -> torch.Tensor:
    """``x`` sent along the (source, destination) pairs of ``perm`` (group
    indices); a rank no pair sends to gets zeros.  Native: every send and
    receive of this rank in one ``batch_isend_irecv`` (a pair from a rank
    to itself included).  Gloo sends nothing to the sending rank itself,
    so a ``perm`` with such a pair takes the composed form there."""
    mesh = mesh or _MESH.get()
    axes = _axes(axes)
    g, line = _group(axes, mesh)
    n = len(line)
    me = axis_index(axes, mesh)
    to = [d for s, d in perm if s == me]
    frm = [s for s, d in perm if d == me]
    self_pair = any(s == d for s, d in perm)
    x = x.contiguous()
    if _native("ppermute", g, x) and not (
            self_pair and dist.get_backend(g) == "gloo"):
        out = torch.zeros_like(x)
        ops = [dist.P2POp(dist.isend, x, line[d], group=g) for d in to]
        ops += [dist.P2POp(dist.irecv, out, line[s], group=g) for s in frm]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out
    COMPOSED.add("ppermute")
    return _slots_sum({d: x for d in to}, n, x, g)[me].clone()


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

def _map_specs(fn: Callable, specs, tree: Any) -> Any:
    """``fn(leaf, spec)`` over ``tree``; ``specs`` is a prefix of it whose
    leaves are :class:`P` (a spec covers the whole subtree under it)."""
    if isinstance(specs, P):
        if isinstance(tree, dict):
            return {k: _map_specs(fn, specs, v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_map_specs(fn, specs, v) for v in tree)
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, specs[k], tree[k]) for k in specs}
    return type(specs)(_map_specs(fn, s, t) for s, t in zip(specs, tree))


def shard_map(fn: Callable, mesh, in_specs, out_specs) -> Callable:
    """``fn`` on each rank's local blocks; see the module docstring."""
    def to_local(x, spec):
        if x is None:
            return None
        if isinstance(x, DTensor):
            return redistribute(x, spec).to_local()
        return local_block(x, spec, mesh)

    def to_global(y, spec):
        return from_local(y, spec, mesh)

    def run(*args):
        local = _map_specs(to_local, tuple(in_specs), args)
        tok = _MESH.set(mesh)
        try:
            out = fn(*local)
        finally:
            _MESH.reset(tok)
        return _map_specs(to_global, out_specs, out)

    return run
