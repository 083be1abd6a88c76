"""Rank functions of the port's multi-process tests: each runs on one rank
of a world started by ``repro_torch.launch.mesh.spawn_host_world`` and
returns numpy arrays.  This module imports ``torch`` and the port only, so
a spawned rank does not import JAX."""

import numpy as np
import torch

from repro_torch import collectives as coll
from repro_torch import configs, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api, moe, tree
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.sharding import P
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import compression, fault, optimizer, pipeline_par
from repro_torch.train import step as step_lib


def _np(t):
    return t.detach().float().numpy()


def compression_rank(rank, g, e):
    """compressed_psum of g and ErrorFeedback.apply of (g, e) over a
    4-rank ``data`` mesh; g, e: (4, n), row r on rank r."""
    mesh = mesh_lib.make_mesh((4,), ("data",))

    def f(gl, el):
        return (coll.all_gather(compression.compressed_psum(gl[0], "data"),
                                "data"),) + compression.ErrorFeedback.apply(
            {"w": gl[0]}, {"w": el[0]}, "data", world=4)

    out = coll.shard_map(f, mesh, (P("data"), P("data")),
                         (P(), P(), P()))(torch.from_numpy(g),
                                          torch.from_numpy(e))
    psum_all, red, new_e = out
    return (_np(psum_all.to_local()), _np(red["w"].to_local()),
            _np(new_e["w"].to_local()))


def _toy_loss(p, batch):
    pred = batch["x"] @ p["w"]
    return torch.mean((pred - batch["y"]) ** 2), {}


def manual_dp_rank(rank, xs, compress, world):
    """The reference's toy regression through ``build_manual_dp_step``
    over a ``world``-rank ``data`` mesh; the loss of the whole batch
    before each step, and the final params."""
    mesh = mesh_lib.make_mesh((world,), ("data",))
    opt = optimizer.make("sgd", lr=0.2, momentum=0.9)
    params = {"w": torch.zeros((4, 8))}
    state = step_lib.train_state(params, opt)
    state["residual"] = compression.ErrorFeedback.init(
        params, world=world, mesh=mesh, dp_axis="data")
    step = compression.build_manual_dp_step(_toy_loss, opt, mesh,
                                            compress=compress)
    losses = []
    for x in xs:
        x = torch.from_numpy(x)
        batch = {"x": x, "y": x @ torch.ones((4, 8))}
        with torch.no_grad():
            losses.append(float(_toy_loss(state["params"], batch)[0]))
        state = step(state, batch)
    return np.asarray(losses), _np(state["params"]["w"])


def pipeline_rank(rank, ws, x, stages, micro):
    mesh = mesh_lib.make_mesh((stages,), ("pod",))
    out = pipeline_par.pipeline_apply(
        lambda w, h: torch.tanh(h @ w), torch.from_numpy(ws),
        torch.from_numpy(x), mesh=mesh, axis="pod", microbatches=micro)
    return _np(out), sorted(coll.COMPOSED)


def collectives_rank(rank):
    """Each op in its native and its composed form on a (2, 2) mesh."""
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))
    gen = torch.Generator().manual_seed(rank)
    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        x = (torch.randn(4, 6, generator=gen) * 100).to(dt)
        ops = {
            "all_gather_model": lambda: coll.all_gather(
                x, "model", dim=1, tiled=True, mesh=mesh),
            "all_gather_all": lambda: coll.all_gather(
                x, ("data", "model"), dim=0, mesh=mesh),
            "all_to_all": lambda: coll.all_to_all(
                x, ("data", "model"), split_axis=0, concat_axis=1,
                mesh=mesh),
            "ppermute": lambda: coll.ppermute(
                x, ("data", "model"), [(0, 2), (2, 1), (1, 3), (3, 0)],
                mesh=mesh),
            "ppermute_partial": lambda: coll.ppermute(
                x, "model", [(0, 1)], mesh=mesh),
        }
        for name, fn in ops.items():
            native = fn()
            with coll.force_composed():
                composed = fn()
            out[f"{name}_{dt}"] = bool(
                native.dtype == composed.dtype
                and native.shape == composed.shape
                and torch.equal(native, composed))
    return out, sorted(coll.COMPOSED)


# ---------------------------------------------------------------------------
# Checkpoints across meshes
# ---------------------------------------------------------------------------

CKPT_ARCH = "gemma2_2b"


def ckpt_state():
    """A smoke gemma2-2b train state (AdamW), the same on every rank."""
    cfg = configs.get(CKPT_ARCH).smoke
    params = api.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    state = step_lib.train_state(params, optimizer.make("adamw"), step=7)
    with torch.no_grad():
        for leaf in tree.leaves(state["opt"]):
            if leaf.is_floating_point():
                leaf.normal_(generator=torch.Generator().manual_seed(4))
    return cfg, state


def _laid_out(state, cfg, mesh):
    sh = step_lib.state_shardings(state, cfg, mesh)
    return tree.tree_map(
        lambda t, s: coll.distribute(t.detach(), s.spec, s.mesh), state, sh)


def save_sharded_rank(rank, ckpt_dir, shape):
    cfg, state = ckpt_state()
    mesh = mesh_lib.make_mesh(shape, ("data", "model"))
    laid = _laid_out(state, cfg, mesh)
    sharded = sum(1 for t in tree.leaves(laid)
                  if t.to_local().numel() < t.numel())
    ckpt_lib.save(ckpt_dir, laid, 7)
    return sharded


def resume_rank(rank, ckpt_dir, shape, want=None):
    """``resume_elastic`` onto a ``shape`` mesh; whether every gathered
    leaf equals ``want`` (default: :func:`ckpt_state`), bit for bit."""
    cfg, state = ckpt_state()
    if want is not None:
        state = want
    mesh = mesh_lib.make_mesh(shape, ("data", "model"))
    sh = step_lib.state_shardings(state, cfg, mesh)
    like = tree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    drv = fault.TrainDriver(fault.DriverConfig(ckpt_dir=ckpt_dir),
                            step_fn=None, batch_fn=None,
                            state=tree.tree_map(lambda t: t.detach(), state))
    got = drv.resume_elastic(like, sh)
    equal = tree.leaves(tree.tree_map(
        lambda a, b: bool(torch.equal(coll.gather(a), b.detach())),
        got, state))
    return all(equal), drv.events[-1], len(equal)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_cases_rank(rank, shape, cases):
    """``moe_block`` under the train rules on a ``shape`` mesh for each
    (name, MoE config fields, params, x) case; ({name: y}, {name: the
    mesh dims of each weight gather}, the composed collectives)."""
    mesh = mesh_lib.make_mesh(shape, ("data", "model"))
    out, gathers = {}, {}
    real = coll.all_gather

    def counted(x, axes, **kw):
        gathers[name].append(axes)
        return real(x, axes, **kw)
    coll.all_gather = counted
    try:
        for name, moe_kw, p, x in cases:
            cfg = ModelConfig(
                name="t", family="transformer", num_layers=1, d_model=32,
                num_heads=4, num_kv_heads=4, head_dim=8, d_ff=64,
                vocab_size=64, dtype="float32", moe=MoEConfig(**moe_kw))
            pt = tree.tree_map(torch.from_numpy, p)
            gathers[name] = []
            with sharding.use_rules(mesh, sharding.train_rules(mesh)):
                y, _ = moe.moe_block(pt, torch.from_numpy(x), cfg)
            out[name] = _np(y)
    finally:
        coll.all_gather = real
    return out, gathers, sorted(coll.COMPOSED)
