"""The port's sharding rules and layouts (``repro_torch.sharding``,
``partition``, ``moe_param_specs``, ``state_shardings``, the production
mesh) against the JAX package's, with no process world.

The reference's spec functions read only a mesh's axis names and sizes, so
they run here on a stand-in mesh (``_RefMesh``) over abstract parameter
trees (``api.abstract_params``); the port's run on a ``MeshShape`` over meta
tensors of the same shapes, and on its own smoke-size init.  Specs are held
equal entry for entry (``tuple(PartitionSpec)``, which JAX normalises as
the port's ``P`` does).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro import configs as ref_configs
from repro import partition as ref_partition
from repro import sharding as ref_sharding
from repro.models import api as ref_api
from repro.models import moe as ref_moe
from repro.train import optimizer as ref_optimizer
from repro.train import step as ref_step
from repro_torch import configs, partition, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api, moe
from repro_torch.sharding import MeshShape, P
from repro_torch.train import optimizer, step

ARCHS = list(configs.ARCH_NAMES)
MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


class _RefMesh:
    """What the reference's spec functions read of a ``jax.sharding.Mesh``:
    ``axis_names``, ``shape`` (a dict) and ``devices.shape``."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.devices = np.empty(shape, dtype=np.int8)


class _RefNamed:
    """A stand-in for ``jax.sharding.NamedSharding`` on a ``_RefMesh``."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


def _meshes(shape, names):
    return _RefMesh(shape, names), MeshShape(shape, names)


def _ref_flat(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, (RP, _RefNamed)))[0]
    return {ref_partition._path_str(p): tuple(getattr(s, "spec", s))
            for p, s in flat}


def _port_flat(specs) -> dict:
    out = {}
    partition.map_with_path(
        lambda p, s: out.__setitem__(p, tuple(getattr(s, "spec", s))), specs)
    return out


def _meta(abstract):
    return jax.tree.map(lambda a: torch.empty(a.shape, device="meta"),
                        abstract)


def _cfgs(arch, **moe_kw):
    ref_cfg = ref_configs.get(arch).config
    cfg = configs.get(arch).config
    if moe_kw:
        ref_cfg = dataclasses.replace(
            ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe_kw))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return ref_cfg, cfg


# ---------------------------------------------------------------------------
# shard, the rule sets, the fit
# ---------------------------------------------------------------------------

def test_shard_is_a_no_op_without_a_context_and_on_local_tensors():
    x = torch.randn(2, 4, 8)
    assert sharding.shard(x, "batch", "seq", None) is x
    assert sharding.spec("batch") == P()
    m = MeshShape((2, 4), ("data", "model"))
    with sharding.use_rules(m, sharding.train_rules(m)):
        assert sharding.shard(x, "batch", "seq", None) is x
        assert sharding.current().mesh is m
    assert sharding.current() is None


@pytest.mark.parametrize("shape,names", MESHES)
def test_rule_sets_and_specs_match_reference(shape, names):
    ref_m, m = _meshes(shape, names)
    for ref_rules, rules in [
            (ref_sharding.train_rules(ref_m), sharding.train_rules(m)),
            (ref_sharding.train_rules(ref_m, fsdp=False, seq_shard=False),
             sharding.train_rules(m, fsdp=False, seq_shard=False)),
            (ref_sharding.serve_rules(ref_m, seq_shard=True),
             sharding.serve_rules(m, seq_shard=True)),
            (ref_sharding.edge_rules(ref_m), sharding.edge_rules(m))]:
        assert rules == ref_rules
        ref_ctx = ref_sharding.ShardCtx(ref_m, ref_rules)
        ctx = sharding.ShardCtx(m, rules)
        for logical in [("batch", "seq", None), ("batch", "heads", None, None),
                        ("batch", None, "vocab"), ("fsdp", "mlp"),
                        ("zero", "batch"), ("seq", "embed", "heads")]:
            assert tuple(ctx.spec(*logical)) == tuple(
                ref_ctx.spec(*logical)), logical
    assert sharding.dp_axes(m) == ref_sharding.dp_axes(ref_m)


@pytest.mark.parametrize("shape,names", MESHES)
def test_divisibility_fallback_matches_reference(shape, names):
    ref_m, m = _meshes(shape, names)
    dp = sharding.dp_axes(m)
    for dims in [(32, 7, 4096), (1, 16, 256), (2, 3, 5), (512, 16, 16)]:
        for entries in [(dp, "model", None), ("model", dp, None),
                        (None, None, "model"), (dp + ("model",), None, None)]:
            want = ref_partition._fit_spec(dims, entries, ref_m)
            assert tuple(partition._fit_spec(dims, entries, m)) == tuple(
                want), (dims, entries)


# ---------------------------------------------------------------------------
# Parameter and cache layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,impl", [(a, None) for a in ARCHS]
                         + [("deepseek_v3_671b", "a2a")])
def test_param_specs_match_reference(arch, impl):
    """Every published config (and deepseek's a2a layout), both regimes,
    every mesh shape, leaf for leaf."""
    ref_cfg, cfg = _cfgs(arch, **({"impl": impl} if impl else {}))
    abstract = ref_api.abstract_params(ref_cfg)
    meta = _meta(abstract)
    for shape, names in MESHES:
        ref_m, m = _meshes(shape, names)
        for regime in ("train", "serve"):
            want = _ref_flat(ref_partition.param_specs(
                abstract, ref_cfg, ref_m, regime=regime))
            got = _port_flat(partition.param_specs(meta, cfg, m,
                                                   regime=regime))
            assert got == want, (shape, regime)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_of_the_ports_own_init(arch):
    """The port's smoke init has the reference's paths and shapes, so its
    specs are the reference's on the smoke config's abstract tree."""
    ref_cfg = ref_configs.get(arch).smoke
    cfg = configs.get(arch).smoke
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    abstract = ref_api.abstract_params(ref_cfg)
    for shape, names in MESHES[:3]:
        ref_m, m = _meshes(shape, names)
        want = _ref_flat(ref_partition.param_specs(abstract, ref_cfg, ref_m))
        assert _port_flat(partition.param_specs(params, cfg, m)) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_state = ref_api.decode_state_specs(ref_cfg, 32, 4096)
    state = api.decode_state_specs(cfg, 32, 4096)
    for shape, names in MESHES:
        ref_m, m = _meshes(shape, names)
        want = _ref_flat(ref_partition.cache_specs(ref_state, ref_m))
        assert _port_flat(partition.cache_specs(state, m)) == want, shape


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "deepseek_v3_671b"])
def test_moe_param_specs_match_reference(arch):
    """EP where the experts divide the model dim, TP where they do not
    (mixtral's 8 over 3 or 16)."""
    ref_cfg, cfg = _cfgs(arch)
    for shape, names in MESHES + [((1, 3), ("data", "model")),
                                  ((2, 2, 2), ("pod", "data", "model"))]:
        ref_m, m = _meshes(shape, names)
        want = {k: (tuple(v) if isinstance(v, RP) else
                    {kk: tuple(vv) for kk, vv in v.items()})
                for k, v in ref_moe.moe_param_specs(ref_cfg, ref_m).items()}
        got = {k: (tuple(v) if isinstance(v, P) else
                   {kk: tuple(vv) for kk, vv in v.items()})
               for k, v in moe.moe_param_specs(cfg, m).items()}
        assert got == want, shape


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgd"])
def test_state_shardings_follow_the_references_moments(opt_name,
                                                       monkeypatch):
    """Moments take their param's layout (Adafactor's factored slots less
    the reduced dim), the rest and ``step`` are replicated."""
    monkeypatch.setattr(jax.sharding, "NamedSharding", _RefNamed)
    monkeypatch.setattr(ref_partition, "NamedSharding", _RefNamed)
    ref_cfg = ref_configs.get("gemma2_2b").smoke
    cfg = configs.get("gemma2_2b").smoke
    ref_opt = ref_optimizer.make(opt_name)
    ref_state = jax.eval_shape(
        lambda k: {"params": ref_api.init(ref_cfg, k),
                   "opt": ref_opt.init(ref_api.init(ref_cfg, k)),
                   "step": jnp.zeros((), jnp.int32)},
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = step.train_state(params, optimizer.make(opt_name))
    for shape, names in MESHES[:3] + [((2, 2, 2), ("pod", "data", "model"))]:
        ref_m, m = _meshes(shape, names)
        want = _ref_flat(ref_step.state_shardings(ref_state, ref_cfg, ref_m))
        got = _port_flat(step.state_shardings(state, cfg, m))
        assert got == want, shape
        assert any(v for k, v in got.items() if k.startswith("opt/")), shape


def test_production_mesh_refuses_a_small_world():
    with pytest.raises(ValueError, match="256"):
        mesh_lib.make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        mesh_lib.make_production_mesh(multi_pod=True)


def test_spec_to_placements_keeps_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch import collectives as coll
    m = MeshShape((2, 2, 2), ("pod", "data", "model"))
    assert coll.placements(P(("pod", "data"), "model"), m) == [
        Shard(0), Shard(0), Shard(1)]
    assert coll.placements(P(None, ("data", "model")), m) == [
        Replicate(), Shard(1), Shard(1)]
    with pytest.raises(ValueError, match="mesh's order"):
        coll.placements(P(("model", "pod")), m)
