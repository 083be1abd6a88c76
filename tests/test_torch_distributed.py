"""The port's multi-device layer on real gloo worlds of 1-4 CPU ranks
against the JAX package on 8 forced host devices: the compressed psum and
error feedback, the explicit data-parallel step, the GPipe pipeline, the
block order of a spec, the elastic restore of a sharded state onto other
meshes (and checkpoints across both packages), and each collective's
composed gloo form against the native one.

The reference side runs once for the file in a subprocess started with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_moe_distributed.py`` runs it) and writes its outputs to an
``.npz``.  The port's ranks run the functions of ``tests/_torch_ranks.py``
through ``spawn_host_world`` (60 s process-group timeout, 180 s wall
limit).  Inputs come from numpy seeds.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from torch.distributed.device_mesh import DeviceMesh

from repro.train import checkpoint as ref_ckpt
from repro_torch import collectives as coll
from repro_torch.launch.mesh import spawn_host_world
from repro_torch.models import tree
from repro_torch.sharding import P
from repro_torch.train import checkpoint as ckpt_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = [(("pod", "data"), "model"), (None, ("data", "model")),
         ("model", "pod"), (("pod", "data", "model"),), ("data",)]
GSHAPE = (16, 8)

_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import compat
    from repro.train import compression, pipeline_par
    from repro.train import optimizer as opt_lib

    inp = np.load(sys.argv[2])
    devs = np.array(jax.devices())
    res = {}
    mesh4 = Mesh(devs[:4], ("data",))

    def f(gl, el):
        s = compression.compressed_psum(gl[0], "data")
        red, ne = compression.ErrorFeedback.apply(
            {"w": gl[0]}, {"w": el[0]}, "data", world=4)
        return s[None], red["w"][None], ne["w"][None]
    out = jax.jit(compat.shard_map(
        f, mesh=mesh4, in_specs=(P("data"), P("data")),
        out_specs=(P("data"),) * 3, check_vma=False))(inp["g"], inp["e"])
    res["psum"], res["red"], res["new_e"] = map(np.asarray, out)

    def loss_fn(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2), {}
    for compress in (True, False):
        opt = opt_lib.make("sgd", lr=0.2, momentum=0.9)
        params = {"w": jnp.zeros((4, 8))}
        state = {"params": params, "opt": opt.init(params),
                 "step": jnp.asarray(0, jnp.int32),
                 "residual": compression.ErrorFeedback.init(params, world=4)}
        step = jax.jit(compression.build_manual_dp_step(
            loss_fn, opt, mesh4, compress=compress))
        losses = []
        for x in inp["xs"]:
            b = {"x": jnp.asarray(x), "y": jnp.asarray(x) @ jnp.ones((4, 8))}
            losses.append(float(loss_fn(state["params"], b)[0]))
            state = step(state, b)
        res[f"dp_losses_{compress}"] = np.asarray(losses)
        res[f"dp_w_{compress}"] = np.asarray(state["params"]["w"])

    layer = lambda w, h: jnp.tanh(h @ w)
    res["pipe4"] = np.asarray(pipeline_par.pipeline_apply(
        layer, inp["ws"], inp["xp"], mesh=Mesh(devs[:4], ("pod",)),
        axis="pod", microbatches=8))
    res["pipe1"] = np.asarray(pipeline_par.pipeline_apply(
        layer, inp["ws"], inp["xp"], mesh=Mesh(devs[:1], ("pod",)),
        axis="pod", microbatches=2))

    mesh8 = Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))
    specs = [tuple(tuple(e) if isinstance(e, list) else e for e in s)
             for s in eval(sys.argv[3])]
    shape = tuple(eval(sys.argv[4]))
    blocks = []
    for spec in specs:
        idx = NamedSharding(mesh8, P(*spec)).devices_indices_map(shape)
        blocks.append([[(sl.start or 0, shape[i] if sl.stop is None
                         else sl.stop) for i, sl in enumerate(idx[d])]
                       for d in mesh8.devices.flat])
    res["blocks"] = np.asarray(blocks)
    np.savez(sys.argv[1], **res)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rng = np.random.default_rng(0)
    inp = {"g": rng.normal(size=(4, 64)).astype(np.float32),
           "e": (rng.normal(size=(4, 64)) * 0.01).astype(np.float32),
           "xs": rng.normal(size=(120, 8, 4)).astype(np.float32),
           "ws": (rng.normal(size=(8, 8, 8)) * 0.3).astype(np.float32),
           "xp": rng.normal(size=(16, 8)).astype(np.float32)}
    d = tmp_path_factory.mktemp("ref_dist")
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(d / "out.npz"),
         str(d / "in.npz"), repr(SPECS), repr(GSHAPE)],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    return inp, dict(np.load(d / "out.npz"))


def test_compressed_psum_and_error_feedback_match_reference(ref):
    inp, want = ref
    out = spawn_host_world(ranks.compression_rank, 4,
                           args=(inp["g"], inp["e"]))
    for r, (psum_all, red, new_e) in enumerate(out):
        # Every rank holds the same compressed sum.
        for row in psum_all:
            np.testing.assert_allclose(row, want["psum"][r], rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(red, want["red"][r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(new_e, want["new_e"][r], rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(out[0][0][0], inp["g"].sum(0), atol=0.1)


@pytest.mark.parametrize("compress", [True, False])
def test_manual_dp_step_matches_reference_and_trains(ref, compress):
    inp, want = ref
    out = spawn_host_world(ranks.manual_dp_rank, 4,
                           args=(inp["xs"], compress, 4))
    losses, w = out[0]
    np.testing.assert_allclose(losses[:20], want[f"dp_losses_{compress}"][:20],
                               rtol=1e-5, atol=1e-5)
    # int8-compressed reduction with error feedback converges as the
    # reference's test requires.
    assert losses[-1] < 0.1 * losses[0], (losses[0], losses[-1])
    for _, w_r in out[1:]:
        np.testing.assert_array_equal(w_r, w)        # replicas stay equal
    if not compress:
        np.testing.assert_allclose(w, want["dp_w_False"], rtol=1e-5,
                                   atol=1e-5)


def _sequential(ws, x):
    h = torch.from_numpy(x)
    for w in torch.from_numpy(ws):
        h = torch.tanh(h @ w)
    return h.numpy()


@pytest.mark.parametrize("stages,micro", [(4, 8), (1, 2)])
def test_pipeline_matches_reference_and_the_sequential_stack(ref, stages,
                                                             micro):
    inp, want = ref
    out = spawn_host_world(ranks.pipeline_rank, stages,
                           args=(inp["ws"], inp["xp"], stages, micro))
    seq = _sequential(inp["ws"], inp["xp"])
    for got, composed in out:
        np.testing.assert_allclose(got, want[f"pipe{stages}"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got, seq, rtol=1e-5, atol=1e-5)
        # One stage sends to itself: gloo carries no such send, so the
        # ring takes the composed form; four stages go native.
        assert composed == (["ppermute"] if stages == 1 else [])


def test_local_blocks_follow_jax_device_order(ref):
    """On a ("pod", "data", "model") mesh, every rank's block under each
    spec is the block JAX gives the device at the same coordinates (the
    mesh of each rank built without a world: a block needs no
    communication)."""
    _, want = ref
    idx = torch.arange(int(np.prod(GSHAPE))).reshape(GSHAPE)
    for r in range(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                          mesh_dim_names=("pod", "data", "model"),
                          _init_backend=False, _rank=r)
        for s, spec in enumerate(SPECS):
            blk = coll.local_block(idx, P(*spec), mesh)
            start = np.unravel_index(int(blk.reshape(-1)[0]), GSHAPE)
            got = [(int(a), int(a) + n) for a, n in zip(start, blk.shape)]
            assert [tuple(b) for b in want["blocks"][s][r]] == got, (spec, r)


def test_composed_collectives_equal_the_native_ones():
    out = spawn_host_world(ranks.collectives_rank, 4)
    for same, composed in out:
        assert all(same.values()), same
        assert composed == ["all_gather", "all_to_all", "ppermute"]


def test_sharded_state_resumes_elastically_onto_other_meshes(tmp_path):
    """A (2, 2) sharded train state, saved, then ``resume_elastic`` onto a
    (1, 2) mesh and onto world 1: every leaf bit-equal."""
    d = str(tmp_path / "ckpt")
    sharded = spawn_host_world(ranks.save_sharded_rank, 4, args=(d, (2, 2)))
    assert sharded[0] > 0
    for world, shape in [(2, (1, 2)), (1, (1, 1))]:
        for equal, event, n in spawn_host_world(ranks.resume_rank, world,
                                                args=(d, shape)):
            assert equal and n > 10
            assert event == ("elastic_resume", 7)
    # The reference restores the port's sharded checkpoint.
    _, state = ranks.ckpt_state()
    got, step = ref_ckpt.restore(d, _abstract(state))
    assert step == 7
    for (name, leaf), ref_leaf in zip(ckpt_lib._tree_paths(state),
                                      jax.tree.leaves(got)):
        want = ckpt_lib._host(leaf)[0]
        np.testing.assert_array_equal(np.asarray(ref_leaf).view(want.dtype),
                                      want, err_msg=name)


def _abstract(state):
    """The reference's abstract tree of a port state (bf16 as JAX's)."""
    import jax.numpy as jnp

    def one(t):
        dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else \
            np.dtype(str(t.dtype).replace("torch.", ""))
        return jax.ShapeDtypeStruct(tuple(t.shape), dt)
    return tree.tree_map(one, state)


def test_reference_checkpoint_restores_onto_a_port_mesh(tmp_path):
    """A state saved by the reference, restored onto a (1, 2) port mesh
    with ``resume_elastic``: every leaf bit-equal to the state it saved."""
    _, state = ranks.ckpt_state()
    ref_state = tree.tree_map(
        lambda t: jax.numpy.asarray(ckpt_lib._host(t)[0]).view(
            jax.numpy.bfloat16) if t.dtype == torch.bfloat16
        else jax.numpy.asarray(t.detach().numpy()), state)
    d = str(tmp_path / "ref_ckpt")
    ref_ckpt.save(d, ref_state, 7)
    out = spawn_host_world(ranks.resume_rank, 2, args=(d, (1, 2)))
    for equal, event, n in out:
        assert equal and n > 10 and event == ("elastic_resume", 7)
