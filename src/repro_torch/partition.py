"""Parameter and decode-state partitioning: path pattern -> spec.

Port of the JAX package's ``partition.py``, rule for rule:

* train regime: TP over ``model`` on the "wide" dim + FSDP over the DP
  dims on the opposite dim (optimizer moments follow their params,
  :func:`repro_torch.train.step.state_shardings`);
* serve regime: TP only (weights replicated over DP).

Patterns are matched against the ``/``-joined param path, as the
reference's ``_path_str`` joins it, so its regexes carry over unchanged;
the spec applies to the LAST dims named in the pattern (leading stack dims
get ``None``).  Dims that do not divide the mapped mesh dims fall back to
``None``: one rule table serves every arch x mesh cell.  The functions read
only leaf shapes (``meta`` tensors will do) and the mesh's dim names and
sizes (a ``MeshShape`` will do).
"""

from __future__ import annotations

import re
from typing import Any, Callable

from repro_torch import sharding as shlib
from repro_torch.sharding import NamedSharding, P, axis_sizes

# (path regex, spec for trailing dims).  "dp" is replaced by the DP dims,
# "tp" by the model dim.  First match wins.
_TRAIN_RULES: list[tuple[str, tuple]] = [
    # MoE expert banks (E, D, F) / (E, F, D): EP on E when divisible, else
    # the "tp" layout.
    (r"moe/w_(gate|up)$", ("ep", "dp", "tp_if_no_ep")),
    (r"moe/w_down$", ("ep", "tp_if_no_ep", "dp")),
    (r"moe/router(_bias)?$", (None, None)),
    (r"moe/shared/w_(gate|up)$", ("dp", "tp")),
    (r"moe/shared/w_down$", ("tp", "dp")),
    # MLA
    (r"attn/wdq$", ("dp", "tp")),
    (r"attn/wuq$", ("dp", "tp")),
    (r"attn/wdkv$", ("dp", None)),
    (r"attn/wukv$", ("dp", "tp")),
    # Attention projections
    (r"attn/w[qkv]$", ("dp", "tp")),
    (r"x?attn/w[qkv]$", ("dp", "tp")),
    (r"attn/wo$", ("tp", "dp")),
    (r"x?attn/wo$", ("tp", "dp")),
    (r"attn/b[qkv]$", (None,)),
    # MLP
    (r"mlp/w_(gate|up)$", ("dp", "tp")),
    (r"mlp/w_down$", ("tp", "dp")),
    # RWKV
    (r"tmix/w[rkvg]$", ("dp", "tp")),
    (r"tmix/wo$", ("tp", "dp")),
    (r"cmix/wk$", ("dp", "tp")),
    (r"cmix/wv$", ("tp", "dp")),
    (r"cmix/wr$", ("dp", "tp")),
    # Griffin
    (r"rec/w_[xy]$", ("dp", "tp")),
    (r"rec/w_[ai]$", ("dp", "tp")),
    (r"rec/w_out$", ("tp", "dp")),
    (r"rec/conv$", (None, "tp")),
    # Embeddings: vocab over model only.
    (r"(^|/)emb$", ("tp", None)),
    (r"(^|/)unemb$", (None, "tp")),
    (r"(^|/)pos_emb$", (None, None)),
    (r"mtp/proj$", ("dp", "tp")),
]


def map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a nested dict/list tree, the path
    ``/``-joined (list items by index)."""
    def path(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, path(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _resolve(entry, mesh, *, serve: bool, has_ep: bool):
    dp = shlib.dp_axes(mesh)
    names = tuple(mesh.mesh_dim_names)
    if entry is None:
        return None
    if entry == "dp":
        return None if serve or not dp else dp
    if entry == "tp":
        return "model" if "model" in names else None
    if entry == "ep":
        return "model" if has_ep and "model" in names else None
    if entry == "tp_if_no_ep":
        return None if has_ep else ("model" if "model" in names else None)
    return entry


def _fit_spec(shape: tuple, spec_entries: tuple, mesh) -> P:
    """Prepend None for leading stack dims; drop non-dividing dims."""
    n_lead = len(shape) - len(spec_entries)
    entries = ((None,) * max(n_lead, 0) + tuple(spec_entries))[:len(shape)]
    return shlib.fit_spec(tuple(shape), entries, mesh)


def param_specs(params, cfg, mesh, *, regime: str = "train"):
    """A tree of :class:`~repro_torch.sharding.P` matching ``params``."""
    serve = regime == "serve"
    sizes = axis_sizes(mesh)
    moe = getattr(cfg, "moe", None) if cfg is not None else None
    has_ep = (moe is not None and "model" in sizes
              and moe.num_experts % sizes["model"] == 0)
    a2a = moe is not None and getattr(moe, "impl", "") == "a2a"
    world = 1
    for n in sizes.values():
        world *= n
    ep2d = a2a and moe.num_experts % world == 0
    ep2d_axes = tuple(shlib.dp_axes(mesh)) + ("model",)

    def one(ps, leaf):
        shape = tuple(leaf.shape)
        # q8 leaves inherit the parent weight's spec; per-column scales
        # shard like the parent (their singleton dims drop in the fit).
        if ps.endswith("/q8") or (ps.endswith("/scale") and "ln" not in ps
                                  and "norm" not in ps and "/gn/" not in ps):
            ps = ps.rsplit("/", 1)[0]
        if ep2d and re.search(r"moe/w_(gate|up|down)$", ps):
            return _fit_spec(shape, (ep2d_axes, None, None), mesh)
        if a2a and "moe/shared" in ps:
            # a2a layout: the shared expert FSDP-sharded at rest, gathered
            # per layer inside the block.
            dp = shlib.dp_axes(mesh) or None
            if re.search(r"w_(gate|up)$", ps):
                return _fit_spec(shape, (None, dp), mesh)
            if ps.endswith("w_down"):
                return _fit_spec(shape, (dp, None), mesh)
        for pat, entries in _TRAIN_RULES:
            if re.search(pat, ps):
                resolved = tuple(
                    _resolve(e, mesh, serve=serve, has_ep=has_ep)
                    for e in entries)
                return _fit_spec(shape, resolved, mesh)
        return P()      # norms, biases, small vectors: replicated

    return map_with_path(one, params)


def param_shardings(params, cfg, mesh, *, regime: str = "train"):
    """:func:`param_specs` as :class:`~repro_torch.sharding.NamedSharding`s
    (``.placements`` gives each leaf's ``DTensor`` placements)."""
    return _named_tree(param_specs(params, cfg, mesh, regime=regime), mesh)


def _named_tree(specs, mesh):
    if isinstance(specs, P):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: _named_tree(v, mesh) for k, v in specs.items()}
    return type(specs)(_named_tree(v, mesh) for v in specs)


# Decode-state (KV cache / recurrent state) rules: batch over DP, heads over
# model where divisible.
_CACHE_RULES: list[tuple[str, tuple]] = [
    (r"(^|/)(k|v)$", (None, "dp", "tp", None, None)),        # (L,B,H,S,dh)
    (r"(^|/)x[kv]$", (None, "dp", "tp", None, None)),        # whisper cross
    (r"c_kv$", (None, "dp", None, None)),                    # MLA latent
    (r"k_rope$", (None, "dp", None, None, None)),
    (r"tmix/s$", (None, "dp", "tp", None, None)),            # rwkv state
    (r"(tmix|cmix)/prev$", (None, "dp", None, None)),
    (r"(^|/)conv$", (None, "dp", None, "tp")),               # griffin conv
    (r"(^|/)h$", (None, "dp", "tp")),                        # griffin lru
]


def cache_specs(state, mesh):
    """Specs for a decode-state tree."""
    sizes = axis_sizes(mesh)
    model_n = sizes.get("model", 1)

    def one(ps, leaf):
        shape = tuple(leaf.shape)
        for pat, entries in _CACHE_RULES:
            if re.search(pat, ps):
                # Cache rules are written for the full rank: trim from the
                # left.
                trim = entries[max(0, len(entries) - len(shape)):]
                resolved = tuple(_resolve(e, mesh, serve=False, has_ep=False)
                                 for e in trim)
                spec = _fit_spec(shape, resolved, mesh)
                # KV fallback: a head count that does not divide the model
                # dim shards the cache's sequence over it instead.
                if (re.search(r"(^|/)(k|v)$", ps) and len(shape) >= 4
                        and model_n > 1):
                    ent = list(spec) + [None] * (len(shape) - len(spec))
                    h_dim, s_dim = len(shape) - 3, len(shape) - 2
                    if ent[h_dim] is None and shape[s_dim] % model_n == 0:
                        ent[s_dim] = "model"
                        spec = P(*ent)
                return spec
        return P()

    return map_with_path(one, state)


def cache_shardings(state, mesh):
    return _named_tree(cache_specs(state, mesh), mesh)
