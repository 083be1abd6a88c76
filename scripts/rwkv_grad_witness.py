"""Which gradient of rwkv6-7b's training step is right: an f64 witness.

One seeded loss (random weights, a synthetic batch, ``--remat block``) is
differentiated five ways on one card:

  kernels               the port as it trains: both ``rwkv6_scan`` kernels
  plain                 both swapped for their plain PyTorch versions
  fwd kernel, bwd plain the forward kernel, the plain backward
  fwd plain, bwd kernel the plain forward, the backward kernel
  f64                   the same weights, every activation in f64, and the
                        recurrence an f64 loop that autograd differentiates
                        (no kernel, no hand-written backward)
  f64, scan rounded     the f64 witness with each scan's output rounded to
                        the model's dtype (the gradient passes straight):
                        how far one op's rounding moves the gradient
  f64, f32 scan kernels the f64 witness with each scan (forward and
                        backward) taken by the kernels on f32 inputs
  f64, f32 scan plain   the same through the plain versions
  exact scan            the model in its own dtype, each scan an f64 loop
                        (autograd's) whose output is rounded to that dtype

For each it prints the loss, the global gradient norm, each leaf's norm
and its distance to the f64 witness's (``|g - g64| / |g64|``, and the
largest element error over ``max(max|g64|, 1e-3 max|g64| anywhere)``,
chip_smoke.py 17f's measure), the gradient reaching the embedding's
output, position by position, and layer by layer at position 0 the
block's output against the witness's and the gradient reaching it.  The
f64 gradients are kept on the host.

    PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True PYTHONPATH=src \\
        python3 scripts/rwkv_grad_witness.py [--layers 32] [--seq 512] \\
        [--dtypes bfloat16 float32] [--json PATH]

(at full depth in f32 the card holds the weights and two gradients; the
allocator's expandable segments keep that from fragmenting).

``--smoke`` runs the smoke config on the CPU (the wrappers there are the
plain versions, so only the f64 path is exercised).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

from repro_torch import configs
from repro_torch.data.pipeline import synth_batch
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as rw
from repro_torch.models import rwkv, tree
from repro_torch.models.layers import rmsnorm
from repro_torch import runtime
from repro_torch.train import loss as loss_lib
from repro_torch.train import step as step_lib

F64 = torch.float64


def _bwd_plain(r, k, v, w, u, do, states=None):
    """The plain backward under the kernel's signature (it rebuilds S and
    does not read the forward's chunk states)."""
    return rw.rwkv6_scan_bwd_plain(r, k, v, w, u, do)


@contextlib.contextmanager
def swapped(names):
    """The named ``rwkv6`` wrappers swapped for their plain versions."""
    plain = {"rwkv6_scan_cuda": rw.rwkv6_scan_plain,
             "rwkv6_scan_bwd_cuda": _bwd_plain}
    saved = {n: getattr(rw, n) for n in names}
    try:
        for n in names:
            setattr(rw, n, plain[n])
        yield
    finally:
        for n, f in saved.items():
            setattr(rw, n, f)


def scan64(r, k, v, w, u, *, state0=None, return_state=False,
           round_to=None):
    """The RWKV-6 recurrence from zeros as an f64 loop, left to autograd.
    ``round_to``: the output rounded to that dtype, the gradient straight
    through."""
    if state0 is not None or return_state:
        raise ValueError("scan64: no state in or out")
    bh, t_len, d = r.shape
    r, k, v, w, u = (a.to(F64) for a in (r, k, v, w, u))
    uu = u.reshape(-1, d)
    uu = uu.repeat(bh // uu.shape[0], 1)
    s = torch.zeros((bh, d, d), dtype=F64, device=r.device)
    outs = []
    for t in range(t_len):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        outs.append(torch.bmm(rt[:, None], s)[:, 0]
                    + (rt * uu * kt).sum(-1, keepdim=True) * vt)
        s = w[:, t, :, None] * s + kt[:, :, None] * vt[:, None, :]
    out = torch.stack(outs, 1)
    if round_to is not None:
        out = out + (out.to(round_to).to(F64) - out).detach()
    return out


class _Scan32(torch.autograd.Function):
    """The scan on f32 copies of f64 inputs, by ``fwd`` and ``bwd`` (the
    ``rwkv6`` wrappers or their plain versions), widened back to f64."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, fwd, bwd, real_float):
        ins = [a.to(torch.float32) for a in (r, k, v, w, u)]
        with _float_as(real_float):
            out, states = fwd(*ins, return_chunk_states=True)
        ctx.save_for_backward(*ins, states)
        ctx.bwd, ctx.real_float = bwd, real_float
        return out.to(F64)

    @staticmethod
    def backward(ctx, g):
        *ins, states = ctx.saved_tensors
        with _float_as(ctx.real_float):
            grads = ctx.bwd(*ins, g.to(torch.float32), states)
        return tuple(x.to(F64) for x in grads) + (None, None, None)


@contextlib.contextmanager
def _float_as(fn):
    saved = torch.Tensor.float
    torch.Tensor.float = fn
    try:
        yield
    finally:
        torch.Tensor.float = saved


@contextlib.contextmanager
def in_f64(round_to=None, scan32=None):
    """The model's code run with every activation in f64: ``.float()``
    widens to f64, the embedding's output starts in f64 and the scan is
    :func:`scan64` (``scan32``: ``"kernels"`` or ``"plain"``, the scan
    in f32 instead, by :class:`_Scan32`).  The weights stay as they are
    (each product promotes them), so the gradients come back in the
    leaves' dtypes."""
    real_float, real_embed, real_scan = (torch.Tensor.float, rwkv._embed,
                                         ops.rwkv6_scan)

    def embed(params, cfg, tokens):
        emb = params["emb"]
        tokens = torch.as_tensor(tokens, device=emb.device).long()
        x = torch.nn.functional.embedding(tokens, emb).to(F64)
        return rmsnorm(params["ln0"], x, cfg.norm_eps)

    if scan32 is None:
        def scan(*a, **k):
            return scan64(*a, round_to=round_to, **k)
    else:
        fns = ((rw.rwkv6_scan_cuda, rw.rwkv6_scan_bwd_cuda)
               if scan32 == "kernels" and torch.cuda.is_available() else
               (rw.rwkv6_scan_plain, _bwd_plain))

        def scan(r, k, v, w, u, *, state0=None, return_state=False):
            if state0 is not None or return_state:
                raise ValueError("scan32: no state in or out")
            return _Scan32.apply(r, k, v, w, u, *fns, real_float)
    torch.Tensor.float = lambda self, *a, **k: self.to(F64)
    rwkv._embed = embed
    ops.rwkv6_scan = scan
    try:
        yield
    finally:
        torch.Tensor.float = real_float
        rwkv._embed = real_embed
        ops.rwkv6_scan = real_scan


@contextlib.contextmanager
def exact_scan():
    """Each scan of the model, in the model's own dtype, by :func:`scan64`
    and rounded back: the model's arithmetic with an exact recurrence."""
    real_scan = ops.rwkv6_scan
    ops.rwkv6_scan = lambda r, *a, **k: scan64(r, *a, **k).to(r.dtype)
    try:
        yield
    finally:
        ops.rwkv6_scan = real_scan


def leaf_names(params) -> list[str]:
    out = []

    def walk(t, pre):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], f"{pre}/{k}")
        else:
            out.append(pre)
    walk(params, "")
    return out


def loss_and_grads(params, leaves, cfg, batch):
    """The step's CE (no z-loss, no aux: rwkv has neither) and its
    gradient, with the embedding output's gradient a position."""
    seen = {"layers": [], "layer_grads": {}}
    real_embed, real_remat = rwkv._embed, rwkv.maybe_remat

    def remat(f):
        g = real_remat(f)

        def traced(x):
            y = g(x)
            i = len(seen["layers"])
            seen["layers"].append(y.detach()[0, 0].double().cpu())
            if y.requires_grad:
                y.register_hook(lambda gr: seen["layer_grads"].__setitem__(
                    i, float(gr[0, 0].double().norm())))
            return y
        return traced

    def embed(*a):
        x = real_embed(*a)
        if x.requires_grad:
            x.register_hook(lambda g: seen.__setitem__(
                "pos", g.double().norm(dim=-1)[0].cpu()))
        return x
    rwkv._embed, rwkv.maybe_remat = embed, remat
    try:
        with runtime.remat_policy("block"):
            logits = rwkv.rwkv_forward(params, cfg, batch["tokens"])["logits"]
            labels = batch["labels"]
            loss = torch.mean(loss_lib._ce(
                logits if logits.dtype == F64 else logits.float(), labels,
                0.0))
        del logits
        grads = step_lib._grad(loss, leaves)
    finally:
        rwkv._embed, rwkv.maybe_remat = real_embed, real_remat
    seen["layer_grads"] = [seen["layer_grads"][i]
                           for i in range(len(seen["layers"]))]
    return float(loss.detach()), [g.detach() for g in grads], seen


def _parts(g):
    """A leaf in slices along its layer axis (the stacked leaves are
    billions of elements: their f64 copies would not fit at once)."""
    return list(g) if g.dim() >= 3 else [g]


def variant(label, params, leaves, cfg, batch, ref, names):
    t0 = time.perf_counter()
    if label == "f64":
        ctx = in_f64()
    elif label == "f64, scan rounded":
        ctx = in_f64(getattr(torch, cfg.dtype))
    elif label == "exact scan":
        ctx = exact_scan()
    elif label.startswith("f64, f32 scan "):
        ctx = in_f64(scan32=label.rsplit(" ", 1)[1])
    else:
        ctx = swapped(names)
    before = ops.launch_counts()
    with ctx:
        loss, grads, seen = loss_and_grads(params, leaves, cfg, batch)
    pos = seen["pos"]
    launched = {n: c - before[n] for n, c in ops.launch_counts().items()
                if c - before[n]}
    norms = [math.sqrt(sum(float(x.double().square().sum())
                           for x in _parts(g))) for g in grads]
    row = {"loss": loss, "grad_norm": math.sqrt(sum(n * n for n in norms)),
           "launches": launched, "leaf_norms": norms,
           "pos_top": sorted(((float(v), i) for i, v in enumerate(pos)),
                             reverse=True)[:6],
           "pos_median": float(pos.median()), "seconds": None,
           "pos0_layer_grad": seen["layer_grads"]}
    if ref is not None:
        row["pos0_layer_rel_to_f64"] = [
            float((a - b).norm() / b.norm())
            for a, b in zip(seen["layers"], ref["layers"])]
        gmax = max(float(g.abs().max()) for g in ref["grads"])
        dist, elem, num, den = [], [], 0.0, 0.0
        for g, w in zip(grads, ref["grads"]):
            dd = ww = big = wmax = 0.0
            for gp, wp in zip(_parts(g), _parts(w)):
                wp = wp.to(gp.device, torch.float64)
                d = gp.double() - wp
                dd += float(d.square().sum())
                ww += float(wp.square().sum())
                big = max(big, float(d.abs().max()))
                wmax = max(wmax, float(wp.abs().max()))
                del wp, d
            num, den = num + dd, den + ww
            dist.append(math.sqrt(dd / max(ww, 1e-300)))
            elem.append(big / max(wmax, 1e-3 * gmax))
        row["rel_dist_to_f64"] = dist
        row["elem_err_to_f64"] = elem
        row["global_rel_dist_to_f64"] = math.sqrt(num / den)
        row["loss_rel_to_f64"] = abs(loss - ref["loss"]) / abs(ref["loss"])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    row["seconds"] = time.perf_counter() - t0
    row["layers_pos0"] = seen["layers"]
    return row, grads


# The variants beside the witness: the wrappers each swaps for its plain
# version (the f64 variants swap none).
VARIANTS = {
    "kernels": (),
    "plain": ("rwkv6_scan_cuda", "rwkv6_scan_bwd_cuda"),
    "fwd kernel, bwd plain": ("rwkv6_scan_bwd_cuda",),
    "fwd plain, bwd kernel": ("rwkv6_scan_cuda",),
    "f64, scan rounded": (),
    "f64, f32 scan kernels": (),
    "f64, f32 scan plain": (),
    "exact scan": (),
}


def run(arch_cfg, dtype, layers, seq, device, variants) -> dict:
    cfg = dataclasses.replace(arch_cfg, dtype=dtype, num_layers=layers)
    params = rwkv.init_rwkv(cfg, generator=torch.Generator(
        device=device).manual_seed(0), device=device)
    leaves = step_lib._trainable(params)
    names = leaf_names(params)
    batch = tree.tree_map(lambda a: tree.as_tensor(a, device), synth_batch(
        cfg, batch=1, seq=seq, step=0))
    out = {"dtype": dtype, "layers": layers, "seq": seq, "leaves": names,
           "variants": {}}
    row, grads = variant("f64", params, leaves, cfg, batch, None, ())
    ref = {"loss": row["loss"], "grads": [g.to("cpu") for g in grads],
           "layers": row.pop("layers_pos0")}
    del grads
    out["variants"]["f64"] = row
    print("    position 0, layer by layer: gradient reaching the output "
          + " ".join(f"{x:.3g}" for x in row["pos0_layer_grad"]), flush=True)
    print(f"[{dtype} L={layers} T={seq}] f64 loss {row['loss']} grad_norm "
          f"{row['grad_norm']} embedding-output gradient by position: top "
          f"{row['pos_top'][:3]} median {row['pos_median']:.3e} "
          f"({row['seconds']:.1f} s)", flush=True)
    for label in variants:
        row, grads = variant(label, params, leaves, cfg, batch, ref,
                             VARIANTS[label])
        row.pop("layers_pos0")
        del grads
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        out["variants"][label] = row
        worst = max(range(len(names)),
                    key=lambda i: row["elem_err_to_f64"][i])
        print(f"[{dtype} L={layers} T={seq}] {label}: loss {row['loss']} "
              f"grad_norm {row['grad_norm']} global |g-g64|/|g64| "
              f"{row['global_rel_dist_to_f64']:.3e} worst leaf "
              f"{names[worst]} elem err {row['elem_err_to_f64'][worst]:.3e}"
              f" launches {row['launches']} top positions "
              f"{row['pos_top'][:3]} ({row['seconds']:.1f} s)", flush=True)
        print("    position 0, layer by layer: output off the witness's "
              + " ".join(f"{x:.1e}" for x in row["pos0_layer_rel_to_f64"])
              + "; gradient reaching it "
              + " ".join(f"{x:.3g}" for x in row["pos0_layer_grad"]),
              flush=True)
    del params, leaves, ref
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[32])
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--json", default=None)
    a = ap.parse_args(argv)
    arch = configs.get("rwkv6-7b")
    if a.smoke:
        base, device = arch.smoke, torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        from repro_torch.kernels import build
        build.build_all()
        base, device = arch.config, torch.device("cuda")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    results = []
    for layers in a.layers:
        for dtype in a.dtypes:
            results.append(run(base, dtype, layers, a.seq, device,
                               a.variants))
            if device.type == "cuda":
                torch.cuda.empty_cache()
                results[-1]["peak_bytes"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            if a.json:
                with open(a.json, "w") as f:
                    json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
