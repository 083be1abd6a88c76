#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final ``ok`` line:

1. the card, as ``nvidia-smi`` names it with its power limit;
2. build both CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
3. kernels: ``fused_mlp_q8`` on every edge net's fused group at batch 8 and
   on an odd shape, ``gemm_int8`` on every layer shape of the five nets and
   on 256 x 1024 x 1024, each held against its plain PyTorch version on the
   same inputs on the card;
4. serve: ``Deployment.build(["jet_tagger", "tau_select"])`` on the default
   device, ``serve()``, ``warmup()``, ``drive(iters=50)``; then every
   engine degraded to the per-layer rung and driven again.  The launch
   counters are zeroed just before and read just after: every served
   request must have launched ``fused_mlp_q8``, the degraded rung
   ``gemm_int8``.  The two rungs must agree, and the served outputs must
   match the plain path on the CPU with the same weights;
5. times with CUDA events at the served shapes: each kernel, its plain
   version and a library yardstick (``torch._int_mm`` plus the same
   epilogue), beside the least time the card could take and the time of an
   empty launch.

It prints one ``{"kernels": [...]}`` line, the card line again, and last
``{"ok": true, "device": {...}}``.  It needs no network and one card.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
NETS = ("jet_tagger", "tau_select", "vae", "qubit", "autoencoder")
SERVED = ("jet_tagger", "tau_select")
DRIVE_ITERS = 50
DEGRADED_ITERS = 5
# H100 SXM datasheet (not measured): device memory rate and dense int8 rate.
HBM_BW = 3.35e12
PEAK_INT8 = 1979e12
# The int8 side is exact and the f32 epilogue repeats the plain version's
# arithmetic in the same order, so kernel and plain agree bit for bit; the
# tolerance is the reference's own fused-vs-per-layer 1e-5.
TOL = 1e-5
# bf16 outputs: both sides round the same f32 value; allow one bf16 ulp.
TOL_BF16 = 2 ** -8

KERNEL_META = {
    "fused_mlp_q8": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_mlp_q8.cu",
        "replaces": "src/repro/kernels/fused_mlp.py:93"},
    "gemm_int8": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm_int8.cu",
        "replaces": "src/repro/kernels/gemm_int8.py:48"},
}


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check_close(what: str, got, want, *, tol: float = TOL) -> float:
    """Max abs error of ``got`` against ``want``; fails outside
    ``atol = rtol = tol``."""
    import torch
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise SmokeFailure(f"{what}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise SmokeFailure(f"{what}: non-finite output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise SmokeFailure(f"{what}: max abs err {err} beyond tol {tol}")
    return err


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def random_qparams(cfg, gen, device):
    import torch
    from repro_torch.models import edge
    params = edge.init_edge(cfg, generator=gen, device=device)
    calib = torch.randn((cfg.batch, cfg.dims[0]), generator=gen).to(device)
    return edge.quantize_edge(params, calib_x=calib, act=cfg.act)


def pack_net(qp, act_last=False):
    from repro_torch.kernels import ops
    return ops.pack_group([p["w_q"] for p in qp], [p["w_scale"] for p in qp],
                          [p["b"] for p in qp], [p["x_scale"] for p in qp],
                          act="relu", act_last=act_last)


def kernel_phase(device) -> dict:
    import torch
    from repro_torch.core import tiling
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import gemm_int8 as g8
    from repro_torch.kernels import ops
    from repro_torch.models import edge
    from repro_torch.plan import plan_deployment
    gen = torch.Generator().manual_seed(0)
    errs = {"fused_mlp_q8": 0.0, "gemm_int8": 0.0}

    def fused_case(what, x, g):
        err = check_close(what, fm.fused_mlp_q8_cuda(x, g),
                          fm.fused_mlp_q8_plain(x, g))
        errs["fused_mlp_q8"] = max(errs["fused_mlp_q8"], err)
        log(f"kernel fused_mlp_q8 {what}: max_abs_err={err} tol={TOL}")

    def gemm_case(what, x, w, sw, xs, blocks, out_dtype):
        got = g8.gemm_int8_cuda(x, w, sw, xs, block_m=blocks[0],
                                block_k=blocks[1], block_n=blocks[2],
                                out_dtype=out_dtype)
        want = g8.gemm_int8_plain(x, w, sw, xs, out_dtype=out_dtype)
        tol = TOL_BF16 if out_dtype == torch.bfloat16 else TOL
        err = check_close(what, got, want, tol=tol)
        if out_dtype == torch.float32:
            errs["gemm_int8"] = max(errs["gemm_int8"], err)
        log(f"kernel gemm_int8 {what} {str(out_dtype)[6:]} "
            f"blocks={blocks}: max_abs_err={err} tol={tol}")

    for name in NETS:
        cfg = edge.edge_config(name)
        qp = random_qparams(cfg, gen, device)
        x = torch.randn((cfg.batch, cfg.dims[0]), generator=gen).to(device)
        fused_case(f"{name} dims={list(cfg.dims)} M={cfg.batch}", x,
                   pack_net(qp))
        plan = plan_deployment(cfg, device=device)
        for i, (k, n) in enumerate(cfg.layer_shapes):
            xq = torch.randint(-127, 128, (cfg.batch, k), generator=gen,
                               dtype=torch.int8).to(device)
            for out_dtype in (torch.float32, torch.bfloat16):
                gemm_case(f"{name}.dense{i} ({cfg.batch},{k},{n})", xq,
                          qp[i]["w_q"], qp[i]["w_scale"],
                          qp[i]["x_scale"], plan.layer(i).api_tile,
                          out_dtype)
    # An odd group: ragged rows over two CTAs, widths off every multiple.
    dims = (19, 45, 7, 33)
    ws = [torch.randint(-127, 128, (a, b), generator=gen,
                        dtype=torch.int8).to(device)
          for a, b in zip(dims[:-1], dims[1:])]
    scs = [(torch.rand((b,), generator=gen) * 0.09 + 0.01).to(device)
           for b in dims[1:]]
    bs = [torch.randn((b,), generator=gen).to(device) for b in dims[1:]]
    x = torch.randn((13, dims[0]), generator=gen).to(device)
    for act_last in (False, True):
        g = ops.pack_group(ws, scs, bs, [0.03, 0.9, 40.0], act="relu",
                           act_last=act_last)
        fused_case(f"odd dims={list(dims)} M=13 act_last={act_last}", x, g)
    m, k, n = 256, 1024, 1024
    xq = torch.randint(-127, 128, (m, k), generator=gen,
                       dtype=torch.int8).to(device)
    w = torch.randint(-127, 128, (k, n), generator=gen,
                      dtype=torch.int8).to(device)
    sw = (torch.rand((n,), generator=gen) * 0.01).to(device)
    blocks = tiling.plan_api(m, k, n).blocks
    for out_dtype in (torch.float32, torch.bfloat16):
        gemm_case(f"multi-CTA ({m},{k},{n})", xq, w, sw, 0.02, blocks,
                  out_dtype)
    torch.cuda.synchronize(device)
    return errs


# ---------------------------------------------------------------------------
# Phase 4: the main path, through the entry points a user calls
# ---------------------------------------------------------------------------

def serve_phase():
    import torch
    from repro_torch.deploy import Deployment
    from repro_torch.kernels import ops
    from repro_torch.models import edge

    ops.reset_launches()
    dep = Deployment.build(list(SERVED))
    if dep.device.type != "cuda":
        raise SmokeFailure(f"default device is {dep.device}, not cuda")
    router = dep.serve()
    inputs = router.warmup()
    report = router.drive(inputs, iters=DRIVE_ITERS)
    fused_after_drive = ops.launch_counts()["fused_mlp_q8"]
    for eng in dep.engines.values():
        eng.degrade()
    degraded = router.drive(inputs, iters=DEGRADED_ITERS)
    # Both rungs on one input per tenant, then back to the fused rung.
    gen = torch.Generator().manual_seed(1)
    outputs = {}
    for nid, eng in dep.engines.items():
        x = torch.randn((eng.cfg.batch, eng.cfg.dims[0]),
                        generator=gen).to(dep.device)
        y_layer = eng.infer(x)
        eng.restore()
        y_fused = eng.infer(x)
        err = check_close(f"{nid} fused vs per-layer rung", y_fused, y_layer)
        log(f"serve {nid}: fused vs per-layer rung max_abs_err={err} "
            f"tol={TOL}")
        outputs[nid] = (x, y_fused)
    torch.cuda.synchronize(dep.device)
    launches = ops.launch_counts()

    log("serve report " + json.dumps(report, sort_keys=True))
    log("serve degraded report " + json.dumps(degraded, sort_keys=True))
    for nid in SERVED:
        if report[nid]["count"] != DRIVE_ITERS:
            raise SmokeFailure(f"{nid}: {report[nid]['count']} requests "
                               f"served, want {DRIVE_ITERS}")
        if degraded[nid]["count"] != DRIVE_ITERS + DEGRADED_ITERS:
            raise SmokeFailure(f"{nid}: degraded drive not counted")
    want_fused = len(SERVED) * (DRIVE_ITERS + 1)       # warmup + drive
    if fused_after_drive < want_fused:
        raise SmokeFailure(f"fused_mlp_q8 launched {fused_after_drive} "
                           f"times for {want_fused} fused requests")
    layers = sum(len(dep.plans[nid].layers) for nid in SERVED)
    if launches["gemm_int8"] < layers * DEGRADED_ITERS:
        raise SmokeFailure(f"gemm_int8 launched {launches['gemm_int8']} "
                           f"times on the degraded rung, want >= "
                           f"{layers * DEGRADED_ITERS}")
    log(f"serve launches {json.dumps(launches)} (fused after the fused "
        f"drive: {fused_after_drive})")

    # The served outputs against the plain path on the CPU, same weights.
    for nid, (x, y) in outputs.items():
        eng = dep.engines[nid]
        q_cpu = [{k: v.cpu() if torch.is_tensor(v) else v
                  for k, v in q.items()} for q in eng.qparams]
        y_cpu = edge.edge_forward_q8(q_cpu, eng.cfg, x.cpu(), plan=eng.plan)
        if y.shape != (eng.cfg.batch, eng.cfg.dims[-1]):
            raise SmokeFailure(f"{nid}: output shape {tuple(y.shape)}")
        err = check_close(f"{nid} card vs CPU plain path", y.cpu(), y_cpu)
        log(f"serve {nid}: card vs CPU plain path max_abs_err={err} "
            f"tol={TOL}")
    return dep, launches


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------

def event_ms(fn, *, inner: int = 50, reps: int = 21) -> float:
    """Median per-call time of ``inner`` back-to-back eager calls, by CUDA
    events: what a caller that launches from Python sees."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        samples.append(t0.elapsed_time(t1) / inner)
    return statistics.median(samples)


def graph_ms(fn, *, inner: int = 50, reps: int = 21) -> float:
    """Median per-call device time: ``inner`` calls captured in one CUDA
    graph and replayed, so host launch gaps drop out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        samples.append(t0.elapsed_time(t1) / inner)
    return statistics.median(samples)


def bound(bytes_moved: float, ops: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the int8
    rate, whichever is larger."""
    t_bytes, t_ops = bytes_moved / HBM_BW, ops / PEAK_INT8
    return {"bytes": bytes_moved, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _pad_to(t, rows: int, cols: int):
    import torch
    out = torch.zeros((rows, cols), dtype=t.dtype, device=t.device)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def library_chain(qp, act_last=False):
    """The fused group as library calls: per layer ``torch._int_mm`` (which
    wants M > 16 and K, N multiples of 8, so operands are zero-padded once,
    here) plus the same epilogue and requantize in torch."""
    import torch
    layers = []
    for p in qp:
        k, n = p["w_q"].shape
        kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
        xs = torch.full((), p["x_scale"], dtype=torch.float32,
                        device=p["w_q"].device)
        s = _pad_to((p["w_scale"] * xs)[None, :], 1, np_)
        b = _pad_to(p["b"][None, :], 1, np_)
        layers.append((_pad_to(p["w_q"], kp, np_), s, b, xs))
    last = len(layers) - 1

    def run(h_pad):
        h = h_pad
        for i, (w, s, b, xs) in enumerate(layers):
            hq = torch.clamp(torch.round(h / xs), -127, 127).to(torch.int8)
            h = torch._int_mm(hq, w).float() * s + b
            if i != last or act_last:
                h = torch.clamp_min(h, 0.0)
        return h
    return run


def timing_phase(dep, device) -> dict:
    import torch
    from repro_torch.core import tiling
    from repro_torch.kernels import fused_mlp as fm
    rows = {"fused_mlp_q8": [], "gemm_int8": []}
    empty_graph = graph_ms(lambda: fm.empty_launch(device))
    empty_eager = event_ms(lambda: fm.empty_launch(device))
    log(f"timing empty kernel: graph_ms={empty_graph} "
        f"eager_ms={empty_eager}")
    gen = torch.Generator().manual_seed(2)
    for nid in SERVED:
        eng = dep.engines[nid]
        cfg, qp = eng.cfg, eng.qparams
        g = pack_net(qp)
        x = torch.randn((cfg.batch, cfg.dims[0]), generator=gen).to(device)
        lib = library_chain(qp)
        x_pad = _pad_to(x, 32, -(-cfg.dims[0] // 8) * 8)
        lib_out = lib(x_pad)[:cfg.batch, :cfg.dims[-1]]
        check_close(f"{nid} library chain vs kernel", lib_out,
                    fm.fused_mlp_q8_cuda(x, g))
        macs = sum(k * n for k, n in cfg.layer_shapes)
        nbytes = (x.numel() * 4 + sum(k * n for k, n in cfg.layer_shapes)
                  + sum(2 * 4 * n for n in cfg.dims[1:]) + 4 * len(qp)
                  + cfg.batch * cfg.dims[-1] * 4)
        rows["fused_mlp_q8"].append({
            "shape": f"{nid} M={cfg.batch} dims={list(cfg.dims)}",
            "ms": graph_ms(lambda: fm.fused_mlp_q8_cuda(x, g)),
            "eager_ms": event_ms(lambda: fm.fused_mlp_q8_cuda(x, g)),
            "plain_ms": graph_ms(lambda: fm.fused_mlp_q8_plain(x, g)),
            "library_ms": graph_ms(lambda: lib(x_pad)),
            **bound(nbytes, 2.0 * cfg.batch * macs)})
        for i, ((k, n), tile) in enumerate(
                zip(cfg.layer_shapes,
                    [eng.plan.layer(j).api_tile
                     for j in range(len(cfg.layer_shapes))])):
            p = qp[i]
            xq = torch.randint(-127, 128, (cfg.batch, k), generator=gen,
                               dtype=torch.int8).to(device)
            rows["gemm_int8"].append(gemm_row(
                f"{nid}.dense{i} ({cfg.batch},{k},{n})", xq, p["w_q"],
                p["w_scale"], p["x_scale"], tile))
    m, k, n = 256, 1024, 1024
    xq = torch.randint(-127, 128, (m, k), generator=gen,
                       dtype=torch.int8).to(device)
    w = torch.randint(-127, 128, (k, n), generator=gen,
                      dtype=torch.int8).to(device)
    sw = (torch.rand((n,), generator=gen) * 0.01).to(device)
    rows["gemm_int8"].append(gemm_row(f"({m},{k},{n})", xq, w, sw, 0.02,
                                      tiling.plan_api(m, k, n).blocks))
    for name, rs in rows.items():
        for r in rs:
            log(f"timing {name} " + json.dumps(r, sort_keys=True))
    return {"rows": rows, "empty_graph_ms": empty_graph,
            "empty_eager_ms": empty_eager}


def gemm_row(what, xq, w, sw, x_scale, tile) -> dict:
    import torch
    from repro_torch.kernels import gemm_int8 as g8
    m, k = xq.shape
    n = w.shape[1]
    mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    x_pad, w_pad = _pad_to(xq, mp, kp), _pad_to(w, kp, np_)
    scale = _pad_to((torch.full((), x_scale, dtype=torch.float32,
                                device=xq.device) * sw)[None, :], 1, np_)

    def kernel():
        return g8.gemm_int8_cuda(xq, w, sw, x_scale, block_m=tile[0],
                                 block_k=tile[1], block_n=tile[2],
                                 out_dtype=torch.float32)

    def library():
        return torch._int_mm(x_pad, w_pad).float() * scale

    check_close(f"gemm {what} library vs kernel", library()[:m, :n],
                kernel())
    return {"shape": what, "blocks": list(tile),
            "ms": graph_ms(kernel), "eager_ms": event_ms(kernel),
            "plain_ms": graph_ms(lambda: g8.gemm_int8_plain(
                xq, w, sw, x_scale, out_dtype=torch.float32)),
            "library_ms": graph_ms(library),
            **bound(m * k + k * n + 4 * n + 4 * m * n, 2.0 * m * k * n)}


def kernels_line(errs, launches, timing) -> dict:
    """One entry per kernel at the first served net's shapes: the fused
    group of one request, and the per-layer rung of one degraded request
    (its layers' times summed)."""
    first = SERVED[0]
    fused = next(r for r in timing["rows"]["fused_mlp_q8"]
                 if r["shape"].startswith(first + " "))
    layers = [r for r in timing["rows"]["gemm_int8"]
              if r["shape"].startswith(first + ".")]
    per_layer = {key: sum(r[key] for r in layers)
                 for key in ("ms", "eager_ms", "plain_ms", "library_ms")}
    per_layer.update(bound(sum(r["bytes"] for r in layers),
                           sum(r["ops"] for r in layers)))
    per_layer["shape"] = (f"{first} per-layer rung, {len(layers)} launches: "
                          + ", ".join(r["shape"].split(" ", 1)[1]
                                      for r in layers))
    entries = []
    for name, row, n_launch in (("fused_mlp_q8", fused, 1),
                                ("gemm_int8", per_layer, len(layers))):
        entries.append({
            "name": name, **KERNEL_META[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "eager_ms": row["eager_ms"],
            "launch_floor_ms": n_launch * timing["empty_graph_ms"],
            "shape": row["shape"]})
    return {"kernels": entries}


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: PyTorch is missing ({exc})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        card = card_line()
        log(card)
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.build_all()
        log(f"build: {time.perf_counter() - t0:.1f} s for "
            f"{sorted(build.SOURCES)}")
        for name, report in sorted(build.ptxas_report.items()):
            regs = sorted({line.split("Used ")[1].split(",")[0]
                           for line in report.splitlines()
                           if "registers" in line})
            log(f"build {name}: ptxas {regs}")
        device = torch.device("cuda", torch.cuda.current_device())
        errs = kernel_phase(device)
        dep, launches = serve_phase()
        timing = timing_phase(dep, device)
        line = kernels_line(errs, launches, timing)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log(json.dumps(line, sort_keys=True))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
