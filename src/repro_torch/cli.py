"""``python -m repro_torch``: the port's command line.

    python -m repro_torch characterize [--sweep quick|full] [--out model.json]
    python -m repro_torch plan jet_tagger tau_select --lm recurrentgemma_2b
    python -m repro_torch deploy jet_tagger tau_select --lm recurrentgemma_2b
    python -m repro_torch deploy vae --dry-run          # stop after planning
    python -m repro_torch serve jet_tagger --lm rwkv6_7b --requests 4
    python -m repro_torch deploy jet_tagger --lm gemma2_9b
    python -m repro_torch deploy jet_tagger --lm whisper_medium
    python -m repro_torch bench jet_tagger tau_select --json BENCH_deploy.json
    python -m repro_torch replay jet_tagger tau_select --scenario bursty
    python -m repro_torch chaos jet_tagger tau_select --lm recurrentgemma_2b
    python -m repro_torch trace jet_tagger --lm recurrentgemma_2b
    python -m repro_torch profile jet_tagger --lm recurrentgemma_2b
    python -m repro_torch plan jet_tagger vae --target both --pl-budget 100
    python -m repro_torch check [PLAN_JSON ...] [--json] [--no-kernels]
    python -m repro_torch check --root . [--no-lint]

Every subcommand runs on the card unless ``--device cpu`` is given (the
plain PyTorch path on the CPU); without a card it exits with an error.
``plan``, ``deploy``, ``serve``, ``bench``, ``replay``, ``chaos``,
``trace`` and ``profile`` go through
:class:`repro_torch.deploy.Deployment`: ``--lm ARCH`` adds an LM tenant
(``gemma2_2b``, ``gemma2_9b``, ``gemma2_27b``, ``qwen2_5_3b``,
``qwen2_vl_72b``, ``mixtral_8x22b``, ``deepseek_v3_671b``,
``whisper_medium``, ``recurrentgemma_2b`` or ``rwkv6_7b``, seeded weights;
its smoke config, or the published one with ``--lm-config published``),
``--machine-model``
picks the characterization (``auto`` by default; ``stock``, ``quick``,
``full`` or an artifact path).  ``plan`` writes its artifacts under
``plans_torch/``, the others under ``deployments_torch/``.  ``plan
--target`` picks the card (``h100``, the default, since ``plan`` is a step
of the deploy flow), the paper's VEK280 array (``aie``: LARE against
``--pl-budget`` per layer, the spatial split, columns and bands) or
``both`` (one artifact a target); an LM tenant is planned for ``h100``
only.  ``bench --json PATH`` writes the planned-vs-measured rows as
``{"meta", "rows"}``.

``replay`` serves the fleet and replays a scenario trace open loop
(``steady``, ``bursty``, ``diurnal``, ``flash_crowd``; or ``--trace-file``),
printing each tenant's tail, scheduling lag and SLO verdict.  ``chaos``
replays a scenario under a fault burst against one tenant (armed after the
warmup) and judges isolation and recovery: exit 0 only when the verdict is
``RECOVERED``.  Both write their ``BENCH_serve_*`` (and ``BENCH_chaos_*``)
snapshots under ``--json-dir``.

``trace`` builds with spans on, serves the smoke trace, writes the
Chrome/Perfetto ``trace.json``, a Prometheus ``metrics.prom`` and the
``BENCH_serve_*`` snapshots under ``--trace-out`` (default ``<--out>/obs``)
and prints the plan-vs-measured attribution.  ``profile`` serves the same
traffic and prints the roofline profile (achieved rates, the bound, the
roofline fraction clamped and raw, the measured LARE) and each tenant's
model FLOPs against its served step (``--no-graph`` skips that, where the
JAX package's ``--no-hlo`` skips its HLO analysis); ``--json-dir`` writes
``BENCH_profile_<net>.json``.  It exits 1 when no window was profiled.

``check`` verifies the plan or fleet artifacts given, or, with none, checks
the tree at ``--root``: the hazard lint over ``src/repro_torch`` (unless
``--no-lint``), every plan artifact under ``deployments_torch/`` and every
``bench/**/BENCH_*.json`` snapshot; then it plans the five Table-I edge
nets as one fleet for ``h100`` and for ``aie`` and verifies both.  Last it
runs the kernel library self-check, one launch of each ported kernel on the
device.  The exit code is the report's: 0 clean, 1 error findings (or no
device), 2 an artifact that cannot be decoded.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch import check as checklib


def cmd_check(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch check",
        description="Lint src/repro_torch, verify plans against the design "
                    "rules and the kernel contracts, validate the BENCH "
                    "snapshots, then self-check the kernel library.")
    ap.add_argument("artifacts", nargs="*", metavar="PLAN_JSON",
                    help="plan or fleet artifacts to verify (default: check "
                         "the tree at --root and the Table-I fleet planned "
                         "for h100 and aie)")
    ap.add_argument("--root", default=".",
                    help="checkout for the tree check (default: .)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the src/repro_torch hazard lint")
    ap.add_argument("--no-kernels", action="store_true",
                    help="skip the kernel contracts and the library "
                         "self-check")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the self-check launches (default: the GPU; "
                         "cpu runs the plain versions)")
    args = ap.parse_args(argv)
    from repro_torch.check import kernel_contracts
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.models import edge
    from repro_torch.plan import plan_fleet
    from repro_torch.plan.planner import TARGETS
    kernels = not args.no_kernels
    report = checklib.CheckReport()
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:            # no CUDA device
        print(f"check: {e}", file=sys.stderr)
        return checklib.EXIT_FINDINGS
    try:
        for p in args.artifacts:
            report.extend(checklib.check_artifact(p, kernels=kernels))
            report.checked.append(f"plan:{pathlib.Path(p).name}")
        if not args.artifacts:
            tree = checklib.check_tree(args.root, kernels=kernels,
                                       lint=not args.no_lint)
            report.extend(tree.findings)
            report.checked += tree.checked
            cfgs = [edge.edge_config(n) for n in edge.EDGE_NETS]
            for target in TARGETS:
                fleet = plan_fleet(cfgs, target=target, device=device)
                report.extend(checklib.check_fleet(fleet, kernels=kernels))
                report.checked.append(f"fleet:{fleet.name}:{target}")
        if kernels:
            before = ops.launch_counts()
            report.extend(kernel_contracts.verify_kernel_library(device))
            report.launches = {k: n - before[k]
                               for k, n in ops.launch_counts().items()}
            report.checked.append(f"kernels:library self-check on {device}")
    except checklib.ArtifactError as e:
        print(f"check: {e}", file=sys.stderr)
        return checklib.EXIT_UNDECODABLE
    print(report.to_json() if args.json else str(report))
    return report.exit_code


def cmd_characterize(argv) -> int:
    from repro_torch.characterize.__main__ import main as characterize_main
    return characterize_main(argv, prog="python -m repro_torch characterize")


# ---------------------------------------------------------------------------
# plan / deploy / serve / bench
# ---------------------------------------------------------------------------

_DEFAULT_NETS = ("jet_tagger", "tau_select")


def _machine_model_spec(flag: str):
    """The --machine-model flag as a CharacterizeStage spec."""
    return None if flag in ("stock", "none") else flag


def _deploy_parser(prog: str, description: str, *,
                   out: str) -> argparse.ArgumentParser:
    from repro_torch import configs
    ap = argparse.ArgumentParser(prog=prog, description=description)
    ap.add_argument("net", nargs="*", default=list(_DEFAULT_NETS),
                    help="edge net names (default: jet_tagger tau_select)")
    ap.add_argument("--lm", default=None, metavar="ARCH",
                    choices=sorted(configs.ALIASES),
                    help="add an LM tenant with seeded weights")
    ap.add_argument("--lm-config", choices=("smoke", "published"),
                    default="smoke",
                    help="the LM's smoke config (default) or its published "
                         "shape")
    ap.add_argument("--machine-model", default="auto",
                    help="'auto' (default), 'stock', 'quick'/'full' "
                         "(characterize inline) or a MachineModel path")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--iters", type=int, default=10,
                    help="measured inferences per edge tenant")
    ap.add_argument("--out", default=out,
                    help="directory for the plan artifacts")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where to run (default: the GPU; cpu runs the "
                         "plain versions)")
    return ap


def _specs(args) -> list:
    from repro_torch import configs
    specs = list(args.net)
    if args.lm:
        arch = configs.get(args.lm)
        specs.append(arch.config if args.lm_config == "published"
                     else arch.smoke)
    return specs


def _build_deployment(args, *, stop_after=None, trace=False,
                      target: str = "h100", pl_budget: float | None = None):
    from repro_torch.deploy import Deployment
    return Deployment.build(
        _specs(args), target=target,
        machine_model=_machine_model_spec(args.machine_model),
        device=args.device, artifact_dir=args.out, stop_after=stop_after,
        batch=args.batch, trace=trace, pl_budget=pl_budget)


def _print_plan(plan) -> None:
    """An AIE plan layer by layer, as the reference prints one: regime,
    LARE, split, band, tile and interval, then its PL<->AIE crossings."""
    print(f"# {plan.network} [{plan.target}]  batch={plan.batch}  "
          f"key={plan.key[:12]}")
    print(f"    {'layer':<10}{'shape':>12}  {'regime':<9}{'LARE':>8}"
          f"{'P_KxP_N':>9}{'band':>5}  {'tile':<16}{'interval':>11}")
    for l in plan.layers:
        rep = f" x{l.repeat}" if l.repeat > 1 else ""
        print(f"    {l.name:<10}{f'{l.n_in}->{l.n_out}{rep}':>12}  "
              f"{l.regime:<9}{l.lare:>8.1f}{f'{l.p_k}x{l.p_n}':>9}"
              f"{l.band:>5}  {str(l.api_tile):<16}"
              f"{l.est_interval_s * 1e6:>9.3f}us")
    for b in plan.boundaries:
        print(f"    boundary after layer {b.after_layer}: "
              f"{b.from_regime}->{b.to_regime} "
              f"(+{b.crossing_s * 1e6:.3f}us)")
    print(f"    totals: latency={plan.est_latency_s * 1e6:.3f}us  "
          f"interval={plan.est_interval_s * 1e6:.3f}us  "
          f"rate={plan.inferences_per_s / 1e6:.2f} MHz")


def _print_fleet(fleet) -> None:
    if fleet.target == "aie":
        print(f"# fleet {fleet.name} [aie]  key={fleet.key[:12]}  "
              f"band1_cols={fleet.band1_cols_used}")
        for t in fleet.tenants:
            cols = (f"{t.col_offset}..{t.col_offset + t.cols - 1}"
                    if t.cols else "-")
            print(f"{t.net_id:<18} cols={cols:<7} "
                  f"planned={t.plan.est_latency_s * 1e6:10.3f}us "
                  f"+cross={t.crossing_s * 1e6:.3f}us "
                  f"budget={t.latency_budget_s * 1e6:10.3f}us")
        for t in fleet.tenants:
            _print_plan(t.plan)
        return
    print(f"# fleet {fleet.name} [{fleet.target}]  key={fleet.key[:12]}")
    for t in fleet.tenants:
        p = t.plan
        print(f"{t.net_id:<18} kind={p.kind:<5} "
              f"planned={p.est_latency_s * 1e6:10.2f}us "
              f"+cross={t.crossing_s * 1e6:.3f}us "
              f"budget={t.latency_budget_s * 1e6:10.2f}us "
              f"groups={len(p.groups())}")
        for l in p.layers:
            rep = f" x{l.repeat}" if l.repeat > 1 else ""
            print(f"    {l.name:<10}{f'{l.n_in}->{l.n_out}{rep}':>18}  "
                  f"group={l.fuse_group:<3} tile={l.api_tile}  "
                  f"{l.est_latency_s * 1e6:9.3f}us")
        print(f"    serve {json.dumps(p.serve, sort_keys=True)}")


def cmd_plan(argv) -> int:
    ap = _deploy_parser(
        "python -m repro_torch plan",
        "Plan the nets as one fleet for the card and write the plan (one "
        "net) or fleet artifact.", out="plans_torch")
    ap.add_argument("--target", choices=("h100", "aie", "both"),
                    default="h100",
                    help="the card (h100, default), the paper's VEK280 "
                         "array (aie), or both (one artifact a target)")
    ap.add_argument("--pl-budget", type=float, default=400.0,
                    help="PL DSP-equivalents per layer for the AIE target's "
                         "LARE decision")
    args = ap.parse_args(argv)
    from repro_torch.plan.planner import TARGETS
    targets = TARGETS if args.target == "both" else (args.target,)
    if args.lm and targets != ("h100",):
        print("# --lm: an LM is planned for h100 only")
        targets = ("h100",)
    try:
        for target in targets:
            dep = _build_deployment(
                args, stop_after="plan", target=target,
                pl_budget=args.pl_budget if target == "aie" else None)
            _print_fleet(dep.fleet)
            print(f"wrote {dep.stage_results['plan'].artifact}")
    except RuntimeError as e:            # no CUDA device
        print(f"plan: {e}", file=sys.stderr)
        return 1
    return 0


def _serve_smoke(dep, *, iters: int, requests: int = 3) -> tuple:
    """Drive the deployment through the replay driver: ``iters`` edge
    inferences per edge tenant and ``requests`` LM requests per LM tenant
    (the smoke trace); returns (the router report, the non-ok records)."""
    from repro_torch.obs import workload
    router = dep.serve()
    inputs = router.warmup()
    tenants = {t.net_id: t.plan.kind for t in dep.fleet.tenants}
    trace = workload.smoke_trace(tenants, edge_iters=iters,
                                 lm_requests=requests)
    report = workload.replay(router, trace, inputs=inputs)
    return router.report(), [r for r in report.records if r.status != "ok"]


def _print_report(report: dict, bad: list) -> None:
    print("\nper-tenant report:")
    for nid, m in report.items():
        print(f"  {nid:<18} kind={m['kind']:<5} n={m['count']:<4} "
              f"p50={m['p50_s'] * 1e6:10.1f}us "
              f"p95={m['p95_s'] * 1e6:10.1f}us "
              f"violations={m['budget_violations']} "
              f"failures={m['failures']}")
    for r in bad:
        print(f"  request {r.rid} ({r.tenant}): {r.status}", file=sys.stderr)


def cmd_deploy(argv) -> int:
    ap = _deploy_parser(
        "python -m repro_torch deploy",
        "End to end: characterize -> plan -> verify -> engines -> serve -> "
        "planned-vs-measured.", out="deployments_torch")
    ap.add_argument("--dry-run", action="store_true",
                    help="stop after the plan stage")
    args = ap.parse_args(argv)
    try:
        dep = _build_deployment(
            args, stop_after="plan" if args.dry_run else None)
    except RuntimeError as e:
        print(f"deploy: {e}", file=sys.stderr)
        return 1
    print(dep.summary())
    if args.dry_run:
        print("\n(dry run: stopped after the plan stage)")
        return 0
    report, bad = _serve_smoke(dep, iters=args.iters)
    _print_report(report, bad)
    print("\nplanned-vs-measured (name,us_per_call,derived):")
    ok = True
    for row in dep.bench(iters=args.iters):
        rec = row.as_record()
        print(f"{rec['name']},{rec['us_per_call']:.3f},{rec['derived']}")
        ok &= row.within_2x
    print("\nall tenants within 2x of plan" if ok else
          "\nWARNING: a tenant missed the 2x planned-vs-measured band")
    return 1 if bad else 0


def cmd_serve(argv) -> int:
    ap = _deploy_parser(
        "python -m repro_torch serve",
        "Plan and serve a fleet behind the router; drive the smoke trace "
        "and print the report.", out="deployments_torch")
    ap.add_argument("--requests", type=int, default=3,
                    help="LM smoke requests per LM tenant")
    args = ap.parse_args(argv)
    try:
        dep = _build_deployment(args)
    except RuntimeError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 1
    report, bad = _serve_smoke(dep, iters=args.iters, requests=args.requests)
    _print_report(report, bad)
    return 1 if bad else 0


def cmd_bench(argv) -> int:
    ap = _deploy_parser(
        "python -m repro_torch bench",
        "Planned-vs-measured rows of a deployment's edge tenants on this "
        "device.", out="deployments_torch")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the rows as {\"meta\", \"rows\"}")
    args = ap.parse_args(argv)
    try:
        dep = _build_deployment(args)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    rows = [r.as_record() for r in dep.bench(iters=args.iters)]
    print("name,us_per_call,derived")
    for rec in rows:
        print(f"{rec['name']},{rec['us_per_call']:.3f},{rec['derived']}")
    if args.json:
        p = pathlib.Path(args.json)
        p.parent.mkdir(parents=True, exist_ok=True)
        meta = {"source": "python -m repro_torch bench",
                "device": str(dep.device)}
        p.write_text(json.dumps({"meta": meta, "rows": rows}, indent=2,
                                sort_keys=True) + "\n")
        print(f"[wrote {p}]")
    return 0


def cmd_trace(argv) -> int:
    from repro_torch.serve.metrics import write_serve_snapshots
    ap = _deploy_parser(
        "python -m repro_torch trace",
        "Traced end-to-end run: build and serve with spans on, then write "
        "the Chrome/Perfetto trace.json, a Prometheus metrics snapshot and "
        "per-tenant BENCH_serve_<net>.json rows (with per-span-kind "
        "percentiles), and print the plan-vs-measured attribution table.",
        out="deployments_torch")
    ap.add_argument("--requests", type=int, default=3,
                    help="LM smoke requests per LM tenant")
    ap.add_argument("--trace-out", default=None, metavar="DIR",
                    help="directory for trace.json, metrics.prom and "
                         "BENCH_serve_*.json (default: <--out>/obs)")
    args = ap.parse_args(argv)
    try:
        dep = _build_deployment(args, trace=True)
    except RuntimeError as e:
        print(f"trace: {e}", file=sys.stderr)
        return 1
    print(dep.summary())
    report, bad = _serve_smoke(dep, iters=args.iters, requests=args.requests)
    _print_report(report, bad)
    out = pathlib.Path(args.trace_out or pathlib.Path(args.out) / "obs")
    trace_path = dep.export_trace(out / "trace.json")
    prom_path = dep.export_prometheus(out / "metrics.prom")
    bench_paths = write_serve_snapshots(
        report, out, meta={"source": "python -m repro_torch trace",
                           "device": str(dep.device)})
    print("\nplan-vs-measured attribution:")
    print(dep.format_attribution())
    print(f"\nwrote {trace_path}   (load at https://ui.perfetto.dev)")
    print(f"wrote {prom_path}")
    for p in bench_paths:
        print(f"wrote {p}")
    return 1 if bad else 0


def cmd_profile(argv) -> int:
    ap = _deploy_parser(
        "python -m repro_torch profile",
        "Roofline-attributed profiling: serve the smoke traffic, then join "
        "the measured span windows with the plans' work (FLOPs, bytes, "
        "launches) and the card's ceilings: achieved rates, a "
        "compute/memory/launch bound, the roofline fraction and the "
        "measured LARE per tenant, and the plan's model FLOPs against what "
        "each tenant's served step runs.", out="deployments_torch")
    ap.add_argument("--requests", type=int, default=3,
                    help="LM smoke requests per LM tenant")
    ap.add_argument("--json-dir", default=None, metavar="DIR",
                    help="write BENCH_profile_<net>.json snapshots here")
    ap.add_argument("--no-graph", action="store_true",
                    help="skip the served steps' FLOP count (one eager "
                         "step per engine; the JAX package's --no-hlo)")
    args = ap.parse_args(argv)
    try:
        dep = _build_deployment(args, trace=True)
    except RuntimeError as e:
        print(f"profile: {e}", file=sys.stderr)
        return 1
    _, bad = _serve_smoke(dep, iters=args.iters, requests=args.requests)
    rows = dep.profile()
    print(dep.format_profile())
    if not rows:
        print("no profiled windows: did the smoke traffic run?",
              file=sys.stderr)
        return 1
    print("\nraw roofline fraction (unclamped):")
    for r in rows:
        if r.group is None and r.raw_fraction is not None:
            print(f"  {r.tenant:<18} {r.kind:<14} raw={r.raw_fraction:.4f}")
    if not args.no_graph:
        print("\nserved-step overhead (plan model FLOPs vs the step):")
        for nid, ov in sorted(dep.graph_overhead().items()):
            uf = ov["useful_fraction"]
            useful = f"{uf:.4f}" if uf is not None else "-"
            print(f"  {nid:<18} model={ov['model_flops']:.4g} "
                  f"graph={ov['graph_flops']:.4g} "
                  f"bytes={ov['graph_bytes']:.4g} useful={useful}")
    if args.json_dir:
        from repro_torch.obs import write_profile_snapshots
        paths = write_profile_snapshots(
            rows, args.json_dir,
            meta={"source": "python -m repro_torch profile",
                  "device": str(dep.device)})
        for p in paths:
            print(f"wrote {p}")
    return 1 if bad else 0


def _scenario_args(ap) -> None:
    """The arguments ``replay`` and ``chaos`` share: the scenario and its
    knobs."""
    from repro_torch.obs import workload as wl
    ap.add_argument("--scenario", choices=sorted(wl.SCENARIOS),
                    default="flash_crowd")
    ap.add_argument("--duration", type=float, default=0.25, metavar="S",
                    help="trace duration in seconds (default 0.25)")
    ap.add_argument("--rate", type=float, default=None, metavar="HZ",
                    help="edge-tenant mean arrival rate")
    ap.add_argument("--lm-rate", type=float, default=None, metavar="HZ",
                    help="LM-tenant mean arrival rate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speed", type=float, default=1.0,
                    help="replay speedup: 2.0 compresses arrivals 2x")


def _scenario_kw(args) -> dict:
    kw = {}
    if args.rate is not None:
        kw["rate_hz"] = args.rate
    if args.lm_rate is not None:
        kw["lm_rate_hz"] = args.lm_rate
    return kw


def cmd_replay(argv) -> int:
    from repro_torch.obs import workload as wl
    ap = _deploy_parser(
        "python -m repro_torch replay",
        "Open-loop traffic replay against a served fleet: generate a "
        "deterministic scenario trace (or load one), fire arrivals on the "
        "wall clock whatever the completions, and report each tenant's tail "
        "latency, scheduling lag and SLO verdict.", out="deployments_torch")
    _scenario_args(ap)
    ap.add_argument("--trace-file", default=None, metavar="JSONL",
                    help="replay this saved trace instead of generating")
    ap.add_argument("--save-trace", default=None, metavar="JSONL",
                    help="also save the generated trace for re-replay")
    ap.add_argument("--json-dir", default=None, metavar="DIR",
                    help="write BENCH_serve_<net>__<scenario>.json tail "
                         "snapshots here")
    ap.add_argument("--underbudget", default=None, metavar="NET",
                    help="shrink NET's SLO budgets to ~0 before the replay "
                         "(the monitor must flag it)")
    args = ap.parse_args(argv)
    try:
        dep = _build_deployment(args)
    except RuntimeError as e:
        print(f"replay: {e}", file=sys.stderr)
        return 1
    router = dep.serve()
    if args.underbudget:
        if router.slo is None:
            print("--underbudget needs the SLO monitor (serve(slo=True))",
                  file=sys.stderr)
            return 2
        router.slo.set_budget(args.underbudget, p95_s=1e-9, p99_s=1e-9)
        print(f"# injected near-zero SLO budget for {args.underbudget}")
    requests = None
    if args.trace_file:
        requests = wl.load_trace(args.trace_file)
        print(f"# loaded {len(requests)} request(s) from {args.trace_file}")
    scenario_kw = _scenario_kw(args)
    if requests is None and args.save_trace:
        tenants = {t.net_id: t.plan.kind for t in dep.fleet.tenants}
        requests = wl.make_scenario(args.scenario, tenants,
                                    duration_s=args.duration,
                                    seed=args.seed, **scenario_kw)
        print(f"[wrote {wl.save_trace(requests, args.save_trace)}]")
    report = dep.replay(args.scenario, duration_s=args.duration,
                        seed=args.seed, speed=args.speed,
                        requests=requests, json_dir=args.json_dir,
                        **scenario_kw)
    print(wl.format_replay(report, slo=router.slo))
    if args.json_dir:
        out = pathlib.Path(args.json_dir)
        for p in sorted(out.glob("BENCH_serve_*__*.json")):
            print(f"wrote {p}")
    return 0


def _recovery_window(records, victim: str, budget, *, window: int = 8):
    """The first post-fault rolling window of ok latencies whose p95 is
    back under the recovery target: ``(requests_until_recovered,
    window_p95_s, target_s)``, the first two None when it never recovered
    or cannot be judged.  The target is the SLO budget when attainable,
    else 2x the victim's pre-fault window p95: a budget the replay never
    met before the fault is not the bar its recovery is judged by."""
    from repro_torch.obs.trace import percentile
    recs = sorted((r for r in records if r.tenant == victim),
                  key=lambda r: r.rid)
    last_bad = max((i for i, r in enumerate(recs) if r.status != "ok"),
                   default=-1)
    pre = [r.e2e_s for r in recs[:last_bad + 1]
           if r.status == "ok" and r.e2e_s is not None]
    tail = [r.e2e_s for r in recs[last_bad + 1:]
            if r.status == "ok" and r.e2e_s is not None]
    baseline = 2.0 * percentile(pre, 0.95) if pre else None
    target = budget
    if baseline is not None:
        target = max(budget, baseline) if budget is not None else baseline
    if target is None or len(tail) < window:
        return None, (percentile(tail, 0.95) if tail else None), target
    for i in range(window, len(tail) + 1):
        p95 = percentile(tail[i - window:i], 0.95)
        if p95 <= target:
            return i, p95, target
    return None, percentile(tail[-window:], 0.95), target


def cmd_chaos(argv) -> int:
    from repro_torch import faults as flib
    from repro_torch.obs import workload as wl
    ap = _deploy_parser(
        "python -m repro_torch chaos",
        "Chaos replay: serve the fleet, arm a deterministic fault burst "
        "against one tenant after the warmup, replay a scenario under it, "
        "and judge isolation and recovery (the breaker's reclose and the "
        "first post-fault window with p95 back under its target).  Exits "
        "non-zero when the fleet did not recover.", out="deployments_torch")
    _scenario_args(ap)
    ap.add_argument("--faults", default=None, metavar="JSON",
                    help="saved FaultPlan artifact (default: a burst of "
                         "--fault-kind faults against --victim)")
    ap.add_argument("--victim", default=None, metavar="NET",
                    help="tenant the default burst targets "
                         "(default: the first edge tenant)")
    ap.add_argument("--fault-kind", choices=sorted(flib.FAULT_KINDS),
                    default="engine_exception")
    ap.add_argument("--fault-at", type=int, default=8, metavar="N",
                    help="post-warmup call index the burst starts at")
    ap.add_argument("--fault-count", type=int, default=6)
    ap.add_argument("--json-dir", default=None, metavar="DIR",
                    help="write BENCH_serve_* tail snapshots and the "
                         "BENCH_chaos recovery snapshot here")
    args = ap.parse_args(argv)
    try:
        dep = _build_deployment(args)
    except RuntimeError as e:
        print(f"chaos: {e}", file=sys.stderr)
        return 1
    router = dep.serve()
    victim = args.victim or next(
        (t.net_id for t in dep.fleet.tenants if t.plan.kind == "edge"),
        dep.fleet.tenants[0].net_id)
    if args.faults:
        plan = flib.FaultPlan.load(args.faults)
        print(f"# loaded fault plan ({len(plan.faults)} spec(s)) "
              f"from {args.faults}")
    else:
        plan = flib.FaultPlan.burst(
            victim, kind=args.fault_kind, after=args.fault_at,
            count=args.fault_count,
            magnitude_s=0.002 if args.fault_kind == "latency_spike" else 0.0)
        print(f"# fault burst: {args.fault_count}x {args.fault_kind} "
              f"against {victim!r} from call {args.fault_at}")
    injector = plan.injector()
    report = dep.replay(args.scenario, duration_s=args.duration,
                        seed=args.seed, speed=args.speed,
                        json_dir=args.json_dir, faults=injector,
                        **_scenario_kw(args))
    print(wl.format_replay(report, slo=router.slo))

    health = router.health()
    vh = health["tenants"].get(victim, {})
    cfg = (router.supervisor.cfg(victim) if router.supervisor is not None
           else dict(flib.RESILIENCE_DEFAULTS))
    slo_snap = router.slo.snapshot() if router.slo is not None else {}
    budget = slo_snap.get(victim, {}).get("p95_budget_s")
    fired = injector.fired(tenant=victim)
    opens = vh.get("breaker_opens", 0)
    recloses = vh.get("breaker_recloses", 0)
    ttr = vh.get("time_to_recovery_s")
    n_rec, rec_p95, target = _recovery_window(report.records, victim,
                                              budget)

    print(f"\nchaos verdict for {victim!r}:")
    print(f"  faults: scheduled={plan.scheduled(victim)} injected={fired} "
          f"failures={vh.get('failures', 0)}")
    print(f"  breaker: opens={opens} recloses={recloses} "
          f"state={vh.get('state', '-')}"
          + (f" ttr={ttr * 1e3:.1f}ms" if ttr is not None else ""))
    if n_rec is not None:
        print(f"  p95 recovery: back under target "
              f"({target * 1e6:.1f}us) after {n_rec} post-fault "
              f"request(s), window p95={rec_p95 * 1e6:.1f}us")
    elif target is not None:
        print(f"  p95 recovery: window p95 never returned under the "
              f"target ({target * 1e6:.1f}us)"
              + (f"; last window p95={rec_p95 * 1e6:.1f}us"
                 if rec_p95 is not None else ""))
    healthy = [t for t in health["tenants"] if t != victim]
    isolated = all(
        report.summary().get(t, {}).get("ok", 0) > 0 for t in healthy)
    print(f"  isolation: co-residents {healthy} "
          f"{'kept serving' if isolated else 'STARVED'}")

    recovered = (fired > 0 and opens > 0 and recloses >= opens
                 and vh.get("state") == "closed" and isolated)
    print(f"\nchaos: {'RECOVERED' if recovered else 'NOT RECOVERED'} "
          f"(injected={fired}, breaker {opens}->{recloses}, "
          f"model={cfg['breaker_cooldown'] + 1} requests open->reclose)")

    if args.json_dir:
        from repro_torch.serve.metrics import _safe_net_name
        prefix = f"chaos/{victim}/{args.scenario}"
        model_derived = (f"src=model;scenario={args.scenario};"
                         f"kind={args.fault_kind}")
        meas_derived = (f"src=measured;scenario={args.scenario};"
                        f"opens={opens};recloses={recloses};"
                        f"state={vh.get('state', '-')}")
        rows = [
            {"name": f"{prefix}/faults_scheduled",
             "us_per_call": float(plan.scheduled(victim)),
             "derived": f"{model_derived};unit=faults"},
            {"name": f"{prefix}/breaker_k",
             "us_per_call": float(cfg["breaker_k"]),
             "derived": f"{model_derived};unit=failures"},
            {"name": f"{prefix}/recovery_model",
             "us_per_call": float(cfg["breaker_cooldown"] + 1),
             "derived": f"{model_derived};unit=requests"},
            {"name": f"{prefix}/faults_injected",
             "us_per_call": float(fired),
             "derived": f"{meas_derived};unit=faults"},
        ]
        if ttr is not None:
            rows.append({"name": f"{prefix}/time_to_recovery",
                         "us_per_call": round(ttr * 1e6, 3),
                         "derived": meas_derived})
        if n_rec is not None:
            rows.append({"name": f"{prefix}/recovery_requests",
                         "us_per_call": float(n_rec),
                         "derived": f"{meas_derived};unit=requests"})
        out = pathlib.Path(args.json_dir)
        out.mkdir(parents=True, exist_ok=True)
        p = out / (f"BENCH_chaos_{_safe_net_name(victim)}__"
                   f"{_safe_net_name(args.scenario)}.json")
        p.write_text(json.dumps(
            {"meta": {"source": "python -m repro_torch chaos",
                      "victim": victim, "scenario": args.scenario,
                      "fault_kind": args.fault_kind, "seed": args.seed,
                      "device": str(dep.device)},
             "rows": rows}, indent=2, sort_keys=True, allow_nan=False)
            + "\n")
        print(f"wrote {p}")
    return 0 if recovered else 1


_SUBCOMMANDS = {"characterize": cmd_characterize, "plan": cmd_plan,
                "deploy": cmd_deploy, "serve": cmd_serve, "bench": cmd_bench,
                "replay": cmd_replay, "chaos": cmd_chaos, "trace": cmd_trace,
                "profile": cmd_profile, "check": cmd_check}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    if argv[0] not in _SUBCOMMANDS:
        print(f"python -m repro_torch: unknown subcommand {argv[0]!r} "
              f"(choose from {', '.join(sorted(_SUBCOMMANDS))})",
              file=sys.stderr)
        return 2
    return _SUBCOMMANDS[argv[0]](argv[1:])
