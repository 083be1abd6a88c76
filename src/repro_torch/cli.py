"""``python -m repro_torch``: the port's command line.

    python -m repro_torch characterize [--sweep quick|full] [--out model.json]
    python -m repro_torch plan jet_tagger tau_select --lm recurrentgemma_2b
    python -m repro_torch deploy jet_tagger tau_select --lm recurrentgemma_2b
    python -m repro_torch deploy vae --dry-run          # stop after planning
    python -m repro_torch serve jet_tagger --lm rwkv6_7b --requests 4
    python -m repro_torch bench jet_tagger tau_select --json BENCH_deploy.json
    python -m repro_torch check [PLAN_JSON ...] [--json] [--no-kernels]

Every subcommand runs on the card unless ``--device cpu`` is given (the
plain PyTorch path on the CPU); without a card it exits with an error.
``plan``, ``deploy``, ``serve`` and ``bench`` go through
:class:`repro_torch.deploy.Deployment`: ``--lm ARCH`` adds an LM tenant
(``recurrentgemma_2b`` or ``rwkv6_7b``, seeded weights; its smoke config,
or the published one with ``--lm-config published``), ``--machine-model``
picks the characterization (``auto`` by default; ``stock``, ``quick``,
``full`` or an artifact path).  ``plan`` writes its artifacts under
``plans_torch/``, the others under ``deployments_torch/``; ``bench
--json PATH`` writes the planned-vs-measured rows as ``{"meta", "rows"}``.

``check`` verifies the plan or fleet artifacts given, or, with none, plans
the five Table-I edge nets as one fleet and verifies that; then it runs the
kernel library self-check, one launch of each ported kernel on the device.
The exit code is the report's: 0 clean, 1 error findings (or no device), 2
an artifact that cannot be decoded.
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
        description="Verify h100 plans against the design rules and the "
                    "kernel contracts, then self-check the kernel library.")
    ap.add_argument("artifacts", nargs="*", metavar="PLAN_JSON",
                    help="plan or fleet artifacts to verify (default: plan "
                         "the Table-I fleet and verify it)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
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
            fleet = plan_fleet([edge.edge_config(n) for n in edge.EDGE_NETS],
                               device=device)
            report.extend(checklib.check_fleet(fleet, kernels=kernels))
            report.checked.append(f"fleet:{fleet.name}")
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


def _build_deployment(args, *, stop_after=None):
    from repro_torch.deploy import Deployment
    return Deployment.build(
        _specs(args), target=getattr(args, "target", "h100"),
        machine_model=_machine_model_spec(args.machine_model),
        device=args.device, artifact_dir=args.out, stop_after=stop_after,
        batch=args.batch)


def _print_fleet(fleet) -> None:
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
    ap.add_argument("--target", choices=("h100",), default="h100",
                    help="the card planned for (the AIE target is not "
                         "ported)")
    args = ap.parse_args(argv)
    try:
        dep = _build_deployment(args, stop_after="plan")
    except RuntimeError as e:            # no CUDA device
        print(f"plan: {e}", file=sys.stderr)
        return 1
    _print_fleet(dep.fleet)
    print(f"wrote {dep.stage_results['plan'].artifact}")
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


_SUBCOMMANDS = {"characterize": cmd_characterize, "plan": cmd_plan,
                "deploy": cmd_deploy, "serve": cmd_serve, "bench": cmd_bench,
                "check": cmd_check}


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
