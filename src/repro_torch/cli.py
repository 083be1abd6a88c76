"""``python -m repro_torch``: the port's command line.

    python -m repro_torch check [PLAN_JSON ...] [--json] [--no-kernels]
                                [--device cpu|cuda]

``check`` verifies the plan or fleet artifacts given, or, with none, plans
the five Table-I edge nets as one fleet and verifies that; then it runs the
kernel library self-check, one launch of each ported kernel on the device
(the card unless ``--device cpu``).  The exit code is the report's: 0 clean,
1 error findings (or no device), 2 an artifact that cannot be decoded.
"""

from __future__ import annotations

import argparse
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


_SUBCOMMANDS = {"check": cmd_check}


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
