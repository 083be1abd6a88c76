"""Characterize the card and write the machine-model artifact.

    PYTHONPATH=src python -m repro_torch.characterize                   # quick
    PYTHONPATH=src python -m repro_torch.characterize --sweep full --out model.json
    PYTHONPATH=src python -m repro_torch.characterize --device cpu --terms gemm_int8

Runs the sweeps, prints each term's fitted constants and relative
residual, and writes the versioned
:class:`~repro_torch.characterize.MachineModel` JSON that
``Deployment.build(machine_model=PATH)`` reads on the same machine.
Without ``--device`` it runs on the card and exits 1 when there is none.
"""

from __future__ import annotations

import argparse
import sys


def _fmt_constant(name: str, value: float) -> str:
    if name.endswith("_s"):
        return f"{name}={value * 1e6:.3g}us"
    if "penalty" in name:
        return f"{name}={value:.4f}"
    return f"{name}={value:.3g}"


def main(argv: list[str] | None = None, *,
         prog: str = "python -m repro_torch.characterize") -> int:
    from repro_torch.characterize import sweeps as sweeplib
    ap = argparse.ArgumentParser(
        prog=prog,
        description="Run the microbenchmark sweeps on the card, fit every "
                    "cost term, and write the versioned MachineModel "
                    "artifact the planner consumes.")
    ap.add_argument("--sweep", choices=sweeplib.SWEEPS, default="quick",
                    help="grid density")
    ap.add_argument("--out", default="model.json",
                    help="path for the MachineModel JSON artifact")
    ap.add_argument("--terms", nargs="+", choices=sweeplib.TERMS,
                    default=list(sweeplib.TERMS),
                    help="cost terms to characterize (default: all)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=51,
                    help="timed calls per sweep point (median taken)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to fit the plain path on the CPU (default: "
                         "the card)")
    args = ap.parse_args(argv)

    from repro_torch.characterize import characterize
    from repro_torch.device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"{prog}: {exc}", file=sys.stderr)
        return 1
    print(f"# characterizing {len(args.terms)} cost term(s), "
          f"sweep={args.sweep}, device={device}")
    mm = characterize(sweep=args.sweep, batch=args.batch, iters=args.iters,
                      terms=tuple(args.terms), device=device)

    print(f"\n{'term':<12}{'residual':>10}  constants")
    for term, f in mm.fits.items():
        consts = "  ".join(_fmt_constant(k, v)
                           for k, v in f.constants.items())
        print(f"{term:<12}{f.residual_rel_rms:>9.1%}  {consts}")
    path = mm.save(args.out)
    print(f"\nversion {mm.version[:16]}...  wrote {path}")
    print(f"use it:  Deployment.build(nets, machine_model={str(path)!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
