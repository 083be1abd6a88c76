"""Training launcher: the fault-tolerant driver around the train step, on
the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --smoke --device cpu --steps 3

Port of the JAX package's ``launch/train.py``, with its flags (``--arch``,
``--smoke``, ``--steps``, ``--batch``, ``--seq``, ``--opt``, ``--lr``,
``--microbatches``, ``--remat``, ``--ckpt-dir``, ``--ckpt-every``), plus
``--device`` (default: the GPU; without one the launcher raises),
``--state-dtype`` (AdamW's moments: f32 by default, bf16 or int8 blocks)
and ``--fail-at STEP``, which injects one :class:`SimulatedNodeFailure`
before that step so that the driver restores the last checkpoint and
replays.
Params are drawn from ``torch.Generator(device).manual_seed(0)`` on the
training device; batches are ``synth_batch`` of (seed 0, step); the
optimizer runs a warmup-cosine schedule; transformers take the chunked
loss.  Each step prints its loss, ``grad_norm`` and time.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.data.pipeline import synth_batch
from repro_torch.device import resolve_device
from repro_torch.models import tree
from repro_torch.train import fault, optimizer as opt_lib, schedule
from repro_torch.train import step as step_lib


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--opt", default="adamw",
                    choices=["adamw", "adafactor", "sgd"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--state-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"],
                    help="AdamW's moments (the reference's state_dtype)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="block",
                    choices=["none", "block", "dots"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject one node failure before this step")
    return ap


def run(argv=None, *, after=None) -> dict:
    """Train as the flags say; returns the run's record: ``steps`` (the
    1-based step, loss, grad_norm, ms) in the order run, replays included,
    the ``TrainDriver``'s ``events``, the checkpoint directory, the wall
    seconds and the peak device memory (None on the CPU).
    ``after(driver, batch_fn)``, if given, runs once the steps are done (a
    caller's extra step, say) and its result is the record's
    ``"after"``."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    arch = configs.get(args.arch)
    cfg = arch.smoke if args.smoke else arch.config
    hp = {"state_dtype": args.state_dtype} if args.opt == "adamw" else {}
    opt = opt_lib.make(args.opt, lr=schedule.warmup_cosine(
        args.lr, warmup_steps=max(args.steps // 20, 2),
        total_steps=args.steps), **hp)
    init_fn, step_fn = step_lib.build_train_step(
        cfg, opt, step_lib.TrainOptions(
            remat=args.remat, microbatches=args.microbatches,
            chunked_loss=cfg.family == "transformer"), device=device)

    def batch_fn(step):
        return synth_batch(cfg, batch=args.batch, seq=args.seq, step=step)

    failed = []

    def failure_hook(step):
        if step == args.fail_at and not failed:
            failed.append(step)
            raise fault.SimulatedNodeFailure(f"injected before step {step}")

    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix=f"repro_torch_"
                                                    f"{arch.name}_")
    # The driver holds the only reference to the state: a restore frees
    # the lost state before the checkpoint's comes in.
    driver = fault.TrainDriver(
        cfg=fault.DriverConfig(ckpt_dir=ckpt, ckpt_every=args.ckpt_every),
        step_fn=step_fn, batch_fn=batch_fn,
        state=init_fn(torch.Generator(device=device).manual_seed(0)))
    n_params = sum(p.numel() for p in tree.leaves(driver.state["params"]))
    print(f"[train] arch={arch.name} smoke={args.smoke} params={n_params} "
          f"steps={args.steps} device={device}", flush=True)
    steps = []

    def on_step(step, metrics):
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        ms = driver.step_ms[-1]
        steps.append((step + 1, loss, gnorm, ms))
        print(f"[train] step {step + 1} loss {loss!r} grad_norm {gnorm!r} "
              f"{ms:.1f} ms", flush=True)

    driver.on_step = on_step
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    driver.run(args.steps, failure_hook=failure_hook)
    out = {"arch": arch.name, "steps": steps, "events": driver.events,
           "ckpt_dir": ckpt, "wall_s": time.perf_counter() - t0,
           "peak_bytes": (torch.cuda.max_memory_allocated(device)
                          if device.type == "cuda" else None)}
    if after is not None:
        out["after"] = after(driver, batch_fn)
    print(f"[train] done at step {driver.step} after {len(steps)} step "
          f"runs; events={[e[:2] for e in driver.events]}; checkpoints in "
          f"{ckpt}", flush=True)
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
