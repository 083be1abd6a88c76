"""Serving launcher: continuous batching of a language model on the card,
with optional int8 weights.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --quant8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium

``--arch`` takes any architecture the port registers (``repro_torch.configs``:
``gemma2-2b``, ``gemma2-9b``, ``gemma2-27b``, ``qwen2.5-3b``,
``qwen2-vl-72b``, ``mixtral-8x22b``, ``deepseek-v3-671b``,
``whisper-medium``, ``recurrentgemma-2b``, ``rwkv6-7b``); ``--smoke`` serves
its reduced same-family configuration (the published MoE shapes do not fit
one card).  qwen2-vl is served on text tokens (its vision frontend is a
stub in the reference too); whisper's decoder from zero cross K/V, as the
reference's batcher serves it (no encoder frames are admitted).  ``--quant8`` serves
int8 weights (``engine.quantize_params(params, min_size=1024)``, each layer
expanded to bf16 as it runs) and prints the bytes before and after.

Random weights from seed 0 (drawn on the serving device), requests with
2-8 token prompts from numpy seed 0, greedy decoding.  ``--device`` left out
means the GPU; without one the launcher exits with an error.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serve import engine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--quant8", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"[serve] {exc}", file=sys.stderr)
        return 2
    arch = configs.get(args.arch)
    cfg = arch.smoke if args.smoke else arch.config
    gen = torch.Generator(device=device).manual_seed(0)
    params = api.init(cfg, gen, device=device)
    if args.quant8:
        params = engine.quantize_params(params, min_size=1024)
        before, after = engine.quantized_bytes(params)
        print(f"[serve] int8 weights: {before/1e6:.1f} -> {after/1e6:.1f} MB")
    batcher = engine.ContinuousBatcher(cfg, params, slots=args.slots,
                                       max_len=args.max_len)
    rng = np.random.default_rng(0)
    reqs = [engine.Request(
        rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                   rng.integers(2, 9)).astype(np.int32),
        max_new=args.max_new) for i in range(args.requests)]
    t0 = time.perf_counter()
    for r in reqs:
        batcher.submit(r)
    batcher.run_until_drained()
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in reqs)
    print(f"[serve] {cfg.name} on {device}: {len(reqs)} requests, {total} "
          f"tokens in {dt:.2f}s ({total / dt:.1f} tok/s)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
