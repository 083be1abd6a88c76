"""Deterministic synthetic training batches (numpy), and their prefetcher.

Port of the JAX package's ``data/pipeline.py``, kept as the port's own
copy: every batch is a pure function of (seed, step), so a restart replays
identical data, and the per-family extras (whisper's encoder frames,
qwen2-vl's M-RoPE position ids) come with it.  Batches are numpy arrays,
equal bit for bit to the reference's; the train step moves them to the
device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


def synth_batch(cfg: ModelConfig, *, batch: int, seq: int, step: int,
                seed: int = 0) -> dict:
    """One global batch: {"tokens", "labels"} (B, S) int32 and the family's
    extras ("encoder_frames" (B, encoder_len, d_model) f32,
    "mrope_positions" (3, B, S) int32)."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    # A Markov-ish token stream (not uniform noise), so losses move.
    base = rng.integers(0, cfg.vocab_size, size=(batch, seq + 1),
                        dtype=np.int64)
    drift = np.cumsum(rng.integers(0, 7, size=(batch, seq + 1)), axis=1)
    toks = (base + drift) % cfg.vocab_size
    out = {"tokens": toks[:, :-1].astype(np.int32),
           "labels": toks[:, 1:].astype(np.int32)}
    if cfg.family == "encdec":
        out["encoder_frames"] = rng.standard_normal(
            (batch, cfg.encdec.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections is not None:
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (batch, seq))
        out["mrope_positions"] = np.stack([pos, pos, pos]).astype(np.int32)
    return out


class Prefetcher:
    """Batches made on a background thread, ``depth`` ahead; iterating
    yields ``(step, batch)``."""

    def __init__(self, cfg: ModelConfig, *, batch: int, seq: int,
                 seed: int = 0, start_step: int = 0, depth: int = 2):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            b = synth_batch(self.cfg, batch=self.batch, seq=self.seq,
                            step=step, seed=self.seed)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
