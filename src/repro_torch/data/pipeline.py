"""Deterministic, shardable, checkpointable synthetic LM data pipeline: the
port of ``repro.data.pipeline``.

Every batch is a pure function of (seed, step) — restart-safe by
construction: the checkpoint stores only the step counter, and any
data-parallel rank can regenerate exactly its slice.  Tokens follow a
Zipf-ish skew so the loss curve is non-trivial.  The draws are the
reference's (``numpy.random.RandomState`` on the same seed), so both
packages give the same tokens, labels and, in the same dtype, the same
patches and frames; the port returns them as tensors on ``device`` (the
card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


@dataclasses.dataclass
class DataState:
    step: int = 0

    def to_dict(self) -> dict:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d: dict) -> "DataState":
        return cls(step=int(d["step"]))


def batch_at(cfg: DataConfig, step: int, frontend: str = "none",
             n_frontend_tokens: int = 0, d_model: int = 0,
             dtype=torch.bfloat16, device="cuda") -> dict:
    """Materialise the global batch for ``step`` (drawn on the host,
    deterministic), tokens and labels int32, on ``device``."""
    device = resolve_device(device)
    rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % (2**31 - 1))
    # Zipf-ish distribution over the vocab
    ranks = np.arange(1, cfg.vocab_size + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    tok = rng.choice(cfg.vocab_size, size=(cfg.global_batch, cfg.seq_len + 1),
                     p=probs).astype(np.int32)
    tok = torch.from_numpy(tok).to(device)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    key = {"patch": "patches", "frame": "frames"}.get(frontend)
    if key is not None:
        batch[key] = torch.from_numpy(
            rng.randn(cfg.global_batch, n_frontend_tokens, d_model) * 0.05
        ).to(device=device, dtype=dtype)
    return batch


class Pipeline:
    """Stateful iterator facade over ``batch_at`` with checkpointable state."""

    def __init__(self, cfg: DataConfig, state: DataState | None = None,
                 **frontend_kwargs):
        self.cfg = cfg
        self.state = state or DataState()
        self.frontend_kwargs = frontend_kwargs

    def next_batch(self) -> dict:
        b = batch_at(self.cfg, self.state.step, **self.frontend_kwargs)
        self.state.step += 1
        return b
