"""Serving requests + seeded arrival processes: the port of
``repro.serve.request``, drawing the same traces from the same numpy
``RandomState`` seeds.

``ServeRequest`` extends the batcher's ``Request`` with the lifecycle
timestamps the engine's telemetry needs (TTFT, per-token latency,
queue wait) and a *step-indexed* arrival time: traces schedule arrivals
on engine iterations, not wall-clock, so admission order — and therefore
every ordering test and the bench's SJF-vs-FIFO comparison — is
deterministic, while the recorded timestamps are real wall-clock and
feed the ``repro_torch.obs`` histograms.

The two generators cover the classic serving regimes: ``poisson_trace``
(memoryless steady load) and ``bursty_trace`` (batched bursts of mixed
short/long jobs — the trace where cost-aware admission visibly beats
FIFO, because a short job stuck behind a long one dominates p99).
Both are seeded and return plain lists, so the same trace can be driven
through several engines/policies for comparison.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.serve.continuous import Request


@dataclasses.dataclass
class ServeRequest(Request):
    arrival_step: int = 0            # engine iteration the request arrives at
    # wall-clock lifecycle stamps, filled by the engine
    submitted_s: Optional[float] = None
    admitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None
    predicted_s: Optional[float] = None   # cost model's service-time estimate
    slot: Optional[int] = None
    rejected: bool = False           # bounded queue was full at submit

    @property
    def ttft_s(self) -> Optional[float]:
        if self.submitted_s is None or self.first_token_s is None:
            return None
        return self.first_token_s - self.submitted_s

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.submitted_s is None or self.admitted_s is None:
            return None
        return self.admitted_s - self.submitted_s

    @property
    def service_s(self) -> Optional[float]:
        if self.admitted_s is None or self.finished_s is None:
            return None
        return self.finished_s - self.admitted_s


def _mk_request(rid: int, rng: np.random.RandomState, arrival_step: int,
                prompt_len: int, max_new: int, vocab: int) -> ServeRequest:
    prompt = [int(t) for t in rng.randint(1, vocab, size=prompt_len)]
    return ServeRequest(rid=rid, prompt=prompt, max_new=int(max_new),
                        arrival_step=int(arrival_step))


def poisson_trace(n_requests: int, *, seed: int = 0, rate: float = 0.5,
                  prompt_lens=(2, 4, 8), max_news=(4, 8), vocab: int = 256,
                  ) -> list:
    """Memoryless arrivals: geometric inter-arrival gaps (the discrete
    analog of exponential) at ``rate`` requests per engine step, with
    prompt/new lengths drawn uniformly from the given menus."""
    rng = np.random.RandomState(seed)
    reqs, step = [], 0
    for rid in range(n_requests):
        step += int(rng.geometric(min(max(rate, 1e-6), 1.0)) - 1)
        reqs.append(_mk_request(
            rid, rng, step,
            int(rng.choice(prompt_lens)), int(rng.choice(max_news)), vocab))
    return reqs


def bursty_trace(n_bursts: int = 3, *, seed: int = 0, burst_gap: int = 24,
                 short=(2, 4), long=(24, 16), shorts_per_burst: int = 3,
                 longs_per_burst: int = 1, vocab: int = 256) -> list:
    """Bursts of simultaneous arrivals mixing short and long jobs.

    Each burst lands ``shorts_per_burst`` short jobs (prompt, max_new =
    ``short``) and ``longs_per_burst`` long jobs (``long``) on the *same*
    engine step, in seeded-shuffled submit order — so FIFO sometimes
    heads a long job in front of the shorts and SJF reorders them.
    """
    rng = np.random.RandomState(seed)
    reqs, rid = [], 0
    for b in range(n_bursts):
        step = b * burst_gap
        shapes = ([short] * shorts_per_burst + [long] * longs_per_burst)
        rng.shuffle(shapes)
        for prompt_len, max_new in shapes:
            reqs.append(_mk_request(rid, rng, step, prompt_len, max_new,
                                    vocab))
            rid += 1
    return reqs
