"""Continuous (iteration-level) batching engine: the port of
``repro.serve.continuous``.

Slots share one global cache index; a request admitted at step t gets
``start[slot] = t`` — its stale cache region is masked by the attention
visibility test and its rope positions are request-local, so NO cache reset
or copy is needed on admission for KV-cache state.  Prompt tokens are
consumed one per step (piggyback/chunked prefill): a freshly admitted
request "catches up" while other slots keep generating, which is exactly
the orca-style schedule that keeps the decode batch full.

Recurrent state (SSM/xLSTM/hybrid) has no positional masking to hide
behind, so on admission the new tenant's slot is zeroed in every
non-KV cache leaf (``_reset_slot``, in place) — with that, any
``layer_pattern`` of attn/local/moe/mlstm/slstm/hybrid blocks can
continuously batch; only encoder-decoder archs are out.

Admission order can be cost-aware: with a fitted NN+C model the queue is
served shortest-predicted-job-first (the paper's runtime mapping decision,
§1).  The predictors live in the runtime tuning cache as the split
``prefill_step``/``decode_step`` pseudo-kernels (see ``serve.policy``), so
every engine on the same hardware fingerprint shares the fitted models.

The batcher runs where its ``params`` lie: the cache is made on the
device of their first leaf, and the model step writes it in place
(``Model.decode_step``), where the reference's jitted step donates it.

``ContinuousBatcher`` is the mechanism layer: queue/slot/token accounting
with overridable hooks (``_order_queue``, ``_execute``, ``_on_admit``,
``_on_token``, ``_on_done``).  ``serve.engine.ServeEngine`` builds the
predictor-driven, telemetry-reporting engine on top of these hooks.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.models import module
from repro_torch.models.registry import Model
# Back-compat re-exports: the admission cost model moved to serve.policy
# when the decode_step pseudo-kernel split into prefill_step/decode_step.
from repro_torch.serve.policy import (  # noqa: F401
    ColdCacheError, DECODE_STEP_FEATURES, DECODE_STEP_KERNEL,
    PREFILL_STEP_FEATURES, PREFILL_STEP_KERNEL, cost_model_from_cache,
    record_request_time, split_cost_model_from_cache)

# cache leaves that are positional KV state (masked via start, never
# reset); everything else is recurrent state and is zeroed on admission
_KV_LEAVES = frozenset({"k", "v", "xk", "xv"})
_RECURRENT_KINDS = frozenset({"mlstm", "slstm", "hybrid"})
_SUPPORTED_KINDS = frozenset({"attn", "local", "moe"}) | _RECURRENT_KINDS


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list                 # token ids
    max_new: int
    # filled by the engine
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


# One step function per (model, stream_kv), as the reference keeps one
# jitted step per pair.  The model reference in the value keeps the id()
# key stable for the memo's lifetime.
_STEP_FNS: dict = {}


def _model_step(model: Model, stream_kv: bool):
    """``(params, cache, tokens [B,1], index, start [B]) -> (next tokens
    [B,1] int32 on the device, cache)``: one greedy decode step that
    writes ``cache`` in place."""
    key = (id(model), bool(stream_kv))
    hit = _STEP_FNS.get(key)
    if hit is not None and hit[0] is model:
        return hit[1]

    def step_fn(params, cache, tokens, index, start):
        # inference mode is per thread: entered here, so that a step run
        # on an executor's lane worker gets it too
        with torch.inference_mode():
            logits, cache = model.decode_step(params, cache, tokens, index,
                                              start=start,
                                              stream_kv=stream_kv)
            return logits.argmax(-1).to(torch.int32), cache

    _STEP_FNS[key] = (model, step_fn)
    return step_fn


def _zero_slot(tree: dict, slot: int, axis: int) -> None:
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _zero_slot(leaf, slot, axis)
        elif name not in _KV_LEAVES:
            leaf.select(axis, slot).zero_()


@torch.inference_mode()
def _reset_slot(cache: dict, slot: int) -> dict:
    """Zero one slot's recurrent state across the whole cache tree, in
    place.  The batch axis is 1 under "scan" (leaves are period-stacked)
    and 0 under "tail"."""
    for sub in cache.get("scan", {}).values():
        _zero_slot(sub, slot, 1)
    for sub in cache["tail"].values():
        _zero_slot(sub, slot, 0)
    return cache


class ContinuousBatcher:
    def __init__(self, model: Model, params, *, max_slots: int,
                 max_seq: int, cost_model=None, stream_kv: bool = False):
        cfg = model.cfg
        assert not cfg.encdec, \
            "continuous batching does not support encoder-decoder archs"
        assert all(k in _SUPPORTED_KINDS for k in cfg.layer_pattern), \
            f"continuous batching supports {sorted(_SUPPORTED_KINDS)} " \
            f"blocks, got {cfg.layer_pattern}"
        self.model = model
        self.params = params
        self.device = module.leaves(params)[0].device
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.cost_model = cost_model
        self.stream_kv = bool(stream_kv)
        self.recurrent = any(k in _RECURRENT_KINDS
                             for k in cfg.layer_pattern)
        self.cache = model.init_cache(max_slots, max_seq, device=self.device)
        self.index = 0
        self.slots: list[Optional[Request]] = [None] * max_slots
        self.start = np.zeros(max_slots, np.int32)
        self.prompt_left = np.zeros(max_slots, np.int32)
        self.queue: deque[Request] = deque()
        self.steps = 0
        self.busy_slot_steps = 0
        self._step = _model_step(model, self.stream_kv)
        # the caller's stream on the card: a step run on another thread
        # (an executor's lane worker) enqueues on it too
        self._stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None

    # -- queue ---------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _order_queue(self) -> None:
        """Reorder the waiting queue before admission (hook).  Base policy:
        shortest-predicted-job-first when a cost model is set, else FIFO."""
        if self.cost_model is not None:
            jobs = sorted(self.queue,
                          key=lambda r: self.cost_model(len(r.prompt),
                                                        r.max_new))
            self.queue = deque(jobs)

    def _admit(self):
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return
        self._order_queue()
        for slot in free:
            if not self.queue:
                break
            req = self.queue.popleft()
            if self.index + len(req.prompt) + req.max_new > self.max_seq:
                self.queue.appendleft(req)   # would overflow: wait for reset
                break
            self.slots[slot] = req
            self.start[slot] = self.index
            self.prompt_left[slot] = len(req.prompt)
            if self.recurrent:
                # positional masking can't hide a previous tenant's
                # recurrent state — zero the slot's non-KV leaves
                self.cache = _reset_slot(self.cache, slot)
            self._on_admit(req, slot)

    # -- hooks (no-ops here; ServeEngine instruments them) -------------------
    def _on_admit(self, req: Request, slot: int) -> None:
        pass

    def _on_token(self, req: Request, slot: int, first: bool) -> None:
        pass

    def _on_done(self, req: Request, slot: int) -> None:
        pass

    # -- one engine iteration ------------------------------------------------
    def _assemble(self, active: list) -> np.ndarray:
        """Token batch for this iteration: the next prompt token for slots
        still prefilling, else the last generated token."""
        tokens = np.zeros((self.max_slots, 1), np.int32)
        for i in active:
            req = self.slots[i]
            consumed = len(req.prompt) - int(self.prompt_left[i])
            if self.prompt_left[i] > 0:
                tokens[i, 0] = req.prompt[consumed]
            else:
                tokens[i, 0] = req.generated[-1]
        return tokens

    def _run_model(self, tokens, start) -> torch.Tensor:
        """One model step over the batcher's cache from host ``tokens``
        [B,1] and ``start`` [B]; the next tokens stay on the device.  On
        the card the batcher's stream (and so its card) is made current
        first, on whichever thread runs the step."""
        on_device = contextlib.nullcontext() if self._stream is None \
            else torch.cuda.stream(self._stream)
        with on_device:
            next_tok, self.cache = self._step(
                self.params, self.cache,
                torch.from_numpy(np.asarray(tokens)).to(self.device),
                self.index,
                torch.from_numpy(np.asarray(start)).to(self.device))
        return next_tok

    def _execute(self, tokens: np.ndarray) -> np.ndarray:
        """Run one model step (hook — ServeEngine routes this through a
        compiled ``repro_torch.api`` program on the executor)."""
        return self._run_model(tokens, self.start).cpu().numpy()

    def step(self) -> bool:
        """Returns True while there is work."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            if not self.queue:
                return False
            # every slot is drained but the queue head would overflow the
            # shared cache region: all positions are dead tenants, so the
            # region is reclaimable — rewind and re-admit.
            self.index = 0
            self._admit()
            active = [i for i, s in enumerate(self.slots) if s is not None]
            if not active:       # a request that can never fit
                return False
        tokens = self._assemble(active)
        next_tok = self._execute(tokens)
        for i in active:
            req = self.slots[i]
            if self.prompt_left[i] > 1:
                self.prompt_left[i] -= 1          # still prefilling: ignore
            else:
                if self.prompt_left[i] == 1:
                    self.prompt_left[i] = 0       # last prompt token
                req.generated.append(int(next_tok[i, 0]))
                self._on_token(req, i, first=len(req.generated) == 1)
            if len(req.generated) >= req.max_new:
                req.done = True
                self.slots[i] = None
                self._on_done(req, i)
        self.index += 1
        self.steps += 1
        self.busy_slot_steps += len(active)
        return True

    def run(self, max_steps: int = 100000) -> dict:
        while self.step():
            if self.steps >= max_steps:
                break
        return {"engine_steps": self.steps,
                "occupancy": self.busy_slot_steps
                / max(self.steps * self.max_slots, 1)}
