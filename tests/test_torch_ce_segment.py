"""The chunked CE's autograd Function (``train.step._CESegment``) against
the autograd segment it replaced, on the CPU, and whisper-medium's
``train_4k`` cell of the dry-run at 1 layer against the JAX package's.

* The loss and the gradients of the hidden states and the table, fp32
  with ignored labels and the z-loss, within 1e-6 relative of the
  checkpointed autograd segment (the logits through ``whole_matmul``,
  ``_lse_gold``, ``torch.utils.checkpoint``), with the table whole and
  with no mesh.  (Split over the vocabulary on gloo ranks:
  ``tests/test_torch_dist_long.py``.)
* One segment's backward, under the dry-run's ``OpCounter``, keeps one
  [b, chunk, V] fp32 storage live at most (the recomputed logits, made
  their cotangent in place); the autograd segment kept five at once.
* whisper-medium ``train_4k`` at 1 layer (B = 256, S = 4096 on the fake
  group of ``pod16x16``; its vocabulary of 51865 stays whole on every
  rank): the peak a rank at most the JAX package's and the FLOPs
  0.98–1.02x.  The JAX package's figures, from ``PYTHONPATH=src python3
  tests/dryrun_depth.py --package repro --arch whisper-medium --shape
  train_4k --layers 1 --out /tmp/j.json``, are kept as constants.
"""
import dataclasses
import weakref

import numpy as np
import pytest
import torch
from torch.utils import checkpoint

from repro_torch.launch import dryrun
from repro_torch.models.layers import whole_matmul
from repro_torch.train import step

TOL = 1e-6
B, C, D, V = 2, 8, 24, 4096
# the JAX package's whisper-medium train_4k at 1 layer (command above)
JAX_WHISPER = (27118459506563.0, 8704499172)
LOW, HIGH = 0.98, 1.02


def _autograd_segment(h, lab, t32):
    logits = whole_matmul(h.to(torch.float32), t32.t(), 0)
    mask = lab != step.IGNORE_LABEL
    safe = torch.where(mask, lab, 0).long()
    lse, gold = step._lse_gold(logits, safe)
    return (((lse - gold) * mask).sum(), (torch.square(lse) * mask).sum(),
            mask.sum())


def _checkpointed(h, lab, t32, axes=()):
    return checkpoint.checkpoint(_autograd_segment, h, lab, t32,
                                 use_reentrant=False)


def _inputs(seed=0, chunks=3):
    rng = np.random.RandomState(seed)
    h = torch.from_numpy(rng.randn(B, C * chunks, D).astype(np.float32))
    table = torch.from_numpy(rng.randn(V, D).astype(np.float32) * 0.3)
    labels = torch.from_numpy(rng.randint(0, V, (B, C * chunks)))
    labels[0, 2:7] = step.IGNORE_LABEL
    labels[1, -1] = step.IGNORE_LABEL
    return h, table, labels


def _loss_and_grads(segment, monkeypatch, chunks=3):
    h, table, labels = _inputs(chunks=chunks)
    h.requires_grad_()
    table.requires_grad_()
    monkeypatch.setattr(step, "_ce_segment", segment)
    loss, ce = step.chunked_cross_entropy(h, table, labels, chunk=C,
                                          z_loss=1e-2)
    return (loss, ce) + torch.autograd.grad(loss, (h, table))


@pytest.mark.parametrize("what", ["loss", "ce", "dh", "dtable"])
def test_ce_function_matches_the_autograd_segment(monkeypatch, what):
    i = ["loss", "ce", "dh", "dtable"].index(what)
    with monkeypatch.context() as mp:
        got = _loss_and_grads(step._ce_segment, mp)[i]
    with monkeypatch.context() as mp:
        want = _loss_and_grads(_checkpointed, mp)[i]
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= TOL, rel


class _Buffers(dryrun.OpCounter):
    """An ``OpCounter`` that also counts the live storages of ``nbytes``
    bytes and the most of them alive at once since ``reset``."""

    def __init__(self, nbytes: int):
        super().__init__()
        self.nbytes, self.live, self.most = nbytes, 0, 0

    def track(self, tensors) -> None:
        for t in dryrun._tensors(tensors):
            st = t.untyped_storage()
            if st not in self._live and st.nbytes() == self.nbytes:
                self.live += 1
                self.most = max(self.most, self.live)
                weakref.finalize(st, self._gone)
        super().track(tensors)

    def _gone(self) -> None:
        self.live -= 1

    def reset(self) -> None:
        self.most = self.live


@pytest.mark.parametrize("segment,most", [("function", 1), ("autograd", 5)])
def test_one_logits_buffer_live_in_a_segments_backward(monkeypatch, segment,
                                                       most):
    fn = step._ce_segment if segment == "function" else _checkpointed
    monkeypatch.setattr(step, "_ce_segment", fn)
    h, table, labels = _inputs(chunks=1)
    h.requires_grad_()
    table.requires_grad_()
    counter = _Buffers(B * C * V * 4)
    with counter:
        loss, _ = step.chunked_cross_entropy(h, table, labels, chunk=C)
        assert counter.live == 0          # the forward keeps no logits
        counter.reset()
        torch.autograd.grad(loss, (h, table))
    assert counter.most == most, counter.most


@pytest.fixture(scope="module")
def whisper():
    full = dryrun.get_arch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "get_arch", lambda name: dataclasses.replace(
            full(name), n_layers=1))
        return dryrun.run_cell("whisper-medium", "train_4k", verbose=False)


def test_whisper_peak_at_most_the_jax_package(whisper):
    total = whisper["memory_per_device_bytes"]["total_bytes"]
    assert total <= JAX_WHISPER[1], total / JAX_WHISPER[1]


def test_whisper_flops_against_the_jax_package(whisper):
    ratio = whisper["per_device_flops"] / JAX_WHISPER[0]
    assert LOW <= ratio <= HIGH, ratio
