"""The MoE combine over blocks of tokens (``models.moe._combine_tokens``,
the global dispatch) and of slots (``_combine_slots``, the local one),
against the one-block composition they replace, kept here as
``_plain_*``.

* Each combine on numpy-drawn inputs (bf16 and fp32 expert outputs,
  sources outside this rank's slots, each of its slots read by one
  (token, slot) as the dispatch table gives them, repeated tokens, empty
  slots), over
  blocks of 4 tokens or 5 slots: the output and the gradients of the
  expert outputs and the weights to the bit.
* ``moe_apply`` of qwen3-moe-235b-a22b at ``reduced()`` (bf16 compute),
  both dispatches, over blocks of 3 tokens or 24 slots against one
  block of every row: the output, the aux loss and every gradient to
  the bit.
* On fake tensors at qwen3-moe's per-rank ``prefill_32k`` shapes (x
  [2, 32768, 4096] bf16, 128 experts top-8, N·k = 524288 slots; the
  global dispatch at full width, without a mesh) under
  ``launch.dryrun.OpCounter``: no fp32 storage larger than the fp32 y
  [N, d] the reference also holds, where the one-block composition
  makes fp32 [N·k, d] buffers (8 GiB).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.models import layers, moe
from test_torch_norm import _Fp32Storages

N, K, SLOTS, D = 37, 3, 20, 16
PREFILL_X = (2, 32768, 4096)
ARCH = "qwen3-moe-235b-a22b"


def _plain_combine_tokens(ye_rows, src, weights):
    """The global combine as one block of every slot, as it ran before
    the blocks."""
    n, k = src.shape
    slots, d = ye_rows.shape
    flat_src = src.reshape(-1)
    held = (flat_src >= 0) & (flat_src < slots)
    gathered = ye_rows[torch.clamp(flat_src, 0, slots - 1)]
    gathered = gathered.float() * weights.reshape(-1)[:, None]
    gathered = torch.where(held[:, None], gathered, 0.0)
    token_ids = torch.arange(n)[:, None].expand(n, k)
    y = torch.zeros((n, d), dtype=torch.float32)
    y.index_add_(0, token_ids.reshape(-1), gathered)
    return y


def _plain_combine_slots(ye, w_slot, occupied, dispatch, nl):
    """The local combine as one block of every slot, as it ran before
    the blocks."""
    shards, e_loc, cap, d = ye.shape
    contrib = (ye * w_slot[..., None].to(ye.dtype)
               * occupied[..., None].to(ye.dtype))
    scatter_shard = torch.arange(shards)[:, None].expand(
        shards, e_loc * cap).reshape(-1)
    y = torch.zeros((shards, nl, d), dtype=torch.float32)
    y.index_put_((scatter_shard, dispatch.reshape(-1)),
                 contrib.reshape(-1, d).float(), accumulate=True)
    return y


def _grads(fn, *args):
    """(fn's output, the gradients of its floating inputs) for a seeded
    cotangent."""
    live = [a.clone().requires_grad_() if a.is_floating_point() else a
            for a in args]
    y = fn(*live)
    cot = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(y.shape)).astype(np.float32))
    y.backward(cot)
    return [y.detach()] + [a.grad for a in live if a.is_floating_point()]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_combine_tokens_bit_equal_to_one_block(monkeypatch, dtype):
    rng = np.random.default_rng(0)
    ye = torch.from_numpy(rng.standard_normal((SLOTS, D)).astype(
        np.float32)).to(dtype)
    # sources below and past this rank's slots, and each of its slots
    # once, as the dispatch table gives them
    src = rng.integers(SLOTS, SLOTS + 6, N * K) - rng.choice(
        [0, SLOTS + 6], N * K)
    src[rng.choice(N * K, SLOTS, replace=False)] = rng.permutation(SLOTS)
    src = torch.from_numpy(src.reshape(N, K))
    weights = torch.from_numpy(rng.random((N, K)).astype(np.float32))
    monkeypatch.setattr(layers, "ROW_CHUNK_BYTES", 4 * K * D * 4)
    assert len(layers.row_chunks(N, K * D)) == 10
    _same(_grads(moe._combine_tokens, ye, src, weights),
          _grads(_plain_combine_tokens, ye, src, weights))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_combine_slots_bit_equal_to_one_block(monkeypatch, dtype):
    rng = np.random.default_rng(1)
    shards, e_loc, cap, nl = 2, 3, 4, 7
    ye = torch.from_numpy(rng.standard_normal(
        (shards, e_loc, cap, D)).astype(np.float32)).to(dtype)
    w_slot = torch.from_numpy(rng.random((shards, e_loc, cap)).astype(
        np.float32))
    occupied = torch.from_numpy(rng.random((shards, e_loc, cap)) < 0.7)
    dispatch = torch.from_numpy(rng.integers(0, nl, (shards, e_loc, cap)))
    dispatch[~occupied] = 0          # an empty slot points at token 0
    monkeypatch.setattr(layers, "ROW_CHUNK_BYTES", 5 * D * 4)
    assert len(layers.row_chunks(shards * e_loc * cap, D)) == 5

    def fn(ye, w):
        return moe._combine_slots(ye, w, occupied, dispatch, nl)

    def plain(ye, w):
        return _plain_combine_slots(ye, w, occupied, dispatch, nl)

    _same(_grads(fn, ye, w_slot), _grads(plain, ye, w_slot))


def _apply(cfg, params, x):
    live = {k: v.clone().requires_grad_() for k, v in params.items()}
    xx = x.clone().requires_grad_()
    y, aux = moe.moe_apply(cfg, live, xx)
    (y.float().square().sum() + aux).backward()
    return [y.detach(), aux.detach(), xx.grad] + [live[k].grad
                                                  for k in sorted(live)]


@pytest.mark.parametrize("dispatch", ["global", "local"])
def test_moe_apply_bit_equal_across_blocks(monkeypatch, dispatch):
    cfg = dataclasses.replace(configs.ARCHS[ARCH].reduced(),
                              moe_dispatch=dispatch)
    rng = np.random.default_rng(2)
    params = {k: torch.from_numpy((0.1 * rng.standard_normal(v.shape))
                                  .astype(np.float32))
              for k, v in moe.moe_spec(cfg).items()}
    x = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    whole = _apply(cfg, params, x)
    width = cfg.d_model * (cfg.moe_top_k if dispatch == "global" else 1)
    rows = 3 if dispatch == "global" else 24
    monkeypatch.setattr(layers, "ROW_CHUNK_BYTES", rows * width * 4)
    _same(_apply(cfg, params, x), whole)


def _largest_f32_at_prefill():
    cfg = configs.ARCHS[ARCH]
    with FakeTensorMode():
        params = {k: torch.empty(v.shape, dtype=torch.bfloat16)
                  for k, v in moe.moe_spec(cfg).items()}
        x = torch.empty(PREFILL_X, dtype=torch.bfloat16)
        counter = _Fp32Storages()
        with counter, torch.no_grad():
            moe.moe_apply(cfg, params, x)
    return counter.largest_f32


def test_combine_fp32_storages_at_qwen3_prefill(monkeypatch):
    n, d = PREFILL_X[0] * PREFILL_X[1], PREFILL_X[2]
    k = configs.ARCHS[ARCH].moe_top_k
    largest = _largest_f32_at_prefill()
    assert largest == n * d * 4, largest          # y [N, d] alone
    monkeypatch.setattr(moe, "_combine_tokens", _plain_combine_tokens)
    assert _largest_f32_at_prefill() == n * k * d * 4
