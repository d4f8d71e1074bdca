"""The long-context decode on each rank's block of the KV cache's sequence,
the one KV head a rank beside split q heads, and the chunked CE's autograd
Function split over the vocabulary, on a gloo world of 4 ranks.

Each rank runs ``python -c SCRIPT`` (a ``file://`` rendezvous under the
test's temporary directory, one intra-op thread, a group timeout; every
rank killed at the first failure or the deadline) on a ``("model",)`` mesh
of 4, and beside it the same work in one process (no mesh):

* gemma3-1b and hymba-1.5b at ``reduced()``, fp32 compute, prefill B = 2
  prompts of 24 tokens through ``make_prefill_step`` under
  ``serve_rules(long_context=True)``; the cache is then cut into
  ``cache_seq`` blocks with ``shard_tree`` and ``cache_shardings`` (8 of
  its 32 positions a rank) and 8 greedy decode steps run on them, through
  ``make_serve_step`` (the plain step: a max all-reduce and one psum of
  the softmax stats) and through ``decode_step(stream_kv=True)`` (the
  decode ring).  Logits within 1e-5 of one process's largest, tokens
  equal, every rank's logits the same bits, and each rank holding a
  quarter of the cache's bytes.  With the new token written on every
  rank's block (planted) gemma3-1b's logits land above the bound (its
  global layer sees the stray positions; hymba's windows of 8 do not).
* yi-9b at ``reduced()`` (4 q heads split over 4 ranks, 2 KV heads whole)
  under ``train_rules()``: each rank projects the one KV head its q head
  reads (``attention._kv_one_head``); the loss and every gradient leaf of
  ``make_loss_fn`` within 2e-4 of one process's (the split steps' bound).
* the chunked CE (``train.step.chunked_cross_entropy``) on this rank's
  vocabulary block against the autograd segment it replaced (the logits
  through ``copy_to`` and an einsum, ``_lse_gold``, under
  ``torch.utils.checkpoint``), fp32 with ignored labels and the z-loss:
  loss and the gradients of h and the whole table within 1e-6 relative.
"""
import json
import subprocess
import sys
import textwrap
import time

import pytest

from test_torch_dist_blocked import ENV, _wait_all

DEADLINE_S = 240
GROUP_TIMEOUT_S = 120
WORLD = 4
ARCHS = ["gemma3-1b", "hymba-1.5b"]
B, PROMPT, STEPS = 2, 24, 8
TOL = 1e-5            # the long decode's logits, of one process's largest
SPLIT_TOL = 2e-4      # the split steps' bound
CE_TOL = 1e-6

SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    from torch.utils import checkpoint
    torch.set_num_threads(1)
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.dist import collectives, compat
    from repro_torch.dist import sharding as shd
    from repro_torch.models import attention, build_model
    from repro_torch.serve.decode import (_whole_vocab, make_prefill_step,
                                          make_serve_step)
    from repro_torch.train import step as train_step

    ARCHS, WORLD, (B, PROMPT, STEPS) = %r, %r, %r
    rank = int(sys.argv[2])
    compat.init_process_group("cpu", init_method=sys.argv[3], rank=rank,
                              world_size=WORLD, timeout_s=float(sys.argv[4]))
    mesh = compat.make_mesh((WORLD,), ("model",))
    long_rules = shd.serve_rules(long_context=True)
    report = {"decode": {}, "bytes": {}, "equal": {}}

    def same_on_ranks(t):
        prints = collectives.all_ranks(collectives.fingerprint(t))
        return len(set(prints)) == 1

    def err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def model_of(name):
        cfg = dataclasses.replace(configs.ARCHS[name].reduced(),
                                  compute_dtype="float32")
        model = build_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device="cpu")
        return model, params

    def decode(model, params, prompt, mesh, stream):
        # greedy tokens and the [B, V] logits rows of STEPS decode steps
        prefill = make_prefill_step(model, PROMPT + STEPS)
        serve = make_serve_step(model)
        tok, cache = prefill(params, {"tokens": prompt})
        if mesh is not None:
            specs = model.cache_specs(B, PROMPT + STEPS)
            cache = shd.shard_tree(cache, shd.cache_shardings(
                specs, mesh, long_rules), mesh)
        toks, rows = [tok], []
        for i in range(STEPS):
            if stream:
                lg, _ = model.decode_step(params, cache, toks[-1],
                                          PROMPT + i, stream_kv=True)
                lg = _whole_vocab(model, lg, 1)
                tok = lg.argmax(-1).to(torch.int32)
            else:
                tok, lg, cache = serve(params, cache, toks[-1], PROMPT + i)
            toks.append(tok)
            rows.append(lg[:, 0].float())
        return torch.cat(toks, 1), torch.stack(rows), cache

    def held_bytes(cache):
        out = [0, 0]
        for path, leaf in flat(cache):
            if path.split("/")[-1] in ("k", "v"):
                whole = shd.whole_shape(leaf)
                out[0] += shd.local(leaf).untyped_storage().nbytes()
                out[1] += int(np.prod(whole)) * leaf.dtype.itemsize
        return out

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], f"{prefix}{k}/")
        else:
            yield prefix[:-1], tree

    def everywhere(cache, new, index):
        # planted: the token written on every rank's block
        at = index %% cache.local.shape[1]
        cache.local[:, at:at + 1] = new.to(cache.dtype)

    prompt = torch.from_numpy(np.random.RandomState(1).randint(
        1, 256, (B, PROMPT)).astype(np.int32))
    with torch.no_grad():
        for name in ARCHS:
            model, params = model_of(name)
            want_tok, want, _ = decode(model, params, prompt, None, False)
            for stream in (False, True):
                key = f"{name}/{'stream' if stream else 'plain'}"
                with shd.use_mesh(mesh, long_rules):
                    tok, rows, cache = decode(model, params, prompt, mesh,
                                              stream)
                report["decode"][key] = {
                    "err": err(rows, want),
                    "tokens": bool(torch.equal(tok, want_tok)),
                    "blocks": all(isinstance(leaf, shd.Block)
                                  for p, leaf in flat(cache)
                                  if p.split("/")[-1] in ("k", "v"))}
                report["equal"][key] = same_on_ranks(rows)
                report["bytes"][key] = held_bytes(cache)
            if name == "gemma3-1b":
                real = attention._write_token
                attention._write_token = everywhere
                try:
                    with shd.use_mesh(mesh, long_rules):
                        _, rows, _ = decode(model, params, prompt, mesh,
                                            False)
                finally:
                    attention._write_token = real
                report["planted"] = err(rows, want)

    # one KV head a rank beside split q heads: a loss and its gradients
    cfg = dataclasses.replace(configs.ARCHS["yi-9b"].reduced(),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    batch = batch_at(DataConfig(cfg.vocab_size, 16, B), 0, device="cpu")
    grad_fn = train_step._value_and_grad(train_step.make_loss_fn(
        model, train_step.TrainStepConfig()))
    (want_loss, _), want_grads = grad_fn(params, batch)
    real, calls = attention._kv_one_head, []

    def counted(*args):
        calls.append(1)
        return real(*args)

    attention._kv_one_head = counted
    try:
        with shd.use_mesh(mesh, shd.train_rules()):
            axes = attention.head_axes(cfg, B, 16)
            (loss, _), grads = grad_fn(params, batch)
    finally:
        attention._kv_one_head = real
    report["split"] = {
        "axes": [list(a) for a in axes], "calls": len(calls),
        "loss": abs(float(loss) - float(want_loss)) / abs(float(want_loss)),
        "grads": max(err(g, w) if w.abs().max() > 0 else float(g.abs().max())
                     for (_, g), (_, w) in zip(flat(grads),
                                               flat(want_grads))),
        "equal": same_on_ranks(torch.cat([g.flatten() for _, g in
                                          flat(grads)]))}

    # the CE on this rank's vocabulary block against the autograd segment
    rng = np.random.RandomState(2)
    h = torch.from_numpy(rng.randn(B, 12, 32).astype(np.float32))
    table = torch.from_numpy(rng.randn(64, 32).astype(np.float32) * 0.3)
    labels = torch.from_numpy(rng.randint(0, 64, (B, 12)))
    labels[0, :3] = train_step.IGNORE_LABEL
    axes = ("model",)

    def autograd_segment(h, lab, t32):
        h32 = collectives.copy_to(h.to(torch.float32), mesh, axes)
        logits = torch.einsum("bsd,vd->bsv", h32, t32)
        mask = lab != train_step.IGNORE_LABEL
        safe = torch.where(mask, lab, 0).long()
        lse, gold = train_step._lse_gold(logits, safe, axes)
        return (((lse - gold) * mask).sum(), (torch.square(lse) * mask).sum(),
                mask.sum())

    def ce(segment):
        hh, tt = h.clone().requires_grad_(), table.clone().requires_grad_()
        block = shd.take(tt, 0, axes)
        nll = zl = 0.0
        count = 0
        for c in range(3):
            args = (hh[:, 4 * c:4 * c + 4], labels[:, 4 * c:4 * c + 4], block)
            seg = segment(*args)
            nll, zl, count = nll + seg[0], zl + seg[1], count + seg[2]
        loss = (nll + 1e-4 * zl) / count
        return (loss,) + torch.autograd.grad(loss, (hh, tt))

    with shd.use_mesh(mesh, shd.train_rules()):
        got = ce(lambda *a: train_step._ce_segment(*a, axes))
        want = ce(lambda *a: checkpoint.checkpoint(
            shd.bind_frame(autograd_segment), *a, use_reentrant=False))
    report["ce"] = [err(g, w) for g, w in zip(got, want)]

    if rank == 0:
        with open(sys.argv[1], "w") as fh:
            json.dump(report, fh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
""") % (ARCHS, WORLD, (B, PROMPT, STEPS))


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_long")
    out = tmp / "report.json"
    procs = [subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(out), str(r),
         f"file://{tmp / 'rendezvous'}", str(GROUP_TIMEOUT_S)],
        env=ENV, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    deadline = time.monotonic() + DEADLINE_S
    for r, (rc, _, err) in enumerate(_wait_all(procs, deadline)):
        assert rc == 0, f"rank {r} exited {rc}: {err[-3000:]}"
    return json.loads(out.read_text())


CASES = [f"{a}/{m}" for a in ARCHS for m in ("plain", "stream")]


@pytest.mark.parametrize("case", CASES)
def test_long_decode_on_sequence_blocks_matches_one_process(report, case):
    got = report["decode"][case]
    assert got["blocks"], got
    assert got["err"] <= TOL, got
    assert got["tokens"], got
    assert report["equal"][case]


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_a_quarter_of_the_cache(report, case):
    held, whole = report["bytes"][case]
    assert held * WORLD == whole > 0, (held, whole)


def test_token_written_on_every_block_is_caught(report):
    assert report["planted"] > TOL, report["planted"]


def test_one_kv_head_beside_split_q_heads_matches_one_process(report):
    split = report["split"]
    assert split["axes"] == [["model"], []], split
    assert split["calls"] > 0, split
    assert split["loss"] <= SPLIT_TOL and split["grads"] <= SPLIT_TOL, split
    assert split["equal"], split


@pytest.mark.parametrize("what", ["loss", "dh", "dtable"])
def test_vocab_parallel_ce_matches_the_autograd_segment(report, what):
    got = report["ce"][["loss", "dh", "dtable"].index(what)]
    assert got <= CE_TOL, got
