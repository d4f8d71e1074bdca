"""The blocked layout (``dist.sharding.shard_tree``/``gather_tree``) against
the global view on gloo worlds of 2 and 4, and against the JAX package.

Each rank of a world runs ``python -c PORT_SCRIPT`` (a ``file://``
rendezvous under the test's temporary directory, one intra-op thread, a
group timeout; every rank killed at the first failure or the deadline).
On each mesh — a world of 2 as ``("model",)`` and as ``("data",)``, a
world of 4 as ``("data", "model")`` of (2, 2) — and for gemma3-1b and
qwen3-moe (the shard_map MoE, capacity factor 8) at ``reduced()`` with
fp32 compute and the JAX package's weights, every rank runs each case
twice, once on whole leaves (the global view) and once on blocks:

  * ``forward`` under ``train_rules()``;
  * ``make_prefill_step`` and three ``make_serve_step``s under
    ``serve_rules()`` (tokens and cache blocked over the batch);
  * one ``make_train_step`` step with AdamW (clipping on) under
    ``train_rules()``, and under ``train_rules(fsdp=True)`` on the (2, 2)
    mesh, whose params are split over the data axis too.

The two must agree bit for bit (logits, tokens, metrics, and the whole
params, moments and caches ``gather_tree`` gives back), and every rank
must hold the same bits.  The forward's and decode's logits are held to
the JAX package's within the model tests' 1e-4 of the largest logit.  The
dry-run's blocked per-rank figure for full-width gemma3-1b ``decode_32k``
lies under 10 GiB.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.serve.decode import ServeConfig as JServeConfig
from repro.serve.decode import make_prefill_step as jprefill_step
from repro.serve.decode import make_serve_step as jserve_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
       "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
       "PYTHONUNBUFFERED": "1"}
DEADLINE_S = 300            # both worlds, from their start
GROUP_TIMEOUT_S = 120       # a collective no peer answers fails the rank
ARCHS = ["gemma3-1b", "qwen3-moe-235b-a22b"]
MESHES = {2: {"model2": ((2,), ("model",)), "data2": ((2,), ("data",))},
          4: {"2x2": ((2, 2), ("data", "model"))}}
B, S, PRE, STEPS = 4, 16, 8, 3     # batch, train/forward tokens, prompt
REL = 1e-4                          # the model tests' bound


def _cfg(cfgs, name):
    cfg = dataclasses.replace(cfgs.ARCHS[name].reduced(),
                              compute_dtype="float32")
    if cfg.family == "moe" or "moe" in cfg.layer_pattern:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0,
                                  moe_dispatch="shardmap")
    return cfg


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _inputs(path):
    """The JAX weights (bf16 leaves carried as fp32 beside their dtype),
    the tokens, and the JAX package's forward and decode logits."""
    arrays, dtypes, want = {}, {}, {}
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, 256, (B, S)).astype(np.int32)
    arrays["tokens"] = tokens
    for name in ARCHS:
        cfg = _cfg(jconfigs, name)
        model = jbuild(cfg)
        params = model.init_params(jax.random.PRNGKey(0))
        for key, leaf in _flat(jax.tree.map(np.asarray, params)).items():
            dtypes[f"{name}/{key}"] = str(leaf.dtype)
            arrays[f"p/{name}/{key}"] = leaf.astype(np.float32)
        logits, _ = jax.jit(lambda p, t: model.forward(
            p, {"tokens": t}, remat=False))(params, jnp.asarray(tokens))
        want[f"{name}/forward"] = np.asarray(logits)
        prefill = jax.jit(jprefill_step(model, PRE + STEPS, JServeConfig()))
        step = jax.jit(jserve_step(model, JServeConfig()))
        tok, cache = prefill(params, {"tokens": jnp.asarray(tokens[:, :PRE])})
        for i in range(STEPS):
            tok, logits, cache = step(params, cache, tok, jnp.int32(PRE + i))
            want[f"{name}/decode{i}"] = np.asarray(logits)
    np.savez(path, **arrays)
    return dtypes, want


PORT_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch import configs
    from repro_torch.dist import collectives, compat
    from repro_torch.dist import sharding as shd
    from repro_torch.models import build_model, module
    from repro_torch.optim.adamw import AdamW
    from repro_torch.serve.decode import make_prefill_step, make_serve_step
    from repro_torch.train.step import TrainStepConfig, make_train_step

    ARCHS, MESHES, (B, S, PRE, STEPS) = %r, %r, %r
    inputs = dict(np.load(sys.argv[1]))
    dtypes = json.load(open(sys.argv[2]))
    rank, world = int(sys.argv[5]), int(sys.argv[6])
    compat.init_process_group("cpu", init_method=sys.argv[7], rank=rank,
                              world_size=world, timeout_s=float(sys.argv[8]))
    tokens = torch.from_numpy(inputs["tokens"])
    out, report = {}, {"equal": {}, "ranks": {}, "bytes": {}}

    def cfg_of(name):
        cfg = dataclasses.replace(configs.ARCHS[name].reduced(),
                                  compute_dtype="float32")
        if cfg.family == "moe" or "moe" in cfg.layer_pattern:
            cfg = dataclasses.replace(cfg, capacity_factor=8.0,
                                      moe_dispatch="shardmap")
        return cfg

    def weights(name):
        tree = {}
        prefix = f"p/{name}/"
        for key, v in inputs.items():
            if not key.startswith(prefix):
                continue
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            dt = getattr(torch, dtypes[key[2:]])
            node[leaf] = torch.from_numpy(v).to(dt, copy=True)
        return tree

    def leaves_of(tree):
        if isinstance(tree, (list, tuple)):
            return [x for t in tree for x in leaves_of(t)]
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves_of(tree[k])]
        return [tree]

    def same(label, got, want):
        # bit for bit, blocked against the global view, and on every rank
        got, want = leaves_of(got), leaves_of(want)
        bits = lambda ts: [collectives.fingerprint(t.detach()) for t in ts]
        report["equal"][label] = (len(got) == len(want) and all(
            g.shape == w.shape and g.dtype == w.dtype
            for g, w in zip(got, want)) and bits(got) == bits(want))
        prints = collectives.all_ranks(bits(got))
        report["ranks"][label] = all(p == prints[0] for p in prints)

    def forward(model, params, mesh, rules):
        # under a split vocabulary each rank returns its block of the
        # logits: gathered whole here
        with torch.no_grad(), shd.use_mesh(mesh, rules):
            logits = model.forward(params, {"tokens": tokens}, remat=False)[0]
            axes = model.vocab_axes(*tokens.shape)
        return collectives._gather_whole(logits, mesh, (None, None, axes))

    def serve(model, params, mesh, rules, blocked):
        batch = {"tokens": tokens[:, :PRE]}
        if blocked:
            batch = shd.shard_tree(batch, shd.held_batch_shardings(
                batch, mesh, rules), mesh)
        with torch.no_grad(), shd.use_mesh(mesh, rules):
            tok, cache = make_prefill_step(model, PRE + STEPS)(params, batch)
            toks, logits = [tok], []
            for i in range(STEPS):
                t = toks[-1]
                if blocked:
                    t = shd.shard_tree(t, shd.held_batch_shardings(
                        {"tokens": t}, mesh, rules)["tokens"], mesh)
                tok, lg, cache = make_serve_step(model)(params, cache, t,
                                                        PRE + i)
                toks.append(tok)
                logits.append(lg)
        return toks, logits, shd.gather_tree(cache)

    def train(model, params, mesh, rules, blocked):
        opt = AdamW(learning_rate=1e-3)
        batch = {"tokens": tokens, "labels": tokens}
        if blocked:
            specs = shd.tree_shardings(model.param_specs(), mesh, rules)
            params = shd.shard_tree(params, specs, mesh)
            batch = shd.shard_tree(batch, shd.held_batch_shardings(
                batch, mesh, rules), mesh)
        state = opt.init(params)
        step = make_train_step(model, opt, TrainStepConfig(ce_seq_chunk=8))
        with shd.use_mesh(mesh, rules):
            params, state, metrics = step(params, state, batch)
        return metrics, shd.gather_tree((params, state.mu, state.nu))

    for mname, (shape, names) in MESHES[world].items():
        mesh = compat.make_mesh(tuple(shape), tuple(names))
        for name in ARCHS:
            model = build_model(cfg_of(name))
            key = f"{mname}/{name}"
            whole = weights(name)
            specs = shd.tree_shardings(model.param_specs(), mesh,
                                       shd.train_rules())
            held = shd.shard_tree(whole, specs, mesh)
            sizes = dict(zip(names, shape))
            want_bytes = 0
            for leaf, sh in zip(leaves_of(whole), module.leaves(specs)):
                ways = 1
                for entry in sh.spec:
                    for n in collectives.names_of(entry):
                        ways *= sizes[n]
                want_bytes += leaf.numel() * leaf.element_size() // ways
            report["bytes"][key] = [
                sum(shd.local(l).numel() * shd.local(l).element_size()
                    for l in leaves_of(held)), want_bytes,
                sum(isinstance(l, shd.Block) for l in leaves_of(held))]

            rules = shd.train_rules()
            got = forward(model, held, mesh, rules)
            same(f"{key}/forward", got, forward(model, whole, mesh, rules))
            out[f"{key}/forward"] = got.numpy()

            rules = shd.serve_rules()
            held_s = shd.shard_tree(whole, shd.tree_shardings(
                model.param_specs(), mesh, rules), mesh)
            toks, logits, cache = serve(model, held_s, mesh, rules, True)
            wtoks, wlogits, wcache = serve(model, whole, mesh, rules, False)
            same(f"{key}/serve_tokens", toks, wtoks)
            same(f"{key}/serve_logits", logits, wlogits)
            same(f"{key}/serve_cache", cache, wcache)
            for i, lg in enumerate(logits):
                out[f"{key}/decode{i}"] = lg.numpy()

            train_rules = [("train", shd.train_rules())]
            if "data" in names and "model" in names:
                train_rules.append(("fsdp", shd.train_rules(fsdp=True)))
            for rname, rules in train_rules:
                m, state = train(model, weights(name), mesh, rules, True)
                wm, wstate = train(model, weights(name), mesh, rules, False)
                same(f"{key}/{rname}/metrics",
                     [m[k] for k in sorted(m)], [wm[k] for k in sorted(wm)])
                same(f"{key}/{rname}/state", state, wstate)
                out[f"{key}/{rname}/loss"] = m["loss"].numpy()
    if rank == 0:
        np.savez(sys.argv[3], **out)
        with open(sys.argv[4], "w") as fh:
            json.dump(report, fh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("PORT_OK")
""") % (ARCHS, MESHES, (B, S, PRE, STEPS))


def _wait_all(procs, deadline):
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.wait(), p.stdout.read(), p.stderr.read()) for p in procs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds, started together once the JAX references are made:
    {world: (arrays, report)} and the JAX logits."""
    tmp = tmp_path_factory.mktemp("blocked")
    inputs = tmp / "inputs.npz"
    dtypes, want = _inputs(inputs)
    (tmp / "dtypes.json").write_text(json.dumps(dtypes))
    procs = {}
    for world in MESHES:
        procs[world] = [subprocess.Popen(
            [sys.executable, "-c", PORT_SCRIPT, str(inputs),
             str(tmp / "dtypes.json"), str(tmp / f"port{world}.npz"),
             str(tmp / f"port{world}.json"), str(r), str(world),
             f"file://{tmp / f'rendezvous{world}'}", str(GROUP_TIMEOUT_S)],
            env=ENV, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
    deadline = time.monotonic() + DEADLINE_S
    out = {}
    for world, ps in procs.items():
        for r, (rc, _, err) in enumerate(_wait_all(ps, deadline)):
            assert rc == 0, f"world {world} rank {r} exited {rc}: " \
                            f"{err[-3000:]}"
        out[world] = (dict(np.load(tmp / f"port{world}.npz")),
                      json.loads((tmp / f"port{world}.json").read_text()))
    return out, want


CASES = [(w, m, a) for w in MESHES for m in MESHES[w] for a in ARCHS]
IDS = [f"{w}-{m}-{a}" for w, m, a in CASES]


@pytest.mark.parametrize("what", ["forward", "serve_tokens", "serve_logits",
                                  "serve_cache"])
@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_blocked_equals_global_view(runs, world, mesh, arch, what):
    _, report = runs[0][world]
    label = f"{mesh}/{arch}/{what}"
    assert report["equal"][label], label
    assert report["ranks"][label], label


@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_blocked_train_step_equals_global_view(runs, world, mesh, arch):
    """Metrics, and the params and both moments gathered whole after the
    step, bit for bit (also under fsdp where the mesh has both axes)."""
    _, report = runs[0][world]
    labels = [k for k in report["equal"]
              if k.startswith(f"{mesh}/{arch}/") and "/serve" not in k
              and not k.endswith("/forward")]
    assert len(labels) == (4 if mesh == "2x2" else 2)
    for label in labels:
        assert report["equal"][label] and report["ranks"][label], label


@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_blocked_param_bytes(runs, world, mesh, arch):
    """A rank holds exactly the blocks: the sum of its leaves' bytes is
    each whole leaf's bytes over the ways its spec splits it, and some
    leaves are blocks on a mesh with a model axis."""
    _, report = runs[0][world]
    held, want, blocks = report["bytes"][f"{mesh}/{arch}"]
    assert held == want
    assert (blocks > 0) == ("model" in mesh or mesh == "2x2")


@pytest.mark.parametrize("what", ["forward"] + [f"decode{i}"
                                                for i in range(STEPS)])
@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_blocked_logits_match_jax(runs, world, mesh, arch, what):
    got = runs[0][world][0][f"{mesh}/{arch}/{what}"]
    want = runs[1][f"{arch}/{what}"]
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= REL, err


@pytest.mark.parametrize("multi_pod,bound", [(False, 10), (True, 6)])
def test_dryrun_blocked_decode_under_budget(multi_pod, bound):
    """gemma3-1b decode_32k at full width on a fake group: the blocked
    per-rank peak under the bound (107.11 GiB with every leaf whole)."""
    from repro_torch.launch import dryrun

    cell = dryrun.run_cell("gemma3-1b", "decode_32k", multi_pod=multi_pod,
                           verbose=False)
    mem = cell["memory_per_device_bytes"]
    assert cell["layout"] == "blocked"
    assert mem["total_bytes"] < bound * 2**30
    assert mem["argument_bytes"] == mem["sharded_argument_bytes"]
