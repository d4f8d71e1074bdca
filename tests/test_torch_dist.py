"""The port's dist layer on a 4-rank gloo group against the JAX package on a
forced 4-device host platform, on the same seeded numpy inputs.

Two subprocess runs start together from one module fixture:

  * the JAX package, with ``XLA_FLAGS=--xla_force_host_platform_device_count
    =4`` set before ``import jax`` (as ``tests/test_ring_attention.py``
    does): ring attention (output and q-gradient), the decode ring, the
    shard_map MoE (output, aux, expert gradients) and the tree/batch
    sharding specs;
  * the port, four ranks of ``python -c PORT_SCRIPT`` joined by a
    ``file://`` rendezvous under the test's temporary directory (no TCP
    port to collide between test workers), one intra-op thread each and a
    group timeout; the same cases, plus a training step with ``ring=True``
    under a 4-rank model mesh against the one-process step.

A rank that fails or hangs fails the fixture: every rank is killed at the
first nonzero exit or at the deadline.  The MoE weights are the JAX
package's (``models.module.from_numpy`` on the port's side).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist.ring_attention import _causal_skip_possible as jskip
from repro.models import module as jmodule
from repro.models import moe as jmoe
from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.dist import compat
from repro_torch.dist.ring_attention import _causal_skip_possible
from repro_torch.dist import sharding as shd
from repro_torch.models import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
       "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
       "PYTHONUNBUFFERED": "1"}
DEADLINE_S = 240            # both subprocess runs, from their start
GROUP_TIMEOUT_S = 120       # a collective no peer answers fails the rank

# (causal, window) x seq (30 % 4 != 0: the padded ring), then q_offset=5
RING_CASES = [(c, w, s, 0) for c, w in ((True, 0), (False, 0), (True, 8))
              for s in (32, 30)] + [(True, 0, 32, 5)]
DECODE_CASES = [(i, w, st) for i in (3, 7, 12, 31) for w in (0, 8)
                for st in (None, (0, 5))]
MOE_ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]
SPEC_ARCHS = ["gemma3-1b", "yi-9b", "qwen3-moe-235b-a22b"]
SPEC_RULES = ["train", "train-fsdp-sp", "serve-long"]
SPEC_MESHES = {"1x1": ((1, 1), ("data", "model")),
               "2x2": ((2, 2), ("data", "model")), "4": ((4,), ("model",))}
SPEC_BATCH, SPEC_SEQ, SPEC_CACHE = 8, 64, 64


def _ring_key(c, w, s, off):
    return f"ring_c{int(c)}_w{w}_s{s}_o{off}"


def _decode_key(i, w, st):
    return f"decode_i{i}_w{w}_s{'none' if st is None else 'set'}"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _moe_cfg(cfgs, name):
    return dataclasses.replace(cfgs.ARCHS[name].reduced(),
                               compute_dtype="float32", capacity_factor=8.0,
                               moe_dispatch="shardmap")


def _inputs(path):
    """The seeded numpy inputs both runs read, and the JAX MoE weights."""
    rng = np.random.RandomState(0)
    arrays = {}
    for c, w, s, off in RING_CASES:
        key = _ring_key(c, w, s, off)
        for name, scale in (("q", 0.4), ("k", 0.4), ("v", 1.0)):
            arrays[f"{key}/{name}"] = (rng.randn(2, s, 3, 16) * scale
                                       ).astype(np.float32)
    b, h, kv, d, smax = 2, 4, 2, 16, 32
    arrays["decode/q"] = (rng.randn(b, 1, h, d) * 0.4).astype(np.float32)
    arrays["decode/k"] = (rng.randn(b, smax, kv, d) * 0.4).astype(np.float32)
    arrays["decode/v"] = rng.randn(b, smax, kv, d).astype(np.float32)
    for name in MOE_ARCHS:
        cfg = _moe_cfg(jconfigs, name)
        params = jmodule.init(jax.random.PRNGKey(0), jmoe.moe_spec(cfg))
        for k, v in _flat(jax.tree.map(np.asarray, params)).items():
            arrays[f"moe/{name}/p/{k}"] = v
        arrays[f"moe/{name}/x"] = (np.random.RandomState(0).randn(
            4, 8, cfg.d_model) * 0.3).astype(np.float32)
    np.savez(path, **arrays)


COMMON = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    RING_CASES = %r
    DECODE_CASES = %r
    MOE_ARCHS = %r
    SPEC_ARCHS = %r
    SPEC_RULES = %r
    SPEC_MESHES = %r
    SPEC_BATCH, SPEC_SEQ, SPEC_CACHE = %r

    def ring_key(c, w, s, off):
        return f"ring_c{int(c)}_w{w}_s{s}_o{off}"

    def decode_key(i, w, st):
        return f"decode_i{i}_w{w}_s{'none' if st is None else 'set'}"

    def unflat(arrays, prefix):
        tree = {}
        for key, v in arrays.items():
            if not key.startswith(prefix):
                continue
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        return tree

    def entry(e):
        return e if e is None or isinstance(e, str) else list(e)

    def flat_specs(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k in sorted(tree):
                out.update(flat_specs(tree[k], f"{prefix}{k}/"))
            return out
        return {prefix[:-1]: [entry(e) for e in tree]}

    inputs = dict(np.load(sys.argv[1]))
""") % (RING_CASES, DECODE_CASES, MOE_ARCHS, SPEC_ARCHS, SPEC_RULES,
        SPEC_MESHES, (SPEC_BATCH, SPEC_SEQ, SPEC_CACHE))

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
""") + COMMON + textwrap.dedent("""
    from repro import configs
    from repro.configs.base import ShapeConfig
    from repro.dist import sharding as shd
    from repro.dist.compat import make_mesh
    from repro.dist.ring_attention import ring_attention, ring_decode
    from repro.models import build_model
    from repro.models.moe import moe_apply

    out = {}
    mesh = make_mesh((4,), ("model",))
    for c, w, s, off in RING_CASES:
        key = ring_key(c, w, s, off)
        q, k, v = (jnp.asarray(inputs[f"{key}/{n}"]) for n in "qkv")
        f = lambda q: ring_attention(q, k, v, mesh=mesh, causal=c, window=w,
                                     q_offset=off)
        out[f"{key}/out"] = np.asarray(jax.jit(f)(q))
        out[f"{key}/dq"] = np.asarray(jax.jit(jax.grad(
            lambda q: jnp.sum(f(q) ** 2)))(q))
    q, k, v = (jnp.asarray(inputs[f"decode/{n}"]) for n in "qkv")
    for i, w, st in DECODE_CASES:
        start = None if st is None else jnp.asarray(st, jnp.int32)
        out[decode_key(i, w, st)] = np.asarray(jax.jit(
            lambda q, k, v, i, start: ring_decode(
                q, k, v, i, mesh=mesh, window=w, start=start))(
            q, k, v, jnp.int32(i), start))

    mesh22 = make_mesh((2, 2), ("data", "model"))
    for name in MOE_ARCHS:
        cfg = dataclasses.replace(
            configs.ARCHS[name].reduced(), compute_dtype="float32",
            capacity_factor=8.0, moe_dispatch="shardmap")
        params = jax.tree.map(jnp.asarray, unflat(inputs, f"moe/{name}/p/"))
        x = jnp.asarray(inputs[f"moe/{name}/x"])

        def f(params):
            with shd.use_mesh(mesh22, shd.train_rules()):
                return moe_apply(cfg, params, x)

        y, aux = jax.jit(f)(params)
        grads = jax.jit(jax.grad(lambda p: jnp.sum(f(p)[0] ** 2)))(params)
        out[f"moe/{name}/y"] = np.asarray(y)
        out[f"moe/{name}/aux"] = np.asarray(aux)
        for key in ("w_gate", "w_up", "w_down"):
            out[f"moe/{name}/d{key}"] = np.asarray(grads[key])
    np.savez(sys.argv[2], **out)

    rules = {"train": shd.train_rules(),
             "train-fsdp-sp": shd.train_rules(fsdp=True, seq_parallel=True),
             "serve-long": shd.serve_rules(long_context=True)}
    specs = {}
    for mname, (shape, names) in SPEC_MESHES.items():
        m = make_mesh(shape, names, devices=jax.devices()[:int(np.prod(
            shape))])
        for rname, r in rules.items():
            for arch in SPEC_ARCHS:
                model = build_model(configs.ARCHS[arch].reduced())
                tree = {"params": model.param_specs(),
                        "cache": model.cache_specs(SPEC_BATCH, SPEC_CACHE)}
                got = jax.tree.map(lambda s: tuple(s.spec),
                                   shd.tree_shardings(tree, m, r))
                batch = dict(model.input_specs(ShapeConfig(
                    "t", SPEC_SEQ, SPEC_BATCH, "train")))
                batch["frames"] = jax.ShapeDtypeStruct(
                    (SPEC_BATCH, 4, 64), jnp.float32)
                got["batch"] = {k: tuple(v.spec) for k, v in
                                shd.batch_shardings(batch, m, r).items()}
                specs[f"{mname}|{rname}|{arch}"] = flat_specs(got)
    with open(sys.argv[3], "w") as fh:
        json.dump(specs, fh)
    print("JAX_OK")
""")

PORT_SCRIPT = textwrap.dedent("""
    import torch
    torch.set_num_threads(1)
""") + COMMON + textwrap.dedent("""
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.dist import collectives, compat
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.ring_attention import ring_attention, ring_decode
    from repro_torch.models import build_model, module
    from repro_torch.models.moe import moe_apply
    from repro_torch.train.step import (TrainStepConfig, _value_and_grad,
                                        make_loss_fn)

    rank, world = int(sys.argv[4]), int(sys.argv[5])
    compat.init_process_group("cpu", init_method=sys.argv[6], rank=rank,
                              world_size=world,
                              timeout_s=float(sys.argv[7]))
    out, equal = {}, {}

    def keep(key, t):
        t = t.detach()
        prints = collectives.all_ranks(collectives.fingerprint(t))
        equal[key] = len(set(prints)) == 1
        out[key] = t.numpy()

    mesh = compat.make_mesh((4,), ("model",))
    for c, w, s, off in RING_CASES:
        key = ring_key(c, w, s, off)
        q, k, v = (torch.from_numpy(inputs[f"{key}/{n}"]) for n in "qkv")
        q.requires_grad_()
        o = ring_attention(q, k, v, mesh=mesh, causal=c, window=w,
                           q_offset=off)
        (o ** 2).sum().backward()
        keep(f"{key}/out", o)
        keep(f"{key}/dq", q.grad)
    q, k, v = (torch.from_numpy(inputs[f"decode/{n}"]) for n in "qkv")
    for i, w, st in DECODE_CASES:
        start = None if st is None else torch.tensor(st, dtype=torch.int32)
        keep(decode_key(i, w, st), ring_decode(q, k, v, i, mesh=mesh,
                                               window=w, start=start))

    mesh22 = compat.make_mesh((2, 2), ("data", "model"))
    for name in MOE_ARCHS:
        cfg = dataclasses.replace(
            configs.ARCHS[name].reduced(), compute_dtype="float32",
            capacity_factor=8.0, moe_dispatch="shardmap")
        params = module.from_numpy(unflat(inputs, f"moe/{name}/p/"),
                                   device="cpu")
        for key in ("w_gate", "w_up", "w_down"):
            params[key].requires_grad_()
        x = torch.from_numpy(inputs[f"moe/{name}/x"])
        with shd.use_mesh(mesh22, shd.train_rules()):
            y, aux = moe_apply(cfg, params, x)
        (y ** 2).sum().backward()
        keep(f"moe/{name}/y", y)
        keep(f"moe/{name}/aux", aux)
        for key in ("w_gate", "w_up", "w_down"):
            keep(f"moe/{name}/d{key}", params[key].grad)

    # a training step's loss and gradients with ring=True under the 4-rank
    # model mesh, and the same without a mesh (the dense path)
    cfg = dataclasses.replace(configs.ARCHS["gemma3-1b"].reduced(),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    batch = batch_at(DataConfig(cfg.vocab_size, 32, 2), 0, device="cpu")
    grad_fn = _value_and_grad(make_loss_fn(model, TrainStepConfig(ring=True)))
    with shd.use_mesh(mesh, shd.train_rules(seq_parallel=True)):
        (loss, _), grads = grad_fn(params, batch)
    (want, _), want_grads = grad_fn(params, batch)
    keep("train/loss", loss)
    out["train/want_loss"] = want.numpy()

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from walk(tree[k], f"{prefix}{k}/")
        else:
            yield prefix[:-1], tree
    for (path, g), (_, wg) in zip(walk(grads), walk(want_grads)):
        keep(f"train/grad/{path}", g)
        out[f"train/want_grad/{path}"] = wg.numpy()

    specs = {}
    rules = {"train": shd.train_rules(),
             "train-fsdp-sp": shd.train_rules(fsdp=True, seq_parallel=True),
             "serve-long": shd.serve_rules(long_context=True)}
    for mname, m in (("2x2", mesh22), ("4", mesh)):
        for rname, r in rules.items():
            for arch in SPEC_ARCHS:
                model = build_model(configs.ARCHS[arch].reduced())
                tree = {"params": model.param_specs(),
                        "cache": model.cache_specs(SPEC_BATCH, SPEC_CACHE)}
                got = module.tree_map(lambda s: s.spec,
                                      shd.tree_shardings(tree, m, r))
                batch = dict(model.input_specs(ShapeConfig(
                    "t", SPEC_SEQ, SPEC_BATCH, "train")))
                batch["frames"] = torch.empty((SPEC_BATCH, 4, 64),
                                              device="meta")
                got["batch"] = {k: v.spec for k, v in
                                shd.batch_shardings(batch, m, r).items()}
                specs[f"{mname}|{rname}|{arch}"] = flat_specs(got)
    if rank == 0:
        np.savez(sys.argv[2], **out)
        with open(sys.argv[3], "w") as fh:
            json.dump({"specs": specs, "equal": equal,
                       "transport": mesh.transport.describe()}, fh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("PORT_OK")
""")


def _wait_all(procs, deadline):
    """Wait for every process; kill them all at the first failure or at
    the deadline.  Returns each one's (returncode, stdout, stderr)."""
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
    """Both subprocess runs, started together: (jax arrays, jax specs,
    port arrays, port report)."""
    tmp = tmp_path_factory.mktemp("dist")
    inputs = tmp / "inputs.npz"
    _inputs(inputs)

    def popen(script, *args):
        return subprocess.Popen([sys.executable, "-c", script, str(inputs),
                                 *map(str, args)], env=ENV, cwd=tmp,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    deadline = time.monotonic() + DEADLINE_S
    jax_proc = popen(JAX_SCRIPT, tmp / "jax.npz", tmp / "jax.json")
    port = [popen(PORT_SCRIPT, tmp / "port.npz", tmp / "port.json", r, 4,
                  f"file://{tmp / 'rendezvous'}", GROUP_TIMEOUT_S)
            for r in range(4)]
    port_res = _wait_all(port, deadline)
    jax_res = _wait_all([jax_proc], deadline)
    for name, res in [("jax", jax_res[0])] + [
            (f"port rank {r}", x) for r, x in enumerate(port_res)]:
        assert res[0] == 0, f"{name} exited {res[0]}: {res[2][-3000:]}"
    return (dict(np.load(tmp / "jax.npz")),
            json.loads((tmp / "jax.json").read_text()),
            dict(np.load(tmp / "port.npz")),
            json.loads((tmp / "port.json").read_text()))


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("case", RING_CASES,
                         ids=[_ring_key(*c) for c in RING_CASES])
def test_ring_attention_matches_jax(runs, case):
    jx, _, port, report = runs
    key = _ring_key(*case)
    _close(port[f"{key}/out"], jx[f"{key}/out"], 2e-5)
    _close(port[f"{key}/dq"], jx[f"{key}/dq"], 5e-5)
    assert report["equal"][f"{key}/out"] and report["equal"][f"{key}/dq"]


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[_decode_key(*c) for c in DECODE_CASES])
def test_ring_decode_matches_jax(runs, case):
    jx, _, port, report = runs
    key = _decode_key(*case)
    _close(port[key], jx[key], 2e-5)
    assert report["equal"][key]


@pytest.mark.parametrize("what", ["y", "aux", "dw_gate", "dw_up", "dw_down"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_shardmap_moe_matches_jax(runs, name, what):
    jx, _, port, report = runs
    key = f"moe/{name}/{what}"
    _close(port[key], jx[key], 1e-5)
    assert report["equal"][key]


def test_ring_train_step_matches_one_process(runs):
    """Loss and every gradient leaf of a step with ring=True under the
    4-rank model mesh, against the one-process dense step."""
    _, _, port, report = runs
    want = float(port["train/want_loss"])
    assert abs(float(port["train/loss"]) - want) <= 1e-4 * abs(want)
    grads = [k for k in port if k.startswith("train/grad/")]
    assert len(grads) > 10
    for key in grads:
        w = port[key.replace("train/grad/", "train/want_grad/")]
        _close(port[key], w, 1e-4 * max(1.0, float(np.abs(w).max())))
        assert report["equal"][key], key
    assert report["transport"] == "gloo (host-staged, cpu)"


@pytest.mark.parametrize("arch", SPEC_ARCHS)
@pytest.mark.parametrize("rules", SPEC_RULES)
@pytest.mark.parametrize("mesh", sorted(SPEC_MESHES))
def test_tree_and_batch_shardings_match_jax(runs, mesh, rules, arch):
    _, jspecs, _, report = runs
    key = f"{mesh}|{rules}|{arch}"
    if mesh == "1x1":
        got = _specs_on_a_world_of_one(rules, arch)
    else:
        got = report["specs"][key]
    assert got == jspecs[key]


def _specs_on_a_world_of_one(rules, arch):
    """The (1, 1) mesh's specs from a DeviceMesh over a gloo world of one
    in this process."""
    r = {"train": shd.train_rules(),
         "train-fsdp-sp": shd.train_rules(fsdp=True, seq_parallel=True),
         "serve-long": shd.serve_rules(long_context=True)}[rules]
    model = build_model(ARCHS[arch].reduced())
    with compat.process_group("cpu"):
        mesh = compat.make_mesh((1, 1), ("data", "model"))
        tree = {"params": model.param_specs(),
                "cache": model.cache_specs(SPEC_BATCH, SPEC_CACHE)}
        got = shd.tree_shardings(tree, mesh, r)
        batch = dict(model.input_specs(ShapeConfig("t", SPEC_SEQ,
                                                   SPEC_BATCH, "train")))
        batch["frames"] = torch.empty((SPEC_BATCH, 4, 64), device="meta")
        got["batch"] = shd.batch_shardings(batch, mesh, r)
    out = {}
    for path, sh in _walk(got):
        out[path] = [e if e is None or isinstance(e, str) else list(e)
                     for e in sh.spec]
    return out


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def test_placements_follow_the_spec():
    """A leaf's DTensor placements: Shard(i) on each mesh axis that tensor
    dim i uses, Replicate() on the others, in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = ARCHS["qwen3-moe-235b-a22b"].reduced()
    model = build_model(cfg)
    with compat.process_group("cpu"):
        mesh = compat.make_mesh((1, 1), ("data", "model"))
        specs = model.param_specs()
        got = shd.tree_shardings(specs, mesh, shd.train_rules(fsdp=True))
    for path, sh in _walk(got):
        for name, placement in zip(("data", "model"), sh.placements):
            dims = [i for i, e in enumerate(sh.spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            assert placement == (Shard(dims[0]) if dims else Replicate()), \
                (path, sh)


@pytest.mark.parametrize("n", [2, 4])
def test_causal_skip_predicate_matches_jax(n):
    for s_loc in (1, 4, 8):
        for q_offset in (0, 3, s_loc, 3 * s_loc):
            for step in range(n):
                assert _causal_skip_possible(step, n, s_loc, q_offset) \
                    == jskip(step, n, s_loc, q_offset)
