"""Multi-pod dry-run of every (arch x shape x mesh) cell: the port of the
JAX package's ``launch/dryrun.py``.

The reference lowers and compiles each cell's jitted step against 512
forced host devices, from ``ShapeDtypeStruct`` stand-ins, and reads XLA's
cost and memory analyses.  The port has no compiler; its counterpart runs
the cell's real step function once, allocating nothing:

  * a **fake process group** (backend ``"fake"``) of 256 or 512 ranks in
    this one process (:func:`fake_group`), with the production mesh over
    it (``launch.mesh``); its collectives move nothing;
  * params, AdamW state, batch and caches as ``FakeTensorMode`` tensors on
    the CPU device, built from the spec trees (shape and dtype, no data);
  * the cell's step — ``make_train_step``, ``make_prefill_step`` or
    ``make_serve_step`` — under the active mesh and rules;
  * one dispatch-mode **op counter** (:class:`OpCounter`) around it, which
    fills ``hlo_analysis.CostTotals`` (FLOPs from
    ``torch.utils.flop_counter``'s formulas, bytes as each aten op's
    inputs plus outputs with views free, collective bytes by kind from the
    ``c10d`` ops) and tracks the bytes of live fake storages for the
    per-rank peak.

Nothing is launched and nothing is allocated on either device.  Because
the fake tensors live on the CPU, the attention layers take the plain
``attend_chunked`` — the program the reference lowers, whose model never
reaches its Pallas kernel either.

**Memory as the port holds it.**  The cell's arguments are the blocked
layout's (``dist.sharding``, ``layout: "blocked"`` in the result): each
param and AdamW moment is this rank's block under its ``tree_shardings``
spec, the cache this rank's rows and, where the rules split them, its
KV heads, SSM channels and mLSTM heads (``cache_shardings``), and the
batch this rank's rows.  Where the rules split the heads, the MLP (the
MoE's shared expert too), hymba's SSM channels, the xLSTM cores' channels
and heads or the vocabulary over ``model``, those layers compute on this
rank's block of weights and activations, as the reference's SPMD program
does; every other layer gathers its params where it uses them and
computes whole.  The layers' sequential loops keep only their carries for
the backward (``models.layers.scan_step``, the reference's
``jax.checkpoint``), so the recompute of a checkpointed period holds one
step's intermediates at a time.
``memory_per_device_bytes["total_bytes"]`` is the peak of one rank's live
storages over the step, arguments included.  Beside it,
``sharded_argument_bytes`` is the reference's sharded argument figure:
each argument leaf's bytes divided by the sizes of the mesh axes its
``tree_shardings``/``batch_shardings`` spec uses.

There is no compile: ``lower_s`` holds the seconds of the fake trace
(``build_cell`` included) and ``compile_s`` is 0.0.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape, shape_applicable
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import names_of
from repro_torch.launch import hlo_analysis, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model, module
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.serve.decode import ServeConfig, make_prefill_step, make_serve_step
from repro_torch.train.step import TrainStepConfig, make_train_step

aten = torch.ops.aten

# --------------------------------------------------------------------------
# the op counter
# --------------------------------------------------------------------------

_DOT_OPS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}

# c10d op -> collective kind; a c10d op missing here raises
_COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

# metadata queries FlopCounterMode leaves to the next mode (by name: the
# set differs between torch versions)
_META_OPS = {getattr(getattr(aten, name, None), overload, None)
             for name, overload in (
                 ("sym_is_contiguous", "default"), ("is_contiguous", "default"),
                 ("is_contiguous", "memory_format"),
                 ("is_strides_like_format", "default"),
                 ("is_non_overlapping_and_dense", "default"),
                 ("size", "default"), ("sym_size", "default"),
                 ("stride", "default"), ("sym_stride", "default"),
                 ("storage_offset", "default"),
                 ("sym_storage_offset", "default"), ("numel", "default"),
                 ("sym_numel", "default"), ("dim", "default"))}
_META_OPS = (_META_OPS - {None}) | {torch.ops.prim.layout.default}


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shape_str(out) -> str:
    """'bf16[16,4096,1152]'-style name of an op's first tensor output."""
    ts = _tensors(out)
    if not ts:
        return "()"
    t = ts[0]
    name = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16:
            "f16", torch.int32: "s32", torch.int64: "s64", torch.bool:
            "pred", torch.int8: "s8", torch.uint8: "u8"}.get(t.dtype,
                                                             str(t.dtype))
    return f"{name}[{','.join(str(d) for d in t.shape)}]"


class OpCounter(TorchDispatchMode):
    """Per-device cost of the ops run under it, into ``totals`` (a
    ``hlo_analysis.CostTotals``; its docstring says how each field is
    filled), with per-op records for ``launch.profile`` and the bytes of
    live tensor storages.

    FLOPs follow ``FlopCounterMode``'s dispatch exactly (an op is first
    offered its decomposition, and one with a formula is counted by it),
    so the two give the same count on the same ops.  Storages count from
    the :meth:`track` of the step's arguments on: each new one adds its
    bytes to the live total when an op first returns it and drops them
    when it is freed; ``peak_bytes`` is the highest live total seen."""

    def __init__(self):
        super().__init__()
        self.totals = hlo_analysis.CostTotals()
        self.traffic = collections.Counter()     # (op, shape) -> bytes
        self.flops = collections.Counter()       # (op, shape) -> FLOPs
        self.colls = collections.Counter()       # (op, shape) -> bytes
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = WeakIdKeyDictionary()
        self._sent = 0           # payload of the last send, paired with recv_

    # -- storages ------------------------------------------------------------
    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def track(self, tensors) -> None:
        """Count the storages of ``tensors`` as live until they are freed."""
        for t in _tensors(tensors):
            st = t.untyped_storage()
            if st in self._live:
                continue
            n = st.nbytes()
            self._live[st] = n
            weakref.finalize(st, self._release, n)
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def memory(self, args, out) -> dict:
        """The reference's memory keys for one step over ``args`` that
        returned ``out``: ``total_bytes`` is the peak (arguments + outputs
        + temp - alias, with temp the rest of the peak)."""
        arg = {id(t.untyped_storage()): t.untyped_storage().nbytes()
               for t in _tensors(args)}
        outs = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in _tensors(out)}
        a, o = sum(arg.values()), sum(outs.values())
        alias = sum(n for k, n in outs.items() if k in arg)
        return {"argument_bytes": a, "output_bytes": o,
                "temp_bytes": self.peak_bytes - a - o + alias,
                "alias_bytes": alias, "total_bytes": self.peak_bytes}

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_OPS:
            return NotImplemented
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.ops += 1
        self.track(out)
        packet = func._overloadpacket
        key = (packet._qualified_op_name.replace("::", "."), _shape_str(out))
        if func.namespace == "c10d":
            self._collective(func, key, args, kwargs, out)
            return out
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.totals.flops += f
            self.flops[key] += f
            if packet in _DOT_OPS:
                self.totals.dot_flops += f
        results = _tensors(out)
        if results and not func.is_view:     # metadata queries move nothing
            b = (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                 + sum(_nbytes(t) for t in results))
            self.totals.hbm_bytes += b
            self.traffic[key] += b
        return out

    def _collective(self, func, key, args, kwargs, out) -> None:
        name = func._overloadpacket._qualified_op_name.split("::")[1]
        kind = _COLLECTIVE_KINDS.get(name)
        if kind is None:
            raise NotImplementedError(
                f"the dry-run's op counter has no rule for c10d.{name}")
        opd = sum(_nbytes(t) for t in _tensors((args, kwargs)))
        res = sum(_nbytes(t) for t in _tensors(out))
        payload = max(opd, res)
        if name == "send":
            self._sent = payload
        elif name == "recv_" and self._sent == payload:
            payload, self._sent = 0, 0   # one hop: its send carried it
        self.totals.collective_bytes[kind] += payload
        self.totals.hbm_bytes += opd + res
        self.colls[key] += payload


# --------------------------------------------------------------------------
# fake group, fake tensors, the trace
# --------------------------------------------------------------------------

@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks (this process is rank 0)
    for the enclosed block, destroyed at its end.  An existing fake group
    of at least ``world`` ranks is used as it is; any other existing
    default group raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < world:
            raise RuntimeError(
                f"the dry-run needs a fake process group of {world} ranks; "
                f"the default group is {dist.get_backend()} with "
                f"{dist.get_world_size()}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _map(fn, tree):
    """``fn`` over the leaves of an argument tree (torch's pytree: dicts,
    tuples, lists, NamedTuples such as ``AdamWState``, and a Block's
    block)."""
    return pytree.tree_map(fn, tree)


def _fake(leaf):
    """A fake CPU tensor of ``leaf``'s shape, strides and dtype (meta, real
    or spec); other leaves pass through.  Call inside ``FakeTensorMode``."""
    if isinstance(leaf, module.ParamSpec):
        leaf = leaf.meta()
    if not isinstance(leaf, torch.Tensor):
        return leaf
    return torch.empty_strided(tuple(leaf.shape), tuple(leaf.stride()),
                               dtype=leaf.dtype, device="cpu")


def trace(fn, args) -> tuple:
    """Run ``fn(*args)`` once on fake CPU tensors standing in for ``args``
    (meta tensors, real tensors on any device, or ParamSpecs), under an
    :class:`OpCounter`.  Returns (the counter, its memory dict, the
    seconds).  Nothing is allocated on any device."""
    counter = OpCounter()
    t0 = time.perf_counter()
    with FakeTensorMode():
        fake = _map(_fake, args)
        counter.track(fake)
        with counter:
            out = fn(*fake)
        mem = counter.memory(fake, out)
    return counter, mem, time.perf_counter() - t0


def _pairs(args, shardings):
    """(leaf, its Sharding) over an argument tree and its shardings."""
    if isinstance(args, dict):
        for k in args:
            yield from _pairs(args[k], shardings[k])
    elif isinstance(args, (tuple, list)):
        for a, s in zip(args, shardings):
            yield from _pairs(a, s)
    elif isinstance(args, (torch.Tensor, shd.Block)):
        yield args, shardings


def sharded_argument_bytes(args, in_sh, mesh) -> int:
    """The reference's per-device argument bytes: each leaf's bytes (a
    Block's whole leaf's) over the product of the sizes of the mesh axes
    its spec uses."""
    sizes = shd._axis_sizes(mesh)
    total = 0
    for t, sh in _pairs(args, in_sh):
        ways = 1
        for entry in sh.spec:
            for name in names_of(entry):
                ways *= sizes[name]
        n = t.local.element_size() * math.prod(t.whole_shape()) \
            if isinstance(t, shd.Block) else _nbytes(t)
        total += n // ways
    return total


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

def _opt_state_specs(param_specs):
    """Meta tensors for the AdamW state mirroring the param tree."""
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=module.shape_tree(param_specs),
                      nu=module.shape_tree(param_specs))


def _replicated(mesh):
    return shd.Sharding((), tuple(Replicate() for _ in shd._axis_sizes(mesh)))


VARIANTS = ("localattn", "moelocal", "moeshard", "sp", "bigtile", "rematdots", "bf16norm", "fulldp", "ring")


def build_cell(arch_name: str, shape_name: str, mesh, *,
               step_cfg: TrainStepConfig | None = None,
               variant: str = ""):
    """Returns (fn, arg_shapes, in_shardings, out_shardings, donate, model,
    shape): ``arg_shapes`` are this rank's blocks as meta tensors (no
    allocation; ``dist.sharding.Block`` where a spec splits a leaf, the
    batch split over its batch dimension, the cache over its batch and
    KV heads: ``cache_shardings``), the
    shardings the reference's ``dist.sharding.Sharding`` trees, ``donate``
    the arguments the step writes in place.

    ``variant`` is a '+'-separated list of §Perf optimisation names:
      localattn — banded sliding-window attention (O(S*2w))
      moelocal  — per-data-shard MoE dispatch capacity
      sp        — sequence-parallel activations over the model axis
      bigtile   — 2048-wide KV chunks (fewer accumulator sweeps)
    """
    arch = get_arch(arch_name)
    shape = get_shape(shape_name)
    vset = set(v for v in variant.split("+") if v)
    unknown = vset - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {unknown}")
    step_cfg = step_cfg or TrainStepConfig()
    if "localattn" in vset:
        step_cfg = dataclasses.replace(step_cfg, local_block=True)
    if "bigtile" in vset:
        step_cfg = dataclasses.replace(step_cfg, k_chunk=2048)
    if "rematdots" in vset:
        step_cfg = dataclasses.replace(step_cfg, remat_policy="dots")
    if "ring" in vset:
        step_cfg = dataclasses.replace(step_cfg, ring=True)
    if "moelocal" in vset:
        arch = dataclasses.replace(arch, moe_dispatch="local")
    if "moeshard" in vset:
        arch = dataclasses.replace(arch, moe_dispatch="shardmap")
    if "bf16norm" in vset:
        arch = dataclasses.replace(arch, norm_impl="bf16_apply")
    seq_parallel = "sp" in vset
    full_dp = "fulldp" in vset
    model = build_model(arch)

    if shape.is_decode:
        rules = shd.serve_rules(long_context=(shape.kind == "long_decode"))
        if arch.family == "ssm":
            rules = shd.ShardingRules({**rules.rules, "head_dim": "model"})
        # serving weights are bf16 (decode reads every weight once per token)
        if arch.param_dtype == "float32":
            arch = dataclasses.replace(arch, param_dtype="bfloat16")
            model = build_model(arch)
        param_specs = model.param_specs()
        cache_specs = model.cache_specs(shape.global_batch, shape.seq_len)
        p_shard = shd.tree_shardings(param_specs, mesh, rules)
        c_shard = shd.tree_shardings(cache_specs, mesh, rules)
        tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                             device="meta")
        tok_shard = shd.batch_shardings({"tokens": tokens}, mesh,
                                        rules)["tokens"]
        serve_step = make_serve_step(model, ServeConfig())

        def fn(params, cache, tokens, cache_index):
            with shd.use_mesh(mesh, rules):
                return serve_step(params, cache, tokens, cache_index)

        # the reference's index is a traced scalar; the port's decode step
        # reads a Python int, and its cost does not depend on the value
        args = (module.shape_tree(param_specs), module.shape_tree(cache_specs),
                tokens, shape.seq_len - 1)
        in_sh = (p_shard, c_shard, tok_shard, _replicated(mesh))
        args = shd.shard_tree(args, (p_shard, shd.cache_shardings(
            cache_specs, mesh, rules), tok_shard, None), mesh)
        out_sh = (tok_shard, _replicated(mesh), c_shard)
        donate = (1,)
        return fn, args, in_sh, out_sh, donate, model, shape

    if shape.kind == "prefill":
        # inference prefill: forward + KV-cache fill + first sample
        rules = shd.serve_rules(long_context=False)
        if arch.param_dtype == "float32":
            arch = dataclasses.replace(arch, param_dtype="bfloat16")
            model = build_model(arch)
        param_specs = model.param_specs()
        cache_specs = model.cache_specs(shape.global_batch, shape.seq_len)
        p_shard = shd.tree_shardings(param_specs, mesh, rules)
        c_shard = shd.tree_shardings(cache_specs, mesh, rules)
        batch_specs = model.input_specs(shape)
        batch_specs.pop("labels", None)
        b_shard = shd.batch_shardings(batch_specs, mesh, rules)
        prefill_step = make_prefill_step(model, shape.seq_len,
                                         ServeConfig(k_chunk=step_cfg.k_chunk))

        def fn(params, batch):
            with shd.use_mesh(mesh, rules):
                return prefill_step(params, batch)

        tok_shard = b_shard["tokens"]
        args = (module.shape_tree(param_specs), batch_specs)
        in_sh = (p_shard, b_shard)
        args = shd.shard_tree(args, (p_shard, shd.held_batch_shardings(
            batch_specs, mesh, rules)), mesh)
        out_sh = (tok_shard, c_shard)
        donate = ()
        return fn, args, in_sh, out_sh, donate, model, shape

    # training cells run the full train step
    rules = shd.train_rules(fsdp=True, seq_parallel=seq_parallel)
    if full_dp:
        # attention-free / small-head archs: the TP axis is idle for the
        # recurrent core — use it for 256-way data parallelism instead
        rules = shd.ShardingRules({**rules.rules,
                                   "batch": ("pod", "data", "model"),
                                   "mlp": None, "heads": None,
                                   "vocab": "model",
                                   "embed": ("data", "model")})
    param_specs = model.param_specs()
    p_shard = shd.tree_shardings(param_specs, mesh, rules)
    opt_specs = _opt_state_specs(param_specs)
    o_shard = AdamWState(step=_replicated(mesh),
                         mu=shd.tree_shardings(param_specs, mesh, rules),
                         nu=shd.tree_shardings(param_specs, mesh, rules))
    batch_specs = model.input_specs(shape)
    b_shard = shd.batch_shardings(batch_specs, mesh, rules)
    optimizer = AdamW(learning_rate=1e-4)
    train_step = make_train_step(model, optimizer, step_cfg)

    def fn(params, opt_state, batch):
        with shd.use_mesh(mesh, rules):
            return train_step(params, opt_state, batch)

    args = (module.shape_tree(param_specs), opt_specs, batch_specs)
    in_sh = (p_shard, o_shard, b_shard)
    args = shd.shard_tree(args, (p_shard, o_shard, shd.held_batch_shardings(
        batch_specs, mesh, rules)), mesh)
    out_sh = (p_shard, o_shard, None)
    donate = (0, 1)
    return fn, args, in_sh, out_sh, donate, model, shape


def mesh_name_of(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
             step_cfg: TrainStepConfig | None = None,
             variant: str = "", verbose: bool = True,
             counter_out: list | None = None) -> dict:
    """One cell on a fake group of the mesh's size (module docstring).
    ``counter_out``, when given, receives the cell's :class:`OpCounter`
    (``launch.profile`` reads its records)."""
    mesh_name = mesh_name_of(multi_pod)
    label = (f"{arch_name}|{shape_name}|{mesh_name}"
             + (f"|{variant}" if variant else ""))
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = mesh.size()
        t0 = time.perf_counter()
        fn, args, in_sh, out_sh, donate, model, shape = build_cell(
            arch_name, shape_name, mesh, step_cfg=step_cfg, variant=variant)
        try:
            counter, mem, _ = trace(fn, args)
        except Exception as e:
            raise RuntimeError(f"dry-run {label}: the step failed on the "
                               f"fake group: {type(e).__name__}: {e}") from e
        t_lower = time.perf_counter() - t0
        mem["sharded_argument_bytes"] = sharded_argument_bytes(args, in_sh,
                                                               mesh)
    totals = counter.totals
    mf = roofline.model_flops(model, shape)
    cost = {"flops": totals.flops, "bytes accessed": totals.hbm_bytes}
    report = roofline.analyze(arch_name, shape_name, mesh_name, chips,
                              cost, totals, mf, memory_stats=mem)
    result = report.to_dict()
    result.update(lower_s=t_lower, compile_s=0.0, ok=True, variant=variant,
                  ops=counter.ops, layout="blocked")
    if counter_out is not None:
        counter_out.append(counter)
    if verbose:
        print(f"[dryrun] {arch_name} x {shape_name} x {mesh_name}"
              f"{' [' + variant + ']' if variant else ''}: "
              f"trace {t_lower:.1f}s ({counter.ops} ops) | per-dev flops "
              f"{report.per_device_flops:.3e} "
              f"| mem/dev {mem['total_bytes']/1e9:.2f} GB blocked "
              f"(sharded args {mem['sharded_argument_bytes']/1e9:.2f} GB) "
              f"| bottleneck {report.bottleneck} "
              f"(c={report.compute_s*1e3:.2f}ms m={report.memory_s*1e3:.2f}ms "
              f"coll={report.collective_s*1e3:.2f}ms)")
    return result


def cells(include_skips: bool = False):
    for arch_name, arch in ARCHS.items():
        for shape_name, shape in SHAPES.items():
            runs, reason = shape_applicable(arch, shape)
            if runs or include_skips:
                yield arch_name, shape_name, runs, reason


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/torch/dryrun.json")
    ap.add_argument("--variant", default="",
                    help="'+'-separated perf variants: " + ", ".join(VARIANTS))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    if args.all:
        todo = [(a, s) for a, s, runs, _ in cells() if runs]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        todo = [(args.arch, args.shape)]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    failures = []
    # record skips
    for a, s, runs, reason in cells(include_skips=True):
        if not runs:
            for mp in meshes:
                key = f"{a}|{s}|{mesh_name_of(mp)}"
                results.setdefault(key, {"ok": True, "skipped": True,
                                         "reason": reason})
    for arch_name, shape_name in todo:
        for mp in meshes:
            key = f"{arch_name}|{shape_name}|{mesh_name_of(mp)}"
            if args.variant:
                key += f"|{args.variant}"
            if key in results and results[key].get("ok") and not args.force:
                continue
            try:
                results[key] = run_cell(arch_name, shape_name, multi_pod=mp,
                                        variant=args.variant)
            except Exception as e:
                traceback.print_exc()
                results[key] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                failures.append(key)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    print(f"[dryrun] wrote {args.out}; "
          f"{sum(1 for r in results.values() if r.get('ok'))} ok, "
          f"{len(failures)} failed this run")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
