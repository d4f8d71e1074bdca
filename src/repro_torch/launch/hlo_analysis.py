"""Trip-count-aware analytic cost model over post-SPMD optimized HLO: the
port's copy of the JAX package's ``launch/hlo_analysis.py``, for the HLO
text that package dumps (the port imports nothing of it).

``compiled.cost_analysis()`` counts a while-loop body ONCE regardless of its
trip count (an 8-step scanned matmul reports 1/8 the flops of its unrolled
twin).  The reference's models are scans end-to-end (layer stacks, flash
attention tiles, chunked CE), so this module re-derives the three roofline
inputs by walking the optimized HLO with loop multipliers:

  * flops       — exact for dot/convolution (2 * result * contraction),
                  approximate for fused elementwise (1 flop/elem/arith-op);
  * hbm bytes   — post-fusion traffic model: per top-level op, sum of
                  operand + result buffer bytes (fusions count their
                  boundary, not their interior);
  * collective  — per-kind payload bytes (max of operand/result, a ring
                  within-2x bound on per-device link traffic).

Loop trip counts come from XLA's ``known_trip_count`` backend config.

The port's own programs are eager torch, with no HLO: ``launch.dryrun``'s
op counter runs a cell's step under a dispatch mode and fills the same
:class:`CostTotals` (its docstring says how).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "token": 0, "opaque": 0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")

_INSTR_RE = re.compile(
    r"^(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*"
    r"((?:\((?:[^()]|\([^()]*\))*\))|(?:\w+\[[\d,]*\](?:{[^}]*})?)|(?:\w+\[\]))\s+"
    r"([\w\-]+)\((.*)$")

_OPERAND_RE = re.compile(r"%([\w.\-]+)")

_ARITH_OPS = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "power",
    "exponential", "log", "tanh", "sqrt", "rsqrt", "negate", "abs", "sine",
    "cosine", "select", "clamp", "compare", "and", "or", "xor", "not",
    "exponential-minus-one", "log-plus-one", "logistic", "floor", "ceil",
    "round-nearest-afz", "sign", "atan2", "cbrt", "erf",
}

_SKIP_OPS = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "after-all", "partition-id", "replica-id", "rng-get-and-update-state",
    "domain", "opt-barrier",
}

_COLLECTIVES = {
    "all-reduce": "all-reduce", "all-reduce-start": "all-reduce",
    "all-gather": "all-gather", "all-gather-start": "all-gather",
    "reduce-scatter": "reduce-scatter",
    "all-to-all": "all-to-all",
    "collective-permute": "collective-permute",
    "collective-permute-start": "collective-permute",
}


def shape_elems_bytes(shape_str: str) -> tuple[int, int]:
    elems_total = 0
    bytes_total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        elems_total += n
        bytes_total += n * _DTYPE_BYTES[dtype]
    return elems_total, bytes_total


@dataclasses.dataclass
class Instr:
    name: str
    shape: str
    op: str
    operands: list[str]
    rest: str
    trip_count: int = 1
    called: tuple[str, ...] = ()
    dims: Optional[dict] = None


_ARTIFACT_OPS = {"convert", "copy", "bitcast", "reshape", "transpose"}
_ARTIFACT_FUSION_OPS = _ARTIFACT_OPS | {"parameter", "constant", "tuple",
                                        "get-tuple-element", "bitcast-convert"}


@dataclasses.dataclass
class Computation:
    name: str
    instrs: list[Instr]
    symbols: dict[str, str]           # var name -> result shape string
    artifacts: dict[str, str] = dataclasses.field(default_factory=dict)
    # artifacts[name] -> source operand name for pure layout/dtype ops:
    # XLA fuses these into their consumers (layout converts fold into the
    # surrounding kernels), so they carry no HBM traffic of their own and
    # consumers charge the *source* bytes.

    def resolve(self, name: str) -> str:
        seen = set()
        while name in self.artifacts and name not in seen:
            seen.add(name)
            name = self.artifacts[name]
        return name


def parse_module(hlo_text: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for raw in hlo_text.splitlines():
        line = raw.strip()
        if not line or line.startswith("//") or line.startswith("HloModule"):
            continue
        if line.endswith("{") and ("(" in line) and ("=" not in line.split("(")[0]):
            header = line[:-1].strip()
            if header.startswith("ENTRY"):
                header = header[len("ENTRY"):].strip()
            name = header.split("(")[0].strip().lstrip("%").strip()
            cur = Computation(name=name, instrs=[], symbols={})
            comps[name] = cur
            if line.startswith("ENTRY") or raw.startswith("ENTRY"):
                comps["__entry__"] = cur
            continue
        if line == "}":
            cur = None
            continue
        if cur is None or "=" not in line:
            continue
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, shape, op, tail = m.groups()
        # split operand list from trailing attributes at the closing paren
        depth = 1
        idx = 0
        for idx, ch in enumerate(tail):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    break
        operand_str, rest = tail[:idx], tail[idx + 1:]
        operands = _OPERAND_RE.findall(operand_str)
        instr = Instr(name=name, shape=shape, op=op, operands=operands,
                      rest=rest)
        tm = re.search(r'known_trip_count\\?":\s*{\\?"n\\?":\\?"(\d+)', rest)
        if tm:
            instr.trip_count = int(tm.group(1))
        called = []
        for key in ("body", "condition", "calls", "to_apply"):
            cm = re.search(rf"{key}=%?([\w.\-]+)", rest)
            if cm:
                called.append(cm.group(1))
        # branch computations for conditionals
        bm = re.search(r"branch_computations={([^}]*)}", rest)
        if bm:
            called.extend(x.strip().lstrip("%")
                          for x in bm.group(1).split(",") if x.strip())
        instr.called = tuple(called)
        if op == "dot":
            dm = re.search(r"lhs_contracting_dims={([\d,]*)}", rest)
            instr.dims = {"lhs_contracting":
                          [int(x) for x in dm.group(1).split(",") if x]
                          if dm else []}
        cur.instrs.append(instr)
        cur.symbols[name] = shape
    # second pass: mark pure layout/dtype artifacts (incl. artifact-only fusions)
    for comp in comps.values():
        for instr in comp.instrs:
            if instr.op in _ARTIFACT_OPS and len(instr.operands) == 1:
                comp.artifacts[instr.name] = instr.operands[0]
            elif instr.op == "fusion" and instr.called:
                called = comps.get(instr.called[0])
                if called is not None and all(
                        i2.op in _ARTIFACT_FUSION_OPS for i2 in called.instrs):
                    if instr.operands:
                        # data operand = the largest one
                        best = max(instr.operands, key=lambda o: shape_elems_bytes(
                            comp.symbols.get(o, ""))[1])
                        comp.artifacts[instr.name] = best
    return comps


@dataclasses.dataclass
class CostTotals:
    """Per-device totals of one program.

    :func:`analyze_hlo` fills every field from HLO text.  The port's op
    counter (``launch.dryrun.OpCounter``, a ``TorchDispatchMode`` over the
    eager step on fake tensors) fills the same fields so:

      * ``flops`` — ``torch.utils.flop_counter``'s formulas, op by op, the
        count ``FlopCounterMode`` gives (products, convolutions, attention;
        elementwise ops count none, where the HLO walk counts one a
        element);
      * ``dot_flops`` — the matmul family's share of ``flops`` (``mm``,
        ``bmm``, ``addmm``, ``baddbmm``);
      * ``hbm_bytes`` — each aten op's tensor inputs plus outputs, views
        free (eager torch writes every op's result to device memory; there
        is no fusion);
      * ``collective_bytes`` — the payload of each ``c10d`` op by kind
        (``allreduce_`` → all-reduce, ``allgather*`` → all-gather,
        ``reduce_scatter*`` → reduce-scatter, ``alltoall*`` → all-to-all,
        ``send``/``recv_`` of one hop → collective-permute, counted once);
      * ``loops`` — empty: eager code runs every iteration, so there is no
        trip count to recover.
    """

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in
                                 ("all-reduce", "all-gather", "reduce-scatter",
                                  "all-to-all", "collective-permute")})
    dot_flops: float = 0.0
    loops: list = dataclasses.field(default_factory=list)

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())


def _operand_bytes(comp: Computation, instr: Instr) -> int:
    total = 0
    for op_name in instr.operands:
        shp = comp.symbols.get(comp.resolve(op_name))
        if shp:
            total += shape_elems_bytes(shp)[1]
    return total


def _dot_flops(comp: Computation, instr: Instr) -> float:
    res_elems, _ = shape_elems_bytes(instr.shape)
    contract = 1
    if instr.operands:
        lhs_shape = comp.symbols.get(instr.operands[0], "")
        m = _SHAPE_RE.search(lhs_shape)
        if m:
            dims = [int(x) for x in m.group(2).split(",") if x]
            for ci in (instr.dims or {}).get("lhs_contracting", []):
                if ci < len(dims):
                    contract *= dims[ci]
    return 2.0 * res_elems * contract


def _chase(comp: Computation, name: str) -> Optional[Instr]:
    """Follow artifact chains to the defining non-artifact instruction."""
    hops = 0
    instr = next((i for i in comp.instrs if i.name == name), None)
    while (instr is not None and instr.op in _ARTIFACT_OPS
           and len(instr.operands) == 1 and hops < 16):
        instr = next((i for i in comp.instrs if i.name == instr.operands[0]),
                     None)
        hops += 1
    return instr


def _fusion_traffic(comps, comp: Computation, instr: Instr) -> int:
    """HBM traffic of a fusion via interior dataflow.

    Within a fused computation: a parameter consumed only through
    dynamic-slice reads its slices, a parameter that is the in-place target
    of a dynamic-update-slice is free (aliased write), everything else is a
    full read; the write side is the update slice for DUS roots (incl.
    multi-output tuples) or the result bytes otherwise: a scanned layer
    stack slices weights/caches per iteration out of one resident
    buffer."""
    fc = comps.get(instr.called[0]) if instr.called else None
    if fc is None:
        return (shape_elems_bytes(instr.shape)[1]
                + _operand_bytes(comp, instr))
    tags: dict[str, set] = {}
    slice_read = 0
    for i2 in fc.instrs:
        if i2.op in _ARTIFACT_OPS:
            continue
        if i2.op == "dynamic-slice" and i2.operands:
            slice_read += shape_elems_bytes(i2.shape)[1]
            src = _chase(fc, i2.operands[0])
            if src is not None and src.op == "parameter":
                tags.setdefault(src.name, set()).add("slice")
            continue
        for pos, opnd in enumerate(i2.operands):
            src = _chase(fc, opnd)
            if src is None or src.op != "parameter":
                continue
            if i2.op == "dynamic-update-slice" and pos == 0:
                tags.setdefault(src.name, set()).add("target")
            else:
                tags.setdefault(src.name, set()).add("full")
    # write side: chase root through artifacts; tuple of DUSes supported
    root = _chase(fc, fc.instrs[-1].name) or fc.instrs[-1]
    write = 0
    roots = [root]
    if root.op == "tuple":
        roots = [(_chase(fc, o) or None) for o in root.operands]
    all_dus = all(r is not None and r.op == "dynamic-update-slice"
                  for r in roots) and roots
    if all_dus:
        for r in roots:
            upd = fc.symbols.get(fc.resolve(r.operands[1]))
            write += 2 * shape_elems_bytes(upd)[1] if upd else 0
    else:
        write = shape_elems_bytes(instr.shape)[1]
    # read side: full-tagged parameters only
    reads = slice_read
    for pname, t in tags.items():
        if "full" in t:
            shp = fc.symbols.get(pname, "")
            b = shape_elems_bytes(shp)[1]
            if b > 256:                        # ignore scalars/indices
                reads += b
    return reads + write


def _fusion_flops(comps, fused_comp_name: str) -> float:
    """Approximate flops inside a fusion: arith ops x elems (+ exact dots)."""
    comp = comps.get(fused_comp_name)
    if comp is None:
        return 0.0
    flops = 0.0
    for instr in comp.instrs:
        if instr.op == "dot":
            flops += _dot_flops(comp, instr)
        elif instr.op in _ARITH_OPS or instr.op == "reduce":
            flops += shape_elems_bytes(instr.shape)[0]
        elif instr.op == "fusion" and instr.called:
            flops += _fusion_flops(comps, instr.called[0])
    return flops


def _walk(comps, comp_name: str, mult: float, totals: CostTotals,
          seen_path: tuple = ()):
    comp = comps.get(comp_name)
    if comp is None or comp_name in seen_path:
        return
    for instr in comp.instrs:
        op = instr.op
        if op in _SKIP_OPS:
            continue
        if op == "while":
            trip = instr.trip_count
            totals.loops.append((comp_name, instr.name, trip, mult))
            for sub in instr.called:
                _walk(comps, sub, mult * trip, totals,
                      seen_path + (comp_name,))
            continue
        if op in ("call", "conditional", "async-start"):
            for sub in instr.called:
                _walk(comps, sub, mult, totals, seen_path + (comp_name,))
            continue
        if op in _COLLECTIVES:
            kind = _COLLECTIVES[op]
            res = shape_elems_bytes(instr.shape)[1]
            opd = _operand_bytes(comp, instr)
            payload = max(res, opd)
            totals.collective_bytes[kind] += payload * mult
            totals.hbm_bytes += (res + opd) * mult
            continue
        if op.endswith("-done"):
            continue
        if instr.name in comp.artifacts:
            continue        # pure layout/dtype op: fuses into its consumer
        # memory traffic: operands + result (in-place DUS counts its slice)
        res_elems, res_bytes = shape_elems_bytes(instr.shape)
        if op == "dynamic-update-slice" and len(instr.operands) >= 2:
            upd = comp.symbols.get(comp.resolve(instr.operands[1]))
            traffic = 2 * shape_elems_bytes(upd)[1] if upd else res_bytes
        elif op == "dynamic-slice" and instr.operands:
            traffic = 2 * res_bytes                    # read + write the slice
        elif op == "fusion" and instr.called:
            traffic = _fusion_traffic(comps, comp, instr)
        else:
            traffic = res_bytes + _operand_bytes(comp, instr)
        totals.hbm_bytes += traffic * mult
        if op == "dot":
            f = _dot_flops(comp, instr)
            totals.flops += f * mult
            totals.dot_flops += f * mult
        elif op == "convolution":
            # rare here (frontends are stubs); bound via result elems
            totals.flops += 2.0 * res_elems * mult
        elif op == "fusion" and instr.called:
            totals.flops += _fusion_flops(comps, instr.called[0]) * mult
        elif op in _ARITH_OPS or op == "reduce":
            totals.flops += res_elems * mult


def analyze_hlo(hlo_text: str) -> CostTotals:
    comps = parse_module(hlo_text)
    totals = CostTotals()
    entry = comps.get("__entry__")
    if entry is None:
        raise ValueError("no ENTRY computation found in HLO text")
    _walk(comps, entry.name, 1.0, totals)
    return totals
