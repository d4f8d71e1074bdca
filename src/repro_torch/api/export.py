"""Program JSON round-trip + schedule Gantt CSV — the portability story.

A workload is authored (or traced) once, exported as data, and re-compiled
under a different hardware fingerprint: the JSON carries only shapes,
dtypes, kernel names, derived params, and value flow — never weights or
arrays.  ``SCHEMA_VERSION`` gates decoding; ``program_from_json`` rebuilds
the typed IR, re-runs structural validation, and (given a registry)
re-derives params/avals through the abstract hooks so a hand-edited file
cannot smuggle in a stale feature layout.
"""
from __future__ import annotations

import json

from repro_torch.api.program import InputSpec, Node, Program

SCHEMA_VERSION = 1


def program_to_json(program: Program) -> dict:
    return {
        "schema": SCHEMA_VERSION,
        "inputs": [{"name": s.name, "shape": list(s.shape),
                    "dtype": s.dtype} for s in program.inputs],
        "nodes": [{"name": n.name, "kernel": n.kernel,
                   "deps": list(n.deps), "params": dict(n.params),
                   "kwargs": dict(n.kwargs),
                   "out_shape": list(n.out_shape),
                   "out_dtype": n.out_dtype} for n in program.nodes],
        "outputs": list(program.outputs),
    }


def program_from_json(doc: dict, registry=None) -> Program:
    if doc.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"unknown program schema {doc.get('schema')!r} "
                         f"(this build reads {SCHEMA_VERSION})")
    inputs = tuple(InputSpec(s["name"], tuple(s["shape"]), s["dtype"])
                   for s in doc["inputs"])
    nodes = tuple(Node(name=n["name"], kernel=n["kernel"],
                       deps=tuple(n["deps"]), params=dict(n["params"]),
                       kwargs=dict(n["kwargs"]),
                       out_shape=tuple(n["out_shape"]),
                       out_dtype=n["out_dtype"]) for n in doc["nodes"])
    program = Program(inputs, nodes, tuple(doc["outputs"]))
    if registry is not None:
        program.check(registry)
    return program


def save_program(program: Program, path: str) -> None:
    with open(path, "w") as f:
        json.dump(program_to_json(program), f, indent=1)


def load_program(path: str, registry=None) -> Program:
    with open(path) as f:
        return program_from_json(json.load(f), registry=registry)


# -- schedule Gantt export ----------------------------------------------------

def gantt_csv(compiled) -> str:
    """CSV of a ``CompiledProgram``'s predicted schedule (one row per node,
    sorted by start time) — the artifact CI uploads next to the tunecache."""
    lines = ["task,kernel,device,start_s,finish_s"]
    for r in compiled.gantt():
        lines.append(f"{r['task']},{r['kernel']},{r['device']},"
                     f"{r['start_s']:.9f},{r['finish_s']:.9f}")
    return "\n".join(lines) + "\n"


def save_gantt_csv(compiled, path: str) -> None:
    with open(path, "w") as f:
        f.write(gantt_csv(compiled))
