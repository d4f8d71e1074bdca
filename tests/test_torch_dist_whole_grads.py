"""The weights' gradients of layers that stay whole on every rank, computed
on each rank's block of d and all-gathered (``collectives.whole_product``),
on a gloo world of 4 against the port's no-mesh path and the JAX package.

The harness is ``tests/test_torch_dist_tp.py``'s (``port_script`` with a
mesh of its own, ``_inputs``): yi-9b at ``reduced()`` with 6 heads (its 6
heads and 2 KV heads do not divide 4 ranks, so attention stays whole) and
a vocabulary of 258 (which does not divide 4 either, so the unembedding
stays whole), on a ``("model",)`` mesh of 4, fp32 params and compute and
the JAX package's weights of the same variant.  Every rank runs the
forward, the gradients of ``make_train_step``'s loss, one AdamW step,
``make_prefill_step`` and three ``make_serve_step``s, each on whole
leaves and on blocks.  Beside them the step's gradients with the products
that take the op counted, and with a rank's block of each such gradient
left out of its all-gather (planted): it must land above the bound.

Bounds: logits within 1e-4 of the JAX package's largest logit; the loss
within 1e-5 of the no-mesh step's and every gradient leaf within 1e-5 of
its largest magnitude.
"""
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from test_torch_dist_blocked import ENV, _wait_all
from test_torch_dist_tp import GRAD_REL, REL, STEPS, _inputs, port_script

DEADLINE_S = 300
GROUP_TIMEOUT_S = 120
ARCH = "yi-9b+n_heads=6+vocab_size=258"
WORLD = 4
MESH = "model4"
MESHES = {WORLD: {MESH: ((WORLD,), ("model",))}}
D, Q, KV, VOCAB = 64, 6 * 16, 2 * 16, 258

EXTRA = """
from repro_torch.models import attention as at

name = ARCHS[0]
cfg = cfg_of(name)
model = build_model(cfg)
mesh = compat.make_mesh((WORLD,), ("model",))
rules = shd.train_rules()
with shd.use_mesh(mesh, rules):
    report["axes"] = [[list(a) for a in at.head_axes(cfg, B, S)],
                      list(model.vocab_axes(B, S))]
real = collectives.whole_product
seen = []


def counted(x, w, m, names, dim):
    seen.append([list(w.shape), dim, list(names)])
    return real(x, w, m, names, dim)


class DropBlock(torch.autograd.Function):
    # the identity, whose backward zeroes the last rank's block of the
    # gradient along ``dim``: that block left out of the all-gather
    @staticmethod
    def forward(ctx, w, dim):
        ctx.dim = dim
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        n = g.shape[ctx.dim] // WORLD
        g.narrow(ctx.dim, g.shape[ctx.dim] - n, n).zero_()
        return g, None


def planted(x, w, m, names, dim):
    return real(x, DropBlock.apply(w, dim), m, names, dim)


loss0, g0 = grads(model, weights(name), None, None)
got = {}
for label, op in (("counted", counted), ("planted", planted)):
    collectives.whole_product = op
    try:
        got[label] = grads(model, weights(name), mesh, rules)
    finally:
        collectives.whole_product = real
report["whole"] = {
    "calls": sorted({json.dumps(c) for c in seen}),
    "loss": rel(got["counted"][0], loss0), "grads": rel(got["counted"][1], g0),
    "planted": rel(got["planted"][1], g0)}
on_ranks("whole", list(got["counted"]))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's (arrays, report) and the JAX logits and tokens."""
    tmp = tmp_path_factory.mktemp("whole_grads")
    inputs = tmp / "inputs.npz"
    dtypes, want = _inputs(inputs, [ARCH])
    (tmp / "dtypes.json").write_text(json.dumps(dtypes))
    extra = f"WORLD, MESH = {WORLD!r}, {MESH!r}\n" + EXTRA
    script = port_script([ARCH], extra, meshes=MESHES)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(inputs), str(tmp / "dtypes.json"),
         str(tmp / "port.npz"), str(tmp / "port.json"), str(r), str(WORLD),
         f"file://{tmp / 'rendezvous'}", str(GROUP_TIMEOUT_S)],
        env=ENV, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    deadline = time.monotonic() + DEADLINE_S
    for r, (rc, _, err) in enumerate(_wait_all(procs, deadline)):
        assert rc == 0, f"rank {r} exited {rc}: {err[-3000:]}"
    return (dict(np.load(tmp / "port.npz")),
            json.loads((tmp / "port.json").read_text()), want)


def test_whole_layers_stay_whole(runs):
    """Neither the heads nor the vocabulary split over "model"."""
    assert runs[1]["axes"] == [[[], []], []], runs[1]["axes"]


def test_whole_layers_take_the_blocked_gradient(runs):
    """wq, wk, wv (d their first dimension), wo (d its second) and the
    unembedding table's transpose [d, V] run through the op, over
    "model"."""
    calls = {tuple(tuple(x) if isinstance(x, list) else x
                   for x in json.loads(c)) for c in runs[1]["whole"]["calls"]}
    want = {((D, Q), 0, ("model",)), ((D, KV), 0, ("model",)),
            ((Q, D), 1, ("model",)), ((D, VOCAB), 0, ("model",))}
    assert calls == want, calls


def test_whole_grads_match_no_mesh(runs):
    """The loss and every gradient leaf against the no-mesh step, on every
    rank; the harness's train step too."""
    rep = runs[1]
    assert rep["whole"]["loss"] <= GRAD_REL, rep["whole"]
    assert rep["whole"]["grads"] <= GRAD_REL, rep["whole"]
    assert rep["ranks"]["whole"]
    label = f"{MESH}/{ARCH}/train"
    assert rep["err"][f"{label}/loss"] <= GRAD_REL, rep["err"]
    assert rep["err"][f"{label}/grads"] <= GRAD_REL, rep["err"]
    assert rep["ranks"][f"{label}/grads"]


def test_whole_grads_block_left_out_fails(runs):
    """A rank's block of each gradient left out of the all-gather lands
    above the bound."""
    assert runs[1]["whole"]["planted"] > GRAD_REL, runs[1]["whole"]


@pytest.mark.parametrize("what", ["forward"] + [f"decode{i}"
                                                for i in range(STEPS)])
def test_whole_logits_match_jax(runs, what):
    got = runs[0][f"{MESH}/{ARCH}/{what}"]
    want = runs[2][f"{ARCH}/{what}"]
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= REL, err


@pytest.mark.parametrize("what", ["forward", "grads", "step", "serve_tokens",
                                  "serve_logits", "serve_cache", "outside"])
def test_whole_blocked_equals_whole(runs, what):
    """Blocks against whole leaves bit for bit, on every rank; and the
    backward run after the mesh frame has closed against the one inside
    it."""
    rep = runs[1]
    labels = [k for k in rep["equal"] if k.startswith(f"{MESH}/{ARCH}/")
              and k.endswith(f"/{what}")]
    assert labels
    for label in labels:
        assert rep["equal"][label] and rep["ranks"][label], label
