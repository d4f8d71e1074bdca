"""The mLSTM core on each rank's block of C's value rows, where the heads
do not divide the mesh's ``model`` axis, on a gloo world of 4 against the
port's no-mesh path and the JAX package.

The harness is ``tests/test_torch_dist_tp.py``'s (``port_script`` with a
mesh of its own, ``_inputs``): xlstm-1.3b at ``reduced()`` with
``n_heads=2`` (its 2 heads do not divide 4 ranks; each head's 64 value
rows split 16 a rank, the mLSTM's 128 channels 32 a rank) on a
``("model",)`` mesh of 4, fp32 params and compute and the JAX package's
weights of the same variant; its forward and ``repro.serve.decode``
steps give the reference logits and tokens.  Every rank runs the forward,
the gradients of ``make_train_step``'s loss, one AdamW step,
``make_prefill_step`` and three ``make_serve_step``s, each on whole leaves
and on blocks, and the backward after the mesh frame has closed.
Beside them, the gate and ``w_down``'s rows cut contiguously (``take``
where ``take_parts`` with H parts cuts each head's value rows) and the
intra-chunk ``q.k`` left as each rank's block of the (batch, head)
pairs, the others' at zero (its gather dropped), are planted, each on
its own: each must leave the logits above the bound.

Bounds: logits within 1e-4 of the JAX package's largest logit; the loss
within 1e-5 of the no-mesh step's and every gradient leaf within 2e-5 of
its largest magnitude (xlstm's bound, ``test_torch_dist_tp_recurrent``).
"""
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from test_torch_dist_blocked import ENV, _wait_all
from test_torch_dist_tp import GRAD_REL, REL, STEPS, _inputs, port_script
from test_torch_dist_tp_recurrent import GRAD_BOUND

DEADLINE_S = 300
GROUP_TIMEOUT_S = 120
ARCH = "xlstm-1.3b+n_heads=2"
WORLD = 4
MESH = "model4"
MESHES = {WORLD: {MESH: ((WORLD,), ("model",))}}
GRAD_TOL = GRAD_BOUND["xlstm-1.3b"]

EXTRA = """
from repro_torch.models import xlstm as xl

name = ARCHS[0]
cfg = cfg_of(name)
model = build_model(cfg)
mesh = compat.make_mesh((WORLD,), ("model",))
rules = shd.train_rules()
with shd.use_mesh(mesh, rules):
    report["axes"] = [list(a) for a in xl.mlstm_axes(cfg, B, S,
                                                     2 * cfg.d_model)]
want = out[f"{MESH}/{name}/forward"]
report["planted"] = {}
for what, cut_dim in (("gate", 1), ("w_down", 0)):
    real = xl.take_parts

    def contiguous(leaf, dim, axes, parts, _dim=cut_dim, _real=real):
        if parts == cfg.n_heads and dim == _dim:
            return shd.take(leaf, dim, axes)
        if parts == (1, cfg.n_heads) and dim == _dim:
            return _real(leaf, dim, axes, 2)     # the gate half's block
        return _real(leaf, dim, axes, parts)

    xl.take_parts = contiguous
    try:
        got, axes = forward(model, weights(name), mesh, rules)
    finally:
        xl.take_parts = real
    got = collectives._gather_whole(got, mesh, (None, None, axes)).numpy()
    report["planted"][what] = float(np.max(np.abs(got - want))
                                    / np.max(np.abs(want)))
real_qk = xl._intra_qk


def partial_qk(q, k, rows):
    # the intra-chunk q.k of this rank's (batch, head) pairs only, the
    # other ranks' pairs left at zero: its gather dropped
    qk = real_qk(q, k, rows)
    if not rows:
        return qk
    index, blocks = collectives.block_index(mesh, rows)
    b, _, h, _ = q.shape
    per = b * h // blocks
    mine = torch.zeros(b * h, dtype=qk.dtype)
    mine[index * per:(index + 1) * per] = 1
    return qk * mine.reshape(b, 1, 1, h)


xl._intra_qk = partial_qk
try:
    got, axes = forward(model, weights(name), mesh, rules)
finally:
    xl._intra_qk = real_qk
got = collectives._gather_whole(got, mesh, (None, None, axes)).numpy()
report["planted"]["qk"] = float(np.max(np.abs(got - want))
                                / np.max(np.abs(want)))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's (arrays, report) and the JAX logits and tokens."""
    tmp = tmp_path_factory.mktemp("value_rows")
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


def test_value_rows_split_where_heads_do_not_divide(runs):
    """The channels and the value rows over "model", the heads whole."""
    assert runs[1]["axes"] == [["model"], [], ["model"]]


@pytest.mark.parametrize("what", ["forward"] + [f"decode{i}"
                                                for i in range(STEPS)])
def test_value_rows_logits_match_jax(runs, what):
    got = runs[0][f"{MESH}/{ARCH}/{what}"]
    want = runs[2][f"{ARCH}/{what}"]
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= REL, err


def test_value_rows_decode_tokens_equal(runs):
    """Prefill + 3 greedy steps: the JAX package's tokens, and the no-mesh
    run's."""
    got = runs[0][f"{MESH}/{ARCH}/tokens"]
    np.testing.assert_array_equal(got, runs[2][f"{ARCH}/tokens"])
    np.testing.assert_array_equal(got,
                                  runs[0][f"{MESH}/{ARCH}/nomesh_tokens"])
    assert runs[1]["err"][f"{MESH}/{ARCH}/serve_logits"] <= REL


def test_value_rows_grads_match_no_mesh(runs):
    rep = runs[1]
    label = f"{MESH}/{ARCH}/train"
    assert rep["err"][f"{label}/loss"] <= GRAD_REL, rep["err"]
    assert rep["err"][f"{label}/grads"] <= GRAD_TOL, rep["err"]
    assert rep["ranks"][f"{label}/grads"]


@pytest.mark.parametrize("what", ["forward", "grads", "step", "serve_tokens",
                                  "serve_logits", "serve_cache", "outside"])
def test_value_rows_blocked_equals_whole(runs, what):
    """Blocks against whole leaves bit for bit, on every rank; and the
    backward run after the mesh frame has closed against the one inside
    it."""
    rep = runs[1]
    labels = [k for k in rep["equal"] if k.startswith(f"{MESH}/{ARCH}/")
              and k.endswith(f"/{what}")]
    assert labels
    for label in labels:
        assert rep["equal"][label] and rep["ranks"][label], label


def test_value_rows_state_held_by_rows(runs):
    """The blocked cache holds C by its value rows over "model" (the
    stacked periods' leading axis first, then the batch and the heads),
    and n, m and the sLSTM's state whole."""
    held = set(runs[1]["held"][f"{MESH}/{ARCH}"])
    assert held == {"(None, None, None, 'model', None)"}, held


@pytest.mark.parametrize("what", ["gate", "w_down"])
def test_value_rows_contiguous_cut_fails(runs, what):
    """The gate's or ``w_down``'s rows cut contiguously, not per head,
    leave the logits above the bound."""
    assert runs[1]["planted"][what] > REL, runs[1]["planted"]


def test_value_rows_partial_qk_fails(runs):
    """The intra-chunk q.k of each rank's (batch, head) pairs alone, not
    gathered whole, leaves the logits above the bound."""
    assert runs[1]["planted"]["qk"] > REL, runs[1]["planted"]
