"""Training checkpoints across the two packages: an optimizer state is a
NamedTuple (``AdamWState``), which the reference's manager writes under
its field names (``opt/.step``, ``opt/.mu/...``, ``opt/.nu/...``).  The
port's manager writes and reads the same keys, so either package's training
checkpoint restores in the other, bit for bit."""
import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.optim.adamw import AdamW, AdamWState


def _jax_tree(seed=0):
    rng = np.random.RandomState(seed)
    params = {"embed": {"table": jnp.asarray(rng.randn(8, 4), jnp.float32)},
              "stack": {"w": jnp.asarray(rng.randn(2, 4, 4), jnp.float32),
                        "b": jnp.asarray(rng.randn(4), jnp.float32)}}
    opt = JAdamW().init(params)
    opt = opt._replace(
        step=jnp.asarray(7, jnp.int32),
        mu=jax.tree.map(lambda p: p * 0.5, params),
        nu=jax.tree.map(lambda p: p * p, params))
    return {"params": params, "opt": opt}


def _as_port(jt):
    to = lambda a: torch.from_numpy(np.array(a))
    params = {k: {n: to(a) for n, a in v.items()}
              for k, v in jt["params"].items()}
    opt = jt["opt"]
    return {"params": params,
            "opt": AdamWState(step=to(opt.step),
                              mu={k: {n: to(a) for n, a in v.items()}
                                  for k, v in opt.mu.items()},
                              nu={k: {n: to(a) for n, a in v.items()}
                                  for k, v in opt.nu.items()})}


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, tuple):
        return [x for f, v in zip(tree._fields, tree)
                for x in _port_leaves(v, f"{prefix}.{f}/")]
    return [(prefix[:-1], tree)]


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), np.asarray(leaf)) for path, leaf in flat]


def test_adamw_state_keys_are_the_reference_keys(tmp_path):
    jt = _jax_tree()
    JCheckpointManager(str(tmp_path / "j")).save(1, jt)
    CheckpointManager(str(tmp_path / "p")).save(1, _as_port(jt))
    jkeys = json.load(open(tmp_path / "j/step_00000001/manifest.json"))
    pkeys = json.load(open(tmp_path / "p/step_00000001/manifest.json"))
    assert pkeys["keys"] == jkeys["keys"]
    assert pkeys["checksum"] == jkeys["checksum"]
    assert "opt/.step" in pkeys["keys"]
    assert "opt/.mu/stack/w" in pkeys["keys"]
    assert "opt/.nu/embed/table" in pkeys["keys"]
    assert sorted(_flatten(_as_port(jt))) == pkeys["keys"]


def test_jax_training_checkpoint_restores_in_the_port(tmp_path):
    jt = _jax_tree(1)
    JCheckpointManager(str(tmp_path)).save(5, jt, extra={"data": {"step": 5}})
    params = {k: {n: torch.zeros(a.shape) for n, a in v.items()}
              for k, v in jt["params"].items()}
    like = {"params": params, "opt": AdamW().init(params)}
    step, restored, extra = CheckpointManager(str(tmp_path)).restore_latest(
        like)
    assert step == 5 and extra == {"data": {"step": 5}}
    assert isinstance(restored["opt"], AdamWState)
    got, want = _port_leaves(restored), _jax_leaves(jt)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype, key
        assert np.array_equal(g.numpy(), w), key


def test_port_training_checkpoint_restores_in_jax(tmp_path):
    jt = _jax_tree(2)
    CheckpointManager(str(tmp_path)).save(9, _as_port(jt),
                                          extra={"arch": "x"})
    like = {"params": jt["params"], "opt": JAdamW().init(jt["params"])}
    restored, extra = JCheckpointManager(str(tmp_path)).restore(9, like)
    assert extra == {"arch": "x"}
    assert type(restored["opt"]).__name__ == "AdamWState"
    got, want = _jax_leaves(restored), _jax_leaves(jt)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), key


class _State(NamedTuple):
    count: torch.Tensor
    first: dict
    second: list


def test_port_roundtrips_a_namedtuple(tmp_path):
    tree = {"s": _State(count=torch.tensor(3, dtype=torch.int32),
                        first={"a": torch.arange(4.0)},
                        second=[torch.ones(2, 2), torch.zeros(3)])}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, tree)
    like = {"s": _State(count=torch.tensor(0, dtype=torch.int32),
                        first={"a": torch.zeros(4)},
                        second=[torch.zeros(2, 2), torch.ones(3)])}
    restored, _ = mgr.restore(2, like)
    s = restored["s"]
    assert isinstance(s, _State)
    assert sorted(_flatten(tree)) == ["s/.count", "s/.first/a",
                                      "s/.second/0", "s/.second/1"]
    assert torch.equal(s.count, tree["s"].count)
    assert torch.equal(s.first["a"], tree["s"].first["a"])
    assert all(torch.equal(a, b) for a, b in zip(s.second, tree["s"].second))
