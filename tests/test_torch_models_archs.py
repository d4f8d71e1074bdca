"""repro_torch's whole models against the JAX package: each of the ten
architectures at ``reduced()`` size with fp32 compute, the JAX package's
weights (``init_params(PRNGKey(0))``) carried across by
``models.module.from_numpy``, on the same numpy-drawn tokens: ``forward``
(logits and aux), ``prefill`` (logits and cache) and 4 ``decode_step``s
(logits and cache) within 1e-4 of the largest logit (caches 1e-4
absolute); one dense arch in bf16 as well, at 3e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro_torch import configs
from repro_torch.models import build_model, module

ARCH_NAMES = sorted(jconfigs.ARCHS)
B, S, PRE = 2, 12, 8           # batch, tokens, prefill length (then 4 steps)
REL = 1e-4                     # fp32: relative to the largest logit
BF16_REL = 3e-2                # bf16: the JAX flash-attention tests' bound


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Torch ops on one intra-op thread, the count restored after (several
    test workers share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(name, dtype="float32"):
    jcfg = dataclasses.replace(jconfigs.ARCHS[name].reduced(),
                               compute_dtype=dtype)
    cfg = dataclasses.replace(configs.ARCHS[name].reduced(),
                              compute_dtype=dtype)
    jm, m = jbuild(jcfg), build_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, m, jp, module.from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def _batch(cfg, seed, s=S):
    """(jax batch, port batch) from one numpy draw."""
    rng = np.random.RandomState(seed)
    arrs = {"tokens": rng.randint(1, cfg.vocab_size, (B, s)).astype(np.int32)}
    arrs["labels"] = arrs["tokens"]
    for key, on in (("patches", cfg.frontend == "patch"),
                    ("frames", cfg.frontend == "frame")):
        if on:
            arrs[key] = (rng.randn(B, cfg.n_frontend_tokens, cfg.d_model)
                         * 0.05).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    err = np.max(np.abs(got.detach().float().numpy() - want))
    return float(err / (np.max(np.abs(want)) + 1e-9))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat(tree[k],
                                                             path + (k,))]
    return [(path, tree)]


def _same_cache(cache, jcache, tol=1e-4):
    port, ref = _flat(cache), _flat(jcache)
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, got), (_, want) in zip(port, ref):
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol, err_msg=str(path))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_matches_jax(name):
    jm, m, jp, p = _models(name)
    jb, tb = _batch(m.cfg, 0)
    want, jaux = jm.forward(jp, jb, remat=False)
    got, aux = m.forward(p, tb)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) < REL
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-6)
    hidden, _ = m.forward(p, tb, return_hidden=True)
    jhidden, _ = jm.forward(jp, jb, remat=False, return_hidden=True)
    assert _rel(hidden, jhidden) < REL


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_match_jax(name):
    jm, m, jp, p = _models(name)
    jb, tb = _batch(m.cfg, 1, s=PRE)
    want, jcache = jm.prefill(jp, jb, max_seq=S, cache_dtype=jnp.float32)
    got, cache = m.prefill(p, tb, max_seq=S, cache_dtype=torch.float32)
    assert _rel(got, want) < REL
    _same_cache(cache, jcache)
    toks = np.random.RandomState(2).randint(1, m.cfg.vocab_size,
                                            (B, S - PRE)).astype(np.int32)
    for t in range(S - PRE):
        step = toks[:, t:t + 1]
        want, jcache = jm.decode_step(jp, jcache, jnp.asarray(step),
                                      jnp.int32(PRE + t))
        got, same = m.decode_step(p, cache, torch.from_numpy(step), PRE + t)
        assert same is cache                 # updated in place
        assert got.shape == want.shape
        assert _rel(got, want) < REL, t
    _same_cache(cache, jcache)


def test_forward_options_match_jax():
    """gemma3-1b through the chunked branch on ragged chunks (k_chunk 8 at
    S 12) and the banded local path, against the same JAX options."""
    jm, m, jp, p = _models("gemma3-1b")
    jb, tb = _batch(m.cfg, 3)
    for kw in ({"k_chunk": 8}, {"local_block": True}):
        want, _ = jm.forward(jp, jb, remat=False, **kw)
        got, _ = m.forward(p, tb, **kw)
        assert _rel(got, want) < REL, kw


def test_bf16_forward_and_decode_match_jax():
    """yi-9b with the config's own bf16 compute: logits within 3e-2 of the
    largest (rounding of bf16 activations taken at other places by XLA's
    fusion and by torch), and the same greedy token at most positions."""
    jm, m, jp, p = _models("yi-9b", dtype="bfloat16")
    jb, tb = _batch(m.cfg, 4)
    want, _ = jm.forward(jp, jb, remat=False)
    got, _ = m.forward(p, tb)
    assert _rel(got, want) < BF16_REL
    agree = float((got.argmax(-1).numpy()
                   == np.asarray(want).argmax(-1)).mean())
    assert agree >= 0.9, agree
    want, jcache = jm.prefill(jp, {"tokens": jb["tokens"][:, :PRE]},
                              max_seq=S)
    got, cache = m.prefill(p, {"tokens": tb["tokens"][:, :PRE]}, max_seq=S)
    assert cache["scan"]["p0"]["k"].dtype == torch.bfloat16
    assert _rel(got, want) < BF16_REL
    for t in range(PRE, S):
        want, jcache = jm.decode_step(jp, jcache, jb["tokens"][:, t:t + 1],
                                      jnp.int32(t))
        got, cache = m.decode_step(p, cache, tb["tokens"][:, t:t + 1], t)
        assert _rel(got, want) < BF16_REL, t
