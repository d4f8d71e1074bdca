"""The layers' sequential loops recompute each step in the backward, as the
reference's ``jax.checkpoint`` on its ``lax.scan`` bodies does
(``models.layers.scan_step``).

For ``attend_chunked`` (the online softmax over KV chunks), ``ssm_apply``
(the chunked associative scan), ``mlstm_apply`` (the chunkwise mLSTM) and
``slstm_apply`` (the per-step sLSTM), at small sizes with several chunks:

  * the output equals the unrematted loop's bit for bit, and every input
    gradient is within 1e-6 of its leaf's largest magnitude.  The
    unrematted loop is the module's own loop with ``scan_step`` made the
    identity (attention, xLSTM: their bodies are unchanged) or, for the
    SSM, whose chunk step now builds its own A_bar and Bx, the loop as it
    was, kept below;
  * the peak of live storages over the forward and the backward, counted
    as the dry-run's counter counts it (``launch.dryrun.OpCounter.track``:
    a storage is live from the op that returns it until it is freed),
    falls at least 4x for the chunked loops.  The sLSTM's step keeps its
    carry (c, n, m, h: four [B, d] tensors) where the unrematted cell keeps
    its intermediates too, while its norm and its gate and output products
    keep as many a token as before: its peak falls by the intermediates,
    held to at least ten [B, d] fp32 tensors a step;
  * the recompute runs under the mesh frame of the forward when the
    backward runs after the frame has closed (as autograd's device thread
    runs it on the card);
  * the rematted loops' outputs stay within 1e-5 of the JAX package's
    (``repro.models.attention``, ``repro.models.ssm``, ``repro.models.
    xlstm``, whose scans are ``jax.checkpoint``'ed) on the same inputs.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch.configs import get_arch
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.models import attention, ssm, xlstm

REL = 1e-6          # gradients against the unrematted loop's
JAX_REL = 1e-5      # outputs against the JAX package's (fp32)
PEAK_FACTOR = 4.0   # the chunked loops' peak, unrematted over rematted
SLSTM_UNITS = 10    # [B, d] fp32 tensors a step the sLSTM's remat frees

XCFG = dataclasses.replace(get_arch("xlstm-1.3b").reduced(), d_model=8,
                           n_heads=2, compute_dtype="float32")
SCFG = dataclasses.replace(get_arch("hymba-1.5b").reduced(), ssm_state=8)
SSM_DI = 16


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Torch ops on one intra-op thread, the count restored after (several
    test workers share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# the SSM's loop as it was: A_bar and Bx made whole, each chunk a slice
# --------------------------------------------------------------------------

def _discretize_whole(params, u):
    u32 = u.float()
    dt = F.softplus(torch.matmul(u32, params["w_dt_proj"].float())
                    + params["w_dt"])
    A = -torch.exp(params["A_log"].float()) - 1e-3
    B = torch.matmul(u32, params["w_B"].float())
    C = torch.matmul(u32, params["w_C"].float())
    A_bar = torch.exp(dt[..., None] * A[None, None])
    Bx = (dt * u32)[..., None] * B[:, :, None, :]
    return A_bar, Bx, C


def _ssm_unrematted(params, u, chunk):
    b, s, di = u.shape
    n = params["w_B"].shape[1]
    A_bar, Bx, C = _discretize_whole(params, u)
    h = torch.zeros((b, di, n), dtype=torch.float32, device=u.device)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        A_bar = F.pad(A_bar, (0, 0, 0, 0, 0, pad), value=1.0)
        Bx = F.pad(Bx, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    ys = []
    for c in range(n_chunks):
        part = slice(c * chunk, (c + 1) * chunk)
        a_i, b_i, c_i = A_bar[:, part], Bx[:, part].clone(), C[:, part]
        b_i[:, 0] += a_i[:, 0] * h
        _, h_all = ssm.associative_scan(ssm._assoc_op, (a_i, b_i))
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, c_i))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + u.float() * params["D"]
    return y.to(u.dtype), h


# --------------------------------------------------------------------------
# the four loops: (module, rematted fn, unrematted fn, args) per case
# --------------------------------------------------------------------------

def _identity(fn):
    return fn


def _attn(q, k, v):
    return attention.attend_chunked(q, k, v, causal=True, window=96,
                                    k_chunk=32, q_chunk=64)


def _ssm_new(u, p, chunk=32):
    return ssm.ssm_apply(p, u, chunk=chunk)


def _ssm_old(u, p, chunk=32):
    return _ssm_unrematted(p, u, chunk)


def _mlstm(x, p):
    return xlstm.mlstm_apply(XCFG, p, x, chunk=128)


def _slstm(x, p):
    return xlstm.slstm_apply(XCFG, p, x)


def _case(name, s):
    """(the module whose scan_step to drop or None, the rematted fn, the
    unrematted fn, the argument specs: tensors and ParamSpec trees)."""
    if name == "attend_chunked":
        q = torch.empty(1, s, 2, 8)
        return attention, _attn, _attn, (q, q, q)
    if name == "ssm_apply":
        return (None, _ssm_new, _ssm_old,
                (torch.empty(1, s, SSM_DI), ssm.ssm_spec(SCFG, SSM_DI)))
    if name == "mlstm_apply":
        return (xlstm, _mlstm, _mlstm,
                (torch.empty(1, s, XCFG.d_model), xlstm.mlstm_spec(XCFG)))
    return (xlstm, _slstm, _slstm,
            (torch.empty(1, s, XCFG.d_model), xlstm.slstm_spec(XCFG)))


def _run(mod, fn, rematted: bool):
    """``fn`` with its module's loop rematted or not."""
    def run(*args):
        if rematted or mod is None:
            return fn(*args)
        real = mod.scan_step
        mod.scan_step = _identity
        try:
            return fn(*args)
        finally:
            mod.scan_step = real
    return run


def _grads(fn, args):
    """(the output, the gradients of sum(out ** 2) for every float leaf)."""
    args = pytree.tree_map(lambda t: t.requires_grad_()
                           if isinstance(t, torch.Tensor)
                           and t.is_floating_point() else t, args)
    out = fn(*args)
    out = out[0] if isinstance(out, tuple) else out
    leaves = [t for t in pytree.tree_leaves(args)
              if isinstance(t, torch.Tensor) and t.requires_grad]
    return out, torch.autograd.grad(out.float().square().sum(), leaves)


def _real(specs, seed=0):
    """Real CPU tensors for argument specs: seeded normal data, the
    params drawn as the module inits them (A_log's zeros and D's ones)."""
    rng = np.random.RandomState(seed)

    def one(leaf):
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(rng.randn(*leaf.shape).astype(
                np.float32) * 0.5)
        if leaf.init == "zeros":
            return torch.from_numpy(rng.randn(*leaf.shape).astype(
                np.float32) * 0.1)
        if leaf.init == "ones":
            return torch.ones(leaf.shape)
        return torch.from_numpy(rng.randn(*leaf.shape).astype(np.float32)
                                * leaf.init_scale / np.sqrt(leaf.shape[0]))
    return pytree.tree_map(one, specs)


class _LiveBytes(dryrun.OpCounter):
    """The dry-run counter's live storages (``OpCounter.track``: each new
    storage counted when an op first returns it, dropped when it is
    freed) over real tensors, without its FLOP and traffic records."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.track(out)
        return out


def _peak(fn, specs) -> int:
    """The peak of live storages over ``fn``'s forward and backward."""
    args = _real(specs)
    counter = _LiveBytes()
    counter.track(pytree.tree_leaves(args))
    with counter:
        _grads(fn, args)
    return counter.peak_bytes


NAMES = ["attend_chunked", "ssm_apply", "mlstm_apply", "slstm_apply"]
VALUE_S = {"attend_chunked": 256, "ssm_apply": 200, "mlstm_apply": 300,
           "slstm_apply": 48}
PEAK_S = {"attend_chunked": 512, "ssm_apply": 1024, "mlstm_apply": 2048,
          "slstm_apply": 128}


@pytest.mark.parametrize("name", NAMES)
def test_remat_values_and_gradients_equal(name):
    """Bit-equal outputs (ragged lengths: the padded tail chunk too), and
    gradients within REL of the unrematted loop's."""
    mod, new, old, specs = _case(name, VALUE_S[name])
    args = _real(specs)
    with torch.no_grad():
        got = _run(mod, new, True)(*args)
        want = _run(mod, old, False)(*args)
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert torch.equal(g, w), name
    out, grads = _grads(_run(mod, new, True), _real(specs))
    wout, wgrads = _grads(_run(mod, old, False), _real(specs))
    assert torch.equal(out, wout)
    assert len(grads) == len(wgrads)
    for g, w in zip(grads, wgrads):
        err = ((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
        assert err <= REL, (name, err)


@pytest.mark.parametrize("name", NAMES[:3])
def test_remat_peak_falls(name):
    mod, new, old, specs = _case(name, PEAK_S[name])
    rematted = _peak(_run(mod, new, True), specs)
    unrematted = _peak(_run(mod, old, False), specs)
    assert unrematted >= PEAK_FACTOR * rematted, (name, unrematted,
                                                  rematted)


def test_slstm_remat_keeps_the_carry():
    """The sLSTM's peak falls by at least SLSTM_UNITS [B, d] fp32 tensors
    a step (B = 1): the cell's intermediates, which the unrematted loop
    keeps for every step."""
    s = PEAK_S["slstm_apply"]
    mod, new, old, specs = _case("slstm_apply", s)
    rematted = _peak(_run(mod, new, True), specs)
    unrematted = _peak(_run(mod, old, False), specs)
    step_bytes = XCFG.d_model * 4
    assert unrematted - rematted >= SLSTM_UNITS * step_bytes * s, (
        unrematted, rematted)


PROBED = {"attend_chunked": (attention, "_chunk_body"),
          "ssm_apply": (ssm, "_chunk_step"),
          "mlstm_apply": (xlstm, "_mlstm_chunk"),
          "slstm_apply": (xlstm, "_slstm_cell")}


@pytest.mark.parametrize("name", NAMES)
def test_remat_recomputes_under_the_forward_frame(name, monkeypatch):
    """The forward under a mesh frame, the backward after it has closed:
    every call of the step, the recompute's included, sees the frame."""
    mod, attr = PROBED[name]
    real = getattr(mod, attr)
    seen = []

    def probe(*args):
        seen.append(shd.active_mesh())
        return real(*args)

    monkeypatch.setattr(mod, attr, probe)
    mesh = types.SimpleNamespace(axis_names=("model",),
                                 devices=np.empty((1,)))
    _, fn, _, specs = _case(name, VALUE_S[name])
    args = pytree.tree_map(lambda t: t.requires_grad_()
                           if t.is_floating_point() else t, _real(specs))
    with shd.use_mesh(mesh, None):
        out = fn(*args)
    out = out[0] if isinstance(out, tuple) else out
    forward = len(seen)
    out.square().sum().backward()
    assert shd.active_mesh() is None
    assert len(seen) == 2 * forward > 0
    assert all(m is mesh for m in seen)


def _jax_case(name):
    """The JAX package's function for ``name``, taking the same argument
    order as the port's case."""
    from repro import configs as jconfigs
    from repro.models import attention as jattention
    from repro.models import ssm as jssm
    from repro.models import xlstm as jxlstm

    if name == "attend_chunked":
        return lambda q, k, v: jattention.attend_chunked(
            q, k, v, causal=True, window=96, k_chunk=32, q_chunk=64)
    if name == "ssm_apply":
        return lambda u, p: jssm.ssm_apply(p, u, chunk=32)
    jcfg = dataclasses.replace(jconfigs.ARCHS["xlstm-1.3b"].reduced(),
                               d_model=XCFG.d_model, n_heads=XCFG.n_heads,
                               compute_dtype="float32")
    if name == "mlstm_apply":
        return lambda x, p: jxlstm.mlstm_apply(jcfg, p, x, chunk=128)
    return lambda x, p: jxlstm.slstm_apply(jcfg, p, x)


@pytest.mark.parametrize("name", NAMES)
def test_remat_matches_the_reference(name):
    import jax.numpy as jnp

    _, fn, _, specs = _case(name, VALUE_S[name])
    args = _real(specs)
    with torch.no_grad():
        got = fn(*args)
    got = (got[0] if isinstance(got, tuple) else got).numpy()
    jargs = pytree.tree_map(lambda t: jnp.asarray(t.numpy()), args)
    want = _jax_case(name)(*jargs)
    want = np.asarray(want[0] if isinstance(want, tuple) else want)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= JAX_REL, (name, err)
