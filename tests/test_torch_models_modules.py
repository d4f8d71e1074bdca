"""repro_torch's model stack, module by module, against the JAX package:
configs field for field, the param and cache spec trees of all ten
architectures, ``ShardingRules.spec`` on fake meshes, and every model
module of the dense path (norms, MLPs, rope, the attention paths) on the
same numpy-drawn inputs with the JAX package's weights carried across by
``models.module.from_numpy``, at 1e-5 in fp32."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import sharding as jshd
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import module as jmodule
from repro.models import moe as jmoe
from repro.models.registry import build_model as jbuild
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import module
from repro_torch.models import moe
from repro_torch.models.registry import build_model

TOL = 1e-5
ARCH_NAMES = sorted(jconfigs.ARCHS)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Torch ops on one intra-op thread, the count restored after: with
    several test workers on one host a parallel op's OpenMP team waits for
    cores the other workers hold.  The tests check numbers, not speed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _cfgs(name, **kw):
    """(JAX config, port config) at reduced() with fp32 compute."""
    kw.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jconfigs.ARCHS[name].reduced(), **kw),
            dataclasses.replace(configs.ARCHS[name].reduced(), **kw))


def _params(jspec, seed=0):
    """JAX-initialised weights for a JAX spec tree: (jax tree, port tree)."""
    jp = jmodule.init(jax.random.PRNGKey(seed), jspec)
    return jp, module.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _x(seed, *shape, scale=1.0):
    arr = (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)
    return jnp.asarray(arr), torch.from_numpy(arr)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_archs_and_shapes_are_copies():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for shape in configs.SHAPES:
        for name in configs.ARCHS:
            assert configs.shape_applicable(
                configs.get_arch(name), configs.get_shape(shape)) == \
                jconfigs.shape_applicable(jconfigs.get_arch(name),
                                          jconfigs.get_shape(shape))
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("nope")
    with pytest.raises(KeyError, match="unknown shape"):
        configs.get_shape("nope")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_arch_config_field_for_field(name):
    port, ref = configs.ARCHS[name], jconfigs.ARCHS[name]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert (port.resolved_head_dim, port.has_mlp) == \
        (ref.resolved_head_dim, ref.has_mlp)
    assert [port.block_kind(i) for i in range(9)] == \
        [ref.block_kind(i) for i in range(9)]


def test_torch_dtype():
    assert configs.torch_dtype("float32") is torch.float32
    assert configs.torch_dtype("bfloat16") is torch.bfloat16
    for cfg in configs.ARCHS.values():
        for name in (cfg.compute_dtype, cfg.param_dtype):
            assert configs.torch_dtype(name).itemsize == \
                jnp.dtype(name).itemsize
    with pytest.raises(ValueError, match="unknown dtype"):
        configs.torch_dtype("int7")


# --------------------------------------------------------------------------
# spec trees
# --------------------------------------------------------------------------

def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat(tree[k], path + (k,))
        return out
    return [(path, tree)]


def _same_specs(port_tree, jax_tree):
    port, ref = _flat(port_tree), _flat(jax_tree)
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, s), (_, j) in zip(port, ref):
        assert (s.shape, s.logical_axes, s.init, s.init_scale,
                s.fan_in_axes) == (j.shape, j.logical_axes, j.init,
                                   j.init_scale, j.fan_in_axes), path
        assert str(s.dtype).removeprefix("torch.") == jnp.dtype(j.dtype).name
    assert module.count_params(port_tree) == jmodule.count_params(jax_tree)
    assert module.param_bytes(port_tree) == jmodule.param_bytes(jax_tree)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_and_cache_specs_match(name):
    for full in (True, False):
        port_cfg, ref_cfg = configs.ARCHS[name], jconfigs.ARCHS[name]
        if not full:
            port_cfg, ref_cfg = port_cfg.reduced(), ref_cfg.reduced()
        port, ref = build_model(port_cfg), jbuild(ref_cfg)
        _same_specs(port.param_specs(), ref.param_specs())
        _same_specs(port.cache_specs(2, 64), ref.cache_specs(2, 64))
        _same_specs(port.cache_specs(1, 32, cache_dtype=torch.float32),
                    ref.cache_specs(1, 32, cache_dtype=jnp.float32))
        for shape in configs.SHAPES:
            got = port.input_specs(configs.SHAPES[shape])
            want = ref.input_specs(jconfigs.SHAPES[shape])
            assert sorted(got) == sorted(want)
            for key, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == want[key].shape
                assert str(t.dtype).removeprefix("torch.") == \
                    jnp.dtype(want[key].dtype).name


def test_module_helpers():
    spec = module.ParamSpec((3, 4, 5), torch.bfloat16, ("embed", None, "mlp"),
                            fan_in_axes=(1,))
    jspec = jmodule.ParamSpec((3, 4, 5), jnp.bfloat16, ("embed", None, "mlp"),
                              fan_in_axes=(1,))
    st, jst = module.stack(spec, 7), jmodule.stack(jspec, 7)
    assert (st.shape, st.logical_axes, st.fan_in_axes) == \
        (jst.shape, jst.logical_axes, jst.fan_in_axes)
    tree = {"b": spec, "a": {"x": module.ParamSpec((2,))}}
    meta = module.shape_tree(tree)
    assert meta["b"].device.type == "meta" and meta["b"].dtype == torch.bfloat16
    assert module.leaves(tree) == [tree["a"]["x"], spec]     # sorted keys
    assert module.stack_tree(tree, 3)["a"]["x"].shape == (3, 2)
    with pytest.raises(ValueError, match="rank-mismatch"):
        module.ParamSpec((2, 3), logical_axes=("a",))


def test_init_draws_per_leaf_from_the_seed():
    spec = {"w": module.ParamSpec((64, 32)),
            "e": module.ParamSpec((100, 8), init="embed", init_scale=0.5),
            "z": module.ParamSpec((5,), init="zeros"),
            "o": module.ParamSpec((5,), torch.bfloat16, init="ones")}
    a = module.init(torch.Generator().manual_seed(3), spec, device="cpu")
    b = module.init(torch.Generator().manual_seed(3), spec, device="cpu")
    c = module.init(torch.Generator().manual_seed(4), spec, device="cpu")
    for k in spec:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["w"], c["w"])
    assert torch.equal(a["z"], torch.zeros(5))
    assert a["o"].dtype == torch.bfloat16 and bool((a["o"] == 1).all())
    assert abs(float(a["w"].std()) - 64 ** -0.5) < 0.02   # fan-in 64
    assert abs(float(a["e"].std()) - 0.5) < 0.05
    # leaves of one shape draw apart
    pair = module.init(torch.Generator().manual_seed(0),
                       {"p": module.ParamSpec((8, 8)),
                        "q": module.ParamSpec((8, 8))}, device="cpu")
    assert not torch.equal(pair["p"], pair["q"])


def test_from_numpy_carries_bfloat16_exactly():
    rng = np.random.RandomState(0)
    src = {"w": rng.randn(4, 5).astype(np.float32),
           "h": {"b": rng.randn(3).astype(ml_dtypes.bfloat16),
                 "i": np.arange(6, dtype=np.int32)},
           "j": jnp.asarray(rng.randn(2, 2), jnp.bfloat16)}
    got = module.from_numpy(src, device="cpu")
    assert got["h"]["b"].dtype == torch.bfloat16
    assert got["j"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["h"]["b"].float().numpy(),
                                  src["h"]["b"].astype(np.float32))
    np.testing.assert_array_equal(got["j"].float().numpy(),
                                  np.asarray(src["j"], np.float32))
    assert torch.equal(got["w"], torch.from_numpy(src["w"]))
    assert got["h"]["i"].dtype == torch.int32


# --------------------------------------------------------------------------
# dist.sharding
# --------------------------------------------------------------------------

def _fake_mesh(**axes):
    return types.SimpleNamespace(
        axis_names=tuple(axes),
        devices=types.SimpleNamespace(shape=tuple(axes.values())))


MESHES = [None, _fake_mesh(data=4, model=2), _fake_mesh(pod=2, data=2,
                                                        model=4),
          _fake_mesh(model=8), _fake_mesh(data=3)]
AXES = [(("batch", "seq", "embed"), (8, 16, 64)),
        (("embed", "heads", "head_dim"), (64, 6, 16)),
        (("batch", "cache_seq", "kv_heads", "head_dim"), (6, 32, 2, 16)),
        (("expert", "embed", "expert_mlp"), (8, 64, 12)),
        (("vocab", "embed"), (250, 64)),
        (("layers", "embed", "mlp"), (4, 64, 128)),
        ((None, "unknown", "mlp"), (3, 5, 8))]


@pytest.mark.parametrize("mesh_i", range(len(MESHES)))
def test_sharding_spec_matches_jax(mesh_i):
    mesh = MESHES[mesh_i]
    rule_sets = [(shd.train_rules(), jshd.train_rules()),
                 (shd.train_rules(fsdp=True, seq_parallel=True),
                  jshd.train_rules(fsdp=True, seq_parallel=True)),
                 (shd.serve_rules(), jshd.serve_rules()),
                 (shd.serve_rules(long_context=True),
                  jshd.serve_rules(long_context=True))]
    for port, ref in rule_sets:
        assert dict(port.rules) == dict(ref.rules)
        for axes, shape in AXES:
            for kw in ({}, {"shape": shape}):
                got = port.spec(axes, mesh=mesh, **kw)
                assert isinstance(got, tuple)
                assert got == tuple(ref.spec(axes, mesh=mesh, **kw))


def test_constrain_is_a_no_op_without_a_mesh():
    x = torch.randn(2, 3)
    assert shd.active_mesh() is None and shd.constrain(x, "batch",
                                                       "embed") is x
    mesh = _fake_mesh(model=2)
    with shd.use_mesh(mesh, shd.train_rules()):
        assert shd.active_mesh() is mesh
        with pytest.raises(ValueError, match="logical axes"):
            shd.constrain(x, "batch")
        with pytest.raises(NotImplementedError, match="dist slice"):
            shd.constrain(x, "batch", "embed")
        with shd.use_mesh(None, None):
            assert shd.constrain(x, "batch") is x
            assert shd.active_rules() is None
    assert shd.active_mesh() is None


def test_mesh_parts_wait_for_the_dist_slice():
    jcfg, cfg = _cfgs("qwen3-moe-235b-a22b", moe_dispatch="shardmap")
    _, p = _params(jmoe.moe_spec(jcfg))
    with pytest.raises(NotImplementedError, match="dist slice"):
        moe.moe_apply(cfg, p, torch.zeros(1, 4, cfg.d_model))
    jcfg, cfg = _cfgs("yi-9b")
    _, p = _params(jattn.attention_spec(jcfg))
    x = torch.zeros(1, 8, cfg.d_model)
    with shd.use_mesh(_fake_mesh(model=2), None):
        with pytest.raises(NotImplementedError, match="ring attention"):
            attn.attention(cfg, p, x, ring=True)
        # a ring of one device is the dense path, as in the reference
    with shd.use_mesh(_fake_mesh(model=1), None):
        assert attn.attention(cfg, p, x, ring=True).shape == x.shape


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("impl", ["f32", "bf16_apply"])
def test_norms_match_jax(kind, impl):
    jspec = jlayers.norm_spec(kind, 48)
    jp = jmodule.init(jax.random.PRNGKey(1), jspec)
    jp = jax.tree.map(lambda a: a + 0.3 * jax.random.normal(
        jax.random.PRNGKey(2), a.shape), jp)
    p = module.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jx, tx = _x(3, 2, 5, 48, scale=2.0)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, TOL),
                          (jnp.bfloat16, torch.bfloat16, 2e-2)):
        want = jlayers.apply_norm(kind, jp, jx.astype(jdt), impl=impl)
        got = layers.apply_norm(kind, p, tx.to(tdt), impl=impl)
        assert got.dtype == tdt
        _close(got, want.astype(jnp.float32), tol)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_mlps_match_jax(kind):
    jp, p = _params(jlayers.mlp_spec(kind, 32, 96))
    jx, tx = _x(4, 2, 7, 32)
    _close(layers.mlp(kind, p, tx), jlayers.mlp(kind, jp, jx))
    with pytest.raises(ValueError, match="unknown mlp kind"):
        layers.mlp("relu", p, tx)


def test_gelu_is_the_tanh_approximation():
    jx, tx = _x(5, 1000, scale=3.0)
    _close(layers.gelu(tx), jax.nn.gelu(jx), 1e-6)
    erf = torch.nn.functional.gelu(tx)
    assert float((erf - layers.gelu(tx)).abs().max()) > 1e-4


def test_embed_unembed_rope_match_jax():
    jp, p = _params(jlayers.embedding_spec(50, 16))
    toks = np.random.RandomState(6).randint(0, 50, (2, 9)).astype(np.int32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jlayers.embed(jp, jnp.asarray(toks), jdt)
        got = layers.embed(p, torch.from_numpy(toks), tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    jx, tx = _x(7, 2, 9, 16)
    _close(layers.unembed(p, tx), jlayers.unembed(jp, jx))
    for theta in (10000.0, 1_000_000.0, 5_000_000.0):
        jq, tq = _x(8, 2, 9, 3, 16)
        pos = np.stack([np.arange(9), np.arange(9) + 100]).astype(np.int32)
        _close(layers.rope(tq, torch.from_numpy(pos), theta),
               jlayers.rope(jq, jnp.asarray(pos), theta))


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,window,q_offset", [(20, 8, 0), (16, 8, 0),
                                               (13, 4, 3)])
def test_attend_local_matches_jax(s, window, q_offset):
    jq, tq = _x(9, 2, s, 4, 16, scale=0.5)
    jk, tk = _x(10, 2, s, 4, 16, scale=0.5)
    jv, tv = _x(11, 2, s, 4, 16)
    kw = {"window": window, "q_offset": q_offset}
    _close(attn.attend_local(tq, tk, tv, **kw),
           jattn.attend_local(jq, jk, jv, **kw))


@pytest.mark.parametrize("window,with_start", [(0, False), (5, False),
                                               (0, True), (4, True)])
def test_attend_decode_matches_jax(window, with_start):
    jq, tq = _x(12, 3, 1, 4, 16, scale=0.5)
    jk, tk = _x(13, 3, 20, 2, 16, scale=0.5)
    jv, tv = _x(14, 3, 20, 2, 16)
    start = np.array([0, 3, 9], np.int32) if with_start else None
    for index in (0, 9, 19):
        want = jattn.attend_decode(
            jq, jk, jv, jnp.int32(index), window=window,
            start=None if start is None else jnp.asarray(start))
        got = attn.attend_decode(
            tq, tk, tv, index, window=window,
            start=None if start is None else torch.from_numpy(start))
        _close(got, want)


CASES = [  # (arch, kw)
    ("yi-9b", {}),                                       # GQA 4:2
    ("gemma3-1b", {"window": 8}),                        # window, GQA
    ("gemma3-1b", {"window": 8, "local_block": True}),   # banded path
    ("deepseek-67b", {"causal": False}),
    ("nemotron-4-15b", {"k_chunk": 8}),                  # chunked, ragged
    ("whisper-medium", {"use_rope": False, "cross": True,
                        "causal": False}),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_attention_matches_jax(case):
    name, kw = CASES[case]
    kw = dict(kw)
    jcfg, cfg = _cfgs(name)
    jp, p = _params(jattn.attention_spec(jcfg))
    jx, tx = _x(15, 2, 13, cfg.d_model)
    if kw.pop("cross", False):
        jm, tm = _x(16, 2, 6, cfg.d_model)
        kw_j, kw_t = dict(kw, kv_src=jm), dict(kw, kv_src=tm)
    else:
        kw_j = kw_t = kw
    want, (jk, jv) = jattn.attention(jcfg, jp, jx, return_kv=True, **kw_j)
    got, (tk, tv) = attn.attention(cfg, p, tx, return_kv=True, **kw_t)
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)
    _close(attn.attention(cfg, p, tx, **kw_t), want)


def test_project_and_expand_match_jax():
    jcfg, cfg = _cfgs("yi-9b")
    jp, p = _params(jattn.attention_spec(jcfg))
    jx, tx = _x(17, 2, 5, cfg.d_model)
    for got, want in zip(attn._project_qkv(cfg, p, tx),
                         jattn._project_qkv(jcfg, jp, jx)):
        _close(got, want)
        _close(attn._expand_kv(got, 4), jattn._expand_kv(want, 4))


@pytest.mark.parametrize("name,update,with_start",
                         [("yi-9b", True, False), ("gemma3-1b", True, True),
                          ("whisper-medium", False, False)])
def test_attention_decode_step_matches_jax(name, update, with_start):
    jcfg, cfg = _cfgs(name)
    jp, p = _params(jattn.attention_spec(jcfg))
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    jk, tk = _x(18, 2, 10, kv, hd, scale=0.5)
    jv, tv = _x(19, 2, 10, kv, hd)
    jx, tx = _x(20, 2, 1, cfg.d_model)
    start = np.array([0, 2], np.int32) if with_start else None
    kw = {"window": cfg.sliding_window, "update_cache": update,
          "use_rope": update}
    want, jc = jattn.attention_decode_step(
        jcfg, jp, jx, {"k": jk, "v": jv}, jnp.int32(6),
        start=None if start is None else jnp.asarray(start), **kw)
    cache = {"k": tk, "v": tv}
    got, tc = attn.attention_decode_step(
        cfg, p, tx, cache, 6,
        start=None if start is None else torch.from_numpy(start), **kw)
    _close(got, want)
    assert tc is cache and tc["k"] is tk     # written in place
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_kernel_plain_version_equals_attend_chunked():
    """The flash kernel's plain versions on the [B,H,S,D] layout with k
    and v un-expanded equal attend_chunked on the expanded [B,S,H,D]
    layout: a gemma-like case, GQA 4:1, window, ragged S."""
    b, s, h, kv, d, window = 2, 300, 4, 1, 32, 64
    jq, tq = _x(21, b, s, h, d, scale=0.5)
    _, tk = _x(22, b, s, kv, d, scale=0.5)
    _, tv = _x(23, b, s, kv, d)
    want = attn.attend_chunked(tq, attn._expand_kv(tk, h),
                               attn._expand_kv(tv, h), causal=True,
                               window=window, k_chunk=128, q_chunk=64)
    layout = [t.transpose(1, 2) for t in (tq, tk, tv)]
    for got in (fa_ref.attention(*layout, causal=True, window=window),
                fa_ops.attention(*layout, causal=True, window=window)):
        _close(got.transpose(1, 2), want)
    # and the model's chunked branch on a CPU tensor is attend_chunked
    jcfg, cfg = _cfgs("gemma3-1b")
    jp, p = _params(jattn.attention_spec(jcfg))
    jx, tx = _x(24, 2, 40, cfg.d_model)
    for use_kernel in (True, False):
        _close(attn.attention(cfg, p, tx, window=8, k_chunk=16,
                              use_kernel=use_kernel),
               jattn.attention(jcfg, jp, jx, window=8, k_chunk=16))
