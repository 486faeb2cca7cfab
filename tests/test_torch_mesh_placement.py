"""Placement tables of the port against the reference's: for every config
of the registry, every executor (with and without ``fsdp``) and each mesh
shape, every parameter leaf's spec (``param_specs``) and every cache leaf's
(``cache_specs``) equals the reference's ``PartitionSpec`` (the stacked
layer entries dropped: the port keeps a list of layers). The reference is
called with an object that has only ``.shape``, which is all its
``mesh_axes`` reads. Pure tables: no processes, no memory (the port's
trees live on the meta device, the reference's are ``jax.eval_shape``
images). Depth is cut to 4 layers (the hybrid's kept whole: its layer
plan depends on it): every layer's leaves have the same shapes and
specs."""
import functools
import math
import types

import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model      # noqa: E402
from repro.models import param_specs as jps                  # noqa: E402
from repro.models import sharding as jsh                     # noqa: E402
from repro_torch.configs.registry import REGISTRY, get_config  # noqa: E402
from repro_torch.models import sharding as sh                # noqa: E402
from repro_torch.models.param_specs import (abstract_params,  # noqa: E402
                                            cache_specs, param_specs)
from repro_torch.models.registry import build_model          # noqa: E402

ARCHS = sorted(REGISTRY)
MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((4, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
EXECUTORS = ("operator_centric", "sub_operator", "sub_operator+seqkv")
CACHE_B, CACHE_S = 32, 512


def _rules(mod, executor: str, pod_is_dp: bool, with_fsdp: bool):
    base = mod.operator_centric(pod_is_dp) if executor == "operator_centric" \
        else mod.sub_operator(pod_is_dp)
    if executor.endswith("+seqkv"):
        base = mod.seq_sharded_kv(base)
    return mod.fsdp(base) if with_fsdp else base


def _norm(spec, n: int):
    """A spec as a tuple of n entries, single axes as 1-tuples."""
    out = []
    for e in tuple(spec) + (None,) * (n - len(tuple(spec))):
        out.append(None if e is None else
                   ((e,) if isinstance(e, str) else tuple(e)))
    return tuple(out)


def _ref_paths(tree):
    """{path without stack index: (PartitionSpec, ndim)} of a reference
    tree of specs beside its shapes."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jps._path_keys(p): v for p, v in flat}


def _cut(cfg):
    return cfg if cfg.family == "hybrid" else \
        cfg.replace(n_layers=min(cfg.n_layers, 4))


@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    cfg = _cut(jax_get_config(arch))
    api = jax_build_model(cfg)
    params = jax.eval_shape(api.init, jax.random.key(0))
    caches = jax.eval_shape(lambda: api.init_caches(CACHE_B, CACHE_S))
    return params, caches


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    cfg = _cut(get_config(arch))
    api = build_model(cfg, "cpu")
    return abstract_params(cfg), api.init_caches(CACHE_B, CACHE_S,
                                                 device="meta")


_STACKED = ("blocks", "super", "tail", "enc_blocks", "dec_blocks")


def _strip_index(path: str):
    """'blocks/3/attn/wq/w' -> ('blocks', 'attn', 'wq', 'w'), and how many
    stacked layer lists it passed through."""
    keys = path.split("/")
    out, n_stack = [], 0
    for i, k in enumerate(keys):
        if k.isdigit() and i and keys[i - 1] in _STACKED:
            n_stack += 1
            continue
        out.append(k)
    return tuple(out), n_stack


def _check(ref_specs, ref_shapes, port_specs, port_shapes, what):
    ref = _ref_paths(ref_specs)
    shapes = _ref_paths(ref_shapes)
    assert port_specs, what
    seen = {_strip_index(path)[0] for path in port_specs}
    assert seen == set(ref), (what, sorted(set(ref) ^ seen))
    for path, spec in port_specs.items():
        keys, n_stack = _strip_index(path)
        assert keys in ref, (what, path)
        r_nd = len(shapes[keys].shape)
        want = _norm(ref[keys], r_nd)[r_nd - len(port_shapes[path]):]
        got = _norm(spec, len(port_shapes[path]))
        assert got == want, (what, path, got, want)


@pytest.mark.parametrize("mesh", MESHES,
                         ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_placement_equals_reference(arch, mesh):
    shape, axes = mesh
    fake = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    r_params, r_caches = _ref_trees(arch)
    p_params, p_caches = _port_trees(arch)
    from repro_torch.models.param_specs import walk
    p_pshapes = {"/".join(k): t.shape for k, t in walk(p_params)}
    p_cshapes = {"/".join(k): t.shape for k, t in walk(p_caches)}
    for executor in EXECUTORS:
        for with_fsdp in (False, True):
            pod = "pod" in axes
            rctx = jsh.ShardingCtx(fake, _rules(jsh, executor, pod,
                                                with_fsdp))
            pctx = sh.ShardingCtx(fake, _rules(sh, executor, pod, with_fsdp))
            what = (arch, shape, executor, with_fsdp)
            _check(jps.param_specs(r_params, rctx), r_params,
                   param_specs(p_params, pctx), p_pshapes, what + ("params",))
            _check(jps.cache_specs(r_caches, rctx), r_caches,
                   cache_specs(p_caches, pctx), p_cshapes, what + ("caches",))


TIERED_MESHES = [((1, 2), ("data", "model")), ((2, 1), ("data", "model")),
                 ((2, 2), ("data", "model"))]


@pytest.mark.parametrize("cold", ("int8", "int4"))
@pytest.mark.parametrize("mesh", TIERED_MESHES,
                         ids=lambda m: "x".join(map(str, m[0])))
def test_tiered_cache_placement_equals_reference(mesh, cold):
    """A tiered cache's leaves (the cold tier and its scales, the hot
    ring) under every executor: the port's ``cache_specs`` equal the
    reference's, and the part ``init_kv_cache_sharded`` allocates (through
    the model's ``init_caches``) has the shapes those specs cut."""
    from repro_torch.models.param_specs import walk
    from repro_torch.models.sharding import axes_of
    shape, axes = mesh
    over = dict(hot_window=64, kv_cold_dtype=cold, kv_cold_block=16,
                n_layers=2)
    jcfg = jax_get_config("qwen2-0.5b").replace(**over)
    tcfg = get_config("qwen2-0.5b").replace(**over)
    r_caches = jax.eval_shape(
        lambda: jax_build_model(jcfg).init_caches(CACHE_B, CACHE_S))
    p_caches = build_model(tcfg, "cpu").init_caches(CACHE_B, CACHE_S,
                                                    device="meta")
    p_cshapes = {"/".join(k): t.shape for k, t in walk(p_caches)}
    assert {"hot_k", "hot_v", "k_scale"} <= {k.split("/")[0]
                                             for k in p_cshapes}
    mesh_obj = types.SimpleNamespace(
        axis_names=axes, shape=dict(zip(axes, shape)),
        size=math.prod(shape), devices_shape=shape,
        device=torch.device("cpu"), index=lambda a: 0)
    for executor in EXECUTORS:
        rctx = jsh.ShardingCtx(types.SimpleNamespace(
            shape=dict(zip(axes, shape))), _rules(jsh, executor, False,
                                                  False))
        pctx = sh.ShardingCtx(mesh_obj, _rules(sh, executor, False, False))
        specs = cache_specs(p_caches, pctx)
        _check(jps.cache_specs(r_caches, rctx), r_caches, specs,
               p_cshapes, (shape, executor, cold))
        part = build_model(tcfg, "cpu", pctx).init_caches(
            CACHE_B, CACHE_S, device="meta")
        for k, t in walk(part):
            whole = p_cshapes["/".join(k)]
            spec = specs["/".join(k)]
            want = tuple(d // math.prod(shape[axes.index(a)]
                                        for a in axes_of(e))
                         for d, e in zip(whole, tuple(spec)
                                         + (None,) * len(whole)))
            assert tuple(t.shape) == want, (executor, k, t.shape, want)


@pytest.mark.parametrize("mesh", MESHES,
                         ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ("mamba2-1.3b", "recurrentgemma-9b",
                                  "whisper-medium"))
def test_fsdp_gathers_of_each_layer_stack_equal_reference(arch, mesh):
    """The fsdp weight gathers (``MeshLayout.weights``) of the recurrent
    and enc-dec families: for every executor, each leaf's entry in its
    stack's table (``"block"``, the hybrid's ``"super"`` and ``"tail"``,
    the enc-dec family's ``"enc"`` and ``"dec"``, or ``"top"``) names
    exactly the dims that the reference's ``param_specs`` under
    ``fsdp(rules)`` cuts over the data axes, and the tables hold no other
    leaf."""
    shape, axes = mesh
    fake = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes, size=math.prod(shape))
    r_params, _ = _ref_trees(arch)
    p_params, _ = _port_trees(arch)
    from repro_torch.models.param_specs import walk
    shapes = _ref_paths(r_params)
    for executor in EXECUTORS:
        pod = "pod" in axes
        rctx = jsh.ShardingCtx(fake, _rules(jsh, executor, pod, True))
        pctx = sh.ShardingCtx(fake, _rules(sh, executor, pod, True))
        fsdp_axes = {a for a in pctx.rules.rules["embed_w"]
                     if fake.shape.get(a, 1) > 1}
        ref = _ref_paths(jps.param_specs(r_params, rctx))
        tables = sh.MeshLayout(get_config(arch), pctx, train=True).fsdp
        want = {w: {} for w in tables} if tables else {}
        for keys, t in walk(p_params):
            r_keys, _ = _strip_index("/".join(keys))
            r_nd = len(shapes[r_keys].shape)
            spec = _norm(ref[r_keys], r_nd)[r_nd - t.ndim:]
            dims = tuple((d, e) for d, e in enumerate(spec)
                         if e and set(e) & fsdp_axes)
            if not dims:
                continue
            where = sh._STACK_WHERE.get(keys[0])
            leaf = keys[2:] if where else keys
            want[where or "top"][leaf] = dims
        want = {w: t for w, t in want.items() if t}
        got = {w: t for w, t in tables.items() if t}
        assert got == want, (arch, shape, executor)
        if fsdp_axes:
            assert "top" in got and len(got) >= 2, (arch, sorted(got))


def test_qwen2_heads_drop_to_replicated_on_four_ranks():
    """qwen2: 14 query heads and 2 KV heads on a 4-wide model axis: the
    KV cache's head axis and the per-head activations replicate, while the
    flat projection columns (896 and 128) still shard."""
    fake = types.SimpleNamespace(shape={"data": 1, "model": 4})
    ctx = sh.ShardingCtx(fake, sh.sub_operator(False))
    cfg = get_config("qwen2-0.5b")
    p = param_specs(abstract_params(cfg), ctx)
    c = cache_specs(build_model(cfg, "cpu").init_caches(4, 64,
                                                        device="meta"), ctx)
    assert p["blocks/0/attn/wq/w"] == (None, "model")
    assert p["blocks/0/attn/wk/w"] == (None, "model")
    assert c["k"][2] is None and c["v"][2] is None
    assert ctx.spec((None, None, "act_heads", None),
                    (4, 1, cfg.n_heads, cfg.head_dim))[2] is None
    assert ctx.spec(("kv_heads",), (cfg.n_kv_heads,)) == (None,)


# ---------------------------------------------------------------------------
# The residency planner, the analytical model and wa_plan
# ---------------------------------------------------------------------------

SHAPES_ = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
_FIELDS = ("weight_bytes_per_chip", "kv_bytes_per_chip",
           "vmem_weight_resident", "hbm_fits", "wa_profitable",
           "paradox_invariant")


@pytest.fixture()
def cached_jax_count(monkeypatch):
    """The reference's ``count_params`` traces ``init`` on every call; the
    planner calls it many times with one config (the counts themselves are
    held against the port's in ``test_torch_configs.py``)."""
    import repro.models.registry as jreg
    monkeypatch.setattr(jreg, "count_params",
                        functools.lru_cache(maxsize=None)(jreg.count_params))


@pytest.mark.parametrize("arch", ARCHS)
def test_residency_analytical_and_wa_plan_equal_reference(arch,
                                                          cached_jax_count):
    """Given the reference's constants (a v5e's VMEM and HBM; the paper's
    EPYC platform for the analytical model), the port's planner, model and
    policy give the reference's numbers and decisions for every shape and
    mesh."""
    import numpy as np
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.core import analytical as jan
    from repro.core import residency as jres
    from repro.core import wa as jwa
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.core import analytical as tan
    from repro_torch.core import residency as tres
    from repro_torch.core import wa as twa
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    budget = dict(fast_bytes=jres.VMEM_BYTES, hbm_bytes=jres.HBM_BYTES)
    for name in SHAPES_:
        js, ts = JSHAPES[name], SHAPES[name]
        for chips in (1, 256):
            want = jres.plan(jcfg, js, chips)
            got = tres.plan(tcfg, ts, chips, **budget)
            for f in _FIELDS:
                assert getattr(got, f) == getattr(want, f), (name, chips, f)
        for shape in ((16, 16), (4, 1)):
            want = jwa.wa_plan(jcfg, js, types.SimpleNamespace(
                devices=np.empty(shape)))
            got = twa.wa_plan(tcfg, ts, types.SimpleNamespace(
                devices_shape=shape), **budget)
            assert (got.separate, got.weight_rows, got.attention_rows) == \
                (want.separate, want.weight_rows, want.attention_rows)
    assert tres.paradox_table(tcfg, 4096, 8) == \
        jres.paradox_table(jcfg, 4096, 8)
    assert tan.weight_bytes(tcfg) == jan.weight_bytes(jcfg)
    for ctx_len in (1, 4096, 32768):
        assert tan.kv_bytes_per_token(tcfg, ctx_len) == \
            jan.kv_bytes_per_token(jcfg, ctx_len)
        assert tan.flops_per_token(tcfg, ctx_len) == \
            jan.flops_per_token(jcfg, ctx_len)
    for kw in (dict(), dict(wa_separated=True),
               dict(operator_centric=True), dict(cache_resident=False)):
        assert tan.stage_latency(tcfg, tan.EPYC_9684X, batch=8,
                                 ctx_len=4096, n_stages=2, **kw) == \
            jan.stage_latency(jcfg, jan.EPYC_9684X, batch=8, ctx_len=4096,
                              n_stages=2, **kw)
    assert tan.stages_for(tcfg, tan.EPYC_9684X) == jan.stages_for(jcfg)


def test_residency_defaults_are_the_h100s():
    from repro_torch.core import analytical as tan
    from repro_torch.core import residency as tres
    assert tres.FAST_BYTES == 50e6 and tres.HBM_BYTES == 80e9
    assert tan.H100_SXM.fast_capacity == 50e6
    assert tan.H100_SXM.slow_bw == 3.35e12


def test_make_step_refuses_train_and_pipeline():
    """The pod axis as a pipeline serves decode only, as the reference's
    ``make_pp_step``: train and prefill raise its NotImplementedError and
    decode builds a bundle. The recurrent and enc-dec families serve and
    train on a mesh; a tiered cache on a mesh is this rank's part (its
    slots and KV heads of the cold tier and of the hot ring)."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.core.execution import make_rules, make_step
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import ShardingCtx, sub_operator
    mesh = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                 shape={"pod": 2, "data": 2, "model": 2},
                                 devices_shape=(2, 2, 2), size=8,
                                 device=torch.device("cpu"))
    cfg = get_config("qwen2-0.5b").reduced().replace(n_layers=4)
    with pytest.raises(NotImplementedError, match="PP is implemented for "
                       "decode"):
        make_step(cfg, SHAPES["train_4k"], mesh, pod_strategy="pp")
    with pytest.raises(NotImplementedError, match="PP is implemented for "
                       "decode"):
        make_step(cfg, SHAPES["prefill_32k"], mesh, pod_strategy="pp")
    bundle = make_step(cfg, SHAPES["decode_32k"], mesh, pod_strategy="pp")
    assert bundle.name.endswith("|sub_operator|pp2|decode")
    assert bundle.init_caches is not None
    # the recurrent and enc-dec families train on a mesh: the step builds
    # here and, on a (1, 2) mesh of ranks, returns a finite loss
    for arch in ("mamba2-1.3b", "recurrentgemma-9b", "whisper-medium"):
        train = make_step(get_config(arch).reduced(), SHAPES["train_4k"],
                          mesh)
        assert train.plan is not None and train.ctx.rules.name.endswith(
            "+fsdp"), arch
    import numpy as np
    import torch_mesh_train_ranks
    from repro_torch.launch.mesh import spawn
    loss = spawn(torch_mesh_train_ranks.one_step_loss, (1, 2),
                 ("data", "model"), ("mamba2-1.3b", 2, 16),
                 timeout_s=300)[0]
    assert np.isfinite(loss) and loss > 0
    assert make_step(get_config("mamba2-1.3b").reduced(),
                     SHAPES["decode_32k"], mesh).api.ctx.active
    tiered = cfg.replace(hot_window=8, kv_cold_block=4)
    api = build_model(tiered, "cpu", ShardingCtx(mesh, sub_operator()))
    part = api.init_caches(8, 64, device="meta")
    assert part.is_tiered and part.seq_axes == ()
    assert tuple(part.k.shape) == (4, 2, 1, 64, 32)
    assert tuple(part.hot_k.shape) == (4, 2, 1, 12, 32)
    assert make_rules("sub_operator", mesh).rules["batch"] == ("pod", "data")
    with pytest.raises(ValueError, match="unknown executor"):
        make_rules("gspmd", mesh)
