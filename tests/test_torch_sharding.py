"""The port's sharding rules against ``repro``'s, leaf for leaf, without a
rank or an allocation: ``repro``'s state from ``jax.eval_shape``, the
port's on the ``meta`` device, meshes duck-typed with the production axis
sizes (as ``tests/test_sharding.py`` does).

Contracts:

* for every config ``repro`` knows, at (data 16, model 16) and (pod 2,
  data 16, model 16), every parameter's spec and every ``m`` / ``v`` /
  ``master`` spec of the port's ``state_pspecs`` equals ``repro``'s, the
  leaves paired as ``params_from_jax`` pairs them; a leaf of ``repro``'s
  stacked body carries a leading ``None`` the port's per-layer leaf has
  not.  Where ``repro``'s ZeRO-1 puts 'data' on that leading layer
  dimension (the body's ``n_groups`` a multiple of the data size, as
  qwen2.5-32b's 64 groups), the port's per-layer leaf has no layer
  dimension to split: it takes ``repro``'s own ``_zero1`` on its
  per-layer shape instead, and the test checks exactly that for exactly
  those leaves.  Adafactor's ``stats`` (kimi) are paired where both hold
  the same
  statistic; ``repro`` factors a stacked 1-D leaf (a norm scale across the
  layers) where the port keeps its full ``v`` (the by-design difference of
  ROADMAP.md Queue 3), and exactly those are left out;
* ``batch_pspecs`` and ``cache_pspecs`` match on ``repro``'s own cases;
* every sharded dimension divides: each leaf's local shape exists and no
  axis shards two dimensions of one leaf (``test_param_specs_divide``);
* the production and host meshes and ``arch_for_mesh`` as ``repro``'s.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS
from repro.configs import get_arch as jget_arch
from repro.configs.base import LM_SHAPES
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_host_mesh


class _Pod:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class _MultiPod:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"16x16": _Pod(), "2x16x16": _MultiPod()}


@functools.lru_cache(maxsize=None)
def _repro_state(name):
    cfg = jget_arch(name)
    return cfg, jspecs.state_specs(cfg,
                                   jspecs.train_config_for(cfg, LM_SHAPES[0]))


@functools.lru_cache(maxsize=None)
def _port_state(name):
    cfg = get_arch(name)
    return cfg, tspecs.state_specs(cfg,
                                   tspecs.train_config_for(cfg, LM_SHAPES[0]))


def _locate(tree, name, cfg):
    """``repro``'s node for the port's leaf ``name`` and whether it is
    stacked (``params_from_jax``'s map)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        i, rest = int(parts[1]), parts[2:]
        n_pre, per = len(cfg.prefix), len(cfg.pattern)
        if i < n_pre:
            node, stacked = tree["prefix"][i], False
        elif i < n_pre + cfg.n_groups * per:
            node, stacked = tree["body"][(i - n_pre) % per], True
        else:
            node, stacked = tree["suffix"][i - n_pre - cfg.n_groups * per], \
                False
    elif parts[0] == "encoder" and parts[1] == "blocks":
        node, stacked, rest = tree["encoder"]["body"], True, parts[3:]
    else:
        node, stacked, rest = tree, False, parts
    for key in rest:
        node = node[key]
    return node, stacked


def _same(port, jspec, stacked):
    want = tuple(jspec)
    return port == (want[1:] if stacked else want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_state_specs_equal_repros(name, mesh):
    m = MESHES[mesh]
    jcfg, jst = _repro_state(name)
    cfg, st = _port_state(name)
    jspec = jsh.state_pspecs(jst, jcfg, m)
    spec = sh.state_pspecs(st, cfg, m)
    assert spec["step"] == tuple(jspec["step"]) == ()
    n = 0
    for pname in spec["params"]:
        node, stacked = _locate(jspec["params"], pname, cfg)
        assert _same(spec["params"][pname], node, stacked), \
            (pname, spec["params"][pname], node)
        n += 1
    assert n == len(list(st["params"].parameters()))
    nd = m.shape["data"]
    for key in ("m", "v", "master"):
        assert (key in spec["opt"]) == (key in jspec["opt"]), key
        for pname, s in spec["opt"].get(key, {}).items():
            node, stacked = _locate(jspec["opt"][key], pname, cfg)
            if stacked and tuple(node)[0] is not None:    # layers on 'data'
                assert cfg.n_groups % nd == 0 and tuple(node)[0] == "data"
                pnode, _ = _locate(jspec["params"], pname, cfg)
                want = jsh._zero1(P(*tuple(pnode)[1:]),
                                  st["params"].full_shapes[pname], nd)
                assert s == tuple(want), (key, pname, s, want)
                continue
            assert _same(s, node, stacked), (key, pname, s, node)
    skipped = 0
    for pname, stats in spec["opt"].get("stats", {}).items():
        node, stacked = _locate(jspec["opt"]["stats"], pname, cfg)
        if set(stats) != set(node):       # repro factors a stacked 1-D leaf
            assert stacked and set(stats) == {"v"}, (pname, node)
            assert st["params"].full_shapes[pname].__len__() == 1
            skipped += 1
            continue
        for s, v in stats.items():
            assert _same(v, node[s], stacked), (pname, s, v, node[s])
    assert skipped == (0 if name != "kimi-k2-1t-a32b" else sum(
        1 for k, s in st["params"].full_shapes.items()
        if len(s) == 1 and _locate(jspec["params"], k, cfg)[1]))
    assert spec["opt"]["count"] == tuple(jspec["opt"]["count"]) == ()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_divide(name, mesh):
    """Every sharded dim divides its axes; no axis twice in one leaf's
    layout; something is sharded."""
    m = MESHES[mesh]
    cfg, st = _port_state(name)
    spec = sh.state_pspecs(st, cfg, m)
    shapes = dict(st["params"].full_shapes)
    leaves = [(spec["params"][k], shapes[k]) for k in shapes]
    for key in ("m", "v", "master"):
        leaves += [(spec["opt"][key][k], shapes[k])
                   for k in spec["opt"].get(key, {})]
    n_sharded = 0
    for s, shape in leaves:
        local = sh.local_shape(shape, s, m)
        assert len(local) == len(shape)
        axes = sh.spec_axes(s)
        assert len(axes) == len(set(axes)), s
        n_sharded += local != shape
    assert n_sharded > 0


def test_batch_specs():
    b = {"tokens": jax.ShapeDtypeStruct((256, 4096), jnp.int32),
         "memory": jax.ShapeDtypeStruct((256, 1601, 64), jnp.bfloat16),
         "small": jax.ShapeDtypeStruct((1, 8), jnp.int32)}
    want = jsh.batch_pspecs(b, _Pod())
    got = sh.batch_pspecs(b, _Pod())
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got["tokens"] == ("data", None)
    assert got["small"] == (None, None)
    multi = sh.batch_pspecs(b, _MultiPod())
    assert multi == {k: tuple(v) for k, v in
                     jsh.batch_pspecs(b, _MultiPod()).items()}
    assert multi["tokens"] == (("pod", "data"), None)


def test_cache_specs_find_batch_dim():
    cache = {"body": ({"k": jax.ShapeDtypeStruct((56, 128, 4096, 8, 128),
                                                 jnp.bfloat16)},),
             "prefix": ({"k": jax.ShapeDtypeStruct((128, 4096, 8, 128),
                                                   jnp.bfloat16)},)}
    want = jsh.cache_pspecs(cache, _Pod(), batch_size=128)
    got = sh.cache_pspecs(cache, _Pod(), batch_size=128)
    assert got["body"][0]["k"] == tuple(want["body"][0]["k"]) == \
        (None, "data", None, None, None)
    assert got["prefix"][0]["k"] == tuple(want["prefix"][0]["k"]) == \
        ("data", None, None, None)


def test_expert_banks_shard_over_model_and_data():
    """kimi's expert banks: EP over 'model' plus FSDP over 'data'."""
    cfg, st = _port_state("kimi-k2-1t-a32b")
    spec = sh.param_pspecs(st["params"], cfg, _Pod())
    banks = [k for k in spec if ".moe.w_up" in k]
    assert banks
    for k in banks:
        assert {"model", "data"} <= set(sh.spec_axes(spec[k])), spec[k]


@pytest.mark.parametrize("name", ["mixtral-8x22b", "kimi-k2-1t-a32b",
                                  "whisper-medium"])
def test_arch_for_mesh_and_train_config_equal_repros(name):
    for mesh in MESHES.values():
        for shape in LM_SHAPES:
            a = jspecs.arch_for_mesh(jget_arch(name), mesh, shape)
            b = tspecs.arch_for_mesh(get_arch(name), mesh, shape)
            assert a.moe_dispatch_groups == b.moe_dispatch_groups
            assert a.cross_memory_len == b.cross_memory_len
            ja = jspecs.train_config_for(a, shape)
            ta = tspecs.train_config_for(b, shape)
            assert (ja.optimizer, ja.param_dtype, ja.keep_master,
                    ja.dp.n_micro) == (ta.optimizer, ta.param_dtype,
                                       ta.keep_master, ta.dp.n_micro)


def test_host_mesh_without_a_process_group():
    m = make_host_mesh()
    assert m.shape == {"data": 1, "model": 1}
    assert m.coords == {"data": 0, "model": 0}
    assert sh.dp_size(m) == 1 and sh.tp_size(m) == 1
    assert sh.dp_axes(_MultiPod()) == jsh.dp_axes(_MultiPod())
    assert sh.dp_size(_MultiPod()) == jsh.dp_size(_MultiPod()) == 32
