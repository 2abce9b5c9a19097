"""Serving under a mesh: the port's serving specs against ``repro``'s, and
the sharded prefill and decode on 4 Gloo ranks on the CPU against the
one-rank port and ``repro``.

The ranks are spawned once for the module (:func:`ranks`): they import
``repro_torch`` only and run every case through
:func:`repro_torch.launch.sharded_train.jobs` (the job kinds of
:mod:`repro_torch.launch.sharded_serve`); rank 0 of each case serves the
same seeded model whole in its own process and holds the mesh to it
(``serve_job(reference=True)``).  ``repro``'s specs and serving run here,
in the test process.

Contracts:

* (a) for every config ``repro`` knows, at (data 16, model 16) and (pod
  2, data 16, model 16), on ``prefill_32k``, ``decode_32k`` and
  ``long_500k`` where ``shapes_for`` gives it: the port's
  ``serve_cell`` parameter, batch, cache and output specs equal
  ``repro``'s ``build_cell`` in- and out-shardings; on the decode cells
  the port's ``cache_specs`` shapes and dtypes and their
  ``cache_pspecs`` equal ``repro``'s leaf for leaf (a per-layer leaf
  against ``repro``'s stacked one without its leading layer dimension);
  its ``input_specs`` equal ``repro``'s on every shape; every rank's
  cache share divides and holds no more than ``cache_pspecs`` gives it;
* (b) reduced ``qwen2.5-3b`` (attention on local heads),
  ``recurrentgemma-2b`` (``rec`` on local channels, its one-KV-head
  attention whole), ``llama-3.2-vision-11b`` (``xattn``),
  ``whisper-medium`` (encoder and ``encdec``), ``mixtral-8x22b`` (MoE,
  dispatch groups = DP) and ``xlstm-125m`` (no TP), float32, B=4, prompt
  8, gen 6 (the windowed configs' rings wrap), model leaves seeded
  nonzero and a seeded memory / frames, on (data 2, model 2) and (pod
  2, data 1, model 2): prefill and decode logits and every cache entry
  (after the prefill and after the last step) within 1e-5 of the
  largest |value| of the one-rank port's, the tokens equal wherever its
  top-two gap exceeds that; MoE chosen experts equal but near-ties and
  each dispatch group's kept and dropped assignments equal where it has
  none; every rank's parameter shards, working parameters and cache
  bytes the rules' count, its cache entries its rows and, where the
  block runs tensor-parallel, its heads or channels;
* (c) B=1 on (data 2, model 2) is served whole on both DP ranks
  (``repro``'s ``cache_pspecs`` leaves it whole), against the one-rank
  port as in (b);
* (d) at (1, 1) the sharded serve is bitwise the unsharded one (no
  process group needed: in this process);
* (e) reduced ``qwen2.5-3b`` in bfloat16 on (data 2, model 2) within 2 d
  of the one-rank bfloat16 serve, d that serve's distance from float32
  (``PERF.md`` §2's bfloat16 row); the cache within twice its own
  distance;
* (f) the (data 2, model 2) qwen serve against ``repro``'s own
  ``forward_with_cache`` / ``decode_step`` on the same parameters
  (teacher-forced with the mesh's tokens): logits within 1e-4 of the
  largest |logit|, the K/V cache within 2e-5 (``tests/test_torch_serve.py``'s
  bounds).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.configs.base import LM_SHAPES, shapes_for
from repro_torch.distributed import sharding as sh
from repro_torch.launch import serve, sharded_serve, sharded_train
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharded_service import spawn
from repro_torch.models import init_model

B, PROMPT, GEN = 4, 8, 6
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
SERVE_ARCHS = sharded_serve.SMOKE_ARCHS
RTOL_REPRO, ATOL_CACHE = 1e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's side: its CPU work here is small,
    and the test runner runs several workers at once, each of whose
    thread pools would otherwise oversubscribe the cores (as
    ``tests/test_torch_distributed.py`` does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _job(arch, mesh, **over):
    job = dict(arch=arch, smoke=True, mesh=MESHES[mesh], batch=B,
               prompt_len=PROMPT, gen=GEN, param_dtype="float32",
               cross_seed=1, nonzero=True, reference=True)
    job.update(over)
    return job


SERVE_CASES = [(m, a) for m in MESHES for a in SERVE_ARCHS]


@pytest.fixture(scope="module")
def ranks():
    """Every case on one spawn of 4 Gloo ranks: each rank's results."""
    todo = [("serve", _job(a, m, keep=(m, a) == ("2x2", "qwen2.5-3b")))
            for m, a in SERVE_CASES]
    todo += [("serve", _job("qwen2.5-3b", "2x2", batch=1)),
             ("serve", _job("mixtral-8x22b", "2x2", batch=1)),
             ("serve", _job("qwen2.5-3b", "2x2", param_dtype="bfloat16"))]
    res = spawn(sharded_train.jobs, 4, backend="gloo", device="cpu",
                args=(todo,), timeout=600)
    n = len(SERVE_CASES)
    per = [[r[j] for r in res] for j in range(len(todo))]
    return dict(serve=dict(zip(SERVE_CASES, per[:n])),
                b1=dict(zip(("qwen2.5-3b", "mixtral-8x22b"), per[n:n + 2])),
                bf16=per[n + 2])


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("mesh,arch", SERVE_CASES)
def test_sharded_serve_matches_one_rank(ranks, mesh, arch):
    r0 = ranks["serve"][(mesh, arch)][0]
    c = r0["vs_one_rank"]
    for part in ("prefill", "decode"):
        assert c["errs"][part] <= 1e-5 * max(c["tops"]["prefill"],
                                             c["tops"]["decode"]), c
    assert c["errs"]["cache"] <= 1e-5 * c["tops"]["cache"], c
    assert c["errs"]["cache_share"] <= 1.0
    assert c["tokens_differ"] <= c["near_ties"]
    assert c["tops"]["cache"] > 0 and c["tops"]["prefill"] > 0
    if arch == "xlstm-125m":        # no TP: each row's sums as one rank's
        assert c["errs"]["prefill"] == 0.0 and c["errs"]["cache"] == 0.0


def _expected_cache(cfg, kind, name, rows, plan):
    """The shape of a rank's cache entry ``name`` of a ``kind`` block, on
    a 'model' size of 2."""
    H, D = cfg.n_heads, cfg.d_model
    if kind == "slstm":
        return (rows, H, D // H)
    Lc = PROMPT + GEN
    if kind in ("swa", "local") and cfg.window:
        Lc = min(cfg.window, Lc)
    kh = cfg.kv_heads // 2 if plan.attn else cfg.kv_heads
    width = D // 2 if plan.rg else D
    return {"k": (rows, Lc, kh, cfg.dh), "v": (rows, Lc, kh, cfg.dh),
            "xk": (rows, cfg.cross_memory_len, kh, cfg.dh),
            "xv": (rows, cfg.cross_memory_len, kh, cfg.dh),
            "conv": (rows, 3, width), "h": (rows, width),
            "C": (rows, H, D // H, D // H), "n": (rows, H, D // H),
            "m": (rows, H)}[name]


@pytest.mark.parametrize("mesh,arch", SERVE_CASES)
def test_each_rank_holds_its_share(ranks, mesh, arch):
    """Parameter shards, working parameters and cache bytes are the rules'
    count on every rank; the cache holds the rank's rows and, where the
    block runs tensor-parallel, its heads or channels."""
    from repro_torch.distributed.tensor_parallel import tp_plan
    res = ranks["serve"][(mesh, arch)]
    cfg = res[0]["cfg"]
    plan = tp_plan(cfg, 2)
    seen = set()
    for r in res:
        b = r["bytes"]
        assert b["shards"] == b["shards_rule"] > 0, b
        assert b["params"] == b["params_rule"] >= b["shards"], b
        assert b["cache"] == b["cache_layout"] <= b["cache_pspecs"], b
        lo, hi = r["rows"]
        assert hi - lo == B // 2
        seen.add((lo, r["coords"]["model"]))
        for (kind, _), entry in zip(cfg.layer_specs(), r["cache_shapes"]):
            for name, shape in entry.items():
                assert shape == _expected_cache(cfg, kind, name, hi - lo,
                                                plan), (kind, name, shape)
    assert seen == {(0, 0), (0, 1), (2, 0), (2, 1)}
    if arch in ("qwen2.5-3b", "recurrentgemma-2b"):
        # local heads (qwen) or channels (recurrentgemma) halve the cache
        assert res[0]["bytes"]["cache"] < res[0]["bytes"]["cache_pspecs"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_dispatches_a_group_per_dp_rank(ranks, mesh):
    r0 = ranks["serve"][(mesh, "mixtral-8x22b")][0]
    assert r0["cfg"].moe_dispatch_groups == 2
    rt = r0["routes"]
    n_moe = sum(m for _, m in r0["cfg"].layer_specs())
    assert rt["groups"] == n_moe * 2 * GEN      # the prefill, GEN - 1 steps
    assert rt["groups_with_ties"] <= rt["near_ties"]
    assert rt["tokens"] == n_moe * (B * PROMPT + B * (GEN - 1))


# ------------------------------------------------------------------ (c)
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x22b"])
def test_batch_that_does_not_divide_dp_is_served_whole(ranks, arch):
    res = ranks["b1"][arch]
    for r in res:
        assert r["rows"] == (0, 1)
        assert r["bytes"]["cache"] == r["bytes"]["cache_layout"]
        assert all(e[n][0] == 1 for e in r["cache_shapes"] for n in e)
    c = res[0]["vs_one_rank"]
    assert c["errs"]["prefill"] <= 1e-5 * c["tops"]["prefill"], c
    assert c["tokens_differ"] <= c["near_ties"]
    if arch == "mixtral-8x22b":
        assert res[0]["cfg"].moe_dispatch_groups == 1
        assert res[0]["routes"]["groups"] > 0


# ------------------------------------------------------------------ (d)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_one_by_one_mesh_is_bitwise_the_unsharded_serve(arch):
    got = sharded_serve.serve_bitwise_job(0, 1, "cpu", dict(
        arch=arch, smoke=True, batch=B, prompt_len=PROMPT, gen=GEN))
    assert got["bitwise"], got


def test_serve_run_without_a_mesh_keeps_one_device():
    rec = serve.run(smoke=True, device="cpu", gen=2, log=None)
    assert "mesh" not in rec
    mp = serve.run(smoke=True, device="cpu", gen=2, log=None,
                   multi_pod=True)
    assert mp["mesh"] == {"data": 1, "model": 1}
    assert torch.equal(mp["tokens"], rec["tokens"])
    with pytest.raises(ValueError, match="model="):
        serve.run(model=init_model(rec["cfg"], 0, device="cpu"),
                  multi_pod=True, log=None)
    with pytest.raises(NotImplementedError, match="pipeline"):
        serve.run(smoke=True, device="cpu", gen=2, log=None,
                  mesh=make_mesh((1,), ("pod",)))


def test_sampling_a_ranks_rows_draws_the_whole_batchs():
    """``serve_step(rows=)``: a rank's rows sample with the whole batch's
    draw cut to them, so a mesh that splits the batch samples what one
    rank does."""
    from repro_torch.models import forward_with_cache
    from repro_torch.training import serve_step
    cfg = reduced(get_arch("qwen2.5-3b"))
    model = init_model(cfg, 0, device="cpu")
    tok = torch.randint(0, cfg.vocab, (B, PROMPT),
                        generator=torch.Generator().manual_seed(1))
    logits, cache = forward_with_cache(model, tok, cfg, PROMPT + 2)
    nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    whole, _, _ = serve_step(model, nxt, cache, PROMPT, cfg, temperature=1.0,
                             generator=torch.Generator().manual_seed(3))
    for lo, hi in ((0, 2), (2, 4)):
        _, part = forward_with_cache(model, tok[lo:hi], cfg, PROMPT + 2)
        got, _, _ = serve_step(model, nxt[lo:hi], part, PROMPT, cfg,
                               temperature=1.0, rows=(lo, hi, B),
                               generator=torch.Generator().manual_seed(3))
        assert torch.equal(got, whole[lo:hi])


# ------------------------------------------------------------------ (e)
def test_bfloat16_within_twice_its_own_distance(ranks):
    r0 = ranks["bf16"][0]
    c = r0["vs_one_rank"]
    d = r0["d"]
    assert 0 < d < 5e-2 * r0["d_scale"]
    assert c["bound"] == 2.0 * d
    assert max(c["errs"]["prefill"], c["errs"]["decode"]) <= 2.0 * d
    assert c["errs"]["cache_share"] <= 1.0
    assert c["tokens_differ"] <= c["near_ties"]
    for r in ranks["bf16"]:
        assert r["bytes"]["params"] == r["bytes"]["params_rule"]


# ------------------------------------------------------------------ (f)
def _jax_tree(model, cfg):
    """``repro``'s parameter pytree holding ``model``'s values (the
    inverse of ``params_from_jax``: the body stacked group by group)."""
    leaves = {n: p.detach().numpy() for n, p in model.named_parameters()}

    def sub(prefix):
        out = {}
        for n, a in leaves.items():
            if n.startswith(prefix):
                keys = n[len(prefix):].split(".")
                d = out
                for k in keys[:-1]:
                    d = d.setdefault(k, {})
                d[keys[-1]] = a
        return out

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    n_pre, per = len(cfg.prefix), len(cfg.pattern)
    blocks = [sub(f"blocks.{i}.") for i in range(cfg.n_layers)]
    body = tuple(stack([blocks[n_pre + g * per + pos]
                        for g in range(cfg.n_groups)]) for pos in range(per))
    tree = {"embed": sub("embed."), "final_norm": sub("final_norm."),
            "prefix": tuple(blocks[:n_pre]), "body": body,
            "suffix": tuple(blocks[n_pre + cfg.n_groups * per:])}
    if not cfg.tie_embeddings:
        tree["lm_head"] = sub("lm_head.")
    return tree


def test_mesh_serve_matches_repro(ranks):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_arch as jget_arch
    from repro.configs import reduced as jreduced
    from repro.models import decode_step as jdecode_step
    from repro.models import forward_with_cache as jforward_with_cache
    run = ranks["serve"][("2x2", "qwen2.5-3b")][0]["run"]
    cfg = reduced(get_arch("qwen2.5-3b"))
    jcfg = jreduced(jget_arch("qwen2.5-3b"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    whole = init_model(cfg, 0, device="cpu")
    sharded_serve.seed_nonzero(whole, 0)
    tree = jax.tree.map(jnp.asarray, _jax_tree(whole, cfg))

    def close(got, want):
        want = np.asarray(want, np.float64)
        err = np.abs(got.double().numpy() - want).max()
        assert err <= RTOL_REPRO * np.abs(want).max(), err

    want, jcache = jforward_with_cache(tree, jnp.asarray(
        run["prompts"].numpy()), jcfg, cache_len=PROMPT + GEN)
    close(run["logits"]["prefill"], want)
    for i in range(GEN - 1):
        step = run["tokens"][:, i:i + 1].numpy()
        want, jcache = jdecode_step(tree, jnp.asarray(step), jcache,
                                    jnp.asarray(PROMPT + i), jcfg)
        close(run["logits"]["decode"][:, i], np.asarray(want)[:, 0])
    body = jcache["body"][0]
    for g in range(cfg.n_groups):
        for n in ("k", "v"):
            np.testing.assert_allclose(run["cache"]["final"][g][n].numpy(),
                                       np.asarray(body[n])[g], rtol=0,
                                       atol=ATOL_CACHE)


# ------------------------------------------------------------------ (a)
class _Pod:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class _MultiPod:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


PROD = {"16x16": _Pod(), "2x16x16": _MultiPod()}
SERVE_SHAPES = [s for s in LM_SHAPES if s.kind != "train"]


def _jcache_node(cache, i, cfg):
    """``repro``'s cache node of the port's block ``i`` and whether it is
    stacked (layers prefix, body group by group, suffix)."""
    n_pre, per = len(cfg.prefix), len(cfg.pattern)
    if i < n_pre:
        return cache["prefix"][i], False
    if i < n_pre + cfg.n_groups * per:
        return cache["body"][(i - n_pre) % per], True
    return cache["suffix"][i - n_pre - cfg.n_groups * per], False


def _dtype(jdt):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int32": torch.int32}[str(jdt)]


@functools.lru_cache(maxsize=None)
def _jcell(name, shape_name, mesh):
    """``repro``'s ``build_cell`` (its ``eval_shape`` traces take seconds
    a cell: each is made once for the module)."""
    from repro.launch import specs as jspecs
    shape = next(s for s in LM_SHAPES if s.name == shape_name)
    return jspecs.build_cell(name, shape, PROD[mesh])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_and_input_specs_equal_repros(name):
    from repro.configs import get_arch as jget_arch
    from repro.configs import shapes_for as jshapes_for
    from repro.distributed import sharding as jsh
    from repro.launch import specs as jspecs
    jcfg, cfg = jget_arch(name), get_arch(name)
    assert [s.name for s in jshapes_for(jcfg)] == \
        [s.name for s in shapes_for(cfg)]
    for shape in shapes_for(cfg):
        jin, tin = jspecs.input_specs(jcfg, shape), \
            tspecs.input_specs(cfg, shape)
        assert set(jin) == set(tin)
        for k in jin:
            assert tuple(tin[k].shape) == tuple(jin[k].shape), (k, shape)
            assert tin[k].dtype == _dtype(jin[k].dtype), (k, shape)
        if shape.kind != "decode":
            continue
        # repro's cache_specs, as its decode cell holds them
        jc = _jcell(name, shape.name, "16x16").args[2]
        tc = tspecs.cache_specs(cfg, shape)
        assert len(tc) == cfg.n_layers
        for i, entry in enumerate(tc):
            node, stacked = _jcache_node(jc, i, cfg)
            assert set(entry) == set(node), (i, sorted(entry))
            for n, t in entry.items():
                want = tuple(node[n].shape)[1:] if stacked else \
                    tuple(node[n].shape)
                assert tuple(t.shape) == want, (shape.name, i, n)
                assert t.dtype == _dtype(node[n].dtype), (i, n)
        for mesh in PROD.values():
            jspec = jsh.cache_pspecs(jc, mesh, shape.global_batch)
            tspec = sh.cache_pspecs(tc, mesh, shape.global_batch)
            for i, entry in enumerate(tspec):
                node, stacked = _jcache_node(jspec, i, cfg)
                for n, s in entry.items():
                    want = tuple(node[n])
                    if stacked and want[0] is not None:
                        # repro finds the batch by size: its layer dim
                        # holds it where n_groups equals the batch
                        assert cfg.n_groups == shape.global_batch
                        want = (want[0],) + (None,) * (len(s) - 1)
                    elif stacked:
                        want = want[1:]
                    assert s == want, (shape.name, i, n, s, want)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_serve_cells_equal_repros(name):
    cfg = get_arch(name)
    for shape in SERVE_SHAPES:
        if shape not in shapes_for(cfg):
            continue
        for mname, mesh in PROD.items():
            jcell = _jcell(name, shape.name, mname)
            cell = tspecs.serve_cell(name, shape, mesh)
            assert cell.arch.moe_dispatch_groups == \
                jcell.arch.moe_dispatch_groups
            p_specs = cell.in_specs[0]
            jp = jcell.in_shardings[0]
            for pname, s in p_specs.items():
                node, stacked = _param_node(jp, pname, cfg)
                want = tuple(node)
                assert s == (want[1:] if stacked else want), (pname, s, want)
            if shape.kind == "prefill":
                jb = jcell.in_shardings[1]
                assert cell.in_specs[1] == {k: tuple(v)
                                            for k, v in jb.items()}
                assert cell.out_specs == tuple(jcell.out_shardings)
                continue
            assert cell.in_specs[1] == tuple(jcell.in_shardings[1])
            assert cell.in_specs[3] == tuple(jcell.in_shardings[3]) == ()
            assert cell.out_specs[0] == tuple(jcell.out_shardings[0])
            for i, entry in enumerate(cell.in_specs[2]):
                node, stacked = _jcache_node(jcell.in_shardings[2], i, cfg)
                for n, s in entry.items():
                    want = tuple(node[n])
                    assert s == (want[1:] if stacked else want), (i, n)
                onode, _ = _jcache_node(jcell.out_shardings[1], i, cfg)
                assert {n: tuple(v) for n, v in onode.items()} == \
                    {n: tuple(v) for n, v in node.items()}
            assert cell.out_specs[1] == cell.in_specs[2]


def _param_node(tree, name, cfg):
    """``repro``'s parameter node of the port's leaf ``name`` and whether
    it is stacked (``params_from_jax``'s map)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        node, stacked = _jcache_node(tree, int(parts[1]), cfg)
        rest = parts[2:]
    elif parts[0] == "encoder" and parts[1] == "blocks":
        node, stacked, rest = tree["encoder"]["body"], True, parts[3:]
    else:
        node, stacked, rest = tree, False, parts
    for key in rest:
        node = node[key]
    return node, stacked


@pytest.mark.parametrize("mesh", sorted(PROD))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_layout_on_production_meshes(name, mesh):
    """Each rank's cache share divides at the production meshes: its
    rows by the DP rule, its KV heads or RG-LRU channels where the block
    runs tensor-parallel (by ``tp_plan``: at tp 16 only whisper's 16/16
    heads split), and it holds no more than ``repro``'s cache_pspecs give
    it."""
    from repro_torch.distributed.tensor_parallel import tp_plan
    m = PROD[mesh]
    cfg = get_arch(name)
    plan = tp_plan(cfg, 16)
    for batch in (128, 1):
        lay = sh.cache_layout(cfg, m, batch, 64, torch.bfloat16)
        held, implied = sh.cache_bytes(lay, m)
        assert 0 < held <= implied
        for (kind, _), entry in zip(cfg.layer_specs(), lay):
            for n, leaf in entry.items():
                local = sh.local_shape(leaf.shape, leaf.layout, m)
                assert local[0] == (batch // sh.dp_size(m)
                                    if batch >= sh.dp_size(m) else batch)
                split = "model" in sh.spec_axes(leaf.layout)
                assert split == ((n in ("k", "v", "xk", "xv") and plan.attn)
                                 or (kind == "rec" and plan.rg)), (kind, n)
