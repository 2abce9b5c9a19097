"""Attention: the port's twins against ``repro``'s Pallas kernels
(interpret mode) and oracles on the CPU, the dispatch rule, and (on a
Hopper card only) the CUDA kernels against their twins.

Inputs are seeded numpy arrays in the port's layouts (q [B,S,H,dh], k,v
[B,S,KH,dh]; the cache [B,L,KH,dh]), transposed to ``repro``'s Pallas
layouts ([B,H,S,dh], [B,KH,L,dh]) at the test boundary.  Tolerance: rtol
= atol = 2e-5, the bound ``repro`` holds its Pallas attention kernels to
in float32 (``tests/test_kernels.py``).  The Pallas kernels assert that S
and L are multiples of their block, so ragged S and L are checked against
``repro``'s oracles and its XLA layers instead.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import layers

TOL = dict(rtol=2e-5, atol=2e-5)
# (B, H, KH, S, dh): the sets of repro's tests/test_kernels.py, and
# recurrentgemma-2b's heads (10 query heads over 1 kv head, dh 256)
FLASH_SHAPES = [(1, 2, 1, 64, 32), (2, 4, 2, 128, 64), (1, 8, 8, 64, 16),
                (2, 6, 2, 96, 32), (1, 10, 1, 64, 256)]
MASKS = [(True, None), (False, None), (True, 32)]
DECODE_SHAPES = [(1, 2, 1, 128, 32), (2, 4, 2, 256, 64), (2, 8, 8, 64, 16),
                 (1, 10, 1, 128, 256)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's side: its CPU work here is small,
    and the test runner runs several workers at once, each of whose
    thread pools would otherwise oversubscribe the cores (as
    ``tests/test_torch_bf16_train.py`` does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import layers as JL
    return jnp, jops, jref, JL


@pytest.fixture
def hopper():
    """Skip unless an sm_90 card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


def _qkv(B, H, KH, S, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, dh)).astype(np.float32),
            rng.standard_normal((B, S, KH, dh)).astype(np.float32),
            rng.standard_normal((B, S, KH, dh)).astype(np.float32))


def _heads_first(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# ------------------------------------------------------------ flash twin
@pytest.mark.parametrize("B,H,KH,S,dh", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_twin_matches_pallas_and_oracle(jax_side, B, H, KH, S, dh,
                                              causal, window):
    jnp, jops, jref, _ = jax_side
    q, k, v = _qkv(B, H, KH, S, dh)
    got = ref.flash_attention_ref(*_t(q, k, v), causal=causal,
                                  window=window).numpy()
    jq, jk, jv = (jnp.asarray(_heads_first(x)) for x in (q, k, v))
    pallas = jops.flash_attention_op(jq, jk, jv, causal=causal,
                                     window=window, block_q=32, block_k=32)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, _heads_first(np.asarray(want)),
                                   **TOL)


@pytest.mark.parametrize("S", [1, 37, 100])
@pytest.mark.parametrize("causal,window", MASKS + [(False, 7)])
def test_flash_twin_at_ragged_s(jax_side, S, causal, window):
    """Any S: against repro's oracle and its XLA chunked attention."""
    jnp, _, jref, JL = jax_side
    q, k, v = _qkv(2, 6, 2, S, 32, seed=S)
    got = ref.flash_attention_ref(*_t(q, k, v), causal=causal,
                                  window=window).numpy()
    oracle = jref.flash_attention_ref(
        *(jnp.asarray(_heads_first(x)) for x in (q, k, v)), causal=causal,
        window=window)
    np.testing.assert_allclose(got, _heads_first(np.asarray(oracle)), **TOL)
    chunked = JL.chunked_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal=causal, window=window, chunk=16)
    np.testing.assert_allclose(got, np.asarray(chunked), **TOL)


# ------------------------------------------------- flash at Skv != S
# (B, H, KH, S, Skv, dh): cross attention, non-causal, B >= 2 so a wrong
# batch-row stride of k / v shows; Skv % 64 of 0, 1 and 28 (a ragged last
# key tile of 64, 1 or 28 keys) and Skv below one tile, at every head dim
# the kernels take below 256; llama-3.2-vision-11b's 1601 memory rows
# (G 4, dh 128) and whisper-medium's 1500 (G 1, dh 64) at the serve prompt
CROSS = [(2, 8, 2, 32, 128, 16), (2, 8, 2, 32, 65, 32), (3, 4, 4, 9, 92, 64),
         (2, 4, 1, 70, 37, 128), (2, 6, 3, 5, 1, 64), (2, 8, 2, 70, 192, 128),
         (2, 8, 2, 32, 1601, 128), (2, 4, 4, 24, 1500, 64)]


def _qkv_cross(B, H, KH, S, Skv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, dh)).astype(np.float32),
            rng.standard_normal((B, Skv, KH, dh)).astype(np.float32),
            rng.standard_normal((B, Skv, KH, dh)).astype(np.float32))


@pytest.mark.parametrize("B,H,KH,S,Skv,dh", CROSS)
def test_flash_twin_cross_matches_chunked_attention(jax_side, B, H, KH, S,
                                                    Skv, dh):
    """The twin (and the CPU dispatch) at Skv != S against repro's
    ``layers.chunked_attention`` -- the cross attention's own path in
    repro -- and the port's."""
    jnp, _, _, JL = jax_side
    q, k, v = _qkv_cross(B, H, KH, S, Skv, dh, seed=Skv)
    got = ref.flash_attention_ref(*_t(q, k, v), causal=False).numpy()
    want = JL.chunked_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                causal=False, window=None)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    mine = layers.chunked_attention(*_t(q, k, v), causal=False)
    np.testing.assert_allclose(got, mine.numpy(), **TOL)
    assert torch.equal(fa.flash_attention(*_t(q, k, v), causal=False),
                       torch.from_numpy(got))


@pytest.mark.parametrize("causal,window,dh,err", [
    (True, None, 64, ValueError), (False, 8, 64, ValueError),
    (True, 8, 16, ValueError), (False, None, 256, NotImplementedError)])
def test_flash_rejects_what_cross_attention_does_not_take(causal, window, dh,
                                                          err):
    """Skv != S only non-causal without a window (repro defines no causal
    alignment of two lengths), and not at dh 256; Skv == S takes all."""
    q, k, v = _t(*_qkv_cross(2, 4, 2, 16, 40, dh))
    with pytest.raises(err):
        fa.flash_attention(q, k, v, causal=causal, window=window)
    with pytest.raises(err):
        fa.check_lengths(16, 40, dh, causal, window)
    fa.check_lengths(40, 40, dh, causal, window)


# the edges of the dh-256 kernel's tiles (64 query rows, 8 a warp; 32-key
# stages): a single position, recurrentgemma-2b's serve prefill, one row
# past a tile, a ragged last tile, a window narrower than a thread's keys
# (kx + 8j spans 25), one sequence's long prefill, a non-causal prompt
RG_EDGES = [(1, 10, 1, 1, 256, True, 2048), (4, 10, 1, 32, 256, True, 2048),
            (1, 10, 1, 65, 256, True, 2048), (1, 10, 1, 2047, 256, True, 2048),
            (2, 10, 1, 300, 256, True, 5), (1, 10, 1, 2048, 256, True, 2048),
            (1, 10, 1, 300, 256, False, None)]


@pytest.mark.parametrize("B,H,KH,S,dh,causal,window", [
    (1, 12, 4, 100, 64, True, None), (1, 4, 4, 65, 64, False, None),
    (2, 12, 4, 70, 64, True, 7), (1, 6, 2, 90, 128, True, None),
    (1, 12, 4, 1, 64, True, None), (1, 4, 2, 66, 128, False, 9)] + RG_EDGES)
def test_flash_twin_at_tile_edges(jax_side, B, H, KH, S, dh, causal, window):
    """The tile edges of the dh 64 / 128 kernel (ragged last tile, G = 1 or
    3, a window narrower than 8 keys, S = 1) and of the dh-256 kernel
    (RG_EDGES): the twin, which the card-only test holds the kernel to,
    against repro's oracle."""
    jnp, _, jref, _ = jax_side
    q, k, v = _qkv(B, H, KH, S, dh, seed=S)
    got = ref.flash_attention_ref(*_t(q, k, v), causal=causal,
                                  window=window).numpy()
    oracle = jref.flash_attention_ref(
        *(jnp.asarray(_heads_first(x)) for x in (q, k, v)), causal=causal,
        window=window)
    np.testing.assert_allclose(got, _heads_first(np.asarray(oracle)), **TOL)


# (S, causal, window, wide): recurrentgemma-2b's serve prompt and long
# prefill, the card tests' dh-256 edges, and the tile's edge (255 / 256
# keys; a causal window's span is window + 63)
WIDE_RULE = [(32, True, 2048, False), (2048, True, 2048, True),
             (1, True, 2048, False), (65, True, 2048, False),
             (2047, True, 2048, True), (300, True, 5, False),
             (300, False, None, True), (1037, True, 300, True),
             (255, True, None, False), (256, True, None, True),
             (300, False, 5, True), (2048, True, 192, False),
             (2048, True, 193, True)]


@pytest.mark.parametrize("S,causal,window,wide", WIDE_RULE)
def test_flash_wide_rule(S, causal, window, wide):
    """dh 256 runs the wide kernel where a block of 64 query rows can see
    a whole 256-key tile, the narrow one below that."""
    assert fa.wide_tiles(S, causal, window) is wide


def test_flash_tiles_mirror_the_kernel():
    """The launcher's BQ and WIDE_KEYS are the source's kBQ and kWideBK,
    att_flash runs the narrow kernel at dh 256 and att_flash_wide the
    wide one, and both entries are bound."""
    src = (build.CSRC / "attention.cu").read_text()
    for line in ("constexpr int kBQ = 64;", "constexpr int kWideBK = 256;",
                 "case 256: return launch_flash_narrow(",
                 "return launch_flash_wide(q, k, v, o, B, S, H, KH, causal,"):
        assert line in src, line
    assert (fa.BQ, fa.WIDE_KEYS) == (64, 256)
    assert {"att_flash", "att_flash_wide"} <= set(
        build.SIGNATURES["attention"])


def _count_calls(monkeypatch, name):
    """Count the calls of the twin ``ref.<name>`` (it still runs)."""
    calls, twin = [], getattr(ref, name)
    monkeypatch.setattr(ref, name,
                        lambda *a, **kw: calls.append(1) or twin(*a, **kw))
    return calls


def test_flash_dispatch_runs_the_twin_on_the_cpu(monkeypatch):
    q, k, v = _t(*_qkv(1, 4, 2, 20, 16))
    want = ref.flash_attention_ref(q, k, v, causal=True, window=5)
    calls = _count_calls(monkeypatch, "flash_attention_ref")
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, causal=True, window=5)
    assert torch.equal(got, want)
    assert fa.LAUNCHES == {"flash_attention": 0}
    assert len(calls) == 1
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k, v)             # no kernel for the CPU


# ----------------------------------------------------------- decode twin
def _cache(B, H, KH, L, dh, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, dh)).astype(np.float32),
            rng.standard_normal((B, L, KH, dh)).astype(np.float32),
            rng.standard_normal((B, L, KH, dh)).astype(np.float32))


@pytest.mark.parametrize("B,H,KH,L,dh", DECODE_SHAPES)
@pytest.mark.parametrize("frac", [0.25, 1.0])
def test_decode_twin_matches_pallas_oracle_and_layer(jax_side, B, H, KH, L,
                                                     dh, frac):
    jnp, jops, jref, JL = jax_side
    q, k, v = _cache(B, H, KH, L, dh)
    n = max(1, int(L * frac))
    got = ref.decode_attention_ref(*_t(q, k, v), n).numpy()
    jk, jv = jnp.asarray(_heads_first(k)), jnp.asarray(_heads_first(v))
    pallas = jops.decode_attention_op(jnp.asarray(q), jk, jv,
                                      jnp.asarray(n), block_k=32)
    oracle = jref.decode_attention_ref(jnp.asarray(q), jk, jv, n)
    layer = JL.decode_attention(jnp.asarray(q[:, None]), jnp.asarray(k),
                                jnp.asarray(v), n)[:, 0]
    for want in (pallas, oracle, layer):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("L,n", [(100, 100), (100, 37), (48, 33), (1, 1)])
@pytest.mark.parametrize("window", [None, 8])
def test_decode_layer_at_any_length(jax_side, L, n, window):
    """A cache length that is no multiple of any block, with and without a
    window: the port's layer against repro's layer and oracle."""
    jnp, _, jref, JL = jax_side
    q, k, v = _cache(3, 6, 2, L, 32, seed=L + n)
    got = layers.decode_attention(*_t(q[:, None], k, v), n, window=window)
    want = JL.decode_attention(jnp.asarray(q[:, None]), jnp.asarray(k),
                               jnp.asarray(v), n, window=window)
    assert tuple(got.shape) == (3, 1, 6, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if window is None:
        oracle = jref.decode_attention_ref(
            jnp.asarray(q), jnp.asarray(_heads_first(k)),
            jnp.asarray(_heads_first(v)), n)
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(oracle),
                                   **TOL)


def test_decode_dispatch_runs_the_twin_on_the_cpu(monkeypatch):
    q, k, v = _t(*_cache(2, 4, 2, 40, 16))
    want = ref.decode_attention_ref(q, k, v, 17)
    calls = _count_calls(monkeypatch, "decode_attention_ref")
    da.reset_launches()
    got = da.decode_attention(q, k, v, 17)
    assert torch.equal(got, want)
    assert da.LAUNCHES == {"decode_attention": 0}
    assert len(calls) == 1
    with pytest.raises(ValueError):
        da.decode_attention_cuda(q, k, v, 17)
    for bad in (0, 41):                          # outside [1, L]
        with pytest.raises(ValueError):
            da.decode_attention(q, k, v, bad)


# (n valid positions, blocks per split B * KH * head groups, resident
# blocks per SM, step): the earlier six shapes, then recurrentgemma-2b's
# long serve (B=4, KH=1, two head groups at dh 256: the ring full and half
# full), its serve default (cache_len 33) and flaas-100m's long serve (B=8,
# KH=4, dh 64, cache_len 2080), each at residency 1 and 2
SPLIT_CASES = [(1, 16, 3, 64), (33, 16, 3, 64), (32768, 32, 3, 64),
               (20000, 32, 3, 64), (5000, 1, 2, 32), (2049, 4, 1, 256)] + [
    (n, blocks, r, step) for n, blocks, step in
    [(2048, 8, 16), (1000, 8, 16), (33, 8, 16), (2080, 32, 64)]
    for r in (1, 2)]


@pytest.mark.parametrize("n,blocks,residency,step", SPLIT_CASES)
def test_decode_splits_cover_the_valid_range(n, blocks, residency, step):
    split = da.split_size(n, blocks, residency, step)
    nsplit = -(-n // split)
    assert split % step == 0 and split >= step
    assert (nsplit - 1) * split < n <= nsplit * split     # no empty split
    assert nsplit <= da.NSPLIT_MAX
    # the grid reaches the residency * SMS slots wherever n allows it, in
    # one wave: no more blocks than the slots, within one split's blocks of
    # them, unless the cap, the splits' whole steps or n itself stop it
    slots = residency * da.SMS
    want = max(1, min(da.NSPLIT_MAX, slots // blocks))
    assert nsplit <= want and (nsplit == 1 or nsplit * blocks <= slots)
    assert split == step or -(-n // (split - step)) > want
    if nsplit == want:
        assert nsplit * blocks > min(slots, da.NSPLIT_MAX * blocks) - blocks


# (n, blocks per split, residency, step, nsplit): the grids of the serve
# shapes (recurrentgemma-2b's dh 256 kernel holds two blocks an SM, so
# 256 of 264 at 2048 positions; flaas-100m's dh 64 kernel three, so 384
# of 396 at 32768), and a 4096-position cache at the cap
@pytest.mark.parametrize("n,blocks,residency,step,nsplit", [
    (2048, 8, 2, 16, 32), (1000, 8, 2, 16, 32), (33, 8, 2, 16, 3),
    (47, 8, 2, 16, 3), (2080, 32, 3, 64, 11), (32768, 32, 3, 64, 12),
    (4096, 2, 2, 16, 64)])
def test_decode_grids_at_the_serve_shapes(n, blocks, residency, step,
                                          nsplit):
    assert -(-n // da.split_size(n, blocks, residency, step)) == nsplit


@pytest.mark.parametrize("dh", sorted(da.GROUPS))
def test_decode_step_table_mirrors_the_kernel(dh):
    """The launcher's STEPS equal the kernel's DecodeMap STEP = NGR * U,
    and its HEAD_GROUPS, keyed by (dh, G), the kernel's
    decode_head_groups<DH, G>, from the same formulas as the source's;
    the head groups split every G evenly, and a block's GB = G / head
    groups heads keep q in registers (GB x VEC <= 32) and their merge
    arrays within 48 KB, except recurrentgemma-2b's dh-256 block, whose q
    is in shared memory."""
    src = (build.CSRC / "attention.cu").read_text()
    for line in ("constexpr int kThreads = 256;",
                 "VEC = DH > 128 ? 8 : 4;", "LG = DH / VEC;",
                 "NGR = kThreads / LG;", "U = VEC == 8 ? 2 : 4;",
                 "STEP = NGR * U;", "return DH > 128 || G > 8 ? 2 : 1;",
                 "return G / decode_head_groups<DH, G>() * DecodeMap<DH>::VEC"
                 " > 32;"):
        assert line in src, line
    vec = 8 if dh > 128 else 4
    ngr = 256 // (dh // vec)
    assert da.STEPS[dh] == ngr * (2 if vec == 8 else 4)
    for G in da.GROUPS[dh]:
        hg = da.HEAD_GROUPS[dh, G]
        assert hg == (2 if dh > 128 or G > 8 else 1)
        assert G % hg == 0
        gb = G // hg
        q_shared = gb * vec > 32
        assert q_shared == (dh == 256)
        smem = ((gb * dh if q_shared else 0) + ngr * gb * (dh + 2)) * 4
        assert smem <= 48 * 1024, (dh, G, smem)
    assert set(da.STEPS) == {d for d, _ in da.HEAD_GROUPS} == set(da.GROUPS)
    assert len(da.HEAD_GROUPS) == sum(len(g) for g in da.GROUPS.values())


def test_decode_groups_cover_the_dense_family():
    """Every dense config's H/KH at dh 128 has an instantiation: 8 (qwen2.5-
    3b), 5 (qwen2.5-32b), 12 (both starcoder2), the last in two head
    groups."""
    from repro_torch.configs import get_arch
    want = {"qwen2.5-3b": 8, "qwen2.5-32b": 5, "starcoder2-3b": 12,
            "starcoder2-15b": 12}
    for name, G in want.items():
        cfg = get_arch(name)
        assert (cfg.dh, cfg.n_heads // cfg.kv_heads) == (128, G)
        assert G in da.GROUPS[128]
    assert da.HEAD_GROUPS[128, 12] == 2 and da.HEAD_GROUPS[128, 5] == 1


def test_decode_valid_range():
    assert da.valid_range(48, 48, None) == (0, 48)
    assert da.valid_range(33, 48, 8) == (25, 33)     # k > 33 - 1 - 8
    assert da.valid_range(5, 48, 8) == (0, 5)
    with pytest.raises(ValueError):
        da.valid_range(5, 48, 0)


# ------------------------------------------------------------ on the card
# (B, H, KH, S, dh, causal, window): the serve default (ragged against a
# 64-row tile), GQA at flaas-100m's heads, a ragged sliding window, a
# non-causal prompt, a small head dim; recurrentgemma-2b's heads (10/1,
# dh 256) at its prefill (S 2048, window 2048) and a ragged S
CARD_FLASH = [(4, 12, 4, 32, 64, True, None), (2, 12, 4, 1000, 64, True, 256),
              (1, 12, 4, 512, 64, False, None), (2, 4, 2, 130, 32, True, 17),
              (1, 8, 8, 65, 16, False, 9), (1, 2, 1, 70, 128, True, None),
              (4, 10, 1, 2048, 256, True, 2048),
              (2, 10, 1, 1037, 256, True, 300)] + [
    # the edges of the dh 64 / 128 template's 4 x 8 tile: a ragged last
    # tile, one query head per kv head past one tile, a window narrower
    # than a thread's 8 keys, G = 3 at dh 128, a single position; then the
    # dh-256 kernel's edges (RG_EDGES)
    (1, 12, 4, 1000, 64, True, None), (1, 4, 4, 65, 64, False, None),
    (2, 12, 4, 300, 64, True, 7), (1, 6, 2, 200, 128, True, None),
    (1, 12, 4, 1, 64, True, None)] + RG_EDGES
# (B, H, KH, L, dh, cache_len, window); at dh 256 the local ring (2048
# slots, full and partly filled) and a ragged cache
CARD_DECODE = [(4, 12, 4, 48, 64, 33, None), (4, 12, 4, 48, 64, 48, None),
               (8, 12, 4, 4100, 64, 4100, None), (2, 12, 4, 3000, 64, 2999, 100),
               (1, 8, 1, 700, 16, 513, None), (2, 16, 2, 300, 128, 300, None),
               (3, 6, 3, 257, 32, 1, None),
               (4, 10, 1, 2048, 256, 2048, None),
               (4, 10, 1, 2048, 256, 1000, None),
               (3, 10, 1, 1037, 256, 1037, None)] + [
    # the split edges at dh 256: exactly one 16-position step, one
    # past it, a window whose lo falls inside a split, B=1 over 4096
    # positions (64 splits, the cap); flaas-100m's long serve (2080 of
    # 2112 slots)
    (4, 10, 1, 48, 256, 16, None), (4, 10, 1, 48, 256, 17, None),
    (4, 10, 1, 2048, 256, 1500, 695), (1, 10, 1, 4096, 256, 4096, None),
    (8, 12, 4, 2112, 64, 2080, None)] + [
    # the dense family's heads at dh 128: qwen2.5-32b (40 over 8, G 5),
    # starcoder2-3b (24 over 2) and starcoder2-15b (48 over 4; G 12, two
    # head groups), at the serve defaults' cache (B=4, 48 slots, 33 and 47
    # valid) and the long serve's (B=4, 2112 slots, 2080 and 1000 valid)
    (4, H, KH, L, 128, n, None) for H, KH in ((40, 8), (24, 2), (48, 4))
    for L, n in ((48, 33), (48, 47), (2112, 2080), (2112, 1000))] + [
    # cross attention's decode: every row of the memory, llama-3.2-vision-
    # 11b's 1601 (32 over 8 heads, dh 128) and whisper-medium's 1500 (16
    # over 16, dh 64)
    (4, 32, 8, 1601, 128, 1601, None), (4, 16, 16, 1500, 64, 1500, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,S,dh,causal,window", CARD_FLASH)
def test_cuda_flash_matches_twin(hopper, B, H, KH, S, dh, causal, window):
    q, k, v = (x.to(hopper) for x in _t(*_qkv(B, H, KH, S, dh, seed=S)))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)                   # bitwise stable
    assert fa.LAUNCHES == {"flash_attention": 2}
    wide = dh == 256 and fa.wide_tiles(S, causal, window)
    assert fa.LAST_ENTRY["flash_attention"] == (
        "att_flash_wide" if wide else "att_flash")


# (B, H, KH, S, Skv, dh): cross attention on the card, the CPU cases
# (CROSS) and the serve shapes: llama-3.2-vision-11b (32 over 8 heads,
# dh 128) at the serve prompt and a 2048-token prompt against 1601 memory
# rows; whisper-medium's (16 over 16, dh 64) at the serve prompt and a
# 384-token prompt against 1500 frames
CARD_CROSS = CROSS + [(4, 32, 8, 32, 1601, 128), (4, 32, 8, 2048, 1601, 128),
                      (4, 16, 16, 32, 1500, 64), (4, 16, 16, 384, 1500, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,S,Skv,dh", CARD_CROSS)
def test_cuda_flash_cross_matches_twin(hopper, B, H, KH, S, Skv, dh):
    q, k, v = (x.to(hopper) for x in
               _t(*_qkv_cross(B, H, KH, S, Skv, dh, seed=Skv)))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, causal=False)
    again = fa.flash_attention_cuda(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)
    assert fa.LAUNCHES == {"flash_attention": 2}
    assert fa.LAST_ENTRY["flash_attention"] == "att_flash"


@pytest.mark.cuda
def test_cuda_flash_cross_refusals(hopper):
    """The launcher refuses causal, windowed and dh-256 Skv != S, and so
    does the C entry when called past the launcher's checks."""
    q, k, v = (x.to(hopper) for x in _t(*_qkv_cross(2, 4, 2, 16, 40, 64)))
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k, v, causal=True)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k, v, causal=False, window=8)
    with pytest.raises(RuntimeError):
        fa._att_flash("att_flash", q, k, v, True, None)
    q, k, v = (x.to(hopper) for x in _t(*_qkv_cross(2, 4, 2, 16, 40, 256)))
    with pytest.raises(NotImplementedError):
        fa.flash_attention_cuda(q, k, v, causal=False)
    for entry in ("att_flash", "att_flash_wide"):
        with pytest.raises(RuntimeError):
            fa._att_flash(entry, q, k, v, False, None)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["att_flash", "att_flash_wide"])
@pytest.mark.parametrize("B,H,KH,S,dh,causal,window",
                         [c for c in CARD_FLASH if c[4] == 256])
def test_cuda_dh256_kernels_match_twin(hopper, entry, B, H, KH, S, dh,
                                       causal, window):
    """Both dh-256 kernels at every dh-256 card shape, whichever the
    launcher's rule would pick there."""
    q, k, v = (x.to(hopper) for x in _t(*_qkv(B, H, KH, S, dh, seed=S)))
    got = fa._att_flash(entry, q, k, v, causal, window)
    again = fa._att_flash(entry, q, k, v, causal, window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,L,dh,n,window", CARD_DECODE)
def test_cuda_decode_matches_twin(hopper, B, H, KH, L, dh, n, window):
    q, k, v = (x.to(hopper) for x in _t(*_cache(B, H, KH, L, dh, seed=L)))
    da.reset_launches()
    got = da.decode_attention(q, k, v, n, window=window)
    again = da.decode_attention_cuda(q, k, v, n, window=window)
    want = ref.decode_attention_ref(q, k, v, n, window=window)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)
    assert da.LAUNCHES == {"decode_attention": 2}
    lo, hi = da.valid_range(n, L, window)
    res = da.resident_blocks(dh, H // KH)
    per_split = B * KH * da.HEAD_GROUPS[dh, H // KH]
    split = da.split_size(hi - lo, per_split, res, da.STEPS[dh])
    nsplit = -(-(hi - lo) // split)
    assert da.LAST_GRID["decode_attention"] == (split, nsplit,
                                                nsplit * per_split, res)


@pytest.mark.cuda
def test_cuda_launchers_reject_what_the_kernels_do_not_take(hopper):
    q, k, v = (x.to(hopper) for x in _t(*_qkv(1, 4, 2, 16, 32)))
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.double(), k, v)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q.transpose(1, 2), k, v)  # not contiguous
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k.cpu(), v)           # mixed devices
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q[..., :24].contiguous(), k[..., :24]
                                .contiguous(), v[..., :24].contiguous())
    q64, k64, v64 = (x.to(hopper) for x in _t(*_qkv(1, 4, 2, 16, 64)))
    shifted = torch.empty(q64.numel() + 1, device=hopper)[1:].view(q64.shape)
    shifted.copy_(q64)                       # contiguous, 4 bytes off the grid
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(shifted, k64, v64)
    with pytest.raises(RuntimeError):                    # the wide kernel:
        fa._att_flash("att_flash_wide", q64, k64, v64, True, None)  # dh 256
    qd, kc, vc = (x.to(hopper) for x in _t(*_cache(1, 10, 2, 16, 32)))
    with pytest.raises(ValueError):
        da.decode_attention_cuda(qd, kc, vc, 8)          # 5 heads per kv head
    qd, kc, vc = (x.to(hopper) for x in _t(*_cache(1, 8, 1, 16, 256)))
    with pytest.raises(ValueError):
        da.decode_attention_cuda(qd, kc, vc, 8)          # dh 256: G 10 only
    qd, kc, vc = (x.to(hopper) for x in _t(*_cache(1, 4, 2, 16, 32)))
    with pytest.raises(ValueError):
        da.decode_attention_cuda(qd, kc, vc, 17)         # past the cache
