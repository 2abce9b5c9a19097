"""Launchers of the Hopper budget kernels (``csrc/budget_alloc.cu``).

Each launcher takes the tensors of one call, all on one CUDA device, and
checks dtype (float32, selections and masks int32), shape and contiguity;
it allocates the outputs with ``torch.empty``, launches the kernel on
``torch.cuda.current_stream()``, raises if the C call returns a nonzero
``cudaError_t``, and adds one to its entry of :data:`LAUNCHES`.  Anything
else raises: there is no fallback.  :mod:`repro_torch.core.hotpath` sends
CPU tensors to the plain twins instead.

:func:`matvec`, :func:`matvec_t` and :func:`dual_ascent` also take a
fleet of E same-shape episodes stacked on a leading axis (``repro``'s
``run_fleet(mode="vmap")``), in one launch, each episode's result bitwise
a lone launch's on its operands; :func:`rowmax` and the boost sweeps take
a fleet folded into their row axis.

Card figures quoted below are the H100 SXM's published peaks: 3.35 TB/s
of HBM bandwidth and 67 TFLOP/s of float32 outside the tensor cores.
"""
from __future__ import annotations

import torch

from .build import library

# Kernel launches per launcher since the last reset_launches().
LAUNCHES = {"rowmax": 0, "matvec": 0, "matvec_t": 0, "dual_step": 0,
            "boost_scan": 0, "swap_eval": 0}
# Geometry of the last launch: "rowmax" and "matvec" (cs, M), blocks per
# row's cluster and rows; "swap_eval" (analysts, candidates);
# "boost_sweep" (cs, T, blocks) of the last boost_scan or swap_eval.
LAST_GRID: dict[str, tuple[int, ...]] = {}

# row_split's constants: the portable cluster size limit, the fewest
# floats a block of a split row reads (8 KB), and the grid it aims for
# (two blocks on each of the H100's 132 SMs).
ROW_SPLIT_MAX = 8
ROW_SPLIT_MIN_CHUNK = 2048
ROW_SPLIT_BLOCKS = 264
# dual_split's least stripe of columns a block of the dual cluster keeps.
DUAL_MIN_STRIPE = 128
# The boost sweep (csrc kSweepTileMax, kSweepSmemMax): candidates a tile,
# and the dynamic shared memory a block may take with its leftover
# stripes in it (past it they stay in device memory).  sweep_split aims a
# block at SWEEP_SMEM_TARGET, so three of them fit in an SM's 228 KB: the
# sweep waits on each visit's reductions, and more warps on the same
# resident leftover hide more of that wait (PERF.md, the boost sweep).
SWEEP_TILE_MAX = 8
SWEEP_SMEM_MAX = 200 * 1024
SWEEP_SMEM_TARGET = 72 * 1024


def _lib():
    return library("budget_alloc")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAST_GRID.clear()


def _on_cuda(*ts: torch.Tensor) -> None:
    """Raise unless every tensor is on one CUDA device."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"kernel operands span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type != "cuda":
        raise ValueError(f"no Hopper kernel for device {dev}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed with cudaError_t {err}")


_F32, _I32 = torch.float32, torch.int32


def row_split(M: int, K: int) -> int:
    """Blocks per row (the cluster size cs) for :func:`rowmax` and
    :func:`matvec` on an [M, K] matrix.

    cs starts at 1 and doubles while all three hold: cs < ROW_SPLIT_MAX
    (8, the portable cluster size), cs * M < ROW_SPLIT_BLOCKS (264, two
    blocks per SM: a grid that large fills the card without a split), and
    K >= 2 * cs * ROW_SPLIT_MIN_CHUNK (each of the 2 * cs chunks would
    still hold 2048 floats, 8 KB).  So cs = 1 wherever K < 4096 or
    M >= 264.  The kernel cuts a row on its own 16-byte grid, so a
    chunk may hold up to 4 floats fewer than K / cs."""
    cs = 1
    while (cs < ROW_SPLIT_MAX and cs * M < ROW_SPLIT_BLOCKS
           and K >= 2 * cs * ROW_SPLIT_MIN_CHUNK):
        cs *= 2
    return cs


def _fleet(t: torch.Tensor, rank: int) -> int:
    """Episodes of a launch whose one-episode operand ``t`` has ``rank``
    dims: 1 without a leading fleet axis, else its length."""
    if t.dim() == rank:
        return 1
    if t.dim() != rank + 1:
        raise ValueError(f"expected {rank} dims or a leading fleet axis, "
                         f"got shape {tuple(t.shape)}")
    return t.shape[0]


def rowmax(gamma: torch.Tensor) -> torch.Tensor:
    """mu_i = max_k gamma_ik.  [M, K] -> [M].

    Replaces ``repro/kernels/budget_alloc.py:rowmax``.  Bound on the card:
    bytes (reads M*K*4 once; one compare per element).  Design: each row
    is split over a thread-block cluster of ``cs = row_split(M, K)``
    blocks of 256 threads, one launch of cs * M blocks; a block reads its
    contiguous chunk with 16-byte loads, four in flight a thread, reduces
    it by warp shuffle and shared memory, and stores its maximum into the
    cluster's block 0 (distributed shared memory), which combines the cs
    of them after one cluster barrier.  Order-free, so bitwise equal to
    the twin."""
    _on_cuda(gamma)
    M, K = gamma.shape
    _check(gamma, "gamma", _F32, (M, K))
    out = torch.empty(M, dtype=_F32, device=gamma.device)
    cs = row_split(M, K)
    _raise_on(_lib().ba_rowmax(gamma.data_ptr(), out.data_ptr(), M, K, cs,
                               _stream(gamma)), "ba_rowmax")
    LAUNCHES["rowmax"] += 1
    LAST_GRID["rowmax"] = (cs, M)
    return out


def matvec(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y_i = sum_k c_ik v_k.  [M, K] x [K] -> [M], or a fleet's [E, M, K]
    x [E, K] -> [E, M] in one launch.

    Replaces ``repro/kernels/budget_alloc.py:matvec``.  Bound: bytes (c
    read once, 2 flops per 4 bytes; v is shared by the rows and stays in
    L2).  Design: :func:`rowmax`'s clusters of ``cs = row_split(M, K)``
    blocks per row; an FMA chain per thread over its 16-byte loads (eight
    in flight a thread), warp and block tree sums, and the cs partials
    added in rank order by the cluster's block 0.  Within 1e-5 relative
    of the twin, and bitwise from launch to launch.  A fleet's E * M rows
    run on E * M clusters of one episode's ``row_split(M, K)`` blocks, row
    r reading episode r // M's v; each row is cut on its episode's own
    16-byte grid, so an episode's y is bitwise a lone launch's."""
    _on_cuda(c, v)
    E = _fleet(c, 2)
    M, K = c.shape[-2:]
    lead = tuple(c.shape[:-2])
    _check(c, "c", _F32, lead + (M, K))
    _check(v, "v", _F32, lead + (K,))
    y = torch.empty(lead + (M,), dtype=_F32, device=c.device)
    cs = row_split(M, K)
    _raise_on(_lib().ba_matvec(c.data_ptr(), v.data_ptr(), y.data_ptr(),
                               E, M, K, cs, _stream(c)), "ba_matvec")
    LAUNCHES["matvec"] += 1
    LAST_GRID["matvec"] = (cs, E * M)
    return y


def matvec_t(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """load_k = sum_i c_ik x_i.  [M, K] x [M] -> [K], or a fleet's [E, M,
    K] x [E, M] -> [E, K] in one launch.

    Replaces ``repro/kernels/budget_alloc.py:matvec_t`` (there ``matvec``
    on a materialised ``c.T``).  Bound: bytes.  Design: one thread per
    column, rows 0..M-1 in order with one FMA each -- coalesced across the
    warp, no transpose -- which is also the reference's rounding order;
    grid y is the episode.  Bitwise equal to the twin."""
    _on_cuda(c, x)
    E = _fleet(c, 2)
    M, K = c.shape[-2:]
    lead = tuple(c.shape[:-2])
    _check(c, "c", _F32, lead + (M, K))
    _check(x, "x", _F32, lead + (M,))
    load = torch.empty(lead + (K,), dtype=_F32, device=c.device)
    _raise_on(_lib().ba_matvec_t(c.data_ptr(), x.data_ptr(),
                                 load.data_ptr(), E, M, K, _stream(c)),
              "ba_matvec_t")
    LAUNCHES["matvec_t"] += 1
    return load


def dual_split(M: int, K: int) -> int:
    """Blocks (the cluster size cs) of :func:`dual_step` and
    :func:`dual_ascent` on an [M, K] matrix: each call is one cluster.

    cs starts at 1 and doubles while cs < ROW_SPLIT_MAX (8, the portable
    cluster size) and K >= 2 * cs * DUAL_MIN_STRIPE (each block's stripe
    of columns would still hold 128, half a column a thread).  M does not
    enter: a block with no row of its own still takes its stripe of
    columns."""
    cs = 1
    while cs < ROW_SPLIT_MAX and K >= 2 * cs * DUAL_MIN_STRIPE:
        cs *= 2
    return cs


def _dual_operands(c, lam, w_pow, xcap, mask, cap, cap_safe, beta):
    """Check the operands of a dual launch, one episode's or a fleet's
    (a leading axis on every operand); ``(E, M, K, cs, 1/beta as
    float32)``."""
    _on_cuda(c, lam, w_pow, xcap, mask, cap, cap_safe)
    E = _fleet(c, 2)
    M, K = c.shape[-2:]
    lead = tuple(c.shape[:-2])
    _check(c, "c", _F32, lead + (M, K))
    for t, n in ((lam, "lam"), (cap, "cap"), (cap_safe, "cap_safe")):
        _check(t, n, _F32, lead + (K,))
    for t, n in ((w_pow, "w_pow"), (xcap, "xcap")):
        _check(t, n, _F32, lead + (M,))
    _check(mask, "mask", _I32, lead + (M,))
    rows = _lib().ba_dual_smem_limit() // 4
    if M > rows:
        raise ValueError(f"dual_step keeps x in shared memory: M={M} rows "
                         f"exceed {rows}")
    inv_beta = float(torch.tensor(1.0 / float(beta), dtype=_F32))
    return E, M, K, dual_split(M, K), inv_beta


def dual_step(c, lam, w_pow, xcap, mask, cap, cap_safe, beta: float):
    """One SP1 dual-ascent sweep: ``(x [M], g [K])``.

    ``x_i = min((w_pow_i / max(sum_k c_ik lam_k, 1e-12))^(1/beta),
    xcap_i)`` where ``mask`` (int32) is set, else 0; ``g_k = (sum_i c_ik
    x_i - cap_k) / cap_safe_k`` with the load summed over rows in order.

    Replaces ``repro/kernels/budget_alloc.py:dual_step``, whose TPU grid
    carried the K-long load through VMEM scratch row tile by row tile.
    Bound: bytes (c is read twice, the second time from the 50 MB L2 at
    the scheduler's sizes).  Design: ``dual_kernel`` in step mode, one
    cluster of ``cs = dual_split(M, K)`` blocks (see :func:`dual_ascent`):
    a block of 256 threads per row for the denominator and x, x shared
    through distributed shared memory, then the row-ordered FMA load of
    each block's stripe of columns, 8 columns a thread (16-byte loads where
    the rows are 16-byte aligned) -- so g is bitwise the twin's given the
    same x, and x agrees to 1e-5 relative.  One episode only: the
    ascent (:func:`dual_ascent`) is what a fleet launches."""
    if c.dim() != 2:
        raise ValueError(f"dual_step takes one episode's [M, K], got shape "
                         f"{tuple(c.shape)}")
    _, M, K, cs, inv_beta = _dual_operands(c, lam, w_pow, xcap, mask, cap,
                                           cap_safe, beta)
    x = torch.empty(M, dtype=_F32, device=c.device)
    g = torch.empty(K, dtype=_F32, device=c.device)
    _raise_on(_lib().ba_dual_step(
        c.data_ptr(), lam.data_ptr(), w_pow.data_ptr(), xcap.data_ptr(),
        mask.data_ptr(), cap.data_ptr(), cap_safe.data_ptr(), x.data_ptr(),
        g.data_ptr(), M, K, inv_beta, cs, _stream(c)), "ba_dual_step")
    LAUNCHES["dual_step"] += 1
    return x, g


def dual_ascent(c, lam, w_pow, xcap, mask, cap, cap_safe, beta: float, *,
                adaptive: bool, max_iters: int, tol: float):
    """The whole SP1 dual ascent from ``lam``: ``(lam [K], iters)``, with
    ``iters`` an int32 scalar on the card.  Never synchronises.  A fleet
    (every operand with a leading axis E) gives ``(lam [E, K], iters
    [E])`` from one launch.

    Each iteration is :func:`dual_step`'s sweep, then ``lam = clamp(lam *
    exp(eta * g), 1e-12, 1e12)`` and the KKT error ``max(max(g, 0), lam
    * |g|)``; the loop runs while ``it < max_iters`` and the error exceeds
    ``tol`` (float32).  ``eta`` is ``0.5 / (1 + 0.001 it)``, or with
    ``adaptive`` starts at 0.5 and grows x1.2 while the error does not
    rise, else shrinks x0.7, kept in [0.2, 1.5].  This is
    :func:`repro_torch.kernels.ref.dual_ascent_ref`'s loop (``repro``'s
    ``lax.while_loop``), bitwise equal to that loop run over
    :func:`dual_step` launches on the card.

    Design: ``dual_kernel`` in ascent mode, one launch of one cluster of
    ``cs = dual_split(M, K)`` blocks that keeps the loop and its stop
    rule on the card: two cluster barriers an iteration, the KKT error
    combined through distributed shared memory, lam updated in place in
    the output.  Bound per iteration: 4 * M * K operations; c (in L2 at
    the scheduler's sizes) is read twice an iteration by the cluster's cs
    SMs alone, and their L2 reads set the time at M=32, K=16384.

    A fleet's ascents are one launch of E such clusters, cluster e on
    episode e's operands with its own step size, count and stop rule, as
    under ``jax.vmap`` of the loop; an episode's lam and count are a lone
    launch's on its operands.  The launch lasts as long as its longest
    ascent, and past :func:`dual_waves`' one wave the clusters queue."""
    E, M, K, cs, inv_beta = _dual_operands(c, lam, w_pow, xcap, mask, cap,
                                           cap_safe, beta)
    lead = tuple(c.shape[:-2])
    lam_out = torch.empty(lead + (K,), dtype=_F32, device=c.device)
    iters = torch.empty(lead, dtype=_I32, device=c.device)
    tol32 = float(torch.tensor(float(tol), dtype=_F32))
    _raise_on(_lib().ba_dual_ascent(
        c.data_ptr(), lam.data_ptr(), w_pow.data_ptr(), xcap.data_ptr(),
        mask.data_ptr(), cap.data_ptr(), cap_safe.data_ptr(),
        lam_out.data_ptr(), iters.data_ptr(), E, M, K, inv_beta,
        int(max_iters), tol32, int(bool(adaptive)), cs, _stream(c)),
        "ba_dual_ascent")
    LAUNCHES["dual_step"] += 1
    return lam_out, iters


def dual_waves(E: int, M: int, K: int) -> int:
    """Waves a fleet's ascent launch of E episodes of [M, K] runs in: E
    over the clusters of ``dual_split(M, K)`` blocks the card holds at
    once (``cudaOccupancyMaxActiveClusters``), rounded up."""
    n = _lib().ba_dual_max_clusters(M, dual_split(M, K))
    _raise_on(-min(n, 0), "ba_dual_max_clusters")
    if n == 0:
        raise RuntimeError(f"no dual cluster fits the card at M={M}")
    return _cdiv(E, n)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sweep_smem(K: int, cs: int, T: int) -> int:
    """Bytes of dynamic shared memory of a boost-sweep block holding its T
    leftover stripes: ``T * ls * 4`` with ``ls = 4 * ceil(ceil(K / 4) /
    cs)``, plus its 8 warps' lists of (offset, g) pairs, 128 * V a warp,
    where V (float4s a thread holds) is 2 for stripes of up to 2048 floats
    and 8 above.  Mirrors ``sweep_smem`` in csrc/budget_alloc.cu; above
    SWEEP_SMEM_MAX the leftover stays in device memory."""
    ls = 4 * _cdiv(_cdiv(K, 4), cs)
    v = 2 if ls <= 2048 else 8
    return 4 * T * ls + 8 * 8 * 128 * v


def sweep_split(M: int, C: int, K: int) -> tuple[int, int]:
    """``(cs, T)`` of the boost sweep over M analysts x C candidates of K
    blocks: each tile of T candidates of one analyst runs on a cluster of
    cs blocks, block r keeping the r-th stripe of the T leftover rows.

    T starts at min(C, SWEEP_TILE_MAX) (1 for :func:`boost_scan`), cs at
    1.  First, while a block would take more than SWEEP_SMEM_TARGET bytes
    (:func:`sweep_smem`): cs doubles where it may, else T halves, until
    both are at their limit.  Then, while the grid, M * ceil(C / T) * cs
    blocks, is under ROW_SPLIT_BLOCKS (two an SM): the same steps.  cs may
    double while cs < ROW_SPLIT_MAX (8) and K >= 2 * cs *
    ROW_SPLIT_MIN_CHUNK (each stripe keeps 2048 floats); T halves
    (rounding up) while T > 1.  N does not enter: a tile meets every visit
    in turn whatever their number."""
    T = max(1, min(C, SWEEP_TILE_MAX))
    cs = 1

    def step() -> bool:
        nonlocal cs, T
        if cs < ROW_SPLIT_MAX and K >= 2 * cs * ROW_SPLIT_MIN_CHUNK:
            cs *= 2
        elif T > 1:
            T = (T + 1) // 2
        else:
            return False
        return True

    while sweep_smem(K, cs, T) > SWEEP_SMEM_TARGET and step():
        pass
    while M * _cdiv(C, T) * cs < ROW_SPLIT_BLOCKS and step():
        pass
    return cs, T


def _boost_sweep(g_ord, sel, left, kappa_max: float, keep_left: bool):
    """Launch the boost sweep on ``g_ord [B, N, K]``, ``sel [B, C, N]``
    int32, ``left [B, C, K]`` at ``sweep_split(B, C, K)``; returns
    ``(extras, left_after or None)``."""
    B, N, K = g_ord.shape
    C = sel.shape[1]
    _check(g_ord, "g_ord", _F32, (B, N, K))
    _check(sel, "sel", _I32, (B, C, N))
    _check(left, "left", _F32, (B, C, K))
    cs, T = sweep_split(B, C, K)
    extras = torch.empty((B, C, N), dtype=_F32, device=g_ord.device)
    spill = sweep_smem(K, cs, T) > SWEEP_SMEM_MAX
    left_out = (torch.empty((B, C, K), dtype=_F32, device=g_ord.device)
                if keep_left or spill else None)
    kappa_cap = float(torch.tensor(kappa_max - 1.0, dtype=_F32))
    _raise_on(_lib().ba_boost_sweep(
        g_ord.data_ptr(), sel.data_ptr(), left.data_ptr(), extras.data_ptr(),
        None if left_out is None else left_out.data_ptr(), B, C, N, K,
        kappa_cap, cs, T, _stream(g_ord)), "ba_boost_sweep")
    LAST_GRID["boost_sweep"] = (cs, T, B * _cdiv(C, T) * cs)
    return extras, left_out


def boost_scan(g_ord, sel_ord, leftover, kappa_max: float):
    """SP2 boost sweep for one selection per analyst: ``g_ord [M, N, K]``,
    ``sel_ord [M, N]`` int32, ``leftover [M, K]`` -> ``(extras [M, N],
    leftover_after [M, K])``.

    Replaces ``repro/kernels/budget_alloc.py:boost_scan`` (batched there by
    vmap; here the analyst axis is the grid).  Bound: bytes (g and the
    leftover read once), but the N-step chain per analyst sets the time.
    Design: the boost-sweep kernel (see :func:`swap_eval`) with tiles of
    one candidate, each analyst's row split over a cluster of cs blocks
    (``sweep_split``: up to 8 while the grid is under two blocks an SM);
    bitwise equal to the twin."""
    _on_cuda(g_ord, sel_ord, leftover)
    M, N, K = g_ord.shape
    extras, left = _boost_sweep(g_ord, sel_ord.reshape(M, 1, N),
                                leftover.reshape(M, 1, K), kappa_max, True)
    LAUNCHES["boost_scan"] += 1
    return extras.reshape(M, N), left.reshape(M, K)


def swap_eval(g_ord, sel_c, leftover_c, kappa_max: float):
    """Boost sweeps for every swap candidate of every analyst:
    ``g_ord [M, N, K]``, ``sel_c [M, C, N]`` int32, ``leftover_c [M, C,
    K]`` -> ``extras [M, C, N]``.

    Replaces ``repro/kernels/budget_alloc.py:swap_eval`` (the O(N^3 K)
    term of a round).  Bound: bytes -- each candidate's leftover row is
    read once (M*C*K*4); the analyst's demand rows are shared through L2.
    Design (``sweep_tile_kernel``): tiles of T candidates of one analyst
    on clusters of cs blocks, ``(cs, T) = sweep_split(M, C, K)``; each
    block keeps its stripe of the T leftover rows in shared memory (in a
    device buffer past SWEEP_SMEM_MAX), and per visit that a candidate of
    the tile selects loads its stripe of the demand row once (prefetched
    during the previous visit), lists the nonzero entries, and takes each
    selecting candidate's min of left/g, the clip and the FMA debit over
    that list; block minima meet through distributed shared memory.
    Bitwise equal to the twin."""
    _on_cuda(g_ord, sel_c, leftover_c)
    extras, _ = _boost_sweep(g_ord, sel_c, leftover_c, kappa_max, False)
    LAUNCHES["swap_eval"] += 1
    LAST_GRID["swap_eval"] = tuple(sel_c.shape[:2])
    return extras
