"""The RG-LRU ``rec`` block: the port against ``repro`` on the CPU.

Parameters are ``repro``'s own initial values (``init_rglru_block``,
``init_block``), carried across as numpy arrays; inputs are seeded numpy
arrays.  ``repro`` scans with ``jax.lax.associative_scan``, the port in
time order (one FMA per step), so they differ by rounding alone.
Tolerance: every output and state within 1e-5 of its largest |value|,
in absolute terms (a relative bound per element would fail on elements
near zero, where the two scans' rounding is not relative).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models import init_model
from repro_torch.models import recurrent as R
from repro_torch.models.transformer import Block, apply_block

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

RTOL_MAX = 1e-5                  # of the largest |value|, absolute


def _close(got, want, rtol_max=RTOL_MAX):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= rtol_max * np.abs(want).max(), (err, np.abs(want).max())


def _rg_params(D, seed=0):
    tree = jax.device_get(JR.init_rglru_block(jax.random.PRNGKey(seed), D, D,
                                              dtype=jnp.float32))
    return tree, {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _x(B, S, D, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)


def test_coefficients_and_conv_match_repro():
    tree, p = _rg_params(48)
    x = _x(2, 11, 48)
    a, b = R._rglru_coeffs(torch.from_numpy(x), p)
    ja, jb = JR._rglru_coeffs(jnp.asarray(x), tree)
    _close(a, ja)
    _close(b, jb)
    state = _x(2, 3, 48, seed=2)
    for st in (None, state):
        y, new = R.causal_conv1d(torch.from_numpy(x), p["conv_w"],
                                 p["conv_b"],
                                 None if st is None else torch.from_numpy(st))
        jy, jnew = JR.causal_conv1d(jnp.asarray(x), tree["conv_w"],
                                    tree["conv_b"], st)
        _close(y, jy)
        assert np.array_equal(new.numpy(), np.asarray(jnew))   # a copy


@pytest.mark.parametrize("S", [1, 16, 37])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_and_state_match_repro(S, with_state):
    D = 64
    tree, p = _rg_params(D, seed=S)
    x = _x(2, S, D, seed=S)
    state = None
    if with_state:
        state = (_x(2, 3, D, seed=7), _x(1, 2, D, seed=8)[0])
    out, (conv, h) = R.rglru_block(
        torch.from_numpy(x), p,
        None if state is None else tuple(map(torch.from_numpy, state)))
    jout, (jconv, jh) = JR.rglru_block(
        jnp.asarray(x), tree,
        None if state is None else tuple(map(jnp.asarray, state)))
    _close(out, jout)
    _close(conv, jconv)
    _close(h, jh)
    assert conv.shape == (2, 3, D) and h.shape == (2, D)
    assert h.dtype == conv.dtype == torch.float32


def test_decode_steps_continue_the_prefill():
    """The port alone: S steps one at a time from the carried state give
    the state and outputs of one pass over S (within the bound: the
    projections of one row and of S rows round differently)."""
    tree, p = _rg_params(32, seed=3)
    x = torch.from_numpy(_x(2, 9, 32, seed=4))
    out, (conv, h) = R.rglru_block(x, p)
    state = R.rglru_init_state(2, 32, "cpu")
    steps = []
    for t in range(9):
        o, state = R.rglru_block(x[:, t:t + 1], p, state)
        steps.append(o)
    _close(torch.cat(steps, dim=1), out.numpy())
    _close(state[1], h.numpy())
    _close(state[0], conv.numpy())


def test_rec_block_at_full_width_matches_repro():
    """One ``rec`` block of ``recurrentgemma-2b`` at its full width (D =
    2560, MLP 7680, geglu), B = 1, S = 16."""
    jcfg = jget_arch("recurrentgemma-2b")
    cfg = get_arch("recurrentgemma-2b")
    jp = jax.device_get(JT.init_block(jax.random.PRNGKey(0), "rec", False,
                                      jcfg, jnp.float32))
    blk = Block("rec", False, cfg, "cpu")
    with torch.no_grad():
        for name, t in blk.named_parameters():
            mod, leaf = name.split(".")
            t.copy_(torch.from_numpy(np.asarray(jp[mod][leaf])))
    x = _x(1, 16, 2560, seed=5)
    pos = torch.arange(16)
    got, (conv, h) = apply_block(torch.from_numpy(x), blk, "rec", cfg,
                                 positions=pos, attend=None)
    want = JT.apply_block_train(jnp.asarray(x), jp, "rec", jcfg,
                                positions=jnp.arange(16))
    _close(got, want)
    _, (jconv, jh) = JR.rglru_block(
        JT.L.apply_norm(jnp.asarray(x), jp["norm1"], kind=jcfg.norm), jp["rg"])
    _close(conv, jconv)
    _close(h, jh)


def test_init_model_draws_griffin_lambda():
    """``lambda`` so that sigmoid(lambda)^8 lies in (0.9, 0.999) (``repro``'s
    draw), the conv taps N(0, 0.02^2), the gate biases zero."""
    cfg = dataclasses.replace(reduced(get_arch("recurrentgemma-2b")),
                              d_model=512)
    params = {k: v.detach() for k, v in
              init_model(cfg, 0, device="cpu").named_parameters()}
    lam = params["blocks.0.rg.lambda"]
    u = torch.sigmoid(lam.double()) ** 8
    assert float(u.min()) > 0.9 - 1e-6 and float(u.max()) < 0.999 + 1e-6
    assert float(u.std()) > 0.01                     # drawn, not constant
    assert abs(float(params["blocks.1.rg.conv_w"].std()) - 0.02) < 2e-3
    assert abs(float(params["blocks.0.rg.w_a"].std()) - 512 ** -0.5) < 2e-3
    for leaf in ("conv_b", "b_a", "b_i"):
        assert not params[f"blocks.0.rg.{leaf}"].any()
    assert "blocks.2.attn.wq" in params               # the local block
