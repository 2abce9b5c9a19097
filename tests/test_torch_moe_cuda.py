"""The MoE family's kernels and block on the card (Hopper only; skips
elsewhere).  Collects without JAX: the card machine runs these with
``--noconftest``.

* both attention kernels at mixtral-8x22b's heads (48 query over 8 kv
  heads, dh 128, G 6): flash windowed (window 4096) at the serve
  defaults' prompt (B=4, S=32) and a 2048-token one, decode at the serve
  defaults' 48-slot cache (33 valid) and the long serve's 2112 (2080
  valid), each against its twin within rtol = atol = 2e-5 and bitwise
  from launch to launch, one launch a call;
* ``moe_apply`` (no kernel of its own: gathers, ``torch.bmm``, the
  combine) on the card against the same call on the CPU, at mixtral's
  (8 experts, top 2) and kimi-k2-1t-a32b's (384, top 8) geometry at a
  narrow width with a router biased so that one expert overflows: the
  chosen experts and the kept slots equal wherever a token's k-th and
  (k+1)-th logits are more than 1e-5 of its largest |logit| apart, the
  output within 1e-5 of its largest |value| over the tokens routed
  alike, and bitwise from launch to launch.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import moe as M

TOL = dict(rtol=2e-5, atol=2e-5)
H, KH, DH, WINDOW = 48, 8, 128, 4096          # mixtral-8x22b's attention


@pytest.fixture
def hopper():
    """Skip unless an sm_90 card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


def _randn(shape, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(4, 32), (2, 2048)])
def test_cuda_flash_at_mixtrals_heads(hopper, B, S):
    q = _randn((B, S, H, DH), 1, hopper)
    k, v = (_randn((B, S, KH, DH), s, hopper) for s in (2, 3))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, causal=True, window=WINDOW)
    again = fa.flash_attention_cuda(q, k, v, causal=True, window=WINDOW)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=WINDOW)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)
    assert fa.LAUNCHES == {"flash_attention": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("L,n", [(48, 33), (2112, 2080)])
def test_cuda_decode_at_mixtrals_heads(hopper, L, n):
    B = 4
    q = _randn((B, H, DH), 4, hopper)
    k, v = (_randn((B, L, KH, DH), s, hopper) for s in (5, 6))
    da.reset_launches()
    got = da.decode_attention(q, k, v, n)
    again = da.decode_attention_cuda(q, k, v, n)
    want = ref.decode_attention_ref(q, k, v, n)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)
    assert da.LAUNCHES == {"decode_attention": 2}


def _moe_case(E, seed=0, D=96, F=64, T=256):
    """SwiGLU experts at N(0, 1/E), a router N(0, 1/D) whose row 0 steers
    every token to expert 3 (x's column 0 sits near 1)."""
    p = {"router": _randn((D, E), seed, "cpu") / D ** 0.5}
    for i, (n, shape) in enumerate((("w_up", (E, D, F)),
                                    ("w_gate", (E, D, F)),
                                    ("w_down", (E, F, D)))):
        p[n] = _randn(shape, seed + 1 + i, "cpu") / E ** 0.5
    p["router"][0, 3] += 6.0
    x = 0.5 * _randn((T, D), seed + 9, "cpu")
    x[:, 0] = 1.0 + 0.05 * _randn((T,), seed + 10, "cpu")
    return x, p


@pytest.mark.cuda
@pytest.mark.parametrize("E,k", [(8, 2), (384, 8)])
def test_cuda_moe_apply_matches_the_cpu(hopper, E, k):
    x, p = _moe_case(E)
    cap = M.moe_capacity(x.shape[0], k, E, 1.25)
    want = M.moe_apply(x, p, top_k=k, capacity=cap, act="silu")
    rw = M.route(x, p["router"], k, cap)
    assert bool((rw.slot < 0).any())                  # an expert overflows
    xd = x.to(hopper)
    pd = {n: t.to(hopper) for n, t in p.items()}
    got = M.moe_apply(xd, pd, top_k=k, capacity=cap, act="silu")
    again = M.moe_apply(xd, pd, top_k=k, capacity=cap, act="silu")
    assert torch.equal(got, again)
    rg = M.route(xd, pd["router"], k, cap)
    s = torch.sort(rw.logits.double(), dim=-1, descending=True).values
    tie = (s[:, k - 1] - s[:, k]) <= 1e-5 * rw.logits.abs().amax(-1)
    same = ~tie & (rg.experts.cpu() == rw.experts).all(-1)
    assert bool(((rg.experts.cpu() == rw.experts).all(-1) | tie).all())
    if not bool(tie.any()):
        assert torch.equal(rg.slot.cpu(), rw.slot)
    err = (got.cpu() - want).abs()[same].max()
    assert float(err) <= 1e-5 * float(want.abs().max())
