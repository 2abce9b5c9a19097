"""The attention kernels on bfloat16 operands, on a Hopper card only
(``cuda`` marker; they skip elsewhere).  No JAX here: each kernel is held
to its plain twin (:mod:`repro_torch.kernels.ref`) fed the same bfloat16
inputs, which computes in float32 and rounds once.

Bound: every output element within one bfloat16 ulp of the twin's, plus
the float32 kernels' own rtol = atol = 2e-5 (their sum order differs from
the twin's before the one rounding, and near zero that difference can
pass an ulp); and bitwise the same from launch to launch.  Cases: every
flash route -- ``flash_fwd_kernel`` (dh 16, 32), ``flash_fwd_tiled_kernel``
(dh 64, 128, also Skv != S), the narrow and the wide dh-256 kernels -- and
``att_decode`` at every (dh, G) it instantiates, at the configs' heads
and shapes where they have them.

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_bf16_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

F32_TOL = 2e-5
# (B, H, KH, S, Skv, dh, causal, window): the serve prompts and the long
# serves' at the configs' heads, ragged tiles, Skv != S at dh 64 and 128
# (whisper-medium's 16 over 16 heads against 1500 frames, llama-3.2-
# vision-11b's 32 over 8 against 1601 memory rows) and both dh-256
# kernels (recurrentgemma-2b: 10 over 1, window 2048)
FLASH = [(2, 4, 2, 130, 130, 32, True, 17), (1, 8, 8, 65, 65, 16, False, 9),
         (4, 12, 4, 32, 32, 64, True, None),
         (2, 12, 4, 1000, 1000, 64, True, 256),
         (4, 16, 16, 384, 1500, 64, False, None),
         (4, 40, 8, 32, 32, 128, True, None),
         (1, 40, 8, 2048, 2048, 128, True, None),
         (2, 48, 4, 300, 300, 128, True, None),
         (4, 32, 8, 32, 1601, 128, False, None),
         (1, 32, 8, 200, 1601, 128, False, None),
         (4, 10, 1, 32, 32, 256, True, 2048),
         (2, 10, 1, 2048, 2048, 256, True, 2048),
         (1, 10, 1, 1037, 1037, 256, True, 300)]
# (B, H, KH, L, dh, cache_len, window) at every (dh, G) of att_decode:
# the configs' heads where they have that G, else G heads over 2
CONFIG_HEADS = {(64, 1): (16, 16), (64, 3): (12, 4), (128, 4): (32, 8),
                (128, 5): (40, 8), (128, 6): (48, 8), (128, 8): (16, 2),
                (128, 12): (48, 4), (256, 10): (10, 1)}
DECODE = [(4, *CONFIG_HEADS.get((dh, G), (2 * G, 2)), L, dh, n, None)
          for dh, groups in sorted(da.GROUPS.items()) for G in groups
          for L, n in ((48, 33), (2112, 2080))] + [
    (4, 10, 1, 2048, 256, 1500, 695), (2, 12, 4, 3000, 64, 2999, 100),
    (4, 32, 8, 1601, 128, 1601, None), (4, 16, 16, 1500, 64, 1500, None)]


@pytest.fixture
def hopper():
    """Skip unless an sm_90 card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


def _bf16(shape, rng, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev, torch.bfloat16)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each element of ``x`` (8 significant bits)."""
    a = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def assert_within_ulp(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.double(), want.double()
    bound = bf16_ulp(want).double() + F32_TOL * (1 + w.abs())
    bad = (g - w).abs() > bound
    assert not bool(bad.any()), f"{int(bad.sum())} elements past one ulp"


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,S,Skv,dh,causal,window", FLASH)
def test_cuda_bf16_flash_matches_twin(hopper, B, H, KH, S, Skv, dh, causal,
                                      window):
    rng = np.random.default_rng(S + Skv + dh)
    q = _bf16((B, S, H, dh), rng, hopper)
    k, v = (_bf16((B, Skv, KH, dh), rng, hopper) for _ in range(2))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert_within_ulp(got, want)
    assert torch.equal(got, again)
    assert fa.LAUNCHES == {"flash_attention": 2}
    wide = dh == 256 and fa.wide_tiles(S, causal, window)
    assert fa.LAST_ENTRY["flash_attention"] == (
        "att_flash_wide_bf16" if wide else "att_flash_bf16")
    if dh == 256:            # the other dh-256 kernel on the same operands
        other = "att_flash_bf16" if wide else "att_flash_wide_bf16"
        assert_within_ulp(fa._att_flash(other, q, k, v, causal, window),
                          want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,L,dh,n,window", DECODE)
def test_cuda_bf16_decode_matches_twin(hopper, B, H, KH, L, dh, n, window):
    rng = np.random.default_rng(L + dh + H)
    q = _bf16((B, H, dh), rng, hopper)
    k, v = (_bf16((B, L, KH, dh), rng, hopper) for _ in range(2))
    da.reset_launches()
    got = da.decode_attention(q, k, v, n, window=window)
    again = da.decode_attention_cuda(q, k, v, n, window=window)
    want = ref.decode_attention_ref(q, k, v, n, window=window)
    assert_within_ulp(got, want)
    assert torch.equal(got, again)
    assert da.LAUNCHES == {"decode_attention": 2}
    assert da.resident_blocks(dh, H // KH, True) >= 1


@pytest.mark.cuda
def test_cuda_bf16_launchers_refuse_mixed_dtypes(hopper):
    rng = np.random.default_rng(0)
    q = _bf16((1, 16, 4, 64), rng, hopper)
    k, v = (_bf16((1, 16, 2, 64), rng, hopper) for _ in range(2))
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q, k.float(), v)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.half(), k.half(), v.half())
    qd = _bf16((1, 4, 64), rng, hopper)
    with pytest.raises(TypeError):
        da.decode_attention_cuda(qd, k, v.float(), 8)
