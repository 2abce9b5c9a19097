"""The RG-LRU scan's backward kernel on a Hopper card (skipped elsewhere):
``rg_scan_bwd_kernel`` against the twin's backward, bitwise, and the
``rec`` blocks training through it.

The twin's backward (``_TwinScan.backward``) rounds each product and
each sum, in torch ops; run on the same CUDA tensors it is the contract
the kernel meets bit for bit (dL/da, dL/db and, with h0, dL/dh0).
Inputs are seeded numpy arrays: decays in [0.5, 0.999) so that the
carry matters, everything else standard normal.  No JAX here: the CPU
tests hold the twin to ``repro``'s gradient.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import rg_lru
from repro_torch.models import Transformer, forward, lm_loss


@pytest.fixture
def hopper():
    """Skip unless an sm_90 card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


def _inputs(B, S, D, seed, dev):
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(0.5, 0.999, (B, S, D)), rng.standard_normal((B, S, D)),
            rng.standard_normal((B, D)), rng.standard_normal((B, S, D)))
    return [torch.tensor(x, dtype=torch.float32, device=dev) for x in arrs]


def _twin_grads(a, b, h0, g):
    leaves = [t.clone().requires_grad_() for t in (a, b)] + \
        ([] if h0 is None else [h0.clone().requires_grad_()])
    h = rg_lru._TwinScan.apply(*leaves[:2], None if h0 is None else leaves[2])
    h.backward(g)
    return h.detach(), [t.grad for t in leaves]


# (B, S, D, with h0): one step, one step past kAhead (16) and a multiple
# of it, a D below a warp, a ragged D across blocks, serving widths
CASES = [(1, 1, 7, False), (2, 17, 64, True), (2, 32, 100, False),
         (3, 1000, 2597, True), (4, 64, 2560, True), (1, 300, 5, True),
         (4, 33, 2560, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,with_h0", CASES)
def test_cuda_scan_backward_is_bitwise_the_twin(hopper, B, S, D, with_h0):
    a, b, h0, g = _inputs(B, S, D, S + D, hopper)
    h0 = h0 if with_h0 else None
    h, want = _twin_grads(a, b, h0, g)
    rg_lru.reset_launches()
    da, db, dh0 = rg_lru.rglru_scan_bwd_cuda(a, h, g, h0)
    again = rg_lru.rglru_scan_bwd_cuda(a, h, g, h0)
    assert torch.equal(da, want[0]) and torch.equal(db, want[1])
    assert (dh0 is None) == (h0 is None)
    if h0 is not None:
        assert torch.equal(dh0, want[2])
    assert torch.equal(da, again[0]) and torch.equal(db, again[1])
    assert rg_lru.BWD_LAUNCHES == {"rglru_scan_bwd": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
def test_cuda_autograd_runs_both_kernels(hopper, with_h0):
    """rglru_scan under autograd on the card: the forward kernel, then the
    backward kernel, each once; gradients bitwise the twin's."""
    a, b, h0, g = _inputs(2, 40, 96, 3, hopper)
    h0 = h0 if with_h0 else None
    _, want = _twin_grads(a, b, h0, g)
    leaves = [t.clone().requires_grad_() for t in (a, b)] + \
        ([] if h0 is None else [h0.clone().requires_grad_()])
    rg_lru.reset_launches()
    h = rg_lru.rglru_scan(*leaves[:2], None if h0 is None else leaves[2])
    h.backward(g)
    assert rg_lru.LAUNCHES == {"rglru_scan": 1}
    assert rg_lru.BWD_LAUNCHES == {"rglru_scan_bwd": 1}
    for got, w in zip(leaves, want):
        assert torch.equal(got.grad, w)


@pytest.mark.cuda
def test_cuda_rec_blocks_train(hopper):
    """A reduced recurrentgemma-2b (one group: rec, rec, local) trains on
    the card: one forward and one backward scan launch per rec block, and
    every gradient within 1e-5 of the largest |g| of the CPU's (float32
    GEMMs sum in another order on the card; TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_arch("recurrentgemma-2b"), n_layers=3)
    host = Transformer(cfg, device="cpu")
    with torch.no_grad():
        host.flat.copy_(torch.from_numpy(
            np.random.default_rng(0).standard_normal(host.flat.numel())
            .astype(np.float32) * 0.1))
    card = Transformer(cfg, device=hopper)
    with torch.no_grad():
        card.flat.copy_(host.flat)
    t = np.random.default_rng(1).integers(0, cfg.vocab, (2, 25))
    grads = []
    for model, dev in ((host, "cpu"), (card, hopper)):
        tok = torch.as_tensor(t, device=dev)
        rg_lru.reset_launches()
        loss = lm_loss(forward(model, tok[:, :-1]), tok[:, 1:])
        g = torch.autograd.grad(loss, list(model.parameters()))
        grads.append(torch.cat([x.reshape(-1) for x in g]).cpu())
        n_rec = [k for k, _ in cfg.layer_specs()].count("rec")
        if dev is hopper:
            assert rg_lru.LAUNCHES == {"rglru_scan": n_rec}
            assert rg_lru.BWD_LAUNCHES == {"rglru_scan_bwd": n_rec}
    scale = float(grads[0].abs().max())
    assert float((grads[1] - grads[0]).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_cuda_scan_backward_rejects_what_it_does_not_take(hopper):
    a, b, h0, g = _inputs(2, 8, 16, 0, hopper)
    h = rg_lru.rglru_scan_cuda(a, b, h0)
    rg_lru.reset_launches()
    with pytest.raises(TypeError):
        rg_lru.rglru_scan_bwd_cuda(a, h, g.double(), h0)
    with pytest.raises(ValueError):
        rg_lru.rglru_scan_bwd_cuda(a, h.transpose(1, 2), g, h0)
    with pytest.raises(ValueError):
        rg_lru.rglru_scan_bwd_cuda(a, h, g.cpu(), h0)
    with pytest.raises(ValueError):
        rg_lru.rglru_scan_bwd_cuda(a, h, g, h0[:1])
    big = torch.zeros((65536, 1, 1), device=hopper)
    with pytest.raises(ValueError):
        rg_lru.rglru_scan_bwd_cuda(big, big, big)
    assert rg_lru.BWD_LAUNCHES == {"rglru_scan_bwd": 0}
