#!/usr/bin/env python3
"""Where xlstm-125m's float32 gradient leaves the exact one.

    python3 xlstm_grad_probe.py                # the card and the CPU
    python3 xlstm_grad_probe.py --device cpu   # the CPU alone

At launch/train.py's starting point on the device (``make_state(0, ...,
device)``: ``init_model`` draws from a generator on the device, so the
card's and the CPU's draws differ) and on its first batch (B=8 x 128,
two microbatches of 4), for each microbatch:
the loss and the gradient computed exactly (the port's own code in
float64 on the device, under ``repro_torch.fp.float64``), then in float32 on
the device and on the CPU.  For each float32 run it prints the gradient's
norm and its distance from the exact one, how many positions of each
``torch.maximum`` call site took the other branch than the exact run did
(the mLSTM's stabilisers and its normaliser max(|q.n|, exp(-m)), the
sLSTM's stabiliser), and the distance once every such call is made to
take the exact run's branch.  The card's float32 run is made twice, to
show whether it is deterministic.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import sys
import time
from collections import Counter
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


class Branches(TorchFunctionMode):
    """Records, for every ``torch.maximum(a, b)``, where ``a >= b`` and the
    call site; with ``force`` (an earlier run's masks, in call order)
    returns ``where(mask, a, b)`` instead, the other run's branches."""

    def __init__(self, force=None):
        super().__init__()
        self.masks, self.sites, self.force = [], [], force

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.maximum:
            return func(*args, **kwargs)
        a, b = args
        caller = inspect.currentframe().f_back
        self.sites.append(f"{caller.f_code.co_name}:{caller.f_lineno}")
        if self.force is not None:
            mask = self.force[len(self.masks)].to(a.device)
            self.masks.append(mask)
            return torch.where(mask, a, b)
        self.masks.append((a >= b).detach().cpu())
        return func(*args, **kwargs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_arch
    from repro_torch.fp import float64
    from repro_torch.launch import train as launcher
    from repro_torch.models import Transformer
    from repro_torch.training import make_loss_fn, make_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = args.device
    runs = [dev, dev + " again", "cpu"] if dev != "cpu" else ["cpu"]
    cfg = get_arch("xlstm-125m")
    tcfg = launcher.train_config(cfg, 8, 0.2, 1.0)
    start = make_state(0, cfg, tcfg, device=dev)["params"]
    params = Transformer(cfg, device="cpu")
    with torch.no_grad():
        params.flat.copy_(start.flat)
    del start
    batch = cs._batch_on(cfg, 0, 8, 128, "cpu")
    loss_fn = make_loss_fn(cfg)
    names = [(n, p.numel()) for n, p in params.named_parameters()]

    def on(device, f64=False):
        m = Transformer(cfg, device=device)
        with torch.no_grad():
            m.flat.copy_(params.flat)
        return m.double() if f64 else m

    def grad(model, mb, f64=False, force=None):
        device = next(model.parameters()).device
        bb = {k: v.to(device) for k, v in mb.items()}
        rec = Branches(force)
        t0 = time.perf_counter()
        with rec, float64() if f64 else contextlib.nullcontext():
            loss = loss_fn(model, bb)
            g = torch.autograd.grad(loss, list(model.parameters()))
        flat = torch.cat([x.reshape(-1) for x in g]).double().cpu()
        return float(loss.detach()), flat, rec, time.perf_counter() - t0

    if dev != "cpu":
        smi = cs.subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip())
    for j in range(2):
        mb = {k: v[4 * j:4 * j + 4] for k, v in batch.items()}
        l64, g64, exact, s = grad(on(dev, f64=True), mb, f64=True)
        n64 = float(g64.norm())
        print(f"microbatch {j} (4 x 128), exact (float64 on {dev}, "
              f"{s:.2f} s): loss {l64:.9f}, |g| {n64:.4f}; "
              f"{len(exact.masks)} torch.maximum calls at "
              f"{len(set(exact.sites))} sites")
        for run in runs:
            model = on(run.split()[0])
            loss, g, rec, s = grad(model, mb)
            assert rec.sites == exact.sites, run
            flips = Counter()
            for site, a, b in zip(rec.sites, rec.masks, exact.masks):
                flips[site] += int((a != b).sum())
            _, gf, _, _ = grad(model, mb, force=exact.masks)
            off, worst = 0, []
            for n, c in names:
                worst.append((float((g[off:off + c] - g64[off:off + c])
                                    .norm()), n))
                off += c
            worst = sorted(worst, reverse=True)[:3]
            print(f"  float32 on {run} ({s:.2f} s): loss {loss:.9f}, |g| "
                  f"{float(g.norm()):.4f}, |g - exact| / |exact| "
                  f"{float((g - g64).norm()) / n64:.4e}; positions on the "
                  f"other branch {dict((k, v) for k, v in flips.items() if v)}"
                  f" (of {sum(int(m.numel()) for m in rec.masks)}); on the "
                  f"exact run's branches |g - exact| / |exact| "
                  f"{float((gf - g64).norm()) / n64:.4e}; largest "
                  f"|g - exact| by leaf {[(n, round(e, 2)) for e, n in worst]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
