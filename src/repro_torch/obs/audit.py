"""Append-only, checksummed per-grant privacy audit ledger + verifier.

Every grant the service realizes is attributed *before* the slot-table
recycles the pipeline's row: one JSONL record per granted pipeline with
the grant tick, external analyst id, pipeline column, service tier, the
allocation ratio ``x`` (overdraw guard folded in), and the parallel
``bids``/``eps`` lists — the *global* block ids the pipeline's live
demand touched and the epsilon drawn from each.  Global block ids are
layout-independent (shard ``s`` merely owns ``bid % S``), so one ledger
stays verifiable across checkpoint restores and elastic shard remaps.

Integrity is a sha256 hash chain: each record carries
``h = sha256(prev_h + canonical_json(record_without_h))``; the genesis
parent is 64 zeros.  Re-opening an existing ledger (service restart,
checkpoint restore) continues the chain from the last record — the file
is append-only by construction, and any edit, reorder, or truncation
after a reopen breaks verification.

The offline verifier replays a ledger and proves conservation: summed
epsilon per global block never exceeds that block's minted budget, which
holds across ring wraps because a wrapped slot is a *new* bid with a
fresh budget.  CLI::

    python -m repro_torch.obs.audit verify <ledger.jsonl>

exits 0 iff the chain and every per-block budget check out.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterator, Optional

GENESIS = "0" * 64
# float32 grants summed in float64: relative headroom plus an absolute
# floor for epsilon-scale values
_REL_TOL = 1e-5
_ABS_TOL = 1e-6


def _canonical(record: dict) -> str:
    return json.dumps(record, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def _chain(prev: str, record: dict) -> str:
    return hashlib.sha256((prev + _canonical(record)).encode()).hexdigest()


def _last_hash(path: str) -> Optional[str]:
    """Hash of the final record in an existing ledger (None if empty)."""
    last = None
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                last = line
    if last is None:
        return None
    return json.loads(last)["h"]


class AuditWriter:
    """Appends chained records; flushed per :meth:`flush` (the service
    calls it once per chunk), fsynced on :meth:`close`.

    ``meta`` must carry the budget geometry the verifier needs:
    ``device_budget`` (per-device epsilon list), ``blocks_per_device``,
    ``n_devices`` — plus whatever identifies the writer (tick,
    ``layout_shards``...).  Every open appends an ``open`` record, so a
    ledger spanning restarts reads as chained sessions."""

    def __init__(self, path: str, meta: Dict):
        self.path = os.fspath(path)
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        prev = None
        if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
            prev = _last_hash(self.path)
        self._prev = prev if prev is not None else GENESIS
        self._f = open(self.path, "a", encoding="utf-8")
        self._append({"kind": "open", "meta": dict(meta)})
        self.flush()

    def _append(self, record: dict) -> None:
        h = _chain(self._prev, record)
        self._f.write(_canonical({**record, "h": h}) + "\n")
        self._prev = h

    def grant(self, *, tick: int, analyst: int, pipeline: int, tier: str,
              x: float, bids, eps) -> None:
        self._append({
            "kind": "grant", "tick": int(tick), "analyst": int(analyst),
            "pipeline": int(pipeline), "tier": str(tier), "x": float(x),
            "bids": [int(b) for b in bids],
            "eps": [float(e) for e in eps],
        })

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None


# ------------------------------------------------------------------ reader
def read_ledger(path: str) -> Iterator[dict]:
    """Yield records, verifying the hash chain as it goes."""
    prev = GENESIS
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            h = rec.pop("h", None)
            if h != _chain(prev, rec):
                raise ValueError(
                    f"{path}:{lineno}: hash chain broken "
                    f"(record tampered, reordered, or truncated above)")
            prev = h
            rec["_line"] = lineno
            yield rec


def _block_budget(meta: dict, bid: int) -> float:
    bpd = int(meta["blocks_per_device"])
    bpr = int(meta["n_devices"]) * bpd
    return float(meta["device_budget"][(bid % bpr) // bpd])


def verify_ledger(path: str) -> Dict:
    """Replay a ledger: chain integrity + per-block conservation.

    Returns a report dict; ``report["ok"]`` is the verdict and
    ``report["violations"]`` lists every failure with its line number.
    Conservation: for every global block id, the float64 sum of granted
    epsilon must not exceed the block's minted budget (with float32
    summation slack).  Holds across wraps/shards/restores because bids
    are globally unique and layout-independent.
    """
    spend: Dict[int, float] = {}
    grant_ticks: Dict[int, int] = {}
    meta = None
    violations = []
    n_grants = 0
    n_opens = 0
    last_open_tick = None
    try:
        for rec in read_ledger(path):
            if rec["kind"] == "open":
                n_opens += 1
                m = rec["meta"]
                if meta is None:
                    meta = m
                else:
                    for key in ("device_budget", "blocks_per_device",
                                "n_devices"):
                        if m.get(key) != meta.get(key):
                            violations.append(
                                f"line {rec['_line']}: reopen changed "
                                f"budget geometry field {key!r}")
                t = m.get("tick")
                if (t is not None and last_open_tick is not None
                        and t < last_open_tick):
                    violations.append(
                        f"line {rec['_line']}: reopen tick {t} went "
                        f"backwards (< {last_open_tick})")
                last_open_tick = t if t is not None else last_open_tick
            elif rec["kind"] == "grant":
                n_grants += 1
                if len(rec["bids"]) != len(rec["eps"]):
                    violations.append(
                        f"line {rec['_line']}: bids/eps length mismatch")
                    continue
                for bid, e in zip(rec["bids"], rec["eps"]):
                    if e < -_ABS_TOL:
                        violations.append(
                            f"line {rec['_line']}: negative grant "
                            f"{e} on block {bid}")
                    spend[bid] = spend.get(bid, 0.0) + float(e)
                    grant_ticks[bid] = rec["tick"]
            else:
                violations.append(
                    f"line {rec['_line']}: unknown kind {rec['kind']!r}")
    except (ValueError, KeyError, json.JSONDecodeError) as exc:
        return {"ok": False, "error": str(exc), "grants": n_grants,
                "blocks": len(spend), "violations": violations}

    if meta is None:
        violations.append("no open record: budget geometry unknown")
        budgets = {}
    else:
        budgets = {bid: _block_budget(meta, bid) for bid in spend}

    max_util = 0.0
    for bid, s in sorted(spend.items()):
        b = budgets.get(bid)
        if b is None:
            continue
        if b > 0:
            max_util = max(max_util, s / b)
        if s > b * (1.0 + _REL_TOL) + _ABS_TOL:
            violations.append(
                f"block {bid}: spend {s:.6g} exceeds budget {b:.6g} "
                f"(last grant tick {grant_ticks[bid]})")

    return {
        "ok": not violations,
        "opens": n_opens,
        "grants": n_grants,
        "blocks": len(spend),
        "total_epsilon": sum(spend.values()),
        "max_block_utilization": max_util,
        "violations": violations,
    }


def _main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.audit",
        description="Verify a FLaaS privacy audit ledger.")
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("verify", help="chain + per-block conservation")
    v.add_argument("ledger", help="path to the JSONL audit ledger")
    args = p.parse_args(argv)

    report = verify_ledger(args.ledger)
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(_main())
