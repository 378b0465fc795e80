"""Cross-query selectivity calibration (paper section 3.2 follow-on).

The planner's weakest estimates are expression predicates no zone map
can bound — it falls back to a constant selectivity guess, and the
adaptive layer only corrects the damage at the *next* stage barrier.
Recurring predicates deserve better: after a scan pipeline (a pure
``scan → filter… → project…`` chain) completes, the engine records the
*observed* selectivity of its full predicate chain under
``(table, predicate-chain hash)`` in the store's low-latency KV tier —
the same tier the result registry lives in, so calibration spans every
session sharing a store. The next compile of the same predicate seeds
``PhysicalPlanner._est`` with the observation and sizes exchange
fan-outs and fleets correctly *before* any barrier.

Calibration is applied **downward-only** (``min(static, observed)``):
it tightens over-estimates — the direction that wastes money on
over-provisioned fleets — while under-estimates keep the conservative
static figure, preserving the invariant that adaptive fleets never
exceed their statically planned size. Observations are folded with an
exponential moving average so drifting data converges instead of
flapping.
"""

from __future__ import annotations

import hashlib
import json

from repro_torch.storage import msgpack_codec as msgpack

from repro_torch.storage.object_store import ObjectStore


def predicate_key(pred_dicts: list[dict]) -> str:
    """Stable hash of a predicate chain (serialized expression dicts,
    order-insensitive — filter pushdown may reorder conjuncts)."""
    canon = sorted(json.dumps(p, sort_keys=True, separators=(",", ":"))
                   for p in pred_dicts)
    return hashlib.sha256("\n".join(canon).encode()).hexdigest()[:24]


def scan_filter_signature(op: dict) -> tuple[str, str] | None:
    """(table, predicate key) when ``op`` is a calibratable fragment op
    tree: a pure scan → filter/project chain with at least one filter.
    Anything else (aggregates, joins) changes the output cardinality, so
    its rows-out is not a selectivity observation."""
    preds: list[dict] = []
    cur = op
    while True:
        t = cur.get("t")
        if t == "filter":
            preds.append(cur["pred"])
        elif t == "scan_table":
            return (cur["table"], predicate_key(preds)) if preds else None
        elif t != "project":
            return None
        cur = cur["child"]


class SelectivityCalibration:
    """Persistent per-(table, predicate) selectivity observations."""

    def __init__(self, store: ObjectStore, namespace: str = "calibration",
                 alpha: float = 0.5):
        self.store = store.with_tier("dynamodb")
        self.namespace = namespace
        self.alpha = alpha          # EMA weight of the newest observation

    def _key(self, table: str, pred_key: str) -> str:
        return f"{self.namespace}/{table}/{pred_key}"

    def lookup(self, table: str, pred_key: str) -> float | None:
        try:
            entry = msgpack.unpackb(
                self.store.get(self._key(table, pred_key)).data)
        except (KeyError, FileNotFoundError):
            return None
        return float(entry["sel"])

    def record(self, table: str, pred_key: str, selectivity: float) -> None:
        sel = min(1.0, max(float(selectivity), 1e-4))
        prev = self.lookup(table, pred_key)
        if prev is not None:
            sel = self.alpha * sel + (1.0 - self.alpha) * prev
        self.store.put(self._key(table, pred_key),
                       msgpack.packb({"sel": sel}))
