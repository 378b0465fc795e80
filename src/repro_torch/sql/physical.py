"""Physical optimizer and plan (paper section 3.2, blue boxes; Fig. 3).

Maps the optimized logical plan to pipelines of physical operators for
data-parallel execution by serverless workers:

  * logical→physical operator mapping (repartition vs. broadcast join,
    direct vs. sort aggregation strategies),
  * pipeline-breaker identification and shuffle-point insertion,
  * worker counts per pipeline from input size and per-function network
    burst capacity,
  * shuffle tier selection (standard vs. hot/express storage) from the
    object-request-rate reasoning of the paper,
  * per-pipeline *semantic hashes* — computed from the logical subtree a
    pipeline completes plus the catalog's file lists, *before* physical
    properties (worker counts, partition fan-out, exchange tier) are
    attached, so cached results match across physical configurations
    (section 3.4).

All artifacts are JSON/msgpack-serializable: fragment specs are the
function invocation payloads (section 3.3).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np

from repro_torch.data.catalog import Catalog
from repro_torch.exec.expr import expr_from_dict, expr_to_dict
from repro_torch.sql import ast
from repro_torch.sql.logical import (LAggregate, LFilter, LJoin, LLimit, LNode,
                               LProject, LScan, LSort)

DIRECT_AGG_MAX_GROUPS = 4096


@dataclasses.dataclass
class PlannerConfig:
    # Per-worker input target: the network burst capacity of one function
    # (paper: worker count is input size / burst capacity).
    bytes_per_worker: int = 32 << 20
    max_workers: int = 2500
    # Build sides smaller than this are broadcast instead of repartitioned.
    broadcast_threshold_bytes: int = 16 << 20
    # Exchange fan-out (defaults derived from producer width if None).
    exchange_partitions: int | None = None
    # Above this many shuffle objects, tier the exchange to hot storage.
    hot_shuffle_object_threshold: int = 64
    filter_selectivity_guess: float = 0.3
    # Force one shuffle strategy for every hash exchange
    # ("direct" | "combining" | "multilevel"); None → the cost model
    # picks per exchange via ``CostModel.exchange_cost``.
    exchange_strategy: str | None = None
    # Annotate repartition joins for semi-join filter pushdown (the
    # build side publishes a Bloom filter over the join key; eligible
    # probe exchanges apply it before partitioning when
    # ``CostModel.semijoin_benefit`` projects a saving).
    semijoin: bool = True


@dataclasses.dataclass
class Partitioning:
    kind: str                      # none | hash
    keys: tuple[str, ...] = ()
    n_dest: int = 1
    tier: str = "s3-standard"
    # Shuffle strategy (repro_torch.exec.exchange registry). The *intent*; the
    # materialized layout consumers dispatch on is recorded in the
    # registry entry at publish time ("layout": grid | combined).
    strategy: str = "direct"
    # Multilevel only: storage tier of the short-lived l0 intermediates
    # (producer spill before the merge wave). None → same as ``tier``;
    # ``CostModel.l0_tier_choice`` routes them to the express tier when
    # cheaper, and the engine deletes the l0 prefix once the wave lands.
    l0_tier: str | None = None

    def to_dict(self):
        return {"kind": self.kind, "keys": list(self.keys),
                "n_dest": self.n_dest, "tier": self.tier,
                "strategy": self.strategy, "l0_tier": self.l0_tier}

    @classmethod
    def from_dict(cls, d):
        return cls(d["kind"], tuple(d["keys"]), d["n_dest"], d["tier"],
                   d.get("strategy", "direct"), d.get("l0_tier"))


@dataclasses.dataclass
class ExecutionParams:
    """Mutable physical execution properties of one pipeline.

    Everything here may be re-decided *after* planning: the planner
    writes its compile-time choices and estimates, and the runtime
    re-optimizer (``repro_torch.core.adaptive``) overwrites them at the stage
    barrier once upstream pipelines have published observed statistics.
    The logical content of the owning :class:`Pipeline` (op tree,
    semantic hash, dependencies, schema) is never touched at runtime —
    semantic hashing guarantees a re-parameterized pipeline still caches
    and dedups against its statically planned twin (section 3.4).
    """

    n_fragments: int
    partitioning: Partitioning
    # planner estimates (est vs actual shown by EXPLAIN ANALYZE)
    est_in_bytes: int = 0
    est_out_rows: int = -1              # -1 = no basis for an estimate
    est_out_bytes: int = -1
    # runtime adaptation state (set by core.adaptive at the barrier):
    # exchange sources to read broadcast (mode=all) instead of aligned
    # partitions — the shuffle→broadcast join downgrade
    broadcast_sources: list[str] = dataclasses.field(default_factory=list)
    # per-fragment upstream partition ids (shared by every aligned
    # partition-mode source); None = the static 1:1 fragment↔partition map
    partition_assignment: list[list[int]] | None = None
    # per-source surviving (non-empty) partition ids for pruning reads
    source_partitions: dict[str, list[int]] = \
        dataclasses.field(default_factory=dict)
    # estimated producer-side storage requests of this pipeline's output
    # exchange under the chosen strategy (EXPLAIN ANALYZE est vs actual)
    est_exchange_requests: int = 0
    # Semi-join filter pushdown (probe side of an annotated repartition
    # join): the build pipeline's sem hash, key columns, key mode, the
    # cost gate's verdict and estimates. The Reoptimizer may flip
    # ``enabled`` at pilot-K time from the observed build cardinality;
    # the sem hash already folds the build side, so filtered and
    # unfiltered runs share one cache entry.
    semijoin: dict | None = None
    # Build side of the same join: instructs the fleet to construct a
    # Bloom filter over its exchange keys and publish the merged words
    # through the partial-manifest protocol.
    bloom: dict | None = None


@dataclasses.dataclass
class Pipeline:
    """One pipeline: an immutable logical core plus mutable
    :class:`ExecutionParams`.

    After ``compile_query`` returns, the logical fields (``op``,
    ``sem_hash``, ``deps``, ``output_schema``, ``scan_units``) are
    frozen by contract; all runtime adaptation goes through ``params``.
    """

    pid: int
    sem_hash: str
    op: dict                       # serializable operator tree
    deps: list[int]
    params: ExecutionParams
    output_schema: list[dict]      # ColumnSpec dicts
    scan_units: list[str]          # table files (scan pipelines only)
    final: bool = False
    # fused Pallas kernel the fragment hot loop lowers to, or None — the
    # exec.lower pattern match is decided at plan time so EXPLAIN and
    # per-pipeline reports can show the dispatch without executing.
    # Misses carry the matcher's reason; matches the roofline-chosen
    # tiling estimates (block/resident rows, arithmetic intensity).
    kernel: str | None = None
    kernel_miss_reason: str | None = None
    kernel_roofline: dict | None = None

    # -- convenience views over the mutable params ------------------------
    @property
    def n_fragments(self) -> int:
        return self.params.n_fragments

    @property
    def partitioning(self) -> Partitioning:
        return self.params.partitioning

    @property
    def input_bytes(self) -> int:
        return self.params.est_in_bytes


@dataclasses.dataclass
class PhysicalPlan:
    pipelines: dict[int, Pipeline]
    root_pid: int
    output_names: list[str]

    def stages(self) -> list[list[int]]:
        """Topological stage order (pipelines grouped by dependency depth)."""
        depth: dict[int, int] = {}

        def d(pid: int) -> int:
            if pid not in depth:
                deps = self.pipelines[pid].deps
                depth[pid] = 1 + max((d(x) for x in deps), default=-1)
            return depth[pid]

        for pid in self.pipelines:
            d(pid)
        stages: dict[int, list[int]] = {}
        for pid, dep in depth.items():
            stages.setdefault(dep, []).append(pid)
        return [sorted(stages[k]) for k in sorted(stages)]


def _h(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:24]


def _schema_dicts(names_types) -> list[dict]:
    return [{"name": n, "kind": k, "dtype": dt} for n, k, dt in names_types]


class PhysicalPlanner:
    def __init__(self, catalog: Catalog,
                 config: PlannerConfig | None = None,
                 cost_model=None, calibration=None):
        # cost_model: repro_torch.core.cost.CostModel (built lazily when absent)
        # calibration: repro_torch.sql.calibration.SelectivityCalibration | None
        self.catalog = catalog
        self.config = config or PlannerConfig()
        if cost_model is None:
            from repro_torch.core.cost import CostModel
            cost_model = CostModel()
        self.cost_model = cost_model
        self.calibration = calibration
        self.pipelines: dict[int, Pipeline] = {}
        self._next_pid = 0

    # -- helpers ------------------------------------------------------------
    def _tables_version(self, node: LNode) -> str:
        tables = sorted({n.table for n in _walk(node)
                         if isinstance(n, LScan)})
        return _h([(t, tuple(self.catalog.table(t).files))
                   for t in tables])

    def _est(self, node: LNode) -> tuple[float, float]:
        """(rows, bytes) output estimate of a logical subtree.

        Replaces the old ``_subtree_bytes`` guess, which ignored
        ``LJoin.right`` entirely and charged one constant selectivity
        per filter node: joins now account for both sides (FK→PK match
        fraction from the build side's own selectivity), and filter
        selectivity is estimated per conjunct from catalog zone-map
        hints (numeric min/max ranges, dictionary cardinalities) when
        available, falling back to ``filter_selectivity_guess``.
        """
        if isinstance(node, LScan):
            meta = self.catalog.table(node.table)
            frac = len(node.schema_cols) / max(len(meta.schema), 1)
            return float(meta.rows), meta.total_bytes * frac
        if isinstance(node, LFilter):
            r, b = self._est(node.child)
            sel = self._selectivity(node.pred, node.child)
            cal = self._calibrated_est(node)
            if cal is not None:
                # downward-only: calibration tightens over-estimates;
                # under-estimates keep the conservative static figure so
                # adaptive fleets never exceed their static twin's size
                return min(r * sel, cal[0]), min(b * sel, cal[1])
            return r * sel, b * sel
        if isinstance(node, LProject):
            r, b = self._est(node.child)
            width = len(node.exprs) / max(
                len(_columns_of_logical(node.child)), 1)
            return r, b * min(1.0, width)
        if isinstance(node, LJoin):
            lr, lb = self._est(node.left)
            rr, rb = self._est(node.right)
            base = self._base_rows(node.right)
            match = min(1.0, rr / base) if base > 0 else 1.0
            jr = lr * match
            width = (lb / lr if lr > 0 else 0.0) + \
                (rb / rr if rr > 0 else 0.0)
            return jr, jr * width
        if isinstance(node, LAggregate):
            r, _ = self._est(node.child)
            _, sizes = self._agg_strategy(node)
            if not node.group_cols:
                k = 1.0
            elif sizes:
                k = float(np.prod(sizes))
            else:
                k = float(DIRECT_AGG_MAX_GROUPS)
            rows = min(r, k)
            width = 8.0 * (len(node.group_cols) + len(node.aggs))
            return rows, rows * width
        if isinstance(node, LLimit):
            r, b = self._est(node.child)
            per_row = b / r if r > 0 else 0.0
            rows = min(r, float(node.n))
            return rows, rows * per_row
        kids = node.children()
        if not kids:
            return 0.0, 0.0
        ests = [self._est(c) for c in kids]
        return sum(r for r, _ in ests), sum(b for _, b in ests)

    def _base_rows(self, node: LNode) -> float:
        """Unfiltered row count of the dominant base relation under
        ``node`` (the FK→PK match-fraction denominator)."""
        rows = [self.catalog.table(n.table).rows for n in _walk(node)
                if isinstance(n, LScan)]
        return float(max(rows)) if rows else 0.0

    # -- selectivity estimation ------------------------------------------------
    def _selectivity(self, pred: ast.Expr, child: LNode) -> float:
        sel = 1.0
        for c in ast.conjuncts(pred):
            sel *= self._conjunct_selectivity(c, child)
        return min(1.0, max(sel, 1e-4))

    def _conjunct_selectivity(self, c: ast.Expr, child: LNode) -> float:
        guess = self.config.filter_selectivity_guess
        if isinstance(c, ast.InList) and isinstance(c.term, ast.Col):
            ct = _column_type(child, c.term.name, self.catalog)
            if ct is not None and ct[0] == "dict" and ct[2]:
                return min(1.0, len(c.values) / max(len(ct[2]), 1))
            return guess
        if not isinstance(c, ast.Cmp):
            return guess
        if isinstance(c.left, ast.Col) and isinstance(c.right, ast.Lit):
            col, op, v = c.left.name, c.op, c.right.value
        elif isinstance(c.right, ast.Col) and isinstance(c.left, ast.Lit):
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                    "=": "=", "<>": "<>"}
            col, op, v = c.right.name, flip[c.op], c.left.value
        else:
            return guess            # column-column / expression compare
        if not isinstance(v, (int, float)):
            return guess
        hint = self._column_hint(child, col)
        if hint is None:
            return guess
        lo, hi = hint
        span = float(hi) - float(lo)
        if span <= 0:               # constant column: predicate is 0/1
            ops = {"<": v > lo, "<=": v >= lo, ">": v < lo, ">=": v <= lo,
                   "=": v == lo, "<>": v != lo}
            return 1.0 if ops[op] else 1e-4
        eq = 1.0 / (span + 1.0)     # uniform over an integer-ish domain
        frac = {
            "<": (v - lo) / span,
            "<=": (v - lo) / span + eq,
            ">": (hi - v) / span,
            ">=": (hi - v) / span + eq,
            "=": eq,
            "<>": 1.0 - eq,
        }[op]
        return min(1.0, max(frac, 1e-4))

    def _column_hint(self, node: LNode,
                     col: str) -> tuple[float, float] | None:
        """(min, max) range hint for a column produced by a subtree:
        catalog zone-map roll-ups for base columns, dictionary domains
        for dict columns, None for derived expressions."""
        if isinstance(node, LScan):
            meta = self.catalog.table(node.table)
            if not meta.has_column(col):
                return None
            r = meta.column_range(col)
            if r is not None:
                return r
            spec = meta.spec(col)
            if spec.kind == "dict" and spec.dictionary:
                return (0.0, float(len(spec.dictionary) - 1))
            return None
        if isinstance(node, (LFilter, LSort, LLimit, LAggregate)):
            return self._column_hint(node.child, col)
        if isinstance(node, LProject):
            for n, e in node.exprs:
                if n == col:
                    if isinstance(e, ast.Col):
                        return self._column_hint(node.child, e.name)
                    return None
            return None
        if isinstance(node, LJoin):
            return self._column_hint(node.left, col) or \
                self._column_hint(node.right, col)
        return None

    def _calibrated_est(self, node: LFilter) -> tuple[float, float] | None:
        """(rows, bytes) from a persisted cross-query selectivity
        observation of this exact filter chain over a base scan."""
        if self.calibration is None:
            return None
        from repro_torch.sql.calibration import predicate_key
        preds: list = []
        cur: LNode = node
        while isinstance(cur, LFilter):
            preds.append(cur.pred)
            cur = cur.child
        if not isinstance(cur, LScan):
            return None
        sel = self.calibration.lookup(
            cur.table, predicate_key([expr_to_dict(p) for p in preds]))
        if sel is None:
            return None
        meta = self.catalog.table(cur.table)
        frac = len(cur.schema_cols) / max(len(meta.schema), 1)
        return meta.rows * sel, meta.total_bytes * frac * sel

    def _workers_for_bytes(self, nbytes: int) -> int:
        c = self.config
        return max(1, min(c.max_workers,
                          -(-nbytes // c.bytes_per_worker)))

    def _tier_for_objects(self, objects: int) -> str:
        if objects > self.config.hot_shuffle_object_threshold:
            return "s3-express"
        return "s3-standard"

    def _pick_exchange(self, producers: int, keys, n_dest: int,
                       est_bytes: float) -> tuple[Partitioning, int]:
        """Choose the shuffle strategy (and tier) of one hash exchange
        via ``CostModel.exchange_cost``; returns the partitioning plus
        the estimated producer-side request count for EXPLAIN."""
        from repro_torch.exec.exchange import get_strategy
        forced = self.config.exchange_strategy
        nbytes = max(float(est_bytes), 0.0)
        if forced:
            strat = get_strategy(forced)
            tier = self._tier_for_objects(
                strat.written_objects(producers, n_dest))
            cost = self.cost_model.exchange_cost(
                producers, n_dest, nbytes, strategy=forced, tier=tier)
        else:
            cost, _ = self.cost_model.choose_exchange_strategy(
                producers, n_dest, nbytes, tier_for=self._tier_for_objects)
        strat = get_strategy(cost.strategy)
        part = Partitioning("hash", tuple(keys), n_dest, cost.tier,
                            cost.strategy)
        if cost.strategy == "multilevel":
            part.l0_tier = self.cost_model.l0_tier_choice(
                producers, nbytes, base_tier=cost.tier)
        return part, strat.producer_requests(producers, n_dest)

    def _new_pid(self) -> int:
        pid = self._next_pid
        self._next_pid += 1
        return pid

    # -- main entry ----------------------------------------------------------
    def compile(self, lqp: LNode) -> PhysicalPlan:
        # Peel final-stage nodes (project/sort/limit above aggregation).
        node = lqp
        limit = None
        sort_keys: list[tuple[str, bool]] = []
        if isinstance(node, LLimit):
            limit = node.n
            node = node.child
        if isinstance(node, LSort):
            sort_keys = list(node.keys)
            node = node.child
        post_project: tuple[tuple[str, ast.Expr], ...] | None = None
        agg_node = None
        if isinstance(node, LProject) and isinstance(node.child, LAggregate):
            post_project = node.exprs
            agg_node = node.child
            output_names = [n for n, _ in post_project]
        elif isinstance(node, LProject):
            output_names = [n for n, _ in node.exprs]
        else:
            output_names = sorted(_columns_of_logical(node))

        if agg_node is not None:
            root = self._compile_aggregate(agg_node, post_project,
                                           sort_keys, limit)
        else:
            root = self._compile_streaming_query(node, sort_keys, limit)
        return PhysicalPlan(self.pipelines, root, output_names)

    # -- streaming (no aggregate) ---------------------------------------------
    def _compile_streaming_query(self, node: LNode, sort_keys, limit) -> int:
        op, deps, units, in_bytes, sub = self._stream(node)
        sem = _h(("stream", sub.key(), self._tables_version(sub)))
        n_frag = min(self._workers_for_bytes(in_bytes),
                     max(len(units), 1)) if units else 1
        er, eb = self._est(node)
        schema = _output_schema_of(node, self.catalog)
        needs_final = bool(sort_keys) or limit is not None
        pid = self._new_pid()
        self.pipelines[pid] = Pipeline(
            pid, sem, op, deps,
            ExecutionParams(n_frag, Partitioning("none"),
                            est_in_bytes=in_bytes, est_out_rows=int(er),
                            est_out_bytes=int(eb)),
            schema, units, final=not needs_final)
        if not needs_final:
            return pid
        fsem = _h(("final", sub.key(), sort_keys, limit,
                   self._tables_version(sub)))
        fop = {"t": "final",
               "child": {"t": "scan_exchange", "source": sem,
                         "mode": "all"},
               "project": None,
               "sort_keys": [[k, d] for k, d in sort_keys],
               "limit": limit}
        fpid = self._new_pid()
        fr = min(er, limit) if limit is not None else er
        self.pipelines[fpid] = Pipeline(
            fpid, fsem, fop, [pid],
            ExecutionParams(1, Partitioning("none"),
                            est_in_bytes=int(eb), est_out_rows=int(fr)),
            schema, [], final=True)
        return fpid

    # -- aggregation queries ----------------------------------------------------
    def _compile_aggregate(self, agg: LAggregate, post_project,
                           sort_keys, limit) -> int:
        op, deps, units, in_bytes, sub = self._stream(agg.child)
        strategy, sizes = self._agg_strategy(agg)
        aggs_ser = [[name, fn, expr_to_dict(arg) if arg else None]
                    for name, fn, arg in agg.aggs]
        partial_op = {"t": "partial_agg", "child": op,
                      "group_cols": list(agg.group_cols),
                      "aggs": aggs_ser, "strategy": strategy,
                      "sizes": sizes}
        tv = self._tables_version(agg)
        partial_sem = _h(("partial_agg", agg.key(), tv))
        n_frag = min(self._workers_for_bytes(in_bytes),
                     max(len(units), 1)) if units else 1

        partial_schema = _agg_schema(agg, self.catalog)
        if strategy == "direct" or not agg.group_cols:
            n_dest, merge_frags = 1, 1
        else:
            n_dest = self.config.exchange_partitions or \
                max(1, min(n_frag, 16))
            merge_frags = n_dest
        er_child, eb_child = self._est(agg.child)
        ar, ab = self._est(agg)
        partial_rows = min(er_child, ar * n_frag)
        partial_bytes = min(eb_child, ab * n_frag)
        if n_dest > 1:
            part, est_xreq = self._pick_exchange(
                n_frag, agg.group_cols, n_dest, partial_bytes)
        else:
            part, est_xreq = Partitioning("none"), 0
        ppid = self._new_pid()
        self.pipelines[ppid] = Pipeline(
            ppid, partial_sem, partial_op, deps,
            ExecutionParams(n_frag, part, est_in_bytes=in_bytes,
                            est_out_rows=int(partial_rows),
                            est_out_bytes=int(partial_bytes),
                            est_exchange_requests=est_xreq),
            partial_schema, units)

        merge_aggs = [[name, {"sum": "sum", "count": "sum", "min": "min",
                              "max": "max"}[fn],
                       expr_to_dict(ast.Col(name))]
                      for name, fn, _ in agg.aggs]
        merge_child = {"t": "scan_exchange", "source": partial_sem,
                       "mode": "partition" if n_dest > 1 else "all"}
        merge_op: dict = {"t": "merge_agg", "child": merge_child,
                          "group_cols": list(agg.group_cols),
                          "aggs": merge_aggs, "strategy": strategy,
                          "sizes": sizes}
        if post_project is not None:
            merge_op = {"t": "project", "child": merge_op,
                        "exprs": [[n, expr_to_dict(e)]
                                  for n, e in post_project]}
            partial_types = {s["name"]: s for s in partial_schema}
            out_schema = []
            for n, e in post_project:
                if isinstance(e, ast.Col) and e.name in partial_types:
                    src = partial_types[e.name]
                    out_schema.append({"name": n, "kind": src["kind"],
                                       "dtype": src["dtype"]})
                else:
                    out_schema.append({"name": n, "kind": "num",
                                       "dtype": "<f8"})
        else:
            out_schema = partial_schema

        fold_final = merge_frags == 1
        merge_sem = _h(("merge_agg", agg.key(),
                        tuple((n, e.key()) for n, e in (post_project or ())),
                        tuple(sort_keys) if fold_final else (),
                        limit if fold_final else None, tv))
        if fold_final and (sort_keys or limit is not None):
            merge_op = {"t": "final", "child": merge_op, "project": None,
                        "sort_keys": [[k, d] for k, d in sort_keys],
                        "limit": limit}
        mpid = self._new_pid()
        mr = min(ar, limit) if fold_final and limit is not None else ar
        self.pipelines[mpid] = Pipeline(
            mpid, merge_sem, merge_op, [ppid],
            ExecutionParams(merge_frags, Partitioning("none"),
                            est_in_bytes=int(partial_bytes),
                            est_out_rows=int(mr), est_out_bytes=int(ab)),
            out_schema, [], final=fold_final)
        if fold_final:
            return mpid

        fsem = _h(("final", agg.key(),
                   tuple((n, e.key()) for n, e in (post_project or ())),
                   tuple(sort_keys), limit, tv))
        fop = {"t": "final",
               "child": {"t": "scan_exchange", "source": merge_sem,
                         "mode": "all"},
               "project": None,
               "sort_keys": [[k, d] for k, d in sort_keys],
               "limit": limit}
        fpid = self._new_pid()
        fr = min(ar, limit) if limit is not None else ar
        self.pipelines[fpid] = Pipeline(
            fpid, fsem, fop, [mpid],
            ExecutionParams(1, Partitioning("none"),
                            est_in_bytes=int(ab), est_out_rows=int(fr)),
            out_schema, [], final=True)
        return fpid

    def _agg_strategy(self, agg: LAggregate):
        sizes = []
        for c in agg.group_cols:
            ct = _column_type(agg.child, c, self.catalog)
            if ct is not None and ct[0] == "dict":
                sizes.append(len(ct[2]))
            else:
                return "sort", None
        import numpy as _np
        if not sizes:
            return "direct", []
        if int(_np.prod(sizes)) <= DIRECT_AGG_MAX_GROUPS:
            return "direct", sizes
        return "sort", None

    # -- streaming segment construction ------------------------------------------
    def _stream(self, node: LNode):
        """Compile a streamable subtree; returns
        (op_dict, pipeline_deps, scan_units, input_bytes, logical_subtree)."""
        if isinstance(node, LScan):
            meta = self.catalog.table(node.table)
            op = {"t": "scan_table", "table": node.table,
                  "columns": list(node.schema_cols), "zone_preds": []}
            frac = len(node.schema_cols) / max(len(meta.schema), 1)
            return op, [], list(meta.files), int(meta.total_bytes * frac), \
                node
        if isinstance(node, LFilter):
            op, deps, units, nbytes, sub = self._stream(node.child)
            if op["t"] == "scan_table":
                op["zone_preds"].extend(_zone_preds(node.pred))
            return ({"t": "filter", "child": op,
                     "pred": expr_to_dict(node.pred)},
                    deps, units, nbytes, node)
        if isinstance(node, LProject):
            op, deps, units, nbytes, sub = self._stream(node.child)
            return ({"t": "project", "child": op,
                     "exprs": [[n, expr_to_dict(e)] for n, e in node.exprs]},
                    deps, units, nbytes, node)
        if isinstance(node, LJoin):
            return self._stream_join(node)
        raise TypeError(f"not streamable: {node}")

    def _stream_join(self, node: LJoin):
        probe_op, probe_deps, units, in_bytes, _ = self._stream(node.left)
        prr, prb = self._est(node.left)      # probe exchange payload est
        brr, brb = self._est(node.right)     # build exchange payload est
        payload = sorted(_columns_of_logical(node.right))
        tv_b = self._tables_version(node.right)
        build_sem = _h(("build", node.right.key(), tv_b))

        bop, bdeps, bunits, bbytes, _ = self._stream(node.right)
        build_schema = _output_schema_of(node.right, self.catalog)
        bfrags = min(self._workers_for_bytes(bbytes),
                     max(len(bunits), 1)) if bunits else 1

        if brb <= self.config.broadcast_threshold_bytes:
            # Broadcast join: build side materializes unpartitioned; every
            # probe fragment reads all of it.
            bpid = self._new_pid()
            self.pipelines[bpid] = Pipeline(
                bpid, build_sem, bop, bdeps,
                ExecutionParams(bfrags, Partitioning("none"),
                                est_in_bytes=bbytes,
                                est_out_rows=int(brr),
                                est_out_bytes=int(brb)),
                build_schema, bunits)
            join_op = {"t": "join",
                       "probe": probe_op,
                       "build": {"t": "scan_exchange", "source": build_sem,
                                 "mode": "all"},
                       "probe_key": node.left_key,
                       "build_key": node.right_key,
                       "payload": payload}
            return join_op, probe_deps + [bpid], units, in_bytes, node

        # Repartition join: both sides exchange on the join key; the join
        # runs in a new pipeline with one fragment per hash bucket. The
        # fan-out is sized from the estimated *exchange payload* (filtered
        # output), not the scanned input.
        n_dest = self.config.exchange_partitions or \
            max(1, min(self._workers_for_bytes(int(max(prb, brb))), 16))
        probe_sem = _h(("exchange", node.left.key(), node.left_key,
                        self._tables_version(node.left)))
        probe_schema = _output_schema_of(node.left, self.catalog)
        pfrags = min(self._workers_for_bytes(in_bytes),
                     max(len(units), 1)) if units else 1
        ppart, pxreq = self._pick_exchange(pfrags, (node.left_key,),
                                           n_dest, prb)
        # Semi-join filter pushdown: when the build side's key admits a
        # side-consistent hash (dictionary codes don't — each side owns
        # its own code space), annotate the probe exchange with the
        # build's filter and fold the build identity into the probe sem
        # hash. The fold is unconditional for annotated joins — even if
        # the cost gate says no — so gate-on, gate-off, and runtime-
        # adopted runs share one cache entry, and a filtered probe
        # exchange can never be consumed by a query joining a different
        # build side. ``enabled`` is only the plan-time verdict; the
        # Reoptimizer revisits it at pilot-K time.
        sj = None
        if self.config.semijoin:
            sj_mode = _semijoin_mode(node, self.catalog)
            if sj_mode is not None:
                base = self._base_rows(node.right)
                match = min(1.0, brr / base) if base > 0 else 1.0
                distinct = max(int(brr), 1)
                ben = self.cost_model.semijoin_benefit(
                    producers=pfrags, n_dest=n_dest,
                    probe_bytes=max(prb, 0.0), match_fraction=match,
                    build_distinct=distinct, strategy=ppart.strategy,
                    tier=ppart.tier)
                sj = {"build": build_sem, "key": [node.left_key],
                      "mode": sj_mode,
                      "enabled": bool(ben["benefit_cents"] > 0),
                      "est_match": match, "est_distinct": distinct,
                      "est_rows": int(prr), "base_rows": base,
                      "n_dest": n_dest,
                      "benefit_cents": ben["benefit_cents"],
                      "kept_fraction": ben["kept_fraction"],
                      "fpr": ben["fpr"]}
                probe_sem = _h(("semijoin", probe_sem, build_sem))
        ppid = self._new_pid()
        self.pipelines[ppid] = Pipeline(
            ppid, probe_sem, probe_op, probe_deps,
            ExecutionParams(
                pfrags, ppart,
                est_in_bytes=in_bytes, est_out_rows=int(prr),
                est_out_bytes=int(prb), est_exchange_requests=pxreq,
                semijoin=sj),
            probe_schema, units)
        bpart, bxreq = self._pick_exchange(bfrags, (node.right_key,),
                                           n_dest, brb)
        bpid = self._new_pid()
        self.pipelines[bpid] = Pipeline(
            bpid, build_sem, bop, bdeps,
            ExecutionParams(
                bfrags, bpart,
                est_in_bytes=bbytes, est_out_rows=int(brr),
                est_out_bytes=int(brb), est_exchange_requests=bxreq,
                bloom=({"mode": sj["mode"],
                        "est_distinct": sj["est_distinct"]}
                       if sj else None)),
            build_schema, bunits)
        join_op = {"t": "join",
                   "probe": {"t": "scan_exchange", "source": probe_sem,
                             "mode": "partition"},
                   "build": {"t": "scan_exchange", "source": build_sem,
                             "mode": "partition"},
                   "probe_key": node.left_key,
                   "build_key": node.right_key,
                   "payload": payload}
        # The join continues streaming in a pipeline with n_dest fragments;
        # callers embed join_op and set deps/n_fragments accordingly via
        # the _JoinSegment marker.
        return join_op, [ppid, bpid, ("_n_frag", n_dest)], [], \
            in_bytes, node


# -- logical schema helpers ----------------------------------------------------

def _walk(node: LNode):
    yield node
    for c in node.children():
        yield from _walk(c)


def _columns_of_logical(node: LNode) -> set[str]:
    if isinstance(node, LScan):
        return set(node.schema_cols)
    if isinstance(node, LFilter):
        return _columns_of_logical(node.child)
    if isinstance(node, LProject):
        return {n for n, _ in node.exprs}
    if isinstance(node, LJoin):
        return _columns_of_logical(node.left) | \
            _columns_of_logical(node.right)
    if isinstance(node, LAggregate):
        return set(node.group_cols) | {n for n, _, _ in node.aggs}
    return _columns_of_logical(node.child)


def _column_type(node: LNode, col: str, catalog: Catalog):
    """(kind, dtype, dictionary) for a column produced by a subtree."""
    if isinstance(node, LScan):
        meta = catalog.table(node.table)
        if meta.has_column(col):
            s = meta.spec(col)
            return (s.kind, s.dtype, s.dictionary)
        return None
    if isinstance(node, (LFilter, LSort, LLimit)):
        return _column_type(node.child, col, catalog)
    if isinstance(node, LProject):
        for n, e in node.exprs:
            if n == col:
                if isinstance(e, ast.Col):
                    return _column_type(node.child, e.name, catalog)
                return ("num", "<f8", None)
        return None
    if isinstance(node, LJoin):
        return _column_type(node.left, col, catalog) or \
            _column_type(node.right, col, catalog)
    if isinstance(node, LAggregate):
        if col in node.group_cols:
            return _column_type(node.child, col, catalog)
        for n, fn, _ in node.aggs:
            if n == col:
                return ("num", "<i8" if fn == "count" else "<f8", None)
        return None
    raise TypeError(node)


def _semijoin_mode(node: LJoin, catalog: Catalog) -> str | None:
    """Key-hash mode for a semi-join filter on ``node``'s join key, or
    None if the key cannot be hashed consistently on both sides.

    Dictionary-encoded keys are ineligible: each side assigns its own
    code space, so hashing codes risks false *negatives* — the one
    failure mode a semi-join filter must never have. ``u32`` (truncating
    cast, kernel-eligible) needs integer keys on both sides; any other
    numeric pair falls back to the 64-bit column hash.
    """
    lt = _column_type(node.left, node.left_key, catalog)
    rt = _column_type(node.right, node.right_key, catalog)
    if not lt or not rt or lt[0] != "num" or rt[0] != "num":
        return None

    def _is_int(dtype: str) -> bool:
        return "i" in dtype or "u" in dtype

    if _is_int(lt[1]) and _is_int(rt[1]):
        return "u32"
    return "hash64"


def _output_schema_of(node: LNode, catalog: Catalog) -> list[dict]:
    out = []
    for c in sorted(_columns_of_logical(node)):
        ct = _column_type(node, c, catalog)
        kind, dtype, _ = ct if ct else ("num", "<f8", None)
        if kind == "bytes":
            continue  # opaque strings are pruned before execution
        out.append({"name": c, "kind": kind, "dtype": dtype})
    return out


def _agg_schema(agg: LAggregate, catalog: Catalog) -> list[dict]:
    out = []
    for c in agg.group_cols:
        ct = _column_type(agg.child, c, catalog)
        kind, dtype, _ = ct if ct else ("num", "<i8", None)
        out.append({"name": c, "kind": kind, "dtype": "<i8"})
    for name, fn, _ in agg.aggs:
        out.append({"name": name, "kind": "num", "dtype": "<f8"})
    return out


def _project_schema(exprs) -> list[dict]:
    return [{"name": n, "kind": "num", "dtype": "<f8"} for n, _ in exprs]


def _zone_preds(pred: ast.Expr) -> list[list]:
    """Extract (col, op, literal) conjuncts usable for row-group pruning."""
    out = []
    for c in ast.conjuncts(pred):
        if isinstance(c, ast.Cmp) and isinstance(c.left, ast.Col) \
                and isinstance(c.right, ast.Lit) and c.op != "<>":
            op = "==" if c.op == "=" else c.op
            out.append([c.left.name, op, c.right.value])
        elif isinstance(c, ast.Cmp) and isinstance(c.right, ast.Col) \
                and isinstance(c.left, ast.Lit) and c.op != "<>":
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=="}
            out.append([c.right.name, flip[c.op], c.left.value])
        elif isinstance(c, ast.InList) and isinstance(c.term, ast.Col) \
                and all(isinstance(v, ast.Lit) for v in c.values):
            out.append([c.term.name, "in",
                        [v.value for v in c.values]])
    return out


def compile_query(lqp: LNode, catalog: Catalog,
                  config: PlannerConfig | None = None,
                  cost_model=None, calibration=None) -> PhysicalPlan:
    planner = PhysicalPlanner(catalog, config, cost_model=cost_model,
                              calibration=calibration)
    plan = planner.compile(lqp)
    _fix_join_segments(plan, planner)
    _annotate_kernels(plan)
    return plan


def _annotate_kernels(plan: PhysicalPlan) -> None:
    """Record which pipelines the kernel dispatch layer will lower —
    kernel name and roofline tiling on a match, the matcher's miss
    reason otherwise (``final`` ops dispatch on their child when the
    top-k arm misses; ``kernel_info`` handles that)."""
    from repro_torch.exec.lower import enabled, kernel_info
    if not enabled():
        return
    for p in plan.pipelines.values():
        info = kernel_info(p.op)
        p.kernel = info["kernel"]
        p.kernel_miss_reason = info["miss"]
        p.kernel_roofline = info["tiling"]


def _fix_join_segments(plan: PhysicalPlan,
                       planner: PhysicalPlanner) -> None:
    """Resolve the ('_n_frag', D) markers emitted for repartition joins:
    the pipeline embedding such a join must have D fragments and no scan
    units — and its own output exchange, if any, is re-picked for the
    corrected producer count."""
    for p in plan.pipelines.values():
        markers = [d for d in p.deps if isinstance(d, tuple)]
        if markers:
            p.deps = [d for d in p.deps if not isinstance(d, tuple)]
            p.params.n_fragments = markers[0][1]
            p.scan_units = []
            part = p.params.partitioning
            if part.kind == "hash":
                p.params.partitioning, p.params.est_exchange_requests = \
                    planner._pick_exchange(p.params.n_fragments,
                                           part.keys, part.n_dest,
                                           p.params.est_out_bytes)
