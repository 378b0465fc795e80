"""PAX-style columnar file format ("SPAX") for object storage.

Mirrors the Parquet/ORC layout the paper's storage stack targets (section
3.4): a file holds row groups; each row group holds one compressed chunk per
column; a footer indexes chunk byte ranges and per-chunk min/max zone maps so
readers fetch *only relevant columns and rows* via ranged requests.

Column kinds:
  * ``num``   — fixed-width numeric (int32/int64/float32/float64); dates are
                int32 days since 1970-01-01.
  * ``dict``  — low-cardinality strings stored as int32 codes against a
                dictionary recorded in the footer. Dictionaries are assigned
                globally by the data generator/catalog so codes are
                consistent across partition files.
  * ``bytes`` — fixed-width opaque bytes (high-cardinality strings); stored
                and round-tripped but not computable inside XLA programs.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Callable, Sequence

from repro_torch.storage import msgpack_codec as msgpack
import numpy as np

from repro_torch.storage import compression

MAGIC = b"SPAX1\x00"
TAIL_LEN = 4 + len(MAGIC)  # u32 footer length + magic

_COMPRESS_LEVEL = 3


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    name: str
    kind: str                    # num | dict | bytes
    dtype: str                   # numpy dtype string, e.g. "<i4", "S10"
    dictionary: tuple[str, ...] | None = None

    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)


@dataclasses.dataclass
class ChunkMeta:
    off: int
    length: int
    raw_len: int
    vmin: float | int | None
    vmax: float | int | None


@dataclasses.dataclass
class RowGroupMeta:
    n_rows: int
    chunks: dict[str, ChunkMeta]


@dataclasses.dataclass
class PaxFooter:
    n_rows: int
    columns: list[ColumnSpec]
    row_groups: list[RowGroupMeta]
    codec: str = "zstd"

    def spec(self, name: str) -> ColumnSpec:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)


def _stats(spec: ColumnSpec, arr: np.ndarray):
    if spec.kind in ("num", "dict") and arr.size:
        return arr.min().item(), arr.max().item()
    return None, None


def _group_bounds(n_rows: int, row_group_rows: int,
                  splits: Sequence[int] | None) -> list[tuple[int, int]]:
    """(start, stop) row-group bounds: fixed-size groups by default;
    ``splits`` forces group boundaries at the given row indices (an
    exchange writer splits at partition boundaries so zone maps on the
    destination column prune exactly), with oversized segments still
    chunked to ``row_group_rows``."""
    if not splits:
        return [(s, min(s + row_group_rows, n_rows))
                for s in range(0, max(n_rows, 1), row_group_rows)]
    edges = sorted({0, n_rows, *(s for s in splits if 0 < s < n_rows)})
    out = []
    for lo, hi in zip(edges, edges[1:]):
        for s in range(lo, hi, row_group_rows):
            out.append((s, min(s + row_group_rows, hi)))
    return out or [(0, 0)]


def write_pax(columns: dict[str, np.ndarray],
              schema: Sequence[ColumnSpec],
              row_group_rows: int = 65536,
              codec: str | None = None,
              splits: Sequence[int] | None = None) -> bytes:
    """Serialize columns (all equal length) to SPAX bytes.

    ``codec`` defaults to zstd when available, else zlib; the choice is
    recorded in the footer so readers dispatch per file. ``splits``
    forces row-group boundaries at the given row indices.
    """
    codec = codec or compression.DEFAULT_CODEC
    names = [c.name for c in schema]
    assert set(names) == set(columns), (names, list(columns))
    n_rows = len(columns[names[0]]) if names else 0
    for c in schema:
        arr = columns[c.name]
        assert len(arr) == n_rows, (c.name, len(arr), n_rows)
        assert arr.dtype == c.np_dtype(), (c.name, arr.dtype, c.dtype)

    buf = io.BytesIO()
    buf.write(MAGIC)
    row_groups: list[RowGroupMeta] = []
    for start, stop in _group_bounds(n_rows, row_group_rows, splits):
        if stop <= start and row_groups:
            break
        chunks: dict[str, ChunkMeta] = {}
        for c in schema:
            arr = np.ascontiguousarray(columns[c.name][start:stop])
            raw = arr.tobytes()
            comp = compression.compress(raw, codec, level=_COMPRESS_LEVEL)
            off = buf.tell()
            buf.write(comp)
            vmin, vmax = _stats(c, arr)
            chunks[c.name] = ChunkMeta(off, len(comp), len(raw), vmin, vmax)
        row_groups.append(RowGroupMeta(stop - start, chunks))
        if stop >= n_rows:
            break

    footer = {
        "version": 1,
        "codec": codec,
        "n_rows": n_rows,
        "columns": [
            {"name": c.name, "kind": c.kind, "dtype": c.dtype,
             "dict": list(c.dictionary) if c.dictionary else None}
            for c in schema
        ],
        "row_groups": [
            {"n_rows": rg.n_rows,
             "chunks": {
                 n: {"off": m.off, "len": m.length, "raw_len": m.raw_len,
                     "min": m.vmin, "max": m.vmax}
                 for n, m in rg.chunks.items()}}
            for rg in row_groups
        ],
    }
    footer_bytes = msgpack.packb(footer)
    buf.write(footer_bytes)
    buf.write(np.uint32(len(footer_bytes)).tobytes())
    buf.write(MAGIC)
    return buf.getvalue()


def parse_footer(footer_bytes: bytes) -> PaxFooter:
    raw = msgpack.unpackb(footer_bytes)
    columns = [
        ColumnSpec(c["name"], c["kind"], c["dtype"],
                   tuple(c["dict"]) if c["dict"] else None)
        for c in raw["columns"]
    ]
    row_groups = [
        RowGroupMeta(
            rg["n_rows"],
            {n: ChunkMeta(m["off"], m["len"], m["raw_len"], m["min"], m["max"])
             for n, m in rg["chunks"].items()})
        for rg in raw["row_groups"]
    ]
    return PaxFooter(raw["n_rows"], columns, row_groups,
                     raw.get("codec", "zstd"))


def footer_byte_range(file_size: int, tail: bytes) -> tuple[int, int]:
    """Given the file's trailing TAIL_LEN bytes, locate the footer."""
    assert tail[-len(MAGIC):] == MAGIC, "not a SPAX file"
    footer_len = int(np.frombuffer(tail[:4], np.uint32)[0])
    return file_size - TAIL_LEN - footer_len, footer_len


def decompress_chunk(spec: ColumnSpec, meta_raw_len: int,
                     comp: bytes, codec: str = "zstd") -> np.ndarray:
    raw = compression.decompress(comp, codec,
                                 max_output_size=meta_raw_len)
    return np.frombuffer(raw, dtype=spec.np_dtype())


# -- ranged-read planning ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChunkRequest:
    """One (row group, column) chunk a reader must fetch."""

    group: int
    column: str
    off: int
    length: int


def plan_chunk_requests(footer: PaxFooter, names: Sequence[str],
                        groups: Sequence[int]) -> list[ChunkRequest]:
    """The chunk fetches for a projection over surviving row groups,
    ordered by file offset (the write order interleaves columns within a
    row group, so adjacent chunks of one projection are often adjacent
    in the file)."""
    reqs = [ChunkRequest(gi, n, footer.row_groups[gi].chunks[n].off,
                         footer.row_groups[gi].chunks[n].length)
            for gi in groups for n in names]
    reqs.sort(key=lambda r: r.off)
    return reqs


def coalesce_ranges(reqs: Sequence[ChunkRequest],
                    gap: int) -> list[tuple[int, int, list[ChunkRequest]]]:
    """Merge offset-sorted chunk requests into ranged GETs.

    Requests whose byte ranges are adjacent or separated by at most
    ``gap`` wasted bytes share one GET (Lambada-style request batching:
    per-request cost dominates small reads, so a bounded amount of
    discarded bytes buys a large request-count reduction). Returns
    ``(off, length, members)`` triples covering every request.
    """
    out: list[tuple[int, int, list[ChunkRequest]]] = []
    for r in reqs:
        if out:
            off, length, members = out[-1]
            if r.off <= off + length + gap:
                end = max(off + length, r.off + r.length)
                out[-1] = (off, end - off, members + [r])
                continue
        out.append((r.off, r.length, [r]))
    return out


# -- zone-map predicate pruning ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class ZonePredicate:
    """Conjunct usable for row-group pruning: ``col op literal``.

    ``op`` in {"<", "<=", ">", ">=", "==", "in"}. For dict columns the
    literal(s) must already be dictionary codes (the planner rewrites string
    literals via the catalog dictionary — including LIKE-prefix → IN-codes).
    """

    column: str
    op: str
    value: float | int | tuple

    def may_match(self, vmin, vmax) -> bool:
        if vmin is None or vmax is None:
            return True
        v = self.value
        if self.op == "<":
            return vmin < v
        if self.op == "<=":
            return vmin <= v
        if self.op == ">":
            return vmax > v
        if self.op == ">=":
            return vmax >= v
        if self.op == "==":
            return vmin <= v <= vmax
        if self.op == "in":
            return any(vmin <= x <= vmax for x in v)
        return True


def surviving_row_groups(footer: PaxFooter,
                         predicates: Sequence[ZonePredicate]) -> list[int]:
    """Indices of row groups that may contain matching rows."""
    out = []
    for i, rg in enumerate(footer.row_groups):
        keep = True
        for p in predicates:
            meta = rg.chunks.get(p.column)
            if meta is None:
                continue
            if not p.may_match(meta.vmin, meta.vmax):
                keep = False
                break
        if keep:
            out.append(i)
    return out
