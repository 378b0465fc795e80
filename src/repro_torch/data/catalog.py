"""External database catalog (the paper's Glue analog, section 3.2).

Maps table names to schemas, partition file lists, global dictionaries, and
simple statistics (row/byte counts). The logical planner validates column
references against it; the physical planner sizes worker fleets from its
byte statistics. Persisted as a msgpack object in the object store so the
coordinator — itself a stateless function — can reconstruct all state.
"""

from __future__ import annotations

import dataclasses

from repro_torch.storage import msgpack_codec as msgpack

from repro_torch.storage.object_store import ObjectStore
from repro_torch.storage.pax import ColumnSpec


@dataclasses.dataclass
class TableMeta:
    name: str
    schema: list[ColumnSpec]
    files: list[str]
    rows: int
    total_bytes: int
    # Per-column (min, max) zone-map hints for num/dict columns, rolled up
    # from the partition-file zone maps at generation time. Optional: the
    # planner's selectivity estimator falls back to its constant guess for
    # columns (or whole catalogs) without hints.
    column_stats: dict[str, tuple[float, float]] = \
        dataclasses.field(default_factory=dict)

    def spec(self, column: str) -> ColumnSpec:
        for c in self.schema:
            if c.name == column:
                return c
        raise KeyError(f"{self.name}.{column}")

    def has_column(self, column: str) -> bool:
        return any(c.name == column for c in self.schema)

    def column_range(self, column: str) -> tuple[float, float] | None:
        """(min, max) hint for a column, or None when unknown."""
        r = self.column_stats.get(column)
        return (r[0], r[1]) if r is not None else None


@dataclasses.dataclass
class Catalog:
    tables: dict[str, TableMeta] = dataclasses.field(default_factory=dict)

    def add(self, meta: TableMeta) -> None:
        self.tables[meta.name] = meta

    def table(self, name: str) -> TableMeta:
        if name not in self.tables:
            raise KeyError(f"unknown table: {name}")
        return self.tables[name]

    def resolve_column(self, column: str,
                       tables: list[str]) -> tuple[str, ColumnSpec]:
        hits = [(t, self.tables[t].spec(column)) for t in tables
                if self.tables[t].has_column(column)]
        if not hits:
            raise KeyError(f"column {column} not found in {tables}")
        if len(hits) > 1:
            raise KeyError(f"ambiguous column {column} in {tables}")
        return hits[0]

    # -- persistence --------------------------------------------------------
    def to_bytes(self) -> bytes:
        return msgpack.packb({
            "tables": {
                name: {
                    "schema": [
                        {"name": c.name, "kind": c.kind, "dtype": c.dtype,
                         "dict": list(c.dictionary) if c.dictionary else None}
                        for c in t.schema],
                    "files": t.files,
                    "rows": t.rows,
                    "total_bytes": t.total_bytes,
                    "column_stats": {c: [v[0], v[1]]
                                     for c, v in t.column_stats.items()},
                } for name, t in self.tables.items()
            }
        })

    @classmethod
    def from_bytes(cls, data: bytes) -> "Catalog":
        raw = msgpack.unpackb(data)
        cat = cls()
        for name, t in raw["tables"].items():
            schema = [ColumnSpec(c["name"], c["kind"], c["dtype"],
                                 tuple(c["dict"]) if c["dict"] else None)
                      for c in t["schema"]]
            cat.add(TableMeta(name, schema, list(t["files"]), t["rows"],
                              t["total_bytes"],
                              {c: (v[0], v[1]) for c, v in
                               (t.get("column_stats") or {}).items()}))
        return cat

    def save(self, store: ObjectStore, key: str) -> None:
        store.put(key, self.to_bytes())

    @classmethod
    def load(cls, store: ObjectStore, key: str) -> "Catalog":
        return cls.from_bytes(store.get(key).data)
