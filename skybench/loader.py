"""Load the benchmark's tables into the system under test.

The tables come from ``skybench.tpchgen``; they go into the object store
through the port's own SPAX writer and catalog, as the port's
``ensure_tpch`` writes them: lineitem and orders in their partitions,
every other table one object, row groups of ``row_group_rows``, and the
catalog's per-column (min, max) hints, saved under ``tpch/sf<sf>``.
"""

from __future__ import annotations

import numpy as np

from skybench import tpchgen


def load(store, parts: dict[str, list[dict]], sf: float,
         row_group_rows: int, pool=None):
    """Write ``parts`` (``tpchgen.generate``'s tables) into ``store`` and
    return the port's catalog of them. SPAX encoding runs on ``pool``
    where given."""
    from repro_torch.data.catalog import Catalog, TableMeta
    from repro_torch.storage.pax import ColumnSpec, write_pax

    prefix = f"tpch/sf{sf:g}"
    schemas = {t: [ColumnSpec(*c) for c in cols]
               for t, cols in tpchgen.SCHEMAS.items()}
    jobs = [(t, i, cols) for t, ps in parts.items()
            for i, cols in enumerate(ps)]

    def encode(job):
        table, _, cols = job
        return write_pax(cols, schemas[table], row_group_rows)

    blobs = list(pool.map(encode, jobs)) if pool is not None \
        else [encode(j) for j in jobs]
    catalog = Catalog()
    for table, schema in schemas.items():
        files, rows, nbytes = [], 0, 0
        stats: dict[str, tuple] = {}
        for (t, i, cols), blob in zip(jobs, blobs):
            if t != table:
                continue
            key = f"{prefix}/{table}/part-{i:05d}.spax"
            store.put(key, blob)
            files.append(key)
            rows += len(next(iter(cols.values())))
            nbytes += len(blob)
            for c in schema:
                if c.kind not in ("num", "dict") or not len(cols[c.name]):
                    continue
                lo = np.min(cols[c.name]).item()
                hi = np.max(cols[c.name]).item()
                if c.name in stats:
                    lo, hi = min(lo, stats[c.name][0]), \
                        max(hi, stats[c.name][1])
                stats[c.name] = (lo, hi)
        catalog.add(TableMeta(table, schema, files, rows, nbytes, stats))
    catalog.save(store, f"{prefix}/catalog")
    return catalog
