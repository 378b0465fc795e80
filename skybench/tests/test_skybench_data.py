"""The benchmark's frozen tables against the port's generator, and its
loader against the port's ``ensure_tpch``."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from skybench import loader, tpchgen  # noqa: E402

SF, SEED = 0.01, 20260418


@pytest.fixture(scope="module")
def port():
    from repro_torch.api import connect
    s = connect(device="cpu")
    s.ensure_tpch(sf=SF, seed=SEED, n_parts=3)
    yield s
    s.close()


def _read(store, catalog):
    from repro_torch.storage import InputHandler
    ih = InputHandler(store)
    out = {}
    for name, meta in catalog.tables.items():
        parts = [ih.read_table(f)[0] for f in meta.files]
        out[name] = {c.name: np.concatenate([p[c.name] for p in parts])
                     for c in meta.schema}
    return out


def test_frozen_tables_equal_what_the_port_writes(port):
    mine = {t: tpchgen.concat(p)
            for t, p in tpchgen.generate(SF, SEED, 3).items()}
    theirs = _read(port.store, port.catalog)
    assert sorted(mine) == sorted(theirs)
    for t in theirs:
        assert sorted(mine[t]) == sorted(theirs[t]), t
        for c in theirs[t]:
            assert mine[t][c].dtype == theirs[t][c].dtype, (t, c)
            np.testing.assert_array_equal(mine[t][c], theirs[t][c],
                                          err_msg=f"{t}.{c}")


def test_loader_writes_the_catalog_ensure_tpch_writes(port):
    from repro_torch.storage.object_store import ObjectStore
    store = ObjectStore()
    cat = loader.load(store, tpchgen.generate(SF, SEED, 3), SF, 65536)
    ref = port.catalog
    assert sorted(cat.tables) == sorted(ref.tables)
    for name, meta in ref.tables.items():
        mine = cat.tables[name]
        assert mine.files == meta.files
        assert mine.rows == meta.rows
        assert mine.schema == meta.schema
        assert mine.column_stats == meta.column_stats
    assert _read(store, cat).keys() == _read(port.store, ref).keys()


def test_partitions_follow_the_ports_default():
    assert tpchgen.n_parts_default(1) == 6
    assert tpchgen.n_parts_default(0.01) == 1
    parts = tpchgen.generate(0.01, 1)
    assert len(parts["lineitem"]) == len(parts["orders"]) == 1
    assert all(len(parts[t]) == 1 for t in ("part", "customer", "region"))


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40, -7])
def test_the_same_seed_makes_the_same_tables(seed):
    a = tpchgen.generate(0.001, seed)
    b = tpchgen.generate(0.001, seed)
    for t in a:
        for c in a[t][0]:
            np.testing.assert_array_equal(a[t][0][c], b[t][0][c])
