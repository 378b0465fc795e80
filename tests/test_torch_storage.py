"""The port's host copies against the reference: the msgpack codec, SPAX
objects, catalogs and whole stores, read across packages."""

import math

import msgpack
import numpy as np
import pytest

import repro.api as ref_api
from repro.data import generate_tpch as ref_generate
from repro.storage import InputHandler as RefInput
from repro.storage import ObjectStore as RefStore
from repro.storage.pax import ColumnSpec as RefSpec
from repro.storage.pax import write_pax as ref_write_pax
import repro_torch.api as port_api
from repro_torch.data import generate_tpch as port_generate
from repro_torch.sql.queries import QUERIES
from repro_torch.storage import InputHandler as PortInput
from repro_torch.storage import ObjectStore as PortStore
from repro_torch.storage import msgpack_codec as codec
from repro_torch.storage.pax import ColumnSpec as PortSpec
from repro_torch.storage.pax import write_pax as port_write_pax

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
        2**63, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
        -2**31, -2**31 - 1, -2**63]
LENS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def _values():
    out = list(INTS) + [0.0, -1.5, 1e300, math.inf, -math.inf, True, False,
                        None, "é", "a\x00b"]
    out += ["s" * n for n in LENS] + [b"\x01" * n for n in LENS]
    out += [list(range(n)) for n in (0, 15, 16, 70000)]
    out += [tuple(range(3)), {}, {str(i): i for i in range(15)},
            {str(i): [i, {"x": b"y"}] for i in range(16)},
            {"nested": {"deep": [1.25, None, "z", {"k": -7}]}, b"b": 1}]
    return out


@pytest.mark.parametrize("value", _values(),
                         ids=lambda v: type(v).__name__)
def test_codec_bytes_equal_msgpack(value):
    want = msgpack.packb(value)
    assert codec.packb(value) == want
    back = codec.unpackb(want)
    assert back == msgpack.unpackb(want)


def test_codec_float_nan_and_map_key_rules():
    assert codec.packb(math.nan) == msgpack.packb(math.nan)
    assert math.isnan(codec.unpackb(msgpack.packb(math.nan)))
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb({1: 2}))       # strict_map_key
    with pytest.raises(ValueError):
        msgpack.unpackb(msgpack.packb({1: 2}))
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb(1) + b"\x01")   # extra data


@pytest.mark.parametrize("bad", [np.int64(3), {1, 2}, object(), 2**64,
                                 -2**63 - 1, np.bool_(True)],
                         ids=lambda v: type(v).__name__)
def test_codec_raises_where_msgpack_raises(bad):
    with pytest.raises((TypeError, OverflowError)) as want:
        msgpack.packb(bad)
    with pytest.raises(want.type):
        codec.packb(bad)


def test_codec_on_everything_a_q1_q6_run_stores(monkeypatch):
    """Footers, catalog, registry entries and manifests: each object the
    port packs equals msgpack's bytes and reads back the same."""
    seen = []
    packb = codec.packb

    def record(obj):
        data = packb(obj)
        seen.append((obj, data))
        return data
    monkeypatch.setattr(codec, "packb", record)
    s = port_api.connect(tier="local", quota=8, device="cpu")
    try:
        s.ensure_tpch(sf=0.01, n_parts=4)
        for q in ("q6", "q1"):
            s.sql(QUERIES[q])
    finally:
        s.close()
    kinds = set()
    for obj, data in seen:
        assert data == msgpack.packb(obj)
        assert codec.unpackb(data) == msgpack.unpackb(data)
        kinds.add(frozenset(obj) if isinstance(obj, dict) else frozenset())
    assert any({"codec", "row_groups"} <= k for k in kinds)   # SPAX footers
    assert frozenset({"tables"}) in kinds                     # catalog
    assert any({"done", "n_producers"} <= k for k in kinds)   # manifests
    assert any({"complete", "partitioning"} <= k for k in kinds)  # registry


@pytest.fixture(scope="module")
def both_generated():
    ref, port = RefStore(tier="local", seed=0), PortStore(tier="local",
                                                           seed=0)
    ref_generate(ref, sf=0.01, n_parts=4, seed=0)
    port_generate(port, sf=0.01, n_parts=4, seed=0)
    return ref, port


def test_generator_writes_byte_identical_objects(both_generated):
    ref, port = both_generated
    keys = ref.list("tpch/")
    assert keys and keys == port.list("tpch/")
    for k in keys:
        assert ref.get(k).data == port.get(k).data, k


def _spax_table(seed):
    rng = np.random.default_rng(seed)
    n = 5000
    return {"a": rng.integers(0, 10**9, n).astype(np.int64),
            "b": rng.normal(size=n),
            "c": rng.integers(0, 3, n).astype(np.int32)}


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_spax_objects_read_across_packages(direction):
    cols = _spax_table(1)
    specs = [("a", "num", "<i8"), ("b", "num", "<f8"),
             ("c", "dict", "<i4", ("x", "y", "z"))]
    if direction == "ref_to_port":
        data = ref_write_pax(cols, [RefSpec(*s) for s in specs])
        store, reader = PortStore(tier="local"), PortInput
    else:
        data = port_write_pax(cols, [PortSpec(*s) for s in specs])
        store, reader = RefStore(tier="local"), RefInput
    store.put("t.spax", data)
    got, footer, _ = reader(store).read_table("t.spax")
    assert footer.n_rows == 5000
    for c, v in cols.items():
        np.testing.assert_array_equal(got[c], v)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_store_written_by_either_package_opens_in_the_other(tmp_path,
                                                              writer):
    first, second = ((ref_api, port_api) if writer == "ref"
                     else (port_api, ref_api))
    kw = {"device": "cpu"} if first is port_api else {}
    s1 = first.connect(store_dir=str(tmp_path), tier="local", **kw)
    s1.ensure_tpch(sf=0.01, n_parts=4)
    s1.close()
    kw = {"device": "cpu"} if second is port_api else {}
    s2 = second.connect(store_dir=str(tmp_path), tier="local", **kw)
    try:
        cat = s2.ensure_tpch(sf=0.01, n_parts=4)       # loads, no rewrite
        meta = cat.tables["lineitem"]
        assert len(meta.files) == 4
        handler = (PortInput if second is port_api else RefInput)(s2.store)
        rows = sum(len(handler.read_table(f, ["l_orderkey"])[0]
                       ["l_orderkey"]) for f in meta.files)
        assert rows == meta.rows > 0
    finally:
        s2.close()
