"""The parameter draw (TPC-H section 2.4) and the traffic generator."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from skybench import qgen, workload  # noqa: E402

BENCH = ROOT / "skybench"
SEEDS = [1, 987654321, 2**31 + 5, 2**33 + 1]


def test_validation_texts_are_the_ports():
    from repro_torch.sql.queries import QUERIES
    for q in qgen.QUERIES:
        assert qgen.render(q, qgen.VALIDATION[q]) == QUERIES[q], q


def _within_ranges(q, p):
    if q == "q1":
        return 60 <= p["delta"] <= 120
    if q == "q3":
        d = int(p["date"][-2:])
        return p["segment"] in qgen.SEGMENTS and \
            p["date"].startswith("1995-03-") and 1 <= d <= 31
    if q == "q6":
        return p["year"] in qgen.YEARS and 2 <= p["discount"] <= 9 \
            and p["quantity"] in (24, 25)
    if q == "q12":
        return p["mode1"] in qgen.SHIPMODES and p["mode2"] in qgen.SHIPMODES \
            and p["mode1"] != p["mode2"] and p["year"] in qgen.YEARS
    if q == "q14":
        return p["year"] in qgen.YEARS and 1 <= p["month"] <= 12
    return (1 <= p["qty1"] <= 10 and 10 <= p["qty2"] <= 20
            and 20 <= p["qty3"] <= 30
            and all(p[f"brand{i}"] // 10 in range(1, 6)
                    and p[f"brand{i}"] % 10 in range(1, 6)
                    for i in (1, 2, 3)))


@pytest.mark.parametrize("seed", SEEDS)
def test_draw_stays_within_the_specs_ranges(seed):
    for q, p, text in workload.sequence(
            workload.load("adhoc", BENCH), seed):
        assert _within_ranges(q, p), (q, p)
        assert text == qgen.render(q, p)


def test_spaces_are_the_specs_less_the_validation_set():
    sizes = {"q1": 61, "q3": 155, "q6": 80, "q12": 105, "q14": 60}
    for q, n in sizes.items():
        assert len(qgen.space(q)) == n - 1, q


@pytest.mark.parametrize("clients", [1, 4])
@pytest.mark.parametrize("seed", SEEDS)
def test_no_text_repeats_before_its_space_is_spent(clients, seed):
    seq = workload.sequence(dict(workload.load("adhoc", BENCH),
                                 clients=clients), seed)
    validation = {qgen.render(q, qgen.VALIDATION[q]) for q in qgen.QUERIES}
    for q in qgen.QUERIES:
        texts = [t for k, _, t in seq if k == q]
        room = len(qgen.space(q) or texts)
        assert len(set(texts[:room])) == min(room, len(texts)), q
        assert not validation & set(texts), q
    # a client's whole list never repeats a text
    first = [t for _, _, t in seq[:200]]
    assert len(set(first)) == len(first)


def test_q12_never_draws_the_validation_pair_in_either_order():
    seq = workload.sequence(workload.load("adhoc", BENCH), 3)
    for q, p, _ in seq:
        if q == "q12" and p["year"] == 1994:
            assert {p["mode1"], p["mode2"]} != {"MAIL", "SHIP"}


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_lists_and_clients_share_nothing(seed):
    t = workload.load("adhoc", BENCH)
    a, b = workload.client_lists(t, seed), workload.client_lists(t, seed)
    assert a == b
    assert len(a) == t["clients"]
    heads = [x[2] for lst in a for x in lst[:50]]
    assert len(set(heads)) == len(heads)
    assert workload.client_lists(t, seed + 1) != a
    assert len(workload.client_lists(dict(t, clients=4), seed)) == 4


@pytest.mark.parametrize("seed", SEEDS)
def test_every_client_gets_each_query_once_a_block_of_six(seed):
    t = workload.load("adhoc", BENCH)
    lists = workload.client_lists(t, seed)
    assert [len(lst) for lst in lists] == \
        [t["queries_per_client"]] * t["clients"]
    for lst in lists:
        for i in range(0, len(lst) - 5, 6):
            assert sorted(k for k, _, _ in lst[i:i + 6]) == \
                sorted(qgen.QUERIES)


def test_the_order_within_a_block_is_the_seeds():
    t = workload.load("adhoc", BENCH)
    firsts = {tuple(k for k, _, _ in workload.client_lists(t, s)[0][:6])
              for s in SEEDS}
    assert len(firsts) > 1


def test_a_longer_list_begins_with_the_shorter():
    t = workload.load("adhoc", BENCH)
    short = workload.client_lists(dict(t, queries_per_client=50), 11)
    assert workload.client_lists(t, 11)[0][:50] == short[0]
