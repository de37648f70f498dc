"""The readers of the stages' device intervals, the beam epoch's host
spans and the B4 launch count, on made-up accountant records; each reads
nothing from a program that records none of them."""

import types

import pytest

from bench_h100.harness import cells

NEW = ("search.device_s", "clean.device_s", "beams.device_s",
       "beams.upload_s", "beams.hit_s", "beams.ledger_s", "b4.launches")


def _view(chunks):
    return types.SimpleNamespace(chunks=chunks)


def read(name, view):
    return cells.metric_reader(name)(view)


def _chunk(device_s=None, buckets=None, counters=None):
    rec = {"wall_s": 1.0, "buckets": dict(buckets or {}),
           "counters": dict(counters or {})}
    if device_s is not None:
        rec["device_s"] = dict(device_s)
    return rec


def test_device_interval_readers_average_the_units_that_have_them():
    v = _view([_chunk({"search": 0.5, "clean": 0.002}),
               _chunk({"search": 0.7, "clean": 0.004}),
               # a unit whose pair the stream had not passed at the return
               _chunk({"clean": 0.003})])
    assert read("search.device_s", v) == pytest.approx(0.6)
    assert read("beams.device_s", v) == pytest.approx(0.6)
    assert read("clean.device_s", v) == pytest.approx(0.003)


def test_epoch_bucket_readers_count_every_epoch():
    v = _view([
        _chunk(buckets={"search/dispatch/upload": 0.2, "persist/ledger":
                        0.02, "hit_products": 1.2}),
        _chunk(buckets={"search/dispatch/upload": 0.4,
                        "persist/ledger": 0.04}),
        _chunk(buckets={"search/dispatch/upload": 0.3,
                        "persist/ledger": 0.03}),
        _chunk(buckets={"search/dispatch/upload": 0.1,
                        "persist/ledger": 0.01, "hit_products": 0.4})])
    assert read("beams.upload_s", v) == pytest.approx(0.25)
    assert read("beams.ledger_s", v) == pytest.approx(0.025)
    assert read("beams.hit_s", v) == pytest.approx(0.4)


def test_b4_launches_a_unit():
    v = _view([_chunk(counters={"b4_launches": 3068, "dispatches": 1}),
               _chunk(counters={"b4_launches": 3068}),
               _chunk(counters={"dispatches": 1})])
    assert read("b4.launches", v) == pytest.approx(2 * 3068 / 3)
    assert read("b4.launches", _view(
        [_chunk(counters={"b4_launches": 2})] * 5)) == 2


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_is_none(name):
    # the parent program's records: buckets and counters of its own, no
    # device intervals, no epoch spans, no launch counters
    parent = _view([_chunk(buckets={"read": 0.1, "search": 0.5,
                                    "search/dispatch": 0.4, "persist": 0.2},
                           counters={"dispatches": 1, "readbacks": 1})
                    for _ in range(4)])
    assert read(name, parent) is None
    assert read(name, _view([])) is None
    # device intervals of other stages only
    assert read(name, _view([_chunk({"read": 0.1})])) is None
