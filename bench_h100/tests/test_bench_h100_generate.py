"""The generator is deterministic in ``--seed`` and gives every seed the
same set of events."""

import hashlib
import os

import torch

from bench_h100.harness import cells
from bench_h100.harness.generate import make_pointing, plan_events
from bench_h100.tests import tiny


def _digest(paths):
    h = hashlib.sha256()
    for p in paths:
        for q in (p, p + ".badchans"):
            if os.path.exists(q):
                with open(q, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()


def test_same_seed_same_bytes(tmp_path):
    tiny.make_root(tmp_path)
    cell = cells.load_cell("htru_hilat.frb_direct", root=str(tmp_path))
    big = 2 ** 31 + 987654
    a, ev_a, bad_a = make_pointing(cell.config, cell.traffic, big,
                                   str(tmp_path / "a"), torch.device("cpu"))
    b, ev_b, bad_b = make_pointing(cell.config, cell.traffic, big,
                                   str(tmp_path / "b"), torch.device("cpu"))
    c, _, bad_c = make_pointing(cell.config, cell.traffic, big + 1,
                                str(tmp_path / "c"), torch.device("cpu"))
    assert _digest(a) == _digest(b) and ev_a == ev_b
    assert _digest(a) != _digest(c)
    assert bad_a.sum() == bad_c.sum() == round(0.05 * cell.config["nchans"])


def test_every_seed_gets_the_same_set_of_events():
    for workload in ("pmps_13beam.rrat_batched", "htru_hilat.frb_direct"):
        cell = cells.load_cell(workload)
        data = cell.traffic["data"]

        def sizes(seed):
            evs = plan_events(cell.config, data, seed)
            return sorted((e["kind"], round(e["width_s"], 12),
                           round(max(e["beams"].values()), 12),
                           len(e["beams"])) for e in evs)

        assert sizes(1) == sizes(2 ** 31 + 5) == sizes(77)
        # in the same order: a window reaches the same events
        def dms(seed):
            return sorted(((e["kind"], e["t0"]), e["dm"])
                          for e in plan_events(cell.config, data, seed))

        assert [dm for _, dm in dms(1)] == [dm for _, dm in dms(2 ** 31 + 5)]
        a = plan_events(cell.config, data, 3)
        b = plan_events(cell.config, data, 4)
        assert [e["t0"] for e in a] != [e["t0"] for e in b]
        # the same arrivals, each late by at most its kind's jitter
        a, b = (sorted(x, key=lambda e: (e["kind"], e["t0"])) for x in (a, b))
        for ea, eb in zip(a, b):
            assert ea["kind"] == eb["kind"]
            jitter = data[ea["kind"] + "s"]["jitter_s"]
            assert abs(ea["t0"] - eb["t0"]) <= jitter
