"""The comparison that decides ``correct`` fails where it must: the
control (the reference at the next lower precision in the program's
place), and a run with the timed path broken underneath, once for each
fault a cell can have.  Each drives the rest of a run on the CPU at a
tiny size, past the harness's look for a card."""

import numpy as np
import pytest

from bench_h100.tests import tiny

HTRU = "htru_hilat.frb_direct"
PMPS = "pmps_13beam.rrat_batched"


@pytest.fixture
def root(tmp_path):
    tiny.make_root(tmp_path)
    return tmp_path


@pytest.mark.parametrize("workload", [HTRU, PMPS])
def test_sound_run_is_correct(root, workload):
    result = tiny.run(root, workload)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("workload", [HTRU, PMPS])
def test_control_is_not_correct(root, workload):
    result = tiny.run(root, workload, control=True)
    assert not result["correct"]
    assert result["checks"]["snr_gap"]["value"] \
        > result["checks"]["snr_gap"]["limit"]


def _with_table(table, snr):
    from pulsarutils_tpu_torch.utils.table import ResultTable

    cols = {k: table[k] for k in table.colnames}
    cols["snr"] = snr
    return ResultTable(cols, meta=dict(table.meta))


def _break_search(monkeypatch, fault):
    """Break the chunk loop's search: ``altered`` lowers the best row's
    S/N of every table where it is produced by 5%; ``one_block`` lowers
    by 5% one block of 16 trials half the plan away from the best row, as
    a sweep kernel wrong in one block of trials would; ``stale`` hands
    every chunk the first chunk's table (the state never moves on)."""
    from pulsarutils_tpu_torch.pipeline import search_pipeline

    inner = search_pipeline.dedispersion_search
    first = []

    def broken(*args, **kwargs):
        out = inner(*args, **kwargs)
        table = out[0] if isinstance(out, tuple) else out
        if fault == "altered":
            snr = np.array(table["snr"], dtype=np.float64)
            snr[int(np.argmax(snr))] *= 0.95
            table = _with_table(table, snr)
        elif fault == "one_block":
            snr = np.array(table["snr"], dtype=np.float64)
            lo = (int(np.argmax(snr)) + len(snr) // 2) % len(snr) // 16 * 16
            snr[lo:lo + 16] *= 0.95
            table = _with_table(table, snr)
        else:
            first.append(table)
            table = first[0]
        return (table,) + out[1:] if isinstance(out, tuple) else table

    monkeypatch.setattr(search_pipeline, "dedispersion_search", broken)


@pytest.mark.parametrize("fault", ["altered", "one_block", "stale"])
def test_broken_search_is_not_correct(root, monkeypatch, fault):
    _break_search(monkeypatch, fault)
    result = tiny.run(root, HTRU, seed=11)
    assert result["timing"]["units"] >= 3   # room for the fault to show
    assert not result["correct"]
    if fault == "one_block":    # caught by the chunk compared in full
        gap = result["checks"]["snr_gap"]
        assert gap["value"] > gap["limit"]
        assert result["checks"]["hits_wrong"]["value"] == 0


def test_half_the_beam_batch_left_out_is_not_correct(root, monkeypatch):
    """The batch's second half gets the first half's tables."""
    from pulsarutils_tpu_torch.beams.batcher import BeamBatcher

    inner = BeamBatcher.search

    def half(self, blocks):
        tables = inner(self, blocks[:(len(blocks) + 1) // 2])
        return (tables + tables)[:len(blocks)]

    monkeypatch.setattr(BeamBatcher, "search", half)
    assert not tiny.run(root, PMPS, seed=12)["correct"]


def test_answer_altered_in_the_batch_is_not_correct(root, monkeypatch):
    from pulsarutils_tpu_torch.beams.batcher import BeamBatcher

    inner = BeamBatcher.search

    def altered(self, blocks):
        tables = inner(self, blocks)
        snr = np.array(tables[-1]["snr"], dtype=np.float64)
        snr[int(np.argmax(snr))] *= 1.05
        return tables[:-1] + [_with_table(tables[-1], snr)]

    monkeypatch.setattr(BeamBatcher, "search", altered)
    assert not tiny.run(root, PMPS, seed=13)["correct"]


@pytest.mark.parametrize("workload", [HTRU, PMPS])
def test_chunk_left_unmarked_is_not_correct(root, monkeypatch, workload):
    from pulsarutils_tpu_torch.io.candidates import CandidateStore

    inner = CandidateStore.mark_done
    skipped = []

    def forgetful(self, istart, reason=None):
        # the first mark of the window's jobs (not the warm-up's) is lost
        if "job" in str(self.directory) and not skipped:
            skipped.append(istart)
            return None
        return inner(self, istart, reason=reason)

    monkeypatch.setattr(CandidateStore, "mark_done", forgetful)
    assert not tiny.run(root, workload, seed=14)["correct"]
