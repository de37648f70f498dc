"""The plain reference agrees with the port at a tiny size: the reader and
decode, the plan, the cleaning, the sweep and scores, the sift."""

import numpy as np
import pytest
import torch

from bench_h100.harness import cells
from bench_h100.harness.checking import RefPointing
from bench_h100.harness.generate import make_pointing
from bench_h100.reference import coincidence, search
from bench_h100.tests import tiny


@pytest.fixture(scope="module")
def pointing(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref")
    tiny.make_root(root)
    cell = cells.load_cell("htru_hilat.frb_direct", root=str(root))
    paths, _, _ = make_pointing(cell.config, cell.traffic, 12345,
                                str(root / "data"), torch.device("cpu"))
    return cell, paths[0]


def test_reader_decode_and_plan(pointing):
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan
    from pulsarutils_tpu_torch.parallel.stream import (iter_chunk_starts,
                                                       plan_chunks)

    cell, path = pointing
    cfg = cell.config
    r = RefPointing(path, cfg["dmmin"], cfg["dmmax"], torch.device("cpu"))
    reader = FilterbankReader(path)
    h = reader.header
    plan = plan_chunks(h["nsamples"], h["tsamp"], cfg["dmmin"], cfg["dmmax"],
                       h["fbottom"], h["ftop"], h["foff"])
    assert (r.step, r.hop, r.resample) == (plan.step, plan.hop, plan.resample)
    assert search.chunk_starts(r.nsamples, r.step, r.hop) == list(
        iter_chunk_starts(h["nsamples"], plan))
    np.testing.assert_array_equal(r.dms, dedispersion_plan(
        h["nchans"], cfg["dmmin"], cfg["dmmax"], h["fbottom"],
        h["bandwidth"], plan.sample_time))
    from bench_h100.reference import filterbank

    codes = filterbank.decode(filterbank.read_frames(path, 100, 300),
                              h["nbits"], h["nchans"], torch.device("cpu"))
    np.testing.assert_array_equal(
        codes.numpy(), reader.read_block(100, 300).astype(np.float32))


def test_clean_sweep_and_scores_match_the_port(pointing):
    from pulsarutils_tpu_torch.ops.clean_ops import renormalize_data
    from pulsarutils_tpu_torch.ops.search import dedispersion_search
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader

    cell, path = pointing
    cfg = cell.config
    r = RefPointing(path, cfg["dmmin"], cfg["dmmax"], torch.device("cpu"))
    x = r.chunk(r.hop)
    reader = FilterbankReader(path)
    block = torch.from_numpy(reader.read_block(r.hop, r.step,
                                               band_ascending=True)
                             .astype(np.float32))
    port = renormalize_data(block, badchans_mask=torch.from_numpy(r.bad))
    np.testing.assert_allclose(x.numpy(), port.numpy(), rtol=1e-5,
                               atol=1e-5)
    table = dedispersion_search(port, cfg["dmmin"], cfg["dmmax"],
                                r.fbottom, r.bandwidth, r.eff_tsamp,
                                kernel="pallas", device="cpu")
    ref = r.all_rows(port)
    np.testing.assert_allclose(ref["snr"], table["snr"], rtol=1e-5)
    np.testing.assert_array_equal(ref["width"], table["rebin"])
    np.testing.assert_array_equal(ref["peak"], table["peak"])


def test_coincidence_matches_the_port():
    from pulsarutils_tpu_torch.beams.coincidence import coincidence_sift

    cell = cells.load_cell("pmps_13beam.rrat_batched")
    adj = {int(k): {int(b) for b in v}
           for k, v in cell.config["adjacency"].items()}
    rng = np.random.default_rng(3)
    cands = []
    for t in (1.0, 5.0, 9.0, 13.0):
        beams = rng.choice(np.arange(1, 14), size=int(rng.integers(1, 14)),
                           replace=False)
        for b in beams:
            cands.append({"beam": int(b), "time": t + rng.normal(0, 0.01),
                          "dm": 50 + rng.normal(0, 0.2),
                          "snr": float(rng.uniform(8, 30)),
                          "width": 0.002})
    want = sorted((v, tuple(b), n) for v, b, n in coincidence.sift(
        cands, 13, adj))
    got = sorted((g["verdict"], tuple(sorted(g["beams"])), g["n_members"])
                 for g in coincidence_sift(cands, nbeams=13,
                                           adjacency=adj))
    assert want == got
