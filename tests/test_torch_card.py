"""Tests that need a CUDA card: the hand-written kernels on the paths
that reach them only there.  Each skips without a card.  On a CUDA
host, from the root of a checkout (the repository's ``conftest.py``
imports JAX, which a CUDA host running the port need not have)::

    python -m pytest tests/test_torch_card.py -q --noconftest \\
        -p no:cacheprovider

This file imports neither JAX nor the JAX package: it compares the
port with itself.
"""

import numpy as np
import pytest
import torch

from pulsarutils_tpu_torch.beams import BeamBatcher
from pulsarutils_tpu_torch.io.lowbit import device_unpack_block, pack_numpy
from pulsarutils_tpu_torch.ops.clean_ops import renormalize_data
from pulsarutils_tpu_torch.ops.search import (dedispersion_search,
                                              formulation_scores,
                                              sweep_offsets)
from pulsarutils_tpu_torch.precision import STRATEGIES
from pulsarutils_tpu_torch.utils.device import to_numpy
from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

pytestmark = pytest.mark.card

GEOM = (1200.0, 200.0, 5e-4)  # start frequency, bandwidth, sample time
#: the ``f32`` policy's score tolerance: torch's gather sums the channels
#: in another order than B1
SCORE_RTOL = STRATEGIES["f32"].score_rtol


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1 and B4 run only there")
    return torch.device("cuda")


def _tables_equal(a, b):
    for col in ("DM", "max", "std", "snr", "rebin", "peak"):
        assert np.array_equal(np.asarray(a[col]), np.asarray(b[col])), col


def _tables_close(ours, ref):
    for col in ("DM", "rebin", "peak"):
        assert np.array_equal(np.asarray(ours[col]), np.asarray(ref[col])), \
            col
    for col in ("max", "std", "snr"):
        np.testing.assert_allclose(ours[col], ref[col], rtol=SCORE_RTOL,
                                   err_msg=col)


def test_packed_beam_batch_runs_the_direct_sweep(card):
    """A packed, conditioned 3-beam batch runs the float32 gather as the
    direct sweep: each beam's table equals its single-beam search and
    ``dedispersion_search(kernel="pallas")`` on the same conditioned
    beam bit for bit, and torch's gather of that beam (the path it
    replaces) within the scores' float tolerance, the discrete columns
    equal; one B1 and one B4 launch a 512-trial superblock a beam."""
    nchan, nsamples, nbits = 64, 16384, 2
    trial_dms = np.linspace(0.0, 1500.0, 2100)  # 4 superblocks of 512, 52
    rng = np.random.default_rng(20)
    frames = []
    for _ in range(3):
        codes = rng.integers(0, 1 << nbits, (nsamples, nchan),
                             dtype=np.uint8)
        codes[1500:1504] = (1 << nbits) - 1
        frames.append(pack_numpy(codes.reshape(-1), nbits).reshape(
            nsamples, -1))
    batcher = BeamBatcher(nchan, nsamples, trial_dms, *GEOM,
                          kernel="gather", packed=(nbits, True),
                          prep=(True, 1), device=card)
    acct = BudgetAccountant()
    with acct.chunk(0):
        tables = batcher.search(frames)
    assert batcher.direct
    superblocks = batcher._offsets_dev(nsamples)
    assert [len(rows) for rows, _ in superblocks] == [512] * 4 + [52]
    superblocks = len(superblocks)
    counts = acct.chunks[0]["counters"]
    assert counts["b1_launches"] == 3 * superblocks
    assert counts["b4_launches"] == 3 * superblocks
    assert counts["beam_direct"] == 3
    for raw, table in zip(frames, tables):
        _tables_equal(table, batcher.search_single(raw))
        beam = renormalize_data(device_unpack_block(
            torch.from_numpy(raw).to(card), nbits, nchan, True))
        _tables_equal(table, dedispersion_search(
            beam, 0.0, 0.0, *GEOM, trial_dms=trial_dms, kernel="pallas",
            device=card))
        blocks = sweep_offsets(trial_dms, nchan, *GEOM, nsamples,
                               batcher.dm_block, card, False)
        gathered = formulation_scores(beam, blocks, batcher.chan_block,
                                      "gather", None)
        _tables_close(table, batcher._tables(to_numpy(gathered)[None])[0])
