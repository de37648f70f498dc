"""The benchmark's frozen work formulas equal the port's at today's
shapes."""

import pytest

from bench_h100.reference import work
from pulsarutils_tpu_torch.obs import roofline

SHAPES = [(40995, 1024, 82944), (7535, 96, 15360), (514, 1024, 1 << 20)]


@pytest.mark.parametrize("ndm,nchan,nsamples", SHAPES)
def test_sweep_and_score_work(ndm, nchan, nsamples):
    assert work.sweep_work(ndm, nchan, nsamples) == roofline.sweep_work(
        ndm, nchan, nsamples)
    assert work.score_work(ndm, nsamples, 5 * ndm) == roofline.score_work(
        ndm, nsamples, 5 * ndm)
    ours = work.bound_s(*work.sweep_work(ndm, nchan, nsamples))
    assert 1e3 * ours == pytest.approx(roofline.sweep_bound_ms(
        ndm, nchan, nsamples)[0])


def test_peaks():
    assert work.PEAKS == roofline.CARD_PEAKS
