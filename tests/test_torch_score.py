"""The one-pass scorer: the port's plain version (``score_profiles_chunked``
with the certificate row) against the JAX package's XLA scorer and its
Pallas kernel (interpret mode); a host replay of the CUDA kernel's
arithmetic (``csrc/score.cu``) against the plain version; the stacked
pack and the wrapper's argument checks.  Windows and peaks are equal;
floats agree within rtol 2e-4, atol 1e-5, the JAX package's tolerance
between its own two scorers."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pulsarutils_tpu.ops.score_pallas import score_plane_pallas
from pulsarutils_tpu.ops.search import \
    score_profiles_chunked as jax_score_chunked

from pulsarutils_tpu_torch.ops import score_cuda
from pulsarutils_tpu_torch.ops.score_cuda import (CENTRE_SAMPLES,
                                                  score_plane,
                                                  score_plane_cuda)
from pulsarutils_tpu_torch.ops.search import (score_profiles_chunked,
                                              score_profiles_stacked,
                                              unstack_scores)
from pulsarutils_tpu_torch.utils import nvcc

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5
FLOAT_ROWS = {0: "max", 1: "std", 2: "snr", 5: "cert"}


def _plane(name):
    """A named test plane, from a numpy seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    shapes = {"odd_t": (37, 3001), "dc_1e4": (16, 4096),
              "pulse_last_3": (24, 4099), "tile_2048": (13, 2048),
              "dc_1e4_tile": (8, 2048), "last_3_tile": (8, 2048),
              "short_19": (5, 19)}
    rows, t = shapes[name]
    plane = rng.standard_normal((rows, t)).astype(np.float32)
    plane[rows // 3, t // 3:t // 3 + 4] += 9.0       # a width-4 pulse
    if name.startswith("dc_1e4"):
        plane += np.float32(1e4)
    if name in ("pulse_last_3", "last_3_tile", "short_19"):
        # a width-3 pulse in the last three samples: only the circular
        # certificate windows see all of it
        plane[rows // 2, t - 3:] += 6.0
    return plane


def _plain(plane, with_cert=True):
    return score_profiles_chunked(torch.from_numpy(plane),
                                  with_cert=with_cert).numpy()


def _assert_scores_close(got, want, rows=FLOAT_ROWS):
    np.testing.assert_array_equal(got[3], want[3], err_msg="window")
    np.testing.assert_array_equal(got[4], want[4], err_msg="peak")
    for k, name in rows.items():
        if k < got.shape[0]:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name", ["odd_t", "pulse_last_3", "tile_2048",
                                  "short_19"])
def test_plain_scorer_matches_jax_xla(name):
    plane = _plane(name)
    want = np.asarray(jax_score_chunked(jnp.asarray(plane), jnp,
                                        with_cert=True))
    got = _plain(plane)
    assert got.shape == want.shape == (6, plane.shape[0])
    _assert_scores_close(got, want)


@pytest.mark.parametrize("name", ["tile_2048", "dc_1e4_tile",
                                  "last_3_tile"])
def test_plain_scorer_matches_pallas_interpret(name):
    plane = _plane(name)
    for with_cert in (True, False):
        want = np.asarray(score_plane_pallas(jnp.asarray(plane),
                                             with_cert=with_cert,
                                             interpret=True))
        got = _plain(plane, with_cert)
        assert got.shape == want.shape
        _assert_scores_close(got, want)


def test_dc_offset_plain_scorer_is_exact_where_xla_quantises():
    # at a DC offset of 1e4 the XLA scorer's float32 row mean is off by a
    # few ulps of 1e4 (~1e-3), moving its maxima by ~2x the tolerance;
    # the port centres on the float64 mean rounded once.  Windows and
    # peaks agree with both JAX scorers; the floats agree with the Pallas
    # kernel (above) and are closer to float64 truth than the XLA ones
    plane = _plane("dc_1e4")
    got = _plain(plane)
    xla = np.asarray(jax_score_chunked(jnp.asarray(plane), jnp,
                                       with_cert=True))
    np.testing.assert_array_equal(got[3], xla[3])
    np.testing.assert_array_equal(got[4], xla[4])
    x64 = plane.astype(np.float64)
    truth = (x64 - x64.mean(axis=1, keepdims=True)).max(axis=1)
    assert np.abs(got[0] - truth).max() <= np.float32(1e4) * 2.0 ** -24
    assert np.abs(got[0] - truth).mean() < np.abs(xla[0] - truth).mean()


def _replay_score(plane, with_cert=True):
    """``csrc/score.cu``'s arithmetic on the host, row by row: centre on
    the mean of the first CENTRE_SAMPLES samples, the block pyramid in
    float32 over floor(T / w) blocks, double sums, maxima moved by
    ``d = c - m32`` at the end, the sliding sums wrapping at T."""
    rows, t = plane.shape
    out = np.zeros((6 if with_cert else 5, rows))
    idx = np.arange(t)
    for r in range(rows):
        x = plane[r]
        n0 = min(t, CENTRE_SAMPLES)
        c = np.float32(x[:n0].astype(np.float64).sum() / n0)
        v = x - c
        m = v.astype(np.float64).sum() / t
        d = np.float64(c) - np.float64(np.float32(np.float64(c) + m))
        var = (v.astype(np.float64) ** 2).sum() / t - m * m
        std = np.float32(np.sqrt(max(var, 0.0)))
        blocks = [v]
        for w in (2, 4, 8):
            prev, n = blocks[-1], t // w
            blocks.append(prev[0:2 * n:2] + prev[1:2 * n:2])
        best, best_w, best_p = np.float32(0.0), 0, 0
        for w, b in zip((1, 2, 4, 8), blocks):
            b64 = b.astype(np.float64)
            nb = t // w
            var_w = (b64 ** 2).sum() / nb - (b64.sum() / nb) ** 2
            snr = np.float32((np.float64(b.max()) + w * d)
                             / np.sqrt(max(var_w, 0.0)))
            if snr > best:
                best, best_w, best_p = snr, w, int(np.argmax(b)) * w
        out[:5, r] = (np.float32(np.float64(v.max()) + d), std, best,
                      best_w, best_p)
        if with_cert:
            s2 = v + v[(idx + 1) % t]
            sums = (s2, s2 + v[(idx + 2) % t],
                    s2 + (v[(idx + 2) % t] + v[(idx + 3) % t]))
            out[5, r] = max(
                np.float32((np.float64(s.max()) + w * d)
                           / (np.float64(std) * np.sqrt(w)))
                for w, s in zip((2, 3, 4), sums))
    return out


@pytest.mark.parametrize("name", ["odd_t", "dc_1e4", "pulse_last_3",
                                  "short_19"])
def test_kernel_arithmetic_replay_matches_plain(name):
    plane = _plane(name)
    replay = _replay_score(plane)
    want = _plain(plane)
    _assert_scores_close(replay, want)
    if name == "dc_1e4":
        # at a DC offset every centred value is an exact multiple of the
        # offset's ulp: the folded maxima equal the plain version's
        np.testing.assert_array_equal(replay[0], want[0])


def test_stacked_pack_is_float64_with_integer_windows_and_peaks():
    plane = _plane("odd_t")
    stacked = score_profiles_stacked(torch.from_numpy(plane))
    assert stacked.dtype == torch.float64 and stacked.shape == (5, 37)
    m, s, snr, win, peak = unstack_scores(stacked)
    assert m.dtype == s.dtype == snr.dtype == np.float32
    assert win.dtype == np.int32 and peak.dtype == np.int64
    assert set(np.unique(win)) <= {1, 2, 4, 8}
    assert ((peak % win) == 0).all() and (peak < 3001).all()
    # the width-4 pulse at t // 3 = 1000: its row peaks there
    assert win[12] in (4, 8) and abs(int(peak[12]) - 1000) <= 8
    cert = unstack_scores(_plain(plane))[5]
    assert cert.dtype == np.float32 and cert.shape == (37,)


def test_score_plane_runs_plain_on_cpu():
    plane = torch.from_numpy(_plane("odd_t"))
    before = score_cuda.launches
    for with_cert in (True, False):
        assert torch.equal(score_plane(plane, with_cert=with_cert),
                           score_profiles_chunked(plane,
                                                  with_cert=with_cert))
    assert score_cuda.launches == before


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper built or loaded the library")
    monkeypatch.setattr(nvcc, "build", refuse)
    monkeypatch.setattr(nvcc, "load", refuse)


@pytest.mark.parametrize("plane, exc, match", [
    (torch.zeros(4, 64), ValueError, "CUDA device"),
    (torch.zeros(4, 64, dtype=torch.float64), TypeError, "float32"),
    (torch.zeros(64, 4).t(), ValueError, "contiguous"),
    (torch.zeros(64), ValueError, "2-D"),
    (torch.zeros(4, 7), ValueError, "8 <= T"),
    (torch.zeros(0, 64), ValueError, "rows > 0"),
])
def test_wrapper_rejects_bad_arguments_without_building(no_build, plane,
                                                        exc, match):
    before = score_cuda.launches
    with pytest.raises(exc, match=match):
        score_plane_cuda(plane, with_cert=True)
    assert score_cuda.launches == before


def test_score_plane_rejects_other_devices(no_build):
    with pytest.raises(ValueError, match="no scorer"):
        score_plane(torch.zeros(2, 16, device="meta"))
