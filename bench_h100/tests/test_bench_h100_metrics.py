"""Each per-layer reader on a synthetic accountant dump and trace."""

import json
import types

import pytest

from bench_h100.harness import cells, devtrace
from bench_h100.reference import work

H100 = "NVIDIA H100 80GB HBM3"


def _view(**kw):
    chunks = [{"wall_s": w, "buckets": {"read": 0.01, "upload_wait": 0.02,
                                        "clean": 0.03, "search": 0.5}}
              for w in (0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2, 1.3, 1.4)]
    view = types.SimpleNamespace(
        chunks=chunks, stage_totals={"persist_backpressure": 0.4,
                                     "persist_drain": 0.1},
        kernels={"void dedisperse_kernel<16>(float const*)": 2.0,
                 "score_kernel(float const*, double*)": 0.5,
                 "elementwise": 1.0},
        busy_s=6.0, window_s=8.0, peak_bytes=3_000_000_000,
        geometry={"ndm": 1000, "nchan": 1024, "nsamples": 65536},
        device_kind=H100,
        rec={"searched": 10, "units": 10})
    for k, v in kw.items():
        setattr(view, k, v)
    return view


def read(name, view):
    return cells.metric_reader(name)(view)


def test_loop_and_stage_readers():
    v = _view()
    assert read("loop.chunk_p90_s", v) == pytest.approx(1.31)
    assert read("io.wait_s", v) == pytest.approx(0.03)
    assert read("clean.chunk_s", v) == pytest.approx(0.03)
    assert read("search.chunk_s", v) == pytest.approx(0.5)
    assert read("persist.wait_s", v) == pytest.approx(0.05)
    assert read("beams.read_s", v) == pytest.approx(0.01)
    assert read("beams.search_s", v) == pytest.approx(0.5)


def test_device_readers():
    v = _view()
    assert read("device.idle_pct", v) == pytest.approx(25.0)
    assert read("device.peak_gb", v) == pytest.approx(3.0)


def test_roofline_readers_count_the_work_once():
    v = _view()
    adds, nbytes = work.sweep_work(1000, 1024, 65536)
    want = 100 * max(10 * adds / work.PEAK_FP32_ADDS,
                     10 * nbytes / work.PEAK_HBM_BYTES_S) / 2.0
    assert read("b1_roofline", v) == pytest.approx(want)
    adds, nbytes = work.score_work(1000, 65536, 5000)
    want = 100 * max(10 * adds / work.PEAK_FP32_ADDS,
                     10 * nbytes / work.PEAK_HBM_BYTES_S) / 0.5
    assert read("b4_roofline", v) == pytest.approx(want)


def test_a_reader_with_nothing_to_read_returns_nothing():
    v = _view(kernels={}, chunks=[], busy_s=None, peak_bytes=0,
              device_kind="cpu")
    for name in ("b1_roofline", "b4_roofline", "loop.chunk_p90_s",
                 "io.wait_s", "device.idle_pct", "device.peak_gb"):
        assert read(name, v) is None, name


def test_trace_summary(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "dedisperse_kernel", "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "score_kernel", "ts": 400,
         "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "chunk", "ts": 0,
         "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "persist", "ts": 160,
         "dur": 300},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 10},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    busy, by_name, breakdown = devtrace.summarise(str(path))
    assert busy == pytest.approx(250e-6)
    assert by_name["dedisperse_kernel"] == pytest.approx(100e-6)
    assert breakdown["idle_gaps"] == [["persist", pytest.approx(250e-6)]]
    assert breakdown["device_ops"][0][0] in ("dedisperse_kernel",
                                             "Memcpy HtoD", "score_kernel")
