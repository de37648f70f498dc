"""putpu-lint for the port (``pulsarutils_tpu_torch.analysis``): each
checker's positive and negative fixtures, waivers, the baseline, the CLI,
and the invariant that the committed port tree lints clean with its empty
baseline.

The cases are the JAX package's ``tests/test_lint.py`` with
``pulsarutils_tpu_torch/...`` fixture paths (its ``retrace`` cases have
no torch counterpart), merged into parametrised tests, plus torch cases
for the translated ``device-trip``, ``float64-leak`` and ``bf16-cast``
spellings.  Fixture snippets are compiled from strings with virtual
paths, so the layer-scoped checkers see the package layout without
depending on it.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from pulsarutils_tpu_torch.analysis import (LintProject, lint_source,
                                            load_baseline, save_baseline)
from pulsarutils_tpu_torch.analysis import baseline as baseline_mod
from pulsarutils_tpu_torch.analysis import core as core_mod
from pulsarutils_tpu_torch.analysis import waivers as waivers_mod
from pulsarutils_tpu_torch.analysis.cli import BASELINE_NAME, run_lint
from pulsarutils_tpu_torch.obs import gate, names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "pulsarutils_tpu_torch"

OPS = f"{PKG}/ops/fixture.py"
PAR = f"{PKG}/parallel/fixture.py"
TUN = f"{PKG}/tuning/fixture.py"
OBS = f"{PKG}/obs/fixture.py"
PIPE = f"{PKG}/pipeline/fixture.py"


def ids(findings):
    return sorted(f.checker for f in findings)


def lint(src, path=OPS, **kw):
    return lint_source(textwrap.dedent(src), path=path, **kw)


def test_package_name_and_baseline_point_at_the_port():
    assert core_mod.PACKAGE_NAME == PKG
    assert BASELINE_NAME == ".putpu-torch-lint-baseline.json"
    assert core_mod._package_relative(f"{PKG}/ops/search.py") \
        == "ops/search.py"
    # the JAX package's files are outside the port's layers
    assert core_mod._package_relative("pulsarutils_tpu/ops/search.py") \
        is None


# -- device-trip, torch spellings ---------------------------------------------

@pytest.mark.parametrize("body,label", [
    ("return np.asarray(torch.sum(x * 2))", "np.asarray"),
    ("return torch.sum(x).item()", ".item()"),
    ("return torch.sum(x).cpu()", ".cpu()"),
    ("return torch.sum(x).tolist()", ".tolist()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
])
@pytest.mark.parametrize("path", [OPS, PAR, TUN])
def test_device_trip_spelling_fires_in_device_layers(body, label, path):
    src = ("import numpy as np\nimport torch\n"
           f"def readback(x):\n    {body}\n")
    found = lint(src, path=path)
    assert ids(found) == ["device-trip"]
    assert found[0].message.startswith(label)


@pytest.mark.parametrize("body", [
    "return np.asarray(torch.sum(x))",
    "return torch.sum(x).item()",
    "return torch.sum(x).cpu()",
    "torch.cuda.synchronize()",
])
def test_device_trip_silent_inside_budget_bucket(body):
    src = ("import numpy as np\nimport torch\n"
           "from pulsarutils_tpu_torch.utils.logging_utils import "
           "budget_bucket\n"
           "def readback(x):\n"
           "    with budget_bucket('search/readback'):\n"
           f"        {body}\n")
    assert lint(src) == []


@pytest.mark.parametrize("path", [OBS, PIPE, f"{PKG}/io/fixture.py"])
def test_device_trip_silent_outside_device_layers(path):
    src = "import torch\ndef f(x):\n    return torch.sum(x).cpu()\n"
    assert lint(src, path=path) == []


@pytest.mark.parametrize("src", [
    # a pure-host helper (never names torch): value conversions are host
    """\
    import numpy as np
    def plan(dms):
        return np.asarray(dms, dtype=np.float32)
    """,
    """\
    def total(values):
        return values.tolist()
    """,
    # host-ness chains through assignments: np result -> method call
    """\
    import numpy as np
    import torch
    def offsets(x):
        y = torch.sum(x)
        shifts = np.rint([1.0, 2.0])
        return shifts.max().item(), y
    """,
    # a value already read back is host
    """\
    import numpy as np
    import torch
    def fetch(x):
        host = to_numpy(torch.sum(x, 0))
        return np.asarray(host)
    """,
    # shape metadata is host
    """\
    import numpy as np
    import torch
    def geometry(x):
        return np.asarray(x.shape), torch.zeros(1)
    """,
])
def test_device_trip_host_values_are_silent(src):
    assert lint(src) == []


@pytest.mark.parametrize("seam", ["fetch_global", "measure_device_rtt",
                                  "measure_kernel_wall", "_fused_seed",
                                  "_fused_mesh_round"])
def test_device_trip_sanctioned_seam_is_silent(seam):
    src = (f"import numpy as np\nimport torch\ndef {seam}(x):\n"
           "    return torch.sum(x).cpu().numpy()\n")
    assert lint(src) == []


def test_device_trip_cpu_in_a_function_without_torch_fires():
    # .cpu() and synchronize are device by name: no pure-host grace
    src = "def fetch(x):\n    return x.cpu()\n"
    assert ids(lint(src)) == ["device-trip"]


# -- lock discipline ----------------------------------------------------------

LOCKED_CLASS = """\
import threading
class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self.items = []
        self.count = 0
    %s
"""


@pytest.mark.parametrize("method,expected", [
    ("""\
    def add(self, x):
            self.items.append(x)
            self.count += 1
    """, ["lock-discipline", "lock-discipline"]),
    ("""\
    def add(self, x):
            with self._lock:
                self.items.append(x)
                self.count += 1
    """, []),
    ("pass\n", []),
    # the caller-holds-the-lock helper pattern
    ("""\
    def add(self, x):
            with self._lock:
                self._bump(x)

        def _bump(self, x):
            self.items.append(x)
    """, []),
    ("""\
    def add(self, x):
            with self._lock:
                self._bump(x)

        def sneak(self, x):
            self._bump(x)

        def _bump(self, x):
            self.items.append(x)
    """, ["lock-discipline"]),
])
def test_lock_discipline_cases(method, expected):
    src = LOCKED_CLASS % textwrap.dedent(method)
    assert ids(lint(src, path=OBS)) == expected


@pytest.mark.parametrize("src,expected", [
    ("""\
    class Plain:
        def __init__(self):
            self.items = []
        def add(self, x):
            self.items.append(x)
    """, []),
    ("""\
    import threading
    class Table:
        def __init__(self):
            self._lock = threading.Lock()
            self.rows = {}
        def put(self, k, v):
            self.rows[k] = v
    """, ["lock-discipline"]),
])
def test_lock_discipline_marking(src, expected):
    assert ids(lint(src, path=OBS)) == expected


# -- span leaks ---------------------------------------------------------------

SPAN_IMPORT = "from pulsarutils_tpu_torch.obs.trace import begin_span\n"


@pytest.mark.parametrize("body,expected", [
    ("""\
    def run():
        h = begin_span("dispatch")
        try:
            work()
        finally:
            h.end()
    """, []),
    ("""\
    def run():
        h = begin_span("dispatch")
        x = 1
        h.end()
    """, []),
    ("""\
    def run(flag):
        h = begin_span("dispatch")
        if flag:
            return None
        h.end()
    """, ["span-leak"]),
    ("""\
    def run():
        h = begin_span("dispatch")
        work(h)
    """, ["span-leak"]),
    ("""\
    def stash(self):
        self.span = begin_span("lease")
    def discard():
        begin_span("oops")
    """, ["span-leak", "span-leak"]),
    ("""\
    def stash(self):
        # putpu-lint: disable=span-leak — ends at lease resolution
        self.span = begin_span("lease")
    """, []),
    ("""\
    def run():
        h = begin_span("dispatch")
        try:
            work()
            h.end()
        except ValueError:
            pass
    """, ["span-leak"]),
])
def test_span_leak_cases(body, expected):
    src = SPAN_IMPORT + textwrap.dedent(body)
    assert ids(lint_source(src, path=OBS)) == expected


# -- metric/span name drift ---------------------------------------------------

MANIFEST = {"putpu_known_total"}


@pytest.mark.parametrize("src,kw,expected", [
    ('reg.counter("putpu_bogus_total")\n', {}, ["metric-name-unknown"]),
    ('reg.counter("putpu_known_total")\n', {}, []),
    ('reg.gauge("putpu_bogus")\n', {}, ["metric-name-unknown"]),
    ('reg.histogram("putpu_bogus")\n', {}, ["metric-name-unknown"]),
    # the precision policy's counting helper is read as an emit site
    ('_count("putpu_bogus_total", "f32")\n', {}, ["metric-name-unknown"]),
    ('_count("putpu_known_total")\n', {}, []),
    ('reg.counter(f"putpu_{name}_total")\n', {}, ["metric-name-dynamic"]),
    ('reg.counter("putpu_dispatches_total")\n',
     {"manifest_names": set(), "dynamic_names": {"dispatches"}}, []),
])
def test_metric_name_cases(src, kw, expected):
    kw = {"manifest_names": MANIFEST, **kw}
    assert ids(lint(src, path=OBS, **kw)) == expected


def _full_scan(project, layers=("parallel", "pipeline", "faults", "io")):
    for layer in layers:
        project.check_source("x = 1\n", f"{PKG}/{layer}/fixture.py")


def test_metric_name_unemitted_manifest_entry_fires_on_full_scan():
    project = LintProject(manifest_names={"putpu_known_total",
                                          "putpu_stale_total"})
    project.check_source('reg.counter("putpu_known_total")\n', OBS)
    _full_scan(project)
    extra = project.finalize()
    assert ids(extra) == ["metric-name-unemitted"]
    assert "putpu_stale_total" in extra[0].message
    assert extra[0].path == f"{PKG}/obs/names.py"


def test_metric_name_manifest_reads_port_names(tmp_path):
    # METRIC_NAMES and PORT_METRIC_NAMES are both the manifest
    pkg = tmp_path / PKG / "obs"
    pkg.mkdir(parents=True)
    (pkg / "names.py").write_text(
        'METRIC_NAMES = {"putpu_real_total": "meaning"}\n'
        'PORT_METRIC_NAMES = {"putpu_port_total": "meaning"}\n'
        'BUDGET_COUNTERS = frozenset({"dispatches"})\n')
    (tmp_path / "README.md").write_text(
        "putpu_real_total, putpu_port_total and putpu_dispatches_total "
        "resolve; putpu_ghost_total does not\n")
    project = LintProject(root=str(tmp_path))
    project.check_source('reg.counter("putpu_port_total")\n',
                         f"{PKG}/obs/fixture.py")
    assert project.findings == []
    extra = project.finalize()
    assert ids(extra) == ["metric-name-unknown-ref"]
    assert "putpu_ghost_total" in extra[0].message


def test_metric_name_docs_dir_is_not_read(tmp_path):
    # the JAX package's docs/ belong to its own lint, not the port's
    pkg = tmp_path / PKG / "obs"
    pkg.mkdir(parents=True)
    (pkg / "names.py").write_text(
        'METRIC_NAMES = {"putpu_real_total": "meaning"}\n')
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "x.md").write_text("putpu_ghost_total\n")
    assert LintProject(root=str(tmp_path)).finalize() == []


def test_runtime_manifest_helpers_agree():
    assert names.is_known("putpu_hits_total")
    assert names.is_known("putpu_fallbacks_total")
    assert names.is_known(names.budget_counter_metric("dispatches"))
    assert not names.is_known("putpu_ghost_total")


# -- broad exception ----------------------------------------------------------

@pytest.mark.parametrize("src,path,expected", [
    ("""\
    def step():
        try:
            work()
        except Exception:
            pass
    """, PIPE, ["broad-except"]),
    ("try:\n    work()\nexcept:\n    pass\n", OPS, ["broad-except"]),
    ("try:\n    work()\nexcept BaseException:\n    raise\n", OPS,
     ["broad-except"]),
    ("""\
    def step():
        try:
            work()
        except (OSError, ValueError):
            pass
    """, PIPE, []),
    ("""\
    class _Handler:
        def do_GET(self):
            try:
                self.respond()
            except Exception:
                pass
    """, f"{PKG}/obs/server.py", []),
])
def test_broad_except_cases(src, path, expected):
    assert ids(lint(src, path=path)) == expected


@pytest.mark.parametrize("path,qual", [
    ("ops/search.py", "_search_direct_laddered"),
    ("ops/search.py", "_search_direct"),
    ("periodicity/driver.py", "_resolve_accel_backend"),
    ("tuning/autotune.py", "KernelTuner.resolve"),
    ("tuning/autotune.py", "KernelTuner._measure"),
])
def test_broad_except_port_seams_are_sanctioned(path, qual):
    parts = qual.split(".")
    if len(parts) == 2:
        src = (f"class {parts[0]}:\n    def {parts[1]}(self):\n"
               "        try:\n            work()\n"
               "        except Exception:\n            raise\n")
    else:
        src = (f"def {parts[0]}():\n    try:\n        work()\n"
               "    except Exception:\n        raise\n")
    assert lint_source(src, path=f"{PKG}/{path}") == []
    # the same handler in another function of that file still fires
    other = src.replace(parts[-1], "elsewhere", 1)
    assert ids(lint_source(other, path=f"{PKG}/{path}")) \
        == ["broad-except"]


# -- float64 leak, torch spellings --------------------------------------------

@pytest.mark.parametrize("src", [
    "import torch\nx = torch.zeros((4,), dtype=torch.float64)\n",
    "import torch\nx = y.to(torch.float64)\n",
    "import torch\nx = y.to(torch.double)\n",
    "import torch\nx = torch.zeros(4, dtype=torch.complex128)\n",
    "import torch\nx = y.double()\n",
])
@pytest.mark.parametrize("path", [OPS, PAR])
def test_float64_leak_fires_in_device_layers(src, path):
    assert ids(lint(src, path=path)) == ["float64-leak"]


@pytest.mark.parametrize("src,path", [
    # host float64 (plan math, reference paths) is deliberate
    ("import numpy as np\nx = np.zeros((4,), dtype=np.float64)\n", OPS),
    ("import torch\nx = torch.zeros(4, dtype=torch.float32)\n", OPS),
    ("import torch\nx = y.to(torch.float64)\n", OBS),
    ("import torch\nx = y.to(torch.float64)\n", PIPE),
    ("import torch\n"
     "x = y.to(torch.float64)  # putpu-lint: disable=float64-leak — pack\n",
     OPS),
])
def test_float64_leak_silent_cases(src, path):
    assert lint(src, path=path) == []


# -- bf16 casts outside the precision seam ------------------------------------

@pytest.mark.parametrize("src", [
    "import torch\ny = x.to(torch.bfloat16)\n",
    "import torch\ny = x.to(dtype=torch.float16)\n",
    "import torch\ny = x.to('cuda', torch.half)\n",
    "import torch\ny = torch.zeros((4,), dtype=torch.bfloat16)\n",
    "y = x.bfloat16()\n",
    "y = x.half()\n",
])
@pytest.mark.parametrize("path", [OPS, PAR])
def test_bf16_cast_fires_in_device_layers(src, path):
    assert ids(lint(src, path=path)) == ["bf16-cast"]


@pytest.mark.parametrize("src,path", [
    ("import torch\nflag = x.dtype == torch.bfloat16\n", OPS),
    ("import torch\ny = x.to(torch.bfloat16)\n",
     f"{PKG}/precision/policy.py"),
    ("import torch\ny = x.to(torch.bfloat16)\n", OBS),
    ("import torch\ny = x.to(torch.bfloat16)"
     "  # putpu-lint: disable=bf16-cast — policy-gated\n", OPS),
])
def test_bf16_cast_silent_cases(src, path):
    assert lint(src, path=path) == []


# -- waivers ------------------------------------------------------------------

BROAD = "try:\n    work()\nexcept Exception:\n    pass\n"


@pytest.mark.parametrize("src,expected", [
    (BROAD.replace("except Exception:",
                   "except Exception:  # putpu-lint: disable=broad-except"
                   " — seam"), []),
    ("try:\n    work()\n# putpu-lint: disable=broad-except — reviewed\n"
     "except Exception:\n    pass\n", []),
    ("# putpu-lint: disable-file=broad-except\n" + BROAD * 2, []),
    (BROAD.replace("except Exception:",
                   "except Exception:  # putpu-lint: disable=device-trip"),
     ["broad-except"]),
    ('s = "# putpu-lint: disable=broad-except"\n' + BROAD,
     ["broad-except"]),
    ("x = 1  # putpu-lint: disable=not-a-checker\n",
     ["lint-waiver-unknown"]),
])
def test_waiver_cases(src, expected):
    assert ids(lint(src, path=OPS)) == expected


def test_waiver_parser_multiple_ids():
    w = waivers_mod.parse_waivers(
        "x = 1  # putpu-lint: disable=broad-except,device-trip\n")
    assert w.waives("broad-except", 1)
    assert w.waives("device-trip", 1)
    assert not w.waives("float64-leak", 1)


def test_waiver_after_statement_does_not_suppress():
    src = ('x = reg.counter("putpu_bogus_total")\n'
           "# putpu-lint: disable=metric-name-unknown — next line only\n"
           'y = reg.counter("putpu_bogus2_total")\n')
    found = lint(src, path=OBS, manifest_names=MANIFEST)
    assert [f.line for f in found] == [1]


# -- baseline -----------------------------------------------------------------

BAD_PIPE = f"{PKG}/pipeline/legacy.py"


def _project_with_finding(src=BROAD):
    project = LintProject()
    project.check_source(src, BAD_PIPE)
    return project


def test_baseline_roundtrip_suppresses(tmp_path):
    path = str(tmp_path / "baseline.json")
    first = _project_with_finding()
    assert save_baseline(path, first.findings, first.sources) == 1
    assert len(load_baseline(path)) == 1
    again = _project_with_finding()
    assert again.apply_baseline(path) == 1
    assert again.new_findings() == []
    assert again.report()["clean"]
    assert again.report()["baselined"] == 1


@pytest.mark.parametrize("variant,applied,new", [
    # fingerprints hash content, not line numbers
    ("# a new comment line\n" + BROAD, 1, 0),
    # an edited flagged line resurfaces
    (BROAD.replace("except Exception:", "except  Exception :"), 0, 1),
    # grandfathering one site does not cover a second identical one
    (BROAD + BROAD, 1, 1),
])
def test_baseline_fingerprint_cases(tmp_path, variant, applied, new):
    path = str(tmp_path / "baseline.json")
    first = _project_with_finding()
    save_baseline(path, first.findings, first.sources)
    project = _project_with_finding(variant)
    assert project.apply_baseline(path) == applied
    assert len(project.new_findings()) == new


def test_baseline_never_records_waived(tmp_path):
    src = BROAD.replace(
        "except Exception:",
        "except Exception:  # putpu-lint: disable=broad-except — ok")
    project = _project_with_finding(src)
    assert save_baseline(str(tmp_path / "b.json"), project.findings,
                         project.sources) == 0


def test_fingerprint_helper_matches_batch():
    project = _project_with_finding()
    f = project.findings[0]
    fp = baseline_mod.fingerprint(f, project.sources[BAD_PIPE])
    assert fp == baseline_mod.fingerprints([f], project.sources)[id(f)]


# -- atomic-write -------------------------------------------------------------

@pytest.mark.parametrize("src,path,expected", [
    ("""\
    import json
    def persist(doc):
        with open("state/progress.json", "w") as f:
            json.dump(doc, f)
    """, f"{PKG}/io/fixture.py", ["atomic-write"]),
    ("""\
    def persist(fp, doc, path):
        with open(f"progress_{fp}.json", "w") as f:
            f.write(doc)
        with open(path + ".jsonl", "a") as f:
            f.write(doc)
    """, f"{PKG}/fleet/fixture.py", ["atomic-write", "atomic-write"]),
    ("""\
    import os
    def persist(outdir, doc):
        with open(os.path.join(outdir, "fleet_journal.jsonl"),
                  "a") as f:
            f.write(doc)
    """, f"{PKG}/fleet/fixture.py", ["atomic-write"]),
    ("""\
    import json
    def load(path, out, doc):
        with open("state/progress.json") as f:
            data = json.load(f)
        with open("state/progress.json", "r") as f:
            data = json.load(f)
        with open(path + ".tmp", "w") as f:
            json.dump(doc, f)
        with open(out, "w") as f:
            json.dump(doc, f)
        return data
    """, f"{PKG}/io/fixture.py", []),
    ("""\
    def append_jsonl(path, line):
        with open("x.jsonl", "a") as f:
            f.write(line)
    """, f"{PKG}/io/atomic.py", []),
    ("""\
    def forge(doc):
        # putpu-lint: disable=atomic-write — a fixture forges a torn file
        with open("torn.json", "w") as f:
            f.write(doc)
    """, f"{PKG}/io/fixture.py", []),
])
def test_atomic_write_cases(src, path, expected):
    assert ids(lint(src, path=path)) == expected


# -- quarantine-reason vocabulary ---------------------------------------------

REASONS_FIXTURE = '''\
FEED_GAP = "feed_gap"
SHED_OVERRUN = "shed_overrun"
QUARANTINE_REASONS = {
    "feed_gap": "unrecoverable feed loss",
    "shed_overrun": "drop-oldest load shedding",
}
'''

REASON_DOC_FIXTURE = '''\
# readme

<!-- torch-quarantine-reasons:begin -->
| `feed_gap` | quarantine |
| `shed_overrun` | journal |
<!-- torch-quarantine-reasons:end -->
'''

FAULTS = f"{PKG}/faults/fixture.py"


def _reason_root(tmp_path, doc=REASON_DOC_FIXTURE):
    faults = tmp_path / PKG / "faults"
    faults.mkdir(parents=True)
    (faults / "reasons.py").write_text(REASONS_FIXTURE)
    (tmp_path / "README.md").write_text(doc)
    return str(tmp_path)


@pytest.mark.parametrize("src,expected", [
    ('def f(m):\n    m.record(0, 8, "mystery", {})\n',
     ["quarantine-reason-unknown"]),
    ("from . import reasons\n"
     "def f(m):\n"
     '    m.record(0, 8, "feed_gap", {})\n'
     "    m.record(0, 8, reasons.SHED_OVERRUN, {})\n", []),
    ("def f(m, x):\n"
     '    m.record(0, 8, f"weird-{x}", {})\n'
     '    m.record(0, 8, "integrity:" + x, {})\n',
     ["quarantine-reason-dynamic"]),
    # a module's own bare record(...) is not a manifest record (the
    # roofline's record(name, work, seconds))
    ("def f(name, work, t):\n    record(name, work, t - 1.0)\n", []),
])
def test_reason_per_file_cases(tmp_path, src, expected):
    project = LintProject(root=_reason_root(tmp_path))
    project.check_source(src, FAULTS)
    assert ids(project.findings) == expected
    if not expected:
        assert project.finalize() == []


@pytest.mark.parametrize("doc,checker,token", [
    (REASON_DOC_FIXTURE.replace("| `shed_overrun` | journal |\n", ""),
     "quarantine-reason-undocumented", "shed_overrun"),
    (REASON_DOC_FIXTURE.replace(
        "<!-- torch-quarantine-reasons:end -->",
        "| `ghost_reason` | ? |\n<!-- torch-quarantine-reasons:end -->"),
     "quarantine-reason-doc-unknown", "ghost_reason"),
    # the JAX package's markers are not the port's table
    (REASON_DOC_FIXTURE.replace("torch-quarantine", "quarantine"),
     "quarantine-reason-undocumented", "feed_gap"),
])
def test_reason_table_cases(tmp_path, doc, checker, token):
    project = LintProject(root=_reason_root(tmp_path, doc=doc))
    project.check_source("x = 1\n", FAULTS)
    extra = project.finalize()
    assert set(ids(extra)) == {checker}
    assert token in extra[0].message


def test_reason_unused_arms_only_on_full_layer_scan(tmp_path):
    root = _reason_root(tmp_path)
    src = 'def f(m):\n    m.record(0, 8, "feed_gap", {})\n'
    project = LintProject(root=root)
    project.check_source(src, FAULTS)
    _full_scan(project, ("obs", "parallel", "pipeline", "io", "ingest"))
    extra = project.finalize()
    assert ids(extra) == ["quarantine-reason-unused"]
    assert "shed_overrun" in extra[0].message
    partial = LintProject(root=root)
    partial.check_source(src, FAULTS)
    _full_scan(partial, ("obs", "parallel", "pipeline", "io"))
    assert partial.finalize() == []


# -- the CLI and the committed-tree invariant ---------------------------------

def _run_cli(*args, module="lint_main"):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", f"{PKG}.cli.{module}", *args],
        cwd=REPO, env=env, capture_output=True, text=True)


def test_committed_port_tree_is_clean():
    """The acceptance invariant: zero unwaived findings on the port,
    with the committed baseline empty."""
    base = os.path.join(REPO, BASELINE_NAME)
    with open(base) as f:
        assert json.load(f)["findings"] == []
    res = _run_cli()
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 new finding(s)" in res.stdout
    assert "0 baselined" in res.stdout


def test_committed_port_tree_runs_every_checker():
    project = run_lint(root=REPO)
    rep = project.report()
    assert rep["clean"], [f.location() for f in project.new_findings()]
    assert set(rep["checkers"]) == {
        "device-trip", "lock-discipline", "metric-name", "broad-except",
        "float64-leak", "bf16-cast", "atomic-write", "quarantine-reason",
        "span-leak"}
    assert rep["files"] > 100
    assert all(f.path.startswith(PKG + "/") for f in project.findings)


def test_a_renamed_series_in_a_copy_of_the_tree_is_found(tmp_path):
    # a full-tree scan arms both directions: the new name is unknown and
    # the manifest's old one is emitted nowhere
    import shutil

    dst = tmp_path / PKG
    shutil.copytree(os.path.join(REPO, PKG), dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(REPO, "README.md"), tmp_path / "README.md")
    sift = dst / "pipeline" / "sift.py"
    text = sift.read_text()
    sift.write_text(text.replace('"putpu_sift_candidates_in_total"',
                                 '"putpu_sift_in_renamed"'))
    project = run_lint(paths=[str(dst)])
    new = ids(project.new_findings())
    assert "metric-name-unknown" in new
    assert "metric-name-unemitted" in new


@pytest.mark.parametrize("args,rc,needle", [
    (("--list-checkers",), 0, "float64-leak"),
    (("--select", "device-trip"), 0, "0 new finding(s)"),
    ((), 1, "broad-except"),
])
def test_cli_on_a_bad_file(tmp_path, args, rc, needle):
    bad = tmp_path / "bad.py"
    bad.write_text(BROAD)
    extra = () if args == ("--list-checkers",) else (str(bad),)
    res = _run_cli(*args, *extra)
    assert res.returncode == rc, res.stdout + res.stderr
    assert needle in res.stdout


def test_cli_json_report(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(BROAD)
    out = tmp_path / "report.json"
    res = _run_cli("--format", "json", "--out", str(out), str(bad))
    assert res.returncode == 1
    doc = json.loads(out.read_text())
    assert doc["tool"] == "putpu-lint"
    assert doc["schema_version"] == 1
    assert not doc["clean"] and doc["new"] == 1
    assert doc == json.loads(res.stdout)


def test_cli_root_follows_scanned_paths(tmp_path):
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "bad.py").write_text(BROAD)
    repo_baseline = os.path.join(REPO, BASELINE_NAME)
    before = open(repo_baseline).read()
    res = _run_cli("--update-baseline", str(pkg))
    assert res.returncode == 0, res.stdout + res.stderr
    assert (tmp_path / BASELINE_NAME).exists()
    assert open(repo_baseline).read() == before
    assert _run_cli(str(pkg)).returncode == 0


def test_update_baseline_partial_path_preserves_unscanned(tmp_path):
    pkg = tmp_path / PKG
    sub = pkg / "sub"
    sub.mkdir(parents=True)
    (pkg / "a.py").write_text(BROAD)
    (sub / "b.py").write_text(BROAD)
    assert _run_cli("--update-baseline", str(pkg)).returncode == 0
    assert _run_cli("--update-baseline", str(sub)).returncode == 0
    doc = json.loads((tmp_path / BASELINE_NAME).read_text())
    assert sorted(e["location"] for e in doc["findings"]) == [
        f"{PKG}/a.py:3", f"{PKG}/sub/b.py:3"]


def test_update_baseline_refuses_select(tmp_path):
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "bad.py").write_text(BROAD)
    res = _run_cli("--update-baseline", "--select", "broad-except",
                   str(pkg))
    assert res.returncode == 2
    assert "unselected" in res.stderr


# -- the perf-gate hook -------------------------------------------------------

def test_gate_accepts_clean_and_refuses_dirty_lint_reports(tmp_path):
    report = tmp_path / "lint.json"
    clean = LintProject()
    clean.check_source("x = 1\n", OPS)
    report.write_text(json.dumps(clean.report()))
    ok, detail = gate.check_lint_report(str(report))
    assert ok, detail
    ok, detail = gate.check_lint_report(str(tmp_path / "absent.json"))
    assert not ok and "missing" in detail
    report.write_text(json.dumps(_project_with_finding().report()))
    ok, detail = gate.check_lint_report(str(report))
    assert not ok and "1 new" in detail
    report.write_text('{"tool": "other"}')
    assert not gate.check_lint_report(str(report))[0]


def test_jax_lint_of_the_jax_package_stays_clean():
    # the port adds no putpu_* name to README.md that the JAX manifest
    # lacks, and its reason table does not disturb the JAX one
    from pulsarutils_tpu.analysis.cli import run_lint as jax_run_lint

    rep = jax_run_lint(root=REPO).report()
    assert rep["clean"], rep["findings"]
