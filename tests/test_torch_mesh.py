"""The port's meshes and multi-process layer (``parallel/mesh.py``,
``parallel/multihost.py``, ``parallel/live.py``) against the JAX
package's on its eight virtual CPU devices.

The port's CPU counterpart of those devices is ``[torch.device("cpu")]
* 8``: a mesh of virtual shards.  Shapes, the ``-1`` and ``None`` rules,
the too-many-devices error, ``balanced_2d_mesh``, ``pad_to_multiple``
and ``process_local_slice`` are compared with the JAX functions; the
``pod_mesh`` grouping rule with the JAX package's mocked two-host
topology (``tests/test_multihost.py``); and a live two-rank gloo run
holds the sharded tables to the single-process tables bit for bit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from pulsarutils_tpu.parallel import mesh as jmesh
from pulsarutils_tpu.parallel import multihost as jmulti

from pulsarutils_tpu_torch.parallel import mesh as tmesh
from pulsarutils_tpu_torch.parallel import multihost as tmulti

CPU8 = [torch.device("cpu")] * 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [None, (4, 2), (-1, 2), (2, -1), (8, 1),
                                   (1, 8), (2, 2), (3, 1)])
def test_make_mesh_shape_equals_jax(shape):
    ours = tmesh.make_mesh(shape, devices=CPU8)
    theirs = jmesh.make_mesh(shape)
    assert dict(ours.shape) == dict(theirs.shape)
    assert list(ours.shape) == list(theirs.axis_names)
    assert ours.devices.shape == theirs.devices.shape
    ids = np.vectorize(lambda d: d.id)(theirs.devices)
    assert np.array_equal(ours.ids, ids - ids.min())
    assert all(d == torch.device("cpu") for d in ours.devices.flat)


def test_make_mesh_errors_and_axes_equal_jax():
    with pytest.raises(ValueError, match="needs 128 devices"):
        tmesh.make_mesh((64, 2), devices=CPU8)
    with pytest.raises(ValueError, match="needs 128 devices"):
        jmesh.make_mesh((64, 2))
    ours = tmesh.make_mesh((8,), ("dm",), devices=CPU8)
    theirs = jmesh.make_mesh((8,), ("dm",))
    assert dict(ours.shape) == dict(theirs.shape) == {"dm": 8}


def test_make_mesh_on_the_card_by_default(monkeypatch):
    # devices=None is every CUDA device; without one it raises, never
    # falling back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmesh.make_mesh((2, 1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = tmesh.make_mesh()
    assert dict(mesh.shape) == {"dm": 2, "chan": 1}
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1"]
    assert mesh.all_cuda and mesh.home == torch.device("cuda", 0)


def test_virtual_shards_of_one_device():
    card = [torch.device("cuda:0")] * 4
    mesh = tmesh.make_mesh((2, 2), devices=card)
    assert dict(mesh.shape) == {"dm": 2, "chan": 2}
    assert all(str(d) == "cuda:0" for d in mesh.devices.flat)
    assert mesh.grid().shape == (2, 2)
    assert mesh.axis_devices("dm") == [torch.device("cuda:0")] * 2


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_balanced_2d_mesh_equals_jax(n):
    ours = tmesh.balanced_2d_mesh(n, devices=CPU8)
    theirs = jmesh.balanced_2d_mesh(n)
    assert dict(ours.shape) == dict(theirs.shape)


@pytest.mark.parametrize("mode", ["edge", "constant"])
@pytest.mark.parametrize("n, axis, multiple", [(5, 0, 4), (5, 0, 5),
                                               (3, 1, 4), (7, 1, 1)])
def test_pad_to_multiple_equals_jax(mode, n, axis, multiple):
    x = np.arange(n * 3).reshape((n, 3) if axis == 0 else (3, n)) + 1
    a, na = tmesh.pad_to_multiple(x, axis, multiple, mode=mode)
    b, nb = jmesh.pad_to_multiple(x, axis, multiple, mode=mode)
    assert na == nb and np.array_equal(a, b)
    if a.shape == x.shape:
        assert a is x


def _mock_two_hosts(monkeypatch, rank):
    """The JAX test's topology: eight devices, four a host, process
    ``rank`` of two."""
    monkeypatch.setattr(tmulti, "local_device_count", lambda devices=None: 4)
    monkeypatch.setattr(tmulti, "process_count", lambda: 2)
    monkeypatch.setattr(tmulti, "process_index", lambda: rank)


def test_pod_mesh_chan_groups_stay_within_host(monkeypatch):
    grids = []
    for rank in (0, 1):
        _mock_two_hosts(monkeypatch, rank)
        ours = tmulti.pod_mesh(devices=CPU8)
        assert ours.process_count == 2 and ours.process_index == rank
        assert ours.dm_offset == 2 * rank
        grids.append(ours.ids)
    grid = np.concatenate(grids)
    monkeypatch.setattr(jax, "local_device_count", lambda: 4)
    theirs = jmulti.pod_mesh()
    assert dict(ours.shape) == dict(theirs.shape) == {"dm": 4, "chan": 2}
    order = {d.id: i for i, d in enumerate(jax.devices())}
    jgrid = np.asarray([[order[d.id] for d in row] for row in theirs.devices])
    assert np.array_equal(grid, jgrid)
    hosts = grid // 4
    assert (hosts == hosts[:, :1]).all(), hosts


def test_pod_mesh_explicit_chan_validates_divisibility(monkeypatch):
    _mock_two_hosts(monkeypatch, 0)
    monkeypatch.setattr(jax, "local_device_count", lambda: 4)
    assert tmulti.pod_mesh(chan_per_host=4, devices=CPU8).shape["chan"] \
        == jmulti.pod_mesh(chan_per_host=4).shape["chan"] == 4
    with pytest.raises(ValueError, match="divide"):
        tmulti.pod_mesh(chan_per_host=3, devices=CPU8)
    with pytest.raises(ValueError, match="divide"):
        jmulti.pod_mesh(chan_per_host=3)


@pytest.mark.parametrize("chan", [1, 2, 4, 8])
def test_pod_mesh_single_host_equals_jax(chan):
    ours = tmulti.pod_mesh(chan_per_host=chan, devices=CPU8)
    theirs = jmulti.pod_mesh(chan_per_host=chan)
    assert dict(ours.shape) == dict(theirs.shape)
    assert sorted(ours.ids.ravel()) == list(range(8))
    assert ours.process_count == 1 and ours.dm_offset == 0


def test_pod_mesh_default_rule_equals_jax():
    assert dict(tmulti.pod_mesh(devices=CPU8).shape) \
        == dict(jmulti.pod_mesh().shape)


@pytest.mark.parametrize("n, p", [(10, 3), (7, 8), (64, 4), (5, 5),
                                  (103, 4)])
def test_process_local_slice_equals_jax(n, p):
    ours = [tmulti.process_local_slice(n, axis_size=p, index=i)
            for i in range(p)]
    theirs = [jmulti.process_local_slice(n, axis_size=p, index=i)
              for i in range(p)]
    assert ours == theirs
    assert ours[0][0] == 0 and ours[-1][1] == n
    assert tmulti.process_local_slice(n) == (0, n)


def test_initialize_single_process_is_false_and_cached(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(tmulti, "_STATE", {"done": False, "multi": False})
    assert tmulti.initialize() is False
    assert tmulti.initialize() is False
    assert tmulti._STATE["done"] is True
    assert tmulti.process_count() == 1 and tmulti.process_index() == 0


def test_initialize_explicit_cluster_needs_every_argument(monkeypatch):
    monkeypatch.setattr(tmulti, "_STATE", {"done": False, "multi": False})
    with pytest.raises(ValueError, match="needs coordinator_address"):
        tmulti.initialize(coordinator_address="127.0.0.1:1",
                          num_processes=2)
    # a failed explicit bring-up is not cached: a retry runs again
    assert tmulti._STATE["done"] is False


def test_fetch_global_single_process_reads_back():
    x = torch.arange(6.0).reshape(2, 3)
    mesh = tmesh.make_mesh((2, 1), devices=CPU8)
    assert np.array_equal(tmesh.fetch_global(x, mesh), x.numpy())
    assert np.array_equal(tmesh.fetch_global(x), x.numpy())


def test_two_rank_gloo_run_equals_the_single_process_tables():
    """Two processes (four CPU shards each, dm across them, chan within)
    search one seeded chunk with the sharded sweep, the sharded FDMT and
    the mesh hybrid (two-stage and fused); each rank's tables equal the
    single-process tables of the same (4, 2) mesh bit for bit."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PUTPU_LIVE_RANK", None)
    proc = subprocess.run(
        [sys.executable, "-m", "pulsarutils_tpu_torch.parallel.live",
         "--device", "cpu", "--timeout", "240"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert "MULTIHOST LIVE: OK" in proc.stdout
    for rank in (0, 1):
        for name in ("sweep", "fdmt", "hybrid", "hybrid_fused"):
            assert f"rank {rank}: {name} on {{'dm': 4, 'chan': 2}}" \
                in proc.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_live_check_needs_a_card_unless_asked_for_the_host():
    """The live check's shards default to the card: without one it
    raises before it starts a rank, and names the host run."""
    proc = subprocess.run(
        [sys.executable, "-m", "pulsarutils_tpu_torch.parallel.live",
         "--nproc", "1"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr
    assert "MULTIHOST LIVE: OK" not in proc.stdout
