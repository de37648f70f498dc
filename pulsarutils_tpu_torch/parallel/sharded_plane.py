"""A dm-sharded dedispersed plane left on its devices, with shard-local
products.

The port of the JAX package's module.  A sharded search's captured plane
stays where it was made, one block of rows per dm shard on that shard's
device, and every consumer runs shard by shard, reading back only
per-row score vectors (a few floats a trial), a time-decimated image for
the figure's plane panel, and single rows on demand (the argbest
profile, the period-refine series).

Per-row products reduce over time only, so sharding the rows changes
nothing numerically, with ONE documented exception, the JAX package's:
:meth:`ShardedPlane.h_curve` digitises each shard by that shard's own
median and MAD (over the shard's rows that the table references), so
its curve is not the single-device curve bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import to_numpy

__all__ = ["ShardedPlane"]

#: rows of one spectral or H-test launch: the batched rFFT allocates
#: several (rows x T) temporaries, so each shard is processed this many
#: rows at a time (the JAX package's bound, ~0.5 GB of workspace)
ROW_CHUNK_ELEMENTS = 1 << 27


class ShardedPlane:
    """Lazy handle over a dm-sharded plane on its devices.

    ``shards`` is the list of ``(rows_d, T)`` tensors, one per dm shard
    in shard order, each on its shard's device; the plane's global rows
    are their concatenation.  ``row_index`` maps each table row (plan or
    trial grid order) to its global row.  Consumers duck-type on the
    methods below: anything that takes a plain ``(ndm, T)`` plane only
    for rows, per-row products or a decimated image takes this handle.
    """

    def __init__(self, shards, mesh, axis, row_index):
        self._shards = list(shards)
        self.mesh = mesh
        self.axis = axis
        self.row_index = np.asarray(row_index, dtype=np.int64)
        sizes = [int(s.shape[0]) for s in self._shards]
        self._starts = np.concatenate([[0], np.cumsum(sizes)]).astype(
            np.int64)
        self._nsamples = int(self._shards[0].shape[1]) if self._shards else 0

    @property
    def shape(self):
        return (len(self.row_index), self._nsamples)

    @property
    def ndim(self):
        return 2

    @property
    def shards(self):
        """The per-shard tensors (global row order)."""
        return list(self._shards)

    def remap(self, idx):
        """A view of the same shards under a new row order (the hybrid maps
        the FDMT grid onto the plan grid this way)."""
        return ShardedPlane(self._shards, self.mesh, self.axis,
                            self.row_index[np.asarray(idx)])

    def _locate(self, g):
        s = int(np.searchsorted(self._starts, g, side="right")) - 1
        return s, int(g - self._starts[s])

    def row(self, i):
        """One table row as a host float array (reads ~T floats back)."""
        s, r = self._locate(int(self.row_index[int(i)]))
        return to_numpy(self._shards[s][r])

    def __getitem__(self, i):
        if not np.isscalar(i) and not isinstance(i, (int, np.integer)):
            raise TypeError("ShardedPlane supports scalar row access only; "
                            "use .to_host() to materialise the full plane")
        return self.row(i)

    def to_host(self):
        """The FULL plane on the host in table-row order (tests and small
        planes only: the gather the handle exists to avoid)."""
        return np.concatenate([to_numpy(s) for s in self._shards])[
            self.row_index]

    # -- shard-local products -------------------------------------------

    def spectral_scores(self, tsamp, max_harmonics=16, fmin=None, fmax=None):
        """Per-row spectral search (periodicity stage 1), shard-local, in
        row chunks (the harmonic stack B6 on the card): the ``{freq,
        power, nharm, log_sf, sigma}`` host arrays in table-row order, as
        the per-chunk stage of :func:`~..ops.periodicity.
        period_search_plane` returns them."""
        from ..ops.periodicity import _SPEC_KEYS, _spectral_chunk

        chunk = max(16, ROW_CHUNK_ELEMENTS // max(1, self._nsamples))
        parts = []
        for s in self._shards:
            for lo in range(0, s.shape[0], chunk):
                spec = _spectral_chunk(s[lo:lo + chunk], float(tsamp),
                                       int(max_harmonics), fmin, fmax)
                parts.append(spec)
        out = {k: np.concatenate([p[k] for p in parts])[self.row_index]
               for k in _SPEC_KEYS}
        return out

    def h_curve(self, window=1, nmax=None):
        """Per-row H statistic (the figure's H-vs-DM curve), shard-local.

        ``window`` is the candidate's best boxcar width (the resampling
        the single-device figure applies before its H test).  Each shard
        is digitised by the median and MAD of its rows that the table
        references (the JAX package's per-shard semantics; a shard with
        none uses centre 0 and scale 1).  Returns ``(h, m)`` host arrays
        in table-row order.
        """
        from ..ops.rebin import quick_resample
        from ..ops.robust import MAD_SCALE, digitize, h_test_batch, median

        t_r = self.shape[1] // max(1, int(window))
        if nmax is None:
            nmax = max(1, t_r // 10)
        nmax = int(max(1, min(nmax, t_r // 2 if t_r >= 4 else 1)))
        used = np.zeros(int(self._starts[-1]), dtype=bool)
        used[np.unique(self.row_index)] = True
        hs, ms = [], []
        for s, lo, hi in zip(self._shards, self._starts[:-1],
                             self._starts[1:]):
            r = quick_resample(s, int(window)) if window > 1 else s
            valid = torch.from_numpy(used[lo:hi]).to(r.device)
            if bool(used[lo:hi].any()):
                vals = r[valid]
                med = median(vals)
                scale = median(torch.abs(vals - med)) / MAD_SCALE
            else:
                med = torch.zeros((), dtype=r.dtype, device=r.device)
                scale = torch.ones((), dtype=r.dtype, device=r.device)
            counts = torch.clamp(digitize(r, center=med, scale=scale), min=0)
            h, m = h_test_batch(counts, nmax=nmax)
            hs.append(to_numpy(h).astype(np.float32))
            ms.append(to_numpy(m).astype(np.int32))
        return (np.concatenate(hs)[self.row_index],
                np.concatenate(ms)[self.row_index])

    def decimated(self, max_bins=2048):
        """Time-decimated plane image for the figure's plane panel:
        ``(image, factor)``, block sums over ``factor`` samples (the
        ``quick_resample`` convention, a trailing partial block dropped)
        in table-row order, at most ``max_bins`` time bins."""
        from ..ops.rebin import quick_resample

        factor = max(1, -(-self.shape[1] // int(max_bins)))
        if factor == 1:
            return self.to_host(), 1
        img = np.concatenate([to_numpy(quick_resample(s, factor))
                              for s in self._shards])
        return img[self.row_index], factor
