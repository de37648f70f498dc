"""A minimal column table for search results (host numpy columns)."""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np


class ResultTable(Mapping):
    """Ordered mapping of column name -> 1-D numpy array (equal lengths),
    saved as the same npz as the JAX package's table.

    ``meta`` is a free-form dict of per-table annotations that are not
    columns (the hybrid's noise-certificate verdict).  As in the JAX
    package it is NOT persisted by :meth:`to_npz`: the candidate npz
    holds the columns only.
    """

    def __init__(self, columns, meta=None):
        self._cols = {}
        self.meta = dict(meta) if meta else {}
        n = None
        for name, values in dict(columns).items():
            arr = np.asarray(values)
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise ValueError(
                    f"column {name!r} has length {arr.shape[0]} != {n}")
            self._cols[name] = arr
        self._nrows = 0 if n is None else n

    def __getitem__(self, name):
        return self._cols[name]

    def __iter__(self):
        return iter(self._cols)

    def __len__(self):
        return len(self._cols)

    @property
    def nrows(self):
        return self._nrows

    @property
    def colnames(self):
        return list(self._cols)

    def argbest(self, column="snr"):
        """Row index of the maximum of ``column`` (first one on ties)."""
        return int(np.argmax(self._cols[column]))

    def best_row(self, column="snr"):
        i = self.argbest(column)
        return {name: col[i] for name, col in self._cols.items()}

    def to_npz(self, path):
        np.savez(path, **self._cols)

    @classmethod
    def from_npz(cls, path):
        with np.load(path) as data:
            return cls({k: data[k] for k in data.files})

    def __repr__(self):
        cols = ", ".join(f"{k}[{self._nrows}]" for k in self._cols)
        return f"ResultTable({cols})"
