"""Quantile bin edges and feature binning — the port of ``h2o3_tpu/ops/quantile.py``.

Edges come once per training run from a row sample (:func:`compute_bin_edges`,
numpy, copied from the reference); the full columns are then binned on the
device by ``searchsorted``. Missing values get their own bin (``nbins``), so
trees learn a default direction for them.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_bin_edges(X_host: np.ndarray, nbins: int,
                      w_host: np.ndarray | None = None) -> np.ndarray:
    """Per-feature quantile edges, shape [F, nbins-1] (inf-padded).

    ``X_host``: a row sample [n, F] (NaNs allowed); ``w_host``: matching
    per-row weights.  Bin b covers [edges[b-1], edges[b]);
    bin(x) = #edges <= x.

    Quantiles are weighted inverted-CDF (the smallest value whose
    cumulative weight reaches q·total).  That definition makes a row
    with weight k bin IDENTICALLY to the same row repeated k times —
    the reference's weights-as-replication contract
    (``pyunit_weights_gbm.py``; ``hex/tree/DHistogram`` sees weighted
    counts the same way).
    """
    n, F = X_host.shape
    qs = np.linspace(0, 1, nbins + 1)[1:-1]
    edges = np.full((F, nbins - 1), np.inf, np.float32)
    if w_host is None:
        w_host = np.ones(n, np.float64)
    for f in range(F):
        col = X_host[:, f]
        m = ~np.isnan(col) & (w_host > 0)
        col, w = col[m], w_host[m]
        if col.size == 0:
            continue
        order = np.argsort(col, kind="stable")
        c, cw = col[order], np.cumsum(w[order])
        pos = np.searchsorted(cw, qs * cw[-1], side="left")
        e = np.unique(c[np.clip(pos, 0, len(c) - 1)])
        edges[f, : len(e)] = e
    return edges


def bin_dtype(nbins: int) -> torch.dtype:
    """Narrowest integer dtype for bin ids 0..nbins (``nbins`` is the NA
    bin): int8 up to 125 bins, else int16 — the reference's threshold,
    which also leaves room for its Pallas pad sentinel ``nbins + 2``."""
    return torch.int8 if nbins + 2 <= 127 else torch.int16


def bin_column(col: torch.Tensor, edges_f: torch.Tensor, nbins: int,
               dtype: torch.dtype) -> torch.Tensor:
    """One float32 column → bins: the count of edges <= x; NaN → ``nbins``."""
    b = torch.searchsorted(edges_f, col, right=True)
    return torch.where(torch.isnan(col), nbins, b).to(dtype)


def bin_features(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Bin a [rows, F] float32 matrix → int8/int16 bins in [0, B]; NaN → B
    (the missing bin), where B = edges.shape[1] + 1."""
    nbins = edges.shape[1] + 1
    dtype = bin_dtype(nbins)
    return torch.stack([bin_column(X[:, f].contiguous(), edges[f], nbins,
                                   dtype) for f in range(X.shape[1])], 1)
