"""Sparse frames — COO storage for wide-sparse data on the device — the
port of ``h2o3_tpu/frame/sparse.py`` (reference: the sparse chunk codecs
``water/fvec/CXIChunk.java``/``CXFChunk.java``; SVMLight ingest,
``water/parser/SVMLightParser.java``).

A :class:`SparseMatrix` keeps the COO triplet (``data``/``row``/``col``) of
its nonzeros, with no padding. The two products a linear model needs are
one gather and one ``index_add_`` each:

    X @ v      = index_add over row of data * v[col]
    X.T @ u    = index_add over col of data * u[row]

On the card ``index_add_`` adds with atomics, so the order of a row's sum
varies from run to run in the last bits; the reference's ``segment_sum``s
are XLA's. Dense side columns (response, weights, offset) stay
:class:`~h2o3_tpu_torch.frame.vec.Vec` columns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.vec import Vec


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int):
    return torch.zeros(n, dtype=vals.dtype,
                       device=vals.device).index_add_(0, seg, vals)


@dataclasses.dataclass
class SparseMatrix:
    """COO on one device."""
    data: torch.Tensor     # float32 [nnz]
    row: torch.Tensor      # int64 [nnz]
    col: torch.Tensor      # int64 [nnz]
    nrows: int
    ncols: int

    @property
    def nnz(self) -> int:
        return self.data.numel()

    @staticmethod
    def from_scipy_like(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                        nrows: int, ncols: int,
                        device: str | torch.device | None = None
                        ) -> "SparseMatrix":
        """From host COO arrays (values rounded to float32)."""
        dev = resolve_device(device)
        return SparseMatrix(
            torch.as_tensor(np.asarray(vals, np.float32)).to(dev),
            torch.as_tensor(np.asarray(rows, np.int64)).to(dev),
            torch.as_tensor(np.asarray(cols, np.int64)).to(dev),
            int(nrows), int(ncols))

    @property
    def device(self) -> torch.device:
        return self.data.device

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """X @ v → [nrows]."""
        return _segment_sum(self.data * v[self.col], self.row, self.nrows)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        """X.T @ u → [ncols]."""
        return _segment_sum(self.data * u[self.row], self.col, self.ncols)

    def col_sq_weighted(self, w_rows: torch.Tensor) -> torch.Tensor:
        """Σ_r w_r x_rj² per column — the diagonal of X'WX (the Jacobi
        preconditioner of the CG solve)."""
        return _segment_sum(self.data * self.data * w_rows[self.row],
                            self.col, self.ncols)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros((self.nrows, self.ncols), dtype=torch.float32,
                          device=self.device)
        return out.index_put_((self.row, self.col), self.data,
                              accumulate=True)


class SparseFrame:
    """A wide-sparse design + dense side columns (response/weights/offset):
    just enough of :class:`~h2o3_tpu_torch.frame.frame.Frame` for the
    sparse model paths."""

    def __init__(self, X: SparseMatrix, dense_cols: dict[str, Vec] | None = None,
                 key: str | None = None):
        self.X = X
        self.dense: dict[str, Vec] = dense_cols or {}
        self.key = key

    @property
    def nrows(self) -> int:
        return self.X.nrows

    @property
    def ncols(self) -> int:
        return self.X.ncols

    @property
    def device(self) -> torch.device:
        return self.X.device

    def vec(self, name: str) -> Vec:
        return self.dense[name]

    def row_mask(self) -> torch.Tensor:
        """All rows are logical (COO carries no padding)."""
        return torch.ones(self.nrows, dtype=torch.bool, device=self.device)

    def __contains__(self, name: str) -> bool:
        return name in self.dense

    def density(self) -> float:
        return self.X.nnz / max(self.X.nrows * self.X.ncols, 1)

    def __repr__(self) -> str:
        return (f"SparseFrame({self.nrows} x {self.ncols}, nnz={self.X.nnz}"
                f" [{100 * self.density():.3f}%], dense={list(self.dense)})")


def parse_svmlight_sparse(path: str, key: str | None = None,
                          device: str | torch.device | None = None
                          ) -> SparseFrame:
    """SVMLight → SparseFrame without densifying (reference:
    SVMLightParser fills CXI chunks). Lines are ``label [qid:n] idx:val
    ...``; ``#`` starts a comment. Indices are one-based unless some index
    is 0 (the "auto" rule of the common loaders); the width is the largest
    index + 1. The response is named ``C0``, as on the dense route."""
    labels, rows, cols, vals = [], [], [], []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].split()
            if not line:
                continue
            r = len(labels)
            labels.append(float(line[0]))
            for tok in line[1:]:
                idx, val = tok.split(":", 1)
                if idx == "qid":
                    continue
                rows.append(r)
                cols.append(int(idx))
                vals.append(float(val))
    cols_a = np.asarray(cols, np.int64)
    if cols_a.size and cols_a.min() > 0:
        cols_a -= 1
    ncols = int(cols_a.max()) + 1 if cols_a.size else 0
    X = SparseMatrix.from_scipy_like(np.asarray(rows, np.int64), cols_a,
                                     np.asarray(vals, np.float64),
                                     len(labels), ncols, device=device)
    yv = Vec.from_numpy(np.asarray(labels, np.float32), device=device)
    return SparseFrame(X, {"C0": yv}, key=key)
