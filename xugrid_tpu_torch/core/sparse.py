"""
Sparse weight-matrix containers for regridding (host, numpy).

``MatrixCOO`` and ``MatrixCSR`` are the weight triplets as the weight
build emits them.  ``PaddedCSR`` pads every target row to the widest
window, giving the (n_target, w_max) index and weight tables that the
apply kernels read directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from xugrid_tpu_torch.constants import IntDType


class MatrixCOO(NamedTuple):
    """Sparse matrix in coordinate (triplet) form."""

    data: np.ndarray
    row: np.ndarray
    col: np.ndarray
    n: int
    m: int
    nnz: int

    @staticmethod
    def from_triplet(row, col, data, n=None, m=None) -> "MatrixCOO":
        """``n`` and ``m`` default to one past the largest row and
        column index."""
        if n is None:
            n = int(np.max(row)) + 1
        if m is None:
            m = int(np.max(col)) + 1
        return MatrixCOO(
            np.asarray(data, dtype=np.float64),
            np.asarray(row, dtype=IntDType),
            np.asarray(col, dtype=IntDType),
            int(n),
            int(m),
            len(data),
        )

    def to_csr(self) -> "MatrixCSR":
        from xugrid_tpu_torch.utils.native import csr_from_triplet_native
        from xugrid_tpu_torch.utils.profiling import timed

        with timed("sparse.csr_from_triplet"):
            native = csr_from_triplet_native(self.row, self.col, self.data, self.n)
        if native is not None:
            data, col, indptr = native
            return MatrixCSR(data, col, indptr, self.n, self.m, self.nnz)
        order = np.argsort(self.row, kind="stable")
        indptr = np.zeros(self.n + 1, dtype=IntDType)
        np.add.at(indptr, self.row[order] + 1, 1)
        np.cumsum(indptr, out=indptr)
        return MatrixCSR(
            self.data[order], self.col[order], indptr, self.n, self.m, self.nnz
        )


class MatrixCSR(NamedTuple):
    """Sparse matrix in compressed row form."""

    data: np.ndarray
    indices: np.ndarray
    indptr: np.ndarray
    n: int
    m: int
    nnz: int

    @staticmethod
    def from_triplet(row, col, data, n=None, m=None) -> "MatrixCSR":
        return MatrixCOO.from_triplet(row, col, data, n, m).to_csr()

    def to_coo(self) -> MatrixCOO:
        row = np.repeat(np.arange(self.n, dtype=IntDType), np.diff(self.indptr))
        return MatrixCOO(self.data, row, self.indices, self.n, self.m, self.nnz)


def nzrange(A: MatrixCSR, row: int):
    """Non-zero range of a CSR row."""
    return A.indptr[row], A.indptr[row + 1]


def row_slice(A: MatrixCSR, row: int) -> slice:
    start, end = nzrange(A, row)
    return slice(start, end)


def columns_and_values(A: MatrixCSR, row_sl: slice):
    return A.indices[row_sl], A.data[row_sl]


class PaddedCSR(NamedTuple):
    """
    Dense-window CSR: (n, w_max) column indices (-1 padded) and weights
    (0 padded).
    """

    indices: np.ndarray  # (n, w_max) int32
    weights: np.ndarray  # (n, w_max) float
    n: int
    m: int
    w_max: int

    @staticmethod
    def from_csr(A: MatrixCSR, dtype=np.float64) -> "PaddedCSR":
        n_per_row = np.diff(A.indptr)
        w_max = max(int(n_per_row.max()) if len(n_per_row) else 0, 1)
        indices = np.full((A.n, w_max), -1, dtype=np.int32)
        weights = np.zeros((A.n, w_max), dtype=dtype)
        cols = np.arange(w_max)[np.newaxis, :] < n_per_row[:, np.newaxis]
        indices[cols] = A.indices
        weights[cols] = A.data.astype(dtype)
        return PaddedCSR(indices, weights, A.n, A.m, w_max)

    @staticmethod
    def from_coo(A: MatrixCOO, dtype=np.float64) -> "PaddedCSR":
        return PaddedCSR.from_csr(A.to_csr(), dtype)
