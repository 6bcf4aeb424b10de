"""CSR ingestion/interchange format (host-side, numpy).

Counterpart of ``tpusparse/formats/csr.py``. Because the op is
``Y = X @ A``, ``CsrMatrix`` IS standard CSR over ``A.T``: row r lists the
nonzeros of output column r of A. The row-pointer array includes the final
sentinel (``len == n + 1``). This is an interchange format: the compute
formats (``SellMatrix``, ``AwspMatrix``) pack from it; no kernel gathers
through raw row pointers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def col_window_widths(csr, window: int = 128) -> np.ndarray:
    """(n,) per-output-column SELL width demand — the max nnz any
    ``window``-row slab of the contraction dim holds for that column."""
    m, n = csr.shape
    mb = -(-max(m, 1) // window)
    col_w = np.zeros(n, dtype=np.int64)
    if csr.nnz:
        r = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz)
        key = r * mb + csr.col_idx.astype(np.int64) // window
        uk, counts = np.unique(key, return_counts=True)
        np.maximum.at(col_w, uk // mb, counts)
    return col_w


def segment_ranks(key_a: np.ndarray,
                  key_b: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
    """Exclusive rank of each entry within its contiguous (key_a, key_b)
    run: (rank, run_start, run_counts). Entries must already be sorted so
    equal key pairs are adjacent."""
    k = key_a.size
    if k == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z
    new_run = np.empty(k, dtype=bool)
    new_run[0] = True
    new_run[1:] = (key_a[1:] != key_a[:-1]) | (key_b[1:] != key_b[:-1])
    run_start = np.flatnonzero(new_run)
    run_counts = np.diff(np.append(run_start, k))
    rank = np.arange(k) - np.repeat(run_start, run_counts)
    return rank, run_start, run_counts


def csr_rows_subset(csr, rows: np.ndarray) -> "CsrMatrix":
    """CSR whose row k is ``csr`` row ``rows[k]`` (shape (m, len(rows)));
    entries ``rows[k] >= n`` select empty rows (column padding)."""
    m, n = csr.shape
    rp = csr.row_ptr.astype(np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    safe = np.minimum(rows, n - 1)
    valid = rows < n
    starts = np.where(valid, rp[safe], 0)
    counts = np.where(valid, rp[safe + 1] - rp[safe], 0)
    out_ptr = np.zeros(rows.size + 1, dtype=np.int64)
    np.cumsum(counts, out=out_ptr[1:])
    total = int(out_ptr[-1])
    offs = np.arange(total, dtype=np.int64) - np.repeat(out_ptr[:-1], counts)
    src = np.repeat(starts, counts) + offs
    return CsrMatrix(shape=(m, int(rows.size)),
                     row_ptr=out_ptr.astype(np.int32),
                     col_idx=np.asarray(csr.col_idx)[src],
                     values=np.asarray(csr.values)[src])


def _host_numpy(a) -> np.ndarray:
    """numpy view of a host array or a tensor on any device (copied to the
    host; bf16/fp16 widen to fp32, which numpy can hold)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class CsrMatrix:
    """CSR of A.T: row r lists the nonzeros of output column r of A."""

    shape: tuple[int, int]          # (m, n) of the dense A
    row_ptr: np.ndarray             # (n + 1,) int32, includes final sentinel
    col_idx: np.ndarray             # (nnz,) int32 — indices into the M axis
    values: np.ndarray              # (nnz,) dtype

    @property
    def nnz(self) -> int:
        return int(self.values.size)

    @property
    def row_nnz(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    @classmethod
    def from_dense(cls, a, use_native: bool | None = None) -> "CsrMatrix":
        """Dense A as a numpy array or a tensor (copied to the host).
        ``use_native``: the C++ converter for fp32 A (None: where it
        built; True: raise when it did not)."""
        a = _host_numpy(a)
        m, n = a.shape
        if use_native is not False and a.dtype == np.float32:
            from tpusparse_torch import native

            if native.available():
                row_ptr, col_idx, values = native.csr_from_dense(a)
                return cls(shape=(m, n), row_ptr=row_ptr, col_idx=col_idx,
                           values=values)
            if use_native:
                raise RuntimeError("native converters requested but "
                                   "unavailable")
        at = a.T                                  # (n, m): rows = output cols
        mask = at != 0
        row_nnz = mask.sum(axis=1)
        row_ptr = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(row_nnz, out=row_ptr[1:])
        rows, cols = np.nonzero(mask)             # sorted by row, then col
        return cls(shape=(m, n), row_ptr=row_ptr,
                   col_idx=cols.astype(np.int32), values=at[rows, cols])

    @classmethod
    def from_coo(cls, m: int, n: int, rows: np.ndarray, cols: np.ndarray,
                 values: np.ndarray) -> "CsrMatrix":
        """COO triplets over A itself: A[rows[k], cols[k]] = values[k]."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        values = np.asarray(values)
        order = np.lexsort((rows, cols))          # sort by output col, then m
        rows, cols, values = rows[order], cols[order], values[order]
        row_ptr = np.zeros(n + 1, dtype=np.int32)
        np.add.at(row_ptr, cols + 1, 1)
        np.cumsum(row_ptr, out=row_ptr)
        return cls(shape=(m, n), row_ptr=row_ptr,
                   col_idx=rows.astype(np.int32), values=values)

    @classmethod
    def from_mtx(cls, path: str) -> "CsrMatrix":
        """MatrixMarket (.mtx) file, through scipy's reader."""
        from scipy import io as _sio

        return cls.from_scipy(_sio.mmread(path))

    @classmethod
    def from_scipy(cls, sp) -> "CsrMatrix":
        """Any ``scipy.sparse`` matrix. CSC's (indptr over columns, row
        indices) layout IS this class's CSR of A.T."""
        csc = sp.tocsc(copy=True)     # never alias/mutate the caller's data
        csc.sum_duplicates()
        csc.eliminate_zeros()         # keep nnz == count of true nonzeros
        m, n = csc.shape
        return cls(shape=(m, n), row_ptr=csc.indptr.astype(np.int32),
                   col_idx=csc.indices.astype(np.int32),
                   values=np.array(csc.data))

    def to_scipy(self):
        """The same matrix as ``scipy.sparse.csc_matrix``."""
        from scipy import sparse

        m, n = self.shape
        return sparse.csc_matrix(
            (self.values, self.col_idx, self.row_ptr), shape=(m, n))

    @classmethod
    def from_torch(cls, t: torch.Tensor) -> "CsrMatrix":
        """Any 2-D tensor: dense (strided) or sparse COO/CSR/CSC, on any
        device. Gradients are detached; data is copied to the host."""
        if t.ndim != 2:
            raise ValueError(f"expected a 2-D tensor, got shape "
                             f"{tuple(t.shape)}")
        t = t.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        if t.layout == torch.strided:
            return cls.from_dense(t)
        if t.layout in (torch.sparse_csr, torch.sparse_csc):
            t = t.to_sparse_coo()
        t = t.coalesce().cpu()
        idx = t.indices().numpy()
        m, n = t.shape
        return cls.from_coo(int(m), int(n), idx[0], idx[1],
                            t.values().numpy())

    def to_torch(self) -> torch.Tensor:
        """The same matrix as ``torch.sparse_csc_tensor`` — CSR of A.T IS
        CSC of A, so the handoff is pointer-exact."""
        m, n = self.shape
        return torch.sparse_csc_tensor(
            torch.from_numpy(np.ascontiguousarray(self.row_ptr)).long(),
            torch.from_numpy(np.ascontiguousarray(self.col_idx)).long(),
            torch.from_numpy(np.ascontiguousarray(self.values)),
            size=(m, n))

    def transpose(self) -> "CsrMatrix":
        """``CsrMatrix`` describing ``A.T`` (shape (n, m)). O(nnz) counting
        sort; entries stay sorted by output column then contraction index."""
        m, n = self.shape
        counts = np.bincount(self.col_idx, minlength=m)
        row_ptr = np.zeros(m + 1, dtype=np.int32)
        np.cumsum(counts, out=row_ptr[1:])
        j_of = np.repeat(np.arange(n, dtype=np.int32),
                         self.row_nnz.astype(np.int64))
        order = np.argsort(self.col_idx, kind="stable")
        return CsrMatrix(shape=(n, m), row_ptr=row_ptr,
                         col_idx=j_of[order], values=self.values[order])

    def to_dense(self) -> np.ndarray:
        m, n = self.shape
        at = np.zeros((n, m), dtype=self.values.dtype)
        rows = np.repeat(np.arange(n), self.row_nnz)
        # duplicates sum, matching what every packed kernel does
        np.add.at(at, (rows, self.col_idx), self.values)
        return at.T

    def save(self, path: str) -> None:
        """npz with ``shape``, ``row_ptr``, ``col_idx`` and ``values``: the
        JAX package's ``CsrMatrix.save`` layout, so either loads it."""
        np.savez_compressed(path, shape=np.asarray(self.shape),
                            row_ptr=self.row_ptr, col_idx=self.col_idx,
                            values=self.values)

    @classmethod
    def load(cls, path: str) -> "CsrMatrix":
        with np.load(path) as z:
            return cls(shape=tuple(int(v) for v in z["shape"]),
                       row_ptr=z["row_ptr"], col_idx=z["col_idx"],
                       values=z["values"])
