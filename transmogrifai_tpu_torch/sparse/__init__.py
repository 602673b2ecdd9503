"""Sparse device representation for wide hashed features (port of
``transmogrifai_tpu/sparse``).

- :mod:`.matrix` — ``SparseMatrix``, a flat-COO container on one device with
  row- and column-sorted orders for the two product kernels;
- :mod:`.sparse_kernels` — ``sp_matmat`` / ``sp_rmatmat`` (hand-written
  CUDA, ``csrc/sp_matmat.cu`` and ``csrc/sp_rmatmat.cu``) and their twins;
- :mod:`.transform` — hashed text → SparseMatrix (host dedupe), block
  stacking, and the process-wide nnz/density stats.
"""

from .matrix import (SparseMatrix, nnz_capacity, sp_matmat,  # noqa: F401
                     sp_matvec, sp_rmatmat, sp_rmatvec)
from .transform import (combine_blocks, hash_tokens_to_sparse,  # noqa: F401
                        record_sparse_stats, reset_sparse_stats,
                        sparse_from_hash_flat, sparse_stats)

__all__ = [
    "SparseMatrix",
    "nnz_capacity",
    "sp_matvec",
    "sp_rmatvec",
    "sp_matmat",
    "sp_rmatmat",
    "sparse_from_hash_flat",
    "hash_tokens_to_sparse",
    "combine_blocks",
    "sparse_stats",
    "record_sparse_stats",
    "reset_sparse_stats",
]
