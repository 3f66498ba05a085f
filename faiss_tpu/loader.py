"""Bulk ingestion: stream large datasets from disk into an index.

The reference has no data loader (vectors arrive via ``add(n, x)`` from user
memory); at accelerator scale the interesting ingest path is disk → host staging →
(threaded C++ dtype conversion, native/) → device shards, chunk by chunk, so
a 100M×128 build never holds the fp32 dataset in host RAM. `.fvecs`/`.bvecs`
support covers the standard ANN benchmark formats (SIFT1M etc.).
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, Optional

import numpy as np

DEFAULT_BATCH_ROWS = 262_144


def iter_npy_batches(path: str, batch_rows: int = DEFAULT_BATCH_ROWS
                     ) -> Iterator[np.ndarray]:
    """Yield fp32 (rows, d) batches from a .npy file via memmap."""
    mm = np.load(path, mmap_mode="r")
    if mm.ndim != 2:
        raise ValueError(f"expected a 2-D array in {path}, got {mm.shape}")
    for lo in range(0, mm.shape[0], batch_rows):
        yield np.asarray(mm[lo : lo + batch_rows], dtype=np.float32)


def iter_fvecs_batches(path: str, batch_rows: int = DEFAULT_BATCH_ROWS
                       ) -> Iterator[np.ndarray]:
    """Yield batches from an .fvecs file (TexMex format: per row, int32 d
    then d float32s — the SIFT/GIST benchmark format)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = np.fromfile(f, np.int32, 1)
    if head.size == 0:
        return
    d = int(head[0])
    row_bytes = 4 * (d + 1)
    if size % row_bytes:
        raise ValueError(f"{path}: not a whole number of {d}-d fvecs rows")
    n = size // row_bytes
    mm = np.memmap(path, np.float32, "r", shape=(n, d + 1))
    for lo in range(0, n, batch_rows):
        yield np.ascontiguousarray(mm[lo : lo + batch_rows, 1:],
                                   dtype=np.float32)


def iter_bvecs_batches(path: str, batch_rows: int = DEFAULT_BATCH_ROWS
                       ) -> Iterator[np.ndarray]:
    """Yield batches from a .bvecs file (int32 d then d uint8s per row)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = np.fromfile(f, np.int32, 1)
    if head.size == 0:
        return
    d = int(head[0])
    row_bytes = 4 + d
    if size % row_bytes:
        raise ValueError(f"{path}: not a whole number of {d}-d bvecs rows")
    n = size // row_bytes
    mm = np.memmap(path, np.uint8, "r", shape=(n, row_bytes))
    for lo in range(0, n, batch_rows):
        yield mm[lo : lo + batch_rows, 4:].astype(np.float32)


_READERS = {
    ".npy": iter_npy_batches,
    ".fvecs": iter_fvecs_batches,
    ".bvecs": iter_bvecs_batches,
}


def iter_file_batches(path: str, batch_rows: int = DEFAULT_BATCH_ROWS
                      ) -> Iterator[np.ndarray]:
    ext = os.path.splitext(path)[1].lower()
    try:
        reader = _READERS[ext]
    except KeyError:
        raise ValueError(
            f"unsupported dataset format {ext!r} (supported: {sorted(_READERS)})"
        ) from None
    return reader(path, batch_rows)


def add_batches(index, batches: Iterable[np.ndarray]) -> int:
    """Stream batches into any index with .add(). JAX's async dispatch
    overlaps each batch's device work with reading/converting the next.
    Returns rows added."""
    n = 0
    for b in batches:
        index.add(b)
        n += b.shape[0]
    return n


def build_index_from_file(
    path: str,
    metric="l2",
    storage="float32",
    sharded: bool = False,
    resources=None,
    batch_rows: int = DEFAULT_BATCH_ROWS,
    d: Optional[int] = None,
):
    """Build a TpuIndexFlat / ShardedIndexFlat by streaming a dataset file."""
    from .index import TpuIndexFlat
    from .parallel.sharded import ShardedIndexFlat

    batches = iter_file_batches(path, batch_rows)
    first = next(iter(batches), None)
    if first is None and d is None:
        raise ValueError(f"{path} is empty and no d was given")
    dim = first.shape[1] if first is not None else d
    cls = ShardedIndexFlat if sharded else TpuIndexFlat
    idx = cls(dim, metric=metric, storage=storage, resources=resources)
    if first is not None:
        idx.add(first)
        add_batches(idx, batches)
    return idx
