"""ctypes bindings for the native host-side data pipeline (native/insider_io.cpp).

Builds lazily with `make` on first use; every function has a pure-numpy
fallback so the package works without a toolchain.  The native splitter uses
a splitmix64 counter RNG (deterministic per (seed, index), parallel), which
is a different — but equally valid — stream than the numpy splitter;
both honor the ratio_splitter contract (R/utils.R:78-117).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO = os.path.join(_NATIVE_DIR, "libinsider_io.so")

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # Always invoke make: it is a no-op when the .so is current and rebuilds
    # it when insider_io.cpp changed (a stale .so would break the ABI the
    # bindings below assume).
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
    except Exception:
        if not os.path.exists(_SO):
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.insider_csv_shape.restype = ctypes.c_int
    lib.insider_csv_shape.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.insider_csv_parse.restype = ctypes.c_int64
    lib.insider_csv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.insider_log2p1.restype = None
    lib.insider_log2p1.argtypes = [ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64]
    lib.insider_split_mask.restype = ctypes.c_int64
    lib.insider_split_mask.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_double,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.insider_block_read_f32.restype = ctypes.c_int
    lib.insider_block_read_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.insider_split_mask_block.restype = ctypes.c_int64
    lib.insider_split_mask_block.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def load_csv(path: str, delim: str = ",", skip_header: bool = False,
             strict: bool = True) -> np.ndarray:
    """Parse a numeric CSV/TSV into float32 (NaN for NA/NaN/empty fields;
    double-quoted fields unwrapped).

    strict: raise ValueError when any field is neither numeric nor a
    recognized NA token (e.g. "N5", "null") instead of silently reading it
    as missing data.
    """
    lib = _load()
    if lib is None:
        return np.genfromtxt(path, delimiter=delim,
                             skip_header=1 if skip_header else 0,
                             dtype=np.float32)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.insider_csv_shape(path.encode(), delim.encode(),
                               int(skip_header), ctypes.byref(rows),
                               ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"insider_csv_shape({path}) failed: {rc}")
    out = np.empty((rows.value, cols.value), np.float32)
    bad = ctypes.c_int64()
    done = lib.insider_csv_parse(
        path.encode(), delim.encode(), int(skip_header),
        rows.value, cols.value,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(bad),
    )
    if done != rows.value:
        raise IOError(f"insider_csv_parse parsed {done}/{rows.value} rows")
    if strict and bad.value:
        raise ValueError(
            f"{path}: {bad.value} field(s) are neither numeric nor NA/NaN "
            f"(pass strict=False to read them as missing)")
    return out


def log2p1(data: np.ndarray) -> np.ndarray:
    """In-place log2(x+1) (README.md:47) on a float32 array."""
    data = np.ascontiguousarray(data, np.float32)
    lib = _load()
    if lib is None:
        np.log2(np.maximum(data, 0.0) + 1.0, out=data)
        return data
    lib.insider_log2p1(data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       data.size)
    return data


def split_mask(data: np.ndarray, ratio: float, seed: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(train, test, na) uint8 masks + n_test, ratio_splitter semantics."""
    data32 = np.ascontiguousarray(data, np.float32)
    lib = _load()
    train = np.empty(data.shape, np.uint8)
    test = np.empty(data.shape, np.uint8)
    na = np.empty(data.shape, np.uint8)
    if lib is None:
        nan = np.isnan(data32)
        na[:] = nan
        rng = np.random.default_rng(seed)
        obs = np.flatnonzero(~nan.ravel())
        k = int(obs.size * ratio)
        pick = rng.choice(obs, size=k, replace=False)
        test[:] = 0
        test.ravel()[pick] = 1
        train[:] = (~nan) & (test == 0)
        return train, test, na, k
    picked = lib.insider_split_mask(
        data32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data32.size, float(ratio), int(seed),
        train.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        test.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        na.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return train, test, na, int(picked)


def read_block(path: str, global_shape: Tuple[int, int],
               rows: Tuple[int, int], cols: Tuple[int, int]) -> np.ndarray:
    """Read block [r0,r1) x [c0,c1) of a raw row-major float32 matrix file.

    The per-shard reader for build_problem_distributed: a process touches
    only its own block's bytes (pread per row, OpenMP over rows natively;
    memmap fallback).
    """
    N, M = global_shape
    (r0, r1), (c0, c1) = rows, cols
    lib = _load()
    if lib is None:
        mm = np.memmap(path, dtype=np.float32, mode="r", shape=(N, M))
        return np.array(mm[r0:r1, c0:c1])
    out = np.empty((r1 - r0, c1 - c0), np.float32)
    rc = lib.insider_block_read_f32(
        path.encode(), M, r0, r1, c0, c1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise IOError(f"insider_block_read_f32({path}, rows={rows}, "
                      f"cols={cols}) failed: {rc}")
    return out


def split_mask_block(global_shape: Tuple[int, int],
                     rows: Tuple[int, int], cols: Tuple[int, int],
                     ratio: float, seed: int,
                     data_block: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train, test, na) uint8 masks for ONE block of a global split.

    Deterministic in (seed, global element index): every process generates
    its own block and the blocks tile into one consistent global split —
    no process ever holds the full mask (the distributed-ingestion analog
    of ratio_splitter).

    SPLITTER VARIANT: this is element-wise Bernoulli(ratio) on
    a per-element splitmix64 stream, NOT the exact-floor(n*ratio)-element
    selection of split_mask/ratio_splitter — exact-k selection needs a
    global pass no process can do here.  The same (data, seed) therefore
    yields a DIFFERENT train/test partition via the two ingestion paths;
    runs are comparable only within one path.  build_problem_distributed
    records the variant in Problem.split_variant so a mixed comparison is
    detectable (see native/insider_io.cpp for the exact-k trade-off note).
    """
    N, M = global_shape
    (r0, r1), (c0, c1) = rows, cols
    shape = (r1 - r0, c1 - c0)
    lib = _load()
    if lib is None:
        # numpy fallback: identical splitmix64 stream
        gi = (np.arange(r0, r1, dtype=np.uint64)[:, None] * np.uint64(M)
              + np.arange(c0, c1, dtype=np.uint64)[None, :])
        x = gi ^ np.uint64(seed)
        with np.errstate(over="ignore"):
            x = (x + np.uint64(0x9E3779B97F4A7C15))
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            x = x ^ (x >> np.uint64(31))
        cut = np.uint64(min(ratio, 1.0) * 18446744073709551616.0) \
            if ratio < 1.0 else np.uint64(0xFFFFFFFFFFFFFFFF)
        test = (x < cut).astype(np.uint8)
        na = (np.zeros(shape, np.uint8) if data_block is None
              else np.isnan(data_block).astype(np.uint8))
        test[na == 1] = 0
        train = ((test == 0) & (na == 0)).astype(np.uint8)
        return train, test, na
    train = np.empty(shape, np.uint8)
    test = np.empty(shape, np.uint8)
    na = np.empty(shape, np.uint8)
    dptr = (None if data_block is None else
            np.ascontiguousarray(data_block, np.float32))
    lib.insider_split_mask_block(
        (dptr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
         if dptr is not None else None),
        M, r0, r1, c0, c1, float(ratio), int(seed),
        train.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        test.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        na.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return train, test, na


def file_ingest_callbacks(path: str, global_shape: Tuple[int, int],
                          ratio: float, seed: int):
    """Per-shard-callback bundle for als.build_problem_distributed.

    Returns (data_cb, train_cb, test_cb): each takes the index tuple of
    slices the sharding machinery passes per addressable shard and returns
    that shard's block — data via native block pread of the raw f32 file,
    masks via the deterministic block splitter.  No allocation ever exceeds
    one shard; every process sees a consistent global split.

    NOTE the splitter-variant caveat on split_mask_block: the partition is
    Bernoulli(ratio) per element, not ratio_splitter's exact-k sample — a
    from-file distributed run and an in-memory run of the same (data,
    seed) hold out different test elements.
    """
    N, M = global_shape

    def _bounds(index):
        rs = index[0].indices(N)
        cs = index[1].indices(M)
        return (rs[0], rs[1]), (cs[0], cs[1])

    def data_cb(index):
        rows, cols = _bounds(index)
        return read_block(path, global_shape, rows, cols)

    def train_cb(index):
        rows, cols = _bounds(index)
        blk = read_block(path, global_shape, rows, cols)
        return split_mask_block(global_shape, rows, cols, ratio, seed,
                                data_block=blk)[0]

    def test_cb(index):
        rows, cols = _bounds(index)
        blk = read_block(path, global_shape, rows, cols)
        return split_mask_block(global_shape, rows, cols, ratio, seed,
                                data_block=blk)[1]

    return data_cb, train_cb, test_cb
