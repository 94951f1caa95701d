"""The ``.rio`` record format of a binarized corpus, and its native reader.

Port of ``dicttts_tpu/data/recordio.py``, byte-compatible with it in both
directions. Records are flat little-endian tensor blobs that numpy views
zero-copy from an mmap. The reader's mmap lifetime, record lookup and page
prefetch are host C++ (``csrc/recordio.cpp``, this package's own copy),
compiled with ``g++`` at first use into ``dicttts_tpu_torch/_build/`` and
loaded with ctypes; a failed build raises. ``RecordReader(path,
use_native=False)`` is the pure-Python mmap reader, the reference the
tests hold the native one against. ``convert_indexed_dataset`` writes a
``.data``/``.idx`` split as ``.rio``/``.rix`` (``record_item``).

Record layout:
  u32 n_tensors, then per tensor:
    u16 name_len, name bytes (utf-8)
    u8 dtype code (see DTYPES), u8 ndim, i64 dims[ndim]
    padding to 16-byte alignment, raw data bytes, padding to 16
Non-array values (ints, floats, strings, lists) travel as one JSON payload
in a uint8 tensor named ``__json__``.
Index file (.rix): i64 count, i64 offsets[count+1].
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import mmap
import os
import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from dicttts_tpu_torch.utils.indexed_dataset import IndexedDataset

DTYPES = {
    0: np.float32, 1: np.float16, 2: np.int64, 3: np.int32,
    4: np.int16, 5: np.uint8, 6: np.bool_, 7: np.float64,
}
DTYPE_CODES = {np.dtype(v): k for k, v in DTYPES.items()}
_JSON_NAME = "__json__"

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "recordio.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread", "-std=c++17")


def _align(n: int, a: int = 16) -> int:
    return (n + a - 1) // a * a


def encode_record(item: dict) -> bytes:
    """A dict of numpy arrays and JSON-able values (None skipped) -> record bytes."""
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {}
    for k, v in item.items():
        if v is None:
            continue
        if isinstance(v, np.ndarray) and v.dtype != object:
            arrays[k] = v
        elif isinstance(v, np.generic):
            meta[k] = v.item()
        elif isinstance(v, (int, float, str, bool, list)):
            meta[k] = v
        else:
            raise TypeError(f"recordio cannot store {k}: {type(v)}")
    if meta:
        arrays[_JSON_NAME] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8).copy()
    out = bytearray(struct.pack("<I", len(arrays)))
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        nb = name.encode()
        out += struct.pack("<H", len(nb)) + nb
        out += struct.pack("<BB", DTYPE_CODES[arr.dtype], arr.ndim)
        out += struct.pack(f"<{arr.ndim}q", *arr.shape)
        out += b"\0" * (_align(len(out)) - len(out))
        out += arr.tobytes()
        out += b"\0" * (_align(len(out)) - len(out))
    return bytes(out)


def decode_record(buf: memoryview) -> dict:
    """Record bytes -> dict; the arrays are zero-copy views into ``buf``."""
    (n_tensors,) = struct.unpack_from("<I", buf, 0)
    pos = 4
    out: dict = {}
    for _ in range(n_tensors):
        (name_len,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        name = bytes(buf[pos:pos + name_len]).decode()
        pos += name_len
        code, ndim = struct.unpack_from("<BB", buf, pos)
        pos += 2
        shape = struct.unpack_from(f"<{ndim}q", buf, pos)
        pos = _align(pos + 8 * ndim)
        dtype = np.dtype(DTYPES[code])
        count = int(np.prod(shape)) if ndim else 1
        arr = np.frombuffer(buf, dtype=dtype, count=count, offset=pos)
        out[name] = arr.reshape(shape) if ndim else arr[0]
        pos = _align(pos + count * dtype.itemsize)
    if _JSON_NAME in out:
        out.update(json.loads(bytes(out.pop(_JSON_NAME)).decode()))
    return out


class RecordWriter:
    """Appends records to ``<path>.rio``; ``finalize`` writes ``<path>.rix``."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path + ".rio", "wb")
        self.offsets = [0]

    def add(self, item: dict) -> None:
        data = encode_record(item)
        self._f.write(data)
        self.offsets.append(self.offsets[-1] + len(data))

    def finalize(self) -> None:
        self._f.close()
        with open(self.path + ".rix", "wb") as f:
            f.write(struct.pack("<q", len(self.offsets) - 1))
            f.write(np.asarray(self.offsets, dtype="<i8").tobytes())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()


def build() -> Path:
    """Compile ``csrc/recordio.cpp`` with g++ (``$CXX`` if set) unless the
    library for this source and these flags exists; it is written under a
    temporary name, then renamed into place. Raises RuntimeError if the
    compiler fails or is missing."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"librecordio_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = os.path.join(tmp, so.name)
        cxx = os.environ.get("CXX", "g++")
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp_so, str(SOURCE)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot build the native .rio reader: {cxx}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build the native .rio reader:\n{proc.stdout}")
        os.replace(tmp_so, so)
    return so


@functools.lru_cache(maxsize=None)
def native_lib() -> ctypes.CDLL:
    """The built reader library, loaded once per process, argtypes set."""
    lib = ctypes.CDLL(str(build()))
    lib.rio_open.restype = ctypes.c_void_p
    lib.rio_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.rio_close.argtypes = [ctypes.c_void_p]
    lib.rio_len.restype = ctypes.c_int64
    lib.rio_len.argtypes = [ctypes.c_void_p]
    lib.rio_record.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rio_record.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.rio_prefetch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    return lib


class RecordReader:
    """Random-access reader of ``<path>.rio`` / ``<path>.rix``: the native
    mmap reader with page prefetch (the default), or with
    ``use_native=False`` the pure-Python mmap reader."""

    def __init__(self, path: str, use_native: bool = True):
        self.path = path
        self._h = None
        self._mm = None
        if use_native:
            self._lib = native_lib()
            self._h = self._lib.rio_open((path + ".rio").encode(), (path + ".rix").encode())
            if not self._h:
                raise OSError(f"the native reader cannot open {path}.rio / {path}.rix")
        else:
            with open(path + ".rio", "rb") as f:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            with open(path + ".rix", "rb") as f:
                (count,) = struct.unpack("<q", f.read(8))
                self._offsets = np.frombuffer(f.read(8 * (count + 1)), dtype="<i8")

    @property
    def is_native(self) -> bool:
        return self._h is not None

    def __len__(self) -> int:
        if self._h is not None:
            return int(self._lib.rio_len(self._h))
        return len(self._offsets) - 1

    def __getitem__(self, i: int) -> dict:
        """Item ``i``, its arrays copied out of the mapping."""
        if self._h is not None:
            size = ctypes.c_int64()
            ptr = self._lib.rio_record(self._h, i, ctypes.byref(size))
            if not ptr or size.value <= 0:
                raise IndexError(i)
            buf = (ctypes.c_uint8 * size.value).from_address(ctypes.addressof(ptr.contents))
            item = decode_record(memoryview(buf).cast("B"))
        else:
            if i < 0 or i >= len(self):
                raise IndexError(i)
            item = decode_record(memoryview(self._mm)[int(self._offsets[i]):int(self._offsets[i + 1])])
        return {k: (np.array(v) if isinstance(v, np.ndarray) else v) for k, v in item.items()}

    def prefetch(self, ids) -> None:
        """Have the native reader's threads touch these records' pages (the
        Python reader does nothing)."""
        if self._h is not None:
            arr = np.asarray(list(ids), dtype=np.int64)
            self._lib.rio_prefetch(self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(arr))

    def close(self) -> None:
        if self._h is not None:
            self._lib.rio_close(self._h)
            self._h = None
        if self._mm is not None:
            self._mm.close()
            self._mm = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def record_item(item: dict) -> dict:
    """An item of a ``.data`` split as ``convert_indexed_dataset`` stores it:
    None and ragged lists dropped, lists of numbers as numpy arrays, lists
    of strings (``words``) kept as lists, which travel in the JSON payload.
    (The JAX package's converter turns those into numpy string arrays,
    which the format has no dtype code for, and fails on the corpus.)"""
    out = {}
    for k, v in item.items():
        if isinstance(v, list):
            try:
                a = np.asarray(v)
            except ValueError:  # ragged
                continue
            if a.dtype == object:
                continue
            v = a if a.dtype.kind in "biuf" else v
        elif v is None or not isinstance(v, (np.ndarray, int, float, str, bool, np.generic)):
            continue
        out[k] = v
    return out


def convert_indexed_dataset(src_path: str, dst_path: str) -> int:
    """The ``.data``/``.idx`` split at ``src_path`` as ``dst_path.rio`` /
    ``.rix``, each item as ``record_item`` stores it. Returns the item
    count."""
    with IndexedDataset(src_path) as ds, RecordWriter(dst_path) as w:
        for item in ds:
            w.add(record_item(item))
        return len(ds)
