"""ctypes bindings for the port's native C++ ANN index (csrc/vecindex.cpp).

Counterpart of generativeaiexamples_tpu/retrieval/native_index.py, with
its names, ctypes surface and file format: a flat or IVF-flat index in a
small C library, compiled at first use with the host's C++ compiler
(``$CXX``, else ``g++``) and the JAX package's flags
(``-O3 -march=native -ffast-math -fPIC -shared -std=c++17``), and loaded
through ctypes. An index saved by either package's library loads in the
other's (the ``.vecidx`` layout of the C source).

The library goes into the port's build directory (``build/torch_kernels/``
at the repository root, beside the CUDA kernels of ops/_build.py), named
by a digest of its source, the compiler, the flags and the host CPU's
model and feature flags: ``-march=native`` code is built for the machine
that runs it, and a library built on another CPU is never loaded.

Nothing is built at import time. ``available()`` builds and loads the
library and says whether that worked; when it did not,
``unavailable_reason()`` holds the error, and the store factory serves the
in-process store instead (retrieval/store.py), as JAX's does. ctypes
releases the GIL during a call, so each ``NativeIndex`` serializes its
calls under its own lock.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from generativeaiexamples_tpu_torch.ops._build import BUILD_DIR

SRC_PATH = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "vecindex.cpp"
FLAGS = ["-O3", "-march=native", "-ffast-math", "-fPIC", "-shared", "-std=c++17"]

_BUILD_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None  # written under _BUILD_LOCK
_ERROR: Optional[str] = None  # the last build or load failure

METRIC_IP = 0
METRIC_L2 = 1


class NativeUnavailable(RuntimeError):
    pass


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def _host_cpu() -> str:
    """The CPU's model and feature flags (what ``-march=native`` compiles
    for), or the machine type where /proc/cpuinfo is not readable."""
    import platform

    keep = []
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as fh:
            for line in fh:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part") and line not in keep:
                    keep.append(line)
                if not line.strip() and keep:
                    break  # the first processor's block
    except OSError:
        pass
    return "".join(keep) or platform.machine()


def library_path() -> pathlib.Path:
    """Where the library for this source, compiler, flags and CPU lives."""
    key = b"\0".join([SRC_PATH.read_bytes(), _compiler().encode(), " ".join(FLAGS).encode(),
                      _host_cpu().encode()])
    return BUILD_DIR / f"vecindex-{hashlib.sha256(key).hexdigest()[:16]}.so"


def ensure_built() -> str:
    """Compile the shared library if it is missing; returns its path."""
    with _BUILD_LOCK:
        if not SRC_PATH.exists():
            raise NativeUnavailable(f"missing source {SRC_PATH}")
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_compiler(), *FLAGS, "-o", str(tmp), str(SRC_PATH)]
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            except (subprocess.CalledProcessError, OSError, subprocess.TimeoutExpired) as exc:
                detail = getattr(exc, "stderr", b"") or b""
                tmp.unlink(missing_ok=True)
                raise NativeUnavailable(
                    f"native build failed: {exc}: {detail[:500].decode(errors='replace')}"
                ) from exc
            os.replace(tmp, out)
    return str(out)


def _load_lib() -> ctypes.CDLL:
    global _LIB, _ERROR
    if _LIB is not None:
        return _LIB
    try:
        path = ensure_built()
        lib = ctypes.CDLL(path)
    except (NativeUnavailable, OSError) as exc:
        _ERROR = str(exc)
        raise NativeUnavailable(_ERROR) from exc
    c = ctypes
    lib.vi_create.restype = c.c_void_p
    lib.vi_create.argtypes = [c.c_int, c.c_int, c.c_int]
    lib.vi_free.restype = None
    lib.vi_free.argtypes = [c.c_void_p]
    lib.vi_is_trained.restype = c.c_int
    lib.vi_is_trained.argtypes = [c.c_void_p]
    lib.vi_count.restype = c.c_int64
    lib.vi_count.argtypes = [c.c_void_p]
    lib.vi_dim.restype = c.c_int
    lib.vi_dim.argtypes = [c.c_void_p]
    lib.vi_train.restype = None
    lib.vi_train.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_int64, c.c_int, c.c_uint64]
    lib.vi_add.restype = c.c_int64
    lib.vi_add.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_int64]
    lib.vi_search.restype = None
    lib.vi_search.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_int64, c.c_int, c.c_int,
                              c.POINTER(c.c_float), c.POINTER(c.c_int64)]
    lib.vi_remove.restype = c.c_int64
    lib.vi_remove.argtypes = [c.c_void_p, c.POINTER(c.c_int64), c.c_int64]
    lib.vi_save.restype = c.c_int
    lib.vi_save.argtypes = [c.c_void_p, c.c_char_p]
    lib.vi_load.restype = c.c_void_p
    lib.vi_load.argtypes = [c.c_char_p]
    with _BUILD_LOCK:
        _LIB = lib
        _ERROR = None
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load_lib()
        return True
    except NativeUnavailable:
        return False


def unavailable_reason() -> Optional[str]:
    """The error of the last failed build or load, None after a success."""
    return _ERROR


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeIndex:
    """Flat (nlist=0) or IVF-flat ANN index backed by the C++ library."""

    def __init__(self, dim: int, metric: int = METRIC_IP, nlist: int = 0,
                 _handle: Optional[int] = None):
        self._lib = _load_lib()
        self.dim = dim
        self.metric = metric
        self.nlist = nlist
        self._handle = _handle if _handle is not None else self._lib.vi_create(
            dim, metric, nlist
        )
        self._lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            if self._handle:
                self._lib.vi_free(self._handle)
                self._handle = None

    def __del__(self):  # best effort
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    def _h(self) -> int:
        """The open handle (callers hold ``_lock``)."""
        if not self._handle:
            raise ValueError("the native index is closed")
        return self._handle

    # -- ops -------------------------------------------------------------
    @property
    def is_trained(self) -> bool:
        with self._lock:
            return bool(self._lib.vi_is_trained(self._h()))

    def __len__(self) -> int:
        with self._lock:
            return int(self._lib.vi_count(self._h()))

    def _rows(self, vectors) -> np.ndarray:
        vectors = np.ascontiguousarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"expected [N, {self.dim}], got {vectors.shape}")
        return vectors

    def train(self, vectors: np.ndarray, iters: int = 10, seed: int = 1234) -> None:
        vectors = self._rows(vectors)
        with self._lock:
            self._lib.vi_train(self._h(), _fptr(vectors), vectors.shape[0], iters, seed)

    def add(self, vectors: np.ndarray) -> int:
        """Append rows; returns the first assigned sequential id."""
        vectors = self._rows(vectors)
        with self._lock:
            first = self._lib.vi_add(self._h(), _fptr(vectors), vectors.shape[0])
        if first < 0:
            raise RuntimeError("index not trained (IVF requires train() before add())")
        return int(first)

    def search(
        self, queries: np.ndarray, k: int, nprobe: int = 8
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores [Q, k], ids [Q, k]); missing slots get id -1."""
        queries = np.ascontiguousarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        queries = self._rows(queries)
        k = max(int(k), 0)
        nq = queries.shape[0]
        scores = np.empty((nq, k), np.float32)
        ids = np.empty((nq, k), np.int64)
        with self._lock:
            self._lib.vi_search(self._h(), _fptr(queries), nq, k, nprobe, _fptr(scores),
                                _iptr(ids))
        return scores, ids

    def remove(self, ids) -> int:
        arr = np.ascontiguousarray(ids, np.int64).reshape(-1)
        with self._lock:
            return int(self._lib.vi_remove(self._h(), _iptr(arr), arr.shape[0]))

    def save(self, path: str) -> None:
        with self._lock:
            rc = self._lib.vi_save(self._h(), path.encode())
        if rc != 0:
            raise IOError(f"failed to save index to {path}")

    @classmethod
    def load(cls, path: str) -> "NativeIndex":
        lib = _load_lib()
        handle = lib.vi_load(path.encode())
        if not handle:
            raise IOError(f"failed to load index from {path}")
        idx = cls.__new__(cls)
        idx._lib = lib
        idx._handle = handle
        idx.dim = int(lib.vi_dim(handle))
        idx.metric = METRIC_IP
        idx.nlist = 0
        idx._lock = threading.Lock()
        return idx
