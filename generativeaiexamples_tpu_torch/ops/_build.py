"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``), at first use, into ``build/torch_kernels/``
at the repository root. The file name carries a hash of the source and the
flags, so an edited kernel rebuilds and an unchanged one loads as it is.
Pointers and the CUDA stream cross as ``ctypes.c_void_p``; every C entry
point returns ``cudaGetLastError()`` and :func:`check` raises on a
non-zero code.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Sequence

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = (
    "int8_matmul", "int8_w8a8_matmul", "page_attention", "flash_attention", "decode_attention",
)
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}  # guarded by _LOCK
_TICKETS: Dict[tuple, object] = {}  # written under _LOCK


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS, verbose: bool = False) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all nvcc
    processes started together. Returns name -> compiler output (the
    ``-Xptxas -v`` register/shared-memory report when ``verbose``; empty
    for a library that was already built). Raises with the compiler's
    messages when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports = {name: "" for name in names}
    failures: List[str] = []
    for name, (proc, tmp, out) in jobs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The built library for ``name`` (compiled on first use), with
    ``argtypes`` set from ``signatures`` and ``restype`` c_int for each
    entry point."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(tensor) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on the tensor's device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


def tickets(kernel: str, tensor, count: int):
    """The int32 ticket buffer of a kernel whose last block to finish merges
    the others' partial results (``decode_attention``, ``int8_matmul``,
    ``int8_w8a8_matmul``), for
    the tensor's device and PyTorch's current stream there. Zeroed once,
    here; the merging block sets its ticket back to zero, so every launch
    finds zeros and launches on one stream, which run one after another, can
    share the buffer."""
    import torch

    stream = torch.cuda.current_stream(tensor.device).cuda_stream
    key = (kernel, tensor.device, stream, count)
    buf = _TICKETS.get(key)  # the hot path of a decode step: no lock on a hit
    if buf is None:
        with _LOCK:
            buf = _TICKETS.get(key)
            if buf is None:
                buf = _TICKETS[key] = torch.zeros(count, dtype=torch.int32, device=tensor.device)
    return buf
