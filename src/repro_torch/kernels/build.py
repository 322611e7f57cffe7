"""Build and load the port's CUDA C++ kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``, all
started together, and the objects are linked into ONE shared library with
a plain C interface, at first use, under ``build/`` at the root of the
checkout; the library's name carries a hash of the sources and flags, so a
stale build is never loaded.  It is bound with ``ctypes``:
every pointer and the stream are ``c_void_p``, every size ``c_int``, and
every entry returns ``cudaGetLastError()``, which :func:`launch` turns into
an exception.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: C entry -> (number of pointer args, number of int args); the stream is
#: the last argument of every entry
ENTRIES = {
    "stencil_spmv_f32": (4, 3),
    "rb_dilu_forward_f32": (5, 3),
    "rb_dilu_backward_f32": (5, 3),
    "rwkv6_scan_f32": (8, 4),
    "rwkv6_scan_bf16": (8, 4),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: compiler output of the build this process made (``-Xptxas -v`` lines)
build_log = ""


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                           "CUDA kernels are built on a machine with the CUDA "
                           "toolkit")
    return path


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:12]}.so"


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` per source in parallel, then one link."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [pathlib.Path(tmpdir) / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [f"{src.name} ({p.returncode})" for src, p in
                  zip(sources(), procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{build_log}")
        tmp = pathlib.Path(tmpdir) / out.name
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, out)        # atomic: a concurrent build never sees
    return out                      # a half-written library


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (n_ptr, n_int) in ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] * n_ptr
                               + [ctypes.c_int] * n_int + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(entry: str, tensors: Sequence[torch.Tensor],
           ints: Sequence[int]) -> None:
    """Call one C entry on the current stream of the tensors' device; raise
    if the launch was refused."""
    lib = library()
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(*(t.data_ptr() for t in tensors),
                                  *ints, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA launch failed ({err}: {msg})")
