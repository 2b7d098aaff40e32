"""Build and load the hand-written CUDA kernels of csrc/.

Each `csrc/<name>.cu` exposes a plain C interface (pointers and the stream as `void*`,
sizes as `int`, each function returning `cudaGetLastError()` after its launches). It is
compiled by `nvcc` for `sm_90a` into `_build/<name>-<hash>.so` at first use, where the
hash covers the source, the shared headers `csrc/*.cuh` and the flags, and loaded with
ctypes. Nothing is built when the
package is imported; a build that fails raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_resident: dict[tuple, int] = {}
_buffers: dict[tuple, object] = {}
_retired: list = []  # outgrown buffers, kept for the CUDA graphs captured on them


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else `nvcc` on PATH, else the toolkit's
    default install prefix."""
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the CUDA kernels are built from csrc/ at first use)")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    """Where the built library of one source lives: the name plus a hash of the source,
    every shared header `csrc/*.cuh` (a source may include any of them) and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, f) for f in headers]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def start_build(name: str):
    """Start `nvcc` for one kernel source unless its library is already built; returns
    the job for finish_build, or None. Compiler output goes to `_build/<name>.log`
    (ptxas reports registers and spills there)."""
    lib = library_path(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    log_path = os.path.join(BUILD_DIR, f"{name}.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(name)],
                                stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, lib, log_path


def finish_build(job) -> None:
    """Wait for a job of start_build and install its library; raise on failure."""
    if job is None:
        return
    proc, tmp, lib, log_path = job
    rc = proc.wait()
    if rc != 0:
        with open(log_path) as f:
            raise RuntimeError(f"nvcc failed ({rc}) building {lib}:\n{f.read()}")
    os.replace(tmp, lib)


def build(names: list[str]) -> None:
    """Build every named kernel, one nvcc process per source, all started together."""
    jobs = [start_build(n) for n in names]
    for job in jobs:
        finish_build(job)


P = ctypes.c_void_p  # pointer or stream argument
I = ctypes.c_int
F = ctypes.c_float


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed. `signatures`
    maps each C function to its argument types; every function returns an int (the
    CUDA error code of its launches)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            finish_build(start_build(name))
            lib = ctypes.CDLL(library_path(name))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = I
            _loaded[name] = lib
        return lib


@functools.cache
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of one card (sizes the kernels' grids)."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def resident_blocks(lib, fn: str, args: tuple, device_index: int) -> int:
    """Blocks of one kernel build the card holds at once: the kernel's own occupancy
    query `fn(*args)` (blocks per SM) times the SM count, asked once per build and
    device."""
    key = (fn, args, device_index)
    n = _resident.get(key)
    if n is None:
        per_sm = getattr(lib, fn)(*args)
        if per_sm < 1:
            raise RuntimeError(f"{fn}{args}: no block of the kernel fits on an SM")
        n = _resident[key] = per_sm * sm_count(device_index)
    return n


def device_buffer(name: str, device, n: int, dtype, minimum: int):
    """At least `n` zeroed elements of `dtype` on `device`, the same buffer under `name`
    from call to call (so a captured CUDA graph keeps its address); a buffer outgrown
    stays allocated. The kernels that use one leave it as they found it."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    buf = _buffers.get((name, idx))
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(n, minimum), dtype=dtype, device=device)
        _buffers[(name, idx)] = buf
    return buf


def stream_of(t) -> int:
    """PyTorch's current stream on the tensor's device, as a raw pointer value."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
