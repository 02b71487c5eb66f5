"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so``
under the repository root (``build/`` is git-ignored), then loaded with
``ctypes``.  The hash covers the source, every ``csrc/*.cuh`` header and
the compiler flags, so an edited source rebuilds and an unchanged one is
loaded as it is.  Nothing is built at import: the first launch builds
(``build_all`` builds every kernel at once, one ``nvcc`` per source, all
started together).

Every wrapper counts its launches here (:func:`count_launch`), once per
call that launched its kernel; the plain PyTorch versions never count.
A CUDA graph capture calls the wrappers but launches nothing, and a
replay launches without a wrapper call: inside :func:`recording_launches`
the calls go to the capture's own record, and each replay adds that
record to the counts (:func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = ("lut_dequant_matmul", "flash_prefill", "decode_gqa",
                  "lama_bulk_op", "exp_histogram")
# --split-compile=0 runs the device code's optimisation on every core:
# the LUT GEMM source, the longest build, took 68 s with it and 225 s
# without on an H100 host of 8 cores (CUDA 12.9), every kernel with the
# same registers
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_LIBS: dict[str, ctypes.CDLL] = {}
_LAUNCHES: dict[str, int] = {}
_RECORD: dict[str, int] | None = None   # the capture being recorded
BUILD_SECONDS: dict[str, float] = {}   # source -> nvcc wall seconds


# ------------------------------------------------------------ counters --

def count_launch(name: str) -> None:
    counts = _LAUNCHES if _RECORD is None else _RECORD
    counts[name] = counts.get(name, 0) + 1


@contextlib.contextmanager
def recording_launches():
    """Count the wrapper calls made inside the block into a record of
    their own (yielded), not into the launch counts: what a CUDA graph
    captured, which each replay then adds with :func:`add_launches`."""
    global _RECORD
    prev, _RECORD = _RECORD, {}
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def add_launches(record: dict[str, int]) -> None:
    """Add a capture's record to the launch counts: one replay."""
    for name, n in record.items():
        _LAUNCHES[name] = _LAUNCHES.get(name, 0) + n


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


# --------------------------------------------------------------- build --

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is already built.
    Returns (name, final path, temp path, log file, process, start time)
    or None."""
    path = _lib_path(name)
    if path.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    # nvcc's output goes to a file, not a pipe, so that every build runs
    # to its end while the others are polled
    log = tempfile.TemporaryFile(mode="w+", dir=BUILD_DIR)
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            text=True)
    return name, path, tmp, log, proc, time.perf_counter()


def _finish(job) -> str:
    name, path, tmp, log, proc, _ = job
    proc.wait()
    log.seek(0)
    out = log.read()
    log.close()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, path)
    return out


def build_all(names=KERNEL_SOURCES) -> dict[str, str]:
    """Build every kernel library in parallel; returns nvcc's output
    (register and shared-memory use from ``-Xptxas -v``) per source, and
    records each build's wall seconds in ``BUILD_SECONDS``.  Raises if
    any build fails."""
    jobs = [j for j in (_start(n) for n in names) if j is not None]
    running = list(jobs)
    while running:
        for job in [j for j in running if j[4].poll() is not None]:
            BUILD_SECONDS[job[0]] = time.perf_counter() - job[5]
            running.remove(job)
        if running:
            time.sleep(0.05)
    logs, err = {}, None
    for job in jobs:
        try:
            logs[job[0]] = _finish(job)
        except RuntimeError as e:   # finish the others, then raise
            err = err or e
    if err is not None:
        raise err
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, for a launch."""
    return torch.cuda.current_stream(t.device).cuda_stream
