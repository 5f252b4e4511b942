"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers, so a
build takes seconds). It is compiled at first use for `sm_90a` into
`_build/lib<name>-<hash>.so`, keyed by a hash of the sources and flags, so a
fresh checkout builds everything on its first call and a changed source
rebuilds. `build(names)` starts one nvcc per source, all at once.

`-fmad=false` keeps every multiply and add separately rounded, as PyTorch's
eager elementwise ops are, so a kernel and its plain version compute the
same float32 values and the masks at the alpha floor agree.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


# wall seconds this process has spent compiling kernels (what a run reports
# as its compile time)
build_seconds = 0.0


class BuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (looked in $CUDA_HOME/bin and on PATH)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, dict]:
    """Compile every named kernel that is not built yet, one nvcc each, all in
    parallel. Returns {name: {"seconds": wall time, "log": ptxas report}}
    for the ones compiled here; raises BuildError if any compile fails."""
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    global build_seconds
    build_seconds += time.perf_counter() - t0
    if failed:
        raise BuildError("nvcc failed:\n" + "\n".join(failed))
    return report


# the live viewer renders from a second host thread while training launches
# from the first: a first use builds once, and no launch goes uncounted
_build_lock = threading.Lock()
_count_lock = threading.Lock()


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    build([name])
    return ctypes.CDLL(str(_lib_path(name)))


def load(name: str) -> ctypes.CDLL:
    """The compiled library for csrc/<name>.cu, built on first use."""
    with _build_lock:
        return _load(name)


def count_launch(wrapper) -> None:
    """`wrapper.launches += 1`, from any host thread."""
    with _count_lock:
        wrapper.launches += 1


def entry(lib_name: str, fn_name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function `fn_name` of csrc/<lib_name>.cu with its argument types
    declared (pointers and the stream as c_void_p); it returns a cudaError_t."""
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
