"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so ``nvcc`` takes seconds, not
minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/tpuflow_torch/lib<name>-<hash>.so \
         tpuflow_torch/csrc/<name>.cu

The output lands in ``build/tpuflow_torch/`` at the repository root
(git-ignored), named by the source's content hash so an edited kernel is
never served from a stale library. Fast math stays off: the int8 kernel
is bit-exact only under IEEE division and rounding.

Nothing here runs at import time; the CPU tests import every module and
this machine may have no ``nvcc``. ``python <path>/_build.py`` builds
every library and prints the seconds it took: the step a replacement
replica runs before it takes traffic (``infer/router.py::launch_command``);
the module imports nothing of the package, so it runs by path from any
working directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
    "build", "tpuflow_torch",
)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
# Each library's C entry points and their argtypes (pointers and the stream
# as c_void_p: a plain int would be cut to 32 bits). Every launch entry
# returns cudaGetLastError() as an int; a ``_smem`` entry returns bytes.
KERNELS = {
    "flash_fwd": {
        # q, k, v, o, lse; B, H, Tq, Tk, D, dtype, causal, bq; the scale;
        # the nine strides; the stream.
        "tpuflow_flash_fwd": [_P] * 5 + [_I] * 8 + [_F] + [_L] * 9 + [_P],
        # dtype, D, bq -> the block's dynamic shared memory bytes.
        "tpuflow_flash_fwd_smem": [_I] * 3,
    },
    "flash_bwd": {
        # Tensors, then B, H, Tq, Tk, D, dtype, causal, rows (the plan's),
        # the scale, a pointer to the int64 strides, the stream.
        "tpuflow_flash_bwd_dq": [_P] * 8 + [_I] * 8 + [_F, _P, _P],
        "tpuflow_flash_bwd_dkv": [_P] * 8 + [_I] * 8 + [_F, _P, _P],
        "tpuflow_flash_bwd_dq_split": [_P] * 7 + [_I] * 8 + [_F, _P, _P],
        "tpuflow_flash_bwd_dkv_split": [_P] * 8 + [_I] * 8 + [_F, _P, _P],
        # kernel (0 dq, 1 dk/dv), split, dtype, D, rows -> the block's
        # dynamic shared memory bytes.
        "tpuflow_flash_bwd_smem": [_I] * 5,
    },
    "int8_matmul": {
        # x, w, ws, s, out, scratch, counters; M, K, N, w_contract_last,
        # ws_stride, tile, splits, cps, stages; the stream.
        "tpuflow_int8_matmul": [_P] * 7 + [_I] * 9 + [_P],
        # tile, M, cps, stages -> the block's dynamic shared memory bytes.
        "tpuflow_int8_smem": [_I] * 4,
    },
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# The seconds this process spent in nvcc for each library it built (the
# device observatory's ``kernel.<name>`` program entries).
BUILT: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")


def library_path(name: str) -> str:
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str):
    """Start ``nvcc`` for one kernel; None when its library is built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [
        _nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu"),
    ]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, time.monotonic()


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees a half-written .so
    BUILT[name] = time.monotonic() - t0


def build_all(names=tuple(KERNELS)) -> float:
    """Compile every kernel not built yet, one ``nvcc`` per source, all
    started together. Returns the wall seconds spent."""
    t0 = time.monotonic()
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        _finish(n, s)
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use, with its entry
    points' argtypes set."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(library_path(name))
        lib.tpuflow_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpuflow_cuda_error_string.restype = ctypes.c_char_p
        for entry, argtypes in KERNELS[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch:
    a refused launch never runs, and a later synchronize does not say so."""
    if rc != 0:
        msg = lib.tpuflow_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def int64_array(values) -> ctypes.Array:
    """A C array of int64 (strides for an entry point that takes a
    pointer); the caller keeps it alive across the call."""
    return (ctypes.c_longlong * len(values))(*values)


if __name__ == "__main__":
    print(f"[build] kernels built in {build_all():.1f} s", flush=True)
