"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source compiles with its own ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``; the compilers of
all sources start together, so the build takes as long as the slowest
source. Each library lands in ``build/kernels/`` at the root of the
checkout, named by the source and a hash of it, the shared headers and the
flags, so an edited source rebuilds and an unchanged one is reused. Nothing
is fetched or prebuilt: the first kernel launch builds.

``--fmad=false`` keeps every device multiply from fusing into an add on
the score path (the exactness contract, docs/DESIGN.md).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

from diagon_tpu_torch.observability.metrics import registry

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# launcher name -> argtypes (pointers and the stream as c_void_p)
_SIGNATURES = {
    "diagon_row_sum": [_P, _P, _P, _P, _P, _I, _I, _I64, _I, _P],
    "diagon_row_boolean": [_P, _P, _P, _P, _P, _P, _I, _I, _I64, _I, _P],
    "diagon_approx_select": [_P] * 6 + [_I, _I, _I64, _P],
    "diagon_approx_select_bool": [_P] * 10 + [_I, _I, _I64, _P],
    "diagon_approx_select_bool2": [_P] * 8 + [_I, _I, _I64, _P],
    "diagon_gather_rescore": [_P] * 5 + [_I] * 5 + [_P],
    "diagon_union_rescore": [_P] * 5 + [_I] * 7 + [_P],
    "diagon_bits_hits": [_P] * 5 + [_I, _I64] + [_I] * 6 + [_P],
    "diagon_range_agg": [_P, _P],  # a pointer to X1Args, the stream
    "diagon_range_agg_grid": [_I, _I, _I64, _P],
    "diagon_block_score": [_P, _I64] + [_P] * 18 + [_I] * 7 + [_P],
    "diagon_bank_decode": [_P, _P, _I, _I] + [_P] * 7
    + [_I64, _P, _P, _I, _I64, _I, _P],
}

_lib = None
_NVCC_SECONDS = registry.gauge(
    "ops.nvcc_seconds",
    "wall time of the kernel build this process ran (0.0: none ran)")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
        "cannot be built"
    )


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path(src: Path) -> Path:
    """The shared library built from one source."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def library_paths():
    return [library_path(s) for s in _sources()]


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills) from the
    builds of the current sources that are on disk."""
    logs = [p.with_suffix(".log") for p in library_paths()]
    return "".join(p.read_text() for p in logs if p.exists())


def _build_missing():
    """Start one nvcc per source whose library is missing, all at once,
    and wait for every one; raise with the output of any that failed."""
    todo = [(s, library_path(s)) for s in _sources()
            if not library_path(s).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src, so in todo:
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((so, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for so, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    _NVCC_SECONDS.set(time.perf_counter() - t0)


def library() -> SimpleNamespace:
    """Every launcher of ``_SIGNATURES`` as an attribute, built on first
    use."""
    global _lib
    if _lib is not None:
        return _lib
    _build_missing()
    fns = {}
    libs = [ctypes.CDLL(str(so)) for so in library_paths()]
    for lib in libs:
        for name, argtypes in _SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
    missing = sorted(set(_SIGNATURES) - set(fns))
    if missing:
        raise RuntimeError(f"kernel libraries lack launchers {missing}")
    _lib = SimpleNamespace(**fns, libraries=libs)
    return _lib
