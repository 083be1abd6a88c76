"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``.cu`` source under ``csrc/`` compiles with ``nvcc`` into its own
shared library with a plain C interface, for ``sm_90a`` and without fast
math (the kernels rely on IEEE division and rounding).  All sources compile
together, one ``nvcc`` process each.  Libraries land in ``_build/`` beside
this file, named by a hash of their source, the ``.cuh`` headers and the
flags, so an edit rebuilds and an unchanged source is not compiled twice.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = {"fused_mlp_q8": "fused_mlp_q8.cu", "gemm_int8": "gemm_int8.cu",
           "flash_attention": "flash_attention.cu",
           "linear_scan": "linear_scan.cu", "rwkv6_scan": "rwkv6_scan.cu",
           "tiled_gemm": "tiled_gemm.cu", "fused_dense": "fused_dense.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "rwkv6_scan_bwd": "rwkv6_scan_bwd.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
ptxas_report: dict[str, str] = {}      # nvcc's -Xptxas -v output per source


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> pathlib.Path:
    # Every header counts for every source: an edit to one rebuilds all.
    src = b"".join(p.read_bytes() for p in [CSRC / SOURCES[name]]
                   + sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every source whose library is missing, all at once; return
    the library path of each kernel.  Raises with nvcc's output on failure."""
    targets = {name: _target(name) for name in SOURCES}
    missing = {n: t for n, t in targets.items() if not t.exists()}
    if not missing:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, target in missing.items():
        tmp = target.with_name(f"{target.name}.tmp.{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        ptxas_report[name] = output
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on {SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{output}")
        else:
            os.replace(tmp, targets[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building every kernel first."""
    if name not in _loaded:
        for n, path in build_all().items():
            _loaded.setdefault(n, ctypes.CDLL(str(path)))
    return _loaded[name]
