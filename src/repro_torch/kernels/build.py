"""Build and bind the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each `csrc/*.cu` file is compiled on first use, all sources in parallel
(one `nvcc` each), for `sm_90a` into `build/repro_torch/` at the root of
the checkout, under a name that carries a hash of the source, the
`csrc/*.cuh` headers it includes and the flags, so an edited source or
header never loads a stale library.  The C entry points take raw device
pointers and the CUDA stream as `c_void_p`, launch on that stream,
allocate nothing, and return `cudaGetLastError()`; `check` raises on a
non-zero code.  Nothing here runs at import time, and nothing falls
back: a missing `nvcc` or a failed build raises.

`LAUNCHES` counts one per kernel-wrapper call that launched its CUDA
kernel (the wrappers in grouped_matmul.py, paged_attn.py, normhead.py,
wkv6.py and rwkv_decay.py increment it); calls that took the plain PyTorch version on
CPU tensors do not count.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> (source stem, argtypes); every entry returns int.
SIGNATURES = {
    "fused_moe_ffn": ("fused_moe_ffn", [_P] * 11 + [_I] * 9 + [_P]),
    "paged_attn_scores_max": ("paged_attn", [_P] * 7 + [_I] * 8 + [_F, _P]),
    "paged_attn_accumulate": ("paged_attn", [_P] * 10 + [_I] * 8 + [_F, _P]),
    "grouped_matmul_aligned": ("grouped_matmul", [_P] * 4 + [_I] * 7 + [_P]),
    "grouped_matmul_wgrad": ("grouped_matmul", [_P] * 5 + [_I] * 7 + [_P]),
    "normhead_matmul": ("normhead", [_P] * 3 + [_I] * 5 + [_F, _P]),
    "wkv6": ("wkv6", [_P] * 8 + [_I] * 5 + [_P]),
    "rwkv_decay": ("rwkv_decay", [_P] * 6 + [_I] * 4 + [_P]),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                           "port's CUDA kernels cannot be built")
    return path


def _headers(src: Path):
    """The csrc/*.cuh files that `src` includes, directly or through
    another header, in include order."""
    seen, todo = [], [src]
    while todo:
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                               todo.pop().read_text(), re.M):
            dep = CSRC / name
            if dep.suffix == ".cuh" and dep.exists() and dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def _target(src: Path) -> Path:
    """The library's path: a hash of the source, the headers it includes
    and the flags, so an edited header never loads a stale library."""
    digest = hashlib.sha1()
    for part in [src] + _headers(src):
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:12]}.so"


@functools.cache
def build_all() -> Dict[str, Path]:
    """Compile every csrc/*.cu that has no up-to-date library, in
    parallel.  Returns {source stem: library path}; the ptxas report of
    each build lands beside its library as `<name>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Path] = {}
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = _target(src)
        out[src.stem] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{lib.name}:\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


@functools.cache
def library(stem: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_all()[stem]))
    for name, (src, argtypes) in SIGNATURES.items():
        if src == stem:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def entry(name: str):
    """The bound C entry point `name` (builds its source on first use)."""
    return getattr(library(SIGNATURES[name][0]), name)


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
