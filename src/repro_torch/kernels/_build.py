"""Build the port's CUDA sources with ``nvcc`` into shared libraries.

Each ``.cu`` file becomes one ``.so`` with a plain C interface (loaded with
``ctypes``), compiled for Hopper (``sm_90a``) into ``build/repro_torch_kernels/``
at the repository root. A library's file name carries a hash of its source,
the headers beside it and the flags, so an edit rebuilds and an unchanged
source is reused. Several sources compile in parallel, one ``nvcc`` each.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[Path]) -> Dict[Path, dict]:
    """Compile every source whose library is missing, all at once.

    Returns, per source, ``{"path", "seconds", "log"}``; ``log`` holds what
    ``-Xptxas -v`` printed (registers, shared memory, spills). Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[Path, dict] = {}
    running = []
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            out[src] = {"path": lib, "seconds": 0.0, "log": "(cached)"}
            continue
        tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc, time.perf_counter()))
    failures = []
    for src, lib, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
        out[src] = {"path": lib, "seconds": secs, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return out
