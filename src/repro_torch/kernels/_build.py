"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``kernels/csrc/<name>.cu`` has a plain C interface.  ``nvcc``
compiles it for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the root of the checkout the package runs from
(git-ignored), or, for an installed package, under
``<tempdir>/repro_torch-build-<uid>/`` (``tempfile.gettempdir()``, so
``$TMPDIR``), made readable by its owner only.  A library is named by a hash of the source and the flags,
so an edited source is never served from a stale library.  Several
sources build in parallel: one ``nvcc`` each, all started together.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
#: per source: {"seconds": build time (0.0 when reused), "ptxas": the
#: ``-Xptxas -v`` report (registers, shared memory, spills), "path": …}
build_log: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels are "
                           "built from source at first use")
    return path


def build_dir() -> Path:
    """``build/repro_torch`` of the checkout when the package runs from
    its ``src/``, else a directory under the temporary directory — never
    a path beside an installed package."""
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").is_file() and (root / "src" /
                                                "repro_torch").is_dir():
        return root / "build" / "repro_torch"
    return Path(tempfile.gettempdir()) / f"repro_torch-build-{os.getuid()}"


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile every named source whose library is missing, all in
    parallel; raise with nvcc's output if any fails."""
    jobs = []
    for name in names:
        target = _target(name)
        if target.exists():
            log = target.with_suffix(".log")
            build_log.setdefault(name, {
                "seconds": 0.0, "path": str(target),
                "ptxas": log.read_text() if log.exists() else ""})
            continue
        target.parent.mkdir(mode=0o700, parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, tmp, proc, time.perf_counter()))
    failed = []
    for name, target, tmp, proc, t0 in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}.cu:\n{out}")
            continue
        target.with_suffix(".log").write_text(out)
        os.replace(tmp, target)           # atomic: readers never see half
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": out, "path": str(target)}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(build_log[name]["path"])
    return lib
