"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``<build dir>/lib<name>_<hash>.so``, compiled by ``nvcc`` for
Hopper (``sm_90a``). ``<hash>`` covers the source, every ``csrc/*.cuh``
header and the flags, so an edited source rebuilds and an unchanged one
loads what is there. ``build_all`` starts one ``nvcc`` per source, all
together, and waits for them. ``nvcc`` prints each kernel's registers,
shared memory and spills (``-Xptxas -v``) into ``lib<name>_<hash>.log``
beside the library.

The build directory is ``build/repro_torch/`` at the root of the checkout,
or ``$REPRO_TORCH_BUILD_DIR``. A missing ``nvcc`` or a failed build raises:
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
_REPO_ROOT = Path(__file__).resolve().parents[3]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else _REPO_ROOT / "build" / "repro_torch"


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}_{_digest(name)}.so"


def log_path(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def build_all(names: List[str] | None = None) -> Dict[str, Path]:
    """Build every named kernel (default: all) that is not built yet, one
    ``nvcc`` process per source, started together. Returns name -> path."""
    names = sources() if names is None else list(names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = open(log_path(name), "w")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          f"{log_path(name).read_text()}")
            continue
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib


def ptxas_report(name: str) -> List[str]:
    """The register / shared-memory / spill lines of the kernel's build."""
    path = log_path(name)
    if not path.exists():
        return []
    return [ln.strip() for ln in path.read_text().splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]
