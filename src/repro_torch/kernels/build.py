"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source is compiled on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
``build/kernels/`` at the repository root.  The library's file name carries a
hash of every file in the source's ``csrc/`` directory (the ``.cu`` and the
headers it includes) and of the compiler flags, so an edited source, header
or flag is rebuilt and an unchanged one is reused.  Nothing is built when a
module is imported: a kernel's wrapper asks for its library on its first
launch, and ``compile_all`` builds every source at once, one ``nvcc``
process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent
REPO_ROOT = _PKG.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Every kernel source of the port, by library name.
SOURCES: Dict[str, Path] = {
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "rmsnorm": _PKG / "rmsnorm" / "csrc" / "rmsnorm.cu",
    "norm_shift_mix": _PKG / "norm_shift_mix" / "csrc" / "norm_shift_mix.cu",
    "wkv6": _PKG / "rwkv6" / "csrc" / "wkv6.cu",
    "wkv6_bwd": _PKG / "rwkv6" / "csrc" / "wkv6_bwd.cu",
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    csrc = SOURCES[name].parent
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(str(f.relative_to(csrc)).encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def compile_all(names: List[str] = None) -> Dict[str, str]:
    """Build the named libraries (default: all), one ``nvcc`` per source,
    all running at once.  Returns each name's compiler output, with ptxas's
    register and spill report ("" when the library was already built).
    Raises if any build fails."""
    names = list(SOURCES) if names is None else names
    with _lock:
        jobs = {n: _start(n) for n in names}
        logs, failed = {}, []
        for n, job in jobs.items():
            if job is None:
                logs[n] = ""
                continue
            proc, tmp, out = job
            text, _ = proc.communicate()
            logs[n] = text
            if proc.returncode != 0:
                failed.append(f"{n}:\n{text}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    compile_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
