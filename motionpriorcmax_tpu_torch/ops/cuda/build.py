"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in `motionpriorcmax_tpu_torch/csrc/` has a plain C interface and
is compiled on first use into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

The library goes into `motionpriorcmax_tpu_torch/_build/` (listed in
.gitignore), named by a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  nvcc's output, with its
`-Xptxas -v` register and shared-memory report, is kept beside the library.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, else PATH, else the toolkit's default
    install prefix; raises with a clear message when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates: List[str] = []
    if home:
        candidates.append(str(Path(home) / "bin" / "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if Path(c).is_file() and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit or put nvcc on "
        "PATH (the port's kernels are compiled from csrc/ on first use)")


def build_library(name: str) -> Tuple[Path, str]:
    """Compile csrc/<name>.cu (if not built yet) -> (library path, nvcc log)."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"CUDA source missing: {src}")
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log = lib.with_suffix(".log")
    if lib.is_file():
        return lib, log.read_text() if log.is_file() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # Build under a temporary name and rename: a concurrent builder of the
    # same source never sees a half-written library.
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}-", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n"
                           f"{' '.join(cmd)}\n{output}")
    log.write_text(output)
    os.replace(tmp, lib)
    return lib, output


def load_library(name: str) -> ctypes.CDLL:
    """Build (once) and dlopen csrc/<name>.cu's library."""
    if name not in _LOADED:
        path, _ = build_library(name)
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]
