"""Build and load the port's CUDA kernels.

`euler_tpu_torch/csrc/<name>.cu` is compiled by nvcc into a shared
library with a plain C interface, which is then loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/euler_tpu_torch/<name>-<hash>.so <name>.cu

The build happens at first use (or through `build(name)`), into
`build/euler_tpu_torch/` at the root of the checkout. The file name
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.

nvcc is taken from $CUDA_HOME/bin, else /usr/local/cuda/bin, else PATH.
A missing nvcc or a failed compile raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "euler_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> dict:
    """Compile kernel `name` unless its library exists. Returns
    {"seconds": wall seconds (0.0 if already built), "log": nvcc's
    output (the ptxas register/spill report), kept beside the library
    so a later call reads it too}."""
    out = library_path(name)
    log = out.with_suffix(".log")
    if out.is_file():
        return {"seconds": 0.0,
                "log": log.read_text() if log.is_file() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.monotonic()
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    tmp_log.write_text(proc.stdout)
    os.replace(tmp_log, log)
    os.replace(tmp, out)  # atomic: a reader never sees a partial file
    return {"seconds": time.monotonic() - t0, "log": proc.stdout}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
