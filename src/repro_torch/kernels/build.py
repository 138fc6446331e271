"""Build the CUDA kernels of `kernels/csrc/` and load them with ctypes.

Each `csrc/*.cu` is compiled on first use, by `nvcc` into its own shared
library with a plain C interface, under `build/repro_torch_kernels/` at the
repository root (git-ignored). The file name carries a hash of the source,
of every shared header `csrc/*.cuh` and of the flags, so an edited kernel
or header rebuilds every kernel it may reach, and an unchanged one loads
from the previous build. All sources compile in parallel, one `nvcc` each.

Each build runs with `-Xptxas -v` and prints the compiler's output as it
is: per kernel (by its mangled name), the assembler's register,
shared-memory, stack and spill lines.

Importing this module builds nothing and needs no `nvcc`: the CPU tests
import every module of the package on machines without a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def check_operand(name: str, x, dtype, shape, device) -> None:
    """Validate a tensor before its pointer crosses into a kernel: device,
    dtype, shape and contiguity, raising on anything the kernel does not
    take."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(name: str, x, n_bytes: int) -> None:
    """Raise unless `x`'s data starts on an `n_bytes` boundary (a kernel
    reads it in vectors of that width)."""
    if x.data_ptr() % n_bytes:
        raise ValueError(f"{name} must start on a {n_bytes}-byte boundary")


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else under CUDA_HOME or
    /usr/local/cuda. Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin): the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    """The library built from `src`: its name hashes the source, every
    `csrc/*.cuh` header (a source may include any of them) and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every `csrc/*.cu` whose library is missing, all in parallel.

    Returns {source stem: build seconds} for the sources it compiled (an
    empty dict when everything was built already). Raises RuntimeError
    with the compiler output if any source fails."""
    todo = [s for s in sorted(CSRC.glob("*.cu")) if not _target(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in todo:
        out = _target(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    seconds, failures = {}, []
    for src, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds[src.stem] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src.name} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        if log.strip():
            print(f"[nvcc {src.name}]\n{log.rstrip()}")
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<stem>.cu` (builds on first use)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            src = CSRC / f"{stem}.cu"
            if not src.exists():
                raise FileNotFoundError(src)
            build_all()
            lib = ctypes.CDLL(str(_target(src)))
            _libs[stem] = lib
        return lib
