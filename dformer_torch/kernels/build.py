"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each source under `csrc/` compiles on first use into a shared library with a
plain C interface, under `kernels/build/` (listed in `.gitignore`), named by
a hash of the source so an edited source is rebuilt. Targets `sm_90a`
(Hopper). Nothing is compiled at import time: the CPU tests import every
module of the port, and the CPU host has no nvcc.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

_libs = {}
build_seconds = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built on the machine with the card")
    return found


def _compile(source: Path, target: Path, defines=()) -> None:
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           *(f"-D{d}" for d in defines), "-o", str(target), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    # ptxas -v: registers, shared memory and spills of every instantiation
    target.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {source}:\n"
                           f"{proc.stderr[-4000:]}")


def library(name: str, defines=()) -> ctypes.CDLL:
    """Load `csrc/<name>.cu` as a shared library, compiling it first if no
    build of this exact source and these preprocessor `defines` exists.
    Raises if the build fails."""
    key = (name, *defines)
    if key in _libs:
        return _libs[key]
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(defines).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"lib{name}_{digest}.so"
    if not target.exists():
        t0 = time.perf_counter()
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        _compile(source, tmp, defines)
        os.replace(tmp, target)
        os.replace(tmp.with_suffix(".log"), target.with_suffix(".log"))
        build_seconds[" ".join(key)] = time.perf_counter() - t0
    _libs[key] = ctypes.CDLL(str(target))
    return _libs[key]


def build_all() -> dict:
    """Compile (if needed) and load every source under csrc/, one nvcc per
    source, all started together. Returns {name: seconds spent compiling,
    0.0 if already built}; raises if a build fails."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(library, names))
    return {n: build_seconds.get(n, 0.0) for n in names}
