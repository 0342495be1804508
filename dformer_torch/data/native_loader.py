"""ctypes binding of the port's native C++ decode pool
(`dformer_torch/native/loader.cpp`; counterpart of
`dformer_tpu/data/native_loader.py`).

The library is built at first use with g++ (libjpeg and libpng headers
needed) into `native/build/libdfloader_<source hash>.so`, a directory
`.gitignore` lists, so an edited source is rebuilt. A build or load that
fails raises, with the compiler's message: nothing falls back to the
Python `Loader` behind the caller's back.

    nl = NativeLoader(num_threads=4)
    batch = np.empty((B, H, W, 3), np.uint8)
    ticket = nl.submit(paths, batch, want_color=True)   # async decode
    nl.wait(ticket)                                     # batch is filled
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCE = NATIVE_DIR / "loader.cpp"
BUILD_DIR = NATIVE_DIR / "build"
CXX = "g++"
CXXFLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the build of the current source goes."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdfloader_{digest}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cmd = [CXX, *CXXFLAGS, str(SOURCE), "-o", str(tmp), "-ljpeg", "-lpng"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"native loader: cannot run {CXX}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native loader: {' '.join(cmd)} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, target)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if this source has no build yet.
    Raises if the build or the load fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        lib.dfl_create.restype = ctypes.c_void_p
        lib.dfl_create.argtypes = [ctypes.c_int]
        lib.dfl_destroy.argtypes = [ctypes.c_void_p]
        lib.dfl_decode_image.restype = ctypes.c_int
        lib.dfl_decode_image.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.dfl_submit_batch.restype = ctypes.c_long
        lib.dfl_submit_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.dfl_wait_batch.restype = ctypes.c_int
        lib.dfl_wait_batch.argtypes = [ctypes.c_void_p, ctypes.c_long]
        _lib = lib
        return _lib


class NativeLoader:
    """A pool of `num_threads` C++ decode threads."""

    def __init__(self, num_threads: int = 4):
        self._lib = get_lib()
        self._h = self._lib.dfl_create(num_threads)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dfl_destroy(self._h)
            self._h = None

    def decode(self, path: str, want_color: bool = True) -> np.ndarray:
        """One image at its own size: [H, W, 3] BGR or [H, W, 1] gray."""
        cap = 8192 * 8192 * 3
        buf = np.empty((cap,), np.uint8)
        h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = self._lib.dfl_decode_image(
            path.encode(), int(want_color),
            buf.ctypes.data_as(ctypes.c_void_p), cap,
            ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
        if rc != 0:
            raise IOError(f"decode failed rc={rc}: {path}")
        return buf[:h.value * w.value * c.value].reshape(
            h.value, w.value, c.value).copy()

    def submit(self, paths: Sequence[str], out: np.ndarray,
               want_color: bool = True) -> int:
        """Start decoding len(paths) images of out's item size into out[i];
        returns the ticket to `wait` on."""
        if out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
            raise ValueError("out must be a C-contiguous uint8 array")
        n = len(paths)
        B, H, W = out.shape[:3]
        C = out.shape[3] if out.ndim == 4 else 1
        if n > B:
            raise ValueError(f"{n} paths for {B} slots")
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        return self._lib.dfl_submit_batch(
            self._h, arr, n, int(want_color), H, W, C,
            out.ctypes.data_as(ctypes.c_void_p))

    def wait(self, ticket: int) -> None:
        """Block until the batch of `ticket` is decoded; raises on a file
        that failed or had another size."""
        rc = self._lib.dfl_wait_batch(self._h, ticket)
        if rc != 0:
            raise IOError(f"batch decode failed rc={rc}")
