"""ctypes bindings for the port's native data library
(`eventgrad_tpu_torch/native/dataio.cpp`).

Port of `eventgrad_tpu/data/native.py`. The library is the port's own
copy of the JAX package's `native/dataio.cpp`: the MNIST idx and CIFAR-10
binary readers, libjpeg decode with a bilinear resize and the JPEG
encoder, the shard plan and the float32 / int32 batch gathers. It is a
host library, not a kernel.

It is built on first use with g++ (the JAX package's `native/Makefile`
flags, plus `-ljpeg -DEG_HAVE_LIBJPEG` where `<jpeglib.h>`
preprocesses) into `build/eventgrad_tpu_torch/<hash>/libeg_dataio.so`
beside the package (or under `$EG_TORCH_BUILD_DIR`), keyed by a hash of
the source and the flags, as `ops/build.py` keys the kernels; never into
the JAX package's `native/`. The build runs once a process, under a lock
(the first JPEG decode may come from a thread pool), and lands by an
atomic rename, so processes building at once do not meet a half-written
library. Nothing here runs at import time.

The contract is the JAX module's: `available()`, `jpeg_supported()`;
`load_cifar10_bin` and `load_mnist_idx` return None where the library is
missing, so `datasets.py`'s numpy readers serve; `load_jpeg_image` and
`save_jpeg` raise without libjpeg; `shard_plan` and `gather_batches`
fall back to numpy. `gather_rows`, the gather under `gather_batches`,
keeps each array's dtype (the prefetcher's form). Why a build failed is
kept in `build_error()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from eventgrad_tpu_torch.ops.build import build_root

SOURCE = Path(__file__).resolve().parent.parent / "native" / "dataio.cpp"
LIB_NAME = "libeg_dataio.so"
#: the JAX package's native/Makefile CXXFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-Wall", "-Wextra",
            "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None
_lock = threading.Lock()


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _have_libjpeg(cxx: str) -> bool:
    """True when `<jpeglib.h>` preprocesses (the Makefile's probe)."""
    try:
        res = subprocess.run([cxx, "-E", "-x", "c++", "-"],
                             input="#include <jpeglib.h>\n",
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return res.returncode == 0


def flags(cxx: Optional[str] = None) -> Tuple[Tuple[str, ...],
                                              Tuple[str, ...]]:
    """(compile flags, link libraries) of this host's build."""
    if _have_libjpeg(cxx or _cxx()):
        return CXXFLAGS + ("-DEG_HAVE_LIBJPEG",), ("-ljpeg",)
    return CXXFLAGS, ()


def library_path(cxx: Optional[str] = None) -> Path:
    """Where this source and these flags build to."""
    cflags, ldlibs = flags(cxx)
    h = hashlib.sha256(" ".join((cxx or _cxx(),) + cflags + ldlibs).encode())
    h.update(SOURCE.read_bytes())
    return build_root() / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Build the library unless this hash has one; returns its path.
    Raises RuntimeError with the compiler's output on failure."""
    cxx = _cxx()
    out = library_path(cxx)
    if out.is_file():
        return out
    cflags, ldlibs = flags(cxx)
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [cxx, *cflags, "-shared", "-o", tmp, str(SOURCE), *ldlibs]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library() -> Optional[ctypes.CDLL]:
    """The shared library, built on first use; None if it cannot be built
    or loaded (`build_error()` says why). Thread-safe."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
        except (RuntimeError, OSError, AttributeError) as e:
            _error = str(e)
            return None
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded or was not
    tried yet)."""
    return _error


def _bind(lib: ctypes.CDLL) -> None:
    i64, i32, f32, u64 = (
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_float,
        ctypes.c_uint64,
    )
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pi32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    lib.eg_load_cifar10_file.restype = i64
    lib.eg_load_cifar10_file.argtypes = [ctypes.c_char_p, pf, pi32, i64]
    lib.eg_load_mnist.restype = i64
    lib.eg_load_mnist.argtypes = [ctypes.c_char_p, ctypes.c_char_p, pf, pi32,
                                  i64, f32, f32]
    lib.eg_shard_plan.restype = None
    lib.eg_shard_plan.argtypes = [i64, i64, u64, u64, ctypes.c_int, pi64]
    lib.eg_gather.restype = None
    lib.eg_gather.argtypes = [pf, i64, pi64, i64, pf]
    lib.eg_gather_i32.restype = None
    lib.eg_gather_i32.argtypes = [pi32, pi64, i64, pi32]
    pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.eg_jpeg_supported.restype = ctypes.c_int
    lib.eg_load_jpeg_image.restype = ctypes.c_int
    lib.eg_load_jpeg_image.argtypes = [ctypes.c_char_p, pf, i32]
    lib.eg_jpeg_encode_file.restype = ctypes.c_int
    lib.eg_jpeg_encode_file.argtypes = [ctypes.c_char_p, pu8, i32, i32, i32]
    lib.eg_resize_bilinear_rgb.restype = None
    lib.eg_resize_bilinear_rgb.argtypes = [pu8, i32, i32, pu8, i32, i32]
    lib.eg_version.restype = ctypes.c_int


def available() -> bool:
    return load_library() is not None


def load_cifar10_bin(paths) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Read CIFAR-10 binary batch files natively; None if the library is
    unavailable or a file cannot be read."""
    lib = load_library()
    if lib is None:
        return None
    per_file = 10_000
    x = np.empty((per_file * len(paths), 32, 32, 3), np.float32)
    y = np.empty(per_file * len(paths), np.int32)
    total = 0
    for p in paths:
        got = lib.eg_load_cifar10_file(
            str(p).encode(), x[total:].reshape(-1), y[total:], per_file
        )
        if got < 0:
            return None
        total += int(got)
    return x[:total], y[:total]


def load_mnist_idx(
    images_path: str, labels_path: str, mean: float, std: float
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Read raw MNIST idx files natively, `(x / 255 - mean) / std` (no
    normalization at std 0); None if the library or a file is missing."""
    lib = load_library()
    if lib is None or not (os.path.exists(images_path)
                           and os.path.exists(labels_path)):
        return None
    cap = 70_000
    x = np.empty((cap, 28, 28, 1), np.float32)
    y = np.empty(cap, np.int32)
    got = lib.eg_load_mnist(
        images_path.encode(), labels_path.encode(), x.reshape(-1), y, cap,
        mean, std
    )
    if got < 0:
        return None
    return x[: int(got)], y[: int(got)]


def jpeg_supported() -> bool:
    lib = load_library()
    return bool(lib is not None and lib.eg_jpeg_supported())


_NO_JPEG = ("JPEG support needs the port's data library "
            "(eventgrad_tpu_torch/native/dataio.cpp) built against libjpeg")


def load_jpeg_image(path: str, image_size: int = 32) -> np.ndarray:
    """Decode one JPEG to [image_size, image_size, 3] RGB float32 in [0,1]
    (libjpeg decode + bilinear resize, the reference's imread+resize,
    custom.hpp:33-41). Raises on unsupported builds or bad files."""
    lib = load_library()
    if lib is None or not lib.eg_jpeg_supported():
        raise RuntimeError(_NO_JPEG)
    out = np.empty((image_size, image_size, 3), np.float32)
    rc = lib.eg_load_jpeg_image(str(path).encode(), out.reshape(-1),
                                image_size)
    if rc != 0:
        raise ValueError(f"JPEG decode failed for {path!r} (rc={rc})")
    return out


def save_jpeg(path: str, rgb: np.ndarray, quality: int = 90) -> None:
    """Encode an HWC uint8 RGB array to a JPEG file (fixtures / export)."""
    lib = load_library()
    if lib is None or not lib.eg_jpeg_supported():
        raise RuntimeError(_NO_JPEG)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected HWC RGB uint8, got shape {rgb.shape}")
    rc = lib.eg_jpeg_encode_file(
        str(path).encode(), rgb.reshape(-1), rgb.shape[1], rgb.shape[0],
        quality
    )
    if rc != 0:
        raise ValueError(f"JPEG encode failed for {path!r} (rc={rc})")


def shard_plan(
    n: int, n_ranks: int, seed: int = 0, epoch: int = 0, shuffle: bool = False
) -> np.ndarray:
    """[n_ranks, n // n_ranks] shard index plan (native or numpy fallback)."""
    per = n // n_ranks
    lib = load_library()
    if lib is None:
        if not shuffle:
            return np.arange(n_ranks * per, dtype=np.int64).reshape(n_ranks,
                                                                    per)
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        return rng.permutation(n)[: n_ranks * per].reshape(
            n_ranks, per).astype(np.int64)
    out = np.empty(n_ranks * per, np.int64)
    lib.eg_shard_plan(n, n_ranks, seed, epoch, int(shuffle), out)
    return out.reshape(n_ranks, per)


def gather_rows(arr: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """`arr[idx]`, bitwise, with the native memcpy gathers: a row of any
    whole number of 4-byte words (float32, int32, int64 labels or tokens)
    rides `eg_gather` through a float32 bit view, a scalar int32 row
    `eg_gather_i32`; other rows, or no library, take numpy indexing."""
    lib = load_library()
    a = np.ascontiguousarray(arr)
    flat_idx = np.ascontiguousarray(idx.reshape(-1), np.int64)
    row = a.itemsize * (int(np.prod(a.shape[1:])) if a.ndim > 1 else 1)
    if lib is None or row % 4:
        return a[flat_idx].reshape(idx.shape + a.shape[1:])
    if row == 4 and a.dtype == np.int32:
        out = np.empty(flat_idx.size, np.int32)
        lib.eg_gather_i32(a.reshape(-1), flat_idx, flat_idx.size, out)
    else:
        out = np.empty((flat_idx.size,) + a.shape[1:], a.dtype)
        lib.eg_gather(a.reshape(-1).view(np.float32), row // 4, flat_idx,
                      flat_idx.size, out.reshape(-1).view(np.float32))
    return out.reshape(idx.shape + a.shape[1:])


def gather_batches(
    x: np.ndarray, y: np.ndarray, idx: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Assemble [*idx.shape, ...sample] batches with native memcpy gathers.

    Samples may be any shape — images [H, W, C] with scalar labels, or
    token sequences [T] with [T]-shaped targets; integer arrays gather as
    int32, floats as float32 (the JAX module's contract; `gather_rows`
    keeps each array's dtype)."""

    def _norm(arr: np.ndarray) -> np.ndarray:
        dt = np.int32 if np.issubdtype(arr.dtype, np.integer) else np.float32
        return np.ascontiguousarray(arr, dt)

    return gather_rows(_norm(x), idx), gather_rows(_norm(y), idx)
