"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source compiles with `nvcc` for Hopper (`sm_90a`) into an object
file, all sources at once in parallel, and the objects link into one
shared library with a plain C interface, loaded with `ctypes`. The
library is built on first use into
`build/eventgrad_tpu_torch/<hash>/libeg_kernels.so` beside the package
(or under `$EG_TORCH_BUILD_DIR`), keyed by a hash of the sources and the
flags, so a checkout builds what it holds and a rebuilt source never
meets a stale library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
LIB_NAME = "libeg_kernels.so"

#: -fmad=false: no FMA contraction, so each kernel is bitwise its plain
#: PyTorch version (the sources also use the _rn intrinsics)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)


def build_root() -> Path:
    env = os.environ.get("EG_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return _PKG.parent / "build" / "eventgrad_tpu_torch"


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME, else the toolkit's default
    install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME): the port's CUDA kernels are "
        "built from source on first use"
    )


def library_path() -> Path:
    return build_root() / source_hash() / LIB_NAME


def build(verbose: bool = False) -> Tuple[Path, float, str]:
    """Build the library unless this source hash already has one.
    Returns (path, seconds spent building, compiler output). With
    `verbose`, ptxas reports registers, shared memory and spills."""
    out = library_path()
    if out.is_file():
        return out, 0.0, ""
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *flags, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        logs = []
        failed = None
        for cmd, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(text)
            if proc.returncode != 0 and failed is None:
                failed = (cmd, text)
        if failed is not None:
            raise RuntimeError(
                f"nvcc failed: {' '.join(failed[0])}\n{failed[1]}"
            )
        lib_tmp = Path(tmp) / LIB_NAME
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib_tmp),
                *(str(obj) for _, obj, _ in procs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed: {' '.join(link)}\n{res.stdout}{res.stderr}"
            )
        os.replace(lib_tmp, out)
    return out, time.perf_counter() - t0, "".join(logs)


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
_I = ctypes.c_int

_SIGNATURES = {
    # flat, fire, out, n, vec, stream
    "eg_masked_wire": [_P, _P, _P, _I64, _I, _P],
    # flat, fire, scale, out, n, vec, stream
    "eg_mask_quant": [_P, _P, _P, _P, _I64, _I, _P],
    # p, g, t, cands*, keeps*, lasts*, p_out, t_out, bufs_out*, nb, n,
    # lr, mom, w, mix_stale, vec, stream
    "eg_mix_commit": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I64,
                      _F, _F, _F, _I, _I, _P],
    # p, buf_sum, g, t, p_out, t_out, n, lr, mom, w, rows, w_rows|NULL,
    # vec, stream
    "eg_mix_sgd": [_P, _P, _P, _P, _P, _P, _I64, _F, _F, _F, _I64, _P, _I,
                   _P],
    # p, g, t, cands*, keeps*, lasts*, scales*|NULL, p_out, t_out,
    # bufs_out*, nb, n, lr, mom, w, mix_stale, carrier, vec, stream
    "eg_mix_commit_carrier": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I64, _F, _F, _F, _I, _I, _I, _P],
    # q, k, v, out, lse, offs|NULL, strides (host int64[9]), b, t, h, d,
    # n_off, per, causal, dtype, stream
    "eg_flash_fwd": [_P] * 7 + [_I] * 8 + [_P],
    # q, k, v, dout, lse, delta, dq, offs|NULL, strides (host int64[12]),
    # b, t, h, d, n_off, per, causal, dtype, stream
    "eg_flash_dq": [_P] * 9 + [_I] * 8 + [_P],
    # q, k, v, dout, lse, delta, dk, dv, offs|NULL, strides (host
    # int64[12]), b, t, h, d, n_off, per, causal, dtype, stream
    "eg_flash_dkv": [_P] * 10 + [_I] * 8 + [_P],
    # kernel (0 forward, 1 dQ, 2 dK/dV), ptrs (host void*[3 or 4]), strides
    # (host int64[9 or 12]), d, dtype, smem (host int64*): the form the C
    # dispatcher picks and its shared memory (chip_smoke.py's check)
    "eg_flash_form": [_I, _P, _P, _I, _I, _P],
    # the pitched (bucket) forms: the contiguous form's pointers, then
    # rows, cols, ld (the arena row pitch), off (the bucket's first
    # column) in place of n; the commit forms then take the gated form's
    # per-row operands (w_rows, gate, poison, quar; carrier: w_rows,
    # gate), each NULL when unused
    "eg_masked_wire_pitched": [_P, _P, _P, _I64, _I64, _I64, _I64, _I, _P],
    "eg_mask_quant_pitched": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I,
                              _P],
    "eg_mix_commit_pitched": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I64,
                              _I64, _I64, _I64, _F, _F, _F, _I, _P, _P, _P,
                              _P, _I, _P],
    "eg_mix_commit_carrier_pitched": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _I, _I64, _I64, _I64, _I64, _F,
                                      _F, _F, _I, _I, _P, _P, _I, _P],
    # x, o, n, stream: the auditor's seeded unregistered kernel
    # (analysis/audit.py, eg::leak_kernel)
    "eg_leak_x2": [_P, _P, _I64, _P],
}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_inputs(op: str, *, dtypes=None, **tensors):
    """Validate a kernel's tensor arguments: contiguous, one shape, one
    device, and each of the dtype `dtypes` names for it (default
    float32). Returns (device, numel)."""
    import torch

    dtypes = dtypes or {}
    first = None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{op}: {name} must be a torch.Tensor")
        want = dtypes.get(name, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{op}: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        if first is None:
            first = (name, t)
            continue
        if t.shape != first[1].shape:
            raise ValueError(
                f"{op}: {name} has shape {tuple(t.shape)}, "
                f"{first[0]} has {tuple(first[1].shape)}"
            )
        if t.device != first[1].device:
            raise ValueError(
                f"{op}: {name} is on {t.device}, {first[0]} on "
                f"{first[1].device}"
            )
    t0 = first[1]
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {t0.device}")
    return t0.device, t0.numel()


def check_bucket(op: str, arena: dict, bucket: dict, off: int, *,
                 dtypes=None):
    """Validate a pitched (bucket) form's arguments: the `arena` tensors
    `[R, n]` and the `bucket` tensors `[R, c]`, all contiguous, on one
    device, each of the dtype `dtypes` names for it (default float32),
    with the bucket's columns `[off, off + c)` inside the arena row.
    Returns (device, R, c, n)."""
    device, _ = check_inputs(op, dtypes=dtypes, **arena)
    bdev, _ = check_inputs(op, dtypes=dtypes, **bucket)
    a0, b0 = next(iter(arena.values())), next(iter(bucket.values()))
    if a0.dim() != 2 or b0.dim() != 2 or a0.shape[0] != b0.shape[0]:
        raise ValueError(f"{op}: arena {tuple(a0.shape)} and bucket "
                         f"{tuple(b0.shape)} must be [R, n] and [R, c]")
    if bdev != device:
        raise ValueError(f"{op}: bucket tensors on {bdev}, arena on {device}")
    rows, cols, ld = a0.shape[0], b0.shape[1], a0.shape[1]
    if not 0 <= int(off) <= ld - cols:
        raise ValueError(f"{op}: columns [{off}, {off + cols}) outside the "
                         f"arena row of {ld}")
    return device, rows, cols, ld


def launch(op: str, fn, *args) -> None:
    """Call a C entry point and raise on a non-zero cudaError_t."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{op}: CUDA kernel launch failed (cudaError {rc})")


def aligned(*tensors) -> int:
    """1 when every tensor's storage pointer is aligned for a load of 4
    of its elements at once (the kernels' 4-wide path: 16 bytes for f32,
    8 for bf16, 4 for int8), else 0."""
    return int(all(t.data_ptr() % (4 * t.element_size()) == 0
                   for t in tensors))


def stream_of(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
