"""The port's native data library and file loaders against the JAX
package's, on files the test writes.

Both libraries build from the same C++ source (`native/dataio.cpp` and
the port's copy, `eventgrad_tpu_torch/native/dataio.cpp`) with the same
flags, so every array here must match the JAX package's bitwise: the
shard plan, the float32 / int32 gathers (and the port's dtype-keeping
gather against numpy indexing), CIFAR-10 binary batches, MNIST idx files
(raw and `.gz`, normalized or not), a JPEG round trip, a resize, a
garbage rejection, the JPEG tree loader, and `load_or_synthesize` for
"mnist" and "cifar10" with a `data_dir` (binary, pickle and JPEG trees,
and missing files falling back to the synthetic stand-in). The port's
library builds under `build/` and leaves the JAX package's `native/`
as it was.
"""

import gzip
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

from eventgrad_tpu.data import datasets as jax_datasets
from eventgrad_tpu.data import native as jax_native
from eventgrad_tpu_torch.data import datasets, native

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def libs():
    if jax_native.load_library() is None:
        pytest.skip("the JAX package's native library is unavailable")
    lib = native.load_library()
    assert lib is not None, native.build_error()
    return lib


@pytest.fixture(scope="module")
def jpeg(libs):
    if not jax_native.jpeg_supported():
        pytest.skip("the JAX package's library was built without libjpeg")
    assert native.jpeg_supported()
    return libs


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_version_and_build_place(libs):
    assert libs.eg_version() == 2
    path = native.library_path()
    root = pathlib.Path(os.environ.get("EG_TORCH_BUILD_DIR")
                        or ROOT / "build" / "eventgrad_tpu_torch")
    assert path.is_file() and root in path.parents
    assert path.name == "libeg_dataio.so"


def test_build_from_scratch_leaves_native_untouched(tmp_path):
    """A fresh build (its own build dir, its own process) lands under
    that dir, and nothing in the JAX package's native/ changes."""
    before = {p.name: p.stat().st_mtime_ns
              for p in (ROOT / "native").iterdir()}
    code = ("from eventgrad_tpu_torch.data import native; "
            "lib = native.load_library(); "
            "print(lib is not None, native.library_path(), "
            "native.build_error())")
    env = dict(os.environ, EG_TORCH_BUILD_DIR=str(tmp_path / "b"),
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    ok, path = out.stdout.split()[:2]
    assert ok == "True", out.stdout
    assert pathlib.Path(path).is_file()
    assert (tmp_path / "b") in pathlib.Path(path).parents
    after = {p.name: p.stat().st_mtime_ns for p in (ROOT / "native").iterdir()}
    assert after == before


@pytest.mark.parametrize("args", [(103, 4, 1, 2, True), (103, 4, 1, 3, True),
                                  (16, 4, 0, 0, False), (50, 3, 9, 1, True)])
def test_shard_plan_matches_jax(libs, args):
    n, r, seed, epoch, shuffle = args
    _same(native.shard_plan(n, r, seed, epoch, shuffle),
          jax_native.shard_plan(n, r, seed, epoch, shuffle))


def test_gathers_match_jax(libs):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 20, (3, 2, 5))
    cases = [
        (rng.standard_normal((20, 4, 4, 3)).astype(np.float32),
         np.arange(20, dtype=np.int32)),
        (rng.integers(0, 1000, (20, 16)).astype(np.int32),
         rng.integers(0, 1000, (20, 16)).astype(np.int64)),
        (rng.standard_normal((20, 7)).astype(np.float64),
         rng.integers(0, 9, 20).astype(np.uint8)),
    ]
    for x, y in cases:
        for got, want in zip(native.gather_batches(x, y, idx),
                             jax_native.gather_batches(x, y, idx)):
            _same(got, want)
        # the prefetcher's form: each array in its own dtype, bitwise
        # numpy indexing
        for arr in (x, y):
            _same(native.gather_rows(arr, idx), arr[idx])


def _write_cifar_bin(path, labels, chw):
    with open(path, "wb") as f:
        for lab, img in zip(labels, chw):
            f.write(bytes([int(lab)]))
            f.write(img.tobytes())


def _cifar_tree(root, rng, n_train=6, n_test=4):
    """The five binary training batches and the test batch."""
    data = {}
    for i in range(1, 6):
        lab = rng.integers(0, 10, n_train).astype(np.uint8)
        chw = rng.integers(0, 256, (n_train, 3, 32, 32)).astype(np.uint8)
        _write_cifar_bin(root / f"data_batch_{i}.bin", lab, chw)
        data[f"data_batch_{i}"] = (lab, chw)
    lab = rng.integers(0, 10, n_test).astype(np.uint8)
    chw = rng.integers(0, 256, (n_test, 3, 32, 32)).astype(np.uint8)
    _write_cifar_bin(root / "test_batch.bin", lab, chw)
    data["test_batch"] = (lab, chw)
    return data


def test_cifar10_binary_matches_jax(libs, tmp_path):
    data = _cifar_tree(tmp_path, np.random.default_rng(7))
    paths = [str(tmp_path / f"data_batch_{i}.bin") for i in range(1, 6)]
    for got, want in zip(native.load_cifar10_bin(paths),
                         jax_native.load_cifar10_bin(paths)):
        _same(got, want)
    for split in ("train", "test"):
        x, y = datasets.load_cifar10(str(tmp_path), split)
        jx, jy = jax_datasets.load_cifar10(str(tmp_path), split)
        _same(x, jx)
        _same(y, jy)
    # the reader's scale is the float32 reciprocal of 255
    lab, chw = data["test_batch"]
    x, y = datasets.load_cifar10(str(tmp_path), "test")
    _same(x, chw.transpose(0, 2, 3, 1).astype(np.float32)
          * (np.float32(1) / np.float32(255)))
    _same(y, lab.astype(np.int32))


def _write_idx(path, arr, magic, gz=False):
    header = magic.to_bytes(4, "big") + b"".join(
        d.to_bytes(4, "big") for d in arr.shape)
    opener = gzip.open if gz else open
    with opener(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(header + arr.tobytes())


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
def test_mnist_idx_matches_jax(libs, tmp_path, gz):
    rng = np.random.default_rng(9)
    for prefix, n in (("train", 7), ("t10k", 3)):
        _write_idx(tmp_path / f"{prefix}-images-idx3-ubyte",
                   rng.integers(0, 256, (n, 28, 28)).astype(np.uint8), 2051,
                   gz)
        _write_idx(tmp_path / f"{prefix}-labels-idx1-ubyte",
                   rng.integers(0, 10, n).astype(np.uint8), 2049, gz)
    for split in ("train", "test"):
        for normalize in (True, False):
            x, y = datasets.load_mnist(str(tmp_path), split, normalize)
            jx, jy = jax_datasets.load_mnist(str(tmp_path), split, normalize)
            assert x.shape[1:] == (28, 28, 1)
            _same(x, jx)
            _same(y, jy)


def _smooth(size):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    return np.stack([127 + 120 * np.sin(xx / 7), 127 + 120 * np.cos(yy / 9),
                     127 * np.ones_like(xx)], -1).astype(np.uint8)


def test_jpeg_round_trip_resize_and_garbage_match_jax(jpeg, tmp_path):
    small, big = str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")
    native.save_jpeg(small, _smooth(32), quality=95)
    native.save_jpeg(big, np.full((64, 48, 3), (10, 200, 90), np.uint8),
                     quality=98)
    out = native.load_jpeg_image(small, 32)
    assert out.dtype == np.float32 and 0.0 <= out.min() <= out.max() <= 1.0
    assert np.abs(out * 255.0 - _smooth(32)).mean() < 3.0
    for path in (small, big):
        for size in (32, 24):
            _same(native.load_jpeg_image(path, size),
                  jax_native.load_jpeg_image(path, size))
    # the same encoder: the same file bytes
    twin = str(tmp_path / "twin.jpg")
    jax_native.save_jpeg(twin, _smooth(32), quality=95)
    assert open(small, "rb").read() == open(twin, "rb").read()
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"this is not a jpeg at all")
    with pytest.raises(ValueError):
        native.load_jpeg_image(bad, 32)
    with pytest.raises(ValueError):
        jax_native.load_jpeg_image(bad, 32)


def _jpeg_tree(root, rng, classes=3):
    for split, n in (("train", 4), ("test", 2)):
        for cls in datasets.CIFAR10_CLASSES[:classes]:
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                native.save_jpeg(
                    str(d / f"{i:04d}.jpg"),
                    rng.integers(0, 256, (32, 32, 3)).astype(np.uint8), 92)


def test_jpeg_tree_loader_matches_jax(jpeg, tmp_path):
    _jpeg_tree(tmp_path, np.random.default_rng(3))
    assert datasets.CIFAR10_CLASSES == jax_datasets.CIFAR10_CLASSES
    x, y = datasets.load_cifar10_jpeg_dir(str(tmp_path), "train")
    assert x.shape == (12, 32, 32, 3)
    assert [int((y == c).sum()) for c in range(3)] == [4, 4, 4]
    jx, jy = jax_datasets.load_cifar10_jpeg_dir(str(tmp_path), "train")
    _same(x, jx)
    _same(y, jy)


def _pickle_tree(root, rng):
    for name, n in [(f"data_batch_{i}", 5) for i in range(1, 6)] + [
            ("test_batch", 3)]:
        with open(root / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072)).astype(
                np.uint8), b"labels": list(rng.integers(0, 10, n))}, f)


@pytest.mark.parametrize("layout", ["binary", "pickle", "jpeg", "missing"])
def test_load_or_synthesize_cifar10_matches_jax(libs, tmp_path, layout):
    rng = np.random.default_rng(11)
    if layout == "binary":
        _cifar_tree(tmp_path, rng)
    elif layout == "pickle":
        _pickle_tree(tmp_path, rng)
    elif layout == "jpeg":
        if not (jax_native.jpeg_supported() and native.jpeg_supported()):
            pytest.skip("built without libjpeg")
        _jpeg_tree(tmp_path, rng)
    for split in ("train", "test"):
        x, y = datasets.load_or_synthesize("cifar10", str(tmp_path), split,
                                           64, 0)
        jx, jy = jax_datasets.load_or_synthesize("cifar10", str(tmp_path),
                                                 split, 64, 0)
        _same(x, jx)
        _same(y, jy)
        if layout == "missing":
            _same(x, datasets.synthetic_dataset(64, (32, 32, 3), seed=0,
                                                split=split)[0])


@pytest.mark.parametrize("layout", ["idx", "missing"])
def test_load_or_synthesize_mnist_matches_jax(libs, tmp_path, layout):
    if layout == "idx":
        rng = np.random.default_rng(13)
        for prefix, n in (("train", 6), ("t10k", 4)):
            _write_idx(tmp_path / f"{prefix}-images-idx3-ubyte",
                       rng.integers(0, 256, (n, 28, 28)).astype(np.uint8),
                       2051)
            _write_idx(tmp_path / f"{prefix}-labels-idx1-ubyte",
                       rng.integers(0, 10, n).astype(np.uint8), 2049)
    for split in ("train", "test"):
        x, y = datasets.load_or_synthesize("mnist", str(tmp_path), split,
                                           64, 0)
        jx, jy = jax_datasets.load_or_synthesize("mnist", str(tmp_path),
                                                 split, 64, 0)
        _same(x, jx)
        _same(y, jy)
        assert (len(x) == 64) == (layout == "missing")
