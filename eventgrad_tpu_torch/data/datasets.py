"""Datasets: the MNIST idx and CIFAR-10 file loaders, the synthetic
CIFAR/MNIST-shaped stand-in, the bundled real digit scans, and the
synthetic language-modeling task.

Port of `eventgrad_tpu/data/datasets.py`, verbatim in numpy so the two
packages train on identical arrays:

  * `load_mnist(dir)` reads the standard idx files
    (train-images-idx3-ubyte etc., raw or `.gz`) and applies the
    reference's Normalize(0.1307, 0.3081) (cent.cpp:55); raw files go
    through the port's native reader (`data/native.py`), `.gz` through
    numpy.
  * `load_cifar10(dir)` reads the reference's raw-JPEG tree
    (`<split>/<class>/*.jpg`, decoded by libjpeg in a thread pool) when
    it is there and decodable, else the canonical binary batches
    (data_batch_{1..5}.bin / test_batch.bin), else the python-pickle
    batches, scaled to [0,1] float32.
  * `load_or_synthesize` reads `data_dir` for "mnist" / "cifar10" and
    falls back to `synthetic_dataset`, the deterministic learnable
    stand-in, when the files are not there.

The digits are the UCI handwritten digits (1,797 8x8 scans, CC BY 4.0)
as scikit-learn ships them: `digits.csv.gz` beside this module is a
copy of scikit-learn's bundled file, parsed here as scikit-learn parses
it, so the port needs neither scikit-learn nor a download.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct as _struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

#: scikit-learn's `datasets/data/digits.csv.gz`: 64 pixels (0..16) and
#: the label per row
DIGITS_FILE = Path(__file__).resolve().with_name("digits.csv.gz")


MNIST_MEAN, MNIST_STD = 0.1307, 0.3081


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def _read_idx(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        data = f.read()
    magic, = _struct.unpack(">I", data[:4])
    ndim = magic & 0xFF
    dims = _struct.unpack(">" + "I" * ndim, data[4 : 4 + 4 * ndim])
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def load_mnist(
    data_dir: str, split: str = "train", normalize: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST from its idx files in `data_dir`: images NHWC float32
    (normalized unless `normalize=False`), labels int32."""
    prefix = "train" if split == "train" else "t10k"
    ipath = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte")
    lpath = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte")

    # fast path: native idx reader (raw files only; gz falls through)
    from eventgrad_tpu_torch.data import native

    mean, std = (MNIST_MEAN, MNIST_STD) if normalize else (0.0, 0.0)
    out = native.load_mnist_idx(ipath, lpath, mean, std)
    if out is not None:
        return out

    images = _read_idx(ipath)
    labels = _read_idx(lpath)
    x = images.astype(np.float32)[..., None] / 255.0
    if normalize:
        x = (x - MNIST_MEAN) / MNIST_STD
    return x, labels.astype(np.int32)


# the reference's folder-name -> label map (custom.hpp:15-19 uses the same
# alphabetical CIFAR-10 class order)
CIFAR10_CLASSES = (
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
)


def load_cifar10_jpeg_dir(
    data_dir: str, split: str = "train", image_size: int = 32
) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's raw-JPEG CIFAR-10 layout (`<root>/<split>/<class>/
    NNNN.jpg`, the "CIFAR-10-images" mirror, custom.hpp:66-122): walk the
    class folders, decode and resize natively (libjpeg + bilinear,
    standing in for cv::imread/cv::resize, custom.hpp:33-41).
    Deterministic file order (sorted); shuffling is the sampler's job."""
    from eventgrad_tpu_torch.data import native

    root = os.path.join(data_dir, split)
    paths: list = []
    labels: list = []
    for label, cls in enumerate(CIFAR10_CLASSES):
        cls_dir = os.path.join(root, cls)
        if not os.path.isdir(cls_dir):
            continue
        for name in sorted(os.listdir(cls_dir)):
            if name.lower().endswith((".jpg", ".jpeg")):
                paths.append(os.path.join(cls_dir, name))
                labels.append(label)
    if not paths:
        raise FileNotFoundError(f"no <class>/*.jpg under {root}")
    if not native.jpeg_supported():  # also forces the (locked) library load
        raise RuntimeError(native._NO_JPEG)
    x = np.empty((len(paths), image_size, image_size, 3), np.float32)

    # ctypes drops the GIL during the native decode, so a thread pool
    # scales across cores
    from concurrent.futures import ThreadPoolExecutor

    def _decode(i: int) -> None:
        x[i] = native.load_jpeg_image(paths[i], image_size)

    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as pool:
        list(pool.map(_decode, range(len(paths))))
    return x, np.asarray(labels, np.int32)


def load_cifar10(data_dir: str, split: str = "train"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 from `data_dir`: the raw-JPEG tree when present and
    decodable, else the binary batches, else the pickle batches. Images
    NHWC float32 in [0, 1], labels int32."""
    # a libjpeg-less build or a jpg-less class tree falls through to the
    # binary/pickle formats (and ultimately the synthetic fallback)
    def _has_jpgs() -> bool:
        for c in CIFAR10_CLASSES:
            d = os.path.join(data_dir, split, c)
            if os.path.isdir(d) and any(
                n.lower().endswith((".jpg", ".jpeg")) for n in os.listdir(d)
            ):
                return True
        return False

    if os.path.isdir(os.path.join(data_dir, split)) and _has_jpgs():
        from eventgrad_tpu_torch.data import native

        if native.jpeg_supported():
            return load_cifar10_jpeg_dir(data_dir, split)

    bin_names = (
        [f"data_batch_{i}.bin" for i in range(1, 6)]
        if split == "train"
        else ["test_batch.bin"]
    )
    if os.path.exists(os.path.join(data_dir, bin_names[0])):
        paths = [os.path.join(data_dir, n) for n in bin_names]

        # fast path: native binary reader
        from eventgrad_tpu_torch.data import native

        out = native.load_cifar10_bin(paths)
        if out is not None:
            return out

        xs, ys = [], []
        for path in paths:
            raw = np.fromfile(path, np.uint8).reshape(-1, 3073)
            ys.append(raw[:, 0])
            xs.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        x = np.concatenate(xs).astype(np.float32) / 255.0
        return x, np.concatenate(ys).astype(np.int32)

    # python pickle version (cifar-10-batches-py)
    py_names = (
        [f"data_batch_{i}" for i in range(1, 6)] if split == "train"
        else ["test_batch"]
    )
    xs, ys = [], []
    for name in py_names:
        with open(os.path.join(data_dir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(
            np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32)
            .transpose(0, 2, 3, 1)
        )
        ys.append(np.asarray(d[b"labels"], np.int64))
    x = np.concatenate(xs).astype(np.float32) / 255.0
    return x, np.concatenate(ys).astype(np.int32)


def synthetic_dataset(
    n: int,
    image_shape: Tuple[int, int, int] = (28, 28, 1),
    num_classes: int = 10,
    seed: int = 0,
    split: str = "train",
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic learnable classification task.

    Each class has a fixed random prototype image; a sample is its class
    prototype at moderate SNR plus Gaussian noise. `split` offsets the
    sample stream so train/test are disjoint. Images are NHWC float32,
    labels int32.
    """
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((num_classes,) + tuple(image_shape)).astype(
        np.float32
    )
    offset = 0 if split == "train" else 1_000_003
    sample_rng = np.random.default_rng(seed + 17 + offset)
    y = sample_rng.integers(0, num_classes, n).astype(np.int32)
    noise = sample_rng.standard_normal((n,) + tuple(image_shape)).astype(np.float32)
    x = 0.6 * protos[y] + noise
    return x, y


def load_digits(
    split: str, seed: int = 0, geometry: str = "mnist"
) -> Tuple[np.ndarray, np.ndarray]:
    """The real handwritten-digit scans (1,797 8x8 images, 10 classes),
    deterministically shuffled by `seed`: 357 test / 1,440 train.

    geometry="mnist": upsampled 8x8 -> 32x32 (nearest) and center-cropped
    to 28x28x1 so the MNIST models apply unchanged.
    geometry="cifar32": the full 32x32 upsample replicated to 3 channels,
    real pixels at CIFAR shapes. Images float32 NHWC, labels int32."""
    with gzip.open(DIGITS_FILE, mode="rt", encoding="utf-8") as f:
        data = np.loadtxt(f, delimiter=",")
    images = data[:, :-1].reshape(-1, 8, 8)
    target = data[:, -1].astype(int, copy=False)
    imgs = images.astype(np.float32) / 16.0
    big = np.kron(imgs, np.ones((4, 4), np.float32))
    if geometry == "cifar32":
        big = np.repeat(big[:, :, :, None], 3, axis=3)
    elif geometry == "mnist":
        big = big[:, 2:30, 2:30, None]
    else:
        raise ValueError(f"unknown digits geometry {geometry!r}")
    labels = target.astype(np.int32)
    order = np.random.default_rng(seed).permutation(len(labels))
    big, labels = big[order], labels[order]
    n_test = 357
    if split == "train":
        return big[n_test:], labels[n_test:]
    return big[:n_test], labels[:n_test]


def load_or_synthesize(
    dataset: str, data_dir: Optional[str], split: str, n_synth: int = 4096,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Real data where there is some, else the synthetic stand-in of the
    named dataset's shape ("mnist": 28x28x1, else 32x32x3).

    "digits" (MNIST geometry) and "digits32" (CIFAR geometry) are the
    bundled real scans (no data_dir needed); "mnist" / "cifar10" read
    real bytes from `data_dir` when present (`load_mnist`,
    `load_cifar10`), and a missing or unreadable file falls back to the
    stand-in, as the JAX function does."""
    if dataset == "digits":
        return load_digits(split, seed=seed)
    if dataset == "digits32":
        return load_digits(split, seed=seed, geometry="cifar32")
    shape = (28, 28, 1) if dataset == "mnist" else (32, 32, 3)
    if data_dir:
        try:
            if dataset == "mnist":
                return load_mnist(data_dir, split)
            if dataset == "cifar10":
                return load_cifar10(data_dir, split)
        except (FileNotFoundError, OSError):
            pass
    return synthetic_dataset(n_synth, shape, seed=seed, split=split)

def synthetic_lm_dataset(
    n: int,
    seq_len: int = 128,
    vocab: int = 256,
    seed: int = 0,
    split: str = "train",
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic learnable language-modeling task.

    Sequences are sampled from a fixed random first-order Markov chain with
    peaked transition rows (each token has a few likely successors), so a
    next-token model genuinely learns — cross-entropy falls from log(vocab)
    toward the chain's conditional entropy. Returns (tokens[n, seq_len],
    targets[n, seq_len]) int32 with targets the next token. `split` offsets
    the sample stream so train/test are disjoint.
    """
    rng = np.random.default_rng(seed)
    # peaked rows: logits ~ N(0, 3) -> a handful of high-probability successors
    logits = 3.0 * rng.standard_normal((vocab, vocab))
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    cum = np.cumsum(probs, axis=1)

    offset = 0 if split == "train" else 1_000_003
    sample_rng = np.random.default_rng(seed + 29 + offset)
    toks = np.empty((n, seq_len + 1), np.int32)
    toks[:, 0] = sample_rng.integers(0, vocab, n)
    u = sample_rng.random((n, seq_len))
    for t in range(seq_len):  # vectorized over sequences; seq_len steps
        # clamp: float cumsum can top out a few ulps below 1.0, and a draw
        # above it would index one past the vocabulary
        toks[:, t + 1] = np.minimum(
            (cum[toks[:, t]] < u[:, t : t + 1]).sum(axis=1), vocab - 1
        ).astype(np.int32)
    return toks[:, :-1].copy(), toks[:, 1:].copy()
