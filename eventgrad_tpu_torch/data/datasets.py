"""Datasets: the synthetic CIFAR/MNIST-shaped stand-in, the bundled
real digit scans, and the synthetic language-modeling task.

Port of `eventgrad_tpu/data/datasets.py`: `synthetic_dataset`,
`load_digits`, the synthetic and digits branches of
`load_or_synthesize` and `synthetic_lm_dataset`, verbatim in numpy so
the two packages train on identical arrays. The file loaders (MNIST
idx, CIFAR-10 binary) are not ported yet.

The digits are the UCI handwritten digits (1,797 8x8 scans, CC BY 4.0)
as scikit-learn ships them: `digits.csv.gz` beside this module is a
copy of scikit-learn's bundled file, parsed here as scikit-learn parses
it, so the port needs neither scikit-learn nor a download.
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

#: scikit-learn's `datasets/data/digits.csv.gz`: 64 pixels (0..16) and
#: the label per row
DIGITS_FILE = Path(__file__).resolve().with_name("digits.csv.gz")


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
    """"digits" (MNIST geometry) and "digits32" (CIFAR geometry) are the
    bundled real scans; anything else is the synthetic stand-in of the
    named dataset's shape ("mnist": 28x28x1, else 32x32x3). Reading real
    bytes from `data_dir` is not ported yet, so a `data_dir` raises
    rather than being ignored."""
    if dataset == "digits":
        return load_digits(split, seed=seed)
    if dataset == "digits32":
        return load_digits(split, seed=seed, geometry="cifar32")
    if data_dir:
        raise NotImplementedError(
            "the MNIST/CIFAR file loaders are not ported yet (ROADMAP "
            "queue 1, item 6); pass data_dir=None for the synthetic "
            "stand-in"
        )
    shape = (28, 28, 1) if dataset == "mnist" else (32, 32, 3)
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
