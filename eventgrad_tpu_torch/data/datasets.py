"""Datasets: the synthetic CIFAR/MNIST-shaped stand-in and the synthetic
language-modeling task.

Port of `eventgrad_tpu/data/datasets.py`: `synthetic_dataset`, the
synthetic branch of `load_or_synthesize` and `synthetic_lm_dataset`,
verbatim in numpy so the two packages train on identical arrays. The real-data loaders (MNIST,
CIFAR-10, the bundled digits) are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


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


def load_or_synthesize(
    dataset: str, data_dir: Optional[str], split: str, n_synth: int = 4096,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """The synthetic stand-in of the named dataset's shape ("mnist":
    28x28x1, anything else: 32x32x3). Reading real bytes from `data_dir`
    is not ported yet, so a `data_dir` raises rather than being ignored."""
    if data_dir:
        raise NotImplementedError(
            "real-data loaders are not ported yet; pass data_dir=None for "
            "the synthetic stand-in"
        )
    if dataset in ("digits", "digits32"):
        raise NotImplementedError(f"dataset {dataset!r} is not ported yet")
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
