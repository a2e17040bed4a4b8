"""Datasets: the synthetic CIFAR/MNIST-shaped stand-in.

Port of `eventgrad_tpu/data/datasets.py`: `synthetic_dataset` and the
synthetic branch of `load_or_synthesize`, verbatim in numpy so the two
packages train on identical arrays. The real-data loaders (MNIST,
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
