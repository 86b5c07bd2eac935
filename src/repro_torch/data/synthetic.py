"""Deterministic synthetic datasets (the container has no network access,
so CIFAR-10 and text corpora are procedurally generated — DESIGN.md §3).

* ``synthetic_cifar``: class-conditional structured images.  Each of the
  10 classes is a distinct mixture of oriented gratings + blob layout,
  plus per-sample noise — learnable by a small CNN but not trivially
  linearly separable, which is what a resilience analysis needs (a model
  whose accuracy responds smoothly to arithmetic error).
* ``token_stream``: a Zipf-distributed Markov token generator for LM
  training smoke runs (real perplexity dynamics, deterministic).
"""
from __future__ import annotations

import numpy as np


DATA_VERSION = 2  # bump to invalidate cached trained checkpoints


def synthetic_cifar(split: str, n: int, seed: int = 0,
                    image_size: int = 32, n_classes: int = 10):
    """Returns (images (n,S,S,3) f32 in [0,1], labels (n,) i32).

    Difficulty is tuned so a small trained CNN lands in the ~80-90%
    range (like CIFAR-10 ResNet-8): heavy per-sample texture jitter,
    low-contrast class signal, strong noise — this is what makes the
    resilience analysis informative (a saturated task hides arithmetic
    error; paper Sec. IV needs graded degradation)."""
    base = 0xC1FA9 if split == "train" else 0x7E57
    rng = np.random.default_rng(base + seed)
    s = image_size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s

    # fixed per-class texture parameters (shared across splits!)
    prng = np.random.default_rng(1234)
    freqs = prng.uniform(2.0, 6.0, size=(n_classes, 3))
    angles = prng.uniform(0, np.pi, size=(n_classes, 3))
    phases = prng.uniform(0, 2 * np.pi, size=(n_classes, 3))
    centers = prng.uniform(0.25, 0.75, size=(n_classes, 2))
    colors = prng.uniform(0.4, 1.0, size=(n_classes, 3))

    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    images = np.empty((n, s, s, 3), dtype=np.float32)
    for i in range(n):
        c = labels[i]
        img = np.zeros((s, s, 3), np.float32)
        jitter = rng.normal(0, 0.22, size=2)
        cx, cy = centers[c] + jitter
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.04))
        for ch in range(3):
            a = angles[c, ch] + rng.normal(0, 0.35)
            f = freqs[c, ch] * (1.0 + rng.normal(0, 0.15))
            grating = np.sin(2 * np.pi * f
                             * (xx * np.cos(a) + yy * np.sin(a))
                             + phases[c, ch] + rng.normal(0, 0.8))
            img[:, :, ch] = 0.5 + 0.10 * grating * colors[c, ch] \
                + 0.16 * blob * colors[c, (ch + 1) % 3]
        img += rng.normal(0, 0.16, size=(s, s, 3))
        images[i] = np.clip(img, 0.0, 1.0)
    return images, labels


def token_stream(vocab: int, batch: int, seq_len: int, step: int,
                 seed: int = 0):
    """Deterministic Markov-ish Zipf token batches.
    Returns (tokens (B,S) i32, targets (B,S) i32 = next token)."""
    rng = np.random.default_rng((seed * 1_000_003 + step) & 0x7FFFFFFF)
    v = min(vocab, 32768)
    # zipf-ish marginal
    ranks = np.arange(1, v + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    flat = rng.choice(v, size=batch * (seq_len + 1), p=probs)
    # inject local structure: every 4th token repeats with offset
    flat = flat.reshape(batch, seq_len + 1)
    flat[:, 4::4] = (flat[:, 0:-4:4] + 17) % v
    tokens = flat[:, :-1].astype(np.int32)
    targets = flat[:, 1:].astype(np.int32)
    return tokens, targets


class CifarBatches:
    """Host-side batched iterator with deterministic shuffling."""

    def __init__(self, split: str, n: int, batch: int, seed: int = 0):
        self.images, self.labels = synthetic_cifar(split, n, seed)
        self.batch = batch
        self.n = n
        self._rng = np.random.default_rng(seed + 99)
        self._order = np.arange(n)

    def epoch(self):
        self._rng.shuffle(self._order)
        for i in range(0, self.n - self.batch + 1, self.batch):
            idx = self._order[i:i + self.batch]
            yield {"images": self.images[idx], "labels": self.labels[idx]}

    def eval_batches(self, max_batches: int | None = None):
        count = 0
        for i in range(0, self.n - self.batch + 1, self.batch):
            yield {"images": self.images[i:i + self.batch],
                   "labels": self.labels[i:i + self.batch]}
            count += 1
            if max_batches is not None and count >= max_batches:
                return
