"""Synthetic token pipeline: the port of ``repro/data/tokens.py``.

Reproducible pseudo-text token streams with a power-law unigram
distribution plus a short-range bigram structure, so the loss falls
measurably in training (uniform tokens would give a flat loss).  numpy
only, drawn as the reference draws them, so every array is bit-equal to
the reference's for the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # Zipfian unigram over a capped support, for cheap sampling
        support = min(v, 4096)
        ranks = np.arange(1, support + 1)
        probs = 1.0 / ranks**1.1
        self._support = support
        self._probs = probs / probs.sum()
        # a deterministic "grammar": each token prefers one successor
        self._succ = rng.integers(0, support, size=support)

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        base = rng.choice(self._support, size=(batch, seq), p=self._probs)
        # half of the positions follow the bigram successor of the previous
        follow = rng.random((batch, seq)) < 0.5
        out = base.copy()
        out[:, 1:] = np.where(
            follow[:, 1:], self._succ[out[:, :-1]], base[:, 1:]
        )
        return out.astype(np.int32)


def synthetic_token_batches(
    vocab_size: int, batch: int, seq: int, *, seed: int = 0
):
    """Infinite iterator of (tokens, labels) next-token-prediction batches."""
    stream = TokenStream(vocab_size, seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        toks = stream.sample(rng, batch, seq + 1)
        yield toks[:, :-1], toks[:, 1:]


@dataclasses.dataclass
class TokenDataset:
    """A fixed token corpus shaped like the FL drivers' image ``Dataset``.

    x_* are (N, S) int32 token rows, y_* the (N, S) shifted next-token
    labels; class_* are (N,) pseudo-class ids (first token mod 10), so
    :func:`repro_torch.data.partition.dirichlet_partition`, which
    partitions by class label, makes the same kind of non-iid shards of
    token rows as of images.
    """

    x_train: np.ndarray   # (N, S) int32
    y_train: np.ndarray   # (N, S) int32
    x_test: np.ndarray
    y_test: np.ndarray
    class_train: np.ndarray   # (N,) int32 pseudo-class for partitioning
    class_test: np.ndarray


def make_token_dataset(
    *,
    vocab_size: int,
    num_samples: int = 2_000,
    seq_len: int = 16,
    train_frac: float = 0.9,
    seed: int = 0,
) -> TokenDataset:
    """A fixed (N, S) next-token corpus from :class:`TokenStream`: each row
    an independent length-(S+1) draw split into (tokens, labels), the FL
    analogue of one image sample."""
    stream = TokenStream(vocab_size, seed)
    rng = np.random.default_rng(seed + 1)
    toks = stream.sample(rng, num_samples, seq_len + 1)
    x, y = toks[:, :-1], toks[:, 1:]
    classes = (x[:, 0] % 10).astype(np.int32)
    n_train = int(train_frac * num_samples)
    return TokenDataset(
        x_train=x[:n_train], y_train=y[:n_train],
        x_test=x[n_train:], y_test=y[n_train:],
        class_train=classes[:n_train], class_test=classes[n_train:],
    )
