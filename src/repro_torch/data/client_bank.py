"""Device-resident padded client data bank (the batched FL engine's input).

All M shards are padded once to a common batch grid and moved to the
device as two tensors

    xb: (M, n_batches, batch_size, *feat)   x_train dtype
    yb: (M, n_batches, batch_size, *lab)    int32, -1 marks padding

so a round is a K-row gather (``xb[dev_idx]``) on the device instead of K
host-to-device copies.  Padding positions carry label -1, the validity
convention the loss masks on: the extra all-padding batches produce
exactly-zero gradients and leave the parameters untouched.

The same gather idiom serves evaluation: :class:`EvalBank` keeps the test
set on the device, and :func:`eval_sample_plan` precomputes a seeded
(T, n) row plan for a client-sampled eval (``frac = 1`` evaluates the full
test set).  Port of ``repro.data.client_bank`` (padded layout); the
bucketed layout comes with a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

EVAL_SEED_OFFSET = 23
# decorrelates the eval-sampling stream from the model-init / channel /
# scheduling streams that consume FLConfig.seed (the reference's value)


def _padded_arrays(x_train, y_train, shards, batch_size, nb):
    """Shared shard->grid layout: (m, nb, bs, *trail) arrays, -1 label pad."""
    m = len(shards)
    bs = int(batch_size)
    xb = np.zeros((m, nb * bs, *x_train.shape[1:]), x_train.dtype)
    yb = np.full((m, nb * bs, *y_train.shape[1:]), -1, np.int32)
    for k, idx in enumerate(shards):
        n = len(idx)
        xb[k, :n] = x_train[idx]
        yb[k, :n] = y_train[idx]
    feat, lab = x_train.shape[1:], y_train.shape[1:]
    return (
        xb.reshape(m, nb, bs, *feat),
        yb.reshape(m, nb, bs, *lab),
    )


@dataclasses.dataclass
class ClientBank:
    """All M client shards, padded and resident on the device."""

    xb: torch.Tensor     # (M, NB, BS, *feat) x_train dtype
    yb: torch.Tensor     # (M, NB, BS, *lab) int32; -1 marks padding
    sizes: np.ndarray    # (M,) realized shard sizes (host, for FedAvg weights)

    @property
    def num_devices(self) -> int:
        return self.xb.shape[0]

    @property
    def batch_size(self) -> int:
        return self.xb.shape[2]

    @property
    def nbytes(self) -> int:
        """Device bytes the bank holds (both tensors, padding included)."""
        return (self.xb.numel() * self.xb.element_size()
                + self.yb.numel() * self.yb.element_size())

    @staticmethod
    def _ceil_batches(n: int, batch_size: int) -> int:
        """The grid rule: batches needed to cover n samples (min 1)."""
        return max(1, int(-(-int(n) // int(batch_size))))

    def n_batches_for(self, devs) -> int:
        """Batches covering the given devices' shards — the batched engine
        slices the global grid down to this per round, clamped to the
        bank's own grid."""
        if not len(devs):
            return 1
        need = self._ceil_batches(self.sizes[list(devs)].max(), self.batch_size)
        return min(need, self.xb.shape[1])

    @classmethod
    def build(
        cls, x_train: np.ndarray, y_train: np.ndarray, shards: list,
        batch_size: int, *, device,
    ) -> "ClientBank":
        """Pad all shards once to the common (n_batches, batch_size) grid
        and move them to ``device``.  Sample order inside each shard is
        preserved."""
        m = len(shards)
        bs = int(batch_size)
        sizes = np.array([len(s) for s in shards], dtype=np.intp)
        nb = cls._ceil_batches(sizes.max(), bs) if m else 1
        xb, yb = _padded_arrays(x_train, y_train, shards, bs, nb)
        return cls(
            xb=torch.from_numpy(xb).to(device),
            yb=torch.from_numpy(yb).to(device),
            sizes=sizes,
        )


@dataclasses.dataclass
class EvalBank:
    """The test set, resident on the device for per-round evaluation."""

    xe: torch.Tensor     # (N, *feat)
    ye: torch.Tensor     # (N, *lab)

    @property
    def num_samples(self) -> int:
        return self.xe.shape[0]

    @classmethod
    def build(cls, x_test: np.ndarray, y_test: np.ndarray, *,
              device) -> "EvalBank":
        return cls(
            xe=torch.from_numpy(np.asarray(x_test)).to(device),
            ye=torch.from_numpy(np.asarray(y_test)).to(device),
        )


def eval_sample_plan(
    num_test: int, frac: float, num_rounds: int, seed: int
) -> "np.ndarray | None":
    """Seeded (T, n) eval-row gather plan, or ``None`` for a full eval.

    One draw per round for every round; n = ceil(frac * N), without
    replacement within a round (numpy, identical to the reference's plan).
    """
    if frac >= 1.0:
        return None
    n = max(1, int(np.ceil(frac * num_test)))
    rng = np.random.default_rng(seed + EVAL_SEED_OFFSET)
    return np.stack(
        [rng.choice(num_test, size=n, replace=False) for _ in range(num_rounds)]
    ).astype(np.int32)
