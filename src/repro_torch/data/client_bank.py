"""Device-resident padded client data bank (the batched FL engine's input).

All M shards are padded once to a common batch grid and moved to the
device as two tensors

    xb: (M, n_batches, batch_size, *feat)   x_train dtype
    yb: (M, n_batches, batch_size, *lab)    int32, -1 marks padding

so a round is a K-row gather (``xb[dev_idx]``) on the device instead of K
host-to-device copies.  Padding positions carry label -1, the validity
convention the loss masks on: the extra all-padding batches produce
exactly-zero gradients and leave the parameters untouched.

Memory: the padded bank pads every client to the largest shard's batch
count, so a skewed partition at large M pays M * max_k instead of sum_k.
``ClientBank.build`` warns (:func:`_check_bank_memory`) when the bank would
claim more than ``DEFAULT_MEM_FRACTION`` of the card's memory and points at
:class:`BucketedClientBank`, which groups clients into power-of-two
batch-count buckets so that within-bucket padding stays below 2x.

The same gather idiom serves evaluation: :class:`EvalBank` keeps the test
set on the device, and :func:`eval_sample_plan` precomputes a seeded
(T, n) row plan for a client-sampled eval (``frac = 1`` evaluates the full
test set).  Port of ``repro.data.client_bank``.  ``build`` puts the banks on
``cuda`` unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.device import resolve_device

EVAL_SEED_OFFSET = 23
# decorrelates the eval-sampling stream from the model-init / channel /
# scheduling streams that consume FLConfig.seed (the reference's value)

DEFAULT_MEM_FRACTION = 0.5
# fraction of the card's memory a padded bank may claim before ``build``
# warns and recommends the bucketed layout


def _device_memory_limit(device) -> "int | None":
    """The card's memory in bytes (``torch.cuda.mem_get_info``), or None on
    the CPU, which reports no limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def _check_bank_memory(projected_bytes: int, mem_fraction: float,
                       device) -> None:
    limit = _device_memory_limit(device)
    if limit is None or limit <= 0:
        return
    if projected_bytes > mem_fraction * limit:
        warnings.warn(
            f"padded ClientBank would hold {projected_bytes / 2**20:.0f} MiB "
            f"(> {mem_fraction:.0%} of the device's {limit / 2**20:.0f} MiB):"
            f" skewed shard sizes pad every client to the largest shard; "
            f"use FLConfig(client_bank='bucketed') (BucketedClientBank) to "
            f"bound the padding, or shrink the dataset / batch grid",
            ResourceWarning,
            stacklevel=3,
        )


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

    def gather(self, devs, nb: int):
        """The scheduled rows, (K, nb, BS, ...) each, row k device devs[k]."""
        idx = torch.as_tensor(list(devs), dtype=torch.int64,
                              device=self.xb.device)
        return self.take(idx, nb)

    def take(self, idx: torch.Tensor, nb: int):
        """The rows of the device ids ``idx`` (an int64 tensor on the bank's
        device), cut to ``nb`` batches: the scanned horizon's gather, with
        no host list and no copy to the card."""
        return self.xb[idx, :nb], self.yb[idx, :nb]

    @classmethod
    def build(
        cls, x_train: np.ndarray, y_train: np.ndarray, shards: list,
        batch_size: int, *, device=None,
        mem_fraction: float = DEFAULT_MEM_FRACTION,
    ) -> "ClientBank":
        """Pad all shards once to the common (n_batches, batch_size) grid
        and move them to ``device`` (``None`` means ``cuda``).  Sample
        order inside each shard is preserved."""
        device = resolve_device(device)
        m = len(shards)
        bs = int(batch_size)
        sizes = np.array([len(s) for s in shards], dtype=np.intp)
        nb = cls._ceil_batches(sizes.max(), bs) if m else 1
        itemsize = np.dtype(x_train.dtype).itemsize
        feat = int(np.prod(x_train.shape[1:], dtype=np.int64))
        lab = int(np.prod(y_train.shape[1:], dtype=np.int64))
        _check_bank_memory(m * nb * bs * (feat * itemsize + lab * 4),
                           mem_fraction, device)
        xb, yb = _padded_arrays(x_train, y_train, shards, bs, nb)
        return cls(
            xb=torch.from_numpy(xb).to(device),
            yb=torch.from_numpy(yb).to(device),
            sizes=sizes,
        )


@dataclasses.dataclass
class BucketedClientBank:
    """Size-bucketed client banks: power-of-two batch grids instead of one
    max grid.

    Clients are grouped by ``next_pow2(ceil(|D_k| / bs))`` and each bucket
    is padded only to its own power-of-two batch count, so within-bucket
    padding stays below 2x a client's own need.  A round's K-row gather
    spans several buckets (:meth:`gather`): each row from its bucket, its
    batch axis padded or sliced to the round's ``nb``.  The gathered rows
    equal the padded bank's ``xb[devs, :nb]`` element for element, so
    training through either layout is bit-identical.
    """

    buckets: list           # (xb, yb) tensor pairs, (m_b, NB_b, BS, ...)
    bucket_of: np.ndarray   # (M,) bucket index per client
    row_of: np.ndarray      # (M,) row of the client inside its bucket
    sizes: np.ndarray       # (M,) realized shard sizes

    @property
    def num_devices(self) -> int:
        return len(self.sizes)

    @property
    def batch_size(self) -> int:
        return self.buckets[0][0].shape[2]

    @property
    def nbytes(self) -> int:
        return sum(xb.numel() * xb.element_size()
                   + yb.numel() * yb.element_size()
                   for xb, yb in self.buckets)

    def n_batches_for(self, devs) -> int:
        """:meth:`ClientBank.n_batches_for`'s rule, clamped to the largest
        bucket grid."""
        if not len(devs):
            return 1
        need = ClientBank._ceil_batches(
            self.sizes[list(devs)].max(), self.batch_size
        )
        return min(need, max(xb.shape[1] for xb, _ in self.buckets))

    def gather(self, devs, nb: int):
        """The scheduled rows as (K, nb, BS, ...) tensors, row k device
        devs[k]; pad batches carry label -1 (exactly-zero gradients).

        Each row comes from its own bucket, its batch axis cut or padded
        to ``nb``.  The reference gathers in bucket order and permutes
        back; taking the rows in schedule order gives the same tensors
        without an index copy to the card."""
        xs, ys = [], []
        for d in devs:
            xb, yb = self.buckets[self.bucket_of[d]]
            row = int(self.row_of[d])
            x, y = xb[row], yb[row]
            have = x.shape[0]
            if have >= nb:
                x, y = x[:nb], y[:nb]
            else:
                pad = nb - have
                x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
                y = torch.cat([y, y.new_full((pad, *y.shape[1:]), -1)])
            xs.append(x)
            ys.append(y)
        return torch.stack(xs), torch.stack(ys)

    @classmethod
    def build(
        cls, x_train: np.ndarray, y_train: np.ndarray, shards: list,
        batch_size: int, *, device=None,
        mem_fraction: float = DEFAULT_MEM_FRACTION,
    ) -> "BucketedClientBank":
        """Bucket the shards by power-of-two batch count and move each
        bucket to ``device`` (``None`` means ``cuda``).  ``mem_fraction``
        is accepted for :meth:`ClientBank.build`'s signature: bucketing is
        the remedy its warning names."""
        del mem_fraction
        device = resolve_device(device)
        bs = int(batch_size)
        sizes = np.array([len(s) for s in shards], dtype=np.intp)
        need = np.array(
            [ClientBank._ceil_batches(n, bs) for n in sizes], dtype=np.intp
        )
        pow2 = 1 << np.ceil(np.log2(need)).astype(np.intp)
        levels = sorted(set(int(p) for p in pow2))
        bucket_of = np.zeros(len(shards), np.intp)
        row_of = np.zeros(len(shards), np.intp)
        buckets = []
        for bi, nb in enumerate(levels):
            members = [k for k in range(len(shards)) if int(pow2[k]) == nb]
            bucket_of[members] = bi
            row_of[members] = np.arange(len(members))
            xb, yb = _padded_arrays(
                x_train, y_train, [shards[k] for k in members], bs, nb
            )
            buckets.append((torch.from_numpy(xb).to(device),
                            torch.from_numpy(yb).to(device)))
        return cls(buckets=buckets, bucket_of=bucket_of, row_of=row_of,
                   sizes=sizes)


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
