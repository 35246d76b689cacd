"""Synthetic MNIST-like and token data, non-iid partitioning and the device
banks."""
from repro_torch.data.client_bank import (
    BucketedClientBank, ClientBank, EvalBank, eval_sample_plan,
)
from repro_torch.data.mnist_like import Dataset, make_mnist_like
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.tokens import TokenDataset, make_token_dataset

__all__ = [
    "BucketedClientBank", "ClientBank", "Dataset", "EvalBank", "dirichlet_partition",
    "eval_sample_plan", "make_mnist_like", "TokenDataset",
    "make_token_dataset",
]
