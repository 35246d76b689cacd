"""Quickstart on the PyTorch port: the paper's pipeline end to end.

    PYTHONPATH=src python examples/quickstart_torch.py               # on cuda
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The same run as examples/quickstart.py, through ``repro_torch``: a small
NOMA cell, the MWIS greedy schedule, MAPEL power, a few FedAvg rounds of the
reference's default round body (``FLConfig`` defaults: the legacy engine,
adaptive DoReFa compression) and the accuracy trajectory.  It runs on the
CUDA card unless given ``--device cpu``; seed s draws the channels and
initial weights the reference draws from seed s.
"""
import argparse

import numpy as np

from repro_torch.config import FLConfig
from repro_torch.core import channel, fl
from repro_torch.data import dirichlet_partition, make_mnist_like

M, K, T = 30, 3, 6


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    print("== 1. world: synthetic MNIST-like dataset, non-iid across", M,
          "devices")
    ds = make_mnist_like(num_samples=2500, seed=0)
    cell = channel.CellConfig(num_devices=M)
    shards = dirichlet_partition(ds.y_train, M, seed=0)
    print(f"   train={len(ds.x_train)} test={len(ds.x_test)} "
          f"device sizes: min={min(map(len, shards))} "
          f"max={max(map(len, shards))}")

    print(f"== 2. FL over NOMA on {args.device}: MWIS scheduling + MAPEL "
          f"power, K={K}, T={T}")
    cfg = FLConfig(num_devices=M, group_size=K, num_rounds=T,
                   scheduler="lazy-gwmin", power_mode="mapel",
                   compression="adaptive", seed=0)
    res = fl.run_federated_learning(
        ds, shards, cell, cfg, uplink="noma", device=args.device,
        progress=lambda log: print(
            f"   round {log.round}: devices={log.devices} "
            f"rates={np.round(log.rates, 2)} bits={log.bits} "
            f"acc={log.test_accuracy:.3f} t={log.wall_time_s:.1f}s"))

    print(f"== 3. final accuracy {res.accuracies()[-1]:.3f} "
          f"(scheme {res.scheme}, engine {cfg.fl_engine})")
    assert res.accuracies()[-1] > res.accuracies()[0]


if __name__ == "__main__":
    main()
