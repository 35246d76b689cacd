"""PyTorch/CUDA port of the NOMA federated-learning simulator.

A second package beside the JAX reference ``repro``: it mirrors the
reference's layout (``core/``, ``data/``, ``models/``, ``kernels/``,
``config.py``) and imports ``torch`` and ``numpy``, never ``jax`` or
anything of ``repro``.  The host control plane (channels, scheduling,
MAPEL, rates) is float64 numpy as in the reference; the data plane (client
bank, local SGD, quantization, aggregation, evaluation) runs on the device,
``cuda`` unless the caller passes ``device="cpu"``.
"""
