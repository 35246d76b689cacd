"""Hand-written Hopper kernels of the port, each beside its plain version.

 - aggregate.py   : fused dequant + weighted FedAvg aggregation
                    (CUDA C++, csrc/aggregate.cu; replaces the Pallas
                    weighted_aggregate_pallas)
 - cuda_build.py  : nvcc build into build/ + ctypes loading
"""
