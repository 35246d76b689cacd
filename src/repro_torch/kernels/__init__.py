"""Hand-written Hopper kernels of the port, each beside its plain version.

 - aggregate.py   : fused dequant + weighted FedAvg aggregation
                    (CUDA C++, csrc/aggregate.cu; replaces the Pallas
                    weighted_aggregate_pallas)
 - ota_aggregate.py : over-the-air receiver reduction, noise + weighted sum
                    (CUDA C++, csrc/ota_aggregate.cu; replaces the Pallas
                    ota_aggregate_pallas)
 - sic_rates.py   : weighted SIC sum-rate vertex scorer of the MWIS greedy
                    (CUDA C++, csrc/sic_rates.cu; replaces the Pallas
                    sic_weighted_rates_pallas)
 - cuda_build.py  : nvcc build into build/ + ctypes loading
"""
