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
 - dorefa.py      : DoReFa quantize / dequantize / fused q-dq of the uplink
                    codec (CUDA C++, csrc/dorefa.cu; replaces the Pallas
                    quantize_codes_pallas, dequantize_codes_pallas and
                    quantize_dequantize_pallas)
 - flash_decode.py : one-token grouped-query decode attention
                    (CUDA C++, csrc/flash_decode.cu; replaces the Pallas
                    flash_decode_pallas)
 - threefry.py    : jax.random's Threefry uniforms, normals and truncated
                    normals in one launch on the card (CUDA C++,
                    csrc/threefry.cu; its plain version is core/prng.py)
 - ops.py         : the public wrappers (use_pallas: kernel path or oracle)
 - ref.py         : the oracles behind ops.*(use_pallas=False)
 - fma.py         : exactly rounded fused multiply-adds in tensor ops
 - cuda_build.py  : nvcc build into build/ + ctypes loading
"""
