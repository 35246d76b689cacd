"""The paper's contribution, ported: NOMA FL scheduling, power allocation,
adaptive compression and the FedAvg runtime.

 - channel.py      : cell + fading channel model             (paper §II-A)
 - rates.py        : batched SIC rate engine, float64 numpy  (paper Eq. 2-4)
 - rates_device.py : the same engine on the device + the device-resident
                     lazy GWMIN greedy                       (paper §III-A)
 - power.py        : MAPEL polyblock power allocation        (paper §III-C)
 - scheduling.py   : policy registry + lazy GWMIN MWIS greedy (paper §III-A)
 - quantization.py : DoReFa adaptive quantization, torch     (paper §II-B)
 - compression.py  : packed tree codec, top-k plan and mask  (paper Alg. 1)
 - tree.py         : nested-dict trees in JAX's leaf order
 - ota.py          : uplink-combination rules
 - fl_engine.py    : batched round engine on the device      (paper Alg. 1)
 - fl.py           : FedAvg over the simulated NOMA cell     (paper §IV)
"""
