"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit), as `chip_smoke.py` (commit 0fe27a5) states
them."""

#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: float32 rate outside the tensor cores, operations/s
F32_OPS_PER_S = 67e12
