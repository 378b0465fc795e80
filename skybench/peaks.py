"""Published peaks of the card the benchmark runs on.

NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet; dense rates, without
sparsity; at the full 700 W power limit): the benchmark's own copy, so
that no change to the program can move a roofline's yardstick. Every
type is listed, for the readers that later cells add.
"""

HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12          # CUDA cores (67e12 on the FP64 tensor cores)
FP32_FLOPS = 67e12
TF32_FLOPS = 494.7e12
BF16_FLOPS = 989e12
FP8_FLOPS = 1979e12
INT8_OPS = 1979e12
POWER_LIMIT_W = 700.0
