"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989.4e12          # tensor cores, bf16 and fp16
FP32_FLOPS = 67e12             # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12      # HBM3
POWER_LIMIT_W = 700.0          # the limit these rates assume
