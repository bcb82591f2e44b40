"""Published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
sheet, dense rates): float32 outside the tensor cores (the port runs
float32 with TF32 off), bf16 products on the tensor cores, and HBM3."""

FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
