"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates,
no sparsity, at the 700 W power limit)."""

TF32_FLOPS = 495e12  # tensor cores on float32 inputs: the highest rate for f32 products
BF16_FLOPS = 989e12  # tensor cores, bf16 and fp16
F32_FLOPS = 67e12    # float32 on the CUDA cores
HBM_BYTES = 3.35e12  # device memory, bytes/s
