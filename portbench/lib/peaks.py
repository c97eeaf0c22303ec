"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). The benchmark's programs run
float32 with TF32 off, so their matrix products run outside the tensor
cores: the float32 peak is 67 TFLOP/s. A card set below 700 W runs slower
under load; every run prints the card's power limit beside its numbers."""

FP32_FLOPS = 67e12          # float32, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # 80 GB HBM3
