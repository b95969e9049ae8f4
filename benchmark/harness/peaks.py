"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). The card's own power
limit is printed beside every result (``device.power_limit``)."""

PEAK_BF16_FLOPS = 989e12  # bf16 / fp16 tensor cores
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12  # HBM3
