"""Published peaks of the card the benchmark measures: one NVIDIA H100 SXM
(NVIDIA's data sheet, dense rates without sparsity, at the 700 W limit).
"""

H100_SXM = {
    "bf16_flops_per_s": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}

BF16_BYTES = 2
