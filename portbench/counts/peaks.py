"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
F32_FLOP_PER_S = 67e12  # outside the tensor cores (TF32 off)

BY_DTYPE = {"bf16": BF16_FLOP_PER_S, "int8": INT8_OP_PER_S,
            "f32": F32_FLOP_PER_S}
