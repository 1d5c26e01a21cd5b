"""Least times of the port's two hand-written kernels on an H100, from
shapes: frozen copies of ``icd_tpu_torch/k1_bench.k1_bound_ms`` (K1)
and ``icd_tpu_torch/ops/fused_beam.bound_ms`` (K2). Each input byte is
read once and each output byte written once at the HBM rate; the
operations at the peak of the inputs' type; the larger of the two is
the bound. Each returns (ms, "bytes" or "operations")."""

from . import peaks


def _bound(nbytes, flops, elem_bytes):
    peak = peaks.BF16_FLOP_PER_S if elem_bytes == 2 else peaks.F32_FLOP_PER_S
    by_bytes, by_ops = nbytes / peaks.HBM_BYTES_PER_S, flops / peak
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def k1_bound_ms(b, k, p, d, a, h, elem_bytes):
    """One K1 call on ``b`` images of ``k`` rows each: inputs enc
    (B, P, D), att_enc (B, P, A), h (rows, H), dec_att (A, H) + (A,),
    full_att (A,) + (1,), f_beta (D, H) + (D,) in the grid's type;
    outputs the gated context (rows, D) in that type and alpha
    (rows, P) in f32."""
    rows = b * k
    inputs = (b * p * d + b * p * a + rows * h + a * h + a + a + 1
              + d * h + d)
    nbytes = inputs * elem_bytes + rows * d * elem_bytes + rows * p * 4
    flops = 2 * rows * h * (a + d) + 4 * rows * p * a + 2 * rows * p * d
    return _bound(nbytes, flops, elem_bytes)


def k2_bound_ms(b, k, p, d, a, h, e, v, steps, elem_bytes):
    """One K2 search of ``steps`` steps: enc and att_enc read once a step,
    the weights, h0 and c0 once, of the embedding only the rows gathered
    (one a beam a step, at most the table), the raw alphas (f32) written
    once a step; the step's products at the grid type's peak. The
    summed LSTM bias is f32."""
    rows = b * k
    per_step = (b * p * d + b * p * a) * elem_bytes
    weights = (b * h + b * h  # h0, c0
               + a * h + a + a + 1  # dec_att, full_att
               + d * h + d  # f_beta
               + 4 * h * (e + d) + 4 * h * h  # LSTM input and hidden
               + v * h + v)  # fc
    once = weights * elem_bytes + 4 * h * 4  # + the f32 bias sum
    gathered = min(v, rows * steps) * e * elem_bytes
    nbytes = steps * (per_step + rows * p * 4) + once + gathered
    flops = steps * (2 * rows * h * (a + d) + 4 * rows * p * a
                     + 2 * rows * p * d + 2 * rows * (e + d + h) * 4 * h
                     + 2 * rows * h * v)
    return _bound(nbytes, flops, elem_bytes)
