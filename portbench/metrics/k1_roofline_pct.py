"""k1_roofline_pct: K1's bound (``counts.kernels.k1_bound_ms`` at the
serving shapes) times its launches in the traced block, over the device
time of its two kernels, ``k1_gate`` and ``k1_attention``."""

from ..counts import kernels
from ..weights import encoder_dim
from ._common import elem_bytes


def read(reading):
    att_s, n = reading.device_seconds(lambda name: "k1_attention" in name)
    gate_s, _ = reading.device_seconds(lambda name: "k1_gate" in name)
    if n == 0 or n != reading.counters["k1_launches"]:
        return None
    cfg, tr = reading.config, reading.traffic
    bound_ms, _ = kernels.k1_bound_ms(
        tr["batch"], cfg["beam_size"], cfg["grid"] ** 2, encoder_dim(cfg),
        cfg["attention_dim"], cfg["decoder_dim"], elem_bytes(tr))
    return 100.0 * n * bound_ms * 1e-3 / (att_s + gate_s)
