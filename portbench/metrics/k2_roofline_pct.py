"""k2_roofline_pct: K2's bound (``counts.kernels.k2_bound_ms`` at the
steps each traced search ran) summed over the searches, over the device
time of its kernel, ``fused_beam``."""

import re

from ..counts import kernels
from ..weights import encoder_dim
from ._common import elem_bytes

KERNEL = re.compile(r"\bfused_beam\b")


def read(reading):
    busy_s, n = reading.device_seconds(lambda name: bool(KERNEL.search(name)))
    steps = reading.counters["traced_steps"]
    if n == 0 or n != reading.counters["k2_launches"] or n != len(steps):
        return None
    cfg, tr = reading.config, reading.traffic
    bound_ms = sum(kernels.k2_bound_ms(
        tr["batch"], cfg["beam_size"], cfg["grid"] ** 2, encoder_dim(cfg),
        cfg["attention_dim"], cfg["decoder_dim"], cfg["embed_size"],
        cfg["vocab_size"], s, elem_bytes(tr))[0] for s in steps)
    return 100.0 * bound_ms * 1e-3 / busy_s
