"""bn_epilogue_ms: device time of K3, the float encoder's eval-mode BN
with its ReLU and residual add (kernels named ``bn_epilogue``), over the
traced block's ``request`` spans. None where no such kernel ran (a
program without K3, or the int8 encoder). Not a share of a roofline:
the later stages' activations stay in L2, so a share of the HBM bound
could read above 100 %."""

import re

KERNEL = re.compile(r"\bbn_epilogue\b")


def read(reading):
    busy_s, n = reading.device_seconds(lambda name: bool(KERNEL.search(name)))
    requests = len(reading.spans_named("request"))
    if n == 0 or requests == 0:
        return None
    return 1e3 * busy_s / requests
