"""int8_epilogue_ms: device time of K4, the static-int8 encoder's
epilogue after each int8 convolution (dequant affine, residual, ReLU,
requantize; kernels named ``int8_epilogue``), over the traced block's
``request`` spans, per request. None where no such kernel ran (a
program without K4, or the float encoder). Not a share of a roofline:
the later stages' int32 sums stay in the 50 MB L2, so a share of the
HBM bound could read above 100 %."""

import re

KERNEL = re.compile(r"\bint8_epilogue\b")


def read(reading):
    busy_s, n = reading.device_seconds(lambda name: bool(KERNEL.search(name)))
    requests = len(reading.spans_named("request"))
    if n == 0 or requests == 0:
        return None
    return 1e3 * busy_s / requests
