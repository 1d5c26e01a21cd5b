"""ctypes binding of the native JSON validator (port of
``icd_tpu/native/jsonlib.py``): ``json.cpp``, built into the mask
library (``native/mask.py``) at the first call."""

import ctypes

from .mask import LIBRARY


def validate(data):
    """Parse and validate a JSON document natively.

    Returns (valid, stats) where stats = {'nodes', 'objects', 'arrays',
    'strings', 'numbers', 'literals', 'numeric_sum'}.
    """
    if isinstance(data, str):
        data = data.encode()
    counts = (ctypes.c_uint64 * 6)()
    total = ctypes.c_double()
    ok = LIBRARY.load().icd_json_validate(data, len(data), counts,
                                          ctypes.byref(total))
    stats = {
        "nodes": counts[0], "objects": counts[1], "arrays": counts[2],
        "strings": counts[3], "numbers": counts[4], "literals": counts[5],
        "numeric_sum": total.value,
    }
    return bool(ok), stats
