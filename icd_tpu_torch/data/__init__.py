"""The data modules ``beam_eval`` needs, copied from ``icd_tpu/data``."""
