"""The benchmark of icd_tpu_torch (see README.md)."""
