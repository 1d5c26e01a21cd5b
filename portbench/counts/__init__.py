"""The benchmark's yardstick: operations and bytes counted from shapes,
and the H100's published peaks.

Frozen copies of the program's arithmetic, so that a change to the
program cannot move what it is measured against:

- ``peaks``: NVIDIA's H100 SXM data sheet (dense rates);
- ``serve``: ResNet-101's forward (15.6 GFLOP an image at 224x224, as
  ``icd_tpu_torch/bench.py`` counts it) and the decoders' serving steps;
- ``kernels``: K1's bound (``icd_tpu_torch/k1_bench.k1_bound_ms``) and
  K2's (``icd_tpu_torch/ops/fused_beam.bound_ms``);
- ``train``: one decoder forward + backward
  (``icd_tpu_torch/bench_train.decoder_train_gflops``).

``portbench/tests/test_portbench_counts.py`` holds each copy equal to
its original at the serving and training shapes.
"""
