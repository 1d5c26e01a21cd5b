"""The frozen copies in portbench/counts equal the program's arithmetic
at today's serving and training shapes: the one place portbench reads
those functions, to show that the copies were faithful when made."""

import pytest
import torch

from portbench.counts import kernels, serve, train

B, K, P, D, A, H, E, V = 64, 5, 196, 2048, 512, 512, 512, 10000


def _meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_bound_is_k1_bench(dtype):
    from icd_tpu_torch.k1_bench import k1_bound_ms

    args = (_meta(B, P, D, dtype=dtype), _meta(B, P, A, dtype=dtype),
            _meta(B * K, H, dtype=dtype), _meta(A, H, dtype=dtype),
            _meta(A, dtype=dtype), _meta(A, dtype=dtype),
            _meta(1, dtype=dtype), _meta(D, H, dtype=dtype),
            _meta(D, dtype=dtype))
    out = (_meta(B * K, D, dtype=dtype),
           _meta(B * K, P, dtype=torch.float32))
    mine, theirs = (kernels.k1_bound_ms(B, K, P, D, A, H, dtype.itemsize),
                    k1_bound_ms(args, out))
    assert mine[1] == theirs[1]
    assert mine[0] == pytest.approx(theirs[0], rel=1e-12)


@pytest.mark.parametrize("steps", [1, 18, 51])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_bound_is_fused_beam(steps, dtype):
    from icd_tpu_torch.ops.fused_beam import bound_ms

    m = lambda *s: _meta(*s, dtype=dtype)  # noqa: E731
    ops = dict(enc=m(B, P, D), att_enc=m(B, P, A), h0=m(B, H), c0=m(B, H),
               emb=m(V, E), wd=m(A, H), bd=m(A), wf=m(A), bf=m(1),
               wg=m(D, H), bg=m(D), wi=m(4 * H, E + D), wh=m(4 * H, H),
               b_sum=_meta(4 * H, dtype=torch.float32), wfc=m(V, H),
               bfc=m(V))
    mine = kernels.k2_bound_ms(B, K, P, D, A, H, E, V, steps, dtype.itemsize)
    theirs = bound_ms(ops, K, steps)
    assert mine[1] == theirs[1]
    assert mine[0] == pytest.approx(theirs[0], rel=1e-12)


@pytest.mark.parametrize("t", [10, 21, 25, 52])
def test_train_count_is_bench_train(t):
    from icd_tpu_torch.bench_train import decoder_train_gflops

    assert train.attention_decoder_train_gflop(32, t, P, D, A, H, E, V) == \
        pytest.approx(decoder_train_gflops(True, b=32, t=t), rel=1e-12)


def test_resnet101_is_the_bench_count():
    from icd_tpu_torch.bench import RESNET101_GFLOP

    got = serve.resnet_gflop((3, 4, 23, 3), (64, 128, 256, 512), 224)
    assert got == pytest.approx(RESNET101_GFLOP, rel=1e-3)


def test_serving_step_counts_k2s_step():
    """A beam step's products are the ones K2's bound counts a step."""
    step = serve.attention_step_gflop(B * K, P, D, A, H, E, V)
    flops = (2 * B * K * H * (A + D) + 4 * B * K * P * A
             + 2 * B * K * P * D + 2 * B * K * (E + D + H) * 4 * H
             + 2 * B * K * H * V)
    assert step * 1e9 == pytest.approx(flops, rel=1e-12)
