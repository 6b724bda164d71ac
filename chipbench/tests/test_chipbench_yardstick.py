"""The yardstick against counts made another way: each kernel bound's bytes
by the rule "every input byte read once, every output byte written once"
from the call's tensors, its operations from the mask by brute force, and
the model FLOPs of a train step by hand at a tiny width."""

import itertools
import math
import sys

import pytest

from tiny import ROOT

sys.path.insert(0, str(ROOT))

from chipbench import yardstick  # noqa: E402
from chipbench.metrics import _model_flops  # noqa: E402


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (1, 32, 32, 4096, 4096, 112, True), (4, 16, 8, 4096, 4096, 64, True),
    (2, 4, 2, 7, 5, 16, True), (2, 4, 2, 5, 7, 16, True),
    (1, 2, 1, 6, 9, 8, False)])
def test_flash_bound_reads_and_writes_each_byte_once(b, hq, hkv, sq, skv, d,
                                                     causal):
    flops, nbytes = yardstick.flash_launch(b, hq, hkv, sq, skv, d, causal,
                                           "bfloat16")
    q = o = b * hq * sq * d
    k = v = b * hkv * skv * d
    assert nbytes == 2 * (q + k + v + o)
    if sq * skv <= 100:
        kept = sum(1 for i, j in itertools.product(range(sq), range(skv))
                   if not causal or j <= i)
    else:
        kept = sq * (sq + 1) // 2
    assert flops == 4 * d * b * hq * kept


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(1, 4096, 112, 64, 64, 256),
                                             (2, 300, 4, 16, 16, 128)])
def test_ssd_bound_reads_and_writes_each_byte_once(b, s, h, p, n, chunk):
    flops, nbytes = yardstick.ssd_launch(b, s, h, p, n, chunk)
    q = min(chunk, s)
    nc = math.ceil(s / q)
    rows = b * nc * q                     # the chunked (padded) rows
    inputs = rows * h * p + rows * h + h + 2 * rows * n   # x, dt, A, B, C
    outputs = rows * h * p + b * nc * h * n * p + b * nc * h  # y, states, lf
    assert nbytes == 4 * (inputs + outputs)
    kept = sum(1 for i in range(q) for j in range(q) if j <= i)
    assert flops == b * nc * (kept * 2 * n + h * (kept * 2 * p
                                                  + 2 * q * n * p))


@pytest.mark.parametrize("e,m,k,f", [(1, 4096, 3584, 14336),
                                     (32, 5120, 1024, 512)])
def test_swiglu_bound_reads_and_writes_each_byte_once(e, m, k, f):
    flops, nbytes = yardstick.swiglu_launch(e, m, k, f, "bfloat16")
    assert nbytes == 2 * (e * m * k + 2 * e * k * f + e * m * f)
    assert flops == 2 * (2 * e * m * k * f)


def test_bound_is_the_larger_term():
    card = "NVIDIA H100 80GB HBM3"
    assert yardstick.bound_ms(989e12, 0, "bfloat16", card) == \
        pytest.approx(1e3)
    assert yardstick.bound_ms(0, 3.35e12, "bfloat16", card) == \
        pytest.approx(1e3)
    with pytest.raises(KeyError):
        yardstick.peaks("a card nobody published")


def test_model_flops_against_a_hand_count_hybrid():
    cfg = dict(family="hybrid", n_layers=5, shared_attn_every=2, d_model=8,
               n_heads=2, n_kv_heads=2, head_dim=4, d_ff=16, vocab=10,
               ssm_expand=2, ssm_state=2, ssm_heads=4, ssm_conv=4,
               ssm_chunk=4)
    s = 6
    # mamba layer: in_proj 8 -> 2*16 + 2*2 + 4 = 40; conv over 16 + 4
    # columns, 4 taps; out_proj 16 -> 8; scan at chunk 4: chunks of 4
    # and 2 (padded to 4), 10 kept pairs each
    mamba = 2 * 6 * 8 * 40 + 2 * 6 * 4 * 20 + 2 * 6 * 16 * 8
    scan = (2 * (10 * 2 * 2) + 4 * 2 * (10 * 2 * 4)
            + 2 * (4 * 2 * (2 * 4 * 2 * 4)))
    # attention: q, k, v, o each 8 x 8; 21 causal pairs of 6 positions
    attn = 4 * (2 * 6 * 8 * 8) + 2 * 2 * 4 * 2 * 21
    mlp = 3 * 2 * 6 * 8 * 16
    logits = 2 * 6 * 8 * 10
    forward = 5 * (mamba + scan) + 2 * (attn + mlp) + logits
    assert _model_flops.forward_flops(cfg, s) == forward
    assert _model_flops.train_step_flops(cfg, s, 3) == 9 * forward


def test_model_flops_against_a_hand_count_moe():
    cfg = dict(family="moe", n_layers=2, d_model=8, n_heads=4, n_kv_heads=2,
               head_dim=2, n_experts=4, top_k=2, moe_d_ff=3, vocab=11)
    s = 5
    attn = 2 * 5 * 8 * (8 + 4 + 4) + 2 * 5 * 8 * 8 + 2 * 2 * 2 * 4 * 15
    moe = 2 * 5 * 8 * 4 + 2 * (3 * 2 * 5 * 8 * 3)
    forward = 2 * (attn + moe) + 2 * 5 * 8 * 11
    assert _model_flops.forward_flops(cfg, s) == forward
