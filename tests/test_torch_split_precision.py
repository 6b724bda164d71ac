"""The arithmetic of the wgmma SSD and mLSTM kernels, settled on the CPU.

Both kernels run their matrix products on the tf32 tensor cores as
3xTF32: each fp32 operand a is split into hi = a rounded to tf32 (round
to nearest, ties away from zero) and lo = a - hi rounded to tf32 again,
and a product is lo_a hi_b + hi_a lo_b + hi_a hi_b, summed in fp32
(``kernels/csrc/hopper.cuh``: ``split_tf32``).  Here that split is
emulated with int32 bit operations and run through the kernels' plain
twins' own products (their ``product`` hook), on the kernel tests' cases
and on reduced-batch slices of the full-width shapes; the result must
meet the kernel tests' rtol = atol = 1e-4 against the twin in fp32, and a
single tf32 pass (hi_a hi_b) must not.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mlstm_scan import kernel as M  # noqa: E402
from repro_torch.kernels.mlstm_scan.ops import \
    chunk_inputs as mlstm_chunk_inputs  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as S  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import \
    chunk_inputs as ssd_chunk_inputs  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_kernels.py:105,151

SSD_CASES = [
    # (b, s, h, p, n, chunk): tests/test_kernels.py, then zamba2-7b's mamba
    # layer (112 heads, p = n = 64, Q = 256) at B = 1 and two chunks
    (1, 64, 2, 16, 16, 32),
    (2, 128, 4, 32, 64, 64),
    (1, 100, 2, 16, 16, 32),
    (1, 32, 1, 64, 32, 32),
    (1, 512, 112, 64, 64, 256),
]
MLSTM_CASES = [
    # (b, s, h, p, chunk): tests/test_kernels.py:130, then xlstm-1.3b's
    # chunk (Q = 256, 4 heads) at B = 1, one chunk, p = 64 and p = 1024
    (1, 64, 2, 16, 32),
    (2, 128, 4, 32, 64),
    (1, 100, 2, 16, 32),
    (1, 32, 1, 64, 32),
    (1, 256, 4, 64, 256),
    (1, 256, 4, 1024, 256),
]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest tf32 value (ties away from zero), as PTX's
    ``cvt.rna.tf32.f32``: add half of the 13 dropped mantissa bits to the
    magnitude, then clear them (the sign bit is not touched for finite
    inputs of the size used here)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product_3xtf32(eq, a, b):
    """The kernels' product: three tf32 passes into one fp32 sum."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def product_1xtf32(eq, a, b):
    """One tf32 pass: what a plain tf32 wgmma computes."""
    return torch.einsum(eq, tf32_rna(a), tf32_rna(b))


def _worst(got, want):
    """max over the outputs of |got - want| / (atol + rtol |want|): at most
    1 means within the tolerance."""
    return max(((g - w).abs() / (TOL["atol"] + TOL["rtol"] * w.abs()))
               .max().item() for g, w in zip(got, want))


def _ssd_chunks(case, seed=0):
    b, s, h, p, n, chunk = case
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p), np.float32))
    dt = torch.from_numpy(
        np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32))
    A_log = torch.from_numpy((rng.standard_normal(h) * 0.5)
                             .astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((b, s, n), np.float32))
    C = torch.from_numpy(rng.standard_normal((b, s, n), np.float32))
    xc, dtc, Bc, Cc = ssd_chunk_inputs(x, dt, B, C, chunk)
    return xc, dtc, A_log, Bc, Cc


def _mlstm_chunks(case, seed=0):
    """tests/test_kernels.py's distributions: q, k, v ~ N(0, 1), ig ~ 2 N,
    fg ~ 2 N + 2."""
    b, s, h, p, chunk = case
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, p),
                                                    np.float32))
               for _ in range(3))
    ig, fg = (torch.from_numpy((rng.standard_normal((b, s, h)) * 2 + mean)
                               .astype(np.float32)) for mean in (0.0, 2.0))
    return (*mlstm_chunk_inputs(q, k, v, ig, fg, chunk), 1 / math.sqrt(p))


def test_tf32_rounding_emulation():
    """Round to nearest with ties away from zero at 10 mantissa bits; the
    split represents a to about 2^-22 of |a|."""
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 2 ** -12, -(one + 2 ** -11),
                      one + 3 * 2 ** -11, 3.0], dtype=torch.float32)
    want = [one + 2 ** -10, one, -(one + 2 ** -10), one + 2 ** -9, 3.0]
    assert tf32_rna(x).tolist() == want
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(
        10_000, np.float32))
    hi, lo = split_tf32(a)
    assert (tf32_rna(hi) == hi).all() and (tf32_rna(lo) == lo).all()
    assert ((a - hi).abs() <= a.abs() * 2 ** -11).all()
    assert ((a - hi - lo).abs() <= a.abs() * 2 ** -21).all()


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_3xtf32_meets_the_kernel_tolerance(case):
    ins = _ssd_chunks(case)
    want = S.ssd_chunk_plain(*ins)
    got = S.ssd_chunk_plain(*ins, product=product_3xtf32)
    assert _worst(got, want) <= 0.5


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_single_tf32_pass_misses_it(case):
    ins = _ssd_chunks(case)
    want = S.ssd_chunk_plain(*ins)
    got = S.ssd_chunk_plain(*ins, product=product_1xtf32)
    assert _worst(got, want) > 2


@pytest.mark.parametrize("case", MLSTM_CASES)
def test_mlstm_3xtf32_meets_the_kernel_tolerance(case):
    ins = _mlstm_chunks(case)
    want = M.mlstm_chunk_plain(*ins)
    got = M.mlstm_chunk_plain(*ins, product=product_3xtf32)
    assert _worst(got, want) <= 0.5


@pytest.mark.parametrize("case", MLSTM_CASES)
def test_mlstm_single_tf32_pass_misses_it(case):
    ins = _mlstm_chunks(case)
    want = M.mlstm_chunk_plain(*ins)
    got = M.mlstm_chunk_plain(*ins, product=product_1xtf32)
    assert _worst(got, want) > 2
