"""The GELU probe's plain versions (``ops/gelu_probe.py``), on the CPU.

The degree-11 polynomial against the JAX package's ``_gelu``
(``ops/fused_msab.py:98``) in float32, within 1e-6 after one and after 64
applications (the same operations in the same order). The degree-7
placeholder, the 3x3 stencil and the single multiply-add against NumPy
transcriptions of ``tools/exp_vpu_bf16.py`` (not imported: it writes a JAX
cache at import): the JAX and NumPy versions round a multiply and an add
apart where the probe's multiply-add rounds once, so they agree within
1e-6 (of max |y| for the growing stencil). The erf GELU against
``torch.nn.functional.gelu``. The plain bf16 multiply-add and its
conversion against exact rationals rounded once; the bars of ``excess``.
The kernels themselves run on the card only
(``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.ops.fused_msab import _GELU_COEF, _gelu
from animal_vision_tpu_torch.ops import _build
from animal_vision_tpu_torch.ops import gelu_probe as P


def _x(shape=(1024, 64), seed=0):
    return (np.random.default_rng(seed).random(shape, dtype=np.float32) * 4 - 2).astype(np.float32)


def _gelu7_np(x):
    C = np.asarray(_GELU_COEF, np.float32)
    xc = np.clip(x, np.float32(-4.0), np.float32(4.0))
    v = xc * xc * np.float32(1.0 / 8.0) - np.float32(1.0)
    w = v * v
    ge = (C[4] * w + C[2]) * w + C[0]
    go = (C[5] * w + C[3]) * w + C[1]
    return x * (np.float32(0.5) + xc * (ge + v * go))


def _madd3_np(y):
    rows, cols = y.shape
    s = y.reshape(rows // 512, 512, cols)
    a = np.concatenate([s[:, 1:], s[:, :1]], axis=1).reshape(rows, cols)
    b = np.concatenate([s[:, -1:], s[:, :-1]], axis=1).reshape(rows, cols)
    f = np.float32
    return (y * f(1.1) + a * f(0.9) + b * f(0.8) + y * f(0.7) + a * f(0.6) + b * f(0.5)
            + y * f(0.4) + a * f(0.3) + b * f(0.2))


def test_coefficients_are_the_jax_ones():
    assert P.GELU_COEF == tuple(_GELU_COEF)


@pytest.mark.parametrize("reps", [1, 64])
def test_gelu_deg11_vs_jax(reps):
    x = _x()
    want = jnp.asarray(x)
    for _ in range(reps):
        want = _gelu(want)
    got = P.run_plain("gelu_deg11", torch.from_numpy(x), reps)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_gelu_deg11_over_its_range():
    """One application on [-8, 8], beyond the clip at 5, against JAX; and
    within 2e-5 of the exact GELU (the JAX comment's 1.66e-5)."""
    x = np.linspace(-8.0, 8.0, 1 << 14, dtype=np.float32).reshape(-1, 64)
    got = P.run_plain("gelu_deg11", torch.from_numpy(x), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(_gelu(jnp.asarray(x))), rtol=0, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x).double()).float()
    assert (got - exact).abs().max().item() < 2e-5


def test_gelu_deg7_vs_numpy():
    x = _x(seed=1)
    want = x
    for _ in range(64):
        want = _gelu7_np(want)
    np.testing.assert_allclose(P.run_plain("gelu_deg7", torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-6)


def test_madd3x3_vs_numpy():
    """32 applications grow the values 5.5^32-fold (the nine coefficients
    sum to 5.5): held relative to max |y|."""
    x = _x((1024, 32), seed=2)
    want = x
    for _ in range(32):
        want = _madd3_np(want)
    got = P.run_plain("madd3x3", torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_single_madd_and_gelu_erf():
    x = _x(seed=3)
    want = x
    for _ in range(256):  # a multiply-add that rounds once, as the kernel's fmaf
        want = (want.astype(np.float64) * np.float32(1.0001) + np.float32(0.0001)).astype(np.float32)
    np.testing.assert_allclose(P.run_plain("single_madd", torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-6)
    got = P.run_plain("gelu_erf", torch.from_numpy(x), 1)
    np.testing.assert_allclose(got.numpy(), torch.nn.functional.gelu(torch.from_numpy(x)).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", [name for name, _ in P.CASES])
def test_bf16_plain_follows_float32(case):
    """The bf16 plain versions round to bf16 after every multiply-add:
    after one application each is within a few bf16 steps of the float32
    version (the stencil relative to its size)."""
    x = torch.from_numpy(_x((512, 64), seed=4)).to(torch.bfloat16)
    got = P.run_plain(case, x, 1)
    want = P.run_plain(case, x.float(), 1)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max().item() <= 4 * 2.0 ** -8 * max(1.0, want.abs().max().item())


def test_run_on_the_cpu_takes_the_plain_version():
    _build.reset_launches()
    x = torch.from_numpy(_x((512, 16), seed=5))
    for case, _ in P.CASES:
        assert torch.equal(P.run(case, x, 3), P.run_plain(case, x, 3))
    assert set(_build.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match="madd3x3 needs"):
        P.run("madd3x3", torch.zeros(100, 16))
    with pytest.raises(ValueError, match="unknown probe case"):
        P.run("tanh", x)
    with pytest.raises(ValueError, match="2-D float32 or bf16"):
        P.run("gelu_erf", torch.zeros(4, 4, dtype=torch.float64))


def _bf16_rne(q):
    """A rational rounded once to the nearest bf16 value, ties to even."""
    from fractions import Fraction

    if q == 0:
        return 0.0
    e = abs(q.numerator).bit_length() - q.denominator.bit_length()
    if Fraction(2) ** e > abs(q):
        e -= 1
    ulp = Fraction(2) ** (e - 7)
    m = q / ulp
    n = m.numerator // m.denominator
    rest = m - n
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and n % 2):
        n += 1
    return float(n * ulp)


def test_to_bf16_once_rounds_once():
    """float64 -> bf16 as one rounding: where PyTorch's own conversion
    rounds through float32 and lands on the even side of a tie it made."""
    from fractions import Fraction

    just_above_tie = 1.0 + 2.0 ** -8 + 2.0 ** -30
    assert torch.tensor(just_above_tie, dtype=torch.float64).to(torch.bfloat16).item() == 1.0
    assert P.to_bf16_once(torch.tensor([just_above_tie], dtype=torch.float64)).item() == 1.0 + 2.0 ** -7
    rng = np.random.default_rng(6)
    s = rng.standard_normal(4000) * np.exp2(rng.integers(-20, 20, 4000))
    ties = (rng.integers(128, 256, 200) * 2 + 1) * 2.0 ** -9 + rng.choice([-1, 1], 200) * 2.0 ** -40
    s = np.concatenate([s, ties, -ties, [0.0, 1.0, -3.5]])
    got = P.to_bf16_once(torch.from_numpy(s)).double().numpy()
    np.testing.assert_array_equal(got, [_bf16_rne(Fraction(v)) for v in s])


def test_bf16_multiply_add_rounds_once():
    """The plain bf16 multiply-add against the exact product and sum rounded
    once, as __hfma2 rounds."""
    from fractions import Fraction

    rng = np.random.default_rng(7)
    a, b, d = (torch.from_numpy(rng.standard_normal(3000) * np.exp2(rng.integers(-12, 12, 3000))).to(torch.bfloat16)
               for _ in range(3))
    got = P._Arith(torch.bfloat16).fma(a, b, d)
    assert got.dtype == torch.bfloat16
    want = [_bf16_rne(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a.double().tolist(), b.double().tolist(), d.double().tolist())]
    np.testing.assert_array_equal(got.double().numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_excess_bars(dtype):
    """The bars the kernels are held to: a wrong kernel fails them even
    where repeated GELUs leave values near 1e-15."""
    x = torch.from_numpy(_x((512, 16), seed=8)).to(dtype)
    want = P.run_plain("gelu_deg11", x)
    assert want.float().abs().max().item() < 1e-10
    assert P.excess("gelu_deg11", want, want) == (0.0, 0.0)
    assert P.excess("gelu_deg11", torch.zeros_like(want), want)[1] > 1
    assert P.excess("gelu_deg11", want * 1.1, want)[1] > 1
    bad = want.clone()
    bad[0, 0] = float("nan")
    assert P.excess("gelu_deg11", bad, want)[1] == float("inf")
    stencil = P.run_plain("madd3x3", x)
    if dtype == torch.float32:  # relative to max |y|: its values grow 5.5^32-fold
        nudge = P.F32_TOL / 2 * stencil.abs().max().item()
        assert P.excess("madd3x3", stencil + nudge, stencil)[1] <= 1
    assert P.excess("madd3x3", stencil * 2, stencil)[1] > 1
