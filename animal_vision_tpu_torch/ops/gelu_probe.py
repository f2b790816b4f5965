"""The GELU probe: what an activation's arithmetic costs on the card.

Counterpart of the TPU probe ``tools/exp_vpu_bf16.py:55``. Each case
applies one function ``reps`` times in a row to every element of a
(rows, cols) float32 or bf16 array (``CASES``: the fused-MSAB degree-11
GELU polynomial, a degree-7 one, a 3x3-like multiply-add stencil over the
rows wrapping inside 512-row slabs, one multiply-add, and the exact
``erff`` GELU of the port's kernels). ``run`` launches the kernel of
``csrc/gelu_probe.cu`` on a CUDA tensor and counts the launch in
``LAUNCHES``; on a CPU tensor it takes the case's plain version. The plain
versions repeat the kernel's arithmetic op for op and round each
operation once, as the kernel does (``fmaf``, ``__hfma2``, ``__hmul2``): a
float32 multiply-add is formed in float64 and rounded to float32; a bf16
one is exact in float64 (a product of two bf16 values has 16 bits) and
goes to bf16 through float32 rounded to odd, so that it rounds once. The
erf GELU computes in float32 per application, as the kernel's bf16 case
does. Nothing on a card path calls them but the comparison with the
kernels, held by ``excess``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from animal_vision_tpu_torch.ops import _build

#: (name, applications per call) of each case, in the kernel's case order;
#: the repetitions of the TPU probe, with gelu_erf at gelu_deg11's
CASES = (("gelu_deg11", 64), ("gelu_deg7", 64), ("madd3x3", 32), ("single_madd", 256), ("gelu_erf", 64))
REPS = dict(CASES)
#: the probe's array, as on the TPU
SHAPE = (4096, 512)
#: madd3x3's rows wrap around inside slabs of this many rows
SLAB = 512
#: the JAX package's _GELU_COEF (ops/fused_msab.py:91)
GELU_COEF = (
    1.413638139e-01, -7.029590887e-02, 5.154378282e-02, -4.045128240e-02,
    3.117513943e-02, -2.321312828e-02, 1.752299849e-02, -1.130712491e-02,
    4.284632193e-03, -2.526916729e-03, 3.580725317e-03, -1.676730979e-03,
)
MADD3 = (1.1, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2)
LAUNCHES = {name: 0 for name, _ in CASES}
#: the kernel against its plain version: float32 within F32_TOL of
#: min(1, max |y|) (so at most 1e-5 absolute, and relative where repeated
#: GELUs shrink every value toward 0), madd3x3 of max |y| (its values grow
#: 5.5^32-fold); bf16 within BF16_REL_TOL of each |y|, two bf16 steps: both
#: sides round each operation once, so a difference is the kernel's
F32_TOL = 1e-5
BF16_REL_TOL = 2.0 ** -6


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("gelu_probe")
    if lib.av_gelu_probe.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.av_gelu_probe.argtypes = [p, p, i, i, i, i, i, p]
        lib.av_gelu_probe.restype = ctypes.c_int
    return lib


def to_bf16_once(s: torch.Tensor) -> torch.Tensor:
    """float64 -> bf16 rounded once to nearest even. PyTorch converts
    through float32 and rounds twice; rounding to float32 toward zero and
    setting the last bit where inexact (round to odd) keeps the information
    that the second rounding needs."""
    t = s.to(torch.float32)
    t = torch.where(t.to(torch.float64).abs() > s.abs(), torch.nextafter(t, torch.zeros_like(t)), t)
    odd = (t.to(torch.float64) != s).to(torch.int32)
    return (t.view(torch.int32) | odd).view(torch.float32).to(torch.bfloat16)


class _Arith:
    """The kernel's operations in one type: ``c`` a constant as that type
    rounds it, ``fma``, ``mul``, ``clamp``."""

    def __init__(self, dtype: torch.dtype):
        self.bf16 = dtype == torch.bfloat16

    def c(self, v: float) -> float:
        return float(torch.tensor(v, dtype=torch.bfloat16)) if self.bf16 else float(torch.tensor(v, dtype=torch.float32))

    def fma(self, a, b, d):
        # exact or rounded once in float64, then once to the working type
        f = lambda t: t.to(torch.float64) if isinstance(t, torch.Tensor) else t  # noqa: E731
        s = f(a) * f(b) + f(d)
        return to_bf16_once(s) if self.bf16 else s.to(torch.float32)

    def mul(self, a, b):
        if self.bf16:
            return (a.float() * (b.float() if isinstance(b, torch.Tensor) else b)).to(torch.bfloat16)
        return a * b

    def clamp(self, x, lo: float, hi: float):
        return torch.clamp(x, self.c(lo), self.c(hi))


def _gelu_poly(x: torch.Tensor, ar: _Arith, clip: float, inv: float, even: tuple, odd: tuple) -> torch.Tensor:
    c = ar.c
    xc = ar.clamp(x, -clip, clip)
    v = ar.fma(ar.mul(xc, xc), c(inv), c(-1.0))
    w = ar.mul(v, v)
    ge, go = ar.fma(w, c(even[0]), c(even[1])), ar.fma(w, c(odd[0]), c(odd[1]))
    for ce, co in zip(even[2:], odd[2:]):
        ge, go = ar.fma(ge, w, c(ce)), ar.fma(go, w, c(co))
    return ar.mul(x, ar.fma(xc, ar.fma(v, go, ge), c(0.5)))


def gelu_deg11_once(x: torch.Tensor) -> torch.Tensor:
    """One application of the degree-11 polynomial (the JAX ``_gelu``)."""
    k = GELU_COEF
    return _gelu_poly(x, _Arith(x.dtype), 5.0, 1.0 / 12.5, (k[10], k[8], k[6], k[4], k[2], k[0]),
                      (k[11], k[9], k[7], k[5], k[3], k[1]))


def gelu_deg7_once(x: torch.Tensor) -> torch.Tensor:
    """One application of the degree-7 placeholder (``_gelu7`` of the TPU
    probe)."""
    k = GELU_COEF
    return _gelu_poly(x, _Arith(x.dtype), 4.0, 1.0 / 8.0, (k[4], k[2], k[0]), (k[5], k[3], k[1]))


def madd3x3_once(y: torch.Tensor) -> torch.Tensor:
    """Nine multiply-adds of each row and its two neighbours, the rows
    wrapping inside each 512-row slab (``madd3`` of the TPU probe), left to
    right."""
    ar = _Arith(y.dtype)
    rows, cols = y.shape
    slabs = y.reshape(rows // SLAB, SLAB, cols)
    a = torch.roll(slabs, -1, dims=1).reshape(rows, cols)
    b = torch.roll(slabs, 1, dims=1).reshape(rows, cols)
    m = [ar.c(v) for v in MADD3]
    acc = ar.mul(y, m[0])
    for t, mk in zip((a, b, y, a, b, y, a, b), m[1:]):
        acc = ar.fma(t, mk, acc)
    return acc


def single_madd_once(x: torch.Tensor) -> torch.Tensor:
    ar = _Arith(x.dtype)
    return ar.fma(x, ar.c(1.0001), ar.c(0.0001))


def gelu_erf_once(x: torch.Tensor) -> torch.Tensor:
    """The port's exact GELU, 0.5 x (1 + erf(x / sqrt 2)), in float32."""
    f = x.float()
    return (0.5 * f * (1.0 + torch.erf(f * (1.0 / math.sqrt(2.0))))).to(x.dtype)


_ONCE = {"gelu_deg11": gelu_deg11_once, "gelu_deg7": gelu_deg7_once, "madd3x3": madd3x3_once,
         "single_madd": single_madd_once, "gelu_erf": gelu_erf_once}


def _check(case: str, x: torch.Tensor) -> None:
    if case not in REPS:
        raise ValueError(f"unknown probe case {case!r}; cases: {list(REPS)}")
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"the probe takes a contiguous 2-D float32 or bf16 array, got {x.dtype} {tuple(x.shape)}")
    if case == "madd3x3" and (x.shape[0] % SLAB or x.shape[1] % 16):
        raise ValueError(f"madd3x3 needs rows a multiple of {SLAB} and columns of 16, got {tuple(x.shape)}")
    if x.numel() * x.element_size() % 16:
        raise ValueError(f"the probe needs a multiple of 16 bytes, got {tuple(x.shape)} {x.dtype}")


def excess(case: str, got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, the largest ratio of a difference to its bar): the
    kernel's ``got`` against the plain ``want`` passes when the ratio is at
    most 1 (infinite where ``got`` is not finite)."""
    g, w = got.to(torch.float64), want.to(torch.float64)
    d = (g - w).abs()
    err = d.max().item()
    if not torch.isfinite(g).all().item():
        return err, math.inf
    if want.dtype == torch.bfloat16:
        bar = BF16_REL_TOL * w.abs()
    else:
        top = w.abs().max().item()
        bar = torch.full_like(w, F32_TOL * (top if case == "madd3x3" else min(1.0, top)))
    ratio = torch.where(d == 0, torch.zeros_like(d), d / bar)
    return err, ratio.max().item()


def run_plain(case: str, x: torch.Tensor, reps: int | None = None) -> torch.Tensor:
    """``case`` applied ``reps`` times (its ``REPS`` when None), in PyTorch."""
    _check(case, x)
    once = _ONCE[case]
    for _ in range(REPS[case] if reps is None else reps):
        x = once(x)
    return x


def run(case: str, x: torch.Tensor, reps: int | None = None) -> torch.Tensor:
    """``case`` applied ``reps`` times (its ``REPS`` when None): the kernel
    on a CUDA tensor (one launch, counted), the plain version on a CPU
    one."""
    _check(case, x)
    if not x.is_cuda:
        return run_plain(case, x, reps)
    y = torch.empty_like(x)
    lib = _lib()
    which = [name for name, _ in CASES].index(case)
    _build.launch(lib, "av_gelu_probe", x.device, x.data_ptr(), y.data_ptr(), which, int(x.dtype == torch.bfloat16),
                  x.shape[0], x.shape[1], REPS[case] if reps is None else reps)
    LAUNCHES[case] += 1
    return y
