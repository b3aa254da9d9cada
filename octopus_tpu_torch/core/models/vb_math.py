"""Float32 arithmetic for the VB engines that rounds alike on the CPU and on
a CUDA card.

The callers read the VB evidences far into their tails: a cancer call's PP
is 1 minus a posterior mass near 1, a difference that at PP ~ 130 is below
the float64 resolution of the evidence sums, so one ELBO that differs in
its last bit can move a record. torch's own exp, log, digamma and lgamma
round differently on the two devices (different math libraries), and so do
its reductions (different summation orders). The functions here use only
operations that IEEE 754 rounds exactly and that both devices implement
so: float32 +, -, *, /, comparisons, round and bit views. Reductions add in
a fixed order: one element after another over a short axis, a pairwise tree
over a long one. So an evaluation gives the same bits wherever it runs and
however its genotype rows are chunked.

Each function matches its float64 value to a few float32 ulps on the
domain the engines use: fexp on x <= 0 (and returns 0 below -86), flog,
flgamma and fdigamma on positive normal floats.
"""

from __future__ import annotations

import math

import torch

_LOG2E = 1.4426950408889634
# ln 2 split so that n * _LN2_HI is exact for |n| < 2^8
_LN2_HI = 0.693145751953125
_LN2_LO = 1.4286068203094173e-06
_EXP_COEFFS = tuple(1.0 / math.factorial(k) for k in range(8))   # 1/k!
_SQRT2 = math.sqrt(2.0)
# below this exp would leave the normal float32 range: those are 0
_EXP_MIN = -86.0


def fsum(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """Sum over `dim` in a fixed order: in sequence up to 8 elements, else
    a pairwise tree over the length padded with zeros to a power of two."""
    dim = dim % x.dim()
    n = x.shape[dim]
    if n == 0:
        return x.sum(dim, keepdim=keepdim)
    if n <= 8:
        acc = x.narrow(dim, 0, 1)
        for i in range(1, n):
            acc = acc + x.narrow(dim, i, 1)
    else:
        size = 1 << (n - 1).bit_length()
        if size != n:
            pad = list(x.shape)
            pad[dim] = size - n
            x = torch.cat([x, x.new_zeros(pad)], dim)
        while size > 1:
            size //= 2
            x = x.narrow(dim, 0, size) + x.narrow(dim, size, size)
        acc = x
    return acc if keepdim else acc.squeeze(dim)


def fexp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) for x <= 0: x = n ln2 + r, a degree-7 Taylor polynomial in r,
    scaled by 2^n built from its bits."""
    xc = torch.clamp(x, min=_EXP_MIN)
    n = torch.round(xc * _LOG2E)
    r = (xc - n * _LN2_HI) - n * _LN2_LO
    p = torch.full_like(r, _EXP_COEFFS[-1])
    for c in reversed(_EXP_COEFFS[:-1]):
        p = p * r + c
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(x < _EXP_MIN, torch.zeros_like(p), p * scale)


def flog(x: torch.Tensor) -> torch.Tensor:
    """ln(x) for positive normal x: x = m 2^e with m in [sqrt(1/2), sqrt(2)),
    ln m = 2 atanh(s), s = (m - 1) / (m + 1), by its odd series."""
    bits = x.contiguous().view(torch.int32)
    e = (bits >> 23) - 127
    m = ((bits & 0x7FFFFF) | 0x3F800000).view(torch.float32)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = (e + big.to(torch.int32)).to(torch.float32)
    f = m - 1.0
    s = f / (f + 2.0)
    z = s * s
    series = z * (2.0 / 9.0) + 2.0 / 7.0
    for c in (2.0 / 5.0, 2.0 / 3.0, 2.0):
        series = series * z + c
    return e * _LN2_HI + (e * _LN2_LO + s * series)


# the Lanczos approximation (g = 7) of the gamma function, as XLA's lgamma
# computes it, on which the reference package's VB evidences are built
_LANCZOS_G = 7.0
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS_COEFFS = (676.520368121885098567009190444019,
                   -1259.13921672240287047156078755283,
                   771.3234287776530788486528258894,
                   -176.61502916214059906584551354,
                   12.507343278686904814458936853,
                   -0.13857109526572011689554707,
                   9.984369578019570859563e-6,
                   1.50563273514931155834e-7)
_HALF_LOG_2PI = (math.log(2) + math.log(math.pi)) / 2


def flgamma(x: torch.Tensor) -> torch.Tensor:
    """ln Gamma(x) for x > 0: the Lanczos sum at max(x, x + 1) (for x below
    0.5, ln Gamma(x) = ln Gamma(x + 1) - ln x)."""
    small = x < 0.5
    y = torch.where(small, x + 1.0, x)
    z = y - 1.0
    a = torch.full_like(z, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS_COEFFS):
        a = a + c / (z + float(i + 1))
    t = z + (_LANCZOS_G + 0.5)
    log_t = flog(t)
    lg = (_HALF_LOG_2PI + (z + 0.5 - t / log_t) * log_t) + flog(a)
    return torch.where(small, lg - flog(torch.where(small, x, 1.0)), lg)


def fdigamma(x: torch.Tensor) -> torch.Tensor:
    """digamma(x) for x > 0: the recurrence psi(x) = psi(x + 1) - 1/x up to
    x >= 6, then the asymptotic series to x^-10."""
    acc = torch.zeros_like(x)
    for _ in range(6):
        small = x < 6.0
        acc = acc - torch.where(small, 1.0 / x, 0.0)
        x = torch.where(small, x + 1.0, x)
    inv = 1.0 / x
    inv2 = inv * inv
    series = torch.full_like(x, 1.0 / 132.0)
    for c in (1.0 / 240.0, 1.0 / 252.0, 1.0 / 120.0, 1.0 / 12.0):
        series = c - inv2 * series
    return acc + ((flog(x) - 0.5 * inv) - inv2 * series)


def fsoftmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """softmax over a short axis: exp(x - max) over its fixed-order sum."""
    e = fexp(x - x.amax(dim, keepdim=True))
    return e / fsum(e, dim, keepdim=True)


__all__ = ["fsum", "fexp", "flog", "flgamma", "fdigamma", "fsoftmax"]
