"""Float32 arithmetic for the VB engines that rounds alike on the CPU and on
a CUDA card, in the forms XLA:CPU compiles for the reference package.

The callers read the VB evidences far into their tails: a cancer call's PP
is 1 minus a posterior mass near 1, a difference that at PP ~ 130 is below
the float64 resolution of the evidence sums, so one ELBO that differs in
its last bit can move a record. torch's own exp, log, digamma and lgamma
round differently on the two devices (different math libraries), and so do
its reductions (different summation orders). The functions here use only
operations that IEEE 754 rounds exactly and that both devices implement
so: float32 and float64 +, -, *, /, comparisons, floor and bit views.
Reductions add in a fixed order. So an evaluation gives the same bits
wherever it runs and however its genotype rows are chunked.

The forms are those of the reference's compiled program (its optimised
HLO and the LLVM code XLA:CPU emits for it): Cephes' expf, logf and log1pf
polynomials; the Lanczos (g = 7) lgamma and digamma with XLA's reflection
below 0.5 and its true divisions; sin and cos as glibc's sinf/cosf round
them (the float32 rounding of the float64 value); and every product that
LLVM contracts into a fused multiply-add, which `ffma` rounds once, as the
card's and the CPU's FMA units do, from an exact float64 product. fsum_xla
adds in XLA:CPU's order for a reduction over a long axis: in windows of 32,
one element after another, then the window sums the same way.

On the CPU, exp and log (the element-wise work of a VB round) run in
csrc/vb_host.cpp, the same operations in the same order without torch's
float64 temporaries, and so do fsum_xla's sums; fexp_ops, flog_ops and
fsum_xla_ops are the torch forms, which a card runs and the tests hold the
host forms to. The subclone model's whole evaluation runs there too
(subclone_vb.vb_subclone), each form here that it takes in C++: for it the
torch forms are the card's, and the CPU's where g++ is missing.
"""

from __future__ import annotations

import ctypes
import math
import platform

import torch

_LN2_HI = 0.693359375                  # Cephes' split of ln 2
_LN2_LO = -0.00021219444170128554     # float32
_LOG2E = 1.44269502162933349609375     # float32
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_EXP_P = (1.9875691214110702e-4, 1.398199936375022e-3, 8.333452045917511e-3,
          4.166579619050026e-2, 0.1666666567325592, 0.5)
_FLT_MIN = 1.1754943508222875e-38
_SQRTH = 0.7071067690849304
_LOG_P = ((0.07037683576345444, -0.11514610052108765, 0.11676998436450958),
          (-0.12420140951871872, 0.14249323308467865, -0.16668057441711426),
          (0.2000071406364441, -0.24999994039535522, 0.3333333134651184))
_LOG1P_SMALL = 0.41421356                         # sqrt(2) - 1, float32
_LOG1P_NUM = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
              29.91191864013672, 60.949668884277344, 57.11296463012695,
              20.039552688598633)
_LOG1P_DEN = (1.0, 15.062909126281738, 83.04756927490234, 221.7624053955078,
              309.0987243652344, 216.42788696289062, 60.11865997314453)


def _f32(v: float) -> float:
    """The float32 value nearest v, as a Python float."""
    return torch.tensor(v, dtype=torch.float32).item()


_PI = _f32(math.pi)
_LOG_PI = _f32(math.log(math.pi))
_HALF_LOG_2PI = _f32((math.log(2) + math.log(math.pi)) / 2)
_LOG_G_HALF = _f32(math.log(7.5))
_INV_G_HALF = _f32(1 / 7.5)            # XLA turns z / 7.5 into z * (1 / 7.5)
_LANCZOS = tuple(_f32(c) for c in (
    676.520368121885098567009190444019, -1259.13921672240287047156078755283,
    771.3234287776530788486528258894, -176.61502916214059906584551354,
    12.507343278686904814458936853, -0.13857109526572011689554707,
    9.984369578019570859563e-6, 1.50563273514931155834e-7))


def _d(v):
    return v.double() if isinstance(v, torch.Tensor) else float(v)


def ffma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add: the
    product of two float32 values is exact in float64, and rounding the
    float64 sum to float32 gives the fused result unless that sum lands
    exactly on a float32 rounding midpoint (about 2^-29 of sums)."""
    return (_d(a) * _d(b) + _d(c)).float()


def _floor(x: torch.Tensor) -> torch.Tensor:
    """floor(x). On the CPU as trunc(x), less one where that rounded up:
    torch's float32 floor takes tens of milliseconds there on tensors of
    a few thousand elements."""
    if x.is_cuda:
        return torch.floor(x)
    t = torch.trunc(x)
    return torch.where(t > x, t - 1.0, t)


def _select(mask: torch.Tensor, if_true, if_false) -> torch.Tensor:
    """torch.where(mask, if_true(), if_false()). On the CPU a branch that no
    element takes is not computed: the values are the same, the work less
    (on a card the test would cost a synchronisation)."""
    if not mask.is_cuda:
        if bool(mask.all()):
            return if_true()
        if not bool(mask.any()):
            return if_false()
    return torch.where(mask, if_true(), if_false())


def _div(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x as a true division (torch computes a Python scalar over a
    tensor as a reciprocal times c)."""
    return torch.full_like(x, c) / x


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


def _seq(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis one element after another (the axis moved to
    the front first, so that each step reads a contiguous slice)."""
    cols = x.movedim(-1, 0).contiguous()
    acc = cols[0]
    for col in cols[1:]:
        acc = acc + col
    return acc


def fsum_xla(x: torch.Tensor, dims: int = 1, window: int = 32) -> torch.Tensor:
    """Sum over the last `dims` axes, of which the last is long, as XLA:CPU
    reduces them: the long axis cut in windows of `window` (zero-padded),
    each window's elements (all leading reduced axes, then the long one)
    added one after another, then the window sums the same way, in windows
    again while there are more than `window` of them. On the CPU
    csrc/vb_host.cpp adds in the same order."""
    n = x.shape[-1]
    out_shape = x.shape[:x.dim() - dims]
    y = None if n == 0 else _on_host(
        "vb_fsum_xla", x, out_shape,
        (math.prod(out_shape), math.prod(x.shape[x.dim() - dims:-1]), n,
         window))
    return fsum_xla_ops(x, dims, window) if y is None else y


def fsum_xla_ops(x: torch.Tensor, dims: int = 1,
                 window: int = 32) -> torch.Tensor:
    """fsum_xla in torch operations, the form a card runs."""
    n = x.shape[-1]
    if n == 0:
        return x.new_zeros(x.shape[:x.dim() - dims])
    nw = -(-n // window)
    if nw * window != n:
        x = torch.cat([x, x.new_zeros(*x.shape[:-1], nw * window - n)], -1)
    lead = x.shape[x.dim() - dims:-1]
    x = x.reshape(*x.shape[:x.dim() - 1], nw, window)
    # (..., *lead, nw, window) -> (..., nw, *lead * window)
    x = x.movedim(-2, x.dim() - dims - 1)
    x = x.reshape(*x.shape[:x.dim() - dims], math.prod(lead) * window)
    sums = _seq(x)                                        # (..., nw)
    if nw > window:
        return fsum_xla_ops(sums, 1, window)
    return _seq(sums)


def fdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of a * b, one multiply-add after another (a
    reduction whose product XLA:CPU fuses into its loop)."""
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = ffma(a[..., i], b[..., i], acc)
    return acc


_HOST = None          # csrc/vb_host.cpp's library; False when it cannot build


def _host_library():
    """csrc/vb_host.cpp built (first call only) and loaded, or None where
    g++ is missing: the torch forms then run on the CPU too, to the same
    bits."""
    global _HOST
    if _HOST is None:
        from ..._build import CSRC, BuildError, build
        src = CSRC / "vb_host.cpp"
        # -fno-trapping-math lets g++ vectorise the selects (it moves no
        # rounding); AVX2 on x86-64, which every H100 host has
        arch = (["-march=x86-64-v3"] if platform.machine() == "x86_64"
                else [])
        try:
            path = build("vb_host", [src],
                         lambda out: ["g++", "-O3", "-std=c++17",
                                      "-ffp-contract=off", "-fno-trapping-math",
                                      *arch, "-shared", "-fPIC", "-pthread",
                                      src, "-o", out], ".so")
            lib = ctypes.CDLL(str(path))
        except (BuildError, OSError):
            _HOST = False
            return None
        for name, n_arrays, n_sizes in (("vb_fexp", 2, 1), ("vb_flog", 2, 1),
                                        ("vb_fsum_xla", 2, 4),
                                        ("vb_subclone_host", 6, 5)):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = ([ctypes.c_void_p] * n_arrays
                           + [ctypes.c_int64] * n_sizes + [ctypes.c_int])
        _HOST = lib
    return _HOST or None


def _on_host(name: str, x: torch.Tensor, out_shape=None, sizes=None):
    """The host library's `name` over a float32 CPU tensor (element-wise,
    or into `out_shape` given the call's `sizes`), else None."""
    if x.is_cuda or x.dtype != torch.float32:
        return None
    lib = _host_library()
    if lib is None:
        return None
    x = x.contiguous()
    y = torch.empty(x.shape if out_shape is None else out_shape,
                    dtype=torch.float32)
    getattr(lib, name)(x.data_ptr(), y.data_ptr(),
                       *((x.numel(),) if sizes is None else sizes),
                       torch.get_num_threads())
    return y


def fexp(x: torch.Tensor) -> torch.Tensor:
    """exp(x), Cephes' expf: x = n ln2 + r with n = floor(x log2e + 1/2)
    and a degree-5 polynomial in r, scaled by 2^n built from its bits. On
    the CPU csrc/vb_host.cpp computes the same form."""
    y = _on_host("vb_fexp", x)
    return fexp_ops(x) if y is None else y


def fexp_ops(x: torch.Tensor) -> torch.Tensor:
    """fexp in torch operations, the form a card runs."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = _floor(ffma(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    n64 = n.double()
    r = ffma(n64, -_LN2_LO, ffma(n64, -_LN2_HI, x)).double()
    p = ffma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        p = ffma(p, r, c)
    y = ffma(p, (r * r).float(), r) + 1.0     # r * r rounded as float32
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    y = y * scale
    return torch.where(y < _FLT_MIN, torch.zeros_like(y), y)  # flushed


def flog(x: torch.Tensor) -> torch.Tensor:
    """ln(x) for positive x, Cephes' logf: x = m 2^e with m in [sqrt(1/2),
    sqrt(2)), a polynomial in m - 1 split in three interleaved parts. On
    the CPU csrc/vb_host.cpp computes the same form."""
    y = _on_host("vb_flog", x)
    return flog_ops(x) if y is None else y


def flog_ops(x: torch.Tensor) -> torch.Tensor:
    """flog in torch operations, the form a card runs."""
    x = torch.where(x > _FLT_MIN, x, torch.full_like(x, _FLT_MIN))
    bits = x.contiguous().view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    lt = m < _SQRTH
    e = e - lt.to(torch.float32)
    f = (m - 1.0) + torch.where(lt, m, torch.zeros_like(m))
    z = f * f
    f64, f3 = f.double(), (z * f).double()
    a, b, c = (ffma(f64, p[0], p[1]) for p in _LOG_P)
    a, b, c = (ffma(q, f64, p[2]) for q, p in zip((a, b, c), _LOG_P))
    y = ffma(ffma(a, f3, b), f3, c)
    y = ffma(y, f3, e * _LN2_LO)
    return ffma(e, _LN2_HI, (f - 0.5 * z) + y)


def flog1p(x: torch.Tensor) -> torch.Tensor:
    """ln(1 + x): Cephes' rational form for |x| < sqrt(2) - 1, else flog."""
    def small():
        x64 = x.double()
        num = torch.full_like(x, _LOG1P_NUM[0])
        den = torch.full_like(x, _LOG1P_DEN[0])
        for cn, cd in zip(_LOG1P_NUM[1:], _LOG1P_DEN[1:]):
            num = ffma(num, x64, cn)
            den = ffma(den, x64, cd)
        x2 = x * x
        return x + ffma(x2, -0.5, (x * x2) * (num / den))

    return _select(torch.abs(x) < _LOG1P_SMALL, small, lambda: flog(x + 1.0))


# glibc's sinf/cosf (the table of sincosf_data.c): sign, 2/pi and pi/2,
# the cosine's c0-c4 and the sine's s1-s3, evaluated in double
_SC_HPI = float.fromhex("0x1.921FB54442D18p0")
_SC_HPI_INV = float.fromhex("0x1.45F306DC9C883p-1")
_SC_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SC_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))


def _sin_poly(x, x2):
    x3 = x * x2
    s1 = _SC_S[1] + x2 * _SC_S[2]
    return (x + x3 * _SC_S[0]) + (x3 * x2) * s1


def _cos_poly(x2):
    x4 = x2 * x2
    c2 = _SC_C[3] + x2 * _SC_C[4]
    c1 = _SC_C[0] + x2 * _SC_C[1]
    return (c1 + x4 * _SC_C[2]) + (x4 * x2) * c2


def _sincos(a: torch.Tensor):
    """sin and cos of float32 a in [0, pi/2], as glibc's sinf and cosf
    compute them: in double, below 0.75 by their polynomials, above it on
    r = a - n pi/2 with n = round(a 2/pi) (for n = 1, sin a = cos r and
    cos a = sin(-r)), rounded to float32."""
    x = a.double()
    n = torch.where(a >= 0.75, _floor(x * _SC_HPI_INV + 0.5),
                    torch.zeros_like(x))
    r = x - n * _SC_HPI
    r2 = r * r
    odd = n == 1.0
    sin = torch.where(odd, _cos_poly(r2), _sin_poly(r, r2))
    cos = torch.where(odd, _sin_poly(-r, r2), _cos_poly(r2))
    return sin.float(), cos.float()


def _lanczos_z(x: torch.Tensor):
    """z: -x below 1/2 (reflected), x - 1 above; the masks and z + i."""
    reflect = x < 0.5
    z = torch.where(reflect, -x, x - 1.0)
    return reflect, z, [z + float(i + 1) for i in range(len(_LANCZOS))]


def _log_t(z: torch.Tensor) -> torch.Tensor:
    """ln(z + 7.5) as XLA computes it: ln 7.5 + log1p(z / 7.5)."""
    return flog1p(z * _INV_G_HALF) + _LOG_G_HALF


def flgamma(x: torch.Tensor) -> torch.Tensor:
    """ln Gamma(x) for x > 0, XLA's Lanczos form (g = 7): above 1/2 at
    z = x - 1, below it reflected through ln(pi / sin(pi x))."""
    reflect, z, zi = _lanczos_z(x)
    a = _div(_LANCZOS[0], zi[0]) + 1.0
    for c, zc in zip(_LANCZOS[1:], zi[1:]):
        a = a + _div(c, zc)
    t = z + 7.5
    log_t = _log_t(z)
    log_y = ffma((z + 0.5) - t / log_t, log_t, _HALF_LOG_2PI) + flog(a)

    def reflected():
        frac = x - _floor(x)
        frac = torch.where(frac > 0.5, 1.0 - frac, frac)
        log_sin = flog(_sincos(frac * _PI)[0])
        return (_LOG_PI - log_sin) - log_y

    return _select(reflect, reflected, lambda: log_y)


def fdigamma(x: torch.Tensor) -> torch.Tensor:
    """digamma(x) for x > 0, XLA's form: the derivative of the Lanczos
    form (g = 7), below 1/2 reflected through pi cot(pi x)."""
    reflect, z, zi = _lanczos_z(x)
    num = torch.zeros_like(x)
    den = _div(_LANCZOS[0], zi[0]) + 1.0
    for i, (c, zc) in enumerate(zip(_LANCZOS, zi)):
        num = num - _div(c, zc * zc)
        if i:
            den = den + _div(c, zc)
    y = ((_log_t(z) + num / den) - _div(7.0, z + 7.5))

    def reflected():
        sin, cos = _sincos((x + torch.abs(_floor(x + 0.5))) * _PI)
        return y - (cos * _PI) / sin

    return _select(reflect, reflected, lambda: y)


def fsoftmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """softmax over a short axis: exp(x - max) over its fixed-order sum."""
    e = fexp(x - x.amax(dim, keepdim=True))
    return e / fsum(e, dim, keepdim=True)


__all__ = ["ffma", "fdot", "fsum", "fsum_xla", "fsum_xla_ops", "fexp",
           "fexp_ops", "flog", "flog_ops", "flog1p", "flgamma", "fdigamma",
           "fsoftmax"]
