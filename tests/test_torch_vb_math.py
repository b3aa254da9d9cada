"""vb_math's functions against XLA:CPU's, value by value.

The reference package's VB evidences come from jnp.exp, jnp.log,
jax.scipy.special.gammaln and digamma on XLA:CPU; the port's from
octopus_tpu_torch/core/models/vb_math.py, which builds them from IEEE-exact
ops, in the forms XLA:CPU compiles, so that the CPU and the card agree bit
for bit and both with the reference. Over a seeded float32 sweep of the
domain the engines use (concentrations down to 0.01, where lgamma and
digamma reflect through sin and cos), every value must equal XLA's bit
for bit (PERF.md, Findings): a change to vb_math that moves a function
away from XLA's bits fails here. So does fsum_xla's order against
jnp.sum's over the long read axis, and over (K, reads).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_vb_math.py   # the table
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import digamma, gammaln

from octopus_tpu_torch.core.models import vb_math


def ulps(a, b):
    """Distance of float32 values in units in the last place."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def log_uniform(rng, lo, hi, n):
    return np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.float32)


# name -> (port, XLA:CPU, sweep): the softmax's exp arguments (x - max, down
# to where exp flushes to 0), responsibilities and Lanczos terms for log,
# log1p's arguments z / 7.5, Dirichlet concentrations and their sums for
# lgamma and digamma (below 0.5 both reflect through sin and cos)
SWEEPS = {
    "fexp": (vb_math.fexp, jnp.exp,
             lambda rng: np.concatenate([
                 rng.uniform(-88.0, 0.0, 100_000),
                 -log_uniform(rng, 1e-8, 1.0, 100_000)]).astype(np.float32)),
    "flog1p": (vb_math.flog1p, jnp.log1p,
               lambda rng: np.concatenate([
                   rng.uniform(-0.2, 0.5, 100_000),
                   log_uniform(rng, 1e-6, 2e3, 100_000)]).astype(np.float32)),
    "flog": (vb_math.flog, jnp.log,
             lambda rng: log_uniform(rng, 1e-30, 1e4, 200_000)),
    "flgamma": (vb_math.flgamma, gammaln,
                lambda rng: log_uniform(rng, 0.05, 1e4, 200_000)),
    "fdigamma": (vb_math.fdigamma, digamma,
                 lambda rng: log_uniform(rng, 0.5, 1e4, 200_000)),
    "fdigamma_below_half": (vb_math.fdigamma, digamma,
                            lambda rng: log_uniform(rng, 0.01, 0.5, 50_000)),
    "flgamma_below_half": (vb_math.flgamma, gammaln,
                           lambda rng: log_uniform(rng, 0.01, 0.5, 50_000)),
}

def measure(name, seed=0):
    port, xla, sweep = SWEEPS[name]
    x = sweep(np.random.default_rng(seed))
    got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(xla(jnp.asarray(x)))
    d = ulps(got, want)
    return {"function": name, "n": int(x.size),
            "bit_equal": float((d == 0).mean()), "max_ulps": int(d.max()),
            "domain": [float(x.min()), float(x.max())]}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_vb_math_against_xla_cpu(name):
    row = measure(name)
    assert row["bit_equal"] == 1.0 and row["max_ulps"] == 0, row


def crafted(rng, shape):
    """float32 values over ten decades of both signs, where the order of
    the additions shows in the last bits."""
    return (rng.standard_normal(shape)
            * np.exp(rng.uniform(-5, 5, shape))).astype(np.float32)


@pytest.mark.parametrize("n", [24, 32, 100, 128, 500, 2048, 8000])
def test_fsum_xla_adds_in_xla_cpu_order(n):
    """jnp.sum over the reference's reads, padded with zeros to its rung
    Np = 32 * 4^k, and over (K, reads), as XLA:CPU adds them: windows of 32
    one element after another (K-major within a window), then the window
    sums; fsum_xla over the n real reads gives the same bits, the pairwise
    order does not."""
    rng = np.random.default_rng(n)
    x = crafted(rng, (6, 3, n))
    rung = 32
    while rung < n:
        rung *= 4
    padded = jnp.asarray(np.concatenate(
        [x, np.zeros((6, 3, rung - n), np.float32)], -1))
    for fsum_xla in (vb_math.fsum_xla, vb_math.fsum_xla_ops):
        got = fsum_xla(torch.from_numpy(x))
        assert np.array_equal(got.numpy(), np.asarray(jnp.sum(padded, -1)))
        got2 = fsum_xla(torch.from_numpy(x), 2)
        assert np.array_equal(got2.numpy(),
                              np.asarray(jnp.sum(padded, (-2, -1))))
    if n > 32:
        pairwise = vb_math.fsum(torch.from_numpy(x), -1).numpy()
        assert not np.array_equal(pairwise, np.asarray(jnp.sum(padded, -1)))


def every_float32(stride):
    """Every stride-th float32 bit pattern, NaNs left out."""
    x = (np.arange(0, 2 ** 32, stride, dtype=np.uint64).astype(np.uint32)
         .view(np.float32))
    return x[~np.isnan(x)]


@pytest.mark.parametrize("name", ["fexp", "flog", "fsum_xla"])
def test_host_forms_give_the_torch_forms_bits(name):
    """On the CPU exp, log and fsum_xla run in csrc/vb_host.cpp; the torch
    forms (fexp_ops, flog_ops, fsum_xla_ops) are what a card runs. Over
    float32 bit patterns across the whole range (flushes, clamps and the
    log's floor included) and over sums of every shape the engines take,
    both give the same bits."""
    assert vb_math._host_library() is not None, "csrc/vb_host.cpp did not build"
    host, ops = getattr(vb_math, name), getattr(vb_math, name + "_ops")
    rng = np.random.default_rng(7)
    if name == "fsum_xla":
        cases = [(crafted(rng, (5, 3, n)), dims, window)
                 for n in (1, 31, 32, 33, 100, 1025, 33_000)
                 for dims in (1, 2) for window in (32, 8)]
        for x, dims, window in cases:
            x[x > 2] = -0.0
            got = host(torch.from_numpy(x), dims, window)
            want = ops(torch.from_numpy(x), dims, window)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        return
    x = every_float32(997)
    if name == "flog":
        x = x[np.isfinite(x)]
    x = torch.from_numpy(np.concatenate([x, rng.uniform(
        -100, 100, 1_000_000).astype(np.float32)]))
    assert torch.equal(host(x).view(torch.int32), ops(x).view(torch.int32))


if __name__ == "__main__":
    for name in SWEEPS:
        print(json.dumps(measure(name)))
