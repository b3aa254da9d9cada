"""The plain pair-HMM against the reference SSE2 kernel (the prebuilt
harnesses in tests/golden) and against the port's two scorers."""

import os
import subprocess

import numpy as np
import pytest

from benchmark.reference import pairhmm as ref

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "golden")


def cases(seed, n, L, pad, flanks):
    """Packed random cases: reads drawn from their window with SNVs and
    indels, ragged lengths, N in some windows, SNV masks, flanks."""
    rng = np.random.default_rng(seed)
    W = L + 2 * pad - 1
    win = rng.integers(0, 4, (n, W)).astype(np.int32)
    win[rng.random((n, W)) < 0.01] = 4
    lens = rng.integers(L // 2, L + 1, n).astype(np.int32)
    tgt = np.full((n, L), 5, np.int32)
    qual = np.zeros((n, L), np.int32)
    for i in range(n):
        start = int(rng.integers(0, 2 * pad))
        s = win[i, start:start + lens[i]].copy()
        s[s == 4] = 0
        hit = rng.random(len(s)) < 0.05
        s[hit] = rng.integers(0, 4, int(hit.sum()))
        if rng.random() < 0.5:
            k = int(rng.integers(1, len(s) - 5))
            s = np.concatenate((s[:k], s[k + int(rng.integers(1, 4)):]))
        if rng.random() < 0.5:
            k = int(rng.integers(1, len(s) - 5))
            s = np.concatenate((s[:k], rng.integers(0, 4, int(rng.integers(1, 4))), s[k:]))
        s = s[:lens[i]]
        lens[i] = len(s)
        tgt[i, :len(s)] = s
        qual[i, :len(s)] = rng.integers(5, 41, len(s))
    opn = rng.integers(10, 50, (n, W)).astype(np.int32)
    ext = rng.integers(1, 10, (n, W)).astype(np.int32)
    mask = np.where(rng.random((n, W)) < 0.3, rng.integers(0, 4, (n, W)), 4).astype(np.int32)
    prior = rng.integers(5, 40, (n, W)).astype(np.int32)
    lhs = np.zeros(n, np.int32)
    rhs = np.zeros(n, np.int32)
    if flanks:
        lhs = np.where(rng.random(n) < 0.6, rng.integers(0, 30, n), 0).astype(np.int32)
        rhs = np.where(rng.random(n) < 0.6, rng.integers(0, 30, n), 0).astype(np.int32)
    return tgt, qual, win, opn, ext, mask, prior, lens, lhs, rhs


def golden(binary, rows, pad, nuc_prior, flank):
    """Scores of the reference kernel's harness for each row at its length."""
    tgt, qual, win, opn, ext, mask, prior, lens, lhs, rhs = rows
    lines = []
    for i in range(len(lens)):
        R = int(lens[i])
        W = R + 2 * pad - 1
        head = f"{R} {W} {pad} {nuc_prior}"
        if flank:
            head += f" {int(lhs[i])} {int(rhs[i])}"
        lines.append(head)
        for a, n in ((tgt[i], R), (qual[i], R), (win[i], W), (opn[i], W),
                     (ext[i], W), (mask[i], W), (prior[i], W)):
            lines.append(" ".join(map(str, a[:n].tolist())))
    out = subprocess.run([os.path.join(GOLDEN, binary)],
                         input="\n".join(lines) + "\n", capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return np.asarray([int(x) for x in out.stdout.split()])


@pytest.mark.parametrize("pad", [8, 16])
def test_flank_scores_match_the_reference_kernel(pad):
    rows = cases(1 + pad, 150, 100, pad, flanks=True)
    want = golden("golden_pairhmm_flank", rows, pad, 2, flank=True)
    got = ref.flank_scores(*rows, pad=pad, nuc_prior=2)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("pad", [8, 16])
def test_banded_scores_match_the_reference_kernel(pad):
    rows = cases(2 + pad, 150, 100, pad, flanks=False)
    tgt, qual, win, opn, ext, mask, prior, lens, _, _ = rows
    want = golden("golden_pairhmm", rows, pad, 2, flank=False)
    # the band of padded rows scores each read at its own length: the
    # padding's cost is 0 (quality 0, a base no window holds)
    got = ref.banded_scores(tgt, qual, win, opn, ext, mask, prior, pad=pad,
                            nuc_prior=2)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("pad", [8, 16, 32])
def test_matches_the_ports_host_dp_and_plain_scorer(pad):
    torch = pytest.importorskip("torch")
    from octopus_tpu_torch._build import load_native
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    rows = cases(3 + pad, 120, 80, pad, flanks=True)
    native = load_native()
    n, L = rows[0].shape
    W = rows[2].shape[1]
    raw = native.flank_banded_scores(n, L, W, pad, 2,
                                     *(np.ascontiguousarray(a) for a in rows))
    assert np.array_equal(ref.flank_scores(*rows, pad=pad, nuc_prior=2),
                          np.frombuffer(raw, np.int32))
    plain = pb.pairhmm_scores(*rows[:7], pad=pad, nuc_prior=2,
                              device=torch.device("cpu")).numpy()
    assert np.array_equal(ref.banded_scores(*rows[:7], pad=pad, nuc_prior=2),
                          plain)


def test_controls():
    """int16 (the reference kernel's own width) is exact at these scores;
    int8 is not."""
    rows = cases(7, 150, 100, 8, flanks=True)
    want = ref.flank_scores(*rows, pad=8, nuc_prior=2)
    i16 = ref.flank_scores(*rows, pad=8, nuc_prior=2, dtype=np.int16, inf=16000)
    i8 = ref.flank_scores(*rows, pad=8, nuc_prior=2, dtype=np.int8, inf=127)
    assert np.array_equal(i16, want)
    assert np.abs(i8 - want).max() > 0
