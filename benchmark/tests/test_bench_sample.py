"""The check's sample of the pair-HMM's pairs (`probes.PairSample`): at most
its size whatever the launches, each pair of the window as likely to be
compared as any other, the rows it holds bounded once a call returns, and
the check over it (`check.pairhmm_gap`) bounded in time when every launch
is larger than the cap."""

import time
import types

import numpy as np
import pytest
import torch

from benchmark import check, probes
from benchmark.reference import pairhmm as ref

PAD = 8


def tracks(rng, n: int, R: int) -> list:
    """The seven batch-major tracks of n random pairs of R rows."""
    W = R + 2 * PAD - 1
    ints = lambda lo, hi, width: rng.integers(lo, hi, (n, width)).astype(np.int32)
    return [ints(0, 4, R), ints(5, 41, R), ints(0, 4, W), ints(10, 50, W),
            ints(1, 10, W), ints(0, 5, W), ints(5, 40, W)]


def test_sample_holds_its_size_of_the_pairs_whatever_the_calls():
    """Calls of 1,000-5,000 pairs, each larger than the sample: the sample
    is the `size` pairs of least key over all of them, the rows held stay
    under `hold` once each call returns, and each row sampled is the row
    of its call it says it is."""
    rng = np.random.default_rng(5)
    sample = probes.PairSample(256, np.random.default_rng(6))
    base = 0
    for n in rng.integers(1000, 5000, 30):
        ids = torch.arange(base, base + n)
        sample.offer(int(n), lambda ids=ids: [ids, ids * 2], ("launch",))
        base += int(n)
        assert sample.rows_held <= sample.hold
    items = sample.items()
    rows = torch.cat([arrays[0] for _, arrays in items])
    assert len(rows) == 256 and len(set(rows.tolist())) == 256
    for _, (ids, doubled) in items:
        assert torch.equal(doubled, ids * 2)
    assert sample.cuts > 0 and sample.held_max <= sample.hold
    # the 256 pairs of least key among every key the sample drew
    keys = np.random.default_rng(6)
    drawn = np.concatenate([keys.random(int(n)) for n in
                            np.random.default_rng(5).integers(1000, 5000, 30)])
    assert set(rows.tolist()) == set(np.argsort(drawn)[:256].tolist())


def test_every_pair_is_as_likely_to_be_compared():
    """Over 400 seeds, calls of 5, 50, 500 and 45 pairs: a pair of each
    is in a sample of 60 with the chance 60 / 600, within 5 standard
    deviations."""
    sizes = [5, 50, 500, 45]
    hits = np.zeros(len(sizes))
    seeds = 400
    for seed in range(seeds):
        sample = probes.PairSample(60, np.random.default_rng(seed))
        for k, n in enumerate(sizes):
            sample.offer(n, lambda n=n: [np.zeros(n)], (k,))
        for (k,), arrays in sample.items():
            hits[k] += len(arrays[0])
    p = 60 / sum(sizes)
    for k, n in enumerate(sizes):
        trials = seeds * n
        assert abs(hits[k] / trials - p) < 5 * np.sqrt(p * (1 - p) / trials), k


@pytest.mark.parametrize("wrong", [False, True])
def test_check_time_holds_when_every_launch_exceeds_the_cap(wrong):
    """30 launches of 2,000-4,000 pairs against a card cap of 512: the
    check compares 512 pairs, in under 5 s on one CPU core, and finds
    answers wrong on 2% of each launch's rows (512 sampled pairs miss them
    all with a chance of ~3e-5). Rows of 30, so that the reference can
    give every launch its answers here."""
    rng = np.random.default_rng(11)
    capture = types.SimpleNamespace(
        host=probes.PairSample(512, np.random.default_rng(12)),
        card=probes.PairSample(512, np.random.default_rng(13)))
    scored = 0
    for n in rng.integers(2000, 4000, 30):
        n = int(n)
        t = tracks(rng, n, 30)
        out = ref.banded_scores(*t, pad=PAD, nuc_prior=2).astype(np.int32)
        if wrong:
            out[rng.choice(n, n // 50, replace=False)] += 1
        t = [torch.from_numpy(a) for a in (*t, out)]
        capture.card.offer(n, lambda t=t: t, (PAD, 2))
        scored += n
        assert capture.card.rows_held <= capture.card.hold
    started = time.perf_counter()
    gap = check.pairhmm_gap(check.pairhmm_sample(capture))
    seconds = time.perf_counter() - started
    assert scored > 30 * 512
    assert gap["card_pairs"] == 512 and gap["host_pairs"] == 0
    assert gap["card_held_max"] <= 4 * 512
    assert seconds < 5
    assert (gap["hmm_err"] > 0) == wrong
