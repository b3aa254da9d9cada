"""The host extension's job gathering against the reference's.

`likelihood_array._gather_jobs` runs `gather_anchor_jobs` of the host
extension. The oracle here is the reference's NumPy form: its k-mer
mapper (`read_kmer_hashes`, `HaplotypeKmerIndex.map_reads_flat`), the
original offset through `np.isin`, the range rule and the shift as the
reference's `_populate_sample` applies them, over groups of reads and
haplotypes. Both must give the same (haplotype, read, anchor) jobs,
element for element, in the same order: every later step (the length
buckets, the host-DP gate, each launch's shape, the max over anchors, the
cache writes) reads them as they come. The sweeps cover
reads shorter than K, N bases, reads with no k-mer hit, low-complexity
haplotypes with more than ten best begins, reads over either end of a
haplotype, a need mask with fully cached haplotypes, several groups, pads
8/16/32 and 5-15 kb reads against tens-of-kb haplotypes.
"""

import numpy as np
import pytest

from octopus_tpu.core.likelihood.kmer_mapper import (
    HaplotypeKmerIndex,
    read_kmer_hashes,
)
from octopus_tpu_torch import _build
from octopus_tpu_torch.basics.reads import make_read_batch
from octopus_tpu_torch.basics.sequence import decode_sequence
from octopus_tpu_torch.core.likelihood import likelihood_array as la


@pytest.fixture(autouse=True)
def native():
    return _build.require_native()


def reference_jobs(seq, seq_offsets, original, haplotypes, read_base,
                   hap_base, need, pad, fault):
    """`la._gather_jobs`'s contract, computed as the reference's
    `_populate_sample` computes one group's jobs."""
    hashes_flat, hash_offsets = read_kmer_hashes(seq, seq_offsets)
    lens = np.diff(seq_offsets)
    jh_parts, jr_parts, jp_parts = [], [], []
    for g in range(len(read_base) - 1):
        r0, r1 = int(read_base[g]), int(read_base[g + 1])
        ho = hash_offsets[r0:r1 + 1]
        local_hashes = hashes_flat[ho[0]:ho[-1]]
        local_offsets = ho - ho[0]
        local_orig = original[r0:r1]
        local_lens = lens[r0:r1]
        nr = r1 - r0
        if nr == 0:
            continue
        loc_reads = np.arange(nr)
        for h in range(int(hap_base[g]), int(hap_base[g + 1])):
            hap_len = len(haplotypes[h])
            need_h = np.ones(nr, bool) if need is None else need[h, r0:r1]
            if not need_h.any():
                continue
            read_of, begin = HaplotypeKmerIndex(haplotypes[h]).map_reads_flat(
                local_hashes, local_offsets)
            M = max(hap_len, int(local_orig.max()) + 1) + 2
            have = np.isin(loc_reads * M + local_orig, read_of * M + begin)
            missing = np.flatnonzero(~have)
            if len(missing):
                read_of = np.concatenate([read_of, missing])
                begin = np.concatenate([begin, local_orig[missing]])
            sel = need_h[read_of]
            read_of, begin = read_of[sel], begin[sel]
            ok = (begin >= pad) & (begin + local_lens[read_of] <= hap_len)
            cnt_ok = np.bincount(read_of[ok], minlength=nr)
            none_r = np.flatnonzero(need_h & (cnt_ok == 0))
            read_of, begin = read_of[ok], begin[ok]
            if len(none_r):
                pos = np.maximum(local_orig[none_r], pad)
                over = pos + local_lens[none_r] - hap_len
                pos = np.where(over > 0, pos - over, pos)
                bad = (pos < pad) | (pos + local_lens[none_r] > hap_len)
                if bad.any():
                    raise la.ShortHaplotypeError(
                        fault(h, r0 + int(none_r[np.argmax(bad)])))
                read_of = np.concatenate([read_of, none_r])
                begin = np.concatenate([begin, pos])
            jh_parts.append(np.full(len(read_of), h, np.int64))
            jr_parts.append(read_of.astype(np.int64) + r0)
            jp_parts.append(begin.astype(np.int64))
    empty = np.zeros(0, np.int64)
    return (np.concatenate(jh_parts) if jh_parts else empty,
            np.concatenate(jr_parts) if jr_parts else empty,
            np.concatenate(jp_parts) if jp_parts else empty)


def numpy_form(monkeypatch):
    monkeypatch.setattr(la, "_gather_jobs", reference_jobs)


def mutate(rng, codes, n_snvs):
    out = codes.copy()
    for _ in range(n_snvs if len(out) else 0):
        i = int(rng.integers(0, len(out)))
        out[i] = (out[i] + rng.integers(1, 4)) % 4
    return out


def make_groups(seed, pad, n_groups=3, hap_lens=(150, 700), n_reads=(1, 40),
                read_lens=(60, 160)):
    """Groups of haplotypes (mutated copies of one chunk, some with N bases
    or a poly-A run) and reads of every kind the gathering meets."""
    rng = np.random.default_rng(seed)
    seqs, original, haps = [], [], []
    read_base, hap_base = [0], [0]
    for _ in range(n_groups):
        hap_len = int(rng.integers(*hap_lens))
        ref = rng.integers(0, 4, hap_len).astype(np.uint8)
        if rng.random() < 0.4:
            at = int(rng.integers(0, hap_len - 60))
            ref[at:at + int(rng.integers(20, 60))] = 0
        group_haps = [ref] + [mutate(rng, ref, int(rng.integers(1, 6)))
                              for _ in range(int(rng.integers(0, 4)))]
        for h in group_haps:
            if rng.random() < 0.3:
                h[rng.integers(0, hap_len, 3)] = 4
        haps.extend(group_haps)
        hap_base.append(len(haps))
        for _ in range(int(rng.integers(n_reads[0], n_reads[1] + 1))):
            kind = rng.choice(["plain", "short", "n_bases", "random", "start",
                               "end", "over_end", "beyond", "poly_a"])
            L = int(rng.integers(*read_lens))
            L = min(L, hap_len - pad)
            src = group_haps[int(rng.integers(0, len(group_haps)))]
            start = int(rng.integers(0, hap_len - L + 1))
            if kind == "short":
                L = int(rng.integers(0, 6))
            if kind == "start":
                start = int(rng.integers(0, pad + 1))
            if kind == "end":
                start = hap_len - L
            seq = mutate(rng, src[start:start + L], int(rng.integers(0, 4)))
            if kind == "over_end":
                start = int(rng.integers(hap_len - L + 1, hap_len - 5))
                tail = rng.integers(0, 4, L - (hap_len - start))
                seq = np.concatenate((src[start:], tail)).astype(np.uint8)
            if kind == "n_bases" and L:
                seq[rng.integers(0, L, int(rng.integers(1, 8)))] = 4
            if kind == "random":
                seq = rng.integers(0, 4, L).astype(np.uint8)
            if kind == "poly_a":
                seq = np.zeros(L, np.uint8)
            orig = max(start + int(rng.integers(-3, 4)), 0)
            if kind == "beyond":
                orig = hap_len + int(rng.integers(0, 50))
            seqs.append(seq.astype(np.uint8))
            original.append(orig)
        read_base.append(len(seqs))
    seq_offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=seq_offsets[1:])
    return dict(seq=np.concatenate(seqs), seq_offsets=seq_offsets,
                original=np.asarray(original, np.int64), haplotypes=haps,
                read_base=np.asarray(read_base, np.int64),
                hap_base=np.asarray(hap_base, np.int64))


def fault(h, r):
    return f"haplotype {h}, read {r}"


def gather(case, need, pad):
    return la._gather_jobs(case["seq"], case["seq_offsets"],
                           case["original"], case["haplotypes"],
                           case["read_base"], case["hap_base"], need, pad,
                           fault)


def both_forms(case, need, pad, monkeypatch):
    la.ROUTING.reset()
    got = gather(case, need, pad)
    assert la.ROUTING.native_gathers == 1
    with monkeypatch.context() as m:
        numpy_form(m)
        want = gather(case, need, pad)
    assert la.ROUTING.native_gathers == 1
    return got, want


def assert_same_jobs(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and w.dtype == np.int64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pad", [8, 16, 32])
@pytest.mark.parametrize("seed", range(6))
def test_native_jobs_equal_the_numpy_form(seed, pad, monkeypatch):
    case = make_groups(seed * 97 + pad, pad)
    got, want = both_forms(case, None, pad, monkeypatch)
    assert_same_jobs(got, want)
    assert len(got[0]) > 0


@pytest.mark.parametrize("pad", [8, 16, 32])
@pytest.mark.parametrize("seed", range(4))
def test_native_jobs_equal_the_numpy_form_under_a_need_mask(seed, pad,
                                                           monkeypatch):
    case = make_groups(1000 + seed * 31 + pad, pad, n_groups=1)
    n_haps, n_reads = len(case["haplotypes"]), len(case["original"])
    rng = np.random.default_rng(seed)
    need = rng.random((n_haps, n_reads)) < 0.6
    need[rng.integers(0, n_haps)] = False       # a fully cached haplotype
    got, want = both_forms(case, need, pad, monkeypatch)
    assert_same_jobs(got, want)
    assert not np.isin(got[0], np.flatnonzero(~need.any(axis=1))).any()
    assert need[got[0], got[1]].all()


@pytest.mark.parametrize("seed", range(2))
def test_long_reads_against_long_haplotypes(seed, monkeypatch):
    """5-15 kb reads against haplotypes of tens of kb: the reference's
    mapper takes its sparse vote path there (reads x begins above 2**21)."""
    case = make_groups(50 + seed, 16, n_groups=1, hap_lens=(28000, 32000),
                       n_reads=(80, 85), read_lens=(5000, 15000))
    assert len(case["original"]) * (28000 - 6) > (1 << 21)
    got, want = both_forms(case, None, 16, monkeypatch)
    assert_same_jobs(got, want)


@pytest.mark.parametrize("pad", [8, 16, 32])
def test_a_short_haplotype_raises_the_same_fault(pad, monkeypatch):
    case = make_groups(7 + pad, pad, n_groups=2)
    # the last group's haplotypes cut shorter than its first read and pad
    g0, g1 = int(case["hap_base"][-2]), int(case["hap_base"][-1])
    r0 = int(case["read_base"][-2])
    long_read = int(np.argmax(np.diff(case["seq_offsets"])[r0:])) + r0
    L = int(np.diff(case["seq_offsets"])[long_read])
    for h in range(g0, g1):
        case["haplotypes"][h] = case["haplotypes"][h][:max(L + pad - 1, 0)]
    messages = []
    la.ROUTING.reset()
    with pytest.raises(la.ShortHaplotypeError) as native_error:
        gather(case, None, pad)
    messages.append(str(native_error.value))
    with monkeypatch.context() as m:
        numpy_form(m)
        with pytest.raises(la.ShortHaplotypeError) as numpy_error:
            gather(case, None, pad)
    messages.append(str(numpy_error.value))
    assert messages[0] == messages[1]
    assert messages[0].startswith(f"haplotype {g0}, read ")
    assert la.ROUTING.native_gathers == 1


def test_no_reads_and_no_haplotypes(monkeypatch):
    case = make_groups(3, 8, n_groups=1)
    empty = dict(case, haplotypes=[], hap_base=np.zeros(2, np.int64))
    got, want = both_forms(empty, None, 8, monkeypatch)
    assert_same_jobs(got, want)
    assert len(got[0]) == 0


def window(seed, n_reads=70, hap_len=360, n_haps=4):
    """Haplotypes of one chunk and reads with errors and N bases, some
    over its ends."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, hap_len).astype(np.uint8)
    haps = [ref] + [mutate(rng, ref, 2) for _ in range(n_haps - 1)]
    reads = []
    for _ in range(n_reads):
        L = int(rng.integers(60, 101))
        start = int(rng.integers(0, hap_len - L + 1))
        seq = mutate(rng, haps[int(rng.integers(0, n_haps))][start:start + L],
                     int(rng.integers(0, 3)))
        if rng.random() < 0.1:
            seq[rng.integers(0, L)] = 4
        reads.append((start, f"{L}M", decode_sequence(seq),
                      rng.integers(15, 42, L), int(rng.integers(20, 61)),
                      16 if rng.random() < 0.5 else 0))
    return haps, reads


@pytest.mark.parametrize("pad", [8, 16])
def test_populate_is_bit_equal_with_either_form(pad, monkeypatch):
    haps, reads = window(pad)
    batches = [make_read_batch("chr1", reads[:40]),
               make_read_batch("chr1", reads[40:])]
    cfg = la.LikelihoodConfig(device="cpu")

    def run():
        cache = {}
        arr = la.HaplotypeLikelihoodArray(cfg)
        first = arr.populate(batches, haps, 0, flank_state=la.FlankState(30, 30),
                             cache=cache, pad=pad)
        first = [first.sample_matrix(i).copy() for i in range(2)]
        # a prune round: the survivors are fully cached, a new one is not
        kept = [haps[0], haps[2], mutate(np.random.default_rng(pad), haps[1], 3)]
        second = arr.populate(batches, kept, 0,
                              flank_state=la.FlankState(30, 30), cache=cache,
                              pad=pad)
        return first + [second.sample_matrix(i) for i in range(2)], len(cache)

    la.ROUTING.reset()
    got, n_got = run()
    assert la.ROUTING.native_gathers == 4      # two samples, two populates
    with monkeypatch.context() as m:
        numpy_form(m)
        want, n_want = run()
    assert la.ROUTING.native_gathers == 4
    assert n_got == n_want > 0
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_assignment_blocks_are_bit_equal_with_either_form(monkeypatch):
    jobs = []
    for seed, pad in ((21, 8), (22, 8), (23, 16), (24, 8)):
        haps, reads = window(seed, n_reads=30, n_haps=2 + seed % 2)
        jobs.append((make_read_batch("chr1", reads), haps, [None] * len(haps),
                     0, pad))
    cfg = la.LikelihoodConfig(device="cpu")
    la.ROUTING.reset()
    got = la.populate_assignment_blocks(jobs, cfg)
    assert la.ROUTING.native_gathers == 2      # one a pad group
    with monkeypatch.context() as m:
        numpy_form(m)
        want = la.populate_assignment_blocks(jobs, cfg)
    assert la.ROUTING.native_gathers == 2
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_assignment_fault_names_its_job(monkeypatch):
    haps, reads = window(31, n_reads=20)
    batch = make_read_batch("chr1", reads)
    short = [h[:90] for h in haps]
    jobs = [(batch, haps, [None] * len(haps), 0, 8),
            (batch, short, [None] * len(short), 0, 8)]
    messages = []
    for force_numpy in (False, True):
        with monkeypatch.context() as m:
            if force_numpy:
                numpy_form(m)
            with pytest.raises(la.ShortHaplotypeError) as error:
                la.populate_assignment_blocks(
                    jobs, la.LikelihoodConfig(device="cpu"))
        messages.append(str(error.value))
    assert messages[0] == messages[1] == (
        "assignment-block haplotype too short (hap 90, job 1)")


def test_native_gathers_counter_resets():
    la.ROUTING.record_native_gather()
    assert la.ROUTING.native_gathers >= 1
    la.ROUTING.reset()
    assert la.ROUTING.native_gathers == 0
