"""The port's CLI with the population and trio callers against the
reference CLI, on the CPU.

simulate_population(kb=15, depth=30, seed=9, n_samples=3) and
simulate_trio(kb=15, depth=30, seed=5) (10 de novo SNVs) go through the
reference package's CLI (JAX on the CPU) and the port's with --device
cpu; the VCF record lines and the header must be identical (but the lines
carrying a date or a command line). Cases: --caller population, several
BAMs without --caller, -M/-F, --pedigree with the BAMs given child first,
--denovos-only, and the pair-HMM routed to the kernels' plain twins
(OCTOPUS_TPU_HOST_HMM_MAX=0, with and without OCTOPUS_TPU_UNROLLED_HMM=1),
which must give the reference's default records. The reference CLI leaves
OCTOPUS_TPU_HOST_HMM_MAX and OCTOPUS_TPU_HOST_LATENTS set after a small
run; both are cleared before every port run. The simulators must write the
files bench_e2e_multi.py's bench_trio and bench_population write.

The file took 40 s on an 8-core CPU host with nothing else running, so it
stands alone and --dist loadfile gives it a worker.
"""

import filecmp
import os
from pathlib import Path

import pytest

from octopus_tpu import cli as ref_cli
from octopus_tpu_torch import cli
from octopus_tpu_torch.core.likelihood import likelihood_array as la
from octopus_tpu_torch.utils import synthetic

PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")
PED = ("FAM KID DAD MOM 1 1\n"
       "FAM DAD 0 0 1 1\n"
       "FAM MOM 0 0 2 1\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_multi")
    (d / "population").mkdir()
    (d / "trio").mkdir()
    fa_p, bams_p, truth, _ = synthetic.simulate_population(
        str(d / "population"), kb=15, depth=30, seed=9, n_samples=3)
    fa_t, bams_t, germline, denovo, _ = synthetic.simulate_trio(
        str(d / "trio"), kb=15, depth=30, seed=5)
    ped = d / "trio" / "family.ped"
    ped.write_text(PED)
    mom, dad, kid = bams_t
    cases = {
        "population": ["-R", fa_p, "-I", *bams_p, "--caller", "population"],
        "population_auto": ["-R", fa_p, "-I", *bams_p],
        "trio": ["-R", fa_t, "-I", *bams_t, "-M", "MOM", "-F", "DAD"],
        "trio_pedigree_child_first": ["-R", fa_t, "-I", kid, mom, dad,
                                      "--pedigree", str(ped)],
        "trio_denovos_only": ["-R", fa_t, "-I", *bams_t, "-M", "MOM", "-F",
                              "DAD", "--denovos-only"],
    }
    return d, cases, {"population": truth, "germline": germline,
                      "denovo": denovo}


@pytest.fixture(scope="module")
def reference_vcfs(inputs):
    d, cases, _ = inputs
    saved = {k: os.environ.get(k) for k in PINNED}
    vcfs = {}
    try:
        for name, argv in cases.items():
            vcfs[name] = str(d / f"reference_{name}.vcf")
            assert ref_cli.main([*argv, "-o", vcfs[name]]) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return vcfs


def split_vcf(path):
    lines = Path(path).read_text().splitlines()
    header = [line for line in lines if line.startswith("##")
              and not line.startswith(("##fileDate", "##commandline",
                                       "##source"))]
    return header, [line for line in lines if not line.startswith("##")]


def near(points, targets, tol=5):
    return [t for t in targets if any(abs(t - p) <= tol for p in points)]


# port case -> (reference case, environment of the port run)
ROUTED = {
    "population_host_hmm_max_0": ("population",
                                  {"OCTOPUS_TPU_HOST_HMM_MAX": "0"}),
    "trio_host_hmm_max_0": ("trio", {"OCTOPUS_TPU_HOST_HMM_MAX": "0"}),
    "trio_lanes_host_hmm_max_0": ("trio", {"OCTOPUS_TPU_HOST_HMM_MAX": "0",
                                           "OCTOPUS_TPU_UNROLLED_HMM": "1"}),
}
CASES = ["population", "population_auto", "trio", "trio_pedigree_child_first",
         "trio_denovos_only", *ROUTED]


@pytest.mark.parametrize("case", CASES)
def test_port_cli_writes_the_reference_records(inputs, reference_vcfs,
                                               monkeypatch, case):
    d, cases, truth = inputs
    want_case, env = ROUTED.get(case, (case, {}))
    for k in PINNED:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = str(d / f"port_{case}.vcf")
    la.ROUTING.reset()
    assert cli.main([*cases[want_case], "-o", out, "--device", "cpu"]) == 0
    want_header, want = split_vcf(reference_vcfs[want_case])
    got_header, got = split_vcf(out)
    assert got == want
    assert got_header == want_header
    records = [line.split("\t") for line in got[1:]]
    called = [int(r[1]) - 1 for r in records]
    if case.startswith("population"):
        assert len(got[0].split("\t")) == 12            # three samples
        assert near(called, sorted(truth["population"])) == sorted(
            truth["population"])
    elif case == "trio_denovos_only":
        assert records and all("DENOVO" in r[7] for r in records)
    else:
        denovo = [int(r[1]) - 1 for r in records if "DENOVO" in r[7]]
        assert near(denovo, sorted(truth["denovo"])) == sorted(truth["denovo"])
    if env:
        scorer = ("pairhmm_lanes_plain" if "OCTOPUS_TPU_UNROLLED_HMM" in env
                  else "pairhmm_plain")
        assert set(la.ROUTING.job_sets) == {("populate", scorer),
                                            ("assignment", scorer)}


class _Stop(Exception):
    pass


@pytest.mark.parametrize("kind", ["trio", "population"])
def test_simulation_writes_the_benchmark_files(tmp_path, monkeypatch, kind):
    """bench_e2e_multi.py builds its BAMs through the reference package;
    the port's simulators must write the same bytes and truth."""
    import bench_e2e_multi
    a, b = tmp_path / "bench", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    monkeypatch.setattr(bench_e2e_multi.tempfile, "mkdtemp", lambda: str(a))

    def stop(fa, bams, out, extra, timeout=3600):
        raise _Stop

    monkeypatch.setattr(bench_e2e_multi, "_run_cli", stop)
    with pytest.raises(_Stop):
        if kind == "trio":
            bench_e2e_multi.bench_trio(kb=8, depth=20, seed=5)
        else:
            bench_e2e_multi.bench_population(kb=8, depth=20, seed=9)
    if kind == "trio":
        fa, bams, *_ = synthetic.simulate_trio(str(b), kb=8, depth=20, seed=5)
    else:
        fa, bams, *_ = synthetic.simulate_population(str(b), kb=8, depth=20,
                                                     seed=9)
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert len([n for n in names if n.endswith(".bam")]) == 3
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name
