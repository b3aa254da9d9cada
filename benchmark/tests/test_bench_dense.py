"""The dense germline cell (`germline-mhc35x.dense`) and its readers.

A traced rehearsal of the cell on the CPU at its traffic's `rehearsal`
size reaches, at the program's own gates, what the cell exists for: the
stateful haplotype generator (its packets, in the `hapgen_tree` phase),
its pruning rounds, populate's job sets above the host-DP gate on the
card's scorer, and a genotype reduction on the device path (float32; on a
CPU its own twin) in the `genotype_card` phase, compared by the check; on
the same window the int8, float32 and bfloat16 controls are not correct.
Every per-layer metric the cell lists is read, but those of the card's
trace, which a CPU has not. The new readers return None on a program without
their counters, and the GEMM's roofline share is the frozen yardstick of
`roofline_genotype.py` over the profiler's GEMM kernel time."""

import contextlib
import io
import json
import types

import pytest

from benchmark import cell, devtrace, roofline_genotype

SPEC = cell.load_spec()
WORKLOAD = "germline-mhc35x.dense"
CAP = 600                   # seconds no rehearsal reaches: it calls its whole pass
DEVICE_READERS = {"device_idle_pct", "pairhmm_roofline_pct",
                  "genotype_gemm_roofline_pct"}
CONTROLS = ("int8", "float32", "bfloat16")
NEW_READERS = ("hapgen_tree_s_per_mb", "prune_rounds_per_mb",
               "genotype_card_s_per_mb", "card_reductions_per_mb",
               "genotype_gemm_roofline_pct")


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """(result line, window log, generator packets, pruning rounds, card
    reduction sums) of one traced rehearsal on the CPU, with CONTROLS."""
    from octopus_tpu_torch.core.likelihood import likelihood_array

    log = io.StringIO()
    mp = pytest.MonkeyPatch()
    mp.delenv("OCTOPUS_TPU_HOST_HMM_MAX", raising=False)
    try:
        with contextlib.redirect_stderr(log):
            res = cell.run_cell(WORKLOAD, 2**31 + 5, CAP, True, device="cpu",
                                traffic_override=cell.rehearsal_size(SPEC, WORKLOAD),
                                tmp_root=str(tmp_path_factory.mktemp("dense")),
                                controls=CONTROLS)
    finally:
        mp.undo()
    window = next(json.loads(line)["window"] for line in log.getvalue().splitlines()
                  if line.startswith('{"window"'))
    routing = likelihood_array.ROUTING
    return (res, window, routing.hapgen_packets, routing.prune_rounds,
            dict(routing.card_reductions))


def test_traffic_carries_its_rehearsal():
    traffic = cell.load_cell(SPEC, WORKLOAD)[2]
    size = cell.rehearsal_size(SPEC, WORKLOAD)
    assert size == traffic["rehearsal"] != cell.REHEARSAL


def test_rehearsal_reaches_the_generator_card_job_sets_and_a_device_reduction(
        rehearsal):
    res, window, packets, rounds, sums = rehearsal
    assert res["correct"], res["checks"]
    assert res["pass_complete"]
    assert packets >= 1 and rounds >= 1
    # populate's job sets above the host-DP gate went to the card's scorer
    assert window["card_job_sets"] >= 1
    assert window["card_pairs"] > 384 * window["card_job_sets"]
    # a float32 reduction on the device path, seen and compared
    assert window["genotype"]["device"] >= 1
    assert window["genotype_kept"]["device"] >= 1
    assert res["checks"]["gl_rows"]["value"] >= 1
    assert sums["ghr"] >= window["genotype"]["device"] * 10**6


def test_controls_are_not_correct(rehearsal):
    """The pair-HMM in int8, the host reductions in float32 and the
    device's in bfloat16, each in the program's place on the window: none
    is correct, while the program, whose device reductions run in float32,
    holds gl_err within its limit."""
    res = rehearsal[0]
    assert res["checks"]["gl_err"]["value"] <= 1
    controls = res["controls"]
    assert controls["int8"]["checks"]["hmm_err"]["value"] > 0
    for name in ("float32", "bfloat16"):
        assert controls[name]["checks"]["gl_err"]["value"] > 1, name
    assert not any(c["correct"] for c in controls.values())


def test_rehearsal_reads_every_metric_but_the_cards(rehearsal):
    res, window, packets, rounds, _ = rehearsal
    wanted = {m["name"] for m in cell.metrics_of(SPEC, "per_layer", WORKLOAD)}
    assert set(res["metrics"]) == wanted - DEVICE_READERS
    values = {k: v["value"] for k, v in res["metrics"].items()}
    called_mb = window["called_kb"] / 1e3
    for name in NEW_READERS[:4]:
        assert values[name] > 0, name
    assert values["prune_rounds_per_mb"] == pytest.approx(rounds / called_mb)
    assert values["card_reductions_per_mb"] == pytest.approx(
        window["genotype"]["device"] / called_mb)


def reading(called_mb=0.5, device=None, self_s=None):
    return cell.Reading(self_s=self_s or {}, called_mb=called_mb, window_s=1.0,
                        device=device, launches=[], routing={},
                        kernel_launches=0)


def test_new_readers_return_none_without_the_programs_counters(monkeypatch):
    from octopus_tpu_torch.core import likelihood, models
    from octopus_tpu_torch.core.likelihood import likelihood_array
    from octopus_tpu_torch.core.models import genotype_likelihoods

    readers = {name: cell.load_reader(name) for name in NEW_READERS}
    r = reading(self_s={"hapgen_tree": 2.0, "genotype_card": 1.0})
    monkeypatch.setattr(likelihood_array, "ROUTING", types.SimpleNamespace(
        hapgen_packets=4, prune_rounds=6, card_reductions={}))
    monkeypatch.setattr(genotype_likelihoods, "COUNTS",
                        types.SimpleNamespace(host=1, device=3))
    assert readers["hapgen_tree_s_per_mb"](r) == 4.0
    assert readers["prune_rounds_per_mb"](r) == 12.0
    assert readers["genotype_card_s_per_mb"](r) == 2.0
    assert readers["card_reductions_per_mb"](r) == 6.0
    assert readers["genotype_gemm_roofline_pct"](r) is None
    # a program that has the counters and did not enter the phases reads 0
    assert readers["hapgen_tree_s_per_mb"](reading()) == 0.0
    assert readers["genotype_card_s_per_mb"](reading()) == 0.0
    # the counters' owners as a program without them has them
    monkeypatch.setattr(likelihood_array, "ROUTING", types.SimpleNamespace())
    monkeypatch.setattr(genotype_likelihoods, "COUNTS", types.SimpleNamespace())
    assert all(read(r) is None for read in readers.values())
    monkeypatch.setattr(models, "genotype_likelihoods",
                        types.ModuleType("genotype_likelihoods"))
    monkeypatch.setattr(likelihood, "likelihood_array",
                        types.ModuleType("likelihood_array"))
    assert all(read(r) is None for read in readers.values())


def test_gemm_yardstick():
    # G 20,100 genotypes of H 200 haplotypes over R 500 reads: operations bind
    G, H, R = 20_100, 200, 500
    seconds, binds = roofline_genotype.gemm_least_seconds(
        G * H * R, G * H, H * R, G * R)
    assert binds == "operations"
    assert seconds == pytest.approx(2 * G * H * R / 67e12)
    # a thin product binds on bytes
    assert roofline_genotype.gemm_least_seconds(3 * 2 * 8, 6, 16, 24)[1] == "bytes"
    # the least time of summed shapes is no more than the sum of each's
    shapes = [(G, H, R), (3, 2, 10**6), (10, 4, 40)]
    each = sum(roofline_genotype.gemm_least_seconds(g * h * r, g * h, h * r,
                                                    g * r)[0]
               for g, h, r in shapes)
    summed = roofline_genotype.gemm_least_seconds(
        *(sum(f(g, h, r) for g, h, r in shapes) for f in (
            lambda g, h, r: g * h * r, lambda g, h, r: g * h,
            lambda g, h, r: h * r, lambda g, h, r: g * r)))[0]
    assert summed <= each


def test_gemm_roofline_reads_the_gemm_kernels_only(monkeypatch):
    from octopus_tpu_torch.core.likelihood import likelihood_array

    gemm = ("void sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_"
            "warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas(args)")
    ops = [(gemm, 0, 2_000_000), ("void pairhmm_kernel<32, 4>(int)", 0, 9_000_000),
           ("Memcpy HtoD (Pageable -> Device)", 0, 5_000_000)]
    trace = devtrace.DeviceTrace(ops=ops, window=(0, 10_000_000))
    G, H, R = 20_100, 200, 500
    sums = {"ghr": G * H * R, "gh": G * H, "hr": H * R, "gr": G * R}
    monkeypatch.setattr(likelihood_array, "ROUTING",
                        types.SimpleNamespace(card_reductions=sums))
    read = cell.load_reader("genotype_gemm_roofline_pct")
    least = roofline_genotype.gemm_least_seconds(*sums.values())[0]
    assert read(reading(device=trace)) == pytest.approx(100 * least / 2e-3)
    assert read(reading(device=None)) is None
    no_gemm = devtrace.DeviceTrace(ops=ops[1:], window=(0, 10_000_000))
    assert read(reading(device=no_gemm)) is None
