"""The comparison has to fail its controls and every fault a cell can have.

The controls put a plain reference, in a narrower type, in the program's
place in one layer: the pair-HMM in int8, saturating at 127 (int16, the
reference SSE2 kernel's own width, is exact at these reads' scores, as a
case here shows), the VB and the device's genotype reductions in bfloat16,
the host's reductions in float32. The faults are planted in the program
underneath a run whose chip look is skipped (`run_cell(device="cpu")`),
at each cell's rehearsal size (`cell.rehearsal_size`): one answer of the
pair-HMM altered where it is produced, on the host DP and on the card's
scorer; the card's scorer wrong on 1% of each launch's rows; one VB answer
altered; a host genotype reduction off by 1e-6 relative, and a device one
(every reduction sent there) off by twice its float32 bound; the card's
scorer, the VB or the reduction reached past the seams the harness
watches; half of the shards' records left out; every record's genotype
altered. A cell on one card has no exchange between chips, and no step
state to leave unchanged. With the pair caps set low the check compares
no more pairs than the caps and still catches a wrong card answer."""

import functools
import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import cell, probes
from benchmark.reference import germline as ref_germline

SPEC = cell.load_spec()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
CAP = 600                   # seconds no rehearsal reaches: each calls its whole pass
SOMATIC = "somatic-t60n30.subclonal"
# the int8 control needs some scores above 127, which at 0.1% errors a
# window's first shard of tumour and normal reads holds
CONTROL_SIZE = {"contig_kb": 40, "shard_kb": 10}


def config_of(workload):
    return cell.load_cell(SPEC, workload)[1]


def reduces(workload):
    """Whether the cell's window reaches the individual model's genotype
    reductions, as its configuration's limits say."""
    return "gl_rows" in config_of(workload)["limits"]


def rehearse(workload, tmp_path, size=None, **kw):
    size = size or cell.rehearsal_size(SPEC, workload)
    return cell.run_cell(workload, 2**31 + 17, CAP, False, device="cpu",
                         traffic_override=size, tmp_root=str(tmp_path), **kw)


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.delenv("OCTOPUS_TPU_HOST_HMM_MAX", raising=False)
    yield
    torch.set_num_threads(threads)


def test_control_fails_and_int16_does_not(tmp_path):
    """At a test's size on the CPU, on one window: the program is correct,
    the int8 and bfloat16 controls are not, and int16 loses nothing."""
    res = rehearse(SOMATIC, tmp_path, CONTROL_SIZE,
                   controls=("int8", "int16", "bfloat16"))
    assert res["correct"], res["checks"]
    controls = res["controls"]
    assert not controls["int8"]["correct"]
    assert controls["int8"]["checks"]["hmm_err"]["value"] > 0
    assert controls["int16"]["checks"]["hmm_err"]["value"] == 0
    assert not controls["bfloat16"]["correct"]
    vb = controls["bfloat16"]["checks"]["vb_err"]
    assert vb["value"] > vb["limit"]


def altered_host_dp(monkeypatch):
    from octopus_tpu_torch._build import load_native
    native = load_native()
    flank = native.flank_banded_scores

    def wrong(*args):
        raw = bytearray(flank(*args))
        raw[0] ^= 1                     # the first answer, off by one
        return bytes(raw)

    monkeypatch.setattr(native, "flank_banded_scores", wrong)


def altered_card_scorer(monkeypatch):
    from octopus_tpu_torch.core.likelihood import pairhmm_batch
    monkeypatch.setenv("OCTOPUS_TPU_HOST_HMM_MAX", "0")   # every job set to the scorer
    scores = pairhmm_batch.pairhmm_scores_plain            # the card's twin here

    def wrong(*args, **kw):
        out = scores(*args, **kw).clone()
        out[0] += 1
        return out

    monkeypatch.setattr(pairhmm_batch, "pairhmm_scores_plain", wrong)


def card_rows_wrong(monkeypatch):
    """1% of each launch's rows (one at least) off by one, at rows drawn
    from a stream of the test's own, not the check's."""
    from octopus_tpu_torch.core.likelihood import pairhmm_batch
    monkeypatch.setenv("OCTOPUS_TPU_HOST_HMM_MAX", "0")
    scores = pairhmm_batch.pairhmm_scores_plain
    rng = np.random.default_rng(99)

    def wrong(*args, **kw):
        out = scores(*args, **kw).clone()
        B = len(out)
        rows = rng.choice(B, math.ceil(B / 100), replace=False)
        out[torch.from_numpy(rows)] += 1
        return out

    monkeypatch.setattr(pairhmm_batch, "pairhmm_scores_plain", wrong)


def hidden_card_scorer(monkeypatch):
    """The likelihood layer reaches the scorer by another name, which the
    harness does not watch: the scores are right, and unseen."""
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.core.likelihood import pairhmm_batch
    monkeypatch.setenv("OCTOPUS_TPU_HOST_HMM_MAX", "0")
    plain = pairhmm_batch.pairhmm_scores_plain

    def other(*tracks, pad=8, nuc_prior=2, device=None):
        return plain(*(torch.as_tensor(t) for t in tracks), pad=pad,
                     nuc_prior=nuc_prior)

    monkeypatch.setattr(la, "pairhmm_scores", other)


def altered_vb(monkeypatch):
    from octopus_tpu_torch.core.models import subclone_vb
    engine = subclone_vb.vb_subclone

    def wrong(*args, **kw):
        elbo, alpha, resp = engine(*args, **kw)
        return elbo + 1.0, alpha, resp                  # one nat on every row

    monkeypatch.setattr(subclone_vb, "vb_subclone", wrong)


def hidden_vb(monkeypatch):
    """The model reaches the VB engine by another name."""
    from octopus_tpu_torch.core.models import subclone_vb
    engine = subclone_vb.vb_subclone
    evaluate = subclone_vb.SubcloneModel.evaluate

    def other(self, *args, **kw):
        saved = subclone_vb.vb_subclone
        subclone_vb.vb_subclone = engine
        try:
            return evaluate(self, *args, **kw)
        finally:
            subclone_vb.vb_subclone = saved

    monkeypatch.setattr(subclone_vb.SubcloneModel, "evaluate", other)


def host_reduction_off(monkeypatch):
    """Every host genotype reduction's answer off by 1e-6 relative."""
    from octopus_tpu_torch.core.models import genotype_likelihoods as gl
    reduce_np = gl.genotype_log_likelihoods_np

    def wrong(*args, **kw):
        return reduce_np(*args, **kw) * (1 + 1e-6)

    monkeypatch.setattr(gl, "genotype_log_likelihoods_np", wrong)


def device_reduction_off(monkeypatch):
    """Every reduction sent to the device path (float32; on a CPU its
    own), and each answer off by twice the reference's float32 bound."""
    from octopus_tpu_torch.core.models import genotype_likelihoods as gl
    reduce_torch = gl.genotype_log_likelihoods_torch
    monkeypatch.setattr(gl, "HOST_GATE", 0)

    def wrong(lnL, counts, ploidy):
        out = reduce_torch(lnL, counts, ploidy)
        genotypes = probes.counts_genotypes(counts.cpu().numpy())
        bound = ref_germline.float32_bound(lnL.double().cpu(), genotypes)
        return out - (2 * bound).to(out)

    monkeypatch.setattr(gl, "genotype_log_likelihoods_torch", wrong)


def hidden_reduction(monkeypatch):
    """The individual model reaches every second host reduction by another
    name, and counts it as its own would: the answers are right, the
    others are seen, and these are not."""
    from octopus_tpu_torch.core.models import genotype_likelihoods as gl
    from octopus_tpu_torch.core.models import individual
    reduce_np, reduce = gl.genotype_log_likelihoods_np, individual.genotype_log_likelihoods
    calls = [0]

    def other(lnL, genotypes, use_device=True, device="cuda"):
        calls[0] += 1
        if calls[0] % 2:
            return reduce(lnL, genotypes, use_device=use_device, device=device)
        gl.COUNTS.host += 1
        return reduce_np(lnL, genotypes)

    monkeypatch.setattr(individual, "genotype_log_likelihoods", other)


def shard_outputs(monkeypatch, edit):
    """Run `edit(path, index)` on every shard's VCF once it is written."""
    from octopus_tpu_torch import run as program
    run_calling = program.run_calling
    calls = [0]

    def edited(args):
        code = run_calling(args)
        calls[0] += 1
        edit(args.output, calls[0])
        return code

    monkeypatch.setattr(program, "run_calling", edited)


def half_left_out(monkeypatch):
    def drop(path, k):
        if k % 2 == 0:
            with open(path) as fh:
                head = [l for l in fh if l.startswith("#")]
            with open(path, "w") as fh:
                fh.writelines(head)
    shard_outputs(monkeypatch, drop)


def genotypes_altered(monkeypatch):
    def flip(path, k):
        with open(path) as fh:
            lines = fh.readlines()
        out = []
        for line in lines:
            if not line.startswith("#"):
                f = line.rstrip("\n").split("\t")
                for j in range(9, len(f)):
                    gt, _, rest = f[j].partition(":")
                    sep = "|" if "|" in gt else "/"
                    a = gt.split(sep)
                    new = "1" + sep + "1" if a.count("0") else "0" + sep + "1"
                    f[j] = new + (":" + rest if rest else "")
                line = "\t".join(f) + "\n"
            out.append(line)
        with open(path, "w") as fh:
            fh.writelines(out)
    shard_outputs(monkeypatch, flip)


FAULTS = {"host_dp_answer": altered_host_dp, "card_answer": altered_card_scorer,
          "card_rows_1pct": card_rows_wrong,
          "hidden_card_scorer": hidden_card_scorer,
          "half_the_shards": half_left_out, "genotypes": genotypes_altered}
VB_FAULTS = {"vb_answer": altered_vb, "hidden_vb": hidden_vb}
GL_FAULTS = {"host_reduction": host_reduction_off,
             "device_reduction": device_reduction_off,
             "hidden_reduction": hidden_reduction}
CASES = [(w, f) for w in WORKLOADS for f in FAULTS] + \
    [(w, f) for w in WORKLOADS if w == SOMATIC for f in VB_FAULTS] + \
    [(w, f) for w in WORKLOADS if reduces(w) for f in GL_FAULTS]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault, tmp_path, monkeypatch):
    {**FAULTS, **VB_FAULTS, **GL_FAULTS}[fault](monkeypatch)
    res = rehearse(workload, tmp_path)
    assert not res["correct"], res["checks"]


def test_sound_run_is_correct(tmp_path):
    res = rehearse(WORKLOADS[0], tmp_path)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("workload", [w for w in WORKLOADS if reduces(w)])
def test_device_reductions_are_correct(workload, tmp_path, monkeypatch):
    """Every reduction sent to the device path (on a CPU its float32 twin):
    the rows compared are the device's, and each lies within its bound;
    the bfloat16 control, in their place, does not."""
    from octopus_tpu_torch.core.models import genotype_likelihoods as gl
    monkeypatch.setattr(gl, "HOST_GATE", 0)
    res = rehearse(workload, tmp_path, controls=("bfloat16", "float32"))
    assert res["correct"], res["checks"]
    assert res["checks"]["gl_rows"]["value"] >= 1
    assert res["checks"]["gl_err"]["value"] <= 1
    control = res["controls"]["bfloat16"]
    assert not control["correct"] and control["checks"]["gl_err"]["value"] > 1
    # no host reduction ran, so the host's control has nothing to replace
    assert res["controls"]["float32"]["checks"]["gl_err"]["value"] <= 1


@pytest.mark.parametrize("workload", [w for w in WORKLOADS if reduces(w)])
def test_host_reduction_control_fails(workload, tmp_path):
    """The host's reductions are within 1e-9 relative of the reference;
    the reference in float32, in their place, is not."""
    res = rehearse(workload, tmp_path, controls=("float32",))
    assert res["correct"], res["checks"]
    assert res["checks"]["gl_err"]["value"] < 1e-3
    control = res["controls"]["float32"]
    assert not control["correct"] and control["checks"]["gl_err"]["value"] > 1


LOW_CAPS = 256
CHECK_CPU_S = 20            # the check of a low-cap rehearsal, on one CPU core


def test_check_is_bounded_by_the_pair_caps(tmp_path, monkeypatch):
    """The germline cell with every job set on the card's scorer and the
    pair caps at 256: the window scores more pairs than the caps, the check
    compares no more than the caps, stays under CHECK_CPU_S seconds, and
    still catches one wrong answer a launch (`card_answer`: at this size
    one pair in ~23 is wrong, so 256 sampled pairs miss them all with a
    chance of ~1e-5). `test_bench_sample.py` holds the sample itself to
    launches each larger than the cap."""
    workload = "germline-illumina35x.wgs"
    monkeypatch.setattr(probes, "Capture", functools.partial(
        probes.Capture, host_pairs=LOW_CAPS, card_pairs_kept=LOW_CAPS))
    import contextlib
    import io
    log = io.StringIO()
    altered_card_scorer(monkeypatch)
    with contextlib.redirect_stderr(log):
        res = rehearse(workload, tmp_path)
    window = next(json.loads(line)["window"] for line in log.getvalue().splitlines()
                  if line.startswith('{"window"'))
    assert window["card_pairs"] > LOW_CAPS
    assert res["checks"]["hmm_pairs"]["value"] <= 2 * LOW_CAPS
    assert window["checked"]["card_pairs"] == LOW_CAPS
    assert window["checked"]["card_held_max"] <= 4 * LOW_CAPS
    assert window["check_s"] < CHECK_CPU_S
    assert not res["correct"], res["checks"]


CARD = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import cell
res = cell.run_cell({workload!r}, {seed}, {seconds}, False, controls={controls!r},
                    traffic_override={override!r}, tmp_root={tmp!r})
print(json.dumps({{"correct": res["correct"], "checks": res["checks"],
                  "pass_complete": res["pass_complete"],
                  "controls": res.get("controls", {{}})}}))
"""


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_on_the_card(workload, tmp_path):
    """At the cell's own size and load, on three seeds: the program is
    correct and each control is not, on the window a run measures, one
    process a seed as the benchmark runs it (the readings print). One
    process a seed, and not three windows in one, because the program's
    card VB runs out of memory in the third (PERF.md, first open question;
    `test_window_of_seed_drawn_reads_on_the_card`): once that is mended,
    three windows in one process can be held here again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    controls = ("int8",) + (("bfloat16",) if "vb" in config_of(workload) else ()) \
        + (("float32",) if reduces(workload) else ())
    for seed in (2**31 + 201, 2**31 + 202, 2**31 + 203):
        code = CARD.format(root=str(cell.ROOT), workload=workload, seed=seed,
                           seconds=SPEC["run_seconds"], controls=controls,
                           override=None, tmp=str(tmp_path))
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=600, cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(workload, seed, "program", json.dumps(res["checks"]))
        for name, control in res["controls"].items():
            print(workload, seed, name, json.dumps(control["checks"]))
        assert res["correct"]
        assert not any(c["correct"] for c in res["controls"].values())


def test_window_of_seed_drawn_reads_on_the_card(tmp_path):
    """One window of the tumour cell in a process of its own, as a run
    measures it, over reads drawn from the seed (`reads_from_seed`) on a
    300 kb contig, seed 2,180,000,106: the pass completes and is correct.
    It fails on the card while a fault of the program stands (PERF.md,
    first open question): the card's VB runs out of memory in CUDA Graphs'
    private pools at shard 220-230 kb, after the shards before it, though
    that shard alone runs. The benchmark's traffic fixes its reads and
    does not reach this draw, so this test is where the fault shows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code = CARD.format(root=str(cell.ROOT), workload=SOMATIC, seed=2_180_000_106,
                       seconds=600, controls=(),
                       override={"contig_kb": 300, "reads_from_seed": True},
                       tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    print(SOMATIC, "reads from the seed", json.dumps(res["checks"]))
    assert res["pass_complete"] and res["correct"]
