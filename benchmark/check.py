"""The comparison that decides `correct`, run once the window has closed.

Four layers, each against its plain reference under `reference/`:

* the pair-HMM answers of the window: a uniform sample, drawn from the
  seed, of at most `probes.HOST_PAIRS` pairs of the host DP's calls and
  `probes.CARD_PAIRS` of the card's launches (`probes.PairSample`, so the
  check's cost does not grow with a launch), with the inputs the
  likelihood layer handed them, scored again by `reference.pairhmm`;
  `hmm_err` is the largest gap in phred units, limit 0, over `hmm_pairs`
  compared pairs. What the capture saw is held against the program's own
  counters (`hmm_unseen`: launches against `pairhmm_batch.KERNEL_COUNTS`,
  card pairs against `likelihood_array.ROUTING.device_pairs`, host-DP
  calls against `ROUTING.host_job_sets`), at least one pair has to be
  compared (`hmm_pairs`), and one of the card's wherever ROUTING sent
  pairs there (`card_unchecked`), so that a scorer the harness no longer
  sees cannot pass unread;
* the VB of the cancer model: a sample, drawn from the seed, of genotype
  rows of the window's `vb_subclone` calls, their log evidence (the best
  ELBO over the seeds) against `reference.vb` in float64 at the iterations
  and seeds the configuration states (`vb_err`, nats); `vb_rows` rows at
  least, and every evaluation `subclone_vb.COUNTS` counted seen
  (`vb_unseen`);
* the individual model's genotype reductions: a sample, drawn from the
  seed, of genotype rows of the window's reductions against
  `reference.germline` in float64, the host's (float64) within 1e-9
  relative and the device's (float32) within the reference's
  `float32_bound`; `gl_err` the largest error over its allowance (limit
  1), `gl_rows` the rows compared, and every reduction
  `genotype_likelihoods.COUNTS` counted seen (`gl_unseen`);
* the records every shard of the window wrote, against the simulated
  truth (`reference.records`): recall, precision, genotype concordance and,
  with a clone, somatic recall, each at or above the configuration's
  floor.

A control puts a reference, in a narrower type, in the program's place in
one layer: "int8" (saturating at 127) the pair-HMM's control, "int16" (the
reference SSE2 kernel's own width, saturating at 16000, exact at these
reads' scores) beside it, "bfloat16" the VB's and the device reductions',
and "float32" the host reductions'.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

import torch

from .reference import germline as ref_germline
from .reference import pairhmm as ref_hmm
from .reference import records as ref_records
from .reference import vb as ref_vb

CONTROLS = {"int16": (np.int16, 16000), "int8": (np.int8, 127)}
VB_CONTROLS = ("bfloat16",)
# control -> whether it takes the device's reductions (else the host's)
GL_CONTROLS = {"float32": False, "bfloat16": True}
GL_HOST_REL = 1e-9
# number -> True where a larger value is better
HIGHER = {"hmm_err": False, "hmm_pairs": True, "hmm_unseen": False,
          "card_unchecked": False, "vb_err": False, "vb_rows": True,
          "vb_unseen": False, "gl_err": False, "gl_rows": True,
          "gl_unseen": False, "recall": True, "precision": True,
          "genotype": True, "somatic_recall": True}


def _as_numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def pairhmm_sample(capture) -> dict:
    """The window's sampled pairs on the host, once it has closed, grouped
    by what the reference takes at once: {"host": {(L, W, pad, nuc): the
    ten arrays and the answers}, "card": {(R, W, pad, nuc): the seven
    tracks and the answers}, "host_calls", "card_calls" (calls with a pair
    in the sample), "card_held_max" (the most rows the capture held on the
    card at once), "card_cuts"}."""
    out = {"host": defaultdict(list), "card": defaultdict(list)}
    host_items, card_items = capture.host.items(), capture.card.items()
    for meta, arrays in host_items:
        out["host"][meta].append([_as_numpy(a) for a in arrays])
    for (pad, nuc), arrays in card_items:
        t = [_as_numpy(a) for a in arrays]
        out["card"][(t[0].shape[1], t[2].shape[1], pad, nuc)].append(t)
    for side in ("host", "card"):
        out[side] = {key: [np.concatenate([c[k] for c in calls])
                           for k in range(len(calls[0]))]
                     for key, calls in out[side].items()}
    out.update(host_calls=len(host_items), card_calls=len(card_items),
               card_held_max=capture.card.held_max, card_cuts=capture.card.cuts)
    return out


def pairhmm_gap(sample: dict, control: str | None = None) -> dict:
    """The widest gap between the sampled answers (or the control's) and
    the reference's, and the pairs and calls compared."""
    control = control if control in CONTROLS else None
    dtype, inf = CONTROLS[control] if control else (None, None)
    worst = top = 0
    host_pairs = card_pairs = 0
    for (L, W, pad, nuc), arrays in sample["host"].items():
        *inputs, got = arrays
        want = ref_hmm.flank_scores(*inputs, pad=pad, nuc_prior=nuc)
        got = (ref_hmm.flank_scores(*inputs, pad=pad, nuc_prior=nuc,
                                    dtype=dtype, inf=inf)
               if control else got.astype(np.int64))
        worst = max(worst, int(np.abs(got - want).max()))
        top = max(top, int(want.max()))
        host_pairs += len(want)
    for (_, _, pad, nuc), arrays in sample["card"].items():
        tracks = [a.astype(np.int32) for a in arrays[:7]]
        want = ref_hmm.banded_scores(*tracks, pad=pad, nuc_prior=nuc)
        got = (ref_hmm.banded_scores(*tracks, pad=pad, nuc_prior=nuc,
                                     dtype=dtype, inf=inf)
               if control else arrays[7].astype(np.int64))
        worst = max(worst, int(np.abs(got - want).max()))
        top = max(top, int(want.max()))
        card_pairs += len(want)
    return {"hmm_err": worst, "host_pairs": host_pairs,
            "host_calls": sample["host_calls"], "card_pairs": card_pairs,
            "card_calls": sample["card_calls"], "max_score": top,
            "card_held_max": sample["card_held_max"],
            "card_cuts": sample["card_cuts"]}


def genotype_errors(lnL, genotypes, got, device: bool,
                    control: str | None = None) -> np.ndarray:
    """Each genotype row's error over its allowance, so that 1 is the
    limit on both sides: lnL (H, R) and genotypes (rows, P) as the program
    was handed them, got (rows,) its answers. A host reduction (float64)
    is allowed 1e-9 of |reference| (of 1 nat where that is less), a device
    one (float32) `reference.germline.float32_bound`. A control puts the
    reference, in the narrower type (GL_CONTROLS), in the program's place
    on its side."""
    want = ref_germline.genotype_log_likelihoods(lnL, genotypes).numpy()
    if device:
        allow = ref_germline.float32_bound(lnL, genotypes).numpy()
    else:
        allow = GL_HOST_REL * np.maximum(np.abs(want), 1.0)
    if GL_CONTROLS.get(control) == device:
        got = ref_germline.genotype_log_likelihoods(
            lnL, genotypes, dtype=getattr(torch, control)).numpy()
    got = np.asarray(got, np.float64)
    with np.errstate(invalid="ignore"):
        gap = np.abs(got - want)
    gap[got == want] = 0.0                      # -inf on both sides
    gap[np.isnan(gap)] = np.inf
    return gap / allow


def genotype_gap(reductions: list, gl_counts, gl_calls: int,
                 control: str | None = None) -> dict:
    """The largest error over its allowance of the sampled genotype rows
    (`Capture.reductions()`), the rows compared, and the reductions that
    `genotype_likelihoods.COUNTS` counted and the capture did not see."""
    worst, rows = 0.0, 0
    for item in reductions:
        if len(item["out"]) == 0:
            continue
        err = genotype_errors(item["lnl"], item["genotypes"], item["out"],
                              item["device"], control)
        worst = max(worst, float(err.max()))
        rows += len(err)
    counted = gl_counts.host + gl_counts.device
    return {"gl_err": worst, "gl_rows": rows,
            "gl_unseen": abs(counted - gl_calls)}


def unseen(capture, kernel_launches: int, routing) -> dict:
    """The program's counts of the window against what the capture saw."""
    parts = {"launches": abs(kernel_launches - capture.card_launches),
             "card_pairs": abs(routing.device_pairs - capture.card_pairs),
             "host_job_sets": abs(routing.host_job_sets - capture.host_dp_calls)}
    return {"hmm_unseen": sum(parts.values()), "parts": parts}


def vb_gap(capture, settings: dict | None, vb_counts,
           control: str | None = None) -> dict:
    """The widest gap, in nats, between the sampled rows' log evidence (or
    the control's) and the reference's, the rows compared and the
    evaluations not seen."""
    rounding = control if control in VB_CONTROLS else None
    worst, rows = 0.0, 0
    for item in capture.vb.items if settings else ():
        kw = dict(iterations=int(settings["iterations"]),
                  n_seeds=int(settings["seeds"]))
        want = ref_vb.log_evidences(item["lnl"], item["alpha0"], **kw)
        got = (ref_vb.log_evidences(item["lnl"], item["alpha0"],
                                    rounding=rounding, **kw)
               if rounding else item["elbo"].max(-1))
        worst = max(worst, float(np.abs(got - want).max()))
        rows += len(want)
    counted = vb_counts.host + vb_counts.device
    return {"vb_err": worst, "vb_rows": rows,
            "vb_unseen": capture.vb_unseen + abs(counted - capture.vb_evaluations)}


def records_shares(called: list, sites: list, reference: np.ndarray) -> tuple:
    """(the compared shares, counts) over the window's shards that
    completed, [(region (begin, end), VCF path)]."""
    records = []
    for _, path in called:
        records.extend(ref_records.read_vcf(path))
    counts = ref_records.compare(records, sites, [region for region, _ in called],
                                 reference)
    return ref_records.shares(counts), dict(counts)


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of every number that has a limit, and
    whether each holds."""
    out = {}
    for name, value in numbers.items():
        limit = limits.get(name)
        if limit is None:
            continue
        holds = value >= limit if HIGHER[name] else value <= limit
        out[name] = {"value": value, "limit": limit, "holds": bool(holds)}
    return out


__all__ = ["pairhmm_sample", "pairhmm_gap", "unseen", "vb_gap",
           "genotype_errors", "genotype_gap", "records_shares", "judge",
           "CONTROLS", "VB_CONTROLS", "GL_CONTROLS", "GL_HOST_REL"]
