"""The comparison that decides `correct`, run once the window has closed.

Three layers, each against its plain reference under `reference/`:

* the pair-HMM answers of the window: a sample, drawn from the seed, of
  the host DP's calls and of the card's launches, with the inputs the
  likelihood layer handed them, scored again by `reference.pairhmm`;
  `hmm_err` is the largest gap in phred units, limit 0. What the capture
  saw is held against the program's own counters (`hmm_unseen`: launches
  against `pairhmm_batch.KERNEL_COUNTS`, card pairs against
  `likelihood_array.ROUTING.device_pairs`, host-DP calls against
  `ROUTING.host_job_sets`), at least one pair has to be compared
  (`hmm_pairs`), and one of the card's wherever ROUTING sent pairs there
  (`card_unchecked`), so that a scorer the harness no longer sees cannot
  pass unread;
* the VB of the cancer model: a sample, drawn from the seed, of genotype
  rows of the window's `vb_subclone` calls, their log evidence (the best
  ELBO over the seeds) against `reference.vb` in float64 at the iterations
  and seeds the configuration states (`vb_err`, nats); `vb_rows` rows at
  least, and every evaluation `subclone_vb.COUNTS` counted seen
  (`vb_unseen`);
* the records every shard of the window wrote, against the simulated
  truth (`reference.records`): recall, precision, genotype concordance and,
  with a clone, somatic recall, each at or above the configuration's
  floor.

A control puts a reference, in a narrower type, in the program's place in
one layer: "int8" (saturating at 127) the pair-HMM's control, "int16" (the
reference SSE2 kernel's own width, saturating at 16000, exact at these
reads' scores) beside it, and "bfloat16" the VB's.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .reference import pairhmm as ref_hmm
from .reference import records as ref_records
from .reference import vb as ref_vb

CONTROLS = {"int16": (np.int16, 16000), "int8": (np.int8, 127)}
VB_CONTROLS = ("bfloat16",)
# number -> True where a larger value is better
HIGHER = {"hmm_err": False, "hmm_pairs": True, "hmm_unseen": False,
          "card_unchecked": False, "vb_err": False, "vb_rows": True,
          "vb_unseen": False, "recall": True, "precision": True,
          "genotype": True, "somatic_recall": True}


def _as_numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def pairhmm_gap(capture, control: str | None = None) -> dict:
    """The widest gap between the sampled answers (or the control's) and
    the reference's, and the pairs and calls compared."""
    control = control if control in CONTROLS else None
    dtype, inf = CONTROLS[control] if control else (None, None)
    worst = top = 0
    host_groups: dict = defaultdict(list)
    for args, raw in capture.host.items:
        n, L, W, pad, nuc = args[:5]
        host_groups[(L, W, pad, nuc)].append(
            (args[5:], np.frombuffer(raw, np.int32)))
    host_pairs = 0
    for (L, W, pad, nuc), calls in host_groups.items():
        arrays = [np.concatenate([c[0][k] for c in calls]) for k in range(10)]
        arrays = [a.reshape(-1, L) if k < 2 else
                  a.reshape(-1, W) if k < 7 else a for k, a in enumerate(arrays)]
        got = np.concatenate([c[1] for c in calls]).astype(np.int64)
        want = ref_hmm.flank_scores(*arrays, pad=pad, nuc_prior=nuc)
        if control:
            got = ref_hmm.flank_scores(*arrays, pad=pad, nuc_prior=nuc,
                                       dtype=dtype, inf=inf)
        worst = max(worst, int(np.abs(got - want).max()))
        top = max(top, int(want.max()))
        host_pairs += len(want)
    card_groups: dict = defaultdict(list)
    for tracks, pad, nuc, out in capture.card.items:
        t = [_as_numpy(a).astype(np.int32) for a in tracks]
        card_groups[(t[0].shape[1], t[2].shape[1], pad, nuc)].append(
            (t, _as_numpy(out).astype(np.int64)))
    card_pairs = 0
    for (_, _, pad, nuc), calls in card_groups.items():
        tracks = [np.concatenate([c[0][k] for c in calls]) for k in range(7)]
        got = np.concatenate([c[1] for c in calls])
        want = ref_hmm.banded_scores(*tracks, pad=pad, nuc_prior=nuc)
        if control:
            got = ref_hmm.banded_scores(*tracks, pad=pad, nuc_prior=nuc,
                                        dtype=dtype, inf=inf)
        worst = max(worst, int(np.abs(got - want).max()))
        top = max(top, int(want.max()))
        card_pairs += len(want)
    return {"hmm_err": worst, "host_pairs": host_pairs,
            "host_calls": len(capture.host.items), "card_pairs": card_pairs,
            "card_calls": len(capture.card.items), "max_score": top}


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


__all__ = ["pairhmm_gap", "unseen", "vb_gap", "records_shares", "judge",
           "CONTROLS", "VB_CONTROLS"]
