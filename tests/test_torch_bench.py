"""octopus_tpu_torch.bench against the reference repository's bench.py, on
the CPU: the bench's inputs, drawn by a seeded torch.Generator over the
reference's ranges at small B, go through the scorer the port's bench times
(kernel #1's plain twin on CPU tensors; #3's under OCTOPUS_TPU_UNROLLED_HMM
=1), and the scores equal the reference package's pairhmm_scores_xla on the
same arrays bit for bit. main with --device cpu prints the original's keys;
`detail` adds the H100 bound's and nulls the TPU ceilings.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from octopus_tpu.core.likelihood.pairhmm_batch import pairhmm_scores_xla
from octopus_tpu_torch import bench
from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb

ROOT = Path(__file__).resolve().parent.parent
BOUND_KEYS = {"bound_ms", "bound_by", "bound_pairs_per_s", "fraction_of_bound"}
TPU_KEYS = ("speed_of_light_gcups_est", "fraction_of_sol",
            "measured_issue_ceiling_gcups", "fraction_of_issue_ceiling")


@pytest.mark.parametrize("unrolled", [False, True])
@pytest.mark.parametrize("B", [1, 37, 256])
def test_bench_scores_equal_xla(monkeypatch, B, unrolled):
    if unrolled:
        monkeypatch.setenv("OCTOPUS_TPU_UNROLLED_HMM", "1")
    else:
        monkeypatch.delenv("OCTOPUS_TPU_UNROLLED_HMM", raising=False)
    dev = torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(bench.SEED + B)
    tracks = bench.bench_inputs(B, dev, gen)
    W = bench.R + 2 * bench.PAD - 1
    assert [tuple(t.shape) for t in tracks] == [(B, bench.R)] * 2 + [(B, W)] * 5
    assert pb.scorer_name(dev) == ("pairhmm_lanes_plain" if unrolled
                                   else "pairhmm_plain")
    got = pb._scorer(dev)(*tracks, pad=bench.PAD).numpy()
    want = np.asarray(pairhmm_scores_xla(*(t.numpy() for t in tracks),
                                         pad=bench.PAD))
    np.testing.assert_array_equal(got, want)


def original_keys():
    """(top-level keys, detail keys) of the line the original prints."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    dump = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")
    top = dump.args[0]
    detail = next(v for k, v in zip(top.keys, top.values)
                  if k.value == "detail")
    return {k.value for k in top.keys}, {k.value for k in detail.keys}


def test_main_prints_the_originals_keys(capsys):
    assert bench.main(["--device", "cpu", "--batches", "4,8",
                       "--reps", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    top, detail = original_keys()
    assert set(line) == top
    assert set(line["detail"]) == detail | BOUND_KEYS
    assert all(line["detail"][k] is None for k in TPU_KEYS)
    d = line["detail"]
    assert d["kernel"] == "pairhmm_plain" and d["backend"] == "cpu"
    assert line["value"] > 0 and d["bound_by"] == "operations"
    assert d["bound_ms"] == pb.pairhmm_bound(8, bench.R, bench.PAD)[0]
    # the prebuilt reference SSE2 bench runs on this host
    assert line["vs_baseline"] is not None


def test_bound_is_the_chip_smoke_formula():
    """pairhmm_bound at the bench shape: 14 int32 ops a cell, plus 6 a lane
    for row 0 and the band minimum, over 132 x 64 x 1.98e9 ops/s."""
    ms, by = pb.pairhmm_bound(65536, 150, 8)
    assert by == "operations"
    assert ms == (14 * 150 + 6) * 16 * 65536 / (132 * 64 * 1.98e9) * 1e3
