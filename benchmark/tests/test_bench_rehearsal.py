"""A tiny rehearsal of each cell on the CPU at its rehearsal size
(`cell.rehearsal_size`), in a process of its own: the harness's whole path
(inputs, warm-up, a whole pass under a cap it does not reach, check,
readers) runs, comes out correct with its pass complete, and leaves no
module of JAX or of the JAX package loaded (top-level names compared
whole)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import cell

SPEC = cell.load_spec()
CODE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import cell
res = cell.run_cell({workload!r}, 2**31 + 3, 300, {trace}, device="cpu",
                    traffic_override={size!r}, tmp_root={tmp!r})
print(json.dumps({{"found": cell.forbidden_modules(), "correct": res["correct"],
                  "pass_complete": res["pass_complete"],
                  "metrics": sorted(res["metrics"]), "checks": res["checks"]}}))
"""


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_rehearsal_on_the_cpu(workload, trace, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("OCTOPUS_TPU_HOST_HMM_MAX", None)
    out = subprocess.run(
        [sys.executable, "-c", CODE.format(
            root=str(cell.ROOT), workload=workload, trace=trace, tmp=str(tmp_path),
            size=cell.rehearsal_size(SPEC, workload))],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["found"] == []
    assert res["correct"], res["checks"]
    assert res["pass_complete"]
    kind = "per_layer" if trace else "end_to_end"
    wanted = {m["name"] for m in cell.metrics_of(SPEC, kind, workload)}
    if trace:
        # the card's readers find nothing to read on the CPU
        wanted -= {"device_idle_pct", "pairhmm_roofline_pct"}
    assert wanted <= set(res["metrics"])
