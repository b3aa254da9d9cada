"""The port stands alone: it imports neither JAX nor the reference package,
nor the reference's kernel experiments (experiments/).

An AST scan covers every module of octopus_tpu_torch (kernel_experiments/
included) and chip_smoke.py; a subprocess runs a small port call, loads the
forest, training and clustering CSR, the standalone CSR, the evidence-BAM
realigner, the CRAM modules and the kernel experiments' ports (running the
int16 probe's plain version), and then inspects sys.modules.

The host extension is one requirement of the whole port, decided in
_build.py: no other module tests it for truth or probes it, and a CPU run
without it fails at start-up with the build error.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "octopus_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "octopus_tpu", "experiments")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_forbidden_imports():
    bad = []
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {m}" for m in names
                    if _forbidden(m)]
    assert len(PORT_FILES) > 40
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"octopus_tpu_torch/{m}.py" for m in NEW_MODULES} <= names
    assert not bad, bad


# the modules of the last slices, which the probe also loads
NEW_MODULES = ("core/csr/random_forest", "core/csr/training",
               "core/csr/clustering", "csr_run", "core/tools/bam_realigner",
               "io/cram", "io/cram_writer", "io/rans",
               "kernel_experiments/_common", "kernel_experiments/dual_chain",
               "kernel_experiments/v10_kernel", "kernel_experiments/v11_kernel",
               "kernel_experiments/v13_unroll2",
               "kernel_experiments/i16_probe")


PROBE = r"""
import sys
import numpy as np
from octopus_tpu_torch.basics.reads import make_read_batch
from octopus_tpu_torch.core.callers.base import BaseCallerConfig
from octopus_tpu_torch.core.callers.individual import IndividualCaller
from octopus_tpu_torch.core.likelihood.pairhmm_batch import pairhmm_scores
from octopus_tpu_torch.core.tools.vcf_record_factory import site_call_to_record
from octopus_tpu_torch.io.fasta import InMemoryReference, ReferenceGenome
from octopus_tpu_torch.utils.synthetic import simulate_diploid_reads

seq, reads, truth, n = simulate_diploid_reads(kb=3, seed=3, spacing=(300, 600))
ref = ReferenceGenome(InMemoryReference({"chr1": seq}))
batch = make_read_batch("chr1", reads).sorted_by_begin()
calls = IndividualCaller(ref, "chr1", BaseCallerConfig(device="cpu")).call(
    0, n, batch)
lines = [site_call_to_record(c, "chr1", ref).to_line() for c in calls]
z = np.zeros((2, 8), np.int32)
w = np.zeros((2, 23), np.int32)
pairhmm_scores(z, z, w, w, w, w, w, pad=8, device="cpu")
assert lines, "no calls"
import importlib
for m in ("core.csr.random_forest", "core.csr.training", "core.csr.clustering",
          "csr_run", "core.tools.bam_realigner", "io.cram", "io.cram_writer",
          "io.rans", "kernel_experiments.dual_chain",
          "kernel_experiments.v10_kernel", "kernel_experiments.v11_kernel",
          "kernel_experiments.v13_unroll2", "kernel_experiments.i16_probe"):
    importlib.import_module("octopus_tpu_torch." + m)
from octopus_tpu_torch.kernel_experiments import i16_probe
assert int(i16_probe.probe(device="cpu")[0, 0]) == 51
from octopus_tpu_torch.core.csr.random_forest import Forest
from octopus_tpu_torch.io import rans
forest = Forest.load("resources/forests/germline.npz")
assert forest.predict_proba(np.zeros((2, len(forest.measures)))).shape == (2,)
assert rans.uncompress(rans.compress(b"ACGT" * 50, 1)) == b"ACGT" * 50
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib") or m.startswith(("jax.", "jaxlib."))
                or m == "octopus_tpu" or m.startswith("octopus_tpu.")
                or m == "experiments" or m.startswith("experiments."))
print("LEAKED", leaked)
print("NATIVE", "octopus_tpu_torch._native" in sys.modules)
"""


def test_port_run_loads_no_jax_and_no_reference_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout, proc.stdout
    assert "NATIVE True" in proc.stdout, proc.stdout


def _extension_probes(tree: ast.AST) -> list[int]:
    """Lines that test the host extension for truth, compare it with None,
    probe it with hasattr, or call load_native (which returns None where
    the build failed)."""
    ext = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.ImportFrom)
                and (node.module or "").split(".")[-1] == "_build"):
            ext |= {a.asname or a.name for a in node.names
                    if a.name in ("NATIVE", "load_native", "require_native")}

    def is_ext(expr):
        if isinstance(expr, ast.Call):
            expr = expr.func
        return isinstance(expr, ast.Name) and expr.id in ext

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and is_ext(node.value):
            ext |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    lines = []
    for node in ast.walk(tree):
        tests = []
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            tests.append(node.test)
        elif isinstance(node, ast.BoolOp):
            tests += node.values
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            tests.append(node.operand)
        elif isinstance(node, ast.Compare):
            tests += [node.left, *node.comparators]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id in ("hasattr", "getattr", "bool")
              and node.args):
            tests.append(node.args[0])
        elif isinstance(node, ast.Name) and node.id == "load_native":
            lines.append(node.lineno)
        lines += [node.lineno for t in tests if is_ext(t)]
    return sorted(set(lines))


def test_only_build_decides_whether_the_extension_is_there():
    found = {}
    for path in sorted((ROOT / "octopus_tpu_torch").rglob("*.py")):
        if path.name == "_build.py":
            continue
        lines = _extension_probes(ast.parse(path.read_text()))
        if lines:
            found[str(path.relative_to(ROOT))] = lines
    assert not found, found


@pytest.mark.parametrize("made", ["likelihood_array", "caller"])
def test_a_cpu_run_without_the_extension_fails_at_start_up(made, tmp_path,
                                                           monkeypatch):
    """A box without g++: no built extension and no compiler on PATH."""
    from octopus_tpu_torch import _build
    from octopus_tpu_torch.core.callers.base import BaseCallerConfig
    from octopus_tpu_torch.core.callers.individual import IndividualCaller
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.io.fasta import InMemoryReference, ReferenceGenome

    monkeypatch.setattr(_build, "_native", None)
    monkeypatch.setattr(_build, "_native_error", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match=(
            r"^host extension unavailable: _native: cannot run g\+\+")):
        if made == "likelihood_array":
            la.HaplotypeLikelihoodArray(la.LikelihoodConfig(device="cpu"))
        else:
            ref = ReferenceGenome(InMemoryReference(
                {"chr1": np.zeros(100, np.uint8)}))
            IndividualCaller(ref, "chr1", BaseCallerConfig(device="cpu"))
