"""The port's parallel CLI paths against its serial run and the reference.

A simulated 24 kb diploid at 30x, called over six 4 kb regions (one window
each), on the CPU:

* the process pool (`--threads 4`) writes the serial port run's record
  lines and the reference CLI's `--threads 4` lines (made under octopus's
  rule for tied reads, `reference_tie_rule`, in its workers too); with
  OCTOPUS_TPU_DEFER_HEAVY_AT=1 the workers hand windows back to the parent
  and the records stay the same;
* two port processes sharing a run through `--work-queue --num-shards 2`
  merge a VCF byte-identical to the serial run's, also when the second
  starts only after the first has exited, and when both start
  torch.distributed through OCTOPUS_TPU_COORDINATOR;
* no pool worker imports jax or the reference package.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

import reference_tie_rule as tie_rule
from octopus_tpu import cli as ref_cli
from octopus_tpu_torch import cli, run
from octopus_tpu_torch.utils.synthetic import simulate_diploid

ROOT = Path(__file__).resolve().parent.parent
PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")
REGIONS = ["-T"] + [f"chr1:{i * 4000}-{(i + 1) * 4000}" for i in range(6)]


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_parallel")
    fa, bam, truth, n = simulate_diploid(str(d), kb=24, depth=30, seed=5,
                                         spacing=(150, 450))
    return d, fa, bam


def record_lines(path):
    return [line for line in Path(path).read_text().splitlines()
            if not line.startswith("##")]


def run_port(sample, monkeypatch, name, *extra, env=None):
    d, fa, bam = sample
    for k in PINNED:
        monkeypatch.delenv(k, raising=False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    out = str(d / name)
    run.POOL.reset()
    assert cli.main(["-R", fa, "-I", bam, "-o", out, "--device", "cpu",
                     *REGIONS, *extra]) == 0
    return out


@pytest.fixture(scope="module")
def serial(sample):
    with pytest.MonkeyPatch.context() as mp:
        out = run_port(sample, mp, "serial.vcf")
    assert len(record_lines(out)) > 20
    return out


@pytest.fixture(scope="module")
def reference_threads(sample):
    """The reference CLI with its process pool, which leaves its small-run
    variables set: they are restored."""
    d, fa, bam = sample
    out = str(d / "reference_threads.vcf")
    saved = {k: os.environ.get(k) for k in PINNED}
    try:
        with tie_rule.applied():        # the pool's workers take it too
            assert ref_cli.main(["-R", fa, "-I", bam, "-o", out, *REGIONS,
                                 "--threads", "4"]) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def test_process_pool_writes_the_serial_and_reference_records(
        sample, serial, reference_threads, monkeypatch):
    out = run_port(sample, monkeypatch, "pool.vcf", "--threads", "4")
    assert record_lines(out) == record_lines(serial)
    assert record_lines(out) == record_lines(reference_threads)
    assert run.POOL.worker_windows > 0
    assert run.POOL.worker_windows + run.POOL.deferred_windows == 6
    assert run.POOL.fallbacks == 0


def test_deferred_windows_keep_the_records(sample, serial, monkeypatch):
    out = run_port(sample, monkeypatch, "deferred.vcf", "--threads", "4",
                   env={"OCTOPUS_TPU_DEFER_HEAVY_AT": "1"})
    assert record_lines(out) == record_lines(serial)
    assert run.POOL.deferred_windows > 0
    assert run.POOL.fallbacks == 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_env(**extra):
    """The environment of a port process beside others on this machine:
    two threads each, so that two "hosts" do not oversubscribe its cores."""
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and k not in PINNED}
    env.update(OMP_NUM_THREADS="2", **extra)
    return env


def start_shard(sample, out, i, env):
    d, fa, bam = sample
    return subprocess.Popen(
        [sys.executable, "-m", "octopus_tpu_torch.cli", "-R", fa, "-I", bam,
         "-o", out, "--device", "cpu", *REGIONS, "--work-queue",
         "--num-shards", "2", "--shard-index", str(i),
         "--keep-temporary-files"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish(procs):
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        errs.append(err)
    return errs


def test_two_process_work_queue_matches_single_process(sample, serial):
    out = str(sample[0] / "multi.vcf")
    errs = finish([start_shard(sample, out, i, port_env()) for i in range(2)])
    assert os.path.exists(out), "\n---\n".join(errs)
    assert Path(out).read_bytes() == Path(serial).read_bytes()
    qdir = out + ".shards/queue"
    workers = {open(os.path.join(qdir, c)).read()
               for c in os.listdir(qdir) if c.endswith(".claim")}
    assert len(workers) == 2, workers


def test_work_queue_resume_after_kill(sample, serial, monkeypatch):
    """A preempted host: shard 0 runs alone and leaves without merging, then
    shard 1 finishes the job and merges the serial run's bytes."""
    out = str(sample[0] / "resumed.vcf")
    shard = ["--work-queue", "--num-shards", "2", "--keep-temporary-files"]
    run_port(sample, monkeypatch, "resumed.vcf", *shard, "--shard-index", "0")
    assert not os.path.exists(out)
    run_port(sample, monkeypatch, "resumed.vcf", *shard, "--shard-index", "1")
    assert Path(out).read_bytes() == Path(serial).read_bytes()


def test_coordinator_start_up_writes_the_single_process_records(sample,
                                                                 serial):
    out = str(sample[0] / "coordinated.vcf")
    coord = f"127.0.0.1:{free_port()}"
    errs = finish([start_shard(sample, out, i, port_env(
        OCTOPUS_TPU_COORDINATOR=coord, OCTOPUS_TPU_NUM_PROCESSES="2",
        OCTOPUS_TPU_PROCESS_ID=str(i))) for i in range(2)])
    for i, err in enumerate(errs):
        assert f"torch.distributed initialised (process {i}/2)" in err, err
    assert record_lines(out) == record_lines(serial)


PROBE_MODULE = r'''
import json
import os
import sys

from octopus_tpu_torch import run

_run = run._process_worker_run


def leaked_run(task):
    """The pool's task, then the modules this worker process has loaded."""
    result = _run(task)
    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "jaxlib")
                    or m.startswith(("jax.", "jaxlib."))
                    or m == "octopus_tpu" or m.startswith("octopus_tpu."))
    with open(os.path.join(os.environ["PROBE_DIR"], f"{os.getpid()}.json"),
              "w") as fh:
        json.dump(leaked, fh)
    return result


def main(argv):
    run._process_worker_run = leaked_run
    from octopus_tpu_torch.cli import main as cli_main
    print("RC", cli_main(argv))
'''


def test_pool_workers_load_no_jax_and_no_reference_module(sample, tmp_path):
    d, fa, bam = sample
    (tmp_path / "pool_probe.py").write_text(PROBE_MODULE)
    probe_dir = tmp_path / "seen"
    probe_dir.mkdir()
    code = (f"import sys; sys.path.insert(0, {str(tmp_path)!r}); "
            "import pool_probe; pool_probe.main(sys.argv[1:])")
    proc = subprocess.run(
        [sys.executable, "-c", code, "-R", fa, "-I", bam, "-o",
         str(tmp_path / "probe.vcf"), "--device", "cpu", *REGIONS[:4],
         "--threads", "2"],
        cwd=ROOT, env=port_env(PROBE_DIR=str(probe_dir)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "RC 0" in proc.stdout, proc.stderr[-2000:]
    seen = [json.loads(p.read_text()) for p in probe_dir.iterdir()]
    assert seen and all(leaked == [] for leaked in seen), seen


@pytest.mark.parametrize("path", ["coordinator", "env"])
def test_distributed_start_up_starts_once_and_ends_with_the_run(
        sample, monkeypatch, capsys, path):
    """One process of a one-process job, in this process: the start-up
    starts the gloo group once (a second start-up leaves it alone) and
    prints the notice, and a run destroys the group it started."""
    import torch.distributed as dist
    port = str(free_port())
    if path == "coordinator":
        env = {"OCTOPUS_TPU_COORDINATOR": f"127.0.0.1:{port}",
               "OCTOPUS_TPU_NUM_PROCESSES": "1", "OCTOPUS_TPU_PROCESS_ID": "0"}
    else:
        env = {"OCTOPUS_TPU_DISTRIBUTED": "1", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": port, "RANK": "0", "WORLD_SIZE": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert run._maybe_init_distributed()
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert not run._maybe_init_distributed()
    finally:
        dist.destroy_process_group()
    assert "torch.distributed initialised (process 0/1)" in \
        capsys.readouterr().err
    if path == "env":
        monkeypatch.setenv("MASTER_PORT", str(free_port()))
    else:
        monkeypatch.setenv("OCTOPUS_TPU_COORDINATOR",
                           f"127.0.0.1:{free_port()}")
    d, fa, bam = sample
    out = str(d / f"distributed_{path}.vcf")
    assert cli.main(["-R", fa, "-I", bam, "-o", out, "--device", "cpu",
                     "-T", "chr1:0-4000"]) == 0
    assert "torch.distributed initialised" in capsys.readouterr().err
    assert not dist.is_initialized()
    assert record_lines(out)
