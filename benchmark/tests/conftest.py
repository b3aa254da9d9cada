"""The benchmark's tests: run from the root of the repository,

    python -m pytest benchmark/tests -q

on the CPU, where the tests that need a CUDA card skip, and on the card's
machine, where they run. They import the port (`octopus_tpu_torch`) only
to hold the harness against it; nothing here imports JAX."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
