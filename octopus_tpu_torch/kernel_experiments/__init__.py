"""Ports of the reference's Pallas kernel experiments (experiments/*.py).

Each experiment probes one lever of the banded pair-HMM kernel: independent
chains in one thread (dual_chain), fewer instructions a cell against more
bytes a pair (v10_kernel), sliding register windows (v11_kernel), two rows
a loop iteration (v13_unroll2), and int16 arithmetic (i16_probe). None is
on a path of the product. Each module keeps its experiment's function and
layout, has a plain PyTorch version, a hand-written CUDA kernel
(csrc/exp_*.cu) and a launch count, and runs as

    python -m octopus_tpu_torch.kernel_experiments.<module>

which checks parity and times the experiment on the card, as the
experiment's own __main__ does. (The package is not named experiments:
.gitignore's `experiments/` pattern matches that name at any depth.)
"""

from ._common import COUNTS

__all__ = ["COUNTS"]
