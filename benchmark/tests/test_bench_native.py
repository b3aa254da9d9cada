"""The reader of the host VB's native calls (`vb_host_native_per_mb`):
`subclone_vb.COUNTS.host_native` a called Mb, and None on a program
without the counter."""

import types

from benchmark import cell


def test_native_calls_reader_reads_the_counter_or_none(monkeypatch):
    from octopus_tpu_torch.core import models
    from octopus_tpu_torch.core.models import subclone_vb

    read = cell.load_reader("vb_host_native_per_mb")
    r = cell.Reading(self_s={}, called_mb=0.5, window_s=1.0, device=None,
                     launches=[], routing={}, kernel_launches=0)
    monkeypatch.setattr(subclone_vb, "COUNTS", types.SimpleNamespace(
        host=3, device=0, host_elements=1, device_elements=0, captures=0,
        host_native=3))
    assert read(r) == 6.0
    # the counter's owner as a program without the field has it
    monkeypatch.setattr(subclone_vb, "COUNTS", types.SimpleNamespace(
        host=3, device=0, host_elements=1, device_elements=0, captures=0))
    assert read(r) is None
    monkeypatch.setattr(models, "subclone_vb", types.ModuleType("subclone_vb"))
    assert read(r) is None
