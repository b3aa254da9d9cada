"""The reader of populate's native job gatherings
(`populate_jobs_native_per_mb`): `likelihood_array.ROUTING.native_gathers`
a called Mb, and None on a program without the counter."""

import types

from benchmark import cell


def test_native_gathers_reader_reads_the_counter_or_none(monkeypatch):
    from octopus_tpu_torch.core import likelihood
    from octopus_tpu_torch.core.likelihood import likelihood_array

    read = cell.load_reader("populate_jobs_native_per_mb")
    r = cell.Reading(self_s={}, called_mb=0.25, window_s=1.0, device=None,
                     launches=[], routing={}, kernel_launches=0)
    monkeypatch.setattr(likelihood_array, "ROUTING", types.SimpleNamespace(
        shortcut_pairs=0, tied_reads_credited=0, native_gathers=5))
    assert read(r) == 20.0
    # the counter's owner as a program without the field has it
    monkeypatch.setattr(likelihood_array, "ROUTING", types.SimpleNamespace(
        shortcut_pairs=0, tied_reads_credited=0))
    assert read(r) is None
    monkeypatch.setattr(likelihood, "likelihood_array",
                        types.ModuleType("likelihood_array"))
    assert read(r) is None
    # no called Mb, no reading
    monkeypatch.undo()
    zero = cell.Reading(self_s={}, called_mb=0.0, window_s=1.0, device=None,
                        launches=[], routing={}, kernel_launches=0)
    assert cell.load_reader("populate_jobs_native_per_mb")(zero) is None
