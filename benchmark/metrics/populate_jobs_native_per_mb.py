"""Populate job gatherings a called Mb that the host extension ran in one
native call (likelihood_array.ROUTING.native_gathers, reset before the
window): one a populate's sample or a pad group of CSR's assignment
blocks. None on a program without the counter."""


def read(r):
    from octopus_tpu_torch.core.likelihood import likelihood_array
    value = getattr(getattr(likelihood_array, "ROUTING", None),
                    "native_gathers", None)
    return value / r.called_mb if value is not None and r.called_mb else None
