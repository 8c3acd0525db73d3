"""host_syncs_per_plan: device-to-host reads the program counted
(``repro_torch.tracing.counters["host_reads.<site>"]``) in the traced
part of the window, a plan there (``uruvbench.progtrace``)."""

from uruvbench.progtrace import program


def read(facts):
    p = program(facts)
    return p["host_reads"] / facts["plans_traced"] if p else None
