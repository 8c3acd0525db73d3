"""api_host_ms_per_plan: ``repro_torch.api``'s own host time (self time
of the program's ``api.*`` spans: ``Uruv.apply``, ``apply_nowait``,
``confirm``, the executor) in the traced part of the window, a plan
there (``uruvbench.progtrace``)."""

from uruvbench.progtrace import self_ms_per_plan


def read(facts):
    return self_ms_per_plan(facts, "api")
