"""frontend_host_ms_per_plan: the admission front end's own host time
(self time of the program's ``serve.*`` spans) in the traced part of the
window, a plan dispatched there (``uruvbench.progtrace``)."""

from uruvbench.progtrace import self_ms_per_plan


def read(facts):
    return self_ms_per_plan(facts, "frontend")
