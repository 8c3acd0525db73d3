"""store_host_ms_per_plan: the store pass's own host time (self time of
the program's ``store.*`` spans: building and launching its eager ops
and kernels) in the traced part of the window, a plan there
(``uruvbench.progtrace``)."""

from uruvbench.progtrace import self_ms_per_plan


def read(facts):
    return self_ms_per_plan(facts, "store")
