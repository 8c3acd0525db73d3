"""combining_host_ms_per_plan: the combining and self-sizing layers' own
host time (self time of the program's ``batch.*`` and ``lifecycle.*``
spans) in the traced part of the window, a plan there
(``uruvbench.progtrace``)."""

from uruvbench.progtrace import self_ms_per_plan


def read(facts):
    return self_ms_per_plan(facts, "combining")
