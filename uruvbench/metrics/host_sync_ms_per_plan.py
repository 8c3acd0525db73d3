"""host_sync_ms_per_plan: host time in device-to-host reads (the
program's ``sync.<site>`` spans: the wait for the device and the copy)
in the traced part of the window, a plan there
(``uruvbench.progtrace``)."""

from uruvbench.progtrace import self_ms_per_plan


def read(facts):
    return self_ms_per_plan(facts, "sync")
