"""range_pages_ms_per_plan: host time turning range pages into Python
pairs and arrays (self time of the program's ``pages`` spans, in
``core.batch.bulk_range_all`` and ``api.opbatch.make_result``) in the
traced part of the window, a plan there (``uruvbench.progtrace``)."""

from uruvbench.progtrace import self_ms_per_plan


def read(facts):
    return self_ms_per_plan(facts, "pages")
