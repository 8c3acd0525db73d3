"""queue_wait_ms_p95: the 95th percentile of a request's wait in the
admission front end's queue, from ``submit`` to the dispatch of its plan,
over the requests dispatched in the traced part of the window (the
program's ``tracing.note_waits``); nothing without the program's
tracing (``uruvbench.progtrace``)."""

import numpy as np

from uruvbench.progtrace import program


def read(facts):
    p = program(facts)
    w = p["waits_s"] if p else ()
    return float(np.percentile(w, 95)) * 1e3 if len(w) else None
