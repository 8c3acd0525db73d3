"""coalesced_ops_per_plan: the admission front end's ops a plan over the
window (``Coalescer.stats``: ops submitted / plans dispatched)."""


def read(facts):
    c = facts["coalescer"]
    return c["ops"] / c["plans"] if c and c["plans"] else None
