"""rejected_plan_share: the share of the front end's speculative plans
that the store rejected and the front end replayed (``Coalescer.stats``:
plans_rejected / plans), in %."""


def read(facts):
    c = facts["coalescer"]
    return 100.0 * c["plans_rejected"] / c["plans"] if c and c["plans"] else None
