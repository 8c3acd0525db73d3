"""kernels_per_plan: kernel launches in the traced part of the window
(the device trace's kernel events), a plan dispatched there."""


def read(facts):
    t = facts["trace"]
    return t["kernels"] / facts["plans_traced"] if t and facts["plans_traced"] else None
