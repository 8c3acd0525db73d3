"""d2h_copies_per_plan: device-to-host copies (host syncs) in the traced
part of the window (the device trace's DtoH memcpy events), a plan
dispatched there."""


def read(facts):
    t = facts["trace"]
    return t["d2h_copies"] / facts["plans_traced"] if t and facts["plans_traced"] else None
