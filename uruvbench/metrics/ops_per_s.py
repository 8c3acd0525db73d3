"""ops_per_s: every op whose result reached the host inside the window,
over the window's seconds (one rate over the whole window)."""


def read(facts):
    return facts["ops_done"] / facts["seconds"]
