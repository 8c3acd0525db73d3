"""passes_per_plan: the store's device passes over the window
(``Uruv.stats["device_passes"]``), a plan handed to the store."""


def read(facts):
    return facts["uruv"]["device_passes"] / facts["plans"] if facts["plans"] else None
