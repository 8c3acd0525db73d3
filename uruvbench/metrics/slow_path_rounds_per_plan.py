"""slow_path_rounds_per_plan: the combining layer's help rounds after a
rejected pass over the window (``Uruv.stats["slow_path_rounds"]``), a
plan handed to the store."""


def read(facts):
    return facts["uruv"]["slow_path_rounds"] / facts["plans"] if facts["plans"] else None
