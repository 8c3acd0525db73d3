"""setup_s: seconds from the start of the process to the window's start
(imports, data made from the seed, the store built, the prefill, the
warm-up; in a fresh checkout also the kernels' build)."""


def read(facts):
    return facts["setup_s"]
