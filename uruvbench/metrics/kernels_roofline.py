"""kernels_roofline: the store kernels' share of the card's memory
roofline in the traced part of the window: the least bytes the traced
plans' work needs (``uruvbench.roofline.plan_min_bytes``, a function of
the ops alone) over (device busy seconds x the card's HBM bandwidth),
in %.  Nothing where the card is not in ``uruvbench/peaks.json`` or the
trace holds no device time."""

from uruvbench.roofline import hbm_bytes_per_s, plan_min_bytes


def read(facts):
    t = facts["trace"]
    peak = hbm_bytes_per_s(facts["device"]["kind"])
    if not t or not peak or t["busy_s"] <= 0 or not facts["traced"]:
        return None
    need = sum(plan_min_bytes(c, k, pairs) for c, k, pairs in facts["traced"])
    return 100.0 * need / (t["busy_s"] * peak)
