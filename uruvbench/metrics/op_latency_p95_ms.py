"""op_latency_p95_ms: the 95th percentile, over every op completed in the
window, of the time from its call (plans) or ``submit`` (requests) to its
result on the host."""

import numpy as np


def read(facts):
    lat = facts["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) else None
