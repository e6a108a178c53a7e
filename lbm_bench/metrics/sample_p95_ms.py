"""sample_p95_ms: the 95th percentile of the force samples' intervals, each
from the previous sample's values on the host to its own."""

import statistics


def read(rec):
    if len(rec.sample_ms) < 2:
        return None
    return statistics.quantiles(rec.sample_ms, n=100, method="inclusive")[94]
