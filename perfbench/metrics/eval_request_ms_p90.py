"""The 90th percentile of every request's latency in the window (host
clock, from the host samples handed to the program to the request's
metrics on the host)."""

import statistics


def read(run: dict, suffix: str):
    lat = run["latencies_ms"]
    if run["kind"] != "eval" or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]
