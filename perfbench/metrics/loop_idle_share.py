"""Share of the traced stretch, in percent, in which the device was idle
(no kernel, memcpy or memset) while the host was inside one of the
program's batch spans (batch.stack, batch.h2d, batch.to_device)."""

from ._program import host_spans, idle_while


def read(run: dict, suffix: str):
    spans = host_spans(run, suffix,
                       ("batch.stack", "batch.h2d", "batch.to_device"))
    if spans is None:
        return None
    lo, hi = run["stretch_us"]
    return 100.0 * idle_while(run, spans) / (hi - lo)
