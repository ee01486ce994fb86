"""Host ms per step or request inside the program's batch.stack and
batch.h2d spans (cli/main.py::stack_traj_batch's np.stack and its copies
to the card), from their host records in the traced stretch."""

from ._program import host_spans, union


def read(run: dict, suffix: str):
    spans = host_spans(run, suffix, ("batch.stack", "batch.h2d"))
    if spans is None:
        return None
    return sum(b - a for a, b in union(spans)) / 1e3 / run["stretch_steps"]
