"""Samples whose request's metrics reached the host in the window, over
the window's seconds."""


def read(run: dict, suffix: str):
    if run["kind"] != "eval":
        return None
    return run["samples"] / run["window_s"]
