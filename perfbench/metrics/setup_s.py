"""Seconds from process start to the first timed step."""


def read(run: dict, suffix: str):
    return run["setup_s"]
