"""Training samples whose step was issued in the window, over the
window's seconds (the window ends with a synchronize: every counted step
is done)."""


def read(run: dict, suffix: str):
    if run["kind"] != "train":
        return None
    return run["samples"] / run["window_s"]
