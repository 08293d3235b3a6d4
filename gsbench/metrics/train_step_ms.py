"""The window over the train steps it completed, in milliseconds."""


def read(run):
    if not run.requests:
        return None
    return 1e3 * run.window_s / len(run.requests)
