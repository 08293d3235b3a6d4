"""Requests completed correctly per second: their count over the window
(a closed loop's window lasts until the last has finished; an open
loop's until its last request was due, or until the last finished where
that is later)."""


def read(run):
    if not run.requests:
        return None
    done = [r for r in run.requests if r["ok"]]
    if run.mix["arrival"] == "closed":
        return len(done) / run.window_s
    return len(done) / max(run.seconds, max(r["done"] for r in run.requests))
