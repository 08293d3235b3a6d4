"""Per cent of the window's requests answered correctly within one
period of the open loop's rate of when they were due (11.1 ms at 90 Hz:
the view is on the device before the display's next refresh). In a
traced run the profiler's stop after the traced requests holds up the
first request after them and leaves a backlog, so the count starts at
the first later request that was due after the one before it had
finished. Left out (None) for a
closed loop, which has no rate."""


def read(run):
    rate = run.mix.get("rate_hz")
    if run.mix["arrival"] == "closed" or not rate:
        return None
    reqs = run.requests
    first = 0
    if run.traced:
        first = next((i for i in range(run.traced + 1, len(reqs))
                      if reqs[i - 1]["done"] <= reqs[i]["due"]), len(reqs))
    reqs = reqs[first:]
    if not reqs:
        return None
    period = 1.0 / float(rate)
    on_time = [r for r in reqs if r["ok"] and r["done"] - r["due"] <= period]
    return 100.0 * len(on_time) / len(reqs)
