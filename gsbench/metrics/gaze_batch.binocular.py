"""Mean of the program's ``gs.gaze.eyes`` counter over the traced
headset frames: the eye images per RITnet forward, 2.0 where both eyes
share one forward. Left out where the program has no such counter."""

from gsbench import spans


def read(run):
    eyes = [c.value for c in spans.program_counts(run) if c.name == "gs.gaze.eyes"]
    return sum(eyes) / len(eyes) if eyes else None
