"""Device ms a dp step charged to its `dp.PHASE` range `track` (an eager program
on a copy of the warm state, each step traced; `trace.charge`)."""


def read(rec):
    ph = rec.get("dp_phase_ms")
    if not ph:
        return None
    return ph.get("track")
