"""Device ms a dp step charged to its `dp.PHASE` ranges `insert` and `stage` (an eager program
on a copy of the warm state, each step traced; `trace.charge`)."""


def read(rec):
    ph = rec.get("dp_phase_ms")
    if not ph:
        return None
    return ph.get("insert", 0.0) + ph.get("stage", 0.0)
