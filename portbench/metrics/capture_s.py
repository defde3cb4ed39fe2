"""Host s of the program's `capture` records before the window: each
captured graph's warm-up on copies and its capture, in set-up.  From the
program's span log (`window.py`)."""

from portbench import window


def read(rec):
    w = window.select(rec)
    if w is None:
        return None
    first = w.records[0].seq
    xs = [r.dur_s for r in w.log.records
          if r.name == "capture" and r.seq < first]
    return sum(xs) if xs else None
