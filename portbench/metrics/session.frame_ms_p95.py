"""95th percentile of the host ms of the window's `track_*` calls
(`SLAM.timings`, each the duration of the program's `frame` span): the
end-to-end `frame_ms_p95`, read per layer in the cells where its runs
spread too widely to hold a bound (the desk: its p95 sits on the edge of
the stage frames' cluster, which moves with the card's speed mode)."""

import statistics


def read(rec):
    xs = rec["timings_ms"] if rec["mode"] == "session" else []
    return statistics.quantiles(xs, n=20)[18] if len(xs) >= 2 else None
