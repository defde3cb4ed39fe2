"""`loop.verify_ms` in the cells where it moves `frames_per_s`: those that
report `frame_ms_p95` only per layer (`session.frame_ms_p95`)."""

from portbench import registry

read = registry.reader("loop.verify_ms")
