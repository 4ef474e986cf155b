"""init_idle_ms.<bucket|genome>: a request's device-idle milliseconds inside
the union of the program's start spans (`init.start`, `init.draws`,
`init.landmark_sharded`): the profiler's idle gaps intersected with them,
the mean over the traced requests."""

from metrics._program import idle_ms


def read(data):
    return idle_ms(data, "init.")
