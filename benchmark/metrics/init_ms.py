"""init_ms.<run|genome>: a request's milliseconds in the solver's start
functions (`solver.anneal.initial_structure`,
`solver.sharded.sharded_landmark_init`), the mean over the window's
requests."""

from metrics._common import span_ms


def read(data):
    return span_ms(data, "init")
