"""solve_idle_ms.<run|genome>: a request's device-idle milliseconds inside
the union of the program's solve-phase spans (`solve.setup`, `solve.hot`,
`solve.pick`, `solve.cool`, `solve.final`): the profiler's idle gaps
intersected with them, the mean over the traced requests."""

from metrics._program import idle_ms


def read(data):
    return idle_ms(data, "solve.")
