"""terms_ms.run: a request's milliseconds inside the program's
`solve.terms` spans (solver/anneal.py `_solve_stack`: the final energy
terms, whole-matrix below CHUNKED_TERMS_MIN_L and in row blocks from it,
each span ended by a fence on the device while traced), the mean over the
traced requests; absent where the program records no such span."""

from metrics._named_spans import named_span_ms


def read(data):
    return named_span_ms(data, "solve.terms")
