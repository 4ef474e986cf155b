"""prep_ms.<run|genome>: a request's milliseconds in the restraint prep on
the card (the solve's tiles, the assessment view), the mean over the
window's requests; absent where the window runs no prep."""

from metrics._common import span_ms


def read(data):
    return span_ms(data, "prep")
