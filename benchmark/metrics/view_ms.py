"""view_ms.run: a request's milliseconds inside the program's `prep.view`
span (pipeline._assessment_view_from_if: the assessment view prepped again
on the card after the solve and downloaded to the host), the mean over the
traced requests; absent where the program records no such span."""

from metrics._named_spans import named_span_ms


def read(data):
    return named_span_ms(data, "prep.view")
