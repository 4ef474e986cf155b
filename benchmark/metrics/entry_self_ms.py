"""entry_self_ms.<run|genome>: a request's milliseconds outside the prep and
init spans (uploads, downloads, host views, the solve's step loop and
glue), the mean over the window's requests."""

from metrics._common import entry_self_ms


def read(data):
    return entry_self_ms(data)
