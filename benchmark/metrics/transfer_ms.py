"""transfer_ms.<run|bucket|genome>: a request's milliseconds in the
program's uploads and downloads, its `xfer.h2d` and `xfer.d2h` spans
(utils/trace.py `to_device` / `to_host`; the wait for the device before a
copy, `xfer.wait`, is not counted), the mean over the traced requests."""

from metrics._program import transfer_ms


def read(data):
    return transfer_ms(data)
