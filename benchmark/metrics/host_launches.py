"""host_launches.<run|bucket|genome>: the kernel launches of a request, the
deltas of the program's kernel-wrapper launch counters that its `request`
roots keep, summed; the mean over the traced requests."""

from metrics._program import host_launches


def read(data):
    return host_launches(data)
