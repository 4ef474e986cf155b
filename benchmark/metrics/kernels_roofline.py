"""kernels_roofline.<run|genome>: the least time of the traced requests'
counted work (benchmark/work/counts.py) over the summed time of all their
kernels (torch.profiler), in %."""

from metrics._common import kernels_roofline


def read(data):
    return kernels_roofline(data)
