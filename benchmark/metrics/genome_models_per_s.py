"""genome_models_per_s: models completed per second through the genome
runner's buckets, a whole genome a request (each bucket on its own route),
over the whole window."""

from metrics._common import models_per_s


def read(data):
    return models_per_s(data)
