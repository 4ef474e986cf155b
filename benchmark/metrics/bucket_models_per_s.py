"""bucket_models_per_s: models completed per second through the genome
runner's one-bucket solve (`parallel.genome.solve_bucket` on a host stack),
over the whole window."""

from metrics._common import models_per_s


def read(data):
    return models_per_s(data)
