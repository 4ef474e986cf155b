"""run_models_per_s: models completed per second through the warm server's
solve (`serve.SolverCache.solve`), over the whole window."""

from metrics._common import models_per_s


def read(data):
    return models_per_s(data)
