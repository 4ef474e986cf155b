"""anneal_ms.<run|genome>: a request's milliseconds in the solver's calls
(`pipeline._solve`, `solver.anneal.solve_bucket_impl`,
`solver.sharded.solve_genome_sharded`) outside its start functions: the
step loop, the enantiomer pick and the final terms; the mean over the
window's requests."""

from metrics._common import anneal_ms


def read(data):
    return anneal_ms(data)
