"""Seeds and inputs made from `--seed`."""

from __future__ import annotations

import zlib

import numpy as np

from reference.truth import confined_walk, if_matrix


def derive(seed: int, *keys) -> int:
    """A 31-bit seed for (seed, keys...): the same keys always give the same
    number, any whole --seed (negative or past 64 bits too) is taken."""
    words = [int(seed) % (2**64)] + [zlib.crc32(str(k).encode()) for k in keys]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint32)[0] & 0x7FFFFFFF)


def genome_instance(lengths, seed: int, instance: int, truth: dict, device) -> list:
    """One instance of a set of chromosomes: [(true coords, IF float32)] a
    chromosome, chromosome k's truth from confined_walk(L, derive(seed,
    instance, k)) and its IF matrix from the recipe in the config's
    `truth`."""
    out = []
    for k, L in enumerate(lengths):
        s = derive(seed, "instance", instance, k)
        X = confined_walk(int(L), seed=s)
        out.append((X, if_matrix(X, truth["alpha"], truth["noise_sigma"], s + 1, device=device)))
    return out
