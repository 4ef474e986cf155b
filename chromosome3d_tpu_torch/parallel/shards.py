"""A shard group: the port's counterpart of the JAX package's `beads` mesh
axis for the row-sharded solve (chromosome3d_tpu/solver/sharded.py), and a
device list cut two ways, chrom x beads, for a genome bucket past the length
buckets (`large_mesh_layout`, `chrom_groups`: the JAX package's 2-D mesh of
chromosome3d_tpu/parallel/genome.py).

One process drives every device of an explicit list, as the JAX program
drives every device of its mesh. Rank r owns rows [r Lb, (r + 1) Lb) of
the (L, L) restraint tensors (Lb = L / n); coordinates and optimizer state
are replicated. The collectives are copies to the lead device (rank 0)
combined there in rank order, so they are deterministic and every replica
gets the same bits. A list may name one device several times: the copies
are then no-ops, and the strips, offsets and collectives run unchanged on
one card.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


class ShardGroup:
    """Devices of a row-sharded solve, rank 0 first (the lead)."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a shard group needs at least one device")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def rows(self, L: int) -> int:
        """Rows per shard; L must be a multiple of the shard count."""
        if L % self.n:
            raise ValueError(f"L={L} must be a multiple of the {self.n} shards")
        return L // self.n

    def row_start(self, r: int, L: int) -> int:
        """Global index of rank r's first row."""
        return r * self.rows(L)

    def strips(self, a: torch.Tensor) -> List[torch.Tensor]:
        """Rank r's contiguous row strip of an (L, ...) tensor, on its device."""
        Lb = self.rows(a.shape[0])
        return [a[r * Lb:(r + 1) * Lb].to(d).contiguous()
                for r, d in enumerate(self.devices)]

    def broadcast(self, t: torch.Tensor) -> List[torch.Tensor]:
        """One copy of t per rank (the same tensor on a repeated device)."""
        return [t.to(d) for d in self.devices]

    def _on_lead(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(parts) != self.n:
            raise ValueError(f"{len(parts)} parts for {self.n} shards")
        return [p.to(self.lead) for p in parts]

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum of the ranks' parts on the lead, added in rank order."""
        acc, *rest = self._on_lead(parts)
        for p in rest:
            acc = acc + p
        return acc

    def pmin(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        acc, *rest = self._on_lead(parts)
        for p in rest:
            acc = torch.minimum(acc, p)
        return acc

    def pmax(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        acc, *rest = self._on_lead(parts)
        for p in rest:
            acc = torch.maximum(acc, p)
        return acc

    def all_gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The ranks' parts concatenated along dim, in rank order, on the lead."""
        return torch.cat(self._on_lead(parts), dim)


def large_mesh_layout(B: int, n_dev: int) -> Tuple[int, int]:
    """(chrom, beads) factors of n_dev devices for an at-scale bucket of B
    chromosomes (the JAX package's large_mesh_layout, parallel/genome.py:274):
    the chromosome axis takes the largest divisor of n_dev that the B
    chromosomes can fill; the other devices shard each chromosome's rows."""
    nc = max(d for d in range(1, n_dev + 1) if n_dev % d == 0 and d <= B)
    return nc, n_dev // nc


def chrom_groups(devices: Sequence, B: int) -> List[ShardGroup]:
    """The device list cut chrom x beads for B chromosomes: nc shard groups
    of nb devices each (large_mesh_layout), group g taking devices
    [g nb, (g + 1) nb), as the JAX mesh reshapes its list to (nc, nb). A
    list may name one device several times."""
    devices = list(devices)
    nc, nb = large_mesh_layout(B, len(devices))
    return [ShardGroup(devices[g * nb:(g + 1) * nb]) for g in range(nc)]
