"""Device resolution, the shard devices, and the port's numeric settings.

float32 matrix products run in full float32: the JAX reference runs them at
full precision on the CPU, and mds_init's subspace iteration (`b @ v`,
solver/init.py) loses the embedding's small eigen-gaps in TF32. PyTorch's
default already keeps `matmul.allow_tf32` off, but `cudnn.allow_tf32` is on
by default, so both are stated here, once, when a module that computes is
imported: the packages `ops` and `solver` import this one (the package root
does not, so that a client of the server never imports torch).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device a run computes on.

    None is the first CUDA device. A CUDA device, asked for or by default,
    raises RuntimeError when torch.cuda.is_available() is False: the CPU,
    where every kernel runs its plain PyTorch twin, is used only when asked
    for ("cpu"), so nothing falls back to it silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} (the default without device=\"cpu\") needs CUDA, but "
            "torch.cuda.is_available() is False"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {dev.type!r} (cuda or cpu)")
    return dev


def shard_devices() -> List[torch.device]:
    """The devices a row-sharded solve spreads over: every visible CUDA
    device (none without CUDA). The pipeline shards when this lists more
    than one. A list may name one device several times, which runs the
    sharded program's strips, offsets and collectives on one card; the
    tests and chip_smoke.py replace this function to do so."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
