"""Logging: the reference's stdout banners with localtime brackets
(chromosome3D.pl:48-53, 100-108) as standard logging with a stdout handler —
the port's copy of chromosome3d_tpu/utils/logging.py's get_logger and
banner — and `profile_trace`, a torch.profiler trace of a block (the JAX
package's jax.profiler trace of the solve, `run --profile DIR`)."""

from __future__ import annotations

import contextlib
import logging
import os
import sys


def get_logger(name: str = "chromosome3d_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("[%(asctime)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def banner(logger: logging.Logger, message: str) -> None:
    logger.info(message)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """torch.profiler trace of the block (host activity, and the CUDA
    kernels and copies where there is a card), written into log_dir as a
    Chrome trace (`trace.json`: chrome://tracing, Perfetto); no-op when
    log_dir is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
