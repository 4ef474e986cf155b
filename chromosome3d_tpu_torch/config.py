"""Typed configuration: the JAX package's jax-free dataclasses
(chromosome3d_tpu.config), re-exported so that a run of the port is
described by exactly the same (RestraintConfig, AnnealConfig,
PipelineConfig) values as a run of the JAX package."""

from chromosome3d_tpu.config import (
    AnnealConfig,
    PipelineConfig,
    RestraintConfig,
    fast_anneal,
    turbo_anneal,
)

__all__ = ["AnnealConfig", "PipelineConfig", "RestraintConfig", "fast_anneal",
           "turbo_anneal"]
