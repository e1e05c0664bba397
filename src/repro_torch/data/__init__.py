"""Data substrate (port of ``repro.data``): the deterministic host-sharded
LM pipeline and the synthetic audio tasks, in numpy."""

from repro_torch.data.pipeline import ShardedLMPipeline
from repro_torch.data import synthetic

__all__ = ["ShardedLMPipeline", "synthetic"]
