"""vst_torch.core — checkpointing, metric aggregation and JSON writers,
timing, tracing (vst's ``vst/core``)."""

from vst_torch.core.checkpoint import Checkpointer

__all__ = ["Checkpointer"]
