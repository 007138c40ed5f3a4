"""Bytes of the stream's pageable copies, both ways (counter
``vst.stream.pageable_bytes``), in MB (1e6 bytes) per frame (counter
``vst.stream.frames``) of the profiled frames."""

from vstbench.program_trace import count_per_unit


def read(ctx):
    return count_per_unit(ctx, "vst.stream.pageable_bytes", "vst.stream.frames", scale=1e-6)
