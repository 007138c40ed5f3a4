"""Image, sampling and flow-consistency ops (NCHW)."""
