"""RAFT optical flow and its correlation pyramid (NCHW)."""
