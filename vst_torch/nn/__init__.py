"""Convolution blocks, norms and initialisers (NCHW)."""
