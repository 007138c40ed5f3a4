"""Stylization networks (NCHW)."""
