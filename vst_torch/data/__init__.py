"""Synthetic motion clips for evaluation without datasets."""
