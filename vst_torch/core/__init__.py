"""Metric aggregation and JSON writers."""
