"""The Sintel TCL-ST / TCL-LT / DT harness, the FC2 metric harness, the
per-family drivers, and writing stylized frames and grids."""
