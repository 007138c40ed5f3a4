"""The Sintel TCL-ST / TCL-LT / DT harness, the feed-forward family's
drivers, and writing stylized frames."""
