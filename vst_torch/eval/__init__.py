"""The Sintel TCL-ST / TCL-LT / DT harness and its FastStyleNet driver."""
