"""One module a configuration family: the program's nets with the
reference's weights, and the reference's side of each loop."""
