"""One closed loop a kind of traffic mix: eval, stream, train."""
