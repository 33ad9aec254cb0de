"""MPO math, layers, the execution engine, and parameter carry-over."""
