"""How a request of each engine calls the program, one file an engine."""
