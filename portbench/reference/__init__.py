"""The plain references the benchmark judges the program's answers by, one
file an engine.  Nothing here imports the program under test."""
