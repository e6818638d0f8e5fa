"""How the benchmark builds the program under test for a configuration."""
