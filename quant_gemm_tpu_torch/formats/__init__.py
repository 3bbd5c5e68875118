"""Block formats: containers, numpy golden, torch quantizers."""
