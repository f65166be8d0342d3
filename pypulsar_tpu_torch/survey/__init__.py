"""The survey's per-observation stage chain over the port's entry points."""
