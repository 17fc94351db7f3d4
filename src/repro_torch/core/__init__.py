"""Core abstractions of the port (so far: ``spaces.Discrete``)."""
