"""Small utilities of the port (so far: the tabular ``Logger``)."""
