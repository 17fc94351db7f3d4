"""Entry points of the port that mirror the root ``examples/`` scripts."""
