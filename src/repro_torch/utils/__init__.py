"""Small utilities of the port: the tabular ``Logger``."""
from .logger import Logger  # noqa: F401
