"""Replay of the port (so far the device-resident ring with its sum tree;
the host buffers follow with the async slice)."""
from . import device  # noqa: F401
from .interface import ReplayLike, DeviceReplay, transition_example  # noqa: F401
