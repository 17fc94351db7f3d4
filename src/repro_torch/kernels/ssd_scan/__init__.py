"""Mamba-2 SSD chunked scan: the hand-written CUDA kernel
(``csrc/ssd_scan.cu``) behind ``ops.ssd_scan``, and its plain version
``ssd_reference`` (the port's ``models/layers.py::ssd_chunked``)."""
from .ops import ssd_scan  # noqa: F401
from .ref import ssd_reference  # noqa: F401
