"""Plain-PyTorch version of the SSD kernel: the port's
``models/layers.py::ssd_chunked`` (the exact math the mamba2 backbone trains
with).  Port of ``repro/kernels/ssd_scan/ref.py``."""
from __future__ import annotations

from ...models.layers import ssd_chunked


def ssd_reference(x, dt, A, Bmat, Cmat, *, chunk: int = 64, state=None):
    """x:(B,T,H,P) dt:(B,T,H) A:(H,)<0  B/C:(B,T,G,N) -> (y, final_state)."""
    return ssd_chunked(x, dt, A, Bmat, Cmat, chunk, state)
