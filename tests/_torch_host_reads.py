"""The host-read detector for the bodies the port captures in CUDA graphs.

``NoHostReads`` is a ``TorchDispatchMode`` that raises on a read of a
tensor's value by the host (``aten._local_scalar_dense``: ``item``,
``int``, ``bool``), a shape that depends on the data (``nonzero``,
``masked_select``, ``unique``), a tensor made from host data inside the
body (``aten.lift_fresh``, or an input that no op made and that did not
exist before the body ran: ``torch.as_tensor`` of a numpy array), and a
copy across devices: what a capture refuses or silently freezes.  Imports
torch only (never JAX), so the mesh tests' spawned ranks use it as the
test process does."""
import gc
import warnings

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


class HostRead(AssertionError):
    pass


class NoHostReads(TorchDispatchMode):
    """Raise on what a CUDA graph capture refuses or silently freezes (the
    module docstring lists it).  Tensors alive when the mode is entered (state,
    weights, cached constants) are known; so is every op's output."""

    BANNED = {aten._local_scalar_dense, aten.nonzero, aten.lift_fresh,
              aten.lift_fresh_copy, aten.masked_select, aten._unique2,
              aten.unique_consecutive, aten.unique_dim}
    # indexing by a boolean mask runs nonzero inside the op
    INDEXING = {aten.index, aten.index_put, aten.index_put_,
                aten._index_put_impl_}

    def __enter__(self):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self._alive = [t for t in gc.get_objects()
                           if isinstance(t, torch.Tensor)]
        self._known = {id(t) for t in self._alive}
        self._made = []
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket in self.BANNED:
            raise HostRead(f"host read or host data: {func}")
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if func.overloadpacket in self.INDEXING and any(
                t is not None and t.dtype == torch.bool for t in args[1]):
            raise HostRead(f"{func} by a boolean mask")
        if len({t.device for t in ins}) > 1:
            raise HostRead(f"{func} across devices "
                           f"{sorted(str(t.device) for t in ins)}")
        for t in ins:
            if id(t) not in self._known:
                raise HostRead(f"{func} reads a {tuple(t.shape)} tensor that "
                               "no op made (host data)")
        out = func(*args, **kwargs)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._known.add(id(t))
                self._made.append(t)
        return out
