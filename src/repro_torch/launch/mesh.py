"""Device placement for the decoupled async runner, port of
``repro/launch/mesh.py::split_actor_learner``.

Only the actor / learner split is ported.  The meshes (``make_data_mesh``,
the 2-D mesh, ``install``) come with the distributed half of ROADMAP Queue 1
item 12; ``split_actor_learner(mesh=...)`` raises until then.
"""
from __future__ import annotations

import torch


def split_actor_learner(devices, *, mesh=None):
    """Disjoint devices for the decoupled async runner (paper §2.3).

    ``devices``: the ``torch.device``s to choose from.  Returns
    ``(actor_device, learner_device)``.  With several devices the learner
    pins to the FIRST and the actor to the LAST, so the rollout and the
    update never contend for one device; the rest stay free for a future
    sharded learner.  With one device both share it, and the runner gives
    actor and learner a CUDA stream each.
    """
    if mesh is not None:
        raise NotImplementedError(
            "split_actor_learner: mesh= is not ported to repro_torch yet "
            "(ROADMAP Queue 1, item 12)")
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("no devices available")
    if len(devs) == 1:
        return devs[0], devs[0]
    return devs[-1], devs[0]
