"""Program counters of the port's kernels: how often a mechanism of the
card path engaged since the kernels' counters were last reset
(``reset_launches`` of each kernel module).  Each reads a kernel
wrapper's ``LAUNCHES`` / ``STEPS`` counts, which count launches on the
card only (a CPU call runs the plain version and counts nothing).

* `sophia_leaf_route_share` — of the Sophia steps run on the card, the
  share that took the leaf route at the loss/grad boundary (the grads
  and h_hat read as autograd's leaves, the next forward's params leaves
  stored by the kernel; `repro_torch.kernels.sophia_update.
  sophia_update_leaves`).  Every step of a round over fp32 resident m
  and h takes it; a narrow ``state_dtype`` keeps the packed route.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import sophia_update


def sophia_leaf_route_share() -> Optional[float]:
    """Sophia steps on the leaf route over all Sophia steps on the card;
    None before any step.  A flat or batched launch is one step; a leaf
    route step counts once however many launches its table took."""
    leaf = sophia_update.STEPS["sophia_update_leaves"]
    total = (leaf + sophia_update.LAUNCHES["sophia_update_flat"]
             + sophia_update.LAUNCHES["sophia_update_batched"])
    return leaf / total if total else None
