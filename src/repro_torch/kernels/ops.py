"""The pytree form of the fused Sophia update (the port of the JAX
package's ``kernels/ops.py:sophia_fused_step``): every leaf of the five
parameter trees packed into one ``(R, 1024)`` buffer each (sorted-key
order, `repro_torch.comm.flat`), one launch of the Sophia kernel
(``csrc/sophia_update.cu`` through `sophia_update.sophia_update_flat`),
and the results unpacked.  The round engine never takes this route: it
holds its state packed and calls the kernel directly.

For CPU trees the wrapped entry runs its plain version; ``LAUNCHES``
counts the calls that launched the kernel.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.comm.flat import flat_spec, pack, unpack
from repro_torch.kernels.sophia_update import sophia_update_flat

#: packed columns of the pytree route (the JAX package's ``BLOCK_C``)
BLOCK_C = 1024

#: kernel launches per entry point since the last `reset_launches`
LAUNCHES: Dict[str, int] = {"sophia_fused_step": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sophia_fused_step(params, m, h, grads, h_hat, do_h, *, lr, beta1,
                      beta2, rho, eps, weight_decay):
    """Fused m-EMA + gated h-EMA + decay + clip + update over parameter
    dicts (one kernel launch on the card).  ``do_h`` and ``lr`` are host
    scalars.  Returns ``(new_params, new_m, new_h)``."""
    spec = flat_spec(params, cols=BLOCK_C)
    t2, m2, h2, g2, hh2 = (pack(t, spec)
                           for t in (params, m, h, grads, h_hat))
    t2, m2, h2 = sophia_update_flat(
        t2, m2, h2, g2, hh2, do_h, lr, beta1=beta1, beta2=beta2, rho=rho,
        eps=eps, weight_decay=weight_decay, inplace=True)
    if t2.device.type == "cuda":
        LAUNCHES["sophia_fused_step"] += 1
    return unpack(t2, spec), unpack(m2, spec), unpack(h2, spec)
