"""Adversarial fleet: byzantine fault injection and robust aggregation
over the packed wire layout (the port of the JAX package's
``repro.robust``).

* `attacks` — a deterministic subset of clients (per
  ``RobustConfig.seed``) transforms its packed uplink wire buffers
  (sign-flip, scale, random wire); another subset trains on noisy
  labels; the scheduler injects dropout/rejoin delays.
* `aggregators` — the robust combine of the ``(K, rows, cols)`` arrival
  stack: ``trimmed_mean``, ``coordinate_median`` (the maximal trim) and
  ``norm_clip``, all through the CUDA kernel of
  `repro_torch.kernels.robust_agg`.

Degenerate settings (`aggregators.resolve` gives ``"mean"``, or no
byzantine client) leave the callers on their plain mean path, bitwise.
"""
from repro_torch.configs.base import (AGGREGATORS, ATTACKS,  # noqa: F401
                                      RobustConfig)
from repro_torch.robust.aggregators import (aggregate_stack,  # noqa: F401
                                            clip_scales, resolve,
                                            trim_count)
from repro_torch.robust.attacks import (attack_wires,  # noqa: F401
                                        byzantine_mask, corrupt_labels,
                                        label_noise_mask,
                                        wire_attack_active)
