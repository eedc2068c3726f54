"""The weights of a cell, made from the seed on the device, by the
schema of the configuration's arch (``schema(conf)`` of its reference
module: key -> shape, dtype and `portbench.reference.inits.Init`).  The
reference reads the same dict by the same keys.

Each dtype's drawn leaves (in schema order) come from one ``torch.randn``
call of that dtype on the device, the dtypes in order of their names;
every other leaf is made by its kind from an empty tensor.  The
decoder's kinds: every matrix N(0, 1/d_in), the token table N(0, (0.02 /
scale_emb)^2) (its scaled rows N(0, 0.02^2): a larger table makes a
tied head's logit of the input token dwarf the others, so the model
starts out certain of it and the GNB's sampled labels carry no
gradient), every norm weight 1.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench import cells
from portbench.reference.inits import Schema


def schema(conf) -> Schema:
    """key -> (shape, dtype, init) of every leaf, as ``conf``'s arch
    lays them out."""
    return cells.arch_of(conf).schema(conf)


def count(conf) -> int:
    """Parameters of the model (the padded token rows included, as the
    program holds and trains them)."""
    return sum(math.prod(s) for s, _, _ in schema(conf).values())


def make(conf, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The weights, on the generator's device."""
    dev = generator.device
    sch = schema(conf)
    out: Dict[str, torch.Tensor] = {}
    for dtype in sorted({dt for _, dt, _ in sch.values()}, key=str):
        keys = [k for k, (_, dt, init) in sch.items()
                if dt == dtype and init.drawn]
        n = sum(math.prod(sch[k][0]) for k in keys)
        if not n:
            continue
        draw = torch.randn(n, generator=generator, device=dev, dtype=dtype)
        off = 0
        for k in keys:
            shape, _, init = sch[k]
            size = math.prod(shape)
            out[k] = init.make(draw[off:off + size].view(shape), conf)
            off += size
        del draw
    for k, (shape, dt, init) in sch.items():
        if not init.drawn:
            out[k] = init.make(torch.empty(shape, dtype=dt, device=dev), conf)
    return {k: out[k] for k in sorted(out)}
