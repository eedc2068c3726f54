"""How a weight leaf is made (`portbench.weights.make`), the kinds an
arch's schema gives its leaves.

A drawn kind takes the leaf's slice of one N(0, 1) draw of its dtype
(every drawn leaf of that dtype in schema order, one ``torch.randn``),
viewed to the leaf's shape; an undrawn kind gets an empty tensor of the
leaf's shape.  ``make(x, conf)`` turns that into the leaf.  An arch
module defines kinds of its own as more `Init` values."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch


@dataclass(frozen=True)
class Init:
    drawn: bool
    make: Callable[[torch.Tensor, Any], torch.Tensor]


#: every norm weight
ONES = Init(False, lambda x, conf: x.fill_(1))
#: the token table: N(0, (0.02 / scale_emb)^2)
EMBED = Init(True, lambda x, conf: x * (0.02 / conf.scale_emb))
#: a matrix: N(0, 1 / d_in), d_in its next-to-last axis
DENSE = Init(True, lambda x, conf: x * (1.0 / math.sqrt(x.shape[-2])))

#: key -> (shape, dtype, init) of every leaf
Schema = Dict[str, Tuple[Tuple[int, ...], torch.dtype, Init]]
