"""The yardstick's arithmetic: the card's published peaks, a cell's model
FLOPs and the bytes of its optimiser and uplink kernels, worked out from
the configuration and the traffic alone, and the classes of device
activities by name.

Peaks: NVIDIA's data sheet for the H100 SXM (NVIDIA H100 80GB HBM3, the
700 W part): dense bf16 on the tensor cores 989.4e12 FLOP/s, HBM
3.35e12 B/s.  A card set below 700 W (``nvidia-smi`` power.limit) runs
slower; shares are stated against these peaks with the limit beside
them.
"""
from __future__ import annotations

from portbench import cells, weights

PEAK_BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12
#: coordinates of one row of the packed wire layout (the program's
#: ``CommConfig.quant_block``)
PACK_COLS = 1024

#: device-activity classes of a trace, by words of the activity's name
#: (first match wins)
ACTIVITY_CLASSES = (("sophia", ("sophia",)),
                    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_",
                              "cublas")),
                    ("copy", ("copy",)),
                    ("reduction", ("reduce",)),
                    ("index", ("index", "gather", "scatter")),
                    ("elementwise", ("elementwise",)))


def activity_class(name: str) -> str:
    low = name.lower()
    for label, words in ACTIVITY_CLASSES:
        if any(w in low for w in words):
            return label
    return "other"


def refreshes_per_round(traffic: dict) -> float:
    """GNB refreshes a client makes a round, on average over the
    refresh period: local step j of round r refreshes when ``(r * J +
    j) % tau == 0``."""
    J, tau = traffic["local_iters"], traffic["tau"]
    hits = sum((r * J + j) % tau == 0 for r in range(tau) for j in range(J))
    return hits / tau


def trained_tokens(traffic: dict) -> int:
    """Tokens trained a round: clients x local steps x batch x seq (the
    GNB's passes not counted)."""
    return (traffic["clients"] * traffic["local_iters"] * traffic["batch"]
            * traffic["seq"])


def model_flops(conf, traffic: dict) -> float:
    """Model FLOPs a round: 6 x active parameters (``active_params`` of
    ``conf``'s arch) x trained tokens, plus one forward and backward (6 x
    active x tokens of a batch) per GNB refresh of each client.
    Attention's score products and recompute are not counted."""
    tokens = trained_tokens(traffic)
    gnb = (traffic["clients"] * refreshes_per_round(traffic)
           * traffic["batch"] * traffic["seq"])
    return 6.0 * cells.arch_of(conf).active_params(conf) * (tokens + gnb)


def packed_rows(conf) -> int:
    return -(-weights.count(conf) // PACK_COLS)


def sophia_bytes(conf, traffic: dict) -> float:
    """Bytes of a round's Sophia updates: per client and local step,
    theta, m, h, g and h_hat read once and theta, m, h written once, each
    fp32 over the packed layout."""
    P = packed_rows(conf) * PACK_COLS
    return float(traffic["clients"] * traffic["local_iters"] * 8 * 4 * P)


def quant_bytes(conf, traffic: dict) -> float:
    """Bytes of a round's int8 uplink round trips: per client the delta
    and its noise read once, the row scales read once, the
    reconstruction written once (fp32)."""
    rows = packed_rows(conf)
    P = rows * PACK_COLS
    return float(traffic["clients"] * (3 * 4 * P + 4 * rows))
