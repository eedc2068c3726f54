"""The whole round's share of the card's dense bf16 peak (989.4e12
FLOP/s, NVIDIA H100 SXM, 700 W; `portbench.cost`): model FLOPs a round
(`cost.model_flops`: 6 x active parameters x trained tokens, plus the
GNB's forward and backward per refresh; recompute not counted) over the
time of a round untraced (the mean over the untraced rounds run just
before the trace, three a traced round, CUDA events: the profiler's host
cost is not the program's)."""
from portbench import cost


def read(run):
    if run.trace is None or run.plain_round_s <= 0:
        return None
    flops = cost.model_flops(run.conf, run.traffic)
    return 100.0 * flops / run.plain_round_s / cost.PEAK_BF16_FLOPS
