"""The yardstick's counts at a tiny configuration against hand counts,
and the trace reduction on a hand-made trace."""
import pytest

from portbench import cells, cost, weights
from portbench.reference import decoder
from portbench.reference.decoder import MoE, Conf
from portbench.trace import Trace

DENSE = Conf(name="t", hidden_size=8, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, head_dim=4,
             intermediate_size=16, vocab_size=250, tie_word_embeddings=True,
             rope_theta=1e4, rms_norm_eps=1e-6, scale_emb=1.0,
             residual_scale=1.0)
MOE = Conf(name="m", hidden_size=8, num_hidden_layers=1,
           num_attention_heads=2, num_key_value_heads=2, head_dim=4,
           intermediate_size=0, vocab_size=256, tie_word_embeddings=False,
           rope_theta=1e4, rms_norm_eps=1e-6, scale_emb=1.0,
           residual_scale=1.0,
           moe=MoE(n_routed_experts=4, num_experts_per_tok=1,
                   moe_intermediate_size=2, n_shared_experts=1,
                   norm_topk_prob=True, capacity_factor=1.25,
                   aux_loss_coef=0.01))
TRAFFIC = {"clients": 3, "local_iters": 2, "tau": 2, "batch": 2, "seq": 5}


def test_dense_counts_by_hand():
    # embed 256x8; final norm 8; per layer: 2 norms of 8, q/k/v/o 8x8
    # each, gate/up 8x16, down 16x8
    per_layer = 2 * 8 + 4 * 64 + 3 * 128
    assert weights.count(DENSE) == 256 * 8 + 8 + 2 * per_layer == 3368
    assert decoder.active_params(DENSE) == 3368       # tied: table once
    # 3 clients x 2 steps x 10 tokens trained + 3 refreshes x 10 tokens
    assert cost.trained_tokens(TRAFFIC) == 60
    assert cost.model_flops(DENSE, TRAFFIC) == 6 * 3368 * (60 + 30)
    rows = -(-3368 // 1024)                            # 4
    assert cost.packed_rows(DENSE) == rows
    assert cost.sophia_bytes(DENSE, TRAFFIC) == 3 * 2 * 8 * 4 * rows * 1024
    assert cost.quant_bytes(DENSE, TRAFFIC) == 3 * (12 * rows * 1024
                                                   + 4 * rows)


def test_moe_active_params_by_hand():
    # table 256x8 (a lookup: not counted), head 8x256, final norm 8;
    # layer: norms 16, attention 4x64, router 8x4, experts 3 x 4x8x2
    # (one of four active), shared 2x(8x2) + 2x8
    routed = 3 * 4 * 8 * 2
    total = 256 * 8 + 8 * 256 + 8 + 16 + 256 + 32 + routed + 3 * 16
    assert weights.count(MOE) == total
    assert decoder.active_params(MOE) == total - 256 * 8 - routed * 3 / 4


#: the counts the readers take for each cell, as the benchmark computed
#: them before its archs became modules of their own: model FLOPs a
#: round, Sophia bytes a round, int8 uplink bytes a round
CELL_COUNTS = {
    "minicpm2b-l2.par-c4.j5.b2s256": (29876104986624.0, 259341680640.0,
                                      19456957632.0),
    "dsv2lite-l2.seq-c2-int8.b2s256": (6929063608320.0, 203408408576.0,
                                       38151491672.0),
    "minicpm2b-l2.par-c4.b4s512": (59752209973248.0, 103736672256.0,
                                   19456957632.0),
}


@pytest.mark.parametrize("cell", sorted(CELL_COUNTS))
def test_cell_counts_pinned(cell):
    bench = cells.Bench()
    w = bench.workload(cell)
    d = bench.config(w["config"])
    conf, tr = bench.arch(d).from_json(d), bench.traffic(w["traffic"])
    assert (cost.model_flops(conf, tr), cost.sophia_bytes(conf, tr),
            cost.quant_bytes(conf, tr)) == CELL_COUNTS[cell]


@pytest.mark.parametrize("J,tau,want", [(2, 2, 1.0), (3, 2, 1.5),
                                        (1, 3, 1 / 3), (4, 1, 4.0)])
def test_refreshes_per_round(J, tau, want):
    assert cost.refreshes_per_round({"local_iters": J,
                                     "tau": tau}) == pytest.approx(want)


def test_trace_reduction():
    t = Trace(rounds=2, start=0.0, end=100.0,
              kernels=[("void sophia_update_f32x4_kernel", 10, 30),
                       ("nvjet_gemm_a", 20, 40),
                       ("elementwise_kernel", 60, 70)],
              ranges={"span": [(15, 65)]},
              host=[("aten::mm", 0, 12), ("aten::add", 41, 59),
                    ("aten::copy_", 71, 100)])
    assert t.busy() == [(10, 40), (60, 70)]
    assert t.busy_s() == pytest.approx(40e-6)
    assert t.gaps() == [(0.0, 10), (40, 60), (70, 100.0)]
    assert t.named_s("sophia") == pytest.approx(20e-6)
    assert t.class_s("gemm") == pytest.approx(20e-6)
    # the activities that start inside the range, clipped at its end
    assert t.range_s("span") == pytest.approx((20 + 5) * 1e-6)
    assert t.range_s("none") is None
    b = t.breakdown()
    assert [v for _, v in b["device_ops"]] == pytest.approx(
        [20e-6, 20e-6, 10e-6])
    assert dict(map(tuple, b["idle_gaps"])) == pytest.approx(
        {"aten::copy_": 30e-6, "aten::add": 20e-6, "aten::mm": 10e-6})
