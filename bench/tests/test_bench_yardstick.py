"""The benchmark's FLOP and byte arithmetic against hand counts, and each
cell's yardstick outputs as constants: moving a configuration's counts into
a file of its own changes none of them by a bit."""
import pytest

from bench import spec, yardstick

BENCH = spec.load_benchmark()


def _cell(name):
    entry = spec.cell(BENCH, name)
    return spec.config(BENCH, entry), spec.traffic(entry["traffic"])


def test_vgg9_forward_flops_by_hand():
    cfg, _ = _cell("vgg9-k20-fedldf")
    # 2·H·W·9·cin·cout per convolution at 32, 32, 16, 16, 8, 8, 4, 4
    convs = [(32, 3, 64), (32, 64, 64), (16, 64, 128), (16, 128, 128),
             (8, 128, 256), (8, 256, 256), (4, 256, 512), (4, 512, 512)]
    hand = sum(2 * s * s * 9 * a * b for s, a, b in convs) + 2 * 2048 * 10
    assert hand == 418_816_000
    counts = spec.counts("vgg9-cifar10")
    assert counts.forward_flops(cfg["model"], {}) == hand


def test_vgg9_round_flops():
    """8.04e11 training FLOPs a round (3 × forward × K=20 × B=32), plus
    the evaluation's forward of 10,000 images every 10 rounds."""
    cfg, traffic = _cell("vgg9-k20-fedldf")
    train = 3 * 418_816_000 * 20 * 32
    assert train == pytest.approx(8.04e11, rel=1e-3)
    assert yardstick.round_model_flops(cfg, traffic) == \
        train + 418_816_000 * 10_000 / 10


def test_kernel1_bytes_at_k20():
    """Eq. 3 reads 20 locals and the global model once (396 MB) and writes
    the (20, 9) f32 divergences."""
    cfg, traffic = _cell("vgg9-k20-fedldf")
    got = yardstick.fl_kernel_bytes_per_round(cfg, traffic)
    assert got == {"sqdiff": 21 * 4 * 4_709_706 + 4 * 20 * 9}
    assert got["sqdiff"] == pytest.approx(396e6, rel=2e-3)


def test_kernel4_bytes_at_k20():
    cfg, traffic = _cell("vgg9-k20-int8ef")
    p = 4_709_706
    got = yardstick.fl_kernel_bytes_per_round(cfg, traffic)
    assert got["fused_uplink_ef"] == 20 * p * 13 + 4 * p + 12 * 20 * 9


def test_scan_round_kernel_bytes():
    cfg, traffic = _cell("hymba-ft-seq512")
    p = 1_640_872_320
    got = yardstick.fl_kernel_bytes_per_round(cfg, traffic)
    assert got == {"sqdiff": 4 * (8 * p + 4 * 34),
                   "masked_accumulate": 4 * (12 * p + 4 * 34)}


def test_parameter_counts():
    vgg, _ = _cell("vgg9-k20-fedldf")
    hymba, _ = _cell("hymba-ft-seq512")
    assert yardstick.param_count(vgg) == 4_709_706
    assert yardstick.param_count(hymba) == 1_640_872_320
    assert yardstick.num_units(vgg) == 9 and yardstick.num_units(hymba) == 34


def test_hymba_flops_by_hand():
    cfg, traffic = _cell("hymba-ft-seq512")
    m, seq = cfg["model"], 512
    matmul = 1_640_872_320 - 32_001 * 1600          # all but the lookup
    attn = 32 * 4 * (512 * 513 // 2) * 64 * 25       # QKᵀ and PV, causal
    q, n, p, h = 128, 16, 64, 50
    ssd = 32 * 4 * (2 * q * q * n + 2 * q * q * p * h + 4 * q * n * p * h)
    fwd = 2 * matmul * seq + attn + ssd
    counts = spec.counts("hymba-1.5b")
    assert counts.forward_flops(m, traffic["data"]) == fwd
    assert counts.attention_flops(m, seq) == attn
    # 6·N·tokens dominates: 4,096 tokens a round
    assert 3 * fwd * 8 == pytest.approx(6 * matmul * 4096, rel=0.05)
    assert yardstick.attention_flops_per_round(cfg, traffic) == \
        attn * (2 * 4 * 2 + 32 / 4)


def test_packed_int8_uplink_bytes():
    """n·Σ_u(params_u + 5) + K·U·4 = 18,839,724 B a round at VGG-9."""
    import torch

    from bench.reference import fl
    cfg, traffic = _cell("vgg9-k20-int8ef")
    ref = spec.reference("vgg9-cifar10")
    params = {}
    for path, shape, _ in ref.param_spec(cfg["model"]):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.zeros(shape, device="meta")
    _, units, sizes = fl.unit_layout(params)
    assert units == 9 and sum(sizes) == 4_709_706
    assert 4 * sum(s + 5 for s in sizes) + 20 * 9 * 4 == 18_839_724


# (param_count, num_units, round_model_flops, attention_flops_per_round,
#  fl_kernel_bytes_per_round) of each cell, as the yardstick gave them when
# every configuration's counts were still its own code
TABLE = {
    "vgg9-k20-fedldf": (4_709_706, 9, 1222942720000.0, 0.0,
                        {"sqdiff": 395_616_024}),
    "vgg9-k20-int8ef": (4_709_706, 9, 1222942720000.0, 0.0,
                        {"sqdiff": 395_616_024,
                         "fused_uplink_ef": 1_243_364_544}),
    "hymba-ft-seq512": (1_640_872_320, 34, 53490019729408.0,
                        645503385600.0,
                        {"sqdiff": 52_507_914_784,
                         "masked_accumulate": 78_761_871_904}),
}


def test_table_covers_every_cell():
    assert set(TABLE) == {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("name", sorted(TABLE))
def test_yardstick_outputs_bit_for_bit(name):
    cfg, traffic = _cell(name)
    params, units, flops, attention, fl_bytes = TABLE[name]
    assert yardstick.param_count(cfg) == params
    assert yardstick.num_units(cfg) == units
    got = yardstick.round_model_flops(cfg, traffic)
    assert got == flops and type(got) is float
    got = yardstick.attention_flops_per_round(cfg, traffic)
    assert got == attention and type(got) is float
    assert yardstick.fl_kernel_bytes_per_round(cfg, traffic) == fl_bytes
