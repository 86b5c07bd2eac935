"""The yardstick's counts against counts made by hand."""
from perfbench import counts, peaks

# per 32x32 image: im2col rows x K x N of each layer
HAND_RESNET8 = {
    "conv_init": 1024 * 27 * 16,
    "s0_b0_conv1": 1024 * 144 * 16, "s0_b0_conv2": 1024 * 144 * 16,
    "s1_b0_conv1": 256 * 144 * 32, "s1_b0_conv2": 256 * 288 * 32,
    "s1_b0_proj": 256 * 16 * 32,
    "s2_b0_conv1": 64 * 288 * 64, "s2_b0_conv2": 64 * 576 * 64,
    "s2_b0_proj": 64 * 32 * 64,
    "head": 64 * 10,
}


def resnet8(batch):
    return counts.resnet_projections(batch, 32, (16, 32, 64), 10)


def test_resnet8_lookups_by_layer():
    got = {p.name: p.lookups for p in resnet8(1)}
    assert got == HAND_RESNET8


def test_resnet8_pass_of_64_images():
    assert sum(p.lookups for p in resnet8(64)) == 800_104_448
    work = counts.pass_work(resnet8(64), 57, shared_input="conv_init")
    assert work["lookups"] == 57 * 800_104_448          # 4.56e10
    assert 5.4e-3 < work["lookups"] / peaks.LOOKUPS_PER_S < 5.5e-3


def qwen3_moe(tokens):
    return counts.moe_decoder_projections(
        tokens, n_layers=4, d_model=2048, n_heads=32, n_kv_heads=4,
        head_dim=128, n_experts=128, top_k=8, expert_width=768)


def test_qwen3_moe_lookups_a_token_and_layer():
    attn = 2048 * (32 * 128 + 2 * 4 * 128) + 32 * 128 * 2048
    experts = 8 * 3 * 2048 * 768
    assert attn + experts == 56_623_104
    per_token = sum(p.lookups for p in qwen3_moe(1)) / 4
    assert per_token == 56_623_104


def test_qwen3_moe_pass():
    work = counts.pass_work(qwen3_moe(1024), 8)
    assert work["lookups"] == 56_623_104 * 1024 * 4 * 8   # 1.86e12
    assert 0.221 < peaks.gather_floor_s(work["lookups"], work["bytes"]) \
        < 0.223


def test_floor_is_the_largest_of_three():
    lookups = 10 ** 9
    assert peaks.gather_floor_s(lookups, 0) == lookups / peaks.LOOKUPS_PER_S
    big = 10 ** 12
    assert peaks.gather_floor_s(lookups, big) == big / peaks.HBM_BYTES_PER_S
