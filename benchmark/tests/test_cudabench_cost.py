"""The yardstick's operation and byte counts, against hand-computed
counts at small shapes."""

import json
import os

import pytest

from benchmark.cost import mobilenet_v2 as mcost
from benchmark.cost import peaks
from benchmark.cost import transformer as tcost

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(name):
    with open(os.path.join(HERE, "configs", name)) as f:
        return json.load(f)


TINY_LM = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16,
           "num_hidden_layers": 3, "vocab_size": 10}


def test_mobilenet_v2_published_count():
    # 2 x 300.8M multiply-adds (Sandler et al. Table 3 rounds to 300M)
    assert mcost.frame_flops(_cfg("mobilenet_v2_1.0_224.json")) == 601551104


def test_mobilenet_v2_hand_count_small():
    cfg = {"width_multiplier": 1.0, "input_size": 8, "first_channels": 8,
           "last_channels": 16, "num_classes": 4,
           "inverted_residual_setting": [[1, 8, 1, 1], [2, 16, 1, 2]]}
    # stem 3x3 s2: 8 -> 4x4, 3 -> 8: 2*9*3*8*16 = 6912
    # block t=1: dw 3x3 on 8 ch at 4x4: 2*9*1*8*16 = 2304;
    #   project 8 -> 8: 2*8*8*16 = 2048
    # block t=2: expand 8 -> 16 at 4x4: 2*8*16*16 = 4096;
    #   dw s2 -> 2x2 on 16 ch: 2*9*16*4 = 1152; project 16 -> 16 at 2x2:
    #   2*16*16*4 = 2048
    # head 16 -> 16 at 2x2: 2048; classifier 16 -> 4: 128
    assert mcost.frame_flops(cfg) == 6912 + 2304 + 2048 + 4096 + 1152 \
        + 2048 + 2048 + 128


def test_mistral_param_count():
    cfg = _cfg("mistral_7b_v0.1.json")
    assert tcost.params_count(cfg) == 7241732096
    assert tcost.layer_matmul_params(cfg) == 218103808


def test_token_flops_tiny():
    # per layer: q 8x8 + k,v 8x4 each + o 8x8 + 3 x 8x16 = 64+64+64+384
    assert tcost.layer_matmul_params(TINY_LM) == 576
    # ctx 5: per layer 2*576 + 4*2*4*5 = 1312; 3 layers; head 2*8*10
    assert tcost.token_flops(TINY_LM, 5) == 3 * 1312 + 160
    assert tcost.token_flops(TINY_LM, 5, head=False) == 3 * 1312


def test_decode_attn_tiny():
    flops, nbytes = tcost.decode_attn(TINY_LM, ctx=5, block_size=4)
    assert flops == 4 * 2 * 4 * 5
    # K and V: 2*5*1*4*2 = 80; q and out: 2*2*4*2 = 32; table 2 blocks
    # *4 + pos 4 = 12
    assert nbytes == 80 + 32 + 12


def test_prefill_attn_tiny():
    # 3 rows at positions 4, 5, 6 see 5, 6, 7 keys = 18
    flops, nbytes = tcost.prefill_attn(TINY_LM, pos0=4, c=3, block_size=4)
    assert flops == 4 * 2 * 4 * 18
    # K and V of 7 keys: 2*7*1*4*2 = 112; q and out 2*3*2*4*2 = 96; 2 blocks
    assert nbytes == 112 + 96 + 8


def test_chunks():
    assert tcost.chunks(100, 512) == [(0, 100)]
    assert tcost.chunks(1100, 512) == [(0, 512), (512, 512), (1024, 76)]
    assert tcost.chunks(1024, 512) == [(0, 512), (512, 512)]
    assert tcost.chunks(7, 0) == [(0, 7)]


def test_prefill_flops_counts_head_once():
    lin = 3 * 2 * 576 * 3
    att = 3 * 4 * 2 * 4 * (1 + 2 + 3)
    assert tcost.prefill_flops(TINY_LM, 0, 3) == lin + att + 160


def test_peaks_and_least_time():
    assert peaks.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3350e9)
    assert peaks.peaks("cpu") is None
    assert peaks.least_time(989e12, 0, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(1.0)
    assert peaks.least_time(0, 3350e9, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(1.0)
