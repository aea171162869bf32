"""The FLOP and byte counts of ``reference/work.py`` against counts by
hand and against PyTorch's FLOP counter on the plain reference."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import harness
from gpubench.reference import mast3r_plain, work
from gpubench.tests.tiny import TINY

M = dict(TINY, patch_size=16, mlp_ratio=4, rope_base=100.0)


def test_encode_by_hand():
    # 4 x 6 patches, E = 64, one block: patch embed, qkv, two attention
    # products, proj, fc1 and fc2, 2 operations a multiply-add
    m = dict(M, enc_depth=1)
    n, E = 24, 64
    hand = (2 * n * 768 * E + 2 * n * E * 3 * E + 2 * 2 * n * n * E
            + 2 * n * E * E + 2 * 2 * n * E * 4 * E)
    assert work.call_flops(m, "encode", 1) == hand
    assert work.call_flops(m, "encode", 3) == 3 * hand


def test_rope_bytes_by_hand():
    # encoder launch at b = 2: q and k in and out as float32, one table pair
    n, E, hd = 24, 64, 16
    (launches, per), = work.rope_launches(M, "encode", 2)
    assert launches == 2
    assert per == 2 * (2 * n * E * 4) * 2 + 2 * (2 * n * hd * 4)
    # a symmetric call of one edge decodes two pairs
    self_, cross = work.rope_launches(M, "inference_symmetric", 1)
    assert self_[0] == cross[0] == 8
    assert cross[1] - self_[1] == 2 * (2 * n * 12 * 4)


@pytest.mark.parametrize("kind,b", [("encode", 3), ("inference_mono", 2),
                                    ("inference_asymmetric", 1),
                                    ("inference_symmetric", 2)])
def test_against_flop_counter(kind, b):
    w = harness.make_weights(M, 1, "cpu")
    net = mast3r_plain.Net(w, M)
    img = torch.randint(0, 255, (b, 64, 96, 3), dtype=torch.uint8)
    f = net.encode(img)
    with FlopCounterMode(display=False) as fc:
        if kind == "encode":
            net.encode(img)
        else:
            bb = work.decode_batch(kind, b)
            g = f.repeat(bb // b, 1, 1)
            net.decode_pair(g, g)
    assert fc.get_total_flops() == work.call_flops(M, kind, b)
