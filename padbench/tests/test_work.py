"""The operation and byte counts against counts made by hand."""

from __future__ import annotations

import pytest

from padbench import work
from padbench.harness import Manifest
from padbench.tests.tiny import REPO


@pytest.fixture(scope="module")
def cfg():
    return Manifest(REPO).config("vit_b16_mlp_head")


def test_forward_flops_by_hand(cfg):
    t, d, f = 197, 768, 3072
    layer = (2 * t * d * 3 * d      # qkv
             + 2 * t * t * d        # scores, all heads
             + 2 * t * t * d        # weights x values
             + 2 * t * d * d        # proj
             + 2 * t * d * f        # fc1
             + 2 * t * f * d)       # fc2
    stem = 2 * 196 * (16 * 16 * 3) * d
    head = 2 * d * 512 + 2 * 512 * 2
    assert work.tokens(cfg) == t
    assert work.forward_flops(cfg) == 12 * layer + stem + head
    assert work.forward_flops(cfg) == 35_126_908_928
    assert round(work.forward_flops(cfg) / 1e10, 4) == 3.5127
    assert work.train_flops(cfg) == 3 * work.forward_flops(cfg)


def test_linear_head(cfg):
    lin = dict(cfg, head="linear")
    assert (work.forward_flops(cfg) - work.forward_flops(lin)
            == 2 * 768 * 512 + 2 * 512 * 2 - 2 * 768 * 2)


def test_kernel_counts_use_the_real_tokens(cfg):
    b, t, d = 128, 197, 768
    flops, nbytes = work.attention_block(cfg, b)
    assert flops == 2 * b * t * d * 4 * d + 4 * b * t * t * d
    assert nbytes == 2 * b * t * d * 2 + 4 * d * d * 2 + 6 * d * 4
    flops, nbytes = work.mlp_block(cfg, b)
    assert flops == 4 * b * t * d * 3072
    flops, nbytes = work.attention_qkv_bwd(cfg, b)
    assert flops == 10 * b * t * t * d and nbytes == b * t * 7 * d * 2
    # kernel 1's bound at B 128 is its operations: 0.136 ms
    s, by = work.bound_s(*work.attention_block(cfg, b), 989e12)
    assert by == "operations" and s == pytest.approx(1.358e-4, rel=1e-3)
    # kernel 4's is its bytes
    assert work.bound_s(*work.attention_qkv_bwd(cfg, b), 989e12)[1] == "bytes"

