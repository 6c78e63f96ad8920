"""The operation and byte counters against counts made by hand."""

import json
import os

import pytest

from port_bench import flops

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def so400m():
    with open(os.path.join(HERE, "configs", "siglip-so400m-384.json")) as f:
        return json.load(f)["model"]


def test_image_flops_by_hand():
    m = so400m()
    s, d, mlp = 729, 1152, 4304
    layer = 2 * s * d * 3 * d + 2 * 2 * s * s * d + 2 * s * d * d + 2 * 2 * s * d * mlp
    head = 2 * s * d * 2 * d + 2 * 2 * s * d + 2 * 2 * d * d + 2 * 2 * d * mlp
    hand = 2 * s * 588 * d + 27 * layer + head
    assert flops.image_flops(m) == pytest.approx(hand, rel=1e-12)
    assert 665e9 < flops.image_flops(m) < 675e9  # "about 670 GFLOP an image"


@pytest.mark.parametrize("b", [1, 7, 128])
def test_image_ops_scale_with_the_batch(b):
    m = so400m()
    one, many = flops.image_ops(m, 1), flops.image_ops(m, b)
    assert [n for n, _, _ in one] == [n for n, _, _ in many]
    assert len(one) == 1 + 4 * 27 + 3
    assert sum(f for _, f, _ in many) == pytest.approx(b * sum(f for _, f, _ in one), rel=1e-9)


def test_image_bytes_by_hand():
    """One layer's LN + QKV at B images: x in, the weights, q, k, v out."""
    m = so400m()
    b, s, d = 3, 729, 1152
    name, f, nbytes = flops.image_ops(m, b)[1]
    assert name == "ln_qkv"
    assert nbytes == b * s * d * 2 + 3 * d * d * 2 + 3 * b * s * d * 2
    assert f == 2 * b * s * d * 3 * d


def test_bound_is_operations_or_bytes():
    # 2 GB read once at 3.35 TB/s, against few operations: the bytes bound
    assert flops.bound_s(1e9, 2e9) == pytest.approx(2e9 / 3.35e12)
    assert flops.bound_s(989e12, 1.0) == pytest.approx(1.0)


def test_image_batch_is_compute_bound_at_128():
    m = so400m()
    total = sum(flops.bound_s(f, n) for _, f, n in flops.image_ops(m, 128))
    assert total == pytest.approx(128 * flops.image_flops(m) / flops.PEAK_BF16, rel=0.01)
