"""Each kernel's count at the headline shapes against its closed form, and
the least time and what sets it."""

import pytest

from chipbench.harness import peaks, registry

U, P, T, K, B = 131_072, 25, 64, 64, 16
NV = 13 * U                     # valid paths: the mean of 1..25 per user
HEAD = dict(users=U, max_paths=P, valid_paths=NV, rx=1, tx=T, k=K, beams=B)
PER_PATH = 4 * 7 * U * P        # the 7 float32 [U, P] inputs

CASES = {
    # name: (bytes, flops, least ms, set by)
    "render_fwd": (PER_PATH + 4 * U * T * 2 * K, 8 * T * K * NV,
                   (PER_PATH + 4 * U * T * 2 * K) / 3.35e9, "bytes"),
    "render_bwd": (2 * PER_PATH + 4 * U * T * 2 * K, 16 * T * K * NV,
                   (2 * PER_PATH + 4 * U * T * 2 * K) / 3.35e9, "bytes"),
    "beam_gain": (PER_PATH + 8 * B * T + 4 * U * B * K,
                  8 * B * T * NV + 8 * B * K * NV + 3 * U * B * K,
                  (PER_PATH + 8 * B * T + 4 * U * B * K) / 3.35e9, "bytes"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_headline_count(name):
    n_bytes, flops, ms, by = CASES[name]
    got = registry.load_module("roofline", name).count(HEAD)
    assert got == (n_bytes, flops)
    t, b = peaks.bound_s(*got)
    assert b == by and t * 1e3 == pytest.approx(ms, rel=1e-12)


def test_headline_numbers():
    """The figures PERF.md quotes: 1.3095 ms (render, bytes), 0.1877 ms (beam
    gain, bytes; its operations 0.171 ms)."""
    fwd = peaks.bound_s(*registry.load_module("roofline",
                                              "render_fwd").count(HEAD))
    bg_bytes, bg_flops = registry.load_module("roofline",
                                              "beam_gain").count(HEAD)
    assert fwd[0] * 1e3 == pytest.approx(1.3095, abs=1e-4)
    assert bg_bytes / 3.35e12 * 1e3 == pytest.approx(0.1877, abs=1e-4)
    assert 3 * bg_flops / 495e12 * 1e3 == pytest.approx(0.1716, abs=1e-4)


def test_operations_can_set_the_bound():
    # past ~49 valid paths per user the products outgrow the bytes
    s = dict(HEAD, max_paths=100, valid_paths=100 * U)
    assert peaks.bound_s(*registry.load_module("roofline",
                                               "render_fwd").count(s))[1] \
        == "operations"
