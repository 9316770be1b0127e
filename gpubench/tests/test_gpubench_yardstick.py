"""The frozen decode_bound at shapes whose bounds PERF.md's kernel table
states (NVIDIA H100 peaks, K=69, 3 operators)."""

import pytest

from gpubench.yardstick import MEM_BW, PEAK, decode_bound

T, P, K, G = 8192, 8192, 69, 3


def test_exact_forward_counts():
    b = decode_bound("forward", T, P, K, G, False, "exact")
    nbytes = 4 * (2 * T * P + 3 * T * K) + G * K * K * 8 + T * K * P * 4
    flop = 2 * (T - 1) * P * K * K
    assert b["ms"] == pytest.approx(1e3 * max(nbytes / MEM_BW,
                                              3 * flop / PEAK["tf32"]))
    assert b["by"] == "bytes" and b["ms"] == pytest.approx(5.69, abs=0.01)
    assert b["op_ms"] == pytest.approx(1e3 * 3 * flop / PEAK["tf32"])


@pytest.mark.parametrize("T_, outs, ms, by", [
    (8192, dict(posterior_sums=True, major_minor_sums=True), 9.54,
     "operations"),
    (1024, dict(posterior=True, threshold_sums=True), 1.41, "bytes"),
])
def test_exact_backward_as_the_kernel_table(T_, outs, ms, by):
    b = decode_bound("backward", T_, P, K, G, False, "exact", outs)
    assert b["ms"] == pytest.approx(ms, abs=0.01) and b["by"] == by


def test_outputs_add_their_bytes():
    base = decode_bound("backward", 1024, P, K, G, False, "fast")
    post = decode_bound("backward", 1024, P, K, G, False, "fast",
                        dict(posterior=True))
    assert base["by"] == post["by"] == "bytes"
    assert post["ms"] - base["ms"] == pytest.approx(
        1e3 * 4 * 1024 * K * P / MEM_BW)
