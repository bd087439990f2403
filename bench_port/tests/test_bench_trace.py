"""The trace's reduction, on events written out by hand."""

import pytest

from bench_port.trace import WINDOW, reduce_events


def ev(name, dev, s, e):
    return (name, dev, s * 1000, e * 1000)  # microseconds to ns


def test_busy_is_the_union_and_gaps_are_named():
    events = [
        ev(WINDOW, False, 0, 100),
        ev("input", False, 0, 5), ev("step_call", False, 5, 60), ev("read", False, 60, 100),
        ev("k1", True, 10, 30), ev("k2", True, 20, 40),  # overlapping: 30 us busy
        ev("memcpy", True, 70, 80),
        ev("step_call", True, 10, 40),  # a span's annotation on the device: not an op
    ]
    t = reduce_events(events, frames=2)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.device_ops == 3
    assert [n for n, _ in t.top_ops] == ["k1", "k2", "memcpy"]
    assert t.idle_gaps[0] == ("step_call", pytest.approx(30e-6))
    assert ("input", pytest.approx(10e-6)) in t.idle_gaps
    assert ("read", pytest.approx(20e-6)) in t.idle_gaps


def test_no_device_activity_fails():
    with pytest.raises(RuntimeError):
        reduce_events([ev(WINDOW, False, 0, 10)], frames=1)
