"""The phase, idle and roofline arithmetic of the per-layer readers, on a
made-up context."""

import pytest

from pupbench import harness, readers, spec
from pupbench.trace import Trace, union


def trace(window_s=1.0):
    ev = [
        {"ph": "X", "cat": "kernel", "name": "quad_accumulate_staged_kernel",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 120, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 500,
         "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 230,
         "dur": 260},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 240,
         "dur": 20},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]
    return Trace(ev, window_s)


def test_union_and_busy():
    assert union([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    t = trace()
    assert t.busy_s() == pytest.approx((220 - 100 + 100) * 1e-6)
    assert t.kernel_s(["quad_accumulate_staged_kernel"]) == \
        pytest.approx(50e-6)


def test_idle_share():
    ctx = harness.Context(trace=trace(window_s=0.001))
    assert readers.idle_share(ctx) == pytest.approx(100 * (1 - 0.22))
    assert readers.idle_share(harness.Context()) is None
    empty = Trace([], 1.0)
    assert readers.idle_share(harness.Context(trace=empty)) is None


def test_breakdown_names_gaps_by_device_ops():
    b = trace().breakdown()
    assert b["device_ops"][0][0] == "other"
    [(name, seconds)] = b["idle_gaps"]
    assert seconds == pytest.approx(280e-6)
    assert name == "after other | before Memcpy HtoD"


def test_phase_per_job():
    ctx = harness.Context(phases=[{"coords": 2.0, "tiles": 1.0},
                                  {"coords": 4.0}, {}])
    assert readers.phase_per_job(ctx, "coords") == 3.0
    assert readers.phase_per_job(ctx, "tiles") == 0.5
    assert readers.phase_per_job(ctx, "wait") == 0.0
    assert readers.phase_per_job(harness.Context(), "coords") is None


class FakeWork:
    def bound_s(self):
        return 25e-6, "bytes"


def test_roofline_share():
    ctx = harness.Context(trace=trace(), work=[FakeWork()])
    assert readers.roofline_share(ctx, "quad_roofline") == \
        pytest.approx(50.0)
    # no wide kernel in the trace: nothing to read, never 0
    assert readers.roofline_share(ctx, "wide_roofline") is None
    assert spec.reader("quad_roofline")(ctx) == pytest.approx(50.0)
