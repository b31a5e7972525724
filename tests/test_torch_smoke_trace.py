"""chip_smoke.py's reading of a profiler trace: the device ms of each
traced call, where the profiler dropped kernels or whole calls."""
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(calls, per_call=(10.0, 30.0), drop=()):
    """A Timer loop's kernels: a flush, then ``per_call``'s kernels (dur
    in us), ``calls`` times, and a closing flush; ``drop`` holds the
    indices of the events the profiler lost."""
    events = []
    for _ in range(calls):
        events.append(dict(name="at::native::bitwise_not_kernel", dur=50.0))
        events += [dict(name=f"k{i}", dur=d) for i, d in enumerate(per_call)]
    events.append(dict(name="at::native::bitwise_not_kernel", dur=50.0))
    for ts, e in enumerate(events):
        e["ts"] = float(ts)
    kept = [e for i, e in enumerate(events) if i not in set(drop)]
    return kept[::-1]  # the order of the trace's events is not relied on


@pytest.mark.parametrize("drop,want", [
    ((), 5),
    ((0, 1, 2, 3, 4, 5), 3),  # the first two calls lost whole
    ((4,), 4),  # one kernel of call 1 lost
    ((3,), 3),  # the flush between calls 0 and 1: they read as one
    ((15,), 4),  # the closing flush: the last call is not whole
    ((2, 7), 3),  # a kernel of each of calls 0 and 2
])
def test_call_device_ms_keeps_whole_calls(smoke, drop, want):
    ms = smoke.call_device_ms(_trace(5, drop=drop))
    assert ms == [0.04] * want


def test_call_device_ms_without_flush_reads_nothing(smoke):
    ev = [e for e in _trace(3) if "bitwise_not" not in e["name"]]
    assert smoke.call_device_ms(ev) == []
