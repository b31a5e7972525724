"""The port's preemption primitives (``tpuflow_torch/utils/preempt.py``)
against the JAX package's (``tpuflow/utils/preempt.py``): the grace
budget, the grace left and the emergency-save advice for the same
budgets, thresholds and elapsed times (the JAX side set through
``TPUFLOW_PREEMPT_GRACE_S`` / ``TPUFLOW_PREEMPT_EMERGENCY_S``, the port's
through arguments and ``configure``; both clocks pinned), and SIGTERM
setting the flag in both."""

import os
import signal
import time

import pytest

from tpuflow.utils import preempt as jp
from tpuflow_torch.train import step as tstep
from tpuflow_torch.utils import preempt as tp

BUDGETS = [None, 0.0, 5.0, 30.0, -3.0]
THRESHOLDS = [None, 0.0, 2.5, 40.0]
ELAPSED = [0.0, 1.0, 4.9, 31.0]


class _Clock:
    def __init__(self, now: float):
        self.now = now

    def monotonic(self) -> float:
        return self.now


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for k in ("TPUFLOW_PREEMPT_GRACE_S", "TPUFLOW_PREEMPT_EMERGENCY_S",
              "TPUFLOW_ATTEMPT"):
        monkeypatch.delenv(k, raising=False)
    jp.clear_preemption()
    tp.clear_preemption()
    yield
    jp.clear_preemption()
    tp.clear_preemption()
    tp.configure(grace_s=tp.DEFAULT_GRACE_S,
                 emergency_s=tp.DEFAULT_EMERGENCY_S, attempt=0)


def _readings(monkeypatch, budget, threshold, elapsed):
    """``(jax, port)`` of (grace_budget_s, grace_remaining_s,
    emergency_save_advised) after a request ``elapsed`` seconds ago."""
    if budget is not None:
        monkeypatch.setenv("TPUFLOW_PREEMPT_GRACE_S", str(budget))
    if threshold is not None:
        monkeypatch.setenv("TPUFLOW_PREEMPT_EMERGENCY_S", str(threshold))
    clock = _Clock(1000.0)
    monkeypatch.setattr(jp, "time", clock)
    monkeypatch.setattr(tp, "time", clock)
    jp.request_preemption()
    tp.request_preemption()
    clock.now += elapsed
    jax = (jp.grace_budget_s(), jp.grace_remaining_s(),
           jp.emergency_save_advised())
    port = (tp.grace_budget_s(budget), tp.grace_remaining_s(budget),
            tp.emergency_save_advised(threshold, budget))
    return jax, port


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_grace_matches_jax(monkeypatch, budget, threshold):
    for elapsed in ELAPSED:
        jax, port = _readings(monkeypatch, budget, threshold, elapsed)
        assert port == jax, (budget, threshold, elapsed)
        jp.clear_preemption()
        tp.clear_preemption()


def test_configured_settings_match_jax_env(monkeypatch):
    """The process's own settings (``configure``, as a gang member gets
    them) stand where the JAX package reads its environment."""
    tp.configure(grace_s=5.0, emergency_s=2.5, attempt=3)
    monkeypatch.setenv("TPUFLOW_ATTEMPT", "3")
    assert tp.launch_attempt() == jp.launch_attempt() == 3
    monkeypatch.setenv("TPUFLOW_PREEMPT_GRACE_S", "5")
    monkeypatch.setenv("TPUFLOW_PREEMPT_EMERGENCY_S", "2.5")
    clock = _Clock(50.0)
    monkeypatch.setattr(jp, "time", clock)
    monkeypatch.setattr(tp, "time", clock)
    for elapsed in (0.0, 2.4, 2.6, 9.0):
        jp.request_preemption()
        tp.request_preemption()
        clock.now += elapsed
        jax = (jp.grace_budget_s(), jp.grace_remaining_s(),
               jp.emergency_save_advised())
        port = (tp.grace_budget_s(), tp.grace_remaining_s(),
                tp.emergency_save_advised())
        assert port == jax, elapsed
        jp.clear_preemption()
        tp.clear_preemption()


def test_no_request_no_grace():
    assert tp.grace_remaining_s() is None is jp.grace_remaining_s()
    assert tp.emergency_save_advised(100.0) is False
    assert jp.emergency_save_advised(100.0) is False


def test_repeated_requests_keep_the_first_anchor(monkeypatch):
    clock = _Clock(10.0)
    monkeypatch.setattr(tp, "time", clock)
    tp.request_preemption()
    clock.now += 4.0
    tp.request_preemption()  # a second SIGTERM
    assert tp.grace_remaining_s(30.0) == 26.0


@pytest.mark.parametrize("pkg", [jp, tp], ids=["jax", "port"])
def test_sigterm_sets_preemption_flag(pkg):
    prev = signal.getsignal(signal.SIGTERM)
    try:
        pkg.clear_preemption()
        assert pkg.install_sigterm_handler()
        assert not pkg.preemption_requested()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not pkg.preemption_requested():
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        signal.signal(signal.SIGTERM, prev)
        pkg.clear_preemption()


def test_train_step_reexports_the_preemption_api():
    from tpuflow.train import step as jstep

    names = ("REQUEUE_EXIT_CODE", "Preempted", "clear_preemption",
             "emergency_save_advised", "grace_remaining_s",
             "install_sigterm_handler", "preemption_requested",
             "request_preemption")
    for name in names:
        assert hasattr(jstep, name)
        assert getattr(tstep, name) is getattr(tp, name)
    assert tp.REQUEUE_EXIT_CODE == jp.REQUEUE_EXIT_CODE == 75
