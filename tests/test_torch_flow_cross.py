"""Cross-framework flow legs on the CPU: the port's eval flows consume the
JAX package's training runs and the JAX eval consumes the port's, under
one home. The two stores share their layout, and the two checkpoint
formats are one (``tpuflow-raw-v2``).

- A JAX ``TpuTrain`` run: ``TorchEval --checkpoint-run-pathspec`` gives the
  JAX ``TpuEval``'s ``n_rows`` and ``n_misclassified``.
- A ``TorchTrain`` run: the JAX ``TpuEval`` gives ``TorchEval``'s.
- A JAX ``TpuGptTrain`` run (preset ``test``, slow): ``TorchGptEval`` gives
  the JAX ``TpuGptEval``'s greedy sample exactly and its test loss within
  1e-5 (f32 on both sides, the same products summed in another order).
  Sampled tokens are not compared: the random streams differ.

The JAX flows read their sizes from their declared knobs; the port's
take them as parameters.
"""

import importlib
import os
import sys

import pytest

from tpuflow_torch.flow import Run, store
from tpuflow_torch.flows import eval_flow, gpt_eval_flow, train_flow

FLOWS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "flows")


@pytest.fixture
def jax_flows(tmp_path, monkeypatch):
    """Both packages rooted at one home; the JAX MLP flows sized at 256 / 64
    rows, the train step in-process."""
    home = str(tmp_path / "home")
    store.set_home(home)
    monkeypatch.setenv("TPUFLOW_HOME", home)
    monkeypatch.setenv("TPUFLOW_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("TPUFLOW_SYNTH_TRAIN_N", "256")
    monkeypatch.setenv("TPUFLOW_SYNTH_TEST_N", "64")
    monkeypatch.setenv("TPUFLOW_N_PARALLEL", "1")
    monkeypatch.syspath_prepend(FLOWS)
    names = ("train_flow", "eval_flow", "my_tpu_module", "gpt_flow",
             "gpt_eval_flow")
    for name in names:
        sys.modules.pop(name, None)
    yield home
    for name in names:
        sys.modules.pop(name, None)
    store.set_home(None)


def _port(home):
    return ["--device", "cpu", "--home", home]


def test_torch_eval_of_a_jax_train_run(jax_flows):
    jtrain = importlib.import_module("train_flow")
    jeval = importlib.import_module("eval_flow")
    from tpuflow.flow import Run as JRun

    train = jtrain.TpuTrain.main(["run", "--epochs", "1", "--batch-size",
                                  "64", "--learning-rate", "0.05"])
    want = JRun(jeval.TpuEval.main(["run", "--checkpoint-run-pathspec",
                                    train, "--batch-size", "64"])).data
    got = Run(eval_flow.main(["run", "--checkpoint-run-pathspec", train,
                              "--batch-size", "64", "--n-test", "64",
                              *_port(jax_flows)])).data
    assert (got.n_rows, got.n_misclassified) == (want.n_rows,
                                                 want.n_misclassified)
    assert got.n_rows == 64


def test_jax_eval_of_a_torch_train_run(jax_flows):
    jeval = importlib.import_module("eval_flow")
    from tpuflow.flow import Run as JRun

    train = train_flow.main(["run", "--epochs", "1", "--batch-size", "64",
                             "--learning-rate", "0.05", "--n-train", "256",
                             "--n-test", "64", *_port(jax_flows)])
    want = JRun(jeval.TpuEval.main(["run", "--checkpoint-run-pathspec",
                                    train, "--batch-size", "64"])).data
    got = Run(eval_flow.main(["run", "--checkpoint-run-pathspec", train,
                              "--batch-size", "64",
                              *_port(jax_flows)])).data
    assert (got.n_rows, got.n_misclassified) == (want.n_rows,
                                                 want.n_misclassified)
    assert got.n_rows == 64


@pytest.mark.slow
def test_torch_gpt_eval_of_a_jax_gpt_run(jax_flows):
    jtrain = importlib.import_module("gpt_flow")
    jeval = importlib.import_module("gpt_eval_flow")
    from tpuflow.flow import Run as JRun

    train = jtrain.TpuGptTrain.main([
        "run", "--preset", "test", "--epochs", "1", "--steps-per-epoch", "2",
        "--seq-len", "32", "--data-axis", "2", "--fsdp-axis", "4"])
    want = JRun(jeval.TpuGptEval.main([
        "run", "--checkpoint-run-pathspec", train, "--sample-tokens",
        "8"])).data
    got = Run(gpt_eval_flow.main([
        "run", "--checkpoint-run-pathspec", train, "--sample-tokens", "8",
        *_port(jax_flows)])).data
    assert got.samples[0] == list(want.samples[0])
    assert got.samples[0][0] == "greedy"
    assert len(got.samples[0][1].split()) == 8
    assert got.test_loss == pytest.approx(want.test_loss, rel=0, abs=1e-5)
