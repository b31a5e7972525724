"""The training recipes through the port's GPT flows on the CPU:
``TorchGptTrain --optimizer lion --experts 2 --dataset lm_text
--text-path <file>`` at the test preset records the corpus's identity
and the MoE config, and the triggered ``TorchGptEval`` rebuilds the MoE
model, checks the corpus and scores it; an eval of a run whose corpus
changed raises. Across the packages (slow: the JAX flows compile their
steps): the port's eval of a JAX MoE/``lm_text`` run and the JAX eval of
the port's give the other's greedy byte-level sample exactly and its test
loss within 1e-5 (f32, the same products summed in another order)."""

import importlib
import os
import sys

import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow_torch.data.lm import text_source_record
from tpuflow_torch.flow import Run, store
from tpuflow_torch.flows import gpt_eval_flow, gpt_flow

FLOWS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "flows")
TRAIN = ["--preset", "test", "--epochs", "2", "--steps-per-epoch", "2",
         "--seq-len", "32", "--batch-size", "8", "--experts", "2",
         "--dataset", "lm_text", "--learning-rate", "1e-3"]


def _corpus(path, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"the", b"flow", b"trains", b"a", b"model", b"on", b"bytes"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), 1500))
    path.write_bytes(text)
    return str(path)


@pytest.fixture
def home(tmp_path):
    h = str(tmp_path / "home")
    store.set_home(h)
    yield h
    store.set_home(None)


def test_recipe_train_and_eval_flows(tmp_path, home):
    text = _corpus(tmp_path / "corpus.txt")
    train = Run(gpt_flow.main([
        "run", *TRAIN, "--optimizer", "lion", "--text-path", text,
        "--data-axis", "1", "--fsdp-axis", "1", "--sample-tokens", "6",
        "--device", "cpu", "--home", home]))
    assert train.successful
    assert train.data.model_config["n_experts"] == 2
    assert train.data.text_source == text_source_record(text)
    assert train.data.dataset_used == "lm_text"
    assert len(train.data.loss_history) == 2
    assert all(np.isfinite(train.data.loss_history))
    assert len(train.data.sample) == 6
    ev = Run(gpt_eval_flow.main(["run", "--triggered", "--sample-tokens",
                                 "8", "--device", "cpu", "--home", home]))
    assert ev.meta.get("triggered_by") == train.pathspec
    assert np.isfinite(ev.data.test_ppl)
    # Byte-level samples render as text, not as ids.
    name, sample = ev.data.samples[0]
    assert name == "greedy" and len(sample) == 8
    # The training run's last validation loss is the eval's test loss: the
    # same weights on the same held-out windows.
    assert ev.data.test_loss == pytest.approx(
        train.data.metrics_history[-1]["val_loss"], abs=1e-6)
    # The corpus changes: the eval refuses to score it.
    _corpus(tmp_path / "corpus.txt", seed=1)
    with pytest.raises(ValueError, match="corpus changed"):
        gpt_eval_flow.main(["run", "--checkpoint-run-pathspec",
                            train.pathspec, "--device", "cpu", "--home",
                            home])


def test_train_flow_without_a_file_uses_the_stand_in(home):
    """lm_text without --text-path trains on the synthetic stand-in and
    records no file; its eval scores the same stand-in."""
    train = Run(gpt_flow.main([
        "run", *TRAIN[:-4], "--dataset", "lm_text", "--optimizer",
        "adafactor", "--data-axis", "1", "--fsdp-axis", "1", "--device",
        "cpu", "--home", home]))
    assert train.data.text_source == {"path": None, "sha256": None,
                                      "bytes": 0}
    ev = Run(gpt_eval_flow.main(["run", "--triggered", "--sample-tokens",
                                 "4", "--device", "cpu", "--home", home]))
    assert ev.data.test_loss == pytest.approx(
        train.data.metrics_history[-1]["val_loss"], abs=1e-6)


@pytest.fixture
def jax_flows(tmp_path, monkeypatch, home):
    """Both packages rooted at one home, the JAX flows importable."""
    monkeypatch.setenv("TPUFLOW_HOME", home)
    monkeypatch.setenv("TPUFLOW_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("TPUFLOW_N_PARALLEL", "1")
    monkeypatch.syspath_prepend(FLOWS)
    for name in ("gpt_flow", "gpt_eval_flow"):
        sys.modules.pop(name, None)
    yield home
    for name in ("gpt_flow", "gpt_eval_flow"):
        sys.modules.pop(name, None)


@pytest.mark.slow
def test_moe_lm_text_runs_cross_the_packages(tmp_path, monkeypatch,
                                             jax_flows):
    jtrain = importlib.import_module("gpt_flow")
    jeval = importlib.import_module("gpt_eval_flow")
    from tpuflow.flow import Run as JRun

    text = _corpus(tmp_path / "corpus.txt")
    monkeypatch.setenv("TPUFLOW_TEXT_FILE", text)
    port = ["--device", "cpu", "--home", jax_flows]
    jrun = jtrain.TpuGptTrain.main(["run", *TRAIN, "--data-axis", "8",
                                    "--fsdp-axis", "1"])
    trun = gpt_flow.main(["run", *TRAIN, "--text-path", text,
                          "--data-axis", "1", "--fsdp-axis", "1", *port])
    for run in (jrun, trun):
        want = JRun(jeval.TpuGptEval.main([
            "run", "--checkpoint-run-pathspec", run, "--sample-tokens",
            "8"])).data
        got = Run(gpt_eval_flow.main([
            "run", "--checkpoint-run-pathspec", run, "--sample-tokens", "8",
            *port])).data
        assert got.samples[0] == list(want.samples[0]), run
        assert got.test_loss == pytest.approx(want.test_loss, rel=0,
                                              abs=1e-5)
