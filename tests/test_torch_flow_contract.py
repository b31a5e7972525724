"""The README contract on the port's flows: the twin of
``tests/test_parity_flows.py::test_readme_contract_end_to_end`` — a fresh
``TorchTrain`` run, a ``--from-run`` warm start, a triggered ``TorchEval``
with its error card, a pathspec eval, and the "no checkpoint source"
error — through the CLIs' ``main(argv)`` on the CPU at 256 / 64 rows:
in-process (``num_parallel`` 1), and as a 2-process gloo gang (slow).
Also: the flow's ``result.metrics_history`` equals a direct
``train_model`` call's."""

import os

import numpy as np
import pytest

from tpuflow_torch.flow import Run, store
from tpuflow_torch.flows import eval_flow, my_torch_module, train_flow

ROWS = ["--n-train", "256", "--n-test", "64"]
TRAIN = ["--batch-size", "64", "--learning-rate", "0.05"]


@pytest.fixture
def home(tmp_path):
    h = store.set_home(str(tmp_path / "home"))
    yield h
    store.set_home(None)


def _contract(home: str, num_parallel: int) -> None:
    common = ["--device", "cpu", "--home", home]
    gang = ["--num-parallel", str(num_parallel)]
    # 1. A fresh run.
    pathspec = train_flow.main(["run", "--epochs", "2", *TRAIN, *ROWS,
                                *gang, *common])
    run = Run(pathspec)
    assert run.successful and not run.data.warm_started
    result = run.data.result
    assert result.checkpoint is not None
    assert result.mesh_axes == {"data": num_parallel}
    first_val = result.metrics_history[0]["val_loss"]
    assert len(result.metrics_history) == 2
    assert all(np.isfinite(h["val_loss"]) for h in result.metrics_history)

    # 2. A warm start from it: its first epoch beats the cold first epoch.
    pathspec2 = train_flow.main(["run", "--epochs", "1", *TRAIN, *ROWS,
                                 *gang, "--from-run", pathspec, *common])
    run2 = Run(pathspec2)
    assert run2.data.warm_started
    assert run2.data.result.metrics_history[0]["val_loss"] < first_val

    # 3. The triggered eval consumes the newest successful train run.
    epath = eval_flow.main(["run", "--triggered", "--batch-size", "64",
                            *common])
    erun = Run(epath)
    assert erun.successful
    assert erun.meta["triggered_by"] == pathspec2
    assert erun.data.n_rows == 64
    assert 0 <= erun.data.n_misclassified < 64
    # The count agrees with the run's own accuracy on the same 64 rows.
    acc = run2.data.result.metrics_history[0]["accuracy"]
    assert erun.data.n_misclassified == round((1 - acc) * 64)
    eflow, erid = epath.split("/")
    html = open(os.path.join(store.task_dir(eflow, erid, "start", 0),
                             "card.html")).read()
    assert "Error analysis" in html
    assert f"<b>{erun.data.n_misclassified}</b> of <b>64</b>" in html
    if erun.data.n_misclassified:
        n_rows = min(50, erun.data.n_misclassified)
        assert html.count("data:image/png") == n_rows
        assert html.count("<svg") == n_rows

    # 4. An eval from an explicit run pathspec.
    assert Run(eval_flow.main(["run", "--checkpoint-run-pathspec", pathspec,
                               "--batch-size", "64", *common])).successful

    # 5. No source at all.
    with pytest.raises(ValueError, match="no checkpoint source"):
        eval_flow.main(["run", "--batch-size", "64", *common])


def test_readme_contract_in_process(home):
    _contract(home, 1)


@pytest.mark.slow
def test_readme_contract_as_a_gloo_gang(home):
    _contract(home, 2)


def test_flow_result_equals_a_direct_train_model_call(home, tmp_path):
    pathspec = train_flow.main(["run", "--epochs", "2", *TRAIN, *ROWS,
                                "--device", "cpu"])
    got = Run(pathspec).data.result.metrics_history
    want = my_torch_module.train_model(
        device="cpu", checkpoint_storage_path=str(tmp_path / "direct"),
        global_batch_size=64, lr=0.05, epochs=2, n_train=256,
        n_test=64).metrics_history
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5,
                                       err_msg=k)
