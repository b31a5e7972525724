"""The port's flow layer (``tpuflow_torch/flow``): the twin of
``tests/test_flow.py`` — DAG execution, parameters, artifacts, retry with
backoff, the client and pathspecs, cards, trigger events, the namespace —
plus what the port adds: the PNG encoder, the device check, and runs that
cross between the two packages' stores."""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow_torch.ckpt import Checkpoint
from tpuflow_torch.flow import (
    FlowSpec,
    Image,
    Markdown,
    Parameter,
    Run,
    Table,
    Task,
    card,
    current,
    device_profile,
    retry,
    schedule,
    step,
    trigger_on_finish,
)
from tpuflow_torch.flow import runner as runner_mod
from tpuflow_torch.flow import store
from tpuflow_torch.flow.runner import FlowRunner


@pytest.fixture(autouse=True)
def isolated_home(tmp_path):
    home = store.set_home(str(tmp_path / "home"))
    yield home
    store.set_home(None)


@schedule(cron="*/5 * * * *")
class LinearFlow(FlowSpec):
    x = Parameter("x", default=3, help="value")

    @step
    def start(self):
        self.doubled = self.x * 2
        self.arr = np.arange(4, dtype=np.float32)
        self.next(self.middle)

    @retry(times=2)
    @card()
    @step
    def middle(self):
        cls = type(self)
        if not getattr(cls, "_failed", False):
            cls._failed = True
            raise RuntimeError("transient failure")
        current.card.append(Markdown("# hello"))
        current.card.append(Table([[1, 2]], headers=["a", "b"]))
        self.tripled = self.doubled + self.x
        self.next(self.end)

    @step
    def end(self):
        self.final = self.tripled


class NoNextFlow(FlowSpec):
    @step
    def start(self):
        pass  # forgets self.next

    @step
    def end(self):
        pass


@trigger_on_finish(flow="LinearFlow")
class DownstreamFlow(FlowSpec):
    @step
    def start(self):
        if current.trigger is not None:
            self.upstream = current.trigger.run.pathspec
            self.upstream_final = current.trigger.run.data.final
        else:
            self.upstream = None
        self.next(self.end)

    @step
    def end(self):
        pass


@pytest.fixture
def no_sleep(monkeypatch):
    """Pin the retry jitter and record the backoff sleeps."""
    sleeps = []
    monkeypatch.setattr(runner_mod, "_sleep", sleeps.append)
    monkeypatch.setattr(runner_mod, "_random", lambda: 1.0)
    return sleeps


def test_linear_flow_with_retry_artifacts_and_card(isolated_home, no_sleep):
    LinearFlow._failed = False
    pathspec = FlowRunner(LinearFlow).run({"x": 5})
    run = Run(pathspec)
    assert run.successful
    assert run.data.doubled == 10 and run.data.final == 15
    np.testing.assert_array_equal(run.data.arr,
                                  np.arange(4, dtype=np.float32))
    assert run.meta["schedule"] == "*/5 * * * *"
    # One retry after backoff_s * 2**0 at the pinned jitter (0.5 + 0.5).
    assert no_sleep == [2.0]
    flow, run_id = pathspec.split("/")
    middle_task = run.meta["steps"][1]["head_task"]
    tdir = store.task_dir(flow, run_id, "middle", middle_task)
    html = open(os.path.join(tdir, "card.html")).read()
    assert "<h1>hello</h1>" in html and "<table" in html
    # The commit marker follows every artifacts.json.
    assert os.path.exists(os.path.join(tdir, "artifacts.ok"))


def test_backoff_grows_exponentially_with_jitter(monkeypatch):
    monkeypatch.setattr(runner_mod, "_random", lambda: 0.0)
    assert [runner_mod._backoff_delay(a, 2.0, 60.0) for a in (1, 2, 3, 7)] \
        == [1.0, 2.0, 4.0, 30.0]
    monkeypatch.setattr(runner_mod, "_random", lambda: 1.0)
    assert runner_mod._backoff_delay(3, 2.0, 60.0) == 8.0


def test_step_without_next_fails(isolated_home):
    with pytest.raises(Exception, match="did not call self.next"):
        FlowRunner(NoNextFlow).run({})


def test_retry_exhaustion_marks_run_failed(isolated_home, no_sleep):
    class AlwaysFails(FlowSpec):
        @retry(times=1)
        @step
        def start(self):
            raise RuntimeError("boom")

        @step
        def end(self):
            pass

    with pytest.raises(RuntimeError):
        FlowRunner(AlwaysFails).run({})
    meta = store.read_run_meta("AlwaysFails", 1)
    assert meta["status"] == "failed" and "boom" in meta["error"]
    assert len(no_sleep) == 1


def test_task_client_and_pathspecs(isolated_home):
    LinearFlow._failed = True  # no transient failure this time
    pathspec = FlowRunner(LinearFlow).run({"x": 1})
    run = Run(pathspec)
    end_task = run["end"]
    assert end_task.data.final == 3
    assert Task(end_task.pathspec).data.final == 3
    with pytest.raises(KeyError):
        Run("LinearFlow/9999")
    with pytest.raises(KeyError):
        Task("LinearFlow/9999/start/0")
    with pytest.raises(ValueError):
        Run("LinearFlow")


def test_trigger_event_handoff(isolated_home):
    LinearFlow._failed = True
    up = FlowRunner(LinearFlow).run({"x": 2})
    events = store.read_events("LinearFlow")
    assert events[-1]["run"] == up and events[-1]["status"] == "success"
    assert [e["run"] for e in Run(up).events()] == [up]

    down = FlowRunner(DownstreamFlow).run({}, triggered=True)
    drun = Run(down)
    assert drun.data.upstream == up
    assert drun.data.upstream_final == 6
    assert drun.meta["triggered_by"] == up
    # An untriggered run sees no trigger context.
    assert Run(FlowRunner(DownstreamFlow).run({})).data.upstream is None


def test_checkpoint_artifact_is_reference_not_pickle(isolated_home, tmp_path):
    ckdir = tmp_path / "ck"
    ckdir.mkdir()

    class CkFlow(FlowSpec):
        @step
        def start(self):
            self.ckpt = Checkpoint.from_directory(str(ckdir), {"step": 3})
            self.next(self.end)

        @step
        def end(self):
            pass

    pathspec = FlowRunner(CkFlow).run({})
    flow, run_id = pathspec.split("/")
    raw = json.load(open(os.path.join(
        store.task_dir(flow, run_id, "start", 0), "artifacts.json")))
    assert raw["ckpt"] == {"__type__": "checkpoint", "path": str(ckdir),
                           "metadata": {"step": 3}}
    restored = Run(pathspec).data.ckpt
    assert isinstance(restored, Checkpoint) and restored.metadata["step"] == 3


def test_tensor_artifact_rejected(isolated_home):
    class BadFlow(FlowSpec):
        @step
        def start(self):
            self.weights = {"w": [torch.ones(4, 4)]}
            self.next(self.end)

        @step
        def end(self):
            pass

    with pytest.raises(TypeError, match="torch.Tensor.*Checkpoint"):
        FlowRunner(BadFlow).run({})
    # Host numpy arrays remain fine (stored as .npy blobs).
    store.reject_device_arrays("ok", {"w": np.ones(3)})


def test_gpt_eval_of_an_lm_text_run_raises_not_ported(isolated_home):
    """A GPT run on the byte-level corpus stops the eval flow with the
    "not ported" error before its checkpoint is read."""
    from tpuflow_torch.flows import gpt_eval_flow

    class LmTextRun(FlowSpec):
        @step
        def start(self):
            self.result_checkpoint = None
            self.model_config = {}
            self.dataset_used = "lm_text"
            self.seq_len_used = 32
            self.synthetic_size_used = 8
            self.next(self.end)

        @step
        def end(self):
            pass

    pathspec = FlowRunner(LmTextRun).run({})
    with pytest.raises(NotImplementedError, match="lm_text.*item 12"):
        gpt_eval_flow.main(["run", "--checkpoint-run-pathspec", pathspec,
                            "--device", "cpu", "--home", isolated_home])


def test_gpt_eval_beam_sample_equals_jax_beam_search(isolated_home):
    """``TorchGptEval --beam-size 2`` on a ``TorchGptTrain`` run: its card
    holds the beam sample, whose tokens equal the JAX ``beam_search`` over
    the same checkpoint's weights and whose score agrees within the
    card's three decimals."""
    import re

    import jax
    import jax.numpy as jnp

    from tpuflow.infer.beam import beam_search as jbeam
    from tpuflow.models.gpt2 import GPT2 as JGPT2
    from tpuflow.models.gpt2 import GPT2Config as JConfig
    from tpuflow_torch.ckpt import restore_from_handle
    from tpuflow_torch.flows import gpt_eval_flow, gpt_flow

    port = ["--device", "cpu", "--home", isolated_home]
    train = gpt_flow.main([
        "run", "--preset", "test", "--epochs", "1", "--steps-per-epoch",
        "2", "--seq-len", "32", "--data-axis", "1", "--fsdp-axis", "1",
        *port])
    pathspec = gpt_eval_flow.main([
        "run", "--checkpoint-run-pathspec", train, "--sample-tokens", "8",
        "--beam-size", "2", *port])
    run = Run(pathspec)
    name, text = run.data.samples[-1]
    m = re.fullmatch(r"beam K=2 \((-?[0-9.]+) nats/tok\)", name)
    assert m, name
    tr = Run(train).data
    params = jax.tree_util.tree_map(
        lambda t: t.numpy(),
        restore_from_handle(tr.result_checkpoint, weights_only=True))
    jm = JGPT2(JConfig(dropout=0.0, **tr.model_config))
    toks, score = jbeam(jm, params, jnp.zeros((1, 4), jnp.int32),
                        beam_size=2, max_new_tokens=8)
    assert text == " ".join(str(int(t)) for t in np.asarray(toks)[0])
    assert abs(float(m.group(1)) - float(score[0])) <= 5e-4 + 1e-5
    card = open(os.path.join(isolated_home, "flows", pathspec, "start", "0",
                             "card.html")).read()
    assert name in card


def test_deploy_raises_and_params_cli(isolated_home, capsys):
    from tpuflow_torch.flow.runner import main

    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8b"):
        main(LinearFlow, ["deploy"])
    main(LinearFlow, ["show"])
    out = capsys.readouterr().out
    assert "--x" in out and "middle [retry×2, card]" in out
    with pytest.raises(SystemExit):
        main(LinearFlow, ["run", "--nope", "1"])
    with pytest.raises(SystemExit):
        main(LinearFlow, ["run", "--x"])


def test_home_option_roots_the_store(tmp_path):
    from tpuflow_torch.flow.runner import main

    LinearFlow._failed = True
    other = tmp_path / "other"
    pathspec = main(LinearFlow, ["run", "--x", "4", "--home", str(other)])
    assert store.home() == str(other)
    assert os.path.exists(os.path.join(str(other), "flows", "LinearFlow",
                                       "1", "run.json"))
    assert Run(pathspec).data.final == 12


def test_cuda_asked_without_a_card_raises(isolated_home, monkeypatch):
    """No fallback: a flow whose device is cuda raises on a machine
    without a card, before any run exists."""
    class DeviceFlow(FlowSpec):
        device = Parameter("device", default="cuda")

        @step
        def start(self):
            self.next(self.end)

        @step
        def end(self):
            pass

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        FlowRunner(DeviceFlow).run({"device": "cuda"})
    assert not os.path.exists(store.flow_dir("DeviceFlow"))
    assert Run(FlowRunner(DeviceFlow).run({"device": "cpu"})).successful


def test_metrics_table_formats_consistently():
    from tpuflow_torch.flow import metrics_table

    html = metrics_table(
        [{"epoch": 0, "loss": 1.23456, "tokens_per_s": 8123.456}])._render()
    assert "1.2346" in html and "8123.5" in html and "epoch" in html
    assert "<td>0</td>" in html
    assert metrics_table([])._render()


def _png_pixels(png: bytes) -> np.ndarray:
    """Decode the port's PNG (8-bit gray or RGB, filter 0, one IDAT)."""
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(png):
        n = struct.unpack(">I", png[pos:pos + 4])[0]
        tag, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", png[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + data) & 0xFFFFFFFF
        chunks[tag] = data
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert depth == 8 and color in (0, 2)
    ch = 1 if color == 0 else 3
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + w * ch)
    assert (rows[:, 0] == 0).all()  # filter type 0 on every row
    return rows[:, 1:].reshape((h, w) if ch == 1 else (h, w, ch))


def test_png_encoder_round_trips():
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (28, 28), dtype=np.uint8)
    np.testing.assert_array_equal(_png_pixels(Image.from_array(gray)
                                              .png_bytes), gray)
    rgb = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(_png_pixels(Image.from_array(rgb)
                                              .png_bytes), rgb)
    # Floats scale min..max to 0..255; scale repeats pixels.
    img = _png_pixels(Image.from_array(np.array([[-1.0, 1.0]]), scale=2)
                      .png_bytes)
    np.testing.assert_array_equal(img, [[0, 0, 255, 255], [0, 0, 255, 255]])
    assert 'src="data:image/png;base64,' in Image.from_array(gray)._render()


def test_charts_render_svg():
    from tpuflow_torch.flow import BarChart, CardBuffer, training_curve_card

    bars = BarChart([-1.0, 2.5, 0.0], ["a", "b", "c"])._render()
    assert bars.startswith("<svg") and bars.count("<rect") == 3
    buf = CardBuffer()
    training_curve_card(buf, [
        {"epoch": 0, "train_loss": 6.0, "val_loss": 5.9, "ppl": 365.0},
        {"epoch": 1, "train_loss": 5.0, "val_loss": 5.1, "ppl": 164.0},
    ])
    html = buf.render_html("t")
    assert "Training curves" in html and "<polyline" in html
    assert html.count("<polyline") == 2 and "164.00" in html


def test_namespace_scopes_client_resolution(isolated_home):
    from tpuflow_torch.flow import (
        Flow,
        default_namespace,
        get_namespace,
        namespace,
    )
    import tpuflow_torch.flow.client as client

    LinearFlow._failed = True
    try:
        namespace("user:alice")
        pathspec = FlowRunner(LinearFlow).run({"x": 1})
        assert Run(pathspec).meta["namespace"] == "user:alice"
        task_spec = f"{pathspec}/start/0"
        assert Task(task_spec).data.doubled == 2

        namespace("user:bob")
        with pytest.raises(KeyError, match="user:alice"):
            Run(pathspec)
        with pytest.raises(KeyError, match="user:alice"):
            Task(task_spec)
        bob_spec = FlowRunner(LinearFlow).run({"x": 2})

        namespace(None)
        assert Run(pathspec).data.doubled == 2
        assert get_namespace() is None

        namespace("user:alice")
        assert [r.pathspec for r in Flow("LinearFlow").runs()] == [pathspec]
        assert Flow("LinearFlow").latest_successful_run.pathspec == pathspec
        namespace("user:bob")
        assert Flow("LinearFlow").latest_successful_run.pathspec == bob_spec
        namespace(None)
        assert len(Flow("LinearFlow").runs()) == 2
        namespace("user:nobody")
        with pytest.raises(KeyError, match="no successful runs"):
            Flow("LinearFlow").latest_successful_run
    finally:
        client._NAMESPACE = client._UNSET
    assert get_namespace() == default_namespace()


class ProfiledFlow(FlowSpec):
    device = Parameter("device", default="cpu")

    @step
    def start(self):
        self.next(self.work)

    @device_profile(interval=0.05, trace=True)
    @step
    def work(self):
        import time as _time

        x = torch.ones(128, 128)
        deadline = _time.monotonic() + 0.3
        while _time.monotonic() < deadline:
            x = torch.tanh(x @ x)
        self.done = True
        self.next(self.end)

    @step
    def end(self):
        pass


def test_device_profiler_and_trace_capture(isolated_home):
    """profile.json with its samples, platform and cards, and the
    torch.profiler chrome trace of the step."""
    pathspec = FlowRunner(ProfiledFlow).run({"device": "cpu"})
    flow, run_id = pathspec.split("/")
    tdir = store.task_dir(flow, run_id, "work", 1)
    prof = json.load(open(os.path.join(tdir, "profile.json")))
    assert prof["platform"] == "cpu" and prof["device_kinds"] == []
    assert len(prof["samples"]) >= 2
    assert all(s["devices"] == [] for s in prof["samples"])
    trace = json.load(open(os.path.join(tdir, "trace", "trace.json")))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


# ---------------------------------------------- the two packages' stores
def test_runs_cross_between_the_two_stores(isolated_home, monkeypatch,
                                           tmp_path):
    """The same layout: a run written by either package reads through the
    other's client, its Checkpoint and Result artifacts decoded as each
    package's own classes."""
    from tpuflow.ckpt import Checkpoint as JCheckpoint
    from tpuflow.flow import FlowSpec as JFlowSpec
    from tpuflow.flow import Run as JRun
    from tpuflow.flow import step as jstep
    from tpuflow.flow.runner import FlowRunner as JFlowRunner
    from tpuflow.train.trainer import Result as JResult
    from tpuflow_torch.train.trainer import Result

    monkeypatch.setenv("TPUFLOW_HOME", isolated_home)
    ckdir = tmp_path / "ck"
    ckdir.mkdir()

    class PortFlow(FlowSpec):
        @step
        def start(self):
            self.result = Result(
                metrics={"val_loss": 0.5}, metrics_history=[{"a": 1}],
                checkpoint=Checkpoint(str(ckdir), {"step": 2}),
                best_checkpoint=None, path=str(ckdir))
            self.note = "port"
            self.next(self.end)

        @step
        def end(self):
            pass

    class JaxFlow(JFlowSpec):
        @jstep
        def start(self):
            self.ckpt = JCheckpoint(str(ckdir), {"step": 7})
            self.next(self.end)

        @jstep
        def end(self):
            pass

    port_spec = FlowRunner(PortFlow).run({})
    jres = JRun(port_spec).data.result
    assert isinstance(jres, JResult) and jres.metrics == {"val_loss": 0.5}
    assert jres.checkpoint.path == str(ckdir)
    assert jres.checkpoint.metadata == {"step": 2}
    assert JRun(port_spec).data.note == "port"

    jax_spec = JFlowRunner(JaxFlow).run({})
    ck = Run(jax_spec).data.ckpt
    assert isinstance(ck, Checkpoint) and ck.metadata == {"step": 7}
    assert Run(jax_spec).successful
