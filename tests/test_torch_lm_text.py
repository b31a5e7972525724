"""Port parity for the byte-level ``lm_text`` corpus
(``tpuflow_torch/data/datasets.py``, ``data/lm.py``) against the JAX
package: the loaders are bit-equal on a file and on the synthetic
stand-in, the errors are the same, and the provenance record
(``text_source_record``, ``check_text_source``) agrees. The JAX side reads
its data directory from ``TPUFLOW_DATA_DIR`` (a test's empty temporary
directory); the port looks in no directory unless given one."""

import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow.data import lm as jlm
from tpuflow.data.datasets import load_dataset as j_load_dataset
from tpuflow_torch.data import datasets as tds
from tpuflow_torch.data import lm as tlm


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    d = tmp_path / "data"
    d.mkdir()
    monkeypatch.setenv("TPUFLOW_DATA_DIR", str(d))
    monkeypatch.delenv("TPUFLOW_TEXT_FILE", raising=False)
    return d


def _text(path, n_bytes: int, seed: int = 0):
    """A file of ``n_bytes`` seeded printable bytes and newlines."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(32, 127, n_bytes).astype(np.uint8)
    raw[rng.integers(0, n_bytes, n_bytes // 40)] = 10
    path.write_bytes(raw.tobytes())
    return str(path)


def _assert_loaders_equal(j, t, epochs=2):
    for (jl, tl) in zip(j, t):
        for epoch in range(epochs):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            jb, tb = list(jl), list(tl)
            assert len(jb) == len(tb) > 0
            for a, b in zip(jb, tb):
                assert a.keys() == b.keys()
                for key in a:
                    np.testing.assert_array_equal(a[key], b[key])
                    assert a[key].dtype == b[key].dtype


@pytest.mark.parametrize("n_bytes,seq_len", [(5000, 31), (40_000, 64),
                                             (4 * 65, 64)])
def test_loaders_bit_equal_on_a_file(tmp_path, data_dir, n_bytes, seq_len):
    """Windows of seq_len + 1 bytes, the 95/5 split (its n_train
    corrections at 4 windows), the shuffled train loader over two epochs
    and the padded, masked validation tail: bit for bit."""
    path = _text(tmp_path / "corpus.txt", n_bytes)
    args = (2, 3, seq_len, 300)
    _assert_loaders_equal(
        jlm.make_lm_loaders(*args, dataset="lm_text", text_path=path),
        tlm.make_lm_loaders(*args, dataset="lm_text", text_path=path))
    j = j_load_dataset("lm_text", seq_len=seq_len, text_path=path)
    t = tds.load_dataset("lm_text", seq_len=seq_len, text_path=path)
    assert (t.num_classes, t.synthetic) == (j.num_classes, j.synthetic) == \
        (256, False)
    for split in ("train", "test"):
        np.testing.assert_array_equal(getattr(t, split).images,
                                      getattr(j, split).images)
        np.testing.assert_array_equal(getattr(t, split).labels,
                                      getattr(j, split).labels)


def test_stand_in_bit_equal(data_dir):
    """No file anywhere: the 95-symbol lm_synth pattern shifted by 32,
    marked synthetic, on both sides."""
    args = (4, 3, 16, 256)
    _assert_loaders_equal(jlm.make_lm_loaders(*args, dataset="lm_text"),
                          tlm.make_lm_loaders(*args, dataset="lm_text"))
    t = tds.load_dataset("lm_text", seq_len=16)
    assert t.synthetic and t.num_classes == 256
    assert 32 <= t.train.images.min() and t.train.images.max() < 127


def test_data_dir_resolution(tmp_path, data_dir):
    """The first *.txt of the data directory, as the JAX package resolves
    it from TPUFLOW_DATA_DIR; an explicit text_path wins."""
    _text(data_dir / "b.txt", 3000, seed=1)
    a = _text(data_dir / "a.txt", 3000, seed=2)
    other = _text(tmp_path / "other.txt", 3000, seed=3)
    assert tds.resolve_text_path(str(data_dir)) == a
    assert tds.resolve_text_path(str(data_dir), other) == other
    assert tds.resolve_text_path(None) is None
    args = (2, 2, 32, 256)
    _assert_loaders_equal(
        jlm.make_lm_loaders(*args, dataset="lm_text"),
        tlm.make_lm_loaders(*args, dataset="lm_text",
                            data_dir=str(data_dir)))


def test_errors_match_jax(tmp_path, data_dir):
    """A requested file that is missing, a file under four windows, a
    corpus under one batch and a vocab under 256 raise on both sides."""
    missing = str(tmp_path / "nope.txt")
    for make in (jlm.make_lm_loaders, tlm.make_lm_loaders):
        with pytest.raises(FileNotFoundError, match="does not exist"):
            make(2, 2, 16, 300, dataset="lm_text", text_path=missing)
    short = _text(tmp_path / "short.txt", 4 * 17 - 1)
    for make in (jlm.make_lm_loaders, tlm.make_lm_loaders):
        with pytest.raises(ValueError, match="need at least 68 bytes"):
            make(2, 2, 16, 300, dataset="lm_text", text_path=short)
    small = _text(tmp_path / "small.txt", 6 * 17)
    for make in (jlm.make_lm_loaders, tlm.make_lm_loaders):
        with pytest.raises(ValueError, match="fewer than one batch"):
            make(8, 2, 16, 300, dataset="lm_text", text_path=small)
        with pytest.raises(ValueError, match="byte-level"):
            make(2, 2, 16, 255, dataset="lm_text", text_path=small)
        with pytest.raises(ValueError, match="unknown dataset"):
            make(2, 2, 16, 300, dataset="lm_other")


def test_text_source_record_and_check(tmp_path, data_dir):
    """The record (path, sha256, bytes) equals the JAX one; the check
    passes on the same bytes and raises on both sides once they change; a
    stand-in record raises once a file resolves."""
    path = _text(tmp_path / "corpus.txt", 5000)
    rec = tlm.text_source_record(path)
    assert rec == jlm.text_source_record(text_path=path)
    assert rec["bytes"] == 5000 and len(rec["sha256"]) == 64
    tlm.check_text_source(rec)
    jlm.check_text_source(rec)
    _text(tmp_path / "corpus.txt", 5000, seed=9)
    for check in (tlm.check_text_source, jlm.check_text_source):
        with pytest.raises(ValueError, match="corpus changed"):
            check(rec)
    stand_in = tlm.text_source_record()
    assert stand_in == jlm.text_source_record() == \
        {"path": None, "sha256": None, "bytes": 0}
    tlm.check_text_source(stand_in)
    _text(data_dir / "found.txt", 3000)
    with pytest.raises(ValueError, match="stand-in"):
        tlm.check_text_source(stand_in, data_dir=str(data_dir))
    with pytest.raises(ValueError, match="stand-in"):
        jlm.check_text_source(stand_in)


def test_eval_loader_is_the_training_val_loader(tmp_path, data_dir):
    """lm_test_loader of a recorded text file holds the training run's
    validation batches."""
    path = _text(tmp_path / "corpus.txt", 9000)
    _, val = tlm.make_lm_loaders(4, 2, 32, 256, dataset="lm_text",
                                 text_path=path)
    test = tlm.lm_test_loader(4, 0, 32, 256, dataset="lm_text",
                              text_path=path)
    for a, b in zip(list(val), list(test)):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
