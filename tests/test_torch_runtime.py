"""The port's ``.npy`` batch loader (ganecdotes_torch/runtime) held against
the JAX package's: the same files and seed give the same batches in the
same order (one worker thread: with more, the threads race for the queue
in both packages), the decode rules of tests/test_runtime.py, bad files
counted, epochs advancing, the atomic build, and no silent fallback.

The tests write their own .npy files from a seed; the batches are compared
bit for bit (both packages decode the same bytes with the same
arithmetic).
"""

import os

import numpy as np
import pytest

import ganecdotes_tpu.runtime as jruntime
from ganecdotes_tpu.runtime import NativeDataLoader as JNativeDataLoader
from ganecdotes_torch import runtime
from ganecdotes_torch.runtime import NativeDataLoader


def _write_dataset(tmp_path, n=12, h=8, w=8, c=3):
    rng = np.random.RandomState(0)
    paths, arrays = [], []
    for i in range(n):
        if i % 2 == 0:
            a = (rng.rand(h, w, c) * 255).astype(np.uint8)
        else:
            a = rng.randn(h, w, c).astype(np.float32)
        p = str(tmp_path / f"img_{i:03d}.npy")
        np.save(p, a)
        paths.append(p)
        arrays.append(a)
    return paths, arrays


def _expected(a):
    if a.dtype == np.uint8:
        return a.astype(np.float32) / 127.5 - 1.0
    return a


def test_native_loader_matches_the_jax_loader_batch_for_batch(tmp_path, monkeypatch):
    # the JAX loader builds its library into tmp_path here, so that this
    # test never races tests/test_runtime.py's build of the same file
    monkeypatch.setattr(jruntime, "_BUILD_DIR", str(tmp_path / "jax_build"))
    monkeypatch.setattr(jruntime, "_SO", str(tmp_path / "jax_build" / "libgxloader.so"))
    monkeypatch.setattr(jruntime, "_lib", None)
    monkeypatch.setattr(jruntime, "_lib_err", None)
    assert jruntime.load_native() is not None, jruntime._lib_err
    paths, _ = _write_dataset(tmp_path, n=10)
    kw = dict(n_threads=1, seed=3, queue_depth=2)
    with NativeDataLoader(paths, 4, 8, 8, 3, **kw) as ours:
        theirs = JNativeDataLoader(paths, 4, 8, 8, 3, **kw)
        try:
            for _ in range(7):  # across three reshuffled epochs
                np.testing.assert_array_equal(ours.next(), theirs.next())
        finally:
            theirs.close()
    assert ours.decode_errors == theirs.decode_errors == 0
    assert ours.epoch >= 2


@pytest.mark.parametrize("n_threads", [1, 3])
def test_loader_decodes_all_samples(tmp_path, n_threads):
    paths, arrays = _write_dataset(tmp_path)
    loader = NativeDataLoader(paths, 4, 8, 8, 3, n_threads=n_threads, seed=1)
    want = {a.tobytes() for a in map(_expected, arrays)}
    seen = set()
    with loader:
        for _ in range(9):  # 3 epochs' worth
            b = loader.next()
            assert b.shape == (4, 8, 8, 3) and b.dtype == np.float32
            seen.update(np.ascontiguousarray(s).tobytes() for s in b)
    assert seen == want
    assert loader.decode_errors == 0


@pytest.mark.parametrize("n_threads", [1, 3])
def test_loader_counts_bad_files(tmp_path, n_threads):
    paths, _ = _write_dataset(tmp_path, n=4)
    bad = str(tmp_path / "bad.npy")
    with open(bad, "wb") as f:
        f.write(b"not an npy file at all")
    wrong = str(tmp_path / "wrong_shape.npy")
    np.save(wrong, np.zeros((4, 4, 3), np.float32))
    with NativeDataLoader(paths + [bad, wrong], 6, 8, 8, 3, n_threads=n_threads,
                          shuffle=False) as loader:
        b = loader.next()
        assert b.shape == (6, 8, 8, 3)
        np.testing.assert_array_equal(b[4:], 0)  # they train as zeros
        assert loader.decode_errors >= 2


def test_native_loader_epochs_advance(tmp_path):
    paths, _ = _write_dataset(tmp_path, n=4)
    loader = NativeDataLoader(paths, 4, 8, 8, 3, n_threads=2, queue_depth=2)
    for _ in range(6):
        loader.next()
    assert loader.epoch >= 2 and loader.batches_produced >= 6
    loader.close()
    # the counts stay readable after close
    assert loader.epoch >= 2 and loader.batches_produced >= 6
    with pytest.raises(StopIteration):
        loader.next()


def test_build_is_atomic_and_keyed_by_the_source(tmp_path, monkeypatch):
    """A fresh build directory: the library appears under its hash's name,
    with no temporary file left beside it."""
    monkeypatch.setattr(runtime, "BUILD_DIR", str(tmp_path / "loader"))
    monkeypatch.setattr(runtime, "_lib", None)
    lib = runtime.load_native()
    assert lib is not None
    files = os.listdir(tmp_path / "loader")
    assert files == [os.path.basename(runtime._library_path())]
    assert files[0].startswith("libgxloader_") and files[0].endswith(".so")


def test_native_loader_unavailable_raises(tmp_path, monkeypatch):
    """No quiet fallback: the build's error comes through the loader, and
    there is no other loader to give way to."""
    paths, _ = _write_dataset(tmp_path, n=4)
    monkeypatch.setattr(runtime, "BUILD_DIR", str(tmp_path / "loader"))
    monkeypatch.setattr(runtime, "CXX_FLAGS", runtime.CXX_FLAGS + ["--no-such-option"])
    monkeypatch.setattr(runtime, "_lib", None)
    with pytest.raises(RuntimeError, match="native loader"):
        NativeDataLoader(paths, 4, 8, 8, 3)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ at all
    with pytest.raises(RuntimeError, match="cannot run g\\+\\+"):
        NativeDataLoader(paths, 4, 8, 8, 3)
    assert not hasattr(runtime, "PyDataLoader") and not hasattr(runtime, "make_loader")
