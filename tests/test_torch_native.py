"""The port's native host DP (``ops/native.py`` over its own copy of
``lvsr_native.cpp``) against the JAX package's native module and the
numpy rows, as ``tests/test_native.py`` holds the JAX package's (CPU):
equal integers on random cases; ``error_rate.batch_reward_and_gain``
takes the library where every groundtruth column holds EOS and the rows
elsewhere; without a compiler the library is missing and the rows give
the same answers."""
import numpy as np
import pytest
from numpy.testing import assert_equal

from attention_lvcsr_tpu.ops import error_rate as jax_error_rate
from attention_lvcsr_tpu.ops import native as jax_native
from attention_lvcsr_torch.ops import error_rate, native


@pytest.fixture
def library():
    """Skip where the library cannot be built (no compiler)."""
    if not native.available():
        pytest.skip(f"native library unavailable: "
                    f"{native.build_info['error']}")


def _case(rng, A=6, eos=5):
    T_g, T_r, B = rng.randint(2, 9), rng.randint(2, 9), rng.randint(1, 4)
    gt = rng.randint(0, A - 1, size=(T_g, B)).astype(np.int64)
    gt[rng.randint(0, T_g, size=B), np.arange(B)] = eos
    rec = rng.randint(0, A, size=(T_r, B)).astype(np.int64)
    return gt, rec


@pytest.mark.parametrize("seed", range(4))
def test_reward_gain_matches_jax_and_the_rows(seed, library):
    rng = np.random.RandomState(seed)
    A, eos = 6, 5
    for _ in range(10):
        gt, rec = _case(rng, A, eos)
        ours = native.batch_reward_and_gain_native(gt, rec, A, eos)
        rows = error_rate.batch_reward_and_gain_rows(gt, rec, A, eos)
        for a, b in zip(ours, rows):
            assert_equal(a, b)
        if jax_native.available():
            for a, b in zip(ours, jax_native.batch_reward_and_gain_native(
                    gt, rec, A, eos)):
                assert_equal(a, b)


def test_edit_distances_match_jax(library):
    rng = np.random.RandomState(1)
    a_seqs = [list(rng.randint(0, 4, rng.randint(0, 10))) for _ in range(20)]
    b_seqs = [list(rng.randint(0, 4, rng.randint(0, 10))) for _ in range(20)]
    out = native.edit_distances_native(a_seqs, b_seqs)
    assert [int(d) for d in out] == [
        jax_error_rate.edit_distance(a, b) for a, b in zip(a_seqs, b_seqs)]
    if jax_native.available():
        assert_equal(out, jax_native.edit_distances_native(a_seqs, b_seqs))


def test_batch_reward_and_gain_takes_the_library_where_jax_does(
        library, monkeypatch):
    rng = np.random.RandomState(7)
    A, eos = 7, 6
    gt, rec = _case(rng, A, eos)
    calls = []
    real = native.batch_reward_and_gain_native
    monkeypatch.setattr(native, "batch_reward_and_gain_native",
                        lambda *a: calls.append(1) or real(*a))
    ours = error_rate.batch_reward_and_gain(gt, rec, A, eos, min_reward=-2)
    assert calls == [1]
    for a, b in zip(ours, jax_error_rate.batch_reward_and_gain(
            gt, rec, A, eos, min_reward=-2)):
        assert_equal(a, b)
    # a groundtruth column without EOS: the rows, which refuse it, as in
    # the JAX package
    gt[:, 0] = 0
    for module in (error_rate, jax_error_rate):
        with pytest.raises(ValueError, match="must be EOS"):
            module.batch_reward_and_gain(gt, rec, A, eos)
    assert calls == [1]


@pytest.fixture
def no_compiler(monkeypatch):
    """The module as on a machine without a C++ compiler."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_info", dict(native.build_info))
    monkeypatch.setattr(native, "_compiler", lambda: None)


def test_without_a_compiler_the_rows_answer(no_compiler):
    assert not native.available()
    assert "no C++ compiler" in native.build_info["error"]
    assert native.batch_reward_and_gain_native(
        np.array([[1], [5]]), np.array([[1]]), 6, 5) is None
    assert native.edit_distances_native([[1]], [[2]]) is None
    rng = np.random.RandomState(3)
    gt, rec = _case(rng)
    for a, b in zip(error_rate.batch_reward_and_gain(gt, rec, 6, 5),
                    jax_error_rate.batch_reward_and_gain(gt, rec, 6, 5)):
        assert_equal(a, b)


def test_a_failed_build_is_reported(no_compiler, monkeypatch, tmp_path):
    script = tmp_path / "cxx"
    script.write_text("#!/bin/sh\necho broken compiler >&2\nexit 3\n")
    script.chmod(0o755)
    monkeypatch.setattr(native, "_compiler", lambda: str(script))
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    assert not native.available()
    assert "rc=3" in native.build_info["error"]
    assert "broken compiler" in native.build_info["error"]
