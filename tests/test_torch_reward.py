"""The task loss's targets: the port's numpy edit-distance, reward and gain
matrices against the JAX package's and against the reference's golden
values, and the port's device DP (``ops/reward_op.py``, plain PyTorch on
the CPU here) against the numpy batch DP and the JAX package's
``reward_and_gain_device``, integer for integer."""
import numpy as np
import pytest
import torch
from numpy.testing import assert_equal

from attention_lvcsr_tpu.ops import error_rate as jax_er
from attention_lvcsr_tpu.ops.reward_op import reward_and_gain_device
from attention_lvcsr_torch.ops import error_rate as er
from attention_lvcsr_torch.ops.reward_op import reward_and_gain

GOLDEN_GT = [[0, 0, 0], [1, 2, 1], [2, 1, 4], [4, 3, 0], [0, 4, 0]]
GOLDEN_REC = [[0, 0, 0], [2, 1, 1], [1, 2, 4], [3, 4, 0], [4, 0, 0]]


def test_golden_values():
    """The reference's values (``tests/test_error_rate.py``)."""
    dist, action = er.edit_distance_matrix("abdce", "abcd")
    assert_equal(dist[-1], [5, 4, 3, 2, 2])
    assert_equal(action[3], [0, 0, 0, 3, 0])
    assert_equal(er.reward_matrix("abc$", "acb$", "abc$", eos_label=3),
                 [[0, -1, -1, -3], [-1, 0, -1, -2], [-2, -1, -1, -1],
                  [-2, -2, -1, -2], [-3, -3, -2, -2]])
    assert_equal(er.gain_matrix("abc$", "abc$", alphabet="abc$",
                                eos_label=3)[2], [-1, -1, 0, -1])
    rewards, gains = er.batch_reward_and_gain(GOLDEN_GT, GOLDEN_REC, 7, 4)
    assert_equal(rewards[2, 2], [-1, -1, -1, -1, 0, -1, -1])
    assert_equal(gains[3, 2], [-1000] * 7)
    assert_equal(gains[4, 0], [-1, -1, 0, -1, 0, -1, -1])
    assert er.edit_distance("kitten", "sitting") == 3
    np.testing.assert_allclose(er.wer("abc", "adc"), 1 / 3)


@pytest.mark.parametrize("seed", range(6))
def test_numpy_functions_match_jax(seed):
    rng = np.random.RandomState(seed)
    A = rng.randint(3, 8)
    eos = A - 1
    for _ in range(5):
        y = list(rng.randint(0, A - 1, size=rng.randint(0, 9))) + [eos]
        y_hat = list(rng.randint(0, A, size=rng.randint(0, 10)))
        for a, b in zip(er.edit_distance_matrix(y, y_hat),
                        jax_er.edit_distance_matrix(y, y_hat)):
            assert_equal(a, b)
        assert er.edit_distance(y, y_hat) == jax_er.edit_distance(y, y_hat)
        alphabet = list(range(A))
        assert_equal(er.reward_matrix(y, y_hat, alphabet, eos),
                     jax_er.reward_matrix(y, y_hat, alphabet, eos))
        assert_equal(er.gain_matrix(y, y_hat, alphabet, eos_label=eos),
                     jax_er.gain_matrix(y, y_hat, alphabet, eos_label=eos))
    B, T_g, T_r = rng.randint(1, 5), rng.randint(1, 9), rng.randint(1, 9)
    gt = rng.randint(0, A, size=(T_g, B))
    gt[rng.randint(0, T_g, size=B), np.arange(B)] = eos
    rec = rng.randint(0, A, size=(T_r, B))
    for a, b in zip(er.batch_reward_and_gain(gt, rec, A, eos, min_reward=-2),
                    jax_er.batch_reward_and_gain(gt, rec, A, eos,
                                                 min_reward=-2)):
        assert_equal(a, b)


def _cases():
    """(groundtruth, recognized, A, EOS) with every edge: hypotheses
    without an EOS, an EOS at step 0 on either side, T_g != T_r both ways, an EOS
    before the groundtruth's end, a batch of one."""
    rng = np.random.RandomState(7)
    out = [(np.asarray(GOLDEN_GT), np.asarray(GOLDEN_REC), 7, 4)]
    for k in range(12):
        A = rng.randint(3, 9)
        eos = A - 1
        B = 1 if k == 0 else rng.randint(2, 6)
        T_g, T_r = rng.randint(1, 10), rng.randint(1, 12)
        gt = rng.randint(0, A - 1, size=(T_g, B))
        gt[rng.randint(0, T_g, size=B), np.arange(B)] = eos
        rec = rng.randint(0, A - 1, size=(T_r, B))     # no EOS anywhere
        if k % 3 == 1:
            rec[0, 0] = eos                             # EOS at step 0
            gt[0, -1] = eos
        elif k % 3 == 2:
            rec[rng.randint(0, T_r, size=B), np.arange(B)] = eos
        out.append((gt, rec, A, eos))
    return out


@pytest.mark.parametrize("case", range(13))
def test_device_dp_matches_numpy_and_jax(case):
    gt, rec, A, eos = _cases()[case]
    ref_r, ref_g = er.batch_reward_and_gain(gt, rec, A, eos)
    rewards, gains = reward_and_gain(torch.as_tensor(gt),
                                     torch.as_tensor(rec), A,
                                     None if eos == A - 1 else eos)
    assert rewards.dtype == gains.dtype == torch.int32
    assert rewards.shape == (rec.shape[0], rec.shape[1], A)
    assert_equal(rewards.numpy(), ref_r)
    assert_equal(gains.numpy(), ref_g)
    jr, jg = reward_and_gain_device(gt, rec, A, eos)
    assert_equal(rewards.numpy(), np.asarray(jr))
    assert_equal(gains.numpy(), np.asarray(jg))


def test_device_dp_groundtruth_without_eos_matches_jax():
    """A groundtruth column without EOS (the numpy DP refuses it) is taken
    whole, as the JAX device DP takes it."""
    rng = np.random.RandomState(3)
    gt = rng.randint(0, 4, size=(6, 3))
    rec = rng.randint(0, 5, size=(8, 3))
    rewards, gains = reward_and_gain(torch.as_tensor(gt),
                                     torch.as_tensor(rec), 5, eos_label=4)
    jr, jg = reward_and_gain_device(gt, rec, 5, 4)
    assert_equal(rewards.numpy(), np.asarray(jr))
    assert_equal(gains.numpy(), np.asarray(jg))


def test_device_dp_has_no_gradient():
    gt = torch.tensor([[1], [2], [3]])
    rec = torch.tensor([[2], [3]])
    rewards, gains = reward_and_gain(gt, rec, 4)
    assert not rewards.requires_grad and not gains.requires_grad
