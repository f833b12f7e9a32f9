"""Edit distance, word/character error rate, and the task loss's reward and
gain matrices, in numpy.

The port's own copy of ``attention_lvcsr_tpu/ops/error_rate.py``: that
module cannot be imported without JAX, because
``attention_lvcsr_tpu/ops/__init__.py`` imports ``expressions``.  Same
values (the golden values of the reference, arXiv:1511.06456's reward
math); the DP row uses the same prefix-min transform over deletions:

    dist[i][j] = min_k<=j ( base[i][k] + (j - k) )

with ``base`` the insertion/substitution/copy candidates of row ``i - 1``.
``batch_reward_and_gain`` is the reference ``RewardOp`` over a batch; it
takes the native C++ DP (``ops/native.py``) where the JAX module takes
it, when every groundtruth column holds EOS and the library exists, and
the numpy rows otherwise, which give the same integers.
``ops/reward_op.py`` computes the same matrices on the tensors' device.
"""
from __future__ import annotations

import numpy as np

# Action codes, the reference's encoding
COPY = 0
INSERTION = 1
DELETION = 2
SUBSTITUTION = 3


def edit_distance_matrix(y, y_hat):
    """The Levenshtein DP matrix of ``y`` and ``y_hat`` (strings or lists of
    ints) with its traceback actions: ``dist[i, j]`` the edit distance of
    ``y[:i]`` and ``y_hat[:j]``, ``action[i, j]`` the action applied to
    ``y_hat[j - 1]`` in a chain of optimal actions (the reference's
    tie-breaking: insertion < deletion < substitution < copy, later
    wins).  Both int64 (len(y) + 1, len(y_hat) + 1)."""
    y, y_hat = list(y), list(y_hat)
    n, m = len(y), len(y_hat)
    dist = np.zeros((n + 1, m + 1), dtype=np.int64)
    action = np.zeros_like(dist)
    dist[:, 0] = np.arange(n + 1)
    dist[0, :] = np.arange(m + 1)
    if m == 0 or n == 0:
        return dist, action
    y_arr = np.empty(n, dtype=object)
    y_arr[:] = y
    y_hat_arr = np.empty(m, dtype=object)
    y_hat_arr[:] = y_hat
    mismatch = (y_arr[:, None] != y_hat_arr[None, :]).astype(np.int64)
    j_idx = np.arange(1, m + 1)
    for i in range(1, n + 1):
        ins = dist[i - 1, 1:] + 1
        diag = dist[i - 1, :-1] + mismatch[i - 1]
        base = np.minimum(ins, diag)
        # deletions chain along the row: prefix-min of base[k] - k
        c = np.concatenate(([np.int64(i)], base - j_idx))
        run = np.minimum.accumulate(c)[1:]
        row = np.minimum(base, run + j_idx)
        dist[i, 1:] = row
        # the reference's if-cascade: an insertion inherits the action
        # above it, then deletion, substitution and copy overwrite
        act = np.empty(m, dtype=np.int64)
        is_ins = row == ins
        is_del = row == dist[i, :-1] + 1
        is_sub = (row == diag) & (mismatch[i - 1] == 1)
        is_copy = (row == diag) & (mismatch[i - 1] == 0)
        act[is_ins] = action[i - 1, 1:][is_ins]
        act[is_del] = DELETION
        act[is_sub] = SUBSTITUTION
        act[is_copy] = COPY
        action[i, 1:] = act
    return dist, action


def edit_distance(y, y_hat):
    """Minimum number of insertions, deletions and substitutions that
    turn ``y_hat`` into ``y`` (strings or lists of ints)."""
    y, y_hat = list(y), list(y_hat)
    m = len(y_hat)
    row = np.arange(m + 1, dtype=np.int64)
    if not y or not m:
        return max(len(y), m)
    hat = np.empty(m, dtype=object)
    hat[:] = y_hat
    cols = np.arange(1, m + 1)
    for i, sym in enumerate(y, start=1):
        mismatch = (hat != sym).astype(np.int64)
        base = np.minimum(row[1:] + 1, row[:-1] + mismatch)
        run = np.minimum.accumulate(np.concatenate(([i], base - cols)))[1:]
        row = np.concatenate(([i], np.minimum(base, run + cols)))
    return int(row[-1])


def wer(y, y_hat):
    """Length-normalized edit distance (CER when units are characters)."""
    return edit_distance(y, y_hat) / float(len(y))


def reward_matrix(y, y_hat, alphabet, eos_label):
    """Per-(prefix, next symbol) optimistic rewards: ``R[j, c]`` is minus
    the best edit distance to any groundtruth prefix of ``y_hat[:j]``
    followed by ``c``; the EOS column holds ``-dist[len(y) - 1, j]``.  The
    groundtruth must end with ``eos_label``."""
    dist, _ = edit_distance_matrix(y, y_hat)
    alphabet = list(alphabet)
    y_indices = np.asarray([alphabet.index(c) for c in y])
    if y_indices[-1] != eos_label:
        raise ValueError("Last character of the groundtruth must be EOS")
    optim_dist = dist.min(axis=0)
    # a wasted character: one worse than the prefix optimum
    char_dist = np.tile(optim_dist[:, None] + 1, (1, len(alphabet)))
    # emitting y[i] after a match up to i keeps dist[i, j]
    n = len(y_indices)
    cols = np.broadcast_to(y_indices[None, :], (dist.shape[1], n))
    np.minimum.at(
        char_dist,
        (np.repeat(np.arange(dist.shape[1]), n), cols.ravel()),
        dist[:n, :].T.ravel())
    reward = -char_dist
    reward[:, eos_label] = -dist[len(y) - 1, :]
    return reward


def gain_matrix(y, y_hat, alphabet=None, given_reward_matrix=None,
                eos_label=None):
    """Stepwise gains: ``G[j, c] = R[j, c] - R[j - 1, y_hat[j - 1]]``."""
    alphabet = list(alphabet)
    y_hat_indices = np.asarray([alphabet.index(c) for c in y_hat],
                               dtype=np.int64)
    reward = (np.array(given_reward_matrix, copy=True)
              if given_reward_matrix is not None
              else reward_matrix(y, y_hat, alphabet, eos_label))
    if len(y_hat_indices):
        taken = reward[np.arange(len(y_hat_indices)), y_hat_indices]
        reward[1:] -= taken[:, None]
    return reward


def batch_reward_and_gain(groundtruth, recognized, alphabet_size, eos_label,
                          min_reward=None):
    """Rewards and gains of a batch (the reference ``RewardOp.perform``):
    each (T, B) column is cut after its first EOS (included), the matrices
    of the cut pair lose their last row, and the rows past the cut length
    are -1 (rewards) and -1000 (gains).  ``min_reward`` clamps the gains
    from below.  Returns int64 (T, B, alphabet_size) rewards and gains.
    When every groundtruth column holds EOS, the native library computes
    them where it exists (``ops/native.py``)."""
    groundtruth = np.asarray(groundtruth)
    recognized = np.asarray(recognized)
    if groundtruth.ndim != 2 or recognized.ndim != 2 \
            or groundtruth.shape[1] != recognized.shape[1]:
        raise ValueError("expected (T, B) int matrices with equal batch")
    if (groundtruth == eos_label).any() \
            and (groundtruth == eos_label).any(axis=0).all():
        from attention_lvcsr_torch.ops import native
        result = native.batch_reward_and_gain_native(
            groundtruth, recognized, alphabet_size, eos_label)
        if result is not None:
            rewards, gains = result
            if min_reward is not None:
                gains = np.maximum(gains, min_reward)
            return rewards, gains
    return batch_reward_and_gain_rows(groundtruth, recognized,
                                      alphabet_size, eos_label, min_reward)


def batch_reward_and_gain_rows(groundtruth, recognized, alphabet_size,
                               eos_label, min_reward=None):
    """:func:`batch_reward_and_gain` by the numpy rows, one column at a
    time, without the native library."""
    groundtruth = np.asarray(groundtruth)
    recognized = np.asarray(recognized)
    T, B = recognized.shape
    alphabet = list(range(alphabet_size))
    all_rewards = np.zeros((T, B, alphabet_size), dtype=np.int64)
    all_gains = np.zeros((T, B, alphabet_size), dtype=np.int64)
    for b in range(B):
        y = list(groundtruth[:, b])
        y_hat = list(recognized[:, b])
        if eos_label in y:
            y = y[:y.index(eos_label) + 1]
        if eos_label in y_hat:
            y_hat = y_hat[:y_hat.index(eos_label) + 1]
        rewards_cut = reward_matrix(y, y_hat, alphabet, eos_label)
        gains_cut = gain_matrix(y, y_hat, alphabet,
                                given_reward_matrix=rewards_cut)
        rewards = np.full((T, alphabet_size), -1, dtype=np.int64)
        gains = np.full((T, alphabet_size), -1000, dtype=np.int64)
        rewards[:rewards_cut.shape[0] - 1] = rewards_cut[:-1]
        gains[:gains_cut.shape[0] - 1] = gains_cut[:-1]
        all_rewards[:, b] = rewards
        all_gains[:, b] = gains
    if min_reward is not None:
        all_gains = np.maximum(all_gains, min_reward)
    return all_rewards, all_gains
