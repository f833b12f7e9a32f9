"""The task loss's reward and gain matrices on the tensors' device.

Counterpart of ``attention_lvcsr_tpu/ops/reward_op.py``
(``_single_reward_gain`` :54, ``reward_and_gain_device`` :122,
``reward_and_gain`` :146): the reference ``RewardOp`` (``lvsr/ops.py``)
as a batched DP in plain PyTorch, the integers of
``ops/error_rate.py::batch_reward_and_gain``.  The JAX package computes
it outside any Pallas kernel, and so does the port: a loop over the
groundtruth's rows, each row one set of vector operations over the batch
and the hypothesis, the deletion chain a prefix minimum
(``torch.cummin``).  No gradient flows through it.
"""
from __future__ import annotations

import torch

BIG = 1 << 20


def _length_to_eos(seq, eos_label):
    """(B,) index of each row's first EOS plus one, or the row's length."""
    is_eos = seq == eos_label
    first = is_eos.to(torch.int32).argmax(dim=1)
    return torch.where(is_eos.any(dim=1), first + 1,
                       torch.full_like(first, seq.shape[1]))


@torch.no_grad()
def reward_and_gain(groundtruth, recognized, alphabet_size, eos_label=None):
    """Rewards and gains ``(T_g, B), (T_r, B) -> (T_r, B, A)`` int32 each.

    Each column is taken up to and including its first EOS (all of it
    without one); the rows past a hypothesis's length are -1 (rewards)
    and -1000 (gains).  ``eos_label`` defaults to ``alphabet_size - 1``."""
    A = int(alphabet_size)
    eos = A - 1 if eos_label is None else int(eos_label)
    gt = groundtruth.to(torch.int32).t()                  # (B, T_g)
    rec = recognized.to(torch.int32).t()                  # (B, T_r)
    B, T_g = gt.shape
    T_r = rec.shape[1]
    dev = rec.device
    n = _length_to_eos(gt, eos)[:, None]                  # (B, 1)
    m = _length_to_eos(rec, eos)[:, None]
    j = torch.arange(T_r + 1, dtype=torch.int32, device=dev)

    # ---- Levenshtein rows, the deletions a prefix minimum ------------
    prev = j.expand(B, T_r + 1)
    rows = [prev]
    for i in range(T_g):
        mismatch = (rec != gt[:, i:i + 1]).to(torch.int32)
        base = torch.minimum(prev[:, :-1] + mismatch, prev[:, 1:] + 1)
        seed = torch.full((B, 1), i + 1, dtype=torch.int32, device=dev)
        run = torch.cummin(torch.cat([seed, base - j[1:]], dim=1),
                           dim=1).values[:, 1:]
        row = torch.cat([seed, torch.minimum(base, run + j[1:])], dim=1)
        # rows past the groundtruth's length keep the one before
        prev = torch.where(i < n, row, prev)
        rows.append(prev)
    dist = torch.stack(rows, dim=1)                       # (B, T_g+1, T_r+1)
    i_idx = torch.arange(T_g + 1, device=dev)[None, :, None]
    dist_masked = torch.where(i_idx <= n[:, :, None], dist, BIG)

    # ---- rewards ------------------------------------------------------
    optim = dist_masked.min(dim=1).values                 # (B, T_r+1)
    char_dist = (optim + 1)[:, :, None].expand(B, T_r + 1, A).contiguous()
    # char_dist[b, j, c] = min over i < n with gt[b, i] == c of dist[b, i, j]
    active = torch.arange(T_g, device=dev)[None, :] < n   # (B, T_g)
    src = torch.where(active[:, :, None], dist[:, :T_g], BIG)
    char_dist.scatter_reduce_(
        2, gt.long()[:, None, :].expand(B, T_r + 1, T_g),
        src.transpose(1, 2), reduce="amin")
    reward = -char_dist
    last = dist.gather(1, (n - 1).clamp(min=0)[:, :, None].long()
                       .expand(B, 1, T_r + 1))[:, 0]       # (B, T_r+1)
    reward[:, :, eos] = -last

    # ---- gains --------------------------------------------------------
    taken = reward[:, :-1].gather(2, rec.long()[:, :, None])   # (B, T_r, 1)
    gain = torch.cat([reward[:, :1], reward[:, 1:] - taken], dim=1)

    # ---- the last row dropped, padding past each hypothesis -----------
    pos = torch.arange(T_r, device=dev)[None, :, None]
    live = pos < m[:, :, None]
    rewards = torch.where(live, reward[:, :-1], -1)
    gains = torch.where(live, gain[:, :-1], -1000)
    return (rewards.transpose(0, 1).contiguous().to(torch.int32),
            gains.transpose(0, 1).contiguous().to(torch.int32))
