"""The recurrent cells: simple RNN, GRU and peephole LSTM, with trainable
initial states.

Counterparts of ``attention_lvcsr_tpu/models/cells.py``:

* :class:`SimpleRecurrent` — the Elman RNN ``h' = tanh(h W + x)``
  (``cells.py:93-115``); JAX has no kernel for it, and neither has the
  port: its scan (:func:`simple_scan`) is a module scan of PyTorch
  operations on every device, differentiable;
* :class:`GatedRecurrent` — blocks' gate layout (update first, then
  reset) and update rule ``h' = z*tanh((r*h) Wss + x) + (1-z)*h`` with
  ``[z, r] = sigmoid(h Wsg + xg)``;
* :class:`LSTM` — blocks' gate order [in, forget, cell, out] with
  peepholes, the out gate's on the new cell (``cells.py:199-212``).

A masked step (mask 0) keeps the state (and the cell).  ``has_cells``
says whether a cell carries memory cells beside its states (the LSTM):
its ``one_step`` then takes and returns the (states, cells) pair, as the
decoder's transition drives it.  Input projections
are computed by the caller for the whole sequence; ``scan`` runs the
recurrence through ``ops/gru_scan.py`` / ``ops/lstm_scan.py`` (inference)
or, with ``train``, through the differentiable ``ops/gru_train.py`` /
``ops/lstm_train.py`` (the CUDA kernels on a CUDA tensor); the encoder
runs both directions of a layer in one call.  Parameter names are the JAX
package's, so ``models/params.py`` maps them unchanged.
"""
from __future__ import annotations

import torch
from torch import nn

from attention_lvcsr_torch.ops.gru_scan import gru_scan
from attention_lvcsr_torch.ops.gru_train import gru_scan_train
from attention_lvcsr_torch.ops.lstm_scan import lstm_scan
from attention_lvcsr_torch.ops.lstm_train import lstm_scan_train


def _keep(mask, new, old):
    """``new`` on the live rows of a (B,) mask, else ``old``."""
    if mask is None:
        return new
    m = mask[..., None]
    return m * new + (1.0 - m) * old


def _simple_direction(x, mask, h0, w, reverse):
    """One direction of the simple RNN over time (T, B, D)."""
    T = x.shape[0]
    h, out = h0, [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h = _keep(None if mask is None else mask[t],
                  torch.tanh(h @ w + x[t]), h)
        out[t] = h
    return torch.stack(out)


def simple_scan(proj, mask, fwd, bwd=None):
    """The simple RNN over time, one direction or both, as
    ``ops/gru_scan.py::gru_scan`` lays them out: ``proj`` (T, B, D) or
    (T, B, 2D) = [inputs_fwd | inputs_bwd], ``fwd`` and ``bwd`` (h0 (B, D),
    W (D, D)); returns the states (T, B, D) or (T, B, 2D) = [forward |
    backward], the backward direction run in reverse time."""
    D = fwd[1].shape[0]
    states = _simple_direction(proj[..., :D], mask, *fwd, reverse=False)
    if bwd is None:
        return states
    return torch.cat([states, _simple_direction(proj[..., D:], mask, *bwd,
                                                reverse=True)], dim=-1)


class SimpleRecurrent(nn.Module):
    """Elman RNN: ``h' = tanh(h W + x)`` (blocks ``SimpleRecurrent``)."""
    sequence_names = ("inputs",)
    has_cells = False

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.W = nn.Parameter(torch.zeros(dim, dim))
        self.initial_state = nn.Parameter(torch.zeros(dim))

    def sequence_dims(self):
        return {"inputs": self.dim}

    def initial_states(self, batch_size):
        return self.initial_state.expand(batch_size, self.dim)

    def one_step(self, h, seqs, mask=None):
        return _keep(mask, torch.tanh(h @ self.W + seqs["inputs"]), h)

    def scan_weights(self, batch_size):
        """(h0, W) as :func:`simple_scan` takes them."""
        return self.initial_states(batch_size), self.W

    @staticmethod
    def scan_fn(train):
        """The module scan, the same for training and inference."""
        return simple_scan

    def scan(self, seqs, mask=None, train=False):
        return simple_scan(seqs["inputs"], mask,
                           self.scan_weights(seqs["inputs"].shape[1]))


class GatedRecurrent(nn.Module):
    sequence_names = ("inputs", "gate_inputs")
    has_cells = False

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.state_to_state = nn.Parameter(torch.zeros(dim, dim))
        self.state_to_gates = nn.Parameter(torch.zeros(dim, 2 * dim))
        self.initial_state = nn.Parameter(torch.zeros(dim))

    def sequence_dims(self):
        return {"inputs": self.dim, "gate_inputs": 2 * self.dim}

    def initial_states(self, batch_size):
        return self.initial_state.expand(batch_size, self.dim)

    def one_step(self, h, seqs, mask=None):
        gates = torch.sigmoid(h @ self.state_to_gates + seqs["gate_inputs"])
        update = gates[..., :self.dim]
        reset = gates[..., self.dim:]
        candidate = torch.tanh((h * reset) @ self.state_to_state
                               + seqs["inputs"])
        new_h = update * candidate + (1.0 - update) * h
        return _keep(mask, new_h, h)

    def scan_weights(self, batch_size):
        """(h0, state_to_state, state_to_gates) as the scans take them."""
        return (self.initial_states(batch_size).contiguous(),
                self.state_to_state.contiguous(),
                self.state_to_gates.contiguous())

    @staticmethod
    def scan_fn(train):
        """The scan over both directions' (or one's) projections."""
        return gru_scan_train if train else gru_scan

    def scan(self, seqs, mask=None, train=False):
        """seqs: name -> (T, B, d) projections; mask (T, B) or None ->
        states (T, B, dim).  ``train`` takes the differentiable scan."""
        proj = torch.cat([seqs["inputs"], seqs["gate_inputs"]], dim=-1)
        return self.scan_fn(train)(
            proj, mask.contiguous() if mask is not None else None,
            self.scan_weights(proj.shape[1]))


class LSTM(nn.Module):
    """LSTM with peepholes, blocks' gate order [in, forget, cell, out]."""
    sequence_names = ("inputs",)
    has_cells = True

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.W_state = nn.Parameter(torch.zeros(dim, 4 * dim))
        self.W_cell_to_in = nn.Parameter(torch.zeros(dim))
        self.W_cell_to_forget = nn.Parameter(torch.zeros(dim))
        self.W_cell_to_out = nn.Parameter(torch.zeros(dim))
        self.initial_state = nn.Parameter(torch.zeros(dim))
        self.initial_cells = nn.Parameter(torch.zeros(dim))

    def sequence_dims(self):
        return {"inputs": 4 * self.dim}

    def initial_states(self, batch_size):
        """(states, cells), each (batch_size, dim)."""
        return (self.initial_state.expand(batch_size, self.dim),
                self.initial_cells.expand(batch_size, self.dim))

    def one_step(self, states, seqs, mask=None):
        """(h, c), seqs["inputs"] (B, 4D) -> the next (h, c)."""
        h, c = states
        acts = h @ self.W_state + seqs["inputs"]
        d = self.dim
        in_gate = torch.sigmoid(acts[..., :d] + c * self.W_cell_to_in)
        forget_gate = torch.sigmoid(acts[..., d:2 * d]
                                    + c * self.W_cell_to_forget)
        new_c = forget_gate * c + in_gate * torch.tanh(acts[..., 2 * d:3 * d])
        out_gate = torch.sigmoid(acts[..., 3 * d:]
                                 + new_c * self.W_cell_to_out)
        new_h = out_gate * torch.tanh(new_c)
        if mask is None:
            return new_h, new_c
        keep = (mask != 0)[..., None]
        return torch.where(keep, new_h, h), torch.where(keep, new_c, c)

    def scan_weights(self, batch_size):
        """(h0, c0, W_state, W_cell_to_in, W_cell_to_forget,
        W_cell_to_out) as the scans take them."""
        h0, c0 = self.initial_states(batch_size)
        return (h0.contiguous(), c0.contiguous(), self.W_state.contiguous(),
                self.W_cell_to_in, self.W_cell_to_forget, self.W_cell_to_out)

    @staticmethod
    def scan_fn(train):
        """The scan over both directions' (or one's) projections."""
        return lstm_scan_train if train else lstm_scan

    def scan(self, seqs, mask=None, train=False):
        """seqs: {"inputs": (T, B, 4D)}; mask (T, B) or None -> (states,
        cells), each (T, B, dim).  ``train`` takes the differentiable
        scan."""
        proj = seqs["inputs"].contiguous()
        return self.scan_fn(train)(
            proj, mask.contiguous() if mask is not None else None,
            self.scan_weights(proj.shape[1]))


CELL_REGISTRY = {
    "simple": SimpleRecurrent,
    "gru": GatedRecurrent,
    "lstm": LSTM,
    # blocks' class names, as the reference's YAML names them
    "SimpleRecurrent": SimpleRecurrent,
    "GatedRecurrent": GatedRecurrent,
    "LSTM": LSTM,
}


def make_cell(kind: str, dim: int) -> nn.Module:
    """'simple', 'gru', 'lstm' or a blocks class path
    ('...recurrent.LSTM')."""
    key = kind.rsplit(".", 1)[-1]
    if key not in CELL_REGISTRY:
        raise NotImplementedError(f"not ported yet: the {kind!r} cell")
    return CELL_REGISTRY[key](dim)
