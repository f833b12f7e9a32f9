"""Batched beam search through the whole-loop decode kernel.

Counterpart of ``attention_lvcsr_tpu/search/beam.py`` on its loop-kernel
route (``BeamSearch._search_loop_kernel``): encoder + one decode launch
per batch, returning the same arrays (``done_out``, ``done_cost``,
``done_adjusted``, ``done_len``, ``done_valid``, ``steps``).  Semantics
(char_discount, round_to_inf, ignore_first_eol, patience and
optimistic_future_cost stopping, EOS retirement, lowest-flat-index tie
order) are those of ``ops/beam_loop.py``.

Not ported yet, and raising ``NotImplementedError``: LM shallow fusion
and the module-driven decode (``_search_core``), ``DecodeConstraint`` and
host ``validate_solution_function`` checks, the bf16 ``compute_dtype``,
and the model variants listed in ``models/recognizer.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from attention_lvcsr_torch.ops.beam_loop import INF, beam_search_loop


class CandidateNotFoundError(Exception):
    """No finished hypothesis was produced (blocks/search.py:15)."""


class BeamSearch:
    def __init__(self, recognizer, beam_size: int, compute_dtype=None):
        self.recognizer = recognizer
        self.net = recognizer.net
        self.beam_size = beam_size
        self.compute_dtype = compute_dtype
        self._tables = None          # (parameter token, tables)

    def _loop_tables(self):
        """Decode tables, rebuilt when any parameter was replaced or
        written in place (storage pointer and version counter)."""
        token = tuple((p.data_ptr(), p._version)
                      for p in self.net.parameters())
        if self._tables is None or self._tables[0] != token:
            self._tables = (token, self.net.decode_loop_tables())
        return self._tables[1]

    @torch.inference_mode()
    def search(self, inputs, inputs_mask, eol_symbol, max_length,
               ignore_first_eol=False, as_arrays=False, char_discount=0.0,
               round_to_inf=1e9, stop_on="patience",
               validate_solution_function=None):
        if validate_solution_function is not None:
            raise NotImplementedError(
                "validate_solution_function (DecodeConstraint or host "
                "validator) is not ported yet")
        if self.compute_dtype is not None:
            raise NotImplementedError(
                f"compute_dtype {self.compute_dtype!r}: only float32 "
                "decoding is ported")
        device = self.recognizer.device
        inputs = torch.as_tensor(inputs, dtype=torch.float32, device=device)
        inputs_mask = torch.as_tensor(inputs_mask, dtype=torch.float32,
                                      device=device)
        data = self.net.decode_loop(inputs, inputs_mask)
        prior = self.net.generator.attention.prior_config()
        done_out, done_meta, steps = beam_search_loop(
            data["pre"], data["attended"], data["attended_mask"],
            self._loop_tables(), beam=self.beam_size,
            max_len=max(1, int(max_length)), eol=int(eol_symbol),
            stop_on=stop_on, ignore_first_eol=bool(ignore_first_eol),
            char_discount=float(char_discount),
            round_to_inf=float(round_to_inf),
            prior=prior.get("type", "expanding"),
            before=float(prior.get("before", 0.0)),
            after=float(prior.get("after", 0.0)),
            initial_begin=float(prior.get("initial_begin", 0.0)),
            initial_end=float(prior.get("initial_end", 1e4)),
            min_speed=float(prior.get("min_speed", 0.0)),
            max_speed=float(prior.get("max_speed", 0.0)))
        meta = done_meta.cpu().numpy()
        out = {
            "done_out": done_out.cpu().numpy(),
            "done_cost": meta[:, :, 0],
            "done_adjusted": meta[:, :, 1],
            "done_len": meta[:, :, 2].astype(np.int32),
            "done_valid": meta[:, :, 1] < INF / 2,
            "steps": steps.max().cpu().numpy(),
        }
        if as_arrays:
            return out
        return self._to_lists(out)

    @staticmethod
    def _to_lists(out):
        """Best-first outputs/costs for the first utterance (the reference
        API decodes one utterance at a time)."""
        valid = out["done_valid"][0]
        if not valid.any():
            raise CandidateNotFoundError()
        order = [i for i in np.argsort(out["done_adjusted"][0]) if valid[i]]
        outputs = [list(out["done_out"][0, i, :out["done_len"][0, i]])
                   for i in order]
        costs = [float(out["done_cost"][0, i]) for i in order]
        return outputs, costs
