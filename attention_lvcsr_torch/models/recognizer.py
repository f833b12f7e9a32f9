"""The recognizer: speech bottom -> BiGRU encoder -> attention decoder.

Counterpart of ``attention_lvcsr_tpu/models/recognizer.py``:

* :class:`RecognizerNet` — the network from the ``net`` config section
  (same keys), with ``encode`` (the inference encoder), ``decode_loop``
  and ``decode_loop_tables`` (what the whole-loop decode consumes), and
  the step interface of the module-driven decode (``decode_contexts``,
  ``decode_init``, ``decode_score``, ``decode_advance``); a ``net.lm``
  section with a ``path`` adds the FST language model and the
  shallow-fusion readout;
* :class:`SpeechRecognizer` — parameters, config-driven init, checkpoint
  loading and saving, the training cost (``cost_fn``) and
  ``beam_search`` with the same frame and batch padding.

The port covers the flagship configuration family; anything else raises
``NotImplementedError`` naming the piece that is not ported yet.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from attention_lvcsr_torch.models.attention import \
    SequenceContentAndConvAttention
from attention_lvcsr_torch.models.bottom import SpeechBottom
from attention_lvcsr_torch.models.encoder import Encoder
from attention_lvcsr_torch.models.generator import SequenceGenerator
from attention_lvcsr_torch.models.initializers import initialize_params
from attention_lvcsr_torch.models.params import (load_parameters,
                                                 load_path_dict,
                                                 named_parameters,
                                                 param_path_dict,
                                                 param_shapes)


def _canon(name):
    """'blocks.bricks.recurrent.GatedRecurrent' -> 'GatedRecurrent'."""
    return name.rsplit(".", 1)[-1] if isinstance(name, str) else name


def unported_piece(cfg: Mapping[str, Any]) -> Optional[str]:
    """The first part of a net config this port does not cover yet."""
    bottom = dict(cfg.get("bottom") or {"bottom_class": "speech"})
    criterion = dict(cfg.get("criterion") or {"name": "log_likelihood"})
    prior = dict(cfg.get("prior") or {})
    checks = [
        (_canon(bottom.get("bottom_class", "speech"))
         in ("speech", "SpeechBottom"), "a non-speech (lookup) bottom"),
        (all(_canon(cfg.get(k, "gru")) in ("gru", "GatedRecurrent")
             for k in ("enc_transition", "dec_transition")),
         "a non-GRU transition (LSTM or simple RNN)"),
        (not cfg.get("dims_top"), "the top MLP (dims_top)"),
        (cfg.get("attention_type", "content") == "content_and_conv",
         f"attention_type {cfg.get('attention_type', 'content')!r} "
         "(content-only attention)"),
        ((cfg.get("conv_num_filters") or 1) == 1, "multiple conv filters"),
        ((cfg.get("energy_normalizer") or "softmax") == "softmax",
         f"the {cfg.get('energy_normalizer')!r} energy normalizer"),
        ((cfg.get("dec_stack") or 1) == 1, "a stacked decoder (dec_stack > 1)"),
        (cfg.get("post_merge_dims") is not None
         and len(cfg["post_merge_dims"]) == 1,
         "a readout without exactly one post-merge layer"),
        ((cfg.get("post_merge_activation") or "tanh") == "tanh",
         f"the {cfg.get('post_merge_activation')!r} post-merge activation"),
        (criterion.get("name") == "log_likelihood",
         f"the {criterion.get('name')!r} criterion"),
        (cfg.get("embed_outputs", True), "one-hot (non-embedded) feedback"),
        (prior.get("type", "expanding")
         in ("expanding", "window_around_median"),
         f"the {prior.get('type')!r} attention prior"),
    ]
    for ok, piece in checks:
        if not ok:
            return piece
    return None


class RecognizerNet(nn.Module):
    """Network assembly from the ``net`` config section (JAX field names).

    ``use_pallas`` selects routes, not devices: CUDA tensors always take
    the kernels.  ``"fused"`` (and ``"interpret"``, as in the JAX
    package's tests) makes the module-driven decode score each step with
    ``fused_decode_score``; ``"never"`` keeps a decode without LM or
    constraint off the whole-loop kernel and the training cost's decoder
    on the plain module scan, as in the JAX package.  ``dropout`` is
    not ported: a training cost with it raises."""

    def __init__(self, input_dims: Mapping[str, int], eos_label: int,
                 num_phonemes: int, dim_dec: int, dims_bidir: Sequence[int],
                 input_num_chars=None, enc_transition="gru",
                 dec_transition="gru", attention_type="content",
                 use_states_for_readout=False, criterion=None, bottom=None,
                 lm=None, character_map=None, bidir=True, subsample=None,
                 dims_top=None, prior=None, conv_n=None,
                 post_merge_activation="tanh", post_merge_dims=None,
                 dim_matcher=None, embed_outputs=True,
                 dim_output_embedding=None, dec_stack=1, conv_num_filters=1,
                 data_prepend_eos=True, energy_normalizer=None,
                 max_decoded_length_scale=1.0, dropout=False,
                 use_pallas="auto"):
        super().__init__()
        piece = unported_piece(dict(
            bottom=bottom, enc_transition=enc_transition,
            dec_transition=dec_transition, bidir=bidir, dims_top=dims_top,
            attention_type=attention_type,
            conv_num_filters=conv_num_filters,
            energy_normalizer=energy_normalizer, dec_stack=dec_stack,
            post_merge_dims=post_merge_dims,
            post_merge_activation=post_merge_activation,
            criterion=criterion, embed_outputs=embed_outputs,
            prior=prior))
        if piece is not None:
            raise NotImplementedError(f"not ported yet: {piece}")
        bottom = dict(bottom or {})
        bottom.pop("bottom_class", None)
        self.bottom = SpeechBottom(input_dims["recordings"], **bottom)
        self.encoder = Encoder(self.bottom.output_dim, dims_bidir,
                               subsample or [1] * len(dims_bidir),
                               bidir=bidir)
        self.dropout = dropout
        D = self.encoder.dim_encoded
        attention = SequenceContentAndConvAttention(
            ("states",), dim_dec, D, dim_matcher or dim_dec, conv_n,
            prior=prior)
        self.use_pallas = use_pallas
        lm_conf = dict(lm or {})
        language_model = fusion = None
        if lm_conf.get("path"):
            from attention_lvcsr_torch.models.lm import make_language_model
            fusion = {
                "lm_weight": lm_conf.pop("weight", 0.0),
                "normalize_am_weights": lm_conf.pop("normalize_am_weights",
                                                    True),
                "normalize_lm_weights": lm_conf.pop("normalize_lm_weights",
                                                    False),
                "normalize_tot_weights": lm_conf.pop(
                    "normalize_tot_weights", False),
                "am_beta": lm_conf.pop("am_beta", 1.0)}
            lm_conf.pop("type", None)
            language_model = make_language_model(
                lm_conf, nn_char_map=dict(character_map or {}))
        self.generator = SequenceGenerator(
            attention, num_phonemes, dim_dec,
            dim_output_embedding or dim_dec, post_merge_dims,
            use_states_for_readout=use_states_for_readout,
            language_model=language_model, fusion=fusion)

    def encode(self, inputs, inputs_mask, train=False):
        """(B, T, F) features, (B, T) mask -> encoded (B, L, D), mask.
        ``train`` runs the differentiable scans of the training path."""
        return self.encoder(self.bottom(inputs), inputs_mask, train=train)

    def cost(self, inputs, inputs_mask, labels, labels_mask, train=False):
        """The teacher-forced cost graph (JAX ``RecognizerNet.cost``):
        batch-major (B, T) labels and masks in, the generator's evaluate
        dict (``costs`` (T, B), ``weights``, ``energies``, ``readouts``)
        plus ``encoded``, ``encoded_mask`` and ``bottom_output`` out."""
        if self.dropout and train:
            raise NotImplementedError("not ported yet: dropout")
        bottom_output = self.bottom(inputs)
        encoded, encoded_mask = self.encoder(bottom_output, inputs_mask,
                                             train=True)
        result = self.generator.evaluate(
            encoded, encoded_mask, labels.T,
            labels_mask.T if labels_mask is not None else None,
            use_pallas=self.use_pallas)
        result.update(encoded=encoded, encoded_mask=encoded_mask,
                      bottom_output=bottom_output)
        return result

    def decode_loop(self, inputs, inputs_mask):
        """Encoder outputs + preprocessed keys for the decode kernel."""
        encoded, encoded_mask = self.encode(inputs, inputs_mask)
        encoded = encoded.contiguous()
        return {
            "pre": self.generator.attention.preprocess(encoded).contiguous(),
            "attended": encoded,
            "attended_mask": encoded_mask.contiguous(),
        }

    def decode_loop_tables(self):
        return self.generator.loop_decode_tables()

    # -- the step interface of the module-driven decode ------------------
    def decode_contexts(self, inputs, inputs_mask):
        """Per-utterance contexts: encoder outputs, keys, mask, and the
        fused score tables when ``use_pallas`` opts into them."""
        encoded, encoded_mask = self.encode(inputs, inputs_mask)
        encoded = encoded.contiguous()
        ctx = {
            "attended": encoded,
            "preprocessed": self.generator.attention.preprocess(encoded)
            .contiguous(),
            "attended_mask": encoded_mask.contiguous(),
        }
        if self.use_pallas in ("fused", "interpret") \
                and self.generator.fused_score_supported():
            ctx["fused_tables"] = self.generator.fused_score_tables()
        return ctx

    def decode_init(self, batch_size, contexts):
        return self.generator.initial_states(batch_size,
                                             contexts["attended"])

    def decode_score(self, carry, contexts, beam=1):
        return self.generator.score_step(carry, contexts, beam=beam)

    def decode_advance(self, carry, g_new, outputs):
        return self.generator.advance_states(carry, g_new, outputs)


class SpeechRecognizer:
    """Owns the net and its parameters on ``device``; the public surface
    the serving code (``serve.Transcriber``) uses."""

    def __init__(self, net_config: Mapping[str, Any], *,
                 init_config: Optional[Mapping] = None, seed: int = 1234,
                 device="cpu"):
        self.net_config = dict(net_config)
        self.compute_dtype = self.net_config.pop("compute_dtype", None)
        self.device = torch.device(device)
        self.net = RecognizerNet(**self.net_config).to(self.device)
        self.net.requires_grad_(False)
        self.eos_label = self.net_config["eos_label"]
        self.num_phonemes = self.net_config["num_phonemes"]
        self.character_map = self.net_config.get("character_map")
        self.data_prepend_eos = self.net_config.get("data_prepend_eos", True)
        self.max_decoded_length_scale = self.net_config.get(
            "max_decoded_length_scale", 1.0)
        self._beam_search = None
        self.beam_size = None
        self.init_params(init_config or {}, seed=seed)

    # -- parameters --------------------------------------------------------
    def parameters(self):
        """``{'/recognizer/...': parameter}``, the JAX package's keys."""
        return named_parameters(self.net)

    def init_params(self, init_config, seed=1234):
        load_path_dict(self.net, initialize_params(
            param_shapes(self.net), init_config, seed=seed))

    def load_params(self, path):
        """Load a JAX-package checkpoint (tar or npz).  Keys outside
        ``/recognizer`` (the adaptive-noise variances) are not model
        parameters and are skipped, as the JAX ``load_params`` skips
        them."""
        params = {k: v for k, v in load_parameters(path).items()
                  if k.startswith("/recognizer/")}
        load_path_dict(self.net, params)

    def param_path_dict(self):
        return param_path_dict(self.net)

    # -- the training cost -------------------------------------------------
    def cost_fn(self):
        """``fn(inputs, inputs_mask, labels, labels_mask)`` -> the cost
        dict of :meth:`RecognizerNet.cost`, differentiable in the
        parameters (which then need ``requires_grad``)."""
        def fn(inputs, inputs_mask, labels, labels_mask, train=False):
            return self.net.cost(inputs, inputs_mask, labels, labels_mask,
                                 train=train)
        return fn

    # -- beam search -------------------------------------------------------
    def init_beam_search(self, beam_size, compute_dtype="default"):
        from attention_lvcsr_torch.search.beam import BeamSearch
        if compute_dtype == "default":
            compute_dtype = self.compute_dtype
        if self._beam_search is not None and self.beam_size == beam_size \
                and self._beam_search.compute_dtype == compute_dtype:
            return
        self.beam_size = beam_size
        self._beam_search = BeamSearch(self, beam_size,
                                       compute_dtype=compute_dtype)

    def beam_search(self, inputs, inputs_mask=None, pad_frames_multiple=100,
                    pad_batch_multiple=8, **kwargs):
        """Decode one (T, F) utterance or a (B, T, F) batch.

        Time is zero-padded to a multiple of ``pad_frames_multiple`` and
        the batch to a multiple of ``pad_batch_multiple`` (a single
        utterance stays single) with zero mask, like the JAX package; the
        decode-length cap comes from the unpadded T."""
        self.init_beam_search(self.beam_size or 10)
        inputs = torch.as_tensor(np.asarray(inputs, np.float32)
                                 if not torch.is_tensor(inputs) else inputs,
                                 dtype=torch.float32, device=self.device)
        if inputs.ndim == 2:
            inputs = inputs[None]
        if inputs_mask is None:
            mask = torch.ones(inputs.shape[:2], device=self.device)
        else:
            mask = torch.as_tensor(
                np.asarray(inputs_mask, np.float32)
                if not torch.is_tensor(inputs_mask) else inputs_mask,
                dtype=torch.float32, device=self.device)
        B, T = inputs.shape[:2]
        max_length = int(T / self.max_decoded_length_scale)

        def up(n, m):
            return -(-n // m) * m if m and m > 1 else n

        T_pad, B_pad = up(T, pad_frames_multiple), up(B, pad_batch_multiple)
        if B == 1:
            B_pad = 1
        if (T_pad, B_pad) != (T, B):
            padded = inputs.new_zeros((B_pad, T_pad) + inputs.shape[2:])
            padded[:B, :T] = inputs
            padded_mask = mask.new_zeros((B_pad, T_pad))
            padded_mask[:B, :T] = mask
            inputs, mask = padded, padded_mask
        return self._beam_search.search(
            inputs, mask, self.eos_label, max_length,
            ignore_first_eol=self.data_prepend_eos, **kwargs)
