"""The recognizer: bottom -> (bi)directional encoder -> top MLP ->
attention decoder.

Counterpart of ``attention_lvcsr_tpu/models/recognizer.py``:

* :class:`RecognizerNet` — the network from the ``net`` config section
  (same keys: the speech or lookup bottom, a GRU, LSTM or simple-RNN
  encoder, the optional top MLP ``dims_top``, ``dec_stack`` GRU, LSTM or
  simple-RNN decoder layers, embedded or one-hot feedback), with
  ``encode`` (the inference encoder), ``decode_loop`` and ``decode_loop_tables`` (what the whole-loop decode consumes), and
  the step interface of the module-driven decode (``decode_contexts``,
  ``decode_init``, ``decode_score``, ``decode_advance``); a ``net.lm``
  section with a ``path`` adds the FST language model and the
  shallow-fusion readout;
* :class:`SpeechRecognizer` — parameters, config-driven init, checkpoint
  loading and saving, the training cost (``cost_fn``), ``analyze`` (the
  cost and alignment the search driver prints), ``sample`` and
  ``beam_search`` with the same frame and batch padding; a lookup
  bottom's inputs are (B, T) integer tokens, kept integer throughout.

A configuration the port does not cover raises ``NotImplementedError``
naming the piece (:func:`unported_piece`).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from attention_lvcsr_torch.models.attention import make_attention
from attention_lvcsr_torch.models.bottom import make_bottom
from attention_lvcsr_torch.models.encoder import Encoder
from attention_lvcsr_torch.models.generator import (SequenceGenerator,
                                                    state_names)
from attention_lvcsr_torch.models.initializers import initialize_params
from attention_lvcsr_torch.models.layers import Dense
from attention_lvcsr_torch.models.params import (NOISE_PREFIX, PREFIX,
                                                 load_parameters,
                                                 load_path_dict,
                                                 named_parameters,
                                                 param_path_dict,
                                                 param_shapes)


def _canon(name):
    """'blocks.bricks.recurrent.GatedRecurrent' -> 'GatedRecurrent'."""
    return name.rsplit(".", 1)[-1] if isinstance(name, str) else name


def unported_piece(cfg: Mapping[str, Any]) -> Optional[str]:
    """The first part of a net config this port does not cover yet."""
    criterion = dict(cfg.get("criterion") or {"name": "log_likelihood"})
    prior = dict(cfg.get("prior") or {})
    checks = [
        (cfg.get("attention_type", "content") in ("content",
                                                  "content_and_conv"),
         f"attention_type {cfg.get('attention_type')!r}"),
        ((cfg.get("energy_normalizer") or "softmax")
         in ("softmax", "logistic", "relu"),
         f"the {cfg.get('energy_normalizer')!r} energy normalizer"),
        (criterion.get("name") in ("log_likelihood", "mse_gain",
                                   "mse_reward"),
         f"the {criterion.get('name')!r} criterion"),
        (prior.get("type", "expanding")
         in ("expanding", "window_around_median", "window_around_mean"),
         f"the {prior.get('type')!r} attention prior"),
    ]
    for ok, piece in checks:
        if not ok:
            return piece
    return None


# the bottom dropout's rate (the reference's graph surgery,
# lvsr/main.py:402-404)
DROPOUT_RATE = 0.5


def draw_dropout_mask(shape, generator, device=None):
    """A bool mask of ``shape`` keeping each value with probability
    ``1 - DROPOUT_RATE``: one ``torch.rand`` from ``generator`` on
    ``device``."""
    return torch.rand(tuple(shape), generator=generator,
                      device=device) < 1.0 - DROPOUT_RATE


class TopMLP(nn.Module):
    """The MLP on top of the encoder (JAX ``TopMLP``,
    ``recognizer.py:44-53``): tanh layers ``top_{i}`` of ``dims``, then the
    linear ``top_out`` back to ``out_dim``."""

    def __init__(self, in_dim: int, dims: Sequence[int], out_dim: int):
        super().__init__()
        self.dims = list(dims)
        for i, d in enumerate(self.dims):
            self.add_module(f"top_{i}", Dense(in_dim, d))
            in_dim = d
        self.top_out = Dense(in_dim, out_dim)

    def forward(self, x):
        for i in range(len(self.dims)):
            x = torch.tanh(getattr(self, f"top_{i}")(x))
        return self.top_out(x)


def bottom_dropout(x, mask):
    """Dropout as flax's ``nn.Dropout``: the kept values divided by the
    keep probability, the others zero."""
    keep = 1.0 - DROPOUT_RATE
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


class RecognizerNet(nn.Module):
    """Network assembly from the ``net`` config section (JAX field names).

    ``use_pallas`` selects routes, not devices: CUDA tensors always take
    the kernels.  ``"fused"`` (and ``"interpret"``, as in the JAX
    package's tests) makes the module-driven decode score each step with
    ``fused_decode_score``; ``"never"`` keeps a decode without LM or
    constraint off the whole-loop kernel and the training cost's decoder
    on the plain module scan, as in the JAX package.  ``dropout`` drops
    half of the bottom's output in the training cost (``cost(...,
    train=True)``), as the JAX package's ``bottom_dropout`` does."""

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
            attention_type=attention_type,
            energy_normalizer=energy_normalizer, criterion=criterion,
            prior=prior))
        if piece is not None:
            raise NotImplementedError(f"not ported yet: {piece}")
        self.bottom = make_bottom(bottom, input_dims, input_num_chars or {})
        self.encoder = Encoder(self.bottom.output_dim, dims_bidir,
                               subsample or [1] * len(dims_bidir),
                               bidir=bidir, transition=enc_transition)
        self.dropout = dropout
        D = self.encoder.dim_encoded
        self.top = TopMLP(D, dims_top, D) if dims_top else None
        # the state names of JAX ``recognizer.py:111-112``
        attention = make_attention(attention_type,
                                   state_names(dec_stack or 1), dim_dec, D,
                                   dim_matcher or dim_dec, conv_n=conv_n,
                                   conv_num_filters=conv_num_filters,
                                   prior=prior,
                                   energy_normalizer=energy_normalizer)
        criterion = dict(criterion or {"name": "log_likelihood"})
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
            post_merge_activation=post_merge_activation or "tanh",
            use_states_for_readout=use_states_for_readout,
            language_model=language_model, fusion=fusion,
            criterion=criterion["name"],
            min_reward=float(criterion.get("min_reward", -1.0)),
            dec_stack=dec_stack or 1, transition=dec_transition,
            embed_outputs=embed_outputs)

    def encode(self, inputs, inputs_mask, train=False):
        """(B, T, F) features or (B, T) tokens, (B, T) mask -> encoded (B,
        L, D) (after the top MLP, where there is one), mask.  ``train``
        runs the differentiable scans of the training path."""
        return self._encoded(self.bottom(inputs), inputs_mask, train)

    def _encoded(self, bottom_output, inputs_mask, train):
        encoded, encoded_mask = self.encoder(bottom_output, inputs_mask,
                                             train=train)
        if self.top is not None:
            encoded = self.top(encoded)
        return encoded, encoded_mask

    def cost(self, inputs, inputs_mask, labels, labels_mask, prediction=None,
             prediction_mask=None, train=False, dropout_mask=None):
        """The teacher-forced cost graph (JAX ``RecognizerNet.cost``):
        batch-major (B, T) labels and masks in, the generator's evaluate
        dict (``costs`` (T, B), ``weights``, ``energies``, ``readouts``,
        the mse criteria's aux outputs) plus ``encoded``, ``encoded_mask``
        and ``bottom_output`` out.  ``prediction`` (B, T') and its mask,
        the exploration's outputs, are fed in place of the labels, which
        stay the groundtruth of the mse criteria.  With ``dropout`` and
        ``train``, the bottom's output goes through :func:`bottom_dropout`
        with ``dropout_mask``, a bool tensor of its shape that the caller
        draws (the training step's :func:`regularization_draws`);
        ``bottom_output`` is then the dropped-out one, as in the JAX
        package."""
        bottom_output = self.bottom(inputs)
        if self.dropout and train:
            if dropout_mask is None:
                raise ValueError("a training cost with dropout needs its "
                                 "dropout_mask")
            bottom_output = bottom_dropout(bottom_output, dropout_mask)
        encoded, encoded_mask = self._encoded(bottom_output, inputs_mask,
                                              True)
        fed = prediction if prediction is not None else labels
        fed_mask = (prediction_mask if prediction_mask is not None
                    else labels_mask)
        result = self.generator.evaluate(
            encoded, encoded_mask, fed.T,
            fed_mask.T if fed_mask is not None else None,
            use_pallas=self.use_pallas, groundtruth=labels.T)
        result.update(encoded=encoded, encoded_mask=encoded_mask,
                      bottom_output=bottom_output)
        return result

    def generate(self, inputs, inputs_mask, n_steps, generator=None):
        """Sample ``n_steps`` outputs per utterance (JAX
        ``RecognizerNet.generate``) through the inference encoder and the
        module step; see :meth:`SequenceGenerator.generate`."""
        encoded, encoded_mask = self.encode(inputs, inputs_mask)
        return self.generator.generate(encoded.contiguous(),
                                       encoded_mask.contiguous(), n_steps,
                                       generator)

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
    """Owns the net and its parameters on ``device`` (the card unless the
    caller names another); the public surface the serving code
    (``serve.Transcriber``) uses.

    ``noise`` is the adaptive weight noise's collection when training
    with it (``train/driver.py::init_adaptive_noise_params``), else None:
    ``{'/adaptive_noise/...': log-variance}``, one tensor of each
    parameter's shape under the parameter's path with ``/adaptive_noise``
    in place of ``/recognizer`` (the JAX package's ``noise`` collection
    and checkpoint keys)."""

    def __init__(self, net_config: Mapping[str, Any], *,
                 init_config: Optional[Mapping] = None, seed: int = 1234,
                 device="cuda"):
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
        self.noise = None
        self.init_params(init_config or {}, seed=seed)

    # -- parameters --------------------------------------------------------
    def parameters(self):
        """``{'/recognizer/...': parameter}``, the JAX package's keys."""
        return named_parameters(self.net)

    def init_params(self, init_config, seed=1234):
        load_path_dict(self.net, initialize_params(
            param_shapes(self.net), init_config, seed=seed))

    def optimized(self):
        """``{path: tensor}`` the optimizer updates: the parameters
        (detached) and, with adaptive noise, the log-variances."""
        out = {k: p.detach() for k, p in self.parameters().items()}
        out.update(self.noise or {})
        return out

    def load_params(self, path):
        """Load a checkpoint of either package (tar or npz): the
        ``/recognizer`` keys, and the ``/adaptive_noise`` keys into the
        noise collection when the recognizer has one.  Other keys are
        skipped, as the JAX ``load_params`` skips them."""
        self.load_path_dict(load_parameters(path))

    def load_path_dict(self, path_dict):
        load_path_dict(self.net, {k: v for k, v in path_dict.items()
                                  if k.startswith(PREFIX + "/")})
        if self.noise is not None:
            with torch.no_grad():
                for key, value in path_dict.items():
                    if key.startswith(NOISE_PREFIX + "/"):
                        if key not in self.noise:
                            raise KeyError(f"unexpected noise key {key}")
                        self.noise[key].copy_(torch.as_tensor(value))

    def param_path_dict(self):
        """The checkpoint's path-keyed arrays: the parameters and, with
        adaptive noise, the log-variances."""
        out = param_path_dict(self.net)
        out.update({k: v.detach().cpu().numpy()
                    for k, v in (self.noise or {}).items()})
        return out

    # -- the training cost -------------------------------------------------
    def cost_fn(self):
        """``fn(inputs, inputs_mask, labels, labels_mask)`` -> the cost
        dict of :meth:`RecognizerNet.cost`, differentiable in the
        parameters (which then need ``requires_grad``)."""
        def fn(inputs, inputs_mask, labels, labels_mask, train=False,
               dropout_mask=None):
            return self.net.cost(inputs, inputs_mask, labels, labels_mask,
                                 train=train, dropout_mask=dropout_mask)
        return fn

    def _tensor(self, x, dtype=torch.float32):
        """An array or tensor as a ``dtype`` tensor on the model's
        device."""
        return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                               dtype=dtype, device=self.device)

    def inputs_tensor(self, x):
        """Inputs as the bottom reads them (its ``input_dtype``): int64
        tokens of a lookup bottom, float32 features of the speech
        bottom."""
        return self._tensor(x, self.net.bottom.input_dtype)

    @staticmethod
    def _batched(inputs):
        """One utterance ((T, F) features or (T,) tokens) as a batch of
        one; a batch as it is."""
        return inputs[None] if inputs.ndim == (
            2 if inputs.is_floating_point() else 1) else inputs

    def analyze(self, inputs, inputs_mask, labels, labels_mask):
        """The teacher-forced cost and alignment of batch-major labels
        (JAX ``SpeechRecognizer.analyze``): ``costs`` (T, B), ``weights``
        and ``energies`` (T, B, L; None for content attention, which has
        none) as numpy, through :meth:`RecognizerNet.cost` under
        ``torch.no_grad()``."""
        with torch.no_grad():
            out = self.net.cost(self.inputs_tensor(inputs),
                                self._tensor(inputs_mask),
                                self._tensor(labels, torch.long),
                                self._tensor(labels_mask))
            return {k: out[k].cpu().numpy() if out[k] is not None else None
                    for k in ("costs", "weights", "energies")}

    def sample(self, inputs, inputs_mask=None, n_steps=None, generator=None):
        """Sample from the model (JAX ``SpeechRecognizer.sample``): one
        (T, F) utterance or a (B, T, F) batch (a lookup bottom's: (T,) or
        (B, T) tokens); ``n_steps`` defaults to T
        divided by ``max_decoded_length_scale``, ``generator`` to a
        ``torch.Generator`` on the model's device seeded with 0.  Returns
        ``outputs``, ``costs``, ``weights`` and ``readouts`` as numpy,
        time-major (n_steps, B, ...)."""
        inputs = self._batched(self.inputs_tensor(inputs))
        mask = (torch.ones(inputs.shape[:2], device=self.device)
                if inputs_mask is None else self._tensor(inputs_mask))
        if n_steps is None:
            n_steps = int(inputs.shape[1] / self.max_decoded_length_scale)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        with torch.no_grad():
            out = self.net.generate(inputs, mask, n_steps, generator)
            return {k: v.cpu().numpy() for k, v in out.items()}

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
        """Decode one (T, F) utterance or a (B, T, F) batch (a lookup
        bottom's: (T,) or (B, T) tokens).

        Time is zero-padded to a multiple of ``pad_frames_multiple`` and
        the batch to a multiple of ``pad_batch_multiple`` (a single
        utterance stays single) with zero mask, like the JAX package; the
        decode-length cap comes from the unpadded T."""
        self.init_beam_search(self.beam_size or 10)
        inputs = self._batched(self.inputs_tensor(inputs))
        mask = (torch.ones(inputs.shape[:2], device=self.device)
                if inputs_mask is None else self._tensor(inputs_mask))
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
