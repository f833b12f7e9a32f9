"""attention_lvcsr_torch — the PyTorch/CUDA port of attention_lvcsr_tpu.

The JAX package beside it stays the reference; this package imports
``torch`` and never ``jax`` or ``flax``.  It serves, decodes and trains
the recognizer (speech bottom -> BiGRU or BiLSTM encoder -> conv-attention
GRU decoder) on one NVIDIA H100, with every TPU kernel of the JAX package
rewritten by hand for Hopper in ``csrc/``:

* ``ops/gru_scan.py``, ``ops/gru_train.py``, ``ops/lstm_scan.py``,
  ``ops/lstm_train.py`` — the encoder's scans, inference and training;
* ``ops/beam_loop.py`` — the whole beam decode loop;
* ``ops/attention_energy.py``, ``ops/decode_score.py`` — the steps of the
  module-driven decode (LM fusion, constraints);
* ``ops/decoder_train.py`` — the teacher-forced decoder of training;
* ``ops/frontend.py`` — log-mel fbank + deltas for waveform requests;
* ``ops/outer_sum.py`` — the training scans' weight gradients.

Each kernel has a plain PyTorch version beside it, taken only for tensors
that lie on the CPU; a CUDA tensor launches the kernel or raises.
``_build.py`` compiles ``csrc/*.cu`` with ``nvcc`` at first use.

Layer map (same names as the JAX package):

* ``models``  — initializers, parameter bridge, cells, bottom, encoder,
                attention, generator, LM, recognizer.
* ``ops``     — the kernels' wrappers, FSTs and the decoding-graph
                builder, conv1d, edit distance.
* ``search``  — ``BeamSearch``: the whole-loop kernel or the module loop.
* ``data``    — datasets, pipeline, the feature frontend.
* ``train``   — the train step, rule chain, loop, checkpoints.
* ``serve``   — the HTTP endpoint of the JAX package, over this recognizer.
* ``cli``     — ``run.py`` (train, search, serve, ...) and the recipes'
                tools: ``lm_tools``, ``kaldi2hdf``, ``score``,
                ``edit_params``, ``print_config``, ``make_toy_dataset``.
"""

__version__ = "0.1.0"
