"""attention_lvcsr_torch — the PyTorch/CUDA port of attention_lvcsr_tpu.

The JAX package beside it stays the reference; this package imports
``torch`` and never ``jax`` or ``flax``.  It runs the flagship serving
decode (speech bottom -> BiGRU encoder -> beam search with a conv-attention
GRU decoder) on one NVIDIA H100, with the two TPU kernels of that path
rewritten by hand for Hopper:

* ``ops/gru_scan.py`` + ``csrc/gru_scan.cu`` — the encoder's GRU scan;
* ``ops/beam_loop.py`` + ``csrc/beam_loop.cu`` — the whole beam decode loop.

Each kernel has a plain PyTorch version beside it, taken only for tensors
that lie on the CPU; a CUDA tensor launches the kernel or raises.
``_build.py`` compiles ``csrc/*.cu`` with ``nvcc`` at first use.

Layer map (same names as the JAX package):

* ``models``  — initializers, parameter bridge, cells, bottom, encoder,
                attention, generator, recognizer.
* ``ops``     — the two kernels' wrappers, conv1d, edit distance.
* ``search``  — ``BeamSearch`` over the whole-loop decode kernel.
* ``serve``   — the HTTP endpoint of the JAX package, over this recognizer.
* ``cli``     — ``run.py serve``.
"""

__version__ = "0.1.0"
