"""The PyTorch port imports no JAX, and never falls back silently: a
tensor on a device without a kernel raises, so does a missing compiler,
and so do configurations the port does not cover yet."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from attention_lvcsr_torch import _build
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops.beam_loop import beam_search_loop
from attention_lvcsr_torch.ops.decoder_train import decoder_scan_train
from attention_lvcsr_torch.ops.frontend import fbank_deltas
from attention_lvcsr_torch.ops.gru_scan import gru_scan
from attention_lvcsr_torch.ops.gru_train import gru_scan_train
from attention_lvcsr_torch.ops.lstm_scan import lstm_scan
from attention_lvcsr_torch.ops.lstm_train import lstm_scan_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "attention_lvcsr_torch", "attention_lvcsr_torch._build",
    "attention_lvcsr_torch.models.initializers",
    "attention_lvcsr_torch.models.params",
    "attention_lvcsr_torch.models.layers",
    "attention_lvcsr_torch.models.cells",
    "attention_lvcsr_torch.models.bottom",
    "attention_lvcsr_torch.models.encoder",
    "attention_lvcsr_torch.models.attention",
    "attention_lvcsr_torch.models.generator",
    "attention_lvcsr_torch.models.lm",
    "attention_lvcsr_torch.models.recognizer",
    "attention_lvcsr_torch.ops.gru_scan",
    "attention_lvcsr_torch.ops.beam_loop",
    "attention_lvcsr_torch.ops.attention_energy",
    "attention_lvcsr_torch.ops.decode_score",
    "attention_lvcsr_torch.ops.fst",
    "attention_lvcsr_torch.ops.fst_algo",
    "attention_lvcsr_torch.ops.lm_graph",
    "attention_lvcsr_torch.ops.expressions",
    "attention_lvcsr_torch.ops.error_rate",
    "attention_lvcsr_torch.ops.gru_train",
    "attention_lvcsr_torch.ops.decoder_train",
    "attention_lvcsr_torch.ops.outer_sum",
    "attention_lvcsr_torch.ops.lstm_scan",
    "attention_lvcsr_torch.ops.lstm_train",
    "attention_lvcsr_torch.ops.frontend",
    "attention_lvcsr_torch.data.features",
    "attention_lvcsr_torch.search.beam",
    "attention_lvcsr_torch.serve",
    "attention_lvcsr_torch.config",
    "attention_lvcsr_torch.data",
    "attention_lvcsr_torch.train.rules",
    "attention_lvcsr_torch.train.checkpoint",
    "attention_lvcsr_torch.train.log",
    "attention_lvcsr_torch.train.loop",
    "attention_lvcsr_torch.train.monitoring",
    "attention_lvcsr_torch.train.driver",
    "attention_lvcsr_torch.utils.plots",
    "attention_lvcsr_torch.cli.run",
    "attention_lvcsr_torch.cli.lm_tools",
    "attention_lvcsr_torch.cli.kaldi2hdf",
    "attention_lvcsr_torch.cli.score",
    "attention_lvcsr_torch.cli.edit_params",
    "attention_lvcsr_torch.cli.print_config",
    "attention_lvcsr_torch.cli.make_toy_dataset",
    "attention_lvcsr_torch.cli.quality_proxy",
    "attention_lvcsr_torch.data.h5",
    "attention_lvcsr_torch.train.extensions",
    "attention_lvcsr_torch.data.server",
    "attention_lvcsr_torch.ops.native",
    "attention_lvcsr_torch.utils.notebook",
]
BANNED_ROOTS = ("attention_lvcsr_tpu", "jax", "jaxlib", "flax")

TINY = dict(
    input_dims={"recordings": 5}, input_num_chars={}, eos_label=3,
    num_phonemes=4, dim_dec=6, dims_bidir=[4], enc_transition="gru",
    dec_transition="gru", attention_type="content_and_conv", conv_n=1,
    criterion={"name": "log_likelihood"},
    bottom={"bottom_class": "speech"}, subsample=[1],
    post_merge_dims=[6], data_prepend_eos=False)


def _imports_leave_out(modules, banned):
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              f"{tuple(banned)!r})\n"
              "print('BAD', bad)\n"
              "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_imports_no_jax_yaml_or_h5py():
    _imports_leave_out(MODULES, ("jax", "jaxlib", "flax", "yaml", "h5py"))


def test_port_imports_nothing_of_the_jax_package():
    """Serving on the card loads the port alone: its modules import no
    module of ``attention_lvcsr_tpu`` (the CLI loads its config and data
    readers only when it runs)."""
    _imports_leave_out(MODULES, ("attention_lvcsr_tpu",))


def test_cli_path_imports_no_jax():
    """``run.py train`` and ``serve`` read configs and datasets with the
    port's own ``config`` and ``data`` modules: run, they load no JAX and
    nothing of the JAX package either."""
    code = ("import sys\n"
            "from attention_lvcsr_torch.config import Configuration\n"
            "from attention_lvcsr_torch.data import Data\n"
            "Configuration('tests/configs/toy.yaml')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{BANNED_ROOTS!r})\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _package_sources():
    pkg = os.path.join(ROOT, "attention_lvcsr_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, name), ROOT)


@pytest.mark.parametrize("source", sorted(_package_sources()) + [
    "chip_smoke.py"])
def test_no_module_imports_jax_or_the_jax_package(source):
    """Every module of the port, the CLI and the server included, and the
    on-card smoke test: no ``import`` or ``from`` of ``jax``, ``flax`` or
    ``attention_lvcsr_tpu`` anywhere in the file, at any depth (docstrings
    that name the JAX package's paths are text, not imports)."""
    with open(os.path.join(ROOT, source)) as f:
        tree = ast.parse(f.read(), source)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        found += [f"{source}:{node.lineno} {n}" for n in names
                  if n.split(".")[0] in BANNED_ROOTS]
    assert not found, found


def test_the_import_walk_covers_the_cli_and_the_server():
    sources = set(_package_sources())
    assert {os.path.join("attention_lvcsr_torch", "cli", "run.py"),
            os.path.join("attention_lvcsr_torch", "serve.py")} <= sources


def test_wrappers_raise_on_a_device_without_kernel():
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        gru_scan(meta(3, 2, 12), None, (meta(2, 4), meta(4, 4), meta(4, 8)))
    with pytest.raises(ValueError, match="no kernel"):
        gru_scan_train(meta(3, 2, 12), None,
                       (meta(2, 4), meta(4, 4), meta(4, 8)))
    with pytest.raises(ValueError, match="no kernel"):
        decoder_scan_train(*[meta(1)] * 17, prior={})
    with pytest.raises(ValueError, match="no kernel"):
        beam_search_loop(meta(2, 5, 3), meta(2, 5, 4), meta(2, 5), {},
                         beam=2, max_len=3, eol=0)
    lstm = (meta(2, 4), meta(2, 4), meta(4, 16), meta(4), meta(4), meta(4))
    with pytest.raises(ValueError, match="no kernel"):
        lstm_scan(meta(3, 2, 16), None, lstm)
    with pytest.raises(ValueError, match="no kernel"):
        lstm_scan_train(meta(3, 2, 16), None, lstm)
    with pytest.raises(ValueError, match="no kernel"):
        fbank_deltas(meta(2, 800))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_cuda_recognizer_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        SpeechRecognizer(TINY, device="cuda")


def test_recognizer_defaults_to_the_card():
    """A caller who names no device gets the card: without one it raises,
    never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        SpeechRecognizer(TINY)


@pytest.mark.parametrize("override,piece", [
    ({"energy_normalizer": "softplus"}, "normalizer"),
    ({"attention_type": "hybrid"}, "attention_type"),
    ({"criterion": {"name": "hinge"}}, "criterion"),
    ({"energy_normalizer": "softplus", "lm": {"path": "x.fst"}},
     "normalizer"),
])
def test_unported_variants_raise(override, piece):
    with pytest.raises(NotImplementedError, match=piece):
        SpeechRecognizer(dict(TINY, **override), device="cpu")


def test_unported_search_options_raise():
    """bf16 decoding raises on both routes: the loop kernel's and the
    module-driven decode a validator takes."""
    x = np.zeros((4, 5), np.float32)
    rec = SpeechRecognizer(dict(TINY, compute_dtype="bfloat16"),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="float32"):
        rec.beam_search(x, as_arrays=True)
    with pytest.raises(NotImplementedError, match="float32"):
        rec.beam_search(x, validate_solution_function=lambda *a: True)
    with pytest.raises(TypeError, match="DecodeConstraint"):
        SpeechRecognizer(TINY, device="cpu").beam_search(
            x, validate_solution_function=3)
