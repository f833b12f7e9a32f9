"""The weight bridge: JAX package checkpoints <-> the port's modules.

Parameters are keyed as the JAX package keys them
(``models/recognizer.py:355-386``): ``/recognizer/<module path>/<leaf>``.
A torch parameter name maps onto that key by replacing dots with slashes;
three module names differ only because PyTorch reserves them
(``forward``/``backward`` are ``nn.Module`` methods, ``preprocess`` is the
attention's method), listed in ``_JAX_NAMES``.

Checkpoints are the JAX package's tar files (``train/checkpoint.py``):
the ``_parameters.npz`` member, read here with ``tarfile`` and numpy
only, because the JAX package's reader imports ``jax`` at the top.
"""
from __future__ import annotations

import io
import tarfile
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

PREFIX = "/recognizer"
PARAMETERS_MEMBER = "_parameters.npz"
# torch module name -> JAX module name
_JAX_NAMES = {"fwd": "forward", "bwd": "backward",
              "preprocessor": "preprocess"}


def jax_path(name: str) -> str:
    """'encoder.bidir0.fwd.cell.state_to_state' ->
    '/recognizer/encoder/bidir0/forward/cell/state_to_state'."""
    return PREFIX + "/" + "/".join(_JAX_NAMES.get(p, p)
                                   for p in name.split("."))


def named_parameters(module: nn.Module) -> Dict[str, nn.Parameter]:
    """``{'/recognizer/...': parameter}`` in the module's order."""
    return {jax_path(n): p for n, p in module.named_parameters()}


def param_shapes(module: nn.Module) -> Dict[str, tuple]:
    return {jax_path(n): tuple(p.shape) for n, p in module.named_parameters()}


def param_path_dict(module: nn.Module) -> Dict[str, np.ndarray]:
    return {jax_path(n): p.detach().cpu().numpy()
            for n, p in module.named_parameters()}


def load_path_dict(module: nn.Module, path_dict: Mapping[str, np.ndarray]):
    """Copy ``{'/recognizer/...': array}`` into the module's parameters.
    Raises KeyError on a missing or unexpected key, ValueError on a shape
    mismatch."""
    params = {jax_path(n): p for n, p in module.named_parameters()}
    missing = sorted(set(params) - set(path_dict))
    unexpected = sorted(set(path_dict) - set(params))
    if missing or unexpected:
        raise KeyError(f"parameter keys differ: missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for key, p in params.items():
            value = np.asarray(path_dict[key])
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{key}: checkpoint shape {value.shape}, "
                                 f"model shape {tuple(p.shape)}")
            p.copy_(torch.tensor(value, dtype=p.dtype))


def load_parameters(path: str) -> Dict[str, np.ndarray]:
    """The path-keyed parameter dict of a checkpoint tar or a raw npz."""
    if tarfile.is_tarfile(path):
        with tarfile.open(path, "r") as tar:
            try:
                member = tar.extractfile(PARAMETERS_MEMBER)
            except KeyError:
                member = None
            if member is None:
                raise KeyError(f"{path} has no {PARAMETERS_MEMBER}")
            data = member.read()
        with np.load(io.BytesIO(data)) as npz:
            return {k: npz[k] for k in npz.files}
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}
