"""Checkpoints: the JAX package's tar format, written by the port.

Counterpart of ``attention_lvcsr_tpu/train/checkpoint.py``: a tar file
(``.zip`` suffix kept) whose ``_parameters.npz`` member holds the
path-keyed parameters (``/recognizer/...``), so the JAX package's
``load_parameters`` reads a checkpoint the port trained; the log and the
metadata are the same members (``_log.pkl``, ``_meta.json``).  The
optimizer state goes in a member of the port's own,
``_torch_opt_state.npz``, flattened by ``train/rules.py::state_arrays``
(the adaptive noise's log-variances under their ``/adaptive_noise`` keys
beside the parameters').
A checkpoint the JAX package wrote holds its optax state in
``_opt_state.pkl`` instead, which is read with the port's stand-ins for
the optax state types (:class:`OptaxStateUnpickler`), importing neither
``jax``, ``optax`` nor the JAX package, and flattened to the port's keys
(:func:`optax_state_arrays`).  Writes go to a temporary file that is
renamed into place.  ``load_parameters`` (the parameters of a checkpoint
or of a raw npz) is :mod:`attention_lvcsr_torch.models.params`'s, and is
read from here as from the JAX package's module (``cli/edit_params.py``).
"""
from __future__ import annotations

import io
import json
import os
import pickle
import tarfile
import tempfile
from collections import namedtuple
from typing import Any, Dict, Mapping, Optional

import numpy as np

from attention_lvcsr_torch.models.params import (NOISE_PREFIX,
                                                 PARAMETERS_MEMBER, PREFIX,
                                                 load_parameters)

OPT_STATE_MEMBER = "_torch_opt_state.npz"
JAX_OPT_STATE_MEMBER = "_opt_state.pkl"
LOG_MEMBER = "_log.pkl"
META_MEMBER = "_meta.json"


def _npz_bytes(arrays: Mapping[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def secure_write(path: str, writer):
    """Write through a temporary file and an atomic rename."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            writer(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(path: str, parameters: Mapping[str, np.ndarray],
                    opt_state: Optional[Mapping[str, np.ndarray]] = None,
                    log_state: Any = None, meta: Optional[Dict] = None):
    """Write the tar checkpoint; ``opt_state`` is the flattened state."""

    def writer(f):
        with tarfile.open(fileobj=f, mode="w") as tar:
            def add(name, data: bytes):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))

            add(PARAMETERS_MEMBER, _npz_bytes(parameters))
            if opt_state is not None:
                add(OPT_STATE_MEMBER, _npz_bytes(opt_state))
            if log_state is not None:
                add(LOG_MEMBER, pickle.dumps(log_state, protocol=4))
            add(META_MEMBER, json.dumps(meta or {}).encode())

    secure_write(path, writer)


def save_parameters(path: str, parameters: Mapping[str, np.ndarray]):
    """The path-keyed parameters alone, as an npz (the JAX package's
    ``<root>_params.npz``)."""
    secure_write(path, lambda f: f.write(_npz_bytes(parameters)))


def _member(path, name):
    with tarfile.open(path, "r") as tar:
        try:
            f = tar.extractfile(name)
        except KeyError:
            return None
        return f.read() if f is not None else None


# The state types of the JAX package's rule chain, by class name (optax's
# and its ``train/rules.py``'s NamedTuples), with their fields in order
# (pickle rebuilds a NamedTuple from its values by position): each field
# is the port's state key of the same name.
OPTAX_STATES = {
    name: namedtuple(name, fields) for name, fields in (
        ("EmptyState", ()),
        ("TraceState", ("trace",)),
        ("ScaleByAdaDeltaState", ("e_g", "e_x")),
        ("ScaleByRmsState", ("nu",)),
        ("ScaleByAdamState", ("count", "mu", "nu")),
        ("ScaleByRssState", ("sum_of_squares",)),
        ("ScaleByScheduleState", ("count",)),
        ("BurnInState", ("count",)))}


class OptaxStateUnpickler(pickle.Unpickler):
    """Reads the JAX package's pickled optax state: its state types by
    class name as :data:`OPTAX_STATES` and numpy's arrays (dicts and
    tuples need no class).  Any other class raises
    ``NotImplementedError`` naming it."""

    _NUMPY = ("_reconstruct", "ndarray", "dtype", "scalar")

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in ("optax", "attention_lvcsr_tpu") and name in OPTAX_STATES:
            return OPTAX_STATES[name]
        if root == "numpy" and name in self._NUMPY:
            return super().find_class(module, name)
        raise NotImplementedError(
            f"optimizer state type {module}.{name} is not ported: the "
            f"checkpoint's optimizer state cannot be read")


def _rule_states(node):
    """The rule states of a (nested) optax chain state, in order."""
    if type(node) in OPTAX_STATES.values():
        return [node]
    if isinstance(node, (tuple, list)):
        return [s for child in node for s in _rule_states(child)]
    raise TypeError(f"not an optax chain state: {type(node).__name__}")


def _path_arrays(tree, prefix):
    """``{prefix + '/a/b/leaf': array}`` of a nested dict of arrays."""
    if isinstance(tree, Mapping):
        out = {}
        for key, value in tree.items():
            out.update(_path_arrays(value, f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree)}


# the JAX package's trained collections and their checkpoint prefixes
_COLLECTIONS = {"params": PREFIX, "noise": NOISE_PREFIX}


def optax_state_arrays(state) -> Dict[str, np.ndarray]:
    """The flat arrays of ``rules.state_arrays`` of a JAX-package optax
    state (read with :data:`OPTAX_STATES`): the i-th rule state of the
    chain, flattened, is the i-th rule of the port's chain, and its field
    ``f`` of the parameter collection ``params`` becomes
    ``i/f/recognizer/...`` (the parameters' own path keys), of the
    adaptive noise's ``noise`` ``i/f/adaptive_noise/...``."""
    out = {}
    for i, rule in enumerate(_rule_states(state)):
        for field, value in rule._asdict().items():
            if isinstance(value, Mapping):
                if not {"params"} <= set(value) <= set(_COLLECTIONS):
                    raise NotImplementedError(
                        f"optimizer state of the parameter collections "
                        f"{sorted(value)}: the port trains 'params' and "
                        f"'noise'")
                for name, tree in value.items():
                    out.update(_path_arrays(
                        tree, f"{i}/{field}{_COLLECTIONS[name]}"))
            else:
                out[f"{i}/{field}"] = np.asarray(value)
    return out


def load_checkpoint(path: str) -> Dict[str, Any]:
    """``parameters``, ``opt_state`` (flattened as by
    ``rules.state_arrays``, from either package's member, or None),
    ``log_state`` and ``meta`` of a checkpoint tar (or parameters alone
    from an npz)."""
    out: Dict[str, Any] = {"parameters": load_parameters(path),
                           "opt_state": None, "log_state": None, "meta": {}}
    if tarfile.is_tarfile(path):
        opt = _member(path, OPT_STATE_MEMBER)
        if opt is not None:
            with np.load(io.BytesIO(opt)) as npz:
                out["opt_state"] = {k: npz[k] for k in npz.files}
        else:
            opt = _member(path, JAX_OPT_STATE_MEMBER)
            if opt is not None:
                out["opt_state"] = optax_state_arrays(
                    OptaxStateUnpickler(io.BytesIO(opt)).load())
        log = _member(path, LOG_MEMBER)
        out["log_state"] = pickle.loads(log) if log else None
        meta = _member(path, META_MEMBER)
        out["meta"] = json.loads(meta) if meta else {}
    return out
