"""Checkpoints: the JAX package's tar format, written by the port.

Counterpart of ``attention_lvcsr_tpu/train/checkpoint.py``: a tar file
(``.zip`` suffix kept) whose ``_parameters.npz`` member holds the
path-keyed parameters (``/recognizer/...``), so the JAX package's
``load_parameters`` reads a checkpoint the port trained; the log and the
metadata are the same members (``_log.pkl``, ``_meta.json``).  The
optimizer state goes in a member of the port's own,
``_torch_opt_state.npz``, flattened by ``train/rules.py::state_arrays``.
Writes go to a temporary file that is renamed into place.
"""
from __future__ import annotations

import io
import json
import os
import pickle
import tarfile
import tempfile
from typing import Any, Dict, Mapping, Optional

import numpy as np

from attention_lvcsr_torch.models.params import (PARAMETERS_MEMBER,
                                                 load_parameters)

OPT_STATE_MEMBER = "_torch_opt_state.npz"
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


def _member(path, name):
    with tarfile.open(path, "r") as tar:
        try:
            f = tar.extractfile(name)
        except KeyError:
            return None
        return f.read() if f is not None else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """``parameters``, ``opt_state`` (flattened, or None), ``log_state``
    and ``meta`` of a checkpoint tar (or parameters alone from an npz)."""
    out: Dict[str, Any] = {"parameters": load_parameters(path),
                           "opt_state": None, "log_state": None, "meta": {}}
    if tarfile.is_tarfile(path):
        opt = _member(path, OPT_STATE_MEMBER)
        if opt is not None:
            with np.load(io.BytesIO(opt)) as npz:
                out["opt_state"] = {k: npz[k] for k in npz.files}
        log = _member(path, LOG_MEMBER)
        out["log_state"] = pickle.loads(log) if log else None
        meta = _member(path, META_MEMBER)
        out["meta"] = json.loads(meta) if meta else {}
    return out
