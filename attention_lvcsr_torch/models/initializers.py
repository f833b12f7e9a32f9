"""Numpy initialization schemes and config-driven parameter init.

The port's copy of ``attention_lvcsr_tpu/models/initializers.py`` plus
``initialize_params`` (``models/recognizer.py:278-349``): importing the
JAX package's ``models`` pulls in flax, so the port carries these.  Every
parameter path is seeded with ``crc32(path)`` exactly as the JAX side
does, so the same config and seed give bit-identical parameters.
"""
from __future__ import annotations

import zlib
from typing import Dict, Mapping, Tuple

import numpy as np


class NdarrayInitialization:
    """Base class: generate a numpy array of a given shape."""

    def generate(self, rng: np.random.RandomState, shape):
        raise NotImplementedError

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in sorted(self.__dict__.items()))
        return f"{type(self).__name__}({args})"

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__


class Constant(NdarrayInitialization):
    def __init__(self, constant=0.0):
        self.constant = constant

    def generate(self, rng, shape):
        return np.full(shape, self.constant, dtype=np.float32)


class IsotropicGaussian(NdarrayInitialization):
    def __init__(self, std=1.0, mean=0.0):
        self.std = std
        self.mean = mean

    def generate(self, rng, shape):
        return rng.normal(self.mean, self.std, size=shape).astype(np.float32)


class Uniform(NdarrayInitialization):
    def __init__(self, mean=0.0, width=None, std=None):
        if (width is None) == (std is None):
            raise ValueError("provide exactly one of width or std")
        self.mean = mean
        self.width = width
        self.std = std

    def generate(self, rng, shape):
        w = self.width if self.width is not None else np.sqrt(12) * self.std
        return rng.uniform(self.mean - w / 2, self.mean + w / 2,
                           size=shape).astype(np.float32)


class Orthogonal(NdarrayInitialization):
    """Orthogonal init for square (or stacked-square) recurrent matrices."""

    def __init__(self, scale=1.0):
        self.scale = scale

    def generate(self, rng, shape):
        if len(shape) != 2:
            raise ValueError("orthogonal init needs a 2D shape")
        rows, cols = shape
        if cols % rows == 0:
            # e.g. state_to_gates (dim, 2*dim): independent orthogonal blocks
            blocks = []
            for _ in range(cols // rows):
                q, r = np.linalg.qr(rng.randn(rows, rows))
                blocks.append(q * np.sign(np.diag(r)))
            w = np.concatenate(blocks, axis=1)
        else:
            u, _, vt = np.linalg.svd(rng.randn(rows, cols),
                                     full_matrices=False)
            w = u if u.shape == shape else vt
        return (self.scale * w).astype(np.float32)


class Identity(NdarrayInitialization):
    def __init__(self, mult=1.0):
        self.mult = mult

    def generate(self, rng, shape):
        rows, cols = shape
        return (self.mult * np.eye(rows, cols)).astype(np.float32)


class Sparse(NdarrayInitialization):
    """Sparse init: a fraction of entries drawn from `weights_init`, rest 0."""

    def __init__(self, proportion=0.1, weights_init=None):
        self.proportion = proportion
        self.weights_init = weights_init or IsotropicGaussian(1.0)

    def generate(self, rng, shape):
        weights = np.zeros(shape, dtype=np.float32)
        flat = weights.reshape(-1)
        num = int(round(flat.size * self.proportion))
        idx = rng.choice(flat.size, num, replace=False)
        flat[idx] = self.weights_init.generate(rng, (num,))
        return weights


REGISTRY = {
    "constant": Constant, "isotropic_gaussian": IsotropicGaussian,
    "gaussian": IsotropicGaussian, "uniform": Uniform,
    "orthogonal": Orthogonal, "identity": Identity, "sparse": Sparse,
    # class-name aliases so reference YAML tags resolve
    "Constant": Constant, "IsotropicGaussian": IsotropicGaussian,
    "Uniform": Uniform, "Orthogonal": Orthogonal, "Identity": Identity,
    "Sparse": Sparse,
}


def get_initializer(spec):
    """Resolve an initializer from an instance, name, or (name, args) spec."""
    if isinstance(spec, NdarrayInitialization):
        return spec
    if isinstance(spec, str):
        return REGISTRY[spec]()
    if isinstance(spec, (list, tuple)) and spec and isinstance(spec[0], str):
        return REGISTRY[spec[0]](*spec[1:])
    if isinstance(spec, dict) and "type" in spec:
        kwargs = {k: v for k, v in spec.items() if k != "type"}
        return REGISTRY[spec["type"]](**kwargs)
    raise ValueError(f"cannot interpret initializer spec: {spec!r}")


_RECURRENT_NAMES = {"state_to_state", "state_to_gates", "W", "W_state"}
_BIAS_NAMES = {"bias", "merge_bias"}
_INITIAL_STATE_NAMES = {"initial_state", "initial_cells"}
_CATEGORY_KEYS = {
    "weight": ("weights_init",),
    "recurrent_weight": ("rec_weights_init", "weights_init"),
    "bias": ("biases_init",),
    "initial_state": ("initial_states_init",),
}
_CATEGORY_DEFAULTS = {
    "bias": Constant(0.0),
    "initial_state": Constant(0.0),
}


def classify_param(path: Tuple[str, ...]) -> str:
    leaf = path[-1]
    if leaf in _INITIAL_STATE_NAMES:
        return "initial_state"
    if leaf in _BIAS_NAMES:
        return "bias"
    if leaf in _RECURRENT_NAMES and any("cell" in p or "transition" in p
                                        for p in path):
        return "recurrent_weight"
    return "weight"


def initialize_params(shapes: Mapping[str, Tuple[int, ...]],
                      init_config: Mapping[str, Mapping],
                      seed: int = 1234) -> Dict[str, np.ndarray]:
    """``{'/recognizer/...': shape}`` -> ``{'/recognizer/...': array}``.

    ``init_config`` maps brick-style paths to scheme dicts
    (``weights_init``/``biases_init``/``rec_weights_init``/
    ``initial_states_init``); the deepest matching path wins."""
    init_config = {k.rstrip("/"): dict(v)
                   for k, v in (init_config or {}).items()}
    out = {}
    for full, shape in shapes.items():
        path = tuple(full.split("/")[2:])          # drop '', 'recognizer'
        category = classify_param(path)
        chosen, chosen_depth = None, -1
        for cfg_path, schemes in init_config.items():
            if not (full == cfg_path or full.startswith(cfg_path + "/")):
                continue
            for key in _CATEGORY_KEYS[category]:
                if key in schemes and cfg_path.count("/") > chosen_depth:
                    chosen = schemes[key]
                    chosen_depth = cfg_path.count("/")
                    break
        if chosen is None:
            chosen = _CATEGORY_DEFAULTS.get(category, IsotropicGaussian(0.1))
        initializer = get_initializer(chosen)
        shape = tuple(shape)
        if isinstance(initializer, Orthogonal) and len(shape) != 2:
            initializer = IsotropicGaussian(0.1)
        rng = np.random.RandomState(
            (seed + zlib.crc32(full.encode())) % (2 ** 31 - 1))
        out[full] = initializer.generate(rng, shape)
    return out
