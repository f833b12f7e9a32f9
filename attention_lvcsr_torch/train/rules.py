"""Step rules of the training update, with optax's arithmetic.

Counterpart of ``attention_lvcsr_tpu/train/rules.py``: the same rules,
assembled by :func:`build_optimizer` from the same config keys in the same
order (clipping -> core rules -> scale schedule -> max-norm ->
RemoveNotFinite -> burn-in).  Each rule is a plain PyTorch update with the
optax transformation's arithmetic (``clip_by_global_norm``, ``trace``,
``scale_by_adadelta``, ``scale_by_rms``, ``scale_by_adam``,
``scale_by_rss``, ``scale_by_schedule``, ``scale``).

Parameters, gradients and updates are dicts ``{path: tensor}``; a rule's
``init(params)`` returns its state, a dict of tensors and of such dicts,
and ``update(updates, state, params)`` returns ``(updates, state)``.
Updates are added to the parameters (optax's sign convention).  The state
flattens to and from numpy arrays (:func:`state_arrays`,
:func:`load_state_arrays`), which is how checkpoints store it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

_WEIGHT_LEAVES = ("kernel", "embedding", "state_to_state", "state_to_gates",
                  "W", "W_state")


def global_norm(tree: Mapping[str, torch.Tensor]):
    return torch.sqrt(sum((x * x).sum() for x in tree.values()))


def _zeros(params):
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _count(params):
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


class Rule:
    """A gradient transformation without state."""

    def init(self, params):
        return {}

    def update(self, updates, state, params=None):
        raise NotImplementedError


class Scale(Rule):
    def __init__(self, step_size):
        self.step_size = step_size

    def update(self, updates, state, params=None):
        return {k: self.step_size * g for k, g in updates.items()}, state


class ClipByGlobalNorm(Rule):
    """Blocks StepClipping: rescale to ``max_norm`` above it."""

    def __init__(self, max_norm):
        self.max_norm = max_norm

    def update(self, updates, state, params=None):
        norm = global_norm(updates)
        keep = norm < self.max_norm
        return {k: torch.where(keep, g, (g / norm) * self.max_norm)
                for k, g in updates.items()}, state


class Trace(Rule):
    """``trace = g + decay * trace``; the update is the trace."""

    def __init__(self, decay):
        self.decay = decay

    def init(self, params):
        return {"trace": _zeros(params)}

    def update(self, updates, state, params=None):
        new = {k: g + self.decay * state["trace"][k]
               for k, g in updates.items()}
        return new, {"trace": new}


class ScaleByAdadelta(Rule):
    def __init__(self, rho, eps):
        self.rho, self.eps = rho, eps

    def init(self, params):
        return {"e_g": _zeros(params), "e_x": _zeros(params)}

    def update(self, updates, state, params=None):
        rho, eps = self.rho, self.eps
        e_g = {k: (1 - rho) * g ** 2 + rho * state["e_g"][k]
               for k, g in updates.items()}
        out = {k: torch.sqrt(state["e_x"][k] + eps)
               / torch.sqrt(e_g[k] + eps) * g for k, g in updates.items()}
        e_x = {k: (1 - rho) * u ** 2 + rho * state["e_x"][k]
               for k, u in out.items()}
        return out, {"e_g": e_g, "e_x": e_x}


class ScaleByRms(Rule):
    def __init__(self, decay, eps):
        self.decay, self.eps = decay, eps

    def init(self, params):
        return {"nu": _zeros(params)}

    def update(self, updates, state, params=None):
        nu = {k: (1 - self.decay) * g ** 2 + self.decay * state["nu"][k]
              for k, g in updates.items()}
        return ({k: torch.rsqrt(nu[k] + self.eps) * g
                 for k, g in updates.items()}, {"nu": nu})


class ScaleByAdam(Rule):
    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": _count(params), "mu": _zeros(params),
                "nu": _zeros(params)}

    def update(self, updates, state, params=None):
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state["mu"][k]
              for k, g in updates.items()}
        nu = {k: (1 - b2) * g ** 2 + b2 * state["nu"][k]
              for k, g in updates.items()}
        count = state["count"] + 1
        # 1 - decay**count in float32, as optax computes it
        c1 = 1 - torch.tensor(b1, dtype=torch.float32,
                              device=count.device) ** count
        c2 = 1 - torch.tensor(b2, dtype=torch.float32,
                              device=count.device) ** count
        out = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
               for k in updates}
        return out, {"count": count, "mu": mu, "nu": nu}


class ScaleByRss(Rule):
    """Adagrad: the root of the running sum of squares."""

    def __init__(self, eps):
        self.eps = eps

    def init(self, params):
        return {"sum_of_squares": _zeros(params)}

    def update(self, updates, state, params=None):
        sos = {k: g * g + state["sum_of_squares"][k]
               for k, g in updates.items()}
        out = {k: torch.where(sos[k] > 0, torch.rsqrt(sos[k] + self.eps),
                              torch.zeros_like(g)) * g
               for k, g in updates.items()}
        return out, {"sum_of_squares": sos}


class ScaleSchedule(Rule):
    """``[[step, factor], ...]``: the factor of the last boundary passed
    (optax ``piecewise_constant_schedule`` of the chained ratios)."""

    def __init__(self, entries):
        entries = sorted((int(s), float(f)) for s, f in entries)
        if len({s for s, _ in entries}) != len(entries):
            raise ValueError(f"scale_schedule has duplicate step values: "
                             f"{entries}")
        prev = [1.0] + [f for _, f in entries[:-1]]
        self.boundaries = [(s, f / p) for (s, f), p in zip(entries, prev)]

    def init(self, params):
        return {"count": _count(params)}

    def update(self, updates, state, params=None):
        count = state["count"].to(torch.float32)
        v = torch.ones((), dtype=torch.float32, device=count.device)
        for threshold, scale in self.boundaries:
            indicator = torch.clamp(torch.sign(threshold - count), min=0.0)
            v = v * indicator + (1 - indicator) * scale * v
        return ({k: v * g for k, g in updates.items()},
                {"count": state["count"] + 1})


class MaxNormConstraint(Rule):
    """Column-norm bound on the weight matrices after the update (blocks
    VariableClipping on the WEIGHT role)."""

    def __init__(self, threshold, exclude_lookup=False):
        self.threshold = threshold
        self.exclude_lookup = exclude_lookup

    def _subject(self, path, p):
        name = path.rsplit("/", 1)[-1]
        return (p.dim() == 2 and name in _WEIGHT_LEAVES
                and not (self.exclude_lookup and name == "embedding"))

    def update(self, updates, state, params=None):
        if params is None:
            return updates, state
        out = {}
        for k, u in updates.items():
            p = params[k]
            if self._subject(k, p):
                new_p = p + u
                norms = torch.sqrt((new_p ** 2).sum(dim=0, keepdim=True))
                scale = torch.clamp(self.threshold / (norms + 1e-30),
                                    max=1.0)
                u = new_p * scale - p
            out[k] = u
        return out, state


class RemoveNotFinite(Rule):
    """A tensor's update with a NaN or Inf becomes ``-scaler * param``
    (0: the parameter stays)."""

    def __init__(self, scaler=0.0):
        self.scaler = scaler

    def update(self, updates, state, params=None):
        out = {}
        for k, u in updates.items():
            fallback = (-self.scaler * params[k] if params is not None
                        else torch.zeros_like(u))
            out[k] = torch.where(torch.isfinite(u).all(), u, fallback)
        return out, state


class BurnIn(Rule):
    """No update for the first ``num_steps`` steps."""

    def __init__(self, num_steps):
        self.num_steps = num_steps

    def init(self, params):
        return {"count": _count(params)}

    def update(self, updates, state, params=None):
        live = (state["count"] >= self.num_steps).to(torch.float32)
        return ({k: u * live for k, u in updates.items()},
                {"count": state["count"] + 1})


class Chain(Rule):
    def __init__(self, *rules):
        self.rules = rules

    def init(self, params):
        return {str(i): rule.init(params) for i, rule in enumerate(
            self.rules)}

    def update(self, updates, state, params=None):
        new_state = {}
        for i, rule in enumerate(self.rules):
            updates, new_state[str(i)] = rule.update(updates, state[str(i)],
                                                     params)
        return updates, new_state


def build_optimizer(train_conf: dict, reg_conf: Optional[dict] = None):
    """The rule chain of the ``training`` and ``regularization`` config
    sections, as the JAX package's ``build_optimizer`` assembles it."""
    reg_conf = reg_conf or {}
    chain = []
    threshold = train_conf.get("gradient_threshold", 100.0)
    if threshold:
        chain.append(ClipByGlobalNorm(threshold))
    for name in train_conf.get("rules", ["momentum"]):
        if name == "momentum":
            chain += [Trace(train_conf.get("momentum", 0.0)),
                      Scale(-train_conf.get("scale", 0.01))]
        elif name == "adadelta":
            chain += [ScaleByAdadelta(train_conf.get("decay_rate", 0.95),
                                      train_conf.get("epsilon", 1e-6)),
                      Scale(-1.0)]
        elif name == "rmsprop":
            chain += [ScaleByRms(train_conf.get("decay_rate", 0.9),
                                 1.0 / 1e5),
                      Scale(-train_conf.get("scale", 0.01))]
        elif name == "adam":
            # blocks' Adam parametrises the decays as 1 - beta
            chain += [ScaleByAdam(1 - 0.1, 1 - 0.001, 1e-8),
                      Scale(-train_conf.get("scale", 2e-3))]
        elif name == "adagrad":
            chain += [ScaleByRss(1e-6),
                      Scale(-train_conf.get("scale", 0.002))]
        else:
            raise ValueError(f"unknown training rule {name!r}")
    if train_conf.get("scale_schedule"):
        chain.append(ScaleSchedule(train_conf["scale_schedule"]))
    if reg_conf.get("max_norm", 0) and reg_conf["max_norm"] > 0:
        chain.append(MaxNormConstraint(
            reg_conf["max_norm"],
            exclude_lookup=reg_conf.get("max_norm_exclude_lookup", False)))
    chain.append(RemoveNotFinite(0.0))
    if train_conf.get("burn_in_steps", 0):
        chain.append(BurnIn(train_conf["burn_in_steps"]))
    return Chain(*chain)


def state_arrays(state, prefix="") -> Dict[str, np.ndarray]:
    """Flatten an optimizer state to ``{'0/e_g/recognizer/...': array}``."""
    out = {}
    for key, value in state.items():
        name = f"{prefix}{key}" if not key.startswith("/") else \
            f"{prefix[:-1]}{key}"
        if isinstance(value, dict):
            out.update(state_arrays(value, name + "/"))
        else:
            out[name] = value.detach().cpu().numpy()
    return out


def load_state_arrays(template, arrays: Mapping[str, np.ndarray]):
    """The state of ``template``'s structure (an ``init`` result, on the
    device it is to live on) with the values of ``arrays``, the flat
    arrays of :func:`state_arrays`; a key missing or unexpected (a rule
    chain of another length or order) raises ``KeyError``."""
    flat = state_arrays(template)
    missing = sorted(set(flat) - set(arrays))
    unexpected = sorted(set(arrays) - set(flat))
    if missing or unexpected:
        raise KeyError(f"optimizer state lacks {missing[:5]}, has "
                       f"unexpected {unexpected[:5]}")

    def fill(node, prefix):
        out = {}
        for key, value in node.items():
            name = f"{prefix}{key}" if not key.startswith("/") else \
                f"{prefix[:-1]}{key}"
            if isinstance(value, dict):
                out[key] = fill(value, name + "/")
            else:
                out[key] = torch.as_tensor(arrays[name], dtype=value.dtype,
                                           device=value.device)
        return out

    return fill(template, "")
