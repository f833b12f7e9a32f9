"""Built-in structural schema validation for experiment configs.

Plays the role of pykwalify in the reference (``lvsr/config.py:82-91``
validating against ``lvsr/configs/schema.yaml``) with a compact schema
format:

* a schema node is a dict; ``type`` is one of str/int/float/bool/seq/map/
  any (numbers accept int-where-float);
* ``map`` lists allowed child keys with their schemas; unknown keys are
  errors unless ``allow_extra`` is true or a ``"*"`` wildcard child exists;
* ``seq`` gives the element schema under ``element``.

The default schema (``schema.yaml`` next to this module) covers the same
config surface as the reference schema: data/net/regularization/
initialization/training/monitoring/stages/vocabulary.
"""
from __future__ import annotations

import os
from typing import Any, List, Optional



class ConfigValidationError(ValueError):
    pass


_SCALARS = {
    "str": (str,),
    "int": (int,),
    "float": (int, float),
    "bool": (bool,),
    "number": (int, float),
}

DEFAULT_SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "schema.yaml")


def coerce_config(config: Any, schema: Optional[dict] = None,
                  schema_path: Optional[str] = None):
    """Coerce archival-YAML scalar quirks in place, guided by the schema:
    numeric strings where a number is expected (YAML 1.1 reads ``1e-8``
    as a string — wsj_prior_conv_adadelta.yaml), and empty strings where
    an int/float is expected (``sort_k_batches: ''`` means "disabled",
    nips_baseline.yaml; the reference schema types it as str for the
    same reason)."""
    if schema is None:
        if schema_path is False:        # validation disabled: no-op
            return config
        if schema_path is None:
            schema_path = DEFAULT_SCHEMA_PATH
        import yaml
        with open(os.path.expandvars(schema_path)) as f:
            schema = yaml.safe_load(f)
    kind = schema.get("type", "map" if "map" in schema else "any")
    if kind == "map" and isinstance(config, dict):
        children = schema.get("map", {})
        wildcard = children.get("*")
        for key, value in config.items():
            child = children.get(key, wildcard)
            if isinstance(value, str) and isinstance(child, dict) \
                    and child.get("type") in ("int", "float", "number"):
                if not value.strip():
                    config[key] = None
                else:
                    try:
                        num = float(value)
                        config[key] = (int(num)
                                       if child["type"] == "int" else num)
                    except ValueError:
                        pass  # validation will report it
            elif isinstance(value, (dict, list)) and child:
                coerce_config(value, child)
    elif kind == "seq" and isinstance(config, list):
        elem = schema.get("element", {"type": "any"})
        for item in config:
            if isinstance(item, (dict, list)):
                coerce_config(item, elem)
    return config


def _check(node: Any, schema: dict, path: str, errors: List[str]):
    kind = schema.get("type", "map" if "map" in schema else "any")
    if kind == "any":
        return
    if kind in _SCALARS:
        if node is not None and not isinstance(node, _SCALARS[kind]):
            # YAML tags may produce lists/dicts where classes used to be
            errors.append(f"{path}: expected {kind}, got "
                          f"{type(node).__name__} ({node!r})")
        return
    if kind == "seq":
        if node is None:
            return
        if not isinstance(node, (list, tuple)):
            errors.append(f"{path}: expected a sequence")
            return
        elem = schema.get("element", {"type": "any"})
        for i, item in enumerate(node):
            _check(item, elem, f"{path}[{i}]", errors)
        return
    if kind == "map":
        if node is None:
            return
        if not isinstance(node, dict):
            errors.append(f"{path}: expected a mapping")
            return
        children = schema.get("map", {})
        wildcard = children.get("*")
        for key, value in node.items():
            child = children.get(key, wildcard)
            if child is None:
                if schema.get("allow_extra"):
                    continue
                errors.append(f"{path}: unknown key '{key}'")
                continue
            _check(value, child or {"type": "any"}, f"{path}.{key}", errors)
        for key, child in children.items():
            if key != "*" and isinstance(child, dict) \
                    and child.get("required") and key not in node:
                errors.append(f"{path}: missing required key '{key}'")
        return
    raise ValueError(f"bad schema node type {kind!r} at {path}")


def validate_config(config: dict, schema_path: Optional[str] = None):
    """Validate ``config``; raises ConfigValidationError listing problems.

    ``schema_path=None`` uses the built-in schema; ``schema_path=False``
    disables validation.
    """
    if schema_path is False:
        return
    if schema_path is None:
        schema_path = DEFAULT_SCHEMA_PATH
    import yaml
    with open(os.path.expandvars(schema_path)) as f:
        schema = yaml.safe_load(f)
    errors: List[str] = []
    _check(config, schema, "config", errors)
    if errors:
        raise ConfigValidationError("\n".join(errors))
