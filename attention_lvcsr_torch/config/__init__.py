"""YAML configuration with parent chains, overrides, schema and stages.

The port's copy of ``attention_lvcsr_tpu/config``; ``yaml`` is imported
only when a file is read.  A ``parent:`` under the JAX package's
``config/prototypes/`` resolves to the copy of that prototype here.

Counterpart of ``lvsr/config.py:9-92``: recursive ``parent:`` resolution
(with ``$LVSR``-style env expansion), recursive dict merge, dotted-path CLI
overrides, schema validation, and multi-stage expansion ordered by
``number:``.  Differences from the reference:

* schema validation is a small built-in structural checker
  (:mod:`attention_lvcsr_torch.config.schema`) instead of pykwalify;
* ``!!python/name:`` / ``!!python/object/apply:`` YAML tags from reference
  configs are accepted and mapped to registry names / initializer specs so
  reference experiment YAMLs load unchanged
  (:mod:`attention_lvcsr_torch.config.registry`).
"""
from __future__ import annotations

import copy
import os
from collections import OrderedDict
from typing import Dict, List, Tuple

from attention_lvcsr_torch.config.registry import make_loader
from attention_lvcsr_torch.config.schema import (coerce_config,
                                                 validate_config)

_PROTOTYPES = os.path.join("attention_lvcsr_tpu", "config", "prototypes")


def load_yaml(text_or_file):
    import yaml      # only the CLI reads configs: yaml is not needed on the card
    return yaml.load(text_or_file, Loader=make_loader())


def read_config(file_) -> dict:
    """Read YAML resolving ``parent:`` chains (env vars expanded)."""
    config = load_yaml(file_)
    if "parent" in config:
        # $LVSR_TPU is the reference's $LVSR convention (env.sh:16);
        # default it to the repo root so configs work out of the box
        os.environ.setdefault("LVSR_TPU", os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        parent_path = os.path.expandvars(config.pop("parent"))
        head, name = os.path.split(os.path.normpath(parent_path))
        if head.endswith(_PROTOTYPES):
            parent_path = os.path.join(os.path.dirname(__file__),
                                       "prototypes", name)
        with open(parent_path) as src:
            parent = read_config(src)
        merge_recursively(parent, config)
        config = parent
    return config


def merge_recursively(config: dict, changes: dict) -> None:
    """In-place recursive merge of ``changes`` into ``config``."""
    for key, value in changes.items():
        if isinstance(value, dict) and isinstance(config.get(key), dict):
            merge_recursively(config[key], value)
        else:
            config[key] = value


def make_config_changes(config: dict, changes: List[Tuple[str, str]]) -> None:
    """Apply ``(dotted.path, yaml_value)`` pairs (CLI overrides)."""
    for path, value in changes:
        parts = path.split(".")
        node = config
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = (load_yaml(value) if isinstance(value, str)
                           else value)


class Configuration(dict):
    """Multi-stage configuration (lvsr/config.py:52-92).

    ``stages:`` maps stage names to per-stage deltas with a ``number:``
    ordering key; each stage's config is the base config with its delta
    recursively merged (and ``stages`` removed).
    """

    def __init__(self, config_path, schema_path=None, config_changes=()):
        with open(config_path, "rt") as src:
            config = read_config(src)
        make_config_changes(config, list(config_changes))

        coerce_config(config, schema_path=schema_path)
        self.multi_stage = "stages" in config
        self.ordered_stages: "OrderedDict[str, dict]" = OrderedDict()
        if self.multi_stage:
            stages = [(k, v) for k, v in config["stages"].items() if v]
            stages.sort(key=lambda kv: kv[1]["number"])
            for name, changes in stages:
                stage_config = copy.deepcopy(config)
                del stage_config["stages"]
                changes = dict(changes)
                del changes["number"]
                merge_recursively(stage_config, changes)
                # stage deltas come from the schema-opaque `stages:`
                # section, so archival scalar quirks in them were not
                # coerced with the top level
                coerce_config(stage_config, schema_path=schema_path)
                self.ordered_stages[name] = stage_config

        validate_config(config, schema_path)
        for stage in self.ordered_stages.values():
            validate_config(stage, schema_path)
        super().__init__(config)
