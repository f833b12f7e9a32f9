"""YAML tag compatibility with reference experiment configs.

Reference configs instantiate Theano/Blocks classes straight from YAML
(``!!python/name:blocks.bricks.recurrent.GatedRecurrent``,
``!!python/object/apply:blocks.initialization.IsotropicGaussian [0.1]`` —
see ``lvsr/configs/prototype_speech.yaml``).  This loader resolves those
tags into *our* registry equivalents so reference YAMLs parse unchanged:

* ``python/name:`` tags become the class-name string (the model factories
  accept names — ``GatedRecurrent`` -> the GRU cell, ``SpeechBottom`` ->
  the speech bottom, ...);
* ``python/object/apply:`` tags on initializer/activation classes become
  ``[ClassName, *args]`` specs understood by
  :func:`attention_lvcsr_torch.models.initializers.get_initializer`.
"""
from __future__ import annotations

# Activation bricks appear as object/apply with no args; map to plain names.
_ACTIVATIONS = {"Rectifier": "relu", "Tanh": "tanh", "Logistic": "sigmoid",
                "Identity": "identity", "Maxout": "maxout"}


def _name_constructor(loader, suffix, node):
    # value is the dotted path; keep the final class name.
    return suffix.rsplit(".", 1)[-1]


def _apply_constructor(loader, suffix, node):
    import yaml
    name = suffix.rsplit(".", 1)[-1]
    if isinstance(node, yaml.SequenceNode):
        args = loader.construct_sequence(node, deep=True)
    elif isinstance(node, yaml.MappingNode):
        args = loader.construct_mapping(node, deep=True)
    else:
        args = []
    if name in _ACTIVATIONS and not args:
        return _ACTIVATIONS[name]
    if name == "Maxout" and isinstance(args, list) and args:
        # Maxout carries num_pieces (blocks/bricks/simple.py:155-158).
        return f"maxout:{args[0]}"
    if isinstance(args, dict):
        spec = dict(args)
        spec["type"] = name
        return spec
    return [name] + list(args)


def _object_constructor(loader, suffix, node):
    # ``!!python/object:blocks.initialization.Uniform {width: 0.1}``
    # (wsj_bhd*.yaml) — kwargs-style instantiation; same spec form as
    # the mapping branch of object/apply.
    name = suffix.rsplit(".", 1)[-1]
    kwargs = (loader.construct_mapping(node, deep=True)
              if isinstance(node, yaml.MappingNode) else {})
    if name in _ACTIVATIONS and not kwargs:
        return _ACTIVATIONS[name]
    spec = dict(kwargs)
    spec["type"] = name
    return spec


def make_loader():
    import yaml

    class ConfigLoader(yaml.SafeLoader):
        pass

    ConfigLoader.add_multi_constructor(
        "tag:yaml.org,2002:python/name:", _name_constructor)
    ConfigLoader.add_multi_constructor(
        "tag:yaml.org,2002:python/object/apply:", _apply_constructor)
    ConfigLoader.add_multi_constructor(
        "tag:yaml.org,2002:python/object:", _object_constructor)
    return ConfigLoader
