"""Checkpoint surgery on path-keyed parameter files.

The path-keyed checkpoint format ('/recognizer/...' -> array, see
``attention_lvcsr_torch/train/checkpoint.py``) exists precisely so
parameters can be edited across model versions; this tool packages the
workflows the reference did ad hoc:

* ``grow``  — the ``exp/wsj/add_bos_to_parameters.py`` role: grow every
  axis of a given size by N zero-initialized rows/columns (adding
  vocabulary entries, e.g. a new ``<bol>`` character);
* ``rename`` — regex-rename parameter paths (brick/module renames
  between model versions);
* ``extract`` / ``merge`` — subset or overlay parameter sets (warm
  starts from a different experiment);
* ``list`` — inspect keys and shapes.

Inputs may be tar checkpoints (``*.zip``) or raw ``.npz``; output is a
raw path-keyed ``.npz`` loadable by the trainer's ``--params``.

The port's copy of ``tools/edit_params.py``: the same subcommands, files
and output, with no JAX::

    python -m attention_lvcsr_torch.cli.edit_params list model.zip
"""
import argparse
import re

import numpy as np

from attention_lvcsr_torch.train.checkpoint import (load_parameters,
                                                    save_parameters)


def _grow_axis(param, axis, extra):
    shape = list(param.shape)
    shape[axis] += extra
    out = np.zeros(shape, param.dtype)
    out[tuple(slice(d) for d in param.shape)] = param
    return out


def cmd_list(args):
    for key, value in sorted(load_parameters(args.ckpt).items()):
        print(f"{key}  {value.dtype}{list(value.shape)}")


def cmd_grow(args):
    params = load_parameters(args.ckpt)
    out = {}
    touched = 0
    for key, value in params.items():
        if hasattr(value, "shape") and (args.key is None
                                        or re.search(args.key, key)):
            for axis, dim in enumerate(value.shape):
                if dim == args.dim_size:
                    value = _grow_axis(value, axis, args.extra)
                    touched += 1
        out[key] = value
    save_parameters(args.out, out)
    print(f"grew {touched} axes of size {args.dim_size} by {args.extra} "
          f"-> {args.out}")


def cmd_rename(args):
    params = load_parameters(args.ckpt)
    out = {}
    touched = 0
    for key, value in params.items():
        new = re.sub(args.pattern, args.repl, key)
        if new != key:
            touched += 1
        if new in out:
            raise SystemExit(f"rename collision: {new}")
        out[new] = value
    save_parameters(args.out, out)
    print(f"renamed {touched}/{len(out)} keys -> {args.out}")


def cmd_extract(args):
    params = load_parameters(args.ckpt)
    out = {k: v for k, v in params.items() if re.search(args.pattern, k)}
    if not out:
        raise SystemExit(f"no keys match {args.pattern!r}")
    save_parameters(args.out, out)
    print(f"extracted {len(out)}/{len(params)} keys -> {args.out}")


def cmd_merge(args):
    base = load_parameters(args.base)
    overlay = load_parameters(args.overlay)
    replaced = sum(1 for k in overlay if k in base)
    base.update(overlay)
    save_parameters(args.out, base)
    print(f"merged: {replaced} replaced, {len(overlay) - replaced} added, "
          f"{len(base)} total -> {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("list", help="print keys and shapes")
    a.add_argument("ckpt")
    a.set_defaults(fn=cmd_list)

    a = sub.add_parser("grow", help="zero-grow axes of a given size "
                       "(add_bos_to_parameters role)")
    a.add_argument("ckpt")
    a.add_argument("out")
    a.add_argument("--dim-size", type=int, required=True,
                   help="grow every axis currently of this size")
    a.add_argument("--extra", type=int, default=1,
                   help="number of zero rows/cols to append (default 1)")
    a.add_argument("--key", default=None,
                   help="only touch keys matching this regex")
    a.set_defaults(fn=cmd_grow)

    a = sub.add_parser("rename", help="regex-rename parameter paths")
    a.add_argument("ckpt")
    a.add_argument("out")
    a.add_argument("pattern")
    a.add_argument("repl")
    a.set_defaults(fn=cmd_rename)

    a = sub.add_parser("extract", help="subset keys by regex")
    a.add_argument("ckpt")
    a.add_argument("out")
    a.add_argument("pattern")
    a.set_defaults(fn=cmd_extract)

    a = sub.add_parser("merge", help="overlay params onto a base set")
    a.add_argument("base")
    a.add_argument("overlay")
    a.add_argument("out")
    a.set_defaults(fn=cmd_merge)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
