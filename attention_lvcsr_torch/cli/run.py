"""Command-line front end of the port: ``train`` and ``serve``.

Same arguments as ``attention_lvcsr_tpu/cli/run.py train`` (save path,
YAML config path, ``--params`` checkpoint, trailing ``path value``
overrides) and ``serve`` (config, ``--params``, overrides, host, port,
beam size, micro-batch size and wait), plus ``--device``.  The other
subcommands (search, sample, ...) come with later parts of the port.

    python -m attention_lvcsr_torch.cli.run train model.zip \\
        tests/configs/toy.yaml training.num_batches 5 --device cpu
    python -m attention_lvcsr_torch.cli.run serve tests/configs/toy.yaml \\
        --params model.zip --port 8000
"""
from __future__ import annotations

import argparse
import logging


class ParseChanges(argparse.Action):
    """Collect trailing ``path value`` pairs into (path, value) tuples."""

    def __call__(self, parser, namespace, values, option_string=None):
        if len(values) % 2:
            raise ValueError(
                "config changes must come in (path, value) pairs")
        setattr(namespace, self.dest,
                list(zip(values[::2], values[1::2])))


def build_parser():
    parser = argparse.ArgumentParser(
        description="Fully neural speech recognition (PyTorch/CUDA port)")
    parser.add_argument("--logging", default="INFO",
                        help="logging level (DEBUG/INFO/WARNING)")
    subparsers = parser.add_subparsers(dest="mode", required=True)
    tr = subparsers.add_parser("train", help="train a model")
    tr.add_argument("save_path", help="where to save the model")
    tr.add_argument("--fast-start", action="store_true",
                    help="skip the validation and the checkpoint before "
                         "the first epoch")
    sv = subparsers.add_parser("serve", help="HTTP decode endpoint with "
                               "micro-batching")
    for sub in (tr, sv):
        sub.add_argument("config_path", help="experiment YAML")
        sub.add_argument("--params", default=None,
                         help="load parameters from this checkpoint")
        sub.add_argument("config_changes", nargs="*", action=ParseChanges,
                         default=[],
                         help="trailing (dotted.path value) override pairs")
        sub.add_argument("--device", default="cuda",
                         help="torch device of the model (cuda runs the "
                              "kernels)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--beam-size", type=int, default=None)
    sv.add_argument("--max-batch", type=int, default=8)
    sv.add_argument("--batch-wait-ms", type=float, default=20.0)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.logging.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    from attention_lvcsr_torch.config import Configuration   # yaml: CLI only
    config = Configuration(args.config_path,
                           config_changes=args.config_changes or [])
    if args.mode == "train":
        from attention_lvcsr_torch.train.driver import train
        return train(config, args.save_path, args.params,
                     fast_start=args.fast_start, device=args.device)
    from attention_lvcsr_torch.serve import serve
    return serve(config, args.params, host=args.host, port=args.port,
                 beam_size=args.beam_size, max_batch=args.max_batch,
                 batch_wait_ms=args.batch_wait_ms, device=args.device)


if __name__ == "__main__":
    main()
