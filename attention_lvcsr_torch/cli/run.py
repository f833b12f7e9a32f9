"""Command-line front end of the port: ``train``, ``test``,
``init_norm``, ``search``, ``sample``, ``show_data`` and ``serve``.

The subcommands and arguments of ``attention_lvcsr_tpu/cli/run.py`` (a
YAML config path, trailing ``path value`` overrides, ``--params`` where
the JAX parser has it), plus ``--device`` (default ``cuda``, where the
kernels run) on each subcommand that builds a model; they dispatch into
:mod:`attention_lvcsr_torch.train.driver` and
:mod:`attention_lvcsr_torch.serve`.

    python -m attention_lvcsr_torch.cli.run train model.zip \\
        tests/configs/toy.yaml training.num_batches 5 --device cpu
    python -m attention_lvcsr_torch.cli.run train run_dir \\
        exp/wsj/configs/wsj_paper.yaml --start-stage main \\
        --params run_dir/pretraining_best_ll.zip --use-load-ext
    python -m attention_lvcsr_torch.cli.run search tests/configs/toy.yaml \\
        --params model.zip --report report --device cpu
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

    def add_common(sub, with_save=False, with_params=True, with_device=True):
        if with_save:
            sub.add_argument("save_path", help="where to save the model")
        sub.add_argument("config_path", help="experiment YAML")
        if with_params:
            sub.add_argument("--params", default=None,
                             help="load parameters from this checkpoint")
        sub.add_argument("config_changes", nargs="*", action=ParseChanges,
                         default=[],
                         help="trailing (dotted.path value) override pairs")
        if with_device:
            sub.add_argument("--device", default="cuda",
                             help="torch device of the model (cuda runs the "
                                  "kernels)")

    tr = subparsers.add_parser("train", help="train a model")
    add_common(tr, with_save=True)
    tr.add_argument("--fast-start", action="store_true",
                    help="skip the validation, the search and the "
                         "checkpoint before the first epoch")
    tr.add_argument("--use-load-ext", action="store_true",
                    help="resume the parameters, the optimizer state and "
                         "the log of --params (of each stage's start)")
    tr.add_argument("--load-log", action="store_true",
                    help="load only the log from --params")
    tr.add_argument("--start-stage", default=None,
                    help="the stage of a multistage config to start at")
    tr.add_argument("--final-stage", default=None,
                    help="the stage of a multistage config to stop after")
    tr.add_argument("--profile", action="store_true",
                    help="print the training loop's host times at the end")

    te = subparsers.add_parser("test", help="evaluate on the test set")
    add_common(te, with_device=False)

    n = subparsers.add_parser("init_norm",
                              help="estimate feature normalization")
    add_common(n, with_save=True, with_params=False, with_device=False)

    s = subparsers.add_parser("search", help="beam-search decode")
    add_common(s)
    s.add_argument("--part", default="valid")
    s.add_argument("--report", default=None,
                   help="directory for report.txt + alignment plots")
    s.add_argument("--decoded-save", default=None)
    s.add_argument("--decode-only", default=None,
                   help="python expression for utterance numbers")
    s.add_argument("--nll-only", action="store_true")
    s.add_argument("--seed", type=int, default=None)

    sa = subparsers.add_parser("sample", help="sample from the model")
    add_common(sa)
    sa.add_argument("--part", default="valid")

    sd = subparsers.add_parser("show_data",
                               help="print a batch of training data")
    add_common(sd, with_params=False, with_device=False)

    sv = subparsers.add_parser("serve", help="HTTP decode endpoint with "
                               "micro-batching")
    add_common(sv)
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
    if args.mode == "serve":
        from attention_lvcsr_torch.serve import serve
        return serve(config, args.params, host=args.host, port=args.port,
                     beam_size=args.beam_size, max_batch=args.max_batch,
                     batch_wait_ms=args.batch_wait_ms, device=args.device)
    from attention_lvcsr_torch.train import driver
    if args.mode == "train":
        return driver.train_multistage(
            config, args.save_path, params_path=args.params,
            start_stage=args.start_stage, final_stage=args.final_stage,
            fast_start=args.fast_start, use_load_ext=args.use_load_ext,
            load_log=args.load_log, profile=args.profile,
            device=args.device)
    if args.mode == "test":
        return driver.test(config)
    if args.mode == "init_norm":
        return driver.init_norm(config, args.save_path)
    if args.mode == "search":
        decode_only = eval(args.decode_only) if args.decode_only else None
        return driver.search(
            config, args.params, part=args.part, decode_only=decode_only,
            report=args.report, decoded_save=args.decoded_save,
            nll_only=args.nll_only, seed=args.seed, device=args.device)
    if args.mode == "sample":
        return driver.sample(config, args.params, part=args.part,
                             device=args.device)
    if args.mode == "show_data":
        return driver.show_data(config)
    raise ValueError(args.mode)


if __name__ == "__main__":
    main()
