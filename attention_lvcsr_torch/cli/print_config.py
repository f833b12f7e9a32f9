"""Print (parts of) the fully-expanded experiment configuration — the
parent chain merged, CLI changes applied (reference
bin/print_yaml_conf.py).  The format string is applied with the config
as keyword arguments, e.g.::

    print_config.py exp/wsj/configs/wsj_paper.yaml "{net[dims_bidir]}"
    print_config.py cfg.yaml "{0}" --positional  # whole config
    print_config.py cfg.yaml "{net[dim_dec]}" net.dim_dec 300

The port's copy of ``tools/print_config.py`` over the port's
``config.Configuration`` (``yaml`` is imported when the file is read)::

    python -m attention_lvcsr_torch.cli.print_config \\
        exp/wsj/configs/wsj_paper.yaml "{net[dims_bidir]}"
"""
import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config_path")
    parser.add_argument("format_string", default="{0}", nargs="?")
    parser.add_argument("--positional", action="store_true",
                        help="format with the config as argument 0 "
                             "instead of keyword-expanded")
    parser.add_argument("changes", nargs="*", default=(),
                        help="dotted-path value override pairs")
    args = parser.parse_args(argv)

    from attention_lvcsr_torch.config import Configuration
    pairs = list(zip(args.changes[::2], args.changes[1::2]))
    config = Configuration(args.config_path, config_changes=pairs)
    if args.positional:
        print(args.format_string.format(dict(config)))
    else:
        print(args.format_string.format(**config))


if __name__ == "__main__":
    main()
