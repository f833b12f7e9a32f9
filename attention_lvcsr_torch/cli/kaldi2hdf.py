"""Dataset converter: build Fuel-layout HDF5 speech datasets.

The ``bin/kaldi2fuel.py`` role without the kaldi-python bridge: sources
are added incrementally to one HDF5 file, the split table is written from
utterance-id lists, and symbol tables become ``value_map`` attributes.
Feature input options:

* ``add-wavs``: wav/raw-audio files -> native log-mel fbank (+energy,
  deltas) via :mod:`attention_lvcsr_torch.data.features` (the
  ``compute-fbank-feats | add-deltas`` stage of
  ``exp/wsj/write_hdf_dataset.sh:99-104``);
* ``add-ark``: Kaldi *text-format* feature archives (``ark,t:``) parsed
  directly;
* ``add-text``: transcripts -> encoded label sequences with a character
  map (``<spc>``/``<noise>``/``<eol>`` conventions of
  ``exp/wsj/write_hdf_dataset.sh``).

The port's copy of ``tools/kaldi2hdf.py`` over the port's
``data/features.py`` and ``data/h5.py``: the same subcommands, datasets,
attributes and split tables, with no JAX; ``h5py`` is imported when a
subcommand runs::

    python -m attention_lvcsr_torch.cli.kaldi2hdf add-wavs wsj.h5 wav.scp
    python -m attention_lvcsr_torch.cli.kaldi2hdf add-text wsj.h5 text
    python -m attention_lvcsr_torch.cli.kaldi2hdf split wsj.h5 \\
        train=train.scp test=test.scp
"""
from __future__ import annotations

import argparse
import sys
import wave
from typing import Dict, Iterator, List, Tuple

import numpy as np

from attention_lvcsr_torch.data.features import extract_features
from attention_lvcsr_torch.data.h5 import create_split_array


def read_wav(path) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        data = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
    return data.astype(np.float32) / 32768.0, rate


def read_ark_text(path) -> Iterator[Tuple[str, np.ndarray]]:
    """Parse a Kaldi text archive: 'uttid  [\\n r1\\n r2 ... ]'."""
    with open(path) as f:
        uttid, rows = None, []
        for line in f:
            line = line.strip()
            if line.endswith("["):
                uttid = line.split()[0]
                rows = []
            elif line.endswith("]"):
                rows.append([float(x) for x in line[:-1].split()])
                yield uttid, np.asarray(rows, np.float32)
                uttid, rows = None, []
            elif uttid is not None and line:
                rows.append([float(x) for x in line.split()])


def _append_source(h5, name, items: List[Tuple[str, np.ndarray]]):
    """Write a vlen source + shapes + a parallel uttids source."""
    import h5py
    uttids = [u for u, _ in items]
    arrays = [a for _, a in items]
    first = np.asarray(arrays[0])
    dt = h5py.special_dtype(vlen=first.dtype)
    ds = h5.create_dataset(name, (len(arrays),), dtype=dt)
    shapes = h5.create_dataset(f"{name}_shapes",
                               (len(arrays), first.ndim), dtype="int64")
    labels = h5.create_dataset(f"{name}_shape_labels", (first.ndim,),
                               dtype=h5py.special_dtype(vlen=str))
    labels[...] = ["time", "feature"][:first.ndim]
    for i, arr in enumerate(arrays):
        arr = np.asarray(arr)
        shapes[i] = arr.shape
        ds[i] = arr.ravel()
    if "uttids" not in h5:
        u = h5.create_dataset("uttids", (len(uttids),),
                              dtype=h5py.special_dtype(vlen=str))
        u[...] = uttids
    else:
        stored = [s if isinstance(s, str) else s.decode()
                  for s in h5["uttids"][...]]
        if stored != uttids:
            raise SystemExit(f"uttid order mismatch when adding {name}")
    return ds


def cmd_add_wavs(args):
    import h5py
    with open(args.scp) as f:
        pairs = [line.split(None, 1) for line in f if line.strip()]
    items = []
    for uttid, path in pairs:
        wav, rate = read_wav(path.strip())
        feats = extract_features(wav, sample_rate=rate,
                                 num_bins=args.num_bins,
                                 use_energy=not args.no_energy,
                                 deltas_order=args.deltas)
        items.append((uttid, feats))
    with h5py.File(args.h5, "a") as h5:
        _append_source(h5, args.source, items)
    print(f"added {len(items)} utterances to {args.h5}:{args.source}")


def cmd_add_ark(args):
    import h5py
    items = list(read_ark_text(args.ark))
    with h5py.File(args.h5, "a") as h5:
        _append_source(h5, args.source, items)
    print(f"added {len(items)} utterances from {args.ark}")


def encode_text(text: str, char_map: Dict[str, int]) -> np.ndarray:
    out = []
    for token in text:
        ch = "<spc>" if token == " " else token
        if ch not in char_map:
            ch = "<noise>"
        out.append(char_map.get(ch, 0))
    return np.asarray(out, np.int64)


def encode_tokens(text: str, token_map: Dict[str, int]) -> np.ndarray:
    """Whitespace-token encoding (phone transcripts, TIMIT-style)."""
    out = []
    for token in text.split():
        if token not in token_map:
            raise SystemExit(f"token {token!r} missing from symbol table")
        out.append(token_map[token])
    return np.asarray(out, np.int64)


def cmd_add_text(args):
    import h5py
    char_map: Dict[str, int] = {}
    if args.symbols:
        with open(args.symbols) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    char_map[parts[0]] = int(parts[1])
    with open(args.transcripts) as f:
        pairs = [line.strip().split(None, 1) for line in f if line.strip()]
    if not char_map:
        if args.tokens:
            toks = sorted({t for _, text in pairs for t in text.split()})
            for t in toks + ["<eol>"]:
                char_map.setdefault(t, len(char_map))
        else:
            chars = sorted({("<spc>" if c == " " else c)
                            for _, text in pairs for c in text})
            for ch in chars + ["<noise>", "<eol>"]:
                char_map.setdefault(ch, len(char_map))
    encode = encode_tokens if args.tokens else encode_text
    items = [(uttid, encode(text, char_map)) for uttid, text in pairs]
    with h5py.File(args.h5, "a") as h5:
        _append_source(h5, args.source, items)
        klen = max(len(k) for k in char_map)
        arr = np.array(sorted(char_map.items(), key=lambda kv: kv[1]),
                       dtype=[("key", f"S{klen}"), ("val", "int32")])
        h5[args.source].attrs["value_map"] = arr
    print(f"added {len(items)} transcripts; alphabet size {len(char_map)}")


def cmd_read_symbols(args):
    """Dump a source's value_map as a ``symbol id`` table (reference
    kaldi2fuel.py read_symbols — feeds net-chars.txt to the LM-graph
    recipes)."""
    import h5py
    with h5py.File(args.h5, "r") as h5:
        vm = h5[args.source].attrs["value_map"]
        lines = [f"{k.decode() if isinstance(k, bytes) else k} {v}"
                 for k, v in zip(vm["key"], vm["val"])]
    text = "\n".join(lines) + "\n"
    if args.out == "-":
        print(text, end="")
    else:
        with open(args.out, "w") as f:
            f.write(text)


def cmd_read_text(args):
    """Decode a label source back to ``uttid TEXT`` lines (reference
    kaldi2fuel.py read_raw_text — feeds create_graph_form_text)."""
    import h5py
    with h5py.File(args.h5, "r") as h5:
        vm = h5[args.source].attrs["value_map"]
        inv = {int(v): (k.decode() if isinstance(k, bytes) else k)
               for k, v in zip(vm["key"], vm["val"])}
        uttids = [u.decode() if isinstance(u, bytes) else u
                  for u in h5["uttids"][...]]
        rows = list(range(len(uttids)))
        if args.subset:
            rows = [int(i) for i in h5[f"{args.subset}_indices"][...]]
        out = sys.stdout if args.out == "-" else open(args.out, "w")
        try:
            for i in rows:
                syms = [inv[int(c)] for c in h5[args.source][i]]
                text = "".join(" " if s == "<spc>" else s for s in syms
                               if not (s.startswith("<") and s != "<spc>"))
                out.write(f"{uttids[i]} {text.strip()}\n")
        finally:
            if out is not sys.stdout:
                out.close()


def cmd_add_label(args):
    """Append a symbol to an existing source's value_map without
    rebuilding the dataset (reference exp/wsj/add_bol.py, which patches
    ``<bol>`` into wsj.h5)."""
    import h5py
    with h5py.File(args.h5, "a") as h5:
        vm = h5[args.source].attrs["value_map"]
        keys = [k.decode() if isinstance(k, bytes) else k
                for k in vm["key"]]
        if args.symbol in keys:
            raise SystemExit(f"{args.symbol!r} already in value_map")
        code = args.id if args.id is not None else int(vm["val"].max()) + 1
        klen = max(max(len(k) for k in keys), len(args.symbol))
        arr = np.array(list(zip(keys, vm["val"])) +
                       [(args.symbol, code)],
                       dtype=[("key", f"S{klen}"), ("val", "int32")])
        h5[args.source].attrs["value_map"] = arr
    print(f"added {args.symbol} -> {code} to {args.source} value_map")


def cmd_split(args):
    import h5py
    with h5py.File(args.h5, "a") as h5:
        stored = [s if isinstance(s, str) else s.decode()
                  for s in h5["uttids"][...]]
        index = {u: i for i, u in enumerate(stored)}
        sources = [name for name in h5
                   if not name.endswith(("_shapes", "_shape_labels",
                                         "_indices"))]
        split_dict = {}
        for spec in args.sets:
            name, listfile = spec.split("=")
            with open(listfile) as f:
                ids = [line.split()[0] for line in f if line.strip()]
            indices = np.asarray(sorted(index[u] for u in ids), "int64")
            ref = h5.create_dataset(f"{name}_indices", data=indices)
            split_dict[name] = {s: (-1, -1, ref.ref) for s in sources}
        h5.attrs["split"] = create_split_array(split_dict)
    print(f"split table written for {list(split_dict)}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("add-wavs", help="wav scp -> fbank features")
    a.add_argument("h5"); a.add_argument("scp")
    a.add_argument("--source", default="recordings")
    a.add_argument("--num-bins", type=int, default=40)
    a.add_argument("--deltas", type=int, default=2)
    a.add_argument("--no-energy", action="store_true")
    a.set_defaults(fn=cmd_add_wavs)

    a = sub.add_parser("add-ark", help="kaldi text ark -> features")
    a.add_argument("h5"); a.add_argument("ark")
    a.add_argument("--source", default="recordings")
    a.set_defaults(fn=cmd_add_ark)

    a = sub.add_parser("add-text", help="transcripts -> labels")
    a.add_argument("h5"); a.add_argument("transcripts")
    a.add_argument("--source", default="labels")
    a.add_argument("--symbols", default=None)
    a.add_argument("--tokens", action="store_true",
                   help="whitespace-token transcripts (phones) instead of "
                        "character-level (the reference's add_text "
                        "--applymap mode)")
    a.set_defaults(fn=cmd_add_text)

    a = sub.add_parser("add-label", help="append a symbol to a source's "
                       "value_map (add_bol.py role)")
    a.add_argument("h5"); a.add_argument("symbol")
    a.add_argument("--source", default="labels")
    a.add_argument("--id", type=int, default=None)
    a.set_defaults(fn=cmd_add_label)

    a = sub.add_parser("read-symbols", help="dump a value_map as a "
                       "symbol table")
    a.add_argument("h5"); a.add_argument("out", default="-", nargs="?")
    a.add_argument("--source", default="labels")
    a.set_defaults(fn=cmd_read_symbols)

    a = sub.add_parser("read-text", help="decode labels to raw text")
    a.add_argument("h5"); a.add_argument("out", default="-", nargs="?")
    a.add_argument("--source", default="labels")
    a.add_argument("--subset", default=None)
    a.set_defaults(fn=cmd_read_text)

    a = sub.add_parser("split", help="write the split table")
    a.add_argument("h5")
    a.add_argument("sets", nargs="+", help="name=uttid_list pairs")
    a.set_defaults(fn=cmd_split)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
