"""Build a synthetic speech-like HDF5 dataset in the Fuel layout.

Each utterance is a random character sequence; "recordings" are per-symbol
feature templates repeated for a few frames with additive noise, so a tiny
model can actually learn the mapping.  Used by the end-to-end smoke tests
and as a stand-in for the WSJ/TIMIT datasets (whose raw audio is not
available in this environment); the file layout matches
``bin/kaldi2fuel.py`` output so real converted datasets drop in.

The port's copy of ``tools/make_toy_dataset.py``: the same file from the
same seed, written without JAX::

    python -m attention_lvcsr_torch.cli.make_toy_dataset /tmp/toy.h5

``--text`` writes a text-only set instead (:func:`make_text_dataset`): the
``inputs`` and ``labels`` sources hold the same random character
sequences over one character map, the data of
``prototype_autoencoder.yaml``, which learns to copy its input::

    python -m attention_lvcsr_torch.cli.make_toy_dataset --text /tmp/text.h5
"""
from __future__ import annotations

import argparse

import numpy as np

from attention_lvcsr_torch.data.h5 import DatasetWriter


def make_toy_dataset(path, num_examples=120, num_chars=6, feat_dim=8,
                     min_len=2, max_len=8, frames_per_char=3, noise=0.1,
                     seed=0, splits=(("train", 0.8), ("valid", 0.1),
                                     ("test", 0.1))):
    rng = np.random.RandomState(seed)
    # symbol inventory: real characters + <eol> (+ <spc> flavor optional)
    chars = [chr(ord("a") + i) for i in range(num_chars)] + ["<eol>"]
    value_map = {c: i for i, c in enumerate(chars)}
    templates = rng.randn(num_chars, feat_dim).astype("float32") * 2.0

    recordings, labels, uttids = [], [], []
    for i in range(num_examples):
        length = rng.randint(min_len, max_len + 1)
        seq = rng.randint(0, num_chars, size=length)
        frames = np.repeat(templates[seq], frames_per_char, axis=0)
        frames = frames + noise * rng.randn(*frames.shape).astype("float32")
        recordings.append(frames.astype("float32"))
        labels.append(seq.astype("int64"))
        uttids.append(f"utt{i:04d}")

    writer = DatasetWriter(path)
    writer.add_vector_source("recordings", recordings)
    writer.add_vector_source("labels", labels, value_map=value_map)
    writer.add_text_source("uttids", uttids)

    bounds = {}
    start = 0
    for name, frac in splits:
        n = int(round(frac * num_examples))
        bounds[name] = (start, min(start + n, num_examples))
        start += n
    writer.set_split({name: {src: rng_ for src in
                             ("recordings", "labels", "uttids")}
                      for name, rng_ in bounds.items()})
    writer.close()
    return value_map


def make_text_dataset(path, num_examples=120, num_chars=6, min_len=2,
                      max_len=8, seed=0, splits=(("train", 0.8),
                                                 ("valid", 0.1),
                                                 ("test", 0.1))):
    """A seeded text-only dataset: ``inputs`` equal to ``labels``, random
    sequences over ``num_chars`` characters, both sources with the
    character map of the characters and ``<eol>`` (the labels' EOS)."""
    rng = np.random.RandomState(seed)
    chars = [chr(ord("a") + i) for i in range(num_chars)] + ["<eol>"]
    value_map = {c: i for i, c in enumerate(chars)}
    sequences, uttids = [], []
    for i in range(num_examples):
        length = rng.randint(min_len, max_len + 1)
        sequences.append(rng.randint(0, num_chars, size=length)
                         .astype("int64"))
        uttids.append(f"text{i:04d}")
    writer = DatasetWriter(path)
    writer.add_vector_source("inputs", sequences, value_map=value_map)
    writer.add_vector_source("labels", sequences, value_map=value_map)
    writer.add_text_source("uttids", uttids)
    bounds, start = {}, 0
    for name, frac in splits:
        n = int(round(frac * num_examples))
        bounds[name] = (start, min(start + n, num_examples))
        start += n
    writer.set_split({name: {src: rng_ for src in
                             ("inputs", "labels", "uttids")}
                      for name, rng_ in bounds.items()})
    writer.close()
    return value_map


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--num-examples", type=int, default=120)
    ap.add_argument("--num-chars", type=int, default=6)
    ap.add_argument("--feat-dim", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--text", action="store_true",
                    help="a text-only set: inputs equal to the labels")
    args = ap.parse_args(argv)
    if args.text:
        vm = make_text_dataset(args.path, num_examples=args.num_examples,
                               num_chars=args.num_chars, seed=args.seed)
        print(f"wrote {args.path} with alphabet {vm}")
        return
    vm = make_toy_dataset(args.path, num_examples=args.num_examples,
                          num_chars=args.num_chars, feat_dim=args.feat_dim,
                          seed=args.seed)
    print(f"wrote {args.path} with alphabet {vm}")


if __name__ == "__main__":
    main()
