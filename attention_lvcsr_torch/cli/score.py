"""WER/CER scoring of decoded transcripts (the Kaldi ``compute-wer`` role
in ``exp/wsj/score.sh:37``).

Reads reference and hypothesis files of ``uttid transcript...`` lines,
applies optional text filters (lowercase, remove ``<noise>``-style tags —
the wer_ref_filter/wer_hyp_filter role), and prints per-utterance and
aggregate WER using the same edit-distance core as training
(:mod:`attention_lvcsr_torch.ops.error_rate`).

The port's copy of ``tools/score.py``: the same arguments and output, with
no JAX::

    python -m attention_lvcsr_torch.cli.score ref.txt decoded.txt
"""
from __future__ import annotations

import argparse
import re
from typing import Dict, List

from attention_lvcsr_torch.ops.error_rate import edit_distance


def read_trn(path) -> Dict[str, List[str]]:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                out[parts[0]] = parts[1:]
    return out


def apply_filter(words: List[str], lowercase=False, strip_tags=True,
                 char_mode=False) -> List[str]:
    out = []
    for w in words:
        if strip_tags and re.fullmatch(r"<[^>]+>|\[[^\]]+\]|~+", w):
            continue
        if lowercase:
            w = w.lower()
        out.append(w)
    if char_mode:
        return list(" ".join(out).replace(" ", "|"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ref", help="reference transcripts (uttid words...)")
    ap.add_argument("hyp", help="hypothesis transcripts")
    ap.add_argument("--lowercase", action="store_true")
    ap.add_argument("--keep-tags", action="store_true")
    ap.add_argument("--cer", action="store_true",
                    help="score characters instead of words")
    ap.add_argument("--per-utt", action="store_true")
    args = ap.parse_args(argv)

    refs = read_trn(args.ref)
    hyps = read_trn(args.hyp)
    total_err = total_len = 0
    missing = 0
    for uttid, ref_words in sorted(refs.items()):
        ref_f = apply_filter(ref_words, args.lowercase,
                             not args.keep_tags, args.cer)
        if uttid not in hyps:
            missing += 1
            hyp_f = []
        else:
            hyp_f = apply_filter(hyps[uttid], args.lowercase,
                                 not args.keep_tags, args.cer)
        err = edit_distance(ref_f, hyp_f)
        total_err += err
        total_len += len(ref_f)
        if args.per_utt:
            rate = err / max(len(ref_f), 1)
            print(f"{uttid} errors={err} len={len(ref_f)} "
                  f"{'cer' if args.cer else 'wer'}={rate:.4f}")
    unit = "CER" if args.cer else "WER"
    rate = 100.0 * total_err / max(total_len, 1)
    print(f"%{unit} {rate:.2f} [ {total_err} / {total_len} ]"
          + (f" ({missing} missing hyps)" if missing else ""))
    return rate


if __name__ == "__main__":
    main()
