#!/usr/bin/env python3
"""Times the whole-loop decode kernel on one NVIDIA GPU, alone, and keeps
its outputs for a bit-for-bit comparison with another commit's.

    python3 tools/torch_bench_decode_kernels.py [--root DIR] [--out F.npz]
                                                [--repeats N]
    python3 tools/torch_bench_decode_kernels.py --compare A.npz B.npz

Run from the repository root on a machine with a CUDA device and nvcc.
On the flagship network (``__graft_entry__.FLAGSHIP_NET``, random weights
from seed 1234, the initialisation ``chip_smoke.py`` uses), for U = 64, 128
and 256 utterances of 800 frames of numpy-seeded features, the encoder's
outputs and the loop tables are made once; then ``beam_search_loop``
(``csrc/beam_loop.cu``: beam 10, a 100-step cap) is timed with CUDA events
around ``--repeats`` launches.  At U=64 it also runs with the EOS logit
raised by 1.5, so that most hypotheses finish, and calls the kernel a
second time to check that it repeats its bits.  ``--out`` writes each
run's ``done_out``, ``done_meta`` and ``steps`` to an ``.npz``.

``--root DIR`` imports the ``attention_lvcsr_torch`` package found in DIR
instead of this checkout's and builds its kernels there: with DIR an
unpacked copy of another commit (``git archive <commit>
attention_lvcsr_torch __graft_entry__.py | tar -x -C DIR``), runs in turns
time two versions on the same card.  ``--compare`` reports, key by key,
whether two such files hold the same bits.  The last line is a JSON object
of the numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.1],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}


def compare(path_a, path_b):
    a, b = np.load(path_a), np.load(path_b)
    same = {}
    for key in sorted(set(a.files) | set(b.files)):
        same[key] = (key in a.files and key in b.files
                     and a[key].dtype == b[key].dtype
                     and a[key].shape == b[key].shape
                     and a[key].tobytes() == b[key].tobytes())
        print(f"{key}: {'same bits' if same[key] else 'DIFFERENT'}")
    print(json.dumps({"a": path_a, "b": path_b, "all_same": all(same.values()),
                      "same": same}))
    return all(same.values())


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=ROOT,
                        help="directory holding the attention_lvcsr_torch "
                             "package to time")
    parser.add_argument("--out", default=None,
                        help="write the decodes' outputs to this .npz")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--compare", nargs=2, metavar="NPZ")
    args = parser.parse_args()
    if args.compare:
        sys.exit(0 if compare(*args.compare) else 1)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import beam_loop as bl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"package: {os.path.dirname(bl.__file__)}")
    lib = _build.load()
    mine = False            # ptxas lines of the loop kernel
    for line in lib.log.splitlines():
        if "Compiling entry" in line:
            mine = "beam_loop" in line or "product_rows" in line
        if mine and ("Compiling entry" in line or "Used" in line
                     or "spill" in line):
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda:0")

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.repeats):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.repeats

    rec = SpeechRecognizer(dict(FLAGSHIP_NET, max_decoded_length_scale=8.0),
                           init_config=INIT, seed=1234, device=dev)
    rec.init_beam_search(10)
    prior = rec.net.generator.attention.prior_config()
    frames = 800
    kw = dict(beam=10, max_len=frames // 8, eol=rec.eos_label,
              ignore_first_eol=rec.data_prepend_eos, prior=prior["type"],
              before=float(prior["before"]), after=float(prior["after"]))
    result = {"card": card, "root": os.path.abspath(args.root)}
    arrays = {}
    for U in (64, 128, 256):
        feats = torch.tensor(np.random.RandomState(1).randn(U, frames, 123)
                             .astype(np.float32), device=dev)
        with torch.inference_mode():
            data = rec.net.decode_loop(feats, torch.ones(U, frames,
                                                         device=dev))
            tables = dict(rec.net.decode_loop_tables())
        loop_args = (data["pre"], data["attended"], data["attended_mask"])
        for eos_bias in ((0.0, 1.5) if U == 64 else (0.0,)):
            tab = dict(tables)
            tab["post_b"] = tables["post_b"].clone()
            tab["post_b"][rec.eos_label] += eos_bias
            out = [x.cpu().numpy()
                   for x in bl.beam_search_loop(*loop_args, tab, **kw)]
            tag = f"U{U}_eos{eos_bias}"
            for name, x in zip(("done_out", "done_meta", "steps"), out):
                arrays[f"{tag}_{name}"] = x
            if U == 64:
                again = [x.cpu().numpy()
                         for x in bl.beam_search_loop(*loop_args, tab, **kw)]
                result[f"{tag}_repeats_bits"] = all(
                    x.tobytes() == y.tobytes() for x, y in zip(out, again))
            if eos_bias == 0.0:
                ms = cuda_ms(lambda: bl.beam_search_loop(*loop_args, tab,
                                                         **kw))
                result[f"beam_search_loop_U{U}_ms"] = ms
                steps = out[2]
                print(f"beam_search_loop U={U} frames={frames} beam=10: "
                      f"{ms:.3f} ms (steps {int(steps.min())}.."
                      f"{int(steps.max())}, {ms * 1e3 / int(steps.max()):.1f}"
                      f" us a step)")
            finished = int((out[1][:, :, 1] < bl.INF / 2).any(axis=1).sum())
            repeats = result.get(f"{tag}_repeats_bits")
            print(f"  U={U} eos_bias={eos_bias}: {finished}/{U} utterances "
                  f"finished" + ("" if repeats is None else
                                 f"; a second call repeats its bits: "
                                 f"{repeats}"))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        np.savez(args.out, **arrays)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
