#!/usr/bin/env python3
"""Times the training scans' kernels on one NVIDIA GPU, alone.

    python3 tools/torch_bench_train_kernels.py [--root DIR] [--repeats N]
        [--only decoder|gru|lstm] [--decoder-plans]

Run from the repository root on a machine with a CUDA device and nvcc.
At the flagship encoder layer's shapes (T=800, D=250, ragged mask, random
weights and cotangent from numpy seeds):

* the forward kernel of ``csrc/gru_scan.cu`` through
  ``ops/gru_scan.py::launch`` (CUDA events around many launches): the
  training forward with its residuals at B=32, one direction and both,
  and the decode's scan, both directions, at B=64, 128 and 256; its states
  against the plain scan, as max abs error, and the cluster size the
  launcher chose where it chooses one;

and at B=32:

* ``gru_train_bwd_f32`` of ``csrc/gru_train.cu`` (the reverse-time
  recurrence, CUDA events around the C launcher alone), both directions in
  one launch and one direction, in ms and in us per step;
* ``outer_sum`` of ``ops/outer_sum.py`` (``csrc/outer_sum.cu``, both of its
  kernels) on the bidirectional layer's four weight-gradient jobs over
  T*B rows, beside one float32 cuBLAS ``addmm_`` per job;
* the backward kernel's dx_in, dx_gate and dh0 against autograd through
  the plain scan, as max abs error over the largest value;

the LSTM encoder's kernels at the same shapes: the forward of
``csrc/lstm_scan.cu`` through ``ops/lstm_scan.py::launch``, both
directions, at the training forward's B=32 (with the gate residuals) and
the decode's B=64, and ``lstm_train_bwd_f32`` of ``csrc/lstm_train.cu``
alone at B=32, both directions and one, each against the plain scan (the
forward's states and cells as max abs error, the backward's dx, dh0 and
dc0 against autograd as max abs error over the largest value), with the
cluster size the launcher chose where it chooses one;

and the teacher-forced decoder's two kernels of ``csrc/decoder_train.cu``
at the flagship decoder's shapes (T=100, L=200, M=250, D=500, S=250, 201
taps, the median prior, ragged masks) at B=32 and B=64 (``--decoder-batches``
to change them): each launch made
through ``ops/decoder_train.py::_launch`` repeated between CUDA events (the
kernel alone), the forward and the autograd backward around them, the
SHA-256 of the outputs' and gradients' bits (two commits' runs compute the
same numbers when they print the same digest), and the outputs against
the plain version at B=32.  With ``--decoder-plans`` the
package's launch plan is also forced to each cluster size in turn (where
the package has plans).

``--root DIR`` imports the ``attention_lvcsr_torch`` package found in DIR
instead of this checkout's, and builds its kernels there: with DIR an
unpacked copy of another commit (``git archive <commit>
attention_lvcsr_torch | tar -x -C DIR``), two runs back to back time two
versions of the kernels on the same card.  The last line is a JSON object
of the numbers.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=ROOT,
                        help="directory holding the attention_lvcsr_torch "
                             "package to time")
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--only", choices=("decoder", "gru", "lstm"),
                        default=None)
    parser.add_argument("--decoder-plans", action="store_true")
    parser.add_argument("--decoder-batches", default="32,64",
                        help="batch sizes of the decoder kernels' timings")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import gru_train as gt

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"package: {os.path.dirname(gt.__file__)}")
    lib = _build.load()
    mine = False            # ptxas lines of the timed kernels
    for line in lib.log.splitlines():
        if "Compiling entry" in line:
            mine = any(k in line for k in ("gru_bwd", "outer_sum", "gru_scan",
                                           "gru_fwd", "decoder_", "lstm_"))
        if mine and ("Compiling entry" in line or "Used" in line
                     or "spill" in line):
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda:0")
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)

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

    result = {"card": card, "root": os.path.abspath(args.root)}
    if args.only in (None, "decoder"):
        decoder_kernels(t, dev, args, result)
    if args.only in (None, "gru"):
        gru_kernels(t, dev, args, lib, result, cuda_ms)
    if args.only in (None, "lstm"):
        lstm_kernels(t, dev, lib, result, cuda_ms)
    print(json.dumps(result))


def gru_kernels(t, dev, args, lib, result, cuda_ms):
    """The GRU forward and backward kernels and outer_sum."""
    import torch
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.ops import outer_sum as osum
    T, D = 800, 250
    frng = np.random.RandomState(17)
    for B, ndir, train in ((32, 1, True), (32, 2, True), (64, 2, False),
                           (128, 2, False), (256, 2, False)):
        lengths = frng.randint(300, T + 1, size=B)
        lengths[0] = T
        fmask = t((np.arange(T)[:, None] < lengths[None]).astype(np.float32))
        proj = t(frng.randn(T, B, 3 * D * ndir) * 0.5)
        dirs = [(t(frng.randn(B, D) * 0.1),
                 t(frng.randn(D, D) / np.sqrt(D)),
                 t(frng.randn(D, 2 * D) / np.sqrt(D))) for _ in range(ndir)]
        out = torch.empty(T, B, D * ndir, device=dev)
        residuals = [tuple(torch.empty(T, B, D, device=dev)
                           for _ in range(3)) for _ in range(ndir)] \
            if train else None
        ms = cuda_ms(lambda: gs.launch(proj, fmask, dirs, out, residuals,
                                       "bench"))
        ref = gs.gru_scan_reference(proj, fmask, *dirs)
        err = float((out - ref).abs().max())
        key = f"gru_fwd_B{B}_{'train' if train else 'decode'}_{ndir}dir"
        result[f"{key}_ms"] = ms
        result[f"{key}_err"] = err
        plan = ""
        if hasattr(gs, "launch_plan"):
            p = gs.launch_plan(D, B, ndir, dev)
            result[f"{key}_cluster"] = p["cluster"]
            plan = (f"; {p['clusters']} clusters of {p['cluster']} blocks "
                    f"(co-resident at most: {p['active']})")
        print(f"gru_scan forward T={T} B={B} D={D} ndir={ndir}"
              f"{' with residuals' if train else ''}: {ms:.3f} ms "
              f"({ms * 1e3 / T:.2f} us a step), states vs plain {err:.2e}"
              f"{plan}")

    rng = np.random.RandomState(11)
    B = 32
    lengths = rng.randint(300, T + 1, size=B)
    lengths[0] = T
    mask = t((np.arange(T)[:, None] < lengths[None, :]).astype(np.float32))
    for ndir in (2, 1):
        proj = t(rng.randn(T, B, 3 * D * ndir) * 0.5)
        dirs = [(t(rng.randn(B, D) * 0.1), t(rng.randn(D, D) / np.sqrt(D)),
                 t(rng.randn(D, 2 * D) / np.sqrt(D))) for _ in range(ndir)]
        cot = t(rng.randn(T, B, D * ndir))
        out = torch.empty(T, B, D * ndir, device=dev)
        residuals = [tuple(torch.empty(T, B, D, device=dev)
                           for _ in range(3)) for _ in range(ndir)]
        gs.launch(proj, mask, dirs, out, residuals, "bench")
        dproj = torch.empty(T, B, 3 * D * ndir, device=dev)
        dh0s = [torch.empty(B, D, device=dev) for _ in range(ndir)]
        kargs = gt._BwdArgs(mask=mask.data_ptr(), T=T, B=B, D=D,
                            ld_dout=D * ndir, ld_states=D * ndir,
                            ld_dproj=3 * D * ndir)
        for i, ((h0, ws, wg), (u, r, c), dh0) in enumerate(
                zip(dirs, residuals, dh0s)):
            kargs.dir[i] = gt._BwdDir(
                cot[..., D * i:].data_ptr(), out[..., D * i:].data_ptr(),
                h0.data_ptr(), u.data_ptr(), r.data_ptr(), c.data_ptr(),
                ws.data_ptr(), wg.data_ptr(),
                dproj[..., 3 * D * i:].data_ptr(),
                dproj[..., 3 * D * i + D:].data_ptr(), dh0.data_ptr(),
                reverse=i)
        fn = lib.lib.gru_train_bwd_f32
        fn.argtypes = [ctypes.POINTER(gt._BwdArgs), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = _build.stream_of(out)

        def backward():
            _build.check(fn(ctypes.byref(kargs), ndir, stream),
                         "gru_train_bwd_f32")

        ms = cuda_ms(backward)
        # the kernel's outputs vs autograd through the plain scan
        leaves = [x.detach().requires_grad_()
                  for x in [proj] + [w for d in dirs for w in d]]
        ref = gt.gru_scan_train_reference(
            leaves[0], mask, tuple(leaves[1:4]),
            tuple(leaves[4:7]) if ndir == 2 else None)
        gref = torch.autograd.grad(ref, leaves, cot)
        err = max(float((dproj - gref[0]).abs().max() / gref[0].abs().max()),
                  *[float((dh0 - gref[1 + 3 * i]).abs().max()
                          / gref[1 + 3 * i].abs().max())
                    for i, dh0 in enumerate(dh0s)])
        key = "bidir" if ndir == 2 else "one_direction"
        result[f"gru_bwd_{key}_ms"] = ms
        result[f"gru_bwd_{key}_us_per_step"] = ms * 1e3 / T
        result[f"gru_bwd_{key}_rel_err"] = err
        print(f"gru_train_bwd_f32 T={T} B={B} D={D} ndir={ndir}: {ms:.3f} ms "
              f"({ms * 1e3 / T:.2f} us a step); dx/dh0 vs plain {err:.2e} of "
              f"the largest value")

    dproj = t(rng.randn(T, B, 6 * D))
    h_prev = [t(rng.randn(T, B, D) * 0.5) for _ in range(2)]
    r = [t(rng.rand(T, B, D)) for _ in range(2)]
    jobs = [job for i in range(2) for job in (
        (h_prev[i], r[i], dproj[..., 3 * D * i:3 * D * i + D],
         torch.zeros(D, D, device=dev)),
        (h_prev[i], None, dproj[..., 3 * D * i + D:3 * D * (i + 1)],
         torch.zeros(D, 2 * D, device=dev)))]
    flat = [(a.view(T * B, D), None if a2 is None else a2.view(T * B, D),
             b.reshape(T * B, b.shape[-1]), c) for a, a2, b, c in jobs]

    def library():
        for a, a2, b, c in flat:
            c.addmm_((a if a2 is None else a * a2).T, b)

    result["outer_sum_ms"] = cuda_ms(lambda: osum.outer_sum(jobs, dproj))
    result["addmm_per_job_ms"] = cuda_ms(library)
    result["outer_sum_again_ms"] = cuda_ms(lambda: osum.outer_sum(jobs, dproj))
    print(f"outer_sum, 4 jobs over {T * B} rows: {result['outer_sum_ms']:.4f} "
          f"ms, again {result['outer_sum_again_ms']:.4f} ms; one addmm_ per "
          f"job {result['addmm_per_job_ms']:.4f} ms")


def lstm_kernels(t, dev, lib, result, cuda_ms):
    """The LSTM forward kernel at B=32 (training) and B=64 (decode) and the
    backward kernel alone at B=32."""
    import torch
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import lstm_scan as ls
    from attention_lvcsr_torch.ops import lstm_train as lt
    T, D = 800, 250
    rng = np.random.RandomState(16)

    def operands(B, ndir):
        lengths = rng.randint(300, T + 1, size=B)
        lengths[0] = T
        mask = t((np.arange(T)[:, None] < lengths[None]).astype(np.float32))
        dirs = [(t(rng.randn(B, D) * 0.1), t(rng.randn(B, D) * 0.1),
                 t(rng.randn(D, 4 * D) / np.sqrt(D)), t(rng.randn(D) * 0.1),
                 t(rng.randn(D) * 0.1), t(rng.randn(D) * 0.1))
                for _ in range(ndir)]
        return t(rng.randn(T, B, 4 * D * ndir) * 0.5), mask, dirs

    def forward(proj, mask, dirs, train):
        B, ndir = proj.shape[1], len(dirs)
        states = torch.empty(T, B, D * ndir, device=dev)
        cells = torch.empty_like(states)
        residuals = [tuple(torch.empty(T, B, D, device=dev)
                           for _ in range(4)) for _ in range(ndir)] \
            if train else None
        run = lambda: ls.launch(proj, mask, dirs, states, cells, residuals,
                                "bench")
        return run, states, cells, residuals

    for B, train in ((32, True), (64, False)):
        proj, mask, dirs = operands(B, 2)
        run, states, cells, _ = forward(proj, mask, dirs, train)
        ms = cuda_ms(run)
        ref = ls.lstm_scan_reference(proj, mask, *dirs)
        err = max(float((states - ref[0]).abs().max()),
                  float((cells - ref[1]).abs().max()))
        key = f"lstm_fwd_B{B}_{'train' if train else 'decode'}_2dir"
        result[f"{key}_ms"] = ms
        result[f"{key}_err"] = err
        plan = ""
        if hasattr(ls, "launch_plan"):
            p = ls.launch_plan(D, B, 2, dev)
            result[f"{key}_cluster"] = p["cluster"]
            plan = (f"; {p['clusters']} clusters of {p['cluster']} blocks "
                    f"(co-resident at most: {p['active']})")
        print(f"lstm_scan forward T={T} B={B} D={D} ndir=2"
              f"{' with residuals' if train else ''}: {ms:.3f} ms "
              f"({ms * 1e3 / T:.2f} us a step), states and cells vs plain "
              f"{err:.2e}{plan}", flush=True)

    B = 32
    fn = lib.lib.lstm_train_bwd_f32
    fn.argtypes = [ctypes.POINTER(lt._BwdArgs), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for ndir in (2, 1):
        proj, mask, dirs = operands(B, ndir)
        run, states, cells, residuals = forward(proj, mask, dirs, True)
        run()
        cot = t(rng.randn(T, B, D * ndir))
        dproj = torch.empty(T, B, 4 * D * ndir, device=dev)
        dh0s = [torch.empty(B, D, device=dev) for _ in range(ndir)]
        dc0s = [torch.empty(B, D, device=dev) for _ in range(ndir)]
        dpeep = [torch.empty(B, 3 * D, device=dev) for _ in range(ndir)]
        kargs = lt._BwdArgs(mask=mask.data_ptr(), T=T, B=B, D=D,
                            ld_dout=D * ndir, ld_states=D * ndir,
                            ld_dx=4 * D * ndir)
        for i, ((_, c0, ws, pci, pcf, pco), gates) in enumerate(
                zip(dirs, residuals)):
            kargs.dir[i] = lt._BwdDir(
                cot[..., D * i:].data_ptr(), None,
                cells[..., D * i:].data_ptr(), c0.data_ptr(),
                *(g.data_ptr() for g in gates), ws.data_ptr(),
                pci.data_ptr(), pcf.data_ptr(), pco.data_ptr(),
                dproj[..., 4 * D * i:].data_ptr(), dh0s[i].data_ptr(),
                dc0s[i].data_ptr(), dpeep[i].data_ptr(), reverse=i)
        stream = _build.stream_of(states)

        def backward():
            _build.check(fn(ctypes.byref(kargs), ndir, stream),
                         "lstm_train_bwd_f32")

        ms = cuda_ms(backward)
        leaves = [x.detach().requires_grad_()
                  for x in [proj] + [w for d in dirs for w in d]]
        ref = lt.lstm_scan_train_reference(
            leaves[0], mask, tuple(leaves[1:7]),
            tuple(leaves[7:]) if ndir == 2 else None)
        gref = torch.autograd.grad(ref[0], leaves, cot)
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
        err = max(rel(dproj, gref[0]),
                  *[rel(g, gref[1 + 6 * i + k]) for i in range(ndir)
                    for k, g in enumerate((dh0s[i], dc0s[i]))])
        key = "bidir" if ndir == 2 else "one_direction"
        result[f"lstm_bwd_{key}_ms"] = ms
        result[f"lstm_bwd_{key}_us_per_step"] = ms * 1e3 / T
        result[f"lstm_bwd_{key}_rel_err"] = err
        print(f"lstm_train_bwd_f32 T={T} B={B} D={D} ndir={ndir}: {ms:.3f} "
              f"ms ({ms * 1e3 / T:.2f} us a step); dx/dh0/dc0 vs plain "
              f"{err:.2e} of the largest value", flush=True)


def decoder_kernels(t, dev, args, result):
    """decoder_train.cu's forward and backward kernels alone, at B=32 and
    B=64, and through the autograd Function."""
    import torch
    from attention_lvcsr_torch.ops import decoder_train as dt
    T, L, M, D, S, taps = 100, 200, 250, 500, 250, 201
    prior = {"type": "window_around_median", "before": 100, "after": 100}
    launch, plan_of = dt._launch, getattr(dt, "launch_plan", None)
    times = {}

    def timed(name, kargs, stream_of):
        launch(name, kargs, stream_of)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.repeats):
            launch(name, kargs, stream_of)
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / args.repeats

    def events_ms(fn, repeats=3):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / repeats

    for B in map(int, args.decoder_batches.split(",")):
        plans = [None]
        if args.decoder_plans and hasattr(dt, "plan"):
            # each cluster size over all the clusters the card holds, and
            # 8-block clusters over as few as take the same rows a cluster
            active = dt.max_active_clusters("forward", dev)
            plans += [{"cluster": C} for C in dt.CLUSTERS]
            plans.append({"cluster": 8,
                          "clusters": -(-B // -(-B // active[8]))})
        rng = np.random.RandomState(12)
        f = lambda *s, scale=1.0: t(rng.randn(*s) * scale)
        labels = rng.randint(T // 2, T + 1, size=B)
        frames = rng.randint(L // 2, L + 1, size=B)
        labels[0], frames[0] = T, L
        mask = t((np.arange(T)[:, None] < labels[None]).astype(np.float32))
        amask = t((np.arange(L)[None] < frames[:, None]).astype(np.float32))
        w0 = torch.zeros(B, L, device=dev)
        w0[:, 0] = 1.0
        leaves = [f(T, B, S), f(T, B, 2 * S), f(B, L, M, scale=0.5),
                  f(B, L, D, scale=0.5), f(B, S, scale=0.1),
                  torch.zeros(B, D, device=dev),
                  dt.toeplitz_band(f(1, taps, scale=0.1), L),
                  f(S, M, scale=0.1), f(1, M, scale=0.1), f(M, scale=0.1),
                  f(S, S, scale=1 / np.sqrt(S)),
                  f(S, 2 * S, scale=1 / np.sqrt(S)), f(D, S, scale=0.05),
                  f(D, 2 * S, scale=0.05)]
        cots = [f(T, B, S), f(T, B, L), f(T, B, D)]

        def scan(fn):
            return lambda fx, fg, pre, att, h0, wa0, *w: fn(
                fx, fg, mask, pre, att, amask, h0, w0, wa0, *w, prior=prior)

        def run(fn):
            xs = [x.detach().requires_grad_() for x in leaves]
            outs = fn(*xs)
            return outs, xs, torch.autograd.grad(outs[:3], xs, cots,
                                                 retain_graph=True)

        for force in plans:
            tag = "" if force is None else f"_C{force['cluster']}" + (
                f"x{force['clusters']}" if "clusters" in force else "")
            if force is not None:         # every launch takes this plan
                dt.launch_plan = lambda *a, **k: plan_of(*a, **k, **force)
            try:
                dt._launch = timed
                times.clear()
                outs, xs, grads = run(scan(dt.decoder_scan_train))
            except NotImplementedError as exc:
                print(f"decoder B={B} plan {force}: refused ({exc})")
                continue
            finally:
                dt._launch = launch
                if force is not None:
                    dt.launch_plan = plan_of
            key = f"decoder_B{B}{tag}"
            result[f"{key}_fwd_kernel_ms"] = times["decoder_train_fwd_f32"]
            result[f"{key}_bwd_kernel_ms"] = times["decoder_train_bwd_f32"]
            plan = ""
            if hasattr(dt, "launch_plan"):
                p = {k: dt.launch_plan(k, B, L, M, D, S, dev, **(force or {}))
                     for k in dt.KINDS}
                result[f"{key}_plan"] = p
                plan = "; plans " + ", ".join(
                    f"{k}: {q['clusters']} clusters of {q['cluster']} "
                    f"({q['blocks']} blocks, {q['rows']} rows, "
                    f"resident {({t: q[f'res_{t}'] for t in dt.TILES[k]})})"
                    for k, q in p.items())
            if force is None:
                # the bits of the outputs and every gradient, so that two
                # commits' runs say whether they compute the same numbers
                digest = hashlib.sha256()
                for x in [o.detach() for o in outs[:4]] + list(grads):
                    digest.update(x.cpu().numpy().tobytes())
                result[f"{key}_sha256"] = digest.hexdigest()
                plan += f"; bits {digest.hexdigest()[:16]}"
                fwd = scan(dt.decoder_scan_train)
                result[f"{key}_fwd_ms"] = events_ms(lambda: fwd(*leaves))
                result[f"{key}_bwd_ms"] = events_ms(
                    lambda: torch.autograd.grad(outs[:3], xs, cots,
                                                retain_graph=True))
            err = ""
            if B == 32:
                ref, _, gref = run(scan(dt.decoder_scan_train_reference))
                rel = max(float((a - b).abs().max() / b.abs().max())
                          for a, b in zip([o.detach() for o in outs[:4]]
                                          + list(grads),
                                          [o.detach() for o in ref[:4]]
                                          + list(gref)))
                result[f"{key}_rel_err"] = rel
                err = f"; outputs and gradients vs plain {rel:.2e}"
            print(f"decoder_scan_train T={T} B={B}{tag}: forward kernel "
                  f"{result[f'{key}_fwd_kernel_ms']:.3f} ms, backward kernel "
                  f"{result[f'{key}_bwd_kernel_ms']:.3f} ms"
                  + (f"; forward {result[f'{key}_fwd_ms']:.3f} ms, autograd "
                     f"backward {result[f'{key}_bwd_ms']:.3f} ms"
                     if force is None else "") + plan + err, flush=True)


if __name__ == "__main__":
    main()
