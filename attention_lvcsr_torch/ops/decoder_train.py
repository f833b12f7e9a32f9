"""Differentiable teacher-forced attention-decoder scan: the CUDA kernels'
wrapper and its plain version.

Counterpart of ``attention_lvcsr_tpu/ops/pallas/decoder_train.py::
decoder_scan_train`` (:839): the whole label-time loop of
``SequenceGenerator.evaluate`` (windowed prior, Toeplitz convolution of
the previous weights, match / tanh / energies, normalizer, weighted
average and the GRU transition), same arguments and outputs.

* :func:`decoder_scan_train_reference`, the plain version, covers what the
  TPU kernel covers: content-only attention (``n_filters=0``), 1-16 conv
  filters, the softmax, logistic and relu normalizers, the expanding,
  ``window_around_mean`` and ``window_around_median`` priors and stacked
  GRU decoders (``dec_stack`` up to 4).  Autograd takes its gradient.
* On a CUDA tensor :func:`decoder_scan_train` is a
  ``torch.autograd.Function`` over ``csrc/decoder_train.cu`` for the
  flagship variant (one conv filter, softmax, expanding or median prior,
  one GRU layer): a forward kernel, then a reverse-time backward kernel
  that recomputes each step's (B, L, M) match tensor from the previous
  state and weights instead of storing it, then ``csrc/outer_sum.cu`` for
  the weight gradients (whose two kernels count on
  ``outer_sum.launches``).  Other variants
  raise ``NotImplementedError`` naming the variant.

The window of the ``window_around_*`` priors spans the whole batch: its
bounds are the min / max of every row's bounds, as in the JAX package's
XLA scan and in its TPU kernel whenever the kernel's batch block is the
batch.  The CUDA forward records each step's bounds and the backward reads
them, so the gradient is the exact gradient of the forward.  The median of
a row is ``max(0, below - 1)`` with ``below`` the number of frames whose
running sum stays under 0.5 (the TPU kernel's rule).  Masked steps keep the
previous values by selection, not arithmetic, so a NaN of a masked row
does not leak.
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build
from attention_lvcsr_torch.ops.outer_sum import outer_sum

NEG = -1e30
launches = _build.LaunchCounter()   # forward + backward; outer_sum has its own


def toeplitz_band(filters, length):
    """(L, L) band with ``T[i, l] = filter[n + l - i]`` inside it, zero
    outside: ``weights @ T`` is the reference's trimmed full convolution.
    Differentiable in the taps (``decode_score.py::toeplitz_band`` :149)."""
    taps = filters.reshape(-1)
    n = (taps.shape[0] - 1) // 2
    pos = torch.arange(length, device=taps.device)
    offset = pos[None, :] - pos[:, None] + n
    inside = (offset >= 0) & (offset < taps.shape[0])
    return torch.where(inside, taps[offset.clamp(0, taps.shape[0] - 1)],
                       taps.new_zeros(()))


def prior_config(prior):
    p = dict(prior)
    return dict(
        prior=p.get("type", "expanding"),
        before=float(p.get("before", 0.0)), after=float(p.get("after", 0.0)),
        initial_begin=float(p.get("initial_begin", 0.0)),
        initial_end=float(p.get("initial_end", 1e4)),
        min_speed=float(p.get("min_speed", 0.0)),
        max_speed=float(p.get("max_speed", 0.0)))


def step_zero(mask):
    """The expanding prior's step counter: the number of unmasked steps
    row 0 has seen before each step (int32, (T,))."""
    c = torch.cumsum(mask[:, 0], dim=0)
    return torch.cat([c.new_zeros(1), c[:-1]]).to(torch.int32)


def _window(w, step0, amask, cfg):
    """(global mask (1, L), combined (B, L), bounds (2,)) of one step."""
    B, L = w.shape
    f32 = torch.float32
    pos = torch.arange(L, device=w.device, dtype=f32)
    if cfg["prior"] == "expanding":
        s = step0.to(f32)
        begin = torch.floor(torch.clamp(
            cfg["initial_begin"] + s * cfg["min_speed"], 0.0, L - 1.0))
        end = torch.ceil(torch.clamp(
            cfg["initial_end"] + s * cfg["max_speed"], 0.0, float(L)))
        gmask = ((pos >= begin) & (pos < end)).to(f32)[None]
        return gmask, gmask * amask, torch.stack([begin, end])
    if cfg["prior"] == "window_around_mean":
        expected = (w * pos).sum(dim=1)
    elif cfg["prior"] == "window_around_median":
        below = (torch.cumsum(w, dim=1) < 0.5).sum(dim=1).to(f32)
        expected = torch.clamp(below - 1.0, min=0.0)
    else:
        raise ValueError(f"unknown prior {cfg['prior']!r}")
    begins = torch.floor(expected - cfg["before"])
    ends = torch.ceil(expected + cfg["after"])
    gb = torch.floor(torch.clamp(begins.min(), min=0.0))
    ge = torch.ceil(torch.clamp(ends.max(), max=float(L)))
    gmask = ((pos >= gb) & (pos < ge)).to(f32)[None]
    additional = ((pos > begins[:, None]) & (pos < ends[:, None])).to(f32)
    return gmask, gmask * additional * amask, torch.stack([gb, ge])


def _attend(h, w, pre, att, amask, toep, st, hand, v, e_b, step0, cfg):
    """One attention step: (wnew, wa_new, energies, gmask)."""
    L = att.shape[1]
    with torch.no_grad():
        gmask, combined, _ = _window(w.detach(), step0, amask, cfg)
    sp = h @ st
    match = pre + sp[:, None, :]
    if cfg["n_filters"]:
        conv = (w * gmask) @ toep                       # (B, Fh * L)
        for f in range(cfg["n_filters"]):
            match = match + conv[:, f * L:(f + 1) * L, None] * hand[f]
    match = torch.tanh(match)
    energies = (match * v).sum(dim=2) + e_b
    if cfg["normalizer"] == "softmax":
        masked = torch.where(gmask > 0, energies, NEG)
        mx = masked.max(dim=1, keepdim=True).values
        mx = torch.where(mx > NEG / 2, mx, 0.0)
        unnorm = torch.exp(energies - mx) * combined
    elif cfg["normalizer"] == "logistic":
        unnorm = torch.sigmoid(energies) * combined
    elif cfg["normalizer"] == "relu":
        unnorm = torch.clamp(energies / 1000.0, min=0.0) * combined
    else:
        raise ValueError(f"unknown normalizer {cfg['normalizer']!r}")
    denom = unnorm.sum(dim=1, keepdim=True) + (
        combined.sum(dim=1, keepdim=True) == 0).to(energies.dtype)
    wnew = unnorm / denom
    wa_new = torch.bmm(wnew[:, None, :], att)[:, 0]
    return wnew, wa_new, energies, gmask


def decoder_scan_train_reference(fx, fg, mask, pre, attended, att_mask, h0,
                                 w0, wa0, toep, st, hand, v, wss, wsg, dxm,
                                 dgm, *, prior, e_bias=None,
                                 normalizer="softmax", n_filters=1,
                                 dec_stack=1, inter_in=None,
                                 inter_gate=None):
    """Plain version of :func:`decoder_scan_train`, same arguments."""
    T, B, NS = fx.shape
    N = int(dec_stack)
    S = NS // N
    if mask is None:
        mask = fx.new_ones(T, B)
    e_b = e_bias.reshape(()) if e_bias is not None else fx.new_zeros(())
    hand = hand.reshape(-1, hand.shape[-1])
    cfg = dict(prior_config(prior), normalizer=normalizer,
               n_filters=int(n_filters))
    step0 = step_zero(mask)
    h, w, wa = h0, w0, wa0
    e_keep = fx.new_zeros(B, pre.shape[1])
    outs = []
    for t in range(T):
        wnew, wa_new, energies, gmask = _attend(
            h, w, pre, attended, att_mask, toep, st, hand, v, e_b, step0[t],
            cfg)
        parts, below = [], None
        for ly in range(N):
            s1, s2 = slice(ly * S, (ly + 1) * S), slice(ly * 2 * S,
                                                        (ly + 1) * 2 * S)
            h_ly = h[:, s1]
            g_in = fg[t][:, s2] + wa_new @ dgm[:, s2]
            x_in = fx[t][:, s1] + wa_new @ dxm[:, s1]
            if ly > 0:
                g_in = g_in + below @ inter_gate[:, (ly - 1) * 2 * S:
                                                 ly * 2 * S]
                x_in = x_in + below @ inter_in[:, (ly - 1) * S:ly * S]
            gates = torch.sigmoid(h_ly @ wsg[:, s2] + g_in)
            u, r = gates[:, :S], gates[:, S:]
            cand = torch.tanh((h_ly * r) @ wss[:, s1] + x_in)
            below = u * cand + (1.0 - u) * h_ly
            parts.append(below)
        h_new = parts[0] if N == 1 else torch.cat(parts, dim=1)
        m = (mask[t] > 0.5)[:, None]
        h = torch.where(m, h_new, h)
        w = torch.where(m, wnew, w)
        wa = torch.where(m, wa_new, wa)
        e_keep = torch.where(m, energies * gmask, e_keep)
        outs.append((h, w, wa, e_keep))
    return tuple(torch.stack(seq) for seq in zip(*outs))


# --------------------------------------------------------------------------
# the CUDA route
# --------------------------------------------------------------------------

class _Args(ctypes.Structure):
    """Mirror of ``struct DecoderArgs`` in csrc/decoder_train.cu."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "fx", "fg", "mask", "step0", "pre", "att", "amask", "h0", "w0",
            "wa0", "toep", "st", "hand", "v", "wss", "wsg", "dxm", "dgm",
            "h_out", "w_out", "wa_out", "e_out", "u_out", "r_out", "c_out",
            "bounds", "exch", "barrier",
            "dh", "dw", "dwa", "dfx", "dfg", "dh0", "dwa0", "dpre", "datt",
            "dsp", "wg", "dconv", "dhand", "dv", "wss_t", "wsg_t", "dxm_t",
            "dgm_t", "st_t", "toep_t")]
        + [(name, ctypes.c_int) for name in (
            "T", "B", "L", "M", "D", "S", "prior_median")]
        + [(name, ctypes.c_float) for name in (
            "before", "after", "initial_begin", "initial_end", "min_speed",
            "max_speed")])


def unported_variant(normalizer, n_filters, dec_stack, prior_type):
    """The first piece of a decoder variant the CUDA kernel does not cover,
    or None."""
    for ok, piece in (
            (int(n_filters) == 1, f"{n_filters} conv filters"),
            (normalizer == "softmax", f"the {normalizer!r} normalizer"),
            (int(dec_stack) == 1, f"dec_stack={dec_stack}"),
            (prior_type in ("expanding", "window_around_median"),
             f"the {prior_type!r} prior")):
        if not ok:
            return piece
    return None


def _check(name, t, shape, device, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"decoder_scan_train: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"decoder_scan_train: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"decoder_scan_train: {name} must be contiguous")
    if t.device != device:
        raise ValueError(f"decoder_scan_train: {name} is on {t.device}, "
                         f"expected {device}")


def _launch(name, args, stream_of):
    lib = _build.load().lib
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(stream_of.device):
        status = fn(ctypes.byref(args), _build.stream_of(stream_of))
    if status == -1:
        raise NotImplementedError(
            f"decoder_scan_train: a batch of {args.B} rows at L={args.L}, "
            f"M={args.M}, D={args.D}, S={args.S} does not fit one "
            f"co-resident wave of blocks (one block per row), or its "
            f"buffers exceed a block's shared memory")
    _build.check(status, name)


def _ptr(t):
    return t.data_ptr() if t is not None else None


class _DecoderScanTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg, fx, fg, mask, step0, pre, att, amask, h0, w0, wa0,
                toep, st, hand, v, wss, wsg, dxm, dgm):
        T, B, S = fx.shape
        L, M, D = pre.shape[1], pre.shape[2], att.shape[2]
        new = lambda *s: torch.empty(*s, dtype=fx.dtype, device=fx.device)
        outs = dict(h_out=new(T, B, S), w_out=new(T, B, L),
                    wa_out=new(T, B, D), e_out=new(T, B, L),
                    u_out=new(T, B, S), r_out=new(T, B, S),
                    c_out=new(T, B, S), bounds=new(max(T, 1), 2),
                    exch=new(2, 2 * B))
        barrier = torch.zeros(2, dtype=torch.int32, device=fx.device)
        ins = dict(fx=fx, fg=fg, mask=mask, step0=step0, pre=pre, att=att,
                   amask=amask, h0=h0, w0=w0, wa0=wa0, toep=toep, st=st,
                   hand=hand, v=v, wss=wss, wsg=wsg, dxm=dxm, dgm=dgm)
        args = _Args(**{k: _ptr(t) for k, t in {**ins, **outs}.items()},
                     barrier=barrier.data_ptr(), T=T, B=B, L=L, M=M, D=D,
                     S=S, prior_median=int(cfg["prior"] != "expanding"),
                     **{k: cfg[k] for k in (
                         "before", "after", "initial_begin", "initial_end",
                         "min_speed", "max_speed")})
        if T and B:
            _launch("decoder_train_fwd_f32", args, fx)
            launches.count += 1
        ctx.cfg = cfg
        ctx.save_for_backward(*ins.values(), *outs.values())
        return (outs["h_out"], outs["w_out"], outs["wa_out"], outs["e_out"])

    @staticmethod
    def backward(ctx, dh, dw, dwa, _de):
        saved = ctx.saved_tensors
        (fx, fg, mask, step0, pre, att, amask, h0, w0, wa0, toep, st, hand,
         v, wss, wsg, dxm, dgm) = saved[:18]
        (h_out, w_out, wa_out, e_out, u_out, r_out, c_out, bounds,
         exch) = saved[18:]
        cfg = ctx.cfg
        T, B, S = fx.shape
        L, M, D = pre.shape[1], pre.shape[2], att.shape[2]
        new = lambda *s: torch.empty(*s, dtype=fx.dtype, device=fx.device)
        zeros = lambda *s: torch.zeros(*s, dtype=fx.dtype, device=fx.device)
        cot = lambda g, *s: g.contiguous() if g is not None else zeros(*s)
        dh, dw, dwa = cot(dh, T, B, S), cot(dw, T, B, L), cot(dwa, T, B, D)
        g = dict(dfx=new(T, B, S), dfg=new(T, B, 2 * S), dh0=new(B, S),
                 dwa0=new(B, D), dpre=zeros(B, L, M), datt=zeros(B, L, D),
                 dsp=new(T, B, M), wg=new(T, B, L), dconv=new(T, B, L),
                 dhand=new(B, M), dv=new(B, M))
        ins = dict(fx=fx, fg=fg, mask=mask, step0=step0, pre=pre, att=att,
                   amask=amask, h0=h0, w0=w0, wa0=wa0, toep=toep, st=st,
                   hand=hand, v=v, wss=wss, wsg=wsg, dxm=dxm, dgm=dgm,
                   h_out=h_out, w_out=w_out, wa_out=wa_out, e_out=e_out,
                   u_out=u_out, r_out=r_out, c_out=c_out, bounds=bounds,
                   dh=dh, dw=dw, dwa=dwa,
                   **{f"{k}_t": w.t().contiguous() for k, w in (
                       ("wss", wss), ("wsg", wsg), ("dxm", dxm),
                       ("dgm", dgm), ("st", st), ("toep", toep))})
        args = _Args(**{k: _ptr(t) for k, t in {**ins, **g}.items()},
                     T=T, B=B, L=L, M=M, D=D, S=S,
                     prior_median=int(cfg["prior"] != "expanding"),
                     **{k: cfg[k] for k in (
                         "before", "after", "initial_begin", "initial_end",
                         "min_speed", "max_speed")})
        w_grads = dict(dtoep=zeros(L, L), dst=zeros(S, M), dwss=zeros(S, S),
                       dwsg=zeros(S, 2 * S), ddx=zeros(D, S),
                       ddg=zeros(D, 2 * S), dhand=zeros(1, M), dv=zeros(1, M))
        if T and B:
            _launch("decoder_train_bwd_f32", args, fx)
            launches.count += 1
            h_prev = torch.cat([h0[None], h_out[:-1]])
            ones = fx.new_ones(B, 1)      # the rows' dhand, dv summed over B
            outer_sum([
                (g["wg"], None, g["dconv"], w_grads["dtoep"]),
                (h_prev, None, g["dsp"], w_grads["dst"]),
                (h_prev, r_out, g["dfx"], w_grads["dwss"]),
                (h_prev, None, g["dfg"], w_grads["dwsg"]),
                (wa_out, None, g["dfx"], w_grads["ddx"]),
                (wa_out, None, g["dfg"], w_grads["ddg"]),
                (ones, None, g["dhand"], w_grads["dhand"]),
                (ones, None, g["dv"], w_grads["dv"])], fx)
        else:
            for k in ("dfx", "dfg", "dh0", "dwa0"):
                g[k].zero_()
        return (None, g["dfx"], g["dfg"], None, None, g["dpre"], g["datt"],
                None, g["dh0"], None, g["dwa0"], w_grads["dtoep"],
                w_grads["dst"], w_grads["dhand"], w_grads["dv"].view(M),
                w_grads["dwss"], w_grads["dwsg"], w_grads["ddx"],
                w_grads["ddg"])


def decoder_scan_train(fx, fg, mask, pre, attended, att_mask, h0, w0, wa0,
                       toep, st, hand, v, wss, wsg, dxm, dgm, *, prior,
                       e_bias=None, normalizer="softmax", n_filters=1,
                       dec_stack=1, inter_in=None, inter_gate=None):
    """Differentiable attention-decoder scan.

    fx (T, B, S) / fg (T, B, 2S): fork projections of the fed-back labels
    (bias included); mask (T, B) or None; pre (B, L, M) preprocessed keys;
    attended (B, L, D); att_mask (B, L); h0 / w0 / wa0 initial state,
    alignment and weighted average; toep (L, max(n_filters, 1) * L) the
    Toeplitz bands of the conv taps (filter-major); st (S * dec_stack, M)
    state transform; hand (max(n_filters, 1), M) conv handler rows; v (M,)
    energy vector; e_bias the energy bias of the non-softmax normalizers;
    wss / wsg the GRU matrices and dxm / dgm the distribute matrices, each
    lane-stacked over the layers; inter_in / inter_gate the interlayer
    projections of a stacked decoder.  Returns (h, weights, weighted
    averages, energies), each (T, B, .), mask-mixed by selection."""
    device = fx.device
    if device.type == "cpu":
        return decoder_scan_train_reference(
            fx, fg, mask, pre, attended, att_mask, h0, w0, wa0, toep, st,
            hand, v, wss, wsg, dxm, dgm, prior=prior, e_bias=e_bias,
            normalizer=normalizer, n_filters=n_filters, dec_stack=dec_stack,
            inter_in=inter_in, inter_gate=inter_gate)
    if device.type != "cuda":
        raise ValueError(f"decoder_scan_train: no kernel for device {device}")
    cfg = prior_config(prior)
    piece = unported_variant(normalizer, n_filters, dec_stack, cfg["prior"])
    if piece is not None:
        raise NotImplementedError(
            f"decoder_scan_train: the CUDA kernel does not cover {piece} yet "
            f"(the plain version does, on CPU tensors)")
    T, B, S = fx.shape
    L, M = pre.shape[1], pre.shape[2]
    D = attended.shape[2]
    if mask is None:
        mask = fx.new_ones(T, B)
    for name, t, shape in (
            ("fx", fx, (T, B, S)), ("fg", fg, (T, B, 2 * S)),
            ("mask", mask, (T, B)), ("pre", pre, (B, L, M)),
            ("attended", attended, (B, L, D)), ("att_mask", att_mask, (B, L)),
            ("h0", h0, (B, S)), ("w0", w0, (B, L)), ("wa0", wa0, (B, D)),
            ("toep", toep, (L, L)), ("st", st, (S, M)),
            ("hand", hand.reshape(1, -1), (1, M)), ("v", v, (M,)),
            ("wss", wss, (S, S)), ("wsg", wsg, (S, 2 * S)),
            ("dxm", dxm, (D, S)), ("dgm", dgm, (D, 2 * S))):
        _check(name, t, shape, device)
    return _DecoderScanTrain.apply(
        cfg, fx, fg, mask, step_zero(mask), pre, attended, att_mask, h0, w0,
        wa0, toep, st, hand.reshape(1, M), v, wss, wsg, dxm, dgm)
