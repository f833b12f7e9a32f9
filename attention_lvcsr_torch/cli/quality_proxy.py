"""End-to-end quality proxy on the port: synthetic language -> LG_pushed
-> train -> decode with and without LM fusion -> a QUALITY json.

The port's copy of ``tools/quality_proxy.py``, with no JAX:

1. generate a synthetic word language (a skewed Markov bigram chain over
   random letter-spelled words) and sample a corpus;
2. estimate a Witten-Bell trigram ARPA from the training part;
3. build the character decoding graph ``LG_pushed`` with
   ``ops/lm_graph.build_decoding_graph`` and pack it for the device;
4. render the utterances as synthetic acoustics (per-character spectral
   templates, variable durations, additive noise, and confusable letter
   pairs that the LM must tell apart);
5. train the wsj_paper-shaped model (BiGRU encoder, conv attention, an
   expanding-prior ``pretraining`` stage, then a ``main`` stage on the
   median window restarted from ``pretraining_best_ll``) through the
   port's multistage driver;
6. decode the test part without and with the LM at beam 10 (each over a
   char_discount grid) and at the wide beam, plus the batch-64 LM decode
   (``parity_point_b64``), scoring CER and WER.

The same seed gives the JAX tool's corpus, ARPA text, graph and
acoustics.  The model starts from the port's own initialization, so its
WERs compare with the JAX tool's within a band, not bit for bit.

    python -m attention_lvcsr_torch.cli.quality_proxy --tier fast \\
        --device cpu --out QUALITY.json

The decode runs on the card unless ``--device cpu`` is given.  The data
go through an H5 file (``h5py``) unless ``--in-memory`` is given: then
the rendered arrays are read by :class:`ArrayDataset` through the same
``Data`` pipeline (shuffle, sort-k-batches, padding, EOS), for a Python
without ``h5py``.  A long run splits in two with ``--skip-train``: the
second run decodes the checkpoint the first one left in ``--work``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import time

import numpy as np

LETTERS = "ABCDEFGHIJKL"

# one sizing row per tier: corpus / acoustics / model / schedule
SIZES = {
    #        n_tr  n_va n_te words len    feat fr    noise B  dim  layers          sub      ep
    "fast":   (400,  50,  50, 16, (3, 5), 12, (3, 5), 0.8, 16,  32, [32, 32],       [1, 2],    (1, 2)),
    "medium": (3000, 128, 256, 200, (4, 9), 20, (4, 7), 1.0, 32,  96, [96, 96],       [1, 2],    (3, 6)),
    "full":   (8000, 256, 256, 200, (4, 10), 40, (6, 10), 1.0, 32, 250, [250] * 4,     [1, 1, 2, 2], (2, 8)),
}

# the kernels' launch counters, read around training and each decode:
# the tiers' bidirectional layers of at most 250 units and their decodes
# (the loop kernel's resident and workspace instances without the LM, the
# energies kernel with it) reach no other kernel
TRAIN_KERNELS = ("gru_scan_train_bidir", "decoder_scan_train", "outer_sum")
DECODE_KERNELS = ("gru_scan", "beam_search_loop", "beam_search_loop_ws",
                  "beam_attention_energies")


def launch_counters():
    """The launch counter of each kernel on the proxy's paths."""
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.ops import outer_sum as osum
    return {"gru_scan_train_bidir": gt.launches_bidir,
            "decoder_scan_train": dt.launches, "outer_sum": osum.launches,
            "gru_scan": gs.launches, "beam_search_loop": bl.launches,
            "beam_search_loop_ws": bl.launches_ws,
            "beam_attention_energies": ae.launches}


def card():
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else None


# ---------------------------------------------------------------------------
# synthetic language
# ---------------------------------------------------------------------------

def make_language(rng, num_words=30, min_wlen=2, max_wlen=5,
                  branching=5):
    """Random letter-spelled words + a skewed Markov bigram sampler."""
    words = set()
    while len(words) < num_words:
        n = rng.randint(min_wlen, max_wlen + 1)
        words.add("".join(LETTERS[rng.randint(len(LETTERS))]
                          for _ in range(n)))
    words = sorted(words)
    W = len(words)
    # each word allows `branching` successors with skewed probabilities
    succ = {}
    for i in range(W + 1):                    # W = sentence start state
        nxt = rng.choice(W, size=min(branching, W), replace=False)
        logits = rng.randn(len(nxt)) * 1.5
        p = np.exp(logits)
        succ[i] = (nxt, p / p.sum())
    return words, succ


def sample_corpus(words, succ, rng, n_sentences, min_len=4, max_len=9):
    W = len(words)
    corpus = []
    for _ in range(n_sentences):
        n = rng.randint(min_len, max_len + 1)
        state, sent = W, []
        for _ in range(n):
            nxt, p = succ[state]
            state = int(nxt[rng.choice(len(nxt), p=p)])
            sent.append(words[state])
        corpus.append(sent)
    return corpus


# ---------------------------------------------------------------------------
# Witten-Bell trigram ARPA estimation
# ---------------------------------------------------------------------------

def estimate_arpa(corpus, vocab, path):
    """Interpolated Witten-Bell trigram, written as a backoff ARPA.

    With P(w|h) = (c(hw) + T(h) P_low(w|h')) / (c(h) + T(h)) for seen
    h,w and backoff weight bow(h) = T(h) / (c(h) + T(h)), the model
    normalizes exactly (T(h) = distinct continuations of h).
    """
    from collections import Counter, defaultdict
    c1, c2, c3 = Counter(), Counter(), Counter()
    for sent in corpus:
        toks = ["<s>"] + sent + ["</s>"]
        for i, w in enumerate(toks):
            c1[(w,)] += 1
            if i >= 1:
                c2[tuple(toks[i - 1:i + 1])] += 1
            if i >= 2:
                c3[tuple(toks[i - 2:i + 1])] += 1

    V = len(vocab) + 2                        # + <s>, </s>
    # unigrams: WB against a uniform prior, floor for unseen vocab
    total1 = sum(c1.values())
    T1 = len(c1)
    p1 = {}
    for w in list(vocab) + ["<s>", "</s>"]:
        p1[w] = (c1.get((w,), 0) + T1 / V) / (total1 + T1)
    # <s> is never predicted: ARPA convention gives it -99
    norm = sum(v for k, v in p1.items() if k != "<s>")
    for w in p1:
        p1[w] /= norm

    def wb(counts, lower_p):
        hist = defaultdict(list)
        for ngram, c in counts.items():
            hist[ngram[:-1]].append((ngram[-1], c))
        probs, bows = {}, {}
        for h, items in hist.items():
            ch = sum(c for _, c in items)
            Th = len(items)
            for w, c in items:
                probs[h + (w,)] = (c + Th * lower_p(h, w)) / (ch + Th)
            bows[h] = Th / (ch + Th)
        return probs, bows

    p2, bow1 = wb(c2, lambda h, w: p1[w])

    def p2_of(h, w):                          # backoff lookup P(w|h[-1])
        if (h[-1], w) in p2:
            return p2[(h[-1], w)]
        return bow1.get((h[-1],), 1.0) * p1[w]

    p3, bow2 = wb(c3, lambda h, w: p2_of(h, w))

    def lg(x):
        return round(math.log10(max(x, 1e-30)), 6)

    with open(path, "w") as f:
        f.write("\\data\\\n")
        f.write(f"ngram 1={len(p1)}\n")
        f.write(f"ngram 2={len(p2)}\n")
        f.write(f"ngram 3={len(p3)}\n\n")
        f.write("\\1-grams:\n")
        for w, p in sorted(p1.items()):
            prob = -99 if w == "<s>" else lg(p)
            bow = bow1.get((w,))
            f.write(f"{prob} {w}" + (f" {lg(bow)}" if bow else "")
                    + "\n")
        f.write("\n\\2-grams:\n")
        for ngram, p in sorted(p2.items()):
            bow = bow2.get(ngram)
            f.write(f"{lg(p)} {' '.join(ngram)}"
                    + (f" {lg(bow)}" if bow else "") + "\n")
        f.write("\n\\3-grams:\n")
        for ngram, p in sorted(p3.items()):
            f.write(f"{lg(p)} {' '.join(ngram)}\n")
        f.write("\n\\end\\\n")
    return path


# ---------------------------------------------------------------------------
# synthetic acoustics
# ---------------------------------------------------------------------------

SOURCES = ("recordings", "labels", "uttids")


def render_dataset(corpus, value_map, rng, feat_dim=40, frames_lo=6,
                   frames_hi=10, noise=1.0,
                   confusable=(("A", "B"), ("C", "D"), ("E", "F")),
                   confusion_scale=0.25, splits=None):
    """Render word sentences as (frames, feat_dim) template acoustics.

    ``confusable`` letter pairs share nearly-identical templates
    (separation ``confusion_scale`` vs the ~2.0 of distinct letters):
    the acoustic model alone confuses them; the LM's lexical knowledge
    is what resolves the right word.  Draws from ``rng`` in the JAX
    tool's order: the templates, the confusable pairs, then per
    utterance each character's duration and noise.  Returns a dict of
    ``recordings`` (float32), ``labels`` (int64), ``uttids``, ``texts``,
    ``value_map`` and ``splits`` ({name: (start, stop)}, in the order of
    ``splits``' (name, size) pairs)."""
    templates = {}
    for ch in value_map:
        if ch == "<eol>":
            continue
        templates[ch] = rng.randn(feat_dim).astype("f") * 2.0
    for a, b in confusable:
        if a in templates and b in templates:
            templates[b] = (templates[a]
                            + confusion_scale
                            * rng.randn(feat_dim).astype("f"))

    recordings, labels, uttids, texts = [], [], [], []
    for i, sent in enumerate(corpus):
        seq = []
        for w in sent:
            if seq:
                seq.append("<spc>")
            seq.extend(w)
        frames = []
        for ch in seq:
            n = rng.randint(frames_lo, frames_hi + 1)
            f = np.tile(templates[ch], (n, 1))
            frames.append(f + noise * rng.randn(*f.shape).astype("f"))
        recordings.append(np.concatenate(frames, axis=0))
        labels.append(np.asarray([value_map[ch] for ch in seq], "int64"))
        uttids.append(f"utt{i:05d}")
        texts.append(" ".join(sent))
    bounds, start = {}, 0
    for name, n in splits:
        bounds[name] = (start, start + n)
        start += n
    return {"recordings": recordings, "labels": labels, "uttids": uttids,
            "texts": texts, "value_map": dict(value_map), "splits": bounds}


def write_dataset(path, rendered):
    """The rendered arrays as the JAX tool's Fuel-layout H5 file."""
    from attention_lvcsr_torch.data.h5 import DatasetWriter
    writer = DatasetWriter(path)
    writer.add_vector_source("recordings", rendered["recordings"])
    writer.add_vector_source("labels", rendered["labels"],
                             value_map=rendered["value_map"])
    writer.add_text_source("uttids", rendered["uttids"])
    writer.set_split({name: {src: bounds for src in SOURCES}
                      for name, bounds in rendered["splits"].items()})
    writer.close()


class ArrayDataset:
    """One or more splits of rendered arrays with ``H5AudioDataset``'s
    constructor and reading interface, for ``Data(dataset_class=...)``:
    the arrays come from the class's ``rendered`` (a subclass per data
    set, :func:`array_dataset_class`), and ``file_or_path`` names them
    only.  Examples read as the H5 file gives them back: float32
    recordings, int64 labels, the uttid as bytes."""

    rendered = None

    def __init__(self, file_or_path, which_sets, sources,
                 target_source="labels"):
        self.path = file_or_path
        self.which_sets = tuple(which_sets)
        self.sources = tuple(sources)
        self.target_source = target_source
        splits = self.rendered["splits"]
        # the H5 split table's order: split names sorted
        found = [name for name in sorted(splits) if name in self.which_sets]
        if not found:
            raise ValueError(f"splits {self.which_sets} not found for "
                             f"{self.sources}")
        self._index = np.concatenate([np.arange(*splits[name])
                                      for name in found])
        self.char2num = self.character_map(target_source)
        self.num2char = {num: char for char, num in self.char2num.items()}
        self.num_characters = len(self.num2char)
        self.eos_label = self.char2num.get("<eol>")
        self.bos_label = self.char2num.get("<bol>")

    @property
    def num_examples(self) -> int:
        return len(self._index)

    def character_map(self, source):
        return dict(self.rendered["value_map"]) if source == "labels" \
            else {}

    def dim(self, source) -> int:
        first = np.asarray(self.rendered[source][0])
        return int(first.shape[1]) if first.ndim == 2 else 0

    def _value(self, source, j):
        value = self.rendered[source][j]
        if source == "uttids":
            return np.asarray(value.encode())
        return np.array(value)

    def get_example(self, i):
        j = int(self._index[i])
        return tuple(self._value(source, j) for source in self.sources)

    def example_lengths(self, source):
        return np.asarray([len(self.rendered[source][int(j)])
                           for j in self._index])

    def decode(self, labels, keep_eos=False):
        return [self.num2char[int(l)] for l in labels
                if (int(l) != self.eos_label or keep_eos)
                and int(l) != self.bos_label]


def array_dataset_class(rendered):
    """An :class:`ArrayDataset` over ``rendered`` (:func:`render_dataset`)."""
    return type("ArrayDataset", (ArrayDataset,), {"rendered": rendered})


CONFIG_TEMPLATE = """
data:
    dataset_filename: {dataset}
    name_mapping:
        train: train
        valid: valid
        test: test
    sources_map:
        recordings: recordings
        labels: labels
        uttids: uttids
    default_sources: [recordings, labels]
    batch_size: {batch_size}
    validation_batch_size: {batch_size}
    sort_k_batches: 8
    add_eos: true
    pad_multiple:
        recordings: {pad_rec}
        labels: {pad_lab}
    pad_batches: true
net:
    dim_dec: {dim}
    dims_bidir: {dims_bidir}
    subsample: {subsample}
    dim_matcher: {dim}
    attention_type: content_and_conv
    conv_n: 20
    bottom:
        bottom_class: SpeechBottom
        dims: []
    enc_transition: GatedRecurrent
    dec_transition: GatedRecurrent
    use_states_for_readout: false
    post_merge_dims: [{dim}]
    max_decoded_length_scale: 1.5
    criterion:
        name: log_likelihood
    lm: {{}}
initialization:
    /recognizer:
        weights_init: [IsotropicGaussian, 0.1]
        biases_init: [Constant, 0.0]
        rec_weights_init: [Orthogonal]
regularization:
    max_norm: 1.0
training:
    gradient_threshold: 100.0
    rules: [adadelta]
    decay_rate: 0.95
    epsilon: 1.0e-8
    seed: 1
monitoring:
    validate_every_epochs: 1
    search_every_epochs: 0
    search:
        beam_size: 10
        char_discount: 0.1
stages:
    pretraining:
        number: 0
        net:
            prior:
                type: expanding
                initial_begin: 0
                initial_end: 12
                min_speed: 0.5
                max_speed: 1.5
        training:
            num_epochs: {pretrain_epochs}
    main:
        number: 100
        net:
            prior:
                type: window_around_median
                before: 30
                after: 30
        training:
            restart_from: _best_ll
            num_epochs: {main_epochs}
"""


def load_config(path, dataset_class=None):
    """The port's ``Configuration`` of ``path``; with ``dataset_class``
    (:func:`array_dataset_class`), its data section and every stage's
    read the arrays in memory instead of the H5 file."""
    from attention_lvcsr_torch.config import Configuration
    config = Configuration(path)
    if dataset_class is not None:
        for section in [config, *config.ordered_stages.values()]:
            section["data"]["dataset_class"] = dataset_class
    return config


# ---------------------------------------------------------------------------
# decoding + scoring
# ---------------------------------------------------------------------------

def best_hypothesis(out, j):
    """The labels of utterance ``j``'s best finished hypothesis, or None
    when it has none."""
    valid = out["done_valid"][j]
    if not valid.any():
        return None
    adjusted = np.where(valid, out["done_adjusted"][j], np.inf)
    k = int(np.argmin(adjusted))
    n = int(out["done_len"][j, k])
    return [int(x) for x in out["done_out"][j, k, :n]]


def decode_and_score(recognizer, data, beam_size, search_kwargs,
                     batch=16, part="test", limit=None, outputs=None):
    """Batched beam decode of a dataset part -> CER/WER + timing.

    Every batch is padded to ONE shape (full ``batch`` rows x the part's
    longest utterance), as the JAX tool pads it: an LM decode's answer
    depends on its batch, so equal batching keeps the rows comparable.
    The first batch is decoded once more before the timed pass;
    ``compile_s`` is that first call's seconds, which include building
    the kernels at their first use.  ``outputs``, a list, receives the
    timed calls' outputs, each as (utterances of the batch, outputs).
    ``launches`` counts each decode kernel's launches over the timed
    pass."""
    from attention_lvcsr_torch.ops.error_rate import wer as wer_fn

    recognizer.init_beam_search(beam_size)
    examples = list(data.get_stream(part, batches=False, shuffle=False))
    if limit:
        examples = examples[:limit]
    stats = dict(cer_errors=0.0, cer_length=0.0, wer_errors=0.0,
                 wer_length=0.0, empty=0)
    t_decode = 0.0
    T = max(len(e["recordings"]) for e in examples)
    F = examples[0]["recordings"].shape[1]
    total_frames = sum(len(e["recordings"]) for e in examples)
    counters = launch_counters()
    before = {}
    compile_s = None
    for i in range(0, len(examples), batch):
        chunk = examples[i:i + batch]
        inputs = np.zeros((batch, T, F), np.float32)
        mask = np.zeros((batch, T), np.float32)
        for j, e in enumerate(chunk):
            t = len(e["recordings"])
            inputs[j, :t] = e["recordings"]
            mask[j, :t] = 1.0
        if compile_s is None:
            t0 = time.time()
            recognizer.beam_search(inputs, mask, as_arrays=True,
                                   **search_kwargs)
            compile_s = time.time() - t0
            before = {k: counters[k].count for k in DECODE_KERNELS}
        t0 = time.time()
        out = recognizer.beam_search(inputs, mask, as_arrays=True,
                                     **search_kwargs)
        t_decode += time.time() - t0
        if outputs is not None:
            outputs.append((len(chunk), out))
        for j, e in enumerate(chunk):
            recognized = best_hypothesis(out, j)
            if recognized is None:
                stats["empty"] += 1
                recognized = []
            gt = data.decode(np.asarray(e["labels"], np.int64))
            hyp = data.decode(recognized)
            stats["cer_errors"] += min(1.0, wer_fn(gt, hyp)
                                       if hyp else 1.0) * len(gt)
            stats["cer_length"] += len(gt)
            gt_words = "".join(" " if c == "<spc>" else c
                               for c in gt).split()
            hyp_words = "".join(" " if c == "<spc>" else c
                                for c in hyp).split()
            stats["wer_errors"] += min(1.0, wer_fn(gt_words, hyp_words)
                                       if hyp_words else 1.0) \
                * len(gt_words)
            stats["wer_length"] += len(gt_words)
    n = len(examples)
    return {
        "beam": beam_size,
        "char_discount": search_kwargs.get("char_discount"),
        "cer": round(stats["cer_errors"] / stats["cer_length"], 4),
        "wer": round(stats["wer_errors"] / stats["wer_length"], 4),
        "empty": stats["empty"],
        "utterances": n,
        "batch": batch,
        "compile_s": round(compile_s, 2) if compile_s else None,
        "decode_wall_s": round(t_decode, 2),
        "utt_per_s": round(n / t_decode, 2) if t_decode else None,
        # synthetic frames are treated as the 10 ms hop of the real
        # pipeline for a realtime factor
        "realtime_factor": (round(total_frames * 0.01 / t_decode, 1)
                            if t_decode else None),
        "launches": {k: counters[k].count - before[k]
                     for k in DECODE_KERNELS},
    }


def build(work, seed, tier, epochs=None, pad=None, in_memory=False):
    """Steps 1-4 and the config: the language, its ARPA, ``LG_pushed``,
    the acoustics (an H5 file, or in memory) and ``config.yaml`` in
    ``work``.  Returns a dict of the words, the corpus, the graph, its
    seconds, the rendered data, the config and the epochs."""
    from attention_lvcsr_torch.ops.lm_graph import build_decoding_graph

    if not in_memory:
        try:
            import h5py  # noqa: F401
        except ImportError as exc:
            raise RuntimeError(
                "the H5 data path needs h5py; pass --in-memory to read the "
                "rendered arrays in memory instead") from exc
    rng = np.random.RandomState(seed)
    os.makedirs(work, exist_ok=True)
    (n_train, n_valid, n_test, num_words, (min_len, max_len), feat_dim,
     (frames_lo, frames_hi), noise, batch_size, dim, dims_bidir,
     subsample, (pretrain_epochs, main_epochs)) = SIZES[tier]
    if epochs:
        pretrain_epochs, main_epochs = (int(x) for x in epochs.split(","))

    # 1+2: language + ARPA
    words, succ = make_language(rng, num_words=num_words)
    corpus = sample_corpus(words, succ, rng, n_train + n_valid + n_test,
                           min_len=min_len, max_len=max_len)
    arpa_path = os.path.join(work, "lm.arpa")
    estimate_arpa(corpus[:n_train], words, arpa_path)

    # symbol inventory shared by dataset and graph
    value_map = {"<spc>": 0, "<eol>": 1}
    for ch in LETTERS:
        value_map[ch] = len(value_map)

    # 3: LG_pushed, not determinized (as bin/lm2fst.sh composes the eol
    # adapter), the decoder's FST state sets handle the nondeterminism
    lm_dir = os.path.join(work, "lm")
    t0 = time.time()
    graph = build_decoding_graph(arpa_path, value_map, out_dir=lm_dir,
                                 deterministic=False,
                                 no_transition_cost=20.0)
    graph_s = time.time() - t0
    lm_npz = os.path.join(lm_dir, "LG_pushed.npz")
    print(f"LG_pushed: {graph['LG_pushed'].num_states} states "
          f"({graph_s:.1f}s) -> {lm_npz}")

    # 4: acoustics
    dataset = os.path.join(work, "synth.h5")
    rendered = render_dataset(
        corpus, value_map, rng, feat_dim=feat_dim, frames_lo=frames_lo,
        frames_hi=frames_hi, noise=noise,
        splits=(("train", n_train), ("valid", n_valid), ("test", n_test)))
    if not in_memory:
        write_dataset(dataset, rendered)

    cfg_path = os.path.join(work, "config.yaml")
    pad_rec, pad_lab = (int(x) for x in pad.split(",")) if pad else (50, 10)
    with open(cfg_path, "w") as f:
        f.write(CONFIG_TEMPLATE.format(
            dataset=os.path.abspath(dataset),
            batch_size=batch_size, dim=dim,
            dims_bidir=str(dims_bidir), subsample=str(subsample),
            pretrain_epochs=pretrain_epochs, main_epochs=main_epochs,
            pad_rec=pad_rec, pad_lab=pad_lab,
        ))
    dataset_class = array_dataset_class(rendered) if in_memory else None
    return {"words": words, "corpus": corpus, "graph": graph,
            "graph_s": graph_s,
            "arpa": arpa_path, "lm_npz": lm_npz, "rendered": rendered,
            "cfg_path": cfg_path, "dataset_class": dataset_class,
            "config": load_config(cfg_path, dataset_class),
            "n_train": n_train, "pretrain_epochs": pretrain_epochs,
            "main_epochs": main_epochs}


def train(built, save_dir, device):
    """Step 5: the stages through the port's ``train_multistage`` into
    ``save_dir``.  Returns (``train_meta``: the wall seconds, the epochs,
    the card's name and power limit and each training kernel's launches;
    the stages' main loops)."""
    from attention_lvcsr_torch.train import driver
    counters = launch_counters()
    before = {k: counters[k].count for k in TRAIN_KERNELS}
    t0 = time.time()
    loops = driver.train_multistage(built["config"], save_dir,
                                    fast_start=True, device=device)
    return {"train_wall_s": round(time.time() - t0, 1),
            "pretrain_epochs": built["pretrain_epochs"],
            "main_epochs": built["main_epochs"],
            "device": str(device),
            "card": card() if str(device).startswith("cuda") else None,
            "train_kernel_launches": {k: counters[k].count - before[k]
                                      for k in TRAIN_KERNELS}}, loops


def lm_model(built, data, checkpoint, device):
    """The recognizer of ``checkpoint`` with ``LG_pushed`` fused in
    (weight 0.5, no_transition_cost 20, exp/wsj/decode.sh's)."""
    from attention_lvcsr_torch.train import driver
    lm_config = load_config(built["cfg_path"], built["dataset_class"])
    lm_config["net"]["lm"] = {"path": built["lm_npz"], "weight": 0.5,
                              "no_transition_cost": 20.0}
    return driver.create_model(lm_config, data, checkpoint, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="the result's JSON file (default: QUALITY.json "
                         "in --work)")
    ap.add_argument("--work", default=".quality_work")
    ap.add_argument("--fast", action="store_true",
                    help="alias for --tier fast")
    ap.add_argument("--tier", choices=("fast", "medium", "full"),
                    default="full",
                    help="fast: a tiny smoke run; medium: enough signal "
                         "for the LM and beam tradeoffs; full: the "
                         "paper-shaped 4x250 model")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--skip-train", action="store_true",
                    help="reuse the checkpoint in --work")
    ap.add_argument("--epochs", default=None,
                    help="override 'P,M' pretrain/main epoch counts "
                         "(the tier default undertrains on hard seeds)")
    ap.add_argument("--pad", default=None,
                    help="override 'REC,LAB' pad multiples of the "
                         "batches' frames and labels")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--in-memory", action="store_true",
                    help="read the rendered arrays in memory through the "
                         "Data pipeline instead of an H5 file (no h5py)")
    args = ap.parse_args(argv)

    from attention_lvcsr_torch.data import Data
    from attention_lvcsr_torch.train import driver

    tier = "fast" if args.fast else args.tier
    fast = tier == "fast"
    built = build(args.work, args.seed, tier, args.epochs, args.pad,
                  args.in_memory)
    config = built["config"]
    save_dir = os.path.join(args.work, "model")
    final_ckpt = os.path.join(save_dir, "main.zip")
    # the training's cost is kept beside the checkpoint, so that a
    # --skip-train run reports what the model it decodes cost
    train_meta_path = os.path.join(args.work, "train_meta.json")
    if not (args.skip_train and os.path.exists(final_ckpt)):
        train_meta, _ = train(built, save_dir, args.device)
        with open(train_meta_path, "w") as f:
            json.dump(train_meta, f)
    elif os.path.exists(train_meta_path):
        with open(train_meta_path) as f:
            train_meta = json.load(f)
        train_meta["reused_checkpoint"] = True
    else:
        train_meta = {"train_wall_s": None, "reused_checkpoint": True}

    # 6: decode
    t_decode = time.time()
    data = Data(**config["data"])
    base_kwargs = dict(stop_on="patience", round_to_inf=1e9)
    results = {}
    # the fast tier caps the wide beam at 20; the key names the beam
    wide_beam = 20 if fast else 200
    rec = driver.create_model(config, data, final_ckpt, device=args.device)
    rec_lm = lm_model(built, data, final_ckpt, args.device)

    # char_discount is tuned per condition, as exp/wsj/decode.sh's
    # per-LM table does (0.1 without an LM, 1.0 with the WSJ trigram):
    # the grid at beam 10, the tuned point under the canonical key, the
    # other row kept for the record
    tuned_cd = {}
    for cond, r in (("nolm", rec), ("lm", rec_lm)):
        rows = {}
        for cd in (0.1, 1.0):
            rows[cd] = decode_and_score(
                r, data, 10, dict(base_kwargs, char_discount=cd))
        best = min(rows, key=lambda cd: (rows[cd]["wer"],
                                         rows[cd]["cer"]))
        tuned_cd[cond] = best
        other = 1.0 if best == 0.1 else 0.1
        results[f"{cond}_beam10"] = rows[best]
        results[f"{cond}_beam10_cd{other}"] = rows[other]
        print(cond, "tuned cd", best, rows[best])
        results[f"{cond}_beam{wide_beam}"] = decode_and_score(
            r, data, wide_beam, dict(base_kwargs, char_discount=best))
        print(cond, f"beam{wide_beam}",
              results[f"{cond}_beam{wide_beam}"])

    # the trained model decoded at the bench's operating point: batch
    # 64, beam 10, LM fusion; quality and throughput in one measurement
    results["parity_point_b64"] = decode_and_score(
        rec_lm, data, 10,
        dict(base_kwargs, char_discount=tuned_cd["lm"]), batch=64)
    print("parity point", results["parity_point_b64"])

    out = {
        "task": "synthetic-language quality proxy on the PyTorch port",
        "tier": tier,
        "fast_mode": fast,
        "seed": args.seed,
        "device": args.device,
        "card": (card() if str(args.device).startswith("cuda") else None),
        "data_path": "in-memory" if args.in_memory else "h5",
        "language": {"words": len(built["words"]),
                     "arpa": built["arpa"],
                     "lg_states": built["graph"]["LG_pushed"].num_states,
                     "graph_build_s": round(built["graph_s"], 1)},
        "train_utterances": built["n_train"],
        "train_meta": train_meta,
        "train_wall_s": train_meta.get("train_wall_s"),
        "decode_wall_s": round(time.time() - t_decode, 1),
        "compile_s": "each row's first call, timed alone: it includes "
                     "building the kernels at their first use",
        "results": results,
        "lm_beats_nolm_wer": (results["lm_beam10"]["wer"]
                              < results["nolm_beam10"]["wer"]),
    }
    with open(args.out or os.path.join(args.work, "QUALITY.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
