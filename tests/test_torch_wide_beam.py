"""Wide beams and long inputs on the whole-loop decode route (CPU).

* The port's plain loop (``beam_search_loop_reference``) against JAX's
  ``beam_search_loop`` in interpret mode at beam 40, past JAX's
  ``UNROLL_SLOTS`` (32), where its selection and done-set rounds roll into
  ``fori_loop``; again at L=160 with JAX's match tensor forced into
  128-frame chunks (``pick_l_chunk``).  Conv attention under the median
  window, content attention, ten filters with a maxout readout under the
  mean window, and two stacked decoder layers: done sets, lengths and
  steps identical, costs within 1e-5.  With five symbols, the first steps
  fill most of the 40 slots with dead rows' candidates whose costs round
  to the same float32 value: both order them by flat index.
* ``search/beam.py::loop_route`` gives JAX's ``_loop_kernel_mode`` for
  every config under ``exp/``, at its own widths, at beams 10-513 and 800
  and 1600 frames; no model is built.
* The workspace instance's layout mirror (``ops/beam_loop.py::
  smem_plan``'s ``"workspace"``): no two buffers live at once overlap,
  every offset is 16-byte aligned, and the shared part stays within a
  block at K=512, L=2000."""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
from attention_lvcsr_tpu.models.recognizer import RecognizerNet as JaxNet
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.ops.pallas import beam_loop as jax_loop
from attention_lvcsr_tpu.search.beam import BeamSearch as JaxBeamSearch
from attention_lvcsr_torch.config import Configuration
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops import beam_loop as bl
from attention_lvcsr_torch.ops.expressions import maxout_pieces
from attention_lvcsr_torch.search.beam import MAX_LOOP_BEAM, loop_route

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 4
BEAM = 40
MEDIAN = {"type": "window_around_median", "before": 3, "after": 3}
MEAN = {"type": "window_around_mean", "before": 3, "after": 3}
NET = dict(
    input_dims={"recordings": 6}, input_num_chars={}, eos_label=EOS,
    num_phonemes=5, dim_dec=8, dims_bidir=[7], enc_transition="gru",
    dec_transition="gru", attention_type="content_and_conv", conv_n=2,
    use_states_for_readout=False, criterion={"name": "log_likelihood"},
    bottom={"bottom_class": "speech"}, subsample=[1], post_merge_dims=[10],
    max_decoded_length_scale=1.0, data_prepend_eos=False, prior=MEDIAN)
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}
CONFIGS = {
    "conv-median": {},
    "content": {"attention_type": "content", "prior": None},
    "conv10-maxout-mean": {"conv_num_filters": 10,
                           "post_merge_activation": "maxout:2",
                           "use_states_for_readout": True, "prior": MEAN},
    "stack2": {"dec_stack": 2, "dim_dec": 6, "dim_matcher": 9},
}


def _pair(overrides):
    """(JAX recognizer, port recognizer) on JAX's weights, the EOS logit
    raised so that hypotheses finish."""
    cfg = dict(NET, use_pallas="interpret", **overrides)
    jrec = JaxRecognizer(cfg, init_config=INIT, seed=7)
    last = jrec.params["params"]["generator"]["readout"]["post_merge_0"]
    last["bias"] = last["bias"].at[EOS].add(1.5)
    rec = SpeechRecognizer(cfg, init_config=INIT, seed=7, device="cpu")
    load_path_dict(rec.net, param_path_dict(jrec.params))
    return jrec, rec


@pytest.mark.parametrize("chunk", [None, 128], ids=["whole", "l-chunk-128"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_plain_loop_matches_jax_at_beam_40(config, chunk, monkeypatch):
    jrec, rec = _pair(CONFIGS[config])
    T = 16 if chunk is None else 160
    rng = np.random.RandomState(3)
    x = rng.randn(2, T, 6).astype(np.float32)
    m = (np.arange(T)[None] < np.array([[T], [T - 4]])).astype("f")
    data = jrec.net.apply(jrec.params, x, m, method=jrec.net.decode_loop)
    L = data["attended"].shape[1]
    tables = jrec.net.apply(jrec.params, L, jnp.float32,
                            method=jrec.net.decode_loop_tables)
    chunked = []
    if chunk is not None:
        monkeypatch.setattr(jax_loop, "pick_l_chunk",
                            lambda *a: chunked.append(a) or chunk)
    net = rec.net_config
    content = net["attention_type"] == "content"
    prior = dict(net["prior"] or {"type": "expanding",
                                  "initial_end": float(L) + 1.0})
    act = net.get("post_merge_activation", "tanh")
    kw = dict(beam=BEAM, max_len=12, eol=EOS, char_discount=0.1,
              prior=prior.pop("type"),
              **{k: float(v) for k, v in prior.items()})
    ref_out, ref_meta, ref_steps = (np.asarray(a) for a in
                                    jax_loop.beam_search_loop(
        data["pre"], data["attended"], data["attended_mask"], tables,
        states_readout=bool(net["use_states_for_readout"]),
        maxout=maxout_pieces(act), post_act=act,
        content_attention=content, dec_stack=net.get("dec_stack", 1),
        interpret=True, **kw))
    t = lambda a: torch.from_numpy(np.array(a))
    with torch.no_grad():
        out, meta, steps = bl.beam_search_loop(
            t(data["pre"]), t(data["attended"]), t(data["attended_mask"]),
            rec.net.decode_loop_tables(), post_act=act,
            content_attention=content, **kw)
    assert bool(chunked) == (chunk is not None), "JAX's trace was cached"
    valid = ref_meta[:, :, 1] < 1e9 / 2
    assert valid.sum() >= BEAM, "vacuous: most slots empty"
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_array_equal(meta.numpy()[:, :, 2], ref_meta[:, :, 2])
    np.testing.assert_array_equal(steps.numpy(), ref_steps)
    np.testing.assert_allclose(meta.numpy()[:, :, :2], ref_meta[:, :, :2],
                               rtol=1e-5, atol=1e-5)


# -- routing ------------------------------------------------------------------

CONFIG_FILES = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "exp", "*", "configs", "*.yaml")))


def _stages(path, cls):
    conf = cls(os.path.join(ROOT, path))
    if getattr(conf, "multi_stage", False):
        return list(conf.ordered_stages.values())
    return [conf]


def _full(net):
    """A stage's net at its own widths, with what building the JAX net
    needs and the route JAX takes on the CPU (``interpret``)."""
    net = {k: v for k, v in dict(net).items()
           if k not in ("compute_dtype", "input_sources")}
    return dict(net, input_dims={"recordings": 123}, input_num_chars={},
                eos_label=4, num_phonemes=32, use_pallas="interpret")


class _Rec:
    pass


def test_every_config_is_routed():
    assert len(CONFIG_FILES) == 54


@pytest.mark.parametrize("path", CONFIG_FILES)
def test_loop_route_matches_jax(path):
    """Per stage, beam and input length: the port takes the loop kernel
    exactly where JAX's ``_loop_kernel_mode(num_frames)`` does."""
    for stage, jstage in zip(_stages(path, Configuration),
                             _stages(path, JaxConfiguration)):
        net = _full(stage["net"])
        jrec = _Rec()
        jrec.net, jrec.num_phonemes = JaxNet(**_full(jstage["net"])), 32
        for beam in (10, 18, 200, MAX_LOOP_BEAM, MAX_LOOP_BEAM + 1):
            search = JaxBeamSearch(jrec, beam)
            for frames in (800, 1600):
                jax_route = search._loop_kernel_mode(
                    num_frames=frames) is not None
                assert loop_route(net, beam, frames) \
                    == jax_route, (stage["net"], beam, frames)
    assert not loop_route(net, MAX_LOOP_BEAM + 1, 800)


def test_loop_route_follows_jax_budget():
    """JAX leaves its kernel when one utterance's fixed and per-utterance
    bytes pass 1.5 x 64 MB: the flagship's beam 10 up to L=3524 encoded
    frames (14,096 input frames at its 4-fold subsampling)."""
    from __graft_entry__ import FLAGSHIP_NET
    net = dict(FLAGSHIP_NET, use_pallas="interpret")
    jrec = _Rec()
    jrec.net = JaxNet(**net)
    search = JaxBeamSearch(jrec, 10)
    for frames in (14096, 14097, 14100):
        assert loop_route(net, 10, frames) == (
            search._loop_kernel_mode(num_frames=frames) is not None)
    assert loop_route(net, 10, 14096)
    assert not loop_route(net, 10, 14097)


# -- the workspace layout -----------------------------------------------------

FLAGSHIP = dict(K=10, L=200, M=250, D=500, S=250, R=250, V=32, F=250,
                Lout=100, n_taps=201)
PHASES = (("conv", "sp"), ("act", "costs"),
          ("hs", "was", "aout2", "dout2", "fb", "gi", "it"))
ROWS = {"h", "w", "aout", "dout", "wn", "wa"} | {
    name for phase in PHASES for name in phase}


def _sizes(K, L, M, D, S, R, V, F, Lout, n_taps, n_filters=1, maxout=0,
           dec_stack=1, content=False, normalizer="softmax"):
    nf = 0 if content else n_filters
    return dict(
        h=K * S * dec_stack, w=K * L, aout=K * Lout, dout=K * Lout,
        mask=L, taps=nf * n_taps, handler=nf * M, v=M,
        bad=K if normalizer == "relu" else 0,
        red_v=bl.THREADS // 32 + 1, red_i=bl.THREADS // 32 + 1,
        wn=K * L, wa=K * D, conv=nf * K * L, sp=K * M,
        act=K * R + (K * R // maxout if maxout else 0), costs=K * V,
        hs=K * S, was=K * D, aout2=K * Lout, dout2=K * Lout,
        fb=0 if dec_stack > 1 else K * F, gi=2 * K * S, it=K * S)


@pytest.mark.parametrize("shape,options", [
    (dict(FLAGSHIP, K=200), {}),
    (dict(FLAGSHIP, K=512, L=2000, Lout=666, M=512), dict(n_filters=16,
                                                           maxout=2)),
    (dict(FLAGSHIP, K=512, L=2000, Lout=666), dict(normalizer="relu")),
    (dict(FLAGSHIP, K=18, D=2000, R=1000, Lout=266), {}),
    (dict(FLAGSHIP, K=40, S=256, M=512, D=512, L=400, Lout=266),
     dict(n_filters=10, maxout=2, dec_stack=2)),
    (dict(FLAGSHIP, K=64, L=175, n_taps=0), dict(content=True)),
    (dict(K=201, L=37, M=13, D=66, S=33, R=17, V=9, F=15, Lout=11,
          n_taps=5), {})])
def test_workspace_layout(shape, options):
    plan = bl.smem_plan(**shape, **options)
    ws = plan["workspace"]
    assert not plan["fits"] and bl.route(plan, shape["K"]) == "workspace"
    assert ws["fits"] and ws["smem_bytes"] <= bl.SMEM_LIMIT
    size = _sizes(**shape, **options)
    offsets = ws["offsets"]
    assert all(off % 4 == 0 for off in offsets.values())
    shared = [n for n in offsets if n not in ROWS]
    rows = ["h", "w", "aout", "dout", "wn", "wa"]
    for region, live_sets in (("shared", [shared]), ("rows", [
            rows + list(phase) for phase in PHASES])):
        end = ws["smem_bytes"] // 4 if region == "shared" else ws["stride"]
        for live in live_sets:
            spans = sorted((offsets[n], offsets[n] + size.get(n, shape["K"]))
                           for n in live)
            for (_, a_end), (b_start, _) in zip(spans, spans[1:]):
                assert a_end <= b_start, (region, live)
            assert spans[-1][1] <= end
    # the K-row buffers keep the resident layout's order and phases: the
    # workspace rows are the resident layout less the shared buffers
    assert ws["stride"] < plan["smem_bytes"] // 4
    assert plan["smem_bytes"] // 4 - ws["stride"] <= ws["smem_bytes"] // 4


def test_workspace_shared_part_at_the_widest():
    """K=512, L=2000, 16 filters of 201 taps, M=512: the per-row scalars,
    mask, taps, handler rows and energy vector take 78,368 bytes of the
    block's 232,448."""
    plan = bl.smem_plan(K=512, L=2000, M=512, D=2000, S=512, R=1000, V=32,
                        F=512, Lout=2000, n_taps=201, n_filters=16,
                        maxout=2, normalizer="relu")
    assert plan["workspace"]["smem_bytes"] == 78368 + 4 * 512
    assert plan["workspace"]["fits"]


def test_route_refuses_past_the_widest_beam():
    plan = bl.smem_plan(**dict(FLAGSHIP, K=MAX_LOOP_BEAM + 1))
    assert bl.MAX_BEAM == MAX_LOOP_BEAM
    with pytest.raises(ValueError, match="beam 513"):
        bl.route(plan, MAX_LOOP_BEAM + 1)
    assert bl.route(bl.smem_plan(**FLAGSHIP), 10) == "resident"
    assert bl.route(bl.smem_plan(**dict(FLAGSHIP, K=17)), 17) == "resident"
    assert bl.route(bl.smem_plan(**dict(FLAGSHIP, K=18)), 18) == "workspace"
