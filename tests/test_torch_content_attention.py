"""Content-only attention (``attention_type: content``) in the port vs the
JAX package (CPU, f32 both sides).

The same weights give the same glimpses (one hypothesis a row and K a
row over shared keys), the same teacher-forced cost graph and gradients
on the module route (``use_pallas: never``) and on the
``decoder_scan_train`` route (the JAX kernel in interpret mode, the port's
plain version, ``n_filters=0``), the same whole-loop decode
(``beam_search_loop`` with ``content_attention=True``, the JAX kernel in
interpret mode), and the same hypotheses from ``run.py search`` and the
same samples."""
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
from attention_lvcsr_tpu.data import Data as JaxData
from attention_lvcsr_tpu.models.attention import \
    SequenceContentAttention as JaxContentAttention
from attention_lvcsr_tpu.models.recognizer import RecognizerNet as JaxNet
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.ops.pallas.beam_loop import \
    beam_search_loop as jax_beam_search_loop
from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
from attention_lvcsr_tpu.train import driver as jax_driver
from attention_lvcsr_torch.config import Configuration
from attention_lvcsr_torch.models import generator as generator_mod
from attention_lvcsr_torch.models.attention import SequenceContentAttention
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops.beam_loop import beam_search_loop
from attention_lvcsr_torch.train import driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 4
NET = dict(
    input_dims={"recordings": 6}, input_num_chars={}, eos_label=EOS,
    num_phonemes=5, dim_dec=8, dims_bidir=[7, 7], enc_transition="gru",
    dec_transition="gru", attention_type="content",
    use_states_for_readout=False, criterion={"name": "log_likelihood"},
    bottom={"bottom_class": "speech"}, subsample=[1, 2],
    post_merge_dims=[10], max_decoded_length_scale=1.0,
    data_prepend_eos=False)
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["isotropic_gaussian", 0.1],
                        "rec_weights_init": ["orthogonal"]}}
# the cost graph: f32 both sides, through the scans
COST_TOL = dict(rtol=1e-5, atol=1e-6)
# gradients through two scans (tests/test_torch_cost.py's tolerance)
GRAD_TOL = dict(rtol=2e-5, atol=2e-6)


def _pair(use_pallas="interpret", states_readout=False, seed=7):
    """(JAX recognizer, port recognizer) with identical weights; the EOS
    logit is raised so hypotheses finish."""
    cfg = dict(NET, use_pallas=use_pallas,
               use_states_for_readout=states_readout)
    jrec = JaxRecognizer(cfg, init_config=INIT, seed=seed)
    post = jrec.params["params"]["generator"]["readout"]["post_merge_0"]
    post["bias"] = post["bias"].at[EOS].add(1.5)
    rec = SpeechRecognizer(cfg, init_config=INIT, seed=seed, device="cpu")
    load_path_dict(rec.net, param_path_dict(jrec.params))
    return jrec, rec


def _batch(U=3, T=16):
    rng = np.random.RandomState(3)
    x = rng.randn(U, T, 6).astype(np.float32)
    m = (np.arange(T)[None] < np.array([[T], [T - 4], [0]])).astype("f")
    return x, m


@pytest.mark.parametrize("beam", [1, 3])
def test_glimpse_matches_jax(beam):
    """One glimpse of U*beam hypothesis rows over U utterances' keys:
    weights and weighted averages; the initial glimpses are zeros and
    have no energies and no step."""
    U, L, D, S, M = 3, 9, 6, 5, 4
    rng = np.random.RandomState(beam)
    attended = rng.randn(U, L, D).astype(np.float32)
    mask = (np.arange(L)[None] < np.array([[L], [5], [0]])).astype("f")
    states = rng.randn(U * beam, S).astype(np.float32)
    jatt = JaxContentAttention(state_names=("states",), attended_dim=D,
                               match_dim=M)
    variables = jatt.init(
        jax.random.PRNGKey(0), jnp.asarray(attended), None,
        jnp.asarray(mask), {}, {"states": jnp.asarray(states)}, beam,
        method=jatt.take_glimpses)
    ref = jatt.apply(variables, jnp.asarray(attended), None,
                     jnp.asarray(mask), {}, {"states": jnp.asarray(states)},
                     beam, method=jatt.take_glimpses)
    att = SequenceContentAttention(("states",), S, D, M)
    p = variables["params"]
    with torch.no_grad():
        att.state_trans_states.kernel.copy_(torch.from_numpy(np.asarray(
            p["state_trans_states"]["kernel"])))
        att.preprocessor.kernel.copy_(torch.from_numpy(np.asarray(
            p["preprocess"]["kernel"])))
        att.preprocessor.bias.copy_(torch.from_numpy(np.asarray(
            p["preprocess"]["bias"])))
        att.energy_comp.kernel.copy_(torch.from_numpy(np.asarray(
            p["energy_comp"]["kernel"])))
        a = torch.from_numpy(attended)
        ours = att.take_glimpses(a, att.preprocess(a), torch.from_numpy(mask),
                                 {}, {"states": torch.from_numpy(states)},
                                 beam=beam)
    assert set(ours) == set(ref) == {"weights", "weighted_averages"}
    for key in ours:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, **COST_TOL)
    assert not ours["weights"][(U - 1) * beam:].any(), \
        "an all-masked row has zero weights"
    init = att.initial_glimpses(2, a)
    assert set(init) == {"weights", "weighted_averages"}
    assert not init["weights"].any()


def _data(seed=1, U=3, T=12, TL=5):
    rng = np.random.RandomState(seed)
    inputs = rng.randn(U, T, 6).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[T], [T - 3], [T]])).astype("f")
    labels = rng.randint(0, 5, size=(U, TL)).astype(np.int32)
    lmask = (np.arange(TL)[None] < np.array([[TL], [TL - 2], [3]])).astype(
        "f")
    return inputs, mask, labels, lmask


@pytest.mark.parametrize("use_pallas", ["interpret", "never"])
def test_cost_and_gradients_match_jax(use_pallas, monkeypatch):
    """``net.cost`` (costs and weights; no energies on either side) and
    every parameter's gradient; ``interpret`` takes ``decoder_scan_train``
    with ``n_filters=0`` and the full-window expanding prior."""
    data = _data()
    jdata = [jnp.asarray(a) for a in data]
    cfg = dict(NET)
    init = JaxNet(**dict(cfg, use_pallas="never"))
    params = init.init(jax.random.PRNGKey(0), *jdata, method=init.cost)
    net = JaxNet(**dict(cfg, use_pallas=use_pallas))

    def cost(p):
        out = net.apply(p, *jdata, method=net.cost)
        return out["costs"].sum(), out

    (_, ref), ref_grads = jax.value_and_grad(cost, has_aux=True)(params)
    ref_grads = param_path_dict(ref_grads)
    calls = []
    real = generator_mod.decoder_scan_train
    monkeypatch.setattr(generator_mod, "decoder_scan_train",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    net_cfg = dict(cfg, use_pallas=use_pallas)
    rec = SpeechRecognizer(net_cfg, device="cpu")
    load_path_dict(rec.net, param_path_dict(params))
    rec.net.requires_grad_(True)
    inputs, mask, labels, lmask = (torch.from_numpy(a) for a in data)
    out = rec.cost_fn()(inputs, mask, labels.long(), lmask)
    if use_pallas == "never":
        assert not calls
    else:
        (kw,) = calls
        L = out["weights"].shape[2]
        assert kw["n_filters"] == 0
        assert kw["prior"]["initial_end"] == float(L)
    assert out["energies"] is None and ref["energies"] is None
    for key in ("costs", "weights"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), err_msg=key,
                                   **COST_TOL)
    out["costs"].sum().backward()
    grads = {k: p.grad for k, p in rec.parameters().items()}
    assert set(grads) == set(ref_grads)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[key], err_msg=key,
                                   **GRAD_TOL)


@pytest.mark.parametrize("case", ["patience", "optimistic", "states"])
def test_beam_loop_matches_jax_interpret(case):
    """The plain loop decode's content branch vs the JAX kernel with
    ``content_attention=True`` in interpret mode, both with the window
    ``search/beam.py`` gives content attention (expanding, to L + 1):
    identical done-set tokens, lengths and steps, costs to 1e-5
    relative."""
    jrec, rec = _pair(states_readout=case == "states")
    x, m = _batch()
    data = jrec.net.apply(jrec.params, x, m, method=jrec.net.decode_loop)
    L = data["attended"].shape[1]
    tables = jrec.net.apply(jrec.params, L, jnp.float32,
                            method=jrec.net.decode_loop_tables)
    kw = dict(beam=3, max_len=10, eol=EOS, prior="expanding",
              initial_end=float(L) + 1.0, char_discount=0.1)
    if case == "optimistic":
        kw.update(stop_on="optimistic_future_cost", char_discount=0.5)
    ref_out, ref_meta, ref_steps = (np.asarray(a) for a in
                                    jax_beam_search_loop(
        data["pre"], data["attended"], data["attended_mask"], tables,
        states_readout=case == "states", content_attention=True,
        interpret=True, **kw))
    t = lambda a: torch.from_numpy(np.array(a))
    ours_tables = rec.net.decode_loop_tables()
    assert "handler" not in ours_tables and "conv_filters" not in ours_tables
    with torch.no_grad():
        out, meta, steps = beam_search_loop(
            t(data["pre"]), t(data["attended"]), t(data["attended_mask"]),
            ours_tables, content_attention=True, **kw)
    valid = ref_meta[:, :, 1] < 1e9 / 2
    assert valid.any(), "vacuous: nothing finished"
    assert not valid[2].any(), "the fully padded utterance must not decode"
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_array_equal(meta.numpy()[:, :, 2], ref_meta[:, :, 2])
    np.testing.assert_array_equal(steps.numpy(), ref_steps)
    np.testing.assert_allclose(meta.numpy()[:, :, :2], ref_meta[:, :, :2],
                               rtol=1e-5, atol=1e-5)


def test_beam_search_routes_match_jax():
    """``beam_search`` of one utterance on the port's loop route (the
    content branch of the plain loop) and module route (``never``) gives
    the JAX module decode's hypotheses and costs."""
    jrec, rec = _pair(use_pallas="never")
    _, rec_loop = _pair(use_pallas="auto")
    x, _ = _batch(U=1, T=14)
    jrec.init_beam_search(3)
    ref_out, ref_costs = jrec.beam_search(x[0], char_discount=0.1)
    assert ref_out, "vacuous: nothing decoded"
    for port in (rec, rec_loop):
        port.init_beam_search(3)
        out, costs = port.beam_search(x[0], char_discount=0.1)
        assert [list(o) for o in out] == [list(o) for o in ref_out]
        np.testing.assert_allclose(costs, ref_costs, rtol=1e-5, atol=1e-5)


def test_sample_matches_jax_teacher_forced():
    """A content model's samples: per-step costs and weights equal the JAX
    package's teacher-forced ``cost`` of the sampled outputs (1e-5)."""
    jrec, rec = _pair(use_pallas="never")
    x, _ = _batch(T=14)
    out = rec.sample(x, n_steps=8)
    labels = out["outputs"].T.astype(np.int32)
    ref = jrec.net.apply(jrec.params, jnp.asarray(x), jnp.ones(x.shape[:2]),
                         jnp.asarray(labels), jnp.ones(labels.shape),
                         method=jrec.net.cost)
    np.testing.assert_allclose(out["costs"], np.asarray(ref["costs"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["weights"], np.asarray(ref["weights"]),
                               rtol=1e-5, atol=1e-5)
    assert len(np.unique(out["outputs"])) > 2, "vacuous: one symbol drawn"


# the toy dataset at tiny widths, content attention; a character discount
# of 2.5 makes the random model's best hypotheses non-empty
WIDTHS = ["net.attention_type", "content", "net.dim_dec", "8",
          "net.dims_bidir", "[6]", "net.dim_matcher", "8",
          "net.post_merge_dims", "[8]",
          "monitoring.search.char_discount", "2.5"]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy dataset, its config and a JAX-written checkpoint of a
    content model with the EOS logit raised by 1."""
    d = tmp_path_factory.mktemp("content")
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_toy_dataset import make_toy_dataset
    make_toy_dataset(str(d / "toy.h5"), num_examples=20, num_chars=4,
                     feat_dim=5, max_len=4, seed=5)
    text = open(os.path.join(ROOT, "tests", "configs", "toy.yaml")).read()
    (d / "toy.yaml").write_text(text.replace("/tmp/toy.h5",
                                             str(d / "toy.h5")))
    jconf = JaxConfiguration(str(d / "toy.yaml"),
                             config_changes=_pairs(WIDTHS))
    data = JaxData(**jconf["data"])
    jrec = jax_driver.create_model(jconf, data)
    post = jrec.params["params"]["generator"]["readout"]["post_merge_0"]
    post["bias"] = post["bias"].at[data.eos_label].add(1.0)
    ckpt = str(d / "model.zip")
    jax_checkpoint.save_checkpoint(ckpt, param_path_dict(jrec.params))
    return {"config": str(d / "toy.yaml"), "ckpt": ckpt}


def _pairs(flat):
    return list(zip(flat[::2], flat[1::2]))


def test_search_matches_jax(toy, tmp_path):
    """``run.py search`` of a content model in chunks of 4: the JAX
    package's report (its module decode) and the port's (the loop route's
    content branch) recognize the same texts, with the same totals and
    the same decoded file."""
    from test_torch_search import assert_same_report, assert_same_stats
    changes = _pairs(WIDTHS + ["monitoring.search.decode_batch", "4"])
    jconf = JaxConfiguration(toy["config"], config_changes=changes)
    conf = Configuration(toy["config"], config_changes=changes)
    theirs, ours = io.StringIO(), io.StringIO()
    jstats = jax_driver.search(jconf, toy["ckpt"], print_to=theirs,
                               decoded_save=str(tmp_path / "jax.txt"),
                               part="train", seed=1)
    stats = driver.search(conf, toy["ckpt"], print_to=ours,
                          decoded_save=str(tmp_path / "port.txt"),
                          device="cpu", part="train", seed=1)
    assert_same_report(ours.getvalue(), theirs.getvalue())
    assert_same_stats(stats, jstats)
    decoded = open(tmp_path / "port.txt").read()
    assert decoded == open(tmp_path / "jax.txt").read()
    assert sum(bool(line.strip()) for line in decoded.splitlines()) * 2 \
        >= stats["num_examples"], "vacuous: most hypotheses are empty"
