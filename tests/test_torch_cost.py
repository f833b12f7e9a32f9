"""The training cost of the port vs the JAX package (CPU, f32 both sides):
``RecognizerNet.cost`` values and every parameter gradient, on the same
parameters and batch, for both priors, under ``use_pallas`` "interpret"
(the JAX package's training kernels in interpret mode; the port's
``decoder_scan_train`` and ``gru_scan_train`` take their plain versions
because the tensors lie on the CPU) and "never" (the JAX package's XLA
scans; the port's plain module scan)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.models.recognizer import RecognizerNet as JaxNet
from attention_lvcsr_tpu.models.recognizer import \
    param_path_dict as jax_param_path_dict
from attention_lvcsr_torch.models import generator as generator_mod
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer

U, T, TL = 3, 10, 5
BASE = dict(
    input_dims={"recordings": 5}, input_num_chars={},
    eos_label=4, num_phonemes=5, dim_dec=8, dims_bidir=[6],
    enc_transition="gru", dec_transition="gru",
    attention_type="content_and_conv", conv_n=2,
    use_states_for_readout=False, criterion={"name": "log_likelihood"},
    bottom={"bottom_class": "speech"}, subsample=[2],
    post_merge_dims=[10], max_decoded_length_scale=1.0)
PRIORS = {
    "expanding": {"type": "expanding", "initial_begin": 0, "initial_end": 4,
                  "min_speed": 1.0, "max_speed": 2.0},
    "median": {"type": "window_around_median", "before": 2, "after": 2},
}
# f32 both sides through two scans and their gradients
TOL = dict(rtol=2e-5, atol=2e-6)


def _data(seed=1):
    rng = np.random.RandomState(seed)
    inputs = rng.randn(U, T, 5).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[T], [T - 3], [T]])).astype("f")
    labels = rng.randint(0, 5, size=(U, TL)).astype(np.int32)
    lmask = (np.arange(TL)[None] < np.array([[TL], [TL - 2], [3]])).astype(
        "f")
    return inputs, mask, labels, lmask


def _jax_side(cfg, use_pallas, data):
    jdata = [jnp.asarray(a) for a in data]
    init = JaxNet(**dict(cfg, use_pallas="never"))
    params = init.init(jax.random.PRNGKey(0), *jdata, method=init.cost)
    net = JaxNet(**dict(cfg, use_pallas=use_pallas))

    def cost(p):
        out = net.apply(p, *jdata, method=net.cost)
        return out["costs"].sum(), out

    (_, out), grads = jax.value_and_grad(cost, has_aux=True)(params)
    return params, out, jax_param_path_dict(grads)


@pytest.mark.parametrize("use_pallas", ["interpret", "never"])
@pytest.mark.parametrize("prior", sorted(PRIORS))
def test_cost_and_gradients_match_jax(prior, use_pallas, monkeypatch):
    cfg = dict(BASE, prior=PRIORS[prior])
    data = _data()
    params, ref, ref_grads = _jax_side(cfg, use_pallas, data)
    calls = []
    real = generator_mod.decoder_scan_train
    monkeypatch.setattr(generator_mod, "decoder_scan_train",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    net_cfg = dict(cfg, use_pallas=use_pallas)
    net_cfg.pop("input_num_chars")
    rec = SpeechRecognizer(net_cfg, device="cpu")
    load_path_dict(rec.net, jax_param_path_dict(params))
    rec.net.requires_grad_(True)
    inputs, mask, labels, lmask = (torch.from_numpy(a) for a in data)
    out = rec.cost_fn()(inputs, mask, labels.long(), lmask)
    assert bool(calls) == (use_pallas != "never")   # the route taken
    for key in ("costs", "weights", "energies"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), err_msg=key, **TOL)
    out["costs"].sum().backward()
    grads = {k: p.grad for k, p in rec.parameters().items()}
    assert set(grads) == set(ref_grads)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[key], err_msg=key,
                                   **TOL)


def test_unidirectional_encoder_matches_jax():
    """``bidir: false`` (layers ``with_fork{i}``) takes one direction of
    ``gru_scan_train``; cost and gradients as the JAX package's."""
    cfg = dict(BASE, prior=PRIORS["median"], bidir=False)
    data = _data(seed=2)
    params, ref, ref_grads = _jax_side(cfg, "never", data)
    net_cfg = dict(cfg)
    net_cfg.pop("input_num_chars")
    rec = SpeechRecognizer(net_cfg, device="cpu")
    load_path_dict(rec.net, jax_param_path_dict(params))
    rec.net.requires_grad_(True)
    out = rec.cost_fn()(*(torch.from_numpy(a) for a in data[:2]),
                        torch.from_numpy(data[2]).long(),
                        torch.from_numpy(data[3]))
    np.testing.assert_allclose(out["costs"].detach().numpy(),
                               np.asarray(ref["costs"]), **TOL)
    out["costs"].sum().backward()
    for key, p in rec.parameters().items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key],
                                   err_msg=key, **TOL)


def test_dropout_is_not_ported():
    cfg = dict(BASE, prior=PRIORS["median"], dropout=True)
    cfg.pop("input_num_chars")
    rec = SpeechRecognizer(cfg, device="cpu")
    data = [torch.from_numpy(a) for a in _data()]
    with pytest.raises(NotImplementedError, match="dropout"):
        rec.cost_fn()(data[0], data[1], data[2].long(), data[3], train=True)
