"""The plain version of ``beam_attention_energies`` against the JAX
package's Pallas kernel in interpret mode, and the port's module glimpse
(``take_glimpses``, batch-wide window) against the JAX module's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_net_config
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.ops.pallas.attention_energy import \
    beam_attention_energies as jax_energies
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops.attention_energy import (
    beam_attention_energies, beam_attention_energies_reference)

INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}


@pytest.mark.parametrize("U,K,L,M,bias", [(3, 4, 23, 9, 0.0),
                                          (2, 1, 7, 33, 0.25),
                                          (1, 10, 40, 300, -1.5)])
def test_plain_energies_match_jax_kernel(U, K, L, M, bias):
    rng = np.random.RandomState(U * K + L + M)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    args = (f(U, L, M), f(U * K, M), f(U * K, L), f(M) * 0.3, f(M) * 0.3)
    ref = jax_energies(*map(jnp.asarray, args), bias, beam=K, interpret=True)
    got = beam_attention_energies(*map(torch.tensor, args), bias, beam=K)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), beam_attention_energies_reference(
            *map(torch.tensor, args), bias, beam=K).numpy())


def _glimpse_inputs(rng, U, K, L, D, S):
    f = lambda *s: rng.randn(*s).astype(np.float32)
    w = np.abs(f(U * K, L))
    w /= w.sum(axis=1, keepdims=True)
    mask = (np.arange(L)[None] < np.array([[L], [L - 4], [0]])[:U]
            ).astype(np.float32)
    return {"attended": f(U, L, D), "mask": mask, "weights": w,
            "step": np.full((U * K,), 3, np.int32), "states": f(U * K, S)}


@pytest.mark.parametrize("mode", ["never", "interpret"])
@pytest.mark.parametrize("prior", [
    {"type": "window_around_median", "before": 2, "after": 3},
    {"type": "expanding", "initial_begin": 1, "initial_end": 6,
     "min_speed": 0.5, "max_speed": 1.5}], ids=["median", "expanding"])
def test_module_glimpse_matches_jax(mode, prior):
    """One glimpse of a padded 3-utterance batch (the last utterance fully
    padded): weights, energies and weighted averages as the JAX module
    computes them, its window taken over every row of the batch."""
    cfg = dict(_tiny_net_config(), prior=prior)
    jax_rec = JaxRecognizer(dict(cfg, use_pallas=mode), init_config=INIT,
                            seed=3)
    port = SpeechRecognizer(cfg, init_config=INIT, seed=3, device="cpu")
    U, K, L = 3, 4, 17
    D = port.net.generator.attention.attended_dim
    x = _glimpse_inputs(np.random.RandomState(1), U, K, L, D, 16)

    def jax_glimpse(net, attended, mask, weights, step, states):
        a = net.generator.attention
        return a.take_glimpses(attended, a.preprocess(attended), mask,
                               {"weights": weights, "step": step},
                               {"states": states}, beam=K)

    ref = jax_rec.net.apply(jax_rec.params, *(jnp.asarray(x[k]) for k in (
        "attended", "mask", "weights", "step", "states")),
        method=jax_glimpse)
    a = port.net.generator.attention
    with torch.inference_mode():
        t = {k: torch.tensor(v) for k, v in x.items()}
        got = a.take_glimpses(t["attended"], a.preprocess(t["attended"]),
                              t["mask"], {"weights": t["weights"],
                                          "step": t["step"]},
                              {"states": t["states"]}, beam=K)
    for key in ("weights", "energies", "weighted_averages", "step"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_energies_on_a_device_without_kernel_raise():
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        beam_attention_energies(meta(2, 5, 3), meta(4, 3), meta(4, 5),
                                meta(3), meta(3), 0.0, beam=2)
