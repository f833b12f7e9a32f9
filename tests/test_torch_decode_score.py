"""The plain version of ``fused_decode_score`` against the JAX package's
Pallas kernel in interpret mode (both priors, a padded batch with a row of
zero weights), and the port's fused score tables against the JAX ones."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_net_config
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.ops.pallas.decode_score import (fused_decode_score
                                                         as jax_score,
                                                         toeplitz_band)
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops.decode_score import fused_decode_score

TABLES = ("state_trans", "handler", "v", "merge_k", "merge_b", "post_k",
          "post_b")
PRIORS = {
    "median": dict(prior="window_around_median", before=4.0, after=5.0),
    "expanding": dict(prior="expanding", initial_begin=1.0, initial_end=6.0,
                      min_speed=1.5, max_speed=2.5),
}


def _inputs(seed, U=4, K=3, L=23, M=9, D=6, S=5, R=7, V=8, n=3):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    w = np.abs(f(U * K, L))
    w /= w.sum(axis=1, keepdims=True)
    w[1] = 0.0                       # a row of zero weights: median L - 1
    w[4] = 0.0
    w[4, 7] = 1.0                    # a one-hot row
    mask = (np.arange(L)[None] < np.array([[L], [17], [9], [0]])
            ).astype(np.float32)    # the last utterance fully padded
    tables = {"state_trans": f(S, M), "handler": f(M), "v": f(M),
              "merge_k": f(D, R), "merge_b": f(R), "post_k": f(R, V),
              "post_b": f(V), "conv_filters": f(1, 2 * n + 1) * 0.3}
    data = {"pre": f(U, L, M), "attended": f(U, L, D), "mask": mask,
            "weights": w, "step": rng.randint(0, 5, U * K).astype(np.int32),
            "states": f(U * K, S)}
    return data, tables, K


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("prior", sorted(PRIORS))
def test_plain_score_step_matches_jax_kernel(prior, seed):
    data, tables, K = _inputs(seed)
    L = data["weights"].shape[1]
    ref = jax_score(
        *(jnp.asarray(data[k]) for k in ("pre", "attended", "mask",
                                         "weights", "step", "states")),
        toeplitz_band(jnp.asarray(tables["conv_filters"]), L),
        jnp.triu(jnp.ones((L, L), jnp.float32)),
        *(jnp.asarray(tables[k]) for k in TABLES), beam=K, interpret=True,
        **PRIORS[prior])
    got = fused_decode_score(
        *(torch.tensor(data[k]) for k in ("pre", "attended", "mask",
                                          "weights", "step", "states")),
        {k: torch.tensor(v) for k, v in tables.items()}, beam=K,
        **PRIORS[prior])
    rows = slice(0, 3 * K)          # not the fully padded utterance
    for name, g, r in zip(("costs", "weights", "energies", "wa"), got, ref):
        np.testing.assert_allclose(g.numpy()[rows], np.asarray(r)[rows],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_fused_score_tables_match_jax():
    """The tables the port hands the kernel hold the JAX tables' values;
    the JAX Toeplitz band is built from the port's filter taps."""
    cfg = _tiny_net_config()
    init = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                            "biases_init": ["isotropic_gaussian", 0.5],
                            "rec_weights_init": ["orthogonal"]}}
    jax_rec = JaxRecognizer(cfg, init_config=init, seed=9)
    port = SpeechRecognizer(cfg, init_config=init, seed=9, device="cpu")
    L = 13
    ref = jax_rec.net.apply(
        jax_rec.params, method=lambda net: net.generator.fused_score_tables(
            L, jnp.float32))
    got = port.net.generator.fused_score_tables()
    for name in TABLES:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref[name]), err_msg=name)
    np.testing.assert_array_equal(
        np.asarray(toeplitz_band(jnp.asarray(got["conv_filters"].numpy()),
                                 L)), np.asarray(ref["toeplitz"]))


def test_score_on_a_device_without_kernel_raises():
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_decode_score(meta(2, 5, 3), meta(2, 5, 4), meta(2, 5),
                           meta(4, 5), meta(4), meta(4, 6), {}, beam=2)
