"""Port parity: kernel D (beam selection) against the JAX package's Pallas
kernel in interpret mode: exact-tie rows, dead parents, num_finished > 0.

Integer outputs must be equal; vals agree to 1e-6 (both are one float32 add
of the same operands).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.ops import beam_select_pallas
from e2e_asr_tpu_torch.kernels import beam_select

torch.set_num_threads(1)
EOS = 2


def _inputs(seed, B=6, k=4, V=7):
    """Every row keeps at least one live parent, so that at least k
    candidates are finite (the Pallas kernel's lane padding only differs
    from lax.top_k among NEG_INF ties, which the beam never accepts)."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(B, k)).astype(np.float32)
    logp = np.log(rng.dirichlet(np.ones(V), size=(B, k))).astype(np.float32)
    alive = rng.random((B, k)) < 0.6
    alive[:, 0] = True
    nf = rng.integers(0, k, size=B).astype(np.int32)
    # Exact ties: row 0 has identical parents, row 1 identical tokens.
    logp[0, 1], scores[0, 1], alive[0, 1] = logp[0, 0], scores[0, 0], True
    logp[1, :, 3] = logp[1, :, 4]
    if B > 3:
        # <eos> among the winners of row 2, and a row with one live parent.
        logp[2, 0, EOS] = 0.0
        alive[3, 1:] = False
    scores[~alive] = -1e30
    return scores, logp, alive, nf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_pallas(seed):
    scores, logp, alive, nf = _inputs(seed)
    want = beam_select_pallas.beam_select(
        jnp.asarray(scores), jnp.asarray(logp), jnp.asarray(alive),
        jnp.asarray(nf), eos_id=EOS)
    got = beam_select.beam_select(torch.tensor(scores), torch.tensor(logp),
                                  torch.tensor(alive), torch.tensor(nf),
                                  eos_id=EOS)
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].numpy().dtype == w.dtype, key
        if key == "vals":
            np.testing.assert_allclose(got[key].numpy(), w, atol=1e-6,
                                       rtol=0)
        else:
            np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)


def test_ties_go_to_the_lowest_flat_index():
    scores = torch.zeros(1, 2)
    logp = torch.full((1, 2, 3), -1.0)
    got = beam_select.beam_select(scores, logp, torch.ones(1, 2, dtype=bool),
                                  torch.zeros(1, dtype=torch.int32))
    assert got["parent"].tolist() == [[0, 0]]
    assert got["token"].tolist() == [[0, 1]]


def test_non_finite_rows_give_valid_indices():
    """A row of -inf candidates, and a NaN one (a diverged checkpoint),
    still yield k distinct in-range (parent, token) pairs; NaN ranks
    first, as in a stable descending sort."""
    k, V = 3, 5
    scores = torch.zeros(2, k)
    logp = torch.full((2, k, V), -torch.inf)
    logp[1, 2, 4] = torch.nan
    got = beam_select.beam_select(scores, logp, torch.ones(2, k, dtype=bool),
                                  torch.zeros(2, dtype=torch.int32))
    flat = got["parent"] * V + got["token"]
    assert flat[0].tolist() == [0, 1, 2]
    assert flat[1].tolist() == [2 * V + 4, 0, 1]
    assert torch.isnan(got["vals"][1, 0])
