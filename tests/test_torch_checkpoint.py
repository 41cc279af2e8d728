"""Port parity for weights: `core/checkpoint.py` builds the port's
parameters from the JAX package's named leaves (`flatten_named`) and from
its `.npz` checkpoints, strictly, and the port's own init has the JAX
init's layout. Leaves must be equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.models import seq2seq
from tests.test_torch_slice import setup  # noqa: F401  (shared fixture)

torch.set_num_threads(1)


def test_params_from_named_is_strict(setup):
    cfg, _, _, named, _ = setup
    params = checkpoint.params_from_named(named, cfg, "cpu")
    port_named = checkpoint.flatten_named(params)
    assert sorted(port_named) == sorted(named)
    for name, arr in named.items():
        np.testing.assert_array_equal(port_named[name].numpy(), arr)
    with pytest.raises(ValueError, match="missing"):
        checkpoint.params_from_named(
            {k: v for k, v in named.items() if "attn_v" not in k}, cfg,
            "cpu")
    with pytest.raises(ValueError, match="unexpected"):
        checkpoint.params_from_named({**named, "encoder/extra": named[
            "decoder_char/attn_v"]}, cfg, "cpu")
    bad = dict(named)
    bad["decoder_char/attn_v"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.params_from_named(bad, cfg, "cpu")


@pytest.mark.parametrize("train_state", [False, True])
def test_load_npz_reads_a_jax_checkpoint(setup, train_state):
    """A bare parameter tree (as tools/convert_tf_ckpt.py saves it) and a
    training state with its parameters under `params/`."""
    cfg, _, jparams, named, root = setup
    state = ({"params": jparams, "step": jnp.int32(3)} if train_state
             else jparams)
    path = jckpt.save(str(root / f"ckpt{int(train_state)}"), "asr.ckpt", 3,
                      state)
    params = checkpoint.load_npz(path, cfg, "cpu")
    for name, leaf in checkpoint.flatten_named(params).items():
        np.testing.assert_array_equal(leaf.numpy(), named[name])


def test_port_init_matches_jax_layout(setup):
    cfg, _, _, named, _ = setup
    port = checkpoint.flatten_named(
        seq2seq.init(torch.Generator().manual_seed(1), cfg,
                     device="cpu"))
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: v.shape for k, v in named.items()}
