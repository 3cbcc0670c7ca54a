"""``forward_train`` of the port against the reference's, on every smoke
config: the loss and every gradient, through ``jax.grad`` of the
reference's loss on the same weights (``params_from_jax``), tokens and
modality input (the counterpart of ``tests/test_models.py``'s per-arch
train-step case, in f32).

The weights are ``tests/_families.py``'s: gates at 2.0 and QKV biases drawn,
so that every parameter gets a gradient. On the CPU the attention backward
is K2's plain backward inside ``FlashAttentionFn``; the SSD scan is its
plain version, differentiated by autograd. Tolerance: the loss to 1e-5
relative, each gradient leaf to 1e-4 of its largest entry (the two
frameworks sum in other orders through two layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _families import make_pair

from repro.configs import ALIASES
from repro.models import forward_train as jax_forward_train
from repro_torch.models import forward_train, param_leaves, params_from_jax
from repro_torch.train import cross_entropy_loss

S = 16


def _jax_loss_and_grads(jcfg, jparams, tokens, cross):
    targets = jnp.roll(tokens, -1, axis=1)

    def loss_fn(p):
        logits = jax_forward_train(p, jcfg, tokens, cross, remat=False)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(lp, targets[..., None], axis=-1))

    loss, grads = jax.value_and_grad(loss_fn)(jparams)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def port_loss_and_grads(cfg, np_params, tokens, cross, remat=False):
    model = params_from_jax(np_params, cfg, device="cpu")
    model.requires_grad_(True)
    tok = torch.from_numpy(tokens).long()
    src = None if cross is None else torch.from_numpy(cross)
    loss = cross_entropy_loss(forward_train(model, tok, src, remat=remat),
                              torch.roll(tok, -1, dims=1))
    loss.backward()
    grads = [np.stack([t.grad.numpy() for t in leaf.tensors]) if leaf.stacked
             else leaf.tensors[0].grad.numpy() for leaf in param_leaves(model)]
    return float(loss), grads


@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_forward_train_loss_and_gradients_match_reference(arch):
    cfg, jcfg, jparams, _, tokens, cross = make_pair(arch)
    tokens = tokens[:, :S]
    np_params = jax.tree.map(np.asarray, jparams)
    want_loss, want = _jax_loss_and_grads(jcfg, jparams, jnp.asarray(tokens),
                                          None if cross is None else jnp.asarray(cross))
    got_loss, got = port_loss_and_grads(cfg, np_params, tokens, cross)
    assert np.isfinite(got_loss)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(float(np.abs(w).max()), 1e-8))
