"""A train-mode forward and gradient of the port's camera zoo against the
JAX package, on the CPU: ``cvt_att_fuse``, ``cvt_v2vnet`` and
``cvt_disconet`` at dropout 0 (BatchNorm batch statistics and their update,
the gradients through the pairwise warp) at the tiny width and on the
padded, rotated batch of ``tests/test_torch_camera_zoo.py``, the same numpy
weights on both sides.

Both sides run in f64.  In f32 the train-mode BatchNorms on 8 x 8 maps
amplify rounding: the port in f32 against JAX in f64 differs by 1e-2 of a
gradient's scale everywhere, which would hide a real fault, while the port
in f64 meets the JAX result to ~1e-6 (the attention scores and softmax
still run in f32 inside, as they do at every dtype).  Tolerances: the
scalar (a signed mix of the logits) 1e-6 of the sum of its terms'
magnitudes; each gradient 2e-5 of its tensor's largest value plus 1e-4 rel,
with a floor of 1e-6 of the model's largest gradient (conv biases ahead of
a BatchNorm have a true gradient of 0); the updated BatchNorm statistics
1e-7 abs / 1e-6 rel.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu_torch.utils.weights import jax_tree_to_state_dict
from tests.test_torch_camera_zoo import B, pair_of_models, tiny_batch


@pytest.mark.parametrize("fusion", ["att", "v2vnet", "disconet"])
def test_train_forward_and_gradients_match_jax(fusion):
    jm, variables, port = pair_of_models(fusion, seed=10)
    batch = tiny_batch(2)
    mix = np.random.RandomState(3).randn(B, 1, 64, 64, 2)

    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jb = {k: jnp.asarray(a, jnp.float64) for k, a in batch.items()}

        def loss_fn(params):
            out, new = jm.apply({"params": params,
                                 "batch_stats": v64["batch_stats"]}, jb,
                                True, mutable=["batch_stats"])
            terms = out["dynamic_seg"] * mix
            return terms.sum(), (jnp.abs(terms).sum(), new["batch_stats"])

        (jloss, (jmass, jstats)), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v64["params"])
        jloss, jmass = float(jloss), float(jmass)
        jgrads, jstats = (jax.tree.map(np.asarray, jgrads),
                          jax.tree.map(np.asarray, jstats))

    port.train().double()
    out = port({k: torch.from_numpy(a.astype(np.float64))
                for k, a in batch.items()})
    loss = (out["dynamic_seg"] * torch.from_numpy(mix)).sum()
    loss.backward()
    # the terms' signs cancel: a share of their absolute sum
    np.testing.assert_allclose(loss.item(), jloss, rtol=0, atol=1e-6 * jmass)

    want = jax_tree_to_state_dict(port, {"params": jgrads})
    largest = max(float(np.abs(g).max()) for g in want.values())
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    for k, g in want.items():
        scale = float(np.abs(g).max())
        # the unused static head has no gradient here and a zero one there
        grad = got[k].grad
        grad = np.zeros_like(g) if grad is None else grad.numpy()
        np.testing.assert_allclose(grad, g, rtol=1e-4,
                                   atol=2e-5 * scale + 1e-6 * largest,
                                   err_msg=k)
    stats = jax_tree_to_state_dict(port, {"batch_stats": jstats})
    state = port.state_dict()
    assert stats and all(k.endswith(("running_mean", "running_var"))
                         for k in stats)
    for k, s in stats.items():
        np.testing.assert_allclose(state[k].numpy(), s, atol=1e-7,
                                   rtol=1e-6, err_msg=k)
