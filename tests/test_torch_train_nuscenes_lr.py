"""Why the CLI parity of tests/test_torch_train_nuscenes.py runs at
``--lr 5e-5`` and not at the vehicle experiment's 5e-3.

The JAX CLI's pieces against themselves, on that file's scene set and
weights, in f64, over 4 steps at 5e-3: once as the JAX model is written
(the intrinsics inverted in f32) and once with the inverse taken in f64.
The two differ by an f32 rounding of one input, as the port and the JAX
package do: step 1's loss and gradient norm agree to 1e-6.  By step 4 the
updates have blown that up past the budgets the port is held to there
(loss 1e-5 relative, gradient norm 1e-4), so at 5e-3 no implementation
that rounds differently from the JAX package could meet them, the JAX
package itself included.
"""

import pytest

from tests.test_torch_train_nuscenes import _jax_steps, scenes, variables

pytest.importorskip("PIL")

__all__ = ["scenes", "variables"]

EXPERIMENT_LR = 5e-3


class _InverseInF64:
    """The JAX model module's ``jnp`` with ``linalg.inv`` in f64."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.linalg = _Linalg(jnp)

    def __getattr__(self, name):
        return getattr(self._jnp, name)


class _Linalg:
    def __init__(self, jnp):
        self._jnp = jnp

    def __getattr__(self, name):
        return getattr(self._jnp.linalg, name)

    def inv(self, a):
        return self._jnp.linalg.inv(a.astype(self._jnp.float64))


def test_the_jax_pieces_leave_the_budgets_at_the_experiment_lr(
        scenes, variables, monkeypatch):
    import jax.numpy as jnp

    from cobevt_tpu.models import sinbevt_nuscenes as jsn

    as_written = _jax_steps(scenes, variables, 4, EXPERIMENT_LR)
    monkeypatch.setattr(jsn, "jnp", _InverseInF64(jnp))
    inverse_f64 = _jax_steps(scenes, variables, 4, EXPERIMENT_LR)
    gap = [{k: abs(b[k] - a[k]) / abs(a[k]) for k in a}
           for a, b in zip(as_written, inverse_f64)]
    for step, g in enumerate(gap, 1):
        print(f"step {step}: relative gaps {g}")
    assert gap[0]["loss"] < 1e-6 and gap[0]["grad_norm"] < 1e-6, gap[0]
    assert gap[3]["loss"] > 1e-5 and gap[3]["grad_norm"] > 1e-4, gap[3]
