"""The per-switch cases of the serving export's tests (not a test module).

``tests/test_torch_export_serving.py`` runs them under the "stock" switch
setting and ``tests/test_torch_export_serving_fused.py`` under "fused",
each file exporting its one setting, so the two exports run in different
test processes.  The tiny CorpBEVT of ``tests/test_torch_corpbevt.py``
(ResNet-18, 128^2 images, max_cav 4, 2 cameras, BEV 64^2; numpy weights
shared with the JAX module) in the switch settings of that file: "stock"
(COBEVT_FUSED_XATTN and COBEVT_FUSED_FUSION "0") and "fused" (K2 and K4).
Its eval forward is exported through ``torch.export``, saved to a ``.pt2``,
loaded back and run on the CPU, where every op runs its plain version: the
program's outputs must equal the JAX forward at that file's TOL and the
live port forward at 1e-6, and its graph must hold one ``cobevt::`` node
per wrapper call of the live frame: K2 6 and K4 1 when fused and none when
stock, K3 two per eval BasicBlock the dispatch takes (stride 1, both
channel axes >= 128).  A batch with another agent count must raise.
"""

import os

import numpy as np
import pytest
import torch

from cobevt_tpu_torch import ops
from cobevt_tpu_torch.models.corpbevt import CorpBEVT
from cobevt_tpu_torch.nn.layers import BasicBlock, fused_conv_enabled
from cobevt_tpu_torch.tools import export_serving
from tests.test_corpbevt_parity import our_config
from tests.test_torch_corpbevt import (
    MAX_CAV,
    TOL,
    _torch_batch,
    make_batch,
    port_config,
)
from tests.torch_parity import jax_apply, jax_variables, jnp_tree, port_from

SWITCHES = {"stock": {"COBEVT_FUSED_XATTN": "0", "COBEVT_FUSED_FUSION": "0"},
            "fused": {"COBEVT_FUSED_XATTN": None,
                      "COBEVT_FUSED_FUSION": "force"}}


@pytest.fixture(scope="module")
def models():
    from cobevt_tpu.models.corpbevt import CorpBEVT as JaxCorpBEVT

    jm = JaxCorpBEVT(our_config())
    v = jax_variables(jm, jnp_tree(make_batch(3)), False, seed=3)
    port = port_from(CorpBEVT(port_config(our_config())), v).eval()
    return jm, v, port


def exported_fixture(switch):
    """The module fixture ``exported`` of one switch setting: (switch,
    batch, the live outputs, the program as traced, the program loaded back
    from its .pt2, the JAX outputs) at 3 live agents."""

    @pytest.fixture(scope="module", params=[switch], name="exported")
    def exported(request, models, tmp_path_factory):
        jm, v, port = models
        batch = make_batch(3, seed=3)
        with pytest.MonkeyPatch.context() as mp:
            for k, val in SWITCHES[request.param].items():
                if val is None:
                    mp.delenv(k, raising=False)
                else:
                    mp.setenv(k, val)
            want = jax_apply(jm, v, jnp_tree(batch), False)
            tb = _torch_batch(batch)
            with torch.no_grad():
                live = port(tb)
            program = export_serving.export_model(port, tb)
        path = str(tmp_path_factory.mktemp("export") / "corpbevt.pt2")
        size = export_serving.save_exported(program, path)
        assert size == os.path.getsize(path) > 0
        loaded = export_serving.load_exported(path)
        return request.param, tb, live, program, loaded, want

    return exported


def test_loaded_program_matches_jax_and_the_live_forward(exported):
    _, batch, live, _, loaded, want = exported
    got = export_serving.run_exported(loaded, batch)
    assert set(got) == set(live)
    for k in live:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)
        torch.testing.assert_close(got[k], live[k], atol=1e-6, rtol=1e-6)


def _k3_blocks(model) -> int:
    return sum(1 for m in model.modules() if isinstance(m, BasicBlock)
               and m.stride == 1
               and fused_conv_enabled(m.conv1.in_channels, m.planes))


def test_graph_holds_one_op_per_wrapper_call(exported, models):
    switch, _, _, program, loaded, _ = exported
    nodes = export_serving.cobevt_nodes(program)
    assert export_serving.cobevt_nodes(loaded) == nodes
    fused = switch == "fused"
    assert nodes.get("cross_view_attention", 0) == (6 if fused else 0)
    assert nodes.get("swap_fusion", 0) == (1 if fused else 0)
    assert nodes["conv3x3"] == 2 * _k3_blocks(models[2]) > 0
    assert nodes["window_attention_packed"] >= 1
    assert set(nodes) <= set(ops.KERNEL_OPS)


def test_another_agent_count_raises(exported):
    _, _, _, _, loaded, _ = exported
    other = _torch_batch({k: a[:, :MAX_CAV - 1]
                          for k, a in make_batch(2).items()})
    with pytest.raises(Exception):
        export_serving.run_exported(loaded, other)
