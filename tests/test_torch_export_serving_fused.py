"""The serving export under the "fused" switch setting (K2 and K4; the
cases and the model in ``tests/torch_export_cases.py``), and the int8 frame
(``COBEVT_INT8=1``: K7 with its written scale slots, the absmax and the
int8 chain's conv) exported bit for bit.  Apart from
``tests/test_torch_export_serving.py`` so that the two switch settings'
exports run in different test processes.
"""

import torch

from cobevt_tpu_torch.tools import export_serving
from tests.test_torch_corpbevt import _torch_batch, make_batch
from tests.torch_export_cases import (  # noqa: F401 (collected by pytest)
    exported_fixture,
    models,
    test_another_agent_count_raises,
    test_graph_holds_one_op_per_wrapper_call,
    test_loaded_program_matches_jax_and_the_live_forward,
)

exported = exported_fixture("fused")


def test_int8_frame_exports_bit_for_bit(models, monkeypatch):
    """Under ``COBEVT_INT8=1`` the program holds K7 with its written scale
    slots, the absmax and the int8 chain's conv, and equals the live int8
    frame bit for bit."""
    _, _, port = models
    monkeypatch.setenv("COBEVT_INT8", "1")
    batch = _torch_batch(make_batch(3, seed=4))
    with torch.no_grad():
        live = port(batch)
    program = export_serving.export_model(port, batch)
    nodes = export_serving.cobevt_nodes(program)
    assert nodes["conv3x3_int8"] > 0 and nodes["int8_absmax"] > 0 \
        and nodes["conv3x3_s8"] > 0
    monkeypatch.delenv("COBEVT_INT8")
    got = export_serving.run_exported(program, batch)
    for k in live:
        assert torch.equal(got[k], live[k]), k
