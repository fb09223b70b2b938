"""Serving export: the eval forward as a ``torch.export`` program.

Counterpart of ``cobevt_tpu/tools/export_serving.py``, which serializes the
jitted eval forward to StableHLO with its Pallas kernels as custom calls.
Here :func:`export_model` traces the module's eval forward with
``torch.export.export`` at the sample batch's static shapes; the hand
kernels enter the graph as the ``cobevt::`` custom ops (``ops/dispatch.py:
KernelOp``), so the program runs the same kernels and counts the same
launches as the live module, with no Python model code.  The weights are
part of the saved ``.pt2`` (:func:`save_exported`); a serving process loads
it with :func:`load_exported`, which registers the ops first, and calls
``program.module()(batch)`` under ``torch.no_grad()``.

  # export a trained model for 5-agent serving on the card
  python -m cobevt_tpu_torch.tools.export_serving --model_dir runs/corpbevt \\
      --out runs/corpbevt/serving.pt2

  # export the benchmark flagship with seeded weights
  python -m cobevt_tpu_torch.tools.export_serving --synthetic corpbevt \\
      --out /tmp/corpbevt.pt2

What is decided in Python is fixed at export, as in the JAX tool's jitted
trace: the environment switches (``COBEVT_FUSED_XATTN``,
``COBEVT_FUSED_FUSION``, ``COBEVT_FUSED_CONV``, ``COBEVT_INT8``,
``COBEVT_INT8_RESIDENT``), each kernel's route and gate
(``kernel_path``, ``stream_accepts``, ...), the compute dtype and every
shape.  A batch of other shapes raises when the program is called.  The
kernels' packed operands (folded BatchNorm, transposed and cast weights)
are not cached across calls in the program: they are recomputed inside the
graph at every call, as the JAX program refolds inside its forward.
"""

from __future__ import annotations

import argparse
import collections
import json
import os

import numpy as np
import torch


def export_model(model, sample_batch):
    """``torch.export`` of ``model(batch)`` in eval mode, traced at
    ``sample_batch``'s shapes without autograd.  Returns the
    ``ExportedProgram``."""
    model.eval()
    with torch.no_grad():
        return torch.export.export(model, (sample_batch,), strict=False)


def save_exported(program, path: str) -> int:
    """Write ``program`` to ``path`` (``.pt2``); returns its bytes."""
    torch.export.save(program, path)
    return os.path.getsize(path)


def load_exported(path: str):
    """The program saved at ``path``.  Imports the port's ops first, so the
    ``cobevt::`` custom ops are registered before the graph is read."""
    import cobevt_tpu_torch.ops  # noqa: F401  (registers cobevt::*)

    return torch.export.load(path)


def run_exported(program, batch) -> dict:
    """One call of a loaded program without autograd."""
    with torch.no_grad():
        return program.module()(batch)


def cobevt_nodes(program) -> dict:
    """{op name: calls} of the ``cobevt::`` ops in the program's graph."""
    counts = collections.Counter(
        node.target._opname for node in program.graph.nodes
        if isinstance(node.target, torch._ops.OpOverload)
        and node.target.namespace == "cobevt")
    return dict(counts)


def synthetic_model(name: str, max_cav: int, device):
    """(model, batch) of the JAX tool's ``--synthetic`` choices: the
    benchmark's CorpBEVT or nuScenes flagship with seeded weights, in bf16
    (the serving default), and its synthetic batch."""
    from cobevt_tpu_torch.tools.benchmark import build_corpbevt, build_sinbevt

    if name == "corpbevt":
        model, batch, _ = build_corpbevt(max_cav, device=device)
    else:
        model, batch, _ = build_sinbevt(device=device)
        batch = {k: batch[k] for k in ("image", "intrinsics", "extrinsics")}
    return model.to(torch.bfloat16).eval(), batch


def model_from_dir(model_dir: str, device):
    """(model, batch): the latest ``net_epoch{N}.pth`` of a run directory in
    its training dtype, and a synthetic frame of ``max_cav`` live agents."""
    from cobevt_tpu_torch.tools.inference_camera import restore_for_eval
    from cobevt_tpu_torch.tools.serve_camera import synthetic_frame

    _, cfg, _, state = restore_for_eval(model_dir, device)
    frame = synthetic_frame(np.random.RandomState(0), cfg, cfg.max_cav)
    batch = {k: torch.from_numpy(v).to(device) for k, v in frame.items()}
    return state.compute_model.eval(), batch


def main(argv=None):
    p = argparse.ArgumentParser("cobevt_tpu_torch serving export")
    p.add_argument("--model_dir", default=None,
                   help="run dir (config.yaml, net_epoch{N}.pth)")
    p.add_argument("--synthetic", default=None,
                   choices=["corpbevt", "sinbevt_nuscenes"],
                   help="export a benchmark model with seeded weights")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--max_cav", type=int, default=5)
    opt = p.parse_args(argv)
    if (opt.model_dir is None) == (opt.synthetic is None):
        raise SystemExit("give one of --model_dir and --synthetic")

    from cobevt_tpu_torch.tools.train_camera import require_device

    device = require_device(opt.device)
    if opt.synthetic:
        model, batch = synthetic_model(opt.synthetic, opt.max_cav, device)
    else:
        model, batch = model_from_dir(opt.model_dir, device)

    program = export_model(model, batch)
    size = save_exported(program, opt.out)

    # round trip: load the file back and run it once
    out = run_exported(load_exported(opt.out), batch)
    shapes = {k: list(v.shape) for k, v in out.items()}
    summary = {"out": opt.out, "bytes": size, "device": str(device),
               "outputs": shapes}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
