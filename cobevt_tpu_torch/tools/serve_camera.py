"""Cooperative-camera serving: bucketed inference and a latency report.

Counterpart of ``cobevt_tpu/tools/serve_camera.py``.  Serves synthetic
frames with mixed live-agent counts through an agent-count runner
(``utils/serving.py``: ``--bucketing staged`` takes the exact staged runner
for CorpBEVT and the sliced ``BucketedRunner`` for every other graph, as the
JAX tool does; ``sliced`` and ``off`` force the sliced runner or the full
padded forward; a sliced runner that averages over max_cav agents is
approximate and says so on stderr) and prints one JSON summary line: per-bucket and overall
p50/p95/p99 latency (ms), frames/sec and the runner taken (also named on
stderr).

  python -m cobevt_tpu_torch.tools.serve_camera --synthetic 16 --half
  python -m cobevt_tpu_torch.tools.serve_camera --synthetic 16 --half --int8

``--int8`` serves in the lossy ``COBEVT_INT8=1`` mode (K7 for the trunk
blocks of 256 and 512 channels, layer1 int8-resident; gate it with
``tools/validate_kernels.py``).  The variable is set while this run serves
and the caller's value comes back afterwards; the summary then carries
``"int8": true`` and the K3, K7 and chain-conv launches per served frame.

With ``--model_dir`` the server restores ``config.yaml`` and the latest
``net_epoch{N}.pth`` of a training run (``tools/train_camera.py``) and
serves the frames of a dataset directory (``--root_dir``, by default the
hypes' ``validate_dir``), writing each frame's argmax map to ``--out_dir``
as ``frame_{i:06d}.npz`` (the format of ``tools/inference_camera.py
--out_dir``); ``--half`` computes in bf16 on the twin training and
evaluation use (``train/state.py:compute_twin``).  Without it the weights
are random, drawn from ``--seed``, and the frames synthetic.  Needs a CUDA
card unless ``--device cpu`` is given.

  python -m cobevt_tpu_torch.tools.serve_camera --model_dir runs/corpbevt \
      --root_dir /data/opv2v/validate --half --out_dir preds/
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from cobevt_tpu_torch import ops
from cobevt_tpu_torch.nn.layers import int8_enabled
from cobevt_tpu_torch.ops.dispatch import env_switches
from cobevt_tpu_torch.utils.serving import (
    BucketedRunner,
    FullRunner,
    StagedBucketedRunner,
    save_prediction,
)


def slicing_is_exact(model) -> bool:
    """Whether a forward sliced to the live agents gives the padded
    forward's answer.  Every fusion of the port runs over the live agents
    alone but FuseBEVT's agent mean without ``mean_over_valid``, which
    averages over all max_cav rows (CorpBEVT by default, ``cvt_swap_fuse``)."""
    from cobevt_tpu_torch.models.fusion.swap_fusion import SwapFusionEncoder

    return not any(isinstance(m, SwapFusionEncoder) and not m.mean_over_valid
                   for m in model.modules())


def build_runner(model, cfg, bucketing: str):
    """The JAX tool's choice (``cobevt_tpu/tools/serve_camera.py:66-88``):
    ``staged`` takes the exact ``StagedBucketedRunner`` for CorpBEVT and
    the ``BucketedRunner`` for a graph without its ``stage=`` contract
    (SinBEVT, the CVT zoo); ``sliced`` takes the ``BucketedRunner``; ``off``
    the full padded forward.  A warning on stderr names a sliced runner
    whose answer differs from the padded forward's
    (:func:`slicing_is_exact`)."""
    from cobevt_tpu_torch.models.corpbevt import CorpBEVT

    if bucketing == "staged" and isinstance(model, CorpBEVT):
        return StagedBucketedRunner(model, cfg.max_cav)
    if bucketing == "off":
        return FullRunner(model)
    if bucketing not in ("staged", "sliced"):
        raise ValueError(f"unknown bucketing {bucketing!r}")
    if not slicing_is_exact(model):
        exact = "staged or off" if isinstance(model, CorpBEVT) else "off"
        print(f"warning: the sliced runner is approximate for a fusion "
              f"that averages over max_cav agents; --bucketing {exact} "
              f"gives the padded forward's answer", file=sys.stderr)
    return BucketedRunner(model)


def synthetic_frame(rng, cfg, n_agents: int):
    """One padded synthetic frame with ``n_agents`` live agents."""
    L, M = cfg.max_cav, 4
    H, W = cfg.image_height, cfg.image_width
    intr = np.zeros((1, L, M, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = W * 0.9
    intr[..., 0, 2] = W / 2
    intr[..., 1, 2] = H / 2
    intr[..., 2, 2] = 1.0
    mask = np.zeros((1, L), np.float32)
    mask[:, :n_agents] = 1.0
    inputs = np.zeros((1, L, M, H, W, 3), np.float32)
    inputs[:, :n_agents] = rng.rand(1, n_agents, M, H, W, 3)
    return {
        "inputs": inputs,
        "intrinsic": intr,
        "extrinsic": np.tile(np.eye(4, dtype=np.float32),
                             (1, L, M, 1, 1)),
        "transformation_matrix": np.tile(np.eye(4, dtype=np.float32),
                                         (1, L, 1, 1)),
        "pairwise_t_matrix": np.tile(np.eye(4, dtype=np.float32),
                                     (1, L, L, 1, 1)),
        "agent_mask": mask,
    }


def _wait(out: dict) -> dict:
    for v in out.values():
        if v.is_cuda:
            torch.cuda.synchronize(v.device)
            break
    return out


def _percentiles(v):
    return {f"p{q}_ms": float(np.percentile(v, q)) for q in (50, 95, 99)}


def serve(runner, frames, cfg, rng, bucketing: str = "staged",
          pipeline: int = 1, on_output=None) -> dict:
    """Serve ``frames`` [(n_agents, batch or a function that loads it)]
    through ``runner`` and return the latency summary (a frame's load is
    not part of its latency).  Every bucket is warmed first, outside the
    measured loop.  ``pipeline`` > 1 keeps that many frames in flight
    (latencies then include queueing); ``on_output(i, n, out)`` sees each
    finished frame."""
    for n in sorted({n for n, _ in frames}):
        _wait(runner(synthetic_frame(rng, cfg, n)))

    before = ops.launch_counts()
    lat = {}
    frame_ms = []        # in completion order
    inflight = []        # (t_dispatch, i, n, out) FIFO
    t_all0 = time.perf_counter()

    def finish(td, j, m, o):
        o = _wait(o)
        frame_ms.append((time.perf_counter() - td) * 1e3)
        lat.setdefault(m, []).append(frame_ms[-1])
        if on_output is not None:
            on_output(j, m, o)

    for i, (n, frame) in enumerate(frames):
        if callable(frame):
            frame = frame()
        t0 = time.perf_counter()
        inflight.append((t0, i, n, runner(frame)))
        while len(inflight) >= max(pipeline, 1):
            finish(*inflight.pop(0))
    for item in inflight:
        finish(*item)
    wall = time.perf_counter() - t_all0
    launches = {k: (c - before[k]) / max(len(frames), 1)
                for k, c in ops.launch_counts().items()}

    return {
        "bucketing": bucketing,
        "pipeline": pipeline,
        "int8": int8_enabled(),
        "conv_launches_per_frame": {
            "K3": launches["fused_conv3x3"],
            "K7": launches["fused_conv3x3_int8"],
            "int8_chain": launches["conv3x3_s8"]},
        "frames": len(frames),
        "frames_per_sec": len(frames) / wall,
        **_percentiles(frame_ms),
        "buckets": {str(n): {"frames": len(v), **_percentiles(v)}
                    for n, v in sorted(lat.items())},
        "frame_ms": frame_ms,
    }


def synthetic_frames(rng, cfg, count: int):
    """``count`` frames with live-agent counts drawn from 1..max_cav."""
    frames = []
    for _ in range(count):
        n = 1 + rng.randint(cfg.max_cav)
        frames.append((n, synthetic_frame(rng, cfg, n)))
    return frames


def parse_args(argv=None):
    p = argparse.ArgumentParser("cobevt_tpu_torch camera serving")
    p.add_argument("--bucketing", default="staged",
                   choices=["staged", "sliced", "off"],
                   help="staged = exact for reference-parity fusion "
                        "(graphs without CorpBEVT's stage= split are "
                        "sliced); sliced = exact only under "
                        "fusion_mean_over_valid; off = full padded forward")
    p.add_argument("--model_dir", default=None,
                   help="serve the latest checkpoint of this training run")
    p.add_argument("--root_dir", default=None,
                   help="dataset dir to serve (with --model_dir; defaults "
                        "to the hypes' validate_dir)")
    p.add_argument("--out_dir", default=None,
                   help="write per-frame argmax seg maps (npz) here")
    p.add_argument("--synthetic", type=int, default=None,
                   help="serve N synthetic frames with mixed agent counts "
                        "(16 without --model_dir)")
    p.add_argument("--half", action="store_true",
                   help="bfloat16 weights and activations")
    p.add_argument("--int8", action="store_true",
                   help="post-training-quantized int8 conv paths "
                        "(COBEVT_INT8=1, lossy)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--pipeline", type=int, default=1)
    p.add_argument("--report", default=None,
                   help="also write the JSON summary to this file")
    return p.parse_args(argv)


def dataset_frames(hypes: dict, root_dir: str):
    """[(live agents, load)] of every sample of a dataset dir: the count
    from the per-timestamp YAML files alone, ``load()`` decoding the sample
    (a batch of one) when it is served, so no more than the frames in
    flight are held decoded."""
    from cobevt_tpu_torch.data.opv2v import (
        OPV2VCameraDataset,
        OPV2VScenarioDatabase,
    )
    from cobevt_tpu_torch.tools.train_camera import image_hw

    tp = hypes["train_params"]
    db = OPV2VScenarioDatabase(root_dir, max_cav=tp["max_cav"])
    ds = OPV2VCameraDataset(db, image_hw=image_hw(hypes),
                            visible=tp.get("visible", True), train=False)
    def load(i):
        return {k: np.stack([v]) for k, v in ds[i].items()}

    return [(max(len(ds.plan(i)[2]), 1), functools.partial(load, i))
            for i in range(len(ds))]


def main(argv=None):
    opt = parse_args(argv)
    from cobevt_tpu_torch.tools.train_camera import require_device
    from cobevt_tpu_torch.utils.weights import seeded_init_

    device = require_device(opt.device)
    if opt.root_dir and not opt.model_dir:
        raise SystemExit("--root_dir serves a trained model: give --model_dir")
    rng = np.random.RandomState(opt.seed)
    if opt.model_dir:
        from cobevt_tpu_torch.configs.hypes import (
            build_from_hypes,
            load_hypes,
        )
        from cobevt_tpu_torch.train.checkpoint import load_model_weights
        from cobevt_tpu_torch.train.state import compute_twin

        hypes = load_hypes(os.path.join(opt.model_dir, "config.yaml"))
        cfg, model = build_from_hypes(hypes)
        load_model_weights(opt.model_dir, model)
        model = compute_twin(model.to(device),
                             torch.bfloat16 if opt.half else None).eval()
    else:
        from cobevt_tpu_torch.configs.presets import corpbevt_default
        from cobevt_tpu_torch.models.corpbevt import CorpBEVT

        cfg = corpbevt_default()
        model = CorpBEVT(cfg)
        seeded_init_(model, opt.seed)
        model = model.to(device,
                         torch.bfloat16 if opt.half else torch.float32).eval()
    if opt.model_dir and opt.synthetic is None:
        frames = dataset_frames(hypes, opt.root_dir or hypes["validate_dir"])
    else:
        frames = synthetic_frames(rng, cfg, opt.synthetic or 16)
    on_output = None
    if opt.out_dir:
        os.makedirs(opt.out_dir, exist_ok=True)
        on_output = functools.partial(save_prediction, opt.out_dir)
    runner = build_runner(model, cfg, opt.bucketing)
    print(f"serve_camera: {type(model).__name__} behind "
          f"{type(runner).__name__} (--bucketing {opt.bucketing})",
          file=sys.stderr)
    with env_switches(**({"COBEVT_INT8": "1"} if opt.int8 else {})):
        summary = serve(runner, frames, cfg, rng, opt.bucketing,
                        opt.pipeline, on_output=on_output)
    summary["runner"] = type(runner).__name__
    print(json.dumps(summary))
    if opt.report:
        with open(opt.report, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
