"""The ported CorpBEVT serving slice against the JAX package, end to end.

Small config of tests/test_corpbevt_parity.py (ResNet-18, 128^2 images,
max_cav 4, 2 cameras, BEV 64^2), non-identity agent transforms, two
live-agent counts.  Every test runs in two configurations (the
``switches`` fixture): "stock", both packages at COBEVT_FUSED_XATTN=0 and
COBEVT_FUSED_FUSION=0; and "fused", the serving default, where the port
takes K2 for every FAX cross-view branch and K4 for the fusion encoder and
the JAX package runs its defaults with COBEVT_FUSED_FUSION=force (its K4
runs only on a TPU or in interpret mode; the port's "force" takes K4 as
its default does).  The fused conv stays on in both.  Same numpy weights
and inputs, f32 on the CPU.  Tolerance on the seg logits: 1e-4 abs / 1e-3
rel (the full graph, summed in another order).  Also: the staged runner
and serving loop, the weight bridge's round trip under both switch
settings, and that the package imports without JAX.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.models.corpbevt import CorpBEVT as JaxCorpBEVT
from cobevt_tpu.utils.torch_port import (
    fit_to_template,
    state_dict_to_numpy,
    torch_to_flax,
)
from cobevt_tpu_torch.models import fax as port_fax
from cobevt_tpu_torch.models.corpbevt import CorpBEVT, CorpBEVTConfig
from cobevt_tpu_torch.models.fax import FAXConfig
from cobevt_tpu_torch.models.fusion import swap_fusion as port_fusion
from cobevt_tpu_torch.tools import serve_camera
from cobevt_tpu_torch.utils.serving import StagedBucketedRunner
from tests.test_corpbevt_parity import our_config
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    jnp_tree,
    port_from,
)

TOL = dict(atol=1e-4, rtol=1e-3)
MAX_CAV, M, IMG = 4, 2, 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, params=["stock", "fused"])
def switches(request, monkeypatch):
    if request.param == "stock":
        monkeypatch.setenv("COBEVT_FUSED_XATTN", "0")
        monkeypatch.setenv("COBEVT_FUSED_FUSION", "0")
    else:
        monkeypatch.delenv("COBEVT_FUSED_XATTN", raising=False)
        monkeypatch.setenv("COBEVT_FUSED_FUSION", "force")
    return request.param


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the port's calls of the K2 and K4 wrappers."""
    calls = {"K2": 0, "K4": 0}

    def spy(name, module, attr):
        real = getattr(module, attr)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(module, attr, wrapped)

    spy("K2", port_fax, "fused_cross_view_attention")
    spy("K4", port_fusion, "fused_swap_fusion")
    return calls


def expected_calls(switches, frames=1, encodes=1):
    """Six K2 branches per encode (two per FAX stage), one K4 per fuse."""
    if switches == "stock":
        return {"K2": 0, "K4": 0}
    return {"K2": 6 * encodes, "K4": frames}


def port_config(jcfg) -> CorpBEVTConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(CorpBEVTConfig) if f.name != "fax"}
    return CorpBEVTConfig(**fields,
                          fax=FAXConfig(**dataclasses.asdict(jcfg.fax)))


def make_batch(n_live, seed=0):
    """Padded batch with ``n_live`` live agents, rotated and shifted."""
    rng = np.random.RandomState(seed)
    inputs = np.zeros((1, MAX_CAV, M, IMG, IMG, 3), np.float32)
    inputs[:, :n_live] = rng.rand(1, n_live, M, IMG, IMG, 3)
    intr = np.tile(np.eye(3, dtype=np.float32), (1, MAX_CAV, M, 1, 1))
    intr[:, :n_live, :, 0, 0] = intr[:, :n_live, :, 1, 1] = 120.0
    intr[:, :n_live, :, 0, 2] = intr[:, :n_live, :, 1, 2] = IMG / 2
    extr = np.tile(np.eye(4, dtype=np.float32), (1, MAX_CAV, M, 1, 1))
    extr[:, :n_live, :, :3, 3] = rng.randn(1, n_live, M, 3) * 0.5
    tmat = np.tile(np.eye(4, dtype=np.float32), (1, MAX_CAV, 1, 1))
    for l in range(1, MAX_CAV):
        a = rng.uniform(-0.3, 0.3)
        tmat[0, l, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        tmat[0, l, :2, 3] = rng.uniform(-4, 4, 2)
    mask = (np.arange(MAX_CAV) < n_live)[None].astype(np.float32)
    return {"inputs": inputs, "intrinsic": intr, "extrinsic": extr,
            "transformation_matrix": tmat, "agent_mask": mask}


@pytest.fixture(scope="module")
def models():
    jm = JaxCorpBEVT(our_config())
    v = jax_variables(jm, jnp_tree(make_batch(3)), False, seed=3)
    port = port_from(CorpBEVT(port_config(our_config())), v)
    return jm, v, port


def _torch_batch(batch):
    return {k: torch.from_numpy(a) for k, a in batch.items()}


@pytest.mark.parametrize("n_live", [3, 1])
def test_full_forward_matches_jax(models, n_live, switches, fused_calls):
    jm, v, port = models
    batch = make_batch(n_live, seed=n_live)
    want = jax_apply(jm, v, jnp_tree(batch), False)
    with torch.no_grad():
        got = port(_torch_batch(batch))
    assert got["dynamic_seg"].shape == (1, 1, 64, 64, 2)
    assert_close(got, want, **TOL)
    assert fused_calls == expected_calls(switches)


@pytest.mark.parametrize("n_live", [3, 2])
def test_staged_encode_fuse_matches_jax(models, n_live, switches,
                                        fused_calls):
    jm, v, port = models
    batch = make_batch(n_live, seed=10 + n_live)
    live = {k: a[:, :n_live] for k, a in batch.items()}
    j_bev = jax_apply(jm, v, jnp_tree(live), False, stage="encode")
    with torch.no_grad():
        p_bev = port(_torch_batch(live), stage="encode")
    assert_close(p_bev, j_bev, **TOL)

    j_pad = jnp.pad(j_bev, ((0, 0), (0, MAX_CAV - n_live), (0, 0), (0, 0),
                            (0, 0)))
    fuse = {k: batch[k] for k in ("transformation_matrix", "agent_mask")}
    want = jax_apply(jm, v, jnp_tree(fuse), False, stage="fuse",
                     agent_bev=j_pad)
    # the port's runner: encode on the live agents, pad, fuse
    got = StagedBucketedRunner(port, MAX_CAV)(batch)
    assert_close(got, want, **TOL)
    assert fused_calls == expected_calls(switches, frames=1, encodes=2)
    # exact bucketing: the staged frame equals the full padded forward
    with torch.no_grad():
        full = port(_torch_batch(batch))
    assert_close(got, {k: t.numpy() for k, t in full.items()},
                 atol=1e-5, rtol=1e-5)


def test_serve_loop_reports_every_bucket(models):
    _, _, port = models
    cfg = port.config
    rng = np.random.RandomState(0)
    frames = [(n, serve_camera.synthetic_frame(rng, cfg, n))
              for n in (1, 3, 1)]
    seen = []
    runner = serve_camera.build_runner(port, cfg, "staged")
    summary = serve_camera.serve(
        runner, frames, cfg, rng,
        on_output=lambda i, n, out: seen.append(
            (i, n, bool(torch.isfinite(out["dynamic_seg"]).all()))))
    assert summary["frames"] == 3
    assert set(summary["buckets"]) == {"1", "3"}
    assert summary["buckets"]["1"]["frames"] == 2
    assert summary["p50_ms"] > 0 and summary["frames_per_sec"] > 0
    assert seen == [(0, 1, True), (1, 3, True), (2, 1, True)]
    piped = serve_camera.serve(runner, frames, cfg, rng, pipeline=2)
    assert piped["pipeline"] == 2 and len(piped["frame_ms"]) == 3
    off = serve_camera.build_runner(port, cfg, "off")
    with torch.no_grad():
        a = off(frames[1][1])["dynamic_seg"]
        b = runner(frames[1][1])["dynamic_seg"]
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_bridge_round_trip_gives_the_jax_tree(models):
    _, v, port = models
    converted = torch_to_flax(state_dict_to_numpy(port.state_dict()))
    assert set(converted) == set(v)
    for col in v:
        back = fit_to_template(converted[col], v[col])
        jax.tree.map(np.testing.assert_array_equal, back, v[col])


def test_state_dict_is_the_same_under_both_switches(monkeypatch):
    """No switch adds or drops a leaf: the fused and stock paths share one
    state_dict, so one JAX tree loads into either."""
    cfg = port_config(our_config())
    keys = {}
    for xattn, fusion in (("0", "0"), ("1", "1")):
        monkeypatch.setenv("COBEVT_FUSED_XATTN", xattn)
        monkeypatch.setenv("COBEVT_FUSED_FUSION", fusion)
        sd = CorpBEVT(cfg).state_dict()
        keys[xattn] = {k: tuple(t.shape) for k, t in sd.items()}
    assert keys["0"] == keys["1"]


def test_bridge_raises_on_leftover_leaves(models):
    from cobevt_tpu_torch.utils.weights import load_jax_variables
    _, v, port = models
    extra = {"params": dict(v["params"], stray={"kernel": np.zeros(3)}),
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        load_jax_variables(port, extra)
    missing = {"params": {k: x for k, x in v["params"].items()
                          if k != "seg_head"},
               "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="seg_head"):
        load_jax_variables(port, missing)


def test_package_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cobevt_tpu_torch\n"
        "for m in pkgutil.walk_packages(cobevt_tpu_torch.__path__,\n"
        "                               'cobevt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'flax', 'cobevt_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('cobevt_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20

