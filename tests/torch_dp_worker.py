"""One rank of the port's two-process data-parallel step (not a test module).

Used by ``tests/test_torch_distributed.py``, which starts two of these with
the explicit-env rendezvous (``COBEVT_COORDINATOR``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``) and runs the same steps in one process on the global
batches.  A rank joins the gloo group through
``cobevt_tpu_torch.parallel.maybe_initialize_distributed`` and trains the
tiny CorpBEVT in f64 through an f64 compute twin, so the step takes the
twin's branch (its gradients copied into the masters' before the
reduction), as a bf16 run does; dropout is 0, and rank 1 starts from other
weights, which the step's broadcast replaces by rank 0's.

  python tests/torch_dp_worker.py step <out.npz>
      loads its shard of a 4-sample set through the port's ``DataLoader``
      (batch 2), takes one train step and writes its loss, its parameters,
      its BatchNorm statistics and the gradients the update read.
  python tests/torch_dp_worker.py fit <out.npz> <ckpt_dir>
      runs one epoch of ``Trainer.fit`` over its shard of a 5-sample set at
      batch 1 (shards of 2 and 3 samples) with a checkpoint at its end, and
      writes its logged losses, its step count, its loader's length and
      its parameters.
"""

import os
import sys

import numpy as np

B, L, M, IMG, BEV = 4, 2, 1, 64, 32
# the fit mode's set: shards of 2 and 3 samples on two ranks
FIT_SAMPLES = 5


def tiny_config():
    """The train-step test's config (``tests/test_torch_train_step.py``:
    ResNet-18, 64^2 images, 2 agents x 1 camera, BEV 32^2) with every
    dropout rate at 0: the two runs would draw different masks, since each
    rank draws its own batch's from one generator state."""
    from cobevt_tpu_torch.models.corpbevt import CorpBEVTConfig
    from cobevt_tpu_torch.models.fax import FAXConfig

    fax = FAXConfig(
        dim=(32, 32, 32), middle=(1, 1, 1), image_height=IMG,
        image_width=IMG, heads=(2, 2, 2), dim_head=(16, 16, 16),
        q_win_size=((4, 4), (4, 4), (4, 4)),
        feat_win_size=((2, 2), (2, 2), (2, 2)),
        bev_embedding_flag=(True, False, False), bev_height=BEV,
        bev_width=BEV, upsample_scales=(2, 4, 8), self_attn_dim_head=16,
        self_attn_dropout=0.0, self_attn_window=4)
    return CorpBEVTConfig(
        max_cav=L, target="dynamic", encoder_num_layers=18,
        encoder_id_pick=(1, 2, 3), image_height=IMG, image_width=IMG,
        fax=fax, sttf_resolution=0.8, sttf_downsample_rate=4,
        use_roi_mask=True, fusion_mlp_dim=32, fusion_window_size=2,
        fusion_dim_head=8, fusion_dropout=0.0, fusion_depth=1,
        fusion_mask=True, decoder_num_layer=3, decoder_num_ch=(16, 24, 32),
        seg_head_dim=16, output_class=2)


def to_tensors(batch) -> dict:
    """A numpy batch as tensors, floats in f64 (the model's dtype)."""
    import torch
    return {k: torch.as_tensor(np.asarray(v)).double()
            if np.asarray(v).dtype == np.float32
            else torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def global_batch(B=B):
    """The global batch of ``B`` samples, drawn from a seeded numpy
    generator."""
    rng = np.random.RandomState(0)
    intr = np.zeros((B, L, M, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = IMG * 0.9
    intr[..., 0, 2] = intr[..., 1, 2] = IMG / 2
    intr[..., 2, 2] = 1.0
    tmat = np.tile(np.eye(4, dtype=np.float32), (B, L, 1, 1))
    tmat[:, 1, :2, 3] = [1.5, -2.0]
    return {
        "inputs": rng.rand(B, L, M, IMG, IMG, 3).astype(np.float32),
        "intrinsic": intr,
        "extrinsic": np.tile(np.eye(4, dtype=np.float32), (B, L, M, 1, 1)),
        "transformation_matrix": tmat,
        "agent_mask": np.ones((B, L), np.float32),
        "gt_dynamic": rng.randint(0, 2, (B, 1, BEV, BEV)),
    }


class SampleSet:
    """The global batch as a dataset of its samples."""

    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return len(self.batch["inputs"])

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.batch.items()}

    @staticmethod
    def collate(samples):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def criterion(out, b):
    """The train-step test's class-weighted loss on the dynamic map."""
    from cobevt_tpu_torch.losses import VanillaSegLoss

    seg = VanillaSegLoss(target="dynamic", d_weights=75.0, d_coe=2.0)
    return seg(out, {"gt_dynamic": b["gt_dynamic"],
                     "gt_static": b["gt_dynamic"]})


def train_state(seed: int = 0):
    """(model, state, step) of the tiny CorpBEVT, weights from ``seed``, on
    the train-step test's schedule, AdamW and class-weighted loss, computing
    on an f64 twin of the f64 masters."""
    import torch

    from cobevt_tpu_torch.models.corpbevt import CorpBEVT
    from cobevt_tpu_torch.train import (
        cosine_warmup_schedule,
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from cobevt_tpu_torch.utils.weights import seeded_init_

    torch.manual_seed(seed)
    model = CorpBEVT(tiny_config())
    seeded_init_(model, seed)
    model = model.double()

    schedule = cosine_warmup_schedule(2e-4, 2e-5, 10, 100)
    optimizer = make_optimizer(model.parameters(), schedule)
    # the gradients the update reads (after the reduction over the ranks)
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {}
    optimizer.register_step_pre_hook(lambda opt, args, kwargs: grads.update(
        {names[id(p)]: p.grad.detach().clone() for group in opt.param_groups
         for p in group["params"]}))
    state = create_train_state(model, optimizer, schedule,
                               compute_dtype=torch.float64)
    assert state.compute_model is not model
    state.grads = grads
    return model, state, make_train_step(model, criterion)


def results(state, logs) -> dict:
    """What the test compares: the loss, every parameter and every
    BatchNorm buffer after the step, and the gradients the update read
    (``grad/<name>``), as numpy."""
    out = {"loss": np.asarray(float(logs["loss"]))}
    for name, t in state.model.state_dict().items():
        out[name] = t.detach().cpu().numpy()
    for name, g in state.grads.items():
        out[f"grad/{name}"] = g.cpu().numpy()
    return out


def step_main(out_path):
    import torch

    from cobevt_tpu_torch.data.loader import DataLoader
    from cobevt_tpu_torch.parallel import rank, world_size

    batch = global_batch()
    loader = DataLoader(SampleSet(batch), 2, shuffle=False, num_workers=0,
                        num_shards=world_size(), shard_index=rank())
    assert len(loader) == 1
    local = next(iter(loader))
    lo = 2 * rank()
    np.testing.assert_array_equal(np.asarray(local["inputs"]),
                                  batch["inputs"][lo:lo + 2])

    # rank 1 draws other weights: the step's start-of-run broadcast must
    # give it rank 0's
    model, state, step = train_state(seed=rank())
    logs = step(state, to_tensors(local))
    np.savez(out_path, rank=rank(), **results(state, logs))


def fit_main(out_path, ckpt_dir):
    from cobevt_tpu_torch.data.loader import DataLoader
    from cobevt_tpu_torch.parallel import rank, world_size
    from cobevt_tpu_torch.train.loop import Trainer, TrainerConfig

    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in global_batch(FIT_SAMPLES).items()}
    loader = DataLoader(SampleSet(batch), 1, shuffle=False, num_workers=0,
                        num_shards=world_size(), shard_index=rank())
    model, state, _ = train_state(seed=rank())
    trainer = Trainer(model, criterion, state, TrainerConfig(
        epochs=1, save_freq=1, log_every=1, ckpt_dir=ckpt_dir))
    trainer.fit(loader)
    losses = [r["scalars"]["loss"] for r in trainer.records]
    np.savez(out_path, rank=rank(), loader_len=len(loader),
             steps=trainer.global_step, losses=np.asarray(losses),
             **{k: t.detach().numpy()
                for k, t in state.model.state_dict().items()})


def main():
    mode, out_path = sys.argv[1], sys.argv[2]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    import torch

    # one intra-op thread: with two, PyTorch's CPU AdamW update of the
    # first parameter was seen to differ in the last bits between the two
    # ranks on identical parameters, gradients and moments (up to 1e-11 of
    # the step on one thread's half of the tensor, in about 1 run of 20 to
    # 200 under load), which the ranks' bit-equality check would read as a
    # fault of the step
    torch.set_num_threads(1)
    from cobevt_tpu_torch.parallel import (
        maybe_initialize_distributed,
        world_size,
    )

    assert maybe_initialize_distributed(backend="gloo") is True
    assert world_size() == 2
    if mode == "step":
        step_main(out_path)
    else:
        fit_main(out_path, sys.argv[3])
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
