"""OPV2V cooperative camera training CLI.

Counterpart of ``cobevt_tpu/tools/train_camera.py`` (reference
``opv2v/opencood/tools/train_camera.py``):

  python -m cobevt_tpu_torch.tools.train_camera --hypes_yaml <yaml> \\
      [--model_dir <resume_dir>] [--half]

Builds dataset, model and loss from the hypes file, trains with AdamW on the
cosine-after-warmup schedule (warmup and length in steps per epoch), checks
the validation IoU every ``eval_freq`` epochs, writes ``net_epoch{N}.pth``
checkpoints (``train/checkpoint.py``) next to ``config.yaml`` every
``save_freq`` epochs and logs to JSONL (and tensorboard where installed).
``--half`` computes in bf16 on a twin of the f32 master weights
(``train/state.py``).  ``--model_dir`` resumes from the latest checkpoint
there, its ``config.yaml`` taking priority over ``--hypes_yaml``.  The
weights and the dropout generator start from seed 0.

Multi-GPU: the first thing ``main`` does is
``parallel/distributed.py:maybe_initialize_distributed`` (torchrun with
``COBEVT_MULTIHOST=1``, SLURM, or ``COBEVT_COORDINATOR`` with
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``), one process a GPU.  Each rank
then loads its shard of the train and validation sets, the train step
averages the gradients over the ranks, and only rank 0 writes the config,
the checkpoints and the logs.  ``hypes["train_params"]["batch_size"]`` is
a rank's batch, as in the JAX CLI.

Runs on the CUDA card unless ``--device cpu`` is given.  ``main(argv)``
can be called in-process and returns the ``Trainer``.
"""

from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser("cobevt_tpu_torch camera training")
    p.add_argument("--hypes_yaml", required=True)
    p.add_argument("--model_dir", default="",
                   help="resume from this checkpoint dir")
    p.add_argument("--half", action="store_true",
                   help="bfloat16 compute")
    p.add_argument("--save_dir", default="runs/default")
    p.add_argument("--uint8_input", action="store_true",
                   help="the loader ships resized uint8 images and the "
                        "model normalizes on the device (4x fewer host "
                        "bytes; nn/layers.py:images_from_uint8)")
    p.add_argument("--input_cache", default="",
                   help="directory of the decode-once sample cache "
                        "(data/cache.py); freezes wild-setting noise draws "
                        "and the CAV order at cache-build time")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num_workers", type=int, default=2,
                   help="loader worker processes (0: decode in this one)")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace this many steps after the first with "
                        "torch.profiler and print their device time and "
                        "idle share")
    return p.parse_args(argv)


def require_device(name: str) -> torch.device:
    """The device an entry point runs on; a CUDA device needs a card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    return device


def build_from_hypes(hypes: dict, device, seed: int = 0):
    """(config, f32 model on ``device`` with seeded weights, criterion)
    from hypes (reference ``train_utils.create_model``)."""
    from cobevt_tpu_torch.configs.hypes import build_from_hypes as build
    from cobevt_tpu_torch.losses import VanillaSegLoss
    from cobevt_tpu_torch.utils.weights import seeded_init_

    cfg, model = build(hypes)
    seeded_init_(model, seed)
    model = model.to(device)

    loss_args = hypes["loss"]["args"]
    seg_loss = VanillaSegLoss(
        target=loss_args["target"], d_weights=loss_args["d_weights"],
        s_weights=loss_args["s_weights"],
        l_weights=loss_args.get("l_weights", 50.0),
        d_coe=loss_args["d_coe"], s_coe=loss_args["s_coe"])

    def criterion(out, batch):
        return seg_loss(out, {"gt_dynamic": batch["gt_dynamic"],
                              "gt_static": batch["gt_static"]})
    return cfg, model, criterion


def image_hw(hypes: dict):
    args = hypes["preprocess"]["args"]
    return args["resize_y"], args["resize_x"]


def main(argv=None):
    opt = parse_args(argv)
    from cobevt_tpu_torch.parallel.distributed import (
        barrier,
        is_main_process,
        maybe_initialize_distributed,
        rank,
        world_size,
    )

    maybe_initialize_distributed()
    device = require_device(opt.device)

    from cobevt_tpu_torch.configs.hypes import (
        load_hypes,
        save_config_snapshot,
    )
    from cobevt_tpu_torch.data import DATASET_REGISTRY
    from cobevt_tpu_torch.data.loader import DataLoader
    from cobevt_tpu_torch.data.opv2v import OPV2VScenarioDatabase, WildConfig
    from cobevt_tpu_torch.train import (
        cosine_warmup_schedule,
        create_train_state,
        make_optimizer,
    )
    from cobevt_tpu_torch.train.loop import Trainer, TrainerConfig

    hypes = load_hypes(opt.hypes_yaml, opt.model_dir or None)
    cfg, model, criterion = build_from_hypes(hypes, device)

    tp = hypes["train_params"]
    wild = WildConfig(**hypes["wild_setting"]) \
        if "wild_setting" in hypes else WildConfig()
    ds_cls = DATASET_REGISTRY[hypes["fusion"]["core_method"]]
    train_db = OPV2VScenarioDatabase(hypes["root_dir"],
                                     max_cav=tp["max_cav"],
                                     shuffle_cavs=True)
    val_db = OPV2VScenarioDatabase(hypes["validate_dir"],
                                   max_cav=tp["max_cav"])
    ds_kwargs = {"normalize": False} if opt.uint8_input else {}
    train_ds = ds_cls(train_db, image_hw=image_hw(hypes),
                      visible=tp.get("visible", True),
                      wild=wild, train=True, **ds_kwargs)
    val_ds = ds_cls(val_db, image_hw=image_hw(hypes),
                    visible=tp.get("visible", True),
                    train=False, **ds_kwargs)
    if opt.input_cache:
        from cobevt_tpu_torch.data.cache import CachedDataset

        train_ds = CachedDataset(train_ds,
                                 os.path.join(opt.input_cache, "train"))
        val_ds = CachedDataset(val_ds,
                               os.path.join(opt.input_cache, "val"))

    # each rank's shard (the JAX CLI's per-host sharding)
    loader_kw = dict(num_workers=opt.num_workers, device=device,
                     num_shards=world_size(), shard_index=rank())
    train_loader = DataLoader(train_ds, tp["batch_size"], shuffle=True,
                              **loader_kw)
    val_loader = DataLoader(val_ds, 1, shuffle=False, drop_last=False,
                            **loader_kw)

    steps_per_epoch = max(len(train_loader), 1)
    sched_cfg = hypes["lr_scheduler"]
    schedule = cosine_warmup_schedule(
        base_lr=hypes["optimizer"]["lr"],
        warmup_lr=sched_cfg.get("warmup_lr", hypes["optimizer"]["lr"]),
        warmup_steps=sched_cfg.get("warmup_epoches", 0) * steps_per_epoch,
        total_steps=tp["epoches"] * steps_per_epoch,
        lr_min=sched_cfg.get("lr_min", 0.0))
    optimizer = make_optimizer(
        model.parameters(), schedule,
        weight_decay=hypes["optimizer"]["args"].get("weight_decay", 1e-2),
        eps=hypes["optimizer"]["args"].get("eps", 1e-10))
    state = create_train_state(
        model, optimizer, schedule,
        compute_dtype=torch.bfloat16 if opt.half else None)

    save_dir = opt.model_dir or opt.save_dir
    if is_main_process():
        save_config_snapshot(hypes, save_dir)
    barrier()
    trainer = Trainer(model, criterion, state, TrainerConfig(
        epochs=tp["epoches"], eval_freq=tp.get("eval_freq", 5),
        save_freq=tp.get("save_freq", 5), log_every=opt.log_every,
        ckpt_dir=save_dir, log_dir=os.path.join(save_dir, "logs"),
        seg_target=cfg.target, profile_steps=opt.profile_steps),
        generator=torch.Generator(device=device).manual_seed(0))
    trainer.maybe_resume()

    def reshuffle(epoch):
        train_db.reinitialize()          # re-shuffle CAV ordering

    # the sample cache keys on index only: re-shuffling CAV order under it
    # would serve stale agents, so the cache pins one CAV ordering (the
    # batch-order shuffle of the loader is unaffected)
    on_epoch_end = None if opt.input_cache else reshuffle
    if on_epoch_end is not None:
        # a resumed run sees the CAV orders the epochs before it left
        for epoch in range(trainer.start_epoch):
            on_epoch_end(epoch)
    trainer.fit(train_loader, val_loader, on_epoch_end=on_epoch_end)
    trainer.logger.close()
    if trainer.profile is not None:
        import json
        print(json.dumps({"train_profile": trainer.profile}))
    return trainer


if __name__ == "__main__":
    main()
