"""LoRA-baseline training CLI (counterpart of dmi_tpu/train_lora.py;
reference dmi/train_lora.py).

    python -m dmi_tpu_torch.train_lora <config.json> [--device cpu]
    torchrun --nproc-per-node N -m dmi_tpu_torch.train_lora <config with mesh_shape>

A sweep over (epochs, dataset_size) pairs x seeds with an idempotent skip of
completed runs, then per-dataset seed averaging.  Accepts the reference's
LoRA config JSONs unchanged.  It runs on the card unless given --device cpu
(device="cpu"), and fails before loading anything when no card is visible.
"""

from __future__ import annotations

import copy
import logging
import os.path as osp
import sys

from dmi_tpu_torch.models import lora as lora_mod
from dmi_tpu_torch.models import projector as proj
from dmi_tpu_torch.parallel.distributed import (
    launch_device,
    on_rank0,
    rank0_first,
    require_mesh,
)
from dmi_tpu_torch.training.embeddings import build_embedding_managers
from dmi_tpu_torch.training.lora_trainer import LoraTrainer
from dmi_tpu_torch.training.model_utils import (
    build_lm,
    build_tokenizer,
    is_instruct_lm,
    require_device,
)
from dmi_tpu_torch.training.projector_trainer import load_projector
from dmi_tpu_torch.utils.rng import CounterRNG

log = logging.getLogger("dmi_tpu_torch")


def _groups():
    from dmi_tpu_torch.config import (
        DatasetArgs,
        LMArgs,
        LoraArgs,
        MEncArgs,
        ProjectorArgs,
        TrainArgs,
    )

    return (DatasetArgs, LoraArgs, LMArgs, MEncArgs, ProjectorArgs, TrainArgs)


def main(name, data_args, lora_args, lm_args, menc_args, projector_args, train_args,
         device="cuda"):
    device = require_device(device)
    from dmi_tpu_torch.config import apply_debug_overrides, lora_post_init
    from dmi_tpu_torch.data.loader import DatasetLoader
    from dmi_tpu_torch.registry import dataset_spec
    from dmi_tpu_torch.utils.logging import dump_config_snapshot

    is_instruct = is_instruct_lm(lm_args.lm_name_or_path)
    apply_debug_overrides(train_args, "lora")
    lora_post_init(train_args, menc_args, lora_args, projector_args)
    on_rank0(lambda: dump_config_snapshot(name, data_args, lora_args, lm_args, menc_args,
                                          projector_args, train_args))
    tokenizer = build_tokenizer(lm_args)
    llm_cfg, llm_params = build_lm(lm_args, tokenizer, seed=train_args.seed, device=device)
    emb_mgrs = build_embedding_managers(menc_args, device)
    proj_spec = proj.ProjectorSpec(
        mm_dim=menc_args.mm_dim, lm_dim=llm_cfg.hidden_size, arch=projector_args.proj_arch,
        act=projector_args.proj_act, n_layers=projector_args.proj_n_layers,
        dropout=projector_args.proj_dropout,
    )
    frozen = load_projector(projector_args.proj_name_or_path, proj_spec)
    lora_spec = lora_mod.LoraSpec(rank=lora_args.lora_rank, alpha=lora_args.lora_alpha,
                                  n_proj_layers=lora_args.lora_n_proj_layers)
    gen = CounterRNG(train_args.seed, device=device)  # the same draws on any device
    lora_params = lora_mod.init(lora_spec, proj_spec, gen, device=device)
    # the loaders write their columnar caches: rank 0 first under torchrun
    loaders = rank0_first(lambda: [
        DatasetLoader(dataset_spec(ds), tokenizer, train_args, enc.split("/")[-1],
                      is_instruct, data_args.data_root)
        for ds, enc in zip(data_args.dataset_names_or_paths, menc_args.menc_names_or_paths)
    ])
    trainer = LoraTrainer(
        lora_spec=lora_spec, lora_params=lora_params, frozen_proj_params=frozen, name=name,
        llm_cfg=llm_cfg, llm_params=llm_params, proj_spec=proj_spec, loaders=loaders,
        emb_mgrs=emb_mgrs, tokenizer=tokenizer, train_args=train_args,
        data_root=data_args.data_root,
    )
    start_step = 0
    if train_args.resume_from_checkpoint:
        start_step = trainer.resume(train_args.resume_from_checkpoint)
        if train_args.resume_from_checkpoint_reset_steps:
            start_step = 0
        log.info("Resuming LoRA training from step %d", start_step)
    log.info("Starting LoRA training (%d steps)", trainer.total_steps)
    return trainer.train(start_step)


def run(config_path: str, device="cuda") -> None:
    require_device(device)
    # under torchrun: join the process group first, as dmi_tpu's CLIs do
    device = launch_device(device)
    from dmi_tpu_torch.config import parse_config
    from dmi_tpu_torch.training.results import average_seed_results, run_exists

    data_args, lora_args, lm_args, menc_args, projector_args, train_args = parse_config(
        config_path, _groups()
    )
    name = osp.splitext(osp.basename(config_path))[0]
    require_mesh(train_args.mesh_shape)
    seeds = train_args.seeds
    train_args.seeds = None
    epochs_l, dataset_size_l = train_args.epochs_l, train_args.dataset_size_l
    train_args.epochs_l = train_args.dataset_size_l = None
    if epochs_l is None:
        epochs_l, dataset_size_l = [train_args.epochs], [train_args.dataset_size]

    for epochs, dataset_size in zip(epochs_l, dataset_size_l):
        train_args.epochs = epochs
        train_args.dataset_size = dataset_size
        for seed in seeds:
            train_args.seed = seed
            output_fname = f"{name}-dsz{dataset_size}-seed{seed}"
            if run_exists(train_args.output_root, "lora", output_fname):
                log.info("Skipping %s (results exist)", output_fname)
                continue
            main(output_fname, *(copy.deepcopy(g) for g in (
                data_args, lora_args, lm_args, menc_args, projector_args, train_args)),
                device=device)
        if len(data_args.dataset_names_or_paths) == 1:
            on_rank0(lambda: average_seed_results(seeds, name, dataset_size,
                                                  data_args.dataset_names_or_paths[0], "lora",
                                                  train_args.output_root))


def cli(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="python -m dmi_tpu_torch.train_lora")
    ap.add_argument("config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
        datefmt="%d/%m/%Y %H:%M:%S",
    )
    run(osp.abspath(args.config), device=args.device)


if __name__ == "__main__":
    cli()
