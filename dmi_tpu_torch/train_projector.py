"""Projector training CLI, stage 1 and the scratch/fine-tuned baselines
(counterpart of dmi_tpu/train_projector.py).

    python -m dmi_tpu_torch.train_projector <config.json> [--device cpu]

Mirrors the reference entry point (dmi/train_projector.py:186-347): a sweep over
(epochs, dataset_size) pairs x seeds with an idempotent skip of completed
runs, then per-dataset seed averaging.  Accepts the reference's projector
config JSONs unchanged.  The LM comes from the port's build_lm: a test LM
or an HF-layout model of any of dmi_tpu's families from a local directory
or the HF hub cache (training/model_utils.py).  The port's
copies of dmi_tpu's framework-free config, data, registry and results
modules do the host work.  It runs on the card unless given --device cpu
(device="cpu"), and fails before loading anything when no card is visible.
"""

from __future__ import annotations

import copy
import logging
import os.path as osp
import sys

from dmi_tpu_torch.models import projector as proj
from dmi_tpu_torch.training.embeddings import build_embedding_managers
from dmi_tpu_torch.training.model_utils import (
    build_lm,
    build_tokenizer,
    is_instruct_lm,
    require_device,
)
from dmi_tpu_torch.training.projector_trainer import ProjectorTrainer
from dmi_tpu_torch.utils.rng import CounterRNG

log = logging.getLogger("dmi_tpu_torch")


def _groups():
    from dmi_tpu_torch.config import DatasetArgs, LMArgs, MEncArgs, ProjectorArgs, TrainArgs

    return (DatasetArgs, LMArgs, MEncArgs, ProjectorArgs, TrainArgs)


def main(name, data_args, lm_args, menc_args, projector_args, train_args, device="cuda"):
    device = require_device(device)
    from dmi_tpu_torch.config import apply_debug_overrides, projector_post_init
    from dmi_tpu_torch.data.loader import DatasetLoader
    from dmi_tpu_torch.registry import dataset_spec
    from dmi_tpu_torch.utils.logging import dump_config_snapshot

    is_instruct = is_instruct_lm(lm_args.lm_name_or_path)
    apply_debug_overrides(train_args, "projector")
    projector_post_init(train_args, menc_args, projector_args)
    dump_config_snapshot(name, data_args, lm_args, menc_args, projector_args, train_args)

    log.info("Building tokenizer / language model")
    tokenizer = build_tokenizer(lm_args)
    llm_cfg, llm_params = build_lm(lm_args, tokenizer, seed=train_args.seed, device=device)
    emb_mgrs = build_embedding_managers(menc_args, device)
    proj_spec = proj.ProjectorSpec(
        mm_dim=menc_args.mm_dim,
        lm_dim=llm_cfg.hidden_size,
        arch=projector_args.proj_arch,
        act=projector_args.proj_act,
        n_layers=projector_args.proj_n_layers,
        dropout=projector_args.proj_dropout,
    )
    gen = CounterRNG(train_args.seed, device=device)  # the same draws on any device
    proj_params = proj.init(proj_spec, gen, device=device)

    log.info("Building loaders")
    model_names = [m.split("/")[-1] for m in menc_args.menc_names_or_paths]
    loaders = [
        DatasetLoader(dataset_spec(ds_name), tokenizer, train_args, model_name, is_instruct,
                      data_args.data_root)
        for ds_name, model_name in zip(data_args.dataset_names_or_paths, model_names)
    ]
    trainer = ProjectorTrainer(
        name=name, llm_cfg=llm_cfg, llm_params=llm_params, proj_spec=proj_spec,
        proj_params=proj_params, loaders=loaders, emb_mgrs=emb_mgrs, tokenizer=tokenizer,
        train_args=train_args, data_root=data_args.data_root,
    )
    start_step = 0
    if train_args.resume_from_checkpoint:
        start_step = trainer.resume(train_args.resume_from_checkpoint)
        if train_args.resume_from_checkpoint_reset_steps:
            start_step = 0
        log.info("Resuming training from step %d", start_step)
    log.info("Starting training (%d steps)", trainer.total_steps)
    return trainer.train(start_step)


def run(config_path: str, device="cuda") -> None:
    require_device(device)
    from dmi_tpu_torch.config import parse_config
    from dmi_tpu_torch.training.results import average_seed_results, run_exists

    data_args, lm_args, menc_args, projector_args, train_args = parse_config(
        config_path, _groups()
    )
    name = osp.splitext(osp.basename(config_path))[0]
    if len(menc_args.menc_names_or_paths) != len(data_args.dataset_names_or_paths):
        raise ValueError("one encoder per dataset: menc_names_or_paths and "
                         "dataset_names_or_paths differ in length")

    seeds = train_args.seeds
    train_args.seeds = None
    epochs_l, dataset_size_l = train_args.epochs_l, train_args.dataset_size_l
    train_args.epochs_l = train_args.dataset_size_l = None
    if epochs_l is None:
        epochs_l, dataset_size_l = [train_args.epochs], [train_args.dataset_size]

    for epochs, dataset_size in zip(epochs_l, dataset_size_l):
        train_args.epochs = epochs
        train_args.dataset_size = dataset_size
        train_type = "ft_projector" if train_args.finetune_from_checkpoint else "projector"
        log.info("Training %s epochs with dataset size %s", epochs, dataset_size)
        for seed in seeds:
            train_args.seed = seed
            output_fname = f"{name}-dsz{dataset_size}-seed{seed}"
            if run_exists(train_args.output_root, train_type, output_fname):
                log.info("Skipping %s (results exist)", output_fname)
                continue
            main(output_fname, copy.deepcopy(data_args), copy.deepcopy(lm_args),
                 copy.deepcopy(menc_args), copy.deepcopy(projector_args),
                 copy.deepcopy(train_args), device=device)
        if len(data_args.dataset_names_or_paths) == 1:
            average_seed_results(seeds, name, dataset_size,
                                 data_args.dataset_names_or_paths[0], train_type,
                                 train_args.output_root)


def cli(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="python -m dmi_tpu_torch.train_projector")
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
