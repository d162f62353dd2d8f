"""Hypernetwork training and few-shot CLI, stages 2 and 3 (counterpart of
dmi_tpu/train_hypernet.py; reference dmi/train_hypernet.py).

    python -m dmi_tpu_torch.train_hypernet <config.json> [--device cpu]
    torchrun --nproc-per-node N -m dmi_tpu_torch.train_hypernet <config with mesh_shape>

  mode=train   — stage 2: train the hypernetwork on the high-resource datasets
  mode=fewshot — stage 3: few-shot integration, a sweep over
                 (fewshot_epochs x fewshot_dataset_sizes) x seeds with an
                 idempotent skip of completed runs and per-dataset seed
                 averaging

Accepts the reference's hypernet config JSONs unchanged.  The LM comes from
the port's build_lm: a test LM or an HF-layout model of any of dmi_tpu's
families from a local directory or the HF hub cache
(training/model_utils.py).  It runs on the card unless given --device cpu
(device="cpu"), and fails before loading anything when no card is visible.
"""

from __future__ import annotations

import copy
import logging
import os.path as osp
import sys

from dmi_tpu_torch.models import hypernet as hn
from dmi_tpu_torch.models import projector as proj
from dmi_tpu_torch.parallel.distributed import (
    launch_device,
    on_rank0,
    rank0_first,
    require_mesh,
)
from dmi_tpu_torch.training.embeddings import (
    build_embedding_managers,
    build_fewshot_embedding_managers,
)
from dmi_tpu_torch.training.hypernet_trainer import HypernetTrainer
from dmi_tpu_torch.training.projector_trainer import load_projector
from dmi_tpu_torch.utils.rng import CounterRNG
from dmi_tpu_torch.training.model_utils import (
    build_lm,
    build_tokenizer,
    is_instruct_lm,
    require_device,
)

log = logging.getLogger("dmi_tpu_torch")


def _groups():
    from dmi_tpu_torch.config import (
        DatasetArgs,
        FewshotArgs,
        HypnetArgs,
        LMArgs,
        MEncArgs,
        ProjectorArgs,
        TrainArgs,
    )

    return (DatasetArgs, HypnetArgs, LMArgs, MEncArgs, ProjectorArgs, TrainArgs, FewshotArgs)


def main(name, train_args, hn_args, projector_args, data_args, menc_args, lm_args,
         fewshot_args, device="cuda"):
    device = require_device(device)
    from dmi_tpu_torch.config import apply_debug_overrides
    from dmi_tpu_torch.data.loader import DatasetLoader
    from dmi_tpu_torch.registry import dataset_spec
    from dmi_tpu_torch.utils.logging import dump_config_snapshot

    is_instruct = is_instruct_lm(lm_args.lm_name_or_path)
    if train_args.mode not in ("train", "fewshot"):
        raise ValueError(f"mode {train_args.mode!r}: train or fewshot")
    apply_debug_overrides(train_args, "hypernet")
    on_rank0(lambda: dump_config_snapshot(name, data_args, hn_args, lm_args, menc_args,
                                          projector_args, train_args, fewshot_args))
    tokenizer = build_tokenizer(lm_args)
    llm_cfg, llm_params = build_lm(lm_args, tokenizer, seed=train_args.seed, device=device)
    emb_mgrs = build_embedding_managers(menc_args, device)
    fewshot_emb_mgrs = (build_fewshot_embedding_managers(menc_args, device)
                        if menc_args.fewshot_menc_names_or_paths else [])

    proj_spec = proj.ProjectorSpec(
        mm_dim=menc_args.mm_dim, lm_dim=llm_cfg.hidden_size, arch=projector_args.proj_arch,
        act=projector_args.proj_act, n_layers=projector_args.proj_n_layers,
        dropout=projector_args.proj_dropout,
    )
    frozen_proj = load_projector(projector_args.proj_name_or_path, proj_spec)
    n_tokens = (fewshot_args.fewshot_n_tokens if fewshot_args.fewshot_n_tokens is not None
                else train_args.subset_batch_size)
    hn_spec = hn.HypnetSpec(
        lm_dim=llm_cfg.hidden_size, mm_dim=menc_args.mm_dim, n_tokens=n_tokens,
        arch=hn_args.hn_arch, n_layers=hn_args.hn_n_layers, n_heads=hn_args.hn_n_heads,
        hypnet_dim=hn_args.hn_hypnet_dim, rank=hn_args.hn_rank, alpha=hn_args.hn_alpha,
        predict_bias=hn_args.hn_predict_bias, n_proj_layers=hn_args.hn_n_proj_layers,
        use_pos_encs=hn_args.hn_use_pos_encs, attn_dropout=hn_args.hn_attn_dropout,
        transformer_dropout=hn_args.hn_transformer_dropout,
    )
    gen = CounterRNG(train_args.seed, device=device)  # the same draws on any device
    hn_params = hn.init(hn_spec, gen, device=device)

    def build(datasets, encoders):
        # the loaders write their columnar caches: rank 0 first under torchrun
        return rank0_first(lambda: [
            DatasetLoader(dataset_spec(ds), tokenizer, train_args, enc.split("/")[-1],
                          is_instruct, data_args.data_root)
            for ds, enc in zip(datasets, encoders)
        ])

    loaders = (build(data_args.dataset_names_or_paths, menc_args.menc_names_or_paths)
               if train_args.mode == "train" else [])
    fewshot_loaders = (build(data_args.fewshot_dataset_names_or_paths,
                             menc_args.fewshot_menc_names_or_paths)
                       if data_args.fewshot_dataset_names_or_paths else [])
    trainer = HypernetTrainer(
        name=name, llm_cfg=llm_cfg, llm_params=llm_params, proj_spec=proj_spec,
        frozen_proj_params=frozen_proj, hn_spec=hn_spec, hn_params=hn_params,
        loaders=loaders, emb_mgrs=emb_mgrs, fewshot_loaders=fewshot_loaders,
        fewshot_emb_mgrs=fewshot_emb_mgrs, tokenizer=tokenizer, train_args=train_args,
        fewshot_args=fewshot_args, data_root=data_args.data_root,
    )
    start_step = 0
    if train_args.resume_from_checkpoint:
        ck = trainer.load_checkpoint(train_args.resume_from_checkpoint)
        if train_args.mode == "train" and not train_args.resume_from_checkpoint_reset_steps:
            start_step = int(ck["step_idx"]) + 1
            log.info("Resuming hypernet training from step %d", start_step)
    if train_args.mode == "train":
        log.info("Starting hypernet training (%d steps)", trainer.total_steps)
        trainer.train(start_step)
    else:
        log.info("Starting fewshot integration")
        trainer.fewshot_generate()
    return trainer


def run(config_path: str, device="cuda") -> None:
    require_device(device)
    # under torchrun: join the process group first, as dmi_tpu's CLIs do
    device = launch_device(device)
    from dmi_tpu_torch.config import hypernet_post_init, parse_config
    from dmi_tpu_torch.training.results import average_seed_results, run_exists

    (data_args, hn_args, lm_args, menc_args, projector_args, train_args,
     fewshot_args) = parse_config(config_path, _groups())
    name = osp.splitext(osp.basename(config_path))[0]
    require_mesh(train_args.mesh_shape)
    hypernet_post_init(hn_args, projector_args, train_args, menc_args)

    def groups():
        return tuple(copy.deepcopy(g) for g in (train_args, hn_args, projector_args,
                                                data_args, menc_args, lm_args, fewshot_args))

    if train_args.mode == "train":
        main(name, *groups(), device=device)
        return

    # the few-shot sweep (dmi/train_hypernet.py:674-704)
    seeds = train_args.seeds
    train_args.seeds = None
    for epochs, dataset_size in zip(fewshot_args.fewshot_epochs,
                                    fewshot_args.fewshot_dataset_sizes):
        train_args.epochs = epochs
        train_args.dataset_size = dataset_size
        log.info("Fewshot: %s epochs, dataset size %s", epochs, dataset_size)
        for seed in seeds:
            train_args.seed = seed
            output_fname = f"{name}-dsz{dataset_size}-seed{seed}"
            if run_exists(train_args.output_root, "hypernet", output_fname):
                log.info("Skipping %s (results exist)", output_fname)
                continue
            main(output_fname, *groups(), device=device)
        if len(data_args.fewshot_dataset_names_or_paths) == 1:
            on_rank0(lambda: average_seed_results(seeds, name, dataset_size,
                                                  data_args.fewshot_dataset_names_or_paths[0],
                                                  "hypernet", train_args.output_root))


def cli(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="python -m dmi_tpu_torch.train_hypernet")
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
