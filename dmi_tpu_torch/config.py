# Copy of dmi_tpu/config.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Experiment configuration system.

Mirrors the reference's seven HfArgumentParser dataclass groups
(reference: dmi/utils/args.py:9-113) so that all 77 reference experiment
JSONs under dmi/configs/ parse unchanged.  A single flat JSON file is
partitioned into groups by field name, exactly like HfArgumentParser's
parse_json_file does for a tuple of dataclasses.

Differences from the reference (deliberate):
  * `device` is accepted but ignored — device placement is JAX's job
    (single-process TPU or a Mesh; see dmi_tpu.parallel).
  * extra cross-field post-init rules live here as pure functions
    (reference: dmi/train_projector.py:178-184, dmi/train_hypernet.py:465-472,
    dmi/train_lora.py:162-169).
"""

from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field, fields
from typing import Any, List, Optional, Sequence, Tuple

DEFAULT_SEEDS: Tuple[int, ...] = (55625, 66848, 92900, 5225, 71753)


def _default_seeds() -> Tuple[int, ...]:
    return copy.deepcopy(DEFAULT_SEEDS)


@dataclass
class TrainArgs:
    """Training-loop arguments (reference: dmi/utils/args.py:9-51)."""

    output_dir: str
    mode: str = "train"  # "train" | "fewshot"
    device: str = "tpu"  # accepted for config compatibility; unused
    resume_from_checkpoint: Optional[str] = None
    finetune_from_checkpoint: Optional[str] = None
    finetune_mm_dim: Optional[int] = None
    resume_from_checkpoint_reset_steps: bool = False
    save_state: bool = True
    train_batch_size: int = 128
    subset_batch_size: int = 128
    eval_batch_size: int = 128
    learning_rate: float = 1e-4
    max_grad_norm: float = 1.0
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    epochs: Optional[int] = None
    dataset_size: Optional[str] = None
    epochs_l: Optional[List[int]] = None
    dataset_size_l: Optional[List[str]] = None
    warmup_steps: int = 500
    scheduler: Optional[str] = "cosine_warmup"
    logging_steps: int = 50
    save_steps: int = 5000
    save_steps_l: Optional[List[int]] = None
    eval_steps: int = 5000
    eval_steps_l: Optional[List[int]] = None
    generate_steps: int = 5000
    generate_steps_l: Optional[List[int]] = None
    eval_at_step_zero: bool = False
    generate_at_step_zero: bool = False
    seed: int = 42
    seeds: Optional[Tuple[int, ...]] = field(default_factory=_default_seeds)
    gradient_accumulation_steps: int = 1
    pad_to_multiple_of: int = 8
    debug: bool = False
    feed_txt_embs: bool = False
    augment_emb_space: bool = False
    subtract_mean: bool = False
    n_components: Optional[int] = None
    # --- TPU-native extensions (absent from reference configs; defaulted) ---
    mesh_shape: Optional[List[int]] = None  # e.g. [8, 1] -> (data, model)
    # coalesce k same-loader grad-accum micro-batches into one dispatch
    # (k*B rows through the frozen LLM; numerics equal up to summation
    # order, test_hypernet_e2e.py::test_coalesced_micro_steps_match_
    # sequential).  Chip A/B (BASELINE.md round-5): k=2 is +3.2% at the
    # production stage-2 shape, k>=4 OOMs on the [k*B*T, V] loss temps.
    # Default stays 1 = the reference-exact sequential form; set 2 for
    # chip training throughput.
    micro_batch_coalesce: int = 1
    use_pallas: bool = True
    profile_dir: Optional[str] = None
    output_root: str = "../outputs"  # results JSON root (reference hardcodes ../outputs)
    checkpoint_dir: str = "checkpoints"


@dataclass
class MEncArgs:
    """Modality-encoder arguments (reference: dmi/utils/args.py:53-60)."""

    menc_names_or_paths: List[str]
    load_extracted_features: List[bool]
    fewshot_menc_names_or_paths: Optional[List[str]] = None
    fewshot_load_extracted_features: Optional[List[bool]] = None
    mm_dim: int = 768
    mm_dtype: Optional[str] = "float32"


@dataclass
class LMArgs:
    """Language-model arguments (reference: dmi/utils/args.py:63-66)."""

    lm_name_or_path: str
    lm_dtype: Optional[str] = "bfloat16"


@dataclass
class DatasetArgs:
    """Dataset arguments (reference: dmi/utils/args.py:69-72)."""

    dataset_names_or_paths: List[str]
    fewshot_dataset_names_or_paths: Optional[List[str]] = None
    data_root: str = "data"  # TPU-native extension: dataset root directory


@dataclass
class ProjectorArgs:
    """Projector arguments (reference: dmi/utils/args.py:75-82)."""

    proj_name_or_path: Optional[str] = None
    proj_arch: str = "mlp"
    proj_act: str = "quick_gelu"
    proj_n_layers: int = 2
    proj_dropout: float = 0.1
    proj_prune: Optional[int] = None


@dataclass
class HypnetArgs:
    """Hypernetwork arguments (reference: dmi/utils/args.py:84-96)."""

    hn_name_or_path: str = "hypnet_1"
    hn_arch: str = "transformer"
    hn_n_layers: int = 1
    hn_n_heads: int = 1
    hn_hypnet_dim: int = 768  # assumption shared with reference: == mm_dim
    hn_rank: int = 32
    hn_alpha: int = 32
    hn_predict_bias: bool = True
    hn_principled_init: bool = False
    hn_n_proj_layers: Optional[int] = None  # set by post-init from proj_n_layers
    hn_use_pos_encs: bool = False
    # dropout rates the reference hardcodes (dmi/model/hypernet.py:47 MHSA
    # p=0.05; torch TransformerEncoderLayer default 0.1) — exposed so
    # deterministic cross-implementation runs can zero them on both sides
    hn_attn_dropout: float = 0.05
    hn_transformer_dropout: float = 0.1


@dataclass
class LoraArgs:
    """LoRA-baseline arguments (reference: dmi/utils/args.py:98-103)."""

    lora_name_or_path: str = "lora_1"
    lora_rank: int = 32
    lora_alpha: int = 32
    lora_n_proj_layers: Optional[int] = None  # set by post-init


@dataclass
class FewshotArgs:
    """Few-shot stage arguments (reference: dmi/utils/args.py:105-113)."""

    finetune_generated_projector: bool
    fewshot_learning_rate: float = 1e-4
    fewshot_weight_decay: float = 5e-6
    fewshot_dataset_sizes: Optional[List[str]] = None
    fewshot_epochs: Optional[List[int]] = None
    fewshot_n_adapters: str = "multiple"  # "one" | "multiple"
    fewshot_n_tokens: Optional[int] = None


ALL_GROUPS = (
    DatasetArgs,
    HypnetArgs,
    LMArgs,
    MEncArgs,
    ProjectorArgs,
    TrainArgs,
    LoraArgs,
    FewshotArgs,
)


def _field_names(cls) -> List[str]:
    return [f.name for f in fields(cls)]


def parse_config(
    json_path_or_dict,
    groups: Sequence[type],
    allow_extra: bool = False,
):
    """Partition a flat experiment JSON into dataclass groups by field name.

    Mirrors HfArgumentParser.parse_json_file over a tuple of dataclasses
    (reference: dmi/train_projector.py:299-307).  Every key must belong to at
    least one group unless allow_extra.  A key present in several groups is
    assigned to each (HF behavior).
    """
    if isinstance(json_path_or_dict, (str,)):
        with open(json_path_or_dict, "r") as f:
            raw = json.load(f)
    else:
        raw = dict(json_path_or_dict)

    known = set()
    for g in groups:
        known.update(_field_names(g))
    extra = set(raw) - known
    if extra and not allow_extra:
        raise ValueError(f"Unknown config keys: {sorted(extra)}")

    out = []
    for g in groups:
        names = set(_field_names(g))
        kwargs = {k: v for k, v in raw.items() if k in names}
        out.append(g(**kwargs))
    return tuple(out)


def _apply_finetune_mm_dim(
    train_args: TrainArgs, menc_args: MEncArgs, projector_args: ProjectorArgs
) -> None:
    """finetune_mm_dim routing shared by all three entry points: prune when
    the encoder is narrower than the shared interface, InfFS top-k when it
    is wider (reference: dmi/train_projector.py:178-184,
    dmi/train_hypernet.py:465-472, dmi/train_lora.py:162-169)."""
    if train_args.finetune_mm_dim is not None:
        if menc_args.mm_dim < train_args.finetune_mm_dim:
            projector_args.proj_prune = menc_args.mm_dim
        elif menc_args.mm_dim > train_args.finetune_mm_dim:
            train_args.n_components = train_args.finetune_mm_dim
            menc_args.mm_dim = train_args.finetune_mm_dim


def projector_post_init(train_args: TrainArgs, menc_args: MEncArgs, projector_args: ProjectorArgs) -> None:
    _apply_finetune_mm_dim(train_args, menc_args, projector_args)


def hypernet_post_init(
    hn_args: HypnetArgs,
    projector_args: ProjectorArgs,
    train_args: TrainArgs,
    menc_args: MEncArgs,
) -> None:
    hn_args.hn_n_proj_layers = projector_args.proj_n_layers
    _apply_finetune_mm_dim(train_args, menc_args, projector_args)


def lora_post_init(
    train_args: TrainArgs,
    menc_args: MEncArgs,
    lora_args: LoraArgs,
    projector_args: ProjectorArgs,
) -> None:
    lora_args.lora_n_proj_layers = projector_args.proj_n_layers
    _apply_finetune_mm_dim(train_args, menc_args, projector_args)


def apply_debug_overrides(train_args: TrainArgs, kind: str) -> None:
    """Debug mode shrinks batches and forces frequent eval/generate — the
    reference's integration smoke test (dmi/train_projector.py:190-199,
    dmi/train_hypernet.py:480-489)."""
    if not train_args.debug:
        return
    if kind == "hypernet":
        train_args.train_batch_size = 4
        train_args.subset_batch_size = 128
        train_args.eval_batch_size = 4
    else:
        train_args.train_batch_size = max(1, train_args.train_batch_size // 32)
        train_args.subset_batch_size = max(1, train_args.subset_batch_size // 32)
        train_args.eval_batch_size = max(1, train_args.eval_batch_size // 32)
    train_args.eval_steps = 1
    train_args.generate_steps = 4
    train_args.logging_steps = 1
    train_args.save_steps = 2


def asdict_flat(*args_groups) -> dict:
    out: dict[str, Any] = {}
    for g in args_groups:
        out.update(dataclasses.asdict(g))
    return out
