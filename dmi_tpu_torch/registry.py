# Copy of dmi_tpu/registry.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Dataset / encoder / modality registry.

The reference implements nine near-identical loader subclasses
(dmi/data/{coco,audiocaps,openvid,sharegpt4v,clothodetail,sharegpt4video,
chebi20,candels,sydney}.py) that differ only in a handful of constants and
three behavioral switches.  Here those become one declarative table of
``DatasetSpec`` consumed by a single loader implementation
(dmi_tpu/data/loader.py) — less code, same behavior.

Behavioral provenance per field is cited inline.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


class Modality(str, enum.Enum):
    """Reference: dmi/model/__init__.py:15-22."""

    IMAGE = "image"
    AUDIO = "audio"
    VIDEO = "video"
    TEXT = "text"
    MOLECULE = "molecule"
    SATELLITE = "satellite"
    GALAXY = "galaxy"


@dataclass(frozen=True)
class DatasetSpec:
    """Everything that distinguishes one dataset loader from another.

    Fields map to the constants/overrides of the reference loader classes:
      * ``emb_key``      — pkl value key holding the embedding ('emb'/'embs')
      * ``emb_index``    — some datasets store a leading axis and take [0]
                           in their collates (e.g. dmi/data/audiocaps.py:85,
                           dmi/data/sharegpt4v.py:102, dmi/data/openvid.py:84)
      * ``fixed_prefix`` — pretrain datasets use one hard-coded instruction
                           (dmi/data/coco.py:59); None means a per-batch
                           random instruction drawn from the prefix pkl
                           (dmi/data/base.py:205-219)
      * ``prefix_pkl``   — file under data/prefixes/ holding
                           {instruction: text-embedding} for subset
                           conditioning (dmi/data/base.py:128-131,
                           dmi/data/sharegpt4v.py:20-23)
      * ``subsample``    — 'shuffle': train.shuffle(seed).select(n)
                           (dmi/data/coco.py:124-126); 'baseid': keep whole
                           caption groups per base id
                           (dmi/data/base.py:139-157)
      * ``caps_per_image``— captions per underlying item, used by the
                           'baseid' subsampler (dmi/data/sydney.py:13)
      * ``text_emb_key`` — key form of the gte-modernbert text-emb pkl:
                           'int_first' -> (int(id.split('_')[0]), caption)
                           (dmi/data/coco.py:90); 'full_id' -> (id, caption)
                           (dmi/data/sharegpt4v.py:45); 'item_id' ->
                           (item[id_key], caption) (dmi/data/base.py:114)
      * ``has_test_split`` — fewshot datasets carry train/validation/test;
                           pretrain/hypernet ones only train/validation
                           (dmi/data/base.py:187-203 vs dmi/data/coco.py:114)
      * ``pretokenize``  — pretrain datasets tokenize once at init with the
                           fixed prefix (dmi/data/coco.py:136-137); others
                           re-tokenize per batch with a random prefix
      * ``has_smiles``   — chebi20 embeds the SMILES string in the user turn
                           (dmi/data/chebi20.py:51-65)
      * ``clamp_dataset_size`` — clothodetail clamps the requested train size
                           to the dataset length (dmi/data/clothodetail.py:77-80)
    """

    name: str
    modality: Modality
    path: str  # relative to data_root
    id_key: str
    emb_key: str
    max_new_tokens: int
    emb_index: Optional[int] = None
    fixed_prefix: Optional[str] = None
    prefix_pkl: Optional[str] = None
    subsample: str = "baseid"  # 'baseid' | 'shuffle'
    caps_per_image: int = 1
    text_emb_key: str = "item_id"  # 'int_first' | 'full_id' | 'item_id'
    has_test_split: bool = False
    pretokenize: bool = False
    has_smiles: bool = False
    clamp_dataset_size: bool = False


DATASETS: dict[str, DatasetSpec] = {
    # --- Stage 1: projector pretrain (high-resource) ---------------------
    "coco": DatasetSpec(
        name="coco", modality=Modality.IMAGE, path="coco", id_key="imageid",
        emb_key="embs", max_new_tokens=56, fixed_prefix="Caption the image",
        subsample="shuffle", text_emb_key="int_first", pretokenize=True,
    ),
    "audiocaps": DatasetSpec(
        name="audiocaps", modality=Modality.AUDIO, path="audiocaps",
        id_key="audioid", emb_key="embs", emb_index=0, max_new_tokens=42,
        fixed_prefix="Caption the audio", subsample="shuffle",
        text_emb_key="int_first", pretokenize=True,
    ),
    "openvid": DatasetSpec(
        name="openvid", modality=Modality.VIDEO, path="openvid",
        id_key="videoid", emb_key="emb", emb_index=0, max_new_tokens=77,
        fixed_prefix="Describe the video", subsample="shuffle",
        text_emb_key="int_first", pretokenize=True,
    ),
    # --- Stage 2: hypernet training (high-resource, random instructions) -
    "sharegpt4v": DatasetSpec(
        name="sharegpt4v", modality=Modality.IMAGE, path="sharegpt4v",
        id_key="imageid", emb_key="emb", emb_index=0, max_new_tokens=328,
        prefix_pkl="image_inst.pkl", subsample="shuffle", text_emb_key="full_id",
    ),
    "clothodetail": DatasetSpec(
        name="clothodetail", modality=Modality.AUDIO, path="clothodetail",
        id_key="audioid", emb_key="emb", max_new_tokens=88,
        prefix_pkl="audio_inst.pkl", subsample="shuffle", text_emb_key="full_id",
        clamp_dataset_size=True,
    ),
    "sharegpt4video": DatasetSpec(
        name="sharegpt4video", modality=Modality.VIDEO, path="sharegpt4video",
        id_key="videoid", emb_key="embs", max_new_tokens=605,
        prefix_pkl="video_inst.pkl", subsample="shuffle", text_emb_key="full_id",
    ),
    # --- Stage 3: unseen low-resource modalities (few-shot targets) ------
    "chebi20": DatasetSpec(
        name="chebi20", modality=Modality.MOLECULE, path="chebi20",
        id_key="molid", emb_key="emb", max_new_tokens=401,
        prefix_pkl="molecule_inst.pkl", subsample="baseid", caps_per_image=1,
        has_test_split=True, has_smiles=True,
    ),
    "candels": DatasetSpec(
        name="candels", modality=Modality.GALAXY, path="candels",
        id_key="imageid", emb_key="emb", max_new_tokens=94,
        prefix_pkl="galaxy_inst.pkl", subsample="baseid", caps_per_image=3,
        has_test_split=True,
    ),
    "sydney": DatasetSpec(
        name="sydney", modality=Modality.SATELLITE, path="sydney",
        id_key="imageid", emb_key="emb", max_new_tokens=22,
        prefix_pkl="satellite_inst.pkl", subsample="baseid", caps_per_image=5,
        has_test_split=True,
    ),
}


# Encoder -> modality (reference: dmi/model/__init__.py:49-64).
ENCODER_MODALITIES: dict[str, Modality] = {
    "openai/clip-vit-large-patch14": Modality.IMAGE,
    "timm/caformer_b36.sail_in22k": Modality.IMAGE,
    "clap-htsat-fused": Modality.AUDIO,
    "alibaba-pai/VideoCLIP-XL": Modality.VIDEO,
    "timm/ViT-L-16-SigLIP2-384": Modality.IMAGE,
    "Cacophony": Modality.AUDIO,
    "ospanbatyr/Cacophony": Modality.AUDIO,
    "OpenGVLab/ViCLIP-B-16": Modality.VIDEO,
    "chendelong/RemoteCLIP-RN50-Unchanged": Modality.SATELLITE,
    "chendelong/RemoteCLIP-ViT-B-32-Unchanged": Modality.SATELLITE,
    "chendelong/RemoteCLIP-ViT-L-14": Modality.SATELLITE,
    "acharkq/MolCA": Modality.MOLECULE,
    "mwalmsley/zoobot-encoder-convnext_base": Modality.GALAXY,
    "mwalmsley/zoobot-encoder-convnext_tiny": Modality.GALAXY,
    "mwalmsley/zoobot-encoder-convnext_nano": Modality.GALAXY,
}

# Encoder embedding dims (reference: per-config mm_dim values, SURVEY.md §2 row 30).
ENCODER_DIMS: dict[str, int] = {
    "openai/clip-vit-large-patch14": 768,
    "clap-htsat-fused": 768,
    "alibaba-pai/VideoCLIP-XL": 768,
    "timm/ViT-L-16-SigLIP2-384": 768,
    "Cacophony": 768,
    "ospanbatyr/Cacophony": 768,
    "OpenGVLab/ViCLIP-B-16": 768,
    "chendelong/RemoteCLIP-RN50-Unchanged": 1024,
    "chendelong/RemoteCLIP-ViT-B-32-Unchanged": 512,
    "chendelong/RemoteCLIP-ViT-L-14": 768,
    "acharkq/MolCA": 768,
    "mwalmsley/zoobot-encoder-convnext_base": 1024,
    "mwalmsley/zoobot-encoder-convnext_tiny": 768,
    "mwalmsley/zoobot-encoder-convnext_nano": 640,
}


def dataset_spec(name: str) -> DatasetSpec:
    try:
        return DATASETS[name]
    except KeyError:
        raise KeyError(f"Unknown dataset '{name}'. Known: {sorted(DATASETS)}")
