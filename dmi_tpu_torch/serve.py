"""Captioning service: embeddings in, captions out (counterpart of
dmi_tpu/serve.py).

    captioner = Captioner.from_checkpoint(
        lm="test:1b", projector_ckpt="checkpoints/...-projector-best.pt",
        dataset="sydney", device="cuda",
    )
    captions = captioner.caption(embeddings)   # [N, mm_dim] -> N strings

Per batch: l2-normalize, project (the fused MLP2 CUDA kernel), prepend the
soft token to the chat prefix, greedy-decode on the batch-last loop (per
step: the decode-attention and decode-MLP CUDA kernels on every layer, the
fused head + argmax kernel once for a bf16 head, tied or untied; with
int8="w8a8"|"w4a8" the int8 matmul kernels in place of the layers' matmuls
and an untied head's).  Every decoder family serves alike
(models/llama.py): a MoE layer's routed MLP and an MLA layer's attention
run as torch ops, as dmi_tpu runs them in XLA.  The
tail batch is padded to the batch size, as in the JAX package.  With a
temperature the loop samples (top-k, top-p) with request-indexed draws;
engine="bulk" serves the workload on the continuous-batching engine
(streaming.py), and the default engine="auto" picks between the two from
the first batch.  speculative=k decodes by draft-verify rounds with a
W4A8 copy of the same weights as the draft (models/speculative.py): greedy
captions identical to the plain loop's, sampled ones with its law, on the
batch engine and (engine="bulk") the speculative slot engine.

CLI:  python -m dmi_tpu_torch.serve --lm test:tiny --projector-ckpt P
      --dataset sydney --embs embs.npy --out captions.json
      [--int8 [1|w8a8|w4a8]] [--temperature T --top-k K --top-p P --seed S]
      [--engine auto|batch|bulk] [--speculative K] [--device cpu]

It runs on the card unless asked for the CPU, and fails before loading
anything when no card is visible.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from dmi_tpu_torch.models import mmmodel
from dmi_tpu_torch.models import projector as proj
from dmi_tpu_torch.models.llama import fuse_projections
from dmi_tpu_torch.models.quant import quantize_llama
from dmi_tpu_torch.models.speculative import speculative_bulk_caption
from dmi_tpu_torch.ops import l2_normalize
from dmi_tpu_torch.streaming import StreamingCaptioner
from dmi_tpu_torch.training.checkpoint import load_pytree
from dmi_tpu_torch.training.model_utils import build_lm, build_tokenizer, require_device


# engine="auto" regime constants, dmi_tpu's (dmi_tpu/serve.py:47-53): never
# bulk above _BULK_MAX_POOL slots; after a probe batch on the batch engine,
# bulk only when the mean caption length is under _BULK_LEN_RATIO of the
# budget (idle lanes to refill).  dmi_tpu chose them from TPU measurements;
# the card's captions/s of both engines are in PERF.md.
_BULK_MAX_POOL = 384
_BULK_LEN_RATIO = 0.75


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


class Captioner:
    """Captioner over one LLM and one projector: greedy by default, sampled
    with a temperature.

    int8: False serves the weights as they are; True quantizes them to int8
    and widens them at each matmul; "w8a8" runs int8 x int8 matmuls in the
    token loop; "w4a8" packs the layer weights to int4 for the token loop
    (its embed stays int8).  The last two keep the unquantized originals for
    the compute-bound prefill (llm_params_prefill), as dmi_tpu does.
    batch_first=True pins the batch-first decode loop (a parity oracle: the
    batch-last loop is the default and is token-identical).

    speculative=k: draft-verify decoding, k proposals a round, with a W4A8
    copy of the same weights (quantize_llama(bits=4)) as the draft and the
    unquantized tree as its prefill, so its prompt cache is the target's
    (share_prefill).  Greedy captions equal the plain loop's (greedy
    rejection), sampled ones keep its law; a w4a8 target is refused (it is
    already the cheapest loop), an MLA model at the first batch, as in
    dmi_tpu.  self.spec_rounds: the verify rounds of the last caption_ids
    call.  It takes precedence over batch_first, as dmi_tpu's speculative
    pipeline does over its batch-first switch.

    Surface difference from dmi_tpu.serve.Captioner: mesh_shape raises
    NotImplementedError naming its ROADMAP item; caption_ids takes the
    whole caption() surface (engine, sampling) and returns ids, for callers
    with no tokenizer.  Sampling on the batch engine always runs the
    batch-last loop (batch_first pins the greedy loop only), as in dmi_tpu.

    The chat prefix comes from `tokenizer` + `prefix` (the chat template
    applied, as in dmi_tpu), or directly as `prefix_ids`, with no tokenizer
    needed; `pad_token_id` defaults to the tokenizer's."""

    def __init__(
        self,
        llm_cfg,
        llm_params: dict,
        proj_spec: proj.ProjectorSpec,
        proj_params: dict,
        tokenizer=None,
        prefix: Optional[str] = None,
        max_new_tokens: int = 22,
        batch_size: int = 256,
        int8=False,
        mesh_shape: Optional[tuple] = None,
        speculative: int = 0,
        batch_first: bool = False,
        *,
        prefix_ids: Optional[Sequence[int]] = None,
        pad_token_id: Optional[int] = None,
    ):
        if int8 not in (False, True, "w8a8", "w4a8"):
            raise ValueError(f"int8 must be False, True, 'w8a8' or 'w4a8', got {int8!r}")
        if mesh_shape:
            raise _not_ported("mesh_shape", "A.10 (parallelism)")
        if speculative and int8 == "w4a8":
            raise ValueError("speculative=k needs a draft cheaper than the target loop; the "
                             "w4a8 target is already the cheapest flavor")
        if prefix_ids is None:
            if tokenizer is None or prefix is None:
                raise ValueError("pass tokenizer and prefix, or prefix_ids")
            prefix_ids = tokenizer.apply_chat_template(
                [{"role": "user", "content": prefix}],
                tokenize=True,
                add_generation_prompt=True,
            )
        if pad_token_id is None:
            if tokenizer is None:
                raise ValueError("pass pad_token_id when there is no tokenizer")
            pad_token_id = tokenizer.pad_token_id
        self.llm_cfg = llm_cfg
        llm_params = fuse_projections(llm_params)
        # self-speculation: the draft is a W4A8 copy of the same weights, its
        # prefill the unquantized tree (the target's prompt cache, shared)
        self.spec_k = int(speculative)
        self.draft_params = quantize_llama(llm_params, bits=4) if self.spec_k else None
        self.draft_prefill_params = llm_params if self.spec_k else None
        self.spec_rounds = 0
        # w8a8 and w4a8 quantize the token loop only: prefill runs on the
        # unquantized originals (one more weight copy in device memory)
        self.llm_params_prefill = llm_params if int8 in ("w8a8", "w4a8") else None
        if int8 == "w4a8":
            llm_params = quantize_llama(llm_params, bits=4)
        elif int8:
            llm_params = quantize_llama(llm_params, native=(int8 == "w8a8"))
        self.llm_params = llm_params
        self.batch_first = batch_first
        self.proj_spec = proj_spec
        self.proj_params = proj_params
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.batch_size = batch_size
        self.pad_token_id = pad_token_id
        self.device = self.llm_params["final_norm"].device
        self.engine_decision = None  # (engine, reason) of the last caption_ids call
        self.bulk_engine = None  # the StreamingCaptioner of the last bulk run
        self._prefix = torch.as_tensor(
            np.asarray(prefix_ids, np.int64), device=self.device
        )[None, :].expand(batch_size, -1)

    @classmethod
    def from_checkpoint(
        cls,
        lm: str,
        projector_ckpt: str,
        dataset: str,
        lm_dtype: str = "bfloat16",
        device="cuda",
        **kwargs,
    ) -> "Captioner":
        # imported here so that serving from parameters loads neither
        from dmi_tpu_torch.config import LMArgs
        from dmi_tpu_torch.registry import dataset_spec

        device = require_device(device)
        spec = dataset_spec(dataset)
        lm_args = LMArgs(lm_name_or_path=lm, lm_dtype=lm_dtype)
        tokenizer = build_tokenizer(lm_args)
        llm_cfg, llm_params = build_lm(lm_args, tokenizer, device=device)
        ckpt = load_pytree(projector_ckpt)
        if ckpt.get("generated_projector") is not None:
            # fewshot checkpoint: serve the baked generated projector
            tree = ckpt["generated_projector"]
        else:
            key = next(
                k for k in ckpt
                if k.endswith("_state_dict")
                and k not in ("optimizer_state_dict", "hypernet_state_dict")
            )
            tree = ckpt[key]
        pparams = {"layers": [
            {n: torch.as_tensor(np.asarray(layer[n]), device=device) for n in ("w", "b")}
            for layer in tree["layers"]
        ]}
        pspec = proj.ProjectorSpec(
            mm_dim=pparams["layers"][0]["w"].shape[0],
            lm_dim=llm_cfg.hidden_size,
            n_layers=len(pparams["layers"]),
        )
        prefix = spec.fixed_prefix or f"Describe the {spec.modality.value}"
        return cls(
            llm_cfg, llm_params, pspec, pparams, tokenizer,
            prefix, spec.max_new_tokens, **kwargs,
        )

    def _dispatch_batch(self, chunk: np.ndarray, temperature=None, top_k: int = 0,
                        seed: int = 0, row_start: int = 0, top_p: float = 1.0,
                        plain: bool = False):
        """Pad one chunk to the batch size and decode it (asynchronously on
        a CUDA device); returns (tokens [batch_size, max_new], real rows).
        row_start: the chunk's first workload row.  Sampling draws with
        request-indexed keys, request = workload row, so the bulk engine
        draws the same tokens for the same rows."""
        real = chunk.shape[0]
        if real < self.batch_size:  # pad the tail to the batch shape
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], self.batch_size - real, axis=0)], axis=0
            )
        embs = l2_normalize(torch.as_tensor(chunk, dtype=torch.float32, device=self.device))
        soft = proj.apply(self.proj_spec, self.proj_params, embs, plain=plain)
        req_ids = torch.arange(row_start, row_start + self.batch_size, device=self.device)
        if self.spec_k:
            common = dict(k=self.spec_k, prefill_params=self.llm_params_prefill,
                          draft_prefill_params=self.draft_prefill_params, share_prefill=True,
                          plain=plain)
            if temperature is None:
                tokens, rounds = mmmodel.caption_generate_speculative(
                    self.llm_cfg, self.llm_params, self.llm_cfg, self.draft_params, soft,
                    self._prefix, self.max_new_tokens, self.pad_token_id, **common)
            else:
                tokens, rounds = mmmodel.caption_sample_speculative(
                    self.llm_cfg, self.llm_params, self.llm_cfg, self.draft_params, soft,
                    self._prefix, self.max_new_tokens, self.pad_token_id, seed, temperature,
                    top_k, top_p, req_ids, **common)
            self.spec_rounds += rounds
        elif temperature is None:
            tokens = mmmodel.caption_generate(
                self.llm_cfg, self.llm_params, soft, self._prefix,
                self.max_new_tokens, self.pad_token_id,
                prefill_params=self.llm_params_prefill, batch_first=self.batch_first,
                plain=plain,
            )
        else:
            tokens = mmmodel.caption_sample(
                self.llm_cfg, self.llm_params, soft, self._prefix, self.max_new_tokens,
                self.pad_token_id, seed, temperature, top_k, top_p, req_ids=req_ids,
                prefill_params=self.llm_params_prefill, plain=plain,
            )
        return tokens, real

    def _caption_bulk(self, embeddings: np.ndarray, temperature=None, top_k: int = 0,
                      seed: int = 0, req_base: int = 0, top_p: float = 1.0,
                      plain: bool = False) -> torch.Tensor:
        """The continuous-batching engine over a whole workload (greedy, or
        request-indexed sampling with a temperature; streaming.py) ->
        LongTensor [N, max_new] on the CPU.  The engine stays in
        self.bulk_engine (its step and admission counts)."""
        eng = self.bulk_engine = StreamingCaptioner(
            self.llm_cfg, self.llm_params, self.proj_spec, self.proj_params,
            self._prefix[0], self.max_new_tokens, self.pad_token_id,
            # run_bulk uses every slot, but the pool invariant is >= 2
            pool=max(2, self.batch_size), admit=max(1, min(64, self.batch_size // 4)),
            prefill_params=self.llm_params_prefill, temperature=temperature, top_k=top_k,
            top_p=top_p, seed=seed, req_base=req_base, plain=plain,
        )
        return eng.run_bulk(l2_normalize(torch.as_tensor(embeddings, device=self.device)))

    def _caption_bulk_spec(self, embeddings: np.ndarray, temperature=None, top_k: int = 0,
                           seed: int = 0, top_p: float = 1.0,
                           plain: bool = False) -> torch.Tensor:
        """Speculative continuous batching (speculative_bulk_caption): the
        slot engine running draft-verify rounds with finished slots refilled.
        Greedy equals the batch speculative path and the plain greedy loop;
        sampled draws are keyed by (request, age), so it equals the batch
        speculative sampler on the same rows.  -> LongTensor [N, max_new] on
        the CPU."""
        chunk = max(1, min(64, self.batch_size // 4))
        sample = (None if temperature is None
                  else (float(temperature), int(top_k), float(top_p)))
        queue = l2_normalize(torch.as_tensor(embeddings, dtype=torch.float32,
                                             device=self.device))
        toks, rounds, _ = speculative_bulk_caption(
            self.llm_cfg, self.llm_params, self.llm_cfg, self.draft_params, self.proj_spec,
            self.proj_params, queue, self._prefix[:1].expand(chunk, -1),
            1 + self._prefix.shape[1], self.max_new_tokens, self.pad_token_id, chunk,
            max(chunk, self.batch_size), k=self.spec_k, prefill_params=self.llm_params_prefill,
            draft_prefill_params=self.draft_prefill_params, sample=sample, seed=seed,
            share_prefill=True, plain=plain)
        self.spec_rounds += rounds
        return toks.cpu()

    @torch.no_grad()
    def caption_ids(self, embeddings: np.ndarray, plain: bool = False,
                    temperature: Optional[float] = None, top_k: int = 0, top_p: float = 1.0,
                    seed: int = 0, engine: str = "batch") -> torch.Tensor:
        """Caption ids, LongTensor [N, max_new_tokens] on the CPU, pad-filled
        after each row's EOS.  plain=True runs the kernels' plain twins in
        place of the CUDA kernels (a reference path).

        Greedy by default (the reference's decode mode); a temperature
        samples, with top_k (0: off) and top_p (1.0: off), request-indexed
        by workload row and `seed`: the same tokens on every engine.

        engine="batch" (this method's default): fixed batches of
        batch_size, the tail padded.  engine="bulk": the continuous-batching
        engine (streaming.py): finished slots refilled with new requests.
        engine="auto" (caption()'s default, as in dmi_tpu): one batch or a pool over _BULK_MAX_POOL stays on the batch
        engine; otherwise the first batch is served on the batch engine as a
        probe, and the rest goes to bulk when its mean caption length is
        under _BULK_LEN_RATIO of the budget.  The decision and its reason
        land in self.engine_decision.  With speculative=k, "bulk" runs the
        speculative slot engine (a budget of 1 has no round to speculate
        and stays on the batch engine, with the same ids) and "auto" stays
        on the batch engine, as in dmi_tpu (its probe's length model is the
        plain engines')."""
        if engine not in ("auto", "batch", "bulk"):
            raise ValueError(f"unknown engine {engine!r}")
        embeddings = np.asarray(embeddings, np.float32)
        n = embeddings.shape[0]
        sampling = dict(temperature=temperature, top_k=top_k, seed=seed, top_p=top_p,
                        plain=plain)
        self.spec_rounds = 0
        if self.spec_k:
            if engine == "bulk" and self.max_new_tokens >= 2 and n > 0:
                self.engine_decision = ("bulk", "explicit (speculative)")
                return self._caption_bulk_spec(embeddings, **sampling)
            engine = "batch"
        decision, reason, probe = engine, "explicit", False
        if engine == "auto":
            if n <= self.batch_size:
                decision, reason = "batch", "single batch (nothing to amortize)"
            elif self.batch_size > _BULK_MAX_POOL:
                decision, reason = "batch", (
                    f"pool {self.batch_size} > {_BULK_MAX_POOL} "
                    "(bulk measured a wash at 512)")
            else:
                decision, probe = "batch", True
        if decision == "bulk" and n > 0:
            self.engine_decision = ("bulk", reason)
            return self._caption_bulk(embeddings, **sampling)

        out = []
        start = 0
        if probe:
            # decide from the first batch, served on the batch engine
            tokens, _ = self._dispatch_batch(embeddings[: self.batch_size], row_start=0,
                                             **sampling)
            tokens = tokens.cpu()
            out.append(tokens)
            # the loops write pad after a row ends: its non-pad count is
            # the caption's length
            lens = (tokens != self.pad_token_id).sum(dim=1).float()
            ratio = float(lens.mean()) / max(1, self.max_new_tokens)
            start = self.batch_size
            if ratio < _BULK_LEN_RATIO:
                self.engine_decision = (
                    "bulk", f"probe: mean-length ratio {ratio:.2f} < "
                    f"{_BULK_LEN_RATIO} (idle-lane waste; bulk regime)")
                out.append(self._caption_bulk(embeddings[start:], req_base=start, **sampling))
                return torch.cat(out)
            self.engine_decision = (
                "batch", f"probe: mean-length ratio {ratio:.2f} >= "
                f"{_BULK_LEN_RATIO} (bulk eos-free overhead)")
        else:
            self.engine_decision = ("batch", reason)
        # every batch is dispatched before the first is read back, so that
        # host preparation overlaps the device's decode
        pending = [
            self._dispatch_batch(embeddings[s: s + self.batch_size], row_start=s, **sampling)
            for s in range(start, n, self.batch_size)
        ]
        out.extend(tokens[:real].cpu() for tokens, real in pending)
        if not out:
            return torch.zeros((0, self.max_new_tokens), dtype=torch.long)
        return torch.cat(out)

    def caption(
        self,
        embeddings: np.ndarray,
        temperature: Optional[float] = None,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        engine: str = "auto",
    ) -> List[str]:
        """Captions, one string per row of embeddings [N, mm_dim]: greedy by
        default, sampled with a temperature (see caption_ids; the captions
        are the same on every engine)."""
        if engine not in ("auto", "batch", "bulk"):
            raise ValueError(f"unknown engine {engine!r}")
        if self.tokenizer is None:
            raise ValueError("caption() needs a tokenizer; use caption_ids()")
        ids = self.caption_ids(embeddings, temperature=temperature, top_k=top_k, top_p=top_p,
                               seed=seed, engine=engine)
        return self.tokenizer.batch_decode(ids.numpy(), skip_special_tokens=True)


def _load_embs(path: str):
    import pickle

    if path.endswith(".npy"):
        arr = np.load(path)
        return [str(i) for i in range(arr.shape[0])], arr
    with open(path, "rb") as f:
        d = pickle.load(f)
    ids = list(d)
    key = "emb" if "emb" in next(iter(d.values())) else "embs"
    embs = np.stack([np.asarray(d[i][key], np.float32) for i in ids])
    if embs.ndim == 3:
        embs = embs[:, 0]
    return ids, embs


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--lm", required=True)
    ap.add_argument("--projector-ckpt", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--embs", required=True, help=".npy array or reference-schema .pkl")
    ap.add_argument("--out", default="captions.json")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--int8", nargs="?", const="1", default=None,
                    choices=["1", "w8a8", "w4a8"],
                    help="quantize the LLM: int8 weights widened at the matmul (1), int8 x "
                         "int8 matmuls (w8a8) or int4 weights with int8 activations (w4a8) "
                         "in the token loop")
    ap.add_argument("--temperature", type=float, default=None,
                    help="sample at this temperature (default: greedy)")
    ap.add_argument("--top-k", type=int, default=0, help="top-k filter when sampling (0: off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus mass when sampling (1.0: off)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the sampling draws")
    ap.add_argument("--engine", choices=["auto", "batch", "bulk"], default="auto",
                    help="batch: fixed batches; bulk: continuous batching; auto probes the "
                         "first batch and picks (the captions are the same on every engine)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="draft-verify decode with a W4A8 self-draft proposing K tokens a "
                         "round: greedy output identical to the plain loop's, sampling with "
                         "its law; on the batch and bulk engines")
    ap.add_argument("--lm-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="the LM's weights and activations (a config's lm_dtype)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cap = Captioner.from_checkpoint(
        args.lm, args.projector_ckpt, args.dataset, lm_dtype=args.lm_dtype, device=args.device,
        batch_size=args.batch_size,
        int8={None: False, "1": True}.get(args.int8, args.int8),
        speculative=args.speculative,
    )
    ids, embs = _load_embs(args.embs)
    captions = cap.caption(embs, temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, seed=args.seed, engine=args.engine)
    if cap.engine_decision is not None:
        print("engine: {} ({})".format(*cap.engine_decision))
    with open(args.out, "w") as f:
        json.dump(dict(zip(ids, captions)), f, indent=2)
    print(f"wrote {len(captions)} captions -> {args.out}")


if __name__ == "__main__":
    main()
