"""Speculative (draft-verify) decoding, batch-last (counterpart of
dmi_tpu/models/speculative.py).

A cheap draft proposes k tokens a round; the target verifies all k + 1
positions ([last emitted, d_1 .. d_k]) in ONE forward over P * B lanes,
P = k + 1, so each of its weights is read once a round instead of once a
token.  Greedy rejection accepts d_i iff it equals the target's argmax after
d_1 .. d_{i-1}, and the first mismatch is replaced by that argmax: every
emitted token is the target's greedy choice given its prefix, so the output
equals the plain greedy loop's (dec.greedy_generate_bl) for ANY draft, under
identical forward numerics (f32 on the CPU, pinned in
tests/test_torch_speculative.py); on bf16 a near-tie may resolve otherwise
between the k + 1-position and the 1-position forwards (dmi_tpu's exactness
contract, speculative.py:14-26).

Row bookkeeping, as dmi_tpu's: every round writes k + 1 PHYSICAL cache rows
shared by the batch (rows T + rnd * (k + 1) .. + k; S = T + (k + 1) *
(budget - 1) rows, never compacted), per-slot LOGICAL positions live in
row_pos and rejected proposals are re-masked in valid, both [B, S] like the
slot engine's SlotState (dmi_tpu keeps [S, B]).  The verify's bias is
[B, P, S] (a causal row per query position), built from (valid, row_pos).
The draft runs k + 1 single-token steps of dec._decode_step_bl with per-slot
rope, write row and [B, S] bias (the slot engine's convention) over its own
cache of the same design.

What runs on the card: the verify forward is dec._decode_step_bl with P
query positions per cache row (_verify_step_bl), so its attention is the
decode-attention kernel over k + 1 positions (K3, ops/cuda/decode_attn), its
matmuls _mm_bl by weight kind (the int8 kernels on quantized trees), its
unquantized fused MLP the decode-MLP kernel at N = P * B and MoE layers
_moe_mlp_bl; the draft's steps are the slot engine's (decode attention with
a bias row per slot, kernel 7 on the W4A8 self-draft).  Greedy selection on
bf16 trees goes through the fused head + argmax wherever greedy_generate_bl
takes it (dec.fused_head_weights): the verify's P * B columns and the
draft's B (q8 mode on a W4A8 draft).  The measurement harness
(speculative_generate_forced_bl) needs the logits for its margin and keeps
the logits path.

Differences from dmi_tpu, each a consequence of eager torch or a repair:

  * lax.while_loop's condition is one host read a round of done.all(), as
    the port's bulk_caption reads its live count;
  * caches are written IN PLACE, so share_prefill gives the draft a COPY of
    the target's prefill caches (dmi_tpu shares an immutable array): the
    target and the draft write the same physical rows, and without the copy
    the verify's K/V would overwrite the draft's;
  * the draft's last step of a round (j = k) only writes its K/V: its head
    and its draw, which dmi_tpu computes and discards, are skipped;
  * _chain_next computes in int64 (dmi_tpu's int32 overflows above a vocab
    of about 271k) and _excl_shift deduplicates the eos ids (dmi_tpu's
    shifts twice for a repeated id, landing on an excluded id);
  * the draws are the port's (dec._req_keys, uniform_draws, _gumbel_pick),
    not JAX's threefry; dmi_tpu's fold_in(K, 1) and fold_in(K, 2) become
    _subkeys(K, 1) and _subkeys(K, 2);
  * the engines are host loops over rounds (dmi_tpu's bulk engine is one
    on-device while_loop); on a mesh (dmi_tpu's _pin_spec_pool shards the
    pool over 'data') each data rank runs its share of the queue in pool / d
    slots, and acceptance is decided from the merged, replicated tokens, so
    the model ranks of one data rank run their rounds in lockstep; the
    queue is not padded to a bucketed length (bucket_queue_len bounds XLA
    compiles, which eager torch does not have).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from dmi_tpu_torch.models import decode as dec
from dmi_tpu_torch.models import llama, mmmodel
from dmi_tpu_torch.models import projector as proj
from dmi_tpu_torch.models.llama import LlamaConfig
from dmi_tpu_torch.parallel.collectives import engine_shard

NEG = llama.NEG_INF


def _refuse_mla(*cfgs: LlamaConfig) -> None:
    if any(c.kv_lora_rank is not None for c in cfgs):
        raise NotImplementedError(
            "speculative decoding does not support MLA (deepseek-v2) "
            "targets/drafts yet — the verify forward uses the expanded "
            "per-head KV layout; use the plain batch/engine decode paths "
            "(greedy_generate_bl / streaming), which run MLA on the "
            "compressed-latent cache"
        )


def _embed_bl(cfg: LlamaConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The batch-last stream entry [H, n] of n token ids."""
    h = llama.scale_embeds(cfg, llama.embed_tokens(cfg, params, tokens).t().to(cfg.dtype))
    return h.contiguous()


def _select(out: torch.Tensor, head_w: Optional[dict], plain: bool) -> torch.Tensor:
    """Greedy ids [n] of a step's output: the fused head + argmax over the
    final norm's output [H, n] where head_w is given, else the argmax of the
    logits [V, n]."""
    if head_w is None:
        return out.argmax(dim=0)
    return dec.head_ids(head_w, out, plain)


def _verify_step_bl(cfg, params, h, caches, qpos, bias, rt: int, bias_sw=None,
                    head: bool = True, plain: bool = False):
    """Target forward over P = k + 1 speculative positions, batch-last
    (dmi_tpu's _verify_step_bl): h [H, P * B], lane p * B + b the embedding
    of row b's in-round token p; caches ([L, B, nkv, S, hd] x 2) written IN
    PLACE at rows rt .. rt + P - 1; qpos [P, B] logical query positions;
    bias / bias_sw [B, P, S].  The layer body is dec._decode_step_bl's with
    P positions per cache row (every family branch, the kernels by weight
    kind).  Returns the logits [V, P * B] without final_softcap (greedy
    consumers need their argmax; the sampler caps them), or with head=False
    the final norm's output [H, P * B] for the fused head + argmax."""
    positions = qpos.reshape(-1)
    cos, sin = llama.rope_tables(cfg, positions)  # [P * B, rope_dim]
    local = dec._local_rope(cfg, positions)
    return dec._decode_step_bl(
        cfg, params, h, caches, None, head=head, plain=plain, rope=(cos.t(), sin.t()),
        write_row=rt, bias=bias, bias_sw=bias_sw,
        rope_local=None if local is None else (local[0].t(), local[1].t()))


def _stamp_rows(valid, row_pos, r0: int, count: int, live, positions) -> None:
    """Mark `count` rows from physical row r0 valid for the live slots (and
    invalid for the others) and stamp their logical positions [B, count];
    in place."""
    valid[:, r0:r0 + count] = live[:, None]
    row_pos[:, r0:r0 + count] = positions


def _retract_rows(valid, r0: int, k: int, n_acc) -> None:
    """After acceptance, rows r0 + 1 + n_acc[b] .. r0 + k (this round's
    rejected proposals) become invalid for slot b; row r0 (the consumed
    emitted token) stays; in place."""
    j = torch.arange(1, k + 1, device=valid.device)
    valid[:, r0 + 1:r0 + k + 1] &= j[None, :] <= n_acc[:, None]


def _bias_from(valid, row_pos, qpos, cfg: LlamaConfig, sliding_on: bool):
    """[B, P, S] additive biases from the row bookkeeping: a key row is
    attendable by query (p, b) iff it is valid for slot b and holds a
    logical position <= qpos[p, b]; sliding families additionally require
    qpos - row_pos < window (bias_sw, None when no window binds).  Both
    contiguous, as the kernel reads them (a broadcast of the transposed
    qpos may give a permuted layout)."""
    qp = qpos.t()[:, :, None]  # [B, P, 1]
    rp = row_pos[:, None, :]   # [B, 1, S]
    ok = valid[:, None, :] & (rp <= qp)
    bias = torch.where(ok, 0.0, NEG).contiguous()
    bias_sw = None
    if sliding_on:
        bias_sw = torch.where(ok & llama.window_mask(cfg, qp, rp), 0.0, NEG).contiguous()
    return bias, bias_sw


@dataclass
class _SpecCore:
    """Target-side state of a batch (or of the engine's pool), updated in
    place round by round."""

    done: torch.Tensor     # [B] bool (the engine: free slots are done)
    last: torch.Tensor     # [B] int64: last emitted token (its K/V not yet written)
    out_pos: torch.Tensor  # [B] int64: tokens emitted so far
    tokens: torch.Tensor   # [B, budget] int64, pad-filled
    caches: tuple          # K, V [L, B, nkv, S, hd]
    valid: torch.Tensor    # [B, S] bool
    row_pos: torch.Tensor  # [B, S] int64


def _advance(core: _SpecCore, props, a_ids, k: int, budget: int, eos, n_acc=None):
    """Acceptance and bookkeeping for one round, in place: props [k, B] the
    draft's proposals; a_ids [k + 1, B] correction tokens (a_i: the token to
    emit if the first rejection lands at in-round index i; greedy: the
    target's argmax after d_1 .. d_i; sampling: the residual or bonus
    draw).  n_acc [B] accepted counts; None (greedy) derives them from d_i
    == a_{i-1}.  Emits the accepted drafts and the correction, truncated at
    the first EOS (inclusive) and at the budget.  Returns n_acc; the caller
    retracts its rows with it."""
    B = core.last.shape[0]
    dev = core.last.device
    live = ~core.done
    if n_acc is None:
        if k > 0:
            n_acc = torch.cumprod((props == a_ids[:-1]).long(), dim=0).sum(dim=0)
        else:
            n_acc = torch.zeros(B, dtype=torch.long, device=dev)
    i_idx = torch.arange(k + 1, device=dev)[:, None]
    d_pad = torch.cat([props, torch.zeros((1, B), dtype=torch.long, device=dev)])
    a_at = a_ids.gather(0, n_acc[None, :])  # [1, B]
    m = torch.where(i_idx < n_acc[None, :], d_pad, a_at)  # [k + 1, B]
    is_eos = torch.isin(m, eos).long()
    eos_before = torch.cumsum(is_eos, dim=0) - is_eos  # an EOS strictly earlier
    can_emit = ((i_idx <= n_acc[None, :]) & (eos_before == 0)
                & (core.out_pos[None, :] + i_idx < budget) & live[None, :])
    n_emit = can_emit.long().sum(dim=0)
    cols = core.out_pos[None, :] + i_idx
    onehot = ((cols[:, :, None] == torch.arange(budget, device=dev)[None, None, :])
              & can_emit[:, :, None])  # [k + 1, B, budget]
    upd = torch.where(onehot, m[:, :, None], torch.iinfo(torch.long).min).amax(dim=0)
    core.tokens = torch.where(onehot.any(dim=0), upd, core.tokens)
    core.out_pos = core.out_pos + n_emit
    emitted_eos = ((is_eos > 0) & can_emit).any(dim=0)
    core.done = core.done | emitted_eos | (core.out_pos >= budget)
    # the next round consumes the newest emitted token
    m_last = m.gather(0, (n_emit - 1).clamp(min=0)[None, :])[0]
    core.last = torch.where(live & (n_emit > 0), m_last, core.last)
    return n_acc


def _fresh_rows(B: int, T: int, S: int, device):
    """valid [B, S] (the T prompt rows) and row_pos [B, S] of a new batch:
    prompt rows hold positions 0 .. T - 1, the rest are stamped when
    written."""
    valid = torch.zeros((B, S), dtype=torch.bool, device=device)
    valid[:, :T] = True
    row_pos = torch.arange(S, device=device).clamp(max=T - 1).expand(B, S).contiguous()
    return valid, row_pos


def _spec_setup(cfg, params, prefill_params, inputs_embeds, max_new_tokens: int,
                pad_token_id: int, k: int, pick0=None, plain: bool = False):
    """Prefill and state of every flavour: caches of S = T + (k + 1) *
    (budget - 1) rows, token 0 from the prefill logits [B, V] (already
    final_softcap'd) by pick0, None = greedy argmax.  Returns (core, eos, T,
    max_rounds)."""
    _refuse_mla(cfg)
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    max_rounds = max(max_new_tokens - 1, 0)
    S = T + (k + 1) * max_rounds
    eos = torch.tensor(cfg.eos_token_ids, dtype=torch.long, device=dev)
    caches, logits0 = dec._prefill_caches(
        cfg, params if prefill_params is None else prefill_params, inputs_embeds, S, plain)
    tok0 = logits0.argmax(dim=-1) if pick0 is None else pick0(logits0)
    tokens = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.long, device=dev)
    tokens[:, 0] = tok0
    valid, row_pos = _fresh_rows(B, T, S, dev)
    core = _SpecCore(done=torch.isin(tok0, eos) | (max_new_tokens <= 1), last=tok0,
                     out_pos=torch.ones(B, dtype=torch.long, device=dev), tokens=tokens,
                     caches=caches, valid=valid, row_pos=row_pos)
    return core, eos, T, max_rounds


def _draft_setup(draft_cfg, draft_params, draft_prefill_params, draft_inputs_embeds, k: int,
                 max_rounds: int, from_target=None, plain: bool = False):
    """The draft's prefill and row bookkeeping, Sd = Td + (k + 1) *
    max_rounds rows.  Returns (caches, valid, row_pos, Td).

    from_target: the target's fresh prefill caches (share_prefill): the
    self-draft prefills the same inputs with the same weights and config,
    so its cache IS the target's and the second prefill is skipped.  The
    port writes caches in place and both models write the same rows, so
    the draft takes a copy."""
    _refuse_mla(draft_cfg)
    draft_cfg = llama.local_config(draft_cfg, draft_params)
    Bd, Td, _ = draft_inputs_embeds.shape
    Sd = Td + (k + 1) * max_rounds
    if from_target is not None:
        want = (draft_cfg.num_hidden_layers, Bd, draft_cfg.num_key_value_heads, Sd,
                draft_cfg.head_dim)
        if tuple(from_target[0].shape) != want:
            raise ValueError(
                "share_prefill needs the draft's cache layout to equal the target's; got "
                f"target {tuple(from_target[0].shape)} vs draft {want}")
        caches = tuple(c.clone() for c in from_target)
    else:
        caches, _ = dec._prefill_caches(
            draft_cfg, draft_params if draft_prefill_params is None else draft_prefill_params,
            draft_inputs_embeds, Sd, plain)
    valid, row_pos = _fresh_rows(Bd, Td, Sd, draft_inputs_embeds.device)
    return caches, valid, row_pos, Td


def _step_bias(cfg, valid, row_pos, pos, sliding: bool):
    """A single-token step's [B, S] biases at per-slot positions pos [B]."""
    ok = valid & (row_pos <= pos[:, None])
    bias = torch.where(ok, 0.0, NEG)
    bias_sw = None
    if sliding:
        bias_sw = torch.where(ok & llama.window_mask(cfg, pos[:, None], row_pos), 0.0, NEG)
    return bias, bias_sw


def _draft_step(draft_cfg, draft_params, cur, pos, row: int, caches_d, valid_d, rp_d, live,
                d_sliding: bool, head: bool, plain: bool):
    """One single-token draft step at per-slot positions pos [B], writing
    physical row `row`; returns the step's output (logits [V, B], or the
    final norm's [H, B] with head=False)."""
    _stamp_rows(valid_d, rp_d, row, 1, live, pos[:, None])
    bias, bias_sw = _step_bias(draft_cfg, valid_d, rp_d, pos, d_sliding)
    cos, sin = llama.rope_tables(draft_cfg, pos)  # [B, rope_dim]
    local = dec._local_rope(draft_cfg, pos)
    return dec._decode_step_bl(
        draft_cfg, draft_params, _embed_bl(draft_cfg, draft_params, cur), caches_d, None,
        head=head, plain=plain, rope=(cos.t(), sin.t()), write_row=row, bias=bias,
        bias_sw=bias_sw, rope_local=None if local is None else (local[0].t(), local[1].t()))


def _draft_steps_greedy(draft_cfg, draft_params, last, done, out_pos, caches_d, valid_d, rp_d,
                        rd: int, Td: int, k: int, d_sliding: bool, head_w=None,
                        plain: bool = False):
    """k + 1 greedy single-token draft steps: consume [last, p_1 .. p_k],
    write their K/V at physical rows rd .. rd + k, and return the proposals
    p_1 .. p_k [k, B].  The last step only writes its K/V.  Shared by the
    batch loop (monotone rd) and the slot engine (ring rd)."""
    live = ~done
    dpos0 = Td + out_pos - 1
    props, cur = [], last
    for j in range(k + 1):
        out = _draft_step(draft_cfg, draft_params, cur, dpos0 + j, rd + j, caches_d, valid_d,
                          rp_d, live, d_sliding, head=head_w is None and j < k, plain=plain)
        if j < k:
            cur = _select(out, head_w, plain)
            props.append(cur)
    return torch.stack(props) if k else last.new_zeros((0, last.shape[0]))


def _verify_target(cfg, params, core: _SpecCore, props, k: int, T: int, sliding_on: bool,
                   rt: int, head: bool = True, plain: bool = False):
    """The target side's preamble for every acceptance flavour: embed [last,
    props], stamp this round's k + 1 rows at physical rt, build the biases
    and run the verify forward.  Returns its output over the P * B lanes
    (logits [V, P * B], or the final norm's [H, P * B] with head=False)."""
    live = ~core.done
    pos = T + core.out_pos - 1  # [B] logical position of `last`
    qpos = pos[None, :] + torch.arange(k + 1, device=pos.device)[:, None]  # [P, B]
    in_tokens = torch.cat([core.last[None, :], props])  # [P, B]
    h = _embed_bl(cfg, params, in_tokens.reshape(-1))  # [H, P * B]
    _stamp_rows(core.valid, core.row_pos, rt, k + 1, live, qpos.t())
    bias, bias_sw = _bias_from(core.valid, core.row_pos, qpos, cfg, sliding_on)
    return _verify_step_bl(cfg, params, h, core.caches, qpos, bias, rt, bias_sw, head, plain)


def _verify_round(cfg, params, core: _SpecCore, props, rnd: int, k: int, T: int, budget: int,
                  eos, sliding_on: bool, rt: Optional[int] = None, head_w=None,
                  plain: bool = False):
    """The target side of one greedy round: verify [last, props], accept and
    advance.  rt: this round's physical row, by default the batch loop's
    monotone T + rnd * (k + 1); the slot engine passes a ring row.  Returns
    n_acc."""
    if rt is None:
        rt = T + rnd * (k + 1)
    out = _verify_target(cfg, params, core, props, k, T, sliding_on, rt,
                         head=head_w is None, plain=plain)
    a_ids = _select(out, head_w, plain).reshape(k + 1, -1)
    n_acc = _advance(core, props, a_ids, k, budget, eos)
    _retract_rows(core.valid, rt, k, n_acc)
    return n_acc


@torch.no_grad()
def speculative_generate_bl(
    cfg: LlamaConfig,
    params: dict,
    draft_cfg: LlamaConfig,
    draft_params: dict,
    inputs_embeds: torch.Tensor,
    draft_inputs_embeds: torch.Tensor,
    max_new_tokens: int,
    pad_token_id: int,
    k: int = 4,
    prefill_params: Optional[dict] = None,
    draft_prefill_params: Optional[dict] = None,
    share_prefill: bool = False,
    plain: bool = False,
) -> Tuple[torch.Tensor, int]:
    """Draft-model speculative greedy decode: token-identical to
    dec.greedy_generate_bl(cfg, params, ...) for ANY draft, under identical
    forward numerics (the draft only decides which prefix lengths a round
    verifies).  draft_inputs_embeds: the prompt in the draft's embedding
    space (the draft shares the target's vocab ids).  share_prefill: the
    self-draft fast path (the draft prefills the same inputs with the same
    weights and config as the target, as serve.Captioner(speculative=k)'s
    W4A8 self-draft does on the bf16 tree): the draft starts from a copy of
    the target's prefill caches.  plain=True runs every kernel's twin.

    Returns (tokens [B, max_new_tokens] int64, rounds): the verify forwards
    run, budget - 1 when the draft never helps, about budget / (k + 1) at
    full acceptance."""
    B = inputs_embeds.shape[0]
    if max_new_tokens == 0:
        return torch.zeros((B, 0), dtype=torch.long, device=inputs_embeds.device), 0
    budget = max_new_tokens
    core, eos, T, max_rounds = _spec_setup(cfg, params, prefill_params, inputs_embeds, budget,
                                           pad_token_id, k, plain=plain)
    if max_rounds == 0:  # budget 1: token 0 is the whole output
        return core.tokens, 0
    sliding_on = llama.sliding_effective(cfg, T + budget)
    kv_d, valid_d, rp_d, Td = _draft_setup(
        draft_cfg, draft_params, draft_prefill_params, draft_inputs_embeds, k, max_rounds,
        from_target=core.caches if share_prefill else None, plain=plain)
    d_sliding = llama.sliding_effective(draft_cfg, Td + budget)
    head_w, d_head_w = dec.fused_head_weights(cfg, params), dec.fused_head_weights(
        draft_cfg, draft_params)
    rnd = 0
    while rnd < max_rounds and not bool(core.done.all()):
        rd = Td + rnd * (k + 1)
        props = _draft_steps_greedy(draft_cfg, draft_params, core.last, core.done,
                                    core.out_pos, kv_d, valid_d, rp_d, rd, Td, k, d_sliding,
                                    d_head_w, plain)
        n_acc = _verify_round(cfg, params, core, props, rnd, k, T, budget, eos, sliding_on,
                              head_w=head_w, plain=plain)
        _retract_rows(valid_d, rd, k, n_acc)
        rnd += 1
    return core.tokens, rnd


@torch.no_grad()
def speculative_generate_oracle_bl(
    cfg: LlamaConfig,
    params: dict,
    inputs_embeds: torch.Tensor,
    oracle_tokens: torch.Tensor,
    max_new_tokens: int,
    pad_token_id: int,
    k: int = 4,
    wrong_period: int = 0,
    prefill_params: Optional[dict] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, int]:
    """Speculative decode with a free ORACLE draft, for measurement and
    adversarial tests: proposal i of a slot at output position q is
    oracle_tokens[b, q + i] [B, max_new_tokens], and with wrong_period = m
    > 0 every proposal whose output index is a multiple of m is corrupted
    (+1 mod vocab), forcing a rejection.  Sweeping m maps the verify side's
    cost against acceptance with no draft cost.  Token-identical to greedy
    decode whatever the oracle holds.  Returns (tokens, rounds)."""
    B = inputs_embeds.shape[0]
    if max_new_tokens == 0:
        return torch.zeros((B, 0), dtype=torch.long, device=inputs_embeds.device), 0
    budget = max_new_tokens
    core, eos, T, max_rounds = _spec_setup(cfg, params, prefill_params, inputs_embeds, budget,
                                           pad_token_id, k, plain=plain)
    if max_rounds == 0:
        return core.tokens, 0
    sliding_on = llama.sliding_effective(cfg, T + budget)
    head_w = dec.fused_head_weights(cfg, params)
    oracle = torch.as_tensor(oracle_tokens, device=inputs_embeds.device).long().t()  # [budget, B]
    offs = torch.arange(k, device=oracle.device)[:, None]
    rnd = 0
    while rnd < max_rounds and not bool(core.done.all()):
        at = core.out_pos[None, :] + offs  # [k, B] absolute output positions
        props = oracle.gather(0, at.clamp(0, budget - 1))
        if wrong_period > 0:
            props = torch.where(at % wrong_period == 0, (props + 1) % cfg.vocab_size, props)
        _verify_round(cfg, params, core, props, rnd, k, T, budget, eos, sliding_on,
                      head_w=head_w, plain=plain)
        rnd += 1
    return core.tokens, rnd


# ---------------------------------------------------------------------------
# Controlled-acceptance measurement harness (dmi_tpu's block comment at
# speculative.py:762-778): both models run their real forwards every round,
# but the target's argmax is margin-forced onto a deterministic token chain
# and the draft's proposals are overridden with that chain, corrupted at
# every wrong_period-th output position, so acceptance is exact and free of
# cascades and the wall clock at each wrong_period is the full pipeline's at
# that acceptance.
# ---------------------------------------------------------------------------


def _excl_shift(c: torch.Tensor, excl) -> torch.Tensor:
    """Map c in [0, V - len(excl)) injectively into [0, V) minus excl:
    c + #{i: excl_i - i <= c} over the sorted DISTINCT exclusions, the
    thresholds applied to the original value.  dmi_tpu's counts a repeated
    id twice and then lands on an excluded id."""
    shift = torch.zeros_like(c)
    for i, e in enumerate(sorted(set(int(x) for x in excl))):
        shift = shift + (c >= e - i).long()
    return c + shift


def _chain_next(tok: torch.Tensor, V: int, eos_ids, wrong: bool = False) -> torch.Tensor:
    """Deterministic successor token: an affine (LCG) step in the eos-free
    sub-vocab, shifted past the eos ids so that forced rows never end.
    wrong=True gives a token that differs from the clean successor.  In
    int64: dmi_tpu's int32 product overflows above a vocab of about 271k."""
    Vr = V - len(set(int(x) for x in eos_ids))
    c = (tok.long() * 7919 + 104729) % Vr
    if wrong:
        c = (c + 1) % Vr
    return _excl_shift(c, eos_ids)


def _verify_round_forced(cfg, params, core: _SpecCore, props, rnd: int, k: int, T: int,
                         budget: int, eos, sliding_on: bool, margin: float,
                         plain: bool = False):
    """_verify_round with the target's argmax margin-forced onto the chain:
    a_ids = argmax(logits + margin * onehot(chain(in_token))), the margin
    added in the logits' dtype as dmi_tpu adds it.  The verify forward runs
    unchanged."""
    rt = T + rnd * (k + 1)
    in_tokens = torch.cat([core.last[None, :], props])  # [P, B]
    logits = _verify_target(cfg, params, core, props, k, T, sliding_on, rt, plain=plain)
    tgt = _chain_next(in_tokens, logits.shape[0], cfg.eos_token_ids).reshape(-1)
    cols = torch.arange(tgt.shape[0], device=tgt.device)
    logits[tgt, cols] = logits[tgt, cols] + torch.tensor(margin, dtype=logits.dtype)
    a_ids = logits.argmax(dim=0).reshape(k + 1, -1)
    n_acc = _advance(core, props, a_ids, k, budget, eos)
    _retract_rows(core.valid, rt, k, n_acc)
    return n_acc


@torch.no_grad()
def speculative_generate_forced_bl(
    cfg: LlamaConfig,
    params: dict,
    draft_cfg: LlamaConfig,
    draft_params: dict,
    inputs_embeds: torch.Tensor,
    draft_inputs_embeds: torch.Tensor,
    max_new_tokens: int,
    pad_token_id: int,
    wrong_period: int,
    k: int = 4,
    margin: float = 1e4,
    prefill_params: Optional[dict] = None,
    draft_prefill_params: Optional[dict] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, int]:
    """Full-cost speculative decode at a CONTROLLED acceptance rate (a
    measurement harness, not a serving path): the rounds of
    speculative_generate_bl (the target's verify, the draft's k + 1 real
    steps, the same retraction), except that the target's argmax is
    margin-forced onto the chain tok -> _chain_next(tok) and the draft's
    proposals are that chain, corrupted at every output position that is a
    multiple of wrong_period (0: never, full acceptance).  The emitted
    tokens are the chain from token 0 whatever wrong_period, and the rounds
    follow in closed form.  Returns (tokens, rounds)."""
    B = inputs_embeds.shape[0]
    if max_new_tokens == 0:
        return torch.zeros((B, 0), dtype=torch.long, device=inputs_embeds.device), 0
    budget = max_new_tokens
    core, eos, T, max_rounds = _spec_setup(cfg, params, prefill_params, inputs_embeds, budget,
                                           pad_token_id, k, plain=plain)
    V = cfg.vocab_size
    # token 0 onto the chain too, so that no row ends at round 0
    core.last = _chain_next(core.last, V, cfg.eos_token_ids)
    core.tokens[:, 0] = core.last
    core.done = torch.zeros_like(core.done) | (budget <= 1)
    if max_rounds == 0:
        return core.tokens, 0
    sliding_on = llama.sliding_effective(cfg, T + budget)
    kv_d, valid_d, rp_d, Td = _draft_setup(draft_cfg, draft_params, draft_prefill_params,
                                           draft_inputs_embeds, k, max_rounds, plain=plain)
    d_sliding = llama.sliding_effective(draft_cfg, Td + budget)
    d_head_w = dec.fused_head_weights(draft_cfg, draft_params)
    offs = torch.arange(k, device=core.last.device)[:, None]

    def forced_props():
        chain, p = [], core.last
        for _ in range(k):
            p = _chain_next(p, V, cfg.eos_token_ids)
            chain.append(p)
        chain = torch.stack(chain)  # [k, B]
        corrupt = ((core.out_pos[None, :] + offs) % max(wrong_period, 1) == 0) & (
            wrong_period > 0)
        wrongs = _chain_next(torch.cat([core.last[None, :], chain[:-1]]), V,
                             cfg.eos_token_ids, wrong=True)
        return torch.where(corrupt, wrongs, chain)

    rnd = 0
    while rnd < max_rounds and not bool(core.done.all()):
        rd = Td + rnd * (k + 1)
        # the draft's real steps (their cost is what the harness measures);
        # its proposals are overridden by the chain
        _draft_steps_greedy(draft_cfg, draft_params, core.last, core.done, core.out_pos, kv_d,
                            valid_d, rp_d, rd, Td, k, d_sliding, d_head_w, plain)
        n_acc = _verify_round_forced(cfg, params, core, forced_props(), rnd, k, T, budget, eos,
                                     sliding_on, margin, plain)
        _retract_rows(valid_d, rd, k, n_acc)
        rnd += 1
    return core.tokens, rnd


# ---------------------------------------------------------------------------
# Stochastic speculative sampling (Leviathan et al. / Chen et al. 2023, as
# dmi_tpu's speculative.py:940-966): proposal d_i ~ q_i is accepted with
# probability min(1, p_i(d_i) / q_i(d_i)); the first rejection is replaced
# by a draw from norm(max(p_i - q_i, 0)), full acceptance earns a bonus draw
# from p_{k+1}.  The emitted marginal is the target's for any draft; p and q
# are the WARPED distributions (temperature, top-k, top-p: dec._warp_bl).
#
# Draws, keyed by (request, output age) as dec.sample_generate_bl's:
#   K(age)             = dec._req_keys(seed, req, budget, age)
#   proposal draw      = K(age)               (the plain sampler's own key)
#   acceptance uniform = _subkeys(K(age), 1)  (dmi_tpu: fold_in(K, 1))
#   residual draw      = _subkeys(K(age), 2)  (dmi_tpu: fold_in(K, 2))
#   bonus draw         = K(age)               (no other draw at that age)
# With draft == target every proposal is the plain sampler's draw and
# p == q, so u * q < p holds for every u < 1: the output is bit-identical to
# dec.sample_generate_bl.
# ---------------------------------------------------------------------------


def _subkeys(keys: torch.Tensor, i: int) -> torch.Tensor:
    """Stream i of the keys K (int64 in [0, 2**32)): fmix32(K ^ fmix32(i *
    0x9E3779B9 mod 2**32)), a bijection of K per i, so K's streams and the
    draws of K itself stay apart."""
    c = dec._fmix32(torch.tensor((i * 0x9E3779B9) & 0xFFFFFFFF, dtype=torch.long,
                                 device=keys.device))
    return dec._fmix32(keys ^ c)


def _softmax_v(w: torch.Tensor) -> torch.Tensor:
    """softmax over the vocab axis of warped [V, n] f32 logits, taken over
    the rows of the transpose: on the card a softmax over the leading axis
    of [V, n] is two orders slower (chip_smoke.py's speculative phase times
    both).  Returns a [V, n] view."""
    return torch.softmax(w.t().contiguous(), dim=1).t()


def _spec_keys(seed: int, req_ids, budget: int, ages) -> torch.Tensor:
    """K(age) over an [n, B] age grid (req_ids [B])."""
    return dec._req_keys(seed, req_ids[None, :].expand_as(ages), budget, ages)


def _draft_steps_sample(draft_cfg, draft_params, last, done, out_pos, caches_d, valid_d, rp_d,
                        rd: int, Td: int, k: int, d_sliding: bool, seed: int, req_ids,
                        budget: int, temperature: float, top_k: int, top_p: float,
                        plain: bool = False):
    """k + 1 stochastic draft steps at physical rows rd .. rd + k: proposal j
    is drawn from the draft's warped distribution with the plain sampler's
    key K(out_pos + j); the warped probability vectors are kept for the
    verify side.  The last step only writes its K/V.  Returns (props [k, B],
    q_w [V, k, B] f32).  Shared by the batch loop and the slot engine."""
    live = ~done
    dpos0 = Td + out_pos - 1
    props, qs, cur = [], [], last
    for j in range(k + 1):
        out = _draft_step(draft_cfg, draft_params, cur, dpos0 + j, rd + j, caches_d, valid_d,
                          rp_d, live, d_sliding, head=j < k, plain=plain)
        if j == k:
            break
        w_d = dec._warp_bl(llama.final_softcap(draft_cfg, out), temperature, top_k, top_p)
        cur = dec._gumbel_pick(w_d, dec._req_keys(seed, req_ids, budget, out_pos + j))
        props.append(cur)
        qs.append(_softmax_v(w_d))
    return torch.stack(props), torch.stack(qs, dim=1)


def _verify_round_sample(cfg, params, core: _SpecCore, props, q_w, rnd: int, k: int, T: int,
                         budget: int, eos, sliding_on: bool, seed: int, req_ids,
                         temperature: float, top_k: int, top_p: float,
                         rt: Optional[int] = None, plain: bool = False):
    """The target side of one stochastic round: verify [last, props], accept
    by u * q(d) < p(d) (u uniform in (0, 1); strict, so p == q always
    accepts), emit the residual or bonus draw.  q_w [V, k, B]: the draft's
    warped probabilities of its k proposals.  rt as in _verify_round.
    Returns n_acc."""
    if rt is None:
        rt = T + rnd * (k + 1)
    B = core.last.shape[0]
    logits = _verify_target(cfg, params, core, props, k, T, sliding_on, rt, plain=plain)
    V = logits.shape[0]
    w = dec._warp_bl(llama.final_softcap(cfg, logits), temperature, top_k, top_p)  # [V, P*B]
    p_w = _softmax_v(w).reshape(V, k + 1, B)
    w = w.reshape(V, k + 1, B)
    ages = core.out_pos[None, :] + torch.arange(k + 1, device=props.device)[:, None]
    keys = _spec_keys(seed, req_ids, budget, ages)  # [k + 1, B]

    p_sel = p_w[:, :k].gather(0, props[None])[0]  # [k, B]
    q_sel = q_w.gather(0, props[None])[0]
    u = dec.uniform_draws(_subkeys(keys[:k], 1).reshape(-1), 1)[0].reshape(k, B)
    accept = (u * q_sel.double() < p_sel.double()).long()
    n_acc = torch.cumprod(accept, dim=0).sum(dim=0)

    res = (p_w[:, :k] - q_w).clamp(min=0.0)  # [V, k, B]
    logres = torch.where(res > 0, torch.log(res), float("-inf")).reshape(V, k * B)
    corr_res = dec._gumbel_pick(logres, _subkeys(keys[:k], 2).reshape(-1)).reshape(k, B)
    corr_bonus = dec._gumbel_pick(w[:, k], keys[k])[None]  # the plain sampler's pick
    corr = torch.cat([corr_res, corr_bonus])
    n_acc = _advance(core, props, corr, k, budget, eos, n_acc=n_acc)
    _retract_rows(core.valid, rt, k, n_acc)
    return n_acc


def _check_sampling(cfg, draft_cfg, k: int) -> None:
    if k < 1:
        raise ValueError("speculative sampling needs k >= 1")
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError("speculative sampling compares p/q over one vocab: draft "
                         f"vocab {draft_cfg.vocab_size} != target {cfg.vocab_size}")


@torch.no_grad()
def speculative_sample_bl(
    cfg: LlamaConfig,
    params: dict,
    draft_cfg: LlamaConfig,
    draft_params: dict,
    inputs_embeds: torch.Tensor,
    draft_inputs_embeds: torch.Tensor,
    max_new_tokens: int,
    pad_token_id: int,
    seed: int = 0,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    req_ids: Optional[torch.Tensor] = None,
    k: int = 4,
    prefill_params: Optional[dict] = None,
    draft_prefill_params: Optional[dict] = None,
    share_prefill: bool = False,
    plain: bool = False,
) -> Tuple[torch.Tensor, int]:
    """Stochastic speculative decode: the tokens are distributed exactly as
    dec.sample_generate_bl's (the warped target's marginal, for any draft),
    and are bit-identical to it when draft == target.  EOS, pad, budget,
    req_ids (default: the rows) and seed as the plain sampler;
    share_prefill as in speculative_generate_bl.  Returns (tokens [B,
    max_new_tokens] int64, verify rounds)."""
    _check_sampling(cfg, draft_cfg, k)
    B = inputs_embeds.shape[0]
    dev = inputs_embeds.device
    req_ids = torch.arange(B, device=dev) if req_ids is None else torch.as_tensor(
        req_ids, dtype=torch.long, device=dev)
    if max_new_tokens == 0:
        return torch.zeros((B, 0), dtype=torch.long, device=dev), 0
    budget = max_new_tokens

    def pick0(logits0):
        return dec._sample_pick_bl(logits0.t(), dec._req_keys(seed, req_ids, budget, 0),
                                   temperature, top_k, top_p)

    core, eos, T, max_rounds = _spec_setup(cfg, params, prefill_params, inputs_embeds, budget,
                                           pad_token_id, k, pick0=pick0, plain=plain)
    if max_rounds == 0:
        return core.tokens, 0
    sliding_on = llama.sliding_effective(cfg, T + budget)
    kv_d, valid_d, rp_d, Td = _draft_setup(
        draft_cfg, draft_params, draft_prefill_params, draft_inputs_embeds, k, max_rounds,
        from_target=core.caches if share_prefill else None, plain=plain)
    d_sliding = llama.sliding_effective(draft_cfg, Td + budget)
    rnd = 0
    while rnd < max_rounds and not bool(core.done.all()):
        rd = Td + rnd * (k + 1)
        props, q_w = _draft_steps_sample(
            draft_cfg, draft_params, core.last, core.done, core.out_pos, kv_d, valid_d, rp_d,
            rd, Td, k, d_sliding, seed, req_ids, budget, temperature, top_k, top_p, plain)
        n_acc = _verify_round_sample(cfg, params, core, props, q_w, rnd, k, T, budget, eos,
                                     sliding_on, seed, req_ids, temperature, top_k, top_p,
                                     plain=plain)
        _retract_rows(valid_d, rd, k, n_acc)
        rnd += 1
    return core.tokens, rnd


# ---------------------------------------------------------------------------
# Speculative continuous batching: the slot engine (streaming.py's
# admission design) running draft-verify rounds instead of single-token
# steps.  Cache rows ride a ring of budget - 1 round slots of width k + 1
# (ring row rnd mod (budget - 1)): a tenant lives at most budget - 1 rounds
# (each round emits at least one token), so by the time the ring wraps onto
# a row, the tenant that stamped it is done, and the wrap's stamp rewrites
# the row's valid bits for every lane.  Greedy rejection keeps the engine
# token-identical to the batch captioner for any draft; sampled draws are
# keyed by (request, age), so it equals the batch speculative sampler row
# for row.
# ---------------------------------------------------------------------------


@dataclass
class _SpecPool:
    """The speculative slot pool, fixed shapes, updated in place."""

    core: _SpecCore         # the target's pool (done doubles as slot-free)
    caches_d: tuple         # the draft's K, V [Ld, pool, nkvd, S, hdd]
    valid_d: torch.Tensor   # [pool, S]
    rp_d: torch.Tensor      # [pool, S]
    slot_req: torch.Tensor  # [pool] int64: the workload row each slot flushes to
    rnd: int = 0            # engine rounds so far (the ring row's source)


def _check_engine(cfg, draft_cfg, budget: int, k: int, sample) -> None:
    if k < 1:
        raise ValueError("speculative engine needs k >= 1")
    if budget < 2:
        raise ValueError("speculative engine needs budget >= 2")
    _refuse_mla(cfg, draft_cfg)
    if sample is not None:
        _check_sampling(cfg, draft_cfg, k)


def _spec_pool_state(cfg, draft_cfg, pool: int, T: int, budget: int, k: int,
                     pad_token_id: int, device) -> _SpecPool:
    """A fresh pool of free slots over S = T + (k + 1) * (budget - 1) rows."""
    S = T + (k + 1) * (budget - 1)
    _, row_pos = _fresh_rows(pool, T, S, device)
    valid = torch.zeros((pool, S), dtype=torch.bool, device=device)
    core = _SpecCore(
        done=torch.ones(pool, dtype=torch.bool, device=device),
        last=torch.zeros(pool, dtype=torch.long, device=device),
        out_pos=torch.zeros(pool, dtype=torch.long, device=device),
        tokens=torch.full((pool, budget), pad_token_id, dtype=torch.long, device=device),
        caches=dec.init_cache(cfg, pool, S, device), valid=valid, row_pos=row_pos)
    return _SpecPool(core=core, caches_d=dec.init_cache(draft_cfg, pool, S, device),
                     valid_d=valid.clone(), rp_d=row_pos.clone(),
                     slot_req=torch.full((pool,), -1, dtype=torch.long, device=device))


def _admit_install(cfg, draft_cfg, params, draft_params, pspec, pparams, state: _SpecPool,
                   embs, prefix_ids, slots: np.ndarray, fresh: np.ndarray, rows: np.ndarray,
                   T: int, budget: int, pad_token_id: int, eos, sample=None, seed: int = 0,
                   req_base: int = 0,
                   prefill_params=None, draft_prefill_params=None, share_prefill: bool = False,
                   plain: bool = False) -> None:
    """Prefill one chunk of M prompts (target and draft; the projector's mlp2
    kernel first) and install its fresh rows into `slots`, in place: the
    chunk's caches into the slots' prompt rows of both pools, token 0
    (sampled with the age-0 key of request req_base + row), the slots'
    validity reset to the prompt rows.  Rows not fresh (padding) install
    nothing.  embs [M, mm_dim] and prefix_ids [M, T - 1] on the device;
    slots, fresh and rows (workload rows) [M] on the host.  share_prefill:
    the self-draft's chunk caches are the target's (installed as a copy)."""
    pp = params if prefill_params is None else prefill_params
    dpp = draft_params if draft_prefill_params is None else draft_prefill_params
    core = state.core
    dev = core.last.device
    soft = proj.apply(pspec, pparams, embs, plain=plain)
    inputs = mmmodel.assemble_prompt(cfg, pp, soft, prefix_ids)
    caches, logits0 = dec._prefill_caches(cfg, pp, inputs, T, plain)
    if share_prefill:
        if tuple(state.caches_d[0].shape[:3]) != tuple(core.caches[0].shape[:3]) or (
                state.caches_d[0].shape[4] != core.caches[0].shape[4]):
            raise ValueError("share_prefill needs the draft's cache layout to equal the "
                             f"target's; got draft {tuple(state.caches_d[0].shape)} vs "
                             f"target {tuple(core.caches[0].shape)}")
        caches_d = caches
    else:
        caches_d, _ = dec._prefill_caches(draft_cfg, dpp, inputs, T, plain)
    take = torch.as_tensor(np.nonzero(fresh)[0], device=dev)
    sl = torch.as_tensor(np.asarray(slots)[fresh], dtype=torch.long, device=dev)
    req = torch.as_tensor(np.asarray(rows)[fresh], dtype=torch.long, device=dev)
    logits0 = logits0[take]
    if sample is None:
        tok0 = logits0.argmax(dim=-1)
    else:  # token 0 (age 0) with the batch sampler's own keys
        tok0 = dec._sample_pick_bl(logits0.t(), dec._req_keys(seed, req_base + req, budget, 0),
                                   *sample)
    for pool_c, chunk_c in zip(core.caches + state.caches_d, caches + caches_d):
        pool_c[:, sl, :, :T] = chunk_c[:, take]
    core.done[sl] = torch.isin(tok0, eos)
    core.last[sl] = tok0
    core.out_pos[sl] = 1
    core.tokens[sl] = pad_token_id
    core.tokens[sl, 0] = tok0
    for valid in (core.valid, state.valid_d):
        valid[sl] = False
        valid[sl, :T] = True
    # row_pos untouched: prompt rows hold the same positions for every
    # tenant; generated rows are stamped when written
    state.slot_req[sl] = req


def _spec_round_step(cfg, params, draft_cfg, draft_params, state: _SpecPool, T: int,
                     budget: int, k: int, eos, sliding_on: bool, d_sliding: bool, sample,
                     seed: int, req_base: int, head_w, d_head_w, plain: bool) -> None:
    """One engine round (k + 1 draft steps and one verify) for the whole pool
    at the ring row of state.rnd, in place; dead slots do masked work."""
    rt = T + (state.rnd % (budget - 1)) * (k + 1)
    core = state.core
    if sample is None:
        props = _draft_steps_greedy(draft_cfg, draft_params, core.last, core.done,
                                    core.out_pos, state.caches_d, state.valid_d, state.rp_d,
                                    rt, T, k, d_sliding, d_head_w, plain)
        n_acc = _verify_round(cfg, params, core, props, state.rnd, k, T, budget, eos,
                              sliding_on, rt=rt, head_w=head_w, plain=plain)
    else:
        req_ids = req_base + state.slot_req
        props, q_w = _draft_steps_sample(
            draft_cfg, draft_params, core.last, core.done, core.out_pos, state.caches_d,
            state.valid_d, state.rp_d, rt, T, k, d_sliding, seed, req_ids, budget, *sample,
            plain=plain)
        n_acc = _verify_round_sample(cfg, params, core, props, q_w, state.rnd, k, T, budget,
                                     eos, sliding_on, seed, req_ids, *sample, rt=rt,
                                     plain=plain)
    _retract_rows(state.valid_d, rt, k, n_acc)
    state.rnd += 1


@torch.no_grad()
def speculative_bulk_caption(
    cfg: LlamaConfig,
    params: dict,
    draft_cfg: LlamaConfig,
    draft_params: dict,
    pspec,
    pparams,
    queue: torch.Tensor,
    prefix_ids: torch.Tensor,
    T: int,
    budget: int,
    pad_token_id: int,
    chunk: int,
    pool: int,
    k: int = 4,
    prefill_params: Optional[dict] = None,
    draft_prefill_params: Optional[dict] = None,
    mesh=None,
    sample=None,
    seed: int = 0,
    req_base: int = 0,
    share_prefill: bool = False,
    plain: bool = False,
) -> Tuple[torch.Tensor, int, int]:
    """Speculative continuous batching over a whole known workload.

    queue [N, mm_dim] on the device (l2-normalised); prefix_ids [chunk,
    T - 1].  Each round: when at least `chunk` slots are free and requests
    remain, flush the outgoing tenants, prefill the next chunk (its rows
    past N are padding and install nothing) into both pools; then run one
    draft-verify round for every slot.  dmi_tpu runs this as one on-device
    while_loop; here it is a host loop that reads the free count once a
    round.  Greedy by default, token-identical to the batch captioner for
    any draft; sample=(temperature, top_k, top_p) draws every round with
    the keys of request req_base + queue row, bit-identical to
    speculative_sample_bl on the same request ids whatever the slot,
    admission order or pool size.  The draft consumes the target's
    assembled prompt (the self-draft shares its embedding space).
    Returns (tokens [N, budget] int64, rounds, admissions).

    mesh: the (data, model) DeviceMesh the four trees were sharded over
    (parallel.shard_llm_params): each data rank serves its contiguous
    share of the queue in pool / d slots (chunk at most that), and the
    tokens of every rank are gathered in queue order; rounds and
    admissions are this rank's."""
    _check_engine(cfg, draft_cfg, budget, k, sample)
    shard = engine_shard(mesh, params, draft_params, prefill_params, draft_prefill_params)
    if shard is not None:
        lo, hi = shard.rows(queue.shape[0])
        queue, req_base = queue[lo:hi], req_base + lo
        pool = max(2, pool // shard.n_data)
        chunk = min(chunk, pool)
    if not 1 <= chunk <= pool:
        # chunk > pool would leave the admission condition (free >= chunk)
        # false for ever
        raise ValueError(f"chunk must be in [1, pool], got {chunk}")
    cfg, draft_cfg = llama.local_config(cfg, params), llama.local_config(draft_cfg, draft_params)
    N = queue.shape[0]
    dev = queue.device
    eos = torch.tensor(cfg.eos_token_ids, dtype=torch.long, device=dev)
    sliding_on = llama.sliding_effective(cfg, T + budget)
    d_sliding = llama.sliding_effective(draft_cfg, T + budget)
    head_w = dec.fused_head_weights(cfg, params) if sample is None else None
    d_head_w = dec.fused_head_weights(draft_cfg, draft_params) if sample is None else None
    state = _spec_pool_state(cfg, draft_cfg, pool, T, budget, k, pad_token_id, dev)
    state.slot_req[:] = N  # row N: the trash row of slots never used
    out = torch.full((N + 1, budget), pad_token_id, dtype=torch.long, device=dev)
    pad_rows = torch.zeros((chunk, queue.shape[1]), dtype=queue.dtype, device=dev)
    qptr = admissions = 0
    while True:
        free = int(state.core.done.sum())
        if free == pool and qptr >= N:
            break
        if free >= chunk and qptr < N:
            core = state.core
            slots = torch.argsort((~core.done).to(torch.int8), stable=True)[:chunk]  # free first
            out[state.slot_req[slots]] = core.tokens[slots]  # flush the outgoing tenants
            take = min(chunk, N - qptr)
            fresh = np.arange(chunk) < take
            state.slot_req[slots] = N
            _admit_install(cfg, draft_cfg, params, draft_params, pspec, pparams, state,
                           torch.cat([queue[qptr:qptr + take], pad_rows[take:]]), prefix_ids,
                           slots.cpu().numpy(), fresh, qptr + np.arange(chunk), T, budget,
                           pad_token_id, eos, sample, seed, req_base, prefill_params,
                           draft_prefill_params, share_prefill, plain)
            qptr += take
            admissions += 1
        _spec_round_step(cfg, params, draft_cfg, draft_params, state, T, budget, k, eos,
                         sliding_on, d_sliding, sample, seed, req_base, head_w, d_head_w, plain)
    out[state.slot_req] = state.core.tokens  # the remaining tenants
    return (out[:N] if shard is None else shard.gather_rows(out[:N])), state.rnd, admissions


def spec_admit_chunk(cfg, params, draft_cfg, draft_params, pspec, pparams, state: _SpecPool,
                     embs: np.ndarray, prefix_ids, slots: np.ndarray, fresh: np.ndarray,
                     rows: np.ndarray, T: int, budget: int, pad_token_id: int,
                     prefill_params=None, draft_prefill_params=None, sample=None,
                     seed: int = 0, req_base: int = 0, share_prefill: bool = False,
                     plain: bool = False) -> _SpecPool:
    """Host-loop admission (SpeculativeStreamingCaptioner.run): prefill and
    install one fixed-size chunk; embs [M, mm_dim] on the host, rows not
    fresh point at the reserved scratch slot and install nothing."""
    dev = state.core.last.device
    eos = torch.tensor(cfg.eos_token_ids, dtype=torch.long, device=dev)
    _admit_install(cfg, draft_cfg, params, draft_params, pspec, pparams, state,
                   torch.as_tensor(embs, dtype=torch.float32, device=dev), prefix_ids, slots,
                   fresh, rows, T, budget, pad_token_id, eos, sample, seed, req_base,
                   prefill_params, draft_prefill_params, share_prefill, plain)
    return state


def spec_rounds(cfg, params, draft_cfg, draft_params, state: _SpecPool, T: int, budget: int,
                k: int, n_rounds: int, sample=None, seed: int = 0, req_base: int = 0,
                plain: bool = False) -> _SpecPool:
    """n_rounds draft-verify rounds for the whole pool (one dispatch in
    dmi_tpu)."""
    eos = torch.tensor(cfg.eos_token_ids, dtype=torch.long, device=state.core.last.device)
    sliding_on = llama.sliding_effective(cfg, T + budget)
    d_sliding = llama.sliding_effective(draft_cfg, T + budget)
    head_w = dec.fused_head_weights(cfg, params) if sample is None else None
    d_head_w = dec.fused_head_weights(draft_cfg, draft_params) if sample is None else None
    for _ in range(n_rounds):
        _spec_round_step(cfg, params, draft_cfg, draft_params, state, T, budget, k, eos,
                         sliding_on, d_sliding, sample, seed, req_base, head_w, d_head_w, plain)
    return state


class SpeculativeStreamingCaptioner:
    """Online speculative continuous batching over a fixed slot pool: the
    host loop admits arrivals in fixed-size chunks, runs `rounds`
    draft-verify rounds at a time and harvests finished slots.  Greedy
    tokens equal the batch captioner's for any draft; sampled draws are
    keyed by (request, age), equal to the batch speculative sampler row for
    row.  For a workload known up front speculative_bulk_caption has no
    harvest round trips.  `dispatches` counts admissions and round runs;
    plain=True runs every kernel's twin.  mesh: the (data, model) DeviceMesh
    the four trees were sharded over (as speculative_bulk_caption)."""

    def __init__(self, cfg: LlamaConfig, llm_params: dict, draft_cfg: LlamaConfig,
                 draft_params: dict, pspec, pparams, prefix_ids, budget: int, pad_token_id: int,
                 pool: int = 64, admit: int = 16, rounds: int = 2, k: int = 4,
                 prefill_params: Optional[dict] = None,
                 draft_prefill_params: Optional[dict] = None, mesh=None,
                 temperature: Optional[float] = None, top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0, req_base: int = 0, share_prefill: bool = False,
                 plain: bool = False):
        self.sample = ((float(temperature), int(top_k), float(top_p))
                       if temperature is not None else None)
        _check_engine(cfg, draft_cfg, budget, k, self.sample)
        self.shard = engine_shard(mesh, llm_params, draft_params, prefill_params,
                                  draft_prefill_params)
        if self.shard is not None:
            pool = max(2, pool // self.shard.n_data)
            admit = min(admit, pool - 1)
            cfg = llama.local_config(cfg, llm_params)
            draft_cfg = llama.local_config(draft_cfg, draft_params)
        if pool < 2:
            raise ValueError("pool must be >= 2 (one slot is scratch)")
        if not 1 <= admit <= pool - 1:
            # the LAST slot is the scratch target of a padded chunk's rows
            raise ValueError(f"admit must be in [1, pool-1], got {admit}")
        self.cfg, self.params = cfg, llm_params
        self.draft_cfg, self.draft_params = draft_cfg, draft_params
        self.pspec, self.pparams = pspec, pparams
        self.device = llm_params["final_norm"].device
        self.prefix = torch.as_tensor(prefix_ids, dtype=torch.long, device=self.device)
        self.T = 1 + int(self.prefix.shape[0])
        self.budget, self.pad = int(budget), int(pad_token_id)
        self.pool, self.admit, self.rounds, self.k = int(pool), int(admit), int(rounds), int(k)
        self.prefill_params = prefill_params
        self.draft_prefill_params = draft_prefill_params
        self.seed, self.req_base = int(seed), int(req_base)
        self.share_prefill = bool(share_prefill)
        self.plain = plain
        self.scratch = self.pool - 1
        self.state = None
        self._occupied = np.zeros(self.pool, bool)
        self._slot_req = np.full(self.pool, -1, np.int64)
        self.dispatches = 0

    def run(self, embeddings: np.ndarray) -> torch.Tensor:
        """Caption every row (embeddings [N, mm_dim], already normalised);
        returns LongTensor [N, budget] on the CPU (on a mesh: this data
        rank's share served, every rank's rows returned)."""
        lo, hi = (0, embeddings.shape[0]) if self.shard is None else self.shard.rows(
            embeddings.shape[0])
        embeddings = embeddings[lo:hi]
        req_base = self.req_base + lo
        N = embeddings.shape[0]
        if self.state is None:
            self.state = _spec_pool_state(self.cfg, self.draft_cfg, self.pool, self.T,
                                          self.budget, self.k, self.pad, self.device)
        out = np.full((N, self.budget), self.pad, np.int64)
        next_req = 0
        prefix_chunk = self.prefix[None, :].expand(self.admit, -1)

        def fetch_and_harvest():
            core = self.state.core
            packed = torch.cat([core.done.long(), core.out_pos]).cpu().numpy()  # one transfer
            done = packed[: self.pool].astype(bool)
            n = packed[self.pool:]
            finished = self._occupied & done & (n > 0)
            finished[self.scratch] = False
            if finished.any():
                toks = core.tokens.cpu().numpy()
                for b in np.nonzero(finished)[0]:
                    out[self._slot_req[b]] = toks[b]
                    self._occupied[b] = False
                    self._slot_req[b] = -1

        while next_req < N or self._occupied[: self.scratch].any():
            while next_req < N:
                free = np.nonzero(~self._occupied[: self.scratch])[0][: self.admit]
                take = min(len(free), N - next_req)
                if take == 0:
                    break
                slots = np.full(self.admit, self.scratch, np.int64)
                slots[:take] = free[:take]
                fresh = np.arange(self.admit) < take
                chunk = np.zeros((self.admit, embeddings.shape[1]), np.float32)
                chunk[:take] = embeddings[next_req: next_req + take]
                self.state = spec_admit_chunk(
                    self.cfg, self.params, self.draft_cfg, self.draft_params, self.pspec,
                    self.pparams, self.state, chunk, prefix_chunk, slots, fresh,
                    next_req + np.arange(self.admit), self.T, self.budget, self.pad,
                    self.prefill_params, self.draft_prefill_params, self.sample, self.seed,
                    req_base, self.share_prefill, self.plain)
                self.dispatches += 1
                self._occupied[free[:take]] = True
                self._slot_req[free[:take]] = np.arange(next_req, next_req + take)
                next_req += take
            if self._occupied[: self.scratch].any():
                self.state = spec_rounds(self.cfg, self.params, self.draft_cfg,
                                         self.draft_params, self.state, self.T, self.budget,
                                         self.k, self.rounds, self.sample, self.seed,
                                         req_base, self.plain)
                self.dispatches += 1
            fetch_and_harvest()
        if self.shard is None:
            return torch.as_tensor(out)
        return self.shard.gather_rows(torch.as_tensor(out).to(self.device)).cpu()
