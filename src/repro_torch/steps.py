"""Step functions: the programs the Syscore hot-loads (port of
``repro/steps.py``).  The serving programs take dense and paged caches;
every decoder-only family shares them, and the encoder-decoder family
takes the encdec branches of :func:`make_prefill_step` and
:func:`make_serve_step`, bound by :func:`encdec_program_specs`.  The
training step (:func:`make_train_step`, :func:`train_program_spec`) runs
the dense decoder-only family: its gradients come from K1's backward
kernel and K2's products.

Each program works on the live cache tree in place and returns it, so the
engine's call sites read as the reference's: ``caches, out = prog(...)``.
Nothing in them waits for the host, so on the card the Syscore captures
each as a CUDA graph.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core.program_store import ProgramSpec, leaves, unflatten
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import softmax_xent, torch_dtype
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update_


def _index(value, device) -> torch.Tensor:
    """A slot or a length as a (1,) int32 tensor on ``device`` (a tensor
    already there, as in a capture, is not copied)."""
    return torch.as_tensor(value, dtype=torch.int32,
                           device=device).reshape(1)


def warm_prefix_capable(cfg) -> bool:
    """The reference's tier-1 rule (``repro/launch/serve.py:310-322``):
    only attention-only, non-MoE configs admit a prefix hit by computing
    the suffix alone (``prefill_offset``).  A recurrent layer must replay
    the whole prompt to rebuild its state, and MoE routing runs over the
    whole prompt's tokens; both take tier 2, a full ``prefill_slot`` over
    the shared blocks mapped read-only."""
    unit, _, tail = transformer.split_layers(cfg)
    return all(k in transformer.ATTN_KINDS for k in unit + tail) and \
        cfg.n_experts == 0


def make_prefill_step(cfg):
    """prefill(params, caches, tokens (B, S_tok), lengths (B,)[,
    prefix_embeds (B, P, d)]) -> (caches, last (B, V)).

    Burst admission: one whole-batch prefill into the live dense tree,
    every row rewritten; row b is right-padded to S, its ``pos`` set to
    ``lengths[b]`` and its ``last`` taken at position ``lengths[b] - 1``
    (``repro/steps.py:make_prefill_step``).  ``lengths`` is an int32
    device tensor, read by index, never on the host.  A frontend's
    ``prefix_embeds`` (the reference's ``batch["prefix_embeds"]``) run
    before the tokens: S = P + S_tok, and ``lengths`` counts the prefix.
    The engine's burst path passes none.

    An encoder-decoder config gets the reference's encdec branch instead:
    prefill(params, caches, frames (B, S_enc, d), tokens (B, S_dec)) ->
    (caches, last (B, V)), every row S_dec long and ``last`` its final
    position's logits (:func:`repro_torch.models.encdec.forward`)."""
    if cfg.is_encdec:
        def prefill_encdec(params, caches, frames, tokens):
            logits, caches = encdec.forward(cfg, params, frames, tokens,
                                            mode="prefill", caches=caches)
            return caches, logits[:, -1]

        return prefill_encdec

    def prefill(params, caches, tokens, lengths, prefix_embeds=None):
        lengths = lengths.to(device=tokens.device, dtype=torch.int32)
        logits, caches = transformer.forward(cfg, params, tokens,
                                             prefix_embeds=prefix_embeds,
                                             mode="prefill", caches=caches,
                                             lengths=lengths)
        idx = (lengths - 1).long()[:, None, None].expand(
            -1, 1, logits.shape[-1])
        return caches, logits.gather(1, idx)[:, 0]

    return prefill


def make_prefill_slot_step(cfg, cache_len: int, ring: bool = True):
    """prefill_slot(params, caches, tokens (1,S), slot, length) ->
    (caches, last).

    Admission of ONE request into a live batch: prefill a fresh batch-1
    cache and copy its rows, and its ``pos``, into slot ``slot`` of the live
    tree.  Nothing outside row ``slot`` is touched, so the other slots keep
    decoding between executions.  ``last`` is the (V,) logits at the final
    valid prompt position.  ``slot`` and ``length`` are int32 scalars on
    the device, as in the reference (``.at[slot].set``, ``jnp.take``), or
    Python ints; the rows are written and read through device indices, so
    the program never reads them on the host.  ``ring=False`` matches the
    full-length windowed buffers of the speculative engine."""
    def prefill_slot(params, caches, tokens, slot, length):
        slot = _index(slot, tokens.device).long()
        length = _index(length, tokens.device)
        fresh = transformer.init_cache(cfg, 1, cache_len, ring=ring,
                                       device=tokens.device)
        logits, c1 = transformer.forward(
            cfg, params, tokens, mode="prefill", caches=fresh,
            lengths=length)
        caches["pos"].index_copy_(0, slot, c1["pos"])
        # group-stacked leaves carry a leading (layers,) axis: batch is axis
        # 1; tail leaves index batch at axis 0
        for name, group in caches["groups"].items():
            for leaf, buf in group.items():
                buf.index_copy_(1, slot, c1["groups"][name][leaf])
        for name, layer in caches["tail"].items():
            for leaf, buf in layer.items():
                buf.index_copy_(0, slot, c1["tail"][name][leaf])
        last = logits[0].index_select(0, (length - 1).long())[0]
        return caches, last

    return prefill_slot


def make_paged_prefill_slot_step(cfg, cache_len: int, kv_block: int):
    """Paged-arena admission program (repro_torch.core.paging).

    Same contract as :func:`make_prefill_slot_step`, but the live cache
    tree carries a physical-block KV arena and a per-slot block table
    instead of dense per-slot buffers: the fresh batch-1 prefill cache is
    computed exactly as in the dense path (so admission stays token-exact;
    windowed layers prefill a full-length buffer, so logical block j holds
    positions [j*bs, (j+1)*bs) for every kind), then its attention rows are
    copied, block by block, into the arena blocks the host-side pager
    mapped for this slot, while recurrent state rows go into the slot as
    before.  Unmapped table entries (-1, beyond the request's reservation)
    and read-only shared mappings (``-(p + 2)``) send their block to the
    arena's sink (``attention.write_paged_kv``), the port's form of the
    reference's out-of-range index under ``mode="drop"``."""
    n_blocks = cache_len // kv_block

    def to_arena(arena, full, dest, axis):
        blocks = full.reshape(*full.shape[:axis], n_blocks, kv_block,
                              *full.shape[axis + 1:])
        arena.index_copy_(axis, dest, blocks.to(arena.dtype))

    def prefill_slot(params, caches, tokens, slot, length):
        slot = _index(slot, tokens.device).long()
        length = _index(length, tokens.device)
        fresh = transformer.init_cache(cfg, 1, cache_len, ring=False,
                                       device=tokens.device)
        logits, c1 = transformer.forward(
            cfg, params, tokens, mode="prefill", caches=fresh,
            lengths=length)
        row = caches["block_table"].index_select(0, slot)[0]   # (n_blocks,)
        caches["pos"].index_copy_(0, slot, c1["pos"])
        # group-stacked leaves carry a leading (layers,) axis: the arena
        # and batch axes are 1 there; tail leaves use axis 0
        for top, axis in (("groups", 1), ("tail", 0)):
            for name, layer in caches[top].items():
                for leaf, buf in layer.items():
                    full = c1[top][name][leaf]
                    if leaf in ("k", "v"):
                        sink = buf.shape[axis] - 1
                        dest = torch.where(row >= 0, row,
                                           torch.full_like(row, sink))
                        to_arena(buf, full.select(axis, 0), dest.long(),
                                 axis)
                    else:
                        buf.index_copy_(axis, slot, full)
        last = logits[0].index_select(0, (length - 1).long())[0]
        return caches, last

    return prefill_slot


def make_paged_prefill_offset_step(cfg, max_suffix: int):
    """prefill_offset(params, caches, tokens (1, max_suffix), slot, offset,
    length) -> (caches, last (V,)).

    Warm prefix admission (``repro/steps.py:279``): the slot's first
    ``offset`` prompt tokens are already in shared arena blocks mapped
    read-only into its block-table row, so only the suffix
    ``tokens[0, :length - offset]`` runs
    (:func:`~repro_torch.models.transformer.prefill_offset`).  The pager
    keeps ``offset`` block-aligned and below ``length``, so at least one
    token runs and every suffix write lands in the slot's private blocks.
    The reference runs the suffix as a scan of ``decode_step``; here it is
    one batch-1 prefill at the offset, through K1 over the slot's gathered
    row, so its rows have a cold prefill's bits on the card (decode
    attention rounds differently from K1 in bf16).  ``last`` is row
    ``length - offset - 1`` of the suffix's logits, taken by index; slot,
    offset and length are int32 device scalars or Python ints."""
    assert max_suffix >= 1

    def prefill_offset(params, caches, tokens, slot, offset, length):
        slot = _index(slot, tokens.device)
        offset = _index(offset, tokens.device)
        length = _index(length, tokens.device)
        logits, caches = transformer.prefill_offset(
            cfg, params, caches, tokens, slot, offset, length)
        last = logits[0].index_select(0, (length - offset - 1).long())[0]
        return caches, last

    return prefill_offset


def make_serve_step(cfg):
    """decode(params, caches, token (B,1)) -> (caches, next (B,1), logits).

    One greedy decode step; each row reads its position from the per-slot
    ``pos`` in the cache tree and the tree comes back with it advanced.
    An encoder-decoder config keeps the reference's explicit position:
    decode(params, caches, token (B, 1), pos ()) -> (caches, next (B, 1),
    logits), every row at ``pos``."""
    def serve_step_encdec(params, caches, token, pos):
        logits, caches = encdec.decode_step(cfg, params, caches, token, pos)
        return caches, transformer.greedy_token(cfg, logits), logits

    def serve_step(params, caches, token):
        logits, caches = transformer.decode_step(cfg, params, caches, token)
        return caches, transformer.greedy_token(cfg, logits), logits

    return serve_step_encdec if cfg.is_encdec else serve_step


def make_verify_step(cfg):
    """verify(params, caches, tokens (B, k+1)) -> (caches, ys (B, k+1),
    n_new (B,)).

    One execution scores each row's last accepted token and k drafts,
    accepts the longest greedy-matching prefix and leaves the cache rolled
    back to exactly the accepted state
    (:func:`~repro_torch.models.transformer.verify_decode`)."""
    def verify_step(params, caches, tokens):
        return transformer.verify_decode(cfg, params, caches, tokens)

    return verify_step


def make_decode_horizon_step(cfg, horizon: int, eos_id=None):
    """decode_horizon(params, caches, tokens (B, 1), budget (B,)) ->
    (caches, events).

    ``horizon`` greedy decode steps in one execution, with the greedy
    token fed back on the device and per-slot termination (EOS or an
    exhausted budget) masked there
    (:func:`~repro_torch.models.transformer.decode_horizon`); the host
    reads the event buffer back once per horizon."""
    def decode_horizon_step(params, caches, tokens, budget):
        return transformer.decode_horizon(cfg, params, caches, tokens,
                                          budget, horizon=horizon,
                                          eos_id=eos_id)

    return decode_horizon_step


def encdec_program_specs(cfg, params, caches, dec_prompt_len: int
                         ) -> Dict[str, ProgramSpec]:
    """An encoder-decoder config's two programs, bound to ``params`` and
    ``caches`` (:func:`repro_torch.models.encdec.init_cache`; they run on
    the device those trees are on): ``prefill`` (its per-call inputs: the
    (B, S_enc, d) frames in the model dtype, S_enc the cache's, and the
    (B, ``dec_prompt_len``) tokens) and ``decode`` (the (B, 1) tokens and
    the position, a 0-dim int32 that a call may pass as a number: it is
    copied into the program's own buffer, never baked into a graph).  The
    counterpart of the reference's jitted ``make_prefill_step`` and
    ``make_serve_step`` for the encdec family; the serving engine is
    decoder-only (:func:`serve_program_specs`)."""
    encdec.check_supported(cfg)
    cross = caches["cross_k"]
    b, s_enc, device = cross.shape[1], cross.shape[2], cross.device
    frames = torch.zeros((b, s_enc, cfg.d_model), dtype=cross.dtype,
                         device=device)
    tokens = torch.zeros((b, dec_prompt_len), dtype=torch.int32,
                         device=device)
    token = torch.zeros((b, 1), dtype=torch.int32, device=device)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    context = repr(cfg)
    return {"prefill": ProgramSpec("prefill", make_prefill_step(cfg),
                                   resident=(params, caches),
                                   inputs=(frames, tokens), context=context),
            "decode": ProgramSpec("decode", make_serve_step(cfg),
                                  resident=(params, caches),
                                  inputs=(token, pos), context=context)}


def serve_program_specs(cfg, config, params, caches
                        ) -> Dict[str, ProgramSpec]:
    """The serving programs for an :class:`EngineConfig`, bound to the
    engine's ``params`` and ``caches``: ``prefill_slot`` (one admission
    into a live batch; its per-call inputs are the (1, prefill_len)
    tokens, the slot and the length) and ``decode`` (one greedy token for
    every slot; its input is the (batch, 1) tokens).  A paged config
    admits through :func:`make_paged_prefill_slot_step`; ``decode`` reads
    the block table from the tree.

    With ``config.spec`` a ``verify`` program scores ``spec.k`` drafts per
    slot in one execution (its input: the (batch, k+1) tokens), and a
    dense admission prefills flat windowed buffers (``ring=False``, as the
    engine's caches then are: rollback needs a rejected write at an
    absolute slot past the truncated ``pos``, never inside a live ring
    window).  With ``config.horizon`` a ``decode_horizon`` program runs
    ``horizon.length`` greedy steps in one execution (its inputs: the
    (batch, 1) tokens and the (batch,) budgets), with ``config.eos_id``
    as its in-graph EOS.

    With ``config.group_prefill`` a ``prefill`` program admits a burst
    into the whole dense batch (:func:`make_prefill_step`; its inputs: the
    (batch, prefill_len) tokens and the (batch,) lengths).  With
    ``config.prefix`` and an attention-only, non-MoE config
    (:func:`warm_prefix_capable`) a ``prefill_offset`` program admits a
    prefix hit by its suffix alone (:func:`make_paged_prefill_offset_step`;
    its inputs: the (1, max_suffix) tokens, the slot, the offset and the
    length)."""
    transformer.check_supported(cfg)
    device = caches["pos"].device
    s = config.resolved_prefill_len
    prefill = (make_paged_prefill_slot_step(cfg, config.max_len,
                                            config.paging.kv_block)
               if config.paged else
               make_prefill_slot_step(cfg, config.max_len,
                                      ring=config.spec is None))

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    tokens = torch.zeros((1, s), dtype=torch.int32, device=device)
    token = torch.zeros((config.batch, 1), dtype=torch.int32, device=device)
    # what the closures capture besides scalars, for the fingerprints
    context = "|".join((repr(cfg), config.program_context()))
    specs = {
        "prefill_slot": ProgramSpec(
            "prefill_slot", prefill,
            resident=(params, caches),
            inputs=(tokens, scalar(0), scalar(s)), context=context),
        "decode": ProgramSpec("decode", make_serve_step(cfg),
                              resident=(params, caches), inputs=(token,),
                              context=context),
    }
    if config.group_prefill:
        specs["prefill"] = ProgramSpec(
            "prefill", make_prefill_step(cfg), resident=(params, caches),
            inputs=(torch.zeros((config.batch, s), dtype=torch.int32,
                                device=device),
                    torch.full((config.batch,), s, dtype=torch.int32,
                               device=device)), context=context)
    if config.prefix is not None and warm_prefix_capable(cfg):
        ms = config.resolved_prefix_suffix
        specs["prefill_offset"] = ProgramSpec(
            "prefill_offset", make_paged_prefill_offset_step(cfg, ms),
            resident=(params, caches),
            inputs=(torch.zeros((1, ms), dtype=torch.int32, device=device),
                    scalar(0), scalar(0), scalar(ms)),
            context=context + "|" + config.prefix_context())
    if config.spec is not None:
        drafts = torch.zeros((config.batch, config.spec.k + 1),
                             dtype=torch.int32, device=device)
        specs["verify"] = ProgramSpec("verify", make_verify_step(cfg),
                                      resident=(params, caches),
                                      inputs=(drafts,), context=context)
    if config.horizon is not None:
        budget = torch.zeros((config.batch,), dtype=torch.int32,
                             device=device)
        specs["decode_horizon"] = ProgramSpec(
            "decode_horizon",
            make_decode_horizon_step(cfg, config.horizon.length,
                                     config.eos_id),
            resident=(params, caches), inputs=(token, budget),
            context=context + "|" + config.horizon_context())
    return specs


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def model_module(cfg):
    return encdec if cfg.is_encdec else transformer


def train_unsupported(cfg) -> Optional[str]:
    """Why the port cannot train ``cfg`` yet, or None: the training step
    covers the decoder-only models of "G", "L" and "R" layers, with the
    SwiGLU MLP (the dense family, a frontend's prefix included), a mixture
    of experts (K3's backward kernel, the router's gradient and auxiliary
    loss) or the RG-LRU recurrence (K5's backward kernel, the hybrid
    family); SSM training waits for ROADMAP Queue 1 item 14b.3 (K4's
    backward) and encoder-decoder training for item 14b.4."""
    if cfg.is_encdec:
        return (f"{cfg.name}: training an encoder-decoder model is not "
                f"ported yet (ROADMAP Queue 1 item 14b.4)")
    unit, _, tail = transformer.split_layers(cfg)
    kinds = sorted(set(unit + tail) - set(transformer.ATTN_KINDS) - {"R"})
    if not kinds:
        return None
    return (f"{cfg.name}: training layer kinds {', '.join(kinds)} (K4's "
            f"backward) is not ported yet (ROADMAP Queue 1 item 14b.3)")


def lm_loss(cfg, logits, labels, aux):
    """Mean cross-entropy over the positions whose label is >= 0 (a
    frontend's prefix positions carry -1), plus the MoE auxiliary term
    (``repro/steps.py:_lm_loss``)."""
    losses = softmax_xent(logits, torch.clamp(labels, min=0),
                          cfg.vocab_size)
    mask = (labels >= 0).float()
    loss = torch.sum(losses * mask) / torch.clamp(torch.sum(mask), min=1.0)
    if cfg.n_experts:
        loss = loss + cfg.router_aux_coef * aux / max(cfg.n_layers, 1)
    return loss


def make_train_step(cfg, opt_cfg: AdamWConfig, accum: int = 1,
                    grad_constraint: bool = False,
                    grad_of_scan: bool = False):
    """train_step(state, batch) -> (state, metrics), the reference's
    ``make_train_step`` with the state updated in place.

    state = {"params": ..., "opt": {"m", "v", "step"}}; batch =
    {"tokens" (B, S_tok), "labels" (B, S)[, "prefix_embeds" (B, P, d)]}.
    The gradients are ``torch.autograd.grad`` of the loss over the
    parameter leaves (K2's gradient products and K1's and K3's backward
    kernels on the card); AdamW then writes the parameters, moments and step in
    place (:func:`repro_torch.optim.adamw_update_`).  metrics = {"loss",
    "grad_norm", "lr"}, 0-dim device tensors.  Nothing waits for the host,
    so on the card the Syscore captures the step as one CUDA graph.

    ``accum`` > 1 splits the batch into microbatches and sums their
    gradients in fp32 (then divides by ``accum``).  With ``grad_of_scan``
    the parameters are upcast to fp32 once and the loss of every
    microbatch, each under a checkpoint that keeps nothing, is summed
    before one backward: the gradients come out fp32, as the reference's
    cotangent accumulated through its scan.  ``grad_constraint`` pins
    gradients to the parameters' sharding, which needs tensor parallelism
    (ROADMAP Queue 1 item 13)."""
    if grad_constraint:
        raise NotImplementedError(
            "grad_constraint pins gradients to a sharding: tensor "
            "parallelism is not ported yet (ROADMAP Queue 1 item 13)")
    why = train_unsupported(cfg)
    if why is not None:
        raise NotImplementedError(why)

    def loss_fn(params, batch):
        if cfg.is_encdec:
            logits, _, aux = encdec.forward(cfg, params, batch["frames"],
                                            batch["tokens"], mode="train")
        else:
            logits, _, aux = transformer.forward(
                cfg, params, batch["tokens"],
                prefix_embeds=batch.get("prefix_embeds"), mode="train")
        return lm_loss(cfg, logits, batch["labels"], aux)

    def grads_of(params, flat, batch):
        req = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            loss = loss_fn(unflatten(params, req), batch)
            grads = torch.autograd.grad(loss, req)
        return loss.detach(), list(grads)

    def split(batch):
        out = []
        for i in range(accum):
            mb = {}
            for k, x in batch.items():
                b = x.shape[0]
                if b % accum:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{accum} microbatches")
                n = b // accum
                mb[k] = x[i * n:(i + 1) * n]
            out.append(mb)
        return out

    def grads_grad_of_scan(params, flat, batch):
        p32 = [p.detach().float().requires_grad_() for p in flat]

        def body(mb, *p32s):
            return loss_fn(unflatten(params, [
                q.to(p.dtype) for q, p in zip(p32s, flat)]), mb)

        with torch.enable_grad():
            total = None
            for mb in split(batch):
                li = ckpt.checkpoint(body, mb, *p32, use_reentrant=False,
                                     preserve_rng_state=False)
                total = li if total is None else total + li
            loss = total / accum
            grads = torch.autograd.grad(loss, p32)
        return loss.detach(), list(grads)

    def train_step(state, batch):
        params = state["params"]
        flat = list(leaves(params))
        if accum <= 1:
            loss, grads = grads_of(params, flat, batch)
        elif grad_of_scan:
            loss, grads = grads_grad_of_scan(params, flat, batch)
        else:
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in flat]
            lsum = None
            for mb in split(batch):
                li, gi = grads_of(params, flat, mb)
                gsum = [a + b.float() for a, b in zip(gsum, gi)]
                lsum = li if lsum is None else lsum + li
            grads = [g / accum for g in gsum]
            loss = lsum / accum
        metrics = adamw_update_(opt_cfg, grads, state["opt"], params)
        metrics["loss"] = loss
        return state, metrics

    return train_step


def batch_keys(cfg) -> tuple:
    """The order in which the train program takes the batch's tensors."""
    if cfg.is_encdec:
        return ("frames", "tokens", "labels")
    return ("tokens", "labels") + (("prefix_embeds",)
                                   if cfg.frontend_tokens else ())


def batch_templates(cfg, global_batch: int, seq_len: int,
                    device) -> Dict[str, torch.Tensor]:
    """Zero tensors of a train batch's shapes and dtypes (the program's
    input templates; labels 0, a valid label)."""
    from repro_torch.data.pipeline import DataConfig, make_batch_specs
    specs = make_batch_specs(cfg, DataConfig(global_batch, seq_len))
    dtype = torch_dtype(cfg.dtype)
    return {k: torch.zeros(leaf.shape, dtype=leaf.dtype or dtype,
                           device=device) for k, leaf in specs.items()}


def make_train_program(cfg, opt_cfg: AdamWConfig, accum: int = 1,
                       step_fn=None):
    """train(state, *batch) -> (state, metrics): the train step over the
    batch's tensors in :func:`batch_keys` order, the form a program
    takes its per-call inputs in."""
    step = step_fn if step_fn is not None else make_train_step(
        cfg, opt_cfg, accum=accum)
    keys = batch_keys(cfg)

    def train(state, *batch):
        return step(state, dict(zip(keys, batch)))

    return train


def train_program_spec(cfg, opt_cfg: AdamWConfig, state, batch, *,
                       accum: int = 1, fn=None) -> ProgramSpec:
    """The train program as a :class:`ProgramSpec` bound to the resident
    ``state`` (written in place by every call), its inputs the tensors of
    ``batch`` (templates: shapes, dtypes, device) in :func:`batch_keys`
    order.  ``fn`` overrides the program (e.g. a telemetry-wrapping
    closure); it still fingerprints under the (cfg, opt_cfg, accum)
    context."""
    if fn is None:
        fn = make_train_program(cfg, opt_cfg, accum=accum)
    inputs = tuple(batch[k] for k in batch_keys(cfg))
    return ProgramSpec("train", fn, resident=(state,), inputs=inputs,
                       context="|".join((repr(cfg), repr(opt_cfg),
                                         repr(accum))))


def init_train_state(cfg, seed: int = 0, *, device="cpu",
                     params: Optional[dict] = None) -> dict:
    """{"params": random weights from ``seed`` (or ``params``), "opt":
    fp32 zero moments and step 0}, on ``device``."""
    if params is None:
        params = model_module(cfg).init_params(cfg, seed, device=device)
    return {"params": params, "opt": adamw_init(params)}
