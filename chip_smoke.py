#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line; the first that fails prints its error
and the script exits non-zero:

1. device   the card (``nvidia-smi`` name and power limit), CUDA and torch
            versions; TF32 is switched off for matmul and cuDNN;
2. build    compiles the CUDA kernels from ``kernels/csrc`` with nvcc, one
            process per source, all started together; prints the
            registers, shared memory and spills (``-Xptxas -v``) of K2's
            kernels, of K1's, K3's and K4's wgmma kernels and of K5, and
            fails unless each of those bf16 kernels' SASS holds HGMMA
            (``cuobjdump``) and the wgmma ones spill nothing;
3. matmul   K2 against ``matmul_ref`` at the shapes of the served paths
            (qwen3-0.6b, olmoe-1b-7b, mamba2-130m and recurrentgemma-2b),
            bf16 and f32, with kernel, plain, library (``torch.matmul``, a
            yardstick only) and bound times (device time: a sleep kernel
            holds the card while the calls queue), the wrapper's host us
            per call, and the plan (S, tiles) of each product; the same in
            bf16 at every (K, N) of llama3.2-3b, gemma3-4b, gemma3-12b and
            internvl2-26b, and at seamless-m4t-medium's new ones (d_ff
            4096 both ways and its untied head of 258,048), heads
            included, at a decode batch and an admission (a head timed as
            it comes, cold: larger than the L2 by itself), and
            seamless's products at its prefill's M too (B x S_enc = 2,000,
            B x S_dec = 52), each with the x tile route() took; then at every
            served (K, N), heads included, rows
            of a bf16 product at M in {1, 2, 4, 8} must equal the rows
            computed alone (M = 37 and 256 reported);
4. flash    K1 against ``flash_attention_ref`` over GQA, MHA, causal,
            window, ragged and right-aligned cases, each naming the route
            it took (bf16 at head dim 128 and 256: wgmma), with the same
            times (library: ``scaled_dot_product_attention``); at head dim
            256 (recurrentgemma's MQA, 10 heads over 1) every case is
            timed; every bf16 case's heads at batch 1 must equal the same
            heads inside the batch-2 call, bit for bit; then queries from
            a start on the device (``q_start``, a warm prefix admission's
            suffix over 512 keys) on both routes, bf16 at D 128 and 256
            and f32, Sq 1, 7 and 16, window 0 and 64, starts 0, 200 and
            right-aligned, each against the plain version with the same
            start;
            the rows of a warm call (Sq 16 from 200) must equal the same
            rows of the cold call (Sq = Sk = 216) bit for bit on each
            route; the warm shapes of phase 16 timed (library: SDPA with
            the boolean mask); then phases 18-21's layouts in bf16 (D 128
            at G 3 and G 6, D 256 at G 2 with the "L" window of 1024 and
            without), S 256 and 512 (and 1024 for gemma3-4b), each on the
            wgmma route, batch 1's heads bit-equal to batch 2's, timed
            beside causal SDPA; then phase 22's layouts (16 heads over 16)
            in bf16 and f32 at D 64, the SIMT route: bidirectional at S
            500, cross-attention of 13 queries over 500 keys, causal self
            at 13, and causal=False with 600 queries over 512 keys; the
            causal=False cases at D 128 too (bf16: wgmma); each naming its
            route, bf16 heads at batch 1 bit-equal to batch 2; the D 64
            layouts timed at batch 4 beside SDPA (``is_causal`` for the
            causal self-attention alone); qwen3-moe-30b-a3b's 32 heads
            over 4 (G 8) at D 128 as phases 18-21's layouts (S 256 and
            512, wgmma, batch 1 bit-equal to batch 2, timed);
5. moe_ffn  K3 against ``moe_ffn_ref`` at the olmoe shapes (C = 1, 4, 37,
            40), qwen3-moe-30b-a3b's (E 128, f 768; C 4, 20 and 80),
            Table 2's (E 1, d 2048, f 768, C 32), small ragged shapes,
            and with per-expert row counts that leave experts empty, bf16
            and f32, each naming its route (the MoE shapes in bf16:
            wgmma); a live row's bf16 output at C = 4 must equal the same
            row at C = 1 and C = 8 (C = 40 reported), and the rows at C 20
            the same rows at C 32 (one tile of 32);
6. ssd_scan K4 against ``ssd_scan_ref`` at the mamba2 shape (B 1, S 256,
            H 24, P 64, N 128), at B 2, at ragged S (1, 37, 129, 200, the
            first two below one chunk), from a non-zero state h0 and at
            small ragged P and N, bf16 and f32, on strided views as the
            layer passes them, and at N 64, each naming the route it took
            (bf16 at P 64, ragged S included: wgmma); y and the final state
            are both compared, and a B = 2 call's batch-0 rows must equal
            the B = 1 call's bit for bit; then one call timed at the mamba2
            shape, the bf16 SIMT kernel beside it, and the wgmma kernel at
            B 2 and 4 and at S 128 (library: none, no single PyTorch call
            computes the scan);
7. rglru_scan  K5 against ``rglru_scan_ref`` at the recurrentgemma-2b
            admission shape (B 1, S 256, L 2560), at B 2, at S 1, 37 and
            200, at a ragged L of 40, from zero and from a state h0; h and
            the final state are both compared, card == plain bit for bit
            reported, and a B = 2 call's batch-0 rows must equal the B = 1
            call's bit for bit; then one call timed at the admission shape
            (library: none);
8. serve    qwen3-0.6b at full width (28 layers, d 1024, vocab 153,600) in
            bf16 serving 8 staggered requests; the engine's Syscore
            captures ``decode`` and ``prefill_slot`` as CUDA graphs at
            boot (its report must say "cuda_graph" for both, with their
            warm-up and capture seconds); every stream must equal
            ``reference_generate``, every kernel must have launched
            exactly the expected number of times (the replays' accounting)
            and every K1 and K3 call must have taken the wgmma route; 4
            decode steps and one admission through the graphs must equal
            the same through the eager functions bit for bit, logits and
            every cache leaf; the boot's peak memory and serving's own are
            reported apart, and decode steps and admissions are profiled
            for device time by kernel family and the card's idle share,
            beside the device time of a replay by CUDA events (as in
            9-11);
9. serve_olmoe  olmoe-1b-7b at full width (16 layers, d 2048, 64 experts
            top-8, untied head over vocab 51,200) in bf16 serving 6
            staggered requests, with the same checks for K1, K2 and K3;
            then K3 timed on the inputs the path gave it, beside three
            ``torch.bmm`` as its yardstick;
10. serve_mamba2  mamba2-130m at full width (24 SSM layers, d 768, N 128,
            untied head over vocab 51,200) in bf16 serving 8 staggered
            requests, with the same checks for K2 and K4 (every K4 call on
            the wgmma route);
11. serve_recurrentgemma  recurrentgemma-2b at full width (26 layers =
            8 x (R, R, L) + R, R; d 2560, MQA 10 x 256 over 1 KV head,
            window 2048, tied head over vocab 256,000) in bf16 serving 8
            staggered requests, with the same checks for K1, K2 and K5,
            after a batch-4-vs-1 bit check of its decode layers;
12. parity  reduced qwen3-0.6b, olmoe-1b-7b, mamba2-130m,
            recurrentgemma-2b, llama3.2-3b, gemma3-4b, gemma3-12b and
            internvl2-26b in fp32 on the card and on the CPU, with weights
            drawn once: the greedy streams must be equal, through the dense
            engine and through the paged engine (an arena of 6 blocks of 8
            under 3 requests, timeslice 3), whose card streams must also
            equal the dense engine's; internvl2's ``forward`` with 4
            prefix embeddings from a numpy seed, card against CPU at
            rtol/atol 1e-4; and reduced seamless-m4t-medium's two programs
            (12 frames, 6 prompt tokens, batch 2): the prefill's last
            logits card against CPU at rtol/atol 1e-4, and 8 greedy tokens
            a row equal;
13. serve_paged  the paged KV arena at full width in bf16: qwen3-0.6b
            (16 requests) and recurrentgemma-2b (8 requests) through a
            ``PagingConfig(kv_block=8, arena_blocks=128, timeslice=8)``
            engine at batch 4, max_len 512 (64 blocks a slot: the arena
            holds half the batch), prompts of 160-256 tokens with 96-128
            new each from seed 0, so the workload's blocks are >= 2x the
            arena; evictions, page faults and preemptions must each be
            >= 1, every stream must equal ``reference_generate`` and the
            unpaged engine's stream on the same workload, launches must be
            exact, graph == eager bit for bit (4 decode steps and one
            admission, every cache leaf, the arena without its sink block)
            with every slot mapped, and ``check_invariants()`` must hold;
            decode p50, tok/s, admission ms, device ms a decode step,
            swap-out and page-fault host ms, arena occupancy, boot
            memory and (profiled last) device time and kernels a decode
            step are reported beside the unpaged engine's;
14. serve_horizon  fused decode horizons (``HorizonConfig(length=16)``)
            at full width in bf16, on phase 8-11's params (and engines, as
            the step engines): qwen3-0.6b, olmoe-1b-7b, mamba2-130m and
            recurrentgemma-2b each serve 6 staggered requests of 48 new
            tokens and then a saturated batch (4 requests at once, 65 new
            each), and qwen3-0.6b serves phase 13's workload through phase
            13's arena.  Every stream must equal the step engine's (phase
            13's paged streams for the paged run) and
            ``reference_generate``; a ``decode_horizon`` replay must launch
            exactly 16 decode steps' kernels and each run's launches be
            exact; the saturated run must take <= 1/8 dispatch a token; one
            replay, with a row frozen mid-way and one throughout, must
            equal 16 eager ``decode_step(live=...)`` calls bit for bit,
            events and caches.  Reported: tok/s and ms a token beside the
            step engine, the replay's span and wall time (no profiler
            session: cut for the script's time), and each program's
            capture time and graph pool;
15. serve_spec  speculative decoding (``SpecConfig(k=3, ngram=2)``) on
            the same params: qwen3-0.6b, mamba2-130m, recurrentgemma-2b,
            olmoe-1b-7b, and qwen3-0.6b through a paged arena, serve one
            prompt a slot built as ``benchmarks/bench_spec.py`` builds
            them (8 random tokens and the model's own continuation), 48
            new tokens each, then the same with every step forced through
            verify.  Streams must equal the non-speculative engine's and
            ``reference_generate``, launches be exact (a verify replay: 4
            decode steps' kernels), ``check_invariants()`` hold after the
            paged run; on the card, rows accepting t = 0, 1 and 3 drafts
            must leave each row's cache bit-equal to its accepted tokens
            decoded one at a time, and the verify replay equal its eager
            function.  Reported: accept rate, tok/s beside the
            non-speculative engine, verify's device time (CUDA events; no
            profiler session) against 4 decode steps', capture time and
            graph pool.  Last, qwen3-0.6b's
            engine with both (``spec`` and ``horizon``), whose steps
            without a draft fall back to fused horizons: streams and
            launches as above;
16. serve_prefix  prefix sharing (``PrefixConfig``) on the paged arena at
            full width in bf16, on phase 8-11's params: first
            ``benchmarks/bench_prefix.py``'s workload on qwen3-0.6b (a
            257-token popular prompt, kv_block 8, max_suffix 1, batch 2,
            max_len 320, prefill_len 264; one cold request, then 4 warm
            ones): every stream must equal the batch-1 reference of that
            geometry, every shared block be mapped by >= 2 requests,
            launches be exact, the ``prefill_offset`` graph equal its
            eager function and its last logits equal the reference's cold
            ``prefill_slot`` logits bit for bit; warm and cold TTFT are
            reported with their ratio (not a limit).  Then
            ``tests/test_prefix.py``'s sharing workload at kv_block 8
            (max_suffix 16, max_len 64, prefill_len 32) on qwen3-0.6b in
            plain, speculative (k 3) and horizon (H 16) modes and on
            recurrentgemma-2b and olmoe-1b-7b in plain mode (tier 2: a
            full prefill over the shared blocks): streams equal to the
            reference, qwen3 >= 3 warm admissions, tier 2 none and >= 3
            prefix admissions, ``check_invariants()``, exact launches,
            hostcall 10 once a prefix admission, and every resident
            shared block equal to its ``PrefixStore`` copy;
17. serve_burst  burst admission (``group_prefill=True``) at full width on
            qwen3-0.6b and mamba2-130m, batch 4: 4 requests at step 0,
            then 4 that refill freed slots one by one; ``prefill`` must run
            once, streams equal ``reference_generate``, launches be exact,
            every K1 and K4 call take the wgmma route and the ``prefill``
            replay equal its eager function; the burst's admission ms is
            reported beside 4 ``prefill_slot`` admissions';
18. serve_llama  llama3.2-3b at full width (28 layers, d 3072, 24 heads
            over 8, tied head over vocab 129,024) in bf16, phases 8-11's
            engines freed first: phase 8's workload and checks (streams
            equal ``reference_generate``, launches exact: K2 7 L + 1 a
            pass, K1 L an admission, K3-K5 none; every K1 call on the
            wgmma route; 4 decode steps and one admission through the
            graphs equal the eager functions bit for bit) and figures, and
            (n_layers, d_model, padded_vocab) against the published config;
19. serve_gemma3_4b  gemma3-4b at full width (34 layers = 5 x (5 L + G) +
            4 L, d 2560, 8 heads over 4 of 256, window 1024, tied head over
            vocab 262,144) with phase 18's checks; then its family row on
            the same params: the paged engine (phase 13's geometry, 8
            requests), the horizon engine (H 16, phase 14's workloads), the
            speculative engine (k 3, phase 15's lookup prompts and forced
            drafts), phase 16's sharing workload (the warm path) and, last,
            an engine at prefill_len 1024 (the window) and max_len 1152
            whose "L" caches are rings, serving 2 requests of 960 and 1000
            tokens with 96 new each, so that decode wraps each ring; every
            stream equal to ``reference_generate`` of its geometry;
20. serve_gemma3_12b  gemma3-12b at full width (48 layers, d 3840, 16
            heads over 8 of 256, d_ff 15,360) with phase 18's checks, 6
            requests of 16 new tokens;
21. serve_internvl2  internvl2-26b's text backbone at full width (48
            layers, d 6144, 48 heads over 8, untied head over vocab 94,208)
            with phase 18's checks, 6 requests of 16 new tokens, as the
            reference's engine serves it; then its frontend: the
            whole-batch ``prefill`` program, captured at batch 2 and 1,
            with 256 patch embeddings (bf16, numpy seed 0) before 200 text
            tokens (S = 456), and 16 greedy ``decode_step``s from its
            cache: finite logits, batch 1 equal to row 0 of batch 2 bit for
            bit (prefill logits and tokens), each replay equal to its eager
            function;
22. serve_seamless  seamless-m4t-medium, the encoder-decoder, at full
            width (12 encoder and 12 decoder layers, d 1024, 16 heads of
            64, d_ff 4096, untied head over vocab 258,048) in bf16, weights
            drawn on the card from seed 0, through the encdec branches of
            ``steps.make_prefill_step`` and ``make_serve_step`` captured
            as CUDA graphs (``steps.encdec_program_specs``): batch 4, frames
            (4, 500, 1024) and 13-token prompts from numpy seed 0, 48
            greedy tokens a row.  Launches exact (K1 36 a prefill, every
            one on the SIMT route, none a decode step; K2 217 a prefill and
            109 a step; K3-K5 none); one prefill and 4 decode steps through
            the graphs equal the eager functions bit for bit (logits,
            tokens, every cache leaf, the cross K/V included); each request
            alone at batch 1 gives its row's prefill logits and 48 tokens
            bit for bit; logits finite; ``decode_attention``'s rows at
            batch 4 equal the rows alone at every ported head layout and
            cache lengths on and off a multiple of 64 (the batched scores
            einsum's rows reported beside them).  Reported: decode p50 and
            tok/s, prefill ms, device time by kernel family and idle share
            of a decode step and of a prefill, K2's time a step and a
            prefill beside its bound and ``torch.matmul``, memory;
23. warm_boot  the program store (paper §3.3): for qwen3-0.6b, then
            mamba2-130m, at full width (phase 8's geometry, seed 0), a cold
            boot over a fresh ``ProgramStore`` in a temporary directory
            serves phase 8's 8 requests (streams equal
            ``reference_generate``, launches exact) and exports every
            program; ``repro_torch.bench.boot --warm`` in a fresh process
            boots from that directory: every program ``source == "store"``
            with ``load_s > 0``, no call of a program function, the same
            streams and launches; then the ``decode`` entry is torn: the
            next boot captures it from its function (a counted miss),
            heals the entry and stays exact.  Reported: cold and warm
            ``boot_s``, per program ``load_s``, ``lower_s``,
            ``compile_s``, the export's seconds and ``serialized_bytes``,
            a warm and a cold ``decode`` replay's device time;
24. table1  ``repro_torch.bench.load_exec``: Table 1's four rows on
            qwen3-0.6b's ``decode`` at full width (cold_execute, hot_load,
            serialize + install_serialized with the payload's bytes, a
            re-execute and the cold / re-execute ratio), the serialized
            program bit-equal to the hot-loaded one;
25. hostcalls  in-graph host calls (paper §3.5): a captured program with
            a ``CALL_METRIC`` call and a ``hostcall_value`` call, replayed
            100 times under a watchdog (an event polled for 60 s, which
            fails the phase and not the run's clock): the table receives
            the 100 device-computed values in order, each replay's value
            reaches the kernel after it, the store skips the program;
            then ``repro_torch.bench.hostcall`` in a process of its own
            (its timeout the watchdog): the no-op and value round trips
            and UVA's 256 KB host write and write + H2D;
26. serve_qwen3_moe  qwen3-moe-30b-a3b at full width (48 layers, d 2048,
            128 experts of f 768 top-8, GQA 32/4 of 128, untied head over
            vocab 151,936; 30.5 B parameters, 61 GB in bf16) in a process
            of its own (``chip_smoke.py --serve-qwen3-moe``: the card is
            free for its weights, drawn on the card from seed 0): phase
            8's requests and checks (streams against
            ``reference_generate``, graph == eager, exact launches, every
            K1 and K3 call on the wgmma route), peak memory, K3 timed per
            decode call (C 4) and per admission call (C 20) on the path's
            own inputs against the live experts' bytes, then
            ``repro_torch.bench.serve``'s trace on the same weights (its
            refilled streams against ``reference_generate``; its burst
            prefill, K3 at C 80, replayed against the program's eager
            function on the burst's inputs, and its first tokens against
            that replay); no program is exported;
27. benches  ``python -m repro_torch.bench --smoke`` (each bench in a
            process of its own) at full width in bf16, with the
            reference's smoke workloads to keep the script inside its
            time: ``serve`` (qwen3-0.6b), ``placement`` (Table 2 over one
            qwen3-moe-30b-a3b layer's 128 experts, which has no smoke
            size: the three layouts' outputs bit-equal, layout A's against
            ``moe_ffn_ref``), ``paging``, ``prefix``, ``fused`` and
            ``spec`` (qwen3-0.6b); each names
            the card, keeps its reference's exactness and count checks,
            reports its speed ratios without asserting them, and launches
            K1 and K3 on the wgmma route only;
28. serve_cluster  qwen3-0.6b's serving fleet (``repro_torch.cluster``)
            at full width in a process of its own (``chip_smoke.py
            --serve-cluster``, so that its replicas' graph pools go with
            it), over one fresh ``ProgramStore`` that one cold boot
            exported (phase 23's qwen3 boot, copied before any other boot
            read it; run alone, a cold boot in the process): A, two replicas, phase 8's requests and
            ``bench.cluster``'s, replica 1 killed mid-decode and rebooted
            warm; C, on A's fleet, replica 0 slowed by 50 ms a tick and
            replaced warm on the straggler monitor's escalation; B, one
            replica grown to two under a burst with the new replica's
            store loads on a background thread while replica 0 serves,
            queued requests rebalanced, then shrunk on idle.  Every stream
            against the batch-1 engine, no request lost, every later boot
            warm (every program from the store, no program function
            called, one store hit a program, no put, nothing exported),
            K1 and K2 launches equal to the programs' replays and warm-ups
            (B's background load included); one JSON line a sub-run.

Then a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  The full record is also written to
``results/chip_smoke.json``.  Without a card, or outside a checkout of
the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import signal
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# tolerances of tests/test_kernels.py (matmul :41, flash attention :72, :75)
MATMUL_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
FLASH_TOL = {"float32": 3e-4, "bfloat16": 3e-2}
# tolerances of tests/test_kernels.py (moe_ffn :189 f32, :202 bf16)
MOE_TOL = {"float32": 3e-4, "bfloat16": 5e-2}
# the SSD tolerance of tests/test_kernels.py:132 in f32; in bf16 the
# loosest of that file (:202)
SSD_TOL = {"float32": 3e-3, "bfloat16": 5e-2}
# the RG-LRU tolerance of tests/test_kernels.py:160 (K5 is fp32 only)
RGLRU_TOL = 2e-4

# the serving runs of phases 8-11 at full width: batch 4 keeps every
# decode-time capacity at its floor of 4 (no token is dropped), so the
# engine's olmoe streams can equal the batch-1 reference
BATCH, MAX_LEN, PREFILL_LEN, MAX_NEW, MOE_MAX_NEW = 4, 512, 256, 32, 16
# phase 13's arena: 64 blocks of 8 a slot, half the batch's 256 resident
PAGED_BLOCK, PAGED_ARENA, PAGED_TIMESLICE = 8, 128, 8
# phase 14: horizons of 16 steps, 48 new tokens a request so that they
# fuse; phase 15: 3 drafts a verify from a bigram lookup, prompts of 8
# random tokens and the model's own 56-token continuation
HORIZON, HORIZON_MAX_NEW = 16, 48
SPEC_K, SPEC_NGRAM, SPEC_WARM, SPEC_MAX_NEW = 3, 2, 56, 48
# phase 16's sharing workload: new tokens a request
PREFIX_MAX_NEW = 12

RECORD = {"phases": []}


def emit(obj):
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    out = {"phase": name}
    try:
        yield out
    except Exception as e:  # report the failing phase, then exit non-zero
        out.update(ok=False, error=f"{type(e).__name__}: {e}",
                   seconds=time.perf_counter() - t0)
        emit(out)
        traceback.print_exc()
        RECORD["phases"].append(out)
        _write_record()
        if isinstance(e, DeviceTimeout):
            # the stream is stuck: leave without waiting for it at exit
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
        sys.exit(1)
    out.update(ok=True, seconds=round(time.perf_counter() - t0, 3))
    RECORD["phases"].append(out)
    emit({k: v for k, v in out.items() if k != "detail"})


class DeviceTimeout(RuntimeError):
    """The card did not finish queued work in time (a hung host node)."""


def wait_device(torch, seconds):
    """Wait for the work queued so far on the current stream, polling an
    event (the host never blocks in a CUDA call), and raise
    :class:`DeviceTimeout` after ``seconds``: the watchdog of a phase that
    replays host nodes, which fails the phase and not the run's clock."""
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.perf_counter()
    while not ev.query():
        if time.perf_counter() - t0 > seconds:
            raise DeviceTimeout(f"queued work did not finish in {seconds} s")
        time.sleep(0.001)


def _write_record():
    out_dir = os.path.join(ROOT, "results")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)


def cuda_ms(torch, fn, iters=10, warmup=2):
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls.  A sleep kernel holds the
    card while the host queues the calls, so the events time the device
    and not the host's launches (timed apart, :func:`host_us`)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at up to 2 GHz for 1.5x the host's queueing time, capped
    torch.cuda._sleep(int(min(2e9 * (1.5 * enqueue_s * iters + 1e-4), 4e8)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters=50):
    """Mean host time of one call of ``fn`` in us, without waiting for the
    card (what the host spends to queue it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return us


def sass_counts(library, opcode):
    """Lines of ``opcode`` in each function of ``library``'s SASS
    (``cuobjdump -sass``), by mangled name."""
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        cuobjdump = "cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    fn, counts = None, {}
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn is not None and opcode in line:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def bound_ms(nbytes, flops, dtype_name):
    """The card's least time for the work and what bounds it: the port's
    ``repro_torch.bench.common.bound_ms`` (the H100's peaks live there)."""
    from repro_torch.bench.common import bound_ms as bound
    return bound(nbytes, flops, dtype_name)


def max_violation(got, want, tol):
    """max(|got - want| - (tol + tol * |want|)) in fp32, and max |err|."""
    g, w = got.float(), want.float()
    if not bool(g.isfinite().all()):
        raise AssertionError("non-finite kernel output")
    err = (g - w).abs()
    return float((err - (tol + tol * w.abs())).max()), float(err.max())


def to_device(tree, device):
    """A nested dict of tensors, copied to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def copy_tree(dst, src):
    """Copy ``src``'s leaves into ``dst``'s, in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            copy_tree(dst[k], v)
        else:
            dst[k].copy_(v)


def tree_diffs(torch, a, b, path=""):
    """Paths of the leaves of two trees that are not bit-equal."""
    if isinstance(a, dict):
        return [p for k in sorted(a)
                for p in tree_diffs(torch, a[k], b[k], f"{path}/{k}")]
    return [] if torch.equal(a, b) else [path]


def without_sink(tree):
    """A paged cache tree's leaves with the arena leaves cut to the blocks
    the pager owns: the last block is the sink of dropped writes, which
    racing writes leave in no fixed order and nothing reads."""
    def cut(path, t):
        if path[-1] not in ("k", "v"):
            return t
        axis = 1 if path[0] == "groups" else 0
        return t.narrow(axis, 0, t.shape[axis] - 1)

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return cut(path, node)
    return walk(tree) if "block_table" in tree else tree


def graph_vs_eager(torch, eng, dev, long_tokens, steps=4, slot=2):
    """``steps`` decode steps and one admission (``long_tokens``, 200
    valid, into ``slot``) through the engine's programs, which replay
    their captured graphs on the live caches, and through the programs'
    eager functions on a clone of the same caches: the logits, tokens and
    every cache leaf (a paged arena without its sink) must be bit-equal.
    The live caches are restored after.  Returns the differing outputs
    (empty when equal)."""
    decode, prefill = eng.programs["decode"], eng.programs["prefill_slot"]
    backup = clone_tree(eng.caches)
    eager = clone_tree(eng.caches)
    diffs = []
    gen = torch.Generator(device="cpu").manual_seed(1)
    tok = torch.randint(1, eng.cfg.vocab_size, (eng.batch, 1), generator=gen,
                        dtype=torch.int32).to(dev)
    tok_e = tok
    for i in range(steps):
        _, nt_g, lg_g = decode(eng.params, eng.caches, tok)
        _, nt_e, lg_e = decode.program.fn(eng.params, eager, tok_e)
        if not torch.equal(lg_g, lg_e):
            diffs.append(f"decode step {i}: logits")
        if not torch.equal(nt_g, nt_e):
            diffs.append(f"decode step {i}: tokens")
        tok, tok_e = nt_g.clone(), nt_e
    diffs += [f"decode: cache {p}"
              for p in tree_diffs(torch, without_sink(eng.caches),
                                  without_sink(eager))]
    _, last_g = prefill(eng.params, eng.caches, long_tokens, slot, 200)
    _, last_e = prefill.program.fn(eng.params, eager, long_tokens, slot, 200)
    if not torch.equal(last_g, last_e):
        diffs.append("prefill_slot: last logits")
    diffs += [f"prefill_slot: cache {p}"
              for p in tree_diffs(torch, without_sink(eng.caches),
                                  without_sink(eager))]
    copy_tree(eng.caches, backup)
    torch.cuda.synchronize()
    return diffs


def decode_call(torch, eng, dev, eager=False):
    """One decode step of the live engine: a replay of its ``decode``
    graph, or with ``eager`` the program's eager function."""
    tokens = torch.zeros((eng.batch, 1), dtype=torch.int32, device=dev)
    decode = eng.programs["decode"]
    fn = decode.program.fn if eager else decode
    return lambda: fn(eng.params, eng.caches, tokens)


def admission_call(eng, long_tokens, eager=False):
    """The same for an admission: ``prefill_slot`` of the 200-token prompt
    into slot 0 ("per_step" keys below are per admission)."""
    prefill = eng.programs["prefill_slot"]
    fn = prefill.program.fn if eager else prefill
    return lambda: fn(eng.params, eng.caches, long_tokens, 0, 200)


def median_wall_ms(torch, call, steps):
    """Median host wall time in ms of ``call`` ended by a sync, over
    ``steps`` calls after two warm-up calls."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[steps // 2]


def time_calls(torch, call, steps):
    """``call`` without the profiler: its wall time with a sync (median of
    ``steps``), its device time by CUDA events around ``steps`` calls
    queued behind a sleep kernel (:func:`cuda_ms`; a replayed graph's
    kernels count there whatever the profiler attributes), and the host
    time to queue one call (:func:`host_us`)."""
    return {"wall_ms_per_step": median_wall_ms(torch, call, steps),
            "events_device_ms_per_step": cuda_ms(torch, call, iters=steps,
                                                 warmup=1),
            "host_ms_per_call": host_us(torch, call, iters=steps) / 1e3}


def profile_calls(torch, call, steps, timed):
    """``call`` ``steps`` times under torch.profiler, each ended by a
    sync: device time by kernel family (K2, K1, K3, K4, K5, PyTorch's own
    kernels) and kernels per call, beside ``timed`` (:func:`time_calls`,
    measured before any profiler ran in the phase).  The idle share is one
    minus the profiled (or the events') device time over the unprofiled
    wall time of a step; under the profiler the wall time grows, so its
    own idle share is given apart.  No family keys where the profiler saw
    no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            call()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    fam = {"matmul_kernel": 0.0, "flash_attention_kernel": 0.0,
           "moe_ffn_kernel": 0.0, "ssd_scan_kernel": 0.0,
           "rglru_scan_kernel": 0.0, "torch": 0.0}
    n_kernels = 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        n_kernels += e.count
        key = next((k for k in fam if k in e.key), "torch")
        fam[key] += t / 1e3                      # us -> ms
    busy = sum(fam.values())
    wall_unprofiled = timed["wall_ms_per_step"]
    events_ms = timed["events_device_ms_per_step"]
    out = dict(timed, idle_share_events=max(
        0.0, 1.0 - events_ms / wall_unprofiled))
    if busy == 0:
        return dict(out, device_ms=None)
    return dict(out,
                wall_ms_per_step_profiled=wall_ms / steps,
                device_ms_per_step=busy / steps,
                matmul_ms_per_step=fam["matmul_kernel"] / steps,
                flash_ms_per_step=fam["flash_attention_kernel"] / steps,
                moe_ffn_ms_per_step=fam["moe_ffn_kernel"] / steps,
                ssd_scan_ms_per_step=fam["ssd_scan_kernel"] / steps,
                rglru_scan_ms_per_step=fam["rglru_scan_kernel"] / steps,
                torch_ms_per_step=fam["torch"] / steps,
                kernels_per_step=n_kernels / steps,
                idle_share=max(0.0, 1.0 - busy / steps / wall_unprofiled),
                idle_share_profiled=max(0.0, 1.0 - busy / wall_ms))


def serve_engine(out, arch, plens, arrivals, max_new, per_pass, smi):
    """Serve staggered requests through one full-width bf16 engine;
    hold every stream against ``reference_generate`` and the kernel
    launches of the run against ``per_pass``: {kernel: (per decode
    step, per admission)}.  Returns the engine, the admission's tokens,
    the launches and the launches by route."""
    import numpy as np
    import torch

    from repro_torch.engine_config import EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import transformer
    dev = torch.device("cuda")
    gc.collect()          # an earlier phase's engine may sit in a cycle
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(arch, EngineConfig(
        reduced=False, batch=BATCH, max_len=MAX_LEN,
        prefill_len=PREFILL_LEN, clock="step", seed=0), device="cuda")
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    # the boot's peak (weights drawn in fp32, then cast), then serving's
    # own from here on
    boot_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    after_boot = torch.cuda.memory_allocated()
    cfg = eng.cfg
    assert eng.params["embed"].dtype == torch.bfloat16
    # the Syscore captured both programs at boot
    programs = eng.syscore.report()["programs"]
    for name, prog in programs.items():
        print(f"{arch} {name}: source {prog['source']}, lower_s "
              f"{prog['lower_s']:.4f}, compile_s {prog['compile_s']:.4f}",
              flush=True)
        if prog["source"] != "cuda_graph" or not prog["compile_s"] > 0:
            raise AssertionError(f"{arch} {name} is not a captured "
                                 f"graph: {prog}")
    tree_bytes = sum(t.numel() * t.element_size()
                     for tree in (eng.params, eng.caches)
                     for t in leaves(tree))
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size, size=p),
                       max_new=max_new, arrival_time=a)
            for p, a in zip(plens, arrivals)]
    ops.reset_launch_counts()
    stats = eng.run()
    launches = ops.launch_counts()
    routes = ops.route_counts()
    peak = torch.cuda.max_memory_allocated()
    assert stats["requests"] == len(reqs), stats
    assert stats["refill_admissions"] >= 1, stats
    admissions = stats["admitted"]
    want = {name: step * stats["decode_steps"] + adm * admissions
            for name, (step, adm) in per_pass.items()}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{want}")
    # every served K1, K3 and K4 call is bf16 on the tensor cores
    if any(r["wgmma"] != launches[name] for name, r in routes.items()):
        raise AssertionError(f"K1/K3/K4 calls off the wgmma route: "
                             f"{routes}")
    mism = []
    for r in reqs:
        ref = eng.reference_generate(r.prompt, r.max_new)
        if ref != r.generated:
            mism.append({"rid": r.rid, "engine": r.generated,
                         "reference": ref})
    if mism:
        RECORD.setdefault("stream_mismatch", {})[arch] = mism
        raise AssertionError(f"{len(mism)} of {len(reqs)} streams differ "
                             f"from reference_generate: {mism[0]}")
    # what comes out is finite and of the expected shape
    pad = [0] * (PREFILL_LEN - reqs[0].prompt_len)
    tokens = torch.from_numpy(np.asarray(
        [reqs[0].prompt.tolist() + pad], np.int32)).to(dev)
    logits, _ = transformer.forward(
        cfg, eng.params, tokens, mode="prefill",
        caches=transformer.init_cache(cfg, 1, MAX_LEN, device=dev),
        lengths=torch.tensor([reqs[0].prompt_len]))
    assert logits.shape == (1, PREFILL_LEN, cfg.padded_vocab), \
        logits.shape
    assert bool(logits.isfinite().all()), "non-finite logits"
    first = int(torch.argmax(
        logits[0, reqs[0].prompt_len - 1, :cfg.vocab_size].float()))
    assert first == reqs[0].generated[0], (first, reqs[0].generated[0])
    # one admission (prefill_slot of a 200-token prompt) on the host
    # clock with a sync, and where the device time of decode goes
    long = next(r for r in reqs if r.prompt_len == 200)
    long_tokens = torch.zeros((1, PREFILL_LEN), dtype=torch.int32)
    long_tokens[0, :200] = torch.from_numpy(long.prompt)
    long_tokens = long_tokens.to(dev)
    # the graphs against the eager functions, on the live caches
    diffs = graph_vs_eager(torch, eng, dev, long_tokens)
    if diffs:
        raise AssertionError(f"{arch}: graph replay and eager run "
                             f"differ: {diffs[:8]}")
    ref_programs = eng._ref_engine.syscore.report()["programs"]
    if any(p["source"] != "cuda_graph" for p in ref_programs.values()):
        raise AssertionError(f"{arch}: the reference engine's programs "
                             f"are not captured: {ref_programs}")
    admit_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.programs["prefill_slot"](eng.params, eng.caches, long_tokens,
                                     0, 200)
        torch.cuda.synchronize()
        admit_ms.append(1e3 * (time.perf_counter() - t1))
    # the replays, then the programs' eager functions, timed before the
    # phase's profiler runs; then the replays under the profiler, and
    # the eager decode and a replay's host time again after it (a
    # profiler session adds host time to later launches in the process)
    calls = {"decode": (decode_call(torch, eng, dev), 5),
             "admission": (admission_call(eng, long_tokens), 3)}
    eager_calls = {
        "decode": (decode_call(torch, eng, dev, eager=True), 5),
        "admission": (admission_call(eng, long_tokens, eager=True), 3)}
    timed = {k: time_calls(torch, *c) for k, c in calls.items()}
    eager_ms = {k: median_wall_ms(torch, *c)
                for k, c in eager_calls.items()}
    profile = profile_calls(torch, *calls["decode"], timed["decode"])
    admission_profile = profile_calls(torch, *calls["admission"],
                                      timed["admission"])
    eager_ms["decode_after_profiler"] = median_wall_ms(
        torch, *eager_calls["decode"])
    profile["host_ms_per_call_after_profiler"] = host_us(
        torch, calls["decode"][0], iters=5) / 1e3
    out.update(
        model=arch, dtype="bfloat16", layers=cfg.n_layers,
        d_model=cfg.d_model, padded_vocab=cfg.padded_vocab,
        batch=BATCH, max_len=MAX_LEN, prefill_len=PREFILL_LEN,
        requests=len(reqs), prompt_lens=plens, arrivals=arrivals,
        max_new=max_new, boot_s=round(boot_s, 3),
        tok_per_s=stats["tok_per_s"], ttft_ms=stats["ttft_ms"],
        decode_p50_ms=stats["decode_p50_ms"], wall_s=stats["wall_s"],
        tokens=stats["tokens"], decode_steps=stats["decode_steps"],
        admitted=admissions, programs=eng.syscore.report()["programs"],
        graph_equals_eager={"decode_steps": 4, "admissions": 1,
                            "bit_equal": True},
        refill_admissions=stats["refill_admissions"],
        occupancy=stats["occupancy"], launches=launches,
        launches_by_route=routes, launches_per_pass=per_pass,
        admission_ms=sorted(admit_ms[1:])[1], profile=profile,
        admission_profile=admission_profile,
        eager_wall_ms=eager_ms,
        peak_mem_gib=round(max(peak, boot_peak) / 2 ** 30, 3),
        boot_peak_gib=round(boot_peak / 2 ** 30, 3),
        serve_peak_gib=round(peak / 2 ** 30, 3),
        serve_peak_above_boot_gib=round((peak - after_boot) / 2 ** 30, 3),
        mem_at_start_gib=round(base / 2 ** 30, 3),
        mem_after_boot_gib=round(after_boot / 2 ** 30, 3),
        params_and_caches_gib=round(tree_bytes / 2 ** 30, 3),
        boot_besides_trees_gib=round(
            (after_boot - base - tree_bytes) / 2 ** 30, 3),
        streams_equal_reference=True, card=smi)
    return eng, long_tokens, launches, routes


def k3_timed(eng, long_tokens):
    """K3 on the inputs an MoE engine's path gives it: record every call
    of one decode step and of one admission (``prefill_slot`` of
    ``long_tokens``, 200 valid), then time each set cycling through its
    layers, so every call streams its own layer's experts from memory as
    the path does; beside the plain version, three ``torch.bmm`` as a
    yardstick, and the bound over the live experts' bytes."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_dispatch import moe_ffn, moe_ffn_ref
    from repro_torch.kernels.moe_dispatch import route as moe_route
    from repro_torch.kernels.moe_dispatch import tile_rows
    dev = torch.device("cuda")
    k3 = {}
    real = ops.moe_ffn
    seen = []

    def record(*args):
        seen.append(args)
        return real(*args)

    # (the programs' eager functions: a replay calls no Python)
    ops.moe_ffn = record
    try:
        eng.programs["decode"].program.fn(
            eng.params, eng.caches,
            torch.zeros((BATCH, 1), dtype=torch.int32, device=dev))
        n_dec = len(seen)
        eng.programs["prefill_slot"].program.fn(
            eng.params, eng.caches, long_tokens, 0, 200)
    finally:
        ops.moe_ffn = real
    torch.cuda.synchronize()
    for name, calls in (("decode", seen[:n_dec]),
                        ("admission", seen[n_dec:])):
        assert len(calls) == eng.cfg.n_layers, len(calls)
        it = {"i": 0}

        def nxt():
            it["i"] += 1
            return calls[it["i"] % len(calls)]

        def bmm3(buf, w1, w3, w2, counts):
            h = torch.nn.functional.silu(torch.bmm(buf, w1)) \
                * torch.bmm(buf, w3)
            return torch.bmm(h, w2)

        ms = cuda_ms(torch, lambda: moe_ffn(*nxt()), iters=32)
        plain = cuda_ms(torch, lambda: moe_ffn_ref(*nxt()), iters=32)
        yard = cuda_ms(torch, lambda: bmm3(*nxt()), iters=32)
        nbytes = flops = 0
        live_experts = rows = 0
        for buf, w1, _, _, counts in calls:
            e, c, d = buf.shape
            f = w1.shape[2]
            n_live = int((counts > 0).sum())
            n_rows = int(counts.sum())
            live_experts += n_live
            rows += n_rows
            nbytes += 2 * e * c * d * 2 + n_live * 3 * d * f * 2 + e * 4
            flops += 6 * n_rows * d * f
        b_ms, b_by = bound_ms(nbytes / len(calls), flops / len(calls),
                              "bfloat16")
        k3[name] = {"dtype": "bfloat16", "E": e, "C": c, "d": d, "f": f,
                    "route": moe_route(buf.dtype, d, f),
                    "tile_rows": tile_rows(c),
                    "live_experts_per_call": live_experts / len(calls),
                    "rows_per_call": rows / len(calls),
                    "ms": ms, "plain_ms": plain,
                    "yardstick_bmm_ms": yard, "bound_ms": b_ms,
                    "bound_by": b_by, "bound_share": b_ms / ms,
                    "yardstick_factor": ms / yard}
    return k3


# phase 26: qwen3-moe-30b-a3b at its published width and depth, in a
# process of its own (the 61 GB of weights need the whole card); phase 8's
# requests
QWEN3_MOE = "qwen3-moe-30b-a3b"
PHASE8_PLENS = [16, 200, 57, 120, 31, 180, 90, 140]
PHASE8_ARRIVALS = [0, 0, 0, 0, 3, 9, 20, 40]


def serve_qwen3_moe():
    """Phase 26's body (``chip_smoke.py --serve-qwen3-moe``, started by
    phase 26 in a fresh process): qwen3-moe-30b-a3b drawn on the card from
    seed 0, served by :func:`serve_engine` (streams against
    ``reference_generate``, graph == eager, exact launches, every K1 and K3
    call on the wgmma route), K3 timed on the path's inputs
    (:func:`k3_timed`), then ``repro_torch.bench.serve``'s trace on the
    same weights (its refills against ``reference_generate``, its burst
    prefill's replay against the program's eager function).  No program
    is exported: neither engine has a store.
    Prints its lines, then its record as the last line."""
    import numpy as np
    import torch
    sys.path.insert(0, SRC)
    from repro_torch.bench import serve as serve_bench
    from repro_torch.kernels import _build
    from repro_torch.models import registry
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.library()
    cfg = registry.get_config(QWEN3_MOE)
    assert (cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.experts_per_token,
            cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.vocab_size, cfg.tie_embeddings) == \
        (48, 2048, 128, 8, 768, 32, 4, 128, 151_936, False), cfg
    n = cfg.n_layers
    # K2: wq, wk, wv, wo and the router a layer, and the head; K1 a layer
    # an admission; K3 a layer a step and an admission
    per_pass = {"matmul": (5 * n + 1, 5 * n + 1),
                "flash_attention": (0, n), "moe_ffn": (n, n),
                "ssd_scan": (0, 0), "rglru_scan": (0, 0)}
    out = {}
    eng, long_tokens, launches, routes = serve_engine(
        out, QWEN3_MOE, PHASE8_PLENS, PHASE8_ARRIVALS, MAX_NEW, per_pass, smi)
    if eng.syscore.store is not None or \
            eng._ref_engine.syscore.store is not None:
        raise AssertionError("phase 26 must export no program")
    out.update(
        params=sum(t.numel() for t in leaves(eng.params)),
        params_gb=sum(t.numel() * t.element_size()
                      for t in leaves(eng.params)) / 1e9,
        launches_by_route=routes)
    print(f"{QWEN3_MOE}: {out['params']:,} parameters "
          f"({out['params_gb']:.2f} GB), decode p50 "
          f"{out['decode_p50_ms']:.3f} ms, {out['tok_per_s']:.1f} tok/s, "
          f"admission {out['admission_ms']:.3f} ms, peak "
          f"{out['peak_mem_gib']:.2f} GiB (boot {out['boot_peak_gib']:.2f}, "
          f"serving {out['serve_peak_gib']:.2f}) ({smi})", flush=True)
    out["k3_timed"] = k3_timed(eng, long_tokens)
    for key, k in out["k3_timed"].items():
        print(f"{QWEN3_MOE} K3 per {key} call (E {k['E']}, C {k['C']}, tile "
              f"{k['tile_rows']}, {k['live_experts_per_call']:.1f} live "
              f"experts): {k['ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}), plain {k['plain_ms']:.4f} ms, three bmm "
              f"{k['yardstick_bmm_ms']:.4f} ms ({smi})", flush=True)
    # the reference's serve trace on the same weights (no second draw);
    # first its requests through this engine's batch-1 reference
    work = serve_bench.trace(cfg.vocab_size)
    refs = [eng.reference_generate(p, m) for p, m in work]
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench = serve_bench.run(QWEN3_MOE, full=True, device="cuda",
                            params=params, keep_engine=True)
    bench["seconds"] = time.perf_counter() - t0
    beng = bench.pop("_engine")
    if bench["requests"] != 32 or \
            set(bench["sources"].values()) != {"cuda_graph"} or any(
                r["wgmma"] != bench["launches"][k] or r["simt"]
                for k, r in bench["launches_by_route"].items()):
        raise AssertionError(f"{QWEN3_MOE} serve bench: {bench}")
    # every request is due at once into an idle engine, so one burst
    # prefill admits the first ``batch`` of them and prefill_slot each
    # later one: those are held against the batch-1 reference bit for
    # bit.  A burst routes its B x prefill_len rows (padded ones too)
    # under one capacity (C 80 here), as the reference's burst does, so a
    # burst row may lose an expert slot that it keeps alone: the burst's
    # streams are held to the JAX engine's on the CPU
    # (tests/test_torch_bench_serve.py), and here its ``prefill`` replay
    # to the program's eager function on the burst's own inputs, and its
    # first tokens to that replay's logits
    nb = bench["batch"]
    if (bench["programs"]["prefill"], bench["programs"]["prefill_slot"],
            bench["prefill_len"]) != (1, len(work) - nb, PREFILL_LEN):
        raise AssertionError(f"{QWEN3_MOE} serve bench admissions: "
                             f"{bench['programs']}")
    mism = [i for i in range(nb, len(work))
            if bench["streams"][i] != refs[i]]
    if mism:
        raise AssertionError(f"{QWEN3_MOE} serve bench: refilled streams "
                             f"{mism} differ from reference_generate")
    tokens = torch.zeros((nb, beng.prefill_len), dtype=torch.int32)
    for i, (p, _) in enumerate(work[:nb]):
        tokens[i, :len(p)] = torch.from_numpy(p)
    tokens = tokens.cuda()
    lengths = torch.tensor([len(p) for p, _ in work[:nb]],
                           dtype=torch.int32, device="cuda")
    prefill = beng.programs["prefill"]
    eager = clone_tree(beng.caches)
    _, last_g = prefill(beng.params, beng.caches, tokens, lengths)
    _, last_e = prefill.program.fn(beng.params, eager, tokens, lengths)
    diffs = (["last logits"] if not torch.equal(last_g, last_e) else []) \
        + tree_diffs(torch, beng.caches, eager)
    if diffs:
        raise AssertionError(f"{QWEN3_MOE} burst prefill: graph and eager "
                             f"differ: {diffs[:8]}")
    # (the engine's own pick: numpy's argmax, the first of any ties)
    firsts = np.argmax(last_g[:, :cfg.vocab_size].float().cpu().numpy(),
                       -1).tolist()
    if firsts != [s[0] for s in bench["streams"][:nb]]:
        raise AssertionError(f"{QWEN3_MOE} burst: first tokens "
                             f"{[s[0] for s in bench['streams'][:nb]]}, its "
                             f"replay's logits give {firsts}")
    bench.update(refills_equal_reference=True,
                 burst_graph_equals_eager=True,
                 burst_streams_equal_reference=[
                     bench["streams"][i] == refs[i] for i in range(nb)])
    del beng, eager, prefill, last_g, last_e
    print(f"{QWEN3_MOE} bench.serve: {bench['tok_per_s']:.1f} tok/s, decode "
          f"p50 {bench['decode_p50_ms']:.3f} ms, TTFT "
          f"{bench['ttft_ms']:.1f} ms, occupancy {bench['occupancy']:.3f}, "
          f"programs {bench['programs']} ({smi})", flush=True)
    out.update(serve_bench=bench, seconds=time.perf_counter() - t_start)
    emit(out)
    return 0


# phase 28: qwen3-0.6b's fleet (``chip_smoke.py --serve-cluster``)
CLUSTER_ARCH = "qwen3-0.6b"
# sub-run A: replica 1 killed at its engine step 12 (mid-decode of phase
# 8's requests); sub-run C: replica 0's ticks from its C_SLOW_AFTER-th of
# C on sleep C_SLEEP_S, ~6x a decode tick.  A's fleet flags a tick over 3x
# its replica's median and escalates on 5 in a row: a tick that admits
# requests runs their prefills too (one admission about doubles a decode
# tick), so only the slowed replica escalates
A_KILL_STEP, C_SLEEP_S, C_SLOW_AFTER = 12, 0.05, 6
# sub-run B: the burst that grows the fleet, the top-ups that keep
# replica 0's queue at B_QUEUE while the grow's loads run in the
# background (paced at B_LOAD_PACE_S a pass, which hands the loads the
# interpreter), and the trickle that leaves replica 1 idle until it
# shrinks
B_BURST, B_QUEUE, B_TOPUP_CAP, B_LOAD_PACE_S, B_MAX_NEW = 12, 2, 80, 0.2, 24


def fleet_window(boots, store):
    """What a sub-run is measured against: per engine booted so far, its
    programs' executions and decode-latency samples, and the store's
    counters.  Engines booted later count from zero."""
    from repro_torch.launch.serve import METRIC_DECODE_MS
    return {"engines": {id(b["engine"]): (
        {k: h.stats.executions for k, h in b["engine"].programs.items()},
        len(b["engine"].syscore.hostcalls.metrics.get(METRIC_DECODE_MS, [])))
        for b in boots},
        "n_boots": len(boots),
        "store": (store.hits, store.misses, store.puts)}


def fleet_expected(boots, window):
    """The kernel launches a sub-run must have counted: each program's
    captured launches times its replays since ``window``, plus one eager
    run (the warm-up before the capture) of every program of an engine
    booted inside it.  Also checks that every qwen3 program launches
    what its shapes give: K2 once a product and K1 once a layer an
    admission."""
    want = {}
    for b in boots:
        eng = b["engine"]
        exec0 = window["engines"].get(id(eng), (None, 0))[0]
        for key, h in eng.programs.items():
            prog = h.program
            n = h.stats.executions - (exec0[key] if exec0 else 0)
            n += exec0 is None
            for name, v in prog.launches.items():
                want[name] = want.get(name, 0) + v * n
    return want


def fleet_decode_ms(boots, window):
    from repro_torch.launch.serve import METRIC_DECODE_MS
    out = []
    for b in boots:
        ms = b["engine"].syscore.hostcalls.metrics.get(METRIC_DECODE_MS, [])
        out.extend(ms[window["engines"].get(id(b["engine"]), (None, 0))[1]:])
    return sorted(out)


def fleet_boot_checks(boots, start):
    """Point 2's warm rule (``repro_torch.bench.cluster.boot_checks``) for
    the boots from ``start`` on, with each boot's load, warm-up and
    capture seconds; raises on a boot that was not warm."""
    from repro_torch.bench.cluster import boot_checks
    rows = [boot_checks(b) for b in boots[start:]]
    cold = [r for r in rows if not r["warm"]]
    if cold:
        raise AssertionError(f"a boot was not warm: {cold[0]}")
    return rows


def fleet_record(torch, sup, boots, window, launches, routes, wall_s,
                 tokens, n_progs, smi, **extra):
    """One sub-run's checks and record: the kernel launches against the
    programs' (exact, every K1 call on the wgmma route), the store's hits
    (one a program a warm boot), no put and no miss."""
    want = fleet_expected(boots, window)
    got = {k: v for k, v in launches.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"launches {launches}, the programs' replays "
                             f"and warm-ups give {want}")
    if routes["flash_attention"]["wgmma"] != launches["flash_attention"]:
        raise AssertionError(f"K1 calls off the wgmma route: {routes}")
    warm_boots = len(boots) - window["n_boots"]
    h0, m0, p0 = window["store"]
    store = (sup.store.hits - h0, sup.store.misses - m0,
             sup.store.puts - p0)
    if store != (n_progs * warm_boots, 0, 0):
        raise AssertionError(f"store hits/misses/puts {store} over "
                             f"{warm_boots} warm boots")
    dec = fleet_decode_ms(boots, window)
    rec = dict(extra, launches=launches, launches_by_route=routes,
               expected_launches=want,
               boots=fleet_boot_checks(boots, window["n_boots"]),
               store_hits_misses_puts=store, wall_s=wall_s, tokens=tokens,
               tok_per_s=tokens / wall_s,
               decode_p50_ms=dec[len(dec) // 2] if dec else None,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               card=smi)
    return rec


def serve_cluster(store_dir=None):
    """Phase 28's body (``chip_smoke.py --serve-cluster [STORE_DIR]``,
    started by phase 28 in a fresh process, so that its replicas' graph
    pools go with it): qwen3-0.6b at full width in bf16 (batch 4, max_len
    512, prefill_len 256, weights from seed 0 drawn on the card), fleets
    of :class:`repro_torch.cluster.Supervisor` over one fresh
    ``ProgramStore`` that one cold boot exported: phase 23's qwen3 boot
    (``STORE_DIR``, a copy made before any other boot read it), or, run
    alone, a cold boot here.  Every fleet boot installs from it.

    A. two replicas, replica 1 killed mid-decode by a ``FaultInjector`` and
       rebooted warm; phase 8's 8 requests and ``bench.cluster``'s 12;
    C. A's fleet again, replica 0's ``fault_hook`` sleeping 50 ms a tick
       from its 6th tick of C on: the monitor escalates and the scale pass
       replaces it with a warm replica 2, which takes its unfinished
       requests;
    B. one replica, ``ScaleConfig(max_replicas=2, async_spawn=True,
       straggler_detection=False)``: a burst grows the fleet, the grow's
       store loads run on a background thread while replica 0 serves
       top-ups, the attach rebalances queued requests onto replica 1, then
       a trickle leaves it idle until it shrinks.

    Gates, each sub-run: every stream equals the batch-1
    ``reference_generate`` on the same weights; no request lost; the kill,
    the replacement, the grow and the shrink as scheduled; every fleet
    boot warm (every program from the store, no program function called,
    one store hit a program and no put, nothing exported); K1 and K2 launches equal the programs' captured launches
    times their replays plus one warm-up run of every program booted in
    the sub-run (B's background load included), every K1 call on the
    wgmma route.  Prints a JSON line per sub-run, then the record as the
    last line."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    sys.path.insert(0, SRC)
    from repro_torch.bench import cluster as cluster_bench
    from repro_torch.bench.boot import EntryPointCounter
    from repro_torch.core.program_store import ProgramStore
    from repro_torch.engine_config import (ClusterConfig, EngineConfig,
                                           ScaleConfig)
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import registry
    from repro_torch.runtime.fault import FaultInjector
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.library()
    cfg = registry.get_config(CLUSTER_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.padded_vocab) == \
        (28, 1024, 153_600), cfg
    ecfg = EngineConfig(reduced=False, batch=BATCH, max_len=MAX_LEN,
                        prefill_len=PREFILL_LEN, clock="step", seed=0,
                        device="cuda")
    # K2 once a product (7 a layer) and the tied head; K1 a layer an
    # admission
    per_pass = {"decode": {"matmul": 7 * cfg.n_layers + 1},
                "prefill_slot": {"matmul": 7 * cfg.n_layers + 1,
                                 "flash_attention": cfg.n_layers}}
    rng = np.random.default_rng(0)
    phase8 = [(rng.integers(1, cfg.vocab_size, size=p), MAX_NEW, a)
              for p, a in zip(PHASE8_PLENS, PHASE8_ARRIVALS)]
    bench12 = [(p, m, 0) for p, m in
               cluster_bench.workload(12, np.random.default_rng(0))]
    own_store = store_dir is None
    out, works = {"card": smi, "store_from": "phase 23's cold boot"}, {}
    if own_store:
        store_dir = tempfile.mkdtemp(prefix="repro_cluster_store_")
        t0 = time.perf_counter()
        cold = ServingEngine(CLUSTER_ARCH, ecfg,
                             store=ProgramStore(store_dir))
        torch.cuda.synchronize()
        out.update(store_from="a cold boot here", cold_boot={
            "boot_s": time.perf_counter() - t0,
            "export_s": sum(h.stats.export_s
                            for h in cold.programs.values())})
        del cold
        gc.collect()
        torch.cuda.empty_cache()
    slow = {"from": None}

    def degrade(step):
        # sub-run C: replica 0 turns straggler from its C_SLOW_AFTER-th
        # tick of C on
        if slow["from"] is not None and step >= slow["from"]:
            time.sleep(C_SLEEP_S)

    def served(sup, work, rids):
        lost = [r for r in rids if r not in sup.streams]
        if lost:
            raise AssertionError(f"requests lost: {lost}")
        works.setdefault("requests", []).extend(
            (p, m, sup.streams[r]) for (p, m, _), r in zip(work, rids))

    def emit_sub(name, rec):
        out[name] = rec
        brief = {k: v for k, v in rec.items()
                 if k not in ("boots", "expected_launches",
                              "launches_by_route", "events")}
        print(json.dumps({"sub_run": name, **brief}), flush=True)

    try:
        # -- A: two replicas, one killed and rebooted warm ------------------
        inj = FaultInjector(fail_at_steps=[A_KILL_STEP])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sup = cluster_bench.CountingSupervisor(
            CLUSTER_ARCH, ClusterConfig(
                engine=ecfg, replicas=2, health_interval=1,
                straggler_threshold=3.0, straggler_patience=5,
                scale=ScaleConfig(min_replicas=1, max_replicas=2,
                                  high_watermark=5.0, low_watermark=0.0,
                                  sustain_window=3, cooldown=0)),
            store=ProgramStore(store_dir),
            fault_hooks={0: degrade, 1: inj.check})
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        params = sup.params
        n_progs = len(sup.replicas[0].engine.programs)
        for b in sup.boots:
            for key, h in b["engine"].programs.items():
                if h.program.launches != per_pass[key]:
                    raise AssertionError(f"{key} captured "
                                         f"{h.program.launches}, its "
                                         f"shapes give {per_pass[key]}")
        if (sup.store.hits, sup.store.misses, sup.store.puts) != \
                (2 * n_progs, 0, 0):
            raise AssertionError(f"A's boot: store {sup.store.report()}")
        boots_a = fleet_boot_checks(sup.boots, 0)
        work = phase8 + bench12
        window = fleet_window(sup.boots, sup.store)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with EntryPointCounter() as calls:
            rids = [sup.submit(p, max_new=m, arrival_time=a)
                    for p, m, a in work]
            stats = sup.run()
        torch.cuda.synchronize()
        if inj.fired != [A_KILL_STEP] or stats["kills"] != 1 or \
                len(stats["recoveries"]) != 1 or not stats["completed_all"] \
                or [e["action"] for e in sup.scale_events]:
            raise AssertionError(f"A: {inj.fired} {stats}")
        if calls.calls:
            raise AssertionError(f"A called program functions {calls.calls}"
                                 f" times")
        served(sup, work, rids)
        rec = stats["recoveries"][0]
        emit_sub("A", fleet_record(
            torch, sup, sup.boots, window, ops.launch_counts(),
            ops.route_counts(), stats["wall_s"], stats["tokens"], n_progs,
            smi, boot_s=boot_s, fleet_boots=boots_a,
            requests=stats["requests"], kills=stats["kills"],
            replayed=rec["replayed"], reboot_s=rec["reboot_s"],
            downtime_s=rec["downtime_s"], recovery_load_s=rec["load_s"],
            recovery_capture_s=rec["compile_s"],
            ttft_p99_ms=stats["ttft_p99_ms"]))

        # -- C: replica 0 turns straggler and is replaced warm -------------
        window = fleet_window(sup.boots, sup.store)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        rng_c = np.random.default_rng(3)
        work = [(rng_c.integers(1, cfg.vocab_size, size=p), m, 0)
                for p, m in ((64, 48), (40, 8), (90, 8), (20, 8), (120, 8),
                             (33, 8))]
        slow["from"] = sup.replicas[0].engine.steps + C_SLOW_AFTER
        with EntryPointCounter() as calls:
            rids = [sup.submit(p, max_new=m, arrival_time=a)
                    for p, m, a in work]
            stats = sup.run()
        torch.cuda.synchronize()
        events = [e for e in sup.scale_events if e["action"] == "replace"]
        victim = sup.replicas[0]
        if (len(events) != 1 or events[0]["victim"] != 0
                or victim.state != "retired"
                or victim.retire_reason != "straggler-replaced"
                or not stats["completed_all"] or stats["kills"] != 1
                or victim.journal.unfinished()
                or sup.replicas[2].state != "running"):
            raise AssertionError(f"C: {sup.scale_events} {stats}")
        if calls.calls:
            raise AssertionError(f"C called program functions {calls.calls}"
                                 f" times")
        served(sup, work, rids)
        e = events[0]
        emit_sub("C", fleet_record(
            torch, sup, sup.boots, window, ops.launch_counts(),
            ops.route_counts(), stats["wall_s"], stats["tokens"], n_progs,
            smi, requests=stats["requests"], rerouted=stats["rerouted"],
            escalations=victim.monitor.escalations,
            straggler=victim.monitor.summary(),
            boot_s=e["boot_s"], load_s=e["load_s"], capture_s=e["compile_s"],
            attach_s=e["attach_s"], reason=e["reason"],
            ttft_p99_ms=stats["ttft_p99_ms"], events=sup.scale_events))
        sup.close()
        del sup, victim
        gc.collect()
        torch.cuda.empty_cache()

        # -- B: one replica grows under a burst, loads in the background ---
        scale = ScaleConfig(min_replicas=1, max_replicas=2,
                            high_watermark=0.75, low_watermark=0.15,
                            sustain_window=3, cooldown=8, async_spawn=True,
                            straggler_detection=False)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sup = cluster_bench.CountingSupervisor(
            CLUSTER_ARCH, ClusterConfig(engine=ecfg, replicas=1,
                                        scale=scale),
            params=params, store=ProgramStore(store_dir))
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        fleet_boot_checks(sup.boots, 0)
        window = fleet_window(sup.boots, sup.store)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        rng_b = np.random.default_rng(5)

        def request():
            return (rng_b.integers(1, cfg.vocab_size,
                                   size=int(rng_b.integers(16, 201))),
                    B_MAX_NEW, 0)

        work, rids = [], []

        def submit(n):
            for _ in range(n):
                work.append(request())
                rids.append(sup.submit(work[-1][0], max_new=B_MAX_NEW))
                if rids[-1] is None:
                    raise AssertionError("B: admission refused")

        ttft0, passes_loading, topups = len(sup._ttft_ms), 0, 0
        t0 = time.perf_counter()
        with EntryPointCounter() as calls:
            submit(B_BURST)
            # the burst raises the load past the high watermark; while
            # the grow's loads run on their thread, replica 0 serves and
            # keeps a queue for the attach to rebalance
            while len(sup.replicas) < 2:
                if sup.spawning:
                    passes_loading += 1
                    time.sleep(B_LOAD_PACE_S)
                    depth = sup.replicas[0].engine.snapshot()["queue_depth"]
                    if depth < B_QUEUE and topups < B_TOPUP_CAP:
                        submit(1)
                        topups += 1
                if not sup.run(max_ticks=1)["ticks"] and not sup.spawning:
                    raise AssertionError(f"B: no grow: {sup.scale_events}")
            sup.run()
            # a trickle: one request at a time leaves replica 1 idle
            for _ in range(12):
                if sup.replicas[1].state == "retired":
                    break
                submit(1)
                sup.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        actions = [e["action"] for e in sup.scale_events]
        grow = next(e for e in sup.scale_events if e["action"] == "grow")
        if (actions != ["grow", "shrink"] or sup.rebalanced < 1
                or sup.replicas[1].state != "retired"
                or passes_loading < 1
                or any(r.journal.unfinished() for r in sup.replicas)):
            raise AssertionError(f"B: events {sup.scale_events}, rebalanced "
                                 f"{sup.rebalanced}, passes while loading "
                                 f"{passes_loading}")
        if calls.calls:
            raise AssertionError(f"B called program functions {calls.calls}"
                                 f" times")
        served(sup, work, rids)
        ttft = sorted(sup._ttft_ms[ttft0:])
        tokens = sum(len(sup.streams[r]) for r in rids)
        emit_sub("B", fleet_record(
            torch, sup, sup.boots, window, ops.launch_counts(),
            ops.route_counts(), wall_s, tokens, n_progs, smi,
            boot_s=boot_s, requests=len(rids), topups=topups,
            passes_while_loading=passes_loading,
            rebalanced=sup.rebalanced, grow_boot_s=grow["boot_s"],
            grow_load_wall_s=grow["load_wall_s"],
            grow_attach_s=grow["attach_s"], grow_load_s=grow["load_s"],
            grow_capture_s=grow["compile_s"],
            ttft_p99_ms=ttft[min(len(ttft) - 1, int(0.99 * len(ttft)))],
            events=sup.scale_events))
        sup.close()
        del sup
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        if own_store:
            shutil.rmtree(store_dir, ignore_errors=True)

    # every stream against the batch-1 engine on the same weights
    ref = ServingEngine(CLUSTER_ARCH, ecfg.replace(batch=1), params=params)
    mism = []
    for p, m, got in works["requests"]:
        req = ref.submit(p, max_new=m)
        ref.run()
        ref.drain_completed()
        if req.generated != got:
            mism.append({"prompt_len": len(p), "fleet": got,
                         "reference": req.generated})
    if mism:
        raise AssertionError(f"{len(mism)} of {len(works['requests'])} "
                             f"streams differ from the batch-1 engine: "
                             f"{mism[0]}")
    out.update(streams_equal_reference=len(works["requests"]),
               seconds=time.perf_counter() - t_start)
    emit(out)
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "the port on the card only", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run the script "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as k1_mod
    from repro_torch.kernels import moe_dispatch as k3_mod
    from repro_torch.kernels import ssd_scan as k4_mod
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention import route as fa_route
    from repro_torch.kernels.matmul import matmul, matmul_ref, plan, route
    from repro_torch.kernels.moe_dispatch import moe_ffn, moe_ffn_ref
    from repro_torch.kernels.moe_dispatch import route as moe_route
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref

    dev = torch.device("cuda")
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    # -- 1. device -------------------------------------------------------
    with phase("device") as out:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out.update(nvidia_smi=smi, name=torch.cuda.get_device_name(0),
                   count=torch.cuda.device_count(),
                   cuda=torch.version.cuda, torch=torch.__version__,
                   python=sys.version.split()[0])
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        RECORD["device"] = dict(out)

    # -- 2. build --------------------------------------------------------
    with phase("build") as out:
        t0 = time.perf_counter()
        lib = _build.library()
        out.update(build_s=round(time.perf_counter() - t0, 3),
                   nvcc_s=_build.last_build_seconds(),
                   library=str(_build.BUILD_DIR / _build.LIB_NAME))
        # K2's kernels as ptxas built them (-Xptxas -v), and the tensor-core
        # instructions in their SASS: every bf16 kernel must hold HGMMA
        k2_build = []
        hgmma = sass_counts(_build.BUILD_DIR / _build.LIB_NAME, "HGMMA")
        for r in _build.ptxas_report("matmul"):
            wgmma = "wgmma" in r["function"]
            nt = 128 if "ILi128E" in r["function"] else 64
            r.update(route="bf16 wgmma" if wgmma else "fp32 CUDA cores",
                     dynamic_smem=lib.repro_matmul_smem_bytes(nt)
                     if wgmma else 0,
                     hgmma=hgmma.get(r["function"], 0))
            k2_build.append(r)
            print(f"K2 {r['route']}: {r['function']}: {r.get('registers')} "
                  f"registers, {r.get('static_smem')} B static + "
                  f"{r['dynamic_smem']} B dynamic shared memory, "
                  f"{r.get('spill_stores')} B spill stores, "
                  f"{r.get('spill_loads')} B spill loads, {r['hgmma']} HGMMA",
                  flush=True)
        wg = [r for r in k2_build if r["route"] == "bf16 wgmma"]
        if len(wg) != 4 or not all(r["hgmma"] > 0 for r in wg):
            raise AssertionError(f"K2's bf16 kernels without HGMMA in their "
                                 f"SASS: {k2_build}")
        out["k2_kernels"] = k2_build
        # K1's and K3's wgmma kernels: tensor cores in the SASS, no spills,
        # and the shared memory the CPU tests hold (wgmma_smem_bytes)
        def k1_smem(fn):
            d = 256 if "ILi256E" in fn else 128
            return (lib.repro_flash_attention_wgmma_smem(d),
                    k1_mod.wgmma_smem_bytes(d))

        def k3_smem(fn):
            gate_up, nt = "ILb1E" in fn, int(fn.split("ELi")[1].split("E")[0])
            return (lib.repro_moe_ffn_wgmma_smem(int(gate_up), nt),
                    k3_mod.wgmma_smem_bytes(gate_up, nt))

        def k4_smem(fn):
            n = 64 if "ILi64E" in fn else 128
            return (lib.repro_ssd_scan_wgmma_smem(n),
                    k4_mod.wgmma_smem_bytes(n))

        tc_build = {}
        for stem, name, smem in (("flash_attention", "K1", k1_smem),
                                 ("moe_ffn", "K3", k3_smem),
                                 ("ssd_scan", "K4", k4_smem)):
            rows = []
            for r in _build.ptxas_report(stem):
                if "wgmma" not in r["function"]:
                    continue
                dynamic, mirrored = smem(r["function"])
                if dynamic != mirrored:
                    raise AssertionError(f"{name}: {r['function']} takes "
                                         f"{dynamic} B of shared memory, the "
                                         f"wrapper's mirror says {mirrored}")
                r.update(route="bf16 wgmma", dynamic_smem=dynamic,
                         hgmma=hgmma.get(r["function"], 0))
                rows.append(r)
                print(f"{name} {r['route']}: {r['function']}: "
                      f"{r.get('registers')} registers, "
                      f"{r.get('static_smem')} B static + "
                      f"{r['dynamic_smem']} B dynamic shared memory, "
                      f"{r.get('spill_stores')} B spill stores, "
                      f"{r.get('spill_loads')} B spill loads, "
                      f"{r['hgmma']} HGMMA", flush=True)
            want = {"K1": 2, "K3": 10, "K4": 2}[name]
            if len(rows) != want or not all(
                    r["hgmma"] > 0 and r.get("spill_stores") == 0 and
                    r.get("spill_loads") == 0 for r in rows):
                raise AssertionError(f"{name}'s wgmma kernels: {want} "
                                     f"expected, each with HGMMA in its SASS "
                                     f"and no spills: {rows}")
            tc_build[name] = rows
        out["k1_kernels"], out["k3_kernels"] = tc_build["K1"], tc_build["K3"]
        out["k4_kernels"] = tc_build["K4"]
        # K5 runs on CUDA cores: its registers and spills, for the record
        out["k5_kernels"] = _build.ptxas_report("rglru_scan")
        for r in out["k5_kernels"]:
            print(f"K5 fp32 CUDA cores: {r['function']}: "
                  f"{r.get('registers')} registers, {r.get('static_smem')} B "
                  f"static shared memory, {r.get('spill_stores')} B spill "
                  f"stores, {r.get('spill_loads')} B spill loads", flush=True)

    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    # -- 3. K2 matmul ----------------------------------------------------
    from repro_torch.models import registry
    full = registry.get_config("qwen3-0.6b")
    n_layers, d_model = full.n_layers, full.d_model
    vocab = full.padded_vocab
    heads, kv_heads, hd = full.n_heads, full.n_kv_heads, full.resolved_head_dim

    def dense_layer(c):
        """(K, N) of a dense layer's products and how many of each: wq;
        wk, wv; wo; gate, up; down."""
        hd = c.resolved_head_dim
        return [((c.d_model, c.n_heads * hd), 1),
                ((c.d_model, c.n_kv_heads * hd), 2),
                ((c.n_heads * hd, c.d_model), 1), ((c.d_model, c.d_ff), 2),
                ((c.d_ff, c.d_model), 1)]

    # qwen3's tied head is (d_model, padded vocab)
    per_layer = dense_layer(full)
    per_step = n_layers * sum(c for _, c in per_layer) + 1
    # olmoe-1b-7b: wq, wk, wv (MHA) and wo of (d, d), the router (d, E);
    # the expert FFN is K3's; the untied head is a row-major (d, vocab)
    moe = registry.get_config("olmoe-1b-7b")
    moe_d, moe_hd = moe.d_model, moe.resolved_head_dim
    moe_vocab = moe.padded_vocab
    moe_layer = [((moe_d, moe.n_heads * moe_hd), 1),
                 ((moe_d, moe.n_kv_heads * moe_hd), 2),
                 ((moe.n_heads * moe_hd, moe_d), 1),
                 ((moe_d, moe.n_experts), 1)]
    moe_per_step = moe.n_layers * sum(c for _, c in moe_layer) + 1
    # mamba2-130m: w_in (d, 2 d_inner + 2 N + H) and w_out (d_inner, d);
    # the scan is K4's; the untied head is a row-major (d, vocab)
    ssm = registry.get_config("mamba2-130m")
    ssm_d, ssm_vocab = ssm.d_model, ssm.padded_vocab
    ssm_inner = ssm.ssm_expand * ssm_d
    ssm_heads = ssm_inner // ssm.ssm_head_dim
    ssm_layer = [((ssm_d, 2 * ssm_inner + 2 * ssm.ssm_state + ssm_heads), 1),
                 ((ssm_inner, ssm_d), 1)]
    ssm_per_step = ssm.n_layers * sum(c for _, c in ssm_layer) + 1
    # recurrentgemma-2b: each "R" layer's w_x, w_gate (d, lru) and w_out
    # (lru, d), each "L" layer's wq (d, H hd), wk, wv (d, hd) and wo; the
    # MLP of every layer; the tied head is (d_model, padded vocab)
    rg = registry.get_config("recurrentgemma-2b")
    rg_d, rg_lru, rg_ff, rg_vocab = (rg.d_model, rg.lru_width, rg.d_ff,
                                     rg.padded_vocab)
    rg_hd, rg_h, rg_kv = rg.resolved_head_dim, rg.n_heads, rg.n_kv_heads
    rg_kinds = rg.pattern_for_layers()
    rg_r, rg_l = rg_kinds.count("R"), rg_kinds.count("L")
    rg_mlp = [((rg_d, rg_ff), 2), ((rg_ff, rg_d), 1)]
    rg_r_layer = [((rg_d, rg_lru), 2), ((rg_lru, rg_d), 1)] + rg_mlp
    rg_l_layer = [((rg_d, rg_h * rg_hd), 1), ((rg_d, rg_kv * rg_hd), 2),
                  ((rg_h * rg_hd, rg_d), 1)] + rg_mlp
    # one pass as (K, N) with the count over all 26 layers
    rg_pass = [(kn, c * rg_r) for kn, c in rg_r_layer] + \
        [(kn, c * rg_l) for kn, c in rg_l_layer]
    rg_per_step = sum(c for _, c in rg_pass) + 1
    # the dense and vision-backbone configs of phases 18-21: each layer's
    # 7 products and one head, tied (the (V, d) table read in place as
    # embed.t()) or untied (internvl2's (d, V) lm_head)
    new_cfgs = {a: registry.get_config(a) for a in (
        "llama3.2-3b", "gemma3-4b", "gemma3-12b", "internvl2-26b")}
    new_layers = {a: dense_layer(c) for a, c in new_cfgs.items()}
    # {kernel: (per decode step, per admission)}: K2 7 L + 1, K1 L
    new_passes = {a: {"matmul": (7 * c.n_layers + 1,) * 2,
                      "flash_attention": (0, c.n_layers), "moe_ffn": (0, 0),
                      "ssd_scan": (0, 0), "rglru_scan": (0, 0)}
                  for a, c in new_cfgs.items()}
    # seamless-m4t-medium (phase 22): an encoder layer runs a dense layer's
    # 7 products; a decoder layer's prefill adds the cross wq, wk, wv and
    # wo (11), its decode step the cross wq and wo alone (9: the cross K/V
    # are cached); one untied head (d, padded vocab).  K1 runs 3 calls a
    # layer pair at a prefill (encoder, decoder self, cross), none a step
    sm = registry.get_config("seamless-m4t-medium")
    # phase 22's workload: 500 frames and 13 prompt tokens are ragged
    # against K1's 16- and 32-row SIMT tiles; 48 new tokens fill the 64
    # self-cache slots to 60
    SM_ENC, SM_PROMPT, SM_NEW, SM_DEC_LEN = 500, 13, 48, 64
    sm_hd = sm.resolved_head_dim
    sm_q = (sm.d_model, sm.n_heads * sm_hd)
    sm_o = (sm.n_heads * sm_hd, sm.d_model)
    new_layers["seamless-m4t-medium"] = dense_layer(sm)
    sm_step_layer = dense_layer(sm) + [(sm_q, 1), (sm_o, 1)]
    sm_passes = {
        "matmul": (9 * sm.n_layers + 1,
                   7 * sm.n_enc_layers + 11 * sm.n_layers + 1),
        "flash_attention": (0, sm.n_enc_layers + 2 * sm.n_layers),
        "moe_ffn": (0, 0), "ssd_scan": (0, 0), "rglru_scan": (0, 0)}
    # (K, N, head kind) per M: qwen3's at four batch sizes, olmoe's,
    # mamba2's and recurrentgemma's at the two their paths run (decode
    # batch, one admission)
    cases = []
    for m in (BATCH, 1, PREFILL_LEN, 37):
        cases += [(m, k, n, None) for k, n in sorted({kn for kn, _ in
                                                      per_layer})]
        cases.append((m, d_model, vocab, "tied"))
    for m in (BATCH, PREFILL_LEN):
        for layer, d, v in ((moe_layer, moe_d, moe_vocab),
                            (ssm_layer, ssm_d, ssm_vocab)):
            cases += [(m, k, n, None) for k, n in sorted({kn for kn, _ in
                                                          layer})]
            cases.append((m, d, v, "untied"))
        cases += [(m, k, n, None) for k, n in sorted({kn for kn, _ in
                                                      rg_pass})]
        cases.append((m, rg_d, rg_vocab, "tied"))
    cgen = torch.Generator(device=dev).manual_seed(0)

    def crandn(shape, dtype, scale=1.0):
        """Drawn on the card: the olmoe expert stacks are 0.4-1.6 GB, the
        recurrentgemma head table 1.3-2.6 GB."""
        return (torch.randn(shape, generator=cgen, device=dev)
                * scale).to(dtype)

    mm = {}
    with phase("matmul") as out:
        checks = []
        table = {name: randn((vocab, d_model), dt, 0.02)
                 for name, dt in dtypes.items()}
        # the (V, d) tables of the tied heads, by dtype and d_model
        tables = {(name, d_model): t for name, t in table.items()}
        for dname, dt in dtypes.items():
            tol = MATMUL_TOL[dname]
            for m, k, n, head in cases:
                # outputs of unit scale against the tolerance: a head's
                # input is a final-norm output (unit scale) and its table
                # is drawn at 0.02; the projections' weights are unit normal
                x = randn((m, k), dt, 1.0 / math.sqrt(k) if head is None
                          else 1.0)
                if head == "tied":
                    if (dname, k) not in tables:
                        tables[(dname, k)] = crandn((n, k), dt, 0.02)
                    w = tables[(dname, k)].t()
                else:
                    w = randn((k, n), dt, 1.0 if head is None else 0.02)
                got = matmul(x, w)
                want = matmul_ref(x, w)
                torch.cuda.synchronize()
                viol, err = max_violation(got, want, tol)
                if viol > 0:
                    raise AssertionError(
                        f"matmul {dname} M={m} K={k} N={n}: max err "
                        f"{err} exceeds tol {tol}")
                # rotate weight copies past the 50 MB L2 so each call
                # streams its weights from memory, as a decode step does
                nbytes_w = k * n * x.element_size()
                copies = [w] + [w.clone() for _ in range(
                    min(63, (128 << 20) // nbytes_w))] if head is None \
                    else [w]
                it = {"i": 0}

                def nxt():
                    it["i"] += 1
                    return copies[it["i"] % len(copies)]

                ms = cuda_ms(torch, lambda: matmul(x, nxt()))
                plain = cuda_ms(torch, lambda: matmul_ref(x, nxt()))
                lib = cuda_ms(torch, lambda: torch.matmul(x, nxt()))
                k2_host = host_us(torch, lambda: matmul(x, w))
                lib_host = host_us(torch, lambda: torch.matmul(x, w))
                del copies, w
                b_ms, b_by = bound_ms(
                    (m * k + k * n + m * n) * x.element_size(),
                    2 * m * n * k, dname)
                p = plan(k, n, dt)
                x_rows, split = route(p, m, n) if dt == torch.bfloat16 \
                    else (64, False)
                row = {"dtype": dname, "M": m, "K": k, "N": n,
                       "head": head, "max_abs_err": err,
                       "tol": tol, "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": b_ms,
                       "bound_by": b_by, "bound_share": b_ms / ms,
                       "host_us": k2_host, "library_host_us": lib_host,
                       "S": p.segments, "bounds": list(p.bounds),
                       "tile_n": p.tile_n, "tile_k": p.tile_k,
                       "x_rows": x_rows, "split": split}
                checks.append(row)
                mm[(dname, m, k, n)] = row
        # bits: rows of a bf16 product at M in {1, 2, 4, 8} must equal the
        # same rows computed alone, at every served (K, N), heads included;
        # M = 37 and 256 are reported
        bits = []
        for k, n, head in sorted({(k, n, head) for _, k, n, head in cases},
                                 key=str):
            x = randn((256, k), torch.bfloat16,
                      1.0 / math.sqrt(k) if head is None else 1.0)
            if head == "tied":
                w = tables.get(("bfloat16", k))
                if w is None:
                    w = tables[("bfloat16", k)] = crandn((n, k),
                                                         torch.bfloat16, 0.02)
                w = w.t()
            else:
                w = randn((k, n), torch.bfloat16,
                          1.0 if head is None else 0.02)
            alone = torch.cat([matmul(x[i:i + 1], w) for i in range(256)])
            row = {"K": k, "N": n, "head": head,
                   "S": plan(k, n, torch.bfloat16).segments}
            for m in (1, 2, 4, 8, 37, 256):
                got = matmul(x[:m], w)
                row[f"rows_differing_M{m}"] = int(
                    (got != alone[:m]).any(dim=1).sum())
            bits.append(row)
            del w, x, alone
        del table, tables
        # phases 18-22's configs at full width, bf16: every served (K, N)
        # against the plain version at a decode batch and an admission,
        # timed there (kernel, plain, torch.matmul as the yardstick; the
        # layers' weights rotated past the L2, a head, itself larger than
        # the L2, timed as it comes: cold), and the rows of a product at M
        # in {1, 2, 4, 8} bit-equal to the rows computed alone (37 and 256
        # reported).  seamless's prefill runs its products at two more M:
        # the encoder's and the cross K/V's at B x S_enc (2,000, where
        # route() takes 128-row x tiles with a ragged last one) and the
        # decoder's and the head at B x S_dec (52)
        tol = MATMUL_TOL["bfloat16"]
        new_checks = []
        for arch, c in {**new_cfgs, "seamless-m4t-medium": sm}.items():
            head_kn = (c.d_model, c.padded_vocab)
            kns = sorted({kn for kn, _ in new_layers[arch]})
            ms = {kn: [BATCH, PREFILL_LEN] for kn in kns + [head_kn]}
            if arch == "seamless-m4t-medium":
                for kn in kns:
                    # its (1024, 1024) at BATCH and PREFILL_LEN is
                    # qwen3's, checked, timed and bit-checked above
                    if ("bfloat16", BATCH, *kn) in mm:
                        ms[kn] = []
                    ms[kn] += [BATCH * SM_PROMPT, BATCH * SM_ENC]
                ms[head_kn].append(BATCH * SM_PROMPT)
            for k, n in kns + [head_kn]:
                head = None if (k, n) != head_kn else \
                    "tied" if c.tie_embeddings else "untied"
                w = (crandn((n, k), torch.bfloat16, 0.02).t()
                     if head == "tied" else
                     crandn((k, n), torch.bfloat16,
                            1.0 if head is None else 0.02))
                xs = crandn((max(ms[(k, n)] + [PREFILL_LEN]), k),
                            torch.bfloat16,
                            1.0 / math.sqrt(k) if head is None else 1.0)
                nbytes_w = k * n * 2
                copies = [w] + [w.clone() for _ in range(
                    min(63, (128 << 20) // nbytes_w))] if head is None \
                    else [w]
                it = {"i": 0}

                def nxt():
                    it["i"] += 1
                    return copies[it["i"] % len(copies)]

                for m in ms[(k, n)]:
                    x = xs[:m]
                    viol, err = max_violation(matmul(x, w),
                                              matmul_ref(x, w), tol)
                    if viol > 0:
                        raise AssertionError(
                            f"matmul {arch} bf16 M={m} K={k} N={n}: max "
                            f"err {err} exceeds tol {tol}")
                    b_ms, b_by = bound_ms((m * k + k * n + m * n) * 2,
                                          2 * m * n * k, "bfloat16")
                    row = {"arch": arch, "dtype": "bfloat16", "M": m,
                           "K": k, "N": n, "head": head,
                           "max_abs_err": err, "tol": tol,
                           "ms": cuda_ms(torch, lambda: matmul(x, nxt())),
                           "plain_ms": cuda_ms(
                               torch, lambda: matmul_ref(x, nxt())),
                           "library_ms": cuda_ms(
                               torch, lambda: torch.matmul(x, nxt())),
                           "bound_ms": b_ms, "bound_by": b_by,
                           "host_us": host_us(torch, lambda: matmul(x, w)),
                           "library_host_us": host_us(
                               torch, lambda: torch.matmul(x, w)),
                           "S": plan(k, n, torch.bfloat16).segments}
                    row["x_rows"], row["split"] = route(
                        plan(k, n, torch.bfloat16), m, n)
                    row["bound_share"] = b_ms / row["ms"]
                    new_checks.append(row)
                    mm[("bfloat16", m, k, n)] = row
                if BATCH not in ms[(k, n)]:
                    del w, xs, x, copies
                    continue
                alone = torch.cat([matmul(xs[i:i + 1], w)
                                   for i in range(PREFILL_LEN)])
                row = {"arch": arch, "K": k, "N": n, "head": head,
                       "S": plan(k, n, torch.bfloat16).segments}
                for m in (1, 2, 4, 8, 37, 256):
                    got = matmul(xs[:m], w)
                    row[f"rows_differing_M{m}"] = int(
                        (got != alone[:m]).any(dim=1).sum())
                bits.append(row)
                del w, xs, x, alone, copies, got
        checks += new_checks
        out["bits"] = bits
        small_m_differ = [r for r in bits if any(
            r[f"rows_differing_M{m}"] for m in (1, 2, 4, 8))]
        if small_m_differ:
            raise AssertionError(f"K2 rows at M <= 8 differ from the rows "
                                 f"computed alone: {small_m_differ}")
        out["detail"] = checks
        out["checks"] = len(checks)
        out["max_abs_err"] = max(c["max_abs_err"] for c in checks)
        out["bits_equal_M_le_8"] = True
        out["bits_equal_M37"] = not any(r["rows_differing_M37"] for r in bits)
        out["bits_equal_M256"] = not any(r["rows_differing_M256"]
                                         for r in bits)
        for c in checks:
            emit({"matmul": {key: (round(v, 5) if isinstance(v, float)
                                   else v) for key, v in c.items()}})
        for r in bits:
            emit({"matmul_bits": r})
    matmul_err = out["max_abs_err"]
    matmul_bits = {key: out[key] for key in ("bits_equal_M_le_8",
                                             "bits_equal_M37",
                                             "bits_equal_M256")}
    matmul_build = RECORD["phases"][1]["k2_kernels"]
    k1_build = RECORD["phases"][1]["k1_kernels"]
    k3_build = RECORD["phases"][1]["k3_kernels"]
    k4_build = RECORD["phases"][1]["k4_kernels"]
    k5_build = RECORD["phases"][1]["k5_kernels"]

    def k2_aggregate(dname, m, layer_products, layers, head):
        """K2 numbers for one serving pass at batch rows ``m``: each
        layer's products, ``layers`` times, plus the head's (K, N).  (A
        pass with layers of two kinds gives its products counted over the
        whole depth and ``layers`` 1.)"""
        agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "host_us": 0.0, "library_host_us": 0.0}
        nbytes = flops = 0
        for (k, n), c in layer_products + [(head, None)]:
            times = layers * c if c is not None else 1
            row = mm[(dname, m, k, n)]
            for key in agg:
                agg[key] += times * row[key]
            nbytes += times * (m * k + k * n + m * n) * 2
            flops += times * 2 * m * n * k
        agg["bound_ms"], agg["bound_by"] = bound_ms(nbytes, flops, dname)
        agg["bound_share"] = agg["bound_ms"] / agg["ms"]
        # what the host spends queueing the pass's products
        agg["host_ms"] = agg.pop("host_us") / 1e3
        agg["library_host_ms"] = agg.pop("library_host_us") / 1e3
        agg["library_factor"] = agg["ms"] / agg["library_ms"]
        return agg

    # -- 4. K1 flash attention -------------------------------------------
    fa = {}
    with phase("flash_attention") as out:
        checks = []
        cases = []
        for h, kv, d in ((heads, kv_heads, hd),
                         (moe.n_heads, moe.n_kv_heads, moe_hd), (4, 2, 16)):
            for causal, window in ((True, 0), (True, 64)):
                for sq, sk in ((PREFILL_LEN, PREFILL_LEN), (200, 200),
                               (37, PREFILL_LEN)):
                    cases.append((h, kv, d, causal, window, sq, sk))
        # recurrentgemma's "L" layers: MQA, 10 heads over 1 of 256, its
        # window of 2048 (no effect at S 256) and one of 64 that bites
        rg_fa = [(rg_h, rg_kv, rg_hd, True, window, sq, sk)
                 for window in (rg.local_window, 64)
                 for sq, sk in ((PREFILL_LEN, PREFILL_LEN), (200, 200),
                                (37, PREFILL_LEN))]
        cases += rg_fa
        for dname, dt in dtypes.items():
            tol = FLASH_TOL[dname]
            for h, kv, d, causal, window, sq, sk in cases:
                b = 2
                q = randn((b * h, sq, d), dt)
                k = randn((b * kv, sk, d), dt)
                v = randn((b * kv, sk, d), dt)
                before = dict(flash_attention.launches_by_route)
                got = flash_attention(q, k, v, causal=causal, window=window)
                took = [r for r, n in flash_attention.launches_by_route
                        .items() if n != before[r]]
                want = flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
                torch.cuda.synchronize()
                viol, err = max_violation(got, want, tol)
                if viol > 0:
                    raise AssertionError(
                        f"flash_attention {dname} H={h}/{kv} D={d} "
                        f"causal={causal} window={window} Sq={sq} Sk={sk}: "
                        f"max err {err} exceeds tol {tol}")
                row = {"dtype": dname, "B": b, "H": h, "Hk": kv, "D": d,
                       "causal": causal, "window": window, "Sq": sq,
                       "Sk": sk, "route": took, "max_abs_err": err,
                       "tol": tol}
                if took != [fa_route(dt, d)]:
                    raise AssertionError(f"flash_attention took {took}: {row}")
                if dt == torch.bfloat16:
                    # bits: batch element 0's heads alone equal the same
                    # heads inside the batch-2 call
                    one = flash_attention(q[:h], k[:kv], v[:kv],
                                          causal=causal, window=window)
                    row["bits_equal_B1_B2"] = torch.equal(one, got[:h])
                    if not row["bits_equal_B1_B2"]:
                        raise AssertionError(f"flash_attention heads at "
                                             f"batch 1 differ from batch 2: "
                                             f"{row}")
                checks.append(row)
        # q_start: the queries from a start on the device (a warm prefix
        # admission's suffix over its slot's gathered row, Sk = MAX_LEN),
        # on both routes, each case against the plain version with the
        # same start
        qs_cases = [(heads, kv_heads, hd, "bfloat16"),
                    (rg_h, rg_kv, rg_hd, "bfloat16"),
                    (heads, kv_heads, hd, "float32")]
        qs_checks = []
        sk = MAX_LEN
        for h, kv, d, dname in qs_cases:
            dt, tol = dtypes[dname], FLASH_TOL[dname]
            for sq in (1, 7, 16):
                for window in (0, 64):
                    for start in (200, 0, sk - sq):
                        q = randn((h, sq, d), dt)
                        k = randn((kv, sk, d), dt)
                        v = randn((kv, sk, d), dt)
                        st = torch.tensor([start], dtype=torch.int32,
                                          device=dev)
                        before = dict(flash_attention.launches_by_route)
                        got = flash_attention(q, k, v, window=window,
                                              q_start=st)
                        took = [r for r, n in flash_attention
                                .launches_by_route.items() if n != before[r]]
                        want = flash_attention_ref(q, k, v, window=window,
                                                   q_start=st)
                        torch.cuda.synchronize()
                        viol, err = max_violation(got, want, tol)
                        row = {"dtype": dname, "H": h, "Hk": kv, "D": d,
                               "window": window, "Sq": sq, "Sk": sk,
                               "q_start": start, "route": took,
                               "max_abs_err": err, "tol": tol}
                        if viol > 0 or took != [fa_route(dt, d)]:
                            raise AssertionError(f"flash_attention with "
                                                 f"q_start: {row}")
                        qs_checks.append(row)
        # the design's proof: the rows of a warm call (Sq 16 from q_start
        # 200 over 512 keys, the first 216 the cold call's, the rest other
        # finite values) equal the same rows of the cold call (Sq = Sk =
        # 216, right-aligned) bit for bit, on both routes
        warm_cold = []
        for h, kv, d, dname in qs_cases:
            dt = dtypes[dname]
            start, sq, cold_s = 200, 16, 216
            for window in (0, 64):
                q = randn((h, cold_s, d), dt)
                k = randn((kv, cold_s, d), dt)
                v = randn((kv, cold_s, d), dt)
                k_warm = torch.cat([k, randn((kv, sk - cold_s, d), dt)], 1)
                v_warm = torch.cat([v, randn((kv, sk - cold_s, d), dt)], 1)
                cold = flash_attention(q, k, v, window=window)
                warm = flash_attention(
                    q[:, start:].contiguous(), k_warm, v_warm, window=window,
                    q_start=torch.tensor([start], dtype=torch.int32,
                                         device=dev))
                row = {"dtype": dname, "H": h, "Hk": kv, "D": d,
                       "window": window, "q_start": start, "Sq": sq,
                       "Sk": sk, "cold_S": cold_s,
                       "route": fa_route(dt, d),
                       "bit_equal": torch.equal(cold[:, start:], warm)}
                if not row["bit_equal"]:
                    raise AssertionError(f"flash_attention: warm rows differ "
                                         f"from the cold call's: {row}")
                warm_cold.append(row)
        # times at the warm shapes: phase 16's (one suffix token at 256
        # over max_len 320) and the proof's (16 rows from 200 over 512),
        # SDPA given the same boolean mask as the yardstick; the bound
        # counts the keys the causal rows need
        for key, sq, sk_w, start in (("warm_bench", 1, 320, 256),
                                     ("warm", 16, MAX_LEN, 200)):
            q = randn((heads, sq, hd), torch.bfloat16)
            k = randn((kv_heads, sk_w, hd), torch.bfloat16)
            v = randn((kv_heads, sk_w, hd), torch.bfloat16)
            st = torch.tensor([start], dtype=torch.int32, device=dev)
            q_pos = torch.arange(sq, device=dev)[:, None] + start
            mask = q_pos >= torch.arange(sk_w, device=dev)[None, :]
            qs = q[None]
            ks = k.repeat_interleave(heads // kv_heads, 0)[None]
            vs = v.repeat_interleave(heads // kv_heads, 0)[None]
            ms = cuda_ms(torch, lambda: flash_attention(q, k, v, q_start=st),
                         iters=50)
            plain = cuda_ms(torch, lambda: flash_attention_ref(
                q, k, v, q_start=st), iters=50)
            lib = cuda_ms(torch, lambda: torch.nn.functional
                          .scaled_dot_product_attention(qs, ks, vs,
                                                        attn_mask=mask),
                          iters=50)
            needed = min(sk_w, start + sq)
            b_ms, b_by = bound_ms((2 * heads * sq + 2 * kv_heads * needed)
                                  * hd * 2,
                                  4 * hd * int(mask.sum()) * heads,
                                  "bfloat16")
            fa[key] = {"dtype": "bfloat16", "H": heads, "Hk": kv_heads,
                       "D": hd, "Sq": sq, "Sk": sk_w, "q_start": start,
                       "route": fa_route(torch.bfloat16, hd), "ms": ms,
                       "plain_ms": plain, "library_ms": lib,
                       "bound_ms": b_ms, "bound_by": b_by}
        # times at the paths' shapes: one layer's prefill of one admission
        # (bf16 and f32 for qwen3, bf16 for olmoe)
        d, s = hd, PREFILL_LEN
        for key, dname, heads_, kv in (
                ("bfloat16", "bfloat16", heads, kv_heads),
                ("float32", "float32", heads, kv_heads),
                ("olmoe", "bfloat16", moe.n_heads, moe.n_kv_heads)):
            dt = dtypes[dname]
            q = randn((heads_, s, d), dt)
            k = randn((kv, s, d), dt)
            v = randn((kv, s, d), dt)
            qs = q.reshape(1, heads_, s, d)
            ks = k.repeat_interleave(heads_ // kv, 0).reshape(1, heads_, s, d)
            vs = v.repeat_interleave(heads_ // kv, 0).reshape(1, heads_, s, d)
            ms = cuda_ms(torch, lambda: flash_attention(q, k, v), iters=50)
            plain = cuda_ms(torch, lambda: flash_attention_ref(q, k, v),
                            iters=50)
            lib = cuda_ms(torch, lambda: torch.nn.functional
                          .scaled_dot_product_attention(qs, ks, vs,
                                                        is_causal=True),
                          iters=50)
            pairs = s * (s + 1) // 2
            b_ms, b_by = bound_ms((2 * heads_ + 2 * kv) * s * d
                                  * q.element_size(),
                                  4 * d * pairs * heads_, dname)
            fa[key] = {"dtype": dname, "H": heads_, "Hk": kv, "D": d,
                       "S": s, "causal": True, "route": fa_route(dt, d),
                       "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": b_ms,
                       "bound_by": b_by}
        # every head-dim-256 case timed at one admission's batch of 1,
        # SDPA given the same boolean mask as the yardstick
        fa_rg = []
        for dname, dt in dtypes.items():
            for h, kv, d, _, window, sq, sk in rg_fa:
                q = randn((h, sq, d), dt)
                k = randn((kv, sk, d), dt)
                v = randn((kv, sk, d), dt)
                q_pos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
                k_pos = torch.arange(sk, device=dev)[None, :]
                mask = (q_pos >= k_pos) & (q_pos - k_pos < window)
                qs = q[None]
                ks = k.repeat_interleave(h // kv, 0)[None]
                vs = v.repeat_interleave(h // kv, 0)[None]
                ms = cuda_ms(torch, lambda: flash_attention(
                    q, k, v, window=window), iters=20)
                plain = cuda_ms(torch, lambda: flash_attention_ref(
                    q, k, v, window=window), iters=20)
                lib = cuda_ms(torch, lambda: torch.nn.functional
                              .scaled_dot_product_attention(
                                  qs, ks, vs, attn_mask=mask), iters=20)
                pairs = int(mask.sum())
                b_ms, b_by = bound_ms((2 * h * sq + 2 * kv * sk) * d
                                      * q.element_size(),
                                      4 * d * pairs * h, dname)
                fa_rg.append({"dtype": dname, "H": h, "Hk": kv, "D": d,
                              "causal": True, "window": window, "Sq": sq,
                              "Sk": sk, "route": fa_route(dt, d), "ms": ms,
                              "plain_ms": plain,
                              "library_ms": lib, "bound_ms": b_ms,
                              "bound_by": b_by})
        # the path's shape: S 256 under the window of 2048
        for row in fa_rg:
            if row["window"] == rg.local_window and \
                    row["Sq"] == row["Sk"] == PREFILL_LEN:
                key = "recurrentgemma" + \
                    ("" if row["dtype"] == "bfloat16" else "_float32")
                fa[key] = row
        # phases 18-21's head layouts, bf16 (the wgmma route): llama's 24
        # heads over 8 (G 3) and internvl2's 48 over 8 (G 6) at D 128,
        # gemma3-4b's 8 over 4 and gemma3-12b's 16 over 8 at D 256 (G 2)
        # with the "L" layers' window of 1024 and the "G" layers' none; S
        # 256 (an admission), 512 (internvl2's patch prefill reaches 456)
        # and, for gemma3-4b, 1024 (phase 19's ring engine).  Each against
        # the plain version at B 2, batch 1's heads bit-equal to the batch
        # 2 call's, then timed at B 1 beside causal SDPA (the window does
        # not bite at S <= 1024) and the bound
        # and qwen3-moe-30b-a3b's 32 heads over 4 (G 8) at D 128 (phase 26)
        fa_new = []
        for arch, c in {**new_cfgs,
                        QWEN3_MOE: registry.get_config(QWEN3_MOE)}.items():
            h, kv, d = c.n_heads, c.n_kv_heads, c.resolved_head_dim
            windows = sorted({c.local_window if k_ == "L" else 0
                              for k_ in c.pattern_for_layers()})
            lens = (PREFILL_LEN, MAX_LEN) + \
                ((1024,) if arch == "gemma3-4b" else ())
            for window in windows:
                for s_ in lens:
                    q = randn((2 * h, s_, d), torch.bfloat16)
                    k = randn((2 * kv, s_, d), torch.bfloat16)
                    v = randn((2 * kv, s_, d), torch.bfloat16)
                    before = dict(flash_attention.launches_by_route)
                    got = flash_attention(q, k, v, window=window)
                    took = [r for r, n in flash_attention.launches_by_route
                            .items() if n != before[r]]
                    want = flash_attention_ref(q, k, v, window=window)
                    torch.cuda.synchronize()
                    viol, err = max_violation(got, want,
                                              FLASH_TOL["bfloat16"])
                    one = flash_attention(q[:h].contiguous(),
                                          k[:kv].contiguous(),
                                          v[:kv].contiguous(), window=window)
                    row = {"arch": arch, "dtype": "bfloat16", "H": h,
                           "Hk": kv, "G": h // kv, "D": d, "causal": True,
                           "window": window, "Sq": s_, "Sk": s_,
                           "route": took, "max_abs_err": err,
                           "tol": FLASH_TOL["bfloat16"],
                           "bits_equal_B1_B2": torch.equal(one, got[:h])}
                    if viol > 0 or took != ["wgmma"] or \
                            not row["bits_equal_B1_B2"]:
                        raise AssertionError(f"flash_attention at a new "
                                             f"layout: {row}")
                    q1, k1, v1 = q[:h], k[:kv], v[:kv]
                    qs = q1[None]
                    ks = k1.repeat_interleave(h // kv, 0)[None]
                    vs = v1.repeat_interleave(h // kv, 0)[None]
                    pairs = s_ * (s_ + 1) // 2
                    b_ms, b_by = bound_ms((2 * h + 2 * kv) * s_ * d * 2,
                                          4 * d * pairs * h, "bfloat16")
                    row.update(
                        ms=cuda_ms(torch, lambda: flash_attention(
                            q1, k1, v1, window=window), iters=20),
                        plain_ms=cuda_ms(torch, lambda: flash_attention_ref(
                            q1, k1, v1, window=window), iters=20),
                        library_ms=cuda_ms(
                            torch, lambda: torch.nn.functional
                            .scaled_dot_product_attention(
                                qs, ks, vs, is_causal=True), iters=20),
                        bound_ms=b_ms, bound_by=b_by)
                    fa_new.append(row)
                    if s_ == PREFILL_LEN and window == windows[-1]:
                        fa[arch] = row
            checks += [r for r in fa_new if r["arch"] == arch]
        # seamless-m4t-medium's layouts (phase 22), MHA 16 heads over 16:
        # at its D 64 in bf16 and f32 (the SIMT route) the encoder's
        # bidirectional self-attention (S 500), the decoder's cross-
        # attention (13 queries over 500 keys) and its causal self-
        # attention (13), then causal=False with more queries than keys
        # (600 over 512); the same causal=False cases at D 128 (bf16: the
        # wgmma route).  Each against the plain version at B 2, its route
        # named, a bf16 case's batch-1 heads bit-equal to the batch-2
        # call's; then the D 64 layouts in bf16 timed at phase 22's batch
        # beside SDPA (is_causal for the causal self-attention alone) and
        # the bound
        sm_h, sm_kv = sm.n_heads, sm.n_kv_heads
        sm_layouts = [(sm_hd, False, 500, 500), (sm_hd, False, 13, 500),
                      (sm_hd, True, 13, 13), (sm_hd, False, 600, 512),
                      (128, False, 500, 500), (128, False, 13, 500),
                      (128, False, 600, 512)]
        fa_sm = []
        for dname, dt in dtypes.items():
            tol = FLASH_TOL[dname]
            for d, causal, sq, sk in sm_layouts:
                q = randn((2 * sm_h, sq, d), dt)
                k = randn((2 * sm_kv, sk, d), dt)
                v = randn((2 * sm_kv, sk, d), dt)
                before = dict(flash_attention.launches_by_route)
                got = flash_attention(q, k, v, causal=causal)
                took = [r for r, n in flash_attention.launches_by_route
                        .items() if n != before[r]]
                want = flash_attention_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                viol, err = max_violation(got, want, tol)
                row = {"arch": "seamless-m4t-medium", "dtype": dname,
                       "H": sm_h, "Hk": sm_kv, "D": d, "causal": causal,
                       "window": 0, "Sq": sq, "Sk": sk, "route": took,
                       "max_abs_err": err, "tol": tol}
                if dt == torch.bfloat16:
                    one = flash_attention(q[:sm_h].contiguous(),
                                          k[:sm_kv].contiguous(),
                                          v[:sm_kv].contiguous(),
                                          causal=causal)
                    row["bits_equal_B1_B2"] = torch.equal(one, got[:sm_h])
                if viol > 0 or took != [fa_route(dt, d)] or \
                        not row.get("bits_equal_B1_B2", True):
                    raise AssertionError(f"flash_attention at a seamless "
                                         f"layout: {row}")
                fa_sm.append(row)
        for key, (d, causal, sq, sk) in zip(
                ("seamless_encoder", "seamless_cross", "seamless_self"),
                sm_layouts[:3]):
            q = randn((BATCH * sm_h, sq, d), torch.bfloat16)
            k = randn((BATCH * sm_kv, sk, d), torch.bfloat16)
            v = randn((BATCH * sm_kv, sk, d), torch.bfloat16)
            qs = q.reshape(BATCH, sm_h, sq, d)
            ks = k.reshape(BATCH, sm_kv, sk, d)
            vs = v.reshape(BATCH, sm_kv, sk, d)
            pairs = sq * (sq + 1) // 2 if causal else sq * sk
            b_ms, b_by = bound_ms(BATCH * (2 * sm_h * sq + 2 * sm_kv * sk)
                                  * d * 2, BATCH * 4 * d * pairs * sm_h,
                                  "bfloat16")
            fa[key] = {
                "arch": "seamless-m4t-medium", "dtype": "bfloat16",
                "B": BATCH, "H": sm_h, "Hk": sm_kv, "D": d,
                "causal": causal, "Sq": sq, "Sk": sk,
                "route": fa_route(torch.bfloat16, d),
                "ms": cuda_ms(torch, lambda: flash_attention(
                    q, k, v, causal=causal), iters=20),
                "plain_ms": cuda_ms(torch, lambda: flash_attention_ref(
                    q, k, v, causal=causal), iters=20),
                "library_ms": cuda_ms(
                    torch, lambda: torch.nn.functional
                    .scaled_dot_product_attention(qs, ks, vs,
                                                  is_causal=causal),
                    iters=20),
                "bound_ms": b_ms, "bound_by": b_by}
            emit({f"flash_attention_{key}": {
                k_: (round(v_, 6) if isinstance(v_, float) else v_)
                for k_, v_ in fa[key].items()}})
        checks += fa_sm
        out["detail"] = checks
        out["checks"] = len(checks)
        out["max_abs_err"] = max(c["max_abs_err"] for c in checks)
        out["timed"] = fa
        out["timed_head_dim_256"] = fa_rg
        out["bits_equal_B1_B2"] = all(c["bits_equal_B1_B2"] for c in checks
                                      if "bits_equal_B1_B2" in c)
        out["q_start_checks"] = len(qs_checks)
        out["q_start_max_abs_err"] = max(c["max_abs_err"] for c in qs_checks)
        out["q_start_detail"] = qs_checks
        out["warm_equals_cold"] = warm_cold
        for c in warm_cold:
            emit({"flash_attention_warm_vs_cold": c})
        for key in ("warm_bench", "warm"):
            emit({f"flash_attention_{key}": {
                k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in fa[key].items()}})
        for c in checks:
            emit({"flash_attention": {key: (round(v, 6) if isinstance(
                v, float) else v) for key, v in c.items()}})
        for c in fa_rg:
            emit({"flash_attention_d256": {key: (round(v, 6) if isinstance(
                v, float) else v) for key, v in c.items()}})
        out["timed_new_layouts"] = fa_new
    flash_err = max(out["max_abs_err"], out["q_start_max_abs_err"])
    flash_bits = out["bits_equal_B1_B2"]
    flash_warm_cold = out["warm_equals_cold"]

    # -- 5. K3 moe_ffn ---------------------------------------------------
    moe_e, moe_f = moe.n_experts, moe.d_ff
    with phase("moe_ffn") as out:
        checks = []
        # olmoe's shapes, qwen3-moe-30b-a3b's (phase 26: E 128, f 768, C 4
        # a decode call, 20 an admission call, 80 a burst prefill call:
        # two 64-row tiles, the second ragged), Table 2's (phase 27: one
        # expert, c 32) and small ragged ones
        qm = registry.get_config(QWEN3_MOE)
        qm_shape = (qm.n_experts, qm.d_model, qm.d_ff)
        table2_shape = (1, qm.d_model, qm.d_ff)
        groups = [((moe_e, moe_d, moe_f), (1, BATCH, 37, 40)),
                  (qm_shape, (BATCH, 20, 80)), (table2_shape, (32,)),
                  ((3, 96, 80), (5,)), ((2, 33, 17), (20,)),
                  ((5, 40, 24), (3,))]
        for dname, dt in dtypes.items():
            tol = MOE_TOL[dname]
            for (e, d, f), cs in groups:
                w1 = crandn((e, d, f), dt, d ** -0.5)
                w3 = crandn((e, d, f), dt, d ** -0.5)
                w2 = crandn((e, f, d), dt, f ** -0.5)
                for c in cs:
                    buf = crandn((e, c, d), dt)
                    # row counts: every other expert empty, the rest filled
                    # to a random depth; rows past the count are zero, as
                    # the dispatch leaves them
                    cnt = torch.randint(0, c + 1, (e,), generator=gen,
                                        dtype=torch.int32)
                    cnt[::2] = 0
                    cnt = cnt.to(dev)
                    live = torch.arange(c, device=dev)[None] < cnt[:, None]
                    for counts, b in ((None, buf),
                                      (cnt, buf * live[..., None].to(dt))):
                        before = dict(moe_ffn.launches_by_route)
                        got = moe_ffn(b, w1, w3, w2, counts)
                        took = [r for r, n in moe_ffn.launches_by_route
                                .items() if n != before[r]]
                        want = moe_ffn_ref(b, w1, w3, w2, counts)
                        torch.cuda.synchronize()
                        viol, err = max_violation(got, want, tol)
                        if viol > 0:
                            raise AssertionError(
                                f"moe_ffn {dname} E={e} C={c} d={d} f={f} "
                                f"counts={counts is not None}: max err "
                                f"{err} exceeds tol {tol}")
                        row = {"dtype": dname, "E": e, "C": c, "d": d,
                               "f": f, "counts": counts is not None,
                               "route": took, "max_abs_err": err,
                               "tol": tol}
                        # the MoE archs' shapes in bf16 on the tensor
                        # cores; fp32 and the odd shapes on the CUDA cores
                        if took != [moe_route(dt, d, f)] or took != [
                                "wgmma" if dt == torch.bfloat16 and (e, d, f)
                                in ((moe_e, moe_d, moe_f), qm_shape,
                                    table2_shape)
                                else "simt"]:
                            raise AssertionError(f"moe_ffn took {took}: "
                                                 f"{row}")
                        checks.append(row)
                if dt == torch.bfloat16 and (e, d, f) == (moe_e, moe_d,
                                                          moe_f):
                    # bits: the first rows of each expert at C = 4 equal
                    # the same rows computed at C = 1 and C = 8 (one n8
                    # instruction); C = 40 (n48) reported; the rows at C 20
                    # (qwen3-moe-30b-a3b's admission) equal the same rows
                    # at C 32 (both one n32 tile)
                    x = crandn((e, 40, d), dt)
                    at = {c: moe_ffn(x[:, :c].contiguous(), w1, w3, w2)
                          for c in (1, 4, 8, 20, 32, 40)}
                    bits = {f"C{c}": torch.equal(at[c][:, :min(c, 4)],
                                                 at[4][:, :min(c, 4)])
                            for c in (1, 8, 40)}
                    bits["C20_C32"] = torch.equal(at[20], at[32][:, :20])
                    out["bits_equal_to_C4"] = bits
                    if not (bits["C1"] and bits["C8"] and bits["C20_C32"]):
                        raise AssertionError(f"moe_ffn rows at C = 1 or 8 "
                                             f"differ from C = 4, or at C 20 "
                                             f"from C 32: {bits}")
                    del x, at
                del w1, w3, w2
        out["detail"] = checks
        out["checks"] = len(checks)
        out["max_abs_err"] = max(c["max_abs_err"] for c in checks)
        for c in checks:
            emit({"moe_ffn": {key: (round(v, 6) if isinstance(v, float)
                                    else v) for key, v in c.items()}})
    k3_err = out["max_abs_err"]
    k3_bits = out["bits_equal_to_C4"]

    # -- 6. K4 ssd_scan --------------------------------------------------
    def ssd_inputs(bsz, s, h, p, n, dt_, with_h0):
        """x, b and c as strided views of one (B, S, H*P + 2N) tensor, as
        the layer's conv output hands them over; dt post-softplus and a
        negative in fp32 (scales of tests/test_kernels.py:123-128)."""
        conv = randn((bsz, s, h * p + 2 * n), torch.float32)
        conv[..., :h * p] *= 0.5
        conv[..., h * p:] *= 0.3
        conv = conv.to(dt_)
        x = conv[..., :h * p].reshape(bsz, s, h, p)
        b, c = conv[..., h * p:h * p + n], conv[..., h * p + n:]
        dtv = torch.nn.functional.softplus(randn((bsz, s, h), torch.float32))
        a = -torch.exp(randn((h,), torch.float32, 0.3))
        h0 = randn((bsz, h, p, n), torch.float32, 0.5) if with_h0 else None
        return x, dtv, a, b, c, h0

    ssd_h, ssd_p = ssm_heads, ssm.ssm_head_dim
    ssd_n = ssm.ssm_state
    k4 = {}
    with phase("ssd_scan") as out:
        checks = []
        # (B, S, H, P, N, chunk, h0): the mamba2 admission and its batch-2
        # form, ragged S (1 and 37 below one chunk, 129 and 200 over), a
        # non-zero state, N 64 (the wgmma route's other width), small
        # ragged P and N
        cases = [(1, PREFILL_LEN, ssd_h, ssd_p, ssd_n, 128, False),
                 (1, PREFILL_LEN, ssd_h, ssd_p, ssd_n, 128, True),
                 (2, PREFILL_LEN, ssd_h, ssd_p, ssd_n, 128, True)]
        cases += [(1, s, ssd_h, ssd_p, ssd_n, 128, True)
                  for s in (1, 37, 129, 200)]
        cases += [(2, 200, 4, ssd_p, 64, 128, True),
                  (2, 100, 3, 24, 40, 32, True), (3, 50, 2, 5, 7, 16, False),
                  (1, 70, 2, 17, 130, 64, True)]
        for dname, dt_ in dtypes.items():
            tol = SSD_TOL[dname]
            for bsz, s, h, p, n, chunk, with_h0 in cases:
                args = ssd_inputs(bsz, s, h, p, n, dt_, with_h0)
                ops.reset_launch_counts()
                got = ssd_scan(*args, chunk=chunk)
                took = [r for r, c in ssd_scan.launches_by_route.items()
                        if c]
                want = ssd_scan_ref(*args, chunk=chunk)
                torch.cuda.synchronize()
                # bf16 at P 64 (N 128 or 64, chunks of 128 or one) runs on
                # the tensor cores, ragged S included; the rest on CUDA cores
                route_want = ("wgmma" if dname == "bfloat16" and p == ssd_p
                              else "simt")
                if took != [route_want]:
                    raise AssertionError(
                        f"ssd_scan {dname} B={bsz} S={s} P={p} N={n}: took "
                        f"{took}, expected {route_want}")
                errs = []
                for what, g, w in zip(("y", "h_final"), got, want):
                    viol, err = max_violation(g, w, tol)
                    if viol > 0:
                        raise AssertionError(
                            f"ssd_scan {dname} B={bsz} S={s} H={h} P={p} "
                            f"N={n} chunk={chunk} h0={with_h0}: {what} max "
                            f"err {err} exceeds tol {tol}")
                    errs.append(err)
                check = {"dtype": dname, "B": bsz, "S": s, "H": h, "P": p,
                         "N": n, "chunk": chunk, "h0": with_h0,
                         "route": took[0], "max_abs_err": max(errs),
                         "y_err": errs[0], "h_final_err": errs[1],
                         "tol": tol}
                if bsz > 1:
                    # batch 0 of the batched call against it alone
                    one = ssd_scan(*[t[:1] if t is not None and t.dim() > 1
                                     else t for t in args], chunk=chunk)
                    torch.cuda.synchronize()
                    check["bits_equal_B1"] = all(
                        torch.equal(g[:1], o) for g, o in zip(got, one))
                    if not check["bits_equal_B1"]:
                        raise AssertionError(
                            f"ssd_scan {dname} B={bsz} S={s} P={p} N={n}: "
                            f"batch 0 differs from the B = 1 call")
                checks.append(check)
        # one call at the mamba2 admission shape, from a state as the
        # layer passes one
        bsz, s, q = 1, PREFILL_LEN, 128
        for dname in ("bfloat16", "float32"):
            args = ssd_inputs(bsz, s, ssd_h, ssd_p, ssd_n, dtypes[dname],
                              True)
            ms = cuda_ms(torch, lambda: ssd_scan(*args, chunk=q), iters=50)
            # the CUDA-core kernel on the same inputs (the bf16 route
            # before the wgmma kernel)
            simt = cuda_ms(torch, lambda: k4_mod._launch("simt", *args, q),
                           iters=50)
            plain = cuda_ms(torch, lambda: ssd_scan_ref(*args, chunk=q),
                            iters=20)
            kroute = k4_mod.route(args[0].dtype, ssd_p, ssd_n, q, s,
                                  args[0].stride(),
                                  (args[3].stride(), args[4].stride()),
                                  (args[0].data_ptr(), args[3].data_ptr(),
                                   args[4].data_ptr()))
            esize = args[0].element_size()
            state = bsz * ssd_h * ssd_p * ssd_n * 4
            nbytes = (2 * bsz * s * ssd_h * ssd_p * esize      # x, y
                      + 2 * bsz * s * ssd_n * esize            # b, c
                      + bsz * s * ssd_h * 4 + ssd_h * 4        # dt, a
                      + 2 * state)                             # h0, h_final
            flops = 0
            for s0 in range(0, s, q):
                c_len = min(q, s - s0)
                tri = c_len * (c_len + 1) // 2
                # C.B^T once per chunk; per head att.x, C.h^T and the
                # state update
                flops += bsz * (2 * tri * ssd_n + ssd_h * (
                    2 * tri * ssd_p + 4 * c_len * ssd_p * ssd_n))
            b_ms, b_by = bound_ms(nbytes, flops, dname)
            # where the time goes: more blocks (B 2, 4: 48, 96 of the 132
            # SMs) at the same chain, and one chunk (S 128) instead of two
            grid = {}
            if dname == "bfloat16":
                for key, (gb, gs) in {"B2": (2, s), "B4": (4, s),
                                      "S128": (1, 128)}.items():
                    gargs = ssd_inputs(gb, gs, ssd_h, ssd_p, ssd_n,
                                       dtypes[dname], True)
                    grid[key] = cuda_ms(
                        torch, lambda: ssd_scan(*gargs, chunk=q), iters=50)
            k4[dname] = {"dtype": dname, "B": bsz, "S": s, "H": ssd_h,
                         "P": ssd_p, "N": ssd_n, "chunk": q, "route": kroute,
                         "ms": ms, "simt_ms": simt, "ms_at": grid,
                         "plain_ms": plain, "bound_ms": b_ms,
                         "bound_by": b_by, "bytes": nbytes, "flops": flops}
        out["detail"] = checks
        out["checks"] = len(checks)
        out["max_abs_err"] = max(c["max_abs_err"] for c in checks)
        out["timed"] = k4
        out["bits_equal_B1"] = all(c["bits_equal_B1"] for c in checks
                                   if "bits_equal_B1" in c)
        for c in checks:
            emit({"ssd_scan": {key: (round(v, 6) if isinstance(v, float)
                                     else v) for key, v in c.items()}})
    k4_err = out["max_abs_err"]
    k4_bits = out["bits_equal_B1"]

    # -- 7. K5 rglru_scan ------------------------------------------------
    def rglru_inputs(bsz, s, l, with_h0):
        """a = sigmoid(normal), b = 0.3 normal (tests/test_kernels.py:
        156-157), h0 normal, all fp32."""
        a = torch.sigmoid(randn((bsz, s, l), torch.float32))
        b = randn((bsz, s, l), torch.float32, 0.3)
        h0 = randn((bsz, l), torch.float32) if with_h0 else None
        return a, b, h0

    k5 = {}
    with phase("rglru_scan") as out:
        checks = []
        # (B, S, L): the recurrentgemma admission and its batch-2 form,
        # S of 1, 37 and 200, a ragged L of 40; each from zero and from h0
        for bsz, s, l in ((1, PREFILL_LEN, rg_lru), (2, PREFILL_LEN, rg_lru),
                          (1, 1, rg_lru), (1, 37, rg_lru), (1, 200, rg_lru),
                          (3, 50, 40)):
            for with_h0 in (False, True):
                args = rglru_inputs(bsz, s, l, with_h0)
                got = rglru_scan(*args)
                want = rglru_scan_ref(*args)
                torch.cuda.synchronize()
                errs = []
                for what, g, w in zip(("h", "h_final"), got, want):
                    viol, err = max_violation(g, w, RGLRU_TOL)
                    if viol > 0:
                        raise AssertionError(
                            f"rglru_scan B={bsz} S={s} L={l} h0={with_h0}: "
                            f"{what} max err {err} exceeds tol {RGLRU_TOL}")
                    errs.append(err)
                check = {"dtype": "float32", "B": bsz, "S": s, "L": l,
                         "h0": with_h0, "max_abs_err": max(errs),
                         "h_err": errs[0], "h_final_err": errs[1],
                         "bit_equal": all(torch.equal(g, w) for g, w
                                          in zip(got, want)),
                         "tol": RGLRU_TOL}
                if bsz > 1:
                    # batch 0 of the batched call against it alone
                    one = rglru_scan(*[t[:1] if t is not None else t
                                       for t in args])
                    torch.cuda.synchronize()
                    check["bits_equal_B1"] = all(
                        torch.equal(g[:1], o) for g, o in zip(got, one))
                    if not check["bits_equal_B1"]:
                        raise AssertionError(
                            f"rglru_scan B={bsz} S={s} L={l} h0={with_h0}: "
                            f"batch 0 differs from the B = 1 call")
                checks.append(check)
        # one call at the admission shape, from a state as the layer
        # passes one (zeros there; the kernel reads it all the same)
        bsz, s, l = 1, PREFILL_LEN, rg_lru
        args = rglru_inputs(bsz, s, l, True)
        ms = cuda_ms(torch, lambda: rglru_scan(*args), iters=50)
        plain = cuda_ms(torch, lambda: rglru_scan_ref(*args), iters=5)
        nbytes = 3 * bsz * s * l * 4 + 2 * bsz * l * 4   # a, b, h; h0, hf
        b_ms, b_by = bound_ms(nbytes, 2 * bsz * s * l, "float32")
        k5 = {"dtype": "float32", "B": bsz, "S": s, "L": l, "ms": ms,
              "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
              "bytes": nbytes}
        out["detail"] = checks
        out["checks"] = len(checks)
        out["max_abs_err"] = max(c["max_abs_err"] for c in checks)
        out["bit_equal"] = all(c["bit_equal"] for c in checks)
        out["bits_equal_B1"] = all(c["bits_equal_B1"] for c in checks
                                   if "bits_equal_B1" in c)
        out["timed"] = k5
        for c in checks:
            emit({"rglru_scan": {key: (round(v, 6) if isinstance(v, float)
                                       else v) for key, v in c.items()}})
    k5_err = out["max_abs_err"]
    k5_plain_bits, k5_bits = out["bit_equal"], out["bits_equal_B1"]

    # -- 8-11. the served paths at full width --------------------------------
    from repro_torch import steps as steps_lib
    from repro_torch.core.syscore import Syscore
    from repro_torch.engine_config import EngineConfig, PagingConfig
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import attention as attn_mod, encdec, transformer

    def serve_full(out, arch, plens, arrivals, max_new, per_pass):
        """:func:`serve_engine`, its routes kept under ``arch``."""
        eng, long_tokens, launches, path_routes[arch] = serve_engine(
            out, arch, plens, arrivals, max_new, per_pass, smi)
        return eng, long_tokens, launches

    # phases 8-11's engines stay: phases 13-15 serve on their params (no
    # second draw), beside them as the step engines
    path_launches, path_routes, served = {}, {}, {}
    with phase("serve") as out:
        eng, _, path_launches["qwen3-0.6b"] = serve_full(
            out, "qwen3-0.6b", [16, 200, 57, 120, 31, 180, 90, 140],
            [0, 0, 0, 0, 3, 9, 20, 40], MAX_NEW,
            {"matmul": (per_step, per_step),
             "flash_attention": (0, n_layers), "moe_ffn": (0, 0),
             "ssd_scan": (0, 0), "rglru_scan": (0, 0)})
        assert (eng.cfg.n_layers, eng.cfg.d_model, eng.cfg.padded_vocab) == \
            (28, 1024, 153_600), eng.cfg
        served["qwen3-0.6b"] = eng

    k3 = {}
    with phase("serve_olmoe") as out:
        eng, long_tokens, path_launches["olmoe-1b-7b"] = serve_full(
            out, "olmoe-1b-7b", [16, 200, 57, 120, 31, 180],
            [0, 0, 0, 2, 3, 9], MOE_MAX_NEW,
            {"matmul": (moe_per_step, moe_per_step),
             "flash_attention": (0, moe.n_layers),
             "moe_ffn": (moe.n_layers, moe.n_layers), "ssd_scan": (0, 0),
             "rglru_scan": (0, 0)})
        cfg = eng.cfg
        assert (cfg.n_layers, cfg.d_model, cfg.n_experts,
                cfg.experts_per_token, cfg.padded_vocab) == \
            (16, 2048, 64, 8, 51_200), cfg
        assert "lm_head" in eng.params and not cfg.tie_embeddings
        # K3 on the inputs the path gives it (C = 4 a decode call, 40 an
        # admission call)
        k3.update(k3_timed(eng, long_tokens))
        out["k3_timed"] = k3
        served["olmoe-1b-7b"] = eng

    with phase("serve_mamba2") as out:
        # the engine decodes at batch 4, its reference at batch 1: the
        # plain decode reductions must give a row the same bits at both
        from repro_torch.models import layers, ssm as ssm_mod

        def mean_rmsnorm(scale, x, eps):
            """RMSNorm over a plain ``torch.mean``: recorded, not used."""
            x32 = x.float()
            x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True)
                                    + eps)
            return (x32 * (1.0 + scale.float())).to(x.dtype)

        rows, plain_mean = {}, {}
        for d in (ssm_d, d_model, ssm_inner, moe_d):
            for dname, dt_ in dtypes.items():
                # rows of a batch-4 norm that differ from the row alone,
                # over 64 random batches: the port's norm and a plain mean
                differ = {"port": 0, "torch_mean": 0}
                for _ in range(64):
                    x = randn((BATCH, 1, d), dt_)
                    sc = randn((d,), dt_, 0.1)
                    for key, fn in (("port", layers.apply_rmsnorm),
                                    ("torch_mean", mean_rmsnorm)):
                        full_b = fn(sc, x, 1e-6)
                        differ[key] += sum(
                            not torch.equal(full_b[i:i + 1],
                                            fn(sc, x[i:i + 1], 1e-6))
                            for i in range(BATCH))
                rows[f"rmsnorm_{d}_{dname}"] = differ["port"] == 0
                plain_mean[f"{d}_{dname}"] = differ["torch_mean"]
        out["torch_mean_rows_differing_of_256"] = plain_mean
        dec = [randn((BATCH, 1, ssd_h, ssd_p), torch.bfloat16),
               torch.nn.functional.softplus(randn((BATCH, 1, ssd_h),
                                                  torch.float32)),
               -torch.exp(randn((ssd_h,), torch.float32, 0.3)),
               randn((BATCH, 1, ssd_n), torch.bfloat16),
               randn((BATCH, 1, ssd_n), torch.bfloat16),
               randn((ssd_h,), torch.float32),
               randn((BATCH, ssd_h, ssd_p, ssd_n), torch.float32)]
        y4, h4 = ssm_mod.ssd_decode(*dec)
        rows["ssd_decode"] = all(
            torch.equal(y4[i:i + 1], y1) and torch.equal(h4[i:i + 1], h1)
            for i in range(BATCH)
            for y1, h1 in [ssm_mod.ssd_decode(
                *[t if t.dim() == 1 else t[i:i + 1] for t in dec])])
        out["batch_invariant"] = rows
        if not all(rows.values()):
            raise AssertionError(f"decode ops differ between batch "
                                 f"{BATCH} and 1: {rows}")
        # K4 runs once per layer at each admission; decode is the plain
        # one-token update, so K4 launches nowhere else
        eng, _, path_launches["mamba2-130m"] = serve_full(
            out, "mamba2-130m", [16, 200, 57, 120, 31, 180, 90, 140],
            [0, 0, 0, 0, 3, 9, 20, 40], MAX_NEW,
            {"matmul": (ssm_per_step, ssm_per_step),
             "flash_attention": (0, 0), "moe_ffn": (0, 0),
             "ssd_scan": (0, ssm.n_layers), "rglru_scan": (0, 0)})
        cfg = eng.cfg
        assert (cfg.n_layers, cfg.d_model, cfg.padded_vocab,
                cfg.tie_embeddings) == (24, 768, 51_200, False), cfg
        assert "lm_head" in eng.params
        layer0 = eng.caches["groups"]["slot0"]
        assert layer0["state"].dtype == torch.float32
        assert layer0["conv"].dtype == torch.bfloat16
        del layer0
        served["mamba2-130m"] = eng

    with phase("serve_recurrentgemma") as out:
        # the engine decodes at batch 4, its reference at batch 1: one "R"
        # and one "L" layer at full width, every leaf drawn (the gates and
        # biases too, which the model's own draw zeroes in its tail), must
        # give a row the same bits at both, output and cache; the "L"
        # layer's MQA decode attention has b x 1 rows in its batched
        # product, b = 4 in the engine and 1 in the reference
        from repro_torch.models import layers
        rows = {}
        for lkind in ("R", "L"):
            p = layers.init_params(transformer.layer_shapes(rg, lkind), cgen,
                                   torch.bfloat16, dev)
            for name, leaf in p["mix"].items():
                if leaf.dim() == 1:
                    p["mix"][name] = crandn(leaf.shape, leaf.dtype, 0.5)
            p["ffn_ln"] = crandn(p["ffn_ln"].shape, torch.bfloat16, 0.1)
            shapes = transformer._layer_cache_shape(rg, lkind, BATCH,
                                                    MAX_LEN)
            differ = 0
            for _ in range(16):
                x = randn((BATCH, 1, rg_d), torch.bfloat16)
                cache = {k: crandn(v.shape, v.dtype or torch.bfloat16)
                         for k, v in shapes.items()}
                pos = torch.randint(1, MAX_LEN, (BATCH,), generator=gen,
                                    dtype=torch.int32).to(dev)
                c4 = {k: v.clone() for k, v in cache.items()}
                y4, _ = transformer.apply_layer(rg, lkind, p, x,
                                                mode="decode", cache=c4,
                                                pos=pos)
                for i in range(BATCH):
                    c1 = {k: v[i:i + 1].clone() for k, v in cache.items()}
                    y1, _ = transformer.apply_layer(
                        rg, lkind, p, x[i:i + 1], mode="decode", cache=c1,
                        pos=pos[i:i + 1])
                    differ += not (torch.equal(y4[i:i + 1], y1) and all(
                        torch.equal(c4[k][i:i + 1], c1[k]) for k in c1))
            rows[f"{lkind}_layer_rows_differing_of_{16 * BATCH}"] = differ
        del p, cache, c4, c1
        out["batch_invariant"] = rows
        if any(rows.values()):
            raise AssertionError(f"recurrentgemma decode layers differ "
                                 f"between batch {BATCH} and 1: {rows}")
        # K5 runs once per "R" layer at each admission and K1 once per "L"
        # layer; decode is the plain one-token update and cache attention
        eng, _, path_launches["recurrentgemma-2b"] = serve_full(
            out, "recurrentgemma-2b", [16, 200, 57, 120, 31, 180, 90, 140],
            [0, 0, 0, 0, 3, 9, 20, 40], MAX_NEW,
            {"matmul": (rg_per_step, rg_per_step),
             "flash_attention": (0, rg_l), "moe_ffn": (0, 0),
             "ssd_scan": (0, 0), "rglru_scan": (0, rg_r)})
        cfg = eng.cfg
        assert (cfg.n_layers, cfg.d_model, cfg.resolved_head_dim,
                cfg.n_kv_heads, cfg.local_window, cfg.padded_vocab,
                cfg.tie_embeddings) == (26, 2560, 256, 1, 2048, 256_000,
                                        True), cfg
        assert (rg_r, rg_l, rg_per_step) == (18, 8, 165)
        assert "lm_head" not in eng.params
        for layer in (eng.params["groups"]["slot0"]["mix"],
                      eng.params["tail"]["tail1"]["mix"]):
            for name in ("lam", "w_a", "b_a", "w_i", "b_i"):
                assert layer[name].dtype == torch.float32, name
            assert layer["w_x"].dtype == torch.bfloat16
        for layer in (eng.caches["groups"]["slot1"],
                      eng.caches["tail"]["tail0"]):
            assert layer["h"].dtype == torch.float32
            assert layer["conv"].dtype == torch.bfloat16
        attn = eng.caches["groups"]["slot2"]
        for leaf in ("k", "v"):
            # max_len 512 < window 2048: the flat windowed layout
            assert attn[leaf].dtype == torch.bfloat16
            assert tuple(attn[leaf].shape) == (rg_l, BATCH, MAX_LEN, 1, 256)
        del layer, attn
        served["recurrentgemma-2b"] = eng

    # -- 12. card against CPU ----------------------------------------------
    with phase("parity") as out:
        equal, paged_equal, paged_moves = {}, {}, {}
        for arch in ("qwen3-0.6b", "olmoe-1b-7b", "mamba2-130m",
                     "recurrentgemma-2b", *new_cfgs):
            config = EngineConfig(reduced=True, batch=2, max_len=64,
                                  clock="step")
            # the three requests need 3, 5 and 4 blocks of 8: an arena of
            # 6 holds no two of the longer ones, so admission waits,
            # slots rotate every 3 tokens and blocks swap
            paged = config.replace(paging=PagingConfig(
                kv_block=8, arena_blocks=6, timeslice=3))
            # drawn once on the CPU: the card's generator draws other bits
            params = transformer.init_params(
                registry.get_config(arch, reduced=True), 7)
            streams = {}
            for device in ("cuda", "cpu"):
                for name, conf in (("dense", config), ("paged", paged)):
                    eng = ServingEngine(arch, conf, device=device,
                                        params=to_device(params, device))
                    rng = np.random.default_rng(1)
                    reqs = [eng.submit(rng.integers(1, eng.cfg.vocab_size,
                                                    size=p),
                                       max_new=n, arrival_time=a)
                            for p, n, a in ((5, 12, 0), (17, 20, 0),
                                            (9, 16, 3))]
                    stats = eng.run()
                    streams[device, name] = [r.generated for r in reqs]
                    if name == "paged":
                        eng.pager.check_invariants()
                        progs = eng.syscore.report()["programs"]
                        if device == "cuda" and any(
                                p["source"] != "cuda_graph"
                                for p in progs.values()):
                            raise AssertionError(
                                f"{arch}: paged programs are not captured "
                                f"graphs: {progs}")
                        paged_moves[f"{arch}/{device}"] = {
                            k: stats[k] for k in ("preemptions", "swap_ins",
                                                  "page_faults",
                                                  "swap_outs")}
            if streams["cuda", "dense"] != streams["cpu", "dense"]:
                raise AssertionError(f"{arch}: card and CPU streams differ: "
                                     f"{streams}")
            if streams["cuda", "paged"] != streams["cpu", "paged"]:
                raise AssertionError(f"{arch}: paged card and CPU streams "
                                     f"differ: {streams}")
            if streams["cuda", "paged"] != streams["cuda", "dense"]:
                raise AssertionError(f"{arch}: paged and dense card streams "
                                     f"differ: {streams}")
            if not paged_moves[f"{arch}/cuda"]["preemptions"]:
                raise AssertionError(f"{arch}: the paged run preempted "
                                     f"nothing: {paged_moves}")
            equal[arch] = sum(len(s) for s in streams["cuda", "dense"])
            paged_equal[arch] = sum(len(s) for s in streams["cuda", "paged"])
        # internvl2's frontend: forward with 4 patch embeddings from a
        # numpy seed before 12 text tokens (row 1 right-padded), card
        # against CPU at rtol/atol 1e-4, the model tolerance the CPU tests
        # hold the port to the reference with (fp32 sums in other orders)
        vcfg = registry.get_config("internvl2-26b", reduced=True)
        vparams = transformer.init_params(vcfg, 7)
        rng = np.random.default_rng(0)
        vtok = rng.integers(1, vcfg.vocab_size, (2, 12)).astype(np.int32)
        vtok[1, 7:] = 0
        vpre = rng.standard_normal(
            (2, vcfg.frontend_tokens, vcfg.d_model)).astype(np.float32)
        vlen = np.asarray([vcfg.frontend_tokens + 12,
                           vcfg.frontend_tokens + 7], np.int32)
        vlogits = {}
        for device in ("cuda", "cpu"):
            vlogits[device], _ = transformer.forward(
                vcfg, to_device(vparams, device),
                torch.from_numpy(vtok).to(device),
                prefix_embeds=torch.from_numpy(vpre).to(device),
                mode="prefill",
                caches=transformer.init_cache(vcfg, 2, 64, device=device),
                lengths=torch.from_numpy(vlen).to(device))
        frontend_err = float((vlogits["cuda"].cpu() - vlogits["cpu"])
                             .abs().max())
        if not torch.allclose(vlogits["cuda"].cpu(), vlogits["cpu"],
                              rtol=1e-4, atol=1e-4):
            raise AssertionError(f"internvl2 forward with prefix_embeds: "
                                 f"card and CPU logits differ by "
                                 f"{frontend_err}")
        # seamless-m4t-medium: its two programs (captured graphs on the
        # card) on 12 frames from a numpy seed and 6 prompt tokens a row,
        # batch 2: the prefill's last logits card against CPU at rtol/atol
        # 1e-4, then 8 greedy tokens a row (the prefill's and 7 decode
        # steps'), equal
        scfg = registry.get_config("seamless-m4t-medium", reduced=True)
        sparams = encdec.init_params(scfg, 7, device="cpu")
        rng = np.random.default_rng(0)
        sframes = torch.from_numpy((rng.standard_normal(
            (2, 12, scfg.d_model)) * 0.02).astype(np.float32))
        stok = torch.from_numpy(rng.integers(
            1, scfg.vocab_size, (2, 6)).astype(np.int32))
        slast, sstream = {}, {}
        for device in ("cuda", "cpu"):
            sp = to_device(sparams, device)
            scaches = encdec.init_cache(scfg, 2, 16, 12, device=device)
            sysc = Syscore(device)
            sprogs = {k_: sysc.hot_load(spec) for k_, spec in
                      steps_lib.encdec_program_specs(scfg, sp, scaches,
                                                     6).items()}
            if device == "cuda" and any(
                    p["source"] != "cuda_graph"
                    for p in sysc.report()["programs"].values()):
                raise AssertionError(f"seamless programs are not captured "
                                     f"graphs: {sysc.report()['programs']}")
            for t in leaves(scaches):       # the warm-ups wrote them
                t.zero_()
            _, last = sprogs["prefill"](sp, scaches, sframes.to(device),
                                        stok.to(device))
            slast[device] = last.cpu()
            tok = transformer.greedy_token(scfg, last)[:, None]
            toks = [tok.cpu()]
            for i in range(7):
                _, tok, _ = sprogs["decode"](sp, scaches, tok, 6 + i)
                toks.append(tok.cpu())
            sstream[device] = torch.cat(toks, 1).tolist()
            del sysc, sprogs, scaches
        seamless_err = float((slast["cuda"] - slast["cpu"]).abs().max())
        if not torch.allclose(slast["cuda"], slast["cpu"], rtol=1e-4,
                              atol=1e-4):
            raise AssertionError(f"seamless prefill: card and CPU last "
                                 f"logits differ by {seamless_err}")
        if sstream["cuda"] != sstream["cpu"]:
            raise AssertionError(f"seamless: card and CPU greedy streams "
                                 f"differ: {sstream}")
        out.update(dtype="float32", streams=3, tokens=equal, equal=True,
                   paged_tokens=paged_equal, paged_equal=True,
                   paged_moves=paged_moves,
                   frontend={"arch": "internvl2-26b", "prefix_embeds":
                             vcfg.frontend_tokens, "text_tokens": 12,
                             "max_abs_diff": frontend_err, "tol": 1e-4},
                   seamless={"frames": 12, "prompt": 6, "batch": 2,
                             "last_logits_max_abs_diff": seamless_err,
                             "tol": 1e-4, "tokens": sstream["cuda"],
                             "streams_equal": True})

    # -- 13. the paged KV arena at full width -----------------------------
    def paged_workload(n_req, vocab_size):
        """``n_req`` requests from seed 0: prompts of 160-256 tokens, 96-128
        new tokens each."""
        rng = np.random.default_rng(0)
        return [(rng.integers(1, vocab_size,
                              size=int(rng.integers(160, PREFILL_LEN + 1))),
                 int(rng.integers(96, 129))) for _ in range(n_req)]

    def serve_paged(out, arch, n_req, per_pass):
        """Serve ``n_req`` requests through a full-width bf16 paged engine
        whose arena holds half the batch, then the same requests through
        the unpaged engine on the same weights; hold the streams against
        each other and ``reference_generate``, the launches against
        ``per_pass``, graph against eager with every slot mapped; time
        both engines' decode steps and admissions."""
        gc.collect()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServingEngine(arch, EngineConfig(
            reduced=False, batch=BATCH, max_len=MAX_LEN,
            prefill_len=PREFILL_LEN, clock="step", seed=0,
            paging=PagingConfig(kv_block=PAGED_BLOCK,
                                arena_blocks=PAGED_ARENA,
                                timeslice=PAGED_TIMESLICE)), device="cuda",
            params=served[arch].params)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        boot_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        after_boot = torch.cuda.memory_allocated()
        cfg, pager = eng.cfg, eng.pager
        programs = eng.syscore.report()["programs"]
        for name, prog in programs.items():
            print(f"{arch} paged {name}: source {prog['source']}, lower_s "
                  f"{prog['lower_s']:.4f}, compile_s {prog['compile_s']:.4f}",
                  flush=True)
            if prog["source"] != "cuda_graph" or not prog["compile_s"] > 0:
                raise AssertionError(f"{arch} paged {name} is not a captured "
                                     f"graph: {prog}")
        # the warm-ups wrote the tree; the engine booted it empty again,
        # with every slot unmapped (0 would map them all to block 0)
        if not bool((eng.caches["block_table"] == -1).all()):
            raise AssertionError(f"{arch}: the block table did not boot "
                                 f"unmapped")
        arena_leaf = next(t for t in leaves(eng.caches)
                          if t.dim() >= 4 and t.dtype == torch.bfloat16
                          and PAGED_ARENA + 1 in t.shape)
        tree_bytes = sum(t.numel() * t.element_size()
                         for tree in (eng.params, eng.caches)
                         for t in leaves(tree))
        # the params are phase 8's or 11's, allocated before ``base``
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in leaves(eng.caches))
        work = paged_workload(n_req, cfg.vocab_size)
        reqs = [eng.submit(p, max_new=m) for p, m in work]
        assert all(r is not None for r in reqs), "a request was rejected"
        blocks = sum(eng._blocks_needed(r.prompt_len, r.max_new)
                     for r in reqs)
        ratio = blocks / PAGED_ARENA
        if ratio < 2:
            raise AssertionError(f"{arch}: workload {blocks} blocks is under "
                                 f"2x the arena's {PAGED_ARENA}")
        ops.reset_launch_counts()
        stats = eng.run()
        launches = ops.launch_counts()
        routes = ops.route_counts()
        peak = torch.cuda.max_memory_allocated()
        rep = pager.report()
        assert stats["requests"] == len(reqs), stats
        pager.check_invariants()
        moves = {"evictions": rep["evictions"],
                 "page_faults": rep["page_faults"],
                 "swap_outs": rep["swap_outs"],
                 "preemptions": stats["preemptions"],
                 "swap_ins": stats["swap_ins"], "hits": rep["hits"]}
        if min(moves["evictions"], moves["page_faults"],
               moves["preemptions"]) < 1:
            raise AssertionError(f"{arch}: no paging under pressure: "
                                 f"{moves}")
        # resumes run no program: admissions are the fresh ones only
        want = {name: step * stats["decode_steps"] + adm * stats["admitted"]
                for name, (step, adm) in per_pass.items()}
        if launches != want:
            raise AssertionError(f"{arch} paged: kernel launches {launches}, "
                                 f"expected {want}")
        if any(r["wgmma"] != launches[name] for name, r in routes.items()):
            raise AssertionError(f"{arch} paged: K1/K3/K4 calls off the "
                                 f"wgmma route: {routes}")
        # the unpaged engine on the same weights and workload
        dense = ServingEngine(arch, EngineConfig(
            reduced=False, batch=BATCH, max_len=MAX_LEN,
            prefill_len=PREFILL_LEN, clock="step"), device="cuda",
            params=eng.params)
        dreqs = [dense.submit(p, max_new=m) for p, m in work]
        dstats = dense.run()
        mism = []
        for r, d in zip(reqs, dreqs):
            ref = eng.reference_generate(r.prompt, r.max_new)
            if not r.generated == d.generated == ref:
                mism.append({"rid": r.rid, "paged": r.generated,
                             "unpaged": d.generated, "reference": ref})
        if mism:
            RECORD.setdefault("stream_mismatch", {})[f"{arch}/paged"] = mism
            raise AssertionError(f"{arch}: {len(mism)} of {len(reqs)} paged "
                                 f"streams differ: {mism[0]}")
        # every slot mapped (the whole arena, 32 blocks each) at its own
        # position: 4 decode steps and one admission, graph against eager
        long = max(reqs, key=lambda r: r.prompt_len)
        assert long.prompt_len >= 200, long.prompt_len
        long_tokens = torch.zeros((1, PREFILL_LEN), dtype=torch.int32)
        long_tokens[0, :200] = torch.from_numpy(long.prompt[:200])
        long_tokens = long_tokens.to(dev)
        per_slot = PAGED_ARENA // BATCH
        for slot in range(BATCH):
            eng.caches = pager.admit(-1 - slot, per_slot, slot, eng.caches)
        eng.caches["pos"].copy_(torch.tensor([100, 37, 3, 170],
                                             dtype=torch.int32))
        pager.check_invariants()
        diffs = graph_vs_eager(torch, eng, dev, long_tokens)
        if diffs:
            raise AssertionError(f"{arch} paged: graph replay and eager run "
                                 f"differ: {diffs[:8]}")
        timed, admit_ms = {}, {}
        for name, e in (("paged", eng), ("unpaged", dense)):
            timed[name] = time_calls(torch, decode_call(torch, e, dev), 5)
            admit_ms[name] = median_wall_ms(
                torch, admission_call(e, long_tokens), 3)
        # then where a decode step's device time goes, kernels counted
        # (the profiler runs after every timed call of the phase)
        for name, e in (("paged", eng), ("unpaged", dense)):
            timed[name] = profile_calls(torch, decode_call(torch, e, dev), 5,
                                        timed[name])
        for slot in range(BATCH):
            eng.caches = pager.release(-1 - slot, slot, eng.caches)
        pager.check_invariants()
        unpaged = {"decode_p50_ms": dstats["decode_p50_ms"],
                   "tok_per_s": dstats["tok_per_s"],
                   "wall_s": dstats["wall_s"],
                   "decode_steps": dstats["decode_steps"],
                   "admission_ms": admit_ms["unpaged"],
                   "decode": timed["unpaged"]}
        out.update(
            model=arch, dtype="bfloat16", batch=BATCH, max_len=MAX_LEN,
            prefill_len=PREFILL_LEN, kv_block=PAGED_BLOCK,
            arena_blocks=PAGED_ARENA, timeslice=PAGED_TIMESLICE,
            arena_mib=round(PAGED_ARENA * rep["block_bytes"] / 2 ** 20, 3),
            block_bytes=rep["block_bytes"],
            arena_leaf_shape=list(arena_leaf.shape),
            requests=len(reqs), workload_blocks=blocks,
            footprint_ratio=ratio, boot_s=round(boot_s, 3),
            decode_p50_ms=stats["decode_p50_ms"],
            tok_per_s=stats["tok_per_s"], wall_s=stats["wall_s"],
            decode_steps=stats["decode_steps"], admitted=stats["admitted"],
            admission_ms=admit_ms["paged"], decode=timed["paged"],
            arena_occupancy=stats["arena_occupancy"], moves=moves,
            swap_out_ms=rep["swap_out_ms"],
            page_fault_ms=rep["page_fault_ms"],
            launches=launches, launches_by_route=routes,
            launches_per_pass=per_pass,
            programs=eng.syscore.report()["programs"],
            graph_equals_eager={"decode_steps": 4, "admissions": 1,
                                "bit_equal": True, "slots_mapped": BATCH},
            streams_equal_reference_and_unpaged=True, invariants=True,
            boot_peak_gib=round(boot_peak / 2 ** 30, 3),
            serve_peak_gib=round(peak / 2 ** 30, 3),
            mem_at_start_gib=round(base / 2 ** 30, 3),
            mem_after_boot_gib=round(after_boot / 2 ** 30, 3),
            params_and_caches_gib=round(tree_bytes / 2 ** 30, 3),
            boot_besides_trees_gib=round(
                (after_boot - base - cache_bytes) / 2 ** 30, 3),
            unpaged=unpaged, card=smi)
        print(f"{arch} paged: decode p50 {stats['decode_p50_ms']:.3f} ms "
              f"(unpaged {dstats['decode_p50_ms']:.3f}), tok/s "
              f"{stats['tok_per_s']:.1f} ({dstats['tok_per_s']:.1f}), "
              f"admission {admit_ms['paged']:.3f} ms "
              f"({admit_ms['unpaged']:.3f}), page faults "
              f"{rep['page_faults']} at {rep['page_fault_ms']:.3f} ms, "
              f"swap-outs {rep['swap_outs']} at {rep['swap_out_ms']:.3f} ms, "
              f"arena occupancy {stats['arena_occupancy']:.3f}, boot peak "
              f"{boot_peak / 2 ** 30:.3f} GiB ({tree_bytes / 2 ** 30:.3f} "
              f"GiB params and caches)", flush=True)
        path_launches[f"{arch}/paged"] = launches
        paged_streams[arch] = (work, [r.generated for r in reqs])
        path_routes[f"{arch}/paged"] = routes
        del eng, dense

    paged_streams = {}
    with phase("serve_paged") as out:
        out["qwen3-0.6b"] = {}
        serve_paged(out["qwen3-0.6b"], "qwen3-0.6b", 16,
                    {"matmul": (per_step, per_step),
                     "flash_attention": (0, n_layers), "moe_ffn": (0, 0),
                     "ssd_scan": (0, 0), "rglru_scan": (0, 0)})
        out["recurrentgemma-2b"] = {}
        serve_paged(out["recurrentgemma-2b"], "recurrentgemma-2b", 8,
                    {"matmul": (rg_per_step, rg_per_step),
                     "flash_attention": (0, rg_l), "moe_ffn": (0, 0),
                     "ssd_scan": (0, 0), "rglru_scan": (0, rg_r)})

    # -- 14-15. fused decode horizons and speculative verify ---------------
    from repro_torch.core.paging import cache_leaves, leaf_axis, leaf_kind
    from repro_torch.engine_config import HorizonConfig, SpecConfig
    from repro_torch.launch import serve as serve_mod

    def boot(arch, **kw):
        """A full-width bf16 engine at batch 4 on the params of phase 8-11's
        engine for ``arch`` (no second draw), every program a captured
        graph.  Returns the engine and its boot record: seconds, the
        memory it took besides its caches (the graphs' static outputs and
        buffers), and per program the warm-up and capture seconds and the
        memory the capture reserved for the graph's own pool."""
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = ServingEngine(arch, EngineConfig(**dict(dict(
            reduced=False, batch=BATCH, max_len=MAX_LEN,
            prefill_len=PREFILL_LEN, clock="step"), **kw)), device="cuda",
            params=served[arch].params)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in leaves(eng.caches))
        programs = {}
        for name, prog in eng.syscore.report()["programs"].items():
            pool = eng.programs[name].program.stats.graph_bytes / 2 ** 20
            print(f"{arch} {name}: source {prog['source']}, lower_s "
                  f"{prog['lower_s']:.4f}, compile_s {prog['compile_s']:.4f}, "
                  f"graph pool {pool:.1f} MiB", flush=True)
            if prog["source"] != "cuda_graph" or not prog["compile_s"] > 0:
                raise AssertionError(f"{arch} {name} is not a captured "
                                     f"graph: {prog}")
            programs[name] = {"lower_s": prog["lower_s"],
                              "compile_s": prog["compile_s"],
                              "graph_pool_mib": pool}
        return eng, {
            "boot_s": boot_s, "programs": programs,
            "caches_gib": cache_bytes / 2 ** 30,
            "boot_besides_params_and_caches_gib":
                (torch.cuda.memory_allocated() - base - cache_bytes) / 2 ** 30}

    def serve_counted(eng, work):
        """Submit ``work`` ((prompt, max_new, arrival) each) and serve it,
        the launch counts set to 0 just before; returns the requests, the
        run's stats and its launches and routes."""
        reqs = [eng.submit(p, max_new=m, arrival_time=a) for p, m, a in work]
        assert all(r is not None for r in reqs), "a request was rejected"
        ops.reset_launch_counts()
        stats = eng.run()
        launches, routes = ops.launch_counts(), ops.route_counts()
        assert stats["requests"] == len(reqs), stats
        return reqs, stats, launches, routes

    def check_launches(name, per_pass, stats, launches, routes, fused):
        """A run's launches against ``per_pass`` ({kernel: (per decode
        step, per admission)}): for each ``key: n`` of ``fused`` the run's
        ``stats[key]`` replays of an n-step program count n decode steps
        each, every other dispatch one; every K1/K3/K4 call on the wgmma
        route.  The run joins the kernels line as path ``name``."""
        steps = stats["decode_steps"] + sum((n - 1) * stats[key]
                                            for key, n in fused.items())
        want = {k: step * steps + adm * stats["admitted"]
                for k, (step, adm) in per_pass.items()}
        if launches != want:
            raise AssertionError(f"{name}: kernel launches {launches}, "
                                 f"expected {want}")
        if any(r["wgmma"] != launches[k] for k, r in routes.items()):
            raise AssertionError(f"{name}: K1/K3/K4 calls off the wgmma "
                                 f"route: {routes}")
        path_launches[name], path_routes[name] = launches, routes

    def check_streams(name, reqs, others):
        """Every stream of ``reqs`` equals the same request's in ``others``
        and ``reference_generate`` (phase 8-11's batch-1 engine)."""
        ref_eng = served[name.split("/")[0]]
        mism = []
        for r, o in zip(reqs, others):
            ref = ref_eng.reference_generate(r.prompt, r.max_new)
            if not r.generated == o.generated == ref:
                mism.append({"rid": r.rid, "engine": r.generated,
                             "other": o.generated, "reference": ref})
        if mism:
            RECORD.setdefault("stream_mismatch", {})[name] = mism
            raise AssertionError(f"{name}: {len(mism)} of {len(reqs)} "
                                 f"streams differ: {mism[0]}")

    def fill_slots(eng, seed):
        """Admit a random prompt into every slot through the engine's
        ``prefill_slot`` replay (a paged engine's slots mapped first, by
        fake rids -1..-4, the arena split between them).  Returns the
        (batch, 1) last tokens to decode from."""
        if eng.paged:
            for slot in range(BATCH):
                eng.caches = eng.pager.admit(-1 - slot, PAGED_ARENA // BATCH,
                                             slot, eng.caches)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for slot, n in enumerate((200, 57, 120, 31)):
            prompt = torch.zeros((1, PREFILL_LEN), dtype=torch.int32)
            prompt[0, :n] = torch.randint(1, eng.cfg.vocab_size, (n,),
                                          generator=gen, dtype=torch.int32)
            eng.programs["prefill_slot"](eng.params, eng.caches,
                                         prompt.to(dev), slot, n)
        return torch.randint(1, eng.cfg.vocab_size, (BATCH, 1),
                             generator=gen, dtype=torch.int32).to(dev)

    def unmap_slots(eng):
        if eng.paged:
            for slot in range(BATCH):
                eng.caches = eng.pager.release(-1 - slot, slot, eng.caches)
            eng.pager.check_invariants()

    def horizon_vs_eager(eng, last):
        """One ``decode_horizon`` replay against H eager
        ``decode_step(live=...)`` calls with the same greedy feedback on a
        copy of the same caches: row 1's budget of 7 freezes it mid-way,
        row 3's of 0 throughout.  The events and every cache leaf (a paged
        arena without its sink) must be bit-equal.  The caches are
        restored after."""
        cfg = eng.cfg
        backup = clone_tree(eng.caches)
        budgets = [HORIZON, 7, HORIZON, 0]
        budget = torch.tensor(budgets, dtype=torch.int32, device=dev)
        _, ev = eng.programs["decode_horizon"](eng.params, eng.caches, last,
                                               budget)
        got = {k: v.clone() for k, v in ev.items()}
        eager = clone_tree(backup)
        tok, live = last[:, 0], budget > 0
        emitted = torch.zeros_like(budget)
        ys, occ = [], []
        for _ in range(HORIZON):
            logits, _ = transformer.decode_step(cfg, eng.params, eager,
                                                tok[:, None], live=live)
            y = torch.where(live, transformer.greedy_token(cfg, logits[:, 0]),
                            tok)
            emitted = emitted + live.to(emitted.dtype)
            occ.append(live.float().mean())
            ys.append(y)
            tok, live = y, live & (emitted < budget)
        diffs = [f"cache {p}" for p in tree_diffs(
            torch, without_sink(eng.caches), without_sink(eager))]
        for key, want in (("tokens", torch.stack(ys, 1)),
                          ("n_emitted", emitted),
                          ("occupancy", torch.stack(occ))):
            if not torch.equal(got[key], want):
                diffs.append(f"events {key}")
        if got["n_emitted"].tolist() != budgets:
            diffs.append(f"n_emitted {got['n_emitted'].tolist()}")
        copy_tree(eng.caches, backup)
        torch.cuda.synchronize()
        if diffs:
            raise AssertionError(f"{eng.arch}: the decode_horizon replay and "
                                 f"{HORIZON} eager decode_step(live) calls "
                                 f"differ: {diffs[:8]}")
        return {"steps": HORIZON, "budgets": budgets, "bit_equal": True}

    def timed_replays(eng, name, args, steps):
        """``name``'s replays on the live caches, timed (:func:`time_calls`);
        the caches are restored after.  Returns the times and the caches
        as they were."""
        backup = clone_tree(eng.caches)
        prog = eng.programs[name]

        def call():
            return prog(eng.params, eng.caches, *args)

        timed = time_calls(torch, call, steps)
        copy_tree(eng.caches, backup)
        return timed, backup

    def serve_horizon(out, arch, per_pass, plens, arrivals):
        """The horizon engine (H = 16) on phase 8-11's params beside that
        phase's step engine: a staggered workload, then a saturated one
        (every slot at time 0, 4H + 1 new tokens each); one replay against
        eager steps; the replay timed beside a decode step."""
        step_eng = served[arch]
        eng, info = boot(arch, horizon=HorizonConfig(HORIZON))
        cfg = eng.cfg
        one = eng.programs["decode"].program.launches
        fused = eng.programs["decode_horizon"].program.launches
        if fused != {k: HORIZON * v for k, v in one.items()}:
            raise AssertionError(f"{arch}: a decode_horizon replay launches "
                                 f"{fused}, not {HORIZON} x {one}")
        rng = np.random.default_rng(2)
        work = [(rng.integers(1, cfg.vocab_size, size=p), HORIZON_MAX_NEW, a)
                for p, a in zip(plens, arrivals)]
        sat_work = [(rng.integers(1, cfg.vocab_size, size=64),
                     4 * HORIZON + 1, 0.0) for _ in range(BATCH)]
        runs = {}
        for key, w in (("staggered", work), ("saturated", sat_work)):
            step = serve_counted(step_eng, w)
            fuse = serve_counted(eng, w)
            reqs, stats, launches, routes = fuse
            if stats["horizon_steps"] < 1:
                raise AssertionError(f"{arch} {key}: no horizon fused: "
                                     f"{stats}")
            check_launches(f"{arch}/horizon/{key}", per_pass, stats,
                           launches, routes, {"horizon_steps": HORIZON})
            check_streams(f"{arch}/horizon/{key}", reqs, step[0])
            ms_tok = [1e3 * s["wall_s"] / s["decode_tokens"]
                      for s in (stats, step[1])]
            runs[key] = {
                "requests": len(w), "max_new": w[0][1],
                "tok_per_s": stats["tok_per_s"],
                "step_tok_per_s": step[1]["tok_per_s"],
                "ms_per_token": ms_tok[0], "step_ms_per_token": ms_tok[1],
                "decode_steps": stats["decode_steps"],
                "horizon_steps": stats["horizon_steps"],
                "step_decode_steps": step[1]["decode_steps"],
                "dispatches_per_token": stats["dispatches_per_token"],
                "step_dispatches_per_token":
                    step[1]["dispatches_per_token"]}
        if not runs["saturated"]["dispatches_per_token"] <= 1 / 8:
            raise AssertionError(f"{arch}: {runs['saturated']} dispatches a "
                                 f"token at H = {HORIZON}")
        runs["staggered"].update(prompt_lens=plens, arrivals=arrivals)
        last = fill_slots(eng, 3)
        eager = horizon_vs_eager(eng, last)
        full = torch.full((BATCH,), HORIZON, dtype=torch.int32, device=dev)
        timed, backup = timed_replays(eng, "decode_horizon", (last, full), 3)
        step_timed, _ = timed_replays(eng, "decode", (last,), 5)
        copy_tree(eng.caches, backup)
        prog = info["programs"]["decode_horizon"]
        out.update(
            model=arch, horizon=HORIZON, boot=info, **runs,
            launches_per_replay=fused, launches_per_decode_step=one,
            graph_equals_eager=eager, replay=timed, decode_step=step_timed,
            streams_equal_step_engine_and_reference=True, card=smi)
        sat = runs["saturated"]
        print(f"{arch} horizon {HORIZON}: saturated tok/s "
              f"{sat['tok_per_s']:.1f} (step engine "
              f"{sat['step_tok_per_s']:.1f}), ms/token "
              f"{sat['ms_per_token']:.3f} ({sat['step_ms_per_token']:.3f}), "
              f"replay span {timed['events_device_ms_per_step']:.3f} ms, "
              f"capture "
              f"{prog['compile_s']:.3f} s, graph pool "
              f"{prog['graph_pool_mib']:.1f} MiB", flush=True)

    def serve_horizon_paged(out):
        """qwen3-0.6b's horizon engine through phase 13's arena and
        workload: its streams must be phase 13's paged engine's (which
        equal the unpaged engine's and ``reference_generate``).  With no
        timeslice: the adaptive policy never fuses while a request waits
        and a timeslice could rotate a slot out, and under this workload
        one always waits until the last requests."""
        arch = "qwen3-0.6b"
        eng, info = boot(arch, horizon=HorizonConfig(HORIZON),
                         paging=PagingConfig(kv_block=PAGED_BLOCK,
                                             arena_blocks=PAGED_ARENA))
        work, streams = paged_streams[arch]
        reqs, stats, launches, routes = serve_counted(
            eng, [(p, m, 0.0) for p, m in work])
        check_launches(f"{arch}/paged/horizon", qwen_pass, stats, launches,
                       routes, {"horizon_steps": HORIZON})
        eng.pager.check_invariants()
        if [r.generated for r in reqs] != streams:
            raise AssertionError(f"{arch}: paged horizon streams differ from "
                                 f"phase 13's paged engine's")
        if stats["horizon_steps"] < 1:
            raise AssertionError(f"{arch}: the paged horizon run fused "
                                 f"nothing: {stats}")
        last = fill_slots(eng, 5)
        eager = horizon_vs_eager(eng, last)
        unmap_slots(eng)
        out.update(model=arch, horizon=HORIZON, boot=info,
                   requests=len(reqs),
                   **{k: stats[k] for k in (
                       "tok_per_s", "decode_steps", "horizon_steps",
                       "dispatches_per_token", "arena_occupancy")},
                   graph_equals_eager=eager,
                   streams_equal_phase13_paged=True, invariants=True,
                   card=smi)
        print(f"{arch} paged horizon: tok/s {stats['tok_per_s']:.1f}, "
              f"{stats['horizon_steps']} of {stats['decode_steps']} "
              f"dispatches fused, arena occupancy "
              f"{stats['arena_occupancy']:.3f}", flush=True)

    qwen_pass = {"matmul": (per_step, per_step),
                 "flash_attention": (0, n_layers), "moe_ffn": (0, 0),
                 "ssd_scan": (0, 0), "rglru_scan": (0, 0)}
    serve_passes = {
        "qwen3-0.6b": qwen_pass,
        "olmoe-1b-7b": {"matmul": (moe_per_step, moe_per_step),
                        "flash_attention": (0, moe.n_layers),
                        "moe_ffn": (moe.n_layers, moe.n_layers),
                        "ssd_scan": (0, 0), "rglru_scan": (0, 0)},
        "mamba2-130m": {"matmul": (ssm_per_step, ssm_per_step),
                        "flash_attention": (0, 0), "moe_ffn": (0, 0),
                        "ssd_scan": (0, ssm.n_layers), "rglru_scan": (0, 0)},
        "recurrentgemma-2b": {"matmul": (rg_per_step, rg_per_step),
                              "flash_attention": (0, rg_l), "moe_ffn": (0, 0),
                              "ssd_scan": (0, 0), "rglru_scan": (0, rg_r)},
    }
    with phase("serve_horizon") as out:
        for arch, per_pass in serve_passes.items():
            out[arch] = {}
            serve_horizon(out[arch], arch, per_pass,
                          [16, 200, 57, 120, 31, 180], [0, 0, 0, 0, 3, 9])
        out["qwen3-0.6b/paged"] = {}
        serve_horizon_paged(out["qwen3-0.6b/paged"])

    class ForcedProposer:
        """Offers k drafts at every step, cycled from the observed history
        (the rule of the repository's test double), so every step
        verifies."""

        def __init__(self, ngram):
            self.h = []

        def observe(self, toks):
            self.h.extend(int(t) for t in toks)

        def propose(self, k):
            return [self.h[(len(self.h) + i) % len(self.h)]
                    for i in range(k)]

    def lookup_prompts(arch):
        """One prompt a slot, built as ``benchmarks/bench_spec.py`` builds
        them: 8 random tokens, then the model's own greedy continuation of
        them (batch-1 ``reference_generate``), so that the continuation
        revisits spans a prompt lookup finds."""
        rng = np.random.default_rng(4)
        prompts = []
        for _ in range(BATCH):
            seed = rng.integers(1, served[arch].cfg.vocab_size, size=8)
            warm = served[arch].reference_generate(seed, SPEC_WARM)
            prompts.append(np.concatenate([seed, np.asarray(warm)]))
        return prompts

    def row_slices(tree, row):
        """{path: tensor} of what slot ``row`` owns in a cache tree: its
        ``pos``, its rows of the dense KV and state leaves and, paged, the
        arena blocks its block-table row maps."""
        table = tree.get("block_table")
        blocks = None
        if table is not None:
            blocks = torch.tensor([b for b in table[row].tolist() if b >= 0],
                                  dtype=torch.long, device=dev)
        out = {}
        for path, leaf in cache_leaves(tree):
            if path[0] == "pos":
                out[path] = leaf[row]
            elif path[0] != "block_table":
                axis = leaf_axis(path)
                out[path] = (leaf.index_select(axis, blocks)
                             if leaf_kind(path) == "kv" and blocks is not None
                             else leaf.select(axis, row))
        return out

    def verify_rollback(eng, last):
        """On the card, through the engine's replays: rows 0-2 verify
        drafts whose first t = 0, k/2 and k are the model's own tokens, row
        3 random drafts.  Each row's cache after the verify must be
        bit-equal to its accepted tokens fed through the decode replay one
        at a time, and the verify replay to its eager function."""
        cfg, k = eng.cfg, SPEC_K
        decode, verify = eng.programs["decode"], eng.programs["verify"]
        snap = clone_tree(eng.caches)
        cont, tok = [], last
        for _ in range(k + 1):
            _, nt, _ = decode(eng.params, eng.caches, tok)
            tok = nt.clone()
            cont.append(tok[:, 0])
        cont = torch.stack(cont, 1)
        gen = torch.Generator(device="cpu").manual_seed(6)
        drafts = torch.randint(1, cfg.vocab_size, (BATCH, k), generator=gen,
                               dtype=torch.int32).to(dev)
        for row, t in enumerate((0, k // 2, k)):
            drafts[row, :t] = cont[row, :t]
            drafts[row, t:] = (cont[row, t:k] + 1) % cfg.vocab_size
        tokens = torch.cat([last, drafts], 1)
        copy_tree(eng.caches, snap)
        _, ys, n_new = verify(eng.params, eng.caches, tokens)
        ys, n_new = ys.clone(), n_new.clone()
        after = clone_tree(eng.caches)
        eager = clone_tree(snap)
        _, ys_e, n_e = verify.program.fn(eng.params, eager, tokens)
        diffs = [f"eager: cache {p}" for p in tree_diffs(
            torch, without_sink(after), without_sink(eager))]
        if not (torch.equal(ys, ys_e) and torch.equal(n_new, n_e)):
            diffs.append("eager: ys or n_new")
        accepted = n_new.tolist()
        if accepted[:3] != [1, k // 2 + 1, k + 1]:
            diffs.append(f"n_new {accepted}")
        feed = torch.cat([last, cont[:, :k]], 1)
        for n in sorted(set(accepted)):
            copy_tree(eng.caches, snap)
            for j in range(n):
                decode(eng.params, eng.caches, feed[:, j:j + 1].contiguous())
            for row in (r for r, a in enumerate(accepted) if a == n):
                if not torch.equal(ys[row, :n], cont[row, :n]):
                    diffs.append(f"row {row}: accepted tokens")
                seq = row_slices(eng.caches, row)
                diffs += [f"row {row} ({n} accepted): {'/'.join(p)}"
                          for p, x in row_slices(after, row).items()
                          if not torch.equal(x, seq[p])]
        copy_tree(eng.caches, snap)
        torch.cuda.synchronize()
        if diffs:
            raise AssertionError(f"{eng.arch}: verify rollback: {diffs[:8]}")
        return {"n_new": accepted, "bit_equal_sequential": True,
                "graph_equals_eager": True}

    def serve_spec(out, arch, per_pass, prompts, paged=False):
        """The speculative engine (k = 3, n-gram 2) on phase 8-11's params
        beside that phase's step engine: lookup prompts, then the same with
        every step forced through verify; rollback and graph == eager on
        the card; verify's replay timed beside the decode step's."""
        name = f"{arch}/paged/spec" if paged else f"{arch}/spec"
        kw = {"spec": SpecConfig(k=SPEC_K, ngram=SPEC_NGRAM)}
        if paged:
            kw["paging"] = PagingConfig(kv_block=PAGED_BLOCK,
                                        arena_blocks=PAGED_ARENA,
                                        timeslice=PAGED_TIMESLICE)
        eng, info = boot(arch, **kw)
        one = eng.programs["decode"].program.launches
        multi = eng.programs["verify"].program.launches
        if multi != {k: (SPEC_K + 1) * v for k, v in one.items()}:
            raise AssertionError(f"{arch}: a verify replay launches {multi}, "
                                 f"not {SPEC_K + 1} x {one}")
        work = [(p, SPEC_MAX_NEW, 0.0) for p in prompts]
        base = serve_counted(served[arch], work)
        reqs, stats, launches, routes = serve_counted(eng, work)
        check_launches(name, per_pass, stats, launches, routes,
                       {"spec_steps": SPEC_K + 1})
        check_streams(name, reqs, base[0])
        real = serve_mod.NGramProposer
        serve_mod.NGramProposer = ForcedProposer
        try:
            freqs, fstats, flaunch, froutes = serve_counted(eng, work)
        finally:
            serve_mod.NGramProposer = real
        check_launches(f"{name}/forced", per_pass, fstats, flaunch, froutes,
                       {"spec_steps": SPEC_K + 1})
        if fstats["spec_steps"] != fstats["decode_steps"]:
            raise AssertionError(f"{name}: forced drafts, yet "
                                 f"{fstats['decode_steps']} dispatches for "
                                 f"{fstats['spec_steps']} verifies")
        if [r.generated for r in freqs] != [r.generated for r in reqs]:
            raise AssertionError(f"{name}: forced-draft streams differ")
        if paged:
            eng.pager.check_invariants()
            rep = eng.pager.report()
            out.update(invariants=True, grown_blocks=rep["grown_blocks"],
                       reclaimed_blocks=rep["reclaimed_blocks"])
        last = fill_slots(eng, 7)
        rollback = verify_rollback(eng, last)
        drafts = torch.cat([last, last.repeat(1, SPEC_K)], 1)
        vtimed, backup = timed_replays(eng, "verify", (drafts,), 5)
        dtimed, _ = timed_replays(eng, "decode", (last,), 5)
        copy_tree(eng.caches, backup)
        unmap_slots(eng)
        ratio = vtimed["events_device_ms_per_step"] / \
            ((SPEC_K + 1) * dtimed["events_device_ms_per_step"])
        prog = info["programs"]["verify"]
        out.update(
            model=arch, k=SPEC_K, ngram=SPEC_NGRAM, boot=info,
            requests=len(reqs), prompt_len=len(prompts[0]),
            max_new=SPEC_MAX_NEW, accept_rate=stats["accept_rate"],
            spec_steps=stats["spec_steps"],
            draft_tokens=stats["draft_tokens"],
            decode_steps=stats["decode_steps"], tokens=stats["tokens"],
            tok_per_s=stats["tok_per_s"],
            step_tok_per_s=base[1]["tok_per_s"],
            step_decode_steps=base[1]["decode_steps"],
            forced={k: fstats[k] for k in ("accept_rate", "spec_steps",
                                           "tok_per_s")},
            launches_per_verify=multi, launches_per_decode_step=one,
            rollback=rollback, verify=vtimed, decode_step=dtimed,
            verify_over_k1_decode_steps=ratio,
            streams_equal_step_engine_and_reference=True, card=smi)
        print(f"{name}: {stats['draft_tokens']} drafts, accept rate "
              f"{stats['accept_rate']:.3f}, tok/s "
              f"{stats['tok_per_s']:.1f} (non-speculative "
              f"{base[1]['tok_per_s']:.1f}), verify "
              f"{vtimed['events_device_ms_per_step']:.3f} ms against "
              f"{SPEC_K + 1} x decode "
              f"{dtimed['events_device_ms_per_step']:.3f} ms ({ratio:.3f}x), "
              f"capture {prog['compile_s']:.3f} s, graph pool "
              f"{prog['graph_pool_mib']:.1f} MiB", flush=True)

    def serve_spec_horizon(out, arch, prompts):
        """Both at once, as the engine entry point takes them
        (``EngineConfig(spec=SpecConfig(k=3), horizon=HorizonConfig(16))``):
        a step with no draft in any slot falls back to a fused horizon.
        Streams against the step engine and ``reference_generate``,
        launches exact with both programs' replays counted."""
        name = f"{arch}/spec+horizon"
        eng, info = boot(arch, spec=SpecConfig(k=SPEC_K, ngram=SPEC_NGRAM),
                         horizon=HorizonConfig(HORIZON))
        work = [(p, SPEC_MAX_NEW, 0.0) for p in prompts]
        base = serve_counted(served[arch], work)
        reqs, stats, launches, routes = serve_counted(eng, work)
        check_launches(name, serve_passes[arch], stats, launches, routes,
                       {"spec_steps": SPEC_K + 1, "horizon_steps": HORIZON})
        check_streams(name, reqs, base[0])
        out.update(model=arch, k=SPEC_K, horizon=HORIZON, boot=info,
                   **{k: stats[k] for k in (
                       "tok_per_s", "decode_steps", "spec_steps",
                       "horizon_steps", "draft_tokens", "accept_rate",
                       "dispatches_per_token")},
                   step_tok_per_s=base[1]["tok_per_s"],
                   streams_equal_step_engine_and_reference=True, card=smi)
        print(f"{name}: {stats['spec_steps']} verifies and "
              f"{stats['horizon_steps']} horizons of {stats['decode_steps']} "
              f"dispatches, tok/s {stats['tok_per_s']:.1f} (non-speculative "
              f"{base[1]['tok_per_s']:.1f})", flush=True)

    with phase("serve_spec") as out:
        qwen_prompts = lookup_prompts("qwen3-0.6b")
        for arch in ("qwen3-0.6b", "mamba2-130m", "recurrentgemma-2b",
                     "olmoe-1b-7b"):
            out[arch] = {}
            serve_spec(out[arch], arch, serve_passes[arch],
                       qwen_prompts if arch == "qwen3-0.6b"
                       else lookup_prompts(arch))
        out["qwen3-0.6b/paged"] = {}
        serve_spec(out["qwen3-0.6b/paged"], "qwen3-0.6b", qwen_pass,
                   qwen_prompts, paged=True)
        out["qwen3-0.6b/spec+horizon"] = {}
        serve_spec_horizon(out["qwen3-0.6b/spec+horizon"], "qwen3-0.6b",
                           qwen_prompts)

    # -- 16-17. prefix sharing and burst admission ------------------------
    from repro_torch.engine_config import PrefixConfig

    def reference_streams(arch, prompts, max_new, max_len, prefill_len):
        """Each prompt through a batch-1 dense engine of this geometry on
        phase 8-11's params: what ``reference_generate`` of an engine of
        that ``max_len`` and ``prefill_len`` runs (built once for all the
        engines of one geometry)."""
        ref = ServingEngine(arch, EngineConfig(
            reduced=False, batch=1, max_len=max_len, prefill_len=prefill_len,
            clock="step"), device="cuda", params=served[arch].params)
        streams = []
        for p in prompts:
            req = ref.submit(p, max_new)
            ref.run()
            ref.drain_completed()
            streams.append(req.generated)
        return ref, streams

    def offset_vs_eager(eng, prompt, offset, slot=0):
        """One ``prefill_offset`` replay against its eager function on a
        clone of the same caches, the slot mapped through the pager by a
        fake rid with ``prompt``'s published head: the last logits and
        every cache leaf (the arena without its sink) must be bit-equal.
        Returns the replay's last logits; the caches and the pager are
        restored."""
        shared = eng.pager.match_prefix(prompt)
        n = eng._blocks_needed(len(prompt), 1)
        eng.caches = eng.pager.admit(-1, n, slot, eng.caches, shared=shared)
        tokens = torch.zeros((1, eng.prefix_suffix), dtype=torch.int32)
        tokens[0, :len(prompt) - offset] = torch.from_numpy(
            np.asarray(prompt[offset:], np.int32))
        tokens = tokens.to(dev)
        backup = clone_tree(eng.caches)
        prog = eng.programs["prefill_offset"]
        _, last = prog(eng.params, eng.caches, tokens, slot, offset,
                       len(prompt))
        last = last.clone()
        eager = clone_tree(backup)
        _, last_e = prog.program.fn(eng.params, eager, tokens, slot, offset,
                                    len(prompt))
        diffs = [f"cache {p}" for p in tree_diffs(
            torch, without_sink(eng.caches), without_sink(eager))]
        if not torch.equal(last, last_e):
            diffs.append("last logits")
        copy_tree(eng.caches, backup)
        eng.caches = eng.pager.release(-1, slot, eng.caches)
        eng.pager.check_invariants()
        torch.cuda.synchronize()
        if diffs:
            raise AssertionError(f"{eng.arch}: the prefill_offset replay and "
                                 f"its eager function differ: {diffs[:8]}")
        return last

    def serve_prefix_bench(out):
        """``benchmarks/bench_prefix.py``'s workload at full width on
        qwen3-0.6b: a 257-token popular prompt, kv_block 8 (32 shared
        blocks, a 1-token suffix), max_suffix 1, batch 2; one cold request,
        then 4 warm ones, after an untimed cold + warm pair on another
        prompt.  Streams against the batch-1 reference of this geometry,
        every shared block mapped by >= 2 requests, launches exact, the
        prefill_offset replay == eager, and its last logits == the
        reference's cold prefill_slot logits at the same position, bit for
        bit."""
        arch, max_len, plen, prefill_len, n_warm = "qwen3-0.6b", 320, 257, \
            264, 4
        eng, info = boot(arch, batch=2, max_len=max_len,
                         prefill_len=prefill_len,
                         paging=PagingConfig(kv_block=PAGED_BLOCK),
                         prefix=PrefixConfig(max_suffix=1))
        if not eng._prefix_tier1:
            raise AssertionError(f"{arch} does not take the warm path")
        rng = np.random.default_rng(0)
        warmup = rng.integers(1, eng.cfg.vocab_size, size=plen)
        base = rng.integers(1, eng.cfg.vocab_size, size=plen)
        for p in (warmup, warmup.copy()):
            eng.submit(p, max_new=2)
            eng.run()
        ops.reset_launch_counts()
        reqs, runs = [], []
        for p in [base] + [base.copy() for _ in range(n_warm)]:
            req = eng.submit(p, max_new=4)
            runs.append(eng.run())
            reqs.append(req)
        launches, routes = ops.launch_counts(), ops.route_counts()
        stats = {k: sum(r[k] for r in runs)
                 for k in ("decode_steps", "admitted", "warm_admissions",
                           "prefix_admissions", "prefix_tokens_reused")}
        check_launches(f"{arch}/prefix/bench", qwen_pass, stats, launches,
                       routes, {})
        shared_blocks = (plen - 1) // PAGED_BLOCK
        if stats["warm_admissions"] != n_warm:
            raise AssertionError(f"{arch}: {stats} warm admissions, not "
                                 f"{n_warm}")
        popular = [sb for sb in eng.pager._shared.values() if sb.hits >= 2]
        if len(popular) < shared_blocks:
            raise AssertionError(f"{len(popular)} shared blocks mapped by >= "
                                 f"2 requests, not {shared_blocks}")
        ref, want = reference_streams(arch, [base], 4, max_len, prefill_len)
        if any(r.generated != want[0] for r in reqs):
            RECORD.setdefault("stream_mismatch", {})[f"{arch}/prefix"] = [
                r.generated for r in reqs] + want
            raise AssertionError(f"{arch}: a prefix stream differs from the "
                                 f"cold reference: "
                                 f"{[r.generated for r in reqs]} vs {want}")
        eng.pager.check_invariants()
        prog = eng.syscore.report()["programs"]["prefill_offset"]
        if prog["source"] != "cuda_graph":
            raise AssertionError(f"prefill_offset is not a graph: {prog}")
        offset = shared_blocks * PAGED_BLOCK
        last = offset_vs_eager(eng, base, offset)
        # the engine-level proof: the warm suffix's logits are the cold
        # prefill's at the same position, bit for bit
        prompt = torch.zeros((1, prefill_len), dtype=torch.int32)
        prompt[0, :plen] = torch.from_numpy(base.astype(np.int32))
        _, cold_last = ref.programs["prefill_slot"](
            ref.params, ref.caches, prompt.to(dev), 0, plen)
        if not torch.equal(last, cold_last):
            raise AssertionError(f"{arch}: warm last logits differ from the "
                                 f"cold prefill's (max abs "
                                 f"{float((last.float() - cold_last.float()).abs().max())})")
        # a warm and a cold admission's replays on the host clock with a
        # sync (median of 5), the caches restored after each
        shared = eng.pager.match_prefix(base)
        eng.caches = eng.pager.admit(-1, eng._blocks_needed(plen, 1), 0,
                                     eng.caches, shared=shared)
        suffix = torch.zeros((1, 1), dtype=torch.int32)
        suffix[0, 0] = int(base[offset])
        suffix = suffix.to(dev)
        backup = clone_tree(eng.caches)
        prompt = prompt.to(dev)
        calls = {"warm": lambda: eng.programs["prefill_offset"](
                     eng.params, eng.caches, suffix, 0, offset, plen),
                 "cold": lambda: eng.programs["prefill_slot"](
                     eng.params, eng.caches, prompt, 0, plen)}
        warm_ms = median_wall_ms(torch, calls["warm"], 5)
        cold_ms = median_wall_ms(torch, calls["cold"], 5)
        # where each replay's device time goes (the profiler last)
        timed = {k: time_calls(torch, c, 5) for k, c in calls.items()}
        profiles = {k: profile_calls(torch, c, 3, timed[k])
                    for k, c in calls.items()}
        copy_tree(eng.caches, backup)
        eng.caches = eng.pager.release(-1, 0, eng.caches)
        eng.pager.check_invariants()
        cold_ttft = reqs[0].ttft_s * 1e3
        warm_ttft = [r.ttft_s * 1e3 for r in reqs[1:]]
        rep = eng.pager.report()["prefix"]
        out.update(
            model=arch, batch=2, max_len=max_len, prefill_len=prefill_len,
            prompt_len=plen, kv_block=PAGED_BLOCK, max_suffix=1,
            shared_blocks=shared_blocks, warm_requests=n_warm, boot=info,
            ttft_cold_ms=cold_ttft, ttft_warm_ms=warm_ttft,
            ttft_warm_over_cold=min(warm_ttft) / cold_ttft,
            replay_wall_ms={"prefill_offset": warm_ms,
                            "prefill_slot": cold_ms,
                            "ratio": warm_ms / cold_ms},
            replay_profile={"prefill_offset": profiles["warm"],
                            "prefill_slot": profiles["cold"]},
            popular_blocks=len(popular), prefix=rep, **stats,
            launches=launches, graph_equals_eager=True,
            warm_last_equals_cold_prefill=True,
            streams_equal_reference=True, card=smi)
        print(f"{arch} prefix bench: TTFT cold {cold_ttft:.3f} ms, warm "
              f"{min(warm_ttft):.3f} ms ({min(warm_ttft) / cold_ttft:.3f}x); "
              f"replays {warm_ms:.3f} / {cold_ms:.3f} ms; prefill_offset "
              f"capture {info['programs']['prefill_offset']['compile_s']:.3f}"
              f" s, graph pool "
              f"{info['programs']['prefill_offset']['graph_pool_mib']:.1f} "
              f"MiB", flush=True)
        del eng, ref

    def sharing_workload():
        """``tests/test_prefix.py``'s prompts at kv_block 8 (lengths x2): a
        cold base, a repeat (warm), two divergences inside the warm suffix
        window, one long-suffix divergence (tier 2), a fresh prompt."""
        rng = np.random.default_rng(0)
        base = rng.integers(1, 500, size=24)
        fresh = rng.integers(1, 500, size=20)
        alt = rng.integers(1, 500, size=32)
        return [base, base.copy(), np.concatenate([base[:18], alt[:6]]),
                np.concatenate([base[:16], alt[:14]]),
                np.concatenate([base[:8], alt[:20]]), fresh]

    def serve_prefix_matrix(out, arch, mode, per_pass, want):
        """The sharing workload through one full-width prefix engine (batch
        2, max_len 64, prefill_len 32, kv_block 8, max_suffix 16) in
        ``mode``: streams against ``want`` (the batch-1 reference),
        warm / tier-2 counts, invariants, launches exact (a
        ``prefill_offset`` counts as an admission: the same K2 products and
        one K1 per layer), hostcall 10 per prefix admission, and after the
        speculative run every resident shared block equal to its store
        copy."""
        name = f"{arch}/prefix/{mode}"
        kw = {"spec": SpecConfig(k=SPEC_K, ngram=SPEC_NGRAM)} \
            if mode == "spec" else \
            {"horizon": HorizonConfig(HORIZON)} if mode == "horizon" else {}
        eng, info = boot(arch, batch=2, max_len=64, prefill_len=32,
                         paging=PagingConfig(kv_block=PAGED_BLOCK),
                         prefix=PrefixConfig(), **kw)
        prompts = sharing_workload()
        reqs, stats, launches, routes = serve_counted(
            eng, [(p, PREFIX_MAX_NEW, 0.0) for p in prompts])
        fused = {"spec": {"spec_steps": SPEC_K + 1},
                 "horizon": {"horizon_steps": HORIZON}}.get(mode, {})
        check_launches(name, per_pass, stats, launches, routes, fused)
        got = [r.generated for r in reqs]
        if got != want:
            RECORD.setdefault("stream_mismatch", {})[name] = {
                "engine": got, "reference": want}
            raise AssertionError(f"{name}: streams differ from the "
                                 f"reference: {got} vs {want}")
        eng.pager.check_invariants()
        if eng._prefix_tier1:
            if stats["warm_admissions"] < 3:
                raise AssertionError(f"{name}: {stats}")
            warm_runs = eng.programs["prefill_offset"].stats.executions
            if warm_runs != stats["warm_admissions"]:
                raise AssertionError(f"{name}: {warm_runs} prefill_offset "
                                     f"runs for {stats}")
        elif stats["warm_admissions"] != 0 or \
                stats["prefix_admissions"] < 3:
            raise AssertionError(f"{name}: tier 2 expected: {stats}")
        hits = eng.syscore.report()["hostcalls"]["metrics"].get(10, {})
        if hits.get("count", 0) != stats["prefix_admissions"]:
            raise AssertionError(f"{name}: {hits} prefix-hit metrics for "
                                 f"{stats['prefix_admissions']} admissions")
        intact = 0
        for sb in eng.pager._shared.values():
            if sb.phys is None:
                continue
            live = [leaf.index_select(leaf_axis(path), torch.tensor(
                [sb.phys], device=dev)).cpu()
                for path, leaf in cache_leaves(eng.caches)
                if leaf_kind(path) == "kv"]
            if not all(torch.equal(a, b) for a, b in zip(
                    live, eng.prefix_store.get(sb.key))):
                raise AssertionError(f"{name}: shared block {sb.key} differs "
                                     f"from its store copy")
            intact += 1
        if not eng._prefix_tier1:
            # a tier-2 admission (the base prompt over its published head)
            # beside the same prompt unshared, the same program either way:
            # replays on the host clock with a sync, median of 5
            base = prompts[0]
            tokens = torch.zeros((1, 32), dtype=torch.int32)
            tokens[0, :len(base)] = torch.from_numpy(base.astype(np.int32))
            tokens = tokens.to(dev)

            def admit_ms(shared):
                eng.caches = eng.pager.admit(
                    -1, eng._blocks_needed(len(base), 1), 0, eng.caches,
                    shared=shared)
                backup = clone_tree(eng.caches)
                ms = median_wall_ms(torch, lambda: eng.programs[
                    "prefill_slot"](eng.params, eng.caches, tokens, 0,
                                    len(base)), 5)
                copy_tree(eng.caches, backup)
                eng.caches = eng.pager.release(-1, 0, eng.caches)
                return ms
            out["tier2_admission_ms"] = {
                "shared_head": admit_ms(eng.pager.match_prefix(base)),
                "unshared": admit_ms([])}
            eng.pager.check_invariants()
        out.update(model=arch, mode=mode, boot=info,
                   **{k: stats[k] for k in (
                       "prefix_admissions", "warm_admissions",
                       "prefix_tokens_reused", "decode_steps", "admitted",
                       "tok_per_s")},
                   horizon_steps=stats.get("horizon_steps"),
                   spec_steps=stats.get("spec_steps"),
                   prefix=eng.pager.report()["prefix"],
                   shared_blocks_equal_store=intact, invariants=True,
                   streams_equal_reference=True, card=smi)
        print(f"{name}: {stats['prefix_admissions']} prefix admissions, "
              f"{stats['warm_admissions']} warm, "
              f"{stats['prefix_tokens_reused']} tokens reused", flush=True)
        del eng

    with phase("serve_prefix") as out:
        out["bench"] = {}
        serve_prefix_bench(out["bench"])
        for arch, modes in (("qwen3-0.6b", ("plain", "spec", "horizon")),
                            ("recurrentgemma-2b", ("plain",)),
                            ("olmoe-1b-7b", ("plain",))):
            # (the reference engine is not kept: it holds arch's params)
            want = reference_streams(arch, sharing_workload(),
                                     PREFIX_MAX_NEW, 64, 32)[1]
            for mode in modes:
                out[f"{arch}/{mode}"] = {}
                serve_prefix_matrix(out[f"{arch}/{mode}"], arch, mode,
                                    serve_passes[arch], want)
            gc.collect()

    def serve_burst(out, arch, per_pass):
        """Burst admission at full width (batch 4, max_len 512): 4 requests
        at step 0 with budgets that end one at a time, then 4 more that
        refill the freed slots one by one.  ``prefill`` must run once,
        every stream equal ``reference_generate``, launches be exact (a
        burst counts as one admission's launches: K2 at M = 4 x 256 and
        one K1 or K4 per layer over 4 rows), every K1 and K4 call take the
        wgmma route, and a ``prefill`` replay equal its eager function."""
        eng, info = boot(arch, group_prefill=True)
        rng = np.random.default_rng(8)
        work = [(rng.integers(1, eng.cfg.vocab_size, size=int(n)), int(m), a)
                for n, m, a in zip((200, 57, 120, 31, 90, 16, 140, 64),
                                   (8, 14, 20, 26, 12, 12, 12, 12),
                                   (0, 0, 0, 0, 1, 2, 3, 4))]
        reqs, stats, launches, routes = serve_counted(eng, work)
        progs = eng.syscore.report()["programs"]
        if progs["prefill"]["executions"] != 1 or \
                progs["prefill_slot"]["executions"] != 4:
            raise AssertionError(f"{arch}: prefill ran "
                                 f"{progs['prefill']['executions']} times, "
                                 f"prefill_slot "
                                 f"{progs['prefill_slot']['executions']}")
        # the burst placed 4 requests with one program's launches
        counted = dict(stats, admitted=stats["admitted"] - 3)
        check_launches(f"{arch}/burst", per_pass, counted, launches, routes,
                       {})
        ref_eng = served[arch]
        mism = [r.rid for r in reqs if r.generated !=
                ref_eng.reference_generate(r.prompt, r.max_new)]
        if mism:
            raise AssertionError(f"{arch}: burst streams {mism} differ from "
                                 f"reference_generate")
        # the prefill replay against its eager function, and its time
        # beside 4 prefill_slot replays of the same prompts
        tokens = torch.zeros((BATCH, PREFILL_LEN), dtype=torch.int32)
        lens = [len(p) for p, _, _ in work[:BATCH]]
        for i, (p, _, _) in enumerate(work[:BATCH]):
            tokens[i, :len(p)] = torch.from_numpy(p.astype(np.int32))
        tokens = tokens.to(dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        backup = clone_tree(eng.caches)
        prog = eng.programs["prefill"]
        _, last = prog(eng.params, eng.caches, tokens, lengths)
        last = last.clone()
        eager = clone_tree(backup)
        _, last_e = prog.program.fn(eng.params, eager, tokens, lengths)
        diffs = [f"cache {p}" for p in tree_diffs(torch, eng.caches, eager)]
        if not torch.equal(last, last_e):
            diffs.append("last logits")
        if diffs:
            raise AssertionError(f"{arch}: the prefill replay and its eager "
                                 f"function differ: {diffs[:8]}")
        burst_ms = median_wall_ms(torch, lambda: prog(
            eng.params, eng.caches, tokens, lengths), 5)
        slot_prog = eng.programs["prefill_slot"]

        def four():
            for i in range(BATCH):
                slot_prog(eng.params, eng.caches, tokens[i:i + 1], i,
                          lens[i])
        slots_ms = median_wall_ms(torch, four, 5)
        copy_tree(eng.caches, backup)
        out.update(model=arch, batch=BATCH, boot=info, requests=len(reqs),
                   **{k: stats[k] for k in ("decode_steps", "admitted",
                                            "refill_admissions",
                                            "tok_per_s")},
                   prefill_executions=1, launches=launches,
                   burst_admission_ms=burst_ms,
                   four_prefill_slot_ms=slots_ms,
                   graph_equals_eager=True, streams_equal_reference=True,
                   card=smi)
        print(f"{arch} burst: prefill of {BATCH} {burst_ms:.3f} ms, "
              f"4 prefill_slot {slots_ms:.3f} ms", flush=True)
        del eng

    with phase("serve_burst") as out:
        for arch in ("qwen3-0.6b", "mamba2-130m"):
            out[arch] = {}
            serve_burst(out[arch], arch, serve_passes[arch])

    # -- 18-21. the dense and vision-backbone configs at full width --------
    # no later phase reuses phases 8-11's engines: free their ~21 GB of
    # params first (internvl2's are ~40 GB); each new phase frees its own
    served.clear()
    gc.collect()
    torch.cuda.empty_cache()
    published = {"llama3.2-3b": (28, 3072, 129_024),
                 "gemma3-4b": (34, 2560, 262_144),
                 "gemma3-12b": (48, 3840, 262_144),
                 "internvl2-26b": (48, 6144, 94_208)}

    def serve_new(out, arch, plens, arrivals, max_new):
        """``serve_full`` for one of phases 18-21's configs: streams equal
        ``reference_generate``, launches exact (K2 7 L + 1 a pass, K1 L an
        admission, K3-K5 none), every K1 call on the wgmma route, graph ==
        eager; then (n_layers, d_model, padded_vocab) against the
        published config."""
        eng, _, path_launches[arch] = serve_full(out, arch, plens, arrivals,
                                                 max_new, new_passes[arch])
        c = eng.cfg
        if (c.n_layers, c.d_model, c.padded_vocab) != published[arch]:
            raise AssertionError(f"{arch} is not at its published width: "
                                 f"{c}")
        if eng.params["embed"].shape != (c.padded_vocab, c.d_model) or \
                ("lm_head" in eng.params) == c.tie_embeddings:
            raise AssertionError(f"{arch}: head leaves "
                                 f"{sorted(eng.params)}")
        return eng

    # phase 19's ring engine: gemma3-4b's window is 1024, so "L" caches
    # are rings when max_len >= 1024; an engine needs prefill_len <
    # max_len, so prefill_len is the window and max_len 1152
    RING_PREFILL_LEN, RING_MAX_LEN, RING_NEW = 1024, 1152, 96

    def serve_ring(out, arch):
        """Two requests of 960 and 1000 tokens, 96 new each, at batch 2
        through an engine whose "L" caches are rings of ``local_window``
        slots ("G" caches flat, ``RING_MAX_LEN``): decode writes past
        position 1024, so each ring wraps.  Streams against
        ``reference_generate`` of this geometry, launches exact."""
        eng, info = boot(arch, batch=2, max_len=RING_MAX_LEN,
                         prefill_len=RING_PREFILL_LEN)
        cfg = eng.cfg
        unit = transformer.split_layers(cfg)[0]
        lens = {unit[i]: eng.caches["groups"][f"slot{i}"]["k"].shape[2]
                for i in range(len(unit))}
        if lens != {"L": cfg.local_window, "G": RING_MAX_LEN}:
            raise AssertionError(f"{arch}: cache slots by layer kind {lens}")
        rng = np.random.default_rng(9)
        work = [(rng.integers(1, cfg.vocab_size, size=n), RING_NEW, 0.0)
                for n in (960, 1000)]
        reqs, stats, launches, routes = serve_counted(eng, work)
        check_launches(f"{arch}/ring", new_passes[arch], stats, launches,
                       routes, {})
        last_pos = max(r.prompt_len + len(r.generated) - 1 for r in reqs)
        if last_pos <= cfg.local_window:
            raise AssertionError(f"{arch}: decode ended at {last_pos}, the "
                                 f"rings did not wrap")
        mism = [r.rid for r in reqs if r.generated !=
                eng.reference_generate(r.prompt, r.max_new)]
        if mism:
            raise AssertionError(f"{arch}: ring streams {mism} differ from "
                                 f"reference_generate")
        out.update(model=arch, batch=2, max_len=RING_MAX_LEN,
                   prefill_len=RING_PREFILL_LEN, slots_by_kind=lens,
                   prompt_lens=[r.prompt_len for r in reqs],
                   max_new=RING_NEW, last_position=last_pos, boot=info,
                   **{k: stats[k] for k in ("decode_steps", "admitted",
                                            "tok_per_s", "decode_p50_ms")},
                   launches=launches, streams_equal_reference=True, card=smi)
        print(f"{arch} ring: {len(reqs)} requests to position {last_pos} "
              f"over rings of {cfg.local_window}, tok/s "
              f"{stats['tok_per_s']:.1f}", flush=True)

    def serve_frontend(out, eng):
        """internvl2's prefix-embedding path on the served params: the
        whole-batch ``prefill`` program (``steps.make_prefill_step``) with
        ``frontend_tokens`` (256) patch embeddings (bf16, numpy seed 0)
        before 200 text tokens (S = 456; row 1 of batch 2 has 150), its
        own Syscore capturing it at batch 2 and at batch 1, then 16 greedy
        ``decode_step``s from its cache.  The logits must be finite, batch
        1 equal row 0 of batch 2 bit for bit (prefill logits and the 16
        tokens) and each replay its eager function; K2 and K1 launch as a
        pass and an admission, every K1 on the wgmma route."""
        from repro_torch import steps as steps_lib
        from repro_torch.core.syscore import ProgramSpec, Syscore
        cfg = eng.cfg
        p, s_tok, decode_steps = cfg.frontend_tokens, 200, 16
        rng = np.random.default_rng(0)
        pre = torch.from_numpy(rng.standard_normal(
            (2, p, cfg.d_model)).astype(np.float32)).to(dev, torch.bfloat16)
        tok = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, (2, s_tok)).astype(np.int32))
        tok[1, 150:] = 0
        tok = tok.to(dev)
        lengths = torch.tensor([p + s_tok, p + 150], dtype=torch.int32,
                               device=dev)
        syscore = Syscore(dev)
        runs = {}
        for b in (2, 1):
            caches = transformer.init_cache(cfg, b, MAX_LEN, device=dev)
            args = (tok[:b].clone(), lengths[:b].clone(), pre[:b].clone())
            prog = syscore.hot_load(ProgramSpec(
                f"prefill_b{b}", steps_lib.make_prefill_step(cfg),
                resident=(eng.params, caches), inputs=args))
            if prog.program.source != "cuda_graph":
                raise AssertionError(f"prefill at batch {b} is not a "
                                     f"captured graph")
            before = clone_tree(caches)
            ops.reset_launch_counts()
            _, last = prog(eng.params, caches, *args)
            launches, routes = ops.launch_counts(), ops.route_counts()
            last = last.clone()
            eager = clone_tree(before)
            _, last_e = prog.program.fn(eng.params, eager, *args)
            diffs = [f"cache {q}" for q in tree_diffs(torch, caches, eager)]
            if not torch.equal(last, last_e):
                diffs.append("last logits")
            if diffs:
                raise AssertionError(f"internvl2 prefill at batch {b}: the "
                                     f"replay and its eager function differ:"
                                     f" {diffs[:8]}")
            del before, eager
            want = {"matmul": 7 * cfg.n_layers + 1,
                    "flash_attention": cfg.n_layers, "moe_ffn": 0,
                    "ssd_scan": 0, "rglru_scan": 0}
            if launches != want or \
                    routes["flash_attention"]["wgmma"] != cfg.n_layers:
                raise AssertionError(f"internvl2 prefill: launches "
                                     f"{launches}, routes {routes}")
            nt = transformer.greedy_token(cfg, last)[:, None]
            toks, finite = [nt[:, 0].clone()], bool(last.isfinite().all())
            for _ in range(decode_steps):
                logits, _ = transformer.decode_step(cfg, eng.params, caches,
                                                    nt)
                finite &= bool(logits.isfinite().all())
                nt = transformer.greedy_token(cfg, logits[:, 0])[:, None]
                toks.append(nt[:, 0].clone())
            if not finite:
                raise AssertionError(f"internvl2 frontend: non-finite "
                                     f"logits at batch {b}")
            runs[b] = {"last": last, "tokens": torch.stack(toks, 1),
                       "pos": caches["pos"].tolist(),
                       "capture_s": prog.program.stats.compile_s,
                       "graph_pool_mib":
                           prog.program.stats.graph_bytes / 2 ** 20}
            del caches
        bit_equal = {
            "prefill_logits": torch.equal(runs[1]["last"][0],
                                          runs[2]["last"][0]),
            "tokens": torch.equal(runs[1]["tokens"][0],
                                  runs[2]["tokens"][0])}
        if not all(bit_equal.values()):
            raise AssertionError(f"internvl2 frontend: batch 1 differs from "
                                 f"row 0 of batch 2: {bit_equal}")
        out.update(prefix_embeds=p, text_tokens=[s_tok, 150],
                   lengths=lengths.tolist(), decode_steps=decode_steps,
                   tokens_row0=runs[1]["tokens"][0].tolist(),
                   pos_after={b: r["pos"] for b, r in runs.items()},
                   batch1_equals_row0_of_batch2=bit_equal,
                   graph_equals_eager=True, logits_finite=True,
                   programs={f"prefill_b{b}": {
                       "capture_s": r["capture_s"],
                       "graph_pool_mib": r["graph_pool_mib"]}
                       for b, r in runs.items()}, card=smi)
        del syscore, runs

    with phase("serve_llama") as out:
        eng = serve_new(out, "llama3.2-3b",
                        [16, 200, 57, 120, 31, 180, 90, 140],
                        [0, 0, 0, 0, 3, 9, 20, 40], MAX_NEW)
        del eng

    with phase("serve_gemma3_4b") as out:
        arch = "gemma3-4b"
        served[arch] = serve_new(out, arch,
                                 [16, 200, 57, 120, 31, 180, 90, 140],
                                 [0, 0, 0, 0, 3, 9, 20, 40], MAX_NEW)
        # the family row at full width, on the same params
        per_pass = new_passes[arch]
        out["paged"] = {}
        serve_paged(out["paged"], arch, 8, per_pass)
        out["horizon"] = {}
        serve_horizon(out["horizon"], arch, per_pass,
                      [16, 200, 57, 120, 31, 180], [0, 0, 0, 0, 3, 9])
        out["spec"] = {}
        serve_spec(out["spec"], arch, per_pass, lookup_prompts(arch))
        want = reference_streams(arch, sharing_workload(), PREFIX_MAX_NEW,
                                 64, 32)[1]
        out["prefix"] = {}
        serve_prefix_matrix(out["prefix"], arch, "plain", per_pass, want)
        out["ring"] = {}
        serve_ring(out["ring"], arch)
        served.clear()
        gc.collect()

    with phase("serve_gemma3_12b") as out:
        eng = serve_new(out, "gemma3-12b", [16, 200, 57, 120, 31, 180],
                        [0, 0, 0, 2, 3, 9], MOE_MAX_NEW)
        del eng

    with phase("serve_internvl2") as out:
        # text only, as the reference's engine serves it; then the
        # frontend path through the prefill program
        eng = serve_new(out, "internvl2-26b", [16, 200, 57, 120, 31, 180],
                        [0, 0, 0, 2, 3, 9], MOE_MAX_NEW)
        out["frontend"] = {}
        serve_frontend(out["frontend"], eng)
        del eng

    # -- 22. seamless-m4t-medium, the encoder-decoder ----------------------
    def serve_seamless(out):
        """seamless-m4t-medium at full width in bf16, weights drawn on the
        card from seed 0, through the reference's entry points for the
        family (``steps.make_prefill_step``'s encdec branch and
        ``make_serve_step``'s ``serve_step_encdec``) hot-loaded as CUDA
        graphs (``steps.encdec_program_specs``): batch 4, frames (4, 500,
        1024) and prompts of 13 tokens from numpy seed 0, 48 greedy tokens
        a row (the prefill's and 47 decode steps').  Checks: both programs
        captured; launches exact (K1 36 a prefill, all SIMT, none a step;
        K2 217 a prefill, 109 a step; K3-K5 none); one prefill and 4
        decode steps through the graphs equal the eager functions bit for
        bit (logits, tokens, every cache leaf); each request alone at
        batch 1 gives its row's 48 tokens and prefill logits bit for bit;
        finite logits.  Reported: decode p50 and tok/s (host clock, each
        step ended by reading its tokens back), prefill ms, device time by
        kernel family and idle share of a decode step and of a prefill,
        K2's per step beside its bound and torch.matmul, memory."""
        arch = "seamless-m4t-medium"
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = encdec.init_params(sm, 0, device=dev)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        draw_peak = torch.cuda.max_memory_allocated()
        if (sm.n_enc_layers, sm.n_layers, sm.d_model, sm.padded_vocab) != \
                (12, 12, 1024, 258_048) or \
                params["lm_head"].dtype != torch.bfloat16:
            raise AssertionError(f"{arch} is not at its published width in "
                                 f"bf16: {sm}")
        param_bytes = sum(t.numel() * t.element_size()
                          for t in leaves(params))
        rng = np.random.default_rng(0)
        frames = torch.from_numpy((rng.standard_normal(
            (BATCH, SM_ENC, sm.d_model)) * 0.02).astype(np.float32)).to(
                dev, torch.bfloat16)
        prompts = torch.from_numpy(rng.integers(
            1, sm.vocab_size, (BATCH, SM_PROMPT)).astype(np.int32)).to(dev)

        def boot_programs(b):
            caches = encdec.init_cache(sm, b, SM_DEC_LEN, SM_ENC, device=dev)
            syscore = Syscore(dev)
            t1 = time.perf_counter()
            progs = {k_: syscore.hot_load(spec) for k_, spec in
                     steps_lib.encdec_program_specs(sm, params, caches,
                                                    SM_PROMPT).items()}
            torch.cuda.synchronize()
            report = syscore.report()["programs"]
            for name, prog in report.items():
                print(f"{arch} batch {b} {name}: source {prog['source']}, "
                      f"lower_s {prog['lower_s']:.4f}, compile_s "
                      f"{prog['compile_s']:.4f}", flush=True)
                if prog["source"] != "cuda_graph" or \
                        not prog["compile_s"] > 0:
                    raise AssertionError(f"{arch} {name} is not a captured "
                                         f"graph: {prog}")
            return syscore, caches, progs, time.perf_counter() - t1

        def generate(progs, caches, fr, pr):
            """A fresh cache, the prefill, then SM_NEW - 1 decode steps;
            returns the prefill's last logits, the (b, SM_NEW) tokens,
            host ms of the prefill and of each step (each ended by
            reading its tokens back) and whether every logit was
            finite."""
            for t in leaves(caches):
                t.zero_()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, last = progs["prefill"](params, caches, fr, pr)
            tok = transformer.greedy_token(sm, last)[:, None]
            toks = [tok.cpu()]
            prefill_ms = 1e3 * (time.perf_counter() - t1)
            last = last.clone()
            finite = bool(last.isfinite().all())
            step_ms = []
            for i in range(SM_NEW - 1):
                t1 = time.perf_counter()
                _, tok, logits = progs["decode"](params, caches, tok,
                                                 SM_PROMPT + i)
                toks.append(tok.cpu())
                step_ms.append(1e3 * (time.perf_counter() - t1))
                finite &= bool(logits.isfinite().all())
            return last, torch.cat(toks, 1), prefill_ms, step_ms, finite

        def exact(launches, routes, prefills, steps_):
            want = {name: step * steps_ + pre * prefills
                    for name, (step, pre) in sm_passes.items()}
            k1 = routes["flash_attention"]
            if launches != want or k1["simt"] != want["flash_attention"] \
                    or k1["wgmma"]:
                raise AssertionError(f"{arch}: launches {launches}, routes "
                                     f"{routes}, expected {want}, every K1 "
                                     f"call on the SIMT route")

        syscore, caches, progs, load_s = boot_programs(BATCH)
        after_boot = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        last4, toks4, prefill_ms, step_ms, finite = generate(
            progs, caches, frames, prompts)
        launches, routes = ops.launch_counts(), ops.route_counts()
        serve_peak = torch.cuda.max_memory_allocated()
        exact(launches, routes, 1, SM_NEW - 1)
        if not finite:
            raise AssertionError(f"{arch}: non-finite logits")
        # each request alone at batch 1: its row's tokens and prefill
        # logits, bit for bit
        syscore1, caches1, progs1, _ = boot_programs(1)
        ops.reset_launch_counts()
        alone = [generate(progs1, caches1, frames[r:r + 1].contiguous(),
                          prompts[r:r + 1].contiguous())
                 for r in range(BATCH)]
        exact(ops.launch_counts(), ops.route_counts(), BATCH,
              BATCH * (SM_NEW - 1))
        batch_invariant = {
            "prefill_logits": [torch.equal(a[0][0], last4[r])
                               for r, a in enumerate(alone)],
            "tokens": [torch.equal(a[1][0], toks4[r])
                       for r, a in enumerate(alone)]}
        if not all(batch_invariant["prefill_logits"] +
                   batch_invariant["tokens"]) or \
                not all(a[4] for a in alone):
            RECORD.setdefault("stream_mismatch", {})[arch] = {
                "batch4": toks4.tolist(),
                "alone": [a[1][0].tolist() for a in alone]}
            raise AssertionError(f"{arch}: batch 1 differs from its row of "
                                 f"batch 4: {batch_invariant}")
        del syscore1, caches1, progs1, alone
        # the graphs against the eager functions: one prefill and 4 decode
        # steps on a clone of the same caches
        eager = clone_tree(caches)
        prefill, decode = progs["prefill"], progs["decode"]
        _, last_g = prefill(params, caches, frames, prompts)
        _, last_e = prefill.program.fn(params, eager, frames, prompts)
        diffs = [] if torch.equal(last_g, last_e) else ["prefill: logits"]
        diffs += [f"prefill: cache {p}"
                  for p in tree_diffs(torch, caches, eager)]
        tok_g = transformer.greedy_token(sm, last_g)[:, None]
        tok_e = transformer.greedy_token(sm, last_e)[:, None]
        for i in range(4):
            pos = torch.tensor(SM_PROMPT + i, dtype=torch.int32, device=dev)
            _, tok_g, lg_g = decode(params, caches, tok_g, pos)
            _, tok_e, lg_e = decode.program.fn(params, eager, tok_e, pos)
            if not torch.equal(lg_g, lg_e):
                diffs.append(f"decode step {i}: logits")
            if not torch.equal(tok_g, tok_e):
                diffs.append(f"decode step {i}: tokens")
        diffs += [f"decode: cache {p}"
                  for p in tree_diffs(torch, caches, eager)]
        if diffs:
            raise AssertionError(f"{arch}: graph replay and eager run "
                                 f"differ: {diffs[:8]}")
        del eager
        # decode_attention's rows against the same rows alone, bit for bit
        # (a gate), at every ported attention layout and at cache lengths
        # on and off a multiple of 64 (500: the cross cache's), random
        # queries, caches and per-row lengths; beside them (reported) the
        # rows of the batched scores einsum, the form decode_attention
        # keeps only for lengths that are multiples of 64
        layouts = sorted({(c.n_heads, c.n_kv_heads, c.resolved_head_dim)
                          for c in map(registry.get_config,
                                       registry.PORTED_ARCHS)
                          if set(c.pattern_for_layers()) & {"G", "L"}})
        decode_rows = []
        for h, hk, d in layouts:
            for c_len in (64, 320, SM_ENC, 512, 1000, 1152):
                qx, kx, vx = (torch.randn(shape, generator=cgen,
                                          device=dev).to(torch.bfloat16)
                              for shape in ((BATCH, 1, h, d),
                                            (BATCH, c_len, hk, d),
                                            (BATCH, c_len, hk, d)))
                lens = torch.randint(c_len // 2, c_len + 1, (BATCH,),
                                     generator=cgen, device=dev,
                                     dtype=torch.int32)
                got = attn_mod.decode_attention(qx, kx, vx, lens)
                qg = qx.reshape(BATCH, hk, h // hk, d)
                s4 = torch.einsum("bhgd,bkhd->bhgk", qg, kx)
                decode_rows.append({
                    "H": h, "Hkv": hk, "D": d, "C": c_len,
                    "batched": c_len % attn_mod.BATCHED_CACHE_MULTIPLE == 0,
                    "rows_differing": sum(not torch.equal(
                        attn_mod.decode_attention(
                            qx[r:r + 1], kx[r:r + 1], vx[r:r + 1],
                            lens[r:r + 1])[0], got[r])
                        for r in range(BATCH)),
                    "scores_einsum_rows_differing": sum(not torch.equal(
                        torch.einsum("bhgd,bkhd->bhgk", qg[r:r + 1],
                                     kx[r:r + 1])[0], s4[r])
                        for r in range(BATCH))})
        del qx, kx, vx, qg, s4, got
        for r in decode_rows:
            emit({"decode_attention_rows": r})
        if any(r["rows_differing"] for r in decode_rows):
            raise AssertionError(
                f"decode_attention: a row of batch {BATCH} differs from the "
                f"row alone: "
                f"{[r for r in decode_rows if r['rows_differing']]}")
        # where the device time goes: a decode step (at position 40) and a
        # prefill, timed, then profiled
        step_tok = torch.zeros((BATCH, 1), dtype=torch.int32, device=dev)
        calls = {"decode": (lambda: decode(params, caches, step_tok, 40), 10),
                 "prefill": (lambda: prefill(params, caches, frames,
                                             prompts), 3)}
        timed = {k_: time_calls(torch, *c) for k_, c in calls.items()}
        profile = {k_: profile_calls(torch, *c, timed[k_])
                   for k_, c in calls.items()}
        k2_sm = k2_aggregate("bfloat16", BATCH, sm_step_layer, sm.n_layers,
                             (sm.d_model, sm.padded_vocab))
        # a prefill's 217 products at phase 3's times: the encoder's and
        # the cross K/V's at M = B x S_enc, the decoder's and the head at
        # M = B x S_dec
        m_enc, m_dec = BATCH * SM_ENC, BATCH * SM_PROMPT
        prefill_products = (
            [(m_enc, kn, c_ * sm.n_enc_layers) for kn, c_ in dense_layer(sm)]
            + [(m_enc, sm_q, 2 * sm.n_layers)]
            + [(m_dec, kn, c_ * sm.n_layers) for kn, c_ in sm_step_layer]
            + [(m_dec, (sm.d_model, sm.padded_vocab), 1)])
        if sum(t for _, _, t in prefill_products) != sm_passes["matmul"][1]:
            raise AssertionError(f"{arch}: a prefill's products "
                                 f"{prefill_products} are not its K2 count")
        k2_prefill = {key: sum(t * mm[("bfloat16", m_, *kn)][key]
                               for m_, kn, t in prefill_products)
                      for key in ("ms", "plain_ms", "library_ms")}
        k2_prefill["bound_ms"], k2_prefill["bound_by"] = bound_ms(
            sum(t * (m_ * k_ + k_ * n_ + m_ * n_) * 2
                for m_, (k_, n_), t in prefill_products),
            sum(t * 2 * m_ * n_ * k_ for m_, (k_, n_), t in prefill_products),
            "bfloat16")
        p50 = sorted(step_ms)[len(step_ms) // 2]
        wall_s = (prefill_ms + sum(step_ms)) / 1e3
        out.update(
            model=arch, dtype="bfloat16", enc_layers=sm.n_enc_layers,
            dec_layers=sm.n_layers, d_model=sm.d_model,
            padded_vocab=sm.padded_vocab, batch=BATCH, frames=SM_ENC,
            prompt=SM_PROMPT, max_new=SM_NEW, dec_len=SM_DEC_LEN,
            draw_s=round(draw_s, 3), boot_programs_s=round(load_s, 3),
            programs=syscore.report()["programs"],
            launches=launches, launches_by_route=routes,
            launches_per_pass=sm_passes,
            graph_equals_eager={"prefills": 1, "decode_steps": 4,
                                "bit_equal": True},
            batch1_equals_row_of_batch4=True, logits_finite=True,
            decode_attention_rows_equal_alone={
                "cases": len(decode_rows), "rows": BATCH * len(decode_rows),
                "scores_einsum_rows_differing_off_64": sum(
                    r["scores_einsum_rows_differing"]
                    for r in decode_rows if not r["batched"]),
                "scores_einsum_rows_differing_on_64": sum(
                    r["scores_einsum_rows_differing"]
                    for r in decode_rows if r["batched"])},
            tokens_row0=toks4[0].tolist(),
            decode_p50_ms=p50, tok_per_s=BATCH * SM_NEW / wall_s,
            decode_tok_per_s=1e3 * BATCH / p50, prefill_ms=prefill_ms,
            wall_s=wall_s, decode=profile["decode"],
            prefill=profile["prefill"], k2_per_decode_step=k2_sm,
            k2_per_prefill=k2_prefill,
            params_gib=round(param_bytes / 2 ** 30, 3),
            draw_peak_gib=round((draw_peak - base) / 2 ** 30, 3),
            mem_at_start_gib=round(base / 2 ** 30, 3),
            boot_besides_params_gib=round(
                (after_boot - base - param_bytes) / 2 ** 30, 3),
            serve_peak_above_boot_gib=round(
                (serve_peak - after_boot) / 2 ** 30, 3), card=smi)
        print(f"{arch}: decode p50 {p50:.3f} ms, tok/s "
              f"{BATCH * SM_NEW / wall_s:.1f}, prefill {prefill_ms:.3f} ms, "
              f"K2 a step {k2_sm['ms']:.3f} ms (bound {k2_sm['bound_ms']:.3f}"
              f", torch.matmul {k2_sm['library_ms']:.3f})", flush=True)
        path_launches[arch] = launches
        path_routes[arch] = routes
        return k2_sm

    with phase("serve_seamless") as out:
        k2_seamless = serve_seamless(out)

    # -- 23-25. the run-time of paper §3.3-3.5 --------------------------------
    import shutil
    import tempfile

    from repro_torch.bench import boot as boot_bench
    from repro_torch.bench import load_exec as load_exec_bench
    from repro_torch.core.program_store import ProgramSpec, ProgramStore
    served.clear()
    env = dict(os.environ, PYTHONPATH=SRC)

    def warm_boot(out, arch, plens, arrivals, per_pass, keep_store=None):
        """A cold boot over a fresh ProgramStore serves phase 8's requests
        (streams equal ``reference_generate``, launches ``per_pass``) and
        exports every program; ``repro_torch.bench.boot --warm`` in a
        fresh process boots from the store: every program installed from
        it (``source == "store"``, ``load_s > 0``), no call of a program
        function, the same streams and launches.  Then one entry is
        corrupted: the next boot captures that program from its function
        (a miss), heals the entry, and its streams stay exact.  With
        ``keep_store``, the store as the cold boot left it is copied
        there first (phase 28's fleet boots from it)."""
        gc.collect()
        torch.cuda.empty_cache()
        store_dir = tempfile.mkdtemp(prefix="repro_store_")
        kw = dict(full=True, device="cuda", batch=BATCH, max_len=MAX_LEN,
                  prefill_len=PREFILL_LEN, seed=0, prompt_lens=plens,
                  arrivals=arrivals, max_new=MAX_NEW)
        try:
            eng, cold = boot_bench.run_boot(arch, store_dir, **kw)
            names = sorted(cold["programs"])
            if any(cold["programs"][k]["source"] != "cuda_graph"
                   for k in names) or cold["store"]["puts"] != len(names):
                raise AssertionError(f"{arch}: the cold boot did not "
                                     f"capture and store every program: "
                                     f"{cold['programs']} {cold['store']}")
            want = {name: step * cold["decode_steps"] + adm * cold["admitted"]
                    for name, (step, adm) in per_pass.items()}
            if cold["launches"] != want:
                raise AssertionError(f"{arch} cold: launches "
                                     f"{cold['launches']}, expected {want}")
            prompts = boot_bench.workload(eng.cfg.vocab_size, plens)
            refs = [eng.reference_generate(p, MAX_NEW) for p in prompts]
            if refs != cold["tokens"]:
                raise AssertionError(f"{arch}: cold streams differ from "
                                     f"reference_generate")
            cold["persisted_after_serving"] = eng.syscore.persist()
            if keep_store is not None:
                shutil.copytree(store_dir, keep_store, dirs_exist_ok=True)
            cold["decode_replay_device_ms"] = boot_bench.decode_replay_ms(eng)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            cmd = [sys.executable, "-m", "repro_torch.bench.boot", "--warm",
                   "--full", "--device", "cuda", "--arch", arch,
                   "--store-dir", store_dir, "--batch", str(BATCH),
                   "--max-len", str(MAX_LEN), "--prefill-len",
                   str(PREFILL_LEN), "--prompt-lens",
                   ",".join(map(str, plens)), "--arrivals",
                   ",".join(map(str, arrivals)), "--max-new", str(MAX_NEW)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 env=env, timeout=600, cwd=ROOT)
            process_s = time.perf_counter() - t0
            if res.returncode != 0:
                raise AssertionError(f"{arch}: the warm boot failed: "
                                     f"{res.stderr[-3000:]}")
            warm = json.loads(res.stdout.strip().splitlines()[-1])
            warm["process_s"] = process_s
            bad = {k: p for k, p in warm["programs"].items()
                   if p["source"] != "store" or not p["load_s"] > 0}
            if bad or sorted(warm["programs"]) != names:
                raise AssertionError(f"{arch}: the warm boot did not "
                                     f"install every program from the "
                                     f"store: {warm['programs']}")
            if warm["python_calls"]["boot_and_serve"] != 0:
                raise AssertionError(f"{arch}: the warm boot called the "
                                     f"program functions: "
                                     f"{warm['python_calls']}")
            if (warm["store"]["hits"], warm["store"]["misses"]) != \
                    (len(names), 0):
                raise AssertionError(f"{arch}: warm store {warm['store']}")
            if warm["tokens"] != cold["tokens"]:
                raise AssertionError(f"{arch}: warm streams differ from "
                                     f"the cold boot's")
            if warm["launches"] != cold["launches"]:
                raise AssertionError(f"{arch}: warm launches "
                                     f"{warm['launches']}, cold "
                                     f"{cold['launches']}")
            # one entry torn: the next boot misses it, captures the program
            # from its function, heals the entry and stays exact
            store = ProgramStore(store_dir)
            torn = next(d for d, e in store.entries().items()
                        if e["key"] == "decode")
            (store.directory / (torn + ".pt2")).write_bytes(b"torn write")
            eng, fallback = boot_bench.run_boot(arch, store_dir, **kw)
            del eng
            progs = fallback["programs"]
            if progs["decode"]["source"] != "cuda_graph" or any(
                    progs[k]["source"] != "store" for k in names
                    if k != "decode"):
                raise AssertionError(f"{arch}: after a torn entry "
                                     f"{progs}")
            st = fallback["store"]
            if (st["hits"], st["misses"], st["puts"]) != \
                    (len(names) - 1, 1, 1):
                raise AssertionError(f"{arch}: torn-entry store {st}")
            if fallback["tokens"] != cold["tokens"]:
                raise AssertionError(f"{arch}: streams after a torn entry "
                                     f"differ")
        finally:
            shutil.rmtree(store_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        for rec in (cold, warm, fallback):
            rec.pop("tokens")
        out[arch] = {"cold": cold, "warm": warm, "torn_entry": fallback,
                     "streams_equal_reference": True}
        path_launches[f"{arch}/store_cold"] = cold["launches"]
        path_launches[f"{arch}/store_warm"] = warm["launches"]
        path_routes[f"{arch}/store_cold"] = cold["launches_by_route"]
        path_routes[f"{arch}/store_warm"] = warm["launches_by_route"]
        print(f"{arch} boot: cold {cold['boot_s']:.2f} s, warm "
              f"{warm['boot_s']:.2f} s (its process "
              f"{warm['process_s']:.2f} s), torn entry "
              f"{fallback['boot_s']:.2f} s; decode replay device ms warm "
              f"{warm['decode_replay_device_ms']:.4f}, cold "
              f"{cold['decode_replay_device_ms']:.4f} ({smi})", flush=True)
        for k in names:
            c, w = cold["programs"][k], warm["programs"][k]
            print(f"  {k}: load_s {w['load_s']:.3f}, lower_s "
                  f"{w['lower_s']:.3f}, compile_s {w['compile_s']:.3f} "
                  f"(cold {c['lower_s']:.3f} / {c['compile_s']:.3f}, export "
                  f"{c['export_s']:.2f} s), serialized_bytes "
                  f"{w['serialized_bytes']}", flush=True)

    phase8_plens = [16, 200, 57, 120, 31, 180, 90, 140]
    phase8_arrivals = [0, 0, 0, 0, 3, 9, 20, 40]
    # phase 28's fresh store: what qwen3's cold boot here exported (the
    # same programs: phase 8's geometry), before any other boot used it
    cluster_store = tempfile.mkdtemp(prefix="repro_cluster_store_")
    with phase("warm_boot") as out:
        warm_boot(out, "qwen3-0.6b", phase8_plens, phase8_arrivals,
                  {"matmul": (per_step, per_step),
                   "flash_attention": (0, n_layers), "moe_ffn": (0, 0),
                   "ssd_scan": (0, 0), "rglru_scan": (0, 0)},
                  keep_store=cluster_store)
        warm_boot(out, "mamba2-130m", phase8_plens, phase8_arrivals,
                  {"matmul": (ssm_per_step, ssm_per_step),
                   "flash_attention": (0, 0), "moe_ffn": (0, 0),
                   "ssd_scan": (0, ssm.n_layers), "rglru_scan": (0, 0)})

    # -- 24. Table 1 ---------------------------------------------------------
    with phase("table1") as out:
        gc.collect()
        torch.cuda.empty_cache()
        table1 = load_exec_bench.run("qwen3-0.6b", full=True, device="cuda",
                                     batch=BATCH, max_len=MAX_LEN)
        if not table1["serialized_equals_hot_load"]:
            raise AssertionError("the serialized decode program differs "
                                 "from the hot-loaded one")
        out.update(table1=table1, card=smi)
        for r in table1["rows"]:
            print(f"Table 1 {r['row']}: {r['us']:.1f} us "
                  f"({ {k: v for k, v in r.items() if k not in ('row', 'us', 'what')} }) "
                  f"on {smi}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    # -- 25. in-graph host calls ---------------------------------------------
    with phase("hostcalls") as out:
        from repro_torch.core.hostcall import CALL_METRIC
        replays, code = 100, 77
        store_dir = tempfile.mkdtemp(prefix="repro_store_")
        try:
            sc = Syscore(dev, store=ProgramStore(store_dir))
            hct = sc.hostcalls
            seen = []
            double = hct.register(
                lambda v: (seen.append(float(v)), np.float32(2 * v))[1])

            def program(state, x):
                """Each replay: step += 1, y = step * sum(x) reported
                through CALL_METRIC, v = 2 y from the host, out = v + 1
                (a kernel after the call reads v)."""
                state["step"].add_(1)
                y = (x * state["step"]).sum()
                hct.hostcall(CALL_METRIC, code, y)
                v = hct.hostcall_value(double, torch.float32, y)
                return state, v + 1

            state = {"step": torch.zeros((), device=dev)}
            x = torch.arange(8, dtype=torch.float32, device=dev)
            prog = sc.hot_load(ProgramSpec("hostcalls", program,
                                           resident=(state,), inputs=(x,)))
            p = prog.program
            if p.source != "cuda_graph" or len(p.host_sites) != 2:
                raise AssertionError(f"host-call program: source "
                                     f"{p.source}, sites {len(p.host_sites)}")
            if sc.store.skipped != 1 or sc.store.puts != 0 or \
                    p.serializable is not False:
                raise AssertionError(f"the host-call program was not "
                                     f"skipped by the store: "
                                     f"{sc.store.report()}")
            torch.cuda.synchronize()
            state["step"].zero_()
            hct.metrics.clear()
            seen.clear()
            outs = []
            t0 = time.perf_counter()
            for _ in range(replays):
                outs.append(prog(state, x)[1].clone())
            wait_device(torch, 60.0)
            wall = time.perf_counter() - t0
            xsum = float(x.sum())
            want = [xsum * k for k in range(1, replays + 1)]
            got = hct.metrics.get(code, [])
            if got != want or seen != want:
                raise AssertionError(f"host calls received {got[:4]}... "
                                     f"({len(got)}), {seen[:4]}..., "
                                     f"expected {want[:4]}...")
            vals = [float(o) for o in outs]
            if vals != [2 * w + 1 for w in want]:
                raise AssertionError(f"the host's values did not reach the "
                                     f"next kernel: {vals[:4]}...")
            if hct.errors:
                raise AssertionError(f"host functions failed: "
                                     f"{hct.errors[:4]}")
            out.update(replays=replays, calls_in_order=True,
                       value_read_by_next_kernel=True,
                       store=sc.store.report(), export_error=p.export_error,
                       ms_per_replay=1e3 * wall / replays)
            del prog, p, sc
        finally:
            shutil.rmtree(store_dir, ignore_errors=True)
        res = subprocess.run([sys.executable, "-m", "repro_torch.bench.hostcall",
                              "--device", "cuda"], capture_output=True,
                             text=True, env=env, timeout=300, cwd=ROOT)
        if res.returncode != 0:
            raise AssertionError(f"bench.hostcall failed: "
                                 f"{res.stderr[-3000:]}")
        hc = json.loads(res.stdout.strip().splitlines()[-1])
        out["bench"] = hc
        for r in hc["rows"]:
            print(f"host call {r['row']}: {r['us']:.2f} us on {smi}",
                  flush=True)

    # -- 26. qwen3-moe-30b-a3b at full width, in a process of its own ------
    with phase("serve_qwen3_moe") as out:
        gc.collect()
        torch.cuda.empty_cache()
        out.update(
            parent_allocated_gib=torch.cuda.memory_allocated() / 2 ** 30,
            parent_reserved_gib=torch.cuda.memory_reserved() / 2 ** 30)
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--serve-qwen3-moe"], capture_output=True,
                             text=True, env=env, timeout=900, cwd=ROOT)
        lines = res.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(line, flush=True)
        if res.returncode != 0 or not lines:
            raise AssertionError(f"phase 26's process failed "
                                 f"({res.returncode}): {res.stderr[-4000:]}")
        moe30 = json.loads(lines[-1])
        out.update(moe30)
        path_launches[QWEN3_MOE] = moe30["launches"]
        path_routes[QWEN3_MOE] = moe30["launches_by_route"]
        path_launches[f"{QWEN3_MOE}/bench_serve"] = \
            moe30["serve_bench"]["launches"]
        path_routes[f"{QWEN3_MOE}/bench_serve"] = \
            moe30["serve_bench"]["launches_by_route"]

    # -- 27. the port's benches --------------------------------------------
    # through the port's runner, each bench in a process of its own, with
    # the reference's smoke workloads (placement has none): the script's
    # time
    with phase("benches") as out:
        for names, flags in (
                (["serve", "placement", "paging", "prefix", "fused",
                  "spec"], ["--smoke"]),):
            cmd = [sys.executable, "-m", "repro_torch.bench", "--only",
                   ",".join(names), "--device", "cuda", *flags]
            # the runner starts a process per bench: a session of their
            # own, so that a timeout stops them all
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True,
                                    env=env, cwd=ROOT,
                                    start_new_session=True)
            try:
                stdout, stderr = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
                raise
            if proc.returncode != 0:
                raise AssertionError(f"benches {names} failed: "
                                     f"{stdout[-2000:]} {stderr[-4000:]}")
            # one line a bench, in order, then the waiting ones
            recs = [json.loads(line)
                    for line in stdout.strip().splitlines()[:len(names)]]
            for name, rec in zip(names, recs):
                if rec["device"]["platform"] != "gpu":
                    raise AssertionError(f"bench.{name} did not run on the "
                                         f"card: {rec['device']}")
                if any(r["wgmma"] != rec["launches"][k] or r["simt"]
                       for k, r in rec["launches_by_route"].items()):
                    raise AssertionError(f"bench.{name}: K1/K3/K4 calls off "
                                         f"the wgmma route: "
                                         f"{rec['launches_by_route']}")
                path_launches[f"bench/{name}"] = rec["launches"]
                path_routes[f"bench/{name}"] = rec["launches_by_route"]
                rec.pop("streams", None)
                rec["args"] = flags
                out[name] = rec
                print(f"bench.{name} {' '.join(flags)}: "
                      f"{rec['seconds']:.1f} s, launches {rec['launches']} "
                      f"({smi})", flush=True)
        table2 = out["placement"]
        if not all(table2["outputs_bit_equal"].values()):
            raise AssertionError(f"Table 2's layouts differ: {table2}")
        print(f"Table 2 layout A against moe_ffn_ref: max abs err "
              f"{table2['max_abs_err_vs_plain']:.6f} (tol "
              f"{table2['tol']})", flush=True)
        for r in table2["rows"]:
            print(f"Table 2 {r}", flush=True)
        k3c = table2["k3_call"]
        print(f"Table 2 K3 call (E 1, C {k3c['C']}, d {k3c['d']}, f "
              f"{k3c['f']}, {k3c['route']}): {k3c['ms']:.5f} ms, bound "
              f"{k3c['bound_ms']:.5f} ms ({k3c['bound_by']}) ({smi})",
              flush=True)
        serve = out["serve"]
        print(f"bench.serve qwen3-0.6b: {serve['tok_per_s']:.1f} tok/s, "
              f"decode p50 {serve['decode_p50_ms']:.3f} ms, TTFT "
              f"{serve['ttft_ms']:.1f} ms ({smi})", flush=True)
        print(f"ratios reported, not asserted: spec speedup "
              f"{out['spec']['speedup']:.3f}, fused H16 "
              f"{out['fused']['speedup_h16']:.3f} (dispatches a token "
              f"{out['fused']['dispatches_per_token_h16']:.4f}), prefix "
              f"warm/cold TTFT {out['prefix']['ttft']['warm_over_cold']:.3f}, "
              f"paged/unpaged tok/s "
              f"{out['paging']['paged_over_unpaged_tok_per_s']:.3f} ({smi})",
              flush=True)

    # -- 28. qwen3-0.6b's serving fleet, in a process of its own -----------
    with phase("serve_cluster") as out:
        gc.collect()
        torch.cuda.empty_cache()
        try:
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--serve-cluster", cluster_store],
                                 capture_output=True, text=True, env=env,
                                 timeout=900, cwd=ROOT)
        finally:
            shutil.rmtree(cluster_store, ignore_errors=True)
        lines = res.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(line, flush=True)
        if res.returncode != 0 or not lines:
            raise AssertionError(f"phase 28's process failed "
                                 f"({res.returncode}): {res.stderr[-4000:]}")
        fleet = json.loads(lines[-1])
        out.update(fleet)
        for name in ("A", "C", "B"):
            path_launches[f"qwen3-0.6b/cluster_{name}"] = \
                fleet[name]["launches"]
            path_routes[f"qwen3-0.6b/cluster_{name}"] = \
                fleet[name]["launches_by_route"]
        a, b, c = fleet["A"], fleet["B"], fleet["C"]
        print(f"cluster: A reboot {a['reboot_s']:.2f} s (load "
              f"{a['recovery_load_s']:.2f}, capture "
              f"{a['recovery_capture_s']:.2f}), downtime "
              f"{a['downtime_s']:.2f} s, {a['tok_per_s']:.1f} tok/s; C "
              f"replace {c['boot_s']:.2f} s; B grow load "
              f"{b['grow_load_wall_s']:.2f} s in the background over "
              f"{b['passes_while_loading']} passes, attach "
              f"{b['grow_attach_s']:.2f} s, rebalanced {b['rebalanced']}; "
              f"{fleet['streams_equal_reference']} streams equal the "
              f"batch-1 engine; {fleet['seconds']:.1f} s ({smi})",
              flush=True)

    def total(name):
        return sum(path[name] for path in path_launches.values())

    def by_path(name):
        return {arch: path[name] for arch, path in path_launches.items()}

    def by_route(name):
        return {r: sum(path[name][r] for path in path_routes.values())
                for r in ("wgmma", "simt")}

    k2 = k2_aggregate("bfloat16", BATCH, per_layer, n_layers,
                      (d_model, vocab))
    k2_prefill = k2_aggregate("bfloat16", PREFILL_LEN, per_layer, n_layers,
                              (d_model, vocab))
    k2_moe = k2_aggregate("bfloat16", BATCH, moe_layer, moe.n_layers,
                          (moe_d, moe_vocab))
    k2_moe_prefill = k2_aggregate("bfloat16", PREFILL_LEN, moe_layer,
                                  moe.n_layers, (moe_d, moe_vocab))
    k2_ssm = k2_aggregate("bfloat16", BATCH, ssm_layer, ssm.n_layers,
                          (ssm_d, ssm_vocab))
    k2_ssm_prefill = k2_aggregate("bfloat16", PREFILL_LEN, ssm_layer,
                                  ssm.n_layers, (ssm_d, ssm_vocab))
    k2_rg = k2_aggregate("bfloat16", BATCH, rg_pass, 1, (rg_d, rg_vocab))
    k2_rg_prefill = k2_aggregate("bfloat16", PREFILL_LEN, rg_pass, 1,
                                 (rg_d, rg_vocab))
    k2_new = {}
    for arch, c in new_cfgs.items():
        for m, key in ((BATCH, "per_decode_step"),
                       (PREFILL_LEN, "prefill_per_admission")):
            k2_new[f"{arch}_{key}"] = k2_aggregate(
                "bfloat16", m, new_layers[arch], c.n_layers,
                (c.d_model, c.padded_vocab))
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:84",
         "launches": total("flash_attention"),
         "launches_by_path": by_path("flash_attention"),
         "launches_by_route": by_route("flash_attention"),
         "max_abs_err": flash_err,
         "ms": fa["bfloat16"]["ms"], "plain_ms": fa["bfloat16"]["plain_ms"],
         "bound_ms": fa["bfloat16"]["bound_ms"],
         "bound_by": fa["bfloat16"]["bound_by"],
         "library_ms": fa["bfloat16"]["library_ms"],
         "per": f"one call: bf16 causal prefill S={PREFILL_LEN}, "
                f"H={heads}, Hk={kv_heads}, D={hd}",
         "olmoe": fa["olmoe"], "recurrentgemma": fa["recurrentgemma"],
         "recurrentgemma_float32": fa["recurrentgemma_float32"],
         "warm": fa["warm"], "warm_bench": fa["warm_bench"],
         "warm_rows_equal_cold": flash_warm_cold,
         "new_layouts": {arch: fa[arch] for arch in (*new_cfgs, QWEN3_MOE)},
         "seamless": {key: fa[f"seamless_{key}"]
                      for key in ("encoder", "cross", "self")},
         "bits_equal_B1_B2": flash_bits, "build": k1_build},
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:33",
         "launches": total("matmul"),
         "launches_by_path": by_path("matmul"),
         "max_abs_err": matmul_err,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"], "host_ms": k2["host_ms"],
         "library_host_ms": k2["library_host_ms"],
         "per": f"one qwen3-0.6b decode step: bf16 M={BATCH}, "
                f"{n_layers}x7 projections + tied head",
         "prefill_per_admission": k2_prefill,
         "olmoe_per_decode_step": k2_moe,
         "olmoe_prefill_per_admission": k2_moe_prefill,
         "mamba2_per_decode_step": k2_ssm,
         "mamba2_prefill_per_admission": k2_ssm_prefill,
         "recurrentgemma_per_decode_step": k2_rg,
         "recurrentgemma_prefill_per_admission": k2_rg_prefill,
         **k2_new,
         "seamless-m4t-medium_per_decode_step": k2_seamless,
         "bits": matmul_bits, "build": matmul_build},
        {"name": "moe_ffn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_ffn.cu",
         "replaces": "src/repro/kernels/moe_dispatch.py:38",
         "launches": total("moe_ffn"),
         "launches_by_path": by_path("moe_ffn"),
         "launches_by_route": by_route("moe_ffn"),
         "max_abs_err": k3_err,
         "ms": k3["decode"]["ms"], "plain_ms": k3["decode"]["plain_ms"],
         "bound_ms": k3["decode"]["bound_ms"],
         "bound_by": k3["decode"]["bound_by"],
         "library_ms": None,
         "yardstick_bmm_ms": k3["decode"]["yardstick_bmm_ms"],
         "per": f"one call at olmoe-1b-7b decode: bf16 E={moe_e}, "
                f"C={k3['decode']['C']}, d={moe_d}, f={moe_f}, the path's "
                f"own inputs ({k3['decode']['live_experts_per_call']} live "
                "experts per call)",
         "admission": k3["admission"], "bits_equal_to_C4": k3_bits,
         "qwen3_moe_30b_a3b": moe30["k3_timed"],
         "table2_call": table2["k3_call"],
         "build": k3_build},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:65",
         "launches": total("ssd_scan"),
         "launches_by_path": by_path("ssd_scan"),
         "launches_by_route": by_route("ssd_scan"),
         "kernel_route": k4["bfloat16"]["route"],
         "max_abs_err": k4_err,
         "ms": k4["bfloat16"]["ms"], "plain_ms": k4["bfloat16"]["plain_ms"],
         "simt_ms": k4["bfloat16"]["simt_ms"],
         "bound_ms": k4["bfloat16"]["bound_ms"],
         "bound_by": k4["bfloat16"]["bound_by"],
         "library_ms": None,
         "library": "none: no single PyTorch call computes the SSD scan",
         "per": f"one call at mamba2-130m admission: bf16 B=1, "
                f"S={PREFILL_LEN} in chunks of 128, H={ssd_h}, P={ssd_p}, "
                f"N={ssd_n}, from a state h0",
         "float32": k4["float32"], "bits_equal_B1_B2": k4_bits,
         "build": k4_build},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:45",
         "launches": total("rglru_scan"),
         "launches_by_path": by_path("rglru_scan"),
         "max_abs_err": k5_err,
         "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": None,
         "library": "none: no single PyTorch call computes a linear "
                    "recurrence",
         "per": f"one call at recurrentgemma-2b admission: f32 B=1, "
                f"S={PREFILL_LEN}, L={rg_lru}, from a state h0",
         "bit_equal_plain": k5_plain_bits, "bits_equal_B1_B2": k5_bits,
         "build": k5_build},
    ]
    RECORD["kernels"] = kernels
    _write_record()
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--serve-qwen3-moe"]:
        sys.exit(serve_qwen3_moe())
    if sys.argv[1:2] == ["--serve-cluster"] and len(sys.argv) <= 3:
        sys.exit(serve_cluster(*sys.argv[2:]))
    sys.exit(main())
