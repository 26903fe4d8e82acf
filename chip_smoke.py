#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ProbGraph on one GPU and check it.

    python3 chip_smoke.py                  # from the root of a checkout
    python3 chip_smoke.py --fused-pass     # phase 3m alone

Phases, each printed as it runs:

  1. Environment: the card's name and power limit, torch and CUDA
     versions, and the build of every CUDA kernel from ``src/``.
  2. Kernels against their plain PyTorch versions on the card (integers:
     equality required). The popcount kernels, both [T, k] forms, over
     the programs of ``popcount_programs`` (AND2/AND3/AND4, OR, ANDNOT,
     nested, 8-leaf and permuted-column programs), row widths 1..600
     (every vector width, column blocks), tuple counts at the kernels'
     tile edges and up to ~1M, ids to clamp, operands whose base is
     shifted by 4 bytes, and two-column tuples; the dense AND2 at every
     power-of-two width from 2 to 4,096 words (the adaptive Bloom's
     folded operands); the MinHash counts in
     both forms (rows: int32[E, k] rows; gather: the sketch matrix and
     pairs of ids) over k in {1, 4, 7, 24, 28, 31, 32, 33, 128, 256},
     ragged E up to ~1M and 0, with
     all-sentinel rows, negative entries, duplicates, out-of-range and
     negative ids (clamped), and operands whose base is shifted by 4
     bytes. Attention by both routes (bfloat16: the wgmma
     tensor-core kernel; float32: the CUDA-core kernel), head dims
     16..256, MHA/GQA/MQA, windows 0/8/4096, S in {1, 97, 1000, 4096},
     Sq != Skv and rows that see no key; the float32 route also with
     3-group GQA (H 6, KV 2) and 8-head MQA (H 8, KV 1) packs and rows
     that are not 16-byte aligned (D = 30 and 31, [..., 2:32] and
     [..., 1:31] views), its library's registers, spills, shared memory
     and blocks an SM, and its SASS counts (FFMA, LDS.128; no
     tensor-core instruction). Then each kernel timed at the
     main path's shape beside its bound (the MinHash gather forms also
     beside the old route: two ``index_select`` row copies, then the rows
     kernel); attention at the repo's
     prefill_32k shapes (qwen3_8b, h2o_danube3_4b, gemma_2b; bf16) and
     deepseek_v3's MLA prefill shape (H = KV = 128, D = 192, S = 2,048,
     v as the model pads it), driven
     once through ``flash_attention`` with its per-route launch counts
     zeroed before and read after, and timed beside the plain version and
     ``scaled_dot_product_attention`` (a yardstick the port never calls,
     whose own error against the plain version is printed too); the
     float32 route driven on its own at qwen3_8b's heads, S =
     ATTN_FP32_SEQ, and timed there, at phase 3i's float32 layer (S =
     HOOK_SEQ), at gemma_2b's MQA heads and at a 3-group layer, with the SM
     clock sampled during each timing (shapes from
     ``repro_torch.configs``, ``fp32_attention_shapes``).
  3. The Bloom path: a scale-21 Kronecker graph (2.1M vertices, 31.8M
     edges), ``session(g, "bf", storage_budget=1.0)`` on the card,
     ``triangle_count()`` and ``local_clustering()``. The launch counts are
     zeroed just before and read just after (the per-edge pass: one
     ``gather/and2/card`` launch); the pass's cardinalities equal the
     chunked pass's in their bits; per-edge popcounts of a fixed 1M-edge
     sample and the TC are held against the plain path on the card.
  3b. The MinHash path on the same graph: ``session(g, "kh", ...)`` with
     TC, LCC, ``jarvis_patrick("jaccard", 0.05)`` and
     ``edge_similarity("jaccard")``, then ``session(g, "1h", ...,
     variant="naive")`` with TC; each with its launch counts (by form:
     only the gather form may run) zeroed just before and read just
     after, its kernel's match counts on the 1M-edge sample (both forms)
     and its TC held against the plain path.
  3d. The AND2 gather on two real chunks of the phase-3 TC pass (the
     first and the median in hub order), checked against the plain
     version and timed with L2 flushed and warm, beside its bound and
     ``khash_match_gather`` on the same pairs over the k-Hash sketch.
  3c. Cliques: ``four_clique_count()`` on the phase-3 Bloom session
     (scale 21; its wedge candidates held to a numpy count from the CSR),
     then on ``kronecker(16, 16, seed=1)`` the Bloom ``five_clique_count()``
     (the AND4 form) and the k-Hash ``four_clique_count()``; each with its
     launch counts zeroed just before and read just after; the Bloom
     passes must launch only the segmented kernel. Kernel-path popcounts
     of sampled triangles and 4-cliques, hub edges included, equal the
     plain path's, through segments and through [T, k] tuples; the k-Hash
     count equals the plain path's. On the first launch of each Bloom pass
     (up to ``_LAUNCH_TUPLES`` survivor tuples over the session's sketch)
     the segmented kernel and the [T, k] gather kernel are checked against
     each other and the plain version and timed in turns, each beside its
     bound; the k-Hash pass must launch only the rows form of
     ``khash_match_pairs``, which is timed on the pass's first launch.
  3e. The exact baseline and local clustering at scale 21. The exact
     session (``session(g, None)``): its per-edge pass and
     ``exact_triangle_count`` (times, lookups, peak memory; no kernel
     launch), the same count with a binary search inside the CSR row in
     place of the port's edge-key search (time compared, count equal),
     the Bloom TC of phase 3 against the exact count, and the
     exact counts of 2,000 sampled edges (hub edges included) against
     np.intersect1d. ``local_cluster`` with the launcher's 8 seeds (alpha
     0.15, eps 1e-4, auto mode: the sparse push) on the Bloom and the
     exact session, launch counts zeroed just before and read just after:
     the Bloom sweep must launch ``fused_rows_popcount`` (AND2) and
     nothing else, the exact one nothing; the dense frontier must give the
     same supports and equal profiles where the orders agree; the exact
     best conductances equal a host recount. Then a batch of 128 seeds
     chosen by degree (the top hubs, the highest degrees that still push,
     and the largest supports of a pool drawn across degree bands) through
     ``local_cluster`` on both sessions, at eps 1e-4 and again at 1e-5
     (forced sparse: supports up to the sweep's cap, hub seeds that
     push), with its push's expansion slots per round, supports,
     launches and host-recounted conductances; a spill forced by a
     frontier cap below the largest frontiers, which must fall back to
     the dense push with the same supports; and the dense AND2 on both
     Bloom sweeps' operands (E = 65,536) against its plain version on
     every row and on the rows of real steps alone, timed L2 flushed and
     warm beside its bound.
  3f. The streaming serving path at scale 21: the phase-3 edges split as
     ``launch/stream.py`` splits them (``default_rng(2)`` permutation, 30%
     withheld, 96 arrival chunks); a Bloom ``StreamSession`` (s = 1.0,
     strict policy) behind a ``BatchedQueryServer(max_batch=5,
     max_wait_s=0.25)`` replays the first 2 chunks (the host's set
     algebra takes tens of seconds a delta at this size), each a delta
     (10% as many deletions as inserts) and the launcher's five queries;
     per batch the apply_delta wall time split by its spans, cards
     recomputed/carried, rows rebuilt, bytes uploaded (required below
     bytes_init / 8), the flush time and the launches of delta and flush
     by form (counts zeroed before each, read after; the delta's refresh
     must launch the fused AND2 gather, ``gather/and2/card``, the flush
     the AND2 gather and the dense AND2). After each batch the
     stream is held to a from-scratch session on ``from_edge_array`` (TC
     float32 bits, similarity, membership, local cluster, sketch rows,
     device CSR). The last batch runs under torch.profiler (device busy,
     idle share, top kernels). Then a k-Hash stream (k = 22) of 1 batch,
     held the same way (rows equal to a fresh ``build_khash``).
     Checkpoints: after the first Bloom batch ``st.save`` (bytes on
     disk, seconds); after the last, ``StreamSession.restore`` of that
     checkpoint on the card, its state (edge keys, degrees, device CSR,
     sketch rows, dirty, stale, counters, version) equal to the live
     session's at that version; batch 1 replayed on it with the
     launcher's RNG, after which state, TC float32 bits and the five
     answers equal the live session's; one ``AsyncCheckpointer`` write
     read back. The directory is deleted at the end.
  3g. On the phase-3 graph: the degree-adaptive Bloom (s = 1.0, k = 2):
     Σ words, bytes, size classes, build time; sampled rows (hubs
     included) equal to ``build_adaptive_bloom_np``;
     ``adaptive_triangle_count`` with launches zeroed before and read
     after (only ``rows/and2`` may run; no n x words_max tensor), its
     error against the exact count beside the fixed Bloom's, a warm pass
     unprofiled and under torch.profiler (device busy, idle share, the
     dense AND2's share, top kernels); the
     popcounts of a 1M-edge sample (hub edges included) equal to the
     plain path's. Link prediction (removed 0.1, seed 0, ``common``):
     2,000,000 distance-2 candidates equal to a numpy rule, ef for the
     exact, Bloom (s = 1.0) and k-Hash scorers with their launches, the
     kernel path's counts and scores equal to the plain path's; the Bloom
     scorer again at scale 16, where fewer edges are removed than there
     are candidates. MinHash dedup of a 50,000-doc corpus (5,000 planted
     near-duplicates) with k = k_for(0.1, 0.01) = 265: seconds per step,
     candidates, duplicates dropped; sketches of 200 sampled docs equal to
     numpy's and a 2,000-doc sub-corpus's keep mask and stats equal to the
     reference's rule run in numpy.
  3h. The sharded mining path on the phase-3 graph, over a process group
     of world size 1 (NCCL, ``file://`` store in a temporary directory,
     destroyed at the end) and its ("data", "model") = (1, 1) mesh:
     ``launch.mine.mine(g, mesh)`` at budget 0.25 with its launches zeroed
     just before and read just after (only ``gather/and2``, one per
     chunk), its rows (``build_sketches_distributed``) equal to
     ``build_bloom`` and its estimate within rtol 1e-5 of the budget-0.25
     session's TC; ``sum_edge_cardinalities`` with ``shard_edges=True``
     under ``use_rules(mesh)`` on an s = 1.0 session equal to the local
     fold's float32 bits. Then R = 2, 4 and 8 ranks in one process (NCCL
     takes one rank per GPU): each rank's block partial through
     ``shard_edge_cardinalities`` within its fold bound of the float64
     sum of the block's per-edge estimates, their sum within twice the
     bound of the local fold, and the vertex-range builds, concatenated,
     equal to ``build_bloom``.
  3i. The dense-transformer serving path at full width: ``qwen3_8b``
     (36 layers, d_model 4,096, 32/8 heads of 128, d_ff 12,288, vocab
     151,936 padded to 152,064; bfloat16 weights from ``init_params``
     under a seeded CUDA generator, their count checked against
     ``total_params()``). The prefill ``forward`` at B = 1, S = 8,192,
     timed by CUDA events, with the launch counts zeroed just before and
     read just after (exactly 36 ``wgmma_bf16`` flash launches, nothing
     else), beside its bound (``model_flops + attention_flops`` over 989
     TFLOP/s), its peak memory and a profile; the flash kernel alone at
     one layer's shape. A second forward at S = 2,048 with a hook on every
     layer's attention core holds each layer's kernel output against
     ``ref.causal_attention`` on that layer's q, k, v (phase 2's bf16
     tolerance). 64 teacher-forced ``decode_step``s at batch 2 against
     the forward's logits on the same tokens, within 2L·2^-8 of max
     |logit| (top-1 agreement printed). The serve loop
     (``launch.serve.generate``) on 4 prompts of 3-32 tokens, 32 tokens
     sampled, max_len 128: tokens in the vocab, ms a step beside the step's
     bound (the bytes it must move over 3.35 TB/s); ``PROFILE_STEPS``
     decode steps at that batch under torch.profiler (launches a step,
     idle share). The float32
     route: the same config at 4 layers, S = 2,048, 4 ``fma_fp32``
     launches, each layer held as above at atol = rtol = 2e-5. Last, the
     launcher ``python -m repro_torch.launch.serve --device cuda`` in a
     process of its own, its output line checked.
  3j. The MoE, MLA, SSM and hybrid configs at full width, bf16, random
     weights from a seeded CUDA generator (the router, ``a_log``,
     ``d_skip`` and ``dt_bias`` float32), one at a time, cut in depth
     only (``ARCH_MODELS``): ``phi35_moe`` 8 of 32 layers, ``deepseek_v3``
     4 of 61 (3 MLA + MLP, then MLA + MoE of 256 experts with a shared
     one), ``jamba15_large`` 2 of 72 (attention + MLP, then SSM + MoE),
     ``mamba2_130m`` whole. Each: the prefill ``forward`` at B = 1, S =
     2,048 timed by CUDA events with its launches zeroed just before and
     read just after (one ``wgmma_bf16`` per attention or MLA layer: 8, 4,
     1, 0; nothing else), beside ``model_flops + attention_flops`` over 989
     TFLOP/s, finite logits, a profile; a hooked forward holding every
     attention or MLA core to ``ref.causal_attention`` (MLA on its
     unpadded v); the first MoE layer's routing equal to a numpy rule on
     its router logits (ids, kept and dropped assignments) and its output
     within 2^-5 of max |value| (mean 2^-6) of a float32 per-expert loop
     with the same drops; ``deepseek_v3``'s first MLA layer: 32 absorbed
     decode steps within 2^-5 of ``mla_fwd`` (the flash kernel at its
     shape is timed in phase 2);
     the first SSM layer of ``mamba2_130m`` and ``jamba15_large`` alone:
     64 ``ssm_decode`` steps at batch 2 within 2^-5 of ``ssm_fwd`` (mean
     2^-7); ``mamba2_130m``: 64 decode steps at batch 2 against the
     prefill, bf16 within 0.5 of max |logit| (``SSM_DECODE_BF16``: the
     reference's own drift reaches 0.36) and float32 within 1e-3. Then the serve loop and a profiled decode step for
     ``mamba2_130m`` and ``phi35_moe``, and the launcher's ``main
     --device cuda`` for both.
  3k. The training path. The flash Function (the kernel's forward, the
     plain recompute's backward) at ``qwen3_8b``'s layer shape (B = 1, S =
     4,096, 32/8 heads of 128) and at MLA's (S = 2,048, 128 heads, D 192,
     v 128), bf16: output and dq, dk, dv against autograd through
     ``ref.causal_attention`` on the same tensors, then forward + backward
     timed beside the backward alone, the plain version's and SDPA's. A
     reduced float32 train step (Adafactor) on the card against the same
     step on the CPU (``qwen3_8b``, ``deepseek_v3``). Through
     ``launch.train.train`` on the card: reduced ``gemma_2b``, 25 steps,
     whose last-5 mean loss must fall below its first-5 mean; a fault at
     step 13 of 24, recovered from the step-12 checkpoint in a temporary
     directory; ``qwen3_8b`` at full width and depth (bf16, Adafactor,
     remat, B = 1, S = 4,096, ``TRAIN_STEPS`` steps): finite loss and
     grad_norm, step times by CUDA events (median of steps 2-4) beside the
     bound (``model_flops + attention_flops`` at ``train_4k`` with batch 1
     over 989 TFLOP/s), peak memory, exactly 72 ``wgmma_bf16`` launches a
     step (forward and remat), one more step under torch.profiler (device
     busy, idle share; the attention backward's share from its time at the
     layer shape). AdamW (float32 moments) at full width with
     ``ADAMW_LAYERS`` of 36 layers through ``make_train_step``: step time,
     peak memory, launches. Last, the launcher's ``main --device cuda``.
     Each run's launch counts are zeroed just before and read just after.
  3l. Production sharding and the dry run, in subprocesses (a fake
     process group may meet no other). On rank 0 of a fake 16×16 group:
     the flash kernel under ``local_map`` (``qwen3_8b``'s 2 local query
     heads and the kv head they read, local batch 16, S = 4,096, bf16)
     against the plain version on the same local q, k, v; then
     ``qwen3_8b``'s ``train_4k`` local shard at full width and depth for
     real, with no other process beside it (``launch.dryrun.run_local_shard``: local batch 16 × 4,096,
     bf16, remat, AdamW with ``keep_master``, ``SHARD_STEPS`` steps, the
     last profiled): step times by CUDA events, peak memory against the
     dry run's estimate, exactly 72 flash launches a step, idle share.
     The collectives of a fake group are no-ops, so the time excludes
     communication and the loss is not a result. Then ``DRYRUN_CELLS``
     through ``python -m repro_torch.launch.dryrun --device cuda`` (one
     subprocess each, in parallel): per-device flops, bytes, collective
     bytes, the memory estimate, the roofline terms, the bottleneck and
     ``useful_ratio``, which for ``qwen3_8b`` ``train_4k`` must lie in
     ``USEFUL_RANGE``.
  3m. The Bloom per-edge pass at scale 24: the graph of the benchmark's
     ``kron24_bf`` configuration (drawn on the card by
     ``graphbench/generator.py``, loaded by ``from_edge_array``), a Bloom
     session as the benchmark opens it, then the pass in its two forms in
     turns (fused, chunked, chunked, fused): the fused pass (one
     ``gather/and2/card`` launch) and the chunked pass (``map_edges`` over
     the hub-ordered edges, one ``gather/and2`` a chunk, PyTorch's Eq. 2
     ops); wall time, launches by form, peak memory above the pass's
     start, and under torch.profiler each form's gather kernel time and
     device busy time; the fused kernel alone (L2 flushed) beside its
     bound by bytes (rows named, ids, the order and the float store); the
     two results equal in their bits; the fused kernel's profiler name
     holds ``tile_popcount_kernel`` and ``GatherSrc``. Alone: ``python3
     chip_smoke.py --fused-pass``.
  4. Where the time goes: a warm Bloom pass (and the [T, k] gather
     kernel's time per launch in it), a Bloom sketch build, warm k-Hash
     and 1-Hash-naive passes, the scale-21 4-clique pass, the exact
     per-edge pass and a warm 8-seed Bloom ``local_cluster`` under
     torch.profiler (device busy time, idle share, top kernels).
  5. A scale-12 graph against an independent numpy reference of the same
     definitions: Bloom words, k-Hash, 1-Hash and KMV sketches identical;
     TC (and the Bloom LCC) within rtol 1e-4 of the numpy estimators;
     ``exact_triangle_count`` equal to trace(A³)/6 and the exact
     session's Adamic–Adar / Resource-Allocation within rtol 1e-5 of
     numpy sums over np.intersect1d; the Bloom 4- and 5-clique estimates
     within rtol 1e-5 of numpy's, and the exact branch's counts equal to
     4,032,443 and 26,522,168 (brute force).

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. It also fails at once without a CUDA
device, or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
#: when this process started importing (phase 3l's subprocess reports it)
T_IMPORT = time.perf_counter()

#: Kronecker scale of the main path: 2^21 vertices, ~31.8M edges
SCALE = 21
#: phase 3m: the benchmark's Bloom configuration (scale 24) and the seed
#: of its edge order
FUSED_PASS_CONFIG = SRC.parent / "graphbench" / "configs" / "kron24_bf.json"
FUSED_PASS_SEED = 1
#: scale of the 5-clique and k-Hash 4-clique passes (phase 3c)
CLIQUE5_SCALE = 16
#: exact counts of kronecker(12, 16, seed=1), by brute force over sets
EXACT_4CLIQUES_12, EXACT_5CLIQUES_12 = 4_032_443, 26_522_168
#: row widths of the adaptive Bloom's size classes (phase 2 and 3g), words
ADAPTIVE_WIDTHS = tuple(1 << i for i in range(1, 13))
#: phase 3g: the scale of the second link-prediction graph, where the
#: removed edges are fewer than the candidates and the ranking decides ef
LINKPRED_SMALL_SCALE = 16
#: phase 3g: the dedup corpus (originals, planted near-duplicates, token
#: lengths, vocabulary), its parameters, and the docs checked against numpy
DEDUP_DOCS, DEDUP_DUPS, DEDUP_LEN, DEDUP_VOCAB = 45_000, 5_000, (200, 2000), \
    50_257
DEDUP_THRESHOLD, DEDUP_W = 0.7, 5
DEDUP_CHECKED, DEDUP_SAMPLED = 2_000, 200
#: phase 3h: rank counts whose shards are computed one after another in
#: one process (NCCL takes one rank per GPU, and the machine has one)
SHARD_RANKS = (2, 4, 8)

#: phase 2's attention cells: the prefill_32k cell of these configs, one
#: sequence of its global batch; gemma_2b's sequence cut to its published
#: context of 8,192 tokens (arXiv:2403.08295), deepseek_v3's (MLA: H = KV
#: = 128, D = qk_nope + qk_rope = 192, v padded to it) to phase 3j's
#: prefill length (see ``attention_shapes``)
ATTN_ARCHS = ("qwen3_8b", "h2o_danube3_4b", "gemma_2b", "deepseek_v3")
ATTN_CONTEXT = {"gemma_2b": 8192, "deepseek_v3": 2048}
#: the float32 route's timing length, at qwen3_8b's heads
ATTN_FP32_SEQ = 4096
#: the float32 route's other timed cells (see ``fp32_attention_shapes``):
#: a 3-group GQA layer (H 6, KV 2, D 64) at ATTN_FP32_SEQ
ATTN_FP32_GQA3 = (6, 2, 64)
#: SASS opcodes of the tensor cores, none of which the float32 library may
#: hold
TENSOR_CORE_OPS = ("HMMA", "HGMMA", "IMMA", "IGMMA", "BMMA", "DMMA",
                   "QGMMA", "UTCHMMA")
#: bound on the mean |kernel - plain| of a bfloat16 case (see attn_tol)
ATTN_BF16_MEAN = 1e-3

#: phase 3i: the full-width model, its prefill length, the per-layer
#: check's length, the decode check (batch, tokens), the serving run
#: (prompt lengths, sampled tokens, cache length, temperature) and the
#: float32 route's depth (full width)
MODEL_ARCH = "qwen3_8b"
PREFILL_SEQ, HOOK_SEQ = 8192, 2048
DECODE_BATCH, DECODE_TOKENS = 2, 64
SERVE_PROMPTS, SERVE_TOKENS, SERVE_MAX_LEN, SERVE_TEMPERATURE = \
    (3, 11, 20, 32), 32, 128, 0.8
FP32_LAYERS = 4
#: phase 3i: decode steps profiled at the serving batch
PROFILE_STEPS = 4

#: phase 3j: the MoE, MLA, SSM and hybrid configs at full width, cut in
#: depth only: (arch, layers run)
ARCH_MODELS = (("phi35_moe", 8), ("deepseek_v3", 4), ("jamba15_large", 2),
               ("mamba2_130m", 24))
#: phase 3j: the prefill length (a multiple of ssm_chunk 64), MLA's
#: absorbed-decode check's positions, and the configs served
ARCH_SEQ, MLA_DECODE_POS = 2048, 32
ARCH_SERVED = ("mamba2_130m", "phi35_moe")
#: phase 3j: the weights a bf16 model keeps in float32 (the reference's)
FLOAT32_LEAVES = ("router", "a_log", "d_skip", "dt_bias")
#: phase 3j bounds, shares of the float32 result's max |value| (and, for
#: the MoE, of its mean |value|): see check_moe_layer, check_mla_decode
MOE_BF16_TOL, MOE_BF16_MEAN_TOL, MLA_DECODE_TOL = 2.0 ** -5, 2.0 ** -6, \
    2.0 ** -5
#: phase 3j: mamba2_130m's decode against its prefill, shares of max
#: |logit|. bf16: 0.5. The reference's own bf16 decode and prefill lie
#: 0.171-0.359 apart at full width on the CPU (five weight draws; the port
#: 0.155-0.383 on the same weights; tests/bf16_drift.py), beyond 3i's
#: 2L·2^-8 = 0.1875 in four of five: an SSD layer's bf16 error is 3-5
#: times an attention or MLP sublayer's, and the stack carries it with a
#: gain above 1. So the model-level bf16 check catches gross faults only;
#: the SSM layer alone (SSM_LAYER_TOL) bounds the bf16 path. float32 (the
#: same config, fresh weights): 1e-3, the check of the algorithm itself.
SSM_DECODE_BF16, SSM_DECODE_FP32 = 0.5, 1e-3
#: phase 3j: the first SSM layer alone, bf16: its ssm_decode steps against
#: its ssm_fwd on the same input, max |diff| within 2^-5 of max |forward|
#: and mean within 2^-7 of mean |forward|. The reference's own at
#: mamba2_130m's width on the CPU: max 0.8-1.7%, mean 0.61-0.65% (the
#: port's 0.45-0.74%, 0.29-0.31%; tests/bf16_drift.py).
SSM_LAYER_TOL, SSM_LAYER_MEAN_TOL = 2.0 ** -5, 2.0 ** -7

#: phase 3k: the training path at full width: the config, its sequence
#: (``train_4k``'s, the global batch cut to 1), the steps of the
#: ``train()`` run (timed on steps 2-4), and AdamW's depth (its float32
#: moments for all 36 layers, 65.5 GB, beside weights and gradients, do
#: not fit on one card) and steps
TRAIN_ARCH, TRAIN_SEQ, TRAIN_STEPS = "qwen3_8b", 4096, 5
ADAMW_LAYERS, ADAMW_STEPS = 8, 4

#: phase 3l: the dry-run cells on the 16×16 production mesh (arch, shape,
#: optimization profile), traced in parallel subprocesses; the local
#: shard's cell and steps (the first is warm-up, the last profiled)
DRYRUN_CELLS = (("qwen3_8b", "train_4k", False),
                ("qwen3_8b", "decode_32k", False),
                ("deepseek_v3", "train_4k", True))
SHARD_ARCH, SHARD_SHAPE, SHARD_STEPS = "qwen3_8b", "train_4k", 4
#: phase 3l: the required useful share of the qwen3_8b train_4k cell's
#: counted flops (model_flops + attention_flops over them)
USEFUL_RANGE = (0.5, 1.05)

#: why a row's ``library_ms`` is null: no single PyTorch call computes it
NO_LIBRARY = {
    "popcount": "no PyTorch call computes a gather, a bitwise AND tree and "
                "a popcount (torch has no popcount)",
    "minhash": "no PyTorch call computes it: compare, mask and sum are "
               "three calls",
}

#: the card's published peaks (H100 SXM data sheet): HBM bytes/s, and the
#: float32 rate outside the tensor cores (an FMA counted as two), flop/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
#: the INT32 rate, for integer operations (compares, bitwise ops,
#: popcounts, adds): 64 INT32 lanes per SM x 132 SMs x the 1,980 MHz
#: maximum SM clock, ops/s
PEAK_INT32_OPS_S = 64 * 132 * 1.98e9
#: dense bf16 tensor-core rate, flop/s
PEAK_BF16_FLOPS = 989e12


def require(cond: bool, msg: str) -> None:
    """Fail the run (non-zero exit, no result line) unless ``cond``."""
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(log: str) -> list:
    """Per kernel of an nvcc ``-Xptxas -v`` log: its name (demangled by
    c++filt where the machine has it), registers and spill-store bytes."""
    entries, current, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            entries.append(dict(kernel=current, registers=int(m.group(1)),
                                spill_stores=spill))
            current = None
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(e["kernel"] for e in entries),
            capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) == len(entries):
        for e, name in zip(entries, names):
            e["kernel"] = name.replace("(anonymous namespace)::", "")
    return entries


def time_ms(fn, flush, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn()`` with CUDA events.

    ``flush()`` runs before each launch: it evicts L2 (the sketch is larger
    than L2, so its callers find it cold) and keeps the device busy long
    enough that the host has enqueued ``fn``'s launches before the start
    event fires, so the events time the device work and not the host's
    Python in between.
    """
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: float, ops: float, peak_ops: float = PEAK_INT32_OPS_S
             ) -> tuple[float, str]:
    """Least time for the work: max(bytes / HBM rate, ops / peak rate);
    ``ops`` are integer operations unless another rate is given."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_flush(torch):
    """A flush for :func:`time_ms`: a 2 GiB write evicts L2 and keeps the
    card busy while the host enqueues the timed launches."""
    scratch = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()
    return flush


def popcount_programs(setexpr, program):
    """The programs phase 2 and the card tests hold both popcount forms to:
    name -> Program over tuples of 8 columns. The k-way ANDs run the
    kernels' template; "AND3@4,0,2" is the template reading permuted
    columns; every other program the interpreted path (up to 8 leaves)."""
    r = setexpr.rows(8)
    u, v, w, x = r[:4]
    exprs = {"AND2": u & v, "AND3": u & v & w, "AND4": u & v & w & x,
             "OR": u | v, "ANDNOT": u - v, "nested": (u | (v & w)) - (x | u),
             "AND8": setexpr.and_all(*r),
             "mixed8": ((r[0] & r[1]) | (r[2] & r[3]))
             - ((r[4] | r[5]) & (r[6] | r[7])),
             "permuted": (setexpr.Row(6) | setexpr.Row(1)) - setexpr.Row(4)}
    progs = {k: setexpr.compile_program(e) for k, e in exprs.items()}
    chain = program.and_program(3)
    progs["AND3@4,0,2"] = program.Program(ops=chain.ops, args=chain.args,
                                          slots=(4, 0, 2))
    return progs


def shifted(torch, x):
    """A copy of contiguous ``x`` whose base lies one word past an
    allocation's start (4-byte but not 8- or 16-byte aligned)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def phase_kernels(torch, setexpr, fused_expr, ref, flush):
    """Phase 2, popcount kernels: parity on many shapes, then timing of
    each form the main path or a reference kernel uses, at the main path's
    shape."""
    from repro_torch.kernels import program

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    programs = popcount_programs(setexpr, program)
    n = 100_003
    cases = [(W, T) for W in (2, 8, 32, 34) for T in (1, 999, 65_549,
                                                        1_000_003)]
    cases += [(600, T) for T in (1, 999, 70_001)]
    # tile edges, every vector width and column blocks
    cases += [(W, T) for W in (1, 3, 4, 30, 31, 33, 128, 129)
              for T in (1, 31, 32, 33, 65, 4099)]
    # the scale-21 Bloom stream's width (phase 3f): its 64-pair batch and
    # a refresh launch
    cases += [(24, T) for T in (1, 64, 65_536)]
    checked = 0
    # max |kernel - plain| per form and program
    err = {f"{form}/{name}": 0 for form in ("gather", "rows")
           for name in programs}

    def check(key, got, want, what):
        err[key] = max(err[key], int((got - want).abs().max()))
        require(torch.equal(got, want),
                f"{key} {what}: {int((got != want).sum())} of {want.numel()} "
                "differ from the plain version")

    for W, T in cases:
        data = torch.randint(-2**31, 2**31 - 1, (n, W), dtype=torch.int32,
                             device=dev, generator=gen)
        data[0] = -1                                  # an all-ones row
        # ids in [-3, n + 3): negative and past-the-end ids clamp
        tuples = torch.randint(-3, n + 3, (T, 8), dtype=torch.int32,
                               device=dev, generator=gen)
        tuples[::7, 0] = 0
        pairs = tuples[:, :2].contiguous()            # 8-byte id loads
        for d, how in ((data, ""), (shifted(torch, data), " (shifted)")):
            what = f"W={W} T={T}{how}"
            for name, prog in programs.items():
                want = ref.fused_gather_popcount(d, tuples, prog)
                check(f"gather/{name}",
                      fused_expr.fused_gather_popcount(d, tuples, prog),
                      want, what)
                rows = [ref.gather_rows(d, tuples[:, s]) for s in prog.slots]
                if how:
                    rows[0] = shifted(torch, rows[0])
                check(f"rows/{name}", fused_expr.fused_rows_popcount(
                    rows, prog), want, what)
                checked += 2
            for tp, tw in ((pairs, " [T, 2]"),
                           (shifted(torch, pairs), " [T, 2] shifted")):
                check("gather/AND2", fused_expr.fused_gather_popcount(
                    d, tp, programs["AND2"]), ref.fused_gather_popcount(
                    d, tp, programs["AND2"]), what + tw)
                checked += 1
        del data, tuples, pairs, rows
    torch.cuda.synchronize()
    print(f"phase 2: popcount kernels equal their plain versions on "
          f"{checked} cases ({len(cases)} shapes x {len(programs)} programs "
          f"x 2 forms x aligned and 4-byte shifted operands, and [T, 2] "
          f"ids); max_abs_err {max(err.values())}", flush=True)
    # the adaptive Bloom pass's widths (phase 3g): the dense AND2 over
    # folded operands of every power-of-two width up to 4,096 words
    and2, wide = programs["AND2"], 0
    for W in ADAPTIVE_WIDTHS:
        for T in (1, 33, max(65, (1 << 22) // W)):
            a, b = (torch.randint(-2**31, 2**31 - 1, (T, W),
                                  dtype=torch.int32, device=dev,
                                  generator=gen) for _ in range(2))
            a[::5] = -1                               # all-ones rows
            want = ref.fused_rows_popcount([a, b], and2)
            for lhs, how in ((a, ""), (shifted(torch, a), " (shifted)")):
                check("rows/AND2", fused_expr.fused_rows_popcount(
                    [lhs, b], and2), want, f"W={W} T={T}{how} (adaptive)")
                wide += 1
    print(f"phase 2: the dense AND2 equals its plain version at the adaptive "
          f"pass's widths {ADAPTIVE_WIDTHS[0]}..{ADAPTIVE_WIDTHS[-1]} words "
          f"({wide} cases, aligned and 4-byte shifted)", flush=True)

    # timing at the main path's shape: scale-21 rows of 32 words, one
    # 65,536-edge chunk; AND2 is the TC pass, AND3 the 4-clique form
    n21, W, T = 1 << 21, 32, 65_536
    data = torch.randint(-2**31, 2**31 - 1, (n21, W), dtype=torch.int32,
                         device=dev, generator=gen)
    tuples = torch.randint(0, n21, (T, 3), dtype=torch.int32, device=dev,
                           generator=gen)
    # row of the table -> (form, program); rows 1-2 are the kernels as PR
    # 11 timed them, rows 3-6 the reference's bf_intersect kernels, which
    # are these same forms
    forms = {"fused_gather_popcount": ("gather", "AND2"),
             "fused_rows_popcount": ("rows", "AND2"),
             "bf_intersect_pairs": ("rows", "AND2"),
             "bf_intersect3_pairs": ("rows", "AND3"),
             "bf_edge_intersect": ("gather", "AND2"),
             "bf_edge_intersect3": ("gather", "AND3")}
    timing = {}
    print(f"  [T, k] kernels' layout at W={W}: {fused_expr.tile_layout(data)}",
          flush=True)
    for name, (form, pname) in forms.items():
        prog = programs[pname]
        k = len(prog.slots)
        tup = tuples[:, :k].contiguous()
        ops = T * W * (k + 1)                 # k-1 ANDs, a popcount, an add
        if form == "gather":
            nbytes = int(torch.unique(tup).numel()) * W * 4 + T * k * 4 + T * 4
            ms = time_ms(lambda: fused_expr.fused_gather_popcount(
                data, tup, prog), flush)
            plain = time_ms(lambda: ref.fused_gather_popcount(data, tup, prog),
                            flush)
        else:
            rows = [data[tup[:, s].long()] for s in prog.slots]
            nbytes = k * T * W * 4 + T * 4
            ms = time_ms(lambda: fused_expr.fused_rows_popcount(rows, prog),
                         flush)
            plain = time_ms(lambda: ref.fused_rows_popcount(rows, prog),
                            flush)
            del rows
        bound, by = bound_ms(nbytes, ops)
        timing[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                            bound_by=by, bytes=nbytes, form=f"{form}/{pname}",
                            max_abs_err=err[f"{form}/{pname}"],
                            library_note=NO_LIBRARY["popcount"],
                            timed_at=f"{form} {pname}, T={T} random tuples, "
                                     f"W={W}, {n21} rows (a TC pass chunk)")
        print(f"  {name} ({form}, {pname}): {ms:.4f} ms (plain {plain:.4f} "
              f"ms, bound {bound:.4f} ms by {by}, {nbytes} bytes, "
              f"{bound / ms:.1%} of bound) at T={T} W={W}", flush=True)
    del data, tuples
    torch.cuda.empty_cache()
    return timing


def minhash_rows(torch, gen, e: int, k: int, sentinel: int):
    """Row pairs drawn from [-40, sentinel + 40): negative ids, pads above
    the sentinel and duplicates within rows; b copies about half of a's
    positions (aligned matches), every 13th row of a and of b (offset) is
    all sentinel."""
    a = torch.randint(-40, sentinel + 40, (e, k), dtype=torch.int32,
                      device="cuda", generator=gen)
    b = torch.randint(-40, sentinel + 40, (e, k), dtype=torch.int32,
                      device="cuda", generator=gen)
    b = torch.where(torch.rand((e, k), device="cuda", generator=gen) < 0.5,
                    a, b)
    a[::13] = sentinel
    b[5::13] = sentinel
    return a, b


#: the MinHash counts: rows form (the TPU kernels' signature) -> gather form
MINHASH_FORMS = {"mh_intersect_pairs": "mh_intersect_gather",
                 "khash_match_pairs": "khash_match_gather"}


def phase_minhash_kernels(torch, mh_intersect, ref, flush):
    """Phase 2, MinHash counts, both forms: parity over k and ragged E,
    then timing at the main path's shape (E = 65,536 pairs, k = 31), with
    the old route of the TC pass (two row copies, then the rows kernel)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    sentinel, n = 150, 100_003
    err = {name: 0 for pair in MINHASH_FORMS.items() for name in pair}
    cases = [(k, e) for k in (1, 4, 7, 24, 28, 31, 32, 33)
             for e in (0, 1, 999, 65_537, 1_000_003)]
    cases += [(k, e) for k in (128, 256) for e in (0, 1, 999, 70_001)]
    # the scale-21 k-Hash stream's k (phase 3f): its pair batch, a refresh
    cases += [(22, e) for e in (64, 65_536)]
    checked = 0

    def check(name, got, want, what):
        require(got.shape == want.shape and got.dtype == torch.int32,
                f"{name} {what}: output {got.dtype}{list(got.shape)}")
        if got.numel():
            err[name] = max(err[name], int((got - want).abs().max()))
        require(torch.equal(got, want),
                f"{name} {what}: {int((got != want).sum())} pairs differ "
                "from the plain version")

    for k, e in cases:
        a, b = minhash_rows(torch, gen, e, k, sentinel)
        data, _ = minhash_rows(torch, gen, n, k, sentinel)
        # ids in [-3, n + 3): negative and past-the-end ids clamp
        pairs = torch.randint(-3, n + 3, (e, 2), dtype=torch.int32,
                              device="cuda", generator=gen)
        pairs[::7, 1] = pairs[::7, 0]
        for rows_name, gather_name in MINHASH_FORMS.items():
            what = f"k={k} E={e}"
            want = getattr(ref, rows_name)(a, b, sentinel)
            check(rows_name, getattr(mh_intersect, rows_name)(a, b, sentinel),
                  want, what)
            check(rows_name, getattr(mh_intersect, rows_name)(
                shifted(torch, a), b, sentinel), want, what + " (shifted a)")
            want = getattr(ref, gather_name)(data, pairs, sentinel)
            for x, how in ((data, ""), (shifted(torch, data), " (shifted)")):
                check(gather_name, getattr(mh_intersect, gather_name)(
                    x, pairs, sentinel), want, what + how)
            checked += 4
        del a, b, data, pairs
    torch.cuda.synchronize()
    print(f"phase 2: MinHash kernels equal their plain versions on "
          f"{checked} cases ({len(cases)} (k, E) shapes x 2 counts x rows "
          f"and gather forms, each aligned and 4-byte shifted); max_abs_err "
          f"{err}", flush=True)

    e, k = 65_536, 31
    a, b = minhash_rows(torch, gen, e, k, sentinel)
    data, _ = minhash_rows(torch, gen, 1 << 21, k, sentinel)
    pairs = torch.randint(0, 1 << 21, (e, 2), dtype=torch.int32,
                          device="cuda", generator=gen)
    u, v = pairs[:, 0].long(), pairs[:, 1].long()
    timing = {}
    for rows_name, gather_name in MINHASH_FORMS.items():
        ops = e * k * k if rows_name == "mh_intersect_pairs" else e * k
        rows_fn = getattr(mh_intersect, rows_name)
        gather_fn = getattr(mh_intersect, gather_name)
        forms = (
            (rows_name, lambda: rows_fn(a, b, sentinel),
             lambda: getattr(ref, rows_name)(a, b, sentinel),
             2 * e * k * 4 + e * 4, f"E={e} row pairs"),
            (gather_name, lambda: gather_fn(data, pairs, sentinel),
             lambda: getattr(ref, gather_name)(data, pairs, sentinel),
             e * (8 + 2 * k * 4 + 4),
             f"E={e} pairs by id from a {1 << 21}-row sketch"))
        for name, fn, plain_fn, nbytes, shape in forms:
            ms = time_ms(fn, flush)
            plain = time_ms(plain_fn, flush)
            bound, by = bound_ms(nbytes, ops)
            timing[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                bound_by=by, bytes=nbytes,
                                max_abs_err=err[name],
                                library_note=NO_LIBRARY["minhash"],
                                timed_at=f"{shape}, k={k} (a TC pass "
                                         "chunk)")
            extra = ""
            if name == gather_name:
                old = time_ms(lambda: rows_fn(data.index_select(0, u),
                                              data.index_select(0, v),
                                              sentinel), flush)
                timing[name]["old_route_ms"] = old
                extra = (f"; old route (two index_select row copies, then "
                         f"the rows kernel) {old:.4f} ms")
            print(f"  {name}: {ms:.4f} ms (plain {plain:.4f} ms, bound "
                  f"{bound:.4f} ms by {by}, {nbytes} bytes, {ops} compares, "
                  f"{bound / ms:.1%} of bound) at E={e} k={k}{extra}",
                  flush=True)
    del a, b, data, pairs
    return timing


def attention_shapes():
    """Phase 2's attention shapes from the port's configs: name -> (batch,
    seq, heads, kv heads, head dim, window) for each of ``ATTN_ARCHS`` at
    the prefill_32k cell (``ATTN_CONTEXT`` caps the sequence), and the
    float32 route's shape: qwen3_8b's heads at ``ATTN_FP32_SEQ``."""
    from repro_torch import configs
    from repro_torch.models import SHAPES

    cell = SHAPES["prefill_32k"]
    shapes = {}
    for name in ATTN_ARCHS:
        c = configs.get(name)
        shapes[name] = (1, min(cell.seq_len, ATTN_CONTEXT.get(name,
                                                               cell.seq_len)),
                        c.num_heads, c.num_kv_heads, c.head_dim,
                        c.sliding_window)
    b, _, h, kv, d, window = shapes["qwen3_8b"]
    return shapes, (b, ATTN_FP32_SEQ, h, kv, d, window)


def fp32_attention_shapes():
    """The float32 route's timed cells: name -> (batch, seq, heads, kv
    heads, head dim, window). The timing shape (qwen3_8b's heads at
    ATTN_FP32_SEQ, the first), phase 3i's float32 layer (the same heads at
    HOOK_SEQ), gemma_2b's MQA heads at ATTN_FP32_SEQ, and a 3-group GQA
    layer (ATTN_FP32_GQA3) at ATTN_FP32_SEQ."""
    from repro_torch import configs

    shapes = {}
    for name, seq in (("qwen3_8b", ATTN_FP32_SEQ), ("qwen3_8b", HOOK_SEQ),
                      ("gemma_2b", ATTN_FP32_SEQ)):
        c = configs.get(name)
        shapes[f"{name} S={seq}"] = (1, seq, c.num_heads, c.num_kv_heads,
                                     c.head_dim, c.sliding_window)
    h, kv, d = ATTN_FP32_GQA3
    shapes[f"gqa3 S={ATTN_FP32_SEQ}"] = (1, ATTN_FP32_SEQ, h, kv, d, 0)
    return shapes


def fp32_build_summary(lib_path) -> tuple[str, list]:
    """The float32 library's ``-Xptxas -v`` lines, one per block shape
    (head dim DP, rows R, threads): registers and spill bytes, with the
    dynamic shared memory and the blocks resident on an SM that the CUDA
    occupancy API reports for it."""
    import ctypes

    shapes, entry = [], None
    log = (lib_path.parent / "flash_attention.log").read_text()
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*flash_fwd_kernelILi(\d+)"
                      r"ELi(\d+)ELi(\d+)E", line)
        if m:
            entry = dict(dp=int(m.group(1)), rows=int(m.group(2)),
                         threads=int(m.group(3)), spill_stores=0,
                         spill_loads=0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            entry["registers"] = int(m.group(1))
            shapes.append(entry)
            entry = None
    occ = (ctypes.c_int * 45)()
    rc = ctypes.CDLL(str(lib_path)).pg_flash_occupancy(occ)
    require(rc == 0, f"pg_flash_occupancy failed: error {rc}")
    fit = {tuple(occ[5 * i:5 * i + 3]): (occ[5 * i + 3], occ[5 * i + 4])
           for i in range(9)}
    for e in shapes:
        e["smem_bytes"], e["blocks_per_sm"] = fit[(e["dp"], e["rows"],
                                                  e["threads"])]
    require(len(shapes) == 9, f"ptxas reported {len(shapes)} float32 "
            f"kernels, expected 9")
    text = "; ".join(
        f"DP={e['dp']} R={e['rows']} {e['threads']} threads: "
        f"{e['registers']} registers, spill stores/loads "
        f"{e['spill_stores']}/{e['spill_loads']} bytes, {e['smem_bytes']} "
        f"bytes shared, {e['blocks_per_sm']} block(s) = "
        f"{e['blocks_per_sm'] * e['threads'] // 32} warps an SM"
        for e in sorted(shapes, key=lambda e: (e["dp"], -e["rows"])))
    return text, shapes


def sass_counts(lib_path) -> dict | None:
    """Per kernel of a built library, from ``cuobjdump -sass`` (None where
    the toolkit has no cuobjdump): FFMA, LDS.128 and tensor-core
    instructions (TENSOR_CORE_OPS) in the whole function, and (FFMA,
    LDS.128, LDS of any width) in each innermost loop that holds FFMA (a
    loop: the instructions from a backward branch's target to the
    branch). Instructions predicated on ``!PT`` never run and are not
    counted."""
    from repro_torch.kernels import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    functions, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"flash_fwd_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                          m.group(1))
            name = (f"DP={k.group(1)} R={k.group(2)} {k.group(3)} threads"
                    if k else m.group(1))
            functions[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if name is not None and m and "@!PT" not in m.group(2):
            functions[name].append((int(m.group(1), 16), m.group(2)))
    tensor = re.compile(r"\b(" + "|".join(TENSOR_CORE_OPS) + r")\b")

    def count(ins):
        return (sum(bool(re.search(r"\bFFMA\b", t)) for _, t in ins),
                sum(bool(re.search(r"\bLDS\.128\b", t)) for _, t in ins),
                sum(bool(re.search(r"\bLDS\b", t)) for _, t in ins))
    counts = {}
    for name, ins in functions.items():
        loops = []
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
        inner = [(a, b) for a, b in loops
                 if not any(a <= c and d <= b and (c, d) != (a, b)
                            for c, d in loops)]
        ffma, lds128, _ = count(ins)
        counts[name] = dict(
            ffma=ffma, lds128=lds128,
            tensor=sum(bool(tensor.search(t)) for _, t in ins),
            loops=[c for c in (count([x for x in ins if a <= x[0] <= b])
                               for a, b in sorted(set(inner))) if c[0]])
    return counts


def sm_clocks(torch, load, measure, seconds: float = 0.5):
    """Run ``load()`` for ``seconds``, then ``measure()`` (a timing of the
    same work), while nvidia-smi samples the SM clock every 20 ms; returns
    (what ``measure`` returned, the median SM clock in MHz, the number of
    samples)."""
    poll = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "20"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            load()
            torch.cuda.synchronize()
        result = measure()
        torch.cuda.synchronize()
    finally:
        poll.terminate()
        out, _ = poll.communicate(timeout=30)
    mhz = sorted(int(x) for x in out.split() if x.strip().isdigit())
    return result, (mhz[len(mhz) // 2] if mhz else None), len(mhz)


def attended_pairs(s: int, window: int) -> int:
    """(query, key) pairs causal attention over s positions attends."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def library_attention(torch, q, k, v, window: int):
    """``scaled_dot_product_attention`` on the same inputs (a yardstick
    only: the port never calls it). A window needs a boolean mask, which
    only the memory-efficient backend takes at S = 32K, and that backend
    wants the kv heads expanded (done here, outside the timed call)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if not window:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    g = q.shape[2] // k.shape[2]
    kt, vt = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
    pos = torch.arange(q.shape[1], device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)
    return call


def attn_tol(v, dtype_name: str) -> dict:
    """Kernel vs plain attention. float32: sums in another order, the
    reference's own 2e-5. bfloat16: the tensor-core kernel rounds P to
    bf16 before P·V, which moves an output by at most 2^-9·max|v| (l is
    summed from the fp32 P); twice that covers the accumulation order and
    where the scale is applied, on top of one bf16 rounding of the output
    (atol 1e-3, rtol 1e-2). The mean error stays <= ATTN_BF16_MEAN."""
    if dtype_name == "float32":
        return dict(atol=2e-5, rtol=2e-5)
    return dict(atol=1e-3 + 2.0 ** -8 * float(v.float().abs().max()),
                rtol=1e-2)


def wgmma_build_summary(lib_path) -> str:
    """The tensor-core library's ``-Xptxas -v`` lines (one per (Dp, BKV)
    instantiation: the entry register count and spills) with the role
    budgets the kernel sets with setmaxnreg."""
    import ctypes
    import re

    regs = (ctypes.c_int * 2)()
    ctypes.CDLL(str(lib_path)).pg_flash_wgmma_roles(regs)
    log = (lib_path.parent / "flash_attention_wgmma.log").read_text()
    shapes = re.findall(r"flash_wgmma_kernelILi(\d+)ELi(\d+)E", log)
    used = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        log)
    parts = [f"Dp={dp} BKV={bkv}: {u} registers at entry, spill stores/"
             f"loads {st}/{ld} bytes"
             for (dp, bkv), u, (st, ld) in zip(shapes[::2], used, spills)]
    return (f"producer warpgroup setmaxnreg {regs[0]}, consumer warpgroups "
            f"{regs[1]}; " + "; ".join(parts))


def phase_attention(torch, flash_attention, ref, flush, lib_path,
                    fp32_lib_path):
    """Phase 2, attention: both routes against the plain version over
    types, head dims and layouts (the float32 route also over 3-group GQA,
    8-head MQA packs and rows that are not 16-byte aligned), then the
    prefill shapes (bf16, the tensor-core route): one counted drive
    through the entry point, parity, and timing; then the float32 route,
    counted on its own and timed at ``fp32_attention_shapes``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    err = {"float32": 0.0, "bfloat16": 0.0}
    mean_err = {"float32": 0.0, "bfloat16": 0.0}
    print(f"  flash_attention_wgmma build: {wgmma_build_summary(lib_path)}",
          flush=True)
    fp32_summary, fp32_shapes = fp32_build_summary(fp32_lib_path)
    print(f"  flash_attention (float32) build: {fp32_summary}", flush=True)
    sass = sass_counts(fp32_lib_path)
    if sass is None:
        print("  flash_attention (float32) SASS: no cuobjdump in the "
              "toolkit, not counted", flush=True)
    else:
        require(len(sass) == 9 and not any(c["tensor"]
                                           for c in sass.values()),
                f"float32 library SASS: {sass}")
        print("  flash_attention (float32) SASS (cuobjdump -sass; no "
              "tensor-core instruction in any kernel): " + "; ".join(
                  f"{name}: innermost loops " + ", ".join(
                      f"{f} FFMA / {l} LDS.128 ({f / max(l, 1):.1f} each; "
                      f"{a} LDS of any width)" for f, l, a in c["loops"])
                  + f"; whole function {c['ffma']} FFMA / {c['lds128']} "
                  f"LDS.128" for name, c in sass.items()), flush=True)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def check(got, want, v, what):
        name = str(want.dtype).split(".")[-1]
        diff = (got.float() - want.float()).abs()
        e, mean = float(diff.max()), float(diff.mean())
        err[name] = max(err[name], e)
        mean_err[name] = max(mean_err[name], mean)
        require(got.dtype == want.dtype and got.shape == want.shape
                and torch.allclose(got.float(), want.float(),
                                   **attn_tol(v, name))
                and (name == "float32" or mean <= ATTN_BF16_MEAN),
                f"flash_attention {what}: max |kernel - plain| {e}, mean "
                f"{mean} ({got.dtype}{list(got.shape)})")

    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 64, 120, 128, 256):
            for h, kv in ((4, 4), (4, 2), (4, 1)):
                for window in (0, 8, 4096):
                    for sq in (1, 97, 1000, 4096):
                        q = randn(1, sq, h, d, dtype=dtype)
                        k, v = (randn(1, sq, kv, d, dtype=dtype)
                                for _ in range(2))
                        check(flash_attention.flash_attention(
                            q, k, v, window=window),
                            ref.causal_attention(q, k, v, window), v,
                            f"{dtype} D={d} H={h} KV={kv} window={window} "
                            f"S={sq}")
                        cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        for sq, skv, window in ((1000, 97, 0), (97, 1000, 0), (1000, 97, 8),
                                (4096, 1, 3)):
            q, k, v = (randn(n, s, 64, dtype=dtype)
                       for n, s in ((8, sq), (2, skv), (2, skv)))
            check(flash_attention.flash_attention_folded(q, k, v, groups=4,
                                                         window=window),
                  ref.flash_attention_folded(q, k, v, groups=4,
                                             window=window), v,
                  f"{dtype} folded Sq={sq} Skv={skv} window={window}")
            cases += 1
    # the float32 kernel's head packs: 3 groups, and 8 heads of one kv head
    for d in (16, 64, 128, 256):
        for h, kv in ((6, 2), (8, 1)):
            for window in (0, 8):
                for sq in (97, 1000, 4096):
                    q = randn(1, sq, h, d)
                    k, v = randn(1, sq, kv, d), randn(1, sq, kv, d)
                    check(flash_attention.flash_attention(q, k, v,
                                                          window=window),
                          ref.causal_attention(q, k, v, window), v,
                          f"float32 D={d} H={h} KV={kv} window={window} "
                          f"S={sq}")
                    cases += 1
    # rows that are not 16-byte aligned: the kernel's 8- and 4-byte copies
    for what, d, cut in (("D=30", 30, None), ("D=31", 31, None),
                         ("[..., 2:32] of D=40", 40, (2, 32)),
                         ("[..., 1:31] of D=40", 40, (1, 31))):
        for window in (0, 8):
            q = randn(2, 1000, 4, d)
            k, v = randn(2, 1000, 2, d), randn(2, 1000, 2, d)
            if cut:
                q, k, v = (x[..., cut[0]:cut[1]] for x in (q, k, v))
            check(flash_attention.flash_attention(q, k, v, window=window),
                  ref.causal_attention(q, k, v, window), v,
                  f"float32 {what} window={window}")
            cases += 1
    torch.cuda.synchronize()
    print(f"phase 2: flash_attention equals its plain version on {cases} "
          f"cases (float32 atol=rtol=2e-5; bfloat16 atol 1e-3 + "
          f"2^-8·max|v|, rtol 1e-2, mean <= {ATTN_BF16_MEAN}); "
          f"max_abs_err {err}, largest mean_abs_err {mean_err}", flush=True)

    # the entry point at the prefill shapes, once each, counted
    attn_shapes, fp32_shape = attention_shapes()
    inputs = {}
    for name, (b, sq, h, kv, d, window) in attn_shapes.items():
        inputs[name] = (randn(b, sq, h, d, dtype=torch.bfloat16),
                        randn(b, sq, kv, d, dtype=torch.bfloat16),
                        randn(b, sq, kv, d, dtype=torch.bfloat16), window)
    flash_attention.reset_launch_counts()
    outs = {name: flash_attention.flash_attention(q, k, v, window=window)
            for name, (q, k, v, window) in inputs.items()}
    torch.cuda.synchronize()
    launches = dict(flash_attention.ROUTE_LAUNCHES)
    require(launches == {"wgmma_bf16": len(attn_shapes), "fma_fp32": 0},
            f"flash_attention at the prefill shapes launched {launches}, "
            f"expected {len(attn_shapes)} wgmma_bf16 and no fma_fp32")
    timing = {}
    for name, (q, k, v, window) in inputs.items():
        b, sq, h, kv, d, _ = attn_shapes[name]
        out = outs.pop(name)
        require(bool(torch.isfinite(out).all()),
                f"flash_attention {name}: non-finite output")
        want = ref.causal_attention(q, k, v, window)
        check(out, want, v, name)
        kernel_err = float((out.float() - want.float()).abs().max())
        flops = 4 * b * h * d * attended_pairs(sq, window)
        nbytes = 2 * (2 * b * sq * h * d + 2 * b * sq * kv * d)
        bound, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        ms = time_ms(lambda: flash_attention.flash_attention(
            q, k, v, window=window), flush, reps=5, warmup=1)
        plain = time_ms(lambda: ref.causal_attention(q, k, v, window), flush,
                        reps=2, warmup=1)
        try:
            call = library_attention(torch, q, k, v, window)
            library = time_ms(call, flush, reps=3, warmup=1)
            library_err = float((call().transpose(1, 2).float()
                                 - want.float()).abs().max())
            why = ""
        except (RuntimeError, ValueError) as exc:   # OOM is a RuntimeError
            library, library_err = None, None
            why = f" ({type(exc).__name__}: {exc})"[:300]
        del want
        torch.cuda.empty_cache()
        timing[name] = dict(ms=ms, plain_ms=plain, library_ms=library,
                            library_note=why.strip(" ()") or None,
                            bound_ms=bound, bound_by=by, flops=flops,
                            bytes=nbytes, max_abs_err=err["bfloat16"],
                            timed_at=f"{name}: B={b} S={sq} H={h} KV={kv} "
                                     f"D={d} window={window}, bf16")
        lib = "null" + why if library is None else f"{library:.3f} ms"
        print(f"  flash_attention_wgmma {name} (B={b} S={sq} H={h} KV={kv} "
              f"D={d} window={window}, bf16): {ms:.3f} ms (plain "
              f"{plain:.3f} ms, scaled_dot_product_attention {lib}; bound "
              f"{bound:.3f} ms by {by}: {flops:.4g} flop, {nbytes} bytes; "
              f"{bound / ms:.2%} of bound, {flops / ms / 1e9:.1f} TFLOP/s); "
              f"max |kernel - plain| {kernel_err:.4g}, max |SDPA - plain| "
              f"{library_err if library_err is None else f'{library_err:.4g}'}",
              flush=True)
    del inputs, outs

    # the float32 route on its own path: one counted call, then timed at
    # each of fp32_attention_shapes (the timing shape first)
    b, sq, h, kv, d, window = fp32_shape
    q = randn(b, sq, h, d)
    k, v = randn(b, sq, kv, d), randn(b, sq, kv, d)
    flash_attention.reset_launch_counts()
    out = flash_attention.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    fp32_launches = dict(flash_attention.ROUTE_LAUNCHES)
    require(fp32_launches == {"wgmma_bf16": 0, "fma_fp32": 1},
            f"flash_attention on float32 launched {fp32_launches}")
    check(out, ref.causal_attention(q, k, v, window), v, "float32 timing shape")
    del out
    cells = {}
    for name, (b, sq, h, kv, d, window) in fp32_attention_shapes().items():
        if (b, sq, h, kv, d, window) != fp32_shape:
            q = randn(b, sq, h, d)
            k, v = randn(b, sq, kv, d), randn(b, sq, kv, d)
            check(flash_attention.flash_attention(q, k, v, window=window),
                  ref.causal_attention(q, k, v, window), v,
                  f"float32 {name}")
        flops = 4 * b * h * d * attended_pairs(sq, window)
        nbytes = 4 * (2 * b * sq * h * d + 2 * b * sq * kv * d)
        bound, by = bound_ms(nbytes, flops, PEAK_FP32_FLOPS)

        def call(q=q, k=k, v=v, window=window):
            return flash_attention.flash_attention(q, k, v, window=window)
        ms, mhz, samples = sm_clocks(
            torch, call, lambda: time_ms(call, flush, reps=10, warmup=1))
        plain = time_ms(lambda: ref.causal_attention(q, k, v, window), flush,
                        reps=3, warmup=1)
        try:
            library = time_ms(library_attention(torch, q, k, v, window),
                              flush, reps=3, warmup=1)
            why = ""
        except (RuntimeError, ValueError) as exc:
            library, why = None, f" ({type(exc).__name__}: {exc})"[:300]
        cells[name] = dict(ms=ms, plain_ms=plain, library_ms=library,
                           library_note=why.strip(" ()") or None,
                           bound_ms=bound, bound_by=by, sm_mhz=mhz,
                           max_abs_err=err["float32"],
                           timed_at=f"B={b} S={sq} H={h} KV={kv} D={d} "
                                    f"window={window}, float32")
        lib = "null" + why if library is None else f"{library:.3f} ms"
        print(f"  flash_attention fp32 {name} (B={b} S={sq} H={h} KV={kv} "
              f"D={d} window={window}, float32): {ms:.3f} ms at SM clock "
              f"{mhz} MHz (median of {samples} samples) (plain {plain:.3f} "
              f"ms, scaled_dot_product_attention {lib}; bound {bound:.3f} ms "
              f"by {by} at 67 TFLOP/s fp32; {bound / ms:.2%} of bound)",
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    first = next(iter(cells))
    timing["fp32"] = dict(cells[first], timed_at=cells[first]["timed_at"]
                          + " (no prefill shape is float32)",
                          fp32_cells=cells)
    return timing, launches["wgmma_bf16"], fp32_launches["fma_fp32"]


def phase_main(torch, np, TE, TG, kernels, scale: int):
    """Phase 3: the port's Bloom path at full size, then its checks."""
    t0 = time.perf_counter()
    g = TG.kronecker(scale, 16, seed=1, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    print(f"phase 3: kronecker({scale}, 16, seed=1): n={g.n} m={g.m} "
          f"d_max={g.d_max} generate+CSR {gen_s:.1f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sess = TE.session(g, "bf", storage_budget=1.0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tc = float(sess.triangle_count())
    pass_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lcc = sess.local_clustering()
    mean_lcc = float(lcc.mean())
    lcc_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    forms = dict(kernels.fused_expr.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    words = sess.sketch.data.shape[1]
    chunks = math.ceil(g.m / sess.plan.edge_chunk)
    print(f"  session: words={words} sketch={sess.stats()['sketch_bytes']} "
          f"bytes build {build_s:.3f} s; pass (TC) {pass_s:.3f} s; "
          f"LCC {lcc_s:.3f} s; edge_chunk={sess.plan.edge_chunk} "
          f"degree_order={sess.plan.degree_order}", flush=True)
    print(f"  TC={tc:.6g} mean LCC={mean_lcc:.6g} launches={launches} "
          f"by form={forms} peak device memory {peak} bytes", flush=True)
    require(sess.plan.use_kernel, "the main path must use the kernels")
    require(launches["fused_gather_popcount"] == 1
            and forms == {"gather/and2/card": 1},
            f"gather kernel launched {launches['fused_gather_popcount']} "
            f"times ({forms}), expected one gather/and2/card launch for the "
            f"pass")
    require(math.isfinite(tc) and tc > 0, f"TC {tc} not finite and positive")
    require(lcc.shape == (g.n,) and bool(torch.isfinite(lcc).all()),
            "LCC must be finite float32[n]")
    require(bool((lcc >= 0).all()), "LCC must be non-negative")

    # the runs below launch kernels too; they are not counted
    t0 = time.perf_counter()
    float(TE.MiningSession(g, sess.sketch, sess.plan).triangle_count())
    warm_pass_s = time.perf_counter() - t0
    print(f"  warm pass (TC, second session over the same sketch) "
          f"{warm_pass_s:.3f} s = {g.m / warm_pass_s:.4g} edges/s", flush=True)
    chunked = chunked_edge_pass(TE, g, sess.sketch, sess.plan)
    cards = sess.edge_cardinalities()
    require(torch.equal(cards.view(torch.int32), chunked.view(torch.int32)),
            f"fused per-edge pass: {int((cards != chunked).sum())} of {g.m} "
            "cardinalities differ in their bits from the chunked pass")
    del chunked
    print(f"  fused per-edge pass bit-identical to the chunked pass "
          f"({chunks} chunks of the gather AND2 and PyTorch's Eq. 2)",
          flush=True)
    plain_plan = sess.plan.with_(use_kernel=False)
    edges = g.edges[edge_sample(torch, np, g)]
    got = TE.tuple_cardinality_ones(sess.sketch, edges, sess.plan)
    want = TE.tuple_cardinality_ones(sess.sketch, edges, plain_plan)
    require(torch.equal(got, want),
            f"per-edge popcounts: {int((got != want).sum())} of "
            f"{edges.shape[0]} sampled edges differ from the plain path")
    t0 = time.perf_counter()
    tc_plain = float(TE.MiningSession(g, sess.sketch,
                                      plain_plan).triangle_count())
    plain_pass_s = time.perf_counter() - t0
    require(math.isclose(tc, tc_plain, rel_tol=1e-4),
            f"TC {tc} vs plain-path TC {tc_plain}")
    print(f"  {edges.shape[0]}-edge popcount sample equal to the plain "
          f"path; plain-path "
          f"TC={tc_plain:.6g} (pass {plain_pass_s:.3f} s)", flush=True)
    return g, sess, dict(launches=launches, forms=forms, chunks=chunks,
                n=g.n, m=g.m,
                gen_s=gen_s, build_s=build_s, pass_s=pass_s, lcc_s=lcc_s,
                warm_pass_s=warm_pass_s,
                plain_pass_s=plain_pass_s, tc=tc, mean_lcc=mean_lcc,
                peak_bytes=peak, words=words)


def chunked_edge_pass(TE, g, sketch, plan):
    """The Bloom per-edge pass as chunks: the gather AND2 on each
    ``plan.edge_chunk`` edges in hub order, PyTorch's Eq. 2 ops on its
    counts, the result unsorted (what ``edge_cardinalities`` ran before
    the fused store)."""
    edges_s, inv = TE.order_edges_by_hub(g, g.edges)
    return TE.map_edges(edges_s, TE.pair_cardinality_fn(g, sketch, plan),
                        plan)[inv]


def edge_sample(torch, np, g):
    """Indices of a fixed 1M-edge sample of ``g.edges`` (seed 0)."""
    return torch.from_numpy(np.random.default_rng(0).choice(
        g.m, size=min(g.m, 1_000_000), replace=False)).to("cuda")


def phase_minhash(torch, np, TE, kernels, g, chunks: int):
    """Phase 3b: the MinHash path on the scale-21 graph of phase 3."""
    from repro_torch.kernels import mh_intersect, ref
    from repro_torch.obs.metrics import REGISTRY

    sample = edge_sample(torch, np, g)
    u, v = (g.edges[sample, c].long() for c in (0, 1))
    results, sessions = {}, {}
    for kind, kw, kernel in (("kh", {}, "khash_match_pairs"),
                             ("1h", {"variant": "naive"},
                              "mh_intersect_pairs")):
        label = kind + ("-naive" if kw else "")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        sess = TE.session(g, kind, storage_budget=1.0, device="cuda", **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tc = float(sess.triangle_count())
        pass_s = time.perf_counter() - t0
        r = dict(build_s=build_s, pass_s=pass_s, tc=tc, k=sess.sketch.k,
                 sketch_bytes=sess.stats()["sketch_bytes"])
        if kind == "kh":
            t0 = time.perf_counter()
            lcc = sess.local_clustering()
            r["mean_lcc"] = float(lcc.mean())
            r["lcc_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            labels, num = sess.jarvis_patrick("jaccard", 0.05)
            r["clusters"] = int(num)
            r["jp_s"] = time.perf_counter() - t0
            r["jp_iterations"] = int(
                REGISTRY.gauge("cluster_cc_iterations").value)
            t0 = time.perf_counter()
            sim = sess.edge_similarity("jaccard")
            r["mean_jaccard"] = float(sim.mean())
            r["sim_s"] = time.perf_counter() - t0
        launches = kernels.launch_counts()
        forms = dict(mh_intersect.FORM_LAUNCHES)
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        r["launches"], r["forms"] = launches, forms
        print(f"phase 3b: {label}: k={r['k']} sketch={r['sketch_bytes']} "
              f"bytes build {build_s:.3f} s; pass (TC) {pass_s:.3f} s; "
              f"TC={tc:.6g}; launches={launches}; by form={forms}; peak "
              f"device memory {r['peak_bytes']} bytes", flush=True)
        if kind == "kh":
            print(f"  LCC mean {r['mean_lcc']:.6g} ({r['lcc_s']:.3f} s); "
                  f"Jarvis-Patrick (jaccard >= 0.05): {r['clusters']} "
                  f"clusters, {r['jp_iterations']} iterations "
                  f"({r['jp_s']:.3f} s); edge Jaccard mean "
                  f"{r['mean_jaccard']:.6g} ({r['sim_s']:.3f} s)",
                  flush=True)
            require(lcc.shape == (g.n,) and bool(torch.isfinite(lcc).all())
                    and bool((lcc >= 0).all()),
                    "kh LCC must be finite, non-negative float32[n]")
            require(labels.shape == (g.n,) and 1 <= r["clusters"] <= g.n
                    and bool((labels <= torch.arange(
                        g.n, device="cuda")).all()),
                    "Jarvis-Patrick labels must be int32[n] minima")
            require(sim.shape == (g.m,) and bool(torch.isfinite(sim).all())
                    and bool(((sim >= 0) & (sim <= 1)).all()),
                    "edge Jaccard must lie in [0, 1]")
        require(sess.plan.use_kernel, f"the {label} path must use the kernels")
        require(launches[kernel] == chunks
                and sum(launches.values()) == chunks
                and forms == {f"{kernel}/gather": chunks},
                f"{label}: launches {launches} ({forms}), expected {chunks} "
                f"of {kernel}, all in the gather form, and no other")
        require(math.isfinite(tc) and tc > 0, f"{label} TC {tc}")

        # the runs below launch kernels too; they are not counted
        t0 = time.perf_counter()
        float(TE.MiningSession(g, sess.sketch, sess.plan).triangle_count())
        r["warm_pass_s"] = time.perf_counter() - t0
        data, n = sess.sketch.data, sess.sketch.n
        ru, rv = data.index_select(0, u), data.index_select(0, v)
        want = getattr(ref, kernel)(ru, rv, n)
        for form, got in (
                ("rows", getattr(mh_intersect, kernel)(ru, rv, n)),
                ("gather", getattr(mh_intersect, MINHASH_FORMS[kernel])(
                    data, g.edges[sample], n))):
            require(torch.equal(got, want),
                    f"{label}: {int((got != want).sum())} of {u.numel()} "
                    f"sampled edges' match counts ({form} form) differ from "
                    "the plain version")
        t0 = time.perf_counter()
        tc_plain = float(TE.MiningSession(
            g, sess.sketch, sess.plan.with_(use_kernel=False)
        ).triangle_count())
        r["plain_pass_s"] = time.perf_counter() - t0
        require(math.isclose(tc, tc_plain, rel_tol=1e-4),
                f"{label} TC {tc} vs plain-path TC {tc_plain}")
        print(f"  warm pass {r['warm_pass_s']:.3f} s = "
              f"{g.m / r['warm_pass_s']:.4g} edges/s; {u.numel()}-edge "
              f"match-count sample (rows and gather forms) equal to the "
              f"plain version; plain-path "
              f"TC={tc_plain:.6g} (pass {r['plain_pass_s']:.3f} s)",
              flush=True)
        results[label], sessions[label] = r, sess
    return results, sessions


#: device cycles a warm timing holds the card before each launch (~1 ms at
#: 1.98 GHz): the host enqueues the launch meanwhile
HOLD_CYCLES = 2_000_000


def make_hold(torch):
    """A stand-in for :func:`make_flush` that keeps the card busy without
    touching memory (``torch.cuda._sleep``), so :func:`time_ms` times a
    launch that finds the rows its previous runs read still in L2."""
    def hold():
        torch.cuda._sleep(HOLD_CYCLES)
    return hold


def hub_chunks(g, plan) -> dict:
    """Two chunks of the Bloom TC pass as it launches them: the edges in
    hub order (``order_edges_by_hub``) cut into ``plan.edge_chunk``
    tuples; the first (the hubbiest) and the median one, int32[T, 2]."""
    from repro_torch.engine.plan import order_edges_by_hub

    edges, _ = order_edges_by_hub(g, g.edges)
    c = plan.edge_chunk
    mid = -(-edges.shape[0] // c) // 2
    return {"hub chunk": edges[:c].contiguous(),
            "median chunk": edges[mid * c:(mid + 1) * c].contiguous()}


def phase_real_chunks(torch, kernels, g, sess, kh_sess) -> dict:
    """Phase 3d: the AND2 gather on two real chunks of the Bloom TC pass
    (:func:`hub_chunks`), checked against the plain version, timed with L2
    flushed and warm (no flush), each beside its bound (each distinct row,
    id and output once) and beside ``khash_match_gather`` on the same pairs
    over the phase-3b k-Hash sketch."""
    from repro_torch.kernels import program, ref

    fe, mh = kernels.fused_expr, kernels.mh_intersect
    data, W = sess.sketch.data, sess.sketch.data.shape[1]
    kdata, kn = kh_sess.sketch.data, kh_sess.sketch.n
    prog = program.and_program(2)
    flush, hold = make_flush(torch), make_hold(torch)
    timing = {}
    for label, pairs in hub_chunks(g, sess.plan).items():
        T = pairs.shape[0]
        call = lambda: fe.fused_gather_popcount(data, pairs, prog)
        want = ref.fused_gather_popcount(data, pairs, prog)
        got = call()
        require(torch.equal(got, want),
                f"gather AND2 on the {label}: {int((got != want).sum())} of "
                f"{T} popcounts differ from the plain version")
        rows = int(torch.unique(pairs).numel())
        nbytes = rows * W * 4 + T * 2 * 4 + T * 4
        bound, by = bound_ms(nbytes, T * W * 3)
        ms, warm = time_ms(call, flush), time_ms(call, hold)
        plain = time_ms(lambda: ref.fused_gather_popcount(data, pairs, prog),
                        flush)
        kcall = lambda: mh.khash_match_gather(kdata, pairs, kn)
        kms, kwarm = time_ms(kcall, flush), time_ms(kcall, hold)
        timed_at = (f"gather AND2, the {label} of the scale-{SCALE} Bloom TC "
                    f"pass in hub order: T={T}, {rows} distinct rows, W={W}")
        print(f"phase 3d: {timed_at}: {ms:.4f} ms L2 flushed, {warm:.4f} ms "
              f"warm (plain {plain:.4f} ms; bound {bound:.4f} ms by {by}, "
              f"{nbytes} bytes, {bound / ms:.1%} / {bound / warm:.1%}); "
              f"khash_match_gather on the same pairs (k={kdata.shape[1]}) "
              f"{kms:.4f} / {kwarm:.4f} ms; popcounts equal the plain "
              f"version; layout {fe.tile_layout(data)}", flush=True)
        timing[f"fused_gather_popcount[{label}]"] = dict(
            ms=ms, warm_ms=warm, plain_ms=plain, bound_ms=bound, bound_by=by,
            bytes=nbytes, max_abs_err=int((got - want).abs().max()),
            khash_gather_ms=kms, khash_gather_warm_ms=kwarm,
            library_note=NO_LIBRARY["popcount"], timed_at=timed_at)
    del flush
    torch.cuda.empty_cache()
    return timing


def phase_fused_pass(torch, TE, kernels) -> dict:
    """Phase 3m: the Bloom per-edge pass at scale 24, fused against
    chunked (see the module docstring); returns the kernel table's record
    of the fused form."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(SRC.parent))
    from graphbench import generator
    from repro_torch.core.graph import from_edge_array

    config = json.loads(FUSED_PASS_CONFIG.read_text())
    t0 = time.perf_counter()
    raw = generator.kronecker_edges(config, FUSED_PASS_SEED, "cuda")
    raw_host = raw.cpu().numpy()
    del raw
    g = from_edge_array(1 << config["scale"], raw_host, device="cuda")
    del raw_host
    sess = TE.session(g, config["sketch"],
                      storage_budget=config["storage_budget"],
                      num_hashes=config["num_hashes"], device="cuda")
    sk, plan, fe = sess.sketch, sess.plan, kernels.fused_expr
    torch.cuda.synchronize()
    m, words = g.m, sk.data.shape[1]
    chunks = math.ceil(m / plan.edge_chunk)
    require(TE.fuses_edge_pass(sk, plan, g.edges.device),
            "the benchmark's Bloom session must take the fused pass")
    print(f"phase 3m: {FUSED_PASS_CONFIG.name}: n={g.n} m={m} words={words} "
          f"b={sk.num_hashes}; graph and sketch in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    forms_of = {"fused": lambda: TE.edge_cardinalities(g, sk, plan),
                "chunked": lambda: chunked_edge_pass(TE, g, sk, plan)}
    stats = {label: dict(wall_s=[]) for label in forms_of}
    out = {}
    for label in ("fused", "chunked", "chunked", "fused",
                  "fused", "chunked"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        out[label] = forms_of[label]()
        torch.cuda.synchronize()
        stats[label]["wall_s"].append(time.perf_counter() - t)
        stats[label]["forms"] = dict(fe.FORM_LAUNCHES)
        stats[label]["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    fused, chunked = out["fused"], out["chunked"]
    require(torch.equal(fused.view(torch.int32), chunked.view(torch.int32)),
            f"scale-24 fused pass: {int((fused != chunked).sum())} of {m} "
            "cardinalities differ in their bits from the chunked pass")
    require(stats["fused"]["forms"] == {"gather/and2/card": 1}
            and stats["chunked"]["forms"] == {"gather/and2": chunks},
            f"launches by form: fused {stats['fused']['forms']}, chunked "
            f"{stats['chunked']['forms']} (expected 1 and {chunks})")
    del out, fused, chunked
    for label, fn in forms_of.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        tile = [e for e in device if "tile_popcount_kernel" in e.key]
        stats[label].update(
            busy_ms=sum(e.self_device_time_total for e in device) / 1e3,
            kernel_ms=sum(e.self_device_time_total for e in tile) / 1e3,
            kernel_launches=sum(e.count for e in tile),
            device_ops=sum(e.count for e in device),
            kernel_names=sorted({e.key for e in tile}))
    names = stats["fused"]["kernel_names"]
    require(len(names) == 1 and "GatherSrc" in names[0]
            and "CardStore" in names[0],
            f"the fused pass's gather kernel under the profiler: {names}")

    order = TE.hub_order(g, g.edges)
    call = lambda: fe.fused_gather_cardinality(sk.data, g.edges,
                                               sk.num_hashes, order=order)
    ms = time_ms(call, make_flush(torch), reps=5, warmup=1)
    rows = int((g.deg > 0).sum())
    nbytes = rows * words * 4 + m * (8 + 8 + 4)
    bound, by = bound_ms(nbytes, m * words * 3)
    for label, st in stats.items():
        walls = sorted(st["wall_s"])
        print(f"  {label} pass: wall {walls[len(walls) // 2]:.4f} s "
              f"(runs {', '.join(f'{w:.4f}' for w in st['wall_s'])}), "
              f"launches {st['forms']}, peak {st['peak_bytes']} bytes above "
              f"its start; profiled: {st['device_ops']} device ops, busy "
              f"{st['busy_ms']:.3f} ms, gather kernel {st['kernel_ms']:.3f} "
              f"ms in {st['kernel_launches']} launches", flush=True)
    print(f"  fused kernel alone (order precomputed, L2 flushed): {ms:.3f} "
          f"ms; bound {bound:.3f} ms by {by} ({nbytes} bytes: {rows} rows "
          f"named, ids, order, float store), {bound / ms:.1%}; equal bits "
          f"to the chunked pass; profiler name {names[0][:120]}", flush=True)
    del sess, sk, g, order
    torch.cuda.empty_cache()
    walls = {label: sorted(st["wall_s"])[1] for label, st in stats.items()}
    return {"fused_gather_cardinality": dict(
        ms=ms, plain_ms=None, bound_ms=bound, bound_by=by, bytes=nbytes,
        max_abs_err=0, pass_s=walls["fused"],
        pass_kernel_ms=stats["fused"]["kernel_ms"],
        pass_launches=stats["fused"]["kernel_launches"],
        chunked_pass_s=walls["chunked"],
        chunked_kernel_ms=stats["chunked"]["kernel_ms"],
        chunked_launches=stats["chunked"]["kernel_launches"],
        library_note=NO_LIBRARY["popcount"],
        timed_at=(f"the Bloom per-edge pass of {FUSED_PASS_CONFIG.name} "
                  f"(scale {config['scale']}): T={m}, {rows} rows named, "
                  f"W={words}, b={config['num_hashes']}, hub order"))}


def wedge_candidates(np, g) -> int:
    """Σ over canonical edges (u, v) of |{w ∈ N_v : w > v}|, in numpy."""
    indptr, indices = g.indptr.cpu().numpy(), g.indices.cpu().numpy()
    row = np.repeat(np.arange(g.n), np.diff(indptr))
    up = np.bincount(row[indices > row], minlength=g.n)
    return int(up[g.edges[:, 1].cpu().numpy()].sum())


def hub_edge_sample(torch, np, g, hubs: int = 4, per_hub: int = 64,
                    others: int = 4096):
    """Canonical edges: up to ``per_hub`` at each of the ``hubs`` vertices
    of highest degree, and ``others`` drawn at random (seed 0)."""
    top = torch.topk(g.deg, hubs).indices.to(torch.int32)
    picks = []
    for hub in top:
        at = torch.nonzero((g.edges == hub).any(dim=1)).squeeze(1)
        picks.append(at[torch.linspace(0, at.numel() - 1, min(
            per_hub, at.numel()), device=at.device).long()])
    picks.append(torch.from_numpy(np.random.default_rng(0).choice(
        g.m, size=min(others, g.m), replace=False)).to(g.edges.device))
    return g.edges[torch.unique(torch.cat(picks))]


def clique_pass(torch, kernels, fn):
    """Run ``fn()`` with launch counts zeroed just before and read just
    after; returns (value, seconds, launches, forms, peak bytes)."""
    from repro_torch.obs.metrics import REGISTRY

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    value = float(fn())
    seconds = time.perf_counter() - t0
    gauges = {name: int(REGISTRY.gauge(name).value) for name in (
        "clique_wedge_candidates", "clique_triangles",
        "clique_pair_candidates", "clique_quads")}
    return dict(value=value, s=seconds, launches=kernels.launch_counts(),
                forms=dict(kernels.fused_expr.FORM_LAUNCHES),
                peak_bytes=torch.cuda.max_memory_allocated(), **gauges)


def require_same_popcounts(torch, TE, sketch, plan, tuples, what: str):
    """Kernel-path popcounts of ``tuples`` equal the plain path's."""
    tuples = tuples.to(torch.int32)
    got = TE.tuple_cardinality_ones(sketch, tuples, plan)
    want = TE.tuple_cardinality_ones(sketch, tuples,
                                     plan.with_(use_kernel=False))
    require(torch.equal(got, want),
            f"{what}: {int((got != want).sum())} of {tuples.shape[0]} "
            "popcounts differ from the plain path")


def require_same_segment_popcounts(torch, TE, sketch, plan, segments,
                                   what: str) -> int:
    """Kernel-path popcounts of every launch of ``segments`` (see
    ``cliques.closed_segments``) equal the plain path's; returns the
    tuples checked."""
    from repro_torch.core.algorithms import cliques

    plain, checked = plan.with_(use_kernel=False), 0
    for segment in segments:
        for launch in cliques.segment_launches(*segment):
            got = TE.segment_cardinality_ones(sketch, *launch, plan)
            want = TE.segment_cardinality_ones(sketch, *launch, plain)
            require(torch.equal(got, want),
                    f"{what}: {int((got != want).sum())} of {got.numel()} "
                    "segmented popcounts differ from the plain path")
            checked += got.numel()
    return checked


def time_clique_form(torch, kernels, sketch, segments, flush, what: str
                     ) -> dict:
    """The first launch of a Bloom clique pass: the segmented kernel and
    the [T, k] gather kernel on the same tuples, checked against each other
    and the plain version, then timed in turns (gather, segmented,
    segmented, gather; L2 flushed before each launch) beside the plain
    time and two bounds: the segmented input's (each row, head, offset,
    tail and output once) and the [T, k] input's."""
    from repro_torch.core.algorithms import cliques
    from repro_torch.kernels import program, ref

    fe = kernels.fused_expr
    heads, offsets, tails = next(cliques.segment_launches(*next(segments)))
    T, k = tails.numel(), heads.shape[1] + 1
    data, W = sketch.data, sketch.data.shape[1]
    counts = (offsets[1:] - offsets[:-1]).long()
    tuples = torch.cat([heads.repeat_interleave(counts, 0), tails[:, None]],
                       dim=1).contiguous()
    prog = program.and_program(k)
    got = fe.fused_segment_popcount(data, heads, offsets, tails)
    gathered = fe.fused_gather_popcount(data, tuples, prog)
    want = ref.fused_segment_popcount(data, heads, offsets, tails)
    require(torch.equal(got, want) and torch.equal(gathered, want),
            f"AND{k} on {what}: {int((got != want).sum())} segmented and "
            f"{int((gathered != want).sum())} [T, k] popcounts of {T} differ "
            "from the plain version")
    used = counts > 0
    s_used = int(used.sum())
    rows = torch.unique(torch.cat([heads[used].reshape(-1), tails]))
    seg_bytes = (rows.numel() * W * 4 + s_used * (k - 1) * 4
                 + (s_used + 1) * offsets.element_size() + T * 4 + T * 4)
    tup_bytes = int(torch.unique(tuples).numel()) * W * 4 + T * k * 4 + T * 4
    # per tail word an AND, a popcount and an add; per head word k-2 ANDs
    bound, by = bound_ms(seg_bytes, T * W * 3 + s_used * W * (k - 2))
    bound_tuples, _ = bound_ms(tup_bytes, T * W * (k + 1))
    seg_call = lambda: fe.fused_segment_popcount(data, heads, offsets, tails)
    gather_call = lambda: fe.fused_gather_popcount(data, tuples, prog)
    g1 = time_ms(gather_call, flush, reps=10, warmup=2)
    s1 = time_ms(seg_call, flush, reps=10, warmup=2)
    s2 = time_ms(seg_call, flush, reps=10, warmup=2)
    g2 = time_ms(gather_call, flush, reps=10, warmup=2)
    ms, gather_ms = (s1 + s2) / 2, (g1 + g2) / 2
    plain = time_ms(lambda: ref.fused_segment_popcount(data, heads, offsets,
                                                       tails),
                    flush, reps=5, warmup=1)
    layout = fe.segment_layout(data)
    timed_at = (f"segment AND{k}, T={T} {what} in {s_used} segments "
                f"({heads.shape[0]} given), W={W}")
    print(f"  AND{k} on the first launch of the pass ({timed_at}; layout "
          f"{layout}): segmented {s1:.4f} / {s2:.4f} ms, [T, k] gather "
          f"{g1:.4f} / {g2:.4f} ms (in turns), plain {plain:.4f} ms; bound "
          f"{bound:.4f} ms by {by} ({seg_bytes} bytes, {bound / ms:.1%}), "
          f"[T, k] input's bound {bound_tuples:.4f} ms ({tup_bytes} bytes, "
          f"{bound_tuples / gather_ms:.1%} of the gather kernel); popcounts "
          f"equal each other and the plain version", flush=True)
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                bytes=seg_bytes, kernel="pg_fused_segment_popcount",
                gather_ms=gather_ms, bound_ms_tuples=bound_tuples,
                max_abs_err=int((got - want).abs().max()),
                library_note=NO_LIBRARY["popcount"], timed_at=timed_at)


def time_khash_clique_launch(torch, kernels, g, sketch) -> dict:
    """The first launch of the k-Hash 4-clique pass: ``khash_match_pairs``
    (rows form) on rows u and v of its first piece of triangles, checked
    against the plain version and timed beside its bound (L2 flushed)."""
    from repro_torch.core.algorithms import cliques
    from repro_torch.kernels import ref

    tri = next(cliques.closed_triangles(g, sketch))[:cliques._LAUNCH_TUPLES]
    mu, mv = (sketch.data.index_select(0, tri[:, c].long()) for c in (0, 1))
    T, k, n = mu.shape[0], mu.shape[1], g.n
    fn = kernels.mh_intersect.khash_match_pairs
    got, want = fn(mu, mv, n), ref.khash_match_pairs(mu, mv, n)
    require(torch.equal(got, want),
            f"khash_match_pairs on the k-Hash 4-clique launch: "
            f"{int((got != want).sum())} of {T} counts differ from the plain "
            "version")
    flush = make_flush(torch)
    ms = time_ms(lambda: fn(mu, mv, n), flush, reps=10, warmup=2)
    plain = time_ms(lambda: ref.khash_match_pairs(mu, mv, n), flush,
                    reps=5, warmup=1)
    nbytes = 2 * T * k * 4 + T * 4
    bound, by = bound_ms(nbytes, T * k)
    timed_at = (f"rows form, E={T} pairs (u, v) of the first piece of "
                f"triangles of the k-Hash 4-clique pass, k={k}, "
                f"kronecker({CLIQUE5_SCALE}, 16, seed=1)")
    print(f"  khash_match_pairs on the first launch of the pass ({timed_at})"
          f": {ms:.4f} ms (plain {plain:.4f} ms, bound {bound:.4f} ms by "
          f"{by}, {nbytes} bytes, {bound / ms:.1%} of bound); counts equal "
          "the plain version", flush=True)
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                bytes=nbytes, timed_at=timed_at,
                max_abs_err=int((got - want).abs().max()))


def phase_cliques(torch, np, TE, TG, kernels, g, sess):
    """Phase 3c: 4-cliques on the phase-3 Bloom session at scale 21, then
    5-cliques (Bloom, AND4) and the k-Hash 4-clique at CLIQUE5_SCALE. The
    AND3 and AND4 forms are timed on the first launch of their pass."""
    from repro_torch.core.algorithms import cliques

    want_wedges = wedge_candidates(np, g)
    r4 = clique_pass(torch, kernels, sess.four_clique_count)
    and3 = r4["forms"].get("segment/and3", 0)
    print(f"phase 3c: 4-cliques, scale {SCALE} Bloom session: estimate "
          f"{r4['value']:.6g}; wedge candidates {r4['clique_wedge_candidates']}"
          f" (numpy {want_wedges}); tuples to the kernel "
          f"{r4['clique_triangles']}; AND3 launches {and3} "
          f"(launches {r4['launches']}); pass {r4['s']:.3f} s; peak device "
          f"memory {r4['peak_bytes']} bytes", flush=True)
    require(sess.plan.use_kernel, "the 4-clique pass must use the kernels")
    require(r4["clique_wedge_candidates"] == want_wedges,
            "4-clique wedge candidates differ from the numpy count")
    require(and3 >= -(-r4["clique_triangles"] // cliques._LAUNCH_TUPLES) > 0
            and r4["launches"]["fused_segment_popcount"] == and3
            and r4["launches"]["fused_gather_popcount"] == 0,
            f"4-clique pass: {and3} segmented AND3 launches for "
            f"{r4['clique_triangles']} tuples ({r4['forms']})")
    require(math.isfinite(r4["value"]) and r4["value"] > 0,
            f"4-clique estimate {r4['value']}")
    sample = hub_edge_sample(torch, np, g)
    tri = torch.cat(list(cliques.closed_triangles(g, sess.sketch,
                                                  edges=sample)))
    require_same_popcounts(torch, TE, sess.sketch, sess.plan,
                           tri[:2_000_000], "scale-21 triangle sample")
    seg_checked = require_same_segment_popcounts(
        torch, TE, sess.sketch, sess.plan,
        cliques.closed_segments(g, sess.sketch, 3, edges=sample),
        "scale-21 triangle sample")
    print(f"  {min(tri.shape[0], 2_000_000)} triangles of {sample.shape[0]} "
          f"sampled edges (hub edges included): AND3 popcounts equal the "
          f"plain path ([T, k] gather); all {seg_checked} through segments "
          f"too", flush=True)
    del tri
    flush = make_flush(torch)
    timing = {"bf_edge_intersect3": time_clique_form(
        torch, kernels, sess.sketch, cliques.closed_segments(g, sess.sketch),
        flush, f"survivor tuples of the scale-{SCALE} 4-clique pass")}

    t0 = time.perf_counter()
    g16 = TG.kronecker(CLIQUE5_SCALE, 16, seed=1, device="cuda")
    gen_s = time.perf_counter() - t0
    bf16s = TE.session(g16, "bf", storage_budget=1.0, device="cuda")
    r5 = clique_pass(torch, kernels, bf16s.five_clique_count)
    and4 = r5["forms"].get("segment/and4", 0)
    print(f"phase 3c: 5-cliques, kronecker({CLIQUE5_SCALE}, 16, seed=1) "
          f"(n={g16.n} m={g16.m}, generated in {gen_s:.1f} s) Bloom "
          f"words={bf16s.sketch.data.shape[1]}: estimate {r5['value']:.6g}; "
          f"wedges {r5['clique_wedge_candidates']}, triangles "
          f"{r5['clique_triangles']}, pair candidates "
          f"{r5['clique_pair_candidates']}, tuples to the kernel "
          f"{r5['clique_quads']}; AND4 launches {and4}; pass {r5['s']:.3f} s;"
          f" peak device memory {r5['peak_bytes']} bytes", flush=True)
    require(and4 >= -(-r5["clique_quads"] // cliques._LAUNCH_TUPLES) > 0
            and r5["launches"]["fused_segment_popcount"] == and4
            and r5["launches"]["fused_gather_popcount"] == 0,
            f"5-clique pass: {and4} segmented AND4 launches "
            f"({r5['forms']})")
    require(math.isfinite(r5["value"]) and r5["value"] > 0,
            f"5-clique estimate {r5['value']}")
    sample16 = hub_edge_sample(torch, np, g16, per_hub=16, others=1024)
    quads = torch.cat(list(cliques.closed_quads(g16, bf16s.sketch,
                                                edges=sample16)))
    require_same_popcounts(torch, TE, bf16s.sketch, bf16s.plan,
                           quads[:2_000_000], "scale-16 4-clique sample")
    seg_checked = require_same_segment_popcounts(
        torch, TE, bf16s.sketch, bf16s.plan,
        cliques.closed_segments(g16, bf16s.sketch, 4, edges=sample16),
        "scale-16 4-clique sample")
    print(f"  {min(quads.shape[0], 2_000_000)} 4-cliques of "
          f"{sample16.shape[0]} sampled edges (hub edges included): AND4 "
          f"popcounts equal the plain path ([T, k] gather); all "
          f"{seg_checked} through segments too", flush=True)
    del quads
    timing["fused_gather_popcount[AND4]"] = time_clique_form(
        torch, kernels, bf16s.sketch,
        cliques.closed_segments(g16, bf16s.sketch, 4), flush,
        f"survivor 4-cliques of the scale-{CLIQUE5_SCALE} 5-clique pass")
    del bf16s, flush

    kh = TE.session(g16, "kh", storage_budget=1.0, device="cuda")
    rk = clique_pass(torch, kernels, kh.four_clique_count)
    kforms = dict(kernels.mh_intersect.FORM_LAUNCHES)
    t0 = time.perf_counter()
    plain_kh = float(TE.MiningSession(g16, kh.sketch, kh.plan.with_(
        use_kernel=False)).four_clique_count())
    plain_kh_s = time.perf_counter() - t0
    print(f"phase 3c: k-Hash 4-cliques, kronecker({CLIQUE5_SCALE}) k="
          f"{kh.sketch.k}: estimate {rk['value']:.6g} (plain path "
          f"{plain_kh:.6g}, {plain_kh_s:.3f} s); triangles (exact closing) "
          f"{rk['clique_triangles']}; launches {rk['launches']}; pass "
          f"{rk['s']:.3f} s; peak device memory {rk['peak_bytes']} bytes",
          flush=True)
    rk["forms"] = kforms
    require(rk["launches"]["khash_match_pairs"] > 0
            and kforms == {"khash_match_pairs/rows":
                           rk["launches"]["khash_match_pairs"]},
            f"the k-Hash 4-clique pass launched {kforms}, expected the rows "
            "form of khash_match_pairs only")
    require(rk["value"] == plain_kh,
            f"k-Hash 4-cliques {rk['value']} vs plain path {plain_kh}")
    timing["khash_match_pairs[clique]"] = time_khash_clique_launch(
        torch, kernels, g16, kh.sketch)
    del kh, g16
    torch.cuda.empty_cache()
    return dict(four=r4, five=r5, kh=rk, and3=and3, and4=and4,
                timing=timing)


#: local clustering as the launcher runs it: 8 seeds from
#: default_rng(7) (``mine --algos localcluster``), alpha, eps
LC_SEEDS, LC_ALPHA, LC_EPS = 8, 0.15, 1e-4
#: the degree-chosen batch whose sweep times the dense AND2 (E = 128 x
#: 512): SWEEP_SEEDS seeds, of which TOP_HUBS hubs and EDGE_PUSHERS of the
#: highest degree that pushes, the rest the largest supports of a pool of
#: POOL_PER_BAND vertices per degree band from default_rng(POOL_SEED)
SWEEP_SEEDS, TOP_HUBS, EDGE_PUSHERS = 128, 8, 8
POOL_PER_BAND, POOL_SEED = 32, 11
#: seeds of the forced spill (dense push at [SPILL_SEEDS, n])
SPILL_SEEDS = 8
#: the batch's second push tolerance, through the sparse push (auto mode
#: would take the dense one): supports up to the sweep's cap
DEEP_EPS = 1e-5


def launcher_seeds(np, n: int, count: int):
    """``count`` seed ids from the launcher's generator, int32."""
    return np.random.default_rng(7).integers(0, n, size=count).astype(
        np.int32)


def host_intersections(np, indptr, indices, pairs) -> list:
    """|N_u ∩ N_v| per pair, by np.intersect1d over the host CSR."""
    return [np.intersect1d(indices[indptr[u]:indptr[u + 1]],
                           indices[indptr[v]:indptr[v + 1]],
                           assume_unique=True).size for u, v in pairs]


def row_member(torch, g):
    """z ∈ N_a by binary search inside a's CSR row (int32 positions): the
    lookup that phase 3e times against the port's edge-key search."""
    indptr = g.indptr.to(torch.int32)
    indices = g.indices
    last = indices.numel() - 1
    steps = int(g.d_max).bit_length()

    def member(a, z):
        z = z.to(torch.int32)
        lo = indptr[a]
        end = indptr[a + 1]
        hi = end.clone()
        for _ in range(steps):
            mid = (lo + hi) >> 1
            less = indices[mid.clamp(max=last)] < z
            live = lo < hi
            lo = torch.where(live & less, mid + 1, lo)
            hi = torch.where(live & ~less, mid, hi)
        return (lo < end) & (indices[lo.clamp(max=last)] == z)
    return member


def in_row_triangle_count(torch, exact, g, edge_chunk: int = 65536) -> int:
    """``exact_triangle_count`` with :func:`row_member` as its lookup."""
    member = row_member(torch, g)
    total = torch.zeros((), dtype=torch.int64, device=g.edges.device)
    for s in range(0, g.m, edge_chunk):
        total += exact.common_count(g, g.edges[s:s + edge_chunk],
                                    member).sum()
    return int(total) // 3


def phase_exact(torch, np, TE, kernels, g, estimates: dict):
    """Phase 3e, first half: the exact session's per-edge pass and
    ``exact_triangle_count`` at scale 21 (and the same count with the
    lookup the port did not choose, a search inside the CSR row), the TC
    estimates of phases 3/3b (``estimates``: sketch -> TC) against the
    exact count, and sampled per-edge counts against numpy."""
    from repro_torch.core import exact
    from repro_torch.core.graph import edge_keys

    deg = g.deg.to(torch.int64)
    lookups = int(torch.minimum(deg[g.edges[:, 0].long()],
                                deg[g.edges[:, 1].long()]).sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sx = TE.session(g, None, device="cuda")
    cards = sx.edge_cardinalities()
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    tc_sess = float(sx.triangle_count())
    launches = kernels.launch_counts()
    pass_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tc = int(exact.exact_triangle_count(g))
    tc_s = time.perf_counter() - t0
    tc_peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    tc_rows = in_row_triangle_count(torch, exact, g)
    rows_s = time.perf_counter() - t0
    total = int(cards.to(torch.float64).sum())
    rel = {kind: (est - tc) / tc for kind, est in estimates.items()}
    print(f"phase 3e: exact session (sketch=None), scale {SCALE}: per-edge "
          f"pass {pass_s:.3f} s ({lookups} lookups, {lookups / pass_s:.4g}/s"
          f"), peak device memory {pass_peak} bytes; session TC "
          f"{tc_sess:.9g}; exact_triangle_count {tc} in {tc_s:.3f} s (peak "
          f"{tc_peak} bytes); launches {sum(launches.values())}", flush=True)
    print(f"  lookups compared: edge-key search (the port's) {tc_s:.3f} s, "
          f"in-row binary search {rows_s:.3f} s ({rows_s / tc_s:.2f}x), "
          f"same count {tc_rows}", flush=True)
    print(f"  TC estimates against the exact {tc}: " + "; ".join(
        f"{kind} {estimates[kind]:.9g} (relative error {rel[kind]:+.6f})"
        for kind in estimates), flush=True)
    require(sum(launches.values()) == 0,
            f"the exact pass launched kernels: {launches}")
    require(total == 3 * tc, f"per-edge counts sum to {total}, not 3 x {tc}")
    require(tc_rows == tc, f"in-row search counts {tc_rows}, not {tc}")
    require(math.isclose(tc_sess, tc, rel_tol=1e-5),
            f"session TC {tc_sess} vs exact_triangle_count {tc}")
    sample = hub_edge_sample(torch, np, g, hubs=4, per_hub=64, others=1744)
    at = torch.searchsorted(edge_keys(g), sample[:, 0].long() * g.n
                            + sample[:, 1].long())
    want = host_intersections(np, g.indptr.cpu().numpy(),
                              g.indices.cpu().numpy(),
                              sample.cpu().numpy())
    got = exact.exact_pair_cardinalities(g, sample).cpu().numpy()
    require(got.tolist() == want and cards[at].cpu().numpy().astype(
        np.int64).tolist() == want,
            f"exact counts of {sample.shape[0]} sampled edges differ from "
            "np.intersect1d")
    print(f"  {sample.shape[0]} sampled edges (hub edges included, max "
          f"count {max(want)}): exact counts and the session's equal "
          f"np.intersect1d over the CSR", flush=True)
    return sx, dict(pass_s=pass_s, lookups=lookups, pass_peak=pass_peak,
                    tc=tc, tc_s=tc_s, tc_peak=tc_peak, tc_sess=tc_sess,
                    rows_s=rows_s, rel_err=rel)


def host_conductance(np, indptr, indices, deg, m: int, members) -> float:
    """φ of a vertex set from the host CSR: cut / min(vol, 2m - vol)."""
    nbrs = np.concatenate([indices[indptr[v]:indptr[v + 1]]
                           for v in members])
    cut = int((~np.isin(nbrs, members)).sum())
    vol = int(deg[members].sum())
    return cut / min(vol, 2 * m - vol)


def phase_local_cluster(torch, np, kernels, g, sess, sx):
    """Phase 3e, second half: ``local_cluster`` with the launcher's 8 seeds
    on the Bloom and the exact sessions (counts zeroed just before each,
    read just after), against the dense frontier and a host recount."""
    from repro_torch.core.algorithms import localcluster as LC

    seeds = launcher_seeds(np, g.n, LC_SEEDS)
    indptr, indices = g.indptr.cpu().numpy(), g.indices.cpu().numpy()
    deg = g.deg.cpu().numpy()
    out = {}
    for label, s in (("bf", sess), ("exact", sx)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = s.local_cluster(seeds, LC_ALPHA, LC_EPS)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        forms = dict(kernels.fused_expr.FORM_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        # the runs below launch kernels too; they are not counted
        t0 = time.perf_counter()
        s.local_cluster(seeds, LC_ALPHA, LC_EPS)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fr = LC.ppr_push_sparse(g, seeds, LC_ALPHA, LC_EPS)
        torch.cuda.synchronize()
        push_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        LC.sweep_cut(g, fr, s.sketch, s.plan)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = s.local_cluster(seeds, LC_ALPHA, LC_EPS,
                                frontier_mode="dense")
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        phi = res.best_conductance.cpu().numpy()
        print(f"phase 3e: local_cluster, {label} session, {LC_SEEDS} seeds, "
              f"alpha={LC_ALPHA} eps={LC_EPS}: sparse="
              f"{res.frontier is not None} (cap {fr.cap}) spilled="
              f"{res.spilled}; {res.iterations} push "
              f"rounds; support {res.support.tolist()}; frontier sizes "
              f"{fr.sizes().tolist()}; best sizes {res.best_size.tolist()}; "
              f"best conductance {[round(float(x), 6) for x in phi]}; pass "
              f"{pass_s:.3f} s, warm {warm_s:.3f} s (push {push_s:.3f} s, "
              f"sweep {sweep_s:.3f} s); launches {launches} by form {forms}; "
              f"peak device memory {peak} bytes; dense frontier "
              f"{dense.iterations} rounds {dense_s:.3f} s", flush=True)
        require(res.frontier is not None and not res.spilled,
                f"{label}: auto mode must take the sparse push at scale "
                f"{SCALE} without a spill")
        rows = launches["fused_rows_popcount"]
        if label == "bf":
            require(rows >= 1 and forms.get("rows/and2") == rows
                    and sum(launches.values()) == rows,
                    f"the Bloom sweep must launch fused_rows_popcount (AND2) "
                    f"and nothing else: {launches} {forms}")
        else:
            require(sum(launches.values()) == 0,
                    f"the exact sweep launched kernels: {launches}")
        require(torch.equal(dense.support, res.support),
                f"{label}: dense-frontier supports {dense.support.tolist()} "
                f"differ from the sparse {res.support.tolist()}")
        agree = torch.cumprod((dense.order == res.order).to(torch.int64),
                              1).bool()
        require(torch.equal(dense.conductance[agree], res.conductance[agree]),
                f"{label}: conductance profiles differ where orders agree")
        found = res.best_size.cpu().numpy() > 0
        require(found.any() and np.array_equal(np.isfinite(phi), found)
                and (phi[found] >= 0).all(),
                f"{label}: best conductances {phi} must be finite and "
                "non-negative exactly where a cluster was found (an isolated "
                "seed finds none), for at least one seed")
        if label == "exact":
            host = [host_conductance(np, indptr, indices, deg, g.m,
                                     res.members(i))
                    for i in np.flatnonzero(found)]
            require(np.allclose(phi[found], host, rtol=1e-5),
                    f"exact best conductance {phi} vs host recount {host}")
            print(f"  best conductances equal a host recount of each "
                  f"cluster's cut and volume; orders agree with the dense "
                  f"frontier on {agree.sum(1).tolist()} prefixes", flush=True)
        else:
            print(f"  orders agree with the dense frontier on "
                  f"{agree.sum(1).tolist()} prefixes (profiles equal there)",
                  flush=True)
        out[label] = dict(res=res, pass_s=pass_s, warm_s=warm_s,
                          push_s=push_s, sweep_s=sweep_s, dense_s=dense_s,
                          launches=launches, forms=forms, peak=peak,
                          rounds=res.iterations)
    bf, ex = (out[k]["res"].best_conductance.cpu().numpy()
              for k in ("bf", "exact"))
    print(f"  Bloom - exact best conductance per seed: "
          f"{[round(float(x), 6) for x in bf - ex]}", flush=True)
    out["seeds"] = seeds
    return out


def degree_batch(torch, np, LC, g):
    """The phase-3e batch of SWEEP_SEEDS seeds, chosen by degree: the
    TOP_HUBS vertices of highest degree (d > 1/eps, so the seed's unit
    residual never pushes), the EDGE_PUSHERS of highest degree that still
    push (d <= 1/eps: the longest CSR rows the push expands and the exact
    sweep reads), then the seeds of largest support (stable ties) among up
    to POOL_PER_BAND vertices of each degree band [2^b, 2^(b+1)), drawn
    from default_rng(POOL_SEED). Returns (int32 seeds, group slices, pool
    size)."""
    deg = g.deg.cpu().numpy().astype(np.int64)
    by_deg = np.argsort(-deg, kind="stable")
    limit = int(round(1.0 / LC_EPS))
    hubs = by_deg[:TOP_HUBS]
    pushers = by_deg[deg[by_deg] <= limit][:EDGE_PUSHERS]
    rng = np.random.default_rng(POOL_SEED)
    pool = []
    for b in range(limit.bit_length()):
        band = np.flatnonzero((deg >= 1 << b) & (deg < 2 << b)
                              & (deg <= limit))
        pool.append(rng.choice(band, size=min(POOL_PER_BAND, band.size),
                               replace=False))
    pool = np.setdiff1d(np.concatenate(pool), pushers)
    fr = LC.ppr_push_sparse(g, pool.astype(np.int32), LC_ALPHA, LC_EPS)
    require(not fr.overflowed, "the pool's push spilled")
    support = (fr.p > 0).sum(1).cpu().numpy()
    rest = SWEEP_SEEDS - TOP_HUBS - EDGE_PUSHERS
    best = pool[np.argsort(-support, kind="stable")[:rest]]
    seeds = np.concatenate([hubs, pushers, best]).astype(np.int32)
    groups = {"hubs": slice(0, TOP_HUBS),
              "pushers": slice(TOP_HUBS, TOP_HUBS + EDGE_PUSHERS),
              "pool": slice(TOP_HUBS + EDGE_PUSHERS, SWEEP_SEEDS)}
    return seeds, groups, pool.size


def expansion_slots(torch, LC, g, seeds, eps: float) -> tuple:
    """The sparse push of ``seeds`` with the ragged expansion's slots per
    round recorded (the degrees of the active entries, summed): (frontier,
    slots per round)."""
    deg = g.deg.to(torch.int64)
    slots, expand = [], LC.row_elements

    def counted(graph, rows, *args):
        slots.append(int(deg[rows].sum()))
        return expand(graph, rows, *args)
    LC.row_elements = counted
    try:
        fr = LC.ppr_push_sparse(g, seeds, LC_ALPHA, eps)
    finally:
        LC.row_elements = expand
    return fr, slots


def spread(x) -> str:
    """min/median/max of integers (the upper median of an even count)."""
    v = sorted(int(i) for i in x)
    return f"{v[0]}/{v[len(v) // 2]}/{v[-1]}" if v else "-"


def batch_pass(torch, np, kernels, g, s, label: str, seeds, groups,
               eps: float, **kw):
    """``local_cluster`` of the degree-chosen batch on session ``s``, its
    launch counts zeroed just before and read just after: the Bloom sweep
    must launch ``fused_rows_popcount`` (AND2) and nothing else, the exact
    one nothing; seeds of degree > 1/eps, whose unit residual cannot push,
    must find nothing."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = s.local_cluster(seeds, LC_ALPHA, eps, **kw)
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    forms = dict(kernels.fused_expr.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    support = res.support.cpu().numpy()
    best = res.best_size.cpu().numpy()
    k = res.order.shape[1]
    print(f"phase 3e: local_cluster, {label} session, the degree-chosen "
          f"batch, eps={eps}: sparse={res.frontier is not None} spilled="
          f"{res.spilled}; {res.iterations} push rounds; support "
          + "; ".join(f"{name} {spread(support[v])}"
                      for name, v in groups.items())
          + f" ({int((support == k).sum())} at the cap {k}, mean "
          f"{support.mean():.1f}); best sizes {spread(best)}; pass "
          f"{pass_s:.3f} s; launches {sum(launches.values())} by form "
          f"{forms}; peak device memory {peak} bytes", flush=True)
    require(res.frontier is not None and not res.spilled,
            f"{label}: the degree-chosen batch must take the sparse push "
            "without a spill")
    rows = launches["fused_rows_popcount"]
    if label == "bf":
        require(rows >= 1 and forms.get("rows/and2") == rows
                and sum(launches.values()) == rows,
                f"the Bloom sweep must launch fused_rows_popcount (AND2) "
                f"and nothing else: {launches} {forms}")
    else:
        require(sum(launches.values()) == 0,
                f"the exact sweep launched kernels: {launches}")
    quiet = g.deg.cpu().numpy()[seeds] > round(1.0 / eps)
    require((support[quiet] == 0).all() and (best[quiet] == 0).all(),
            f"{label}: seeds of degree > 1/eps cannot push, yet support "
            f"{support[quiet].tolist()}")
    return res


def sweep_and2(torch, kernels, sess, order, what: str, flush, hold):
    """The Bloom sweep's dense AND2 on the operands of sweep ``order``, as
    launched (every row) and on the rows of real steps alone (a sentinel
    step repeats row 0's operands), against its plain version; then timed
    with L2 flushed and warm beside its bound."""
    from repro_torch.core.algorithms import localcluster as LC
    from repro_torch.kernels import program, ref

    fe = kernels.fused_expr
    nbr, prefix = LC.sweep_operands(sess.sketch, order)
    real = (order.reshape(-1) < sess.graph.n).nonzero().squeeze(1)
    prog = program.and_program(2)
    call = lambda: fe.fused_rows_popcount([nbr, prefix], prog)
    want = ref.fused_rows_popcount([nbr, prefix], prog)
    got = call()
    real_got = fe.fused_rows_popcount([nbr[real], prefix[real]], prog)
    real_want = ref.fused_rows_popcount([nbr[real], prefix[real]], prog)
    E, W = nbr.shape
    require(torch.equal(got, want) and torch.equal(real_got, real_want)
            and torch.equal(real_got, got[real]),
            f"dense AND2 on {what}: {int((got != want).sum())} of {E} "
            f"popcounts ({int((real_got != real_want).sum())} of "
            f"{real.numel()} real rows) differ from the plain version")
    nbytes = 2 * E * W * 4 + E * 4
    bound, by = bound_ms(nbytes, E * W * 3)
    ms, warm = time_ms(call, flush), time_ms(call, hold)
    plain = time_ms(lambda: ref.fused_rows_popcount([nbr, prefix], prog),
                    flush)
    timed_at = (f"rows AND2, {what}: E={E} (= {order.shape[0]} x "
                f"{order.shape[1]}), W={W}, {real.numel()} rows of real "
                f"steps")
    print(f"phase 3e: {timed_at} ({real.numel() / E:.1%}): kernel "
          f"{ms:.4f} ms L2 flushed, {warm:.4f} ms warm (plain {plain:.4f} "
          f"ms; bound {bound:.4f} ms by {by}, {nbytes} bytes, "
          f"{bound / ms:.1%} / {bound / warm:.1%}); popcounts equal the "
          f"plain version on every row and on the real rows alone",
          flush=True)
    return dict(ms=ms, warm_ms=warm, plain_ms=plain, bound_ms=bound,
                bound_by=by, bytes=nbytes,
                max_abs_err=int((got - want).abs().max()),
                real_rows=int(real.numel()),
                library_note=NO_LIBRARY["popcount"], timed_at=timed_at)


def phase_degree_batch(torch, np, kernels, g, sess, sx) -> dict:
    """Phase 3e: the degree-chosen batch of SWEEP_SEEDS seeds (see
    :func:`degree_batch`) through ``local_cluster`` on the Bloom and the
    exact sessions, with its push's expansion slots per round; a spill
    forced by a small frontier cap; the same batch at eps = DEEP_EPS
    through the sparse push (supports up to the sweep's cap, hub seeds
    that push); and the dense AND2 on both Bloom sweeps' operands (E =
    SWEEP_SEEDS x sweep_cap) against its plain version, timed with L2
    flushed and warm beside its bound (the eps = LC_EPS sweep is the
    ``[sweep]`` record)."""
    from repro_torch.core.algorithms import localcluster as LC
    from repro_torch.obs.metrics import REGISTRY

    t0 = time.perf_counter()
    seeds, groups, pool = degree_batch(torch, np, LC, g)
    pick_s = time.perf_counter() - t0
    deg = g.deg.cpu().numpy().astype(np.int64)
    indptr, indices = g.indptr.cpu().numpy(), g.indices.cpu().numpy()
    print(f"phase 3e: degree-chosen batch of {SWEEP_SEEDS} seeds (picked in "
          f"{pick_s:.3f} s from a pool of {pool}): degrees min/median/max "
          + "; ".join(f"{k} {spread(deg[seeds[v]])}" for k, v in
                      groups.items()), flush=True)
    runs = {}
    for eps, kw in ((LC_EPS, {}), (DEEP_EPS, {"frontier_mode": "sparse"})):
        fr, slots = expansion_slots(torch, LC, g, seeds, eps)
        acl = 1.0 / (LC_ALPHA * eps)
        print(f"phase 3e: sparse push of the batch, eps={eps}: "
              f"{fr.iterations} rounds, expansion slots per round {slots} "
              f"(sum {sum(slots)}, {sum(slots) / (SWEEP_SEEDS * acl):.2%} "
              f"of the ACL bound {SWEEP_SEEDS} x 1/(alpha eps) = "
              f"{SWEEP_SEEDS * acl:.0f}), frontier sizes "
              f"{spread(fr.sizes())} of cap {fr.cap}", flush=True)
        require(not fr.overflowed, f"the batch's push at eps={eps} spilled")
        bf, ex = (batch_pass(torch, np, kernels, g, s, label, seeds, groups,
                             eps, **kw)
                  for label, s in (("bf", sess), ("exact", sx)))
        require(torch.equal(bf.support, ex.support),
                f"eps={eps}: the Bloom and exact sessions' pushes differ")
        # the exact best conductance of the seeds with the longest rows
        # swept and of the seed of largest support, recounted on the host
        phi = ex.best_conductance.cpu().numpy()
        pushing = np.flatnonzero(deg[seeds] <= round(1.0 / eps))
        check = [int(i) for i in [*pushing[np.argsort(
                     -deg[seeds[pushing]], kind="stable")[:4]],
                     int(np.argmax(ex.support.cpu().numpy()))]
                 if np.isfinite(phi[i])]
        host = [host_conductance(np, indptr, indices, deg, g.m,
                                 ex.members(i)) for i in check]
        require(np.allclose(phi[check], host, rtol=1e-5),
                f"exact best conductance {phi[check]} vs host {host}")
        print(f"  exact best conductances of seeds {check} (degrees "
              f"{deg[seeds[check]].tolist()}) equal a host recount",
              flush=True)
        runs[eps] = dict(fr=fr, bf=bf)

    # a spill: the SPILL_SEEDS of largest frontier at LC_EPS, with a
    # frontier cap below their frontier sizes, must fall back to the dense
    # push
    sizes = runs[LC_EPS]["fr"].sizes()
    bf = runs[LC_EPS]["bf"]
    top = np.argsort(-sizes, kind="stable")[:SPILL_SEEDS]
    require(sizes[top].min() >= 3, f"frontiers {sizes[top]} too small to "
            "spill")
    # its pow2 bucket stays below every one of those frontier sizes
    small = int(sizes[top].min()) // 2
    at = torch.as_tensor(top, device=bf.support.device)
    spills = REGISTRY.counter("ppr.spill").value
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sp = sess.local_cluster(seeds[top], LC_ALPHA, LC_EPS, frontier_cap=small)
    torch.cuda.synchronize()
    spill_s = time.perf_counter() - t0
    spill_launches = kernels.launch_counts()["fused_rows_popcount"]
    print(f"phase 3e: spill: {SPILL_SEEDS} seeds of frontier sizes "
          f"{sizes[top].tolist()} with frontier_cap={small}: spilled="
          f"{sp.spilled}, ppr.spill "
          f"+{REGISTRY.counter('ppr.spill').value - spills}, dense push "
          f"{sp.iterations} rounds, {spill_s:.3f} s, support "
          f"{sp.support.tolist()}, {spill_launches} AND2 launch", flush=True)
    require(sp.spilled and sp.frontier is None
            and REGISTRY.counter("ppr.spill").value == spills + 1
            and spill_launches >= 1,
            "a frontier cap below the support must spill to the dense push")
    require(torch.equal(sp.support, bf.support[at]),
            f"spilled supports {sp.support.tolist()} differ from the sparse "
            f"push's {bf.support[at].tolist()}")

    flush, hold = make_flush(torch), make_hold(torch)
    timing = sweep_and2(torch, kernels, sess, bf.order,
                        f"the sweep of the {SWEEP_SEEDS}-seed degree-chosen "
                        f"batch on the scale-{SCALE} Bloom session", flush,
                        hold)
    deep = sweep_and2(torch, kernels, sess, runs[DEEP_EPS]["bf"].order,
                      f"the same batch's sweep at eps={DEEP_EPS}", flush,
                      hold)
    timing.update(deep_ms=deep["ms"], deep_warm_ms=deep["warm_ms"],
                  deep_real_rows=deep["real_rows"])
    del flush
    torch.cuda.empty_cache()
    return {"fused_rows_popcount[sweep]": timing}


#: phase 3f: the launcher's split of the phase-3 edges (``stream_frac``
#: 0.3, ``default_rng(seed + 1)``) into 96 arrival chunks; Bloom batches
#: (the last one also profiled) and k-Hash batches. The host's set algebra
#: takes 20-40 s a delta at this size on an H100 machine's host, so the
#: stream replays 2 + 2 of the 96 chunks
STREAM_SEED, STREAM_FRAC, STREAM_CHUNKS = 1, 0.3, 96
STREAM_BATCHES, STREAM_KH_BATCHES = 2, 2
#: the spans a delta's wall time splits into (name printed -> span names)
STREAM_SPANS = {"host set algebra": ("graph.host_delta",),
                "host isin": ("graph.host_isin",),
                "host union1d": ("graph.host_union",),
                "host directed keys": ("graph.host_directed",),
                "device splice + CSR": ("graph.device_delta",),
                "sketch insert": ("sketch.insert",),
                "rebuild": ("sketch.rebuild",),
                "recompute set": ("stream.recompute_set",),
                "refresh": ("engine.refresh",)}


def stream_launches(kernels) -> dict:
    """Nonzero launches since the last reset, by kernel and by form (both
    forms' tables)."""
    counts = {**kernels.launch_counts(),
              **kernels.fused_expr.FORM_LAUNCHES,
              **kernels.mh_intersect.FORM_LAUNCHES}
    return {key: value for key, value in counts.items() if value}


def stream_batch(torch, np, kernels, trace, LS, st, server, chunks, b: int,
                 kind: str, profiler=None):
    """One batch of the replay: its delta (spans aggregated), then the
    launcher's five queries, answered by the server's auto-flush; launch
    counts zeroed before each part and read after it."""
    rng = np.random.default_rng([STREAM_SEED + 2, b])
    dels = LS.batch_deletes(st, rng, len(chunks[b]), 0.1)
    trace.clear()
    torch.cuda.synchronize()
    if profiler is not None:
        profiler.start()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    info = st.apply_delta(chunks[b], dels)
    torch.cuda.synchronize()
    delta_s = time.perf_counter() - t0
    delta_launches = stream_launches(kernels)
    spans = trace.aggregate()
    split = {label: sum(spans.get(name, {}).get("total_s", 0.0)
                        for name in names)
             for label, names in STREAM_SPANS.items()}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    q = LS.submit_queries(server, rng, st.dyn.n, 64)
    answers = server.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    if profiler is not None:
        profiler.stop()
    flush_launches = stream_launches(kernels)
    require(len(answers) == 5, f"stream batch {b}: {len(answers)} answers")
    bytes_init = st.dyn.traffic.bytes_init
    print(f"phase 3f: {kind} batch {b}: +{info['inserted']} "
          f"-{info['deleted']} touched {info['touched']} m={st.dyn.m}; "
          f"apply_delta {delta_s:.3f} s = "
          + ", ".join(f"{label} {sec:.3f}" for label, sec in split.items())
          + f" s; cards recomputed {info['cards_recomputed']} / carried "
          f"{info['cards_carried']}; rows rebuilt {info['rows_rebuilt_now']}"
          f"; uploaded {info['bytes_uploaded']} of bytes_init {bytes_init} "
          f"({info['bytes_uploaded'] / bytes_init:.4%}); delta launches "
          f"{delta_launches}; flush {flush_s:.3f} s, launches "
          f"{flush_launches}", flush=True)
    require(info["bytes_uploaded"] < bytes_init / 8,
            f"stream batch {b} uploaded {info['bytes_uploaded']} bytes, not "
            f"below bytes_init / 8 = {bytes_init / 8}")
    return dict(info=info, q=q, answers=answers, delta_s=delta_s,
                flush_s=flush_s, split=split, delta_launches=delta_launches,
                flush_launches=flush_launches)


def verify_stream(torch, np, LS, st, row, b: int, kind: str):
    """The stream against a from-scratch port session on
    ``from_edge_array(n, dyn.edge_array())`` with a fresh sketch, run on the
    plain PyTorch path: TC float32 bits, similarity, membership, local
    cluster, sketch rows, device CSR; and the served answers against the
    stream's own. Equal answers hold the kernels the stream launched to
    their plain versions on its own rows and ids (launches not counted)."""
    t0 = time.perf_counter()
    q = row["q"]
    check = LS.verify_against_static(st, q["pairs"], q["lc_seed"],
                                     q["membership"])
    served = row["answers"]
    sim = served[q["rids"]["similarity"]].value
    tc = served[q["rids"]["tc"]].value
    same_served = (np.array_equal(sim, st.similarity(q["pairs"])
                                  .cpu().numpy())
                   and tc == float(st.triangle_count()))
    print(f"phase 3f: {kind} batch {b} against a static session "
          f"({time.perf_counter() - t0:.1f} s): {check}; served answers "
          f"equal the stream's: {same_served}", flush=True)
    require(check["exact_match"] and check["csr_equal"]
            and check["sketch_equal"] and check.get("membership_equal", True)
            and same_served,
            f"{kind} stream batch {b} differs from the static session: "
            f"{check}")


def stream_state(st) -> dict:
    """What a checkpoint must carry across, by reference (every published
    array and tensor is immutable once published; dirty/stale are copied):
    version, host edge keys and degrees, device CSR, sketch rows, dirty,
    stale and the maintenance counters."""
    view, mt = st.graph, st.maintainer
    return {"version": st.version, "edge_keys": st.dyn.edge_keys,
            "deg": st.dyn.deg,
            "csr": {f: getattr(view, f)
                    for f in ("indptr", "indices", "deg", "edges")},
            "sketch": mt.sketch.data, "dirty": mt.dirty.copy(),
            "stale": mt.stale.copy(),
            "counters": (mt.rows_incremental, mt.rows_rebuilt,
                         mt.deltas_applied)}


def require_same_state(torch, np, got: dict, want: dict, what: str) -> None:
    """Fail unless two :func:`stream_state` records are equal."""
    diff = [key for key in ("version", "counters") if got[key] != want[key]]
    diff += [key for key in ("edge_keys", "deg", "dirty", "stale")
             if not np.array_equal(got[key], want[key])]
    diff += [f"csr.{f}" for f in got["csr"]
             if not torch.equal(got["csr"][f], want["csr"][f])]
    if not torch.equal(got["sketch"], want["sketch"]):
        diff.append("sketch")
    require(not diff, f"{what}: {diff} differ")


def same_value(np, a, b) -> bool:
    """Exact equality of two served answers (dicts, lists, arrays,
    numbers)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(same_value(np, a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(same_value(np, x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    return a == b


def stream_restore(torch, np, LS, st, saved: dict, live: dict, chunks,
                   ck_dir: str) -> dict:
    """Phase 3f, checkpoints: restore the version-1 checkpoint on the card,
    require its state to equal the live session's at version 1, replay
    batch 1 with the launcher's RNG, and require the state, the TC float32
    bits and the five answers to equal the live session's after batch 1;
    then one ``AsyncCheckpointer`` write read back."""
    from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                        restore_checkpoint)
    from repro_torch.stream import BatchedQueryServer, StreamSession

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = StreamSession.restore(ck_dir, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require_same_state(torch, np, stream_state(r), saved,
                       "the restored session against the live one at "
                       "version 1")
    server = BatchedQueryServer(r, max_batch=5, max_wait_s=0.25)
    r.session.edge_cardinalities()      # warm, as the launcher does
    b = 1
    rng = np.random.default_rng([STREAM_SEED + 2, b])
    dels = LS.batch_deletes(r, rng, len(chunks[b]), 0.1)
    t0 = time.perf_counter()
    info = r.apply_delta(chunks[b], dels)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    q = LS.submit_queries(server, rng, r.dyn.n, 64)
    answers = server.flush()
    server.close()
    require_same_state(torch, np, stream_state(r), stream_state(st),
                       "the restored session after replaying batch 1 "
                       "against the live one")
    tc_r, tc_l = float(r.triangle_count()), float(st.triangle_count())
    require(np.float32(tc_r).tobytes() == np.float32(tc_l).tobytes(),
            f"restored TC {tc_r!r} vs live {tc_l!r}")
    for name, rid in q["rids"].items():
        require(same_value(np, answers[rid].value,
                           live["answers"][live["q"]["rids"][name]].value),
                f"restored {name} answer differs from the live session's")
    same_info = {key: info[key] == live["info"][key] for key in info}
    require(all(v for key, v in same_info.items()
                if key != "bytes_uploaded"),
            f"replayed delta {info} vs live {live['info']}")
    del r, server
    # the asynchronous writer: copy to the host now, write in a thread
    ack_dir = ck_dir + "/async"
    ck = AsyncCheckpointer(ack_dir, keep=1)
    t0 = time.perf_counter()
    ck.save(st.version, {"edge_keys": st.dyn.edge_keys,
                         "sketch": st.sketch.data})
    async_save_s = time.perf_counter() - t0
    ck.wait()
    async_s = time.perf_counter() - t0
    back = restore_checkpoint(ack_dir, st.version, {
        "edge_keys": torch.empty(st.dyn.edge_keys.shape, dtype=torch.int64,
                                 device="meta"),
        "sketch": torch.empty(st.sketch.data.shape, dtype=torch.int32,
                              device="meta")}, device="cuda")
    require(latest_step(ack_dir) == st.version
            and torch.equal(back["sketch"], st.sketch.data)
            and np.array_equal(back["edge_keys"].cpu().numpy(),
                               st.dyn.edge_keys),
            "AsyncCheckpointer's write does not read back")
    print(f"phase 3f: checkpoint restored on the card in {restore_s:.2f} s, "
          f"state equal to the live session's at version 1; batch 1 "
          f"replayed in {replay_s:.2f} s (bytes uploaded {info['bytes_uploaded']}"
          f" vs live {live['info']['bytes_uploaded']}); state, TC float32 "
          f"bits ({tc_r!r}) and the five answers equal the live session's; "
          f"AsyncCheckpointer: save returned in {async_save_s:.2f} s, "
          f"written in {async_s:.2f} s, read back equal", flush=True)
    return dict(restore_s=restore_s, replay_s=replay_s,
                async_save_s=async_save_s, async_s=async_s)


def phase_stream(torch, np, kernels, g):
    """Phase 3f: the streaming serving path at scale 21 (the phase-3
    edges): a Bloom ``StreamSession`` behind a ``BatchedQueryServer``
    replays deltas and the launcher's queries, checked against static
    sessions after its first and last batch; then a k-Hash stream."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import stream as LS
    from repro_torch.obs import trace
    from repro_torch.stream import (BatchedQueryServer, DynamicGraph,
                                    StreamSession)

    t_phase = time.perf_counter()
    edges = g.edges.cpu().numpy().astype(np.int64)
    initial, arrivals = LS.split_stream(edges, STREAM_FRAC, STREAM_SEED)
    del edges
    chunks = np.array_split(arrivals, STREAM_CHUNKS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = StreamSession(DynamicGraph.from_edges(g.n, initial, device="cuda"),
                       "bf", storage_budget=1.0)
    server = BatchedQueryServer(st, max_batch=5, max_wait_s=0.25)
    st.session.edge_cardinalities()
    torch.cuda.synchronize()
    open_s = time.perf_counter() - t0
    print(f"phase 3f: stream of kronecker({SCALE}): initial m={st.dyn.m} "
          f"arrivals {arrivals.shape[0]} in {STREAM_CHUNKS} chunks of "
          f"~{chunks[0].shape[0]}; Bloom words={st.maintainer.words}; "
          f"bytes_init {st.dyn.traffic.bytes_init}; open (graph, mirror, "
          f"sketch, first pass) {open_s:.1f} s; plan use_kernel="
          f"{st.session.plan.use_kernel}", flush=True)
    require(st.session.plan.use_kernel, "the stream must use the kernels")
    # the last Bloom batch also runs under the profiler, started after its
    # deletions are drawn and stopped after its flush
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rows = []
    ck_dir = tempfile.mkdtemp(prefix="pg_stream_ck_")
    trace.enable()
    try:
        for b in range(STREAM_BATCHES):
            last = b == STREAM_BATCHES - 1
            rows.append(stream_batch(torch, np, kernels, trace, LS, st,
                                     server, chunks, b, "bf",
                                     prof if last else None))
            verify_stream(torch, np, LS, st, rows[-1], b, "bf")
            if b == 0:
                saved = stream_state(st)
                t0 = time.perf_counter()
                path = Path(st.save(ck_dir))
                save_s = time.perf_counter() - t0
                ck_bytes = sum(f.stat().st_size for f in path.iterdir())
                print(f"phase 3f: checkpoint of version {st.version}: "
                      f"{ck_bytes} bytes on disk, saved in {save_s:.2f} s",
                      flush=True)
        trace.disable()
        trace.clear()
        ck = stream_restore(torch, np, LS, st, saved, rows[1], chunks,
                            ck_dir)
        ck.update(bytes=ck_bytes, save_s=save_s)
    finally:
        trace.disable()
        trace.clear()
        shutil.rmtree(ck_dir, ignore_errors=True)
    for key in ("gather/and2", "rows/and2"):
        require(all(r["flush_launches"].get(key, 0) > 0 for r in rows),
                f"a stream flush launched no {key} kernel")
    require(all(r["delta_launches"].get("gather/and2/card", 0) > 0
                for r in rows),
            "a stream delta's refresh launched no gather/and2/card kernel")
    launches = {key: sum(r["delta_launches"].get(key, 0)
                         + r["flush_launches"].get(key, 0) for r in rows)
                for key in ("fused_gather_popcount", "fused_rows_popcount",
                            "gather/and2", "gather/and2/card", "rows/and2")}
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in device) / 1e6
    wall_s = rows[-1]["delta_s"] + rows[-1]["flush_s"]
    print(f"phase 3f: bf batch {STREAM_BATCHES - 1} (delta + flush) under "
          f"the profiler: device busy {busy_s * 1e3:.3f} ms of "
          f"{wall_s * 1e3:.1f} ms wall, idle share "
          f"{max(0.0, 1 - busy_s / wall_s):.1%}; top kernels:", flush=True)
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x "
              f"{e.key[:100]}", flush=True)
    server_stats = server.stats()
    server.close()
    bf_stats = st.stats()
    del st, server

    # the k-Hash stream: tie-breaking (invariant 3) on the card
    t0 = time.perf_counter()
    kh = StreamSession(DynamicGraph.from_edges(g.n, initial, device="cuda"),
                       "kh", storage_budget=1.0)
    kh_server = BatchedQueryServer(kh, max_batch=5, max_wait_s=0.25)
    kh.session.edge_cardinalities()
    torch.cuda.synchronize()
    print(f"phase 3f: k-Hash stream: k={kh.maintainer.k}; open "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kh_rows = []
    trace.enable()
    try:
        for b in range(STREAM_KH_BATCHES):
            kh_rows.append(stream_batch(torch, np, kernels, trace, LS, kh,
                                        kh_server, chunks, b, "kh"))
    finally:
        trace.disable()
        trace.clear()
    verify_stream(torch, np, LS, kh, kh_rows[-1], STREAM_KH_BATCHES - 1,
                  "kh")
    kh_key = "khash_match_pairs/gather"
    require(all(r["flush_launches"].get(kh_key, 0) > 0
                and r["delta_launches"].get(kh_key, 0) > 0 for r in kh_rows),
            "the k-Hash stream launched no khash_match_gather kernel")
    launches[kh_key] = sum(r["flush_launches"].get(kh_key, 0)
                           + r["delta_launches"].get(kh_key, 0)
                           for r in kh_rows)
    kh_server.close()
    del kh, kh_server
    peak = torch.cuda.max_memory_allocated()
    phase_s = time.perf_counter() - t_phase
    print(f"phase 3f: server stats {json.dumps(server_stats)}; stream stats "
          f"{json.dumps(bf_stats)}; launches on the stream path {launches}; "
          f"peak device memory {peak} bytes; {phase_s:.1f} s in all",
          flush=True)
    return dict(rows=rows, kh_rows=kh_rows, launches=launches, peak=peak,
                phase_s=phase_s, busy_s=busy_s, wall_s=wall_s, open_s=open_s,
                checkpoint=ck)


def phase_breakdown(torch, TE, sketches, g, sess, warm_pass_s, build_s,
                    mh_sessions, mh_path, clique_s, sx, exact_s, lc):
    """Phase 4: where the time goes. A warm Bloom pass (TC + LCC), a Bloom
    sketch build, warm k-Hash and 1-Hash-naive passes (TC), the 4-clique
    pass, the exact per-edge pass and a warm 8-seed Bloom
    ``local_cluster`` run under torch.profiler; device busy time is the
    sum of their kernels' device time, and the idle share is taken against
    the unprofiled wall time of phases 3/3b/3c/3e."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(label, fn, wall_s, top=6):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
        print(f"phase 4: {label}: device busy {busy_s * 1e3:.3f} ms of "
              f"{wall_s * 1e3:.1f} ms wall (unprofiled), idle share "
              f"{max(0.0, 1 - busy_s / wall_s):.1%}; top kernels:", flush=True)
        for e in sorted(kernels,
                        key=lambda e: -e.self_device_time_total)[:top]:
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x "
                  f"{e.key[:100]}", flush=True)
        return busy_s, kernels

    def warm_pass():
        again = TE.MiningSession(g, sess.sketch, sess.plan)
        float(again.triangle_count())
        again.local_clustering()

    pass_busy, pass_kernels = run("warm TC pass + LCC", warm_pass,
                                  warm_pass_s)
    tile = [e for e in pass_kernels if "tile_popcount_kernel" in e.key]
    tile_us = sum(e.self_device_time_total for e in tile)
    tile_n = sum(e.count for e in tile)
    require(tile_n > 0, "the warm Bloom pass profile shows no launch of the "
                        "[T, k] gather kernel")
    print(f"  the [T, k] gather kernel in the warm pass: {tile_n} launches, "
          f"{tile_us / 1e3:.3f} ms, {tile_us / tile_n:.2f} us a launch",
          flush=True)
    build_busy, _ = run("sketch build", lambda: sketches.build(
        g, "bf", storage_budget=1.0), build_s)
    mh_busy = {}
    for label, name in (("kh", "k-Hash"), ("1h-naive", "1-Hash-naive")):
        mh = mh_sessions[label]
        mh_busy[label], _ = run(f"warm {name} TC pass", lambda: float(
            TE.MiningSession(g, mh.sketch, mh.plan).triangle_count()),
            mh_path[label]["warm_pass_s"])
    clique_busy, _ = run(f"4-clique pass (scale {SCALE})",
                         lambda: float(sess.four_clique_count()), clique_s,
                         top=14)
    exact_busy, _ = run(f"exact per-edge pass (scale {SCALE})",
                        lambda: TE.MiningSession(g, None, sx.plan)
                        .edge_cardinalities(), exact_s, top=10)
    lc_busy, lc_kernels = run(
        f"warm {LC_SEEDS}-seed Bloom local_cluster (scale {SCALE})",
        lambda: sess.local_cluster(lc["seeds"], LC_ALPHA, LC_EPS),
        lc["bf"]["warm_s"], top=10)
    tile = [e for e in lc_kernels if "tile_popcount_kernel" in e.key]
    require(sum(e.count for e in tile) > 0, "the local_cluster profile "
            "shows no launch of the dense AND2 kernel")
    return pass_busy, build_busy, mh_busy, clique_busy, exact_busy, lc_busy


def phase_adaptive(torch, np, kernels, g, tc_fixed: float, tc_exact: int
                   ) -> dict:
    """Phase 3g, adaptive Bloom at scale 21 (s = 1.0, k = 2, the fixed
    Bloom's budget and hashes): build, sampled rows (hubs included)
    against the host twin, the triangle count with launches zeroed before
    and read after (only ``rows/and2`` may run), and the popcounts of a
    1M-edge sample (hub edges included) against the plain path."""
    from repro_torch.core import adaptive as AD

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sk = AD.build_adaptive_bloom(g, 1.0, num_hashes=2, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    words = sk.words.to(torch.int64)
    hist = {int(w): int(c) for w, c in zip(*torch.unique(
        words, return_counts=True))}
    total_words = sk.data.numel()
    deg = g.deg.to(torch.int64)
    eu, ev = g.edges[:, 0].long(), g.edges[:, 1].long()
    pair_bytes = int((words[eu] + words[ev]).sum()) * 4
    print(f"phase 3g: adaptive Bloom of kronecker({SCALE}), s=1.0, k=2: "
          f"Σ words {total_words} ({total_words * 4} bytes; the dense "
          f"layout would be n x words_max = {g.n * sk.words_max * 4} bytes), "
          f"words_max {sk.words_max}, rows by width {hist}; built in "
          f"{build_s:.3f} s, peak {build_peak} bytes; the pass reads "
          f"Σ_e (w_u + w_v)·4 = {pair_bytes} bytes", flush=True)
    require(total_words == int(words.sum()) and sk.offsets.shape == (g.n + 1,),
            "adaptive layout is not ragged over Σ words")
    hubs = torch.topk(deg, 8).indices.cpu().numpy()
    sample = np.unique(np.concatenate([hubs, np.random.default_rng(0).choice(
        g.n, size=256, replace=False)]))
    t0 = time.perf_counter()
    want, offs, _ = AD.build_adaptive_bloom_np(g, 1.0, 2, 0,
                                               vertices=sample)
    got = torch.cat([sk.row(int(v)) for v in sample]).cpu().numpy()
    require(np.array_equal(got.view(np.uint32), want),
            f"adaptive rows of {sample.size} sampled vertices differ from "
            "build_adaptive_bloom_np")
    print(f"  {sample.size} sampled rows (the 8 hubs included, "
          f"{offs[-1]} words) equal build_adaptive_bloom_np "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tc = float(AD.adaptive_triangle_count(g, sk))
    pass_s = time.perf_counter() - t0
    launches = stream_launches(kernels)
    peak = torch.cuda.max_memory_allocated()
    rel, rel_fixed = (tc - tc_exact) / tc_exact, (tc_fixed - tc_exact) / \
        tc_exact
    print(f"  adaptive_triangle_count {tc:.9g} in {pass_s:.3f} s, peak "
          f"{peak} bytes, launches {launches}; against the exact {tc_exact}: "
          f"relative error {rel:+.6f} (the fixed Bloom of phase 3: "
          f"{tc_fixed:.9g}, {rel_fixed:+.6f})", flush=True)
    require(math.isfinite(tc) and tc > 0, f"adaptive TC {tc}")
    require(set(launches) == {"fused_rows_popcount", "rows/and2"},
            f"the adaptive pass launched {launches}; only rows/and2 may run")
    require(peak < g.n * sk.words_max * 4,
            f"peak {peak} bytes reaches an n x words_max tensor")
    plan = kernel_plan(g)
    pairs = torch.cat([g.edges[edge_sample(torch, np, g)],
                       hub_edge_sample(torch, np, g, hubs=8, per_hub=512)])
    ones_k, wt = AD.adaptive_pair_ones(sk, pairs, plan)
    ones_p, _ = AD.adaptive_pair_ones(sk, pairs, plan.with_(use_kernel=False))
    require(torch.equal(ones_k, ones_p),
            f"adaptive popcounts: {int((ones_k != ones_p).sum())} of "
            f"{pairs.shape[0]} sampled edges differ from the plain path")
    vk = AD.adaptive_pair_cardinalities(sk, pairs, plan)
    vp = AD.adaptive_pair_cardinalities(sk, pairs,
                                        plan.with_(use_kernel=False))
    require(torch.equal(vk, vp), "adaptive estimates differ from the plain "
            "path's on equal popcounts")
    print(f"  {pairs.shape[0]} sampled edges (hub edges included, widths "
          f"{int(wt.min())}..{int(wt.max())} words after folding): kernel "
          f"popcounts and estimates equal the plain path's", flush=True)
    # where the pass's time goes: a warm pass unprofiled (its wall), then
    # one under the profiler (device busy, the popcount kernel's share)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    AD.adaptive_triangle_count(g, sk)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        AD.adaptive_triangle_count(g, sk)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in device) / 1e6
    popc_s = sum(e.self_device_time_total for e in device
                 if "tile_popcount" in e.key) / 1e6
    print(f"  warm pass {warm_s:.3f} s; under the profiler: device busy "
          f"{busy_s * 1e3:.1f} ms (idle share {max(0.0, 1 - busy_s / warm_s):.1%}"
          f" of the unprofiled wall), the dense AND2 {popc_s * 1e3:.1f} ms "
          f"of it; top kernels:", flush=True)
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x "
              f"{e.key[:100]}", flush=True)
    rows_launches = launches.get("rows/and2", 0)
    del sk
    torch.cuda.empty_cache()
    return dict(tc=tc, rel=rel, rel_fixed=rel_fixed, build_s=build_s,
                pass_s=pass_s, peak=peak, words=total_words, hist=hist,
                launches=rows_launches, pair_bytes=pair_bytes,
                warm_s=warm_s, busy_s=busy_s, popc_s=popc_s)


def kernel_plan(g):
    """The engine's default plan for ``g`` (kernels on the card)."""
    from repro_torch import engine as TE

    return TE.plan_for(g, None)


def numpy_candidates(np, indptr, indices, n: int, limit: int):
    """The link-prediction candidates by a numpy rule: wedges in the
    reference's order (v ascending, then i < j in v's sorted row, a row in
    blocks of about 2^20 wedges), pairs that are edges dropped, the first
    ``limit`` distinct pairs kept (then it stops), sorted: int64 keys
    ``a·n + b``, and the wedges read."""
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    edges = src * n + indices
    keys = np.sort(edges[src < indices])
    seen, read = set(), 0
    for v in range(n):
        d = int(deg[v])
        nb = indices[indptr[v]:indptr[v + 1]].astype(np.int64)
        i0 = 0
        while i0 < d - 1:
            i1, wedges = i0, 0
            while i1 < d - 1 and wedges < (1 << 20):
                wedges += d - 1 - i1
                i1 += 1
            per_row = d - 1 - np.arange(i0, i1)       # j > i in row i
            ii = np.repeat(np.arange(i0, i1), per_row)
            jj = ii + 1 + np.arange(ii.size) - np.repeat(
                np.cumsum(per_row) - per_row, per_row)
            key = nb[ii] * n + nb[jj]
            at = np.minimum(np.searchsorted(keys, key), keys.size - 1)
            key = key[keys[at] != key]
            _, firsts = np.unique(key, return_index=True)
            for kk in key[np.sort(firsts)].tolist():
                if kk not in seen:
                    seen.add(kk)
                    if len(seen) == limit:
                        return np.sort(np.fromiter(seen, np.int64)), \
                            read + wedges
            read += wedges
            i0 = i1
    return np.sort(np.fromiter(seen, np.int64, len(seen))), read


def linkpred_scores(torch, TE, LP, SK, kernels, sparse, cand, kind: str):
    """Kernel-path scores of ``cand`` for one sketch kind against the plain
    path's (integer popcounts or match counts first, then the floats);
    returns (kernel scoring seconds, launches by form)."""
    from repro_torch.engine import setexpr
    from repro_torch.kernels import ops

    sk = SK.build(sparse, kind, 1.0 if kind == "bf" else 0.25, num_hashes=2,
                  seed=0)
    plan = TE.plan_for(sparse, sk)
    if kind == "bf":
        and2 = setexpr.and_all(*setexpr.rows(2))
        got = setexpr.compile_expr(and2, use_kernel=True).ones(sk.data, cand)
        want = setexpr.compile_expr(and2, use_kernel=False).ones(sk.data,
                                                                 cand)
    else:
        got = ops.khash_match_gather(sk.data, cand, sk.n, use_kernel=True)
        want = ops.khash_match_gather(sk.data, cand, sk.n, use_kernel=False)
    require(torch.equal(got, want), f"{kind} link-prediction counts differ "
            "from the plain path's")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sk_scores = LP.pair_similarity(sparse, cand, "common", sk, plan=plan)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    launches = stream_launches(kernels)
    plain = LP.pair_similarity(sparse, cand, "common", sk,
                               plan=plan.with_(use_kernel=False))
    require(torch.equal(sk_scores, plain), f"{kind} link-prediction scores "
            "differ from the plain path's")
    return score_s, launches


def phase_linkpred(torch, np, TG, kernels, g) -> dict:
    """Phase 3g, link prediction (Listing 5) at the reference's defaults
    (removed 0.1, seed 0, ``common``): the split and the distance-2
    candidates at scale 21 against a numpy rule, then ef for the exact,
    Bloom (s = 1.0) and k-Hash scorers with launches zeroed before and read
    after, each scorer's kernel path against its plain path; then the
    Bloom scorer at scale 16, where the ranking decides ef."""
    from repro_torch import engine as TE
    from repro_torch.core import sketches as SK
    from repro_torch.core.algorithms import linkpred as LP
    from repro_torch.obs.metrics import REGISTRY

    t0 = time.perf_counter()
    sparse, removed = LP.split_edges(g, 0.1, 0)
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cand = LP._distance2_candidates(sparse)
    torch.cuda.synchronize()
    enum_s = time.perf_counter() - t0
    wedges = REGISTRY.gauge("linkpred_wedges_read").value
    t0 = time.perf_counter()
    want, np_read = numpy_candidates(
        np, sparse.indptr.cpu().numpy().astype(np.int64),
        sparse.indices.cpu().numpy().astype(np.int64), sparse.n,
        2_000_000)
    np_s = time.perf_counter() - t0
    got = cand.cpu().numpy().astype(np.int64)
    require(np.array_equal(got[:, 0] * sparse.n + got[:, 1], want),
            f"{cand.shape[0]} candidates differ from the numpy rule's "
            f"{want.size}")
    print(f"phase 3g: link prediction, kronecker({SCALE}): split "
          f"{split_s:.2f} s (removed {removed.shape[0]}, sparse m "
          f"{sparse.m}); {cand.shape[0]} candidates in {enum_s:.3f} s from "
          f"{wedges} wedges read (numpy rule: {np_read} wedges, {np_s:.1f} "
          f"s, the same pairs)", flush=True)
    require(cand.shape[0] == 2_000_000, f"{cand.shape[0]} candidates")
    out = {"split_s": split_s, "enum_s": enum_s, "wedges": wedges,
           "candidates": cand.shape[0], "r": removed.shape[0], "ef": {},
           "launches": {}}
    for kind in (None, "bf", "kh"):
        label = kind or "exact"
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ef = LP.link_prediction_effectiveness(
            g, sketch_kind=kind, storage_budget=1.0 if kind == "bf" else 0.25)
        ef_s = time.perf_counter() - t0
        launches = stream_launches(kernels)
        line = (f"  {label}: ef {ef:.6f} in {ef_s:.2f} s, launches "
                f"{launches}")
        if kind is None:
            require(not launches, f"exact link prediction launched "
                    f"{launches}")
        else:
            score_s, _ = linkpred_scores(torch, TE, LP, SK, kernels, sparse,
                                         cand, kind)
            line += (f"; scoring {cand.shape[0]} candidates {score_s:.3f} s, "
                     f"kernel counts and scores equal the plain path's")
        key = {"bf": "gather/and2/card",
               "kh": "khash_match_pairs/gather"}.get(
            kind)
        require(key is None or launches.get(key, 0) > 0,
                f"{label} link prediction launched no {key}")
        out["ef"][label] = ef
        out["launches"][label] = launches
        print(line, flush=True)
    del sparse, cand
    torch.cuda.empty_cache()
    g16 = TG.kronecker(LINKPRED_SMALL_SCALE, 16, seed=1, device="cuda")
    sparse16, removed16 = LP.split_edges(g16, 0.1, 0)
    n_cand = LP._distance2_candidates(sparse16).shape[0]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ef16 = LP.link_prediction_effectiveness(g16, sketch_kind="bf",
                                            storage_budget=1.0)
    ef16_s = time.perf_counter() - t0
    launches16 = stream_launches(kernels)
    ef16_exact = LP.link_prediction_effectiveness(g16)
    print(f"  kronecker({LINKPRED_SMALL_SCALE}): r {removed16.shape[0]} "
          f"removed < {n_cand} candidates; bf ef {ef16:.6f} in {ef16_s:.2f} "
          f"s (launches {launches16}), exact ef {ef16_exact:.6f}",
          flush=True)
    require(removed16.shape[0] < n_cand and 0.0 < ef16 <= 1.0,
            f"scale {LINKPRED_SMALL_SCALE}: ef {ef16}")
    out.update(ef16=ef16, ef16_exact=ef16_exact, ef16_s=ef16_s,
               launches16=launches16)
    return out


def dedup_corpus(np):
    """``DEDUP_DOCS`` originals of 200-2,000 tokens over ``DEDUP_VOCAB``
    ids, then ``DEDUP_DUPS`` near-duplicates of random originals with 3% of
    their tokens redrawn (``default_rng(0)``, as examples/dedup_corpus.py
    plants them); returns (docs, the original of each planted duplicate)."""
    rng = np.random.default_rng(0)
    lo, hi = DEDUP_LEN
    docs = [rng.integers(0, DEDUP_VOCAB, size=rng.integers(lo, hi + 1))
            .astype(np.int64) for _ in range(DEDUP_DOCS)]
    sources = rng.choice(DEDUP_DOCS, size=DEDUP_DUPS, replace=False)
    for i in sources:
        d = docs[i].copy()
        idx = rng.choice(len(d), size=max(1, len(d) // 33), replace=False)
        d[idx] = rng.integers(0, DEDUP_VOCAB, size=len(idx))
        docs.append(d)
    return docs, sources


def numpy_sketch(np, hash_u32, tokens, k: int, w: int, seed: int = 0):
    """The reference's k-Hash sketch of one doc, in numpy: uint32[k]."""
    tokens = np.asarray(tokens, dtype=np.uint32)
    if len(tokens) < w:
        sh = hash_u32(tokens, 7)
    else:
        sh = np.zeros(len(tokens) - w + 1, dtype=np.uint32)
        with np.errstate(over="ignore"):
            for i in range(w):
                sh = (sh * np.uint32(1000003)) ^ hash_u32(
                    tokens[i:i + len(sh)], 7 + i)
    out = np.full(k, 0xFFFFFFFF, dtype=np.uint32)
    for i in range(k if len(sh) else 0):
        out[i] = hash_u32(sh, (i + seed * 0x9E3779B9) & 0xFFFFFFFF).min()
    return out


def numpy_dedup(np, sketches, threshold: float, k: int, bands: int):
    """The reference's banding and keep rule over given sketches, in
    numpy and Python dicts: (keep, stats)."""
    n = sketches.shape[0]
    rpb = max(1, k // bands)
    buckets = {}
    for di in range(n):
        for b in range(bands):
            band = sketches[di, b * rpb:(b + 1) * rpb]
            buckets.setdefault((b, band.tobytes()), []).append(di)
    keep = np.ones(n, dtype=bool)
    checked, dropped = 0, []
    for members in buckets.values():
        for other in members[1:]:
            anchor = members[0]
            if not keep[other] or not keep[anchor]:
                continue
            checked += 1
            j = float(np.mean(sketches[anchor] == sketches[other]))
            if j >= threshold:
                keep[other] = False
                dropped.append((anchor, other, j))
    return keep, {"checked_pairs": checked, "dropped": int((~keep).sum()),
                  "dropped_pairs": dropped[:32], "k": k, "bands": bands}


def fold_rtol(chunks: int) -> float:
    """Relative bound on a float32 fold of ``chunks`` chunk sums of
    non-negative values: one rounding per add of the fold, plus 64 for
    each chunk's ``torch.sum`` (its per-thread runs and tree levels over
    at most 65,536 values), 2^-24 each."""
    return (chunks + 64) * 2.0 ** -24


def phase_sharded(torch, TE, kernels, g) -> dict:
    """Phase 3h: the sharded mining path on the card at world size 1."""
    import torch.distributed as dist

    from repro_torch.distributed.spawn import init_group
    from repro_torch.launch import mesh as launch_mesh

    t_phase = time.perf_counter()
    store = tempfile.mkdtemp(prefix="pg_sharded_")
    init_group("file://" + str(Path(store) / "store"), 1, 0, "cuda", 60.0)
    try:
        mesh = launch_mesh.make_host_mesh(1, 1, device="cuda")
        print(f"phase 3h: process group of world size 1 "
              f"({dist.get_backend()}), mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} up in "
              f"{time.perf_counter() - t_phase:.2f} s", flush=True)
        out = sharded_checks(torch, TE, kernels, g, mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 3h: {out['phase_s']:.1f} s in all (scaling over several "
          "GPUs is not measured: one card)", flush=True)
    return out


def sharded_checks(torch, TE, kernels, g, mesh) -> dict:
    """Phase 3h's checks over the world-size-1 NCCL mesh ``mesh``."""
    from repro_torch.core import sketches as SK
    from repro_torch.distributed import sharding
    from repro_torch.launch import mine as LM

    m = g.m
    # mine(): the launch counts zeroed just before and read just after
    kernels.reset_launch_counts()
    out = LM.mine(g, mesh, device="cuda")
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    forms = dict(kernels.fused_expr.FORM_LAUNCHES)
    words = out["words"]
    chunk = TE.plan_for(g, SK.SketchSet(
        data=torch.empty((g.n, words), dtype=torch.int32, device="cuda"),
        kind="bf", num_hashes=2, k=0, seed=0, n=g.n)).edge_chunk
    expected = math.ceil(m / chunk)
    print(f"phase 3h: mine(): words={words} build {out['build_s']:.3f} s "
          f"mine {out['mine_s']:.3f} s TC={out['tc_estimate']:.9g} launches "
          f"{launches} by form {forms}", flush=True)
    require(out["devices"] == 1 and forms == {"gather/and2": expected}
            and launches == {"fused_gather_popcount": expected},
            f"mine() launched {launches} by form {forms}; expected only "
            f"{expected} gather/and2 launches (one per {chunk}-edge chunk)")
    rows = LM.build_sketches_distributed(g, mesh, words, 2, 0)
    bloom = SK.build_bloom(g, words, 2, 0)
    require(torch.equal(rows, bloom), "build_sketches_distributed rows "
            "differ from build_bloom")
    sess25 = TE.session(g, "bf", storage_budget=0.25, device="cuda")
    require(sess25.sketch.data.shape[1] == words
            and torch.equal(sess25.sketch.data, bloom),
            "the budget-0.25 session's sketch differs from mine()'s")
    tc_sess = float(sess25.triangle_count())
    rel = abs(out["tc_estimate"] - tc_sess) / tc_sess
    require(rel <= 1e-5, f"mine() TC {out['tc_estimate']} vs session TC "
            f"{tc_sess}: rel {rel:.3g} > 1e-5")
    print(f"  rows equal build_bloom ({rows.numel() * 4} bytes); the "
          f"session's TC {tc_sess:.9g} (torch.sum of the per-edge map) is "
          f"{rel:.3g} off mine()'s sharded fold (rtol 1e-5)", flush=True)
    del sess25, rows

    # the engine's sharded fold on the phase-3 session (s = 1.0)
    sess = TE.session(g, "bf", storage_budget=1.0, device="cuda")
    plan = sess.plan
    local = TE.sum_edge_cardinalities(g, sess.sketch, plan)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with sharding.use_rules(mesh):
        sharded = TE.sum_edge_cardinalities(g, sess.sketch,
                                            plan.with_(shard_edges=True))
    fold_s = time.perf_counter() - t0
    fold_forms = dict(kernels.fused_expr.FORM_LAUNCHES)
    chunks = math.ceil(m / plan.edge_chunk)
    require(int(sharded.view(torch.int32)) == int(local.view(torch.int32)),
            f"sharded fold {float(sharded)!r} vs local fold "
            f"{float(local)!r}: float32 bits differ")
    require(fold_forms == {"gather/and2": chunks}, f"sharded fold launched "
            f"{fold_forms}, expected {chunks} gather/and2")
    print(f"phase 3h: sharded fold under use_rules (s=1.0, words="
          f"{sess.sketch.data.shape[1]}, edge_chunk={plan.edge_chunk}, "
          f"degree_order={plan.degree_order}): {float(sharded)!r} = the "
          f"local fold's float32 bits; {fold_s:.3f} s, {fold_forms}",
          flush=True)

    # R > 1 ranks, in one process: each block's partial through the
    # function the rank calls, held to the float64 sum of the block's
    # per-edge estimates; their sum to the local fold
    edges = (TE.order_edges_by_hub(g, g.edges)[0] if plan.degree_order
             else g.edges)
    fn = TE.pair_cardinality_fn(g, sess.sketch, plan)
    arithmetic = {}
    for ranks in SHARD_RANKS:
        t0 = time.perf_counter()
        partials, worst = [], 0.0
        for r in range(ranks):
            part = TE.shard_edge_cardinalities(g, sess.sketch, plan, r,
                                               ranks)
            start, stop = TE.edge_shard(m, ranks, r, plan.edge_chunk)
            exact = sum(float(torch.sum(fn(edges[s:min(stop, s + plan
                                                       .edge_chunk)]),
                                        dtype=torch.float64))
                        for s in range(start, stop, plan.edge_chunk))
            tol = fold_rtol(math.ceil((stop - start) / plan.edge_chunk))
            err = abs(float(part) - exact) / max(exact, 1e-30)
            require(err <= tol, f"R={ranks} rank {r}: partial "
                    f"{float(part)!r} vs float64 {exact!r} (rel {err:.3g} > "
                    f"{tol:.3g})")
            worst = max(worst, err)
            partials.append(float(part))
        total = math.fsum(partials)
        err_total = abs(total - float(local)) / float(local)
        require(err_total <= 2 * fold_rtol(chunks),
                f"R={ranks}: sum of partials {total!r} vs local fold "
                f"{float(local)!r} (rel {err_total:.3g})")
        lo_hi = [LM.vertex_range(g.n, ranks, r) for r in range(ranks)]
        built = torch.cat([SK.build_bloom_range(g, words, lo, hi, 2, 0)
                           for lo, hi in lo_hi])
        require(torch.equal(built, bloom), f"R={ranks}: vertex-range "
                "builds differ from build_bloom")
        arithmetic[ranks] = dict(rel_total=err_total, worst_partial=worst,
                                 seconds=time.perf_counter() - t0)
        print(f"  R={ranks}: {ranks} edge blocks of "
              f"{TE.edge_shard(m, ranks, 0, plan.edge_chunk)[1]} edges; "
              f"partials within {worst:.3g} of their float64 sums (bound "
              f"{fold_rtol(chunks):.3g}), their sum {err_total:.3g} off the "
              f"local fold (bound {2 * fold_rtol(chunks):.3g}); vertex "
              f"blocks of {lo_hi[0][1]} rows equal build_bloom; "
              f"{arithmetic[ranks]['seconds']:.2f} s", flush=True)
    mine_launches = forms["gather/and2"]
    fold_launches = fold_forms["gather/and2"]
    return dict(mine=out, launches=mine_launches + fold_launches,
                mine_launches=mine_launches, fold_launches=fold_launches,
                fold_s=fold_s,
                arithmetic=arithmetic)


def phase_dedup(torch, np) -> dict:
    """Phase 3g, MinHash dedup of a 50,000-doc corpus on the card
    (threshold 0.7, k = k_for(0.1, 0.01), w = 5), its steps timed by their
    spans; sketches of sampled docs against numpy, and the keep mask and
    stats of a 2,000-doc sub-corpus (the first originals and the planted
    duplicates of those) against the reference's rule in numpy."""
    from repro_torch.core.hashing import np_hash_u32
    from repro_torch.data import dedup as DD
    from repro_torch.obs import trace

    t0 = time.perf_counter()
    docs, sources = dedup_corpus(np)
    corpus_s = time.perf_counter() - t0
    k = DD.k_for(0.1, 0.01)
    tokens = sum(len(d) for d in docs)
    trace.clear()
    trace.enable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep, stats = DD.minhash_dedup(docs, DEDUP_THRESHOLD, k, DEDUP_W,
                                       device="cuda")
        dedup_s = time.perf_counter() - t0
        spans = trace.aggregate()
        cands = [e["args"].get("candidates") for e in trace.events()
                 if e["name"] == "dedup.banding"]
    finally:
        trace.disable()
        trace.clear()
    step = {name: spans.get(f"dedup.{name}", {}).get("total_s", 0.0)
            for name in ("sketches", "banding", "keep")}
    planted = int((~keep[DEDUP_DOCS:]).sum())
    distinct = int((~keep[:DEDUP_DOCS]).sum())
    print(f"phase 3g: dedup of {len(docs)} docs ({tokens} tokens; corpus "
          f"built in {corpus_s:.1f} s), k={k} w={DEDUP_W} bands="
          f"{stats['bands']} threshold {DEDUP_THRESHOLD}: {dedup_s:.2f} s = "
          + ", ".join(f"{name} {sec:.3f} s" for name, sec in step.items())
          + f"; {cands[0] if cands else '?'} candidate pairs, "
          f"{stats['checked_pairs']} checked; dropped {stats['dropped']}: "
          f"{planted} of {DEDUP_DUPS} planted duplicates, {distinct} "
          f"originals", flush=True)
    rng = np.random.default_rng(1)
    sample = np.sort(rng.choice(len(docs), size=DEDUP_SAMPLED, replace=False))
    t0 = time.perf_counter()
    got = DD.document_sketches([docs[i] for i in sample], k, DEDUP_W,
                               device="cuda")
    want = np.stack([numpy_sketch(np, np_hash_u32, docs[i], k, DEDUP_W)
                     for i in sample])
    require(np.array_equal(got, want), f"dedup sketches of {DEDUP_SAMPLED} "
            "sampled docs differ from numpy")
    head = int(DEDUP_CHECKED * 0.9)
    sub = list(range(head)) + [DEDUP_DOCS + j for j, src in
                               enumerate(sources) if src < head]
    sub = [docs[i] for i in sub[:DEDUP_CHECKED]]
    keep_sub, stats_sub = DD.minhash_dedup(sub, DEDUP_THRESHOLD, k,
                                           DEDUP_W, device="cuda")
    sk_sub = DD.document_sketches(sub, k, DEDUP_W, device="cuda")
    keep_np, stats_np = numpy_dedup(np, sk_sub, DEDUP_THRESHOLD, k,
                                    stats_sub["bands"])
    require(np.array_equal(keep_sub, keep_np) and stats_sub == stats_np,
            f"dedup of the {len(sub)}-doc sub-corpus differs from the numpy "
            f"rule: {stats_sub['checked_pairs']} / {stats_np['checked_pairs']}"
            f" checked, {stats_sub['dropped']} / {stats_np['dropped']} "
            "dropped")
    print(f"  sketches of {DEDUP_SAMPLED} sampled docs equal numpy's; the "
          f"{len(sub)}-doc sub-corpus ({len(sub) - head} planted duplicates): "
          f"keep mask and stats equal the numpy rule's ({stats_np['dropped']}"
          f" dropped, {stats_np['checked_pairs']} checked; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    require(planted > 0.9 * DEDUP_DUPS, f"only {planted} of {DEDUP_DUPS} "
            "planted duplicates dropped")
    return dict(dedup_s=dedup_s, step=step, planted=planted,
                distinct=distinct, checked=stats["checked_pairs"],
                candidates=cands[0] if cands else None, k=k,
                docs=len(docs), tokens=tokens)


def phase_reference(torch, np, TE, TG, sketches):
    """Phase 5: a small graph against an independent numpy estimator."""
    g = TG.kronecker(12, 16, seed=1, device="cuda")
    sess = TE.session(g, "bf", storage_budget=0.25, device="cuda")
    words = sess.sketch.data.shape[1]
    bloom = sketches.build_bloom_np(g, words, 2, 0)
    require(np.array_equal(sess.sketch.data.cpu().numpy().view(np.uint32),
                           bloom), "sketch words differ from build_bloom_np")
    e = g.edges.cpu().numpy()
    anded = (bloom[e[:, 0]] & bloom[e[:, 1]]).view(np.uint8)
    ones = np.unpackbits(anded, axis=1).sum(axis=1).astype(np.float64)
    bits = words * 32
    est = -(bits / 2) * np.log1p(-np.minimum(ones, bits - 1) / bits)
    tc_ref = est.sum() / 3
    tv = np.zeros(g.n)
    np.add.at(tv, e[:, 0], est)
    np.add.at(tv, e[:, 1], est)
    d = g.deg.cpu().numpy().astype(np.float64)
    lcc_ref = tv / np.maximum(d * (d - 1), 1)
    tc = float(sess.triangle_count())
    lcc = sess.local_clustering().cpu().numpy()
    require(math.isclose(tc, tc_ref, rel_tol=1e-4),
            f"scale-12 TC {tc} vs numpy {tc_ref}")
    require(np.allclose(lcc, lcc_ref, rtol=1e-4, atol=1e-5),
            "scale-12 LCC differs from numpy")
    a = torch.zeros((g.n, g.n), dtype=torch.float64, device="cuda")
    a[g.edges[:, 0].long(), g.edges[:, 1].long()] = 1
    a[g.edges[:, 1].long(), g.edges[:, 0].long()] = 1
    exact = float(torch.trace(a @ a @ a)) / 6
    print(f"phase 5: scale 12 TC={tc:.6g} numpy={tc_ref:.6g} exact={exact:.0f} "
          f"(estimate rel err {abs(tc - exact) / exact:.4f})", flush=True)
    return g, exact


def phase_reference_exact(torch, np, TE, g, exact: float):
    """Phase 5: the exact baseline at scale 12 — ``exact_triangle_count``
    equal to trace(A³)/6, and the exact session's Adamic–Adar and
    Resource-Allocation equal to numpy sums over np.intersect1d on
    sampled pairs (rtol 1e-5)."""
    from repro_torch.core import exact as X

    tc = int(X.exact_triangle_count(g))
    require(tc == round(exact), f"exact_triangle_count {tc} vs trace {exact}")
    indptr, indices = g.indptr.cpu().numpy(), g.indices.cpu().numpy()
    deg = g.deg.cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(0)
    e = g.edges.cpu().numpy()
    hubs = np.argsort(-deg, kind="stable")[:8]
    pairs = np.concatenate([e[rng.choice(e.shape[0], 1500, replace=False)],
                            rng.integers(0, g.n, (400, 2)),
                            np.stack([hubs, np.roll(hubs, 1)], 1)]
                           ).astype(np.int32)
    sx = TE.session(g, None, device="cuda")
    for measure, weight in (
            ("adamic_adar",
             lambda d: 1.0 / np.maximum(np.log(np.maximum(d, 2.0)), 1e-6)),
            ("resource_alloc", lambda d: 1.0 / np.maximum(d, 1.0))):
        want = np.array([weight(deg[np.intersect1d(
            indices[indptr[u]:indptr[u + 1]],
            indices[indptr[v]:indptr[v + 1]])]).sum() for u, v in pairs])
        got = sx.similarity(torch.from_numpy(pairs).cuda(), measure)
        require(np.allclose(got.cpu().numpy(), want, rtol=1e-5, atol=0),
                f"scale-12 exact {measure} differs from numpy")
    print(f"phase 5: scale 12 exact_triangle_count {tc} = trace(A^3)/6; "
          f"exact Adamic-Adar and Resource-Allocation on {pairs.shape[0]} "
          f"sampled pairs (hub pairs included) equal numpy (rtol 1e-5)",
          flush=True)


_GOLDEN = 0x9E3779B9
_PAD_HASH = 0xFFFFFFFF


def numpy_bloom_cliques(np, hash_u32, bloom, indptr, indices, edges,
                        num_hashes: int, seed: int = 0):
    """Bloom 4- and 5-clique estimates from the definitions, in numpy:
    candidates w > v of N_v per edge (u, v), closed when every hash bit of
    w is set in u's row; pairs w < x of one edge's survivors closed when
    x's bits are set in w's row; Eq. 2 on popcount(AND of the rows),
    summed in float64 and divided by 4 and 5."""
    n, words = bloom.shape
    bits = words * 32
    pos = np.stack([hash_u32(np.arange(n), (i + seed * _GOLDEN) & 0xFFFFFFFF)
                    .astype(np.int64) % bits for i in range(num_hashes)], 1)

    def member(a, x):
        ok = np.ones(a.shape[0], dtype=bool)
        for i in range(num_hashes):
            p = pos[x, i]
            ok &= ((bloom[a, p >> 5] >> (p & 31).astype(np.uint32)) & 1) == 1
        return ok

    def estimate_sum(cols):
        total = 0.0
        for s0 in range(0, cols[0].shape[0], 1 << 20):
            acc = bloom[cols[0][s0:s0 + (1 << 20)]]
            for c in cols[1:]:
                acc = acc & bloom[c[s0:s0 + (1 << 20)]]
            ones = np.unpackbits(acc.view(np.uint8), axis=1).sum(axis=1)
            ones = np.minimum(ones.astype(np.float64), bits - 1)
            total += float((-(bits / num_hashes)
                            * np.log1p(-ones / bits)).sum())
        return total

    def expand(counts):
        """(item, rank) of every slot of items holding counts[i] slots."""
        item = np.repeat(np.arange(counts.shape[0]), counts)
        first = np.cumsum(counts) - counts
        return item, np.arange(item.shape[0]) - first[item]

    row = np.repeat(np.arange(n), np.diff(indptr))
    up_first = indptr[:-1].astype(np.int64) + np.bincount(
        row[indices < row], minlength=n)
    up_count = indptr[1:] - up_first
    u, v = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    e, rank = expand(up_count[v])
    w = indices[up_first[v][e] + rank].astype(np.int64)
    keep = member(u[e], w)
    e, w = e[keep], w[keep]
    cc4 = estimate_sum([u[e], v[e], w]) / 4
    later = np.searchsorted(e, e, side="right") - 1 - np.arange(e.shape[0])
    i, rank = expand(later)
    j = i + 1 + rank
    keep = member(w[i], w[j])
    i, j = i[keep], j[keep]
    cc5 = estimate_sum([u[e[i]], v[e[i]], w[i], w[j]]) / 5
    return cc4, cc5


def phase_reference_cliques(torch, np, TE, g):
    """Phase 5, cliques: the Bloom 4- and 5-clique estimates at scale 12
    against numpy's and against the exact counts; the exact branch
    reproduces the brute-force counts."""
    from repro_torch.core.algorithms import cliques
    from repro_torch.core.hashing import np_hash_u32

    sess = TE.session(g, "bf", storage_budget=0.25, device="cuda")
    t0 = time.perf_counter()
    cc4, cc5 = float(sess.four_clique_count()), float(sess.five_clique_count())
    est_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex4, ex5 = float(cliques.four_clique_count(g)), float(
        cliques.five_clique_count(g))
    exact_s = time.perf_counter() - t0
    want4, want5 = numpy_bloom_cliques(
        np, np_hash_u32, sess.sketch.data.cpu().numpy().view(np.uint32),
        g.indptr.cpu().numpy(), g.indices.cpu().numpy(),
        g.edges.cpu().numpy(), sess.sketch.num_hashes, sess.sketch.seed)
    print(f"phase 5: scale 12 cliques: Bloom 4-cliques {cc4:.6g} (numpy "
          f"{want4:.6g}, exact {ex4:.0f}, rel err "
          f"{(cc4 - ex4) / ex4:+.4f}); Bloom 5-cliques {cc5:.6g} (numpy "
          f"{want5:.6g}, exact {ex5:.0f}, rel err {(cc5 - ex5) / ex5:+.4f}); "
          f"estimates {est_s:.3f} s, exact counts {exact_s:.3f} s",
          flush=True)
    require(ex4 == EXACT_4CLIQUES_12 and ex5 == EXACT_5CLIQUES_12,
            f"exact clique counts {ex4}, {ex5} vs brute force "
            f"{EXACT_4CLIQUES_12}, {EXACT_5CLIQUES_12}")
    require(math.isclose(cc4, want4, rel_tol=1e-5)
            and math.isclose(cc5, want5, rel_tol=1e-5),
            f"Bloom clique estimates {cc4}, {cc5} vs numpy {want4}, {want5}")


def numpy_minhash(np, hash_u32, indptr, indices, n: int, k: int, d_max: int,
                  seed: int = 0):
    """k-Hash, 1-Hash and KMV sketches built row by row in numpy from the
    definitions: per hash function the neighbour of least hash (smallest
    id on ties); the k neighbours of least hash, ties by id, a hash of
    all ones read as a pad; the k least hash values mapped to (0, 1]. The
    last two keep min(k, d_max) columns, as the reference does."""
    width = min(k, d_max)
    kh = np.full((n, k), n, np.int32)
    oh = np.full((n, width), n, np.int32)
    kmv = np.full((n, width), 2.0, np.float32)
    fam = np.stack([hash_u32(indices, (i + seed * _GOLDEN) & 0xFFFFFFFF)
                    for i in range(k)], axis=1)
    h1 = hash_u32(indices, seed)
    unit = (h1.astype(np.float32) + np.float32(1.0)) * np.float32(2.0 ** -32)
    for x in range(n):
        lo, hi = int(indptr[x]), int(indptr[x + 1])
        if lo == hi:
            continue
        nb = indices[lo:hi]
        kh[x] = nb[np.argmin(fam[lo:hi], axis=0)]
        order = np.argsort(h1[lo:hi], kind="stable")[:width]
        oh[x, :order.size] = np.where(h1[lo:hi][order] == _PAD_HASH, n,
                                      nb[order])
        vals = np.sort(unit[lo:hi])[:width]
        kmv[x, :vals.size] = vals
    return kh, oh, kmv


def numpy_kmv_size(np, rows):
    filled = (rows < 2.0).sum(axis=1)
    kmax = np.where(rows < 2.0, rows, 0.0).max(axis=1)
    est = (filled - 1.0) / np.maximum(kmax, 1e-20)
    return np.where(filled >= rows.shape[1], est, filled)


def phase_reference_minhash(torch, np, TE, g, exact: float):
    """Phase 5, MinHash and KMV: sketches equal to the numpy build, TC
    within rtol 1e-4 of the numpy estimators (1-Hash: the naive variant,
    the kernel path)."""
    from repro_torch.core.hashing import np_hash_u32

    indptr, indices = g.indptr.cpu().numpy(), g.indices.cpu().numpy()
    e = g.edges.cpu().numpy()
    du = g.deg.cpu().numpy()[e[:, 0]].astype(np.float64)
    dv = g.deg.cpu().numpy()[e[:, 1]].astype(np.float64)
    k = TE.session(g, "kh", storage_budget=1.0, device="cuda").sketch.k
    kh, oh, kmv = numpy_minhash(np, np_hash_u32, indptr, indices, g.n, k,
                                g.d_max)
    n = g.n
    for kind, kw, want in (("kh", {}, kh), ("1h", {"variant": "naive"}, oh),
                           ("kmv", {}, kmv)):
        sess = TE.session(g, kind, storage_budget=1.0, device="cuda", **kw)
        got = sess.sketch.data.cpu().numpy()
        require(got.dtype == want.dtype and np.array_equal(got, want),
                f"scale-12 {kind} sketch differs from the numpy build")
        a, b = want[e[:, 0]], want[e[:, 1]]
        if kind == "kh":
            j = ((a == b) & (a < n)).sum(axis=1) / a.shape[1]
            inter = j / (1 + j) * (du + dv)
        elif kind == "1h":
            j = ((a[:, :, None] == b[:, None, :])
                 & (a[:, :, None] < n)).sum(axis=(1, 2)) / a.shape[1]
            inter = j / (1 + j) * (du + dv)
        else:
            merged = np.sort(np.concatenate([a, b], axis=1), axis=1)
            dup = np.concatenate([np.zeros((len(e), 1), bool),
                                  merged[:, 1:] == merged[:, :-1]], axis=1)
            merged = np.where(dup & (merged < 2.0), 2.0, merged)
            union = numpy_kmv_size(np, np.sort(merged, axis=1)[:, :a.shape[1]])
            inter = np.maximum(du + dv - union, 0.0)
        tc_ref = inter.sum() / 3
        tc = float(sess.triangle_count())
        require(math.isclose(tc, tc_ref, rel_tol=1e-4),
                f"scale-12 {kind} TC {tc} vs numpy {tc_ref}")
        print(f"phase 5: scale 12 {kind}{'-naive' if kw else ''} (k={k}): "
              f"sketch equal to the numpy build; TC={tc:.6g} numpy="
              f"{tc_ref:.6g} (rel err vs exact {abs(tc - exact) / exact:.4f})",
              flush=True)


def profile_run(torch, fn, wall_s: float, top: int = 6):
    """``fn()`` under torch.profiler: device busy seconds (the sum of its
    kernels' device time), the idle share against ``wall_s`` (an
    unprofiled wall time of the same work), the top kernels and the
    number of kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    lines = [f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
             f"{e.key[:90]}" for e in sorted(
                 kernels, key=lambda e: -e.self_device_time_total)[:top]]
    return (busy_s, max(0.0, 1 - busy_s / wall_s), "\n".join(lines),
            sum(e.count for e in kernels))


def hook_attention_cores(torch, ref, model, dtype_name: str, errs: list):
    """On every attention or MLA layer's core, a forward hook that holds
    the kernel's output against ``ref.causal_attention`` on the layer's
    own q, k, v under phase 2's tolerance for ``dtype_name``; each layer's
    max and mean error go to ``errs``. MLA's v (head dim 128 against q's
    192) is the core's unpadded input: the plain version takes it padded
    with zeros and its output is cut to 128, the core's output width.
    Returns the hooks' handles."""
    import torch.nn.functional as F

    def check(i):
        def hook(core, inputs, out):
            q, k, v = inputs
            dv = v.shape[-1]
            want = ref.causal_attention(
                q, k, F.pad(v, (0, q.shape[-1] - dv)), core.window
            )[..., :dv]
            diff = (out.float() - want.float()).abs()
            e, mean = float(diff.max()), float(diff.mean())
            errs.append((i, e, mean))
            require(out.dtype == want.dtype and out.shape == want.shape
                    and torch.allclose(out.float(), want.float(),
                                       **attn_tol(v, dtype_name))
                    and (dtype_name == "float32" or mean <= ATTN_BF16_MEAN),
                    f"layer {i} attention ({dtype_name}): max |kernel - "
                    f"plain| {e}, mean {mean}")
        return hook
    return [layer.mixer.core.register_forward_hook(check(i))
            for i, layer in enumerate(model.layers)
            if hasattr(layer.mixer, "core")]


def step_bytes(model, cfg, cache) -> int:
    """Bytes one decode step must move: every weight read once, except the
    token embedding, of which only the batch's rows are read (all of it
    when tied: it is the head too), and an MoE layer's experts, of which a
    step must read at least the top k; and the cache read once."""
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    batch = cache["layers"][0][next(iter(cache["layers"][0]))].shape[0]
    emb = model.embed
    if not cfg.tie_embeddings:
        total -= (emb.shape[0] - batch) * emb.shape[1] * emb.element_size()
    for layer in model.layers:
        if layer.sig[1] == "moe":
            unread = cfg.moe_num_experts - cfg.moe_top_k
            total -= sum(w[:unread].numel() * w.element_size() for w in
                         (layer.ffn.wi_gate, layer.ffn.wi_up, layer.ffn.wo))
    return total + sum(t.numel() * t.element_size()
                       for lc in cache["layers"] for t in lc.values())


def decode_against_prefill(torch, model, cfg, gen, since, bound=None,
                           why="2L·2^-8") -> dict:
    """``DECODE_TOKENS`` teacher-forced ``decode_step``s at batch
    ``DECODE_BATCH`` against the ``forward`` logits on the same random
    tokens: within ``bound`` of max |logit|, by default 2L·2^-8, one bf16
    rounding (2^-9 a side) of each of the 2L sublayers' outputs carried to
    the logits at gain 1 (top-1 agreement printed). Call under
    ``torch.inference_mode``."""
    from repro_torch.models import decode_step, forward, init_cache

    tokens = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, DECODE_TOKENS),
                           device="cuda", generator=gen)
    full = forward(model, cfg, tokens)[..., :cfg.vocab_size].float()
    cache = init_cache(cfg, DECODE_BATCH, DECODE_TOKENS, device="cuda")
    steps = []
    for i in range(DECODE_TOKENS):
        lg, cache = decode_step(model, cache, cfg, tokens[:, i:i + 1])
        steps.append(lg[:, 0, :cfg.vocab_size].float())
    dec = torch.stack(steps, dim=1)
    del steps, cache
    diff = (dec - full).abs()
    err, mean = float(diff.max()), float(diff.mean())
    scale = float(full.abs().max())
    if bound is None:
        bound = 2 * cfg.num_layers * 2.0 ** -8
    top1 = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    del dec, full, diff
    require(err <= bound * scale,
            f"{cfg.name} decode vs prefill: max |diff| {err} > {bound} x "
            f"max |logit| {scale}")
    print(f"  [{since():.1f} s] {cfg.dtype} decode_step x{DECODE_TOKENS} at "
          f"batch {DECODE_BATCH} vs forward on the same tokens: max |diff| "
          f"{err:.4g}, mean {mean:.4g}, max |logit| {scale:.4g} (bound "
          f"{why} = {bound:.4g} of it); top-1 agreement {top1:.2%}",
          flush=True)
    return dict(err=err, mean=mean, scale=scale, bound=bound, top1=top1)


def serve_and_profile(torch, np, model, cfg, since, tag: str) -> dict:
    """The launcher's loop (``launch.serve.generate``) on ``model`` at full
    width: ``SERVE_PROMPTS`` prompts, ``SERVE_TOKENS`` sampled, max_len
    ``SERVE_MAX_LEN``; tokens in the vocab; ms a step beside the step's
    bound (:func:`step_bytes` over 3.35 TB/s). Then ``PROFILE_STEPS``
    decode steps at that batch, unprofiled and under torch.profiler
    (launches a step, idle share)."""
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, init_cache

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPTS]
    sample = torch.Generator(device="cuda").manual_seed(1)

    def serve_run(num_tokens):
        return serve.generate(model, cfg, prompts, num_tokens,
                              max_len=SERVE_MAX_LEN,
                              temperature=SERVE_TEMPERATURE,
                              generator=sample)

    serve_run(1)                           # warm-up: each op at its shapes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve_run(SERVE_TOKENS)
    serve_s = time.perf_counter() - t0
    require(out.shape == (len(prompts), SERVE_TOKENS) and out.min() >= 0
            and out.max() < cfg.vocab_size,
            f"{tag} served tokens: shape {out.shape}, range [{out.min()}, "
            f"{out.max()}]")
    n_steps = max(SERVE_PROMPTS) + SERVE_TOKENS
    step_ms = serve_s / n_steps * 1e3
    with torch.inference_mode():
        nbytes = step_bytes(model, cfg, init_cache(
            cfg, len(prompts), SERVE_MAX_LEN, device="cuda"))
    step_bound_ms = nbytes / PEAK_BYTES_S * 1e3
    print(f"  [{since():.1f} s] {tag}serving {len(prompts)} prompts of "
          f"{list(SERVE_PROMPTS)} tokens, {SERVE_TOKENS} sampled at "
          f"T={SERVE_TEMPERATURE}, max_len {SERVE_MAX_LEN}: {serve_s:.3f} s "
          f"for {n_steps} decode steps, {step_ms:.3f} ms a step, "
          f"{len(prompts) * SERVE_TOKENS / serve_s:.1f} sampled tokens/s; "
          f"step bound {step_bound_ms:.3f} ms ({nbytes} bytes over "
          f"{PEAK_BYTES_S:.3g} B/s), {step_bound_ms / step_ms:.2%} of bound",
          flush=True)

    # where a decode step's time goes: PROFILE_STEPS steps at the serving
    # batch and cache length, unprofiled, then under the profiler
    step_in = torch.from_numpy(np.asarray(out[:, :1], np.int64)).cuda()

    def steps():
        with torch.inference_mode():
            cache = init_cache(cfg, len(prompts), SERVE_MAX_LEN,
                               device="cuda")
            for _ in range(PROFILE_STEPS):
                _, cache = decode_step(model, cache, cfg, step_in)

    steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    busy, idle, top, launches = profile_run(torch, steps, steps_s, top=8)
    print(f"  [{since():.1f} s] {tag}{PROFILE_STEPS} decode steps at batch "
          f"{len(prompts)}: {steps_s / PROFILE_STEPS * 1e3:.3f} ms a step; "
          f"profiled: {launches / PROFILE_STEPS:.0f} kernel launches a step, "
          f"device busy {busy / PROFILE_STEPS * 1e3:.3f} ms a step, idle "
          f"share {idle:.1%}; top kernels:\n{top}", flush=True)
    return dict(serve_s=serve_s, step_ms=step_ms, step_bound_ms=step_bound_ms,
                profiled_step_ms=steps_s / PROFILE_STEPS * 1e3,
                launches_per_step=launches / PROFILE_STEPS, idle=idle)


def phase_model(torch, np, kernels, ref) -> dict:
    """Phase 3i: the dense-transformer serving path at full width."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.analysis import roofline
    from repro_torch.models import ShapeConfig, forward, init_params

    fa = kernels.flash_attention
    t_phase = time.perf_counter()

    def since():
        return time.perf_counter() - t_phase

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get(MODEL_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_weights = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    d, L = cfg.d_model, cfg.num_layers
    norms = L * (2 * d + (2 * cfg.head_dim if cfg.qk_norm else 0)) + d
    pad = (cfg.padded_vocab - cfg.vocab_size) * d * (
        1 if cfg.tie_embeddings else 2)
    require(n_weights == cfg.total_params() + pad + norms,
            f"{n_weights} weights, expected total_params() "
            f"{cfg.total_params()} + {pad} pad rows + {norms} norm gains")
    require(all(p.dtype == torch.bfloat16 and not p.requires_grad
                for p in model.parameters()), "weights not bf16 inference")
    print(f"phase 3i: {MODEL_ARCH} at full width ({L} layers, d_model {d}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size} padded to "
          f"{cfg.padded_vocab}, {cfg.dtype}): {n_weights} weights "
          f"(total_params() {cfg.total_params()}), {weight_bytes} bytes, "
          f"drawn in {init_s:.2f} s", flush=True)

    # prefill: one warm-up forward, then the counted and timed one
    shape = ShapeConfig(f"prefill_{PREFILL_SEQ // 1024}k", PREFILL_SEQ, 1,
                        "prefill")
    flops = (roofline.model_flops(cfg, shape)
             + roofline.attention_flops(cfg, shape))
    bound_s = flops / roofline.PEAK_FLOPS_BF16
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_SEQ),
                           device="cuda", generator=gen)
    times = []
    with torch.inference_mode():
        logits = forward(model, cfg, tokens)
        torch.cuda.synchronize()
        del logits
        torch.cuda.reset_peak_memory_stats()
        for rep in range(3):
            if rep == 0:
                kernels.reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            logits = forward(model, cfg, tokens)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
            if rep == 0:
                prefill_peak = torch.cuda.max_memory_allocated()
                routes = dict(fa.ROUTE_LAUNCHES)
                others = {k: n for k, n in kernels.launch_counts().items()
                          if n and k != "flash_attention"}
                require(routes == {"wgmma_bf16": L, "fma_fp32": 0}
                        and not others,
                        f"the {MODEL_ARCH} forward launched {routes}, "
                        f"{others}; expected {L} wgmma_bf16 and nothing else")
                # finite iff the extremes are (max and min propagate NaN)
                ends = torch.stack([logits[..., :cfg.vocab_size].amax(),
                                    logits[..., :cfg.vocab_size].amin()])
                require(tuple(logits.shape) == (1, PREFILL_SEQ,
                                                cfg.padded_vocab)
                        and bool(torch.isfinite(ends).all())
                        and bool((logits[..., cfg.vocab_size:]
                                  == -1e30).all()),
                        "prefill logits: shape, finite values or pad mask")
            del logits
        prefill_s = sorted(times)[1]
        busy, idle, top, _ = profile_run(
            torch, lambda: forward(model, cfg, tokens), prefill_s, top=8)
        print(f"  [{since():.1f} s] prefill B=1 S={PREFILL_SEQ}: "
              f"{prefill_s:.4f} s (median of {[round(t, 4) for t in times]};"
              f" events), "
              f"{PREFILL_SEQ / prefill_s:.0f} tokens/s, peak memory "
              f"{prefill_peak} bytes; bound {bound_s:.4f} s "
              f"({flops:.4g} flop: model_flops + attention_flops over "
              f"{roofline.PEAK_FLOPS_BF16:.4g} flop/s), "
              f"{bound_s / prefill_s:.2%} of bound; launches {routes}; "
              f"profiled: device busy "
              f"{busy * 1e3:.3f} ms, idle share {idle:.1%}; top kernels:\n"
              f"{top}", flush=True)
        # the flash kernel alone at one layer's prefill shape
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = torch.randn((1, PREFILL_SEQ, h, hd), device="cuda",
                        generator=gen).to(torch.bfloat16)
        k, v = (torch.randn((1, PREFILL_SEQ, kvh, hd), device="cuda",
                            generator=gen).to(torch.bfloat16)
                for _ in range(2))
        attn_ms = time_ms(lambda: fa.flash_attention(q, k, v),
                          lambda: None, reps=10, warmup=2)
        attn_flops = 4 * h * hd * attended_pairs(PREFILL_SEQ, 0)
        attn_bound, _ = bound_ms(0, attn_flops, PEAK_BF16_FLOPS)
        del q, k, v
        print(f"  [{since():.1f} s] flash_attention_wgmma at one layer's "
              f"prefill shape (B=1 S={PREFILL_SEQ} H={h} KV={kvh} D={hd}): "
              f"{attn_ms:.4f} ms"
              f" (bound {attn_bound:.4f} ms, {attn_bound / attn_ms:.2%}); "
              f"{L} layers {L * attn_ms / 1e3:.4f} s, "
              f"{L * attn_ms / 1e3 / prefill_s:.1%} of the prefill",
              flush=True)

        # every layer's kernel against the plain version, on its q, k, v
        errs = []
        handles = hook_attention_cores(torch, ref, model, "bfloat16", errs)
        try:
            hook_tokens = tokens[:, :HOOK_SEQ]
            before = fa.ROUTE_LAUNCHES["wgmma_bf16"]
            logits = forward(model, cfg, hook_tokens)
            torch.cuda.synchronize()
            del logits
        finally:
            for handle in handles:
                handle.remove()
        require(len(errs) == L and fa.ROUTE_LAUNCHES["wgmma_bf16"]
                == before + L, f"hooked {len(errs)} layers")
        bf16_err = max(e for _, e, _ in errs)
        print(f"  [{since():.1f} s] every layer's kernel output "
              f"(S={HOOK_SEQ}) within phase 2's bf16 tolerance of "
              f"ref.causal_attention on its own q, k, v: max |kernel - "
              f"plain| {bf16_err:.4g} (layer "
              f"{max(errs, key=lambda r: r[1])[0]}), largest mean "
              f"{max(m for _, _, m in errs):.3g}", flush=True)

        # decode against prefill on the same tokens
        dec = decode_against_prefill(torch, model, cfg, gen, since)
        dec_err, scale, top1 = dec["err"], dec["scale"], dec["top1"]

    # serving: the launcher's loop at full width
    served = serve_and_profile(torch, np, model, cfg, since, "")
    step_ms, step_bound_ms = served["step_ms"], served["step_bound_ms"]
    phase_peak = max(init_peak, torch.cuda.max_memory_allocated())
    del model
    torch.cuda.empty_cache()

    # the float32 route on the path: full width, FP32_LAYERS layers
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=FP32_LAYERS)
    model32 = init_params(cfg32, gen, device="cuda")
    errs = []
    handles = hook_attention_cores(torch, ref, model32, "float32", errs)
    try:
        with torch.inference_mode():
            kernels.reset_launch_counts()
            logits = forward(model32, cfg32, tokens[:, :HOOK_SEQ])
            torch.cuda.synchronize()
            fp32_routes = dict(fa.ROUTE_LAUNCHES)
            finite = bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
            del logits
    finally:
        for handle in handles:
            handle.remove()
    require(fp32_routes == {"wgmma_bf16": 0, "fma_fp32": FP32_LAYERS}
            and len(errs) == FP32_LAYERS and finite,
            f"float32 forward: launches {fp32_routes}, {len(errs)} layers "
            f"checked, finite {finite}")
    fp32_err = max(e for _, e, _ in errs)
    phase_peak = max(phase_peak, torch.cuda.max_memory_allocated())
    del model32
    torch.cuda.empty_cache()
    print(f"  [{since():.1f} s] float32 route: {MODEL_ARCH} at full width,"
          f" {FP32_LAYERS} layers, S={HOOK_SEQ}: launches {fp32_routes}; "
          f"every layer within "
          f"atol = rtol = 2e-5 of ref.causal_attention, max |kernel - plain| "
          f"{fp32_err:.4g}", flush=True)

    # the launcher, in a process of its own
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--device", "cuda"], capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    first = (run.stdout.splitlines() or [""])[0]
    require(run.returncode == 0 and re.fullmatch(
        r"generated \(4, 32\) in [0-9.]+s \([0-9.]+ tok/s\) on cuda:0",
        first), f"serve launcher: exit {run.returncode}, first line "
                f"{first!r}, stderr {run.stderr[-2000:]}")
    print(f"  [{since():.1f} s] python -m repro_torch.launch.serve --device "
          f"cuda: {first!r} ({time.perf_counter() - t0:.1f} s with the "
          f"process start)",
          flush=True)
    out = dict(prefill_s=prefill_s, prefill_times=times, bound_s=bound_s,
               prefill_peak=prefill_peak, phase_peak=phase_peak,
               attn_ms=attn_ms, bf16_launches=routes["wgmma_bf16"],
               fp32_launches=fp32_routes["fma_fp32"], bf16_err=bf16_err,
               fp32_err=fp32_err, dec_err=dec_err, dec_scale=scale,
               top1=top1, step_ms=step_ms, step_bound_ms=step_bound_ms,
               serve_s=served["serve_s"],
               phase_s=time.perf_counter() - t_phase)
    print(f"phase 3i: {out['phase_s']:.1f} s in all, peak memory "
          f"{phase_peak} bytes ({smi_line()})", flush=True)
    return out


def numpy_routing(np, logits, k: int, cap: int):
    """The reference's MoE routing as a numpy rule on the router's float32
    logits [t, E]: each token's k largest logits (the softmax keeps their
    order; ties to the smaller expert id), gates their softmax
    probabilities renormalised (float64), each assignment's rank within its
    expert counted in token order, kept below ``cap``."""
    lg = logits.astype(np.float64)
    idx = np.argsort(-lg, axis=1, kind="stable")[:, :k]
    p = np.exp(lg - lg.max(axis=1, keepdims=True))
    gates = np.take_along_axis(p, idx, axis=1)
    gates /= gates.sum(axis=1, keepdims=True)
    seen = np.zeros(lg.shape[1], np.int64)
    rank = np.empty(idx.size, np.int64)
    for i, ex in enumerate(idx.reshape(-1).tolist()):
        rank[i] = seen[ex]
        seen[ex] += 1
    return idx, gates, rank, rank < cap


def moe_float32(torch, moe, cfg, xt, idx, gates, keep):
    """The MoE layer over ``xt`` [t, d] in float32, expert by expert: each
    kept assignment's token through its expert's SiLU-gated MLP, weighted
    by its gate and summed per token; plus the shared expert."""
    import torch.nn.functional as F

    require(cfg.act == "silu", f"{cfg.name}: act {cfg.act}")
    k = cfg.moe_top_k
    x = xt.float()
    y = torch.zeros_like(x)
    tok = torch.arange(idx.numel(), device=x.device) // k
    flat, g = idx.reshape(-1), gates.reshape(-1)
    for ex in range(cfg.moe_num_experts):
        sel = ((flat == ex) & keep).nonzero()[:, 0]
        if sel.numel():
            xe = x[tok[sel]]
            h = F.silu(xe @ moe.wi_gate[ex].float()) * (
                xe @ moe.wi_up[ex].float())
            y.index_add_(0, tok[sel], (h @ moe.wo[ex].float())
                         * g[sel, None])
    if cfg.moe_shared_experts:
        sh = moe.shared
        y += (F.silu(x @ sh.wi_gate.float()) * (x @ sh.wi_up.float())) \
            @ sh.wo.float()
    return y


def check_moe_layer(torch, np, moe, cfg, x, y, since) -> dict:
    """One full-width MoE layer's call on its own input ``x`` [1, S, d]
    (output ``y``): its routing (``moe_route``, the function ``moe_fwd``
    calls) equal to :func:`numpy_routing` on its logits, ids, kept and
    dropped assignments; ``y`` against :func:`moe_float32` with the same
    drops. Bound: the bf16 layer rounds its dispatched rows' products, the
    activation, the gated product, the expert output, the gate and the
    weighted sum to bf16, about ten roundings of 2^-9 between input and
    output: max |bf16 - float32| <= MOE_BF16_TOL (2^-5) of max |float32|,
    mean <= MOE_BF16_MEAN_TOL (2^-6) of its mean |value|."""
    from repro_torch.models import layers as L

    t = x.shape[0] * x.shape[1]
    xt = x.reshape(t, -1)
    r = L.moe_route(moe, xt, cfg)
    idx, gates, rank, keep = numpy_routing(np, r.logits.cpu().numpy(),
                                           cfg.moe_top_k, r.cap)
    got_keep = r.keep.cpu().numpy()
    require(np.array_equal(r.idx.cpu().numpy(), idx)
            and np.array_equal(r.rank.cpu().numpy(), rank)
            and np.array_equal(got_keep, keep),
            f"{cfg.name} routing differs from the numpy rule: ids "
            f"{int((r.idx.cpu().numpy() != idx).sum())}, kept "
            f"{int(got_keep.sum())} vs {int(keep.sum())}")
    kept, dropped = int(keep.sum()), int((~keep).sum())
    want = moe_float32(torch, moe, cfg, xt, torch.from_numpy(idx).cuda(),
                       torch.from_numpy(gates).float().cuda(),
                       torch.from_numpy(keep).cuda())
    diff = (y.reshape(t, -1).float() - want).abs()
    err, mean = float(diff.max()), float(diff.mean())
    scale, mean_ref = float(want.abs().max()), float(want.abs().mean())
    require(err <= MOE_BF16_TOL * scale and mean <= MOE_BF16_MEAN_TOL
            * mean_ref, f"{cfg.name} MoE layer vs float32 loop: max "
            f"{err} (max |ref| {scale}), mean {mean} (mean |ref| "
            f"{mean_ref})")
    used = int((np.bincount(idx[keep.reshape(idx.shape)],
                            minlength=cfg.moe_num_experts) > 0).sum())
    print(f"  [{since():.1f} s] one MoE layer ({cfg.moe_num_experts} "
          f"experts, top-{cfg.moe_top_k}, d_ff {cfg.moe_d_ff}, "
          f"{cfg.moe_shared_experts} shared) on its {t} tokens: routing "
          f"equal to the numpy rule ({t * cfg.moe_top_k} assignments, cap "
          f"{r.cap}: {kept} kept, {dropped} dropped, {used} experts used); "
          f"output vs the float32 per-expert loop: max |diff| {err:.4g} of "
          f"max |ref| {scale:.4g} ({err / scale:.3%}; bound 2^-5), mean "
          f"{mean:.4g} of {mean_ref:.4g} ({mean / mean_ref:.3%}; bound "
          f"2^-6)", flush=True)
    return dict(kept=kept, dropped=dropped, cap=r.cap, err=err, scale=scale,
                mean=mean, mean_ref=mean_ref)


def check_mla_decode(torch, mixer, cfg, gen, since) -> dict:
    """The first MLA layer alone: ``MLA_DECODE_POS`` absorbed
    ``mla_decode`` steps against ``mla_fwd`` (the flash kernel) on the same
    unit-RMS bf16 input, as the layer sees after its norm. The two paths
    round at different places (the expanded k and v against the absorbed
    query and context, each a bf16 rounding of 2^-9 on the way to about
    eight such roundings a side): max |decode - forward| <= MLA_DECODE_TOL
    (2^-5) of max |forward|."""
    from repro_torch.models import layers as L

    n = MLA_DECODE_POS
    x = torch.randn((1, n, cfg.d_model), device="cuda",
                    generator=gen).to(torch.bfloat16)
    pos = torch.arange(n, dtype=torch.int32, device="cuda")[None]
    fwd = L.mla_fwd(mixer, x, cfg, pos).float()
    cache = L.init_mla_cache(cfg, 1, n, torch.bfloat16, "cuda")
    dec = torch.cat([L.mla_decode(mixer, x[:, i:i + 1], cache, cfg, i)
                     for i in range(n)], dim=1).float()
    err, scale = float((dec - fwd).abs().max()), float(fwd.abs().max())
    require(err <= MLA_DECODE_TOL * scale,
            f"MLA absorbed decode vs mla_fwd: max |diff| {err} > 2^-5 x "
            f"{scale}")
    print(f"  [{since():.1f} s] first MLA layer alone: {n} absorbed "
          f"mla_decode steps vs mla_fwd on the same input: max |diff| "
          f"{err:.4g} of max |forward| {scale:.4g} ({err / scale:.3%}; "
          f"bound 2^-5)", flush=True)
    return dict(err=err, scale=scale)


def check_ssm_decode(torch, mixer, cfg, gen, since) -> dict:
    """The first SSM layer alone: ``DECODE_TOKENS`` ``ssm_decode`` steps at
    batch ``DECODE_BATCH`` against ``ssm_fwd`` on the same unit-normal bf16
    input. The two round apart (the prefill rounds wmat, the decode carries
    its state in float32 step by step): max |decode - forward| <=
    SSM_LAYER_TOL (2^-5) of max |forward|, mean <= SSM_LAYER_MEAN_TOL
    (2^-7) of mean |forward|."""
    from repro_torch.models import ssm as S

    x = torch.randn((DECODE_BATCH, DECODE_TOKENS, cfg.d_model),
                    device="cuda", generator=gen).to(torch.bfloat16)
    fwd = S.ssm_fwd(mixer, x, cfg).float()
    cache = S.init_ssm_cache(cfg, DECODE_BATCH, torch.bfloat16, "cuda")
    dec = torch.cat([S.ssm_decode(mixer, x[:, i:i + 1], cache, cfg)
                     for i in range(DECODE_TOKENS)], dim=1).float()
    diff = (dec - fwd).abs()
    err, mean = float(diff.max()), float(diff.mean())
    scale, mean_ref = float(fwd.abs().max()), float(fwd.abs().mean())
    require(err <= SSM_LAYER_TOL * scale
            and mean <= SSM_LAYER_MEAN_TOL * mean_ref,
            f"{cfg.name} SSM layer decode vs ssm_fwd: max |diff| {err} "
            f"(max |forward| {scale}), mean {mean} (mean |forward| "
            f"{mean_ref})")
    print(f"  [{since():.1f} s] first SSM layer alone: {DECODE_TOKENS} "
          f"ssm_decode steps at batch {DECODE_BATCH} vs ssm_fwd on the same "
          f"input: max |diff| {err:.4g} of max |forward| {scale:.4g} "
          f"({err / scale:.3%}; bound 2^-5), mean {mean:.4g} of {mean_ref:.4g}"
          f" ({mean / mean_ref:.3%}; bound 2^-7)", flush=True)
    return dict(err=err, scale=scale, mean=mean, mean_ref=mean_ref)


def phase_arch(torch, np, kernels, ref, arch: str, layers: int,
               since) -> dict:
    """Phase 3j for one config: full width, the first ``layers`` layers,
    bf16 weights from a seeded CUDA generator (float32 where the reference
    keeps them). The prefill ``forward`` at B = 1, S = ``ARCH_SEQ`` timed
    by CUDA events with the launch counts zeroed just before and read just
    after (one ``wgmma_bf16`` launch per attention or MLA layer, nothing
    else), beside its flop bound, and profiled; a second forward with
    every attention core hooked (:func:`hook_attention_cores`) and the
    first MoE layer's input and output kept for :func:`check_moe_layer`;
    then MLA's absorbed decode (deepseek_v3), the first SSM layer's decode
    against its prefill (mamba2_130m, jamba15_large), the model's decode
    against its prefill (mamba2_130m), and the serving loop
    (``ARCH_SERVED``)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.analysis import roofline
    from repro_torch.models import ShapeConfig, forward, init_params

    fa = kernels.flash_attention
    full = configs.get(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sigs = [layer.sig for layer in model.layers]
    n_attn = sum(m in ("attn", "mla") for m, _ in sigs)
    n_weights = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    wrong = [name for name, p in model.named_parameters()
             if p.requires_grad or p.dtype != (
                 torch.float32 if name.rsplit(".", 1)[-1] in FLOAT32_LEAVES
                 else torch.bfloat16)]
    require(not wrong, f"{arch}: weights of the wrong type {wrong[:4]}")
    kinds = {}
    for sig in sigs:
        kinds["+".join(sig)] = kinds.get("+".join(sig), 0) + 1
    print(f"phase 3j: {arch} at full width (d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}), depth cut to {layers} of {full.num_layers} "
          f"layers ({', '.join(f'{n} {k}' for k, n in kinds.items())}): "
          f"{n_weights} weights (total_params() of the cut config "
          f"{cfg.total_params()}), {weight_bytes} bytes, drawn in "
          f"{init_s:.2f} s", flush=True)

    shape = ShapeConfig(f"prefill_{ARCH_SEQ // 1024}k", ARCH_SEQ, 1,
                        "prefill")
    flops = (roofline.model_flops(cfg, shape)
             + roofline.attention_flops(cfg, shape))
    bound_s = flops / roofline.PEAK_FLOPS_BF16
    tokens = torch.randint(0, cfg.vocab_size, (1, ARCH_SEQ), device="cuda",
                           generator=gen)
    out = dict(layers=layers, of=full.num_layers, weights=n_weights,
               weight_bytes=weight_bytes, init_s=init_s, bound_s=bound_s,
               flash_layers=n_attn)
    with torch.inference_mode():
        logits = forward(model, cfg, tokens)             # warm-up
        torch.cuda.synchronize()
        del logits
        times = []
        for rep in range(3):
            if rep == 0:
                kernels.reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            logits = forward(model, cfg, tokens)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
            if rep == 0:
                routes = dict(fa.ROUTE_LAUNCHES)
                others = {k: n for k, n in kernels.launch_counts().items()
                          if n and k != "flash_attention"}
                require(routes == {"wgmma_bf16": n_attn, "fma_fp32": 0}
                        and not others,
                        f"the {arch} forward launched {routes}, {others}; "
                        f"expected {n_attn} wgmma_bf16 and nothing else")
                ends = torch.stack([logits[..., :cfg.vocab_size].amax(),
                                    logits[..., :cfg.vocab_size].amin()])
                require(tuple(logits.shape) == (1, ARCH_SEQ,
                                                cfg.padded_vocab)
                        and bool(torch.isfinite(ends).all())
                        and bool((logits[..., cfg.vocab_size:]
                                  == -1e30).all()),
                        f"{arch} prefill logits: shape, finite values or pad "
                        f"mask")
            del logits
        prefill_s = sorted(times)[1]
        busy, idle, top, _ = profile_run(
            torch, lambda: forward(model, cfg, tokens), prefill_s, top=6)
        out.update(prefill_s=prefill_s, times=times, launches=routes,
                   idle=idle, busy_s=busy)
        print(f"  [{since():.1f} s] prefill B=1 S={ARCH_SEQ}: {prefill_s:.4f}"
              f" s (median of {[round(t, 4) for t in times]}; events), "
              f"{ARCH_SEQ / prefill_s:.0f} tokens/s; bound {bound_s:.4f} s "
              f"({flops:.4g} flop: model_flops + attention_flops over "
              f"{roofline.PEAK_FLOPS_BF16:.4g} flop/s), "
              f"{bound_s / prefill_s:.2%} of bound; launches {routes}; "
              f"profiled: device busy {busy * 1e3:.3f} ms, idle share "
              f"{idle:.1%}; top kernels:\n{top}", flush=True)

        # every attention core against the plain version, and the first
        # MoE layer's own input and output
        errs, moe_io = [], {}
        handles = hook_attention_cores(torch, ref, model, "bfloat16", errs)
        first_moe = next((layer.ffn for layer in model.layers
                          if layer.sig[1] == "moe"), None)
        def keep_moe_io(module, inputs, y):
            moe_io.setdefault("io", (inputs[0], y))

        if first_moe is not None:
            handles.append(first_moe.register_forward_hook(keep_moe_io))
        try:
            logits = forward(model, cfg, tokens)
            torch.cuda.synchronize()
            del logits
        finally:
            for handle in handles:
                handle.remove()
        require(len(errs) == n_attn, f"{arch}: hooked {len(errs)} cores")
        if errs:
            out["flash_err"] = max(e for _, e, _ in errs)
            print(f"  [{since():.1f} s] every attention/MLA layer's kernel "
                  f"output within phase 2's bf16 tolerance of "
                  f"ref.causal_attention on its own q, k, v: max |kernel - "
                  f"plain| {out['flash_err']:.4g} (layer "
                  f"{max(errs, key=lambda r: r[1])[0]}), largest mean "
                  f"{max(m for _, _, m in errs):.3g}", flush=True)
        if first_moe is not None:
            out["moe"] = check_moe_layer(torch, np, first_moe, cfg,
                                         *moe_io.pop("io"), since)
        if cfg.mla:
            out["mla_decode"] = check_mla_decode(
                torch, model.layers[0].mixer, cfg, gen, since)
        if cfg.ssm:
            out["ssm_decode"] = check_ssm_decode(
                torch, next(layer.mixer for layer in model.layers
                            if layer.sig[0] == "ssm"), cfg, gen, since)
        if not n_attn:
            out["decode"] = decode_against_prefill(
                torch, model, cfg, gen, since, bound=SSM_DECODE_BF16,
                why="the reference's own drift, 0.17-0.36, with room")
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            model32 = init_params(cfg32, gen, device="cuda")
            out["decode32"] = decode_against_prefill(
                torch, model32, cfg32, gen, since, bound=SSM_DECODE_FP32,
                why="1e-3")
            del model32
    if arch in ARCH_SERVED:
        out["serve"] = serve_and_profile(torch, np, model, cfg, since,
                                         f"{arch} ")
    out["peak"] = torch.cuda.max_memory_allocated()
    del model
    torch.cuda.empty_cache()
    return out


def phase_archs(torch, np, kernels, ref) -> dict:
    """Phase 3j: the MoE, MLA, SSM and hybrid configs at full width, one
    at a time (each freed before the next), then the launcher's ``main``
    with ``--device cuda`` for ``ARCH_SERVED``."""
    import contextlib
    import io

    from repro_torch.launch import serve

    t_phase = time.perf_counter()

    def since():
        return time.perf_counter() - t_phase

    archs = {arch: phase_arch(torch, np, kernels, ref, arch, layers, since)
             for arch, layers in ARCH_MODELS}
    for arch in ARCH_SERVED:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            toks = serve.main(["--arch", arch, "--device", "cuda"])
        first = (text.getvalue().splitlines() or [""])[0]
        require(toks.shape == (4, 32) and re.fullmatch(
            r"generated \(4, 32\) in [0-9.]+s \([0-9.]+ tok/s\) on cuda:0",
            first), f"serve main --arch {arch}: {toks.shape}, {first!r}")
        print(f"  [{since():.1f} s] launch.serve main --arch {arch} --device "
              f"cuda: {first!r}", flush=True)
    out = dict(archs=archs, phase_s=time.perf_counter() - t_phase,
               bf16_launches=sum(a["launches"]["wgmma_bf16"]
                                 for a in archs.values()),
               peak=max(a["peak"] for a in archs.values()))
    print(f"phase 3j: {out['phase_s']:.1f} s in all, "
          f"{out['bf16_launches']} wgmma_bf16 launches in the four "
          f"prefills, peak memory {out['peak']} bytes ({smi_line()})",
          flush=True)
    return out


def flash_gradient_cell(torch, fa, ref, flush, name, shape, gen, since
                        ) -> dict:
    """The flash Function at one layer's shape, bfloat16: its output and
    dq, dk, dv against autograd through ``ref.causal_attention`` on the
    same tensors (phase 2's forward tolerance; gradients within one bf16
    ulp, 2^-7 of the value, plus 1e-6 of max |plain|: both round a
    float32 gradient once), then forward + backward timed beside the
    backward alone, the plain version's forward + backward and SDPA's (a
    yardstick) on the same inputs, and the bound: the flops of forward
    and backward, 2·H·pairs·(4·D + 3·Dv), over the bf16 tensor-core
    rate."""
    import torch.nn.functional as F

    from repro_torch.models.layers import AttentionCore

    b, s, h, kvh, d, dv = shape

    def draw(*dims):
        return torch.randn(dims, device="cuda", generator=gen).to(
            torch.bfloat16).requires_grad_()
    q, k, v = draw(b, s, h, d), draw(b, s, kvh, d), draw(b, s, kvh, dv)
    dout = draw(b, s, h, dv).detach()
    core = AttentionCore(0)
    before = fa.ROUTE_LAUNCHES["wgmma_bf16"]
    out = core(q, k, v)
    require(fa.ROUTE_LAUNCHES["wgmma_bf16"] == before + 1,
            f"{name}: the Function's forward launched "
            f"{fa.ROUTE_LAUNCHES['wgmma_bf16'] - before} wgmma kernels")
    got = torch.autograd.grad(out, (q, k, v), dout)
    out = out.detach()

    def plain():
        return ref.causal_attention(q, k, F.pad(v, (0, d - dv)), 0)[..., :dv]
    want_out = plain()
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    want_out = want_out.detach()
    diff = (out.float() - want_out.float()).abs()
    require(torch.allclose(out.float(), want_out.float(),
                           **attn_tol(v.detach(), "bfloat16"))
            and float(diff.mean()) <= ATTN_BF16_MEAN,
            f"{name}: Function output vs plain, max {float(diff.max())}")
    errs = {}
    for what, g, w in zip("qkv", got, want):
        gd = (g.float() - w.float()).abs()
        scale = float(w.float().abs().max())
        errs[what] = float(gd.max()) / scale
        require(g.dtype == torch.bfloat16 and bool(
            (gd <= 2.0 ** -7 * w.float().abs() + 1e-6 * scale).all()),
            f"{name}: d{what} vs plain autograd, max |diff| "
            f"{float(gd.max())} of max {scale}")
    del out, want_out, got, want, diff
    v_pad = F.pad(v.detach(), (0, d - dv))
    dout_pad = F.pad(dout, (0, d - dv))
    ms = time_ms(lambda: torch.autograd.grad(core(q, k, v), (q, k, v), dout),
                 flush, reps=5, warmup=1)
    bwd_ms = time_ms(lambda: fa.attention_backward(
        q.detach(), k.detach(), v_pad, dout_pad, 0), flush, reps=5, warmup=1)
    plain_ms = time_ms(lambda: torch.autograd.grad(plain(), (q, k, v), dout),
                       flush, reps=3, warmup=1)
    vp = v_pad.clone().requires_grad_()
    lib = library_attention(torch, q, k, vp, 0)
    lib_dout = dout_pad.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.autograd.grad(lib(), (q, k, vp),
                                                 lib_dout),
                     flush, reps=5, warmup=1)
    flops = 2 * h * attended_pairs(s, 0) * (4 * d + 3 * dv)
    bound, by = bound_ms(0, flops, PEAK_BF16_FLOPS)
    print(f"  [{since():.1f} s] flash Function {name} (B={b} S={s} H={h} "
          f"KV={kvh} D={d} Dv={dv}, bf16): output and dq/dk/dv within bound "
          f"of plain autograd (max |diff| / max: "
          + ", ".join(f"d{w} {e:.3g}" for w, e in errs.items())
          + f"); forward + backward {ms:.3f} ms (backward alone "
          f"{bwd_ms:.3f} ms), plain {plain_ms:.3f} ms, SDPA {lib_ms:.3f} ms; "
          f"bound {bound:.4f} ms ({flops:.4g} flop over "
          f"{PEAK_BF16_FLOPS:.4g} flop/s), {bound / ms:.2%} of it",
          flush=True)
    return dict(ms=ms, bwd_ms=bwd_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=by, errs=errs)


def card_vs_cpu_step(torch, arch: str, since) -> dict:
    """One reduced float32 ``make_train_step`` step (Adafactor, lr 1e-2,
    remat on) on the card against the same step on the CPU from the same
    state, as the card test holds it: every gradient within 1e-4 of max
    |CPU|; loss and ``grad_norm`` within rtol 1e-4; parameters within 1e-4
    of max |CPU| on all but 1e-3 of each tensor and within 2.1 · lr
    everywhere (a gradient that is zero up to its float32 error may step
    the other way: Adafactor's first update of an unfactored leaf is
    lr · g / |g|)."""
    import copy
    import dataclasses

    from repro_torch import configs
    from repro_torch.distributed.step import init_train_state, \
        make_train_step
    from repro_torch.models import loss_fn, reduced
    from repro_torch.optim import Adafactor

    cfg = dataclasses.replace(
        reduced(configs.get(arch), layers=3, d_model=256, heads=4, kv=2,
                ff=512, vocab=1000), dtype="float32")
    lr = 1e-2
    opt = Adafactor(learning_rate=lr)
    host = init_train_state(cfg, opt, 0, device="cpu")

    def to_card(tree):
        return ({k: to_card(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.cuda())
    card = {"params": copy.deepcopy(host["params"]).cuda(),
            "opt": to_card(host["opt"])}
    gen = torch.Generator().manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
             for k in ("inputs", "labels")}
    card_batch = to_card(batch)
    grad_err = max(float((g.cpu() - w).abs().max() / w.abs().max())
                   for g, w in zip(
                       torch.autograd.grad(
                           loss_fn(card["params"], cfg, card_batch),
                           list(card["params"].parameters())),
                       torch.autograd.grad(
                           loss_fn(host["params"], cfg, batch),
                           list(host["params"].parameters()))))
    step = make_train_step(cfg, opt)
    card, got = step(card, card_batch)
    host, want = step(host, batch)
    rel = {key: abs(float(got[key]) - float(want[key])) / abs(float(
        want[key])) for key in ("loss", "grad_norm")}
    cpu = dict(host["params"].named_parameters())
    worst, flipped, off_share = 0.0, 0, 0.0
    for name, p in card["params"].named_parameters():
        w = cpu[name].detach()
        diff = (p.detach().cpu() - w).abs()
        off = diff > 1e-4 * float(w.abs().max())
        flipped += int(off.sum())
        off_share = max(off_share, float(off.float().mean()))
        worst = max(worst, float(diff.max()))
    require(grad_err <= 1e-4 and max(rel.values()) <= 1e-4
            and worst <= 2.1 * lr and off_share <= 1e-3,
            f"{arch} train step card vs CPU: gradients {grad_err}, {rel}, "
            f"parameters max |diff| {worst}, {flipped} elements off")
    print(f"  [{since():.1f} s] reduced {arch} train step (float32, "
          f"Adafactor) card vs CPU: gradients within {grad_err:.3g} of max "
          f"|CPU|, loss {float(got['loss']):.6f} (rel {rel['loss']:.3g}), "
          f"grad_norm rel {rel['grad_norm']:.3g}; parameters: {flipped} "
          f"elements beyond 1e-4 of max |CPU| (max |diff| {worst:.3g}, lr "
          f"{lr})", flush=True)
    return dict(rel, grad_err=grad_err, flipped=flipped)


def event_steps(torch, times: list):
    """An ``on_metrics`` callback for ``train``: a CUDA event and the
    flash launches at the end of each step (``train`` has synchronized
    on the step's loss), and finite loss and ``grad_norm`` required."""
    from repro_torch.kernels import flash_attention as fa

    def record(step, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        times.append((step, ev, sum(fa.ROUTE_LAUNCHES.values()),
                      float(metrics["loss"]), float(metrics["grad_norm"])))
        require(math.isfinite(times[-1][3]) and math.isfinite(times[-1][4]),
                f"step {step}: loss {times[-1][3]}, grad_norm "
                f"{times[-1][4]}")
    return record


def step_times(times: list) -> list:
    """Seconds of each step after the first, from consecutive events."""
    for _, ev, *_ in times:
        ev.synchronize()
    return [a[1].elapsed_time(b[1]) / 1e3 for a, b in zip(times, times[1:])]


def optimizer_update_s(torch, opt, state) -> float:
    """Seconds of the optimizer's update alone on the state's parameters
    (CUDA events; the second of two updates), with gradients drawn at the
    parameters' dtype."""
    model = state["params"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    grads = {n: torch.randn(p.shape, device="cuda", generator=gen,
                            dtype=p.dtype).mul_(1e-3)
             for n, p in model.named_parameters()}
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        opt.update(grads, state["opt"], model)
        stop.record()
        stop.synchronize()
    return start.elapsed_time(stop) / 1e3


def phase_train(torch, np, kernels, ref) -> dict:
    """Phase 3k: the training path. The flash Function's gradients at
    ``qwen3_8b``'s and MLA's layer shapes; a reduced train step on the
    card against the CPU; a reduced ``gemma_2b`` run that learns; a fault
    recovered from a checkpoint; ``qwen3_8b`` at full width and depth
    through ``train()`` (Adafactor, B = 1, S = TRAIN_SEQ) and AdamW at
    full width with ``ADAMW_LAYERS`` layers; the launcher's ``main``."""
    import contextlib
    import dataclasses
    import io

    from repro_torch import configs
    from repro_torch.analysis import roofline
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed.fault import FaultInjector
    from repro_torch.distributed.step import init_train_state, \
        make_train_step
    from repro_torch.launch import train as TT
    from repro_torch.models import ShapeConfig
    from repro_torch.optim import AdamW, cosine_warmup

    fa = kernels.flash_attention
    t_phase = time.perf_counter()

    def since():
        return time.perf_counter() - t_phase

    torch.cuda.empty_cache()
    flush = make_flush(torch)
    gen = torch.Generator(device="cuda").manual_seed(24)
    cfg = configs.get(TRAIN_ARCH)
    mla = configs.get("deepseek_v3")
    grad_cells = {
        TRAIN_ARCH: flash_gradient_cell(
            torch, fa, ref, flush, TRAIN_ARCH,
            (1, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
             cfg.head_dim), gen, since),
        "deepseek_v3 MLA": flash_gradient_cell(
            torch, fa, ref, flush, "deepseek_v3 MLA",
            (1, ATTN_CONTEXT["deepseek_v3"], mla.num_heads, mla.num_heads,
             mla.qk_nope_head_dim + mla.qk_rope_head_dim, mla.v_head_dim),
            gen, since)}
    del flush
    torch.cuda.empty_cache()
    card_cpu = {arch: card_vs_cpu_step(torch, arch, since)
                for arch in ("qwen3_8b", "deepseek_v3")}

    # reduced runs through train(): descent, then a fault and its recovery
    kernels.reset_launch_counts()
    _, hist = TT.train(TT.TrainRunConfig(
        arch="gemma_2b", steps=25, global_batch=8, seq_len=32, d_model=64,
        layers=2, lr=5e-3, vocab_size=128), device="cuda")
    first = float(np.mean([h["loss"] for h in hist[:5]]))
    last = float(np.mean([h["loss"] for h in hist[-5:]]))
    descent_launches = dict(fa.ROUTE_LAUNCHES)
    require(last < first and descent_launches == {
        "wgmma_bf16": 0, "fma_fp32": 25 * 2 * 2},
        f"reduced gemma_2b: first-5 mean {first}, last-5 {last}, launches "
        f"{descent_launches}")
    print(f"  [{since():.1f} s] reduced gemma_2b through train() on the "
          f"card, 25 steps: mean loss of the first 5 {first:.4f}, of the "
          f"last 5 {last:.4f}; launches {descent_launches} (2 layers, "
          f"forward and remat)", flush=True)
    with tempfile.TemporaryDirectory() as ckpt:
        fault = FaultInjector(fail_at_steps=[13])
        kernels.reset_launch_counts()
        _, hist = TT.train(TT.TrainRunConfig(
            arch="qwen3_8b", steps=24, global_batch=4, seq_len=32,
            d_model=64, layers=2, vocab_size=128, ckpt_dir=ckpt,
            ckpt_every=6), fault=fault, device="cuda")
        seen = [h["step"] for h in hist]
        fault_launches = fa.ROUTE_LAUNCHES["fma_fp32"]
        require(13 in fault.fired and seen.count(12) == 2 and seen[-1] == 23
                and fault_launches == len(seen) * 2 * 2,
                f"fault recovery: steps {seen}, launches {fault_launches}")
    print(f"  [{since():.1f} s] fault injected at step 13 of 24, recovered "
          f"from the step-12 checkpoint in a temporary directory: "
          f"{len(seen)} steps run, last loss {hist[-1]['loss']:.4f}, "
          f"{fault_launches} fma_fp32 launches", flush=True)

    # qwen3_8b at full width and depth through train()
    data_s = time.perf_counter()
    SyntheticLMData(cfg.vocab_size, TRAIN_SEQ).batch(0, 1)
    data_s = time.perf_counter() - data_s
    run = TT.TrainRunConfig(arch=TRAIN_ARCH, use_reduced=False,
                            steps=TRAIN_STEPS, global_batch=1,
                            seq_len=TRAIN_SEQ, optimizer="adafactor")
    shape = ShapeConfig(f"train_{TRAIN_SEQ // 1024}k", TRAIN_SEQ, 1, "train")
    flops = (roofline.model_flops(cfg, shape)
             + roofline.attention_flops(cfg, shape))
    bound_s = flops / roofline.PEAK_FLOPS_BF16
    times: list = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist = TT.train(run, on_metrics=event_steps(torch, times),
                           device="cuda")
    run_s = time.perf_counter() - t0
    full_peak = torch.cuda.max_memory_allocated()
    full_launches = dict(fa.ROUTE_LAUNCHES)
    others = {k: n for k, n in kernels.launch_counts().items()
              if n and k != "flash_attention"}
    per_step = [b[2] - a[2] for a, b in zip(times, times[1:])]
    L = cfg.num_layers
    secs = step_times(times)
    step_s = sorted(secs[-3:])[1]
    require(len(times) == TRAIN_STEPS and full_launches == {
        "wgmma_bf16": TRAIN_STEPS * 2 * L, "fma_fp32": 0} and not others
        and per_step == [2 * L] * (TRAIN_STEPS - 1),
        f"{TRAIN_ARCH} full-width training: {len(times)} steps, launches "
        f"{full_launches}, per step {per_step}, others {others}")
    # where a step's time goes: one more step on the trained state
    model = state["params"]
    step_fn = make_train_step(cfg, TT.build(run)[1])
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLMData(
        cfg.vocab_size, TRAIN_SEQ).batch(TRAIN_STEPS, 1).items()}
    busy, idle, top, launches = profile_run(
        torch, lambda: step_fn(state, batch), step_s, top=8)
    bwd_share = L * grad_cells[TRAIN_ARCH]["bwd_ms"] / 1e3 / busy
    opt_s = optimizer_update_s(torch, TT.build(run)[1], state)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  [{since():.1f} s] {TRAIN_ARCH} at full width and depth "
          f"through train() ({L} layers, {n_params} parameters, "
          f"{cfg.dtype}, Adafactor, remat), B=1 S={TRAIN_SEQ}: losses "
          f"{[round(t[3], 4) for t in times]}, grad_norm "
          f"{[round(t[4], 4) for t in times]}; step times (events, from the "
          f"end of one step to the end of the next, the host's batch "
          f"included: {data_s * 1e3:.1f} ms) {[round(x, 4) for x in secs]} "
          f"s, median of steps 2-4 {step_s:.4f} s; bound {bound_s:.4f} s "
          f"({flops:.4g} flop: model_flops + attention_flops over "
          f"{roofline.PEAK_FLOPS_BF16:.4g} flop/s), {bound_s / step_s:.2%} "
          f"of it; peak memory {full_peak} bytes; flash launches "
          f"{per_step[0]} a step ({full_launches} in {TRAIN_STEPS} steps); "
          f"{run_s:.1f} s for the run with init; profiled step: device busy "
          f"{busy * 1e3:.1f} ms, idle share {idle:.1%}, {launches} kernel "
          f"launches; attention backward {L} x "
          f"{grad_cells[TRAIN_ARCH]['bwd_ms']:.2f} ms = {bwd_share:.1%} of "
          f"device busy; the Adafactor update alone {opt_s:.4f} s "
          f"({opt_s / step_s:.1%} of the step); top kernels:\n{top}",
          flush=True)
    del state, model, batch, step_fn
    torch.cuda.empty_cache()

    # AdamW at full width, depth cut to ADAMW_LAYERS
    cfg8 = dataclasses.replace(cfg, num_layers=ADAMW_LAYERS)
    opt = AdamW(learning_rate=cosine_warmup(3e-3, 10, 50), keep_master=False)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    state = init_train_state(cfg8, opt, 0, device="cuda")
    step_fn = make_train_step(cfg8, opt)
    data = SyntheticLMData(cfg8.vocab_size, TRAIN_SEQ)
    adamw_times, adamw_losses = [], []
    for step in range(ADAMW_STEPS):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch(step, 1).items()}
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step_fn(state, batch)
        stop.record()
        stop.synchronize()
        adamw_times.append(start.elapsed_time(stop) / 1e3)
        adamw_losses.append((float(metrics["loss"]),
                             float(metrics["grad_norm"])))
    adamw_peak = torch.cuda.max_memory_allocated()
    adamw_launches = dict(fa.ROUTE_LAUNCHES)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in (*state["opt"]["mu"].values(),
                                *state["opt"]["nu"].values()))
    adamw_params = sum(p.numel() for p in state["params"].parameters())
    adamw_s = sorted(adamw_times[1:])[len(adamw_times[1:]) // 2]
    adamw_opt_s = optimizer_update_s(torch, opt, state)
    require(all(math.isfinite(a) and math.isfinite(b)
                for a, b in adamw_losses)
            and adamw_launches == {"wgmma_bf16": ADAMW_STEPS * 2
                                   * ADAMW_LAYERS, "fma_fp32": 0},
            f"AdamW {ADAMW_LAYERS} layers: {adamw_losses}, launches "
            f"{adamw_launches}")
    bound8 = (roofline.model_flops(cfg8, shape)
              + roofline.attention_flops(cfg8, shape)) \
        / roofline.PEAK_FLOPS_BF16
    print(f"  [{since():.1f} s] AdamW at full width, {ADAMW_LAYERS} of "
          f"{L} layers ({adamw_params} parameters, moments {state_bytes} "
          f"bytes), B=1 S={TRAIN_SEQ}: (loss, grad_norm) "
          f"{[(round(a, 4), round(b, 4)) for a, b in adamw_losses]}; step "
          f"times (events) {[round(x, 4) for x in adamw_times]} s, median "
          f"of steps 2-{ADAMW_STEPS} {adamw_s:.4f} s (bound {bound8:.4f} s), "
          f"the AdamW update alone {adamw_opt_s:.4f} s; "
          f"peak memory {adamw_peak} bytes; launches {adamw_launches}",
          flush=True)
    del state, step_fn, batch
    torch.cuda.empty_cache()

    # the launcher's main
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        TT.main(["--arch", "gemma_2b", "--steps", "5", "--global-batch", "2",
                 "--seq-len", "32", "--d-model", "64", "--layers", "2",
                 "--device", "cuda"])
    line = (text.getvalue().splitlines() or [""])[0]
    require(re.fullmatch(r"first loss [0-9.]+ -> final [0-9.]+ in [0-9.]+s "
                         r"on cuda:0", line), f"train main: {line!r}")
    print(f"  [{since():.1f} s] launch.train main --device cuda: {line!r}",
          flush=True)
    out = dict(grad_cells=grad_cells, card_cpu=card_cpu, step_s=step_s,
               step_times=secs, bound_s=bound_s, full_peak=full_peak,
               per_step=per_step[0], busy=busy, idle=idle,
               bwd_share=bwd_share, opt_s=opt_s, adamw_s=adamw_s,
               adamw_opt_s=adamw_opt_s, adamw_peak=adamw_peak,
               bf16_launches=full_launches["wgmma_bf16"]
               + adamw_launches["wgmma_bf16"],
               fp32_launches=descent_launches["fma_fp32"] + fault_launches,
               phase_s=time.perf_counter() - t_phase)
    print(f"phase 3k: {out['phase_s']:.1f} s in all ({smi_line()})",
          flush=True)
    return out


def local_shard_main(out_path: str) -> None:
    """Phase 3l's subprocess (``chip_smoke.py --local-shard OUT``), on its
    own so that its fake group meets no other: on rank 0 of a fake 16×16
    group, the flash kernel under ``local_map`` against its plain version,
    then ``SHARD_ARCH`` at full width and depth, ``SHARD_SHAPE``'s local
    shard for real (``launch.dryrun.run_local_shard``). Writes a JSON
    object to OUT."""
    import torch

    sys.path.insert(0, str(SRC))
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    from repro_torch import configs
    from repro_torch.models import SHAPES
    from repro_torch.models.layers import AttentionCore
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.profiler import ProfilerActivity, profile

    stages = {"import": time.perf_counter() - T_IMPORT}
    t0 = time.perf_counter()
    _build.build()
    stages["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = configs.get(SHARD_ARCH)
    shape = SHAPES[SHARD_SHAPE]
    gen = torch.Generator(device="cuda").manual_seed(31)
    # the kernel under local_map: each rank's 2 query heads and the kv head
    # they read, against the plain version on the same local tensors
    with fake_group(256):
        mesh = make_production_mesh(device="cuda")
        b_loc = shape.global_batch // mesh.size(0)
        h_loc = cfg.num_heads // mesh.size(1)

        def rand(*dims):
            return torch.randn(dims, generator=gen, device="cuda",
                               dtype=torch.bfloat16)

        ql = rand(b_loc, shape.seq_len, h_loc, cfg.head_dim)
        kl = rand(b_loc, shape.seq_len, cfg.num_kv_heads, cfg.head_dim)
        vl = rand(b_loc, shape.seq_len, cfg.num_kv_heads, cfg.head_dim)
        q = DTensor.from_local(ql, mesh, [Shard(0), Shard(2)],
                               run_check=False)
        k = DTensor.from_local(kl, mesh, [Shard(0), Replicate()],
                               run_check=False)
        v = DTensor.from_local(vl, mesh, [Shard(0), Replicate()],
                               run_check=False)
        fa.reset_launch_counts()
        with SH.use_rules(mesh), torch.no_grad():
            out = AttentionCore(0)(q, k, v)
        torch.cuda.synchronize()
        core_launches = dict(fa.ROUTE_LAUNCHES)
        g = cfg.num_heads // cfg.num_kv_heads
        kv = slice(0, max(1, h_loc // g))    # rank 0's heads read kv 0
        want = ref.causal_attention(ql, kl[:, :, kv], vl[:, :, kv], 0)
        got = out.to_local()
        err = float((got.float() - want.float()).abs().max())
        tol = attn_tol(vl, "bfloat16")
        close = bool(torch.allclose(got.float(), want.float(), **tol))
        mean_err = float((got.float() - want.float()).abs().mean())
        del q, k, v, ql, kl, vl, out, want, got
    torch.cuda.empty_cache()
    stages["local_map check"] = time.perf_counter() - t0

    # the local shard: SHARD_STEPS train steps, the last one profiled
    prof = profile(activities=[ProfilerActivity.CUDA])
    launches = []

    def on_step(i):
        launches.append(sum(fa.ROUTE_LAUNCHES.values()))
        if i == SHARD_STEPS - 2:
            prof.start()
        elif i == SHARD_STEPS - 1:
            torch.cuda.synchronize()
            prof.stop()

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    res = DR.run_local_shard(cfg, shape, steps=SHARD_STEPS,
                             optimizer=DR.make_optimizer(SHARD_ARCH),
                             device="cuda", on_step=on_step)
    run_s = time.perf_counter() - t0
    from torch.autograd import DeviceType

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    top = [(e.key[:80], e.self_device_time_total / 1e3, e.count)
           for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]]
    with open(out_path, "w") as f:
        json.dump({"core": {"max_abs_err": err, "mean_abs_err": mean_err,
                            "close": close, "launches": core_launches,
                            "local_heads": h_loc, "local_batch": b_loc,
                            "seq": shape.seq_len},
                   "step_s": res["step_s"], "peak_bytes": res["peak_bytes"],
                   "local_batch": res["local_batch"], "launches": launches,
                   "routes": dict(fa.ROUTE_LAUNCHES), "busy_s": busy,
                   "kernel_launches": sum(e.count for e in kern),
                   "top": top, "run_s": run_s, "stages": stages}, f)


def phase_dryrun() -> dict:
    """Phase 3l: production sharding and the dry run, in subprocesses: the
    local shard on the card (``local_shard_main``) alone, so that no other
    process loads the host while its steps are timed; then the
    DRYRUN_CELLS through ``python -m repro_torch.launch.dryrun`` (fake
    16×16 group, fake CUDA tensors; host work only), one process each,
    side by side."""
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            shard = _local_shard(tmp, env)
            for arch, shape_name, opt in DRYRUN_CELLS:
                log = open(Path(tmp) / f"{arch}__{shape_name}.log", "w+")
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_name, "--mesh",
                       "single", "--device", "cuda", "--tag", "smoke"] \
                    + (["--opt"] if opt else [])
                procs.append(((arch, shape_name), log, subprocess.Popen(
                    cmd, env=env, stdout=log, stderr=subprocess.STDOUT)))
            return _dryrun_results(shard, procs, t_phase)
        finally:
            for _, log, p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
                log.close()


def _local_shard(tmp: str, env: dict) -> dict:
    """Phase 3l's local shard, in its own process with no other running:
    printed, checked, returned."""
    out = Path(tmp) / "shard.json"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--local-shard", str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    shard_s = time.perf_counter() - t0
    require(proc.returncode == 0 and out.exists(),
            f"local shard: exit {proc.returncode}\n"
            f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    shard = json.loads(out.read_text())
    core = shard["core"]
    require(core["close"] and core["mean_abs_err"] <= ATTN_BF16_MEAN
            and core["launches"] == {"wgmma_bf16": 1, "fma_fp32": 0},
            f"flash under local_map: {core}")
    print(f"phase 3l: flash kernel under local_map on rank 0 of a fake "
          f"16x16 group ({core['local_heads']} local query heads of "
          f"{SHARD_ARCH}, the kv head they read, local batch "
          f"{core['local_batch']}, S={core['seq']}, bf16) against "
          f"the plain version on the same local q, k, v: max |err| "
          f"{core['max_abs_err']:.3g}, mean {core['mean_abs_err']:.3g}; "
          f"launches {core['launches']}", flush=True)

    from repro_torch import configs

    per_step = [b - a for a, b in zip([0] + shard["launches"],
                                      shard["launches"])]
    layers = configs.get(SHARD_ARCH).num_layers
    steps = shard["step_s"]
    step_s = sorted(steps[1:-1])[len(steps[1:-1]) // 2]
    idle = max(0.0, 1 - shard["busy_s"] / step_s)
    top = "\n".join(f"    {ms:9.3f} ms {n:6d}x {key}"
                     for key, ms, n in shard["top"])
    print(f"  local shard: {SHARD_ARCH} {SHARD_SHAPE} at full width and "
          f"depth, rank 0 of a fake 16x16 group (its collectives are "
          f"no-ops: the time excludes communication, and the loss is not a "
          f"result; no other process ran beside it), local batch "
          f"{shard['local_batch']}, bf16, "
          f"remat, AdamW keep_master: step times (events) "
          f"{[round(x, 4) for x in steps]} s, median of steps 2-"
          f"{SHARD_STEPS - 1} {step_s:.4f} s; peak memory "
          f"{shard['peak_bytes']} bytes; flash launches {per_step} by step "
          f"({shard['routes']}); profiled last step: device busy "
          f"{shard['busy_s'] * 1e3:.1f} ms, idle share {idle:.1%}, "
          f"{shard['kernel_launches']} kernel launches; "
          f"{shard['run_s']:.1f} s with init (before it: "
          f"{ {k: round(v, 1) for k, v in shard['stages'].items()} } s); "
          f"subprocess {shard_s:.1f} s; top kernels:\n{top}",
          flush=True)
    require(per_step == [2 * layers] * SHARD_STEPS
            and shard["routes"]["fma_fp32"] == 0,
            f"local shard launches {shard['launches']}, {shard['routes']}")

    return dict(shard, step_s_median=step_s, idle=idle)


def _dryrun_results(shard: dict, procs: list, t_phase: float) -> dict:
    """Phase 3l's dry-run cells ``procs``: their results, printed and
    checked beside the local shard's."""
    failed, cells = [], {}
    for (arch, shape_name), log, p in procs:
        p.wait(timeout=900)
        if p.returncode != 0:
            log.seek(0)
            failed.append(f"dry run {arch} {shape_name}: exit "
                          f"{p.returncode}\n{log.read()[-3000:]}")
            continue
        r = json.loads((SRC.parent / "experiments" / "dryrun_torch" / (
            f"{arch}__{shape_name}__16x16__smoke.json")).read_text())
        cells[(arch, shape_name)] = r
        roof, st = r["roofline"], r["hlo_stats"]
        links = {k: f"{v:.4g}" for k, v in st["collective_bytes"].items()}
        print(f"  dry run {arch} {shape_name} 16x16"
              f"{' (--opt)' if arch == 'deepseek_v3' else ''}: per device "
              f"{st['flops']:.4g} flop, {st['bytes_proxy']:.4g} bytes "
              f"(proxy), collective payload bytes {links} in "
              f"{st['collective_ops']} ops, {st['collective_link_bytes']:.4g} "
              f"link bytes; memory estimate "
              f"{r['memory_analysis']['Total']} bytes "
              f"({roof['per_device_memory_gb']:.2f} GiB); terms compute "
              f"{roof['compute_s']:.4f} s, memory {roof['memory_s']:.4f} s, "
              f"collective {roof['collective_s']:.4f} s; bottleneck "
              f"{roof['bottleneck']}; useful_ratio "
              f"{roof['useful_ratio']:.4f}; traced in {r['trace_s']} s "
              f"({time.perf_counter() - t_phase:.1f} s into the phase)",
              flush=True)
    require(not failed, "\n".join(failed))
    qwen = cells[("qwen3_8b", "train_4k")]
    lo, hi = USEFUL_RANGE
    require(lo < qwen["roofline"]["useful_ratio"] <= hi,
            f"qwen3_8b train_4k useful_ratio "
            f"{qwen['roofline']['useful_ratio']}")
    estimate = qwen["memory_analysis"]["Total"]
    out = dict(local_launches=shard["routes"]["wgmma_bf16"],
               step_s=shard["step_s_median"], peak=shard["peak_bytes"],
               estimate=estimate, idle=shard["idle"],
               useful=qwen["roofline"]["useful_ratio"], cells=cells,
               phase_s=time.perf_counter() - t_phase)
    print(f"  local shard peak memory {shard['peak_bytes']} bytes against "
          f"the dry run's estimate for the same cell {estimate} bytes "
          f"({shard['peak_bytes'] / estimate:.3f}x)", flush=True)
    print(f"phase 3l: {out['phase_s']:.1f} s in all ({smi_line()})",
          flush=True)
    return out


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit(f"no port sources under {SRC}: run chip_smoke.py "
                         "from the root of a checkout")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: chip_smoke.py "
                         "needs an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch import engine as TE
    from repro_torch.core import graph as TG
    from repro_torch.core import sketches
    from repro_torch import kernels
    from repro_torch.engine import setexpr
    from repro_torch.kernels import _build, ref

    t_start = time.perf_counter()
    smi = smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"phase 1: torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; kernels built in "
          f"{build_s:.2f} s: {', '.join(p.name for p in libs.values())}",
          flush=True)
    for name in libs:
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            entries = ptxas_kernels(log.read_text())
            if entries:
                regs = [e["registers"] for e in entries]
                spilled = [e for e in entries if e["spill_stores"]]
                print(f"  {name}: {len(entries)} kernels, {min(regs)}-"
                      f"{max(regs)} registers, "
                      f"{sum(e['spill_stores'] for e in entries)} bytes of "
                      f"spill stores in all (ptxas)"
                      + "".join(f"; {e['spill_stores']} B in {e['kernel']}"
                                for e in spilled), flush=True)

    flush = make_flush(torch)
    timing = phase_kernels(torch, setexpr, kernels.fused_expr, ref, flush)
    timing.update(phase_minhash_kernels(torch, kernels.mh_intersect, ref,
                                        flush))
    attn, attn_launches, fp32_launches = phase_attention(
        torch, kernels.flash_attention, ref, flush,
        libs["flash_attention_wgmma"], libs["flash_attention"])
    timing["flash_attention_wgmma"] = attn["qwen3_8b"]
    timing["flash_attention"] = attn["fp32"]
    del flush
    torch.cuda.empty_cache()
    g, sess, main_path = phase_main(torch, np, TE, TG, kernels, SCALE)
    mh_path, mh_sessions = phase_minhash(torch, np, TE, kernels, g,
                                         main_path["chunks"])
    timing.update(phase_real_chunks(torch, kernels, g, sess,
                                    mh_sessions["kh"]))
    clq = phase_cliques(torch, np, TE, TG, kernels, g, sess)
    timing.update(clq["timing"])
    t_3e = time.perf_counter()
    sx, xp = phase_exact(torch, np, TE, kernels, g, {
        "bf": main_path["tc"],
        **{label: r["tc"] for label, r in mh_path.items()}})
    lc = phase_local_cluster(torch, np, kernels, g, sess, sx)
    timing.update(phase_degree_batch(torch, np, kernels, g, sess, sx))
    print(f"phase 3e: {time.perf_counter() - t_3e:.1f} s in all", flush=True)
    phase_breakdown(torch, TE, sketches, g, sess, main_path["warm_pass_s"],
                    main_path["build_s"], mh_sessions, mh_path,
                    clq["four"]["s"], sx, xp["pass_s"], lc)
    del sess, mh_sessions, sx
    torch.cuda.empty_cache()
    stream = phase_stream(torch, np, kernels, g)
    t_3g = time.perf_counter()
    adaptive = phase_adaptive(torch, np, kernels, g, main_path["tc"],
                              xp["tc"])
    lp = phase_linkpred(torch, np, TG, kernels, g)
    dd = phase_dedup(torch, np)
    print(f"phase 3g: {time.perf_counter() - t_3g:.1f} s in all", flush=True)
    sharded = phase_sharded(torch, TE, kernels, g)
    del g
    torch.cuda.empty_cache()
    timing.update(phase_fused_pass(torch, TE, kernels))
    model = phase_model(torch, np, kernels, ref)
    timing["flash_attention_wgmma"]["model_ms"] = model["attn_ms"]
    archs = phase_archs(torch, np, kernels, ref)
    training = phase_train(torch, np, kernels, ref)
    dry = phase_dryrun()
    g12, exact = phase_reference(torch, np, TE, TG, sketches)
    phase_reference_exact(torch, np, TE, g12, exact)
    phase_reference_minhash(torch, np, TE, g12, exact)
    phase_reference_cliques(torch, np, TE, g12)

    print(f"main path: scale {SCALE} n={main_path['n']} "
          f"m={main_path['m']} words={main_path['words']} "
          f"build {main_path['build_s']:.3f} s pass {main_path['pass_s']:.3f} s "
          f"gather launches {main_path['launches']['fused_gather_popcount']}; "
          + "; ".join(f"{label}: k={r['k']} build {r['build_s']:.3f} s pass "
                      f"{r['pass_s']:.3f} s launches {r['forms']}"
                      for label, r in mh_path.items())
          + f"; 4-cliques pass {clq['four']['s']:.3f} s AND3 launches "
          f"{clq['and3']}; 5-cliques (scale {CLIQUE5_SCALE}) pass "
          f"{clq['five']['s']:.3f} s AND4 launches {clq['and4']}; "
          f"flash_attention launches: {attn_launches} wgmma_bf16 (prefill), "
          f"{fp32_launches} fma_fp32 (float32 path); exact per-edge pass "
          f"{xp['pass_s']:.3f} s, TC {xp['tc']} (Bloom rel err "
          f"{xp['rel_err']['bf']:+.6f}); local_cluster ({LC_SEEDS} seeds) Bloom "
          f"{lc['bf']['pass_s']:.3f} s, "
          f"{lc['bf']['launches']['fused_rows_popcount']} dense AND2 "
          f"launches, exact {lc['exact']['pass_s']:.3f} s; stream "
          f"(phase 3f) {STREAM_BATCHES} Bloom batches, apply_delta "
          f"{[round(r['delta_s'], 3) for r in stream['rows']]} s, flush "
          f"{[round(r['flush_s'], 3) for r in stream['rows']]} s, "
          f"launches {stream['launches']}, peak {stream['peak']} bytes, "
          f"{stream['phase_s']:.1f} s, checkpoint "
          f"{stream['checkpoint']['bytes']} bytes saved in "
          f"{stream['checkpoint']['save_s']:.2f} s, restored in "
          f"{stream['checkpoint']['restore_s']:.2f} s; adaptive Bloom "
          f"(phase 3g) TC {adaptive['tc']:.9g} ({adaptive['rel']:+.6f} vs "
          f"exact; fixed {adaptive['rel_fixed']:+.6f}) pass "
          f"{adaptive['pass_s']:.3f} s, {adaptive['launches']} rows/and2 "
          f"launches; link prediction ef {lp['ef']} (scale "
          f"{LINKPRED_SMALL_SCALE} bf {lp['ef16']:.6f}); dedup "
          f"{dd['docs']} docs {dd['dedup_s']:.2f} s, {dd['planted']} of "
          f"{DEDUP_DUPS} planted dropped; sharded (phase 3h, world size 1) "
          f"mine() words {sharded['mine']['words']} build "
          f"{sharded['mine']['build_s']:.3f} s mine "
          f"{sharded['mine']['mine_s']:.3f} s, {sharded['mine_launches']} + "
          f"{sharded['fold_launches']} gather/and2 launches (mine, sharded "
          f"fold), {sharded['phase_s']:.1f} s; {MODEL_ARCH} (phase 3i) "
          f"prefill S={PREFILL_SEQ} {model['prefill_s']:.4f} s (bound "
          f"{model['bound_s']:.4f} s), {model['bf16_launches']} wgmma_bf16 "
          f"+ {model['fp32_launches']} fma_fp32 launches, decode "
          f"{model['step_ms']:.3f} ms a step (bound "
          f"{model['step_bound_ms']:.3f} ms), peak {model['phase_peak']} "
          f"bytes, {model['phase_s']:.1f} s; phase 3j "
          + ", ".join(f"{arch} ({a['layers']} of {a['of']} layers) prefill "
                      f"S={ARCH_SEQ} {a['prefill_s']:.4f} s (bound "
                      f"{a['bound_s']:.4f} s), {a['launches']['wgmma_bf16']} "
                      f"wgmma_bf16" for arch, a in archs["archs"].items())
          + f", {archs['phase_s']:.1f} s; phase 3k {TRAIN_ARCH} train step "
          f"S={TRAIN_SEQ} {training['step_s']:.4f} s (bound "
          f"{training['bound_s']:.4f} s), {training['per_step']} wgmma_bf16 "
          f"launches a step, peak {training['full_peak']} bytes; AdamW "
          f"{ADAMW_LAYERS} layers {training['adamw_s']:.4f} s, peak "
          f"{training['adamw_peak']} bytes; {training['phase_s']:.1f} s"
          + f"; phase 3l {SHARD_ARCH} local shard step "
          f"{dry['step_s']:.4f} s, peak {dry['peak']} bytes (estimate "
          f"{dry['estimate']}), useful_ratio {dry['useful']:.4f}, "
          f"{dry['phase_s']:.1f} s"
          + f"; total {time.perf_counter() - t_start:.1f} s", flush=True)

    # each row: the kernel's launches on the paths that run it, each path
    # counted from zero (row 1: the Bloom TC, 4-clique and 5-clique paths;
    # rows 2-3 and ``[sweep]``: the 8-seed Bloom local_cluster of phase
    # 3e, whose sweep launches the dense AND2; rows 4-6 and the AND4
    # entry: their form's launches on those paths);
    # rows 1-5 are timed at a TC pass chunk, row 6 and the AND4 entry at
    # the first launch of their clique pass (``timed_at``), which runs the
    # segmented kernel (``kernel``; ``gather_ms`` and ``bound_ms_tuples``
    # are the [T, k] kernel's time and its input's bound there). The
    # MinHash rows ``*_pairs`` are the rows forms (mh: no mined path runs
    # it, the TC passes read rows by id; khash: the k-Hash 4-clique pass,
    # timed on its first launch under ``clique_*``), the ``*_gather`` rows
    # the forms the TC passes launch (``old_route_ms``: row copies, then
    # the rows kernel, on the same pairs); the ``[... chunk]`` rows are the
    # AND2 gather on two real chunks of the Bloom TC pass (phase 3d: ``ms``
    # with L2 flushed, ``warm_ms`` without, ``khash_gather_*`` the k-Hash
    # gather on the same pairs), with the Bloom TC path's AND2 launches;
    # ``[sweep]`` is the dense AND2 on the operands of the degree-chosen
    # 128-seed batch's sweep (phase 3e, flushed and ``warm_ms``;
    # ``real_rows`` of its rows are real sweep steps)
    fused_src = "src/repro_torch/kernels/csrc/fused_expr.cu"
    mh_src = "src/repro_torch/kernels/csrc/mh_intersect.cu"
    mh_forms = {label: r["forms"] for label, r in mh_path.items()}
    kh_clique = clq["kh"]["forms"]["khash_match_pairs/rows"]
    kh_launch = timing.pop("khash_match_pairs[clique]")
    timing["khash_match_pairs"].update(
        clique_launches=kh_clique, clique_ms=kh_launch["ms"],
        clique_plain_ms=kh_launch["plain_ms"],
        clique_bound_ms=kh_launch["bound_ms"],
        clique_bound_by=kh_launch["bound_by"],
        clique_timed_at=kh_launch["timed_at"])
    gather = (main_path["launches"]["fused_gather_popcount"]
              + clq["four"]["launches"]["fused_gather_popcount"]
              + clq["five"]["launches"]["fused_gather_popcount"])
    # the stream path's launches (phase 3f), counted into the rows of the
    # kernels and forms it runs and also reported on their own
    sl = stream["launches"]
    stream_rows = {"fused_gather_popcount": sl["fused_gather_popcount"],
                   "fused_rows_popcount": sl["fused_rows_popcount"],
                   "bf_intersect_pairs": sl["rows/and2"],
                   "bf_edge_intersect": sl["gather/and2"],
                   "fused_gather_cardinality": sl["gather/and2/card"],
                   "khash_match_gather": sl["khash_match_pairs/gather"]}
    rows = [
        ("fused_gather_popcount", fused_src,
         "src/repro/kernels/fused_expr.py:79", gather),
        ("fused_rows_popcount", fused_src,
         "src/repro/kernels/fused_expr.py:129",
         lc["bf"]["launches"]["fused_rows_popcount"]),
        ("bf_intersect_pairs", fused_src,
         "src/repro/kernels/bf_intersect.py:66",
         lc["bf"]["forms"].get("rows/and2", 0)),
        ("bf_intersect3_pairs", fused_src,
         "src/repro/kernels/bf_intersect.py:98",
         lc["bf"]["forms"].get("rows/and3", 0)),
        ("bf_edge_intersect", fused_src,
         "src/repro/kernels/bf_intersect.py:168",
         main_path["forms"].get("gather/and2", 0)),
        ("bf_edge_intersect3", fused_src,
         "src/repro/kernels/bf_intersect.py:219", clq["and3"]),
        ("mh_intersect_pairs", mh_src, "src/repro/kernels/mh_intersect.py:26",
         mh_forms["1h-naive"].get("mh_intersect_pairs/rows", 0)),
        ("khash_match_pairs", mh_src, "src/repro/kernels/mh_intersect.py:53",
         mh_forms["kh"].get("khash_match_pairs/rows", 0) + kh_clique),
        ("mh_intersect_gather", mh_src,
         "src/repro/kernels/mh_intersect.py:26",
         mh_forms["1h-naive"]["mh_intersect_pairs/gather"]),
        ("khash_match_gather", mh_src,
         "src/repro/kernels/mh_intersect.py:53",
         mh_forms["kh"]["khash_match_pairs/gather"]),
        ("flash_attention_wgmma",
         "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
         "src/repro/kernels/flash_attention.py:73", attn_launches),
        ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:73", fp32_launches),
        ("fused_gather_popcount[AND4]", fused_src,
         "src/repro/kernels/fused_expr.py:79", clq["and4"]),
        ("fused_gather_popcount[hub chunk]", fused_src,
         "src/repro/kernels/fused_expr.py:79",
         main_path["forms"].get("gather/and2", 0)),
        ("fused_gather_popcount[median chunk]", fused_src,
         "src/repro/kernels/fused_expr.py:79",
         main_path["forms"].get("gather/and2", 0)),
        ("fused_rows_popcount[sweep]", fused_src,
         "src/repro/kernels/fused_expr.py:129",
         lc["bf"]["forms"].get("rows/and2", 0)),
        ("fused_gather_cardinality", fused_src,
         "src/repro/kernels/bf_intersect.py:168",
         main_path["forms"].get("gather/and2/card", 0)),
    ]
    # phase 3g: the adaptive pass's dense AND2 launches and link
    # prediction's (scale 21, Bloom and k-Hash scorers; scale 16, Bloom)
    lpl = lp["launches"]
    adaptive_rows = {"fused_rows_popcount": adaptive["launches"],
                     "bf_intersect_pairs": adaptive["launches"]}
    lp_gather = (lpl["bf"].get("gather/and2", 0)
                 + lp["launches16"].get("gather/and2", 0))
    lp_card = (lpl["bf"].get("gather/and2/card", 0)
               + lp["launches16"].get("gather/and2/card", 0))
    linkpred_rows = {"fused_gather_popcount": lp_gather + lp_card,
                     "bf_edge_intersect": lp_gather,
                     "fused_gather_cardinality": lp_card,
                     "khash_match_gather": lpl["kh"].get(
                         "khash_match_pairs/gather", 0)}
    # phase 3h: mine() and the sharded fold at world size 1 (AND2 gather)
    sharded_rows = {"fused_gather_popcount": sharded["launches"],
                    "bf_edge_intersect": sharded["launches"]}
    # phases 3i and 3j: the full-width forwards (bf16: qwen3_8b, then the
    # four prefills of 3j) and the float32 route's forward; the hooked
    # forwards that hold each layer to the plain version, and 3j's MLA
    # checks, are not counted
    model_rows = {"flash_attention_wgmma": model["bf16_launches"]
                  + archs["bf16_launches"],
                  "flash_attention": model["fp32_launches"]}
    # phase 3k: the training runs (bf16: qwen3_8b through train() and the
    # AdamW steps; float32: the reduced descent and fault-recovery runs);
    # the gradient cells and the card-vs-CPU steps compare and do not count
    train_rows = {"flash_attention_wgmma": training["bf16_launches"],
                  "flash_attention": training["fp32_launches"]}
    # phase 3l: the local shard's train steps (bf16); the kernel-vs-plain
    # launch under local_map compares and does not count
    dryrun_rows = {"flash_attention_wgmma": dry["local_launches"]}
    cell = training["grad_cells"][TRAIN_ARCH]
    timing["flash_attention_wgmma"].update(
        train_fwd_bwd_ms=cell["ms"], train_bwd_ms=cell["bwd_ms"],
        train_plain_fwd_bwd_ms=cell["plain_ms"],
        train_library_fwd_bwd_ms=cell["library_ms"],
        train_bound_ms=cell["bound_ms"], train_timed_at=(
            f"{TRAIN_ARCH} layer, B=1 S={TRAIN_SEQ}, forward + backward"))
    rows = [(name, source, replaces, launches + stream_rows.get(name, 0)
             + adaptive_rows.get(name, 0) + linkpred_rows.get(name, 0)
             + sharded_rows.get(name, 0) + model_rows.get(name, 0)
             + train_rows.get(name, 0) + dryrun_rows.get(name, 0))
            for name, source, replaces, launches in rows]
    records = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        **({"stream_launches": stream_rows[name]} if name in stream_rows
           else {}),
        **({"adaptive_launches": adaptive_rows[name]}
           if name in adaptive_rows else {}),
        **({"linkpred_launches": linkpred_rows[name]}
           if name in linkpred_rows else {}),
        **({"sharded_launches": sharded_rows[name]}
           if name in sharded_rows else {}),
        **({"model_launches": model_rows[name]}
           if name in model_rows else {}),
        **({"train_launches": train_rows[name]}
           if name in train_rows else {}),
        **({"dryrun_launches": dryrun_rows[name]}
           if name in dryrun_rows else {}),
        "max_abs_err": timing[name]["max_abs_err"],
        "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "share": timing[name]["bound_ms"] / timing[name]["ms"],
        "library_ms": timing[name].get("library_ms"),
        "library_note": timing[name].get("library_note"),
        "timed_at": timing[name]["timed_at"],
        **{key: value for key, value in timing[name].items()
           if key in ("kernel", "gather_ms", "bound_ms_tuples", "model_ms",
                      "old_route_ms", "warm_ms", "real_rows", "deep_ms",
                      "deep_warm_ms", "deep_real_rows", "khash_gather_ms",
                      "khash_gather_warm_ms", "pass_s", "pass_kernel_ms",
                      "pass_launches", "chunked_pass_s",
                      "chunked_kernel_ms", "chunked_launches")
           or key.startswith(("clique_", "train_", "fp32_"))},
    } for name, source, replaces, launches in rows]
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def fused_pass_main() -> None:
    """``--fused-pass``: the kernels' build and phase 3m alone."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: chip_smoke.py "
                         "needs an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch import engine as TE
    from repro_torch import kernels
    from repro_torch.kernels import _build

    print(smi_line(), flush=True)
    _build.build(["fused_expr"])
    record = phase_fused_pass(torch, TE, kernels)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--local-shard":
        local_shard_main(sys.argv[2])
        raise SystemExit(0)
    if sys.argv[1:] == ["--fused-pass"]:
        fused_pass_main()
        raise SystemExit(0)
    main()
