#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a).

Drives the port's main path — the paper's Algorithm 1 on resnet9
(repro_torch.experiment.train_cnn, 4 simulated workers, real wire
payloads of QSGD, TernGrad, signSGD, natural compression, top-k and
random-k) — and holds every hand-written kernel against its plain
PyTorch version on the card. Phases, each failing the run at its first
error:

  1. the card's name and power limit (nvidia-smi); TF32 off
  2. build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc)
  3. each kernel vs its plain version, bitwise, at every resnet9 bucket
     shape stacked over 4 workers, the entire-model shape (4, 121002) and
     a stress shape (4, 1048579): QSGD widths 2/4/6/8, TernGrad, sign,
     bits, and fields at widths 1/4/9/13/16/17/24/31 (k = d) plus each
     shape's top-k index leg (k = 1% of d, ceil(log2 d) bits); the
     majority vote of n in {1, 2, 3, 4, 5, 8} workers over each shape's
     signSGD words; the grouped QSGD pack (qsgd_pack_buckets) bitwise
     against the per-bucket plain loop on the 11 layerwise buckets in one
     launch, on MAX_BUCKETS + 8 buckets in two, and on units of edge
     dimensions (d = 1, 2, 3, odd d, ceil(d/2) = 32k +- 1, tile edges),
     grouped and one at a time; the grouped field pack / unpack
     (fields_pack_buckets / fields_unpack_buckets) bitwise against the
     per-bucket plain twins at every field width over k at the chunk and
     tile edges, on the 22 mixed-width layerwise legs (natural's and the
     top-k index legs) in one launch, on MAX_BUCKETS + 9 buckets in two,
     and on inputs 4 bytes past a 16-byte boundary; the grouped sign pack
     and QSGD unpack (sign_pack_buckets / qsgd_unpack_buckets) bitwise
     against the per-bucket plain twins on the 11 layerwise buckets in one
     launch, on MAX_BUCKETS + 8 buckets in two, on units of d at the chunk
     and tile edges and on inputs 4 bytes past a 16-byte boundary (sign
     inputs holding -0.0 and NaN; QSGD widths 2/4/6/8, packed and random
     words), grouped and one bucket at a time; the grouped TernGrad pack
     (terngrad_pack_buckets, the hash-once tile walk it shares with the
     QSGD pack) and bit unpack (bits_unpack_buckets) bitwise against the
     per-bucket plain twins on the 11 layerwise buckets in one launch, on
     MAX_BUCKETS + 8 buckets in two, on units of the edge dimensions
     (TernGrad inputs holding -0.0 and NaN; bits on sign and random
     words, and on words 4 bytes past a 16-byte boundary), grouped and one
     bucket at a time; the grouped TernGrad and signSGD unpacks
     (terngrad_unpack_buckets / sign_unpack_buckets, the tile walk of
     csrc/unpack_tile.cuh they share with the QSGD and bit unpacks)
     bitwise against the per-bucket plain twins on packed and random words
     on the same groups and on words 4 bytes past a 16-byte boundary,
     grouped and one bucket at a time; the grouped bit pack
     (bits_pack_buckets, the staged-tile ballot walk of
     csrc/ballot_pack.cuh it shares with the sign pack) and the grouped
     majority vote (majority_buckets) bitwise against the per-bucket
     plain twins on the 11 layerwise buckets in one launch, on
     MAX_BUCKETS + 8 buckets in two, on units of the edge dimensions,
     on votes of n in {1, 2, 3, 4, 5, 8, 9, 17, 255} workers over W at the
     vote's tile edges with every W % 4 (zero columns, exact ties) and
     on inputs 4 bytes past a 16-byte boundary, grouped and one bucket
     at a time; the grouped compress-only quantizers
     (qsgd_compress_buckets at levels 4/7/16/64, terngrad_compress_buckets:
     the pair walks of csrc/compress.cu, 1 and 4 pairs a thread, that draw
     each unit's uniforms themselves over the unit's draw length), each
     walk bitwise against the per-bucket
     plain twins on one worker's 11 layerwise buckets in one launch, on
     MAX_BUCKETS + 8 buckets in two, on units of d at the 1,024-pair tile
     and h = N / 2 edges at both draw granules (512 and 131,072), at the
     entire-model and 2**20-entry widths and on units 4 bytes past a
     16-byte boundary, inputs holding -0.0, a NaN and zero statistics,
     grouped and one bucket at a time
  4. the main path: train_cnn on resnet9 with QSGD(16) layerwise and
     entire_model, TernGrad, signSGD, natural, top-k(1%) and random-k(1%)
     layerwise, top-k entire_model, and adaptive threshold layerwise (the
     sim path: no launches); launch counters reset before and read after
     each run and held to exact per-step counts (QSGD, TernGrad and
     signSGD: one pack and one unpack launch a step for all their
     buckets; natural and sparse: one field pack and one field unpack
     launch a step); the wire buffers of one step built with the kernels
     equal those built with the plain
     versions (QSGD / TernGrad on the card's own statistics; signSGD,
     natural and top-k against the whole path run on the CPU); one
     error-feedback aggregation each for QSGD and top-k through the
     kernels equals the sim path; two steps of optim.apply_updates
     (SGD, momentum, Nesterov, Adam, with and without weight decay) on
     resnet9's parameters on the card equal the CPU's bit for bit
  5. timings of each kernel and its plain version at the main-path shapes
     and the stress shape, beside the byte and operation bounds: device
     time from CUDA-event timed replays of a CUDA graph of 20 calls
     (`ms`, `plain_ms`), and the per-call time of the same calls issued
     back to back from Python (`call_ms`, host enqueue included); the
     QSGD, TernGrad and sign packs and unpacks, the bit pack and unpack,
     the majority vote and the field pack / unpack (natural's legs and
     the top-k index legs) also as the step's one grouped launch
     (layerwise_step_grouped, the kernel line's time), a layerwise step's
     QSGD encode and natural encode and decode from Python, grouped and
     per bucket; the compress-only quantizers as phase 8 calls them (one
     grouped launch over a layerwise plan_compress call's 11 buckets, the
     entire-model bucket, the whole-input calls) on keys, beside their
     byte and operation bounds (hashes counted from the draw lengths);
     top-k as blockwise_topk calls it (topk_mask_flat, k=5) on the flat
     gradient and on 2**20 entries, and on 237, 2,048 and 8,192 rows in
     f32 and bf16 and on 2**20 entries of sparse rows (topk_rows)
  6. torch.profiler over five main-path steps each of QSGD(16) and
     top-k(1%) layerwise: wall and device-busy time per step, the
     device's idle share and the top device ops
  7. the multi-rank path: 4 rank processes on the one card joined over
     gloo (launch/mesh.py), each holding its own worker's resnet9
     gradients. (a) compressed_allreduce under simulated and allgather,
     wire on and off, QSGD(16) / TernGrad / signSGD / natural / top-k(1%),
     layerwise and entire-model, error feedback for QSGD and top-k, equals
     the single-process Algorithm 1 in its key scheme bit for bit on every
     rank (and aggregate_simulated_workers for the key-free signSGD and
     top-k), its collectives moving comm_report's bytes under wire=True,
     with integrity words verifying and leaving payloads unchanged; (b)
     the signSGD majority vote on every bucket's gathered payloads in
     one call a granularity, fused (one majority launch) = non-fused
     (one bits_unpack, count, one bits_pack) = plain, bucket by bucket;
     (c) one step's buffers of the per-unit codecs (fused=False: one
     pack and one unpack launch a granularity) = the fused buffers; (e)
     the streaming strategies, compressed_allreduce(strategy="ring" /
     "rs_stream", wire=True) for QSGD(16) (on entries of {0, +-1/8,
     +-1/4}, whose norms both devices sum exactly) / TernGrad / signSGD /
     natural / top-k(1%), layerwise and entire-model, fusion 0 and 64
     KiB, hop chunks whole and 64 B: each call bitwise the same call on
     CPU copies of its inputs on the same gloo group (so every kernel on
     the path against its plain twin), the same on every rank, ring
     bitwise the allgather wire result, exact hops, ring and
     reduce-scatter bytes (staged bytes printed); each of (a)-(c) and
     (e) held to exact launch counts; (d) train_cnn_ranks, 20 resnet9
     steps (batch 64, 16 a rank; cuDNN's deterministic algorithms) for
     allgather-wire QSGD(16) and signSGD, simulated-wire QSGD(16) and
     ring QSGD(16): seconds, test
     loss, collective bytes a step against comm_report (the ring's
     against its message layouts), exact launch counts (the allgather
     receive leg decodes a step's gathered buckets in one launch; the
     ring a message's own payload and each hop's chunk in one), equal
     parameters on every rank at the end, and the ring run's test loss
     and parameters bitwise the allgather QSGD(16) run's
  8. the compress-only path (kernels/ops.py) on one worker's resnet9
     gradients: plan_compress for QSGD(16) and TernGrad at layerwise,
     entire-model and blockwise (65,536) granularity (11 / 1 / 1
     buckets), held to exactly one launch a call (every bucket in one
     grouped launch) and to the same call built with the plain versions on
     the card; qsgd_compress, terngrad_compress and blockwise_topk(k=5) on
     the flat gradient and on 2**20 entries (one launch each; a whole
     input is one unit);
     rmsnorm at (4096, 3072) bf16; theory.noise_bounds_from_plan for
     QSGD(16) at both granularities and theory.lemma1_check over the
     layer parts

  9. the LM train path (repro_torch.models, experiment.train_lm): (a) the
     seven attention archs' smoke configs (dense GQA / MQA, MLA, MoE,
     interleaved MoE with sliding windows, VLM), Model.loss and every
     gradient leaf on the card within tolerance of the port's CPU run; (b)
     train_lm at phi4-mini-3.8b's full width (d_model 3072, vocab 200,064,
     24 / 8 heads of 128, d_ff 8192, bf16; depth cut to 2 layers), 4
     workers of 2 sequences of 512 tokens, 3 steps each of QSGD(16)
     layerwise and entire-model and top-k(1%) layerwise, held to exactly
     one pack and one unpack launch a step, finite losses, seconds and
     peak memory printed; (c) one full-width step's wire buffers a worker
     equal to comm_report(measured) plus the message headers, and on the
     614,596,608-entry embedding / head bucket and the 1,430,535,168-entry
     entire model the kernels' QSGD words and decodes bitwise the plain
     versions' (evaluated over spans of positions: the plain arithmetic
     cannot hold such a unit at once), the top-k index leg's pack and
     unpack bitwise, each beside its byte bound (group lm_full_width);
     (d) torch.profiler over one full-width QSGD(16) layerwise step

 10. the serving path (repro_torch.launch.serve, Model.prefill /
     decode_step): (a) the ten archs' smoke configs in f32, phi4-mini
     with an 8-token ring under an 11-token prompt and llama3 with an
     int8 KV cache: prefill and two chained decode steps on the card
     within 1e-5 of max |logit| of the same calls on the CPU, slot_pos
     bitwise; (b) phi4-mini-3.8b whole (32 layers, bf16,
     4,450,618,368 parameters) served at batch 8, 512 uniform prompt
     tokens made on the card, 64 generated tokens: prefill ms, decode ms
     a token (CUDA events over the 63 decode steps), tokens/s, peak
     memory and the cache's exact bytes (603,979,776 of k / v and 73,728
     of slot_pos); (c) mamba2-1.3b whole (48 layers, bf16) the same way,
     its SSM cache exactly 815,333,376 B; (d) zamba2-7b at full width
     cut to 9 layers (one group of 6 and the 3-layer tail) the same
     way, and whisper-base whole at batch 8, 64 prompt and 16 generated
     tokens; each of (b)-(d) then checks the decode of the prompt's last
     token after a prefill of the others against the full prompt's
     prefill (see serve_full); (e) torch.profiler over one phi4-mini
     decode step. The wire kernels' launch counters do not move

 11. the data-parallel Engine, checkpoints and the train CLI
     (launch/engine.py, ckpt/, launch/train.py) on 2 gloo ranks sharing
     cuda:0: (a) the CLI's main path, llama3 smoke in f32, QSGD(16)
     layerwise over the simulated wire, 4 steps with a checkpoint every 2,
     its losses within 1e-5 relative of the same call with --device cpu,
     exact launches a rank and equal states on both ranks; the Engine's
     steps over the simulated wire, allgather and the ring bitwise its
     simulated records (params, momentum, losses); (b) the run resumed
     from its step-2 checkpoint in a fresh run_ranks bitwise the
     uninterrupted 4-step run, and the card's step-4 file loaded bitwise
     on the CPU; (c) the Engine at phi4-mini's full width (2 layers,
     bf16, 1,430,535,168 parameters), each rank 2 x 512 uniform tokens a
     step, QSGD(16) over the allgather wire layerwise and entire-model:
     each unprofiled step's ms (CUDA events), one step split into
     forward / backward, aggregation (gloo's host ms inside it) and
     update, one profiled layerwise step (the pack and decode kernels'
     device ms), each rank's peak memory beside memory_estimate, wire
     bytes a step and rank exactly comm_report's, finite losses, exact
     launches; (d) inside (c)'s rank spawn, the train CLI's rank loop with
     --policy granularity_switch (control/: the controller over the
     Engine, top-k(10%), re-planning every 2 of 6 steps) on the card and
     then on the CPU over the same group: the card's losses within 1e-5
     relative of the CPU's, the same decision at every step on both
     devices and ranks, the same builds / switches

 12. the adaptive controller and the paper's figures (control/,
     experiment.cnn_controller, figures.py): (a) cnn_controller on resnet9
     with AdaptiveKPolicy over top-k(1%) layerwise, re-planning every 5 of
     15 steps through train_cnn_with_controller: builds equal to the
     distinct decisions, exact launches (one fields pack and one fields
     unpack a step: the per-bucket k's index legs in one grouped launch
     each way); then on one step's worker gradients the last decision's
     wire aggregation bitwise its simulated one, its index legs (a
     different k and width a bucket) through fields_pack_buckets /
     fields_unpack_buckets in one launch each bitwise the plain twins,
     and the card's TelemetryState within 1e-5 relative of the CPU's on
     the same gradients (the signed grad_sum within 1e-5 of its bucket's
     sum |x|); (b) at the figures' own shapes: one step's worker
     gradients of mlp, alexnet and resnet9, and for every sim-exact
     compressor and knob figures.ALL runs on that model (QSGD(4),
     TernGrad, top-k and random-k at each ratio) at both granularities,
     aggregate_simulated_workers(wire=True) bitwise its wire=False result,
     and ef_beyond_paper's error-feedback top-k(0.1%) over two steps
     (aggregate and EF state), with exact launch counts; (c) figures.ALL
     at 3 steps a run: every row printed with finite accuracies

 13. tensor, sequence and FSDP parallelism (models/dist.py, the (data,
     model) mesh, the Engine's shards) in one spawn of 4 gloo ranks
     sharing cuda:0, rank = d * 2 + m: (b) phi4-mini at full width (2
     layers, bf16, SGD) on (data 2, model 2), one step each from the same
     params and batch of QSGD(16) layerwise over the simulated wire and
     over the allgather wire (bitwise equal params), and
     top-k(1%) over the wire, exact launches a run, rank 0's wire
     launches at the TP shards' bucket shapes captured and held bitwise
     against the plain versions and the simulated wire's decodes against
     QSGD.sim (the simulated step), each step split into forward /
     backward (the TP collectives' host ms), aggregation and update, loss
     and peak memory a rank; then on ranks 0
     and 1: (a) tests/dist_checks.py's five families on model 2, SP off
     and on, aggregated gradients within its TOL of the port's one-device
     run on the card; (c) the same phi4-mini with use_fsdp=True on data
     2: a dense step's aggregated gradients within TOL of the unsharded
     Engine's, and a top-k(1%) FSDP hook call bitwise the plain top-k of
     its gradient; (d) phi4-mini-3.8b whole served on model 2 (batch 8,
     128 + 16 tokens): each rank's cache half the slots, every step's
     logits within 5e-2 of max |logit| of the one-device run fed the same
     tokens, prefill ms, decode ms a token and peak memory
 14. observability (obs/) on a one-rank gloo group opened in this
     process: (a) the Engine on phi4-mini at full width (2 layers, bf16),
     QSGD(16) layerwise over the simulated wire, momentum SGD, with
     tracer= and metrics=: one step each from the same params untraced,
     with a disabled TraceRecorder and traced (twice), then untraced
     again: params and momentum bitwise equal, launches identical
     (exact), each traced step exactly num_messages message spans whose
     stages include compress / pack / decode / collective, the sum of
     stage_us at most wall_us, the traced step's wire launches held
     bitwise against their plain versions, the engine/* gauges equal
     the plan's and schedule's counts and payload_bits_per_step, the
     Chrome trace valid; step ms from CUDA events; (b) obs.calibrate
     with QSGD(16) at the three default thresholds (reps 3) on resnet9's
     and (a)'s phi4-mini gradient trees: counts, bytes and model bits
     equal the CPU's, the fitted alpha / beta and model-error ratios
     printed; (c) inside phase 7's spawn: measure_stream (ring, rs) and
     measure_collective on each rank's resnet9 gradient: hop spans
     exactly n_messages x (n - 1), hop bytes what ring_shift moved,
     exact launches; (d) the serve CLI and the train CLI's rank loop
     with --trace-out / --metrics-out at smoke width: one prefill and
     gen - 1 decode spans and decode_us samples, num_messages message
     spans a train step
 15. the simulated cluster and the resilience plane (sim/, resil/): (a)
     aggregate_simulated_workers(wire=True) at phi4-mini's full width (2
     layers, bf16, 2 workers), QSGD(16) layerwise with the integrity
     word, under prob=1 bit flips with resend bitwise the clean aggregate
     (every message detected and resent), without resend all detected and
     the aggregate different, a prob-0 injector the clean launches and
     bits; aggregate ms (CUDA events) and peak memory a run; (b) resnet9
     through train_resilient (top-k 0.25 with EF, both granularities, 8
     steps, deterministic algorithms): corrupted with resend bitwise
     clean, resume bitwise, the step guard, the card's losses against a
     CPU run, exact launches; (c) inside phase 7's spawn: the ring under
     per-hop bit flips and dropped hops with resend bitwise the clean ring
     with every hop detected, stale hops undetected with a different
     aggregate, the allgather wire path under bit flips with resend
     bitwise, each faulted call the clean call's launches; (d) one
     campaign cell a reference scenario (repro_torch.scenarios, 3 steps)
     and the identity scenarios bitwise the bare aggregate

Phase 3 also holds the other compress-only kernels against their plain
versions on the card at every bucket shape, the entire-model gradient and
2**20 entries: top-k bitwise at k 1/5/16/128 on 512-wide rows, and as
flat inputs (topk_mask_flat, the tail row padded in the kernel) in f32
and bf16 at k 0/1/5/16/128/511/512/600 on d = 1, 511, 513, 121,002 and
2**20, on rows of special values (zeros, ties, +-inf, NaN, -0.0, tiny,
huge) and on a view one element past a 16-byte boundary; and RMSNorm at
(4096, 3072) in f32 (within 1e-6 relative) and bf16 (at most
0.1% of entries one bf16 ulp apart; the two sum the squares in other
orders) and at (64, 65536) bf16 (the looped kernel), and the RMSNorm
wrapper refusing a view that does not start on a 16-byte boundary. Phase
5 times them beside their bounds at the phase-8 shapes, and RMSNorm
beside torch.nn.functional.rms_norm (`library_ms`, timed only) and a copy
of the same bytes (`copy_ms`). After phase 8, the whole-call rows: a
layerwise plan_compress (QSGD(16), TernGrad), the whole-input calls on
2**20 entries and blockwise_topk(k=5) on the flat gradient and on 2**20
entries in f32 and bf16 and on 2**20 entries of sparse rows, host ms per
call and the kernels one call launches (torch.profiler).

Run from the repository root: `python3 chip_smoke.py` (no arguments, one
card). `python3 chip_smoke.py --nccl` on a machine with 4 cards runs the
build and phase 7 only, one rank per card over NCCL. `python3
chip_smoke.py --calls DIR` runs only the whole-call rows, on the port of
the checkout DIR (another commit's tree, unpacked with git archive, for a
comparison in one call). Details go to
chiprun_out/chip_smoke.json. The last line is {"ok": true, "device":
{...}}; the line before it the kernel table, whose launches are, for the
wire kernels, the main-path runs of phase 4 plus the multi-rank phase 7
summed over its ranks plus phase 9(b) plus phase 11 summed over its
ranks plus phase 12 plus phase 13 summed over its ranks plus phase 14
(its (c) summed over phase 7's ranks) plus phase 15 (its (c) summed over
phase 7's ranks), and for the compress-only kernels the runs of phase 8.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

STEPS = 20
WORKERS = 4
STRESS = (4, 1048579)
QSGD_WIDTHS = ((2, 1), (4, 4), (6, 16), (8, 64))
MAIN_LEVELS, MAIN_WIDTH = 16, 6
FIELD_WIDTHS = (1, 4, 9, 13, 16, 17, 24, 31)
NATURAL_WIDTH = 9
SPARSE_RATIO = 0.01

# H100 SXM peaks (NVIDIA data sheet / Hopper whitepaper, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost (derived from the whitepaper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer ops of one threefry2x32 hash: 20 rounds of add/rotate/xor plus
# 5 key injections of 3 adds and the 2 initial adds and the parity xor
THREEFRY_INT_OPS = 20 * 3 + 5 * 3 + 2 + 2
# (int32, fp32) operations per element beyond the hash. Pack: QSGD
# abs/div/mul/floor/sub/compare/add, TernGrad abs/div/compare, sign one
# compare (fp); code select + shift/or into a word (int; the sign word is
# one ballot). Unpack: word index, shift(s), or, mask (int), and for QSGD /
# TernGrad the int->float convert and multiply (fp); sign: shift, mask,
# select.
ELEMENT_OPS = {"qsgd_pack": (3, 7), "terngrad_pack": (3, 3),
               "sign_pack": (1, 1), "fields_pack": (3, 0),
               "qsgd_unpack": (4, 2), "terngrad_unpack": (4, 2),
               "sign_unpack": (3, 0), "fields_unpack": (4, 0),
               "bits_pack": (2, 0), "bits_unpack": (3, 0)}
HASHING = ("qsgd_pack", "terngrad_pack")
# majority: per word column, a ripple-carry add of each worker's word over
# 8 planes (xor + and each) and the 8-step borrow chain (not + or/and)
MAJORITY_PLANES = 8
VOTERS = (1, 2, 3, 4, 5, 8)
RANKS = 4
RANK_TIMEOUT = 600.0
# the compress-only path (phase 8)
COMPRESS_LEVELS = (4, 7, 16, 64)
TOPK_KS = (1, 5, 16, 128)
# the top-k checks on flat inputs: k from none kept to more than a row, d
# on both sides of a 512-entry row (the tail row's padding in the kernel)
TOPK_EDGE_KS = (0, 1, 5, 16, 128, 511, 512, 600)
TOPK_FLAT_DIMS = (1, 511, 513, 121002, 1 << 20)
# rows of 512 timed at 237 (resnet9's flat gradient), 2,048 (2**20
# entries) and 8,192
TOPK_ROWS = (237, 2048, 8192)
TOPK_SPARSE = 4              # nonzeros a row of the sparse top-k input
MICRO = 1 << 20              # benchmarks/microbench.py's D
RMS_SHAPE = (4096, 3072)     # phi4-mini's d_model (configs/phi4_mini_3_8b.py)
# rows too wide for the registers kernel (past 512 threads x 8 vectors)
RMS_WIDE = (64, 65536)
# field counts at the grouped field kernels' chunk and tile edges (32-field
# chunks, 2,048-field tiles), with k % 4 != 0 beside them (the 4-byte path)
FIELD_EDGE_KS = (1, 2, 31, 32, 33, 100, 1025, 2047, 2048, 2049, 4095, 4096,
                 4097, 65537)
# unit dimensions where the hash-once pack's split is most fragile: d = 1,
# 2, 3, odd d, h = ceil(d / 2) = 32k +- 1 and h at tile edges (480 pairs)
PACK_EDGE_DIMS = (1, 2, 3, 31, 32, 33, 61, 62, 63, 64, 65, 479, 480, 481,
                  511, 513, 957, 959, 960, 961, 962, 1025, 1919, 1921, 2049,
                  65537)
# unit dimensions at the grouped sign pack's and the unpack walk's chunk
# (32) and tile (2,048) edges
GROUPED_EDGE_DIMS = (1, 2, 31, 32, 33, 2047, 2048, 2049, 4097, 65537)
# the grouped vote's checks: every worker count of VOTERS, two and three
# groups of 8 and the most the kernel counts (8 bit planes), over word
# columns at its 4-column and 128-column tile edges with every W % 4
VOTE_NS = VOTERS + (9, 17, 255)
VOTE_EDGE_COLS = (1, 2, 3, 4, 5, 6, 7, 127, 128, 129, 130, 255, 256, 1025,
                  4096)
BLOCK = 65536
# the compress-only quantizers' draw granules: a UnitPlan unit's uniforms
# span 512 * ceil(d / 512) positions, a whole input's 131,072 * ceil(d /
# 131,072) (kernels/ops.py draw_length)
UNIT_DRAW, WHOLE_DRAW = 512, 131072
# unit dimensions where the compress-only pair walks are most fragile:
# min(d, N / 2) on both sides of their 256- and 1,024-pair tiles and of h
# = N / 2 at both granules, d % 4 != 0 beside d % 4 == 0
COMPRESS_EDGE_DIMS = (1, 2, 3, 255, 256, 257, 511, 512, 513, 1023, 1024,
                      1025, 2047, 2048, 2049, 2303, 65537)
# (int32, fp32) operations per element of the compress-only kernels beyond
# the threefry hashes (THREEFRY_INT_OPS a counter pair, drawn in the QSGD
# and TernGrad kernels): QSGD abs, divide, fma (2), floor, sign, two
# multiplies; TernGrad abs, divide, compare, select, multiply; top-k abs,
# max, 24 bisection compares and the final compare (fp) with 24 count adds
# (int); RMSNorm square, add and two multiplies
COMPRESS_OPS = {"qsgd_compress_rows": (0, 8),
                "terngrad_compress_rows": (0, 5),
                "topk_mask": (24, 27), "rmsnorm": (0, 4)}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def max_abs_err(a, b) -> float:
    """Largest |a - b| (words compared as integers, floats as values)."""
    import torch
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def bitwise_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---- inputs -----------------------------------------------------------------

def bucket_shapes():
    """resnet9 layerwise bucket shapes stacked over the workers, and the
    entire-model shape: what the main path hands the kernels."""
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.models.cnn import init_cnn
    from repro_torch.random import key
    p = init_cnn(RESNET9, key(0), device="cpu")
    plan = build_plan(p, stacked_mask(p), Granularity("layerwise"))
    check(plan.num_units == 14 and plan.num_dispatches == 11,
          f"resnet9 plan {plan.summary()}")
    return [(WORKERS * b.n, b.dim) for b in plan.buckets], (WORKERS,
                                                            plan.total)


def make_inputs(shape, seed, dev):
    """Seeded (n, d) f32 units (every 7th entry 0, for sign(0) codes) and
    the two int32 key-word columns, on the card."""
    import torch
    from repro_torch.kernels.ref import words_to_i32
    g = torch.Generator().manual_seed(seed)
    n, d = shape
    x = torch.randn((n, d), generator=g)
    x[:, ::7] = 0.0
    x = x.to(dev)
    keys = torch.randint(0, 2**32, (n, 2), generator=g, dtype=torch.int64)
    kw = words_to_i32(keys).to(dev)
    return x, kw[:, 0].contiguous(), kw[:, 1].contiguous()


def make_fields(shape, bound, seed, dev):
    """Seeded (n, k) int32 fields in [0, bound), on the card."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, bound, shape, generator=g,
                         dtype=torch.int64).to(torch.int32).to(dev)


def make_words(n, wpu, seed, dev):
    """Seeded (n, wpu) int32 words with every bit pattern possible."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31, (n, wpu), generator=g,
                         dtype=torch.int64).to(torch.int32).to(dev)


def make_votes(n, W, seed, dev):
    """Seeded (n, W) int32 words of n workers: the last column zero (the
    padding votes 0) and, at even n, an exact tie in every bit of column
    0 (ties vote 1)."""
    w = make_words(n, W, seed, dev)
    w[:, -1] = 0
    if n % 2 == 0:
        w[: n // 2, 0] = -1
        w[n // 2:, 0] = 0
    return w


def shift(t):
    """t's values in a view that starts 4 bytes past a 16-byte boundary."""
    import torch
    v = torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:].view(t.shape)
    check(v.data_ptr() % 16 == 4, "misaligned input is aligned")
    return v


def index_leg(d: int):
    """(k, width) of a top-k / random-k index leg at SPARSE_RATIO."""
    from repro_torch.core.compressors import _k_of, index_bits
    return _k_of(SPARSE_RATIO, d), index_bits(d)


# ---- phase 3: kernels vs plain versions ------------------------------------

def check_kernels(shapes, dev):
    """Every kernel vs its plain version, bitwise -> max |err| per kernel."""
    import torch
    from repro_torch.kernels import pack as P
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import sign as S
    from repro_torch.kernels import terngrad as T
    from repro_torch.kernels.ref import words_per_unit
    err = {k: 0.0 for k in SOURCES}

    def same(name, got, want, what):
        err[name] = max(err[name], max_abs_err(got, want))
        check(bitwise_equal(got, want), f"{name} {what}")

    for si, shape in enumerate(shapes):
        x, k0, k1 = make_inputs(shape, 100 + si, dev)
        d = shape[1]
        nrm = torch.linalg.vector_norm(x, dim=1) + 1e-12
        for width, levels in QSGD_WIDTHS:
            w = Q.qsgd_pack(x, k0, k1, nrm, levels, width)
            same("qsgd_pack", w,
                 Q.qsgd_pack_plain(x, k0, k1, nrm, levels, width),
                 f"{shape} w{width}")
            fac = nrm / levels
            same("qsgd_unpack", Q.qsgd_unpack(w, fac, d, levels, width),
                 Q.qsgd_unpack_plain(w, fac, d, levels, width),
                 f"{shape} w{width}")
        sc = x.abs().amax(dim=1) + 1e-12
        w = T.terngrad_pack(x, k0, k1, sc)
        same("terngrad_pack", w, T.terngrad_pack_plain(x, k0, k1, sc),
             str(shape))
        same("terngrad_unpack", T.terngrad_unpack(w, sc, d),
             T.terngrad_unpack_plain(w, sc, d), str(shape))
        n = shape[0]
        xs = x.clone()
        xs[:, 3::11] = -0.0
        xs[0, min(5, d - 1)] = float("nan")
        w = S.sign_pack(xs)
        same("sign_pack", w, S.sign_pack_plain(xs), str(shape))
        check(bitwise_equal(S.sign_unpack(w, d),
                            torch.where(xs >= 0, 1.0, -1.0)),
              f"sign round trip {shape}")
        w = make_words(n, words_per_unit(d, 1), 200 + si, dev)
        same("sign_unpack", S.sign_unpack(w, d), S.sign_unpack_plain(w, d),
             str(shape))
        b = (xs >= 0).to(torch.int32)
        w = P.bits_pack(b)
        same("bits_pack", w, P.bits_pack_plain(b), str(shape))
        check(bitwise_equal(P.bits_unpack(w, d), b),
              f"bits round trip {shape}")
        w = make_words(n, words_per_unit(d, 1), 250 + si, dev)
        same("bits_unpack", P.bits_unpack(w, d), P.bits_unpack_plain(w, d),
             str(shape))
        W = (n // WORKERS) * words_per_unit(d, 1)     # one worker's words
        for nv in VOTERS:
            w = make_words(nv, W, 270 + 8 * si + nv, dev)
            w[:, -1] = 0                              # padding column
            same("majority", S.majority(w), S.majority_plain(w),
                 f"{nv} x {W}")
        k_idx, w_idx = index_leg(d)
        legs = ([(width, d, 2**width) for width in FIELD_WIDTHS]
                + [(w_idx, k_idx, d)])           # index leg: indices < d
        for li, (width, k, bound) in enumerate(legs):
            f = make_fields((n, k), bound, 300 + 16 * si + li, dev)
            w = P.fields_pack(f, width)
            same("fields_pack", w, P.fields_pack_plain(f, width),
                 f"{(n, k)} w{width}")
            check(bitwise_equal(P.fields_unpack(w, k, width), f),
                  f"fields round trip {(n, k)} w{width}")
            w = make_words(n, words_per_unit(k, width), 400 + li, dev)
            same("fields_unpack", P.fields_unpack(w, k, width),
                 P.fields_unpack_plain(w, k, width), f"{(n, k)} w{width}")
    torch.cuda.synchronize()
    return err


# ---- phase 3: the compress-only kernels vs their plain versions -------------

def compress_inputs(shape, seed, dev):
    """Seeded (n, d) f32 entries (every 7th 0, some -0.0), on the card."""
    import torch
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    x[:, ::7] = 0.0
    x[:, 3::11] = -0.0
    return x.to(dev)


def quant_inputs(shape, seed, dev, specials=False):
    """Seeded (n, d) f32 units (every 7th entry 0), their int32 key words
    and each unit's l2 norm and max|x| over its finite entries, on the
    card. Under `specials`: -0.0 entries, one NaN and, at n > 1, a last
    unit of zeros (statistic 0)."""
    import torch
    x, k0, k1 = make_inputs(shape, seed, dev)
    if specials:
        x[:, 3::11] = -0.0
        x[0, min(5, shape[1] - 1)] = float("nan")
        if shape[0] > 1:
            x[-1] = 0.0
    f = torch.nan_to_num(x, nan=0.0)
    return (x, k0, k1, torch.linalg.vector_norm(f, dim=1),
            f.abs().amax(dim=1))


def rmsnorm_inputs(dtype, seed, dev, shape=RMS_SHAPE):
    """Seeded rows of varied scale in `dtype` and gamma (f32)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    scale = torch.rand((shape[0], 1), generator=g) * 10 + 0.1
    x = torch.randn(shape, generator=g) * scale
    gamma = torch.rand(shape[1], generator=g) + 0.5
    return x.to(dtype).to(dev), gamma.to(dev)


def rmsnorm_close(got, want) -> bool:
    """The stated RMSNorm tolerance (the kernel and torch sum the squares in
    other orders): f32 within 1e-6 relative; bf16 equal except at most 0.1%
    of entries, each one bf16 ulp (2**-7 relative) apart."""
    import torch
    a, b = got.to(torch.float32), want.to(torch.float32)
    err = (a - b).abs()
    if got.dtype == torch.float32:
        return bool((err <= 1e-6 * b.abs()).all())
    off = a != b
    return (float(off.float().mean()) <= 1e-3
            and bool((err[off] <= 2.0**-7 * b.abs()[off]).all()))


@contextlib.contextmanager
def walk(per_thread: int):
    """Inside the block the compress-only kernels take `per_thread` (1 or
    4) counter pairs a thread at every size: kernels/qsgd.py compress_walk
    is shown a card that holds more resident threads than any call has
    pairs (1), or none (4)."""
    from repro_torch.kernels import qsgd as Q
    saved = Q._resident_threads
    Q._resident_threads = lambda device: 2**31 if per_thread == 1 else 0
    try:
        yield
    finally:
        Q._resident_threads = saved


def check_grouped_compress(unit_shapes, em_d, dev):
    """The grouped compress-only quantizers, the pair walks of
    csrc/compress.cu drawing their own uniforms (qsgd_compress_buckets at
    every level of COMPRESS_LEVELS, terngrad_compress_buckets, each on
    both walks: 1 and 4 pairs a thread), vs the plain twins per bucket,
    bitwise, and each group's exact launches: the
    11 resnet9 layerwise buckets of one worker in ONE launch, 40 buckets
    in two, the COMPRESS_EDGE_DIMS units at the unit granule (3 units a
    bucket) and as whole inputs (one unit, the whole-input granule), the
    entire-model and 2**20-entry inputs at both granules, and units 4
    bytes past a 16-byte boundary (the 4-byte path); inputs hold -0.0, a
    NaN and a unit whose statistic is 0. Edge and misaligned buckets also
    one at a time (qsgd_compress_rows / terngrad_compress_rows). -> max
    |err| of (QSGD, TernGrad)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import terngrad as T
    groups = {
        "layerwise": [(s, UNIT_DRAW) for s in unit_shapes],
        "over_max_buckets": [((1 + i % 3, 17 + 61 * i), UNIT_DRAW)
                             for i in range(Q.MAX_BUCKETS + 8)],
        "edges_unit": [((3, d), UNIT_DRAW) for d in COMPRESS_EDGE_DIMS],
        "edges_whole": [((1, d), WHOLE_DRAW) for d in COMPRESS_EDGE_DIMS],
        "full_width": [((1, d), g) for d in (em_d, MICRO)
                       for g in (UNIT_DRAW, WHOLE_DRAW)],
        "misaligned": [((2, d), UNIT_DRAW) for d in (4, 256, 2048, 4608)]}
    err = [0.0, 0.0]

    def held(i, name, got, want, what):
        err[i] = max(err[i], max_abs_err(torch.nan_to_num(got),
                                         torch.nan_to_num(want)))
        check(bitwise_equal(got, want), f"{name} {what}")

    for gi, (gname, cases) in enumerate(groups.items()):
        ins = [quant_inputs(s, 2100 + 64 * gi + i, dev, specials=i % 2 == 0)
               for i, (s, _) in enumerate(cases)]
        xs = [c[0] for c in ins]
        if gname == "misaligned":
            xs = [shift(x) for x in xs]
        k0s, k1s = [c[1] for c in ins], [c[2] for c in ins]
        nrms, scs = [c[3] for c in ins], [c[4] for c in ins]
        draws = [ops.draw_length(s[1], g) for s, g in cases]
        single = gname in ("edges_unit", "edges_whole", "misaligned")
        for lv in COMPRESS_LEVELS:
            want = Q.qsgd_compress_buckets_plain(xs, k0s, k1s, nrms, draws,
                                                 lv)
            for pt in (1, 4):
                with walk(pt):
                    got = launched(Q.qsgd_compress_rows,
                                   lambda: Q.qsgd_compress_buckets(
                                       xs, k0s, k1s, nrms, draws, lv),
                                   len(cases), gname)
                    ones = [Q.qsgd_compress_rows(xs[b], k0s[b], k1s[b],
                                                 nrms[b], draws[b], lv)
                            for b in range(len(cases))] if single else []
                for b, (g, w) in enumerate(zip(got, want)):
                    what = (f"{gname} {tuple(xs[b].shape)} N {draws[b]} "
                            f"levels {lv}, {pt} a thread")
                    held(0, "qsgd_compress_buckets", g, w, what)
                    if single:
                        held(0, "qsgd_compress_rows", ones[b], w, what)
        want = T.terngrad_compress_buckets_plain(xs, k0s, k1s, scs, draws)
        for pt in (1, 4):
            with walk(pt):
                got = launched(T.terngrad_compress_rows,
                               lambda: T.terngrad_compress_buckets(
                                   xs, k0s, k1s, scs, draws),
                               len(cases), gname)
                ones = [T.terngrad_compress_rows(xs[b], k0s[b], k1s[b],
                                                 scs[b], draws[b])
                        for b in range(len(cases))] if single else []
            for b, (g, w) in enumerate(zip(got, want)):
                what = f"{gname} {tuple(xs[b].shape)} N {draws[b]}, {pt} a thread"
                held(1, "terngrad_compress_buckets", g, w, what)
                if single:
                    held(1, "terngrad_compress_rows", ones[b], w, what)
    torch.cuda.synchronize()
    return tuple(err)


def topk_special_rows(dev):
    """(16, 512) f32 rows where the top-k bisection is most fragile: zeros
    and equal values (every count 512, the 10-bit field full), ties at the
    threshold, +-inf, a NaN, all -0.0, 1e-30 magnitudes, subnormals,
    magnitudes of 2^126 and more (counted whole at every step), a dense
    cluster and a row mostly zeros (the [lo, hi) list filled late or
    never)."""
    import torch
    g = torch.Generator().manual_seed(5)
    x = torch.randn((16, 512), generator=g)
    x[1] = 0.0
    x[2, ::3] = 1.5
    x[3] *= 1e-30
    x[4, 7] = float("nan")
    x[5, 9] = float("inf")
    x[6, 3] = -float("inf")
    x[7] = -0.0
    x[8] = 2.0
    x[9, ::2] = -3.0
    x[10] = 1e-45 * torch.sign(x[10])
    x[11] = 3e38 * torch.sign(x[11])
    x[12, 5] = 2.0**126
    x[13] = 1 + torch.arange(512) * 1e-7
    x[14, :300] = 0.0
    x[15] = torch.rand(512, generator=g) * 0.01 + 0.99
    return x.to(dev)


def topk_sparse_inputs(rows, seed, dev):
    """Seeded (rows * 512,) f32 entries, TOPK_SPARSE nonzeros in each row
    of 512 (a sparse gradient's rows): at k = 5 a row's zeros stay in
    [lo, hi) to the end, so the top-k kernel counts the whole row at all
    24 steps, its slowest case."""
    import torch
    g = torch.Generator().manual_seed(seed)
    at = torch.rand((rows, 512), generator=g).argsort(1)[:, :TOPK_SPARSE]
    x = torch.zeros((rows, 512)).scatter_(
        1, at, torch.randn((rows, TOPK_SPARSE), generator=g))
    return x.reshape(-1).to(dev)


def check_compress_kernels(shapes, dev):
    """The other compress-only kernels vs their plain versions on the card
    -> max |err| per kernel: top-k bitwise at every (n, d) shape on its
    entries as 512-wide rows (topk_mask) at TOPK_KS, and as a flat input
    (topk_mask_flat, the tail row padded in the kernel) at TOPK_EDGE_KS in
    f32 and bf16 on d in TOPK_FLAT_DIMS, on the special rows and on a view
    one element past a 16-byte boundary (the 2- and 4-byte path); then
    RMSNorm at RMS_SHAPE in f32 and bf16 (the registers kernel) and at
    RMS_WIDE in bf16 (the looped kernel) within the stated tolerance, and
    the wrapper raising on a view that does not start on a 16-byte
    boundary."""
    import torch
    from repro_torch.kernels import topk_mask as K
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    err = {"topk_mask": 0.0, "rmsnorm": 0.0}

    def held(got, want, what):
        err["topk_mask"] = max(err["topk_mask"], max_abs_err(
            torch.nan_to_num(got), torch.nan_to_num(want)))
        check(bitwise_equal(got, want), f"topk_mask {what}")

    for si, shape in enumerate(shapes):
        xt = K._tile(compress_inputs(shape, 800 + si, dev))[0]
        for k in TOPK_KS:
            held(K.topk_mask(xt, k), K.topk_mask_plain(xt, k),
                 f"{tuple(xt.shape)} k {k}")
    flats = [(f"d {d}", compress_inputs((1, d), 820 + i, dev).reshape(-1))
             for i, d in enumerate(TOPK_FLAT_DIMS)]
    flats.append(("special rows", topk_special_rows(dev).reshape(-1)))
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(what, x.to(dtype)) for what, x in flats]
        x = compress_inputs((1, 121003), 830, dev).reshape(-1).to(dtype)
        cases.append(("view one element past a 16-byte boundary", x[1:]))
        check(x[1:].data_ptr() % 16 == x.element_size(), "aligned view")
        for what, x in cases:
            for k in TOPK_EDGE_KS:
                held(K.topk_mask_flat(x, k), K.topk_mask_flat_plain(x, k),
                     f"flat {what} {dtype} k {k}")
    for shape, dtype, variant in ((RMS_SHAPE, torch.float32, "registers"),
                                  (RMS_SHAPE, torch.bfloat16, "registers"),
                                  (RMS_WIDE, torch.bfloat16, "looped")):
        x, gamma = rmsnorm_inputs(dtype, 900, dev, shape)
        got, want = rmsnorm(x, gamma), rmsnorm_plain(x, gamma)
        check(rmsnorm.variant == variant,
              f"rmsnorm {shape} {dtype}: ran {rmsnorm.variant}")
        err["rmsnorm"] = max(err["rmsnorm"], max_abs_err(got, want))
        check(rmsnorm_close(got, want), f"rmsnorm {shape} {dtype}")
    whole = torch.empty(RMS_SHAPE[0] * RMS_SHAPE[1] + 1, dtype=torch.bfloat16,
                        device=dev)
    try:
        rmsnorm(whole[1:].view(RMS_SHAPE), torch.ones(RMS_SHAPE[1],
                                                      device=dev))
        fail("rmsnorm took a view 2 bytes off a 16-byte boundary")
    except ValueError as e:
        check("16-byte aligned" in str(e), f"rmsnorm misaligned view: {e}")
    torch.cuda.synchronize()
    return err


def launched(wrapper, fn, count, what):
    """fn(), a grouped call over `count` buckets, held to exactly one
    launch of `wrapper` per MAX_BUCKETS buckets -> what fn returns."""
    from repro_torch.kernels.qsgd import MAX_BUCKETS
    before = wrapper.launches
    out = fn()
    got = wrapper.launches - before
    want = -(-count // MAX_BUCKETS)
    check(got == want, f"{wrapper.__name__} grouped {what}: {got} "
          f"launches for {count} buckets, want {want}")
    return out


def check_grouped_pack(layer_shapes, dev):
    """The grouped stochastic packs, the hash-once tile walk of
    csrc/hash_pack.cuh (qsgd_pack_buckets for every (width, levels) of
    QSGD_WIDTHS, terngrad_pack_buckets on inputs holding -0.0 and NaN), vs
    the per-bucket plain loop, bitwise, and each group's exact launches:
    the 11 resnet9 layerwise buckets in ONE launch, MAX_BUCKETS + 8 buckets
    in two, and the PACK_EDGE_DIMS units grouped and one bucket at a time.
    -> max |err| of (qsgd_pack, terngrad_pack)."""
    import torch
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import terngrad as T
    groups = {"layerwise": layer_shapes,
              "over_max_buckets": [(1 + i % 3, 17 + 61 * i)
                                   for i in range(Q.MAX_BUCKETS + 8)],
              "edges": [(3, d) for d in PACK_EDGE_DIMS]}
    err = [0.0, 0.0]

    for gi, (gname, shapes) in enumerate(groups.items()):
        ins = [make_inputs(s, 1500 + 64 * gi + i, dev)
               for i, s in enumerate(shapes)]
        xs = [x for x, _, _ in ins]
        k0s = [k0 for _, k0, _ in ins]
        k1s = [k1 for _, _, k1 in ins]
        nrms = [torch.linalg.vector_norm(x, dim=1) + 1e-12 for x in xs]
        for width, levels in QSGD_WIDTHS:
            got = launched(Q.qsgd_pack, lambda: Q.qsgd_pack_buckets(
                xs, k0s, k1s, nrms, levels, width), len(shapes), gname)
            for g, x, k0, k1, nrm in zip(got, xs, k0s, k1s, nrms):
                want = Q.qsgd_pack_plain(x, k0, k1, nrm, levels, width)
                err[0] = max(err[0], max_abs_err(g, want))
                check(bitwise_equal(g, want),
                      f"qsgd_pack grouped {gname} {tuple(x.shape)} w{width}")
                if gname == "edges":
                    one = Q.qsgd_pack(x, k0, k1, nrm, levels, width)
                    check(bitwise_equal(one, want),
                          f"qsgd_pack {tuple(x.shape)} w{width}")
        scs = [x.abs().amax(dim=1) + 1e-12 for x in xs]
        txs = []
        for x in xs:                 # -0.0 and NaN code as the plain twin's
            t = x.clone()
            t[:, 3::11] = -0.0
            t[0, min(5, t.shape[1] - 1)] = float("nan")
            txs.append(t)
        got = launched(T.terngrad_pack, lambda: T.terngrad_pack_buckets(
            txs, k0s, k1s, scs), len(shapes), gname)
        for g, x, k0, k1, sc in zip(got, txs, k0s, k1s, scs):
            want = T.terngrad_pack_plain(x, k0, k1, sc)
            err[1] = max(err[1], max_abs_err(g, want))
            check(bitwise_equal(g, want),
                  f"terngrad_pack grouped {gname} {tuple(x.shape)}")
            if gname == "edges":
                check(bitwise_equal(T.terngrad_pack(x, k0, k1, sc), want),
                      f"terngrad_pack {tuple(x.shape)}")
    torch.cuda.synchronize()
    return tuple(err)


def check_grouped_fields(layer_shapes, dev):
    """The grouped field launches (fields_pack_buckets /
    fields_unpack_buckets) vs the per-bucket plain twins, bitwise, and
    each group's exact launches: every width of FIELD_WIDTHS over the
    FIELD_EDGE_KS buckets (one launch each way a width); natural's 9-bit
    legs and the top-k index legs of the 11 layerwise buckets, mixed widths
    in one table (one launch); MAX_BUCKETS + 9 buckets of mixed widths (two
    launches); and inputs that start 4 bytes past a 16-byte boundary (the
    4-byte load path at k % 4 == 0). Unpack runs on the packed words (a
    round trip) and on random words. -> max |err| of (pack, unpack)."""
    import torch
    from repro_torch.kernels import pack as P
    from repro_torch.kernels.ref import words_per_unit
    groups = {f"edges_w{w}": [(3, k, w) for k in FIELD_EDGE_KS]
              for w in FIELD_WIDTHS}
    groups["layerwise_legs"] = (
        [(n, d, NATURAL_WIDTH) for n, d in layer_shapes]
        + [(n, *index_leg(d)) for n, d in layer_shapes])
    groups["over_max_buckets"] = [
        (1 + i % 3, 17 + 61 * i, FIELD_WIDTHS[i % len(FIELD_WIDTHS)])
        for i in range(P.MAX_BUCKETS + 9)]
    groups["misaligned"] = [(3, k, w) for k, w in ((1024, 9), (4608, 13),
                                                   (100, 31))]
    err = [0.0, 0.0]

    for gi, (gname, buckets) in enumerate(groups.items()):
        fs, ws, rand, ks = [], [], [], []
        for i, (n, k, w) in enumerate(buckets):
            f = make_fields((n, k), 2**w, 1700 + 97 * gi + i, dev)
            r = make_words(n, words_per_unit(k, w), 1800 + 97 * gi + i, dev)
            if gname == "misaligned":           # 4 bytes past the boundary
                f = torch.cat([f.reshape(-1)[:1], f.reshape(-1)])[1:].view(
                    n, k)
                r = torch.cat([r.reshape(-1)[:1], r.reshape(-1)])[1:].view(
                    r.shape)
                check(f.data_ptr() % 16 == 4 and r.data_ptr() % 16 == 4,
                      "misaligned inputs are aligned")
            fs.append(f)
            ws.append(w)
            rand.append(r)
            ks.append(k)
        got = launched(P.fields_pack, lambda: P.fields_pack_buckets(fs, ws),
                       len(buckets), gname)
        back = launched(P.fields_unpack,
                        lambda: P.fields_unpack_buckets(got, ks, ws),
                        len(buckets), gname)
        dec = launched(P.fields_unpack,
                       lambda: P.fields_unpack_buckets(rand, ks, ws),
                       len(buckets), gname)
        for f, w, k, g, b, r, dd in zip(fs, ws, ks, got, back, rand, dec):
            want = P.fields_pack_plain(f, w)
            err[0] = max(err[0], max_abs_err(g, want))
            check(bitwise_equal(g, want),
                  f"fields_pack grouped {gname} {tuple(f.shape)} w{w}")
            check(bitwise_equal(b, f),
                  f"fields round trip grouped {gname} {tuple(f.shape)} w{w}")
            want = P.fields_unpack_plain(r, k, w)
            err[1] = max(err[1], max_abs_err(dd, want))
            check(bitwise_equal(dd, want),
                  f"fields_unpack grouped {gname} {tuple(r.shape)} w{w}")
    torch.cuda.synchronize()
    return tuple(err)


def check_grouped_sign_unpack(layer_shapes, dev):
    """The grouped sign pack, QSGD unpack and bit unpack launches
    (sign_pack_buckets / qsgd_unpack_buckets / bits_unpack_buckets) vs the
    per-bucket plain twins, bitwise, and each group's exact launches: the
    11 layerwise buckets (one launch), MAX_BUCKETS + 8 buckets (two), units
    of GROUPED_EDGE_DIMS, and inputs that start 4 bytes past a 16-byte
    boundary (the 4-byte load path at d % 4 == 0). Sign inputs hold -0.0
    and a NaN; QSGD unpacks every (width, levels) of QSGD_WIDTHS on the
    packed words of the same units and on random words; the bit unpack
    runs on the sign words of the same units and on random words. The
    edge and misaligned units also go one bucket at a time. -> max |err|
    of (sign_pack, qsgd_unpack, bits_unpack)."""
    import torch
    from repro_torch.kernels import pack as P
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import sign as S
    from repro_torch.kernels.ref import words_per_unit
    groups = {"layerwise": layer_shapes,
              "over_max_buckets": [(1 + i % 3, 17 + 61 * i)
                                   for i in range(Q.MAX_BUCKETS + 8)],
              "edges": [(3, d) for d in GROUPED_EDGE_DIMS],
              "misaligned": [(3, d) for d in (1024, 4608, 100, 2049)]}
    err = [0.0, 0.0, 0.0]

    def same(i, got, want, what):
        err[i] = max(err[i], max_abs_err(got, want))
        check(bitwise_equal(got, want), what)

    for gi, (gname, shapes) in enumerate(groups.items()):
        one = gname in ("edges", "misaligned")
        ins = [make_inputs(s, 2100 + 64 * gi + i, dev)
               for i, s in enumerate(shapes)]
        xs = []
        for x, _, _ in ins:
            x[:, 3::11] = -0.0
            x[0, min(5, x.shape[1] - 1)] = float("nan")
            xs.append(shift(x) if gname == "misaligned" else x)
        got = launched(S.sign_pack, lambda: S.sign_pack_buckets(xs),
                       len(xs), gname)
        for g, x in zip(got, xs):
            want = S.sign_pack_plain(x)
            same(0, g, want, f"sign_pack grouped {gname} {tuple(x.shape)}")
            if one:
                same(0, S.sign_pack(x), want,
                     f"sign_pack {gname} {tuple(x.shape)}")
        dims = [d for _, d in shapes]
        signs = got
        rand = [make_words(n, words_per_unit(d, 1), 2300 + 64 * gi + i, dev)
                for i, (n, d) in enumerate(shapes)]
        if gname == "misaligned":
            signs = [shift(w) for w in signs]
            rand = [shift(r) for r in rand]
        for kind, words in (("signs", signs), ("random", rand)):
            got = launched(P.bits_unpack, lambda: P.bits_unpack_buckets(
                words, dims), len(words), gname)
            for g, w, d in zip(got, words, dims):
                want = P.bits_unpack_plain(w, d)
                what = f"{gname} {kind} {tuple(w.shape)}"
                same(2, g, want, f"bits_unpack grouped {what}")
                if one:
                    same(2, P.bits_unpack(w, d), want, f"bits_unpack {what}")
        clean = [x.nan_to_num() for x, _, _ in ins]
        nrms = [torch.linalg.vector_norm(x, dim=1) + 1e-12 for x in clean]
        for width, levels in QSGD_WIDTHS:
            packed = Q.qsgd_pack_buckets(clean, [k0 for _, k0, _ in ins],
                                         [k1 for _, _, k1 in ins], nrms,
                                         levels, width)
            rand = [make_words(n, words_per_unit(d, width),
                               2200 + 64 * gi + i, dev)
                    for i, (n, d) in enumerate(shapes)]
            if gname == "misaligned":
                rand = [shift(r) for r in rand]
            facs = [nrm / levels for nrm in nrms]
            for kind, words in (("packed", packed), ("random", rand)):
                got = launched(Q.qsgd_unpack, lambda: Q.qsgd_unpack_buckets(
                    words, facs, dims, levels, width), len(words), gname)
                for g, w, f, d in zip(got, words, facs, dims):
                    want = Q.qsgd_unpack_plain(w, f, d, levels, width)
                    what = f"{gname} {kind} {tuple(w.shape)} w{width}"
                    same(1, g, want, f"qsgd_unpack grouped {what}")
                    if one:
                        same(1, Q.qsgd_unpack(w, f, d, levels, width), want,
                             f"qsgd_unpack {what}")
    torch.cuda.synchronize()
    return tuple(err)


def check_grouped_decode(layer_shapes, dev):
    """The grouped TernGrad and signSGD unpacks (terngrad_unpack_buckets /
    sign_unpack_buckets, the tile walk of csrc/unpack_tile.cuh) vs the
    per-bucket plain twins, bitwise, and each group's exact launches: the
    11 layerwise buckets (one launch), MAX_BUCKETS + 8 buckets (two), units
    of GROUPED_EDGE_DIMS, and words that start 4 bytes past a 16-byte
    boundary. Each decodes the words packed from the same units (the
    grouped packs) and random words (at width 2 they hold code 3, which
    the pack never emits). The edge and misaligned units also go one
    bucket at a time. -> max |err| of (terngrad_unpack, sign_unpack)."""
    import torch
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import sign as S
    from repro_torch.kernels import terngrad as T
    from repro_torch.kernels.ref import words_per_unit
    groups = {"layerwise": layer_shapes,
              "over_max_buckets": [(1 + i % 3, 17 + 61 * i)
                                   for i in range(Q.MAX_BUCKETS + 8)],
              "edges": [(3, d) for d in GROUPED_EDGE_DIMS],
              "misaligned": [(3, d) for d in (1024, 4608, 100, 2049)]}
    err = [0.0, 0.0]

    for gi, (gname, shapes) in enumerate(groups.items()):
        one = gname in ("edges", "misaligned")
        ins = [make_inputs(s, 2500 + 64 * gi + i, dev)
               for i, s in enumerate(shapes)]
        xs = [x for x, _, _ in ins]
        scs = [x.abs().amax(dim=1) + 1e-12 for x in xs]
        dims = [d for _, d in shapes]
        tern = {"packed": T.terngrad_pack_buckets(
                    xs, [k0 for _, k0, _ in ins], [k1 for _, _, k1 in ins],
                    scs),
                "random": [make_words(n, words_per_unit(d, 2),
                                      2600 + 64 * gi + i, dev)
                           for i, (n, d) in enumerate(shapes)]}
        signs = {"packed": S.sign_pack_buckets(xs),
                 "random": [make_words(n, words_per_unit(d, 1),
                                       2700 + 64 * gi + i, dev)
                            for i, (n, d) in enumerate(shapes)]}
        if gname == "misaligned":
            tern = {k: [shift(w) for w in v] for k, v in tern.items()}
            signs = {k: [shift(w) for w in v] for k, v in signs.items()}
        for kind in ("packed", "random"):
            got = launched(T.terngrad_unpack,
                           lambda: T.terngrad_unpack_buckets(tern[kind], scs,
                                                             dims),
                           len(shapes), gname)
            for g, w, sc, d in zip(got, tern[kind], scs, dims):
                want = T.terngrad_unpack_plain(w, sc, d)
                what = f"{gname} {kind} {tuple(w.shape)}"
                err[0] = max(err[0], max_abs_err(g, want))
                check(bitwise_equal(g, want),
                      f"terngrad_unpack grouped {what}")
                if one:
                    check(bitwise_equal(T.terngrad_unpack(w, sc, d), want),
                          f"terngrad_unpack {what}")
            got = launched(S.sign_unpack, lambda: S.sign_unpack_buckets(
                signs[kind], dims), len(shapes), gname)
            for g, w, d in zip(got, signs[kind], dims):
                want = S.sign_unpack_plain(w, d)
                what = f"{gname} {kind} {tuple(w.shape)}"
                err[1] = max(err[1], max_abs_err(g, want))
                check(bitwise_equal(g, want), f"sign_unpack grouped {what}")
                if one:
                    check(bitwise_equal(S.sign_unpack(w, d), want),
                          f"sign_unpack {what}")
    torch.cuda.synchronize()
    return tuple(err)


def check_grouped_vote(layer_shapes, dev):
    """The grouped bit pack (bits_pack_buckets, the staged-tile ballot walk
    of csrc/ballot_pack.cuh it shares with sign_pack) and the grouped
    majority vote (majority_buckets) vs the per-bucket plain twins,
    bitwise, and each group's exact launches: the 11 layerwise buckets
    (one launch each; the vote on each bucket's sign words as 4 workers'),
    MAX_BUCKETS + 8 buckets (two), units of GROUPED_EDGE_DIMS (bits) and
    VOTE_EDGE_COLS columns at each worker count of VOTE_NS (the vote, one
    launch a count), and inputs that start 4 bytes past a 16-byte boundary
    (the 4-byte paths at d % 4 == 0 and W % 4 == 0). The bits are the
    signs of inputs holding -0.0 and a NaN; the votes of every group but
    the layerwise one hold a zero column and, at even n, exact ties. The
    edge and misaligned groups also go one bucket at a time. -> max |err|
    of (bits_pack, majority)."""
    import torch
    from repro_torch.kernels import pack as P
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import sign as S
    groups = {"layerwise": layer_shapes,
              "over_max_buckets": [(1 + i % 3, 17 + 61 * i)
                                   for i in range(Q.MAX_BUCKETS + 8)],
              "edges": [(3, d) for d in GROUPED_EDGE_DIMS],
              "misaligned": [(3, d) for d in (1024, 4608, 100, 2049)]}
    votes = {"over_max_buckets": [[(1 + i % 9, 1 + 53 * i)
                                   for i in range(Q.MAX_BUCKETS + 8)]],
             "edges": [[(nv, W) for W in VOTE_EDGE_COLS] for nv in VOTE_NS],
             "misaligned": [[(4, 1024), (3, 4608), (8, 100), (2, 2049),
                             (255, 1028)]]}
    err = [0.0, 0.0]

    def same(i, got, want, what):
        err[i] = max(err[i], max_abs_err(got, want))
        check(bitwise_equal(got, want), what)

    for gi, (gname, shapes) in enumerate(groups.items()):
        one = gname in ("edges", "misaligned")
        bits = []
        for i, s in enumerate(shapes):
            x, _, _ = make_inputs(s, 2900 + 64 * gi + i, dev)
            x[:, 3::11] = -0.0
            x[0, min(5, x.shape[1] - 1)] = float("nan")
            b = (x >= 0).to(torch.int32)
            bits.append(shift(b) if gname == "misaligned" else b)
        got = launched(P.bits_pack, lambda: P.bits_pack_buckets(bits),
                       len(bits), gname)
        for g, b in zip(got, bits):
            want = P.bits_pack_plain(b)
            what = f"{gname} {tuple(b.shape)}"
            same(0, g, want, f"bits_pack grouped {what}")
            if one:
                same(0, P.bits_pack(b), want, f"bits_pack {what}")
        if gname == "layerwise":            # 4 workers' sign words a bucket
            tables = [[w.reshape(WORKERS, -1) for w in got]]
        else:
            tables = [[make_votes(nv, W, 3100 + 97 * gi + 13 * ti + i, dev)
                       for i, (nv, W) in enumerate(table)]
                      for ti, table in enumerate(votes[gname])]
        if gname == "misaligned":
            tables = [[shift(w) for w in table] for table in tables]
        for words in tables:
            got = launched(S.majority, lambda: S.majority_buckets(words),
                           len(words), gname)
            for g, w in zip(got, words):
                want = S.majority_plain(w)
                what = f"{gname} {tuple(w.shape)}"
                same(1, g, want, f"majority grouped {what}")
                if one:
                    same(1, S.majority(w), want, f"majority {what}")
    torch.cuda.synchronize()
    return tuple(err)


# ---- phase 4: the main path -------------------------------------------------

def main_path_runs(dev):
    """train_cnn runs, each held to exact launch counts: per step, one pack
    and one unpack launch of the codec's kernel family for all its buckets
    (11 layerwise, 1 entire-model); none of any other kernel, and
    none at all for adaptive threshold (its records are not sim-exact, so
    train_step takes the sim path, as the reference's train_cnn always
    does)."""
    from repro_torch import kernels
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import (QSGD, AdaptiveThreshold,
                                              NaturalCompression, RandomK,
                                              SignSGD, TernGrad, TopK)
    from repro_torch.core.granularity import Granularity
    from repro_torch.experiment import train_cnn
    import torch
    topk = TopK(ratio=SPARSE_RATIO)
    # launches a step: a step encodes every bucket in one call, then
    # decodes every bucket in one call. The fused QSGD, TernGrad and
    # signSGD codecs pack all their buckets (11 <= MAX_BUCKETS) in one
    # launch and unpack them in one (qsgd_pack_buckets /
    # qsgd_unpack_buckets, terngrad_pack_buckets / terngrad_unpack_buckets,
    # sign_pack_buckets / sign_unpack_buckets); the natural and sparse
    # codecs pack and unpack all their buckets in one launch each
    # (fields_pack_buckets / fields_unpack_buckets); an entire-model step
    # has one bucket. Over STEPS = 20 steps: QSGD layerwise qsgd_pack
    # 1 x 20 = 20 and qsgd_unpack 1 x 20 = 20, QSGD entire-model 20 / 20;
    # TernGrad layerwise terngrad_pack 1 x 20 = 20 and terngrad_unpack
    # 1 x 20 = 20; signSGD layerwise sign_pack 20 and sign_unpack 20;
    # natural, top-k and random-k layerwise and top-k entire-model 20
    # fields_pack and 20 fields_unpack each
    fields = {"fields_pack": 1, "fields_unpack": 1}
    runs = [("qsgd16_layerwise", QSGD(levels=MAIN_LEVELS), "layerwise",
             {"qsgd_pack": 1, "qsgd_unpack": 1}),
            ("qsgd16_entire_model", QSGD(levels=MAIN_LEVELS), "entire_model",
             {"qsgd_pack": 1, "qsgd_unpack": 1}),
            ("terngrad_layerwise", TernGrad(), "layerwise",
             {"terngrad_pack": 1, "terngrad_unpack": 1}),
            ("signsgd_layerwise", SignSGD(), "layerwise",
             {"sign_pack": 1, "sign_unpack": 1}),
            ("natural_layerwise", NaturalCompression(), "layerwise", fields),
            ("topk1_layerwise", topk, "layerwise", fields),
            ("randomk1_layerwise", RandomK(ratio=SPARSE_RATIO), "layerwise",
             fields),
            ("topk1_entire_model", topk, "entire_model", fields),
            ("adaptive_threshold_layerwise", AdaptiveThreshold(),
             "layerwise", {})]
    out = []
    for name, comp, gran, per_step in runs:
        cfg = CompressionConfig(qw=comp, granularity=Granularity(gran))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        acc, loss = train_cnn("resnet9", cfg, steps=STEPS, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        want = {k: per_step.get(k, 0) * STEPS for k in counts}
        check(counts == want, f"{name}: launches {counts} != {want}")
        check(math.isfinite(loss) and math.isfinite(acc),
              f"{name}: test loss {loss} / accuracy {acc}")
        print(f"main path {name}: {STEPS} steps in {secs:.3f} s, test "
              f"loss {loss:.6f}, test accuracy {acc:.4f}, launches {counts}",
              flush=True)
        out.append({"run": name, "steps": STEPS, "seconds": secs,
                    "test_loss": loss, "test_accuracy": acc,
                    "launches": counts})
    return out


def check_step_buffers(dev):
    """One resnet9 step's real wire buffers, built through the kernels,
    against buffers assembled from the plain versions on the same worker
    gradients, norms and keys; then one EF aggregation through the kernels
    against the sim path."""
    import torch
    from repro_torch import random as R
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.convert import tree_map
    from repro_torch.core import wire
    from repro_torch.core.aggregation import (CompressionConfig,
                                              aggregate_simulated_workers)
    from repro_torch.core.compressors import (QSGD, NaturalCompression,
                                              SignSGD, TernGrad, TopK)
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.core.schedule import build_schedule
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.experiment import worker_grads
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import terngrad as T
    from repro_torch.kernels.ref import words_to_i32
    from repro_torch.models.cnn import init_cnn
    key = R.key(0)
    params = init_cnn(RESNET9, key, device=dev)
    batch = classification_batch(R.fold_in(key, 0), 64, device=dev)
    wg, _ = worker_grads(RESNET9, params, batch, WORKERS)
    wkeys = R.fold_in(key[None], torch.arange(WORKERS))
    n_msgs = 0
    for comp, gran in ((QSGD(levels=MAIN_LEVELS), "layerwise"),
                       (QSGD(levels=MAIN_LEVELS), "entire_model"),
                       (TernGrad(), "layerwise")):
        codec = wire.wire_codec(comp)
        plan = build_plan(params, stacked_mask(params), Granularity(gran))
        sched = build_schedule(plan, 0.0)
        _, bufs = wire.execute_schedule_wire(sched, codec, wg, wkeys)
        leaves, _ = plan._inputs(wg, wkeys)
        flat = plan._flat(leaves) if plan.needs_flat else None
        keys = plan._keys(wkeys, dev)
        for msg, layout, buf in zip(sched.messages,
                                    wire.message_layouts(sched, codec), bufs):
            rows = []
            for bi in msg.bucket_ids:
                b = plan.buckets[bi]
                x = plan._gather_runs(leaves, flat, b).contiguous()
                kw = words_to_i32(plan._bucket_keys(keys, b))
                k0, k1 = kw[:, 0].contiguous(), kw[:, 1].contiguous()
                if isinstance(comp, QSGD):
                    stat = torch.linalg.vector_norm(x, dim=1) + 1e-12
                    words = Q.qsgd_pack_plain(x, k0, k1, stat, comp.levels,
                                              comp.entry_bits)
                else:
                    stat = x.abs().amax(dim=1) + 1e-12
                    words = T.terngrad_pack_plain(x, k0, k1, stat)
                rows.append(torch.cat([stat[:, None].view(torch.uint8),
                                       words.view(torch.uint8)], dim=1)
                            .reshape(WORKERS, -1))
            want = wire._message_buffer(layout, rows)
            check(bitwise_equal(buf, want),
                  f"{comp.name} {gran}: message buffer != plain build")
            n_msgs += 1
    # no statistic enters these codecs, so the whole path run on the CPU
    # (plain versions) must give the card's bytes
    wg_cpu = tree_map(lambda g: g.cpu(), wg)
    for comp, gran in ((SignSGD(), "layerwise"),
                       (NaturalCompression(), "layerwise"),
                       (TopK(ratio=SPARSE_RATIO), "layerwise"),
                       (TopK(ratio=SPARSE_RATIO), "entire_model")):
        codec = wire.wire_codec(comp)
        plan = build_plan(params, stacked_mask(params), Granularity(gran))
        sched = build_schedule(plan, 0.0)
        _, bufs = wire.execute_schedule_wire(sched, codec, wg, wkeys)
        _, cpu_bufs = wire.execute_schedule_wire(sched, codec, wg_cpu, wkeys)
        for buf, want in zip(bufs, cpu_bufs):
            check(bitwise_equal(buf.cpu(), want),
                  f"{comp.name} {gran}: message buffer != CPU build")
            n_msgs += 1
    m0 = tree_map(lambda g: 0.01 * g, wg)
    sm = stacked_mask(params)
    for comp in (QSGD(levels=MAIN_LEVELS), TopK(ratio=SPARSE_RATIO)):
        cfg = CompressionConfig(qw=comp, granularity=Granularity("layerwise"),
                                error_feedback=True)
        a, am = aggregate_simulated_workers(wg, sm, cfg, key, ef_state=m0,
                                            wire=True)
        b, bm = aggregate_simulated_workers(wg, sm, cfg, key, ef_state=m0,
                                            wire=False)
        for k in a:
            check(bitwise_equal(a[k], b[k]) and bitwise_equal(am[k], bm[k]),
                  f"{comp.name} EF aggregation wire != sim at {k}")
    torch.cuda.synchronize()
    return n_msgs


OPTIMIZERS = ({"name": "sgd"}, {"name": "sgd", "weight_decay": 5e-4},
              {"name": "momentum"},
              {"name": "momentum", "nesterov": True, "weight_decay": 5e-4},
              {"name": "adam"}, {"name": "adam", "weight_decay": 5e-4})


def check_optimizers(dev):
    """optim.apply_updates on resnet9's parameters (random weights from
    seed 0, seeded gradients): two steps of each optimizer on the card
    give the CPU's bits (every step is elementwise: the fmas and Adam's
    f64 square root as on the CPU, its bias corrections host scalars).
    -> optimizers checked."""
    import torch
    from repro_torch import random as R
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.models.cnn import init_cnn
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    params = init_cnn(RESNET9, R.key(0), device=dev)
    gen = torch.Generator().manual_seed(3)
    grads = [tree_map(lambda p: torch.randn(p.shape, generator=gen)
                      .to(dev), params) for _ in range(2)]
    for kw in OPTIMIZERS:
        cfg = OptConfig(lr=0.05, **kw)
        sides = []
        for where in (dev, torch.device("cpu")):
            p = tree_map(lambda t: t.to(where), params)
            st = init_opt_state(cfg, p)
            for i, g in enumerate(grads):
                p, st = apply_updates(cfg, p, tree_map(lambda t: t.to(where),
                                                       g), st,
                                      torch.tensor(0.05 * (i + 1)))
            sides.append(torch.cat([t.reshape(-1).cpu()
                                    for t in tree_leaves(p)]))
        check(bool(torch.isfinite(sides[0]).all())
              and bitwise_equal(sides[0], sides[1]),
              f"optimizer {kw}: the card's update != the CPU's")
    return len(OPTIMIZERS)


# ---- phase 5: timing ---------------------------------------------------------

def _median_event_ms(run, count, repeats):
    import torch
    vals = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        vals.append(a.elapsed_time(b) / count)
    vals.sort()
    return vals[len(vals) // 2]


def call_ms(fn, reps=20, repeats=7) -> float:
    """Per call, in ms: median over `repeats` of the CUDA-event time of
    `reps` back-to-back calls issued from Python (what the main path pays:
    includes the host enqueue when a launch is shorter than it)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return _median_event_ms(run, reps, repeats)


def device_ms(fn, reps=20, repeats=7) -> float:
    """Per call, in ms: the same calls captured into one CUDA graph and
    replayed, so the time is the device's alone (no host gaps)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(graph.replay, reps, repeats)


def bounds(kernel: str, n: int, d: int, width: int):
    """(bytes moved, int ops, fp ops, byte-bound ms, op-bound ms) of one
    launch over n units of d elements (fields: d fields per unit; majority:
    n workers of d words): each input read once and each output written
    once over the HBM rate; the integer and fp32 operations over their
    peak rates."""
    from repro_torch.kernels import ops
    if kernel == "majority":
        mv = ops.majority_bytes_moved(n, d)
        int_ops = d * (2 * MAJORITY_PLANES * (n + 1) + 1)
        fp_ops = 0
    else:
        fam, kind = kernel.split("_")
        moved = (ops.pack_bytes_moved if kind == "pack"
                 else ops.unpack_bytes_moved)
        mv = moved(n, d, width, fam)
        per_int, per_fp = ELEMENT_OPS[kernel]
        int_ops = n * d * per_int
        if kernel in HASHING:
            int_ops += n * -(-d // 2) * THREEFRY_INT_OPS
        fp_ops = n * d * per_fp
    nbytes = mv["read"] + mv["write"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (int_ops / INT32_OPS_PER_S + fp_ops / FP32_OPS_PER_S) * 1e3
    return nbytes, int_ops, fp_ops, t_bytes, t_ops


def time_kernels(layer_shapes, em_shape, dev):
    """Rows of device / call / plain times beside the bounds, per kernel,
    shape group and leg: the fields kernels are timed on natural's 9-bit
    code leg (k = d) and on the top-k index leg (k = 1% of d); the bit
    kernels on the signSGD words of the allgather receive leg, the majority
    vote on the 4 workers' sign words of each bucket."""
    import torch
    from repro_torch.kernels import pack as P
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import sign as S
    from repro_torch.kernels import terngrad as T
    rows = []
    groups = {"layerwise_step": layer_shapes, "entire_model_step": [em_shape],
              "stress": [STRESS]}
    for group, shapes in groups.items():
        for si, shape in enumerate(shapes):
            n, d = shape
            x, k0, k1 = make_inputs(shape, 500 + si, dev)
            nrm = torch.linalg.vector_norm(x, dim=1) + 1e-12
            fac = nrm / MAIN_LEVELS
            sc = x.abs().amax(dim=1) + 1e-12
            wq = Q.qsgd_pack(x, k0, k1, nrm, MAIN_LEVELS, MAIN_WIDTH)
            wt = T.terngrad_pack(x, k0, k1, sc)
            ws = S.sign_pack(x)
            k_idx, w_idx = index_leg(d)
            fn = make_fields((n, d), 2**NATURAL_WIDTH, 600 + si, dev)
            fi = make_fields((n, k_idx), d, 700 + si, dev)
            wn = P.fields_pack(fn, NATURAL_WIDTH)
            wi = P.fields_pack(fi, w_idx)
            bi = (x >= 0).to(torch.int32)
            wm = ws.reshape(WORKERS, -1)            # each worker's words
            cases = [
                ("qsgd_pack", "", d, MAIN_WIDTH,
                 lambda: Q.qsgd_pack(x, k0, k1, nrm, MAIN_LEVELS, MAIN_WIDTH),
                 lambda: Q.qsgd_pack_plain(x, k0, k1, nrm, MAIN_LEVELS,
                                           MAIN_WIDTH)),
                ("qsgd_unpack", "", d, MAIN_WIDTH,
                 lambda: Q.qsgd_unpack(wq, fac, d, MAIN_LEVELS, MAIN_WIDTH),
                 lambda: Q.qsgd_unpack_plain(wq, fac, d, MAIN_LEVELS,
                                             MAIN_WIDTH)),
                ("terngrad_pack", "", d, 2,
                 lambda: T.terngrad_pack(x, k0, k1, sc),
                 lambda: T.terngrad_pack_plain(x, k0, k1, sc)),
                ("terngrad_unpack", "", d, 2,
                 lambda: T.terngrad_unpack(wt, sc, d),
                 lambda: T.terngrad_unpack_plain(wt, sc, d)),
                ("sign_pack", "", d, 1, lambda: S.sign_pack(x),
                 lambda: S.sign_pack_plain(x)),
                ("sign_unpack", "", d, 1, lambda: S.sign_unpack(ws, d),
                 lambda: S.sign_unpack_plain(ws, d)),
                ("fields_pack", "natural", d, NATURAL_WIDTH,
                 lambda: P.fields_pack(fn, NATURAL_WIDTH),
                 lambda: P.fields_pack_plain(fn, NATURAL_WIDTH)),
                ("fields_unpack", "natural", d, NATURAL_WIDTH,
                 lambda: P.fields_unpack(wn, d, NATURAL_WIDTH),
                 lambda: P.fields_unpack_plain(wn, d, NATURAL_WIDTH)),
                ("fields_pack", "index", k_idx, w_idx,
                 lambda: P.fields_pack(fi, w_idx),
                 lambda: P.fields_pack_plain(fi, w_idx)),
                ("fields_unpack", "index", k_idx, w_idx,
                 lambda: P.fields_unpack(wi, k_idx, w_idx),
                 lambda: P.fields_unpack_plain(wi, k_idx, w_idx)),
                ("bits_pack", "", d, 1, lambda: P.bits_pack(bi),
                 lambda: P.bits_pack_plain(bi)),
                ("bits_unpack", "", d, 1, lambda: P.bits_unpack(ws, d),
                 lambda: P.bits_unpack_plain(ws, d)),
                ("majority", "", wm.shape[1], 1, lambda: S.majority(wm),
                 lambda: S.majority_plain(wm)),
            ]
            for name, leg, k, width, kern, plain in cases:
                rn = WORKERS if name == "majority" else n
                nbytes, iops, fops, t_b, t_o = bounds(name, rn, k, width)
                rows.append({
                    "group": group, "kernel": name, "leg": leg,
                    "shape": [rn, k], "width": width, "ms": device_ms(kern),
                    "call_ms": call_ms(kern),
                    "plain_ms": device_ms(plain, reps=3, repeats=3),
                    "bytes": nbytes, "int_ops": iops, "fp_ops": fops,
                    "bytes_ms": t_b, "ops_ms": t_o, "bound_ms": max(t_b, t_o),
                    "bound_by": "bytes" if t_b >= t_o else "operations"})
    rows += time_grouped_wire(layer_shapes, dev)
    rows += time_grouped_fields(layer_shapes, dev)
    return rows


def grouped_row(kernel, leg, width, buckets, kern, plain):
    """A row of group layerwise_step_grouped: `kern`, ONE grouped launch
    over `buckets` ((n, d, width) each) as a step runs it, beside `plain`,
    the per-bucket plain loop; shape [units, elements], bounds the sums of
    the buckets' bytes and operations."""
    parts = [bounds(kernel, n, d, w) for n, d, w in buckets]
    nbytes, iops, fops = (sum(p[i] for p in parts) for i in range(3))
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = (iops / INT32_OPS_PER_S + fops / FP32_OPS_PER_S) * 1e3
    return {"group": "layerwise_step_grouped", "kernel": kernel, "leg": leg,
            "shape": [sum(n for n, _, _ in buckets),
                      sum(n * d for n, d, _ in buckets)],
            "width": width, "ms": device_ms(kern), "call_ms": call_ms(kern),
            "plain_ms": device_ms(plain, reps=3, repeats=3),
            "bytes": nbytes, "int_ops": iops, "fp_ops": fops,
            "bytes_ms": t_b, "ops_ms": t_o, "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def time_grouped_wire(layer_shapes, dev):
    """Rows of group layerwise_step_grouped for the QSGD, TernGrad and
    sign packs and unpacks, the bit pack and unpack and the majority vote:
    ONE launch over the 11 layerwise buckets x 4 workers
    (qsgd_pack_buckets, qsgd_unpack_buckets at width 6,
    terngrad_pack_buckets, terngrad_unpack_buckets, sign_pack_buckets,
    sign_unpack_buckets, bits_pack_buckets on the signs, the per-unit
    signSGD encode, bits_unpack_buckets on the sign words, the allgather
    receive leg's decode, and majority_buckets on each bucket's sign
    words as 4 workers'), on the same inputs as time_kernels' one-bucket
    rows."""
    import torch
    from repro_torch.kernels import pack as P
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import sign as S
    from repro_torch.kernels import terngrad as T
    ins = [make_inputs(s, 500 + si, dev) for si, s in enumerate(layer_shapes)]
    xs = [x for x, _, _ in ins]
    k0s = [k0 for _, k0, _ in ins]
    k1s = [k1 for _, _, k1 in ins]
    nrms = [torch.linalg.vector_norm(x, dim=1) + 1e-12 for x in xs]
    facs = [nrm / MAIN_LEVELS for nrm in nrms]
    dims = [d for _, d in layer_shapes]
    words = Q.qsgd_pack_buckets(xs, k0s, k1s, nrms, MAIN_LEVELS, MAIN_WIDTH)
    buckets = [(n, d, MAIN_WIDTH) for n, d in layer_shapes]
    scs = [x.abs().amax(dim=1) + 1e-12 for x in xs]
    terns = T.terngrad_pack_buckets(xs, k0s, k1s, scs)
    signs = S.sign_pack_buckets(xs)
    bis = [(x >= 0).to(torch.int32) for x in xs]
    wms = [w.reshape(WORKERS, -1) for w in signs]
    return [
        grouped_row("qsgd_pack", f"{len(xs)} buckets", MAIN_WIDTH, buckets,
                    lambda: Q.qsgd_pack_buckets(xs, k0s, k1s, nrms,
                                                MAIN_LEVELS, MAIN_WIDTH),
                    lambda: [Q.qsgd_pack_plain(x, k0, k1, nrm, MAIN_LEVELS,
                                               MAIN_WIDTH)
                             for x, k0, k1, nrm in zip(xs, k0s, k1s, nrms)]),
        grouped_row("qsgd_unpack", f"{len(xs)} buckets", MAIN_WIDTH, buckets,
                    lambda: Q.qsgd_unpack_buckets(words, facs, dims,
                                                  MAIN_LEVELS, MAIN_WIDTH),
                    lambda: [Q.qsgd_unpack_plain(w, f, d, MAIN_LEVELS,
                                                 MAIN_WIDTH)
                             for w, f, d in zip(words, facs, dims)]),
        grouped_row("terngrad_pack", f"{len(xs)} buckets", 2,
                    [(n, d, 2) for n, d in layer_shapes],
                    lambda: T.terngrad_pack_buckets(xs, k0s, k1s, scs),
                    lambda: [T.terngrad_pack_plain(x, k0, k1, sc)
                             for x, k0, k1, sc in zip(xs, k0s, k1s, scs)]),
        grouped_row("terngrad_unpack", f"{len(xs)} buckets", 2,
                    [(n, d, 2) for n, d in layer_shapes],
                    lambda: T.terngrad_unpack_buckets(terns, scs, dims),
                    lambda: [T.terngrad_unpack_plain(w, sc, d)
                             for w, sc, d in zip(terns, scs, dims)]),
        grouped_row("sign_pack", f"{len(xs)} buckets", 1,
                    [(n, d, 1) for n, d in layer_shapes],
                    lambda: S.sign_pack_buckets(xs),
                    lambda: [S.sign_pack_plain(x) for x in xs]),
        grouped_row("sign_unpack", f"{len(xs)} buckets", 1,
                    [(n, d, 1) for n, d in layer_shapes],
                    lambda: S.sign_unpack_buckets(signs, dims),
                    lambda: [S.sign_unpack_plain(w, d)
                             for w, d in zip(signs, dims)]),
        grouped_row("bits_pack", f"{len(xs)} buckets", 1,
                    [(n, d, 1) for n, d in layer_shapes],
                    lambda: P.bits_pack_buckets(bis),
                    lambda: [P.bits_pack_plain(b) for b in bis]),
        grouped_row("bits_unpack", f"{len(xs)} buckets", 1,
                    [(n, d, 1) for n, d in layer_shapes],
                    lambda: P.bits_unpack_buckets(signs, dims),
                    lambda: [P.bits_unpack_plain(w, d)
                             for w, d in zip(signs, dims)]),
        grouped_row("majority", f"{len(xs)} buckets", 1,
                    [(WORKERS, w.shape[1], 1) for w in wms],
                    lambda: S.majority_buckets(wms),
                    lambda: [S.majority_plain(w) for w in wms])]


def time_grouped_fields(layer_shapes, dev):
    """Rows of group layerwise_step_grouped for the field kernels: ONE
    fields_pack and ONE fields_unpack launch over the 11 layerwise buckets
    x 4 workers (fields_pack_buckets / fields_unpack_buckets), as a step
    runs them, for natural's 9-bit legs (leg natural) and the top-k(1%)
    index legs (leg index, each bucket at its own width: width 0), on the
    same inputs as time_kernels' one-bucket rows, beside the per-bucket
    plain loop; shape [units, fields], bounds the sums of the buckets'."""
    from repro_torch.kernels import pack as P
    rows = []
    legs = {"natural": [((n, d), NATURAL_WIDTH, 2**NATURAL_WIDTH, 600 + si)
                        for si, (n, d) in enumerate(layer_shapes)],
            "index": [((n, index_leg(d)[0]), index_leg(d)[1], d, 700 + si)
                      for si, (n, d) in enumerate(layer_shapes)]}
    for leg, buckets in legs.items():
        fs = [make_fields(shape, bound, seed, dev)
              for shape, _, bound, seed in buckets]
        ws = [w for _, w, _, _ in buckets]
        ks = [shape[1] for shape, _, _, _ in buckets]
        words = P.fields_pack_buckets(fs, ws)
        sized = [(shape[0], shape[1], w) for shape, w, _, _ in buckets]
        width = ws[0] if leg == "natural" else 0
        rows += [
            grouped_row("fields_pack", leg, width, sized,
                        lambda: P.fields_pack_buckets(fs, ws),
                        lambda: [P.fields_pack_plain(f, w)
                                 for f, w in zip(fs, ws)]),
            grouped_row("fields_unpack", leg, width, sized,
                        lambda: P.fields_unpack_buckets(words, ks, ws),
                        lambda: [P.fields_unpack_plain(x, k, w)
                                 for x, k, w in zip(words, ks, ws)])]
    return rows


def natural_host_ms(layer_shapes, dev):
    """Per call, in ms (call_ms: host enqueue included): one layerwise
    step's natural encode and decode through the codec, grouped
    (encode_buckets / decode_buckets: one fields_pack and one
    fields_unpack launch) and per bucket (encode_batch / decode_batch, one
    launch a bucket each), the exponent draws included in the encode."""
    from repro_torch import random as R
    from repro_torch.core.compressors import NaturalCompression
    from repro_torch.core.wire import wire_codec
    import torch
    codec = wire_codec(NaturalCompression())
    g = torch.Generator().manual_seed(1500)
    xs = [torch.randn(s, generator=g).to(dev) for s in layer_shapes]
    ks = [R.fold_in(R.key(i)[None], torch.arange(s[0])).to(dev)
          for i, s in enumerate(layer_shapes)]
    dims = [d for _, d in layer_shapes]
    pays = codec.encode_buckets(xs, ks)
    return {
        "encode_grouped": call_ms(lambda: codec.encode_buckets(xs, ks)),
        "encode_per_bucket": call_ms(lambda: [codec.encode_batch(x, k)
                                              for x, k in zip(xs, ks)]),
        "decode_grouped": call_ms(lambda: codec.decode_buckets(pays, dims)),
        "decode_per_bucket": call_ms(lambda: [codec.decode_batch(p, d)
                                              for p, d in zip(pays, dims)])}


def encode_host_ms(layer_shapes, dev):
    """Per call, in ms (call_ms: host enqueue included): one layerwise
    step's QSGD encode through ops.qsgd_pack_units_buckets (one pack
    launch) and through ops.qsgd_pack_units per bucket (11), the norms and
    key splits included in both."""
    from repro_torch.kernels import ops
    from repro_torch import random as R
    import torch
    g = torch.Generator().manual_seed(1400)
    xs = [torch.randn(s, generator=g).to(dev) for s in layer_shapes]
    ks = [R.fold_in(R.key(i)[None], torch.arange(s[0])).to(dev)
          for i, s in enumerate(layer_shapes)]
    return {
        "grouped": call_ms(lambda: ops.qsgd_pack_units_buckets(
            xs, ks, MAIN_LEVELS, MAIN_WIDTH)),
        "per_bucket": call_ms(lambda: [ops.qsgd_pack_units(
            x, k, MAIN_LEVELS, MAIN_WIDTH) for x, k in zip(xs, ks)])}


def compress_bounds(kernel: str, rows: int, cols: int, elt: int = 4,
                    entries=None):
    """(bytes moved, int ops, fp ops, byte-bound ms, op-bound ms) of one
    top-k or RMSNorm launch over (rows, cols): each reads and writes `elt`
    B an entry (f32: 4), RMSNorm also gamma (4 B a column). `entries`: the
    live entries of a flat top-k input, whose tail row is padded in the
    kernel: its bytes count those alone, its operations the whole tile."""
    nbytes = 2 * elt * (rows * cols if entries is None else entries)
    if kernel == "rmsnorm":
        nbytes += 4 * cols
    per_int, per_fp = COMPRESS_OPS[kernel]
    return _bounded(nbytes, rows * cols * per_int, rows * cols * per_fp)


def quant_bounds(kernel: str, buckets):
    """The same for one grouped QSGD / TernGrad compress-only launch over
    (n, d, draw) buckets: x read and the output written once (8 B an
    element), two key words and the statistic read once a unit (12 B),
    one threefry hash for each of the n * min(d, draw / 2) counter pairs
    below d, and the quantizer's fp32 operations an element."""
    elems = sum(n * d for n, d, _ in buckets)
    hashes = sum(n * min(d, N // 2) for n, d, N in buckets)
    per_int, per_fp = COMPRESS_OPS[kernel]
    return _bounded(8 * elems + 12 * sum(n for n, _, _ in buckets),
                    hashes * THREEFRY_INT_OPS + elems * per_int,
                    elems * per_fp)


def _bounded(nbytes, int_ops, fp_ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (int_ops / INT32_OPS_PER_S + fp_ops / FP32_OPS_PER_S) * 1e3
    return nbytes, int_ops, fp_ops, t_bytes, t_ops


def time_compress_kernels(unit_shapes, total, dev):
    """Rows like time_kernels' for the compress-only kernels at phase 8's
    shapes: QSGD(16) and TernGrad as ONE grouped launch over the 11
    buckets of one layerwise plan_compress call (group
    compress_layerwise), over its entire-model bucket
    (compress_entire_model), and in the whole-input calls on the flat
    gradient and on 2**20 entries (one unit, the whole-input draw:
    compress_flat, compress_micro), each on keys (the uniforms drawn in
    the kernel) beside the plain twins per bucket; QSGD(16) on both
    walks, forced, from a layerwise call to a whole input of 3 * 2**18
    entries (compress_walk, `auto` the walk compress_walk picks); top-k
    (k=5) as topk_mask_flat in the same two whole-input calls, and on
    TOPK_ROWS rows in f32 and bf16 and on 2**20 entries of sparse rows
    (topk_rows); RMSNorm at RMS_SHAPE in
    bf16 and f32, beside torch.nn.functional.rms_norm (`library_ms`) and a
    copy of x (`copy_ms`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import terngrad as T
    from repro_torch.kernels import topk_mask as K
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    rows = []

    def add(group, kernel, shape, bounded, kern, plain, library=None,
            **extra):
        nbytes, iops, fops, t_b, t_o = bounded
        rows.append({**extra,
            "group": group, "kernel": kernel, "leg": "", "shape": list(shape),
            "width": 0, "ms": device_ms(kern), "call_ms": call_ms(kern),
            "plain_ms": device_ms(plain, reps=3, repeats=3),
            "library_ms": None if library is None else device_ms(library),
            "bytes": nbytes, "int_ops": iops, "fp_ops": fops,
            "bytes_ms": t_b, "ops_ms": t_o, "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"})

    cases = (("compress_layerwise", unit_shapes, UNIT_DRAW),
             ("compress_entire_model", [(1, total)], UNIT_DRAW),
             ("compress_flat", [(1, total)], WHOLE_DRAW),
             ("compress_micro", [(1, MICRO)], WHOLE_DRAW))
    for ci, (group, shapes, granule) in enumerate(cases):
        ins = [quant_inputs(s, 1000 + 16 * ci + i, dev)
               for i, s in enumerate(shapes)]
        xs = [c[0] for c in ins]
        k0s, k1s = [c[1] for c in ins], [c[2] for c in ins]
        nrms, scs = [c[3] for c in ins], [c[4] for c in ins]
        draws = [ops.draw_length(d, granule) for _, d in shapes]
        buckets = [(n, d, N) for (n, d), N in zip(shapes, draws)]
        hashes = sum(n * min(d, N // 2) for n, d, N in buckets)
        info = {"buckets": len(shapes), "hashes": hashes,
                "per_thread": Q.compress_walk(hashes, dev)}
        shp = (sum(n for n, _ in shapes), sum(n * d for n, d in shapes))
        add(group, "qsgd_compress_rows", shp,
            quant_bounds("qsgd_compress_rows", buckets),
            lambda: Q.qsgd_compress_buckets(xs, k0s, k1s, nrms, draws,
                                            MAIN_LEVELS),
            lambda: Q.qsgd_compress_buckets_plain(xs, k0s, k1s, nrms, draws,
                                                  MAIN_LEVELS), **info)
        add(group, "terngrad_compress_rows", shp,
            quant_bounds("terngrad_compress_rows", buckets),
            lambda: T.terngrad_compress_buckets(xs, k0s, k1s, scs, draws),
            lambda: T.terngrad_compress_buckets_plain(xs, k0s, k1s, scs,
                                                      draws), **info)
        if granule == WHOLE_DRAW:
            # top-k as blockwise_topk calls it: the flat input, its tail
            # row padded in the kernel (no padded lane is loaded or stored)
            xf = xs[0].reshape(-1)
            rows_ = -(-xf.numel() // 512)
            add(group, "topk_mask", (rows_, 512),
                compress_bounds("topk_mask", rows_, 512,
                                entries=xf.numel()),
                lambda: K.topk_mask_flat(xf, 5),
                lambda: K.topk_mask_flat_plain(xf, 5))
    # group compress_walk: the QSGD(16) grouped call on both walks, forced,
    # from a layerwise call's 61,050 pairs to a whole input's 393,216 (the
    # evidence for compress_walk's switch at one wave of resident threads)
    walks = (("layerwise", unit_shapes, UNIT_DRAW),
             ("entire_model", [(1, total)], UNIT_DRAW),
             *((f"whole_{d}", [(1, d)], WHOLE_DRAW)
               for d in (1 << 18, 1 << 19, MICRO, 3 << 18)))
    for ci, (label, shapes, granule) in enumerate(walks):
        ins = [quant_inputs(s, 1200 + 16 * ci + i, dev)
               for i, s in enumerate(shapes)]
        xs = [c[0] for c in ins]
        k0s, k1s = [c[1] for c in ins], [c[2] for c in ins]
        nrms = [c[3] for c in ins]
        draws = [ops.draw_length(d, granule) for _, d in shapes]
        buckets = [(n, d, N) for (n, d), N in zip(shapes, draws)]
        hashes = sum(n * min(d, N // 2) for n, d, N in buckets)
        auto = Q.compress_walk(hashes, dev)
        for pt in (1, 4):
            with walk(pt):
                add("compress_walk", "qsgd_compress_rows",
                    (sum(n for n, _ in shapes),
                     sum(n * d for n, d in shapes)),
                    quant_bounds("qsgd_compress_rows", buckets),
                    lambda: Q.qsgd_compress_buckets(xs, k0s, k1s, nrms,
                                                    draws, MAIN_LEVELS),
                    lambda: Q.qsgd_compress_buckets_plain(
                        xs, k0s, k1s, nrms, draws, MAIN_LEVELS),
                    input=label, hashes=hashes, per_thread=pt, auto=auto)
    # group topk_rows: top-k (k=5) on TOPK_ROWS rows of 512 in f32 and
    # bf16 (leg), the one walk the kernel keeps; and on 2**20 entries of
    # sparse rows (leg sparse), the kernel's slowest case
    for ri, rows_ in enumerate(TOPK_ROWS):
        x32 = compress_inputs((rows_, 512), 1300 + ri, dev).reshape(-1)
        legs = [(x32, "f32"), (x32.to(torch.bfloat16), "bf16")]
        if rows_ * 512 == MICRO:
            legs.append((topk_sparse_inputs(rows_, 1310, dev), "sparse"))
        for x, leg in legs:
            add("topk_rows", "topk_mask", (rows_, 512),
                compress_bounds("topk_mask", rows_, 512, x.element_size()),
                lambda: K.topk_mask_flat(x, 5),
                lambda: K.topk_mask_flat_plain(x, 5))
            rows[-1]["leg"] = leg
    for dtype, group in ((torch.bfloat16, "rmsnorm_bf16"),
                         (torch.float32, "rmsnorm_f32")):
        x, gamma = rmsnorm_inputs(dtype, 1100, dev)
        g_lib = gamma.to(dtype)
        y = torch.empty_like(x)
        # copy_ms: x copied into y, the same bytes less gamma (information:
        # what this card's copy reaches for the read + write stream)
        add(group, "rmsnorm", RMS_SHAPE,
            compress_bounds("rmsnorm", *RMS_SHAPE, x.element_size()),
            lambda: rmsnorm(x, gamma), lambda: rmsnorm_plain(x, gamma),
            library=lambda: F.rms_norm(x, (RMS_SHAPE[1],), g_lib, 1e-5),
            copy_ms=device_ms(lambda: y.copy_(x)))
    return rows


def profile_steps(dev, qw, steps=5):
    """torch.profiler over `steps` layerwise train steps with worker
    compressor `qw` on resnet9 (after 2 warm-up steps): wall time, device
    busy time (sum of the device events, one stream), idle share and the
    top device ops."""
    import torch
    from repro_torch import random as R
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.convert import tree_map
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.experiment import train_step
    from repro_torch.models.cnn import init_cnn
    key = R.key(1)
    params = init_cnn(RESNET9, key, device=dev)
    vel = tree_map(torch.zeros_like, params)
    comp = CompressionConfig(qw=qw)
    batches = [classification_batch(R.fold_in(key, i), 64, device=dev)
               for i in range(steps + 2)]
    lr = torch.tensor(0.01, device=dev)

    def step(i):
        nonlocal params, vel
        params, vel, _ = train_step(RESNET9, comp, params, vel, batches[i],
                                    R.fold_in(key, 10_000 + i), lr)
    for i in range(2):
        step(i)
    return {"compressor": qw.name,
            **device_profile(lambda: [step(i) for i in range(2, steps + 2)],
                             steps)}


def device_profile(run, steps: int, match=()):
    """torch.profiler over run() (`steps` steps, after the caller's warm-up):
    wall and device-busy ms a step (the sum of the device events, one
    stream), the device's idle share and the top device ops; with `match`,
    the device ms a step of the events whose names hold each substring."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "matched_ms": {m: sum(t for n, t in by_name.items() if m in n)
                           / steps for m in match},
            "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
            "device_events": sum(1 for e in prof.events()
                                 if e.device_type == DeviceType.CUDA),
            "top_device_ms_per_step": [(n[:80], t / steps) for n, t in top]}

# ---- phase 9: the LM train path (phi4-mini at full width) -------------------

# the seven attention archs whose smoke configs phase 9(a) runs
LM_ARCHS = ("llama3-405b", "phi4-mini-3.8b", "granite-20b", "minicpm3-4b",
            "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
            "internvl2-2b")
# phase 9(b)-(d): 4 workers of 2 sequences of 512 tokens, 3 steps a run,
# at an LR small enough for phi4-mini's random full-width init
LM_BATCH, LM_SEQ, LM_STEPS, LM_LR = 8, 512, 3, 0.01
# positions of a unit the plain QSGD pack and unpack take at a time
LM_SPAN = 1 << 23


def lm_full_width():
    """phi4-mini-3.8b at its published width, depth cut to 2 layers, bf16:
    d_model 3072, vocab 200,064, 24 heads over 8 kv heads of 128, d_ff
    8192 (1,430,535,168 parameters)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("phi4-mini-3.8b"), n_layers=2)


def lm_runs_spec():
    """(name, worker compressor, granularity, launches a step) of phase
    9(b). A step encodes every bucket in one call and decodes them in one:
    QSGD's 12 layerwise buckets (21 units, <= MAX_BUCKETS) and its one
    entire-model bucket pack in 1 qsgd_pack and unpack in 1 qsgd_unpack
    launch; top-k's index legs in 1 fields_pack and 1 fields_unpack."""
    from repro_torch.core.compressors import QSGD, TopK
    qsgd = {"qsgd_pack": 1, "qsgd_unpack": 1}
    return [("qsgd16_layerwise", QSGD(levels=MAIN_LEVELS), "layerwise", qsgd),
            ("qsgd16_entire_model", QSGD(levels=MAIN_LEVELS), "entire_model",
             qsgd),
            ("topk1_layerwise", TopK(ratio=SPARSE_RATIO), "layerwise",
             {"fields_pack": 1, "fields_unpack": 1})]


def lm_token_batches(vocab: int, dev, seed: int = 1):
    """Batches of LM_BATCH uniform random sequences of LM_SEQ + 1 tokens
    on the card (targets the next token): at vocab 200,064 the Markov
    chain of lm_batches would need a (vocab, vocab) matrix, 160 GB in f32."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    while True:
        s = torch.randint(0, vocab, (LM_BATCH, LM_SEQ + 1), generator=g,
                          device=dev)
        yield {"tokens": s[:, :-1], "targets": s[:, 1:]}


def _free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def check_lm_smoke(dev):
    """9(a): the seven attention archs' smoke configs, Model.loss and every
    gradient leaf on the card against the port's CPU run on the same params
    and batch: the loss within 1e-5 relative and each leaf within 1e-4 of
    its max |g| (the f32 tolerances the CPU tests hold against the
    reference; TF32 and reduced-precision bf16 reductions off)."""
    import torch
    from repro_torch import random as R
    from repro_torch.configs import get_smoke
    from repro_torch.convert import tree_leaves, tree_paths, tree_unflatten
    from repro_torch.data import lm_batches, patches_stub
    from repro_torch.models import DistConfig, Model
    rows = []
    for arch in LM_ARCHS:
        cfg = get_smoke(arch)
        m = Model(cfg, DistConfig())
        params = m.init(R.key(0), device="cpu")
        batch = next(lm_batches(cfg.vocab, 4, 24, seed=1, device="cpu"))
        if cfg.arch_type == "vlm":
            batch["patch_embeds"] = patches_stub(
                R.key(3), 4, cfg.frontend_seq, cfg.d_model, device="cpu")
        out = []
        for d in ("cpu", dev):
            leaves = [l.to(d).requires_grad_(True)
                      for l in tree_leaves(params)]
            loss = m.loss(tree_unflatten(tree_paths(params), leaves),
                          {k: v.to(d) for k, v in batch.items()}, None)
            grads = torch.autograd.grad(loss, leaves)
            out.append((loss.item(), [g.cpu() for g in grads]))
        (l_cpu, g_cpu), (l_card, g_card) = out
        rel = abs(l_card - l_cpu) / abs(l_cpu)
        err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  for a, b in zip(g_card, g_cpu))
        check(math.isfinite(l_card) and rel <= 1e-5 and err <= 1e-4,
              f"LM smoke {arch}: loss {l_card} vs CPU {l_cpu} ({rel:.2e}), "
              f"gradient error {err:.2e} of max |g|")
        rows.append({"arch": arch, "loss_card": l_card, "loss_cpu": l_cpu,
                     "loss_rel_err": rel, "grad_err_of_max": err,
                     "leaves": len(g_card)})
    return rows


def lm_runs(dev):
    """9(b): train_lm at phi4-mini's full width (lm_full_width), 4 workers,
    LM_STEPS steps each of QSGD(16) layerwise and entire-model and top-k(1%)
    layerwise: exact launches, finite losses, seconds and peak memory."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.granularity import Granularity
    from repro_torch.experiment import train_lm
    cfg = lm_full_width()
    out = []
    for name, comp, gran, per_step in lm_runs_spec():
        c = CompressionConfig(qw=comp, granularity=Granularity(gran))
        _free_card()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        first, last, secs, params = train_lm(
            cfg, c, steps=LM_STEPS, workers=WORKERS, lr=LM_LR, batch=LM_BATCH,
            seq=LM_SEQ, seed=0, device=dev,
            data=lm_token_batches(cfg.vocab, dev))
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = kernels.launch_counts()
        want = {k: per_step.get(k, 0) * LM_STEPS for k in counts}
        check(counts == want, f"LM {name}: launches {counts} != {want}")
        check(math.isfinite(first) and math.isfinite(last),
              f"LM {name}: losses {first} -> {last}")
        peak = torch.cuda.max_memory_allocated(dev)
        del params
        print(f"LM full width {name}: {LM_STEPS} steps in {secs:.3f} s "
              f"({secs / LM_STEPS:.3f} s a step; init and data "
              f"{total - secs:.3f} s), loss {first:.6f} -> {last:.6f}, "
              f"peak {peak / 2**30:.2f} GiB, launches {counts}", flush=True)
        out.append({"run": name, "steps": LM_STEPS, "seconds": secs,
                    "seconds_per_step": secs / LM_STEPS,
                    "setup_seconds": total - secs, "first_loss": first,
                    "last_loss": last, "peak_bytes": peak,
                    "launches": counts})
    return out


def _largest_bucket(plan, sched, codec, bufs):
    """(bucket, its (B * n, nbytes) payload rows in the step's buffers) of
    the plan's bucket with the most entries a unit."""
    from repro_torch.core.wire import _bucket_region, message_layouts
    bi = max(range(len(plan.buckets)), key=lambda i: plan.buckets[i].dim)
    for msg, layout, buf in zip(sched.messages,
                                message_layouts(sched, codec), bufs):
        if bi in msg.bucket_ids:
            j = msg.bucket_ids.index(bi)
            b = plan.buckets[bi]
            return b, _bucket_region(buf, layout, j, b.n)
    fail(f"bucket {bi} in no message")


def _timed(fn):
    """(fn(), device-synchronized seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _big_row(kernel, leg, n, d, width, ms, plain_ms):
    nbytes, iops, fops, t_b, t_o = bounds(kernel, n, d, width)
    return {"group": "lm_full_width", "kernel": kernel, "leg": leg,
            "shape": [n, d], "width": width, "ms": ms, "call_ms": ms,
            "plain_ms": plain_ms, "bytes": nbytes, "int_ops": iops,
            "fp_ops": fops, "bytes_ms": t_b, "ops_ms": t_o,
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def check_qsgd_unit(name, x, keys, rows, dev):
    """The QSGD(16) payload rows a step built with the kernel (4-byte norm,
    then the words) against the plain pack over LM_SPAN-position spans of
    the same units, norms and keys, bitwise; the kernel's decode against
    the plain decode the same way. -> (timing rows, spans checked)."""
    import torch
    from repro_torch.core.wire import _split
    from repro_torch.kernels import ops
    from repro_torch.kernels import qsgd as Q
    n, d = x.shape
    nrm, words = _split(rows)
    check(bitwise_equal(nrm, torch.linalg.vector_norm(x, dim=1) + 1e-12),
          f"{name}: payload norms != vector_norm + 1e-12")
    k0, k1 = ops._split_keys(keys, dev)
    wpc = MAIN_WIDTH                     # words a 32-position chunk spans

    def plain_pack():
        for lo in range(0, d, LM_SPAN):
            want = Q.qsgd_pack_plain(x, k0, k1, nrm, MAIN_LEVELS, MAIN_WIDTH,
                                     lo, min(lo + LM_SPAN, d))
            w0 = lo // 32 * wpc
            check(torch.equal(words[:, w0:w0 + want.shape[1]], want),
                  f"{name}: qsgd_pack words != plain in span {lo}")
    _, pack_s = _timed(plain_pack)
    fac = nrm / MAIN_LEVELS
    xhat = Q.qsgd_unpack_buckets([words], [fac], [d], MAIN_LEVELS,
                                 MAIN_WIDTH)[0]

    def plain_unpack():
        for lo in range(0, d, LM_SPAN):
            hi = min(lo + LM_SPAN, d)
            w0 = lo // 32 * wpc
            want = Q.qsgd_unpack_plain(
                words[:, w0:w0 + -(-(hi - lo) * wpc // 32)], fac, hi - lo,
                MAIN_LEVELS, MAIN_WIDTH)
            check(bitwise_equal(xhat[:, lo:hi].contiguous(), want),
                  f"{name}: qsgd_unpack != plain in span {lo}")
    _, unpack_s = _timed(plain_unpack)
    del xhat
    pack = lambda: Q.qsgd_pack_buckets([x], [k0], [k1], [nrm], MAIN_LEVELS,
                                       MAIN_WIDTH)
    unpack = lambda: Q.qsgd_unpack_buckets([words], [fac], [d], MAIN_LEVELS,
                                           MAIN_WIDTH)
    out = [_big_row("qsgd_pack", name, n, d, MAIN_WIDTH,
                    call_ms(pack, reps=3, repeats=3), pack_s * 1e3),
           _big_row("qsgd_unpack", name, n, d, MAIN_WIDTH,
                    call_ms(unpack, reps=3, repeats=3), unpack_s * 1e3)]
    return out, -(-d // LM_SPAN)


def check_index_leg(name, x, rows, comp, dev):
    """The top-k index leg of a step's payload rows (values first, then the
    packed indices) against the plain field pack of the same units'
    top-k indices, and the kernel's unpack against the plain unpack,
    bitwise -> timing rows."""
    import torch
    from repro_torch.core.compressors import _k_of, index_bits
    from repro_torch.core.wire import _u8_rows_to
    from repro_torch.kernels import pack as P
    n, d = x.shape
    k, width = _k_of(comp.ratio, d), index_bits(d)
    idx = comp.encode(x, None)["idx"].contiguous()
    words = _u8_rows_to(rows[:, 4 * k:], torch.int32)
    want, pack_s = _timed(lambda: P.fields_pack_plain(idx, width))
    check(torch.equal(words, want), f"{name}: index leg != plain pack")
    got = P.fields_unpack_buckets([words], [k], [width])[0]
    plain, unpack_s = _timed(lambda: P.fields_unpack_plain(words, k, width))
    check(torch.equal(got, plain) and torch.equal(got, idx),
          f"{name}: fields_unpack != plain / the indices")
    pack = lambda: P.fields_pack_buckets([idx], [width])
    unpack = lambda: P.fields_unpack_buckets([words], [k], [width])
    return [_big_row("fields_pack", name, n, k, width,
                     call_ms(pack, reps=3, repeats=3), pack_s * 1e3),
            _big_row("fields_unpack", name, n, k, width,
                     call_ms(unpack, reps=3, repeats=3), unpack_s * 1e3)]


def lm_step_buffers(dev):
    """9(c): one full-width step's wire buffers (the worker gradients of
    step 0 of a train_lm run, aggregate_simulated_workers's per-bucket
    schedule and keys) for QSGD(16) layerwise, top-k(1%) layerwise and
    QSGD(16) entire-model: bytes a worker against comm_report(measured)
    and message_wire_bits; on the largest unit of each (the 614,596,608-
    entry embedding and head bucket, the 1,430,535,168-entry model) the
    kernels' buffers bitwise the plain versions' -> (byte rows, timing
    rows, spans checked)."""
    import torch
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.bits import comm_report
    from repro_torch.core.granularity import Granularity
    from repro_torch.core.plan import build_plan
    from repro_torch.core.schedule import build_schedule, message_wire_bits
    from repro_torch.core.wire import (execute_schedule_wire, message_layouts,
                                       wire_codec)
    from repro_torch.experiment import lm_worker_grads
    from repro_torch.models import DistConfig, Model
    _free_card()
    model = Model(lm_full_width(), DistConfig())
    params = model.init(R.key(0), device=dev)
    batch = next(lm_token_batches(model.cfg.vocab, dev))
    key = R.fold_in(R.key(2), 0)
    wg, _ = lm_worker_grads(model, params, batch, key, WORKERS)
    del params, batch
    wkeys = R.fold_in(key[None], torch.arange(WORKERS))
    shapes = model.param_shapes()
    byte_rows, rows, spans = [], [], 0
    for name, comp, gran, _ in (lm_runs_spec()[0], lm_runs_spec()[2],
                                lm_runs_spec()[1]):
        _free_card()
        plan = build_plan(shapes, model.stacked(), Granularity(gran))
        sched = build_schedule(plan, 0.0)
        codec = wire_codec(comp)
        _, bufs = execute_schedule_wire(sched, codec, wg, wkeys)
        layouts = message_layouts(sched, codec)
        total = sum(buf.shape[1] for buf in bufs)
        header = sum(l.header_nbytes for l in layouts)
        rep = comm_report(CompressionConfig(qw=comp, strategy="allgather",
                                            granularity=Granularity(gran)),
                          plan, WORKERS, measured=True)
        mwb = sum(message_wire_bits(sched, bucket_bits=[
            b.n * codec.wire_bits(b.dim) for b in plan.buckets]))
        check(total == sum(l.total_nbytes for l in layouts)
              and 8 * (total - header) == rep.uplink_bits_per_worker == mwb,
              f"LM {name}: {total} B a worker ({header} B headers), "
              f"comm_report {rep.uplink_bits_per_worker / 8} B, "
              f"message_wire_bits {mwb / 8} B")
        byte_rows.append({"run": name, "messages": sched.num_messages,
                          "bytes_per_worker": total, "header_bytes": header,
                          "comm_report_bytes":
                              rep.uplink_bits_per_worker / 8})
        print(f"LM full width {name}: one step's wire {total} B a worker "
              f"in {sched.num_messages} messages ({header} B headers) = "
              f"comm_report {rep.uplink_bits_per_worker / 8:.0f} B + "
              f"headers", flush=True)
        b, region = _largest_bucket(plan, sched, codec, bufs)
        leaves = tree_leaves(wg)
        flat = plan._flat(leaves) if plan.needs_flat else None
        if gran == "entire_model":   # the last use of the gradients
            del wg, leaves
            _free_card()
            leaves = None
        x = plan._gather_runs(leaves, flat, b)
        keys = plan._bucket_keys(plan._keys(wkeys, dev), b)
        if comp.name == "qsgd":
            r, s = check_qsgd_unit(name, x, keys, region, dev)
            rows += r
            spans += s
        else:
            rows += check_index_leg(name, x, region, comp, dev)
        del bufs, region, x, flat
        for r in rows[-2:]:
            print(f"  {r['group']} {r['kernel']:13s} {r['leg']:20s} "
                  f"{str(r['shape']):20s} w{r['width']:<2d} ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.1f} bound_ms={r['bound_ms']:.4f} "
                  f"({r['bound_by']}) x{r['ms'] / r['bound_ms']:.2f}",
                  flush=True)
    _free_card()
    return byte_rows, rows, spans


def profile_lm_step(dev):
    """9(d): torch.profiler over one full-width QSGD(16) layerwise step
    (after a warm-up step)."""
    from repro_torch import random as R
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.experiment import lm_train_step
    from repro_torch.models import DistConfig, Model
    _free_card()
    model = Model(lm_full_width(), DistConfig())
    params = model.init(R.key(0), device=dev)
    data = lm_token_batches(model.cfg.vocab, dev)
    batches = [next(data) for _ in range(2)]
    comp = CompressionConfig(qw=lm_runs_spec()[0][1])

    def step(i):
        nonlocal params
        params, _ = lm_train_step(model, comp, params, batches[i],
                                  R.fold_in(R.key(2), i), LM_LR,
                                  workers=WORKERS)
    step(0)
    prof = device_profile(lambda: step(1), 1)
    del params
    _free_card()
    return {"compressor": "qsgd", **prof}


def lm_phase(dev):
    """Phase 9 -> (its record, its main-path launches per kernel)."""
    t0 = time.perf_counter()
    smoke = check_lm_smoke(dev)
    print(f"LM smoke (7 attention archs): loss and every gradient leaf on "
          f"the card within tolerance of the CPU run; worst loss rel err "
          f"{max(r['loss_rel_err'] for r in smoke):.2e}, worst gradient "
          f"err {max(r['grad_err_of_max'] for r in smoke):.2e} of max |g|",
          flush=True)
    runs = lm_runs(dev)
    byte_rows, rows, spans = lm_step_buffers(dev)
    print(f"LM full width: the kernels' QSGD buffers and decodes bitwise "
          f"the plain versions' on the embedding bucket and the entire "
          f"model ({spans} spans of {LM_SPAN} positions), the top-k index "
          f"leg's pack and unpack bitwise", flush=True)
    prof = profile_lm_step(dev)
    print(f"LM profile (one full-width QSGD(16) layerwise step): wall "
          f"{prof['wall_ms_per_step']:.1f} ms, device busy "
          f"{prof['device_busy_ms_per_step']:.1f} ms, idle share "
          f"{prof['idle_share']}, {prof['device_events']} device events",
          flush=True)
    for name, t in prof["top_device_ms_per_step"]:
        print(f"  device {t:.3f} ms  {name}", flush=True)
    launches = {}
    for r in runs:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return ({"seconds": time.perf_counter() - t0, "smoke": smoke,
             "runs": runs, "wire_bytes": byte_rows, "timings": rows,
             "profile": prof}, launches)


# ---- phase 10: the serving path -------------------------------------------------

# 10(a): prompts of the smoke runs (the ring case's prompt is longer than
# its 8-token window)
SERVE_SMOKE_BATCH, SERVE_SMOKE_PROMPT, SERVE_RING_PROMPT = 2, 12, 11
# 10(b)-(d): 8 prompts of 512 uniform tokens, 64 generated tokens;
# whisper-base 8 prompts of 64 and 16 generated tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 64
WHISPER_PROMPT, WHISPER_GEN = 64, 16
# the consistency check at full width (serve_full): the decode of the
# prompt's last token after a prefill of the others against the last
# logits of the whole prompt's prefill, in f32 within SERVE_F32_TOL of max
# |logit| (the logic), and in bf16 within SERVE_BF16_NOISE x the bf16
# prefill's own distance from the f32 prefill (bf16's rounding on that
# model and input)
SERVE_F32_TOL = 1e-4
SERVE_BF16_NOISE = 2.0
# the declared leaves of phi4-mini at 32 layers (ModelConfig.param_count(),
# an analytic count, says 4,450,811,904: it counts 63 more norm vectors)
PHI4_PARAMS = 4_450_618_368
# k and v: 32 layers x 8 x 8 kv heads x 576 positions x 128 x 2 B; slot_pos
# 32 x 576 int32
PHI4_CACHE_BYTES = 603_979_776 + 32 * 576 * 4
# ssm 48 x 8 x 64 x 64 x 128 x 4 B, conv_x 48 x 8 x 3 x 4,096 x 2 B,
# conv_bc 48 x 8 x 3 x 256 x 2 B
MAMBA2_CACHE_BYTES = 815_333_376


def serve_smoke_cases():
    """(name, config, prompt) of 10(a): the ten archs' smoke configs in
    f32, phi4-mini with an 8-token ring and llama3 with an int8 cache."""
    import dataclasses
    from repro_torch.configs import ARCH_NAMES, get_smoke
    phi4, llama3 = get_smoke("phi4-mini-3.8b"), get_smoke("llama3-405b")
    return ([(a, get_smoke(a), SERVE_SMOKE_PROMPT) for a in ARCH_NAMES]
            + [("phi4-mini-3.8b ring", dataclasses.replace(
                phi4, sliding_window=8, swa_pattern=0), SERVE_RING_PROMPT),
               ("llama3-405b int8", dataclasses.replace(
                   llama3, kv_cache_dtype="int8"), SERVE_SMOKE_PROMPT)])


def _slot_leaves(cache):
    """The int32 leaves of a cache (every slot_pos), on the CPU."""
    import torch
    from repro_torch.convert import map_tree
    out = []
    map_tree(lambda t: out.append(t.cpu()) if t.dtype == torch.int32
             else None, cache)
    return out


def check_serve_smoke(dev):
    """10(a): each case's prefill and two chained decode steps on the card
    against the same calls on the CPU (same params, prompt and tokens):
    logits within 1e-5 of max |logit| (f32, TF32 off), slot_pos bitwise."""
    import torch
    from repro_torch import random as R
    from repro_torch.convert import tree_map
    from repro_torch.launch import serve
    from repro_torch.models import DistConfig, Model
    cpu = torch.device("cpu")
    rows = []
    for name, cfg, S in serve_smoke_cases():
        m = Model(cfg, DistConfig())
        params = m.init(R.key(0), device=cpu)
        batch = serve.make_batch(cfg, SERVE_SMOKE_BATCH, S, 1, cpu)
        g = torch.Generator().manual_seed(2)
        toks = [torch.randint(0, cfg.vocab, (SERVE_SMOKE_BATCH,),
                              generator=g) for _ in range(2)]
        runs = []
        for d in (cpu, dev):
            p = tree_map(lambda t: t.to(d), params)
            logits, cache = m.prefill(
                p, {k: v.to(d) for k, v in batch.items()}, cache_len=S + 2)
            out = [logits.cpu()]
            for t, tok in enumerate(toks):
                logits, cache = m.decode_step(p, tok.to(d), S + t, cache)
                out.append(logits.cpu())
            runs.append((out, _slot_leaves(cache)))
        (l_cpu, s_cpu), (l_card, s_card) = runs
        errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(l_card, l_cpu)]
        slots = len(s_cpu) == len(s_card) and all(
            torch.equal(a, b) for a, b in zip(s_card, s_cpu))
        check(all(math.isfinite(e) and e <= 1e-5 for e in errs) and slots,
              f"serve smoke {name}: card vs CPU logit errors {errs} of max "
              f"|logit| (prefill, steps 1 and 2), slot_pos equal {slots}")
        rows.append({"case": name, "prompt": S, "logit_err_of_max": errs,
                     "slot_pos_equal": slots})
    return rows


def _decode_vs_prefill(m, params, batch, prompt):
    """(the prompt's prefill's last logits, the decode of its last token
    after a prefill of the others), f32, on the card."""
    import torch
    with torch.inference_mode():
        full, _ = m.prefill(params, batch)
        _, cache = m.prefill(params, dict(batch,
                                          tokens=batch["tokens"][:, :-1]),
                             cache_len=prompt)
        step, _ = m.decode_step(params, batch["tokens"][:, -1], prompt - 1,
                                cache)
    return full.float(), step.float()


def serve_full(dev, card, name, cfg, batch, prompt, gen, want_params=None,
               want_cache=None, profile=False):
    """10(b)-(e): launch/serve.py's generate on the card (random params
    from key(0), uniform prompt tokens drawn on the card, after one warm-up
    prefill and decode step at the same shapes): prefill ms, decode ms a
    token (CUDA events over the gen - 1 steps), tokens/s, peak memory and
    the cache's bytes; with `profile`, torch.profiler over one more decode
    step; then the consistency check, in bf16 and on an f32 copy of the
    params -> its record."""
    import dataclasses
    import torch
    from repro_torch import random as R
    from repro_torch.convert import map_tree, tree_leaves, tree_map
    from repro_torch.launch import serve
    from repro_torch.models import DistConfig, Model
    _free_card()
    m = Model(cfg, DistConfig())
    n_params = sum(t.numel() for t in tree_leaves(m.param_shapes()))
    check(want_params in (None, n_params),
          f"serve {name}: {n_params} parameters declared, want {want_params}")
    params, init_s = _timed(lambda: m.init(R.key(0), device=dev))
    b = serve.make_batch(cfg, batch, prompt, 0, dev)
    serve.generate(m, params, b, 2)
    torch.cuda.reset_peak_memory_stats(dev)
    res = serve.generate(m, params, b, gen)
    peak = torch.cuda.max_memory_allocated(dev)
    tokens = res["tokens"]
    # argmax runs over the padded vocab, as in the reference
    check(tuple(tokens.shape) == (batch, gen) and int(tokens.min()) >= 0
          and int(tokens.max()) < m.vocab_padded,
          f"serve {name}: generated tokens {tuple(tokens.shape)} or their "
          f"range [{int(tokens.min())}, {int(tokens.max())}] wrong")
    sizes = []
    map_tree(lambda t: sizes.append(t.numel() * t.element_size()),
             res["cache"])
    cache_bytes = sum(sizes)
    check(want_cache in (None, cache_bytes),
          f"serve {name}: cache {cache_bytes} B, want {want_cache}")
    rec = {"run": name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "params": n_params, "param_count": cfg.param_count(),
           "batch": batch, "prompt": prompt, "gen": gen,
           "init_seconds": init_s, "prefill_ms": res["prefill_ms"],
           "decode_ms": res["decode_ms"],
           "decode_ms_per_token": res["decode_ms_per_token"],
           "tokens_per_s": res["tokens_per_s"], "peak_bytes": peak,
           "cache_bytes": cache_bytes, "card": card}
    if profile:
        tok = tokens[:, -1]
        with torch.inference_mode():
            rec["profile"] = device_profile(lambda: m.decode_step(
                params, tok, prompt + gen - 1, res["cache"]), 1)
    del res
    _free_card()
    full, step = _decode_vs_prefill(m, params, b, prompt)
    params32 = tree_map(lambda t: t.to(torch.float32), params)
    del params
    _free_card()
    full32, step32 = _decode_vs_prefill(
        Model(dataclasses.replace(cfg, dtype="float32"), DistConfig()),
        params32, b, prompt)
    del params32
    _free_card()
    top = float(full32.abs().max())
    err32 = float((step32 - full32).abs().max()) / top
    err = float((step - full).abs().max()) / top
    noise = float((full - full32).abs().max()) / top
    rec.update(consistency_err_of_max=err, consistency_f32_err_of_max=err32,
               bf16_prefill_err_of_max=noise,
               consistency_argmax_agree=float(
                   (step.argmax(-1) == full.argmax(-1)).float().mean()))
    finite = all(bool(torch.isfinite(t).all())
                 for t in (full, step, full32, step32))
    check(finite and err32 <= SERVE_F32_TOL
          and err <= SERVE_BF16_NOISE * noise,
          f"serve {name}: decode of token {prompt - 1} after a "
          f"{prompt - 1}-token prefill vs the {prompt}-token prefill: f32 "
          f"{err32:.3e} of max |logit| (tolerance {SERVE_F32_TOL}); bf16 "
          f"{err:.3e}, the bf16 prefill {noise:.3e} off the f32 one "
          f"(tolerance {SERVE_BF16_NOISE} x that); finite {finite}")
    print(f"serve {name} ({cfg.n_layers} layers, {cfg.dtype}, {n_params:,} "
          f"parameters; batch {batch}, prompt {prompt}, {gen} tokens): "
          f"prefill {rec['prefill_ms']:.3f} ms, decode "
          f"{rec['decode_ms_per_token']:.3f} ms/token over {gen - 1} steps, "
          f"{rec['tokens_per_s']:.1f} tokens/s, peak {peak} B "
          f"({peak / 2**30:.2f} GiB), cache {cache_bytes} B, init "
          f"{init_s:.2f} s; decode vs prefill {err:.3e} of max |logit| in "
          f"bf16 (the bf16 prefill {noise:.3e} off the f32 one; argmax "
          f"agree {rec['consistency_argmax_agree']:.3f}), {err32:.3e} in "
          f"f32 [{card}]", flush=True)
    return rec


def serve_phase(dev, card):
    """Phase 10 -> its record. The serving path launches none of the wire
    kernels: their counters are the same before and after."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    before = kernels.launch_counts()
    smoke = check_serve_smoke(dev)
    print(f"serve smoke ({len(smoke)} cases: the ten archs, the phi4 ring, "
          f"the llama3 int8 cache): prefill and two decode steps on the card "
          f"within 1e-5 of the CPU's max |logit|, worst "
          f"{max(max(r['logit_err_of_max']) for r in smoke):.2e}; slot_pos "
          f"bitwise [{card}]", flush=True)
    runs = [serve_full(dev, card, "phi4-mini-3.8b",
                       get_config("phi4-mini-3.8b"), SERVE_BATCH,
                       SERVE_PROMPT, SERVE_GEN, want_params=PHI4_PARAMS,
                       want_cache=PHI4_CACHE_BYTES, profile=True),
            serve_full(dev, card, "mamba2-1.3b", get_config("mamba2-1.3b"),
                       SERVE_BATCH, SERVE_PROMPT, SERVE_GEN,
                       want_cache=MAMBA2_CACHE_BYTES),
            serve_full(dev, card, "zamba2-7b", dataclasses.replace(
                get_config("zamba2-7b"), n_layers=9), SERVE_BATCH,
                SERVE_PROMPT, SERVE_GEN),
            serve_full(dev, card, "whisper-base", get_config("whisper-base"),
                       SERVE_BATCH, WHISPER_PROMPT, WHISPER_GEN)]
    prof = runs[0]["profile"]
    print(f"serve profile (one phi4-mini decode step, batch {SERVE_BATCH}): "
          f"wall {prof['wall_ms_per_step']:.3f} ms, device busy "
          f"{prof['device_busy_ms_per_step']:.3f} ms, idle share "
          f"{prof['idle_share']}, {prof['device_events']} device events "
          f"[{card}]", flush=True)
    for op, t in prof["top_device_ms_per_step"]:
        print(f"  device {t:.4f} ms  {op}", flush=True)
    after = kernels.launch_counts()
    check(after == before, f"the serving path launched wire kernels: "
          f"{before} -> {after}")
    return {"seconds": time.perf_counter() - t0, "smoke": smoke,
            "runs": runs}


# ---- phase 11: the data-parallel Engine, checkpoints and the train CLI ------

ENGINE_RANKS = 2
# 11(a)-(b): the train CLI on 2 gloo ranks sharing cuda:0, llama3 smoke in
# f32, QSGD(16) layerwise over the wire, 8 x 32 tokens a step, a
# checkpoint every 2 steps
CLI_STEPS = 4
CLI = ["--arch", "llama3-405b", "--smoke", "--data", str(ENGINE_RANKS),
       "--backend", "gloo", "--compressor", "qsgd", "--levels",
       str(MAIN_LEVELS), "--granularity", "layerwise", "--wire", "--batch",
       "8", "--seq", "32", "--lr", "0.05", "--steps", str(CLI_STEPS)]
# launches a step and rank. llama3 smoke's layerwise plan has 5 buckets
# (21 units, <= MAX_BUCKETS): the simulated wire step packs all 5 in one
# qsgd_pack launch and decodes its own payloads in one qsgd_unpack; the
# allgather step packs in one launch and decodes every rank's gathered
# rows in one decode_rows_buckets call (one fields_unpack); the ring runs
# the per-bucket schedule, a pack a message (5) and a qsgd_unpack for its
# own payload and each of its n - 1 = 1 hops (5 x 2 = 10)
CLI_LAUNCHES = {"qsgd_pack": 1, "qsgd_unpack": 1}
VARIANT_STEPS = 3
VARIANTS = (("records", False, None, {}),
            ("wire", True, None, {"qsgd_pack": 1, "qsgd_unpack": 1}),
            ("allgather", True, "allgather",
             {"qsgd_pack": 1, "fields_unpack": 1}),
            ("ring", True, "ring", {"qsgd_pack": 5, "qsgd_unpack": 10}))
# 11(c): phi4-mini at full width (lm_full_width: 2 layers, bf16), each
# rank 2 x 512 uniform tokens a step, QSGD(16) over the allgather wire;
# each step packs every bucket in one qsgd_pack launch and decodes the
# gathered rows in one fields_unpack (its 5 layerwise buckets, or 1)
FULL_ROWS, FULL_STEPS = 2, 3
FULL_LAUNCHES = {"qsgd_pack": 1, "fields_unpack": 1}
# steps a granularity runs: FULL_STEPS timed, one split in its stages,
# one whose decode is checked, and for layerwise one profiled
FULL_BATCHES = 2 * (FULL_STEPS + 2) + 1
DIGEST_CHUNK = 1 << 24
# 11(d): the controller CLI (GranularitySwitchPolicy over top-k(10%); the
# controller's steps aggregate on the simulated path, no kernel)
POLICY_STEPS = 6
POLICY_CLI = ["--arch", "llama3-405b", "--smoke", "--data",
              str(ENGINE_RANKS), "--backend", "gloo", "--compressor", "topk",
              "--ratio", "0.1", "--policy", "granularity_switch",
              "--replan-every", "2", "--batch", "8", "--seq", "32", "--lr",
              "0.05", "--steps", str(POLICY_STEPS)]


def _rank_launches(results):
    """Kernel launches summed over the ranks' records."""
    out = {}
    for r in results:
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def _want_launches(per_step, steps, names):
    return {k: per_step.get(k, 0) * steps for k in names}


def engine_variants(rank, n, dev):
    """11(a) on the Engine itself: VARIANT_STEPS steps of llama3 smoke in
    f32 with QSGD(16) layerwise as simulated records, over the simulated
    wire, allgather and the ring, launch counters reset before each run
    and read after it -> {variant: record}."""
    import torch
    from repro_torch import kernels
    from repro_torch import random as R
    from repro_torch.configs import get_smoke
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import QSGD
    from repro_torch.experiment import _full_precision
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import OptConfig
    _full_precision()
    cfg = get_smoke("llama3-405b")
    comp = CompressionConfig(qw=QSGD(levels=MAIN_LEVELS))
    g = torch.Generator().manual_seed(3)
    data = [torch.randint(0, cfg.vocab, (8, 33), generator=g)
            for _ in range(VARIANT_STEPS)]
    out = {}
    for name, wire, collective, per_step in VARIANTS:
        eng = Engine(cfg, make_host_mesh(data=n), comp=comp,
                     opt=OptConfig("momentum", lr=0.05), device=dev)
        params, state = eng.init_state(0)
        step = eng.build_train_step(wire=wire, collective=collective)
        kernels.reset_launch_counts()
        losses = []
        for i, s in enumerate(data):
            s = s.to(dev)
            params, state, m = step(params, state, {"tokens": s[:, :-1],
                                                    "targets": s[:, 1:]}, i)
            losses.append(float(m["loss"]))
        counts = kernels.launch_counts()
        want = _want_launches(per_step, VARIANT_STEPS, SOURCES)
        check({k: counts[k] for k in SOURCES} == want,
              f"engine {name}: launches {counts} != {want}")
        out[name] = {"losses": losses, "launches": counts,
                     "params": _flat(params).cpu().numpy(),
                     "m": _flat(state["m"]).cpu().numpy()}
        del params, state
    return out


def _full_batches(vocab: int, dev, steps: int):
    """The global batches of 11(c): ENGINE_RANKS x FULL_ROWS uniform
    sequences of LM_SEQ + 1 tokens a step, drawn on the card from one
    seed (the same on every rank)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(11)
    out = []
    for _ in range(steps):
        s = torch.randint(0, vocab, (ENGINE_RANKS * FULL_ROWS, LM_SEQ + 1),
                          generator=g, device=dev)
        out.append({"tokens": s[:, :-1], "targets": s[:, 1:]})
    return out


def _digest(tensors) -> list:
    """A 64-bit digest of each tensor's bits, on the card: the sum over
    its entries of a mix of the entry's bits and its index (wrapping
    int64 arithmetic), DIGEST_CHUNK entries at a time."""
    import torch
    out = []
    for t in tensors:
        x = t.detach().reshape(-1)
        if x.is_floating_point():
            x = x.view({2: torch.int16, 4: torch.int32}[x.element_size()])
        h = torch.zeros((), dtype=torch.int64, device=x.device)
        for lo in range(0, x.numel(), DIGEST_CHUNK):
            v = x[lo:lo + DIGEST_CHUNK].to(torch.int64)
            v = v * 6364136223846793005 + torch.arange(
                lo, lo + v.numel(), dtype=torch.int64,
                device=x.device) * 1442695040888963407
            v = (v ^ (v >> 29)) * 6364136223846793005
            h += (v ^ (v >> 32)).sum()
        out.append(int(h))
    return out


def _capture_unpack(cap: dict):
    """Swap ops' fields_unpack_buckets for one that runs the kernel and
    keeps its input words, fields, widths and its output's digest in
    `cap` -> a function that puts the kernel's entry point back."""
    from repro_torch.kernels import ops
    orig = ops.fields_unpack_buckets

    def capture(words_list, ks, widths):
        got = orig(words_list, ks, widths)
        cap.update(words=list(words_list), ks=[int(k) for k in ks],
                   widths=list(widths), digest=_digest(got))
        return got
    ops.fields_unpack_buckets = capture

    def restore():
        ops.fields_unpack_buckets = orig
    return restore


def check_gathered_decode(name, cap):
    """A step's one fields_unpack launch over every rank's gathered QSGD
    payload rows (`cap`, from _capture_unpack): the kernel launched again
    on the same words at the same grouped shape (its output's digest the
    step's launch's) against the plain unpack over LM_SPAN-position spans
    of each bucket, bitwise -> (spans checked, the plain unpack's ms)."""
    import torch
    from repro_torch.kernels import pack as P
    got = P.fields_unpack_buckets(cap["words"], cap["ks"], cap["widths"])
    check(_digest(got) == cap["digest"],
          f"{name}: fields_unpack launched again != the step's launch")
    spans, plain_s = 0, 0.0
    for b, (words, k, w, out) in enumerate(zip(cap["words"], cap["ks"],
                                               cap["widths"], got)):
        rows = max(1, LM_SPAN // min(k, LM_SPAN))
        for lo in range(0, k, LM_SPAN):        # LM_SPAN is a multiple of 32
            hi = min(lo + LM_SPAN, k)
            w0, nw = lo // 32 * w, -(-(hi - lo) * w // 32)
            for r in range(0, words.shape[0], rows):
                want, s = _timed(lambda: P.fields_unpack_plain(
                    words[r:r + rows, w0:w0 + nw], hi - lo, w))
                plain_s += s
                check(torch.equal(out[r:r + rows, lo:hi], want),
                      f"{name}: fields_unpack != plain in bucket {b}, rows "
                      f"{r}:, positions {lo}:{hi}")
                spans += 1
    return spans, plain_s * 1e3


def engine_full_width(rank, n, dev):
    """11(c) on one rank: the Engine on phi4-mini at full width (2 layers,
    bf16), QSGD(16) over the allgather wire, layerwise then entire-model:
    FULL_STEPS unprofiled steps each timed by CUDA events, one step timed
    in its three stages (forward / backward, aggregation with gloo's host
    seconds inside it, update), one step whose fields_unpack launch over
    the gathered rows is held against the plain unpack (check_gathered_
    decode), and for layerwise one profiled step (the pack and decode
    kernels' device time); peak memory outside the checked steps (which
    keep the gathered words), exact wire bytes against comm_report,
    finite losses, and a digest of each param and momentum leaf after
    each granularity's run, for the ranks to be held equal."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import collectives
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.bits import comm_report
    from repro_torch.core.compressors import QSGD
    from repro_torch.core.granularity import Granularity
    from repro_torch.experiment import _full_precision
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves
    from repro_torch.models import InputShape
    from repro_torch.optim import OptConfig, init_opt_state
    _full_precision()
    cfg = lm_full_width()
    eng = Engine(cfg, make_host_mesh(data=n), opt=OptConfig("momentum",
                                                            lr=LM_LR),
                 device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    # draws on the card (Engine.init_state draws on the CPU)
    params = eng.model.init(R.key(0), device=dev)
    state = init_opt_state(eng.opt, params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    est = eng.memory_estimate(InputShape("train", LM_SEQ,
                                         n * FULL_ROWS, "train"))
    batches = _full_batches(cfg.vocab, dev, FULL_BATCHES)
    out = {"params": n_params, "estimate": est, "runs": []}
    peaks, check_peaks = [], []
    i = 0
    for gran in ("layerwise", "entire_model"):
        comp = CompressionConfig(qw=QSGD(levels=MAIN_LEVELS),
                                 strategy="allgather",
                                 granularity=Granularity(gran))
        step = eng.build_train_step(comp=comp, wire=True,
                                    collective="allgather")
        plan = eng.comm_plans(comp)[0]
        rep = comm_report(comp, plan, n, measured=True)
        kernels.reset_launch_counts()
        collectives.reset_counts()
        ms, losses = [], []
        for _ in range(FULL_STEPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            params, state, m = step(params, state, batches[i], i)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            losses.append(float(m["loss"]))
            i += 1
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, grads = step.grads(params, batches[i], i)
        ev[1].record()
        g0 = collectives.counts("all_gather")["seconds"]
        agg = step.aggregate(grads, i)
        ev[2].record()
        ev[2].synchronize()
        gloo_s = collectives.counts("all_gather")["seconds"] - g0
        del grads
        params, state, m = step.update(params, state, loss, agg, i)
        ev[3].record()
        ev[3].synchronize()
        del agg
        losses.append(float(m["loss"]))
        i += 1
        steps = FULL_STEPS + 2
        prof = None
        if gran == "layerwise":
            b_i = batches[i]

            def one(b_i=b_i, i=i):
                nonlocal params, state
                params, state, _ = step(params, state, b_i, i)
            prof = device_profile(one, 1, match=("qsgd_pack",
                                                 "fields_unpack"))
            i += 1
            steps += 1
        # the checked step keeps its words past the decode: its peak apart
        peaks.append(torch.cuda.max_memory_allocated(dev))
        cap = {}
        restore = _capture_unpack(cap)
        try:
            params, state, m = step(params, state, batches[i], i)
        finally:
            restore()
        losses.append(float(m["loss"]))
        i += 1
        counts = kernels.launch_counts()
        want = _want_launches(FULL_LAUNCHES, steps, SOURCES)
        check({k: counts[k] for k in SOURCES} == want,
              f"full width {gran}: launches {counts} != {want}")
        coll = collectives.counts("all_gather")
        sent = coll["sent_bytes"] / steps
        check(8 * sent == rep.uplink_bits_per_worker,
              f"full width {gran}: {sent} B sent a step, comm_report "
              f"{rep.uplink_bits_per_worker / 8} B")
        check(all(math.isfinite(v) for v in losses),
              f"full width {gran}: losses {losses}")
        spans, plain_ms = check_gathered_decode(f"full width {gran}", cap)
        decoded = {"buckets": len(cap["ks"]), "spans": spans,
                   "shapes": [[int(w.shape[0]), k] for w, k in
                              zip(cap["words"], cap["ks"])],
                   "plain_ms": plain_ms}
        del cap
        check_peaks.append(torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        digest = {"params": _digest(tree_leaves(params)),
                  "m": _digest(tree_leaves(state["m"]))}
        out["runs"].append({
            "run": f"qsgd16_{gran}", "step_ms": ms, "losses": losses,
            "split_ms": {"forward_backward": ev[0].elapsed_time(ev[1]),
                         "aggregation": ev[1].elapsed_time(ev[2]),
                         "gloo_host": gloo_s * 1e3,
                         "update": ev[2].elapsed_time(ev[3])},
            "sent_bytes_per_step": sent,
            "recv_bytes_per_step": coll["recv_bytes"] / steps,
            "gather_calls_per_step": coll["calls"] / steps,
            "comm_report_bytes": rep.uplink_bits_per_worker / 8,
            "buckets": len(plan.buckets), "steps": steps,
            "launches": counts, "profile": prof, "decode_check": decoded,
            "digest": digest})
    out["peak_bytes"] = max(peaks)
    out["check_peak_bytes"] = max(check_peaks)
    out["launches"] = {}
    for run in out["runs"]:
        for k, v in run["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    return out


def engine_policy(rank, n, dev):
    """11(d) on one rank: the train CLI's rank loop with --policy on the
    card, then the same on the CPU over the same gloo group -> {device:
    the rank's results}."""
    import torch
    from repro_torch.launch import train
    threads = torch.get_num_threads()
    out = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        args = train._parse(POLICY_CLI + ["--device", d.type])
        out[name] = train._train_rank(rank, n, d, args, False)
    torch.set_num_threads(threads)
    return out


def engine_ranks(rank, n, dev):
    """11(a)'s Engine variants, 11(d), then 11(c), in one spawn of the
    ranks."""
    variants = engine_variants(rank, n, dev)
    t0 = time.perf_counter()
    policy = engine_policy(rank, n, dev)
    policy["seconds"] = time.perf_counter() - t0
    _free_card()
    t0 = time.perf_counter()
    full = engine_full_width(rank, n, dev)
    full["seconds"] = time.perf_counter() - t0
    return {"variants": variants, "policy": policy, "full_width": full}


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _states_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].tobytes() == b[k].tobytes() for k in a)


def engine_phase(dev):
    """Phase 11 -> (its record, its main-path launches per kernel)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.ckpt import host_state, load_checkpoint
    from repro_torch.convert import tree_leaves
    from repro_torch.launch import train
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    _free_card()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        full, killed = Path(tmp) / "full", Path(tmp) / "killed"
        # (a) the CLI on the card, then the same call on the CPU
        card = train.run(CLI + ["--device", "cuda", "--ckpt-dir", str(full),
                                "--ckpt-every", "2"], collect=True)
        cpu = train.run(CLI + ["--device", "cpu"], collect=True)
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(card[0]["losses"], cpu[0]["losses"]))
        check(len(card[0]["losses"]) == CLI_STEPS and rel <= 1e-5,
              f"engine CLI: card losses {card[0]['losses']} vs CPU "
              f"{cpu[0]['losses']} ({rel:.2e})")
        for r in card:
            want = _want_launches(CLI_LAUNCHES, CLI_STEPS, SOURCES)
            check({k: r["launches"][k] for k in SOURCES} == want,
                  f"engine CLI: launches {r['launches']} != {want}")
            check(r["wire"]["calls"] == 5 * CLI_STEPS,
                  f"engine CLI: {r['wire']['calls']} all_gather calls")
        check(_states_equal(card[0]["state"], card[1]["state"]),
              "engine CLI: ranks' states differ")
        # (b) resume from the step-2 checkpoint in a fresh run_ranks
        killed.mkdir()
        shutil.copy(full / "ckpt_00000002_s0.npz", killed)
        resumed = train.run(CLI + ["--device", "cuda", "--ckpt-dir",
                                   str(killed), "--resume"], collect=True)
        check(resumed[0]["start"] == 2
              and resumed[0]["losses"] == card[0]["losses"][2:]
              and _states_equal(resumed[0]["state"], card[0]["state"]),
              "engine resume: not bitwise the uninterrupted run")
        _, back = load_checkpoint(str(full / "ckpt_00000004_s0.npz"),
                                  _nested(card[0]["state"]))
        check(all(t.device.type == "cpu" for t in tree_leaves(back))
              and _states_equal(host_state(back), card[0]["state"]),
              "engine checkpoint: the card's file does not load bitwise on "
              "the CPU")
    for res in (card, resumed):
        for k, v in _rank_launches(res).items():
            launches[k] = launches.get(k, 0) + v
    print(f"engine (a): train CLI on {ENGINE_RANKS} gloo ranks on cuda:0, "
          f"llama3 smoke f32, QSGD({MAIN_LEVELS}) layerwise wire, "
          f"{CLI_STEPS} steps: losses {card[0]['losses']}, the CPU's within "
          f"{rel:.2e}; launches a rank {_nonzero(card[0]['launches'])}",
          flush=True)
    print(f"engine (b): resumed at step 2 from the card's checkpoint in a "
          f"fresh run_ranks: params and momentum bitwise the uninterrupted "
          f"run; the card's step-4 file loads bitwise on the CPU",
          flush=True)
    _free_card()
    # two full-width ranks hold about 75 GB between them: their caching
    # allocators grow segments in place rather than leave split blocks
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = run_ranks(engine_ranks, ENGINE_RANKS, backend="gloo",
                          device="cuda", timeout=RANK_TIMEOUT)
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    var = [r["variants"] for r in ranks]
    fw = [r["full_width"] for r in ranks]
    pol = [r["policy"] for r in ranks]
    p0 = pol[0]
    prel = max(abs(a - b) / abs(b) for a, b in
               zip(p0["card"]["losses"], p0["cpu"]["losses"]))
    check(len(p0["card"]["losses"]) == POLICY_STEPS and prel <= 1e-5,
          f"engine policy CLI: card losses {p0['card']['losses']} vs CPU "
          f"{p0['cpu']['losses']} ({prel:.2e})")

    def ctl_line(c):
        rep = c["controller"]["report"]
        return (f"controller: decision={rep['decision']} "
                f"builds={rep['builds']} switches={len(rep['switches'])}")
    lines = {ctl_line(r[d]) for r in pol for d in ("card", "cpu")}
    seqs = {tuple(r[d]["controller"]["decisions"]) for r in pol
            for d in ("card", "cpu")}
    check(len(lines) == 1 and len(seqs) == 1,
          f"engine policy CLI: decisions or builds / switches differ "
          f"between the card and the CPU or the ranks: {lines}, {seqs}")
    c0 = p0["card"]["controller"]
    check(c0["report"]["builds"] == len(set(c0["decisions"]))
          and c0["report"]["switches"],
          f"engine policy CLI: {c0['report']['builds']} builds for "
          f"decisions {c0['decisions']}")
    for r in pol:
        for k, v in r["card"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"engine (d): train CLI --policy granularity_switch on "
          f"{ENGINE_RANKS} gloo ranks on cuda:0, llama3 smoke, top-k(10%), "
          f"{POLICY_STEPS} steps: losses {p0['card']['losses']}, the CPU's "
          f"within {prel:.2e}; decisions {c0['decisions']} on both devices "
          f"and ranks; {lines.pop()} ({p0['seconds']:.1f} s, card and CPU)",
          flush=True)
    v0 = var[0]
    for a, b in (("wire", "records"), ("allgather", "wire"),
                 ("ring", "allgather")):
        check(v0[a]["losses"] == v0[b]["losses"]
              and v0[a]["params"].tobytes() == v0[b]["params"].tobytes()
              and v0[a]["m"].tobytes() == v0[b]["m"].tobytes(),
              f"engine {a} != {b}")
    check(all(r[k]["params"].tobytes() == v0[k]["params"].tobytes()
              for r in var for k in v0), "engine variants: ranks differ")
    for r in var:
        for v in r.values():
            for k, c in v["launches"].items():
                launches[k] = launches.get(k, 0) + c
    print(f"engine (a): Engine steps over the simulated wire, allgather and "
          f"the ring bitwise the simulated records ({VARIANT_STEPS} steps, "
          f"params and momentum, every rank); launches a rank "
          f"{ {n: _nonzero(v['launches']) for n, v in v0.items()} }",
          flush=True)
    fw_secs = fw[0]["seconds"]
    for r in fw:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    f0 = fw[0]
    for j, run in enumerate(f0["runs"]):
        check(all(r["runs"][j]["digest"] == run["digest"] for r in fw),
              f"full width {run['run']}: the ranks' params or momentum "
              f"differ")
        print(f"engine (c) full width {run['run']}: {f0['params']} params, "
              f"{ENGINE_RANKS} ranks x {FULL_ROWS} x {LM_SEQ} tokens; step "
              f"ms {[round(t, 1) for t in run['step_ms']]}; split "
              f"{ {k: round(v, 1) for k, v in run['split_ms'].items()} }; "
              f"wire {run['sent_bytes_per_step']:.0f} B sent a step and "
              f"rank (comm_report {run['comm_report_bytes']:.0f}), "
              f"{run['recv_bytes_per_step']:.0f} B received, "
              f"{run['gather_calls_per_step']:.0f} all_gathers; losses "
              f"{[round(v, 4) for v in run['losses']]}", flush=True)
        if run["profile"]:
            p = run["profile"]
            print(f"  profiled step: wall {p['wall_ms_per_step']:.1f} ms, "
                  f"device busy {p['device_busy_ms_per_step']:.1f} ms, "
                  f"idle {p['idle_share']}, matched {p['matched_ms']}",
                  flush=True)
        dc = run["decode_check"]
        print(f"  one step's fields_unpack over the gathered rows "
              f"({dc['buckets']} buckets, (rows, fields) {dc['shapes']}) "
              f"bitwise the plain unpack over {dc['spans']} spans "
              f"(plain {dc['plain_ms']:.1f} ms) on every rank; params and "
              f"momentum the same on both ranks (a digest a leaf)",
              flush=True)
    print(f"engine (c): peak {[r['peak_bytes'] for r in fw]} B a rank "
          f"outside the checked steps ({[r['check_peak_bytes'] for r in fw]}"
          f" B in them), memory_estimate total "
          f"{f0['estimate']['total']:.0f} B; {fw_secs:.1f} s", flush=True)
    return ({"seconds": time.perf_counter() - t0,
             "cli": {"card": [{k: v for k, v in r.items() if k != "state"}
                              for r in card],
                     "cpu_losses": cpu[0]["losses"], "loss_rel_err": rel},
             "variants": {k: {"losses": v["losses"],
                              "launches": v["launches"]}
                          for k, v in v0.items()},
             "full_width": fw,
             "policy": {"card_losses": p0["card"]["losses"],
                        "cpu_losses": p0["cpu"]["losses"],
                        "loss_rel_err": prel, "controller": c0,
                        "seconds": p0["seconds"]},
             "full_width_seconds": fw_secs}, launches)


# ---- phase 12: the adaptive controller and the paper's figures ---------------

CTRL_STEPS, CTRL_REPLAN = 15, 5
# 12(a): every step of a top-k decision (the base or a per-bucket-k
# allocation) aggregates resnet9's 11 layerwise buckets over the simulated
# wire: one encode_buckets call (one fields_pack launch for the 11 index
# legs, <= MAX_BUCKETS) and one decode_buckets call (one fields_unpack);
# the telemetry leg runs TopK.sim (no kernel). 15 steps -> 15 and 15.
CTRL_LAUNCHES = {"fields_pack": 1, "fields_unpack": 1}
FIG_STEPS = 3


def check_adaptive_wire(decision, dev):
    """12(a)'s checks on one step's worker gradients under `decision`:
    wire == simulated aggregation on the card, bitwise; the decision's
    index legs through one fields_pack_buckets / fields_unpack_buckets
    launch each, bitwise the plain twins; the card's TelemetryState
    within 1e-5 relative of the CPU's (exact zeros exactly; the signed
    grad_sum within 1e-5 of its bucket's sum |x|) -> (legs as
    (n, k, width), max |err| of (pack, unpack), telemetry rel err)."""
    import torch
    from repro_torch import random as R
    from repro_torch.control import measure, measurement_plan
    from repro_torch.convert import tree_map
    from repro_torch.core import aggregate_simulated_workers, stacked_mask
    from repro_torch.core.aggregation import worker_mean
    from repro_torch.core.compressors import index_bits
    from repro_torch.core.wire import wire_codec
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.experiment import MODELS, worker_grads
    from repro_torch.kernels import pack as P
    from repro_torch.models.cnn import init_cnn
    cfg = MODELS["resnet9"]
    key = R.key(31)
    params = init_cnn(cfg, key, device=dev)
    wg, _ = worker_grads(cfg, params, classification_batch(
        R.fold_in(key, 1), 64, device=dev), WORKERS)
    sm = stacked_mask(params)
    mplan = measurement_plan(params, sm)
    comp = decision.to_config()
    sim, _, inc = aggregate_simulated_workers(wg, sm, comp, key,
                                              telemetry_plan=mplan)
    wire, _ = aggregate_simulated_workers(wg, sm, comp, key, wire=True)
    check(bitwise_equal(_flat(sim), _flat(wire)),
          "adaptive-k wire step != its simulated step")
    cpu_wg = {k: v.cpu() for k, v in wg.items()}
    _, _, cinc = aggregate_simulated_workers(cpu_wg, sm, comp, key,
                                             telemetry_plan=mplan)
    rel = {}
    # the signed grad_sum is held against sum |x| of its bucket (the
    # grad_sum of the same mean gradient's magnitudes)
    abs_sum = measure(mplan, comp.qw, tree_map(
        lambda g: worker_mean(g).abs(), cpu_wg), key,
        entire_model=False).grad_sum.double()
    for name, a, b in zip(inc._fields, inc, cinc):
        a, b = a.cpu().double(), b.double()
        zero = b == 0
        check(torch.equal(a[zero], b[zero]),
              f"telemetry {name}: card zeros != CPU zeros")
        scale = abs_sum if name == "grad_sum" else b.abs()
        rel[name] = (float(((a - b).abs() / scale)[~zero].max())
                     if (~zero).any() else 0.0)
        check(rel[name] <= 1e-5,
              f"telemetry {name} card vs CPU: {rel[name]:.2e} relative")
    rel = max(rel.values())
    codec = wire_codec(comp.qw)
    legs, idx = [], []
    for b in mplan.buckets:
        rows = mplan.gather_bucket(mplan.flatten(
            {k: v[0] for k, v in wg.items()}), b)
        k = codec._k(b.dim)
        idx.append(codec._c(b.dim).encode(rows, None)["idx"])
        legs.append((b.n, k, index_bits(b.dim)))
    check(len({(k, w) for _, k, w in legs}) > 1,
          f"adaptive-k legs share one (k, width): {legs}")
    ws, ks = [w for _, _, w in legs], [k for _, k, _ in legs]
    got = launched(P.fields_pack, lambda: P.fields_pack_buckets(idx, ws),
                   len(idx), "adaptive-k legs")
    back = launched(P.fields_unpack,
                    lambda: P.fields_unpack_buckets(got, ks, ws), len(idx),
                    "adaptive-k legs")
    err = [0.0, 0.0]
    for f, w, k, g, bk in zip(idx, ws, ks, got, back):
        want = P.fields_pack_plain(f, w)
        err[0] = max(err[0], max_abs_err(g, want))
        check(bitwise_equal(g, want), f"fields_pack adaptive-k w{w} k{k}")
        want = P.fields_unpack_plain(g, k, w)
        err[1] = max(err[1], max_abs_err(bk, want))
        check(bitwise_equal(bk, want) and bitwise_equal(bk, f),
              f"fields_unpack adaptive-k w{w} k{k}")
    torch.cuda.synchronize()
    return legs, tuple(err), rel


def figure_wire_cases():
    """What figures.ALL trains, read off its calls with the experiment
    stubbed -> ({model: [(compressor name, knobs)]} of the sim-exact
    compressors, in figure order, each once; [(model, CompressionConfig)]
    of ef_beyond_paper's runs)."""
    import io
    from repro_torch import figures
    from repro_torch.core import make_compressor
    from repro_torch.core.wire import wire_codec
    runs, efs = {}, []

    def compare(model, qname, *, steps, nesterov=False, device=None, **kw):
        qw = make_compressor(qname, **kw)
        if wire_codec(qw).exact_sim and (qname, kw) not in runs.get(model,
                                                                     []):
            runs.setdefault(model, []).append((qname, kw))
        return {"layerwise": 0.0, "entire_model": 0.0, "baseline": 0.0}

    def ef_run(model, comp, steps=100, device=None):
        efs.append((model, comp))
        return 0.0, None
    saved = figures.compare_granularities, figures.train_cnn_ef
    figures.compare_granularities, figures.train_cnn_ef = compare, ef_run
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            for fig in figures.ALL:
                fig(1, "cpu")
    finally:
        figures.compare_granularities, figures.train_cnn_ef = saved
    return runs, efs


# 12(b): one aggregate_simulated_workers(wire=True) call encodes every
# bucket of the step in one encode_buckets call and decodes them in one
# decode_buckets (decode_ef_buckets under error feedback) call: one pack
# and one unpack launch of the codec's kernel family (mlp 6, alexnet 8
# and resnet9 11 layerwise buckets, all <= MAX_BUCKETS; one entire-model
# bucket); the wire=False call launches nothing. So each (model,
# compressor, granularity) counts 1 + 1, and ef_beyond_paper's two-step
# runs 2 + 2 each.
FAMILY = {"qsgd": ("qsgd_pack", "qsgd_unpack"),
          "terngrad": ("terngrad_pack", "terngrad_unpack"),
          "topk": ("fields_pack", "fields_unpack"),
          "randomk": ("fields_pack", "fields_unpack")}
EF_STEPS = 2


def check_figure_wire(dev):
    """12(b): on one step's worker gradients of each figure model, every
    sim-exact compressor figures.ALL runs on it, at both granularities:
    aggregate_simulated_workers(wire=True) bitwise its wire=False result
    on the card; ef_beyond_paper's error-feedback runs over EF_STEPS
    steps, the aggregate and the EF state bitwise; launches counted
    exactly -> (cases checked, launches per kernel)."""
    import torch
    from repro_torch import kernels
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.core import (CompressionConfig, Granularity,
                                  aggregate_simulated_workers,
                                  make_compressor, stacked_mask)
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.experiment import MODELS, worker_grads
    from repro_torch.models.cnn import init_cnn
    runs, efs = figure_wire_cases()
    key = R.key(37)
    grads = {}
    for model in sorted(set(runs) | {m for m, _ in efs}):
        params = init_cnn(MODELS[model], key, device=dev)
        wg, _ = worker_grads(MODELS[model], params, classification_batch(
            R.fold_in(key, 1), 64, device=dev), WORKERS)
        grads[model] = (wg, stacked_mask(params))

    def same(a, b, what):
        check(all(bitwise_equal(x, y) for x, y in
                  zip(tree_leaves(a), tree_leaves(b))),
              f"figure wire {what}: wire != simulated")
    want, total, cases = {}, {}, 0
    kernels.reset_launch_counts()
    for model, qs in runs.items():
        wg, sm = grads[model]
        for qname, kw in qs:
            for gran in ("layerwise", "entire_model"):
                comp = CompressionConfig(qw=make_compressor(qname, **kw),
                                         granularity=Granularity(gran))
                k = R.fold_in(key, 10_000 + cases)
                sim, _ = aggregate_simulated_workers(wg, sm, comp, k)
                wire, _ = aggregate_simulated_workers(wg, sm, comp, k,
                                                      wire=True)
                same(sim, wire, f"{model} {qname} {kw} {gran}")
                for name in FAMILY[qname]:
                    want[name] = want.get(name, 0) + 1
                cases += 1
    for model, comp in efs:
        wg, sm = grads[model]
        ef = (tree_map(torch.zeros_like, wg) if comp.error_feedback
              else None)
        for i in range(EF_STEPS):
            k = R.fold_in(key, 20_000 + i)
            sim, sim_ef = aggregate_simulated_workers(wg, sm, comp, k,
                                                      ef_state=ef)
            wire, wire_ef = aggregate_simulated_workers(
                wg, sm, comp, k, ef_state=ef, wire=True)
            what = f"{model} ef={comp.error_feedback} step {i}"
            same(sim, wire, what)
            if comp.error_feedback:
                same(sim_ef, wire_ef, what + " EF state")
                ef = sim_ef
            for name in FAMILY[comp.qw.name]:
                want[name] = want.get(name, 0) + 1
        cases += 1
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    full = {k: want.get(k, 0) for k in counts}
    check(counts == full, f"figure wire: launches {counts} != {full}")
    return cases, _nonzero(counts), {m: len(q) for m, q in runs.items()}


def control_phase(dev):
    """Phase 12 -> (its record, its main-path launches per kernel, max
    |err| of the adaptive-k field legs)."""
    import io
    from repro_torch import figures, kernels
    from repro_torch.control import AdaptiveKPolicy, CompressionDecision
    from repro_torch.core import Granularity, make_compressor
    from repro_torch.experiment import (cnn_controller,
                                        train_cnn_with_controller)
    t0 = time.perf_counter()
    base = CompressionDecision(qw=make_compressor("topk",
                                                  ratio=SPARSE_RATIO),
                               granularity=Granularity("layerwise"))
    ctrl = cnn_controller("resnet9", AdaptiveKPolicy(avg_ratio=SPARSE_RATIO),
                          base=base, replan_every=CTRL_REPLAN)
    decisions, inner = [], ctrl.step_fn

    def step_fn():
        decisions.append(ctrl.decision)
        return inner()
    ctrl.step_fn = step_fn
    kernels.reset_launch_counts()
    acc, loss = train_cnn_with_controller("resnet9", ctrl, steps=CTRL_STEPS)
    counts = kernels.launch_counts()
    want = _want_launches(CTRL_LAUNCHES, CTRL_STEPS, SOURCES)
    check({k: counts[k] for k in SOURCES} == want,
          f"controller: launches {counts} != {want}")
    check(math.isfinite(loss) and ctrl.builds == len(set(decisions)) >= 2,
          f"controller: loss {loss}, {ctrl.builds} builds for "
          f"{len(set(decisions))} distinct decisions")
    launches = dict(counts)
    last = ctrl.decision
    legs, err, rel = check_adaptive_wire(last, dev)
    print(f"control (a): cnn_controller resnet9, AdaptiveKPolicy over "
          f"top-k({SPARSE_RATIO}) layerwise, re-plan every {CTRL_REPLAN} of "
          f"{CTRL_STEPS} steps: acc {acc:.3f} loss {loss:.4f}; "
          f"{ctrl.builds} builds for {len(set(decisions))} distinct "
          f"decisions, {len(ctrl.switches)} switches, last "
          f"{last.describe()}; launches {_nonzero(counts)}; its wire step "
          f"bitwise its simulated step; index legs (n, k, width) {legs} in "
          f"one fields_pack / fields_unpack launch each bitwise the plain "
          f"twins (max abs err {err}); telemetry card vs CPU {rel:.2e} "
          f"relative", flush=True)
    ta = time.perf_counter() - t0
    # (b) every sim-exact figure compressor's wire step at the figures'
    # shapes (comparison launches: not added to the main path's)
    tw = time.perf_counter()
    wcases, wlaunch, per_model = check_figure_wire(dev)
    tw = time.perf_counter() - tw
    print(f"control (b): figure shapes, {per_model} sim-exact compressors "
          f"a model x 2 granularities plus ef_beyond_paper's runs: "
          f"{wcases} cases, wire bitwise simulated; launches {wlaunch}; "
          f"{tw:.1f} s", flush=True)
    # (c) the paper's figures at FIG_STEPS steps a run
    t1 = time.perf_counter()
    buf = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        for fig in figures.ALL:
            fig(FIG_STEPS)
    fig_counts = kernels.launch_counts()
    for k, v in fig_counts.items():
        launches[k] = launches.get(k, 0) + v
    rows = [ln.split(",") for ln in buf.getvalue().splitlines()]
    accs = [float(a.split("=")[1]) for _, _, d in rows for a in d.split("|")]
    check(len(rows) == 26 and all(math.isfinite(a) for a in accs),
          f"figures: {len(rows)} rows, accuracies {accs}")
    for ln in buf.getvalue().splitlines():
        print(f"  {ln}", flush=True)
    tb = time.perf_counter() - t1
    print(f"control (c): figures.ALL at {FIG_STEPS} steps a run: "
          f"{len(rows)} rows, every accuracy finite; launches "
          f"{_nonzero(fig_counts)}; {tb:.1f} s", flush=True)
    return ({"seconds": time.perf_counter() - t0, "controller_seconds": ta,
             "figures_seconds": tb, "figure_wire_seconds": tw,
             "figure_wire_cases": wcases, "figure_wire_launches": wlaunch,
             "acc": acc, "loss": loss,
             "builds": ctrl.builds, "switches": ctrl.switches,
             "decisions": [d.describe() for d in decisions],
             "legs": legs, "telemetry_rel_err": rel,
             "launches": counts, "figure_rows": rows,
             "figure_launches": fig_counts}, launches, err)


def _nested(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out



# ---- phase 13: tensor, sequence and FSDP parallelism ------------------------

TP_RANKS = 4
# 13(a): tests/dist_checks.py's five families (its configs and TOL, copied:
# that module imports jax) on the model group of ranks 0 and 1 (data 1,
# model 2), SP off and on, 16 x 32 tokens
TP_FAMILIES = {
    "dense": dict(name="dense", arch_type="dense", n_layers=2, d_model=64,
                  vocab=256, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                  dtype="float32"),
    "moe": dict(name="moe", arch_type="moe", n_layers=2, d_model=64,
                vocab=256, n_heads=4, n_kv_heads=2, d_head=16, d_ff=96,
                n_experts=4, experts_per_token=2, moe_capacity_factor=8.0,
                dtype="float32"),
    "mla": dict(name="mla", arch_type="dense", attention="mla", n_layers=2,
                d_model=64, vocab=256, n_heads=4, n_kv_heads=4, d_head=48,
                d_ff=128, q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=32,
                qk_rope_dim=16, v_head_dim=32, dtype="float32"),
    "ssm": dict(name="ssm", arch_type="ssm", attention="none", n_layers=2,
                d_model=64, vocab=256, d_ff=0, ssm_state=16, ssm_expand=2,
                ssm_head_dim=16, ssm_chunk=8, dtype="float32"),
    "hybrid": dict(name="hybrid", arch_type="hybrid", n_layers=5,
                   d_model=64, vocab=256, n_heads=4, n_kv_heads=4, d_head=16,
                   d_ff=128, ssm_state=16, ssm_expand=2, ssm_head_dim=16,
                   ssm_chunk=8, attn_every=2, dtype="float32"),
}
TP_TOL = {"dense": 1e-4, "moe": 2e-2, "mla": 1e-4, "ssm": 1e-4,
          "hybrid": 1e-4}
# 13(b): phi4-mini at full width cut to 2 layers (lm_full_width) on all four
# ranks as (data 2, model 2), each data rank FULL_ROWS x LM_SEQ tokens,
# three steps from the same params: QSGD(16) layerwise over the simulated
# wire and over the allgather wire, and top-k(1%) over the simulated wire.
# (The simulated records, QSGD.sim on every bucket and the f32 mean, do
# not fit four full-width ranks on one card: rank 0 holds each bucket's
# decode against QSGD.sim of its inputs instead.) The TP shards' layerwise
# plan has 5 buckets (21 units, <= MAX_BUCKETS), so a rank's step
# launches: simulated wire 1 qsgd_pack (every bucket) + 1 qsgd_unpack
# (its own payloads); allgather 1 qsgd_pack + 1 fields_unpack (every
# rank's gathered rows at once); top-k 1 fields_pack + 1 fields_unpack
# (the index legs). Four ranks: 4 x (1 + 1) qsgd_pack, 4 x 1 qsgd_unpack,
# 4 x 1 fields_pack, 4 x (1 + 1) fields_unpack.
TP_STEP_LAUNCHES = {"wire": {"qsgd_pack": 1, "qsgd_unpack": 1},
                    "allgather": {"qsgd_pack": 1, "fields_unpack": 1},
                    "topk_wire": {"fields_pack": 1, "fields_unpack": 1}}
# 13(d): phi4-mini-3.8b whole (32 layers, bf16) served by ranks 0 and 1 as
# model 2: batch 8, TP_PROMPT uniform prompt tokens, TP_GEN tokens
TP_PROMPT, TP_GEN = 128, 16
# bf16 logits: phase 10's decode-vs-prefill bound, of max |logit|
TP_SERVE_BOUND = 5e-2


def _capture_ops(names, cap: dict):
    """Swap kernels.ops entry points `names` for ones that run the kernel
    and keep, of the first call, copies of its arguments and a digest of
    its output in cap[name] (the wire path reuses and drops its buffers
    after a launch) -> a function that puts them back."""
    import torch
    from repro_torch.kernels import ops
    orig = {n: getattr(ops, n) for n in names}

    def keep(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (list, tuple)):
            return [keep(t) for t in x]
        return x

    def wrap(n):
        def f(*a):
            if n in cap:
                return orig[n](*a)
            args = keep(a)
            out = orig[n](*a)
            cap[n] = (args, _digest(out))
            return out
        return f
    for n in names:
        setattr(ops, n, wrap(n))

    def restore():
        for n in names:
            setattr(ops, n, orig[n])
    return restore


def _spans(d: int):
    for lo in range(0, d, LM_SPAN):      # LM_SPAN is a multiple of 32
        yield lo, min(lo + LM_SPAN, d)


def check_captured_wire(name, cap) -> dict:
    """Each captured wire launch (qsgd_pack_buckets, qsgd_unpack_buckets,
    fields_pack_buckets, fields_unpack_buckets at the shapes the TP shards'
    step gave them), launched again on copies of its inputs (its output's
    digest the step's launch's), against the plain versions of the same
    inputs over LM_SPAN-position spans, bitwise; where a step packed and
    decoded its own QSGD payloads (the simulated wire), each bucket's
    decode bitwise QSGD.sim of the packed units and keys (the simulated
    step's values) -> {kernel: max abs err} (0.0)."""
    import torch
    from repro_torch.core.compressors import QSGD
    from repro_torch.kernels import ops
    from repro_torch.kernels import pack as P
    from repro_torch.kernels import qsgd as Q
    errs = {}
    sim = None
    if "qsgd_pack_buckets" in cap and "qsgd_unpack_buckets" in cap:
        sim = {}

    def again(n):
        args, digest = cap.pop(n)
        outs = getattr(ops, n)(*args)
        check(_digest(outs) == digest,
              f"{name}: {n} launched again != the step's launch")
        return args, outs
    if "qsgd_pack_buckets" in cap:
        (xs, k0s, k1s, nrms, levels, width), words = again(
            "qsgd_pack_buckets")
        for b, (x, k0, k1, nrm, w) in enumerate(zip(xs, k0s, k1s, nrms,
                                                    words)):
            if sim is not None:       # the simulated step's values
                keys = torch.stack([k0, k1], 1).to(torch.int64) & 0xFFFFFFFF
                sim[b] = QSGD(levels=levels).sim(x, keys)
            for lo, hi in _spans(x.shape[1]):
                want = Q.qsgd_pack_plain(x, k0, k1, nrm, levels, width, lo, hi)
                w0 = lo // 32 * width
                check(torch.equal(w[:, w0:w0 + want.shape[1]], want),
                      f"{name}: qsgd_pack bucket {b} != plain at {lo}")
        errs["qsgd_pack"] = 0.0
        del xs, words
    if "qsgd_unpack_buckets" in cap:
        (wl, facs, dims, levels, width), outs = again("qsgd_unpack_buckets")
        for b, (w, fac, d, out) in enumerate(zip(wl, facs, dims, outs)):
            for lo, hi in _spans(d):
                w0 = lo // 32 * width
                want = Q.qsgd_unpack_plain(
                    w[:, w0:w0 + -(-(hi - lo) * width // 32)], fac, hi - lo,
                    levels, width)
                check(bitwise_equal(out[:, lo:hi].contiguous(), want),
                      f"{name}: qsgd_unpack bucket {b} != plain at {lo}")
            if sim is not None:
                check(bitwise_equal(out, sim.pop(b)),
                      f"{name}: bucket {b}'s wire decode != QSGD.sim of its "
                      f"units (the simulated step)")
        errs["qsgd_unpack"] = 0.0
        del wl, outs
    if "fields_pack_buckets" in cap:
        (fs, widths), words = again("fields_pack_buckets")
        for b, (f, w, out) in enumerate(zip(fs, widths, words)):
            for lo, hi in _spans(f.shape[1]):
                want = P.fields_pack_plain(f[:, lo:hi].contiguous(), w)
                w0 = lo // 32 * w
                check(torch.equal(out[:, w0:w0 + want.shape[1]], want),
                      f"{name}: fields_pack bucket {b} != plain at {lo}")
        errs["fields_pack"] = 0.0
        del fs, words
    if "fields_unpack_buckets" in cap:
        (wl, ks, widths), outs = again("fields_unpack_buckets")
        for b, (w, k, width, out) in enumerate(zip(wl, ks, widths, outs)):
            for lo, hi in _spans(k):
                w0, nw = lo // 32 * width, -(-(hi - lo) * width // 32)
                want = P.fields_unpack_plain(w[:, w0:w0 + nw], hi - lo, width)
                check(torch.equal(out[:, lo:hi], want),
                      f"{name}: fields_unpack bucket {b} != plain at {lo}")
        errs["fields_unpack"] = 0.0
        del wl, outs
    return errs


def _tp_meshes(rank):
    """The process groups of phase 13: (data 2, model 2) over all four
    ranks (make_host_mesh), and on ranks 0 and 1 a (1, 2) mesh (their
    model group) and a (2, 1) mesh (their data group), each axis of size
    1 a group of its one rank. Every rank creates every group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    full = make_host_mesh(data=2, model=2)
    pair = dist.new_group([0, 1])
    dist.new_group([2, 3])
    single = [dist.new_group([r]) for r in range(TP_RANKS)]
    if rank >= 2:
        return full, None, None
    tp = Mesh(("data", "model"), (1, 2), {"data": single[rank],
                                          "model": pair},
              {"data": 0, "model": rank})
    dp = Mesh(("data", "model"), (2, 1), {"data": pair,
                                          "model": single[rank]},
              {"data": rank, "model": 0})
    return full, tp, dp


def tp_families(mesh, dev):
    """13(a) on ranks 0 and 1: each family's loss and dense-aggregated
    gradients on the (1, 2) mesh, SP off and on, gathered to global
    arrays, against the port's one-device gradients on the card (the same
    params, batch and key) -> {family: {sp: worst rel}}."""
    import dataclasses
    import torch
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves, tree_paths, tree_unflatten
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.launch.engine import Engine
    from repro_torch.models import DistConfig, Model
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.dist import bind_axes
    from repro_torch.optim import OptConfig
    g = torch.Generator().manual_seed(3)
    s = torch.randint(0, 256, (16, 33), generator=g).to(dev)
    batch = {"tokens": s[:, :-1], "targets": s[:, 1:]}
    key = R.key(7)
    out = {}
    for name, kw in TP_FAMILIES.items():
        cfg = ModelConfig(**kw)
        m1 = Model(cfg, DistConfig())
        params = {k: v for k, v in m1.init(R.key(0), device="cpu").items()}
        paths, leaves = tree_paths(params), tree_leaves(params)
        bind_axes({})
        p = [l.to(dev).requires_grad_(True) for l in leaves]
        want = torch.autograd.grad(
            m1.loss(tree_unflatten(paths, p), batch, key), p)
        out[name] = {}
        for sp in (False, True):
            eng = Engine(cfg, mesh, comp=CompressionConfig(strategy="dense"),
                         opt=OptConfig(), device=dev)
            if not sp:
                eng.dist = dataclasses.replace(eng.dist, sp=False)
                eng.model.dist = eng.dist
            eng.bind()
            specs = eng.model.param_pspecs()
            local = eng.shard_tree(params, specs)
            lp = [l.detach().requires_grad_(True) for l in tree_leaves(local)]
            loss = eng.model.loss(tree_unflatten(tree_paths(local), lp),
                                  eng.local_batch(batch), key)
            gl = torch.autograd.grad(loss, lp)
            agg = eng._aggregate_grads(
                tree_unflatten(tree_paths(local), list(gl)), key)
            full = tree_leaves(eng.global_tree(agg, specs))
            worst = max(float((a - b).abs().max() / (b.abs().max() + 1e-9))
                        for a, b in zip(full, want))
            check(worst < TP_TOL[name], f"TP {name} SP={sp}: gradients "
                  f"{worst:.2e} of max |g| from the one-device run")
            out[name]["sp" if sp else "nosp"] = worst
    return out


def _tp_batches(vocab, dev, rows, steps, seed=11):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(steps):
        s = torch.randint(0, vocab, (rows, LM_SEQ + 1), generator=g,
                          device=dev)
        out.append({"tokens": s[:, :-1], "targets": s[:, 1:]})
    return out


def tp_full_width(rank, mesh, dev):
    """13(b) on all four ranks: phi4-mini at full width (2 layers, bf16)
    on the (data 2, model 2) mesh, three steps from the same params and
    batch (TP_STEP_LAUNCHES), launches counted exactly a run; rank 0
    captures each run's wire launches and holds them against the plain
    versions, and the simulated wire's decode against QSGD.sim; the
    allgather step bitwise the simulated wire step (a digest a leaf); each
    step split into forward / backward (the TP and SP collectives' host
    seconds inside), aggregation and update; loss and peak memory a
    rank."""
    import torch
    from repro_torch import kernels
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves
    from repro_torch.core import collectives
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import QSGD, TopK
    from repro_torch.experiment import _full_precision
    from repro_torch.launch.engine import Engine
    from repro_torch.optim import OptConfig, init_opt_state
    _full_precision()
    cfg = lm_full_width()
    torch.cuda.reset_peak_memory_stats(dev)
    qsgd = CompressionConfig(qw=QSGD(levels=MAIN_LEVELS))
    # plain SGD: four full-width ranks on one card leave no room for a
    # momentum buffer (2.9 GB f32 a rank) beside the f32 gathers
    eng = Engine(cfg, mesh, comp=qsgd, opt=OptConfig("sgd", lr=LM_LR),
                 device=dev)
    # every rank draws the global params on the card from one seed, then
    # keeps its shards
    params = eng.shard_tree(eng.model.init(R.key(0), device=dev),
                            eng.model.param_pspecs())
    _free_card()
    state = init_opt_state(eng.opt, params)
    batch = _tp_batches(cfg.vocab, dev, 2 * FULL_ROWS, 1)[0]
    runs = (("wire", qsgd, True, None),
            ("allgather", qsgd, True, "allgather"),
            ("topk_wire", CompressionConfig(qw=TopK(ratio=SPARSE_RATIO)),
             True, None))
    names = ("qsgd_pack_buckets", "qsgd_unpack_buckets",
             "fields_pack_buckets", "fields_unpack_buckets")
    out = {"runs": {}, "errs": {}, "params_local": sum(
        p.numel() for p in tree_leaves(params))}
    digests = {}
    for run, comp, wire, coll in runs:
        step = eng.build_train_step(comp=comp, wire=wire, collective=coll)
        kernels.reset_launch_counts()
        collectives.reset_counts()
        cap = {}
        restore = _capture_ops(names, cap) if rank == 0 else (lambda: None)
        try:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss, grads = step.grads(params, batch, 0)
            ev[1].record()
            ev[1].synchronize()
            tp_s = {c: collectives.counts(c)["seconds"]
                    for c in ("all_gather", "reduce_scatter")}
            tp_calls = {c: collectives.counts(c)["calls"]
                        for c in ("all_gather", "reduce_scatter")}
            agg = step.aggregate(grads, 0)
            ev[2].record()
            del grads
            p1, s1, m = step.update(params, state, loss, agg, 0)
            ev[3].record()
            ev[3].synchronize()
            del agg
        finally:
            restore()
        counts = kernels.launch_counts()
        want = {k: TP_STEP_LAUNCHES[run].get(k, 0) for k in SOURCES}
        check({k: counts[k] for k in SOURCES} == want,
              f"TP full width {run}: launches {counts} != {want}")
        check(math.isfinite(float(m["loss"])),
              f"TP full width {run}: loss {float(m['loss'])}")
        if rank == 0:
            out["errs"].update(check_captured_wire(f"TP full width {run}",
                                                   cap))
        del cap
        digests[run] = {"params": _digest(tree_leaves(p1))}
        out["runs"][run] = {
            "loss": float(m["loss"]), "launches": counts,
            "split_ms": {"forward_backward": ev[0].elapsed_time(ev[1]),
                         "aggregation": ev[1].elapsed_time(ev[2]),
                         "update": ev[2].elapsed_time(ev[3])},
            "tp_collective_host_ms": {c: v * 1e3 for c, v in tp_s.items()},
            "tp_collective_calls": tp_calls}
        del p1, s1
        _free_card()
    check(digests["allgather"] == digests["wire"],
          "TP full width: the allgather step's params != the simulated "
          "wire step's")
    out["digests"] = digests
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del params, state
    _free_card()
    return out


def tp_fsdp(rank, mesh, dev):
    """13(c) on ranks 0 and 1 as (data 2, model 1): phi4-mini at full width
    (2 layers, bf16) with use_fsdp=True, one dense step's aggregated
    gradients (gathered) against the unsharded data-parallel Engine's on
    the same params and batch, within dist_checks' dense TOL; then one
    top-k(1%) step whose first FSDP hook call on a leaf of at most 2^25
    entries is held bitwise against the same _hook_compress on CPU copies
    (the plain top-k)."""
    import dataclasses
    import torch
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves, tree_paths
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import TopK
    from repro_torch.experiment import _full_precision
    from repro_torch.launch.engine import Engine
    from repro_torch.models import dist as D
    from repro_torch.optim import OptConfig, init_opt_state
    _full_precision()
    torch.cuda.reset_peak_memory_stats(dev)
    base = lm_full_width()
    batch = _tp_batches(base.vocab, dev, 2 * FULL_ROWS, 1, seed=13)[0]
    aggs, ms = {}, {}
    # the embedding's gradient is an indexed accumulate: atomics in bf16
    # by default, an order-fixed sort with deterministic algorithms on
    torch.use_deterministic_algorithms(True, warn_only=True)
    for fsdp in (False, True):
        eng = Engine(dataclasses.replace(base, use_fsdp=fsdp), mesh,
                     opt=OptConfig("momentum", lr=LM_LR), device=dev)
        specs = eng.model.param_pspecs()
        params = eng.shard_tree(eng.model.init(R.key(0), device=dev), specs)
        _free_card()
        step = eng.build_train_step()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        _, grads = step.grads(params, batch, 0)
        agg = step.aggregate(grads, 0)
        b.record()
        b.synchronize()
        ms["fsdp" if fsdp else "unsharded"] = a.elapsed_time(b)
        del grads
        full = eng.global_tree(agg, specs)
        aggs[fsdp] = dict(zip(["/".join(p) for p in tree_paths(full)],
                              tree_leaves(full)))
        del agg, full
        if not fsdp:
            del params
            _free_card()
    rel = {k: float((aggs[True][k].float() - y.float()).abs().max()
                    / (y.float().abs().max() + 1e-9))
           for k, y in aggs[False].items()}
    worst_leaf = max(rel, key=rel.get)
    worst = rel[worst_leaf]
    torch.use_deterministic_algorithms(False)
    check(worst < TP_TOL["dense"], f"FSDP dense step: aggregated gradients "
          f"{worst:.2e} of max |g| from the unsharded Engine's (leaf "
          f"{worst_leaf}; {sorted(rel.items(), key=lambda kv: -kv[1])[:4]})")
    del aggs
    _free_card()
    comp = CompressionConfig(qw=TopK(ratio=SPARSE_RATIO))
    step = eng.build_train_step(comp=comp)
    cap = {}
    orig = D._hook_compress

    def hook(g, kb, cfg, dist):
        out = orig(g, kb, cfg, dist)
        if "g" not in cap and cfg is not None and g.numel() <= 1 << 25:
            cap.update(g=g.detach().clone(), kb=kb.detach().clone(),
                       out=out.detach().clone(), cfg=cfg, dist=dist)
        return out
    D._hook_compress = hook
    try:
        p1, _, m = step(params, init_opt_state(eng.opt, params), batch, 1)
    finally:
        D._hook_compress = orig
    check("g" in cap, "FSDP top-k step: no hook call captured")
    eng.bind()
    plain = orig(cap["g"].cpu(), cap["kb"].cpu(), cap["cfg"], cap["dist"])
    check(bitwise_equal(cap["out"].cpu(), plain),
          f"FSDP hook: top-k({SPARSE_RATIO}) on the card != the plain "
          f"top-k of the same {tuple(cap['g'].shape)} gradient")
    out = {"worst_rel": worst, "worst_leaf": worst_leaf, "step_ms": ms,
           "topk_loss": float(m["loss"]),
           "hook_leaf": list(cap["g"].shape),
           "hook_kept": int((cap["out"] != 0).sum()),
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    del p1, params, cap
    _free_card()
    return out


def tp_serve(rank, mesh, dev):
    """13(d) on ranks 0 and 1 as model 2: phi4-mini-3.8b whole (bf16)
    through the Engine's prefill and serve steps, batch 8, TP_PROMPT
    tokens, TP_GEN generated; each rank's cache shard exactly half the
    slots; rank 0 serves the same params one-device with the TP run's
    tokens forced and holds every step's logits within TP_SERVE_BOUND of
    max |logit|; prefill ms, decode ms a token and peak memory a rank."""
    import torch
    from repro_torch import random as R
    from repro_torch.configs import get_config
    from repro_torch.experiment import _full_precision
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.serve import generate, make_batch
    from repro_torch.models import DistConfig, Model
    from repro_torch.models.dist import bind_axes
    _full_precision()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config("phi4-mini-3.8b")
    eng = Engine(cfg, mesh, device=dev)
    full = eng.model.init(R.key(0), device=dev)
    shards = eng.shard_tree(full, eng.model.param_pspecs())
    if rank:
        del full
    _free_card()
    batch = make_batch(cfg, 8, TP_PROMPT, 0, dev)
    res = generate(eng.model, shards, batch, TP_GEN, engine=eng,
                   keep_logits=True)
    clen = eng.model.cache_len(TP_PROMPT + TP_GEN)
    k = res["cache"]["k"]
    check(k.shape[3] * 2 == clen and res["cache"]["slot_pos"].shape[1] * 2
          == clen, f"TP serve: rank {rank}'s cache holds {k.shape[3]} of "
          f"{clen} slots")
    out = {"prefill_ms": res["prefill_ms"],
           "decode_ms_per_token": res["decode_ms_per_token"],
           "tokens_per_s": res["tokens_per_s"],
           "cache_slots": int(k.shape[3]), "cache_len": clen,
           "cache_bytes": sum(t.numel() * t.element_size()
                              for t in res["cache"].values())}
    tokens = res["tokens"]
    logits = [t.float() for t in res["logits"]]
    del res, shards
    _free_card()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if rank == 0:
        bind_axes({})
        one = Model(cfg, DistConfig())
        want = generate(one, full, batch, TP_GEN, forced=tokens,
                        keep_logits=True)
        errs = []
        for i, (got, w) in enumerate(zip(logits, want["logits"])):
            w = w.float()
            e = float((got - w).abs().max() / w.abs().max())
            check(e <= TP_SERVE_BOUND, f"TP serve: step {i}'s logits {e:.2e} "
                  f"of max |logit| from the one-device run's")
            errs.append(e)
        out["logit_rel_err"] = errs
        out["one_device"] = {"prefill_ms": want["prefill_ms"],
                             "decode_ms_per_token":
                                 want["decode_ms_per_token"]}
        del full, want
        eng.bind()
    _free_card()
    return out


def tp_ranks(rank, n, dev):
    """Phase 13's one spawn of TP_RANKS ranks on cuda:0: 13(b) on all four,
    then on ranks 0 and 1 13(a), 13(c) and 13(d)."""
    import torch
    from repro_torch import kernels
    full, tp, dp = _tp_meshes(rank)
    t0 = time.perf_counter()
    out = {"full_width": tp_full_width(rank, full, dev)}
    out["seconds"] = {"full_width": time.perf_counter() - t0}
    out["launches"] = {}
    for r in out["full_width"]["runs"].values():
        for k, v in r["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    if rank >= 2:
        return out
    kernels.reset_launch_counts()
    for name, fn, mesh in (("families", tp_families, tp),
                           ("fsdp", tp_fsdp, dp), ("serve", tp_serve, tp)):
        t0 = time.perf_counter()
        out[name] = fn(mesh, dev) if name == "families" else fn(rank, mesh,
                                                                dev)
        out["seconds"][name] = time.perf_counter() - t0
        torch.cuda.synchronize()
    for k, v in kernels.launch_counts().items():
        out["launches"][k] = out["launches"].get(k, 0) + v
    return out


def tp_phase(dev):
    """Phase 13 -> (its record, its launches per kernel summed over the
    ranks, max abs err per wire kernel checked)."""
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    _free_card()
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = run_ranks(tp_ranks, TP_RANKS, backend="gloo", device="cuda",
                          timeout=RANK_TIMEOUT)
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    want = {k: TP_RANKS * sum(TP_STEP_LAUNCHES[run].get(k, 0)
                              for run in TP_STEP_LAUNCHES) for k in SOURCES}
    check({k: launches.get(k, 0) for k in SOURCES} == want,
          f"phase 13: launches {launches} != {want}")
    fw = [r["full_width"] for r in ranks]
    # rank = d * 2 + m: ranks 0 and 2 hold model shard 0, ranks 1 and 3
    # shard 1, and each pair's data replicas must agree after every step
    check(fw[0]["digests"] == fw[2]["digests"]
          and fw[1]["digests"] == fw[3]["digests"],
          "TP full width: a model shard's data replicas differ")
    check(all(f["runs"][k]["loss"] == fw[0]["runs"][k]["loss"]
              for f in fw for k in fw[0]["runs"]),
          "TP full width: the ranks' losses differ")
    r0 = ranks[0]
    fam = r0["families"]
    print(f"TP (a): dist_checks' five families on 2 gloo ranks (model 2) "
          f"on cuda:0, aggregated gradients against the one-device run: "
          f"worst rel { {k: {s: f'{v:.2e}' for s, v in d.items()} for k, d in fam.items()} } "
          f"(TOL {TP_TOL}); {r0['seconds']['families']:.1f} s", flush=True)
    f0 = fw[0]
    for run, rec in f0["runs"].items():
        print(f"TP (b) phi4-mini full width (2 layers, bf16) on (data 2, "
              f"model 2), {f0['params_local']} params a rank, {run}: loss "
              f"{rec['loss']:.4f}, split ms "
              f"{ {k: round(v, 1) for k, v in rec['split_ms'].items()} }, TP "
              f"collectives' host ms in forward / backward "
              f"{ {k: round(v, 1) for k, v in rec['tp_collective_host_ms'].items()} } "
              f"({rec['tp_collective_calls']} calls), launches a rank "
              f"{_nonzero(rec['launches'])}", flush=True)
    print(f"TP (b): the allgather step bitwise the simulated wire step "
          f"(params; each shard's data replicas equal); rank 0's "
          f"wire launches bitwise the plain versions and its decodes "
          f"QSGD.sim of their units {f0['errs']}; peak "
          f"{[f['peak_bytes'] for f in fw]} B a rank; "
          f"{r0['seconds']['full_width']:.1f} s", flush=True)
    fs = r0["fsdp"]
    print(f"TP (c) FSDP phi4-mini full width on data 2: dense step's "
          f"aggregated gradients {fs['worst_rel']:.2e} of max |g| from the "
          f"unsharded Engine's (ms {fs['step_ms']}); top-k({SPARSE_RATIO}) "
          f"hook on a {fs['hook_leaf']} leaf bitwise the plain top-k "
          f"({fs['hook_kept']} kept); peak {fs['peak_bytes']} B; "
          f"{r0['seconds']['fsdp']:.1f} s", flush=True)
    sv = [r["serve"] for r in ranks[:2]]
    print(f"TP (d) serve phi4-mini whole bf16 on model 2, batch 8, "
          f"{TP_PROMPT} + {TP_GEN} tokens: prefill "
          f"{sv[0]['prefill_ms']:.1f} ms, decode "
          f"{sv[0]['decode_ms_per_token']:.2f} ms a token "
          f"({sv[0]['tokens_per_s']:.1f} tokens/s; one device "
          f"{sv[0]['one_device']}), cache {sv[0]['cache_slots']} of "
          f"{sv[0]['cache_len']} slots a rank ({sv[0]['cache_bytes']} B), "
          f"logits within {max(sv[0]['logit_rel_err']):.2e} of max |logit| "
          f"of the one-device run's; peak {[s['peak_bytes'] for s in sv]} "
          f"B a rank; {r0['seconds']['serve']:.1f} s", flush=True)
    errs = {}
    for k, v in f0["errs"].items():
        errs[k] = max(errs.get(k, 0.0), v)
    return ({"seconds": time.perf_counter() - t0, "ranks": ranks},
            launches, errs)


# ---- phase 14: observability (obs/: recorder, metrics, calibration) ---------

# 14(a): the Engine on a one-rank gloo group in this process, phi4-mini at
# full width (lm_full_width: 2 layers, bf16), FULL_ROWS x LM_SEQ tokens,
# QSGD(16) layerwise over the simulated wire with the per-bucket schedule,
# momentum SGD. Every run steps from the same params, batch and step index,
# untraced, with a disabled TraceRecorder and traced (tracer= and metrics=
# on every run): a step packs its 5 layerwise buckets (21 units) in one
# qsgd_pack launch and decodes them in one qsgd_unpack, traced or not.
OBS_RUNS = ("untraced", "disabled", "traced", "traced", "untraced")
OBS_STEP_LAUNCHES = {"qsgd_pack": 1, "qsgd_unpack": 1}
# the tracer's cost on the aggregation alone: execute_schedule_wire (no
# collective) on the step's gradient tree, untraced and traced in turns,
# a warm-up pair and OBS_COST_REPS timed pairs
OBS_COST_REPS = 10
# 14(b): calibrate at the three default thresholds with reps 3 (a warm-up
# run and 3 timed runs a threshold, each one pack and one unpack launch)
OBS_REPS = 3
# 14(c), inside phase 7's spawn: measure_stream (ring, rs) and
# measure_collective on each rank's resnet9 gradient row, per-bucket
# messages, a warm-up call and OBS_STREAM_REPS timed calls each
OBS_STREAM_REPS = 2
# 14(d): the serve CLI (phi4 smoke) and the train CLI's rank loop (llama3
# smoke, QSGD(16) layerwise over the wire, 2 steps) on the one-rank group
OBS_SERVE_GEN = 4
OBS_TRAIN = ["--arch", "llama3-405b", "--smoke", "--steps", "2", "--data",
             "1", "--backend", "gloo", "--compressor", "qsgd", "--levels",
             str(MAIN_LEVELS), "--granularity", "layerwise", "--wire",
             "--batch", "8", "--seq", "32"]


def _stages_within_wall(summary) -> bool:
    """The sum of a step's stage_us is at most its wall_us, in the integer
    nanoseconds both are rounded from."""
    return (round(sum(v * 1000 for v in summary["stage_us"].values()))
            <= round(summary["wall_us"] * 1000))


def obs_engine(dev):
    """14(a) -> (record, launches, (phi4-mini gradient tree, stacked
    mask) for 14(b))."""
    import torch
    from repro_torch import random as R
    from repro_torch.control.telemetry import payload_bits_per_step
    from repro_torch.convert import tree_leaves
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import QSGD
    from repro_torch.core.granularity import Granularity
    from repro_torch.experiment import _full_precision
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.obs import (MetricsRegistry, TraceRecorder,
                                 validate_chrome_trace)
    from repro_torch.optim import OptConfig, init_opt_state
    _full_precision()
    cfg = lm_full_width()
    comp = CompressionConfig(qw=QSGD(levels=MAIN_LEVELS),
                             granularity=Granularity("layerwise"))
    eng = Engine(cfg, make_host_mesh(data=1), comp=comp,
                 opt=OptConfig("momentum", lr=LM_LR), device=dev)
    params = eng.model.init(R.key(0), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_opt_state(eng.opt, params)
    g = torch.Generator(device=dev).manual_seed(11)
    s = torch.randint(0, cfg.vocab, (FULL_ROWS, LM_SEQ + 1), generator=g,
                      device=dev)
    batch = {"tokens": s[:, :-1], "targets": s[:, 1:]}
    rec = TraceRecorder()
    tracers = {"untraced": None, "disabled": TraceRecorder(enabled=False),
               "traced": rec}
    regs = {k: MetricsRegistry() for k in tracers}
    steps = {k: eng.build_train_step(schedule=0.0, wire=True, tracer=t,
                                     metrics=regs[k])
             for k, t in tracers.items()}
    plan, sched = eng.comm_plans()[0], steps["traced"].schedule
    want_gauges = {"engine/n_dispatches": float(plan.num_dispatches),
                   "engine/n_units": float(plan.num_units),
                   "engine/n_messages": float(sched.num_messages),
                   "engine/fusion_bytes": 0.0,
                   "engine/wire_bits_per_step": float(
                       payload_bits_per_step(plan, comp.qw))}
    for k, reg in regs.items():
        check(reg.counters == {"engine/step_builds": 1.0}
              and reg.gauges == want_gauges,
              f"14(a) {k}: counters {reg.counters}, gauges {reg.gauges} != "
              f"{want_gauges}")
    runs, launches, errs = [], {}, {}
    # the embedding's gradient is an indexed accumulate: atomics in bf16
    # by default, an order-fixed sort with deterministic algorithms on
    # (so two runs of one step can be held bitwise)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs, launches, errs = _obs_runs(steps, params, state, batch, rec,
                                         sched)
        _, grads = steps["untraced"].grads(params, batch, 0)
    finally:
        torch.use_deterministic_algorithms(False)
    cost = obs_tracer_cost(grads, eng.model.stacked())
    differ = {r["run"] + str(i): sum(a != b for a, b in zip(
        r["digest"], runs[0]["digest"])) for i, r in enumerate(runs)}
    check(not any(differ.values()), f"14(a): params / momentum differ "
          f"from the first untraced step's (leaves differing a run: "
          f"{differ})")
    check(all(math.isfinite(r["loss"]) for r in runs), "14(a): losses")
    trace = rec.chrome_trace()
    validate_chrome_trace(trace)
    rec.export(str(ROOT / "chiprun_out" / "obs_trace.json"))
    for e in rec.message_spans():
        check({"compress", "pack", "decode", "collective"}
              <= set(e["args"]["stages"]),
              f"14(a): message {e['args']['message']} stages "
              f"{e['args']['stages']}")
    out = {"params": sum(t.numel() for t in tree_leaves(params)),
           "buckets": len(plan.buckets), "messages": sched.num_messages,
           "gauges": want_gauges, "runs": [
               {k: v for k, v in r.items() if k != "digest"} for r in runs],
           "events": len(trace["traceEvents"]), "errs": errs,
           "tracer_cost": cost,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    del params, state, steps
    return out, launches, (grads, eng.model.stacked())


def _obs_runs(steps, params, state, batch, rec, sched):
    """14(a)'s OBS_RUNS, each one step from `params` / `state`, timed by
    CUDA events, launches counted; the first traced step's wire launches
    captured and held against the plain versions -> (runs, launches,
    max abs err per kernel checked)."""
    import torch
    from repro_torch import kernels
    from repro_torch.convert import tree_leaves
    from repro_torch.obs import format_step_summary
    runs, launches, errs = [], {}, {}
    for name in OBS_RUNS:
        cap = {}
        first_traced = name == "traced" and not rec.steps
        restore = (_capture_ops(["qsgd_pack_buckets", "qsgd_unpack_buckets"],
                                cap) if first_traced else None)
        kernels.reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        try:
            ev[0].record()
            p, st, m = steps[name](params, state, batch, 0)
            ev[1].record()
            ev[1].synchronize()
        finally:
            if restore is not None:
                restore()
        counts = kernels.launch_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        check({k: counts[k] for k in SOURCES}
              == _want_launches(OBS_STEP_LAUNCHES, 1, SOURCES),
              f"14(a) {name}: launches {counts}")
        run = {"run": name, "ms": ev[0].elapsed_time(ev[1]),
               "loss": float(m["loss"]),
               "digest": _digest(tree_leaves(p) + tree_leaves(st))}
        del p, st, m
        if name == "traced":
            summary = rec.finalize_step(len(rec.steps))
            n_spans = len(rec.message_spans(step=summary["step"]))
            check(summary["n_message_spans"] == n_spans
                  == sched.num_messages,
                  f"14(a): {n_spans} message spans, {sched.num_messages} "
                  f"messages")
            check(_stages_within_wall(summary),
                  f"14(a): stage_us {summary['stage_us']} exceed wall_us "
                  f"{summary['wall_us']}")
            run["summary"] = summary
            run["line"] = format_step_summary(summary)
        if first_traced:
            errs = check_captured_wire("14(a) traced step", cap)
            del cap
        runs.append(run)
    return runs, launches, errs


def obs_tracer_cost(tree, stacked) -> dict:
    """14(a)'s tracer cost on the aggregation alone: execute_schedule_wire
    (QSGD(16) layerwise, per-bucket messages, no collective) on the
    phi4-mini gradient tree, untraced and traced in turns (the order
    alternating a pair), a warm-up pair and OBS_COST_REPS timed pairs,
    each call timed by CUDA events; the traced calls' trees and buffers
    bitwise the untraced calls', their message spans num_messages."""
    import statistics

    import torch
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves
    from repro_torch.core import build_plan, build_schedule, wire_codec
    from repro_torch.core.compressors import QSGD
    from repro_torch.core.granularity import Granularity
    from repro_torch.core.wire import execute_schedule_wire
    from repro_torch.obs import TraceRecorder
    sched = build_schedule(build_plan(tree, stacked,
                                      Granularity("layerwise")), 0.0)
    codec = wire_codec(QSGD(levels=MAIN_LEVELS))
    key = R.key(0)
    rec = TraceRecorder()
    ms = {"untraced": [], "traced": []}
    digests = {}
    for r in range(1 + OBS_COST_REPS):
        pair = ("untraced", "traced") if r % 2 else ("traced", "untraced")
        for name in pair:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out, bufs = execute_schedule_wire(
                sched, codec, tree, key,
                recorder=rec if name == "traced" else None)
            ev[1].record()
            ev[1].synchronize()
            if name == "traced":
                summary = rec.finalize_step(r)
                check(summary["n_message_spans"] == sched.num_messages
                      and _stages_within_wall(summary),
                      f"14(a) tracer cost: {summary}")
            if r:
                ms[name].append(ev[0].elapsed_time(ev[1]))
            d = _digest(tree_leaves(out) + list(bufs))
            check(digests.setdefault(name, d) == d,
                  f"14(a) tracer cost: {name} call {r} differs from its "
                  f"first")
            del out, bufs
    check(digests["traced"] == digests["untraced"],
          "14(a) tracer cost: the traced aggregation's tree or buffers "
          "differ from the untraced")
    med = {k: statistics.median(v) for k, v in ms.items()}
    return {"messages": sched.num_messages, "ms": ms, "median_ms": med,
            "spread_ms": {k: max(v) - min(v) for k, v in ms.items()},
            "traced_minus_untraced_ms": med["traced"] - med["untraced"],
            "events_a_step": rec.steps[-1]["n_spans"]}


def obs_card_buffers(tree, stacked, comp, cal, name) -> None:
    """14(b): per threshold, one execute_schedule_wire of `tree` on the
    card under a TraceRecorder: the byte size of every buffer it returned
    equals calibrate's per-message wire_bytes, and it gives calibrate's
    n_messages message spans."""
    from repro_torch import random as R
    from repro_torch.core import build_plan, build_schedule, wire_codec
    from repro_torch.core.granularity import Granularity
    from repro_torch.core.wire import execute_schedule_wire
    from repro_torch.obs import DEFAULT_THRESHOLDS, TraceRecorder
    plan = build_plan(tree, stacked, Granularity("layerwise"))
    for label, fb in DEFAULT_THRESHOLDS:
        t = cal["thresholds"][label]
        rec = TraceRecorder()
        _, bufs = execute_schedule_wire(build_schedule(plan, float(fb)),
                                        wire_codec(comp), tree, R.key(0),
                                        recorder=rec)
        got = [b.numel() * b.element_size() for b in bufs]
        del bufs
        rec.finalize_step(0)
        want = [m["wire_bytes"] for m in t["per_message_measured"]]
        spans = len(rec.message_spans(0))
        check(got == want and spans == t["n_messages"]
              and sum(got) == t["wire_bytes_measured"],
              f"14(b) {name} {label}: the card's buffers {got} B and "
              f"{spans} message spans, calibrate's {want} B and "
              f"{t['n_messages']} messages")


def _calibration_cpu(tree, stacked, comp) -> dict:
    """calibrate's message counts, buffer bytes, model bits and per-message
    bytes of `tree` at DEFAULT_THRESHOLDS, from its plan, schedules and
    layouts on the CPU (no execution: the shapes decide them)."""
    from repro_torch.core.granularity import Granularity
    from repro_torch.core.plan import build_plan
    from repro_torch.core.schedule import build_schedule, simulate_schedule
    from repro_torch.core.wire import message_layouts, wire_codec
    from repro_torch.obs import DEFAULT_THRESHOLDS
    plan = build_plan(tree, stacked, Granularity("layerwise"))
    out = {}
    for label, fb in DEFAULT_THRESHOLDS:
        sched = build_schedule(plan, float(fb))
        lays = message_layouts(sched, wire_codec(comp))
        out[label] = {"n_messages": sched.num_messages,
                      "wire_bytes_measured": sum(l.total_nbytes
                                                 for l in lays),
                      "wire_bits_model": simulate_schedule(
                          sched, qw=comp)["wire_bits_total"],
                      "per_message": [l.total_nbytes for l in lays]}
    return out


def _calibration_counts(cal) -> dict:
    return {label: {"n_messages": t["n_messages"],
                    "wire_bytes_measured": t["wire_bytes_measured"],
                    "wire_bits_model": t["wire_bits_model"],
                    "per_message": [m["wire_bytes"] for m in
                                    t["per_message_measured"]]}
            for label, t in cal["thresholds"].items()}


def obs_calibrate(dev, phi4):
    """14(b): calibrate with QSGD(16) at the three default thresholds and
    reps OBS_REPS on the resnet9 gradient tree and on 14(a)'s phi4-mini
    gradient tree, on the card; counts, bytes and model bits equal the
    CPU's (resnet9: calibrate run on a CPU copy; phi4-mini: its CPU plan,
    schedules and layouts), a structural check, as both sides read the
    layouts; then the buffers the card's wire step returns and its
    message spans are held against the report (obs_card_buffers) ->
    (record, launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch import random as R
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.convert import tree_map
    from repro_torch.core.compressors import QSGD
    from repro_torch.core.granularity import stacked_mask
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.experiment import worker_grads
    from repro_torch.models.cnn import init_cnn
    from repro_torch.obs import DEFAULT_THRESHOLDS, calibrate
    key = R.key(0)
    params = init_cnn(RESNET9, key, device=dev)
    wg, _ = worker_grads(RESNET9, params,
                         classification_batch(R.fold_in(key, 0), 64,
                                              device=dev), 1)
    g9 = tree_map(lambda t: t[0], wg)
    q = QSGD(levels=MAIN_LEVELS)
    trees = (("resnet9", g9, stacked_mask(g9)), ("phi4-mini",) + phi4)
    out, launches = {}, {}
    per_call = len(DEFAULT_THRESHOLDS) * (1 + OBS_REPS)
    for name, tree, sm in trees:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cal = calibrate(name, tree, sm, q, reps=OBS_REPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        check({k: counts[k] for k in SOURCES}
              == _want_launches(OBS_STEP_LAUNCHES, per_call, SOURCES),
              f"14(b) {name}: launches {counts}")
        if name == "resnet9":
            want = _calibration_counts(calibrate(
                name, tree_map(lambda t: t.cpu(), tree), sm, q, reps=1))
        else:
            want = _calibration_cpu(tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype,
                                      device="meta"), tree), sm, q)
        check(_calibration_counts(cal) == want,
              f"14(b) {name}: counts {_calibration_counts(cal)} != the "
              f"CPU's {want}")
        obs_card_buffers(tree, sm, q, cal, name)
        out[name] = dict(cal, seconds=secs)
    return out, launches


def obs_streams(rank, n, dev, wg):
    """14(c) on one rank of phase 7's spawn: measure_stream (ring, rs) and
    measure_collective (allgather) on this rank's resnet9 gradient row
    with QSGD(16), per-bucket messages: hop spans exactly n_messages x
    (n - 1) a call, hop_bytes_total exactly what ring_shift moved a call,
    launches exactly stream_plan's (the collective's 1 qsgd_pack and 1
    fields_unpack) a call -> {mode: report, "launches"}."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.convert import tree_map
    from repro_torch.core import collectives
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import QSGD
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.obs.calibrate import measure_collective, measure_stream
    g = tree_map(lambda t: t[rank], wg)
    sm = stacked_mask(g)
    q = QSGD(levels=MAIN_LEVELS)
    base = CompressionConfig(qw=q, fusion_bytes=0.0,
                             granularity=Granularity("layerwise"))
    calls = 1 + OBS_STREAM_REPS
    out, launches = {}, {}
    for mode, strategy in (("ring", "ring"), ("rs", "rs_stream")):
        layouts, want, hops, nbytes, _ = stream_plan(
            dataclasses.replace(base, strategy=strategy), g, sm, n, None)
        collectives.reset_counts()
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        rep = measure_stream(g, sm, q, 0.0, mode=mode, reps=OBS_STREAM_REPS)
        rep["seconds"] = time.perf_counter() - t0
        got = _launched(before)
        ring = collectives.counts("ring_shift")
        check(rep["n_hop_spans_measured"] == rep["n_hops"]
              == len(layouts) * (n - 1) == hops,
              f"14(c) {mode}: {rep['n_hop_spans_measured']} hop spans, "
              f"{rep['n_hops']} hops, {hops} planned")
        check(ring["sent_bytes"] == calls * rep["hop_bytes_total"] == calls
              * nbytes and ring["calls"] == calls * hops,
              f"14(c) {mode}: ring_shift moved {ring}, the report "
              f"{rep['hop_bytes_total']} B a call, planned {nbytes}")
        check(got == {k: calls * v for k, v in want.items()},
              f"14(c) {mode}: launches {got} != {calls} x {want}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        out[mode] = rep
    collectives.reset_counts()
    before = kernels.launch_counts()
    rep = measure_collective(g, sm, q, 0.0, reps=OBS_STREAM_REPS)
    got = _launched(before)
    gathers = collectives.counts("all_gather")
    check(got == {"qsgd_pack": calls, "fields_unpack": calls},
          f"14(c) collective: launches {got}")
    check(gathers["calls"] == calls * rep["n_messages"],
          f"14(c) collective: {gathers['calls']} all_gathers for {calls} x "
          f"{rep['n_messages']} messages")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    out["collective"] = rep
    out["launches"] = launches
    return out


def obs_stream_ranks(rank, n, dev):
    """14(c) in a rank spawn of its own (tools/obs_phase_probe.py; the
    whole script runs obs_streams inside phase 7's spawn)."""
    _, wg = _fixed_gradients(rank, n, dev)
    return obs_streams(rank, n, dev, wg)


def obs_clis(dev):
    """14(d): the serve CLI with --trace-out / --metrics-out (phi4 smoke,
    OBS_SERVE_GEN tokens) and the train CLI's rank loop with both (on the
    one-rank group), on the card -> (record, launches)."""
    import io
    from repro_torch import kernels
    from repro_torch.launch import serve, train
    from repro_torch.obs import read_jsonl, validate_chrome_trace
    out_dir = ROOT / "chiprun_out"
    out, launches = {}, {}
    kernels.reset_launch_counts()
    paths = [out_dir / "obs_serve_trace.json",
             out_dir / "obs_serve_metrics.jsonl"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", "phi4-mini-3.8b", "--smoke", "--gen",
                    str(OBS_SERVE_GEN), "--trace-out", str(paths[0]),
                    "--metrics-out", str(paths[1])])
    launches.update(kernels.launch_counts())
    trace = json.loads(paths[0].read_text())
    validate_chrome_trace(trace)
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    check([e["name"] for e in spans]
          == ["prefill"] + ["decode"] * (OBS_SERVE_GEN - 1),
          f"14(d) serve: spans {[e['name'] for e in spans]}")
    (line,) = read_jsonl(str(paths[1]))
    hist = line["histograms"]["serve/decode_us"]
    check(hist["count"] == OBS_SERVE_GEN - 1
          and line["counters"]["serve/requests"] == 1.0,
          f"14(d) serve: metrics {line}")
    out["serve"] = {"lines": buf.getvalue().splitlines(),
                    "span_us": [(e["name"], e["dur"]) for e in spans],
                    "decode_us": hist,
                    "prefill_us": line["gauges"]["serve/prefill_us"]}
    paths = [out_dir / "obs_train_trace.json",
             out_dir / "obs_train_metrics.jsonl"]
    args = train._parse(OBS_TRAIN + ["--trace-out", str(paths[0]),
                                     "--metrics-out", str(paths[1])])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train._train_rank(0, 1, dev, args, False)
    for k, v in res["launches"].items():
        launches[k] = launches.get(k, 0) + v
    check({k: res["launches"][k] for k in SOURCES}
          == _want_launches(OBS_STEP_LAUNCHES, 2, SOURCES),
          f"14(d) train: launches {res['launches']}")
    trace = json.loads(paths[0].read_text())
    validate_chrome_trace(trace)
    lines = read_jsonl(str(paths[1]))
    msgs = lines[-1]["gauges"]["engine/n_dispatches"]   # per-bucket
    per_step = [st["n_message_spans"] for st in trace["metadata"]["steps"]]
    check(per_step == [msgs] * 2 and lines[-1]["counters"]["train/steps"]
          == 2.0, f"14(d) train: message spans a step {per_step}, "
          f"{msgs} messages; metrics {lines[-1]}")
    out["train"] = {"lines": buf.getvalue().splitlines(),
                    "message_spans": per_step, "losses": res["losses"],
                    "metrics": lines[-1],
                    "steps": trace["metadata"]["steps"]}
    return out, launches


def obs_phase(dev, streams):
    """Phase 14: (a), (b) and (d) on a one-rank gloo group opened in this
    process; `streams` are (c)'s reports from phase 7's ranks -> (record,
    launches of (a)-(d) per kernel)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    _free_card()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)    # the exported files
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    try:
        eng, counts, phi4 = obs_engine(dev)
        add(counts)
        t1 = time.perf_counter()
        cal, counts = obs_calibrate(dev, phi4)
        add(counts)
        del phi4
        _free_card()
        t2 = time.perf_counter()
        cli, counts = obs_clis(dev)
        add(counts)
    finally:
        dist.destroy_process_group()
    for r in streams:
        add(r["launches"])
    secs = time.perf_counter() - t0
    ms = {k: [r["ms"] for r in eng["runs"] if r["run"] == k]
          for k in ("untraced", "disabled", "traced")}
    later = [r["ms"] for r in eng["runs"][1:]]   # the first warms up
    print(f"obs (a): phi4-mini full width ({eng['params']} params, 2 "
          f"layers, bf16) on a one-rank gloo group, QSGD({MAIN_LEVELS}) "
          f"layerwise over the simulated wire, {eng['buckets']} buckets, "
          f"{eng['messages']} messages a step: params and momentum bitwise "
          f"equal untraced / disabled / traced, launches {OBS_STEP_LAUNCHES} "
          f"every run, the traced step's wire launches bitwise the plain "
          f"versions {eng['errs']}, gauges {eng['gauges']}; step ms (CUDA "
          f"events, in run order {OBS_RUNS}) untraced {ms['untraced']}, "
          f"disabled {ms['disabled']}, traced {ms['traced']} (spread of the "
          f"traced {max(ms['traced']) - min(ms['traced']):.1f}, of every "
          f"run after the first {max(later) - min(later):.1f}); "
          f"{eng['events']} trace events; peak {eng['peak_bytes']} B; "
          f"{t1 - t0:.1f} s", flush=True)
    for r in eng["runs"]:
        if "line" in r:
            print(f"  (a) {r['line']}", flush=True)
    c = eng["tracer_cost"]
    print(f"obs (a) tracer cost on the aggregation alone "
          f"(execute_schedule_wire, {c['messages']} messages, no "
          f"collective, {c['events_a_step']} spans a traced call; outputs "
          f"and buffers bitwise): ms (CUDA events, {OBS_COST_REPS} calls "
          f"each, in turns) untraced {c['ms']['untraced']}, traced "
          f"{c['ms']['traced']}; medians {c['median_ms']}, spreads "
          f"{c['spread_ms']}, traced - untraced "
          f"{c['traced_minus_untraced_ms']:.4f} ms", flush=True)
    for name, c in cal.items():
        fit = next(iter(c["fit_by_host"].values()))
        rows = "; ".join(
            f"{label} {t['n_messages']} messages {t['wire_bytes_measured']} "
            f"B measured {t['exposed_comm_us_measured']:.1f} us, model "
            f"{t['exposed_comm_us_model']:.1f} us, error ratio default "
            f"{t['model_error_ratio_default']} fitted "
            f"{t['model_error_ratio_fitted']}"
            for label, t in c["thresholds"].items())
        print(f"obs (b) calibrate {name} QSGD({MAIN_LEVELS}) reps "
              f"{OBS_REPS}: counts and bytes == the CPU's, the card's buffers "
              f"and message spans == the report; fit alpha "
              f"{fit['alpha_us']} us, gbps {fit['gbps']} (us/B "
              f"{fit['us_per_byte']}, resid {fit['resid_rms_us']} us, "
              f"degenerate {fit['fit_degenerate']}); {rows}; "
              f"{c['seconds']:.1f} s", flush=True)
    s0 = streams[0]
    for mode in ("ring", "rs"):
        r = s0[mode]
        print(f"obs (c) measure_stream {mode} on {r['n_workers']} gloo "
              f"ranks (resnet9, per-bucket): {r['n_messages']} messages, "
              f"{r['n_hop_spans_measured']} hop spans (== {r['n_hops']}), "
              f"{r['hop_bytes_total']} hop B a call (== ring_shift's), hop "
              f"{r['hop_us']:.1f} us, total {r['total_us']:.1f} us, stages "
              f"{r['stage_us']}; {r['seconds']:.1f} s", flush=True)
    r = s0["collective"]
    print(f"obs (c) measure_collective allgather: {r['n_messages']} "
          f"messages, {r['wire_bytes']} B, total {r['total_us']:.1f} us, "
          f"stages {r['stage_us']}", flush=True)
    sv, tr = cli["serve"], cli["train"]
    print(f"obs (d) serve --trace-out --metrics-out (phi4 smoke, "
          f"{OBS_SERVE_GEN} tokens): spans {sv['span_us']}, decode_us "
          f"{sv['decode_us']}, prefill_us {sv['prefill_us']:.1f}", flush=True)
    print(f"obs (d) train rank loop --trace-out --metrics-out (llama3 "
          f"smoke, 2 steps): message spans a step {tr['message_spans']}, "
          f"losses {tr['losses']}, gauges {tr['metrics']['gauges']}",
          flush=True)
    print(f"phase 14: {secs:.1f} s here (a {t1 - t0:.1f}, b {t2 - t1:.1f}, "
          f"d {secs - (t2 - t0):.1f}) + (c) inside phase 7", flush=True)
    return ({"seconds": secs, "engine": eng, "calibrate": cal,
             "streams": streams, "cli": cli}, launches)


# ---- phase 15: the simulated cluster and the resilience plane ---------------

# 15(a): the faulted full-width aggregate runs in this order (the last two
# again for the step times); each is one aggregate_simulated_workers call of
# QSGD(16) layerwise on 2 workers: phi4-mini's 5 layerwise buckets at 2
# layers (<= MAX_BUCKETS) encode in 1 qsgd_pack and decode in 1 qsgd_unpack
# launch,
# and a fault injector without error feedback adds no launch (the received
# regions go through the same one decode), so 15(a) counts 6 qsgd_pack and
# 6 qsgd_unpack launches
RESIL_RUNS = ("clean", "resend", "no_resend", "prob0", "clean", "resend")
RESIL_WORKERS = 2
# 15(b): the faults leg's cell (resnet9, top-k 0.25 with EF, integrity),
# RESIL_STEPS steps a run, the first RESIL_CPU_STEPS also on the CPU
RESIL_STEPS, RESIL_CPU_STEPS, RESIL_KILL = 8, 3, 4
# 15(d): one campaign cell a reference scenario
SCEN_STEPS = 3


def resil_launches_b(steps: int) -> dict:
    """15(b)'s exact launches. A top-k EF wire step of resnet9 (11
    layerwise buckets or 1 entire-model bucket) packs its index legs in 1
    fields_pack and unpacks them in 1 fields_unpack; under an injector
    that touches bytes the receiver's regions decode in 1 more
    fields_unpack (the residual stays the clean decode's). Runs: clean
    and faulted (resend) at each granularity (steps each), the resume
    pair (k steps, then steps - k, faulted, whatever k), the guard pair (1
    clean step, then 2 with the second poisoned): packs 4 steps + steps +
    3 and unpacks 2 steps (clean) + 4 steps (faulted) + 2 steps (resume,
    faulted) + 3."""
    return {"fields_pack": 5 * steps + 3, "fields_unpack": 8 * steps + 3}


def _tree_equal(a, b) -> bool:
    import torch
    from repro_torch.convert import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def resil_full_width(dev):
    """15(a): aggregate_simulated_workers(wire=True) at phi4-mini's full
    width (2 layers, bf16; two param draws as the 2 workers' gradients),
    QSGD(16) layerwise with the integrity word: under prob=1 bit flips with
    resend the aggregate is bitwise the faults=None one and every message
    is detected and resent (2 x n_messages); without resend every message
    is detected and the aggregate differs; a prob=0 injector runs the
    clean call's launches and bits. Aggregate ms from CUDA events (the
    allocator's cache kept between runs), peak memory a run -> (record,
    launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.core import (CompressionConfig, Granularity,
                                  aggregate_simulated_workers, build_plan,
                                  build_schedule)
    from repro_torch.core.compressors import QSGD
    from repro_torch.models import DistConfig, Model
    from repro_torch.resil import FaultInjector
    from repro_torch.sim import CorruptionSpec
    _free_card()
    cfg = lm_full_width()
    model = Model(cfg, DistConfig())
    draws = [model.init(R.key(150 + w), device=dev)
             for w in range(RESIL_WORKERS)]
    wg = tree_map(lambda *xs: torch.stack(xs), *draws)
    del draws
    sm = model.stacked()
    comp = CompressionConfig(qw=QSGD(levels=MAIN_LEVELS),
                             granularity=Granularity("layerwise"),
                             integrity=True)
    one = tree_map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype,
                                         device="meta"), wg)
    plan = build_plan(one, sm, comp.granularity)
    n_msgs = build_schedule(plan, 0.0).num_messages
    params = sum(x[0].numel() for x in tree_leaves(wg))
    key = R.key(15)
    specs = {"clean": None,
             "resend": (CorruptionSpec(prob=1.0, seed=3), True),
             "no_resend": (CorruptionSpec(prob=1.0, seed=3), False),
             "prob0": (CorruptionSpec(prob=0.0), True)}
    runs, launches, ref = [], {}, None
    for name in RESIL_RUNS:
        spec = specs[name]
        inj = None if spec is None else FaultInjector(spec[0],
                                                      resend=spec[1])
        torch.cuda.reset_peak_memory_stats(dev)
        before = kernels.launch_counts()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(dev)
        e0.record()
        out = aggregate_simulated_workers(wg, sm, comp, key, wire=True,
                                          faults=inj)
        e1.record()
        torch.cuda.synchronize(dev)
        got = _launched(before)
        check(got == {"qsgd_pack": 1, "qsgd_unpack": 1},
              f"15(a) {name}: launches {got}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        rec = {"run": name, "ms": e0.elapsed_time(e1),
               "peak_bytes": torch.cuda.max_memory_allocated(dev),
               "launches": got}
        if inj is not None:
            info = {k: int(v) for k, v in out[-1].items()}
            rec["info"] = info
            if name in ("resend", "no_resend"):
                want = RESIL_WORKERS * n_msgs
                check(info["messages"] == info["corrupt_detected"] == want
                      and info["resends"] == (want if spec[1] else 0),
                      f"15(a) {name}: counters {info}, want {want} "
                      f"messages all detected")
            else:
                check(info == {"messages": 0, "corrupt_detected": 0,
                               "resends": 0}, f"15(a) prob0: {info}")
        if ref is None:
            ref = out[0]
        else:
            same = _tree_equal(out[0], ref)
            rec["bitwise_clean"] = same
            check(same == (name != "no_resend"),
                  f"15(a) {name}: aggregate "
                  f"{'differs from' if not same else 'equals'} the clean "
                  f"one")
        del out
        runs.append(rec)
    del ref, wg
    _free_card()
    return ({"params": params, "buckets": len(plan.buckets),
             "messages": n_msgs, "workers": RESIL_WORKERS, "runs": runs},
            launches)


def resil_resnet9(dev):
    """15(b): train_resilient on the faults leg's cell (resnet9, top-k 0.25
    with EF and the integrity word, both granularities, RESIL_STEPS steps)
    under deterministic algorithms, TF32 off: heavy receive corruption
    (prob 0.5, 2 bit flips) with resend is bitwise the clean trajectory
    (losses, params, EF); train RESIL_STEPS == train RESIL_KILL, resume,
    train the rest, leaf for leaf; a non-finite grad_hook step leaves
    params and EF as they were; the clean layerwise run's first
    RESIL_CPU_STEPS losses within Queue 3 item 2 (1e-2 relative) of the
    CPU's run of the same cell -> (record, launches)."""
    import tempfile
    import torch
    from repro_torch import kernels
    from repro_torch.convert import tree_map
    from repro_torch.faults import LR, _cnn_comp
    from repro_torch.resil import RecoveryConfig, train_resilient
    from repro_torch.scenarios import _CnnRunner
    from repro_torch.sim import CorruptionSpec, Scenario
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    clean = Scenario(name="clean", n_workers=4)
    bad = Scenario(name="corrupt", n_workers=4,
                   corruption=CorruptionSpec(prob=0.5, n_bits=2, seed=21))
    before = kernels.launch_counts()
    out = {}

    def train(device, scen, gran, steps, **kw):
        t0 = time.perf_counter()
        r = train_resilient(_CnnRunner(device), scen, _cnn_comp(gran),
                            steps=steps, lr=LR, seed=17, **kw)
        r["seconds"] = time.perf_counter() - t0
        return r
    try:
        runs = {}
        for gran in ("layerwise", "entire_model"):
            c = train(dev, clean, gran, RESIL_STEPS,
                      recovery=RecoveryConfig(resend=False))
            f = train(dev, bad, gran, RESIL_STEPS,
                      recovery=RecoveryConfig(resend=True))
            det = f["counters"]["resil/corrupt_detected"]
            check(det > 0 and f["counters"]["resil/resends"] == det,
                  f"15(b) {gran}: counters {f['counters']}")
            check(f["losses"] == c["losses"] and _tree_equal(
                f["params"], c["params"]) and _tree_equal(f["ef"], c["ef"]),
                f"15(b) {gran}: the faulted run with resend is not bitwise "
                f"the clean run")
            runs[gran] = (c, f)
            out[gran] = {"losses": c["losses"], "detected": det,
                         "clean_seconds": c["seconds"],
                         "faulted_seconds": f["seconds"]}
        full = runs["layerwise"][1]
        with tempfile.TemporaryDirectory() as d:
            train(dev, bad, "layerwise", RESIL_KILL, ckpt_dir=d,
                  ckpt_every=RESIL_KILL)
            res = train(dev, bad, "layerwise", RESIL_STEPS, ckpt_dir=d,
                        ckpt_every=RESIL_KILL, resume=True)
        check(_tree_equal(res["params"], full["params"])
              and _tree_equal(res["ef"], full["ef"])
              and res["losses"] == full["losses"][RESIL_KILL:]
              and res["counters"] == full["counters"],
              "15(b) resume: not bitwise the uninterrupted run")
        calls = []

        def poison(wg, key):
            calls.append(1)
            return tree_map(lambda g: torch.full_like(g, torch.nan)
                            if len(calls) == 2 else g, wg)
        one = train(dev, clean, "layerwise", 1)
        guard = train(dev, clean, "layerwise", 2, grad_hook=poison)
        check(guard["counters"]["resil/steps_skipped"] == 1
              and _tree_equal(guard["params"], one["params"])
              and _tree_equal(guard["ef"], one["ef"]),
              "15(b) step guard: params or EF moved on a skipped step")
        launches = _launched(before)
        want = resil_launches_b(RESIL_STEPS)
        check(launches == want, f"15(b): launches {launches} != {want}")
        cpu = train("cpu", clean, "layerwise", RESIL_CPU_STEPS,
                    recovery=RecoveryConfig(resend=False))
        card = runs["layerwise"][0]["losses"][:RESIL_CPU_STEPS]
        rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu["losses"]))
        check(rel <= 1e-2, f"15(b): card losses {card} vs CPU "
              f"{cpu['losses']} ({rel:.2e} relative)")
        out.update({"resume_seconds": res["seconds"], "cpu_losses":
                    cpu["losses"], "cpu_rel_err": rel,
                    "cpu_seconds": cpu["seconds"]})
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    return out, launches


def resil_campaign(dev):
    """15(d): one campaign cell a reference scenario (resnet9, top-k 0.25
    with EF, layerwise, SCEN_STEPS steps; repro_torch.scenarios._run_cell):
    finite losses and the exposed-comm accounting; and the identity
    scenario (every knob present and neutral) and the clean one are
    bitwise the bare aggregate_simulated_workers on resnet9 gradients of
    4 workers, sim and wire, with EF -> record."""
    from repro_torch import random as R
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.core import (CompressionConfig, Granularity,
                                  aggregate_simulated_workers,
                                  make_compressor, stacked_mask)
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.experiment import worker_grads
    from repro_torch.models.cnn import init_cnn
    from repro_torch import scenarios as S
    from repro_torch.sim import (RescaleEvent, Scenario, SimCluster,
                                 StragglerSpec, init_ef)
    runner = S._CnnRunner(dev)
    cells = {}
    for sc in S.scenarios_for(SCEN_STEPS):
        t0 = time.perf_counter()
        c = S._run_cell("resnet9", runner, sc, 0.25, "layerwise",
                        SCEN_STEPS)
        check(all(math.isfinite(v) for v in c["loss_curve"]),
              f"15(d) {sc.name}: losses {c['loss_curve']}")
        cells[sc.name] = {"losses": c["loss_curve"],
                          "exposed_comm_us_per_step":
                              c["exposed_comm_us_per_step"],
                          "straggler_hits": c["straggler_hits"],
                          "seconds": time.perf_counter() - t0}
    params = init_cnn(RESNET9, R.key(0), device=dev)
    wg, _ = worker_grads(RESNET9, params, classification_batch(
        R.fold_in(R.key(0), 0), 64, device=dev), 4)
    sm = stacked_mask(params)
    ident = Scenario(name="identity", n_workers=4,
                     straggler=StragglerSpec(prob=0.5, delay_us=0.0,
                                             seed=11),
                     rescales=(RescaleEvent(step=3, world_size=4),))
    comp = CompressionConfig(qw=make_compressor("topk", ratio=0.25),
                             granularity=Granularity("layerwise"),
                             error_feedback=True)
    ef = init_ef(params, 4)
    for sc in (ident, Scenario(name="clean", n_workers=4)):
        check(sc.is_identity(), f"15(d) {sc.name} is not at identity")
        for wire in (False, True):
            got = SimCluster(sc, comp).aggregate(wg, sm, R.key(5),
                                                 ef_state=ef, wire=wire)
            want = aggregate_simulated_workers(wg, sm, comp, R.key(5),
                                               ef_state=ef, wire=wire)
            check(_tree_equal(got[0], want[0])
                  and _tree_equal(got[1], want[1]),
                  f"15(d) {sc.name} wire={wire}: not the bare aggregate")
    return {"cells": cells}


def resil_phase(dev, ranks):
    """Phase 15; `ranks` are (c)'s records from phase 7's ranks ->
    (record, launches of (a)-(d) per kernel)."""
    import torch
    t0 = time.perf_counter()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    full, counts = resil_full_width(dev)
    add(counts)
    t1 = time.perf_counter()
    r9, counts = resil_resnet9(dev)
    add(counts)
    t2 = time.perf_counter()
    camp = resil_campaign(dev)
    t3 = time.perf_counter()
    for r in ranks:
        add(r["launches"])
    ms = {name: [r["ms"] for r in full["runs"] if r["run"] == name]
          for name in dict.fromkeys(RESIL_RUNS)}
    peak = max(r["peak_bytes"] for r in full["runs"])
    print(f"resil (a): phi4-mini full width ({full['params']} params, 2 "
          f"layers, bf16), {full['workers']} workers, QSGD({MAIN_LEVELS}) "
          f"layerwise with the integrity word, {full['buckets']} buckets = "
          f"{full['messages']} messages a worker: prob=1 bit flips with "
          f"resend bitwise the clean aggregate, every message detected and "
          f"resent; without resend all detected and the aggregate differs; "
          f"prob 0 the clean launches and bits; aggregate ms (CUDA events, "
          f"in run order {RESIL_RUNS}) {ms}; peak {peak} B "
          f"({peak / 2**30:.2f} GiB); {t1 - t0:.1f} s", flush=True)
    print(f"resil (b): resnet9 train_resilient (top-k 0.25 EF, "
          f"{RESIL_STEPS} steps): corrupted with resend bitwise clean "
          f"(detected: layerwise {r9['layerwise']['detected']}, "
          f"entire-model {r9['entire_model']['detected']}), resume at "
          f"{RESIL_KILL} bitwise, the step guard holds params and EF, "
          f"card vs CPU losses {r9['cpu_rel_err']:.2e} relative over "
          f"{RESIL_CPU_STEPS} steps; run seconds clean / faulted: layerwise "
          f"{r9['layerwise']['clean_seconds']:.2f} / "
          f"{r9['layerwise']['faulted_seconds']:.2f}, entire-model "
          f"{r9['entire_model']['clean_seconds']:.2f} / "
          f"{r9['entire_model']['faulted_seconds']:.2f}, CPU "
          f"{r9['cpu_seconds']:.2f}; {t2 - t1:.1f} s", flush=True)
    for name, c in ranks[0]["runs"].items():
        print(f"resil (c) {name}: {c}", flush=True)
    for name, c in camp["cells"].items():
        print(f"resil (d) {name}: losses {c['losses']}, exposed comm "
              f"{c['exposed_comm_us_per_step']} us a step (model), "
              f"straggler hits {c['straggler_hits']}, "
              f"{c['seconds']:.1f} s", flush=True)
    secs = time.perf_counter() - t0
    print(f"phase 15: {secs:.1f} s here (a {t1 - t0:.1f}, b {t2 - t1:.1f}, "
          f"d {t3 - t2:.1f}) + (c) inside phase 7", flush=True)
    torch.cuda.synchronize(dev)
    return ({"seconds": secs, "full_width": full, "resnet9": r9,
             "campaign": camp, "ranks": ranks}, launches)


# ---- phase 7: the multi-rank path (runs inside each rank process) ----------

def _flat(tree):
    import torch
    from repro_torch.convert import tree_leaves
    return torch.cat([leaf.reshape(-1) for leaf in tree_leaves(tree)])


def _equal_on_all_ranks(t) -> bool:
    from repro_torch.core.collectives import all_gather
    g = all_gather(t)
    return all(bitwise_equal(g[i], g[0]) for i in range(1, g.shape[0]))


def _oracle(cfg, wg, m, key, rank, n):
    """Algorithm 1 in compressed_allreduce's key scheme on one process:
    per rank r, Q_W on its units keyed by fold_in(unit key, r) (with error
    feedback when m is given), then the rank-order mean -> (mean tree,
    this rank's new EF tree or None)."""
    import torch
    from repro_torch import random as R
    from repro_torch.convert import tree_map
    from repro_torch.core.aggregation import worker_mean
    from repro_torch.core.granularity import stacked_mask
    from repro_torch.core.plan import build_plan
    g0 = tree_map(lambda t: t[0], wg)
    plan = build_plan(g0, stacked_mask(g0), cfg.granularity)
    ys, mine = [], None
    for r in range(n):
        gr = tree_map(lambda t: t[r], wg)
        if m is None:
            ys.append(plan.execute(
                lambda x, k: cfg.qw.sim(x, R.fold_in(k, r)), gr, key))
            continue

        def fn(x, mm, k):
            e = x + mm
            q = cfg.qw.sim(e, R.fold_in(k, r))
            return q, e - q
        y, mn = plan.execute_with_state(fn, gr, tree_map(lambda t: t[r], m),
                                        key)
        ys.append(y)
        mine = mn if r == rank else mine
    mean = tree_map(lambda *ls: worker_mean(torch.stack(ls)), *ys)
    return mean, mine


def _fixed_gradients(rank, n, dev):
    """Every rank builds the same n workers' resnet9 gradients (cuDNN set
    deterministic for this, so every rank's bytes are the same)."""
    import torch
    from repro_torch import random as R
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.experiment import worker_grads
    from repro_torch.models.cnn import init_cnn
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        key = R.key(0)
        params = init_cnn(RESNET9, key, device=dev)
        batch = classification_batch(R.fold_in(key, 0), 64, device=dev)
        wg, _ = worker_grads(RESNET9, params, batch, n)
    finally:
        torch.backends.cudnn.deterministic = False
    check(_equal_on_all_ranks(_flat(wg)), "ranks built different gradients")
    return params, wg


def _comps():
    from repro_torch.core.compressors import (QSGD, NaturalCompression,
                                              SignSGD, TernGrad, TopK)
    return (QSGD(levels=MAIN_LEVELS), TernGrad(), SignSGD(),
            NaturalCompression(), TopK(ratio=SPARSE_RATIO))


def gate_fixed_gradients(rank, n, dev, params, wg):
    """(a): compressed_allreduce on this rank's row equals the single-process
    Algorithm 1 (and aggregate_simulated_workers for the key-free signSGD
    and top-k) bit for bit, the same on every rank, and with wire=True its
    collectives move comm_report's bytes; integrity words verify and leave
    payloads and outputs unchanged. -> configurations run."""
    import dataclasses
    import torch
    from repro_torch import random as R
    from repro_torch.convert import tree_map
    from repro_torch.core import collectives, wire
    from repro_torch.core.bits import comm_report
    from repro_torch.core.aggregation import (CompressionConfig,
                                              aggregate_simulated_workers,
                                              compressed_allreduce)
    from repro_torch.core.compressors import SignSGD, TopK
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.core.schedule import build_schedule
    key = R.key(7)
    sm = stacked_mask(params)
    g = tree_map(lambda t: t[rank], wg)
    m_all = tree_map(lambda t: 0.01 * t.flip(0), wg)
    runs = [(c, gran, False) for c in _comps()
            for gran in ("layerwise", "entire_model")]
    runs += [(c, "layerwise", True) for c in _comps()
             if c.name in ("qsgd", "topk")]
    done, outs = 0, {}
    for comp, gran, ef in runs:
        base = CompressionConfig(qw=comp, granularity=Granularity(gran),
                                 error_feedback=ef)
        m = m_all if ef else None
        want, want_m = _oracle(base, wg, m, key, rank, n)
        if isinstance(comp, (SignSGD, TopK)):
            sim, sim_m = aggregate_simulated_workers(wg, sm, base, key,
                                                     ef_state=m)
            check(bitwise_equal(_flat(sim), _flat(want)),
                  f"{comp.name} {gran}: simulated workers != oracle")
        for strategy in ("simulated", "allgather"):
            for wire_on in (False, True):
                cfg = dataclasses.replace(base, strategy=strategy)
                collectives.reset_counts()
                out, m_new = compressed_allreduce(
                    g, sm, cfg, None, key, n,
                    ef_state=tree_map(lambda t: t[rank], m) if ef else None,
                    wire=wire_on)
                moved = collectives.counts()
                what = f"{comp.name} {gran} {strategy} wire={wire_on} ef={ef}"
                if wire_on:
                    rep = comm_report(cfg, build_plan(g, sm, cfg.granularity),
                                      n, measured=True)
                    down = (rep.downlink_bits_per_worker
                            if strategy == "allgather"
                            else (n - 1) * rep.uplink_bits_per_worker)
                    check(8 * moved["sent_bytes"] == rep.uplink_bits_per_worker
                          and 8 * moved["recv_bytes"] == down,
                          f"{what}: collectives moved {moved}, comm_report "
                          f"{rep}")
                check(bitwise_equal(_flat(out), _flat(want)),
                      f"{what}: != single-process Algorithm 1")
                check(_equal_on_all_ranks(_flat(out)),
                      f"{what}: ranks disagree")
                if ef:
                    check(bitwise_equal(_flat(m_new), _flat(want_m)),
                          f"{what}: EF residual != single-process")
                outs[(comp.name, gran, strategy, wire_on, ef)] = out
                done += 1
    for comp in _comps():
        cfg = CompressionConfig(qw=comp, strategy="allgather",
                                integrity=True)
        out, _ = compressed_allreduce(g, sm, cfg, None, key, n, wire=True)
        check(bitwise_equal(_flat(out), _flat(outs[(
            comp.name, "layerwise", "allgather", True, False)])),
            f"{comp.name}: integrity changed the aggregate")
        plan = build_plan(g, sm, Granularity("layerwise"))
        sched = build_schedule(plan, 0.0)
        wk = lambda k: R.fold_in(k, rank)
        codecs = [wire.wire_codec(comp, integrity=i) for i in (True, False)]
        (_, bufs), (_, plain) = (wire.execute_schedule_wire(
            sched, c, g, key, wire_key=wk) for c in codecs)
        for lay, buf, pb in zip(wire.message_layouts(sched, codecs[0]), bufs,
                                plain):
            check(bool(wire.verify_message(buf, lay)),
                  f"{comp.name}: a clean buffer fails verify_message")
            check(bitwise_equal(buf[lay.header_nbytes:],
                                pb[lay.header_nbytes - 4:]),
                  f"{comp.name}: integrity changed the payload bytes")
        done += 1
    torch.cuda.synchronize()
    return done


def gate_majority(rank, n, dev, params, wg):
    """(b): per granularity (layerwise and entire-model), every bucket's
    signSGD payloads encoded in one encode_buckets call and gathered bucket
    by bucket; the fused vote of all of them in one majority_vote_buckets
    call (one majority launch) equals the non-fused one (one bits_unpack,
    the count, one bits_pack) and the plain version, bucket by bucket.
    -> votes."""
    import torch
    from repro_torch import random as R
    from repro_torch.convert import tree_map
    from repro_torch.core.collectives import all_gather
    from repro_torch.core.compressors import SignSGD
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.core.wire import SignSGDCodec
    from repro_torch.kernels.sign import majority_plain
    g = tree_map(lambda t: t[rank], wg)
    fused = SignSGDCodec(comp=SignSGD())
    unfused = SignSGDCodec(comp=SignSGD(), fused=False)
    votes = 0
    for gran in ("layerwise", "entire_model"):
        plan = build_plan(g, stacked_mask(params), Granularity(gran))
        leaves, _ = plan._inputs(g, R.key(0))
        flat = plan._flat(leaves) if plan.needs_flat else None
        xs = [plan._gather_runs(leaves, flat, b) for b in plan.buckets]
        pays = fused.encode_buckets(xs, [None] * len(xs))
        gathered = [all_gather(p) for p in pays]    # (n, units, nbytes)
        dims = [b.dim for b in plan.buckets]
        fv = fused.majority_vote_buckets(gathered, dims)
        uv = unfused.majority_vote_buckets(gathered, dims)
        for b, v, u, gat in zip(plan.buckets, fv, uv, gathered):
            check(bitwise_equal(v, u),
                  f"{gran} {b.n}x{b.dim}: fused vote != non-fused vote")
            words = gat.reshape(n, -1).view(torch.int32)
            check(bitwise_equal(v.reshape(-1).view(torch.int32),
                                majority_plain(words)),
                  f"{gran} {b.n}x{b.dim}: vote != plain version")
            votes += 1
    torch.cuda.synchronize()
    return votes


def gate_unit_codecs(rank, n, dev, params, wg):
    """(c): one step's message buffers through the per-unit codecs
    (fused=False) equal the fused buffers byte for byte, with exact launch
    counts. -> messages."""
    import torch
    from repro_torch import kernels
    from repro_torch import random as R
    from repro_torch.convert import tree_map
    from repro_torch.core import wire
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.core.schedule import build_schedule
    g = tree_map(lambda t: t[rank], wg)
    wk = lambda k: R.fold_in(k, rank)
    msgs = 0
    for comp in _comps():
        for gran in ("layerwise", "entire_model"):
            plan = build_plan(g, stacked_mask(params), Granularity(gran))
            sched = build_schedule(plan, 0.0)
            (_, a), (_, b) = (wire.execute_schedule_wire(
                sched, wire.wire_codec(comp, fused=f), g, R.key(9),
                wire_key=wk) for f in (True, False))
            for x, y in zip(a, b):
                check(bitwise_equal(x, y),
                      f"{comp.name} {gran}: fused=False buffer != fused")
                msgs += 1
    # launches over the 10 (codec, granularity) pairs, each run fused and
    # per-unit with a local decode, at 2 granularities (11 buckets
    # layerwise, 1 entire-model). Fused QSGD, TernGrad and signSGD each
    # pack in 1 launch and unpack in 1 a granularity (qsgd_pack 2,
    # qsgd_unpack 2, terngrad_pack 2, terngrad_unpack 2, sign_pack 2,
    # sign_unpack 2); the per-unit codecs encode every bucket of a
    # granularity in one encode_rows_buckets launch (QSGD and TernGrad
    # fields_pack 2 each, signSGD bits_pack 2) and decode them in one
    # decode_rows_buckets launch (QSGD and TernGrad fields_unpack 2 each,
    # signSGD bits_unpack 2); natural and top-k, fused or not, pack and
    # unpack all buckets in one field launch each (2 x 2 each way
    # apiece): fields_pack 2 + 2 + 4 + 4 = 12, fields_unpack 2 + 2 + 4 +
    # 4 = 12
    want = {"qsgd_pack": 2, "qsgd_unpack": 2, "terngrad_pack": 2,
            "terngrad_unpack": 2, "sign_pack": 2, "sign_unpack": 2,
            "bits_pack": 2, "bits_unpack": 2, "fields_pack": 12,
            "fields_unpack": 12}
    counts = kernels.launch_counts()
    check(counts == {k: want.get(k, 0) for k in counts},
          f"unit codecs: launches {counts} != {want}")
    torch.cuda.synchronize()
    return msgs


# the kernels a wire codec packs and unpacks with (fused codecs)
CODEC_KERNELS = {"qsgd": ("qsgd_pack", "qsgd_unpack"),
                 "terngrad": ("terngrad_pack", "terngrad_unpack"),
                 "signsgd": ("sign_pack", "sign_unpack"),
                 "natural": ("fields_pack", "fields_unpack"),
                 "topk": ("fields_pack", "fields_unpack")}
# the allgather wire path's receive leg decodes with the per-unit codec
GATHER_UNPACK = {"signsgd": "bits_unpack"}
STREAM_CHUNKS = (None, 64.0)
STREAM_FUSIONS = (0.0, 65536.0)


def stream_plan(cfg, g, sm, n, chunk):
    """The layouts a streaming call of cfg on g moves and its exact costs
    on each rank: -> (layouts, launches, hops, ring bytes each way,
    reduce-scatter bytes each way). A call encodes each message in one
    grouped pack launch and decodes, per message, its own payload in one
    grouped unpack launch and every arriving chunk in one: packs M,
    unpacks sum over messages of (1 + (n - 1) x its chunks); the ring
    moves (n - 1) x each message's bytes; rs_stream reduce-scatters each
    bucket's (units, ceil(d / n)) f32 slices, n - 1 each way."""
    from repro_torch.core.plan import build_plan
    from repro_torch.core.schedule import build_schedule
    from repro_torch.core.wire import (_shard_dim, layout_chunks,
                                       message_layouts, shard_message_layouts,
                                       wire_codec)
    sched = build_schedule(build_plan(g, sm, cfg.granularity),
                           cfg.fusion_bytes or 0.0)
    codec = wire_codec(cfg.qw)
    layouts = (message_layouts(sched, codec) if cfg.strategy == "ring"
               else shard_message_layouts(sched, codec, n))
    chunks = [len(layout_chunks(lay, chunk)) for lay in layouts]
    pack, unpack = CODEC_KERNELS[cfg.qw.name]
    launches = {pack: len(layouts),
                unpack: sum(1 + (n - 1) * c for c in chunks)}
    rs = (0 if cfg.strategy == "ring" else
          sum((n - 1) * 4 * b.n * _shard_dim(b.dim, n)
              for b in sched.plan.buckets))
    return (layouts, launches, (n - 1) * sum(chunks),
            (n - 1) * sum(lay.total_nbytes for lay in layouts), rs)


def _launched(before):
    from repro_torch import kernels
    after = kernels.launch_counts()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _dyadic_like(tree, seed):
    """Entries of {0, +-1/8, +-1/4} in the shapes of `tree`: every sum of
    their squares, and of the squares of a rank-order mean of 4 such
    trees, is exact in any order at resnet9's size (below 2**24 units of
    2**-10), so QSGD's unit norms are the same on the card and the CPU.
    On other inputs the two devices sum the squares in other orders
    (ROADMAP.md Queue 3 item 1)."""
    import torch
    from repro_torch.convert import tree_map
    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: (torch.randint(-2, 3, t.shape, generator=gen)
                               * 0.125).to(t.device), tree)


def gate_stream(rank, n, dev, params, wg):
    """(e): compressed_allreduce(strategy="ring" / "rs_stream", wire=True)
    on this rank's resnet9 gradients (QSGD on _dyadic_like entries of
    their shapes): 5 compressors x layerwise / entire-model x fusion 0 /
    64 KiB x chunks None / 64 B. Each call is bitwise the same call on CPU
    copies of its inputs on the same gloo group (the plain versions: every
    kernel on the path against its twin), the same on every rank, and
    under ring bitwise the allgather wire result of the same ranks; exact
    launches (stream_plan), hops and bytes. -> (calls, per-call
    records)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch import random as R
    from repro_torch.convert import tree_map
    from repro_torch.core import collectives
    from repro_torch.core.aggregation import (CompressionConfig,
                                              compressed_allreduce)
    from repro_torch.core.granularity import Granularity, stacked_mask
    key = R.key(7)
    sm = stacked_mask(params)
    # the CPU copies' calls need a group that moves host tensors (under
    # --nccl a gloo group beside the NCCL one)
    cpu_group = (None if dist.get_backend() == "gloo"
                 else dist.new_group(backend="gloo"))
    recs = []
    for comp in _comps():
        g = (_dyadic_like(params, 100 + rank) if comp.name == "qsgd"
             else tree_map(lambda t: t[rank], wg))
        g_cpu = tree_map(lambda t: t.cpu(), g)
        for gran in ("layerwise", "entire_model"):
            for fusion in STREAM_FUSIONS:
                base = CompressionConfig(qw=comp, fusion_bytes=fusion,
                                         granularity=Granularity(gran))
                before = kernels.launch_counts()
                ag, _ = compressed_allreduce(
                    g, sm, dataclasses.replace(base, strategy="allgather"),
                    None, key, n, wire=True)
                pack = CODEC_KERNELS[comp.name][0]
                unpack = GATHER_UNPACK.get(comp.name, "fields_unpack")
                got = _launched(before)
                check(got == {pack: 1, unpack: 1}, f"{comp.name} {gran} "
                      f"fusion {fusion} allgather: launches {got}")
                for strategy in ("ring", "rs_stream"):
                    cfg = dataclasses.replace(base, strategy=strategy)
                    for chunk in STREAM_CHUNKS:
                        what = (f"{comp.name} {gran} fusion {fusion} "
                                f"{strategy} chunks {chunk}")
                        layouts, want, hops, nbytes, rs = stream_plan(
                            cfg, g, sm, n, chunk)
                        collectives.reset_counts()
                        before = kernels.launch_counts()
                        t0 = time.perf_counter()
                        out, _ = compressed_allreduce(
                            g, sm, cfg, None, key, n, wire=True,
                            stream_chunk_bytes=chunk)
                        torch.cuda.synchronize()
                        secs = time.perf_counter() - t0
                        got = _launched(before)
                        ring = collectives.counts("ring_shift")
                        red = collectives.counts("reduce_scatter")
                        check(got == want, f"{what}: launches {got} != "
                              f"{want}")
                        check((ring["calls"], ring["sent_bytes"],
                               ring["recv_bytes"]) == (hops, nbytes, nbytes),
                              f"{what}: ring moved {ring}, want {hops} hops "
                              f"of {nbytes} B")
                        check((red["sent_bytes"], red["recv_bytes"])
                              == (rs, rs), f"{what}: reduce-scatter {red}")
                        cpu, _ = compressed_allreduce(
                            g_cpu, sm, cfg, cpu_group, key, n, wire=True,
                            stream_chunk_bytes=chunk)
                        check(bitwise_equal(_flat(out).cpu(), _flat(cpu)),
                              f"{what}: card != the CPU copy's call")
                        check(_equal_on_all_ranks(_flat(out)),
                              f"{what}: ranks disagree")
                        if strategy == "ring":
                            check(bitwise_equal(_flat(out), _flat(ag)),
                                  f"{what}: != the allgather wire path")
                        recs.append({
                            "comp": comp.name, "gran": gran,
                            "fusion": fusion, "strategy": strategy,
                            "chunk": chunk, "messages": len(layouts),
                            "hops": hops, "ring_bytes": nbytes,
                            "rs_bytes": rs, "launches": got,
                            "staged_bytes": ring["staged_bytes"]
                            + red["staged_bytes"], "seconds": secs})
    torch.cuda.synchronize()
    return len(recs), recs


def train_ranks(rank, n, dev):
    """(d): train_cnn_ranks, STEPS resnet9 steps per run, batch 64 over the
    ranks; exact launch counts, collective bytes a step against
    comm_report (the ring's against its layouts, beside comm_report of
    allgather), equal parameters on every rank, and the ring run's test
    loss and parameters bitwise the allgather QSGD run's. -> per-run
    records."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.core import collectives
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.bits import comm_report
    from repro_torch.core.compressors import QSGD, SignSGD
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.experiment import train_cnn_ranks
    # launches a step: QSGD packs its 11 buckets in one launch and signSGD
    # its 11 in one; the allgather receive leg makes the step's 11
    # all_gathers in bucket order, then decodes every bucket's gathered
    # rows with the per-unit codec in one decode_rows_buckets call (one
    # fields_unpack, or bits_unpack for signSGD, a step); simulated
    # decodes every bucket locally in one grouped launch (qsgd_unpack 1)
    # and averages the decoded values. The ring runs the per-bucket
    # schedule (11 messages, each one chunk): a pack a message (11) and a
    # qsgd_unpack for its own payload and for each of its n - 1 = 3 hops
    # (11 x 4 = 44), over 33 ring_shift calls a step
    runs = [("allgather_qsgd16_layerwise", QSGD(levels=MAIN_LEVELS),
             "allgather", {"qsgd_pack": 1, "fields_unpack": 1}),
            ("allgather_signsgd_layerwise", SignSGD(), "allgather",
             {"sign_pack": 1, "bits_unpack": 1}),
            ("simulated_qsgd16_layerwise", QSGD(levels=MAIN_LEVELS),
             "simulated", {"qsgd_pack": 1, "qsgd_unpack": 1}),
            ("ring_qsgd16_layerwise", QSGD(levels=MAIN_LEVELS), "ring",
             {"qsgd_pack": 11, "qsgd_unpack": 44})]
    out, finals = [], {}
    for name, comp, strategy, per_step in runs:
        cfg = CompressionConfig(qw=comp, strategy=strategy,
                                granularity=Granularity("layerwise"))
        kernels.reset_launch_counts()
        collectives.reset_counts()
        torch.cuda.synchronize()
        # cuDNN's default convolution backward adds in a run-dependent
        # order; deterministic algorithms make two runs comparable bit for
        # bit (the ring run against the allgather run)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        t0 = time.perf_counter()
        try:
            acc, loss, params = train_cnn_ranks("resnet9", cfg, steps=STEPS,
                                                batch=64, device=dev)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        coll = collectives.counts()
        want = {k: per_step.get(k, 0) * STEPS for k in counts}
        check(counts == want, f"{name}: launches {counts} != {want}")
        sm = stacked_mask(params)
        plan = build_plan(params, sm, Granularity("layerwise"))
        rep = comm_report(dataclasses.replace(cfg, strategy="allgather")
                          if strategy == "ring" else cfg, plan, n,
                          measured=True)
        sent, recv = coll["sent_bytes"] / STEPS, coll["recv_bytes"] / STEPS
        if strategy == "ring":
            _, _, hops, nbytes, _ = stream_plan(cfg, params, sm, n, None)
            up = down = 8 * nbytes
            calls = hops
        else:
            up = rep.uplink_bits_per_worker
            down = (rep.downlink_bits_per_worker if strategy == "allgather"
                    else (n - 1) * rep.uplink_bits_per_worker)
            calls = 11
        check(8 * sent == up, f"{name}: {sent} B sent a step, want "
              f"{up / 8}")
        check(8 * recv == down, f"{name}: {recv} B received a step, want "
              f"{down / 8}")
        check(coll["calls"] == calls * STEPS,
              f"{name}: {coll['calls']} calls")
        check(math.isfinite(loss) and math.isfinite(acc),
              f"{name}: test loss {loss}")
        check(_equal_on_all_ranks(_flat(params)),
              f"{name}: parameters differ across ranks")
        finals[name] = (loss, _flat(params))
        out.append({"run": name, "steps": STEPS, "seconds": secs,
                    "test_loss": loss, "test_accuracy": acc,
                    "launches": counts, "sent_bytes_per_step": sent,
                    "recv_bytes_per_step": recv,
                    "staged_bytes_per_step": coll["staged_bytes"] / STEPS,
                    "comm_report_up_bytes": rep.uplink_bits_per_worker / 8,
                    "comm_report_down_bytes":
                        rep.downlink_bits_per_worker / 8,
                    "collective_ms_per_step": coll["seconds"] / STEPS * 1e3})
    ring, ag = finals["ring_qsgd16_layerwise"], \
        finals["allgather_qsgd16_layerwise"]
    check(ring[0] == ag[0] and bitwise_equal(ring[1], ag[1]),
          "ring QSGD(16): test loss or parameters != the allgather run's")
    return out


def gather_timing(rank, n, dev, nbytes_list):
    """Host ms of one all_gather per size (median of 20 after 3 warm-ups),
    of a uint8 tensor on the card (the port's transport) and, under gloo
    and for comparison only, of the same bytes in pinned host memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.collectives import all_gather
    out = {}
    wheres = (("card", "pinned_host") if dist.get_backend() == "gloo"
              else ("card",))
    for where in wheres:
        for nb in nbytes_list:
            t = torch.zeros(nb, dtype=torch.uint8, device=dev)
            if where == "pinned_host":
                t = t.cpu().pin_memory()
            vals = []
            for i in range(23):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                all_gather(t)
                torch.cuda.synchronize()
                if i >= 3:
                    vals.append((time.perf_counter() - t0) * 1e3)
            vals.sort()
            out[f"{where}/{nb}"] = vals[len(vals) // 2]
    return out


# exact launches of gates (a) and (b) on each rank. (a) runs, per
# compressor, compressed_allreduce at 2 granularities (B = 11 layerwise
# buckets + 1 entire-model) x {simulated, allgather} x wire {off, on}, with
# EF also for QSGD and top-k layerwise, then one allgather wire call and two
# execute_schedule_wire calls (with a local decode), all layerwise, for
# the integrity words. wire=False launches nothing (sim and records in
# plain torch). A wire call encodes once (one grouped launch for every
# codec), decodes locally under simulated and EF in one grouped launch for
# every codec, and under allgather decodes the gathered rows of all its
# buckets with the per-unit codec in one decode_rows_buckets call (one
# fields_unpack, or bits_unpack for signSGD, a call). So:
#   qsgd_pack 4 + 2 (EF) + 3 = 9; qsgd_unpack 2 + 2 (EF) + 2 = 6;
#   terngrad_pack 4 + 3 = 7; terngrad_unpack and sign_unpack each 1 + 1
#   (simulated wire, a granularity) + 2 x 1 (the two execute_schedule_wire
#   calls) = 4; sign_pack 4 + 3 = 7; fields_pack natural 4 + 3, top-k 4 + 2 + 3
#   = 16; fields_unpack local natural 2 + 2 and top-k 2 + 2 + 2, gathered
#   rows 3 calls x 4 codecs + 2 (EF) = 10 + 12 + 2 = 24; bits_unpack
#   2 + 1 = 3.
# (b) encodes the buckets of each granularity in one call (sign_pack 2) and
# votes on all of them in one fused call (majority 2) and one non-fused
# call (bits_unpack 2, bits_pack 2).
# (e) runs, per compressor, 4 (granularity, fusion) layouts x {ring,
# rs_stream} x chunks {None, 64 B} = 16 streaming calls and 4 allgather
# wire calls (one pack, one gathered-rows unpack: fields_unpack, or
# bits_unpack for signSGD). A streaming call packs each of its M messages
# in one launch and unpacks, per message, its own payload and each of the
# n - 1 = 3 hops' chunks in one launch each (stream_plan): M + hops
# unpacks. M is 11 (layerwise, fusion 0), 4 (layerwise, 64 KiB) and 1
# (entire-model), so 4 x (11 + 4 + 1 + 1) = 68 packs a compressor, + 4
# allgather = 72. Hops over the 16 calls: 33 x 4 (layerwise, fusion 0:
# one bucket a message, one chunk) + 3 x 8 (entire-model) = 156, plus at
# 64 KiB ring / rs_stream with whole and 64-byte chunks QSGD 12 + 24 + 12
# + 24, TernGrad 12 + 24 + 12 + 18, signSGD 12 + 21 + 12 + 18, natural 12
# + 27 + 12 + 24, top-k 12 + 18 + 12 + 18; unpacks 68 + hops: QSGD 68 +
# 228 = 296, TernGrad 290, signSGD 287, natural 299, top-k 284.
# fields_pack 72 natural + 72 top-k = 144; fields_unpack 299 + 284 + 4 x 4
# allgather (QSGD, TernGrad, natural, top-k) = 599; bits_unpack 4.
GATE_LAUNCHES = {
    "fixed_gradients": {"qsgd_pack": 9, "qsgd_unpack": 6,
                        "terngrad_pack": 7, "terngrad_unpack": 4,
                        "sign_pack": 7, "sign_unpack": 4, "fields_pack": 16,
                        "fields_unpack": 24, "bits_unpack": 3},
    "majority": {"sign_pack": 2, "majority": 2, "bits_unpack": 2,
                 "bits_pack": 2},
    "stream": {"qsgd_pack": 72, "qsgd_unpack": 296, "terngrad_pack": 72,
               "terngrad_unpack": 290, "sign_pack": 72, "sign_unpack": 287,
               "fields_pack": 144, "fields_unpack": 599, "bits_unpack": 4}}


def faults_ranks(rank, n, dev, wg):
    """15(c) on one rank of phase 7's spawn, this rank's resnet9 gradient
    row, top-k 0.25 layerwise with the integrity word, the step key the
    same on every rank: the ring under prob=1 per-hop bit flips with
    resend is bitwise the clean ring and every hop is detected
    (n_messages x (n - 1) verdicts, none passing); dropped hops are all
    detected and resent; duplicated (stale) hops pass every check and
    this rank's aggregate differs; the allgather wire path under prob=1
    bit flips with resend is bitwise the clean one, every received message
    detected; the clean ring equals the clean allgather; every faulted
    call launches exactly its clean call's kernels -> {"runs",
    "launches"}."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch import random as R
    from repro_torch.convert import tree_map
    from repro_torch.core import build_plan, build_schedule
    from repro_torch.core.aggregation import (CompressionConfig,
                                              compressed_allreduce)
    from repro_torch.core.compressors import TopK
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.resil import FaultInjector
    from repro_torch.sim import CorruptionSpec
    g = tree_map(lambda t: t[rank], wg)
    sm = stacked_mask(g)
    base = CompressionConfig(qw=TopK(ratio=0.25), fusion_bytes=0.0,
                             granularity=Granularity("layerwise"),
                             integrity=True)
    key = R.key(151)
    launches, runs = {}, {}

    def run(strategy, spec=None, resend=True):
        inj = None if spec is None else FaultInjector(spec, resend=resend)
        before = kernels.launch_counts()
        out, _ = compressed_allreduce(
            g, sm, dataclasses.replace(base, strategy=strategy), None, key,
            n, wire=True, faults=inj)
        torch.cuda.synchronize(dev)
        got = _launched(before)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        flags = (inj.take_flags().reshape(-1) if inj is not None
                 else torch.zeros((0,), dtype=torch.bool))
        return out, flags.cpu(), got
    # resnet9's 11 layerwise buckets ride 11 messages: a ring call packs
    # each message's index legs in 1 fields_pack and unpacks its own copy
    # and each of the n - 1 arriving hops in 1 fields_unpack; an allgather
    # call encodes in 1 and decodes the gathered rows in 1. So a rank's
    # 15(c) (4 ring calls, 2 allgather calls) counts 46 fields_pack and
    # 178 fields_unpack at n = 4
    m = build_schedule(build_plan(g, sm, base.granularity),
                       0.0).num_messages
    clean, _, ring_l = run("ring")
    ag_clean, _, ag_l = run("allgather")
    check(ring_l == {"fields_pack": m, "fields_unpack": m * n}
          and ag_l == {"fields_pack": 1, "fields_unpack": 1},
          f"15(c): clean launches ring {ring_l}, allgather {ag_l}")
    check(_tree_equal(clean, ag_clean), "15(c): clean ring != allgather")
    for name, strategy, spec, want_l, ref in (
            ("ring_bitflip_resend", "ring", CorruptionSpec(prob=1.0, seed=5),
             ring_l, clean),
            ("ring_drop_resend", "ring",
             CorruptionSpec(prob=1.0, mode="drop_hop", seed=6), ring_l,
             clean),
            ("ring_dup", "ring",
             CorruptionSpec(prob=1.0, mode="dup_hop", seed=8), ring_l,
             clean),
            ("allgather_bitflip_resend", "allgather",
             CorruptionSpec(prob=1.0, seed=9), ag_l, ag_clean)):
        out, flags, got = run(strategy, spec)
        same = _tree_equal(out, ref)
        detected = int((~flags).sum())
        runs[name] = {"verdicts": flags.numel(), "detected": detected,
                      "bitwise_clean": same, "launches": got}
        check(got == want_l, f"15(c) {name}: launches {got} != {want_l}")
        if name == "ring_dup":
            check(flags.numel() > 0 and detected == 0 and not same,
                  f"15(c) ring_dup: {runs[name]}")
        else:
            check(flags.numel() > 0 and detected == flags.numel() and same,
                  f"15(c) {name}: {runs[name]}")
    return {"runs": runs, "launches": launches}


def rank_phase(rank, n, dev):
    """Phase 7 on one rank: each gate driven with the launch counters set
    to 0 just before it and read just after, gates (a), (b) and (e) held
    to GATE_LAUNCHES (gate (c) checks its own; (e) each call too)."""
    import torch
    from repro_torch import kernels
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params, wg = _fixed_gradients(rank, n, dev)
    res = {}
    for name, gate in (("fixed_gradients", gate_fixed_gradients),
                       ("majority", gate_majority),
                       ("unit_codecs", gate_unit_codecs),
                       ("stream", gate_stream)):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        count = gate(rank, n, dev, params, wg)
        counts = kernels.launch_counts()
        if name in GATE_LAUNCHES:
            want = {k: GATE_LAUNCHES[name].get(k, 0) for k in counts}
            check(counts == want, f"{name}: launches {counts} != {want}")
        res[name] = {"seconds": time.perf_counter() - t0, "launches": counts}
        if isinstance(count, tuple):
            count, res[name]["records"] = count
        res[name]["count"] = count
    res["train"] = train_ranks(rank, n, dev)
    res["gather_ms"] = gather_timing(rank, n, dev,
                                     (4_096, 60_512, 484_008, 4_194_304))
    t0 = time.perf_counter()
    res["obs"] = obs_streams(rank, n, dev, wg)
    res["obs"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["faults"] = faults_ranks(rank, n, dev, wg)
    res["faults"]["seconds"] = time.perf_counter() - t0
    return res


def multi_rank_path(backend: str = "gloo"):
    """Phase 7: RANKS rank processes, on the one card over gloo or one card
    each over NCCL."""
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    res = run_ranks(rank_phase, RANKS, backend=backend, device="cuda",
                    timeout=RANK_TIMEOUT)
    secs = time.perf_counter() - t0
    r0 = res[0]
    where = ("on cuda:0 over gloo (CUDA tensors straight into gloo's "
             "all_gather; its send / recv staged through pinned host "
             "buffers by the port)" if backend == "gloo"
             else "one card each over nccl")
    print(f"multi-rank: {RANKS} ranks {where}, {secs:.1f} s", flush=True)
    print(f"  (a) {r0['fixed_gradients']['count']} compressed_allreduce "
          f"configurations bitwise equal to the single-process Algorithm 1 "
          f"on every rank, integrity words verified", flush=True)
    print(f"  (b) {r0['majority']['count']} bucket votes: fused == non-fused "
          f"== plain", flush=True)
    print(f"  (c) {r0['unit_codecs']['count']} messages: fused=False buffers "
          f"== fused", flush=True)
    st = r0["stream"]
    print(f"  (e) {st['count']} ring / rs_stream calls bitwise equal to the "
          f"same calls on CPU copies (the plain versions) and on every "
          f"rank, ring == allgather wire, exact launches, hops and bytes; "
          f"{st['seconds']:.1f} s, launches "
          f"{ {k: v for k, v in st['launches'].items() if v} }", flush=True)
    for rec in st["records"]:
        print(f"    (e) {rec['comp']:8s} {rec['gran']:12s} fusion "
              f"{rec['fusion']:7.0f} {rec['strategy']:9s} chunks "
              f"{str(rec['chunk']):5s}: {rec['messages']:2d} messages, "
              f"{rec['hops']:3d} hops, ring {rec['ring_bytes']} B and "
              f"reduce-scatter {rec['rs_bytes']} B each way, staged "
              f"{rec['staged_bytes']} B, {rec['seconds'] * 1e3:.2f} ms, "
              f"launches {rec['launches']}", flush=True)
    for run in r0["train"]:
        print(f"  (d) {run['run']}: {run['steps']} steps in "
              f"{run['seconds']:.3f} s (rank 0), test loss "
              f"{run['test_loss']:.6f}, sent {run['sent_bytes_per_step']:.0f}"
              f" B / received {run['recv_bytes_per_step']:.0f} B a step "
              f"(comm_report"
              f"{' of allgather' if run['run'].startswith('ring') else ''} up "
              f"{run['comm_report_up_bytes']:.0f} B, down "
              f"{run['comm_report_down_bytes']:.0f} B), staged "
              f"{run['staged_bytes_per_step']:.0f} B a step, collectives "
              f"{run['collective_ms_per_step']:.3f} ms a step, launches "
              f"{ {k: v for k, v in run['launches'].items() if v} }",
              flush=True)
    print(f"  {backend} all_gather, host ms by where and bytes per rank: "
          f"{r0['gather_ms']}", flush=True)
    launches = {}
    for r in res:
        for phase in ("fixed_gradients", "majority", "unit_codecs",
                      "stream"):
            for k, v in r[phase]["launches"].items():
                launches[k] = launches.get(k, 0) + v
        for run in r["train"]:
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
    return res, launches, secs


# ---- phase 8: the compress-only path ------------------------------------------

def _plain_plan_compress(plan, grads, key, kind):
    """ops.plan_compress built with the plain twins on the card: the same
    gathers, keys, statistics and draw lengths, each bucket through
    *_compress_buckets_plain (the uniforms from the plain threefry)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import terngrad as T
    flat = plan.flatten(grads)
    keys = plan.unit_keys(key).to(flat.device)
    out = torch.zeros_like(flat)
    for b in plan.buckets:
        x = plan.gather_bucket(flat, b).contiguous()
        k0, k1 = ops._split_keys(keys[list(b.unit_ids)], flat.device)
        draw = ops.draw_length(b.dim, UNIT_DRAW)
        if kind == "qsgd":
            y = Q.qsgd_compress_buckets_plain(
                [x], [k0], [k1], [torch.linalg.vector_norm(x, dim=1)],
                [draw], MAIN_LEVELS)[0]
        else:
            y = T.terngrad_compress_buckets_plain(
                [x], [k0], [k1], [x.abs().amax(dim=1)], [draw])[0]
        plan.scatter_bucket(out, b, y)
    return plan.unflatten(out)


def _plain_whole(kind, x, key):
    """ops.qsgd_compress / terngrad_compress / blockwise_topk(k=5) built
    with the plain twins on the card: a whole input is one unit of d
    elements with one key, its uniforms drawn over the whole-input
    granule."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import terngrad as T
    from repro_torch.kernels import topk_mask as K
    if kind == "topk":
        return K.topk_mask_flat_plain(x, 5)
    xu = x.reshape(1, -1)
    k0, k1 = ops._split_keys(key[None], x.device)
    draw = ops.draw_length(xu.shape[1], WHOLE_DRAW)
    if kind == "qsgd":
        y = Q.qsgd_compress_buckets_plain(
            [xu], [k0], [k1], [torch.linalg.vector_norm(xu, dim=1)], [draw],
            MAIN_LEVELS)[0]
    else:
        y = T.terngrad_compress_buckets_plain(
            [xu], [k0], [k1], [xu.abs().amax(dim=1)], [draw])[0]
    return y.reshape(x.shape)


def compress_grads(dev):
    """Phase 8's inputs: the key, one worker's resnet9 gradient tree (random
    weights from seed 0, one batch of 64), its stacked mask, the flat
    gradient and 2**20 seeded entries, on the card."""
    import torch
    from repro_torch import random as R
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.core.granularity import stacked_mask
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.experiment import worker_grads
    from repro_torch.models.cnn import init_cnn
    key = R.key(0)
    params = init_cnn(RESNET9, key, device=dev)
    batch = classification_batch(R.fold_in(key, 0), 64, device=dev)
    wg, _ = worker_grads(RESNET9, params, batch, 1)
    g = tree_map(lambda t: t[0], wg)
    flat = torch.cat([t.reshape(-1) for t in tree_leaves(g)])
    g_cpu = torch.Generator().manual_seed(8)
    micro = torch.randn(MICRO, generator=g_cpu).to(dev)
    return key, g, stacked_mask(g), flat, micro


def compress_path(dev):
    """Phase 8: the compress-only path on one worker's resnet9 gradients,
    every call held to its exact launches and to the plain build. ->
    (record, launch counts of the whole phase)."""
    import torch
    from repro_torch import kernels
    from repro_torch.convert import tree_leaves
    from repro_torch.core import theory
    from repro_torch.core.compressors import QSGD
    from repro_torch.core.granularity import Granularity
    from repro_torch.core.plan import build_plan
    from repro_torch.kernels import ops
    from repro_torch.kernels.qsgd import MAX_BUCKETS
    from repro_torch.kernels.rmsnorm import rmsnorm_plain
    key, g, sm, flat, micro = compress_grads(dev)
    rec = {"plan_compress": [], "whole": []}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()

    def launched(fn, name, want):
        before = kernels.launch_counts()[name]
        out = fn()
        got = kernels.launch_counts()[name] - before
        check(got == want, f"{name}: {got} launches, want {want}")
        return out

    # launches a call: plan_compress gathers every bucket and makes ONE
    # grouped launch per MAX_BUCKETS buckets, ceil(11 / 32) = ceil(1 / 32)
    # = 1 at each granularity; a whole input is one unit, 1 launch. So the
    # phase counts 1 + 1 + 1 plan_compress + 2 whole-input = 5 launches of
    # each of qsgd_compress_rows and terngrad_compress_rows (a launch per
    # bucket made 11 + 1 + 1 + 2 = 15)
    plans = {}
    for gran in (Granularity("layerwise"), Granularity("entire_model"),
                 Granularity("blockwise", BLOCK)):
        plan = build_plan(g, sm, gran)
        plans[gran.kind] = plan
        want_launches = -(-plan.num_dispatches // MAX_BUCKETS)
        for kind, name in (("qsgd", "qsgd_compress_rows"),
                           ("terngrad", "terngrad_compress_rows")):
            out = launched(lambda: ops.plan_compress(
                plan, g, key, kind=kind, levels=MAIN_LEVELS), name,
                want_launches)
            want = _plain_plan_compress(plan, g, key, kind)
            for a, b in zip(tree_leaves(out), tree_leaves(want)):
                check(a.shape == b.shape and bool(torch.isfinite(a).all()),
                      f"plan_compress {kind} {gran.kind}: bad output")
                check(bitwise_equal(a, b),
                      f"plan_compress {kind} {gran.kind} != plain build")
            rec["plan_compress"].append({
                "kind": kind, "granularity": gran.kind,
                "plan": plan.summary(), "dispatches": plan.num_dispatches,
                "launches": want_launches})
    check([plans[k].num_dispatches for k in plans] == [11, 1, 1],
          f"plans {[p.summary() for p in plans.values()]}")
    for label, x in (("flat_gradient", flat), ("micro", micro)):
        for kind, name, fn in (
                ("qsgd", "qsgd_compress_rows",
                 lambda: ops.qsgd_compress(x, key, MAIN_LEVELS)),
                ("terngrad", "terngrad_compress_rows",
                 lambda: ops.terngrad_compress(x, key)),
                ("topk", "topk_mask", lambda: ops.blockwise_topk(x, 5))):
            out = launched(fn, name, 1)
            check(bitwise_equal(out, _plain_whole(kind, x, key)),
                  f"{kind} whole-input {label} != plain build")
            rec["whole"].append({"kind": kind, "input": label,
                                 "d": x.numel()})
    x, gamma = rmsnorm_inputs(torch.bfloat16, 1200, dev)
    got = launched(lambda: ops.rmsnorm(x, gamma), "rmsnorm", 1)
    check(rmsnorm_close(got, rmsnorm_plain(x, gamma)),
          "rmsnorm (4096, 3072) bf16 beyond the stated tolerance")
    qsgd = QSGD(levels=MAIN_LEVELS)
    bounds_ = {}
    for gname in ("layerwise", "entire_model"):
        plan = plans[gname]
        tr, em = theory.noise_bounds_from_plan(plan, qsgd)
        ow = [qsgd.omega(d) for d in plan.unit_dims]
        tighter = theory.layerwise_tighter(ow, [0.0] * len(ow),
                                           plan.unit_dims)
        check(tighter and math.isfinite(tr) and tr <= em + 1e-9,
              f"{gname}: Trace(A) {tr} vs entire-model bound {em}")
        bounds_[gname] = {"trace_A": tr, "entire_model_bound": em,
                          "layerwise_tighter": tighter}
    lhs, mid, rhs = theory.lemma1_check(qsgd, tree_leaves(g), key,
                                        trials=64)
    check(lhs <= mid * 1.15 and mid <= rhs + 1e-6,
          f"Lemma 1: {lhs} <= {mid} <= {rhs} fails")
    torch.cuda.synchronize()
    rec.update({"seconds": time.perf_counter() - t0, "bounds": bounds_,
                "lemma1": [lhs, mid, rhs], "lemma1_parts": len(tree_leaves(g))})
    return rec, kernels.launch_counts()


def compress_calls(dev):
    """PERF.md's whole-call rows of the compress-only path: a layerwise
    ops.plan_compress on phase 8's resnet9 gradients (QSGD(16) and
    TernGrad), the whole-input ops.qsgd_compress / terngrad_compress on
    its 2**20 entries and ops.blockwise_topk (k=5) on its flat gradient
    and on the 2**20 entries in f32 and bf16 and on 2**20 entries of
    sparse rows, each as a user calls it. Per call: `host_ms`, the
    CUDA-event time of 20 calls issued back to back from Python, then
    synchronized (call_ms: host enqueue, statistics, gathers and scatters
    included), and the CUDA kernels and memory copies one call puts on
    the card, counted by torch.profiler. Uses only entry points
    that every tree of the port has, so `--calls DIR` times another
    checkout's port the same way."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.granularity import Granularity
    from repro_torch.core.plan import build_plan
    from repro_torch.kernels import ops
    key, g, sm, flat, micro = compress_grads(dev)
    plan = build_plan(g, sm, Granularity("layerwise"))
    flat16, micro16 = flat.to(torch.bfloat16), micro.to(torch.bfloat16)
    sparse = topk_sparse_inputs(MICRO // 512, 1310, dev)
    calls = {
        "plan_compress_layerwise_qsgd": lambda: ops.plan_compress(
            plan, g, key, kind="qsgd", levels=MAIN_LEVELS),
        "plan_compress_layerwise_terngrad": lambda: ops.plan_compress(
            plan, g, key, kind="terngrad"),
        "qsgd_compress_micro": lambda: ops.qsgd_compress(micro, key,
                                                         MAIN_LEVELS),
        "terngrad_compress_micro": lambda: ops.terngrad_compress(micro,
                                                                 key),
        "blockwise_topk_flat": lambda: ops.blockwise_topk(flat, 5),
        "blockwise_topk_micro": lambda: ops.blockwise_topk(micro, 5),
        "blockwise_topk_flat_bf16": lambda: ops.blockwise_topk(flat16, 5),
        "blockwise_topk_micro_bf16": lambda: ops.blockwise_topk(micro16, 5),
        "blockwise_topk_sparse": lambda: ops.blockwise_topk(sparse, 5)}
    rows = []
    for name, fn in calls.items():
        host = call_ms(fn)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA]
        copies = sum(1 for e in dev_events
                     if e.name.startswith(("Memcpy", "Memset")))
        rows.append({"call": name, "host_ms": host,
                     "kernels": len(dev_events) - copies,
                     "copies": copies,
                     "device_ms": sum(e.time_range.elapsed_us()
                                      for e in dev_events) / 1e3})
    return rows



# per wire kernel: its source and the TPU kernel it replaces. The C entry
# points: qsgd_pack_buckets / qsgd_unpack_buckets, terngrad_pack_buckets /
# terngrad_unpack_buckets, sign_pack_buckets / sign_unpack_buckets,
# fields_pack_buckets / fields_unpack_buckets, bits_pack_buckets /
# bits_unpack_buckets and majority_buckets; every unpack but fields_unpack
# is the tile walk of csrc/unpack_tile.cuh, the QSGD and TernGrad packs
# that of csrc/hash_pack.cuh, the sign and bit packs that of
# csrc/ballot_pack.cuh
SOURCES = {
    "qsgd_pack": ("src/repro_torch/kernels/csrc/qsgd.cu",
                  "src/repro/kernels/qsgd.py:122"),
    "qsgd_unpack": ("src/repro_torch/kernels/csrc/qsgd.cu",
                    "src/repro/kernels/qsgd.py:151"),
    "terngrad_pack": ("src/repro_torch/kernels/csrc/terngrad.cu",
                      "src/repro/kernels/terngrad.py:92"),
    "terngrad_unpack": ("src/repro_torch/kernels/csrc/terngrad.cu",
                        "src/repro/kernels/terngrad.py:118"),
    "sign_pack": ("src/repro_torch/kernels/csrc/sign.cu",
                  "src/repro/kernels/sign.py:49"),
    "sign_unpack": ("src/repro_torch/kernels/csrc/sign.cu",
                    "src/repro/kernels/sign.py:67"),
    "fields_pack": ("src/repro_torch/kernels/csrc/pack.cu",
                    "src/repro/kernels/pack.py:94"),
    "fields_unpack": ("src/repro_torch/kernels/csrc/pack.cu",
                      "src/repro/kernels/pack.py:111"),
    "bits_pack": ("src/repro_torch/kernels/csrc/bits.cu",
                  "src/repro/kernels/pack.py:47"),
    "bits_unpack": ("src/repro_torch/kernels/csrc/bits.cu",
                    "src/repro/kernels/pack.py:61"),
    "majority": ("src/repro_torch/kernels/csrc/sign.cu",
                 "src/repro/kernels/sign.py:83"),
}
# the compress-only kernels (each QSGD / TernGrad kernel also replaces the
# scalar-statistic Pallas function: qsgd.py:173, terngrad.py:138), and the
# phase-5 group whose rows give their kernel-line times
COMPRESS_SOURCES = {
    "qsgd_compress_rows": ("src/repro_torch/kernels/csrc/compress.cu",
                           "src/repro/kernels/qsgd.py:67"),
    "terngrad_compress_rows": ("src/repro_torch/kernels/csrc/compress.cu",
                               "src/repro/kernels/terngrad.py:48"),
    "topk_mask": ("src/repro_torch/kernels/csrc/topk_mask.cu",
                  "src/repro/kernels/topk_mask.py:43"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:21"),
}
LINE_GROUP = {"qsgd_compress_rows": "compress_layerwise",
              "terngrad_compress_rows": "compress_layerwise",
              "topk_mask": "compress_flat", "rmsnorm": "rmsnorm_bf16",
              "qsgd_pack": "layerwise_step_grouped",
              "qsgd_unpack": "layerwise_step_grouped",
              "terngrad_pack": "layerwise_step_grouped",
              "terngrad_unpack": "layerwise_step_grouped",
              "sign_pack": "layerwise_step_grouped",
              "sign_unpack": "layerwise_step_grouped",
              "bits_pack": "layerwise_step_grouped",
              "bits_unpack": "layerwise_step_grouped",
              "majority": "layerwise_step_grouped",
              "fields_pack": "layerwise_step_grouped",
              "fields_unpack": "layerwise_step_grouped"}


def kernel_line(timings, launches, errs):
    """The per-kernel summary. Wire kernels: device ms / plain_ms /
    bound_ms of one layerwise main-path step (the 11 resnet9 buckets x 4
    workers; every wire kernel the step's one grouped launch, the fields
    kernels theirs on natural compression's 9-bit code legs).
    Compress-only
    kernels: summed over their LINE_GROUP rows (one layerwise
    plan_compress call of QSGD(16) / TernGrad, top-k (k=5)
    on the flat gradient, RMSNorm at (4096, 3072) bf16 with the time of
    torch.nn.functional.rms_norm as `library_ms`). `launches` are each
    kernel's launches on its path (phases 4, 7, 9 and 11, or phase 8),
    every one above 0."""
    out = []
    groups = [(n, v, LINE_GROUP.get(n, "layerwise_step"))
              for n, v in {**SOURCES, **COMPRESS_SOURCES}.items()]
    for name, (src, replaces), group in groups:
        check(launches[name] > 0, f"{name}: no launch on its path")
        step = [r for r in timings
                if r["kernel"] == name and r["group"] == group
                and r["leg"] != "index"]
        check(step, f"{name}: no timing rows in group {group}")
        tot = {k: sum(r[k] for r in step)
               for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
        lib = [r["library_ms"] for r in step
               if r.get("library_ms") is not None]
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                         else "operations"),
            "library_ms": sum(lib) if lib else None})
    return {"kernels": out}


def nccl_only(card: str) -> int:
    """`--nccl`: phase 7 with one rank per card over NCCL."""
    import torch
    check(torch.cuda.device_count() >= RANKS,
          f"--nccl needs {RANKS} cards, torch sees "
          f"{torch.cuda.device_count()}")
    multi, launches, secs = multi_rank_path("nccl")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_nccl.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "multi_rank": multi,
        "multi_rank_seconds": secs, "launches": launches}, indent=1))
    print(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def calls_only(card: str, root: Path) -> int:
    """`--calls DIR`: the whole-call rows (compress_calls) of the port in
    the checkout DIR (this one, or another tree's, e.g. a parent commit
    unpacked with git archive), imported from DIR/src."""
    import torch
    from repro_torch.kernels import build
    secs = build.build_all()
    rows = compress_calls(torch.device("cuda", 0))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"compress_calls_{root.name}.json").write_text(json.dumps({
        "card": card, "root": str(root), "build_seconds": secs,
        "compress_calls": rows}, indent=1))
    for r in rows:
        print(f"  whole call {r['call']:33s} host_ms={r['host_ms']:.5f} "
              f"kernels={r['kernels']} copies={r['copies']} "
              f"device_ms={r['device_ms']:.5f}", flush=True)
    print(f"{card}")
    print(json.dumps({"root": str(root), "compress_calls": rows}))
    return 0


def main(argv) -> int:
    nccl = argv == ["--nccl"]
    calls = argv[:1] == ["--calls"] and len(argv) == 2
    if argv and not (nccl or calls):
        print(f"chip_smoke: unknown arguments {argv}; takes none, --nccl "
              f"or --calls DIR", file=sys.stderr)
        return 2
    if calls:
        root = Path(argv[1]).resolve()
        sys.path.insert(0, str(root / "src"))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs the "
              "card", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = smi_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    secs = build.build_all()
    print(f"build: {secs:.2f} s into {build.build_dir()}", flush=True)
    for src, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}", flush=True)
    if nccl:
        return nccl_only(card)
    if calls:
        return calls_only(card, root)

    layer_shapes, em_shape = bucket_shapes()
    shapes = layer_shapes + [em_shape, STRESS]
    errs = check_kernels(shapes, dev)
    print(f"kernels vs plain: bitwise equal over {len(shapes)} shapes "
          f"(QSGD widths {[w for w, _ in QSGD_WIDTHS]}, TernGrad, sign, "
          f"bits, fields widths {list(FIELD_WIDTHS)} and the top-k index "
          f"legs; majority of {list(VOTERS)} workers); max abs err {errs}",
          flush=True)
    gerr = check_grouped_pack(layer_shapes, dev)
    errs["qsgd_pack"] = max(errs["qsgd_pack"], gerr[0])
    errs["terngrad_pack"] = max(errs["terngrad_pack"], gerr[1])
    print(f"grouped qsgd_pack / terngrad_pack (one tile walk): bitwise equal "
          f"to the per-bucket plain loop (QSGD widths "
          f"{[w for w, _ in QSGD_WIDTHS]}; TernGrad with -0.0 and NaN) on "
          f"the 11 layerwise buckets in one launch, MAX_BUCKETS + 8 buckets "
          f"in two and units of d in {list(PACK_EDGE_DIMS)}; max abs err "
          f"{gerr}", flush=True)
    ferr = check_grouped_fields(layer_shapes, dev)
    errs["fields_pack"] = max(errs["fields_pack"], ferr[0])
    errs["fields_unpack"] = max(errs["fields_unpack"], ferr[1])
    print(f"grouped fields_pack / fields_unpack: bitwise equal to the "
          f"per-bucket plain twins at widths {list(FIELD_WIDTHS)} over k in "
          f"{list(FIELD_EDGE_KS)} (one launch each way a width), the 22 "
          f"mixed-width layerwise legs in one launch, MAX_BUCKETS + 9 "
          f"buckets in two, and inputs 4 bytes past a 16-byte boundary; max "
          f"abs err {ferr}", flush=True)
    serr = check_grouped_sign_unpack(layer_shapes, dev)
    errs["sign_pack"] = max(errs["sign_pack"], serr[0])
    errs["qsgd_unpack"] = max(errs["qsgd_unpack"], serr[1])
    errs["bits_unpack"] = max(errs["bits_unpack"], serr[2])
    print(f"grouped sign_pack / qsgd_unpack / bits_unpack: bitwise equal to "
          f"the per-bucket plain twins (sign with -0.0 and NaN; QSGD widths "
          f"{[w for w, _ in QSGD_WIDTHS]}, packed and random words; bits on "
          f"sign and random words) on the "
          f"11 layerwise buckets in one launch, MAX_BUCKETS + 8 buckets in "
          f"two, units of d in {list(GROUPED_EDGE_DIMS)} and inputs 4 bytes "
          f"past a 16-byte boundary, grouped and one at a time; max abs err "
          f"{serr}", flush=True)
    derr = check_grouped_decode(layer_shapes, dev)
    errs["terngrad_unpack"] = max(errs["terngrad_unpack"], derr[0])
    errs["sign_unpack"] = max(errs["sign_unpack"], derr[1])
    print(f"grouped terngrad_unpack / sign_unpack (the unpack tile walk): "
          f"bitwise equal to the per-bucket plain twins on packed and "
          f"random words on the 11 layerwise buckets in one launch, "
          f"MAX_BUCKETS + 8 buckets in two, units of d in "
          f"{list(GROUPED_EDGE_DIMS)} and words 4 bytes past a 16-byte "
          f"boundary, grouped and one at a time; max abs err {derr}",
          flush=True)
    verr = check_grouped_vote(layer_shapes, dev)
    errs["bits_pack"] = max(errs["bits_pack"], verr[0])
    errs["majority"] = max(errs["majority"], verr[1])
    print(f"grouped bits_pack (the ballot walk it shares with sign_pack) / "
          f"majority: bitwise equal to the per-bucket plain twins on the 11 "
          f"layerwise buckets in one launch, MAX_BUCKETS + 8 buckets in two, "
          f"units of d in {list(GROUPED_EDGE_DIMS)}, votes of "
          f"{list(VOTE_NS)} workers over W in {list(VOTE_EDGE_COLS)} (zero "
          f"columns, exact ties) and inputs 4 bytes past a 16-byte "
          f"boundary, grouped and one at a time; max abs err {verr}",
          flush=True)
    unit_shapes = [(n // WORKERS, d) for n, d in layer_shapes]
    qerr = check_grouped_compress(unit_shapes, em_shape[1], dev)
    errs["qsgd_compress_rows"], errs["terngrad_compress_rows"] = qerr
    print(f"grouped qsgd_compress_buckets (levels {list(COMPRESS_LEVELS)}) "
          f"/ terngrad_compress_buckets (both pair walks, 1 and 4 pairs a "
          f"thread, uniforms drawn in the kernel): bitwise equal to the plain twins on the 11 "
          f"layerwise buckets in one launch, MAX_BUCKETS + 8 buckets in two, "
          f"units of d in {list(COMPRESS_EDGE_DIMS)} at draw granules "
          f"{UNIT_DRAW} and {WHOLE_DRAW}, d = {em_shape[1]} and {MICRO} at "
          f"both, and units 4 bytes past a 16-byte boundary (-0.0, NaN, "
          f"zero statistics), grouped and one bucket at a time; max abs err "
          f"{qerr}", flush=True)
    cshapes = layer_shapes + [(1, em_shape[1]), (1, MICRO)]
    cerrs = check_compress_kernels(cshapes, dev)
    errs.update(cerrs)
    print(f"compress-only kernels vs plain: top-k (k {list(TOPK_KS)}) "
          f"bitwise over {len(cshapes)} shapes, and flat (k "
          f"{list(TOPK_EDGE_KS)}, f32 and bf16) on d in "
          f"{list(TOPK_FLAT_DIMS)}, special rows and a view one element "
          f"off a 16-byte boundary; rmsnorm {RMS_SHAPE} f32 and "
          f"bf16 and {RMS_WIDE} bf16 (looped) within tolerance, a "
          f"misaligned view refused; max abs err {cerrs}", flush=True)

    runs = main_path_runs(dev)
    n_msgs = check_step_buffers(dev)
    print(f"one-step wire buffers: {n_msgs} messages equal the plain build; "
          f"EF aggregation (QSGD, top-k) through the kernels equals the sim "
          f"path", flush=True)
    n_opt = check_optimizers(dev)
    print(f"optim.apply_updates: {n_opt} optimizers x 2 steps on resnet9's "
          f"parameters, the card's bits == the CPU's", flush=True)

    timings = time_kernels(layer_shapes, em_shape, dev)
    timings += time_compress_kernels(unit_shapes, em_shape[1], dev)
    for r in timings:
        print(f"  {r['group']:17s} {r['kernel']:15s} {r['leg']:7s} "
              f"{str(r['shape']):15s} w{r['width']:<2d} "
              f"ms={r['ms']:.5f} call_ms={r['call_ms']:.5f} "
              f"plain_ms={r['plain_ms']:.5f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}; bytes "
              f"{r['bytes_ms']:.6f}, ops {r['ops_ms']:.6f}) "
              f"bytes={r['bytes']}"
              + (f" library_ms={r['library_ms']:.5f}"
                 if r.get("library_ms") is not None else "")
              + (f" copy_ms={r['copy_ms']:.5f}" if "copy_ms" in r else "")
              + (f" per_thread={r['per_thread']} hashes={r['hashes']}"
                 if "per_thread" in r else "")
              + (f" {r['input']} auto={r['auto']}" if "auto" in r else ""),
              flush=True)
    encode_ms = encode_host_ms(layer_shapes, dev)
    print(f"  QSGD encode of a layerwise step, per call from Python (ms): "
          f"{encode_ms}", flush=True)
    natural_ms = natural_host_ms(layer_shapes, dev)
    print(f"  natural encode / decode of a layerwise step, per call from "
          f"Python (ms): {natural_ms}", flush=True)
    multi, multi_launches, multi_secs = multi_rank_path()
    launches = {k: sum(r["launches"][k] for r in runs)
                + multi_launches.get(k, 0) for k in SOURCES}
    compress, compress_launches = compress_path(dev)
    check(all(compress_launches[k] == 0 for k in SOURCES),
          f"compress-only path launched wire kernels: {compress_launches}")
    launches.update({k: compress_launches[k] for k in COMPRESS_SOURCES})
    print(f"compress-only path: plan_compress QSGD({MAIN_LEVELS}) and "
          f"TernGrad at layerwise / entire-model / blockwise({BLOCK}) (11 / "
          f"1 / 1 buckets) with one launch a call, == the plain build; "
          f"whole-input "
          f"QSGD, TernGrad and top-k(5) on d = {em_shape[1]} and {MICRO} == "
          f"plain; rmsnorm {RMS_SHAPE} bf16 within tolerance; "
          f"{compress['seconds']:.2f} s, launches "
          f"{ {k: compress_launches[k] for k in COMPRESS_SOURCES} }",
          flush=True)
    calls = compress_calls(dev)
    for r in calls:
        print(f"  whole call {r['call']:33s} host_ms={r['host_ms']:.5f} "
              f"kernels={r['kernels']} copies={r['copies']} "
              f"device_ms={r['device_ms']:.5f}", flush=True)
    for gname, b in compress["bounds"].items():
        print(f"  theory QSGD({MAIN_LEVELS}) {gname}: Trace(A) "
              f"{b['trace_A']:.1f}, entire-model bound "
              f"{b['entire_model_bound']:.1f}, layerwise_tighter "
              f"{b['layerwise_tighter']}", flush=True)
    print(f"  Lemma 1 (QSGD({MAIN_LEVELS}) over the "
          f"{compress['lemma1_parts']} layer parts): lhs {compress['lemma1'][0]:.6g} <= "
          f"mid {compress['lemma1'][1]:.6g} <= rhs "
          f"{compress['lemma1'][2]:.6g}", flush=True)
    lm, lm_launches = lm_phase(dev)
    for k, v in lm_launches.items():
        launches[k] += v
    serve = serve_phase(dev, card)
    engine, engine_launches = engine_phase(dev)
    for k, v in engine_launches.items():
        launches[k] += v
    control, control_launches, cerr = control_phase(dev)
    for k in SOURCES:
        launches[k] += control_launches.get(k, 0)
    errs["fields_pack"] = max(errs["fields_pack"], cerr[0])
    errs["fields_unpack"] = max(errs["fields_unpack"], cerr[1])
    tp, tp_launches, tp_errs = tp_phase(dev)
    for k in SOURCES:
        launches[k] += tp_launches.get(k, 0)
    for k, v in tp_errs.items():
        errs[k] = max(errs[k], v)
    obs, obs_launches = obs_phase(dev, [r["obs"] for r in multi])
    for k in SOURCES:
        launches[k] += obs_launches.get(k, 0)
    for k, v in obs["engine"]["errs"].items():
        errs[k] = max(errs[k], v)
    resil, resil_launches = resil_phase(dev, [r["faults"] for r in multi])
    for k in SOURCES:
        launches[k] += resil_launches.get(k, 0)
    timings += lm["timings"]
    summary = kernel_line(timings, launches, errs)
    from repro_torch.core.compressors import QSGD, TopK
    profiles = [profile_steps(dev, qw) for qw in (
        QSGD(levels=MAIN_LEVELS), TopK(ratio=SPARSE_RATIO))]
    for prof in profiles:
        print(f"profile ({prof['compressor']} layerwise, {prof['steps']} "
              f"steps): wall {prof['wall_ms_per_step']:.3f} ms/step, device "
              f"busy {prof['device_busy_ms_per_step']:.3f} ms/step, idle "
              f"share {prof['idle_share']}, {prof['device_events']} device "
              f"events", flush=True)
        for name, t in prof["top_device_ms_per_step"]:
            print(f"  device {t:.4f} ms/step  {name}", flush=True)
    total = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "seconds": total,
        "build_seconds": secs, "main_path": runs, "timings": timings,
        "encode_call_ms": encode_ms, "natural_call_ms": natural_ms,
        "profiles": profiles, "multi_rank": multi,
        "compress_path": compress, "compress_calls": calls,
        "ptxas": {src: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                  for src, log in build.BUILD_LOG.items()},
        "multi_rank_seconds": multi_secs, "lm": lm, "serve": serve,
        "engine": engine, "control": control, "tp": tp, "obs": obs,
        "resil": resil, "summary": summary},
        indent=1))
    print(f"total {total:.1f} s", flush=True)
    print(f"{card}")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
