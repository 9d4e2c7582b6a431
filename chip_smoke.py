#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Seventeen paths, each driven with the kernels' launch counts set to 0
just before it and read just after:

* Sparse plane.  Per-key analytics over B = 4096 independent turnstile
  streams (one per tenant or request) at the engine's defaults -- rows 7,
  width 2048, 512 candidates, p = 1, ppswor, FlushPolicy(max_elems=4096).
  Stream b is ``TurnstileZipfStream(vocab_size=2**20, alpha=1.2,
  delete_fraction=0.25)`` shard b: 4096 inserts plus 1024 retractions per
  step.  Eight steps are ingested, then ``sample(k=64)``.  Device state:
  4096 x 7 x 2048 x 4 B = 235 MB of tables.
* Dense segments.  ``SketchEngine.update_dense`` on the per-layer gradient
  streams of one gemma2_2b decoder layer, one stream per parameter leaf (the
  shape of ``gradcomp.tree_compress_step_engine``): 11 streams, 77.9 M live
  elements a step, 4 steps, then ``sample(k=32)``.  Depth is cut to 1 layer
  of 26; the widths are the published ones.
* Single-stream entry points.  ``ops.sketch_dense_vector`` at n = 1 M and at
  one gemma2_2b ``wg`` leaf (21.2 M), ``ops.query_rows``/``ops.estimate``
  with 512 keys, ``ops.transform`` in float32 and bfloat16 (the shapes of
  benchmarks/sketch_throughput.py), and ``ops.query_rows_batched`` (the
  per-row reads of those two tables).
* Samplers.  The sparse plane's stream and engine defaults (B = 4096,
  capacity 512, 8 cascade samplers) through the other samplers:
  ``twopass`` (ingest, ``sample(k=64)``), ``tv`` (ingest, ``sample(k=8)``),
  ``onepass`` with ``freeze``, 8 ``update_pass2`` calls and
  ``sample_exact(k=64)``, and the ``perfect`` oracle (domain 2**20) on the
  first 256 streams.  After each flush the first 256 streams are held
  against the plain update of the state before it (the kernel path's
  state, so that a near tie swapped once does not carry over); tables
  within both bounds, candidate and pass-II keys identical but for near
  ties, exact frequencies equal.  Cut: the plain reference runs on 256 of
  the 4096 streams (per-stream seeds hash only the stream index, so they
  are the same streams).
* Deterministic flush, async and pipeline planes.  Under
  ``torch.use_deterministic_algorithms(True)`` the scatter takes its "det"
  variant (each cell summed in an order fixed by slot index) and the
  flush's segment sums the sorted segment-sum kernel; ``onepass`` at B =
  4096 on the ``sparse`` and ``async`` planes, 8 steps, must then give the
  same state and ``sample(k=64)`` bit for bit, as ``twopass``, ``tv`` and
  ``perfect`` must on the first 256 streams.  In the default mode the two
  planes' ingest rates and traced busy shares are recorded (the async
  plane's overlap, measured and not claimed).  The ``pipeline`` plane
  (4 shards, 2 flushes at B = 4096) is held to the sparse plane, and the
  sparse plane to the plain scatter, within the summing tolerances, its
  async sub-planes to its sparse ones bit for bit,
  and a stalled producer's tail must be published by the interval timer.
* Wire.  At the sparse plane's deployment (the same stream, 8 steps): (a)
  every codec's roundtrip of the one-pass state (235 MB of tables) bit for
  bit the host's decode(encode), its wire bytes and stage times, and
  ``fake_quant`` on the card equal to the host grid on the finite slices;
  (b) the ``pipeline`` (4 shards, 2 flushes) under every codec, its
  collapse bit for bit the merge of the roundtripped shard states in the
  deterministic mode, the samples that differ from ``none``'s over the
  union of both buffers counted, and a ``max_bytes`` budget flushing at the
  encoded count; (c) ``launch.serve``'s aggregation of 4 workers (the
  butterfly) and 3 (the tree), round-robin over the steps, held to one
  engine of every step, under q8 bit for bit the merge of the roundtripped
  states, a worker of other seeds refused; (d) checkpoints of the one-pass
  state under every codec and of ``twopass``, ``tv`` and ``perfect`` on
  the first 256 streams (**cut**, as in the samplers phase) under none and
  q8: bit for bit with the next sample and flush identical (none), within
  the codec's bound (lossy), a flipped byte refused, save and restore MB/s;
  (e) the ``fleet`` plane (2 replicas, 2 flushes) bit for bit the pipeline's
  in the deterministic mode under none and q8.
* Conformance grid.  ``repro_torch.validate.conformance.run_suite``'s
  grid at the nightly operating point (``python -m repro_torch.validate
  --deep``): every sampler, both schemes, p in {0.5, 1, 1.5, 2}, every
  plane (dense, ingest, async, pipeline, fleet), n = 96, k = 8, rows 5,
  width 31 k, 384 trials against 1,152 oracle trials, the codec axis at
  p = 1 (one-pass cells through the pipeline's and the fleet's fp16, q8
  and size_adaptive merge boundaries, and the q2 negative control; at
  ``--deep``'s p = 0.5 the admissibility gate refuses q8 and size_adaptive,
  printed and not gated), and the
  Table 3 rows (n = 10**4, k = 100) at 12 randomizations.  No check may
  fail, and every cell must pass one; every path but dense must launch
  the scatter and the estimate kernels, and no plane's thread may
  outlive the grid.  In the deterministic mode the async path's trials
  equal the ingest path's bit for bit.
* Multi-process fleet.  ``FleetCoordinator`` at the sparse plane's
  deployment (the same stream, 8 steps): R = 2 replica processes on the
  card, ``publish_every=4``, replica 1 killed after 3 blocks, in the
  deterministic mode (each replica inherits it across the spawn):
  ``merged_state()`` and ``sample(k=64)`` bit for bit the in-process
  ``fleet`` plane's; the default (atomics) mode at R = 2 over 2 steps within
  the summing tolerances of the fleet plane's state, samples equal but for
  near ties; R = 3 on the first 256 streams (**cut**) under a hang found by
  the probe, a corrupt publish (IOError) then a wrong-seed publish
  (ValueError) then healed, and a slow replica under backpressure, each bit
  for bit the fleet plane's; ``python -m repro_torch.launch.fleet_serve
  --replicas 2 --kill-replica 1 --kill-after 3 --verify --steps 12`` (**cut**
  from its default 24 steps) and ``--replicas 2 --verify --topk 400
  --steps 4`` (a 5 x 12,400 table, which the det kernels split across
  blocks) in subprocesses at once, each of which must print
  ``parity=bitwise``.  Start and recovery seconds, route
  p50/p99, events/s, published MB and the replicas' kernel launches (each
  replica reports its counts with its publishes and its stop) recorded.
* Gradient compression.  ``optim.gradcomp`` on the dense phase's gemma2_2b
  layer (11 leaves, 77.9 M coordinates; **cut** to 1 layer of 26) over a
  one-rank NCCL group: 3 error-feedback steps of
  ``tree_compress_step_engine(k_per_leaf=32, cand_per_leaf=64)`` at the
  ``CompressorConfig()`` defaults, each applied by ``adamw.update`` to
  float32 parameters; ``tree_compress_step`` and
  ``tree_compress_step_sharded`` once; the engine path once under q8.
  Sampled values equal a at the ids and ``sparse + err == a`` bit for bit,
  1 to 32 nonzeros a leaf, the ids of the plain path (the ``ref`` table and
  plain estimate) but for near ties, ``comm_bytes`` by the reference's
  formula, 1 update-kernel and 1 estimate launch per engine call.
* Deterministic dense update.  Under ``torch.use_deterministic_algorithms(
  True)`` the dense update takes its "det" variant (each chunk of a segment
  summed in slot order by the det scatter's block body, the chunk tables
  then in chunk order by a second pass).  At the dense phase's gemma2_2b
  layer (11 leaves, 77.9 M live slots; **cut** to 1 layer of 26), values
  made on the card: three launches give the same bits, equal bit for bit
  to the order model (``ref.countsketch_update_det_ref`` on the card, at
  the plan's chunk) without the transform and, with it, fed the
  ppswor_transform kernel's values; each cell within its rounding bound of
  the plain version and of the shared-memory (atomics) variant.
  ``SketchEngine.update_dense`` and ``gradcomp.tree_compress_step_engine``
  (one-rank NCCL group) run twice each in the mode: the same bits both
  times, 2 det launches each.  Times of both variants, the order model and
  the bound.
* Serving.  (a) gemma2_2b at its published widths, **cut** to 2 layers (one
  local/global pair), float32 with TF32 off, random weights from the seed:
  a 1024-token prompt and 8 greedy decode steps on the card, the same
  weights through the port's CPU path (decode teacher-forced on the card's
  ids), logits allclose (rtol 1e-4, atol 1e-3 x max(1, max|logit|)); on the
  card, decode from a 512-token prefill against the forward's logits within
  the reference test's 0.1.  (b) ``repro_torch.launch.serve.main`` at
  gemma2_2b's full published configuration (26 layers, d_model 2304,
  vocabulary 256,000, bfloat16, 2.6 B parameters) with ``--batch 4
  --prompt-len 5120 --tokens 32 --worp-topk 8``: the prompt is longer than
  the local window (4096), so the local layers' rings wrap.  Against one
  causal forward over the prompt and its ids, in bfloat16 and (the weights
  cast) in float32: decode from a 3072-token prefill, teacher-forced on
  the prompt inside the window, within the reference test's 0.1 in
  float32; the CLI's own decode recorded (its rings evict the wrong key
  past the prompt, the reference's fault, ROADMAP Queue 3); the
  token analytics' state and sample against a CPU ``dense``-plane engine
  of the same ids (tables within the summing bounds, samples equal but for
  near ties); scatter and estimate launched, the row read not.  (c) the
  same with ``--workers 2 --worp-window 16 --plane async``: the aggregated
  state and sample against one engine that saw every step and retraction.
  Prefill ms, decode ms a step, tokens/s, the analytics' ms and peak memory
  recorded.
* Model families.  (a) olmoe_1b_7b, grok1_314b, mamba2_13b,
  recurrentgemma_9b, seamless_m4t_large_v2 and phi3_vision_42b reduced,
  float32 with TF32 off: a 64-token prompt (the vlm's after its patches,
  the enc-dec's with its frames) and 4 greedy decode steps on the card
  against the port's CPU path, logits allclose (rtol 1e-4, atol 1e-3 x
  max(1, max|logit|); seamless 1e-2 x).  (b) ``serve.main`` at the full
  published configurations in bfloat16 (random weights from the seed),
  ``--batch 4 --tokens 32 --worp-topk 8``: olmoe_1b_7b, mamba2_13b and
  recurrentgemma_9b with 4096-token prompts (past recurrentgemma's
  2048 window), phi3_vision_42b with 3520 after its 576 patch
  embeddings; each launching the scatter and the estimate, its analytics
  held to a CPU ``dense``-plane engine of the same ids, olmoe's dropped
  MoE choices counted; mamba2_13b once more at the CLI's default 64-token
  prompt, which the reference's cache growth crashes (ROADMAP Queue 3).
  (c) seamless_m4t_large_v2 at its published configuration, through
  ``model.prefill`` (4 x 4096 frames, a 1024-token prompt) and 32
  ``model.decode_step`` calls over the grown self cache (the CLI refuses
  the enc-dec, as the reference's does).  (d) for each of (b) and (c), in
  float32 (the CLI's weights) on request 0: one forward, a prefill of its
  first part and 32 decode steps teacher-forced on the rest
  (recurrentgemma's prefill and steps inside its window).  At full depth
  recorded beside the prefill's last logits against the forward's: with
  the reference's init the attention scores reach the hundreds and the
  deep random models are chaotic, two forwards over other lengths
  differing as much as decode does.  Gated at the reference test's 0.1
  of max|logit| on the first layers (``FAMILY_DVF_LAYERS``: 4 of olmoe
  at capacity E / K, where no choice drops, 12 of recurrentgemma, 3 of
  phi3_vision, 2 + 2 of seamless; all 48 of mamba2).  Prefill ms, decode
  ms a step, tokens/s, the analytics' ms, peak memory, the dropped MoE
  choices and launches recorded.
* Training.  (a) phi4_mini_38b, mamba2_13b and olmoe_1b_7b reduced,
  float32 with TF32 off: 3 ``train_step``s (batch 2, 64 tokens, lr 3e-4)
  on the card and on the CPU from the same weights and batches, losses
  and parameters within 1e-3 x max(1, max|want|) (AdamW moves an element
  by at most ~lr a step), moments within 5e-2 x their leaf's max|want|.
  (b) ``repro_torch.launch.train.main(["--arch", "mamba2_13b", "--steps",
  "4"])`` at the published configuration (1.35 B parameters, bfloat16,
  batch 8, seq 128): finite losses.  (c) ``train.loop.run_training`` at
  gemma2_2b's published configuration (2.6 B, bfloat16), 6 steps of 8 x
  128 tokens with one-pass token analytics (top 16) on the ``async``
  plane: finite losses, the last below the first, the scatter and the
  estimate launched, ``top_tokens`` equal to a CPU engine's of the same
  ids.  (d) ``run_training(compressed=True)`` over a one-rank NCCL group
  at mamba2_13b's widths **cut** to 2 of 48 layers (the flat path's plain
  sketch holds ~200 B a coordinate): 3 steps, one step of
  ``make_compressed_train_step_tp``, and the flat and sharded rounds held
  to the two-pass invariants bit for bit.  (e) at the same cut, 8 steps
  against 4 plus a resume of 4 from a checkpoint: the final loss within
  rel 1e-4 in the default mode; in the deterministic mode a second
  uninterrupted run, and every loss and the final weights bit for bit.
  Step ms, tokens/s, peak memory, wire bytes, checkpoint MB/s and
  launches recorded.
* Ingest pipeline.  ``PrefetchingFeeder`` at the sparse plane's
  deployment: one canonical ``TurnstileZipfStream(2**20, alpha=1.2,
  delete_fraction=0.25)`` over 4 producer shards, packed into (4096, 4096)
  blocks (B = 4096 streams); fan-in into ``sparse`` and ``async``,
  per-shard into ``pipeline`` (4 shards), each held to the sparse plane's
  direct ingest of the same stream (itself held to the plain scatter's
  table) within the summing bounds and, read
  over the union of both candidate buffers, with the same samples but for
  near ties; fan-in ``async`` equal to fan-in ``sparse`` bit for bit in
  the deterministic mode.  Events/s, pack efficiency, the producers' and
  the pump's wait and the busy share of a traced feed are recorded.
* The paper's runners.  ``repro_torch.paper`` at ``--fast``: Table 3 (the
  five rows, n = 10**4, k = 100, 10 randomizations), Figure 1, Figure 2
  and Appendix B.1, through ``core.worp``'s plain sketch on the card (no
  kernel launched, as the reference's runners launch none); each row and
  its time printed; for the first randomization of each Table 3 row the
  ``wor``, ``one`` and ``two`` sample keys equal to a CPU run's.
* The examples.  The six ``examples/torch_*.py``, each in a process of its
  own on the card, all started together, at their default sizes (the
  train example at 3 steps over one NCCL rank): each exits 0 and prints
  and returns its claims true (two-pass == perfect p-ppswor; the merged
  sketch == the union's; async == sync bit for bit and the butterfly
  aggregate == one worker, in the deterministic mode; fan-in == sync bit
  for bit and the per-shard collapse close; finite prefill logits; finite
  losses); their kernel launches read from the children.
* The dry-run.  ``python -m repro_torch.launch.dryrun`` over every
  architecture x shape on one card (a subprocess on the host, started
  before the paper phase): every cell ``ok`` or a documented skip.  Its reckoning of mamba2_13b's and gemma2_2b's train
  steps at 8 x 128 (the train phase's CLI and loop steps) against the
  same steps on the card, in a fresh process: counted FLOPs within
  relative 1e-6 of ``FlopCounterMode``'s count of the real step, the
  parameter and moment bytes equal to the allocator's deltas of
  ``init_params`` and ``adamw.init``; the predicted against the measured
  peak and the model-FLOP share of the bf16 peak printed.

Every estimate of the sparse and dense paths (candidate refresh, sample)
is one launch of the estimate kernel, which takes the median of rows in
registers; the row-read kernel serves ``query_rows`` and tables of more
than 16 rows, and the paths must not launch it.  The summing kernels
(scatter, dense update) have two variants, chosen by shape before the
launch: the shared-memory table (one block per stream chunk) wherever rows
x width fits a block, as at every shape of the three paths, and global
atomics for larger tables.  The paths must run the shared-memory variant;
the script also checks and times the global one at the same shapes (forced
through the wrappers' private ``_variant``).  The transform has a 16-byte
vector variant for aligned tensors and a scalar one, chosen by alignment
(the script reaches the scalar one through views that start one element
in).

Phases (each prints its own lines and its wall time; any failure raises and
the script exits non-zero without the final ``ok`` line):
  1. the card, and the kernels built from ``src/repro_torch/kernels/csrc``
     with ptxas's registers, stack frames and spills, and their shared
     memory and blocks per SM;
  2. each batched kernel against its plain PyTorch version on the card,
     both variants of the scatter at the deployment shape, a hot-key
     stream, and a table too large for shared memory, the scatter at
     p = 0.5, 1.5 and 2 and at the conformance grid's flush shape for each
     of its p and schemes; the estimate at the
     flush shape, on special values and at 17 rows (the row read);
  3. the sparse plane (the kernels) against the dense plane (the plain
     reference), from the same seeds and stream, and a ``torch.profiler``
     trace of the sparse plane's flush stages;
  4. the sparse path's times: kernels (both variants, and a hot-key
     stream), plain versions, library yardsticks, events/s, sample latency,
     peak memory;
  5. the dense segment path against the plain path, the estimate at its
     shape, its times (both variants) and a trace;
  6. the single-stream entry points and ``query_rows_batched`` against
     their plain versions (the transform at p = 0.5, 1, 1.5 and 2, both
     variants, the edge key and n not a multiple of the vector width), and
     times; the row read at the flush's 4096 x 512 keys, rows 7 and 17;
  samplers.  ``twopass``, ``tv``, ``onepass``'s exact second pass and
     ``perfect`` against the plain path, their launches (a ``twopass``
     flush 1 scatter + 2 estimates, a ``tv`` flush 2 + 2, a ``tv`` sample
     r + 1 estimates, an ``update_pass2`` call 1 estimate, ``perfect``
     none), traces of a flush and a sample each, times, the recall of the
     exact two-pass sample against the perfect oracle, and the scatter and
     the estimate at the TV cascade's shapes against their bounds;
  determinism.  the det scatter at the flush and the TV cascade shapes
     (three launches identical, each cell within its bound of the plain
     version and of the atomics variant) and the segment sum (equal to the
     CPU's bit for bit), with their times and the NaN fill of
     ``torch.empty`` in the mode; the det scatter on tables too large for
     one block, split across blocks (5 x 12,400 and 7 x 16,384 on the
     flush's streams, 1 x 100,000 on 64: the same bits three times, the
     order model's, against the global atomics' time); async against
     sparse bit for bit; the overlap; the pipeline; the interval timer;
  wire.  codecs, the pipeline's codec and byte budget, serving
     aggregation, checkpoints, the fleet plane (above), with their wire
     MB, stage times, MB/s and launches by part;
  fleet.  the replica processes against the fleet plane (above), their
     start, recovery and route times, published MB and launches, and the
     fleet_serve subprocess;
  gradcomp.  the three gradient-compression paths and AdamW (above), each
     path's ms, the launches per engine call, peak memory;
  det update.  the dense update's det variant at the gemma2_2b layer
     (three launches identical, the order model bit for bit, each cell
     within its bound of the plain version and of the atomics variant),
     update_dense and the gradcomp engine step twice each in the mode, the
     same bits, with the times of both variants and the bound; the det
     update split across blocks (the layer at 7 x 16,384, one segment at
     1 x 100,000), the same checks;
  serve.  the 2-layer float32 pair against the CPU path, the serving CLI
     at the full configuration and with 2 workers, a window and the async
     plane (above), with prefill and decode times, tokens/s, the
     analytics' ms, peak memory and launches;
  families.  the six new architectures' reduced pairs, the serving CLI
     of four at their full published configurations, the enc-dec's
     prefill and decode, decode against the forward (above), with their
     times, peak memory, dropped MoE choices and launches;
  train.  the reduced pairs, the training CLI at mamba2_13b's size,
     gemma2_2b's training with token analytics, compressed data
     parallelism and restart (above), with step times, tokens/s, peak
     memory, checkpoint MB/s and launches;
  validate.  the conformance grid, its codec axis and Table 3, one
     ``conformance_check`` line per check and the ``conformance_summary``
     line, times by path and by sampler, launches by path, live threads;
     the deterministic async cell;
  ingest.  the feeder's fan-in and per-shard runs against direct ingest,
     their rates and waits, a traced feed, the deterministic fan-in;
  paper.  the four runners' rows and times, their keys against the CPU;
  examples.  the six examples' claims, times and launches;
  dryrun.  the sweep's cells, the two train steps' reckoning against the
     card (FLOPs, bytes, peaks, share of peak);
  7. one ``{"kernels": [...]}`` line, then the ``ok`` line.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
``python3 chip_smoke.py --card-step ARCH[,ARCH]`` runs only the dry-run
phase's card steps and prints their records.
``python3 chip_smoke.py --det-parent DIR [DIR ...]`` runs only the dense
update's det kernel of the checkouts at DIR (e.g. a ``git archive`` of the
parent commit) beside this tree's, checks each against its order model
and times them in turns; then the same on tables too large for one det
block (the layer at 7 x 16,384, one segment at 1 x 100,000; this tree's
thread block clusters); then the det scatter at the flush shape and on
its split tables (5 x 12,400 and 7 x 16,384 at the flush, 1 x 100,000 on
64 streams; every checkout's bits equal, beside the wrapper, the atomics
and the index_add_ yardstick), and the row read at B = 2 and 1 x 512 keys
and 4096 x 512 at rows 7 and 17, beside the gather yardstick.
``python3 chip_smoke.py --sass`` instead builds the transform factor alone,
as it was (``-logf`` then ``powf``) and as it is, and prints the static
SASS instruction counts of each (``cuobjdump -sass``); it needs the CUDA
toolkit, not a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

B, ROWS, WIDTH, CANDIDATES, P, K = 4096, 7, 2048, 512, 1.0, 64
INSERTS, STEPS, VOCAB, ALPHA, DELETE_FRACTION = 4096, 8, 1 << 20, 1.2, 0.25
RTOL = 1e-4  # the reference's scale-aware scatter tolerance; atol below
# named ranges of the sparse plane's flush (engine/planes.py) and of
# update_dense (engine/engine.py)
RANGES = ("plane.concat", "plane.h2d", "plane.dispatch", "sparse.scatter",
          "sparse.refresh")
DENSE_RANGES = ("dense.sketch", "dense.refresh")
DEVICE = "cuda"
# the samplers phase: the plain reference runs on the first SUB_B streams
# (per-stream seeds hash only the stream index, so they are the same
# streams); the TV cascade draws TV_K keys (its r = 8 draws)
SUB_B, TV_K = 256, 8
VARIANTS = ("smem", "global")
# kernels' registers, shared memory and blocks per SM, from phase 1
OCCUPANCY: dict = {}
TRANSFORM_PS = (0.5, 1.0, 1.5, 2.0)  # the transform's parity exponents
EDGE_KEY = 17691050  # uniform01 == 1.0 under transform seed 0 (ROADMAP)

# One gemma2_2b decoder layer's gradient leaves, one stream each: the widths
# of src/repro/configs/gemma2_2b.py (d_model 2304, 8 heads, 4 KV heads,
# head_dim 256, d_ff 9216) and the leaves of src/repro/models/transformer.py
# _attn_pd/_mlp_pd/_norms_pd with gemma2's post-norms, in
# jax.tree_util.tree_leaves order (sorted keys).  Cut: 1 layer of 26.
GEMMA_D, GEMMA_H, GEMMA_KV, GEMMA_DH, GEMMA_FF = 2304, 8, 4, 256, 9216
LEAVES = (("ln1", GEMMA_D), ("ln1p", GEMMA_D), ("ln2", GEMMA_D),
          ("ln2p", GEMMA_D), ("wg", GEMMA_D * GEMMA_FF),
          ("wi", GEMMA_D * GEMMA_FF), ("wk", GEMMA_D * GEMMA_KV * GEMMA_DH),
          ("wo", GEMMA_H * GEMMA_DH * GEMMA_D),
          ("wo_mlp", GEMMA_FF * GEMMA_D), ("wq", GEMMA_D * GEMMA_H * GEMMA_DH),
          ("wv", GEMMA_D * GEMMA_KV * GEMMA_DH))
DENSE_STEPS, DENSE_K = 4, 32  # k = gradcomp's k_per_leaf
GRAD_LOG_SCALE = 1.5          # per-coordinate scale exp(1.5 g), g ~ N(0, 1)
# single-stream entry points: benchmarks/sketch_throughput.py's shapes
SINGLE_N = (1_000_000, GEMMA_D * GEMMA_FF)
SINGLE_SEED, SINGLE_KEYS = 3, 512

# Device peaks for the bounds (H100 SXM at 700 W).  HBM3 rate from NVIDIA's
# data sheet.  The integer rate is the fp32 non-tensor rate of the data sheet
# (67 TFLOP/s = 132 SMs x 128 lanes x 2 x 1.98 GHz) scaled to Hopper's 64
# INT32 lanes per SM, counting one operation per lane and clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# 32-bit operations per work item, counted from kernels/csrc/hashing.cuh:
# mix32 = 3 shifts + 3 xors + 2 multiplies = 8; hash_u32 = 2 mix32 + add +
# xor + multiply = 19; row_salt = 3; a bucket = hash + mask (the width is a
# power of two at every timed shape) = 20; a sign = salt xor + hash + and +
# select = 22; an address = 2.  -logf and the power count as one operation
# each (their SASS sequences are longer: ``--sass`` counts them), so these
# are lower bounds.
OPS_PER_ROW = 3 + 20 + 22 + 2
SCATTER_OPS_PER_SLOT = ROWS * OPS_PER_ROW + 24 + 2 + 3   # uniform01, log+pow,
QUERY_OPS_PER_KEY = ROWS * (OPS_PER_ROW + 1)             # mask; query: sign mul


# A median-of-7 selection network: 13 comparators, the median on wire 3
# (N. Devillard, "Fast median search: an ANSI C implementation", 1998).
MEDIAN7_NETWORK = ((0, 5), (0, 3), (1, 6), (2, 4), (0, 1), (3, 5), (2, 6),
                   (2, 3), (3, 6), (4, 5), (1, 4), (1, 3), (3, 4))


def select_ops(rows: int) -> int:
    """The least work the median of 7 reads needs: the min and the max that
    ``MEDIAN7_NETWORK`` computes only where they reach the median, a NaN
    test a row, the add and the multiply."""
    if rows != 7:
        raise ValueError(f"no median network is counted for {rows} rows")
    need, ops = {3}, 0
    for i, j in reversed(MEDIAN7_NETWORK):
        ops += (i in need) + (j in need)
        if i in need or j in need:
            need |= {i, j}
    return ops + rows + 2


ESTIMATE_OPS_PER_KEY = QUERY_OPS_PER_KEY + select_ops(ROWS)


def slot_ops(rows: int) -> int:
    """``SCATTER_OPS_PER_SLOT`` (= ``UPDATE_OPS_PER_SLOT``) of a table of
    ``rows`` rows: each row's hashing, the transform once."""
    return rows * OPS_PER_ROW + 24 + 2 + 3


def query_ops(rows: int) -> int:
    """``QUERY_OPS_PER_KEY`` of a table of ``rows`` rows."""
    return rows * (OPS_PER_ROW + 1)
# the dense update computes its key (an add) where the scatter loads and
# tests it, and tests the length alone: the same count per live slot
UPDATE_OPS_PER_SLOT = SCATTER_OPS_PER_SLOT
TRANSFORM_OPS_PER_ELEM = 24 + 2 + 1  # uniform01, log+pow, mul


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_median(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``reps`` calls of ``fn``, each timed alone by
    CUDA events (the card idle before each), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2] if reps % 2 else \
        sum(sorted(times)[reps // 2 - 1:reps // 2 + 1]) / 2


def device_ms(torch, fn, iters: int) -> float | None:
    """Device time per call of ``fn``: the device activities that a
    ``torch.profiler`` trace of ``iters`` calls records, summed, over
    ``iters`` (None when the profiler sees no device time).  For calls too
    short to keep the card busy, where CUDA events would time the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU
               and "Activity Buffer" not in e.key)
    return busy / 1e3 / iters if busy > 0 else None


def scale_atol(want) -> float:
    """The reference's scale-aware absolute tolerance, 1e-5 * max(1, max|w|)
    over the finite entries (benchmarks/engine_throughput.py)."""
    finite = want[want.isfinite()]
    top = float(finite.abs().max()) if finite.numel() else 0.0
    return 1e-5 * max(1.0, top)


def cell_check(torch, got, want, tol):
    """``got`` against ``want`` cell by cell within the per-cell bound
    ``tol`` (``ref.scatter_tolerance``); a non-finite cell of ``want`` must
    be matched exactly.  Returns (ok, max abs error over the finite cells,
    worst error / bound)."""
    fin = want.isfinite()
    same = (got == want) | (got.isnan() & want.isnan())
    err = torch.where(fin, (got - want).abs(), 0.0)
    # a non-finite cell's bound may be NaN (a NaN old value in its mass)
    ok = bool(same[~fin].all()) and bool(((err <= tol) | ~fin).all())
    ratio = torch.where(tol > 0, err / tol,
                        torch.where(err > 0, float("inf"), 0.0))
    return ok, float(err.max()), float(ratio.max())


def check_sum(torch, what, got, want, tol):
    """A summing kernel's output ``got`` against its plain version ``want``:
    allclose within rtol 1e-4 and the scale-aware atol, and every cell within
    its own rounding bound ``tol``.  Prints a ``[parity]`` line and raises on
    a failure; returns (max abs error, worst error / bound)."""
    torch.cuda.synchronize()
    atol = scale_atol(want)
    close = torch.allclose(got, want, rtol=RTOL, atol=atol, equal_nan=True)
    cells, err, ratio = cell_check(torch, got, want, tol)
    nonfinite = int((~want.isfinite()).sum())
    log(f"[parity] {what}: shape {tuple(got.shape)} max_abs_err {err:.3e}; "
        f"allclose atol {atol:.3e} {'ok' if close else 'FAIL'}; per-cell "
        f"bound worst err/bound {ratio:.3e} {'ok' if cells else 'FAIL'}; "
        f"nonfinite {nonfinite}")
    if not (close and cells):
        raise AssertionError(f"{what}: the kernel disagrees with its plain "
                             f"version")
    return err, ratio


def check_bitwise(torch, what, got, want):
    """A query's output against its plain version, equal under ``==`` with
    NaN equal to NaN (bit for bit but for the sign of a zero).  Prints a
    ``[parity]`` line and raises on a failure."""
    torch.cuda.synchronize()
    ok = got.shape == want.shape and bool(
        ((got == want) | (got.isnan() & want.isnan())).all())
    log(f"[parity] {what}: shape {tuple(got.shape)} equal (==, NaN equal to "
        f"NaN) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the kernel disagrees with its plain "
                             f"version")


def bound(nbytes, ops):
    """The least time in ms for ``nbytes`` moved and ``ops`` 32-bit integer
    operations, and which of the two bounds it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def special_tables(torch, g, B: int, rows: int, width: int):
    """(B, rows, width) float32 tables, a third of whose cells hold NaN,
    +-inf, +-0, +-3e38 (above FLT_MAX / 2, so a sum of two overflows) or a
    tied +-1, the rest N(0, 1), from the CPU generator ``g``."""
    pool = torch.tensor([float("nan"), float("inf"), float("-inf"), 0.0,
                         -0.0, 3e38, -3e38, 1.0, 1.0, -1.0])
    t = torch.randn((B, rows, width), generator=g)
    pick = pool[torch.randint(0, len(pool), t.shape, generator=g)]
    return torch.where(torch.rand(t.shape, generator=g) < 0.33, pick, t)


def check_estimate(torch, what, tables, keys, seeds):
    """``countsketch_estimate_batched`` against the plain median of the
    plain reads (``check_bitwise``); the estimate kernel must launch where
    the rows fit it (``fuses``), else the row read.  Returns the
    estimate."""
    from repro_torch.core import countsketch
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import ref

    fused = q.fuses(tables.shape[1])
    before = (q.launches, q.estimate_launches)
    got = q.countsketch_estimate_batched(tables, keys, seeds)
    ran = (q.launches - before[0], q.estimate_launches - before[1])
    if ran != ((0, 1) if fused else (1, 0)):
        raise AssertionError(f"estimate {what}: (row read, estimate) "
                             f"launches {ran}")
    check_bitwise(torch, f"estimate {what} "
                  f"[{'estimate kernel' if fused else 'row read + median'}]",
                  got, countsketch.median(
                      ref.countsketch_query_batched_ref(tables, keys, seeds),
                      1))
    return got


def check_no_row_sort(rows, what):
    """The traced window must hold no bitonicSortKVInPlace: PyTorch's sort
    of slices of at most 32 elements, which here was only the median's sort
    over rows."""
    found = [key for _, _, key in rows if "bitonicSort" in key]
    log(f"[profile] {what}: sorts over rows (bitonicSortKVInPlace) in the "
        f"trace: {len(found)}")
    if found:
        raise AssertionError(f"{what}: a sort over rows is still traced")


def gather_index(torch, keys, seeds, width: int, rows: int = ROWS):
    """(B, rows * k) int64 indices into each stream's flat (rows * width)
    table of its (B, k) keys' buckets, row by row: the gather yardstick's
    precomputed input."""
    from repro_torch.core import hashing

    B, k = keys.shape
    out = torch.empty((B, rows * k), dtype=torch.int64, device=keys.device)
    for r in range(rows):
        salt = hashing.row_salt(seeds[:, None], r)
        out[:, r * k:(r + 1) * k] = r * width + hashing.bucket_hash(
            keys, salt, width)
    return out


def table_bytes_read(torch, tables, keys, seeds) -> int:
    """The bytes of the distinct 32-byte sectors of ``tables`` that the
    (B, k) keys' buckets touch: what a query of these keys must read."""
    from repro_torch.core import hashing

    B, rows, width = tables.shape
    hit = torch.zeros(-(-tables.numel() // 8), dtype=torch.bool,
                      device=tables.device)
    base = torch.arange(B, device=tables.device)[:, None] * (rows * width)
    for r in range(rows):
        salt = hashing.row_salt(seeds[:, None], r)
        hit[(base + r * width + hashing.bucket_hash(keys, salt, width))
            // 8] = True
    return int(hit.sum()) * 32


def time_estimate(torch, what, tables, keys, seeds, iters, plain_iters,
                  tag) -> dict:
    """Times of the estimate at one shape: the estimate kernel, the row-read
    kernel alone and with ``countsketch.median`` (the path it replaces),
    the plain version and the gather yardstick (memory half only: the
    row read's gather at precomputed indices), each kernel beside its bound
    from these inputs."""
    from repro_torch.core import countsketch
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import ref

    B, rows, width = tables.shape
    n = keys.numel()
    t = {
        "estimate": cuda_ms(torch, lambda: q.countsketch_estimate_batched(
            tables, keys, seeds), iters),
        "row_read": cuda_ms(torch, lambda: q.countsketch_query_batched(
            tables, keys, seeds), iters),
        "row_read_median": cuda_ms(torch, lambda: countsketch.median(
            q.countsketch_query_batched(tables, keys, seeds), 1),
            max(2, iters // 4), warmup=1),
        "plain": cuda_ms(torch, lambda: ref.countsketch_estimate_batched_ref(
            tables, keys, seeds), plain_iters, warmup=1)}
    gidx = gather_index(torch, keys, seeds, width, rows)
    flat = tables.reshape(B, rows * width)
    t["library"] = cuda_ms(torch, lambda: torch.gather(flat, 1, gidx), iters)
    del gidx
    read = table_bytes_read(torch, tables, keys, seeds)
    row_ops = n * rows * (OPS_PER_ROW + 1)
    t["bound"], t["bound_by"] = bound(n * 8 + read,
                                      row_ops + n * select_ops(rows))
    t["row_bound"], t["row_bound_by"] = bound(n * 4 + read + n * rows * 4,
                                              row_ops)
    log(f"[time] estimate {what} (B={B}, k={keys.shape[1]}): estimate "
        f"kernel {t['estimate']:.4f} ms, bound {t['bound']:.4f} ms by "
        f"{t['bound_by']}, {100 * t['bound'] / t['estimate']:.1f} % of bound; "
        f"row read + countsketch.median {t['row_read_median']:.4f} ms (row "
        f"read alone {t['row_read']:.4f} ms, bound {t['row_bound']:.4f} ms by "
        f"{t['row_bound_by']}); plain {t['plain']:.4f} ms; gather yardstick "
        f"(memory half only) {t['library']:.4f} ms; table sectors read "
        f"{read / 1e6:.1f} MB {tag}")
    return t


def row_index(torch, keys, seeds, width: int, rows: int = ROWS):
    """Flat (stream, row, bucket) indices and signs of (B, n) keys, row by
    row: (B, rows * n) int64 and float32, for the library yardsticks."""
    from repro_torch.core import hashing

    base = torch.arange(keys.shape[0], device=keys.device)[:, None] \
        * (rows * width)
    idx, sign = [], []
    for r in range(rows):
        salt = hashing.row_salt(seeds[:, None], r)
        idx.append(base + r * width + hashing.bucket_hash(keys, salt, width))
        sign.append(hashing.sign_hash(keys, salt))
    return torch.cat(idx, 1), torch.cat(sign, 1)


def det_info_variant(kind, plan, width) -> int:
    """The ``worp_countsketch_<kind>_info`` variant of a det plan's kernel,
    its split 0 (whole), 1 (row groups) or 2 (bucket ranges): the
    scatter's 2 + (32-bit entries) + 2 x split, the dense update's 2 +
    split."""
    from repro_torch.kernels import tiling

    split = 2 if plan.ranges > 1 else 1 if plan.row_group else 0
    if kind == "update":
        return 2 + split
    return 2 + (tiling.det_span(plan, width) > 2**15) + 2 * split


def report_occupancy(tag):
    """Each kernel's registers, static and dynamic shared memory and
    resident blocks per SM at its launch shape (the CUDA occupancy
    calculator, through each source's ``worp_<name>_info``)."""
    from repro_torch.kernels import build, tiling

    table = ROWS * WIDTH * 4
    det = tiling.table_plan(B, INSERTS, None, ROWS, WIDTH, 132,
                            variant="det")
    wide = tiling.table_plan(B, INSERTS, None, 1, WIDE_WIDTH, 132,
                             variant="det")
    dense_det = tiling.table_plan(1, 1, [1], ROWS, WIDTH, 132, variant="det",
                                  det_chunks=True)
    split = {(kind, rows, width): tiling.table_plan(
        1, 1, [1], rows, width, 132, variant="det",
        det_chunks=kind == "update") for kind in ("scatter", "update")
        for rows, width, _ in SPLIT_TABLES}
    seg = tiling.SEGMENT_THREADS
    for name, variant, label, threads, smem in (
            ("countsketch_scatter", 1, "smem", tiling.TABLE_THREADS, table),
            ("countsketch_scatter", 0, "global", tiling.THREADS_PER_BLOCK, 0),
            ("countsketch_scatter", 2, "det", det.threads, det.smem_bytes),
            ("countsketch_scatter", 3, "det 32-bit entries", wide.threads,
             wide.smem_bytes),
            ("countsketch_update", 1, "smem", tiling.TABLE_THREADS, table),
            ("countsketch_update", 0, "global", tiling.THREADS_PER_BLOCK, 0),
            ("countsketch_update", 2, "det", dense_det.threads,
             dense_det.smem_bytes),
            *((f"countsketch_{kind}", det_info_variant(kind, plan, width),
               f"det split {rows} x {width}", plan.threads, plan.smem_bytes)
              for (kind, rows, width), plan in split.items()
              if not plan.cluster),
            ("countsketch_query", 2, "a lane a read", 32 * ROWS, 0),
            ("countsketch_query", 0, "a lane a key",
             tiling.THREADS_PER_BLOCK, 0),
            ("countsketch_query", 1, "estimate", tiling.THREADS_PER_BLOCK,
             0),
            ("ppswor_transform", 0, "float32", tiling.THREADS_PER_BLOCK, 0),
            ("ppswor_transform", 1, "bfloat16", tiling.THREADS_PER_BLOCK,
             0),
            ("ppswor_transform", 2, "float32 vector",
             tiling.THREADS_PER_BLOCK, 0),
            ("ppswor_transform", 3, "bfloat16 vector",
             tiling.THREADS_PER_BLOCK, 0),
            ("segment_sum", 0, "", seg, 0),
            ("segment_sum", 1, "4- and 8-byte copies", seg, 0)):
        info = build.kernel_info(name, variant, threads, smem)
        info.update(threads=threads, dynamic_smem=smem)
        OCCUPANCY[(name, label)] = info
        log(f"[occupancy] {name}{' ' + label if label else ''}: "
            f"{info['registers']} registers a thread, {threads} threads, "
            f"static smem {info['static_smem']} B, dynamic smem {smem} B "
            f"(limit {info['max_dynamic_smem']} B), {info['blocks_per_sm']} "
            f"blocks per SM {tag}")
    # the split tables' thread block clusters (tiling.det_cluster)
    for (kind, rows, width), plan in split.items():
        if plan.cluster:
            name = f"countsketch_{kind}"
            info = build.cluster_info(name, plan, width)
            info.update(threads=plan.threads, dynamic_smem=plan.smem_bytes,
                        cluster=plan.cluster)
            OCCUPANCY[(name, f"det split {rows} x {width}")] = info
            log(f"[occupancy] {name} det split {rows} x {width}: "
                + cluster_occupancy(info, plan) + f" {tag}")


def cluster_occupancy(info, plan) -> str:
    """The ``[occupancy]`` text of a det cluster plan's kernel."""
    part = "a bucket range of a row" if plan.ranges > 1 \
        else f"{plan.row_group} row{'s' if plan.row_group > 1 else ''}"
    return (f"{info['registers']} registers a thread, {plan.threads} "
            f"threads, dynamic smem {plan.smem_bytes} B, clusters of "
            f"{plan.cluster} CTAs ({part} a CTA), {info['blocks_per_sm']} "
            f"CTAs an SM, {info['active_clusters']} clusters active at once")


# ``--sass``: the transform factor alone, as it was (-logf, then powf
# whatever the exponent) and as csrc/hashing.cuh has it now, one element a
# thread; {E} is the exponent, run-time or a float32 constant
FACTOR_PROBE = """#include "hashing.cuh"
extern "C" __global__ void old_factor(const unsigned* keys, float* out,
                                      unsigned tseed, float e) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = powf(-logf(worp::uniform01(keys[i], tseed)), {E});
}
extern "C" __global__ void new_factor(const unsigned* keys, float* out,
                                      unsigned tseed, float e) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = worp::transform_factor(keys[i], tseed, worp::kPpswor, {E});
}
"""
SASS_EXPONENTS = {"run-time": "e", "p=1": "-1.0f", "p=1.5": "(-1.0f / 1.5f)"}


def factor_sass() -> int:
    """Build the factor probe for each exponent and print each kernel's
    static SASS instructions (no NOP) and its MUFU (special-function)
    instructions, from ``cuobjdump -sass``."""
    import re

    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    nvcc = build.nvcc()
    out_dir = build.BUILD_DIR / "factor_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for label, e in SASS_EXPONENTS.items():
        cu = out_dir / f"factor_probe_{label.replace('.', '_')}.cu"
        cu.write_text(FACTOR_PROBE.replace("{E}", e))
        cubin = cu.with_suffix(".cubin")
        subprocess.run([nvcc, *build.NVCC_FLAGS[:4], "-I", str(build.CSRC),
                        "-cubin", "-o", str(cubin), str(cu)], check=True,
                       timeout=300)
        sass = subprocess.run(
            [str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
            capture_output=True, text=True, check=True, timeout=300).stdout
        for fn in ("old_factor", "new_factor"):
            body = sass.split(f"Function : {fn}")[1].split("Function :")[0]
            ops = []
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", body):
                words = m.group(1).split()
                op = words[1] if words[0].startswith("@") else words[0]
                ops += [] if op.startswith("NOP") else [op]
            mufu = sum(op.startswith("MUFU") for op in ops)
            log(f"[sass] {fn}, exponent {label}: {len(ops)} instructions, "
                f"{mufu} MUFU")
    return 0


def plan_of(B, n, lengths, rows=ROWS, width=WIDTH, variant=None):
    """The shared-memory (or forced ``variant``'s) plan the wrappers launch
    for these shapes."""
    from repro_torch.kernels import tiling

    p = tiling.table_plan(B, n, tiling.host_lengths(lengths, B, n), rows,
                          width, tiling.sm_count(DEVICE), variant)
    return {"blocks": p.blocks, "threads": p.threads, "chunk": p.chunk,
            "one_per_stream": p.one_per_stream, "smem_bytes": p.smem_bytes}


def segment_plan_of(rows):
    """The segment sum's launch at a ``_dedup_topc`` shape of the flush."""
    from repro_torch.kernels import tiling

    return dict(tiling.segment_plan(
        rows, CANDIDATES + INSERTS + int(INSERTS * DELETE_FRACTION))._asdict(),
        threads=tiling.SEGMENT_THREADS, tile=tiling.SEGMENT_TILE)


def variants_entry(source, launches, errs, ms, plans, hot_ms=None):
    """The kernels line's per-variant record of a summing kernel: its
    launches on the main path, max error and worst error / bound against
    the plain version, time, plan and occupancy."""
    out = {}
    for v in VARIANTS:
        out[v] = {"launches": launches[v], "max_abs_err": errs[v][0],
                  "worst_err_over_bound": errs[v][1], "ms": ms[v],
                  "plan": plans.get(v, "one thread per slot"),
                  "occupancy": OCCUPANCY.get((source, v))}
        if hot_ms is not None:
            out[v]["hot_key_ms"] = hot_ms[v]
    return out


def launched(module, before):
    """The one variant of ``module``'s kernel launched since ``before`` (a
    copy of its ``variant_launches``); raises unless exactly one launch."""
    ran = {v: module.variant_launches[v] - before[v] for v in VARIANTS}
    if sorted(ran.values()) != [0, 1]:
        raise AssertionError(f"expected one launch, got {ran}")
    return max(ran, key=ran.get)


def make_stream(seed: int):
    """Per-step (B, n) keys/values of the deployment's B shards (numpy)."""
    from repro_torch.data.pipeline import TurnstileZipfStream
    import numpy as np

    stream = TurnstileZipfStream(vocab_size=VOCAB, alpha=ALPHA, seed=seed,
                                 delete_fraction=DELETE_FRACTION)
    steps = []
    for t in range(STEPS):
        batches = [stream.sparse_batch_at(t, b, INSERTS) for b in range(B)]
        steps.append((np.stack([k for k, _ in batches]),
                      np.stack([v for _, v in batches])))
    return stream, steps


def make_gradients(seed: int):
    """Gradient-like signed values of the layer's leaves (numpy): a fixed
    per-coordinate scale exp(1.5 g) per leaf, times fresh N(0, 1) noise each
    step.  Returns the leaf sizes, the per-step (L, n_max) float32 values
    (zero past each leaf's length) and their float64 sum over the steps."""
    import numpy as np

    sizes = [n for _, n in LEAVES]
    scales = [np.exp(GRAD_LOG_SCALE * np.random.default_rng(
        [seed, 0, b]).standard_normal(n, dtype=np.float32))
        for b, n in enumerate(sizes)]
    steps, total = [], np.zeros((len(sizes), max(sizes)))
    for t in range(DENSE_STEPS):
        vals = np.zeros((len(sizes), max(sizes)), np.float32)
        for b, n in enumerate(sizes):
            noise = np.random.default_rng([seed, 1 + t, b]).standard_normal(
                n, dtype=np.float32)
            np.multiply(scales[b], noise, out=vals[b, :n])
        total += vals
        steps.append(vals)
    return sizes, steps, total


def phase_parity(torch, seeds, tseeds, keys, vals, tag):
    """Each batched kernel against its plain version on the card: the
    scatter and the dense update within rtol 1e-4 / scale-aware atol and
    within each cell's rounding bound, the query bit for bit.  The scatter
    at the deployment shape in both variants, the shared-memory one by
    shape; a hot-key stream; rows 7 x width 16384 by shape global; the
    conformance grid's flushes, (trials, n / chunks) keys of its Zipf
    stream into rows 5 x width 31 k under its trial seeds, at each of its
    p and schemes."""
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ref
    from repro_torch.validate import conformance, empirics

    dev = keys.device
    results = {}
    ratios = []

    def check_scatter(name, k, v, rows, width, sd, ts, variants=(None,),
                      expect="smem", **kw):
        want = ref.countsketch_scatter_batched_ref(k, v, rows, width, sd,
                                                   transform_seeds=ts, **kw)
        tol = ref.scatter_tolerance(*ref.countsketch_scatter_mass_ref(
            k, v, rows, width, sd, transform_seeds=ts, **kw))
        out = {}
        for variant in variants:
            before = dict(s.variant_launches)
            got = s.countsketch_scatter_batched(k, v, rows, width, sd,
                                                transform_seeds=ts,
                                                _variant=variant, **kw)
            ran = launched(s, before)
            if ran != (variant or expect):
                raise AssertionError(f"scatter {name}: launched {ran}")
            err, ratio = check_sum(torch, f"scatter {name} [{ran}]", got,
                                   want, tol)
            ratios.append(ratio)
            out[ran] = (err, ratio)
        del want, tol
        return got, out

    # deployment shape: one flush of a full step, fused ppswor p=1; the
    # global variant first, so ``table`` is the shared-memory kernel's
    table, results["scatter"] = check_scatter(
        "deployment", keys, vals, ROWS, WIDTH, seeds, tseeds,
        variants=("global", None), p=P)
    hot = torch.zeros_like(keys)  # one key, n times, in every stream
    _, results["scatter_hot"] = check_scatter(
        "hot key (key 0 x n)", hot, vals, ROWS, WIDTH, seeds, tseeds,
        variants=(None, "global"), p=P)
    del hot

    g = torch.Generator(device="cpu").manual_seed(1)

    def rand_stream(b, n, hi=50_000):
        k = torch.randint(0, hi, (b, n), generator=g, dtype=torch.int32)
        v = torch.randn((b, n), generator=g)
        sd = torch.randint(0, 2**32, (b,), generator=g, dtype=torch.int64)
        ts = torch.randint(0, 2**32, (b,), generator=g, dtype=torch.int64)
        return k.to(dev), v.to(dev), sd.to(dev), ts.to(dev)

    k, v, sd, ts = rand_stream(1, 1)
    check_scatter("B=1,n=1", k, v, ROWS, WIDTH, sd, ts, p=P)
    k, v, sd, ts = rand_stream(8, 1000)
    check_scatter("W=1000", k, v, 5, 1000, sd, ts, p=P)
    check_scatter("rows 7 x W=16384 (too large for shared memory)", k, v,
                  ROWS, 16384, sd, ts, expect="global", p=P)
    kp = k.clone()
    kp[3] = -1
    got, _ = check_scatter("all-padding stream 3", kp, v, ROWS, WIDTH,
                           sd, ts, p=P)
    if got[3].any():
        raise AssertionError("all-padding stream is not exactly zero")
    lens = torch.full((8,), 1000, dtype=torch.int64, device=dev)
    lens[2], lens[5] = 0, 377
    got, _ = check_scatter("zero-length stream 2", k, v, ROWS, WIDTH,
                           sd, ts, p=P, lengths=lens)
    if got[2].any():
        raise AssertionError("zero-length stream is not exactly zero")
    check_scatter("priority", k, v, ROWS, WIDTH, sd, ts, p=P,
                  scheme="priority")
    check_scatter("p=0.5", k, v, ROWS, WIDTH, sd, ts, p=0.5)
    check_scatter("p=2", k, v, ROWS, WIDTH, sd, ts, p=2.0)
    check_scatter("p=1.5", k, v, ROWS, WIDTH, sd, ts, p=1.5)
    check_scatter("p=None", k, v, ROWS, WIDTH, sd, ts, p=None)
    cfg = conformance.ConformanceConfig(trials=VALIDATE_TRIALS)
    step, width = -(-cfg.n // cfg.chunks), 31 * cfg.k
    freqs = empirics.zipf_freqs(cfg.n, cfg.alpha, seed=cfg.seed & 0xFF)
    gk = torch.arange(step, dtype=torch.int32, device=dev).repeat(
        cfg.trials, 1)
    gv = torch.tensor(freqs[:step], device=dev).repeat(cfg.trials, 1)
    gsd, gts = empirics.derive_trial_seeds(cfg.trials, cfg.seed, device=dev)
    for scheme in conformance.SCHEMES:
        for gp in conformance.PS:
            check_scatter(f"grid {scheme} p={gp:g} ({cfg.trials}, {step}) "
                          f"rows {cfg.rows} x W={width}", gk, gv, cfg.rows,
                          width, gsd, gts, p=gp, scheme=scheme)
    results["scatter_ratio"] = max(ratios)
    results["scatter_err"] = {v: results["scatter"][v][0] for v in VARIANTS}

    def check_query(name, tables, qk, sd):
        check_bitwise(torch, f"query {name}",
                      q.countsketch_query_batched(tables, qk, sd),
                      ref.countsketch_query_batched_ref(tables, qk, sd))

    qkeys = torch.cat([torch.full((B, CANDIDATES), -1, dtype=torch.int32,
                                  device=dev), keys], 1).contiguous()
    check_query("deployment (candidates + batch)", table, qkeys, seeds)
    tables = torch.randn((8, 5, 1000), generator=g).to(dev)
    check_query("W=1000,k=1", tables, k[:, :1].contiguous(), sd)
    check_query("B=1", tables[:1].contiguous(), k[:1].contiguous(), sd[:1])

    # the estimate kernel: the flush shape, special values at every row
    # count it serves and at 17 rows (the row read and the plain median)
    check_estimate(torch, "flush shape (candidates + batch)", table, qkeys,
                   seeds)
    for rows in (1, 2, 3, 4, 5, 6, 7, 8, 16, 17):
        check_estimate(torch, f"rows={rows} W=1000 k=1000, NaN/+-inf/+-0/"
                       f"+-3e38/ties", special_tables(torch, g, 8, rows,
                                                      1000).to(dev), k, sd)

    # the dense update kernel at its edge shapes (its deployment shape is
    # checked in the dense phase)
    uratios = []

    def check_update(name, vv, rows, width, sd, ts, **kw):
        got = u.countsketch_update_batched(vv, rows, width, sd,
                                           transform_seeds=ts, **kw)
        want = ref.countsketch_update_batched_ref(vv, rows, width, sd,
                                                  transform_seeds=ts, **kw)
        tol = ref.scatter_tolerance(*ref.countsketch_update_mass_ref(
            vv, rows, width, sd, transform_seeds=ts, **kw))
        uratios.append(check_sum(torch, f"update {name}", got, want,
                                 tol)[1])
        return got

    _, v, sd, ts = rand_stream(1, 1)
    check_update("B=1,n=1", v, ROWS, WIDTH, sd, ts, p=P)
    _, v, sd, ts = rand_stream(8, 1000)
    check_update("W=1000", v, 5, 1000, sd, ts, p=P)
    got = check_update("zero-length stream 2", v, ROWS, WIDTH, sd, ts, p=P,
                       lengths=lens)
    if got[2].any():
        raise AssertionError("zero-length stream is not exactly zero")
    past = torch.tensor([1000, 1001, 5000, 2**31 - 1, 0, 1, 999, 4096],
                        device=dev)
    check_update("lengths > n", v, ROWS, WIDTH, sd, ts, p=P, lengths=past)
    # keys wrap past 2**31 and 2**32; stream 1 sketches key 0xFFFFFFFF
    wrap = torch.tensor([2**31 - 500, 2**32 - 5, 2**32 - 1, 0, 7, 2**31,
                         2**32 - 1000, 123], device=dev)
    check_update("base keys near 2**31 and 2**32-5", v, ROWS, WIDTH, sd, ts,
                 p=P, base_keys=wrap)
    check_update("priority", v, ROWS, WIDTH, sd, ts, p=P, scheme="priority")
    check_update("p=0.5", v, ROWS, WIDTH, sd, ts, p=0.5)
    check_update("p=2", v, ROWS, WIDTH, sd, ts, p=2.0)
    check_update("p=None", v, ROWS, WIDTH, sd, ts, p=None)
    # several chunks a stream, ragged lengths, keys wrapping through
    # 0xFFFFFFFF inside a chunk, an empty stream
    _, v, sd, ts = rand_stream(4, 200_000)
    check_update("chunked, ragged, wrapping", v, ROWS, WIDTH, sd, ts, p=P,
                 lengths=torch.tensor([200_000, 77_123, 0, 150_001],
                                      device=dev),
                 base_keys=torch.tensor([0, 2**31 - 500, 5, 2**32 - 100_000],
                                        device=dev))
    results["update_edge_ratio"] = max(uratios)
    log(f"[parity] all batched kernels agree with their plain versions {tag}")
    return results, table, qkeys


def run_engine(torch, plane, steps, flush_policy, sample=True):
    from repro_torch.engine import EngineConfig, SketchEngine

    eng = SketchEngine(EngineConfig(num_streams=B, rows=ROWS, width=WIDTH,
                                    candidates=CANDIDATES, p=P),
                       plane=plane, flush=flush_policy, device=DEVICE)
    flushes = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for keys, vals in steps:
        eng.ingest(keys, vals)
        flushes += eng.pending == 0
    eng.flush()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if not sample:
        return eng, None, flushes, ingest_s, None
    t0 = time.perf_counter()
    samp = eng.sample(K)
    torch.cuda.synchronize()
    return eng, samp, flushes, ingest_s, time.perf_counter() - t0


def compare_tables(torch, what, got, want, tol):
    """The kernel path's tables against the plain path's, within both
    bounds; returns the streams whose plain tables hold non-finite cells
    (the reference's uniform01 == 1.0 edge)."""
    atol = scale_atol(want)
    close = torch.allclose(got, want, rtol=RTOL, atol=atol, equal_nan=True)
    cells, t_err, t_ratio = cell_check(torch, got, want, tol)
    bad_streams = (~want.isfinite()).flatten(1).any(1)
    log(f"[main] {what} tables: max_abs_err {t_err:.3e}; allclose "
        f"rtol {RTOL} atol {atol:.3e}: {'ok' if close else 'FAIL'}; "
        f"per-cell bound worst err/bound {t_ratio:.3e}: "
        f"{'ok' if cells else 'FAIL'}; streams with non-finite cells (the "
        f"reference's uniform01 == 1.0 edge): {int(bad_streams.sum())}")
    if not (close and cells):
        raise AssertionError(f"{what} tables disagree")
    return bad_streams


def compare_samples(torch, what, samp, dst, tol, seeds, k, p, bad_streams,
                    excused=None, excuse=""):
    """The kernel path's sample keys against the plain state read through
    the plain estimate (``worp.onepass_sample``).  A stream's key set may
    differ only where the k-th and (k+1)-st |estimate| differ by less than
    the sum of their error bounds (a key's bound is the largest bound of the
    cells its rows read), or where the plain table is not finite, or where
    ``excused`` (a (B,) mask, for the reason ``excuse``) holds."""
    from repro_torch.core import countsketch, worp
    from repro_torch.kernels import ref

    dsamp = worp.onepass_sample(dst, k, p)
    cand = dst.cand_keys
    mag = torch.where(cand == -1, float("-inf"),
                      countsketch.estimate(dst.sketch, cand).abs())
    top_mag, top_i = worp.top_k(mag, k + 1)
    key_err = ref.countsketch_query_batched_ref(tol, cand, seeds).abs()
    pair_err = torch.gather(key_err.amax(1), 1, top_i[:, k - 1:k + 1])
    near_tie = (top_mag[:, k - 1] - top_mag[:, k]) <= pair_err.sum(1)
    same = (torch.sort(samp.keys, 1).values
            == torch.sort(dsamp.keys, 1).values).all(1)
    if excused is None:
        excused = torch.zeros_like(same)
    mismatch = int((~same & ~(near_tie | bad_streams | excused)).sum())
    n = samp.keys.shape[0]
    log(f"[main] {what} sample key sets: {int(same.sum())}/{n} identical, "
        f"{int(near_tie.sum())} near-tie streams, {int((~same).sum())} "
        f"differ"
        + (f", {int((~same & excused & ~near_tie).sum())} of them outside "
           f"near ties excused ({excuse})" if excuse else "")
        + f", {mismatch} differ outside near ties / non-finite streams")
    if mismatch:
        raise AssertionError(f"{what} sample key sets differ from the plain "
                             f"path's")
    if not bool(samp.freqs[~bad_streams].isfinite().all()):
        raise AssertionError(f"{what}: non-finite sample frequencies")


def trace_report(prof, ranges, wall_ms, what, tag, top: int = 12):
    """Print the named ranges (host time, and the device time of every
    activity launched inside them, the kernels launched through ctypes
    included: ``perfbench.chrometrace`` over the exported trace), device
    time by kernel, and the device's busy share over ``wall_ms`` of a
    ``torch.profiler`` trace.  Returns the device items, (ms, count, name),
    largest first."""
    import tempfile

    from torch.autograd import DeviceType

    from perfbench.chrometrace import Trace

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        tr = Trace.load(path)
    # device-side activities only (kernels, copies, memsets): the host ops
    # that launched them carry the same device time a second time, and the
    # device-side copies of the named ranges span their kernels
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if (e.key not in tr.ranges and dev_us > 0
                and e.device_type != DeviceType.CPU):
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    for name in ranges:
        got = tr.range_device(name)
        if got is None:
            log(f"[profile] stage {name}: not in the trace")
            continue
        n, seconds, _ = got
        host = sum(s.end - s.start for s in tr.spans(name)) * 1e-3
        log(f"[profile] stage {name} x{n}: host {host / n:.3f} ms, device "
            f"{seconds * 1e3 / n:.3f} ms per call, every activity launched "
            f"inside it (traced run) {tag}")
    # the profiler's own buffer requests are not the program's work
    busy = sum(r[0] for r in rows if "Activity Buffer" not in r[2])
    if not rows:
        log(f"[profile] the profiler saw no device time: not measured {tag}")
        return rows
    log(f"[profile] {what}: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f} %), idle "
        f"{100 * (1 - busy / wall_ms):.1f} % (traced run) {tag}")
    for ms, count, key in rows[:top]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return rows


def profile_window(torch, steps, tag):
    """torch.profiler over two flushes and one sample of a fresh sparse
    engine."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import EngineConfig, SketchEngine

    eng = SketchEngine(EngineConfig(num_streams=B, rows=ROWS, width=WIDTH,
                                    candidates=CANDIDATES, p=P),
                       flush_elems=4096, device=DEVICE)
    eng.ingest(*steps[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.ingest(*steps[1])
        eng.ingest(*steps[2])
        eng.sample(K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check_no_row_sort(trace_report(prof, RANGES, wall_ms,
                                   "2 flushes + sample", tag),
                      "sparse plane, 2 flushes + sample")


def phase_sparse(torch, args, seeds, tseeds, tag):
    """Phases 2-4: batched kernel parity, the sparse plane against the dense
    plane, and the sparse path's times.  Returns the kernels-line entries of
    the scatter and the batched query."""
    import numpy as np

    from repro_torch.core import transforms
    from repro_torch.engine import FlushPolicy
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import ref

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    stream, steps = make_stream(args.seed)
    events = sum(k.size for k, _ in steps)
    log(f"[stream] generated {STEPS} steps x {B} streams = {events} signed "
        f"events on the host in {time.perf_counter() - t0:.2f} s (kept out "
        f"of the ingest rate)")

    # -- phase 2: kernel parity -----------------------------------------
    t_phase = time.perf_counter()
    keys1 = torch.from_numpy(steps[1][0]).to(dev)
    vals1 = torch.from_numpy(steps[1][1]).to(dev)
    errs, table, qkeys = phase_parity(torch, seeds, tseeds, keys1, vals1, tag)
    log(f"[phase] 2 kernel parity: {time.perf_counter() - t_phase:.2f} s "
        f"wall")

    # -- phase 3: the sparse plane (kernels) and the dense plane (plain) --
    t_phase = time.perf_counter()
    policy = FlushPolicy(max_elems=4096)
    s.launches = q.launches = q.estimate_launches = 0
    s.variant_launches.update(dict.fromkeys(VARIANTS, 0))
    torch.cuda.reset_peak_memory_stats()
    eng, samp, flushes, ingest_s, sample_s = run_engine(torch, "sparse",
                                                        steps, policy)
    scatter_launches, estimate_launches = s.launches, q.estimate_launches
    scatter_variants = dict(s.variant_launches)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    log(f"[main] sparse plane: {flushes} flushes, scatter launches "
        f"{scatter_launches} ({scatter_variants}), estimate launches "
        f"{estimate_launches}, row-read launches {q.launches}")
    if scatter_launches != flushes or flushes == 0:
        raise AssertionError("scatter launches do not match the flushes")
    if scatter_variants["smem"] != flushes:
        raise AssertionError("the sparse plane did not run the shared-memory "
                             "scatter")
    if estimate_launches < flushes + 1:
        raise AssertionError("estimate launches < flushes + 1")
    if q.launches:
        raise AssertionError("the sparse path launched the row-read kernel")
    st = eng.state
    if tuple(samp.keys.shape) != (B, K) or samp.keys.dtype != torch.int32:
        raise AssertionError(f"sample keys shape {tuple(samp.keys.shape)}")

    dense, _, dflushes, dense_s, _ = run_engine(torch, "dense", steps,
                                                policy, sample=False)
    dst = dense.state
    # each cell's rounding bound over all steps: any summation order of its
    # terms, the sparse plane's per-flush deltas included
    cnt = torch.zeros_like(dst.sketch.table)
    mass = torch.zeros_like(dst.sketch.table)
    for keys, vals in steps:
        c, m = ref.countsketch_scatter_mass_ref(
            torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev),
            ROWS, WIDTH, seeds, p=P, transform_seeds=tseeds)
        cnt += c
        mass += m
    tol = ref.scatter_tolerance(cnt, mass)
    del cnt, mass, c, m
    bad_streams = compare_tables(torch, "sparse vs dense plane",
                                 st.sketch.table, dst.sketch.table, tol)
    compare_samples(torch, "sparse vs dense plane", samp, dst, tol, seeds, K,
                    P, bad_streams)
    del tol

    recalls = []
    for b in range(8):
        f = stream.aggregate_freqs(b, STEPS, INSERTS)
        nz = np.nonzero(f)[0]
        tstar = transforms.transform_frequencies(
            torch.from_numpy(nz.astype(np.int32)),
            torch.from_numpy(f[nz].astype(np.float32)), P,
            int(tseeds[b]))
        exact = set(nz[torch.argsort(tstar.abs(), descending=True,
                                     stable=True)[:K].numpy()].tolist())
        recalls.append(len(exact & set(samp.keys[b].tolist())) / K)
    log(f"[main] recall of the exact bottom-{K} on streams 0-7: "
        + " ".join(f"{r:.3f}" for r in recalls))
    if min(recalls) < 0.5:
        raise AssertionError("sample recall below 0.5")
    del dense, dst
    profile_window(torch, steps, tag)
    log(f"[phase] 3 sparse plane: {time.perf_counter() - t_phase:.2f} s wall")

    # -- phase 4: times --------------------------------------------------
    t_phase = time.perf_counter()
    log(f"[time] sparse plane: {events} events ingested in {ingest_s:.4f} s "
        f"= {events / ingest_s:.4e} events/s; sample(k={K}) {sample_s * 1e3:.3f}"
        f" ms (first call); dense plane {dense_s:.4f} s = "
        f"{events / dense_s:.4e} events/s; peak memory {peak_mb:.1f} MB "
        f"{tag}")
    sample_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.sample(K)
        torch.cuda.synchronize()
        sample_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[time] sample(k={K}) latency, 5 calls: "
        + " ".join(f"{x:.3f}" for x in sample_ms) + f" ms {tag}")
    del eng, st, samp

    n1 = keys1.shape[1]
    hot = torch.zeros_like(keys1)
    s_var, s_hot = {}, {}
    for variant in VARIANTS:
        s_var[variant] = cuda_ms(torch, lambda: s.countsketch_scatter_batched(
            keys1, vals1, ROWS, WIDTH, seeds, p=P, transform_seeds=tseeds,
            _variant=variant), 20)
        s_hot[variant] = cuda_ms(torch, lambda: s.countsketch_scatter_batched(
            hot, vals1, ROWS, WIDTH, seeds, p=P, transform_seeds=tseeds,
            _variant=variant), 20)
    del hot
    scatter_plain = lambda: ref.countsketch_scatter_batched_ref(  # noqa: E731
        keys1, vals1, ROWS, WIDTH, seeds, p=P, transform_seeds=tseeds)
    # library yardstick, memory half only: precomputed flat indices and
    # signed transformed values into a zeroed table with index_add_
    tv = transforms.transform_values(keys1, vals1, P, tseeds[:, None])
    idx, sign = row_index(torch, keys1, seeds, WIDTH)
    idx = idx.reshape(-1)
    sv = (sign * tv.repeat(1, ROWS)).reshape(-1)
    flat = torch.zeros(B * ROWS * WIDTH, device=dev)
    scatter_lib = lambda: flat.zero_().index_add_(0, idx, sv)  # noqa: E731
    s_ms = s_var["smem"]
    s_plain = cuda_ms(torch, scatter_plain, 3, warmup=1)
    s_lib = cuda_ms(torch, scatter_lib, 20)
    del idx, sign, sv, flat, tv

    est_t = time_estimate(torch, "flush shape", table, qkeys, seeds, 20, 3,
                          tag)

    # bounds from this run's inputs: each input read once, each output
    # written once; integer work for the slots/keys this data makes live
    live = int((keys1 != -1).sum())
    s_bytes = keys1.numel() * 8 + B * ROWS * WIDTH * 4
    s_ops = live * SCATTER_OPS_PER_SLOT
    s_bound, s_by = bound(s_bytes, s_ops)
    log(f"[time] scatter (B={B}, n={n1}): kernel {s_ms:.4f} ms (shared "
        f"memory; global atomics {s_var['global']:.4f} ms), plain "
        f"{s_plain:.4f} ms, index_add_ yardstick (memory half only) "
        f"{s_lib:.4f} ms, bound {s_bound:.4f} ms by {s_by} "
        f"({s_bytes / 1e6:.1f} MB, {s_ops / 1e9:.2f} G int ops), "
        f"{100 * s_bound / s_ms:.1f} % of bound {tag}")
    log(f"[time] scatter hot key (key 0 x {n1} in each of {B} streams): "
        f"shared memory {s_hot['smem']:.4f} ms, global atomics "
        f"{s_hot['global']:.4f} ms; the hot key costs "
        f"{s_hot['smem'] - s_ms:+.4f} ms on the shared-memory kernel {tag}")
    log(f"[phase] 4 sparse times: {time.perf_counter() - t_phase:.2f} s wall")
    plan = plan_of(B, n1, None)
    return (stream, steps), [
        {"name": "countsketch_scatter_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_scatter.cu",
         "replaces": "src/repro/kernels/countsketch_scatter.py:112",
         "launches": scatter_launches,
         "max_abs_err": errs["scatter_err"]["smem"],
         "parity": f"allclose rtol {RTOL} atol 1e-5*max(1,max|want|) and "
                   f"per-cell eps32*(m+{ref.TRANSFORM_ULPS})*sum|term|",
         "worst_err_over_bound": errs["scatter_ratio"],
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": s_lib, "variant": "smem",
         "variants": variants_entry(
             "countsketch_scatter", scatter_variants, errs["scatter"],
             s_var, {"smem": plan}, hot_ms=s_hot)},
        {"name": "countsketch_estimate_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_query.cu",
         "replaces": "src/repro/kernels/countsketch_query.py:150",
         "launches": estimate_launches,  # the dense path's are added
         "max_abs_err": 0.0,
         "parity": "equal under == (NaN equal to NaN) to countsketch.median "
                   "of the plain reads",
         "ms": est_t["estimate"], "plain_ms": est_t["plain"],
         "bound_ms": est_t["bound"], "bound_by": est_t["bound_by"],
         "library_ms": est_t["library"],
         "row_read_median_ms": est_t["row_read_median"],
         "row_read_ms": est_t["row_read"],
         "occupancy": OCCUPANCY.get(("countsketch_query", "estimate"))},
    ], errs


def profile_dense(torch, cfg, values, sizes, tag):
    """torch.profiler over one update_dense of a fresh engine: the split of
    its ranges ``dense.sketch`` and ``dense.refresh``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import SketchEngine

    eng = SketchEngine(cfg, device=DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.update_dense(values, lengths=sizes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check_no_row_sort(trace_report(prof, DENSE_RANGES, wall_ms,
                                   "1 update_dense", tag, top=8),
                      "dense segments, 1 update_dense")


def phase_dense(torch, args, tag):
    """Phase 5: SketchEngine.update_dense on one gemma2_2b layer's gradient
    streams (kernels) against the plain path, its times and a trace.
    Returns the kernels-line entry of the dense update and the wg leaf's
    first-step values (for the single-stream phase)."""
    import functools

    import numpy as np

    from repro_torch.core import transforms, worp
    from repro_torch.engine import (EngineConfig, SketchEngine,
                                    derive_stream_seeds, onepass_init_batched)
    from repro_torch.engine.engine import _map, _map2
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ref

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    sizes, steps, total = make_gradients(args.seed)
    L, n_max, live = len(sizes), max(sizes), sum(sizes)
    log(f"[dense] one gemma2_2b layer: {L} gradient streams ("
        + ", ".join(f"{name} {n}" for name, n in LEAVES) + f"), n_max "
        f"{n_max}, {live} live elements a step; {DENSE_STEPS} steps "
        f"generated on the host in {time.perf_counter() - t_phase:.2f} s "
        f"(kept out of the update rate)")
    cfg = EngineConfig(num_streams=L)
    seeds, tseeds = derive_stream_seeds(cfg, device=dev)
    lengths = torch.tensor(sizes, device=dev)

    # the kernel against its plain version at the deployment shape, both
    # variants, the shared-memory one by shape
    v0 = torch.from_numpy(steps[0]).to(dev)
    kw = dict(p=cfg.p, transform_seeds=tseeds, lengths=lengths)
    want = ref.countsketch_update_batched_ref(v0, cfg.rows, cfg.width, seeds,
                                              **kw)
    tol = ref.scatter_tolerance(*ref.countsketch_update_mass_ref(
        v0, cfg.rows, cfg.width, seeds, **kw))
    u_errs = {}
    for variant in (None, "global"):
        before = dict(u.variant_launches)
        got = u.countsketch_update_batched(v0, cfg.rows, cfg.width, seeds,
                                           _variant=variant, **kw)
        ran = launched(u, before)
        if ran != (variant or "smem"):
            raise AssertionError(f"update gemma2_2b layer: launched {ran}")
        u_errs[ran] = check_sum(torch, f"update gemma2_2b layer (step 0) "
                                f"[{ran}]", got, want, tol)
        del got
    del want, tol
    u_err, u_ratio = u_errs["smem"]

    # peak of one update_dense, reckoned from its shapes: the (L, n_max)
    # values and int32 keys, and the (L, n_max + C) arrays live together in
    # the candidate refresh's last sort (worp._dedup_topc's top_k): the
    # query keys, the estimate and 10 more of 4 bytes, 3 of 8 (the argsort
    # order, the segment ids, the sort's indices) and 2 boolean masks.  The
    # estimate kernel writes one float a key, so the (L, rows, n_max + C)
    # reads and their sort (16 bytes a read) are gone.
    nq = L * (n_max + cfg.candidates)
    reckoned = L * n_max * 4 * 2 + nq * (12 * 4 + 3 * 8 + 2)
    log(f"[dense] reckoned peak of one update_dense: {reckoned / 1e9:.2f} GB "
        f"(values and keys {L * n_max * 8 / 1e9:.2f} GB, the refresh's "
        f"arrays {nq * 74 / 1e9:.2f} GB; the sorts' own buffers are not "
        f"counted)")

    # -- the main path: update_dense x DENSE_STEPS, then sample ----------
    del v0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    u.launches = q.launches = q.estimate_launches = 0
    u.variant_launches.update(dict.fromkeys(VARIANTS, 0))
    eng = SketchEngine(cfg, device=DEVICE)
    update_s = []
    for vals in steps:
        dv = torch.from_numpy(vals).to(dev)  # the gradients live on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.update_dense(dv, lengths=sizes)
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t0)
        del dv
    t0 = time.perf_counter()
    samp = eng.sample(DENSE_K)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    update_launches, estimate_launches = u.launches, q.estimate_launches
    update_variants = dict(u.variant_launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] dense segments: {DENSE_STEPS} update_dense calls, update "
        f"launches {update_launches} ({update_variants}), estimate launches "
        f"{estimate_launches}, row-read launches {q.launches}")
    if update_launches != DENSE_STEPS:
        raise AssertionError("update launches do not match update_dense calls")
    if update_variants["smem"] != DENSE_STEPS:
        raise AssertionError("update_dense did not run the shared-memory "
                             "update")
    if estimate_launches < DENSE_STEPS + 1:
        raise AssertionError("estimate launches < update_dense calls + 1")
    if q.launches:
        raise AssertionError("the dense path launched the row-read kernel")
    if tuple(samp.keys.shape) != (L, DENSE_K) \
            or samp.keys.dtype != torch.int32:
        raise AssertionError(f"sample keys shape {tuple(samp.keys.shape)}")
    rate = DENSE_STEPS * live / sum(update_s)
    log(f"[time] update_dense: {DENSE_STEPS} x {live} live elements in "
        f"{sum(update_s):.4f} s = {rate:.4e} elements/s (per call "
        + " ".join(f"{x * 1e3:.1f}" for x in update_s) + f" ms); peak "
        f"memory {peak / 1e6:.1f} MB (reckoned {reckoned / 1e6:.1f} MB) "
        f"{tag}")
    sample_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.sample(DENSE_K)
        torch.cuda.synchronize()
        sample_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[time] dense sample(k={DENSE_K}) latency: first {first_ms:.3f} ms, "
        f"5 calls " + " ".join(f"{x:.3f}" for x in sample_ms) + f" ms {tag}")
    st = eng.state
    del eng
    torch.cuda.empty_cache()

    # -- the plain path: worp.onepass_update stream by stream, keys base + i
    # (-1 past the length), same seeds and order -------------------------
    t0 = time.perf_counter()
    st0 = onepass_init_batched(cfg, device=dev)
    offs = torch.arange(n_max, device=dev)
    parts = []
    for b in range(L):
        sb = _map(lambda x: x[b:b + 1], st0)
        keys = torch.where(offs < sizes[b], offs, -1).to(torch.int32)[None]
        for vals in steps:
            sb = worp.onepass_update(
                sb, keys, torch.from_numpy(vals[b:b + 1]).to(dev), cfg.p,
                cfg.scheme)
        parts.append(sb)
    dst = functools.reduce(
        lambda a, c: _map2(lambda x, y: torch.cat([x, y]), a, c), parts)
    del parts, sb, keys
    torch.cuda.synchronize()
    log(f"[dense] plain path (worp.onepass_update, stream by stream): "
        f"{time.perf_counter() - t0:.2f} s")
    cnt = torch.zeros_like(dst.sketch.table)
    mass = torch.zeros_like(dst.sketch.table)
    for vals in steps:
        c, m = ref.countsketch_update_mass_ref(
            torch.from_numpy(vals).to(dev), cfg.rows, cfg.width, seeds, **kw)
        cnt += c
        mass += m
    tol = ref.scatter_tolerance(cnt, mass)
    del cnt, mass, c, m
    bad = compare_tables(torch, "dense segments, kernels vs plain",
                         st.sketch.table, dst.sketch.table, tol)
    compare_samples(torch, "dense segments, kernels vs plain", samp, dst,
                    tol, seeds, DENSE_K, cfg.p, bad)
    del tol, dst

    recalls = []
    for b, n in enumerate(sizes):
        keys = torch.arange(n, dtype=torch.int32, device=dev)
        f = torch.from_numpy(total[b, :n].astype(np.float32)).to(dev)
        tstar = transforms.transform_frequencies(keys, f, cfg.p,
                                                 int(tseeds[b]))
        exact = keys[torch.argsort(tstar.abs(), descending=True,
                                   stable=True)[:DENSE_K]]
        recalls.append(len(set(exact.tolist())
                           & set(samp.keys[b].tolist())) / DENSE_K)
    del keys, f, tstar
    log(f"[main] recall of the exact bottom-{DENSE_K} per stream ("
        + ", ".join(f"{name} {r:.3f}{' (non-finite)' if bool(bad[b]) else ''}"
                    for b, ((name, _), r) in enumerate(zip(LEAVES, recalls)))
        + ")")
    if min(r for b, r in enumerate(recalls) if not bool(bad[b])) < 0.5:
        raise AssertionError("dense sample recall below 0.5 on a finite "
                             "stream")
    profile_dense(torch, cfg, torch.from_numpy(steps[0]).to(dev), sizes, tag)

    # -- the estimate at the refresh's shape: the final tables, the
    # candidates and the segment keys (-1 past each length) ---------------
    offs = torch.arange(n_max, device=dev)
    qkeys = torch.cat([st.cand_keys, torch.where(
        offs < lengths[:, None], offs, -1).to(torch.int32)], 1).contiguous()
    del offs
    check_estimate(torch, "dense refresh shape", st.sketch.table, qkeys,
                   st.sketch.seed)
    torch.cuda.empty_cache()
    est_t = time_estimate(torch, "dense refresh shape", st.sketch.table,
                          qkeys, st.sketch.seed, 5, 1, tag)
    del qkeys
    torch.cuda.empty_cache()

    # -- times of the kernel at the deployment shape -----------------------
    v0 = torch.from_numpy(steps[0]).to(dev)
    u_var = {variant: cuda_ms(torch, lambda: u.countsketch_update_batched(
        v0, cfg.rows, cfg.width, seeds, _variant=variant, **kw), 10)
        for variant in VARIANTS}
    u_ms = u_var["smem"]
    update_plain = lambda: ref.countsketch_update_batched_ref(  # noqa: E731
        v0, cfg.rows, cfg.width, seeds, **kw)
    u_plain = cuda_ms(torch, update_plain, 2, warmup=1)
    # library yardstick, memory half only: index_add_ of the signed,
    # transformed live values at precomputed flat buckets
    idx, sv = [], []
    for b, n in enumerate(sizes):
        keys = torch.arange(n, device=dev)[None]
        tv = transforms.transform_values(keys, v0[b:b + 1, :n], cfg.p,
                                         tseeds[b:b + 1, None])
        i, sg = row_index(torch, keys, seeds[b:b + 1], cfg.width, cfg.rows)
        idx.append(i.reshape(-1) + b * cfg.rows * cfg.width)
        sv.append((sg * tv.repeat(1, cfg.rows)).reshape(-1))
        del keys, tv, i, sg
    idx, sv = torch.cat(idx), torch.cat(sv)
    flat = torch.zeros(L * cfg.rows * cfg.width, device=dev)
    update_lib = lambda: flat.zero_().index_add_(0, idx, sv)  # noqa: E731
    u_lib = cuda_ms(torch, update_lib, 10)
    del idx, sv, flat, v0
    torch.cuda.empty_cache()
    u_bound, u_by = bound(live * 4 + L * cfg.rows * cfg.width * 4,
                          live * UPDATE_OPS_PER_SLOT)
    plan = plan_of(L, n_max, sizes)
    log(f"[time] update (L={L}, n_max={n_max}, {live} live): kernel "
        f"{u_ms:.4f} ms (shared memory, {plan['blocks']} blocks of "
        f"{plan['chunk']} slots; global atomics {u_var['global']:.4f} ms), "
        f"plain {u_plain:.4f} ms, index_add_ yardstick "
        f"(memory half only) {u_lib:.4f} ms, bound {u_bound:.4f} ms by "
        f"{u_by} ({live * 4 / 1e6:.1f} MB, "
        f"{live * UPDATE_OPS_PER_SLOT / 1e9:.2f} G int ops), "
        f"{100 * u_bound / u_ms:.1f} % of bound {tag}")
    log(f"[phase] 5 dense segments: {time.perf_counter() - t_phase:.2f} s "
        f"wall")
    wg = [name for name, _ in LEAVES].index("wg")
    entry = {
        "name": "countsketch_update_batched", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/countsketch_update.cu",
        "replaces": "src/repro/kernels/countsketch_update.py:240",
        "launches": update_launches, "max_abs_err": u_err,
        "parity": f"allclose rtol {RTOL} atol 1e-5*max(1,max|want|) and "
                  f"per-cell eps32*(m+{ref.TRANSFORM_ULPS})*sum|term|",
        "worst_err_over_bound": u_ratio,
        "ms": u_ms, "plain_ms": u_plain, "bound_ms": u_bound,
        "bound_by": u_by, "library_ms": u_lib, "variant": "smem",
        "variants": variants_entry("countsketch_update", update_variants,
                                   u_errs, u_var, {"smem": plan})}
    return entry, steps[0][wg, :sizes[wg]], estimate_launches, est_t


# the row read at the flush's shape: B streams' CANDIDATES keys against
# tables of these rows (17: past MAX_FUSED_ROWS, the estimate's fallback)
FLUSH_READ_ROWS = (ROWS, 17)


def row_read_inputs(torch, rows, seed=5):
    """(B, rows, WIDTH) N(0, 1) tables, (B, CANDIDATES) random int32 keys
    and B seeds on the card, from a seeded CPU generator."""
    g = torch.Generator().manual_seed(seed + rows)
    dev = torch.device(DEVICE)
    tables = torch.randn((B, rows, WIDTH), generator=g).to(dev)
    keys = torch.randint(-2**31, 2**31 - 1, (B, CANDIDATES), generator=g,
                         dtype=torch.int64).to(torch.int32).to(dev)
    seeds = torch.randint(0, 2**32, (B,), generator=g).to(dev)
    return tables, keys, seeds


def row_read_shape(torch, rows, tag) -> dict:
    """The batched row read at the flush's shape: bit for bit its plain
    version, one launch; its time (CUDA events, 20 calls), the plain
    version's and the gather yardstick's (precomputed indices), beside
    the bound: the keys read once, the 32-byte table sectors they touch,
    the reads written, or their hashing."""
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import ref

    tables, keys, seeds = row_read_inputs(torch, rows)
    before = q.launches
    got = q.countsketch_query_batched(tables, keys, seeds)
    if q.launches != before + 1:
        raise AssertionError(f"row read rows {rows}: did not launch")
    check_bitwise(torch, f"query_rows_batched B={B} k={CANDIDATES} rows "
                  f"{rows}", got, ref.countsketch_query_batched_ref(
                      tables, keys, seeds))
    del got
    gidx = gather_index(torch, keys, seeds, WIDTH, rows)
    flat = tables.reshape(B, -1)
    rec = {"B": B, "k": CANDIDATES, "rows": rows,
           "ms": cuda_ms(torch, lambda: q.countsketch_query_batched(
               tables, keys, seeds), 20),
           "plain_ms": cuda_ms(
               torch, lambda: ref.countsketch_query_batched_ref(
                   tables, keys, seeds), 3, warmup=1),
           "library_ms": cuda_ms(torch, lambda: torch.gather(flat, 1, gidx),
                                 20)}
    nk = keys.numel()
    rec["bound_ms"], rec["bound_by"] = bound(
        nk * 4 + table_bytes_read(torch, tables, keys, seeds) + rows * nk * 4,
        nk * query_ops(rows))
    log(f"[time] query_rows_batched (B={B}, k={CANDIDATES}, rows {rows}): "
        f"kernel {rec['ms']:.4f} ms ({100 * rec['bound_ms'] / rec['ms']:.1f} "
        f"% of bound), plain {rec['plain_ms']:.4f} ms, gather yardstick "
        f"(memory half only) {rec['library_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} (CUDA events) {tag}")
    return rec


def phase_single(torch, wg_values, tag):
    """Phase 6: the single-stream entry points (benchmarks/
    sketch_throughput.py's calls) and ``query_rows_batched`` against their
    plain versions, and times.  Returns the kernels-line entries of the
    single-segment update, the batched and single-table row reads, the
    single-table estimate and the transform."""
    from repro_torch.core import countsketch, hashing, transforms
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ppswor_transform as tr

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    vals = torch.from_numpy(wg_values).to(dev)
    n_big = vals.numel()
    keys_big = torch.arange(n_big, dtype=torch.int32, device=dev)
    qkeys = torch.arange(SINGLE_KEYS, dtype=torch.int32, device=dev)
    vals_bf16 = vals.to(torch.bfloat16)

    # -- the path: counts zeroed just before, read just after --------------
    u.single_launches = q.single_launches = tr.launches = 0
    q.launches = q.estimate_single_launches = 0
    u.variant_launches.update(dict.fromkeys(VARIANTS, 0))
    tr.variant_launches.update(dict.fromkeys(tr.VARIANTS, 0))
    tables = [ops.sketch_dense_vector(vals[:n], ROWS, WIDTH, SINGLE_SEED,
                                      p=P) for n in SINGLE_N]
    rows_out = ops.query_rows(tables[-1], qkeys, SINGLE_SEED)
    est = ops.estimate(tables[-1], qkeys, SINGLE_SEED)
    both = torch.stack(tables)
    both_keys = qkeys.expand(len(SINGLE_N), -1).contiguous()
    both_seeds = torch.full((len(SINGLE_N),), SINGLE_SEED, device=dev)
    rows_both = ops.query_rows_batched(both, both_keys, both_seeds)
    t32 = ops.transform(keys_big, vals, P, 0)
    t16 = ops.transform(keys_big, vals_bf16, P, 0)
    torch.cuda.synchronize()
    launches = {"update": u.single_launches, "query": q.single_launches,
                "estimate": q.estimate_single_launches,
                "query_batched": q.launches, "transform": tr.launches}
    single_variants = dict(u.variant_launches)
    transform_variants = dict(tr.variant_launches)
    log(f"[main] single-stream entry points: sketch_dense_vector launches "
        f"{launches['update']} ({single_variants}), row-read launches "
        f"{launches['query']} (one table) and {launches['query_batched']} "
        f"(query_rows_batched), estimate launches {launches['estimate']}, "
        f"transform launches {launches['transform']} ({transform_variants})")
    if launches != {"update": len(SINGLE_N), "query": 1, "estimate": 1,
                    "query_batched": 1, "transform": 2}:
        raise AssertionError("single-stream launches do not match the calls")
    if single_variants["smem"] != len(SINGLE_N):
        raise AssertionError("sketch_dense_vector did not run the "
                             "shared-memory update")
    if transform_variants["vector"] != 2:
        raise AssertionError("the aligned transforms did not run the vector "
                             "variant")

    # -- parity against the plain versions ---------------------------------
    u_err, single_errs = 0.0, {}
    for n, table in zip(SINGLE_N, tables):
        want = ref.countsketch_update_ref(vals[:n], 0, ROWS, WIDTH,
                                          SINGLE_SEED, p=P)
        tol = ref.scatter_tolerance(*ref.countsketch_update_mass_ref(
            vals[None, :n], ROWS, WIDTH, SINGLE_SEED, p=P))[0]
        single_errs["smem"] = check_sum(
            torch, f"sketch_dense_vector n={n} [smem]", table, want, tol)
        u_err = max(u_err, single_errs["smem"][0])
    # the global variant of #4 at n = 21.2 M, against the same plain table
    before = dict(u.variant_launches)
    got = u.countsketch_update(vals, ROWS, WIDTH, SINGLE_SEED, p=P,
                               _variant="global")
    if launched(u, before) != "global":
        raise AssertionError("the forced global update did not launch")
    single_errs["global"] = check_sum(torch, f"sketch_dense_vector n={n} "
                                      f"[global]", got, want, tol)
    del got
    check_bitwise(torch, f"query_rows k={SINGLE_KEYS}", rows_out,
                  ref.countsketch_query_ref(tables[-1], qkeys, SINGLE_SEED))
    check_bitwise(torch, f"estimate k={SINGLE_KEYS}", est,
                  ref.countsketch_estimate_ref(tables[-1], qkeys,
                                               SINGLE_SEED))
    check_bitwise(torch, f"query_rows_batched B={len(SINGLE_N)} "
                  f"k={SINGLE_KEYS}", rows_both,
                  ref.countsketch_query_batched_ref(both, both_keys,
                                                    both_seeds))
    del rows_both

    t_err = {"float32": 0.0, "bfloat16": 0.0}

    def check_transform(name, got, keys, v, p):
        """The transform against its plain version: allclose at the
        tolerances of tests/test_kernels.py, and the same infinities, with
        their signs, where the plain version has them."""
        rtol, atol = (1e-5, 1e-6) if v.dtype == torch.float32 \
            else (2e-2, 1e-2)
        want = ref.ppswor_transform_ref(keys, v, p, 0)
        torch.cuda.synchronize()
        g32, w32 = got.float(), want.float()
        fin = w32.isfinite()
        same_nonfinite = bool(((g32 == w32) | (g32.isnan() & w32.isnan()))[
            ~fin].all())
        ok = got.dtype == want.dtype and same_nonfinite and torch.allclose(
            g32, w32, rtol=rtol, atol=atol, equal_nan=True)
        err = float((g32 - w32)[fin].abs().max()) if fin.any() else 0.0
        dt = "float32" if v.dtype == torch.float32 else "bfloat16"
        t_err[dt] = max(t_err[dt], err)
        log(f"[parity] transform {name} {dt} p={p} n={v.numel()}: "
            f"max_abs_err {err:.3e}; allclose rtol {rtol} atol {atol} and "
            f"the same +-inf: {'ok' if ok else 'FAIL'}; nonfinite "
            f"{int((~fin).sum())} ("
            + ", ".join(f"{x:g}" for x in w32[~fin][:4].tolist()) + ")")
        if not ok:
            raise AssertionError(f"transform {name} {dt} p={p}: the kernel "
                                 f"disagrees with its plain version")

    edge = int(ref.ppswor_transform_ref(
        torch.tensor([EDGE_KEY], dtype=torch.int32, device=dev),
        torch.ones(1, device=dev), 1.0, 0).isinf().all())
    log(f"[parity] transform: key {EDGE_KEY} hits the uniform01 == 1.0 "
        f"edge under seed 0: {bool(edge)}; it is among the n={n_big} keys: "
        f"{EDGE_KEY < n_big}")
    check_transform("path", t32, keys_big, vals, P)
    check_transform("path", t16, keys_big, vals_bf16, P)
    path_err = dict(t_err)
    del t32, t16
    for v in (vals, vals_bf16):
        # the tensors (vector), views that start 4 (or 2) bytes in (scalar,
        # by alignment; n - 1 is not a multiple of the vector width), and a
        # prefix n - 3 long (the vector loop's tail)
        for variant, what, cut, ps in (
                ("vector", "", slice(None), TRANSFORM_PS),
                ("scalar", " view [1:]", slice(1, None), TRANSFORM_PS),
                ("vector", f" prefix [:{n_big - 3}]", slice(n_big - 3),
                 (P,))):
            for p in ps:
                before = dict(tr.variant_launches)
                got = ops.transform(keys_big[cut], v[cut], p, 0)
                if tr.variant_launches[variant] != before[variant] + 1:
                    raise AssertionError(f"transform: {variant} did not "
                                         f"launch")
                check_transform(variant + what, got, keys_big[cut], v[cut],
                                p)
                del got
    del rows_out, est

    # -- times -------------------------------------------------------------
    table = tables[-1]
    single_ms = {variant: cuda_ms(torch, lambda: u.countsketch_update(
        vals, ROWS, WIDTH, SINGLE_SEED, p=P, _variant=variant), 20)
        for variant in VARIANTS}
    upd_plain = lambda: ref.countsketch_update_ref(  # noqa: E731
        vals, 0, ROWS, WIDTH, SINGLE_SEED, p=P)
    tv = transforms.transform_values(keys_big, vals, P, 0)
    sd = torch.tensor([SINGLE_SEED], device=dev)
    idx, sign = row_index(torch, keys_big[None], sd, WIDTH)
    idx, sv = idx.reshape(-1), (sign * tv.repeat(1, ROWS)).reshape(-1)
    flat = torch.zeros(ROWS * WIDTH, device=dev)
    upd_lib = lambda: flat.zero_().index_add_(0, idx, sv)  # noqa: E731
    s_ms = single_ms["smem"]
    s_plain = cuda_ms(torch, upd_plain, 3, warmup=1)
    s_lib = cuda_ms(torch, upd_lib, 20)
    del tv, idx, sign, sv, flat
    s_bound, s_by = bound(n_big * 4 + ROWS * WIDTH * 4,
                          n_big * UPDATE_OPS_PER_SLOT)

    qry = lambda: ops.query_rows(table, qkeys, SINGLE_SEED)  # noqa: E731
    qry_plain = lambda: ref.countsketch_query_ref(  # noqa: E731
        table, qkeys, SINGLE_SEED)
    gidx = gather_index(torch, qkeys[None], sd, WIDTH).reshape(-1)
    flat_table = table.reshape(-1)
    qry_lib = lambda: torch.gather(flat_table, 0, gidx)  # noqa: E731
    # one call keeps the card busy for microseconds, so CUDA events over
    # back-to-back calls time the host; the device time comes from a trace
    q_call = (cuda_ms(torch, qry, 200, warmup=5),
              cuda_ms(torch, qry_plain, 50, warmup=5),
              cuda_ms(torch, qry_lib, 200, warmup=5))
    q_ms, q_plain, q_lib = (device_ms(torch, f, 50) or t for f, t in zip(
        (qry, qry_plain, qry_lib), q_call))
    read = table_bytes_read(torch, table[None], qkeys[None], sd)
    q_bound, q_by = bound(SINGLE_KEYS * 4 + read + ROWS * SINGLE_KEYS * 4,
                          SINGLE_KEYS * QUERY_OPS_PER_KEY)
    # the batched row read at the shape query_rows_batched launched it
    nb = both_keys.numel()
    bgidx = gather_index(torch, both_keys, both_seeds, WIDTH)
    both_flat = both.reshape(len(SINGLE_N), -1)
    qb_fns = (
        lambda: ops.query_rows_batched(both, both_keys, both_seeds),
        lambda: ref.countsketch_query_batched_ref(both, both_keys,
                                                  both_seeds),
        lambda: torch.gather(both_flat, 1, bgidx))
    qb_call = [cuda_ms(torch, f, 200, warmup=5) for f in qb_fns]
    qb_ms, qb_plain, qb_lib = (device_ms(torch, f, 50) or t
                               for f, t in zip(qb_fns, qb_call))
    qb_bound, qb_by = bound(
        nb * 4 + table_bytes_read(torch, both, both_keys, both_seeds)
        + ROWS * nb * 4, nb * QUERY_OPS_PER_KEY)
    # the row read at the flush's shape (B streams x CANDIDATES keys), rows
    # 7 and 17 (where the estimate falls back to it)
    flush_reads = {rows: row_read_shape(torch, rows, tag)
                   for rows in FLUSH_READ_ROWS}
    # the estimate: its kernel against the row read and the plain median
    # (one launch against eight), device time per call from a trace
    e_fns = {
        "estimate": lambda: ops.estimate(table, qkeys, SINGLE_SEED),
        "row_read_median": lambda: countsketch.median(
            ops.query_rows(table, qkeys, SINGLE_SEED), 0),
        "plain": lambda: ref.countsketch_estimate_ref(table, qkeys,
                                                      SINGLE_SEED)}
    e_call = {name: cuda_ms(torch, f, 200, warmup=5)
              for name, f in e_fns.items()}
    e_t = {name: device_ms(torch, f, 50) or e_call[name]
           for name, f in e_fns.items()}
    e_bound, e_by = bound(SINGLE_KEYS * 8 + read,
                          SINGLE_KEYS * ESTIMATE_OPS_PER_KEY)

    # the transform at p = 1 (a reciprocal) and p = 1.5 (powf), both
    # variants; the plain version and the yardstick at p = 1
    factor = transforms._pow32(hashing.exp1(keys_big, 0), -1.0 / P)
    t_times = {}
    for name, v, width in (("float32", vals, 4), ("bfloat16", vals_bf16, 2)):
        f = factor.to(v.dtype)
        # the scalar variant on views that start one element in (n - 1)
        t = {(p, variant): cuda_ms(torch, lambda: tr.ppswor_transform(
            keys_big[cut], v[cut], p, 0), 20)
            for p in (1.0, 1.5) for variant, cut in (
                ("vector", slice(None)), ("scalar", slice(1, None)))}
        t["plain"] = cuda_ms(torch, lambda: ref.ppswor_transform_ref(
            keys_big, v, P, 0), 3, warmup=1)
        t["library"] = cuda_ms(torch, lambda: torch.mul(v, f), 20)
        t["bound"], t["bound_by"] = bound(n_big * (4 + 2 * width),
                                          n_big * TRANSFORM_OPS_PER_ELEM)
        t_times[name] = t
        del f
    del factor
    plan = plan_of(1, n_big, None)
    log(f"[time] sketch_dense_vector (n={n_big}): kernel {s_ms:.4f} ms "
        f"(shared memory, {plan['blocks']} blocks of {plan['chunk']} slots; "
        f"global atomics {single_ms['global']:.4f} ms), plain "
        f"{s_plain:.4f} ms, index_add_ yardstick (memory half only) "
        f"{s_lib:.4f} ms, bound {s_bound:.4f} ms by {s_by}, "
        f"{100 * s_bound / s_ms:.1f} % of bound {tag}")
    log(f"[time] query_rows (k={SINGLE_KEYS}), device time per call "
        f"(traced): kernel {q_ms:.4f} ms, plain {q_plain:.4f} ms, gather "
        f"yardstick (memory half only) {q_lib:.4f} ms, bound {q_bound:.6f} "
        f"ms by {q_by}; per call by CUDA events (host-bound): kernel "
        f"{q_call[0]:.4f} ms, plain {q_call[1]:.4f} ms, gather "
        f"{q_call[2]:.4f} ms {tag}")
    log(f"[time] query_rows_batched (B={len(SINGLE_N)}, k={SINGLE_KEYS}), "
        f"device time per call (traced): kernel {qb_ms:.4f} ms, plain "
        f"{qb_plain:.4f} ms, gather yardstick (memory half only) "
        f"{qb_lib:.4f} ms, bound {qb_bound:.6f} ms by {qb_by}; per call by "
        f"CUDA events (host-bound): kernel {qb_call[0]:.4f} ms, plain "
        f"{qb_call[1]:.4f} ms, gather {qb_call[2]:.4f} ms {tag}")
    log(f"[time] estimate (k={SINGLE_KEYS}), device time per call "
        f"(traced): estimate kernel {e_t['estimate']:.4f} ms, row read + "
        f"countsketch.median {e_t['row_read_median']:.4f} ms, plain "
        f"{e_t['plain']:.4f} ms, bound {e_bound:.6f} ms by {e_by}; per call "
        f"by CUDA events (host-bound): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in e_call.items()) + f" {tag}")
    for name, t in t_times.items():
        log(f"[time] transform {name} (n={n_big}): p=1 vector "
            f"{t[(1.0, 'vector')]:.4f} ms, scalar (n-1, a view one element "
            f"in) {t[(1.0, 'scalar')]:.4f} ms; p=1.5 vector "
            f"{t[(1.5, 'vector')]:.4f} ms, scalar {t[(1.5, 'scalar')]:.4f} "
            f"ms; plain (p=1) {t['plain']:.4f} ms, torch.mul by precomputed "
            f"factors {t['library']:.4f} ms, bound {t['bound']:.4f} ms by "
            f"{t['bound_by']}, "
            f"{100 * t['bound'] / t[(1.0, 'vector')]:.1f} % of bound at p=1 "
            f"(vector) {tag}")
    log(f"[phase] 6 single-stream entry points: "
        f"{time.perf_counter() - t_phase:.2f} s wall")
    f32, bf16 = t_times["float32"], t_times["bfloat16"]

    def transform_variants_entry(t):
        return {v: {"launches": transform_variants[v], "ms": t[(1.0, v)],
                    "ms_p1.5": t[(1.5, v)]} for v in tr.VARIANTS}
    return [
        {"name": "countsketch_update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_update.cu",
         "replaces": "src/repro/kernels/countsketch_update.py:102",
         "launches": launches["update"], "max_abs_err": u_err,
         "parity": f"allclose rtol {RTOL} atol 1e-5*max(1,max|want|) and "
                   f"per-cell eps32*(m+{ref.TRANSFORM_ULPS})*sum|term|",
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": s_lib, "variant": "smem",
         "variants": variants_entry("countsketch_update", single_variants,
                                    single_errs, single_ms, {"smem": plan})},
        {"name": "countsketch_query", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_query.cu",
         "replaces": "src/repro/kernels/countsketch_query.py:66",
         "launches": launches["query"], "max_abs_err": 0.0,
         "parity": "bitwise", "ms": q_ms, "plain_ms": q_plain,
         "bound_ms": q_bound, "bound_by": q_by, "library_ms": q_lib,
         "timing": "device time per call from a torch.profiler trace",
         "call_ms": q_call[0]},
        {"name": "countsketch_query_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_query.cu",
         "replaces": "src/repro/kernels/countsketch_query.py:150",
         "launches": launches["query_batched"], "max_abs_err": 0.0,
         "parity": "bitwise", "ms": qb_ms, "plain_ms": qb_plain,
         "bound_ms": qb_bound, "bound_by": qb_by, "library_ms": qb_lib,
         "timing": "device time per call from a torch.profiler trace, at "
                   "query_rows_batched's shape",
         "call_ms": qb_call[0],
         "design": "within one wave of the card a lane a (stream, row, "
                   "key) read (a block a stream's 32-key tile, a warp a "
                   "row); past it a lane a key, 4 rows' loads in flight",
         **{f"flush_shape_rows{rows}": rec
            for rows, rec in flush_reads.items()}},
        {"name": "countsketch_estimate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_query.cu",
         "replaces": "src/repro/kernels/countsketch_query.py:66",
         "launches": launches["estimate"], "max_abs_err": 0.0,
         "parity": "equal under == (NaN equal to NaN) to countsketch.median "
                   "of the plain reads",
         "ms": e_t["estimate"], "plain_ms": e_t["plain"],
         "bound_ms": e_bound, "bound_by": e_by, "library_ms": q_lib,
         "row_read_median_ms": e_t["row_read_median"],
         "timing": "device time per call from a torch.profiler trace",
         "call_ms": e_call["estimate"]},
        {"name": "ppswor_transform", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ppswor_transform.cu",
         "replaces": "src/repro/kernels/ppswor_transform.py:32",
         "launches": launches["transform"],
         "max_abs_err": path_err["float32"],
         "max_abs_err_any_p": t_err["float32"],
         "parity": "float32 rtol 1e-5 atol 1e-6; bfloat16 rtol 2e-2 "
                   "atol 1e-2; the plain version's +-inf equal, signs "
                   "included; p = 0.5, 1, 1.5, 2",
         "ms": f32[(1.0, "vector")], "plain_ms": f32["plain"],
         "bound_ms": f32["bound"], "bound_by": f32["bound_by"],
         "library_ms": f32["library"], "variant": "vector",
         "variants": transform_variants_entry(f32),
         "bf16_max_abs_err": path_err["bfloat16"],
         "bf16_ms": bf16[(1.0, "vector")], "bf16_plain_ms": bf16["plain"],
         "bf16_bound_ms": bf16["bound"], "bf16_library_ms": bf16["library"],
         "bf16_variants": transform_variants_entry(bf16)},
    ]


# -- the samplers phase ---------------------------------------------------

def reset_counts() -> None:
    """Every kernel wrapper's launch counters to 0."""
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ppswor_transform as tr
    from repro_torch.kernels import segment_sum as sg

    s.launches = s.single_launches = 0
    u.launches = u.single_launches = tr.launches = 0
    q.launches = q.single_launches = 0
    q.estimate_launches = q.estimate_single_launches = 0
    sg.launches = 0
    for m in (s, u, tr):
        m.variant_launches.update(dict.fromkeys(m.variant_launches, 0))


def read_counts() -> dict:
    """The launch counters (``kernels.launch_counts``): the scatter (and
    its variants), the estimate, the batched row read, the segment sum,
    and every other kernel's launches summed."""
    from repro_torch.kernels import launch_counts

    return launch_counts()


def since(before: dict) -> dict:
    now = read_counts()
    return {k: now[k] - before[k] for k in now}


def expect_counts(what, got: dict, scatter=0, estimate=0):
    """Raise unless the launches are exactly ``scatter`` shared-memory
    scatters and ``estimate`` estimate-kernel launches, and nothing else."""
    want = {"scatter": scatter, "smem": scatter, "global": 0, "det": 0,
            "segment_sum": 0, "estimate": estimate, "row_read": 0,
            "other": 0}
    log(f"[main] {what}: launches {got}")
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def sub_view(st):
    """The first SUB_B streams of a batched state or sample, as views (no
    path writes into a state's tensors: a flush makes new ones)."""
    from repro_torch.engine.engine import _map

    return _map(lambda x: x[:SUB_B], st)


def flush_tolerance(torch, old_table, keys, vals, seeds, tseeds):
    """Each cell's rounding bound for one flush into ``old_table``: the
    flush's terms and the old value, in any order."""
    from repro_torch.kernels import ref

    rows, width = old_table.shape[-2:]
    cnt, mass = ref.countsketch_scatter_mass_ref(keys, vals, rows, width,
                                                 seeds, p=P,
                                                 transform_seeds=tseeds)
    return ref.scatter_tolerance(cnt + 1, mass + old_table.abs())


def near_tie_streams(torch, keys, prio, err, c: int):
    """(B,) streams whose c-th and (c+1)-st distinct priorities under the
    buffer policy (``worp._dedup_keys_topc``) lie within the sum of their
    errors, ``err(keys)``: where rounding may swap the key kept."""
    from repro_torch.core import worp

    k2, p2 = worp._dedup_keys_topc(keys, prio, c + 1)
    e2 = err(k2)
    return (p2[:, c - 1] - p2[:, c]) <= (e2[:, c - 1] + e2[:, c])


def same_sets(torch, a, b):
    return (torch.sort(a, 1).values == torch.sort(b, 1).values).all(1)


def check_flush_table(torch, what, got, want, tol, scale, stats):
    """A flush's kernel tables (of the first SUB_B streams) against the
    plain update's from the same state, within both bounds.  The
    scale-aware one takes its scale from the deployment's tables before
    and after the flush (``scale``, all B streams): a retraction can take
    a cell from the largest value back to about zero, leaving the rounding
    of that value behind.  Returns the streams whose plain tables hold
    non-finite cells (the uniform01 == 1.0 edge)."""
    atol = max(scale_atol(t) for t in scale)
    close = torch.allclose(got, want, rtol=RTOL, atol=atol, equal_nan=True)
    cells, err, ratio = cell_check(torch, got, want, tol)
    if not (close and cells):
        over = torch.where(want.isfinite(), (got - want).abs()
                           - RTOL * want.abs(), 0.0).flatten()
        i = int(over.argmax())
        raise AssertionError(
            f"{what} tables disagree (max_abs_err {err:.3e}, worst err/bound"
            f" {ratio:.3e}; allclose atol {atol:.3e}, worst cell {i}: got "
            f"{float(got.flatten()[i])!r} want {float(want.flatten()[i])!r} "
            f"bound {float(tol.flatten()[i])!r})")
    st = stats.setdefault(what, {"max_abs_err": 0.0, "ratio": 0.0})
    st["max_abs_err"] = max(st["max_abs_err"], err)
    st["ratio"] = max(st["ratio"], ratio)
    return (~want.isfinite()).flatten(1).any(1)


def check_buffer(torch, what, got_keys, want_keys, all_keys, prio, err, c,
                 bad, stats):
    """A flush's kernel buffer (candidates, or the pass-II keys) against the
    plain update's as key sets: a stream may differ only in a near tie of
    its c-th and (c+1)-st priorities, or where its plain table is not
    finite."""
    same = same_sets(torch, got_keys, want_keys)
    near = near_tie_streams(torch, all_keys, prio, err, c)
    outside = int((~same & ~near & ~bad).sum())
    st = stats.setdefault(what, {"checked": 0, "differ": 0, "near_tie": 0})
    st["checked"] += same.numel()
    st["differ"] += int((~same).sum())
    st["near_tie"] += int(near.sum())
    if outside:
        raise AssertionError(f"{what}: {outside} streams differ from the "
                             f"plain path outside near ties")
    return same


def check_refresh(torch, what, got_cand, want_sk, want_cand, old_cand, keys,
                  tol, bad, stats):
    """The candidate refresh of one flush (top-C of old candidates U batch
    keys by |estimate|)."""
    from repro_torch.core import countsketch
    from repro_torch.kernels import ref

    all_keys = torch.cat([old_cand, keys], 1)
    est = countsketch.estimate(want_sk, all_keys).abs()
    prio = torch.where(all_keys == -1, float("-inf"), est)

    def err(k):
        return ref.countsketch_query_batched_ref(tol, k, want_sk.seed).abs(
            ).amax(1)

    check_buffer(torch, what, got_cand, want_cand, all_keys, prio, err,
                 old_cand.shape[1], bad, stats)
    return err


def check_twopass_flush(torch, spec, old, full, keys, vals, stats):
    """One ``twopass`` flush of the kernels (the engine's states ``old``
    before and ``full`` after it, their first SUB_B streams) against the
    plain update of the same state: pass-I tables and candidates, pass-II
    keys, and the exact frequencies of equal buffers bit for bit (the
    stream's values are +-1)."""
    from repro_torch.core import countsketch

    snap, got = sub_view(old), sub_view(full)
    want = spec.update(snap, keys, torch.where(keys == -1, 0.0, vals))
    sk0 = snap.pass1.sketch
    tol = flush_tolerance(torch, sk0.table, keys, vals, sk0.seed,
                          snap.pass1.seed_transform)
    bad = check_flush_table(torch, "twopass pass I", got.pass1.sketch.table,
                            want.pass1.sketch.table, tol,
                            (old.pass1.sketch.table, full.pass1.sketch.table),
                            stats)
    err = check_refresh(torch, "twopass pass-I candidates",
                        got.pass1.cand_keys, want.pass1.sketch,
                        want.pass1.cand_keys, snap.pass1.cand_keys, keys,
                        tol, bad, stats)
    # pass II: top-capacity of (buffer U batch keys) by online priority
    est = countsketch.estimate(want.pass1.sketch, keys).abs()
    all_keys = torch.cat([snap.pass2.keys, keys], 1)
    prio = torch.cat([snap.pass2.priority,
                      torch.where(keys == -1, float("-inf"), est)], 1)
    same = check_buffer(torch, "twopass pass-II keys", got.pass2.keys,
                        want.pass2.keys, all_keys, prio, err,
                        snap.pass2.keys.shape[1], bad, stats)
    gk, gi = torch.sort(got.pass2.keys, 1)
    wk, wi = torch.sort(want.pass2.keys, 1)
    equal = (torch.gather(got.pass2.freqs, 1, gi)
             == torch.gather(want.pass2.freqs, 1, wi)).all(1)
    if bool((same & ~equal).any()):
        raise AssertionError("twopass pass-II frequencies differ from the "
                             "plain path's")
    return bad


def check_tv_flush(torch, spec, old, full, keys, vals, stats):
    """One ``tv`` flush of the kernels against the plain update of the same
    state: the B x r cascade tables and candidates, the rHH's."""
    from repro_torch.core import countsketch

    snap, got = sub_view(old), sub_view(full)
    want = spec.update(snap, keys, torch.where(keys == -1, 0.0, vals))
    Bs, r = snap.transform_seeds.shape

    def flat(t):
        return t.reshape((Bs * r,) + t.shape[2:])

    kf, vf = keys.repeat_interleave(r, 0), vals.repeat_interleave(r, 0)
    tol = flush_tolerance(torch, flat(snap.sketches.table), kf, vf,
                          flat(snap.sketches.seed),
                          flat(snap.transform_seeds))
    bad_f = check_flush_table(torch, "tv cascade", flat(got.sketches.table),
                              flat(want.sketches.table), tol,
                              (old.sketches.table, full.sketches.table),
                              stats)
    check_refresh(torch, "tv cascade candidates", flat(got.cand_keys),
                  countsketch.CountSketch(table=flat(want.sketches.table),
                                          seed=flat(want.sketches.seed)),
                  flat(want.cand_keys), flat(snap.cand_keys), kf, tol, bad_f,
                  stats)
    sk0 = snap.rhh.sketch
    tol = flush_tolerance(torch, sk0.table, keys, vals, sk0.seed,
                          snap.rhh.seed_transform)
    bad_r = check_flush_table(torch, "tv rHH", got.rhh.sketch.table,
                              want.rhh.sketch.table, tol,
                              (old.rhh.sketch.table, full.rhh.sketch.table),
                              stats)
    check_refresh(torch, "tv rHH candidates", got.rhh.cand_keys,
                  want.rhh.sketch, want.rhh.cand_keys, snap.rhh.cand_keys,
                  keys, tol, bad_r, stats)
    return bad_f.reshape(Bs, r).any(1) | bad_r


def sampler_engine(name: str, num_streams: int = None):
    from repro_torch.engine import EngineConfig, FlushPolicy, SketchEngine

    return SketchEngine(
        EngineConfig(num_streams=num_streams or B, rows=ROWS, width=WIDTH,
                     candidates=CANDIDATES, p=P, sampler=name,
                     domain=VOCAB),
        flush=FlushPolicy(max_elems=4096), device=DEVICE)


def traced_ms(torch, fn, what, tag) -> float | None:
    """Device busy ms of one call of ``fn`` from a torch.profiler trace
    (its stage ranges, kernels by name and busy share printed; None when
    the profiler saw no device time); the trace must hold no sort over
    rows."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = trace_report(prof, RANGES, wall_ms, what, tag, top=8)
    check_no_row_sort(rows, what)
    busy = sum(r[0] for r in rows if "Activity Buffer" not in r[2])
    return busy if rows else None


def profile_sampler(torch, name, steps, k, tag, num_streams=None):
    """A fresh engine of ``name``: one flush, then a second flush and a
    sample each in a trace.  Returns their device ms."""
    eng = sampler_engine(name, num_streams)
    n = num_streams or B
    eng.ingest(steps[0][0][:n], steps[0][1][:n])
    flush_ms = traced_ms(torch, lambda: eng.ingest(steps[1][0][:n],
                                                   steps[1][1][:n]),
                         f"{name}, 1 flush", tag)
    sample_ms = traced_ms(torch, lambda: eng.sample(k),
                          f"{name}, sample(k={k})", tag)
    return flush_ms, sample_ms


def drive_sampler(torch, name, steps, k, check_flush, tag):
    """The main path of sampler ``name`` at B streams: ingest the steps
    (each fills one flush) and sample, with the launches counted; after
    each flush, outside the timed calls, the first SUB_B streams against
    the plain update of the state before it (``check_flush``)."""
    dev = torch.device(DEVICE)
    eng = sampler_engine(name)
    stats, bad = {}, None
    ingest_s, flushes, peak = 0.0, 0, 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()
    for keys, vals in steps:
        old = eng.state  # a flush makes new tensors: this one stays intact
        before = read_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.ingest(keys, vals)
        torch.cuda.synchronize()
        ingest_s += time.perf_counter() - t0
        peak = max(peak, torch.cuda.max_memory_allocated())
        flushes += eng.pending == 0
        ran = since(before)
        kt = torch.from_numpy(keys[:SUB_B]).to(dev)
        vt = torch.from_numpy(vals[:SUB_B]).to(dev)
        b = check_flush(torch, eng.spec, old, eng.state, kt, vt, stats)
        if since(before) != ran:
            raise AssertionError("the plain reference launched a kernel")
        bad = b if bad is None else bad | b
        del old, kt, vt
    ingest_counts = read_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    samp = eng.sample(k)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    peak = max(peak, torch.cuda.max_memory_allocated())
    sample_counts = since(ingest_counts)
    sample_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.sample(k)
        torch.cuda.synchronize()
        sample_ms.append((time.perf_counter() - t0) * 1e3)
    events = sum(kk.size for kk, _ in steps)
    for what, st in stats.items():
        log(f"[main] {name} vs plain, {what}: {st}")
    log(f"[time] {name} sparse plane: {flushes} flushes, {events} events in "
        f"{ingest_s:.4f} s = {events / ingest_s:.4e} events/s; sample(k={k})"
        f" first {first_ms:.3f} ms, 5 calls "
        + " ".join(f"{x:.3f}" for x in sample_ms) + f" ms; peak memory "
        f"{peak / 1e6:.1f} MB {tag}")
    return {"eng": eng, "sample": samp, "bad": bad, "flushes": flushes,
            "ingest": ingest_counts, "sample_launches": sample_counts,
            "events_per_s": events / ingest_s, "sample_ms": sample_ms,
            "first_sample_ms": first_ms, "peak_mb": peak / 1e6,
            "stats": stats}


def phase_samplers(torch, steps, stream, tag):
    """The samplers phase: ``twopass`` and ``tv`` on the sparse plane,
    ``onepass`` with freeze/update_pass2/sample_exact, and ``perfect``, at
    the sparse plane's deployment, each against the plain path on the
    first SUB_B streams; the scatter and the estimate at the TV cascade's
    shapes.  Returns the launches of each kernel on these paths and the
    kernels-line records of the new shapes."""
    import numpy as np

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    launches = {"scatter": 0, "smem": 0, "estimate": 0}
    out = {}

    def add(counts):
        for key in launches:
            launches[key] += counts[key]

    # -- twopass, sparse plane -------------------------------------------
    tp = drive_sampler(torch, "twopass", steps, K, check_twopass_flush, tag)
    f = tp["flushes"]
    expect_counts(f"twopass, {f} flushes", tp["ingest"], scatter=f,
                  estimate=2 * f)
    expect_counts("twopass sample", tp["sample_launches"])
    add(tp["ingest"])
    want = tp["eng"].spec.sample(sub_view(tp["eng"].state), K)
    got = sub_view(tp["sample"])
    if not (torch.equal(got.keys, want.keys)
            and torch.equal(got.freqs, want.freqs)):
        raise AssertionError("twopass sample differs from the plain "
                             "sample of the same state")
    log(f"[main] twopass sample(k={K}) of the first {SUB_B} streams: keys and"
        f" exact frequencies equal to the plain sample; streams with "
        f"non-finite cells {int(tp['bad'].sum())}")
    out["twopass"] = {k: tp[k] for k in ("events_per_s", "sample_ms",
                                         "first_sample_ms", "peak_mb")}
    del tp
    torch.cuda.empty_cache()
    out["twopass"]["flush_ms"], out["twopass"]["traced_sample_ms"] = \
        profile_sampler(torch, "twopass", steps, K, tag)

    # -- tv, sparse plane --------------------------------------------------
    tv = drive_sampler(torch, "tv", steps, TV_K, check_tv_flush, tag)
    f = tv["flushes"]
    r = tv["eng"].cfg.num_samplers
    expect_counts(f"tv, {f} flushes", tv["ingest"], scatter=2 * f,
                  estimate=2 * f)
    expect_counts(f"tv sample ({r} draws and the rHH read)",
                  tv["sample_launches"], estimate=r + 1)
    add(tv["ingest"])
    add(tv["sample_launches"])
    want = tv["eng"].spec.sample(sub_view(tv["eng"].state), TV_K)
    got = sub_view(tv["sample"])
    if not torch.equal(got.keys, want.keys):
        raise AssertionError("tv sample keys differ from the plain sample of "
                             "the same state")
    if not bool(tv["sample"].threshold.isnan().all()):
        raise AssertionError("tv sample threshold is not NaN")
    fresh = (tv["sample"].keys != -1).sum(1).float()
    log(f"[main] tv sample(k={TV_K}) of the first {SUB_B} streams: keys "
        f"equal to the plain sample's (estimate kernel == plain median); "
        f"threshold NaN; fresh draws a stream mean {float(fresh.mean()):.3f}"
        f" min {int(fresh.min())}; streams with non-finite cells "
        f"{int(tv['bad'].sum())}")
    out["tv"] = {k: tv[k] for k in ("events_per_s", "sample_ms",
                                    "first_sample_ms", "peak_mb")}
    tv_state = tv["eng"].state
    del tv
    torch.cuda.empty_cache()
    out["tv"]["flush_ms"], out["tv"]["traced_sample_ms"] = profile_sampler(
        torch, "tv", steps, TV_K, tag)

    # -- the scatter and the estimate at the TV cascade's shapes ----------
    out["tv_shapes"] = time_tv_shapes(torch, tv_state, steps, tag)
    del tv_state
    torch.cuda.empty_cache()

    # -- perfect, sparse plane, on the sub-batch: no kernel ----------------
    pe = sampler_engine("perfect", SUB_B)
    reset_counts()
    before = read_counts()
    t0 = time.perf_counter()
    for keys, vals in steps:
        pe.ingest(keys[:SUB_B], vals[:SUB_B])
    pe.flush()
    torch.cuda.synchronize()
    perfect_s = time.perf_counter() - t0
    expect_counts("perfect, sparse plane (no sketch, no kernel)",
                  since(before))
    devices = {t.device.type for t in (pe.state.freqs,
                                       pe.state.seed_transform)}
    if devices != {dev.type}:
        raise AssertionError(f"perfect state on {devices}")
    for b in range(4):
        agg = stream.aggregate_freqs(b, STEPS, INSERTS).astype(np.float32)
        if not np.array_equal(pe.state.freqs[b].cpu().numpy(), agg):
            raise AssertionError("perfect frequencies differ from the "
                                 "stream's aggregate")
    exact = pe.sample(K)
    out["perfect"] = {"ingest_s": perfect_s}
    out["perfect"]["flush_ms"], out["perfect"]["traced_sample_ms"] = \
        profile_sampler(torch, "perfect", steps, K, tag, num_streams=SUB_B)
    log(f"[main] perfect (B={SUB_B}, domain {VOCAB}): state on the card, no "
        f"kernel launched, frequencies equal to the stream's aggregate "
        f"(streams 0-3); {STEPS} steps in {perfect_s:.4f} s {tag}")

    # -- onepass: freeze, update_pass2, sample_exact -----------------------
    eng = sampler_engine("onepass")
    for keys, vals in steps:
        eng.ingest(keys, vals)
    eng.freeze()
    spec = eng.spec
    frozen = sub_view(eng.state)  # pass II leaves it as it is
    plain2 = spec.init2(frozen)
    reset_counts()
    call_ms = []
    for keys, vals in steps:
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.update_pass2(keys, vals)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        expect_counts("update_pass2 call", since(before), estimate=1)
        plain2 = spec.update2(plain2, frozen,
                              torch.from_numpy(keys[:SUB_B]).to(dev),
                              torch.from_numpy(vals[:SUB_B]).to(dev))
    add(read_counts())
    before = read_counts()
    t0 = time.perf_counter()
    samp = eng.sample_exact(K)
    torch.cuda.synchronize()
    exact_ms = [(time.perf_counter() - t0) * 1e3]
    for _ in range(5):
        t0 = time.perf_counter()
        eng.sample_exact(K)
        torch.cuda.synchronize()
        exact_ms.append((time.perf_counter() - t0) * 1e3)
    expect_counts("sample_exact", since(before))
    got2 = sub_view(eng.pass2)
    if not all(torch.equal(a, b) for a, b in zip(got2, plain2)):
        raise AssertionError("pass-II buffers differ from the plain path's "
                             "(the priorities are estimates equal under ==)")
    want = spec.sample2(plain2, K)
    sub = sub_view(samp)
    if not (torch.equal(sub.keys, want.keys)
            and torch.equal(sub.freqs, want.freqs)):
        raise AssertionError("sample_exact differs from the plain path's")
    live = sub.keys != -1
    agg = torch.gather(pe.state.freqs, 1,
                       torch.where(live, sub.keys, 0).to(torch.int64))
    if not bool(torch.isclose(sub.freqs, agg, rtol=1e-5)[live].all()):
        raise AssertionError("sample_exact frequencies are not the stream's "
                             "exact aggregated frequencies")
    ex = exact.keys
    hit = (sub.keys[:, :, None] == ex[:, None, :]).any(2).sum(1).float() / K
    finite = frozen.sketch.table.isfinite().flatten(1).all(1)
    fin = hit[finite]
    n_exact = int((same_sets(torch, sub.keys, ex) & finite).sum())
    log(f"[main] onepass freeze -> {STEPS} x update_pass2 -> sample_exact("
        f"k={K}): pass-II buffers and sample equal to the plain path's on "
        f"{SUB_B} streams; sampled frequencies equal the exact aggregate; "
        f"recall of the perfect oracle's bottom-{K} over the "
        f"{int(finite.sum())}"
        f" finite streams: mean {float(fin.mean()):.4f} min "
        f"{float(fin.min()):.4f}, {n_exact} streams exact")
    if float(fin.min()) < 0.5:
        raise AssertionError("exact two-pass recall below 0.5")
    log(f"[time] update_pass2 (B={B}, n=5120 a call): "
        + " ".join(f"{x:.3f}" for x in call_ms) + f" ms; sample_exact(k={K})"
        f" first {exact_ms[0]:.3f} ms, 5 calls "
        + " ".join(f"{x:.3f}" for x in exact_ms[1:]) + f" ms {tag}")
    out["onepass_pass2"] = {"update_pass2_ms": call_ms,
                            "sample_exact_ms": exact_ms,
                            "recall_mean": float(fin.mean()),
                            "recall_min": float(fin.min()),
                            "exact_streams": n_exact}
    pass2_ms = traced_ms(torch, lambda: eng.update_pass2(*steps[1]),
                         "update_pass2, 1 call", tag)
    out["onepass_pass2"]["traced_ms"] = pass2_ms
    del eng, pe, frozen, plain2, samp, exact
    torch.cuda.empty_cache()
    log(f"[main] samplers phase launches on the main paths: {launches}")
    log(f"[phase] samplers: {time.perf_counter() - t_phase:.2f} s wall")
    return launches, out


def time_tv_shapes(torch, st, steps, tag) -> dict:
    """The scatter at the TV cascade's flush (B x r streams of one step) and
    the estimate at its refresh (B x r x (C + n) keys) and draw (B x C
    keys) shapes, each against its bound from these inputs, as phase 4
    counts them; the scatter with its index_add_ yardstick."""
    from repro_torch.core import transforms
    from repro_torch.kernels import countsketch_scatter as s

    dev = torch.device(DEVICE)
    Bt, r = st.transform_seeds.shape
    seeds = st.sketches.seed.reshape(-1)
    tseeds = st.transform_seeds.reshape(-1)
    keys = torch.from_numpy(steps[1][0]).to(dev).repeat_interleave(r, 0)
    vals = torch.from_numpy(steps[1][1]).to(dev).repeat_interleave(r, 0)
    before = dict(s.variant_launches)
    s.countsketch_scatter_batched(keys, vals, ROWS, WIDTH, seeds, p=P,
                                  transform_seeds=tseeds)
    if launched(s, before) != "smem":
        raise AssertionError("the TV cascade's scatter is not the "
                             "shared-memory variant")
    s_ms = cuda_ms(torch, lambda: s.countsketch_scatter_batched(
        keys, vals, ROWS, WIDTH, seeds, p=P, transform_seeds=tseeds), 10)
    live = int((keys != -1).sum())
    s_bound, s_by = bound(keys.numel() * 8 + Bt * r * ROWS * WIDTH * 4,
                          live * SCATTER_OPS_PER_SLOT)
    tv_ = transforms.transform_values(keys, vals, P, tseeds[:, None])
    idx, sign = row_index(torch, keys, seeds, WIDTH)
    idx = idx.reshape(-1)
    sv = (sign * tv_.repeat(1, ROWS)).reshape(-1)
    del tv_, sign
    flat = torch.zeros(Bt * r * ROWS * WIDTH, device=dev)
    s_lib = cuda_ms(torch, lambda: flat.zero_().index_add_(0, idx, sv), 5)
    del idx, sv, flat
    torch.cuda.empty_cache()
    plan = plan_of(Bt * r, keys.shape[1], None)
    log(f"[time] scatter at the TV cascade's flush (B*r={Bt * r}, n="
        f"{keys.shape[1]}): kernel {s_ms:.4f} ms ({plan['blocks']} blocks, "
        f"one a stream: {plan['one_per_stream']}), index_add_ yardstick "
        f"(memory half only) {s_lib:.4f} ms, bound {s_bound:.4f} ms by "
        f"{s_by}, {100 * s_bound / s_ms:.1f} % of bound {tag}")
    tables = st.sketches.table.reshape(Bt * r, ROWS, WIDTH)
    cands = st.cand_keys.reshape(Bt * r, -1)
    qkeys = torch.cat([cands, keys], 1).contiguous()
    del keys, vals
    check_estimate(torch, "TV cascade refresh shape", tables, qkeys, seeds)
    refresh = time_estimate(torch, "TV cascade refresh shape", tables, qkeys,
                            seeds, 5, 1, tag)
    del qkeys
    torch.cuda.empty_cache()
    draw_tables = st.sketches.table[:, 0].contiguous()
    draw_keys = st.cand_keys[:, 0].contiguous()
    draw_seeds = st.sketches.seed[:, 0].contiguous()
    check_estimate(torch, "TV draw shape", draw_tables, draw_keys,
                   draw_seeds)
    draw = time_estimate(torch, "TV draw shape", draw_tables, draw_keys,
                         draw_seeds, 20, 3, tag)
    return {"scatter": {"ms": s_ms, "bound_ms": s_bound, "bound_by": s_by,
                        "library_ms": s_lib, "streams": Bt * r,
                        "n": int(steps[1][0].shape[1])},
            "estimate_refresh": refresh, "estimate_draw": draw}


# -- the deterministic flush path and the async and pipeline planes --------

# the pipeline's shards, its steps (each one flush; the host partition of a
# (4096, 5120) flush takes seconds), and the interval trigger's age bound
PIPE_SHARDS, PIPE_STEPS, INTERVAL_S = 4, 2, 0.5
TRACED_FLUSHES = 4  # the overlap's traced window


class deterministic_mode:
    """``torch.use_deterministic_algorithms(True)`` inside, the caller's
    setting restored after."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        t = self.torch
        self.was = (t.are_deterministic_algorithms_enabled(),
                    t.is_deterministic_algorithms_warn_only_enabled())
        t.use_deterministic_algorithms(True)
        return self

    def __exit__(self, *exc):
        self.torch.use_deterministic_algorithms(self.was[0],
                                                warn_only=self.was[1])
        return False


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit (a float -0 differs from +0, NaN payloads count)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        a, b = (x.contiguous().view(torch.int32) for x in (a, b))
    return bool(torch.equal(a, b))


def states_equal(torch, a, b) -> bool:
    from repro_torch.engine.engine import _leaves

    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(same_bits(torch, x, y)
                                      for x, y in zip(la, lb))


def samples_equal(torch, a, b) -> bool:
    return all(same_bits(torch, x, y) for x, y in zip(a, b))


# The det scatter's and segment sum's designs these kernels replaced, as
# PERF.md's kernel table quotes them (NVIDIA H100 80GB HBM3, 700.00 W): ms,
# and the same-run ratio to the yardstick (the atomics variant;
# scatter_add_ with the mode off)
EARLIER_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
EARLIER = {("det", "flush shape"): (2.2955, 3.76),
           ("det", "TV cascade shape"): (17.5413, 3.95),
           ("segment sum", "flush shape"): (0.5851, 1.47),
           ("segment sum", "TV cascade shape"): (4.0409, 1.32)}


def earlier(kernel, what) -> str:
    ms, ratio = EARLIER[(kernel, what)]
    return (f"earlier (the replaced design, PERF.md, {EARLIER_CARD}) "
            f"{ms:.4f} ms, {ratio:.2f}x its yardstick")


def det_scatter_shape(torch, what, keys, vals, seeds, tseeds, iters, tag):
    """The det scatter at one shape: three launches give the same bits,
    each cell within its rounding bound of the plain version and of the
    shared-memory (atomics) variant; times of both variants, by CUDA
    events, beside the bound this run's inputs give."""
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import ref

    Bs, n = keys.shape
    kw = dict(p=P, transform_seeds=tseeds)
    want = ref.countsketch_scatter_batched_ref(keys, vals, ROWS, WIDTH,
                                               seeds, **kw)
    tol = ref.scatter_tolerance(*ref.countsketch_scatter_mass_ref(
        keys, vals, ROWS, WIDTH, seeds, **kw))
    outs = []
    with deterministic_mode(torch):
        for _ in range(3):
            before = dict(s.variant_launches)
            outs.append(s.countsketch_scatter_batched(keys, vals, ROWS,
                                                      WIDTH, seeds, **kw))
            ran = {v: s.variant_launches[v] - before[v] for v in before}
            if ran != {"smem": 0, "global": 0, "det": 1}:
                raise AssertionError(f"det scatter {what}: launched {ran}")
    torch.cuda.synchronize()
    identical = all(same_bits(torch, o, outs[0]) for o in outs[1:])
    log(f"[det] scatter {what} (B={Bs}, n={n}): 3 launches in the "
        f"deterministic mode, identical bits: {identical} {tag}")
    if not identical:
        raise AssertionError(f"det scatter {what}: launches differ")
    del outs[1:]
    err, ratio = check_sum(torch, f"scatter {what} [det]", outs[0], want,
                           tol)
    atomics = s.countsketch_scatter_batched(keys, vals, ROWS, WIDTH, seeds,
                                            _variant="smem", **kw)
    a_err, a_ratio = check_sum(torch, f"scatter {what} [det] vs [smem] "
                               f"(atomics)", outs[0], atomics, tol)
    del want, tol, atomics, outs
    torch.cuda.empty_cache()
    with deterministic_mode(torch):
        det_ms = cuda_ms(torch, lambda: s.countsketch_scatter_batched(
            keys, vals, ROWS, WIDTH, seeds, **kw), iters)
    smem_ms = cuda_ms(torch, lambda: s.countsketch_scatter_batched(
        keys, vals, ROWS, WIDTH, seeds, _variant="smem", **kw), iters)
    live = int((keys != -1).sum())
    b_ms, b_by = bound(keys.numel() * 8 + Bs * ROWS * WIDTH * 4,
                       live * SCATTER_OPS_PER_SLOT)
    log(f"[time] scatter {what} (B={Bs}, n={n}): det {det_ms:.4f} ms "
        f"({100 * b_ms / det_ms:.1f} % of bound), shared-memory atomics "
        f"{smem_ms:.4f} ms ({100 * b_ms / smem_ms:.1f} %), bound "
        f"{b_ms:.4f} ms by {b_by}; det / atomics "
        f"{det_ms / smem_ms:.2f}x; {earlier('det', what)} {tag}")
    return {"ms": det_ms, "atomics_ms": smem_ms, "bound_ms": b_ms,
            "ratio_to_atomics": det_ms / smem_ms,
            "bound_by": b_by, "max_abs_err": err,
            "worst_err_over_bound": ratio, "vs_atomics_max_abs_err": a_err,
            "vs_atomics_worst_err_over_bound": a_ratio}


# A one-row table past 2**15 buckets, where the det scatter stages 32-bit
# (bucket, sign) entries (tiling.det_entry_bytes); it fits a block up to
# 57,072 buckets (tiling.det_fits); checked on at most WIDE_STREAMS of the
# flush's streams
WIDE_WIDTH, WIDE_STREAMS = 40_000, 64


def det_wide_check(torch, keys, vals, seeds, tseeds, tag) -> dict:
    """The det scatter's 32-bit-entry instantiation on ``WIDE_STREAMS`` of
    the flush's streams (one of them padding, the rest with lengths) into
    one row of ``WIDE_WIDTH`` buckets: three launches give the same bits,
    which without the transform are the order model's
    (``ref.countsketch_scatter_det_ref``, on the CPU) bit for bit, and with
    it lie within the rounding bound of the plain version."""
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import ref, tiling

    if tiling.det_entry_bytes(WIDE_WIDTH) != 4 \
            or not tiling.det_fits(1, WIDE_WIDTH):
        raise AssertionError(f"width {WIDE_WIDTH} does not take the det "
                             f"scatter's 32-bit entries")
    keys, vals = keys[:WIDE_STREAMS].clone(), vals[:WIDE_STREAMS]
    keys[1] = -1
    streams, n = keys.shape
    lengths = torch.arange(streams, device=keys.device) * 97 % n + 1
    lengths[0] = n
    sd, td = seeds[:streams], tseeds[:streams]
    out = {"width": WIDE_WIDTH, "streams": streams}
    for p in (None, P):
        kw = dict(p=p, transform_seeds=td, lengths=lengths)
        with deterministic_mode(torch):
            got = [s.countsketch_scatter_batched(keys, vals, 1, WIDE_WIDTH,
                                                 sd, **kw) for _ in range(3)]
        torch.cuda.synchronize()
        identical = all(same_bits(torch, g, got[0]) for g in got[1:])
        if p is None:  # the order model on the CPU, as the card tests run it
            cpu = [t.cpu() for t in (keys, vals, sd, lengths)]
            model = same_bits(torch, got[0].cpu(),
                              ref.countsketch_scatter_det_ref(
                                  *cpu[:2], 1, WIDE_WIDTH, cpu[2],
                                  lengths=cpu[3]))
            out["equals_order_model"] = model
        else:  # the plain version on the card, as det_scatter_shape's
            model = True
            want = ref.countsketch_scatter_batched_ref(keys, vals, 1,
                                                       WIDE_WIDTH, sd, **kw)
            tol = ref.scatter_tolerance(*ref.countsketch_scatter_mass_ref(
                keys, vals, 1, WIDE_WIDTH, sd, **kw))
            out["max_abs_err"], out["worst_err_over_bound"] = check_sum(
                torch, f"scatter 1 x {WIDE_WIDTH} [det, 32-bit entries]",
                got[0], want, tol)
        vs = "" if p else f", equal to the order model bit for bit: {model}"
        log(f"[det] scatter 1 x {WIDE_WIDTH} ({streams} streams, "
            f"32-bit entries, p={p}): 3 launches identical: {identical}{vs} "
            f"{tag}")
        if not (identical and model):
            raise AssertionError(f"det scatter 1 x {WIDE_WIDTH}, p={p}: "
                                 f"identical {identical}, model {model}")
    return out


# Tables too large for one det block, split (tiling.det_split): the flush's
# B streams into fleet_serve --topk 400's 5 x 12,400 (two row groups; 1.0
# GB of deltas) and 7 x 16,384 (three; 1.9 GB), and WIDE_STREAMS of them
# into one row of 100,000 buckets (two bucket ranges); (rows, width,
# streams, None: all B).  The dense update's: the gemma2_2b layer at 7 x
# 16,384 and one 21.2 M segment at 1 x 100,000 (SPLIT_DENSE).
SPLIT_TABLES = ((5, 12_400, None), (7, 16_384, None),
                (1, 100_000, WIDE_STREAMS))
SPLIT_DENSE = ((7, 16_384, "layer"), (1, 100_000, "segment"))


def det_split_scatter(torch, keys, vals, seeds, tseeds, tag) -> dict:
    """The det scatter on ``SPLIT_TABLES``: three launches give the same
    bits, each counted as one det launch; without the transform the first
    ``WIDE_STREAMS`` streams are the order model's bit for bit
    (``ref.countsketch_scatter_det_ref`` on those streams, run on the card:
    its float32 adds are single IEEE adds in its own order, the bits the
    CPU gives, where the card tests run it); with it every cell lies within
    its rounding bound of the plain version.  Times of the det variant and
    of the global atomics (the default mode's variant at these widths),
    through the wrapper by CUDA events, beside the bound."""
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import ref, tiling

    out = {}
    for rows, width, streams in SPLIT_TABLES:
        k = keys if streams is None else keys[:streams].contiguous()
        v = vals if streams is None else vals[:streams].contiguous()
        Bs, n = k.shape
        sd, td = seeds[:Bs], tseeds[:Bs]
        plan = tiling.table_plan(Bs, n, None, rows, width,
                                 tiling.sm_count(k.device),
                                 deterministic=True)
        if not plan.row_group:
            raise AssertionError(f"det scatter {rows} x {width} is not split")
        what = f"{rows} x {width}"
        rec = {"rows": rows, "width": width, "streams": Bs,
               "plan": plan._asdict(), "parts": tiling.det_parts(plan, rows)}

        def det(p):
            before = dict(s.variant_launches)
            with deterministic_mode(torch):
                got = s.countsketch_scatter_batched(k, v, rows, width, sd,
                                                    p=p, transform_seeds=td)
            ran = {x: s.variant_launches[x] - before[x] for x in before}
            if ran != {"smem": 0, "global": 0, "det": 1}:
                raise AssertionError(f"det scatter {what}: launched {ran}")
            return got

        for p in (None, P):
            outs = [det(p) for _ in range(3)]
            torch.cuda.synchronize()
            identical = all(same_bits(torch, o, outs[0]) for o in outs[1:])
            del outs[1:]
            if p is None:
                m = min(Bs, WIDE_STREAMS)
                model = same_bits(torch, outs[0][:m],
                                  ref.countsketch_scatter_det_ref(
                                      k[:m], v[:m], rows, width, sd[:m]))
                rec["equals_order_model"] = model
            else:
                model = True
                kw = dict(p=p, transform_seeds=td)
                want = ref.countsketch_scatter_batched_ref(k, v, rows, width,
                                                           sd, **kw)
                tol = ref.scatter_tolerance(
                    *ref.countsketch_scatter_mass_ref(k, v, rows, width, sd,
                                                      **kw))
                rec["max_abs_err"], rec["worst_err_over_bound"] = check_sum(
                    torch, f"scatter {what} [det, split]", outs[0], want,
                    tol)
                del want, tol
            vs = "" if p else (f", the first {min(Bs, WIDE_STREAMS)} streams "
                               f"equal to the order model bit for bit: "
                               f"{model}")
            log(f"[det] scatter {what} (B={Bs}, n={n}, split into "
                f"{rec['parts']} blocks a stream: row group "
                f"{plan.row_group}, ranges {plan.ranges}; p={p}): 3 launches "
                f"identical: {identical}{vs} {tag}")
            if not (identical and model):
                raise AssertionError(f"det scatter {what}, p={p}: identical "
                                     f"{identical}, model {model}")
            del outs
            torch.cuda.empty_cache()
        kw = dict(p=P, transform_seeds=td)
        with deterministic_mode(torch):
            rec["ms"] = cuda_ms(torch, lambda: s.countsketch_scatter_batched(
                k, v, rows, width, sd, **kw), 5)
        rec["atomics_ms"] = cuda_ms(
            torch, lambda: s.countsketch_scatter_batched(
                k, v, rows, width, sd, _variant="global", **kw), 5)
        rec["plain_ms"] = cuda_ms(
            torch, lambda: ref.countsketch_scatter_batched_ref(
                k, v, rows, width, sd, **kw), 1, warmup=0)
        rec["library_ms"] = scatter_library_ms(torch, k, v, sd, td, rows,
                                               width)
        live = int((k != -1).sum())
        rec["bound_ms"], rec["bound_by"] = bound(
            k.numel() * 8 + Bs * rows * width * 4, live * slot_ops(rows))
        rec["ratio_to_atomics"] = rec["ms"] / rec["atomics_ms"]
        log(f"[time] scatter {what} (B={Bs}, n={n}): det (split) "
            f"{rec['ms']:.4f} ms ({100 * rec['bound_ms'] / rec['ms']:.1f} % "
            f"of bound), global atomics {rec['atomics_ms']:.4f} ms "
            f"({100 * rec['bound_ms'] / rec['atomics_ms']:.1f} %), plain "
            f"{rec['plain_ms']:.2f} ms, index_add_ yardstick "
            f"{rec['library_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}; det / atomics "
            f"{rec['ratio_to_atomics']:.2f}x (through the wrapper, the "
            f"mode's NaN fill of the delta included) {tag}")
        out[what] = rec
        torch.cuda.empty_cache()
    return out


def scatter_library_ms(torch, k, v, sd, td, rows, width) -> float:
    """The scatter's index_add_ yardstick (memory half only), as phase 4's:
    the (B, n) keys' flat (stream, row, bucket) indices and signed
    transformed values precomputed, one ``index_add_`` into zeroed
    rows x width tables, timed by CUDA events."""
    from repro_torch.core import transforms

    tv = transforms.transform_values(k, v, P, td[:, None])
    idx, sign = row_index(torch, k, sd, width, rows)
    idx, sv = idx.reshape(-1), (sign * tv.repeat(1, rows)).reshape(-1)
    del tv, sign
    flat = torch.zeros(k.shape[0] * rows * width, device=k.device)
    return cuda_ms(torch, lambda: flat.zero_().index_add_(0, idx, sv), 5)


def segment_sum_shape(torch, what, rows, tag):
    """The sorted segment sum at a ``_dedup_topc`` shape of the flush (rows
    x (C + n) entries, the run ids of sorted Zipf-like keys, made on the
    card): the same bits on two launches, and on the first ``SUB_B`` rows
    bit for bit the plain version on the CPU (index order); its time, the
    plain version's on the card under the mode (PyTorch's deterministic
    scatter_add_) and the atomics scatter_add_ (the mode off)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_sum as sg

    n = CANDIDATES + INSERTS + int(INSERTS * DELETE_FRACTION)
    g = torch.Generator(device=DEVICE).manual_seed(7)
    u = torch.rand((rows, n), generator=g, device=DEVICE)
    # a Zipf(1.2)-like head: key = floor(u^(-1/0.2)), key 1 in 13 % of a
    # row's slots
    keys = torch.sort(torch.clamp(u.pow(-1.0 / (ALPHA - 1.0)), max=VOCAB)
                      .to(torch.int64), 1).values
    first = torch.ones_like(keys, dtype=torch.bool)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    seg = torch.cumsum(first.to(torch.int64), 1) - 1
    vals = torch.randn((rows, n), generator=g, device=DEVICE)
    del u, keys, first
    got = [sg.segment_sum(vals, seg) for _ in range(2)]
    want = ref.segment_sum_ref(vals[:SUB_B].cpu(), seg[:SUB_B].cpu())
    ok = same_bits(torch, got[0], got[1]) \
        and same_bits(torch, got[0][:SUB_B].cpu(), want)
    log(f"[det] segment sum {what} ({rows} x {n}): 2 launches identical, "
        f"and the first {SUB_B} rows equal to the CPU's scatter_add_ bit for "
        f"bit: {ok} {tag}")
    if not ok:
        raise AssertionError(f"segment sum {what} is not deterministic or "
                             f"differs from the CPU's")
    del got, want
    k_ms = cuda_ms(torch, lambda: sg.segment_sum(vals, seg), 10)
    with deterministic_mode(torch):
        plain_ms = cuda_ms(torch, lambda: ref.segment_sum_ref(vals, seg),
                           3, warmup=1)
    lib_ms = cuda_ms(torch, lambda: ref.segment_sum_ref(vals, seg), 10)
    b_ms, b_by = bound(rows * n * 16, rows * n)
    log(f"[time] segment sum {what} ({rows} x {n}): kernel {k_ms:.4f} ms "
        f"({100 * b_ms / k_ms:.1f} % of bound {b_ms:.4f} ms by {b_by}); "
        f"PyTorch's deterministic scatter_add_ {plain_ms:.4f} ms; atomics "
        f"scatter_add_ (mode off) {lib_ms:.4f} ms; kernel / atomics "
        f"{k_ms / lib_ms:.2f}x; {earlier('segment sum', what)} {tag}")
    return {"ms": k_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "ratio_to_atomics": k_ms / lib_ms}


def nan_fill_ms(torch, streams, tag) -> dict:
    """The deterministic mode's cost of ``torch.empty`` for a scatter delta
    of ``streams`` tables (it fills new float memory with NaN)."""
    shape = (streams, ROWS, WIDTH)
    off = cuda_ms(torch, lambda: torch.empty(shape, device=DEVICE), 10)
    with deterministic_mode(torch):
        on = cuda_ms(torch, lambda: torch.empty(shape, device=DEVICE), 10)
    log(f"[time] torch.empty of a {streams * ROWS * WIDTH * 4 / 1e6:.0f} MB "
        f"scatter delta: {off:.4f} ms, in the deterministic mode (NaN "
        f"fill) {on:.4f} ms {tag}")
    return {"mb": streams * ROWS * WIDTH * 4 / 1e6, "ms": off, "det_ms": on}


def pytorch_sums_ms(torch, keys, vals, tag) -> dict:
    """The two PyTorch sums of the flush paths that keep PyTorch's own
    deterministic forms under the mode (the card tests check their bits):
    the perfect spec's ``scatter_add_`` (``SUB_B`` streams into a 2**20
    domain) and ``countsketch.update``'s ``index_add_`` (B x 7 x n terms,
    a plain path), each timed with the mode off and on."""
    from repro_torch.core import countsketch
    from repro_torch.core.sampler import SamplerConfig, make_sampler

    spec = make_sampler("perfect", SamplerConfig(domain=VOCAB))
    ids = torch.arange(B, device=DEVICE)
    st = spec.init(ids[:SUB_B], ids[:SUB_B])
    sk = countsketch.init(ROWS, WIDTH, ids)
    fns = {"perfect scatter_add_": lambda: spec.update(
               st, keys[:SUB_B], vals[:SUB_B]),
           "countsketch.update index_add_": lambda: countsketch.update(
               sk, keys, vals)}
    out = {}
    for what, fn in fns.items():
        off = cuda_ms(torch, fn, 3, warmup=1)
        with deterministic_mode(torch):
            on = cuda_ms(torch, fn, 3, warmup=1)
        out[what] = {"ms": off, "det_ms": on}
        log(f"[time] {what}: {off:.4f} ms, in the deterministic mode "
            f"{on:.4f} ms {tag}")
    return out


def plane_engine(name, plane, num_streams=None, policy=None, **opts):
    from repro_torch.engine import EngineConfig, FlushPolicy, SketchEngine

    return SketchEngine(
        EngineConfig(num_streams=num_streams or B, rows=ROWS, width=WIDTH,
                     candidates=CANDIDATES, p=P, sampler=name,
                     domain=VOCAB),
        plane=plane, flush=policy or FlushPolicy(max_elems=4096),
        device=DEVICE, plane_opts=opts or None)


def drive_plane(torch, eng, steps, n=None):
    """Ingest the steps (each fills one flush) and drain; the seconds to the
    card's synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for keys, vals in steps:
        eng.ingest(keys[:n], vals[:n])
    eng.flush()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def async_vs_sparse(torch, name, steps, k, n, tag):
    """Sampler ``name`` on the sparse and the async plane in the
    deterministic mode, on the first ``n`` streams: every state leaf and
    the sample equal bit for bit.  Returns the async run's launches."""
    engs, counts = {}, {}
    with deterministic_mode(torch):
        for plane in ("sparse", "async"):
            eng = plane_engine(name, plane, num_streams=n)
            reset_counts()
            drive_plane(torch, eng, steps, n)
            counts[plane] = read_counts()
            engs[plane] = eng
        state_ok = states_equal(torch, engs["sparse"].state,
                                engs["async"].state)
        samp_ok = samples_equal(torch, engs["sparse"].sample(k),
                                engs["async"].sample(k))
    engs["async"].plane.close()
    log(f"[det] {name} (B={n}, {len(steps)} flushes): async vs sparse, every "
        f"state leaf bit for bit: {state_ok}; sample(k={k}) bit for bit: "
        f"{samp_ok}; launches sparse {counts['sparse']}, async "
        f"{counts['async']} {tag}")
    if not (state_ok and samp_ok) or counts["sparse"] != counts["async"]:
        raise AssertionError(f"{name}: async differs from sparse in the "
                             f"deterministic mode")
    return counts["async"]


def profiler_config(torch):
    """An experimental config that records every thread's ranges (the async
    worker's ``plane.h2d``/``plane.dispatch``), where this PyTorch has it."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def overlap(torch, plane, steps, tag) -> dict:
    """Default mode (atomics): the ingest rate of the steps (one flush
    each), then a trace of ``TRACED_FLUSHES`` flushes and the drain, its
    busy share and plane ranges."""
    from torch.profiler import ProfilerActivity, profile

    eng = plane_engine("onepass", plane)
    secs = drive_plane(torch, eng, steps)
    events = sum(kk.size for kk, _ in steps)
    cfg = profiler_config(torch)
    eng2 = plane_engine("onepass", plane)
    eng2.ingest(*steps[0])
    eng2.flush()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **({"experimental_config": cfg} if cfg else {})) as prof:
        t0 = time.perf_counter()
        for keys, vals in steps[1:1 + TRACED_FLUSHES]:
            eng2.ingest(keys, vals)
        eng2.flush()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log(f"[overlap] {plane} plane: {events} events in {secs:.4f} s = "
        f"{events / secs:.4e} events/s ({len(steps)} flushes, default mode); "
        f"trace of "
        f"{TRACED_FLUSHES} flushes + drain, every thread's ranges: "
        f"{cfg is not None} {tag}")
    rows = trace_report(prof, RANGES, wall_ms,
                        f"{plane} plane, {TRACED_FLUSHES} flushes", tag,
                        top=6)
    busy = sum(r[0] for r in rows if "Activity Buffer" not in r[2])
    for e in (eng, eng2):
        e.plane.close()
    return {"events_per_s": events / secs, "seconds": secs,
            "traced_wall_ms": wall_ms, "busy_ms": busy,
            "busy_share": busy / wall_ms if rows else None}


def compare_histories(torch, what, st, ss, tol, seeds, k=K, p=P) -> int:
    """Two one-pass states of the same stream fed with other flush
    boundaries or shards: tables within the bounds, and sample keys
    identical but for near ties, non-finite streams and candidate buffers
    that differ; read over the union of both buffers, identical but for
    near ties and non-finite streams.  Returns the streams whose samples
    differ only through their buffers' histories.

    The candidate buffer is a heuristic whose content depends on the order
    of its refreshes (each flush refreshes among its own keys; a collapse
    among the shards' buffers), so a stream's samples may differ where a
    key of one sample is missing from the other state's buffer; read over
    the union of both buffers, the two tables must give the same sample
    but for near ties."""
    from repro_torch.engine.engine import onepass_sample_batched

    bad = compare_tables(torch, what, st.sketch.table, ss.sketch.table, tol)
    samp, ssamp = (onepass_sample_batched(x, k, p) for x in (st, ss))
    diff_a = ~(samp.keys[:, :, None] == ssamp.keys[:, None, :]).any(2)
    diff_b = ~(ssamp.keys[:, :, None] == samp.keys[:, None, :]).any(2)
    missing = ((diff_a & ~(samp.keys[:, :, None]
                           == ss.cand_keys[:, None, :]).any(2)).any(1)
               | (diff_b & ~(ssamp.keys[:, :, None]
                             == st.cand_keys[:, None, :]).any(2)).any(1))
    compare_samples(torch, what, samp, ss, tol, seeds, k, p, bad,
                    excused=missing,
                    excuse="a sampled key missing from the other state's "
                           "candidate buffer")
    pool = union_pool(torch, st, ss)
    compare_samples(torch, f"{what}, both read over the union of their "
                    f"candidate buffers",
                    onepass_sample_batched(st._replace(cand_keys=pool), k, p),
                    ss._replace(cand_keys=pool), tol, seeds, k, p, bad)
    return int(missing.sum())


def union_pool(torch, a, b):
    """The union of two one-pass states' candidate buffers, per stream
    (each key once, -1 padding)."""
    pool = torch.sort(torch.cat([a.cand_keys, b.cand_keys], 1), 1).values
    dup = torch.zeros_like(pool, dtype=torch.bool)
    dup[:, 1:] = pool[:, 1:] == pool[:, :-1]
    return torch.where(dup, -1, pool)


def flush_plain(torch, steps, seeds, tseeds):
    """The plain scatter's table of ``steps`` (each (B, n) keys and values,
    numpy) summed into one table, and the per-cell rounding bound of such a
    sum, any order."""
    import numpy as np

    from repro_torch.kernels import ref

    dev = torch.device(DEVICE)
    want = cnt = mass = None
    for keys, vals in steps:
        k = torch.from_numpy(np.ascontiguousarray(keys)).to(dev)
        v = torch.from_numpy(np.ascontiguousarray(vals)).to(dev)
        t = ref.countsketch_scatter_batched_ref(k, v, ROWS, WIDTH, seeds, p=P,
                                                transform_seeds=tseeds)
        c, m = ref.countsketch_scatter_mass_ref(k, v, ROWS, WIDTH, seeds, p=P,
                                                transform_seeds=tseeds)
        if want is None:
            want, cnt, mass = t, c, m
        else:
            want += t
            cnt += c
            mass += m
        del k, v, t, c, m
    return want, ref.scatter_tolerance(cnt, mass)


def pipeline_checks(torch, steps, seeds, tseeds, tag) -> dict:
    """``shards=4`` at B streams: the sparse plane against the plain
    scatter and the collapse against the sparse plane within the summing
    tolerances, sample keys identical but for near ties
    and for candidate buffers that differ, and identical but for near ties
    when both are read over the union of the two buffers; async sub-planes
    against sparse sub-planes bit for bit in the deterministic mode (fed the
    same partition through ``ingest_shard``)."""
    from repro_torch.engine import planes

    psteps = steps[:PIPE_STEPS]
    sparse = plane_engine("onepass", "sparse")
    drive_plane(torch, sparse, psteps)
    pipe = plane_engine("onepass", "pipeline", shards=PIPE_SHARDS)
    reset_counts()
    secs = drive_plane(torch, pipe, psteps)
    st = pipe.state
    merged = read_counts()
    want, tol = flush_plain(torch, psteps, seeds, tseeds)
    ss = sparse.state
    compare_tables(torch, "sparse plane vs the plain scatter",
                   ss.sketch.table, want, tol)
    del want
    missing = compare_histories(torch, f"pipeline (shards={PIPE_SHARDS}) vs "
                                f"sparse", st, ss, tol, seeds)
    out = {"seconds": secs, "history_streams": missing}
    del tol, sparse, pipe, st, ss
    torch.cuda.empty_cache()
    parts = [planes.partition_by_key(keys, vals, PIPE_SHARDS)
             for keys, vals in psteps]
    engs = {}
    with deterministic_mode(torch):
        for sub in ("sparse", "async"):
            eng = plane_engine("onepass", "pipeline", shards=PIPE_SHARDS,
                               subplane=sub)
            for blocks in parts:
                for shard, (k, v) in enumerate(blocks):
                    eng.plane.ingest_shard(shard, k, v)
            eng.flush()
            engs[sub] = eng
        ok = states_equal(torch, engs["sparse"].state, engs["async"].state) \
            and samples_equal(torch, engs["sparse"].sample(K),
                              engs["async"].sample(K))
    engs["async"].plane.close()
    log(f"[det] pipeline (shards={PIPE_SHARDS}, B={B}, {PIPE_STEPS} "
        f"flushes): async sub-planes vs sparse sub-planes, merged state and "
        f"sample bit for bit: {ok}; collapse launches {merged} {tag}")
    if not ok:
        raise AssertionError("pipeline: async sub-planes differ from sparse "
                             "sub-planes")
    out["launches"] = merged
    return out


def interval_check(torch, steps, tag) -> dict:
    """A stalled producer: one microbatch under every ingest-time trigger,
    then no call but reads of ``plane.state`` (which settles in-flight work
    and does not flush).  The timer must submit it once it is
    ``INTERVAL_S`` old, and the state must then equal a sparse plane's
    flush of the same batch bit for bit (deterministic mode)."""
    from repro_torch.engine import FlushPolicy

    keys, vals = steps[0][0][:SUB_B, :1024], steps[0][1][:SUB_B, :1024]
    with deterministic_mode(torch):
        eng = plane_engine("onepass", "async", num_streams=SUB_B,
                           policy=FlushPolicy(max_elems=None,
                                              max_interval=INTERVAL_S))
        t0 = time.perf_counter()
        eng.ingest(keys, vals)
        published = None
        while time.perf_counter() - t0 < INTERVAL_S + 30.0:
            if bool(eng.plane.state.sketch.table.any()):
                published = time.perf_counter() - t0
                break
            time.sleep(0.01)
        pending = eng.pending
        ref_eng = plane_engine("onepass", "sparse", num_streams=SUB_B)
        ref_eng.ingest(keys, vals)
        ref_eng.flush()
        ok = published is not None and pending == 0 \
            and states_equal(torch, eng.plane.state, ref_eng.state)
    eng.plane.close()
    log(f"[det] interval trigger (max_interval {INTERVAL_S} s, no drain): "
        f"published after "
        f"{'never' if published is None else f'{published:.3f} s'}, pending "
        f"{pending}, state equal to the sparse plane's flush bit for bit: "
        f"{ok} {tag}")
    if not ok or published < INTERVAL_S:
        raise AssertionError("the interval timer did not publish the stalled "
                             "tail as it should")
    return {"max_interval_s": INTERVAL_S, "published_s": published}


def phase_determinism(torch, steps, tag):
    """The deterministic flush path and the async and pipeline planes at the
    sparse plane's deployment.  Returns the launches of the det scatter and
    the segment sum on the deterministic main path, and the records of the
    kernels line and the ``[planes]`` line."""
    from repro_torch.engine import derive_stream_seeds, engine_spec
    from repro_torch.engine.engine import EngineConfig

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    out = {}
    cfg = EngineConfig(num_streams=B, rows=ROWS, width=WIDTH,
                       candidates=CANDIDATES, p=P)
    seeds, tseeds = derive_stream_seeds(cfg, device=dev)

    # -- 1. the det scatter at the flush and the TV cascade shapes --------
    keys = torch.from_numpy(steps[1][0]).to(dev)
    vals = torch.from_numpy(steps[1][1]).to(dev)
    out["scatter_flush"] = det_scatter_shape(torch, "flush shape", keys,
                                             vals, seeds, tseeds, 20, tag)
    tv = engine_spec(cfg._replace(sampler="tv")).init(
        *derive_stream_seeds(cfg, device=dev))
    r = tv.transform_seeds.shape[1]
    tv_seeds = tv.sketches.seed.reshape(-1).clone()
    tv_tseeds = tv.transform_seeds.reshape(-1).clone()
    del tv
    torch.cuda.empty_cache()
    out["scatter_tv"] = det_scatter_shape(
        torch, "TV cascade shape", keys.repeat_interleave(r, 0),
        vals.repeat_interleave(r, 0), tv_seeds, tv_tseeds, 5, tag)
    out["scatter_wide"] = det_wide_check(torch, keys, vals, seeds, tseeds,
                                         tag)
    del tv_seeds, tv_tseeds
    torch.cuda.empty_cache()
    out["scatter_split"] = det_split_scatter(torch, keys, vals, seeds, tseeds,
                                             tag)
    del keys, vals
    torch.cuda.empty_cache()
    out["segment_sum_flush"] = segment_sum_shape(torch, "flush shape", B,
                                                 tag)
    out["segment_sum_tv"] = segment_sum_shape(torch, "TV cascade shape",
                                              B * r, tag)
    out["nan_fill"] = [nan_fill_ms(torch, b, tag) for b in (B, B * r)]
    out["pytorch_sums"] = pytorch_sums_ms(
        torch, torch.from_numpy(steps[1][0]).to(dev),
        torch.from_numpy(steps[1][1]).to(dev), tag)
    torch.cuda.empty_cache()

    # -- 2. async against sparse, bit for bit, in the deterministic mode --
    launches = async_vs_sparse(torch, "onepass", steps, K, B, tag)
    flushes = len(steps)
    # the one-pass refresh keeps keys alone: no segment sum
    want = {"scatter": flushes, "smem": 0, "global": 0, "det": flushes,
            "segment_sum": 0, "estimate": flushes, "row_read": 0,
            "other": 0}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"deterministic onepass path launches "
                             f"{launches}, expected {want}")
    out["det_path_launches"] = launches
    for name, k in (("twopass", K), ("tv", TV_K), ("perfect", K)):
        async_vs_sparse(torch, name, steps, k, SUB_B, tag)
        torch.cuda.empty_cache()

    # -- 3. the overlap, measured in the default mode ---------------------
    out["overlap"] = {plane: overlap(torch, plane, steps, tag)
                      for plane in ("sparse", "async")}
    a, s = out["overlap"]["async"], out["overlap"]["sparse"]
    log(f"[overlap] async / sparse ingest rate "
        f"{a['events_per_s'] / s['events_per_s']:.3f} (one call, measured, "
        f"not claimed) {tag}")
    torch.cuda.empty_cache()

    # -- 4. the pipeline; 5. the interval timer ---------------------------
    out["pipeline"] = pipeline_checks(torch, steps, seeds, tseeds, tag)
    torch.cuda.empty_cache()
    out["interval"] = interval_check(torch, steps, tag)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[det] phase launches by variant on the deterministic onepass "
        f"path: det scatter {launches['det']}, shared-memory {launches['smem']}"
        f", global {launches['global']}, estimate {launches['estimate']}, "
        f"segment sum {launches['segment_sum']}")
    log(f"[phase] determinism, async and pipeline planes: "
        f"{out['wall_s']:.2f} s wall")
    return launches, out


# the conformance grid at the nightly operating point (``python -m
# repro_torch.validate --deep``): 384 trials, 3 x 384 oracle trials, every
# p, scheme, sampler and plane, and Table 3 at 12 randomizations
VALIDATE_TRIALS, VALIDATE_TABLE3_TRIALS = 384, 12
# --deep's codecs, at p = 1 (the fast suite's p): at run_suite's PS[0] =
# 0.5 the admissibility gate refuses q8 and size_adaptive
VALIDATE_CODECS, VALIDATE_CODEC_P = ("fp16", "q8", "size_adaptive"), 1.0
# the feeder: S producer shards, block_elems (the span), ring depth
FEED_SHARDS, FEED_BLOCK, FEED_PREFETCH = 4, 4096, 2


def uniform01_edge_pairs(torch, trials, seed, offset, n) -> int:
    """(trial, key) pairs of a trial seed bank whose ``uniform01`` is
    exactly 1.0 (the reference's fault, ROADMAP Queue 3), keys [0, n)."""
    from repro_torch.core import hashing
    from repro_torch.validate import empirics

    _, tseeds = empirics.derive_trial_seeds(trials, seed, offset,
                                            device=DEVICE)
    keys = torch.arange(n, dtype=torch.int64, device=tseeds.device)
    return int((hashing.uniform01(keys[None, :], tseeds[:, None])
                == 1.0).sum())


def phase_validate(torch, tag):
    """The conformance grid (``conformance.run_suite``'s, cell by cell
    through ``run_cell``, then ``check_table3_nrmse``) at the ``--deep``
    operating point on the card: one ``conformance_check`` line per check
    and the summary line, wall time by path and by sampler, launches by
    path, and the live threads after the grid.  Fails unless no check fails
    and every cell passes at least one.  Then a deterministic-mode cell:
    the async path's trials equal the ingest path's bit for bit.  Returns
    the grid's launches (summed over paths and Table 3) and the record of
    the ``[validate]`` line."""
    import threading

    from repro_torch.validate import conformance as C
    from repro_torch.validate import empirics
    from repro_torch.validate.__main__ import check_lines
    from repro_torch.validate.report import FAIL, PASS, build, summary_line

    t_phase = time.perf_counter()
    cfg = C.ConformanceConfig(trials=VALIDATE_TRIALS,
                              ref_trials=3 * VALIDATE_TRIALS, device=DEVICE)
    threads_before = threading.active_count()
    by_path, by_sampler, launches, cells = {}, {}, {}, {}
    samplers = list(C.available())
    results = []
    reset_counts()
    t0 = time.perf_counter()
    # run_suite's grid, one cell at a time, each timed and its launches read
    for name in samplers:
        for scheme in C.SCHEMES:
            for p in C.PS:
                for path in empirics.PATHS:
                    before = read_counts()
                    t1 = time.perf_counter()
                    cell = C.run_cell(name, scheme, p, path, cfg)
                    secs = time.perf_counter() - t1
                    got = since(before)
                    acc = launches.setdefault(path, dict.fromkeys(got, 0))
                    for key in got:
                        acc[key] += got[key]
                    by_path[path] = by_path.get(path, 0.0) + secs
                    by_sampler[name] = by_sampler.get(name, 0.0) + secs
                    cells[(name, scheme, p, path)] = [r.status for r in cell]
                    results.extend(cell)
    # the codec axis: the one-pass cells through the pipeline's and the
    # fleet's lossy merge boundaries, and the q2 control, at VALIDATE_CODEC_P
    for codec in VALIDATE_CODECS:
        for plane in C.CODEC_PLANES:
            before = read_counts()
            t1 = time.perf_counter()
            cell = C.run_codec_cell("onepass", C.SCHEMES[0],
                                    VALIDATE_CODEC_P, plane, codec, cfg)
            label = f"{plane}@{codec}"
            by_path[label] = time.perf_counter() - t1
            launches[label] = since(before)
            cells[("onepass", C.SCHEMES[0], VALIDATE_CODEC_P, label)] = [
                r.status for r in cell]
            results.extend(cell)
    results.append(C.codec_negative_control(C.SCHEMES[0], VALIDATE_CODEC_P,
                                            cfg))
    # ``run_suite(ps=PS)`` (``--deep``) puts these cells at PS[0] = 0.5,
    # where the admissibility gate refuses q8 and size_adaptive in both
    # packages (ROADMAP Queue 3): measured there, not gated
    gate = {codec: C.check_codec_admissible(
                "onepass", C.SCHEMES[0], C.PS[0], "pipeline",
                cfg._replace(codec=codec))
            for codec in VALIDATE_CODECS}
    for codec, r in gate.items():
        log(f"[validate] codec_admissible at p = {C.PS[0]:g} (measured, "
            f"not gated) {codec}: {r.status}, mean flip allowance "
            f"{r.details['mean_flip_allowance']:.4f}, relative bias "
            f"allowance {r.details['rel_bias_allowance']:.4f} {tag}")
    before = read_counts()
    results.extend(C.check_table3_nrmse(trials=VALIDATE_TABLE3_TRIALS,
                                        delta=cfg.delta, device=cfg.device))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches["table3"] = since(before)
    threads_after = threading.active_count()
    rep = build(results, {"suite": "repro_torch.validate",
                          "config": cfg._asdict(), "samplers": samplers,
                          "schemes": list(C.SCHEMES), "ps": list(C.PS),
                          "paths": list(empirics.PATHS),
                          "codecs": list(VALIDATE_CODECS),
                          "table3_trials": VALIDATE_TABLE3_TRIALS})
    for line in check_lines(rep):
        log(line)
    log(summary_line(rep))
    grid_s = sum(by_path.values())
    log(f"[validate] grid of {len(cells)} cells ({VALIDATE_TRIALS} trials, "
        f"{3 * VALIDATE_TRIALS} oracle trials) {grid_s:.2f} s, Table 3 "
        f"({VALIDATE_TABLE3_TRIALS} trials) {total_s - grid_s:.2f} s wall "
        f"{tag}")
    for what, secs in [*(("path " + k, v) for k, v in by_path.items()),
                       *(("sampler " + k, v) for k, v in by_sampler.items())]:
        log(f"[validate] {what}: {secs:.2f} s wall {tag}")
    for path, got in launches.items():
        log(f"[validate] launches on {path}: {got}")
    log(f"[validate] live threads: {threads_before} before the grid, "
        f"{threads_after} after")
    edge = {"table3": uniform01_edge_pairs(torch, VALIDATE_TABLE3_TRIALS,
                                           0x7AB3, 0, 10_000),
            "grid": sum(uniform01_edge_pairs(torch, t, cfg.seed, off, cfg.n)
                        for t, off in ((cfg.trials, 0),
                                       (cfg.ref_trials, cfg.ref_offset),
                                       (cfg.trials, 2 * cfg.ref_offset)))}
    log(f"[validate] (trial, key) pairs at the uniform01 == 1.0 edge under "
        f"the ppswor/priority transform seeds: Table 3 {edge['table3']} of "
        f"{VALIDATE_TABLE3_TRIALS * 10_000}, grid {edge['grid']} of "
        f"{(2 * cfg.trials + cfg.ref_trials) * cfg.n}")
    s = rep["summary"]
    no_pass = [c for c, st in cells.items() if PASS not in st]
    if s["failed"] or no_pass:
        for r in rep["results"]:
            if r["status"] == FAIL:
                log(f"[validate] FAIL {r['check']} {r['sampler']} "
                    f"{r['scheme']} p={r['p']:g} {r['path']}: "
                    f"{json.dumps(r['details'])}")
        raise AssertionError(f"conformance grid: {s['failed']} failed "
                             f"checks, cells without a pass: {no_pass}")
    for path in ("ingest", "async", "pipeline", "fleet",
                 *(f"{p}@{c}" for c in VALIDATE_CODECS
                   for p in C.CODEC_PLANES)):
        got = launches[path]
        if got["scatter"] <= 0 or got["smem"] <= 0 or got["estimate"] <= 0:
            raise AssertionError(f"conformance grid: the {path} path "
                                 f"launched {got}")
    if threads_after > threads_before:
        raise AssertionError(f"conformance grid: {threads_after} threads "
                             f"live after it, {threads_before} before")

    # -- the async path against the ingest path, bit for bit --------------
    freqs = empirics.zipf_freqs(64, 2.0, seed=3)
    spec = empirics.spec_for("onepass", 64, 4, 1.0, "ppswor")
    with deterministic_mode(torch):
        reset_counts()
        runs = {path: empirics.run_trials(spec, freqs, 4, 16, seed=5,
                                          path=path, device=DEVICE)
                for path in ("ingest", "async")}
        det = read_counts()
        ok = states_equal(torch, runs["ingest"][1], runs["async"][1]) \
            and samples_equal(torch, runs["ingest"][0], runs["async"][0])
    log(f"[validate] deterministic mode, onepass trials (n = 64, k = 4, 16 "
        f"trials, 3 chunks): async vs ingest, every state leaf and the "
        f"sample bit for bit: {ok}; launches {det} {tag}")
    if not ok or det["det"] != 2 * cfg.chunks:
        raise AssertionError("validate: the async path's trials differ from "
                             "the ingest path's in the deterministic mode")
    total = dict.fromkeys(read_counts(), 0)
    for got in launches.values():
        for key in total:
            total[key] += got[key]
    for key in total:
        total[key] += det[key]
    out = {"wall_s": time.perf_counter() - t_phase, "grid_s": grid_s,
           "table3_s": total_s - grid_s, "by_path_s": by_path,
           "by_sampler_s": by_sampler, "launches": launches,
           "summary": s, "threads": [threads_before, threads_after],
           "uniform01_edge_pairs": edge, "det_cell_launches": det,
           "codec_gate_at_p_half": {c: [r.status, r.details[
               "mean_flip_allowance"], r.details["rel_bias_allowance"]]
               for c, r in gate.items()}}
    log(f"[phase] validate: {out['wall_s']:.2f} s wall")
    return total, out


def phase_ingest(torch, seed, tag):
    """The feeder at the sparse plane's deployment: one canonical
    ``TurnstileZipfStream(2**20, alpha=1.2, delete_fraction=0.25)`` of
    STEPS x (4096 inserts + 1024 retractions), split over FEED_SHARDS
    producer shards, packed into (B, 4096) blocks broadcast to B = 4096
    streams.  Fan-in into ``sparse`` and ``async``, per-shard into
    ``pipeline``, each against the sparse plane's direct ingest of the same
    ragged stream (one flush a step), whose table is held to the plain
    scatter's: tables within the summing bounds,
    samples as ``compare_histories`` holds them; fan-in ``async`` equal to
    fan-in ``sparse`` bit for bit in the deterministic mode.  Prints
    events/s, ``pack_efficiency``, the producers' and the pump's wait and
    the busy share of a traced fan-in.  Returns the launches of its
    default-mode runs and of its deterministic runs, and the record of the
    ``[ingest]`` line."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.ingest_pipeline import (PrefetchingFeeder,
                                                  ShardedSource)
    from repro_torch.data.pipeline import TurnstileZipfStream
    from repro_torch.engine import EngineConfig, derive_stream_seeds

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    stream = TurnstileZipfStream(vocab_size=VOCAB, alpha=ALPHA, seed=seed,
                                 delete_fraction=DELETE_FRACTION)
    evs = [stream.events_at(t, INSERTS) for t in range(STEPS)]
    events = sum(k.size for k, _ in evs)
    steps = [(np.broadcast_to(k[None], (B, k.size)),
              np.broadcast_to(v[None], (B, v.size))) for k, v in evs]
    seeds, tseeds = derive_stream_seeds(
        EngineConfig(num_streams=B, rows=ROWS, width=WIDTH,
                     candidates=CANDIDATES, p=P), device=dev)
    out = {"events": events, "streams": B, "shards": FEED_SHARDS}

    def feed(plane, pershard=False, **opts):
        eng = plane_engine("onepass", plane, **opts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = PrefetchingFeeder(ShardedSource(evs, FEED_SHARDS), eng,
                                  block_elems=FEED_BLOCK,
                                  prefetch=FEED_PREFETCH,
                                  pershard=pershard).run()
        st = eng.state  # the pipeline's collapse
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rec = {"seconds": secs, "events_per_s": events * B / secs,
               "blocks": stats.blocks, "span": stats.span,
               "pack_efficiency": stats.pack_efficiency,
               "producer_wait_s": stats.producer_wait_s,
               "pump_wait_s": stats.pump_wait_s}
        log(f"[ingest] {'per-shard' if pershard else 'fan-in'} -> {plane}: "
            f"{events} events x {B} streams in {secs:.4f} s = "
            f"{rec['events_per_s']:.4e} events/s; {stats.blocks} blocks of "
            f"{stats.span}, pack_efficiency {stats.pack_efficiency:.4f}, "
            f"producers' wait {stats.producer_wait_s:.4f} s, pump's wait "
            f"{stats.pump_wait_s:.4f} s {tag}")
        return eng, st, rec

    # -- the reference: the sparse plane's direct ingest, one flush a step
    direct = plane_engine("onepass", "sparse")
    reset_counts()
    secs = drive_plane(torch, direct, steps)
    out["direct"] = {"seconds": secs, "events_per_s": events * B / secs,
                     "launches": read_counts()}
    log(f"[ingest] direct ingest -> sparse: {events} events x {B} streams in "
        f"{secs:.4f} s = {events * B / secs:.4e} events/s ({STEPS} flushes) "
        f"{tag}")
    ss = direct.state
    want, tol = flush_plain(torch, steps, seeds, tseeds)
    compare_tables(torch, "direct ingest -> sparse vs the plain scatter",
                   ss.sketch.table, want, tol)
    del want

    # -- fan-in into sparse and async, per-shard into pipeline ------------
    reset_counts()
    launches = {}
    for plane, pershard, opts in (("sparse", False, {}),
                                  ("async", False, {}),
                                  ("pipeline", True,
                                   {"shards": FEED_SHARDS})):
        before = read_counts()
        eng, st, rec = feed(plane, pershard, **opts)
        rec["launches"] = launches[plane] = since(before)
        what = (f"{'per-shard' if pershard else 'fan-in'} -> {plane} vs "
                f"direct ingest")
        rec["history_streams"] = compare_histories(torch, what, st, ss, tol,
                                                   seeds)
        if rec["launches"]["scatter"] < rec["blocks"] \
                or rec["launches"]["estimate"] < rec["blocks"]:
            raise AssertionError(f"{what}: launches {rec['launches']} for "
                                 f"{rec['blocks']} blocks")
        out[f"{'pershard' if pershard else 'fanin'}_{plane}"] = rec
        eng.plane.close()
        del eng, st
        torch.cuda.empty_cache()
    launches["direct"] = out["direct"]["launches"]
    main_launches = {key: sum(got[key] for got in launches.values())
                     for key in launches["direct"]}
    log(f"[ingest] launches: {launches}")
    for plane in ("async", "pipeline"):
        key = ("pershard_" if plane == "pipeline" else "fanin_") + plane
        log(f"[ingest] {key} / fanin_sparse events/s "
            f"{out[key]['events_per_s'] / out['fanin_sparse']['events_per_s']:.3f}"
            f"; fanin_sparse / direct "
            f"{out['fanin_sparse']['events_per_s'] / out['direct']['events_per_s']:.3f}"
            f" (one call, measured, not claimed) {tag}")
    del tol, ss, direct
    torch.cuda.empty_cache()

    # -- a traced fan-in into the sparse plane: every thread's ranges -----
    cfg = profiler_config(torch)
    eng = plane_engine("onepass", "sparse")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **({"experimental_config": cfg} if cfg else {})) as prof:
        t0 = time.perf_counter()
        PrefetchingFeeder(ShardedSource(evs, FEED_SHARDS), eng,
                          block_elems=FEED_BLOCK,
                          prefetch=FEED_PREFETCH).run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = trace_report(prof, RANGES, wall_ms, "fan-in -> sparse, whole feed",
                        tag, top=6)
    busy = sum(r[0] for r in rows if "Activity Buffer" not in r[2])
    out["traced"] = {"wall_ms": wall_ms, "busy_ms": busy,
                     "busy_share": busy / wall_ms if rows else None}
    del eng, prof
    torch.cuda.empty_cache()

    # -- fan-in async against fan-in sparse, bit for bit, deterministic ---
    engs = {}
    with deterministic_mode(torch):
        reset_counts()
        for plane in ("sparse", "async"):
            engs[plane] = plane_engine("onepass", plane)
            PrefetchingFeeder(ShardedSource(evs, FEED_SHARDS), engs[plane],
                              block_elems=FEED_BLOCK,
                              prefetch=FEED_PREFETCH).run()
        det = read_counts()
        ok = states_equal(torch, engs["sparse"].state, engs["async"].state) \
            and samples_equal(torch, engs["sparse"].sample(K),
                              engs["async"].sample(K))
    engs["async"].plane.close()
    log(f"[det] fan-in (B={B}, {FEED_SHARDS} shards): async vs sparse, every "
        f"state leaf and sample(k={K}) bit for bit: {ok}; launches {det} "
        f"{tag}")
    if not ok or det["det"] != det["scatter"] or det["det"] == 0:
        raise AssertionError("fan-in: async differs from sparse in the "
                             "deterministic mode")
    out["det_launches"] = det
    del engs
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase] ingest pipeline: {out['wall_s']:.2f} s wall")
    return main_launches, det, out


# -- the wire phase: codecs, the pipeline's codec, serving aggregation,
# checkpoints, the fleet plane ---------------------------------------------

CODECS = ("none", "fp16", "q8", "size_adaptive", "q2")
# the serving aggregation's worker counts (the butterfly, the tree), the
# pipeline's shards and the fleet's replicas
WIRE_WORKERS, WIRE_SHARDS, FLEET_REPLICAS = (4, 3), 4, 2
STAGES = ("d2h", "encode", "decode", "h2d")


def wire_cross(torch, cdc, st):
    """One wire crossing of every leaf of ``st``, stage by stage: the copy
    to the host, the codec's encode and decode (the reference's numpy
    code), the copy back.  Returns the decoded state on the card, the wire
    bytes and each stage's seconds."""
    from repro_torch.distributed import codecs as wc
    from repro_torch.distributed import pytree

    secs, out, nbytes = dict.fromkeys(STAGES, 0.0), [], 0
    for leaf in pytree.leaves(st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = wc.to_host(leaf)
        t1 = time.perf_counter()
        enc = cdc.encode_leaf(host)
        t2 = time.perf_counter()
        dec = wc.decode_leaf(enc)
        t3 = time.perf_counter()
        out.append(wc.to_tensor(dec, enc.dtype, leaf.device))
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, dt in zip(STAGES, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            secs[key] += dt
        nbytes += enc.nbytes
    return pytree.unflatten(st, out), nbytes, secs


def wire_codecs(torch, st, tag) -> dict:
    """(a) Every codec's roundtrip of the one-pass state: the library's
    ``Codec.roundtrip`` against the stage-by-stage crossing bit for bit,
    its wire bytes (``tree_nbytes``) and times; ``fake_quant`` on the card
    against the host grid (``==``: a q grid's -0 decodes to +0 through
    int8) and the CPU's ``fake_quant`` bit for bit, on the finite slices."""
    from repro_torch.distributed import codecs as wc

    table = st.sketch.table
    finite = table.isfinite().flatten(1).all(1)
    out = {}
    for name in CODECS:
        cdc = wc.get_codec(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lib = cdc.roundtrip(st)
        torch.cuda.synchronize()
        rt_s = time.perf_counter() - t0
        ref, nbytes, secs = wire_cross(torch, cdc, st)
        ok = states_equal(torch, lib, ref) and nbytes == cdc.tree_nbytes(st)
        rec = {"wire_mb": nbytes / 1e6, "roundtrip_ms": rt_s * 1e3,
               **{f"{k}_ms": v * 1e3 for k, v in secs.items()},
               "bitwise_host": ok}
        if cdc.rel_step:
            fq = cdc.fake_quant(table)
            host = ref.sketch.table
            cpu = cdc.fake_quant(table.cpu())
            rec["fake_quant_equal"] = bool((fq[finite] == host[finite]).all())
            rec["fake_quant_cpu_bitwise"] = same_bits(
                torch, fq[finite].cpu(), cpu[finite.cpu()])
            rec["nonfinite_slices_skipped"] = int((~finite).sum())
            ok = ok and rec["fake_quant_equal"] \
                and rec["fake_quant_cpu_bitwise"]
            del fq, cpu, host
        log(f"[wire] codec {name}: {nbytes / 1e6:.1f} MB on the wire "
            f"(raw {wc.tree_nbytes(st, 'none') / 1e6:.1f} MB); roundtrip "
            f"{rt_s * 1e3:.1f} ms (d2h {secs['d2h'] * 1e3:.1f}, encode "
            f"{secs['encode'] * 1e3:.1f}, decode {secs['decode'] * 1e3:.1f}, "
            f"h2d {secs['h2d'] * 1e3:.1f}); " + ", ".join(
                f"{k} {v}" for k, v in rec.items()
                if k.startswith(("bitwise", "fake", "nonfinite"))) + f" {tag}")
        if not ok:
            raise AssertionError(f"codec {name}: the roundtrip on the card "
                                 f"differs from the host's decode(encode)")
        out[name] = rec
        del lib, ref
        torch.cuda.empty_cache()
    return out


def union_samples_differ(torch, a, b) -> int:
    """Streams whose one-pass samples of ``a`` and ``b`` differ, both read
    over the union of their candidate buffers."""
    from repro_torch.engine.engine import onepass_sample_batched

    pool = union_pool(torch, a, b)
    sa, sb = (onepass_sample_batched(x._replace(cand_keys=pool), K, P)
              for x in (a, b))
    return int((~same_sets(torch, sa.keys, sb.keys)).sum())


def wire_pipeline(torch, steps, tag) -> dict:
    """(b) The pipeline (WIRE_SHARDS shards, PIPE_STEPS flushes, the same
    partition fed through ``ingest_shard``) under every codec, in the
    deterministic mode: the collapse equals the merge of the roundtripped
    shard states bit for bit (with ``none``, the plain merge); the streams
    whose samples differ from ``none``'s over the union of the buffers
    (measured).  Then a ``max_bytes`` budget of one raw step flushes at
    the encoded count (sparse plane, SUB_B streams)."""
    from repro_torch.distributed import codecs as wc
    from repro_torch.engine import FlushPolicy, planes

    parts = [planes.partition_by_key(k, v, WIRE_SHARDS)
             for k, v in steps[:PIPE_STEPS]]
    out, base = {}, None
    with deterministic_mode(torch):
        for name in CODECS:
            cdc = wc.get_codec(name)
            eng = plane_engine("onepass", "pipeline", shards=WIRE_SHARDS,
                               codec=name)
            for blocks in parts:
                for shard, (k, v) in enumerate(blocks):
                    eng.plane.ingest_shard(shard, k, v)
            eng.flush()
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = eng.state
            torch.cuda.synchronize()
            collapse_s = time.perf_counter() - t0
            launches = since(before)
            subs = [sub.state for sub in eng.plane._subplanes]
            want = cdc.roundtrip(subs[0])
            for sub in subs[1:]:
                want = eng.merge_fn(want, cdc.roundtrip(sub))
            ok = states_equal(torch, st, want)
            rec = {"collapse_ms": collapse_s * 1e3,
                   "collapse_launches": launches,
                   "equals_merge_of_roundtripped": ok}
            if base is None:
                base = st
            else:
                rec["streams_differing_from_none"] = union_samples_differ(
                    torch, st, base)
            log(f"[wire] pipeline ({WIRE_SHARDS} shards, {PIPE_STEPS} "
                f"flushes, B={B}) under {name}: collapse {collapse_s * 1e3:.1f}"
                f" ms, bit for bit the merge of the roundtripped shard "
                f"states: {ok}" + (f"; samples differing from none's over "
                                   f"the union of both buffers: "
                                   f"{rec['streams_differing_from_none']} of"
                                   f" {B} (measured)" if name != "none"
                                   else "") + f" {tag}")
            if not ok:
                raise AssertionError(f"pipeline under {name}: the collapse "
                                     f"differs from the merge of the "
                                     f"roundtripped shard states")
            out[name] = rec
            del eng, st, subs, want
            torch.cuda.empty_cache()
    del base
    # the byte budget counts wire bytes
    (k0, v0), (k1, v1) = ((k[:SUB_B], v[:SUB_B]) for k, v in steps[:2])
    budget = k0.nbytes + v0.nbytes
    for name in CODECS:
        cdc = wc.get_codec(name)
        eng = plane_engine("onepass", "sparse", num_streams=SUB_B,
                           policy=FlushPolicy(max_elems=None,
                                              max_bytes=budget), codec=name)
        eng.ingest(k0, v0)
        pending, nbytes = eng.pending, eng.plane.pending_bytes
        enc = cdc.payload_nbytes(k0) + cdc.payload_nbytes(v0)
        eng.ingest(k1, v1)
        ok = (pending == 0 if enc >= budget
              else pending == k0.shape[1] and nbytes == enc) \
            and eng.pending == 0
        log(f"[wire] max_bytes {budget} (one raw step, {SUB_B} streams) "
            f"under {name}: encoded step {enc} B, pending after it {pending} "
            f"({nbytes} B), after the next step {eng.pending}: {ok} {tag}")
        if not ok:
            raise AssertionError(f"max_bytes under {name} does not count the "
                                 f"encoded bytes")
        out[name]["max_bytes_step_bytes"] = enc
    return out


def wire_serving(torch, steps, single, tol, seeds, tag) -> dict:
    """(c) ``launch.serve``'s aggregation, the decode steps round-robin over
    W workers (the butterfly at 4, the tree at 3): against ``single``, the
    engine that saw every step, as ``compare_histories`` holds them; under
    q8 equal to the merge of the roundtripped worker states bit for bit;
    a worker of another seed raises."""
    from repro_torch.distributed import codecs as wc
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import serve

    cfg = plane_engine("onepass", "sparse", num_streams=1).cfg._replace(
        num_streams=B)
    out = {}
    for w in WIRE_WORKERS:
        workers = serve.make_worker_engines(cfg, w, device=DEVICE)
        before = read_counts()
        for t, (k, v) in enumerate(steps):
            workers[t % w].ingest(k, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merged = serve.aggregate_worker_states(workers)
        torch.cuda.synchronize()
        agg_s = time.perf_counter() - t0
        rec = {"aggregate_ms": agg_s * 1e3, "launches": since(before)}
        rec["history_streams"] = compare_histories(
            torch, f"serve aggregate ({w} workers, "
            f"{'butterfly' if w & (w - 1) == 0 else 'tree'}) vs one engine "
            f"of every step", merged, single, tol, seeds)
        del merged
        if w == WIRE_WORKERS[0]:
            q8 = wc.get_codec("q8")
            got = serve.aggregate_worker_states(workers, codec="q8")
            want = shd.merge_states([q8.roundtrip(x.state) for x in workers],
                                    workers[0].merge_fn)
            rec["q8_equals_merge_of_roundtripped"] = ok = states_equal(
                torch, got, want)
            del got, want
            rogue = plane_engine("onepass", "sparse")
            rogue.state = rogue.spec.init(
                (rogue.state.sketch.seed + 1) & 0xFFFFFFFF,
                (rogue.state.seed_transform + 1) & 0xFFFFFFFF)
            try:
                serve.aggregate_worker_states(workers + [rogue])
                raised = False
            except ValueError as err:
                raised = "seeds" in str(err)
            rec["other_seed_raises"] = raised
            log(f"[wire] serve aggregate ({w} workers) under q8 bit for bit "
                f"the merge of the roundtripped states: {ok}; a worker of "
                f"other seeds raises: {raised} {tag}")
            if not (ok and raised):
                raise AssertionError("serving aggregation under q8 or its "
                                     "seed guard failed")
            del rogue
        log(f"[wire] serve aggregate ({w} workers): {agg_s * 1e3:.1f} ms, "
            f"launches {rec['launches']} {tag}")
        out[str(w)] = rec
        del workers
        torch.cuda.empty_cache()
    return out


def finite_streams(torch, st):
    """(B,) streams whose every float cell is finite."""
    from repro_torch.engine.engine import _leaves

    fin = None
    for x in _leaves(st):
        if x.is_floating_point():
            f = x.reshape(x.shape[0], -1).isfinite().all(1)
            fin = f if fin is None else fin & f
    return fin


def check_restore(torch, what, name, st, back, codec, step):
    """A restored state against the saved one: bit for bit under ``none``,
    then the next sample and a further flush of ``step`` identical in the
    deterministic mode.  Under a lossy codec: bit for bit the codec's
    roundtrip, and within the codec's bound on the streams whose float
    cells are finite (a slice holding inf or NaN has no bound)."""
    from repro_torch.distributed import codecs as wc
    from repro_torch.engine.engine import _map

    if codec != "none":
        fin = finite_streams(torch, st)
        wc.assert_trees_within_codec(_map(lambda x: x[fin], back),
                                     _map(lambda x: x[fin], st), codec,
                                     label=what)
        log(f"[wire] {what}: within the codec's bound on "
            f"{int(fin.sum())} of {fin.numel()} streams (the rest hold "
            f"non-finite cells)")
        return states_equal(torch, back, wc.get_codec(codec).roundtrip(st))
    n = wc.pytree.leaves(st)[0].shape[0]
    engs = []
    for s in (st, back):
        eng = plane_engine(name, "sparse", num_streams=n)
        eng.state = s
        engs.append(eng)
    k = TV_K if name == "tv" else K
    with deterministic_mode(torch):
        ok = states_equal(torch, st, back) \
            and samples_equal(torch, engs[0].sample(k), engs[1].sample(k))
        for eng in engs:
            eng.ingest(step[0][:n], step[1][:n])
            eng.flush()
        ok = ok and states_equal(torch, engs[0].state, engs[1].state)
    return ok


def wire_checkpoints(torch, steps, st, tag) -> dict:
    """(d) Checkpoints in a temporary directory: the one-pass state at B
    streams under every codec, ``twopass``, ``tv`` and ``perfect`` on the
    first SUB_B streams under none and q8; ``payload_nbytes`` equals
    ``tree_nbytes``; save and restore MB/s; a flipped byte raises."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.distributed import codecs as wc
    from repro_torch.train import checkpoint

    d = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    out = {}
    try:
        states = [("onepass", st, CODECS)]
        for name in ("twopass", "tv", "perfect"):
            eng = plane_engine(name, "sparse", num_streams=SUB_B)
            drive_plane(torch, eng, steps, SUB_B)
            states.append((name, eng.state, ("none", "q8")))
        for name, s, codecs in states:
            n = wc.pytree.leaves(s)[0].shape[0]
            for codec in codecs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = checkpoint.save(d, 1, s, codec=codec)
                t1 = time.perf_counter()
                back = checkpoint.restore(d, 1, s, device=DEVICE)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                mb = checkpoint.payload_nbytes(path) / 1e6
                what = f"{name} (B={n}) checkpoint under {codec}"
                ok = checkpoint.payload_nbytes(path) == wc.tree_nbytes(
                    s, codec) and check_restore(torch, what, name, s, back,
                                                codec, steps[0])
                rec = {"wire_mb": mb, "save_mb_per_s": mb / (t1 - t0),
                       "restore_mb_per_s": mb / (t2 - t1), "ok": ok}
                log(f"[wire] {what}: {mb:.1f} MB, save {t1 - t0:.3f} s "
                    f"({rec['save_mb_per_s']:.1f} MB/s), restore "
                    f"{t2 - t1:.3f} s ({rec['restore_mb_per_s']:.1f} MB/s); "
                    f"{'bit for bit, the next sample and flush identical' if codec == 'none' else 'the roundtrip bit for bit, within the bound'}"
                    f": {ok} {tag}")
                if not ok:
                    raise AssertionError(f"{what} did not restore")
                out[f"{name}@{codec}"] = rec
                del back
                torch.cuda.empty_cache()
        # a flipped byte of the table's wire image
        path = checkpoint.save(d, 2, st, codec="q8")
        fn = os.path.join(path, "sketch.table.npy")
        arr = np.load(fn)
        arr[12345] ^= 0xFF
        np.save(fn, arr)
        try:
            checkpoint.restore(d, 2, st, device=DEVICE)
            raised = False
        except IOError:
            raised = True
        log(f"[wire] a flipped byte of the q8 table's wire image raises "
            f"IOError: {raised} {tag}")
        if not raised:
            raise AssertionError("a corrupt checkpoint restored")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


def wire_fleet(torch, steps, tag) -> dict:
    """(e) The fleet plane at R = FLEET_REPLICAS, PIPE_STEPS flushes, against
    the pipeline of as many shards, bit for bit in the deterministic mode,
    under none and q8 (one partition, fed through ``ingest_shard``)."""
    from repro_torch.engine import planes

    parts = [planes.partition_by_key(k, v, FLEET_REPLICAS)
             for k, v in steps[:PIPE_STEPS]]
    out = {}
    with deterministic_mode(torch):
        for codec in ("none", "q8"):
            engs = {}
            for plane, opt in (("fleet", "replicas"), ("pipeline", "shards")):
                eng = plane_engine("onepass", plane, codec=codec,
                                   **{opt: FLEET_REPLICAS})
                for blocks in parts:
                    for shard, (k, v) in enumerate(blocks):
                        eng.plane.ingest_shard(shard, k, v)
                eng.flush()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st = eng.state
                torch.cuda.synchronize()
                out[f"{plane}@{codec}_collapse_ms"] = \
                    (time.perf_counter() - t0) * 1e3
                engs[plane] = (eng, st)
            ok = states_equal(torch, engs["fleet"][1], engs["pipeline"][1]) \
                and samples_equal(torch, engs["fleet"][0].sample(K),
                                  engs["pipeline"][0].sample(K))
            scratch = engs["fleet"][0].plane._scratch
            engs["fleet"][0].plane.close()
            ok = ok and not os.path.exists(scratch)
            log(f"[wire] fleet (R={FLEET_REPLICAS}, {PIPE_STEPS} flushes, "
                f"B={B}) under {codec}: state and sample(k={K}) bit for bit "
                f"the pipeline's, scratch removed on close: {ok}; collapse "
                f"{out[f'fleet@{codec}_collapse_ms']:.1f} ms (pipeline "
                f"{out[f'pipeline@{codec}_collapse_ms']:.1f} ms) {tag}")
            if not ok:
                raise AssertionError(f"fleet under {codec} differs from the "
                                     f"pipeline")
            out[f"equal@{codec}"] = ok
            del engs
            torch.cuda.empty_cache()
    return out


def phase_wire(torch, steps, tag):
    """The wire phase at the sparse plane's deployment (B streams, the
    engine's defaults, the stream's STEPS steps): (a) codecs, (b) the
    pipeline's codec and the byte budget, (c) serving aggregation, (d)
    checkpoints, (e) the fleet plane.  Returns the scatter and estimate
    launches of each part (and of the whole phase) and the record of the
    ``[wire]`` line."""
    from repro_torch.engine import EngineConfig, derive_stream_seeds

    t_phase = time.perf_counter()
    seeds, tseeds = derive_stream_seeds(
        EngineConfig(num_streams=B, rows=ROWS, width=WIDTH,
                     candidates=CANDIDATES, p=P), device=torch.device(DEVICE))
    out, launches = {}, {}
    reset_counts()
    single = plane_engine("onepass", "sparse")
    drive_plane(torch, single, steps)
    st = single.state
    launches["ingest"] = read_counts()

    def serving():
        want, tol = flush_plain(torch, steps, seeds, tseeds)
        compare_tables(torch, "the engine of every step vs the plain "
                       "scatter", st.sketch.table, want, tol)
        del want
        return wire_serving(torch, steps, st, tol, seeds, tag)

    parts = (("codecs", lambda: wire_codecs(torch, st, tag)),
             ("pipeline", lambda: wire_pipeline(torch, steps, tag)),
             ("serving", serving),
             ("checkpoints", lambda: wire_checkpoints(torch, steps, st, tag)),
             ("fleet", lambda: wire_fleet(torch, steps, tag)))
    for name, fn in parts:
        t0 = time.perf_counter()
        before = read_counts()
        out[name] = fn()
        launches[name] = since(before)
        out[name + "_s"] = time.perf_counter() - t0
        log(f"[wire] ({name}) {out[name + '_s']:.2f} s wall, launches "
            f"{launches[name]} {tag}")
        torch.cuda.empty_cache()
    for name in ("ingest", "pipeline", "serving", "checkpoints", "fleet"):
        got = launches[name]
        if got["scatter"] <= 0 or got["estimate"] <= 0:
            raise AssertionError(f"wire phase ({name}): launches {got}")
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    total = {key: sum(got[key] for got in launches.values())
             for key in launches["ingest"]}
    log(f"[phase] wire: {out['wall_s']:.2f} s wall")
    return total, out


# -- the multi-process fleet ---------------------------------------------------

# the fleet phase: R = 2 replica processes over the deployment (replica 1
# killed after its 3rd block), R = 3 on the first SUB_B streams (cut) for
# the chaos scenarios; the fleet_serve subprocess's own time limit
FLEET_R, FLEET_PUBLISH, FLEET_KILL_AFTER = 2, 4, 3
CHAOS_R, CHAOS_STEPS, SERVE_TIMEOUT_S = 3, 8, 600
FLEET_SERVE_STEPS = 12  # cut from the CLI's default 24 (the script's time)


def fleet_config(num_streams=None, **kw):
    from repro_torch.distributed.fleet import FleetConfig
    from repro_torch.engine import EngineConfig

    base = dict(engine=EngineConfig(num_streams=num_streams or B, rows=ROWS,
                                    width=WIDTH, candidates=CANDIDATES, p=P),
                replicas=FLEET_R, publish_every=FLEET_PUBLISH,
                ack_timeout=60.0, ping_timeout=30.0, device=DEVICE)
    base.update(kw)
    return FleetConfig(**base)


def fleet_reference(torch, fcfg, steps, snapshot_after=None):
    """The in-process ``fleet`` plane of the same stream (the bitwise
    reference): its state, its sample(K), and, after ``snapshot_after``
    steps, a snapshot of its state; seconds of its ingest."""
    from repro_torch.engine import SketchEngine

    eng = SketchEngine(fcfg.engine, flush_elems=1, plane="fleet",
                       device=DEVICE, plane_opts={"replicas": fcfg.replicas})
    snap = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t, (keys, vals) in enumerate(steps):
        eng.ingest(keys, vals)
        if snapshot_after is not None and t + 1 == snapshot_after:
            snap = eng.state
    st = eng.state
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    samp = eng.sample(K)
    eng.plane.close()
    return st, samp, snap, secs


def run_fleet(torch, fcfg, steps, faults=None, script=None):
    """Drive a ``FleetCoordinator``: start (timed), route every step
    (``script(co, t)`` after step t), then ``merged_state()`` and
    ``sample(K)``.  Returns (state, sample, record); the record's launches
    are the coordinator's (this process, the run alone) and the replicas'
    (as they report them)."""
    from repro_torch.distributed.fleet import FleetCoordinator

    rec = {}
    before = read_counts()
    t0 = time.perf_counter()
    with FleetCoordinator(fcfg, faults=faults) as co:
        rec["start_wall_s"] = time.perf_counter() - t0
        info = co.replica_info
        t1 = time.perf_counter()
        for t, (keys, vals) in enumerate(steps):
            co.route(keys, vals)
            if script is not None:
                script(co, t)
        rec["route_wall_s"] = time.perf_counter() - t1
        t2 = time.perf_counter()
        st = co.merged_state()
        torch.cuda.synchronize()
        rec["merged_state_s"] = time.perf_counter() - t2
        samp = co.sample(K)
        stats = co.stats
    rec["coordinator_launches"] = since(before)
    events = sum(int((k != -1).sum()) for k, _ in steps)
    rec.update({
        "replica_info": info, "restarts": stats.restarts,
        "probes": stats.probes, "retries": stats.retries,
        "start_s": stats.start_s, "recover_s": stats.recover_s,
        "route_p50_ms": stats.latency_percentile(50) * 1e3,
        "route_p99_ms": stats.latency_percentile(99) * 1e3,
        "events": events,
        "events_per_s": events / max(sum(stats.route_s), 1e-9),
        "publishes": stats.publishes,
        "published_mb": stats.published_bytes / 1e6,
        "replica_launches": dict(stats.replica_launches)})
    return st, samp, rec


def fleet_line(what, rec, verdict, tag):
    log(f"[fleet] {what}: {verdict}; restarts "
        f"{rec['restarts']}, probes {rec['probes']}, retries "
        f"{rec['retries']}; replica starts "
        + ", ".join(f"{s:.2f}" for s in rec["start_s"])
        + " s (of them device context, engine and restore "
        + ", ".join(f"{i['init_s']:.2f}" for i in rec["replica_info"])
        + " s), recoveries " + ", ".join(f"{s:.2f}" for s in rec["recover_s"])
        + f" s; route p50 {rec['route_p50_ms']:.1f} ms, p99 "
        f"{rec['route_p99_ms']:.1f} ms, {rec['events_per_s']:.3e} events/s; "
        f"published {rec['published_mb']:.1f} MB in {rec['publishes']} "
        f"publishes; replicas' launches {rec['replica_launches']} {tag}")


def fleet_chaos(torch, steps, tag) -> dict:
    """R = 3 replicas on the first SUB_B streams (cut), deterministic mode:
    a hang found by the probe and recovered; a corrupt publish refused with
    IOError, a wrong-seed publish with ValueError, then healed; a slow
    replica under backpressure, no restart.  Each ends bit for bit the
    fleet plane's."""
    from repro_torch.distributed.fleet import FaultPlan

    sub = [(k[:SUB_B], v[:SUB_B]) for k, v in steps[:CHAOS_STEPS]]
    fcfg = fleet_config(SUB_B, replicas=CHAOS_R, publish_every=2,
                        ack_timeout=5.0, ping_timeout=2.0)
    want_st, want_s, _, _ = fleet_reference(torch, fcfg, sub)
    out = {}

    def rejections(co, t):
        if t != 2:
            return
        co.inject_fault(0, FaultPlan(corrupt_publish=True))
        try:
            co.merged_state()
        except IOError as e:
            out["corrupt_refused"] = str(e)
        co.inject_fault(0, FaultPlan(publish_wrong_seed=True))
        try:
            co.merged_state()
        except ValueError as e:
            out["wrong_seed_refused"] = str(e)[:80]
        co.inject_fault(0, FaultPlan())

    scenarios = (
        ("hang", fcfg, {0: FaultPlan(hang_after=2)}, None),
        ("rejections", fcfg, None, rejections),
        ("slow", fcfg._replace(queue_depth=1, publish_every=3,
                               ack_timeout=20.0, ping_timeout=5.0),
         {0: FaultPlan(delay_s=0.05)}, None))
    for name, cfg, faults, script in scenarios:
        st, samp, rec = run_fleet(torch, cfg, sub, faults, script)
        ok = states_equal(torch, st, want_st) and samples_equal(torch, samp,
                                                                want_s)
        fleet_line(f"R={CHAOS_R}, {SUB_B} streams (cut), {name}", rec,
                   f"bit for bit the fleet plane's: {ok}", tag)
        checks = {"hang": rec["restarts"] >= 1 and rec["probes"] >= 1,
                  "rejections": "corrupt_refused" in out
                  and "wrong_seed_refused" in out,
                  "slow": rec["restarts"] == 0}
        if not (ok and checks[name]):
            raise AssertionError(f"fleet chaos ({name}): bitwise {ok}, "
                                 f"scenario check {checks[name]}, {rec}")
        out[name] = rec
    log(f"[fleet] refused: corrupt publish ({out['corrupt_refused']}); "
        f"wrong-seed publish ({out['wrong_seed_refused']}...) {tag}")
    return out


# ``fleet_serve``'s two runs: the kill and restart at FLEET_SERVE_STEPS, and
# --topk 400, whose 5 x 12,400 table the det kernels split across blocks
# (a table the JAX CLI verifies at any --topk)
FLEET_SERVE_RUNS = (
    ("kill", ["--replicas", "2", "--kill-replica", "1", "--kill-after", "3",
              "--verify", "--steps", str(FLEET_SERVE_STEPS)]),
    ("topk 400", ["--replicas", "2", "--verify", "--topk", "400", "--steps",
                  "4"]))


def fleet_serve_run(tag) -> dict:
    """``python -m repro_torch.launch.fleet_serve`` with each of
    ``FLEET_SERVE_RUNS``' flags (the others at their defaults), on the
    card, in subprocesses run at once: each must exit 0 and print
    ``parity=bitwise`` and one summary line."""
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = {}
    for label, flags in FLEET_SERVE_RUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.fleet_serve",
               *flags] + (["--device", DEVICE] if DEVICE != "cuda" else [])
        procs[label] = (flags, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    out, failed = {}, []
    try:
        for label, (flags, t0, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=SERVE_TIMEOUT_S)
            secs = time.perf_counter() - t0
            lines = stdout.splitlines()
            summary = [ln for ln in lines
                       if ln.startswith("fleet_serve_summary,")]
            ok = proc.returncode == 0 and len(summary) == 1 and any(
                ln.startswith("parity=bitwise") for ln in lines)
            log(f"[fleet] fleet_serve {' '.join(flags)}: exit "
                f"{proc.returncode}, parity=bitwise printed: {ok}, "
                f"{secs:.1f} s wall (the {len(procs)} runs at once); "
                f"{summary[0] if summary else 'no summary'} {tag}")
            if not ok:
                failed.append(f"{label}:\n{stdout[-4000:]}\n"
                              f"{stderr[-4000:]}")
            out[label] = {"seconds": secs,
                          "summary": summary[0] if summary else None}
    finally:
        for _, _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    if failed:
        raise AssertionError("fleet_serve failed: " + "\n".join(failed))
    return out


def phase_fleet(torch, steps, tag):
    """The multi-process fleet at the sparse plane's deployment (B streams,
    the engine's defaults, the stream's STEPS steps): R = 2 replica
    processes on the card in the deterministic mode, replica 1 killed after
    its 3rd block, ``merged_state()`` and ``sample(K)`` bit for bit the
    in-process fleet plane's; the default (atomics) mode at R = 2 over
    PIPE_STEPS steps within the summing tolerances of the fleet plane's
    state at that point, samples equal but for near ties; the chaos
    scenarios at R = 3; ``fleet_serve --verify``.  Returns the launches
    of the coordinators and their replicas (as the replicas report them),
    and the record."""
    from repro_torch.distributed.fleet import FaultPlan
    from repro_torch.engine import EngineConfig, derive_stream_seeds

    t_phase = time.perf_counter()
    out = {}
    fcfg = fleet_config()
    runs = {}
    with deterministic_mode(torch):
        st, samp, rec = run_fleet(
            torch, fcfg, steps, {1: FaultPlan(kill_after=FLEET_KILL_AFTER)})
        want_st, want_s, snap, ref_s = fleet_reference(torch, fcfg, steps,
                                                       PIPE_STEPS)
        ok = states_equal(torch, st, want_st) and samples_equal(torch, samp,
                                                                want_s)
        det = all(i["deterministic"] and i["device"].split(":")[0] == DEVICE
                  for i in rec["replica_info"])
    rec["reference_ingest_s"] = ref_s
    fleet_line(f"R={FLEET_R}, B={B}, {len(steps)} steps, replica 1 killed "
               f"after {FLEET_KILL_AFTER} blocks, deterministic mode (every "
               f"replica on the card with the mode on: {det})", rec,
               f"bit for bit the fleet plane's: {ok}", tag)
    if not (ok and det and rec["restarts"] == 1):
        raise AssertionError(f"fleet (R={FLEET_R}) differs from the fleet "
                             f"plane: {rec}")
    launched = rec["replica_launches"]
    if launched.get("det", 0) <= 0 or launched.get("segment_sum", 0) \
            or launched.get("estimate", 0) <= 0 \
            or rec["coordinator_launches"]["estimate"] <= 0:
        raise AssertionError(f"fleet launches: replicas {launched}, "
                             f"coordinator {rec['coordinator_launches']}")
    out["deterministic"] = runs["deterministic"] = rec
    del st, samp, want_st, want_s
    torch.cuda.empty_cache()

    # the default (atomics) mode, recorded: within the summing tolerances
    st, samp, rec = run_fleet(torch, fcfg, steps[:PIPE_STEPS])
    seeds, tseeds = derive_stream_seeds(
        EngineConfig(num_streams=B, rows=ROWS, width=WIDTH,
                     candidates=CANDIDATES, p=P), device=torch.device(DEVICE))
    _, tol = flush_plain(torch, steps[:PIPE_STEPS], seeds, tseeds)
    rec["history_streams"] = compare_histories(
        torch, f"fleet R={FLEET_R} in the default mode ({PIPE_STEPS} steps) "
        f"vs the fleet plane (deterministic)", st, snap, tol, seeds)
    fleet_line(f"R={FLEET_R}, B={B}, {PIPE_STEPS} steps, default mode", rec,
               "within the summing tolerances of the fleet plane's state, "
               "samples but for near ties (not bitwise in this mode)", tag)
    out["default_mode"] = runs["default_mode"] = rec
    del st, samp, snap, tol
    torch.cuda.empty_cache()

    with deterministic_mode(torch):
        out["chaos"] = fleet_chaos(torch, steps, tag)
    for name in ("hang", "rejections", "slow"):
        runs[f"chaos_{name}"] = out["chaos"][name]
    out["fleet_serve"] = fleet_serve_run(tag)
    # the main path's launches: the coordinators' and their replicas', not
    # the reference planes' or the comparisons'
    total = dict.fromkeys(read_counts(), 0)
    for rec in runs.values():
        for got in (rec["coordinator_launches"], rec["replica_launches"]):
            for key, n in got.items():
                total[key] = total.get(key, 0) + n
    out["launches"] = {name: {"coordinator": rec["coordinator_launches"],
                              "replicas": rec["replica_launches"]}
                       for name, rec in runs.items()}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[fleet] launches: {out['launches']}; in all {total} {tag}")
    log(f"[phase] fleet: {out['wall_s']:.2f} s wall")
    return total, out


# -- WORp gradient compression -------------------------------------------------

GC_STEPS, GC_K_LEAF, GC_CAND_LEAF = 3, 32, 64  # gradcomp's defaults


class plain_kernels:
    """``kernels.ops``'s dense update and estimate swapped for their plain
    versions (``ref``) for the duration: the plain path of
    ``tree_compress_step_engine`` on the card."""

    def __init__(self):
        from repro_torch.kernels import ops, ref

        self.ops = ops
        self.swap = {
            "sketch_dense_batch": lambda v, rows, width, seeds, p=None,
            scheme="ppswor", transform_seeds=None, base_keys=None,
            lengths=None: ref.countsketch_update_batched_ref(
                v, rows, width, seeds, p=p, transform_seeds=transform_seeds,
                base_keys=base_keys, lengths=lengths, scheme=scheme),
            "estimate_batched": ref.countsketch_estimate_batched_ref}

    def __enter__(self):
        self.was = {k: getattr(self.ops, k) for k in self.swap}
        for k, fn in self.swap.items():
            setattr(self.ops, k, fn)
        return self

    def __exit__(self, *exc):
        for k, fn in self.was.items():
            setattr(self.ops, k, fn)
        return False


def gc_comm_bytes(L, k_leaf, ncand, codec) -> float:
    """The reference's wire formula for the engine path at a world of one
    (``gradcomp._comm_bytes`` of the L x rows x width table block and the
    L x k pass-II values, L scale slices each, plus L x ncand int32 ids),
    written out for the two codecs the phase runs."""
    if codec == "none":
        return 4.0 * (L * ROWS * WIDTH + L * k_leaf + L * ncand)
    if codec == "q8":
        return float(L * ROWS * WIDTH + 4 * L + L * k_leaf + 4 * L
                     + 4 * L * ncand)
    raise ValueError(codec)


def gc_gradients(torch, seed, steps):
    """One gemma2_2b layer's leaves (LEAVES, flat), made on the card: a
    fixed per-coordinate scale exp(1.5 g) per leaf times fresh N(0, 1)
    noise each step (the shape of ``make_gradients``)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    scales = {name: torch.exp(GRAD_LOG_SCALE * torch.randn(
        n, generator=gen, device=DEVICE)) for name, n in LEAVES}
    return [{name: scales[name] * torch.randn(n, generator=gen,
                                              device=DEVICE)
             for name, n in LEAVES} for _ in range(steps)]


def gc_check(torch, what, grads, err, sparse, new_err, k):
    """The two-pass invariants of one compression round: each leaf has 1
    to ``k`` nonzeros, the update equals a = g + e at them bit for bit, and
    ``sparse + err == a`` bit for bit."""
    for name in grads:
        a = grads[name].float() + err[name]
        s = sparse[name]
        nz = torch.nonzero(s).ravel()
        ok = 1 <= nz.numel() <= k and same_bits(torch, s[nz], a[nz]) \
            and same_bits(torch, s + new_err[name], a)
        if not ok:
            raise AssertionError(f"{what}: leaf {name} breaks the two-pass "
                                 f"invariants ({nz.numel()} nonzeros)")


def gc_ids_check(torch, what, grads, err, sparse, plain, tau_plain, cc):
    """The engine path's ids against the plain path's on the same inputs
    (the ``ref`` table and the plain estimate): per leaf the same set but
    for near ties -- an id in one set only must have |estimate| on the
    plain table within twice the leaf's largest table difference of the
    plain threshold.  Returns (leaves identical, leaves excused)."""
    from repro_torch.core import countsketch
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import gradcomp as G

    names = [name for name, _ in LEAVES]
    sizes = [n for _, n in LEAVES]
    L, n_max = len(sizes), max(sizes)
    a_pad = torch.zeros((L, n_max), device=DEVICE)
    for li, name in enumerate(names):
        a_pad[li, :sizes[li]] = grads[name].float() + err[name]
    t_seeds = torch.tensor([int(G._leaf_salt(cc, li)) for li in range(L)],
                           dtype=torch.int64, device=DEVICE)
    args = (a_pad, cc.rows, cc.width, t_seeds ^ 1)
    kw = dict(p=cc.p, transform_seeds=t_seeds, lengths=sizes)
    tk = ops.sketch_dense_batch(*args, **kw)
    tp = ref.countsketch_update_batched_ref(*args, **kw)
    _, _, ratio = cell_check(torch, tk, tp, ref.scatter_tolerance(
        *ref.countsketch_update_mass_ref(*args, **kw)))
    same = excused = 0
    for li, name in enumerate(names):
        got = set(torch.nonzero(sparse[name]).ravel().tolist())
        want = set(torch.nonzero(plain[name]).ravel().tolist())
        if got == want:
            same += 1
            continue
        band = 2.0 * float((tk[li] - tp[li]).abs().max())
        ids = torch.tensor(sorted(got ^ want), dtype=torch.int32,
                           device=DEVICE)
        est = countsketch.estimate(countsketch.CountSketch(
            table=tp[li], seed=t_seeds[li] ^ 1), ids).abs()
        gap = float((est - tau_plain[li]).abs().max())
        if gap > band:
            raise AssertionError(f"{what}: leaf {name}'s ids differ from "
                                 f"the plain path's outside near ties "
                                 f"(gap {gap:.3e} > band {band:.3e})")
        excused += 1
    log(f"[gradcomp] {what}: ids of {same}/{L} leaves identical to the "
        f"plain path's (ref table and plain estimate), {excused} differ "
        f"within a near tie; table worst err / cell bound {ratio:.3e}")
    return same, excused


def phase_gradcomp(torch, seed, tag):
    """WORp gradient compression of one gemma2_2b layer's 11 leaves at the
    published widths (cut: 1 layer of 26), over a one-rank NCCL group:
    GC_STEPS error-feedback steps of ``tree_compress_step_engine(k_per_leaf
    =32, cand_per_leaf=64)``, each applied by ``adamw.update`` to float32
    parameters; ``tree_compress_step`` and ``tree_compress_step_sharded``
    once each, and the engine path once under q8.  Gates: the two-pass
    invariants bit for bit, 1 to 32 nonzeros a leaf, the ids of the plain
    path but for near ties, ``comm_bytes`` by the reference's formula, 1
    update-kernel and 1 estimate launch per engine call."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.optim import adamw
    from repro_torch.optim import gradcomp as G

    t_phase = time.perf_counter()
    out = {"engine_ms": [], "adamw_ms": []}
    names = [name for name, _ in LEAVES]
    L = len(names)
    torch.cuda.reset_peak_memory_stats()
    steps = gc_gradients(torch, seed, GC_STEPS + 1)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 1)
    params = {name: 0.02 * torch.randn(n, generator=gen, device=DEVICE)
              for name, n in LEAVES}
    opt = adamw.init(params)
    err = G.init_error(params)
    cc = G.CompressorConfig()
    store_dir = tempfile.mkdtemp(prefix="chip-smoke-gradcomp-")
    dist.init_process_group(
        "nccl" if DEVICE == "cuda" else "gloo", store=dist.FileStore(
        os.path.join(store_dir, "store"), 1), rank=0, world_size=1)
    launches = {"update": 0, "estimate": 0}
    try:
        def engine(grads, e, cfg):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = G.tree_compress_step_engine(grads, e, cfg,
                                              k_per_leaf=GC_K_LEAF,
                                              cand_per_leaf=GC_CAND_LEAF)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = (u.launches, q.estimate_launches)
            if got != (1, 1) or read_counts()["scatter"] \
                    or read_counts()["segment_sum"]:
                raise AssertionError(f"gradcomp engine path: launches "
                                     f"{read_counts()}, expected 1 update "
                                     f"and 1 estimate")
            launches["update"] += 1
            launches["estimate"] += 1
            want = gc_comm_bytes(L, GC_K_LEAF, GC_CAND_LEAF, cfg.codec)
            if float(res[2]["comm_bytes"]) != want:
                raise AssertionError(f"comm_bytes {res[2]['comm_bytes']} "
                                     f"under {cfg.codec}, formula {want}")
            return res, ms

        for t in range(GC_STEPS):
            grads = steps[t]
            (sparse, new_err, stats), ms = engine(grads, err, cc)
            out["engine_ms"].append(ms)
            gc_check(torch, f"engine step {t}", grads, err, sparse, new_err,
                     GC_K_LEAF)
            with plain_kernels():
                plain, _, pstats = G.tree_compress_step_engine(
                    grads, err, cc, k_per_leaf=GC_K_LEAF,
                    cand_per_leaf=GC_CAND_LEAF)
            same, _ = gc_ids_check(torch, f"engine step {t}", grads, err,
                                   sparse, plain, pstats["tau"], cc)
            out.setdefault("leaves_identical", []).append(same)
            del plain, pstats
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt = adamw.update(params, sparse, opt)
            torch.cuda.synchronize()
            out["adamw_ms"].append((time.perf_counter() - t0) * 1e3)
            err = new_err
            nnz = sum(int(torch.count_nonzero(s)) for s in sparse.values())
            log(f"[gradcomp] engine step {t}: {ms:.1f} ms ({nnz} of "
                f"{sum(n for _, n in LEAVES)} coordinates kept, comm "
                f"{float(stats['comm_bytes']) / 1e6:.3f} MB vs dense "
                f"{float(stats['dense_bytes']) / 1e6:.1f} MB), adamw "
                f"{out['adamw_ms'][-1]:.1f} ms; invariants bit for bit {tag}")
            del sparse, new_err, stats
        if not all(bool(p.isfinite().all()) for p in params.values()):
            raise AssertionError("adamw: non-finite parameters")
        grads = steps[GC_STEPS]
        for name, fn, k in (
                ("flat", lambda: G.tree_compress_step(grads, err, cc), cc.k),
                ("sharded", lambda: G.tree_compress_step_sharded(
                    grads, err, cc, cand_per_leaf=GC_CAND_LEAF), cc.k)):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sparse, new_err, stats = fn()
            torch.cuda.synchronize()
            out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
            if any(read_counts().values()):
                raise AssertionError(f"gradcomp {name} path launched "
                                     f"kernels: {read_counts()}")
            for leaf in names:
                a = grads[leaf] + err[leaf]
                if not same_bits(torch, sparse[leaf] + new_err[leaf], a):
                    raise AssertionError(f"{name}: sparse + err != a")
            nnz = sum(int(torch.count_nonzero(s)) for s in sparse.values())
            if not 1 <= nnz <= k:
                raise AssertionError(f"{name}: {nnz} nonzeros")
            out[f"{name}_kept"] = nnz
            log(f"[gradcomp] {name} path (plain PyTorch, k={k}): "
                f"{out[f'{name}_ms']:.1f} ms, {nnz} kept, comm "
                f"{float(stats['comm_bytes']) / 1e6:.3f} MB; sparse + err "
                f"== a bit for bit {tag}")
            del sparse, new_err, stats
        (sparse, _, stats), ms = engine(grads, err, cc._replace(codec="q8"))
        out["engine_q8_ms"] = ms
        per_leaf = [int(torch.count_nonzero(sparse[n])) for n in names]
        if not all(1 <= c <= GC_K_LEAF for c in per_leaf):
            raise AssertionError(f"engine path under q8: nonzeros {per_leaf}")
        log(f"[gradcomp] engine path under q8: {ms:.1f} ms, comm "
            f"{float(stats['comm_bytes']) / 1e6:.3f} MB (formula), nonzeros "
            f"a leaf {per_leaf} {tag}")
        del sparse, stats
    finally:
        dist.destroy_process_group()
    out["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[gradcomp] peak {out['peak_mb']:.0f} MB; launches {launches} "
        f"{tag}")
    log(f"[phase] gradcomp: {out['wall_s']:.2f} s wall")
    return launches, out



def phase_det_update(torch, seed, tag):
    """The dense update's deterministic variant (#3/#4 "det") at the dense
    phase's shape, one gemma2_2b layer's 11 leaves (77.9 M live slots;
    **cut**: 1 layer of 26), values made on the card as
    ``gc_gradients``'s: in the deterministic mode three launches give the
    same bits, equal bit for bit to the order model
    (``ref.countsketch_update_det_ref`` at the plan's chunk, on the card)
    without the transform and, with it, fed the ppswor_transform kernel's
    values; each cell within its rounding bound of the plain version and
    of the shared-memory (atomics) variant.  Times of both variants
    (medians of 10 by CUDA events) beside the bound, at the layer and at
    one 21.2 M segment (#4, B = 1: the wg leaf, whose three launches give
    the order model's bits too).  Then ``update_dense`` and
    ``gradcomp.tree_compress_step_engine`` twice each in the mode (the
    launches counted from 0, the det variant required): the same bits both
    times."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch.engine import (EngineConfig, SketchEngine,
                                    derive_stream_seeds)
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ppswor_transform as tr
    from repro_torch.kernels import ref, tiling
    from repro_torch.optim import gradcomp as G

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    grads = gc_gradients(torch, seed + 11, 1)[0]
    sizes = [n for _, n in LEAVES]
    L, n_max, live = len(sizes), max(sizes), sum(sizes)
    v0 = torch.zeros((L, n_max), device=dev)
    for b, (name, n) in enumerate(LEAVES):
        v0[b, :n] = grads[name]
    cfg = EngineConfig(num_streams=L)
    seeds, tseeds = derive_stream_seeds(cfg, device=dev)
    lengths = torch.tensor(sizes, device=dev)
    plan = tiling.table_plan(L, n_max, np.asarray(sizes), ROWS, WIDTH,
                             tiling.sm_count(dev), "det", det_chunks=True)
    out = {"plan": plan._asdict(), "occupancy": OCCUPANCY.get(
        ("countsketch_update", "det"))}
    kw = dict(transform_seeds=tseeds, lengths=lengths)

    def det(p):
        before = dict(u.variant_launches)
        with deterministic_mode(torch):
            got = u.countsketch_update_batched(v0, ROWS, WIDTH, seeds, p=p,
                                               **kw)
        ran = {v: u.variant_launches[v] - before[v] for v in before}
        if ran != {"smem": 0, "global": 0, "det": 1}:
            raise AssertionError(f"det update: launched {ran}")
        return got

    # the order model, bit for bit: without the transform, and with the
    # values the ppswor_transform kernel gives (the det kernel's fused
    # transform is that kernel's)
    for p in (None, P):
        outs = [det(p) for _ in range(3)]
        torch.cuda.synchronize()
        identical = all(same_bits(torch, o, outs[0]) for o in outs[1:])
        vals = v0
        if p is not None:
            vals = torch.zeros_like(v0)
            for b, n in enumerate(sizes):
                vals[b, :n] = tr.ppswor_transform(
                    torch.arange(n, dtype=torch.int32, device=dev),
                    v0[b, :n].contiguous(), p, int(tseeds[b]))
        t0 = time.perf_counter()
        model = ref.countsketch_update_det_ref(vals, ROWS, WIDTH, seeds,
                                               lengths=lengths,
                                               chunk=plan.chunk)
        torch.cuda.synchronize()
        out["order_model_s"] = time.perf_counter() - t0
        equal = same_bits(torch, outs[0], model)
        log(f"[det] update gemma2_2b layer (L={L}, n_max={n_max}, {live} "
            f"live, p={p}): 3 launches in the deterministic mode, identical "
            f"bits: {identical}; equal to the order model (chunk "
            f"{plan.chunk}, {plan.blocks} blocks) bit for bit: {equal} "
            f"({out['order_model_s']:.2f} s) {tag}")
        if not (identical and equal):
            raise AssertionError(f"det update, p={p}: identical {identical}, "
                                 f"order model {equal}")
        del outs[1:], vals, model
    got = outs[0]
    want = ref.countsketch_update_batched_ref(v0, ROWS, WIDTH, seeds, p=P,
                                              **kw)
    tol = ref.scatter_tolerance(*ref.countsketch_update_mass_ref(
        v0, ROWS, WIDTH, seeds, p=P, **kw))
    out["max_abs_err"], out["worst_err_over_bound"] = check_sum(
        torch, "update gemma2_2b layer [det]", got, want, tol)
    atomics = u.countsketch_update_batched(v0, ROWS, WIDTH, seeds, p=P,
                                           _variant="smem", **kw)
    out["vs_atomics_max_abs_err"], out["vs_atomics_worst_err_over_bound"] = \
        check_sum(torch, "update gemma2_2b layer [det] vs [smem] (atomics)",
                  got, atomics, tol)
    del got, want, tol, atomics, outs
    torch.cuda.empty_cache()

    # times: the det variant, the atomics, the order model (its plain
    # version), beside the bound of the smem row; the kernels each a median
    # of 10 launches timed alone through their C entries (the wrapper reads
    # the lengths back to plan, which would put its host time in the window)
    out["ms"] = cuda_ms_median(torch, raw_update(
        torch, v0, seeds, tseeds, np.asarray(sizes), P, "det")[1])
    out["atomics_ms"] = cuda_ms_median(torch, raw_update(
        torch, v0, seeds, tseeds, np.asarray(sizes), P, "smem")[1])
    out["plain_ms"] = cuda_ms(torch, lambda: ref.countsketch_update_det_ref(
        v0, ROWS, WIDTH, seeds, p=P, chunk=plan.chunk, **kw), 1, warmup=0)
    out["bound_ms"], out["bound_by"] = bound(
        live * 4 + L * ROWS * WIDTH * 4, live * UPDATE_OPS_PER_SLOT)
    out["ratio_to_atomics"] = out["ms"] / out["atomics_ms"]
    log(f"[time] update gemma2_2b layer: det {out['ms']:.4f} ms "
        f"({100 * out['bound_ms'] / out['ms']:.1f} % of bound), shared-"
        f"memory atomics {out['atomics_ms']:.4f} ms "
        f"({100 * out['bound_ms'] / out['atomics_ms']:.1f} %), order model "
        f"(plain) {out['plain_ms']:.1f} ms, bound {out['bound_ms']:.4f} ms "
        f"by {out['bound_by']}; det / atomics {out['ratio_to_atomics']:.2f}x "
        f"(medians of 10) {tag}")

    # #4: the det kernel at one 21.2 M segment (the wg leaf, B = 1), the
    # same bits on every launch and the order model's, beside its bound and
    # the atomics
    b_wg = [name for name, _ in LEAVES].index("wg")
    wg = v0[b_wg]
    seg = {"n": wg.numel(), "plan": tiling.table_plan(
        1, wg.numel(), np.asarray([wg.numel()]), ROWS, WIDTH,
        tiling.sm_count(dev), "det", det_chunks=True)._asdict()}
    wseed, wtseed = int(seeds[b_wg]), int(tseeds[b_wg])
    with deterministic_mode(torch):
        before = (u.single_launches, u.variant_launches["det"])
        segs = [u.countsketch_update(wg, ROWS, WIDTH, wseed, p=None)
                for _ in range(3)]
        if (u.single_launches - before[0],
                u.variant_launches["det"] - before[1]) != (3, 3):
            raise AssertionError("det update B = 1: the det variant did not "
                                 "launch")
    torch.cuda.synchronize()
    model = ref.countsketch_update_det_ref(wg[None], ROWS, WIDTH, wseed,
                                           chunk=seg["plan"]["chunk"])[0]
    seg_same = all(same_bits(torch, o, segs[0]) for o in segs[1:])
    seg_equal = same_bits(torch, segs[0], model)
    del segs, model
    one = (v0[b_wg:b_wg + 1], seeds[b_wg:b_wg + 1], tseeds[b_wg:b_wg + 1],
           np.asarray([wg.numel()]), P)
    seg["ms"] = cuda_ms_median(torch, raw_update(torch, *one, "det")[1])
    seg["atomics_ms"] = cuda_ms_median(torch, raw_update(torch, *one,
                                                         "smem")[1])
    seg["bound_ms"], seg["bound_by"] = bound(
        wg.numel() * 4 + ROWS * WIDTH * 4, wg.numel() * UPDATE_OPS_PER_SLOT)
    seg["ratio_to_atomics"] = seg["ms"] / seg["atomics_ms"]
    seg["plain_ms"] = cuda_ms(torch, lambda: ref.countsketch_update_det_ref(
        wg[None], ROWS, WIDTH, wseed, p=P, transform_seeds=wtseed,
        chunk=seg["plan"]["chunk"]), 1, warmup=0)
    seg["library_ms"] = dense_library_ms(torch, wg[None], seeds[b_wg:b_wg + 1],
                                         tseeds[b_wg:b_wg + 1], [wg.numel()],
                                         ROWS, WIDTH)
    out["single_segment"] = seg
    log(f"[det] update B = 1, n = {wg.numel()}: 3 launches in the "
        f"deterministic mode, identical bits: {seg_same}; equal to the order "
        f"model (chunk {seg['plan']['chunk']}, {seg['plan']['blocks']} "
        f"blocks) bit for bit: {seg_equal} {tag}")
    log(f"[time] update B = 1, n = {wg.numel()}: det {seg['ms']:.4f} ms "
        f"({100 * seg['bound_ms'] / seg['ms']:.1f} % of bound), shared-"
        f"memory atomics {seg['atomics_ms']:.4f} ms, order model (plain) "
        f"{seg['plain_ms']:.1f} ms, index_add_ yardstick "
        f"{seg['library_ms']:.4f} ms, bound "
        f"{seg['bound_ms']:.4f} ms by {seg['bound_by']}; det / atomics "
        f"{seg['ratio_to_atomics']:.2f}x (medians of 10) {tag}")
    if not (seg_same and seg_equal):
        raise AssertionError(f"det update B = 1: identical {seg_same}, order "
                             f"model {seg_equal}")

    # tables too large for one det block, split across blocks
    out["split_tables"] = det_update_split(torch, v0, seeds, tseeds, sizes,
                                           tag)

    # the dense paths in the mode, launches counted from 0: update_dense and
    # the gradcomp engine step, twice each, the same bits
    reset_counts()
    states, ms = [], []
    with deterministic_mode(torch):
        for _ in range(2):
            eng = SketchEngine(cfg, plane="sparse", device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.update_dense(v0, lengths=lengths)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            states.append(eng.state)
    launches = {"update_dense": dict(u.variant_launches)}
    same = states_equal(torch, *states)
    out["update_dense_ms"] = ms
    log(f"[det] update_dense twice in the deterministic mode: "
        f"{ms[0]:.1f} / {ms[1]:.1f} ms, the same state bit for bit: {same}; "
        f"update launches {launches['update_dense']} {tag}")
    if not same or launches["update_dense"] != {"smem": 0, "global": 0,
                                                "det": 2}:
        raise AssertionError("update_dense in the deterministic mode")
    del states, eng, v0
    torch.cuda.empty_cache()
    store_dir = tempfile.mkdtemp(prefix="chip-smoke-det-update-")
    dist.init_process_group(
        "nccl" if DEVICE == "cuda" else "gloo", store=dist.FileStore(
        os.path.join(store_dir, "store"), 1), rank=0, world_size=1)
    reset_counts()
    try:
        err = G.init_error(grads)
        res, ms = [], []
        with deterministic_mode(torch):
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sparse, new_err, _ = G.tree_compress_step_engine(
                    grads, err, G.CompressorConfig(), k_per_leaf=GC_K_LEAF,
                    cand_per_leaf=GC_CAND_LEAF)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                res.append((sparse, new_err))
    finally:
        dist.destroy_process_group()
    launches["gradcomp"] = dict(u.variant_launches)
    same = all(same_bits(torch, res[0][i][n], res[1][i][n])
               for i in (0, 1) for n in grads)
    out["gradcomp_ms"] = ms
    log(f"[det] gradcomp engine step twice in the deterministic mode: "
        f"{ms[0]:.1f} / {ms[1]:.1f} ms, the same sparse and error bit for "
        f"bit: {same}; update launches {launches['gradcomp']} {tag}")
    if not same or launches["gradcomp"] != {"smem": 0, "global": 0,
                                            "det": 2}:
        raise AssertionError("gradcomp engine step in the deterministic "
                             "mode")
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase] det update: {out['wall_s']:.2f} s wall")
    return out


def dense_library_ms(torch, vals, seeds, tseeds, lens, rows, width):
    """The dense update's index_add_ yardstick (memory half only): the
    (B, n) ``vals``' live slots' flat (stream, row, bucket) indices and
    signed transformed values precomputed, one ``index_add_`` into a
    zeroed rows x width table a stream, timed by CUDA events."""
    from repro_torch.core import hashing, transforms

    dev = vals.device
    per = torch.tensor(lens, device=dev)
    keys = torch.cat([torch.arange(n, dtype=torch.int32, device=dev)
                      for n in lens])
    slot_seeds = seeds.repeat_interleave(per)
    tv = transforms.transform_values(keys, torch.cat(
        [vals[b, :n] for b, n in enumerate(lens)]), P,
        tseeds.repeat_interleave(per))
    base = torch.arange(len(lens), device=dev).repeat_interleave(per) \
        * (rows * width)
    idx, sv = [], []
    for r in range(rows):
        salt = hashing.row_salt(slot_seeds, r)
        idx.append(base + r * width + hashing.bucket_hash(keys, salt, width))
        sv.append(tv * hashing.sign_hash(keys, salt))
    idx, sv = torch.cat(idx), torch.cat(sv)
    del keys, slot_seeds, base, tv
    flat = torch.zeros(len(lens) * rows * width, device=dev)
    return cuda_ms(torch, lambda: flat.zero_().index_add_(0, idx, sv), 5)


def det_update_split(torch, v0, seeds, tseeds, sizes, tag) -> dict:
    """The dense det update on ``SPLIT_DENSE``'s tables, too large for one
    block: the gemma2_2b layer's 11 leaves at 7 x 16,384 (row groups) and
    the wg leaf's 21.2 M segment at 1 x 100,000 (bucket ranges).  Three
    launches in the mode give the same bits, each counted as one det
    launch; they are the order model's (``ref.countsketch_update_det_ref``
    at the plan's chunk, on the card) bit for bit without the transform and
    fed the ppswor_transform kernel's values with it; each cell lies within
    its rounding bound of the plain version.  Times (medians of 10 by CUDA
    events): the det kernel through its C entry, the global atomics (the
    default mode's variant at these widths) through the wrapper, which
    reads no lengths back for them; the order model (plain) once; the
    index_add_ yardstick; beside the bound."""
    import numpy as np
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ppswor_transform as tr
    from repro_torch.kernels import ref, tiling

    dev = v0.device
    b_wg = [name for name, _ in LEAVES].index("wg")
    out = {}
    for rows, width, shape in SPLIT_DENSE:
        if shape == "layer":
            vals, sd, td, lens = v0, seeds, tseeds, list(sizes)
        else:
            vals, sd, td = (x[b_wg:b_wg + 1] for x in (v0, seeds, tseeds))
            lens = [sizes[b_wg]]
        Bs = vals.shape[0]
        lengths = torch.tensor(lens, device=dev)
        plan = tiling.table_plan(Bs, vals.shape[1], np.asarray(lens), rows,
                                 width, tiling.sm_count(dev), "det",
                                 det_chunks=True)
        if not plan.row_group:
            raise AssertionError(f"det update {rows} x {width} is not split")
        what = f"{shape} {rows} x {width}"
        rec = {"rows": rows, "width": width, "streams": Bs,
               "live": int(sum(lens)), "plan": plan._asdict(),
               "parts": tiling.det_parts(plan, rows)}
        kw = dict(transform_seeds=td, lengths=lengths)
        for p in (None, P):
            outs = []
            for _ in range(3):
                before = dict(u.variant_launches)
                with deterministic_mode(torch):
                    outs.append(u.countsketch_update_batched(
                        vals, rows, width, sd, p=p, **kw))
                ran = {x: u.variant_launches[x] - before[x] for x in before}
                if ran != {"smem": 0, "global": 0, "det": 1}:
                    raise AssertionError(f"det update {what}: launched {ran}")
            torch.cuda.synchronize()
            identical = all(same_bits(torch, o, outs[0]) for o in outs[1:])
            del outs[1:]
            tvals = vals
            if p is not None:
                tvals = torch.zeros_like(vals)
                for b, n in enumerate(lens):
                    tvals[b, :n] = tr.ppswor_transform(
                        torch.arange(n, dtype=torch.int32, device=dev),
                        vals[b, :n].contiguous(), p, int(td[b]))
            equal = same_bits(torch, outs[0], ref.countsketch_update_det_ref(
                tvals, rows, width, sd, lengths=lengths, chunk=plan.chunk))
            del tvals
            log(f"[det] update {what} (B={Bs}, {rec['live']} live, split "
                f"into {rec['parts']} blocks a chunk: row group "
                f"{plan.row_group}, ranges {plan.ranges}, chunk {plan.chunk}, "
                f"{plan.blocks} blocks; p={p}): 3 launches identical: "
                f"{identical}; equal to the order model bit for bit: {equal} "
                f"{tag}")
            if not (identical and equal):
                raise AssertionError(f"det update {what}, p={p}: identical "
                                     f"{identical}, order model {equal}")
        want = ref.countsketch_update_batched_ref(vals, rows, width, sd, p=P,
                                                  **kw)
        tol = ref.scatter_tolerance(*ref.countsketch_update_mass_ref(
            vals, rows, width, sd, p=P, **kw))
        rec["max_abs_err"], rec["worst_err_over_bound"] = check_sum(
            torch, f"update {what} [det, split]", outs[0], want, tol)
        del outs, want, tol
        torch.cuda.empty_cache()
        rec["ms"] = cuda_ms_median(torch, raw_update(
            torch, vals, sd, td, np.asarray(lens), P, "det", rows=rows,
            width=width)[1])
        rec["atomics_ms"] = cuda_ms_median(
            torch, lambda: u.countsketch_update_batched(
                vals, rows, width, sd, p=P, _variant="global", **kw))
        rec["plain_ms"] = cuda_ms(
            torch, lambda: ref.countsketch_update_det_ref(
                vals, rows, width, sd, p=P, chunk=plan.chunk, **kw), 1,
            warmup=0)
        rec["library_ms"] = dense_library_ms(torch, vals, sd, td, lens, rows,
                                             width)
        rec["bound_ms"], rec["bound_by"] = bound(
            rec["live"] * 4 + Bs * rows * width * 4,
            rec["live"] * slot_ops(rows))
        rec["ratio_to_atomics"] = rec["ms"] / rec["atomics_ms"]
        log(f"[time] update {what}: det (split) {rec['ms']:.4f} ms "
            f"({100 * rec['bound_ms'] / rec['ms']:.1f} % of bound), global "
            f"atomics {rec['atomics_ms']:.4f} ms "
            f"({100 * rec['bound_ms'] / rec['atomics_ms']:.1f} %), order "
            f"model (plain) {rec['plain_ms']:.1f} ms, index_add_ yardstick "
            f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']}; det / atomics {rec['ratio_to_atomics']:.2f}x"
            f" (medians of 10) {tag}")
        out[what] = rec
        torch.cuda.empty_cache()
    return out


def raw_update(torch, vals, seeds, tseeds, lens, p, variant, plan_mod=None,
               fn=None, rows=ROWS, width=WIDTH):
    """The plan and a closure that launches the dense update's ``variant``
    ("det" or "smem") once through its C entry on (B, n) ``vals`` with host
    ``lens`` into a rows x width table: no wrapper work (the seeds, lengths
    and chunk ends on the card once, before), so CUDA events around a call
    time the kernel, and for "det" its chunk-sum pass, alone.  ``plan_mod``
    is the ``tiling`` module of the checkout whose entry ``fn`` is (this
    tree's by default; a checkout whose plans have no ``row_group`` takes
    the det entry without the split's two arguments)."""
    import numpy as np
    from repro_torch.core import hashing
    from repro_torch.kernels import build, tiling
    from repro_torch.kernels import countsketch_update as u

    dev = vals.device
    plan_mod = plan_mod or tiling
    B, n = vals.shape
    plan = plan_mod.table_plan(B, n, lens, rows, width, tiling.sm_count(dev),
                               variant, det_chunks=True)
    split = () if variant != "det" or not hasattr(plan, "row_group") \
        else (plan.row_group, plan.ranges)
    cluster = getattr(plan, "cluster", 0) if variant == "det" else 0
    if cluster:  # a thread block cluster a chunk: its own entry
        split += (cluster, tiling.det_clash_bits(plan, width))
    if fn is None:
        fn = build.function(
            "countsketch_update", f"worp_countsketch_update_{variant}"
            + ("_cluster" if cluster else ""),
            u._DET_CLUSTER_ARGTYPES if cluster
            else u._DET_ARGTYPES if variant == "det" else u._SMEM_ARGTYPES)
    s32, t32 = hashing.int32_arg(seeds, B, dev), hashing.int32_arg(tseeds, B,
                                                                   dev)
    base32 = torch.zeros(B, dtype=torch.int32, device=dev)
    lens32 = tiling.lengths_arg(lens, B, n, dev)
    ends = None if plan.one_per_stream else torch.from_numpy(
        tiling.block_ends(lens, plan.chunk).astype(np.int32)).to(dev)
    chunks = plan.blocks // (plan_mod.det_parts(plan, rows) if split else 1)
    work = None if plan.one_per_stream or variant != "det" else torch.empty(
        (chunks, rows, width), device=dev)
    delta = torch.empty((B, rows, width), device=dev)
    ptrs = [vals.data_ptr(), s32.data_ptr(), t32.data_ptr(),
            base32.data_ptr(), lens32.data_ptr(),
            None if ends is None else ends.data_ptr()]
    if variant == "det":
        ptrs.append(None if work is None else work.data_ptr())
    args = (*ptrs, delta.data_ptr(), B, n, rows, width, plan.chunk,
            int(p is not None), -1.0 / p if p is not None else 0.0, 0,
            *split, plan.blocks, plan.threads, plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)

    def go(owners=(s32, t32, base32, lens32, ends, work)):
        # ``owners`` keeps the tensors behind the pointers alive
        if variant == "smem" and not plan.one_per_stream:
            delta.zero_()  # the chunks add into a zeroed delta
        err = fn(*args)
        if err:
            raise RuntimeError(f"update ({variant}): CUDA error {err}")
        return delta
    return plan, go


def det_parent_ab(torch, others: list, seed: int) -> int:
    """``--det-parent DIR [DIR ...]``: the dense update's det kernel of
    other checkouts (each DIR's ``countsketch_update.cu`` built here, all
    at once, and launched with its own ``tiling`` plan) beside this tree's,
    in one process on one card, at the gemma2_2b layer (11 streams, 77.9 M
    live slots) and at one 21.2 M segment (#4, B = 1), with and without the
    transform: each gives its order model's bits
    (``ref.countsketch_update_det_ref`` at its plan's chunk), and each is
    timed in turns (the others, this, this, the others in reverse), 10
    back-to-back launches a turn, beside the atomics variant and the bound.
    All take the same C entry, launched raw, so no wrapper time is in any
    window.  Prints each det kernel's registers, occupancy and static SASS
    opcode counts (``cuobjdump -sass``)."""
    import collections
    import ctypes
    import importlib.util
    import re

    import numpy as np
    from repro_torch.engine import EngineConfig, derive_stream_seeds
    from repro_torch.kernels import build, ref, tiling
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ppswor_transform as tr

    smi = card_info()
    tag = f"[{smi}]"
    log(smi)
    dev = torch.device(DEVICE)
    ab_sources = ("countsketch_update", "countsketch_scatter",
                  "countsketch_query")
    built = build.build_all((*ab_sources, "ppswor_transform"))
    libs = {"this": built["countsketch_update"].path}
    others_libs = {"this": {src: built[src].path for src in ab_sources}}
    out_dir = build.BUILD_DIR / "det_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for d in others:
        for src in ab_sources:
            lib = out_dir / f"lib{src}_{d.name}.so"
            jobs[(d.name, src)] = (d, lib, subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                 str(d / f"src/repro_torch/kernels/csrc/{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    versions, mods = {}, {"this": tiling}
    for (label, src), (d, lib, proc) in jobs.items():
        text, _ = proc.communicate(timeout=600)
        for line in text.splitlines():
            if "_det" in line or "query_kernel" in line or "Used" in line:
                log(f"[build] {label} {src}: {line.strip()}")
        if proc.returncode:
            raise RuntimeError(f"{d}: {src}.cu did not build")
        others_libs.setdefault(label, {})[src] = lib
        if src != "countsketch_update":
            continue
        spec = importlib.util.spec_from_file_location(
            f"tiling_{label}", d / "src/repro_torch/kernels/tiling.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods[label] = mod
        clib = ctypes.CDLL(str(lib))
        versions[label] = (mod, clib.worp_countsketch_update_det,
                           clib.worp_countsketch_update_info)
        libs[label] = lib
    clib = ctypes.CDLL(str(libs["this"]))
    versions["this"] = (tiling, clib.worp_countsketch_update_det,
                        clib.worp_countsketch_update_info)
    for mod, fn, info in versions.values():
        # a checkout without the det split takes its entry without the
        # split's two int arguments (row_group, ranges)
        fn.argtypes = u._DET_ARGTYPES if splits(mod) \
            else u._DET_ARGTYPES[:16] + u._DET_ARGTYPES[18:]
        fn.restype = ctypes.c_int
        info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]
        info.restype = ctypes.c_int
    jobs = {label: None for label in mods if label != "this"}
    order = [*jobs, "this", "this", *reversed(jobs)]
    report = {"card": smi, "sass": {}}
    cuobjdump = str(Path(build.nvcc()).parent / "cuobjdump")
    for label, lib in libs.items():
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for body in sass.split("Function : ")[1:]:
            name = body.split()[0]
            if "countsketch_update_det" not in name:
                continue
            ops = collections.Counter()
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", body):
                words = m.group(1).split()
                op = (words[1] if words[0].startswith("@") else
                      words[0]).split(".")[0]
                ops[op] += op != "NOP"
            top = dict(ops.most_common())
            report["sass"][f"{label} {name[-40:]}"] = top
            (out_dir / f"{label}.sass").write_text(body)
            log(f"[sass] {label} {name[-40:]}: {sum(top.values())} "
                f"instructions: " + ", ".join(f"{k} {v}" for k, v in
                                              list(top.items())[:16]))

    grads = gc_gradients(torch, seed + 11, 1)[0]
    sizes = [n for _, n in LEAVES]
    L, n_max = len(sizes), max(sizes)
    v0 = torch.zeros((L, n_max), device=dev)
    for b, (name, n) in enumerate(LEAVES):
        v0[b, :n] = grads[name]
    del grads
    seeds, tseeds = derive_stream_seeds(EngineConfig(num_streams=L),
                                        device=dev)
    b_wg = [name for name, _ in LEAVES].index("wg")
    shapes = {"layer": (v0, seeds, tseeds, np.asarray(sizes)),
              "segment": (v0[b_wg:b_wg + 1], seeds[b_wg:b_wg + 1],
                          tseeds[b_wg:b_wg + 1], np.asarray([n_max]))}

    ok = True
    for shape, (vals, sd, td, lens) in shapes.items():
        B = vals.shape[0]
        live = int(lens.sum())
        rec = {"live": live}
        rec["bound_ms"], rec["bound_by"] = bound(
            live * 4 + B * ROWS * WIDTH * 4, live * UPDATE_OPS_PER_SLOT)
        for p in (None, P):
            tvals = vals
            if p is not None:
                tvals = torch.zeros_like(vals)
                for b in range(B):
                    n = int(lens[b])
                    tvals[b, :n] = tr.ppswor_transform(
                        torch.arange(n, dtype=torch.int32, device=dev),
                        vals[b, :n].contiguous(), p, int(td[b]))
            gos = {}
            for label, (mod, fn, _) in versions.items():
                plan, go = raw_update(torch, vals, sd, td, lens, p, "det",
                                      mod, fn)
                outs = [go().clone() for _ in range(3)]
                torch.cuda.synchronize()
                model = ref.countsketch_update_det_ref(
                    tvals, ROWS, WIDTH, sd, lengths=torch.from_numpy(lens),
                    chunk=plan.chunk)
                same = all(same_bits(torch, o, outs[0]) for o in outs[1:])
                equal = same_bits(torch, outs[0], model)
                ok = ok and same and equal
                log(f"[det-ab] {shape} p={p} {label}: plan {plan.blocks} "
                    f"blocks x {plan.threads} threads, chunk {plan.chunk}, "
                    f"{plan.smem_bytes} B; 3 launches identical: {same}; "
                    f"the order model's bits: {equal} {tag}")
                rec[f"{label}_plan_p{p}"] = plan._asdict()
                gos[label] = go
                del outs, model
            turns = [(label, cuda_ms(torch, gos[label], 10))
                     for label in order]
            for label in versions:
                rec[f"{label}_ms_p{p}"] = [t for lab, t in turns
                                           if lab == label]
            log(f"[det-ab] {shape} p={p}: " + ", ".join(
                f"{lab} {t:.4f} ms" for lab, t in turns)
                + f"; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
                f"{tag}")
            del tvals, gos
        rec["atomics_ms"] = cuda_ms(torch, raw_update(
            torch, vals, sd, td, lens, P, "smem")[1], 10)
        log(f"[det-ab] {shape}: shared-memory atomics {rec['atomics_ms']:.4f}"
            f" ms at p={P} {tag}")
        report[shape] = rec
    ok = split_update_ab(torch, others_libs, mods, order, report, tag, v0,
                         seeds, tseeds, sizes) and ok
    del v0
    torch.cuda.empty_cache()
    for label, (mod, _, info) in versions.items():
        plan = mod.table_plan(L, n_max, np.asarray(sizes), ROWS, WIDTH, 132,
                              "det", det_chunks=True)
        buf = (ctypes.c_int * 4)()
        if info(2, plan.threads, plan.smem_bytes, ctypes.addressof(buf)):
            raise RuntimeError(f"{label}: kernel info failed")
        occ = dict(zip(("registers", "static_smem", "blocks_per_sm",
                        "max_dynamic_smem"), buf))
        report[f"{label}_occupancy"] = dict(occ, threads=plan.threads,
                                            dynamic_smem=plan.smem_bytes)
        log(f"[occupancy] countsketch_update det ({label}): "
            f"{occ['registers']} registers a thread, {plan.threads} threads, "
            f"dynamic smem {plan.smem_bytes} B, {occ['blocks_per_sm']} "
            f"blocks per SM {tag}")
    sq_ok = scatter_query_ab(torch, others_libs, mods, order, report, tag)
    log("[det-ab] " + json.dumps(report))
    return 0 if ok and sq_ok else 1


def raw_scatter(torch, lib_path, mod, keys, vals, s32, t32, lens32, rows,
                width, p):
    """The det plan of the checkout whose ``tiling`` is ``mod`` and a
    closure that launches its det scatter (library ``lib_path``) once,
    raw through its C entry, into one ``torch.empty`` delta: the cluster
    entry where the plan is a cluster's, else the det entry (without the
    split's arguments for a checkout that has none)."""
    import ctypes

    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import tiling

    B, n = keys.shape
    plan = mod.table_plan(B, n, None, rows, width,
                          tiling.sm_count(keys.device), "det")
    lib = ctypes.CDLL(str(lib_path))
    if getattr(plan, "cluster", 0):
        fn = lib.worp_countsketch_scatter_det_cluster
        fn.argtypes = s._DET_CLUSTER_ARGTYPES
        split = (plan.row_group, plan.ranges, plan.cluster,
                 tiling.det_clash_bits(plan, width), plan.blocks)
    elif splits(mod):
        fn = lib.worp_countsketch_scatter_det
        fn.argtypes = s._DET_ARGTYPES
        split = (plan.row_group, plan.ranges, plan.blocks)
    else:
        fn = lib.worp_countsketch_scatter_det
        fn.argtypes = s._DET_ARGTYPES[:13] + s._DET_ARGTYPES[16:]
        split = ()
    fn.restype = ctypes.c_int
    delta = torch.empty((B, rows, width), device=keys.device)
    args = (keys.data_ptr(), vals.data_ptr(), s32.data_ptr(), t32.data_ptr(),
            lens32.data_ptr(), delta.data_ptr(), B, n, rows, width,
            int(p is not None), -1.0 / p if p is not None else 0.0, 0, *split,
            plan.threads, plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)

    def go(owners=(keys, vals, s32, t32, lens32)):
        err = fn(*args)
        if err:
            raise RuntimeError(f"det scatter {rows} x {width}: CUDA error "
                               f"{err}")
        return delta
    return plan, go


def det_occupancy(torch, kind, lib_path, plan, width) -> dict:
    """Registers, CTAs an SM and, for a cluster plan, its clusters active at
    once, of the det kernel that ``plan`` (a checkout's) launches from
    library ``lib_path`` (its ``worp_countsketch_<kind>_info`` or
    ``_cluster_info``)."""
    import ctypes

    lib = ctypes.CDLL(str(lib_path))
    buf = (ctypes.c_int * 5)()
    if getattr(plan, "cluster", 0):
        from repro_torch.kernels import tiling
        fn = getattr(lib, f"worp_countsketch_{kind}_cluster_info")
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        args = (tiling.det_span(plan, width), 2 if plan.ranges > 1 else 1,
                plan.cluster, plan.threads, plan.smem_bytes)
    else:
        fn = getattr(lib, f"worp_countsketch_{kind}_info")
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        args = (det_info_variant(kind, plan, width), plan.threads,
                plan.smem_bytes)
    fn.restype = ctypes.c_int
    if fn(*args, ctypes.addressof(buf)):
        raise RuntimeError(f"{kind} det kernel info failed")
    info = dict(zip(("registers", "static_smem", "blocks_per_sm",
                     "max_dynamic_smem"), buf[:4]), threads=plan.threads,
                dynamic_smem=plan.smem_bytes)
    if getattr(plan, "cluster", 0):
        info.update(cluster=plan.cluster, active_clusters=buf[4])
    return info


def occupancy_text(info, plan) -> str:
    """The ``[occupancy]`` text of a det plan's kernel, a cluster's or a
    block's."""
    if getattr(plan, "cluster", 0):
        return cluster_occupancy(info, plan)
    return (f"{info['registers']} registers a thread, {plan.threads} "
            f"threads, dynamic smem {plan.smem_bytes} B, "
            f"{info['blocks_per_sm']} blocks an SM")


def split_scatter_ab(torch, libs, mods, order, report, tag, keys, vals, seeds,
                     tseeds) -> bool:
    """``--det-parent`` on the tables too large for one det block
    (``SPLIT_TABLES``: the flush's B streams at 5 x 12,400 and 7 x 16,384,
    ``WIDE_STREAMS`` of them at 1 x 100,000): each checkout's det scatter,
    launched raw through its C entry with its own plan, gives the same bits
    as every other checkout and on three launches, and (without the
    transform) on the first ``WIDE_STREAMS`` streams the order model's
    (``ref.countsketch_scatter_det_ref``, on the card); times in turns
    (``order``, 10 launches a turn), beside this tree's wrapper (the
    mode's NaN fill of the delta included), the ``global`` atomics through
    the wrapper (their zeroing included), the ``index_add_`` yardstick and
    the bound.  Returns whether every check held."""
    from repro_torch.core import hashing
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import ref, tiling

    dev = keys.device
    ok = True
    for rows, width, streams in SPLIT_TABLES:
        k = keys if streams is None else keys[:streams].contiguous()
        v = vals if streams is None else vals[:streams].contiguous()
        Bs, n = k.shape
        sd, td = seeds[:Bs], tseeds[:Bs]
        s32, t32 = (hashing.int32_arg(x, Bs, dev) for x in (sd, td))
        lens32 = tiling.lengths_arg(None, Bs, n, dev)
        what = f"{rows} x {width}"
        rec = {"streams": Bs, "n": n}
        gos, first, same = {}, {}, {}
        m = min(Bs, WIDE_STREAMS)
        model = ref.countsketch_scatter_det_ref(k[:m], v[:m], rows, width,
                                                sd[:m])
        for label, mod in mods.items():
            if not splits(mod):
                continue  # a checkout without the split raises here
            lib = libs[label]["countsketch_scatter"]
            plan, go0 = raw_scatter(torch, lib, mod, k, v, s32, t32, lens32,
                                    rows, width, None)
            got = go0()
            torch.cuda.synchronize()
            equal = same_bits(torch, got[:m], model)
            del got, go0
            plan, go = raw_scatter(torch, lib, mod, k, v, s32, t32, lens32,
                                   rows, width, P)
            outs = [go().clone() for _ in range(3)]
            torch.cuda.synchronize()
            same[label] = all(same_bits(torch, o, outs[0]) for o in outs[1:])
            first[label] = outs[0]
            del outs
            gos[label] = go
            info = det_occupancy(torch, "scatter", lib, plan, width)
            rec[f"{label}_plan"] = plan._asdict()
            rec[f"{label}_occupancy"] = info
            rec[f"{label}_equals_order_model"] = equal
            ok = ok and same[label] and equal
            log(f"[det-ab] scatter {what} B={Bs} {label}: plan {tuple(plan)};"
                f" 3 launches identical: {same[label]}; the first {m} "
                f"streams the order model's bits (p=None): {equal} {tag}")
            log(f"[occupancy] countsketch_scatter det split {what} ({label}):"
                f" {occupancy_text(info, plan)} {tag}")
        equal = all(same_bits(torch, o, first["this"])
                    for o in first.values())
        ok = ok and equal
        del first
        torch.cuda.empty_cache()
        labs = [lab for lab in order if lab in gos]
        turns = [(lab, cuda_ms(torch, gos[lab], 10)) for lab in labs]
        kw = dict(p=P, transform_seeds=td)
        with deterministic_mode(torch):
            rec["wrapper_ms"] = cuda_ms(
                torch, lambda: s.countsketch_scatter_batched(
                    k, v, rows, width, sd, **kw), 10)
        rec["atomics_ms"] = cuda_ms(
            torch, lambda: s.countsketch_scatter_batched(
                k, v, rows, width, sd, _variant="global", **kw), 10)
        rec["library_ms"] = scatter_library_ms(torch, k, v, sd, td, rows,
                                               width)
        live = int((k != -1).sum())
        rec["bound_ms"], rec["bound_by"] = bound(
            k.numel() * 8 + Bs * rows * width * 4, live * slot_ops(rows))
        rec["bits_equal_across_checkouts"] = equal
        for label in gos:
            rec[f"{label}_ms"] = [t for lab, t in turns if lab == label]
        report[f"scatter_split_{rows}x{width}"] = rec
        log(f"[det-ab] scatter {what} B={Bs} p={P}: the checkouts' bits "
            f"equal: {equal}; " + ", ".join(f"{lab} {t:.4f} ms"
                                            for lab, t in turns)
            + f" raw; this tree through the wrapper {rec['wrapper_ms']:.4f} "
            f"ms (the mode's NaN fill included), global atomics "
            f"{rec['atomics_ms']:.4f} ms (their zeroing included), "
            f"index_add_ yardstick {rec['library_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} {tag}")
        del gos, k, v
        torch.cuda.empty_cache()
    return ok


def split_update_ab(torch, libs, mods, order, report, tag, v0, seeds, tseeds,
                    sizes) -> bool:
    """``--det-parent`` on the dense update's tables too large for one det
    block (``SPLIT_DENSE``: the gemma2_2b layer at 7 x 16,384, the wg
    leaf's 21.2 M segment at 1 x 100,000): each checkout's det kernel,
    launched raw through its C entry with its own plan (``raw_update``),
    gives on three launches the same bits, without the transform the
    order model's (``ref.countsketch_update_det_ref`` at the plan's
    chunk), with it every other checkout's; times in turns (``order``, 10
    launches a turn) beside the ``global`` atomics through the wrapper,
    the ``index_add_`` yardstick and the bound.  Returns whether every
    check held."""
    import ctypes

    import numpy as np
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ref

    dev = v0.device
    ok = True
    b_wg = [name for name, _ in LEAVES].index("wg")
    for rows, width, shape in SPLIT_DENSE:
        if shape == "layer":
            vals, sd, td, lens = v0, seeds, tseeds, np.asarray(sizes)
        else:
            vals, sd, td = (x[b_wg:b_wg + 1] for x in (v0, seeds, tseeds))
            lens = np.asarray([sizes[b_wg]])
        what = f"{shape} {rows} x {width}"
        lengths = torch.from_numpy(lens).to(dev)
        rec = {"live": int(lens.sum())}
        gos, first, models = {}, {}, {}
        for label, mod in mods.items():
            if not splits(mod):
                continue
            lib = ctypes.CDLL(str(libs[label]["countsketch_update"]))
            plan = mod.table_plan(vals.shape[0], vals.shape[1], lens, rows,
                                  width, 132, "det", det_chunks=True)
            if getattr(plan, "cluster", 0):
                fn = lib.worp_countsketch_update_det_cluster
                fn.argtypes = u._DET_CLUSTER_ARGTYPES
            else:
                fn = lib.worp_countsketch_update_det
                fn.argtypes = u._DET_ARGTYPES
            fn.restype = ctypes.c_int
            plan, go0 = raw_update(torch, vals, sd, td, lens, None, "det",
                                   mod, fn, rows=rows, width=width)
            got = go0().clone()
            if plan.chunk not in models:
                models[plan.chunk] = ref.countsketch_update_det_ref(
                    vals, rows, width, sd, lengths=lengths, chunk=plan.chunk)
            equal = same_bits(torch, got, models[plan.chunk])
            del got, go0
            plan, go = raw_update(torch, vals, sd, td, lens, P, "det", mod,
                                  fn, rows=rows, width=width)
            outs = [go().clone() for _ in range(3)]
            torch.cuda.synchronize()
            same = all(same_bits(torch, o, outs[0]) for o in outs[1:])
            first[label] = outs[0]
            del outs
            gos[label] = go
            info = det_occupancy(torch, "update",
                                 libs[label]["countsketch_update"], plan,
                                 width)
            rec[f"{label}_plan"] = plan._asdict()
            rec[f"{label}_occupancy"] = info
            rec[f"{label}_equals_order_model"] = equal
            ok = ok and same and equal
            log(f"[det-ab] update {what} {label}: plan {tuple(plan)}; 3 "
                f"launches identical: {same}; the order model's bits "
                f"(p=None, chunk {plan.chunk}): {equal} {tag}")
            log(f"[occupancy] countsketch_update det split {rows} x {width} "
                f"({label}): {occupancy_text(info, plan)} {tag}")
        del models
        equal = all(same_bits(torch, o, first["this"])
                    for o in first.values())
        ok = ok and equal
        del first
        torch.cuda.empty_cache()
        labs = [lab for lab in order if lab in gos]
        turns = [(lab, cuda_ms(torch, gos[lab], 10)) for lab in labs]
        rec["atomics_ms"] = cuda_ms(
            torch, lambda: u.countsketch_update_batched(
                vals, rows, width, sd, p=P, transform_seeds=td,
                lengths=lengths, _variant="global"), 10)
        rec["library_ms"] = dense_library_ms(torch, vals, sd, td, list(lens),
                                             rows, width)
        rec["bound_ms"], rec["bound_by"] = bound(
            rec["live"] * 4 + vals.shape[0] * rows * width * 4,
            rec["live"] * slot_ops(rows))
        rec["bits_equal_across_checkouts"] = equal
        for label in gos:
            rec[f"{label}_ms"] = [t for lab, t in turns if lab == label]
        report[f"update_split_{shape}"] = rec
        log(f"[det-ab] update {what} p={P}: the checkouts' bits equal: "
            f"{equal}; " + ", ".join(f"{lab} {t:.4f} ms" for lab, t in turns)
            + f" raw; global atomics {rec['atomics_ms']:.4f} ms (their "
            f"zeroing included), index_add_ yardstick "
            f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} {tag}")
        del gos
        torch.cuda.empty_cache()
    return ok


def splits(tiling_mod) -> bool:
    """Whether a checkout's ``tiling`` plans the det split (its det
    entries then take ``row_group`` and ``ranges``)."""
    return "row_group" in tiling_mod.TablePlan._fields


# the row read's A/B shapes: (B, rows, k); the flush's at rows 7 and 17
ROW_READ_AB = ((2, ROWS, SINGLE_KEYS), (1, ROWS, SINGLE_KEYS),
               (B, ROWS, CANDIDATES), (B, 17, CANDIDATES))


def scatter_query_ab(torch, libs, mods, order, report, tag) -> bool:
    """``--det-parent``'s second half: the det scatter at the flush shape
    (one step of the deployment's stream, p = 1) and the row read at
    ``ROW_READ_AB``'s shapes, each checkout's kernel (``libs[label]``,
    planned by ``mods[label]``) launched raw through its C entry, in turns
    (``order``).  Every det scatter gives every other's bits (the order
    does not depend on the split, and a narrow table is not split) and the
    same on three launches; every row read its plain version's.  Times:
    the scatter by CUDA events (20 calls a turn); the row reads at B <= 2
    by device time from a trace (50 calls a turn: CUDA events over such
    calls time the host), at the flush by CUDA events; each beside the
    gather yardstick and the bound.  Returns whether every check held."""
    import ctypes

    import numpy as np
    from repro_torch.core import hashing
    from repro_torch.data.pipeline import TurnstileZipfStream
    from repro_torch.engine import EngineConfig, derive_stream_seeds
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import ref, tiling

    dev = torch.device(DEVICE)
    ok = True
    stream = TurnstileZipfStream(vocab_size=VOCAB, alpha=ALPHA, seed=0,
                                 delete_fraction=DELETE_FRACTION)
    batches = [stream.sparse_batch_at(1, b, INSERTS) for b in range(B)]
    keys = torch.from_numpy(np.stack([k for k, _ in batches])).to(dev)
    vals = torch.from_numpy(np.stack([v for _, v in batches])).to(dev)
    del batches
    Bs, n = keys.shape
    seeds, tseeds = derive_stream_seeds(EngineConfig(
        num_streams=Bs, rows=ROWS, width=WIDTH, candidates=CANDIDATES, p=P),
        device=dev)
    s32, t32 = (hashing.int32_arg(x, Bs, dev) for x in (seeds, tseeds))
    lens32 = tiling.lengths_arg(None, Bs, n, dev)
    stream_ptr = torch.cuda.current_stream().cuda_stream
    gos, outs = {}, {}
    for label, mod in mods.items():
        plan, go = raw_scatter(torch, libs[label]["countsketch_scatter"], mod,
                               keys, vals, s32, t32, lens32, ROWS, WIDTH, P)
        gos[label] = go
        got = [go().clone() for _ in range(3)]
        torch.cuda.synchronize()
        same = all(same_bits(torch, g, got[0]) for g in got[1:])
        outs[label] = got[0]
        ok = ok and same
        log(f"[det-ab] scatter flush p={P} {label}: plan {tuple(plan)}; 3 "
            f"launches identical: {same} {tag}")
    equal = all(same_bits(torch, o, outs["this"]) for o in outs.values())
    ok = ok and equal
    turns = [(label, cuda_ms(torch, gos[label], 20)) for label in order]
    live = int((keys != -1).sum())
    b_ms, b_by = bound(keys.numel() * 8 + Bs * ROWS * WIDTH * 4,
                       live * SCATTER_OPS_PER_SLOT)
    report["scatter_flush"] = {
        "bits_equal_across_checkouts": equal, "bound_ms": b_ms,
        "bound_by": b_by, **{f"{label}_ms": [t for lab, t in turns
                                             if lab == label]
                             for label in mods}}
    log(f"[det-ab] scatter flush p={P}: the checkouts' bits equal: {equal}; "
        + ", ".join(f"{lab} {t:.4f} ms" for lab, t in turns)
        + f"; bound {b_ms:.4f} ms by {b_by} (raw launches, CUDA events) "
        f"{tag}")
    del outs, gos
    torch.cuda.empty_cache()
    ok = split_scatter_ab(torch, libs, mods, order, report, tag, keys, vals,
                          seeds, tseeds) and ok
    del keys, vals, seeds, tseeds, s32, t32, lens32
    torch.cuda.empty_cache()

    fns = {}
    for label, mod in mods.items():
        fn = ctypes.CDLL(str(libs[label]["countsketch_query"])) \
            .worp_countsketch_query
        # a checkout without ``row_read_launch``: a thread a key, the
        # estimate's signature
        fn.argtypes = q._QUERY_ARGTYPES if hasattr(mod, "row_read_launch") \
            else q._ARGTYPES
        fn.restype = ctypes.c_int
        fns[label] = fn
    for Bq, rows, k in ROW_READ_AB:
        g = torch.Generator().manual_seed(Bq + rows)
        tables = torch.randn((Bq, rows, WIDTH), generator=g).to(dev)
        qkeys = torch.randint(-2**31, 2**31 - 1, (Bq, k), generator=g,
                              dtype=torch.int64).to(torch.int32).to(dev)
        qseeds = hashing.int32_arg(torch.randint(0, 2**32, (Bq,),
                                                 generator=g), Bq, dev)
        want = ref.countsketch_query_batched_ref(tables, qkeys, qseeds)
        small = Bq <= 2
        gos = {}
        for label, fn in fns.items():
            mod = mods[label]
            launch = mod.row_read_launch(Bq, rows, k, tiling.sm_count(dev)) \
                if hasattr(mod, "row_read_launch") \
                else (tiling.grid_1d(Bq * k), tiling.THREADS_PER_BLOCK)
            out = torch.empty((Bq, rows, k), device=dev)
            args = (tables.data_ptr(), qkeys.data_ptr(), qseeds.data_ptr(),
                    out.data_ptr(), Bq, k, rows, WIDTH, *launch,
                    torch.cuda.current_stream().cuda_stream)

            def go(fn=fn, args=args, out=out):
                err = fn(*args)
                if err:
                    raise RuntimeError(f"row read: CUDA error {err}")
                return out
            gos[label] = go
            same = same_bits(torch, go(), want)
            ok = ok and same
            log(f"[det-ab] row read B={Bq} rows {rows} k={k} {label}: launch "
                f"{launch} (blocks, threads[, keys a lane]); the plain "
                f"version's bits: {same} {tag}")
        gidx = gather_index(torch, qkeys, qseeds, WIDTH, rows)
        flat = tables.reshape(Bq, -1)
        gos["gather"] = lambda: torch.gather(flat, 1, gidx)

        def timed(fn):
            return (device_ms(torch, fn, 50) if small else None) \
                or cuda_ms(torch, fn, 20)
        turns = [(label, timed(gos[label])) for label in order]
        lib_ms = timed(gos["gather"])
        nk = qkeys.numel()
        b_ms, b_by = bound(nk * 4 + table_bytes_read(torch, tables, qkeys,
                                                     qseeds)
                           + rows * nk * 4, nk * query_ops(rows))
        report[f"row_read_B{Bq}_rows{rows}_k{k}"] = {
            "bound_ms": b_ms, "bound_by": b_by, "gather_ms": lib_ms,
            "timing": "device time from a trace" if small else "CUDA events",
            **{f"{label}_ms": [t for lab, t in turns if lab == label]
               for label in mods}}
        log(f"[det-ab] row read B={Bq} rows {rows} k={k}: "
            + ", ".join(f"{lab} {t:.4f} ms" for lab, t in turns)
            + f"; gather yardstick {lib_ms:.4f} ms; bound {b_ms:.6f} ms by "
            f"{b_by} ({report[f'row_read_B{Bq}_rows{rows}_k{k}']['timing']}) "
            f"{tag}")
        del tables, qkeys, want, gidx, flat, gos
        torch.cuda.empty_cache()
    return ok


# the serve phase: (a) gemma2_2b at full width and 2 layers (one local/global
# pair) in float32 against the port's CPU path; (b) and (c) the serving CLI
# at the full published configuration
SERVE_PAIR_PROMPT, SERVE_PAIR_DECODE = 1024, 8
SERVE_ARGV = ["--arch", "gemma2_2b", "--batch", "4", "--prompt-len", "5120",
              "--tokens", "32", "--worp-topk", "8"]
SERVE_WORKERS_ARGV = ["--workers", "2", "--worp-window", "16", "--plane",
                      "async"]
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-3  # x max(1, max|want|): card vs CPU
# decode against the forward where the local rings are consistent: a
# prefill of this many prompt tokens (a multiple of the attention's
# 1024-key block) and its 32 steps inside the 4096-key window
SERVE_WINDOW_START = 3072


def serve_close(torch, what, got, want, tag, atol=SERVE_ATOL) -> float:
    """Logits of the card against the port's CPU path, both float32 with
    TF32 off: allclose rtol SERVE_RTOL, atol ``atol`` x max(1, max|want|)
    (sums in other orders over d_model 2304 and 256,000 vocabulary rows).
    Returns max |got - want| / max(1, max|want|)."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = max(1.0, float(want.abs().max()))
    ok = bool(torch.allclose(got, want, rtol=SERVE_RTOL, atol=atol * scale))
    err = float((got - want).abs().max()) / scale
    log(f"[serve] {what}: shape {tuple(got.shape)}, max err / scale "
        f"{err:.3e}, allclose rtol {SERVE_RTOL} atol {atol} x "
        f"{scale:.2f}: {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise AssertionError(f"serve {what}: the card disagrees with the CPU")
    return err


def decode_vs_forward(torch, params, cfg, tokens, start, steps, forward,
                      extras=None):
    """Prefill ``tokens[:, :start]`` (after the vlm's ``patch_embeds`` or
    with the enc-dec's ``frames`` in ``extras``), then decode ``steps``
    tokens teacher-forced on ``tokens[:, start:]``; each step's logits
    against ``forward[:, i]`` (the forward's logits at the step's position,
    start + i after any patches): the largest |diff| / max|forward| over
    the steps (the reference test's measure, gated at 0.1)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    extras = extras or {}
    pe = extras.get("patch_embeds")
    P = 0 if pe is None else pe.shape[1]
    with torch.no_grad():
        _, cache = T.forward_prefill(
            params, {"tokens": tokens[:, :start], **extras}, cfg)
        cache = serve.grow_cache(cache, start, start + P + steps, P)
        worst = 0.0
        for i in range(steps):
            lg, cache = T.forward_decode(params, {
                "token": tokens[:, start + i:start + i + 1],
                "pos": start + P + i, "cache": cache}, cfg)
            want = forward[:, i].float()
            worst = max(worst, float((lg[:, 0].float() - want).abs().max())
                        / (float(want.abs().max()) + 1e-6))
    return worst


def tree_to(tree, dtype):
    """A model tree's tensors cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def pair_config():
    """gemma2_2b at its published widths, cut to 2 layers (one local and
    one global layer)."""
    import dataclasses

    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config("gemma2_2b"), num_layers=2)


def serve_pair(torch, seed, tag) -> dict:
    """(a) gemma2_2b at full width, 2 layers (**cut** from 26), float32,
    TF32 off: a 1024-token prompt and 8 greedy decode steps on the card,
    the same weights through the port's CPU path (prefill, then decode
    teacher-forced on the card's ids), logits allclose; on the card, decode
    from a 512-token prefill against the forward's logits."""
    from repro_torch import convert
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    cfg = pair_config()
    gen = torch.Generator(DEVICE).manual_seed(seed + 21)
    params = M.init_params(cfg, gen, dtype=torch.float32, device=DEVICE)
    host = convert.params_from_numpy(convert.params_to_numpy(params), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, SERVE_PAIR_PROMPT),
                           generator=gen, device=DEVICE, dtype=torch.int32)
    out = {"layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "prompt": SERVE_PAIR_PROMPT,
           "decode": SERVE_PAIR_DECODE}
    S, n = SERVE_PAIR_PROMPT, SERVE_PAIR_DECODE
    with torch.no_grad():
        t0 = time.perf_counter()
        lg, cache = T.forward_prefill(params, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        out["card_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        hl, hcache = T.forward_prefill(host, {"tokens": tokens.cpu()}, cfg)
        out["cpu_prefill_s"] = time.perf_counter() - t0
        errs = [serve_close(torch, "pair prefill logits", lg, hl, tag)]
        out["decode_vs_forward"] = decode_vs_forward(
            torch, params, cfg, tokens, S // 2, n, lg[:, S // 2:S // 2 + n])
        tok = serve.greedy(lg[:, -1:])
        del lg, hl
        cache = serve.grow_cache(cache, S, S + n)
        hcache = serve.grow_cache(hcache, S, S + n)
        for i in range(n):
            lg, cache = T.forward_decode(
                params, {"token": tok, "pos": S + i, "cache": cache}, cfg)
            hl, hcache = T.forward_decode(
                host, {"token": tok.cpu(), "pos": S + i, "cache": hcache},
                cfg)
            errs.append(serve_close(torch, f"pair decode step {i}", lg, hl,
                                    tag))
            tok = serve.greedy(lg)
    out["max_err_over_scale"] = max(errs)
    log(f"[serve] pair (gemma2_2b, 2 layers, float32): card prefill "
        f"{out['card_prefill_ms']:.1f} ms, CPU prefill "
        f"{out['cpu_prefill_s']:.1f} s; decode vs forward on the card (512-"
        f"token prefill, {n} steps) max diff / max|logit| "
        f"{out['decode_vs_forward']:.3e} (gate 0.1) {tag}")
    if not out["decode_vs_forward"] < 0.1:
        raise AssertionError("serve pair: decode differs from the forward")
    return out


def serve_reference_engine(torch, served, prompt, plane, device,
                           window=0):
    """One engine of the CLI's config on ``device`` and ``plane`` that saw
    every step of ``served`` (the prompt unless a window, each step, each
    retraction), flushed; with the (B, n) keys and values it ingested."""
    import numpy as np

    from repro_torch.engine import SketchEngine

    eng = SketchEngine(served.engines[0].cfg, plane=plane, device=device)
    ids = served.gen.ids
    ones = np.ones((ids.shape[0], 1), np.float32)
    keys, vals = ([], []) if window else ([prompt], [np.ones(prompt.shape,
                                                             np.float32)])
    for t in range(ids.shape[1]):
        keys.append(ids[:, t:t + 1])
        vals.append(ones)
        if window and t >= window:
            keys.append(ids[:, t - window:t - window + 1])
            vals.append(-ones)
    for k, v in zip(keys, vals):
        eng.ingest(k, v)
    eng.flush()
    return eng, np.concatenate(keys, 1), np.concatenate(vals, 1)


def serve_inputs(torch, argv):
    """The CLI's configuration, weights, prompt and patch embeddings (None
    but for the vlm) for ``argv`` (its generators, in its order)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    args = serve.build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    dev = torch.device(args.device)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                           device=dev)
    prompt, patch_embeds = serve.make_prompt(cfg, args, dev)
    return cfg, params, prompt, patch_embeds


def serve_cli(torch, label, argv):
    """``serve.main(argv)`` with the launch counts from 0 and the peak
    memory reset: (its result, its record: prefill ms, decode ms a step,
    tokens/s, the analytics' ms, peak GB, wall s, launches and, for a MoE,
    the dropped choices of every layer and step).  The analytics must have
    launched the scatter and the estimate, and not the row read."""
    from repro_torch.launch import serve
    from repro_torch.models import moe

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with moe.count_drops() as drops:
        served = serve.main(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    B, n = served.gen.ids.shape[0], served.gen.ids.shape[1] - 1
    S = serve.build_parser().parse_args(argv).prompt_len
    gen = served.gen
    rec = {"batch": B, "prefill_ms": gen.prefill_s * 1e3,
           "decode_ms_per_step": gen.decode_s * 1e3 / n,
           "decode_tokens_per_s": B * n / gen.decode_s,
           "prefill_tokens_per_s": B * S / gen.prefill_s,
           "analytics_ingest_ms": gen.ingest_s * 1e3,
           "analytics_sample_ms": served.sample_s * 1e3,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "wall_s": wall, "launches": launches}
    if drops:
        rec["moe_dropped"] = int(sum(d for d, _ in drops))
        rec["moe_choices"] = int(sum(c for _, c in drops))
    if not (launches["scatter"] > 0 and launches["estimate"] > 0
            and launches["row_read"] == 0):
        raise AssertionError(f"serve {label}: launches {launches}")
    return served, rec


def log_cli(phase, label, argv, rec, tag):
    drops = (f", {rec['moe_dropped']} of {rec['moe_choices']} MoE choices "
             f"dropped" if "moe_dropped" in rec else "")
    log(f"[{phase}] {label} ({' '.join(argv)}): prefill "
        f"{rec['prefill_ms']:.1f} ms ({rec['prefill_tokens_per_s']:.0f} "
        f"tokens/s), decode {rec['decode_ms_per_step']:.2f} ms a step "
        f"of {rec['batch']} tokens ({rec['decode_tokens_per_s']:.1f} "
        f"tokens/s), analytics ingest {rec['analytics_ingest_ms']:.1f} ms + "
        f"sample {rec['analytics_sample_ms']:.1f} ms, peak "
        f"{rec['peak_gb']:.2f} "
        f"GB, {rec.get('ids_past_vocab', 0)} ids past the vocabulary, "
        f"launches {rec['launches']}{drops}, {rec['wall_s']:.1f} s wall "
        f"{tag}")


def check_ids(label, served, cfg, B, n):
    ids = served.gen.ids
    if not (ids.shape == (B, n + 1) and 0 <= ids.min()
            and ids.max() < cfg.padded_vocab()):
        raise AssertionError(f"serve {label}: ids {ids}")


def check_served_analytics(torch, label, served, prompt, k, window,
                           workers):
    """The served ids in range and the aggregated WORp state and sample
    against one engine of every step: on the CPU's dense plane for one
    worker, on the card's sparse plane for several; the printed sample is
    the aggregated state's.  Returns (ids past the vocabulary, streams of
    ``compare_histories``)."""
    from repro_torch.engine import derive_stream_seeds
    from repro_torch.engine.engine import _map, onepass_sample_batched
    from repro_torch.kernels import ref
    from repro_torch.launch import serve

    plane, dev = ("dense", "cpu") if workers == 1 else ("sparse", DEVICE)
    single, keys, vals = serve_reference_engine(
        torch, served, prompt.cpu().numpy(), plane, dev, window)
    merged = serve.aggregate_worker_states(served.engines)
    ecfg = single.cfg
    seeds, tseeds = derive_stream_seeds(ecfg, device=DEVICE)
    kt, vt = (torch.from_numpy(x).to(DEVICE) for x in (keys, vals))
    tol = ref.scatter_tolerance(*ref.countsketch_scatter_mass_ref(
        kt, vt, ecfg.rows, ecfg.width, seeds, p=ecfg.p,
        transform_seeds=tseeds))
    if not torch.equal(served.sample.keys,
                       onepass_sample_batched(merged, k, ecfg.p).keys):
        raise AssertionError(f"serve {label}: the printed sample is not "
                             f"the aggregated state's")
    return compare_histories(
        torch, f"serve {label} ({workers} worker(s), window {window}) vs "
        f"one {plane}-plane engine of every step", merged,
        _map(lambda t: t.to(DEVICE), single.state), tol, seeds, k=k,
        p=ecfg.p)


def phase_serve(torch, seed, tag):
    """(a) ``serve_pair``; (b) ``repro_torch.launch.serve.main`` at
    gemma2_2b's full published configuration (26 layers, d_model 2304,
    vocabulary 256,000, bfloat16, 2.6 B parameters; random weights from
    the seed) with ``SERVE_ARGV``, the launch counts from 0: scatter and
    estimate launched, the row read not; the WORp state and sample against
    a CPU ``dense``-plane engine of the same ids (tables within the summing
    bounds, samples equal but for near ties); decode against one forward
    over the prompt and the ids: from a ``SERVE_WINDOW_START``-token
    prefill within the reference test's 0.1 in float32, and the CLI's own
    (wrapped rings) recorded.  (c) the same with
    ``--workers 2 --worp-window 16 --plane async``: the aggregated state
    and sample against one card engine that saw every step and
    retraction.  Prefill ms, decode ms a step, tokens/s, the analytics' ms
    and peak memory recorded."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    out = {"pair": serve_pair(torch, seed, tag)}
    torch.cuda.empty_cache()
    B = int(SERVE_ARGV[SERVE_ARGV.index("--batch") + 1])
    S = int(SERVE_ARGV[SERVE_ARGV.index("--prompt-len") + 1])
    k = int(SERVE_ARGV[SERVE_ARGV.index("--worp-topk") + 1])
    for label, argv, window, workers in (
            ("full", SERVE_ARGV, 0, 1),
            ("workers", SERVE_ARGV + SERVE_WORKERS_ARGV, 16, 2)):
        argv = argv + ["--seed", str(seed), "--device", DEVICE]
        served, rec = serve_cli(torch, label, argv)
        n = served.gen.ids.shape[1] - 1
        cfg, params, prompt, _ = serve_inputs(torch, argv)
        check_ids(label, served, cfg, B, n)
        rec["ids_past_vocab"] = int((served.gen.ids >= cfg.vocab_size).sum())
        rec["history_streams"] = check_served_analytics(
            torch, label, served, prompt, k, window, workers)
        log_cli("serve", label, argv, rec, tag)
        if label == "full":
            # the CLI's decode (the prompt's prefill, its n steps teacher-
            # forced on its ids) against one forward over the prompt, the
            # ids and zeros up to whole attention blocks (a causal forward:
            # the zeros after position S + n - 1 change nothing before it)
            T_len = S + n if S + n <= 512 else -(-(S + n) // 1024) * 1024
            ids = torch.from_numpy(served.gen.ids).to(DEVICE)
            tokens = torch.cat([prompt, ids[:, :n], torch.zeros(
                (B, T_len - S - n), dtype=torch.int32, device=DEVICE)], 1)
            # in bfloat16, as the CLI runs, every request; then in float32
            # on request 0, the reference test's condition (one sequence):
            # from the prompt's prefill (the CLI's decode, whose rings wrap:
            # recorded, the reference's ring fault, ROADMAP Queue 3) and
            # from a prefill of SERVE_WINDOW_START tokens teacher-forced on
            # the prompt (its rings consistent: gated in float32)
            W0 = SERVE_WINDOW_START
            for dtype in ("bfloat16", "float32"):
                r = slice(0, B)
                if dtype == "float32":
                    params, r = tree_to(params, torch.float32), slice(0, 1)
                with torch.no_grad():
                    lg, _ = T.forward_prefill(params, {"tokens": tokens[r]},
                                              cfg)
                    fwd = {"ring": lg[:, S:S + n].clone(),
                           "window": lg[:, W0:W0 + n].clone()}
                    del lg
                torch.cuda.empty_cache()
                worst = {what: decode_vs_forward(torch, params, cfg,
                                                 tokens[r], start, n,
                                                 fwd[what])
                         for what, start in (("ring", S), ("window", W0))}
                del fwd
                for what in worst:
                    rec[f"decode_vs_forward_{what}_{dtype}"] = worst[what]
                log(f"[serve] full in {dtype} (requests {r.start} to "
                    f"{r.stop - 1}), decode vs a {T_len}-token "
                    f"forward, max diff / max|logit|: the CLI's ({S}-token "
                    f"prefill, {n} steps on its ids, the local rings of "
                    f"{cfg.local_window} wrapping; the reference's ring "
                    f"fault, recorded) {worst['ring']:.3e}; from a "
                    f"{W0}-token prefill inside the window "
                    f"{worst['window']:.3e}"
                    + (" (gate 0.1)" if dtype == "float32" else
                       " (recorded)") + f" {tag}")
            if not rec["decode_vs_forward_window_float32"] < 0.1:
                raise AssertionError("serve full: decode differs from the "
                                     "forward")
            del tokens, ids
        out[label] = rec
        del served, params, prompt
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase] serve: {out['wall_s']:.2f} s wall")
    return out

# the families phase: (a) the six new architectures reduced, float32, the
# card against the port's CPU path; (b) the serving CLI at the full
# published widths; (c) the enc-dec through prefill and decode_step; (d)
# decode against the forward, float32, request 0
FAMILY_PAIRS = ("olmoe_1b_7b", "grok1_314b", "mamba2_13b",
                "recurrentgemma_9b", "seamless_m4t_large_v2",
                "phi3_vision_42b")
FAMILY_PAIR_PROMPT, FAMILY_PAIR_DECODE = 64, 4
# the CLI's prompt per architecture: 4096 tokens (the vlm's 3520 after its
# 576 patches), past recurrentgemma's 2048 window
FAMILY_CLI = (("olmoe_1b_7b", 4096), ("mamba2_13b", 4096),
              ("recurrentgemma_9b", 4096), ("phi3_vision_42b", 3520))
FAMILY_ARGV = ["--batch", "4", "--tokens", "32", "--worp-topk", "8"]
# (d): (the forward's tokens, the prefill's) per architecture, each a
# length blockwise_attention takes (after the vlm's patches); the
# hybrid's prefill and steps inside its 2048 window
FAMILY_DVF = {"olmoe_1b_7b": (4096, 3072), "mamba2_13b": (4096, 3072),
              "recurrentgemma_9b": (2048, 1024),
              "phi3_vision_42b": (3520, 2496),
              "seamless_m4t_large_v2": (1024, 512)}
FAMILY_DVF_STEPS = 32
# the depth at which (d) is gated (all layers where absent): random weights
# make the deeper attention models chaotic (family_decode_vs_forward)
FAMILY_DVF_LAYERS = {"olmoe_1b_7b": 4, "recurrentgemma_9b": 12,
                     "phi3_vision_42b": 3, "seamless_m4t_large_v2": 2}
# (c): seamless_m4t_large_v2 at its published widths
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_DECODE = 4, 1024, 32
# the CLI's default prompt (64 tokens) on mamba2_13b, whose 64 heads meet
# the reference's grow there (ROADMAP Queue 3)
MAMBA_DEFAULT_ARGV = ["--arch", "mamba2_13b", "--worp-topk", "8"]


def family_extras(torch, cfg, B, gen, dtype=None):
    """The vlm's patch embeddings or the enc-dec's frames (N(0, 1) x 0.02,
    from ``gen`` on the card; in ``dtype`` when given), else nothing."""
    if cfg.family not in ("vlm", "encdec"):
        return {}
    name, n = (("patch_embeds", cfg.num_patches) if cfg.family == "vlm"
               else ("frames", cfg.enc_context))
    x = torch.randn((B, n, cfg.d_model), generator=gen, device=DEVICE,
                    dtype=torch.float32)
    x = x if dtype is None else x.to(dtype)
    return {name: x * 0.02}


def family_pair(torch, name, seed, tag) -> dict:
    """(a) ``name`` reduced, float32, TF32 off: a 64-token prompt and 4
    greedy decode steps on the card, the same weights and inputs through
    the port's CPU path (decode teacher-forced on the card's ids), logits
    allclose (rtol 1e-4, atol 1e-3 x max(1, max|logit|); seamless 1e-2 x,
    whose random cross-attention amplifies float32 rounding 70-fold,
    tests/test_torch_models.py)."""
    from repro_torch import convert
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    from repro_torch.configs.base import get_config

    cfg = get_config(name).reduced()
    atol = 1e-2 if cfg.family == "encdec" else SERVE_ATOL
    gen = torch.Generator(DEVICE).manual_seed(seed + 31)
    params = M.init_params(cfg, gen, dtype=torch.float32, device=DEVICE)
    host = convert.params_from_numpy(convert.params_to_numpy(params), "cpu")
    S, n = FAMILY_PAIR_PROMPT, FAMILY_PAIR_DECODE
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, S),
                                     generator=gen, device=DEVICE,
                                     dtype=torch.int32),
             **family_extras(torch, cfg, 2, gen)}
    hbatch = {k: v.cpu() for k, v in batch.items()}
    P = cfg.num_patches if cfg.family == "vlm" else 0
    with torch.no_grad():
        lg, cache = T.forward_prefill(params, batch, cfg)
        hl, hcache = T.forward_prefill(host, hbatch, cfg)
        errs = [serve_close(torch, f"{name} pair prefill logits", lg, hl,
                            tag, atol)]
        tok = serve.greedy(lg[:, -1:])
        cache = serve.grow_cache(cache, S, S + P + n, P)
        hcache = serve.grow_cache(hcache, S, S + P + n, P)
        for i in range(n):
            lg, cache = T.forward_decode(
                params, {"token": tok, "pos": S + P + i, "cache": cache},
                cfg)
            hl, hcache = T.forward_decode(
                host, {"token": tok.cpu(), "pos": S + P + i,
                       "cache": hcache}, cfg)
            errs.append(serve_close(torch, f"{name} pair decode step {i}",
                                    lg, hl, tag, atol))
            tok = serve.greedy(lg)
    return {"max_err_over_scale": max(errs), "atol_scale": atol}


def cli_weights_f32(torch, cfg, seed):
    """The CLI's bfloat16 weights (``--seed``) in float32, with no
    bfloat16 copy alive: the same float32 draws, each leaf rounded through
    bfloat16 in place."""
    from repro_torch.models import model as M
    from repro_torch.models import params as P

    params = M.init_params(cfg, torch.Generator(DEVICE).manual_seed(seed),
                           dtype=torch.float32, device=DEVICE)
    for leaf in P.leaves(params):
        leaf.copy_(leaf.to(torch.bfloat16))
    return params


def cut_layers(params, cfg, L):
    """The first ``L`` layers of ``cfg``'s stacks (views of ``params``,
    the same weights) and the configuration of that depth: the hybrid
    keeps L / 3 (R, R, L) groups and no tail, the enc-dec L encoder and L
    decoder layers."""
    import dataclasses

    if cfg.family == "encdec":
        keep = {"enc": L, "dec": L}
        cut = dataclasses.replace(cfg, num_layers=L, enc_layers=L,
                                  dec_layers=L)
    elif cfg.family == "hybrid":
        keep = {"rec1": L // 3, "rec2": L // 3, "attn": L // 3, "tail": 0}
        cut = dataclasses.replace(cfg, num_layers=L)
    else:
        keep = {"layers": L}
        cut = dataclasses.replace(cfg, num_layers=L)

    def head(tree, n):
        if isinstance(tree, dict):
            return {k: head(v, n) for k, v in tree.items()}
        return tree[:n]
    return ({k: head(v, keep[k]) if k in keep else v
             for k, v in params.items() if keep.get(k, 1)}, cut)


def family_decode_vs_forward(torch, name, cfg, seed, tokens, extras,
                             tag) -> dict:
    """(d) float32, the CLI's weights, request 0 of ``tokens`` (with its
    ``extras``): one forward over ``FAMILY_DVF[name][0]`` tokens, a
    prefill of the first ``FAMILY_DVF[name][1]`` and ``FAMILY_DVF_STEPS``
    decode steps teacher-forced on the rest, each against the forward's
    logits at its position.  At full depth recorded, beside the prefill's
    last logits against the forward's at the same position (two forwards
    of one causal model over other lengths): with random weights the
    attention scores reach the hundreds, so deep models are chaotic, and
    where the two forwards part, decode parts as much.  Gated at the
    reference test's 0.1 of max|logit| on the first
    ``FAMILY_DVF_LAYERS[name]`` layers (all where absent), a MoE there at
    capacity factor E / K, where no choice drops (a forward over more
    tokens drops choices that decode, one token keeping every choice, does
    not)."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    T_len, start = FAMILY_DVF[name]
    n = FAMILY_DVF_STEPS
    params = cli_weights_f32(torch, cfg, seed)
    toks = tokens[:1, :T_len]
    ex = {k: v[:1].float() for k, v in extras.items()}
    P = ex["patch_embeds"].shape[1] if "patch_embeds" in ex else 0
    out = {"forward_tokens": T_len + P, "prefill_tokens": start + P,
           "steps": n}
    L = FAMILY_DVF_LAYERS.get(name)
    gate_p, gate_cfg = (params, cfg) if L is None else cut_layers(
        params, cfg, L)
    if cfg.num_experts:
        gate_cfg = dataclasses.replace(
            gate_cfg, capacity_factor=cfg.num_experts / cfg.moe_top_k)
    runs = [("gated", gate_p, gate_cfg)]
    if L is not None:
        runs.insert(0, ("full", params, cfg))
    for label, p, c in runs:
        with torch.no_grad(), moe.count_drops() as drops:
            lg = T.forward_train(p, {"tokens": toks, **ex}, c)
            fwd = lg[:, start + P:start + P + n].clone()
            last = lg[:, start + P - 1].clone()
            del lg
            pre, _ = T.forward_prefill(
                p, {"tokens": toks[:, :start], **ex}, c)
            base = float((pre[:, -1] - last).abs().max()
                         / (last.abs().max() + 1e-6))
            del pre, last
        torch.cuda.empty_cache()
        worst = decode_vs_forward(torch, p, c, toks, start, n, fwd, ex)
        del fwd
        rec = {"layers": c.num_layers, "decode_vs_forward_float32": worst,
               "prefill_vs_forward_float32": base}
        if drops:
            rec["capacity_factor"] = c.capacity_factor
            rec["forward_moe_dropped"] = int(sum(d for d, _ in drops))
            rec["forward_moe_choices"] = int(sum(k for _, k in drops))
        out[label] = rec
        what = ("" if not drops else
                f", capacity factor {c.capacity_factor:g}, the forwards "
                f"dropped {rec['forward_moe_dropped']} of "
                f"{rec['forward_moe_choices']} MoE choices, decode none")
        log(f"[families] {name}, {c.num_layers} layers, float32 (request "
            f"0){what}: decode vs a {T_len + P}-token forward from a "
            f"{start + P}-token prefill, {n} steps, max diff / max|logit| "
            f"{worst:.3e} "
            + ("(gate 0.1)" if label == "gated" else "(recorded)")
            + f"; the prefill's last logits vs the forward's {base:.3e} "
            f"{tag}")
    del params, gate_p
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    if not out["gated"]["decode_vs_forward_float32"] < 0.1:
        raise AssertionError(f"families {name}: decode differs from the "
                             f"forward")
    return out


def family_cli(torch, name, prompt, seed, tag) -> dict:
    """(b) ``serve.main`` at ``name``'s published configuration in
    bfloat16 (``FAMILY_ARGV``, a ``prompt``-token prompt, random weights
    from the seed), its analytics held to one engine of every step; then
    (d) on its weights and prompt."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config(name)
    argv = (["--arch", name, "--prompt-len", str(prompt)] + FAMILY_ARGV
            + ["--seed", str(seed), "--device", DEVICE])
    served, rec = serve_cli(torch, name, argv)
    B, n = served.gen.ids.shape[0], served.gen.ids.shape[1] - 1
    check_ids(name, served, cfg, B, n)
    args = serve.build_parser().parse_args(argv)
    tokens, patch_embeds = serve.make_prompt(cfg, args, torch.device(DEVICE))
    rec["ids_past_vocab"] = int((served.gen.ids >= cfg.vocab_size).sum())
    rec["history_streams"] = check_served_analytics(
        torch, name, served, tokens, args.worp_topk, 0, 1)
    rec["layers"] = cfg.num_layers
    rec["params_b"] = M.param_count(cfg) / 1e9
    log_cli("families", name, argv, rec, tag)
    del served
    torch.cuda.empty_cache()
    extras = {} if patch_embeds is None else {"patch_embeds": patch_embeds}
    rec["decode_vs_forward"] = family_decode_vs_forward(
        torch, name, cfg, seed, tokens, extras, tag)
    return rec


def mamba_default_prompt(torch, seed, tag) -> dict:
    """``serve.main`` on mamba2_13b at the CLI's defaults (batch 4, a
    64-token prompt, 16 tokens), which crash the reference: its decode,
    teacher-forced on the CLI's ids with the weights in float32, against
    one forward over the prompt and the ids (gated at 0.1)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    argv = MAMBA_DEFAULT_ARGV + ["--seed", str(seed), "--device", DEVICE]
    served, rec = serve_cli(torch, "mamba2_13b default prompt", argv)
    cfg = get_config("mamba2_13b")
    args = serve.build_parser().parse_args(argv)
    B, n, S = args.batch, args.tokens, args.prompt_len
    check_ids("mamba2_13b default prompt", served, cfg, B, n)
    prompt, _ = serve.make_prompt(cfg, args, torch.device(DEVICE))
    ids = torch.from_numpy(served.gen.ids).to(DEVICE)
    del served
    tokens = torch.cat([prompt, ids[:, :n]], 1)[:1]
    params = cli_weights_f32(torch, cfg, seed)
    with torch.no_grad():
        fwd = T.forward_train(params, {"tokens": tokens}, cfg)[:, S:]
    rec["decode_vs_forward_float32"] = decode_vs_forward(
        torch, params, cfg, tokens, S, n, fwd)
    del params, fwd
    torch.cuda.empty_cache()
    log_cli("families", "mamba2_13b default prompt", argv, rec, tag)
    heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    log(f"[families] mamba2_13b at the CLI's default {S}-token prompt "
        f"(the reference's grow pads its {heads}-head SSM state there and "
        f"crashes): decode vs the "
        f"forward in float32 (request 0, {n} steps on the CLI's ids), max "
        f"diff / max|logit| {rec['decode_vs_forward_float32']:.3e} (gate "
        f"0.1) {tag}")
    if not rec["decode_vs_forward_float32"] < 0.1:
        raise AssertionError("families mamba2_13b default prompt: decode "
                             "differs from the forward")
    return rec


def encdec_full(torch, seed, tag) -> dict:
    """(c) seamless_m4t_large_v2 at its published configuration in
    bfloat16 (random weights and frames from the seed): ``M.prefill`` of
    ``ENCDEC_BATCH`` requests of 4096 frames and an ``ENCDEC_PROMPT``-token
    text prompt, then ``ENCDEC_DECODE`` greedy ``M.decode_step`` calls over
    the grown self cache; finite logits and ids in range; then (d)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    name = "seamless_m4t_large_v2"
    cfg = get_config(name)
    B, S, n = ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_DECODE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(DEVICE).manual_seed(seed),
                           device=DEVICE)
    gen = torch.Generator(DEVICE).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    frames = family_extras(torch, cfg, B, gen, torch.bfloat16)["frames"]
    with torch.no_grad():
        t0 = time.perf_counter()
        lg, cache = M.prefill(params, {"tokens": tokens, "frames": frames},
                              cfg)
        tok = serve.greedy(lg[:, -1:])
        outs = [tok.cpu()]
        prefill_s = time.perf_counter() - t0
        finite = bool(torch.isfinite(lg).all())
        del lg
        cache = serve.grow_cache(cache, S, S + n)
        t0 = time.perf_counter()
        for i in range(n):
            lg, cache = M.decode_step(params, {"token": tok, "pos": S + i,
                                               "cache": cache}, cfg)
            finite &= bool(torch.isfinite(lg).all())
            tok = serve.greedy(lg)
            outs.append(tok.cpu())
        decode_s = time.perf_counter() - t0
    ids = torch.cat(outs, 1)
    rec = {"prefill_ms": prefill_s * 1e3,
           "decode_ms_per_step": decode_s * 1e3 / n,
           "decode_tokens_per_s": B * n / decode_s,
           "prefill_tokens_per_s": B * S / prefill_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "wall_s": time.perf_counter() - t_all, "layers": cfg.num_layers,
           "params_b": M.param_count(cfg) / 1e9}
    log(f"[families] {name} (M.prefill of {B} x {cfg.enc_context} frames "
        f"and {S} tokens, {n} M.decode_step): prefill "
        f"{rec['prefill_ms']:.1f} ms ({rec['prefill_tokens_per_s']:.0f} "
        f"text tokens/s), decode {rec['decode_ms_per_step']:.2f} ms a step "
        f"of {B} tokens ({rec['decode_tokens_per_s']:.1f} tokens/s), peak "
        f"{rec['peak_gb']:.2f} GB, {rec['wall_s']:.1f} s wall {tag}")
    if not (finite and ids.shape == (B, n + 1) and int(ids.min()) >= 0
            and int(ids.max()) < cfg.padded_vocab()):
        raise AssertionError(f"families {name}: logits or ids {ids}")
    del params, cache
    torch.cuda.empty_cache()
    rec["decode_vs_forward"] = family_decode_vs_forward(
        torch, name, cfg, seed, tokens, {"frames": frames}, tag)
    return rec


def phase_families(torch, seed, tag):
    """The moe, ssm, hybrid, enc-dec and vlm families: (a)
    ``family_pair`` for each of ``FAMILY_PAIRS``; (b) ``family_cli`` of
    each of ``FAMILY_CLI``, each with (d); mamba2_13b at the CLI's
    default prompt; (c) ``encdec_full``.  Each model is freed before the
    next."""
    t_phase = time.perf_counter()
    out = {"pairs": {}}
    t0 = time.perf_counter()
    for name in FAMILY_PAIRS:
        out["pairs"][name] = family_pair(torch, name, seed, tag)
        torch.cuda.empty_cache()
    out["pairs_wall_s"] = time.perf_counter() - t0
    log(f"[families] (a) the six pairs: {out['pairs_wall_s']:.1f} s wall "
        f"{tag}")
    for name, prompt in FAMILY_CLI:
        out[name] = family_cli(torch, name, prompt, seed, tag)
        torch.cuda.empty_cache()
    out["mamba2_13b_default_prompt"] = mamba_default_prompt(torch, seed,
                                                            tag)
    torch.cuda.empty_cache()
    out["seamless_m4t_large_v2"] = encdec_full(torch, seed, tag)
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase] families: {out['wall_s']:.2f} s wall")
    return out


# the train phase: (a) reduced float32 pairs, the card against the CPU; (b)
# the training CLI at mamba2_13b's published size; (c) dense training with
# token analytics at gemma2_2b's; (d) compressed data parallelism and (e)
# restart at mamba2_13b's widths cut to TRAIN_CUT_LAYERS layers
TRAIN_PAIRS = ("phi4_mini_38b", "mamba2_13b", "olmoe_1b_7b")
TRAIN_PAIR_STEPS, TRAIN_PAIR_BATCH, TRAIN_PAIR_SEQ = 3, 2, 64
TRAIN_LR = 3e-4                  # the loop's default
TRAIN_ATOL = 1e-3                # x max(1, max|want|): card vs CPU
TRAIN_MOMENT_SCALE = 5e-2        # x max|want| a leaf (the card tests')
TRAIN_CLI_ARGV = ["--arch", "mamba2_13b", "--steps", "4"]
TRAIN_DENSE_ARCH, TRAIN_DENSE_STEPS, TRAIN_TOPK = "gemma2_2b", 6, 16
TRAIN_BATCH, TRAIN_SEQ = 8, 128  # the loop's and the CLI's defaults
TRAIN_CUT_ARCH, TRAIN_CUT_LAYERS = "mamba2_13b", 2
TRAIN_GC_STEPS, TRAIN_RESTART_STEPS = 3, 8


class timed_train_steps:
    """Every step of the loop timed on the host clock between two
    synchronises, with its metrics: ``steps.train_step`` and the steps the
    compressed builders return, patched while the context is open.
    ``records`` holds (ms, {metric: float}) a step."""

    NAMES = ("train_step", "make_compressed_train_step",
             "make_compressed_train_step_tp")

    def __init__(self, torch):
        self.torch = torch
        self.records: list = []

    def _timed(self, fn):
        def run(*args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            self.records.append((ms, {k: float(v)
                                      for k, v in out[1].items()}))
            return out
        return run

    def __enter__(self):
        from repro_torch.train import steps as S

        self.saved = {n: getattr(S, n) for n in self.NAMES}
        S.train_step = self._timed(self.saved["train_step"])
        for n in self.NAMES[1:]:
            build = self.saved[n]
            setattr(S, n, lambda *a, _b=build, **k: self._timed(_b(*a, **k)))
        return self

    def __exit__(self, *exc):
        from repro_torch.train import steps as S

        for n, fn in self.saved.items():
            setattr(S, n, fn)
        return False

    def summary(self, tokens_a_step: int) -> dict:
        """First and steady (median of the rest) step ms, tokens/s."""
        ms = [r[0] for r in self.records]
        steady = sorted(ms[1:])[len(ms[1:]) // 2] if len(ms) > 1 else ms[0]
        return {"steps": len(ms), "first_step_ms": ms[0],
                "steady_step_ms": steady, "step_ms": ms,
                "tokens_per_s": tokens_a_step / (steady / 1e3)}


def tree_err(torch, got_tree, want_tree, scale=None) -> float:
    """The worst leaf's max |got - want| over its bound: TRAIN_ATOL x
    max(1, max|want|), or ``scale`` x max|want| where given."""
    from repro_torch.distributed import pytree

    worst = 0.0
    for got, want in zip(pytree.leaves(got_tree), pytree.leaves(want_tree)):
        want = want.float()
        top = float(want.abs().max())
        bound = TRAIN_ATOL * max(1.0, top) if scale is None \
            else scale * max(top, 1e-30)
        worst = max(worst, float((got.float().cpu() - want).abs().max())
                    / bound)
    return worst


def train_pair(torch, name, seed, tag) -> dict:
    """(a) ``name`` reduced, float32, TF32 off: TRAIN_PAIR_STEPS
    ``train_step``s on the card and on the CPU from the same weights and
    batches (the loop's Zipf stream): losses within TRAIN_ATOL x max(1,
    |want|), each parameter leaf within TRAIN_ATOL x max(1, max|want|)
    (AdamW moves an element by at most ~lr = 3e-4 a step, so a gradient of
    rounding size whose sign flips moves it less than that), the moments
    within TRAIN_MOMENT_SCALE x their leaf's max|want| (they hold the
    gradients, which the reduced random attention models' near-tie
    softmaxes make sensitive to the summation order)."""
    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import ZipfStream
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import steps as S

    cfg = get_config(name).reduced()
    params = M.init_params(cfg, torch.Generator(DEVICE).manual_seed(
        seed + 41), dtype=torch.float32, device=DEVICE)
    host = convert.params_from_numpy(convert.params_to_numpy(params), "cpu")
    cs = S.TrainState(params, adamw.init(params))
    hs = S.TrainState(host, adamw.init(host))
    stream = ZipfStream(cfg.vocab_size, 1.2, seed)
    loss_err = 0.0
    for i in range(TRAIN_PAIR_STEPS):
        hb = stream.lm_batch(i, 0, TRAIN_PAIR_BATCH, TRAIN_PAIR_SEQ,
                             device="cpu")
        cs, cm = S.train_step(cs, {k: v.to(DEVICE) for k, v in hb.items()},
                              cfg, lr=TRAIN_LR)
        hs, hm = S.train_step(hs, hb, cfg, lr=TRAIN_LR)
        want = float(hm["loss"])
        loss_err = max(loss_err, abs(float(cm["loss"]) - want)
                       / (TRAIN_ATOL * max(1.0, abs(want))))
    rec = {"loss_err_over_bound": loss_err,
           "params_err_over_bound": tree_err(torch, cs.params, hs.params),
           "mu_err_over_bound": tree_err(torch, cs.opt.mu, hs.opt.mu,
                                         TRAIN_MOMENT_SCALE),
           "nu_err_over_bound": tree_err(torch, cs.opt.nu, hs.opt.nu,
                                         TRAIN_MOMENT_SCALE),
           "final_loss": float(cm["loss"])}
    worst = max(v for k, v in rec.items() if k.endswith("bound"))
    log(f"[train] (a) {name} reduced, float32, {TRAIN_PAIR_STEPS} steps, "
        f"card vs CPU, err / bound: loss {rec['loss_err_over_bound']:.3e}, "
        f"params {rec['params_err_over_bound']:.3e}, mu "
        f"{rec['mu_err_over_bound']:.3e}, nu {rec['nu_err_over_bound']:.3e}"
        f": {'ok' if worst <= 1.0 else 'FAIL'} {tag}")
    if worst > 1.0:
        raise AssertionError(f"train pair {name}: the card disagrees with "
                             f"the CPU")
    return rec


def train_run(torch, label, fn, tokens_a_step, tag) -> tuple:
    """``fn()`` (a training run) with the launch counts from 0, the peak
    memory reset and every step timed: (its result, its record)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with timed_train_steps(torch) as timer:
        out = fn()
        torch.cuda.synchronize()
    rec = {"wall_s": time.perf_counter() - t0, "launches": read_counts(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           **timer.summary(tokens_a_step)}
    if isinstance(out, dict) and "losses" in out:
        rec["losses"] = out["losses"]
    rec["metrics"] = [m for _, m in timer.records]
    log(f"[train] {label}: first step {rec['first_step_ms']:.1f} ms, "
        f"steady {rec['steady_step_ms']:.1f} ms a step "
        f"({rec['tokens_per_s']:.0f} tokens/s), peak {rec['peak_gb']:.2f} "
        f"GB, launches {rec['launches']}, {rec['wall_s']:.1f} s wall "
        + (f"losses {[round(x, 4) for x in rec['losses']]} "
           if "losses" in rec else "") + tag)
    return out, rec


def finite_losses(label, losses, decreasing=False):
    import math

    if not (losses and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"train {label}: losses {losses}")
    if decreasing and not losses[-1] < losses[0]:
        raise AssertionError(f"train {label}: the last loss is not below "
                             f"the first: {losses}")


def train_analytics_reference(torch, cfg, seed):
    """The loop's token analytics on the CPU's sparse plane, fed the same
    token ids (the loop's Zipf stream): its ``sample(TRAIN_TOPK)``."""
    import numpy as np

    from repro_torch.data.pipeline import ZipfStream
    from repro_torch.train import loop

    eng = loop.analytics_engine(cfg, "onepass", TRAIN_TOPK, "sparse", 1,
                                seed, "cpu")
    stream = ZipfStream(cfg.vocab_size, 1.2, seed)
    for step in range(TRAIN_DENSE_STEPS):
        toks = stream.batch_at(step, 0, TRAIN_BATCH, TRAIN_SEQ + 1)[:, :-1]
        toks = np.ascontiguousarray(toks, np.int32).reshape(1, -1)
        eng.ingest(toks, np.ones_like(toks, np.float32))
    return eng.sample(TRAIN_TOPK)


def check_top_tokens(torch, got, want) -> float:
    """The loop's ``top_tokens`` against the CPU engine's sample: the same
    keys in the same order, frequencies within the summing tolerance
    (rtol RTOL, atol 1e-5 x max(1, max|want|)).  Returns the worst
    |diff| / max(1, max|want|)."""
    keys = [int(k) for k in want.keys[0] if int(k) >= 0]
    freqs = torch.tensor([float(f) for k, f in zip(want.keys[0],
                                                   want.freqs[0])
                          if int(k) >= 0])
    gkeys = [k for k, _ in got]
    gfreqs = torch.tensor([f for _, f in got])
    if gkeys != keys:
        raise AssertionError(f"train (c) top_tokens keys {gkeys} differ "
                             f"from the CPU engine's {keys}")
    scale = max(1.0, float(freqs.abs().max()))
    if not torch.allclose(gfreqs, freqs, rtol=RTOL, atol=1e-5 * scale):
        raise AssertionError(f"train (c) top_tokens frequencies {gfreqs} "
                             f"differ from the CPU engine's {freqs}")
    return float((gfreqs - freqs).abs().max()) / scale


def cut_config(name, layers):
    import dataclasses

    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config(name), num_layers=layers)


def compression_invariants(torch, what, grads, error, sparse, new_err, k):
    """``test_compression_invariants_single_worker``'s checks, bit for
    bit, on one rank's two-pass round: at most k nonzeros in the update,
    each equal to the accumulated gradient a = g + e; the new error zero
    there and equal to a elsewhere."""
    from repro_torch.distributed import pytree

    nnz = 0
    for g, e, sp, ne in zip(*(pytree.leaves(t) for t in (grads, error,
                                                          sparse, new_err))):
        a = g.float() + e.reshape(g.shape)
        sp, ne = sp.reshape(g.shape), ne.reshape(g.shape)
        hit = sp != 0
        nnz += int(hit.sum())
        if not (torch.equal(sp[hit], a[hit]) and bool((ne[hit] == 0).all())
                and torch.equal(ne[~hit], a[~hit])):
            raise AssertionError(f"train (d) {what}: the two-pass "
                                 f"invariants do not hold")
    if not 0 < nnz <= k:
        raise AssertionError(f"train (d) {what}: {nnz} nonzeros, k = {k}")
    return nnz


def train_compressed(torch, seed, tag) -> dict:
    """(d) ``run_training(compressed=True)`` at mamba2_13b's widths cut to
    TRAIN_CUT_LAYERS layers over a one-rank NCCL group, TRAIN_GC_STEPS
    steps; then, from its state, one step of
    ``make_compressed_train_step_tp``, and the flat and sharded rounds on
    the next batch's gradients held to the two-pass invariants."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch.data.pipeline import ZipfStream
    from repro_torch.distributed import pytree
    from repro_torch.models import model as M
    from repro_torch.optim import gradcomp as G
    from repro_torch.train import loop
    from repro_torch.train import steps as S

    cfg = cut_config(TRAIN_CUT_ARCH, TRAIN_CUT_LAYERS)
    cc = G.CompressorConfig()
    store_dir = tempfile.mkdtemp(prefix="chip-smoke-train-")
    dist.init_process_group(
        "nccl" if DEVICE == "cuda" else "gloo", store=dist.FileStore(
            os.path.join(store_dir, "store"), 1), rank=0, world_size=1)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    try:
        out, rec = train_run(torch, f"(d) compressed, {TRAIN_CUT_ARCH} cut "
                             f"to {TRAIN_CUT_LAYERS} layers", lambda:
                             loop.run_training(
                                 cfg, TRAIN_GC_STEPS, batch=TRAIN_BATCH,
                                 seq=TRAIN_SEQ, compressed=True, cc=cc,
                                 seed=seed, log_every=100,
                                 print_fn=lambda s: None, device=DEVICE),
                             tokens, tag)
        finite_losses("(d) compressed", rec["losses"])
        rec["params_m"] = M.param_count(cfg) / 1e6
        rec["comm_bytes"] = rec["metrics"][0]["comm_bytes"]
        rec["dense_bytes"] = rec["metrics"][0]["dense_bytes"]
        state = out["state"]
        del out
        b = ZipfStream(cfg.vocab_size, 1.2, seed).lm_batch(
            TRAIN_GC_STEPS, 0, TRAIN_BATCH, TRAIN_SEQ, device=DEVICE)
        tp_state = state._replace(error=pytree.tree_map(
            lambda e: e[None], state.error))
        tp_out, tp_rec = train_run(
            torch, "(d) make_compressed_train_step_tp, one step",
            lambda: S.make_compressed_train_step_tp(cfg, None, cc)(
                tp_state, b), tokens, tag)
        del tp_out, tp_state
        rec["tp"] = {k: tp_rec[k] for k in ("first_step_ms", "peak_gb",
                                            "launches", "metrics")}
        _, grads = S.value_and_grad(state.params, b, cfg)
        with torch.no_grad():
            for what, fn in (("flat", G.tree_compress_step),
                             ("sharded", G.tree_compress_step_sharded)):
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sparse, new_err, stats = fn(grads, state.error, cc)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                nnz = compression_invariants(torch, what, grads, state.error,
                                             sparse, new_err, cc.k)
                rec[f"{what}_round"] = {
                    "ms": ms, "nonzeros": nnz,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "comm_bytes": float(stats["comm_bytes"]),
                    "dense_bytes": float(stats["dense_bytes"])}
                del sparse, new_err, stats
        log(f"[train] (d) {rec['params_m']:.1f} M coordinates: comm "
            f"{rec['comm_bytes']:.0f} B against dense "
            f"{rec['dense_bytes']:.0f} B a step; flat round "
            f"{rec['flat_round']['ms']:.1f} ms ({rec['flat_round']['nonzeros']}"
            f" nonzeros, peak {rec['flat_round']['peak_gb']:.2f} GB), sharded "
            f"round {rec['sharded_round']['ms']:.1f} ms "
            f"({rec['sharded_round']['nonzeros']} nonzeros, peak "
            f"{rec['sharded_round']['peak_gb']:.2f} GB); two-pass invariants "
            f"bit for bit {tag}")
        del grads, state
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    return rec


class timed_checkpoints:
    """``checkpoint.save`` and ``restore_latest`` timed while open, with
    the bytes of each committed checkpoint."""

    def __init__(self, torch):
        self.torch = torch
        self.saves: list = []
        self.restores: list = []

    def __enter__(self):
        from repro_torch.train import checkpoint as C

        self.saved = (C.save, C.restore_latest)
        save, restore = self.saved

        def timed_save(*a, **k):
            t0 = time.perf_counter()
            path = save(*a, **k)
            self.saves.append((C.payload_nbytes(path),
                               time.perf_counter() - t0))
            return path

        def timed_restore(*a, **k):
            t0 = time.perf_counter()
            out = restore(*a, **k)
            self.torch.cuda.synchronize()
            if out[0] is not None:
                self.restores.append(time.perf_counter() - t0)
            return out
        C.save, C.restore_latest = timed_save, timed_restore
        return self

    def __exit__(self, *exc):
        from repro_torch.train import checkpoint as C

        C.save, C.restore_latest = self.saved
        return False


def train_restart(torch, seed, deterministic, tag) -> dict:
    """(e) at mamba2_13b's widths cut to TRAIN_CUT_LAYERS layers:
    TRAIN_RESTART_STEPS uninterrupted steps against half of them plus a
    resume of the rest from the checkpoint.  Default mode: the final loss
    within rel 1e-4; deterministic mode: a second uninterrupted run, and
    every loss and the final weights bit for bit."""
    import shutil
    import tempfile

    from repro_torch.distributed import pytree
    from repro_torch.train import loop

    cfg = cut_config(TRAIN_CUT_ARCH, TRAIN_CUT_LAYERS)
    n, half = TRAIN_RESTART_STEPS, TRAIN_RESTART_STEPS // 2
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed, log_every=100,
              print_fn=lambda s: None, device=DEVICE)
    d = tempfile.mkdtemp(prefix="chip-smoke-train-ckpt-")
    mode = "deterministic" if deterministic else "default"
    t0 = time.perf_counter()
    try:
        with (deterministic_mode(torch) if deterministic
              else contextlib.nullcontext()), \
                timed_checkpoints(torch) as ck:
            runs = [loop.run_training(cfg, n, **kw)]
            if deterministic:
                runs.append(loop.run_training(cfg, n, **kw))
            loop.run_training(cfg, half, ckpt_dir=d, ckpt_every=100, **kw)
            resumed = loop.run_training(cfg, n, ckpt_dir=d, ckpt_every=100,
                                        **kw)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    full = runs[0]
    finite_losses(f"(e) {mode}", full["losses"])
    rel = abs(resumed["final_loss"] - full["final_loss"]) / abs(
        full["final_loss"])
    rec = {"mode": mode, "losses": full["losses"],
           "resumed_losses": resumed["losses"], "final_loss_rel": rel,
           "checkpoint_mb": ck.saves[0][0] / 1e6,
           "save_mb_per_s": [b / 1e6 / s for b, s in ck.saves],
           "restore_mb_per_s": [ck.saves[0][0] / 1e6 / s
                                for s in ck.restores],
           "wall_s": time.perf_counter() - t0}
    if deterministic:
        same = (runs[1]["losses"] == full["losses"]
                and resumed["losses"] == full["losses"][half:]
                and all(torch.equal(x, y) and torch.equal(x, z)
                        for x, y, z in zip(*(pytree.leaves(o["state"])
                                             for o in (full, runs[1],
                                                       resumed)))))
        rec["bitwise"] = same
    log(f"[train] (e) restart, {mode} mode, {TRAIN_CUT_ARCH} cut to "
        f"{TRAIN_CUT_LAYERS} layers: {n} steps against {half} + a resume of "
        f"{n - half}: final loss rel diff {rel:.3e} (gate 1e-4)"
        + (f", every loss and the weights bit for bit: {rec['bitwise']}"
           if deterministic else "")
        + f"; checkpoint {rec['checkpoint_mb']:.1f} MB, save "
        f"{min(rec['save_mb_per_s']):.0f}-{max(rec['save_mb_per_s']):.0f} "
        f"MB/s, restore {rec['restore_mb_per_s'][0]:.0f} MB/s, "
        f"{rec['wall_s']:.1f} s wall {tag}")
    if not rel <= 1e-4 or (deterministic and not rec["bitwise"]):
        raise AssertionError(f"train (e) restart in the {mode} mode: "
                             f"{rec}")
    return rec


def phase_train(torch, seed, tag):
    """Training: (a) ``train_pair`` for each of TRAIN_PAIRS; (b)
    ``repro_torch.launch.train.main`` at mamba2_13b's published
    configuration (1.35 B parameters, bfloat16, batch 8, seq 128, 4 steps);
    (c) ``loop.run_training`` at TRAIN_DENSE_ARCH's published configuration
    (bfloat16, batch 8, seq 128) with one-pass token analytics on the
    ``async`` plane, scatter and estimate launched, ``top_tokens`` held to
    a CPU engine of the same ids, the last loss below the first; (d)
    ``train_compressed``; (e) ``train_restart`` in the default and the
    deterministic mode.  Step ms, tokens/s, peak memory and launches
    recorded."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.train import loop

    t_phase = time.perf_counter()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"pairs": {name: train_pair(torch, name, seed, tag)
                     for name in TRAIN_PAIRS}}
    torch.cuda.empty_cache()
    argv = TRAIN_CLI_ARGV + ["--device", DEVICE]
    res, rec = train_run(torch, f"(b) launch.train {' '.join(argv)}",
                         lambda: launch_train.main(argv), tokens, tag)
    finite_losses("(b) CLI", rec["losses"])
    rec["params_b"] = M.param_count(get_config("mamba2_13b")) / 1e9
    out["cli"] = rec
    del res
    cfg = get_config(TRAIN_DENSE_ARCH)
    res, rec = train_run(
        torch, f"(c) run_training {TRAIN_DENSE_ARCH}, analytics onepass on "
        f"async, top-{TRAIN_TOPK}",
        lambda: loop.run_training(
            cfg, TRAIN_DENSE_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            seed=seed, analytics_sampler="onepass", analytics_plane="async",
            analytics_topk=TRAIN_TOPK, log_every=100,
            print_fn=lambda s: log(f"[train] (c) {s}"), device=DEVICE),
        tokens, tag)
    finite_losses("(c) dense", rec["losses"], decreasing=True)
    got = rec["launches"]
    if not (got["scatter"] > 0 and got["estimate"] > 0
            and got["row_read"] == 0):
        raise AssertionError(f"train (c): launches {got}")
    top = res["top_tokens"]
    del res
    torch.cuda.empty_cache()
    rec["top_tokens_err"] = check_top_tokens(
        torch, top, train_analytics_reference(torch, cfg, seed))
    rec["params_b"] = M.param_count(cfg) / 1e9
    log(f"[train] (c) top-{TRAIN_TOPK} tokens {top[:4]}... equal to a CPU "
        f"engine's of the same ids (worst freq diff / scale "
        f"{rec['top_tokens_err']:.3e}) {tag}")
    out["dense"] = rec
    out["compressed"] = train_compressed(torch, seed, tag)
    torch.cuda.empty_cache()
    out["restart"] = {mode: train_restart(torch, seed, mode == "det", tag)
                      for mode in ("default", "det")}
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase] train: {out['wall_s']:.2f} s wall")
    return out


# ---------------------------------------------------------------------------
# the paper's runners, the examples, the dry-run
# ---------------------------------------------------------------------------

PAPER_FAST_RUNS = 10       # ``python -m repro_torch.paper --fast``'s Table 3
PAPER_N, PAPER_K = 10_000, 100


def phase_paper(torch, tag):
    """The four paper runners (``repro_torch.paper``) on the card at
    ``--fast``: each row printed with its time; no kernel launched (they go
    through ``core.worp``'s plain sketch, as the reference's do); for the
    first randomization of each Table 3 row the card's ``wor``, ``one``
    and ``two`` sample keys identical to a CPU run of the port's
    runner."""
    import math

    from repro_torch.paper import (fig1_wor_vs_wr, fig2_rankfreq,
                                   psi_calibration, table3_nrmse)
    from repro_torch.paper.common import zipf_freqs

    t_phase = time.perf_counter()
    reset_counts()
    runners = (
        ("table3", lambda: table3_nrmse.run(runs=PAPER_FAST_RUNS,
                                            verbose=False, device=DEVICE)),
        ("fig1", lambda: fig1_wor_vs_wr.run(verbose=False, device=DEVICE)),
        ("fig2", lambda: fig2_rankfreq.run(verbose=False, device=DEVICE)),
        ("psi", lambda: psi_calibration.run(verbose=False)))
    out = {"sections": {}}
    for label, fn in runners:
        t0 = time.perf_counter()
        rows = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for name, us, derived in rows:
            log(f"[paper] {name},{us:.2f},{derived} {tag}")
            nums = [float(x.split("=")[1]) for x in derived.split()
                    if "=" in x]
            if not all(math.isfinite(x) for x in nums):
                raise AssertionError(f"paper {name}: {derived}")
        out["sections"][label] = {"seconds": secs,
                                  "rows": [list(r) for r in rows]}
        log(f"[paper] {label}: {len(rows)} rows in {secs:.2f} s wall {tag}")
    out["launches"] = read_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"paper: the runners launched kernels "
                             f"{out['launches']}")
    out["keys_equal_cpu"] = {}
    for (p, alpha, power) in table3_nrmse.ROWS:
        freqs = zipf_freqs(PAPER_N, alpha, seed=int(alpha * 10))
        card = table3_nrmse.run_samples(freqs, PAPER_K, p, 5000, DEVICE)
        cpu = table3_nrmse.run_samples(freqs, PAPER_K, p, 5000, "cpu")
        for m in ("wor", "one", "two"):
            a = sorted(card[m].keys.cpu().tolist())
            b = sorted(cpu[m].keys.tolist())
            if a != b:
                raise AssertionError(
                    f"paper table3 l{p:g} zipf{alpha:g}: the card's {m} "
                    f"keys differ from the CPU's: "
                    f"{sorted(set(a) ^ set(b))}")
        label = f"l{p:g}_zipf{alpha:g}_pow{power:g}"
        out["keys_equal_cpu"][label] = True
        log(f"[paper] table3 {label} run 0: wor, one and two sample keys "
            f"equal to a CPU run {tag}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase] paper: {out['wall_s']:.2f} s wall")
    return out


# each port example, its arguments, and the claims it must print (and
# return) as true
EXAMPLES = (
    ("torch_quickstart", [], ("two_pass_equals_perfect",),
     ("two-pass == perfect p-ppswor: True",)),
    ("torch_stream_sampling", [], ("merged_equals_union",),
     ("merged sketch == sketch of the union: True",)),
    ("torch_async_ingest", [], ("async_equals_sync",
                                "aggregate_equals_single"),
     ("async drained state bitwise == sync sparse plane: True",
      "4-worker butterfly aggregate == single-worker sample keys: True")),
    ("torch_sharded_ingest", [], ("fan_in_equals_sync", "pershard_close"),
     ("threaded fan-in into async plane bitwise == sync plane: True",
      "per-shard sub-planes collapse (merge) to the fan-in state: True")),
    ("torch_serve_example", [], ("finite",), ("prefill logits finite: True",)),
    ("torch_train_worp_compressed", ["--steps", "3", "--timeout", "500"], (),
     ("final loss: ",)),
)
EXAMPLE_TIMEOUT_S = 600
# the train example's losses against a direct run_training on the card: one
# code path, so equal but for float atomics' order in the sketch scatter
TRAIN_EXAMPLE_RTOL = 1e-4
EXAMPLE_RUNNER = r"""
import importlib, json, sys
import numpy as np
sys.path[:0] = [sys.argv[1]]
from repro_torch.kernels import countsketch_query, launch_counts
out = importlib.import_module(sys.argv[2]).main(sys.argv[3:])
rank0 = out.pop("launches", None)
counts = dict(launch_counts(),
              estimate_single=countsketch_query.estimate_single_launches)
print("[example-result] " + json.dumps(
    {"out": {k: v for k, v in out.items()
             if not isinstance(v, np.ndarray)},
     "launches": counts, "rank0_launches": rank0}, default=str))
"""


def train_example_direct(torch, root, want, tag) -> float:
    """The train example's losses (its process, one NCCL rank) against a
    direct ``loop.run_training`` call in this process on the card with the
    example's settings (``ARCH``, ``BATCH``, ``SEQ``, ``LR``, ``CC``):
    within rel TRAIN_EXAMPLE_RTOL.  Returns the largest relative
    difference; None off the card, where the example runs 4 gloo ranks
    and a one-rank twin takes other candidates."""
    if DEVICE != "cuda":
        log("[examples] torch_train_worp_compressed: 4 CPU ranks, no "
            "one-rank twin")
        return None
    import importlib.util
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.optim import gradcomp
    from repro_torch.train import loop

    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_train_example",
        root / "examples" / "torch_train_worp_compressed.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    d = tempfile.mkdtemp(prefix="chip-smoke-example-")
    dist.init_process_group(
        "nccl" if DEVICE == "cuda" else "gloo", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
    try:
        got = loop.run_training(
            get_config(ex.ARCH).reduced(), len(want), batch=ex.BATCH,
            seq=ex.SEQ, lr=ex.LR, compressed=True,
            cc=gradcomp.CompressorConfig(**ex.CC), log_every=100,
            print_fn=lambda s: None, device=DEVICE)["losses"]
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(want, got))
    if len(got) != len(want) or not rel <= TRAIN_EXAMPLE_RTOL:
        raise AssertionError(f"example torch_train_worp_compressed: losses "
                             f"{want} against a direct run_training's {got}")
    log(f"[examples] torch_train_worp_compressed: losses {want} against a "
        f"direct run_training's {got}: max rel diff {rel:.3e} (gate "
        f"{TRAIN_EXAMPLE_RTOL:g}) {tag}")
    return rel


def phase_examples(torch, tag):
    """The six port examples (``examples/torch_*.py``), each in its own
    process on the card, all started together: each must exit 0, print its
    claims true and return them true; the train example runs 3 steps over
    one NCCL rank with checkpoints in a temporary directory, and its
    losses are held to a direct ``run_training`` call
    (``train_example_direct``).  The kernel launches are read from the
    children (the train example's from its rank 0)."""
    import math
    import tempfile

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = {"examples": {}}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, argv, _, _ in EXAMPLES:
            extra = (["--ckpt", os.path.join(tmp, "ckpt")]
                     if name == "torch_train_worp_compressed" else [])
            extra += ["--device", DEVICE] if DEVICE != "cuda" else []
            procs[name] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-c", EXAMPLE_RUNNER, str(root / "examples"),
                 name] + argv + extra, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env, cwd=str(root)))
        try:
            for name, argv, keys, lines in EXAMPLES:
                t0, proc = procs[name]
                stdout, stderr = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
                secs = time.perf_counter() - t0
                result = [ln for ln in stdout.splitlines()
                          if ln.startswith("[example-result] ")]
                if proc.returncode != 0 or len(result) != 1:
                    raise AssertionError(
                        f"example {name}: exit {proc.returncode}\n"
                        f"{stdout[-3000:]}\n{stderr[-3000:]}")
                rec = json.loads(result[0].split(" ", 1)[1])
                printed = stdout.splitlines()
                bad = [k for k in keys if rec["out"].get(k) is not True]
                bad += [ln for ln in lines
                        if not any(x.startswith(ln) for x in printed)]
                if name == "torch_train_worp_compressed":
                    losses = rec["out"]["losses"]
                    if not (len(losses) == 3
                            and all(math.isfinite(x) for x in losses)):
                        bad.append(f"losses {losses}")
                if bad:
                    raise AssertionError(f"example {name}: claims not true: "
                                         f"{bad}\n{stdout[-3000:]}")
                launches = rec["launches"]
                if rec["rank0_launches"]:
                    launches = {k: launches.get(k, 0) + v for k, v in
                                rec["rank0_launches"].items()}
                    launches.setdefault("estimate_single", 0)
                claims = [x for x in printed if any(x.startswith(ln)
                                                    for ln in lines)]
                out["examples"][name] = {"seconds": secs, "claims": claims,
                                         "launches": launches}
                if "losses" in rec["out"]:
                    out["examples"][name]["losses"] = rec["out"]["losses"]
                log(f"[examples] {' '.join([name] + argv)}: exit 0 in "
                    f"{secs:.1f} s wall; {claims}; launches {launches} "
                    f"{tag}")
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(30)
    train = out["examples"]["torch_train_worp_compressed"]
    train["direct_max_rel"] = train_example_direct(torch, root,
                                                   train["losses"], tag)
    keys = ("scatter", "smem", "global", "det", "segment_sum", "estimate",
            "estimate_single", "row_read", "other")
    out["launches"] = {k: sum(e["launches"].get(k, 0)
                              for e in out["examples"].values())
                       for k in keys}
    for name in ("torch_stream_sampling", "torch_async_ingest",
                 "torch_sharded_ingest"):
        got = out["examples"][name]["launches"]
        if DEVICE == "cuda" and not (got["scatter"] > 0
                                     and got["estimate"]
                                     + got["estimate_single"] > 0):
            raise AssertionError(f"example {name}: launches {got}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase] examples: {out['wall_s']:.2f} s wall, launches "
        f"{out['launches']}")
    return out


DRYRUN_ARCHS = ("mamba2_13b", "gemma2_2b")
DRYRUN_STEP = (8, 128)      # the train phase's CLI and loop steps: B x S
DRYRUN_TIMEOUT_S = 600
DRYRUN_STEPS_TIMED = 3


def card_step(torch, arch) -> dict:
    """One train step of ``arch`` at DRYRUN_STEP on the card, in a process
    of its own (``--card-step``): the allocator's bytes (``memory_
    allocated()`` and the requested bytes) added by ``init_params`` and by
    ``adamw.init``, the step's FLOPs under ``FlopCounterMode``, the
    median time of DRYRUN_STEPS_TIMED more steps, and the peak memory of
    the steps."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import ZipfStream
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    dev = torch.device(DEVICE)
    cfg = get_config(arch)

    def mem():
        torch.cuda.synchronize()
        st = torch.cuda.memory_stats()
        return (torch.cuda.memory_allocated(),
                st.get("requested_bytes.all.current", -1))

    torch.cuda.empty_cache()
    m0 = mem()
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    m1 = mem()
    opt = adamw.init(params)
    m2 = mem()
    B, S = DRYRUN_STEP
    batch = ZipfStream(vocab_size=cfg.vocab_size, alpha=1.2,
                       seed=0).lm_batch(0, shard=0, batch=B, seq=S,
                                        device=dev)
    state = steps.TrainState(params=params, opt=opt)
    del params, opt
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        state, _ = steps.train_step(state, batch, cfg)
    torch.cuda.synchronize()
    ms = []
    for _ in range(DRYRUN_STEPS_TIMED):
        t0 = time.perf_counter()
        state, metrics = steps.train_step(state, batch, cfg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    rec = {"arch": arch, "param_allocated": m1[0] - m0[0],
           "param_requested": m1[1] - m0[1],
           "moment_allocated": m2[0] - m1[0],
           "moment_requested": m2[1] - m1[1],
           "flops": float(fc.get_total_flops()), "step_ms": ms,
           "loss": float(metrics["loss"]),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del state
    torch.cuda.empty_cache()
    return rec


def start_dryrun_sweep():
    """``python -m repro_torch.launch.dryrun`` over every arch x shape on
    one card, into ``build/dryrun_smoke``, started in the background (it
    counts on meta tensors, on the host alone): (the process, its output
    directory)."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out_dir = root / "build" / "dryrun_smoke"
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(out_dir), "--force"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(root)), out_dir


def phase_dryrun(torch, tag, sweep=None):
    """The dry-run sweep (``start_dryrun_sweep``; started here unless the
    caller started it earlier): every cell ``ok`` or a documented skip.
    Once it has ended, the dry-run's reckoning of the
    train phase's two steps (DRYRUN_ARCHS at DRYRUN_STEP, a ``ShapeCell`` of
    that size) is held to ``card_step`` in a fresh process (its allocator with
    expandable segments, so that each block is its request rounded to 512
    B): gated, the counted FLOPs within relative 1e-6 of the card's
    ``FlopCounterMode`` count, and the parameter and moment bytes equal to
    the requested-bytes and ``memory_allocated()`` deltas; printed, the
    predicted peak against the measured one and the model-FLOP share of
    the card's bf16 peak at the measured step time."""
    from repro_torch.configs.base import ARCH_NAMES, SHAPES, ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analyzer

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    sweep, out_dir = sweep or start_dryrun_sweep()
    out = {}
    try:
        # the card step is timed after the sweep has ended: a step is bound
        # by its host's Python loop, which another process would slow
        stdout, stderr = sweep.communicate(timeout=DRYRUN_TIMEOUT_S)
        t0 = time.perf_counter()
        card = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--card-step",
             ",".join(DRYRUN_ARCHS)], capture_output=True, text=True,
            timeout=DRYRUN_TIMEOUT_S, cwd=str(root),
            env=dict(env, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
        card_s = time.perf_counter() - t0
        recs = [json.loads(ln.split(" ", 1)[1])
                for ln in card.stdout.splitlines()
                if ln.startswith("[card-step] ")]
        if card.returncode != 0 or len(recs) != len(DRYRUN_ARCHS):
            raise AssertionError(f"card step: exit {card.returncode}\n"
                                 f"{card.stdout[-3000:]}\n"
                                 f"{card.stderr[-3000:]}")
        B, S = DRYRUN_STEP
        cell = ShapeCell(f"train_{B}x{S}", S, B, "train")
        out["steps"] = {}
        for got in recs:
            arch = got["arch"]
            t1 = time.perf_counter()
            rec = dryrun.run_cell(arch, cell.name, shape=cell, verbose=False)
            count_s = time.perf_counter() - t1
            mem = rec["memory_stats"]
            rel = abs(rec["flops"] - got["flops"]) / got["flops"]
            step_ms = sorted(got["step_ms"])[len(got["step_ms"]) // 2]
            share = rec["model_flops"] / (step_ms / 1e3) / \
                analyzer.PEAK_FLOPS
            counted_share = rec["flops"] / (step_ms / 1e3) / \
                analyzer.PEAK_FLOPS
            row = {
                "count_seconds": count_s, "flops": rec["flops"],
                "card_flops": got["flops"], "flops_rel_err": rel,
                "model_flops": rec["model_flops"],
                "param_bytes": mem["param_bytes"],
                "param_alloc_bytes": mem["param_alloc_bytes"],
                "card_param_requested": got["param_requested"],
                "card_param_allocated": got["param_allocated"],
                "moment_bytes": mem["moment_bytes"],
                "moment_alloc_bytes": mem["moment_alloc_bytes"],
                "card_moment_requested": got["moment_requested"],
                "card_moment_allocated": got["moment_allocated"],
                "predicted_peak_gb": mem["peak_bytes"] / 1e9,
                "saved_gb": mem["saved_bytes"] / 1e9,
                "card_peak_gb": got["peak_bytes"] / 1e9,
                "step_ms": got["step_ms"], "steady_step_ms": step_ms,
                "model_flop_share_of_peak": share,
                "counted_flop_share_of_peak": counted_share,
                "t_compute_ms": rec["t_compute"] * 1e3,
                "t_memory_ms": rec["t_memory"] * 1e3,
                "bottleneck": rec["bottleneck"], "loss": got["loss"]}
            out["steps"][arch] = row
            log(f"[dryrun] {arch} train {B}x{S}: counted {rec['flops']:.6e} "
                f"FLOPs vs the card's FlopCounterMode {got['flops']:.6e} "
                f"(rel {rel:.2e}); params {mem['param_bytes']} B requested "
                f"{got['param_requested']} B, {mem['param_alloc_bytes']} B "
                f"allocated {got['param_allocated']} B; moments "
                f"{mem['moment_bytes']} / {got['moment_requested']} B, "
                f"{mem['moment_alloc_bytes']} / {got['moment_allocated']} "
                f"B; predicted peak {row['predicted_peak_gb']:.2f} GB vs "
                f"measured {row['card_peak_gb']:.2f} GB; step "
                f"{step_ms:.1f} ms: model FLOPs {share:.2%} of the bf16 "
                f"peak, counted FLOPs {counted_share:.2%}; roofline "
                f"compute {row['t_compute_ms']:.2f} ms, memory "
                f"{row['t_memory_ms']:.2f} ms ({rec['bottleneck']}) {tag}")
            if not (rel <= 1e-6
                    and mem["param_bytes"] == got["param_requested"]
                    and mem["param_alloc_bytes"] == got["param_allocated"]
                    and mem["moment_bytes"] == got["moment_requested"]
                    and mem["moment_alloc_bytes"]
                    == got["moment_allocated"]):
                raise AssertionError(f"dryrun {arch}: the reckoning misses "
                                     f"the card: {row}")
        out["card_step_s"] = card_s
    finally:
        if sweep.poll() is None:
            sweep.kill()
            sweep.wait(30)
    if sweep.returncode != 0:
        raise AssertionError(f"dryrun sweep: exit {sweep.returncode}\n"
                             f"{stdout[-3000:]}\n{stderr[-3000:]}")
    cells = {}
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            with open(out_dir / f"{arch}__{shape}__card.json") as f:
                rec = json.load(f)
            ok = rec["status"] == "ok" or (
                rec["status"] == "skip" and "documented" in rec["reason"])
            if not ok:
                raise AssertionError(f"dryrun {arch} {shape}: {rec}")
            cells[f"{arch}/{shape}"] = (
                rec["status"] if rec["status"] == "skip" else
                {k: rec[k] for k in ("flops", "hbm_bytes", "t_compute",
                                     "t_memory", "bottleneck", "fits",
                                     "useful_ratio", "count_seconds")}
                | {"peak_gb": rec["memory_stats"]["peak_bytes"] / 1e9})
    out["cells"] = cells
    n_ok = sum(1 for v in cells.values() if v != "skip")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[dryrun] sweep: {n_ok} cells ok, {len(cells) - n_ok} documented "
        f"skips {tag}")
    log(f"[phase] dryrun: {out['wall_s']:.2f} s wall")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated streams and gradients")
    ap.add_argument("--sass", action="store_true",
                    help="only count the transform factor's SASS, old and "
                         "new, and exit")
    ap.add_argument("--det-parent", default=None, type=Path, nargs="+",
                    help="only time the dense update's det kernel of the "
                         "checkouts at these directories beside this "
                         "tree's, and exit")
    ap.add_argument("--card-step", default=None,
                    help="only run ``card_step`` for these comma-separated "
                         "architectures and print a record of each (the "
                         "dry-run phase's fresh process)")
    args = ap.parse_args()
    if args.sass:
        return factor_sass()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    if args.det_parent is not None:
        return det_parent_ab(torch, [d.resolve() for d in args.det_parent],
                             args.seed)
    if args.card_step:
        for arch in args.card_step.split(","):
            log("[card-step] " + json.dumps(card_step(torch, arch)))
        return 0

    from repro_torch.engine import derive_stream_seeds
    from repro_torch.engine.engine import EngineConfig
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # -- phase 1: the card and the build --------------------------------
    t_phase = time.perf_counter()
    smi = card_info()
    tag = f"[{smi}]"
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(smi)
    log(f"[card] {kind} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda} {tag}")
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.2f} s "
        f"wall (" + ", ".join(f"{b.name} {b.seconds:.2f} s"
                              for b in built.values()) + ")")
    for b in built.values():
        for line in b.log.splitlines():
            if line.strip():
                log(f"[build] {b.name}: {line.strip()}")
    report_occupancy(tag)
    log(f"[phase] 1 card and build: {time.perf_counter() - t_phase:.2f} s "
        f"wall")

    # -- phases 2-4: the sparse plane -------------------------------------
    cfg = EngineConfig(num_streams=B, rows=ROWS, width=WIDTH,
                       candidates=CANDIDATES, p=P)
    seeds, tseeds = derive_stream_seeds(cfg, device=dev)
    (stream, steps), kernels, errs = phase_sparse(torch, args, seeds, tseeds,
                                                  tag)
    del seeds, tseeds
    torch.cuda.empty_cache()

    # -- phase 5: dense segments; phase 6: single-stream entry points -----
    entry, wg_values, dense_estimates, dense_est = phase_dense(torch, args,
                                                               tag)
    kernels.append(entry)
    single = phase_single(torch, wg_values, tag)
    kernels.extend(single)
    torch.cuda.empty_cache()

    # -- the samplers phase: twopass, tv, onepass pass II, perfect -------
    sampler_launches, samplers = phase_samplers(torch, steps, stream, tag)
    torch.cuda.empty_cache()

    # -- the deterministic flush path, the async and pipeline planes ------
    det_launches, planes = phase_determinism(torch, steps, tag)
    torch.cuda.empty_cache()

    # -- the wire: codecs, the pipeline's codec, serving, checkpoints, fleet
    wire_launches, wire = phase_wire(torch, steps, tag)
    torch.cuda.empty_cache()

    # -- the multi-process fleet; WORp gradient compression ----------------
    fleet_launches, fleet = phase_fleet(torch, steps, tag)
    del steps, stream
    torch.cuda.empty_cache()
    gc_launches, gradcomp = phase_gradcomp(torch, args.seed, tag)
    torch.cuda.empty_cache()

    # -- the deterministic dense update; serving at gemma2_2b's full size --
    det_update = phase_det_update(torch, args.seed, tag)
    torch.cuda.empty_cache()
    served = phase_serve(torch, args.seed, tag)
    torch.cuda.empty_cache()
    families = phase_families(torch, args.seed, tag)
    torch.cuda.empty_cache()
    trained = phase_train(torch, args.seed, tag)
    torch.cuda.empty_cache()

    # -- the conformance grid; the ingest pipeline -------------------------
    validate_launches, validate = phase_validate(torch, tag)
    torch.cuda.empty_cache()
    ingest_launches, ingest_det, ingest = phase_ingest(torch, args.seed, tag)
    torch.cuda.empty_cache()

    # -- the paper's runners, the examples, the dry-run (its sweep on the
    # host meanwhile) -----------------------------------------------------
    sweep = start_dryrun_sweep()
    try:
        paper = phase_paper(torch, tag)
        torch.cuda.empty_cache()
        examples = phase_examples(torch, tag)
    except BaseException:
        sweep[0].kill()
        sweep[0].wait(30)
        raise
    dry = phase_dryrun(torch, tag, sweep)

    # -- phase 7: the kernels line and the ok line -------------------------
    by_name = {k["name"]: k for k in kernels}
    est = by_name["countsketch_estimate_batched"]
    est["launches"] += dense_estimates
    est["dense_shape"] = {
        "ms": dense_est["estimate"], "plain_ms": dense_est["plain"],
        "bound_ms": dense_est["bound"], "bound_by": dense_est["bound_by"],
        "library_ms": dense_est["library"],
        "row_read_median_ms": dense_est["row_read_median"],
        "row_read_ms": dense_est["row_read"]}
    log(f"[main] estimate launches on the dense path: {dense_estimates}; "
        f"worst err/bound of the update at its edge shapes "
        f"{errs['update_edge_ratio']:.3e}")
    scatter = by_name["countsketch_scatter_batched"]
    scatter["launches"] += sampler_launches["scatter"]
    scatter["variants"]["smem"]["launches"] += sampler_launches["smem"]
    scatter["tv_cascade_shape"] = samplers["tv_shapes"]["scatter"]
    est["launches"] += sampler_launches["estimate"]
    for key in ("refresh", "draw"):
        t = samplers["tv_shapes"][f"estimate_{key}"]
        est[f"tv_{key}_shape"] = {
            "ms": t["estimate"], "plain_ms": t["plain"],
            "bound_ms": t["bound"], "bound_by": t["bound_by"],
            "library_ms": t["library"],
            "row_read_median_ms": t["row_read_median"],
            "row_read_ms": t["row_read"]}
    scatter["launches"] += det_launches["scatter"]
    est["launches"] += det_launches["estimate"]
    sf, stv = planes["scatter_flush"], planes["scatter_tv"]
    scatter["variants"]["det"] = {
        "launches": det_launches["det"],
        "max_abs_err": sf["max_abs_err"],
        "worst_err_over_bound": max(sf["worst_err_over_bound"],
                                    stv["worst_err_over_bound"]),
        "vs_atomics_worst_err_over_bound": max(
            sf["vs_atomics_worst_err_over_bound"],
            stv["vs_atomics_worst_err_over_bound"]),
        "ms": sf["ms"], "bound_ms": sf["bound_ms"],
        "bound_by": sf["bound_by"], "atomics_ms": sf["atomics_ms"],
        "plan": plan_of(B, INSERTS + int(INSERTS * DELETE_FRACTION), None,
                        variant="det"),
        "occupancy": OCCUPANCY.get(("countsketch_scatter", "det")),
        "ratio_to_atomics": sf["ratio_to_atomics"],
        "tv_cascade_shape": {k: stv[k] for k in (
            "ms", "atomics_ms", "bound_ms", "bound_by",
            "ratio_to_atomics")},
        "wide_table": dict(planes["scatter_wide"], occupancy=OCCUPANCY.get(
            ("countsketch_scatter", "det 32-bit entries"))),
        "split_tables": {what: dict(rec, occupancy=(
            OCCUPANCY.get(("countsketch_scatter", f"det split {what}"))))
            for what, rec in planes["scatter_split"].items()}}
    # the wire phase's, the conformance grid's and the feeder's launches
    # (their default-mode runs take the shared-memory variant; their
    # deterministic runs the det variant and the segment sum)
    for got in (wire_launches, validate_launches, ingest_launches,
                ingest_det, fleet_launches):
        scatter["launches"] += got["scatter"]
        scatter["variants"]["smem"]["launches"] += got["smem"]
        scatter["variants"]["det"]["launches"] += got["det"]
        est["launches"] += got["estimate"]
    scatter["validate_launches"] = {
        k: validate_launches[k] for k in ("scatter", "smem", "det")}
    scatter["ingest_launches"] = {
        k: ingest_launches[k] + ingest_det[k]
        for k in ("scatter", "smem", "det")}
    scatter["wire_launches"] = {k: wire_launches[k]
                                for k in ("scatter", "smem", "det")}
    est["wire_launches"] = wire_launches["estimate"]
    scatter["fleet_launches"] = {k: fleet_launches[k]
                                 for k in ("scatter", "smem", "det")}
    est["fleet_launches"] = fleet_launches["estimate"]
    est["launches"] += gc_launches["estimate"]
    est["gradcomp_launches"] = gc_launches["estimate"]
    update = by_name["countsketch_update_batched"]
    update["launches"] += gc_launches["update"]
    update["variants"]["smem"]["launches"] += gc_launches["update"]
    update["gradcomp_launches"] = gc_launches["update"]
    det_paths = [det_update["launches"][k]["det"]
                 for k in ("update_dense", "gradcomp")]
    update["launches"] += sum(det_paths)
    update["variants"]["det"] = {
        "launches": sum(det_paths),
        "launches_by_path": dict(zip(("update_dense", "gradcomp"),
                                     det_paths)),
        "parity": "bit for bit ref.countsketch_update_det_ref (its order "
                  "model, at the plan's chunk) on the card; per-cell "
                  "rounding bound of the plain version and of the atomics",
        "design": "det_dense_block (csrc/smem_table.cuh): a warp "
                  "a row hashes its row's buckets and signs and adds them "
                  "in slot order over a stage of transformed values that "
                  "every thread fills; countsketch_chunk_sum adds the chunk "
                  "tables in chunk order; a table too large for one block "
                  "goes to det_cluster_block, a thread block cluster a "
                  "chunk whose producer warps hash each slot once and push "
                  "it to the CTA that owns its cell",
        **{key: det_update[key] for key in (
            "max_abs_err", "worst_err_over_bound", "vs_atomics_max_abs_err",
            "vs_atomics_worst_err_over_bound", "ms", "plain_ms", "bound_ms",
            "bound_by", "atomics_ms", "ratio_to_atomics", "plan",
            "occupancy", "single_segment")},
        "split_tables": {what: dict(rec, occupancy=OCCUPANCY.get((
            "countsketch_update", f"det split {rec['rows']} x "
            f"{rec['width']}"))) for what, rec in
            det_update["split_tables"].items()},
        "library_ms": update["library_ms"],
        "plain": "ref.countsketch_update_det_ref on the card",
        "library": "index_add_ of the transformed terms (memory half only)"}
    for label in ("full", "workers"):
        got = served[label]["launches"]
        scatter["launches"] += got["scatter"]
        scatter["variants"]["smem"]["launches"] += got["smem"]
        est["launches"] += got["estimate"]
        scatter.setdefault("serve_launches", {})[label] = got["scatter"]
        est.setdefault("serve_launches", {})[label] = got["estimate"]
    family_runs = {name: families[name]["launches"]
                   for name, _ in FAMILY_CLI}
    family_runs["mamba2_13b default prompt"] = families[
        "mamba2_13b_default_prompt"]["launches"]
    for label, got in family_runs.items():
        scatter["launches"] += got["scatter"]
        scatter["variants"]["smem"]["launches"] += got["smem"]
        est["launches"] += got["estimate"]
        scatter.setdefault("families_launches", {})[label] = got["scatter"]
        est.setdefault("families_launches", {})[label] = got["estimate"]
    for label in ("cli", "dense", "compressed"):
        got = trained[label]["launches"]
        scatter["launches"] += got["scatter"]
        scatter["variants"]["smem"]["launches"] += got["smem"]
        scatter["variants"]["det"]["launches"] += got["det"]
        est["launches"] += got["estimate"]
        scatter.setdefault("train_launches", {})[label] = got["scatter"]
        est.setdefault("train_launches", {})[label] = got["estimate"]
    got = examples["launches"]
    scatter["launches"] += got["scatter"]
    for v in ("smem", "global", "det"):
        scatter["variants"][v]["launches"] += got[v]
    est["launches"] += got["estimate"]
    by_name["countsketch_estimate"]["launches"] += got["estimate_single"]
    scatter["examples_launches"] = {
        name: e["launches"]["scatter"]
        for name, e in examples["examples"].items()}
    est["examples_launches"] = {
        name: e["launches"]["estimate"]
        for name, e in examples["examples"].items()}
    by_name["countsketch_estimate"]["examples_launches"] = {
        name: e["launches"]["estimate_single"]
        for name, e in examples["examples"].items()}
    est["validate_launches"] = validate_launches["estimate"]
    est["ingest_launches"] = (ingest_launches["estimate"]
                              + ingest_det["estimate"])
    ssf, sstv = planes["segment_sum_flush"], planes["segment_sum_tv"]
    kernels.append({
        "name": "segment_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
        "replaces": "src/repro/core/worp.py:70 (jax.ops.segment_sum in XLA, "
                    "no pallas_call; the deterministic mode's form of "
                    "scatter_add_)",
        "launches": (det_launches["segment_sum"]
                     + wire_launches["segment_sum"]
                     + validate_launches["segment_sum"]
                     + ingest_det["segment_sum"]
                     + fleet_launches["segment_sum"]
                     + examples["launches"]["segment_sum"]),
        "max_abs_err": 0.0,
        "parity": "bit for bit equal to the CPU's scatter_add_ (index "
                  "order), the same bits on every launch",
        "ms": ssf["ms"], "plain_ms": ssf["plain_ms"],
        "bound_ms": ssf["bound_ms"], "bound_by": ssf["bound_by"],
        "library_ms": ssf["library_ms"],
        "ratio_to_atomics": ssf["ratio_to_atomics"],
        "plain": "PyTorch's deterministic scatter_add_ (the mode on)",
        "library": "scatter_add_ with atomics (the mode off)",
        "occupancy": OCCUPANCY.get(("segment_sum", "")),
        "plan": segment_plan_of(B),
        "tv_cascade_shape": sstv})
    log("[samplers] " + json.dumps({k: v for k, v in samplers.items()
                                    if k != "tv_shapes"}))
    log("[planes] " + json.dumps({k: v for k, v in planes.items()
                                  if k not in ("scatter_flush", "scatter_tv",
                                               "scatter_wide", "scatter_split",
                                               "segment_sum_flush",
                                               "segment_sum_tv")}))
    log("[wire] " + json.dumps(wire))
    log("[validate] " + json.dumps(
        {k: v for k, v in validate.items() if k != "launches"}))
    log("[ingest] " + json.dumps(ingest))
    log("[fleet] " + json.dumps(fleet))
    log("[gradcomp] " + json.dumps(gradcomp))
    log("[det update] " + json.dumps(det_update))
    log("[serve] " + json.dumps(served))
    log("[families] " + json.dumps(families))
    log("[train] " + json.dumps(trained))
    log("[paper] " + json.dumps(paper))
    log("[examples] " + json.dumps(examples))
    log("[dryrun] " + json.dumps(dry))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
