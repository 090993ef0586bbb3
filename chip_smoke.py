#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. The card (name, power limit) and the kernel build (``nvcc``, one process
   per ``csrc/*.cu``, all at once), with the native host library
   (``native/*.cpp``, ``g++``) built beside them.
2. Kernels vs plain versions on edge cases: K1 (gather + dequant) bit-exact on
   int8 / fp8 / bf16 / f32 / int4 tables with device, per-key and no scales,
   N = 0 and the miss row; K2 / K3 (dot interaction) on general and
   part-major feature maps with phantom rows and on int8 / fp8 / bf16 / f32
   arenas, within rtol 1e-5 and atol 1e-6 * max|z|^2: both sides see the same
   bf16 z and differ only in the order of the f32 sums. K6 (the one-hot
   worklist gather, v1 and v2) bit for bit (compared as int32 bit patterns,
   so the sign of a zero counts) on int8 / fp8 / bf16 / f32 arenas holding
   -0.0 and, for bf16 / f32, +-inf, with members of [700] and [3, 1461,
   2174, 5684] rows, several key tiles per member, m_tile 32, 64, 512 and
   4096, slots outside their member's tiles (zero rows), on int8 against K1,
   and on plans that visit a row tile twice (with and without a miss
   between) at D 36 and 128; every invalid plan raises. The grouped K1 (one
   launch per lookup) bit-exact on every storage kind in one call, device /
   per-key / no scales, empty and skipped groups, one-hot groups with slots
   outside their member (zero rows) and odd widths; K3, K2 and K4's forward
   at F in {2, 27, 128, 129, 300} (past 128 fed features and past one
   16-row block of pairs) with members and slots outside them. The routes
   past the former limits against their plain versions (each must take its
   wide plan): the forward at F 689 and 1,100 (z in shared memory; past one
   warp's tile and past 1,024 fed features or one-hot members) and at 800
   and 850 (z in device memory), the backward at F 148 and 700 (through
   autograd, and K2's parts with gradients not asked for), K5 with N <= 8
   at K 29,057, 30,000 and 100,000 (every activation). K2, K3 and K4's bf16
   route (bf16 bottom, features and output; ``bf16_interaction_checks``) at
   the same F, B 37 (odd output rows start on odd 2-byte boundaries), D 128,
   36 and 31, every arena kind, the wide route too: the bottom copy exact,
   the pairs within 1 bf16 ulp of the plain version (plus the f32 atol where
   a sum cancels); a CUDA tensor of another type still raises.
3. The main path at full width: a Criteo-Kaggle-shaped DLRM (the 26
   categorical cardinalities, each capped at 262,144 rows; D = 128, int8;
   13 dense features; bottom MLP 512-256-128, top MLP 1024-1024-512-256-1;
   random weights from a numpy seed) through ``HierParameterServer`` ->
   ``LookupSession.lookup`` (bit-exact against a host dequant) ->
   ``make_dlrm_multi_server(...).predict`` on batches of 4096, with the
   one-hot group folded into the interaction (K1 + K3) and with
   ``HPS_OH_IN_KERNEL=0`` (K1 + K2). The launch counts of the run must show
   every kernel, and K1 exactly once per lookup and per predict on both
   paths. Key translation A/B on the same batches: the native StaticMap's
   slots bit-identical to the searchsorted lookup on all 26 tables and 3
   batches, and the host time of each (one batch call over the tables, per
   table, searchsorted) and of the argument assembly.
4. K5 (the w8a8 dense layer) against its plain version at every boundary
   of its launch plan (``k5_plan``: the GEMV, the narrow kernel, and the
   quantize kernel with the mma.sync or the wgmma product): N in {1, 8, 9,
   127, 128, 129, 256, 257, 1024}, M in {1, 63, 65, 4097}, K in {13, 256,
   479, 479 with weight rows padded to 480, 1024, 2944}, five more shapes
   and six with K from 2945 to GEMV_MAX_K (29,056), with the activations
   and the bias cycling over the cases (all of them on one shape per path);
   past N = 8 every other plan the kernel takes for the shape as well
   (``k5_plans``). A w8a8 ``QuantDense(479, 1024)`` called directly
   (``k5_quant_dense_check``) hands K5 the rows behind ``kernel_q``,
   padded to 16 bytes, its one copy of the weight: the ``wgmma`` plan
   (``narrow`` on [N, K] rows), bit-equal to the plain version on the
   unpadded weight, the state_dict still [N, K].
   Rows of zeros and rows that quantize on half-integers
   among the inputs, junk in the weight rows' padding: bit-exact for act
   None and relu, within rtol 1e-6 and atol 1e-6 for sigmoid, tanh and
   gelu.
5. The quantized-dense main path on the same deployment: ``DLRM(quant_fmt=
   "w8a8")`` with the f32 weights of phase 3 put through
   ``quantize_model_params``, served by ``make_dlrm_multi_server`` at batch
   4096 with the fold and without. Its launch counts must show K5 at 8 per
   predict (K1 and K3/K2 as before); logits finite, fold vs no fold rel
   < 5e-3, and the first 64 samples against the port on the CPU within
   1e-2 * max|logit| (the interaction's f32 sums run in another order on the
   CPU, and an element one ulp apart can move the top layer-0 quantization
   by one step).
5b. The front end (the "frontend" phase): ``serve(cfg, port=0,
   block=False, grpc_port=None)`` on the card with max_batch_size 256 over
   the same sparse files (gRPC: on the CPU, and in phase 5e), and the JAX
   package's end-to-end traffic (``bench.py``): 64-sample binary-tensor
   requests, one key a table, Zipf(1.05) over each table's keys plus ~1 %
   keys absent from every table, 8 clients for 10 s after the pow2 buckets
   64, 128 and 256 are warm. Printed: qps, samples/s, p50 / p99, the mean
   merged batch, K1 launches per merged batch (exactly one), the card's
   idle share over a 2 s profiled slice (the clients are threads of a
   separate process), the batcher's mean queue / dispatch / software time,
   and where one merged batch's dispatch goes (``dispatch_breakdown``). Checked (any failure fails the run): 64 responses of
   the loaded window bit for bit against the host dequant of their keys
   (with requests co-batched: mean merged batch > 64), a JSON request
   against the binary one, a malformed request answered 400 while the
   clients keep being served, health / metadata / repository index 200,
   ``/metrics`` holding the batcher's counters, and unload + load serving
   the same bytes again.
5c. The hierarchy behind the cache (the "dynamic_tiers" phase,
   ``dynamic_tiers``) at full width on the same sparse files: a ps.json that
   leaves ``embedding_cache_type`` out (dynamic), gpucacheper 0.5, a hash-map
   DRAM tier loaded at 0.5, the SSD tier (``rocks_db``, 0.95 GB of f32
   records) and a ``kafka_message_queue`` update source on an in-process
   ``MiniKafkaBroker``; Zipf(1.05) batches of 4096 keys a table with ~1 %
   keys absent. (1) 12 batches with synchronous inserts: answers and the
   resident key -> slot maps bit-identical to a CPU instance of the port
   after every batch, K1 exactly once per lookup; per batch the hit rate,
   inserts, evictions, lookup wall, the inserts' quantize and scatter
   times, the DRAM and SSD query times. (2) 40 batches at the default
   threshold (the drainer inserts): every answer its key's f32 tier row or
   that row's host dequant, never NaN; dropped inserts, queue depth, hit
   rate. (3) stochastic and UVM caches, 6 batches each, held to their CPU
   instances; a UVM ``refresh`` must admit missed keys. (4) the fold predict
   (K1 + K3) on the dynamic cache with a resident batch: logits bit-identical
   to a static deployment's of the same lookup groups. (5) new rows for
   4096 keys of 4 tables posted through the producer: once the consumer has
   applied them and after ``refresh(1.0)``, each updated key serves its new
   row (its dequant where resident, the f32 row from the tiers where not),
   every other key its old row, and the CPU instance agrees bit for bit.
5d. The model zoo (the "zoo" phase, ``zoo_phase``), each output held
   against a CPU instance of the port (its own parameter server on the
   CPU) on the same weights (Flax's initialisation from a seeded
   generator) and keys: logits rel < 1e-3, retrieval scores rel < 1e-3 and
   the retrieved keys equal at every position more than that from its
   neighbours. K1 must launch exactly once per multi-table predict, twice
   per DIN / BST predict and once per retrieve, no other kernel, and no
   plain version of K1 may see a CUDA tensor. (0) Each bf16 product of
   the served models (DCN-v2, BST, DIN) and of the bf16 DLRM (13 -> 512,
   479 -> 1024) at its serving shape, on seeded operands with biases of
   0.1 N(0, 1), in four forms against the CPU's repaired product
   (``bf16_product_split``): (a) ``F.linear`` with the bias, (b) without,
   then the bias, (c) the repaired product (the f32 SGEMM of the bf16
   operands, rounded once), then the bias, (d) the same on the tensor
   cores (``out_dtype=torch.float32``), then the bias; one line per
   product with each form's share of differing
   outputs and its product's largest gap in bf16 ulps. (c) must stay
   within 1 ulp with at most 1 % of outputs differing at every product,
   and (a) must miss that bar somewhere. (1) DCN-v2 (BASELINE config
   3) at the JAX defaults (3 cross layers of rank 64, deep 1024-512-256,
   head 128-1; width 3,341) through ``make_dcn_server`` on phase 3's
   deployment, batch 4096. (2) Two 1,000,000 x 128 int8 tables of random
   rows from one sparse file (both "solo"), the DIN leg of the JAX
   package's bench (BASELINE config 4): ``FusedDinServer`` with DIN
   (200-80-1, attention 64) and BST (4 heads, 1 layer, head 256-64-1) at
   batch 1024, S 64, Zipf(1.05) keys, seq_len uniform in [1, 64]; and
   ``RetrievalServer`` with ``TwoTowerUser`` (256-128) over the 1,000,000
   items, k 100, batch 1024. Parts 1 and 2 print the wall (median of 10
   after 2 warm-ups), the device time (profiler) and the idle share. (3)
   WDL, DeepFM, a small DCN-v2, xDeepFM, NCF and MMoE on the deployment and
   at the widths of the JAX package's examples/07_model_zoo.py, at batch 8
   and 4096. Every family runs on two sets of weights, Flax's
   initialisation (zero biases) and the same with every bias drawn from
   0.1 N(0, 1) (lines ``<family>_bias``, not timed), each twice: f32, and
   with ``compute_dtype=torch.bfloat16`` (lines ``<family>[_bias]_bf16``), the bf16
   output held to a CPU instance at bf16 within the family's bar
   (``ZOO_BF16_BAR``, from the card's readings) and closer to it than to
   the CPU instance's f32 output, the f32 model's own gap printed beside
   it; the bf16 retrieval
   keys equal wherever the CPU instance's scores stand further apart than
   the two instances' queries can move them. DCN-v2, DIN, BST and retrieval
   print their bf16 wall, device time and idle share beside the f32 ones.
5e. A Triton model repository (the "ensemble" phase, ``ensemble_phase``),
   laid out as examples/05_triton_repo_ensemble.py lays it out and booted
   with ``serve(model_repository=..., grpc_port=0)``: the HPS model
   ``hps_embedding`` holds the 26 tables of phase 3 in one key space
   (1,855,979 x 128 int8 rows, static cache at 100 %, 26 keys a sample,
   max_batch_size 4096), behind dense models of reshape [-1, 3328] and TOP
   (1024-1024-512-256-1, relu ... sigmoid, seeded weights) stored f32, w8a8,
   int8 and fp8, each in its own ensemble. For each: a fused infer at batch
   4096 launches K1 once (and K5 once a layer for w8a8, nothing else), and
   fused = staged = the host reference (the host dequant of the cache's
   bytes through the port's DenseModel on the CPU, first 256 samples) within
   the dense-model tolerances (tests/test_torch_dense_model.py), over the
   ensemble server, HTTP JSON, HTTP binary and gRPC (64-sample requests);
   the fused and staged walls (median of 10), device time and idle share. A
   ragged request (not a multiple of 26 keys) to an ensemble whose dense
   model scores each key goes staged and is right. HTTP p50 / p99 of 200
   64-sample binary requests from one client. K1 at the fused infer's shape
   (106,496 keys, padded to 131,072 slots) and K5 at the w8a8 model's five
   layers (M 4096; K 3328 -> N 1024 first) timed beside their plain versions
   and bounds.
5e2. Sharded tables (the "sharded" phase, ``sharded_phase``; ``parallel/``),
   every shard on the one card, so no interconnect is measured: (1) the 26
   tables as one (1,855,979 x 128 int8) in a ``ShardedTable`` at P = 2 and
   8, both strategies (psum, all_to_all) on the first batch, bit-exact
   against the host dequant of the shards' bytes and the unsharded cache of
   phase 3, exactly one K1 launch per lookup; (2) DCN-v2 (BASELINE config 3)
   through ``make_sharded_dcn_server`` at P = 2, both strategies, logits
   bit-identical to the unsharded ``make_dcn_server`` and rel < 1e-3 against
   the port on the CPU, one K1 launch per predict; (3) a ``shard_tables``
   copy of phase 3's model in one ps.json with it, served over HTTP with
   ``device="cuda:0"``: 64-sample binary responses byte-identical, one K1
   launch per request, then new rows, ``refresh`` and the new rows served;
   (4) the ensemble repository of 5e with its HPS model sharded (P = 2), f32
   and w8a8 dense models: fused = staged bit for bit, K1 once per fused
   infer and K5 once a layer; (5) a mesh over a process group (NCCL, world
   size 1, 4 local shards) bit-identical to the single-process mesh, and
   ``entry.dryrun_multichip(8, device="cuda:0")`` without and with it.
   Printed: the host plan (dedup and buckets; per table for DCN-v2), walls,
   device times, idle shares, and K1 at each lookup's recorded groups beside
   its bound over the unique real slots, the pad rows and the
   ``index_select`` chain.
5e3. The entry points around the package (the "examples" phase,
   ``examples_phase``): (1) ``entry.entry()`` on the card (K1 then K4, once
   each) against ``entry(device="cpu")`` with the same weights; (2) each of
   the nine ``hugectr_backend_tpu_torch.examples`` run by its ``main()`` on
   the card, its own checks raising, its launches counted (K1 exactly once
   per lookup, predict, request or retrieve; K4 in 02's single-table server
   and K3 or K2 in its multi-table one; int4 tables given to K1 in 06; none
   in 08, which runs on the host) and its outputs held against the same
   example run with ``device="cpu"`` in this process (lookups, HTTP
   responses and int4 rows bit-identical, 06's hit rate equal, logits within
   rtol 1e-4 and atol 1e-5 x max(1, max|logit|), 05's ensemble within 1e-5
   / 1e-6, retrieval scores rel < 1e-6 with the keys equal wherever a score
   stands apart from its neighbours); (3) ``tools.perf_client`` (a process
   of its own, 8 clients, 64-sample binary requests of 26 keys) for 5 s
   against a fresh server of one 262,144 x 128 int8 table, its qps and p50 /
   p99 printed beside the frontend phase's; (4)
   ``scripts.frontend_saturation`` at its full configuration with the
   DEVICE STUBBED OUT (front-end software alone; direct, HTTP and gRPC legs
   at the full concurrency), beside the frontend phase's requests/s and p50;
   (5) ``scripts.auc_parity`` in smoke mode, every gate held and the
   one-hot fold engaged.
5f. The ``redis_cluster`` volatile db (the "cluster" phase,
   ``cluster_phase``): two pool nodes started through ``python -m
   hugectr_backend_tpu_torch.tiers.cluster`` with a shared secret and TLS (a
   certificate made at run time; ``enable_tls`` is one setting for the
   whole pool, as in the reference), the dynamic deployment of phase 5c
   (synchronous inserts, the SSD tier, no update stream) with its DRAM tier
   on them: ``ps.dram`` is the pool, both nodes hold rows, 4 Zipf batches
   of lookups bit-identical to a CPU instance on the local native store, K1
   once per lookup; a node with the secret alone (plain TCP) returns its
   rows bit for bit. The pool's query and insert time beside the local
   store's for the same keys.
6. Each kernel timed at the shapes the main path gave it, beside its plain
   version, one PyTorch call for the same product where there is one, and
   its bound: the larger of bytes over the memory rate and operations over
   the card's tensor-core rate for their type (bf16 for K2/K3, int8 for K5).
   K2 and K3 also at bf16 (the same rows cast; the bound over 2-byte rows).
   K5 is timed at each of its 8 layer shapes, each line naming the plan it
   took; its entry in the kernels line sums the 8 (one predict's worth). K1
   is timed as each path's one grouped launch (its library time: the
   groups' ``index_select`` calls chained in one graph; the fold path's is
   the kernels line's entry) and on the arena group alone. Then each route
   past the former limits timed at its edge shape (``WIDE_TIMED``) beside
   its plain version and its bound.
7. K4 (``fused_dot_interaction``, the stacked interaction) and its backward
   kernel against their plain versions on edge cases: B in {1, 7, 4096},
   D in {16, 36, 128}, T in {1, 26}, with only one input requiring grad,
   and the chunked (K2) backward with phantom rows and unmapped subs
   (which must get exactly zero): forward within rtol 1e-5 and atol
   1e-6 * max|z|^2, backward within rtol 1e-5 and atol 1e-6 * F * max|g| *
   max|z| (f32 sums in another order). The backward kernel also at its
   plan's boundaries: F in {2, 27, 128}, D in {4, 64, 128, 130}, B in
   {1, 777, 4099}, and K2's parts with gradients not asked for. K3, K5
   and K1 must raise under autograd.
8. Training at full width: ``train_dlrm_multi`` on ``make_multi_click_dataset``
   over the same 26 capped vocabularies (one f32 table of 1,855,979 x 128
   rows under Adam), batch 4096, lr 5e-3, TRAIN_STEPS steps. K4 forward and
   backward must launch once per step, the loss stay finite and the mean of
   the last 10 steps fall below the first 10; on one batch the card's
   gradients of every parameter and of the looked-up table rows must be
   within 1e-4 * max|grad| of the port's on the CPU.
9. The trained checkpoint served: ``multi_serving_scores`` on 65,536
   held-out samples in fp32, int8 and int8 + w8a8 dense layers (K1, K3, K5),
   and a ``train_dlrm`` run of the single-table shape (vocab 262,144, 26 keys
   per sample, the same widths; 600 steps over 4M samples at lr 1e-3) served by
   ``FusedDlrmServer`` (K1, K4) in the same variants. Gates (the JAX package's, tests/test_auc_parity.py):
   fp32 AUC > 0.55, |delta int8| < 1e-3, |delta w8a8| < 5e-3.
10. K4 forward (f32 and bf16) and backward timed at the training shape
   (CUDA-graph replay) beside their plain versions, ``torch.bmm``
   yardsticks (bf16 z z^T forward; f32 (dzzt) z backward, TF32 off) and
   their bounds (bytes; the backward's f32 FMAs over the card's non-tensor
   f32 rate take less), and the train step: wall time (median of 10),
   device time and idle share from ``torch.profiler``.

11. The lookup microbenchmarks (``hugectr_backend_tpu_torch.scripts``, this
   slice's path; run last, after the training state is freed, so that the
   4.32 GB of tables come and go after phase 10's timing), launch counts set
   to 0 just before and read just after:
   ``microbench_onehot`` (K6 v2 at m_tile 512-4096 and v1 at 4096 on the 16
   tiny Criteo tables and on 18, K1 and a one-hot ``torch.matmul`` on the
   same slots; at every tiling K6 equals K1 bit for bit and the host truth)
   and ``microbench_true`` (configs A-J: the 18-table arena, 1 and 8 big
   tables and the full Criteo-26 mix at the uncapped cardinalities, 33.76M
   rows x 128 int8, every output bit-exact against the host truth). Both K6
   kernels must launch. Then each K6 body timed at the tiny16 shape (batch
   4096: 65,536 keys over 52 row tiles of 512) beside its plain version,
   ``index_select`` and K1 on the same slots, bit for bit against the plain
   version.

12. The benchmark programs (``bench_phase``; this slice's path), launch
   counts set to 0 just before and read just after:
   ``hugectr_backend_tpu_torch.bench`` at the uncapped Criteo-Kaggle cardinalities (33.76M rows x 128
   int8, 4.32 GB; 14 one-hot / 4 arena / 8 solo; the headline lookup at
   batch 4096 and 1024 bit-exact against the closed form with one K1 launch
   an iteration; the six fused variants f32 (fold, K3), f32_twostage (K2),
   bf16cast (K3 at bf16), int8, fp8, w8a8 (K5), fold vs two-stage rel <
   5e-3, each variant's first 64 logits against the same model on the CPU,
   each forward's launches; DIN against the host's pool; the tier, host
   translation and HTTP stages, the latter at 5 s), then the eight
   microbenchmarks (``microbench_w8a8_kernel``, ``_dense``,
   ``_interaction``, ``_int4_gather``, ``_overhead``, ``_update_storm`` for
   5 s, ``_scaling``, ``_zoo_dtypes``), each at its card sizes with its own
   correctness step; ``_zoo_dtypes`` must time DCN-v2 and BST, and each of
   their products, at f32, at bf16 as before the repair of the bf16
   products (with and without cuBLAS's bf16 split-K sums) and as the port
   computes them now (``bf16_f32_out``).
   K1, K2, K3, K4 and K5 must launch. The phase prints its peak memory and
   seconds; ``bench_alone()`` runs it alone.

13. The TPU-layout microbenchmarks (``microbench_layouts_phase``; this
   slice's path), launch counts set to 0 just before and read just after:
   the nine ported ``scripts/microbench_*`` that tuned TPU layouts, each
   asking the card's version of its question at the JAX script's shapes and
   checking itself: ``_pallas_interaction`` (K4 at B 4096, F 27, D 128 at
   every warp-per-sample launch plan, bit for bit the default plan's
   output; the default within rtol 1e-5, atol 1e-6 max|z|^2 of the plain
   formulation; the ``bmm`` yardstick), ``_pallas_parts`` and
   ``_parts_fm`` (the DLRM forward at batch 4096 on oh [14 B, D] and ar
   [12 B, D]: stacked + plain, stacked + K4 and parts + K2, K4 == K2 bit
   for bit, plain within the interaction's bar and rel 5e-3 at the logits;
   the part-major map with the first top layer permuted within rtol 1e-4,
   atol 1e-5 of the interleaved one; 3 rounds), ``_oh_fused`` (K1 + K2
   against K3 on the 14 one-hot members, within the interaction's bar; 3
   rounds), ``_fold_ab`` (the whole fused forward at the uncapped
   cardinalities, fold against two-stage rel < 5e-3; 9 rounds),
   ``_full_ab`` (the 26-table lookup, one-hot members int8 against bf16,
   bit for bit against the host truth), ``_int8_onehot`` (the one-hot
   products bf16 / int8 / one fat member, K1's one-hot group and K6 v2,
   the stored values exactly; K1 with per-key scales == K6 v1 == the host
   truth), ``_geometry`` (K1 on tables of 4,096 to 10,137,600 rows at
   1,024 / 4,096 / 26,624 slots by group kind, bit for bit) and
   ``_overlap`` (one K1 launch against one a group, sorted slots, the
   Criteo-26 layout, bit for bit). Each script's graph replays and rounds
   are its own defaults; no shape is cut. K1, K2, K3, K4 and K6 (both
   bodies) must launch. The phase prints its peak memory and seconds;
   ``microbench_layouts_alone()`` runs it alone.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import io
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# The 26 Criteo-Kaggle categorical cardinalities (C1..C26).
CRITEO_CARDS = [
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
]
ROW_CAP = 262_144
DIM = 128
NUM_DENSE = 13
BATCH = 4096
N_BATCHES = 3
BOTTOM = (512, 256, DIM)
TOP = (1024, 1024, 512, 256, 1)
SEED = 2026

RTOL = 1e-5  # K2/K3 vs plain: f32 summation order only
BWD_MAX_F = 147  # the shared-memory backward kernel's largest F (S, the pair table, a ring)
K6_EDGE_M_TILES = (32, 64, 512, 4096)  # keys per key tile of the K6 edge checks
K3_EDGE_F = (2, 27, 128, 129, 300)  # forward interaction: past 128 fed descriptors, row blocks
REL_LOGITS = 5e-3  # fold vs no fold, the JAX package's bar (test_fused_models.py)
TRAIN_STEPS = 200  # steps of each training run (batch BATCH)
TRAIN_LR = 5e-3
N_TRAIN = 800_000  # training samples (TRAIN_STEPS * BATCH = 819,200 drawn with replacement)
N_EVAL = 65_536  # held-out samples the served checkpoint scores
SINGLE_VOCAB = 262_144  # the single-table run: one table, 26 keys per sample
# The single-table run memorizes at N_TRAIN / TRAIN_STEPS: drawn with
# replacement, most of a late batch was seen before, and each sample's rare
# keys (Zipf over 262,144 ids) let the full-width model learn its label, so
# the held-out AUC stayed at 0.50 (on the card and on the CPU alike). With
# 4M samples and 600 steps it generalizes, but at lr 5e-3 its first steps
# spike and the outcome hangs on rounding (held-out AUC 0.61 on the CPU port,
# 0.52 on the card); at lr 1e-3 it does not spike (0.69 on the CPU port).
SINGLE_N_TRAIN, SINGLE_STEPS, SINGLE_LR = 4_000_000, 600, 1e-3
GRAD_TOL = 1e-4  # card vs CPU gradients: max |delta| / max |grad| per tensor
SERVE_VARIANTS = ("fp32", "int8", "int8+dense_w8a8")
AUC_MIN, AUC_INT8, AUC_W8A8 = 0.55, 1e-3, 5e-3  # tests/test_auc_parity.py
K5_TOL = 1e-6  # K5 vs plain, sigmoid / tanh / gelu: rtol and atol (libm ulps)
W8A8_LOGITS = 1e-2  # w8a8 logits vs the CPU port: |delta| / max|logit|
K5_ACTS = (None, "relu", "sigmoid", "tanh", "gelu")
# The front end's traffic: the JAX package's end-to-end leg (bench.py:80-275).
FRONTEND_SAMPLES = 64  # samples (one key a table each) per request
FRONTEND_MAX_BATCH = 256  # max_batch_size of the served model
FRONTEND_CLIENTS = 8
FRONTEND_SECONDS = 10.0
FRONTEND_ZIPF = 1.05
FRONTEND_CHECKED = 32  # responses held bit for bit against the host dequant, at least
FRONTEND_PROFILE_S = 2.0  # the profiled slice of the window
# The hierarchy behind the cache (the dynamic_tiers phase), on the same tables.
DYN_CACHE_PER = 0.5  # gpucacheper: half of each table's rows on the card
DYN_DRAM_RATE = 0.5  # initial_cache_rate: half in the DRAM tier, all on the SSD
DYN_SYNC_BATCHES = 12  # step 1, synchronous inserts, held to the CPU instance
DYN_ASYNC_BATCHES = 40  # step 2, the default hit_rate_threshold (0.9)
DYN_FLAVOUR_BATCHES = 6  # step 3, stochastic and UVM each
DYN_UPDATE_TABLES = 4  # step 5: tables that get new rows
DYN_UPDATE_KEYS = 4096  # step 5: keys a table
DYN_DEADLINE_S = 60.0  # the wait for the drainer and for the update consumer
# The model zoo (the "zoo" phase): DIN / BST / two-tower at the shapes of the
# JAX package's DIN leg (bench.py:875-905, BASELINE config 4), and the
# small families at the widths of its examples/07_model_zoo.py.
ZOO_ROWS = 1_000_000  # each of the two DIN tables (target / user, sequence / items)
ZOO_BATCH = 1024
ZOO_SEQ = 64
ZOO_ZIPF = 1.05
ZOO_K = 100
ZOO_REF = 256  # samples the CPU instance scores (a sample's logit is its own)
ZOO_REF_RETRIEVE = 64  # users the CPU instance retrieves for
ZOO_REL = 1e-3  # logits and retrieval scores vs the CPU instance
ZOO_SMALL_BATCHES = (8, 4096)
#: The largest gap of the card's bf16 output to the CPU instance's at bf16
#: (max |diff| / max |CPU|) in the runs of the zoo phase on the card (H100
#: 80GB HBM3, 700 W; PERF.md), both batches of part 3; ``*_bias``:
#: the same family with every bias drawn. The bf16 products are f32 SGEMMs
#: of the bf16 operands, which add as the CPU's do: most families equal the
#: CPU instance bit for bit.
ZOO_BF16_READ = {"dcn_v2": 0.0016025641234591603, "dcn_v2_bias": 0.0,
                 "din": 0.0, "din_bias": 0.0, "bst": 0.0, "bst_bias": 0.0007861634949222207,
                 "retrieval": 2.7333568141330034e-05, "retrieval_bias": 0.0,
                 "wdl": 1.0096783853441593e-07, "wdl_bias": 1.0215072165919992e-07,
                 "deepfm": 1.0401090122513779e-07, "deepfm_bias": 1.0409328154992181e-07,
                 "dcn_v2_small": 0.0, "dcn_v2_small_bias": 0.0, "xdeepfm": 0.0,
                 "xdeepfm_bias": 0.0, "ncf": 0.0, "ncf_bias": 0.0, "mmoe": 0.0,
                 "mmoe_bias": 0.0}
#: The bars from the readings before the bf16 products were repaired
#: (twice them; the products then on the tensor cores, the bias before the
#: rounding): no bar may rise above its family's.
ZOO_BF16_BAR_CAP = {"dcn_v2": 0.012820512987673283, "din": 0.0052083334885537624,
                     "bst": 0.005649717524647713, "retrieval": 5.466713628266007e-05,
                     "wdl": 2.0 ** -20, "deepfm": 2.0 ** -20,
                     "dcn_v2_small": 0.005681818351149559, "xdeepfm": 2.0 ** -20,
                     "ncf": 2.0 ** -20, "mmoe": 0.002747252816334367}
#: The bar: twice the reading, no less than 2^-20 (the CPU tests' bar), no
#: more than the family's ``ZOO_BF16_BAR_CAP``. Where the card rounds an
#: output one bf16 ulp away from the CPU (DCN-v2), the rule that the output
#: be closer to the CPU's bf16 output than to its f32 one tells the
#: precisions apart (``zoo_phase``'s ``held``).
ZOO_BF16_BAR = {leg: min(max(2 * r, 2.0 ** -20), ZOO_BF16_BAR_CAP[leg.removesuffix("_bias")])
                for leg, r in ZOO_BF16_READ.items()}
#: Biases of the zoo's second set of weights (the ``*_bias`` legs) and of the
#: per-product split: 0.1 N(0, 1), as a trained checkpoint holds them (Flax
#: initialises every bias to zero).
ZOO_BIAS_STD = 0.1
_DCN_W = NUM_DENSE + len(CRITEO_CARDS) * DIM  # x0 of DCN-v2: 3,341
_BST_T = ZOO_SEQ + 1  # the behaviour sequence and the target token
#: The bf16 products of the zoo's served models and of the bf16 DLRM at their
#: serving shapes (``bf16_product_split``): (name, "linear" (M, K, N), with a
#: bias) or (name, "bmm" (batches, M, K, N), none).
BF16_PRODUCTS = (
    ("dcn_v2 cross u", "linear", (BATCH, _DCN_W, 64)),
    ("dcn_v2 cross v", "linear", (BATCH, 64, _DCN_W)),
    ("dcn_v2 deep 0", "linear", (BATCH, _DCN_W, 1024)),
    ("dcn_v2 deep 1", "linear", (BATCH, 1024, 512)),
    ("dcn_v2 deep 2", "linear", (BATCH, 512, 256)),
    ("dcn_v2 head 0", "linear", (BATCH, _DCN_W + 256, 128)),
    ("dcn_v2 head 1", "linear", (BATCH, 128, 1)),
    ("bst q/k/v/o", "linear", (ZOO_BATCH * _BST_T, DIM, DIM)),
    ("bst ff 0", "linear", (ZOO_BATCH * _BST_T, DIM, 4 * DIM)),
    ("bst ff 1", "linear", (ZOO_BATCH * _BST_T, 4 * DIM, DIM)),
    ("bst q k^T", "bmm", (ZOO_BATCH * 4, _BST_T, DIM // 4, _BST_T)),
    ("bst attention v", "bmm", (ZOO_BATCH * 4, _BST_T, _BST_T, DIM // 4)),
    ("bst head 0", "linear", (ZOO_BATCH, DIM + NUM_DENSE, 256)),
    ("bst head 1", "linear", (ZOO_BATCH, 256, 64)),
    ("bst head 2", "linear", (ZOO_BATCH, 64, 1)),
    ("din attention 0", "linear", (ZOO_BATCH * ZOO_SEQ, 4 * DIM, 64)),
    ("din attention 1", "linear", (ZOO_BATCH * ZOO_SEQ, 64, 1)),
    ("din head 0", "linear", (ZOO_BATCH, NUM_DENSE + 2 * DIM, 200)),
    ("din head 1", "linear", (ZOO_BATCH, 200, 80)),
    ("din head 2", "linear", (ZOO_BATCH, 80, 1)),
    ("dlrm bottom 0", "linear", (BATCH, NUM_DENSE, BOTTOM[0])),
    ("dlrm top 0", "linear", (BATCH, DIM + 27 * 26 // 2, TOP[0])),
)
#: The repaired form's bar against the CPU: its rounded product within 1 bf16
#: ulp, and at most this share of outputs differing (the CPU's own f32
#: sum-order residue against float64 is 0.001-0.02 %).
BF16_SPLIT_SHARE = 0.01
# A Triton model repository (the "ensemble" phase), laid out as in
# examples/05_triton_repo_ensemble.py: the 26 tables as one table (key
# ENS_KEY_STRIDE * t + row) behind a dense model in each format.
ENS_FORMATS = ("f32", "w8a8", "int8", "fp8")
# fused / staged / host reference, the tolerances of tests/test_torch_dense_model.py
ENS_TOL = {"f32": (1e-5, 1e-6), "w8a8": (1e-5, 1e-6), "int8": (1e-3, 1e-5),
           "fp8": (1e-3, 1e-5)}
ENS_KEY_STRIDE = 1 << 32
ENS_TENSORS = ("EMB_KEY", "EMB_N_KEY", "DENSE_OUTPUT")  # the reference sample's names
ENS_TIMED = 10  # timed infers of each path and format (median)
ENS_REF = 256  # samples the host reference scores (a sample's output is its own)
ENS_HTTP_SAMPLES = 64
ENS_HTTP_REQUESTS = 200
# Sharded tables (the "sharded" phase), all shards on the one card.
SHARD_LOOKUP_P = (2, 8)  # shards of the one-table lookups
SHARD_P = 2  # shards of DCN-v2, the ps.json model and the ensemble
SHARD_PG_LOCAL = 4  # local shards of the process-group mesh (world size 1)
SHARD_HTTP_REQUESTS = 8  # 64-sample requests to each of the two models
SHARD_UPDATE_KEYS = 256  # keys of table 0 given new rows before the refresh
SHARD_ENS_FORMATS = ("f32", "w8a8")
SHARD_TIMED = 10  # timed predicts (median)
# The examples phase: each example's card run against its CPU run
# (tests/test_torch_examples_*.py's tolerances), perf_client and
# frontend_saturation beside the frontend phase.
EX_LOGITS_TOL = (1e-4, 1e-5)  # rtol, atol x max(1, max|want|): f32 sums in another order
EX_ENSEMBLE_TOL = (1e-5, 1e-6)  # the ensemble's f32 dense layers
EX_RETRIEVAL_REL = 1e-6  # retrieval scores, max|delta| / max|score|
# perf_client sends one NUMKEYS entry (the reference CI's perf_analyzer
# --shape KEYS:26 --shape NUMKEYS:1), so it cannot drive the frontend phase's
# 26 tables: it drives one table at the row cap of that deployment's large
# tables (keys 0..rows-1, DIM wide, int8). A 64-sample request then carries
# the frontend phase's 1,664 keys and gets its response bytes back.
PERF_CLIENT_ROWS = ROW_CAP
PERF_CLIENT_S = 5.0
# The redis_cluster volatile db (the "cluster" phase): two pool nodes.
CLUSTER_BATCHES = 4
CLUSTER_START_S = 60.0  # the wait for a node process to answer

SOURCES = {
    "gather_dequant": ("hugectr_backend_tpu_torch/csrc/gather_dequant.cu",
                       "hugectr_backend_tpu/ops/dequant_gather.py:54"),
    "dot_interaction_parts": ("hugectr_backend_tpu_torch/csrc/dot_interaction.cu",
                              "hugectr_backend_tpu/ops/fused_interaction.py:298"),
    "dot_interaction_oh_parts": ("hugectr_backend_tpu_torch/csrc/dot_interaction.cu",
                                 "hugectr_backend_tpu/ops/fused_interaction.py:620"),
    "w8a8_dense": ("hugectr_backend_tpu_torch/csrc/w8a8_dense.cu",
                   "hugectr_backend_tpu/ops/quant_matmul.py:49"),
    "fused_dot_interaction": ("hugectr_backend_tpu_torch/csrc/dot_interaction.cu",
                              "hugectr_backend_tpu/ops/fused_interaction.py:65"),
    "dot_interaction_bwd": ("hugectr_backend_tpu_torch/csrc/dot_interaction_bwd.cu",
                            "hugectr_backend_tpu/ops/fused_interaction.py:150"),
    "onehot_gather": ("hugectr_backend_tpu_torch/csrc/onehot_gather.cu",
                      "hugectr_backend_tpu/ops/onehot_gather.py:146"),
    "onehot_gather_rows": ("hugectr_backend_tpu_torch/csrc/onehot_gather.cu",
                           "hugectr_backend_tpu/ops/onehot_gather.py:218"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ checks


def zmax(feats) -> float:
    return max(float(f.to(torch.bfloat16).float().abs().max()) for f in feats if f.numel())


def interaction_err(got, want, zm):
    """-> (ok, max_abs_err) under rtol RTOL and atol 1e-6 * max|z|^2."""
    err = (got - want).abs()
    ok = bool((err <= 1e-6 * zm * zm + RTOL * want.abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def k1_edge_checks(dev) -> int:
    from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant, gather_dequant_ref
    from hugectr_backend_tpu_torch.tiers.hbm import quantize_host_rows

    rng = np.random.default_rng(1)
    n_checks = 0
    for quant in ("int8", "fp8", "bf16", "fp32", "int4"):
        for dim in (DIM, 36):  # 16-byte vector path and the scalar path
            vecs = rng.standard_normal((1000, dim)).astype(np.float32)
            vals, scales = quantize_host_rows(vecs, quant, 0.25)
            values = vals.to(dev)
            dsc = None if scales is None else torch.from_numpy(scales).to(dev)
            rows = values.shape[0]
            for n in (0, 1, 777):
                sl = rng.integers(0, rows, n).astype(np.int32)
                if n:
                    sl[-1] = rows - 1  # the miss (default) row
                slots = torch.from_numpy(sl).to(dev)
                per_key = torch.from_numpy(
                    (rng.random(n) + 0.5).astype(np.float32)).to(dev)
                modes = [(None, None), (None, per_key)]
                if dsc is not None:
                    modes.append((dsc, None))
                for ds, si in modes:
                    got = gather_dequant(values, ds, slots, si)
                    want = gather_dequant_ref(values, ds, slots, si)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    if got.shape != (n, dim) or not torch.equal(got, want):
                        raise AssertionError(
                            f"K1 {quant} dim {dim} n {n} scales "
                            f"{'device' if ds is not None else 'per-key' if si is not None else 'none'}"
                            ": kernel != plain")
                    n_checks += 1
    return n_checks


def k2_k3_edge_checks(dev) -> int:
    from hugectr_backend_tpu_torch.ops.fused_interaction import (
        dot_interaction_oh_parts,
        dot_interaction_oh_parts_ref,
        dot_interaction_parts,
        dot_interaction_parts_ref,
        oh_rows_ref,
        part_major_order,
    )

    g = torch.Generator().manual_seed(3)
    n_checks = 0
    for b, d in ((4096, DIM), (13, DIM), (40, 30)):
        bottom = torch.randn(b, d, generator=g).to(dev)
        # Parts with phantom tail rows (S > B) and unmapped subs.
        parts = [torch.randn(n, s, d, generator=g).to(dev)
                 for n, s in ((5, b + 3), (3, b), (1, b + 8))]
        general = ((1, 2), (0, 0), (2, 0), (0, 3), (1, 0), (0, 1))
        _, part_major = part_major_order(general)
        # Strided views of a stacked [B, T, D] tensor; T = 40 takes the
        # interaction past one 32-row tile.
        cases = [(parts, general), (parts, part_major)]
        for t in (4, 40):
            stacked = torch.randn(b, t, d, generator=g).to(dev).transpose(0, 1)
            cases.append(([stacked], tuple((0, i) for i in range(t))))
        for ps, fmap in cases:
            got = dot_interaction_parts(bottom, ps, fmap)
            want = dot_interaction_parts_ref(bottom, ps, fmap)
            zm = zmax([bottom] + [ps[p][s][:b] for p, s in fmap])
            ok, err = interaction_err(got, want, zm)
            if not ok:
                raise AssertionError(f"K2 B={b} D={d} map {fmap}: max err {err}")
            n_checks += 1
        for dt in (torch.int8, torch.float8_e4m3fn, torch.bfloat16, torch.float32):
            arena = (torch.randn(300, d, generator=g) * 60).clamp(-127, 127)
            arena = arena.round().to(dt) if dt == torch.int8 else arena.to(dt)
            arena = arena.to(dev)
            slots = torch.randint(0, 300, (3, b + 5), generator=g, dtype=torch.int32).to(dev)
            scales = (torch.rand(3, b + 5, generator=g) + 0.01).to(dev)
            for sc in (scales, None):
                got = dot_interaction_oh_parts(bottom, arena, slots, sc, parts, part_major)
                want = dot_interaction_oh_parts_ref(bottom, arena, slots, sc, parts, part_major)
                zm = zmax([bottom] + oh_rows_ref(arena, slots, sc, b)
                          + [parts[p][s][:b] for p, s in part_major])
                ok, err = interaction_err(got, want, zm)
                if not ok:
                    raise AssertionError(f"K3 {dt} B={b} D={d}: max err {err}")
                n_checks += 1
    return n_checks


def k1_group_edge_checks(dev) -> int:
    """The grouped K1 (one launch per lookup) bit-exact against its plain
    version: every storage kind in one call, device, per-key and no scales,
    empty and skipped groups, a one-hot group with slots outside their
    member (zero rows), odd widths (the element path), and groups whose
    sizes are no multiple of a unit, so that one warp's units straddle
    groups."""
    from hugectr_backend_tpu_torch.ops.dequant_gather import (
        gather_dequant_groups,
        gather_dequant_groups_ref,
    )
    from hugectr_backend_tpu_torch.tiers.hbm import quantize_host_rows

    rng = np.random.default_rng(11)
    n_checks = 0
    tables = []
    for quant, dim, rows in (("int8", DIM, 1000), ("fp8", DIM, 700), ("bf16", 64, 300),
                             ("fp32", 37, 500), ("int4", DIM, 900), ("int8", 36, 400)):
        vals, scales = quantize_host_rows(rng.standard_normal((rows, dim)).astype(np.float32),
                                          quant, 0.25)
        tables.append((vals.to(dev), None if scales is None else torch.from_numpy(scales).to(dev)))
    oh_int8 = tables[0][0][:512].contiguous()
    oh_bf16 = tables[2][0][:300].contiguous()
    for sizes in ((33, 1, 0, 70, 4096, 31), (4096, 16384, 5, 257, 1, 999)):
        vals, dsc, meta, slots_l, scin_l = [], [], [], [], []
        for (v, sc), n, mode in zip(tables, sizes, ("device", "per-key", "none", "per-key",
                                                     "device", "none")):
            vals.append(v)
            dsc.append(sc if mode == "device" and sc is not None else None)
            meta.append(("gather",))
            slots_l.append(rng.integers(0, v.shape[0], n).astype(np.int32))
            scin_l.append((rng.random(n) + 0.5).astype(np.float32) if mode == "per-key" else None)
        for arena, members, counts in (
                (oh_int8, ((0, 128), (128, 256), (384, 128)), (40, 0, 77)),
                (oh_bf16, ((0, 100), (100, 150), (250, 50)), (8, 8, 8))):
            sl = []
            for (off, size), c in zip(members, counts):
                s_ = rng.integers(0, arena.shape[0], c).astype(np.int32)  # some outside
                s_[: c // 2] = rng.integers(off, off + size, c // 2)
                sl.append(s_)
            vals.append(arena)
            dsc.append(None)
            meta.append(("onehot", tuple(o for o, _ in members), tuple(z for _, z in members),
                         counts))
            slots_l.append(np.concatenate(sl))
            scin_l.append((rng.random(sum(counts)) + 0.5).astype(np.float32))
        vals.append(tables[0][0])  # a skipped group
        dsc.append(tables[0][1])
        meta.append(("skip",))
        slots_l.append(rng.integers(0, 1000, 64).astype(np.int32))
        scin_l.append(None)
        bounds, off = [], 0
        for a_ in slots_l:
            bounds.append((off, off + a_.size))
            off += a_.size
        cbounds, coff = [], 0
        for a_ in scin_l:
            cbounds.append(None if a_ is None else (coff, coff + a_.size))
            coff += 0 if a_ is None else a_.size
        slots_cat = torch.from_numpy(np.concatenate(slots_l)).to(dev)
        scin_cat = torch.from_numpy(np.concatenate([a_ for a_ in scin_l if a_ is not None])).to(dev)
        args = (vals, dsc, slots_cat, scin_cat, tuple(meta), tuple(bounds), tuple(cbounds))
        got = gather_dequant_groups(*args)
        want = gather_dequant_groups_ref(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        for gi, (x, y) in enumerate(zip(got, want)):
            if (x is None) != (y is None) or (x is not None and (
                    x.shape != y.shape or not torch.equal(x, y))):
                raise AssertionError(f"grouped K1 sizes {sizes} group {gi} ({meta[gi][0]}): "
                                     "kernel != plain")
            n_checks += 1
        # Slots outside their member gave zero rows.
        for gi in range(len(tables), len(tables) + 2):
            _, offs, szs, counts = meta[gi]
            sl = slots_cat[bounds[gi][0]:bounds[gi][1]].cpu()
            p0, outside = 0, []
            for o, z, c in zip(offs, szs, counts):
                part = sl[p0:p0 + c]
                outside.append((part < o) | (part >= o + z))
                p0 += c
            outside = torch.cat(outside)
            if not outside.any() or got[gi].cpu()[outside].any():
                raise AssertionError(f"grouped K1 one-hot group {gi}: slots outside their member "
                                     "did not give zero rows")
            n_checks += 1
    return n_checks


def k3_wide_checks(dev) -> int:
    """K3, K2 and K4's forward past 128 fed features and past one 16-row
    block of pairs: F in K3_EDGE_F (bottom + one-hot + fed) at D 128 (the
    16-byte paths), 36 (one-hot rows off the 16-byte path) and 30 (fed rows
    too), int8 and bf16 one-hot arenas with members and slots outside them
    (zero rows), within rtol RTOL and atol 1e-6 * max|z|^2 of the plain
    versions. Past a block's shared memory, see repaired_route_checks."""
    from hugectr_backend_tpu_torch.ops.fused_interaction import (
        dot_interaction_oh_parts,
        dot_interaction_oh_parts_ref,
        dot_interaction_parts,
        dot_interaction_parts_ref,
        fused_dot_interaction,
        fused_dot_interaction_ref,
        oh_rows_ref,
    )

    g = torch.Generator().manual_seed(12)
    n_checks = 0
    b = 37
    for f in K3_EDGE_F:
        n_oh = max(1, min(f // 3, 100))
        n_fed = f - 1 - n_oh
        for d, dt in ((DIM, torch.int8), (DIM, torch.bfloat16), (36, torch.int8),
                      (30, torch.int8)):
            bottom = torch.randn(b, d, generator=g).to(dev)
            rows = 64 * n_oh
            arena = (torch.randn(rows, d, generator=g) * 40).clamp(-127, 127).round().to(dt).to(dev)
            members = tuple((64 * j, 64 - (j % 5)) for j in range(n_oh))
            slots = torch.stack([torch.randint(max(0, o - 8), min(rows, o + z + 8), (b + 3,),
                                               generator=g, dtype=torch.int32)
                                 for o, z in members]).to(dev)
            scales = (torch.rand(n_oh, b + 3, generator=g) + 0.01).to(dev)
            stacked = torch.randn(b + 2, max(n_fed, 1), d, generator=g).to(dev)
            parts = [stacked.transpose(0, 1)]
            fmap = tuple((0, t) for t in range(n_fed))
            got = dot_interaction_oh_parts(bottom, arena, slots, scales, parts, fmap, members)
            want = dot_interaction_oh_parts_ref(bottom, arena, slots, scales, parts, fmap, members)
            oh = oh_rows_ref(arena, slots, scales, b, members)
            zm = zmax([bottom] + oh + [stacked[:b, t] for t in range(n_fed)])
            ok, err = interaction_err(got, want, zm)
            if not ok:
                raise AssertionError(f"K3 F={f} D={d} {dt}: max err {err}")
            n_checks += 1
            if dt != torch.int8:
                continue
            emb = torch.randn(b, f - 1, d, generator=g).to(dev)
            feats = [bottom] + list(emb.unbind(1))
            for name, got, want in (
                    ("K4", fused_dot_interaction(bottom, emb),
                     fused_dot_interaction_ref(bottom, emb)),
                    ("K2", dot_interaction_parts(bottom, [emb.transpose(0, 1)],
                                                 tuple((0, t) for t in range(f - 1))),
                     dot_interaction_parts_ref(bottom, [emb.transpose(0, 1)],
                                               tuple((0, t) for t in range(f - 1))))):
                ok, err = interaction_err(got, want, zmax(feats))
                if not ok:
                    raise AssertionError(f"{name} F={f} D={d}: max err {err}")
                n_checks += 1
    return n_checks


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at |x| (8 significant bits; the smallest normal's at 0)."""
    m = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def bf16_interaction_err(got, want, zm):
    """-> (ok, max_abs_err) for a bf16 forward against its plain version:
    both round f32 sums of the same bf16 products, summed in other orders,
    so each element is within 1 bf16 ulp of the plain one, widened by the
    f32 check's atol 1e-6 * max|z|^2 where a sum cancels to near zero."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        return False, float("inf")
    err = (got.float() - want.float()).abs()
    ok = bool((err <= bf16_ulp(want) + 1e-6 * zm * zm).all())
    return ok, float(err.max()) if err.numel() else 0.0


def bf16_interaction_checks(dev) -> int:
    """K2, K3 and K4's bf16 route (bf16 bottom, features and output) against
    the plain versions at F in K3_EDGE_F, B 37 (odd: every other output row
    starts on an odd 2-byte boundary), D 128 (the vector path), 36 and 31
    (odd), on general and part-major maps with phantom rows, strided
    stacked views, and int8 / fp8 / bf16 / f32 one-hot arenas with slots
    outside their members; and the wide route (z in shared and in device
    memory). The bottom copy must be exact; the pairs within
    ``bf16_interaction_err``."""
    from hugectr_backend_tpu_torch.ops.fused_interaction import (
        dot_interaction_oh_parts,
        dot_interaction_oh_parts_ref,
        dot_interaction_parts,
        dot_interaction_parts_ref,
        fused_dot_interaction,
        fused_dot_interaction_ref,
        k3_plan,
        oh_rows_ref,
        part_major_order,
    )

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(14)
    n_checks = 0

    def check(what, got, want, feats, bottom, wide=False):
        nonlocal n_checks
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        d = bottom.shape[1]
        if not torch.equal(got[:, :d], bottom):
            raise AssertionError(f"{what}: the bottom copy is not exact")
        ok, err = bf16_interaction_err(got, want, zmax(feats))
        if not ok:
            raise AssertionError(f"{what} (bf16): max err {err}")
        n_checks += 1

    b = 37
    for f in K3_EDGE_F:
        for d in (DIM, 36, 31):
            bottom = torch.randn(b, d, generator=g).to(bf).to(dev)
            emb = torch.randn(b + 2, f - 1, d, generator=g).to(bf).to(dev)[:b]
            feats = [bottom] + list(emb.unbind(1))
            check(f"K4 F={f} D={d}", fused_dot_interaction(bottom, emb),
                  fused_dot_interaction_ref(bottom, emb), feats, bottom)
            n_oh = max(1, min(f // 3, 100)) if f > 2 else 1
            n_fed = f - 1 - n_oh
            # Parts with phantom rows: a general map over two parts, and its
            # part-major order.
            n0 = max(n_fed - n_fed // 2, 0)
            parts = [torch.randn(n0 + 1, b + 3, d, generator=g).to(bf).to(dev),
                     torch.randn(n_fed - n0 + 1, b, d, generator=g).to(bf).to(dev)]
            general = tuple([(1, t) for t in range(n_fed - n0)] + [(0, t) for t in range(n0)])
            _, pmajor = part_major_order(general)
            for name, fmap in (("general", general), ("part-major", pmajor)):
                feats = [bottom] + [parts[p][s][:b] for p, s in fmap]
                check(f"K2 {name} F={n_fed + 1} D={d}", dot_interaction_parts(bottom, parts, fmap),
                      dot_interaction_parts_ref(bottom, parts, fmap), feats, bottom)
            for dt in (torch.int8, torch.float8_e4m3fn, torch.bfloat16, torch.float32):
                rows = 64 * n_oh
                arena = (torch.randn(rows, d, generator=g) * 40).clamp(-127, 127)
                arena = (arena.round() if dt == torch.int8 else arena).to(dt).to(dev)
                members = tuple((64 * j, 64 - (j % 5)) for j in range(n_oh))
                slots = torch.stack([torch.randint(max(0, o - 8), min(rows, o + z + 8), (b + 3,),
                                                   generator=g, dtype=torch.int32)
                                     for o, z in members]).to(dev)
                scales = (torch.rand(n_oh, b + 3, generator=g) + 0.01).to(dev)
                args = (bottom, arena, slots, scales, parts, pmajor, members)
                feats = ([bottom] + oh_rows_ref(arena, slots, scales, b, members)
                         + [parts[p][s][:b] for p, s in pmajor])
                check(f"K3 {dt} F={f} D={d}", dot_interaction_oh_parts(*args),
                      dot_interaction_oh_parts_ref(*args), feats, bottom)
    # The wide route: z in shared memory (F 689) and in device memory (F 800).
    for bw_, f, d, n_oh in ((5, 689, DIM, 60), (3, 800, DIM, 0), (7, 1100, 36, 40)):
        bottom = torch.randn(bw_, d, generator=g).to(bf).to(dev)
        emb = torch.randn(bw_, f - 1 - n_oh, d, generator=g).to(bf).to(dev)
        plan = k3_plan(bw_, f, d)
        if type(plan).__name__ != "K3WidePlan":
            raise AssertionError(f"F={f} D={d}: expected the wide plan, got {plan}")
        if n_oh == 0:
            check(f"K4 wide F={f} D={d}", fused_dot_interaction(bottom, emb),
                  fused_dot_interaction_ref(bottom, emb), [bottom] + list(emb.unbind(1)),
                  bottom)
            continue
        rows = 8 * n_oh
        arena = (torch.randn(rows, d, generator=g) * 40).clamp(-127, 127).round()
        arena = arena.to(torch.int8).to(dev)
        members = tuple((8 * j, 8 - (j % 3)) for j in range(n_oh))
        slots = torch.stack([torch.randint(max(0, o - 2), min(rows, o + z + 2), (bw_,),
                                           generator=g, dtype=torch.int32)
                             for o, z in members]).to(dev)
        scales = (torch.rand(n_oh, bw_, generator=g) + 0.01).to(dev)
        fmap = tuple((0, t) for t in range(emb.shape[1]))
        args = (bottom, arena, slots, scales, [emb.transpose(0, 1)], fmap, members)
        feats = [bottom] + oh_rows_ref(arena, slots, scales, bw_, members) + list(emb.unbind(1))
        check(f"K3 wide F={f} D={d}", dot_interaction_oh_parts(*args),
              dot_interaction_oh_parts_ref(*args), feats, bottom)
    # A CUDA tensor of another type, or features of another type than the
    # bottom, still raises: nothing falls back.
    if dev.type == "cuda":
        bottom = torch.randn(4, DIM, generator=g).to(dev)
        for bad in (bottom.half(), bottom.double()):
            try:
                fused_dot_interaction(bad, bad[:, None, :].expand(4, 3, DIM).contiguous())
            except ValueError:
                n_checks += 1
            else:
                raise AssertionError(f"K4 took a {bad.dtype} bottom")
        try:
            dot_interaction_parts(bottom.to(bf), [bottom[None]], ((0, 0),))
        except ValueError:
            n_checks += 1
        else:
            raise AssertionError("K2 took f32 parts beside a bf16 bottom")
    return n_checks


def k5_inputs(m, k, n, g, dev):
    """x [M, K] f32 with rows of zeros, a few rows scaled far up, and rows
    whose quotients x / xs fall on half-integers (absmax 127, so xs = 1: the
    kernel's exact-divide fallback and ties to even), wq [N, K] int8 over the
    full range, wscale and bias [N] f32."""
    x = torch.randn(m, k, generator=g) * 3
    x[::97] = 0.0
    x[1::89] *= 1e4
    if m > 3:
        ties = (torch.arange(k) % 254).float() - 126.5
        ties[0] = 127.0
        x[2], x[3] = ties, ties * 0.3
    wq = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    ws = torch.rand(n, generator=g) * 0.01 + 1e-4
    b = torch.randn(n, generator=g)
    return x.to(dev), wq.to(dev), ws.to(dev), b.to(dev)


def k5_check(got, want, act, what):
    """Bit-exact for act None / relu, else rtol and atol K5_TOL. -> max |err|."""
    ok = torch.equal(got, want) if act in (None, "relu") else bool(
        ((got - want).abs() <= K5_TOL + K5_TOL * want.abs()).all())
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not ok:
        raise AssertionError(f"K5 {what} act {act}: kernel != plain (max err {err})")
    return err


# K5's plan boundaries (ops/quant_matmul.py k5_plan): N around the GEMV
# limit (8) and the slice and tile widths (64, 128), M around the narrow
# kernel's 16-row items and the tiles (32, 64, 128), K from the byte path
# (13) through the narrow kernel's register widths (128-512), the quantize
# kernel's (479, with weight rows padded to 480, the serving path's layout;
# 1024) and its two-pass rows past 1024 to GEMV_MAX_K.
K5_EDGE_N = (1, 8, 9, 127, 128, 129, 256, 257, 1024)
K5_EDGE_M = (1, 63, 65, 4097)
K5_EDGE_K = (13, 256, 479, 480, 1024, 2944)  # 480: K = 479, weight rows padded to 480
# More shapes: a ragged last column tile, K past a chunk ring's depth with
# rows not a multiple of 16 bytes, a wide N, K = 64 and K = 36 in the narrow
# kernel from float4 rows, with and without 16-byte weight rows.
K5_EDGE_EXTRA = ((100, 600, 520), (33, 1663, 96), (300, 1000, 2048), (65, 64, 300),
                 (64, 36, 129))
# K past the old limit of 2944: the products' K loop, the quantize kernel's
# two passes and the GEMV up to its shared memory (GEMV_MAX_K).
K5_EDGE_WIDE_K = ((4097, 2945, 1024), (65, 4096, 257), (63, 4096, 8), (33, 2945, 300),
                  (17, 29056, 8), (40, 29056, 129))
# All activations, with and without a bias, on one shape per path.
K5_EDGE_ALL_ACTS = ((65, 480, 1024), (63, 256, 257), (65, 2944, 8))


def k5_plans(m, n, k, wvec):
    """The plan of ``k5_plan`` and, past N = 8, every other plan the kernel
    takes for the shape: the narrow kernel (K <= 512) with both slice widths
    on two and on four CTAs per SM, the mma.sync product with each tile (and
    the one that quantizes its own rows, K <= 64), the wgmma product (16-byte
    weight rows) with each tile height and ring depth."""
    from hugectr_backend_tpu_torch.ops import quant_matmul as qm

    plans = [qm.k5_plan(m, n, k, wvec=wvec)]
    if n > 8:
        if k <= 512:
            plans += [qm._narrow_plan(m, n, k, bn, c * qm.H100_SMS)
                      for bn in (64, 128) for c in (2, 4)]
        if k <= 64:
            plans.append(qm._tile_plan(m, n, k, 64, 128, 4))
        plans += [qm._tile_plan(m, n, k, bm, bn) for bm, bn in qm.TILES]
        if wvec:
            plans += [qm._wgmma_plan(m, n, k, bm, st) for bm, st in ((128, 3), (64, 3), (64, 4))]
    return plans


def k5_edge_checks(dev) -> dict:
    """K5 against its plain version at every plan boundary: each (M, K, N)
    of the grid above with an activation and a bias that cycle over the
    cases (all of them on K5_EDGE_ALL_ACTS), inputs with rows of zeros and
    rows on half-integers, junk in the weight rows' padding; past N = 8 with
    the plan and every other variant (``k5_plans``), through the wrapper's
    private launcher. Bit-exact for act None / relu, else within K5_TOL.
    -> checks per plan."""
    from hugectr_backend_tpu_torch.ops.quant_matmul import _launch, w8a8_dense_plain

    g = torch.Generator().manual_seed(5)
    shapes = [(m, k, n) for n in K5_EDGE_N for m in K5_EDGE_M for k in K5_EDGE_K]
    cases = [(s, K5_ACTS[i % len(K5_ACTS)], (i // len(K5_ACTS)) % 2 == 0)
             for i, s in enumerate(shapes + list(K5_EDGE_EXTRA) + list(K5_EDGE_WIDE_K))]
    cases += [(s, act, bias) for s in K5_EDGE_ALL_ACTS for act in K5_ACTS for bias in (True, False)]
    counts: dict = {}
    for (m, kw, n), act, with_bias in cases:
        k = 479 if kw == 480 else kw
        x, wq, ws, b = k5_inputs(m, k, n, g, dev)
        if kw != k:  # rows padded to 16 bytes with junk past K: ignored
            padded = torch.randint(-127, 128, (n, kw), generator=g, dtype=torch.int8).to(dev)
            padded[:, :k] = wq
            wq = padded
        bias = b if with_bias else None
        want = w8a8_dense_plain(x, wq, ws, bias, act)
        for p in k5_plans(m, n, k, kw % 16 == 0):
            got = _launch(x, wq, ws, bias, act, p)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            what = f"{p.variant} {p.bm}x{p.bn}/{p.stages} grid {p.grid[0]}"
            k5_check(got, want, act, f"M {m} K {k} (rows {kw}) N {n} bias {with_bias} ({what})")
            key = f"{p.variant} {p.bm}x{p.bn}/{p.stages}"
            counts[key] = counts.get(key, 0) + 1
    return counts


def k5_quant_dense_check(dev) -> str:
    """Queue C: a w8a8 ``QuantDense(479, 1024)`` called directly hands K5 the
    rows behind ``kernel_q``, padded to 16 bytes (after ``.to(dev)`` too,
    and the layer's one copy of its weight). Its plan is ``wgmma``
    (``narrow`` on [N, K] rows), its output bit-equal to the plain version
    on the unpadded weight at batch BATCH, its state_dict [N, K]. -> the
    plan's variant."""
    from hugectr_backend_tpu_torch.models.quant_dense import QuantDense, quantize_weight
    from hugectr_backend_tpu_torch.ops.quant_matmul import (
        H100_SMS,
        _wvec,
        k5_plan,
        w8a8_dense_plain,
    )

    g = torch.Generator().manual_seed(SEED + 60)
    layer = QuantDense(479, 1024, "w8a8", activation="relu")
    q, sc = quantize_weight(torch.randn(1024, 479, generator=g) / 479 ** 0.5, "w8a8")
    layer.load_state_dict({"kernel_q": q, "kernel_scale": sc,
                           "bias": torch.randn(1024, generator=g) * 0.1})
    layer = layer.to(dev)
    x = torch.randn(BATCH, 479, generator=g).to(dev)
    # launch_plan's choice, on the CPU too (there with the H100's SM count).
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    plan, stored = (k5_plan(BATCH, 1024, 479, sms, _wvec(w)).variant
                    for w in (layer.k5_weight(), layer.kernel_q))
    if (plan, stored) != ("wgmma", "narrow"):
        raise AssertionError(f"QuantDense(479, 1024) w8a8: plan {plan} (rows as stored: "
                             f"{stored}), expected wgmma (narrow)")
    if layer.k5_weight().data_ptr() != layer.kernel_q.data_ptr():
        raise AssertionError("QuantDense(479, 1024) w8a8 holds a second copy of its weight")
    got = layer(x)
    want = w8a8_dense_plain(x, layer.kernel_q, layer.kernel_scale, layer.bias, "relu")
    if not torch.equal(got, want):
        raise AssertionError("QuantDense(479, 1024) w8a8 on its padded rows != plain")
    if tuple(layer.state_dict()["kernel_q"].shape) != (1024, 479):
        raise AssertionError("QuantDense's state_dict lost its [N, K] kernel_q")
    return plan


def bwd_err(got, want, feats: int, gmax: float, zm: float, what: str) -> float:
    """Backward kernel vs plain: rtol RTOL, atol 1e-6 * F * max|g| * max|z|
    (f32 z). -> max |err|."""
    err = (got - want).abs()
    if got.shape != want.shape or not bool(
            (err <= 1e-6 * feats * gmax * zm + RTOL * want.abs()).all()):
        raise AssertionError(f"{what}: kernel != plain (max err {float(err.max())})")
    return float(err.max()) if err.numel() else 0.0


def k4_edge_checks(dev) -> int:
    """K4 forward and backward (through autograd) against their plain
    versions; the chunked backward with phantom rows and unmapped subs."""
    from hugectr_backend_tpu_torch.ops.fused_interaction import (
        dot_interaction_parts,
        dot_interaction_parts_bwd_ref,
        fused_dot_interaction,
        fused_dot_interaction_bwd_ref,
        fused_dot_interaction_ref,
        part_major_order,
    )

    g = torch.Generator().manual_seed(4)
    n_checks = 0
    for b in (1, 7, 4096):
        for d in (16, 36, 128):
            for t in (1, 26):
                bottom = torch.randn(b, d, generator=g).to(dev)
                emb = torch.randn(b, t, d, generator=g).to(dev)
                got = fused_dot_interaction(bottom, emb)
                want = fused_dot_interaction_ref(bottom, emb)
                ok, err = interaction_err(got, want, zmax([bottom] + list(emb.unbind(1))))
                if not ok:
                    raise AssertionError(f"K4 B={b} T={t} D={d}: max err {err}")
                gout = torch.randn(tuple(got.shape), generator=g).to(dev)
                want_b, want_e = fused_dot_interaction_bwd_ref(bottom, emb, gout)
                gm = float(gout.abs().max())
                zm = max(float(bottom.abs().max()), float(emb.abs().max()))
                for need_b, need_e in ((True, True), (False, True), (True, False)):
                    xb = bottom.clone().requires_grad_(need_b)
                    xe = emb.clone().requires_grad_(need_e)
                    wrt = [x for x, need in ((xb, need_b), (xe, need_e)) if need]
                    grads = list(torch.autograd.grad(fused_dot_interaction(xb, xe), wrt, gout))
                    what = f"K4 backward B={b} T={t} D={d} needs {need_b, need_e}"
                    if need_b:
                        bwd_err(grads.pop(0), want_b, t + 1, gm, zm, what + " g_bottom")
                    if need_e:
                        bwd_err(grads.pop(0), want_e, t + 1, gm, zm, what + " g_emb")
                    n_checks += 1
    general = ((1, 2), (0, 0), (2, 0), (0, 3), (1, 0), (0, 1))
    for b, d in ((7, 36), (4096, DIM)):
        for fmap in (general, part_major_order(general)[1]):
            bottom = torch.randn(b, d, generator=g).to(dev).requires_grad_()
            parts = [torch.randn(n, s, d, generator=g).to(dev).requires_grad_()
                     for n, s in ((5, b + 3), (3, b), (1, b + 8))]
            out = dot_interaction_parts(bottom, parts, fmap)
            gout = torch.randn(tuple(out.shape), generator=g).to(dev)
            grads = torch.autograd.grad(out, [bottom] + parts, gout)
            want_b, want_p = dot_interaction_parts_bwd_ref(bottom.detach(),
                                                           [p.detach() for p in parts], fmap, gout)
            gm = float(gout.abs().max())
            zm = max(float(x.detach().abs().max()) for x in [bottom] + parts)
            what = f"K2 backward B={b} D={d} map {fmap}"
            bwd_err(grads[0], want_b, len(fmap) + 1, gm, zm, what)
            for i, (gp, wp) in enumerate(zip(grads[1:], want_p)):
                bwd_err(gp, wp, len(fmap) + 1, gm, zm, f"{what} part {i}")
                unmapped = [s for s in range(gp.shape[0]) if (i, s) not in fmap]
                if gp[:, b:].any() or (unmapped and gp[unmapped].any()):
                    raise AssertionError(f"{what} part {i}: phantom rows or unmapped "
                                         "subs got a gradient")
            n_checks += 1
    return n_checks


def bwd_edge_checks(dev) -> int:
    """The backward kernel against its plain version at its plan's
    boundaries: F in {2, 27, 128, 129, 147}, D in {4, 64, 128, 130} (130: two
    column slices, off the 16-byte path), B in {1, 777} and the training shape at
    B 4099 (no batch a multiple of the persistent grid); K2's chunked parts
    with phantom rows, unmapped subs and gradients not asked for (null
    pointers). Within bwd_err's tolerance; phantom rows and unmapped subs
    exactly zero. Past F = 147, see repaired_route_checks."""
    from hugectr_backend_tpu_torch.ops.fused_interaction import (
        dot_interaction_bwd,
        dot_interaction_parts_bwd_ref,
        fused_dot_interaction_bwd,
        fused_dot_interaction_bwd_ref,
    )

    g = torch.Generator().manual_seed(7)
    n_checks = 0
    shapes = [(b, f, d) for f in (2, 27, 128, 129, BWD_MAX_F) for d in (4, 64, 128, 130)
              for b in (1, 777)]
    for b, f, d in shapes + [(4099, 27, DIM)]:
        bottom = torch.randn(b, d, generator=g).to(dev)
        emb = torch.randn(b, f - 1, d, generator=g).to(dev)
        gout = torch.randn(b, d + f * (f - 1) // 2, generator=g).to(dev)
        (gb, ge), (wb, we) = (fused_dot_interaction_bwd(bottom, emb, gout),
                              fused_dot_interaction_bwd_ref(bottom, emb, gout))
        gm = float(gout.abs().max())
        zm = max(float(bottom.abs().max()), float(emb.abs().max()))
        what = f"backward B={b} F={f} D={d}"
        bwd_err(gb, wb, f, gm, zm, what + " g_bottom")
        bwd_err(ge, we, f, gm, zm, what + " g_emb")
        n_checks += 1
    general = ((1, 2), (0, 0), (2, 0), (0, 3), (1, 0), (0, 1))
    for b, d in ((777, 64), (4096, 130)):
        bottom = torch.randn(b, d, generator=g).to(dev)
        parts = [torch.randn(n, s, d, generator=g).to(dev) for n, s in ((5, b + 3), (3, b), (1, b + 8))]
        gout = torch.randn(b, d + 7 * 6 // 2, generator=g).to(dev)
        want_b, want_p = dot_interaction_parts_bwd_ref(bottom, parts, general, gout)
        gm = float(gout.abs().max())
        zm = max(float(x.abs().max()) for x in [bottom] + parts)
        for need_b, need_p in ((True, (True, True, True)), (False, (True, False, True)),
                               (True, (False, True, False))):
            got_b, got_p = dot_interaction_bwd(bottom, parts, general, gout, need_b, need_p)
            what = f"K2 backward B={b} D={d} needs {need_b, need_p}"
            if (got_b is None) == need_b or any((gp is None) == nd for gp, nd in zip(got_p, need_p)):
                raise AssertionError(f"{what}: a gradient was computed or left out wrongly")
            if need_b:
                bwd_err(got_b, want_b, len(general) + 1, gm, zm, what + " g_bottom")
            for i, (gp, wp) in enumerate(zip(got_p, want_p)):
                if gp is None:
                    continue
                bwd_err(gp, wp, len(general) + 1, gm, zm, f"{what} part {i}")
                unmapped = [s for s in range(gp.shape[0]) if (i, s) not in general]
                if gp[:, b:].any() or (unmapped and gp[unmapped].any()):
                    raise AssertionError(f"{what} part {i}: phantom rows or unmapped subs got "
                                         "a gradient")
            n_checks += 1
    return n_checks


# The repaired routes (ops/fused_interaction.py k3_plan / bwd_plan and
# ops/quant_matmul.py k5_plan past their former limits). Forward: (B, F, D,
# one-hot members): F 689 at D 128 (past one warp's z tile), 1,101 with
# 1,100 fed features (past the 1,024 descriptors) and 1,041 with 1,030
# one-hot members, and 1,100 at D 36 (1,059 fed), all with z in shared
# memory; 800 and 850 at D 128, z in device memory. Backward: (B, F, D): F
# 148 (past the shared memory) and 700. K5: (M, K, N) with N <= 8 past the
# GEMV's K of 29,056.
WIDE_FWD = ((8, 689, DIM, 0), (5, 689, DIM, 60), (4, 1101, 16, 0), (3, 1041, 16, 1030),
            (7, 1100, 36, 40), (3, 800, DIM, 0), (2, 850, DIM, 30))
WIDE_BWD = ((1, 148, 4), (37, 148, DIM), (9, 148, 130), (3, 700, DIM), (2, 700, 36))
K5_PAST_GEMV = ((1, 29057, 8), (63, 29057, 1), (257, 100000, 8), (5, 100000, 1),
                (65, 30000, 3))
# The shapes each repaired route is timed at.
WIDE_TIMED = {"forward F 689": (256, 689, DIM, 0), "forward F 1101": (256, 1101, 16, 0),
              "forward F 800 (z in device memory)": (256, 800, DIM, 0),
              "backward F 148": (256, 148, DIM), "backward F 700": (64, 700, DIM),
              "K5 K 29057 N 8": (4096, 29057, 8), "K5 K 100000 N 1": (1024, 100000, 1)}


def _wide_fwd_case(b, f, d, n_oh, g, dev):
    """-> (kernel call, plain call, max|z|) for the forward at (B, F, D) with
    ``n_oh`` one-hot members (K3; K4 when 0), slots outside the members."""
    from hugectr_backend_tpu_torch.ops.fused_interaction import (
        dot_interaction_oh_parts,
        dot_interaction_oh_parts_ref,
        fused_dot_interaction,
        fused_dot_interaction_ref,
        oh_rows_ref,
    )

    bottom = torch.randn(b, d, generator=g).to(dev)
    emb = torch.randn(b, f - 1 - n_oh, d, generator=g).to(dev)
    if n_oh == 0:
        zm = zmax([bottom] + list(emb.unbind(1)))
        return (lambda: fused_dot_interaction(bottom, emb),
                lambda: fused_dot_interaction_ref(bottom, emb), zm)
    rows = 8 * n_oh
    arena = (torch.randn(rows, d, generator=g) * 40).clamp(-127, 127).round()
    arena = arena.to(torch.int8).to(dev)
    members = tuple((8 * j, 8 - (j % 3)) for j in range(n_oh))
    slots = torch.stack([torch.randint(max(0, o - 2), min(rows, o + z + 2), (b,), generator=g,
                                       dtype=torch.int32) for o, z in members]).to(dev)
    scales = (torch.rand(n_oh, b, generator=g) + 0.01).to(dev)
    parts = [emb.transpose(0, 1)]
    fmap = tuple((0, t) for t in range(emb.shape[1]))
    zm = zmax([bottom] + oh_rows_ref(arena, slots, scales, b, members) + list(emb.unbind(1)))
    args = (bottom, arena, slots, scales, parts, fmap, members)
    return (lambda: dot_interaction_oh_parts(*args),
            lambda: dot_interaction_oh_parts_ref(*args), zm)


def repaired_route_checks(dev) -> dict:
    """The routes past the card's former limits against their plain
    versions: the forward (K4 and K3, zero rows outside the members) at
    WIDE_FWD, the backward (K4 through autograd with one input not
    requiring grad, and K2's chunked parts with phantom rows, unmapped subs
    and gradients not asked for) at WIDE_BWD, K5 at K5_PAST_GEMV for every
    activation (bit-exact for None / relu). Each must take the wide plan.
    -> checks per route."""
    from hugectr_backend_tpu_torch.ops import fused_interaction as fi
    from hugectr_backend_tpu_torch.ops.quant_matmul import k5_plan, w8a8_dense, w8a8_dense_plain

    g = torch.Generator().manual_seed(17)
    counts = {"forward": 0, "backward": 0, "K5": 0}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
    for b, f, d, n_oh in WIDE_FWD:
        if not isinstance(fi.k3_plan(b, f, d, sms, max(f - 1 - n_oh, n_oh)), fi.K3WidePlan):
            raise AssertionError(f"forward F={f} D={d}: not the wide route")
        kernel, plain, zm = _wide_fwd_case(b, f, d, n_oh, g, dev)
        got, want = kernel(), plain()
        ok, err = interaction_err(got, want, zm)
        if not ok:
            raise AssertionError(f"wide forward B={b} F={f} D={d} one-hot {n_oh}: max err {err}")
        if n_oh and not torch.isfinite(got).all():
            raise AssertionError(f"wide forward F={f}: a slot outside its member was not a "
                                 "zero row")
        counts["forward"] += 1
    for b, f, d in WIDE_BWD:
        if not isinstance(fi.bwd_plan(b, d, f - 1, sms), fi.BwdWidePlan):
            raise AssertionError(f"backward F={f} D={d}: not the wide route")
        bottom = torch.randn(b, d, generator=g).to(dev)
        emb = torch.randn(b, f - 1, d, generator=g).to(dev)
        gout = torch.randn(b, d + f * (f - 1) // 2, generator=g).to(dev)
        wb, we = fi.fused_dot_interaction_bwd_ref(bottom, emb, gout)
        gm = float(gout.abs().max())
        zm = max(float(bottom.abs().max()), float(emb.abs().max()))
        for need_b, need_e in ((True, True), (False, True), (True, False)):
            xb, xe = bottom.clone().requires_grad_(need_b), emb.clone().requires_grad_(need_e)
            wrt = [x for x, need in ((xb, need_b), (xe, need_e)) if need]
            grads = list(torch.autograd.grad(fi.fused_dot_interaction(xb, xe), wrt, gout))
            what = f"wide backward B={b} F={f} D={d} needs {need_b, need_e}"
            if need_b:
                bwd_err(grads.pop(0), wb, f, gm, zm, what + " g_bottom")
            if need_e:
                bwd_err(grads.pop(0), we, f, gm, zm, what + " g_emb")
            counts["backward"] += 1
    # K2's chunked parts past F = 147: two parts with phantom rows, one sub
    # never mapped, gradients of the second part not asked for.
    b, d = 11, 64
    bottom = torch.randn(b, d, generator=g).to(dev)
    parts = [torch.randn(100, b + 3, d, generator=g).to(dev),
             torch.randn(60, b, d, generator=g).to(dev)]
    fmap = tuple([(0, s) for s in range(99)] + [(1, s) for s in range(60)])
    gout = torch.randn(b, d + 160 * 159 // 2, generator=g).to(dev)
    want_b, want_p = fi.dot_interaction_parts_bwd_ref(bottom, parts, fmap, gout)
    got_b, got_p = fi.dot_interaction_bwd(bottom, parts, fmap, gout, True, (True, False))
    gm = float(gout.abs().max())
    zm = max(float(x.abs().max()) for x in [bottom] + parts)
    bwd_err(got_b, want_b, 160, gm, zm, "wide K2 backward g_bottom")
    bwd_err(got_p[0], want_p[0], 160, gm, zm, "wide K2 backward part 0")
    if got_p[1] is not None or got_p[0][99].any() or got_p[0][:, b:].any():
        raise AssertionError("wide K2 backward: a gradient not asked for, an unmapped sub or "
                             "a phantom row got a value")
    counts["backward"] += 1
    for i, (m, k, n) in enumerate(K5_PAST_GEMV):
        if k5_plan(m, n, k, sms).variant != "tile":
            raise AssertionError(f"K5 M {m} K {k} N {n}: not the mma.sync product")
        x, wq, ws, bias = k5_inputs(m, k, n, g, dev)
        for j, act in enumerate(K5_ACTS):
            bb = bias if (i + j) % 2 == 0 else None
            k5_check(w8a8_dense(x, wq, ws, bb, act), w8a8_dense_plain(x, wq, ws, bb, act), act,
                     f"M {m} K {k} N {n} bias {bb is not None} (past the GEMV)")
            counts["K5"] += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return counts


def repaired_route_timings(dev, bw, f32_flops, emit_line) -> None:
    """Each repaired route at its WIDE_TIMED shape: device time per call of
    the kernel and of the plain version (CUDA-graph replay; the backward
    kernel by ``torch.profiler``, since its gradient buffers, and so its
    descriptor table, are new each call and a graph cannot capture the
    upload), the host-inclusive time of back-to-back calls (CUDA events: at
    1,100 features the wrapper's per-feature checks in Python show there),
    and the bound (bytes: inputs once, outputs once; the backward also its
    f32 FMAs)."""
    from hugectr_backend_tpu_torch.ops import fused_interaction as fi
    from hugectr_backend_tpu_torch.ops.quant_matmul import w8a8_dense, w8a8_dense_plain

    g = torch.Generator().manual_seed(18)
    for what, shape in WIDE_TIMED.items():
        if what.startswith("forward"):
            b, f, d, n_oh = shape
            kernel, plain, _ = _wide_fwd_case(b, f, d, n_oh, g, dev)
            nbytes = 4 * b * (f * d + d + f * (f - 1) // 2)
            t_ops = 0.0
        elif what.startswith("backward"):
            b, f, d = shape
            bottom = torch.randn(b, d, generator=g).to(dev)
            emb = torch.randn(b, f - 1, d, generator=g).to(dev)
            gout = torch.randn(b, d + f * (f - 1) // 2, generator=g).to(dev)
            kernel = lambda: fi.fused_dot_interaction_bwd(bottom, emb, gout)  # noqa: E731
            plain = lambda: fi.fused_dot_interaction_bwd_ref(bottom, emb, gout)  # noqa: E731
            nbytes = 4 * b * (2 * f * d + d + f * (f - 1) // 2)
            t_ops = 2 * b * f * (f - 1) * d / f32_flops
        else:
            m, k, n = shape
            x, wq, ws, bias = k5_inputs(m, k, n, g, dev)
            kernel = lambda: w8a8_dense(x, wq, ws, bias, "relu")  # noqa: E731
            plain = lambda: w8a8_dense_plain(x, wq, ws, bias, "relu")  # noqa: E731
            nbytes = 4 * m * k + n * k + 8 * n + 4 * m * n
            t_ops = 0.0
        if what.startswith("backward"):
            kernel()
            _, top = device_profile(lambda: [kernel() for _ in range(5)], 5)
            kernel_ms = sum(ms for name, ms in top if "bwd_wide" in name)
        else:
            kernel_ms = device_ms(kernel, per_graph=2, replays=3)
        t_bytes = nbytes / bw
        emit_line({"repaired_route": what, "shape": list(shape), "kernel_ms": kernel_ms,
                   "plain_ms": device_ms(plain, per_graph=2, replays=3),
                   "eager_ms": eager_ms(kernel, iters=5, warmup=1),
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"})


def forward_only_checks(dev) -> int:
    """K3, K5 and K1 have no backward: under autograd their wrappers raise."""
    from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant, gather_dequant_groups
    from hugectr_backend_tpu_torch.ops.fused_interaction import dot_interaction_oh_parts
    from hugectr_backend_tpu_torch.ops.quant_matmul import w8a8_dense

    bottom = torch.randn(8, DIM, device=dev, requires_grad=True)
    arena = torch.zeros(16, DIM, dtype=torch.int8, device=dev)
    slots = torch.zeros(1, 8, dtype=torch.int32, device=dev)
    parts = [torch.randn(1, 8, DIM, device=dev)]
    x = torch.randn(8, 64, device=dev, requires_grad=True)
    wq = torch.ones(16, 64, dtype=torch.int8, device=dev)
    table = torch.randn(16, DIM, device=dev, requires_grad=True)
    k1_slots = torch.zeros(8, dtype=torch.int32, device=dev)
    calls = (lambda: dot_interaction_oh_parts(bottom, arena, slots, None, parts, ((0, 0),)),
             lambda: w8a8_dense(x, wq, torch.ones(16, device=dev), None, "relu"),
             lambda: gather_dequant(table, None, k1_slots),
             lambda: gather_dequant_groups([table], [None], k1_slots, None, (("gather",),),
                                           ((0, 8),), (None,)))
    for name, call in zip(("K3", "K5", "K1", "grouped K1"), calls):
        try:
            call()
        except RuntimeError as e:
            if "forward-only" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} did not raise under autograd")
    return len(calls)


def same_bits(got, want) -> bool:
    """Equal bit for bit: -0.0 is not +0.0, and a NaN equals itself."""
    return got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))


def k6_edge_checks(dev) -> int:
    """K6 (both bodies) against its plain versions, bit for bit (the sign of
    a zero included); int8 also against K1; invalid plans and int4 arenas
    raise."""
    from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant
    from hugectr_backend_tpu_torch.ops.onehot_gather import (
        OnehotPlan,
        onehot_gather,
        onehot_gather_ref,
        onehot_gather_rows,
        onehot_gather_rows_ref,
        plan_onehot_worklist,
    )
    from hugectr_backend_tpu_torch.scripts.common import tile_layout

    def bodies(values, scales, slots, plan):
        return (("v1", onehot_gather(values, scales, slots, plan),
                 onehot_gather_ref(values, scales, slots, plan)),
                ("v1 no scales", onehot_gather(values, None, slots, plan),
                 onehot_gather_ref(values, None, slots, plan)),
                ("v2", onehot_gather_rows(values, slots, plan),
                 onehot_gather_rows_ref(values, slots, plan)))

    def arena(rng, rows, dt, dim=DIM):
        """Values over int8's range; for the float types scaled down, with
        an eighth of them -0.0 and, for bf16 / f32, a few +-inf."""
        vals = rng.integers(-127, 128, (rows, dim)).astype(np.float32)
        if dt != torch.int8:
            vals *= rng.random((rows, dim)).astype(np.float32)
            vals[rng.random((rows, dim)) < 0.125] = -0.0
            if dt != torch.float8_e4m3fn:
                vals[rng.random((rows, dim)) < 0.002] = np.inf
                vals[rng.random((rows, dim)) < 0.002] = -np.inf
        return torch.from_numpy(vals).to(dt).to(dev)

    rng = np.random.default_rng(6)
    r_tile, n_checks = 512, 0
    for member_rows in ([700], [3, 1461, 2174, 5684]):
        tiles, r_pad = tile_layout(member_rows, r_tile)
        for m_tile in K6_EDGE_M_TILES:
            # Two key tiles' worth for the first member, one for the others
            # (at least 1,024 keys a member: many key tiles at small m_tile).
            reps = max(1, 1024 // m_tile)
            kpm = [m_tile * reps * (2 if i == 0 else 1) for i in range(len(member_rows))]
            plan = plan_onehot_worklist(tiles, kpm, m_tile=m_tile, r_tile=r_tile)
            parts, inside = [], []
            for (a, nt), r, k in zip(tiles, member_rows, kpm):
                sl = a * r_tile + rng.integers(0, r, k)
                # An eighth anywhere: other members, past the arena, negative.
                sl[:k // 8] = rng.integers(-600, r_pad + 600, k // 8)
                parts.append(sl)
                inside.append((sl >= a * r_tile) & (sl < (a + nt) * r_tile))
            slots = torch.from_numpy(np.concatenate(parts).astype(np.int32)).to(dev)
            inside = torch.from_numpy(np.concatenate(inside)).to(dev)
            for dt in (torch.int8, torch.float8_e4m3fn, torch.bfloat16, torch.float32):
                values = arena(rng, r_pad, dt)
                scales = torch.from_numpy((rng.random(r_pad) + 0.01).astype(np.float32)).to(dev)
                for body, got, want in bodies(values, scales, slots, plan):
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    what = f"K6 {body} {dt} members {member_rows} m_tile {m_tile}"
                    if got.shape != (slots.shape[0], DIM) or not same_bits(got, want):
                        raise AssertionError(f"{what}: kernel != plain")
                    if got[~inside].any():
                        raise AssertionError(f"{what}: a slot outside its member's tiles "
                                             "gave a nonzero row")
                    n_checks += 1
                if dt == torch.int8:
                    for sc in (scales, None):
                        k6 = (onehot_gather(values, sc, slots, plan) if sc is not None
                              else onehot_gather_rows(values, slots, plan))
                        if not same_bits(k6[inside], gather_dequant(values, sc, slots[inside])):
                            raise AssertionError(f"K6 int8 members {member_rows} m_tile "
                                                 f"{m_tile}: != K1 on the same slots")
                        n_checks += 1
    # Runs that visit a row tile twice, with and without a miss between:
    # v + v, and -0.0 kept only where every step hits. Rows of 36 (the
    # element path for int8 / fp8, pieces for bf16 / f32) and of 128.
    for kt, rt in (([0, 0], [0, 0]), ([0, 0, 0], [0, 1, 0]), ([0, 0, 1], [1, 1, 0])):
        first = [1] + [int(kt[i] != kt[i - 1]) for i in range(1, len(kt))]
        plan = OnehotPlan(np.asarray(kt, np.int32), np.asarray(rt, np.int32),
                          np.asarray(first, np.int32), kt[-1] + 1, m_tile=32, r_tile=64)
        slots = torch.from_numpy(rng.integers(-8, 136, 32 * (kt[-1] + 1)).astype(np.int32)).to(dev)
        for dim in (36, DIM):
            for dt in (torch.int8, torch.float8_e4m3fn, torch.bfloat16, torch.float32):
                values = arena(rng, 128, dt, dim)
                scales = torch.from_numpy((rng.random(128) + 0.01).astype(np.float32)).to(dev)
                for body, got, want in bodies(values, scales, slots, plan):
                    if not same_bits(got, want):
                        raise AssertionError(f"K6 {body} {dt} D {dim} plan kt {kt} rt {rt}: "
                                             "kernel != plain")
                    n_checks += 1
    # Invalid plans raise. `good`: one member of 2 row tiles, 2 key tiles of
    # 512: kt [0, 0, 1, 1], rt [0, 1, 0, 1], first [1, 0, 1, 0].
    values = torch.zeros(1024, DIM, dtype=torch.int8, device=dev)
    slots = torch.zeros(1024, dtype=torch.int32, device=dev)
    good = plan_onehot_worklist([(0, 2)], [1024])

    def bad(kt=good.kt, rt=good.rt, first=good.first, nkt=good.num_key_tiles):
        return OnehotPlan(np.asarray(kt, np.int32), np.asarray(rt, np.int32),
                          np.asarray(first, np.int32), nkt)

    cases = {
        "steps of a key tile not consecutive": (values, slots, bad([0, 1, 0, 1], [0, 0, 1, 1],
                                                                   [1, 1, 0, 0])),
        "first not at the start of a run": (values, slots, bad(first=[1, 1, 1, 0])),
        "a key tile without a run": (values, slots, bad([0, 0], [0, 1], [1, 0], 2)),
        "row tile past the arena": (values, slots, bad(rt=[0, 2, 0, 1])),
        "negative row tile": (values, slots, bad(rt=[-1, 1, 0, 1])),
        "arena rows not a multiple of r_tile": (values[:1000], slots, good),
        "slots length": (values, slots[:1000], good),
    }
    for what, (v, sl, plan) in cases.items():
        for call in (lambda: onehot_gather(v, None, sl, plan),
                     lambda: onehot_gather_rows(v, sl, plan)):
            try:
                call()
            except ValueError:
                n_checks += 1
            else:
                raise AssertionError(f"K6 did not raise on an invalid plan: {what}")
    try:
        onehot_gather_rows(values.view(torch.uint8), slots, good)
    except TypeError:
        n_checks += 1
    else:
        raise AssertionError("K6 did not raise on a nibble-packed int4 arena")
    return n_checks


# --------------------------------------------------------------- main path


def build_deployment(root: str, cards, dim: int, seed: int):
    """Write the sparse tables, create the parameter server on the card."""
    from hugectr_backend_tpu_torch import HierParameterServer
    from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
    from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table

    tables = []
    for t, n in enumerate(cards):
        tbl = make_synthetic_table(n, dim, seed=seed + t)
        write_sparse_model(os.path.join(root, f"t{t}"), tbl.keys, tbl.vectors)
        tables.append(tbl)
    cfg = {"models": [{
        "model": "dlrm",
        "sparse_files": [os.path.join(root, f"t{t}") for t in range(len(cards))],
        "embedding_vecsize_per_table": [dim] * len(cards),
        "maxnum_catfeature_query_per_table_per_sample": [1] * len(cards),
        "gpucacheper": 1.0,
        "embedding_cache_type": "static",
        "quant_bits": 8,
        "deployed_device_list": [0],
    }]}
    return tables, cfg


def make_model(num_tables: int, seed: int, quant_fmt=None):
    """DLRM with weights drawn from a numpy seed (lecun-normal, zero bias);
    with ``quant_fmt`` the same weights, quantized."""
    from hugectr_backend_tpu_torch.models.dlrm import DLRM
    from hugectr_backend_tpu_torch.models.quant_dense import quantize_model_params

    if quant_fmt:
        model = DLRM(NUM_DENSE, num_tables, BOTTOM, TOP, quant_fmt=quant_fmt)
        model.load_state_dict(quantize_model_params(
            make_model(num_tables, seed).state_dict(), quant_fmt))
        return model
    model = DLRM(NUM_DENSE, num_tables, BOTTOM, TOP)
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in model.state_dict().items():
        if name.endswith("weight"):
            w = rng.standard_normal(tuple(p.shape)) / np.sqrt(p.shape[1])
        else:
            w = np.zeros(tuple(p.shape))
        state[name] = torch.from_numpy(w.astype(np.float32))
    model.load_state_dict(state)
    return model


def make_batches(tables, batch: int, n: int, seed: int):
    """n batches of (keys per table [B, 1] with ~1% misses, dense [B, 13])."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        keys = []
        for tbl in tables:
            k = tbl.keys[rng.integers(0, tbl.num_rows, batch)].copy()
            miss = rng.random(batch) < 0.01
            k[miss] = -1 - rng.integers(0, 1 << 40, int(miss.sum()))
            keys.append(k.reshape(batch, 1))
        out.append((keys, rng.standard_normal((batch, NUM_DENSE)).astype(np.float32)))
    return out


def host_snapshot(cache):
    """Per table (values, scales, offset, index), each arena copied to the
    host once."""
    arenas, out = {}, []
    for view in cache.tables:
        a = view.arena
        if id(a) not in arenas:
            arenas[id(a)] = (a.values.cpu().numpy(), a.scales.cpu().numpy())
        out.append((*arenas[id(a)], view.offset, view.index))
    return out


def host_dequant(cache, keys, snap=None):
    """Per-table f32 rows from the cache's stored bytes, in numpy, with the
    keys translated by the searchsorted lookup (the native index's plain
    version)."""
    outs = []
    for (vals, scales, offset, index), k in zip(snap or host_snapshot(cache), keys):
        gs = offset + index.search(np.asarray(k).reshape(-1)).astype(np.int64)
        outs.append(vals[gs].astype(np.float32) * scales[gs][:, None])
    return outs


class Recorder:
    """Record the inputs the main path gives each kernel wrapper (one
    predict, outside the counted run): ``calls[name]`` lists the arguments
    of each call of the (module, name) ``targets``, the DLRM's by default."""

    def __init__(self, *targets):
        import hugectr_backend_tpu_torch.cache.lookup_program as lp
        import hugectr_backend_tpu_torch.models.dlrm as dl
        import hugectr_backend_tpu_torch.models.quant_dense as qd

        self._patches = targets or [(lp, "gather_dequant_groups"),
                                    (dl, "dot_interaction_parts"),
                                    (dl, "dot_interaction_oh_parts"), (qd, "w8a8_dense")]
        self.calls = {name: [] for _, name in self._patches}
        self._orig = {}

    def __enter__(self):
        for mod, name in self._patches:
            orig = getattr(mod, name)
            self._orig[(mod, name)] = orig

            def rec(*args, _o=orig, _n=name):
                self.calls[_n].append(args)
                return _o(*args)

            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for (mod, name), orig in self._orig.items():
            setattr(mod, name, orig)


def predict_sync(srv, keys, dense):
    out = srv.predict(keys, dense)
    torch.cuda.synchronize()
    return out


# ------------------------------------------------------------------ timing


def eager_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """CUDA-event time per call of back-to-back eager calls: the larger of
    the device time and the host's launch overhead (Python wrapper
    included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device time per call: ``per_graph`` calls captured in one CUDA graph,
    replayed, timed with CUDA events. No host launch overhead."""
    from hugectr_backend_tpu_torch.scripts.common import graph_us

    return graph_us([fn] * per_graph, replays) / 1e3


def timings(kernel, plain, library) -> dict:
    """``library`` may be None (no library call computes the function)."""
    return {
        "kernel_ms": device_ms(kernel),
        "plain_ms": device_ms(plain),
        "library_ms": None if library is None else device_ms(library),
        "eager_ms": eager_ms(kernel),
    }


def device_profile(run, n: int):
    """Device kernel time per unit of work (torch.profiler, CUPTI) and the
    kernels that take it, over ``run()``, which does ``n`` units.
    -> (busy_ms or None, [(name, ms per unit)])."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        # User annotations (Optimizer.step#Adam.step) are ranges on the
        # device timeline that span kernels: not device work of their own.
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by_name:
        return None, []
    top = sorted(((k[:80], v / n) for k, v in by_name.items()), key=lambda kv: -kv[1])
    return sum(by_name.values()) / n, top[:8]


def predict_profile(srv, batches):
    """Device kernel time per predict and the kernels that take it."""
    return device_profile(lambda: [predict_sync(srv, *bt) for bt in batches], len(batches))


def k1_measure(args, bw):
    from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant, gather_dequant_ref

    values, ds, slots, si = args
    got = gather_dequant(values, ds, slots, si)
    want = gather_dequant_ref(values, ds, slots, si)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K1 at a main-path shape: kernel != plain")
    n, d = got.shape
    uniq = torch.unique(slots).numel()
    row_bytes = values.shape[1] * values.element_size()
    nbytes = (uniq * row_bytes + n * 4 + n * d * 4
              + (uniq * 4 if ds is not None else 0) + (n * 4 if si is not None else 0))
    idx = slots.long()
    return {
        "shape": {"table_rows": values.shape[0], "n": n, "d": d,
                  "dtype": str(values.dtype).replace("torch.", ""),
                  "scales": "device" if ds is not None else "per-key" if si is not None else "none"},
        "max_abs_err": float((got - want).abs().max()) if n else 0.0,
        **timings(lambda: gather_dequant(values, ds, slots, si),
                  lambda: gather_dequant_ref(values, ds, slots, si),
                  lambda: torch.index_select(values, 0, idx)),
        "bound_ms": nbytes / bw * 1e3,
        "bound_by": "bytes",
    }


def k1_group_measure(args, bw):
    """The grouped K1 at a predict's recorded groups (one launch): bit-exact
    against its plain version, times, the ``index_select`` of each group
    chained in one CUDA graph as the library yardstick, and the bound: per
    group, its distinct rows, slots, scales and f32 output once."""
    from hugectr_backend_tpu_torch.ops.dequant_gather import (
        gather_dequant_groups,
        gather_dequant_groups_ref,
    )

    vals, dsc, slots_cat, scin_cat, meta, sb, cb = args
    got = gather_dequant_groups(*args)
    want = gather_dequant_groups_ref(*args)
    torch.cuda.synchronize()
    err = 0.0
    for gi, (x, y) in enumerate(zip(got, want)):
        if x is None:
            continue
        if not torch.equal(x, y):
            raise AssertionError(f"grouped K1 at a main-path shape, group {gi}: kernel != plain")
        err = max(err, float((x - y).abs().max()) if x.numel() else 0.0)
    nbytes, groups, idx = 0, [], []
    for v, ds, m, (a, b), c in zip(vals, dsc, meta, sb, cb):
        if m[0] == "skip":
            continue
        sl = slots_cat[a:b]
        n, uniq = b - a, torch.unique(sl).numel()
        d = v.shape[1] * (2 if v.dtype == torch.uint8 else 1)
        ds = ds if m[0] == "gather" else None
        nbytes += (uniq * v.shape[1] * v.element_size() + n * 4 + n * d * 4
                   + (uniq * 4 if ds is not None else 0) + (n * 4 if c is not None else 0))
        groups.append({"kind": m[0], "rows": n, "table_rows": v.shape[0],
                       "scales": "device" if ds is not None else "per-key" if c else "none"})
        idx.append((v, sl.long()))
    return {
        "shape": {"groups": groups},
        "max_abs_err": err,
        **timings(lambda: gather_dequant_groups(*args),
                  lambda: gather_dequant_groups_ref(*args),
                  lambda: [torch.index_select(v, 0, i) for v, i in idx]),
        "bound_ms": nbytes / bw * 1e3,
        "bound_by": "bytes",
    }


def interaction_measure(name, fn, ref, args, feats, in_bytes, bw, flops):
    """``in_bytes``: what the kernel must read (each input once). A bf16
    output is held to ``bf16_interaction_err`` and written at 2 bytes a
    value."""
    got = fn(*args)
    want = ref(*args)
    torch.cuda.synchronize()
    out_es = got.element_size()
    check = bf16_interaction_err if got.dtype == torch.bfloat16 else interaction_err
    ok, err = check(got, want, zmax(feats))
    if not ok:
        raise AssertionError(f"{name} ({got.dtype}) at the main-path shape: max err {err}")
    del got, want
    f = len(feats)
    b, d = feats[0].shape
    pairs = f * (f - 1) // 2
    z = torch.stack(feats, dim=1).to(torch.bfloat16)
    zt = z.transpose(1, 2)
    t_bytes = (in_bytes + b * (d + pairs) * out_es) / bw * 1e3
    t_ops = 2.0 * b * pairs * d / flops * 1e3
    return {
        "shape": {"batch": b, "features": f, "d": d, "io": "bf16" if out_es == 2 else "f32"},
        "max_abs_err": err,
        **timings(lambda: fn(*args), lambda: ref(*args), lambda: torch.bmm(z, zt)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def k4_bwd_measure(bottom, emb, g, bw, f32_flops):
    """K4's backward kernel at the training shape against its plain version;
    the yardstick is ``torch.bmm(dzzt, z)`` in f32 (TF32 off) on the
    scattered symmetric adjoint. Bound: max((g + z read, dz written) bytes /
    memory rate, 2 B F^2 D f32 FMA operations / the non-tensor f32 rate)."""
    from hugectr_backend_tpu_torch.ops.fused_interaction import (
        fused_dot_interaction_bwd,
        fused_dot_interaction_bwd_ref,
    )

    (gb, ge), (wb, we) = (fused_dot_interaction_bwd(bottom, emb, g),
                          fused_dot_interaction_bwd_ref(bottom, emb, g))
    torch.cuda.synchronize()
    b, t, d = emb.shape
    f = t + 1
    gm = float(g.abs().max())
    zm = max(float(bottom.abs().max()), float(emb.abs().max()))
    err = max(bwd_err(gb, wb, f, gm, zm, "K4 backward at the training shape: g_bottom"),
              bwd_err(ge, we, f, gm, zm, "K4 backward at the training shape: g_emb"))
    del gb, ge, wb, we
    rows, cols = torch.triu_indices(f, f, 1, device=g.device)
    dzzt = torch.zeros(b, f, f, device=g.device)
    dzzt[:, rows, cols] = g[:, d:]
    dzzt = dzzt + dzzt.transpose(1, 2)
    z = torch.cat([bottom[:, None, :], emb], dim=1)
    t_bytes = (g.numel() + 2 * b * f * d) * 4 / bw * 1e3
    t_ops = 2.0 * b * f * f * d / f32_flops * 1e3
    return {
        "shape": {"batch": b, "features": f, "d": d},
        "max_abs_err": err,
        **timings(lambda: fused_dot_interaction_bwd(bottom, emb, g),
                  lambda: fused_dot_interaction_bwd_ref(bottom, emb, g),
                  lambda: torch.bmm(dzzt, z)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def int_mm_call(x, wq):
    """``torch._int_mm`` on the operands K5 quantizes, K and N zero-padded to
    multiples of 8 as it requires: the int8 product alone (no activation
    quantization, no epilogue), as a yardstick. None where it refuses."""
    from hugectr_backend_tpu_torch.ops.quant_matmul import quantize_activations

    xq, _ = quantize_activations(x)
    (m, k), n = xq.shape, wq.shape[0]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    a = torch.zeros(m, kp, dtype=torch.int8, device=x.device)
    a[:, :k] = xq
    b = torch.zeros(np_, kp, dtype=torch.int8, device=x.device)
    b[:n, :k] = wq[:, :k]
    bt = b.t()
    try:
        torch._int_mm(a, bt)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"torch._int_mm refused M {m} K {kp} N {np_}: {e}", flush=True)
        return None
    return lambda: torch._int_mm(a, bt)


def k5_measure(args, bw, int8_ops):
    """K5 at one layer shape of the main path: bit-exact against plain (act
    None / relu; the DLRM has no other), times, and the bound
    max((4MK + KN + 8N + 4MN) / memory rate, 2MKN / int8 rate)."""
    from hugectr_backend_tpu_torch.ops.quant_matmul import launch_plan, w8a8_dense, w8a8_dense_plain

    x, wq, ws, b, act = args
    plan = launch_plan(x, wq)
    got = w8a8_dense(x, wq, ws, b, act)
    want = w8a8_dense_plain(x, wq, ws, b, act)
    torch.cuda.synchronize()
    err = k5_check(got, want, act, f"main-path layer {tuple(x.shape)} x {tuple(wq.shape)}")
    del got, want
    (m, k), n = x.shape, wq.shape[0]
    t_bytes = (4 * m * k + k * n + 8 * n + 4 * m * n) / bw * 1e3
    t_ops = 2.0 * m * k * n / int8_ops * 1e3
    return {
        "shape": {"m": m, "k": k, "n": n, "act": act},
        "plan": plan._asdict(),
        "max_abs_err": err,
        **timings(lambda: w8a8_dense(x, wq, ws, b, act),
                  lambda: w8a8_dense_plain(x, wq, ws, b, act), int_mm_call(x, wq)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def k6_measure(arena, plan, slots, rows_only: bool, bw) -> dict:
    """One K6 body at the microbenchmark's tiny16 shape: bit-exact against
    its plain version, times (K1 on the same slots beside them), and the
    bound: (distinct rows x row bytes + slots + distinct scales (v1) + the
    f32 output) / memory rate."""
    from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant
    from hugectr_backend_tpu_torch.ops.onehot_gather import (
        onehot_gather,
        onehot_gather_ref,
        onehot_gather_rows,
        onehot_gather_rows_ref,
    )

    values, scales = arena.values, None if rows_only else arena.scales
    if rows_only:
        kernel = lambda: onehot_gather_rows(values, slots, plan)  # noqa: E731
        plain = lambda: onehot_gather_rows_ref(values, slots, plan)  # noqa: E731
    else:
        kernel = lambda: onehot_gather(values, scales, slots, plan)  # noqa: E731
        plain = lambda: onehot_gather_ref(values, scales, slots, plan)  # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise AssertionError(f"K6 {'v2' if rows_only else 'v1'} at the tiny16 shape: "
                             "kernel != plain")
    n, d = got.shape
    uniq = torch.unique(slots).numel()
    nbytes = uniq * d * values.element_size() + n * 4 + n * d * 4 + (0 if rows_only else uniq * 4)
    idx = slots.long()
    return {
        "shape": {"keys": n, "d": d, "arena_rows": values.shape[0], "m_tile": plan.m_tile,
                  "r_tile": plan.r_tile, "steps": plan.steps, "distinct_rows": uniq,
                  "scales": "none" if rows_only else "device"},
        "max_abs_err": float((got - want).abs().max()),
        **timings(kernel, plain, lambda: torch.index_select(values, 0, idx)),
        "k1_ms": device_ms(lambda: gather_dequant(values, scales, slots)),
        "bound_ms": nbytes / bw * 1e3,
        "bound_by": "bytes",
    }


def predict_timing(srv, cache, batches, mode: str) -> dict:
    """Per-predict wall time (host clock around predict + synchronize), the
    host's share (key translation + argument assembly, which predict runs
    under the cache lock) and the device's kernel time (profiler). ``mode``
    ending in "k2" turns the one-hot fold off."""
    if mode.endswith("k2"):
        os.environ["HPS_OH_IN_KERNEL"] = "0"
    ts, hs = [], []
    for i in range(12):
        keys, dense = batches[i % len(batches)]
        t0 = time.perf_counter()
        predict_sync(srv, keys, dense)
        ts.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        with cache._lock:
            local = [cache.translate(t, k.reshape(-1)) for t, k in enumerate(keys)]
            cache.prepare_lookup([BATCH] * len(keys), local)
        hs.append((time.perf_counter() - t0) * 1e3)
    busy, top = predict_profile(srv, batches)
    os.environ.pop("HPS_OH_IN_KERNEL", None)
    ts, hs = sorted(ts[2:]), sorted(hs[2:])
    med = ts[len(ts) // 2]
    return {"mode": mode, "batch": BATCH, "median": med, "min": ts[0], "max": ts[-1],
            "runs": len(ts), "host_translate_prepare_median": hs[len(hs) // 2],
            "device_kernel_ms": busy,
            "device_idle_share": None if busy is None else 1 - busy / med,
            "top_device_kernels_ms": top}


def translate_ab(cache, batches) -> dict:
    """Key translation, the native StaticMap against the searchsorted lookup
    on every table and batch: slots bit-identical (else raise), and host
    times, median of 10 after 2 warm-ups: the one native call over all
    tables (the lookup path), native per table, searchsorted per table, and
    the argument assembly after it (``prepare_lookup``, under the lock)."""
    from hugectr_backend_tpu_torch.tiers.hbm import translate_indexes_batch

    idx = [t.index for t in cache.tables]
    for b, (keys, _) in enumerate(batches):
        flat = [k.reshape(-1) for k in keys]
        for t, (got, i, k) in enumerate(zip(translate_indexes_batch(idx, flat), idx, flat)):
            want = i.search(k)
            if not (np.array_equal(got, want) and np.array_equal(i.lookup(k), want)):
                raise AssertionError(f"batch {b} table {t}: StaticMap slots != searchsorted")
    runs = {"native_batch": [], "native_per_table": [], "searchsorted": [], "prepare": []}
    for r in range(12):
        flat = [k.reshape(-1) for k in batches[r % len(batches)][0]]
        t0 = time.perf_counter()
        local = translate_indexes_batch(idx, flat)
        t1 = time.perf_counter()
        for i, k in zip(idx, flat):
            i.lookup(k)
        t2 = time.perf_counter()
        for i, k in zip(idx, flat):
            i.search(k)
        t3 = time.perf_counter()
        with cache._lock:
            cache.prepare_lookup([k.shape[0] for k in flat], local)
        t4 = time.perf_counter()
        for name, dt in zip(runs, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            runs[name].append(dt * 1e3)
    med = {name: sorted(v[2:])[len(v[2:]) // 2] for name, v in runs.items()}
    return {"tables": len(idx), "native_tables": sum(i._native is not None for i in idx),
            "keys_per_table": BATCH, "batches_checked": len(batches),
            "host_translate_median": {k: med[k] for k in
                                      ("native_batch", "native_per_table", "searchsorted")},
            "host_prepare_median": med["prepare"], "unit": "ms"}


def _http(port, method, path, body=None, headers=None, timeout=60.0):
    """-> (status, headers, body); HTTP errors are returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _binary_infer(keys, numkeys, names=("KEYS", "NUMKEYS", "OUTPUT0")):
    """A KServe-v2 binary-tensor request (in and out); ``names``: the keys',
    the counts' and the output's tensor. -> (body, headers)."""
    kraw = np.ascontiguousarray(keys, "<i8").tobytes()
    nraw = np.asarray(numkeys, "<i4").tobytes()
    hdr = json.dumps({"inputs": [
        {"name": names[0], "datatype": "INT64", "shape": [len(keys)],
         "parameters": {"binary_data_size": len(kraw)}},
        {"name": names[1], "datatype": "INT32", "shape": [len(numkeys)],
         "parameters": {"binary_data_size": len(nraw)}}],
        "outputs": [{"name": names[2], "parameters": {"binary_data": True}}],
    }).encode()
    return hdr + kraw + nraw, {"Inference-Header-Content-Length": str(len(hdr)),
                               "Content-Type": "application/octet-stream"}


def _binary_output(resp) -> np.ndarray:
    status, headers, body = resp
    if status != 200:
        raise AssertionError(f"infer answered {status}: {body[:200]!r}")
    return np.frombuffer(body[int(headers["Inference-Header-Content-Length"]):], "<f4")


def frontend_requests(tables, n: int, samples: int, seed: int):
    """n requests of ``samples`` samples, one key a table each: Zipf over
    each table's real keys, ~1 % keys absent from every table (negative).
    -> list of (flat table-major KEYS, NUMKEYS)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        keys = []
        for tbl in tables:
            k = tbl.keys[rng.zipf(FRONTEND_ZIPF, samples) % tbl.num_rows]
            miss = rng.random(samples) < 0.01
            k[miss] = -1 - rng.integers(0, 1 << 40, int(miss.sum()))
            keys.append(k)
        out.append((np.concatenate(keys), [samples] * len(tables)))
    return out


def dispatch_breakdown(session, tables, samples: int) -> dict:
    """Where a merged batch's dispatch goes, one batch at a time (median of
    10 after 2 warm-ups, ms): ``lookup_flat`` and its device-to-host copy
    on a ``samples``-sample batch with the traffic's ~1 % absent keys, the
    same with those keys replaced by present ones (no miss merge), the
    miss merge's DRAM-tier queries alone, and the output's copy, pageable
    as the batcher does it and into a pinned buffer."""
    (keys, _), = frontend_requests(tables, 1, samples, SEED + 7)
    merged = np.split(keys, len(tables))
    hits = [np.where(m < 0, tbl.keys[0], m) for m, tbl in zip(merged, tables)]
    pads = [FRONTEND_MAX_BATCH] * len(tables)
    cache = session.cache
    misses = [m[m < 0] for m in merged]
    flat = session.lookup_flat(merged)
    pinned = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    steps = {
        "lookup_flat_and_copy": lambda: session.lookup_flat(merged, pad_counts=pads).cpu(),
        "lookup_flat_and_copy_all_hits": lambda: session.lookup_flat(
            hits, pad_counts=pads).cpu(),
        "dram_tier_queries": lambda: [cache.tier_query(t, k) for t, k in enumerate(misses)
                                      if k.size],
        "copy_pageable": lambda: flat.cpu(),
        "copy_pinned": lambda: pinned.copy_(flat),
    }
    runs = {k: [] for k in steps}
    for _ in range(12):
        for name, fn in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            runs[name].append((time.perf_counter() - t0) * 1e3)
    return {"samples": samples, "output_bytes": flat.numel() * 4,
            "tables_with_misses": sum(k.size > 0 for k in misses),
            **{k: sorted(v[2:])[len(v[2:]) // 2] for k, v in runs.items()}, "unit": "ms"}


def frontend_clients(port: int, req_path: str, out_path: str, seconds: float,
                     clients: int, keep: int) -> None:
    """The load generator of the front-end phase, run in a process of its
    own so that its threads do not share the server's interpreter lock:
    ``clients`` threads send the requests of ``req_path`` (round robin, a
    new one as soon as the last is answered) for ``seconds``. Prints
    "start" when the window opens; writes the latencies, each thread's
    first ``keep`` outputs and any error to ``out_path`` (npz)."""
    data = np.load(req_path)
    reqs = [_binary_infer(data[f"k{i}"], data[f"n{i}"].tolist()) for i in range(int(data["n"]))]
    lat, kept, errors = [], [], []
    lock = threading.Lock()
    stop = threading.Event()

    def client(c):
        i = c
        while not stop.is_set():
            t = time.perf_counter()
            try:
                out = _binary_output(_http(port, "POST", "/v2/models/dlrm/infer", *reqs[i % len(reqs)]))
            except Exception as e:  # written out; the phase fails on it
                with lock:
                    errors.append(repr(e))
                return
            dt = time.perf_counter() - t
            with lock:
                lat.append(dt)
                if (i - c) // clients < keep:
                    kept.append((i % len(reqs), out))
            i += clients

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    print("start", flush=True)
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    time.sleep(seconds)
    stop.set()
    for th in threads:
        th.join(timeout=120)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        errors.append("a client thread did not finish")
    np.savez(out_path, lat=np.asarray(lat), wall=wall, errors=np.asarray(errors, dtype=str),
             kept_idx=np.asarray([ri for ri, _ in kept], np.int64),
             **{f"out{j}": out for j, (_, out) in enumerate(kept)})


def frontend_phase(cfg, tables, device=None) -> dict:
    """The KServe-v2 HTTP front end on the card: ``serve`` in-process, 8
    clients (threads of a separate process, ``frontend_clients``) for 10 s
    after the pow2 buckets are warm, then the checks. Raises on any failed
    check. -> the numbers printed. (``device="cpu"`` rehearses it on the
    CPU, with ``torch.cuda.synchronize`` and ``dispatch_breakdown`` stubbed
    out.)"""
    from torch.profiler import ProfilerActivity, profile

    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.serving import metrics
    from hugectr_backend_tpu_torch.serving.server import serve

    cfg = json.loads(json.dumps(cfg))
    cfg["models"][0]["max_batch_size"] = FRONTEND_MAX_BATCH
    hists = {"queue": metrics.QUEUE_LATENCY, "batcher_request": metrics.REQUEST_LATENCY,
             "dispatch": metrics.BATCH_DISPATCH_SECONDS, "software": metrics.BATCH_SW_SECONDS,
             "batch": metrics.BATCH_SIZE}
    t0 = time.perf_counter()
    server = serve(cfg, port=0, block=False, grpc_port=None, device=device)
    deploy_s = time.perf_counter() - t0
    port = server.port
    infer_path = "/v2/models/dlrm/infer"
    work = tempfile.TemporaryDirectory(prefix="hps_chip_smoke_fe_")
    try:
        reqs = frontend_requests(tables, 64, FRONTEND_SAMPLES, SEED + 3)
        req_path = os.path.join(work.name, "requests.npz")
        out_path = os.path.join(work.name, "clients.npz")
        np.savez(req_path, n=len(reqs), **{f"k{i}": k for i, (k, _) in enumerate(reqs)},
                 **{f"n{i}": np.asarray(n) for i, (_, n) in enumerate(reqs)})
        for samples in (64, 128, 256):  # warm the pow2 buckets
            (keys, num), = frontend_requests(tables, 1, samples, SEED + samples)
            _binary_output(_http(port, "POST", infer_path, *_binary_infer(keys, num)))
        keep = -(-2 * FRONTEND_CHECKED // FRONTEND_CLIENTS)
        proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.frontend_clients({port}, {req_path!r}, "
             f"{out_path!r}, {FRONTEND_SECONDS}, {FRONTEND_CLIENTS}, {keep})"],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE, text=True)
        try:
            if proc.stdout.readline().strip() != "start":
                raise AssertionError("the client process did not start")
            before = {k: (h.count(model="dlrm"), h.sum(model="dlrm")) for k, h in hists.items()}
            kernels.launches.clear()
            t_start = time.perf_counter()
            time.sleep(FRONTEND_SECONDS / 2 - FRONTEND_PROFILE_S)
            # A profiled slice of the window: the card's busy time in it.
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t_prof = time.perf_counter()
                time.sleep(FRONTEND_PROFILE_S)
                prof_wall = time.perf_counter() - t_prof
            busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not getattr(e, "is_user_annotation", False)) / 1e3
            # A malformed request (NUMKEYS does not sum to the keys) while the
            # clients keep being served.
            keys, num = reqs[0]
            bad = _http(port, "POST", infer_path,
                        *_binary_infer(keys, [num[0] + 1] + num[1:]))
            proc.wait(timeout=FRONTEND_SECONDS + 180)
            if proc.returncode != 0:
                raise AssertionError(f"the client process exited {proc.returncode}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        after = {k: (h.count(model="dlrm"), h.sum(model="dlrm")) for k, h in hists.items()}
        k1 = kernels.launches.get("gather_dequant", 0)
        res = np.load(out_path)
        if res["errors"].size:
            raise AssertionError(f"front-end clients failed: {res['errors'][:3]}")
        lat, wall = res["lat"], float(res["wall"])
        n_batches = after["batch"][0] - before["batch"][0]
        mean = {k: (after[k][1] - before[k][1]) / max(after[k][0] - before[k][0], 1)
                for k in hists}
        if bad[0] != 400:
            raise AssertionError(f"a malformed request got {bad[0]}, not 400")
        # One K1 launch per merged batch (none on the CPU: the plain version).
        if n_batches == 0 or k1 != (0 if device == "cpu" else n_batches):
            raise AssertionError(f"K1 launched {k1} times for {n_batches} merged batches")
        if mean["batch"] <= FRONTEND_SAMPLES:
            raise AssertionError(f"no request was co-batched (mean batch {mean['batch']})")
        # Every kept response, bit for bit against the host dequant.
        cache = server.manager.ps.get_embedding_cache("dlrm", 0)
        snap = host_snapshot(cache)
        kept_idx = res["kept_idx"]
        for j, ri in enumerate(kept_idx):
            keys, num = reqs[ri]
            want = np.concatenate([r.reshape(-1) for r in host_dequant(
                cache, np.split(keys, len(tables)), snap)])
            if not np.array_equal(res[f"out{j}"].view(np.uint32), want.view(np.uint32)):
                raise AssertionError(f"request {ri}: response != host dequant")
        if kept_idx.size < FRONTEND_CHECKED:
            raise AssertionError(f"only {kept_idx.size} responses kept for the check")
        # The JSON protocol gives the binary protocol's floats.
        keys, num = reqs[0]
        binary = _binary_output(_http(port, "POST", infer_path, *_binary_infer(keys, num)))
        body = json.dumps({"inputs": [
            {"name": "KEYS", "datatype": "INT64", "shape": [len(keys)],
             "data": keys.tolist()},
            {"name": "NUMKEYS", "datatype": "INT32", "shape": [len(num)], "data": num},
        ]}).encode()
        status, _, jbody = _http(port, "POST", infer_path, body)
        jout = np.asarray(json.loads(jbody)["outputs"][0]["data"], np.float32) \
            if status == 200 else None
        if jout is None or not np.array_equal(jout.view(np.uint32), binary.view(np.uint32)):
            raise AssertionError(f"JSON response ({status}) != binary response")
        for method, path in (("GET", "/v2/health/ready"), ("GET", "/v2/models/dlrm"),
                             ("POST", "/v2/repository/index")):
            status = _http(port, method, path, b"" if method == "POST" else None)[0]
            if status != 200:
                raise AssertionError(f"{method} {path} answered {status}")
        text = _http(port, "GET", "/metrics")[2].decode()
        for name in ("hps_inference_request_success", "hps_inference_request_duration_seconds"):
            if not any(line.startswith(name) and 'model="dlrm"' in line
                       for line in text.splitlines()):
                raise AssertionError(f"/metrics lacks {name} for dlrm")
        # Unload, load: the same bytes again.
        t0 = time.perf_counter()
        for action in ("unload", "load"):
            status = _http(port, "POST", f"/v2/repository/models/dlrm/{action}", b"")[0]
            if status != 200:
                raise AssertionError(f"{action} answered {status}")
        reload_s = time.perf_counter() - t0
        again = _binary_output(_http(port, "POST", infer_path, *_binary_infer(keys, num)))
        if not np.array_equal(again.view(np.uint32), binary.view(np.uint32)):
            raise AssertionError("after unload + load the response changed")
        breakdown = dispatch_breakdown(server.manager._models["dlrm"].sessions[0], tables,
                                       int(mean["batch"]))
    finally:
        server.stop()
        work.cleanup()
    ls = np.sort(lat)
    n = ls.size
    return {
        "requests": int(n), "wall_s": wall, "qps": n / wall,
        "samples_per_s": n * FRONTEND_SAMPLES / wall,
        "p50_ms": float(ls[n // 2]) * 1e3, "p99_ms": float(ls[min(int(n * 0.99), n - 1)]) * 1e3,
        "merged_batches": int(n_batches), "mean_merged_batch": mean["batch"],
        "batcher_mean_ms": {k: mean[k] * 1e3 for k in
                            ("queue", "batcher_request", "dispatch", "software")},
        "k1_launches": k1, "k1_launches_per_merged_batch": k1 / n_batches,
        "profiled_s": prof_wall, "device_busy_ms": busy_ms,
        "device_idle_share": (1 - busy_ms / (prof_wall * 1e3)) if busy_ms else None,
        "checked_responses": int(kept_idx.size), "deploy_s": deploy_s,
        "unload_load_s": reload_s, "dispatch_breakdown": breakdown, "clients": FRONTEND_CLIENTS,
        "client_process": "separate", "samples_per_request": FRONTEND_SAMPLES,
        "max_batch_size": FRONTEND_MAX_BATCH,
    }


# ----------------------------------------------------- the dynamic tiers phase


class TierClock:
    """Per-batch counters of a dynamic cache and its server's tiers: the
    hits of each translation, the rows an insert writes (a key that repeats
    in a batch is written once per occurrence, as in the JAX package), the
    keys evicted (every new key, once the cache is full), and the time
    spent quantizing inserted rows, writing them (the scatter and its
    tensor copy; on the card timed with a synchronize on each side), and
    querying the DRAM and SSD tiers. It wraps instance attributes only."""

    def __init__(self, ps, cache):
        self.cache = cache
        self.sync = (cache.device.type == "cuda")
        self.reset()
        self._wrap(ps.dram, "query", "dram_query")
        if ps.ssd is not None:
            self._wrap(ps.ssd, "query", "ssd_query")
        self._wrap(cache, "_prepare_rows", "quantize")
        self._wrap(cache, "_apply_prepared", "scatter", sync=self.sync,
                   count=lambda args, out: ("rows_written", len(args[1])))
        self._wrap(cache, "_translate_all", None,
                   count=lambda args, out: ("hits", sum(int((~m).sum()) for _, m in out[2])))
        self._wrap(cache, "_translate_all", None,
                   count=lambda args, out: ("keys", sum(out[1])))
        for sm in cache.slotmaps:
            self._wrap(sm, "acquire", None, count=lambda args, out: (
                "evicted", int((out[1] != np.iinfo(np.int64).min).sum())))

    def reset(self):
        self.ms = {k: 0.0 for k in ("dram_query", "ssd_query", "quantize", "scatter")}
        self.n = {k: 0 for k in ("hits", "keys", "rows_written", "evicted")}

    def _wrap(self, obj, attr, clock, sync=False, count=None):
        orig = getattr(obj, attr)

        def timed(*args, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            if clock:
                self.ms[clock] += (time.perf_counter() - t0) * 1e3
            if count:
                k, v = count(args, out)
                self.n[k] += v
            return out

        setattr(obj, attr, timed)


def dyn_cfg(root, n_tables: int, name: str, broker_port: int, cache_type=None,
            threshold=None, dim: int = DIM) -> dict:
    """chip_smoke's Criteo deployment as a dynamic hierarchy: ``gpucacheper``
    0.5, a hash-map DRAM tier loaded at 0.5, the SSD tier (its directory
    ``root/ssd_<name>``) and a Kafka update stream. ``cache_type`` None
    leaves ``embedding_cache_type`` out (the default, dynamic)."""
    model = {"model": "dlrm",
             "sparse_files": [os.path.join(root, f"t{t}") for t in range(n_tables)],
             "embedding_vecsize_per_table": [dim] * n_tables,
             "maxnum_catfeature_query_per_table_per_sample": [1] * n_tables,
             "gpucacheper": DYN_CACHE_PER, "quant_bits": 8, "deployed_device_list": [0]}
    if cache_type is not None:
        model["embedding_cache_type"] = cache_type
    if threshold is not None:
        model["hit_rate_threshold"] = threshold
    return {"volatile_db": {"type": "hash_map", "initial_cache_rate": DYN_DRAM_RATE},
            "persistent_db": {"type": "rocks_db", "path": os.path.join(root, f"ssd_{name}")},
            "update_source": {"type": "kafka_message_queue",
                              "brokers": f"127.0.0.1:{broker_port}",
                              "poll_timeout_ms": 20, "max_commit_interval": 1},
            "models": [model]}


def dyn_batches(tables, batch: int, n: int, seed: int):
    """n batches of keys per table: Zipf(1.05) over each table's keys, ~1 %
    keys absent from every table (negative)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        keys = []
        for tbl in tables:
            k = tbl.keys[rng.zipf(FRONTEND_ZIPF, batch) % tbl.num_rows]
            miss = rng.random(batch) < 0.01
            k[miss] = -1 - rng.integers(0, 1 << 40, int(miss.sum()))
            keys.append(k)
        out.append(keys)
    return out


class TruthRows:
    """Each table's f32 rows (the tiers' vectors, updates included) and their
    host dequant (int8 row quantization, as the cache stores them); a key
    absent from the table reads the default row (0.0)."""

    def __init__(self, tables):
        self.order = [np.argsort(t.keys, kind="stable") for t in tables]
        self.sorted = [t.keys[o] for t, o in zip(tables, self.order)]
        self.vectors = [t.vectors for t in tables]

    def set(self, t: int, keys, vectors):
        pos = np.searchsorted(self.sorted[t], keys)
        self.vectors[t] = self.vectors[t].copy()
        self.vectors[t][self.order[t][pos]] = vectors

    def rows(self, t: int, keys):
        """-> (f32 rows, their host dequant)."""
        from hugectr_backend_tpu_torch.ops.quantize import quantize_rows_int8

        sk = self.sorted[t]
        pos = np.clip(np.searchsorted(sk, keys), 0, sk.size - 1)
        present = sk[pos] == keys
        f32 = np.zeros((keys.size, self.vectors[t].shape[1]), np.float32)
        f32[present] = self.vectors[t][self.order[t][pos[present]]]
        q, s = quantize_rows_int8(f32)
        return f32, q.astype(np.float32) * s[:, None]


def same_bits_np(a, b) -> bool:
    """numpy arrays equal bit for bit (as f32)."""
    a, b = np.ascontiguousarray(a, np.float32), np.ascontiguousarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def check_twin(cache, twin, outs, twin_outs, what: str) -> None:
    """The card's answers and resident key -> slot maps bit-identical to the
    CPU instance's."""
    for t, (a, b) in enumerate(zip(outs, twin_outs)):
        if not same_bits_np(a.cpu().numpy(), b.numpy()):
            raise AssertionError(f"{what}: table {t}: answers differ from the CPU instance")
    for t, (sa, sb) in enumerate(zip(cache.slotmaps, twin.slotmaps)):
        (ka, xa), (kb, xb) = sa.resident(), sb.resident()
        oa, ob = np.argsort(ka), np.argsort(kb)
        if not (np.array_equal(ka[oa], kb[ob]) and np.array_equal(xa[oa], xb[ob])):
            raise AssertionError(f"{what}: table {t}: resident map differs from the CPU instance")


def check_truth(truth, keys, outs, what: str, resident=None) -> None:
    """Every answer is its key's f32 tier row or that row's host dequant
    (never another key's row, never NaN); with ``resident`` given (per
    table, whether the key was resident when translated), exactly the one
    that residency implies."""
    for t, (k, o) in enumerate(zip(keys, outs)):
        o = o.cpu().numpy()
        if np.isnan(o).any():
            raise AssertionError(f"{what}: table {t}: NaN in the answer")
        f32, deq = truth.rows(t, k)
        is_f32 = (o.view(np.uint32) == f32.view(np.uint32)).all(1)
        is_deq = (o.view(np.uint32) == deq.view(np.uint32)).all(1)
        if resident is not None:
            ok = np.where(resident[t], is_deq, is_f32)
        else:
            ok = is_f32 | is_deq
        if not ok.all():
            i = int(np.flatnonzero(~ok)[0])
            raise AssertionError(f"{what}: table {t}: key {int(k[i])} served a row that is "
                                 "neither its tier row nor its dequant")


def resident_mask(cache, keys):
    return [sm.translate(k, touch=False) != sm.miss_slot
            for sm, k in zip(cache.slotmaps, keys)]


def clone_ms(cache, dev) -> dict:
    """What the functional row write costs beside the rows: one copy of each
    distinct tensor an insert replaces (an arena or a solo table), timed
    with CUDA events (median of 10)."""
    seen, total_bytes, total_ms, worst = set(), 0, 0.0, (0.0, 0)
    for table in cache.tables:
        holder = getattr(table, "arena", None) or table
        if id(holder) in seen:
            continue
        seen.add(id(holder))
        v = holder.values
        runs = []
        for _ in range(12):
            if dev.type == "cuda":
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                v.clone()
                b.record()
                b.synchronize()
                runs.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                v.clone()
                runs.append((time.perf_counter() - t0) * 1e3)
        ms = sorted(runs[2:])[len(runs[2:]) // 2]
        nbytes = v.numel() * v.element_size()
        total_bytes += nbytes
        total_ms += ms
        worst = max(worst, (ms, nbytes))
    return {"tensors": len(seen), "bytes": total_bytes, "sum_ms": total_ms,
            "largest_ms": worst[0], "largest_bytes": worst[1]}


def pick_update_tables(cache, n: int):
    """One table of each lookup kind (the largest), then the largest left."""
    by_rows = sorted(range(cache.num_tables), key=lambda t: -cache.tables[t].capacity)
    kinds, picked = {}, []
    for t in by_rows:
        arena = getattr(cache.tables[t], "arena", None)
        kind = arena.lookup_kind if arena is not None else "solo"
        if kind not in kinds:
            kinds[kind] = t
    picked = sorted(kinds.values(), key=lambda t: -cache.tables[t].capacity)[:n]
    picked += [t for t in by_rows if t not in picked][: n - len(picked)]
    return picked


def dynamic_tiers(dev, root, tables, batch: int = BATCH, emit_line=emit) -> dict:
    """The hierarchy behind the cache on the card: the deployment of
    ``dyn_cfg`` (the default dynamic cache, DRAM and SSD tiers, a Kafka
    update stream from an in-process ``MiniKafkaBroker``) over the sparse
    files in ``root``, served through ``LookupSession`` and the fused fold
    predict. Every step raises on a mismatch:

    1. synchronous inserts (``hit_rate_threshold`` 1.0), DYN_SYNC_BATCHES
       Zipf batches: answers and resident maps bit-identical to a CPU
       instance of the port after every batch, K1 once per lookup;
    2. the default threshold (asynchronous inserts), DYN_ASYNC_BATCHES
       batches: each answer the key's tier row or its dequant;
    3. stochastic and UVM caches, DYN_FLAVOUR_BATCHES batches each, held to
       their CPU instances (UVM: a ``refresh`` admits the missed keys);
    4. fold predict on the dynamic cache with a batch resident: logits
       bit-identical to a static deployment's (gpucacheper 0.5: the same
       lookup groups; rows at other slots);
    5. online update: new rows for DYN_UPDATE_KEYS keys of DYN_UPDATE_TABLES
       tables through the producer and the broker; once applied and after
       ``refresh(1.0)``, updated keys serve their new row, others the old.

    ``dev`` cpu rehearses it (the "card" instance then runs on the CPU too,
    and K1 is not launched). -> the numbers printed."""
    from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
    from hugectr_backend_tpu_torch.cache.embedding_cache import UvmEmbeddingCache
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.serving.program import make_dlrm_multi_server
    from hugectr_backend_tpu_torch.tiers.base import table_tag
    from hugectr_backend_tpu_torch.update.kafka_lite import KafkaQueueSource
    from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker

    on_card = dev.type == "cuda"
    device = None if on_card else "cpu"
    k1_per_lookup = 1 if on_card else 0
    n = len(tables)
    truth = TruthRows(tables)
    summary = {}
    phase_launches = collections.Counter()
    broker = MiniKafkaBroker().start()
    servers = []

    def create(name, cache_type=None, threshold=None, where=device):
        t0 = time.perf_counter()
        ps = HierParameterServer.create(
            dyn_cfg(root, n, name, broker.port, cache_type, threshold, tables[0].vectors.shape[1]),
            device=where)
        servers.append(ps)
        cache = ps.get_embedding_cache("dlrm", 0)
        return ps, cache, LookupSession.create(ps.get_model_params("dlrm"), cache), \
            time.perf_counter() - t0

    def close(ps):
        ps.shutdown()
        servers.remove(ps)

    def lookup(session, keys):
        """One counted lookup of the card instance: counts set to 0 just
        before, read just after, and added to the phase's."""
        kernels.launches.clear()
        t0 = time.perf_counter()
        out = session.lookup(keys)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        phase_launches.update(kernels.launches)
        return out, wall, kernels.launches.get("gather_dequant", 0)

    try:
        # Step 1: synchronous inserts, held to the CPU instance.
        ps, cache, session, create_s = create("dyn", threshold=1.0)
        twin_ps, twin, twin_session, twin_s = create("dyn_cpu", threshold=1.0, where="cpu")
        emit_line({"dynamic_tiers": "deploy", "create_s": create_s, "cpu_instance_create_s":
                   twin_s, "groups": [g[1] for g in cache._groups],
                   "device_bytes": cache.nbytes(), "capacity_rows": sum(
                       t.capacity for t in cache.tables), "ssd_records": sum(
                       ps.ssd.size(tg) for tg in ps.ssd.tables()),
                   "clone": clone_ms(cache, dev)})
        clock = TierClock(ps, cache)
        rows = []
        for i, keys in enumerate(dyn_batches(tables, batch, DYN_SYNC_BATCHES, SEED + 11)):
            clock.reset()
            out, wall, k1 = lookup(session, keys)
            twin_out = twin_session.lookup(keys)
            check_twin(cache, twin, out, twin_out, f"sync batch {i}")
            if k1 != k1_per_lookup:
                raise AssertionError(f"sync batch {i}: K1 launched {k1} times")
            row = {"batch": i, "hit_rate": clock.n["hits"] / clock.n["keys"],
                   "rows_written": clock.n["rows_written"], "evicted": clock.n["evicted"],
                   "k1_launches": k1, "lookup_ms": wall, **{f"{k}_ms": v for k, v in
                                                             clock.ms.items()}}
            rows.append(row)
            emit_line({"dynamic_tiers": "sync", **row})
        summary["sync"] = rows

        # Step 2: the default threshold: inserts on the drainer.
        ps2, cache2, session2, create2_s = create("dyn_async")
        clock2 = TierClock(ps2, cache2)
        k1_total, walls = 0, []
        for i, keys in enumerate(dyn_batches(tables, batch, DYN_ASYNC_BATCHES, SEED + 12)):
            out, wall, k1 = lookup(session2, keys)
            check_truth(truth, keys, out, f"async batch {i}")
            k1_total += k1
            walls.append(wall)
        if k1_total != k1_per_lookup * DYN_ASYNC_BATCHES:
            raise AssertionError(f"async: K1 launched {k1_total} times in "
                                 f"{DYN_ASYNC_BATCHES} lookups")
        pending = cache2.pending_inserts()
        drained = cache2.drain_pending(DYN_DEADLINE_S)
        summary["async"] = {
            "batches": DYN_ASYNC_BATCHES, "create_s": create2_s,
            "dropped_inserts": cache2.dropped_inserts, "pending_at_end": pending,
            "drained": drained, "hit_rate": clock2.n["hits"] / max(clock2.n["keys"], 1),
            "hit_rate_meter_mean": float(cache2.hit_meter.rates.mean()),
            "rows_written": clock2.n["rows_written"], "evicted": clock2.n["evicted"],
            "lookup_ms_median": sorted(walls)[len(walls) // 2],
            "lookup_ms_first": walls[0], "lookup_ms_last": walls[-1]}
        # One more batch once the queue is drained.
        clock2.reset()
        keys = dyn_batches(tables, batch, 1, SEED + 13)[0]
        out, _, _ = lookup(session2, keys)
        check_truth(truth, keys, out, "async, drained")
        summary["async"]["hit_rate_drained"] = clock2.n["hits"] / clock2.n["keys"]
        if not drained:
            raise AssertionError("async: the drainer did not finish in time")
        emit_line({"dynamic_tiers": "async", **summary["async"]})
        close(ps2)

        # Step 3: stochastic and UVM, each held to its CPU instance.
        for ctype in ("stochastic", "uvm"):
            ps3, cache3, s3, c3_s = create(ctype, ctype, 1.0)
            tps3, twin3, ts3, _ = create(f"{ctype}_cpu", ctype, 1.0, where="cpu")
            clock3 = TierClock(ps3, cache3)
            for i, keys in enumerate(dyn_batches(tables, batch, DYN_FLAVOUR_BATCHES,
                                                 SEED + 14)):
                out, wall, k1 = lookup(s3, keys)
                check_twin(cache3, twin3, out, ts3.lookup(keys), f"{ctype} batch {i}")
                if k1 != k1_per_lookup:
                    raise AssertionError(f"{ctype} batch {i}: K1 launched {k1} times")
            line = {"batches": DYN_FLAVOUR_BATCHES, "create_s": c3_s,
                    "hit_rate": clock3.n["hits"] / clock3.n["keys"],
                    "rows_written": clock3.n["rows_written"], "evicted": clock3.n["evicted"]}
            if isinstance(cache3, UvmEmbeddingCache):
                line["pending_admissions"] = sum(cache3.pending_admissions(t) for t in range(n))
                before = [set(sm.resident()[0].tolist()) for sm in cache3.slotmaps]
                t0 = time.perf_counter()
                line["refreshed_rows"] = cache3.refresh()
                line["refresh_ms"] = (time.perf_counter() - t0) * 1e3
                twin3.refresh()
                line["admitted"] = sum(len(set(sm.resident()[0].tolist()) - b)
                                       for sm, b in zip(cache3.slotmaps, before))
                if line["admitted"] == 0:
                    raise AssertionError("uvm: refresh admitted no missed key")
                keys = dyn_batches(tables, batch, 1, SEED + 15)[0]
                out, _, _ = lookup(s3, keys)
                check_twin(cache3, twin3, out, ts3.lookup(keys), "uvm after refresh")
            summary[ctype] = line
            emit_line({"dynamic_tiers": ctype, **line})
            close(ps3)
            close(tps3)

        # Step 4: fold predict with a batch resident, against a static
        # deployment of the same lookup groups.
        rng = np.random.default_rng(SEED + 16)
        fkeys = []
        for t, tbl in enumerate(tables):
            cap = cache.tables[t].capacity
            first = np.sort(tbl.keys)[:cap]  # the static 0.5 deployment's rows
            fkeys.append(first[rng.zipf(FRONTEND_ZIPF, batch) % cap])
        dense = rng.standard_normal((batch, NUM_DENSE)).astype(np.float32)
        lookup(session, fkeys)
        twin_session.lookup(fkeys)
        if not all(m.all() for m in resident_mask(cache, fkeys)):
            raise AssertionError("fold: the batch is not resident after its lookup")
        scfg = dyn_cfg(root, n, "static", broker.port, "static", None,
                       tables[0].vectors.shape[1])
        scfg = {"models": scfg["models"]}
        static_ps = HierParameterServer.create(scfg, device=device)
        servers.append(static_ps)
        static_cache = static_ps.get_embedding_cache("dlrm", 0)
        if [g[1] for g in static_cache._groups] != [g[1] for g in cache._groups]:
            raise AssertionError("fold: the static deployment's groups differ")
        dyn_srv = make_dlrm_multi_server(ps.get_model_params("dlrm"), cache, make_model(n, SEED))
        st_srv = make_dlrm_multi_server(static_ps.get_model_params("dlrm"), static_cache,
                                        make_model(n, SEED))
        kernels.launches.clear()
        with torch.inference_mode():
            got = dyn_srv.predict([k.reshape(batch, 1) for k in fkeys], dense)
            torch.cuda.synchronize()
        fold_launches = dict(kernels.launches)
        phase_launches.update(fold_launches)
        # The predict translated each table once, touching the keys' LRU
        # ticks: the CPU instance's maps take the same calls.
        for t, k in enumerate(fkeys):
            twin.translate(t, k)
        with torch.inference_mode():
            want = st_srv.predict([k.reshape(batch, 1) for k in fkeys], dense)
        if on_card and fold_launches.get("dot_interaction_oh_parts", 0) != 1:
            raise AssertionError(f"fold: launches {fold_launches}")
        moved = sum(int((sm.translate(k, touch=False) != np.searchsorted(np.sort(tbl.keys), k))
                        .sum()) for sm, k, tbl in zip(cache.slotmaps, fkeys, tables))
        if not (torch.isfinite(got).all() and same_bits(got.cpu(), want.cpu())):
            raise AssertionError("fold: logits on the dynamic cache differ from the static "
                                 "deployment's")
        summary["fold"] = {"batch": batch, "launches": fold_launches,
                           "keys_at_other_slots": moved, "bit_identical": True}
        emit_line({"dynamic_tiers": "fold", **summary["fold"]})
        static_ps.shutdown()
        servers.remove(static_ps)
        del dyn_srv, st_srv

        # Step 5: the online update through the producer and the broker.
        params = ps.get_model_params("dlrm")
        upd = pick_update_tables(cache, DYN_UPDATE_TABLES)
        producer = KafkaQueueSource(f"127.0.0.1:{broker.port}")
        posted = {}
        for t in upd:
            k = rng.choice(tables[t].keys, min(DYN_UPDATE_KEYS, tables[t].num_rows),
                           replace=False)
            v = rng.standard_normal((k.size, tables[t].vectors.shape[1])).astype(np.float32)
            posted[t] = (k, v)
        t_post = time.perf_counter()
        for t, (k, v) in posted.items():
            producer.post(table_tag("dlrm", params.table_name(t)), k, v)
        producer.close()
        deadline = time.perf_counter() + DYN_DEADLINE_S
        while True:
            done = all(same_bits_np(p.dram.query(table_tag("dlrm", params.table_name(t)), k)[0], v)
                       for p in (ps, twin_ps) for t, (k, v) in posted.items())
            if done:
                break
            if time.perf_counter() > deadline:
                raise AssertionError("update: the consumer did not apply the posted rows "
                                     f"within {DYN_DEADLINE_S} s")
            time.sleep(0.005)
        applied_ms = (time.perf_counter() - t_post) * 1e3
        refreshed = cache.refresh(1.0)
        torch.cuda.synchronize()
        visible_ms = (time.perf_counter() - t_post) * 1e3
        twin.refresh(1.0)
        for t, (k, v) in posted.items():
            truth.set(t, k, v)
        # Updated keys, then as many other keys, in each updated table.
        keys = dyn_batches(tables, batch, 1, SEED + 17)[0]
        for t, (k, _) in posted.items():
            others = np.setdiff1d(tables[t].keys, k)
            keys[t] = np.concatenate([k, rng.choice(others, min(k.size, others.size),
                                                    replace=False)])
        resident = resident_mask(cache, keys)
        out, _, _ = lookup(session, keys)
        check_truth(truth, keys, out, "update", resident)
        check_twin(cache, twin, out, twin_session.lookup(keys), "update")
        summary["update"] = {
            "tables": upd, "keys_per_table": [int(posted[t][0].size) for t in upd],
            "post_to_applied_ms": applied_ms, "post_to_visible_ms": visible_ms,
            "refreshed_rows": refreshed,
            "updated_resident": int(sum(r[: posted[t][0].size].sum()
                                        for t, r in ((t, resident[t]) for t in upd))),
            "applied_batches": ps.update_consumer.applied_batches}
        emit_line({"dynamic_tiers": "update", **summary["update"]})
        summary["launches"] = dict(phase_launches)
    finally:
        for p in list(servers):
            p.shutdown()
        broker.stop()
    return summary


# ------------------------------------------------------------------- zoo


class NoFallback:
    """Inside: a plain version of K1 given a CUDA tensor raises (on the card
    every lookup must run the kernel; CPU instances still use them)."""

    def __enter__(self):
        import hugectr_backend_tpu_torch.ops.dequant_gather as dg

        self._dg = dg
        self._orig = {n: getattr(dg, n) for n in ("gather_dequant_ref",
                                                   "gather_dequant_groups_ref")}
        for name, fn in self._orig.items():
            def guard(*args, _fn=fn, _name=name, **kw):
                flat = [t for a in args for t in (a if isinstance(a, (list, tuple)) else [a])]
                if any(isinstance(t, torch.Tensor) and t.is_cuda for t in flat):
                    raise AssertionError(f"{_name} was given a CUDA tensor")
                return _fn(*args, **kw)

            setattr(dg, name, guard)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self._dg, name, fn)


def zoo_launches(call, n: int, k1_each: int, dev, what: str) -> int:
    """Run ``call`` n times with the launch counts at 0 just before; the
    only kernel launched must be K1, ``k1_each`` times a call on the card
    (none on the CPU). -> K1 launches."""
    from hugectr_backend_tpu_torch.ops import kernels

    kernels.launches.clear()
    with NoFallback():
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    got = dict(kernels.launches)
    want = {"gather_dequant": k1_each * n} if dev.type == "cuda" else {}
    if got != want:
        raise AssertionError(f"zoo {what}: launches {got} in {n} calls, expected {want}")
    return got.get("gather_dequant", 0)


def zoo_timing(call, n: int = 10, warmup: int = 2) -> dict:
    """Wall time of ``call`` + synchronize (host clock; median of n after
    ``warmup``), the device's kernel time per call (profiler) and the idle
    share."""
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    busy, top = device_profile(lambda: [call() for _ in range(3)], 3)
    ts.sort()
    med = ts[len(ts) // 2]
    return {"wall_ms_median": med, "wall_ms_min": ts[0], "wall_ms_max": ts[-1], "runs": n,
            "device_kernel_ms": busy,
            "device_idle_share": None if busy is None else 1 - busy / med,
            "top_device_kernels_ms": top}


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over two tensors (got on any device)."""
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"output {tuple(got.shape)} (finite: "
                             f"{bool(torch.isfinite(got).all())}) vs {tuple(want.shape)}")
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def check_rel(what: str, rel: float) -> float:
    if not rel < ZOO_REL:
        raise AssertionError(f"zoo {what}: rel {rel} vs the CPU instance (bar {ZOO_REL})")
    return rel


def model_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def zoo_pair(model_fn, seed: int, biased: bool = False):
    """(the card's model, the CPU instance's), one set of weights: Flax's
    initialisation from a seeded generator, with ``biased`` every bias
    then drawn from ZOO_BIAS_STD N(0, 1) (``draw_biases_``)."""
    import copy

    model = model_fn().init_flax_(torch.Generator().manual_seed(seed))
    if biased:
        draw_biases_(model, seed + 1000)
    return model, copy.deepcopy(model)


def rms_rel(got, want) -> float:
    """sqrt(mean (got - want)^2 / mean want^2) over two tensors."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float(((got - want).pow(2).mean() / (want.pow(2).mean() + 1e-30)).sqrt())


def retrieval_check(keys, scores, ref_keys, ref_scores, rel_bar=ZOO_REL, move=None) -> tuple:
    """The card's top-k against the CPU instance's top-(k+1) on the same
    users: scores within ``rel_bar`` (rel), and the keys equal at every
    position whose score is more than ZOO_REL * max|score| from both
    neighbours (the k+1-th included), plus 2 * ``move`` [n] where given (how
    far the two instances' queries can move a user's scores). -> (rel,
    positions compared, positions)."""
    k = keys.shape[1]
    rel = rel_err(torch.from_numpy(scores), torch.from_numpy(ref_scores[:, :k]))
    if not rel < rel_bar:
        raise AssertionError(f"zoo retrieval scores: rel {rel} vs the CPU instance "
                             f"(bar {rel_bar})")
    gap = ZOO_REL * float(np.abs(ref_scores).max())
    if move is not None:
        gap = gap + 2 * np.asarray(move)[:, None]
    d = np.abs(np.diff(ref_scores, axis=1)) > gap  # [n, k]: position j vs j + 1
    sep = d[:, :k].copy()
    sep[:, 1:] &= d[:, : k - 1]
    bad = sep & (keys != ref_keys[:, :k])
    if bad.any():
        raise AssertionError(f"zoo retrieval: {int(bad.sum())} separated positions hold "
                             "other keys than the CPU instance's")
    return rel, int(sep.sum()), int(sep.size)


def bst_sqrt_dk_check(dev) -> None:
    """BST divides its attention logits by sqrt(dk) taken in compute_dtype,
    a 0-dim host tensor: in f32 that must divide on ``dev`` as the Python
    number it replaced (the f32 model's bits unchanged), bit for bit."""
    x = torch.randn(ZOO_BATCH, ZOO_SEQ + 1, generator=torch.Generator().manual_seed(SEED)).to(dev)
    for dk in (16, 32):
        if not torch.equal(x / math.sqrt(dk), x / torch.tensor(dk, dtype=torch.float32).sqrt()):
            raise AssertionError(f"sqrt({dk}) as a 0-dim host tensor divides otherwise than "
                                 f"the Python number on {dev}")


def din_deployment(root: str, seed: int):
    """Two ZOO_ROWS x DIM int8 tables (target / user, sequence / items) from
    one sparse file of random rows; each is "solo" (host-gathered scales)."""
    from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
    from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table

    tbl = make_synthetic_table(ZOO_ROWS, DIM, seed=seed, deterministic_fn=False)
    path = os.path.join(root, "din_items")
    write_sparse_model(path, tbl.keys, tbl.vectors)
    cfg = {"models": [{
        "model": "din",
        "sparse_files": [path, path],
        "embedding_vecsize_per_table": [DIM, DIM],
        "maxnum_catfeature_query_per_table_per_sample": [1, ZOO_SEQ],
        "gpucacheper": 1.0,
        "embedding_cache_type": "static",
        "quant_bits": 8,
        "deployed_device_list": [0],
    }]}
    return tbl, cfg


def din_traffic(tbl, batch: int, seed: int):
    """One batch of the DIN leg: Zipf(ZOO_ZIPF) rows for the targets and the
    [B, ZOO_SEQ] sequences, seq_len uniform in [1, ZOO_SEQ], dense [B, 13]."""
    rng = np.random.default_rng(seed)
    n = tbl.keys.shape[0]
    return (tbl.keys[rng.zipf(ZOO_ZIPF, batch) % n],
            tbl.keys[rng.zipf(ZOO_ZIPF, (batch, ZOO_SEQ)) % n],
            rng.integers(1, ZOO_SEQ + 1, batch).astype(np.int32),
            rng.standard_normal((batch, NUM_DENSE)).astype(np.float32))


def zoo_example_deployment(root: str):
    """The deployment of the JAX package's examples/07_model_zoo.py: a wide
    table 5,000 x 1 and tables 20,000 x 16 and 30,000 x 16, as the models
    "pair" (wide + a, 4 keys each), "stack" (a + b, 2 and 3 keys) and
    "two_tower" (a + b, one key each)."""
    from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
    from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table

    tbls = {}
    for i, (name, rows, dim) in enumerate((("wide", 5_000, 1), ("a", 20_000, 16),
                                           ("b", 30_000, 16))):
        tbls[name] = make_synthetic_table(rows, dim, seed=1 + i)
        write_sparse_model(os.path.join(root, name), tbls[name].keys, tbls[name].vectors)

    def model(name, files, dims, kps):
        return {"model": name, "sparse_files": [os.path.join(root, f) for f in files],
                "embedding_vecsize_per_table": dims,
                "maxnum_catfeature_query_per_table_per_sample": kps,
                "gpucacheper": 1.0, "embedding_cache_type": "static",
                "deployed_device_list": [0]}

    cfg = {"models": [model("pair", ["wide", "a"], [1, 16], [4, 4]),
                      model("stack", ["a", "b"], [16, 16], [2, 3]),
                      model("two_tower", ["a", "b"], [16, 16], [1, 1])]}
    return tbls, cfg


def bf16_product_split(dev, emit_line=emit) -> list:
    """Each product of ``BF16_PRODUCTS`` on the card in three forms, against
    the CPU's repaired product of the same operands (x N(0, 1), weights
    N(0, 1) / sqrt(K), biases ZOO_BIAS_STD N(0, 1), all bf16, from SEED):
    (a) ``F.linear`` with its bias (the port before the repair: the bias
    added to the sum before the one rounding), (b) ``F.linear`` without it,
    then the bias in bf16, (c) the repaired product
    (``models.dlrm.matmul_f32_sums``: the f32 SGEMM of the bf16 operands,
    one rounding), then the bias in bf16, (d) the same arithmetic on the
    tensor cores (``torch.mm`` / ``torch.bmm`` with
    ``out_dtype=torch.float32``, ``microbench_zoo_dtypes.mm_out_dtype``;
    measured, not used by the port), then the bias; a batched product has
    no bias, so (a) and (b) are its bf16 ``torch.matmul``. All four run
    under PyTorch's default
    ``allow_bf16_reduced_precision_reduction``. Printed per form: the share
    of outputs that differ from the CPU's, and where the form has a rounded
    product of its own ((b), (c), every batched form), the largest
    difference of that product from the CPU's in bf16 ulps, twice: in ulps
    of the CPU's value (``*_max_ulps_at_cpu``, printed only), and as the
    bar reads it (``*_max_ulps``): the ulp taken at the larger of the two
    values, and never below the one at sqrt(K) 2^-16 of the sum of
    |a_i b_i|, where the sum cancels to near zero: two orders of a K-term
    f32 sum part by about sqrt(K) 2^-24 of that sum, which is a bf16 ulp of
    values 2^8 times as large. Without that floor the outputs where a sum
    cancels read as many ulps for every order but the CPU's own (on an H100,
    up to 740 ulps of the CPU's value for (d) and 230 for (c); PERF.md), so
    no second correct order of the same sums could pass. The output
    after the bias is not
    measured in ulps, because one ulp flipped in the product at a tie of
    the bias add's rounding moves it by two. Fails unless (c) is within 1
    ulp with at most BF16_SPLIT_SHARE of outputs differing at every
    product, and unless (a) misses that bar at one product at least."""
    import torch.nn.functional as F

    from hugectr_backend_tpu_torch.models.dlrm import matmul_f32_sums
    from hugectr_backend_tpu_torch.scripts.microbench_zoo_dtypes import mm_out_dtype

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(SEED + 30)
    lines, failed, a_within = [], [], 0
    for name, kind, dims in BF16_PRODUCTS:
        t0 = time.perf_counter()
        if kind == "linear":
            m, k, n = dims
            a = torch.randn(m, k, generator=g).to(bf)
            b = (torch.randn(n, k, generator=g) / math.sqrt(k)).to(bf).T
            bias = (ZOO_BIAS_STD * torch.randn(n, generator=g)).to(bf)
        else:
            _, m, k, n = dims
            a = torch.randn(*dims[:3], generator=g).to(bf)
            b = (torch.randn(dims[0], k, n, generator=g) / math.sqrt(k)).to(bf)
            bias = None
        prod = matmul_f32_sums(a, b)  # the CPU's repaired product
        want = prod if bias is None else prod + bias
        floor = torch.matmul(a.float().abs(), b.float().abs()) * (math.sqrt(k) * 2.0 ** -16)
        ad, bd = a.to(dev), b.to(dev)
        biasd = None if bias is None else bias.to(dev)
        if bias is None:
            forms = {"a": (lambda: torch.matmul(ad, bd), True),
                     "b": (lambda: torch.matmul(ad, bd), True),
                     "c": (lambda: matmul_f32_sums(ad, bd), True),
                     "d": (lambda: mm_out_dtype(ad, bd), True)}
        else:
            forms = {"a": (lambda: F.linear(ad, bd.T, biasd), False),
                     "b": (lambda: F.linear(ad, bd.T), True),
                     "c": (lambda: matmul_f32_sums(ad, bd), True),
                     "d": (lambda: mm_out_dtype(ad, bd), True)}
        if dev.type != "cuda":
            del forms["d"]  # no CPU kernel
        line = {"bf16_product": name, "kind": kind, "shape": list(dims),
                "bias": bias is not None, "outputs": want.numel()}
        for form, (call, own_product) in forms.items():
            with torch.inference_mode():
                got_prod = call().cpu()
            got = got_prod if bias is None or not own_product else got_prod + bias
            if got.dtype != bf or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"bf16 product {name} ({form}): {got.dtype}, finite "
                                     f"{bool(torch.isfinite(got).all())}")
            share = float((got != want).float().mean())
            ulps = ulps_at_cpu = None
            if own_product:
                diff = (got_prod.float() - prod.float()).abs()
                ulps_at_cpu = float((diff / bf16_ulp(prod)).max())
                scale = torch.maximum(torch.maximum(prod.float().abs(),
                                                    got_prod.float().abs()), floor)
                ulps = float((diff / bf16_ulp(scale)).max())
            within = share <= BF16_SPLIT_SHARE and ulps is not None and ulps <= 1.0
            line.update({f"{form}_share_differing": share, f"{form}_max_ulps": ulps,
                         f"{form}_max_ulps_at_cpu": ulps_at_cpu, f"{form}_within": within})
            if form == "a":
                a_within += within
            if form == "c" and not within:
                failed.append(f"{name}: share {share}, {ulps} ulps")
        line["seconds"] = time.perf_counter() - t0
        lines.append(line)
        emit_line(line)
        del a, b, prod, want, floor, ad, bd
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("the repaired bf16 product misses its bar against the CPU: "
                             + "; ".join(failed))
    if a_within == len(BF16_PRODUCTS):
        raise AssertionError("the bias-before-rounding form (a) met the repaired form's bar "
                             "at every product: the split cannot tell them apart")
    return lines


def draw_biases_(model, seed: int):
    """Every bias of ``model`` (``*.bias``, MMoE's ``expert_biases``;
    LayerNorm's too) drawn from ZOO_BIAS_STD N(0, 1). -> model."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "bias" in name:
                p.copy_(ZOO_BIAS_STD * torch.randn(p.shape, generator=g))
    return model


def zoo_phase(dev, ps, cfg, batches, emit_line=emit) -> dict:
    """The model zoo on the card, each output against a CPU instance of the
    port (its own parameter server, ``device="cpu"``) on the same weights
    and keys; K1 launched exactly once per multi-table predict, twice per
    DIN / BST predict, once per retrieve, and nothing else launched.

    1. DCN-v2 (BASELINE config 3, on one card) at the JAX defaults over
       ``ps``, the deployment of ``cfg`` (the 26 Criteo tables), on
       ``batches``.
    2. DIN, BST and two-tower retrieval (BASELINE config 4) on two
       ZOO_ROWS x DIM int8 tables, batch ZOO_BATCH, S ZOO_SEQ, k ZOO_K.
    3. WDL, DeepFM, xDeepFM, NCF, MMoE and a small DCN-v2 on the deployment
       and at the widths of examples/07_model_zoo.py, at ZOO_SMALL_BATCHES.

    Parts 1 and 2 print the wall, device time and idle share. -> {"launches":
    {"gather_dequant": n}, "lines": [...]}."""
    from hugectr_backend_tpu_torch import HierParameterServer
    from hugectr_backend_tpu_torch.models import (
        BST,
        DIN,
        MMoE,
        NCF,
        DCNv2,
        DeepFM,
        TwoTowerUser,
        WideAndDeep,
        XDeepFM,
    )
    from hugectr_backend_tpu_torch.serving import program
    from hugectr_backend_tpu_torch.serving.pooled import FusedDinServer
    from hugectr_backend_tpu_torch.serving.retrieval import RetrievalServer

    cpu = torch.device("cpu")
    k1 = 0
    lines = []

    def out(line):
        lines.append(line)
        emit_line(line)

    def deploy(cfg_):
        return (HierParameterServer.create(cfg_, device=dev),
                HierParameterServer.create(cfg_, device=cpu))

    dtypes = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
    # Each family on Flax's initial weights (zero biases), then with every
    # bias drawn (``*_bias`` lines; not timed): f32, then bf16 on each.
    legs = [(biased, dt) for biased in (False, True) for dt in dtypes]

    failed = []

    def held(fam, got, want, f32=None):
        """The card's output against the CPU instance's: rel < ZOO_REL at
        f32. At bf16 (``f32``: the card's and the CPU instance's f32 outputs
        on the same weights and inputs): within the family's ZOO_BF16_BAR,
        and closer to the CPU's bf16 output than to its f32 one, so that a
        card computing in f32 fails; the f32 output's own gap to the CPU's
        bf16 output is printed beside. A bf16 failure is raised at the end
        of the phase, after every line."""
        rel = rel_err(got, want)
        if f32 is None:
            return {"rel_vs_cpu": check_rel(fam, rel)}
        card_f32, cpu_f32 = f32
        line = {"rel_vs_cpu": rel, "bar": ZOO_BF16_BAR[fam],
                "rel_vs_cpu_f32": rel_err(got, cpu_f32),
                "f32_rel_vs_cpu": rel_err(card_f32, want),
                "rms_vs_cpu": rms_rel(got, want), "rms_vs_cpu_f32": rms_rel(got, cpu_f32),
                "f32_rms_vs_cpu": rms_rel(card_f32, want), "rel_vs_f32": rel_err(got, card_f32)}
        if not rel < ZOO_BF16_BAR[fam]:
            failed.append(f"zoo {fam} at bf16: rel {rel} vs the CPU instance "
                          f"(bar {ZOO_BF16_BAR[fam]})")
        if not line["rel_vs_cpu"] < line["rel_vs_cpu_f32"]:
            failed.append(f"zoo {fam} at bf16: no closer to the CPU's bf16 output "
                          f"({rel}) than to its f32 one ({line['rel_vs_cpu_f32']})")
        return line

    # Part 0: the bf16 products one at a time, three forms against the CPU.
    t0 = time.perf_counter()
    split = bf16_product_split(dev, out)
    print(f"zoo part 0 (the bf16 products one at a time): {time.perf_counter() - t0:.1f} s",
          flush=True)

    # Part 1: DCN-v2 over the 26 Criteo tables, f32 then bf16.
    t0 = time.perf_counter()
    ps_cpu = HierParameterServer.create(cfg, device=cpu)
    try:
        name = cfg["models"][0]["model"]
        n_tables = len(cfg["models"][0]["sparse_files"])
        keys, dense = batches[0]
        for biased, (dt_name, cd) in legs:
            if dt_name == "float32":
                f32 = None
            fam = "dcn_v2" + ("_bias" if biased else "")
            card_m, cpu_m = zoo_pair(
                lambda: DCNv2(NUM_DENSE, n_tables, DIM, compute_dtype=cd), SEED + 20, biased)
            srv = program.make_dcn_server(ps.get_model_params(name),
                                          ps.get_embedding_cache(name, 0), card_m)
            ref_srv = program.make_dcn_server(ps_cpu.get_model_params(name),
                                              ps_cpu.get_embedding_cache(name, 0), cpu_m)
            k1 += zoo_launches(lambda: srv.predict(*batches[0]), len(batches), 1, dev, "dcn")
            got = srv.predict(keys, dense)[:ZOO_REF]
            want = ref_srv.predict([k[:ZOO_REF] for k in keys], dense[:ZOO_REF])
            check = held(fam, got, want, f32)
            out({"zoo": fam + ("" if f32 is None else "_bf16"),
                 "compute_dtype": dt_name, "biases": biased,
                 "deployment": f"{n_tables} Criteo tables x {DIM} int8",
                 "bytes_on_card": ps.get_embedding_cache(name, 0).nbytes(),
                 "model_bytes": model_bytes(card_m),
                 "batch": int(dense.shape[0]), "width": NUM_DENSE + n_tables * DIM, **check,
                 "k1_per_predict": 1 if dev.type == "cuda" else 0,
                 **({} if biased else zoo_timing(lambda: srv.predict(*batches[1])))})
            f32 = (got, want)
            del srv, ref_srv, card_m, cpu_m
    finally:
        ps_cpu.shutdown()
    print(f"zoo part 1 (DCN-v2, f32 and bf16): {time.perf_counter() - t0:.1f} s", flush=True)

    # Part 2: DIN, BST and two-tower retrieval on two 1,000,000-row tables.
    t0 = time.perf_counter()
    bst_sqrt_dk_check(dev)
    with tempfile.TemporaryDirectory(prefix="hps_chip_smoke_zoo_") as root:
        tbl, din_cfg = din_deployment(root, SEED + 21)
        ps, ps_cpu = deploy(din_cfg)
        try:
            cache = ps.get_embedding_cache("din", 0)
            kinds = [g[1] for g in cache._groups]
            out({"zoo": "din_deploy", "rows": 2 * ZOO_ROWS, "dim": DIM, "kinds": kinds,
                 "bytes_on_card": cache.nbytes(), "seconds": time.perf_counter() - t0})
            params, params_cpu = ps.get_model_params("din"), ps_cpu.get_model_params("din")
            cache_cpu = ps_cpu.get_embedding_cache("din", 0)
            traffic = [din_traffic(tbl, ZOO_BATCH, SEED + 22 + i) for i in range(2)]
            ref = [x[:ZOO_REF] for x in traffic[0]]
            for fam, make in (
                    ("din", lambda cd: DIN(NUM_DENSE, DIM, (200, 80, 1), att_hidden=64,
                                           compute_dtype=cd)),
                    ("bst", lambda cd: BST(NUM_DENSE, DIM, ZOO_SEQ, num_heads=4, num_layers=1,
                                           head_widths=(256, 64, 1), compute_dtype=cd))):
                for biased, (dt_name, cd) in legs:
                    if dt_name == "float32":
                        f32 = None
                    leg = fam + ("_bias" if biased else "")
                    card_m, cpu_m = zoo_pair(lambda: make(cd), SEED + 23, biased)
                    srv = FusedDinServer(params, cache, card_m)
                    k1 += zoo_launches(lambda: srv.predict(*traffic[0]), 2, 2, dev, fam)
                    got = srv.predict(*traffic[0])[:ZOO_REF]
                    want = FusedDinServer(params_cpu, cache_cpu, cpu_m).predict(*ref)
                    check = held(leg, got, want, f32)
                    out({"zoo": leg + ("" if f32 is None else "_bf16"),
                         "compute_dtype": dt_name, "biases": biased, "batch": ZOO_BATCH,
                         "seq": ZOO_SEQ, **check, "model_bytes": model_bytes(card_m),
                         "k1_per_predict": 2 if dev.type == "cuda" else 0,
                         **({} if biased else zoo_timing(lambda: srv.predict(*traffic[1])))})
                    f32 = (got, want)
                    del srv, card_m, cpu_m
            tkeys, _, _, dense = traffic[0]
            ut, _, _, udense = traffic[1]
            n_ref = ZOO_REF_RETRIEVE
            for biased, (dt_name, cd) in legs:
                if dt_name == "float32":
                    f32_top = None
                leg = "retrieval" + ("_bias" if biased else "")
                card_m, cpu_m = zoo_pair(lambda: TwoTowerUser(NUM_DENSE, 1, DIM, (256, DIM),
                                                              compute_dtype=cd), SEED + 24,
                                         biased)
                srv = RetrievalServer(params, cache, card_m, k=ZOO_K)
                k1 += zoo_launches(lambda: srv.retrieve(tkeys, dense), 2, 1, dev, "retrieval")
                keys, scores = srv.retrieve(tkeys, dense)
                ref_keys, ref_scores = RetrievalServer(params_cpu, cache_cpu, cpu_m,
                                                       k=ZOO_K).retrieve(
                    tkeys[:n_ref], dense[:n_ref], k=ZOO_K + 1)
                if f32_top is None:
                    rel, compared, positions = retrieval_check(
                        keys[:n_ref], scores[:n_ref], ref_keys, ref_scores)
                    extra = {"rel_vs_cpu": rel}
                else:
                    # How far the two instances' queries move each user's
                    # scores: max over the items of |dq . item| (its scale
                    # applied), on top of the f32 rule's gap.
                    empty = np.zeros(0, np.int64)
                    with torch.inference_mode():
                        qs = [m(torch.from_numpy(dense[:n_ref]).to(c.device),
                                c.lookup([tkeys[:n_ref], empty])[0].view(n_ref, 1, DIM))
                              .float().cpu() for m, c in ((card_m, cache), (cpu_m, cache_cpu))]
                        corpus, iscales = srv._corpus()[:2]
                        moved = ((qs[0] - qs[1]).to(corpus.device) @ corpus.T).abs()
                        if iscales is not None:
                            moved *= iscales[None, :]
                        move = moved.amax(dim=1).cpu().numpy()
                        del moved
                    rel, compared, positions = retrieval_check(
                        keys[:n_ref], scores[:n_ref], ref_keys, ref_scores,
                        rel_bar=ZOO_BF16_BAR[leg], move=move)
                    extra = {**held(leg, torch.from_numpy(scores[:n_ref]),
                                    torch.from_numpy(ref_scores[:, :ZOO_K]),
                                    (torch.from_numpy(f32_top[1][:n_ref]),
                                     torch.from_numpy(f32_top[2]))),
                             "topk_overlap_vs_f32": float(np.mean(
                                 [len(set(a) & set(b)) / ZOO_K
                                  for a, b in zip(keys, f32_top[0])]))}
                out({"zoo": leg + ("" if f32_top is None else "_bf16"),
                     "compute_dtype": dt_name, "biases": biased, "batch": ZOO_BATCH,
                     "corpus": ZOO_ROWS,
                     "k": ZOO_K, "score_matrix_bytes": ZOO_BATCH * ZOO_ROWS * 4,
                     "corpus_f32_bytes": ZOO_ROWS * DIM * 4, "model_bytes": model_bytes(card_m),
                     **extra, "keys_compared": compared, "positions": positions,
                     "k1_per_retrieve": 1 if dev.type == "cuda" else 0,
                     **({} if biased else zoo_timing(lambda: srv.retrieve(ut, udense)))})
                f32_top = (keys, scores, ref_scores[:, :ZOO_K])
                del srv, card_m, cpu_m
        finally:
            ps.shutdown()
            ps_cpu.shutdown()
    torch.cuda.empty_cache()
    print(f"zoo part 2 (DIN, BST, retrieval; f32 and bf16): {time.perf_counter() - t0:.1f} s",
          flush=True)

    # Part 3: the small families of examples/07_model_zoo.py, f32 and bf16.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hps_chip_smoke_zoo_") as root:
        tbls, ex_cfg = zoo_example_deployment(root)
        ps, ps_cpu = deploy(ex_cfg)
        try:
            families = (
                ("wdl", "pair", program.make_wdl_server,
                 lambda cd: WideAndDeep(NUM_DENSE, 4, 16, (64, 1), compute_dtype=cd)),
                ("deepfm", "pair", program.make_deepfm_server,
                 lambda cd: DeepFM(NUM_DENSE, 4, 16, (64, 1), compute_dtype=cd)),
                ("dcn_v2_small", "stack", program.make_dcn_server,
                 lambda cd: DCNv2(NUM_DENSE, 5, 16, num_cross_layers=2, cross_rank=16,
                                  deep_widths=(64,), head_widths=(32, 1), compute_dtype=cd)),
                ("xdeepfm", "stack", program.make_xdeepfm_server,
                 lambda cd: XDeepFM(NUM_DENSE, 5, 16, (16, 8), (64, 1), compute_dtype=cd)),
                ("ncf", "two_tower", program.make_ncf_server,
                 lambda cd: NCF(0, 16, (64, 32), compute_dtype=cd)),
                ("mmoe", "stack", program.make_mmoe_server,
                 lambda cd: MMoE(NUM_DENSE, 5, 16, compute_dtype=cd)),
            )
            rng = np.random.default_rng(SEED + 25)
            for i, (fam, model_name, make_server, make) in enumerate(families):
                files = [os.path.basename(f) for f in
                         next(m for m in ex_cfg["models"]
                              if m["model"] == model_name)["sparse_files"]]
                kps = ps.get_model_params(model_name).maxnum_catfeature_query_per_table_per_sample
                inputs = [([tbls[f].keys[rng.integers(0, tbls[f].num_rows, (b, k))]
                            for f, k in zip(files, kps)],
                           rng.standard_normal((b, 0 if fam == "ncf" else NUM_DENSE)).astype(
                               np.float32)) for b in ZOO_SMALL_BATCHES]
                for biased, (dt_name, cd) in legs:
                    if dt_name == "float32":
                        f32s = None
                    leg = fam + ("_bias" if biased else "")
                    card_m, cpu_m = zoo_pair(lambda: make(cd), SEED + 26 + i, biased)
                    srv = make_server(ps.get_model_params(model_name),
                                      ps.get_embedding_cache(model_name, 0), card_m)
                    ref_srv = make_server(ps_cpu.get_model_params(model_name),
                                          ps_cpu.get_embedding_cache(model_name, 0), cpu_m)
                    outs = []
                    for j, (keys, dense) in enumerate(inputs):
                        k1 += zoo_launches(lambda: srv.predict(keys, dense), 1, 1, dev, fam)
                        got = srv.predict(keys, dense)
                        want = ref_srv.predict(keys, dense)
                        check = held(leg, got, want, None if f32s is None else f32s[j])
                        outs.append((got, want))
                        out({"zoo": leg + ("" if f32s is None else "_bf16"),
                             "compute_dtype": dt_name, "biases": biased, "model": model_name,
                             "batch": dense.shape[0], **check,
                             "bytes_on_card": ps.get_embedding_cache(model_name, 0).nbytes(),
                             "model_bytes": model_bytes(card_m),
                             "k1_per_predict": 1 if dev.type == "cuda" else 0})
                    f32s = outs
                    del srv, ref_srv, card_m, cpu_m
        finally:
            ps.shutdown()
            ps_cpu.shutdown()
    print(f"zoo part 3 (the example's six families, f32 and bf16): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        raise AssertionError("; ".join(failed))
    return {"launches": {"gather_dequant": k1} if k1 else {}, "lines": lines, "split": split}


# ------------------------------------------------------------ the ensemble phase


def ensemble_repository(root: str, tables, seed: int, max_batch: int,
                        formats=ENS_FORMATS, shards: int = 0):
    """A Triton-style repository in the layout of
    examples/05_triton_repo_ensemble.py: one HPS model ``hps_embedding`` (the
    26 tables in one key space: table t's row i is key ENS_KEY_STRIDE * t +
    i; int8, static cache at 100 %, 26 keys a sample), the dense models
    ``dense_<fmt>`` (reshape [-1, 26 * D], then TOP with relu... sigmoid and
    weights from a numpy seed, stored in each of ``formats``) behind the
    ensembles ``ens_<fmt>``, and ``ens_per_key`` whose dense model scores
    each key (reshape [-1, D]). ``shards`` > 1 row-shards the HPS model over
    ``deployed_device_list`` [0 .. shards - 1] (``shard_tables``; its
    instance_group lists the same devices). -> (offsets, f32 weights)."""
    from hugectr_backend_tpu_torch.io.dense_model import save_dense_model
    from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model

    n, dim = len(tables), tables[0].vectors.shape[1]
    hps = os.path.join(root, "hps_embedding")
    keys = np.concatenate([ENS_KEY_STRIDE * t + np.arange(tb.num_rows, dtype=np.int64)
                           for t, tb in enumerate(tables)])
    write_sparse_model(os.path.join(hps, "1", "emb.model"), keys,
                       np.concatenate([tb.vectors for tb in tables]))
    with open(os.path.join(hps, "config.pbtxt"), "w") as f:
        f.write(f'name: "hps_embedding"\nbackend: "hps"\nmax_batch_size: {max_batch}\n'
                'input [\n  { name: "KEYS" data_type: TYPE_INT64 dims: [ -1 ] },\n'
                '  { name: "NUMKEYS" data_type: TYPE_INT32 dims: [ -1 ] }\n]\n'
                'output [ { name: "OUTPUT0" data_type: TYPE_FP32 dims: [ -1 ] } ]\n'
                'instance_group [ { count: 1 kind: KIND_GPU gpus: [ '
                + ", ".join(str(d) for d in range(max(shards, 1))) + ' ] } ]\n')
    with open(os.path.join(root, "ps.json"), "w") as f:
        json.dump({"models": [{
            "model": "hps_embedding", "sparse_files": ["emb.model"],
            "embedding_vecsize_per_table": [dim],
            "maxnum_catfeature_query_per_table_per_sample": [n],
            "max_batch_size": max_batch, "gpucacheper": 1.0,
            "embedding_cache_type": "static", "quant_bits": 8,
            "deployed_device_list": list(range(max(shards, 1))),
            **({"shard_tables": True} if shards > 1 else {})}]}, f)
    rng = np.random.default_rng(seed)
    widths = (n * dim,) + TOP
    weights = [((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
                (rng.standard_normal(b) * 0.01).astype(np.float32))
               for a, b in zip(widths, widths[1:])]
    acts = ["relu"] * (len(TOP) - 1) + ["sigmoid"]
    per_key = [((rng.standard_normal((dim, 64)) / np.sqrt(dim)).astype(np.float32),
                np.zeros(64, np.float32)),
               ((rng.standard_normal((64, 1)) / 8.0).astype(np.float32), np.zeros(1, np.float32))]
    dense = {fmt: (weights, acts, [-1, n * dim], fmt) for fmt in formats}
    if formats == ENS_FORMATS:
        dense["per_key"] = (per_key, ["relu", "sigmoid"], [-1, dim], None)
    for name, (w, a, reshape, quant) in dense.items():
        d = os.path.join(root, f"dense_{name}")
        save_dense_model(os.path.join(d, "1"), w, a, reshape=reshape,
                         quant=None if quant in (None, "f32") else quant)
        with open(os.path.join(d, "config.pbtxt"), "w") as f:
            f.write(f'name: "dense_{name}"\nplatform: "hps_tpu_dense"\n'
                    'input [ { name: "input_1" data_type: TYPE_FP32 dims: [ -1 ] } ]\n'
                    'output [ { name: "output_1" data_type: TYPE_FP32 dims: [ -1, 1 ] } ]\n')
        e = os.path.join(root, f"ens_{name}")
        os.makedirs(os.path.join(e, "1"), exist_ok=True)
        with open(os.path.join(e, "config.pbtxt"), "w") as f:
            f.write(f'name: "ens_{name}"\nplatform: "ensemble"\n'
                    'input [\n  { name: "EMB_KEY" data_type: TYPE_INT64 dims: [ -1, -1 ] },\n'
                    '  { name: "EMB_N_KEY" data_type: TYPE_INT32 dims: [ -1, -1 ] }\n]\n'
                    'output [ { name: "DENSE_OUTPUT" data_type: TYPE_FP32 dims: [ -1, 1 ] } ]\n'
                    'ensemble_scheduling { step [\n'
                    '  { model_name: "hps_embedding" model_version: -1\n'
                    '    input_map { key: "KEYS" value: "EMB_KEY" }\n'
                    '    input_map { key: "NUMKEYS" value: "EMB_N_KEY" }\n'
                    '    output_map { key: "OUTPUT0" value: "LOOKUP_VECTORS" } },\n'
                    f'  {{ model_name: "dense_{name}" model_version: -1\n'
                    '    input_map { key: "input_1" value: "LOOKUP_VECTORS" }\n'
                    '    output_map { key: "output_1" value: "DENSE_OUTPUT" } }\n] }\n')
    return np.arange(n, dtype=np.int64) * ENS_KEY_STRIDE, weights


def ensemble_requests(tables, offsets, samples: int, n: int, seed: int):
    """n requests of ``samples`` samples, 26 keys each (sample-major, one a
    table), ~1 % of them absent from the table (negative)."""
    rng = np.random.default_rng(seed)
    cards = np.asarray([tb.num_rows for tb in tables])
    out = []
    for _ in range(n):
        keys = offsets + (rng.random((samples, len(tables))) * cards).astype(np.int64)
        miss = rng.random(keys.shape) < 0.01
        keys[miss] = -1 - rng.integers(0, 1 << 40, int(miss.sum()))
        out.append(keys.reshape(-1))
    return out


def _ens_inputs(keys):
    return {ENS_TENSORS[0]: np.asarray(keys, np.int64),
            ENS_TENSORS[1]: np.asarray([len(keys)], np.int32)}


def _ens_json(keys) -> bytes:
    return json.dumps({"inputs": [
        {"name": ENS_TENSORS[0], "datatype": "INT64", "shape": [len(keys)],
         "data": [int(k) for k in keys]},
        {"name": ENS_TENSORS[1], "datatype": "INT32", "shape": [1], "data": [len(keys)]},
    ]}).encode()


def _ens_binary(keys):
    return _binary_infer(keys, [len(keys)], ENS_TENSORS)


def grpc_ensemble_infer(port: int, model: str, keys) -> np.ndarray:
    """One KServe-v2 gRPC ModelInfer (raw tensors) -> DENSE_OUTPUT."""
    import grpc

    from hugectr_backend_tpu_torch.serving import kserve_pb

    pb2 = kserve_pb.load()
    req = pb2.ModelInferRequest(
        model_name=model,
        inputs=[pb2.ModelInferRequest.InferInputTensor(name=ENS_TENSORS[0], datatype="INT64",
                                                       shape=[len(keys)]),
                pb2.ModelInferRequest.InferInputTensor(name=ENS_TENSORS[1], datatype="INT32",
                                                       shape=[1])],
        raw_input_contents=[np.ascontiguousarray(keys, "<i8").tobytes(),
                            np.asarray([len(keys)], "<i4").tobytes()])
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        fn = ch.unary_unary(f"/{kserve_pb.SERVICE_NAME}/ModelInfer",
                            request_serializer=lambda m: m.SerializeToString(),
                            response_deserializer=pb2.ModelInferResponse.FromString)
        resp = fn(req, timeout=60)
    (out,) = resp.outputs
    return np.frombuffer(resp.raw_output_contents[0], "<f4").reshape(list(out.shape))


def ens_check(what: str, got, want, fmt) -> float:
    """got vs want within the dense-model tolerances (ENS_TOL). -> max |d|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rtol, atol = ENS_TOL[fmt]
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"ensemble {what}: shape {got.shape} vs {want.shape} or non-finite")
    err = np.abs(got - want)
    if not (err <= atol + rtol * np.abs(want)).all():
        raise AssertionError(f"ensemble {what}: max |delta| {float(err.max())} past rtol {rtol}"
                             f" atol {atol}")
    return float(err.max()) if err.size else 0.0


def ensemble_phase(dev, tables, bw=None, int8_ops=None, emit_line=emit,
                   batch: int = BATCH, grpc: bool = True) -> dict:
    """Triton model repository and ensembles on the card: ``serve(model_repository=
    ...)`` over ``ensemble_repository`` (the 26 tables of ``tables`` as one
    table), with HTTP and (``grpc``) gRPC. For each dense format of
    ENS_FORMATS: the fused path engages with one K1 launch per infer (and
    one K5 launch per layer for w8a8), fused = staged = the host reference
    (the host dequant of the cache's bytes through the port's DenseModel on
    the CPU) within ENS_TOL on the first ENS_REF samples, over the
    EnsembleServer, HTTP JSON, HTTP binary and gRPC; the fused and staged
    walls at ``batch`` with device time and idle share. A ragged request
    (ens_per_key) goes staged and is right. HTTP p50 / p99 of ENS_HTTP_SAMPLES-
    sample requests. With ``bw`` given, K1 at the fused path's shape and K5 at
    the w8a8 model's five layers are timed beside their plain versions and
    bounds. ``dev`` cpu rehearses it (no launch is counted there). -> the
    numbers, {"launches": ..., "lines": [...], "k1": ..., "k5": [...]}."""
    import hugectr_backend_tpu_torch.cache.lookup_program as lp
    import hugectr_backend_tpu_torch.io.dense_model as dmod
    from hugectr_backend_tpu_torch.cache.embedding_cache import _bucket
    from hugectr_backend_tpu_torch.io.dense_model import DenseModel
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.serving.server import serve

    on_card = dev.type == "cuda"
    lines, launches = [], collections.Counter()
    n = len(tables)

    def out(line):
        lines.append(line)
        emit_line(line)

    work = tempfile.TemporaryDirectory(prefix="hps_chip_smoke_ens_")
    server = None
    try:
        t0 = time.perf_counter()
        offsets, _ = ensemble_repository(work.name, tables, SEED + 40, batch)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        server = serve(model_repository=work.name, port=0, block=False,
                       grpc_port=0 if grpc else None, device=None if on_card else "cpu")
        deploy_s = time.perf_counter() - t0
        handler = server.httpd.RequestHandlerClass
        ensembles, dense = handler.ensembles, handler.dense_models
        cache = server.manager.ps.get_embedding_cache("hps_embedding", 0)
        snap = host_snapshot(cache)
        out({"ensemble": "deploy", "write_repository_s": write_s, "serve_s": deploy_s,
             "table_rows": int(cache.tables[0].capacity), "groups": [g[1] for g in cache._groups],
             "device_bytes": cache.nbytes(), "models": sorted(dense) + sorted(ensembles)})
        big, small = (ensemble_requests(tables, offsets, batch, ENS_TIMED + 2, SEED + 41),
                      ensemble_requests(tables, offsets, ENS_HTTP_SAMPLES, 4, SEED + 42))
        cpu_models = {}

        def host_ref(fmt, keys):
            """The host dequant of the cache's bytes through the port's dense
            model on the CPU."""
            if fmt not in cpu_models:
                cpu_models[fmt] = DenseModel.load(
                    os.path.join(work.name, f"dense_{fmt}", "1"), device="cpu")
            rows = host_dequant(cache, [keys], snap)[0]
            return cpu_models[fmt].forward(rows)

        k1_args = k5_args = None
        for fmt in ENS_FORMATS:
            es = ensembles[f"ens_{fmt}"]
            name = f"ens_{fmt}"
            # The counted fused infer: K1 once, K5 once a layer for w8a8.
            with Recorder((lp, "gather_dequant_groups"), (dmod, "w8a8_dense")) as rec:
                kernels.launches.clear()
                fused = es.infer(_ens_inputs(big[0]))[ENS_TENSORS[2]]
                torch.cuda.synchronize()
                got = dict(kernels.launches)
            if es._fused is None:
                raise AssertionError(f"{name}: the fused path did not engage")
            want = ({"gather_dequant": 1, **({"w8a8_dense": len(TOP)} if fmt == "w8a8" else {})}
                    if on_card else {})
            if got != want:
                raise AssertionError(f"{name}: a fused infer launched {got}, expected {want}")
            launches.update(got)
            # K1's work is the request's b_pad * 26 slots and no bucket pad
            # past them, so its bound (k1_group_measure) counts real keys.
            (k1_call,) = rec.calls["gather_dequant_groups"]
            if k1_call[2].shape[0] != _bucket(batch) * n:
                raise AssertionError(f"{name}: K1 gathered {k1_call[2].shape[0]} slots for "
                                     f"{_bucket(batch) * n} keys")
            if fmt == "w8a8":
                k1_args = k1_call
                k5_args = rec.calls["w8a8_dense"]
            kernels.launches.clear()
            staged = es.infer_staged(_ens_inputs(big[0]))[ENS_TENSORS[2]]
            torch.cuda.synchronize()
            staged_launches = dict(kernels.launches)
            launches.update(staged_launches)
            ref = host_ref(fmt, big[0][: ENS_REF * n])
            err = {"fused_vs_staged": ens_check(f"{name} fused vs staged", fused,
                                                staged.reshape(fused.shape), fmt),
                   "fused_vs_host": ens_check(f"{name} fused vs host", fused[:ENS_REF], ref,
                                              fmt)}
            # The front ends: HTTP JSON, HTTP binary, gRPC, each against
            # the host reference and the staged path.
            keys = small[0]
            ref_s = host_ref(fmt, keys)
            status, _, body = _http(server.port, "POST", f"/v2/models/{name}/infer",
                                    _ens_json(keys))
            if status != 200:
                raise AssertionError(f"{name}: JSON infer answered {status}: {body[:200]!r}")
            jout = np.asarray(json.loads(body)["outputs"][0]["data"], np.float32)
            resp = _http(server.port, "POST", f"/v2/models/{name}/infer", *_ens_binary(keys))
            bout = _binary_output(resp)
            err["http_json_vs_host"] = ens_check(f"{name} HTTP JSON", jout.reshape(-1, 1), ref_s,
                                                 fmt)
            err["http_binary_vs_host"] = ens_check(f"{name} HTTP binary", bout.reshape(-1, 1),
                                                   ref_s, fmt)
            if not np.array_equal(jout.view(np.uint32), bout.view(np.uint32)):
                raise AssertionError(f"{name}: JSON and binary responses differ")
            sm = es.infer_staged(_ens_inputs(keys))[ENS_TENSORS[2]]
            err["http_vs_staged"] = ens_check(f"{name} HTTP vs staged", bout.reshape(-1, 1),
                                              sm.reshape(-1, 1), fmt)
            if grpc:
                gout = grpc_ensemble_infer(server.grpc.port, name, keys)
                err["grpc_vs_host"] = ens_check(f"{name} gRPC", gout.reshape(-1, 1), ref_s, fmt)
                if not np.array_equal(gout.reshape(-1).view(np.uint32), bout.view(np.uint32)):
                    raise AssertionError(f"{name}: gRPC and HTTP responses differ")
            # Walls at the full batch, device time and idle share.
            it = itertools.cycle(big[1:])
            fused_t = zoo_timing(lambda: es.infer(_ens_inputs(next(it))), n=ENS_TIMED)
            staged_t = zoo_timing(lambda: es.infer_staged(_ens_inputs(next(it))), n=ENS_TIMED)
            out({"ensemble": name, "dense": fmt, "batch": batch, "keys": batch * n,
                 "fused": fused_t, "staged": staged_t, "fused_launches": got,
                 "staged_launches": staged_launches, "max_abs_err": err,
                 "tolerance": dict(zip(("rtol", "atol"), ENS_TOL[fmt]))})
        # A ragged request (not a multiple of 26 keys) goes staged.
        es = ensembles["ens_per_key"]
        staged_calls = []
        real = es.infer_staged
        es.infer_staged = lambda t: staged_calls.append(1) or real(t)
        try:
            keys = small[1][: n * 3 + 13]
            rag = es.infer(_ens_inputs(keys))[ENS_TENSORS[2]]
            whole = es.infer(_ens_inputs(small[1]))[ENS_TENSORS[2]]
        finally:
            del es.infer_staged
        if es._fused is None or len(staged_calls) != 1:
            raise AssertionError(f"ens_per_key: fused {es._fused is not None}, staged calls "
                                 f"{len(staged_calls)} (expected the ragged one only)")
        out({"ensemble": "ens_per_key", "ragged_keys": len(keys),
             "max_abs_err": {"ragged_vs_host": ens_check("ragged", rag, host_ref(
                 "per_key", keys), "f32"), "whole_vs_host": ens_check(
                 "per_key whole", whole, host_ref("per_key", small[1]), "f32")}})
        # HTTP latency of 64-sample requests to the f32 ensemble (fused),
        # one client, binary tensors.
        reqs = ensemble_requests(tables, offsets, ENS_HTTP_SAMPLES, ENS_HTTP_REQUESTS, SEED + 43)
        lat = []
        for keys in reqs:
            body, headers = _ens_binary(keys)
            t0 = time.perf_counter()
            _binary_output(_http(server.port, "POST", "/v2/models/ens_f32/infer", body,
                                 headers))
            lat.append(time.perf_counter() - t0)
        ls = np.sort(lat) * 1e3
        http = {"ensemble": "http_latency", "model": "ens_f32", "requests": len(ls),
                "samples_per_request": ENS_HTTP_SAMPLES, "clients": 1,
                "p50_ms": float(ls[len(ls) // 2]),
                "p99_ms": float(ls[min(int(len(ls) * 0.99), len(ls) - 1)])}
        out(http)
        k1 = k5 = None
        if bw is not None and on_card:
            k1 = k1_group_measure(k1_args, bw)
            out({"ensemble": "kernel", "kernel": "gather_dequant",
                 "path": "fused ensemble infer", **k1})
            k5 = [k5_measure(a, bw, int8_ops) for a in k5_args]
            for r in k5:
                out({"ensemble": "kernel", "kernel": "w8a8_dense", "path": "dense_w8a8", **r})
    finally:
        if server is not None:
            server.stop()
        work.cleanup()
    return {"launches": dict(launches), "lines": lines, "k1": k1, "k5": k5, "http": http}


# ------------------------------------------------------------- the cluster phase


def start_pool_node(secret: str, log: str, cert=None, key=None):
    """Start one DRAM pool node in a process of its own, through the
    module's command line (``python -m hugectr_backend_tpu_torch.tiers.cluster``),
    on a port the node picks itself (``--port 0``), with the shared secret
    and, with ``cert``, TLS; its standard error goes to ``log``, its port to
    ``log + ".port"``. -> (process, port file, log); ``wait_pool_node``
    reads the port back."""
    port_file = log + ".port"
    cmd = [sys.executable, "-m", "hugectr_backend_tpu_torch.tiers.cluster", "--host",
           "127.0.0.1", "--port", "0", "--port-file", port_file]
    if cert:
        cmd += ["--tls-cert", cert, "--tls-key", key]
    env = {**os.environ, "HPS_CLUSTER_SECRET": secret}
    with open(log, "w") as err:
        proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
    return proc, port_file, log


def wait_pool_node(proc, port_file: str, log: str) -> int:
    """Wait until a started node has written its port (it listens by then).
    -> the port; raise if the node exits or takes longer than
    CLUSTER_START_S."""
    deadline = time.perf_counter() + CLUSTER_START_S
    while not os.path.exists(port_file):
        if proc.poll() is not None:
            with open(log) as f:
                tail = f.read()[-2000:]
            raise AssertionError(f"pool node exited {proc.returncode}: {tail}")
        if time.perf_counter() > deadline:
            proc.kill()
            raise AssertionError(f"pool node did not start in {CLUSTER_START_S} s")
        time.sleep(0.1)
    with open(port_file) as f:
        return int(f.read())


def median_ms(fn, n: int = 5) -> float:
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[n // 2]


def cluster_phase(dev, root, tables, batch: int = BATCH, emit_line=emit) -> dict:
    """The ``redis_cluster`` volatile db on the card: two pool nodes in
    processes of their own on localhost, both with a shared secret and TLS
    (a certificate made here with ``openssl``; the reference's
    ``enable_tls`` is one setting for the whole pool), and the dynamic-cache
    deployment of ``dyn_cfg`` (synchronous inserts, the SSD tier; no update
    stream) with its DRAM tier on them. Checked: ``ps.dram`` is a
    ``ClusterKVTier`` (not the local fallback), both nodes hold rows, every
    lookup of CLUSTER_BATCHES batches is bit-identical to a CPU instance whose
    DRAM tier is the local native store, with K1 once per lookup; a node with
    the secret alone (in-process, plain TCP) answers bit for bit too. Printed:
    the pool's query and insert times beside the local store's for the same
    keys. ``dev`` cpu rehearses it. -> the numbers, with "launches"."""
    import ssl

    from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.tiers.base import table_tag
    from hugectr_backend_tpu_torch.tiers.cluster import ClusterKVTier, ClusterNodeServer

    on_card = dev.type == "cuda"
    secret = "chip-smoke-pool"
    work = tempfile.TemporaryDirectory(prefix="hps_chip_smoke_pool_")
    cert, key = os.path.join(work.name, "cert.pem"), os.path.join(work.name, "key.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", key,
                    "-out", cert, "-days", "1", "-subj", "/CN=localhost",
                    "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
                   check=True, capture_output=True, timeout=60)
    procs, servers, launches = [], [], collections.Counter()
    try:
        t0 = time.perf_counter()
        for i in range(2):
            procs.append(start_pool_node(secret, os.path.join(work.name, f"node{i}.log"),
                                         cert, key))
        ports = [wait_pool_node(*node) for node in procs]
        nodes_s = time.perf_counter() - t0
        addrs = [f"127.0.0.1:{port}" for port in ports]
        n = len(tables)

        def create(pool: bool, where):
            cfg = dyn_cfg(root, n, "pool" if pool else "pool_cpu", 0, threshold=1.0,
                          dim=tables[0].vectors.shape[1])
            del cfg["update_source"]
            if pool:
                cfg["volatile_db"] = {
                    "type": "redis_cluster", "address": ",".join(addrs), "password": secret,
                    "enable_tls": True, "tls_ca_certificate": cert,
                    "tls_server_name_identification": "localhost",
                    "initial_cache_rate": DYN_DRAM_RATE}
            t0 = time.perf_counter()
            ps = HierParameterServer.create(cfg, device=where)
            servers.append(ps)
            cache = ps.get_embedding_cache("dlrm", 0)
            return (ps, cache, LookupSession.create(ps.get_model_params("dlrm"), cache),
                    time.perf_counter() - t0)

        ps, cache, session, create_s = create(True, None if on_card else "cpu")
        twin_ps, twin, twin_session, twin_s = create(False, "cpu")
        if not isinstance(ps.dram, ClusterKVTier):
            raise AssertionError(f"ps.dram is {type(ps.dram).__name__}, not the pool")
        tls = ssl.create_default_context(cafile=cert)
        per_node = []
        for a in addrs:
            one = ClusterKVTier([a], secret=secret, tls=tls, server_hostname="localhost")
            per_node.append(sum(one.size(table_tag("dlrm", f"sparse_embedding{t}"))
                                for t in range(n)))
            one.close()
        if min(per_node) == 0 or sum(per_node) != sum(
                twin_ps.dram.size(tg) for tg in twin_ps.dram.tables()):
            raise AssertionError(f"rows per node {per_node}: a node holds none, or the pool "
                                 "holds other rows than the local store")
        walls = []
        for i, keys in enumerate(dyn_batches(tables, batch, CLUSTER_BATCHES, SEED + 50)):
            kernels.launches.clear()
            t0 = time.perf_counter()
            got = session.lookup(keys)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            k1 = kernels.launches.get("gather_dequant", 0)
            launches.update(kernels.launches)
            if k1 != (1 if on_card else 0):
                raise AssertionError(f"pool batch {i}: K1 launched {k1} times")
            check_twin(cache, twin, got, twin_session.lookup(keys), f"pool batch {i}")
        # The pool's query and insert beside the local store's, for the same
        # keys: the largest table's keys of one batch, half of them in DRAM.
        t = max(range(n), key=lambda i: tables[i].num_rows)
        tag = table_tag("dlrm", f"sparse_embedding{t}")
        keys = dyn_batches(tables, batch, 1, SEED + 51)[0][t]
        (pv, pf), (lv, lf) = ps.dram.query(tag, keys), twin_ps.dram.query(tag, keys)
        if not (np.array_equal(pf, lf) and same_bits_np(pv[pf], lv[lf])):
            raise AssertionError("the pool's query differs from the local store's")
        ukeys = np.unique(keys)  # inserts: each key once
        rows = tables[t].vectors[: ukeys.size]
        for tier in (ps.dram, twin_ps.dram):
            tier.create_table("pool_probe", rows.shape[1])
        timing = {"keys": int(keys.size), "found": int(pf.sum()),
                  "pool_query_ms": median_ms(lambda: ps.dram.query(tag, keys)),
                  "local_query_ms": median_ms(lambda: twin_ps.dram.query(tag, keys)),
                  "insert_keys": int(ukeys.size),
                  "pool_insert_ms": median_ms(lambda: ps.dram.insert("pool_probe", ukeys, rows)),
                  "local_insert_ms": median_ms(
                      lambda: twin_ps.dram.insert("pool_probe", ukeys, rows))}
        ps.dram.drop_table("pool_probe")
        # The shared secret alone, over plain TCP (an in-process node).
        node = ClusterNodeServer(secret=secret).start()
        try:
            plain = ClusterKVTier([f"127.0.0.1:{node.port}"], secret=secret)
            plain.insert("probe", ukeys, rows)
            qv, qf = plain.query("probe", ukeys)
            if not (qf.all() and same_bits_np(qv, rows)):
                raise AssertionError("the secret-only node does not return its rows")
            timing["plain_node_query_ms"] = median_ms(lambda: plain.query("probe", ukeys))
            plain.close()
        finally:
            node.stop()
        res = {"nodes": len(addrs), "node_start_s": nodes_s, "rows_per_node": per_node,
               "create_s": create_s, "cpu_instance_create_s": twin_s,
               "batches": CLUSTER_BATCHES, "lookup_ms": walls, "k1_per_lookup":
               1 if on_card else 0, "tier": timing, "tls": True, "secret": True}
        emit_line({"cluster": "pool", **res})
    finally:
        for ps_ in servers:
            ps_.shutdown()
        for proc, _, _ in procs:
            proc.kill()
            proc.wait(timeout=10)
        work.cleanup()
    return {**res, "launches": dict(launches)}


# ------------------------------------------------------------- the sharded phase


def one_key_space(tables):
    """The tables as one: table t's key k becomes ENS_KEY_STRIDE * t + k.
    -> (keys, vectors, offsets)."""
    offsets = np.arange(len(tables), dtype=np.int64) * ENS_KEY_STRIDE
    keys = np.concatenate([off + tb.keys for off, tb in zip(offsets, tables)])
    return keys, np.concatenate([tb.vectors for tb in tables]), offsets


def one_space_keys(keys_per_table, offsets):
    """A batch's per-table keys in the one key space, table-major; an absent
    (negative) key stays absent."""
    return np.concatenate([np.where(k.reshape(-1) >= 0, k.reshape(-1) + off, k.reshape(-1))
                           for k, off in zip(keys_per_table, offsets)])


def sharded_host_dequant(st, slots) -> np.ndarray:
    """Rows of ``slots`` from a sharded table's stored bytes, dequantized in
    numpy: slot s is row s // P of shard s % P."""
    p = st.n_shards
    out = np.empty((len(slots), st.dim), np.float32)
    for k, (v, sc) in enumerate(zip(st.values, st.scales)):
        m = slots % p == k
        r = slots[m] // p
        out[m] = v.cpu().numpy()[r].astype(np.float32) * sc.cpu().numpy()[r][:, None]
    return out


def k1_sharded_measure(args, n_real: int, uniq: int, out_rows: int, bw) -> dict:
    """K1 at a sharded lookup's recorded groups (one launch over every
    (table, shard) group of the device): bit-exact against its plain version;
    times beside the groups' ``index_select`` calls chained in one CUDA graph;
    the bound over the UNIQUE REAL slots (each such row and its scale read
    once, each of the ``n_real`` request slots read once, ``out_rows`` f32
    rows written once) and, beside it, the pad: rows gathered past the unique
    real ones (the all_to_all buckets' padding, psum's masked gathers, the
    pow2 pads of the request)."""
    from hugectr_backend_tpu_torch.ops.dequant_gather import (
        gather_dequant_groups,
        gather_dequant_groups_ref,
    )

    vals, dsc, slots_cat, _, _, sb, _ = args
    got = gather_dequant_groups(*args)
    want = gather_dequant_groups_ref(*args)
    torch.cuda.synchronize()
    for gi, (x, y) in enumerate(zip(got, want)):
        if not torch.equal(x, y):
            raise AssertionError(f"sharded K1, group {gi}: kernel != plain")
    v0 = vals[0]
    d = v0.shape[1] * (2 if v0.dtype == torch.uint8 else 1)
    nbytes = (uniq * (v0.shape[1] * v0.element_size() + (4 if dsc[0] is not None else 0))
              + n_real * 4 + out_rows * d * 4)
    idx = [(v, slots_cat[a:b].long()) for v, (a, b) in zip(vals, sb)]
    # A graph holds every call's output: at most ~2 GB of them (psum at P 8
    # gathers 8 x the request).
    per_graph = max(1, min(20, int(2e9 // (slots_cat.shape[0] * d * 4))))

    def kernel():
        return gather_dequant_groups(*args)

    def plain():
        return gather_dequant_groups_ref(*args)

    def library():
        return [torch.index_select(v, 0, i) for v, i in idx]

    return {
        "shape": {"groups": len(vals), "gathered_rows": int(slots_cat.shape[0]),
                  "real_slots": n_real, "unique_real_slots": uniq,
                  "pad_rows": int(slots_cat.shape[0]) - uniq, "d": d,
                  "dtype": str(v0.dtype).replace("torch.", "")},
        "max_abs_err": 0.0,
        "kernel_ms": device_ms(kernel, per_graph), "plain_ms": device_ms(plain, per_graph),
        "library_ms": device_ms(library, per_graph), "eager_ms": eager_ms(kernel, 20, 3),
        "per_graph": per_graph,
        "bound_ms": nbytes / bw * 1e3,
        "bound_by": "bytes",
    }


def counted(call, want: dict, what: str):
    """``call()`` with the launch counts at 0 just before and read just
    after; they must be ``want``, and no plain version of K1 may see a CUDA
    tensor. -> (result, launches)."""
    from hugectr_backend_tpu_torch.ops import kernels

    kernels.launches.clear()
    with NoFallback():
        res = call()
        torch.cuda.synchronize()
    got = dict(kernels.launches)
    if got != want:
        raise AssertionError(f"sharded {what}: launches {got}, expected {want}")
    return res, got


def sharded_phase(dev, tables, cfg, cache, batches, bw=None, emit_line=emit,
                  batch: int = BATCH, lookup_p=SHARD_LOOKUP_P) -> dict:
    """Sharded tables on the card (``parallel/``), every shard on ``dev``:
    P shards of one card exchange rows by copies within it, so no
    interconnect is measured. ``tables``, ``cfg``, ``cache`` and ``batches``
    are phase 3's deployment (the sparse files of ``cfg`` are served again).

    1. The 26 tables as one (1,855,979 rows, one key space) in a
       ``ShardedTable`` at each P of ``lookup_p``: both strategies on the
       first batch (~1 % absent keys), bit-exact against the host dequant of
       the shards' bytes and against the unsharded ``EmbeddingCache`` of
       phase 3; exactly one K1 launch per lookup. The host plan's time; the
       lookup's wall, device time and idle share; K1 beside its bound.
    2. BASELINE config 3: DCN-v2 at the JAX defaults through
       ``make_sharded_dcn_server`` at P = SHARD_P, both strategies: logits
       bit-identical to the unsharded ``make_dcn_server`` on the same card,
       rel < ZOO_REL against the port on the CPU; one K1 launch per predict;
       walls, device times and idle shares of all three; the plan per table.
    3. ps.json: phase 3's model and a ``shard_tables`` copy of it
       (deployed_device_list [0, 1], ``device=dev``) served over HTTP: 64-sample
       binary requests answered byte for byte alike, one K1 launch per
       request; then new rows for table 0, ``refresh``, and the new rows
       served.
    4. The ensemble phase's repository with its HPS model sharded (P =
       SHARD_P), f32 and w8a8 dense models: fused = staged bit for bit; K1
       once per fused infer, K5 once a layer for w8a8.
    5. A mesh over a process group (NCCL at world size 1 on the card, gloo
       on the CPU) with SHARD_PG_LOCAL local shards: both lookups bit-identical
       to the single-process mesh's; ``dryrun_multichip(8, device=dev)``
       without and with the group.

    -> {"launches": ..., "lines": [...], "k1": the DCN predict's K1 line}."""
    import copy
    import dataclasses

    import torch.distributed as dist

    import hugectr_backend_tpu_torch.parallel.sharded_table as shtab
    from hugectr_backend_tpu_torch.entry import dryrun_multichip
    from hugectr_backend_tpu_torch.models import DCNv2
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.ops.quantize import quantize_rows_int8
    from hugectr_backend_tpu_torch.parallel.fused_sharded import make_sharded_dcn_server
    from hugectr_backend_tpu_torch.parallel.mesh import make_mesh
    from hugectr_backend_tpu_torch.parallel.sharded_cache import ShardedEmbeddingCache
    from hugectr_backend_tpu_torch.parallel.sharded_table import (
        STRATEGIES,
        ShardedTable,
        route,
        sharded_lookup,
    )
    from hugectr_backend_tpu_torch.serving import program
    from hugectr_backend_tpu_torch.serving.server import serve

    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    k1_once = {"gather_dequant": 1} if on_card else {}
    lines, launches = [], collections.Counter()
    n = len(tables)
    where = str(dev) if on_card else "cpu"

    def out(line):
        lines.append(line)
        emit_line(line)

    def measure_k1(call, n_real, uniq, out_rows):
        if bw is None or not on_card:
            return None
        with Recorder((shtab, "gather_dequant_groups")) as rec:
            call()
        (args,) = rec.calls["gather_dequant_groups"]
        return k1_sharded_measure(args, n_real, uniq, out_rows, bw)

    # Part 1: the one-table lookups at each P.
    keys_all, vecs_all, offsets = one_key_space(tables)
    lookup_keys = one_space_keys(batches[0][0], offsets)
    with torch.inference_mode():
        unsharded = torch.cat(cache.lookup([k.reshape(-1) for k in batches[0][0]])).cpu().numpy()
    for p in lookup_p:
        t0 = time.perf_counter()
        st = ShardedTable.from_numpy(keys_all, vecs_all, make_mesh(table=p, devices=[dev] * p))
        build_s = time.perf_counter() - t0
        slots = st.slots_for(lookup_keys)
        host = sharded_host_dequant(st, slots)
        if not same_bits_np(host, unsharded):
            raise AssertionError(f"P={p}: the shards' bytes != the unsharded cache's rows")
        uniq = int(np.unique(slots).size)
        for strategy in STRATEGIES:
            got, n_l = counted(lambda: sharded_lookup(st, slots, strategy), k1_once,
                               f"lookup P={p} {strategy}")
            launches.update(n_l)
            if not same_bits_np(got.cpu().numpy(), host):
                raise AssertionError(f"P={p} {strategy}: lookup != host dequant")
            plan_ms = median_ms(lambda: route(st, slots, strategy))
            k1 = measure_k1(lambda: sharded_lookup(st, slots, strategy), len(slots), uniq,
                            uniq if strategy == "all_to_all" else len(slots))
            out({"sharded": "lookup", "shards": p, "strategy": strategy,
                 "rows": int(st.capacity), "keys": len(slots), "unique_slots": uniq,
                 "mb_per_shard": st.nbytes_per_shard() / 1e6, "build_s": build_s,
                 "host_plan_ms": plan_ms, "bit_exact_vs": ["host dequant", "unsharded cache"],
                 "launches": n_l, "lookup": zoo_timing(
                     lambda: sharded_lookup(st, slots, strategy), n=SHARD_TIMED),
                 **({"k1": k1} if k1 else {})})
        del st
        torch.cuda.empty_cache()

    # Part 2: DCN-v2 (BASELINE config 3) at P = SHARD_P.
    t0 = time.perf_counter()
    mesh = make_mesh(table=SHARD_P, devices=[dev] * SHARD_P)
    st26 = [ShardedTable.from_numpy(tb.keys, tb.vectors, mesh) for tb in tables]
    cpu26 = [ShardedTable.from_numpy(tb.keys, tb.vectors,
                                     make_mesh(table=SHARD_P, devices=[cpu] * SHARD_P))
             for tb in tables]
    build_s = time.perf_counter() - t0
    card_m, ref_m = zoo_pair(lambda: DCNv2(NUM_DENSE, n, DIM), SEED + 50)
    name = cfg["models"][0]["model"]
    plain = program.make_dcn_server(cache.params, cache, copy.deepcopy(card_m))
    servers = {s: make_sharded_dcn_server(mesh, st26, [1] * n, card_m, strategy=s)
               for s in STRATEGIES}
    ref_srv = make_sharded_dcn_server(cpu26[0].mesh, cpu26, [1] * n, ref_m)
    keys, dense = batches[0]
    rel = check_rel("sharded dcn", rel_err(
        servers["all_to_all"].predict(keys, dense)[:ZOO_REF],
        ref_srv.predict([k[:ZOO_REF] for k in keys], dense[:ZOO_REF])))
    dcn_k1 = None
    for s, srv in servers.items():
        got, n_l = counted(lambda: [srv.predict(*b) for b in batches],
                           {k: v * len(batches) for k, v in k1_once.items()}, f"dcn {s}")
        launches.update(n_l)
        if not all(torch.equal(g, plain.predict(*b)) for g, b in zip(got, batches)):
            raise AssertionError(f"sharded DCN-v2 {s}: logits != the unsharded server's")
        slots = [t.slots_for(k.reshape(-1)) for t, k in zip(st26, keys)]
        plan = [median_ms(lambda: route(t, sl, s)) for t, sl in zip(st26, slots)]
        uniq = sum(int(np.unique(sl).size) for sl in slots)
        k1 = measure_k1(lambda: srv.predict(keys, dense), n * batch, uniq,
                        uniq if s == "all_to_all" else n * batch)
        if s == "all_to_all":
            dcn_k1 = k1
        out({"sharded": "dcn_v2", "shards": SHARD_P, "strategy": s, "batch": batch,
             "tables": n, "build_s": build_s, "bit_identical_to_unsharded": True,
             "rel_vs_cpu": rel, "k1_per_predict": 1 if on_card else 0,
             "host_plan_ms": {"total": sum(plan), "per_table": plan},
             **zoo_timing(lambda: srv.predict(*batches[1]), n=SHARD_TIMED),
             **({"k1": k1} if k1 else {})})
    out({"sharded": "dcn_v2", "shards": 0, "strategy": "unsharded make_dcn_server",
         "batch": batch, **zoo_timing(lambda: plain.predict(*batches[1]), n=SHARD_TIMED)})
    del st26, cpu26, servers, plain, ref_srv
    torch.cuda.empty_cache()

    # Part 3: ps.json shard_tables served over HTTP beside the unsharded model.
    scfg = json.loads(json.dumps(cfg))
    base = scfg["models"][0]
    base["max_batch_size"] = FRONTEND_MAX_BATCH
    scfg["models"].append({**base, "model": "sharded", "shard_tables": True,
                           "deployed_device_list": list(range(SHARD_P))})
    t0 = time.perf_counter()
    server = serve(scfg, port=0, block=False, grpc_port=None, device=where)
    deploy_s = time.perf_counter() - t0
    try:
        ps = server.manager.ps
        scache = ps.get_embedding_cache("sharded", 0)
        if not isinstance(scache, ShardedEmbeddingCache) or scache.device != dev:
            raise AssertionError(f"sharded model served by {type(scache).__name__} on "
                                 f"{scache.device}")

        def infer(model, keys, num):
            return _http(server.port, "POST", f"/v2/models/{model}/infer",
                         *_binary_infer(keys, num))

        reqs = frontend_requests(tables, SHARD_HTTP_REQUESTS, FRONTEND_SAMPLES, SEED + 52)
        plain_out = [_binary_output(infer(name, k, m)) for k, m in reqs]
        got, n_l = counted(lambda: [_binary_output(infer("sharded", k, m)) for k, m in reqs],
                           {k: v * len(reqs) for k, v in k1_once.items()}, "HTTP")
        launches.update(n_l)
        for g, w in zip(got, plain_out):
            if g.tobytes() != w.tobytes():
                raise AssertionError("sharded HTTP response != the unsharded model's")
        # New rows for table 0, refresh, served.
        upd = tables[0].keys[:SHARD_UPDATE_KEYS]
        new = np.random.default_rng(SEED + 53).standard_normal((len(upd), DIM)).astype(np.float32)
        ps.apply_updates("sharded", 0, upd, new)
        t0 = time.perf_counter()
        refreshed = ps.refresh_embedding_cache("sharded", 0)
        refresh_s = time.perf_counter() - t0
        k, m = reqs[0]
        k = k.copy()
        k[:FRONTEND_SAMPLES] = upd[:FRONTEND_SAMPLES]
        after = _binary_output(infer("sharded", k, m)).reshape(-1, DIM)
        q, sc = quantize_rows_int8(new[:FRONTEND_SAMPLES])
        if not same_bits_np(after[:FRONTEND_SAMPLES], q.astype(np.float32) * sc[:, None]):
            raise AssertionError("sharded refresh: the new rows are not served")
        rest = _binary_output(infer(name, k, m)).reshape(-1, DIM)[FRONTEND_SAMPLES:]
        if not same_bits_np(after[FRONTEND_SAMPLES:], rest):
            raise AssertionError("sharded refresh: the other tables' rows changed")
        out({"sharded": "ps_json_http", "shards": SHARD_P, "strategy": scache.strategy,
             "requests": len(reqs), "samples_per_request": FRONTEND_SAMPLES,
             "byte_identical_to_unsharded": True, "launches": n_l, "deploy_s": deploy_s,
             "refreshed_rows": refreshed, "refresh_s": refresh_s,
             "updated_keys_served": FRONTEND_SAMPLES})
    finally:
        server.stop()

    # Part 4: the ensemble repository with its HPS model sharded.
    work = tempfile.TemporaryDirectory(prefix="hps_chip_smoke_shens_")
    server = None
    try:
        offsets_e, _ = ensemble_repository(work.name, tables, SEED + 40, batch,
                                           formats=SHARD_ENS_FORMATS, shards=SHARD_P)
        t0 = time.perf_counter()
        server = serve(model_repository=work.name, port=0, block=False, grpc_port=None,
                       device=where)
        deploy_s = time.perf_counter() - t0
        ensembles = server.httpd.RequestHandlerClass.ensembles
        big = ensemble_requests(tables, offsets_e, batch, 2, SEED + 54)
        for fmt in SHARD_ENS_FORMATS:
            es = ensembles[f"ens_{fmt}"]
            want_l = dict(k1_once)
            if on_card and fmt == "w8a8":
                want_l["w8a8_dense"] = len(TOP)
            fused, n_l = counted(lambda: es.infer(_ens_inputs(big[0]))[ENS_TENSORS[2]],
                                 want_l, f"ensemble {fmt} fused")
            launches.update(n_l)
            if es._fused is None or not es._fused.sharded:
                raise AssertionError(f"sharded ensemble {fmt}: the fused path did not engage")
            staged, s_l = counted(lambda: es.infer_staged(_ens_inputs(big[0]))[ENS_TENSORS[2]],
                                  want_l, f"ensemble {fmt} staged")
            launches.update(s_l)
            if not same_bits_np(fused, staged.reshape(fused.shape)):
                raise AssertionError(f"sharded ensemble {fmt}: fused != staged")
            out({"sharded": "ensemble", "dense": fmt, "shards": SHARD_P, "batch": batch,
                 "keys": batch * n, "deploy_s": deploy_s, "fused_equals_staged": "bit for bit",
                 "fused_launches": n_l, "fused": zoo_timing(
                     lambda: es.infer(_ens_inputs(big[1])), n=SHARD_TIMED)})
    finally:
        if server is not None:
            server.stop()
        work.cleanup()

    # Part 5: the process-group mesh (world size 1) against the
    # single-process mesh, and the dry run without and with the group.
    t0 = time.perf_counter()
    kernels.launches.clear()
    dry = {"single_process": dryrun_multichip(8, device=dev)}
    torch.cuda.synchronize()
    dry_launches = dict(kernels.launches)
    st = ShardedTable.from_numpy(keys_all, vecs_all,
                                 make_mesh(table=SHARD_PG_LOCAL, devices=[dev] * SHARD_PG_LOCAL))
    slots = st.slots_for(lookup_keys)
    store = tempfile.TemporaryDirectory(prefix="hps_chip_smoke_pg_")
    backend = "nccl" if on_card else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(store.name, "s"), 1),
                            rank=0, world_size=1)
    try:
        pg = make_mesh(table=SHARD_PG_LOCAL, devices=[dev] * SHARD_PG_LOCAL,
                       group=dist.group.WORLD)
        stg = dataclasses.replace(st, mesh=pg)
        for strategy in STRATEGIES:
            want = sharded_lookup(st, slots, strategy).cpu().numpy()
            got, n_l = counted(lambda: sharded_lookup(stg, slots, strategy), k1_once,
                               f"process group {strategy}")
            launches.update(n_l)
            if not same_bits_np(got.cpu().numpy(), want):
                raise AssertionError(f"process-group mesh {strategy} != single-process mesh")
        kernels.launches.clear()
        dry["process_group"] = dryrun_multichip(8, device=dev)
        torch.cuda.synchronize()
        for k, v in kernels.launches.items():
            dry_launches[k] = dry_launches.get(k, 0) + v
    finally:
        dist.destroy_process_group()
        store.cleanup()
    out({"sharded": "process_group", "backend": backend, "world_size": 1,
         "local_shards": SHARD_PG_LOCAL, "bit_identical_to_single_process": True,
         "dryrun_multichip_8": dry, "dryrun_launches": dry_launches,
         "seconds": time.perf_counter() - t0})
    launches.update(dry_launches)
    del st
    torch.cuda.empty_cache()
    return {"launches": dict(launches), "lines": lines, "k1": dcn_k1}


# ------------------------------------------------------------ the examples phase


def ex_same(what: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype or got.tobytes() != want.tobytes():
        raise AssertionError(f"examples: {what}: the card's run differs from the CPU run's")


def ex_close(what: str, got, want, tol) -> float:
    """|got - want| <= rtol * |want| + atol * max(1, max|want|), elementwise.
    -> max |delta|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"examples: {what}: shape {got.shape} vs {want.shape}, or "
                             "non-finite values on the card")
    err = np.abs(got - want)
    if (err > tol[0] * np.abs(want) + tol[1] * max(1.0, float(np.abs(want).max()))).any():
        raise AssertionError(f"examples: {what}: max |delta| {err.max()} past rtol {tol[0]}, "
                             f"atol {tol[1]} x max(1, max|want|)")
    return float(err.max())


def ex_retrieval(got, want) -> dict:
    """Retrieval on the card against the CPU run: scores rel < EX_RETRIEVAL_REL,
    and the keys equal wherever a score stands apart from its neighbours
    (ties within the tolerance may come in another order). The k-th key is
    never compared: its right neighbour, the (k+1)-th score, is not
    returned, so a tie there cannot be seen."""
    s_got, s_want = np.asarray(got["scores"]), np.asarray(want["scores"])
    if s_got.shape != s_want.shape:
        raise AssertionError(f"examples: retrieval shapes {s_got.shape} vs {s_want.shape}")
    rel = float(np.abs(s_got - s_want).max() / np.abs(s_want).max())
    if rel >= EX_RETRIEVAL_REL:
        raise AssertionError(f"examples: retrieval scores rel {rel} (bar {EX_RETRIEVAL_REL})")
    gap = EX_RETRIEVAL_REL * float(np.abs(s_want).max())
    apart = np.abs(np.diff(s_want, axis=1)) > gap  # position j vs j + 1
    sep = np.ones_like(s_want, dtype=bool)
    sep[:, :-1] &= apart
    sep[:, 1:] &= apart
    sep[:, -1] = False  # its right neighbour (the k+1-th) is unknown
    bad = sep & (np.asarray(got["item_keys"]) != np.asarray(want["item_keys"]))
    if bad.any():
        raise AssertionError(f"examples: retrieval: {int(bad.sum())} separated positions "
                             "hold other keys on the card than on the CPU")
    return {"scores_rel": rel, "keys_compared": int(sep.sum()), "positions": int(sep.size)}


def ex_compare(name: str, got: dict, want: dict) -> dict:
    """One example's card run against its CPU run, at the CPU tests'
    tolerances. -> what was compared."""
    if name in ("01_deploy_and_lookup", "04_sharded_multichip"):
        ex_same(f"{name} keys", got["keys"], want["keys"])
        ex_same(f"{name} HTTP output", got["output"], want["output"])
        return {"output": "bit-identical"}
    if name == "02_fused_dlrm_serving":
        return {"logits_max_abs": ex_close("02 FusedDlrmServer logits", got["logits"],
                                           want["logits"], EX_LOGITS_TOL),
                "multi_logits_max_abs": ex_close("02 multi-table logits", got["multi_logits"],
                                                 want["multi_logits"], EX_LOGITS_TOL)}
    if name == "03_online_updates":
        ex_same("03 before", got["before"], want["before"])
        ex_same("03 after", got["after"], want["after"])
        return {"rows": "bit-identical"}
    if name == "05_triton_repo_ensemble":
        ex_same("05 torch MLP", got["torch_output"], want["torch_output"])
        return {"ensemble_max_abs": ex_close("05 ensemble", got["output"], want["output"],
                                             EX_ENSEMBLE_TOL)}
    if name == "06_capacity_tiering_int4":
        ex_same("06 int4 rows", got["output"], want["output"])
        ex_same("06 missing key", got["miss"], want["miss"])
        if got["hit_rate"] != want["hit_rate"]:
            raise AssertionError(f"examples: 06 hit rate {got['hit_rate']} on the card, "
                                 f"{want['hit_rate']} on the CPU")
        return {"output": "bit-identical", "hit_rate": got["hit_rate"]}
    if name == "07_model_zoo":
        if list(got) != list(want):
            raise AssertionError(f"examples: 07 families {list(got)} vs {list(want)}")
        return {fam: ex_close(f"07 {fam}", got[fam], want[fam], EX_LOGITS_TOL) for fam in got}
    if name == "08_kafka_groups_compression":
        if got["total"] != want["total"] or got["rows"].keys() != want["rows"].keys():
            raise AssertionError("examples: 08 consumed other rows in the two runs")
        for k, v in want["rows"].items():
            ex_same(f"08 row {k}", got["rows"][k], v)
        return {"rows": got["total"], "lz4_decoder": got["lz4_decoder"]}
    if name == "09_retrieval_topk":
        return ex_retrieval(got, want)
    raise KeyError(name)


def ex_expected_launches(name: str, out: dict) -> dict:
    """The kernel launches one run of example ``name`` must count on the
    card: K1 once per lookup, predict, request or retrieve; K4 in 02's
    single-table server; the interaction 02's multi-table plan picks. Keys
    with a tuple count the sum of those kernels."""
    k1 = {"01_deploy_and_lookup": 1, "02_fused_dlrm_serving": 2,
          "03_online_updates": out.get("lookups"), "04_sharded_multichip": 1,
          "05_triton_repo_ensemble": 1, "06_capacity_tiering_int4": 2, "07_model_zoo": 7,
          "08_kafka_groups_compression": 0, "09_retrieval_topk": 1}[name]
    want = {"gather_dequant": k1} if k1 else {}
    if name == "02_fused_dlrm_serving":
        want["fused_dot_interaction"] = 1
        want[("dot_interaction_parts", "dot_interaction_oh_parts")] = 1
    return want


def ex_check_launches(name: str, got: dict, want: dict, dev) -> None:
    if dev.type != "cuda":
        if any(got.values()):
            raise AssertionError(f"examples: {name} launched {got} on the CPU")
        return
    seen = set()
    for key, n in want.items():
        names = key if isinstance(key, tuple) else (key,)
        seen.update(names)
        if sum(got.get(k, 0) for k in names) != n:
            raise AssertionError(f"examples: {name} launched {got}; expected {want}")
    extra = {k: v for k, v in got.items() if v and k not in seen}
    if extra:
        raise AssertionError(f"examples: {name} launched other kernels too: {extra}")


def perf_client_leg(device, seconds: float, emit_line=emit) -> dict:
    """``tools.perf_client`` (a process of its own, 8 clients, 64-sample
    binary requests of 26 keys, one table) for ``seconds`` against a fresh
    server on ``device``: one PERF_CLIENT_ROWS x DIM int8 table whose keys
    are 0..rows-1, so that the tool's uniform keys all hit (see
    PERF_CLIENT_ROWS for why one table). -> its report, with the K1
    launches of the window."""
    from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
    from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.serving.server import serve

    with tempfile.TemporaryDirectory(prefix="hps_chip_smoke_perf_") as root:
        tbl = make_synthetic_table(PERF_CLIENT_ROWS, DIM, seed=SEED + 61,
                                   key_space=PERF_CLIENT_ROWS)
        write_sparse_model(os.path.join(root, "t0"), tbl.keys, tbl.vectors)
        cfg = {"models": [{"model": "dlrm", "sparse_files": [os.path.join(root, "t0")],
                           "embedding_vecsize_per_table": [DIM],
                           "maxnum_catfeature_query_per_table_per_sample": [26],
                           "max_batch_size": FRONTEND_MAX_BATCH, "gpucacheper": 1.0,
                           "embedding_cache_type": "static", "deployed_device_list": [0]}]}
        server = serve(cfg, port=0, block=False, grpc_port=None, device=device)
        try:
            args = [sys.executable, "-m", "hugectr_backend_tpu_torch.tools.perf_client",
                    "--url", f"http://127.0.0.1:{server.port}", "--model", "dlrm",
                    "--batch", str(FRONTEND_SAMPLES), "--keys-per-sample", "26",
                    "--key-range", str(PERF_CLIENT_ROWS),
                    "--concurrency", str(FRONTEND_CLIENTS), "--binary"]
            here = os.path.dirname(os.path.abspath(__file__))
            subprocess.run(args + ["--duration", "1"], cwd=here, check=True,
                           capture_output=True, timeout=120)  # warm-up
            kernels.launches.clear()
            r = subprocess.run(args + ["--duration", str(seconds)], cwd=here, check=True,
                               capture_output=True, text=True, timeout=120 + seconds)
            k1 = kernels.launches.get("gather_dequant", 0)
        finally:
            server.stop()
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    if rep["requests_err"] or not rep["requests_ok"]:
        raise AssertionError(f"perf_client: {rep}")
    # One K1 launch per merged batch: at most one a request (and one for
    # each warm-up request still in flight when the window opened).
    if (torch.device(device or "cuda").type == "cuda"
            and not 1 <= k1 <= rep["requests_ok"] + FRONTEND_CLIENTS):
        raise AssertionError(f"perf_client: {k1} K1 launches for {rep['requests_ok']} requests")
    rep["k1_launches"] = k1
    emit_line({"perf_client": rep, "rows": PERF_CLIENT_ROWS})
    return rep


def examples_phase(dev, fe=None, emit_line=emit, names=None, smoke: bool = False) -> dict:
    """The entry points around the package (the "examples" phase):
    (1) ``entry.entry()`` on ``dev`` against ``entry(device="cpu")`` (the
    same weights): K1 and K4 once a call; (2) every example's ``main()`` on
    ``dev``, its launches counted (``ex_expected_launches``) and its
    outputs held against the same example run with ``device="cpu"`` in this
    process (``ex_compare``); (3) ``tools.perf_client`` for PERF_CLIENT_S
    against a fresh server; (4) ``scripts.frontend_saturation`` at its full
    configuration, each leg at its full concurrency (the device stubbed),
    beside the frontend phase's ``fe``; (5) ``scripts.auc_parity`` in smoke
    mode, every gate held. ``names`` limits (2) and ``smoke`` runs (3)-(4)
    small (the CPU rehearsal). -> {"launches", "lines"}."""
    import hugectr_backend_tpu_torch.cache.lookup_program as lp
    from hugectr_backend_tpu_torch import examples
    from hugectr_backend_tpu_torch.entry import entry
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.scripts import auc_parity
    from hugectr_backend_tpu_torch.scripts import frontend_saturation as fsat

    device = None if dev.type == "cuda" else "cpu"
    launches = collections.Counter()
    lines = []

    def out(line):
        lines.append(line)
        emit_line(line)

    def counted(call):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        kernels.launches.clear()
        t0 = time.perf_counter()
        res = call()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in kernels.launches.items() if v}
        launches.update(got)
        return res, got, wall

    # (1) entry().
    fn, args = entry(device)
    logits, got, wall = counted(lambda: fn(*args))
    ex_check_launches("entry", got, {"gather_dequant": 1, "fused_dot_interaction": 1}, dev)
    fn_c, args_c = entry("cpu")
    err = ex_close("entry logits", logits.cpu().numpy(), fn_c(*args_c).numpy(), EX_LOGITS_TOL)
    out({"example": "entry", "launches": got, "wall_s": wall, "vs_cpu_max_abs": err})
    del fn, args, logits

    # (2) The nine examples, each on the card, then on the CPU. What they
    # print is kept out of this run's output (the lines below carry it).
    quiet = contextlib.redirect_stdout(io.StringIO())
    for name in names or examples.NAMES:
        mod = examples.load(name)
        with tempfile.TemporaryDirectory(prefix="hps_chip_smoke_ex_") as root:
            with Recorder((lp, "gather_dequant_groups")) as rec, quiet:
                res, got, wall = counted(lambda: mod.main(device=device, root=root))
        ex_check_launches(name, got, ex_expected_launches(name, res), dev)
        if name == "06_capacity_tiering_int4" and dev.type == "cuda" and not any(
                v.dtype == torch.uint8 for call in rec.calls["gather_dequant_groups"]
                for v in call[0]):
            raise AssertionError("examples: 06 never gave K1 an int4 table")
        with tempfile.TemporaryDirectory(prefix="hps_chip_smoke_ex_cpu_") as root:
            t0 = time.perf_counter()
            with quiet:
                ref = mod.main(device="cpu", root=root)
            cpu_wall = time.perf_counter() - t0
        out({"example": name, "launches": got, "wall_s": wall, "cpu_wall_s": cpu_wall,
             "vs_cpu": ex_compare(name, res, ref)})

    # (3) perf_client against a fresh server.
    rep = perf_client_leg(device, 1.0 if smoke else PERF_CLIENT_S, emit_line)
    launches["gather_dequant"] += rep["k1_launches"]
    fe_txt = ("" if fe is None else
              f"; the frontend phase's own clients (26 tables): {fe['qps']:.1f} requests/s, "
              f"p50 {fe['p50_ms']:.2f} ms, p99 {fe['p99_ms']:.2f} ms")
    print(f"examples: perf_client (one {PERF_CLIENT_ROWS} x {DIM} table, 26 keys a sample, "
          f"{FRONTEND_CLIENTS} clients, 64-sample binary requests): {rep['qps']} requests/s, "
          f"p50 {rep['latency_ms']['p50']} ms, p99 {rep['latency_ms']['p99']} ms, "
          f"{rep['k1_launches']} K1 launches for {rep['requests_ok']} requests"
          + (fe_txt and " [NOT the same deployment: the same keys and response bytes a "
             "request, but one table with uniform keys, all present, against 26 tables "
             "with Zipf keys and ~1 % absent]" + fe_txt), flush=True)

    # (4) frontend_saturation: the device stubbed out (no launch can count).
    kernels.launches.clear()
    with quiet:
        sat = fsat.run(device, smoke=smoke, conc_scan=[fsat.concurrency(smoke)])
    if any(kernels.launches.values()):
        raise AssertionError(f"frontend_saturation launched {dict(kernels.launches)}")
    legs = [leg for leg, _, _ in fsat.LEGS]
    for leg in legs:
        if not sat[leg]["samples_per_s"] > 0:
            raise AssertionError(f"frontend_saturation {leg}: {sat[leg]}")
    out({"frontend_saturation": sat, "beside_frontend_phase": fe and {
        k: fe[k] for k in ("qps", "p50_ms", "p99_ms", "mean_merged_batch")}})
    print("examples: frontend_saturation (DEVICE STUBBED: front-end software only; server "
          f"booted on {sat['server_device']}, {sat['concurrency']} clients in this process): "
          + "; ".join(f"{leg} {sat[leg]['requests_per_s']:.1f} requests/s, "
                      f"{sat[leg]['samples_per_s']:.0f} samples/s, "
                      f"{sat[leg]['merged_batches_per_s']:.1f} merged batches/s"
                      + (f", p50 {sat[leg]['p50_ms']:.2f} ms" if "p50_ms" in sat[leg] else "")
                      for leg in legs) + fe_txt, flush=True)

    # (5) auc_parity, smoke mode.
    with quiet:
        res, got, wall = counted(lambda: auc_parity.run(device, smoke=True))
    if not all(res["gates"].values()) or not all(res["path_parity"]["oh_kernel_engaged"]):
        raise AssertionError(f"auc_parity: gates {res['gates']}, one-hot fold engaged "
                             f"{res['path_parity']['oh_kernel_engaged']}")
    if dev.type == "cuda":
        for k in ("gather_dequant", "fused_dot_interaction", "dot_interaction_bwd",
                  "dot_interaction_oh_parts", "dot_interaction_parts", "w8a8_dense"):
            if not got.get(k):
                raise AssertionError(f"auc_parity never launched {k}: {got}")
    out({"auc_parity_smoke": {"max_abs_delta": res["max_abs_delta"], "gates": res["gates"],
                              "path_max_abs_delta": res["path_parity"]["max_abs_delta"]},
         "launches": got, "wall_s": wall})
    return {"launches": dict(launches), "lines": lines}


BENCH_HTTP_S = 5.0  # the benchmark's HTTP windows inside chip_smoke (10 run alone)
BENCH_STORM_S = 5.0  # microbench_update_storm's window
#: What the benchmark programs must launch (the fused variants, DIN and the
#: lookups: K1; the fold and the two-stage path: K3, K2; w8a8: K5;
#: microbench_interaction and _dense: K4).
BENCH_KERNELS = ("gather_dequant", "dot_interaction_oh_parts", "dot_interaction_parts",
                 "fused_dot_interaction", "w8a8_dense")


def bench_phase(dev, emit_line=emit) -> dict:
    """The JAX package's benchmark programs, ported (``bench``, the seven
    ``scripts/microbench_*``), and ``microbench_zoo_dtypes`` (each variant
    of both models and of every product timed), each at its card sizes and
    checking itself:
    the headline lookup's first rows bit-exact against the closed form at
    batch 4096 and 1024 with one K1 launch an iteration; the six fused
    variants (fold vs two-stage rel < 5e-3; each variant's first 64 logits
    against the same model on the CPU within ``bench.VARIANT_TOL``; K3 once
    per fold forward, K2 once per two-stage forward, K5 8 times per w8a8
    forward); the DIN pool against the host's; the HTTP stages at
    ``BENCH_HTTP_S``; each microbenchmark's own correctness step. -> its
    result lines, the launches, the peak memory and the seconds."""
    from hugectr_backend_tpu_torch import bench
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.scripts import (
        microbench_dense,
        microbench_int4_gather,
        microbench_interaction,
        microbench_overhead,
        microbench_scaling,
        microbench_update_storm,
        microbench_w8a8_kernel,
        microbench_zoo_dtypes,
    )

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.empty(1, device=dev)  # the allocator's stats exist once it has allocated
    torch.cuda.reset_peak_memory_stats(dev)
    before = dict(kernels.launches)
    lines = {"bench": bench.run(dev, seconds=BENCH_HTTP_S, emit=emit_line)}
    print(f"bench: {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB allocated", flush=True)
    for mod, kw in ((microbench_w8a8_kernel, {}), (microbench_dense, {}),
                    (microbench_interaction, {}), (microbench_int4_gather, {}),
                    (microbench_overhead, {}), (microbench_update_storm,
                                                {"seconds": BENCH_STORM_S}),
                    (microbench_scaling, {}), (microbench_zoo_dtypes, {})):
        t1 = time.perf_counter()
        lines[mod.__name__.rsplit(".", 1)[1]] = mod.run(dev, emit=emit_line, **kw)
        torch.cuda.synchronize(dev)
        print(f"{mod.__name__.rsplit('.', 1)[1]}: {time.perf_counter() - t1:.1f} s", flush=True)
    # The dtype microbenchmark times the repaired bf16 products beside the
    # forms before the repair: every variant of both models and products.
    zoo = lines["microbench_zoo_dtypes"]
    for model in ("dcn_v2", "bst"):
        variants = [ln["variant"] for ln in zoo if ln["model"] == model and "variant" in ln]
        if variants != [v[0] for v in microbench_zoo_dtypes.VARIANTS]:
            raise AssertionError(f"microbench_zoo_dtypes {model}: variants {variants}")
    if not all(ln.get(f"{v[0]}_us", 0) > 0 for ln in zoo if "product" in ln
               for v in microbench_zoo_dtypes.VARIANTS):
        raise AssertionError("microbench_zoo_dtypes: a product without a time")
    launches = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v - before.get(k, 0)}
    for name in BENCH_KERNELS:
        if launches.get(name, 0) < 1:
            raise AssertionError(f"the benchmark programs never launched {name}")
    return {"lines": lines, "launches": launches, "seconds": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def bench_alone() -> int:
    """The bench phase alone, on the card (build, the phase):
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.bench_alone())"``."""
    from hugectr_backend_tpu_torch.native import kvstore
    from hugectr_backend_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.build_all()
    kvstore.load_lib()
    res = bench_phase(dev)
    print(f"bench phase: launches {res['launches']} ({res['seconds']:.1f} s, peak "
          f"{res['peak_gb']:.3f} GB; {torch.cuda.get_device_name(0)})", flush=True)
    return 0


#: What the TPU-layout microbenchmarks must launch (the geometry, grouping,
#: full_ab and fold_ab lookups: K1; oh_fused and fold_ab: K3 and K2;
#: pallas_interaction and pallas_parts: K4; int8_onehot: K6 v1 and v2).
LAYOUT_KERNELS = ("gather_dequant", "dot_interaction_parts", "dot_interaction_oh_parts",
                  "fused_dot_interaction", "onehot_gather", "onehot_gather_rows")
#: The phase's rehearsal on the CPU (``smoke=True``): each script's
#: correctness step at a test's sizes.
_CAPPED = [min(c, 70_000) for c in CRITEO_CARDS]
LAYOUT_SMOKE = {
    "microbench_pallas_interaction": {"batch": 64, "n_sets": 1},
    "microbench_pallas_parts": {"batch": 64, "n_sets": 1, "bottom": (16, 16), "top": (32, 1)},
    "microbench_parts_fm": {"batch": 64, "n_sets": 1, "bottom": (16, 16), "top": (32, 1)},
    "microbench_oh_fused": {"batch": 64, "n_sets": 1, "dim": 16},
    "microbench_fold_ab": {"batch": 64, "n_sets": 1},
    "microbench_full_ab": {"cards": _CAPPED, "batch": 64, "n_sets": 1},
    "microbench_int8_onehot": {"batch": 64, "n_sets": 1, "m_tile": 64},
    "microbench_geometry": {"rows": (4096, 16_384), "slot_counts": (64, 256), "n_sets": 1},
    "microbench_overlap": {"batch": 64, "n_sets": 1,
                           "big_cards": [c for c in _CAPPED if c > 65_536]},
}


def microbench_layouts_phase(dev, emit_line=emit, smoke: bool = False) -> dict:
    """The nine TPU-layout microbenchmarks, ported, each at its card sizes
    with its own correctness step (``hugectr_backend_tpu_torch.scripts``):
    ``microbench_pallas_interaction`` (K4 at every launch plan, bit for bit
    the default's, the default within rtol 1e-5 / atol 1e-6 max|z|^2 of the
    plain formulation), ``_pallas_parts`` (the DLRM forward stacked + plain,
    stacked + K4, parts + K2: K4 == K2 bit for bit, the plain one within the
    interaction's bar and rel 5e-3 at the logits), ``_parts_fm`` (the
    part-major map with the permuted top layer within rtol 1e-4 / atol 1e-5
    of the interleaved one), ``_oh_fused`` (K1 + K2 against K3 within the
    interaction's bar), ``_fold_ab`` (the whole forward, fold against
    two-stage rel < 5e-3), ``_full_ab`` (int8 and bf16 one-hot members, bit
    for bit), ``_int8_onehot`` (every product, K1 and K6 bit for bit),
    ``_geometry`` and ``_overlap`` (K1 by table size, slot count, group kind
    and launch grouping, bit for bit). One build of the uncapped Criteo
    tables (4.32 GB) serves fold_ab, and its 8 solo tables full_ab and
    overlap. ``smoke``: each script at ``LAYOUT_SMOKE``'s sizes and the
    tables capped, the phase's rehearsal on the CPU. -> the result lines,
    the launches, the peak memory and the seconds."""
    from hugectr_backend_tpu_torch import bench
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.scripts import (
        microbench_fold_ab,
        microbench_full_ab,
        microbench_geometry,
        microbench_int8_onehot,
        microbench_oh_fused,
        microbench_overlap,
        microbench_pallas_interaction,
        microbench_pallas_parts,
        microbench_parts_fm,
    )

    t0 = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.empty(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before = dict(kernels.launches)
    tables = bench.CriteoTables(_CAPPED if smoke else CRITEO_CARDS, dev)
    big = dict(zip(tables.big_cards, tables.big_vals))
    lines = {}
    for mod, kw in ((microbench_pallas_interaction, {}), (microbench_pallas_parts, {}),
                    (microbench_parts_fm, {}), (microbench_oh_fused, {}),
                    (microbench_fold_ab, {"cards": tables.cards, "tables": tables}),
                    (microbench_full_ab, {"big": big}), (microbench_int8_onehot, {}),
                    (microbench_geometry, {}), (microbench_overlap, {"big": big})):
        t1 = time.perf_counter()
        name = mod.__name__.rsplit(".", 1)[1]
        lines[name] = mod.run(dev, emit=emit_line, **kw, **(LAYOUT_SMOKE[name] if smoke else {}))
        if cuda:
            torch.cuda.synchronize(dev)
        print(f"{name}: {time.perf_counter() - t1:.1f} s", flush=True)
    del tables, big
    launches = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v - before.get(k, 0)}
    if cuda:
        torch.cuda.empty_cache()
        plans = [ln for ln in lines["microbench_pallas_interaction"] if ln["leg"] == "K4 plan"]
        if not any(ln["default"] and ln.get("us", 0) > 0 for ln in plans):
            raise AssertionError("microbench_pallas_interaction: the default plan was not timed")
        for name in LAYOUT_KERNELS:
            if launches.get(name, 0) < 1:
                raise AssertionError(f"the TPU-layout microbenchmarks never launched {name}")
    return {"lines": lines, "launches": launches, "seconds": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None}


def microbench_layouts_alone() -> int:
    """The TPU-layout microbenchmarks' phase alone, on the card (build, the
    phase): ``python3 -c "import chip_smoke, sys;
    sys.exit(chip_smoke.microbench_layouts_alone())"``."""
    from hugectr_backend_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.build_all()
    res = microbench_layouts_phase(dev)
    print(f"microbench_layouts phase: launches {res['launches']} ({res['seconds']:.1f} s, "
          f"peak {res['peak_gb']:.3f} GB; {torch.cuda.get_device_name(0)})", flush=True)
    return 0


def examples_alone() -> int:
    """The examples phase alone, on the card (build, the phase):
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.examples_alone())"``."""
    from hugectr_backend_tpu_torch.native import kvstore
    from hugectr_backend_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    kernels.build_all()
    kvstore.load_lib()
    t0 = time.perf_counter()
    res = examples_phase(dev)
    print(f"examples: launches {res['launches']} ({time.perf_counter() - t0:.1f} s; {card})",
          flush=True)
    return 0


def sharded_alone() -> int:
    """The sharded phase alone, on the card (build, phase 3's deployment,
    the phase): ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.sharded_alone())"``."""
    from hugectr_backend_tpu_torch import HierParameterServer
    from hugectr_backend_tpu_torch.native import kvstore
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.scripts.common import peaks

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    bw = peaks(card)[0]
    kernels.build_all()
    kvstore.load_lib()
    with tempfile.TemporaryDirectory(prefix="hps_chip_smoke_") as root:
        cards = [min(c, ROW_CAP) for c in CRITEO_CARDS]
        tables, cfg = build_deployment(root, cards, DIM, SEED)
        ps = HierParameterServer.create(cfg)
        batches = make_batches(tables, BATCH, N_BATCHES, SEED + 1)
        t0 = time.perf_counter()
        res = sharded_phase(dev, tables, cfg, ps.get_embedding_cache("dlrm", 0), batches, bw)
        print(f"sharded: launches {res['launches']} ({time.perf_counter() - t0:.1f} s; "
              f"{card})", flush=True)
        ps.shutdown()
    return 0


def zoo_alone() -> int:
    """The zoo phase alone, on the card (build, phase 3's deployment, the
    phase, f32 and bf16): ``python3 -c "import chip_smoke, sys;
    sys.exit(chip_smoke.zoo_alone())"``."""
    from hugectr_backend_tpu_torch import HierParameterServer
    from hugectr_backend_tpu_torch.native import kvstore
    from hugectr_backend_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.build_all()
    kvstore.load_lib()
    with tempfile.TemporaryDirectory(prefix="hps_chip_smoke_") as root:
        cards = [min(c, ROW_CAP) for c in CRITEO_CARDS]
        tables, cfg = build_deployment(root, cards, DIM, SEED)
        ps = HierParameterServer.create(cfg)
        batches = make_batches(tables, BATCH, N_BATCHES, SEED + 1)
        t0 = time.perf_counter()
        res = zoo_phase(dev, ps, cfg, batches)
        print(f"zoo: launches {res['launches']} ({time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.get_device_name(0)})", flush=True)
        ps.shutdown()
    return 0


def repository_and_pool_phases() -> int:
    """The ensemble and cluster phases alone, on the card (build, the 26
    capped tables, both phases):
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.repository_and_pool_phases())"``."""
    from hugectr_backend_tpu_torch.native import kvstore
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.scripts.common import peaks

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    bw, _, int8_ops, _ = peaks(card)
    kernels.build_all()
    kvstore.load_lib()
    with tempfile.TemporaryDirectory(prefix="hps_chip_smoke_") as root:
        tables, _ = build_deployment(root, [min(c, ROW_CAP) for c in CRITEO_CARDS], DIM, SEED)
        for name, phase in (("ensemble", lambda: ensemble_phase(dev, tables, bw, int8_ops)),
                            ("cluster", lambda: cluster_phase(dev, root, tables))):
            t0 = time.perf_counter()
            res = phase()
            print(f"{name}: launches {res['launches']} ({time.perf_counter() - t0:.1f} s; "
                  f"{card})", flush=True)
    return 0


def run_counted(srv, batches):
    """The counted run of one model: N_BATCHES predicts with the fold, then
    N_BATCHES without, launch counts set to 0 just before and read just
    after. -> (fold logits, no-fold logits, launches, launches after the
    fold predicts)."""
    from hugectr_backend_tpu_torch.ops import kernels

    kernels.launches.clear()
    fold = [predict_sync(srv, *bt) for bt in batches]
    after_fold = dict(kernels.launches)
    os.environ["HPS_OH_IN_KERNEL"] = "0"
    no_fold = [predict_sync(srv, *bt) for bt in batches]
    del os.environ["HPS_OH_IN_KERNEL"]
    return fold, no_fold, dict(kernels.launches), after_fold


def fold_vs_k2(fold, no_fold) -> float:
    """Finite [B] logits on both paths; -> the worst relative difference."""
    worst = 0.0
    for a, c in zip(fold, no_fold):
        for z in (a, c):
            if z.shape != (BATCH,) or not bool(torch.isfinite(z).all()):
                raise AssertionError("logits are not finite [B]")
        worst = max(worst, float((a - c).abs().max() / (c.abs().max() + 1e-9)))
    if worst >= REL_LOGITS:
        raise AssertionError(f"fold vs K2 logits rel {worst} >= {REL_LOGITS}")
    return worst


# ---------------------------------------------------------------- training


def split(data, n_train: int):
    """-> (the first n_train samples as a dataset of the same kind, the held-out
    (keys_idx, dense, labels))."""
    train = type(data)(data.key_ids, data.keys_idx[:n_train], data.dense[:n_train],
                       data.labels[:n_train], data.base_rate)
    return train, (data.keys_idx[n_train:], data.dense[n_train:], data.labels[n_train:])


def train_counted(train_fn, data, dev, steps: int, batch: int, lr: float, seed: int):
    """One training run of the port with the launch counts set to 0 just
    before and read just after. K4 forward and backward must launch once per
    step, the loss stay finite and its last 10 steps average below its first
    10. -> (model, tables, losses, launches, seconds)."""
    from hugectr_backend_tpu_torch.ops import kernels

    kernels.launches.clear()
    t0 = time.perf_counter()
    model, tables, losses = train_fn(data, dim=DIM, steps=steps, batch=batch, lr=lr,
                                     seed=seed, bottom_widths=BOTTOM[:-1], top_widths=TOP,
                                     device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if dev.type == "cuda":
        for name in ("fused_dot_interaction", "dot_interaction_bwd"):
            if launches.get(name, 0) != steps:
                raise AssertionError(f"training: {launches.get(name, 0)} launches of {name} "
                                     f"in {steps} steps, expected one per step")
    if not np.isfinite(losses).all():
        raise AssertionError(f"training: loss not finite: {losses}")
    if not losses[-10:].mean() < losses[:10].mean():
        raise AssertionError(f"training: the loss did not fall ({losses[:10].mean()} -> "
                             f"{losses[-10:].mean()})")
    return model, tables, losses, launches, seconds


def grad_check(model, table: np.ndarray, offsets, data, batch: int, seed: int, dev):
    """One batch through the loss on the card (the whole table, as in
    training) and on the CPU (the port's plain versions; only the looked-up
    rows). Every parameter's gradient and the looked-up rows' must agree
    within GRAD_TOL * max|grad|. -> (worst relative difference, the
    interaction's inputs on the card, for timing)."""
    import copy

    import hugectr_backend_tpu_torch.models.dlrm as dl
    from hugectr_backend_tpu_torch.eval import dlrm_loss

    sel = np.random.default_rng(seed).integers(0, len(data.labels), batch)
    kidx = data.keys_idx[sel].astype(np.int64) + offsets
    uniq, inv = np.unique(kidx, return_inverse=True)
    dense, labels = torch.from_numpy(data.dense[sel]), torch.from_numpy(data.labels[sel])
    full = torch.from_numpy(table).to(dev).requires_grad_()
    seen = []
    real = dl.fused_dot_interaction
    dl.fused_dot_interaction = lambda b, e: seen.append((b.detach(), e.detach())) or real(b, e)
    try:
        loss = dlrm_loss(model, full, torch.from_numpy(kidx).to(dev), dense.to(dev),
                         labels.to(dev))
        card = torch.autograd.grad(loss, list(model.parameters()) + [full])
    finally:
        dl.fused_dot_interaction = real
    card = [g.cpu() for g in card[:-1]] + [card[-1][torch.from_numpy(uniq).to(dev)].cpu()]
    cpu_model = copy.deepcopy(model).cpu()
    rows = torch.from_numpy(table[uniq]).requires_grad_()
    loss_cpu = dlrm_loss(cpu_model, rows, torch.from_numpy(inv.reshape(kidx.shape)), dense,
                         labels)
    host = torch.autograd.grad(loss_cpu, list(cpu_model.parameters()) + [rows])
    names = [n for n, _ in model.named_parameters()] + ["table rows"]
    worst = 0.0
    for name, gc, gh in zip(names, card, host):
        rel = float((gc - gh).abs().max() / (gh.abs().max() + 1e-30))
        worst = max(worst, rel)
        if not rel <= GRAD_TOL:
            raise AssertionError(f"gradient of {name}: card vs CPU {rel} > {GRAD_TOL}")
    if abs(float(loss.detach()) - float(loss_cpu.detach())) > 1e-4 * abs(float(loss_cpu.detach())):
        raise AssertionError(f"loss card {float(loss.detach())} vs CPU {float(loss_cpu.detach())}")
    return worst, seen[0]


def serve_variants(score_fn, held_out, dev) -> tuple:
    """Score the held-out set in each of SERVE_VARIANTS with its own launch
    counts, and hold the AUCs to the JAX package's gates.
    -> ({variant: auc}, {variant: launches})."""
    from hugectr_backend_tpu_torch.eval import VARIANTS, auc
    from hugectr_backend_tpu_torch.ops import kernels

    kidx, dense, labels = held_out
    aucs, launches = {}, {}
    for name in SERVE_VARIANTS:
        qb, fp8, dfmt = VARIANTS[name]
        kernels.launches.clear()
        scores = score_fn(kidx, dense, qb, fp8, dfmt)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        launches[name] = dict(kernels.launches)
        if scores.shape != labels.shape or not np.isfinite(scores).all():
            raise AssertionError(f"{name}: scores not finite [{labels.shape[0]}]")
        aucs[name] = auc(labels, scores)
    d8 = aucs["int8"] - aucs["fp32"]
    dw = aucs["int8+dense_w8a8"] - aucs["fp32"]
    if not (aucs["fp32"] > AUC_MIN and abs(d8) < AUC_INT8 and abs(dw) < AUC_W8A8):
        raise AssertionError(f"AUC gates (fp32 > {AUC_MIN}, |int8 delta| < {AUC_INT8}, "
                             f"|w8a8 delta| < {AUC_W8A8}) failed: {aucs}")
    return aucs, launches


def train_step_timing(trainer, data, batch: int, seed: int, dev) -> dict:
    """A train step at full width: wall time (host clock around the step and
    a synchronize), median of 10 after 2 warm-up steps; device kernel time
    per step and the idle share from torch.profiler over 5 more steps."""
    rs = np.random.default_rng(seed)
    batches = [trainer.batch(data, rs.integers(0, len(data.labels), batch)) for _ in range(17)]
    ts = []
    for bt in batches[:12]:
        t0 = time.perf_counter()
        trainer.step(*bt)
        torch.cuda.synchronize(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    ts = sorted(ts[2:])
    med = ts[len(ts) // 2]
    busy, top = device_profile(lambda: [trainer.step(*bt) for bt in batches[12:]], 5)
    return {"batch": batch, "median": med, "min": ts[0], "max": ts[-1], "runs": len(ts),
            "device_kernel_ms": busy,
            "device_idle_share": None if busy is None else 1 - busy / med,
            "top_device_kernels_ms": top}


# -------------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.ops.fused_interaction import (
        dot_interaction_oh_parts,
        dot_interaction_oh_parts_ref,
        dot_interaction_parts,
        dot_interaction_parts_ref,
        oh_rows_ref,
    )
    from hugectr_backend_tpu_torch.scripts.common import peaks
    from hugectr_backend_tpu_torch.serving.program import make_dlrm_multi_server

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card} | nvidia-smi: {smi}", flush=True)
    bw, flops, int8_ops, f32_flops = peaks(card)

    # Phase 1: build, the native host library beside the kernels.
    from concurrent.futures import ThreadPoolExecutor

    from hugectr_backend_tpu_torch.native import kvstore as native_kv

    def build_native():
        t = time.perf_counter()
        native_kv.load_lib()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as ex:
        native_s = ex.submit(build_native)
        took = kernels.build_all()
        took["native (g++)"] = native_s.result()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()), flush=True)
    for name in kernels.SOURCES:
        log = kernels._target(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text(errors="replace").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")

    # Phase 2: kernels vs plain on edge cases.
    t0 = time.perf_counter()
    n1 = k1_edge_checks(dev)
    n1g = k1_group_edge_checks(dev)
    n23 = k2_k3_edge_checks(dev)
    n3w = k3_wide_checks(dev)
    n3b = bf16_interaction_checks(dev)
    n5 = k5_edge_checks(dev)
    k5_layer = k5_quant_dense_check(dev)
    # Phase 7's checks run here too, before anything long.
    n4 = k4_edge_checks(dev)
    nb = bwd_edge_checks(dev)
    n_fo = forward_only_checks(dev)
    n6 = k6_edge_checks(dev)
    n_rep = repaired_route_checks(dev)
    torch.cuda.synchronize()
    print(f"edge checks: K1 {n1} bit-exact, grouped K1 {n1g} bit-exact, K2/K3 {n23} and "
          f"past 128 features {n3w} within rtol {RTOL}, "
          f"atol 1e-6*max|z|^2, K2/K3/K4 at bf16 {n3b} within 1 bf16 ulp (+ the same "
          f"atol), K5 {n5} (bit-exact for act None / relu, else "
          f"rtol = atol = {K5_TOL}), a w8a8 QuantDense(479, 1024) called directly on "
          f"K5's {k5_layer} plan bit-exact, K4 and the backward kernel {n4} within rtol "
          f"{RTOL} and atol 1e-6*max|z|^2 (forward) / 1e-6*F*max|g|*max|z| "
          f"(backward), the backward kernel at its plan's boundaries {nb}, "
          f"{n_fo} forward-only kernels raise under autograd, K6 {n6} "
          f"(bit-exact, invalid plans raise), the routes past the former limits {n_rep} "
          f"(same tolerances) ({time.perf_counter() - t0:.1f} s)", flush=True)

    # Phase 3: the main path at full width.
    cards = [min(c, ROW_CAP) for c in CRITEO_CARDS]
    # The sparse files stay until the front-end phase has served them.
    sparse_dir = tempfile.TemporaryDirectory(prefix="hps_chip_smoke_")
    t0 = time.perf_counter()
    tables, cfg = build_deployment(sparse_dir.name, cards, DIM, SEED)
    t1 = time.perf_counter()
    ps = HierParameterServer.create(cfg)
    print(f"deploy: {sum(cards)} rows in {len(cards)} tables, "
          f"{time.perf_counter() - t0:.1f} s (writing the sparse files {t1 - t0:.1f} s, "
          f"HierParameterServer.create {time.perf_counter() - t1:.1f} s)", flush=True)
    cache = ps.get_embedding_cache("dlrm", 0)
    kinds = [g[1] for g in cache._groups]
    print(f"lookup groups: {kinds} ({cache.nbytes() / 1e9:.3f} GB on the card)", flush=True)
    session = LookupSession.create(ps.get_model_params("dlrm"), cache)
    model = make_model(len(cards), SEED)
    srv = make_dlrm_multi_server(ps.get_model_params("dlrm"), cache, model)
    batches = make_batches(tables, BATCH, N_BATCHES, SEED + 1)
    lookup_keys = [k.reshape(-1) for k in batches[0][0]]

    # Record each kernel's main-path inputs (one predict per mode, uncounted).
    with Recorder() as rec_fold:
        predict_sync(srv, *batches[0])
    os.environ["HPS_OH_IN_KERNEL"] = "0"
    with Recorder() as rec_plain:
        predict_sync(srv, *batches[0])
    del os.environ["HPS_OH_IN_KERNEL"]

    kernels.launches.clear()
    rows = session.lookup(lookup_keys)
    torch.cuda.synchronize()
    lookup_launches = dict(kernels.launches)
    logits_fold, logits_k2, launches, after_fold = run_counted(srv, batches)
    print(f"main path launches (f32 DLRM): lookup {lookup_launches}; "
          f"predicts {launches}; per fold predict "
          f"{ {k: after_fold.get(k, 0) / N_BATCHES for k in SOURCES} }; per K2 predict "
          f"{ {k: (launches.get(k, 0) - after_fold.get(k, 0)) / N_BATCHES for k in SOURCES} }",
          flush=True)
    for name in ("gather_dequant", "dot_interaction_parts", "dot_interaction_oh_parts"):
        if lookup_launches.get(name, 0) + launches.get(name, 0) < 1:
            raise AssertionError(f"the main path never launched {name}")
    # K1 gathers every group of a lookup in one launch: once per lookup,
    # once per predict on either path.
    k1_fold = after_fold.get("gather_dequant", 0)
    k1_k2 = launches.get("gather_dequant", 0) - k1_fold
    if lookup_launches.get("gather_dequant", 0) != 1 or (k1_fold, k1_k2) != (N_BATCHES,
                                                                              N_BATCHES):
        raise AssertionError(f"K1 launches: lookup {lookup_launches.get('gather_dequant', 0)}, "
                             f"fold predicts {k1_fold}, K2 predicts {k1_k2}; expected one "
                             f"each per lookup and per predict ({N_BATCHES} predicts a path)")
    launches["gather_dequant"] += lookup_launches.get("gather_dequant", 0)

    want_rows = host_dequant(cache, lookup_keys)
    for t, (got, want) in enumerate(zip(rows, want_rows)):
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError(f"lookup table {t}: not bit-exact vs host dequant")
    print(f"lookup: {len(rows)} tables x {BATCH} keys bit-exact vs host dequant",
          flush=True)
    worst = fold_vs_k2(logits_fold, logits_k2)
    # Against a CPU reference on the first 64 samples: plain versions on
    # the host-dequantized embeddings.
    keys0, dense0 = batches[0]
    emb = np.stack([r[:64] for r in host_dequant(cache, keys0)], axis=1)
    ref = make_model(len(cards), SEED)(torch.from_numpy(dense0[:64]),
                                       torch.from_numpy(emb)).detach()
    rel_ref = float((logits_fold[0][:64].cpu() - ref).abs().max() / (ref.abs().max() + 1e-9))
    if rel_ref >= 1e-3:
        raise AssertionError(f"logits vs CPU reference rel {rel_ref}")
    print(f"predict: {N_BATCHES} x {BATCH} finite; fold vs K2 rel {worst:.3g}; "
          f"vs CPU reference rel {rel_ref:.3g}", flush=True)

    # The front end's key translation, A/B: the native StaticMap against the
    # searchsorted lookup, slots bit-identical.
    emit({"translate_ab": translate_ab(cache, batches), "card": card, "nvidia_smi": smi})

    for mode in ("fold", "k2"):
        emit({"predict_ms": predict_timing(srv, cache, batches, mode),
              "card": card, "nvidia_smi": smi})

    # Phase 5: the quantized-dense DLRM (w8a8, K5 in every layer) on the same
    # deployment, with the same f32 weights quantized.
    qmodel = make_model(len(cards), SEED, quant_fmt="w8a8")
    qsrv = make_dlrm_multi_server(ps.get_model_params("dlrm"), cache, qmodel)
    with Recorder() as rec_q:
        predict_sync(qsrv, *batches[0])
    qlogits_fold, qlogits_k2, qlaunches, q_after_fold = run_counted(qsrv, batches)
    print(f"main path launches (w8a8 DLRM): {qlaunches}; per fold predict "
          f"{ {k: q_after_fold.get(k, 0) / N_BATCHES for k in SOURCES} }; per K2 predict "
          f"{ {k: (qlaunches.get(k, 0) - q_after_fold.get(k, 0)) / N_BATCHES for k in SOURCES} }",
          flush=True)
    n_layers = len(BOTTOM) + len(TOP)
    if qlaunches.get("w8a8_dense", 0) != n_layers * 2 * N_BATCHES:
        raise AssertionError(f"w8a8 path: {qlaunches.get('w8a8_dense', 0)} K5 launches, "
                             f"expected {n_layers} per predict")
    for name in ("gather_dequant", "dot_interaction_parts", "dot_interaction_oh_parts"):
        if qlaunches.get(name, 0) < 1:
            raise AssertionError(f"the w8a8 path never launched {name}")
    qworst = fold_vs_k2(qlogits_fold, qlogits_k2)
    # Against the port on the CPU (plain versions) on the first 64 samples.
    qref = make_model(len(cards), SEED, quant_fmt="w8a8")(
        torch.from_numpy(dense0[:64]), torch.from_numpy(emb)).detach()
    qdelta = float((qlogits_fold[0][:64].cpu() - qref).abs().max() / (qref.abs().max() + 1e-9))
    if qdelta > W8A8_LOGITS:
        raise AssertionError(f"w8a8 logits vs the CPU port: |delta| / max|logit| {qdelta}")
    qf32 = float((qlogits_fold[0] - logits_fold[0]).abs().max() / (logits_fold[0].abs().max() + 1e-9))
    print(f"w8a8 predict: {N_BATCHES} x {BATCH} finite; fold vs K2 rel {qworst:.3g}; vs the "
          f"CPU port |delta|/max|logit| {qdelta:.3g} (bar {W8A8_LOGITS}); vs the f32 model "
          f"{qf32:.3g}", flush=True)
    for mode in ("w8a8_fold", "w8a8_k2"):
        emit({"predict_ms": predict_timing(qsrv, cache, batches, mode),
              "card": card, "nvidia_smi": smi})

    # The front end: KServe-v2 HTTP on the card. gRPC is held against the
    # JAX package on the CPU (tests/test_torch_grpc.py) and served on the
    # card by the ensemble phase.
    print("frontend: serving HTTP with grpc_port=None (gRPC: tests/test_torch_grpc.py "
          "on the CPU, the ensemble phase on the card)", flush=True)
    fe = frontend_phase(cfg, tables)
    emit({"frontend_http": fe, "card": card, "nvidia_smi": smi})
    print(f"frontend: {fe['requests']} requests in {fe['wall_s']:.1f} s from "
          f"{FRONTEND_CLIENTS} clients, {fe['qps']:.1f} qps, {fe['samples_per_s']:.0f} "
          f"samples/s, p50 {fe['p50_ms']:.2f} ms, p99 {fe['p99_ms']:.2f} ms, mean merged "
          f"batch {fe['mean_merged_batch']:.1f}, K1 {fe['k1_launches_per_merged_batch']:.2f} "
          f"launches per merged batch, idle share {fe['device_idle_share']}; "
          f"{fe['checked_responses']} responses bit-exact vs host dequant ({card} | {smi})",
          flush=True)

    # Phase 5c: the hierarchy behind the cache (dynamic, stochastic and UVM
    # caches, the SSD tier, the online update) on the same sparse files.
    t0 = time.perf_counter()
    dyn = dynamic_tiers(dev, sparse_dir.name, tables,
                        emit_line=lambda line: emit({**line, "card": card, "nvidia_smi": smi}))
    for name, n in dyn["launches"].items():
        launches[name] = launches.get(name, 0) + n
    sync = dyn["sync"]
    print(f"dynamic_tiers: {len(sync)} synchronous batches bit-identical to the CPU instance "
          f"(hit rate {sync[0]['hit_rate']:.4f} -> {sync[-1]['hit_rate']:.4f}, K1 once per "
          f"lookup); {dyn['async']['batches']} asynchronous batches, every row its tier row "
          f"or its dequant ({dyn['async']['dropped_inserts']} dropped insert batches); "
          f"stochastic and UVM held to their CPU instances (UVM refresh admitted "
          f"{dyn['uvm']['admitted']} keys); fold logits bit-identical to the static "
          f"deployment's; {sum(dyn['update']['keys_per_table'])} updated keys visible "
          f"{dyn['update']['post_to_visible_ms']:.1f} ms after the post; launches "
          f"{dyn['launches']} ({time.perf_counter() - t0:.1f} s)", flush=True)

    # Phase 5d: the model zoo (DCN-v2 on the same sparse files; DIN, BST and
    # retrieval on two 1,000,000-row tables; the example's small families).
    t0 = time.perf_counter()
    zoo = zoo_phase(dev, ps, cfg, batches,
                    emit_line=lambda line: emit({**line, "card": card, "nvidia_smi": smi}))
    for name, n in zoo["launches"].items():
        launches[name] = launches.get(name, 0) + n
    timed = {ln["zoo"]: ln for ln in zoo["lines"] if "wall_ms_median" in ln}
    print("zoo: " + "; ".join(
        f"{fam} wall {ln['wall_ms_median']:.3f} ms, device {ln['device_kernel_ms']} ms, idle "
        f"{ln['device_idle_share']}" for fam, ln in timed.items())
        + f"; every output within rel {ZOO_REL} of the CPU instance at f32, within its "
        f"family's bar at bf16; K1 launches "
        f"{zoo['launches']} ({time.perf_counter() - t0:.1f} s; {card} | {smi})", flush=True)

    # Phase 5e: a Triton model repository served on the card: the 26 tables
    # as one HPS model behind dense models in four formats, as ensembles.
    t0 = time.perf_counter()
    ens = ensemble_phase(dev, tables, bw, int8_ops,
                         emit_line=lambda line: emit({**line, "card": card, "nvidia_smi": smi}))
    for name, n in ens["launches"].items():
        launches[name] = launches.get(name, 0) + n
    walls = {ln["ensemble"]: (ln["fused"]["wall_ms_median"], ln["staged"]["wall_ms_median"])
             for ln in ens["lines"] if "fused" in ln}
    print("ensemble: " + "; ".join(f"{e} fused {f:.3f} ms, staged {st:.3f} ms"
                                   for e, (f, st) in walls.items())
          + f" at batch {BATCH}; fused = staged = the host reference over the server, HTTP "
          f"and gRPC; K1 once per fused infer, K5 {len(TOP)} times for w8a8; HTTP p50 "
          f"{ens['http']['p50_ms']:.2f} ms, p99 {ens['http']['p99_ms']:.2f} ms; launches "
          f"{ens['launches']} ({time.perf_counter() - t0:.1f} s; {card} | {smi})", flush=True)

    # Phase 5e2: sharded tables (parallel/), every shard on this card.
    t0 = time.perf_counter()
    shd = sharded_phase(dev, tables, cfg, cache, batches, bw,
                        emit_line=lambda line: emit({**line, "card": card, "nvidia_smi": smi}))
    dcn_walls = {ln["strategy"]: ln["wall_ms_median"] for ln in shd["lines"]
                 if ln["sharded"] == "dcn_v2"}
    print("sharded: lookups at P " + ", ".join(str(p) for p in SHARD_LOOKUP_P)
          + " bit-exact vs the host dequant and the unsharded cache, one K1 launch each; "
          f"DCN-v2 at P={SHARD_P} bit-identical to the unsharded server, walls "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in dcn_walls.items())
          + f"; ps.json HTTP byte-identical, refresh served; sharded ensemble fused = staged; "
          f"the process-group mesh ({'NCCL' if dev.type == 'cuda' else 'gloo'}, world size 1) "
          f"bit-identical; dryrun_multichip(8) passed; launches {shd['launches']} "
          f"({time.perf_counter() - t0:.1f} s; P shards on one card: no interconnect measured; "
          f"{card} | {smi})", flush=True)

    # Phase 5e3: the entry points around the package: entry(), the nine
    # examples, perf_client, frontend_saturation (device stubbed) and
    # auc_parity's smoke pass.
    t0 = time.perf_counter()
    exa = examples_phase(dev, fe,
                         emit_line=lambda line: emit({**line, "card": card, "nvidia_smi": smi}))
    print(f"examples: entry() and the nine examples on the card held to their CPU runs; "
          f"launches {exa['launches']} ({time.perf_counter() - t0:.1f} s; {card} | {smi})",
          flush=True)

    # Phase 5f: the redis_cluster volatile db: the dynamic deployment with
    # its DRAM tier on two pool node processes.
    t0 = time.perf_counter()
    clu = cluster_phase(dev, sparse_dir.name, tables,
                        emit_line=lambda line: emit({**line, "card": card, "nvidia_smi": smi}))
    sparse_dir.cleanup()
    for name, n in clu["launches"].items():
        launches[name] = launches.get(name, 0) + n
    print(f"cluster: {clu['batches']} lookups over {clu['nodes']} pool nodes (secret + TLS; "
          f"rows per node {clu['rows_per_node']}) bit-identical to the local-store CPU "
          f"instance, K1 once per lookup; the pool's query of {clu['tier']['keys']} keys "
          f"{clu['tier']['pool_query_ms']:.2f} ms vs the local store's "
          f"{clu['tier']['local_query_ms']:.2f} ms, insert {clu['tier']['pool_insert_ms']:.2f} "
          f"vs {clu['tier']['local_insert_ms']:.2f} ms ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # Phase 6: each kernel at its main-path shapes.
    results = {}
    # K1: the fold predict's groups (arena and solo) and the K2 path's (the
    # one-hot group too), each in its one launch; then the arena group alone
    # through the one-table entry.
    (fold_args,) = rec_fold.calls["gather_dequant_groups"]
    (k2_args,) = rec_plain.calls["gather_dequant_groups"]
    for path, args in (("fold", fold_args), ("k2", k2_args)):
        r = k1_group_measure(args, bw)
        emit({"kernel": "gather_dequant", "path": path, **r, "card": card, "nvidia_smi": smi})
        if path == "fold":
            results["gather_dequant"] = r
    vals, dsc, slots_cat, _, meta, sb, _ = fold_args
    arena_g = next(gi for gi, ds in enumerate(dsc) if ds is not None and meta[gi][0] == "gather")
    r = k1_measure((vals[arena_g], dsc[arena_g],
                    slots_cat[sb[arena_g][0]:sb[arena_g][1]], None), bw)
    emit({"kernel": "gather_dequant", "path": "one table (the arena group)", **r, "card": card,
          "nvidia_smi": smi})
    b, d = BATCH, DIM
    (bottom, parts, fmap), = rec_plain.calls["dot_interaction_parts"]
    feats = [bottom] + [parts[p][s][:b] for p, s in fmap]
    r = interaction_measure("dot_interaction_parts", dot_interaction_parts,
                            dot_interaction_parts_ref, (bottom, parts, fmap),
                            feats, len(feats) * b * d * 4, bw, flops)
    results["dot_interaction_parts"] = r
    emit({"kernel": "dot_interaction_parts", **r, "card": card, "nvidia_smi": smi})
    # The bf16 route (compute_dtype=bf16): the same rows in bf16.
    bf = torch.bfloat16
    bargs = (bottom.to(bf), [p.to(bf) for p in parts], fmap)
    bfeats = [bargs[0]] + [bargs[1][p][s][:b] for p, s in fmap]
    r = interaction_measure("dot_interaction_parts", dot_interaction_parts,
                            dot_interaction_parts_ref, bargs, bfeats, len(bfeats) * b * d * 2,
                            bw, flops)
    emit({"kernel": "dot_interaction_parts", **r, "card": card, "nvidia_smi": smi})
    (bottom, arena, slots, scales, parts, fmap, members), = \
        rec_fold.calls["dot_interaction_oh_parts"]
    n_oh = slots.shape[0]
    fed = [bottom] + [parts[p][s][:b] for p, s in fmap]
    feats = [bottom] + oh_rows_ref(arena, slots, scales, b, members) + fed[1:]
    # The one-hot rows are read from the arena (its distinct rows), with a
    # slot and a scale per (feature, sample).
    in_bytes = (len(fed) * b * d * 4
                + torch.unique(slots[:, :b]).numel() * d * arena.element_size()
                + n_oh * b * (4 + (4 if scales is not None else 0)))
    r = interaction_measure("dot_interaction_oh_parts", dot_interaction_oh_parts,
                            dot_interaction_oh_parts_ref,
                            (bottom, arena, slots, scales, parts, fmap, members),
                            feats, in_bytes, bw, flops)
    results["dot_interaction_oh_parts"] = r
    emit({"kernel": "dot_interaction_oh_parts", **r, "card": card, "nvidia_smi": smi})
    bargs = (bottom.to(bf), arena, slots, scales, [p.to(bf) for p in parts], fmap, members)
    bfeats = ([bargs[0]] + oh_rows_ref(arena, slots, scales, b, members)
              + [bargs[4][p][s][:b] for p, s in fmap])
    in_bytes = (len(fed) * b * d * 2
                + torch.unique(slots[:, :b]).numel() * d * arena.element_size()
                + n_oh * b * (4 + (4 if scales is not None else 0)))
    r = interaction_measure("dot_interaction_oh_parts", dot_interaction_oh_parts,
                            dot_interaction_oh_parts_ref, bargs, bfeats, in_bytes, bw, flops)
    emit({"kernel": "dot_interaction_oh_parts", **r, "card": card, "nvidia_smi": smi})
    # K5 at its 8 layer shapes (the fold predict's); its entry in the kernels
    # line sums them: one predict's worth.
    layers = [k5_measure(args, bw, int8_ops) for args in rec_q.calls["w8a8_dense"]]
    for r in layers:
        emit({"kernel": "w8a8_dense", **r, "card": card, "nvidia_smi": smi})
    lib = [r["library_ms"] for r in layers]
    results["w8a8_dense"] = {
        "max_abs_err": max(r["max_abs_err"] for r in layers),
        "kernel_ms": sum(r["kernel_ms"] for r in layers),
        "plain_ms": sum(r["plain_ms"] for r in layers),
        "library_ms": None if None in lib else sum(lib),
        "bound_ms": sum(r["bound_ms"] for r in layers),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in layers) else "operations",
    }
    emit({"kernel": "w8a8_dense", "shape": "sum of the 8 layers of one predict",
          **results["w8a8_dense"], "card": card, "nvidia_smi": smi})
    # What a predict pays: the 8 layers back to back in one CUDA graph (each
    # on its recorded input), where no layer finds its weights and x in L2
    # from a replay of itself.
    from hugectr_backend_tpu_torch.ops.quant_matmul import w8a8_dense
    from hugectr_backend_tpu_torch.scripts.common import graph_us

    chain = [lambda a=a: w8a8_dense(*a) for a in rec_q.calls["w8a8_dense"]]
    emit({"kernel": "w8a8_dense", "shape": "the 8 layers back to back in one CUDA graph",
          "chained_ms": graph_us(chain) * len(chain) / 1e3, "card": card, "nvidia_smi": smi})
    launches["w8a8_dense"] = qlaunches["w8a8_dense"] + ens["launches"].get("w8a8_dense", 0)
    # The routes past the former limits, each at its edge shape.
    repaired_route_timings(dev, bw, f32_flops,
                           lambda line: emit({**line, "card": card, "nvidia_smi": smi}))

    # Phase 8: training at full width (slice 3's path), then the
    # gradients on one batch against the port on the CPU.
    from hugectr_backend_tpu_torch.eval import (
        make_click_dataset,
        make_multi_click_dataset,
        make_trainer,
        multi_serving_scores,
        serving_scores,
        train_dlrm,
        train_dlrm_multi,
    )
    from hugectr_backend_tpu_torch.ops.fused_interaction import (
        fused_dot_interaction,
        fused_dot_interaction_ref,
    )

    t0 = time.perf_counter()
    mdata = make_multi_click_dataset(N_TRAIN + N_EVAL, cards, seed=SEED)
    mtrain, mheld = split(mdata, N_TRAIN)
    print(f"multi-table click data: {N_TRAIN} + {N_EVAL} samples over {len(cards)} tables "
          f"({sum(cards)} rows), {time.perf_counter() - t0:.1f} s", flush=True)
    model_m, tables_m, losses_m, tl_m, secs = train_counted(
        train_dlrm_multi, mtrain, dev, TRAIN_STEPS, BATCH, TRAIN_LR, SEED)
    print(f"train_dlrm_multi: {TRAIN_STEPS} steps x {BATCH} in {secs:.1f} s, loss "
          f"{losses_m[:10].mean():.5f} (first 10) -> {losses_m[-10:].mean():.5f} (last 10); "
          f"launches {tl_m}", flush=True)
    offsets = np.concatenate([[0], np.cumsum(cards)])[:-1]
    table_m = np.concatenate(tables_m)
    worst_grad, (k4_bottom, k4_emb) = grad_check(model_m, table_m, offsets, mtrain, BATCH,
                                                 SEED + 2, dev)
    print(f"gradients, card vs the CPU port on one batch of {BATCH}: worst max|delta| / "
          f"max|grad| {worst_grad:.3g} (bar {GRAD_TOL})", flush=True)

    # Phase 9: the trained checkpoints served in each variant.
    with tempfile.TemporaryDirectory(prefix="hps_chip_smoke_multi_") as wd:
        aucs_m, sl_m = serve_variants(
            lambda k, x, qb, fp8, dfmt: multi_serving_scores(
                model_m, mdata.key_ids, tables_m, k, x, quant_bits=qb, dense_fmt=dfmt,
                batch=BATCH, workdir=wd, device=dev), mheld, dev)
    for name in ("gather_dequant", "dot_interaction_oh_parts"):
        if any(sl_m[v].get(name, 0) < 1 for v in SERVE_VARIANTS):
            raise AssertionError(f"multi-table serving never launched {name}")
    if sl_m["int8+dense_w8a8"].get("w8a8_dense", 0) < 1:
        raise AssertionError("the w8a8 variant never launched w8a8_dense")
    emit({"auc_multi_table": aucs_m, "serving_launches": sl_m, "n_eval": N_EVAL,
          "card": card, "nvidia_smi": smi})
    del tables_m
    t0 = time.perf_counter()
    sdata = make_click_dataset(SINGLE_N_TRAIN + N_EVAL, SINGLE_VOCAB, num_feats=len(cards),
                               seed=SEED + 5)
    strain, sheld = split(sdata, SINGLE_N_TRAIN)
    print(f"single-table click data: {SINGLE_N_TRAIN} + {N_EVAL} samples, vocab "
          f"{SINGLE_VOCAB}, {len(cards)} keys per sample, {time.perf_counter() - t0:.1f} s",
          flush=True)
    model_s, table_s, losses_s, tl_s, secs = train_counted(
        train_dlrm, strain, dev, SINGLE_STEPS, BATCH, SINGLE_LR, SEED + 5)
    print(f"train_dlrm: {SINGLE_STEPS} steps x {BATCH} at lr {SINGLE_LR} in {secs:.1f} s, loss "
          f"{losses_s[:10].mean():.5f} (first 10) -> {losses_s[-10:].mean():.5f} (last 10); "
          f"launches {tl_s}", flush=True)
    with tempfile.TemporaryDirectory(prefix="hps_chip_smoke_single_") as wd:
        aucs_s, sl_s = serve_variants(
            lambda k, x, qb, fp8, dfmt: serving_scores(
                model_s, sdata.key_ids, table_s, k, x, quant_bits=qb, fp8_quant=fp8,
                dense_fmt=dfmt, batch=BATCH, workdir=wd, device=dev), sheld, dev)
    for name in ("gather_dequant", "fused_dot_interaction"):
        if any(sl_s[v].get(name, 0) < 1 for v in SERVE_VARIANTS):
            raise AssertionError(f"FusedDlrmServer never launched {name}")
    emit({"auc_single_table": aucs_s, "serving_launches": sl_s, "n_eval": N_EVAL,
          "card": card, "nvidia_smi": smi})
    print(f"AUC multi-table {aucs_m}; single-table {aucs_s} (gates: fp32 > {AUC_MIN}, "
          f"|int8 delta| < {AUC_INT8}, |w8a8 delta| < {AUC_W8A8})", flush=True)

    # Phase 10: K4 forward and backward at the training shape, and the step.
    feats = [k4_bottom] + list(k4_emb.unbind(1))
    r = interaction_measure("fused_dot_interaction", fused_dot_interaction,
                            fused_dot_interaction_ref, (k4_bottom, k4_emb), feats,
                            len(feats) * BATCH * DIM * 4, bw, flops)
    results["fused_dot_interaction"] = r
    emit({"kernel": "fused_dot_interaction", **r, "card": card, "nvidia_smi": smi})
    bargs = (k4_bottom.detach().to(torch.bfloat16), k4_emb.detach().to(torch.bfloat16))
    r = interaction_measure("fused_dot_interaction", fused_dot_interaction,
                            fused_dot_interaction_ref, bargs,
                            [bargs[0]] + list(bargs[1].unbind(1)),
                            len(feats) * BATCH * DIM * 2, bw, flops)
    emit({"kernel": "fused_dot_interaction", **r, "card": card, "nvidia_smi": smi})
    del bargs
    n_out = DIM + len(feats) * (len(feats) - 1) // 2
    g_out = torch.randn(BATCH, n_out, generator=torch.Generator().manual_seed(6)).to(dev)
    r = k4_bwd_measure(k4_bottom, k4_emb, g_out, bw, f32_flops)
    results["dot_interaction_bwd"] = r
    emit({"kernel": "dot_interaction_bwd", **r, "card": card, "nvidia_smi": smi})
    trainer = make_trainer(sum(cards), NUM_DENSE, len(cards), DIM, BOTTOM[:-1], TOP, TRAIN_LR,
                           SEED, init=(model_m.state_dict(), table_m), offsets=offsets,
                           device=dev)
    emit({"train_step_ms": train_step_timing(trainer, mtrain, BATCH, SEED + 3, dev),
          "model": "26 tables, 1,855,979 x 128 f32 rows, Adam", "card": card,
          "nvidia_smi": smi})
    launches["fused_dot_interaction"] = (tl_m["fused_dot_interaction"]
                                         + tl_s["fused_dot_interaction"]
                                         + sum(v.get("fused_dot_interaction", 0)
                                               for v in sl_s.values()))
    launches["dot_interaction_bwd"] = tl_m["dot_interaction_bwd"] + tl_s["dot_interaction_bwd"]

    # Phase 11: the lookup microbenchmarks (slice 4's path), counted, with
    # the uncapped Criteo tables on the card; then K6 timed. It runs last,
    # after the training state is freed, so that it cannot move phase 10.
    from hugectr_backend_tpu_torch.scripts import common, microbench_onehot, microbench_true

    del trainer, model_m, table_m, model_s, table_s, k4_bottom, k4_emb, g_out, feats
    torch.cuda.empty_cache()

    def mb_emit(line):
        emit({**line, "card": card, "nvidia_smi": smi})

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    print(f"card memory before the microbenchmarks: {torch.cuda.memory_allocated() / 1e9:.3f} "
          "GB allocated", flush=True)
    kernels.launches.clear()
    mb_onehot = microbench_onehot.run(dev, emit=mb_emit)
    mb_true = microbench_true.run(dev, emit=mb_emit)
    torch.cuda.synchronize()
    mb_launches = dict(kernels.launches)
    print(f"microbenchmarks: {len(mb_onehot)} + {len(mb_true)} lines, launches {mb_launches}, "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB allocated, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("onehot_gather", "onehot_gather_rows", "gather_dequant"):
        if mb_launches.get(name, 0) < 1:
            raise AssertionError(f"the microbenchmarks never launched {name}")
    tiny = common.build_arena(common.TINY_CARDS, common.R_TILE, dev)
    tiny_plan = tiny.plan(BATCH, microbench_onehot.V1_M_TILE)
    _, tiny_slots = tiny.slots(1, BATCH)
    for name, rows_only in (("onehot_gather", False), ("onehot_gather_rows", True)):
        r = k6_measure(tiny, tiny_plan, tiny_slots, rows_only, bw)
        results[name] = r
        launches[name] = mb_launches[name]
        emit({"kernel": name, **r, "card": card, "nvidia_smi": smi})
    del tiny, tiny_slots
    torch.cuda.empty_cache()
    print(f"card memory after the microbenchmarks: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          "allocated", flush=True)

    # Phase 12: the benchmark programs (slice 14's path), counted: the
    # uncapped tables, the fused variants, DIN, the HTTP stages and the eight
    # microbenchmarks, every earlier phase's state freed.
    print(f"card memory before the benchmark programs: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated", flush=True)
    kernels.launches.clear()
    bph = bench_phase(dev, emit_line=mb_emit)
    print(f"bench phase: the benchmark and the eight microbenchmarks passed their checks; "
          f"launches {bph['launches']}; peak {bph['peak_gb']:.3f} GB allocated; "
          f"{bph['seconds']:.1f} s ({card} | {smi})", flush=True)

    # Phase 13: the TPU-layout microbenchmarks (slice 17's path), counted:
    # the uncapped tables built once for fold_ab, full_ab and overlap.
    kernels.launches.clear()
    lph = microbench_layouts_phase(dev, emit_line=mb_emit)
    print(f"microbench_layouts phase: the nine microbenchmarks passed their checks; "
          f"launches {lph['launches']}; peak {lph['peak_gb']:.3f} GB allocated; "
          f"{lph['seconds']:.1f} s ({card} | {smi})", flush=True)
    for name, n in (list(shd["launches"].items()) + list(exa["launches"].items())
                    + list(bph["launches"].items()) + list(lph["launches"].items())):
        launches[name] = launches.get(name, 0) + n
    print(smi)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["kernel_ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound_ms"], "bound_by": results[name]["bound_by"],
         "library_ms": results[name]["library_ms"]}
        for name, (src, rep) in SOURCES.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
