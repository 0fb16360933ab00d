#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (recsys_tpu_torch).

    python3 chip_smoke.py [--seed N]

Needs one NVIDIA GPU (sm_90a: H100) and nvcc; run from the root of a
checkout.  Phases, one JSON line each:

1. card      -- nvidia-smi's name and power limit (also printed raw).
2. build     -- nvcc builds every kernel from recsys_tpu_torch/kernels/csrc.
3. check     -- each kernel against its plain PyTorch version on the card,
                TF32 off: the forward kernels at the serving shapes and a
                ragged batch, f32 and bf16; the dot interaction also at one,
                two, 64 and the most fields it takes at D = 128, D = 1, 8,
                32 and 36, on an unaligned input; the MLP backward for both towers
                at 4096 and 1000 rows, bit for bit on integer values and
                within limits on random weights; the embedding updates on one
                100k x 16 table with a 16384-id batch, uniform and skewed,
                with a ragged last block, f32 and bf16 tables, bf16 and f32
                sums and weight decay off and on; rowwise AdaGrad also at
                D = 128 (blocks of 256) and 12, on a table 4 bytes into
                its storage and on 16384 occurrences of one row; fused Adam
                at D = 12, on a table 4 bytes into its storage, and as one
                launch over unequal tables, one no id touches and one of
                no rows; the embedding updates at the JAX chunk length 256
                and at the port's, 1.
3b. f4       -- the routes of shapes outside a kernel's domain against the
                same calls on the CPU, with no launch counted: AutoInt at
                D = 8 (two heads of width 4), a request and a train step;
                attention at head width 12 with its gradients; the dot
                interaction at F = 80, D = 800 with its gradient; top-k at
                D = 1024 through both retrieval functions.
4. serve     -- DLRM at the bench widths (26 x 100k-row tables, D = 16,
                bottom 13-512-256-16-16, top 367-1024-1024-512-256-1, bf16
                compute, 4 dense microbatches), weights made from the seed in
                the JAX package's layout and converted with params_from_jax,
                served by Trainer.predict over 16384-row requests plus a
                ragged tail, with fused_mlps off and on (their request times
                side by side).  Launch counts are
                zeroed before each run and read after it; the logits are
                held against the same model run through the plain versions.
5. train     -- the same DLRM trained by Trainer.fit for one epoch of
                TRAIN_STEPS 16384-row steps: fused Adam with fused_mlps off
                and on, and fused rowwise AdaGrad.  Launch counts as in
                serve; the loss must be finite; one more train_step is held
                against the same step through the plain versions from a copy
                of the state; step time, examples/s, peak memory and a
                profile of one step.
6. timing    -- per-kernel ms beside its bound and the plain version's ms
                (the dot interaction with its launch floor and
                torch.bmm's whole Gram matrix; fused Adam as the step
                launches it, 26 tables at once, and one table a launch);
                the fused MLPs per tower with the unfused cuBLAS tower
                (unfused_ms) and each launch apart (pre-pass, chain, dW),
                with the cluster size C, the clusters the card holds at
                once and kernel B's batch slices S;
                the embedding updates over 26 tables in turn, as a step
                calls them.
7. flash check -- the flash-attention forward and backward kernels against
                their plain versions (flash_check.py) at the SASRec bench
                shape (B·H = 512, S = 512, head dim 32), a ragged S = 300,
                S = 2048 on 16 sequences, head dim 64 with one head,
                AutoInt's (4096 and 512, 2, 39, 8), S = 63, 64, 65, 127
                and 129 at head dim 32 and S = 40, 64 at head dim 128;
                causal on and off; no mask, a random key mask and
                front-padded histories; each limit shown to reject three
                wrong results (two tile faults, single-pass TF32).
8. sasrec serve -- SASRec at the bench.py widths (50,000 items, D = 64, 2
                blocks, 2 heads, max_len 512), weights made from the seed in
                the JAX layout and converted, served by Trainer.predict over
                256-row requests plus a ragged tail against 20 negatives:
                HR@10, NDCG@10, launch counts, logits against the plain
                versions, request time, profile.
9. sasrec train -- Trainer.fit with pairwise BCE and Adam: the prefix
                scheme at max_len 512 and 2048 and the all-position scheme
                at 512; launch counts, finite loss, one more step against
                the plain step, step time, and a profile of one step split
                into attention, GEMMs, gathers, loss and optimizer.
10. sasrec cli -- python -m recsys_tpu_torch.cli sasrec --epochs 2
                --batch-size 128 (synthetic ratings, the numpy dataset
                builder at max_len 50, fit, predict, HR@10), every flash
                launch counted.
11. flash timing -- kernel, plain and torch SDPA ms at S = 512 (B = 256)
                and S = 2048 (B = 32; the kernels also at B = 256), beside
                the split-TF32 bound (3 TF32 products an f32 product at 495
                TFLOP/s) and the CUDA cores' f32 bound (67 TFLOP/s).
12. youtube data -- realistic_ratings at the protocol seqret widths (20,000
                items, users cut to 20,000), with the side features the
                two-tower phase uses, and the numpy retrieval dataset at
                max_len 50.
13. youtube check -- the pooled-gather and top-k kernels against their plain
                versions (retrieval_check.py): the pooled gather at B = 1024
                and 1000, L = 50, D = 32 and 128, f32 and bf16 tables,
                uniform and Zipf ids, empty histories, then at L = 1, 31,
                32, 33, 50, 64, 65, 200 by D = 4, 12, 32, 33, 128, 130, f32
                (also unaligned) and bf16; the top-k at Q = 8192 and 3616
                over the catalog, D = 32, k = 1, 10, 16, with duplicated item
                rows, and at 1024 x 1,000,000 x 64, k = 10; then N = k + 1,
                D = 4, 12, 64, 124 and 128 (the domain's edge) at 1000 x
                5000, and the sweep shape, with rows duplicated across the
                plan's tile and split boundaries; D = 129 through both
                retrieval routes with no launch; each limit shown to reject
                a wrong result (the top-k's also single-pass TF32 scores).
14. youtube serve -- YoutubeDNN (D = 32, hidden 128-64, mean pooling),
                weights made from the seed in the JAX layout and converted,
                served as run_seqret serves it: user_embed over 8192-query
                blocks, top-10 over the whole catalog, recall@10; launch
                counts, indices against the plain path, block time, queries/s,
                peak memory, profile.
15. youtube train -- Trainer.fit with the logQ-corrected in-batch softmax,
                batch 1024, Adam, YOUTUBE_STEPS steps from the head of the
                shuffled train set; launch counts, finite loss, one more step
                against the plain step, step time, profile; then serve again:
                recall@10 must beat random.
16. youtube timing -- kernel, plain and library ms of the pooled gather and
                the top-k with their bounds and launch floors (an empty
                kernel at the kernel's grid), at the serving block and the
                sweep shape; the top-k's split-TF32 bound (3 TF32 products
                an f32 product at 495 TFLOP/s) with the CUDA cores' beside
                it, and its plan.
16b. mind    -- MIND at protocol mind's widths (D = 32, 4 capsules, 3
                routing iterations, user MLP 64), weights from the seed, on
                the youtube data: 50 logQ-softmax steps of 1024 rows (finite
                losses, the last below the first; no kernel on this path),
                then 4096-user blocks: each capsule's top-10 over the
                catalog through the top-k kernel (every launch held against
                the plain top-k), the merge into 10 distinct items and
                recall@10; step and block times.
16c. two-tower -- DSSM, SENet-DSSM and FM-match at protocol dssm's widths
                (user id, age bin, gender, occupation; item id and category;
                D = 16, towers 128-64-32) on the same ratings: 20 fit steps of
                2048 rows each (FM-match through the bi-interaction kernel,
                held against its plain version on one batch), then top-10 in
                8192-user blocks through the top-k kernel, every launch held
                against the plain top-k, and recall@10.
16d. ncf     -- NCF at protocol ncf's widths (tables 32 wide, MLP 64-32-16)
                on the same ratings (20,000 users): one epoch of fit at 1024
                rows with the ranked HR@10 as its eval_fn, a 101-candidate
                request of 1024 users on the card against the CPU, one more
                step against the CPU step, request time.
16e. din     -- DIN with PReLU and with Dice at protocol din's widths
                (maxlen 40, 12 train positions a user, D = 8, FFN 80-40) on
                the same ratings and categories: one epoch with the val
                split, evaluate_auc, a request against the CPU and one more
                step against the CPU step, the BatchNorm statistics within
                1e-5.  Neither model launches a kernel (counted).
17. ctr check -- the FM bi-interaction kernel against its plain version
                (ctr_check.py): F = 1, 2, 26, 39, 70 fields, D = 1, 8, 16, 32,
                36, B = 0, 1, 513, 4096, f32 and bf16, and large nearly
                cancelling inputs; each limit shown to reject two wrong
                results.
18. ctr serve -- the protocol ctr models (FM, DeepFM, Wide&Deep,
                DeepCrossing, DCN, DLRM, AutoInt) at the protocol widths
                (realistic_criteo: 26 fields at the Criteo vocabularies,
                D = 16, 13 dense features), weights made from the seed in the
                JAX layout and converted, served by Trainer.predict over
                4096-row requests plus a ragged tail; launch counts, logits
                against the same model on the CPU, request ms, a profile.
19. ctr train step -- one train_step of FM, DeepFM and AutoInt on the card
                against the same step on the CPU; step ms, profiles.
20. ctr protocol -- the port's protocol ctr runner (fit with early stopping,
                evaluate_auc) with the default models at the full widths,
                rows cut to 200,000; every test AUC must be above 0.55.
20b. ctr table dtype -- the runner's DLRM with --table-dtype bf16,
                --embedding-optimizer fused_adam and --embedding-lr: a step
                against the plain step (#4 on bf16 tables), then the runner
                at 200,000 rows, one epoch, #4 counted.
21. ctr timing -- kernel, plain and bound ms of the bi-interaction at FM's
                and DeepFM's serving shapes; the flash kernels beside torch
                SDPA at AutoInt's (4096, 2, 39, 8) and its train step's
                (512, 2, 39, 8), with both bounds.
22. probe check -- the three probe kernels (elementwise Adam stream, per-row
                walk, hot gather) against their plain versions bit for bit
                (probe_check.py): ragged, bench-table and misaligned Adam
                counts from two states, and passes of the 26 bench tables,
                of unequal tables, with an empty table and of 40 tables,
                each one launch for every 32 tables; walks of 1 to 100,000
                rows and 1 to 1024 columns; the hot gather at pack 1, 2 and
                8 with sentinel and negative ids, 13 to 300,001 unpadded
                ids, ids mostly outside, an unaligned buffer, a buffer past
                48 KB and one at the opt-in limit, and its refusal of a
                256 KB buffer; each limit shown to reject wrong results.
23. probes   -- stream_probe, gather_split_probe (Zipf(1.1), then uniform)
                and dedup_probe at the bench shapes, each printing its JSON
                line; launch counts zeroed before and read after; the split
                gather must be exact.
24. probe timing -- kernel, plain, library and bound ms of the three probe
                kernels at the probes' shapes: the Adam pass over the 26
                tables (one launch) in turns with torch's fused Adam, the
                walk beside its add-chain floor, the hot gather beside its
                launch floor (an empty kernel at its grid, launch_floor_ms).
24b. cli     -- python -m recsys_tpu_torch.cli at the JAX CLI's fixture
                sizes: ctr --model fm (1 epoch), youtube, mind and match
                --model dssm, senet, fm, ncf and din (2 epochs each),
                multitask --model esmm, mmoe, ple and mmoe --census on
                files written there (1 epoch each); each prints its result
                line and launches exactly what its path holds.
24c. protocol seq -- the protocol runner's sasrec (drift 2.0, its rows from
                the native builder, counted), seqret, mind and dssm modes at
                full widths, users cut to 20,000, one epoch each: each prints
                its JSON line, launches the kernels of its path and no
                other, and reports metrics in [0, 1].
24d. multitask -- ESMM, MMoE and PLE at protocol multitask's widths on
                200,000 realistic_multitask rows, one epoch each, head AUCs,
                a request and one more step against the CPU; MMoE and PLE on
                census rows (20,000 train) through the CSV files and the
                loader; no kernel launched.
24e. protocol mt -- the runner's ncf and din (5,000 users; ncf 2 epochs, din
                1), multitask (100,000 rows) and census (20,000 rows) modes,
                1 epoch: each prints its JSON line, launches no kernel and
                reports metrics in [0, 1].  A line gives the seconds of
                16d, 16e, 24d, 24e and the new cli tasks.
24f. files   -- the file-fed training path on Criteo files written from
                the seed (two TSVs of 131,072 rows, one of 65,536 held
                out, a 20,000-row CSV with a header): parse_criteo against
                its 8192-row chunks and the first 1000 rows against a
                Python parse with a Python FNV-1a; cli ctr --model dlrm
                --bf16 --embed-dim 16 --data GLOB --stream
                --embedding-optimizer fused_adam (26 tables of 2^20 x 16,
                batch 4096, one epoch, the native host prep at chunk
                length 1, its arrays pinned), its first 3 steps held
                against the plain step, #1 and #4 counted, steps a second;
                prep ms, the prep's bytes and copy ms, a traced step's
                split, #4 alone against its bound on f32 and bf16 tables
                (three bf16 tables against the plain version); the
                streaming evaluate_auc over the held-out file against the
                array path (within 1e-6, above 0.6); the same model with
                rowwise_adagrad and lazy_adam, 3 steps each against the
                CPU in lockstep, rows outside each batch bit-unchanged,
                step ms; fused_rowwise_adagrad fit over 3 batches (#5
                counted); at 2^16 buckets a fit with checkpoint_path and
                log_jsonl, restore, predictions and the next step's
                loss and dense state bit-equal to the saved trainer's;
                cli ctr --model deepfm --data CSV (#6), ncf --ratings,
                match --ml100k, sasrec --ratings.
                Its seconds go on the slice seconds line.
24g. multidevice -- (a) NCCL at world size 1: the bench DLRM (batch 16384,
                26 tables of 100k x 16, bf16, 4 microbatches, fused Adam)
                three steps through the a2a and psum engines on the (1, 1)
                mesh against the gather engine's steps there, and
                cli ctr --model dlrm --bf16 --embedding-optimizer fused_adam
                --embedding-engine a2a, then psum, one epoch of 4096-row
                batches.  (b) gloo ranks spawned on this one card (CUDA
                tensors staged through the host): worlds of 2 ((2, 1)
                under both contracts, (1, 2)) and 4 ((2, 2) under both,
                fused Adam and rowwise AdaGrad), three bench steps each,
                in bf16 and in f32, against one rank stepping the same
                microbatch rows (the first step's moments within 1e-5)
                and the bench's (losses within 1e-3), every
                rank's launches counted (#4 with 2 streams and in shard
                windows, #5 both at once); every engine's lookup of a
                16384 x 26 batch bit-equal to the gather and its gradient
                the scatter-add; topk_scores_sharded against the whole
                catalog's top-k (#10 on each shard); a save_sharded /
                restore_sharded round trip, refused on a changed mesh.
                (c) #4 and #5 with 2 streams, in a shard window and both,
                against their plain versions, and timed at the mesh
                steps' shapes.  Its (b) times are one-card gloo times,
                not NCCL or several cards'; its seconds go on the slice
                seconds line.
24h. tools   -- the measuring tools at the bench shapes: tools/roofline.py
                (each phase of the DLRM step alone against its H100 bound,
                and Trainer.train_step with fused Adam), tools/dense_probe.py
                (the achievable bf16 rate, the dense tail's 24 matmuls,
                its composition floor, the levers), a cut
                tools/kernel_sweep.py (#1 and #6 as train steps at B = 4096,
                F = 26 and 128, D = 16 and 128; #10 at 1024 queries over
                100,000 and 1,000,000 items, D = 64, each beside its torch
                routes), each launch of #1, #4, #6 and #10 counted;
                tools/comm_bytes.py and tools/skew_capacity.py on a (2, 2)
                world of gloo ranks, their counts on the card equal to the
                same ranks' on the CPU; comm_bytes at world size 1 and
                tools/scaling.py at one rank, under NCCL.  Its seconds go
                on the slice seconds line.
25. kernels  -- the total time, then one line naming every kernel with its
                launches and times.

The last line is {"ok": true, "device": {...}}.  Any failed check raises, and
the script exits non-zero; with no card it exits non-zero before any phase.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import functools
import itertools
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from recsys_tpu_torch.tools.roofline import cuda_ms  # imports torch only when called

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and bf16 tensor
# cores.  A card below 700 W runs under them.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
# TF32 tensor cores.  The flash kernels keep f32 accuracy by splitting each
# operand into two TF32 parts, three TF32 products for each f32 product: their
# bound counts 3 x the operations at this rate (the CUDA-core bound beside it
# as f32_core_bound_ms).
TF32_FLOPS = 495e12

BATCH = 16384          # one request, the bench batch
MICROBATCH = 4         # dense_microbatch: 4096-row slices reach the kernels
VOCAB = 100_000
NUM_SPARSE = 26
NUM_DENSE = 13
EMBED_DIM = 16
BOTTOM = (512, 256, EMBED_DIM)
TOP = (1024, 1024, 512, 256)
REQUESTS = 3
TAIL = 5000            # ragged last request
TRAIN_STEPS = 10       # one fit epoch
LR = 1e-3
UPDATE_BLOCK = 512     # table rows per embedding-update block (host prep too)
UPDATE_CH = 256        # the JAX package's chunk length (the TPU's MXU width)

# Tolerances, kernel against plain version on the same card:
# - dot interaction: both sum D exact products in f32, in another order.
DOT_TOL = dict(rtol=1e-4, atol=1e-4)
# - MLP, exact f32: up to 1024-term f32 sums in another order per layer.
MLP_F32_TOL = dict(rtol=1e-4, atol=1e-4)
# - MLP, bf16: a sum in another order can round a hidden value to the
#   neighbouring bf16 (2^-8 relative), which reaches the output as a few
#   bf16 ulps of outputs of order 1.
MLP_BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# - DLRM logits: the bf16 top tower after a kernel's f32-order change, as
#   for the bf16 MLP.
LOGIT_TOL = dict(rtol=3e-2, atol=3e-2)
# - MLP backward (mlp_bwd_check.py states the limits and why): bit for bit
#   on integer values, where every sum is exact; on random weights, dx as
#   the MLP above, on the rows away from a relu kink, and each dW and db
#   within 1e-4 of the magnitudes of its terms (f32) or by its relative
#   norm error (bf16).
# - Embedding updates: the same values summed in another order (shared-
#   memory atomics), the tolerances of tests/test_streaming_embed.py: table
#   and Adam moments at step 3 from a random state; the AdaGrad
#   accumulator; a bf16 table is one bf16 rounding of the f32 result.
ADAM_TOL = dict(rtol=2e-4, atol=1e-7)
ACC_TOL = dict(rtol=1e-4, atol=1e-9)
ADAGRAD_P_TOL = dict(rtol=1e-3, atol=2e-7)
BF16_TABLE_TOL = dict(rtol=8e-3, atol=1e-6)
# - One train step, kernels against plain versions from the same state:
#   the loss is a mean of per-example losses of logits held to LOGIT_TOL.
#   After ten steps of history one Adam step moves a cell by at most about
#   lr, and a gradient that differs by bf16 roundings moves it by a small
#   share of that: cells of the dense params and tables may differ by more
#   than lr/10 in at most 1% of a tensor.  Optimizer state: m (and the
#   AdaGrad accumulator) take 10% (or all) of one gradient whose bf16
#   roundings may differ; v squares it: at most 0.1% of cells outside
#   rtol 3e-2 (m) or 6e-2 (v, acc).
STEP_P_THRESH, STEP_P_SHARE = LR / 10, 1e-2
STEP_STATE_TOL = {"m": dict(rtol=3e-2, atol=1e-9), "v": dict(rtol=6e-2, atol=1e-12),
                  "acc": dict(rtol=6e-2, atol=1e-12)}
STEP_STATE_SHARE = 1e-3
#   The dense params' Adam first moment, whose step adds 10% of the
#   gradient: per tensor, the norm of the difference over the norm.
STEP_MOMENT_RTOL = 1e-2
#   The same step on the card and on the CPU (the files phase's
#   touched-rows kinds): the two devices' bf16 roundings compound down the
#   backward, from 0.4% of the norm at the top tower's last layers to 1.7%
#   at the bottom tower's first (read on an H100 80GB HBM3 at 700 W); a
#   gradient 20% short reads 0.2.
CROSS_MOMENT_RTOL = 5e-2

# SASRec at the bench.py widths (bench.py:258-315)
SAS_ITEMS = 50_000
SAS_DIM = 64
SAS_BLOCKS = 2
SAS_HEADS = 2
SAS_LEN = 512
SAS_LONG = 2048
SAS_BATCH = 256
SAS_NEGS = 20           # serving: the positive ranked among 20 negatives
SAS_REQUESTS = 3
SAS_TAIL = 100
SAS_STEPS = 5           # one fit epoch at max_len 512
SAS_LONG_STEPS = 3      # and at 2048
SAS_LONG_CHECK = 16     # rows of the 2048 step held against the plain step
# SASRec tolerances, kernels against plain versions, all exact f32: the
# attention's sums in another order (flash_check.py) carried through two
# blocks, 1e-4 on logits and the loss; one Adam step from the same state,
# as for DLRM but f32: at most 0.1% of the cells of a tensor more than
# lr/10 apart (a gradient within rounding of zero can flip its step), and
# the first moment within 1e-3 in relative norm while a 20% short gradient
# must read more.
SAS_LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SAS_P_SHARE = 1e-3
SAS_MOMENT_RTOL = 1e-3

# YoutubeDNN at the protocol seqret widths (recsys_tpu/tools/protocol.py:
# 244-296, defaults :738-744 and :791-793)
YOUTUBE_USERS = 20_000   # the protocol's 100,000, cut: data generation stays short
YOUTUBE_ITEMS = 20_000
YOUTUBE_DIM = 32
YOUTUBE_HIDDEN = (128, 64)
YOUTUBE_MAXLEN = 50
YOUTUBE_POOLING = "mean"
YOUTUBE_BLOCK = 8192     # run_seqret's serving block
YOUTUBE_K = 10
YOUTUBE_BATCH = 1024
YOUTUBE_STEPS = 100      # from the head of the shuffled train set
YOUTUBE_SWEEP = (1024, 1_000_000, 64)  # tools/kernel_sweep.py:98-102
# the kernels' geometry checks: pooled-gather history lengths and widths;
# top-k (queries, items or None for k + 1, width)
POOL_GEOMETRY_L = (1, 31, 32, 33, 50, 64, 65, 200)
POOL_GEOMETRY_D = (4, 12, 32, 33, 128, 130)
TOPK_GEOMETRY = ((300, None, 32), (1000, 5000, 4), (1000, 5000, 12), (1000, 5000, 64),
                 (1000, 5000, 124), (1000, 5000, 128))
# The user vectors, kernels against plain versions: unit vectors from a
# 50-term pooled mean (sums in another order) through three f32 layers.
# One train step is held as SASRec's (all f32).  The kernels' own limits
# are retrieval_check.py's.
YOUTUBE_EMB_TOL = dict(rtol=1e-5, atol=1e-5)

# The CTR protocol (recsys_tpu/tools/protocol.py:44-147, defaults :720-790):
# realistic_criteo's 26 fields at the Criteo vocabularies (1,175,204 rows
# of D = 16 in all), 13 dense features, batch 512, Adam lr 1e-3
CTR_REQUEST = 4096       # Trainer.predict's and evaluate_auc's batch
CTR_REQUESTS = 3
CTR_TAIL = 1000          # ragged last request
CTR_BATCH = 512
CTR_ROWS = 200_000       # the protocol's 1,000,000, cut: the phase stays short
CTR_AUC_FLOOR = 0.55     # the oracle is about 0.835
CTR_STEP_MODELS = ("fm", "deepfm", "autoint")
# Card against CPU, f32: sums in another order through an MLP or three
# attention layers, as SASRec's 1e-4; DLRM computes in bf16 (LOGIT_TOL).
CTR_LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def errors(got, want) -> dict:
    diff = (got.double() - want.double()).abs()
    rel = diff / want.double().abs().clamp_min(1e-6)
    return {"max_abs_err": float(diff.max()), "max_rel_err": float(rel.max())}


def check_close(name: str, got, want, tol: dict) -> dict:
    import torch

    err = errors(got, want)
    bad = ~torch.isclose(got.double(), want.double(), **tol) | ~torch.isfinite(got)
    ok = got.shape == want.shape and not bool(bad.any())
    emit({"phase": "check", "case": name, **err, **tol, "ok": ok})
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {err}")
    return err


def mlp_weights(rng, dims):
    ws = [(rng.standard_normal((a, b), dtype=np.float32) / np.float32(np.sqrt(a)))
          for a, b in zip(dims, dims[1:])]
    bs = [rng.standard_normal(b, dtype=np.float32) * np.float32(0.01) for b in dims[1:]]
    return ws, bs


def bound(bytes_moved: float, operations: float, peak_ops: float) -> tuple[float, str]:
    """Least ms the card could take, and which of the two sets it."""
    by, op = bytes_moved / HBM_BYTES_PER_S, operations / peak_ops
    return max(by, op) * 1e3, "bytes" if by >= op else "operations"


def mlp_work(b, dims) -> tuple[float, float]:
    """(bytes, operations) of one fused MLP call: x and the output once,
    every f32 weight and bias once."""
    n_w = sum(a * c + c for a, c in zip(dims, dims[1:]))
    return ((b * dims[0] + b * dims[-1] + n_w) * 4,
            2 * b * sum(a * c for a, c in zip(dims, dims[1:])))


def mlp_bwd_work(b, dims) -> tuple[float, float]:
    """(bytes, operations) of one fused MLP backward: x, g and dx once,
    every f32 weight and bias read and its gradient written once; the
    hidden layers recomputed (all but the last layer) plus dx and dW."""
    w = [a * c for a, c in zip(dims, dims[1:])]
    n_w = sum(wi + c for wi, c in zip(w, dims[1:]))
    return ((2 * b * dims[0] + b * dims[-1] + 2 * n_w) * 4,
            2 * b * sum(w[:-1]) + 4 * b * sum(w))


def phase_card() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = {"phase": "card", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(card)
    return card


def phase_build() -> None:
    from recsys_tpu_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.libraries()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs), "flags": " ".join(build.NVCC_FLAGS)})


def phase_check(rng, dev) -> dict:
    """Every kernel against its plain version; returns the worst abs error
    of each kernel at the serving dtype (bf16)."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels.interactions import dot_in_domain, dot_interaction
    from recsys_tpu_torch.kernels.mlp import mlp_forward

    worst = {"dot_interaction": 0.0, "mlp_fwd": 0.0}
    f = NUM_SPARSE + 1
    for b in (BATCH // MICROBATCH, 1000):
        x32 = torch.from_numpy(
            rng.standard_normal((b, f, EMBED_DIM), dtype=np.float32) * np.float32(0.5)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for si in (False, True):
                err = check_close(f"dot_interaction b={b} {dtype} self={si}",
                                  dispatch.dot_interaction(x, si),
                                  dot_interaction(x, si), DOT_TOL)
                if dtype == torch.bfloat16 and not si:
                    worst["dot_interaction"] = max(worst["dot_interaction"], err["max_abs_err"])
    # the other layouts: one field (with the diagonal), two, a row width
    # that is not whole float4s, 64 fields, and the widest F the kernel
    # takes at D = 128 with the diagonal (dot_in_domain's edge), on the
    # tensor cores in bf16; ragged batches, and an input 4 bytes into its
    # storage (not 16-byte aligned: the CUDA cores)
    widest = max(f_ for f_ in range(2, 400) if dot_in_domain(f_, 128, True))
    for b, f_, d, offset in ((7, 1, 8, 0), (33, 2, 36, 0), (513, 27, 1, 0), (1001, 64, 8, 1),
                             (1001, 64, 32, 0), (65, widest, 128, 0)):
        storage = torch.from_numpy(rng.standard_normal(b * f_ * d + offset, dtype=np.float32)
                                   * np.float32(0.5)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = storage.to(dtype)[offset:].view(b, f_, d)
            for si in (False, True) if f_ > 1 else (True,):
                check_close(f"dot_interaction b={b} f={f_} d={d} offset={offset} {dtype} "
                            f"self={si}", dispatch.dot_interaction(x, si),
                            dot_interaction(x, si), DOT_TOL)
    top_in = EMBED_DIM + f * (f - 1) // 2
    for name, dims in (("bottom", [NUM_DENSE, *BOTTOM, EMBED_DIM]),
                       ("top", [top_in, *TOP, 1])):
        ws, bs = mlp_weights(rng, dims)
        tw = [torch.from_numpy(w).to(dev) for w in ws]
        tb = [torch.from_numpy(v).to(dev) for v in bs]
        for b in (BATCH // MICROBATCH, 1000):
            x = torch.from_numpy(rng.random((b, dims[0]), dtype=np.float32)).to(dev)
            for mm_bf16 in (False, True):
                err = check_close(
                    f"mlp_fwd {name} b={b} mm_bf16={mm_bf16}",
                    dispatch.fused_mlp_forward(x, tw, tb, mm_bf16),
                    mlp_forward(x, tw, tb, mm_bf16),
                    MLP_BF16_TOL if mm_bf16 else MLP_F32_TOL)
                if mm_bf16:
                    worst["mlp_fwd"] = max(worst["mlp_fwd"], err["max_abs_err"])
    worst["mlp_bwd"] = check_mlp_bwd(rng, dev)
    worst.update(check_embedding_update(rng, dev))
    torch.cuda.synchronize()
    return worst


def check_mlp_bwd(rng, dev) -> float:
    """fused_mlp_backward against mlp_backward for both towers at 4096 and
    1000 rows, f32 and bf16, in the two checks of mlp_bwd_check.py: on
    integer values bit for bit, where a dW scaled by 0.9, missing one
    32-row step of its batch sum or missing the first of kernel B's batch
    slices (dispatch.mlp_bwd_split) must not pass; and on random weights, dW
    and db to a share of their terms (f32) or by their norm (bf16), with
    the distance of the kernel and of the plain version from the same chain
    summed in float64.  Returns the worst dx abs error in bf16 on random
    weights."""
    import torch

    import mlp_bwd_check as chk
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels.mlp import mlp_backward

    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    worst = 0.0
    f = NUM_SPARSE + 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, dims in (("bottom", [NUM_DENSE, *BOTTOM, EMBED_DIM]),
                       ("top", [EMBED_DIM + f * (f - 1) // 2, *TOP, 1])):
        ws, bs = mlp_weights(rng, dims)
        tw = [to(w) for w in ws]
        tb = [to(v[None]) for v in bs]
        for b in (BATCH // MICROBATCH, 1000):
            split, rows = dispatch.mlp_bwd_split(dims, b, sms)
            xe, ge, we, be = chk.exact_case(rng, b, dims)
            xe, ge, we, be = to(xe), to(ge), [to(w) for w in we], [to(v) for v in be]
            top = chk.largest_term_sum(xe, ge, we, be)
            for mm_bf16 in (False, True):
                case = f"mlp_bwd {name} b={b} mm_bf16={mm_bf16}"
                got = dispatch.fused_mlp_backward(xe, ge, we, be, mm_bf16)
                want = mlp_backward(xe, ge, we, be, mm_bf16)
                same = all(torch.equal(u, v) for u, v in
                           zip([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]))
                step = mlp_backward(xe[:32], ge[:32], we, be, mm_bf16)[1]
                first = mlp_backward(xe[:rows], ge[:rows], we, be, mm_bf16)[1]
                caught = all(not torch.equal(0.9 * u, v) and not torch.equal(u - s32, v)
                             and not torch.equal(u - sl, v)
                             for u, v, s32, sl in zip(got[1], want[1], step, first))
                ok = same and caught and top < chk.EXACT_LIMIT
                emit({"phase": "check", "case": case + " integer values", "bit_equal": same,
                      "wrong_dw_caught": caught, "dw_slices": [split, rows],
                      "largest_term_sum": top, "exact_below": chk.EXACT_LIMIT, "ok": ok})
                if not ok:
                    raise AssertionError(f"{case}: not bit-equal to the plain version on "
                                         "integer values, or a wrong dW passes")

            x = torch.from_numpy(rng.random((b, dims[0]), dtype=np.float32)).to(dev)
            g = torch.from_numpy(rng.standard_normal((b, dims[-1]), dtype=np.float32)).to(dev)
            # rows at a relu kink may differ by O(1) between two correct sums
            keep = chk.kink_free_rows(x, tw, tb)
            x, g = x[keep].contiguous(), g[keep].contiguous()
            sw, sb = chk.term_scales(x, g, tw, tb)
            for mm_bf16 in (False, True):
                tol = MLP_BF16_TOL if mm_bf16 else MLP_F32_TOL
                got = dispatch.fused_mlp_backward(x, g, tw, tb, mm_bf16)
                want = mlp_backward(x, g, tw, tb, mm_bf16)
                exact = chk.f64_chain(x, g, tw, tb, mm_bf16)
                case = f"mlp_bwd {name} b={b} mm_bf16={mm_bf16}"
                err = check_close(case + " dx", got[0], want[0], tol)
                if mm_bf16:
                    worst = max(worst, err["max_abs_err"])
                norm = lambda res, ref: max(chk.norm_err(u, v) for u, v in  # noqa: E731
                                            zip(res[1] + res[2], ref[1] + ref[2]))
                step = mlp_backward(x[:32], g[:32], tw, tb, mm_bf16)[1]
                kept_rows = dispatch.mlp_bwd_split(dims, x.shape[0], sms)[1]
                first = mlp_backward(x[:kept_rows], g[:kept_rows], tw, tb, mm_bf16)[1]
                line = {"phase": "check", "case": case + " dW db",
                        "worst_norm_err": norm(got, want),
                        "kernel_vs_f64_chain_norm_err": norm(got, exact),
                        "plain_vs_f64_chain_norm_err": norm(want, exact),
                        "kernel_vs_f64_chain_q999_over_terms": max(
                            chk.q999_over_terms(u, v, sc) for u, v, sc in
                            zip(got[1] + got[2], exact[1] + exact[2], sw + sb)),
                        "plain_vs_f64_chain_q999_over_terms": max(
                            chk.q999_over_terms(u, v, sc) for u, v, sc in
                            zip(want[1] + want[2], exact[1] + exact[2], sw + sb)),
                        "dw_32_rows_left_out_least_norm_err": min(
                            chk.norm_err(u - s32, v) for u, v, s32 in zip(got[1], want[1], step)),
                        "dw_first_slice_left_out_least_norm_err": min(
                            chk.norm_err(u - sl, v) for u, v, sl in zip(got[1], want[1], first)),
                        "rows_at_a_kink_left_out": b - int(keep.sum())}
                if mm_bf16:
                    line["norm_limit"] = chk.BF16_NORM_RTOL
                    ok = line["worst_norm_err"] <= chk.BF16_NORM_RTOL
                else:
                    line.update(chk.F32_TERM_TOL, of="term sum", share_outside=max(
                        chk.f32_outside(u, v, sc) for u, v, sc in
                        zip(got[1] + got[2], want[1] + want[2], sw + sb)))
                    ok = line["share_outside"] == 0.0
                ok &= all(bool(torch.isfinite(u).all()) for u in got[1] + got[2])
                emit({**line, "ok": ok})
                if not ok:
                    raise AssertionError(f"{case}: dW/db disagree with the plain version")
    return worst


def embedding_inputs(rng, dev, vocab, skewed, block, d=EMBED_DIM, one_id=False,
                     ch=UPDATE_CH):
    """One table's update inputs for a 16384-id batch: the cotangent rows
    sorted by host prep at chunk length ``ch``, their ids and chunk
    pointers, and a random table and optimizer state (as if after a few
    steps).  ``one_id``: every id the same row."""
    import torch

    from recsys_tpu_torch.train.streaming_embed import host_prep_group

    if one_id:
        ids = np.full(BATCH, vocab // 3, np.int32)
    elif skewed:  # Zipf-like: a few hot ids take most occurrences
        ids = np.minimum(rng.zipf(1.2, BATCH) - 1, vocab - 1).astype(np.int32)
    else:
        ids = rng.integers(0, vocab, BATCH).astype(np.int32)
    ids2d, idx, cptr = host_prep_group(ids, vp=vocab, block=block, ch=ch)
    cot = (rng.standard_normal((BATCH, d)) * 1e-2).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return {
        "cot": to(cot[idx]), "ids2d": to(ids2d), "cptr": to(cptr),
        "p": to(rng.uniform(-0.05, 0.05, (vocab, d)).astype(np.float32)),
        "m": to((rng.standard_normal((vocab, d)) * 1e-3).astype(np.float32)),
        "v": to(rng.uniform(1e-8, 1e-4, (vocab, d)).astype(np.float32)),
        "acc": to(rng.uniform(0, 1e-4, vocab).astype(np.float32)),
    }


def check_embedding_update(rng, dev) -> dict:
    """The fused embedding updates against their plain versions on one
    bench-size table, at the JAX chunk length and at the port's; returns
    the worst table error of each at the main path's settings (f32 table,
    bf16 sums, no decay)."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels import embedding_update as emb_ref
    from recsys_tpu_torch.train.streaming_embed import PREP_CH

    worst = {"embedding_adam": 0.0, "embedding_rowwise_adagrad": 0.0}
    # (skewed ids, table dtype, mm_bf16, weight decay, block): the last has
    # a ragged last block (100000 = 260 * 384 + 160)
    cases = [(False, torch.float32, True, 0.0, UPDATE_BLOCK),
             (True, torch.float32, True, 0.0, UPDATE_BLOCK),
             (False, torch.bfloat16, True, 0.01, UPDATE_BLOCK),
             (True, torch.bfloat16, False, 0.0, UPDATE_BLOCK),
             (False, torch.float32, False, 0.01, UPDATE_BLOCK),
             (True, torch.float32, True, 0.01, 384)]
    for (skewed, p_dtype, mm_bf16, wd, block), ch in itertools.product(
            cases, (UPDATE_CH, PREP_CH)):
        a = embedding_inputs(rng, dev, VOCAB, skewed, block, ch=ch)
        p = a["p"].to(p_dtype)
        name = (f"{'skewed' if skewed else 'uniform'} p={str(p_dtype)[6:]} "
                f"mm_bf16={mm_bf16} wd={wd} block={block} ch={ch}")
        main = p_dtype == torch.float32 and mm_bf16 and wd == 0.0
        p_tol = BF16_TABLE_TOL if p_dtype == torch.bfloat16 else None
        got = [p.clone(), a["m"].clone(), a["v"].clone()]
        want = [p.clone(), a["m"].clone(), a["v"].clone()]
        dispatch.fused_embedding_adam(*got, a["cot"], a["ids2d"], a["cptr"], 3, block=block,
                                      lr=LR, wd=wd, mm_bf16=mm_bf16)
        emb_ref.fused_adam(*want, a["cot"], a["ids2d"], a["cptr"], 3, block=block, lr=LR,
                           wd=wd, mm_bf16=mm_bf16)
        for key, u, v in zip("pmv", got, want):
            err = check_close(f"embedding_adam {name} {key}", u.float(), v.float(),
                              (p_tol or ADAM_TOL) if key == "p" else ADAM_TOL)
            if main and key == "p":
                worst["embedding_adam"] = max(worst["embedding_adam"], err["max_abs_err"])
        got, want = [p.clone(), a["acc"].clone()], [p.clone(), a["acc"].clone()]
        dispatch.fused_embedding_rowwise_adagrad(*got, a["cot"], a["ids2d"], a["cptr"],
                                                 block=block, lr=LR, wd=wd, mm_bf16=mm_bf16)
        emb_ref.fused_rowwise_adagrad(*want, a["cot"], a["ids2d"], a["cptr"], block=block,
                                      lr=LR, wd=wd, mm_bf16=mm_bf16)
        err = check_close(f"embedding_rowwise_adagrad {name} p", got[0].float(),
                          want[0].float(), p_tol or ADAGRAD_P_TOL)
        check_close(f"embedding_rowwise_adagrad {name} acc", got[1], want[1], ACC_TOL)
        if main:
            worst["embedding_rowwise_adagrad"] = max(worst["embedding_rowwise_adagrad"],
                                                     err["max_abs_err"])
    # Adam's other layouts: a pass of unequal tables in one launch (a
    # bench table, a ragged small one, one of 37 rows in blocks of 16, one
    # no id touches, one of no rows), single values at D = 12 and on a table
    # 4 bytes into its storage
    tabs = [embedding_inputs(rng, dev, v, False, blk) for v, blk in
            ((VOCAB, UPDATE_BLOCK), (1000, 96), (37, 16), (5000, UPDATE_BLOCK))]
    tabs[3]["ids2d"].fill_(emb_ref.num_blocks(5000, UPDATE_BLOCK) * UPDATE_BLOCK)
    tabs[3]["cptr"].zero_()  # every slot the sentinel, every block no chunk
    tabs.append(dict(tabs[2], cptr=tabs[2]["cptr"][:1].clone(),
                     **{k: tabs[0][k][:0] for k in ("p", "m", "v")}))
    blocks = [UPDATE_BLOCK, 96, 16, UPDATE_BLOCK, 16]
    got = [[a[k].clone() for a in tabs] for k in "pmv"]
    want = [[a[k].clone() for a in tabs] for k in "pmv"]
    before = dispatch.LAUNCHES["embedding_adam"]
    cols = [[a[k] for a in tabs] for k in ("cot", "ids2d", "cptr")]
    dispatch.fused_embedding_adam_pass(*got, *cols, 3, blocks=blocks, lr=LR)
    if dispatch.LAUNCHES["embedding_adam"] != before + 1:
        raise AssertionError("embedding_adam pass: not one launch")
    for t, block in enumerate(blocks):
        emb_ref.fused_adam(*(w[t] for w in want), *(c[t] for c in cols), 3, block=block,
                           lr=LR)
        for key, u, v in zip("pmv", got, want):
            if u[t].numel():  # the table of no rows has nothing to hold
                check_close(f"embedding_adam pass table {t} {key}", u[t], v[t], ADAM_TOL)
    for d, offset in ((12, 0), (EMBED_DIM, 1)):
        a = embedding_inputs(rng, dev, VOCAB, True, UPDATE_BLOCK, d=d)
        storage = torch.empty(VOCAB * d + offset, device=dev)
        p = storage[offset:].view(VOCAB, d)
        p.copy_(a["p"])
        got, want = [p, a["m"].clone(), a["v"].clone()], [p.clone(), a["m"], a["v"]]
        dispatch.fused_embedding_adam(*got, a["cot"], a["ids2d"], a["cptr"], 3,
                                      block=UPDATE_BLOCK, lr=LR)
        emb_ref.fused_adam(*want, a["cot"], a["ids2d"], a["cptr"], 3, block=UPDATE_BLOCK,
                           lr=LR)
        for key, u, v in zip("pmv", got, want):
            check_close(f"embedding_adam D={d} offset={offset} {key}", u, v, ADAM_TOL)
    # rowwise AdaGrad's other layouts: 32 lanes a row at D = 128 (blocks of
    # 256 rows, a 128 KB tile past 48 KB), a warp a row at D = 12 and on a
    # table 4 bytes into its storage, and 16384 occurrences of one row
    for d, block, offset, one_id in ((128, 256, 0, False), (12, UPDATE_BLOCK, 0, False),
                                     (EMBED_DIM, UPDATE_BLOCK, 1, False),
                                     (EMBED_DIM, UPDATE_BLOCK, 0, True)):
        a = embedding_inputs(rng, dev, VOCAB, False, block, d=d, one_id=one_id)
        storage = torch.empty(VOCAB * d + offset, device=dev)
        p = storage[offset:].view(VOCAB, d)
        p.copy_(a["p"])
        name = f"D={d} block={block} offset={offset} one_id={one_id}"
        got, want = [p, a["acc"].clone()], [p.clone(), a["acc"].clone()]
        dispatch.fused_embedding_rowwise_adagrad(*got, a["cot"], a["ids2d"], a["cptr"],
                                                 block=block, lr=LR)
        emb_ref.fused_rowwise_adagrad(*want, a["cot"], a["ids2d"], a["cptr"], block=block,
                                      lr=LR)
        check_close(f"embedding_rowwise_adagrad {name} p", got[0], want[0], ADAGRAD_P_TOL)
        check_close(f"embedding_rowwise_adagrad {name} acc", got[1], want[1], ACC_TOL)
    return worst


def phase_f4(rng, dev) -> dict:
    """The routes of shapes outside a kernel's domain, each on the card
    against the same call on the CPU, with the launch counts zeroed just
    before and read just after: none may count a launch.  AutoInt at D = 8
    (two heads of width 4): a request and a train step; multi-head
    attention at head width 12, forward and gradients; DotInteraction at
    F = 80, D = 800, forward and gradient; top-k at D = 1024 through both
    retrieval functions (retrieval_check's near-tie rules, and the CPU's
    scores)."""
    import torch

    import retrieval_check as rc
    from recsys_tpu_torch.data.realistic import realistic_criteo
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels import interactions as int_ref
    from recsys_tpu_torch.ops.attention import MultiHeadAttention
    from recsys_tpu_torch.ops.interactions import DotInteraction
    from recsys_tpu_torch.train import retrieval
    from recsys_tpu_torch.train.loop import Trainer

    res = {}

    def no_launch(name):
        if any(dispatch.LAUNCHES.values()):
            raise AssertionError(f"f4 {name}: the route launched {dispatch.LAUNCHES}")

    # AutoInt at D = 8: a request and a step, the card against the CPU
    schema, data, _ = realistic_criteo(num_examples=2 * CTR_BATCH, embed_dim=8, seed=3)
    batch = {k: v[:CTR_BATCH] for k, v in data.items()}
    model = ctr_model_from_jax(rng, "autoint", schema)
    ref = Trainer(copy.deepcopy(model), device="cpu")
    trainer = Trainer(model)
    dispatch.reset_launches()
    got = trainer.predict(batch, batch_size=CTR_BATCH)
    loss_k = trainer.train_step(batch)
    torch.cuda.synchronize()
    no_launch("autoint D=8")
    want = ref.predict(batch, batch_size=CTR_BATCH)
    res["autoint_d8_logits"] = check_close("f4 autoint D=8 logits", torch.from_numpy(got),
                                           torch.from_numpy(want), CTR_LOGIT_TOL)
    res["autoint_d8_step"] = compare_sasrec_step("autoint D=8", trainer, ref, loss_k,
                                                 ref.train_step(batch), label="f4")

    # attention at head width 12, causal, some rows with no key
    torch.manual_seed(0)
    mha = MultiHeadAttention(24, 2, causal=True)
    mask = torch.from_numpy(rng.random((64, 50)) > 0.3)
    mask[:8] = False
    x = torch.from_numpy(rng.standard_normal((64, 50, 24), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 50, 24), dtype=np.float32))
    outs = {}
    for where in ("cpu", dev):
        m = copy.deepcopy(mha).to(where)
        xi = x.detach().to(where).requires_grad_()
        dispatch.reset_launches()
        out = m(xi, mask=mask.to(where))
        (out * w.to(where)).sum().backward()
        if where != "cpu":
            torch.cuda.synchronize()
            no_launch("attention head width 12")
        outs[str(where)] = [out.detach(), xi.grad, *(q.grad for q in m.parameters())]
    for i, (u, v) in enumerate(zip(outs[str(dev)], outs["cpu"])):
        err = check_close(f"f4 attention head width 12 {'out' if i == 0 else f'grad {i}'}",
                          u.cpu(), v, SAS_LOGIT_TOL)
        res.setdefault("attention_w12", err)

    # DotInteraction past the kernel's shared memory
    f_, d = 80, 800
    assert not int_ref.dot_in_domain(f_, d, False)
    x = torch.from_numpy(rng.standard_normal((64, f_, d), dtype=np.float32) * np.float32(0.3))
    g = torch.from_numpy(rng.standard_normal((64, f_ * (f_ - 1) // 2), dtype=np.float32))
    outs = {}
    for where in ("cpu", dev):
        xi = x.detach().to(where).requires_grad_()
        dispatch.reset_launches()
        out = DotInteraction()(xi)
        (out * g.to(where)).sum().backward()
        if where != "cpu":
            torch.cuda.synchronize()
            no_launch("dot F=80 D=800")
        outs[str(where)] = (out.detach(), xi.grad)
    res["dot_f80_d800"] = check_close("f4 dot F=80 D=800 out", outs[str(dev)][0].cpu(),
                                      outs["cpu"][0], DOT_TOL)
    check_close("f4 dot F=80 D=800 grad", outs[str(dev)][1].cpu(), outs["cpu"][1], DOT_TOL)

    # top-k at D = 1024
    q, items, dup = rc.topk_inputs(rng, 512, 5000, 1024, dev)
    for fn in (retrieval.topk_scores, retrieval.topk_scores_streaming):
        dispatch.reset_launches()
        r = rc.check_topk(q, items, 10, fn, dup)
        torch.cuda.synchronize()
        no_launch(f"{fn.__name__} D=1024")
        v_cpu, _ = fn(q.cpu(), items.cpu(), 10)
        v, _ = fn(q, items, 10)
        r["cpu_within"] = bool(((v.cpu() - v_cpu).abs() <= rc.score_limit(q, items).cpu()).all())
        emit({"phase": "check", "case": f"f4 {fn.__name__} D=1024", **r})
        if not (r["ok"] and r["cpu_within"]):
            raise AssertionError(f"f4 {fn.__name__} D=1024: {r}")
        res[f"{fn.__name__}_d1024"] = r
    emit({"phase": "f4", "routes": sorted(res)})
    del model, trainer, ref
    torch.cuda.empty_cache()
    return res


def jax_layout_params(rng) -> dict:
    """Bench-width DLRM weights in the JAX package's layout: row-packed
    tables, and both towers as MLP (Dense_i kernel (in, out), bias) and as
    FusedMLP (kernel_i, bias_i (1, out)) holding the same numbers."""
    from recsys_tpu_torch.convert import _pad8, pack_factor

    p = pack_factor(EMBED_DIM, VOCAB)
    rows = _pad8(-(-VOCAB // p))
    params = {"StackedEmbedding_0": {
        f"table_{g}": rng.uniform(-0.05, 0.05, (rows, p * EMBED_DIM)).astype(np.float32)
        for g in range(NUM_SPARSE)
    }}
    f = NUM_SPARSE + 1
    towers = ([NUM_DENSE, *BOTTOM, EMBED_DIM],
              [EMBED_DIM + f * (f - 1) // 2, *TOP, 1])
    for i, dims in enumerate(towers):
        ws, bs = mlp_weights(rng, dims)
        params[f"MLP_{i}"] = {f"Dense_{j}": {"kernel": w, "bias": b}
                              for j, (w, b) in enumerate(zip(ws, bs))}
        params[f"FusedMLP_{i}"] = {k: v for j, (w, b) in enumerate(zip(ws, bs))
                                   for k, v in ((f"kernel_{j}", w), (f"bias_{j}", b[None]))}
    return params


@functools.cache
def plain_mlp():
    """The fused MLP as an autograd function of its plain versions."""
    import torch

    from recsys_tpu_torch.kernels.mlp import mlp_backward, mlp_forward

    class PlainMLP(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, mm_bf16, *params):
            ctx.save_for_backward(x, *params)
            ctx.mm_bf16 = mm_bf16
            n = len(params) // 2
            return mlp_forward(x, params[:n], params[n:], mm_bf16)

        @staticmethod
        def backward(ctx, g):
            x, *params = ctx.saved_tensors
            n = len(params) // 2
            dx, dws, dbs = mlp_backward(x, g.contiguous(), params[:n], params[n:], ctx.mm_bf16)
            return (dx, None, *dws, *dbs)

    return PlainMLP


def plain_logits(model, batch):
    """The DLRM forward with every kernel replaced by its plain version,
    called explicitly (the same math the model's own forward dispatches);
    differentiable, the fused MLP's backward being its plain version too."""
    import torch

    from recsys_tpu_torch.kernels.interactions import dot_interaction
    from recsys_tpu_torch.ops.mlp import FusedMLP

    def tower(m, x):
        if isinstance(m, FusedMLP):
            ws = [getattr(m, f"kernel_{i}") for i in range(m.num_layers)]
            bs = [getattr(m, f"bias_{i}") for i in range(m.num_layers)]
            return plain_mlp().apply(x.float().contiguous(), m.mm_bf16, *ws, *bs)
        return m(x)

    fe = model.embedding(batch["sparse"]).to(model.compute_dtype)
    dense = batch["dense"]
    b = fe.shape[0]
    nm = model.dense_microbatch if b % model.dense_microbatch == 0 else 1
    bs = b // nm
    out = []
    for i in range(nm):
        bottom = tower(model.bottom, dense[i * bs:(i + 1) * bs])
        feats = torch.cat([bottom[:, None, :].to(fe.dtype), fe[i * bs:(i + 1) * bs]], 1)
        inter = dot_interaction(feats)
        top_in = torch.cat([bottom.to(inter.dtype), inter], -1)
        out.append(tower(model.top, top_in)[..., 0])
    return torch.cat(out).float()


def plain_train_step(tr, batch):
    """``Trainer.train_step`` with every kernel replaced by its plain
    version, called explicitly: the plain forward and backward, the same
    dense optimizer, and the plain embedding update of every table."""
    import torch

    from recsys_tpu_torch.kernels import embedding_update as emb_ref
    from recsys_tpu_torch.train.losses import bce_with_logits

    db = tr._to_device(dict(batch, **tr._prep(batch["sparse"])))
    tr.model.train()
    tr.step += 1
    tr.optimizer.zero_grad(set_to_none=True)
    loss = bce_with_logits(plain_logits(tr.model, db), db["label"])
    loss.backward()
    tr.optimizer.step()
    cot_all = tr.embedding.tap.grad.reshape(-1, EMBED_DIM)
    tables = tr.tables()
    with torch.no_grad():
        for g, name in enumerate(tr.plan.table_names):
            cot = cot_all.index_select(0, db[f"embaux{g}_src"]).bfloat16()
            ids2d, cptr, st = db[f"embaux{g}_ids"], db[f"embaux{g}_ptr"], tr.emb_state[name]
            block = min(UPDATE_BLOCK, tables[name].shape[0])  # as the Trainer's
            if tr.embedding_optimizer == "fused_adam":
                emb_ref.fused_adam(tables[name], st["m"], st["v"], cot, ids2d, cptr, tr.step,
                                   block=block, lr=tr.embedding_lr)
            else:
                emb_ref.fused_rowwise_adagrad(tables[name], st["acc"], cot, ids2d, cptr,
                                              block=block, lr=tr.embedding_lr)
    return loss.detach()


def profile_call(fn, classify=None) -> dict:
    """Device time by kernel over one call of ``fn`` (which must end in a
    synchronize), from torch.profiler, and the device's idle share of the
    call's wall time; with ``classify`` (kernel name -> category) also the
    device ms of each category.  ``fn`` runs once more before, untraced
    while the tracer warms up: the first device activities of a window are
    otherwise lost (a serving call's input copy and first kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
        fn()
        prof.step()
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    # a user annotation (the optimizer's "Optimizer.step#Adam.step") spans
    # kernels that are rows of their own: counting it would count them twice
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in traced[0]
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    out = {"wall_ms": wall_ms,
           "device_busy_ms": busy if rows else None,
           "idle_share": 1.0 - busy / wall_ms if rows else None,
           "device_kernels": len(rows),
           "top": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in rows[:12]]}
    if classify is not None:
        split = {}
        for k, ms, _ in rows:
            split[classify(k)] = split.get(classify(k), 0.0) + ms
        out["split_ms"] = split
    return out


def phase_serve(params, dev) -> dict:
    """Trainer.predict at bench widths, fused_mlps off and on; returns per
    configuration the launches, errors, latency and throughput."""
    import torch

    from recsys_tpu_torch.convert import params_from_jax
    from recsys_tpu_torch.data.synthetic import synthetic_ctr
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.models.ctr.dlrm import DLRM
    from recsys_tpu_torch.train.loop import Trainer

    n = REQUESTS * BATCH + TAIL
    schema, data = synthetic_ctr(num_examples=n, num_dense=NUM_DENSE,
                                 num_sparse=NUM_SPARSE, vocab_size=VOCAB,
                                 embed_dim=EMBED_DIM, seed=0)
    requests = -(-n // BATCH)  # the tail is padded to a full request
    results = {}
    for fused in (False, True):
        name = f"fused_mlps={fused}"
        model = DLRM(schema, bottom_units=BOTTOM, top_units=TOP,
                     compute_dtype=torch.bfloat16, fused_mlps=fused,
                     dense_microbatch=MICROBATCH, device=dev)
        model.load_state_dict(params_from_jax(params, schema, model))
        trainer = Trainer(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # the main path: counts zeroed just before, read just after
        dispatch.reset_launches()
        logits = trainer.predict(data, batch_size=BATCH)
        torch.cuda.synchronize()
        launches = dict(dispatch.LAUNCHES)
        expected = dict.fromkeys(launches, 0)
        expected.update({"dot_interaction": requests * MICROBATCH,
                         "mlp_fwd": 2 * requests * MICROBATCH if fused else 0})
        if launches != expected:
            raise AssertionError(f"{name}: launches {launches}, expected {expected}")
        if logits.shape != (n,) or not np.isfinite(logits).all():
            raise AssertionError(f"{name}: logits shape {logits.shape} or not finite")

        errs = []
        with torch.inference_mode():
            for lo, hi in ((0, BATCH), (REQUESTS * BATCH, n)):
                batch = {k: torch.from_numpy(data[k][lo:hi]).to(dev)
                         for k in ("sparse", "dense")}
                want = plain_logits(model, batch)
                got = torch.from_numpy(logits[lo:hi]).to(dev)
                errs.append(check_close(f"dlrm {name} rows {lo}..{hi}", got, want, LOGIT_TOL))

        # request latency: one request end to end (host batch, copy in,
        # forward, copy out), after the warm-up above
        one = {k: v[:BATCH] for k, v in data.items()}
        lat = []
        for _ in range(7):
            t0 = time.perf_counter()
            trainer.predict(one, batch_size=BATCH)
            lat.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        trainer.predict(data, batch_size=BATCH)
        wall = time.perf_counter() - t0
        auc = trainer.evaluate_auc(data, batch_size=BATCH)
        emit({"phase": "profile", "config": name,
              **profile_call(lambda: trainer.predict(one, batch_size=BATCH))})
        res = {"phase": "serve", "config": name, "rows": n, "requests": requests,
               "launches": launches, "expected_launches": expected,
               "max_abs_err": max(e["max_abs_err"] for e in errs),
               "request_ms_median": float(np.median(lat)),
               "request_ms_min": float(np.min(lat)),
               "examples_per_s": n / wall,
               "auc_random_weights": auc,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        emit(res)
        results[name] = res
        del model, trainer
        torch.cuda.empty_cache()
    emit({"phase": "serve", "fused_mlps_off_on": {
        k: [results[f"fused_mlps={f}"][k] for f in (False, True)]
        for k in ("request_ms_median", "request_ms_min", "examples_per_s")}})
    return results


def share_off(got, want, thresh: float) -> float:
    """Share of the cells of ``got`` more than ``thresh`` from ``want``
    (which may lie on another device)."""
    return float(((got.double() - want.to(got.device).double()).abs() > thresh)
                 .double().mean())


def share_not_close(got, want, tol: dict) -> float:
    import torch

    return float((~torch.isclose(got.double(), want.to(got.device).double(), **tol))
                 .double().mean())


def moment_errors(trainer, ref) -> tuple[dict, dict]:
    """Per dense parameter with a gradient: the norm of the difference of
    ``trainer``'s Adam first moment from ``ref``'s (which may lie on
    another device) over the norm of ``ref``'s, and the same had
    ``trainer``'s gradient been 20% short.  The first moment follows the
    gradient, where Adam's update normalises it away."""
    moments, short = {}, {}
    b1 = trainer.optimizer.param_groups[0]["betas"][0]
    for (k, pk), pp in zip(trainer.model.named_parameters(), ref.model.parameters()):
        if pk.grad is None:
            continue
        mk = trainer.optimizer.state[pk]["exp_avg"]
        mp = ref.optimizer.state[pp]["exp_avg"].to(mk.device)
        norm = float(mp.norm())
        moments[k] = float((mk - mp).norm()) / norm
        short[k] = float((mk - (1 - b1) * 0.2 * pk.grad - mp).norm()) / norm
    return moments, short


def compare_step(name, trainer, ref, loss_k, loss_p, exact: bool = False) -> dict:
    """One train step through the kernels (``trainer``) against the same
    step through the plain versions (``ref``), from copies of one state.
    With ``exact`` both went through the same kernels from one state: the
    loss and the dense parameters and moments must agree bit for bit, which
    no short gradient does (the power reading is shown but not needed);
    #4 sums an id's duplicates in an order that varies from run to run, so
    the tables keep their shares."""
    import torch

    out = {"loss": float(loss_k), "plain_loss": float(loss_p)}
    ok = bool(torch.isclose(loss_k.double(), loss_p.double(), **LOGIT_TOL))
    got_sd, want_sd = trainer.model.state_dict(), ref.model.state_dict()
    groups = [f"table_{g}" for g in (0, NUM_SPARSE // 2, NUM_SPARSE - 1)]
    compared = [k for k in want_sd if not k.startswith("embedding.table_")]
    compared += [f"embedding.{g}" for g in groups]
    shares = {k: share_off(got_sd[k], want_sd[k], STEP_P_THRESH) for k in compared}
    out["worst_param_share"] = max(shares.values())
    ok &= out["worst_param_share"] <= STEP_P_SHARE
    state_shares = {f"{g}.{k}": share_not_close(v, ref.emb_state[g][k], STEP_STATE_TOL[k])
                    for g in groups for k, v in trainer.emb_state[g].items()}
    out["worst_state_share"] = max(state_shares.values())
    ok &= out["worst_state_share"] <= STEP_STATE_SHARE
    # the dense Adam's first moment; a gradient 20% short must show
    moments, short = moment_errors(trainer, ref)
    out["worst_moment_rel_err"] = max(moments.values())
    out["grad_x0.8_least_moment_rel_err"] = min(short.values())
    if exact:
        out["dense_bit_equal"] = bool(
            torch.equal(loss_k, loss_p) and out["worst_moment_rel_err"] == 0.0
            and all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd
                    if not k.startswith("embedding.")))
        ok &= out["dense_bit_equal"]
    else:
        ok &= (out["worst_moment_rel_err"] <= STEP_MOMENT_RTOL
               < out["grad_x0.8_least_moment_rel_err"])
    out["ok"] = ok
    emit({"phase": "check", "case": f"train step {name} kernels vs plain", **out,
          "param_share_limit": STEP_P_SHARE, "state_share_limit": STEP_STATE_SHARE,
          "moment_rel_err_limit": STEP_MOMENT_RTOL})
    if not ok:
        raise AssertionError(f"train step {name}: kernels disagree with the plain versions: "
                             f"{out}, params {shares}, state {state_shares}, "
                             f"moments {moments}, moments of a short gradient {short}")
    return out


def phase_train(params, dev) -> dict:
    """Trainer.fit at bench widths: fused Adam with fused_mlps off and on,
    fused rowwise AdaGrad; returns per configuration the launches, the
    comparison with the plain versions, step time and throughput."""
    import torch

    from recsys_tpu_torch.convert import params_from_jax
    from recsys_tpu_torch.data.synthetic import synthetic_ctr
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.models.ctr.dlrm import DLRM
    from recsys_tpu_torch.train.loop import Trainer

    n = TRAIN_STEPS * BATCH
    schema, data = synthetic_ctr(num_examples=n + BATCH, num_dense=NUM_DENSE,
                                 num_sparse=NUM_SPARSE, vocab_size=VOCAB,
                                 embed_dim=EMBED_DIM, seed=1)
    train = {k: v[:n] for k, v in data.items()}
    extra = {k: v[n:] for k, v in data.items()}  # the compared and timed step
    results = {}
    for opt, fused in (("fused_adam", False), ("fused_adam", True),
                       ("fused_rowwise_adagrad", False)):
        name = f"{opt} fused_mlps={fused}"
        model = DLRM(schema, bottom_units=BOTTOM, top_units=TOP,
                     compute_dtype=torch.bfloat16, fused_mlps=fused,
                     dense_microbatch=MICROBATCH, sparse_embed_grads=True, device=dev)
        model.load_state_dict(params_from_jax(params, schema, model))
        trainer = Trainer(model, learning_rate=LR, embedding_optimizer=opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # the main path: counts zeroed just before, read just after
        dispatch.reset_launches()
        t0 = time.perf_counter()
        hist = trainer.fit(train, batch_size=BATCH, epochs=1, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(dispatch.LAUNCHES)
        # fused Adam takes every table in one launch, AdaGrad one a table
        kernel, per_step = (("embedding_adam", 1) if opt == "fused_adam" else
                            ("embedding_rowwise_adagrad", NUM_SPARSE))
        expected = dict.fromkeys(launches, 0)
        expected.update({"dot_interaction": MICROBATCH * TRAIN_STEPS,
                         kernel: per_step * TRAIN_STEPS,
                         "mlp_fwd": 2 * MICROBATCH * TRAIN_STEPS if fused else 0,
                         "mlp_bwd": 2 * MICROBATCH * TRAIN_STEPS if fused else 0})
        if launches != expected:
            raise AssertionError(f"train {name}: launches {launches}, expected {expected}")
        if not np.isfinite(hist["loss"]).all():
            raise AssertionError(f"train {name}: loss {hist['loss']} not finite")
        peak = torch.cuda.max_memory_allocated()
        # throughput: a second epoch, past the first steps' warm-up
        t0 = time.perf_counter()
        trainer.fit(train, batch_size=BATCH, epochs=1, verbose=False)
        torch.cuda.synchronize()
        fit2_s = time.perf_counter() - t0

        ref = copy.deepcopy(trainer)
        cmp = compare_step(name, trainer, ref, trainer.train_step(extra),
                           plain_train_step(ref, extra))
        del ref

        # step time: host batch with its prep (done on the prefetch thread
        # in fit), copy in, forward, backward, both optimizers
        prepped = dict(extra, **trainer._prep(extra["sparse"]))
        steps_ms = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(prepped)
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
        emit({"phase": "profile", "config": f"train {name}",
              **profile_call(lambda: (trainer.train_step(prepped), torch.cuda.synchronize()))})
        res = {"phase": "train", "config": name, "steps": TRAIN_STEPS, "rows": n,
               "epoch_loss": hist["loss"][0], "launches": launches,
               "expected_launches": expected, "step_check": cmp,
               "step_ms_median": float(np.median(steps_ms)),
               "step_ms_min": float(np.min(steps_ms)),
               "step_examples_per_s": BATCH / (float(np.median(steps_ms)) / 1e3),
               "fit_seconds": fit_s, "fit_examples_per_s": n / fit_s,
               "second_epoch_seconds": fit2_s, "second_epoch_examples_per_s": n / fit2_s,
               "max_memory_allocated_bytes": peak}
        emit(res)
        results[name] = res
        del model, trainer
        torch.cuda.empty_cache()
    emit({"phase": "train", "fused_adam fused_mlps_off_on": {
        k: [results[f"fused_adam fused_mlps={f}"][k] for f in (False, True)]
        for k in ("step_ms_median", "step_ms_min", "second_epoch_examples_per_s")}})
    return results


def mlp_part_ms(x, g, ws, bs) -> dict:
    """ms of each launch of the fused MLPs (bf16) apart: the pre-pass, the
    chain, and the backward's dW pass with its slice sum; with the chain's
    cluster size C, the clusters the card holds at once, and kernel B's
    batch slices."""
    from recsys_tpu_torch.kernels import dispatch

    dims = [x.shape[1], *(w.shape[1] for w in ws)]
    fwd, _ = dispatch.mlp_forward_call(x, ws, bs)
    bwd, bb = dispatch.mlp_backward_call(x, g, ws, bs)
    fwd(dispatch.MLP_PACK)
    bwd(dispatch.MLP_PACK | dispatch.MLP_CHAIN)
    cluster, fwd_active = dispatch.mlp_chain_clusters(dims)
    return {"cluster": cluster, "fwd_active_clusters": fwd_active,
            "bwd_active_clusters": dispatch.mlp_chain_clusters(dims, backward=True)[1],
            "fwd_pack_ms": cuda_ms(lambda: fwd(dispatch.MLP_PACK)),
            "fwd_chain_ms": cuda_ms(lambda: fwd(dispatch.MLP_CHAIN)),
            "bwd_pack_ms": cuda_ms(lambda: bwd(dispatch.MLP_PACK)),
            "bwd_chain_ms": cuda_ms(lambda: bwd(dispatch.MLP_CHAIN)),
            "bwd_dw_ms": cuda_ms(lambda: bwd(dispatch.MLP_DW)),
            "split": bb["split"], "split_rows": bb["split_rows"]}


def unfused_mlp_ms(x, g, dims) -> float:
    """ms of the tower as ``fused_mlps=False`` runs it: ``ops/mlp.py::MLP``
    in bf16 (cuBLAS products), forward, or with ``g`` forward plus backward
    through autograd with dx."""
    import torch

    from recsys_tpu_torch.ops.mlp import MLP

    m = MLP(dims[0], dims[1:-1], out_dim=dims[-1], dtype=torch.bfloat16, device=x.device)
    if g is None:
        with torch.no_grad():
            return cuda_ms(lambda: m(x))
    xg = x.detach().clone().requires_grad_(True)

    def fwd_bwd():
        out = m(xg)
        out.backward(g.to(out.dtype))

    return cuda_ms(fwd_bwd)


def phase_timing(rng, dev) -> dict:
    """Kernel and plain ms at the main path's shapes (one 4096-row
    microbatch in bf16; one 100k x 16 table and a 16384-id batch), with
    each kernel's bound."""
    import torch

    from recsys_tpu_torch.kernels import build, dispatch
    from recsys_tpu_torch.kernels import embedding_update as emb_ref
    from recsys_tpu_torch.kernels.interactions import dot_interaction
    from recsys_tpu_torch.kernels.mlp import mlp_backward, mlp_forward

    b, f = BATCH // MICROBATCH, NUM_SPARSE + 1
    p = f * (f - 1) // 2
    x = torch.from_numpy(rng.standard_normal((b, f, EMBED_DIM), dtype=np.float32)).to(
        dev, torch.bfloat16)
    # bf16 in, f32 out; the products are bf16, so the tensor-core peak
    bound_ms, kind = bound(b * f * EMBED_DIM * 2 + b * p * 4, 2 * b * p * EMBED_DIM,
                           BF16_FLOPS)
    # the launch floor: an empty kernel at the kernel's grid and block;
    # beside it torch.bmm(x, x.mT), the whole F x F Gram matrix (not the
    # same function, so not library_ms)
    lib = build.libraries()["dot_interaction"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    dot = {"ms": cuda_ms(lambda: dispatch.dot_interaction(x), iters=200),
           "plain_ms": cuda_ms(lambda: dot_interaction(x), iters=200),
           "bound_ms": bound_ms, "bound_by": kind, "library_ms": None,
           "launch_floor_ms": cuda_ms(lambda: lib.dot_interaction_floor(b, f, EMBED_DIM, 0,
                                                                        stream), iters=200),
           "grid": -(-b // lib.dot_interaction_tile(f, EMBED_DIM, 0)),
           "bmm_ms": cuda_ms(lambda: torch.bmm(x, x.mT), iters=200),
           "shape": [b, f, EMBED_DIM], "dtype": "bf16"}
    emit({"phase": "timing", "kernel": "dot_interaction", **dot})

    # one bottom and one top tower per microbatch, as the path launches them;
    # unfused_ms is the tower as fused_mlps=False runs it (ops/mlp.py::MLP in
    # bf16, cuBLAS products), no one PyTorch call
    mlp = {"ms": 0.0, "plain_ms": 0.0, "unfused_ms": 0.0, "towers": {}}
    total_bytes = total_ops = 0.0
    for name, dims in (("bottom", [NUM_DENSE, *BOTTOM, EMBED_DIM]),
                       ("top", [EMBED_DIM + p, *TOP, 1])):
        ws, bs = mlp_weights(rng, dims)
        tw = [torch.from_numpy(w).to(dev) for w in ws]
        tb = [torch.from_numpy(v).to(dev) for v in bs]
        xm = torch.from_numpy(rng.random((b, dims[0]), dtype=np.float32)).to(dev)
        t = {"ms": cuda_ms(lambda: dispatch.fused_mlp_forward(xm, tw, tb, True)),
             "plain_ms": cuda_ms(lambda: mlp_forward(xm, tw, tb, True)),
             "f32_ms": cuda_ms(lambda: dispatch.fused_mlp_forward(xm, tw, tb, False),
                               iters=10, warmup=2),
             "unfused_ms": unfused_mlp_ms(xm, None, dims)}
        by, op = mlp_work(b, dims)
        t["bound_ms"], t["bound_by"] = bound(by, op, BF16_FLOPS)
        emit({"phase": "timing", "kernel": f"mlp_fwd {name}", "dims": dims, **t})
        mlp["towers"][name] = t
        for k in ("ms", "plain_ms", "unfused_ms"):
            mlp[k] += t[k]
        total_bytes, total_ops = total_bytes + by, total_ops + op
    mlp["bound_ms"], mlp["bound_by"] = bound(total_bytes, total_ops, BF16_FLOPS)
    mlp["library_ms"] = None

    # the backward, bf16, one bottom and one top tower per microbatch; its
    # unfused_ms is the unfused tower's forward and backward through autograd
    bwd = {"ms": 0.0, "plain_ms": 0.0, "unfused_ms": 0.0, "towers": {}}
    total_bytes = total_ops = 0.0
    for name, dims in (("bottom", [NUM_DENSE, *BOTTOM, EMBED_DIM]),
                       ("top", [EMBED_DIM + p, *TOP, 1])):
        ws, bs = mlp_weights(rng, dims)
        tw = [torch.from_numpy(w).to(dev) for w in ws]
        tb = [torch.from_numpy(v[None]).to(dev) for v in bs]
        xm = torch.from_numpy(rng.random((b, dims[0]), dtype=np.float32)).to(dev)
        gm = torch.from_numpy(rng.standard_normal((b, dims[-1]), dtype=np.float32)).to(dev)
        t = {"ms": cuda_ms(lambda: dispatch.fused_mlp_backward(xm, gm, tw, tb, True)),
             "plain_ms": cuda_ms(lambda: mlp_backward(xm, gm, tw, tb, True)),
             "f32_ms": cuda_ms(lambda: dispatch.fused_mlp_backward(xm, gm, tw, tb, False),
                               iters=10, warmup=2),
             "unfused_ms": unfused_mlp_ms(xm, gm, dims)}
        by, op = mlp_bwd_work(b, dims)
        t["bound_ms"], t["bound_by"] = bound(by, op, BF16_FLOPS)
        # each launch apart (the pre-pass, the chain, the dW pass with its
        # slice sum), C, the clusters the card holds at once, and S
        parts = mlp_part_ms(xm, gm, tw, tb)
        emit({"phase": "timing", "kernel": f"mlp parts {name}", "dims": dims, **parts})
        t.update({k: parts[k] for k in ("cluster", "bwd_active_clusters", "split",
                                        "split_rows", "bwd_pack_ms", "bwd_chain_ms",
                                        "bwd_dw_ms")})
        mlp["towers"][name].update({k: parts[k] for k in ("fwd_active_clusters",
                                                          "fwd_pack_ms", "fwd_chain_ms")})
        emit({"phase": "timing", "kernel": f"mlp_bwd {name}", "dims": dims, **t})
        bwd["towers"][name] = t
        for k in ("ms", "plain_ms", "unfused_ms"):
            bwd[k] += t[k]
        total_bytes, total_ops = total_bytes + by, total_ops + op
    bwd["bound_ms"], bwd["bound_by"] = bound(total_bytes, total_ops, BF16_FLOPS)
    bwd["library_ms"] = None

    # the embedding updates, bf16 sums, f32 tables.  As in a step, each
    # call updates the next of NUM_SPARSE tables, so the tables come from
    # device memory (one table's p, m and v fill 19 MB of the 50 MB L2);
    # "warm_ms" updates one table again and again.
    tabs = [embedding_inputs(rng, dev, VOCAB, False, UPDATE_BLOCK) for _ in range(NUM_SPARSE)]
    for a in tabs:
        a["cot"] = a["cot"].bfloat16()
    turn = itertools.count()
    blk = dict(block=UPDATE_BLOCK, lr=LR)

    def adam(update, rotate=True):
        a = tabs[next(turn) % NUM_SPARSE if rotate else 0]
        update(a["p"], a["m"], a["v"], a["cot"], a["ids2d"], a["cptr"], 3, **blk)

    def adagrad(update, rotate=True):
        a = tabs[next(turn) % NUM_SPARSE if rotate else 0]
        update(a["p"], a["acc"], a["cot"], a["ids2d"], a["cptr"], **blk)

    vd = VOCAB * EMBED_DIM
    # what the kernel must read of the batch: the cotangent rows and ids of
    # the BATCH real occurrences (a padding slot's cotangent is never
    # loaded) and the chunk pointers
    stream_in = BATCH * EMBED_DIM * 2 + BATCH * 4 + tabs[0]["cptr"].numel() * 4
    rounds = dict(iters=2 * NUM_SPARSE, warmup=NUM_SPARSE)
    res = {}

    def plain_pass(ps, ms, vs, cots, ids2ds, cptrs, step, *, blocks, lr):
        for args in zip(ps, ms, vs, cots, ids2ds, cptrs, blocks):
            emb_ref.fused_adam(*args[:6], step, block=args[6], lr=lr)

    for name, fn, kernel, plain, nbytes, nops in (
            # p, m, v read and written, f32; about 16 flops per element
            ("embedding_adam", adam, dispatch.fused_embedding_adam, emb_ref.fused_adam,
             6 * 4 * vd, 16 * vd),
            # p read and written, f32, and one f32 accumulator per row
            ("embedding_rowwise_adagrad", adagrad, dispatch.fused_embedding_rowwise_adagrad,
             emb_ref.fused_rowwise_adagrad, 2 * 4 * vd + 2 * 4 * VOCAB, 8 * vd)):
        t = {"ms": cuda_ms(lambda: fn(kernel), **rounds),
             "warm_ms": cuda_ms(lambda: fn(kernel, rotate=False)),
             "plain_ms": cuda_ms(lambda: fn(plain), iters=NUM_SPARSE, warmup=5),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = bound(nbytes + stream_in, nops, F32_FLOPS)
        if name == "embedding_adam":
            # the main path's launch: a step's 26 tables in one launch (its
            # plain version table by table); one table a launch, in turn,
            # beside it as table_ms
            def every(update):
                update(*([a[key] for a in tabs] for key in ("p", "m", "v", "cot", "ids2d",
                                                            "cptr")), 3,
                       blocks=[UPDATE_BLOCK] * NUM_SPARSE, lr=LR)
            t.update({"table_ms": t["ms"], "table_plain_ms": t["plain_ms"],
                      "table_bound_ms": t["bound_ms"],
                      "ms": cuda_ms(lambda: every(dispatch.fused_embedding_adam_pass), iters=4,
                                    warmup=2),
                      "plain_ms": cuda_ms(lambda: every(plain_pass), iters=1, warmup=1),
                      "bound_ms": bound(NUM_SPARSE * (nbytes + stream_in), NUM_SPARSE * nops,
                                        F32_FLOPS)[0], "tables_a_launch": NUM_SPARSE})
        emit({"phase": "timing", "kernel": name, "table": [VOCAB, EMBED_DIM],
              "ids": BATCH, "tables_rotated": NUM_SPARSE, **t})
        res[name] = t
    return {"dot_interaction": dot, "mlp_fwd": mlp, "mlp_bwd": bwd, **res}


# -- SASRec -------------------------------------------------------------------
def phase_flash_check(rng, dev) -> dict:
    """flash_check.check on every case; returns the worst abs error of the
    forward (out) and of the backward (dq, dk, dv) over all cases."""
    import torch

    import flash_check
    from recsys_tpu_torch.kernels import dispatch

    worst = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0}
    shapes = [(SAS_BATCH, SAS_HEADS, SAS_LEN, SAS_DIM // SAS_HEADS),
              (64, SAS_HEADS, 300, SAS_DIM // SAS_HEADS),
              (SAS_LONG_CHECK, SAS_HEADS, SAS_LONG, SAS_DIM // SAS_HEADS),
              (128, 1, 50, SAS_DIM),  # the cli sasrec shape
              (CTR_REQUEST, 2, NUM_SPARSE + NUM_DENSE, EMBED_DIM // 2),  # AutoInt's
              (CTR_BATCH, 2, NUM_SPARSE + NUM_DENSE, EMBED_DIM // 2),  # its train step
              # both sides of the short route (S <= 64) and of a 128-row block
              *((16, 2, s, 32) for s in (63, 64, 65, 127, 129)),
              (8, 2, 64, 128), (8, 2, 40, 128)]
    for (b, h, s, d), causal, kind in itertools.product(shapes, (False, True),
                                                       flash_check.MASKS):
        q, k, v, do, mask = flash_check.inputs(rng, b, h, s, d, kind, dev)
        res = flash_check.check(q, k, v, do, mask, causal, dispatch.flash_attention_fwd,
                                dispatch.flash_attention_bwd)
        case = f"flash b={b} h={h} s={s} d={d} causal={causal} mask={kind}"
        emit({"phase": "check", "case": case, **res,
              "limits": flash_check.TOLS})
        if not res["ok"]:
            raise AssertionError(f"{case}: kernels disagree with their plain versions, "
                                 f"or a limit does not reject a wrong result: {res}")
        worst["flash_attention_fwd"] = max(worst["flash_attention_fwd"], res["errors"]["out"])
        worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"],
                                           *(res["errors"][n] for n in ("dq", "dk", "dv")))
        del q, k, v, do, mask
    torch.cuda.synchronize()
    return worst


def sasrec_jax_params(rng, max_len) -> dict:
    """SASRec weights in the JAX package's layout (recsys_tpu/models/match/
    sasrec.py): item table and positions as its initialisers draw them, the
    projections and FFN scaled by 1/sqrt(D), layer norms near 1 and 0."""
    d = SAS_DIM

    def normal(*shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    params = {"item_table": normal(SAS_ITEMS, d, scale=0.05),
              "pos_emb": {"pos": normal(max_len, d, scale=0.02)}}
    for i in range(SAS_BLOCKS):
        params[f"blocks_{i}"] = {
            "MultiHeadAttention_0": {w: {"kernel": normal(d, d, scale=d ** -0.5)}
                                     for w in ("wq", "wk", "wv")},
            **{f"LayerNorm_{j}": {"scale": 1 + normal(d, scale=0.1),
                                  "bias": normal(d, scale=0.1)} for j in (0, 1)},
            **{f"Dense_{j}": {"kernel": normal(d, d, scale=d ** -0.5),
                              "bias": normal(d, scale=0.01)} for j in (0, 1)},
        }
    return params


def sasrec_model(params, max_len, dev):
    from recsys_tpu_torch.convert import sasrec_params_from_jax
    from recsys_tpu_torch.models.match.sasrec import SASRec

    model = SASRec(num_items=SAS_ITEMS, embed_dim=SAS_DIM, num_blocks=SAS_BLOCKS,
                   num_heads=SAS_HEADS, max_len=max_len, dropout_rate=0.0, device=dev)
    model.load_state_dict(sasrec_params_from_jax(params, model))
    return model


def prefix_data(rng, n, max_len, negs) -> dict:
    """Front-padded histories of 1..max_len items, one positive and
    ``negs`` negatives per row."""
    lens = rng.integers(1, max_len + 1, n)
    hist = rng.integers(1, SAS_ITEMS, (n, max_len)).astype(np.int32)
    hist[np.arange(max_len)[None, :] < max_len - lens[:, None]] = 0
    return {"hist": hist, "pos": rng.integers(1, SAS_ITEMS, n).astype(np.int32),
            "neg": rng.integers(1, SAS_ITEMS, (n, negs)).astype(np.int32)}


def all_position_data(rng, n, max_len) -> dict:
    """The published scheme's rows: position t of a front-padded history
    predicts the next item tgt[t] against one negative; pad positions 0."""
    seq = rng.integers(1, SAS_ITEMS, (n, max_len + 1)).astype(np.int32)
    pad = np.arange(max_len)[None, :] < max_len - rng.integers(1, max_len + 1, n)[:, None]
    hist, tgt = seq[:, :-1].copy(), seq[:, 1:].copy()
    neg = rng.integers(1, SAS_ITEMS, (n, max_len)).astype(np.int32)
    for a in (hist, tgt, neg):
        a[pad] = 0
    return {"hist": hist, "pos": tgt, "neg": neg}


def sasrec_loss(out, batch):
    from recsys_tpu_torch.train.losses import pairwise_bce

    return pairwise_bce(out["pos_logits"], out["neg_logits"], mask=out.get("mask"))


@contextlib.contextmanager
def plain_attention():
    """Route ``dispatch.sdpa`` through the plain versions on the card, for
    the comparisons: the same model, the same autograd function."""
    from recsys_tpu_torch.kernels import attention as attn
    from recsys_tpu_torch.kernels import dispatch

    saved = dispatch.flash_attention_fwd, dispatch.flash_attention_bwd
    dispatch.flash_attention_fwd = attn.flash_attention_fwd
    dispatch.flash_attention_bwd = attn.flash_attention_bwd
    try:
        yield
    finally:
        dispatch.flash_attention_fwd, dispatch.flash_attention_bwd = saved


def step_category(name: str) -> str:
    """The category of a device kernel in a SASRec step's profile."""
    low = name.lower()
    for cat, keys in (("flash forward", ("flash_fwd",)),
                      ("flash backward", ("flash_bwd",)),
                      ("GEMMs (projections, FFN, logits)",
                       ("gemm", "gemv", "xmma", "cutlass", "splitk", "kernel2")),
                      ("gathers and item-table scatter",
                       ("index", "embedding", "gather", "scatter", "sort", "radix", "unique")),
                      ("optimizer", ("adam", "multi_tensor")),
                      ("loss", ("log_sigmoid", "logsigmoid", "softplus")),
                      ("host-device copies", ("memcpy",))):
        if any(k in low for k in keys):
            return cat
    return "other (layer norm, elementwise, reductions)"


def phase_sasrec_serve(rng, dev) -> dict:
    """Trainer.predict at the bench widths over 256-row requests and a
    ragged tail, then HR@10 and NDCG@10."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.train.loop import Trainer
    from recsys_tpu_torch.train.metrics import hit_rate_ndcg_at_k

    model = sasrec_model(sasrec_jax_params(rng, SAS_LEN), SAS_LEN, dev)
    n = SAS_REQUESTS * SAS_BATCH + SAS_TAIL
    data = prefix_data(rng, n, SAS_LEN, SAS_NEGS)
    requests = -(-n // SAS_BATCH)
    trainer = Trainer(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts zeroed just before, read just after
    dispatch.reset_launches()
    out = trainer.predict(data, batch_size=SAS_BATCH)
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    expected = {**dict.fromkeys(launches, 0), "flash_attention_fwd": SAS_BLOCKS * requests}
    if launches != expected:
        raise AssertionError(f"sasrec serve: launches {launches}, expected {expected}")
    if out["pos_logits"].shape != (n,) or out["neg_logits"].shape != (n, SAS_NEGS) or \
            not all(np.isfinite(v).all() for v in out.values()):
        raise AssertionError("sasrec serve: logits of the wrong shape or not finite")
    hr, ndcg = hit_rate_ndcg_at_k(out["pos_logits"], out["neg_logits"], k=10)

    errs = []
    with torch.inference_mode(), plain_attention():
        for lo, hi in ((0, SAS_BATCH), (SAS_REQUESTS * SAS_BATCH, n)):
            want = model({k: torch.from_numpy(v[lo:hi]).to(dev) for k, v in data.items()})
            for key in ("pos_logits", "neg_logits"):
                errs.append(check_close(f"sasrec serve {key} rows {lo}..{hi}",
                                        torch.from_numpy(out[key][lo:hi]).to(dev),
                                        want[key], SAS_LOGIT_TOL))

    one = {k: v[:SAS_BATCH] for k, v in data.items()}
    lat = []
    for _ in range(7):
        t0 = time.perf_counter()
        trainer.predict(one, batch_size=SAS_BATCH)
        lat.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    trainer.predict(data, batch_size=SAS_BATCH)
    wall = time.perf_counter() - t0
    emit({"phase": "profile", "config": "sasrec serve",
          **profile_call(lambda: trainer.predict(one, batch_size=SAS_BATCH), step_category)})
    res = {"phase": "sasrec serve", "rows": n, "requests": requests, "max_len": SAS_LEN,
           "negatives": SAS_NEGS, "HR@10": hr, "NDCG@10": ndcg, "launches": launches,
           "expected_launches": expected,
           "max_abs_err": max(e["max_abs_err"] for e in errs),
           "request_ms_median": float(np.median(lat)), "request_ms_min": float(np.min(lat)),
           "examples_per_s": n / wall,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    print(f"sasrec serve: HR@10={hr:.4f} NDCG@10={ndcg:.4f}", flush=True)
    emit(res)
    del model, trainer
    torch.cuda.empty_cache()
    return res


def compare_sasrec_step(name, trainer, ref, loss_k, loss_p, label="sasrec") -> dict:
    """One SASRec (or other all-f32) step through the kernels against the
    same step through the plain versions, from copies of one state (all
    dense f32 Adam); ``ref`` may run on the CPU."""
    import torch

    out = {"loss": float(loss_k), "plain_loss": float(loss_p)}
    ok = bool(torch.isclose(loss_k.double().cpu(), loss_p.double().cpu(), **SAS_LOGIT_TOL))
    got_sd, want_sd = trainer.model.state_dict(), ref.model.state_dict()
    shares = {k: share_off(got_sd[k], want_sd[k], LR / 10) for k in want_sd}
    out["worst_param_share"] = max(shares.values())
    ok &= out["worst_param_share"] <= SAS_P_SHARE
    moments, short = moment_errors(trainer, ref)
    out["worst_moment_rel_err"] = max(moments.values())
    out["grad_x0.8_least_moment_rel_err"] = min(short.values())
    ok &= out["worst_moment_rel_err"] <= SAS_MOMENT_RTOL < out["grad_x0.8_least_moment_rel_err"]
    out["ok"] = ok
    emit({"phase": "check", "case": f"{label} train step {name} kernels vs plain", **out,
          "loss_tol": SAS_LOGIT_TOL, "param_share_limit": SAS_P_SHARE,
          "param_thresh": LR / 10, "moment_rel_err_limit": SAS_MOMENT_RTOL})
    if not ok:
        raise AssertionError(f"{label} train step {name}: kernels disagree with the plain "
                             f"versions: {out}, params {shares}, moments {moments}, "
                             f"moments of a short gradient {short}")
    return out


def phase_sasrec_train(rng, dev) -> dict:
    """Trainer.fit at the bench widths: the prefix scheme with one negative
    (bench.py) at max_len 512 and 2048, the all-position scheme (cli sasrec)
    at 512."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.train.loop import Trainer

    results = {}
    for scheme, max_len, steps, check_rows in (("prefix", SAS_LEN, SAS_STEPS, SAS_BATCH),
                                               ("all-position", SAS_LEN, SAS_STEPS, SAS_BATCH),
                                               ("prefix", SAS_LONG, SAS_LONG_STEPS,
                                                SAS_LONG_CHECK)):
        name = f"{scheme} max_len={max_len}"
        make = (lambda n: prefix_data(rng, n, max_len, 1)) if scheme == "prefix" else \
            (lambda n: all_position_data(rng, n, max_len))
        n = steps * SAS_BATCH
        train, extra = make(n), make(SAS_BATCH)
        model = sasrec_model(sasrec_jax_params(rng, max_len), max_len, dev)
        trainer = Trainer(model, loss_fn=sasrec_loss, learning_rate=LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # the main path: counts zeroed just before, read just after
        dispatch.reset_launches()
        t0 = time.perf_counter()
        hist = trainer.fit(train, batch_size=SAS_BATCH, epochs=1, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(dispatch.LAUNCHES)
        expected = {**dict.fromkeys(launches, 0),
                    "flash_attention_fwd": SAS_BLOCKS * steps,
                    "flash_attention_bwd": SAS_BLOCKS * steps}
        if launches != expected:
            raise AssertionError(f"sasrec train {name}: launches {launches}, "
                                 f"expected {expected}")
        if not np.isfinite(hist["loss"]).all():
            raise AssertionError(f"sasrec train {name}: loss {hist['loss']} not finite")
        peak = torch.cuda.max_memory_allocated()

        small = {k: v[:check_rows] for k, v in extra.items()}
        ref = copy.deepcopy(trainer)
        loss_k = trainer.train_step(small)
        with plain_attention():
            loss_p = ref.train_step(small)
        cmp = compare_sasrec_step(name, trainer, ref, loss_k, loss_p)
        del ref

        steps_ms = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(extra)
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
        emit({"phase": "profile", "config": f"sasrec train {name}",
              **profile_call(lambda: (trainer.train_step(extra), torch.cuda.synchronize()),
                             step_category)})
        res = {"phase": "sasrec train", "config": name, "steps": steps, "rows": n,
               "epoch_loss": hist["loss"][0], "launches": launches,
               "expected_launches": expected, "step_check": cmp,
               "step_check_rows": check_rows,
               "step_ms_median": float(np.median(steps_ms)),
               "step_ms_min": float(np.min(steps_ms)),
               "step_examples_per_s": SAS_BATCH / (float(np.median(steps_ms)) / 1e3),
               "fit_seconds": fit_s, "fit_examples_per_s": n / fit_s,
               "max_memory_allocated_bytes": peak}
        emit(res)
        results[name] = res
        del model, trainer
        torch.cuda.empty_cache()
    return results


def cli_run(argv, expected: dict, label: str) -> dict:
    """``recsys_tpu_torch.cli.main(argv)`` on the card, its output echoed and
    its result line (the last) returned with the launches, counts zeroed
    just before and read just after, and the task's returned ``result``;
    raises unless the launches are ``expected`` (a {kernel: count} of those
    that launch) and every epoch's training loss is finite."""
    import io

    import torch

    from recsys_tpu_torch import cli
    from recsys_tpu_torch.kernels import dispatch

    buf = io.StringIO()
    torch.cuda.synchronize()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(dispatch.LAUNCHES)
    want = ctr_expected(expected)
    lines = buf.getvalue().strip().splitlines()
    print(f"{label}: {lines[-1]}", flush=True)
    if launches != want or not result["loss"] or not np.isfinite(result["loss"]).all():
        raise AssertionError(f"{label}: launches {launches}, expected {want}, "
                             f"loss {result['loss']}")
    return {"phase": "cli", "task": label, "argv": argv, "line": lines[-1],
            "seconds": seconds, "launches": launches, "expected_launches": want,
            "result": result}


def eval_forwards(n: int, b: int) -> int:
    """Forward passes of ``Trainer.evaluate_loss`` over n rows in batches of
    b: one a batch, and one more for a padded last batch's repeated row."""
    return -(-n // b) + (n % b != 0)


def phase_sasrec_cli(dev) -> dict:
    """``cli sasrec`` on the kernels: synthetic ratings, the all-position
    dataset at max_len 50, fit for 2 epochs of 128 rows (every epoch's loss
    finite), predict the test rows, HR@10; every flash launch counted."""
    from recsys_tpu_torch.data.movielens import build_sasrec_dataset, synthetic_ratings

    _, train, _, _ = build_sasrec_dataset(synthetic_ratings(num_users=300, num_items=150),
                                          maxlen=50, all_positions=True)
    steps = 2 * (len(train["hist"]) // 128)
    res = cli_run(["sasrec", "--epochs", "2", "--batch-size", "128"],
                  {"flash_attention_fwd": 2 * steps + 2, "flash_attention_bwd": 2 * steps},
                  "sasrec cli")
    out = res.pop("result")
    m = re.fullmatch(r"test HR@10=([0-9.]+) NDCG@10=([0-9.]+)", res["line"])
    if not m or not 0.0 <= float(m.group(2)) <= float(m.group(1)) <= 1.0 or \
            out["train_rows"] != len(train["hist"]):
        raise AssertionError(f"sasrec cli: result line {res['line']!r}, {out}")
    res.update({"phase": "sasrec cli", **out})
    emit(res)
    return res


RECALL_LINE = r"recall@10: ([0-9.]+) over (\d+) items \(random ([0-9.]+)\)"


def phase_cli(dev) -> dict:
    """The other ported ``python -m recsys_tpu_torch.cli`` tasks on the card
    at the JAX CLI's fixture sizes (synthetic ratings of 300 users and 150
    items, 20,000 synthetic CTR rows, synthetic reviews, 20,000 multi-task
    rows): ctr (FM, 1 epoch), youtube, mind, match (dssm, senet, fm), ncf
    and din, 2 epochs each; multitask (esmm, mmoe, ple, and mmoe on census
    files of 3,000 + 1,000 rows written here), 1 epoch each; each prints
    its result line and launches exactly what its path holds (the last
    slice's tasks nothing).  {task: result}."""
    import tempfile

    from recsys_tpu_torch.data import census
    from recsys_tpu_torch.data.movielens import (build_ml100k_arrays,
                                                 build_seq_retrieval_dataset, synthetic_ratings,
                                                 synthetic_user_item_frames)
    from recsys_tpu_torch.data.realistic import realistic_census

    out = {}
    # ctr fm: 14,400 training rows in 512s, 1,600 validation rows, then the
    # 4,000 test rows in one request
    ctr_fm = 14_400 // 512 + eval_forwards(1_600, 512) + 1
    out["ctr"] = cli_run(["ctr", "--model", "fm", "--epochs", "1"],
                         {"fm_pairwise_vector": ctr_fm}, "cli ctr --model fm")
    _, seq_train, _ = build_seq_retrieval_dataset(synthetic_ratings(num_users=300,
                                                                    num_items=150), maxlen=50)
    n = len(seq_train["item_id"])
    out["youtube"] = cli_run(["youtube", "--epochs", "2"],
                             {"pooled_gather": 2 * (n // min(512, n)) + 1, "topk_scores": 1},
                             "cli youtube")
    # MIND's CLI scores every capsule with a matmul and torch.topk, as the
    # JAX CLI does with lax.top_k
    out["mind"] = cli_run(["mind", "--epochs", "2"], {}, "cli mind")
    _, _, train, _ = build_ml100k_arrays(synthetic_ratings(num_users=300, num_items=150),
                                         *synthetic_user_item_frames(300, 150), embed_dim=8)
    fit_n = int(len(train["label"]) * 0.9)  # fit's validation split
    b = min(512, fit_n)
    fm_forwards = 2 * (fit_n // b + eval_forwards(len(train["label"]) - fit_n, b))
    for model in ("dssm", "senet", "fm"):
        out[f"match {model}"] = cli_run(
            ["match", "--model", model, "--epochs", "2"],
            {"topk_scores": 1, **({"fm_pairwise_vector": fm_forwards} if model == "fm" else {})},
            f"cli match --model {model}")
    # the last slice's tasks launch no kernel; multitask --census reads files
    # written here
    out["ncf"] = cli_run(["ncf", "--epochs", "2"], {}, "cli ncf")
    out["din"] = cli_run(["din", "--epochs", "2"], {}, "cli din")
    for model in ("esmm", "mmoe", "ple"):
        out[f"multitask {model}"] = cli_run(["multitask", "--model", model, "--epochs", "1"],
                                            {}, f"cli multitask --model {model}")
    with tempfile.TemporaryDirectory(prefix="census_") as tmp:
        paths = [f"{tmp}/census.data", f"{tmp}/census.test"]
        for path, cols in zip(paths, realistic_census(num_train=3000, num_test=1000, seed=0)):
            census.write_columns(path, cols)
        out["multitask census"] = cli_run(["multitask", "--model", "mmoe", "--epochs", "1",
                                           "--census", *paths], {},
                                          "cli multitask --model mmoe --census")
    lines = {"ctr": r"test AUC: ([0-9.]+)", "din": r"test AUC: ([0-9.]+)",
             "ncf": r"epoch 2/2 loss=[0-9.]+ HR@10=([0-9.]+) NDCG@10=[0-9.]+"}
    for task, res in out.items():
        line = res["line"]
        pattern = lines.get(task, r"\w+ AUC: ([0-9.]+)" if task.startswith("multitask")
                            else RECALL_LINE)
        ok = re.fullmatch(pattern, line)
        if not ok or not 0.0 <= float(ok.group(1)) <= 1.0:
            raise AssertionError(f"cli {task}: result line {line!r}")
    emit({"phase": "cli", "tasks": {k: {"loss": v["result"]["loss"],
                                        **{kk: v[kk] for kk in ("line", "seconds", "launches")}}
                                    for k, v in out.items()}})
    return out


def attention_work(b, h, s, d, passes, tensors) -> tuple[float, float]:
    """(bytes, operations) of causal attention with all keys kept: the
    ``tensors`` (B, H, S, D) f32 tensors read or written once, lse and the
    mask; ``passes`` products of 2·D flops over the S(S+1)/2 pairs."""
    pairs = s * (s + 1) / 2
    return (4 * (tensors * b * h * s * d + b * h * s + b * s),
            passes * 2 * d * pairs * b * h)


def flash_bounds(kind, bytes_moved, operations) -> dict:
    """The flash bounds of one kernel: split TF32 (3 x the operations on the
    TF32 tensor cores) as ``{kind}_bound_ms``, and the CUDA cores' exact f32
    as ``{kind}_f32_core_bound_ms``."""
    ms, by = bound(bytes_moved, 3 * operations, TF32_FLOPS)
    return {f"{kind}_bound_ms": ms, f"{kind}_bound_by": by,
            f"{kind}_f32_core_bound_ms": bound(bytes_moved, operations, F32_FLOPS)[0]}


def phase_flash_timing(rng, dev) -> dict:
    """Kernel, plain and torch SDPA ms of the flash forward and backward,
    causal with every key kept (bench.py's full histories), at S = 512
    (B = 256) and S = 2048 (B = 32, where the plain version fits)."""
    import torch
    import torch.nn.functional as F

    from recsys_tpu_torch.kernels import attention as attn
    from recsys_tpu_torch.kernels import dispatch

    res = {}
    d, h = SAS_DIM // SAS_HEADS, SAS_HEADS
    for s, b in ((SAS_LEN, SAS_BATCH), (SAS_LONG, 32)):
        q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, s, d), dtype=np.float32))
                       .to(dev) for _ in range(4))
        mask = torch.ones((b, s), dtype=torch.int32, device=dev)
        out, lse = dispatch.flash_attention_fwd(q, k, v, mask, True)
        keep = attn.keep_mask(mask, s, s, True, dev)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

        def lib_fwd():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=keep)

        def lib_fwd_bwd():
            for t in (qg, kg, vg):
                t.grad = None
            F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep).backward(do)

        t = {
            "fwd_ms": cuda_ms(lambda: dispatch.flash_attention_fwd(q, k, v, mask, True), 20, 3),
            "bwd_ms": cuda_ms(lambda: dispatch.flash_attention_bwd(
                q, k, v, mask, out, lse, do, True), 10, 2),
            "plain_fwd_ms": cuda_ms(lambda: attn.flash_attention_fwd(q, k, v, mask, True), 5, 2),
            "plain_bwd_ms": cuda_ms(lambda: attn.flash_attention_bwd(
                q, k, v, mask, out, lse, do, True), 5, 2),
            "library_fwd_ms": cuda_ms(lib_fwd, 10, 2),
            "library_fwd_bwd_ms": cuda_ms(lib_fwd_bwd, 5, 2),
        }
        t["fwd_plus_bwd_ms"] = t["fwd_ms"] + t["bwd_ms"]
        prof = profile_call(lambda: (lib_fwd(), torch.cuda.synchronize()))
        t["library_kernels"] = [r["name"] for r in prof["top"][:3]]
        for kind, passes, tensors in (("fwd", 2, 4), ("bwd", 5, 8)):
            by, op = attention_work(b, h, s, d, passes, tensors)
            t.update(flash_bounds(kind, by, op))
        if s == SAS_LONG:  # the training batch, through the kernels only
            qb, kb, vb, dob = (torch.from_numpy(rng.standard_normal(
                (SAS_BATCH, h, s, d), dtype=np.float32)).to(dev) for _ in range(4))
            mb = torch.ones((SAS_BATCH, s), dtype=torch.int32, device=dev)
            ob, lb = dispatch.flash_attention_fwd(qb, kb, vb, mb, True)
            t[f"fwd_ms_b{SAS_BATCH}"] = cuda_ms(
                lambda: dispatch.flash_attention_fwd(qb, kb, vb, mb, True), 5, 1)
            t[f"bwd_ms_b{SAS_BATCH}"] = cuda_ms(
                lambda: dispatch.flash_attention_bwd(qb, kb, vb, mb, ob, lb, dob, True), 3, 1)
            for kind, passes, tensors in (("fwd", 2, 4), ("bwd", 5, 8)):
                bounds = flash_bounds(kind, *attention_work(SAS_BATCH, h, s, d, passes, tensors))
                t.update({f"{n}_b{SAS_BATCH}": x for n, x in bounds.items()})
            del qb, kb, vb, dob, ob
        emit({"phase": "timing", "kernel": "flash_attention", "shape": [b, h, s, d],
              "causal": True, "dtype": "f32", **t})
        res[s] = t
        del q, k, v, do, qg, kg, vg, out, keep
        torch.cuda.empty_cache()
    t = res[SAS_LEN]
    return {"flash_attention_fwd": {"ms": t["fwd_ms"], "plain_ms": t["plain_fwd_ms"],
                                    "bound_ms": t["fwd_bound_ms"],
                                    "bound_by": t["fwd_bound_by"],
                                    "f32_core_bound_ms": t["fwd_f32_core_bound_ms"],
                                    "library_ms": t["library_fwd_ms"]},
            "flash_attention_bwd": {"ms": t["bwd_ms"], "plain_ms": t["plain_bwd_ms"],
                                    "bound_ms": t["bwd_bound_ms"],
                                    "bound_by": t["bwd_bound_by"],
                                    "f32_core_bound_ms": t["bwd_f32_core_bound_ms"],
                                    "library_ms": t["library_fwd_bwd_ms"]}}


# -- YoutubeDNN ---------------------------------------------------------------
def phase_youtube_data() -> tuple:
    """The protocol's ratings with their side features (the two-tower
    phase's) and the retrieval dataset: (num_items, train, test, ratings,
    meta)."""
    from recsys_tpu_torch.data.movielens import build_seq_retrieval_dataset
    from recsys_tpu_torch.data.realistic import realistic_ratings

    t0 = time.perf_counter()
    ratings, meta = realistic_ratings(num_users=YOUTUBE_USERS, num_items=YOUTUBE_ITEMS, seed=0,
                                      return_meta=True)
    t1 = time.perf_counter()
    ni, train, test = build_seq_retrieval_dataset(ratings, maxlen=YOUTUBE_MAXLEN)
    emit({"phase": "youtube data", "users": YOUTUBE_USERS, "items": YOUTUBE_ITEMS,
          "events": len(ratings["user_id"]), "num_items": ni,
          "train_rows": len(train["item_id"]), "test_rows": len(test["item_id"]),
          "test_real_positions_share": float((test["hist"] != 0).mean()),
          "ratings_seconds": t1 - t0, "dataset_seconds": time.perf_counter() - t1})
    return ni, train, test, ratings, meta


def phase_youtube_check(rng, dev, num_items) -> dict:
    """retrieval_check on every case; returns the worst abs error of each
    kernel at the serving settings (f32 table at D = 32; k = 10)."""
    import torch

    import retrieval_check as rc
    from recsys_tpu_torch.kernels import dispatch

    worst = {"pooled_gather": 0.0, "topk_scores": 0.0}
    for b, d, dtype, skewed in itertools.product((1024, 1000), (YOUTUBE_DIM, 128),
                                                 (torch.float32, torch.bfloat16), (False, True)):
        table, rows, mask = rc.pooled_inputs(rng, b, YOUTUBE_MAXLEN, num_items, d, dtype,
                                             skewed, dev)
        res = rc.check_pooled(table, rows, mask, dispatch.pooled_gather)
        case = (f"pooled_gather b={b} L={YOUTUBE_MAXLEN} d={d} {str(dtype)[6:]} "
                f"{'zipf' if skewed else 'uniform'}")
        emit({"phase": "check", "case": case, **res, "rtol_of_abs_sum": rc.POOL_RTOL,
              "atol": rc.POOL_ATOL})
        if not res["ok"]:
            raise AssertionError(f"{case}: kernel disagrees with its plain version, or the "
                                 f"limit does not reject a wrong result: {res}")
        if d == YOUTUBE_DIM and dtype == torch.float32:
            worst["pooled_gather"] = max(worst["pooled_gather"], res["max_abs_err"])
        del table, rows, mask
    # the kernel's geometries: one pass of 64 positions and more, rows of 16
    # to 520 bytes (two examples a warp up to 64 bytes, column blocks, the
    # element-a-lane path at odd D), Zipf and uniform ids, an unaligned table
    summary = {"cases": 0, "worst_share_of_limit": 0.0, "least_wrong_err": float("inf")}
    for i, (length, d, dtype) in enumerate(itertools.product(
            POOL_GEOMETRY_L, POOL_GEOMETRY_D, (torch.float32, torch.bfloat16))):
        table, rows, mask = rc.pooled_inputs(rng, 333, length, num_items, d, dtype, i % 2 == 1,
                                             dev)
        for t in (table, rc.unaligned(table)) if dtype == torch.float32 else (table,):
            res = rc.check_pooled(t, rows, mask, dispatch.pooled_gather)
            ok = res["within"] and res["empty_rows_zero"] and (length == 1 or
                                                               res["wrong_rejected"])
            if not ok:
                case = (f"pooled_gather b=333 L={length} d={d} {str(dtype)[6:]} "
                        f"{'unaligned' if t is not table else 'aligned'}")
                emit({"phase": "check", "case": case, **res, "ok": False})
                raise AssertionError(f"{case}: kernel disagrees with its plain version, or "
                                     f"the limit does not reject a wrong result: {res}")
            summary["cases"] += 1
            summary["worst_share_of_limit"] = max(summary["worst_share_of_limit"],
                                                  res["worst_share_of_limit"])
            if length > 1:
                summary["least_wrong_err"] = min(summary["least_wrong_err"],
                                                 res["wrong_last_id_left_out_max_abs_err"])
        del table, rows, mask
    emit({"phase": "check", "case": "pooled_gather geometries", "lengths": POOL_GEOMETRY_L,
          "widths": POOL_GEOMETRY_D, **summary, "rtol_of_abs_sum": rc.POOL_RTOL,
          "atol": rc.POOL_ATOL, "ok": True})
    # (queries, items, width, k, unit vectors, duplicated rows at the plan's
    # tile and split boundaries)
    cases = [(nq, num_items, YOUTUBE_DIM, k, True, False) for nq in (YOUTUBE_BLOCK, 3616)
             for k in (1, YOUTUBE_K, 16)]
    cases.append((*YOUTUBE_SWEEP, YOUTUBE_K, False, False))
    # the geometry's edges: ragged query blocks and tiles, N = k + 1, the
    # widths of one to sixteen k-steps up to the domain's edge (128)
    cases += [(nq, n or k + 1, d, k, True, True) for nq, n, d in TOPK_GEOMETRY
              for k in (1, YOUTUBE_K, 16)]
    cases.append((*YOUTUBE_SWEEP, YOUTUBE_K, False, True))
    for nq, n, d, k, unit, boundary in cases:
        dup_at = None
        if boundary:
            plan = dispatch.topk_plan(nq, n, d, k)
            dup_at = rc.boundary_ids(n, plan[1], plan[3])
        q, items, dup = rc.topk_inputs(rng, nq, n, d, dev, normalize=unit, dup_at=dup_at)
        res = rc.check_topk(q, items, k, dispatch.topk_scores_fused, dup)
        case = (f"topk_scores q={nq} n={n} d={d} k={k} {'unit' if unit else 'normal'} vectors"
                f"{', ties across tile and split boundaries' if boundary else ''}")
        emit({"phase": "check", "case": case, **res, "score_rtol_of_norms": rc.SCORE_RTOL,
              "duplicated_rows": dup if len(dup) <= 8 else f"{len(dup)} ids"})
        if not res["ok"]:
            raise AssertionError(f"{case}: kernel disagrees with its plain version, or the "
                                 f"limits do not reject a wrong result: {res}")
        if k == YOUTUBE_K and unit:
            worst["topk_scores"] = max(worst["topk_scores"], res["max_abs_err"])
        del q, items
    # past the domain's edge both retrieval functions take the score route
    from recsys_tpu_torch.train.retrieval import topk_scores, topk_scores_streaming

    q, items, dup = rc.topk_inputs(rng, 1000, 5000, 129, dev)
    before = dispatch.LAUNCHES["topk_scores"]
    for fn in (topk_scores, topk_scores_streaming):
        res = rc.check_topk(q, items, YOUTUBE_K, fn, dup)
        emit({"phase": "check", "case": f"topk {fn.__name__} d=129 (past the kernel's widths)",
              **res, "ok": res["ok"]})
        if not res["ok"]:
            raise AssertionError(f"topk {fn.__name__} at D = 129 disagrees: {res}")
    if dispatch.LAUNCHES["topk_scores"] != before:
        raise AssertionError("topk at D = 129 launched the kernel")
    del q, items
    torch.cuda.empty_cache()
    return worst


def youtube_jax_params(rng, num_items) -> dict:
    """YoutubeDNN weights in the JAX package's layout (recsys_tpu/models/
    match/youtube_dnn.py): the history table row-packed as StackedEmbedding
    keeps it, uniform(-0.05, 0.05); the item table normal(0.05); the user
    tower's Dense_i kernels (in, out) scaled by 1/sqrt(in)."""
    from recsys_tpu_torch.convert import _pad8, pack_factor

    p = pack_factor(YOUTUBE_DIM, num_items)
    ws, bs = mlp_weights(rng, [YOUTUBE_DIM, *YOUTUBE_HIDDEN, YOUTUBE_DIM])
    return {"user_table": {"table_0": rng.uniform(
                -0.05, 0.05, (_pad8(-(-num_items // p)), p * YOUTUBE_DIM)).astype(np.float32)},
            "item_table": rng.standard_normal((num_items, YOUTUBE_DIM), dtype=np.float32)
            * np.float32(0.05),
            "user_mlp": {f"Dense_{j}": {"kernel": w, "bias": b}
                         for j, (w, b) in enumerate(zip(ws, bs))}}


def youtube_model(params, num_items, dev):
    from recsys_tpu_torch.convert import youtube_dnn_params_from_jax
    from recsys_tpu_torch.core.features import FeatureSchema, VarLenSparseFeature
    from recsys_tpu_torch.models.match.youtube_dnn import YoutubeDNN

    schema = FeatureSchema(varlen=[VarLenSparseFeature("hist_item", num_items, YOUTUBE_DIM,
                                                       max_len=YOUTUBE_MAXLEN)])
    model = YoutubeDNN(schema, num_items=num_items, embed_dim=YOUTUBE_DIM,
                       hidden_units=YOUTUBE_HIDDEN, pooling=YOUTUBE_POOLING, device=dev)
    model.load_state_dict(youtube_dnn_params_from_jax(params, model))
    return model


@contextlib.contextmanager
def plain_retrieval():
    """Route the pooled gather and the top-k through their plain versions on
    the card, for the comparisons: the same model, the same calls."""
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels import embedding as emb_ref
    from recsys_tpu_torch.kernels import topk as topk_ref

    saved = dispatch.pooled_gather, dispatch.topk_scores_fused
    dispatch.pooled_gather, dispatch.topk_scores_fused = emb_ref.pooled_gather, \
        topk_ref.topk_scores
    try:
        yield
    finally:
        dispatch.pooled_gather, dispatch.topk_scores_fused = saved


def youtube_category(name: str) -> str:
    """The category of a device kernel in a YoutubeDNN profile."""
    low = name.lower()
    for cat, keys in (("pooled gather", ("pooled_gather",)),
                      ("top-k", ("topk",)),
                      ("MLP GEMMs", ("gemm", "gemv", "xmma", "cutlass", "splitk", "kernel2")),
                      ("loss", ("softmax", "nll", "cross_entropy")),
                      ("table gradients (index_add, embedding backward)",
                       ("index", "embedding", "scatter", "sort", "radix")),
                      ("optimizer", ("adam", "multi_tensor")),
                      ("normalisation (norms, divisions)", ("norm", "reduce", "div", "clamp")),
                      ("host-device copies", ("memcpy",))):
        if any(k in low for k in keys):
            return cat
    return "other (elementwise)"


def youtube_serve_block(model, hist, items, dev):
    """run_seqret's serving step on one block of histories: the user tower,
    then the top-k over the whole catalog; the ids come back to the host."""
    import torch

    from recsys_tpu_torch.train.retrieval import topk_scores

    with torch.inference_mode():
        u = model.user_embed({"hist": torch.from_numpy(hist).to(dev)})
        return topk_scores(u, items, k=YOUTUBE_K)[1].cpu().numpy()


def phase_youtube_serve(model, test, num_items, dev, label) -> dict:
    """Retrieval over the test users in 8192-query blocks; recall@10."""
    import torch

    import retrieval_check as rc
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels import topk as topk_ref
    from recsys_tpu_torch.train.metrics import recall_at_k
    from recsys_tpu_torch.train.retrieval import topk_scores

    model.eval()
    hist, n = test["hist"], len(test["hist"])
    blocks = -(-n // YOUTUBE_BLOCK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts zeroed just before, read just after
    dispatch.reset_launches()
    with torch.inference_mode():
        items = model.all_item_embeddings()
    ids = np.concatenate([youtube_serve_block(model, hist[s:s + YOUTUBE_BLOCK], items, dev)
                          for s in range(0, n, YOUTUBE_BLOCK)])
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    expected = {**dict.fromkeys(launches, 0), "pooled_gather": blocks, "topk_scores": blocks}
    if launches != expected or ids.shape != (n, YOUTUBE_K):
        raise AssertionError(f"youtube serve {label}: launches {launches}, expected "
                             f"{expected}, ids {ids.shape}")
    recall = recall_at_k(ids, test["item_id"])

    # kernels against plain versions on the first and the ragged last block
    errs, equal, agree, same = [], [], [], []
    for lo in (0, (blocks - 1) * YOUTUBE_BLOCK):
        h = {"hist": torch.from_numpy(hist[lo:lo + YOUTUBE_BLOCK]).to(dev)}
        with torch.inference_mode():
            u_k = model.user_embed(h)
            v_k, i_k = topk_scores(u_k, items, k=YOUTUBE_K)
            with plain_retrieval():
                u_p = model.user_embed(h)
            v_p, i_p = topk_ref.topk_scores(u_p, items, YOUTUBE_K)
        errs.append(check_close(f"youtube serve {label} user vectors rows {lo}..",
                                u_k, u_p, YOUTUBE_EMB_TOL))
        equal.append(float((i_k == i_p).double().mean()))
        agree.append(rc.topk_agrees(v_k, i_k, v_p, u_p, items, rc.score_limit(u_p, items)))
        same.append(np.array_equal(i_k.cpu().numpy(), ids[lo:lo + YOUTUBE_BLOCK]))
    emit({"phase": "check", "case": f"youtube serve {label} top-10 kernels vs plain",
          "indices_equal_share": min(equal), "ranks_agree_within_score_limit": all(agree),
          "blocks_served_again_identical": all(same),
          "score_rtol_of_norms": rc.SCORE_RTOL, "ok": all(agree)})
    if not all(agree):
        raise AssertionError(f"youtube serve {label}: top-10 disagrees with the plain path")

    one = hist[:YOUTUBE_BLOCK]
    lat = []
    for _ in range(7):
        t0 = time.perf_counter()
        youtube_serve_block(model, one, items, dev)
        lat.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for s in range(0, n, YOUTUBE_BLOCK):
        youtube_serve_block(model, hist[s:s + YOUTUBE_BLOCK], items, dev)
    wall = time.perf_counter() - t0
    emit({"phase": "profile", "config": f"youtube serve {label}",
          **profile_call(lambda: youtube_serve_block(model, one, items, dev),
                         youtube_category)})
    res = {"phase": "youtube serve", "config": label, "queries": n, "blocks": blocks,
           "num_items": num_items, "recall@10": recall, "random_recall@10": YOUTUBE_K / num_items,
           "launches": launches, "expected_launches": expected,
           "max_abs_err": max(e["max_abs_err"] for e in errs),
           "indices_equal_share": min(equal),
           "block_ms_median": float(np.median(lat)), "block_ms_min": float(np.min(lat)),
           "queries_per_s": n / wall,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    print(f"youtube serve ({label}): recall@10={recall:.4f} over {num_items} items "
          f"(random {YOUTUBE_K / num_items:.5f})", flush=True)
    emit(res)
    return res


def phase_youtube_train(model, train, num_items, dev):
    """Trainer.fit for YOUTUBE_STEPS steps; returns (result, the model as
    the fit left it)."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.train import losses
    from recsys_tpu_torch.train.loop import Trainer

    # logQ from the train stream's item counts, as run_seqret
    log_q = losses.popularity_log_q(np.bincount(train["item_id"], minlength=num_items)).to(dev)

    def loss_fn(out, batch):
        return losses.in_batch_sampled_softmax(out["user"], out["item"],
                                               item_log_q=log_q[batch["item_id"].long()])

    order = np.random.default_rng(0).permutation(len(train["item_id"]))
    n = YOUTUBE_STEPS * YOUTUBE_BATCH
    head = {k: v[order[:n]] for k, v in train.items()}
    extra = {k: v[order[n:n + YOUTUBE_BATCH]] for k, v in train.items()}
    trainer = Trainer(model, loss_fn=loss_fn, learning_rate=LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts zeroed just before, read just after
    dispatch.reset_launches()
    t0 = time.perf_counter()
    hist = trainer.fit(head, batch_size=YOUTUBE_BATCH, epochs=1, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(dispatch.LAUNCHES)
    expected = {**dict.fromkeys(launches, 0), "pooled_gather": YOUTUBE_STEPS}
    if launches != expected:
        raise AssertionError(f"youtube train: launches {launches}, expected {expected}")
    if not np.isfinite(hist["loss"]).all():
        raise AssertionError(f"youtube train: loss {hist['loss']} not finite")
    peak = torch.cuda.max_memory_allocated()
    fitted = copy.deepcopy(trainer.model)  # the steps below train on one batch

    ref = copy.deepcopy(trainer)
    loss_k = trainer.train_step(extra)
    with plain_retrieval():
        loss_p = ref.train_step(extra)
    cmp = compare_sasrec_step(f"batch={YOUTUBE_BATCH}", trainer, ref, loss_k, loss_p,
                              label="youtube")
    del ref

    steps_ms = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(extra)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "profile", "config": "youtube train",
          **profile_call(lambda: (trainer.train_step(extra), torch.cuda.synchronize()),
                         youtube_category)})
    res = {"phase": "youtube train", "steps": YOUTUBE_STEPS, "rows": n, "batch": YOUTUBE_BATCH,
           "epoch_loss": hist["loss"][0], "launches": launches, "expected_launches": expected,
           "step_check": cmp,
           "step_ms_median": float(np.median(steps_ms)), "step_ms_min": float(np.min(steps_ms)),
           "step_examples_per_s": YOUTUBE_BATCH / (float(np.median(steps_ms)) / 1e3),
           "fit_seconds": fit_s, "fit_examples_per_s": n / fit_s,
           "max_memory_allocated_bytes": peak}
    emit(res)
    return res, fitted


def phase_youtube_timing(rng, dev, test_hist, num_items) -> dict:
    """Kernel, plain and library ms and launch floors: the pooled gather on
    the first serving block of test histories (D = 32, f32 table); the top-k
    at the serving block (8192 unit queries over the catalog, D = 32) and at
    the sweep shape (1024 x 1,000,000 x 64, normal vectors), k = 10."""
    import torch
    import torch.nn.functional as F

    from recsys_tpu_torch.kernels import build, dispatch
    from recsys_tpu_torch.kernels import embedding as emb_ref
    from recsys_tpu_torch.kernels import topk as topk_ref

    rows_np = test_hist[:YOUTUBE_BLOCK]
    b, length = rows_np.shape
    table = torch.from_numpy(rng.standard_normal((num_items, YOUTUBE_DIM),
                                                 dtype=np.float32)).to(dev)
    rows = torch.from_numpy(rows_np).to(dev)
    mask = rows != 0
    weights = mask.float()
    touched = len(np.unique(rows_np[rows_np != 0]))
    # each input once: the rows the real positions touch, the ids and the
    # bool mask; the output once
    bound_ms, kind = bound(touched * YOUTUBE_DIM * 4 + b * length * 5 + b * YOUTUBE_DIM * 4,
                           float((rows_np != 0).sum()) * YOUTUBE_DIM, F32_FLOPS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pool_lib = build.libraries()["pooled_gather"]
    pooled = {"ms": cuda_ms(lambda: dispatch.pooled_gather(table, rows, mask), iters=200),
              "plain_ms": cuda_ms(lambda: emb_ref.pooled_gather(table, rows, mask)),
              "library_ms": cuda_ms(lambda: F.embedding_bag(rows, table, mode="sum",
                                                            per_sample_weights=weights),
                                    iters=200),
              "bound_ms": bound_ms, "bound_by": kind, "shape": [b, length, YOUTUBE_DIM],
              "rows_touched": touched, "real_positions": int((rows_np != 0).sum()),
              "bound_ms_every_position_read": bound(
                  b * length * YOUTUBE_DIM * 4 + b * length * 8 + b * YOUTUBE_DIM * 4, 0,
                  F32_FLOPS)[0],
              "library": "F.embedding_bag(mode='sum', per_sample_weights=mask)",
              "launch_floor_ms": cuda_ms(lambda: pool_lib.pooled_gather_floor(
                  b, YOUTUBE_DIM, stream), 200, 10)}
    emit({"phase": "timing", "kernel": "pooled_gather", "dtype": "f32", **pooled})

    res = {"pooled_gather": pooled}
    for name, (nq, n, d), unit in (("serving", (YOUTUBE_BLOCK, num_items, YOUTUBE_DIM), True),
                                   ("sweep", YOUTUBE_SWEEP, False)):
        q = torch.from_numpy(rng.standard_normal((nq, d), dtype=np.float32)).to(dev)
        items = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
        if unit:
            q, items = q / q.norm(dim=1, keepdim=True), items / items.norm(dim=1, keepdim=True)
        k = YOUTUBE_K
        # split TF32: 3 TF32 products an f32 product on the tensor cores; the
        # CUDA cores' exact f32 beside it
        nbytes, ops = (nq * d + n * d) * 4 + nq * k * 8, 2.0 * nq * n * d
        bound_ms, kind = bound(nbytes, 3 * ops, TF32_FLOPS)
        plan = dispatch.topk_plan(nq, n, d, k)
        floor_ms = cuda_ms(lambda: build.libraries()["topk_scores"].topk_scores_floor(
            nq, ctypes.cast(plan, ctypes.c_void_p), stream), 200, 10)
        t = {"ms": cuda_ms(lambda: dispatch.topk_scores_fused(q, items, k), 20, 3),
             "plain_ms": cuda_ms(lambda: topk_ref.topk_scores(q, items, k), 3, 1),
             "library_ms": cuda_ms(lambda: torch.topk(q @ items.T, k), 5, 2),
             "bound_ms": bound_ms, "bound_by": kind,
             "f32_core_bound_ms": bound(nbytes, ops, F32_FLOPS)[0], "launch_floor_ms": floor_ms,
             "plan": {"tile_n": plan[1], "splits": plan[2], "per_split": plan[3],
                      "smem_bytes": plan[4]},
             "shape": [nq, n, d], "k": k,
             "library": "torch.topk(q @ items.T, k): two calls, the (Q, N) scores "
                        "materialised"}
        emit({"phase": "timing", "kernel": f"topk_scores {name}", "dtype": "f32", **t})
        res[f"topk_scores {name}"] = t
        del q, items
        torch.cuda.empty_cache()
    res["topk_scores"] = res["topk_scores serving"]
    return res


# -- the CTR protocol models ---------------------------------------------------
MIND_DIM = 32           # protocol mind's widths
MIND_K = 4
MIND_ITERS = 3
MIND_UNITS = (64,)
MIND_BATCH = 1024
MIND_STEPS = 50
TT_BATCH = 2048          # protocol dssm's widths and batch
TT_STEPS = 20


def logq_loss(train_item_ids, num_items, dev):
    """The logQ-corrected in-batch softmax of the retrieval protocols, its
    log q from the train stream's item counts."""
    from recsys_tpu_torch.tools.protocol import logq_softmax
    from recsys_tpu_torch.train import losses

    return logq_softmax(losses.popularity_log_q(
        np.bincount(train_item_ids, minlength=num_items)).to(dev))


def timed_steps(trainer, batch, n=7) -> list:
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def check_served_topk(label, served, items) -> dict:
    """Each served block's (queries, values, ids) from the kernel against the
    plain top-k of the same queries, by retrieval_check's near-tie rule."""
    import retrieval_check as rc
    from recsys_tpu_torch.kernels import topk as topk_ref

    import torch

    agree, equal = [], []
    with torch.inference_mode():
        for q, v, i in served:
            want_v, want_i = topk_ref.topk_scores(q, items, v.shape[1])
            agree.append(rc.topk_agrees(v, i, want_v, q, items, rc.score_limit(q, items)))
            equal.append(float((i == want_i).double().mean()))
    res = {"phase": "check", "case": f"{label} top-10 kernel launches vs plain",
           "launches_checked": len(served), "indices_equal_share": min(equal),
           "ranks_agree_within_score_limit": all(agree), "score_rtol_of_norms": rc.SCORE_RTOL,
           "ok": all(agree)}
    emit(res)
    if not all(agree):
        raise AssertionError(f"{label}: a top-10 launch disagrees with the plain top-k")
    return res


def phase_mind(train, test, num_items, dev) -> dict:
    """MIND at protocol mind's widths, weights from the seed: MIND_STEPS
    train steps of MIND_BATCH rows (the logQ softmax; no kernel on this
    path), then run_mind's serving over the test users in its blocks
    (``protocol.mind_block_topk``): the capsules' top-10 through the top-k
    kernel (every launch held against the plain top-k), the merge into 10
    distinct items and recall@10."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.models.match.mind import MIND
    from recsys_tpu_torch.tools.protocol import MIND_BLOCK, mind_block_topk
    from recsys_tpu_torch.train.loop import Trainer
    from recsys_tpu_torch.train.metrics import recall_at_k

    torch.manual_seed(0)
    model = MIND(num_items, embed_dim=MIND_DIM, k_max=MIND_K, routing_iterations=MIND_ITERS,
                 user_units=MIND_UNITS, device=dev)
    trainer = Trainer(model, loss_fn=logq_loss(train["item_id"], num_items, dev),
                      learning_rate=LR)
    order = np.random.default_rng(0).permutation(len(train["item_id"]))
    batches = [{k: v[order[s * MIND_BATCH:(s + 1) * MIND_BATCH]] for k, v in train.items()}
               for s in range(MIND_STEPS + 1)]
    torch.cuda.synchronize()
    # the main path: counts zeroed just before, read just after
    dispatch.reset_launches()
    t0 = time.perf_counter()
    losses = [trainer.train_step(b) for b in batches[:MIND_STEPS]]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = dict(dispatch.LAUNCHES)
    losses = [float(x) for x in losses]
    if train_launches != ctr_expected({}) or not np.isfinite(losses).all() or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"mind train: launches {train_launches}, losses {losses[0]} .. "
                             f"{losses[-1]} (finite, falling)")
    steps_ms = timed_steps(trainer, batches[-1])

    model.eval()
    hist, n = test["hist"], len(test["hist"])
    blocks = -(-n // MIND_BLOCK)

    def serve(h):
        return mind_block_topk(model, h, items, k=YOUTUBE_K)

    torch.cuda.synchronize()
    dispatch.reset_launches()
    with torch.inference_mode():
        items = model.all_item_embeddings()
        served = [serve(hist[s:s + MIND_BLOCK]) for s in range(0, n, MIND_BLOCK)]
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    expected = ctr_expected({"topk_scores": blocks})
    merged = np.concatenate([r[3] for r in served])
    if launches != expected or merged.shape != (n, YOUTUBE_K):
        raise AssertionError(f"mind serve: launches {launches}, expected {expected}")
    recall = recall_at_k(merged, test["item_id"])
    check = check_served_topk("mind serve", [r[:3] for r in served], items)
    lat = []
    with torch.inference_mode():
        for _ in range(7):
            t0 = time.perf_counter()
            serve(hist[:MIND_BLOCK])
            lat.append((time.perf_counter() - t0) * 1e3)
    res = {"phase": "mind", "steps": MIND_STEPS, "batch": MIND_BATCH, "first_loss": losses[0],
           "last_loss": losses[-1], "train_launches": train_launches,
           "train_seconds": train_s, "step_ms_median": float(np.median(steps_ms)),
           "step_examples_per_s": MIND_BATCH / (float(np.median(steps_ms)) / 1e3),
           "queries": n, "blocks": blocks, "recall@10": recall,
           "random_recall@10": YOUTUBE_K / num_items, "launches": launches,
           "expected_launches": expected, "indices_equal_share": check["indices_equal_share"],
           "block_ms_median": float(np.median(lat)), "block_ms_min": float(np.min(lat)),
           "users_per_s": MIND_BLOCK / (float(np.median(lat)) / 1e3)}
    print(f"mind: loss {losses[0]:.4f} -> {losses[-1]:.4f} over {MIND_STEPS} steps; "
          f"recall@10={recall:.4f} over {num_items} items (random {YOUTUBE_K / num_items:.5f})",
          flush=True)
    emit(res)
    return res


def phase_two_tower(ratings, meta, dev) -> dict:
    """DSSM, SENet-DSSM and FM-match at protocol dssm's widths (the ratings
    of the youtube phase with their side features): TT_STEPS steps of
    TT_BATCH rows each (FM-match through the bi-interaction kernel, its
    output on one batch held against the plain version), then run_dssm's
    serving (``protocol.tower_block_topk``): top-10 over the catalog in
    user blocks through the top-k kernel, every launch held against the
    plain top-k, and recall@10.  {model: result}."""
    import torch

    import ctr_check
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.models.match.fm_match import FMMatch
    from recsys_tpu_torch.models.match.two_tower import TwoTower
    from recsys_tpu_torch.tools.protocol import (TOWER_BLOCK, dssm_data, tower_block_topk,
                                                 tower_item_embeddings)
    from recsys_tpu_torch.train.loop import Trainer
    from recsys_tpu_torch.train.metrics import recall_at_k

    data = dssm_data(ratings, meta, YOUTUBE_ITEMS)
    out = {}
    for name in ("dssm", "senet", "fm_match"):
        torch.manual_seed(0)
        if name == "fm_match":
            model = FMMatch(data["user_schema"], data["item_schema"], device=dev)
            train = data["bce_train"]
            trainer = Trainer(model, learning_rate=LR)
        else:
            model = TwoTower(data["user_schema"], data["item_schema"], out_dim=32,
                             use_senet=(name == "senet"), output_mode="pair", device=dev)
            train = data["pair_train"]
            trainer = Trainer(model, loss_fn=logq_loss(train["item_id"],
                                                       YOUTUBE_ITEMS + 1, dev),
                              learning_rate=LR)
        order = np.random.default_rng(0).permutation(len(next(iter(train.values()))))
        head = {k: v[order[:TT_STEPS * TT_BATCH]] for k, v in train.items()}
        extra = {k: v[order[TT_STEPS * TT_BATCH:(TT_STEPS + 1) * TT_BATCH]]
                 for k, v in train.items()}
        torch.cuda.synchronize()
        # the main path: counts zeroed just before, read just after
        dispatch.reset_launches()
        hist = trainer.fit(head, batch_size=TT_BATCH, epochs=1, verbose=False)
        torch.cuda.synchronize()
        train_launches = dict(dispatch.LAUNCHES)
        want = ctr_expected({"fm_pairwise_vector": TT_STEPS} if name == "fm_match" else {})
        if train_launches != want or not np.isfinite(hist["loss"]).all():
            raise AssertionError(f"{name} train: launches {train_launches}, expected {want}, "
                                 f"loss {hist['loss']}")
        steps_ms = timed_steps(trainer, extra)
        res = {"phase": "two-tower", "model": name, "steps": TT_STEPS, "batch": TT_BATCH,
               "epoch_loss": hist["loss"][0], "train_launches": train_launches,
               "step_ms_median": float(np.median(steps_ms))}
        model.eval()
        if name == "fm_match":
            with torch.no_grad():
                fields = torch.cat([
                    model.user_table(torch.from_numpy(extra["user_sparse"]).to(dev)),
                    model.item_table(torch.from_numpy(extra["item_sparse"]).to(dev))], 1)
            fm = ctr_check.check(dispatch.fm_pairwise_vector_fused, fields.contiguous())
            ok = fm["excess"] <= 1.0 and fm["wrong_least_excess"] > 1.0
            emit({"phase": "check", "case": f"fm_match fields {tuple(fields.shape)} fm kernel "
                  "vs plain", **fm, "limit": f"{ctr_check.LIMIT} of (sum_f |x_fd|)^2",
                  "ok": ok})
            if not ok:
                raise AssertionError(f"fm_match: the bi-interaction kernel disagrees: {fm}")
            res["fm_max_abs_err"] = fm["max_abs_err"]

        cat, users = data["catalog"], data["test_users"]
        blocks = -(-len(users) // TOWER_BLOCK)

        def block(u):
            return tower_block_topk(model, meta, u, items, k=YOUTUBE_K)

        torch.cuda.synchronize()
        dispatch.reset_launches()
        with torch.inference_mode():
            items = tower_item_embeddings(model, cat, dev)
            served = [block(users[s:s + TOWER_BLOCK])
                      for s in range(0, len(users), TOWER_BLOCK)]
            ids = np.concatenate([r[3] for r in served])
        torch.cuda.synchronize()
        launches = dict(dispatch.LAUNCHES)
        want = ctr_expected({"topk_scores": blocks})
        if launches != want:
            raise AssertionError(f"{name} serve: launches {launches}, expected {want}")
        recall = recall_at_k(ids, data["test_items"])
        check = check_served_topk(f"{name} serve", [r[:3] for r in served], items)
        lat = []
        with torch.inference_mode():
            for _ in range(7):
                t0 = time.perf_counter()
                block(users[:TOWER_BLOCK])
                lat.append((time.perf_counter() - t0) * 1e3)
        res.update({"queries": len(users), "blocks": blocks, "recall@10": recall,
                    "random_recall@10": YOUTUBE_K / YOUTUBE_ITEMS, "launches": launches,
                    "expected_launches": want,
                    "indices_equal_share": check["indices_equal_share"],
                    "block_ms_median": float(np.median(lat)),
                    "block_ms_min": float(np.min(lat))})
        print(f"two-tower {name}: {TT_STEPS} steps, loss {hist['loss'][0]:.4f}; "
              f"recall@10={recall:.4f} over {YOUTUBE_ITEMS} items", flush=True)
        emit(res)
        out[name] = res
    return out


PROTOCOL_USERS = 20_000  # the protocol's 100,000, cut: the phase stays short


def phase_protocol_seq(dev) -> dict:
    """The port's protocol runner in the modes sasrec (drift 2.0, its rows
    from the native builder), seqret, mind and dssm at the full widths,
    users cut to PROTOCOL_USERS, one epoch each: each prints its JSON line,
    launches the kernels of its path and none other, and reports finite
    metrics.  {mode: report}."""
    import io

    import torch

    from recsys_tpu_torch.data import native
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.tools import protocol

    builds = []
    builder = native.build_seq_leave_last2

    def counted(*args, **kw):
        builds.append(time.perf_counter())
        out = builder(*args, **kw)
        builds.append(time.perf_counter())
        return out

    paths = {"sasrec": ("flash_attention_fwd", "flash_attention_bwd"),
             "seqret": ("pooled_gather", "topk_scores"),
             "mind": ("topk_scores",),
             "dssm": ("fm_pairwise_vector", "topk_scores")}
    out = {}
    for mode, kernels in paths.items():
        argv = [mode, "--users", str(PROTOCOL_USERS), "--epochs", "1", "--device", str(dev)]
        if mode == "sasrec":
            argv += ["--drift-scale", "2.0"]
        buf = io.StringIO()
        builds.clear()
        native.build_seq_leave_last2 = counted
        torch.cuda.synchronize()
        # the main path: counts zeroed just before, read just after
        dispatch.reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                protocol.main(argv)
        finally:
            native.build_seq_leave_last2 = builder
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(dispatch.LAUNCHES)
        if len(builds) != (2 if mode == "sasrec" else 0):
            raise AssertionError(f"protocol {mode}: the native sequence builder ran "
                                 f"{len(builds) // 2} times")
        line = buf.getvalue().strip().splitlines()[-1]
        print(line, flush=True)
        rep = json.loads(line)
        metrics = [v for k, v in ([*rep.items()] + [(f"{m}.{k}", v) for m, r in
                                                   rep.get("models", {}).items()
                                                   for k, v in r.items()])
                   if k.split(".")[-1] in ("HR@10", "NDCG@10", "recall@10")]
        off = {k: n for k, n in launches.items() if (n > 0) != (k in kernels)}
        if off or not metrics or not all(0.0 <= v <= 1.0 for v in metrics):
            raise AssertionError(f"protocol {mode}: launches {launches} (the path's: "
                                 f"{kernels}), metrics {metrics}")
        out[mode] = {"phase": "protocol seq", "mode": mode, "seconds": wall,
                     "launches": launches, "report": rep}
        if builds:
            out[mode]["native_builder_seconds"] = builds[1] - builds[0]
        emit(out[mode])
    return out


NCF_BATCH = 1024         # protocol ncf's batch
NCF_REQUEST = 1024       # test users a ranked request, each with 100 negatives
DIN_BATCH = 1024         # protocol din's batch and history length
DIN_MAXLEN = 40
MT_ROWS = 200_000        # protocol multitask's 1,000,000 rows, cut
MT_BATCH = 512
CENSUS_ROWS = 20_000     # protocol census's 200,000 train rows, cut
SLICE_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 on both sides, TF32 off


def timed(fn, *args) -> tuple:
    """(fn(*args), its wall seconds)."""
    t0 = time.perf_counter()
    return fn(*args), time.perf_counter() - t0


def no_launches(label: str, launches: dict) -> None:
    """Raise unless ``launches`` counts no launch of any kernel: the five
    models of the last slice reach none (their JAX modules reach no Pallas
    kernel either)."""
    if launches != ctr_expected({}):
        raise AssertionError(f"{label}: launches {launches}, expected none")


def timed_requests(trainer, data, batch, n=7) -> list:
    import torch

    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        trainer.predict(data, batch_size=batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def card_against_cpu(label: str, trainer, data: dict, batch: int) -> dict:
    """``trainer``'s model on ``data`` in one request on the card against a
    copy of it on the CPU, each output within SLICE_TOL; no launch."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.train.loop import Trainer

    want = Trainer(copy.deepcopy(trainer.model).cpu(), loss_fn=trainer.loss_fn,
                   device="cpu").predict(data, batch_size=batch)
    torch.cuda.synchronize()
    dispatch.reset_launches()
    got = trainer.predict(data, batch_size=batch)
    torch.cuda.synchronize()
    no_launches(f"{label} request", dict(dispatch.LAUNCHES))
    pairs = got.items() if isinstance(got, dict) else [("out", got)]
    want = want if isinstance(want, dict) else {"out": want}
    return {k: check_close(f"{label} request {k} card vs cpu", torch.from_numpy(v),
                           torch.from_numpy(want[k]), SLICE_TOL)["max_abs_err"]
            for k, v in pairs}


def step_against_cpu(label: str, trainer, batch: dict) -> dict:
    """One more train_step on the card against the same step of a copy on
    the CPU: the loss within SLICE_TOL, every state cell (the BatchNorm
    statistics among them) within 1e-5 but at most STEP_STATE_SHARE of
    them, which Adam's first steps may move by up to 2·lr where a gradient
    is near 0."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.train.loop import Trainer

    cpu = Trainer(copy.deepcopy(trainer.model).cpu(), loss_fn=trainer.loss_fn,
                  learning_rate=LR, device="cpu")
    cpu.optimizer.load_state_dict(copy.deepcopy(trainer.optimizer.state_dict()))
    torch.cuda.synchronize()
    dispatch.reset_launches()
    loss = trainer.train_step(batch)
    torch.cuda.synchronize()
    no_launches(f"{label} step", dict(dispatch.LAUNCHES))
    want_loss = cpu.train_step(batch)
    check_close(f"{label} step loss card vs cpu", loss.cpu().reshape(1),
                want_loss.reshape(1), SLICE_TOL)
    off = total = 0
    worst_stat = 0.0
    for name, w in cpu.model.state_dict().items():
        diff = (trainer.model.state_dict()[name].cpu().double() - w.double()).abs()
        if name.endswith((".mean", ".var")):
            worst_stat = max(worst_stat, float(diff.max()))
        if float(diff.max()) > 2 * LR * 1.001:
            raise AssertionError(f"{label} step: {name} off by {float(diff.max())}")
        off += int((diff > 1e-5).sum())
        total += diff.numel()
    res = {"phase": "check", "case": f"{label} step state card vs cpu",
           "share_off_1e-5": off / total, "bn_stats_max_abs_err": worst_stat,
           "ok": off / total <= STEP_STATE_SHARE and worst_stat <= 1e-5}
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"{label} step: state off the CPU step: {res}")
    return res


def fit_no_launch(label: str, trainer, train: dict, batch: int, **kw) -> tuple:
    """``trainer.fit`` for one epoch, counts zeroed just before and read just
    after (none may launch); returns (history, seconds)."""
    import torch

    from recsys_tpu_torch.kernels import dispatch

    torch.cuda.synchronize()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    hist = trainer.fit(train, batch_size=batch, epochs=1, verbose=False, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    no_launches(f"{label} fit", dict(dispatch.LAUNCHES))
    if not np.isfinite(hist["loss"]).all():
        raise AssertionError(f"{label}: loss {hist['loss']}")
    return hist, seconds


def phase_ncf(ratings, dev) -> dict:
    """NCF at protocol ncf's widths on the youtube phase's ratings (20,000
    users): build_ncf_dataset_fast, one epoch of fit at 1024 rows with the
    ranked HR@10 as its eval_fn (its time left out of the step rate), no
    kernel launched; a 101-candidate request of NCF_REQUEST test users on
    the card against the CPU; one more step against the CPU step; request
    time."""
    import torch

    from recsys_tpu_torch.data.realistic import build_ncf_dataset_fast
    from recsys_tpu_torch.models.match.ncf import NCF
    from recsys_tpu_torch.tools.protocol import ncf_loss, ranked_eval
    from recsys_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    nu, ni, train, _, test = build_ncf_dataset_fast(ratings)
    build_s = time.perf_counter() - t0
    torch.manual_seed(0)
    trainer = Trainer(NCF(nu, ni, device=dev), loss_fn=ncf_loss, learning_rate=LR)
    readings = []
    hist, fit_s = fit_no_launch("ncf", trainer, train, NCF_BATCH,
                                eval_fn=ranked_eval(test, readings))
    eval_s = sum(r[2] for r in readings)
    fit_s -= eval_s  # the step rate leaves the ranked reading out, as run_ncf's
    hr, ndcg = hist["HR@10"][0], hist["NDCG@10"][0]
    if not 0.0 <= ndcg <= hr <= 1.0:
        raise AssertionError(f"ncf: HR@10 {hr}, NDCG@10 {ndcg}")
    request = {k: v[:NCF_REQUEST] for k, v in test.items()}
    errs = card_against_cpu("ncf", trainer, request, NCF_REQUEST)
    extra = {k: v[:NCF_BATCH] for k, v in train.items()}
    step_against_cpu("ncf", trainer, extra)
    lat = timed_requests(trainer, request, NCF_REQUEST)
    n = len(train["user"])
    res = {"phase": "ncf", "users": nu, "items": ni, "train_rows": n, "build_seconds": build_s,
           "epoch_loss": hist["loss"][0], "HR@10": hr, "NDCG@10": ndcg,
           "random_HR@10": 10 / 101, "fit_seconds": fit_s, "eval_seconds": eval_s,
           "fit_examples_per_s": (n - n % NCF_BATCH) / fit_s, "request_max_abs_err": errs,
           "request_ms_median": float(np.median(lat)), "launches": ctr_expected({})}
    print(f"ncf: {n} rows, one epoch, HR@10={hr:.4f} NDCG@10={ndcg:.4f}", flush=True)
    emit(res)
    return res


def phase_din(ratings, meta, dev) -> dict:
    """DIN with PReLU and with Dice at protocol din's widths (maxlen 40, 12
    train positions a user) on the youtube phase's ratings and categories:
    one epoch of fit at 1024 rows with the val split, evaluate_auc on the
    test rows, no kernel launched; a request against the CPU and one more
    step against the CPU step, the BatchNorm statistics within 1e-5.
    {activation: result}."""
    import torch

    from recsys_tpu_torch.data.realistic import build_din_dataset_fast
    from recsys_tpu_torch.models.ctr.din import DIN
    from recsys_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    schema, train, val, test = build_din_dataset_fast(
        ratings, meta["item_cate"], meta["num_cates"], maxlen=DIN_MAXLEN,
        max_train_positions=12, seed=0)
    build_s = time.perf_counter() - t0
    out = {}
    for act in ("prelu", "dice"):
        torch.manual_seed(0)
        trainer = Trainer(DIN(schema, ffn_activation=act, device=dev), learning_rate=LR)
        hist, fit_s = fit_no_launch(f"din {act}", trainer, train, DIN_BATCH, val_data=val)
        auc = trainer.evaluate_auc(test)
        if not 0.5 < auc <= 1.0:
            raise AssertionError(f"din {act}: test AUC {auc}")
        errs = card_against_cpu(f"din {act}", trainer, {k: v[:4096] for k, v in test.items()},
                                4096)
        step = step_against_cpu(f"din {act}", trainer,
                                {k: v[:DIN_BATCH] for k, v in train.items()})
        lat = timed_requests(trainer, {k: v[:4096] for k, v in test.items()}, 4096)
        n = len(train["label"])
        out[act] = {"phase": "din", "activation": act, "train_rows": n,
                    "build_seconds": build_s, "epoch_loss": hist["loss"][0],
                    "val_loss": hist["val_loss"][0], "test_auc": auc, "fit_seconds": fit_s,
                    "fit_examples_per_s": (n - n % DIN_BATCH) / fit_s,
                    "request_max_abs_err": errs["out"],
                    "bn_stats_max_abs_err": step["bn_stats_max_abs_err"],
                    "request_4096_ms_median": float(np.median(lat)),
                    "launches": ctr_expected({})}
        print(f"din {act}: {n} rows, one epoch, test AUC={auc:.4f}", flush=True)
        emit(out[act])
    return out


def phase_multitask(dev) -> dict:
    """ESMM, MMoE and PLE at protocol multitask's widths on MT_ROWS
    realistic_multitask rows, one epoch each with the val split, head
    AUCs, a request and a step against the CPU; then MMoE and PLE on
    census-format rows (CENSUS_ROWS train) written to CSV files and read
    back by the loader, one epoch each.  No kernel launches.  {run:
    result}."""
    import tempfile

    import torch

    from recsys_tpu_torch.data import census
    from recsys_tpu_torch.data.realistic import realistic_census, realistic_multitask
    from recsys_tpu_torch.tools.protocol import head_aucs, multitask_model
    from recsys_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    schema, data, meta = realistic_multitask(num_examples=MT_ROWS, seed=0)
    gen_s = time.perf_counter() - t0
    idx = np.random.default_rng(0).permutation(MT_ROWS)
    cut, fit_cut = int(MT_ROWS * 0.8), int(MT_ROWS * 0.8 * 0.9)
    train = {k: v[idx[:fit_cut]] for k, v in data.items()}
    val = {k: v[idx[fit_cut:cut]] for k, v in data.items()}
    test = {k: v[idx[cut:]] for k, v in data.items()}
    t0 = time.perf_counter()
    train_cols, test_cols, cmeta = realistic_census(num_train=CENSUS_ROWS,
                                                    num_test=CENSUS_ROWS // 2, seed=0)
    with tempfile.TemporaryDirectory(prefix="census_") as tmp:
        paths = (f"{tmp}/census.data", f"{tmp}/census.test")
        census.write_columns(paths[0], train_cols)
        census.write_columns(paths[1], test_cols)
        cschema, ctrain, cval, ctest = census.create_census_dataset(*paths)
    census_s = time.perf_counter() - t0
    runs = [(name, schema, train, val, test, ("click", "ctcvr"), ("click", "ctcvr"))
            for name in ("esmm", "mmoe", "ple")]
    runs += [(f"census {name}", cschema, ctrain, cval, ctest, ("income", "marital"),
              ("label_income", "label_marital")) for name in ("mmoe", "ple")]
    out = {}
    for label, sch, tr_d, va_d, te_d, tasks, labels in runs:
        torch.manual_seed(0)
        model, loss_fn, heads, from_logits = multitask_model(label.split()[-1], sch, tasks,
                                                             labels, device=dev)
        trainer = Trainer(model, loss_fn=loss_fn, learning_rate=LR)
        hist, fit_s = fit_no_launch(label, trainer, tr_d, MT_BATCH, val_data=va_d)
        aucs = head_aucs(trainer.predict(te_d), te_d, heads, labels, from_logits, heads)
        # one epoch of the census rows is some 35 steps: only the 200,000
        # multitask rows are enough to beat chance
        low = 0.0 if label.startswith("census") else 0.5
        if not all(low < v <= 1.0 for v in aucs.values()):
            raise AssertionError(f"{label}: AUCs {aucs}")
        errs = card_against_cpu(label, trainer, {k: v[:4096] for k, v in te_d.items()}, 4096)
        step_against_cpu(label, trainer, {k: v[:MT_BATCH] for k, v in tr_d.items()})
        n = len(tr_d[labels[0]])
        out[label] = {"phase": "multitask", "model": label, "train_rows": n,
                      "epoch_loss": hist["loss"][0], **aucs, "fit_seconds": fit_s,
                      "fit_examples_per_s": (n - n % MT_BATCH) / fit_s,
                      "request_max_abs_err": errs, "launches": ctr_expected({}),
                      "data_seconds": census_s if label.startswith("census") else gen_s}
        print(f"multitask {label}: one epoch of {n} rows, {aucs}", flush=True)
        emit(out[label])
    return out


PROTOCOL_MT_ARGV = {"ncf": ["--users", "5000", "--epochs", "2"],
                    "din": ["--users", "5000", "--epochs", "1"],
                    "multitask": ["--rows", "100000", "--epochs", "1"],
                    "census": ["--rows", "20000", "--epochs", "1"]}


def phase_protocol_mt(dev) -> dict:
    """The protocol runner's ncf, din, multitask and census modes at the
    full widths, cut (ncf and din to 5,000 users, ncf for the two epochs of
    its first HR@10 reading, the others one epoch; multitask to 100,000
    rows, census to 20,000): each prints its JSON line, launches no kernel,
    and reports metrics in [0, 1].  {mode: report}."""
    import io

    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.tools import protocol

    out = {}
    for mode, argv in PROTOCOL_MT_ARGV.items():
        buf = io.StringIO()
        torch.cuda.synchronize()
        # the main path: counts zeroed just before, read just after
        dispatch.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            protocol.main([mode, *argv, "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(dispatch.LAUNCHES)
        line = buf.getvalue().strip().splitlines()[-1]
        print(line, flush=True)
        rep = json.loads(line)
        no_launches(f"protocol {mode}", launches)
        metrics = [v for k, v in ([*rep.items()] + [(k, v) for r in rep.get("models", {}).values()
                                                   for k, v in r.items()])
                   if k in ("HR@10", "NDCG@10", "test_auc") or k.startswith("auc_")]
        if not metrics or not all(0.0 <= v <= 1.0 for v in metrics):
            raise AssertionError(f"protocol {mode}: metrics {metrics}")
        out[mode] = {"phase": "protocol mt", "mode": mode, "seconds": wall,
                     "launches": launches, "report": rep}
        emit(out[mode])
    return out


# the files phase: Criteo files written from the seed and the CLI's file flags
FILES_TRAIN_ROWS = 131_072   # two training files of this many rows
FILES_HELD_ROWS = 65_536     # and one held out
FILES_CSV_ROWS = 20_000      # the comma-separated file with a header
FILES_BATCH = 4096
FILES_BUCKETS = 1 << 20      # the stream's default: 26 tables of 2^20 x 16 f32
FILES_CKPT_BUCKETS = 1 << 16
FILES_CHUNK = 8192
FILES_CHECKED_STEPS = 3
FILES_AUC_FLOOR = 0.6


def criteo_columns(rng, rows: int, csv_digits: bool = False) -> list:
    """Criteo rows as 40 columns of text: a label from a logistic teacher on
    I1, I2 and the tokens of C1 and C2, 13 integer columns (I3..I13 with
    some empty) and 26 hex tokens of Zipf-drawn ids (some empty).  With
    ``csv_digits`` C3 holds all-digit tokens with gaps."""
    vocab = np.geomspace(8, 50_000, 26).astype(np.int64)
    ids = (rng.zipf(1.3, (rows, 26)) - 1) % vocab
    dense = rng.integers(0, 100, (rows, 13))
    w = [rng.standard_normal(int(vocab[f])) for f in (0, 1)]
    logit = (4.0 * (dense[:, 0] / 99 - 0.5) - 3.0 * (dense[:, 1] / 99 - 0.5)
             + w[0][ids[:, 0]] + w[1][ids[:, 1]] - 1.0)
    label = (rng.random(rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int64)
    numbers = np.asarray([str(i) for i in range(100)], dtype=object)
    cols = [numbers[label].tolist()]
    for j in range(13):
        col = numbers[dense[:, j]]
        if j >= 2:
            col = np.where(rng.random(rows) < 0.08, "", col)
        cols.append(col.tolist())
    for f in range(26):
        table = np.asarray([f"{f * 1_000_003 + i:08x}" for i in range(int(vocab[f]))],
                           dtype=object)
        col = table[ids[:, f]]
        if csv_digits and f == 2:
            col = np.asarray([str(int(i) * 7) for i in range(int(vocab[f]))],
                             dtype=object)[ids[:, f]]
        cols.append(np.where(rng.random(rows) < 0.04, "", col).tolist())
    return cols


def write_criteo(path: str, cols: list, sep: str, header: bool = False) -> None:
    with open(path, "w") as f:
        if header:
            f.write(sep.join(["label", *(f"I{i}" for i in range(1, 14)),
                              *(f"C{i}" for i in range(1, 27))]) + "\n")
        f.write("\n".join(sep.join(r) for r in zip(*cols)) + "\n")


def fnv1a64(token: bytes) -> int:
    h = 1469598103934665603
    for b in token:
        h = ((h ^ b) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def plain_parse(path: str, rows: int, buckets: int) -> tuple:
    """The first ``rows`` rows of a headerless TSV parsed in Python: label
    and dense values as floats (0 where empty), each categorical its
    FNV-1a 64 hash modulo ``buckets``."""
    labels, dense, sparse = [], [], []
    with open(path, "rb") as f:
        for line in f:
            fields = line.rstrip(b"\r\n").split(b"\t")[:40]
            labels.append(float(fields[0] or 0))
            dense.append([float(x or 0) for x in fields[1:14]])
            sparse.append([fnv1a64(x) % buckets for x in fields[14:40]])
            if len(labels) == rows:
                break
    return (np.asarray(labels, np.float32), np.asarray(dense, np.float32),
            np.asarray(sparse, np.int32))


def phase_files_parse(paths: list) -> dict:
    """``parse_criteo`` of a file against its chunks from ``parse_criteo_chunk``
    at FILES_CHUNK rows, and its first 1000 rows against ``plain_parse``;
    bit for bit."""
    from recsys_tpu_torch.data import native

    parse_s = []
    for _ in range(2):  # the file was just written: both reads are warm
        t0 = time.perf_counter()
        whole = native.parse_criteo(paths[0], sep="\t", skip_header=False)
        parse_s.append(time.perf_counter() - t0)
    parts, off, out = [], 0, native.new_buffers(FILES_CHUNK)
    while True:
        got, off = native.parse_criteo_chunk(paths[0], off, FILES_CHUNK, sep="\t",
                                             skip_header=False, out=out)
        if len(got[0]) == 0:
            break
        parts.append(tuple(a.copy() for a in got))
    plain = plain_parse(paths[0], 1000, native.DEFAULT_BUCKETS)
    ok = len(whole[0]) == FILES_TRAIN_ROWS and all(
        np.array_equal(np.concatenate([p[j] for p in parts]), whole[j])
        and np.array_equal(whole[j][:1000], plain[j]) for j in range(3))
    res = {"phase": "check", "case": "files parser: whole file vs chunks vs plain Python",
           "rows": len(whole[0]), "chunks": len(parts), "parse_seconds": parse_s,
           "rows_per_s": len(whole[0]) / min(parse_s), "ok": ok}
    emit(res)
    if not ok:
        raise AssertionError(f"files: the parser disagrees: {res}")
    return res


@contextlib.contextmanager
def checked_steps(record: dict, n: int):
    """``Trainer.train_step`` patched so that its first ``n`` calls are each
    held against the same step through the plain versions (a copy of the
    trainer taken just before, stepped by ``plain_train_step``; the
    comparison launches nothing); ``record`` keeps the trainer, the
    comparisons and the clock after the last of them."""
    import torch

    from recsys_tpu_torch.train.loop import Trainer

    orig = Trainer.train_step

    def step(self, batch):
        record["trainer"] = self
        checks = record.setdefault("checks", [])
        if len(checks) >= n:
            return orig(self, batch)
        ref = copy.deepcopy(self)
        loss_k = orig(self, batch)
        loss_p = plain_train_step(ref, batch)
        checks.append(compare_step(f"stream fit step {len(checks) + 1}", self, ref, loss_k,
                                   loss_p))
        del ref
        torch.cuda.synchronize()
        record["checked_at"] = time.perf_counter()
        return loss_k

    Trainer.train_step = step
    try:
        yield record
    finally:
        Trainer.train_step = orig


def phase_files_stream(paths: list, held: str) -> dict:
    """``cli ctr --model dlrm --bf16 --embed-dim 16 --data GLOB --stream
    --embedding-optimizer fused_adam`` over the two training files, one
    epoch of 4096-row batches: its first steps held against the plain
    step, every launch counted, the steps a second after them; then
    ``evaluate_auc`` over the held-out file as a stream against the array
    path on the same rows."""
    import torch

    from recsys_tpu_torch.data.streaming import CriteoStream
    from recsys_tpu_torch.kernels import dispatch

    steps = 2 * FILES_TRAIN_ROWS // FILES_BATCH
    glob = str(Path(paths[0]).parent / "day_*.txt")
    record = {}
    with checked_steps(record, FILES_CHECKED_STEPS):
        run = cli_run(["ctr", "--model", "dlrm", "--bf16", "--embed-dim", str(EMBED_DIM),
                       "--data", glob, "--stream", "--embedding-optimizer", "fused_adam",
                       "--epochs", "1", "--batch-size", str(FILES_BATCH)],
                      {"dot_interaction": steps, "embedding_adam": steps},
                      "cli ctr --data GLOB --stream")
    end = time.perf_counter()
    trainer = record["trainer"]
    tables = trainer.tables()
    if len(tables) != NUM_SPARSE or any(t.shape != (FILES_BUCKETS, EMBED_DIM)
                                        for t in tables.values()):
        raise AssertionError(f"files: tables {[tuple(t.shape) for t in tables.values()]}")
    table_bytes = sum(t.numel() * t.element_size() for t in tables.values())
    run.pop("result")

    stream = CriteoStream(held, batch_size=FILES_BATCH, shuffle=False)
    torch.cuda.synchronize()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    auc_stream = trainer.evaluate_auc(stream)
    torch.cuda.synchronize()
    auc_s = time.perf_counter() - t0
    auc_launches = dict(dispatch.LAUNCHES)
    batches = list(stream)
    arrays = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    auc_array = trainer.evaluate_auc(arrays)
    # where a step's time goes: a pass over the stream alone (parse, scale,
    # shuffle), the host prep of a batch, and a step from a prepped batch
    t0 = time.perf_counter()
    passed = sum(1 for _ in CriteoStream(glob, batch_size=FILES_BATCH))
    stream_s = time.perf_counter() - t0
    batch = next(iter(stream))
    prep_ms, step_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        prepped = dict(batch, **trainer._prep(batch["sparse"]))
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(prepped)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    # the device half of a prepped step: the batch's copy to the card alone,
    # one step traced and split by kernel, and #4 alone at these shapes
    copy_ms, prep_copy_ms = [], []
    aux = {k: v for k, v in prepped.items() if k.startswith("embaux")}
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        db = trainer._to_device(prepped)
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        trainer._to_device(aux)
        torch.cuda.synchronize()
        prep_copy_ms.append((time.perf_counter() - t0) * 1e3)
    if trainer.device.type == "cuda" and not all(isinstance(v, torch.Tensor) and v.is_pinned()
                                                 for v in aux.values()):
        raise AssertionError("files: the prep's arrays are not in pinned host memory")
    prof = profile_call(lambda: (trainer.train_step(prepped), torch.cuda.synchronize()),
                        classify=files_category)
    emit({"phase": "profile", "config": "files stream: one prepped step", **prof})
    adam = files_adam_timing(trainer, db)
    ok = abs(auc_stream - auc_array) <= 1e-6 and auc_stream > FILES_AUC_FLOOR
    res = {"phase": "files stream", "rows": 2 * FILES_TRAIN_ROWS, "steps": steps,
           "buckets": FILES_BUCKETS, "table_bytes": table_bytes,
           "table_and_adam_bytes": 3 * table_bytes, "fit_seconds": run["seconds"],
           "checked_steps": FILES_CHECKED_STEPS,
           "steps_per_s_after_checked": (steps - FILES_CHECKED_STEPS) / (
               end - record["checked_at"]),
           "launches": run["launches"], "final_line": run["line"],
           "heldout_rows": len(arrays["label"]), "heldout_auc_stream": auc_stream,
           "heldout_auc_array": auc_array, "auc_seconds": auc_s,
           "stream_alone_batches_per_s": passed / stream_s,
           "prep_ms_median": float(np.median(prep_ms)),
           "chunk_length": int(aux["embaux0_ids"].shape[1]),
           "prep_bytes": sum(np.asarray(v).nbytes for v in aux.values()),
           "prep_copy_ms_median": float(np.median(prep_copy_ms)),
           "step_ms_median": float(np.median(step_ms)), "step_ms_min": float(np.min(step_ms)),
           "batch_bytes": sum(v.numel() * v.element_size() for v in db.values()),
           "copy_to_card_ms_median": float(np.median(copy_ms)), "step_profile": prof,
           "embedding_adam": adam, "auc_launches": auc_launches, "ok": ok}
    emit(res)
    print(f"files stream: {res['steps_per_s_after_checked']:.1f} steps/s over the stream "
          f"(batch {FILES_BATCH}; the stream alone {res['stream_alone_batches_per_s']:.1f} "
          f"batches/s, prep {res['prep_ms_median']:.2f} ms at ch {res['chunk_length']}, a "
          f"prepped step {res['step_ms_median']:.2f} ms, its copy to the card "
          f"{res['copy_to_card_ms_median']:.2f} ms, of which the prep's "
          f"{res['prep_bytes'] / 1e6:.2f} MB {res['prep_copy_ms_median']:.2f} ms, #4 alone "
          f"{adam['ms']:.3f} ms against a bound of {adam['bound_ms']:.3f} ms, on bf16 tables "
          f"{adam['bf16_tables']['ms']:.3f} ms), held-out AUC {auc_stream:.4f}", flush=True)
    if not ok:
        raise AssertionError(f"files: held-out AUC {auc_stream} (array path {auc_array})")
    return res


def files_category(name: str) -> str:
    """``ctr_category``, with #4's kernel a category of its own."""
    return "#4 fused Adam" if "adam_kernel" in name else ctr_category(name)


def files_adam_timing(trainer, db: dict) -> dict:
    """#4 alone on the stream fit's tables (NUM_SPARSE of FILES_BUCKETS x
    EMBED_DIM f32, with m and v) and one prepped batch's ids (``db``, on
    the card), with a bf16 cotangent: the one launch of a step against its
    plain version table by table, and the bound: p, m and v read and
    written, and of the batch the cotangent rows of its real occurrences,
    their ids and the chunk pointers read once."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels import embedding_update as emb_ref
    from recsys_tpu_torch.train.streaming_embed import DEFAULT_BLOCK

    tables, plan = trainer.tables(), trainer.plan
    gen = torch.Generator(device=trainer.device).manual_seed(4)
    cot_all = torch.randn(FILES_BATCH * NUM_SPARSE, EMBED_DIM, generator=gen,
                          device=trainer.device)
    args = []
    nbytes = nops = 0
    for g, name in enumerate(plan.table_names):
        t, st = tables[name], trainer.emb_state[name]
        ptr = db[f"embaux{g}_ptr"]
        args.append((t, st["m"], st["v"], cot_all.index_select(0, db[f"embaux{g}_src"]).bfloat16(),
                     db[f"embaux{g}_ids"], ptr, min(DEFAULT_BLOCK, t.shape[0])))
        nbytes += 6 * 4 * t.numel() + FILES_BATCH * (EMBED_DIM * 2 + 4) + ptr.numel() * 4
        nops += 16 * t.numel()
    p, m, v, cot, ids, ptrs, blocks = (list(x) for x in zip(*args))
    step = trainer.step + 1

    def plain():
        for a in args:
            emb_ref.fused_adam(*a[:6], step, block=a[6], lr=LR)

    res = {"ms": cuda_ms(lambda: dispatch.fused_embedding_adam_pass(
               p, m, v, cot, ids, ptrs, step, blocks=blocks, lr=LR), iters=10, warmup=2),
           "plain_ms": cuda_ms(plain, iters=1, warmup=1), "library_ms": None,
           "tables": [len(args), FILES_BUCKETS, EMBED_DIM], "ids": FILES_BATCH,
           "bytes": nbytes}
    res["bound_ms"], res["bound_by"] = bound(nbytes, nops, F32_FLOPS)
    # the same launch on bf16 tables (the runner's --table-dtype bf16): its
    # time, and three tables held against the plain version
    p16 = [t.bfloat16() for t in p]
    m16, v16 = [t.clone() for t in m], [t.clone() for t in v]
    want = {t: (p16[t].clone(), m16[t].clone(), v16[t].clone())
            for t in (0, NUM_SPARSE // 2, NUM_SPARSE - 1)}
    dispatch.fused_embedding_adam_pass(p16, m16, v16, cot, ids, ptrs, step, blocks=blocks, lr=LR)
    worst = 0.0
    for t, w in want.items():
        emb_ref.fused_adam(*w, cot[t], ids[t], ptrs[t], step, block=blocks[t], lr=LR)
        for key, u, x in zip("pmv", (p16[t], m16[t], v16[t]), w):
            err = check_close(f"embedding_adam bf16 table {t} at the stream's shapes {key}",
                              u.float(), x.float(), BF16_TABLE_TOL if key == "p" else ADAM_TOL)
            worst = max(worst, err["max_abs_err"]) if key == "p" else worst
    b16 = nbytes - 2 * 2 * sum(t.numel() for t in p)  # p read and written in 2 bytes, not 4
    res["bf16_tables"] = {"ms": cuda_ms(lambda: dispatch.fused_embedding_adam_pass(
        p16, m16, v16, cot, ids, ptrs, step, blocks=blocks, lr=LR), iters=10, warmup=2),
        "bytes": b16, "max_abs_err": worst}
    res["bf16_tables"]["bound_ms"], _ = bound(b16, nops, F32_FLOPS)
    emit({"phase": "timing", "kernel": "embedding_adam at the stream's shapes", **res})
    del p16, m16, v16, want
    return res


def sparse_kind_steps(kind: str, schema, batches: list, dev) -> dict:
    """DLRM (bf16, D = 16, 2^20 buckets) with the touched-rows ``kind``: the
    batches stepped on the card and on a copy on the CPU, the tables and
    their state in lockstep, the dense parameters and their Adam state
    copied from the card before each step.  Each step's loss is held to
    LOGIT_TOL and the tables and their state, which ``kind`` updates, to
    the train phase's shares.  The dense parameters (torch's Adam) are held
    by their Adam first moment, as ``compare_step`` holds them: per tensor
    within CROSS_MOMENT_RTOL of the CPU's in norm, where a gradient 20%
    short must fall outside.  Their cells are not held by share: in its
    first steps Adam moves every cell by about ±lr whatever its gradient's
    size, so the two devices' bf16 roundings, which flip the sign of
    gradients within their noise of 0, set a few percent of a tensor's
    cells 2·lr apart; the share and the largest difference are reported.
    The rows outside each batch stay bit-unchanged on the card.  Then the
    step ms."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.models.ctr.dlrm import DLRM
    from recsys_tpu_torch.train.loop import Trainer

    torch.manual_seed(0)
    model = DLRM(schema, compute_dtype=torch.bfloat16, sparse_embed_grads=True, device=dev)
    card = Trainer(model, learning_rate=LR, embedding_optimizer=kind)
    cpu = Trainer(copy.deepcopy(model).cpu(), learning_rate=LR, embedding_optimizer=kind,
                  device="cpu")
    torch.cuda.synchronize()
    dispatch.reset_launches()
    checks = []
    for i, batch in enumerate(batches, start=1):
        before = {n: (t.clone(), {k: v.clone() for k, v in card.emb_state[n].items()})
                  for n, t in card.tables().items()}
        cpu.model.load_state_dict({k: v for k, v in card.model.state_dict().items()
                                   if not k.startswith("embedding.")}, strict=False)
        cpu.optimizer.load_state_dict(copy.deepcopy(card.optimizer.state_dict()))
        loss = card.train_step(batch)
        want = cpu.train_step(batch)
        ok = bool(torch.isclose(loss.cpu().double(), want.double(), **LOGIT_TOL))
        cpu_sd = cpu.model.state_dict()
        shares = {k: share_off(v, cpu_sd[k], STEP_P_THRESH)
                  for k, v in card.model.state_dict().items()}
        dense_max = max(float((v.double() - cpu_sd[k].to(dev).double()).abs().max())
                        for k, v in card.model.state_dict().items()
                        if not k.startswith("embedding."))
        state = {f"{n}.{k}": share_not_close(v, cpu.emb_state[n][k], STEP_STATE_TOL[k])
                 for n, st in card.emb_state.items() for k, v in st.items()}
        moments, short = moment_errors(card, cpu)
        unchanged = True
        sparse = torch.from_numpy(batch["sparse"]).to(dev)
        for g, (n, t) in enumerate(card.tables().items()):
            cols, offs = card.plan.group_cols[g], card.plan.group_offsets[g]
            hit = torch.zeros(t.shape[0], dtype=torch.bool, device=dev)
            for j, off in zip(cols, offs):
                hit[sparse[:, j].long() + off] = True
            old_t, old_st = before[n]
            unchanged &= torch.equal(t[~hit], old_t[~hit])
            unchanged &= all(torch.equal(v[~hit], old_st[k][~hit])
                             for k, v in card.emb_state[n].items())
        out = {"step": i, "loss": float(loss), "cpu_loss": float(want),
               "worst_table_share": max(v for k, v in shares.items()
                                        if k.startswith("embedding.")),
               "worst_dense_share": max(v for k, v in shares.items()
                                        if not k.startswith("embedding.")),
               "dense_max_abs_diff": dense_max,
               "worst_moment_rel_err": max(moments.values()),
               "grad_x0.8_least_moment_rel_err": min(short.values()),
               "worst_state_share": max(state.values()), "untouched_rows_unchanged": unchanged}
        out["ok"] = (ok and out["worst_table_share"] <= STEP_P_SHARE
                     and out["dense_max_abs_diff"] <= 2 * LR * 1.001
                     and out["worst_moment_rel_err"] <= CROSS_MOMENT_RTOL
                     < out["grad_x0.8_least_moment_rel_err"]
                     and out["worst_state_share"] <= STEP_STATE_SHARE and unchanged)
        emit({"phase": "check", "case": f"files {kind} step card vs cpu", **out,
              "moment_rel_err_limit": CROSS_MOMENT_RTOL})
        if not out["ok"]:
            raise AssertionError(f"files {kind} step {i}: {out}, params {shares}, "
                                 f"state {state}, moments {moments}, "
                                 f"moments of a short gradient {short}")
        checks.append(out)
        del before
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    if launches != ctr_expected({"dot_interaction": len(batches)}):
        raise AssertionError(f"files {kind}: launches {launches}")
    ms = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.train_step(batches[0])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    res = {"phase": "files sparse", "kind": kind, "launches": launches, "checks": checks,
           "step_ms_median": float(np.median(ms)), "step_ms_min": float(np.min(ms))}
    print(f"files {kind}: {res['step_ms_median']:.2f} ms a {FILES_BATCH}-row step "
          "(median of 7)", flush=True)
    emit(res)
    return res


def phase_files_fused_adagrad(schema, batches: list, dev) -> dict:
    """DLRM with ``fused_rowwise_adagrad``: ``fit`` over a callable stream of
    the batches, every launch of #5 counted, then one more step held
    against the plain step."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.models.ctr.dlrm import DLRM
    from recsys_tpu_torch.train.loop import Trainer

    torch.manual_seed(0)
    trainer = Trainer(DLRM(schema, compute_dtype=torch.bfloat16, sparse_embed_grads=True,
                           device=dev), learning_rate=LR,
                      embedding_optimizer="fused_rowwise_adagrad")
    torch.cuda.synchronize()
    dispatch.reset_launches()
    hist = trainer.fit(lambda: iter(batches), epochs=1, verbose=False)
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    want = ctr_expected({"dot_interaction": len(batches),
                         "embedding_rowwise_adagrad": NUM_SPARSE * len(batches)})
    if launches != want or not np.isfinite(hist["loss"]).all():
        raise AssertionError(f"files fused rowwise adagrad: launches {launches}, expected "
                             f"{want}, loss {hist['loss']}")
    ref = copy.deepcopy(trainer)
    cmp = compare_step("files fused_rowwise_adagrad", trainer, ref,
                       trainer.train_step(batches[0]), plain_train_step(ref, batches[0]))
    res = {"phase": "files fused rowwise adagrad", "launches": launches, "step_check": cmp,
           "epoch_loss": hist["loss"][0]}
    emit(res)
    return res


def phase_files_checkpoint(paths: list, held: str, tmp: str, dev) -> dict:
    """At 2^16 buckets: ``fit`` over the training stream with
    ``checkpoint_path`` and ``log_jsonl``, ``restore`` into a fresh
    Trainer, its predictions bit-equal to the saved trainer's and its next
    step's loss and dense parameters bit-equal to the saved trainer's next
    step's."""
    import torch

    from recsys_tpu_torch.data.streaming import CriteoStream
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.models.ctr.dlrm import DLRM
    from recsys_tpu_torch.train import checkpoint
    from recsys_tpu_torch.train.loop import Trainer

    stream = CriteoStream(paths, batch_size=FILES_BATCH, cat_buckets=FILES_CKPT_BUCKETS)

    def make(seed):
        torch.manual_seed(seed)
        return Trainer(DLRM(stream.schema, compute_dtype=torch.bfloat16, sparse_embed_grads=True,
                            device=dev), learning_rate=LR, embedding_optimizer="fused_adam")

    saved = make(0)
    path, log = f"{tmp}/ckpt/best.pt", f"{tmp}/log.jsonl"
    torch.cuda.synchronize()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    hist = saved.fit(stream, epochs=1, checkpoint_path=path, log_jsonl=log, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(dispatch.LAUNCHES)
    steps = stream.num_rows // FILES_BATCH
    if launches != ctr_expected({"dot_interaction": steps, "embedding_adam": steps}):
        raise AssertionError(f"files checkpoint fit: launches {launches}")
    restored = make(1)
    t0 = time.perf_counter()
    checkpoint.restore(path, restored)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    batch = next(iter(CriteoStream(held, batch_size=FILES_BATCH, cat_buckets=FILES_CKPT_BUCKETS,
                                   shuffle=False)))
    same = np.array_equal(restored.predict(batch), saved.predict(batch))
    cmp = compare_step("files checkpoint: restored vs saved", restored, saved,
                       restored.train_step(batch), saved.train_step(batch), exact=True)
    recs = [json.loads(line) for line in Path(log).read_text().splitlines()]
    keys_ok = [sorted(r) for r in recs] == [["epoch", "epoch_seconds", "loss", "step"]] and \
        recs[0]["step"] == steps
    res = {"phase": "files checkpoint", "buckets": FILES_CKPT_BUCKETS, "steps": steps,
           "file_bytes": Path(path).stat().st_size, "fit_seconds": fit_s,
           "restore_seconds": restore_s, "predictions_bit_equal": same, "next_step": cmp,
           "log_jsonl": recs, "launches": launches, "epoch_loss": hist["loss"][0],
           "ok": same and keys_ok}
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"files checkpoint: {res}")
    return res


def phase_files_cli(csv_path: str) -> dict:
    """``cli ctr --model deepfm --data`` the comma-separated file (the
    label-encode path; the fm kernel once a forward), ``ncf --ratings``,
    ``match --model dssm --ml100k`` and ``sasrec --ratings`` on the
    committed assets, each with exactly its path's launches."""
    from recsys_tpu_torch.data.movielens import build_sasrec_dataset, read_ratings

    assets = ROOT / "tests" / "assets"
    out = {}
    fit_n = int(int(FILES_CSV_ROWS * 0.8) * 0.9)  # the 80/20 split, then fit's 10%
    deepfm = (fit_n // CTR_BATCH + eval_forwards(int(FILES_CSV_ROWS * 0.8) - fit_n, CTR_BATCH)
              + -(-(FILES_CSV_ROWS - int(FILES_CSV_ROWS * 0.8)) // CTR_REQUEST))
    out["ctr deepfm"] = cli_run(["ctr", "--model", "deepfm", "--data", csv_path, "--epochs",
                                 "1"], {"fm_pairwise_vector": deepfm},
                                "cli ctr --model deepfm --data CSV")
    out["ncf"] = cli_run(["ncf", "--ratings", str(assets / "ml100k" / "u.data"), "--epochs",
                          "2"], {}, "cli ncf --ratings")
    out["match"] = cli_run(["match", "--model", "dssm", "--ml100k", str(assets / "ml100k"),
                            "--epochs", "2"], {"topk_scores": 1}, "cli match --ml100k")
    ratings = str(assets / "ml_latest_ratings.csv")
    _, train, _, test = build_sasrec_dataset(read_ratings(ratings), maxlen=50,
                                             all_positions=True)
    n = len(train["hist"])
    steps = n // min(128, n)
    fwd = 2 * steps + 2 * -(-len(test["hist"]) // 4096)
    out["sasrec"] = cli_run(["sasrec", "--ratings", ratings, "--epochs", "1"],
                            {"flash_attention_fwd": fwd, "flash_attention_bwd": 2 * steps},
                            "cli sasrec --ratings")
    lines = {"ctr deepfm": r"test AUC: ([0-9.]+)",
             "ncf": r"epoch 2/2 loss=[0-9.]+ HR@10=([0-9.]+) NDCG@10=[0-9.]+",
             "match": RECALL_LINE, "sasrec": r"test HR@10=([0-9.]+) NDCG@10=[0-9.]+"}
    for task, res in out.items():
        ok = re.fullmatch(lines[task], res["line"])
        if not ok or not 0.0 <= float(ok.group(1)) <= 1.0:
            raise AssertionError(f"files cli {task}: result line {res['line']!r}")
        res.pop("result")
    emit({"phase": "files cli", "tasks": out})
    return out


def phase_files(dev) -> dict:
    """The file-fed training path: Criteo files written from the seed, the
    parser checks, the stream fit through the CLI at full width, the two
    touched-rows kinds, fused rowwise AdaGrad, checkpoints and the CLI's
    file flags.  {run: result}, each with its launches."""
    import tempfile

    import torch

    from recsys_tpu_torch.data.streaming import CriteoStream

    rng = np.random.default_rng(15)
    out = {}
    with tempfile.TemporaryDirectory(prefix="files_") as tmp:
        t0 = time.perf_counter()
        paths = [f"{tmp}/day_{d}.txt" for d in range(2)]
        for p in paths:
            write_criteo(p, criteo_columns(rng, FILES_TRAIN_ROWS), "\t")
        held = f"{tmp}/heldout.txt"
        write_criteo(held, criteo_columns(rng, FILES_HELD_ROWS), "\t")
        csv_path = f"{tmp}/criteo.csv"
        write_criteo(csv_path, criteo_columns(rng, FILES_CSV_ROWS, csv_digits=True), ",",
                     header=True)
        emit({"phase": "files data", "seconds": time.perf_counter() - t0,
              "bytes": sum(Path(p).stat().st_size for p in [*paths, held, csv_path])})
        out["parse"] = phase_files_parse(paths)
        out["stream"] = phase_files_stream(paths, held)
        out["stream auc"] = {"launches": out["stream"]["auc_launches"]}
        stream = CriteoStream(paths, batch_size=FILES_BATCH, shuffle=False)
        batches = [b for b, _ in zip(stream, range(FILES_CHECKED_STEPS))]
        for kind in ("rowwise_adagrad", "lazy_adam"):
            out[kind] = sparse_kind_steps(kind, stream.schema, batches, dev)
            torch.cuda.empty_cache()
        out["fused_rowwise_adagrad"] = phase_files_fused_adagrad(stream.schema, batches, dev)
        torch.cuda.empty_cache()
        out["checkpoint"] = phase_files_checkpoint(paths, held, tmp, dev)
        out.update({f"cli {k}": v for k, v in phase_files_cli(csv_path).items()})
    return out


def phase_ctr_check(rng, dev) -> dict:
    """ctr_check.check on every case; returns the worst abs error of the
    bi-interaction kernel at the path's shapes (4096 rows, F = 26 and 39,
    D = 16, f32, normal inputs)."""
    import torch

    import ctr_check
    from recsys_tpu_torch.kernels import dispatch

    worst, summary = 0.0, {}
    for b, f, d, dtype, kind in ctr_check.cases():
        x = ctr_check.inputs(rng, b, f, d, dtype, kind, dev)
        res = ctr_check.check(dispatch.fm_pairwise_vector_fused, x)
        ok = res["excess"] <= 1.0 and res.get("wrong_least_excess", 2.0) > 1.0
        if not ok:
            emit({"phase": "check", "case": f"fm b={b} f={f} d={d} {dtype} {kind}", **res,
                  "ok": False})
            raise AssertionError(f"fm_pairwise_vector b={b} f={f} d={d} {dtype} {kind}: the "
                                 f"kernel exceeds its limit, or a wrong result passes: {res}")
        key = f"{str(dtype).removeprefix('torch.')} {kind}"
        s = summary.setdefault(key, {"cases": 0, "worst_excess": 0.0, "max_abs_err": 0.0,
                                     "least_wrong_excess": float("inf")})
        s["cases"] += 1
        s["worst_excess"] = max(s["worst_excess"], res["excess"])
        s["max_abs_err"] = max(s["max_abs_err"], res["max_abs_err"])
        s["least_wrong_excess"] = min(s["least_wrong_excess"],
                                      res.get("wrong_least_excess", float("inf")))
        if (b, d, dtype, kind) == (CTR_REQUEST, EMBED_DIM, torch.float32, "normal") and \
                f in (NUM_SPARSE, NUM_SPARSE + NUM_DENSE):
            worst = max(worst, res["max_abs_err"])
    for key, s in summary.items():
        emit({"phase": "check", "case": f"fm_pairwise_vector {key}", **s,
              "limit": f"{ctr_check.LIMIT} of (sum_f |x_fd|)^2",
              "wrong_results": list(ctr_check.wrong_results(torch.zeros(1, 2, 1))),
              "ok": True})
    torch.cuda.synchronize()
    return {"fm_pairwise_vector": worst}


def ctr_jax_params(rng, model) -> dict:
    """Random weights for a port CTR model in the JAX package's layout:
    row-packed tables and first-order weights, flax ``Dense`` kernels (in,
    out) under the flax submodule names (the inverse of
    ``convert.ctr_params_from_jax``)."""
    from recsys_tpu_torch.convert import _pad8, pack_factor
    from recsys_tpu_torch.models.ctr.dlrm import DLRM

    def packed(v, width, scale):
        p = pack_factor(width, v)
        return (rng.standard_normal((_pad8(-(-max(v, 1) // p)), p * width), dtype=np.float32)
                * np.float32(scale))

    def dense(lin):
        fan_in, fan_out = lin.weight.shape[1], lin.weight.shape[0]
        out = {"kernel": rng.standard_normal((fan_in, fan_out), dtype=np.float32)
               / np.float32(np.sqrt(fan_in))}
        if lin.bias is not None:
            out["bias"] = rng.standard_normal(fan_out, dtype=np.float32) * np.float32(0.01)
        return out

    def tower(mlp):
        return {f"Dense_{i}": dense(lin) for i, lin in enumerate(mlp.layers)}

    d = model.schema.embed_dim
    tree = {"StackedEmbedding_0": {f"table_{g}": packed(v, d, 0.05)
                                   for g, v in enumerate(model.embedding.group_vocab)}}
    if isinstance(model, DLRM):
        tree["MLP_0"], tree["MLP_1"] = tower(model.bottom), tower(model.top)
        return tree
    mods = dict(model.named_children())
    if mods.get("linear") is not None:
        tree["SparseLinear_0"] = {f"w_{g}": packed(v, 1, 0.01)
                                  for g, v in enumerate(model.linear.group_vocab)}
    if "mlp" in mods:
        tree["MLP_0"] = tower(model.mlp)
    if "out" in mods:
        tree["Dense_0"] = dense(model.out)
    if mods.get("wide") is not None:
        tree["LinearLogit_0"] = {"Dense_0": dense(model.wide.dense)}
    if "cross" in mods:
        tree["CrossNetwork_0"] = {k: rng.standard_normal(tuple(v.shape), dtype=np.float32)
                                  * np.float32(0.01) for k, v in model.cross.named_parameters()}
    for i, unit in enumerate(mods.get("residual", ())):
        tree[f"ResidualUnit_{i}"] = {"Dense_0": dense(unit.dense0), "Dense_1": dense(unit.dense1)}
    for i, layer in enumerate(mods.get("attention", ())):
        tree[f"MultiHeadAttention_{i}"] = {n: dense(getattr(layer, n)) for n in ("wq", "wk", "wv")}
    for name, scale in (("bias", 0.01), ("v_dense", 0.05), ("w_dense", 0.1)):
        if hasattr(model, name):
            tree[name] = rng.standard_normal(tuple(getattr(model, name).shape),
                                             dtype=np.float32) * np.float32(scale)
    return tree


def ctr_model_from_jax(rng, name, schema):
    """The protocol's model ``name`` on the CPU, with random weights made in
    the JAX layout and converted."""
    from recsys_tpu_torch.convert import ctr_params_from_jax
    from recsys_tpu_torch.tools.protocol import CTR_MODELS, ctr_model_kwargs

    model = CTR_MODELS[name](schema, **ctr_model_kwargs(name))
    model.load_state_dict(ctr_params_from_jax(ctr_jax_params(rng, model), model))
    return model


def ctr_category(name: str) -> str:
    """The category of a device kernel in a CTR step's or request's profile."""
    low = name.lower()
    for cat, keys in (("fm bi-interaction", ("fm_interaction",)),
                      ("dot interaction", ("dot_interaction",)),
                      ("flash attention", ("flash_",)),
                      ("GEMMs", ("gemm", "gemv", "xmma", "cutlass", "splitk", "kernel2")),
                      ("gathers and table-gradient scatter",
                       ("index", "embedding", "gather", "scatter", "sort", "radix")),
                      ("optimizer", ("adam", "multi_tensor")),
                      ("host-device copies", ("memcpy",))):
        if any(k in low for k in keys):
            return cat
    return "other (zero fills, elementwise, reductions)"


def ctr_expected(counts: dict) -> dict:
    """The launch counts of a run that launched only ``counts``."""
    from recsys_tpu_torch.kernels import dispatch

    return {**dict.fromkeys(dispatch.LAUNCHES, 0), **counts}


def phase_ctr_serve(rng, dev) -> dict:
    """Every protocol model at the protocol widths (random weights in the
    JAX layout, converted) served by Trainer.predict on the card over
    4096-row requests and a ragged tail, against the same model on the
    CPU; request ms; one profiled FM request."""
    import torch

    from recsys_tpu_torch.data.realistic import realistic_criteo
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.tools.protocol import CTR_MODELS
    from recsys_tpu_torch.train.loop import Trainer

    n = CTR_REQUESTS * CTR_REQUEST + CTR_TAIL
    schema, data, _ = realistic_criteo(num_examples=n, embed_dim=EMBED_DIM, seed=1)
    requests = -(-n // CTR_REQUEST)
    per_request = {"fm": {"fm_pairwise_vector": 1}, "deepfm": {"fm_pairwise_vector": 1},
                   "dlrm": {"dot_interaction": 1}, "autoint": {"flash_attention_fwd": 3}}
    one = {k: v[:CTR_REQUEST] for k, v in data.items()}
    results = {}
    for name in CTR_MODELS:
        model = ctr_model_from_jax(rng, name, schema)
        want = Trainer(copy.deepcopy(model), device="cpu").predict(data, CTR_REQUEST)
        trainer = Trainer(model)

        # the main path: counts zeroed just before, read just after
        dispatch.reset_launches()
        logits = trainer.predict(data, batch_size=CTR_REQUEST)
        torch.cuda.synchronize()
        launches = dict(dispatch.LAUNCHES)
        expected = ctr_expected({k: c * requests for k, c in per_request.get(name, {}).items()})
        if launches != expected:
            raise AssertionError(f"ctr serve {name}: launches {launches}, expected {expected}")
        err = check_close(f"ctr serve {name} card vs cpu", torch.from_numpy(logits),
                          torch.from_numpy(want), LOGIT_TOL if name == "dlrm" else CTR_LOGIT_TOL)
        lat = []
        for _ in range(7):
            t0 = time.perf_counter()
            trainer.predict(one, batch_size=CTR_REQUEST)
            lat.append((time.perf_counter() - t0) * 1e3)
        if name == "fm":
            emit({"phase": "profile", "config": "ctr serve fm 4096-row request",
                  **profile_call(lambda: trainer.predict(one, batch_size=CTR_REQUEST),
                                 ctr_category)})
        res = {"phase": "ctr serve", "model": name, "rows": n, "requests": requests,
               "launches": launches, "expected_launches": expected,
               "max_abs_err": err["max_abs_err"],
               "request_ms_median": float(np.median(lat)), "request_ms_min": float(np.min(lat))}
        print(f"ctr serve {name}: {res['request_ms_median']:.3f} ms a {CTR_REQUEST}-row "
              "request (median of 7)", flush=True)
        emit(res)
        results[name] = res
        del model, trainer
        torch.cuda.empty_cache()
    return results


def phase_ctr_train_step(rng, dev) -> dict:
    """One Trainer.train_step of FM, DeepFM and AutoInt at the protocol
    widths on the card against the same step on the CPU; step ms; profiles
    of the FM and DeepFM steps."""
    import torch

    from recsys_tpu_torch.data.realistic import realistic_criteo
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.train.loop import Trainer

    schema, data, _ = realistic_criteo(num_examples=2 * CTR_BATCH, embed_dim=EMBED_DIM, seed=2)
    batch = {k: v[:CTR_BATCH] for k, v in data.items()}
    extra = {k: v[CTR_BATCH:] for k, v in data.items()}
    results = {}
    for name in CTR_STEP_MODELS:
        model = ctr_model_from_jax(rng, name, schema)
        ref = Trainer(copy.deepcopy(model), device="cpu")
        trainer = Trainer(model)
        torch.cuda.synchronize()

        # the main path: counts zeroed just before, read just after
        dispatch.reset_launches()
        loss_k = trainer.train_step(batch)
        torch.cuda.synchronize()
        launches = dict(dispatch.LAUNCHES)
        expected = ctr_expected({"flash_attention_fwd": 3, "flash_attention_bwd": 3}
                                if name == "autoint" else {"fm_pairwise_vector": 1})
        if launches != expected:
            raise AssertionError(f"ctr step {name}: launches {launches}, expected {expected}")
        cmp = compare_sasrec_step(name, trainer, ref, loss_k, ref.train_step(batch), label="ctr")
        steps_ms = []
        for _ in range(7):
            t0 = time.perf_counter()
            trainer.train_step(extra)
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
        if name != "autoint":
            emit({"phase": "profile", "config": f"ctr train step {name}",
                  **profile_call(lambda: (trainer.train_step(extra), torch.cuda.synchronize()),
                                 ctr_category)})
        res = {"phase": "ctr train step", "model": name, "batch": CTR_BATCH,
               "launches": launches, "expected_launches": expected, "step_check": cmp,
               "step_ms_median": float(np.median(steps_ms)),
               "step_ms_min": float(np.min(steps_ms))}
        emit(res)
        results[name] = res
        del model, trainer, ref
        torch.cuda.empty_cache()
    return results


def phase_ctr_protocol(dev) -> dict:
    """The port's protocol ctr runner on the card at the full widths with
    the default models, rows cut to CTR_ROWS; every AUC must be above
    CTR_AUC_FLOOR."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.tools.protocol import run_ctr

    torch.cuda.synchronize()
    # the main path: counts zeroed just before, read just after
    dispatch.reset_launches()
    t0 = time.perf_counter()
    rep = run_ctr(rows=CTR_ROWS, batch_size=CTR_BATCH, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(dispatch.LAUNCHES)
    for name, m in rep["models"].items():
        print(f"ctr protocol {name}: AUC {m['test_auc']:.4f} ({m['pct_of_oracle']}% of the "
              f"oracle margin), {m['epochs_ran']} epochs, {m['seconds']} s, "
              f"{m['fit_examples_per_s']:.0f} fit examples/s", flush=True)
    res = {"phase": "ctr protocol", "seconds": wall, "launches": launches, **rep}
    emit(res)
    low = {k: m["test_auc"] for k, m in rep["models"].items()
           if not m["test_auc"] > CTR_AUC_FLOOR}
    if low:
        raise AssertionError(f"ctr protocol: AUC not above {CTR_AUC_FLOOR}: {low}")
    missing = [k for k in ("fm_pairwise_vector", "dot_interaction", "flash_attention_fwd",
                           "flash_attention_bwd") if launches[k] == 0]
    if missing:
        raise AssertionError(f"ctr protocol: kernels of the path never launched: {missing}")
    return res


def phase_ctr_table_dtype(dev) -> dict:
    """The runner's ``--table-dtype bf16 --embedding-optimizer fused_adam``
    on DLRM, where #4 updates bf16 tables: one step of the runner's model
    held against the plain step, then ``run_ctr`` on it at CTR_ROWS rows,
    one epoch, with ``embedding_lr``, #4's launches counted."""
    import torch

    from recsys_tpu_torch.data.realistic import realistic_criteo
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.models.ctr.dlrm import DLRM
    from recsys_tpu_torch.tools.protocol import ctr_model_kwargs, run_ctr
    from recsys_tpu_torch.train.loop import Trainer

    schema, data, _ = realistic_criteo(num_examples=2 * CTR_BATCH, embed_dim=EMBED_DIM, seed=3)
    torch.manual_seed(0)
    trainer = Trainer(DLRM(schema, device=dev, **ctr_model_kwargs("dlrm", "fused_adam", "bf16")),
                      learning_rate=LR, embedding_optimizer="fused_adam")
    if {t.dtype for t in trainer.tables().values()} != {torch.bfloat16}:
        raise AssertionError("ctr table dtype: the runner's tables are not bf16")
    trainer.train_step({k: v[CTR_BATCH:] for k, v in data.items()})  # a step of history
    batch = {k: v[:CTR_BATCH] for k, v in data.items()}
    ref = copy.deepcopy(trainer)
    cmp = compare_step("ctr dlrm bf16 tables", trainer, ref, trainer.train_step(batch),
                       plain_train_step(ref, batch))
    del trainer, ref
    steps = int(int(CTR_ROWS * 0.8) * 0.9) // CTR_BATCH
    torch.cuda.synchronize()
    # the main path: counts zeroed just before, read just after
    dispatch.reset_launches()
    t0 = time.perf_counter()
    rep = run_ctr(rows=CTR_ROWS, models=("dlrm",), batch_size=CTR_BATCH, epochs=1,
                  embedding_optimizer="fused_adam", embedding_lr=LR, table_dtype="bf16",
                  device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(dispatch.LAUNCHES)
    auc = rep["models"]["dlrm"]["test_auc"]
    res = {"phase": "ctr table dtype", "seconds": wall, "launches": launches, "steps": steps,
           "step_check": cmp, **rep}
    emit(res)
    print(f"ctr protocol dlrm, bf16 tables, fused Adam: AUC {auc:.4f}, {steps} steps, "
          f"{rep['models']['dlrm']['fit_examples_per_s']:.0f} fit examples/s", flush=True)
    if launches["embedding_adam"] != steps or rep.get("table_dtype") != "bf16" or \
            not auc > CTR_AUC_FLOOR:
        raise AssertionError(f"ctr table dtype: launches {launches} (#4 {steps} expected), "
                             f"report {rep}")
    return res


def phase_ctr_timing(rng, dev) -> dict:
    """Kernel, plain and bound ms of the bi-interaction at FM's and DeepFM's
    serving shapes (4096 x 39 and x 26 fields x 16, f32); the flash forward
    and backward beside torch SDPA at AutoInt's serving request (4096, 2,
    39, 8) and train step (512, 2, 39, 8)."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels.interactions import fm_pairwise_vector

    res = {}
    for name, f in (("fm", NUM_SPARSE + NUM_DENSE), ("deepfm", NUM_SPARSE)):
        b, d = CTR_REQUEST, EMBED_DIM
        x = torch.from_numpy(rng.standard_normal((b, f, d), dtype=np.float32)).to(dev)
        # each input read once, the output written once; an add and an FMA
        # per input element
        bound_ms, kind = bound((b * f * d + b * d) * 4, 3.0 * b * f * d, F32_FLOPS)
        t = {"ms": cuda_ms(lambda: dispatch.fm_pairwise_vector_fused(x), iters=200),
             "plain_ms": cuda_ms(lambda: fm_pairwise_vector(x), iters=200),
             "bound_ms": bound_ms, "bound_by": kind, "library_ms": None,
             "shape": [b, f, d], "dtype": "f32"}
        emit({"phase": "timing", "kernel": f"fm_pairwise_vector {name}", **t})
        res[f"fm_pairwise_vector {name}"] = t
    res["fm_pairwise_vector"] = res["fm_pairwise_vector fm"]

    for b in (CTR_REQUEST, CTR_BATCH):  # a serving request and a train step
        label = "flash_attention autoint" + ("" if b == CTR_REQUEST else f" b{b}")
        res[label] = flash_autoint_timing(rng, dev, b)
    return res


def flash_autoint_timing(rng, dev, b) -> dict:
    """The flash forward and backward beside torch SDPA at AutoInt's
    (b, 2, 39, 8), no mask, not causal."""
    import torch
    import torch.nn.functional as F

    from recsys_tpu_torch.kernels import attention as attn
    from recsys_tpu_torch.kernels import dispatch

    h, s, d = 2, NUM_SPARSE + NUM_DENSE, EMBED_DIM // 2
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, s, d), dtype=np.float32))
                   .to(dev) for _ in range(4))
    out, lse = dispatch.flash_attention_fwd(q, k, v)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

    def lib_fwd_bwd():
        for t in (qg, kg, vg):
            t.grad = None
        F.scaled_dot_product_attention(qg, kg, vg).backward(do)

    t = {"fwd_ms": cuda_ms(lambda: dispatch.flash_attention_fwd(q, k, v), 50, 5),
         "bwd_ms": cuda_ms(lambda: dispatch.flash_attention_bwd(q, k, v, None, out, lse, do),
                           50, 5),
         "plain_fwd_ms": cuda_ms(lambda: attn.flash_attention_fwd(q, k, v), 10, 2),
         "plain_bwd_ms": cuda_ms(lambda: attn.flash_attention_bwd(q, k, v, None, out, lse, do),
                                 10, 2),
         "library_fwd_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 50, 5),
         "library_fwd_bwd_ms": cuda_ms(lib_fwd_bwd, 20, 3)}
    # every (query, key) pair kept: 2·D flops a product, 2 products forward
    # and 5 backward; the (B, H, S, D) f32 tensors q, k, v, out (and do, dq,
    # dk, dv backward) and lse once each
    pairs = b * h * s * s
    t.update(flash_bounds("fwd", 4 * (4 * b * h * s * d + b * h * s), 2 * 2 * d * pairs))
    t.update(flash_bounds("bwd", 4 * (8 * b * h * s * d + b * h * s), 5 * 2 * d * pairs))
    emit({"phase": "timing", "kernel": "flash_attention autoint", "shape": [b, h, s, d],
          "causal": False, "mask": None, "dtype": "f32", **t})
    return t


# -- the single-card probes ----------------------------------------------------
PROBE_ITERS = 30
PROBE_HOT = 1024         # the probes' hot rows a table
PROBE_ZIPF = 1.1


def phase_probe_check(rng, dev) -> dict:
    """The three probe kernels against their plain versions (probe_check.py),
    bit for bit, each limit shown to reject its wrong results; the hot
    gather refuses a buffer past the shared-memory limit.  Returns the worst
    abs error of each kernel."""
    import torch

    import probe_check
    from recsys_tpu_torch.kernels import dispatch

    def adam_pass(tables):
        dispatch.reset_launches()
        res = probe_check.check_adam(dispatch.adam_stream_pass_, rng, tables, dev)
        res["launches"] = dispatch.LAUNCHES["adam_stream"]
        res["one_launch_a_32_tables"] = res["launches"] == probe_check.launches_of(tables)
        return res

    runs = [("adam_stream", case, lambda a=tables: adam_pass(a))
            for case, tables in probe_check.ADAM_CASES.items()]
    runs += [("perrow_walk", case, lambda a=args: probe_check.check_perrow(
                 dispatch.perrow_colsum, rng, *a, dev))
             for case, args in probe_check.PERROW_CASES.items()]
    runs += [("hot_gather", case, lambda a=args: probe_check.check_hot(
                 dispatch.hot_gather, rng, *a, dev))
             for case, args in probe_check.HOT_CASES.items()]
    worst = dict.fromkeys(("adam_stream", "perrow_walk", "hot_gather"), 0.0)
    for name, case, run in runs:
        res = run()
        torch.cuda.synchronize()
        ok = probe_check.passed(res) and res.get("one_launch_a_32_tables", True)
        emit({"phase": "check", "case": f"{name} {case}", "limit": "bit-equal", **res, "ok": ok})
        if not ok:
            raise AssertionError(f"{name} {case}: the kernel is not bit-equal to its plain "
                                 f"version, a wrong result passes, or a pass took other "
                                 f"than one launch a 32 tables: {res}")
        worst[name] = max(worst[name], res["max_abs_err"])
    h, pack, d = probe_check.HOT_TOO_BIG
    try:
        dispatch.hot_gather(torch.zeros((h, pack * d), device=dev),
                            torch.zeros(256, dtype=torch.int32, device=dev), pack)
    except ValueError as e:
        emit({"phase": "check", "case": "hot_gather refuses a 256 KB buffer", "error": str(e),
              "ok": True})
    else:
        raise AssertionError("hot_gather: took a hot buffer past the shared-memory limit")
    return worst


def phase_probes(dev) -> dict:
    """The probes at the bench shapes through their CLIs' entry points:
    stream_probe, gather_split_probe (Zipf, then uniform) and dedup_probe,
    each printing its JSON line.  Launch counts are zeroed before and read
    after; every probe kernel must have launched, and the split gather must
    be exact."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.tools import dedup_probe, gather_split_probe, stream_probe

    iters = ["--iters", str(PROBE_ITERS)]
    torch.cuda.synchronize()
    # the main path: counts zeroed just before, read just after
    dispatch.reset_launches()
    t0 = time.perf_counter()
    stream = stream_probe.main(iters)
    split = {dist: gather_split_probe.main(iters + ["--hot", str(PROBE_HOT), *flags])
             for dist, flags in (("zipf", ["--zipf", str(PROBE_ZIPF)]),
                                 ("uniform", ["--uniform"]))}
    dedup = dedup_probe.main(iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(dispatch.LAUNCHES)
    res = {"phase": "probes", "seconds": wall, "launches": launches,
           "adam_stream_gb_s": {k: stream[k]["effective_gb_s"]
                                for k in ("adam_stream_torch", "adam_stream_cuda")},
           "random_gather_gb_s": stream["random_gather_26tables"]["effective_gb_s"],
           "perrow_ns_per_row": stream["perrow_walk"]["ns_per_row"],
           "split_speedup": {k: v["speedup"] for k, v in split.items()},
           "split_max_abs_err": {k: v["max_abs_err"] for k, v in split.items()},
           "dedup_chain_over_plain": dedup["dedup_chain_over_plain"]}
    emit(res)
    bad = {k: v for k, v in res["split_max_abs_err"].items() if v != 0.0}
    if bad:
        raise AssertionError(f"gather_split_probe: the split gather is not exact: {bad}")
    missing = [k for k in ("adam_stream", "perrow_walk", "hot_gather") if launches[k] == 0]
    if missing:
        raise AssertionError(f"probes: kernels of the path never launched: {missing}")
    return res


def phase_probe_timing(rng, dev) -> dict:
    """Kernel, plain, library and bound ms of the probe kernels at the
    probes' shapes: the Adam stream's pass over the 26 bench tables, one
    launch (library: torch's fused Adam, which adds bias correction: the
    same traffic, other values; timed in turns with the kernel), the per-row
    walk over (8192, 128) beside its add-chain floor and the add latency
    read on the card (library: ``x.sum(0)``, in another order), the hot
    gather of one Zipf(1.1) table's hot ids at H = 1024, d = 16, pack 1
    (library: ``index_select`` of the real ids from the hot buffer) beside
    its launch floor, an empty kernel at its grid."""
    import torch

    from recsys_tpu_torch.kernels import build, dispatch
    from recsys_tpu_torch.kernels import probes as probe_ref
    from recsys_tpu_torch.tools import gather_split_probe as gsp
    from recsys_tpu_torch.tools import roofline

    res = {}
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    n_el = VOCAB * EMBED_DIM
    ps = [torch.rand(n_el, generator=gen, device=dev) * 0.1 - 0.05 for _ in range(NUM_SPARSE)]
    gs = [torch.randn(n_el, generator=gen, device=dev) * 1e-3 for _ in range(NUM_SPARSE)]
    ms_, vs = [torch.zeros_like(p) for p in ps], [torch.zeros_like(p) for p in ps]
    lib_ps = [p.clone().requires_grad_() for p in ps]
    for p, g in zip(lib_ps, gs):
        p.grad = g
    fused = torch.optim.Adam(lib_ps, lr=probe_ref.ADAM["lr"], fused=True)

    def kernel_pass():
        dispatch.adam_stream_pass_(ps, ms_, vs, gs)

    def plain_pass():
        for p, m, v, g in zip(ps, ms_, vs, gs):
            probe_ref.adam_stream_step_(p, m, v, g)

    # p, m, v read and written, g read: 28 bytes and about 10 flops an element
    n_pass = n_el * NUM_SPARSE
    b_ms, b_by = bound(7 * 4 * n_pass, 10.0 * n_pass, F32_FLOPS)
    # the kernel and torch's fused Adam in turns: kernel, library, library, kernel
    turns = [cuda_ms(fn, 20, 3) for fn in (kernel_pass, fused.step, fused.step, kernel_pass)]
    t = {"ms": (turns[0] + turns[3]) / 2, "plain_ms": cuda_ms(plain_pass, 10, 2),
         "library_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
         "library": "torch.optim.Adam(fused=True)", "bound_ms": b_ms, "bound_by": b_by,
         "shape": [NUM_SPARSE, VOCAB, EMBED_DIM],
         "per": f"one pass over the {NUM_SPARSE} tables, one launch"}
    t["per_table_ms"] = {k: t[k] / NUM_SPARSE for k in ("ms", "plain_ms", "library_ms",
                                                         "bound_ms")}
    t["tb_s"] = {k: 7 * 4 * n_pass / t[k] / 1e9 for k in ("ms", "library_ms")}
    emit({"phase": "timing", "kernel": "adam_stream", **t})
    res["adam_stream"] = t
    del ps, gs, ms_, vs, lib_ps, fused

    x = torch.randn((8192, 128), generator=gen, device=dev)
    b_ms, b_by = bound(4 * (x.numel() + x.shape[1]), float(x.numel()), F32_FLOPS)
    clock_hz = roofline.card()["max_sm_clock_hz"]
    chain_out = torch.empty(1, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    add_cycles = []
    for _ in range(3):  # the add latency the chain floor assumes, read with clock64
        build.check(build.libraries()["perrow_walk"].perrow_add_chain_cycles(
            x.data_ptr(), chain_out.data_ptr(), cycles.data_ptr(), x.shape[0],
            torch.cuda.current_stream(dev).cuda_stream), "perrow_add_chain_cycles")
        add_cycles.append(cycles.item() / x.shape[0])
    t = {"ms": cuda_ms(lambda: dispatch.perrow_colsum(x), 200, 10),
         "plain_ms": cuda_ms(lambda: probe_ref.perrow_colsum(x), 3, 1),
         "library_ms": cuda_ms(lambda: x.sum(0), 200, 10), "library": "x.sum(0)",
         "bound_ms": b_ms, "bound_by": b_by, "shape": list(x.shape),
         "plan": dispatch.perrow_plan(*x.shape), "clock_hz": clock_hz,
         "chain_floor_ms": roofline.chain_floor_ms(x.shape[0], clock_hz),
         "chain_floor": f"{roofline.F32_ADD_CYCLES} cycles a dependent f32 add at the "
                        f"maximum SM clock", "add_cycles_measured": add_cycles}
    t["ns_per_row"] = t["ms"] * 1e6 / x.shape[0]
    t["cycles_per_row"] = t["ns_per_row"] * clock_hz / 1e9
    emit({"phase": "timing", "kernel": "perrow_walk", **t})
    res["perrow_walk"] = t

    ids = gsp._zipf_ids(rng, PROBE_ZIPF, BATCH, VOCAB)
    hot_rows, hot_idx2d, _, _, n_hot, _ = gsp.host_split(ids, PROBE_HOT)
    table = torch.rand((VOCAB, EMBED_DIM), generator=gen, device=dev) * 0.1 - 0.05
    hot = table.index_select(0, torch.from_numpy(hot_rows).long().to(dev))
    hot_ids = torch.from_numpy(hot_idx2d).to(dev)
    real = hot_ids.reshape(-1)[:n_hot].long()
    n = hot_ids.numel()
    # the hot buffer and the ids read once, the (n, d) rows written once
    b_ms, b_by = bound(4 * (hot.numel() + n + n * EMBED_DIM), 0.0, F32_FLOPS)
    # the launch floor: an empty kernel at the gather's own grid, timed alike
    lib = build.libraries()["hot_gather"]
    grid = lib.hot_gather_grid(n, EMBED_DIM, 1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    floor = cuda_ms(lambda: lib.hot_gather_floor(grid, stream), 200, 10)
    emit({"phase": "timing", "launch_floor_ms": floor, "grid": grid,
          "what": "an empty kernel at the hot gather's grid through cuda_ms"})
    t = {"ms": cuda_ms(lambda: dispatch.hot_gather(hot, hot_ids, 1), 200, 10),
         "plain_ms": cuda_ms(lambda: probe_ref.hot_gather(hot, hot_ids, 1), 200, 10),
         "library_ms": cuda_ms(lambda: hot.index_select(0, real), 200, 10),
         "library": "index_select of the real ids", "bound_ms": b_ms, "bound_by": b_by,
         "launch_floor_ms": floor, "grid": grid,
         "shape": {"hot": list(hot.shape), "ids": list(hot_ids.shape), "n_hot": n_hot}}
    emit({"phase": "timing", "kernel": "hot_gather", **t})
    res["hot_gather"] = t
    return res



# -- multidevice ----------------------------------------------------------------
MD_STEPS = 3             # steps of each mesh run, held against the one-rank steps
MD_KEEP = ("embedding.table_0", "embedding.table_13", "embedding.table_25", "bottom", "top",
           "emb_state.table_0.", "emb_state.table_13.", "emb_state.table_25.")
# (mesh, contract, embedding optimizer, f32 compute) of the spawned worlds
# on the one card: the bench configuration (bf16 compute, bf16 table sums)
# on every mesh and contract, and f32 runs; all held tightly against one
# rank stepping the same microbatch rows
MD_RUNS = {2: [((2, 1), "global", "fused_adam", False), ((2, 1), "local", "fused_adam", False),
               ((1, 2), "global", "fused_adam", False), ((2, 1), "global", "fused_adam", True),
               ((2, 1), "local", "fused_adam", True),
               ((1, 2), "global", "fused_rowwise_adagrad", True)],
           4: [((2, 2), "global", "fused_adam", False), ((2, 2), "local", "fused_adam", False),
               ((2, 2), "local", "fused_rowwise_adagrad", False),
               ((2, 2), "global", "fused_adam", True), ((2, 2), "local", "fused_adam", True),
               ((2, 2), "global", "fused_rowwise_adagrad", True)]}
# A mesh's first step against one rank's over the same microbatch rows
# (a data axis of n splits each microbatch n ways, so the one-rank
# reference runs n·MICROBATCH microbatches): the first moments within
# this in norm.  Only the order of f32 sums differs (2.1e-7 read on a CPU
# at the bench widths, 7.0e-7 on the card at (2, 1) in f32); a gradient
# summed twice over an axis reads 1.
MD_MOMENT_RTOL = 1e-5
# Every step's loss against one rank's, over the same microbatch rows and
# over the bench's 4096-row microbatches: bf16 GEMMs over 2048 rows round
# otherwise than over 4096, 3.1e-4 apart on the third step in bf16 at
# (2, 1) on an H100 80GB HBM3 at 700 W (chip_smoke.py, PR 17)
MD_LOSS_ATOL = 1e-3
MD_ENGINES = [("psum", "psum", {}), ("dedup", "dedup", {}),
              ("a2a", "a2a", {"capacity_factor": None, "dedup": True, "return_stats": True}),
              ("a2a_pipelined", "a2a_pipelined",
               {"num_chunks": 2, "capacity_factor": None, "return_stats": True}),
              ("cols", "cols", {})]
MD_CKPT_VOCAB = 10_000   # the checkpoint round trip's tables, cut: the files stay small
MD_TOPK_ITEMS = 20_000   # protocol seqret's catalog, D = 32
MD_TOPK_QUERIES = 8192


def md_model_fn(schema, f32: bool = False, microbatches: int = MICROBATCH, **kw):
    """The bench DLRM of ``schema`` for the mesh cases (``mesh_check.dlrm``),
    in bf16 compute, or f32 with ``f32``, its dense tail in
    ``microbatches`` slices of a rank's batch."""
    import torch

    from recsys_tpu_torch.tools import mesh_check

    return functools.partial(mesh_check.dlrm, schema, bottom_units=BOTTOM, top_units=TOP,
                             compute_dtype=None if f32 else torch.bfloat16,
                             dense_microbatch=microbatches, sparse_embed_grads=True, **kw)


def md_trainer_kw(opt: str, f32: bool) -> dict:
    return {"embedding_optimizer": opt, "learning_rate": LR, "embedding_fused_bf16": not f32}


def md_state_errors(got: dict, want: dict) -> dict:
    """Of two kept states: each first moment's error in norm (the tables'
    m, v or acc, the dense Adam's exp_avg: they follow the gradient, where
    Adam's update normalises it away; a gradient summed twice over an axis
    reads 1), and of each kept table and of the dense parameters together
    the share of cells more than lr/10 apart and the share outside
    ADAM_TOL."""
    import torch

    moments, past, outside, dense = {}, {}, {}, []
    for k, w in want.items():
        g, w = torch.from_numpy(got[k]).double(), torch.from_numpy(w).double()
        if k.startswith(("emb_state.", "exp_avg.")):
            moments[k] = float((g - w).norm() / w.norm().clamp_min(1e-30))
        elif k.startswith("embedding."):
            past[k], outside[k] = share_off(g, w, STEP_P_THRESH), share_not_close(g, w, ADAM_TOL)
        else:
            dense.append((g.reshape(-1), w.reshape(-1)))
    g, w = (torch.cat(t) for t in zip(*dense))
    past["dense"], outside["dense"] = share_off(g, w, STEP_P_THRESH), share_not_close(g, w, ADAM_TOL)
    return {"worst_moment_rel_err": max(moments.values()),
            "worst_table_share_past_lr_10": max(v for k, v in past.items() if k != "dense"),
            "dense_share_past_lr_10": past["dense"],
            "worst_share_outside_adam_tol": max(outside.values()),
            "moments": moments, "past_lr_10": past, "outside_adam_tol": outside}


def md_check_steps(label: str, got: dict, want: dict, bench: dict | None = None) -> dict:
    """MD_STEPS steps on a mesh against the same steps on one rank, from
    the same seeded init and over the same microbatch rows (``want``):
    every loss finite and within MD_LOSS_ATOL, the first within 1e-5, every
    first moment after it within MD_MOMENT_RTOL in norm, at most
    STEP_STATE_SHARE of any kept table's cells (or the dense parameters')
    outside ADAM_TOL.  Where a data axis split the bench's microbatches,
    ``bench`` is one rank over them: every loss within MD_LOSS_ATOL of its,
    and its first moments' errors shown leaf by leaf.  Later steps start
    from states that already differ, and Adam's first steps from a zero
    state move a cell whose gradient changed sign by lr the other way: the
    final state's errors are shown."""
    import torch

    def losses_close(ref):
        return bool(torch.isclose(gl, torch.tensor(ref["losses"]).double(), rtol=0.0,
                                  atol=MD_LOSS_ATOL).all())

    first = md_state_errors(got["first_state"], want["first_state"])
    last = md_state_errors(got["state"], want["state"])
    gl, wl = torch.tensor(got["losses"]).double(), torch.tensor(want["losses"]).double()
    out = {"losses": got["losses"], "one_rank_losses": want["losses"],
           "loss_max_abs_diff": float((gl - wl).abs().max()),
           "first": {k: v for k, v in first.items() if k.startswith(("worst", "dense"))},
           "first_moments": first["moments"],
           "last": {k: v for k, v in last.items() if k.startswith(("worst", "dense"))},
           "moment_rel_err_limit": MD_MOMENT_RTOL, "loss_atol": MD_LOSS_ATOL}
    ok = bool(torch.isfinite(gl).all()) and losses_close(want)
    ok &= bool(torch.isclose(gl[0], wl[0], rtol=1e-5, atol=1e-5))
    ok &= first["worst_moment_rel_err"] <= MD_MOMENT_RTOL
    ok &= first["worst_share_outside_adam_tol"] <= STEP_STATE_SHARE
    if bench is not None:
        out["bench_microbatch_losses"] = bench["losses"]
        out["bench_microbatch_loss_max_abs_diff"] = float(
            (gl - torch.tensor(bench["losses"]).double()).abs().max())
        out["bench_microbatch_first_moments"] = md_state_errors(
            got["first_state"], bench["first_state"])["moments"]
        ok &= losses_close(bench)
    out["ok"] = ok
    emit({"phase": "check", "case": f"multidevice {label} vs one rank", **out})
    if not ok:
        raise AssertionError(f"multidevice {label}: steps disagree with one rank's: {out}, "
                             f"first step {first}")
    return out


def md_update_inputs(rng, dev, n_ids: int, streams: int, shards: int, vocab=VOCAB):
    """One table's fused-update inputs in a mesh's form: ``streams``
    streams of ``n_ids`` ids each prepped at the port's chunk length with
    the fences of ``shards`` row shards, and a random table shard (the
    last) with its optimizer state; ``window_ids`` counts the ids that
    fall in that shard's rows."""
    import torch

    from recsys_tpu_torch.train.streaming_embed import PREP_CH, host_prep_group

    vs = vocab // shards
    parts, window_ids = [], 0
    for _ in range(streams):
        ids = rng.integers(0, vocab, n_ids).astype(np.int32)
        window_ids += int(((ids >= vocab - vs) & (ids < vocab)).sum())
        cot = (rng.standard_normal((n_ids, EMBED_DIM)) * 1e-2).astype(np.float32)
        i2, ix, cp = host_prep_group(ids, vp=vocab, block=min(UPDATE_BLOCK, vs), ch=PREP_CH,
                                     shards=shards)
        parts.append((cot[ix], i2, cp))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cot, ids2d, cptr = (to(np.concatenate(x)) for x in zip(*parts))
    return {"cot": cot.bfloat16(), "ids2d": ids2d, "cptr": cptr,
            "p": to(rng.uniform(-0.05, 0.05, (vs, EMBED_DIM)).astype(np.float32)),
            "m": to((rng.standard_normal((vs, EMBED_DIM)) * 1e-3).astype(np.float32)),
            "v": to(rng.uniform(1e-8, 1e-4, (vs, EMBED_DIM)).astype(np.float32)),
            "acc": to(rng.uniform(0, 1e-4, vs).astype(np.float32)),
            "shard_index": shards - 1, "streams": streams, "ids": streams * n_ids,
            "window_ids": window_ids, "window_blocks": -(-vs // min(UPDATE_BLOCK, vs))}


def md_kernels(rng, dev) -> tuple[dict, dict]:
    """#4 and #5 in the mesh forms against their plain versions on the card
    (tables and state within ADAM_TOL, ACC_TOL and ADAGRAD_P_TOL), and alone
    against their bytes bound at the step shapes: the local contract's two
    streams of 8192 ids over 26 tables of 100k rows ((2, 1)), and the
    shard window of 26 shards of 50k rows with the 16384-id prep of two
    shards ((1, 2)).  Returns (worst table errors, timings)."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels import embedding_update as emb_ref

    worst = {"embedding_adam": 0.0, "embedding_rowwise_adagrad": 0.0}
    forms = {"streams2": (BATCH // 2, 2, 1), "window": (BATCH, 1, 2),
             "streams2_window": (BATCH // 2, 2, 2)}
    for form, (n_ids, streams, shards) in forms.items():
        a = md_update_inputs(rng, dev, n_ids, streams, shards)
        kw = dict(block=UPDATE_BLOCK, lr=LR, streams=streams, shard_index=a["shard_index"])
        got = [a[k].clone() for k in "pmv"]
        want = [a[k].clone() for k in "pmv"]
        dispatch.fused_embedding_adam(*got, a["cot"], a["ids2d"], a["cptr"], 3, **kw)
        emb_ref.fused_adam(*want, a["cot"], a["ids2d"], a["cptr"], 3, **kw)
        for key, u, v in zip("pmv", got, want):
            err = check_close(f"embedding_adam {form} {key}", u, v, ADAM_TOL)
            if key == "p":
                worst["embedding_adam"] = max(worst["embedding_adam"], err["max_abs_err"])
        got, want = [a["p"].clone(), a["acc"].clone()], [a["p"].clone(), a["acc"].clone()]
        dispatch.fused_embedding_rowwise_adagrad(*got, a["cot"], a["ids2d"], a["cptr"], **kw)
        emb_ref.fused_rowwise_adagrad(*want, a["cot"], a["ids2d"], a["cptr"], **kw)
        err = check_close(f"embedding_rowwise_adagrad {form} p", got[0], want[0],
                          ADAGRAD_P_TOL)
        check_close(f"embedding_rowwise_adagrad {form} acc", got[1], want[1], ACC_TOL)
        worst["embedding_rowwise_adagrad"] = max(worst["embedding_rowwise_adagrad"],
                                                 err["max_abs_err"])
    timing = {"embedding_adam": {}, "embedding_rowwise_adagrad": {}}
    for form in ("streams2", "window"):
        n_ids, streams, shards = forms[form]
        tabs = [md_update_inputs(rng, dev, n_ids, streams, shards) for _ in range(NUM_SPARSE)]
        vd = tabs[0]["p"].numel()
        # of the batch, what a table's shard must read: the cotangent rows
        # (bf16) and ids of the real occurrences in its rows, and each
        # stream's pointers of its window
        stream_in = [t["window_ids"] * (EMBED_DIM * 2 + 4) + streams * (t["window_blocks"] + 1) * 4
                     for t in tabs]
        cols = [[t[k] for t in tabs] for k in ("p", "m", "v", "cot", "ids2d", "cptr")]
        kw = dict(blocks=[UPDATE_BLOCK] * NUM_SPARSE, lr=LR, streams=streams,
                  shard_indices=[tabs[0]["shard_index"]] * NUM_SPARSE)

        def plain_pass():
            for t in tabs:
                emb_ref.fused_adam(*(t[k] for k in ("p", "m", "v", "cot", "ids2d", "cptr")), 3,
                                   block=UPDATE_BLOCK, lr=LR, streams=streams,
                                   shard_index=t["shard_index"])

        t_adam = {f"{form}_ms": cuda_ms(lambda: dispatch.fused_embedding_adam_pass(
                      *cols, 3, **kw), iters=10, warmup=2),
                  f"{form}_plain_ms": cuda_ms(plain_pass, iters=1, warmup=1)}
        t_adam[f"{form}_bound_ms"] = bound(NUM_SPARSE * 6 * 4 * vd + sum(stream_in),
                                           NUM_SPARSE * 16 * vd, F32_FLOPS)[0]
        a = tabs[0]
        one = dict(block=UPDATE_BLOCK, lr=LR, streams=streams, shard_index=a["shard_index"])
        t_ada = {f"{form}_ms": cuda_ms(lambda: dispatch.fused_embedding_rowwise_adagrad(
                     a["p"], a["acc"], a["cot"], a["ids2d"], a["cptr"], **one)),
                 f"{form}_plain_ms": cuda_ms(lambda: emb_ref.fused_rowwise_adagrad(
                     a["p"], a["acc"], a["cot"], a["ids2d"], a["cptr"], **one), iters=5,
                     warmup=1)}
        t_ada[f"{form}_bound_ms"] = bound(2 * 4 * vd + 2 * 4 * a["acc"].numel() + stream_in[0],
                                          8 * vd, F32_FLOPS)[0]
        timing["embedding_adam"].update(t_adam)
        timing["embedding_rowwise_adagrad"].update(t_ada)
        emit({"phase": "timing", "kernel": f"embedding updates, mesh form {form}",
              "tables": [NUM_SPARSE, a["p"].shape[0], EMBED_DIM], "streams": streams,
              "ids_a_stream": n_ids, "shards": shards, "adam_26_tables": t_adam,
              "rowwise_adagrad_one_table": t_ada})
        del tabs, cols
    return worst, timing


def phase_multidevice(rng, dev) -> dict:
    """(a) NCCL at world size 1: the bench DLRM's three steps through the a2a
    and psum engines on the (1, 1) mesh against the gather engine's there;
    the cli's ctr --model dlrm --bf16 --embedding-optimizer
    fused_adam through both engines.  (b) Ranks spawned on this one card
    over gloo (CUDA tensors staged through the host): worlds of 2 and 4,
    three bench-width steps a mesh and contract against the one-rank
    steps, every engine's lookup against the gather, the sharded top-k
    against the whole catalog's, a sharded checkpoint round trip.  (c) #4
    and #5 in the streams and shard-window forms against their plain
    versions, and timed.  The (b) times are one-card gloo times, not NCCL
    or several cards'."""
    import tempfile

    import torch
    import torch.distributed as dist

    from recsys_tpu_torch import cli
    from recsys_tpu_torch.data.synthetic import synthetic_ctr
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.parallel.mesh import init_distributed
    from recsys_tpu_torch.parallel.spawn import spawn
    from recsys_tpu_torch.tools import mesh_check as mc
    from recsys_tpu_torch.train.retrieval import topk_scores

    res = {"runs": {}}
    device = dev.type
    on_card = device == "cuda"  # the CPU takes the plain versions, counting none
    init_distributed(device)
    backend = "nccl" if device == "cuda" else "gloo"
    if dist.get_backend() != backend or dist.get_world_size() != 1:
        raise AssertionError(f"multidevice: {dist.get_backend()} at world size "
                             f"{dist.get_world_size()}, expected {backend} at 1")
    schema, data = synthetic_ctr(num_examples=MD_STEPS * BATCH, num_dense=NUM_DENSE,
                                 num_sparse=NUM_SPARSE, vocab_size=VOCAB, embed_dim=EMBED_DIM,
                                 seed=2)
    batches = [{k: v[s * BATCH:(s + 1) * BATCH] for k, v in data.items()}
               for s in range(MD_STEPS)]
    # one rank's steps, (optimizer, f32, microbatches) -> steps: over the
    # bench's microbatches and over a mesh's, whose data axis of n splits
    # each of them n ways
    refs = {}
    for shape, _, opt, f32 in (r for runs in MD_RUNS.values() for r in runs):
        for nm in (MICROBATCH, MICROBATCH * shape[0]):
            if (opt, f32, nm) not in refs:
                refs[opt, f32, nm] = mc.train_steps(
                    None, md_model_fn(schema, f32, nm), None, batches,
                    trainer_kw=md_trainer_kw(opt, f32), device=device, seed=3, keep=MD_KEEP,
                    first_state=True)
    for (opt, f32, nm), ref in refs.items():  # what the microbatch rows alone move
        if nm != MICROBATCH:
            bench = refs[opt, f32, MICROBATCH]
            emit({"phase": "multidevice", "part": f"one rank, {BATCH // nm}-row against "
                  f"{BATCH // MICROBATCH}-row microbatches", "optimizer": opt,
                  "compute": "f32" if f32 else "bf16", "losses": ref["losses"],
                  "bench_microbatch_losses": bench["losses"],
                  "first_moments": md_state_errors(ref["first_state"],
                                                   bench["first_state"])["moments"]})
    tkw = md_trainer_kw("fused_adam", False)
    # the gather engine's steps on the (1, 1) mesh are the engines' reference
    gather = mc.train_steps((1, 1), md_model_fn(schema), None, batches, trainer_kw=tkw,
                            device=device, seed=3, keep=MD_KEEP, first_state=True)
    for engine in ("a2a", "psum"):
        label = f"{backend} (1, 1) {engine} engine"
        dispatch.reset_launches()
        got = mc.train_steps((1, 1), md_model_fn(schema, embed_kw={"engine": engine}), None,
                             batches, trainer_kw=tkw, device=device, seed=3, keep=MD_KEEP,
                             first_state=True)
        launches = dict(dispatch.LAUNCHES)
        if launches["embedding_adam"] != MD_STEPS * on_card:
            raise AssertionError(f"multidevice {label}: launches {launches}")
        res["runs"][label] = {"launches": launches, "step_seconds": got["seconds"] / (MD_STEPS - 1),
                              "check": md_check_steps(label, got, gather)}
    for engine in ("a2a", "psum"):
        label = f"cli ctr dlrm {engine} {backend} (1, 1)"
        dispatch.reset_launches()
        t0 = time.perf_counter()
        out = cli.main(["ctr", "--model", "dlrm", "--bf16", "--embedding-engine", engine,
                        "--embedding-optimizer", "fused_adam", "--epochs", "1",
                        "--batch-size", "4096", "--device", device])
        launches = dict(dispatch.LAUNCHES)
        if bool(launches["embedding_adam"] and launches["dot_interaction"]) != on_card or \
                not np.isfinite(out["loss"]).all() or not 0.0 <= out["auc"] <= 1.0:
            raise AssertionError(f"multidevice {label}: {out}, launches {launches}")
        res["runs"][label] = {"launches": launches, "seconds": time.perf_counter() - t0,
                              "auc": out["auc"], "a2a_dropped": out.get("a2a_dropped")}
    emit({"phase": "multidevice", "part": f"{backend} world 1", **res["runs"]})

    # (b) spawned ranks on this card over gloo
    crng = np.random.default_rng(5)
    table = crng.normal(size=(VOCAB, EMBED_DIM)).astype(np.float32)
    rows = crng.integers(0, VOCAB, (BATCH, NUM_SPARSE)).astype(np.int64)
    weights = crng.normal(size=(BATCH, NUM_SPARSE, EMBED_DIM)).astype(np.float32)
    items = crng.normal(size=(MD_TOPK_ITEMS, 32)).astype(np.float32)
    queries = crng.normal(size=(MD_TOPK_QUERIES, 32)).astype(np.float32)
    ck_schema, ck_data = synthetic_ctr(num_examples=2 * 4096, num_dense=NUM_DENSE,
                                       num_sparse=NUM_SPARSE, vocab_size=MD_CKPT_VOCAB,
                                       embed_dim=EMBED_DIM, seed=4)
    ck_batches = [{k: v[i * 4096:(i + 1) * 4096] for k, v in ck_data.items()} for i in range(2)]
    tmp = tempfile.mkdtemp(prefix="md_ckpt")
    for world, runs in MD_RUNS.items():
        jobs = [(mc.train_steps, (shape, md_model_fn(schema, f32), None, batches, contract,
                                  md_trainer_kw(opt, f32)),
                 {"device": device, "count_launches": True, "seed": 3, "keep": MD_KEEP,
                  "first_state": True, "only_rank0": True})
                for shape, contract, opt, f32 in runs]
        shape = runs[-1][0]
        jobs.append((mc.lookups, (shape, table, rows, weights, MD_ENGINES),
                     {"device": device, "only_rank0": True}))
        jobs.append((mc.topk, (shape, queries, items, 10), {"device": device}))
        if world == 2:
            jobs.append((mc.checkpoint, ((1, 2), (2, 1), f"{tmp}/ckpt",
                                         md_model_fn(ck_schema), ck_batches,
                                         {"embedding_optimizer": "fused_adam"}),
                         {"device": device}))
        foreign = []
        t0 = time.perf_counter()
        ranks = spawn(mc.run_jobs, world, jobs, device=device, backend="gloo", foreign=foreign)
        if world == 2:
            shutil.rmtree(tmp, ignore_errors=True)
        spawn_s = time.perf_counter() - t0
        if foreign:
            raise AssertionError(f"multidevice: a rank imported {foreign}")
        for i, (shape, contract, opt, f32) in enumerate(runs):
            label = f"gloo {shape} {contract} {opt} {'f32' if f32 else 'bf16'} on one {device}"
            got = ranks[0][i]
            for r in ranks[1:]:
                if r[i]["losses"] != got["losses"]:
                    raise AssertionError(f"multidevice {label}: ranks' losses differ")
            launches = {k: sum(r[i]["launches"].get(k, 0) for r in ranks)
                        for k in dispatch.LAUNCHES}
            kernel = "embedding_adam" if opt == "fused_adam" else "embedding_rowwise_adagrad"
            per_step = 1 if opt == "fused_adam" else NUM_SPARSE
            if launches[kernel] != world * per_step * MD_STEPS * on_card or \
                    launches["dot_interaction"] != world * MICROBATCH * MD_STEPS * on_card:
                raise AssertionError(f"multidevice {label}: launches {launches}")
            res["runs"][label] = {"launches": launches,
                                  "rank_step_seconds": got["seconds"] / (MD_STEPS - 1),
                                  "check": md_check_steps(
                                      label, got, refs[opt, f32, MICROBATCH * shape[0]],
                                      refs[opt, f32, MICROBATCH] if shape[0] > 1 else None)}
        # every engine's lookup against the gather, its gradient the scatter-add
        look = ranks[0][len(runs)]
        want_out = torch.from_numpy(table)[torch.from_numpy(rows)]
        want_grad = torch.zeros(VOCAB, EMBED_DIM, dtype=torch.float64).index_add_(
            0, torch.from_numpy(rows).reshape(-1),
            torch.from_numpy(weights).reshape(-1, EMBED_DIM).double())
        for label, (out, grad, dropped) in look.items():
            if not np.array_equal(out, want_out.numpy()) or dropped not in (None, 0):
                raise AssertionError(f"multidevice {shape} {label}: lookup is not the gather's")
            check_close(f"multidevice {shape} {label} gradient", torch.from_numpy(grad),
                        want_grad.float(), dict(rtol=1e-5, atol=1e-6))
        emit({"phase": "check", "case": f"multidevice {shape} lookups bit-equal to the gather",
              "engines": sorted(look), "ok": True})
        v, i, topk_launches = ranks[0][len(runs) + 1]
        with torch.inference_mode():
            wv, wi = topk_scores(torch.from_numpy(queries).to(dev),
                                 torch.from_numpy(items).to(dev), 10)
        if not np.array_equal(i, wi.cpu().numpy()) or (topk_launches < 1) == on_card:
            raise AssertionError(f"multidevice {shape}: sharded top-k ids differ from the "
                                 f"whole catalog's (launches {topk_launches})")
        check_close(f"multidevice {shape} sharded top-k values", torch.from_numpy(v),
                    wv.cpu(), dict(rtol=1e-6, atol=1e-6))
        res["runs"][f"gloo {shape} topk"] = {"launches": {
            k: (sum(r[len(runs) + 1][2] for r in ranks) if k == "topk_scores" else 0)
            for k in dispatch.LAUNCHES}}
        if world == 2:
            for r in ranks:
                ck = r[-1]
                if not (ck["equal"] and ck["next_loss_equal"] and ck["table_share"] == 0.5
                        and ck["refused"]):
                    raise AssertionError(f"multidevice: sharded checkpoint round trip {ck}")
            emit({"phase": "check", "case": "multidevice (1, 2) sharded checkpoint round trip, "
                  "(2, 1) refused", "ok": True, "refusal": ranks[0][-1]["refused"]})
        emit({"phase": "multidevice", "part": f"gloo world {world} on one card",
              "spawn_and_run_seconds": spawn_s,
              **{k: v for k, v in res["runs"].items() if k.startswith("gloo")
                 and k.split(" (")[1].split(")")[0] in {str(r[0])[1:-1] for r in runs}}})
    res["worst"], res["timing"] = md_kernels(rng, dev)
    return res


TOOLS_ITERS = 10          # cuda_ms calls a timing in the tools phase
TOOLS_SWEEP = {"batches": (4096,), "fields": (26, 128), "dims": (16, 128)}
TOOLS_TOPK = {"catalogs": (100_000, 1_000_000), "topk_dims": (64,)}
TOOLS_COMM = dict(batch=4096, vocab=VOCAB)  # comm_bytes' and skew_capacity's defaults
TOOLS_SCALING = dict(per_device_batch=2048, steps=5, vocab=10_000, embed_dim=16)  # scaling's


def finite_ms(label: str, *values) -> None:
    if not all(isinstance(v, float) and np.isfinite(v) and v > 0 for v in values):
        raise AssertionError(f"tools {label}: times {values}")


def phase_tools(dev) -> dict:
    """The measuring tools on the card (module docstring, 24h).  Returns
    {'launches': the kernels the in-process tools and the scaling rank
    launched, 'reports': each tool's report}."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.parallel.spawn import spawn
    from recsys_tpu_torch.tools import (comm_bytes, dense_probe, kernel_sweep, mesh_check as mc,
                                        roofline, scaling, skew_capacity)

    reports = {}
    dispatch.reset_launches()
    t0 = time.perf_counter()
    roof = roofline.run(BATCH, TOOLS_ITERS, device=dev)
    for name, e in roof["phases"].items():
        finite_ms(f"roofline {name}", e["ms"], e["sol_ms"])
    finite_ms("roofline full step", roof["full_step_ms"])
    reports["roofline"] = roof
    emit({"phase": "tools", "tool": "roofline", "seconds": time.perf_counter() - t0,
          **{k: v for k, v in roof.items() if k != "nvidia_smi"}})
    t0 = time.perf_counter()
    dense = dense_probe.run(TOOLS_ITERS, device=dev)
    finite_ms("dense_probe", dense["achievable_peak"]["ms"], dense["composition_floor_ms"],
              *(r["ms"] for r in dense["matmuls"]), *dense["phase_ms"].values())
    reports["dense_probe"] = dense
    emit({"phase": "tools", "tool": "dense_probe", "seconds": time.perf_counter() - t0,
          **{k: v for k, v in dense.items() if k != "nvidia_smi"}})
    t0 = time.perf_counter()
    sweep = {"interactions": kernel_sweep.sweep_interactions(TOOLS_ITERS, device=dev,
                                                             **TOOLS_SWEEP),
             "topk": kernel_sweep.sweep_topk(3, device=dev, **TOOLS_TOPK)}
    for row in sweep["interactions"]:
        finite_ms(f"kernel_sweep {row}", *(row[k] for k in ("fm_torch_ms", "fm_kernel_ms",
                                                            "dot_torch_ms", "dot_kernel_ms")))
    for row in sweep["topk"]:
        finite_ms(f"kernel_sweep {row}", *(row[k] for k in ("torch_full_ms", "torch_stream_ms",
                                                            "library_ms", "kernel_ms")))
    reports["kernel_sweep"] = sweep
    emit({"phase": "tools", "tool": "kernel_sweep", "seconds": time.perf_counter() - t0, **sweep})
    launches = dict(dispatch.LAUNCHES)
    for name in ("dot_interaction", "embedding_adam", "fm_pairwise_vector", "topk_scores"):
        if not launches[name]:
            raise AssertionError(f"tools: {name} never launched: {launches}")

    # counts are properties of the program: gloo ranks on the card read as on the CPU.
    # One world runs both tools on both devices: a world's start costs more than the
    # tools' work in it
    table, ids = skew_capacity.inputs(TOOLS_COMM["batch"], TOOLS_COMM["vocab"])
    comm_args = ((2, 2), TOOLS_COMM["batch"], TOOLS_COMM["vocab"], EMBED_DIM, 8)
    devices = (dev, torch.device("cpu"))
    jobs = [job for device in devices for job in (
        (comm_bytes.rank_counts, (*comm_args, comm_bytes.DTYPE, device.type), {}),
        (skew_capacity.rank_drops, ((2, 2), table, ids, skew_capacity.CAPACITY_FACTORS,
                                    device.type), {}))]
    t0 = time.perf_counter()
    ranks = spawn(mc.run_jobs, 4, jobs, device=dev.type, backend="gloo")
    world_s = {"gloo (2, 2)": time.perf_counter() - t0}
    got = {device.type: (
        comm_bytes.report([r[2 * i] for r in ranks], *comm_args, "gloo", device),
        skew_capacity.report([r[2 * i + 1] for r in ranks], (2, 2), TOOLS_COMM["batch"],
                             TOOLS_COMM["vocab"], 0, ids, "gloo", device))
        for i, device in enumerate(devices)}
    for i, (label, keys) in enumerate((("comm_bytes", ("engines", "shard_grad_sync")),
                                       ("skew_capacity", ("results", "min_zero_drop_cf")))):
        card_rep, cpu_rep = got[dev.type][i], got["cpu"][i]
        if any(card_rep[k] != cpu_rep[k] for k in keys):
            raise AssertionError(f"tools {label}: the card's counts differ from the CPU's: "
                                 f"{card_rep} against {cpu_rep}")
        reports[label] = card_rep
        emit({"phase": "tools", "tool": label, "equal_on_cpu": True, **card_rep})
    # comm_bytes at world size 1 and scaling at one rank, under NCCL in one world
    nccl_args = ((1, 1), TOOLS_COMM["batch"], TOOLS_COMM["vocab"], EMBED_DIM, 8)
    t0 = time.perf_counter()
    ((counts, fit),) = spawn(mc.run_jobs, 1, [
        (comm_bytes.rank_counts, (*nccl_args, comm_bytes.DTYPE, dev.type), {}),
        (scaling.rank_fit, (1,), dict(TOOLS_SCALING, device=dev.type))],
        device=dev.type, backend="nccl")
    world_s["nccl (1, 1)"] = time.perf_counter() - t0
    nccl = comm_bytes.report([counts], *nccl_args, "nccl", dev)
    if not nccl["engines"]["a2a"]["ops"]:
        raise AssertionError(f"tools comm_bytes under NCCL: {nccl}")
    reports["comm_bytes_nccl"] = nccl
    emit({"phase": "tools", "tool": "comm_bytes", **nccl})
    scale = scaling.report({1: fit}, **TOOLS_SCALING, backend="nccl", device=dev)
    (one,) = scale["measured"]
    if scale["kind"] != "measured" or not one["launches"].get("dot_interaction"):
        raise AssertionError(f"tools scaling: {scale}")
    finite_ms("scaling", 1e3 / one["examples_per_s"])
    reports["scaling"] = scale
    emit({"phase": "tools", "tool": "scaling", **scale})
    emit({"phase": "tools", "tool": "worlds", "seconds": world_s})
    for k, v in one["launches"].items():
        launches[k] += v
    return {"launches": launches, "reports": reports}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "recsys_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (recsys_tpu_torch/ "
              "not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()

    card = phase_card()
    phase_build()
    worst = phase_check(rng, dev)
    phase_f4(rng, dev)
    params = jax_layout_params(rng)
    serve = phase_serve(params, dev)
    train = phase_train(params, dev)
    timing = phase_timing(rng, dev)
    worst.update(phase_flash_check(rng, dev))
    sas_serve = phase_sasrec_serve(rng, dev)
    sas_train = phase_sasrec_train(rng, dev)
    sas_cli = phase_sasrec_cli(dev)
    timing.update(phase_flash_timing(rng, dev))
    ni, yt_train, yt_test, ratings, meta = phase_youtube_data()
    worst.update(phase_youtube_check(rng, dev, ni))
    yt_params = youtube_jax_params(rng, ni)
    yt_serve = phase_youtube_serve(youtube_model(yt_params, ni, dev), yt_test, ni, dev,
                                   "random weights")
    yt_fit, yt_fitted = phase_youtube_train(youtube_model(yt_params, ni, dev), yt_train, ni,
                                            dev)
    yt_after = phase_youtube_serve(yt_fitted, yt_test, ni, dev, f"after {YOUTUBE_STEPS} steps")
    if not yt_after["recall@10"] > yt_after["random_recall@10"]:
        raise AssertionError(f"youtube: recall@10 {yt_after['recall@10']} after the fit is "
                             f"not above random {yt_after['random_recall@10']}")
    del yt_fitted
    timing.update(phase_youtube_timing(rng, dev, yt_test["hist"], ni))
    mind = phase_mind(yt_train, yt_test, ni, dev)
    two_tower = phase_two_tower(ratings, meta, dev)
    slice_s = {}  # the seconds of the last two slices' phases
    ncf, slice_s["ncf"] = timed(phase_ncf, ratings, dev)
    din, slice_s["din"] = timed(phase_din, ratings, meta, dev)
    del ratings, meta, yt_train, yt_test
    worst.update(phase_ctr_check(rng, dev))
    ctr_serve = phase_ctr_serve(rng, dev)
    ctr_steps = phase_ctr_train_step(rng, dev)
    ctr_protocol = phase_ctr_protocol(dev)
    ctr_bf16_tables = phase_ctr_table_dtype(dev)
    timing.update(phase_ctr_timing(rng, dev))
    worst.update(phase_probe_check(rng, dev))
    probes = phase_probes(dev)
    timing.update(phase_probe_timing(rng, dev))
    cli_runs = phase_cli(dev)
    slice_s["cli tasks"] = sum(r["seconds"] for k, r in cli_runs.items()
                               if k in ("ncf", "din") or k.startswith("multitask"))
    protocol_seq = phase_protocol_seq(dev)
    multitask, slice_s["multitask"] = timed(phase_multitask, dev)
    protocol_mt, slice_s["protocol mt"] = timed(phase_protocol_mt, dev)
    files, slice_s["files"] = timed(phase_files, dev)
    multidevice, slice_s["multidevice"] = timed(phase_multidevice, rng, dev)
    tools, slice_s["tools"] = timed(phase_tools, dev)
    emit({"phase": "slice seconds", **slice_s, "total": sum(slice_s.values())})
    for name in ("embedding_adam", "embedding_rowwise_adagrad"):
        timing[name].update(multidevice["timing"][name])
        worst[name] = max(worst[name], multidevice["worst"][name])
    timing["embedding_adam"].update({f"stream_{k}": files["stream"]["embedding_adam"][k]
                                     for k in ("ms", "plain_ms", "bound_ms")})

    csrc = "recsys_tpu_torch/kernels/csrc/"
    sources = {
        "dot_interaction": (csrc + "dot_interaction.cu",
                            "recsys_tpu/kernels/pallas/interactions_tpu.py:84"),
        "fm_pairwise_vector": (csrc + "fm_interaction.cu",
                               "recsys_tpu/kernels/pallas/interactions_tpu.py:35"),
        "mlp_fwd": (csrc + "mlp_fwd.cu", "recsys_tpu/kernels/pallas/mlp_tpu.py:112"),
        "mlp_bwd": (csrc + "mlp_bwd.cu", "recsys_tpu/kernels/pallas/mlp_tpu.py:134"),
        "embedding_adam": (csrc + "embedding_update.cu",
                           "recsys_tpu/kernels/pallas/embedding_update_tpu.py:109"),
        "embedding_rowwise_adagrad": (csrc + "embedding_update.cu",
                                      "recsys_tpu/kernels/pallas/embedding_update_tpu.py:267"),
        "flash_attention_fwd": (csrc + "flash_attention_fwd.cu",
                                "recsys_tpu/kernels/pallas/attention_tpu.py:165"),
        "flash_attention_bwd": (csrc + "flash_attention_bwd.cu",
                                "recsys_tpu/kernels/pallas/attention_tpu.py:350"),
        "pooled_gather": (csrc + "pooled_gather.cu",
                          "recsys_tpu/kernels/pallas/embedding_tpu.py:76"),
        "topk_scores": (csrc + "topk_scores.cu", "recsys_tpu/kernels/pallas/topk_tpu.py:78"),
        "adam_stream": (csrc + "adam_stream.cu", "recsys_tpu/tools/stream_probe.py:85"),
        "perrow_walk": (csrc + "perrow_walk.cu", "recsys_tpu/tools/stream_probe.py:196"),
        "hot_gather": (csrc + "hot_gather.cu", "recsys_tpu/tools/gather_split_probe.py:93"),
    }
    kernels = []
    runs = [*serve.values(), *train.values(), sas_serve, *sas_train.values(), sas_cli,
            yt_serve, yt_fit, yt_after, *ctr_serve.values(), *ctr_steps.values(),
            ctr_protocol, ctr_bf16_tables, probes, mind, {"launches": mind["train_launches"]},
            *two_tower.values(), *({"launches": r["train_launches"]} for r in two_tower.values()),
            *cli_runs.values(), *protocol_seq.values(), ncf, *din.values(),
            *multitask.values(), *protocol_mt.values(),
            *(r for r in files.values() if "launches" in r), *multidevice["runs"].values(),
            tools]
    for name, (source, replaces) in sources.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(r["launches"][name] for r in runs),
            "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **{k: t[k] for k in ("unfused_ms", "launch_floor_ms", "f32_core_bound_ms",
                                 "stream_ms", "stream_plain_ms", "stream_bound_ms",
                                 *(f"{form}_{x}" for form in ("streams2", "window")
                                   for x in ("ms", "plain_ms", "bound_ms"))) if k in t},
        })
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(card["nvidia_smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                 "count": card["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
