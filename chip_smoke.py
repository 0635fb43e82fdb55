#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. the card: its name and power limit (nvidia-smi); no card -> exit 1.
2. build every hand-written kernel from ops/csrc (one nvcc per source, all
   started together, sm_90a) and print the build seconds and each
   kernel's -Xptxas -v register/shared/spill lines.
3. the top-k kernels against their plain torch version on the card at the
   serving shape (256 users x 1,000,000 items x 80 factors): f32, bf16 and
   masked inputs, k in {10, 128, 1024}; then at edge shapes (U = 1 and 257,
   N = 1,000,003, D = 13, 84 and 128), random and exact, f32 and bf16, with
   and without a mask, k in {10, 16, 17, 128, 1024}. Random inputs: values
   within atol=1e-4 + rtol=1e-5 (3xTF32 products, f32 sums in another
   order), and an id may differ only if the kernel's item truly scores that
   value (recomputed in f64). Exact-arithmetic inputs (small integers): ids
   and values identical. Every call is made twice: the same bits. The build
   log shows no ptxas line that serialises the top-k kernel's wgmmas.
4. the fused pairwise step kernel (one call per train step: rows read by
   id, the metadata composite and deltas, the updates added in place, the
   loss stored) against the plain step (gather, row math, index_add_) on
   the card: all 48 step variants (3 losses x sigmoid x weights x bf16 x
   metadata) at B = 1024, 8192 and 1000 from the 100K-user / 1M-item
   packed tables at D=80, ids with forced duplicates (a user on a 16th of
   the rows, an item that is many rows' positive and negative), weighted
   variants with a tenth of zero weights, metadata at (F, W) in {1, 2} x
   {1, 3} (1000- and 50-row tables, ~30% of slots masked, every 97th item
   fully masked). Rows no id names must stay bit-identical; a row one
   update lands on within 1e-6 + 1e-5 |x|; a row k >= 2 updates land on
   within that plus k * 2^-23 * (|old| + sum |update|) (the atomics add
   them in no fixed order); the loss within 1e-6 + 1e-5 |x|; table rows
   of hinge-kink batch rows skipped (counted). Each call counts one
   launch. An out-of-range id traps: checked in child processes (a trap
   leaves the CUDA context unusable).
   The row-level kernel (the FM step's and the mesh wrappers' contract)
   against its plain version on the card,
   all 96 variants (3 losses x sigmoid x weights x emit_g x item_upd x bf16),
   on B = 1024 and 8192 rows gathered from a 1M-item and a 100K-user
   packed table at D=80: every output within rtol=1e-5, atol=1e-6 (f32
   sums in another order, FMA contraction), rows whose hinge diff lies
   within 1e-4 of the kink excluded (their subgradient may flip; counted).
   The in-batch softmax CE kernels (forward; the one-pass backward of dh,
   dv and dvb) against their plain versions, square and rectangular (Br
   rows against Bc columns from off: (1024, 4096, 0), (1024, 4096, 3072),
   (1000, 4000, 3000), (1, 4096, 4095), positives from 50 ids so that
   duplicates sit on both sides of each shard boundary): B=4096 x D=80 with a
   logQ-shifted bias, duplicate-heavy positives (10 ids), a ragged B=1000,
   D in {16, 128}, a cotangent with zero rows, D=13 (rows with no 16-byte
   copies), B=7 (below one tile), D=84 (16-byte rows, not a multiple of 8),
   B=4097 (one row past a tile) and, for the forward, spread logits (h
   and v x 8: most exponentials underflow, the running max moves often). loss and lse
   within rtol=atol=1e-5 (f32 sums
   in another order, a one-pass LSE); dh, dv, dvb within rtol=1e-4 plus
   1e-5 of the largest |reference| entry (sums of B terms of both signs).
   A second run of each kernel gives the same bits.
   The fused MLP tower layer kernels (forward; backward dh and dW/db on
   wgmma) against their plain versions in bf16: both main-path layers
   (16,384 rows, 160 -> 1024 and 1024 -> 128 with batch norm), Din=240, a
   ragged R=1000, a tiny odd shape, widths that are not multiples of 8
   (100 -> 60), R=40 (below one wgmma tile), Dout=1000 (not a multiple of
   the column tile) and R=16383. z and din within one bf16 ulp of their
   product; every f32 sum (s, ss against an f64 sum of the kernel's own z;
   dW, db and the BN sums against the plain version) within 1e-5 of the
   sum of its absolute terms (f32 order); repeated runs bit-identical.
5. card against CPU: a small catalog served from integer tables (raw ids
   identical) and a small dataset trained for two epochs from one start
   with the same round keys (losses and tables within rtol=1e-4,
   atol=1e-5: f32 sums in another order; index_add_ on the card adds
   duplicate ids in no fixed order), with the pairwise loss (Linear and
   FM, each with and without metadata) and with
   sampled softmax (under torch's deterministic algorithms: two epochs
   amplify that order past the tolerance in one item bias); the softmax
   tables' evaluate(loss, auc) with the same negatives on both. The AMP
   MLP (240 -> 256 -> 64, one category column) the same way: losses within
   rtol=0.08, tables and weights by the noise-floor rule of 6f, evaluate.
6. the main paths, each driven with every launch count set to 0 just
   before and read just after, over ~3M synthetic interactions (100K
   users, 1M items, D=80; 2.4M train rows):
   a. train with one int category column: the JAX-layout state carried
      over, ``fit(epochs=1, batch_size=1024)`` with in-training uniform
      negatives. The step kernel must be called once per step and no
      other kernel (the row-level one included) launch, the epoch loss be
      finite, and the loss of a fixed sample of 65,536 train pairs fall
      below the fresh start's; then 20 steps from one state and
      one epoch's batches with the step kernel and with the plain step on
      the card, tables and accumulators within rtol=1e-4, atol=1e-5 (at
      most 8 rows per table beyond it: a hinge flip).
   b. predict from the trained tables: 256-user batches at top_k=10,
      top_k=128 and exclude_seen=True; every top-k kernel must launch. A
      batch of each is checked against the plain path.
   c. train without metadata (static negatives, fused_pairwise_step), with
      the checks of a.
   d. sampled softmax with the int category column: ``fit(epochs=1,
      batch_size=4096, loss="sampled_softmax")`` from seeded tables. Each
      CE kernel must launch once per step, the epoch loss be finite and
      the in-batch CE of 16 fixed train batches fall below the fresh
      start's; 10 steps with the kernels and with the plain versions on
      the card agree (rtol=1e-4, atol=1e-5); then ``evaluate(batch_size=
      4096, eval_metrics=("loss", "auc", "recall@10"))``: the forward
      kernel launches once per eval batch, the top-k kernel serves
      recall@10, and the AUC beats the fresh tables'.
   e. sampled softmax without metadata, with the checks of d but evaluate.
   f. the MLP with AMP (the JAX package's north star, bench.py:140-173):
      ``RecSys(net_type="mlp", n_factors=80, hidden_layers=(1024, 128),
      use_batch_norm=True, use_amp=True, dynamic_neg_sampling=True)`` from
      seeded tables, ``fit(batch_size=8192, learning_rate=0.05,
      loss="hinge")``: 293 steps (timed), each tower kernel launched
      exactly twice per step (one per hidden layer) and nothing else, a
      finite epoch loss; a second such epoch, after which the hinge loss of
      65,536 fixed train pairs lies below the fresh start's (after the
      first it moves by noise only); 10 steps with the kernels, with the
      plain versions and in f32 from one state, the kernels' change of
      every table and weight within the JAX package's noise-floor rule of
      the plain versions'; then ``evaluate(batch_size=8192, ("loss",
      "auc"))`` (no kernel; finite; with fixed negatives it agrees with a
      direct recomputation over every test row: this data's items occur ~3
      times each, so the MLP memorizes without generalizing and its test
      AUC does not rise) and a 16-user ``predict(top_k=10)`` through the
      chunked scorer (no kernel; rescored items in order). Then the same
      seed, tables and two epochs with f32 compute (the plain tower, no
      kernel) as a witness: the AMP run's test AUC at most 0.02 below its
      AUC, and its sample loss at most 10% above.
   g. FM (``net_type="fm"``, fm_sigmoid=True) with and without the
      category column, the checks of a and c: with metadata every step is
      one launch of the row-level kernel (emit_g, no item rows, the
      sigmoid) between torch gathers and scatters and no step-kernel
      call; without it one call of the step kernel's sigmoid variant; the
      variant index each wrapper passed is checked. Then evaluate(loss,
      auc, recall@10) at batch 4096 (recall@10 through #1, nothing else;
      loss and AUC against a direct recomputation with fixed negatives;
      with metadata the AUC above the fresh tables'; without it this
      data's items, each seen ~3 times, give no test signal, so its AUC
      is printed only) and predict as in b.
   h. AMP (``use_amp=True``): Linear and FM, each with and without
      metadata, one epoch each through the step kernel's bf16 variants
      (FM with metadata: the row-level kernel's, between its torch glue;
      variant index checked); 20 steps, each held against the plain bf16
      step from the same pre-step tables by the step phase's rule
      (hinge-kink rows skipped); a bf16 predict, as in b, from the AMP
      Linear metadata model's tables through #1/#2.
   i. sampled softmax with AMP (Linear, no metadata) and FM
      (fm_sigmoid=False, metadata), the checks of d; the AMP steps held
      per step against the plain CE by the change of each table (distance
      <= 2^-8 of the plain change: bf16 gradients may round to the other
      neighbour); FM's evaluate as in d.
   j. popularity sampling at K=1 with a cosine lr schedule over the
      epoch (Linear, the category column, hinge, batch 1024): the alias
      table's host build time; 2^24 alias draws on the card held against
      count^0.75 (chi-square below df + 6 sqrt(2 df)), no zero-count item
      drawn, no negative equal to its positive; one step-kernel call per
      step and nothing else, each at the schedule's lr for its step (and
      the cosine within 1e-8); 20 steps kernel vs plain at their scheduled
      lrs as in a; the sample loss falls.
   k. bench.py:358-365's row: Linear, loss="warp", num_negatives=8,
      popularity negatives, batch 8192, lr 0.05: the autograd step over
      9 x 8192 scored rows, no kernel; a finite loss, the hinge sample loss
      falls; evaluate(loss, auc) over 8 draws per row (the AUC on the
      first) against a direct recomputation with fixed draws.
   l. bench.py:350-351's row: NeuCF with AMP, hinge, batch 8192: one
      epoch, evaluate(loss, auc) against a direct recomputation, a 16-user
      predict(top_k=10) through the chunked scorer; no launch, all finite.
   m. card against CPU on phase 5's small dataset, two epochs from one
      start, the same negatives on both: embedding_optimizer="sgd",
      fused_embedding_update=False, adaptive_hinge with K=4, NeuCF in f32,
      sampled softmax under a step schedule (each CE kernel once per step)
      and popularity at K=1 under an exponential schedule (the step kernel
      once per step; the alias map on the card equal to the CPU's on the
      same uniforms); losses, tables, accumulators and NeuCF's dense layers
      within rtol=1e-4, atol=1e-5.
   n. checkpoints and incremental training (ROADMAP.md §A items 4 and
      12), on a's model right after its timings, on f's after its
      breakdown: a. ``save`` of a's Linear metadata model (seconds,
      bytes); ``restore`` into a fresh RecSys over the same data and its
      top_k 10 (#1) and 128 (#2) of 256 users identical to the warm
      model's (values and ids). b. one more epoch in place, one from
      ``RecSys.load`` of that checkpoint (its trainer, the same store) and
      one in memory again from a copy of the state (the noise floor): #3
      once per step in both, epoch losses and every table and
      accumulator within rtol=1e-4, atol=1e-5, but for at most
      max(64, 2 x the noise floor's) rows of a table (the step kernel's
      atomics add in no fixed order; a hinge-kink row flips). c. f's
      AMP MLP saved (dense, batch-norm statistics, adam with its count,
      step, generator); one more epoch from ``RecSys.load`` against one in
      memory, under deterministic algorithms: #6 and #7 once per hidden
      layer per step in both, the loss and every table, accumulator,
      weight, variance and adam leaf within that tolerance (the biases
      batch norm or neg - pos removes, and their running means, printed
      only). d. ``partial_fit`` of 300,000 new interactions (20,000 new
      users, 100,000 new items, 50 new categories, mixed with known ids)
      on a's model: the vocabularies grow by exactly those, trained rows
      and accumulators stay bit-identical and new accumulators start at
      zero (checked inside ``update_data``), #3 once per step of the
      grown split, the loss of 65,536 new train pairs falls, 256 new raw
      users served through #1 (checked against the plain path) decode in
      the grown vocabulary; the grown model saved. Then one child process
      (``sys.executable``) loads a's, d's and c's checkpoints (and o's)
      cold
      (``RecSys.load``, no dataset) and serves the same users: ids,
      values and raw ids identical to the parent's, ``exclude_seen``
      raises. e. save and load seconds, checkpoint MiB, ``update_data``
      host seconds, ``grow_state`` ms and ``partial_fit`` examples/s on one
      ``[ckpt]`` line beside the card's name and power limit.
   o. the sequence models (ROADMAP.md §A item 10; bench.py:266-296 and
      :415-418's rows): the LSTM and SASRec (2 blocks x 2 heads), d=80,
      history_len=20, AMP, hinge, adam, lr 0.05, batch 8192, one epoch
      each through the autograd step (293 steps; SASRec's five norms a
      step through the layer-norm kernels #8, no other kernel); evaluate
      (loss, auc, recall@10: #1 once per 512 test users) with the loss and
      AUC held to a direct recomputation by the paired-side rule; predict
      at top_k=10 (#1), 128 (#2) and exclude_seen from 256-user batches,
      each checked against the plain top-k, the kernels also seen by the
      profiler; the fit's per-step breakdown and idle share. SASRec then
      trains one sampled-softmax epoch at batch 4096: #4 and #5 once per
      step. Card against CPU: a small LSTM and SASRec (d=16, history 20)
      one bpr epoch from one start within rtol=2e-4, atol=1e-5; the small
      LSTM saved and cold-loaded in 6n's child process, serving identical
      ids and values through #1/#2.
   p. EASE (ROADMAP.md §A item 11) at README.md:150's width: card against
      CPU first (3,000 users x 700 items: G bit-identical, B within
      rtol=1e-5, atol=1e-6, ids identical); then ``RecSys(net_type=
      "ease")`` over 3M interactions of 100K users x 30K items: fit (Gram
      on the TF32 tensor cores and solve seconds, peak device memory, no
      kernel launch), G bit-identical to an IEEE f32 product, the exact
      solve's off-diagonal residual (A P)_ij / (A P)_jj at most 1e-3,
      diag(B) == 0; evaluate(recall@10, hit_rate@10, ndcg@10), the hit
      rate above 3x a random top-10's; 256-user predict batches at
      top_k=10, 128 and exclude_seen (users/s), every batch's items
      scoring the f64 top-k within atol=1e-4 + rtol=1e-5; similar_items
      (the top of B's row, the query dropped); save, and a cold load in
      6n's child serving identical ids and values; update_data of 100,000
      interactions (1,000 new users, 100 new items), predict refused until
      the refit, the refit's nnz; Newton-Schulz at 8192 items against the
      exact solve within rtol=1e-3, atol=1e-4, with its iterations.
   q. the streaming fit (ROADMAP.md §A item 13; 2.4M train rows, cut from
      benchmarks/STREAMING.md's 200M): Linear with the category column,
      hinge, batch 1024, ``Trainer.fit_streaming(superbatch_size=2^17)``:
      19 chunks, #3 once per step and no other kernel, every chunk the
      split's rows of its index in the JAX stream's order, int64, the
      sample loss falls; resident and streamed examples/s in turns; a
      profiled streamed epoch: the host-to-device copies on their own
      stream, overlapping step kernels, the copy time with no kernel
      running, the idle share; one chunk of the whole split against the
      resident epoch from one state and keys (6n's rule); sampled softmax
      at batch 4096 and 2^19 (#4/#5 once per step); the north-star AMP MLP
      at 2^20 (#6/#7 twice per step).
   r. the mesh (ROADMAP.md §A item 14a): four rank processes on this one
      card over gloo (NCCL refuses two ranks on one device), one world,
      three meshes in turn, at the main path's width (100K users x 1M
      items, D=80, the category column), while the parent runs the
      single-device references. (4, 1): Linear, hinge, batch 1024, one
      epoch of 2,344 steps through fused_pairwise_step_meta_dp (B3): each
      rank's 256 rows through the row-level #3 once per step and no other
      kernel; then sampled softmax at 4096, 586 steps through
      inbatch_softmax_ce_dp (B5): #4/#5 once per step per rank at Br=1024
      rows against Bc=4096 columns. (2, 2): FM with metadata, 300 steps
      through fused_pairwise_step_meta_tp (B4), evaluate (loss, AUC,
      recall@10 through B6) within 1e-4 of the single device's, save (rank
      0 writes the gathered state; a cold RecSys.load without a mesh in
      6n's child serves identical ids and values). (1, 4): the (4, 1)
      model's checkpoint restored onto the mesh, 4 batches of 256 users at
      top_k 10 and 128, with and without exclude_seen, through #1/#2 on
      250,000-row shards (B6): ids, values and raw ids identical to the
      single device's. Every table against the single-device run from the
      same seeded state and epoch by 6n's rule (softmax at rtol 2e-4);
      every rank's replicated tables bitwise equal (sha256); each rank's
      launch counts exactly as stated; each rank's step ms, collective ms
      per step (timed between device syncs) and examples/s, labelled as
      four ranks sharing one card: no scaling figure. A rank that fails,
      or a rank still running after 600 s, fails the phase.
   s. the generic step on a mesh (ROADMAP.md §A item 14b): the same four
      ranks, every other net and config (``GEN_RUNS``), each against one
      device.
   t. logging, profiling and the examples (ROADMAP.md §A item 15), at the
      main path's width. Three fits, each run three times from the same
      seeded tables under torch's deterministic algorithms: verbose, with
      ``profile_epochs=1`` (verbose), and not verbose: Linear with the
      category column, hinge, batch 1024, two epochs (#3); Linear sampled
      softmax at 4096, one epoch (#4/#5); the north-star AMP MLP, one epoch
      (#6/#7). The train logger sees one ``epoch k: loss=`` record per
      epoch in the verbose fits, the digest once in the profiled one, and
      nothing in the last; the verbose fit's stdout carries the
      ``[torchrecsys_tpu_torch.train]`` prefix; evaluate logs one ``eval:``
      record with verbose and none without. The profiled epoch's trace
      (utils/trace_files.py::op_totals) counts each kernel of the fit's
      wrappers exactly as often as the wrappers launched it in that epoch
      (a take whose trace lost records runs again, up to 3); the profiled
      fit's losses and state equal the first fit's bit for bit, or, where
      the unprofiled fits differ from each other too (#3's atomics), lie
      within that noise floor by 6n's rule. Printed: the digest, the
      profiled and unprofiled epoch's examples/s, the trace's MiB. Then
      ``quickstart``, ``retrieval_training`` and ``production_serving``
      in process through ``main(["--device", "cuda"])`` at their own
      sizes, their asserts held, each launching its kernels (quickstart:
      the row-level kernel's bf16 variant and #1 on a bf16 catalog;
      retrieval: #4/#5 and #1; serving: #3, #1 and #2); and
      ``multihost_train`` as four gloo rank processes on the card (its
      default 200,000 rows, two streamed epochs): every rank exits 0 and
      rank 0 prints finite losses and eval.
7. times: per-kernel CUDA-event ms and device us per call from
   torch.profiler (each top-k wrapper: at most 3 kernels per call), beside the bound, the plain version
   and, where one exists, one library call the port never uses (the top-k
   rows also at D=160 and on a bf16 catalog); predict
   users/s, fit examples/s (hinge, softmax, MLP) and evaluate rows/s; per-call
   breakdowns; device time per kernel and the device's idle share over a
   window of train steps (torch.profiler); the hinge fit's window must hold
   the two step kernels per step and nothing else (FM with metadata: the
   row-level kernel and its loss sum, its torch glue split out). The
   row-level kernel's row is timed at FM's metadata shape. The step's own row: ms,
   device us, the bound from the bytes its batch needs, the device time of
   an empty kernel on the same grid (the launch floor), the plain step,
   host us per call against the bare C call. The layer-norm pair (#8,
   SASRec's encoder) at the SASRec cell's shape (409,600 x 50, f32 and
   bf16): ms, device us, the bound from its bytes, the plain chain's ms.
   HSTU's attention pair (#9) at the HSTU cell's shape (8192 histories x 2
   heads x 200 x 25, f32, its windows), first held to float64 and bit for
   bit across two backward runs: ms, device us, the bounds over the full
   square and over the unmasked pairs, the share of tile pairs computed,
   the plain chain's ms; then one epoch of HSTU's fit at the cell's widths
   through the Trainer (4 steps of 8192), #9's launches counted from 0
   before it (8 + 8 a step) and reported as #9's launches.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

U, N, D = 256, 1_000_000, 80  # serving shape: a request batch over the catalog
N_USERS, N_INTERACTIONS = 100_000, 3_000_000
TRAIN_B = 1024  # fit batch size on the main path
SOFTMAX_B = 4096  # sampled-softmax fit and evaluate batch size
MLP_B = 8192  # MLP fit and evaluate batch size (bench.py:140-173)
MLP_HIDDEN = (1024, 128)
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM TF32 tensor cores, dense
SPLIT_F32_FLOPS = PEAK_TF32_FLOPS / 3  # f32-accurate products as 3xTF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ATOL, RTOL = 1e-4, 1e-5
KERNEL_ROWS = {
    # wrapper -> (TPU kernel it replaces, k timed at the main path)
    "dot_topk_small": ("torchrecsys_tpu/ops/dot_topk.py:136", 10),
    "dot_topk_large": ("torchrecsys_tpu/ops/dot_topk.py:362", 128),
}
SOURCE = "torchrecsys_tpu_torch/ops/csrc/dot_topk.cu"
TRAIN_SOURCE = "torchrecsys_tpu_torch/ops/csrc/fused_pairwise.cu"
TRAIN_REPLACES = "torchrecsys_tpu/ops/fused_pairwise.py:100"
CE_SOURCE = "torchrecsys_tpu_torch/ops/csrc/softmax_ce.cu"
CE_REPLACES = {
    "softmax_ce_fwd": "torchrecsys_tpu/ops/softmax_ce.py:67",
    "softmax_ce_bwd": "torchrecsys_tpu/ops/softmax_ce.py:92",
}
TOWER_SOURCE = "torchrecsys_tpu_torch/ops/csrc/fused_tower.cu"
TOWER_REPLACES = {
    "fused_tower_fwd": "torchrecsys_tpu/ops/fused_tower.py:75",
    "fused_tower_bwd": "torchrecsys_tpu/ops/fused_tower.py:139",
}
# the main path's layers: (rows, Din, Dout, BN on the input) at 2 x MLP_B rows
TOWER_LAYERS = ((2 * MLP_B, 2 * D, MLP_HIDDEN[0], False), (2 * MLP_B, MLP_HIDDEN[0], MLP_HIDDEN[1], True))
LN_SOURCE = "torchrecsys_tpu_torch/ops/csrc/layer_norm.cu"
LN_REPLACES = "none (the JAX package's norm is jnp ops that XLA fuses: torchrecsys_tpu/models/sasrec.py)"
LN_ROWS, LN_D, LN_EPS = 8192 * 50, 50, 1e-6  # the SASRec cell's encoder: batch 8192 x history 50, d = 50
LN_AMP_ROWS = MLP_B * 20  # 6o's AMP SASRec encoder: batch 8192 x history 20, d = D, bf16
LN_HSTU_ROWS = 8192 * 200  # the HSTU cell's encoder: batch 8192 x history 200, d = 50, unit affine, f32
HA_SOURCE = "torchrecsys_tpu_torch/ops/csrc/hstu_attention.cu"
HA_REPLACES = "none (HSTU exists only in the port: torchrecsys_tpu_torch/models/hstu.py)"
HA_B, HA_L, HA_HEADS, HA_DH = 8192, 200, 2, 25  # the HSTU cell's attention: batch 8192, window 200, 2 heads of 25
HA_MIN_LEN = 62  # window lengths drawn from 62 .. 200 (mean ~131 valid keys, as the cell's), from position 0
HA_CHUNK = 1024  # histories a float64 reference chunk holds
HA_FIT_USERS, HA_FIT_ITEMS, HA_FIT_ROWS = 240, 3706, 40_960  # #9's fit: ~136 train items a user, 4 steps of 8192
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def build_kernels():
    from torchrecsys_tpu_torch.ops import _build

    t0 = time.perf_counter()
    results = _build.build_all()
    log(f"[build] {len(results)} source(s) in {time.perf_counter() - t0:.2f} s")
    for res in results.values():
        log(f"[build] {res.source}: nvcc {res.seconds:.2f} s -> {res.library}")
        if res.source == "dot_topk.cu":  # ptxas says so only in an info line
            serial = [line.strip() for line in res.log.splitlines() if "C75" in line]
            check(not serial, "dot_topk.cu: ptxas serialises wgmma: " + "; ".join(serial)[:400])
            wgmma_sass(res.library)
        name, frame = None, ""
        per: dict = {}  # kernel name -> [(resources, frame)], one per template variant
        for line in res.log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name, frame = m.group(1), ""
            elif "stack frame" in line:
                frame = line.strip()
            elif "Used" in line and name:
                m = re.search(r"_cu_\w+?((?:dot_topk|fused_pairwise|softmax_ce|fused_tower|sum_splits)_\w*?kernel)", name)
                short = m.group(1) if m else name[:60]
                per.setdefault(short, []).append((line.split(":", 1)[1].strip(), frame))
        for short, entries in per.items():
            if len(entries) == 1:
                log(f"[build]   {short}: {entries[0][0]}; {entries[0][1]}")
                continue
            regs = [int(re.search(r"Used (\d+) registers", e).group(1)) for e, _ in entries]
            spills = sum(1 for _, f in entries if "0 bytes spill stores, 0 bytes spill loads" not in f)
            log(f"[build]   {short}: {len(entries)} template variants, {min(regs)}-{max(regs)} "
                f"registers, {spills} with spills; e.g. {entries[0][0]}; {entries[0][1]}")


def wgmma_sass(library: str) -> None:
    """The SASS of the top-k kernel's variants: its products must stay
    asynchronous: a serialised kernel waits after every HGMMA; this one
    waits once per pass of k steps."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", library], capture_output=True, text=True,
                          timeout=300).stdout
    counts = []
    for block in sass.split("Function : ")[1:]:
        if "dot_topk_tc_kernel" not in block.split("\n", 1)[0]:
            continue
        hgmma, waits = block.count("HGMMA"), block.count("WARPGROUP.DEPBAR.LE gsb0, 0x0")
        check(hgmma > 0 and (waits <= 2 or 4 * waits < hgmma),
              f"dot_topk_tc_kernel: {hgmma} HGMMA, {waits} full waits: serialised")
        counts.append((hgmma, waits))
    check(bool(counts), "dot_topk_tc_kernel: no SASS found")
    log(f"[build]   dot_topk_tc_kernel SASS: {len(counts)} variants, HGMMA per variant "
        f"{min(c[0] for c in counts)}-{max(c[0] for c in counts)}, full waits {max(c[1] for c in counts)} at most")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain version
# ---------------------------------------------------------------------------


def compare_topk(uv, iv, ib, mask, k, v, i, pv, pi, exact: bool):
    """Kernel (v, i) against plain (pv, pi). Returns (max |dv|, id
    mismatches); raises on a fault."""
    import torch

    check(v.shape == pv.shape and i.shape == pi.shape, f"shape {tuple(v.shape)} != {tuple(pv.shape)}")
    check(bool(torch.isfinite(v).all()), "non-finite kernel scores")
    err = float((v - pv).abs().max())
    mism = int((i != pi).sum())
    if exact:
        check(err == 0.0 and mism == 0, f"exact input: max|dv|={err}, {mism} id mismatches")
        return err, mism
    tol = ATOL + RTOL * pv.abs()
    check(bool(((v - pv).abs() <= tol).all()), f"values differ by {err}")
    check(bool((i >= 0).all() and (i < iv.shape[0]).all()), "item id out of range")
    rows = i.long()
    true = (uv.double()[:, None, :] * iv[rows].double()).sum(-1) + ib.double()[rows]
    if mask is not None:
        from torchrecsys_tpu_torch.ops.dot_topk import _NEG_INF, mask_bits_for_items

        seen = torch.stack([mask_bits_for_items(mask[r : r + 1], rows[r])[0] for r in range(rows.shape[0])])
        true = torch.where(seen, _NEG_INF, true)
    check(bool(((true - v.double()).abs() <= tol.double()).all()), "kernel ids do not score their values")
    for r in range(i.shape[0]):
        check(i[r].unique().numel() == k, f"row {r}: repeated item ids")
    return err, mism


def topk_inputs(torch, gen, u: int, n: int, d: int, exact: bool):
    """(users, items, bias) on the card: small integers (every score exact
    in f32 whatever the order) or standard normals."""
    dev = torch.device(DEVICE)
    if exact:
        return (torch.randint(-3, 4, (u, d), generator=gen, device=dev).float(),
                torch.randint(-3, 4, (n, d), generator=gen, device=dev).float(),
                torch.randint(-3, 4, (n,), generator=gen, device=dev).float())
    return (torch.randn(u, d, generator=gen, device=dev), torch.randn(n, d, generator=gen, device=dev),
            torch.randn(n, generator=gen, device=dev))


def seen_mask(torch, u: int, n: int, seed: int):
    """A packed seen mask: up to 400 seen items per user; the first user has
    seen all but 5 (fewer unseen items than k: the masked tail)."""
    from torchrecsys_tpu_torch.ops import dot_topk as dt

    rng = np.random.default_rng(seed)
    seen = [rng.choice(n, size=int(rng.integers(0, min(400, n))), replace=False) for _ in range(u)]
    seen[0] = np.setdiff1d(np.arange(n), rng.choice(n, size=5, replace=False))
    return torch.as_tensor(dt.pack_seen_mask(seen, n), device=DEVICE)


def check_topk_call(torch, fn, u_, i_, ib, k, m, exact):
    """One kernel call against the plain version, and a second call that
    must give the same bits. Returns (max |dv|, id mismatches)."""
    from torchrecsys_tpu_torch.ops import dot_topk as dt

    v, i = fn(u_, i_, ib, k, seen_mask=m)
    v2, i2 = fn(u_, i_, ib, k, seen_mask=m)
    pv, pi = dt.dot_topk_plain(u_, i_, ib, k, seen_mask=m)
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()
    check(torch.equal(v, v2) and torch.equal(i, i2), f"{fn.__name__} k={k}: a repeated call differs")
    return compare_topk(u_.float(), i_.float(), ib, m, min(k, i_.shape[0]), v, i, pv, pi, exact)


# Edge shapes of the top-k kernels: (U, N, D). A partial user tile (U = 1,
# 257), a partial item tile and split (N = 1,000,003), rows that are not
# whole 16-byte units (D = 13: the wrapper pads them), D = 84, the widest
# one-unit row (D = 128), and the slab path (128-byte TMA boxes, two per
# ring unit, an odd last box a tail unit): D = 136 (a tail of 8 f32
# lanes), 160 (NeuCF's item table at n_factors = 80; a tail of 32), 192
# (f32 without a tail), 256, and 300 with a partial user tile and the
# stepped-down user tiles.
TOPK_EDGES = ((1, 200_000, D), (257, 200_000, D), (U, 1_000_003, D), (U, 200_000, 13), (U, 200_000, 84),
              (U, 200_000, 128), (U, 200_000, 136), (U, 200_000, 160), (U, 200_000, 192), (U, 200_000, 256),
              (257, 200_000, 300))
WIDE_D = 160  # C1: the top-k kernels' D > 128 on the main path (Linear at n_factors=160; NeuCF's 2 x 80 items)
TIMED_WIDE_DS = (WIDE_D, 256)  # the slab path's timed widths (256: a common retrieval width)
WIDE_STEPS = 300  # the wide Linear's autograd steps of TRAIN_B before it serves
TOPK_EDGE_KS = (10, 16, 17, 128, 1024)
# The widest D that the top-k plan took with 128-lane slabs (before the
# slab path's TMA boxes), per list length k (each k a buffer size of its
# own): (k, f32, bf16). Every D up to it (a multiple of 4 for f32, 8 for
# bf16) must still plan; TOPK_PAST_REACH must raise, for every k.
TOPK_REACH = ((1, 2432, 11776), (16, 2432, 11776), (17, 2432, 11776), (64, 2432, 11776), (128, 2304, 11264),
              (129, 2304, 11264), (192, 2304, 11264), (193, 2048, 10240), (448, 2048, 10240), (449, 1536, 8192),
              (960, 1536, 8192), (961, 512, 4096), (1024, 512, 4096))
TOPK_PAST_REACH = (8192, 32768)  # f32, bf16


def kernel_phase(torch):
    from torchrecsys_tpu_torch.ops import dot_topk as dt

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    mask = seen_mask(torch, U, N, 0)
    errs = {name: 0.0 for name in KERNEL_ROWS}
    for exact in (False, True):
        uv, iv, ib = topk_inputs(torch, gen, U, N, D, exact)
        for dtype, m in ((torch.float32, None), (torch.bfloat16, None), (torch.float32, mask)):
            u_, i_ = uv.to(dtype), iv.to(dtype)
            for k in (10, 128, 1024):
                fn = dt.dot_topk_small if k <= 16 else dt.dot_topk_large
                if dev.type == "cuda" and not exact and m is None:
                    p = dt.plan(k > 16, U, N, D, dtype == torch.bfloat16, k)
                    log(f"[kernel] {fn.__name__} k={k} {str(dtype).removeprefix('torch.')}: {p.splits} catalog "
                        f"splits, lists of {p.list_len}, buffers of {p.cap} per user, {p.smem} B dynamic shared "
                        f"memory per block, {p.stages} ring slots, {p.keys} published keys per user")
                err, mism = check_topk_call(torch, fn, u_, i_, ib, k, m, exact)
                if not exact:
                    errs[fn.__name__] = max(errs[fn.__name__], err)
                log(
                    f"[kernel] {fn.__name__:15s} {'exact ' if exact else 'random'} "
                    f"{str(dtype).removeprefix('torch.'):8s} masked={m is not None!s:5s} k={k:4d}: "
                    f"max|dv|={err:.3g} id mismatches={mism}"
                )
        del uv, iv, ib
    edges = 0
    for u, n, d in TOPK_EDGES:
        masks = {False: None, True: seen_mask(torch, u, n, u + n + d)}
        worst = 0.0
        for exact in (False, True):
            uv, iv, ib = topk_inputs(torch, gen, u, n, d, exact)
            for dtype in (torch.float32, torch.bfloat16):
                u_, i_ = uv.to(dtype), iv.to(dtype)
                for masked in (False, True):
                    for k in TOPK_EDGE_KS:
                        fn = dt.dot_topk_small if k <= 16 else dt.dot_topk_large
                        err, _ = check_topk_call(torch, fn, u_, i_, ib, k, masks[masked], exact)
                        worst = max(worst, err)
                        edges += 1
            del uv, iv, ib
        log(f"[kernel] edge shape U={u} N={n} D={d}: random and exact, f32 and bf16, with and without a mask, "
            f"k in {TOPK_EDGE_KS}: every call matches, repeated calls bit-identical; max|dv|={worst:.3g}")
    log(f"[kernel] {edges} edge-shape calls checked")
    plan_reach(dt)
    return errs


def plan_reach(dt):
    """Every (D, k, dtype) of TOPK_REACH still plans; a width past the
    reach raises from the plan (no fallback)."""
    t0, planned = time.perf_counter(), 0
    for k, *reach in TOPK_REACH:
        for bf16, most in ((False, reach[0]), (True, reach[1])):
            for d in range(8 if bf16 else 4, most + 1, 8 if bf16 else 4):
                dt.plan(k > 16, U, N, d, bf16, k)
                planned += 1
            past = TOPK_PAST_REACH[bf16]
            try:
                dt.plan(k > 16, U, N, past, bf16, k)
            except ValueError:
                continue
            raise SmokeFailure(f"dot_topk plan: D={past} {'bf16' if bf16 else 'f32'} k={k} planned past the reach")
    log(f"[kernel] plan reach: {planned} (D, k, dtype) of TOPK_REACH plan (every D up to the 128-lane slabs' widest, "
        f"k in {[r[0] for r in TOPK_REACH]}), and D={TOPK_PAST_REACH[0]} f32 / {TOPK_PAST_REACH[1]} bf16 raises "
        f"for every k, in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 4: the fused pairwise train kernel against its plain version
# ---------------------------------------------------------------------------


def packed_table(torch, rows: int, gen):
    """A (rows, 128) packed side table (fused_pairwise.py layout): vectors
    N(0, 0.2^2), accumulators |N(0, 0.5^2)|, biases N(0, 0.1^2)."""
    t = torch.zeros((rows, 128), device=DEVICE)
    t[:, :D] = torch.randn((rows, D), generator=gen, device=DEVICE) * 0.2
    t[:, D] = torch.randn((rows,), generator=gen, device=DEVICE).abs() * 0.5
    t[:, D + 1] = torch.randn((rows,), generator=gen, device=DEVICE) * 0.1
    t[:, D + 2] = torch.randn((rows,), generator=gen, device=DEVICE).abs() * 0.5
    return t


def hinge_kink_rows(torch, u, p, n, sigmoid, bf16, width=1e-4):
    """Rows whose hinge diff lies within ``width`` of 0 (f64 recompute)."""
    def rnd(x):
        return x.to(torch.bfloat16).double() if bf16 else x.double()

    raw_p = (rnd(u[:, :D]) * rnd(p[:, :D])).sum(1) + rnd(u[:, D + 1]) + rnd(p[:, D + 1])
    raw_n = (rnd(u[:, :D]) * rnd(n[:, :D])).sum(1) + rnd(u[:, D + 1]) + rnd(n[:, D + 1])
    if sigmoid:
        raw_p, raw_n = torch.sigmoid(raw_p), torch.sigmoid(raw_n)
    return (raw_n - raw_p + 1.0).abs() < width


def train_kernel_phase(torch):
    """Every variant of the fused pairwise kernel against its plain version
    on rows gathered from 1M-item / 100K-user packed tables. Returns the
    largest |kernel - plain| over all variants' update rows (the loss sums,
    over up to 8192 rows, are printed as relative differences)."""
    import itertools

    from torchrecsys_tpu_torch.ops import fused_pairwise as fp

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    users, items = packed_table(torch, N_USERS, gen), packed_table(torch, N, gen)
    batches = {}
    for b in (1024, 8192):
        uid = torch.randint(0, N_USERS, (b,), generator=gen, device=DEVICE)
        iid = torch.randint(0, N, (2 * b,), generator=gen, device=DEVICE)
        pn = items[iid]
        batches[b] = (users[uid], pn[:b], pn[b:], torch.rand((b,), generator=gen, device=DEVICE))
    del users, items
    saved = fp.pairwise_updates_rows.launches
    worst = 0.0
    for loss, sig, use_w, (emit_g, item_upd), bf16 in itertools.product(
        ("hinge", "bpr", "logistic"), (False, True), (False, True),
        ((False, True), (True, True), (True, False), (False, False)), (False, True),
    ):
        kw = dict(d=D, margin=1.0, loss_kind=loss, sigmoid=sig, eps=1e-10,
                  emit_g=emit_g, item_upd=item_upd, bf16=bf16)
        parts = []
        for b, (u, p, n, w) in batches.items():
            w = w if use_w else None
            inv = 1.0 / (float(w.sum()) if use_w else b)
            got = fp.pairwise_updates_rows(u, p, n, w, inv, 0.05, **kw)
            want = fp.pairwise_updates_rows_plain(u, p, n, w, inv, 0.05, **kw)
            torch.cuda.synchronize()
            keep = ~hinge_kink_rows(torch, u, p, n, sig, bf16) if loss == "hinge" else None
            err = 0.0
            loss_rel = abs(float(got[2]) - float(want[2])) / max(abs(float(want[2])), 1e-30)
            for name, g, x in zip(("upd_u", "upd_items", "loss_sum"), got, want):
                if x is None:
                    check(g is None, f"{name}: the kernel wrote item rows with item_upd=False")
                    continue
                check(bool(torch.isfinite(g).all()), f"{loss} {kw}: non-finite {name}")
                if keep is not None and name != "loss_sum":
                    m = keep if name == "upd_u" else torch.cat([keep, keep])
                    g, x = g[m], x[m]
                bad = (g - x).abs() > 1e-6 + 1e-5 * x.abs()
                check(not bool(bad.any()), f"{loss} {kw} B={b}: {name} differs from the plain "
                      f"version by {float((g - x).abs().max()):.3g}")
                if name != "loss_sum":
                    err = max(err, float((g - x).abs().max()))
            worst = max(worst, err)
            kinks = 0 if keep is None else int((~keep).sum())
            parts.append(f"B={b} rows max|d|={err:.3g} loss_sum rel {loss_rel:.2g}"
                         + (f" ({kinks} kink rows)" if kinks else ""))
        log(f"[train-kernel] {loss:8s} sigmoid={sig:d} use_w={use_w:d} emit_g={emit_g:d} "
            f"item_upd={item_upd:d} bf16={bf16:d}: " + ", ".join(parts))
    fp.pairwise_updates_rows.launches = saved  # comparison launches do not count
    return worst


# ---------------------------------------------------------------------------
# phase 4a: the fused pairwise step kernel against the plain step
# ---------------------------------------------------------------------------

STEP_META = ((1, 1), (1, 3), (2, 1), (2, 3))  # (F, W) of the step check's metadata
STEP_BATCHES = (1024, 8192, 1000)
STEP_DUP_ULP = 2.0 ** -23  # two orders of k f32 additions differ by at most k * 2^-23 * sum |terms|
# the row math's difference between the step kernel and the plain step, as a share of a row's
# updates (step_compare): summation orders and IEEE 1/sqrtf against torch.rsqrt. bf16 takes the
# same share: both paths sum the metadata composite in the same order, so they round the same
# values to bf16 (on the card every bf16 variant stays within 2e-7, as f32 does)
STEP_REL = 1e-5


def step_ids(torch, b: int, gen):
    """Batch ids from the 100K-user / 1M-item tables with forced
    duplicates: one user on a 16th of the rows, a popular positive on every
    7th row that is also every 11th row's negative, and every 13th row's
    negative its own positive."""
    uid = torch.randint(0, N_USERS, (b,), generator=gen, device=DEVICE)
    pid, nid = (torch.randint(0, N, (b,), generator=gen, device=DEVICE) for _ in range(2))
    uid[: max(b // 16, 1)] = uid[0]
    pid[1::7] = pid[0]
    nid[2::11] = pid[0]
    nid[3::13] = pid[3::13]
    return uid, pid, nid


def step_meta(torch, nf: int, nw: int, gen):
    """nf augmented (rows, D+1) metadata tables (1000 and 50 rows: every
    row shared by many items), (N, nf, nw) ids and masks (~30% masked;
    every 97th item fully masked)."""
    tables = []
    for rows in (1000, 50)[:nf]:
        t = torch.randn((rows, D + 1), generator=gen, device=DEVICE) * 0.2
        t[:, D] = t[:, D].abs() * 2.5
        tables.append(t)
    ids = torch.stack([torch.randint(0, t.shape[0], (N, nw), generator=gen, device=DEVICE)
                       for t in tables], dim=1)
    mask = torch.rand((N, nf, nw), generator=gen, device=DEVICE) < 0.7
    mask[::97] = False
    return tables, ids, mask


def step_compare(torch, name, got, want, old, ids, width, upd, excluded, rel):
    """Kernel table ``got`` against plain table ``want`` (both from
    ``old``), lane by lane: rows never touched identical to ``old``; on a
    touched row the two deltas (new - old) agree within
        2^-24 (|got| + |want|)       each path rounds old + update once
      + rel * (sum |update| + U)     the row math's difference between the
                                     paths, as a share of the row's updates
                                     and of U, the step's largest |update|
                                     in this table (a lane whose terms
                                     cancel, e.g. a user whose positive is
                                     its negative, keeps a rounding residue
                                     of terms of that size on the card's
                                     fma and exactly 0 in the plain step)
      + k 2^-23 (|old| + sum |update|)   only when k >= 2 updates land on
                                     the row (atomics add them in no fixed order)
      + 2^-126                       a flushed denormal
    so the tolerance stays far below one update (a dropped or mis-scaled
    update fails). Rows in ``excluded`` (hinge-kink batch rows) are skipped
    and counted. Returns (max |diff|, largest diff / tolerance, the rel a
    row needed at most, rows with duplicates, excluded rows)."""
    uniq, inv, counts = torch.unique(ids, return_inverse=True, return_counts=True)
    untouched = torch.ones(old.shape[0], dtype=torch.bool, device=DEVICE)
    untouched[uniq] = False
    check(torch.equal(got[untouched], old[untouched]), f"{name}: the kernel wrote rows no id names")
    f64 = torch.float64
    sums = torch.zeros((uniq.numel(), width), dtype=f64, device=DEVICE).index_add_(0, inv, upd.double().abs())
    g, x, o = (t[uniq, :width].double() for t in (got, want, old))
    k = counts[:, None].double()
    fixed = 2.0**-24 * (g.abs() + x.abs()) + torch.where(k > 1, k * STEP_DUP_ULP * (o.abs() + sums), 0.0) + 2.0**-126
    scale = sums + float(upd.abs().max())
    tol = fixed + rel * scale
    skip = torch.isin(uniq, excluded)
    diff = (g - x).abs()
    over = torch.where(skip[:, None], float("-inf"), diff - tol)
    bad = (over > 0).any(dim=1)
    if bool(bad.any()):
        at = int(over.argmax())
        r, c = divmod(at, width)
        check(False, f"{name}: {int(bad.sum())} rows differ from the plain step; the worst, row "
              f"{int(uniq[r])} lane {c}: kernel {float(g[r, c]):.9g}, plain {float(x[r, c]):.9g}, "
              f"old {float(o[r, c]):.9g}, |diff| {float(diff[r, c]):.3g} > tolerance {float(tol[r, c]):.3g}")
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite values")
    keep = ~skip
    if not bool(keep.any()):
        return 0.0, 0.0, 0.0, int((counts > 1).sum()), int(skip.sum())
    need = ((diff - fixed).clamp_min(0.0) / scale.clamp_min(1e-300))[keep]
    return (float(diff[keep].max()), float((diff / tol)[keep].max()), float(need.max()),
            int((counts > 1).sum()), int(skip.sum()))


def step_case(torch, fp, tables, ids, w, kw, meta, label, lin=None):
    """One step through the kernel and one through the plain step from the
    same tables; every table compared (step_compare, rel = STEP_REL) and
    the loss within 1e-6 + 1e-5 |x|. ``lin``: FM's linear-metadata tables
    (FM's metadata step: the row-level kernel against its plain version,
    the same torch glue around both). Returns (max |diff|, largest diff /
    tolerance, largest rel needed, rows with duplicates, excluded rows)."""
    uid, pid, nid = ids
    fm = lin is not None
    runs = []
    for step in ((fp.fused_pairwise_step_meta, fp.fused_pairwise_step_meta_plain) if meta is not None
                 else (fp.fused_pairwise_step, fp.fused_pairwise_step_plain)):
        t = [tables[0].clone(), tables[1].clone()]
        if meta is not None:
            mv = [m.clone() for m in meta[0]]
            ml = [m.clone() for m in lin] if fm else []
            out = step(*t, mv, meta[1], meta[2], *ids, w, 0.05, **kw,
                       **(dict(meta_lin=ml, fm=True) if fm else {}))
            runs.append((t + mv + ml, out[3]))
        else:
            out = step(*t, *ids, w, 0.05, **kw)
            runs.append((t, out[2]))
    torch.cuda.synchronize()
    (kt, kl), (pt, pl) = runs
    check(abs(float(kl) - float(pl)) <= 1e-6 + 1e-5 * abs(float(pl)), f"{label}: loss {float(kl)} != plain {float(pl)}")
    # the plain step's update rows, from the same tables: each row's sum of |updates|
    inv = fp.step_inv(uid.shape[0], w)
    rk = dict(d=D, margin=kw["margin"], loss_kind=kw["loss_kind"], sigmoid=kw["sigmoid"], eps=1e-10, bf16=kw["bf16"])
    u, pn = tables[0][uid], tables[1][torch.cat([pid, nid])]
    lin_deltas = []
    if fm:
        seen = {}

        def rows_plain(ur, pr, nr, *a, **k):  # the composite rows the row math sees
            seen["rows"] = (ur, torch.cat([pr, nr]))
            return fp.pairwise_updates_rows_plain(ur, pr, nr, *a, **k)

        upd_u, iids, upd_i, deltas, lin_deltas, _ = fp._fm_meta_step_core(
            rows_plain, *tables, meta[0], lin, meta[1], meta[2], *ids, w, inv, 0.05, **rk)
        u, pn = seen["rows"]
    elif meta is not None:
        upd_u, iids, upd_i, deltas, _ = fp._meta_step_core(*tables, meta[0], meta[1], meta[2], *ids, w, inv, 0.05, **rk)
        iids_all = torch.cat([pid, nid])
        mids, mm = meta[1][iids_all], meta[2][iids_all].float()
        for f, table in enumerate(meta[0]):
            pn[:, :D] += (table[mids[:, f, :]][..., :D] * mm[:, f, :, None]).sum(1)
    else:
        iids, upd_u, upd_i, _ = fp._pairwise_updates(*tables, *ids, w, inv, 0.05, **rk)
        deltas = []
    b = uid.shape[0]
    kink = (hinge_kink_rows(torch, u, pn[:b], pn[b:], kw["sigmoid"], kw["bf16"])
            if kw["loss_kind"] == "hinge" else torch.zeros(b, dtype=torch.bool, device=DEVICE))
    kink_items = torch.cat([pid[kink], nid[kink]])
    parts = [("user", kt[0], pt[0], tables[0], uid, 128, upd_u, uid[kink]),
             ("item", kt[1], pt[1], tables[1], iids, 128, upd_i, kink_items)]
    nf = len(deltas)
    for f, (mid, delta) in enumerate(deltas):
        bad = meta[1][kink_items][:, f, :].reshape(-1)
        parts.append((f"meta{f}", kt[2 + f], pt[2 + f], meta[0][f], mid, D + 1, delta, bad))
    for f, (mid, delta) in enumerate(lin_deltas):
        bad = meta[1][kink_items][:, f, :].reshape(-1)
        parts.append((f"linear_meta{f}", kt[2 + nf + f], pt[2 + nf + f], lin[f], mid, 2, delta, bad))
    res = [step_compare(torch, f"{label} {name}", got, want, old, tid, width, upd, excluded, STEP_REL)
           for name, got, want, old, tid, width, upd, excluded in parts]
    return tuple(max(r[i] for r in res) for i in range(3)) + tuple(sum(r[i] for r in res) for i in (3, 4))


STEP_TRAP = """
import sys, torch
from torchrecsys_tpu_torch.ops import fused_pairwise as fp
u = torch.zeros((10, 128), device="cuda")
i = torch.zeros((20, 128), device="cuda")
ids = [torch.zeros(8, dtype=torch.int64, device="cuda") for _ in range(3)]
ids[0][5] = int(sys.argv[1])
fp.fused_pairwise_step(u, i, *ids, None, d=80, margin=1.0, loss_kind="hinge", sigmoid=False)
torch.cuda.synchronize()
print("no error")
"""


def step_trap_check(torch):
    """An out-of-range user id (10 and -1 of a 10-row table) must trap on
    the card. A trap leaves the CUDA context unusable, so each runs in a
    child process that must fail; an in-range id (9) must pass there."""

    root = os.path.dirname(os.path.abspath(__file__))
    for bad, want_fail in ((10, True), (-1, True), (9, False)):
        r = subprocess.run([sys.executable, "-c", STEP_TRAP, str(bad)], cwd=root, capture_output=True,
                           text=True, timeout=300)
        failed = r.returncode != 0
        check(failed == want_fail, f"step with user id {bad}: exit {r.returncode}, "
              f"{(r.stdout + r.stderr).strip()[-300:]}")
        why = (r.stderr.strip().splitlines() or ["?"])[-1][:120]
        log(f"[step-kernel] user id {bad} of 10 rows: " + (f"the step failed ({why})" if failed else "ran"))


def step_kernel_phase(torch):
    """Every step variant (3 losses x sigmoid x weights x bf16 x metadata)
    against the plain step on the card at B = 1024, 8192 and 1000, from
    the 100K-user / 1M-item packed tables, ids with forced duplicates,
    weighted variants with a tenth of zero weights; metadata at every (F,
    W) of STEP_META for B = 1024 and one each for the other B. Returns the
    largest |kernel - plain| over every table compared."""
    import itertools

    from torchrecsys_tpu_torch.ops import fused_pairwise as fp

    gen = torch.Generator(device=DEVICE).manual_seed(13)
    tables = (packed_table(torch, N_USERS, gen), packed_table(torch, N, gen))
    metas = {fw: step_meta(torch, *fw, gen) for fw in STEP_META}
    batches = {}
    for b in STEP_BATCHES:
        w = torch.rand((b,), generator=gen, device=DEVICE)
        w[-(b // 10):] = 0.0
        batches[b] = (step_ids(torch, b, gen), w)
    saved = (fp.fused_pairwise_step.launches, fp.fused_pairwise_step_meta.launches)
    saved_rows = fp.pairwise_updates_rows.launches
    worst, cases, worst_ratio, worst_need = 0.0, 0, 0.0, 0.0
    for vi, (loss, sig, use_w, bf16, meta) in enumerate(itertools.product(
        ("hinge", "bpr", "logistic"), (False, True), (False, True), (False, True), (False, True),
    )):
        kw = dict(d=D, margin=1.0, loss_kind=loss, sigmoid=sig, bf16=bf16)
        parts, dup_rows = [], 0
        for bi, b in enumerate(STEP_BATCHES):
            ids, w = batches[b]
            fws = (STEP_META if b == STEP_BATCHES[0] else (STEP_META[(vi + bi) % len(STEP_META)],)) if meta else (None,)
            for fw in fws:
                label = f"step {loss} sigmoid={sig:d} use_w={use_w:d} bf16={bf16:d} B={b}" + (
                    f" F={fw[0]} W={fw[1]}" if fw else "")
                before = (fp.fused_pairwise_step.launches, fp.fused_pairwise_step_meta.launches)
                err, ratio, need, dups, skipped = step_case(torch, fp, tables, ids, w if use_w else None, kw,
                                                            metas[fw] if fw else None, label)
                grew = (fp.fused_pairwise_step.launches - before[0], fp.fused_pairwise_step_meta.launches - before[1])
                check(grew == ((0, 1) if meta else (1, 0)), f"{label}: step launches grew by {grew}")
                worst = max(worst, err)
                dup_rows += dups
                cases += 1
                worst_ratio, worst_need = max(worst_ratio, ratio), max(worst_need, need)
                parts.append(f"B={b}" + (f" F={fw[0]} W={fw[1]}" if fw else "") + f" max|d|={err:.3g} "
                             f"d/tol={ratio:.3f} rel={need:.2g}" + (f" ({skipped} kink rows skipped)" if skipped else ""))
        log(f"[step-kernel] {loss:8s} sigmoid={sig:d} use_w={use_w:d} bf16={bf16:d} meta={meta:d}: "
            + ", ".join(parts) + f"; {dup_rows} table rows with duplicate ids over these cases")
    check(fp.pairwise_updates_rows.launches == saved_rows, "the step launched the row-level kernel")
    fp.fused_pairwise_step.launches, fp.fused_pairwise_step_meta.launches = saved  # comparisons do not count
    log(f"[step-kernel] {cases} step cases: kernel == plain step, largest |diff| {worst:.3g}, largest "
        f"|diff| / tolerance {worst_ratio:.3f}, largest share of a row's updates the paths differ by "
        f"{worst_need:.3g} (allowed: {STEP_REL:.0e})")
    step_trap_check(torch)
    return worst


# ---------------------------------------------------------------------------
# phase 4b: the in-batch softmax CE kernels against their plain version
# ---------------------------------------------------------------------------


def ce_inputs(torch, gen, b: int, d: int, n_ids: int, zero_from=None, spread: float = 1.0):
    """h, v ~ N(0, (0.5 spread)^2) (at spread 1 the logits spread over a few
    units; at 8 over hundreds, so most exponentials underflow and a row's
    running max moves often), vbq = item bias - logq[pos] with logq ~
    log(1/1M) + N(0, 0.5^2) (the main path's column shift), pos from
    ``n_ids`` ids, and the cotangent of a weighted mean: g = w / sum(w),
    w = 1 before row ``zero_from`` and 0 after."""
    h = torch.randn(b, d, generator=gen, device=DEVICE) * (0.5 * spread)
    v = torch.randn(b, d, generator=gen, device=DEVICE) * (0.5 * spread)
    pos = torch.randint(0, n_ids, (b,), generator=gen, device=DEVICE)
    logq = torch.randn(N, generator=gen, device=DEVICE) * 0.5 - float(np.log(N))
    vbq = torch.randn(b, generator=gen, device=DEVICE) * 0.1 - logq[pos % N]
    w = (torch.arange(b, device=DEVICE) < (b if zero_from is None else zero_from)).float()
    return h, v, vbq, pos, w / w.sum()


def ce_kernel_phase(torch):
    """The CE forward and backward kernels against their plain versions on
    the card. Returns {wrapper name: largest |kernel - plain| over all
    cases} and the main-path-shaped inputs (B=4096, D=80) for timing."""
    from torchrecsys_tpu_torch.ops import softmax_ce as sce

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    saved = (sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches)
    errs = {"softmax_ce_fwd": 0.0, "softmax_ce_bwd": 0.0}
    cases = (("B=4096 D=80 logq", SOFTMAX_B, D, N, None, 1.0),
             ("duplicate-heavy (10 ids)", SOFTMAX_B, D, 10, None, 1.0),
             ("ragged B=1000", 1000, D, N, None, 1.0), ("D=16", SOFTMAX_B, 16, N, None, 1.0),
             ("D=128", SOFTMAX_B, 128, N, None, 1.0), ("weights with zeros", SOFTMAX_B, D, N, 2900, 1.0),
             ("D=13 (no 16-byte rows)", 1000, 13, N, None, 1.0), ("B=7 (below one tile)", 7, D, 5, None, 1.0),
             ("D=84 (16-byte rows, not a multiple of 8)", SOFTMAX_B, 84, N, None, 1.0),
             ("B=4097 (one row past a tile)", SOFTMAX_B + 1, D, N, None, 1.0),
             ("spread logits (h, v x 8)", SOFTMAX_B, D, N, None, 8.0))
    main = None
    for label, b, d, n_ids, zero_from, spread in cases:
        h, v, vbq, pos, g = ce_inputs(torch, gen, b, d, n_ids, zero_from, spread)
        plse = ce_case(torch, sce, label, errs, (h, v, vbq, pos), g, spread == 1.0)
        if main is None:
            main = (h, v, vbq, pos, g, plse)
    # the rectangular call of a data-parallel shard: Br rows (the shard's
    # slice of a batch) against the Bc columns of the whole batch, the label
    # of row r in column r + off; ids from 50 values, so duplicates of a
    # row's positive sit on both sides of every shard boundary
    for br, bc, off in CE_RECT:
        h, v, vbq, pos, g = ce_inputs(torch, gen, bc, D, 50)
        rows = slice(off, off + br)
        ce_case(torch, sce, f"rectangular Br={br} Bc={bc} off={off}", errs,
                (h[rows].contiguous(), v, vbq, pos[rows].contiguous()), g[rows].contiguous(), True,
                rect=(pos, off))
    sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches = saved  # comparisons do not count
    return errs, main


CE_RECT = ((1024, 4096, 0), (1024, 4096, 3072), (1000, 4000, 3000), (1, 4096, 4095))


def ce_case(torch, sce, label, errs, args, g, backward: bool, rect=()):
    """One CE case, kernels against plain versions: loss/lse within
    rtol=atol=1e-5, dh/dv/dvb within rtol=1e-4 plus 1e-5 of the largest
    |reference| entry, a second run the same bits. ``rect`` = (pos_col,
    off) makes it the rectangular call. Returns the plain lse."""
    loss, lse = sce.softmax_ce_fwd(*args, *rect)
    loss2, lse2 = sce.softmax_ce_fwd(*args, *rect)
    ploss, plse = sce.softmax_ce_fwd_plain(*args, *rect)
    torch.cuda.synchronize()
    fwd_err = 0.0
    for name, x, y in (("loss", loss, ploss), ("lse", lse, plse)):
        check(bool(torch.isfinite(x).all()), f"CE {label}: non-finite {name}")
        diff = (x - y).abs()
        check(bool((diff <= 1e-5 + 1e-5 * y.abs()).all()),
              f"CE {label}: {name} differs from the plain version by {float(diff.max()):.3g}")
        fwd_err = max(fwd_err, float(diff.max()))
    check(torch.equal(loss, loss2) and torch.equal(lse, lse2), f"CE {label}: forward not deterministic")
    errs["softmax_ce_fwd"] = max(errs["softmax_ce_fwd"], fwd_err)
    if not backward:
        # a forward case: at logits of ~500 an f32 logit's own rounding
        # (~3e-5) moves a softmax probability by more than the backward
        # check's atol (1e-5 of the largest dh entry) allows, in any f32
        # implementation, the plain version included
        log(f"[ce-kernel] {label}: loss/lse max|d| {fwd_err:.3g}; repeated runs bit-identical "
            "(forward only)")
        return plse
    got = sce.softmax_ce_bwd(*args, plse, g, *rect)
    again = sce.softmax_ce_bwd(*args, plse, g, *rect)
    want = sce.softmax_ce_bwd_plain(*args, plse, g, *rect)
    bwd_err, parts = 0.0, []
    for name, x, y, z in zip(("dh", "dv", "dvb"), got, again, want):
        check(tuple(x.shape) == tuple(z.shape), f"CE {label}: {name} shape {tuple(x.shape)} != {tuple(z.shape)}")
        diff = (x - z).abs()
        scale = float(z.abs().max())
        check(bool((diff <= 1e-4 * z.abs() + 1e-5 * scale).all()),
              f"CE {label}: {name} differs from the plain version by {float(diff.max()):.3g} "
              f"(largest |reference| {scale:.3g})")
        check(torch.equal(x, y), f"CE {label}: {name} not deterministic")
        bwd_err = max(bwd_err, float(diff.max()))
        parts.append(f"{name} {float(diff.max()):.3g} of {scale:.3g}")
    errs["softmax_ce_bwd"] = max(errs["softmax_ce_bwd"], bwd_err)
    log(f"[ce-kernel] {label}: loss/lse max|d| {fwd_err:.3g}; backward max|d| " + ", ".join(parts)
        + "; repeated runs bit-identical")
    return plse


# ---------------------------------------------------------------------------
# phase 4c: the fused tower layer kernels against their plain versions
# ---------------------------------------------------------------------------


def tower_inputs(torch, gen, r: int, din: int, dout: int):
    """bf16 layer inputs at the scale of a trained tower: x ~ N(0, 1), w
    and b torch.nn.Linear-style, BN rows (mean, inv, scale, bias) near
    (0, 1, 1, 0); cotangents of a mean loss (dz ~ 1e-4, ds and dss ~ 1e-5)."""
    bf = torch.bfloat16
    x = torch.randn(r, din, generator=gen, device=DEVICE).to(bf)
    bound = 1.0 / din**0.5
    w = ((torch.rand(din, dout, generator=gen, device=DEVICE) * 2 - 1) * bound).to(bf)
    b = ((torch.rand(dout, generator=gen, device=DEVICE) * 2 - 1) * bound).to(bf)
    bn = torch.stack([torch.randn(din, generator=gen, device=DEVICE) * 0.3,
                      torch.rand(din, generator=gen, device=DEVICE) + 0.5,
                      1 + 0.1 * torch.randn(din, generator=gen, device=DEVICE),
                      0.1 * torch.randn(din, generator=gen, device=DEVICE)]).to(bf)
    dz = (torch.randn(r, dout, generator=gen, device=DEVICE) * 1e-4).to(bf)
    dstat = torch.randn(2, dout, generator=gen, device=DEVICE) * 1e-5
    return x, w, b, bn, dz, dstat


def tower_kernel_phase(torch):
    """The fused tower layer kernels against their plain versions on the
    card: both main-path layers (16,384 rows, 160 -> 1024 and 1024 -> 128
    with BN), a metadata model's first layer (Din = 240), a ragged R=1000,
    a tiny odd shape, widths that are not multiples of 8, R=40, Dout=1000
    (not a multiple of the column tile) and R=16383. Products and sums differ only in f32 order, so z
    and din, rounded to bf16, may move one bf16 ulp of their product (2^-7
    of the sum of the product's absolute terms, plus 2^-7 of the value).
    The f32 sums add bf16-exact terms in another order: s and ss within
    1e-5 of the sum of their absolute terms of an f64 sum of the kernel's
    own z (a z one ulp apart moves them by more than that), dW, db and the
    BN sums within 1e-5 of theirs of the plain version (the BN sums'
    terms bounded through |dz'| |W|^T, which also covers the one-ulp
    flips of bf16 dh that feed them). A row tile or a row range left out of a sum, or a BN sum without the
    ReLU mask, fails this check. A second run of each gives the same bits.
    Returns {wrapper: largest |kernel - plain|} and the main-path inputs."""
    from torchrecsys_tpu_torch.ops import fused_tower as ft

    gen = torch.Generator(device=DEVICE).manual_seed(12)
    saved = (ft.fused_tower_fwd.launches, ft.fused_tower_bwd.launches)
    errs = {"fused_tower_fwd": 0.0, "fused_tower_bwd": 0.0}
    cases = [(f"main layer {i}", *shape) for i, shape in enumerate(TOWER_LAYERS)]
    cases += [("Din=240 (one metadata feature)", 2 * MLP_B, 3 * D, MLP_HIDDEN[0], False),
              ("ragged R=1000", 1000, MLP_HIDDEN[0], MLP_HIDDEN[1], True),
              ("tiny 37 x 20 -> 13", 37, 20, 13, True),
              ("widths not multiples of 8", 1000, 100, 60, True),
              ("R=40 (below one wgmma tile)", 40, MLP_HIDDEN[0], MLP_HIDDEN[1], False),
              ("Dout=1000 (not a multiple of the column tile)", 2 * MLP_B, 2 * D, 1000, False),
              ("R=16383 (one row short of the main path)", 2 * MLP_B - 1, MLP_HIDDEN[0], MLP_HIDDEN[1], True)]
    main = []

    def within(name, label, got, want, slack):
        diff = (got.double() - want.double()).abs()
        check(bool((diff <= slack).all()), f"tower {label}: {name} differs from the plain version by "
              f"{float(diff.max()):.3g}")
        return float(diff.max())

    for label, r, din, dout, has_bn in cases:
        x, w, b, bn, dz, dstat = tower_inputs(torch, gen, r, din, dout)
        z, s, ss = ft.fused_tower_fwd(x, w, b, bn, has_bn)
        z2, s2, ss2 = ft.fused_tower_fwd(x, w, b, bn, has_bn)
        pz = ft.fused_tower_fwd_plain(x, w, b, bn, has_bn)[0]
        out = ft.fused_tower_bwd(x, pz, dz, w, bn, dstat, has_bn)
        again = ft.fused_tower_bwd(x, pz, dz, w, bn, dstat, has_bn)
        want = ft.fused_tower_bwd_plain(x, pz, dz, w, bn, dstat, has_bn)
        torch.cuda.synchronize()
        check(torch.equal(z, z2) and torch.equal(s, s2) and torch.equal(ss, ss2),
              f"tower {label}: forward not deterministic")
        check(all(torch.equal(a, c) for a, c in zip(out, again)), f"tower {label}: backward not deterministic")
        check(all(bool(torch.isfinite(t.float()).all()) for t in (z, s, ss) + out), f"tower {label}: non-finite")
        u, e32 = 2.0**-7, 1e-5
        h = (ft.bn_relu(x, bn)[0] if has_bn else x).float()
        wa = w.float().abs()
        zk, zsq = z.float(), (z * z).float()  # the kernel's own z and bf16(z * z)
        fwd = [within("z", label, z, pz, u * (h.abs() @ wa + pz.float().abs())),
               within("s", label, s, zk.double().sum(0), e32 * zk.abs().sum(0)),
               within("ss", label, ss, zsq.double().sum(0), e32 * zsq.sum(0))]
        dzp = (dz.float() + dstat[0] + 2.0 * pz.float() * dstat[1]).to(torch.bfloat16).float().abs()
        dh = dzp @ wa.T  # bounds |dh| and |dy|
        bnf = bn.float()
        f = (bnf[2] * bnf[1]).abs() if has_bn else torch.ones_like(bnf[0])
        bwd = [within("din", label, out[0], want[0], u * (dh * f + want[0].float().abs())),
               within("dw", label, out[1], want[1], e32 * (h.abs().T @ dzp)),
               within("db", label, out[2], want[2], e32 * dzp.sum(0))]
        if has_bn:
            xhat = ft.bn_relu(x, bn)[1].float().abs()
            terms = (dh * xhat, dh, dh * f, dh * (bnf[2] * (x.float() - bnf[0])).abs())
            bwd.append(within("dbn", label, out[3], want[3], e32 * torch.stack([t.sum(0) for t in terms])))
        errs["fused_tower_fwd"] = max(errs["fused_tower_fwd"], *fwd)
        errs["fused_tower_bwd"] = max(errs["fused_tower_bwd"], *bwd)
        flips = int((z != pz).sum())
        log(f"[tower-kernel] {label} ({r} x {din} -> {dout}, bn={has_bn}): z/s/ss max|d| "
            + "/".join(f"{e:.3g}" for e in fwd) + f" ({flips} of {z.numel()} z values one ulp apart); "
            f"din/dW/db{'/dbn' if has_bn else ''} max|d| " + "/".join(f"{e:.3g}" for e in bwd)
            + "; repeated runs bit-identical")
        if label.startswith("main"):
            main.append((x, w, b, bn, pz, dz, dstat, has_bn))
    ft.fused_tower_fwd.launches, ft.fused_tower_bwd.launches = saved  # comparisons do not count
    return errs, main


# ---------------------------------------------------------------------------
# phases 5-6: card against CPU, the main paths
# ---------------------------------------------------------------------------


def synthetic_interactions(seed: int = 0, n_items: int = 0):
    """Block-preference interactions (bench.py:98-110): user block b prefers
    item block b, 70% on-block. Every user and item occurs at least once so
    the catalog is exactly ``n_items`` items (0: N); category = item % 1000,
    static per item."""
    n_items = n_items or N
    r = np.random.default_rng(seed)
    n_rest = N_INTERACTIONS - n_items
    users = np.concatenate([r.integers(0, N_USERS, n_items), r.integers(0, N_USERS, n_rest)])
    users[: N_USERS] = np.arange(N_USERS)
    on_block = r.random(n_rest) < 0.7
    rand_items = r.integers(0, n_items, n_rest)
    block_items = ((rand_items // 8) * 8 + users[n_items:] % 8) % n_items
    items = np.concatenate([r.permutation(n_items), np.where(on_block, block_items, rand_items)])
    return {"user_id": users.astype(np.int64), "item_id": items.astype(np.int64), "category_id": items % 1000}


def seeded_tables(model, seed: int):
    """JAX-layout tables (padded rows, float32) from a numpy seed."""
    from torchrecsys_tpu_torch.models.base import padded_rows

    r = np.random.default_rng(seed)
    out = {}
    for name, spec in sorted(model.table_specs().items()):
        shape = (padded_rows(spec.rows), spec.dim)
        scale = 0.1 if spec.dim == 1 else 1.0 / spec.dim
        out[name] = r.standard_normal(shape, dtype=np.float32) * np.float32(scale)
    return out


def check_predict(rs, users_raw, got, top_k, exclude_seen, torch):
    """predict's raw ids against the plain path: each returned item must
    score what the plain top-k has at that rank (f64 recompute)."""
    from torchrecsys_tpu_torch.ops.dot_topk import dot_topk_plain, pack_seen_mask

    check(got.shape == (len(users_raw), top_k), f"predict shape {got.shape}")
    rows = torch.as_tensor([rs.store.user_encoder.encode_one(u) for u in users_raw], device=rs.device)
    q, ib, user_fn, transform = rs.model.linearized_catalog(rs._params(), rs.feat)
    uv, const = user_fn(rs._params(), rows)
    mask = None
    seen = None
    if exclude_seen:
        seen = rs._seen(rows.cpu().numpy())
        mask = torch.as_tensor(pack_seen_mask(seen, q.shape[0]), device=rs.device)
    pv, _ = dot_topk_plain(uv, q, ib, top_k, seen_mask=mask)
    enc = rs.store.item_encoder
    item_rows = torch.as_tensor([[enc.encode_one(x) for x in row] for row in got], device=rs.device)
    true = (uv.double()[:, None, :] * q.double()[item_rows]).sum(-1) + ib.double()[item_rows]
    check(bool(((true - pv.double()).abs() <= ATOL + RTOL * pv.double().abs()).all()), "predict disagrees with the plain path")
    if seen is not None:
        for r, s in enumerate(seen):
            check(not set(item_rows[r].tolist()) & set(s.tolist()), "exclude_seen returned a seen item")


def small_catalog_check(torch):
    """A small catalog served on the card and on the CPU from the same
    integer-valued tables (exact arithmetic): identical raw ids."""
    from torchrecsys_tpu_torch import RecSys

    r = np.random.default_rng(5)
    data = {"user_id": r.integers(0, 300, 20000), "item_id": r.integers(0, 5000, 20000)}
    data["category_id"] = data["item_id"] % 17
    rss = [RecSys(data, metadata_id_col=["category_id"], device=d) for d in (DEVICE, "cpu")]
    tables = {k: np.rint(v * 40).astype(np.float32) for k, v in seeded_tables(rss[0].model, 9).items()}
    for rs in rss:
        rs.load_jax_tables(tables)
    users = rss[0].store.user_encoder.to_list()[:64]
    for top_k, excl in ((10, False), (128, False), (10, True), (1500, False)):
        a, b = (rs.predict(users, top_k=top_k, exclude_seen=excl) for rs in rss)
        check(np.array_equal(a, b), f"small catalog top_k={top_k} exclude_seen={excl}: card != CPU")
    log("[main] small catalog: card == CPU at top_k 10/128/1500 and exclude_seen")


def wrappers():
    """Every kernel wrapper of the port (each counts its launches)."""
    from torchrecsys_tpu_torch.ops import dot_topk as dt
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp
    from torchrecsys_tpu_torch.ops import fused_tower as ft
    from torchrecsys_tpu_torch.ops import softmax_ce as sce

    return (dt.dot_topk_small, dt.dot_topk_large, fp.pairwise_updates_rows, fp.fused_pairwise_step,
            fp.fused_pairwise_step_meta, sce.softmax_ce_fwd, sce.softmax_ce_bwd, ft.fused_tower_fwd,
            ft.fused_tower_bwd)


def small_train_check(torch):
    """A small dataset trained two epochs on the card and on the CPU (plain
    steps), from one start with the same round keys and static negatives:
    Linear and FM, each with and without metadata (every step through the
    step kernel; FM with metadata through the row-level kernel)."""
    from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
    from torchrecsys_tpu_torch.data import prepare_data
    from torchrecsys_tpu_torch.models import build_model
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp
    from torchrecsys_tpu_torch.train import Trainer

    r = np.random.default_rng(6)
    data = {"user_id": r.integers(0, 300, 20000), "item_id": r.integers(0, 5000, 20000)}
    data["category_id"] = data["item_id"] % 17
    saved = step_launches(fp)
    for net, meta in (("linear", False), ("linear", True), ("fm", False), ("fm", True)):
        store = prepare_data(data, "user_id", "item_id", metadata_id_col=["category_id"] if meta else None)
        cfg = TrainConfig(batch_size=1000, learning_rate=0.05)
        out = {}
        for dev in ("cpu", DEVICE):
            tr = Trainer(build_model(store.schema, ModelConfig(net_type=net, n_factors=D)), cfg, dev)
            state = tr.init_state()
            if dev == "cpu":
                start = {k: v.clone() for k, v in state["tables"].items()}
            state["tables"] = {k: v.to(dev) for k, v in start.items()}
            data_d, feat = tr._device_train_data(store), tr.feature_tables(store)
            losses = []
            for e in range(2):
                keys = torch.arange(6, device=dev) + 7 * e
                state, loss = tr.train_epoch(state, data_d, feat, keys=keys)
                losses.append(float(loss))
            out[dev] = (np.asarray(losses), {k: v.cpu() for k, v in state["tables"].items()})
        (lc, tc), (lg, tg) = out["cpu"], out[DEVICE]
        check(np.allclose(lg, lc, rtol=1e-4, atol=1e-5), f"small train {net} meta={meta}: losses {lg} != CPU {lc}")
        err = 0.0
        for k in tc:
            check(torch.allclose(tg[k], tc[k], rtol=1e-4, atol=1e-5), f"small train {net} meta={meta}: table {k}")
            err = max(err, float((tg[k] - tc[k]).abs().max()))
        log(f"[main] small train {net} metadata={meta}: card == CPU over 2 epochs (losses "
            f"{lg.round(6).tolist()}, max |table diff| {err:.3g})")
    set_step_launches(fp, saved)


def small_softmax_check(torch):
    """A small dataset trained two epochs with sampled softmax on the card
    (both CE kernels every step) and on the CPU (plain versions), from one
    start with the same round keys; then evaluate(loss, auc) on both with
    the same negatives. It runs under torch's deterministic algorithms:
    index_add_ on the card otherwise adds duplicate ids' rows in no fixed
    order, and two epochs of that can move one item bias of the metadata
    model past the tolerance; in a fixed order it stays inside it."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _small_softmax_check(torch)
    finally:
        torch.use_deterministic_algorithms(False)


def _small_softmax_check(torch):
    from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
    from torchrecsys_tpu_torch.data import prepare_data
    from torchrecsys_tpu_torch.models import build_model
    from torchrecsys_tpu_torch.ops import softmax_ce as sce
    from torchrecsys_tpu_torch.train import Trainer

    r = np.random.default_rng(7)
    data = {"user_id": r.integers(0, 300, 20000), "item_id": r.integers(0, 5000, 20000)}
    data["category_id"] = data["item_id"] % 17
    saved = (sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches)
    for meta in (False, True):
        store = prepare_data(data, "user_id", "item_id", metadata_id_col=["category_id"] if meta else None)
        cfg = TrainConfig(loss="sampled_softmax", batch_size=1000, learning_rate=0.05)
        negs = r.integers(0, store.schema.num_items, store.num_test)
        out = {}
        for dev in ("cpu", DEVICE):
            tr = Trainer(build_model(store.schema, ModelConfig(n_factors=D)), cfg, dev)
            state = tr.init_state()
            if dev == "cpu":
                start = {k: v.clone() for k, v in state["tables"].items()}
            state["tables"] = {k: v.to(dev) for k, v in start.items()}
            data_d, feat = tr._device_train_data(store), tr.feature_tables(store)
            losses = []
            for e in range(2):
                keys = torch.arange(6, device=dev) + 7 * e
                state, loss = tr.train_epoch(state, data_d, feat, keys=keys)
                losses.append(float(loss))
            ev = tr.evaluate(state, store, batch_size=1000, verbose=False, negatives=negs)
            out[dev] = (np.asarray(losses), {k: v.cpu() for k, v in state["tables"].items()}, ev)
        (lc, tc, ec), (lg, tg, eg) = out["cpu"], out[DEVICE]
        check(np.allclose(lg, lc, rtol=1e-4, atol=1e-5), f"small softmax meta={meta}: losses {lg} != CPU {lc}")
        err = 0.0
        for k in tc:
            check(torch.allclose(tg[k], tc[k], rtol=1e-4, atol=1e-5), f"small softmax meta={meta}: table {k}")
            err = max(err, float((tg[k] - tc[k]).abs().max()))
        check(abs(eg["loss"] - ec["loss"]) <= 1e-5 + 1e-4 * abs(ec["loss"]) and
              abs(eg["auc"] - ec["auc"]) <= 2.0 / store.num_test,
              f"small softmax meta={meta}: evaluate {eg} != CPU {ec}")
        log(f"[main] small softmax metadata={meta}: card == CPU over 2 epochs (losses "
            f"{lg.round(6).tolist()}, max |table diff| {err:.3g}); evaluate card {eg} vs CPU {ec}")
    sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches = saved


def small_mlp_check(torch):
    """A small dataset with one category column trained two epochs with the
    AMP MLP on the card (kernels #6 and #7 for every layer of every step),
    on the CPU (their plain versions) and, as the noise floor, on the CPU in
    f32 compute, from one start with the same round keys and static
    negatives. Losses within rtol=0.08 (the JAX package's fused-against-XLA
    fit tolerance, tests/test_fused_tower.py:148); each table's and weight's
    change on the card within the noise-floor rule of that file (:83-119)
    of the CPU's: distance below max(1.5 x the CPU's bf16-to-f32 distance,
    0.02) (bf16 values one ulp apart flip hinge and ReLU edges, and
    adagrad's per-row normalisation turns a flipped row into a full step);
    then evaluate(loss, auc) with the same negatives (loss rtol=0.08, AUC
    within 0.02)."""
    import dataclasses

    from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
    from torchrecsys_tpu_torch.data import prepare_data
    from torchrecsys_tpu_torch.models import build_model
    from torchrecsys_tpu_torch.ops import fused_tower as ft
    from torchrecsys_tpu_torch.train import Trainer
    from torchrecsys_tpu_torch.train.optim import init_dense_opt, tree_map

    r = np.random.default_rng(13)
    data = {"user_id": r.integers(0, 300, 20000), "item_id": r.integers(0, 5000, 20000)}
    data["category_id"] = data["item_id"] % 17
    store = prepare_data(data, "user_id", "item_id", metadata_id_col=["category_id"])
    cfg = TrainConfig(batch_size=1000, learning_rate=0.05)
    mcfg = ModelConfig(net_type="mlp", n_factors=D, hidden_layers=(256, 64), compute_dtype="bfloat16")
    negs = r.integers(0, store.schema.num_items, store.num_test)
    saved = (ft.fused_tower_fwd.launches, ft.fused_tower_bwd.launches)
    out = {}
    for label, dev, mc in (("cpu", "cpu", mcfg), ("card", DEVICE, mcfg),
                           ("f32", "cpu", dataclasses.replace(mcfg, compute_dtype="float32"))):
        tr = Trainer(build_model(store.schema, mc), cfg, dev)
        state = tr.init_state()
        if label == "cpu":
            start = dict(state["tables"], **{f"dense.{k}": v for k, v in flat_dense(state["dense"]).items()})
            start_dense = state["dense"]
        state["tables"] = {k: start[k].to(dev) for k in state["tables"]}
        state["dense"] = tree_map(lambda t: t.to(dev), start_dense)
        state["dense_opt"] = init_dense_opt(cfg.dense_optimizer, state["dense"])
        data_d, feat = tr._device_train_data(store), tr.feature_tables(store)
        before = ft.fused_tower_fwd.launches, ft.fused_tower_bwd.launches
        losses = []
        for e in range(2):
            keys = torch.arange(6, device=dev) + 7 * e
            state, loss = tr.train_epoch(state, data_d, feat, keys=keys)
            losses.append(float(loss))
        if label == "card":
            want = 2 * len(mcfg.hidden_layers) * -(-store.num_train // cfg.batch_size)
            got = (ft.fused_tower_fwd.launches - before[0], ft.fused_tower_bwd.launches - before[1])
            check(got == (want, want), f"small MLP: tower kernels launched {got}, want {want} each")
        ev = tr.evaluate(state, store, batch_size=1000, verbose=False, negatives=negs)
        leaves = dict(state["tables"], **{f"dense.{k}": v for k, v in flat_dense(state["dense"]).items()})
        out[label] = (np.asarray(losses), {k: v.float().cpu() for k, v in leaves.items()}, ev)
    (lc, tc, ec), (lg, tg, eg), (_, tf, _) = out["cpu"], out["card"], out["f32"]
    check(np.allclose(lg, lc, rtol=0.08), f"small MLP: losses {lg} != CPU {lc}")
    worst = (0.0, 0.0, "")
    for name, s0 in start.items():
        if name.endswith(".b"):  # gradient 0 up to rounding (see compare_mlp_steps)
            continue
        dg, dc, df = (t[name] - s0.float() for t in (tg, tc, tf))
        dist = float((dg - dc).norm() / dc.norm().clamp_min(1e-30))
        floor = float((dc - df).norm() / df.norm().clamp_min(1e-30))
        check(dist < max(1.5 * floor, 0.02), f"small MLP: {name} card vs CPU {dist:.3g}, floor {floor:.3g}")
        worst = max(worst, (dist, floor, name))
    check(abs(eg["loss"] - ec["loss"]) <= 0.08 * abs(ec["loss"]) and abs(eg["auc"] - ec["auc"]) <= 0.02,
          f"small MLP: evaluate {eg} != CPU {ec}")
    log(f"[main] small MLP (AMP, 240 -> 256 -> 64, metadata): card vs CPU over 2 epochs, losses "
        f"{lg.round(6).tolist()} vs {lc.round(6).tolist()}; largest relative change distance "
        f"{worst[0]:.3g} ({worst[2]}; bf16-to-f32 floor {worst[1]:.3g}); evaluate card {eg} vs CPU {ec}")
    ft.fused_tower_fwd.launches, ft.fused_tower_bwd.launches = saved


def sample_loss(torch, rs, sample) -> float:
    """Mean hinge loss of the installed tables on a fixed sample of train
    pairs (the model's own score, plain torch)."""
    from torchrecsys_tpu_torch.data.features import attach_features

    users, pos, neg = (torch.as_tensor(x, device=rs.device) for x in sample)
    scores = []
    for items in (pos, neg):
        side = attach_features({"user_id": users, "item_id": items}, rs.feat)
        scores.append(rs.model.score(rs._params(), {}, side)[0])
    return float(torch.clamp_min(scores[1] - scores[0] + 1.0, 0.0).mean())


def step_launches(fp):
    return fp.fused_pairwise_step.launches, fp.fused_pairwise_step_meta.launches, fp.pairwise_updates_rows.launches


def set_step_launches(fp, saved):
    fp.fused_pairwise_step.launches, fp.fused_pairwise_step_meta.launches, fp.pairwise_updates_rows.launches = saved


def compare_steps(torch, rs, steps: int = 20):
    """From the installed state and one epoch's batches, ``steps`` steps
    with the kernel and with the plain version on the card (FM with
    metadata: the row-level kernel against its plain version, the same
    torch glue around both). Returns (max |table diff|, rows beyond
    tolerance per table)."""
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp

    tr = rs.trainer
    data, feat = tr._device_train_data(rs.store), tr.feature_tables(rs.store)
    epoch = tr.build_epoch(data, torch.arange(6, device=DEVICE) * 11 + 5,
                           torch.Generator(device=DEVICE).manual_seed(21), feat)
    saved = step_launches(fp)
    plain = fp.fused_pairwise_step_meta_plain if rs.model.schema.metadata_names else fp.fused_pairwise_step_plain
    runs = []
    for step in (None, plain):
        packed = tr.pack_state(rs.state)
        losses = tr.run_steps(packed, epoch, feat, steps=range(steps), step_fn=step)
        runs.append((losses, packed))
    torch.cuda.synchronize()
    set_step_launches(fp, saved)  # comparisons do not count
    (lk, pk), (lp, pp) = runs
    check(bool(torch.allclose(lk, lp, rtol=1e-5, atol=1e-6)), f"step losses {lk} != plain {lp}")
    worst, bad_rows = 0.0, {}
    for name in pk:
        diff = (pk[name] - pp[name]).abs()
        bad = diff > 1e-5 + 1e-4 * pp[name].abs()
        bad_rows[name] = int(bad.any(dim=1).sum())
        check(bad_rows[name] <= 8, f"{steps} steps: {bad_rows[name]} rows of {name} differ from the "
              f"plain path by up to {float(diff.max()):.3g}")
        worst = max(worst, float(diff.max()))
    return worst, bad_rows


def compare_steps_amp(torch, rs, steps: int = 20):
    """``steps`` AMP steps from one epoch's batches, each held against the
    plain bf16 step from the same pre-step tables by the step phase's rule
    (step_case: every table by step_compare at STEP_REL, hinge-kink rows
    excluded, the loss within 1e-6 + 1e-5 |x|); the kernel's step then
    carries the tables to the next. Returns (max |diff|, largest diff /
    tolerance, largest rel needed, rows with duplicates, excluded rows)."""
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp

    tr = rs.trainer
    data, feat = tr._device_train_data(rs.store), tr.feature_tables(rs.store)
    epoch = tr.build_epoch(data, torch.arange(6, device=DEVICE) * 11 + 5,
                           torch.Generator(device=DEVICE).manual_seed(21))
    saved = step_launches(fp)
    packed = tr.pack_state(rs.state)
    names = rs.model.schema.metadata_names
    meta = ([packed[f"meta_{nm}"] for nm in names], feat["meta_ids"], feat["meta_mask"]) if names else None
    lin = [packed[f"linear_meta_{nm}"] for nm in names] if names and rs.model.pairwise_fm_fields else None
    kw = dict(d=D, margin=tr.cfg.margin, loss_kind=tr.cfg.loss, sigmoid=rs.model.pairwise_sigmoid, bf16=True)
    bt, res = epoch.batches, []
    for i in range(steps):
        ids = tuple(bt[k][i].contiguous() for k in ("user_id", "pos_item_id", "neg_item_id"))
        w = bt["_w"][i] if "_w" in bt else None
        res.append(step_case(torch, fp, (packed["user"], packed["item"]), ids, w, kw, meta, f"AMP step {i}",
                             lin))
        tr.run_steps(packed, epoch, feat, steps=[i])
    torch.cuda.synchronize()
    set_step_launches(fp, saved)  # comparisons do not count
    return tuple(max(r[i] for r in res) for i in range(3)) + tuple(sum(r[i] for r in res) for i in (3, 4))


def hinge_evaluate(torch, rs, fresh_eval, label, learns: bool):
    """evaluate(loss, auc, recall@10) of a pairwise model: the loss and AUC
    on the model's scores (no kernel), recall@10 through the top-k kernel
    (#1) and nothing else; with fixed negatives, the loss and AUC against a
    direct recomputation. ``learns``: the AUC above the fresh tables'. A
    model without metadata does not generalize on this data (each item
    occurs ~3 times), so its test AUC is only printed beside the fresh
    tables' (its train sample loss must fall, train_path)."""
    ws = wrappers()
    for w in ws:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = rs.evaluate(batch_size=SOFTMAX_B, eval_metrics=("loss", "auc", "recall@10"), verbose=False)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in ws}
    check(counts["dot_topk_small"] > 0 and sum(counts.values()) == counts["dot_topk_small"],
          f"{label}: evaluate launched {counts}; want the top-k kernel (recall@10) only")
    check(np.isfinite(ev["loss"]) and (ev["auc"] > fresh_eval["auc"] or not learns),
          f"{label}: evaluate {ev} vs the fresh tables' {fresh_eval}")
    direct = check_evaluate_direct(torch, rs, SOFTMAX_B, label)
    log(f"[main] evaluate {label}: {ev} in {eval_s:.3f} s ({rs.store.num_test} test rows, batch {SOFTMAX_B}; "
        f"fresh tables {fresh_eval}); launches {counts}; with fixed negatives {direct}")
    return ev, counts


def path_label(net: str, amp: bool, rest: str) -> str:
    """A main path's label in the log: the f32 Linear paths keep their bare
    labels."""
    if net == "linear" and not amp:
        return rest
    return f"{'FM' if net == 'fm' else net.capitalize()}{' AMP' if amp else ''} {rest}"


def train_path(torch, data, meta: bool, net: str = "linear", amp: bool = False, evaluate: bool = False):
    """The training main path: RecSys(net_type=net, use_amp=amp) ->
    JAX-layout state -> fit (one epoch, batch 1024). Linear, and FM
    without metadata: one step-kernel call per step (FM's sigmoid variant;
    AMP's bf16 variants) and no other kernel; FM with metadata: one
    row-level launch per step and no step-kernel call. The variant index
    the wrapper passed is checked. Launch counts are zeroed just before
    fit and read just after. With ``evaluate``, evaluate(loss, auc,
    recall@10) before and after the fit."""
    from torchrecsys_tpu_torch import RecSys
    from torchrecsys_tpu_torch.config import TrainConfig
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp
    from torchrecsys_tpu_torch.train import Trainer

    label = path_label(net, amp, "metadata" if meta else "no metadata")
    t0 = time.perf_counter()
    cols = data if meta else {k: data[k] for k in ("user_id", "item_id")}
    rs = RecSys(cols, metadata_id_col=["category_id"] if meta else None, n_factors=D, net_type=net,
                use_amp=amp, device=DEVICE, dynamic_neg_sampling=meta)
    t1 = time.perf_counter()
    tables = seeded_tables(rs.model, seed=1)
    emb_opt = {k: {"acc": np.zeros(v.shape[0], np.float32)} for k, v in tables.items()}
    rs.load_jax_tables(tables, emb_opt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(rs.config["num_items"] == N and rs.config["num_users"] == N_USERS, f"config {rs.config}")
    st = rs.store
    r = np.random.default_rng(8)
    rows = r.choice(st.num_train, min(65536, st.num_train), replace=False)
    negs = st.train_neg_items[rows] if st.train_neg_items is not None else r.integers(0, N, rows.size)
    sample = (st.train_users[rows], st.train_items[rows], negs)
    fresh = sample_loss(torch, rs, sample)
    fresh_eval = None
    if evaluate:
        fresh_eval = Trainer(rs.model, TrainConfig(seed=rs.seed, dynamic_neg_sampling=meta), DEVICE).evaluate(
            rs.state, st, batch_size=SOFTMAX_B, verbose=False)
    log(f"[train] {label}: RecSys ingest {t1 - t0:.2f} s, state carry-over {t2 - t1:.2f} s; "
        f"{st.num_train} train rows; fresh-start sample loss {fresh:.5f}"
        + (f", evaluate {fresh_eval}" if evaluate else ""))
    ws = wrappers()
    for w in ws:
        w.launches = 0
    fp.fused_pairwise_step.variant = fp.fused_pairwise_step_meta.variant = fp.pairwise_updates_rows.variant = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = rs.fit(epochs=1, batch_size=TRAIN_B, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in ws}
    steps = -(-st.num_train // TRAIN_B)
    fm_meta = net == "fm" and meta
    step = "pairwise_updates_rows" if fm_meta else "fused_pairwise_step_meta" if meta else "fused_pairwise_step"
    check(counts[step] == steps, f"{label}: fit ran {steps} steps but {step} launched {counts[step]} times")
    check(sum(counts.values()) == steps, f"{label}: fit launched other kernels: {counts}")
    # every batch is weighted (the epoch has a remainder batch); the FM sigmoid; AMP's bf16
    if fm_meta:  # the row-level kernel with emit_g and no item rows
        variant = fp.pairwise_updates_rows.variant
        want = fp.row_variant("hinge", True, True, True, False, amp)
    else:
        variant = getattr(fp, step).variant
        want = fp.step_variant("hinge", net == "fm", True, amp, meta)
    check(variant == want, f"{label}: {step} ran variant {variant}, want {want} (bf16={amp:d})")
    check(len(losses) == 1 and np.isfinite(losses[0]), f"{label}: epoch loss {losses} is not finite")
    trained = sample_loss(torch, rs, sample)
    check(trained < fresh, f"{label}: the trained tables' sample loss {trained} is not below the fresh "
          f"start's {fresh}")
    rate = st.num_train / fit_s
    log(f"[train] {label}: fit {steps} steps of {TRAIN_B} in {fit_s:.3f} s = {rate:.1f} examples/s; "
        f"epoch loss {losses[0]:.5f}, sample loss {fresh:.5f} -> {trained:.5f}; launches {counts}; "
        f"{step} variant {variant}")
    out = {"launches": counts[step], "row_launches": counts["pairwise_updates_rows"], "steps": steps,
           "fit_s": fit_s, "examples_per_s": rate, "epoch_loss": losses[0], "fresh_loss": fresh,
           "trained_loss": trained, "variant": variant, "label": label}
    if amp:
        err, ratio, need, dups, kinks = compare_steps_amp(torch, rs)
        log(f"[train] {label}: 20 steps, each kernel vs the plain bf16 step from the same tables on the "
            f"card: max |diff| {err:.3g}, largest diff / tolerance {ratio:.3f}, largest share of a row's "
            f"updates {need:.3g} (allowed {STEP_REL:.0e}); {dups} rows with duplicate ids, {kinks} "
            f"hinge-kink rows skipped")
    else:
        err, bad = compare_steps(torch, rs)
        log(f"[train] {label}: 20 steps kernel vs plain on the card: max |table diff| {err:.3g}, "
            f"rows beyond rtol=1e-4/atol=1e-5 {bad}")
    out["step_err"] = err
    if evaluate:
        ev, counts = hinge_evaluate(torch, rs, fresh_eval, label, learns=meta)
        out.update(auc=ev["auc"], fresh_auc=fresh_eval["auc"], eval_launches=counts["dot_topk_small"])
    return rs, out


def ce_sample_loss(torch, rs, batches, logq) -> float:
    """Mean in-batch CE (logQ-corrected, the plain formulation) of the
    installed tables over fixed batches of train rows."""
    from torchrecsys_tpu_torch.data.features import attach_features
    from torchrecsys_tpu_torch.ops.softmax_ce import inbatch_softmax_rows_plain

    st = rs.store
    total = 0.0
    for rows in batches:
        u, p = (torch.as_tensor(x[rows], device=rs.device).long() for x in (st.train_users, st.train_items))
        side = attach_features({"user_id": u, "item_id": p}, rs.feat)
        h, v, vb, _ = rs.model.pair_vectors({}, {}, rs.model.gather_rows(rs.state["tables"], side), side,
                                            train=False)
        total += float(inbatch_softmax_rows_plain(h, v, vb, p, logq).mean())
    return total / len(batches)


def compare_softmax_steps(torch, rs, steps: int = 10):
    """From the installed state and one epoch's batches, ``steps`` softmax
    steps with the CE kernels and with their plain versions on the card.
    Returns (max |table diff|, rows beyond rtol=1e-4/atol=1e-5 per table)."""
    from torchrecsys_tpu_torch.ops import softmax_ce as sce
    from torchrecsys_tpu_torch.train.optim import augment_tables

    tr = rs.trainer
    data, feat = tr._device_train_data(rs.store), tr.feature_tables(rs.store)
    epoch = tr.build_epoch(data, torch.arange(6, device=DEVICE) * 13 + 2,
                           torch.Generator(device=DEVICE).manual_seed(22))
    saved = (sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches)
    runs = []
    for fns in (None, (sce.softmax_ce_fwd_plain, sce.softmax_ce_bwd_plain)):
        aug = augment_tables(rs.state["tables"], rs.state["emb_opt"])
        losses = tr.run_softmax_steps(rs.state, aug, epoch, feat, steps=range(steps), ce_fns=fns)
        runs.append((losses, aug))
    torch.cuda.synchronize()
    sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches = saved  # comparisons do not count
    (lk, ak), (lp, ap) = runs
    check(bool(torch.allclose(lk, lp, rtol=1e-5, atol=1e-5)), f"softmax step losses {lk} != plain {lp}")
    worst, bad_rows = 0.0, {}
    for name in ak:
        diff = (ak[name] - ap[name]).abs()
        bad_rows[name] = int((diff > 1e-5 + 1e-4 * ap[name].abs()).any(dim=1).sum())
        check(bad_rows[name] == 0, f"{steps} softmax steps: {bad_rows[name]} rows of {name} differ from "
              f"the plain path by up to {float(diff.max()):.3g}")
        worst = max(worst, float(diff.max()))
    return worst, bad_rows


def compare_softmax_steps_amp(torch, rs, steps: int = 10):
    """``steps`` AMP softmax steps from one epoch's batches, each with the
    CE kernels and with their plain versions from the same pre-step
    tables; the kernels' step then carries the tables to the next. The
    gradients come back in bf16, and the paths' f32 CE results differ by
    f32 rounding, so now and then an element rounds to the other bf16
    neighbour (one ulp, at most 2^-7 of it): each table's change is held by
    ||kernels - plain|| <= 2^-8 ||plain|| (a dropped row of a 4096-row
    batch or a 1% mis-scale is ~4x that), the loss within 1e-5. Returns the
    largest relative distance per table."""
    from torchrecsys_tpu_torch.ops import softmax_ce as sce
    from torchrecsys_tpu_torch.train.optim import augment_tables

    tr = rs.trainer
    data, feat = tr._device_train_data(rs.store), tr.feature_tables(rs.store)
    epoch = tr.build_epoch(data, torch.arange(6, device=DEVICE) * 13 + 2,
                           torch.Generator(device=DEVICE).manual_seed(22))
    saved = (sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches)
    aug = augment_tables(rs.state["tables"], rs.state["emb_opt"])
    dists = {name: 0.0 for name in aug}
    for i in range(steps):
        runs = []
        for fns in (None, (sce.softmax_ce_fwd_plain, sce.softmax_ce_bwd_plain)):
            a = {k: v.clone() for k, v in aug.items()}
            runs.append((tr.run_softmax_steps(rs.state, a, epoch, feat, steps=[i], ce_fns=fns), a))
        (lk, ak), (lp, ap) = runs
        check(bool(torch.allclose(lk, lp, rtol=1e-5, atol=1e-5)), f"AMP softmax step {i}: loss {lk} != plain {lp}")
        for name, old in aug.items():
            dk, dp = ak[name] - old, ap[name] - old
            dist = float((dk - dp).norm() / dp.norm().clamp_min(1e-30)) if bool(dp.any()) else float(dk.norm())
            check(dist <= 2.0**-8, f"AMP softmax step {i}: {name} kernels vs plain distance {dist:.3g} > 2^-8")
            dists[name] = max(dists[name], dist)
        aug = ak
    torch.cuda.synchronize()
    sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches = saved  # comparisons do not count
    return dists


def softmax_train_path(torch, data, meta: bool, evaluate: bool, net: str = "linear", amp: bool = False):
    """The sampled-softmax main path: RecSys(net_type=net, use_amp=amp,
    fm_sigmoid=False) -> seeded JAX-layout tables -> fit(epochs=1,
    batch_size=4096, loss="sampled_softmax") and, with ``evaluate``,
    RecSys.evaluate(loss, auc, recall@10). Launch counts are zeroed just
    before each call and read just after."""
    from torchrecsys_tpu_torch import RecSys
    from torchrecsys_tpu_torch.config import TrainConfig
    from torchrecsys_tpu_torch.ops import softmax_ce as sce
    from torchrecsys_tpu_torch.train import Trainer

    label = path_label(net, amp, "softmax " + ("metadata" if meta else "no metadata"))
    cols = data if meta else {k: data[k] for k in ("user_id", "item_id")}
    rs = RecSys(cols, metadata_id_col=["category_id"] if meta else None, n_factors=D, net_type=net,
                use_amp=amp, fm_sigmoid=False, device=DEVICE, dynamic_neg_sampling=True)
    tables = seeded_tables(rs.model, seed=2)
    rs.load_jax_tables(tables, {k: {"acc": np.zeros(v.shape[0], np.float32)} for k, v in tables.items()})
    st = rs.store
    fresh_tr = Trainer(rs.model, TrainConfig(loss="sampled_softmax", batch_size=SOFTMAX_B, seed=rs.seed,
                                             dynamic_neg_sampling=True), DEVICE)
    logq = fresh_tr._logq_from(st.train_items)
    r = np.random.default_rng(10)
    batches = [r.choice(st.num_train, SOFTMAX_B, replace=False) for _ in range(16)]
    fresh = ce_sample_loss(torch, rs, batches, logq)
    fresh_eval = fresh_tr.evaluate(rs.state, st, batch_size=SOFTMAX_B, verbose=False) if evaluate else None
    ws = wrappers()
    for w in ws:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = rs.fit(epochs=1, batch_size=SOFTMAX_B, loss="sampled_softmax", verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in ws}
    steps = -(-st.num_train // SOFTMAX_B)
    check(counts["softmax_ce_fwd"] == counts["softmax_ce_bwd"] == steps,
          f"{label}: fit ran {steps} steps but the CE kernels launched {counts}")
    check(sum(counts.values()) == 2 * steps, f"{label}: fit launched other kernels: {counts}")
    check(len(losses) == 1 and np.isfinite(losses[0]), f"{label}: epoch loss {losses} is not finite")
    trained = ce_sample_loss(torch, rs, batches, logq)
    check(trained < fresh, f"{label}: the trained tables' CE {trained} is not below the fresh start's {fresh}")
    rate = st.num_train / fit_s
    log(f"[train] {label}: fit {steps} steps of {SOFTMAX_B} in {fit_s:.3f} s = {rate:.1f} examples/s; "
        f"epoch loss {losses[0]:.5f}, CE of 16 fixed train batches {fresh:.5f} -> {trained:.5f}; "
        f"launches {counts}")
    if amp:
        dists = compare_softmax_steps_amp(torch, rs)
        log(f"[train] {label}: 10 steps, each with the CE kernels vs the plain CE from the same tables on "
            f"the card: largest relative distance of the change per table (allowed 2^-8 = {2.0**-8:.4g}) "
            + ", ".join(f"{k} {v:.3g}" for k, v in dists.items()))
    else:
        err, bad = compare_softmax_steps(torch, rs)
        log(f"[train] {label}: 10 steps kernels vs plain on the card: max |table diff| {err:.3g}, "
            f"rows beyond rtol=1e-4/atol=1e-5 {bad}")
    out = {"steps": steps, "fwd_launches": counts["softmax_ce_fwd"], "bwd_launches": counts["softmax_ce_bwd"],
           "fit_s": fit_s, "examples_per_s": rate, "epoch_loss": losses[0], "eval_launches": 0, "label": label}
    if evaluate:
        for w in ws:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = rs.evaluate(batch_size=SOFTMAX_B, eval_metrics=("loss", "auc", "recall@10"), verbose=False)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        counts = {w.__name__: w.launches for w in ws}
        nb = -(-st.num_test // SOFTMAX_B)
        check(counts["softmax_ce_fwd"] == nb and counts["softmax_ce_bwd"] == 0,
              f"{label}: evaluate ran {nb} batches but the CE kernels launched {counts}")
        check(counts["dot_topk_small"] > 0, f"{label}: recall@10 did not launch the top-k kernel: {counts}")
        check(np.isfinite(ev["loss"]) and ev["auc"] > fresh_eval["auc"],
              f"{label}: evaluate {ev} vs the fresh tables' {fresh_eval}")
        saved = {w.__name__: w.launches for w in ws}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs.evaluate(batch_size=SOFTMAX_B, eval_metrics=("loss", "auc"), verbose=False)
        torch.cuda.synchronize()
        pair_s = time.perf_counter() - t0
        for w in ws:
            w.launches = saved[w.__name__]
        log(f"[main] evaluate {label}: {ev} in {eval_s:.3f} s ({st.num_test} test rows, {nb} batches; "
            f"fresh tables {fresh_eval}); loss+auc alone {pair_s:.3f} s = {st.num_test / pair_s:.1f} rows/s; "
            f"launches {counts}")
        out.update(eval_launches=counts["softmax_ce_fwd"], eval_batches=nb, eval_s=eval_s,
                   eval_rows_per_s=st.num_test / pair_s, auc=ev["auc"], fresh_auc=fresh_eval["auc"])
    return rs, out


def mlp_sample_loss(torch, rs, sample) -> float:
    """Mean hinge loss of the installed MLP (eval mode: running batch-norm
    statistics) on a fixed sample of train pairs."""
    from torchrecsys_tpu_torch.data.features import attach_features

    users, pos, neg = (torch.as_tensor(x, device=rs.device) for x in sample)
    scores = []
    with torch.no_grad():
        for items in (pos, neg):
            side = attach_features({"user_id": users, "item_id": items}, rs.feat)
            scores.append(rs.model.score(rs._params(), rs.state["model_state"], side, train=False)[0])
    return float(torch.clamp_min(scores[1] - scores[0] + 1.0, 0.0).mean())


def compare_mlp_steps(torch, rs, steps: int = 10):
    """From the installed state and one epoch's batches, ``steps`` MLP steps
    with the tower kernels, with their plain versions and with f32 compute
    (the plain f32 tower), on the card. Each table's and each dense leaf's
    change with the kernels is held to the plain versions' by the JAX
    package's noise-floor rule (tests/test_fused_tower.py:83-119): distance
    below max(1.5 x the bf16-to-f32 distance of the plain run, 0.02).
    Returns {leaf: (distance, floor)}."""
    import dataclasses

    from torchrecsys_tpu_torch.models import build_model
    from torchrecsys_tpu_torch.ops import fused_tower as ft
    from torchrecsys_tpu_torch.train import Trainer
    from torchrecsys_tpu_torch.train.optim import augment_tables

    tr = rs.trainer
    data, feat = tr._device_train_data(rs.store), tr.feature_tables(rs.store)
    epoch = tr.build_epoch(data, torch.arange(6, device=DEVICE) * 17 + 3,
                           torch.Generator(device=DEVICE).manual_seed(23))
    f32 = Trainer(build_model(rs.store.schema, dataclasses.replace(rs.model_cfg, compute_dtype="float32")),
                  tr.cfg, DEVICE)
    saved = (ft.fused_tower_fwd.launches, ft.fused_tower_bwd.launches)
    start = dict(augment_tables(rs.state["tables"], rs.state["emb_opt"]), **{
        f"dense.{k}": v for k, v in flat_dense(rs.state["dense"]).items()})
    kernels = (ft.fused_tower_fwd, ft.fused_tower_bwd)
    runs = {}
    try:
        for label, trainer, fns in (("kernels", tr, kernels),
                                    ("plain", tr, (ft.fused_tower_fwd_plain, ft.fused_tower_bwd_plain)),
                                    ("f32", f32, kernels)):
            ft.fused_tower_fwd, ft.fused_tower_bwd = fns  # FusedLayer looks them up at each call
            st = dict(rs.state)
            aug = augment_tables(st["tables"], st["emb_opt"])
            losses = trainer.run_pairwise_steps(st, aug, epoch, feat, steps=range(steps))
            runs[label] = (losses, dict(aug, **{f"dense.{k}": v for k, v in flat_dense(st["dense"]).items()}))
    finally:
        ft.fused_tower_fwd, ft.fused_tower_bwd = kernels
    torch.cuda.synchronize()
    ft.fused_tower_fwd.launches, ft.fused_tower_bwd.launches = saved  # comparisons do not count
    check(bool(torch.isfinite(runs["kernels"][0]).all()), "MLP steps: non-finite loss")
    out = {}
    for name in start:
        # a hidden layer's bias (batch norm removes it) and the output bias
        # (it cancels in the hinge's neg - pos) have gradients that are 0 up
        # to rounding, which adam turns into steps of up to lr: not compared
        if name.endswith(".b"):
            continue
        dk, dp, df = (runs[k][1][name].float() - start[name].float() for k in ("kernels", "plain", "f32"))
        dist = float((dk - dp).norm() / dp.norm().clamp_min(1e-30))
        floor = float((dp - df).norm() / df.norm().clamp_min(1e-30))
        check(dist < max(1.5 * floor, 0.02), f"{steps} MLP steps: {name} kernels vs plain {dist:.3g}, "
              f"floor {floor:.3g}")
        out[name] = (dist, floor)
    lk, lp = runs["kernels"][0], runs["plain"][0]
    check(bool(torch.allclose(lk, lp, rtol=0.08)), f"MLP step losses {lk} vs plain {lp}")
    return out


def flat_dense(dense) -> dict:
    """{"layers.0.w": tensor, ...} of a dense tree."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}{k}.")
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                walk(x, f"{prefix}{i}.")
        else:
            out[prefix[:-1]] = t

    walk(dense, "")
    return out


def seeded_mlp(data, use_amp: bool):
    """The north-star MLP's RecSys over ``data`` from seeded JAX-layout
    tables, and a fixed sample of 65,536 train pairs with random negatives."""
    from torchrecsys_tpu_torch import RecSys

    rs = RecSys({k: data[k] for k in ("user_id", "item_id")}, net_type="mlp", n_factors=D,
                hidden_layers=MLP_HIDDEN, use_batch_norm=True, use_amp=use_amp,
                dynamic_neg_sampling=True, device=DEVICE)
    tables = seeded_tables(rs.model, seed=4)
    rs.load_jax_tables(tables, {k: {"acc": np.zeros(v.shape[0], np.float32)} for k, v in tables.items()})
    st = rs.store
    r = np.random.default_rng(14)
    rows = r.choice(st.num_train, min(65536, st.num_train), replace=False)
    return rs, (st.train_users[rows], st.train_items[rows], r.integers(0, N, rows.size))


def mlp_f32_witness(torch, data, amp):
    """The MLP main path's two epochs and evaluate again with f32 compute:
    the plain torch.matmul tower, no tower kernel, from the same seeded
    tables and seed. A witness, independent of the kernels, of what this
    data lets the MLP learn: the AMP run's test AUC may lie at most 0.02
    below this run's (run-to-run spread: index_add_ sums duplicate ids in
    no fixed order), and its fixed-sample loss after two epochs at most
    10% above this run's."""
    rs, sample = seeded_mlp(data, use_amp=False)
    ws = wrappers()
    for w in ws:
        w.launches = 0
    fresh = mlp_sample_loss(torch, rs, sample)
    samples = []
    for _ in range(2):
        rs.fit(epochs=1, batch_size=MLP_B, learning_rate=0.05, loss="hinge", verbose=False)
        samples.append(mlp_sample_loss(torch, rs, sample))
    ev = rs.evaluate(batch_size=MLP_B, eval_metrics=("loss", "auc"), verbose=False)
    torch.cuda.synchronize()
    check(sum(w.launches for w in ws) == 0, "MLP f32: the plain tower launched kernels")
    log(f"[train] MLP f32 witness (plain tower): sample loss {fresh:.5f} -> {samples[0]:.5f} -> "
        f"{samples[1]:.5f}; evaluate {ev}; AMP: sample loss {amp['samples'][0]:.5f} -> "
        f"{amp['samples'][1]:.5f}, AUC {amp['auc']:.5f}")
    check(amp["auc"] >= ev["auc"] - 0.02, f"MLP AMP test AUC {amp['auc']} is below the f32 run's {ev['auc']}")
    check(amp["samples"][1] <= 1.1 * samples[1], f"MLP AMP sample loss {amp['samples'][1]} is above the "
          f"f32 run's {samples[1]}")
    return {"auc": ev["auc"], "samples": samples}


def mlp_train_path(torch, data):
    """The MLP main path (the JAX package's north-star configuration,
    bench.py:140-173): RecSys(net_type="mlp", n_factors=80, hidden_layers=
    (1024, 128), use_batch_norm=True, use_amp=True, dynamic_neg_sampling=
    True) -> seeded JAX-layout tables -> fit(batch_size=8192,
    learning_rate=0.05, loss="hinge") -> evaluate(loss, auc) -> predict.
    Launch counts are zeroed just before each call and read just after."""
    from torchrecsys_tpu_torch.config import TrainConfig
    from torchrecsys_tpu_torch.train import Trainer

    label = "MLP AMP"
    t0 = time.perf_counter()
    rs, sample = seeded_mlp(data, use_amp=True)
    st = rs.store
    fresh = mlp_sample_loss(torch, rs, sample)
    fresh_eval = Trainer(rs.model, TrainConfig(batch_size=MLP_B, seed=rs.seed, dynamic_neg_sampling=True),
                         DEVICE).evaluate(rs.state, st, batch_size=MLP_B, verbose=False)
    torch.cuda.synchronize()
    log(f"[train] {label}: RecSys ingest and seeded state {time.perf_counter() - t0:.2f} s; "
        f"{st.num_train} train rows; fresh-start sample loss {fresh:.5f}, evaluate {fresh_eval}")
    steps = -(-st.num_train // MLP_B)
    want = len(MLP_HIDDEN) * steps
    epoch_losses, samples, total = [], [], {"fused_tower_fwd": 0, "fused_tower_bwd": 0}
    for epoch in range(2):
        losses, secs, counts = counted(torch, lambda: rs.fit(epochs=1, batch_size=MLP_B, learning_rate=0.05,
                                                             loss="hinge", verbose=False))
        check(counts["fused_tower_fwd"] == counts["fused_tower_bwd"] == want,
              f"{label}: fit ran {steps} steps but the tower kernels launched {counts}, want {want} each")
        check(sum(counts.values()) == 2 * want, f"{label}: fit launched other kernels: {counts}")
        check(len(losses) == 1 and np.isfinite(losses[0]), f"{label}: epoch loss {losses} is not finite")
        epoch_losses.append(losses[0])
        total = {k: n + counts[k] for k, n in total.items()}
        samples.append(mlp_sample_loss(torch, rs, sample))
        if epoch == 0:
            fit_s, launches = secs, counts
    # After one epoch this sample's loss moves by noise only (each item has
    # been a positive ~2.4 times); after the second it falls clearly.
    check(samples[1] < fresh, f"{label}: the sample loss after two epochs {samples[1]} is not below the "
          f"fresh start's {fresh}")
    rate = st.num_train / fit_s
    log(f"[train] {label}: fit {steps} steps of {MLP_B} in {fit_s:.3f} s = {rate:.1f} examples/s; "
        f"epoch loss {epoch_losses[0]:.5f}; launches {launches}; a second epoch: loss {epoch_losses[1]:.5f}; "
        f"sample loss {fresh:.5f} -> {samples[0]:.5f} -> {samples[1]:.5f}")
    dists = compare_mlp_steps(torch, rs)
    worst = max(dists, key=lambda k: dists[k][0])
    log(f"[train] {label}: 10 steps kernels vs plain on the card: largest relative distance "
        f"{dists[worst][0]:.3g} ({worst}; its bf16-to-f32 floor {dists[worst][1]:.3g}); "
        f"all {len(dists)} leaves within max(1.5 x floor, 0.02)")

    ev, eval_s, counts = counted(torch, lambda: rs.evaluate(batch_size=MLP_B, eval_metrics=("loss", "auc"),
                                                            verbose=False))
    check(sum(counts.values()) == 0, f"{label}: evaluate launched kernels: {counts}")
    check(np.isfinite(ev["loss"]) and 0.0 <= ev["auc"] <= 1.0, f"{label}: evaluate {ev}")
    # This MLP memorizes the train pairs of this data without generalizing
    # (each item occurs ~3 times), so the test AUC does not rise (the f32
    # witness, mlp_f32_witness, shows the same); evaluate is held to a
    # direct recomputation instead.
    direct = check_evaluate_direct(torch, rs, MLP_B)
    log(f"[main] evaluate {label}: {ev} in {eval_s:.3f} s = {st.num_test / eval_s:.1f} rows/s "
        f"({st.num_test} test rows, batch {MLP_B}; fresh state {fresh_eval}); launches {counts}; "
        f"with fixed negatives {direct}")

    users = st.user_encoder.to_list()[:16]
    ids, pred_s, counts = counted(torch, lambda: rs.predict(users, top_k=10))
    check(sum(counts.values()) == 0, f"{label}: predict launched kernels: {counts}")
    check_mlp_predict(torch, rs, users, ids)
    log(f"[main] predict {label}: 16 users x {N} items top_k=10 through the chunked scorer in "
        f"{pred_s:.3f} s; launches {counts}")
    return rs, {"steps": steps, "fwd_launches": total["fused_tower_fwd"],
                "bwd_launches": total["fused_tower_bwd"], "fit_s": fit_s,
                "examples_per_s": rate, "epoch_loss": epoch_losses[0], "eval_rows_per_s": st.num_test / eval_s,
                "auc": ev["auc"], "fresh_auc": fresh_eval["auc"], "predict_s": pred_s, "samples": samples}


def check_evaluate_direct(torch, rs, batch: int, what: str = "MLP"):
    """Trainer.evaluate with fixed negatives against the same loss and AUC
    computed directly: every test row's positive and negative scored by the
    model (the MLP's eval tower) in 65,536-row chunks. The products' row
    blocks differ from evaluate's paired batches, so a bf16 score may move
    one ulp: loss within rtol=1e-3, AUC within 1e-3 (600 of 600,000 rows)."""
    from torchrecsys_tpu_torch.data.features import attach_features

    st = rs.store
    negs = np.random.default_rng(16).integers(0, N, st.num_test)
    got = rs.trainer.evaluate(rs.state, st, batch_size=batch, verbose=False, negatives=negs)
    scores = {"pos": [], "neg": []}
    with torch.no_grad():
        for s in range(0, st.num_test, 65536):
            u = torch.as_tensor(st.test_users[s : s + 65536], device=DEVICE).long()
            for key, items in (("pos", st.test_items), ("neg", negs)):
                it = torch.as_tensor(items[s : s + 65536], device=DEVICE).long()
                side = attach_features({"user_id": u, "item_id": it}, rs.feat)
                scores[key].append(rs.model.score(rs._params(), rs.state["model_state"], side, train=False)[0])
    ps, ns = torch.cat(scores["pos"]), torch.cat(scores["neg"])
    loss = float(torch.clamp_min(ns - ps + rs.trainer.cfg.margin, 0.0).mean())
    auc = float((ps > ns).float().mean())
    check(abs(got["loss"] - loss) <= 1e-3 * abs(loss) and abs(got["auc"] - auc) <= 1e-3,
          f"{what} evaluate {got} != direct loss {loss}, auc {auc}")
    return {"evaluate": got, "direct": {"loss": loss, "auc": auc}}


def check_mlp_predict(torch, rs, users, ids, what: str = "MLP"):
    """predict's items, rescored (eval tower): finite, non-increasing along
    each row up to bf16 rounding, and the first at least the best of 4096
    random items."""
    from torchrecsys_tpu_torch.data.features import attach_features

    check(ids.shape == (len(users), 10), f"{what} predict shape {ids.shape}")
    enc = rs.store.item_encoder
    rows = torch.as_tensor([rs.store.user_encoder.encode_one(u) for u in users], device=DEVICE)
    items = torch.as_tensor([[enc.encode_one(x) for x in row] for row in ids], device=DEVICE)
    rand = torch.randint(0, N, (len(users), 4096), device=DEVICE,
                         generator=torch.Generator(device=DEVICE).manual_seed(15))

    def score(it):
        side = attach_features({"user_id": rows.repeat_interleave(it.shape[1]), "item_id": it.reshape(-1)}, rs.feat)
        with torch.no_grad():
            return rs.model.score(rs._params(), rs.state["model_state"], side, train=False)[0].reshape(it.shape)

    top, other = score(items), score(rand)
    tol = 1e-2 * top.abs().max()
    check(bool(torch.isfinite(top).all()), f"{what} predict: non-finite scores")
    check(bool((top[:, 1:] <= top[:, :-1] + tol).all()), f"{what} predict: scores not in descending order")
    check(bool((top[:, 0] + tol >= other.max(dim=1).values).all()), f"{what} predict: a random item beats the top")


def main_path(torch, rs, label: str = ""):
    """Predict from ``rs``'s trained tables (40 batches of U users per
    traffic mix); launch counts are zeroed just before and read just
    after."""
    from torchrecsys_tpu_torch.ops import dot_topk as dt

    all_users = rs.store.user_encoder.to_list()
    batches = [all_users[s : s + U] for s in range(0, 40 * U, U)]
    cases = (("top_k=10", 10, False), ("top_k=128", 128, False), ("exclude_seen top_k=10", 10, True))
    rates = {}
    for w in wrappers():
        w.launches = 0
    wrappers_topk = (dt.dot_topk_small, dt.dot_topk_large)
    for case, top_k, excl in cases:
        before = {w.__name__: w.launches for w in wrappers_topk}
        rs.predict(batches[0], top_k=top_k, exclude_seen=excl)  # warm-up
        t0 = time.perf_counter()
        outs = [rs.predict(b, top_k=top_k, exclude_seen=excl) for b in batches[1:]]
        dt_s = time.perf_counter() - t0
        rates[case] = U * len(outs) / dt_s
        grew = {n: w.launches - before[n] for n, w in ((w.__name__, w) for w in wrappers_topk)}
        want = "dot_topk_small" if top_k <= 16 else "dot_topk_large"
        check(grew[want] == len(batches), f"{label} {case}: {want} launched {grew[want]} times for "
              f"{len(batches)} batches")
        log(f"[main] predict{label} {case}: {len(outs)} batches of {U} users, {rates[case]:.1f} users/s, "
            f"launches {grew}")
        check_predict(rs, batches[1], outs[0], top_k, excl, torch)
    launches = {w.__name__: w.launches for w in wrappers_topk}
    for name, count in launches.items():
        check(count > 0, f"kernel {name} never launched on the main path")
    others = {w.__name__: w.launches for w in wrappers() if w not in wrappers_topk and w.launches}
    check(not others, f"predict{label} launched other kernels: {others}")
    log(f"[main] launches over the predict{label} path: {launches}")
    return batches[1], launches, rates


def host_ms(torch, fn, reps: int = 10):
    """Mean ms of fn() over reps calls, synchronised (host clock)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, out


def predict_breakdown(torch, rs, users_raw):
    """Time predict and each of its parts (the calls predict makes, in
    order), synchronised, for one batch."""
    from torchrecsys_tpu_torch.ops.dot_topk import dot_topk, pack_seen_mask_torch

    q, ib, user_fn, _ = rs._linearized()
    for top_k, excl in ((10, False), (128, False), (10, True)):
        total, _ = host_ms(torch, lambda: rs.predict(users_raw, top_k=top_k, exclude_seen=excl))
        parts = {}
        parts["encode"], rows = host_ms(
            torch, lambda: np.asarray([rs.store.user_encoder.encode_one(u) for u in users_raw])
        )
        mask = None
        if excl:
            parts["seen"], seen = host_ms(torch, lambda: rs._seen(rows))
            pos = np.repeat(np.arange(len(rows)), [len(s) for s in seen])
            parts["mask_build"], mask = host_ms(torch, lambda: pack_seen_mask_torch(
                torch.as_tensor(pos, device=rs.device),
                torch.as_tensor(np.concatenate(seen), device=rs.device), len(rows), q.shape[0],
            ))
        parts["user_vecs"], (uv, _) = host_ms(
            torch, lambda: user_fn(rs._params(), torch.as_tensor(rows, device=rs.device))
        )
        parts["kernel"], (_, ids) = host_ms(torch, lambda: dot_topk(uv, q, ib, top_k, seen_mask=mask))
        parts["to_host"], ids = host_ms(torch, lambda: ids.cpu().numpy())
        parts["decode"], _ = host_ms(torch, lambda: rs._decode_items(ids, True, False))
        log(
            f"[breakdown] predict top_k={top_k} exclude_seen={excl}: {total:.3f} ms per "
            f"{len(users_raw)}-user batch = " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        )
    cat_ms, _ = host_ms(torch, lambda: rs.model.linearized_catalog(rs._params(), rs.feat))
    log(f"[breakdown] linearized catalog rebuild (kept between calls): {cat_ms:.3f} ms")


# ---------------------------------------------------------------------------
# phases 6j-6m: popularity and K negatives, lr schedules, NeuCF, the unfused
# embedding update
# ---------------------------------------------------------------------------

POP_SCHEDULE = {"kind": "cosine", "decay_steps": 2344}
POP_DRAWS = 1 << 24


def ln_launches() -> tuple:
    """(forward, backward) launches of the layer-norm kernels so far. They
    are counted apart from :func:`wrappers`: every SASRec encode launches
    them, beside whatever kernel a path's check counts."""
    from torchrecsys_tpu_torch.ops import layer_norm as ln

    return ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches


def counted(torch, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after: (result, seconds, counts)."""
    ws = wrappers()
    for w in ws:
        w.launches = 0
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    res = fn()
    sync()
    return res, time.perf_counter() - t, {w.__name__: w.launches for w in ws}


def seeded_recsys(torch, data, meta: bool, seed: int, **kw):
    """RecSys over ``data`` (the category column with ``meta``) with
    dynamic negatives and seeded JAX-layout tables, and a fixed sample of
    65,536 train pairs with uniform negatives."""
    from torchrecsys_tpu_torch import RecSys

    cols = data if meta else {k: data[k] for k in ("user_id", "item_id")}
    rs = RecSys(cols, metadata_id_col=["category_id"] if meta else None, n_factors=D, device=DEVICE,
                dynamic_neg_sampling=True, **kw)
    tables = seeded_tables(rs.model, seed=seed)
    rs.load_jax_tables(tables, {k: {"acc": np.zeros(v.shape[0], np.float32)} for k, v in tables.items()})
    st = rs.store
    r = np.random.default_rng(seed + 100)
    rows = r.choice(st.num_train, min(65536, st.num_train), replace=False)
    return rs, (st.train_users[rows], st.train_items[rows], r.integers(0, N, rows.size))


def popularity_draw_check(torch, store, feat):
    """2^24 alias draws on the card from the train split's tables: without
    collision avoidance the counts hold against count^0.75 by a chi-square
    bound (df + 6 sqrt(2 df), df = items with mass - 1: six standard
    deviations of the normal approximation) and zero-count items are never
    drawn; with it, no negative equals its positive. Returns (chi2, bound,
    total variation distance)."""
    from torchrecsys_tpu_torch.data.sampling import sample_negatives_alias

    gen = torch.Generator(device=DEVICE).manual_seed(23)
    train = torch.as_tensor(store.train_items, device=DEVICE).long()
    pos = train[torch.randint(0, train.numel(), (POP_DRAWS,), generator=gen, device=DEVICE)]
    tabs = (feat["neg_prob"], feat["neg_alias"], feat["neg_fb"])
    free = sample_negatives_alias(gen, pos, *tabs, avoid_collisions=False)
    got = torch.bincount(free, minlength=N).double().cpu().numpy()
    counts = np.bincount(store.train_items, minlength=N)
    live = counts > 0
    w = counts.astype(np.float64) ** 0.75
    expect = w / w.sum() * POP_DRAWS
    check(got[~live].sum() == 0, f"popularity draws: {int(got[~live].sum())} draws of zero-count items")
    chi2 = float((((got - expect) ** 2)[live] / expect[live]).sum())
    df = int(live.sum()) - 1
    bound = df + 6.0 * np.sqrt(2.0 * df)
    tv = 0.5 * float(np.abs(got / POP_DRAWS - w / w.sum()).sum())
    check(chi2 < bound, f"popularity draws: chi-square {chi2:.1f} against count^0.75 above {bound:.1f} (df {df})")
    avoid = sample_negatives_alias(gen, pos, *tabs, avoid_collisions=True)
    check(not bool((avoid == pos).any()), "popularity draws: a negative equals its positive")
    check(not bool(torch.as_tensor(~live, device=DEVICE)[avoid].any()), "popularity draws: a zero-count item")
    return chi2, bound, tv, df


def popularity_path(torch, data):
    """6j: Linear with the category column, hinge, popularity negatives at
    K=1 and a cosine lr schedule over the epoch's 2,344 steps, batch 1024,
    one epoch: one step-kernel call per step and no other launch, each
    step's lr the schedule's at that step, 20 steps kernel vs plain at
    their scheduled lrs, the sample loss falls. The alias build's host
    seconds and 2^24 draws on the card (popularity_draw_check)."""
    from torchrecsys_tpu_torch.config import TrainConfig
    from torchrecsys_tpu_torch.data.sampling import alias_table
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp
    from torchrecsys_tpu_torch.train.optim import make_lr_schedule

    label = "popularity K=1 cosine"
    rs, sample = seeded_recsys(torch, data, True, seed=3)
    st = rs.store
    fresh = sample_loss(torch, rs, sample)
    t0 = time.perf_counter()
    alias_table(st.train_items, N, 0.75)
    alias_s = time.perf_counter() - t0
    fit_kw = dict(epochs=1, batch_size=TRAIN_B, learning_rate=1e-2, lr_schedule=POP_SCHEDULE,
                  neg_sampling="popularity")
    tr = rs._ensure_trainer(TrainConfig(
        batch_size=TRAIN_B, epochs=1, learning_rate=1e-2, lr_schedule=POP_SCHEDULE,
        dynamic_neg_sampling=True, neg_sampling="popularity", seed=rs.seed,
    ))
    check(tr._fused and tr._in_step_negs, f"{label}: the trainer does not take the step kernel")
    t0 = time.perf_counter()
    feat = tr._popularity_tables(st)
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    chi2, bound, tv, df = popularity_draw_check(torch, st, feat)
    log(f"[train] {label}: alias table of {N} items built on the host in {alias_s:.3f} s (the trainer's "
        f"build and upload {tables_s:.3f} s); {POP_DRAWS} draws on the card: chi-square {chi2:.1f} < "
        f"{bound:.1f} (df {df}), total variation {tv:.5f}, no zero-count item, no negative equal to its "
        f"positive")
    real = fp.fused_pairwise_step_meta
    lrs = []

    def recording(*a, **k):
        lrs.append(a[9])  # (user, item, meta tables, meta ids, mask, users, pos, neg, w, lr)
        return real(*a, **k)

    # run_steps looks the step up at each call, and the wrapper counts its
    # launches under its module name: on the shim while it is installed
    recording.__name__, recording.launches = real.__name__, 0
    fp.fused_pairwise_step_meta = recording
    try:
        losses, fit_s, counts = counted(torch, lambda: rs.fit(verbose=False, **fit_kw))
    finally:
        fp.fused_pairwise_step_meta = real
    check(rs.trainer is tr, f"{label}: fit built another trainer")
    steps = -(-st.num_train // TRAIN_B)
    check(counts["fused_pairwise_step_meta"] == steps and sum(counts.values()) == steps,
          f"{label}: fit ran {steps} steps but launched {counts}")
    sched = make_lr_schedule(1e-2, POP_SCHEDULE)
    want = [sched(s) for s in range(steps)]
    check(lrs == want, f"{label}: the steps' lr differ from the schedule at "
          f"{[i for i, (a, b) in enumerate(zip(lrs, want)) if a != b][:5]}")
    t = POP_SCHEDULE["decay_steps"]
    direct = np.float32(0.5e-2) * (1 + np.cos(np.pi * np.minimum(np.arange(steps), t) / t))
    check(np.allclose(lrs, direct, rtol=0, atol=1e-8), f"{label}: the schedule is not the cosine")
    check(len(losses) == 1 and np.isfinite(losses[0]), f"{label}: epoch loss {losses} is not finite")
    trained = sample_loss(torch, rs, sample)
    check(trained < fresh, f"{label}: the sample loss {trained} is not below the fresh start's {fresh}")
    rate = st.num_train / fit_s
    log(f"[train] {label}: fit {steps} steps of {TRAIN_B} in {fit_s:.3f} s = {rate:.1f} examples/s; epoch "
        f"loss {losses[0]:.5f}; sample loss {fresh:.5f} -> {trained:.5f}; launches {counts}; lr "
        f"{lrs[0]:.6g} -> {lrs[steps // 2]:.6g} -> {lrs[-1]:.6g}, each the schedule's")
    err, bad = compare_steps(torch, rs)
    log(f"[train] {label}: 20 steps kernel vs plain on the card at the schedule's lr: max |table diff| "
        f"{err:.3g}, rows beyond rtol=1e-4/atol=1e-5 {bad}")
    return rs, {"launches": counts["fused_pairwise_step_meta"], "examples_per_s": rate, "alias_s": alias_s,
                "fit_s": fit_s, "chi2": chi2, "tv": tv, "label": label, "fit_kw": fit_kw}


def check_k_evaluate_direct(torch, rs, batch: int, k: int, what: str):
    """Trainer.evaluate with fixed (k, n) negatives against the per-row
    loss over all k draws and the AUC against the first, from the model's
    scores of every test row computed directly: loss within rtol=1e-4, AUC
    within 1e-4."""
    from torchrecsys_tpu_torch.data.features import attach_features

    st = rs.store
    negs = np.random.default_rng(17).integers(0, N, (k, st.num_test))
    got = rs.trainer.evaluate(rs.state, st, batch_size=batch, verbose=False, negatives=negs)

    def score(u, items):
        side = attach_features({"user_id": u, "item_id": items}, rs.feat)
        return rs.model.score(rs._params(), rs.state["model_state"], side, train=False)[0]

    loss_sum, wins = 0.0, 0.0
    with torch.no_grad():
        for s in range(0, st.num_test, 65536):
            u = torch.as_tensor(st.test_users[s : s + 65536], device=DEVICE).long()
            ps = score(u, torch.as_tensor(st.test_items[s : s + 65536], device=DEVICE).long())
            ns = torch.stack([score(u, torch.as_tensor(n[s : s + 65536], device=DEVICE).long()) for n in negs])
            loss_sum += float(rs.trainer.per_row_fn(ps, ns, rs.trainer.cfg.margin).double().sum())
            wins += float((ps > ns[0]).double().sum())
    loss, auc = loss_sum / st.num_test, wins / st.num_test
    check(abs(got["loss"] - loss) <= 1e-4 * abs(loss) and abs(got["auc"] - auc) <= 1e-4,
          f"{what} evaluate {got} != direct loss {loss}, auc {auc}")
    return {"evaluate": got, "direct": {"loss": loss, "auc": auc}}


def warp_path(torch, data):
    """6k, bench.py:358-365's row: Linear, ``loss="warp"``,
    ``num_negatives=8``, popularity negatives, batch 8192, lr 0.05,
    dynamic negatives: the autograd step over 9 x 8192 rows, no kernel;
    a finite epoch loss and a falling sample loss; evaluate(loss, auc)
    over 8 draws per test row (the AUC on the first), no kernel, held to a
    direct recomputation with fixed draws."""
    label = "WARP K=8 popularity"
    rs, sample = seeded_recsys(torch, data, False, seed=4)
    st = rs.store
    fresh = sample_loss(torch, rs, sample)
    kw = dict(epochs=1, batch_size=MLP_B, learning_rate=0.05, loss="warp", num_negatives=8,
              neg_sampling="popularity")
    losses, fit_s, counts = counted(torch, lambda: rs.fit(verbose=False, **kw))
    steps = -(-st.num_train // MLP_B)
    check(not rs.trainer._fused and sum(counts.values()) == 0, f"{label}: fit launched {counts}")
    check(len(losses) == 1 and np.isfinite(losses[0]), f"{label}: epoch loss {losses} is not finite")
    trained = sample_loss(torch, rs, sample)
    check(trained < fresh, f"{label}: the hinge sample loss {trained} is not below the fresh start's {fresh}")
    rate = st.num_train / fit_s
    log(f"[train] {label}: fit {steps} steps of {MLP_B} x 9 scored rows in {fit_s:.3f} s = {rate:.1f} "
        f"examples/s (alias build included); epoch loss {losses[0]:.5f}; hinge sample loss {fresh:.5f} -> "
        f"{trained:.5f}; launches {counts}")
    ev, eval_s, counts = counted(torch, lambda: rs.evaluate(batch_size=MLP_B, eval_metrics=("loss", "auc"),
                                                            verbose=False))
    check(sum(counts.values()) == 0 and np.isfinite(ev["loss"]) and 0 <= ev["auc"] <= 1,
          f"{label}: evaluate {ev}, launches {counts}")
    direct = check_k_evaluate_direct(torch, rs, MLP_B, 8, label)
    log(f"[main] evaluate {label}: {ev} in {eval_s:.3f} s = {st.num_test / eval_s:.1f} rows/s (8 draws per "
        f"row); launches {counts}; with fixed draws {direct}")
    return rs, {"examples_per_s": rate, "fit_s": fit_s, "eval_rows_per_s": st.num_test / eval_s,
                "auc": ev["auc"], "label": label}


def neucf_path(torch, data):
    """6l, bench.py:350-351's row: NeuCF with AMP, hinge, batch 8192, lr
    0.05, dynamic negatives, one epoch through the autograd step (no
    kernel: NeuCF does not factorize); evaluate(loss, auc) held to a
    direct recomputation; a 16-user predict(top_k=10) through the chunked
    scorer, rescored. No launch anywhere; every value finite."""
    label = "NeuCF AMP"
    rs, sample = seeded_recsys(torch, data, False, seed=5, net_type="neucf", use_amp=True)
    st = rs.store
    fresh = sample_loss(torch, rs, sample)
    losses, fit_s, counts = counted(torch, lambda: rs.fit(epochs=1, batch_size=MLP_B, learning_rate=0.05,
                                                          verbose=False))
    steps = -(-st.num_train // MLP_B)
    check(sum(counts.values()) == 0, f"{label}: fit launched {counts}")
    check(len(losses) == 1 and np.isfinite(losses[0]), f"{label}: epoch loss {losses} is not finite")
    trained = sample_loss(torch, rs, sample)
    check(np.isfinite(trained), f"{label}: sample loss {trained}")
    rate = st.num_train / fit_s
    log(f"[train] {label}: fit {steps} steps of {MLP_B} in {fit_s:.3f} s = {rate:.1f} examples/s; epoch loss "
        f"{losses[0]:.5f}; sample loss {fresh:.5f} -> {trained:.5f}; launches {counts}")
    ev, eval_s, counts = counted(torch, lambda: rs.evaluate(batch_size=MLP_B, eval_metrics=("loss", "auc"),
                                                            verbose=False))
    check(sum(counts.values()) == 0 and np.isfinite(ev["loss"]) and 0 <= ev["auc"] <= 1,
          f"{label}: evaluate {ev}, launches {counts}")
    direct = check_evaluate_direct(torch, rs, MLP_B, label)
    users = st.user_encoder.to_list()[:16]
    ids, pred_s, pcounts = counted(torch, lambda: rs.predict(users, top_k=10))
    check(sum(pcounts.values()) == 0, f"{label}: predict launched {pcounts}")
    check_mlp_predict(torch, rs, users, ids, label)
    items = st.item_encoder.to_list()[:16]
    _, sim_s, scounts = counted(torch, lambda: check_similar(torch, rs, items))
    check(nonzero(scounts) == {"dot_topk_small": len(items)}, f"{label}: similar_items launched {scounts}")
    log(f"[main] {label}: evaluate {ev} in {eval_s:.3f} s = {st.num_test / eval_s:.1f} rows/s, with fixed "
        f"negatives {direct}; predict 16 users x {N} items top_k=10 in {pred_s:.3f} s; launches {counts}, "
        f"{pcounts}; similar_items of {len(items)} items over the {2 * D}-wide item table (#1 on the slab "
        f"path) in {sim_s:.3f} s, each against the plain top-k; launches {nonzero(scounts)}")
    return rs, {"examples_per_s": rate, "fit_s": fit_s, "eval_rows_per_s": st.num_test / eval_s,
                "predict_s": pred_s, "auc": ev["auc"], "label": label, "similar_counts": scounts}


def check_similar(torch, rs, items, k: int = 10):
    """similar_items of each item (the top-k kernels over the item table)
    against the plain top-k of the same dot products: each returned item
    must score (f64) what the plain list holds at its rank."""
    from torchrecsys_tpu_torch.ops.dot_topk import dot_topk_plain

    n = rs.store.schema.num_items
    vecs = rs.state["tables"]["item"][:n].float()
    zero = torch.zeros((n,), dtype=torch.float32, device=vecs.device)
    for item in items:
        row = rs.store.item_encoder.encode_one(item)
        got = torch.as_tensor(rs.similar_items(item, top_k=k, return_raw_ids=False), device=vecs.device).long()
        pv, pi = dot_topk_plain(vecs[row][None, :], vecs, zero, k + 1)
        pv = pv[0][pi[0] != row][:k].double()
        true = (vecs[row].double()[None, :] * vecs[got].double()).sum(-1)
        check(got.shape == (k,) and bool(((true - pv).abs() <= ATOL + RTOL * pv.abs()).all()),
              f"similar_items({item!r}) disagrees with the plain top-k")


def wide_path(torch, data):
    """C1 on the main path: Linear at n_factors=WIDE_D from seeded tables,
    WIDE_STEPS steps of TRAIN_B (the autograd step: the step kernel takes
    124 lanes), then main_path's 40 predict batches of U users at top_k 10,
    128 and exclude_seen through #1/#2 on the slab path, a batch of each
    held against the plain version. Returns the launches and rates."""
    from torchrecsys_tpu_torch import RecSys

    label = f" Linear D={WIDE_D}"
    rs = RecSys({k: data[k] for k in ("user_id", "item_id")}, n_factors=WIDE_D, device=DEVICE,
                dynamic_neg_sampling=True)
    mesh_seed(rs)
    loss, fit_s, counts = counted(torch, lambda: gen_steps(torch, rs, WIDE_STEPS, TRAIN_B))
    check(np.isfinite(loss) and sum(counts.values()) == 0, f"{label}: loss {loss}, launches {counts}")
    _, launches, rates = main_path(torch, rs, label)
    log(f"[main] C1{label}: {WIDE_STEPS} steps of {TRAIN_B} in {fit_s:.3f} s (loss {loss:.5f}); predict users/s "
        f"{json.dumps(rates)}; launches {launches}")
    del rs
    torch.cuda.empty_cache()
    return launches, rates


SMALL_OPTIONS = (
    # (label, net, TrainConfig keywords)
    ("sgd", "linear", dict(embedding_optimizer="sgd")),
    ("unfused adagrad", "linear", dict(fused_embedding_update=False)),
    ("adaptive_hinge K=4", "linear", dict(loss="adaptive_hinge", num_negatives=4)),
    ("NeuCF f32", "neucf", dict(dense_optimizer="adagrad")),
    ("softmax step schedule", "linear",
     dict(loss="sampled_softmax", lr_schedule={"kind": "step", "boundaries_and_scales": {10: 0.5, 25: 0.2}})),
    ("popularity exponential", "linear",
     dict(neg_sampling="popularity", lr_schedule={"kind": "exponential", "transition_steps": 10,
                                                  "decay_rate": 0.8})),
)


def small_options_check(torch):
    """6m: phase 5's small dataset (category column) trained two epochs on
    the card and on the CPU from one start with the same round keys, for
    each of SMALL_OPTIONS; negatives drawn in training are drawn on the CPU
    and handed to both (the popularity case first checks the alias map on
    the card against the CPU's on the same uniforms, id for id). Losses,
    tables and accumulators (NeuCF: its dense layers; adagrad for them:
    adam's first step turns rounding of a cancelling gradient into a step
    of lr) within phase 5's rtol=1e-4, atol=1e-5, under torch's
    deterministic algorithms. The softmax case launches each CE kernel once
    per step, the popularity case the step kernel once per step, the
    others nothing."""
    from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
    from torchrecsys_tpu_torch.data import prepare_data
    from torchrecsys_tpu_torch.data.sampling import alias_map, alias_uniforms, pack_alias
    from torchrecsys_tpu_torch.models import build_model
    from torchrecsys_tpu_torch.train import Trainer
    from torchrecsys_tpu_torch.train.optim import tree_map

    r = np.random.default_rng(6)
    data = {"user_id": r.integers(0, 300, 20000), "item_id": r.integers(0, 5000, 20000)}
    data["category_id"] = data["item_id"] % 17
    store = prepare_data(data, "user_id", "item_id", metadata_id_col=["category_id"])
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    try:
        for label, net, kw in SMALL_OPTIONS:
            cfg = TrainConfig(batch_size=1000, learning_rate=0.05, **kw)
            trs = {dev: Trainer(build_model(store.schema, ModelConfig(net_type=net, n_factors=D)), cfg, dev)
                   for dev in ("cpu", DEVICE)}
            start = trs["cpu"].init_state()
            res = {}
            for dev, tr in trs.items():
                state = dict(start, rng=None, dense_opt=None,
                             tables={k: v.to(dev) for k, v in start["tables"].items()},
                             emb_opt={k: {n: a.to(dev) for n, a in o.items()} for k, o in start["emb_opt"].items()},
                             dense=tree_map(lambda t: t.to(dev), start["dense"]))
                data_d, feat = tr._device_train_data(store), tr.feature_tables(store)
                if dev == "cpu":
                    cpu_data, cpu_feat = data_d, feat
                if "neg_prob" in feat and dev != "cpu":
                    u = alias_uniforms(torch.Generator().manual_seed(9), (3, 4096), store.schema.num_items)
                    pos = torch.as_tensor(store.train_items[:4096]).long()
                    maps = [alias_map(pos.to(d), pack_alias(f["neg_prob"], f["neg_alias"]), f["neg_fb"],
                                      tuple(x.to(d) for x in u)).cpu() for d, f in (("cpu", cpu_feat), (DEVICE, feat))]
                    check(torch.equal(*maps), f"small {label}: the alias map on the card != the CPU's")
                losses, counts = [], None
                ws = wrappers()
                for w in ws:
                    w.launches = 0
                for e in range(2):
                    keys = torch.arange(6) + 7 * e
                    negs = None
                    if tr._in_step_negs and not tr._softmax:
                        ep = trs["cpu"].build_epoch(cpu_data, keys, torch.Generator().manual_seed(40 + e), cpu_feat)
                        negs = ep.batches["neg_item_id"]
                    state, loss = tr.train_epoch(state, data_d, feat, keys=keys.to(dev),
                                                 negatives=None if negs is None else negs.to(dev))
                    losses.append(float(loss))
                counts = {w.__name__: w.launches for w in ws}
                res[dev] = (np.asarray(losses), state, counts)
            (lc, sc, _), (lg, sg, counts) = res["cpu"], res[DEVICE]
            steps = 2 * -(-store.num_train // 1000)
            want = ({"softmax_ce_fwd": steps, "softmax_ce_bwd": steps} if "softmax" in label
                    else {"fused_pairwise_step_meta": steps} if "popularity" in label else {})
            check({k: v for k, v in counts.items() if v} == want,
                  f"small {label}: launches {counts}, want {want}")
            check(np.allclose(lg, lc, rtol=1e-4, atol=1e-5), f"small {label}: losses {lg} != CPU {lc}")
            err = 0.0
            leaves = [(f"table {k}", sg["tables"][k], sc["tables"][k]) for k in sc["tables"]]
            leaves += [(f"acc {k}", sg["emb_opt"][k]["acc"], sc["emb_opt"][k]["acc"])
                       for k in sc["emb_opt"] if "acc" in sc["emb_opt"][k]]
            leaves += [(f"dense {i}", a, b) for i, (a, b) in
                       enumerate(zip(flat_dense(sg["dense"]).values(), flat_dense(sc["dense"]).values()))]
            for name, g, c in leaves:
                g = g.cpu()
                check(torch.allclose(g, c, rtol=1e-4, atol=1e-5), f"small {label}: {name}")
                err = max(err, float((g - c).abs().max()))
            log(f"[main] small {label}: card == CPU over 2 epochs (losses {lg.round(6).tolist()}, max |diff| "
                f"{err:.3g} over {len(leaves)} tensors); card launches {want or 'none'}")
            out[label] = counts
    finally:
        torch.use_deterministic_algorithms(False)
    return out


# ---------------------------------------------------------------------------
# phase 6o: the sequence models (LSTM and SASRec)
# ---------------------------------------------------------------------------

SEQ_LABELS = {"lstm": "LSTM AMP", "sasrec": "SASRec AMP"}
SEQ_SMALL_RTOL, SEQ_SMALL_ATOL = 2e-4, 1e-5  # tests/test_torch_lstm.py's f32 fit tolerance


def check_seq_evaluate_direct(torch, rs, batch: int, what: str):
    """Trainer.evaluate with fixed negatives against the loss and AUC
    computed directly by the paired-side rule: each test row's history
    encoded once with its positive hidden, the positive and the negative
    scored against it, in 65,536-row chunks. The encoder's row blocks differ
    from evaluate's batches, so a bf16 score may move one ulp: loss within
    rtol=1e-3, AUC within 1e-3."""
    st, m, feat = rs.store, rs.model, rs.feat
    negs = np.random.default_rng(17).integers(0, N, st.num_test)
    got = rs.trainer.evaluate(rs.state, st, batch_size=batch, verbose=False, negatives=negs)
    params = rs._params()
    item, ib = params["tables"]["item"], params["tables"]["item_bias"][:, 0]
    cd = m.compute_dtype
    ps, ns = [], []
    with torch.no_grad():
        for s in range(0, st.num_test, 65536):
            u = torch.as_tensor(st.test_users[s : s + 65536], device=DEVICE).long()
            p = torch.as_tensor(st.test_items[s : s + 65536], device=DEVICE).long()
            n = torch.as_tensor(negs[s : s + 65536], device=DEVICE).long()
            hid, hm = feat["hist_ids"][u], feat["hist_mask"][u]
            h = m._encode(params["dense"], item[hid], hm & (hid != p[:, None]))
            ps.append((torch.sum(h * item[p].to(cd), -1) + ib[p].to(cd)).float())
            ns.append((torch.sum(h * item[n].to(cd), -1) + ib[n].to(cd)).float())
    ps, ns = torch.cat(ps), torch.cat(ns)
    loss = float(torch.clamp_min(ns - ps + rs.trainer.cfg.margin, 0.0).mean())
    auc = float((ps > ns).float().mean())
    check(abs(got["loss"] - loss) <= 1e-3 * abs(loss) and abs(got["auc"] - auc) <= 1e-3,
          f"{what} evaluate {got} != direct loss {loss}, auc {auc}")
    return {"evaluate": got, "direct": {"loss": loss, "auc": auc}}


def topk_in_profile(torch, rs, users):
    """torch.profiler's CUDA records of three predicts at top_k=10 and
    three at 128 (:func:`profiled_window`, whose lead-in keeps a window's
    first kernels): the main top-k kernel (#1, then #2) must be among
    them, once per call."""
    for k in (10, 128):
        for take in range(1, 4):  # a window that lost records is taken again, as train_breakdown does
            prof, _ = profiled_window(torch, lambda: rs.predict(users, top_k=k),
                                      lambda: [rs.predict(users, top_k=k) for _ in range(3)])
            n = sum(e.count for e in prof.key_averages() if "dot_topk_tc" in e.key)
            if n == 3:
                break
            log(f"[profile] predict top_k={k}: window {take}: {n} top-k kernel records of 3 calls; taken again")
            time.sleep(0.25 * 2**take)
        check(n == 3, f"predict top_k={k}: {n} top-k kernel records in the profile of 3 calls")


def sequence_path(torch, data, net: str):
    """6o, bench.py:266-296 and :415-418's rows at full width: ``net``
    (d=80, history_len=20; SASRec 2 blocks x 2 heads) with AMP, hinge, adam,
    lr 0.05, batch 8192, dynamic negatives: one epoch through the autograd
    step (no kernel but SASRec's layer norms, #8 in bf16, 2 x blocks + 1
    launches of each a step; the rest of the encoder is plain torch), the
    loss and a fixed
    sample's hinge loss finite (printed before and after: one epoch on this
    data need not lower it); evaluate(loss, auc, recall@10) with the loss
    and AUC held to a direct recomputation and the
    ranking metric through #1; predict at top_k=10 (#1), 128 (#2) and with
    exclude_seen, each item checked against the plain top-k (main_path),
    #1/#2 also seen by the profiler; the fit's per-step breakdown. SASRec
    then trains one sampled-softmax epoch at batch 4096: #4 and #5 once per
    step."""
    label = SEQ_LABELS[net]
    t0 = time.perf_counter()
    rs, sample = seeded_recsys(torch, data, False, seed=7, net_type=net, use_amp=True, history_len=20)
    ingest_s = time.perf_counter() - t0
    st = rs.store
    check(tuple(rs.feat["hist_ids"].shape) == (N_USERS, 20), f"{label}: history {tuple(rs.feat['hist_ids'].shape)}")
    fresh = sample_loss(torch, rs, sample)
    kw = dict(epochs=1, batch_size=MLP_B, learning_rate=0.05, optimizer="adam", verbose=False)
    ln0 = ln_launches()
    losses, fit_s, counts = counted(torch, lambda: rs.fit(**kw))
    steps = -(-st.num_train // MLP_B)
    check(not rs.trainer._fused and sum(counts.values()) == 0, f"{label}: fit launched {counts}")
    norms = 2 * rs.model.cfg.sasrec_blocks + 1 if net == "sasrec" else 0
    ln_fit = tuple(b - a for a, b in zip(ln0, ln_launches()))
    check(ln_fit == (norms * steps,) * 2, f"{label}: fit launched the layer-norm kernels {ln_fit} times, "
          f"want {norms} of each a step ({steps} steps)")
    check(len(losses) == 1 and np.isfinite(losses[0]), f"{label}: epoch loss {losses} is not finite")
    trained = sample_loss(torch, rs, sample)
    check(np.isfinite(trained), f"{label}: sample loss {trained}")
    rate = st.num_train / fit_s
    log(f"[train] {label}: RecSys over the data {ingest_s:.3f} s; fit {steps} steps of {MLP_B} in {fit_s:.3f} s = "
        f"{rate:.1f} examples/s; epoch loss {losses[0]:.5f}; sample loss {fresh:.5f} -> {trained:.5f}; launches "
        f"{nonzero(counts)}")
    ev, eval_s, ecounts = counted(torch, lambda: rs.evaluate(
        batch_size=MLP_B, eval_metrics=("loss", "auc", "recall@10"), verbose=False))
    check(np.isfinite(ev["loss"]) and 0 <= ev["auc"] <= 1 and 0 <= ev["recall@10"] <= 1,
          f"{label}: evaluate {ev}")
    n_rank_users = len(np.unique(st.test_users))
    check(nonzero(ecounts) == {"dot_topk_small": -(-n_rank_users // 512)},
          f"{label}: evaluate launched {ecounts}, want #1 once per 512 test users")
    direct = check_seq_evaluate_direct(torch, rs, MLP_B, label)
    log(f"[main] evaluate {label}: {ev} in {eval_s:.3f} s = {st.num_test / eval_s:.1f} rows/s (recall@10 over "
        f"{n_rank_users} users through #1 included); with fixed negatives {direct}; launches {nonzero(ecounts)}")
    users, launches, rates = main_path(torch, rs, " " + label)
    topk_in_profile(torch, rs, users)
    out = {"examples_per_s": rate, "fit_s": fit_s, "eval_rows_per_s": st.num_test / eval_s, "rates": rates,
           "label": label, "launches": {k: launches[k] + ecounts[k] for k in launches}, "ln_launches": ln_fit}
    out["split"] = mlp_breakdown(torch, rs, window=20, label=label)
    if net == "sasrec":
        sm_label = "SASRec AMP softmax"
        losses, sm_s, counts = counted(torch, lambda: rs.fit(
            epochs=1, batch_size=SOFTMAX_B, learning_rate=0.05, loss="sampled_softmax", verbose=False))
        sm_steps = -(-st.num_train // SOFTMAX_B)
        check(nonzero(counts) == {"softmax_ce_fwd": sm_steps, "softmax_ce_bwd": sm_steps},
              f"{sm_label}: fit launched {counts}, want each CE kernel once per step ({sm_steps})")
        check(len(losses) == 1 and np.isfinite(losses[0]), f"{sm_label}: epoch loss {losses}")
        log(f"[train] {sm_label}: fit {sm_steps} steps of {SOFTMAX_B} in {sm_s:.3f} s = "
            f"{st.num_train / sm_s:.1f} examples/s; epoch loss {losses[0]:.5f}; launches {nonzero(counts)}")
        out["softmax"] = {"examples_per_s": st.num_train / sm_s, "launches": counts, "steps": sm_steps}
    return rs, out


def small_sequence_check(torch):
    """6o: a small LSTM and a small SASRec (d=16, history 20, 2 x 2 SASRec,
    f32, dense adagrad: adam turns a cancelling gradient's rounding into a
    step of lr) trained one epoch (16 steps) of bpr on the card and on the
    CPU from one start with the same round keys and the store's static negatives,
    under deterministic algorithms: losses, tables, accumulators and the
    dense tree within tests/test_torch_lstm.py's f32 fit tolerance (rtol=2e-4,
    atol=1e-5); no kernel launches. bpr, not hinge: the small SASRec
    memorizes fast, and under hinge a pair at the kink takes a whole
    update on one device and none on the other (hinge: 5 item rows off by
    up to 1.2e-4 after two epochs, the rest within 1e-6; bpr: all within
    8.4e-7; on an NVIDIA H100 80GB HBM3 at 700 W). Then the small LSTM's RecSys is fitted
    on the card and saved; returns its cold-load job for the child process
    (top_k 10 and 128 through #1/#2, identical ids and values)."""
    from torchrecsys_tpu_torch import RecSys
    from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
    from torchrecsys_tpu_torch.data import prepare_data
    from torchrecsys_tpu_torch.models import build_model
    from torchrecsys_tpu_torch.train import Trainer
    from torchrecsys_tpu_torch.train.optim import tree_map

    r = np.random.default_rng(8)
    data = {"user_id": r.integers(0, 300, 20000), "item_id": r.integers(0, 5000, 20000)}
    store = prepare_data(data, "user_id", "item_id")
    cfg = TrainConfig(batch_size=1000, learning_rate=0.05, dense_optimizer="adagrad", loss="bpr")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for net in ("lstm", "sasrec"):
            mcfg = ModelConfig(net_type=net, n_factors=16, history_len=20)
            trs = {dev: Trainer(build_model(store.schema, mcfg), cfg, dev) for dev in ("cpu", DEVICE)}
            start = trs["cpu"].init_state()
            res = {}
            for dev, tr in trs.items():
                state = dict(start, rng=None, dense_opt=None,
                             tables={k: v.to(dev) for k, v in start["tables"].items()},
                             emb_opt={k: {n: a.to(dev) for n, a in o.items()} for k, o in start["emb_opt"].items()},
                             dense=tree_map(lambda t: t.to(dev), start["dense"]))
                data_d, feat = tr._device_train_data(store), tr.feature_tables(store)
                losses = []
                ws = wrappers()
                for w in ws:
                    w.launches = 0
                state, loss = tr.train_epoch(state, data_d, feat, keys=torch.arange(6).to(dev))
                losses.append(float(loss))
                res[dev] = (np.asarray(losses), state, {w.__name__: w.launches for w in ws})
            (lc, sc, _), (lg, sg, counts) = res["cpu"], res[DEVICE]
            check(not nonzero(counts), f"small {net}: launches {counts}")
            check(np.allclose(lg, lc, rtol=SEQ_SMALL_RTOL, atol=SEQ_SMALL_ATOL),
                  f"small {net}: losses {lg} != CPU {lc}")
            leaves = [(f"table {k}", sg["tables"][k], sc["tables"][k]) for k in sc["tables"]]
            leaves += [(f"acc {k}", sg["emb_opt"][k]["acc"], sc["emb_opt"][k]["acc"]) for k in sc["emb_opt"]]
            leaves += [(f"dense {k}", a, flat_dense(sc["dense"])[k]) for k, a in flat_dense(sg["dense"]).items()]
            err = 0.0
            for name, g, c in leaves:
                g = g.cpu()
                check(torch.allclose(g, c, rtol=SEQ_SMALL_RTOL, atol=SEQ_SMALL_ATOL), f"small {net}: {name}")
                err = max(err, float((g - c).abs().max()))
            log(f"[main] small {net}: card == CPU over 1 epoch (loss {lg.round(6).tolist()}, max |diff| "
                f"{err:.3g} over {len(leaves)} tensors); no launches")
    finally:
        torch.use_deterministic_algorithms(False)
    rs = RecSys(data, net_type="lstm", n_factors=16, history_len=20, device=DEVICE, seed=8)
    rs.fit(epochs=1, batch_size=1000, verbose=False)
    d = ckpt_dir("small_lstm")
    rs.save(d)
    users = rs.store.user_encoder.to_list()[:64]
    ks = (10, 128)
    return {"name": "small LSTM", "dir": d, "users": users, "ks": ks, "warm": serve_outputs(torch, rs, users, ks),
            "config": rs.config}


# ---------------------------------------------------------------------------
# phase 6p: EASE at its published width
# ---------------------------------------------------------------------------

EASE_ITEMS = 30_000  # README.md:150 and BASELINE.md:131's EASE row: 100K users x 30K items
EASE_ITER_ITEMS = 8192  # the JAX package's _EXACT_INV_MAX_N: the iterative solve against the exact one
EASE_RESIDUAL = 1e-3  # the exact solve: max |(A P)_ij| / (A P)_jj over i != j allowed
EASE_N_NEW, EASE_NEW_USERS, EASE_NEW_ITEMS = 100_000, 1_000, 100
EASE_USERS_CHECKED = 256  # the cold load's users


@contextlib.contextmanager
def ease_parts(torch, times: dict):
    """Synchronised timers around EASE._set_pairs, gram and _solve_b (a
    fit's parts: the host CSR, the Gram, the solve; seconds added into
    ``times``) and a recorder of _inv_spd_newton's
    iterations (``times["iterations"]``); the module is restored after."""
    from torchrecsys_tpu_torch.models import ease as em

    real = (em.EASE.gram, em._solve_b, em._inv_spd_newton, em.EASE._set_pairs)

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key] = times.get(key, 0.0) + time.perf_counter() - t
            return out
        return run

    def newton(a, lam_min):
        x, k = real[2](a, lam_min)
        times["iterations"] = k
        return x, k

    em.EASE.gram, em._solve_b, em._inv_spd_newton, em.EASE._set_pairs = (
        timed("gram_s", real[0]), timed("solve_s", real[1]), newton, timed("csr_s", real[3]))
    try:
        yield times
    finally:
        em.EASE.gram, em._solve_b, em._inv_spd_newton, em.EASE._set_pairs = real


def row_lookup(vocab) -> np.ndarray:
    """raw int id -> encoded row, for this data's int ids."""
    vocab = np.asarray(vocab, np.int64)
    out = np.full(int(vocab.max()) + 1, -1, np.int64)
    out[vocab] = np.arange(len(vocab))
    return out


def ease_check_batch(torch, ease, rows, ids, top_k, exclude_seen, label):
    """One predict batch's item rows against a rescoring in f64: each
    user's scores as the f64 sum of B's rows of their train items (those
    items at -inf with ``exclude_seen``); each returned item's f64 score
    equal to the f64 top-k value at its rank within ATOL + RTOL |v| (an id
    may differ only between items that score that value)."""
    ptr, idx = ease.user_ptr, ease.item_idx
    counts = ptr[rows + 1] - ptr[rows]
    flat = np.concatenate([idx[ptr[r] : ptr[r + 1]] for r in rows]).astype(np.int64)
    rr = torch.as_tensor(np.repeat(np.arange(len(rows)), counts), device=DEVICE)
    ft = torch.as_tensor(flat, device=DEVICE)
    s = torch.zeros((len(rows), ease.num_items), dtype=torch.float64, device=DEVICE)
    s.index_add_(0, rr, ease.b[ft].double())
    if exclude_seen:
        s[rr, ft] = -float("inf")
    want = torch.sort(s, dim=1, descending=True, stable=True)[0][:, :top_k]
    got = torch.gather(s, 1, torch.as_tensor(ids, device=DEVICE))
    check(bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all()),
          f"{label}: predict's items do not score the f64 top-{top_k}")


def small_ease_check(torch):
    """6p card against CPU: a small EASE (3,000 users x 700 items, 20,000
    interactions, lam=10): G on the card's TF32 tensor cores bit-identical
    to the CPU's IEEE f32 G; B within rtol=1e-5, atol=1e-6 (two LU
    factorizations: cuSOLVER's and LAPACK's); scores within rtol=1e-5,
    atol=1e-5; predict ids identical for 40 users, with and without
    exclude_seen."""
    from torchrecsys_tpu_torch.models import EASE

    r = np.random.default_rng(10)
    u, i = r.integers(0, 3000, 20000), r.integers(0, 700, 20000)
    m = {dev: EASE(3000, 700, lam=10.0, device=dev) for dev in ("cpu", DEVICE)}
    for e in m.values():
        e._set_pairs(u, i)
    g_cpu, g_card = m["cpu"].gram(512), m[DEVICE].gram(512).cpu()
    check(torch.equal(g_card, g_cpu), "small EASE: the card's G differs from the CPU's")
    for e in m.values():
        e.fit(u, i, user_chunk=512)
    bc, bg = m["cpu"].b, m[DEVICE].b.cpu()
    check(torch.allclose(bg, bc, rtol=1e-5, atol=1e-6), "small EASE: B differs from the CPU's")
    users = np.arange(0, 3000, 75)
    sc, sg = m["cpu"].scores(users), m[DEVICE].scores(users).cpu()
    check(torch.allclose(sg, sc, rtol=1e-5, atol=1e-5), "small EASE: scores differ from the CPU's")
    for user in users:
        for excl in (True, False):
            check(np.array_equal(m[DEVICE].predict(int(user), 20, excl), m["cpu"].predict(int(user), 20, excl)),
                  f"small EASE: user {user} exclude_seen={excl}: card ids != CPU ids")
    log(f"[main] small EASE: G card == CPU bit for bit (max count {float(g_cpu.max()):.0f}); max |B diff| "
        f"{float((bg - bc).abs().max()):.3g}; max |score diff| {float((sg - sc).abs().max()):.3g}; predict ids "
        f"identical for {len(users)} users x 2")


def ease_new_interactions(seed: int = 2):
    """EASE_N_NEW rows for update_data: known users and items, with
    EASE_NEW_USERS new users and EASE_NEW_ITEMS new items mixed in."""
    r = np.random.default_rng(seed)
    users = r.integers(0, N_USERS + EASE_NEW_USERS, EASE_N_NEW)
    items = r.integers(0, EASE_ITEMS + EASE_NEW_ITEMS, EASE_N_NEW)
    users[:EASE_NEW_USERS] = N_USERS + np.arange(EASE_NEW_USERS)
    items[:EASE_NEW_ITEMS] = EASE_ITEMS + np.arange(EASE_NEW_ITEMS)
    return {"user_id": users.astype(np.int64), "item_id": items.astype(np.int64)}


def ease_residual(torch, ease, em):
    """G again, on the TF32 tensor cores and as an IEEE f32 product (bit
    for bit equal), then the exact solve's residual without P: B = I -
    P diag(P)^-1, so A (I - B) = A P diag(P)^-1 and (A (I - B))_ij /
    (A (I - B))_jj = (A P)_ij / (A P)_jj. Returns the largest and the rms
    off-diagonal |.| of that ratio and G's largest count."""
    g = ease.gram()
    g_ieee = torch.zeros_like(g)
    with em._tf32(ease.device, False):
        for lo in range(0, ease.num_users, 4096):
            x = ease._rows(np.arange(lo, min(lo + 4096, ease.num_users)))
            g_ieee.addmm_(x.T, x)
    check(torch.equal(g, g_ieee), "EASE: the TF32 Gram differs from the IEEE f32 product")
    del g_ieee, x
    g_max = float(g.max())
    check(g_max < 2**24, f"EASE: a count {g_max} past f32's exact integers")
    g.diagonal().add_(ease.lam)
    ib = -ease.b
    ib.diagonal().add_(1.0)
    with em._tf32(ease.device, False):
        m = g @ ib
    del g, ib
    m.div_(torch.diagonal(m).clone()[None, :])
    m.diagonal().zero_()
    res_max, res_rms = float(m.abs().max()), float(m.square().mean().sqrt())
    del m
    torch.cuda.empty_cache()
    return res_max, res_rms, g_max


def ease_path(torch):
    """6p: ``RecSys(net_type="ease")`` at README.md:150's width (100K users
    x 30K items, 3M interactions from bench.py:98-110's generator): fit
    (Gram and solve seconds, peak device memory; no kernel launch), G
    bit-identical to an IEEE f32 product and the solve's residual bounded,
    diag(B) == 0; evaluate(recall@10, hit_rate@10, ndcg@10) above a random
    top-10's hit rate; 256-user predict batches at top_k=10, 128 and
    exclude_seen (users/s), each batch's ids held to an f64 rescoring;
    similar_items; save (its cold load rides 6n's child process);
    update_data, predict refused until the refit, the refit (seconds);
    the Newton-Schulz solve at 8192 items against the exact one within
    the JAX package's rtol=1e-3, atol=1e-4."""
    from torchrecsys_tpu_torch import RecSys
    from torchrecsys_tpu_torch.models import EASE
    from torchrecsys_tpu_torch.models import ease as em

    small_ease_check(torch)
    t0 = time.perf_counter()
    rs = RecSys(synthetic_interactions(n_items=EASE_ITEMS), net_type="ease", device=DEVICE)
    ingest_s = time.perf_counter() - t0
    st, ease = rs.store, rs.ease
    check(rs.model is None and rs.config["num_users"] == N_USERS and rs.config["num_items"] == EASE_ITEMS,
          f"EASE: config {rs.config}")
    train_users, train_items = st.train_users, st.train_items
    times: dict = {}
    torch.cuda.reset_peak_memory_stats()
    with ease_parts(torch, times):
        losses, fit_s, counts = counted(torch, rs.fit)
    peak = torch.cuda.max_memory_allocated()
    check(losses == [] and not nonzero(counts), f"EASE: fit returned {losses}, launched {counts}")
    b = ease.b
    check(tuple(b.shape) == (EASE_ITEMS, EASE_ITEMS) and int(torch.count_nonzero(torch.diagonal(b))) == 0
          and bool(torch.isfinite(b).all()), "EASE: B is not finite with a zero diagonal")
    res_max, res_rms, g_max = ease_residual(torch, ease, em)
    check(res_max <= EASE_RESIDUAL, f"EASE: the solve's residual {res_max:.3g} is above {EASE_RESIDUAL}")
    log(f"[train] EASE: RecSys over {N_INTERACTIONS} interactions {ingest_s:.2f} s; fit {fit_s:.3f} s (host CSR "
        f"{times['csr_s']:.3f} s, Gram {times['gram_s']:.3f} s, solve {times['solve_s']:.3f} s), peak device memory {peak / 2**30:.2f} GiB; "
        f"nnz {ease.nnz}; G (largest count {g_max:.0f}) on the TF32 tensor cores == the IEEE f32 product bit for "
        f"bit; (A P)_ij / (A P)_jj off the diagonal: max {res_max:.3g}, rms {res_rms:.3g}; diag(B) == 0")
    keys = train_users.astype(np.int64) * EASE_ITEMS + train_items
    t0 = time.perf_counter()
    np.unique(keys)
    t1 = time.perf_counter()
    np.sort(keys)
    log(f"[train] EASE: numpy {np.__version__} on this host: np.unique of the {len(keys)} train keys "
        f"{t1 - t0:.3f} s, np.sort {time.perf_counter() - t1:.3f} s (the host CSR dedups after a sort)")
    metrics = ("recall@10", "hit_rate@10", "ndcg@10")
    ev, eval_s, counts = counted(torch, lambda: rs.evaluate(eval_metrics=metrics, verbose=False))
    uniq, inv = np.unique(st.test_users, return_inverse=True)
    rand_hit = float(np.mean(1 - (1 - 10 / EASE_ITEMS) ** np.bincount(inv)))
    check(not nonzero(counts) and all(0 <= ev[m] <= 1 for m in metrics) and ev["hit_rate@10"] > 3 * rand_hit,
          f"EASE: evaluate {ev} (a random top-10 hits {rand_hit:.4g}), launches {counts}")
    log(f"[main] evaluate EASE: {ev} in {eval_s:.3f} s over {len(uniq)} test users ({st.num_test} rows; a random "
        f"top-10's hit rate {rand_hit:.4g})")
    user_row, item_row = row_lookup(st.user_encoder.to_list()), row_lookup(st.item_encoder.to_list())
    users = st.user_encoder.to_list()
    batches = [users[s : s + U] for s in range(0, 40 * U, U)]
    rates = {}
    for case, top_k, excl in (("top_k=10", 10, False), ("top_k=128", 128, False), ("exclude_seen top_k=10", 10, True)):
        rs.predict(batches[0], top_k=top_k, exclude_seen=excl)  # warm-up
        outs, secs, counts = counted(torch, lambda: [rs.predict(bt, top_k=top_k, exclude_seen=excl)
                                                     for bt in batches[1:]])
        check(not nonzero(counts), f"EASE predict {case}: launches {counts}")
        rates[case] = U * len(outs) / secs
        for bt, out in zip(batches[1:], outs):
            ease_check_batch(torch, ease, user_row[np.asarray(bt)], item_row[out], top_k, excl, f"EASE {case}")
        log(f"[main] predict EASE {case}: {len(outs)} batches of {U} users, {rates[case]:.1f} users/s; every "
            f"batch's items score the f64 top-{top_k}")
    items = st.item_encoder.to_list()[:64]
    sims, sim_s, _ = counted(torch, lambda: [rs.similar_items(it, top_k=10) for it in items])
    for it, sim in zip(items, sims):
        r = int(item_row[it])
        w = b[r].clone()
        w[r] = -float("inf")
        want = torch.sort(w, descending=True, stable=True)[0][:10]
        check(r not in item_row[sim] and torch.equal(b[r][torch.as_tensor(item_row[sim], device=DEVICE)], want),
              f"EASE similar_items({it}) is not the top of B's row")
    d = ckpt_dir("ease")
    _, save_s, _ = counted(torch, lambda: rs.save(d))
    job_users = users[:EASE_USERS_CHECKED]
    job = {"name": "EASE", "dir": d, "users": job_users, "ks": (10, 128),
           "warm": serve_outputs(torch, rs, job_users, (10, 128)), "config": dict(rs.config)}
    log(f"[main] EASE similar_items: 64 items in {sim_s:.3f} s, each the top of its B row; save "
        f"{ckpt_bytes(d) / 2**20:.1f} MiB in {save_s:.3f} s")
    _, update_s, _ = counted(torch, lambda: rs.update_data(ease_new_interactions()))
    try:
        rs.predict(users[:2])
        refused = False
    except RuntimeError:
        refused = True
    check(refused and rs.ease.b is None, "EASE: predict served between update_data and the refit")
    st2 = rs.store
    check(rs.config["num_users"] == N_USERS + EASE_NEW_USERS and rs.config["num_items"] == EASE_ITEMS
          + EASE_NEW_ITEMS, f"EASE: grown config {rs.config}")
    refit_times: dict = {}
    with ease_parts(torch, refit_times):
        _, refit_s, counts = counted(torch, rs.fit)
    n2 = EASE_ITEMS + EASE_NEW_ITEMS
    want_nnz = len(np.unique(st2.train_users.astype(np.int64) * n2 + st2.train_items))
    check(rs.ease.nnz == want_nnz and not nonzero(counts) and int(torch.count_nonzero(torch.diagonal(rs.ease.b))) == 0,
          f"EASE refit: nnz {rs.ease.nnz} (want {want_nnz}), launches {counts}")
    new_users = list(range(N_USERS, N_USERS + U))
    got = rs.predict(new_users, top_k=10, exclude_seen=True)
    check(got.shape == (U, 10), f"EASE: new users' predict {got.shape}")
    log(f"[ckpt] EASE update_data of {EASE_N_NEW} interactions ({EASE_NEW_USERS} new users, {EASE_NEW_ITEMS} new "
        f"items) {update_s:.3f} s on the host, predict refused until the refit; refit {refit_s:.3f} s (host CSR "
        f"{refit_times['csr_s']:.3f} s, Gram {refit_times['gram_s']:.3f} s, solve {refit_times['solve_s']:.3f} s), nnz {rs.ease.nnz}")
    del rs, ease, b
    torch.cuda.empty_cache()
    keep = train_items < EASE_ITER_ITEMS
    solves = {}
    for solve in ("exact", "iterative"):
        e, t = EASE(N_USERS, EASE_ITER_ITEMS, device=DEVICE), {}
        with ease_parts(torch, t):
            _, secs, _ = counted(torch, lambda: e.fit(train_users[keep], train_items[keep], solve=solve))
        solves[solve] = (e.b, t, secs)
    (bx, tx, sx), (bi, ti, si) = solves["exact"], solves["iterative"]
    diff = (bi - bx).abs()
    check(bool(torch.allclose(bi, bx, rtol=1e-3, atol=1e-4)), f"EASE iterative at {EASE_ITER_ITEMS} items: max "
          f"|diff| {float(diff.max()):.3g} beyond rtol=1e-3, atol=1e-4")
    log(f"[main] EASE Newton-Schulz at {EASE_ITER_ITEMS} items ({int(keep.sum())} train rows): {ti['iterations']} "
        f"iterations, solve {ti['solve_s']:.3f} s (exact {tx['solve_s']:.3f} s; fits {si:.3f} / {sx:.3f} s), "
        f"max |B diff| {float(diff.max()):.3g} within rtol=1e-3, atol=1e-4")
    del solves, bx, bi, diff
    torch.cuda.empty_cache()
    return {"job": job, "fit_s": fit_s, "csr_s": times["csr_s"], "gram_s": times["gram_s"], "solve_s": times["solve_s"], "peak": peak,
            "eval_s": eval_s, "eval": ev, "rates": rates, "save_s": save_s, "update_s": update_s,
            "refit_s": refit_s, "iter_s": ti["solve_s"], "iterations": ti["iterations"], "res_max": res_max}


# ---------------------------------------------------------------------------
# phase 6q: the streaming fit
# ---------------------------------------------------------------------------

STREAM_SB, STREAM_MLP_SB, STREAM_SOFTMAX_SB = 1 << 17, 1 << 20, 1 << 19


def stream_steps(n: int, sb: int, b: int) -> int:
    """Steps of a streamed epoch: each chunk's ceil(rows / b)."""
    return sum(-(-min(sb, n - s) // b) for s in range(0, n, sb))


def _union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        tot += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def stream_overlap(prof, wall_us: float) -> dict:
    """From a profiled streamed epoch's records: the chunk copies (the
    host-to-device copies on a stream no kernel ran on: count, device ms,
    streams), the other copies, the kernels' streams, the chunk-copy time
    during which no kernel ran (exposed), the chunk copies that overlap a
    kernel and a step kernel, and the device's idle share over the
    window."""
    copies, kernels, steps = [], [], []
    kernel_streams = set()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if "spin_kernel" in name or "Memset" in name:
            continue
        if "Memcpy HtoD" in name:
            copies.append((e.start_ns(), e.end_ns(), e.device_resource_id()))
        elif str(e.device_type()).endswith("CUDA"):
            kernels.append((e.start_ns(), e.end_ns()))
            kernel_streams.add(e.device_resource_id())
            if "fused_pairwise" in name:
                steps.append((e.start_ns(), e.end_ns()))
    side = [(a, b) for a, b, sid in copies if sid not in kernel_streams]
    cu, ku, su = _union(side), _union(kernels), _union(steps)
    copy_ns = sum(e - s for s, e in cu)
    busy_ns = sum(e - s for s, e in _union([(a, b) for a, b, _ in copies] + kernels))
    return {"copies": len(side), "other_copies": len(copies) - len(side), "copy_ms": copy_ns / 1e6,
            "exposed_ms": (copy_ns - _overlap(cu, ku)) / 1e6,
            "over_kernels": sum(1 for c in side if _overlap([list(c)], ku) > 0),
            "over_steps": sum(1 for c in side if _overlap([list(c)], su) > 0),
            "copy_streams": sorted({sid for _, _, sid in copies if sid not in kernel_streams}),
            "kernel_streams": sorted(kernel_streams), "idle_share": 1 - busy_ns / 1e3 / wall_us}


def stream_chunk_parts(torch, tr, rs, rows: int) -> dict:
    """Host ms (synchronised) of the parts of one ``train_epoch`` over the
    first ``rows`` train rows of ``rs``'s store: the epoch build (and,
    alone, the Feistel permutation it starts with: a host-synced pass of
    ~85 launches per cycle-walking step), the table pack, the steps and
    the unpack (a streamed epoch pays each once per chunk). Launches here
    are a measurement and are not counted."""
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp
    from torchrecsys_tpu_torch.utils.permute import random_permutation

    st = rs.store
    data = {k: torch.as_tensor(v[:rows], device=DEVICE).long()
            for k, v in (("user_id", st.train_users), ("pos_item_id", st.train_items))}
    feat, saved, parts = tr.feature_tables(st), step_launches(fp), {}
    state = clone_state(torch, rs.state)

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = (time.perf_counter() - t) * 1e3
        return out

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    timed("permutation", lambda: random_permutation(torch.arange(6, device=DEVICE), rows))
    ep = timed("build", lambda: tr.build_epoch(data, torch.arange(6, device=DEVICE), gen, feat))
    packed = timed("pack", lambda: tr.pack_state(state))
    timed("steps", lambda: tr.run_steps(packed, ep, feat, step0=state["step"]))
    timed("unpack", lambda: tr.unpack_state(state, packed, ep.nb))
    set_step_launches(fp, saved)
    return parts


def streaming_path(torch, data):
    """6q, train/streaming.py at this data's depth (2.4M train rows; cut
    from benchmarks/STREAMING.md's 200M, PERF.md §4): (i) Linear with the
    category column, hinge, batch 1024, ``fit_streaming(superbatch_size=
    2^17)``: 19 chunks, #3 once per step and nothing else, every chunk the
    split's rows of its index in the JAX order, int64, the sample loss
    falls; streamed against resident examples/s (resident, streamed,
    streamed, resident); a profiled streamed epoch: the copies on a side
    stream, overlapping the step kernels, the exposed copy time. (ii) one
    chunk of the whole split against the resident epoch from one state and
    keys, by 6n's rule (6m's tolerance, at most max(64, 2 x the noise
    floor's) rows). (iii) the north-star AMP MLP at 2^20: #6/#7 twice per
    step. (iv) sampled softmax at batch 4096 and 2^19: #4/#5 once per
    step."""
    from torchrecsys_tpu_torch.config import TrainConfig
    from torchrecsys_tpu_torch.train import Trainer

    label = "streamed Linear metadata"
    rs, sample = seeded_recsys(torch, data, True, seed=12)
    st, n = rs.store, rs.store.num_train
    tr = rs._ensure_trainer(TrainConfig(batch_size=TRAIN_B, epochs=1, learning_rate=1e-2, dynamic_neg_sampling=True,
                                        seed=rs.seed))
    fresh = sample_loss(torch, rs, sample)
    chunks, real = [], tr.train_epoch

    def recording(state, data_, feat, keys=None, negatives=None):
        chunks.append(data_)
        return real(state, data_, feat, keys=keys, negatives=negatives)

    def streamed(sb=STREAM_SB, trainer=tr, r=rs, **kw):
        state, losses = trainer.fit_streaming(r.state, r.store, superbatch_size=sb, epochs=1, verbose=False, **kw)
        r._install(state)
        return losses

    tr.train_epoch = recording
    try:
        losses, secs, counts = counted(torch, streamed)
    finally:
        del tr.train_epoch
    steps = stream_steps(n, STREAM_SB, TRAIN_B)
    n_chunks = -(-n // STREAM_SB)
    check(nonzero(counts) == {"fused_pairwise_step_meta": steps}, f"{label}: launched {counts}, want #3 once per "
          f"step ({steps})")
    check(len(losses) == 1 and np.isfinite(losses[0]) and len(chunks) == n_chunks, f"{label}: losses {losses}, "
          f"{len(chunks)} chunks")
    order = np.random.default_rng(0).permutation(n_chunks)
    cols = {"user_id": st.train_users, "pos_item_id": st.train_items}
    for j, c in enumerate(chunks):
        lo = int(order[j]) * STREAM_SB
        check(sorted(c) == sorted(cols), f"{label}: chunk columns {sorted(c)}")
        for k, v in cols.items():
            check(c[k].dtype == torch.int64 and torch.equal(c[k], torch.as_tensor(v[lo : lo + STREAM_SB],
                                                                                  device=DEVICE).long()),
                  f"{label}: chunk {j} is not rows {lo}.. of the split")
    del chunks
    trained = sample_loss(torch, rs, sample)
    check(trained < fresh, f"{label}: sample loss {fresh} -> {trained}")
    launches = dict(counts)
    log(f"[train] {label}: fit_streaming of {n} rows in {n_chunks} chunks of {STREAM_SB} in {secs:.3f} s, "
        f"{steps} steps of {TRAIN_B}; epoch loss {losses[0]:.5f}; sample loss {fresh:.5f} -> {trained:.5f}; every "
        f"chunk the split's rows of its index (int64), in the JAX stream's order; launches {nonzero(counts)}")
    rates = {"resident": [], "streamed": []}
    for kind in ("resident", "streamed", "streamed", "resident"):
        run = streamed if kind == "streamed" else (lambda: rs.fit(epochs=1, batch_size=TRAIN_B, verbose=False))
        _, secs, _ = counted(torch, run)
        rates[kind].append(n / secs)
    log(f"[train] {label}: examples/s in turns, resident {[round(x, 1) for x in rates['resident']]}, streamed "
        f"{[round(x, 1) for x in rates['streamed']]}")
    chunk, whole = (stream_chunk_parts(torch, tr, rs, rows) for rows in (STREAM_SB, n))
    log(f"[breakdown] {label}: host ms of one train_epoch's parts over a chunk of {STREAM_SB} rows "
        f"{ {k: round(v, 3) for k, v in chunk.items()} } (x {n_chunks} chunks) and over the resident {n} rows "
        f"{ {k: round(v, 3) for k, v in whole.items()} }")
    # torch.profiler can drop a window's first records late in a whole run
    # (profiled_window); a window short of chunk copies is taken once more
    for take in (1, 2):
        prof, wall_us = profiled_window(torch, torch.cuda.synchronize, streamed)
        ov = stream_overlap(prof, wall_us)
        if ov["copies"] == 2 * n_chunks:
            break
        log(f"[profile] {label}: window {take}: {ov['copies']} chunk-copy records of the {2 * n_chunks} copies "
            f"issued")
    check(ov["copies"] >= n_chunks and len(ov["copy_streams"]) == 1, f"{label}: the profiled epoch's "
          f"copies {ov}, want the {2 * n_chunks} chunk copies on one side stream")
    log(f"[profile] {label}: {ov['copies']} chunk copies ({ov['copy_ms']:.3f} ms of device time) on stream(s) "
        f"{ov['copy_streams']}, kernels on {ov['kernel_streams']} ({ov['other_copies']} other copies there); "
        f"{ov['over_kernels']} chunk copies overlap a kernel, {ov['over_steps']} a step kernel; copy time with no "
        f"kernel running {ov['exposed_ms']:.3f} ms of a {wall_us / 1e3:.3f} ms epoch; device idle share "
        f"{ov['idle_share']:.3f}")
    # (ii) one chunk of the whole split against the resident epoch, from one state and one set of keys
    data_d, feat = tr._device_train_data(st), tr.feature_tables(st)
    keys = torch.arange(6, device=DEVICE) * 13 + 3
    start = clone_state(torch, dict(rs.state, rng=tr._rng(dict(rs.state))))
    res = [tr.train_epoch(clone_state(torch, start), data_d, feat, keys=keys) for _ in range(2)]
    one_state, one_loss = tr.fit_streaming(clone_state(torch, start), st, superbatch_size=n, epochs=1,
                                           verbose=False, keys=[keys])
    floor = state_diff(torch, res[1][0], res[0][0])
    bad, worst = resume_compare(torch, f"{label} one chunk", one_state, res[0][0], floor)
    loss_res = float(res[0][1])
    check(abs(one_loss[0] - loss_res) <= RESUME_ATOL + RESUME_RTOL * abs(loss_res),
          f"{label} one chunk: loss {one_loss[0]} != resident {loss_res}")
    log(f"[train] {label}: one chunk of {n} rows against the resident epoch from one state and keys: loss "
        f"{one_loss[0]:.7f} / {loss_res:.7f}, max |diff| {worst:.3g}, rows beyond rtol={RESUME_RTOL}/atol="
        f"{RESUME_ATOL} {bad} (noise floor {nonzero({k: v[0] for k, v in floor.items()})})")
    # (iv) sampled softmax at 4096 on the same model: a resident epoch, then a streamed one
    trs = rs._ensure_trainer(TrainConfig(batch_size=SOFTMAX_B, epochs=1, learning_rate=1e-2, loss="sampled_softmax",
                                         dynamic_neg_sampling=True, seed=rs.seed))
    _, sm_res_s, _ = counted(torch, lambda: rs.fit(epochs=1, batch_size=SOFTMAX_B, loss="sampled_softmax",
                                                   verbose=False))
    check(rs.trainer is trs, "streamed softmax: the resident fit took another trainer")
    sm_losses, sm_s, counts = counted(torch, lambda: streamed(STREAM_SOFTMAX_SB, trs))
    sm_steps = stream_steps(n, STREAM_SOFTMAX_SB, SOFTMAX_B)
    check(nonzero(counts) == {"softmax_ce_fwd": sm_steps, "softmax_ce_bwd": sm_steps} and np.isfinite(sm_losses[0]),
          f"streamed softmax: launched {counts}, want #4 and #5 once per step ({sm_steps}); loss {sm_losses}")
    launches = {k: launches[k] + counts[k] for k in launches}
    log(f"[train] streamed Linear metadata softmax: {n} rows in chunks of {STREAM_SOFTMAX_SB}, {sm_steps} steps of "
        f"{SOFTMAX_B} in {sm_s:.3f} s = {n / sm_s:.1f} examples/s (resident, just before: {n / sm_res_s:.1f}); "
        f"loss {sm_losses[0]:.5f}; launches {nonzero(counts)}")
    del rs, tr, trs, start, res, one_state, data_d, feat
    torch.cuda.empty_cache()
    # (iii) the north-star AMP MLP at 2^20
    rm, _ = seeded_mlp(data, use_amp=True)
    trm = rm._ensure_trainer(TrainConfig(batch_size=MLP_B, epochs=1, learning_rate=0.05, dynamic_neg_sampling=True,
                                         seed=rm.seed))
    _, mlp_res_s, _ = counted(torch, lambda: rm.fit(epochs=1, batch_size=MLP_B, learning_rate=0.05, verbose=False))
    check(rm.trainer is trm, "streamed MLP: the resident fit took another trainer")
    mlp_losses, mlp_s, counts = counted(torch, lambda: streamed(STREAM_MLP_SB, trm, rm))
    mlp_steps = stream_steps(n, STREAM_MLP_SB, MLP_B)
    want = len(MLP_HIDDEN) * mlp_steps
    check(nonzero(counts) == {"fused_tower_fwd": want, "fused_tower_bwd": want} and np.isfinite(mlp_losses[0]),
          f"streamed MLP AMP: launched {counts}, want #6 and #7 twice per step ({want}); loss {mlp_losses}")
    launches = {k: launches[k] + counts[k] for k in launches}
    log(f"[train] streamed MLP AMP: {n} rows in chunks of {STREAM_MLP_SB}, {mlp_steps} steps of {MLP_B} in "
        f"{mlp_s:.3f} s = {n / mlp_s:.1f} examples/s (resident, just before: {n / mlp_res_s:.1f}); loss "
        f"{mlp_losses[0]:.5f}; launches {nonzero(counts)}")
    del rm, trm
    torch.cuda.empty_cache()
    return {"launches": launches, "rates": rates, "overlap": ov, "wall_ms": wall_us / 1e3,
            "softmax_rate": n / sm_s, "mlp_rate": n / mlp_s, "softmax_resident": n / sm_res_s,
            "mlp_resident": n / mlp_res_s, "steps": steps, "chunks": n_chunks, "chunk_parts": chunk,
            "whole_parts": whole}


# ---------------------------------------------------------------------------
# phase 6n: checkpoints and incremental training
# ---------------------------------------------------------------------------

CKPT_ROOT = "smoke_ckpt"  # under the checkout (.gitignore); removed at the end of the run
N_NEW, NEW_USERS, NEW_ITEMS, NEW_CATS = 300_000, 20_000, 100_000, 50
RESUME_RTOL, RESUME_ATOL = 1e-4, 1e-5  # 6m's
RESUME_ROWS = 64  # rows per table a hinge flip may move past them (see resume_compare)
COLD_SERVE = """
import sys
import chip_smoke
sys.exit(chip_smoke.cold_serve_main(sys.argv[1], sys.argv[2]))
"""


def ckpt_dir(name: str) -> str:

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), CKPT_ROOT, name)


def ckpt_bytes(directory: str) -> int:

    return sum(os.path.getsize(os.path.join(directory, f)) for f in os.listdir(directory))


def serve_outputs(torch, rs, users, ks):
    """For each k: the top-k values and item rows of ``users`` through the
    facade's scorer (catalog_topk with the kept catalog: #1 for k <= 16,
    #2 above; the chunked scorer for the MLP; EASE's scores and stable
    top-k) and ``predict``'s raw ids."""
    from torchrecsys_tpu_torch.eval.predict import catalog_topk
    from torchrecsys_tpu_torch.models.ease import topk_rows

    rows = torch.as_tensor([rs.store.user_encoder.encode_one(u) for u in users], device=rs.device)
    out = {}
    for k in ks:
        if rs.ease is not None:  # EASE: X[u] @ B, then the stable top-k
            vals, ids = topk_rows(rs.ease.scores(rows.cpu().numpy()), k)
            out[k] = (vals.float().cpu().numpy(), ids.cpu().numpy(), rs.predict(users, top_k=k))
            continue
        cat = rs._linearized() if rs.model.supports_linearized_catalog else None
        vals, ids = catalog_topk(rs.model, rs._params(), rs.state["model_state"], rows, rs.store.schema.num_items,
                                 rs.feat, top_k=k, catalog=cat)
        out[k] = (vals.float().cpu().numpy(), ids.cpu().numpy(), rs.predict(users, top_k=k))
    return out


def cold_serve_main(jobs_path: str, out_path: str) -> int:
    """The child process of 6n: ``RecSys.load`` each checkpoint of the jobs
    file cold (no dataset) and serve its users; write the outputs, the
    load seconds and the launch counts. ``exclude_seen`` must raise."""
    import pickle

    import torch

    from torchrecsys_tpu_torch import RecSys

    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    results = {}
    for job in jobs:
        cold, load_s, counts = counted(torch, lambda: RecSys.load(job["dir"], device=DEVICE))
        check(sum(counts.values()) == 0, f"cold load {job['name']} launched {counts}")
        out, serve_s, counts = counted(torch, lambda: serve_outputs(torch, cold, job["users"], job["ks"]))
        try:
            cold.predict(job["users"][:2], top_k=10, exclude_seen=True)
            raised = False
        except ValueError:
            raised = True
        results[job["name"]] = {"out": out, "load_s": load_s, "serve_s": serve_s, "counts": counts,
                                "exclude_seen_raised": raised, "config": cold.config}
        del cold
        torch.cuda.empty_cache()
    with open(out_path, "wb") as f:
        pickle.dump(results, f)
    return 0


def run_cold_children(torch, jobs):
    """One child process (``sys.executable``, as step_trap_check runs its
    children) loads every checkpoint of ``jobs`` cold and serves; each
    output must equal the parent's warm one bit for bit. Returns the
    child's per-job results (load seconds, launch counts)."""
    import pickle

    root = os.path.dirname(os.path.abspath(__file__))
    jobs_path, out_path = ckpt_dir("jobs.pkl"), ckpt_dir("results.pkl")
    with open(jobs_path, "wb") as f:
        pickle.dump([{k: j[k] for k in ("name", "dir", "users", "ks")} for j in jobs], f)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", COLD_SERVE, jobs_path, out_path], cwd=root, capture_output=True,
                       text=True, timeout=600)
    child_s = time.perf_counter() - t0
    check(r.returncode == 0, f"the cold-load child failed (exit {r.returncode}): {(r.stdout + r.stderr)[-2000:]}")
    with open(out_path, "rb") as f:
        results = pickle.load(f)
    for job in jobs:
        res = results[job["name"]]
        check(res["exclude_seen_raised"], f"{job['name']}: exclude_seen on the cold model did not raise")
        check(res["config"] == job["config"], f"{job['name']}: cold config {res['config']} != {job['config']}")
        for k, (vals, ids, raw) in job["warm"].items():
            cv, ci, cr = res["out"][k]
            check(np.array_equal(cv, vals) and np.array_equal(ci, ids) and np.array_equal(cr, raw),
                  f"{job['name']} top_k={k}: the cold load serves other ids or values than the warm model")
        log(f"[ckpt] {job['name']}: cold RecSys.load in a child process {res['load_s']:.3f} s, serving "
            f"{len(job['users'])} users at top_k {list(job['ks'])} {res['serve_s']:.3f} s: ids, values and "
            f"raw ids identical to the warm model's; exclude_seen raised; launches {nonzero(res['counts'])}")
    log(f"[ckpt] the child process ran {child_s:.2f} s (start, imports, CUDA context, every load)")
    return results


def clone_state(torch, state):
    """A deep copy of a train state (tensors cloned, the generator's state
    copied)."""
    def dup(x):
        if isinstance(x, torch.Generator):
            g = torch.Generator(device=x.device)
            g.set_state(x.get_state())
            return g
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, dict):
            return {k: dup(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [dup(v) for v in x]
        return x

    return dup(state)


def flat_state(state) -> dict:
    """name -> tensor of the tables, accumulators, dense weights, model
    state and dense optimizer state."""
    out = {f"tables.{k}": v for k, v in state["tables"].items()}
    out.update({f"acc.{k}": o["acc"] for k, o in state["emb_opt"].items() if "acc" in o})
    for part in ("dense", "model_state", "dense_opt"):
        for k, v in flat_dense(state.get(part) or {}).items():
            out[f"{part}.{k}"] = v
    return out


def state_diff(torch, got, want) -> dict:
    """name -> (rows beyond rtol=1e-4, atol=1e-5, max |diff|) of every leaf
    of ``got`` against ``want`` (flat_state); an int leaf (a count) must
    be equal."""
    fg, fw = flat_state(got), flat_state(want)
    check(fg.keys() == fw.keys(), f"the state leaves differ: {sorted(fg.keys() ^ fw.keys())}")
    out = {}
    for name, w in fw.items():
        g = fg[name]
        if not isinstance(w, torch.Tensor):
            check(g == w, f"{name}: {g} != {w}")
            continue
        check(g.shape == w.shape and g.dtype == w.dtype, f"{name}: {g.shape} {g.dtype} != {w.shape} {w.dtype}")
        if not g.numel():
            continue
        gf, wf = g.float(), w.float()
        bad = (gf - wf).abs() > RESUME_ATOL + RESUME_RTOL * wf.abs()
        rows = int(bad.reshape(bad.shape[0], -1).any(dim=1).sum()) if bad.dim() else int(bad)
        out[name] = (rows, float((gf - wf).abs().max()))
    return out


def resume_compare(torch, label, got, want, floor=None, skip=()):
    """A resumed run's state against the in-memory run's: every leaf within
    rtol=1e-4, atol=1e-5 (6m's), except at most max(RESUME_ROWS, 2 x the
    noise floor's) rows of a table or accumulator: the step kernel's
    atomics add in no fixed order, and a batch row within rounding of the
    hinge kink takes the other subgradient (``floor``: state_diff of two
    in-memory runs from one state). Leaves whose last name is in ``skip``
    are printed only. Returns (rows beyond per leaf, largest |diff|)."""
    bad, worst, printed = {}, 0.0, {}
    for name, (n, diff) in state_diff(torch, got, want).items():
        if name.split(".")[-1] in skip:
            printed[name] = f"{diff:.3g}"
            continue
        worst = max(worst, diff)
        table = name.startswith(("tables.", "acc."))
        allowed = max(RESUME_ROWS, 2 * (floor or {}).get(name, (0, 0))[0]) if table else 0
        check(n <= allowed, f"{label}: {name}: {n} rows beyond rtol={RESUME_RTOL}/atol={RESUME_ATOL} "
              f"(allowed {allowed}; max |diff| {diff:.3g})")
        if n:
            bad[name] = n
    if printed:
        log(f"[ckpt] {label}: max |diff| of the leaves printed only: {printed}")
    return bad, worst


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def checkpoint_paths(torch, rs, data):
    """6n a, b and d on the Linear metadata model of 6a (its trained state):
    save, restore into a fresh RecSys, the cold load's outputs (checked in
    the child run by run_cold_children), resume, grow. Returns the jobs
    for the child and the numbers."""

    from torchrecsys_tpu_torch import RecSys
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp

    label = "Linear metadata"
    users = rs.store.user_encoder.to_list()[:U]
    warm, _, counts = counted(torch, lambda: serve_outputs(torch, rs, users, (10, 128)))
    check(counts["dot_topk_small"] == 2 and counts["dot_topk_large"] == 2 and sum(counts.values()) == 4,
          f"{label}: warm serving launched {counts}")
    launches = dict(counts)
    # a. save; restore into a fresh RecSys over the same data
    d_a = ckpt_dir("linear")
    shutil.rmtree(ckpt_dir(""), ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs.save(d_a)
    save_s = time.perf_counter() - t0
    os.sync()  # the writeback here, not under a later phase's clock or profiler
    size = ckpt_bytes(d_a)
    log(f"[ckpt] {label}: save {save_s:.3f} s, {size} bytes ({size / 2**20:.1f} MiB) in "
        f"{sorted(os.listdir(d_a))}")
    t0 = time.perf_counter()
    fresh = RecSys(data, metadata_id_col=["category_id"], n_factors=D, device=DEVICE, dynamic_neg_sampling=True)
    ingest_s = time.perf_counter() - t0
    _, restore_s, _ = counted(torch, lambda: fresh.restore(d_a))
    got, _, counts = counted(torch, lambda: serve_outputs(torch, fresh, users, (10, 128)))
    launches = {k: launches[k] + counts[k] for k in launches}
    for k, (vals, ids, raw) in warm.items():
        check(all(np.array_equal(a, b) for a, b in zip(got[k], (vals, ids, raw))),
              f"{label}: the restored RecSys serves other ids or values at top_k={k}")
    log(f"[ckpt] {label}: restore into a fresh RecSys (ingest {ingest_s:.2f} s) {restore_s:.3f} s; top_k 10 "
        f"and 128 of {U} users identical to the warm model's")
    del fresh
    # b. resume: one more epoch in place, from the cold-loaded state, and
    # again in memory from a copy (the noise floor)
    loaded, load_s, _ = counted(torch, lambda: RecSys.load(d_a, device=DEVICE))
    steps = -(-rs.store.num_train // TRAIN_B)
    start = clone_state(torch, rs.state)
    inplace, inplace_s, counts = counted(torch, lambda: rs.fit(epochs=1, batch_size=TRAIN_B, verbose=False))
    check(counts["fused_pairwise_step_meta"] == steps and sum(counts.values()) == steps,
          f"{label}: the in-place epoch ran {steps} steps and launched {counts}")
    launches["fused_pairwise_step_meta"] = counts["fused_pairwise_step_meta"]
    check(loaded.trainer.cfg == rs.trainer.cfg, f"{label}: the loaded train config {loaded.trainer.cfg} != "
          f"{rs.trainer.cfg}")
    (resumed, rlosses), resumed_s, counts = counted(
        torch, lambda: loaded.trainer.fit(loaded.state, rs.store, epochs=1, verbose=False))
    check(counts["fused_pairwise_step_meta"] == steps and sum(counts.values()) == steps,
          f"{label}: the resumed epoch ran {steps} steps and launched {counts}")
    launches["fused_pairwise_step_meta"] += counts["fused_pairwise_step_meta"]
    saved = step_launches(fp)
    again, again_losses = rs.trainer.fit(start, rs.store, epochs=1, verbose=False)
    set_step_launches(fp, saved)  # the noise floor's run is a comparison
    floor = state_diff(torch, again, rs.state)
    check(abs(rlosses[0] - inplace[0]) <= RESUME_ATOL + RESUME_RTOL * abs(inplace[0]),
          f"{label}: resumed epoch loss {rlosses[0]} != in place {inplace[0]}")
    bad, worst = resume_compare(torch, f"{label} resume", resumed, rs.state, floor=floor)
    log(f"[ckpt] {label}: resume from the cold-loaded state ({load_s:.3f} s to load): epoch loss "
        f"{rlosses[0]:.7f} vs {inplace[0]:.7f} in place ({again_losses[0]:.7f} in memory again); "
        f"{steps} step calls each; max |diff| {worst:.3g}; rows beyond rtol={RESUME_RTOL}/atol={RESUME_ATOL} "
        f"{bad or 0} (in memory twice: {({k: v[0] for k, v in floor.items() if v[0]}) or 0})")
    del loaded, resumed, start, again
    torch.cuda.empty_cache()
    return {"warm": warm, "users": users, "save_s": save_s, "bytes": size, "restore_s": restore_s,
            "load_s": load_s, "launches": launches, "dir": d_a, "config": dict(rs.config),
            "epoch_s": (inplace_s, resumed_s)}


def new_interactions(seed: int = 1):
    """N_NEW interactions from synthetic_interactions' generator under
    another seed: NEW_USERS new users and NEW_ITEMS new items (each at
    least once) mixed with existing ids; a new item's category is one of
    NEW_CATS new ones (1000 + item % NEW_CATS), an existing item keeps its
    own (item % 1000)."""
    r = np.random.default_rng(seed)
    new_u = N_USERS + np.arange(NEW_USERS)
    new_i = N + np.arange(NEW_ITEMS)
    n_rest = N_NEW - NEW_ITEMS
    users = np.concatenate([r.integers(0, N_USERS + NEW_USERS, NEW_ITEMS), r.integers(0, N_USERS + NEW_USERS, n_rest)])
    users[:NEW_USERS] = new_u
    on_block = r.random(n_rest) < 0.7
    rand_items = r.integers(0, N + NEW_ITEMS, n_rest)
    block_items = ((rand_items // 8) * 8 + users[NEW_ITEMS:] % 8) % (N + NEW_ITEMS)
    items = np.concatenate([r.permutation(new_i), np.where(on_block, block_items, rand_items)])
    cats = np.where(items >= N, 1000 + items % NEW_CATS, items % 1000)
    return {"user_id": users.astype(np.int64), "item_id": items.astype(np.int64), "category_id": cats}


def grow_path(torch, rs):
    """6n d: ``partial_fit`` with N_NEW new interactions on the Linear
    metadata model. Inside ``update_data``: the vocabularies grow by
    exactly the new users, items and categories, every trained row and
    accumulator is kept bit for bit, the new accumulators are zero; then
    the fit launches #3 once per step of the grown split, the loss of a
    fixed sample of the new train pairs falls, and 256 new raw users are
    served through #1 (raw ids in the grown vocabulary). Returns the child
    job of the grown model's checkpoint and the numbers."""
    from torchrecsys_tpu_torch import api

    label = "grown Linear metadata"
    new = new_interactions()
    old = {k: (v.clone(), rs.state["emb_opt"][k]["acc"].clone()) for k, v in rs.state["tables"].items()}
    old_schema, old_train = rs.store.schema, rs.store.num_train
    times, seen = {}, {}
    grow, update = api.grow_state, rs.update_data

    def timed_grow(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = grow(*args)
        torch.cuda.synchronize()
        times["grow_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def timed_update(dataset):
        t0 = time.perf_counter()
        update(dataset)
        torch.cuda.synchronize()
        times["update_s"] = time.perf_counter() - t0
        st = rs.store
        r = np.random.default_rng(16)
        rows = old_train + r.choice(st.num_train - old_train, min(65536, st.num_train - old_train), replace=False)
        seen["sample"] = (st.train_users[rows], st.train_items[rows], r.integers(0, st.schema.num_items, rows.size))
        seen["fresh"] = sample_loss(torch, rs, seen["sample"])
        t = rs.state["tables"]
        for name, (tab, acc) in old.items():
            n = tab.shape[0]
            check(torch.equal(t[name][:n], tab), f"{label}: trained rows of {name} changed")
            a = rs.state["emb_opt"][name]["acc"]
            check(torch.equal(a[:n], acc) and not bool(a[n:].any()),
                  f"{label}: the accumulator of {name} lost its rows or starts its new ones off zero")
            seen.setdefault("grew", {})[name] = (n, t[name].shape[0])
        torch.cuda.synchronize()

    api.grow_state, rs.update_data = timed_grow, timed_update
    try:
        losses, total_s, counts = counted(torch, lambda: rs.partial_fit(new, epochs=1, batch_size=TRAIN_B,
                                                                        verbose=False))
    finally:
        api.grow_state = grow
        del rs.update_data
    s = rs.store.schema
    check(s.num_users == old_schema.num_users + NEW_USERS and s.num_items == old_schema.num_items + NEW_ITEMS
          and s.metadata_vocab_sizes[0] == old_schema.metadata_vocab_sizes[0] + NEW_CATS,
          f"{label}: schema {s} after {NEW_USERS} new users, {NEW_ITEMS} items, {NEW_CATS} categories")
    steps = -(-rs.store.num_train // TRAIN_B)
    check(counts["fused_pairwise_step_meta"] == steps and sum(counts.values()) == steps,
          f"{label}: partial_fit ran {steps} steps and launched {counts}")
    check(len(losses) == 1 and np.isfinite(losses[0]), f"{label}: epoch loss {losses}")
    trained = sample_loss(torch, rs, seen["sample"])
    check(trained < seen["fresh"], f"{label}: the new pairs' sample loss {trained} is not below {seen['fresh']}")
    fit_s = total_s - times["update_s"]
    rate = rs.store.num_train / fit_s
    log(f"[ckpt] {label}: partial_fit of {N_NEW} interactions ({NEW_USERS} new users, {NEW_ITEMS} new items, "
        f"{NEW_CATS} new categories): update_data {times['update_s']:.3f} s on the host (grow_state "
        f"{times['grow_ms']:.3f} ms; tables {seen['grew']}), trained rows and accumulators bit-identical, new "
        f"accumulators zero; fit {steps} steps of {TRAIN_B} in {fit_s:.3f} s = {rate:.1f} examples/s, "
        f"epoch loss {losses[0]:.5f}; new pairs' sample loss {seen['fresh']:.5f} -> {trained:.5f}; "
        f"launches {nonzero(counts)}")
    new_users = [int(u) for u in N_USERS + np.arange(U)]
    warm, _, counts = counted(torch, lambda: serve_outputs(torch, rs, new_users, (10,)))
    check(counts["dot_topk_small"] == 2 and sum(counts.values()) == 2, f"{label}: serving launched {counts}")
    ids = warm[10][2]
    check(all(x in rs.store.item_encoder for x in ids.reshape(-1).tolist()),
          f"{label}: predicted raw ids outside the grown vocabulary")
    check_predict(rs, new_users, ids, 10, False, torch)
    d_g = ckpt_dir("grown")
    rs.save(d_g)
    os.sync()
    log(f"[ckpt] {label}: {U} new raw users served through #1, checked against the plain path; saved "
        f"{ckpt_bytes(d_g) / 2**20:.1f} MiB")
    return {"name": label, "dir": d_g, "users": new_users, "ks": (10,), "warm": warm, "config": dict(rs.config),
            "update_s": times["update_s"], "grow_ms": times["grow_ms"], "fit_examples_per_s": rate,
            "launches": {"dot_topk_small": counts["dot_topk_small"],
                         "fused_pairwise_step_meta": steps}}


def mlp_checkpoint_path(torch, rs):
    """6n c: the north-star AMP MLP of 6f saved (tables, accumulators,
    dense, batch-norm statistics, adam with its count, step, generator),
    a 16-user predict kept for the child's cold load, and one more epoch
    from the cold-loaded state against one in memory: each through #6
    and #7 once per hidden layer per step, under torch's deterministic
    algorithms (index_add_ otherwise adds duplicate rows in no fixed
    order, which bf16 rounding amplifies over an epoch)."""
    from torchrecsys_tpu_torch import RecSys

    label = "MLP AMP"
    users = rs.store.user_encoder.to_list()[:16]
    warm, _, counts = counted(torch, lambda: serve_outputs(torch, rs, users, (10,)))
    check(sum(counts.values()) == 0, f"{label}: predict launched {counts}")
    d_m = ckpt_dir("mlp")
    _, save_s, _ = counted(torch, lambda: rs.save(d_m))
    os.sync()
    size = ckpt_bytes(d_m)
    check(rs.state["dense_opt"]["count"] == rs.state["step"] > 0 and rs.state["model_state"],
          f"{label}: the saved state has no adam count or batch-norm statistics")
    loaded, load_s, _ = counted(torch, lambda: RecSys.load(d_m, device=DEVICE))
    steps = -(-rs.store.num_train // MLP_B)
    want = len(MLP_HIDDEN) * steps
    fit_kw = dict(epochs=1, batch_size=MLP_B, learning_rate=0.05, loss="hinge", verbose=False)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        inplace, _, c_in = counted(torch, lambda: rs.fit(**fit_kw))
        check(loaded.trainer.cfg == rs.trainer.cfg, f"{label}: loaded train config {loaded.trainer.cfg}")
        (resumed, rlosses), _, c_re = counted(
            torch, lambda: loaded.trainer.fit(loaded.state, rs.store, epochs=1, verbose=False))
    finally:
        torch.use_deterministic_algorithms(False)
    for what, c in (("in place", c_in), ("resumed", c_re)):
        check(c["fused_tower_fwd"] == c["fused_tower_bwd"] == want and sum(c.values()) == 2 * want,
              f"{label} {what}: {steps} steps launched {c}; want {want} of each tower kernel")
    check(abs(rlosses[0] - inplace[0]) <= RESUME_ATOL + RESUME_RTOL * abs(inplace[0]),
          f"{label}: resumed epoch loss {rlosses[0]} != in place {inplace[0]}")
    # a bias batch norm or neg - pos removes has a gradient of 0 up to
    # rounding, which adam turns into steps of up to lr (a running mean
    # follows its bias): printed only
    bad, worst = resume_compare(torch, f"{label} resume", resumed, rs.state, skip=("b", "mean"))
    log(f"[ckpt] {label}: save {save_s:.3f} s, {size} bytes ({size / 2**20:.1f} MiB); load {load_s:.3f} s; "
        f"one more epoch from the loaded state against one in memory (deterministic algorithms): loss "
        f"{rlosses[0]:.7f} vs {inplace[0]:.7f}; tower launches {nonzero(c_re)} / {nonzero(c_in)}; max |diff| "
        f"{worst:.3g}, "
        f"rows beyond {bad or 0}")
    del loaded, resumed
    torch.cuda.empty_cache()
    return {"name": label, "dir": d_m, "users": users, "ks": (10,), "warm": warm, "config": dict(rs.config),
            "save_s": save_s, "bytes": size, "load_s": load_s,
            "launches": {"fused_tower_fwd": c_in["fused_tower_fwd"] + c_re["fused_tower_fwd"],
                         "fused_tower_bwd": c_in["fused_tower_bwd"] + c_re["fused_tower_bwd"]}}


# ---------------------------------------------------------------------------
# phase 7: times
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timing_phase(torch, rs, users_raw, launches, errs):
    from torchrecsys_tpu_torch.ops import dot_topk as dt

    rows = torch.as_tensor([rs.store.user_encoder.encode_one(u) for u in users_raw], device=rs.device)
    q, ib, user_fn, _ = rs.model.linearized_catalog(rs._params(), rs.feat)
    uv, _ = user_fn(rs._params(), rows)
    u, d = uv.shape
    n = q.shape[0]
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 library yardstick
    rows_out = []
    saved = {w.__name__: w.launches for w in (dt.dot_topk_small, dt.dot_topk_large)}
    for name, (replaces, k) in KERNEL_ROWS.items():
        fn = getattr(dt, name)
        ms = cuda_ms(torch, lambda: fn(uv, q, ib, k))
        plain_ms = cuda_ms(torch, lambda: dt.dot_topk_plain(uv, q, ib, k), reps=5)

        def library():
            return torch.topk(torch.matmul(uv, q.T) + ib, k, dim=1)

        library_ms = cuda_ms(torch, library, reps=5)
        dev_us, per_call = device_call(torch, lambda: fn(uv, q, ib, k))
        check(per_call <= 3, f"{name}: {per_call} kernels per call (memset, kernel and merge expected)")
        flops = 2.0 * u * n * d
        nbytes = (u * d + n * d) * q.element_size() + n * 4 + u * k * 8
        # f32-accurate products as 3xTF32 on the tensor cores (a third of
        # the TF32 peak); bf16 products at the bf16 peak
        peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else SPLIT_F32_FLOPS
        bound_ms = max(flops / peak, nbytes / PEAK_BYTES) * 1e3
        rows_out.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops / peak >= nbytes / PEAK_BYTES else "bytes",
            "library_ms": library_ms,
        })
        log(
            f"[time] {name} (U={u}, N={n}, D={d}, k={k}, {str(q.dtype).removeprefix('torch.')}): "
            f"{ms:.4f} ms (device {dev_us:.1f} us per call over {per_call} kernel(s), torch.profiler); "
            f"bound {bound_ms:.4f} ms ({flops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s; "
            f"{max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3:.4f} ms at the CUDA cores' "
            f"{PEAK_F32_FLOPS / 1e12:.0f}); plain {plain_ms:.4f} ms; torch.topk(matmul) {library_ms:.4f} ms"
        )
    # the slab path: the same calls at D = 160 and 256, random f32 vectors
    gen = torch.Generator(device=DEVICE).manual_seed(41)
    for wd in TIMED_WIDE_DS:
        uw, qw, ibw = (torch.randn(u, wd, generator=gen, device=DEVICE),
                       torch.randn(n, wd, generator=gen, device=DEVICE), torch.randn(n, generator=gen, device=DEVICE))
        for row in rows_out:
            fn, k = getattr(dt, row["name"]), KERNEL_ROWS[row["name"]][1]
            ms = cuda_ms(torch, lambda: fn(uw, qw, ibw, k))
            plain_ms = cuda_ms(torch, lambda: dt.dot_topk_plain(uw, qw, ibw, k), reps=5)
            library_ms = cuda_ms(torch, lambda: torch.topk(torch.matmul(uw, qw.T) + ibw, k, dim=1), reps=5)
            flops, nbytes = 2.0 * u * n * wd, (u + n) * wd * 4 + n * 4 + u * k * 8
            bound = max(flops / SPLIT_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
            p = dt.plan(k > 16, u, n, wd, False, k)
            row[f"d{wd}"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
                             "bound_by": "operations" if flops / SPLIT_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes",
                             "user_tile": p.user_tile, "ring_slots": p.stages, "slot_bytes": p.slot_bytes,
                             "smem": p.smem}
            log(f"[time] {row['name']} (U={u}, N={n}, D={wd}: the slab path, k={k}, float32): {ms:.4f} ms; "
                f"bound {bound:.4f} ms ({flops / 1e9:.2f} GFLOP at {SPLIT_F32_FLOPS / 1e12:.0f} TFLOP/s; the item "
                f"stream {nbytes / PEAK_BYTES * 1e3:.4f} ms); plain {plain_ms:.4f} ms; torch.topk(matmul) "
                f"{library_ms:.4f} ms ({library_ms / ms:.2f}x the kernel's time)")
            log(f"[kernel] slab plan D={wd} {row['name']} k={k} float32: {p.user_tile} users per block, "
                f"{p.stages} ring slots of {p.slot_bytes} B (two 128-byte TMA boxes of 64 rows"
                f"{'; the tail unit one' if -(-wd // 32) % 2 else ''}), {p.smem} B dynamic shared memory, "
                f"{p.splits} catalog splits")
        del uw, qw, ibw
    # the same calls on a bf16 catalog (the AMP models' predict): the users and items rounded to bf16
    ub, qb = uv.to(torch.bfloat16), q.to(torch.bfloat16)
    for row in rows_out:
        fn, k = getattr(dt, row["name"]), KERNEL_ROWS[row["name"]][1]
        ms = cuda_ms(torch, lambda: fn(ub, qb, ib, k))
        plain_ms = cuda_ms(torch, lambda: dt.dot_topk_plain(ub, qb, ib, k), reps=5)
        library_ms = cuda_ms(torch, lambda: torch.topk(torch.matmul(ub, qb.T).float() + ib, k, dim=1), reps=5)
        flops, nbytes = 2.0 * u * n * d, (u + n) * d * 2 + n * 4 + u * k * 8
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        row["bf16"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
                       "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"}
        log(f"[time] {row['name']} (U={u}, N={n}, D={d}, k={k}, bfloat16): {ms:.4f} ms; bound {bound:.4f} ms "
            f"({flops / 1e9:.2f} GFLOP at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; the item stream "
            f"{nbytes / PEAK_BYTES * 1e3:.4f} ms); plain {plain_ms:.4f} ms; torch.topk(bf16 matmul) "
            f"{library_ms:.4f} ms")
    del ub, qb
    for w in (dt.dot_topk_small, dt.dot_topk_large):  # timing launches are not main-path launches
        w.launches = saved[w.__name__]
    return rows_out


def one_batch(torch, rs, b: int):
    """Packed rows of one real batch of ``rs``'s epoch (b rows, weighted,
    composite item rows when the model has metadata) and its weights."""
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp

    tr = rs.trainer
    data, feat = tr._device_train_data(rs.store), tr.feature_tables(rs.store)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    keys = torch.arange(6, device=DEVICE) * 3 + 1
    if b != tr.cfg.batch_size:
        from torchrecsys_tpu_torch.train import Trainer

        tr = Trainer(rs.model, type(tr.cfg)(batch_size=b), DEVICE)
    ep = tr.build_epoch(data, keys, gen)
    packed = tr.pack_state(rs.state)
    uid, pid, nid = (ep.batches[k][0] for k in ("user_id", "pos_item_id", "neg_item_id"))
    w = ep.batches["_w"][0] if "_w" in ep.batches else None
    u = packed["user"][uid]
    pn = packed["item"][torch.cat([pid, nid])]
    if feat:  # the metadata step's composite rows: item + masked sum of meta rows
        iids = torch.cat([pid, nid])
        mids, mm = feat["meta_ids"][iids], feat["meta_mask"][iids].float()
        for f, name in enumerate(rs.model.schema.metadata_names):
            rows = packed[f"meta_{name}"][mids[:, f, :]]
            pn[:, :D] += (rows[..., :D] * mm[:, f, :, None]).sum(1)
    return u, pn[:b], pn[b:], w, fp.step_inv(b, w)


def train_timing(torch, rs, err: float):
    """The row-level kernel's JSON row at the main path's shape: FM with
    metadata, one real 1024-row batch of the fit (weighted, the sigmoid,
    emit_g, no item rows; composite rows formed as Linear's, which is
    enough for timing), CUDA-event ms, its bound (the lanes the row math
    reads, in 32-byte sectors, and the rows written), the plain version's
    ms; also B=8192."""
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp

    saved = fp.pairwise_updates_rows.launches
    row = None
    for b in (TRAIN_B, 8192):
        u, p, n, w, inv = one_batch(torch, rs, b)
        kw = dict(d=D, margin=1.0, loss_kind="hinge", sigmoid=True, eps=1e-10, emit_g=True, item_upd=False)
        ms = cuda_ms(torch, lambda: fp.pairwise_updates_rows(u, p, n, w, inv, 0.01, **kw), reps=200)
        plain_ms = cuda_ms(torch, lambda: fp.pairwise_updates_rows_plain(u, p, n, w, inv, 0.01, **kw))
        dev_us, per_call = device_call(torch, lambda: fp.pairwise_updates_rows(u, p, n, w, inv, 0.01, **kw))
        # the bytes the function needs: lanes 0..D+2 of each of the 3 input rows in 32-byte
        # sectors (the kernel loads whole rows), the 128-lane user rows out, the weights
        sector = -(-4 * (D + 3) // 32) * 32
        nbytes = b * (3 * sector + 4 * 128) + 4 * b
        flops = 10 * b * 128  # cost_estimate's count (fused_pairwise.py:347)
        bound_ms = max(nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS) * 1e3
        log(f"[time] pairwise_updates_rows (B={b}, D={D}, hinge, sigmoid, weighted, emit_g, no item rows): "
            f"{ms:.4f} ms; device {dev_us:.2f} us per call over {per_call} kernels (torch.profiler); "
            f"bound {bound_ms:.5f} ms (bytes); plain {plain_ms:.4f} ms; library: none")
        if b == TRAIN_B:
            # host time per call: the whole wrapper against its bare C call
            # (same arguments, outputs into one preallocated buffer)
            lib, rows = fp._lib(), b * 128
            blocks = lib.trs_fused_pairwise_blocks(b)
            buf = torch.empty((rows + blocks + 1,), device=DEVICE)
            ptr = buf.data_ptr()
            args = (0, 1, 1, 1, 0, 0, u.data_ptr(), p.data_ptr(), n.data_ptr(), w.data_ptr(), b, D,
                    fp._inv_d(D), inv, 0.01, 1.0, 1e-10, ptr, None, None, ptr + 4 * rows,
                    ptr + 4 * (rows + blocks), torch.cuda.current_stream().cuda_stream)
            wrap_us = host_ms(torch, lambda: fp.pairwise_updates_rows(u, p, n, w, inv, 0.01, **kw),
                              reps=2000)[0] * 1e3
            bare_us = host_ms(torch, lambda: check(lib.trs_fused_pairwise(*args) == 0, "bare call"),
                              reps=2000)[0] * 1e3
            log(f"[time] pairwise_updates_rows host us per call (B={b}): wrapper {wrap_us:.2f}, "
                f"its bare C call {bare_us:.2f}")
            row = {
                "name": "pairwise_updates_rows", "route": "cuda", "source": TRAIN_SOURCE,
                "replaces": TRAIN_REPLACES, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            }
    fp.pairwise_updates_rows.launches = saved
    return row


PROFILE_SETTLE_S = 0.05
WINDOW_TAKES = 12  # a fit window's takes, with pauses of 0.25, 0.5, ..., 8, 8, ... s between
LEAD_IN = 16  # spin kernels launched just before a profiled window, their records set aside


class WindowRecords:
    """A profiled window's records without its lead-in's (``spin_kernel``):
    ``key_averages()`` and the profiler's ``profiler``."""

    def __init__(self, prof):
        self.profiler = prof.profiler
        self._averages = [e for e in prof.key_averages() if "spin_kernel" not in e.key]

    def key_averages(self):
        return self._averages


def profiled_window(torch, warm, run):
    """torch.profiler's CUDA records of ``run()`` (synchronised, as
    :class:`WindowRecords`) and its wall µs. ``warm()`` runs first, in the
    profiler's warm-up phase, whose records are dropped. Even so, the
    first 1-5 kernels launched in the active phase can be missing from
    its records (seen on the H100 late in a whole run, in 6j's windows,
    take after take), and kernels that end in the last milliseconds of
    the phase can be too. So ``LEAD_IN`` short spin kernels are launched
    just before ``run()``, in the same stream with no pause between, and
    set aside; and the device is idle for ``PROFILE_SETTLE_S`` before the
    lead-in and after ``run()``, outside ``wall_us``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        prof.step()
        time.sleep(PROFILE_SETTLE_S)
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1000)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(PROFILE_SETTLE_S)
        prof.step()
    return WindowRecords(prof), wall_us


def record_gaps(prof, name: str) -> str:
    """Where ``name``'s records of a profiled window lie: the count kineto
    returned, the first start and last end in µs from the trace's start,
    and each gap between starts above 1.5x the median (a missing launch)."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    evs = sorted((e.start_ns(), e.end_ns()) for e in res.events() if name in e.name())
    if len(evs) < 2:
        return f"{name}: {len(evs)} records"
    starts = np.array([a for a, _ in evs], dtype=np.float64)
    gaps = np.diff(starts) / 1e3
    med = float(np.median(gaps))
    big = [(int(i), round(float(g), 1)) for i, g in enumerate(gaps) if g > 1.5 * med]
    return (f"{name}: {len(evs)} records from {(evs[0][0] - t0) / 1e3:.1f} to {(evs[-1][1] - t0) / 1e3:.1f} us, "
            f"median gap {med:.1f} us, gaps above 1.5x after records {big[:8]}")


def device_split(prof) -> dict:
    """Device µs per kernel name from a torch.profiler run."""
    out: dict = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            out[e.key] = out.get(e.key, 0.0) + t
    return out


def train_breakdown(torch, rs, label: str, fit_s: float, window: int = 100, fit_kw=None):
    """Breakdown of fit: the fit's ``fit_s`` against its parts on the host
    clock (the train split's upload, which a store's first fit pays, the
    item features, the epoch build, pack, the epoch's steps, unpack) and
    against the fit run again here, warm and then after emptying the
    allocator's cache and the upload cache (as a fit after
    ``torch.cuda.empty_cache()`` runs), host
    ms per step (the median of 3 windows), the host cost of per-step id
    views against one unbind per epoch, and device µs per step by part
    from torch.profiler over ``window`` steps (``profiled_window``; a
    window short of records is taken again), with the device's idle share
    in that window (``fit_kw``: the fit's keywords past its batch size, e.g.
    6j's popularity sampling and schedule). The window must hold the step
    kernels only (2 launches
    per step): a gather, scatter or elementwise kernel fails the run. FM
    with metadata runs the row-level kernel (and its loss sum: 2 launches
    per step) between torch gathers, elementwise glue and scatters, which
    are split out instead."""
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp

    tr, st = rs.trainer, rs.store

    def upload():
        tr._data_cache_key = None  # as on a store's first fit
        return tr._device_train_data(st)

    upload_ms, data = host_ms(torch, upload, reps=2)
    feat_ms, feat = host_ms(torch, lambda: tr.feature_tables(st), reps=2)
    saved = step_launches(fp)
    glue = rs.model.pairwise_fm_fields and bool(rs.model.schema.metadata_names)
    refit_ms = {}
    for how in ("warm", "cold"):
        if how == "cold":
            torch.cuda.empty_cache()
            tr._data_cache_key = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs.fit(epochs=1, batch_size=TRAIN_B, verbose=False, **(fit_kw or {}))
        torch.cuda.synchronize()
        refit_ms[how] = (time.perf_counter() - t0) * 1e3
    check(rs.trainer is tr, f"{label}: the refit built another trainer")
    data = tr._device_train_data(st)
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    keys = torch.arange(6, device=DEVICE) + 40
    build_ms, _ = host_ms(torch, lambda: tr.build_epoch(data, keys, gen, feat), reps=3)
    ep = tr.build_epoch(data, keys, gen, feat)
    window = min(window, (ep.nb - 10) // 4)
    pack_ms, packed = host_ms(torch, lambda: tr.pack_state(rs.state), reps=2)
    unpack_ms, _ = host_ms(torch, lambda: tr.unpack_state(rs.state, packed, 0), reps=2)
    bt, cols = ep.batches, ("user_id", "pos_item_id", "neg_item_id")
    t0 = time.perf_counter()
    for i in range(ep.nb):
        _ = [bt[k][i] for k in cols]
    views_us = (time.perf_counter() - t0) / ep.nb * 1e6
    t0 = time.perf_counter()
    _ = [bt[k].contiguous().unbind(0) for k in cols]
    unbind_us = (time.perf_counter() - t0) / ep.nb * 1e6
    t0 = time.perf_counter()
    tr.run_steps(packed, ep, feat)
    torch.cuda.synchronize()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    step_ms = []
    for r in range(3):
        start = 10 + r * window
        t0 = time.perf_counter()
        tr.run_steps(packed, ep, feat, steps=range(start, start + window))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) / window * 1e3)
    # each step call is two launches (the C entry fails on a failed launch), and every step of
    # the window launches the same kernels. The wrappers count every call; a window with fewer
    # than 2 step-kernel records per step, or a count of records that is not a multiple of its
    # steps, is logged with what it lacks and taken again after a pause that doubles from
    # 0.25 s up to 8 s (the profiler's losses come in spells of seconds), so the device times
    # below come from a whole window
    for attempt in range(1, WINDOW_TAKES + 1):
        if attempt > 1:
            time.sleep(min(0.25 * 2 ** (attempt - 2), 8.0))
        calls = step_launches(fp)
        prof, wall_us = profiled_window(
            torch, lambda: tr.run_steps(packed, ep, feat, steps=range(5, 10)),
            lambda: tr.run_steps(packed, ep, feat, steps=range(10 + 3 * window, 10 + 4 * window)))
        calls = sum(b - a for a, b in zip(calls, step_launches(fp))) - 5
        check(calls == window, f"fit {label}: {calls} step calls in a window of {window} steps")
        by_name = {}
        for e in prof.key_averages():
            if "fused_pairwise" in e.key and getattr(e, "self_device_time_total", 1) > 0:
                m = re.search(r"fused_pairwise_\w+", e.key)
                by_name[m.group(0) if m else e.key] = by_name.get(m.group(0) if m else e.key, 0) + e.count
        launched = sum(by_name.values())
        records = sum(e.count for e in prof.key_averages() if getattr(e, "self_device_time_total", 1) > 0)
        if launched == 2 * window and records % window == 0:
            break
        log(f"[breakdown] fit {label}: window {attempt}: the profiler recorded {launched} of its "
            f"{2 * window} step-kernel launches ({by_name}) and {records} kernel records in all; taken again; "
            + "; ".join(record_gaps(prof, k) for k in ("fused_pairwise_step_kernel", "fused_pairwise_apply_kernel")))
    set_step_launches(fp, saved)
    check(launched == 2 * window, f"fit {label}: {launched} step-kernel launches recorded in {window} "
          f"steps in each of {attempt} windows, want 2 each: {by_name}")
    if records % window:
        log(f"[breakdown] fit {label}: {records} kernel records in {window} steps in the last of "
            f"{attempt} windows: not the same count per step")
    split = device_split(prof)
    parts = {"kernel": 0.0, "gathers": 0.0, "scatters": 0.0, "elementwise": 0.0}
    for name, us in split.items():
        if "fused_pairwise" in name:
            parts["kernel"] += us
        elif "indexSelect" in name or "index_elementwise" in name or "gather" in name.lower():
            parts["gathers"] += us
        elif "indexFunc" in name or "index_add" in name or "scatter" in name.lower():
            parts["scatters"] += us
        else:  # elementwise, reductions, cat
            parts["elementwise"] += us
    busy = sum(split.values())
    med = sorted(step_ms)[1]
    parts_ms = {"upload": upload_ms, "item features": feat_ms, "epoch build": build_ms, "pack": pack_ms,
                f"{ep.nb} steps": epoch_ms, "unpack": unpack_ms}
    total = sum(parts_ms.values())
    log(f"[breakdown] fit {label}: the fit's {fit_s * 1e3:.1f} ms against its parts, ms on the host clock: "
        + " + ".join(f"{k} {v:.1f}" for k, v in parts_ms.items())
        + f" = {total:.1f}; rest {fit_s * 1e3 - total:.1f}; the fit again here: {refit_ms['warm']:.1f} warm, "
        f"{refit_ms['cold']:.1f} after emptying the allocator's cache and the upload cache")
    log(f"[breakdown] fit {label}: epoch build {build_ms:.3f} ms per epoch "
        f"({build_ms / ep.nb:.4f} ms per step over {ep.nb} steps), pack {pack_ms:.3f} ms + "
        f"unpack {unpack_ms:.3f} ms per epoch; {med:.4f} ms per step (host clock, median of 3 windows "
        f"of {window} steps: {', '.join(f'{x:.4f}' for x in step_ms)}); the ids' per-step views would "
        f"cost {views_us:.2f} us per step, one unbind per epoch costs {unbind_us:.3f}")
    log(f"[breakdown] fit {label}: device us per step (kernel = the "
        f"{'row-level kernel and its loss sum' if glue else 'step kernels'}): " + ", ".join(
        f"{k} {v / window:.2f}" for k, v in parts.items()
    ) + f"; {launched / window:.2f} step-kernel launches and {records / window:.2f} kernel records per step "
        f"(window {attempt}); device busy {busy / window:.2f} of "
        f"{wall_us / window:.2f} us per step under the profiler = idle share {1 - busy / wall_us:.3f}")
    top = sorted(split.items(), key=lambda kv: -kv[1])[:8]

    def short(k):
        k = k.replace("(anonymous namespace)::", "").removeprefix("void ")
        return re.sub(r"[<(].*", "", k).removeprefix("at::native::")[:40]

    log(f"[profile] fit {label}: top kernels, device us per step: " + "; ".join(
        f"{short(k)} {v / window:.2f}" for k, v in top
    ))
    others = {short(k): v for k, v in split.items() if "fused_pairwise" not in k}
    check(glue or not others, f"fit {label}: the step window ran other kernels: {others}")
    return {"build_ms": build_ms, "step_ms": med, "parts_ms": parts_ms, "refit_ms": refit_ms,
            "step_ms_runs": step_ms, "idle_share": 1 - busy / wall_us, "kernel_us": parts["kernel"] / window, "busy_us": busy / window}


def step_timing(torch, rs, meta: bool, err: float, launches: int):
    """The step wrapper's JSON row at the main path's shape: one real
    1024-row batch of the fit (weighted when the epoch has a remainder
    batch), CUDA-event ms per step call, device µs per call and kernels
    per call (torch.profiler), the plain step's ms, the bound from the
    bytes this batch needs (each distinct row's data lanes read and
    written once, in 32-byte sectors; the ids, the weights, the distinct
    unmasked metadata rows and the items' meta_ids / meta_mask), the
    device time of an empty kernel on the same grid (the
    launch floor), and host µs per call of the wrapper against its bare C
    call."""
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp

    name = "fused_pairwise_step_meta" if meta else "fused_pairwise_step"
    wrapper = getattr(fp, name)
    saved = wrapper.launches
    tr = rs.trainer
    data, feat = tr._device_train_data(rs.store), tr.feature_tables(rs.store)
    ep = tr.build_epoch(data, torch.arange(6, device=DEVICE) * 3 + 1, torch.Generator(device=DEVICE).manual_seed(4))
    packed = tr.pack_state(rs.state)
    i = ep.nb - 1  # the remainder batch when there is one
    uid, pid, nid = (ep.batches[k][i].contiguous() for k in ("user_id", "pos_item_id", "neg_item_id"))
    w = ep.batches["_w"][i] if "_w" in ep.batches else None
    ws = ep.weight_sums[i] if ep.weight_sums is not None else None
    b = uid.shape[0]
    lo = torch.empty((1,), device=DEVICE)
    kw = dict(d=D, margin=tr.cfg.margin, loss_kind=tr.cfg.loss, sigmoid=False, weight_sum=ws, loss_out=lo)
    if meta:
        names = rs.model.schema.metadata_names
        mvec = [packed[f"meta_{nm}"] for nm in names]
        lead = (packed["user"], packed["item"], mvec, feat["meta_ids"], feat["meta_mask"])
    else:
        lead = (packed["user"], packed["item"])

    def call():
        return wrapper(*lead, uid, pid, nid, w, 0.01, **kw)

    plain = fp.fused_pairwise_step_meta_plain if meta else fp.fused_pairwise_step_plain
    ms = cuda_ms(torch, call, reps=200)
    plain_ms = cuda_ms(torch, lambda: plain(*lead, uid, pid, nid, w, 0.01, **kw))
    dev_us, per_call = device_call(torch, call)
    check(per_call == 2, f"{name}: {per_call} kernels per call, want 2 (step and apply)")
    lib, stream = fp._lib(), torch.cuda.current_stream().cuda_stream
    floor_us, _ = device_call(torch, lambda: lib.trs_fused_pairwise_empty(b, stream))
    # the bytes this batch needs: each distinct row's data lanes (d+3; the
    # metadata user row d+6, its g lanes) read and written once, in whole
    # 32-byte sectors (a row starts on one), the ids, the weights, the loss
    def sectors(floats):
        return -(-4 * floats // 32) * 32

    items = torch.unique(torch.cat([pid, nid]))
    users = torch.unique(uid).numel()
    user_row = sectors(D + 6 if meta else D + 3)
    nbytes = (users * user_row + items.numel() * sectors(D + 3)) * 2 + 3 * 8 * b + 4
    nbytes += 4 * b if w is not None else 0
    per_row_bytes = 6 * 128 * 4 * b + 3 * 8 * b + (4 * b if w is not None else 0) + 4
    if meta:  # each distinct unmasked metadata row, (d+1) floats each way; the items' ids and masks
        mids, mm = feat["meta_ids"][items], feat["meta_mask"][items]
        nf, nw = mids.shape[1:]
        for f in range(nf):
            nbytes += torch.unique(mids[:, f][mm[:, f]]).numel() * 2 * (D + 1) * 4
        nbytes += items.numel() * nf * nw * 9
        per_row_bytes += 2 * b * nf * nw * (2 * (D + 1) * 4 + 9)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    # host time per call: the wrapper against its bare C call (the same arguments)
    scratch = torch.empty((lib.trs_fused_pairwise_step_scratch(int(meta), b, *(
        feat["meta_ids"].shape[1:] if meta else (0, 0))),), device=DEVICE)
    wd = w.to(torch.float32).contiguous() if w is not None else None
    args = fp._step_args(packed["user"], packed["item"], (uid, pid, nid), wd, fp.step_inv(b, w, ws), 0.01, D,
                         tr.cfg.margin, tr.cfg.loss, False, 1e-10, False, lead[2:] if meta else None,
                         scratch.data_ptr(), lo.data_ptr(), stream)
    wrap_us = host_ms(torch, call, reps=2000)[0] * 1e3
    bare_us = host_ms(torch, lambda: check(lib.trs_fused_pairwise_step(*args) == 0, "bare call"), reps=2000)[0] * 1e3
    wrapper.launches = saved  # timing launches are not main-path launches
    log(f"[time] {name} (B={b}, D={D}, {tr.cfg.loss}{', weighted' if w is not None else ''}): {ms:.4f} ms by CUDA "
        f"events (host-bound back to back); device {dev_us:.2f} us per call over {per_call} kernels "
        f"(torch.profiler); bound {bound_ms:.5f} ms ({nbytes / 1e6:.3f} MB: {items.numel()} distinct items, "
        f"{users} users, {user_row}/{sectors(D + 3)} bytes per user/item row each way; context: "
        f"{per_row_bytes / PEAK_BYTES * 1e3:.5f} ms for every batch row's whole 512-byte rows); "
        f"launch floor {floor_us:.2f} us per empty kernel on the same grid, "
        f"{2 * floor_us:.2f} for the step's two = {2 * floor_us / dev_us:.0%} of its device time; "
        f"plain step {plain_ms:.4f} ms; library: none")
    log(f"[time] {name} host us per call (B={b}): wrapper {wrap_us:.2f}, its bare C call {bare_us:.2f}")
    return {
        "name": name, "route": "cuda", "source": TRAIN_SOURCE, "replaces": TRAIN_REPLACES,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None,
    }


def device_call(torch, fn, calls: int = 20):
    """(device us per call, kernels per call) of ``fn`` from torch.profiler
    over ``calls`` calls after one warm call: a fast kernel's back-to-back
    CUDA-event time can be its wrapper's host time. Each kernel counts at
    its mean time per launch, so a launch the profiler drops does not
    lower the sum (every wrapper here launches each of its kernels once
    per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window in which the profiler recorded no kernel is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = n = 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            if t > 0 and e.count:
                us += t / e.count
                n += 1
        if n:
            break
    return us, n


def ce_timing(torch, inputs, errs, launches):
    """The CE kernels' JSON rows: CUDA-event ms at the main path's shape
    (B=4096, D=80), the bound, the plain versions' ms. No single PyTorch
    call masks duplicate positives, so library_ms is null; the bare
    ``torch.matmul(h, v.T)`` is printed as context only."""
    from torchrecsys_tpu_torch.ops import softmax_ce as sce

    h, v, vbq, pos, g, lse = inputs
    b, d = h.shape
    torch.backends.cuda.matmul.allow_tf32 = False
    saved = (sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches)
    ms = {
        "softmax_ce_fwd": cuda_ms(torch, lambda: sce.softmax_ce_fwd(h, v, vbq, pos), reps=50),
        "softmax_ce_bwd": cuda_ms(torch, lambda: sce.softmax_ce_bwd(h, v, vbq, pos, lse, g), reps=50),
    }
    plain_ms = {
        "softmax_ce_fwd": cuda_ms(torch, lambda: sce.softmax_ce_fwd_plain(h, v, vbq, pos)),
        "softmax_ce_bwd": cuda_ms(torch, lambda: sce.softmax_ce_bwd_plain(h, v, vbq, pos, lse, g)),
    }
    mm_ms = cuda_ms(torch, lambda: torch.matmul(h, v.T), reps=50)
    dev = {
        "softmax_ce_fwd": device_call(torch, lambda: sce.softmax_ce_fwd(h, v, vbq, pos)),
        "softmax_ce_bwd": device_call(torch, lambda: sce.softmax_ce_bwd(h, v, vbq, pos, lse, g)),
    }
    check(dev["softmax_ce_fwd"][1] <= 3, f"CE forward: {dev['softmax_ce_fwd'][1]} kernels per call "
          "(split, products and combine expected)")
    check(dev["softmax_ce_bwd"][1] <= 2, f"CE backward: {dev['softmax_ce_bwd'][1]} kernels per call "
          "(one pass and one sum expected)")
    sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches = saved
    in_bytes = 2 * b * d * 4 + b * 4 + b * 8  # h, v, vbq, pos (int64)
    work = {  # (operations, bytes): each input read once, each output written once
        "softmax_ce_fwd": (2.0 * b * b * d, in_bytes + 2 * b * 4),
        "softmax_ce_bwd": (6.0 * b * b * d, in_bytes + 2 * b * 4 + 2 * b * d * 4 + b * 4),
    }
    rows = []
    for name, (flops, nbytes) in work.items():
        # the least time for f32-accurate products: split products on the
        # tensor cores (3xTF32 at a third of the TF32 peak)
        bound_ms = max(flops / SPLIT_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        by = "operations" if flops / SPLIT_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        us, n_k = dev[name]
        log(f"[time] {name} (B={b}, D={d}, f32): {ms[name]:.4f} ms (device {us:.2f} us per call over "
            f"{n_k} kernel(s), torch.profiler); bound {bound_ms:.4f} ms ({by}, {flops / 1e9:.2f} GFLOP at "
            f"{SPLIT_F32_FLOPS / 1e12:.0f} TFLOP/s; {flops / PEAK_F32_FLOPS * 1e3:.4f} ms at the CUDA cores' "
            f"{PEAK_F32_FLOPS / 1e12:.0f}); plain {plain_ms[name]:.4f} ms; library: none")
        rows.append({
            "name": name, "route": "cuda", "source": CE_SOURCE, "replaces": CE_REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
        })
    log(f"[time] context, not a port path: torch.matmul(h, v.T) at ({b}, {d}) x ({d}, {b}) f32 "
        f"{mm_ms:.4f} ms")
    return rows


def _ln_inputs(torch, gen, rows: int, d: int, dtype):
    """x and dy (rows, d) with 30% of the rows zero (padding), scale ~ 1 +
    N(0, 0.1^2), bias ~ N(0, 0.1^2), all in ``dtype``; and the zero rows."""
    x = torch.randn((rows, d), generator=gen, device=DEVICE)
    zero = torch.rand((rows,), generator=gen, device=DEVICE) < 0.3
    x[zero] = 0.0
    dy = torch.randn((rows, d), generator=gen, device=DEVICE)
    dy[zero] = 0.0
    scale = 1.0 + 0.1 * torch.randn((d,), generator=gen, device=DEVICE)
    bias = 0.1 * torch.randn((d,), generator=gen, device=DEVICE)
    return [t.to(dtype) for t in (x, dy, scale, bias)] + [zero]


def layer_norm_accuracy(torch, gen, rows: int, d: int, dtype, unit: bool = False) -> dict:
    """#8 against float64: y, dx, dscale and dbias of the kernels and of
    layer_norm_plain's autograd in ``dtype``, each as ||got - ref|| /
    ||ref|| against layer_norm_plain's autograd in float64 on the same
    inputs. Each kernel gap must be within max(2 x the plain gap, 1e-6);
    padded rows give y == bias and dx == 0 exactly. With ``unit`` the
    scale and bias are the ones and zeros that ``layer_norm_unit`` keeps
    (HSTU's norms), and that entry's forward must equal the kernel's y
    exactly. Returns the gaps and max |kernel - plain| of y and dx."""
    from torchrecsys_tpu_torch.ops import layer_norm as ln

    x, dy, scale, bias, zero = _ln_inputs(torch, gen, rows, d, dtype)
    if unit:
        y_unit = ln.layer_norm_unit(x, LN_EPS)
        scale, bias = ln._UNIT[(d, dtype, x.device)]
    y, mean, rstd = ln.layer_norm_fwd(x, scale, bias, LN_EPS)
    if unit:
        check(torch.equal(y_unit, y), f"layer_norm_unit {rows} x {d} {dtype}: its forward is not the kernel's y")
    got = (y,) + ln.layer_norm_bwd(x, dy, scale, mean, rstd)

    def plain(dt):
        leaves = [t.detach().to(dt).requires_grad_() for t in (x, scale, bias)]
        yp = ln.layer_norm_plain(*leaves, LN_EPS)
        return (yp.detach(),) + torch.autograd.grad(yp, leaves, dy.to(dt))

    low, ref = plain(dtype), plain(torch.float64)

    def gap(a, r):
        den = float(r.norm())
        return float((a.double() - r).norm()) / (den if den > 0 else 1.0)

    out = {"rows": rows, "d": d}
    for name, k, p, r in zip(("y", "dx", "dscale", "dbias"), got, low, ref):
        check(bool(torch.isfinite(k.float()).all()), f"layer_norm {rows} x {d} {dtype}: {name} not finite")
        k_gap, p_gap = gap(k, r), gap(p, r)
        check(k_gap <= max(2 * p_gap, 1e-6), f"layer_norm {rows} x {d} {dtype}: {name} {k_gap:.3e} off float64, "
              f"beyond max(2 x the plain version's {p_gap:.3e}, 1e-6)")
        out[name] = {"gap": k_gap, "plain_gap": p_gap}
    check(torch.equal(y[zero], bias.expand(int(zero.sum()), d)) and not bool(got[1][zero].any()),
          f"layer_norm {rows} x {d} {dtype}: a padded row's y is not bias or its dx not 0")
    out["err"] = {"fwd": float((y.float() - low[0].float()).abs().max()),
                  "bwd": float((got[1].float() - low[1].float()).abs().max())}
    out["unit"] = unit
    log(f"[check] layer_norm ({rows} x {d}, {str(dtype)[6:]}{', unit affine' if unit else ''}): gap to float64, "
        "kernel (plain) "
        + ", ".join(f"{n} {out[n]['gap']:.3e} ({out[n]['plain_gap']:.3e})" for n in ("y", "dx", "dscale", "dbias"))
        + f"; max |kernel - plain| y {out['err']['fwd']:.3g}, dx {out['err']['bwd']:.3g}")
    return out


def layer_norm_timing(torch):
    """The layer-norm kernels' JSON rows (#8, which replace no TPU kernel).
    Each is first held to float64 (:func:`layer_norm_accuracy`) at the
    SASRec cell's shape (LN_ROWS x LN_D) in f32 and bf16, at 6o's AMP
    encoder (LN_AMP_ROWS x D) in bf16 and at the HSTU cell's (LN_HSTU_ROWS
    x LN_D) in f32 with ``layer_norm_unit``'s ones and zeros. Then
    CUDA-event ms and device us a call at the SASRec cell's shape (30% of the rows zero), f32 and bf16, beside
    the bound (x and y forward, x, dy and dx backward, each moved once,
    plus the f32 mean and rstd, over 3.35 TB/s) and the plain chain's ms
    (layer_norm_plain's forward; the autograd backward of its ops) and of
    ``F.layer_norm`` (library, which the port never calls). launches are
    filled in by main from 6o's SASRec fit."""
    import torch.nn.functional as F

    from torchrecsys_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device=DEVICE).manual_seed(23)
    rows_, d = LN_ROWS, LN_D
    saved = (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches)
    acc = {dt: layer_norm_accuracy(torch, gen, rows_, d, dt) for dt in (torch.float32, torch.bfloat16)}
    amp_acc = layer_norm_accuracy(torch, gen, LN_AMP_ROWS, D, torch.bfloat16)
    hstu_acc = layer_norm_accuracy(torch, gen, LN_HSTU_ROWS, d, torch.float32, unit=True)
    torch.cuda.empty_cache()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, dy, scale, bias, _ = _ln_inputs(torch, gen, rows_, d, dtype)
        y, mean, rstd = ln.layer_norm_fwd(x, scale, bias, LN_EPS)
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        yp = ln.layer_norm_plain(*leaves, LN_EPS)
        yl = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], LN_EPS)
        calls = {"fwd": lambda: ln.layer_norm_fwd(x, scale, bias, LN_EPS),
                 "bwd": lambda: ln.layer_norm_bwd(x, dy, scale, mean, rstd)}
        plain = {"fwd": lambda: ln.layer_norm_plain(x, scale, bias, LN_EPS),
                 "bwd": lambda: torch.autograd.grad(yp, leaves, dy, retain_graph=True)}
        library = {"fwd": lambda: F.layer_norm(x, (d,), scale, bias, LN_EPS),
                   "bwd": lambda: torch.autograd.grad(yl, leaves, dy, retain_graph=True)}
        es, n = x.element_size(), rows_ * d
        nbytes = {"fwd": 2 * n * es + 8 * rows_ + 2 * d * es, "bwd": 3 * n * es + 8 * rows_ + 3 * d * es}
        for part in ("fwd", "bwd"):
            us, n_k = device_call(torch, calls[part])
            check(n_k == (1 if part == "fwd" else 2), f"layer_norm_{part} {dtype}: {n_k} kernels per call "
                  "(forward: one; backward: the rows and the column sums)")
            out[(part, dtype)] = r = {
                "ms": cuda_ms(torch, calls[part], reps=50), "device_us": us, "plain_ms": cuda_ms(torch, plain[part]),
                "library_ms": cuda_ms(torch, library[part]), "bound_ms": nbytes[part] / PEAK_BYTES * 1e3,
                "err": acc[dtype]["err"][part], "gap_f64": acc[dtype],
            }
            log(f"[time] layer_norm_{part} ({rows_} x {d}, {str(dtype)[6:]}): {r['ms']:.4f} ms (device "
                f"{us:.2f} us per call over {n_k} kernel(s), torch.profiler); bound {r['bound_ms']:.4f} ms "
                f"(bytes, {nbytes[part] / 1e6:.1f} MB at {PEAK_BYTES / 1e12:.2f} TB/s); plain chain "
                f"{r['plain_ms']:.4f} ms; library (F.layer_norm) {r['library_ms']:.4f} ms")
    ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches = saved
    rows = []
    for part in ("fwd", "bwd"):
        f32, b16 = out[(part, torch.float32)], out[(part, torch.bfloat16)]
        rows.append({
            "name": f"layer_norm_{part}", "route": "cuda", "source": LN_SOURCE, "replaces": LN_REPLACES,
            "launches": 0, "max_abs_err": f32["err"], "gap_f64": f32["gap_f64"], "ms": f32["ms"],
            "device_us": f32["device_us"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": "bytes", "library_ms": f32["library_ms"], "bf16": b16, "amp_6o_gap_f64": amp_acc,
            "hstu_gap_f64": hstu_acc,
        })
    return rows


def _ha_inputs(torch, gen, b: int, length: int, dtype):
    """q, k, v as strided views of one (B, L, 4 h dh) projection (as the
    model passes them), w (2L - 1,), dO, each N(0, 0.45^2) (q . k of order
    one, so every SiLU bends), and the cell's windows: from position 0,
    lengths HA_MIN_LEN .. L, the positive's hole (1% of positions)."""
    width = HA_HEADS * HA_DH
    uvqk = torch.randn((b, length, 4 * width), generator=gen, device=DEVICE) * 0.45
    _, v, q, k = torch.split(uvqk.to(dtype), width, dim=-1)
    w = (torch.randn((2 * length - 1,), generator=gen, device=DEVICE) * 0.45).to(dtype)
    dout = torch.randn((b, length, width), generator=gen, device=DEVICE).to(dtype)
    n = torch.randint(HA_MIN_LEN, length + 1, (b,), generator=gen, device=DEVICE)
    valid = torch.arange(length, device=DEVICE)[None] < n[:, None]
    valid &= torch.rand((b, length), generator=gen, device=DEVICE) > 0.01
    return q, k, v, w, valid.contiguous(), dout


def hstu_attention_accuracy(torch, q, k, v, w, valid, dout) -> dict:
    """#9 against float64 at the cell's shape: o, dq, dk, dv and dw of the
    kernels and of pointwise_attention_plain's autograd in f32 (TF32 off),
    each as ||got - ref|| / ||ref|| against the plain version's autograd in
    float64 (in chunks of HA_CHUNK histories, dw summed over them in
    float64). Each kernel gap must be within max(2 x the plain gap, 1e-6),
    dw past L - 1 must be 0, and a second backward must give the same bits.
    Returns the gaps and max |kernel - plain f32| of o and dq."""
    from torchrecsys_tpu_torch.ops import hstu_attention as ha

    names = ("o", "dq", "dk", "dv", "dw")
    o = ha.hstu_attention_fwd(q, k, v, w, valid, HA_HEADS)
    grads = ha.hstu_attention_bwd(q, k, v, w, valid, dout, HA_HEADS)
    again = ha.hstu_attention_bwd(q, k, v, w, valid, dout, HA_HEADS)
    check(all(torch.equal(a, b) for a, b in zip(grads, again)), "hstu_attention_bwd: two runs differ")
    got = (o,) + grads
    del again

    def plain(rows, dt):
        leaves = [t[rows].detach().to(dt).requires_grad_() for t in (q, k, v)] + [w.detach().to(dt).requires_grad_()]
        op = ha.pointwise_attention_plain(*leaves, valid[rows], HA_HEADS)
        return (op.detach(),) + torch.autograd.grad(op, leaves, dout[rows].to(dt))

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        low = plain(slice(None), torch.float32)
        torch.cuda.empty_cache()
        sq = {n: [0.0, 0.0, 0.0] for n in names}  # sum (kernel - ref)^2, (plain - ref)^2, ref^2
        dw_ref = torch.zeros_like(w, dtype=torch.float64)
        for r0 in range(0, q.shape[0], HA_CHUNK):
            rows = slice(r0, r0 + HA_CHUNK)
            ref = plain(rows, torch.float64)
            for n, g, lo, r in zip(names[:4], got[:4], low[:4], ref[:4]):
                sq[n][0] += float((g[rows].double() - r).square().sum())
                sq[n][1] += float((lo[rows].double() - r).square().sum())
                sq[n][2] += float(r.square().sum())
            dw_ref += ref[4]
            del ref
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    sq["dw"] = [float((got[4].double() - dw_ref).square().sum()), float((low[4].double() - dw_ref).square().sum()),
                float(dw_ref.square().sum())]
    out = {"shape": [int(q.shape[0]), int(q.shape[1]), HA_HEADS, HA_DH]}
    for n in names:
        den = sq[n][2] ** 0.5 or 1.0
        k_gap, p_gap = sq[n][0] ** 0.5 / den, sq[n][1] ** 0.5 / den
        check(bool(torch.isfinite(got[names.index(n)]).all()), f"hstu_attention: {n} not finite")
        check(k_gap <= max(2 * p_gap, 1e-6), f"hstu_attention: {n} {k_gap:.3e} off float64, beyond max(2 x the "
              f"plain version's {p_gap:.3e}, 1e-6)")
        out[n] = {"gap": k_gap, "plain_gap": p_gap}
    check(not bool(grads[3][q.shape[1]:].any()), "hstu_attention_bwd: dw past L - 1 is not 0")
    out["err"] = {"fwd": float((o - low[0]).abs().max()), "bwd": float((grads[0] - low[1]).abs().max())}
    log(f"[check] hstu_attention ({' x '.join(map(str, out['shape']))}, f32): gap to float64, kernel (plain) "
        + ", ".join(f"{n} {out[n]['gap']:.3e} ({out[n]['plain_gap']:.3e})" for n in names)
        + f"; max |kernel - plain| o {out['err']['fwd']:.3g}, dq {out['err']['bwd']:.3g}; two backward runs "
        "bit for bit")
    return out


def tile_pairs(torch, valid) -> dict:
    """(pairs computed, pairs in the square) a head, summed over the (B, L)
    mask's histories, by kernel pair #9's skipping rule
    (ops/csrc/hstu_attention.cu), in 16 x 16 (tile, block) pairs. Forward
    and the backward's dq units: a 16-row query tile against a 16-key
    block, computed when the block starts at or before the tile's last row
    below L and holds a valid key. The backward's dk / dv units: a 16-key
    tile against a 16-query block, computed when the key tile holds a valid
    key and the block ends at or after the tile's first key. The square:
    ((L padded to 16) / 16)^2 pairs a history."""
    bsz, length = valid.shape
    nb = -(-length // 16)
    padded_valid = torch.zeros((bsz, nb * 16), dtype=torch.bool, device=valid.device)
    padded_valid[:, :length] = valid
    blocks = padded_valid.reshape(bsz, nb, 16).any(dim=2)  # (B, nb)
    c = torch.arange(nb, device=valid.device)
    last = torch.clamp(16 * c + 15, max=length - 1) // 16  # a query tile's last key block
    fwd = int((blocks[:, None, :] & (c[None, None, :] <= last[None, :, None])).sum())
    blocks_from = ((length - 1) // 16 + 1 - c).clamp_min(0)  # query blocks kt .. (L - 1) // 16
    bwd_kv = int((blocks.long() * blocks_from[None]).sum())
    square = bsz * nb * nb
    return {"fwd": (fwd, square), "bwd_dq": (fwd, square), "bwd_dkdv": (bwd_kv, square)}


def hstu_attention_timing(torch):
    """Kernel pair #9's JSON rows (HSTU's pointwise attention, which
    replaces no TPU kernel). First held to float64 at the HSTU cell's shape
    (:func:`hstu_attention_accuracy`: 8192 histories x 2 heads x 200 x 25,
    f32, the cell's windows). Then CUDA-event ms and device us a call,
    beside two bounds (operations over the 3xTF32-held f32 rate of 165
    TFLOP/s, or bytes over 3.35 TB/s, whichever is larger): over the full
    L x L square (forward 2 products, backward 5, each 2 dh flops a pair;
    q, k, v, o and dO, dq, dk, dv moved once) and over the pairs the masks
    leave; the share of (tile, block) pairs the kernels compute, counted on
    the host by their rule (:func:`tile_pairs`); the plain chain's ms
    (pointwise_attention_plain's forward; the autograd backward of its ops).
    No single PyTorch call computes a pointwise, unnormalised, masked
    attention, so library is none. launches: filled in by main from
    :func:`hstu_fit_path`'s fit."""
    from torchrecsys_tpu_torch.ops import hstu_attention as ha

    gen = torch.Generator(device=DEVICE).manual_seed(29)
    q, k, v, w, valid, dout = _ha_inputs(torch, gen, HA_B, HA_L, torch.float32)
    acc = hstu_attention_accuracy(torch, q, k, v, w, valid, dout)
    torch.cuda.empty_cache()
    i = torch.arange(HA_L, device=DEVICE)
    pairs = int(((i[None, :] <= i[:, None])[None] & valid[:, None, :]).sum()) * HA_HEADS
    square = HA_B * HA_HEADS * HA_L * HA_L
    tiles = {kk: a / b for kk, (a, b) in tile_pairs(torch, valid).items()}
    elems = HA_B * HA_L * HA_HEADS * HA_DH
    nbytes = {"fwd": 4 * elems * 4, "bwd": 7 * elems * 4}
    flops = {"fwd": 2 * 2 * HA_DH * square, "bwd": 5 * 2 * HA_DH * square}
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, w)]
    op = ha.pointwise_attention_plain(*leaves, valid, HA_HEADS)
    calls = {"fwd": lambda: ha.hstu_attention_fwd(q, k, v, w, valid, HA_HEADS),
             "bwd": lambda: ha.hstu_attention_bwd(q, k, v, w, valid, dout, HA_HEADS)}
    plain = {"fwd": lambda: ha.pointwise_attention_plain(q, k, v, w, valid, HA_HEADS),
             "bwd": lambda: torch.autograd.grad(op, leaves, dout, retain_graph=True)}
    rows = []
    for part in ("fwd", "bwd"):
        us, n_k = device_call(torch, calls[part], calls=10)
        check(n_k == (1 if part == "fwd" else 2), f"hstu_attention_{part}: {n_k} kernels per call "
              "(forward: one; backward: the problems and dw's column sums)")
        t_ops, t_bytes = flops[part] / SPLIT_F32_FLOPS * 1e3, nbytes[part] / PEAK_BYTES * 1e3
        t_masked = t_ops * pairs / square
        bound, masked = max(t_ops, t_bytes), max(t_masked, t_bytes)
        r = {"ms": cuda_ms(torch, calls[part], reps=10), "device_us": us,
             "plain_ms": cuda_ms(torch, plain[part], reps=3), "bound_ms": bound, "bound_masked_ms": masked,
             "pairs_share": pairs / square}
        r["tile_share"] = tiles["fwd"] if part == "fwd" else (tiles["bwd_dq"] + tiles["bwd_dkdv"]) / 2
        log(f"[time] hstu_attention_{part} ({HA_B} x {HA_HEADS} x {HA_L} x {HA_DH}, f32): {r['ms']:.4f} ms (device "
            f"{us:.2f} us per call over {n_k} kernel(s), torch.profiler); bound {bound:.4f} ms over the square "
            f"({flops[part] / 1e9:.1f} GFLOP at {SPLIT_F32_FLOPS / 1e12:.0f} TFLOP/s, {nbytes[part] / 1e9:.2f} GB at "
            f"{PEAK_BYTES / 1e12:.2f} TB/s), {masked:.4f} ms over the unmasked pairs ({pairs / square:.3f} of the "
            f"square); tile pairs computed {r['tile_share']:.3f} of the square; plain chain {r['plain_ms']:.4f} ms; "
            "library none")
        rows.append({
            "name": f"hstu_attention_{part}", "route": "cuda", "source": HA_SOURCE, "replaces": HA_REPLACES,
            "launches": 0, "max_abs_err": acc["err"][part], "gap_f64": acc, "ms": r["ms"], "device_us": us,
            "plain_ms": r["plain_ms"], "bound_ms": bound, "bound_masked_ms": masked,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bound_masked_by": "operations" if t_masked > t_bytes else "bytes",
            "pairs_share": r["pairs_share"], "tile_share": r["tile_share"], "library_ms": None,
        })
    return rows


def hstu_fit_path(torch):
    """Kernel pair #9 on the main path: one epoch of HSTU's fit at the
    benchmark cell's widths (d = 50, window 200, 8 blocks of 2 heads; BCE
    against one dynamic negative, adam at lr 0.001, batch 8192) through
    build_model and the Trainer, over HA_FIT_ROWS uniform interactions of
    HA_FIT_USERS users and HA_FIT_ITEMS items (windows of ~136 train items,
    as the cell's ~131). #9's launch counts are set to 0 just before the
    fit and must read 8 + 8 a step (a forward and a backward a block), #8's
    16 + 16; the epoch loss must be finite. Returns #9's (forward,
    backward) launches, the steps and the fit's seconds."""
    from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
    from torchrecsys_tpu_torch.data import prepare_data
    from torchrecsys_tpu_torch.models import build_model
    from torchrecsys_tpu_torch.ops import hstu_attention as ha
    from torchrecsys_tpu_torch.train import Trainer

    r = np.random.default_rng(25)
    users = np.concatenate([np.arange(HA_FIT_USERS), r.integers(0, HA_FIT_USERS, HA_FIT_ROWS - HA_FIT_USERS)])
    items = np.concatenate([np.arange(HA_FIT_ITEMS), r.integers(0, HA_FIT_ITEMS, HA_FIT_ROWS - HA_FIT_ITEMS)])
    store = prepare_data({"user_id": users, "item_id": items}, "user_id", "item_id", split_ratio=0.8,
                         dynamic_neg_sampling=True, seed=25)
    blocks = 8
    model = build_model(store.schema, ModelConfig(net_type="hstu", n_factors=HA_HEADS * HA_DH, history_len=HA_L,
                                                  hstu_blocks=blocks, hstu_heads=HA_HEADS)).to(DEVICE)
    trainer = Trainer(model, TrainConfig(batch_size=HA_B, learning_rate=0.001, loss="logistic",
                                         dense_optimizer="adam", dynamic_neg_sampling=True, seed=25), DEVICE)
    state = trainer.init_state()
    steps = -(-store.num_train // HA_B)
    ln0 = ln_launches()
    ha.hstu_attention_fwd.launches = ha.hstu_attention_bwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = trainer.fit(state, store, epochs=1, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    attn = (ha.hstu_attention_fwd.launches, ha.hstu_attention_bwd.launches)
    norms = tuple(b - a for a, b in zip(ln0, ln_launches()))
    check(attn == (blocks * steps,) * 2, f"HSTU fit: #9 launched {attn} times, want {blocks} of each a step "
          f"({steps} steps)")
    check(norms == (2 * blocks * steps,) * 2, f"HSTU fit: #8 launched {norms} times, want {2 * blocks} of each a "
          f"step ({steps} steps)")
    check(len(losses) == 1 and np.isfinite(losses[0]), f"HSTU fit: epoch loss {losses} is not finite")
    log(f"[train] HSTU (d {HA_HEADS * HA_DH}, window {HA_L}, {blocks} blocks of {HA_HEADS} heads): fit {steps} "
        f"steps of {HA_B} in {fit_s:.3f} s (first epoch, builds included); epoch loss {losses[0]:.5f}; #9 "
        f"launches {attn[0]} + {attn[1]}, #8 {norms[0]} + {norms[1]}, counted from 0 before the fit")
    return {"launches": attn, "steps": steps, "fit_s": fit_s}


def softmax_breakdown(torch, rs, label: str, window: int = 60):
    """Per-step breakdown of the softmax fit: epoch build and table
    augmentation (host clock, per epoch), host ms per step, and device us
    per step by part from torch.profiler over ``window`` steps, with the
    device's idle share in that window."""
    from torchrecsys_tpu_torch.ops import softmax_ce as sce
    from torchrecsys_tpu_torch.train.optim import augment_tables

    tr = rs.trainer
    data, feat = tr._device_train_data(rs.store), tr.feature_tables(rs.store)
    saved = (sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches)
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    keys = torch.arange(6, device=DEVICE) + 50
    build_ms, _ = host_ms(torch, lambda: tr.build_epoch(data, keys, gen), reps=3)
    ep = tr.build_epoch(data, keys, gen)
    window = min(window, (ep.nb - 5) // 2)
    aug_ms, aug = host_ms(torch, lambda: augment_tables(rs.state["tables"], rs.state["emb_opt"]), reps=2)
    tr.run_softmax_steps(rs.state, aug, ep, feat, steps=range(5))  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run_softmax_steps(rs.state, aug, ep, feat, steps=range(5, 5 + window))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / window * 1e3
    prof, wall_us = profiled_window(
        torch, lambda: tr.run_softmax_steps(rs.state, aug, ep, feat, steps=range(0, 2)),
        lambda: tr.run_softmax_steps(rs.state, aug, ep, feat, steps=range(5 + window, 5 + 2 * window)))
    sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches = saved
    split = device_split(prof)
    parts = {"gathers": 0.0, "ce_fwd": 0.0, "ce_bwd": 0.0, "autograd_elementwise": 0.0, "scatters": 0.0}
    for name, us in split.items():
        if "softmax_ce_fwd" in name:
            parts["ce_fwd"] += us
        elif "softmax_ce_bwd" in name:  # the one pass and its sum
            parts["ce_bwd"] += us
        elif "indexSelect" in name or "index_elementwise" in name or "gather" in name.lower():
            parts["gathers"] += us
        elif "indexFunc" in name or "index_add" in name or "scatter" in name.lower():
            parts["scatters"] += us
        else:  # autograd of pair_vectors, the loss weighting, the adagrad rows, cat
            parts["autograd_elementwise"] += us
    busy = sum(split.values())
    log(f"[breakdown] fit {label}: epoch build {build_ms:.3f} ms, table augmentation {aug_ms:.3f} ms per "
        f"epoch; {step_ms:.4f} ms per step (host clock, {window} steps of {ep.b})")
    log(f"[breakdown] fit {label}: device us per step: " + ", ".join(
        f"{k} {v / window:.2f}" for k, v in parts.items()
    ) + f"; device busy {busy / window:.2f} of {wall_us / window:.2f} us per step under the "
        f"profiler = idle share {1 - busy / wall_us:.3f}")
    top = sorted(split.items(), key=lambda kv: -kv[1])[:8]

    def short(k):
        k = k.replace("(anonymous namespace)::", "").removeprefix("void ")
        return re.sub(r"[<(].*", "", k).removeprefix("at::native::")[:40]

    log(f"[profile] fit {label}: top kernels, device us per step: " + "; ".join(
        f"{short(k)} {v / window:.2f}" for k, v in top
    ))
    return {"step_ms": step_ms, "idle_share": 1 - busy / wall_us,
            "ce_fwd_us": parts["ce_fwd"] / window, "ce_bwd_us": parts["ce_bwd"] / window}


def tower_timing(torch, inputs, errs, launches):
    """The tower kernels' JSON rows: CUDA-event ms per launch at the main
    path's two layer shapes and their mean (one launch of each per layer per
    step), the bound from the TPU kernels' own CostEstimates
    (fused_tower.py:122-128, :227-233) over 3.35 TB/s and 989 TFLOP/s bf16,
    the plain versions' ms. No single PyTorch call computes the layer with
    its statistics (or its fused backward), so library_ms is null; the bare
    bf16 torch.matmul products of each are printed as context only."""
    from torchrecsys_tpu_torch.ops import fused_tower as ft

    saved = (ft.fused_tower_fwd.launches, ft.fused_tower_bwd.launches)
    acc = {name: {"ms": [], "plain_ms": [], "bound_ms": [], "by": [], "device_ms": []} for name in TOWER_REPLACES}
    for x, w, b, bn, z, dz, dstat, has_bn in inputs:
        r, din = x.shape
        dout = w.shape[1]
        h = ft.bn_relu(x, bn)[0] if has_bn else x
        work = {  # (operations, bytes): the TPU kernels' cost estimates
            "fused_tower_fwd": (2.0 * r * din * dout,
                                2 * (r * din + r * dout + din * dout) + 4 * 2 * dout),
            "fused_tower_bwd": (4.0 * r * din * dout,
                                2 * (2 * r * din + 2 * r * dout + din * dout)
                                + 4 * (din * dout + dout + 4 * din)),
        }
        ms = {"fused_tower_fwd": cuda_ms(torch, lambda: ft.fused_tower_fwd(x, w, b, bn, has_bn), reps=50),
              "fused_tower_bwd": cuda_ms(torch, lambda: ft.fused_tower_bwd(x, z, dz, w, bn, dstat, has_bn),
                                         reps=50)}
        plain = {"fused_tower_fwd": cuda_ms(torch, lambda: ft.fused_tower_fwd_plain(x, w, b, bn, has_bn)),
                 "fused_tower_bwd": cuda_ms(torch, lambda: ft.fused_tower_bwd_plain(x, z, dz, w, bn, dstat,
                                                                                    has_bn))}
        dev = {"fused_tower_fwd": device_call(torch, lambda: ft.fused_tower_fwd(x, w, b, bn, has_bn)),
               "fused_tower_bwd": device_call(torch, lambda: ft.fused_tower_bwd(x, z, dz, w, bn, dstat, has_bn))}
        mm = {"fused_tower_fwd": cuda_ms(torch, lambda: torch.matmul(h, w), reps=50),
              "fused_tower_bwd": cuda_ms(torch, lambda: (torch.matmul(dz, w.T), torch.matmul(h.T, dz)),
                                         reps=50)}
        for name, (flops, nbytes) in work.items():
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
            bound_ms = max(t_ops, t_bytes) * 1e3
            by = "operations" if t_ops >= t_bytes else "bytes"
            us, n_k = dev[name]
            for key, v in (("ms", ms[name]), ("plain_ms", plain[name]), ("bound_ms", bound_ms), ("by", by),
                           ("device_ms", us / 1e3)):
                acc[name][key].append(v)
            log(f"[time] {name} (R={r}, {din} -> {dout}, bn={has_bn}, bf16): {ms[name]:.4f} ms (device "
                f"{us:.2f} us per call over {n_k} kernel(s), torch.profiler); bound "
                f"{bound_ms:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); plain "
                f"{plain[name]:.4f} ms; library: none (context: bf16 torch.matmul of its product(s) "
                f"{mm[name]:.4f} ms)")
    ft.fused_tower_fwd.launches, ft.fused_tower_bwd.launches = saved
    rows = []
    for name, a in acc.items():
        check(len(set(a["by"])) == 1, f"{name}: the layers are bound by different resources")
        rows.append({
            "name": name, "route": "cuda", "source": TOWER_SOURCE, "replaces": TOWER_REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name], "ms": float(np.mean(a["ms"])),
            "plain_ms": float(np.mean(a["plain_ms"])), "bound_ms": float(np.mean(a["bound_ms"])),
            "bound_by": a["by"][0], "library_ms": None,
        })
        log(f"[time] {name}: mean per launch over the two main-path layers {rows[-1]['ms']:.4f} ms "
            f"(device {np.mean(a['device_ms']):.4f} ms), "
            f"bound {rows[-1]['bound_ms']:.4f} ms, plain {rows[-1]['plain_ms']:.4f} ms")
    return rows


def mlp_breakdown(torch, rs, window: int = 40, label: str = "MLP AMP"):
    """Per-step breakdown of an autograd pairwise fit (the MLP's; 6k's and
    6l's): the epoch build (host clock), host ms per step, and device us
    per step by part from torch.profiler over ``window`` steps, with the
    device's idle share in that window."""
    from torch.profiler import ProfilerActivity, profile

    from torchrecsys_tpu_torch.ops import fused_tower as ft
    from torchrecsys_tpu_torch.train.optim import augment_tables

    tr = rs.trainer
    data, feat = tr._device_train_data(rs.store), tr.feature_tables(rs.store)
    saved = (ft.fused_tower_fwd.launches, ft.fused_tower_bwd.launches)
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    keys = torch.arange(6, device=DEVICE) + 60
    build_ms, _ = host_ms(torch, lambda: tr.build_epoch(data, keys, gen, feat), reps=3)
    ep = tr.build_epoch(data, keys, gen, feat)
    n_host = 5  # steps under the CPU profiler
    window = min(window, (ep.nb - 5 - n_host) // 2)
    st = dict(rs.state)
    aug = augment_tables(st["tables"], st["emb_opt"])
    tr.run_pairwise_steps(st, aug, ep, feat, steps=range(5))  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run_pairwise_steps(st, aug, ep, feat, steps=range(5, 5 + window))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / window * 1e3
    prof, wall_us = profiled_window(
        torch, lambda: tr.run_pairwise_steps(st, aug, ep, feat, steps=range(0, 2)),
        lambda: tr.run_pairwise_steps(st, aug, ep, feat, steps=range(5 + window, 5 + 2 * window)))
    ft.fused_tower_fwd.launches, ft.fused_tower_bwd.launches = saved
    split = device_split(prof)
    parts = {"gathers": 0.0, "tower_fwd": 0.0, "tower_bwd": 0.0, "tower_sums": 0.0,
             "head_loss_bn_math": 0.0, "dense_optimizer": 0.0, "scatters": 0.0}
    for name, us in split.items():
        if "fused_tower_fwd" in name:
            parts["tower_fwd"] += us
        elif "sum_splits" in name or "fused_tower_bwd_sum" in name:  # fixed-order partial sums
            parts["tower_sums"] += us
        elif "fused_tower_bwd" in name:  # the dh and dW products
            parts["tower_bwd"] += us
        elif "indexSelect" in name or "index_elementwise" in name or "gather" in name.lower():
            parts["gathers"] += us
        elif "indexFunc" in name or "index_add" in name or "scatter" in name.lower():
            parts["scatters"] += us
        elif "foreach" in name or "sqrt" in name.lower():
            parts["dense_optimizer"] += us
        else:  # the head's matmuls, BN math, loss, autograd, casts, concatenations
            parts["head_loss_bn_math"] += us
    busy = sum(split.values())
    log(f"[breakdown] fit {label}: epoch build {build_ms:.3f} ms per epoch; {step_ms:.4f} ms per step "
        f"(host clock, {window} steps of {ep.b})")
    log(f"[breakdown] fit {label}: device us per step: " + ", ".join(
        f"{k} {v / window:.2f}" for k, v in parts.items()
    ) + f"; device busy {busy / window:.2f} of {wall_us / window:.2f} us per step under the "
        f"profiler = idle share {1 - busy / wall_us:.3f}")
    top = sorted(split.items(), key=lambda kv: -kv[1])[:10]

    def short(k):
        k = k.replace("(anonymous namespace)::", "").removeprefix("void ")
        return re.sub(r"[<(].*", "", k).removeprefix("at::native::")[:40]

    log(f"[profile] fit {label}: top kernels, device us per step: " + "; ".join(
        f"{short(k)} {v / window:.2f}" for k, v in top
    ))
    # host side: torch ops by self CPU time over a few steps (the CPU
    # profiler slows the host, so this window is not the timed one)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run_pairwise_steps(st, aug, ep, feat, steps=range(5 + 2 * window, 5 + 2 * window + n_host))
        torch.cuda.synchronize()
    ops = [(e.key, e.self_cpu_time_total, e.count) for e in prof.key_averages()]
    total_us = sum(t for _, t, _ in ops)
    log(f"[profile] fit {label} host: {sum(c for _, _, c in ops) / n_host:.0f} profiled op calls and "
        f"{total_us / n_host / 1e3:.3f} ms of self CPU time per step (under the CPU profiler); top ops, "
        f"ms per step (calls): " + "; ".join(
            f"{k[:40]} {t / n_host / 1e3:.3f} ({c // n_host})" for k, t, c in sorted(ops, key=lambda o: -o[1])[:12]))
    ft.fused_tower_fwd.launches, ft.fused_tower_bwd.launches = saved
    return {"step_ms": step_ms, "idle_share": 1 - busy / wall_us, "build_ms": build_ms,
            "busy_us": busy / window}


# ---------------------------------------------------------------------------
# phase 6r: the mesh, four ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

MESH_WORLD = 4
MESH_WRAPPERS = {  # the mesh wrappers that launch each kernel on a rank's shard
    "pairwise_updates_rows": ["fused_pairwise_step_dp (B1)", "fused_pairwise_step_tp (B2)",
                              "fused_pairwise_step_meta_dp (B3)", "fused_pairwise_step_meta_tp (B4)"],
    "softmax_ce_fwd": ["inbatch_softmax_ce_dp (B5)"],
    "softmax_ce_bwd": ["inbatch_softmax_ce_dp (B5)"],
    "dot_topk_small": ["_sharded_catalog_topk (B6)"],
    "dot_topk_large": ["_sharded_catalog_topk (B6)"],
}
GEN_ROUTES = {  # 6s: what launches each kernel on a rank of the generic step's mesh
    "fused_tower_fwd": ["the MLP's bf16 tower on a data rank's rows, Σz and Σz² summed over data before the next BN"],
    "fused_tower_bwd": ["the same layers' backward; ds/dss the cotangents of the global sums"],
    "softmax_ce_fwd": ["inbatch_softmax_ce_dp (B5) for SASRec's sampled softmax, Br=2048 against Bc=4096"],
    "softmax_ce_bwd": ["inbatch_softmax_ce_dp (B5) for SASRec's sampled softmax, Br=2048 against Bc=4096"],
    "dot_topk_small": ["_sharded_catalog_topk (B6) for SASRec, its histories by sharded lookup"],
}
MESH_FM_STEPS = 300  # FM with metadata on (2, 2): a few hundred steps of one epoch
MESH_LINEAR_STEPS = 500  # Linear hinge on (4, 1): steps of TRAIN_B (the epoch's 2,344 until PR 16)
MESH_SOFTMAX_STEPS = 200  # Linear sampled softmax on (4, 1): steps of SOFTMAX_B (the epoch's 586 until PR 16)
MESH_WINDOW_STEPS = 50  # the steps of each run's second, collective-timed window
MESH_PREDICT_BATCHES = 4  # (1, 4): predict batches of U = 256 users
MESH_TIMEOUT_S = 600
MESH_SM_RTOL, MESH_SM_ATOL = 2e-4, 1e-5  # the softmax fits' tolerance (the CPU tests' rtol; 6m's atol)
MESH_RANK = """
import sys
import chip_smoke
sys.exit(chip_smoke.mesh_rank_main(int(sys.argv[1]), sys.argv[2]))
"""
# the parent's sizes a rank takes over (settings.json): a rehearsal at a small size sets them in the parent
MESH_SETTINGS = ("DEVICE", "N", "N_USERS", "N_INTERACTIONS", "U", "TRAIN_B", "SOFTMAX_B", "MESH_FM_STEPS",
                 "MESH_LINEAR_STEPS", "MESH_SOFTMAX_STEPS",
                 "MESH_PREDICT_BATCHES", "MESH_WINDOW_STEPS")


def mesh_train_cfg(torch, rs, loss: str, batch: int):
    """The TrainConfig RecSys.fit makes for ``rs`` at ``loss`` and ``batch``."""
    from torchrecsys_tpu_torch.config import TrainConfig

    return TrainConfig(batch_size=batch, epochs=1, learning_rate=1e-2, dynamic_neg_sampling=rs.dynamic_neg_sampling,
                       loss=loss, seed=rs.seed)


def mesh_seed(rs):
    """The seeded JAX-layout tables (seed 1) and zero accumulators of 6a."""
    tables = seeded_tables(rs.model, seed=1)
    rs.load_jax_tables(tables, {k: {"acc": np.zeros(v.shape[0], np.float32)} for k, v in tables.items()})


def mesh_fm_steps(torch, rs):
    """MESH_FM_STEPS steps of FM's one epoch through the trainer (the
    batches fit would build), then installed."""
    tr = rs._ensure_trainer(mesh_train_cfg(torch, rs, "hinge", TRAIN_B))
    from torchrecsys_tpu_torch.utils.permute import round_keys

    state = rs.state
    gen = tr._rng(state)
    data, feat = tr._device_train_data(rs.store), tr.feature_tables(rs.store)
    epoch = tr.build_epoch(data, round_keys(gen), gen, feat)
    packed = tr.pack_state(state)
    losses = tr.run_steps(packed, epoch, feat, steps=range(MESH_FM_STEPS), step0=state["step"])
    rs._install(tr.unpack_state(state, packed, MESH_FM_STEPS))
    return losses


def mesh_serve(torch, rs, users, ks, mesh=None, exclude=(False,)):
    """(vals, ids) of catalog_topk and predict's raw ids, for each (k,
    exclude_seen): what a warm model serves (serve_outputs, on a mesh
    through B6)."""
    from torchrecsys_tpu_torch.eval.predict import catalog_topk
    from torchrecsys_tpu_torch.ops.dot_topk import pack_seen_mask_torch

    rows = np.asarray([rs.store.user_encoder.encode_one(u) for u in users], np.int64)
    out = {}
    for k in ks:
        for excl in exclude:
            mask = None
            if excl:
                seen = rs._seen(rows)
                pos = np.repeat(np.arange(len(rows)), [len(s) for s in seen])
                mask = pack_seen_mask_torch(torch.as_tensor(pos, device=rs.device),
                                            torch.as_tensor(np.concatenate(seen), device=rs.device), len(rows),
                                            rs.store.schema.num_items)
            vals, ids = catalog_topk(rs.model, rs._params(), rs.state["model_state"], torch.as_tensor(rows, device=rs.device),
                                     rs.store.schema.num_items, rs.feat, top_k=k, catalog=rs._linearized(),
                                     seen_mask=mask, mesh=mesh)
            raw = rs.predict(users, top_k=k, exclude_seen=excl)
            out[(k, excl)] = (vals.float().cpu().numpy(), ids.cpu().numpy(), raw)
    return out


def mesh_collective_window(torch, rs, loss: str, batch: int) -> dict:
    """MESH_WINDOW_STEPS more steps at ``loss`` and ``batch`` with every
    collective timed between device syncs (``stats.timing``), on a copy of
    ``rs``'s state and generator, so nothing a check compares moves: the
    collectives' share of an instrumented step. The runs users make, and
    the ms per step and examples/s 6r reports, have the timing off."""
    from torchrecsys_tpu_torch.parallel.mesh import stats

    tr = rs._ensure_trainer(mesh_train_cfg(torch, rs, loss, batch))
    gen = torch.Generator(device=tr.device)
    gen.set_state(tr._rng(rs.state).get_state())
    data = tr._device_train_data(rs.store)
    rows = min(MESH_WINDOW_STEPS * batch, rs.store.num_train)
    data = {k: v[:rows] for k, v in data.items()}
    feat = tr.feature_tables(rs.store)
    stats.reset()
    stats.timing = True
    try:
        _, secs, _ = counted(torch, lambda: tr.train_epoch(dict(rs.state, rng=gen), data, feat)[1].item())
    finally:
        stats.timing = False
    return {"window_steps": -(-rows // batch), "window_s": secs, "coll_s": stats.seconds,
            "coll_calls": stats.calls, "coll_bytes": stats.bytes}


def table_hashes(state) -> dict:
    """sha256 of each table and accumulator as this rank holds it."""
    import hashlib

    out = {f"tables.{k}": hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest() for k, v in state["tables"].items()}
    out.update({f"acc.{k}": hashlib.sha256(o["acc"].cpu().numpy().tobytes()).hexdigest()
                for k, o in state["emb_opt"].items() if "acc" in o})
    return out


def mesh_rank_main(rank: int, directory: str) -> int:
    """One rank of 6r: the (4, 1), (2, 2) and (1, 4) meshes of one 4-rank
    gloo world on the card, in turn. Writes ``r{rank}.pkl``; rank 0 also
    writes the trained states the parent compares (``*.pt``) and a marker
    once the (4, 1) Linear checkpoint is on disk."""
    import pickle

    import torch

    from torchrecsys_tpu_torch import RecSys
    from torchrecsys_tpu_torch.parallel import gather_state, init_distributed, make_mesh
    from torchrecsys_tpu_torch.utils.checkpoint import _to_cpu

    with open(os.path.join(directory, "settings.json")) as f:
        globals().update(json.load(f))
    torch.set_num_threads(1)  # four ranks and the parent share the host's cores; the work is on the card
    init_distributed(f"file://{os.path.join(directory, 'rendezvous')}", MESH_WORLD, rank, backend="gloo")
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    t0 = time.perf_counter()
    data = synthetic_interactions()
    out = {"data_s": time.perf_counter() - t0}

    def fit(rs, loss, batch, label, steps):
        losses, secs, counts = counted(torch, lambda: gen_steps(torch, rs, steps, batch, loss=loss))
        return {"label": label, "losses": losses, "fit_s": secs, "steps": steps, "counts": counts,
                "examples_per_s": steps * batch / secs, "hashes": table_hashes(rs.state),
                **mesh_collective_window(torch, rs, loss, batch)}

    def keep(rs, name):  # the whole trained state, for the parent's comparison
        whole = gather_state(rs.state, rs.mesh)
        if rank == 0:
            torch.save(_to_cpu({"tables": whole["tables"], "emb_opt": whole["emb_opt"]}),
                       os.path.join(directory, name))

    # (4, 1): Linear with metadata, hinge; then sampled softmax from the same seeded state
    mesh = make_mesh(data=4, model=1, device=DEVICE)
    t0 = time.perf_counter()
    rs = RecSys(data, metadata_id_col=["category_id"], n_factors=D, device=DEVICE, dynamic_neg_sampling=True,
                mesh=mesh)
    out["ingest_s"] = time.perf_counter() - t0
    mesh_seed(rs)
    out["linear"] = fit(rs, "hinge", TRAIN_B, "Linear metadata hinge (4, 1)", MESH_LINEAR_STEPS)
    keep(rs, "linear.pt")
    rs.save(ckpt_dir("mesh_linear"))
    if rank == 0:
        open(os.path.join(directory, "linear.done"), "w").close()
    mesh_seed(rs)
    out["softmax"] = fit(rs, "sampled_softmax", SOFTMAX_B, "Linear metadata sampled softmax (4, 1)",
                         MESH_SOFTMAX_STEPS)
    keep(rs, "softmax.pt")
    base = rs
    # (2, 2): FM with metadata, MESH_FM_STEPS steps, evaluate, save (a cold load in 6n's child serves it)
    mesh = make_mesh(data=2, model=2, device=DEVICE)
    fm = net_recsys(base, mesh, "fm")
    losses, secs, counts = counted(torch, lambda: mesh_fm_steps(torch, fm))
    res = {"label": "FM metadata hinge (2, 2)", "losses": float(losses.mean()), "fit_s": secs,
           "steps": MESH_FM_STEPS, "counts": counts, "examples_per_s": MESH_FM_STEPS * TRAIN_B / secs,
           "hashes": table_hashes(fm.state), **mesh_collective_window(torch, fm, "hinge", TRAIN_B)}
    res["eval"], res["eval_s"], res["eval_counts"] = counted(
        torch, lambda: fm.evaluate(batch_size=SOFTMAX_B, eval_metrics=("loss", "auc", "recall@10"), verbose=False))
    keep(fm, "fm.pt")
    fm.save(ckpt_dir("mesh_fm"))
    users = fm.store.user_encoder.to_list()[:U]
    res["warm"], res["serve_s"], res["serve_counts"] = counted(torch, lambda: {
        k: v for (k, _), v in mesh_serve(torch, fm, users, (10, 128), mesh).items()})
    res["users"], res["config"] = users, fm.config
    res["shard_rows"] = fm._linearized()[0].shape[0]
    out["fm"] = res
    del fm
    torch.cuda.empty_cache()
    # (1, 4): the (4, 1) Linear's checkpoint served from 250,000-row shards
    mesh = make_mesh(data=1, model=4, device=DEVICE)
    rs = net_recsys(base, mesh, "linear")  # seeded, then the checkpoint's state restored over it
    del base
    torch.cuda.empty_cache()
    rs.restore(ckpt_dir("mesh_linear"))
    users = rs.store.user_encoder.to_list()[: MESH_PREDICT_BATCHES * U]
    served, secs, counts = counted(torch, lambda: [
        mesh_serve(torch, rs, users[i * U:(i + 1) * U], (10, 128), mesh, exclude=(False, True))
        for i in range(MESH_PREDICT_BATCHES)])
    out["predict"] = {"served": served, "s": secs, "counts": counts, "shard_rows": rs._linearized()[0].shape[0]}
    del rs
    torch.cuda.empty_cache()
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(directory, f"r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


def start_mesh_ranks(directory: str, script: str = MESH_RANK, settings=MESH_SETTINGS):
    """The four rank processes of 6r (or of 6s: its ``script`` and
    ``settings``), started together (the kernels are built already: a rank
    only loads them)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "settings.json"), "w") as f:
        json.dump({k: globals()[k] for k in settings}, f)
    root = os.path.dirname(os.path.abspath(__file__))
    logs = [open(os.path.join(directory, f"r{r}.log"), "w") for r in range(MESH_WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), directory], cwd=root, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(MESH_WORLD)]
    return procs, logs


def wait_mesh_ranks(procs, logs, directory: str, t_start: float):
    """Every rank's exit code within MESH_TIMEOUT_S of the start; a rank
    that fails (or a timeout) ends all of them and fails the phase."""
    failed = None
    for r, p in enumerate(procs):
        try:
            rc = p.wait(timeout=max(1.0, MESH_TIMEOUT_S - (time.perf_counter() - t_start)))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0 and failed is None:
            failed = (r, rc)
            for q in procs:
                if q.poll() is None:
                    q.kill()
    for p in procs:
        p.wait()
    for f in logs:
        f.close()
    if failed is not None:
        r, rc = failed
        with open(os.path.join(directory, f"r{r}.log")) as f:
            tail = f.read()[-3000:]
        check(False, f"mesh: rank {r} failed (exit {rc}): {tail}")


def mesh_reference(torch, data, directory: str):
    """The single-device port runs 6r is held against, in the parent while
    the ranks run: the same seeded state, the same epoch (the same
    generator, hence permutation and negatives). Returns the reference
    states, FM's evaluate and the (1, 4) predict outputs."""
    from torchrecsys_tpu_torch import RecSys

    ref = {}
    rs = RecSys(data, metadata_id_col=["category_id"], n_factors=D, device=DEVICE, dynamic_neg_sampling=True)
    mesh_seed(rs)
    gen_steps(torch, rs, MESH_LINEAR_STEPS, TRAIN_B, loss="hinge")
    ref["linear"] = clone_state(torch, rs.state)
    mesh_seed(rs)
    gen_steps(torch, rs, MESH_SOFTMAX_STEPS, SOFTMAX_B, loss="sampled_softmax")
    ref["softmax"] = clone_state(torch, rs.state)
    fm = RecSys(data, metadata_id_col=["category_id"], n_factors=D, net_type="fm", device=DEVICE,
                dynamic_neg_sampling=True)  # the user's entry point, as the ranks' (2, 2) copy builds it
    mesh_seed(fm)
    mesh_fm_steps(torch, fm)
    ref["fm"] = clone_state(torch, fm.state)
    ref["fm_eval"] = fm.evaluate(batch_size=SOFTMAX_B, eval_metrics=("loss", "auc", "recall@10"), verbose=False)
    del fm
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    while not os.path.exists(os.path.join(directory, "linear.done")):
        check(time.perf_counter() < deadline, "6r: the (4, 1) Linear checkpoint never appeared")
        time.sleep(0.5)
    rs.restore(ckpt_dir("mesh_linear"))
    users = rs.store.user_encoder.to_list()[: MESH_PREDICT_BATCHES * U]
    ref["predict"] = [mesh_serve(torch, rs, users[i * U:(i + 1) * U], (10, 128), exclude=(False, True))
                      for i in range(MESH_PREDICT_BATCHES)]
    del rs
    torch.cuda.empty_cache()
    return ref


def mesh_compare(torch, label, got_path, want, rtol, atol):
    """The whole mesh state (rank 0's gather) against the single-device
    one: rows beyond rtol/atol at most RESUME_ROWS per table (6n's rule:
    the single device adds a batch's duplicate updates by atomics in no
    fixed order, and a row within rounding of the hinge kink may take the
    other subgradient). Returns (largest |diff|, rows beyond per leaf)."""
    got = torch.load(got_path, weights_only=True)
    worst, bad = 0.0, {}
    pairs = [(f"tables.{k}", got["tables"][k], want["tables"][k]) for k in want["tables"]]
    pairs += [(f"acc.{k}", got["emb_opt"][k]["acc"], want["emb_opt"][k]["acc"]) for k in want["emb_opt"]]
    for name, g, w in pairs:
        g, w = g.to(w.device).float(), w.float()
        check(g.shape == w.shape, f"6r {label}: {name} {tuple(g.shape)} != {tuple(w.shape)}")
        diff = (g - w).abs()
        beyond = diff > atol + rtol * w.abs()
        rows = int(beyond.reshape(beyond.shape[0], -1).any(dim=1).sum())
        check(rows <= RESUME_ROWS, f"6r {label}: {name}: {rows} rows beyond rtol={rtol}/atol={atol} of the "
              f"single-device run (allowed {RESUME_ROWS}; max |diff| {float(diff.max()):.3g})")
        worst = max(worst, float(diff.max()))
        if rows:
            bad[name] = rows
    return worst, bad


def ce_rect_timing(torch, gen, br: int) -> dict:
    """#4/#5 at a data rank's shape: Br = ``br`` rows against Bc = SOFTMAX_B
    columns (D=80, f32); CUDA-event ms, device ms, bounds, plain ms."""
    from torchrecsys_tpu_torch.ops import softmax_ce as sce

    out = {}
    h, v, vbq, pos, g = ce_inputs(torch, gen, SOFTMAX_B, D, N)
    args = (h[:br].contiguous(), v, vbq, pos[:br].contiguous())
    lse = sce.softmax_ce_fwd_plain(*args, pos, 0)[1]
    gr = g[:br].contiguous()
    in_bytes = (br + SOFTMAX_B) * D * 4 + SOFTMAX_B * 4 + (br + SOFTMAX_B) * 8
    for name, fn, plain, flops, nbytes in (
        ("softmax_ce_fwd", lambda: sce.softmax_ce_fwd(*args, pos, 0), lambda: sce.softmax_ce_fwd_plain(*args, pos, 0),
         2.0 * br * SOFTMAX_B * D, in_bytes + 2 * br * 4),
        ("softmax_ce_bwd", lambda: sce.softmax_ce_bwd(*args, lse, gr, pos, 0),
         lambda: sce.softmax_ce_bwd_plain(*args, lse, gr, pos, 0), 6.0 * br * SOFTMAX_B * D,
         in_bytes + 2 * br * 4 + (br + SOFTMAX_B) * D * 4 + SOFTMAX_B * 4),
    ):
        ms = cuda_ms(torch, fn, reps=50)
        dev_us, _ = device_call(torch, fn)
        plain_ms = cuda_ms(torch, plain)
        bound = max(flops / SPLIT_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        by = "operations" if flops / SPLIT_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        out[f"{name} Br={br} Bc={SOFTMAX_B}"] = {"ms": ms, "device_ms": dev_us / 1e3, "plain_ms": plain_ms,
                                                 "bound_ms": bound, "bound_by": by}
    return out


def tower_rank_timing(torch, gen, rows: int) -> dict:
    """#6/#7 at a data rank's shape of 6s's MLP: ``rows`` rows through both
    hidden layers (the category column makes the input 3 x D wide)."""
    from torchrecsys_tpu_torch.ops import fused_tower as ft

    out = {}
    for li, (din, dout, has_bn) in enumerate(((3 * D, MLP_HIDDEN[0], False), (MLP_HIDDEN[0], MLP_HIDDEN[1], True))):
        x, w, b, bn, dz, dstat = tower_inputs(torch, gen, rows, din, dout)
        z = ft.fused_tower_fwd_plain(x, w, b, bn, has_bn)[0]
        for name, fn, plain, flops, nbytes in (
            ("fused_tower_fwd", lambda: ft.fused_tower_fwd(x, w, b, bn, has_bn),
             lambda: ft.fused_tower_fwd_plain(x, w, b, bn, has_bn), 2.0 * rows * din * dout,
             2 * (rows * din + rows * dout + din * dout) + 4 * 2 * dout),
            ("fused_tower_bwd", lambda: ft.fused_tower_bwd(x, z, dz, w, bn, dstat, has_bn),
             lambda: ft.fused_tower_bwd_plain(x, z, dz, w, bn, dstat, has_bn), 4.0 * rows * din * dout,
             2 * (2 * rows * din + 2 * rows * dout + din * dout) + 4 * (din * dout + dout + 4 * din)),
        ):
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
            dev_us, _ = device_call(torch, fn)
            out[f"{name} R={rows} {din}->{dout}"] = {
                "ms": cuda_ms(torch, fn, reps=50), "device_ms": dev_us / 1e3, "plain_ms": cuda_ms(torch, plain),
                "bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    return out


def generic_kernel_timing(torch, smi_line: str) -> dict:
    """6s's kernel shapes on a rank: #4/#5 at Br = SOFTMAX_B / 2 (SASRec on
    (2, 2)) and #6/#7 at 2 x MLP_B / 4 rows (the AMP MLP on (4, 1))."""
    from torchrecsys_tpu_torch.ops import fused_tower as ft
    from torchrecsys_tpu_torch.ops import softmax_ce as sce

    gen = torch.Generator(device=DEVICE).manual_seed(37)
    ws = (sce.softmax_ce_fwd, sce.softmax_ce_bwd, ft.fused_tower_fwd, ft.fused_tower_bwd)
    saved = [w.launches for w in ws]
    out = ce_rect_timing(torch, gen, SOFTMAX_B // 2)
    out.update(tower_rank_timing(torch, gen, 2 * MLP_B // MESH_WORLD))
    for w, n in zip(ws, saved):
        w.launches = n
    for k, r in out.items():
        log(f"[time] {smi_line}: {k} (a 6s rank's shape): {r['ms']:.4f} ms (device {r['device_ms']:.5f} ms per "
            f"call, torch.profiler); bound {r['bound_ms']:.5f} ms ({r['bound_by']}); plain {r['plain_ms']:.4f} ms; "
            "library: none")
    return out


def mesh_kernel_timing(torch, smi_line: str) -> dict:
    """The kernels at the mesh's shapes: the row-level #3 at 256 and 512
    rows (a rank's share of a 1024 batch at data 4 and 2) and #4/#5 at
    Br=1024 rows against Bc=4096 columns; CUDA-event ms, bounds, plain
    ms."""
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp
    from torchrecsys_tpu_torch.ops import softmax_ce as sce

    gen = torch.Generator(device=DEVICE).manual_seed(31)
    saved = (fp.pairwise_updates_rows.launches, sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches)
    out = {}
    for b in (256, 512):
        rows = [torch.randn(b, 128, generator=gen, device=DEVICE) * 0.1 for _ in range(3)]
        for r in rows:
            r[:, D] = r[:, D].abs()
            r[:, D + 2] = r[:, D + 2].abs()
        kw = dict(d=D, margin=1.0, loss_kind="hinge", sigmoid=False, eps=1e-10, emit_g=True, item_upd=True)
        ms = cuda_ms(torch, lambda: fp.pairwise_updates_rows(*rows, None, 1.0 / 1024, 0.01, **kw), reps=200)
        dev_us, _ = device_call(torch, lambda: fp.pairwise_updates_rows(*rows, None, 1.0 / 1024, 0.01, **kw))
        plain = cuda_ms(torch, lambda: fp.pairwise_updates_rows_plain(*rows, None, 1.0 / 1024, 0.01, **kw))
        sector = -(-4 * (D + 3) // 32) * 32
        nbytes = b * (3 * sector + 3 * 4 * 128)
        bound = max(nbytes / PEAK_BYTES, 10 * b * 128 / PEAK_F32_FLOPS) * 1e3
        out[f"pairwise_updates_rows B={b}"] = {"ms": ms, "device_ms": dev_us / 1e3, "plain_ms": plain,
                                               "bound_ms": bound, "bound_by": "bytes"}
    out.update(ce_rect_timing(torch, gen, SOFTMAX_B // MESH_WORLD))
    fp.pairwise_updates_rows.launches, sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches = saved
    for k, r in out.items():
        log(f"[time] {smi_line}: {k} (D={D}, a mesh rank's shape): {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.5f} ms per call, torch.profiler); bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}); plain {r['plain_ms']:.4f} ms; library: none")
    return out


def mesh_path(torch, data, smi_line: str):
    """6r: four ranks on the one card over gloo (NCCL refuses two ranks on
    one device), one world, the three meshes in turn. (4, 1): Linear with
    metadata, hinge, MESH_LINEAR_STEPS steps at batch 1024 (the row-level
    #3 once per step on each rank's 256 rows, no other kernel), then
    sampled softmax, MESH_SOFTMAX_STEPS steps at batch 4096 (#4/#5 once per
    step at Br=1024 against Bc=4096), each fit's trainer over the first
    steps x batch train rows (gen_steps), against the single-device
    port's run from the same seeded state (6n's rule; the softmax at
    rtol 2e-4), every rank's tables bitwise equal. (2, 2): FM with
    metadata (B4) for 300 steps, evaluate against the single device, save
    (its cold load rides 6n's child). (1, 4): the (4, 1) model's
    checkpoint served in 256-user batches at top_k 10 and 128, with and
    without exclude_seen, through #1/#2 on 250,000-row shards: ids and
    values identical to the single device's. Returns the launches, the
    cold-load job and the numbers."""
    import pickle

    directory = ckpt_dir("mesh")
    shutil.rmtree(directory, ignore_errors=True)
    t_start = time.perf_counter()
    procs, logs = start_mesh_ranks(directory)
    try:
        ref = mesh_reference(torch, data, directory)
    finally:
        wait_mesh_ranks(procs, logs, directory, t_start)
    ranks_s = time.perf_counter() - t_start
    res = []
    for r in range(MESH_WORLD):
        with open(os.path.join(directory, f"r{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    launches: dict = {}
    for r, out in enumerate(res):
        for key in ("linear", "softmax", "fm"):
            for k, n in out[key]["counts"].items():
                launches[k] = launches.get(k, 0) + n
        for key in ("eval_counts", "serve_counts"):
            for k, n in out["fm"][key].items():
                launches[k] = launches.get(k, 0) + n
        for k, n in out["predict"]["counts"].items():
            launches[k] = launches.get(k, 0) + n
        lin, sm, fm = out["linear"], out["softmax"], out["fm"]
        check(nonzero(lin["counts"]) == {"pairwise_updates_rows": lin["steps"]},
              f"6r rank {r}: the (4, 1) hinge epoch launched {lin['counts']}; want the row-level #3 once per step "
              f"({lin['steps']})")
        check(nonzero(sm["counts"]) == {"softmax_ce_fwd": sm["steps"], "softmax_ce_bwd": sm["steps"]},
              f"6r rank {r}: the softmax epoch launched {sm['counts']}")
        check(nonzero(fm["counts"]) == {"pairwise_updates_rows": MESH_FM_STEPS},
              f"6r rank {r}: FM (2, 2) launched {fm['counts']}")
        pc = nonzero(out["predict"]["counts"])
        want = 2 * 2 * MESH_PREDICT_BATCHES  # per k: (catalog_topk + predict) x exclude_seen in (False, True)
        check(pc == {"dot_topk_small": want, "dot_topk_large": want},
              f"6r rank {r}: the (1, 4) predict launched {pc}")
        check(out["predict"]["shard_rows"] == N // 4, f"6r: a (1, 4) catalog shard holds "
              f"{out['predict']['shard_rows']} rows, want {N // 4}")
    # replicas: every rank of a model column holds the same bits
    for key, m in (("linear", 1), ("softmax", 1), ("fm", 2)):
        for r in range(MESH_WORLD):
            check(res[r][key]["hashes"] == res[r % m][key]["hashes"],
                  f"6r {key}: rank {r}'s tables differ from rank {r % m}'s, which hold the same rows")
    lin_err = mesh_compare(torch, "Linear hinge (4, 1)", os.path.join(directory, "linear.pt"), ref["linear"],
                           RESUME_RTOL, RESUME_ATOL)
    sm_err = mesh_compare(torch, "softmax (4, 1)", os.path.join(directory, "softmax.pt"), ref["softmax"],
                          MESH_SM_RTOL, MESH_SM_ATOL)
    fm_err = mesh_compare(torch, "FM (2, 2)", os.path.join(directory, "fm.pt"), ref["fm"], RESUME_RTOL, RESUME_ATOL)
    for r, out in enumerate(res):
        for m, v in ref["fm_eval"].items():
            got = out["fm"]["eval"][m]
            check(abs(got - v) <= 1e-4 * max(1.0, abs(v)), f"6r rank {r}: FM (2, 2) evaluate {m} {got} != "
                  f"the single device's {v}")
        for i, batch in enumerate(out["predict"]["served"]):
            for key, (vals, ids, raw) in batch.items():
                wv, wi, wr = ref["predict"][i][key]
                check(np.array_equal(vals, wv) and np.array_equal(ids, wi) and np.array_equal(raw, wr),
                      f"6r rank {r}: (1, 4) predict batch {i} top_k/exclude_seen {key}: other ids or values than "
                      "the single device's")
    fm0 = res[0]["fm"]
    job = {"name": "FM metadata (2, 2) mesh", "dir": ckpt_dir("mesh_fm"), "users": fm0["users"], "ks": (10, 128),
           "warm": fm0["warm"], "config": fm0["config"]}
    timing = mesh_kernel_timing(torch, smi_line)
    for r, out in enumerate(res):
        for key in ("linear", "softmax", "fm"):
            x = out[key]
            w = x["window_steps"]
            log(f"[mesh] {smi_line}: four ranks sharing one card over gloo, rank {r}: {x['label']}: "
                f"{x['steps']} steps in {x['fit_s']:.3f} s = {x['fit_s'] / x['steps'] * 1e3:.3f} ms per step, "
                f"{x['examples_per_s']:.1f} examples/s (timing off); launches {nonzero(x['counts'])}; a second "
                f"window of {w} steps with the collectives timed between device syncs: "
                f"{x['window_s'] / w * 1e3:.3f} ms per step, collectives {x['coll_s'] / w * 1e3:.3f} ms per step "
                f"(share {x['coll_s'] / x['window_s']:.3f}; {x['coll_calls'] / w:.1f} all-reduces, "
                f"{x['coll_bytes'] / w / 2**20:.3f} MiB per step)")
        log(f"[mesh] rank {r}: synthetic data {out['data_s']:.2f} s, RecSys ingest {out['ingest_s']:.2f} s; FM "
            f"(2, 2) evaluate {out['fm']['eval']} in {out['fm']['eval_s']:.3f} s; (1, 4) predict "
            f"{MESH_PREDICT_BATCHES} x {U} users x (top_k 10, 128) x (exclude_seen no, yes), catalog_topk and predict "
            f"each, {out['predict']['s']:.3f} s; launches {nonzero(out['predict']['counts'])}")
    log(f"[mesh] single-device comparison: Linear hinge (4, 1) max |diff| {lin_err[0]:.3g} (rows beyond "
        f"rtol={RESUME_RTOL}/atol={RESUME_ATOL}: {lin_err[1]}), softmax (4, 1) {sm_err[0]:.3g} (rows beyond "
        f"rtol={MESH_SM_RTOL}/atol={MESH_SM_ATOL}: {sm_err[1]}), FM (2, 2) {fm_err[0]:.3g} ({fm_err[1]}); FM "
        f"evaluate single device {ref['fm_eval']}; every rank's replicated tables bitwise equal; (1, 4) ids and "
        f"values identical; ranks ran {ranks_s:.1f} s (start, data, ingest, the three meshes)")
    return {"launches": launches, "job": job, "timing": timing, "ranks_s": ranks_s, "res": res}


# ---------------------------------------------------------------------------
# 6s: the generic step on a mesh (every net; the MLP's batch-norm sums over data)
# ---------------------------------------------------------------------------

GEN_MLP_STEPS = 120  # the north-star AMP MLP on (4, 1): steps of 8192 (depth cut for the run's time limit)
GEN_SAS_STEPS = 60  # SASRec AMP sampled softmax on (2, 2): steps of 4096 (depth cut as above)
GEN_F32_STEPS = 20  # the f32 MLP on (2, 2)
GEN_SHORT_STEPS = 50  # Linear K = 4 and WARP, LSTM, Linear at an uneven batch
GEN_ODD_B = 1022  # a batch that does not divide data = 4
GEN_WINDOW_STEPS = 20  # the AMP MLP's second, collective-timed window
GEN_HISTORY = 20  # 6o's history_len
GEN_EASE = (5_000, 2_000, 100_000)  # EASE on every rank: users, items, interactions
GEN_DIST = 1e-3  # f32 runs: a leaf's change within this relative distance of one device's
MESH_GENERIC_RANK = """
import sys
import chip_smoke
sys.exit(chip_smoke.generic_rank_main(int(sys.argv[1]), sys.argv[2]))
"""
GEN_SETTINGS = MESH_SETTINGS + ("MLP_B", "MLP_HIDDEN", "GEN_MLP_STEPS", "GEN_SAS_STEPS", "GEN_F32_STEPS",
                                "GEN_SHORT_STEPS", "GEN_ODD_B", "GEN_WINDOW_STEPS", "GEN_HISTORY", "GEN_EASE", "GEN_RUNS")
# (run, net, mesh shape, steps, batch, fit keywords, use_amp, rule): every 6s training run, on the ranks and on
# one device. rule "floor": 6f's noise-floor rule against a twin on one device in the other precision (the AMP
# runs; the f32 MLP, whose one-pass batch-norm variance E[x^2] - mean^2 loses digits where a feature's mean
# dwarfs its spread, so that two summation orders of 16,384 rows already part by ~0.2% after one step at
# (1024, 128)); "tight": every leaf within GEN_DIST of one device's. Dense adagrad except for the north-star
# MLP: adam turns the rounding of a gradient that is 0 up to rounding (SASRec's key bias, a hidden bias under
# batch norm) into a step of lr, which then feeds every later step (tests/test_torch_lstm.py's AMP fits use
# adagrad for the same reason). The f32 MLP takes bpr: under hinge a pair within rounding of the kink takes a
# whole update on one side and none on the other (6o's small fits take bpr for the same reason).
GEN_RUNS = (
    ("mlp_amp", "mlp", (4, 1), "GEN_MLP_STEPS", "MLP_B", dict(learning_rate=0.05), True, "floor"),
    ("lstm", "lstm", (4, 1), "GEN_SHORT_STEPS", "TRAIN_B", dict(learning_rate=0.05, dense_optimizer="adagrad"), False,
     "tight"),
    ("linear_odd", "linear", (4, 1), "GEN_SHORT_STEPS", "GEN_ODD_B", {}, False, "tight"),
    ("sasrec_softmax", "sasrec", (2, 2), "GEN_SAS_STEPS", "SOFTMAX_B",
     dict(learning_rate=0.05, loss="sampled_softmax", dense_optimizer="adagrad"), True, "floor"),
    ("mlp_f32", "mlp", (2, 2), "GEN_F32_STEPS", "MLP_B", dict(learning_rate=0.05, dense_optimizer="adagrad", loss="bpr"),
     False, "floor"),
    ("linear_k4", "linear", (2, 2), "GEN_SHORT_STEPS", "TRAIN_B", dict(num_negatives=4), False, "tight"),
    ("linear_warp", "linear", (2, 2), "GEN_SHORT_STEPS", "TRAIN_B", dict(loss="warp", num_negatives=4), False, "tight"),
)
GEN_SERVED = ("mlp_amp", "mlp_f32", "sasrec_softmax")  # the runs whose checkpoints predict on both sides


def net_recsys(rs, mesh, net_type: str, use_amp: bool = False):
    """A RecSys over ``rs``'s store (its ingest once per process) for
    ``net_type`` on ``mesh`` (None: ``rs``'s device), with seeded tables
    (mesh_seed): what ``RecSys(data, net_type=..., mesh=mesh)`` builds
    from the same data (6r, 6s)."""
    import copy
    import dataclasses

    out = copy.copy(rs)
    out.mesh = mesh
    out.device = rs.device if mesh is None else mesh.device
    out.model_cfg = dataclasses.replace(rs.model_cfg, net_type=net_type, hidden_layers=MLP_HIDDEN,
                                        history_len=GEN_HISTORY, compute_dtype="bfloat16" if use_amp else "float32")
    out.trainer, out.state = None, None
    out._bind_store(rs.store)
    mesh_seed(out)
    return out


def gen_steps(torch, rs, steps: int, batch: int, **fit_kw):
    """``steps`` steps of fit's trainer at ``batch``: one epoch over the first
    steps x batch train rows (the same rows, generator and draws on every
    rank and on one device), installed. Returns the epoch's mean loss."""
    from torchrecsys_tpu_torch.config import TrainConfig

    cfg = TrainConfig(batch_size=batch, epochs=1, dynamic_neg_sampling=rs.dynamic_neg_sampling, seed=rs.seed,
                      **{"learning_rate": 1e-2, **fit_kw})
    tr = rs._ensure_trainer(cfg)
    data = {k: v[: steps * batch] for k, v in tr._device_train_data(rs.store).items()}
    state, loss = tr.train_epoch(rs.state, data, tr.feature_tables(rs.store))
    rs._install(state)
    return float(loss)


def gen_digests(state) -> dict:
    """sha256 of what every replica must hold alike: this rank's table
    shards and accumulators; the dense tree, its optimizer state and the
    running statistics."""
    import hashlib

    def dig(d):
        h = hashlib.sha256()
        for k in sorted(d):
            h.update(k.encode())
            h.update(d[k].detach().float().cpu().numpy().tobytes())
        return h.hexdigest()

    flat = flat_state(state)
    return {"tables": dig({k: v for k, v in flat.items() if k.startswith(("tables.", "acc."))}),
            "dense": dig({k: v for k, v in flat.items() if not k.startswith(("tables.", "acc."))
                          and not k.endswith("count")})}


def gen_serve(torch, rs, users, k: int = 10) -> dict:
    """serve_outputs' (values, item rows, raw ids) at top_k ``k``, scored on
    ``rs``'s mesh: the data-sharded generic scorer."""
    from torchrecsys_tpu_torch.eval.predict import catalog_topk

    rows = torch.as_tensor([rs.store.user_encoder.encode_one(u) for u in users], device=rs.device)
    vals, ids = catalog_topk(rs.model, rs._params(), rs.state["model_state"], rows, rs.store.schema.num_items,
                             rs.feat, top_k=k, mesh=rs.mesh)
    return {k: (vals.float().cpu().numpy(), ids.cpu().numpy(), rs.predict(users, top_k=k))}


def gen_ease_data():
    r = np.random.default_rng(5)
    users, items, n = GEN_EASE
    return {"user_id": r.integers(0, users, n), "item_id": np.minimum(r.geometric(1.0 / 300, n), items) - 1}


def generic_rank_main(rank: int, directory: str) -> int:
    """One rank of 6s: the (4, 1) and (2, 2) meshes of one 4-rank gloo world
    on the card, each GEN_RUNS run on its mesh from the seeded state,
    predict, the (2, 2) f32 MLP's checkpoint, EASE. Writes
    ``r{rank}.pkl``; rank 0 also writes the trained states (``*.pt``) and
    the checkpoints the parent serves from, each with a marker."""
    import pickle

    import torch

    from torchrecsys_tpu_torch import RecSys
    from torchrecsys_tpu_torch.parallel import gather_state, init_distributed, make_mesh
    from torchrecsys_tpu_torch.parallel.mesh import stats
    from torchrecsys_tpu_torch.utils.checkpoint import _to_cpu

    with open(os.path.join(directory, "settings.json")) as f:
        globals().update(json.load(f))
    torch.set_num_threads(1)
    init_distributed(f"file://{os.path.join(directory, 'rendezvous')}", MESH_WORLD, rank, backend="gloo")
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    t0 = time.perf_counter()
    data = synthetic_interactions()
    shapes = sorted({tuple(run[2]) for run in GEN_RUNS} | {(2, 2)})  # every rank makes the same groups
    meshes = {shape: make_mesh(data=shape[0], model=shape[1], device=DEVICE) for shape in shapes}
    base = RecSys(data, metadata_id_col=["category_id"], n_factors=D, device=DEVICE, dynamic_neg_sampling=True,
                  mesh=meshes[shapes[0]])
    out = {"setup_s": time.perf_counter() - t0, "runs": {}}
    users = base.store.user_encoder.to_list()[:U]

    def save_marked(rs, name):  # every rank calls save; rank 0 writes, then marks it done
        rs.save(ckpt_dir(name))
        if rank == 0:
            open(os.path.join(directory, f"{name}.done"), "w").close()

    for run, net, shape, steps, batch, kw, amp, _ in GEN_RUNS:
        steps, batch = globals()[steps], globals()[batch]
        rs = net_recsys(base, meshes[tuple(shape)], net, use_amp=amp)
        loss, secs, counts = counted(torch, lambda: gen_steps(torch, rs, steps, batch, **kw))
        res = {"loss": loss, "fit_s": secs, "counts": counts, "steps": steps, "batch": batch,
               "digests": gen_digests(rs.state)}
        whole = gather_state(rs.state, rs.mesh)
        if rank == 0:
            torch.save(_to_cpu({k: whole[k] for k in ("tables", "emb_opt", "dense", "model_state")}),
                       os.path.join(directory, f"{run}.pt"))
        if run == "mlp_amp":  # the collectives' share, from a second window on a copy of the state
            state = clone_state(torch, rs.state)
            stats.reset()
            stats.timing = True
            try:
                _, res["window_s"], _ = counted(torch, lambda: gen_steps(torch, rs, GEN_WINDOW_STEPS, batch, **kw))
            finally:
                stats.timing = False
            res.update(window_steps=GEN_WINDOW_STEPS, coll_s=stats.seconds, coll_calls=stats.calls,
                       coll_bytes=stats.bytes)
            rs._install(state)
        if run in ("mlp_amp", "mlp_f32"):  # the data-sharded generic scorer, at top_k 10 and exclude_seen
            save_marked(rs, f"gen_{run}")
            res["served"], res["serve_s"], res["serve_counts"] = counted(torch, lambda: {
                excl: rs.predict(users, top_k=10, exclude_seen=excl) for excl in (False, True)})
        if run == "sasrec_softmax":  # B6 over the item-table shards, the histories by sharded lookup
            save_marked(rs, f"gen_{run}")
            res["served"], res["serve_s"], res["serve_counts"] = counted(torch, lambda: {
                excl: rs.predict(users, top_k=10, exclude_seen=excl) for excl in (False, True)})
        if run == "mlp_f32":  # the cold load of 6n's child serves this checkpoint
            res["warm"] = gen_serve(torch, rs, users[:16])
            res["config"] = rs.config
        out["runs"][run] = res
        del rs, whole
        torch.cuda.empty_cache()
    ease = RecSys(gen_ease_data(), net_type="ease", ease_lam=50.0, device=DEVICE, mesh=meshes[(2, 2)])
    (_, out["ease_fit_s"], _) = counted(torch, lambda: ease.fit())
    e_users = ease.store.user_encoder.to_list()[:U]
    out["ease"] = {excl: ease.predict(e_users, top_k=10, exclude_seen=excl) for excl in (False, True)}
    save_marked(ease, "gen_ease")
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(directory, f"r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


def wait_marker(directory: str, name: str) -> None:
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    while not os.path.exists(os.path.join(directory, f"{name}.done")):
        check(time.perf_counter() < deadline, f"6s: the mesh's {name} checkpoint never appeared")
        time.sleep(0.5)


def generic_reference(torch, data, directory: str):
    """The single-device port 6s is held against, in the parent while the
    ranks run: each GEN_RUNS run from the same seeded state (the AMP ones
    also in f32, the noise floor's other end); then the mesh's checkpoints
    restored and served on one device, and EASE fitted here."""
    from torchrecsys_tpu_torch import RecSys

    base = RecSys(data, metadata_id_col=["category_id"], n_factors=D, device=DEVICE, dynamic_neg_sampling=True)
    ref = {}
    for run, net, shape, steps, batch, kw, amp, rule in GEN_RUNS:
        for twin in ((False, True) if rule == "floor" else (False,)):
            rs = net_recsys(base, None, net, use_amp=amp != twin)  # the twin in the other precision
            if rule == "floor" and not twin:
                ref[(run, "start")] = clone_state(torch, rs.state)
            loss = gen_steps(torch, rs, globals()[steps], globals()[batch], **kw)
            ref[(run, twin)] = {"loss": loss, "state": clone_state(torch, rs.state)}
            if run in GEN_SERVED and not twin:
                ref[(run, "rs")] = rs  # restored from the mesh's checkpoint below
            del rs
    ref["users"] = users = base.store.user_encoder.to_list()[:U]
    for run in [r for r in GEN_SERVED if (r, "rs") in ref]:
        rs = ref.pop((run, "rs"))
        wait_marker(directory, f"gen_{run}")
        rs.restore(ckpt_dir(f"gen_{run}"))
        ref[(run, "served")] = {excl: rs.predict(users, top_k=10, exclude_seen=excl) for excl in (False, True)}
        del rs
        torch.cuda.empty_cache()
    ease = RecSys(gen_ease_data(), net_type="ease", ease_lam=50.0, device=DEVICE)
    ease.fit()
    e_users = ease.store.user_encoder.to_list()[:U]
    ref["ease"] = {excl: ease.predict(e_users, top_k=10, exclude_seen=excl) for excl in (False, True)}
    del ease, base
    torch.cuda.empty_cache()
    return ref


def gen_leaves(torch, state) -> dict:
    flat = flat_state(state)
    return {k: v for k, v in flat.items() if not k.startswith("dense_opt")}


def gen_compare(torch, run, got, ref, floor: bool, adam: bool) -> dict:
    """The mesh's state after ``run`` against one device's from the same
    start: ``floor``, 6f's noise-floor rule (each leaf's change within
    max(1.5 x the distance between one device's changes in the two
    precisions, 0.02) of one device's), else each leaf within GEN_DIST.
    Under ``adam`` or ``floor`` the hidden and output biases are not
    compared (6f: their gradients are 0 up to rounding, which adam turns
    into steps of lr and the floor's relative distances into noise over
    noise). Returns {leaf: distance}."""
    start = gen_leaves(torch, ref[(run, "start")]) if floor else None
    want = gen_leaves(torch, ref[(run, False)]["state"])
    twin = gen_leaves(torch, ref[(run, True)]["state"]) if floor else None
    got = {f"tables.{k}": v for k, v in got["tables"].items()} | {
        f"acc.{k}": o["acc"] for k, o in got["emb_opt"].items() if "acc" in o} | {
        f"dense.{k}": v for k, v in flat_dense(got["dense"]).items()} | {
        f"model_state.{k}": v for k, v in flat_dense(got["model_state"]).items()}
    out = {}
    for name, w in want.items():
        g = got[name].to(w.device).float()
        w = w.float()
        check(g.shape == w.shape, f"6s {run}: {name} {tuple(g.shape)} != {tuple(w.shape)}")
        if (adam or floor) and name.endswith(".b"):
            continue
        if floor:
            s = start[name].float()
            dg, dw, df = g - s, w - s, twin[name].float() - s
            dist = float((dg - dw).norm() / dw.norm().clamp_min(1e-30))
            noise = float((dw - df).norm() / df.norm().clamp_min(1e-30))
            check(dist < max(1.5 * noise, 0.02), f"6s {run}: {name} mesh vs one device {dist:.3g}, floor {noise:.3g}")
        else:
            dist = float((g - w).norm() / w.norm().clamp_min(1e-30))
            check(dist <= GEN_DIST, f"6s {run}: {name} differs from one device's by {dist:.3g} > {GEN_DIST}")
        out[name] = dist
    return out


def generic_mesh_path(torch, data, smi_line: str):
    """6s: four ranks on the one card over gloo, the generic step on the
    (4, 1) and (2, 2) meshes. (4, 1): the north-star AMP MLP (hidden (1024,
    128), batch norm, batch 8192, the category column) for GEN_MLP_STEPS
    steps of hinge, #6 and #7 twice per step on each rank's 4096-row
    paired side with their sums reduced over data; LSTM hinge and Linear at
    batch 1022 (it does not divide data) for GEN_SHORT_STEPS steps. (2, 2):
    SASRec AMP sampled softmax (#4/#5 once per step at Br = 2048 against Bc
    = 4096), the f32 MLP (the plain tower, its statistics synced), Linear
    with K = 4 negatives and WARP. Each run against the single-device port
    from the same seeded state and draws (gen_compare); every rank's
    replicated tables, dense tree and running statistics bitwise equal.
    Predict at top_k 10 with and without exclude_seen from the mesh's
    checkpoints (the MLP's data-sharded scorer on both meshes, SASRec's B6)
    and EASE fitted on every rank: ids identical to one device's. Returns
    the launches, the cold-load job and the numbers."""
    import pickle

    directory = ckpt_dir("mesh_generic")
    shutil.rmtree(directory, ignore_errors=True)
    t_start = time.perf_counter()
    procs, logs = start_mesh_ranks(directory, MESH_GENERIC_RANK, GEN_SETTINGS)
    try:
        ref = generic_reference(torch, data, directory)
    finally:
        wait_mesh_ranks(procs, logs, directory, t_start)
    ranks_s = time.perf_counter() - t_start
    res = []
    for r in range(MESH_WORLD):
        with open(os.path.join(directory, f"r{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    launches: dict = {}
    dists = {}
    for run, net, shape, steps, batch, kw, amp, rule in GEN_RUNS:
        m = shape[1]
        for r, out in enumerate(res):
            x = out["runs"][run]
            for key in ("counts", "serve_counts"):
                for k, n in x.get(key, {}).items():
                    launches[k] = launches.get(k, 0) + n
            want = {}
            if run == "mlp_amp":
                want = {"fused_tower_fwd": 2 * x["steps"], "fused_tower_bwd": 2 * x["steps"]}
            elif run == "sasrec_softmax":
                want = {"softmax_ce_fwd": x["steps"], "softmax_ce_bwd": x["steps"]}
            check(nonzero(x["counts"]) == want, f"6s rank {r}: {run} launched {x['counts']}, want {want}")
            check(np.isfinite(x["loss"]) and abs(x["loss"] - ref[(run, False)]["loss"]) <= (
                0.08 if amp else 1e-3) * abs(ref[(run, False)]["loss"]),
                f"6s rank {r}: {run} loss {x['loss']} against one device's {ref[(run, False)]['loss']}")
            check(x["digests"]["dense"] == res[0]["runs"][run]["digests"]["dense"],
                  f"6s {run}: rank {r}'s dense tree or running statistics differ from rank 0's")
            check(x["digests"]["tables"] == res[r % m]["runs"][run]["digests"]["tables"],
                  f"6s {run}: rank {r}'s tables differ from rank {r % m}'s, which hold the same rows")
            if "served" in x:
                for excl, ids in x["served"].items():
                    check(np.array_equal(ids, ref[(run, "served")][excl]),
                          f"6s rank {r}: {run} predict (exclude_seen={excl}) serves other ids than one device")
                if run == "sasrec_softmax":
                    check(nonzero(x["serve_counts"]) == {"dot_topk_small": 2},
                          f"6s rank {r}: SASRec predict launched {x['serve_counts']}")
        dists[run] = gen_compare(torch, run, torch.load(os.path.join(directory, f"{run}.pt"), weights_only=True),
                                 ref, rule == "floor", kw.get("dense_optimizer", "adam") == "adam" and net != "linear")
    for r, out in enumerate(res):
        for excl, ids in out["ease"].items():
            check(np.array_equal(ids, ref["ease"][excl]), f"6s rank {r}: EASE (exclude_seen={excl}) serves other "
                  "ids than one device")
    f0 = res[0]["runs"].get("mlp_f32")
    job = f0 and {"name": "MLP f32 (2, 2) mesh", "dir": ckpt_dir("gen_mlp_f32"), "users": ref["users"][:16],
                  "ks": (10,), "warm": f0["warm"], "config": f0["config"]}
    for r, out in enumerate(res):
        for run, *_ in GEN_RUNS:
            x = out["runs"][run]
            log(f"[mesh6s] {smi_line}: four ranks sharing one card over gloo (no scaling figure), rank {r}: {run}: "
                f"{x['steps']} steps of {x['batch']} in {x['fit_s']:.3f} s = {x['fit_s'] / x['steps'] * 1e3:.3f} ms "
                f"per step, {x['steps'] * x['batch'] / x['fit_s']:.1f} examples/s (timing off); loss {x['loss']:.6f}; "
                f"launches {nonzero(x['counts'])}"
                + (f"; predict 2 x {U} users {x['serve_s']:.3f} s" if "serve_s" in x else ""))
        x = out["runs"].get("mlp_amp", {"window_steps": 1, "window_s": 1.0, "coll_s": 0.0, "coll_calls": 0,
                                         "coll_bytes": 0})
        w = x["window_steps"]
        log(f"[mesh6s] {smi_line}: rank {r}: AMP MLP window of {w} steps with the collectives timed between device "
            f"syncs: {x['window_s'] / w * 1e3:.3f} ms per step, collectives {x['coll_s'] / w * 1e3:.3f} ms per step "
            f"(share {x['coll_s'] / x['window_s']:.3f}; {x['coll_calls'] / w:.1f} all-reduces, "
            f"{x['coll_bytes'] / w / 2**20:.3f} MiB per step); setup {out['setup_s']:.1f} s; EASE fit "
            f"{out['ease_fit_s']:.3f} s")
    log("[mesh6s] one-device comparison (largest leaf distance per run): " + json.dumps(
        {run: max(d.values()) for run, d in dists.items()}) + "; per leaf " + json.dumps(dists) + f"; every rank's replicas bitwise equal; predict and "
        f"EASE ids identical; ranks ran {ranks_s:.1f} s")
    return {"launches": launches, "job": job, "ranks_s": ranks_s, "res": res,
            "timing": generic_kernel_timing(torch, smi_line)}


# ---------------------------------------------------------------------------
# phase 6t: logging, profile_epochs and the examples
# ---------------------------------------------------------------------------

# wrapper -> the kernels each of its calls launches once (their function names in a trace)
TRACE_KERNELS = {
    "fused_pairwise_step": ("fused_pairwise_step_kernel", "fused_pairwise_apply_kernel"),
    "fused_pairwise_step_meta": ("fused_pairwise_step_kernel", "fused_pairwise_apply_kernel"),
    "softmax_ce_fwd": ("softmax_ce_fwd_split_kernel", "softmax_ce_fwd_kernel", "softmax_ce_fwd_combine_kernel"),
    "softmax_ce_bwd": ("softmax_ce_bwd_kernel", "softmax_ce_bwd_sum_kernel"),
    "fused_tower_fwd": ("fused_tower_fwd_kernel",),
    "fused_tower_bwd": ("fused_tower_bwd_dh_kernel", "fused_tower_bwd_dw_kernel", "fused_tower_bwd_sum_kernel"),
    "dot_topk_small": ("dot_topk_tc_kernel",),
    "dot_topk_large": ("dot_topk_tc_kernel",),
}
PROFILE_TAKES = 3  # a profiled fit whose trace lost kernel records runs again, up to this many times
# the wrappers each in-process example must launch (PERF.md §6's table)
EXAMPLE_KERNELS = {
    "quickstart": ("pairwise_updates_rows", "dot_topk_small"),
    "retrieval_training": ("softmax_ce_fwd", "softmax_ce_bwd", "dot_topk_small"),
    "production_serving": ("fused_pairwise_step", "dot_topk_small", "dot_topk_large"),
}
MULTIHOST_ROWS = 200_000  # examples/multihost_train.py's default --rows


def log_records():
    """A logging handler that keeps every record it sees (``.records``)."""
    import logging

    class Records(logging.Handler):
        def __init__(self):
            super().__init__()
            self.records = []

        def emit(self, record):
            self.records.append(record)

    return Records()


def add_counts(total: dict, counts: dict) -> dict:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def trace_counts(path: str) -> dict:
    """Launches per kernel function name over every device of a trace file
    (utils/trace_files.py::op_totals, the lead-in set aside)."""
    from torchrecsys_tpu_torch.utils import trace_files

    out: dict = {}
    for rows in trace_files.op_totals(path).values():
        for name, _, n in rows:
            base = trace_files.kernel_base_name(name)
            out[base] = out.get(base, 0) + n
    return out


def states_equal(torch, a, b) -> bool:
    """Every leaf of two train states (flat_state), bit for bit."""
    fa, fb = flat_state(a), flat_state(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(x, fb[k]) if isinstance(x, torch.Tensor) else x == fb[k] for k, x in fa.items())


def profiled_fit(torch, rs, tables, fit_kw, label: str, smi_line: str, records, expect: dict):
    """6t (a) and (b) for one fit of ``rs`` from seeded ``tables``: an
    unprofiled verbose fit (its stdout captured), the fit with
    ``profile_epochs=1``, and an unprofiled fit without ``verbose``, each
    from the same tables and generator seed, all under torch's
    deterministic algorithms. The train logger (``records``) must see one
    epoch record per epoch in the verbose fits and the digest once in the
    profiled one, and nothing in the last. The profiled trace's kernel
    counts must equal the wrappers' launches over the same epoch exactly
    (a take whose trace lost records runs again, up to PROFILE_TAKES). The
    profiled fit's losses and state must equal the first fit's bit for
    bit, unless the last fit differs from the first too (the step kernel's
    atomics add in no fixed order): then they are held to that noise floor
    by 6n's rule. ``expect``: each wrapper's launches in the profiled epoch
    (no other wrapper may launch). Returns the launches of all its fits and
    the timings."""
    import contextlib
    import io

    from torchrecsys_tpu_torch.train import trainer as trainer_mod
    from torchrecsys_tpu_torch.utils import trace_files

    emb_opt = {k: {"acc": np.zeros(v.shape[0], np.float32)} for k, v in tables.items()}
    epochs = fit_kw["epochs"]
    real_trace, real_dir = trainer_mod.trace, trainer_mod.default_trace_dir
    window: dict = {}
    total: dict = {}

    @contextlib.contextmanager
    def counting_trace(directory):
        ws = wrappers()
        before = {w.__name__: w.launches for w in ws}
        with real_trace(directory):
            yield
            window.update({w.__name__: w.launches - before[w.__name__] for w in ws})

    def run(verbose: bool, profile_dir=None):
        rs.load_jax_tables(tables, emb_opt)
        n0 = len(records.records)
        if profile_dir:
            trainer_mod.trace, trainer_mod.default_trace_dir = counting_trace, lambda: profile_dir
        try:
            losses, secs, counts = counted(torch, lambda: rs.fit(
                verbose=verbose, profile_epochs=1 if profile_dir else 0, **fit_kw))
        finally:
            trainer_mod.trace, trainer_mod.default_trace_dir = real_trace, real_dir
        add_counts(total, counts)
        return losses, clone_state(torch, rs.state), records.records[n0:]

    def epoch_records(recs):
        return [r for r in recs if r.getMessage().startswith("epoch ")]

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            plain, plain_state, recs = run(True)
        out = buf.getvalue()
        for line in out.splitlines():
            log(f"[6t] {label}: stdout: {line}")
        check(len(epoch_records(recs)) == len(recs) == epochs, f"{label}: the verbose fit logged "
              f"{[r.getMessage() for r in recs]}, want one epoch record per epoch ({epochs})")
        check(len(re.findall(r"^\[torchrecsys_tpu_torch\.train\] epoch \d+: loss=", out, re.M)) == epochs,
              f"{label}: stdout lacks the [torchrecsys_tpu_torch.train] epoch lines: {out[-500:]!r}")
        plain_epoch_s = epoch_records(recs)[0].args[2]
        bad, takes = None, 0
        while takes < PROFILE_TAKES and bad != {}:
            takes += 1
            d = ckpt_dir(f"trace_{label.replace(' ', '_')}_{takes}")
            window.clear()
            prof, prof_state, precs = run(True, d)
            path = trace_files.latest_trace_file(d)
            check(path is not None, f"{label}: the profiled fit wrote no trace under {d}")
            got = trace_counts(path)
            want: dict = {}
            for w, kernels in TRACE_KERNELS.items():
                for k in kernels:
                    want[k] = want.get(k, 0) + window.get(w, 0)
            bad = {k: (got.get(k, 0), n) for k, n in want.items() if got.get(k, 0) != n}
            if bad and takes < PROFILE_TAKES:
                log(f"[6t] {label}: take {takes}: the trace's kernel counts (trace, wrappers) {bad}; taken again")
                shutil.rmtree(d, ignore_errors=True)
        check(not bad, f"{label}: after {takes} takes the trace's kernel counts (trace, wrappers) are {bad}")
        check(nonzero(window) == expect, f"{label}: the profiled epoch launched {nonzero(window)}, want {expect}")
        check("spin_kernel" not in got, f"{label}: the lead-in's spin kernels are in the digest: {got}")
        digests = [r for r in precs if r.getMessage().startswith("per-op device time digest:")]
        check(len(digests) == 1 and len(epoch_records(precs)) == epochs == len(precs) - 1,
              f"{label}: the profiled fit logged {[r.getMessage()[:60] for r in precs]}")
        check("failed to parse" not in digests[0].getMessage() and "TOTAL" in digests[0].getMessage(),
              f"{label}: digest {digests[0].getMessage()[:300]}")
        prof_epoch_s = epoch_records(precs)[0].args[2]
        again, again_state, arecs = run(False)
        check(not arecs, f"{label}: verbose=False logged {[r.getMessage() for r in arecs]}")
    finally:
        torch.use_deterministic_algorithms(False)
    bitwise = prof == plain and states_equal(torch, prof_state, plain_state)
    reproducible = again == plain and states_equal(torch, again_state, plain_state)
    if not bitwise:
        check(not reproducible, f"{label}: the profiled fit's losses {prof} or state differ from the "
              f"unprofiled fit's {plain}, which an unprofiled fit reproduces bit for bit")
        for a, b in zip(prof, plain):
            check(abs(a - b) <= RESUME_ATOL + RESUME_RTOL * abs(b), f"{label}: profiled loss {a} vs {b}")
        resume_compare(torch, f"{label} profiled", prof_state, plain_state,
                       floor=state_diff(torch, again_state, plain_state))
    size = os.path.getsize(path)
    rows = rs.store.num_train
    log(f"[6t] {smi_line}: {label}: profiled epoch {prof_epoch_s:.3f} s = {rows / prof_epoch_s:.1f} examples/s "
        f"against {plain_epoch_s:.3f} s = {rows / plain_epoch_s:.1f} examples/s unprofiled (epoch 0 of each, "
        f"host clock, deterministic algorithms; the profiled epoch includes the trace's start, lead-in and "
        f"export); trace {size / 2**20:.1f} MiB ({takes} take(s)); wrapper launches in the profiled epoch "
        f"{nonzero(window)}, the trace's kernel counts {dict(sorted((k, v) for k, v in got.items() if k in want))}; "
        f"losses {prof} vs {plain} unprofiled: bit for bit {bitwise} (two unprofiled fits bit for bit: "
        f"{reproducible})")
    log(f"[6t] {smi_line}: {label}: the fit's {digests[0].getMessage()}")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    del plain_state, prof_state, again_state
    torch.cuda.empty_cache()
    return {"launches": total, "window": dict(window), "plain_epoch_s": plain_epoch_s, "prof_epoch_s": prof_epoch_s,
            "trace_mib": size / 2**20, "bitwise": bitwise, "reproducible": reproducible, "takes": takes}


def example_runs(torch, smi_line: str) -> dict:
    """6t (c), in process: ``quickstart``, ``retrieval_training`` and
    ``production_serving`` through ``main(["--device", "cuda"])`` at their
    own sizes, each under ``counted`` and with its own asserts; each must
    launch the wrappers EXAMPLE_KERNELS names (quickstart: the row-level
    kernel's bf16 bpr variant, then #1 on a bf16 catalog). Returns the
    launches of all of them and each one's seconds."""
    import contextlib
    import importlib
    import io

    from torchrecsys_tpu_torch.ops import fused_pairwise as fp

    total: dict = {}
    secs: dict = {}
    for name, kernels in EXAMPLE_KERNELS.items():
        mod = importlib.import_module(f"torchrecsys_tpu_torch.examples.{name}")
        argv = ["--device", DEVICE] + (["--ckpt", ckpt_dir("quickstart")] if name == "quickstart" else [])
        fp.pairwise_updates_rows.variant = None
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            models, secs[name], counts = counted(torch, lambda: mod.main(argv))
        for line in buf.getvalue().splitlines():
            log(f"[6t] {name}: {line}")
        check(all(counts[k] > 0 for k in kernels), f"example {name}: launches {nonzero(counts)}, want each of {kernels}")
        if name == "quickstart":
            want = fp.row_variant("bpr", True, True, True, False, True)
            check(fp.pairwise_updates_rows.variant == want,
                  f"quickstart: the row-level kernel ran variant {fp.pairwise_updates_rows.variant}, want {want}")
            q = models["model"]._linearized()[0]
            check(q.dtype == torch.bfloat16, f"quickstart: the catalog is {q.dtype}, want bfloat16")
        add_counts(total, counts)
        log(f"[6t] {smi_line}: example {name}: {secs[name]:.3f} s in process; launches {nonzero(counts)}")
        del models
        torch.cuda.empty_cache()
    return {"launches": total, "secs": secs}


def multihost_example(torch, smi_line: str) -> float:
    """6t (c): ``multihost_train`` as MESH_WORLD rank processes on this one
    card over gloo (as 6r runs), its default 200,000 rows and two streamed
    epochs: every rank exits 0, each logs ``distributed initialized``, and
    rank 0 alone prints two finite losses and a finite eval. Returns the
    seconds from the first start to the last exit."""
    import ast

    d = ckpt_dir("multihost")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    url = f"file://{os.path.join(d, 'rendezvous')}"
    root = os.path.dirname(os.path.abspath(__file__))
    logs = [open(os.path.join(d, f"r{r}.log"), "w") for r in range(MESH_WORLD)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torchrecsys_tpu_torch.examples.multihost_train", "--coordinator", url,
         "--num-processes", str(MESH_WORLD), "--process-id", str(r), "--backend", "gloo", "--device", DEVICE],
        cwd=root, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(MESH_WORLD)]
    wait_mesh_ranks(procs, logs, d, t0)
    secs = time.perf_counter() - t0
    texts = []
    for r in range(MESH_WORLD):
        with open(os.path.join(d, f"r{r}.log")) as f:
            texts.append(f.read())
        check(f"[torchrecsys_tpu_torch.distributed] distributed initialized: process {r}/{MESH_WORLD} over gloo"
              in texts[r], f"multihost rank {r}: no distributed log line: {texts[r][-1500:]}")
        check(r == 0 or "losses:" not in texts[r], f"multihost rank {r} printed the results: {texts[r][-800:]}")
    m_loss = re.search(r"^losses: \[(.*)\]$", texts[0], re.M)
    m_eval = re.search(r"^eval: (\{.*\})$", texts[0], re.M)
    check(m_loss is not None and m_eval is not None, f"multihost rank 0 printed no results: {texts[0][-1500:]}")
    losses = [float(x) for x in m_loss.group(1).split(",")]
    ev = ast.literal_eval(m_eval.group(1))
    check(len(losses) == 2 and np.isfinite(losses).all(), f"multihost losses {losses}")
    check(set(ev) == {"loss", "auc"} and np.isfinite(list(ev.values())).all(), f"multihost eval {ev}")
    log(f"[6t] {smi_line}: example multihost_train: {MESH_WORLD} gloo ranks on one card, {MULTIHOST_ROWS} rows, "
        f"two streamed epochs: losses {losses}, eval {ev}; {secs:.1f} s from the first start to the last exit")
    return secs


def profiling_path(torch, data, smi_line: str) -> dict:
    """6t: (a) and (b) on three fits at the main path's width (Linear with
    the category column, hinge, batch 1024, two epochs; Linear sampled
    softmax at 4096, one epoch; the north-star AMP MLP, one epoch), the
    train logger's eval records, then (c) the four examples. Returns the
    launches of every run and the timings."""
    from torchrecsys_tpu_torch import RecSys
    from torchrecsys_tpu_torch.utils.logging import get_logger

    records = log_records()
    train_log = get_logger("torchrecsys_tpu_torch.train")
    train_log.addHandler(records)
    fits = {}
    try:
        rs = RecSys(data, metadata_id_col=["category_id"], n_factors=D, device=DEVICE, dynamic_neg_sampling=True)
        tables = seeded_tables(rs.model, seed=1)
        n = rs.store.num_train
        label = "Linear metadata hinge"
        fits[label] = profiled_fit(torch, rs, tables, dict(epochs=2, batch_size=TRAIN_B), label, smi_line, records,
                                   {"fused_pairwise_step_meta": -(-n // TRAIN_B)})
        for verbose in (True, False):
            n0 = len(records.records)
            ev = rs.evaluate(batch_size=SOFTMAX_B, eval_metrics=("loss", "auc"), verbose=verbose)
            msgs = [r.getMessage() for r in records.records[n0:]]
            check(len(msgs) == int(verbose) and all(re.match(r"^eval: loss=\d+\.\d{5} auc=\d+\.\d{5}$", m)
                                                    for m in msgs),
                  f"{label}: evaluate(verbose={verbose}) logged {msgs}")
        log(f"[6t] {label}: evaluate {ev}: one eval record with verbose=True, none without")
        label = "Linear metadata softmax"
        sm_steps = -(-n // SOFTMAX_B)
        fits[label] = profiled_fit(torch, rs, tables, dict(epochs=1, batch_size=SOFTMAX_B, loss="sampled_softmax"),
                                   label, smi_line, records, {"softmax_ce_fwd": sm_steps, "softmax_ce_bwd": sm_steps})
        del rs
        torch.cuda.empty_cache()
        rs, _ = seeded_mlp(data, use_amp=True)
        label = "MLP AMP"
        mlp_steps = -(-rs.store.num_train // MLP_B)
        fits[label] = profiled_fit(torch, rs, seeded_tables(rs.model, seed=4),
                                   dict(epochs=1, batch_size=MLP_B, learning_rate=0.05, loss="hinge"), label,
                                   smi_line, records,
                                   {"fused_tower_fwd": 2 * mlp_steps, "fused_tower_bwd": 2 * mlp_steps})
        del rs
        torch.cuda.empty_cache()
    finally:
        train_log.removeHandler(records)
    examples = example_runs(torch, smi_line)
    multihost_s = multihost_example(torch, smi_line)
    total: dict = {}
    for out in (*fits.values(), examples):
        add_counts(total, out["launches"])
    return {"launches": total, "fits": fits, "examples": examples["secs"], "multihost_s": multihost_s}


def profile_phase(torch, rs, users_raw):
    """Device time per launch of each kernel and of the split merge, from
    torch.profiler, for K1 and K2 across k at the main-path shape."""
    from torch.profiler import ProfilerActivity, profile

    from torchrecsys_tpu_torch.ops import dot_topk as dt

    rows = torch.as_tensor([rs.store.user_encoder.encode_one(u) for u in users_raw], device=rs.device)
    q, ib, user_fn, _ = rs._linearized()
    uv, _ = user_fn(rs._params(), rows)
    for fn, k in ((dt.dot_topk_small, 10), (dt.dot_topk_large, 16), (dt.dot_topk_large, 128),
                  (dt.dot_topk_large, 1024)):
        fn(uv, q, ib, k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn(uv, q, ib, k)
            torch.cuda.synchronize()
        per = {
            re.sub(r".*::(dot_topk_\w+?)(_kernel)?[<(].*", r"\1", e.key): e.device_time_total / e.count
            for e in prof.key_averages()
            if "dot_topk" in e.key
        }
        total = sum(per.values())
        merge = per.get("dot_topk_merge", 0.0)
        log(f"[profile] {fn.__name__} k={k}: device us per launch " + ", ".join(f"{n} {t:.1f}" for n, t in per.items())
            + f"; main {total - merge:.1f}, merge {merge:.1f} ({merge / max(total, 1e-9):.1%} of the call)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    try:
        import torchrecsys_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {name}; {torch.cuda.device_count()} device(s)")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(smi_line)
    t_start = time.perf_counter()
    build_kernels()
    log(f"[phase] kernel checks starts at {time.perf_counter() - t_start:.1f} s")
    errs = kernel_phase(torch)
    train_err = train_kernel_phase(torch)
    step_err = step_kernel_phase(torch)
    ce_errs, ce_inputs_main = ce_kernel_phase(torch)
    tower_errs, tower_inputs_main = tower_kernel_phase(torch)
    log(f"[phase] card vs CPU starts at {time.perf_counter() - t_start:.1f} s")
    small_catalog_check(torch)
    small_train_check(torch)
    small_softmax_check(torch)
    small_mlp_check(torch)
    t0 = time.perf_counter()
    data = synthetic_interactions()
    log(f"[main] {N_INTERACTIONS} synthetic interactions in {time.perf_counter() - t0:.2f} s")
    log(f"[phase] main paths starts at {time.perf_counter() - t_start:.1f} s")
    rs, fit_meta = train_path(torch, data, meta=True)
    users_raw, launches, rates = main_path(torch, rs)
    kernels = timing_phase(torch, rs, users_raw, launches, errs)
    predict_breakdown(torch, rs, users_raw)
    profile_phase(torch, rs, users_raw)
    split_meta = train_breakdown(torch, rs, "metadata", fit_meta["fit_s"])
    step_meta_row = step_timing(torch, rs, True, step_err, fit_meta["launches"])
    t0 = time.perf_counter()
    ckpt = checkpoint_paths(torch, rs, data)  # 6n a, b
    grown = grow_path(torch, rs)  # 6n d
    secs_6n = time.perf_counter() - t0
    del rs
    torch.cuda.empty_cache()
    rs, fit_plain = train_path(torch, data, meta=False)
    split_plain = train_breakdown(torch, rs, "no metadata", fit_plain["fit_s"])
    step_row = step_timing(torch, rs, False, step_err, fit_plain["launches"])
    del rs
    torch.cuda.empty_cache()
    # FM (fm_sigmoid=True): with metadata the row-level kernel, without it the step kernel's sigmoid variant
    fm, fm_rates, topk_extra = {}, {}, {"dot_topk_small": 0, "dot_topk_large": 0}
    for meta in (True, False):
        rs, fm[meta] = train_path(torch, data, meta=meta, net="fm", evaluate=True)
        _, fm_launches, fm_rates[meta] = main_path(torch, rs, " " + fm[meta]["label"])
        topk_extra = {k: v + fm_launches[k] for k, v in topk_extra.items()}
        topk_extra["dot_topk_small"] += fm[meta]["eval_launches"]
        fm[meta]["split"] = train_breakdown(torch, rs, fm[meta]["label"], fm[meta]["fit_s"])
        if meta:
            train_row = train_timing(torch, rs, train_err)
        del rs
        torch.cuda.empty_cache()
    # AMP: the step kernel's bf16 variants; a bf16 predict from the metadata model's tables
    amp, amp_rates = {}, {}
    for net, meta in (("linear", True), ("linear", False), ("fm", False), ("fm", True)):
        rs, out = train_path(torch, data, meta=meta, net=net, amp=True)
        out["split"] = train_breakdown(torch, rs, out["label"], out["fit_s"])
        if meta and net == "linear":
            q, *_ = rs._linearized()
            check(q.dtype == torch.bfloat16, f"{out['label']}: the catalog is {q.dtype}, want bfloat16")
            _, amp_launches, amp_rates = main_path(torch, rs, " " + out["label"])
            topk_extra = {k: v + amp_launches[k] for k, v in topk_extra.items()}
        amp[(net, meta)] = out
        del rs
        torch.cuda.empty_cache()
    for row in kernels:
        row["launches"] += topk_extra[row["name"]]
    train_row["launches"] = (fit_meta["row_launches"] + fit_plain["row_launches"] + fm[True]["launches"]
                             + amp[("fm", True)]["launches"])
    step_row["launches"] += fm[False]["launches"] + amp[("linear", False)]["launches"] + amp[("fm", False)]["launches"]
    step_meta_row["launches"] += amp[("linear", True)]["launches"]
    kernels.extend([train_row, step_row, step_meta_row])
    log(f"[phase] softmax paths starts at {time.perf_counter() - t_start:.1f} s")
    rs, sm_meta = softmax_train_path(torch, data, meta=True, evaluate=True)
    split_sm_meta = softmax_breakdown(torch, rs, "softmax metadata")
    del rs
    torch.cuda.empty_cache()
    rs, sm_plain = softmax_train_path(torch, data, meta=False, evaluate=False)
    split_sm_plain = softmax_breakdown(torch, rs, "softmax no metadata")
    del rs
    torch.cuda.empty_cache()
    rs, sm_amp = softmax_train_path(torch, data, meta=False, evaluate=False, amp=True)
    split_sm_amp = softmax_breakdown(torch, rs, "Linear AMP softmax no metadata")
    del rs
    torch.cuda.empty_cache()
    rs, sm_fm = softmax_train_path(torch, data, meta=True, evaluate=True, net="fm")
    split_sm_fm = softmax_breakdown(torch, rs, "FM softmax metadata")
    del rs
    sms = (sm_meta, sm_plain, sm_amp, sm_fm)
    kernels.extend(ce_timing(torch, ce_inputs_main, ce_errs, {
        "softmax_ce_fwd": sum(x["fwd_launches"] + x["eval_launches"] for x in sms),
        "softmax_ce_bwd": sum(x["bwd_launches"] for x in sms),
    }))
    torch.cuda.empty_cache()
    log(f"[phase] MLP path starts at {time.perf_counter() - t_start:.1f} s")
    rs, mlp = mlp_train_path(torch, data)
    split_mlp = mlp_breakdown(torch, rs)
    t0 = time.perf_counter()
    mlp_ckpt = mlp_checkpoint_path(torch, rs)  # 6n c
    secs_6n += time.perf_counter() - t0
    del rs
    torch.cuda.empty_cache()
    witness = mlp_f32_witness(torch, data, mlp)
    kernels.extend(tower_timing(torch, tower_inputs_main, tower_errs, {
        "fused_tower_fwd": mlp["fwd_launches"], "fused_tower_bwd": mlp["bwd_launches"],
    }))
    kernels.extend(layer_norm_timing(torch))
    kernels.extend(hstu_attention_timing(torch))
    torch.cuda.empty_cache()
    ha_fit = hstu_fit_path(torch)
    torch.cuda.empty_cache()
    log(f"[phase] 6j-6m starts at {time.perf_counter() - t_start:.1f} s")
    rs, pop = popularity_path(torch, data)
    step_meta_row["launches"] += pop["launches"]
    fit_kw = {k: v for k, v in pop["fit_kw"].items() if k not in ("epochs", "batch_size")}
    pop["split"] = train_breakdown(torch, rs, pop["label"], pop["fit_s"], fit_kw=fit_kw)
    del rs
    torch.cuda.empty_cache()
    rs, warp = warp_path(torch, data)
    warp["split"] = mlp_breakdown(torch, rs, label=warp["label"])
    del rs
    torch.cuda.empty_cache()
    rs, neucf = neucf_path(torch, data)
    neucf["split"] = mlp_breakdown(torch, rs, label=neucf["label"])
    del rs
    torch.cuda.empty_cache()
    small_options_check(torch)
    # C1: #1/#2 above D = 128 (NeuCF's similar_items above; Linear at n_factors=160 here)
    t0 = time.perf_counter()
    wide_launches, wide_rates = wide_path(torch, data)
    secs_c1 = time.perf_counter() - t0
    # 6o: the sequence models at full width, then card against CPU at a small size
    t0 = time.perf_counter()
    log(f"[phase] 6o starts at {time.perf_counter() - t_start:.1f} s")
    seq = {}
    for net in ("lstm", "sasrec"):
        rs, seq[net] = sequence_path(torch, data, net)
        del rs
        torch.cuda.empty_cache()
    seq_job = small_sequence_check(torch)
    secs_6o = time.perf_counter() - t0
    seq_extra = dict(seq["sasrec"]["softmax"]["launches"])
    for out in seq.values():
        for kernel, n in out["launches"].items():
            seq_extra[kernel] = seq_extra.get(kernel, 0) + n
    # 6p: EASE at 100K users x 30K items (no kernel; its cold load rides 6n's child)
    t0 = time.perf_counter()
    log(f"[phase] 6p starts at {time.perf_counter() - t_start:.1f} s")
    ease = ease_path(torch)
    secs_6p = time.perf_counter() - t0
    # 6q: the streaming fit through #3, #4/#5 and #6/#7
    t0 = time.perf_counter()
    log(f"[phase] 6q starts at {time.perf_counter() - t_start:.1f} s")
    stream = streaming_path(torch, data)
    secs_6q = time.perf_counter() - t0
    # 6r: the mesh, four ranks sharing the card over gloo (its FM checkpoint's cold load rides 6n's child)
    t0 = time.perf_counter()
    log(f"[phase] 6r starts at {time.perf_counter() - t_start:.1f} s")
    mesh = mesh_path(torch, data, smi_line)
    secs_6r = time.perf_counter() - t0
    # 6s: the generic step on a mesh (the MLP's tower kernels with their sums over data, SASRec's B5, ...)
    t0 = time.perf_counter()
    log(f"[phase] 6s starts at {time.perf_counter() - t_start:.1f} s")
    gen = generic_mesh_path(torch, data, smi_line)
    secs_6s = time.perf_counter() - t0
    # 6t: logging, profile_epochs on three fits (#3, #4/#5, #6/#7) and the four examples
    t0 = time.perf_counter()
    log(f"[phase] 6t starts at {time.perf_counter() - t_start:.1f} s")
    prof = profiling_path(torch, data, smi_line)
    secs_6t = time.perf_counter() - t0
    # 6n: the cold loads of a, c and d (and 6o's small LSTM) in one child process; 6n's launches
    linear_job = {"name": "Linear metadata", "dir": ckpt["dir"], "users": ckpt["users"], "ks": (10, 128),
                  "warm": ckpt["warm"], "config": ckpt["config"]}
    t0 = time.perf_counter()
    log(f"[phase] 6n's child starts at {time.perf_counter() - t_start:.1f} s")
    cold = run_cold_children(torch, [linear_job, grown, mlp_ckpt, seq_job, ease["job"], mesh["job"], gen["job"]])
    shutil.rmtree(ckpt_dir(""), ignore_errors=True)
    secs_6n += time.perf_counter() - t0
    extra: dict = {}
    mesh_extra: dict = {}
    mesh_cold = cold.pop(mesh["job"]["name"])["counts"]
    gen_cold = cold.pop(gen["job"]["name"])["counts"]
    for counts in (ckpt["launches"], grown["launches"], mlp_ckpt["launches"],
                   *(res["counts"] for name, res in cold.items() if name != "small LSTM")):
        for kernel, n in counts.items():
            extra[kernel] = extra.get(kernel, 0) + n
    for kernel, n in cold["small LSTM"]["counts"].items():
        seq_extra[kernel] = seq_extra.get(kernel, 0) + n
    for counts in (mesh["launches"], mesh_cold):
        for kernel, n in counts.items():
            mesh_extra[kernel] = mesh_extra.get(kernel, 0) + n
    gen_extra: dict = {}
    for counts in (gen["launches"], gen_cold):
        for kernel, n in counts.items():
            gen_extra[kernel] = gen_extra.get(kernel, 0) + n
    for counts in (wide_launches, neucf["similar_counts"]):
        for kernel, n in counts.items():
            extra[kernel] = extra.get(kernel, 0) + n
    for row in kernels:
        row["launches"] += (extra.get(row["name"], 0) + seq_extra.get(row["name"], 0)
                            + stream["launches"].get(row["name"], 0) + mesh_extra.get(row["name"], 0)
                            + gen_extra.get(row["name"], 0) + prof["launches"].get(row["name"], 0))
        if row["name"] in MESH_WRAPPERS:
            row["mesh_wrappers"] = MESH_WRAPPERS[row["name"]]
            row["mesh_launches_6r"] = mesh_extra.get(row["name"], 0)
        if row["name"] in GEN_ROUTES:
            row["mesh_routes_6s"] = GEN_ROUTES[row["name"]]
            row["mesh_launches_6s"] = gen_extra.get(row["name"], 0)
        if row["name"].startswith("dot_topk"):
            row["variants"] = ["D <= 128: one ring unit per tile (k steps for D up to 32, 64, 80, 128)",
                               "D > 128: the slab path, 128-byte TMA boxes in the 128-byte swizzle, two per "
                               "16 KB ring unit and an odd last one a tail unit, each unit's products added in "
                               "registers, every unit's user images resident; timed at D="
                               + " and ".join(f"{wd} as d{wd}" for wd in TIMED_WIDE_DS)]
        shapes = {k: v for k, v in {**mesh["timing"], **gen["timing"]}.items() if k.split(" ")[0] == row["name"]}
        if shapes:
            row["mesh_shapes"] = shapes
        if row["name"].startswith("softmax_ce"):
            row["variants"] = ["square (one device: B rows against B columns)",
                               f"rectangular (a data rank: Br={SOFTMAX_B // MESH_WORLD} rows against Bc={SOFTMAX_B} "
                               "columns from off = rank x Br), the same kernels"]
    for row, n in zip((r for r in kernels if r["name"].startswith("layer_norm")), seq["sasrec"]["ln_launches"]):
        row["launches"] = n  # the main path's counted run: 6o's AMP SASRec fit
    for row, n in zip((r for r in kernels if r["name"].startswith("hstu_attention")), ha_fit["launches"]):
        row["launches"] = n  # the main path's counted run: HSTU's fit at the cell's widths
    log(f"[ckpt] {smi_line}: Linear metadata checkpoint {ckpt['bytes'] / 2**20:.1f} MiB, save "
        f"{ckpt['save_s']:.3f} s, load {ckpt['load_s']:.3f} s in process / "
        f"{cold['Linear metadata']['load_s']:.3f} s cold in the child, restore {ckpt['restore_s']:.3f} s; "
        f"MLP AMP checkpoint {mlp_ckpt['bytes'] / 2**20:.1f} MiB, save {mlp_ckpt['save_s']:.3f} s, load "
        f"{mlp_ckpt['load_s']:.3f} s / {cold['MLP AMP']['load_s']:.3f} s cold; update_data "
        f"{grown['update_s']:.3f} s on the host, grow_state {grown['grow_ms']:.3f} ms, partial_fit "
        f"{grown['fit_examples_per_s']:.1f} examples/s; 6n took {secs_6n:.1f} s of the run; 6n launches "
        f"{nonzero(extra)}")
    log(f"[main] predict users/s: {json.dumps(rates)}")
    log(f"[main] fit examples/s: metadata {fit_meta['examples_per_s']:.1f}, no metadata "
        f"{fit_plain['examples_per_s']:.1f}; host ms per step {split_meta['step_ms']:.4f} / "
        f"{split_plain['step_ms']:.4f}; device busy us per step {split_meta['busy_us']:.2f} / "
        f"{split_plain['busy_us']:.2f}; device idle share in fit: metadata "
        f"{split_meta['idle_share']:.3f}, no metadata {split_plain['idle_share']:.3f}")
    for out in (fm[True], fm[False], *amp.values()):
        sp = out["split"]
        log(f"[main] {out['label']} fit examples/s {out['examples_per_s']:.1f}; host ms per step "
            f"{sp['step_ms']:.4f}; device busy us per step {sp['busy_us']:.2f} (kernel {sp['kernel_us']:.2f}); "
            f"idle share {sp['idle_share']:.3f}"
            + (f"; evaluate AUC {out['fresh_auc']:.5f} -> {out['auc']:.5f}" if "auc" in out else ""))
    log(f"[main] FM predict users/s: metadata {json.dumps(fm_rates[True])}, no metadata "
        f"{json.dumps(fm_rates[False])}; Linear AMP (bf16 catalog) {json.dumps(amp_rates)}")
    log(f"[main] softmax fit examples/s: metadata {sm_meta['examples_per_s']:.1f}, no metadata "
        f"{sm_plain['examples_per_s']:.1f}; host ms per step {split_sm_meta['step_ms']:.4f} / "
        f"{split_sm_plain['step_ms']:.4f}; device idle share {split_sm_meta['idle_share']:.3f} / "
        f"{split_sm_plain['idle_share']:.3f}; evaluate loss+auc rows/s {sm_meta['eval_rows_per_s']:.1f}")
    for out, sp in ((sm_amp, split_sm_amp), (sm_fm, split_sm_fm)):
        log(f"[main] {out['label']} fit examples/s {out['examples_per_s']:.1f}; host ms per step "
            f"{sp['step_ms']:.4f}; device us per step ce_fwd {sp['ce_fwd_us']:.2f}, ce_bwd {sp['ce_bwd_us']:.2f}; "
            f"idle share {sp['idle_share']:.3f}"
            + (f"; evaluate AUC {out['fresh_auc']:.5f} -> {out['auc']:.5f}" if "auc" in out else ""))
    log(f"[main] MLP AMP fit examples/s {mlp['examples_per_s']:.1f} (first epoch, {mlp['steps']} steps of {MLP_B}); "
        f"host ms per step {split_mlp['step_ms']:.4f}; device idle share {split_mlp['idle_share']:.3f}; "
        f"evaluate loss+auc rows/s {mlp['eval_rows_per_s']:.1f} (AUC {mlp['fresh_auc']:.5f} -> "
        f"{mlp['auc']:.5f}; f32 witness {witness['auc']:.5f}); predict 16 users {mlp['predict_s']:.3f} s")
    for out in (pop, warp, neucf):
        sp = out["split"]
        log(f"[main] {out['label']} fit examples/s {out['examples_per_s']:.1f}; host ms per step "
            f"{sp['step_ms']:.4f}; device busy us per step {sp['busy_us']:.2f}; idle share {sp['idle_share']:.3f}"
            + (f"; evaluate rows/s {out['eval_rows_per_s']:.1f}" if "eval_rows_per_s" in out else ""))
    for out in seq.values():
        sp = out["split"]
        log(f"[main] 6o {smi_line}: {out['label']} fit examples/s {out['examples_per_s']:.1f} (one epoch of "
            f"{MLP_B}); host ms per step {sp['step_ms']:.4f}; device busy us per step {sp['busy_us']:.2f}; idle "
            f"share {sp['idle_share']:.3f}; evaluate rows/s {out['eval_rows_per_s']:.1f}; predict users/s "
            f"{json.dumps(out['rates'])}")
    log(f"[main] 6o {smi_line}: SASRec AMP softmax fit examples/s {seq['sasrec']['softmax']['examples_per_s']:.1f} "
        f"(one epoch of {SOFTMAX_B}); 6o took {secs_6o:.1f} s of the run (its cold load rides 6n's child); "
        f"6o launches {nonzero(seq_extra)}")
    log(f"[main] 6p {smi_line}: EASE {N_USERS} users x {EASE_ITEMS} items: fit {ease['fit_s']:.3f} s (host CSR "
        f"{ease['csr_s']:.3f} s, Gram "
        f"{ease['gram_s']:.3f} s, solve {ease['solve_s']:.3f} s), peak {ease['peak'] / 2**30:.2f} GiB, residual "
        f"{ease['res_max']:.3g}; evaluate {ease['eval_s']:.3f} s {json.dumps(ease['eval'])}; predict users/s "
        f"{json.dumps(ease['rates'])}; save {ease['save_s']:.3f} s, cold load {cold['EASE']['load_s']:.3f} s in the "
        f"child; update_data {ease['update_s']:.3f} s, refit {ease['refit_s']:.3f} s; Newton-Schulz at "
        f"{EASE_ITER_ITEMS} items {ease['iterations']} iterations in {ease['iter_s']:.3f} s; 6p took {secs_6p:.1f} s")
    ov = stream["overlap"]
    log(f"[main] 6q {smi_line}: Linear metadata hinge examples/s resident {stream['rates']['resident']} streamed "
        f"{stream['rates']['streamed']} ({stream['chunks']} chunks of {STREAM_SB}); profiled streamed epoch "
        f"{stream['wall_ms']:.3f} ms: chunk copies {ov['copy_ms']:.3f} ms of device time, {ov['exposed_ms']:.3f} ms "
        f"of it with no kernel running; idle share {ov['idle_share']:.3f}; softmax resident {stream['softmax_resident']:.1f} streamed "
        f"{stream['softmax_rate']:.1f}, MLP AMP resident {stream['mlp_resident']:.1f} streamed "
        f"{stream['mlp_rate']:.1f} examples/s; 6q launches {nonzero(stream['launches'])}; 6q took {secs_6q:.1f} s")
    log(f"[main] 6r {smi_line}: the mesh, four ranks sharing one card over gloo (no scaling figure): 6r took "
        f"{secs_6r:.1f} s of the run (the ranks {mesh['ranks_s']:.1f} s); 6r launches over all ranks "
        f"{nonzero(mesh['launches'])}, its FM checkpoint's cold load {nonzero(mesh_cold)}")
    log(f"[main] C1 {smi_line}: Linear D={WIDE_D} predict users/s {json.dumps(wide_rates)}; NeuCF similar_items "
        f"launches {nonzero(neucf['similar_counts'])}; C1 took {secs_c1:.1f} s of the run")
    log(f"[main] 6s {smi_line}: the generic step on a mesh, four ranks sharing one card over gloo (no scaling "
        f"figure): 6s took {secs_6s:.1f} s of the run (the ranks {gen['ranks_s']:.1f} s); 6s launches over all "
        f"ranks {nonzero(gen['launches'])}, its MLP checkpoint's cold load {nonzero(gen_cold)}")
    log(f"[main] 6t {smi_line}: profiled / unprofiled epoch s " + "; ".join(
        f"{k} {v['prof_epoch_s']:.3f} / {v['plain_epoch_s']:.3f} (trace {v['trace_mib']:.1f} MiB, bit for bit "
        f"{v['bitwise']})" for k, v in prof["fits"].items())
        + f"; examples s {json.dumps({k: round(v, 3) for k, v in prof['examples'].items()})}, multihost_train "
        f"{prof['multihost_s']:.1f} s; 6t took {secs_6t:.1f} s of the run; 6t launches {nonzero(prof['launches'])}")
    log(f"[main] the popularity alias table at {N} items: {pop['alias_s']:.3f} s on the host (outside the "
        f"6j fit, inside 6k's); NeuCF AMP predict 16 users {neucf['predict_s']:.3f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
