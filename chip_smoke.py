#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (svdfeature_tpu_torch) on one NVIDIA GPU.

Usage, from the repository root:  python3 chip_smoke.py

Phases (one or more lines each; any failure exits non-zero and prints no
result line):
  0. the card's name and power limit (nvidia-smi); exit 1 without CUDA;
  1. build the CUDA kernels from svdfeature_tpu_torch/csrc/ with nvcc
     into build/kernels/;
  2. K1 (csrc/fused_embed.cu, one cooperative launch a call) against its
     plain PyTorch version on identical numpy-seeded inputs, R=2 rounds at
     basicMF shapes (N=2626, k=64, B=4096, T=23) and neighborhoodModel
     shapes (+ NG=7, SG=3), for active_type 0/2 and exact_global 0/1, and
     once with R=3 and a second call on the same tensors (the kept plan),
     each call exactly one launch, with both times (on the same device
     tensors call after call, as the trainer calls it);
  3. the slice through the port's entry points: make_feature_buffer, then
     SVDTrainTask (40 rounds, batch_size=4096, device=cuda) and
     SVDInferTask for basicMF, binaryClassification and
     neighborhoodModel; the final test RMSE must lie in the
     golden/GOLDEN.json band and every round must have gone through the
     kernel (launch count 40: one cooperative launch a round).  basicMF
     runs once more with use_pallas=0 (the plain version) for the
     end-to-end comparison, and prints the kernel's share of ten more
     rounds by its own clock (no gate: a round is 23 steps);
  4. the SVD++ kernel (csrc/fused_svdpp.cu) against its plain version on
     numpy-seeded inputs packed by the port's pack_plus from the ML-100K
     user-group fixtures, R=2: the RMSE-band setting (128 users x 8 rows,
     T=159, 8 chunks) and one row per user (its first two user chunks,
     T=1016), active_type 0/2, no_user_bias 0/1, a synthetic pairwise
     (item width 2) case and a case with more users per step (256, its
     first two chunks) than the kernel's resident grid has blocks, each
     one cooperative launch, with both times (three R=2 runs
     each, the kernel's on the same device tensors call after call, as the
     trainer calls it) and a profile;
  5. the implicitFeedback slice: make_ugroup_buffer -fd, SVDTrainTask (40
     rounds, sort_blocks=1 rows_per_user=8, device=cuda), SVDInferTask;
     the final test RMSE must lie in the GOLDEN.json band and every step
     must have gone through the kernel (launch count 40: one cooperative
     launch a round); over ten more rounds, a synchronise after each, the
     kernel must be running for at least 0.7 of the time, and one more round
     is profiled; once more with use_pallas=0 for 10 rounds, held to
     within 1e-4 of the kernel run's checkpoint of round 10;
  6. the big-table kernels against their plain versions at bigTable
     shapes (2,048,577 rows, k=64): K5 and K6 on 2^21 rows (~20% on the
     dummy row) bit for bit, with the library call's time, and K5 once more
     at the E=8192 rows of one batch-4096 step (bigTable (c)'s calls, whose
     time the kernel line reports), where it must not be slower than
     index_copy_ by more than the spread between the turns; K4 (entries
     formed in the kernel from the step's factors) on the plan of one
     B=2^20 batch of bigTable's data and of a skewed one (items from a
     Zipf law, exponent 1.1: runs of thousands of entries), reg_method 0
     and 4, and on a 40,960-row table (reg_method 0-5, no_user_bias with
     the nonnegative clamps), with times against the bound and a profile;
     then K4 on rows wider than 256 factors (the wide kernel: a warp a
     run, sweeps of up to 512 columns) on a 65,536-row table at batch
     2^14: k=300, 512 and 1024 (16-byte copies) and 257 and 301 (4-byte
     copies), uniform items and a skewed batch (Zipf, every long run cut
     into pieces), reg_method 0-5 across the cases, each with kernel /
     plain / bound ms and the kernel's share of the bound (phase 1 fails
     if ptxas reports spills for either form of the wide kernel);
  7. bigTable (bench.py's synthetic KDD-Cup-scale workload, numpy only)
     through the port's entry points, 3 rounds each: (a) batch 2^20, the
     tile sweep (K4), (b) the same with use_pallas=0, (c) batch 4096,
     sorted dedup (K5), (d) batch 2^20 with big_sweep=0 (K5); exact launch
     counts, the probe RMSE falls and lies within 1e-4 of the JAX
     package's CPU figure (scripts/bigtable_jax_reference.py), (a) and (b)
     agree, examples/s beside the reference C++ baseline, peak memory;
     then (e) rows of 300 factors: bigTable's recipe on a 32,769-row table
     (16,384 users and items, 2^15 examples), batch 8192, big_sweep=1, 2
     rounds through the tasks, one K4 launch a step, the probe within 1e-4
     of the JAX CPU figure (scripts/wide_sweep_jax_reference.py);
  8. the stacked multi-IMFB kernel K3 (csrc/fused_imfb.cu, one cooperative
     launch a call, with K2's flush, gather and apply bodies) against its
     plain version, R=2: at the slice's shapes (the depth-2 ML-100K set,
     128 units x 8 rows, T=449, D=2, nseg=129), once more on the same
     tensors (the kept plan), and on synthetic stacked sets with
     no_user_bias=1 and ufeedback_disable_level=1 at rows_per_user 1 and
     2, each call exactly one launch, with both times (two R=2 runs each),
     the bound and a profile;
  9. the stacked slice: the depth-2 transform of the implicitFeedback train
     set (write_plus_buffer) and the stock test buffer (make_ugroup_buffer
     -fd), SVDTrainTask (extend_type=2 rows_per_user=8, 8 rounds,
     device=cuda) and SVDInferTask through K3, the round-8 test RMSE
     within 1e-4 of the JAX package's CPU figure
     (scripts/imfb_jax_reference.py) and within 0.008 of the reference
     binary's (golden/multi_imfb_stacked.rmse.tsv), with exact launch
     counts (8: one a round); once more with use_pallas=0 for 2 rounds,
     within 1e-5 of the kernel run's checkpoint of round 2; over ten more
     rounds, a synchronise after each, the kernel must be running for at
     least 0.7 of the time by its own clock;
 10. the general route: basicMF at reg_method=1, binaryClassification at
     active_type=5 and implicitFeedback at reg_method=4, 5 rounds each
     through SVDTrainTask / SVDInferTask on the card; no kernel takes them,
     so they train on the plain rounds (K1 / K2 launch counts 0), and the
     test RMSE must lie within 1e-5 (1e-4 for SVD++) of the JAX package's
     CPU figure (scripts/general_jax_reference.py);
 11. big-table SVD++ and big-table multi-IMFB: bench.py's bigSvdpp data
     (numpy only: 1,000,000 users, 624,000 items, 624,000 feedback ids,
     a 2,248,001-row table, k=64, 1,999,760 rows of 100,000 users a round,
     written with write_plus_buffer) through SVDTrainTask / SVDInferTask at
     bench.py's conf (G=4096 users x 4 rows a step, sort_blocks=1): (a) the
     user-carry epoch with K5, 3 rounds, (b) the same with use_pallas=0,
     (c) reg_method=4 (the entry-stream body), 1 round, (d) the depth-2
     transform of the first 20,000 users under extend_type=2, 2 rounds;
     the probe (the first 2000 user blocks) RMSE must fall and lie within
     1e-4 of the JAX package's CPU figure
     (scripts/bigsvdpp_jax_reference.py), (a) and (b) within 1e-5 of each
     other, with K5's launch count the plan's (its item writes, and per
     chunk exit the pool writeback and the slab write); examples/s beside
     the reference binary's, pack seconds and peak memory; then K5 bit for
     bit against its plain version at the three call shapes of one epoch
     of (a) (item write, pool writeback, slab write) and the two of (d)
     (the step's rows, the contexts' writeback), timed in turns with
     index_copy_;
 12. K2 on per-round planes (csrc/fused_svdpp.cu: user and item planes
     [R*T, G*M], a pair epoch sampled afresh for every round) against its
     plain version at the pairwiseRank demo's shapes (the skeleton of the
     ML-100K rank train set, 64 users x 8 rows a step, item width 2),
     R=8 rounds in one call, twice (the kept plan), one launch a call, with
     both times, the bound and the cost of checking a round's fresh planes;
 13. pairwiseRank (demo/pairwiseRank: make_ugroup_buffer on the ML-100K
     rank fixtures, k=64, active_type=3, 40 rounds) through SVDTrainTask
     and SVDInferTask pred=40 with the ranker: (kernel) one K2 launch a
     round (40), (plain) use_pallas=0 for 10 rounds, (multi) the
     trainer's update_rounds(src, 40) on the multi-round host sampler (5
     launches), (device) rank_device_sample=1 (1 launch); P@20 as
     demo/pairwiseRank/eval.py computes it within 0.003 of the golden
     0.1651, the kernel run within 0.001 of the JAX package's CPU figure
     (scripts/rank_jax_reference.py), the plain run within 0.001 of the
     kernel run at round 10, with the count of their differing rank
     positions, pairs/s beside the reference binary's;
 14. bigRank (bench.py's KDD-Cup-geometry rank data, numpy only:
     1,000,000 users, 624,000 items, 624,000 feedback ids, k=64, 25,000
     users x 80 rows, 1.5M pairs a round) on the trainer: (a) the
     per-round path, 2 rounds (the entry-stream big epoch), its probe
     order accuracy and mean raw margin (a fresh seed-77 epoch's first 2000
     user blocks) within 1e-4 of the JAX package's CPU figures (scripts/
     rank_jax_reference.py --big); (b) the multi path, one block of 8
     rounds (the user-carry body), accuracy above 0.75; K5 launch counts
     the plan's, pairs/s beside the reference binary's, and K5 bit for bit
     and timed at each run's call shapes;
 15. the shared feedback space (common_feedback_space=1, the per-batch
     refresh epochs): the implicitFeedback train and test sets with
     user-space follow feedback (user u follows min(its feedback count,
     100) distinct users drawn by default_rng(7), value 1/sqrt(n),
     num_ufeedback=943) through SVDTrainTask / SVDInferTask with
     use_pallas set: (a) SVD++ at sort_blocks=1 rows_per_user=8, 5 rounds,
     (b) the depth-2 stacked transform under extend_type=2, 2 rounds; no
     kernel launches (K1, K2 and K3 refuse the shared space), the test
     RMSE within 1e-4 of the JAX package's CPU figure
     (scripts/refresh_jax_reference.py), examples/s beside phase 5's;
 16. the bilinear solver (extend_type=15) through the tasks, use_pallas
     set, K2 and K3 never launched: (a) num_bi_feedback=0 on the
     implicitFeedback band setting, 3 rounds, every round equal to the
     port's plain SVD++ run on the same file-order pack to 1e-6 and within
     0.01 of golden/bilinear.rmse.tsv; (b) num_bi_feedback=1682 (the
     item-item W_bi of the integrated neighbourhood model), 2 rounds; (c)
     phase 15's follow data on the refresh route, 3 rounds; (d) bigSvdpp's
     geometry cut to its first 20,000 users with two property ids each
     (num_bi_feedback=64, W_bi 624,000 x 64; start_ufeedback=64 keeps the
     property ids out of the factor sum), 2 rounds, K5 launches the plan's; (b)-(d) within 1e-4 of the JAX package's CPU figure
     (scripts/bilinear_jax_reference.py); then K5 bit for bit at (d)'s
     W_bi write, timed in turns with index_copy_;
 17. GBRT through SVDTrainTask / SVDInferTask with device=cuda (the trees
     fitted on the host, the model walked on the card in the evals by
     ops/gbrt_forward.py, plain PyTorch; no kernel launches): (a) RegGBRT
     (extend_type=31) on the implicitFeedback buffers at the reference
     binary's recorded tree parameters, the first 2 of the golden's 6
     rounds, each round's test RMSE
     within 5e-6 of golden/gbrt_reg.rmse.tsv, every eval of a model of more
     than one tree on the card's walk (counted in
     gbrt_forward.forward_trees.walks), the last model's card walk within
     1e-5 of its host walk; (b) the 2-tree model walked over the training
     set (90,570 rows, 18.4M entries) on the card and on the host, within
     1e-5, both timed (CUDA events, median of 5); (c) APLambda
     (extend_type=30, active_type=3, lambda_ap_alpha=0.5,
     lambda_ap_reject=1) on the pairwiseRank training set read as plain
     user-group data, 2 rounds and an eval, the trained model's scores of
     the implicitFeedback test set (a card walk) within 1e-5 of the JAX
     package's CPU run (scripts/gbrt_jax_reference.py, SVDInferTask pred:
     the moments and every 397th score);
 18. out-of-core training (streaming=1) through SVDTrainTask and
     SVDInferTask, the test sets read a chunk at a time too, on the buffers
     of the earlier phases: (g) basicMF, chunks of 16384 examples (K1, one
     launch a chunk, 40 rounds, in the GOLDEN band); (a) bigTable's tile
     sweep (K4) and (c) its sorted dedup (K5), chunks of 2^20 and 2^19
     examples (whole batches), 3 rounds, the probe within 1e-5 of phase 7
     (a)'s staged one and within 1e-4 of the JAX CPU figures; (b)
     implicitFeedback at sort_blocks=1 rows_per_user=8, chunks of 256 users
     sorted within themselves (K2, 40 rounds, in the GOLDEN band); (d)
     bigSvdpp's user-carry epoch (K5), chunks of 32768 users, 1 round; (e)
     the stacked set, chunks of 512 units with the open contexts carried
     (K3, 8 rounds); (b), (d), (e) within 1e-4 of the JAX package's
     streamed runs (scripts/streaming_jax_reference.py).  Launch counts the
     chunks' plans', no chunk tensor left in a kernel plan after a round,
     examples/s beside the staged run of the same phase, the seconds a round
     waits for chunks against those it trains them (the tracer's
     ``stream.wait`` and ``stream.chunk`` spans), peak device memory; (f) in
     (a) the device memory held beyond a round's start at a chunk's entry
     within (prefetch + 1) staged chunks;
 19. the base solver on a 2x2 mesh, in one torchrun call of 4 ranks with
     phase 20's and 21's runs (``python -m torch.distributed.run --nproc_per_node=4
     chip_smoke.py --mesh-rank ...``, with a timeout; each rank runs the
     train CLI, then the infer CLI, of every run with mesh_data=2
     mesh_model=2: (c) first, joining the world through the mesh keys
     alone, then distributed=1; the backend is printed: gloo when the ranks
     share the one card; no rank may hold memory on a card but its own): (a)
     basicMF 40 rounds on phase 3's buffers, in the GOLDEN band and within
     1e-4 of phase 3's RMSE; (b) bigTable at batch 4096 on phase 7 (c)'s
     buffers, 3 rounds, mesh_big by its auto rule, the probe within 1e-4
     of phase 7 (c)'s and K5 launched once a step on every rank (512 a
     round) and no other kernel; (c) basicMF streamed (streaming=1) in
     chunks of whole batches, 5 rounds, within 1e-5 of (a) at round 5;
     then K5 at the mesh slab's shape (one step's gathered stream into
     [1,024,290 x 68]) bit for bit against its plain version, timed in turns
     with it and with index_copy_; (d) the lite example solver
     (extend_type=99) on (a)'s buffers, 2 rounds at batch_size=4095 (the
     mesh rounds it up to 4096), no kernel, each rank naming its own files:
     rank 0's alone appear (3 checkpoints, 2 JSON lines, 1 eval line), its
     last checkpoint within 1e-6 of the single card's run at batch 4096,
     its test RMSE and mean |w| within 1e-5 of the JAX lite trainer's 2x2
     CPU mesh (scripts/lite_mesh_jax_reference.py);
 20. the SVD++ and multi-IMFB trainers on the same 2x2 mesh, in that call:
     (a) implicitFeedback at the band setting 2 rounds, (c) pairwiseRank 2
     rounds (a fresh packed pair epoch a round) then the ranker with the
     same mesh keys, (d) the depth-2 stacked set 1 round, no kernel; (b)
     bigSvdpp 2 rounds, (e) big multi-IMFB 1 round and (f) bigSvdpp
     streamed 1 round on mesh_big slabs, K5 twice a mesh step on every rank
     (exact counts); every figure within 1e-4 of the JAX package's 2x2 CPU
     mesh (scripts/mesh_plus_jax_reference.py; (c) P@20 within 0.001 and
     its checkpoint's w within 1e-4), (b) within 1e-4 of phase 11 (a) at
     round 2; then K5 at the mesh pool writeback's shape bit for bit;
 21. the bilinear trainer on the same 2x2 mesh, in that call: (a) the
     item-item W_bi of phase 16 (b) (1682 x 1682, sharded over model) on
     small slabs, 2 rounds, no kernel, its test RMSE within 1e-4 of the JAX
     package's 2x2 CPU mesh (scripts/mesh_bi_jax_reference.py) and of
     phase 16 (b) at round 2, its round-2 checkpoint's w and pinned W_bi
     rows within 1e-4 of the JAX mesh's (scripts/mesh_bi_jax_a.npz), its
     w and whole W_bi within 1e-4 of phase 16 (b)'s round-2 checkpoint;
     (b) big bilinear on phase 16 (d)'s data on mesh_big slabs (W_bi
     624,000 x 64 in scratch-interleaved slabs), 2 rounds, the probe within
     1e-4 of the JAX 2x2 CPU mesh and of phase 16 (d), K5 three times a
     mesh step on every rank (exact counts); then K5 bit for bit at the W_bi
     slab write of model position 0, timed in turns with index_copy_.
Each phase prints its time, and the script its total.  Then one JSON
line describing the kernels, all six, K4 once more on rows of 300
factors (its k=512 time beside), K5 once more at big bilinear's
W_bi write and once more for each mesh's writes (with each one's
bound: the larger of its bytes over 3.35 TB/s and its f32 operations
over 67 TFLOP/s, the H100 SXM's published rates at 700 W) and, last, one
JSON line naming the device.
"""

from __future__ import annotations

import functools
import gzip
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
ROUNDS = 40
SLICE_PLAIN_ROUNDS = 10  # phase 5's plain rounds, held to the kernel run at that round
SLICE_PLAIN_TOL = 1e-4  # SVD++ kernel against plain, as phase 10's SVD++ figure
BATCH = 4096
ATOL, RTOL = 1e-5, 1e-4  # kernel vs plain: atomics sum in a varying order
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores, published
# phase 7: bench.py's bigTable workload (bench.py:826-912), the
# KDD-Cup-2011-scale synthetic; one table of NU users, NI items and the dummy
BIG_NU, BIG_NI, BIG_K = 1_000_000, 1_048_576, 64
BIG_EX = 1 << 21  # training examples per round
BIG_PROBE = 4096  # test rows: the first training rows (bench.py:870)
BIG_ROUNDS = 3
# rows of a block of the train buffer's file: a streamed chunk ends at a
# block's end, so blocks that divide phase 18's chunks (2^19, 2^20 rows)
# keep every chunk a whole number of batches (2^12, 2^20)
BIG_FILE_BATCH = 4096
BIG_CONF = {  # bench.py:859-868
    "base_score": "3", "learning_rate": "0.005", "wd_item": "0.004", "wd_user": "0.004",
    "num_item": str(BIG_NI), "num_user": str(BIG_NU), "num_factor": str(BIG_K),
}
DEMOS = {
    # name: (train fixture, test fixture)
    "basicMF": ("ml100k.base.feature.gz", "ml100k.test.feature.gz"),
    "binaryClassification": ("ml100k.base.bin.feature.gz", "ml100k.test.bin.feature.gz"),
    "neighborhoodModel": ("ml100k.base.nb.feature.gz", "ml100k.test.nb.feature.gz"),
}


def bigtable_arrays(nu=BIG_NU, ni=BIG_NI, ex=BIG_EX):
    """bench.py's bigTable data, numpy only (bench.py:836-858): ex
    (user, item) examples drawn from default_rng(7) with labels from a
    planted rank-8 structure, as the arrays of a 3-segment CSR dataset."""
    brng = np.random.default_rng(7)
    uu = brng.integers(0, nu, ex).astype(np.uint32)
    ii = brng.integers(0, ni, ex).astype(np.uint32)
    pu = brng.standard_normal((nu, 8), dtype=np.float32) * 0.25
    qi = brng.standard_normal((ni, 8), dtype=np.float32) * 0.25
    labels = 3.0 + np.einsum("ek,ek->e", pu[uu], qi[ii])
    row_ptr = np.zeros(3 * ex + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.tile(np.array([0, 1, 1], np.int32), ex))
    index = np.empty(2 * ex, np.uint32)
    index[0::2] = uu
    index[1::2] = ii
    return dict(labels=labels.astype(np.float32), row_ptr=row_ptr, index=index,
                value=np.ones(2 * ex, np.float32))


def write_bigtable(csr_dataset, write_csr_buffer, d, arrays, keys=BIG_CONF):
    """Write bigTable's train buffer (``arrays`` of bigtable_arrays) in file
    blocks of BIG_FILE_BATCH rows, its probe (the first BIG_PROBE rows) as
    the test buffer and its conf (``keys``) into directory ``d`` with a
    package's own CSRDataset and buffer writer; returns (conf path,
    dataset)."""
    ds = csr_dataset(**arrays)
    write_csr_buffer(str(d / "train.buffer"), ds, BIG_FILE_BATCH)
    write_csr_buffer(str(d / "test.buffer"), ds.slice_rows(0, BIG_PROBE))
    conf = d / "bigTable.conf"
    conf.write_text("".join(f"{k} = {v}\n" for k, v in keys.items())
                    + f'buffer_feature = "{d}/train.buffer"\n'
                    + f'test:buffer_feature = "{d}/test.buffer"\nsilent = 1\n')
    return conf, ds


# phase 11: bench.py's bigSvdpp workload (bench.py:919-986), SVD++ at the
# KDD-Cup-2011 table geometry: NU users, NI items, NF feedback ids and the
# dummy in one table; a round trains a 100,000-user shard (1,999,760 rows)
BIG_PLUS = dict(NU=1_000_000, NI=624_000, NF=624_000, KF=64, USERS=100_000, ROWS_MEAN=20)
BIG_PLUS_SMALL = dict(NU=2000, NI=3000, NF=3000, KF=16, USERS=1000, ROWS_MEAN=6)  # BENCH_SMALL
BIG_PLUS_PROBE = 2000  # probe: the first user blocks (bench.py:943)
BIG_PLUS_IMFB_USERS = 20_000  # run (d): the depth-2 transform of the first users
BIG_PLUS_RUNS = {  # tag: the buffer it trains, conf keys beside bigSvdpp.conf's, rounds
    "a": dict(buffer="train.buffer", keys=[], rounds=3),  # the user-carry epoch
    "b": dict(buffer="train.buffer", keys=["use_pallas=0"], rounds=3),  # its plain writer
    "c": dict(buffer="train.buffer", keys=["reg_method=4"], rounds=1),  # the entry-stream body
    "d": dict(buffer="imfb.buffer", keys=["extend_type=2"], rounds=2),  # big multi-IMFB
}


def big_plus_arrays(small=False):
    """bench.make_big_plus's data (bench.py:213-256), numpy only, with the
    same default_rng(0) draws in the same order: rows per user Poisson(20)
    clipped to [1, 64], 1-11 feedback ids per user, items uniform, labels
    from a planted rank-8 structure.  Returns (the arrays of a user-group
    dataset: its rows' CSR arrays and its blocks, dims as bench.py's)."""
    p = BIG_PLUS_SMALL if small else BIG_PLUS
    rng = np.random.default_rng(0)
    counts = rng.poisson(p["ROWS_MEAN"], p["USERS"]).clip(1, 64).astype(np.int64)
    fbcounts = rng.integers(1, 12, p["USERS"]).astype(np.int64)
    ex = int(counts.sum())
    uid = np.repeat(np.arange(p["USERS"], dtype=np.uint32), counts)
    items = rng.integers(0, p["NI"], ex).astype(np.uint32)
    pu = rng.standard_normal((p["USERS"], 8), dtype=np.float32) * 0.25
    qi = rng.standard_normal((p["NI"], 8), dtype=np.float32) * 0.25
    labels = 3.0 + np.einsum("ek,ek->e", pu[uid], qi[items])
    del pu, qi
    row_ptr = np.zeros(3 * ex + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.tile(np.array([0, 1, 1], np.int32), ex))
    index = np.empty(2 * ex, np.uint32)
    index[0::2] = uid
    index[1::2] = items
    ftot = int(fbcounts.sum())
    brp = np.zeros(p["USERS"] + 1, np.int32)
    brp[1:] = np.cumsum(counts)
    bfp = np.zeros(p["USERS"] + 1, np.int32)
    bfp[1:] = np.cumsum(fbcounts)
    arrays = dict(labels=labels.astype(np.float32), row_ptr=row_ptr, index=index,
                  value=np.ones(2 * ex, np.float32),
                  fb_index=rng.integers(0, p["NF"], ftot).astype(np.uint32),
                  fb_value=np.ones(ftot, np.float32), block_row_ptr=brp, block_fb_ptr=bfp,
                  extend_tag=np.zeros(p["USERS"], np.int8), extra_info=np.zeros(p["USERS"], np.int8))
    return arrays, dict(NU=p["NU"], NI=p["NI"], NF=p["NF"], KF=p["KF"], EX=ex)


def plus_dataset(csr, a, nblk=None):
    """A package's PlusDataset (``csr``: its data.csr module) of
    big_plus_arrays' arrays, or of its first ``nblk`` blocks (bench.py's
    slice_plus_blocks)."""
    rows = csr.CSRDataset(a["labels"], a["row_ptr"], a["index"], a["value"])
    if nblk is None:
        return csr.PlusDataset(rows, a["fb_index"], a["fb_value"], a["block_row_ptr"],
                               a["block_fb_ptr"], a["extend_tag"], a["extra_info"])
    r1, f1 = int(a["block_row_ptr"][nblk]), int(a["block_fb_ptr"][nblk])
    return csr.PlusDataset(rows.slice_rows(0, r1), a["fb_index"][:f1], a["fb_value"][:f1],
                           a["block_row_ptr"][: nblk + 1], a["block_fb_ptr"][: nblk + 1],
                           a["extend_tag"][:nblk], a["extra_info"][:nblk])


def write_big_plus(d, csr, write_plus_buffer, a, dims):
    """Write phase 11's buffers into directory ``d`` with a package's own
    classes and writer: the bigSvdpp train set, its first BIG_PLUS_PROBE
    user blocks as the probe, the depth-2 transform of its first
    BIG_PLUS_IMFB_USERS users (run (d)), and the conf (bench.py:929-941);
    returns the conf path."""
    full = plus_dataset(csr, a)
    write_plus_buffer(str(d / "train.buffer"), full)
    write_plus_buffer(str(d / "probe.buffer"), plus_dataset(csr, a, BIG_PLUS_PROBE))
    write_plus_buffer(str(d / "imfb.buffer"),
                      stack_depth2(plus_dataset(csr, a, BIG_PLUS_IMFB_USERS), csr))
    return big_plus_conf(d, dims, "probe.buffer")


# phases 12-14: pairwise ranking.  pairwiseRank is the reference's demo
# (demo/pairwiseRank: ML-100K, k=64, active_type=3, no_user_bias=1, 40
# rounds, P@20 as demo/pairwiseRank/eval.py computes it); bigRank is
# bench.py's KDD-Cup-geometry rank workload (bench.py:258-300, 988-1062).
RANK_ROUNDS = 40
RANK_USERS, RANK_K = 943, 20  # eval.py: hits of rank < 20 over 943 users x 20
RANK_P20_TOL = 0.003  # against golden/GOLDEN.json pairwiseRank precision_at_20
# phase 13's plain run: its rounds, held to the kernel run's P@20 at that round
RANK_PLAIN_ROUNDS = 10
# P@20 of the JAX package on the CPU, same data and conf, the per-round path
# (scripts/rank_jax_reference.py)
JAX_RANK_P20 = 0.165058
RANK_JAX_TOL = 0.001
PAIR_R = 8  # phase 12: rounds of per-round planes in one K2 call (a multi-path block)
# phase 12 over PAIR_R rounds: the kernel's distance from the f64 trajectory
# at most this many times the plain f32 version's (f32 rounding, summation
# order: both part from f64 by 1e-4 at 8 rounds of the pair demo)
PAIR_NOISE = 2.0
BIG_RANK = dict(NU=1_000_000, NI=624_000, NF=624_000, KF=64, USERS=25_000, NPOS=20, NNEG=60)
BIG_RANK_SMALL = dict(NU=2000, NI=3000, NF=3000, KF=16, USERS=500, NPOS=5, NNEG=15)  # BENCH_SMALL
BIG_RANK_PROBE = 2000  # the probe: a fresh seed-77 epoch's first user blocks (bench.py:1026-1036)
BIG_RANK_RUNS = {"a": dict(rounds=2, path="per-round"),  # update_all: the entry-stream epoch
                 "b": dict(rounds=8, path="multi")}  # update_rounds: one block, the carry body


def big_rank_arrays(small=False):
    """bench.make_big_rank's data (bench.py:264-300), numpy only, with the
    same default_rng(3) draws: USERS users of NPOS positives from the low
    half of the item space and NNEG negatives from the high half (labels 1
    / 0), their positives as feedback.  Returns the arrays of a user-group
    dataset (as big_plus_arrays) and the dims."""
    p = BIG_RANK_SMALL if small else BIG_RANK
    users, nr = p["USERS"], p["NPOS"] + p["NNEG"]
    rng = np.random.default_rng(3)
    ex = users * nr
    uid = np.repeat(np.arange(users, dtype=np.uint32), nr)
    pos = rng.integers(0, p["NI"] // 2, (users, p["NPOS"]))
    neg = rng.integers(p["NI"] // 2, p["NI"], (users, p["NNEG"]))
    items = np.concatenate([pos, neg], axis=1).reshape(-1).astype(np.uint32)
    labels = np.concatenate([np.ones((users, p["NPOS"]), np.float32),
                             np.zeros((users, p["NNEG"]), np.float32)], axis=1).reshape(-1)
    row_ptr = np.zeros(3 * ex + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.tile(np.array([0, 1, 1], np.int32), ex))
    index = np.empty(2 * ex, np.uint32)
    index[0::2] = uid
    index[1::2] = items
    arrays = dict(labels=labels, row_ptr=row_ptr, index=index, value=np.ones(2 * ex, np.float32),
                  fb_index=pos.reshape(-1).astype(np.uint32),
                  fb_value=np.ones(users * p["NPOS"], np.float32),
                  block_row_ptr=np.arange(users + 1, dtype=np.int32) * nr,
                  block_fb_ptr=np.arange(users + 1, dtype=np.int32) * p["NPOS"],
                  extend_tag=np.zeros(users, np.int8), extra_info=np.zeros(users, np.int8))
    return arrays, dict(NU=p["NU"], NI=p["NI"], NF=p["NF"], KF=p["KF"], EX=ex)


def big_rank_trainer(trainer_cls, type_cls, dims, extra=()):
    """A package's SVD++ trainer at bench.py's bigRank conf (bench.py:1000-1006)."""
    tr = trainer_cls(type_cls(format_type=1, active_type=3))
    for k, v in [("learning_rate", "0.005"), ("wd_user", "0.004"), ("wd_item", "0.004"),
                 ("num_user", dims["NU"]), ("num_item", dims["NI"]), ("num_global", "0"),
                 ("num_factor", dims["KF"]), ("active_type", "3"), ("num_ufeedback", dims["NF"]),
                 ("wd_ufeedback", "0.004"), ("no_user_bias", "1"),
                 ("rank_users_per_batch", "2048"), *extra]:
        tr.set_param(k, str(v))
    tr.init_model()
    tr.init_trainer()
    return tr


def big_rank_probe_set(csr, rank, registry, arrays):
    """(the probe, pairs a round): a fresh seed-77 pair epoch's first
    BIG_RANK_PROBE user blocks (bench.py:1026-1036), a package's
    PlusDataset, and the epoch's pair count."""
    probe = rank.PairSource(plus_dataset(csr, arrays), registry.IteratorConfig(),
                            seed=77).epoch_dataset()
    n = min(BIG_RANK_PROBE, probe.num_block)
    r1, f1 = int(probe.block_row_ptr[n]), int(probe.block_fb_ptr[n])
    head = csr.PlusDataset(probe.rows.slice_rows(0, r1), probe.fb_index[:f1],
                           probe.fb_value[:f1], probe.block_row_ptr[: n + 1],
                           probe.block_fb_ptr[: n + 1], probe.extend_tag[:n],
                           probe.extra_info[:n] if probe.extra_info is not None else None)
    return head, probe.rows.num_row


def big_rank_probe(tr, head):
    """(raw-margin order accuracy, mean raw margin): the share of the
    probe's [pos, neg] difference rows that score above 0, and the mean of
    those scores (it does not saturate at 1 as the accuracy does)."""
    margin = np.asarray(tr.predict_all(head), np.float64)
    return float(np.mean(margin > 0.0)), float(margin.mean())


def rank_p20(path) -> float:
    """P@20 of a pred.txt of rank positions (demo/pairwiseRank/eval.py)."""
    hits = sum(1 for line in pathlib.Path(path).read_text().split() if int(line) < RANK_K)
    return hits / float(RANK_USERS * RANK_K)


def write_rank(d, make_ugroup_main):
    """The pairwiseRank buffers in ``d`` with a package's make_ugroup_buffer
    (demo/pairwiseRank/run.sh); returns the CLI keys that point the demo's
    conf at them."""
    for split in ("base", "test"):
        for part in ("feature", "feedback"):
            unzip_fixture(f"ml100k.rank.{split}.{part}.gz", d / f"ua.{split}.rank.{part}")
    make_ugroup_main([str(d / "ua.base.rank.feature"), str(d / "train.buffer"), "-fd",
                      str(d / "ua.base.rank.feedback"), "-scale_score", "5"])
    make_ugroup_main([str(d / "ua.test.rank.feature"), str(d / "test.buffer"), "-fd",
                      str(d / "ua.test.rank.feedback"), "-scale_score", "1", "-max_block", "400"])
    return [f"buffer_feature={d}/train.buffer", f"test:buffer_feature={d}/test.buffer",
            "silent=1"]


# phases 8 and 9: the stacked multi-IMFB slice (bench.py:626-659): the
# implicitFeedback conf with extend_type=2, file order, rows_per_user=8
IMFB_ROUNDS = 8
IMFB_PLAIN_ROUNDS = 2  # phase 9's plain rounds, held to the kernel run at that round
# test RMSE after IMFB_ROUNDS rounds, the JAX package on the CPU, same data
# and conf (scripts/imfb_jax_reference.py --rows-per-user 8)
JAX_IMFB_RMSE = 0.952257
IMFB_JAX_TOL = 1e-4
IMFB_GOLDEN_TOL = 0.008  # bench.py:703, against golden/multi_imfb_stacked.rmse.tsv
IMFB_AB_TOL = 1e-5  # K3 against its plain version end to end


def stack_depth2(ds, csr):
    """The depth-2 transform of the stacked golden (bench.py:626-654), built
    with ``csr``'s PlusBlock / PlusDataset: per block of two rows or more,
    START (its feedback, the first half of its rows) keeps the user context
    open, a DEFAULT sub-block (half its feedback, the rest) trains under
    both, END (the START list, no rows) pops; smaller blocks stay as they
    are."""
    blocks = []
    for blk in ds.blocks():
        n = blk.data.num_row
        if n >= 2:
            h = n // 2
            half = max(1, len(blk.fb_index) // 2)
            blocks += [
                csr.PlusBlock(blk.fb_index, blk.fb_value, blk.data.slice_rows(0, h),
                              extend_tag=csr.TAG_START),
                csr.PlusBlock(blk.fb_index[:half], blk.fb_value[:half],
                              blk.data.slice_rows(h, n - h)),
                csr.PlusBlock(blk.fb_index, blk.fb_value, blk.data.slice_rows(n, 0),
                              extend_tag=csr.TAG_END),
            ]
        else:
            blocks.append(blk)
    return csr.PlusDataset.from_blocks(blocks)


def fixture_text(name):
    with gzip.open(ROOT / "tests" / "fixtures" / name, "rt") as f:
        return f.read()


def write_imfb(d, load_plus_text, csr, write_plus_buffer, make_ugroup_main):
    """Write the stacked slice's buffers into directory ``d`` with a
    package's own parser, classes and writers: the depth-2 transform of the
    implicitFeedback train set as train.buffer, the stock test set as
    test.buffer (make_ugroup_buffer -fd, as the reference's infer reads
    it); returns the train dataset."""
    ds = stack_depth2(load_plus_text("x", "y", text=fixture_text("ml100k.base.group.feature.gz"),
                                     feedback_text=fixture_text("ml100k.base.feedback.gz")), csr)
    write_plus_buffer(str(d / "train.buffer"), ds)
    for src, dst in (("ml100k.test.ug.feature.gz", "test.feature"),
                     ("ml100k.test.feedback.gz", "test.feedback")):
        (d / dst).write_text(fixture_text(src))
    make_ugroup_main([str(d / "test.feature"), str(d / "test.buffer"), "-fd", str(d / "test.feedback")])
    return ds


def write_implicit(d, make_ugroup_main):
    """Write the implicitFeedback demo's train.buffer and test.buffer into
    directory ``d`` from the ML-100K fixtures with a package's
    make_ugroup_buffer -fd (demo/implicitFeedback/run.sh)."""
    for split, (fx, fb_fx) in (("train", ("ml100k.base.group.feature.gz", "ml100k.base.feedback.gz")),
                               ("test", ("ml100k.test.ug.feature.gz", "ml100k.test.feedback.gz"))):
        unzip_fixture(fx, d / f"{split}.feature")
        unzip_fixture(fb_fx, d / f"{split}.feedback")
        make_ugroup_main([str(d / f"{split}.feature"), str(d / f"{split}.buffer"),
                          "-fd", str(d / f"{split}.feedback")])


# phases 15 and 16: the shared feedback space and the bilinear solver.  Phase
# 15's data is the implicitFeedback train and test sets with user-space
# feedback in place of their item feedback, the social "follow" feedback that
# common_feedback_space=1 exists for: user u follows n_u = min(its train
# feedback count, FOLLOW_MAX) distinct users drawn from [0, 943) by
# default_rng(FOLLOW_SEED) in user order, each entry of value 1/sqrt(n_u).
FOLLOW_USERS = 943
FOLLOW_MAX = 100
FOLLOW_SEED = 7
FOLLOW_KEYS = [f"num_ufeedback={FOLLOW_USERS}", "common_feedback_space=1"]
BAND_KEYS = ["sort_blocks=1", "rows_per_user=8"]  # the implicitFeedback band setting
REFRESH_RUNS = {  # tag: the buffer it trains, conf keys beside implicitFeedback.conf's, rounds
    "a": dict(buffer="train.buffer", keys=[*BAND_KEYS, *FOLLOW_KEYS], rounds=5),  # SVD++
    # the depth-2 stacked transform, as phase 9 trains it (file order)
    "b": dict(buffer="imfb.buffer", keys=["extend_type=2", "rows_per_user=8", *FOLLOW_KEYS],
              rounds=2),
}
# phase 16: bilinear (extend_type=15).  (a) no user properties, which is plain
# SVD++ (COMPONENTS.md #10); (b) the integrated neighbourhood model: every
# feedback item is a user property, W_bi[item, item']; (c) the follow data on
# the refresh route; (d) bigSvdpp's geometry, the first BIG_BI_USERS users
# with BIG_BI_PROPS property ids from [0, BIG_BI_NBF) each (default_rng(1))
# before their feedback.  The bilinear pack keeps file order (it takes no
# sort_blocks, as the JAX solver's), so (a)'s SVD++ run is at sort_blocks=0.
BIG_BI_USERS = BIG_PLUS_IMFB_USERS
BIG_BI_NBF = 64
BIG_BI_PROPS = 2
BI_RUNS = {  # tag: its data directory, conf keys beside its conf's, rounds
    "a": dict(data="implicitFeedback", keys=[*BAND_KEYS, "extend_type=15", "num_bi_feedback=0"],
              rounds=3),  # of the golden's 8, each against the plain SVD++ rounds too
    "b": dict(data="implicitFeedback", keys=[*BAND_KEYS, "extend_type=15",
                                             "num_bi_feedback=1682", "start_ufeedback=0"], rounds=2),
    "c": dict(data="follow", keys=[*BAND_KEYS, *FOLLOW_KEYS, "extend_type=15",
                                   f"num_bi_feedback={FOLLOW_USERS}", "start_ufeedback=0"], rounds=3),
    # the property ids leave the factor sum (start_ufeedback): with them in
    # it, 64 ids shared by every user of a 4096-user step diverge (NaN by
    # round 2 in both packages)
    "d": dict(data="bigBilinear", keys=["extend_type=15", f"num_bi_feedback={BIG_BI_NBF}",
                                        f"start_ufeedback={BIG_BI_NBF}"], rounds=2),
}


def block_user(blk) -> int:
    """The user of a user-group block: its first row's user entry (-1 for a
    block without rows)."""
    d = blk.data
    return int(d.index[d.row_ptr[1]]) if d.num_row else -1


def follow_lists(train):
    """The followed users of each user (see FOLLOW_SEED)."""
    counts = np.zeros(FOLLOW_USERS, np.int64)
    for blk in train.blocks():
        if block_user(blk) >= 0:
            counts[block_user(blk)] += blk.num_ufeedback
    rng = np.random.default_rng(FOLLOW_SEED)
    return [rng.choice(FOLLOW_USERS, size=min(int(c), FOLLOW_MAX), replace=False) for c in counts]


def with_follow(ds, csr, lists):
    """``ds`` with each block's feedback replaced by its user's follow list."""
    blocks = []
    for blk in ds.blocks():
        ids = lists[block_user(blk)] if block_user(blk) >= 0 else np.zeros(0, np.int64)
        val = np.full(len(ids), 1.0 / np.sqrt(max(len(ids), 1)), np.float32)
        blocks.append(csr.PlusBlock(ids.astype(np.uint32), val, blk.data, extend_tag=blk.extend_tag))
    return csr.PlusDataset.from_blocks(blocks)


def write_follow(d, load_plus_text, csr, write_plus_buffer):
    """Write phase 15's buffers into directory ``d`` with a package's own
    parser, classes and writer: the follow train set (train.buffer), its
    depth-2 stacked transform (imfb.buffer, as phase 9 makes it) and the
    follow test set (test.buffer)."""
    def load(feature, feedback):
        return load_plus_text("x", "y", text=fixture_text(feature), feedback_text=fixture_text(feedback))

    train = load("ml100k.base.group.feature.gz", "ml100k.base.feedback.gz")
    lists = follow_lists(train)
    train = with_follow(train, csr, lists)
    write_plus_buffer(str(d / "train.buffer"), train)
    write_plus_buffer(str(d / "imfb.buffer"), stack_depth2(train, csr))
    write_plus_buffer(str(d / "test.buffer"),
                      with_follow(load("ml100k.test.ug.feature.gz", "ml100k.test.feedback.gz"),
                                  csr, lists))


def big_bi_arrays(a):
    """big_plus_arrays' arrays cut to the first BIG_BI_USERS blocks, each
    with BIG_BI_PROPS distinct property ids from [0, BIG_BI_NBF)
    (default_rng(1)), of value 1, before its feedback."""
    n = BIG_BI_USERS
    rng = np.random.default_rng(1)
    first = rng.integers(0, BIG_BI_NBF, n)
    props = np.stack([first, (first + rng.integers(1, BIG_BI_NBF, n)) % BIG_BI_NBF], axis=1)
    old_ptr = a["block_fb_ptr"][: n + 1].astype(np.int64)
    new_ptr = old_ptr + BIG_BI_PROPS * np.arange(n + 1)
    fb_index = np.empty(int(new_ptr[-1]), np.uint32)
    old = np.arange(int(old_ptr[-1]))
    blk = np.repeat(np.arange(n), np.diff(old_ptr))
    fb_index[old + BIG_BI_PROPS * (blk + 1)] = a["fb_index"][: old_ptr[-1]]
    for j in range(BIG_BI_PROPS):
        fb_index[new_ptr[:-1] + j] = props[:, j]
    return dict(a, fb_index=fb_index, fb_value=np.ones(len(fb_index), np.float32),
                block_fb_ptr=new_ptr.astype(np.int32))


def big_plus_conf(d, dims, probe):
    """bigSvdpp's conf (bench.py:929-941) in directory ``d``, tested on the
    ``probe`` buffer there; returns its path."""
    conf = d / "bigSvdpp.conf"
    conf.write_text(
        "format_type = 1\nbase_score = 3\nlearning_rate = 0.005\nwd_item = 0.004\n"
        "wd_user = 0.004\nwd_ufeedback = 0.004\n"
        f"num_user = {dims['NU']}\nnum_item = {dims['NI']}\nnum_ufeedback = {dims['NF']}\n"
        f"num_global = 0\nnum_factor = {dims['KF']}\n"
        "sort_blocks = 1\nrows_per_user = 4\nusers_per_batch = 4096\n"
        f'test:buffer_feature = "{d}/{probe}"\nsilent = 1\n')
    return conf


def write_big_bilinear(d, csr, write_plus_buffer, a, dims):
    """Write phase 16 (d)'s buffers into directory ``d`` with a package's own
    classes and writer: big_bi_arrays' train set and its first
    BIG_PLUS_PROBE user blocks as the probe, with bigSvdpp's conf; returns
    the conf path."""
    b = big_bi_arrays(a)
    write_plus_buffer(str(d / "train.buffer"), plus_dataset(csr, b, BIG_BI_USERS))
    write_plus_buffer(str(d / "probe.buffer"), plus_dataset(csr, b, BIG_PLUS_PROBE))
    return big_plus_conf(d, dims, "probe.buffer")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        return "nvidia-smi not found"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else f"nvidia-smi failed: {out.stderr.strip()}"


# ---- phase 2: kernel vs plain ------------------------------------------------
def make_inputs(active_type, NG, SG, seed, exact_global=False, N=2626, n_user=943,
                k=64, B=BATCH, n_rows=90570, R=2):
    """numpy arrays at ML-100K shapes: unified table (users, items, dummy),
    n_rows examples packed into ceil(n_rows/B) batches with weight-0
    padding at the dummy row, as pack_csr writes them.  The undamped
    (exact_global) update is stable only while lr * sum(v^2) per slot
    stays below 2, which dense global features break at B=4096 (the
    reason the batched path damps it): its inputs get values 10x smaller."""
    rng = np.random.RandomState(seed)
    T = -(-n_rows // B)
    w = rng.normal(0, 0.01, (N, k)).astype(np.float32)
    w[-1] = 0.0
    g = rng.normal(0, 0.01, (NG,)).astype(np.float32) if NG > 1 else np.zeros(1, np.float32)
    g[-1] = 0.0
    wd_u = np.zeros(N, np.float32)
    wd_i = np.zeros(N, np.float32)
    wd_u[:n_user] = 0.004
    wd_i[n_user:N - 1] = 0.004
    wd_g = np.full(NG, 0.001, np.float32)
    wd_g[-1] = 0.0
    real = (np.arange(T * B) < n_rows).reshape(T, B)
    ratings = rng.randint(1, 6, (T, B)).astype(np.float32)
    label = ratings if active_type == 0 else (ratings >= 4).astype(np.float32)
    u = np.where(real, rng.randint(0, n_user, (T, B)), N - 1)
    i = np.where(real, n_user + rng.randint(0, N - 1 - n_user, (T, B)), N - 1)
    if NG > 1:
        g_idx = rng.randint(0, NG - 1, (T, B, SG))
        g_val = rng.uniform(0.1, 1.0, (T, B, SG)).astype(np.float32)
        if exact_global:
            g_val *= 0.1
        pad = (rng.rand(T, B, SG) < 0.3) | ~real[..., None]
        g_idx[pad] = NG - 1
        g_val[pad] = 0.0
    else:
        g_idx = np.zeros((T, B, 1), np.int32)
        g_val = np.zeros((T, B, 1), np.float32)
    state = dict(w=w, b=np.zeros(N, np.float32), g=g, step=np.int32(0),
                 ref_ui=np.zeros(N, np.int32), ref_g=np.zeros(NG, np.int32))
    consts = dict(wd_u_row=wd_u, wd_i_row=wd_i, wd_g_row=wd_g,
                  wd_user_bias=np.float32(0.0), wd_item_bias=np.float32(0.0))
    stacked = dict(
        label=np.where(real, label, 0.0).astype(np.float32),
        weight=real.astype(np.float32),
        g_idx=g_idx.astype(np.int32), g_val=g_val,
        u_idx=u[..., None].astype(np.int32), u_val=real[..., None].astype(np.float32),
        i_idx=i[..., None].astype(np.int32), i_val=real[..., None].astype(np.float32),
    )
    lrs = np.array([0.005] * R, np.float32)
    return state, consts, stacked, lrs


def bound(bytes_moved, flops, steps):
    """(least ms per step, what bounds it) of a call of ``steps`` steps."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3 / steps, ("bytes" if t_bytes >= t_ops else "operations")


def touched_rows(*idx_planes):
    """Distinct table rows each step's live entries touch (entries of
    padding are -1), summed over steps."""
    total = 0
    for t in range(idx_planes[0].shape[0]):
        rows = np.unique(np.concatenate([p[t].reshape(-1) for p in idx_planes]))
        total += int((rows >= 0).sum())
    return total


def embed_bound(arrays):
    """K1's bound for one R-round call of make_inputs' arrays: each input
    read once and each output written once; per live example 8k + 6 SG
    operations (two scaled rows, the dot, two coef*p products and their
    sums, the global terms), per touched row 2k (add, decay)."""
    st, _, stacked, lrs = arrays
    R = len(lrs)
    T, B = stacked["label"].shape
    N, k = st["w"].shape
    NG, SG = st["g"].shape[0], stacked["g_idx"].shape[-1]
    live = stacked["weight"] > 0
    rows = touched_rows(np.where(live[..., None], stacked["u_idx"], -1),
                        np.where(live[..., None], stacked["i_idx"], -1))
    flops = R * (int(live.sum()) * (8 * k + 6 * SG) + rows * 2 * k)
    moved = 4 * (2 * (N * (k + 1) + NG) + T * B * (6 + 2 * SG) + 2 * N + NG + R)
    return bound(moved, flops, R * T)


def phase_kernel(torch, dev, card, failures):
    from svdfeature_tpu_torch import convert
    from svdfeature_tpu_torch.ops.cuda_embed import launches_per_call, train_rounds_kernel
    from svdfeature_tpu_torch.ops.embed import HyperParams
    from svdfeature_tpu_torch.ops.embed import train_rounds as train_rounds_reference

    def device_inputs(arrays):
        st, cs, stacked, lrs = arrays
        return [convert.state_from_numpy(**st, device=dev),
                convert.stacked_from_numpy(stacked, dev),
                torch.tensor(lrs, device=dev),
                convert.consts_from_numpy(**cs, device=dev)]

    def compare(got, want):
        errs, ok = {}, True
        for name in ("w", "b", "g"):
            a, b = getattr(got, name), getattr(want, name)
            errs[name] = float((a - b).abs().max())
            ok &= bool(torch.isfinite(a).all()) and bool(
                ((a - b).abs() <= ATOL + RTOL * b.abs()).all())
        return errs, ok and int(got.step) == int(want.step)

    max_err = 0.0
    timing = {}
    cases = [(shape, NG, SG, at, exact, 2, 1)
             for shape, NG, SG in (("basicMF", 1, 1), ("neighborhoodModel", 7, 3))
             for at in (0, 2) for exact in (False, True)]
    # R=3, called twice on the same tensors: the second call takes the kept plan
    cases += [("basicMF", 1, 1, 0, False, 3, 2), ("neighborhoodModel", 7, 3, 0, False, 3, 2)]
    for shape, NG, SG, at, exact, R, calls in cases:
        arrays = make_inputs(at, NG, SG, seed=10 + at, exact_global=exact, R=R)
        hp = HyperParams(active_type=at, base_score=3.0 if at == 0 else 0.0, exact_global=exact)
        held = device_inputs(arrays)
        want = device_inputs(arrays)
        for call in range(calls):
            before = train_rounds_kernel.launches
            held[0] = train_rounds_kernel(*held, hp)
            torch.cuda.synchronize()
            launched = train_rounds_kernel.launches - before
            want[0] = train_rounds_reference(*want, hp)
            errs, ok = compare(held[0], want[0])
            ok &= launched == launches_per_call(R) == 1
            max_err = max(max_err, *errs.values())
            if not ok:
                failures.append(f"kernel vs plain {shape} at={at} exact_global={int(exact)} "
                                f"R={R} call {call + 1}")
            print(f"phase 2 {'ok' if ok else 'FAIL'}: {shape} active_type={at} "
                  f"exact_global={int(exact)} R={R} call {call + 1} of {calls} "
                  f"max|dw|={errs['w']:.3e} max|db|={errs['b']:.3e} max|dg|={errs['g']:.3e} "
                  f"(atol {ATOL:g} + rtol {RTOL:g}) launches {launched} (grid "
                  f"{train_rounds_kernel.grid} blocks)", flush=True)
    for shape, NG, SG in (("basicMF", 1, 1), ("neighborhoodModel", 7, 3)):
        # times: CUDA events around whole R=2 calls, in turns, each path on
        # its own device tensors call after call, as the trainer calls it
        arrays = make_inputs(0, NG, SG, seed=10)
        hp = HyperParams(base_score=3.0)
        T = arrays[2]["label"].shape[0]
        R = arrays[3].shape[0]
        fns = {"plain": train_rounds_reference, "kernel": train_rounds_kernel}
        samples = {"plain": [], "kernel": []}
        held = {name: device_inputs(arrays) for name in fns}
        for name in ("plain", "kernel", "kernel", "plain") * 2:
            inputs = held[name]
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            inputs[0] = fns[name](*inputs, hp)
            end.record()
            torch.cuda.synchronize()
            samples[name].append(start.elapsed_time(end) / (R * T))
        samples = {name: v[1:] for name, v in samples.items()}  # the first call warms up
        timing[shape] = {n: float(np.median(v)) for n, v in samples.items()}
        timing[shape]["bound"], timing[shape]["bound_by"] = embed_bound(arrays)
        print(f"phase 2 time: {shape} ms per step (B={BATCH}, median of 8 R={R} calls): "
              f"kernel {timing[shape]['kernel']:.4f} plain {timing[shape]['plain']:.4f} "
              f"bound {timing[shape]['bound']:.6f} ({timing[shape]['bound_by']}) on {card}", flush=True)
        for name in ("kernel", "plain"):
            inputs = held[name]
            print(f"phase 2 profile: {shape} path={name} "
                  f"{device_profile(torch, lambda: fns[name](*inputs, hp), R * T)}",
                  flush=True)
    return max_err, timing


def _short(kernel_name: str) -> str:
    """A demangled kernel name without its namespace prefix, template
    arguments and parameter list."""
    name = kernel_name.replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", name, maxsplit=1)[0].strip().split(" ")[-1][-48:]


def device_profile(torch, run, steps, top=4):
    """Where one R-round run, ``run()``, spends its time on the card
    (torch.profiler): device busy time per step, its share of the run's
    elapsed time, and the device time of each of the run's ``top`` busiest
    kernels, and the host seconds the session took.  The session records
    the card's activity only: recording every host op as well, and
    building the profiler's event tree from them, took far longer than the
    runs themselves on runs of many small ops.  A plain PyTorch op opens
    the session, before the clock starts (a session that opens with a
    ctypes launch records no device events); a session that records none
    all the same is run once more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for _ in range(2):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
        elapsed_us = start.elapsed_time(end) * 1e3
        per_kernel = {}  # from the raw records: prof.events() would build the event tree
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                n, us = per_kernel.get(e.name(), (0, 0.0))
                per_kernel[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
        if per_kernel:
            break
    busy = sum(us for _, us in per_kernel.values())
    session = f"the session {time.perf_counter() - t0:.1f} s on the host"
    if not per_kernel:
        return f"device time not measured (the profiler recorded no device events; {session})"
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:top]
    tops = "; ".join(f"{_short(name)} {n} x {us / n:.2f} us" for name, (n, us) in top)
    return (f"device busy {busy / steps:.2f} us/step of {elapsed_us / steps:.2f} us/step "
            f"elapsed under the profiler (busy share {busy / elapsed_us:.3f}); {tops}; "
            f"{session}; on {card_line()}")


# ---- phases 3, 5 and 9: the slices ---------------------------------------------
# implicitFeedback rounds through K2 and stacked rounds through K3 are bound
# by the card, not the host: the share of a window of rounds, each followed
# by a synchronise as the train task makes it, that the kernel is running,
# by the kernel's own clock.  K2 measures 0.87-0.95 (PERF.md), the
# host-launched form it replaced 0.37-0.64 under the profiler.  The faster
# the kernel and the slower the machine's host, the lower the share, so the
# gate leaves room.  K1's rounds are 23 steps: the host's 100-190 us before
# a launch weigh more there, and its share is printed without a gate.
MIN_BUSY_SHARE = 0.7
STEADY_ROUNDS = 10


def steady_busy_share(torch, task, wrapper, trace_slots, busy_slots, steps_per_round):
    """(busy share, busy us/step, elapsed us/step) of STEADY_ROUNDS more
    rounds of ``task``'s trainer after a warm-up round: busy from the
    kernel's own clock (the nanoseconds its first block spends in its
    phases and at its barriers, the first ``busy_slots`` of the
    ``trace_slots`` of ``wrapper.trace``), elapsed from CUDA events around
    the window."""
    tr = task.trainer
    trace = torch.zeros(trace_slots, dtype=torch.int64, device=tr.state.w.device)
    wrapper.trace = trace
    try:
        tr.update_all(task.dataset)
        tr.synchronize()
        trace.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(STEADY_ROUNDS):
            tr.update_all(task.dataset)
            tr.synchronize()
        end.record()
        torch.cuda.synchronize()
    finally:
        wrapper.trace = None
    steps = STEADY_ROUNDS * steps_per_round
    busy = float(trace[:busy_slots].sum()) / 1e3 / steps
    elapsed = start.elapsed_time(end) * 1e3 / steps
    return busy / elapsed, busy, elapsed


def report_share(phase, name, kid, share, busy, elapsed, card, failures, gate=True):
    ok = share >= MIN_BUSY_SHARE or not gate
    if not ok:
        failures.append(f"{name} rounds: {kid} busy share below {MIN_BUSY_SHARE}")
    want = f"at least {MIN_BUSY_SHARE} wanted" if gate else "no gate"
    print(f"phase {phase} {'ok' if ok else 'FAIL'}: {name} {kid} rounds: {STEADY_ROUNDS} more "
          f"rounds, a synchronise after each: the kernel's own clock counts {busy:.2f} us/step of "
          f"{elapsed:.2f} us/step elapsed (busy share {share:.3f}, {want}) on {card}", flush=True)


def kernel_wrappers():
    from svdfeature_tpu_torch.ops.cuda_embed import train_rounds_kernel
    from svdfeature_tpu_torch.ops.cuda_imfb import train_rounds_imfb_kernel
    from svdfeature_tpu_torch.ops.cuda_scatter import row_reader, row_writer
    from svdfeature_tpu_torch.ops.cuda_svdpp import train_rounds_svdpp_kernel
    from svdfeature_tpu_torch.ops.cuda_sweep import sweep_update

    return {"K1": train_rounds_kernel, "K2": train_rounds_svdpp_kernel,
            "K3": train_rounds_imfb_kernel, "K4": sweep_update, "K5": row_writer,
            "K6": row_reader}


def run_demo(name, d, tag, extra, rounds=ROUNDS):
    """Train and evaluate one demo through SVDTrainTask / SVDInferTask,
    ``rounds`` rounds, with every kernel's launch count set to 0 just
    before training and read just after.  ``d`` holds its train.buffer
    and test.buffer; the checkpoints stay in ``d``/models_``tag``."""
    from svdfeature_tpu_torch.infer.task import SVDInferTask
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    golden = json.loads((ROOT / "golden" / "GOLDEN.json").read_text())[name]
    conf = str(ROOT / "demo" / name / f"{name}.conf")
    common = [f"buffer_feature={d}/train.buffer", f"test:buffer_feature={d}/test.buffer",
              f"model_out_folder={d}/models_{tag}", "device=cuda", "silent=1"]
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    task = SVDTrainTask()
    task.run(conf, common + [f"num_round={rounds}", *extra])
    launches = {kid: fn.launches for kid, fn in wrappers.items()}
    rows = task.dataset_rows()
    rmse = demo_rmse_at(name, d, tag, rounds)
    secs = task.round_seconds
    eps_steady = rows * (len(secs) - 1) / sum(secs[1:])
    eps_all = rows * len(secs) / sum(secs)
    band_ok = math.isfinite(rmse) and abs(rmse - golden["final_rmse"]) < golden["rmse_band"]
    seed10 = golden["rmse_band_provenance"]["seeds"]["10"]
    return dict(rmse=rmse, band_ok=band_ok, launches=launches, rows=rows, task=task,
                eps_steady=eps_steady, eps_all=eps_all, golden=golden["final_rmse"],
                band=golden["rmse_band"], d_seed10=rmse - seed10)


def demo_rmse_at(name, d, tag, rnd):
    """The test RMSE of run ``tag``'s kept checkpoint of round ``rnd``
    (run_demo), through SVDInferTask."""
    from svdfeature_tpu_torch.infer.task import SVDInferTask

    log = d / f"rmse_{tag}_{rnd}.tsv"
    SVDInferTask().run(str(ROOT / "demo" / name / f"{name}.conf"), [
        f"buffer_feature={d}/train.buffer", f"test:buffer_feature={d}/test.buffer",
        f"model_out_folder={d}/models_{tag}",
        "device=cuda", "silent=1", f"start={rnd}", f"end={rnd + 1}", f"log_eval={log}"])
    return float(log.read_text().split()[-1])


def report_demo(phase, name, path, r, kid, want, how, card, failures):
    ok = r["band_ok"] and r["launches"][kid] == want
    if not ok:
        failures.append(f"slice {name} ({path})")
    print(f"phase {phase} {'ok' if ok else 'FAIL'}: {name} path={path} test RMSE {r['rmse']:.6f} "
          f"(golden {r['golden']} band {r['band']}; minus JAX seed-10 {r['d_seed10']:+.6f}) "
          f"{kid} launches {r['launches'][kid]} (want {want} = {how}) "
          f"training {r['eps_steady']:,.0f} examples/s rounds 2-{ROUNDS} "
          f"({r['eps_all']:,.0f} over all {ROUNDS}, first includes packing) "
          f"on {card}", flush=True)


def unzip_fixture(name, dst):
    with gzip.open(ROOT / "tests" / "fixtures" / name, "rb") as src, open(dst, "wb") as out:
        shutil.copyfileobj(src, out)


def phase_slice(work, card, failures):
    import torch

    from svdfeature_tpu_torch.cli import make_feature_buffer
    from svdfeature_tpu_torch.ops.cuda_embed import launches_per_call, train_rounds_kernel

    total = 0
    for name, (train_fx, test_fx) in DEMOS.items():
        d = work / name
        d.mkdir(parents=True)
        for fx, split in ((train_fx, "train"), (test_fx, "test")):
            unzip_fixture(fx, d / f"{split}.feature")
            make_feature_buffer.main([str(d / f"{split}.feature"), str(d / f"{split}.buffer")])
        runs = [("kernel", [])] + ([("plain", ["use_pallas=0"])] if name == "basicMF" else [])
        for path, extra in runs:
            r = run_demo(name, d, path, [f"batch_size={BATCH}", *extra])
            T = -(-r["rows"] // BATCH)
            want = ROUNDS * launches_per_call(1) if path == "kernel" else 0
            total += r["launches"]["K1"]
            report_demo(3, name, path, r, "K1", want,
                        f"{ROUNDS} rounds, one cooperative launch each; T={T}", card, failures)
            if path == "kernel" and name == "basicMF":
                eps = r["eps_steady"]  # what phase 18's streamed run is set beside
                rmse = r["rmse"]  # what phase 19's mesh run is held to
                share = steady_busy_share(torch, r["task"], train_rounds_kernel, 4, 4, T)
                report_share(3, name, "K1", *share, card, failures, gate=False)
    return total, eps, rmse


def phase_svdpp_slice(work, card, failures):
    """implicitFeedback (demo/implicitFeedback/run.sh) at the RMSE band's
    setting, sort_blocks=1 rows_per_user=8 (golden/derive_rmse_bands.py).
    Returns the K2 launches and the kernel run's examples/s."""
    from svdfeature_tpu_torch.cli import make_ugroup_buffer
    from svdfeature_tpu_torch.ops.cuda_svdpp import launches_per_call, train_rounds_svdpp_kernel

    name = "implicitFeedback"
    d = work / name
    d.mkdir(parents=True)
    write_implicit(d, make_ugroup_buffer.main)
    import torch

    launches = 0
    for path, extra, rounds in (("kernel", [], ROUNDS),
                                ("plain", ["use_pallas=0"], SLICE_PLAIN_ROUNDS)):
        r = run_demo(name, d, path, ["sort_blocks=1", "rows_per_user=8", *extra], rounds)
        task = r["task"]
        cid = task.trainer._pack_plus(task.dataset).chunk_id
        want = ROUNDS * launches_per_call(cid, 1) if path == "kernel" else 0
        starts = int(np.count_nonzero(np.concatenate([[True], cid[1:] != cid[:-1]])))
        if path == "kernel":
            launches, eps = r["launches"]["K2"], r["eps_steady"]
            report_demo(5, name, path, r, "K2", want,
                        f"{ROUNDS} rounds, one cooperative launch each; T={len(cid)}, "
                        f"chunk starts={starts}", card, failures)
        else:
            # the plain rounds held to the kernel run's checkpoint of the same round
            ref = demo_rmse_at(name, d, "kernel", rounds)
            ok = (r["launches"] == {kid: 0 for kid in r["launches"]} and math.isfinite(r["rmse"])
                  and abs(r["rmse"] - ref) < SLICE_PLAIN_TOL)
            if not ok:
                failures.append(f"slice {name} ({path})")
            print(f"phase 5 {'ok' if ok else 'FAIL'}: {name} path=plain test RMSE "
                  f"{r['rmse']:.6f} after {rounds} rounds (minus the kernel run's at that round "
                  f"{r['rmse'] - ref:+.6f}, tol {SLICE_PLAIN_TOL:g}) launches {r['launches']} "
                  f"(want all 0; T={len(cid)}, chunk starts={starts}) training "
                  f"{r['eps_steady']:,.0f} examples/s rounds 2-{rounds} on {card}", flush=True)
        # where a round's time goes: one more round under the profiler, after
        # the counts are read and the checkpoints written
        line = device_profile(torch, lambda: task.trainer.update_all(task.dataset), len(cid))
        print(f"phase 5 profile: {name} path={path} one more round: {line}", flush=True)
        if path == "kernel":
            share = steady_busy_share(torch, task, train_rounds_svdpp_kernel, 9, 8, len(cid))
            report_share(5, name, "K2", *share, card, failures)
    return launches, eps


# ---- phase 4: the SVD++ kernel vs plain ---------------------------------------
@functools.lru_cache(maxsize=None)
def ugroup_packed(sort_blocks, M, users=128):
    """The ML-100K implicitFeedback training set packed by the port's
    pack_plus: ``users`` users per step, M rows of each."""
    from svdfeature_tpu_torch.data.batching_plus import pack_plus
    from svdfeature_tpu_torch.data.text import load_plus_text

    def text(name):
        with gzip.open(ROOT / "tests" / "fixtures" / name, "rt") as f:
            return f.read()

    ds = load_plus_text("x", "y", text=text("ml100k.base.group.feature.gz"),
                        feedback_text=text("ml100k.base.feedback.gz"))
    return pack_plus(ds, users, 4307, 0, 1682, 2625, 0, num_user=943, num_item=1682,
                     num_ufeedback=1682, sort_blocks=sort_blocks, rows_per_user=M)


def svdpp_inputs(sort_blocks, M, active_type, pairwise, seed, users=128, chunks=None):
    """numpy inputs at the implicitFeedback layout (feedback rows [0, 1682),
    users [1682, 2625), items [2625, 4307), dummy 4307; k=64).  active_type
    2 takes the ratings >= 4 as its 0/1 labels; ``pairwise`` adds a second,
    random item entry of value -1 to every live slot (the item-width-2
    difference rows of pairwise ranking) with label 1.  ``chunks`` keeps
    the steps and pools of the first ``chunks`` user chunks only (the
    one-row layouts run 400-700 steps a chunk)."""
    packed = ugroup_packed(sort_blocks, M, users)
    rng = np.random.RandomState(seed)
    N, k = 4308, 64
    w = rng.normal(0, 0.01, (N, k)).astype(np.float32)
    b = rng.normal(0, 0.01, (N,)).astype(np.float32)
    w[-1] = 0.0
    b[-1] = 0.0
    wd_u = np.zeros(N, np.float32)
    wd_i = np.zeros(N, np.float32)
    wd_u[1682:2625] = 0.004
    wd_i[2625:N - 1] = 0.004
    stacked = packed.device_arrays()
    chunk_id = stacked.pop("chunk_id")
    fb, overlap = packed.fb_arrays(), packed.fb_overlap
    if chunks is not None and chunk_id.max() >= chunks:
        T = int(np.argmax(chunk_id >= chunks))
        assert (chunk_id[:T] < chunks).all() and T > 0
        chunk_id = chunk_id[:T]
        stacked = {key: v[:T] for key, v in stacked.items()}
        fb = {key: v[:chunks] for key, v in fb.items()}
        overlap = overlap[:chunks]
    live = stacked["weight"] > 0
    if active_type != 0:
        stacked["label"] = (live & (stacked["label"] >= 4)).astype(np.float32)
    if pairwise:
        neg = np.where(live, 2625 + rng.randint(0, 1682, live.shape), N - 1)
        stacked["i_idx"] = np.stack([stacked["i_idx"][..., 0], neg], -1).astype(np.int32)
        stacked["i_val"] = np.stack([stacked["i_val"][..., 0], -live.astype(np.float32)], -1)
        stacked["label"] = live.astype(np.float32)
    return dict(
        st=dict(w=w, b=b, g=np.zeros(1, np.float32), step=np.int32(0),
                ref_ui=np.zeros(N, np.int32), ref_g=np.zeros(1, np.int32)),
        cs=dict(wd_u_row=wd_u, wd_i_row=wd_i, wd_g_row=np.zeros(1, np.float32),
                wd_user_bias=np.float32(0.002), wd_item_bias=np.float32(0.002)),
        stacked=stacked, chunk_id=chunk_id, fb=fb, overlap=overlap,
        lrs=np.array([0.005, 0.0045], np.float32), M=M)


def svdpp_bound(x):
    """K2's bound for one R-round call: each input read once (the live
    pool entries only), each output written once; operations counted from
    this run's data: per live slot (5 + 4 SI) k (p_u, p_i, the dot, the
    u/i scatters, err*p_i and |p_i|^2), per step 2 nnz(O[c]) (k+1) for
    O @ delta over the chunk's nonzero overlaps plus 6 (k+1) per user,
    per touched row 2k, and per chunk start 4 (k+2) per live pool entry
    (gather and flush).  Per-round user and item planes (leading dim R*T)
    are each read once and touch their own rows."""
    st, stacked, fb = x["st"], x["stacked"], x["fb"]
    R = len(x["lrs"])
    N, k = st["w"].shape
    T, GS = stacked["label"].shape
    UR = stacked["u_idx"].shape[0] // T  # 1, or R per-round planes
    G = GS // x["M"]
    SI = stacked["i_idx"].shape[-1]
    cid = x["chunk_id"]
    live = stacked["weight"] > 0
    nnz = [np.count_nonzero(x["overlap"][c, :G, :G]) for c in range(x["overlap"].shape[0])]
    pool_live = (fb["fb_block"] < G).sum(axis=1)
    starts = np.concatenate([[True], cid[1:] != cid[:-1]])
    live_ur = np.tile(live, (UR, 1))[..., None]
    rows = touched_rows(np.where(live_ur, stacked["u_idx"], -1),
                        np.where(live_ur, stacked["i_idx"], -1))
    flops = (R * (int(live.sum()) * (5 + 4 * SI) * k
                  + sum(2 * nnz[c] * (k + 1) + 6 * G * (k + 1) for c in cid)
                  + int(pool_live[cid[starts]].sum()) * 4 * (k + 2))
             + rows * (R // UR) * 2 * k)
    moved = 4 * (2 * N * (k + 1) + T * GS * 2 + UR * T * GS * (2 + 2 * SI)
                 + 3 * int(pool_live.sum()) + x["overlap"].size + 2 * N + 3 * R)
    return bound(moved, flops, R * T)


def phase_svdpp_kernel(torch, dev, card, failures):
    from svdfeature_tpu_torch import convert
    from svdfeature_tpu_torch.ops.cuda_svdpp import (
        launches_per_call, train_rounds_svdpp_kernel, train_rounds_svdpp_reference,
    )
    from svdfeature_tpu_torch.ops.embed import HyperParams
    from svdfeature_tpu_torch.ops.svdpp import PlusHyper

    def device_inputs(x):
        fb, overlap = convert.pool_from_numpy(x["fb"], x["overlap"], dev)
        return (convert.state_from_numpy(**x["st"], device=dev),
                convert.stacked_from_numpy(x["stacked"], dev), x["chunk_id"], fb, overlap,
                torch.tensor(x["lrs"], device=dev),
                convert.consts_from_numpy(**x["cs"], device=dev))

    def hyper(x, at, nub):
        return (HyperParams(active_type=at, no_user_bias=nub, base_score=3.0 if at == 0 else 0.0),
                PlusHyper(rows_per_user=x["M"], off_user=1682, wd_ufeedback=0.004,
                          wd_ufeedback_bias=0.002))

    max_err = 0.0
    cases = (  # (setting, sort_blocks, M, users, active_type, no_user_bias, pairwise, chunks)
        ("band", True, 8, 128, 0, 0, False, None), ("band", True, 8, 128, 2, 1, False, None),
        # the one-row layouts on their first two user chunks (a chunk exit
        # and a chunk entry): the plain version's 2,000-8,000 steps of the
        # whole set are what this phase's time went to
        ("one-row", False, 1, 128, 0, 1, False, 2), ("one-row", False, 1, 128, 2, 0, False, 2),
        ("band-pairwise", True, 8, 128, 3, 1, True, None),
        # more users per step than the resident grid has blocks: each block
        # strides over the users of a step
        ("wide", False, 1, 256, 0, 0, False, 2),
    )
    for setting, sort_blocks, M, users, at, nub, pairwise, chunks in cases:
        x = svdpp_inputs(sort_blocks, M, at, pairwise, seed=20 + at, users=users, chunks=chunks)
        hp, ph = hyper(x, at, nub)
        before = train_rounds_svdpp_kernel.launches
        got = train_rounds_svdpp_kernel(*device_inputs(x), hp, ph)
        torch.cuda.synchronize()
        launched = train_rounds_svdpp_kernel.launches - before
        grid = train_rounds_svdpp_kernel.grid
        want = train_rounds_svdpp_reference(*device_inputs(x), hp, ph)
        T, GS = x["stacked"]["label"].shape
        errs, ok = {}, launched == launches_per_call(x["chunk_id"], len(x["lrs"])) == 1
        for name in ("w", "b"):
            a, b = getattr(got, name), getattr(want, name)
            errs[name] = float((a - b).abs().max())
            ok &= bool(torch.isfinite(a).all()) and bool(((a - b).abs() <= ATOL + RTOL * b.abs()).all())
        ok &= int(got.step) == int(want.step)
        ok &= bool((got.w != torch.from_numpy(x["st"]["w"]).to(dev)).any())
        ok &= grid > 0 and (setting != "wide" or GS // M > grid)
        max_err = max(max_err, *errs.values())
        if not ok:
            failures.append(f"svdpp kernel vs plain {setting} at={at} nub={nub}")
        print(f"phase 4 {'ok' if ok else 'FAIL'}: {setting} (T={T}, GS={GS}, M={M}, "
              f"SI={x['stacked']['i_idx'].shape[-1]}, C={x['fb']['fb_idx'].shape[0]}, "
              f"F={x['fb']['fb_idx'].shape[1]}) active_type={at} no_user_bias={nub} "
              f"max|dw|={errs['w']:.3e} max|db|={errs['b']:.3e} (atol {ATOL:g} + rtol {RTOL:g}) "
              f"launches {launched} (one cooperative launch of {grid} blocks for {GS // M} "
              f"users a step)", flush=True)

    # times at the band setting: CUDA events around whole R=2 runs, after a
    # warm-up, in turns; each path trains on its own device tensors call
    # after call, as the trainer does round after round (the kernel's checks
    # of the packed planes are made once per set of tensors)
    x = svdpp_inputs(True, 8, 0, False, seed=20)
    hp, ph = hyper(x, 0, 0)
    T = x["stacked"]["label"].shape[0]
    R = len(x["lrs"])
    fns = {"plain": train_rounds_svdpp_reference, "kernel": train_rounds_svdpp_kernel}
    samples = {"plain": [], "kernel": []}
    held = {name: list(device_inputs(x)) for name in fns}
    for name in ("plain", "kernel", "kernel", "plain") * 2:
        inputs = held[name]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        inputs[0] = fns[name](*inputs, hp, ph)
        end.record()
        torch.cuda.synchronize()
        samples[name].append(start.elapsed_time(end) / (R * T))
    samples = {name: v[1:] for name, v in samples.items()}  # the first call warms up
    timing = {n: float(np.median(v)) for n, v in samples.items()}
    timing["bound"], timing["bound_by"] = svdpp_bound(x)
    print(f"phase 4 time: band ms per step (GS=1024, median of 3 R={R} runs): "
          f"kernel {timing['kernel']:.4f} plain {timing['plain']:.4f} "
          f"bound {timing['bound']:.6f} ({timing['bound_by']}) on {card}", flush=True)
    for name in ("kernel", "plain"):
        inputs = device_inputs(x)
        print(f"phase 4 profile: band path={name} "
              f"{device_profile(torch, lambda: fns[name](*inputs, hp, ph), R * T)}", flush=True)
    return max_err, timing


# ---- phase 6: the big-table kernels vs plain at bigTable shapes -------------
BIG_ATOL, BIG_RTOL = 1e-6, 1e-5  # K4 vs plain: run sums in plan order vs index_add_
SKEW_EXPONENT = 1.1  # phase 6's skewed K4 batch: Zipf-distributed items
BIG_ROWS_E = 1 << 21  # K5 / K6 rows per call


def timed(torch, fns, inner=5, turns=3, spread=None):
    """ms per call of each zero-argument callable in ``fns``: CUDA events
    around ``inner`` calls, in turns (a b b a ...) ``turns`` times after a
    warm-up call of each; the median.  A dict given as ``spread`` receives
    each name's largest minus smallest turn."""
    names = list(fns)
    for name in names:
        fns[name]()
    samples = {name: [] for name in names}
    for name in (names + names[::-1]) * turns:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fns[name]()
        end.record()
        torch.cuda.synchronize()
        samples[name].append(start.elapsed_time(end) / inner)
    if spread is not None:
        spread.update({name: max(v) - min(v) for name, v in samples.items()})
    return {name: float(np.median(v)) for name, v in samples.items()}


def big_sweep_case(torch, dev, n, u, i, seed, k=BIG_K):
    """K4's arguments for one batch on an n-row table of k factors (rows <
    n-1 random factors and bias with lazy refs, the dummy and pad rows 0):
    the pack-time plan and runs of the batch's (u, i) rows, and the step's
    factors p_u / p_i [B, k] and coefficients coef_u / coef_i [B, 1] of the
    size the bigTable step makes."""
    from svdfeature_tpu_torch.ops import big_embed, tile_sweep

    tile, e_cap = tile_sweep.SWEEP_TILE, tile_sweep.SWEEP_ECAP
    rng = np.random.default_rng(seed)
    n_pad = -(-n // tile) * tile
    tbl = np.zeros((n_pad, big_embed.aug_width(k)), np.float32)
    tbl[: n - 1, : k + 1] = rng.standard_normal((n - 1, k + 1), dtype=np.float32) * 0.01
    tbl[: n - 1, k + 1] = rng.integers(0, 3 * BIG_EX, n - 1, dtype=np.int32).view(np.float32)
    B = u.size
    p_u = rng.standard_normal((B, k), dtype=np.float32) * 0.05
    p_i = rng.standard_normal((B, k), dtype=np.float32) * 0.05
    coef_u = rng.standard_normal((B, 1), dtype=np.float32) * 2e-3
    coef_i = rng.standard_normal((B, 1), dtype=np.float32) * 2e-3
    plan = tile_sweep.attach_sweep_plans({"u_idx": u[None, :, None], "i_idx": i[None, :, None]},
                                         n_pad, tile, e_cap)
    plan = tile_sweep.attach_sweep_runs(plan, tile, e_cap, num_factor=k)
    wd_u = np.zeros(n_pad, np.float32)
    wd_i = np.zeros(n_pad, np.float32)
    wd_u[: int(u.max()) + 1] = 0.004
    wd_i[int(i.min()): n - 1] = 0.004
    f32 = dict(dtype=torch.float32, device=dev)
    plan = {key: torch.from_numpy(plan[key][0]).to(dev) for key in tile_sweep.SWEEP_KEYS}
    rows, counts = np.unique(np.concatenate([u, i]), return_counts=True)
    return dict(
        w=torch.from_numpy(tbl).to(dev),
        args=(plan, *(torch.from_numpy(a).to(dev) for a in (p_u, p_i, coef_u, coef_i)),
              torch.tensor(wd_u, **f32), torch.tensor(wd_i, **f32),
              torch.tensor([0.005, 0.001, 0.002, 0.0], **f32),
              torch.tensor([3 * BIG_EX], dtype=torch.int32, device=dev)),
        touched=len(rows), longest=int(counts.max()), E=2 * B, n=n, k=k)


def zipf_items(n_items, size, exponent, seed):
    """``size`` item ids of a Zipf law with ``exponent`` over ``n_items``
    items (rank r drawn with probability ~ r^-exponent), the ranks spread
    over the ids by a fixed permutation."""
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(np.arange(1, n_items + 1, dtype=np.float64) ** -exponent)
    ranks = np.searchsorted(cdf, rng.random(size) * cdf[-1])
    return rng.permutation(n_items)[np.minimum(ranks, n_items - 1)]


def sweep_bound(case):
    """K4's bound for one call: bytes of the step's factors p_u / p_i and
    the coefficients, the plan arrays it reads (sw_src, sw_runs,
    sw_pieces) once, and each touched row read and written once with its
    two decay rates; operations: 2k per entry (its product and sum) and
    about 4k + 20 per touched row (decay, clamps, bias)."""
    plan, p_u, p_i, coef_u, coef_i = case["args"][:5]
    U, W, k = case["touched"], case["w"].shape[1], case["k"]
    plan_ints = sum(plan[key].numel() for key in ("sw_src", "sw_runs", "sw_pieces"))
    moved = 4 * (p_u.numel() + p_i.numel() + coef_u.numel() + coef_i.numel() + plan_ints
                 + U * (2 * W + 2) + 5)
    return bound(moved, case["E"] * 2 * k + U * (4 * k + 20), 1)


def phase_big_kernels(torch, dev, big, card, failures):
    """K5 and K6 on E = 2^21 rows of the bigTable table (unique targets,
    ~20% of them on the dummy row, which receives zero rows), bit for bit
    against their plain versions, with the library call's time; K4 on the
    plan of one B=2^20 batch of bigTable's data (reg_method 0 and 4) and on
    a 40,960-row table (reg_method 0-5, no_user_bias with the nonnegative
    clamps), against its plain version within atol + rtol, ref bits exact."""
    from svdfeature_tpu_torch.ops import big_embed, cuda_scatter, cuda_sweep
    from svdfeature_tpu_torch.ops.embed import HyperParams

    out = {}
    n = BIG_NU + BIG_NI + 1
    W = big_embed.aug_width(BIG_K)
    E = BIG_ROWS_E
    rng = np.random.default_rng(11)
    on_dummy = rng.random(E) < 0.2
    idx_np = np.full(E, n - 1, np.int32)
    idx_np[~on_dummy] = rng.permutation(n - 1)[: int((~on_dummy).sum())]
    vals_np = rng.standard_normal((E, W), dtype=np.float32)
    vals_np[idx_np == n - 1] = 0.0
    U = len(np.unique(idx_np))
    tbl = torch.from_numpy(rng.standard_normal((n, W), dtype=np.float32)).to(dev)
    tbl[-1] = 0.0
    idx, vals = torch.from_numpy(idx_np).to(dev), torch.from_numpy(vals_np).to(dev)
    idx_long = idx.long()
    got = cuda_scatter.row_writer(tbl.clone(), idx, vals)
    want = cuda_scatter.row_writer_reference(tbl.clone(), idx, vals)
    read = cuda_scatter.row_reader(tbl, idx)
    torch.cuda.synchronize()
    ok5 = torch.equal(got, want) and bool((got[-1] == 0).all())
    ok6 = torch.equal(read, cuda_scatter.row_reader_reference(tbl, idx))
    del got, want, read
    work = tbl.clone()
    t5 = timed(torch, {"plain": lambda: cuda_scatter.row_writer_reference(work, idx, vals),
                       "kernel": lambda: cuda_scatter.row_writer(work, idx, vals),
                       "library": lambda: work.index_copy_(0, idx_long, vals)})
    t5["bound"], t5["bound_by"] = bound(4 * (E + E * W + U * W), 0, 1)
    t6 = timed(torch, {"plain": lambda: cuda_scatter.row_reader_reference(tbl, idx),
                       "kernel": lambda: cuda_scatter.row_reader(tbl, idx),
                       "library": lambda: torch.index_select(tbl, 0, idx_long)})
    t6["bound"], t6["bound_by"] = bound(4 * (E + U * W + E * W), 0, 1)
    for kid, ok, t in (("K5", ok5, t5), ("K6", ok6, t6)):
        if not ok:
            failures.append(f"{kid} vs plain")
        print(f"phase 6 {'ok' if ok else 'FAIL'}: {kid} E={E} rows of W={W} into n={n} "
              f"({U} distinct targets) bit for bit against its plain version; ms per call "
              f"kernel {t['kernel']:.4f} plain {t['plain']:.4f} library {t['library']:.4f} "
              f"bound {t['bound']:.4f} ({t['bound_by']}) on {card}", flush=True)
    # one session holds the kernel and its plain version (a session with
    # nothing but one ctypes launch has recorded no device events)
    print(f"phase 6 profile: K5 row_writer then its plain version "
          f"{device_profile(torch, lambda: (cuda_scatter.row_writer(work, idx, vals), cuda_scatter.row_writer_reference(work, idx, vals)), 1, top=3)}",
          flush=True)
    # K5 at the shape of bigTable (c)'s calls, 1,536 of its launches on the
    # main path: one batch-4096 dedup step writes E = 8192 rows (its u and i
    # entries in sorted order, each run's last entry to its row, the rest
    # as zeros to the dummy row; big_embed.apply_entries)
    ent = np.sort(np.concatenate([big["index"][0:2 * 4096:2].astype(np.int64),
                                  BIG_NU + big["index"][1:2 * 4096:2].astype(np.int64)]))
    last = np.append(ent[1:] != ent[:-1], True)
    Ec, Uc = ent.size, int(last.sum()) + 1  # distinct rows written, the dummy included
    idx_c = torch.from_numpy(np.where(last, ent, n - 1).astype(np.int32)).to(dev)
    vals_c = torch.from_numpy(np.where(last[:, None], vals_np[:Ec], 0.0).astype(np.float32)).to(dev)
    idx_c_long = idx_c.long()
    ok5c = torch.equal(cuda_scatter.row_writer(tbl.clone(), idx_c, vals_c),
                       cuda_scatter.row_writer_reference(tbl.clone(), idx_c, vals_c))
    spread = {}
    t5c = timed(torch, {"plain": lambda: cuda_scatter.row_writer_reference(work, idx_c, vals_c),
                        "kernel": lambda: cuda_scatter.row_writer(work, idx_c, vals_c),
                        "library": lambda: work.index_copy_(0, idx_c_long, vals_c)}, inner=200,
                turns=10, spread=spread)
    t5c["bound"], t5c["bound_by"] = bound(4 * (Ec + Ec * W + Uc * W), 0, 1)
    if not ok5c:
        failures.append("K5 vs plain at E=8192")
    print(f"phase 6 {'ok' if ok5c else 'FAIL'}: K5 at bigTable (c)'s call shape E={Ec} rows "
          f"({Uc} distinct targets) bit for bit against its plain version; ms per call kernel "
          f"{t5c['kernel']:.4f} plain {t5c['plain']:.4f} library {t5c['library']:.4f} bound "
          f"{t5c['bound']:.6f} ({t5c['bound_by']}) on {card}", flush=True)
    # the gate: no slower than the one PyTorch call for the same function,
    # beyond what the turns of this very call differ by
    allowed = max(spread["kernel"], spread["library"])
    ok_lib = t5c["kernel"] <= t5c["library"] + allowed
    if not ok_lib:
        failures.append("K5 at E=8192 slower than index_copy_")
    print(f"phase 6 {'ok' if ok_lib else 'FAIL'}: K5 at E={Ec} against index_copy_: kernel "
          f"{t5c['kernel']:.4f} ms per call, library {t5c['library']:.4f} (spread between "
          f"turns: kernel {spread['kernel']:.4f}, library {spread['library']:.4f}) on {card}",
          flush=True)
    del work, tbl, idx, vals, idx_long, idx_c, vals_c, idx_c_long
    out["K5"] = dict(t5c, err=0.0)
    out["K6"] = dict(t6, err=0.0)

    # K4: one B=2^20 batch of bigTable's data (users [0, NU), items above),
    # and a skewed one: the same users, items from a Zipf law (exponent 1.1)
    B = 1 << 20
    u = big["index"][0:2 * B:2].astype(np.int32)
    i = (BIG_NU + big["index"][1:2 * B:2]).astype(np.int32)
    i_zipf = (BIG_NU + zipf_items(BIG_NI, B, SKEW_EXPONENT, seed=14)).astype(np.int32)
    small_rng = np.random.default_rng(12)
    small_n = 40_960
    half = (small_n - 1) // 2
    cases = [("bigTable", u, i, dict(reg_method=0)), ("bigTable", u, i, dict(reg_method=4)),
             ("skewed", u, i_zipf, dict(reg_method=0)), ("skewed", u, i_zipf, dict(reg_method=4))]
    su = small_rng.integers(0, half, 16_384).astype(np.int32)
    si = (half + small_rng.integers(0, half, 16_384)).astype(np.int32)
    cases += [("40960-row", su, si, dict(reg_method=m)) for m in range(6)]
    cases += [("40960-row", su, si, dict(reg_method=4, no_user_bias=1, user_nonnegative=1,
                                         item_nonnegative=1))]
    max_err, full, t4 = 0.0, None, {}
    for name, cu_, ci_, kw in cases:
        n_case = n if name != "40960-row" else small_n
        if full is None or full["name"] != name:
            full = None
            torch.cuda.empty_cache()
            full = dict(big_sweep_case(torch, dev, n_case, cu_, ci_, seed=13), name=name)
        hp = HyperParams(big_table=True, num_factor=BIG_K, sweep_table=True, **kw)
        got = cuda_sweep.sweep_update(full["w"].clone(), *full["args"], hp)
        want = cuda_sweep.sweep_update_reference(full["w"].clone(), *full["args"], hp)
        torch.cuda.synchronize()
        k = BIG_K
        err = float((got[:, :k + 1] - want[:, :k + 1]).abs().max())
        ok = (bool(((got[:, :k + 1] - want[:, :k + 1]).abs()
                    <= BIG_ATOL + BIG_RTOL * want[:, :k + 1].abs()).all())
              and torch.equal(big_embed.ref_column(got, k), big_embed.ref_column(want, k))
              and bool((got[full["n"] - 1, :k + 1] == 0).all())
              and bool((got[full["n"]:] == 0).all()) and bool(torch.isfinite(got).all())
              and not torch.equal(got, full["w"]))
        if name == "skewed":
            ok &= full["longest"] >= 1000  # runs of thousands of entries
        max_err = max(max_err, err)
        if not ok:
            failures.append(f"K4 vs plain {name} {kw}")
        runs = full["args"][0]["sw_runs"]
        print(f"phase 6 {'ok' if ok else 'FAIL'}: K4 {name} table n={full['n']} "
              f"(E={full['E']}, {full['touched']} touched rows, longest run {full['longest']} "
              f"entries, {runs.shape[0]} run records of which "
              f"{int((runs[:, 3] >= 0).sum())} pieces, G={full['args'][0]['sw_tids'].numel()} "
              f"cells) {kw} max|d|={err:.3e} (atol {BIG_ATOL:g} + rtol {BIG_RTOL:g}; ref bits, "
              f"dummy and pad rows exact)", flush=True)
        if name != "40960-row" and kw["reg_method"] == 0:
            work = full["w"].clone()
            t = timed(torch, {
                "plain": lambda: cuda_sweep.sweep_update_reference(work, *full["args"], hp),
                "kernel": lambda: cuda_sweep.sweep_update(work, *full["args"], hp)})
            t["bound"], t["bound_by"] = sweep_bound(full)
            t4[name] = t
            print(f"phase 6 time: K4 {name} B=2^20 reg_method=0 ms per call kernel "
                  f"{t['kernel']:.4f} plain {t['plain']:.4f} bound {t['bound']:.4f} "
                  f"({t['bound_by']}; kernel at {t['bound'] / t['kernel']:.0%} of it), "
                  f"{t['kernel'] * 1e6 / full['E']:.3f} ns per entry on {card}", flush=True)
            print(f"phase 6 profile: K4 {name} sweep_update then its plain version "
                  f"{device_profile(torch, lambda: (cuda_sweep.sweep_update(work, *full['args'], hp), cuda_sweep.sweep_update_reference(work, *full['args'], hp)), 1, top=3)}",
                  flush=True)
            del work
        del got, want
    out["K4"] = dict(t4["bigTable"], err=max_err)
    out["K4 wide"] = wide_sweep_cases(torch, dev, card, failures)
    return out


# phase 6, wide rows: K4 on rows of more than the 256 factors that its
# first kernels hold (csrc/tile_sweep.cu's sweep_wide_kernel: a warp a run,
# sweeps of up to 512 columns), on a WIDE_N-row table at batch WIDE_B
WIDE_N = 1 << 16
WIDE_B = 1 << 14
WIDE_INNER = 20  # calls a timed turn (kernel and plain version in turns)
WIDE_CASES = (  # (k, items, reg_method): 257 and 301 take 4-byte copies, the rest float4
    (257, "uniform", 1), (300, "uniform", 0), (300, "skewed", 2), (512, "uniform", 4),
    (512, "skewed", 0), (301, "skewed", 5), (1024, "uniform", 3))


def wide_inputs():
    """Phase 6's wide batch: WIDE_B user rows in [0, half) and item rows
    above, uniform or skewed (a Zipf law, SKEW_EXPONENT), of a WIDE_N-row
    table."""
    rng = np.random.default_rng(15)
    half = (WIDE_N - 1) // 2
    u = rng.integers(0, half, WIDE_B).astype(np.int32)
    return u, {"uniform": (half + rng.integers(0, half, WIDE_B)).astype(np.int32),
               "skewed": (half + zipf_items(half, WIDE_B, SKEW_EXPONENT, seed=16)).astype(np.int32)}


def wide_sweep_cases(torch, dev, card, failures):
    """K4 at k=257, 300, 301, 512 and 1024 against its plain version
    (BIG_ATOL + BIG_RTOL, ref bits, dummy and pad rows exact) on a
    WIDE_N-row table at batch WIDE_B: uniform items, and skewed ones (runs
    cut into pieces); reg_method 0-5 across the cases (2: the whole row's
    scale); kernel / plain / bound ms of each and the kernel's share of
    the bound.  Returns k -> the timing of its first case, with the largest
    error of all."""
    from svdfeature_tpu_torch.ops import big_embed, cuda_sweep
    from svdfeature_tpu_torch.ops.embed import HyperParams

    u, items = wide_inputs()
    out, max_err = {}, 0.0
    for k, kind, m in WIDE_CASES:
        torch.cuda.empty_cache()
        case = big_sweep_case(torch, dev, WIDE_N, u, items[kind], seed=17, k=k)
        hp = HyperParams(big_table=True, num_factor=k, sweep_table=True, reg_method=m)
        got = cuda_sweep.sweep_update(case["w"].clone(), *case["args"], hp)
        want = cuda_sweep.sweep_update_reference(case["w"].clone(), *case["args"], hp)
        torch.cuda.synchronize()
        diff = (got[:, :k + 1] - want[:, :k + 1]).abs()
        err = float(diff.max())
        pieces = int((case["args"][0]["sw_runs"][:, 3] >= 0).sum())
        ok = (bool((diff <= BIG_ATOL + BIG_RTOL * want[:, :k + 1].abs()).all())
              and torch.equal(big_embed.ref_column(got, k), big_embed.ref_column(want, k))
              and bool((got[WIDE_N - 1, :k + 1] == 0).all()) and bool((got[WIDE_N:] == 0).all())
              and bool(torch.isfinite(got).all()) and not torch.equal(got, case["w"])
              and (kind == "uniform" or pieces > 0))
        del got, want, diff
        work = case["w"].clone()
        # WIDE_INNER calls a turn: the host's time to a turn's first launch
        # (the wrapper's checks, 26-58 us on the H100's host) counts once a
        # turn, as much as a tenth of a 50 us launch in a turn of 5
        t = timed(torch, {
            "plain": lambda: cuda_sweep.sweep_update_reference(work, *case["args"], hp),
            "kernel": lambda: cuda_sweep.sweep_update(work, *case["args"], hp)},
            inner=WIDE_INNER)
        t["bound"], t["bound_by"] = sweep_bound(case)
        max_err = max(max_err, err)
        out.setdefault(k, t)
        if not ok:
            failures.append(f"K4 vs plain k={k} {kind} reg_method={m}")
        print(f"phase 6 {'ok' if ok else 'FAIL'}: K4 k={k} ({'16' if k % 4 == 0 else '4'}-byte "
              f"copies, {-(-k // 512)} sweep(s) of up to 512 columns) {kind} items, table "
              f"n={WIDE_N} B={WIDE_B} (E={case['E']}, {case['touched']} touched rows, longest run "
              f"{case['longest']} entries, {pieces} pieces) reg_method={m}: max|d|={err:.3e} "
              f"(atol {BIG_ATOL:g} + rtol {BIG_RTOL:g}; ref bits, dummy and pad rows exact); "
              f"ms per call kernel {t['kernel']:.4f} plain {t['plain']:.4f} bound "
              f"{t['bound']:.4f} ({t['bound_by']}; kernel at {t['bound'] / t['kernel']:.0%} of "
              f"it) on {card}", flush=True)
        del work, case
    for t in out.values():
        t["err"] = max_err
    return out


# ---- phase 7: the bigTable slice ---------------------------------------------
# Test RMSE on the probe after BIG_ROUNDS rounds, the JAX package on the
# CPU, same data and conf (scripts/bigtable_jax_reference.py):
#   JAX_PLATFORMS=cpu python scripts/bigtable_jax_reference.py --batch-size 1048576 --big-sweep 0
#   JAX_PLATFORMS=cpu python scripts/bigtable_jax_reference.py --batch-size 4096
JAX_BIG_RMSE = {1 << 20: 0.170827, 4096: 0.170851}
JAX_BIG_RMSE0 = 0.176042  # round 0 (the seeded init), both runs
BIG_JAX_TOL = 1e-4
BIG_AB_TOL = 1e-5  # K4 against its plain version end to end
# (e): rows of WIDE_K factors on the base solver's tile sweep (K4 in
# passes): bigTable's recipe on WIDE_NU users, WIDE_NI items and WIDE_EX
# examples a round, batch WIDE_BATCH, big_sweep=1, WIDE_ROUNDS rounds; its
# probe RMSE after them, the JAX package on the CPU
# (scripts/wide_sweep_jax_reference.py)
WIDE_K = 300
WIDE_NU = WIDE_NI = 16_384
WIDE_EX = 1 << 15
WIDE_BATCH = 8192
WIDE_ROUNDS = 2
WIDE_CONF = dict(BIG_CONF, num_user=str(WIDE_NU), num_item=str(WIDE_NI), num_factor=str(WIDE_K))
JAX_WIDE_RMSE = 0.175345  # round 0 (the seeded init): 0.178875


def big_run(conf, d, tag, extra, through_tasks, rounds=BIG_ROUNDS, profile=True):
    """One bigTable training run of ``rounds`` rounds, every kernel's
    launch count set to 0 just before it and read just after.  Through
    SVDTrainTask + SVDInferTask (the probe's RMSE at rounds 0 and
    ``rounds`` from the checkpoints; with ``profile``, one more round
    under the profiler), or, sparing the 532 MB saves, the task's trainer
    driven directly as bench.py drives it (predict_all on the probe before
    and after)."""
    import torch

    from svdfeature_tpu_torch.data.buffer import read_csr_buffer
    from svdfeature_tpu_torch.infer.task import SVDInferTask
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = [f"model_out_folder={d}/models_{tag}", "device=cuda", f"num_round={rounds}", *extra]
    wrappers = kernel_wrappers()
    task = SVDTrainTask()
    t0 = time.perf_counter()
    if through_tasks:
        for fn in wrappers.values():
            fn.launches = 0
        task.run(str(conf), args)
        launches = {kid: fn.launches for kid, fn in wrappers.items()}
        secs = task.round_seconds
        # where a round's time goes: one more round under the profiler,
        # after the counts are read and the checkpoints written
        steps = -(-task.dataset_rows() // task.trainer.batch_size)
        profile_line = device_profile(
            torch, lambda: task.trainer.update_all(task.dataset), steps, top=8) if profile else None
        log = d / f"rmse_{tag}.tsv"
        SVDInferTask().run(str(conf), args + ["start=0", f"end={rounds + 1}",
                                              f"step={rounds}", f"log_eval={log}"])
        rmse = dict(line.split() for line in log.read_text().splitlines())
        rmse0, rmse1 = float(rmse["0"]), float(rmse[str(rounds)])
        shutil.rmtree(d / f"models_{tag}")
    else:
        task.configure(str(conf), args)
        task.init()
        tr = task.trainer
        probe, _ = read_csr_buffer(str(d / "test.buffer"))

        def probe_rmse():
            return float(np.sqrt(np.mean((tr.predict_all(probe) - probe.labels) ** 2)))

        rmse0 = probe_rmse()
        for fn in wrappers.values():
            fn.launches = 0
        secs = []
        for r in range(rounds):
            tr.set_round(r)
            t1 = time.perf_counter()
            tr.update_all(task.dataset)
            tr.synchronize()
            secs.append(time.perf_counter() - t1)
        launches = {kid: fn.launches for kid, fn in wrappers.items()}
        rmse1 = probe_rmse()
        profile_line = None
        del tr
    hp = task.trainer.hp
    rows = task.dataset_rows()
    res = dict(rmse0=rmse0, rmse1=rmse1, launches=launches, secs=secs,
               eps=rows * (len(secs) - 1) / sum(secs[1:]),
               steps=rounds * -(-rows // task.trainer.batch_size),
               route="sweep" if hp.sweep_table else "dedup", kernels=bool(hp.row_dma),
               batch=task.trainer.batch_size, peak=torch.cuda.max_memory_allocated(),
               seconds=time.perf_counter() - t0, profile=profile_line)
    del task
    return res


def phase_bigtable(work, big, card, failures):
    """bigTable through the port's entry points: (a) batch 2^20 (auto:
    the tile sweep, K4), (b) the same with use_pallas=0 (plain versions),
    (c) batch 4096 (auto: sorted dedup with K5), (d) batch 2^20 with
    big_sweep=0 (K5).  Gates: exact launch counts (one K4 or K5 launch
    per step), the probe RMSE falls, (a) and (b) agree within BIG_AB_TOL,
    each kernel run lies within BIG_JAX_TOL of the JAX package's figure."""
    from svdfeature_tpu_torch.data.buffer import write_csr_buffer
    from svdfeature_tpu_torch.data.csr import CSRDataset

    d = work / "bigTable"
    d.mkdir()
    conf, _ = write_bigtable(CSRDataset, write_csr_buffer, d, big)
    runs = (("a", ["batch_size=1048576"], True), ("b", ["batch_size=1048576", "use_pallas=0"], False),
            ("c", ["batch_size=4096"], True), ("d", ["batch_size=1048576", "big_sweep=0"], False))
    ref_eps = json.loads((ROOT / "golden" / "GOLDEN.json").read_text())["bigTable"]["examples_per_sec_cpu"]
    results = {}
    for tag, extra, through_tasks in runs:
        r = big_run(conf, d, tag, extra, through_tasks)
        results[tag] = r
        kid = ("K4" if r["route"] == "sweep" else "K5") if r["kernels"] else None
        want = {key: 0 for key in r["launches"]}
        if kid:
            want[kid] = r["steps"]
        jax = JAX_BIG_RMSE[r["batch"]]
        ok = (r["launches"] == want and r["rmse1"] < r["rmse0"] and math.isfinite(r["rmse1"])
              and (kid is None or abs(r["rmse1"] - jax) < BIG_JAX_TOL))
        d_jax = f"{r['rmse1'] - jax:+.6f}"
        if not ok:
            failures.append(f"bigTable run ({tag})")
        print(f"phase 7 {'ok' if ok else 'FAIL'}: bigTable ({tag}) batch {r['batch']} route "
              f"{r['route']} {'kernels' if r['kernels'] else 'plain versions'} "
              f"{'through SVDTrainTask/SVDInferTask' if through_tasks else 'trainer driven directly'}: "
              f"probe RMSE {r['rmse0']:.6f} -> {r['rmse1']:.6f} after {BIG_ROUNDS} rounds "
              f"(minus JAX CPU {d_jax}, tol {BIG_JAX_TOL:g}); launches {r['launches']} "
              f"(want {want}: one per step, {r['steps']} steps); training "
              f"{r['eps']:,.0f} examples/s rounds 2-{BIG_ROUNDS} (reference C++ {ref_eps:,}/s), "
              f"round seconds {[round(x, 3) for x in r['secs']]}; peak device memory "
              f"{r['peak'] / 2**30:.2f} GiB; run {r['seconds']:.1f} s; on {card}", flush=True)
        if r["profile"]:
            print(f"phase 7 profile: bigTable ({tag}) one more round: {r['profile']}", flush=True)
    diff = abs(results["a"]["rmse1"] - results["b"]["rmse1"])
    if diff >= BIG_AB_TOL:
        failures.append("bigTable (a) vs (b)")
    print(f"phase 7 {'ok' if diff < BIG_AB_TOL else 'FAIL'}: bigTable K4 (a) against its plain "
          f"version (b) end to end: |d RMSE| {diff:.2e} (tol {BIG_AB_TOL:g})", flush=True)
    # (e): rows of WIDE_K factors, K4 in passes
    wd = work / "wideTable"
    wd.mkdir()
    wconf, _ = write_bigtable(CSRDataset, write_csr_buffer, wd,
                              bigtable_arrays(WIDE_NU, WIDE_NI, WIDE_EX), WIDE_CONF)
    wide = big_run(wconf, wd, "e", [f"batch_size={WIDE_BATCH}", "big_sweep=1"], True,
                   rounds=WIDE_ROUNDS, profile=False)
    want = {key: 0 for key in wide["launches"]}
    want["K4"] = wide["steps"]
    ok = (wide["launches"] == want and wide["route"] == "sweep" and wide["kernels"]
          and wide["rmse1"] < wide["rmse0"] and abs(wide["rmse1"] - JAX_WIDE_RMSE) < BIG_JAX_TOL)
    if not ok:
        failures.append("bigTable run (e), k=300")
    print(f"phase 7 {'ok' if ok else 'FAIL'}: wide rows (e) k={WIDE_K}, {WIDE_NU + WIDE_NI + 1} "
          f"rows, batch {wide['batch']} big_sweep=1 route {wide['route']} through "
          f"SVDTrainTask/SVDInferTask: probe RMSE {wide['rmse0']:.6f} -> {wide['rmse1']:.6f} "
          f"after {WIDE_ROUNDS} rounds (minus JAX CPU {wide['rmse1'] - JAX_WIDE_RMSE:+.6f}, tol "
          f"{BIG_JAX_TOL:g}); launches {wide['launches']} (want {want}: one K4 a step, "
          f"{wide['steps']} steps); round seconds {[round(x, 3) for x in wide['secs']]}; run "
          f"{wide['seconds']:.1f} s; on {card}", flush=True)
    shutil.rmtree(wd, ignore_errors=True)
    launches = {"K4": results["a"]["launches"]["K4"], "K4 wide": wide["launches"]["K4"],
                "K5": results["c"]["launches"]["K5"] + results["d"]["launches"]["K5"],
                "K6": sum(r["launches"]["K6"] for r in results.values())}
    # what phase 18 holds its streamed runs of the same settings to
    return launches, {tag: dict(eps=results[tag]["eps"], rmse=results[tag]["rmse1"]) for tag in "ac"}


# ---- phase 8: K3 vs plain ----------------------------------------------------
def imfb_synth_text(seed, n_users=943):
    """(rows, feedback) text of a synthetic user-group set on the ML-100K
    layout: 1-12 rows per user on random items, 2-30 feedback ids each."""
    rng = np.random.RandomState(seed)
    rows, fbs = [], []
    for u in range(n_users):
        r = rng.randint(1, 13)
        for _ in range(r):
            rows.append(f"{rng.randint(1, 6)} 0 1 1 {u}:1 {rng.randint(0, 1682)}:1")
        nf = rng.randint(2, 31)
        ids = rng.choice(1682, size=nf, replace=False)
        fbs.append(f"{r} {nf} " + " ".join(f"{j}:{1.0 / np.sqrt(nf):.4f}" for j in ids))
    return "\n".join(rows) + "\n", "\n".join(fbs) + "\n"


def imfb_inputs(rows_per_user, seed, synthetic, levels=()):
    """numpy inputs of one K3 case on the implicitFeedback layout (feedback
    rows [0, 1682), users [1682, 2625), items [2625, 4307), dummy 4307;
    k=64): the depth-2 transform of the ML-100K train set, or of a
    synthetic set, packed by the port's pack_imfb with 128 units per step,
    its context overlaps and the update gate with depths ``levels``
    disabled."""
    from svdfeature_tpu_torch.data import csr
    from svdfeature_tpu_torch.data.batching_imfb import pack_imfb
    from svdfeature_tpu_torch.data.batching_plus import compute_fb_overlap
    from svdfeature_tpu_torch.data.text import load_plus_text
    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.multi_imfb import SVDPPMultiIMFBTrainer

    if synthetic:
        rows, fbs = imfb_synth_text(seed)
    else:
        rows, fbs = (fixture_text("ml100k.base.group.feature.gz"),
                     fixture_text("ml100k.base.feedback.gz"))
    ds = stack_depth2(load_plus_text("x", "y", text=rows, feedback_text=fbs), csr)
    packed = pack_imfb(ds, 128, 4307, 0, 1682, 2625, 0, num_user=943, num_item=1682,
                       num_ufeedback=1682, rows_per_user=rows_per_user)
    trainer = SVDPPMultiIMFBTrainer(SVDTypeParam(format_type=1, extend_type=2))
    trainer.disable_levels = set(levels)
    rng = np.random.RandomState(seed)
    N, k = 4308, 64
    w = rng.normal(0, 0.01, (N, k)).astype(np.float32)
    b = rng.normal(0, 0.01, (N,)).astype(np.float32)
    w[-1] = 0.0
    b[-1] = 0.0
    wd_u = np.zeros(N, np.float32)
    wd_i = np.zeros(N, np.float32)
    wd_u[1682:2625] = 0.004
    wd_i[2625:N - 1] = 0.004
    stacked = packed.device_arrays()
    chunk_id = stacked.pop("chunk_id")
    return dict(
        st=dict(w=w, b=b, g=np.zeros(1, np.float32), step=np.int32(0),
                ref_ui=np.zeros(N, np.int32), ref_g=np.zeros(1, np.int32)),
        cs=dict(wd_u_row=wd_u, wd_i_row=wd_i, wd_g_row=np.zeros(1, np.float32),
                wd_user_bias=np.float32(0.002), wd_item_bias=np.float32(0.002)),
        stacked=stacked, chunk_id=chunk_id, fb=packed.fb_arrays(),
        overlap=compute_fb_overlap(packed.fb_idx, packed.fb_val, packed.fb_ctx,
                                   packed.ctx_depth.shape[1]),
        enabled=trainer._imfb_enabled(packed.ctx_depth),
        lrs=np.array([0.005, 0.0045], np.float32), RM=rows_per_user)


def imfb_bound(x):
    """K3's bound for one R-round call: each input read once (the live pool
    entries only), each output written once; operations counted from this
    run's data: per live slot (9 + 2D) k (K2's slot work with one item
    entry, plus reading and adding into its D contexts), per step
    2 nnz(O[c]) (k+1) for O @ delta over the chunk's nonzero overlaps of
    non-pad contexts plus 6 (k+1) per context, per touched row 2k, and per
    chunk start 4 (k+2) per live pool entry (gather and flush)."""
    st, stacked, fb = x["st"], x["stacked"], x["fb"]
    R = len(x["lrs"])
    N, k = st["w"].shape
    T, GS = stacked["label"].shape
    D = stacked["ctx_slots"].shape[-1]
    G = x["enabled"].shape[1] - 1  # non-pad contexts
    cid = x["chunk_id"]
    live = stacked["weight"] > 0
    nnz = [np.count_nonzero(x["overlap"][c, :G, :G]) for c in range(x["overlap"].shape[0])]
    pool_live = (fb["fb_ctx"] < G).sum(axis=1)
    starts = np.concatenate([[True], cid[1:] != cid[:-1]])
    rows = touched_rows(np.where(live[..., None], stacked["u_idx"], -1),
                        np.where(live[..., None], stacked["i_idx"], -1))
    flops = R * (int(live.sum()) * (9 + 2 * D) * k
                 + sum(2 * nnz[c] * (k + 1) + 6 * G * (k + 1) for c in cid)
                 + rows * 2 * k
                 + int(pool_live[cid[starts]].sum()) * 4 * (k + 2))
    moved = 4 * (2 * N * (k + 1) + T * GS * (6 + D) + 3 * int(pool_live.sum())
                 + x["overlap"].size + x["enabled"].size + 2 * N + 3 * R)
    return bound(moved, flops, R * T)


def phase_imfb_kernel(torch, dev, card, failures):
    from svdfeature_tpu_torch import convert
    from svdfeature_tpu_torch.ops.cuda_imfb import (
        launches_per_call, train_rounds_imfb_kernel, train_rounds_imfb_reference,
    )
    from svdfeature_tpu_torch.ops.embed import HyperParams
    from svdfeature_tpu_torch.ops.svdpp import PlusHyper

    def device_inputs(x):
        fb, overlap = convert.pool_from_numpy(x["fb"], x["overlap"], dev)
        return [convert.state_from_numpy(**x["st"], device=dev),
                convert.stacked_from_numpy(x["stacked"], dev), x["chunk_id"], fb, overlap,
                convert.gate_from_numpy(x["enabled"], dev), torch.tensor(x["lrs"], device=dev),
                convert.consts_from_numpy(**x["cs"], device=dev)]

    def hyper(x, nub):
        return (HyperParams(no_user_bias=nub, base_score=3.0),
                PlusHyper(rows_per_user=x["RM"], off_user=1682, wd_ufeedback=0.004,
                          wd_ufeedback_bias=0.002))

    max_err = 0.0
    cases = (  # (setting, synthetic, rows_per_user, no_user_bias, disabled depths, calls)
        ("slice", False, 8, 0, (), 2),  # the second call on the same tensors: the kept plan
        ("synthetic", True, 1, 1, (1,), 1),
        ("synthetic", True, 2, 1, (1,), 1),
    )
    for setting, synthetic, RM, nub, levels, calls in cases:
        x = imfb_inputs(RM, 30 + RM, synthetic, levels)
        hp, ph = hyper(x, nub)
        held = device_inputs(x)
        want = device_inputs(x)
        T, GS = x["stacked"]["label"].shape
        for call in range(calls):
            before = train_rounds_imfb_kernel.launches
            held[0] = train_rounds_imfb_kernel(*held, hp, ph)
            torch.cuda.synchronize()
            launched = train_rounds_imfb_kernel.launches - before
            want[0] = train_rounds_imfb_reference(*want, hp, ph)
            errs, ok = {}, launched == launches_per_call(x["chunk_id"], len(x["lrs"])) == 1
            for name in ("w", "b"):
                a, b = getattr(held[0], name), getattr(want[0], name)
                errs[name] = float((a - b).abs().max())
                ok &= bool(torch.isfinite(a).all()) and bool(((a - b).abs() <= ATOL + RTOL * b.abs()).all())
            ok &= int(held[0].step) == int(want[0].step)
            ok &= bool((held[0].w[:1682] != torch.from_numpy(x["st"]["w"][:1682]).to(dev)).any())
            max_err = max(max_err, *errs.values())
            if not ok:
                failures.append(f"imfb kernel vs plain {setting} RM={RM} nub={nub} call {call + 1}")
            print(f"phase 8 {'ok' if ok else 'FAIL'}: {setting} (T={T}, GS={GS}, RM={RM}, "
                  f"D={x['stacked']['ctx_slots'].shape[-1]}, nseg={x['enabled'].shape[1]}, "
                  f"C={x['fb']['fb_idx'].shape[0]}, F={x['fb']['fb_idx'].shape[1]}) "
                  f"no_user_bias={nub} disabled depths={list(levels)} call {call + 1} of {calls} "
                  f"max|dw|={errs['w']:.3e} max|db|={errs['b']:.3e} (atol {ATOL:g} + rtol "
                  f"{RTOL:g}) launches {launched} (grid {train_rounds_imfb_kernel.grid} blocks)",
                  flush=True)

    # times at the slice's shapes: CUDA events around whole R=2 calls, in
    # turns, each path on its own device tensors call after call, as the
    # trainer calls it
    x = imfb_inputs(8, 38, False)
    hp, ph = hyper(x, 0)
    T = x["stacked"]["label"].shape[0]
    R = len(x["lrs"])
    fns = {"plain": train_rounds_imfb_reference, "kernel": train_rounds_imfb_kernel}
    samples = {"plain": [], "kernel": []}
    held = {name: device_inputs(x) for name in fns}
    for name in ("plain", "kernel", "kernel", "plain", "kernel", "plain"):
        inputs = held[name]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        inputs[0] = fns[name](*inputs, hp, ph)
        end.record()
        torch.cuda.synchronize()
        samples[name].append(start.elapsed_time(end) / (R * T))
    samples = {name: v[1:] for name, v in samples.items()}  # the first call warms up
    timing = {n: float(np.median(v)) for n, v in samples.items()}
    timing["bound"], timing["bound_by"] = imfb_bound(x)
    print(f"phase 8 time: slice ms per step (GS=1024, nseg={x['enabled'].shape[1]}, median of 2 "
          f"R={R} runs): kernel {timing['kernel']:.4f} plain {timing['plain']:.4f} "
          f"bound {timing['bound']:.6f} ({timing['bound_by']}); library call: none (no "
          f"PyTorch call computes a stacked step) on {card}", flush=True)
    for name in ("kernel", "plain"):
        inputs = held[name][:6] + [held[name][6][:1]] + held[name][7:]  # one round
        print(f"phase 8 profile: slice path={name} one round "
              f"{device_profile(torch, lambda: fns[name](*inputs, hp, ph), T)}", flush=True)
    return max_err, timing


# ---- phase 9: the stacked slice ------------------------------------------------
def phase_imfb_slice(work, card, failures):
    """The stacked multi-IMFB slice through SVDTrainTask / SVDInferTask,
    IMFB_ROUNDS rounds through K3, then IMFB_PLAIN_ROUNDS with use_pallas=0
    (the plain version), held to the kernel run at that round."""
    import torch

    from svdfeature_tpu_torch.cli import make_ugroup_buffer
    from svdfeature_tpu_torch.data import csr
    from svdfeature_tpu_torch.data.buffer import write_plus_buffer
    from svdfeature_tpu_torch.data.text import load_plus_text
    from svdfeature_tpu_torch.infer.task import SVDInferTask
    from svdfeature_tpu_torch.ops.cuda_imfb import (
        TRACE_SLOTS, launches_per_call, train_rounds_imfb_kernel,
    )
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    d = work / "multiIMFBStacked"
    d.mkdir()
    write_imfb(d, load_plus_text, csr, write_plus_buffer, make_ugroup_buffer.main)
    conf = str(ROOT / "demo" / "implicitFeedback" / "implicitFeedback.conf")
    golden = json.loads((ROOT / "golden" / "GOLDEN.json").read_text())["multiIMFBStacked"]
    ref_rmse = float((ROOT / "golden" / "multi_imfb_stacked.rmse.tsv").read_text().split()[-1])
    results = {}
    for path, extra, R in (("kernel", [], IMFB_ROUNDS),
                           ("plain", ["use_pallas=0"], IMFB_PLAIN_ROUNDS)):
        common = [f"buffer_feature={d}/train.buffer", f"test:buffer_feature={d}/test.buffer",
                  f"model_out_folder={d}/models_{path}", "device=cuda", "silent=1",
                  "extend_type=2", "rows_per_user=8", *extra]
        wrappers = kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        task = SVDTrainTask()
        task.run(conf, common + [f"num_round={R}"])
        launches = {kid: fn.launches for kid, fn in wrappers.items()}
        tr = task.trainer
        entry = tr._pack_plus(task.dataset)
        cid = entry.chunk_id
        # where a round's time goes: one more round under the profiler,
        # after the counts are read and the checkpoints written
        profile_line = device_profile(torch, lambda: tr.update_all(task.dataset), len(cid), top=5)
        log = d / f"rmse_{path}.tsv"
        # the kernel run's checkpoint of the plain run's last round as well
        evals = ([f"start={R}", f"end={R + 1}"] if path == "plain" else
                 [f"start={IMFB_PLAIN_ROUNDS}", f"end={R + 1}", f"step={R - IMFB_PLAIN_ROUNDS}"])
        SVDInferTask().run(conf, common + [*evals, f"log_eval={log}"])
        at = {int(r): float(x) for r, x in (line.split() for line in log.read_text().splitlines())}
        rmse = at[R]
        rows = task.dataset_rows()
        secs = task.round_seconds
        eps = rows * (len(secs) - 1) / sum(secs[1:])
        want = {kid: 0 for kid in launches}
        starts = int(np.count_nonzero(np.concatenate([[True], cid[1:] != cid[:-1]])))
        if path == "kernel":
            want["K3"] = IMFB_ROUNDS * launches_per_call(cid, 1)
            agree = abs(rmse - JAX_IMFB_RMSE) < IMFB_JAX_TOL and abs(rmse - ref_rmse) < IMFB_GOLDEN_TOL
            vs = (f"minus JAX CPU {rmse - JAX_IMFB_RMSE:+.6f}, tol {IMFB_JAX_TOL:g}; minus "
                  f"reference binary {rmse - ref_rmse:+.6f}, tol {IMFB_GOLDEN_TOL:g}")
        else:  # held to the kernel run below, at round IMFB_PLAIN_ROUNDS
            agree = True
            vs = f"minus the kernel run's at that round {rmse - results['kernel']['at'][R]:+.2e}"
        ok = (agree and launches == want and math.isfinite(rmse)
              and type(tr).__name__ == "SVDPPMultiIMFBTrainer")
        if not ok:
            failures.append(f"stacked slice ({path})")
        results[path] = dict(rmse=rmse, at=at, launches=launches, eps=eps)
        print(f"phase 9 {'ok' if ok else 'FAIL'}: multiIMFBStacked path={path} test RMSE after "
              f"{R} rounds {rmse:.6f} ({vs}) launches {launches} (want {want}: "
              f"{R} rounds{', one cooperative launch each' if path == 'kernel' else ''}; "
              f"T={len(cid)}, chunk starts={starts}) "
              f"training {eps:,.0f} examples/s rounds 2-{R} (reference C++ "
              f"{golden['examples_per_sec_cpu']:,}/s), round seconds "
              f"{[round(x, 3) for x in secs]} on {card}", flush=True)
        print(f"phase 9 profile: multiIMFBStacked path={path} one more round: {profile_line}",
              flush=True)
        if path == "kernel":
            share = steady_busy_share(torch, task, train_rounds_imfb_kernel, TRACE_SLOTS,
                                      TRACE_SLOTS - 1, len(cid))
            report_share(9, "multiIMFBStacked", "K3", *share, card, failures)
        shutil.rmtree(d / f"models_{path}")
        del task, tr, entry
    diff = abs(results["kernel"]["at"][IMFB_PLAIN_ROUNDS] - results["plain"]["rmse"])
    if diff >= IMFB_AB_TOL:
        failures.append("stacked slice kernel vs plain")
    print(f"phase 9 {'ok' if diff < IMFB_AB_TOL else 'FAIL'}: K3 against its plain version end "
          f"to end at round {IMFB_PLAIN_ROUNDS}: |d RMSE| {diff:.2e} (tol {IMFB_AB_TOL:g})",
          flush=True)
    return results["kernel"]["launches"]["K3"], results["kernel"]["eps"]


# ---- phase 10: the general route ------------------------------------------------
# Configurations no kernel takes train on the general plain rounds on the
# card (ops/embed.train_rounds, the plain SVD++ rounds), as the JAX package
# trains them on its jnp path.  Test RMSE after GENERAL_ROUNDS rounds, the
# JAX package on the CPU, same data and conf (scripts/general_jax_reference.py).
GENERAL_ROUNDS = 5
GENERAL = {  # name: (demo, its data as phases 3 and 5 wrote it, conf keys)
    "basicMF reg_method=1": ("basicMF", [f"batch_size={BATCH}", "reg_method=1"]),
    "binaryClassification active_type=5": ("binaryClassification",
                                           [f"batch_size={BATCH}", "active_type=5"]),
    "implicitFeedback reg_method=4": ("implicitFeedback",
                                      ["sort_blocks=1", "rows_per_user=8", "reg_method=4"]),
}
JAX_GENERAL_RMSE = {
    "basicMF reg_method=1": 0.979038,
    "binaryClassification active_type=5": 0.538926,
    "implicitFeedback reg_method=4": 0.993561,
}
GENERAL_TOL = {"basicMF reg_method=1": 1e-5, "binaryClassification active_type=5": 1e-5,
               "implicitFeedback reg_method=4": 1e-4}  # SVD++: 1e-4, as phase 5


def general_gate(task):
    """The kernel gate's answer for ``task``'s packed dataset: why K1 (or
    K2) does not take it, or None."""
    from svdfeature_tpu_torch.data.csr import PlusDataset
    from svdfeature_tpu_torch.ops import cuda_embed, cuda_svdpp

    tr, ds = task.trainer, task.dataset
    if isinstance(ds, PlusDataset):
        entry = tr._pack_plus(ds)
        return cuda_svdpp.gate_failure(tr.hp, tr.state, entry.stacked, entry.fb, tr._plus_hyper())
    return cuda_embed.gate_failure(tr.hp, tr.state, tr._pack(ds)[0])


def phase_general(work, card, failures):
    """basicMF at reg_method=1, binaryClassification at active_type=5 and
    implicitFeedback at reg_method=4, GENERAL_ROUNDS rounds each through
    SVDTrainTask / SVDInferTask on the card: the route is the plain rounds
    (no kernel launch), the test RMSE within GENERAL_TOL of the JAX
    package's CPU figure."""
    from svdfeature_tpu_torch.infer.task import SVDInferTask
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    wrappers = kernel_wrappers()
    for name, (demo, extra) in GENERAL.items():
        d = work / demo
        conf = str(ROOT / "demo" / demo / f"{demo}.conf")
        common = [f"buffer_feature={d}/train.buffer", f"test:buffer_feature={d}/test.buffer",
                  f"model_out_folder={d}/models_general", "device=cuda", "silent=1", *extra]
        for fn in wrappers.values():
            fn.launches = 0
        task = SVDTrainTask()
        task.run(conf, common + [f"num_round={GENERAL_ROUNDS}"])
        launches = {kid: fn.launches for kid, fn in wrappers.items()}
        reason = general_gate(task)
        log = d / "rmse_general.tsv"
        SVDInferTask().run(conf, common + [f"start={GENERAL_ROUNDS}",
                                           f"end={GENERAL_ROUNDS + 1}", f"log_eval={log}"])
        rmse = float(log.read_text().split()[-1])
        want = JAX_GENERAL_RMSE[name]
        secs = task.round_seconds
        ok = (math.isfinite(rmse) and abs(rmse - want) < GENERAL_TOL[name]
              and not any(launches.values()) and reason is not None)
        if not ok:
            failures.append(f"general route {name}")
        print(f"phase 10 {'ok' if ok else 'FAIL'}: {name} route plain (the kernel gate: "
              f"{reason}) K1 launches {launches['K1']} K2 launches {launches['K2']} (want 0); "
              f"test RMSE after {GENERAL_ROUNDS} rounds {rmse:.6f} (JAX CPU {want:.6f}, minus "
              f"{rmse - want:+.2e}, tol {GENERAL_TOL[name]:g}); "
              f"{task.dataset_rows() * (len(secs) - 1) / sum(secs[1:]):,.0f} examples/s rounds "
              f"2-{GENERAL_ROUNDS} on {card}", flush=True)


# ---- phase 11: big-table SVD++ and big-table multi-IMFB -------------------------
# Probe RMSE after each run's rounds, the JAX package on the CPU, same data
# and conf (scripts/bigsvdpp_jax_reference.py --run a / c / d; run (b) is
# (a) on the plain writer).  Round 0 (the seeded init) is 0.176005 for all.
JAX_BIG_PLUS_RMSE = {"a": 0.169612, "b": 0.169612, "c": 0.172358, "d": 0.170718}
BIG_PLUS_JAX_TOL = 1e-4
BIG_PLUS_AB_TOL = 1e-5  # (a) K5 against (b) its plain version, end to end


def big_plus_run(conf, d, tag):
    """One phase-11 run through SVDTrainTask + SVDInferTask, every kernel's
    launch count set to 0 just before training and read just after: the
    probe's RMSE at round 0 and at the last round from the checkpoints,
    the K5 launches the plan implies, round seconds, pack seconds, peak
    device memory."""
    import torch

    from svdfeature_tpu_torch.infer.task import SVDInferTask
    from svdfeature_tpu_torch.ops.svdpp_big import k5_launches
    from svdfeature_tpu_torch.solvers.multi_imfb import ImfbEntry
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    run = BIG_PLUS_RUNS[tag]
    R = run["rounds"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trace_log = d / f"trace_{tag}.jsonl"
    args = [f"buffer_feature={d}/{run['buffer']}", f"model_out_folder={d}/models_{tag}",
            "device=cuda", *run["keys"]]
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    task = SVDTrainTask()
    t0 = time.perf_counter()
    task.run(str(conf), args + [f"num_round={R}", "trace=1", f"log_jsonl={trace_log}"])
    launches = {kid: fn.launches for kid, fn in wrappers.items()}
    pack = first_round_pack_s(trace_log)
    tr = task.trainer
    entry = tr._pack_plus(task.dataset)
    cid = entry.chunk_id
    carry = "chunk_users" in entry.fb
    if not tr.hp.row_dma:
        per_round = 0
    elif isinstance(entry, ImfbEntry):
        per_round = 2 * len(cid)  # the step's rows and the contexts' writeback
    else:
        per_round = k5_launches(cid, carry)
    starts = int(np.count_nonzero(np.concatenate([[True], cid[1:] != cid[:-1]])))
    peak = torch.cuda.max_memory_allocated()
    secs = task.round_seconds
    rows = task.dataset_rows()
    log = d / f"rmse_{tag}.tsv"
    step = 1 if tag == "a" else R  # phase 20 holds its mesh run to (a)'s every round
    SVDInferTask().run(str(conf), args + ["start=0", f"end={R + 1}", f"step={step}",
                                          f"log_eval={log}"])
    rmse = {int(r): float(x) for r, x in (line.split() for line in log.read_text().splitlines())}
    shutil.rmtree(d / f"models_{tag}")
    train = secs[1:] if R > 1 else [secs[0] - pack]
    return dict(task=task, entry=entry, rmse=rmse, rmse0=rmse[0], rmse1=rmse[R],
                launches=launches, want_k5=R * per_round, T=len(cid), starts=starts, carry=carry,
                trainer=type(tr).__name__, big=bool(tr.hp.big_table), secs=secs,
                pack=pack, eps=rows * len(train) / sum(train), peak=peak,
                seconds=time.perf_counter() - t0, R=R)


def k5_shapes(torch, task):
    """K5's arguments at this slice's three call shapes, from one real
    epoch of run (a): the first step's item write (E = G*M), then the first
    chunk exit's pool writeback (E = F) and slab write (E = G).  The epoch
    runs on the trained state with big_embed.row_writer recording its
    calls until the first slab write."""
    from svdfeature_tpu_torch.ops import big_embed

    tr = task.trainer
    G = tr.users_per_batch
    calls, real = [], big_embed.row_writer

    def recorder(w, idx, vals):
        if len(calls) < 2 or calls[-1][0].shape[0] != G:
            calls.append((idx.clone(), vals.clone()))
        return real(w, idx, vals)

    big_embed.row_writer = recorder
    try:
        tr.update_all(task.dataset)
    finally:
        big_embed.row_writer = real
    torch.cuda.synchronize()
    item, pool, slab = calls[0], calls[-2], calls[-1]
    return {"item write": item, "pool writeback": pool, "slab write": slab}


def phase_big_plus(work, card, failures):
    """bigSvdpp (bench.py's KDD-Cup-2011-geometry SVD++, numpy only) and big
    multi-IMFB through the port's entry points: (a) the user-carry epoch
    with K5, (b) the same with use_pallas=0, (c) reg_method=4 (the
    entry-stream body, lazy decay), (d) the depth-2 transform of the first
    20,000 users under extend_type=2.  Gates: the probe RMSE falls and lies
    within BIG_PLUS_JAX_TOL of the JAX package's figure, (a) and (b) agree
    within BIG_PLUS_AB_TOL, K5's launch count is the plan's; then K5 bit for
    bit against its plain version at the three call shapes of (a)'s epoch,
    timed in turns with index_copy_."""
    import torch

    from svdfeature_tpu_torch.data import csr
    from svdfeature_tpu_torch.data.buffer import write_plus_buffer
    from svdfeature_tpu_torch.ops import cuda_scatter

    d = work / "bigSvdpp"
    d.mkdir()
    t0 = time.perf_counter()
    arrays, dims = big_plus_arrays()
    conf = write_big_plus(d, csr, write_plus_buffer, arrays, dims)
    n = dims["NU"] + dims["NI"] + dims["NF"] + 1
    print(f"phase 11: bigSvdpp data ({dims['EX']:,} rows of {BIG_PLUS['USERS']:,} users, table "
          f"{n:,} rows, k={dims['KF']}) written in {time.perf_counter() - t0:.1f} s", flush=True)
    del arrays
    ref_eps = json.loads((ROOT / "golden" / "GOLDEN.json").read_text())["bigSvdpp"]["examples_per_sec_cpu"]
    results = {}
    for tag in BIG_PLUS_RUNS:
        r = big_plus_run(conf, d, tag)
        results[tag] = r
        want = {kid: 0 for kid in r["launches"]}
        want["K5"] = r["want_k5"]
        jax = JAX_BIG_PLUS_RMSE[tag]
        ok = (r["launches"] == want and r["big"] and r["rmse1"] < r["rmse0"]
              and math.isfinite(r["rmse1"]) and abs(r["rmse1"] - jax) < BIG_PLUS_JAX_TOL
              and r["carry"] == (tag in ("a", "b"))
              and r["trainer"] == ("SVDPPMultiIMFBTrainer" if tag == "d" else "SVDPPFeatureTrainer"))
        if not ok:
            failures.append(f"bigSvdpp run ({tag})")
        body = "user-carry" if r["carry"] else ("stacked refresh" if tag == "d" else "entry-stream")
        plan = (f"2 x T={r['T']}" if tag == "d" else
                f"T={r['T']} + {2 if r['carry'] else 1} x {r['starts']} chunk exits") + " a round"
        print(f"phase 11 {'ok' if ok else 'FAIL'}: bigSvdpp ({tag}) {' '.join(BIG_PLUS_RUNS[tag]['keys']) or 'default'} "
              f"{r['trainer']} {body} body through SVDTrainTask/SVDInferTask: probe RMSE "
              f"{r['rmse0']:.6f} -> {r['rmse1']:.6f} after {r['R']} rounds (minus JAX CPU "
              f"{r['rmse1'] - jax:+.6f}, tol {BIG_PLUS_JAX_TOL:g}); launches {r['launches']} "
              f"(want K5 {want['K5']} = {r['R']} rounds x ({plan})); training "
              f"{r['eps']:,.0f} examples/s {'rounds 2-' + str(r['R']) if r['R'] > 1 else 'round 1 less packing'} "
              f"(reference C++ {ref_eps:,}/s); pack {r['pack']:.2f} s (round 1); round seconds "
              f"{[round(x, 3) for x in r['secs']]}; peak device memory {r['peak'] / 2**30:.2f} GiB; "
              f"run {r['seconds']:.1f} s; on {card}", flush=True)
        if tag == "a":
            task = r["task"]
            print(f"phase 11 profile: bigSvdpp (a) one more round: "
                  f"{device_profile(torch, lambda: task.trainer.update_all(task.dataset), r['T'], top=8)}",
                  flush=True)
            shapes = k5_shapes(torch, task)
            w = task.trainer.state.w
            # chunk 0's pool, what phase 20 times K5's mesh pool writeback on
            pool = {k: r["entry"].fb[k][0].cpu() for k in ("fb_idx", "fb_val", "fb_block")}
            del task
        if tag == "d":
            # K5's two calls a step of the stacked big epoch: the step's
            # rows, then the contexts' writeback
            task = r["task"]
            shapes_d = k5_first_calls(torch, lambda: task.trainer.update_all(task.dataset),
                                      {0: "step rows", 1: "context writeback"})
            w_d = task.trainer.state.w
            del task
        if tag != "a":
            del r["task"], r["entry"]
    del results["a"]["task"], results["a"]["entry"]
    diff = abs(results["a"]["rmse1"] - results["b"]["rmse1"])
    if diff >= BIG_PLUS_AB_TOL:
        failures.append("bigSvdpp (a) vs (b)")
    print(f"phase 11 {'ok' if diff < BIG_PLUS_AB_TOL else 'FAIL'}: bigSvdpp K5 (a) against its "
          f"plain version (b) end to end: |d RMSE| {diff:.2e} (tol {BIG_PLUS_AB_TOL:g})", flush=True)

    # K5 at the slice's call shapes, on the trained tables
    timing = time_k5_shapes(torch, 11, "bigSvdpp (a)", w, shapes, card, failures)
    timing.update(time_k5_shapes(torch, 11, "bigSvdpp (d)", w_d, shapes_d, card, failures))
    del w, shapes, w_d, shapes_d
    torch.cuda.empty_cache()
    # what phase 20 holds its mesh runs to: (a)'s probe RMSE every round, the
    # steps a round of (a) and (d), (a)'s chunk-0 pool
    prior = dict(rmse=results["a"]["rmse"], T={"b": results["a"]["T"], "e": results["d"]["T"]},
                 pool=pool)
    return sum(r["launches"]["K5"] for r in results.values()), timing, results["a"]["eps"], prior


def time_k5_shapes(torch, phase, run, w, shapes, card, failures):
    """K5 bit for bit against its plain version on table ``w`` at each
    recorded call shape of ``run`` (``shapes``: name -> (idx, vals)), and
    its time per call beside the plain version's, index_copy_'s and the
    bound, in turns on the same table."""
    from svdfeature_tpu_torch.ops import cuda_scatter

    W = w.shape[1]
    timing = {}
    for name, (idx, vals) in shapes.items():
        E = idx.shape[0]
        U = int(torch.unique(idx).numel())  # rows written, the dummy included
        got = cuda_scatter.row_writer(w.clone(), idx, vals)
        want = cuda_scatter.row_writer_reference(w.clone(), idx, vals)
        ok = torch.equal(got, want) and bool((got[-1] == 0).all())
        err = float((got - want).abs().max())
        del got, want
        work_tbl = w.clone()
        idx_long = idx.long()
        spread = {}
        t = timed(torch, {"plain": lambda: cuda_scatter.row_writer_reference(work_tbl, idx, vals),
                          "kernel": lambda: cuda_scatter.row_writer(work_tbl, idx, vals),
                          "library": lambda: work_tbl.index_copy_(0, idx_long, vals)},
                  inner=50, turns=5, spread=spread)
        t["bound"], t["bound_by"] = bound(4 * (E + E * W + U * W), 0, 1)
        t["err"] = err
        timing[f"{run} {name}"] = t
        del work_tbl
        if not ok:
            failures.append(f"K5 vs plain at {run}'s {name}")
        print(f"phase {phase} {'ok' if ok else 'FAIL'}: K5 at {run}'s {name} E={E} rows "
              f"({U} distinct targets) bit for bit against its plain version; ms per call kernel "
              f"{t['kernel']:.4f} plain {t['plain']:.4f} library (index_copy_) {t['library']:.4f} "
              f"bound {t['bound']:.6f} ({t['bound_by']}); spread between turns kernel "
              f"{spread['kernel']:.4f} library {spread['library']:.4f} on {card}", flush=True)
    return timing


def k5_first_calls(torch, run_epoch, names):
    """K5's arguments at its first calls in ``run_epoch()``, named by
    ``names`` (index -> name): big_embed.row_writer records its calls
    until the last index named."""
    from svdfeature_tpu_torch.ops import big_embed

    calls, real = [], big_embed.row_writer
    last = max(names)

    def recorder(w, idx, vals):
        if len(calls) <= last:
            calls.append((idx.clone(), vals.clone()))
        return real(w, idx, vals)

    big_embed.row_writer = recorder
    try:
        run_epoch()
    finally:
        big_embed.row_writer = real
    torch.cuda.synchronize()
    return {name: calls[i] for i, name in names.items()}


# ---- phases 12-14: pairwise ranking ------------------------------------------------
# bigRank run (a)'s probe order accuracy and mean raw margin, the JAX
# package on the CPU, same data, conf and per-round pair stream
# (scripts/rank_jax_reference.py --big)
JAX_BIG_RANK = {"acc": 1.0, "margin": 0.070162}
BIG_RANK_JAX_TOL = 1e-4  # on both
BIG_RANK_MIN_ACC = 0.75  # bench.py:1043


def rank_task(d, keys):
    """An SVDTrainTask of the pairwiseRank demo configured and initialised
    (trainer and PairSource, no round trained), models into ``d``."""
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    task = SVDTrainTask()
    task.configure(str(ROOT / "demo" / "pairwiseRank" / "pairwiseRank.conf"), keys)
    task.init()
    return task


def clone_state(st):
    return type(st)(**{f: getattr(st, f).clone() for f in st.__dataclass_fields__})


def phase_pair_kernel(torch, d, keys, card, failures):
    """K2 on per-round pair planes at the pairwiseRank demo's shapes: the
    skeleton of the ML-100K rank train set (64 users x 8 rows a step, item
    width 2), PAIR_R freshly sampled rounds in one call, against its plain
    version; one launch a call, again on the same tensors (the kept plan);
    both times per step and the bound; and the cost of the wrapper's check
    of a round's fresh planes (one host sync), per round."""
    from svdfeature_tpu_torch.ops import cuda_svdpp

    task = rank_task(d, keys + ["device=cuda"])
    tr, src = task.trainer, task.dataset
    tr._apply_pair_layout()
    sk = tr._pair_skeleton(src)
    dev = tr.state.w.device

    def planes(R):
        flats = [tr._pair_flats(src, sk) for _ in range(R)]
        fp = torch.from_numpy(np.concatenate([f[0] for f in flats])).to(dev)
        fn = torch.from_numpy(np.concatenate([f[1] for f in flats])).to(dev)
        return tr._pair_stacked(sk, fp, fn)

    stacked = planes(PAIR_R)
    lrs = torch.full((PAIR_R,), 0.005, device=dev)
    rest = (sk["chunk_id"], sk["fb"], sk["overlap"], lrs, tr.consts, tr.hp, tr._plus_hyper())
    kern, ref = cuda_svdpp.train_rounds_svdpp_kernel, cuda_svdpp.train_rounds_svdpp_reference
    st0 = clone_state(tr.state)
    T, GS = sk["T"], sk["GS"]
    shape = (f"T={T} steps, GS={GS} = {sk['G']} users x {sk['M']} rows, item width 2, "
             f"C={sk['fb']['fb_idx'].shape[0]}, F={sk['fb']['fb_idx'].shape[1]}")

    # (i) the first two rounds' planes: the kernel within ATOL + RTOL of its
    # plain version, one launch
    head = dict(stacked, **{p: stacked[p][: 2 * T] for p in cuda_svdpp.ROUND_PLANES})
    rest2 = (*rest[:3], lrs[:2], *rest[4:])
    before = kern.launches
    got = kern(clone_state(st0), head, *rest2)
    torch.cuda.synchronize()
    launched2 = kern.launches - before
    want = ref(clone_state(st0), head, *rest2)
    errs = {}
    ok = sk["use_kernel"] and launched2 == 1 and int(got.step) == int(want.step)
    for name in ("w", "b"):
        a, b = getattr(got, name), getattr(want, name)
        errs[name] = float((a - b).abs().max())
        ok &= bool(torch.isfinite(a).all()) and bool(((a - b).abs() <= ATOL + RTOL * b.abs()).all())
    if not ok:
        failures.append("K2 on per-round pair planes vs plain, R=2")
    print(f"phase 12 {'ok' if ok else 'FAIL'}: K2 on per-round pair planes (R=2 rounds x {shape}) "
          f"against its plain version: max|dw|={errs['w']:.3e} max|db|={errs['b']:.3e} (atol "
          f"{ATOL:g} + rtol {RTOL:g}) launches {launched2} (one cooperative launch)", flush=True)

    # (ii) PAIR_R rounds (a multi-path block) in one call, twice on the same
    # tensors (the kept plan).  Over more rounds the f32 trajectories of any
    # two summation orders part by more than ATOL: the kernel is held to the
    # plain version run in f64, no further from it than PAIR_NOISE times the
    # plain version in f32 is
    launched = []
    for _ in range(2):
        before = kern.launches
        k_state = kern(clone_state(st0), stacked, *rest)
        torch.cuda.synchronize()
        launched.append(kern.launches - before)
    p32 = ref(clone_state(st0), stacked, *rest)
    f64 = lambda x: ({k: f64(v) for k, v in x.items()} if isinstance(x, dict) else  # noqa: E731
                     x.double() if torch.is_tensor(x) and x.is_floating_point() else x)
    consts64 = type(tr.consts)(**{f: f64(getattr(tr.consts, f))
                                  for f in tr.consts.__dataclass_fields__})
    st64 = type(st0)(**{f: f64(getattr(st0, f)).clone() for f in st0.__dataclass_fields__})
    p64 = ref(st64, f64(stacked), sk["chunk_id"], f64(sk["fb"]), f64(sk["overlap"]), lrs.double(),
              consts64, tr.hp, tr._plus_hyper())
    ok = launched == [1, 1] and int(k_state.step) == int(p32.step)
    dist = {}
    for name in ("w", "b"):
        ref64 = getattr(p64, name)
        dist[name] = tuple(float((getattr(x, name).double() - ref64).abs().max())
                           for x in (k_state, p32))
        ok &= bool(torch.isfinite(getattr(k_state, name)).all())
        ok &= dist[name][0] <= PAIR_NOISE * dist[name][1]
    kp = {name: float((getattr(k_state, name) - getattr(p32, name)).abs().max()) for name in "wb"}
    if not ok:
        failures.append(f"K2 on per-round pair planes vs plain, R={PAIR_R}")
    print(f"phase 12 {'ok' if ok else 'FAIL'}: K2 on per-round pair planes (R={PAIR_R} rounds x "
          f"{shape}), two calls on the same tensors: launches {launched} (one cooperative launch "
          f"a call); max distance from the plain version in f64: kernel w {dist['w'][0]:.3e} b "
          f"{dist['b'][0]:.3e}, plain f32 w {dist['w'][1]:.3e} b {dist['b'][1]:.3e} (the kernel's "
          f"at most {PAIR_NOISE:g} x the plain f32's); kernel against plain f32 max|dw|="
          f"{kp['w']:.3e} max|db|={kp['b']:.3e}", flush=True)
    del p64, st64

    # times per step, in turns, each path on its own state call after call:
    # the kernel on the PAIR_R rounds' planes, the plain version (whose cost
    # a step does not depend on the rounds a call holds) on the first two's
    samples = {"plain": [], "kernel": []}
    held = {"plain": clone_state(st0), "kernel": clone_state(st0)}
    calls = {"plain": (ref, head, rest2, 2), "kernel": (kern, stacked, rest, PAIR_R)}
    for name in ("plain", "kernel", "plain", "kernel", "kernel", "plain"):
        fn, stk, args, R = calls[name]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        held[name] = fn(held[name], stk, *args)
        end.record()
        torch.cuda.synchronize()
        samples[name].append(start.elapsed_time(end) / (R * T))
    timing = {n: float(np.median(v[1:])) for n, v in samples.items()}
    cpu = lambda a: a.cpu().numpy() if torch.is_tensor(a) else a  # noqa: E731
    x = dict(st={"w": cpu(st0.w)}, stacked={k: cpu(v) for k, v in stacked.items()},
             fb={k: cpu(v) for k, v in sk["fb"].items()}, overlap=cpu(sk["overlap"]),
             chunk_id=sk["chunk_id"], lrs=np.zeros(PAIR_R), M=sk["M"])
    timing["bound"], timing["bound_by"] = svdpp_bound(x)
    # the check of a round's fresh planes: what the per-round path pays a round
    checks = []
    lr1 = lrs[:1]
    for _ in range(8):
        fresh = planes(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cuda_svdpp._plan(held["kernel"], fresh, sk["chunk_id"], sk["fb"], sk["overlap"], lr1,
                         tr.consts, sk["M"])
        checks.append(time.perf_counter() - t0)
    timing["check_ms"] = float(np.median(checks)) * 1e3
    print(f"phase 12 time: pair planes ms per step (median of 2 calls in turns, the kernel's of "
          f"R={PAIR_R} rounds, the plain version's of 2): "
          f"kernel {timing['kernel']:.4f} plain {timing['plain']:.4f} bound {timing['bound']:.6f} "
          f"({timing['bound_by']}); the check of one round's fresh planes {timing['check_ms']:.3f} "
          f"ms (median of 8, host clock, one host sync), a round being {T} steps, on {card}",
          flush=True)
    print(f"phase 12 profile: pair planes path=kernel "
          f"{device_profile(torch, lambda: kern(held['kernel'], stacked, *rest), PAIR_R * T)}",
          flush=True)
    return max(errs.values()), timing


def rank_run(d, keys, tag, extra, rounds_call, rounds=RANK_ROUNDS, also=None):
    """One pairwiseRank run: the tasks' trainer on the card, every kernel's
    launch count set to 0 just before training and read just after, the
    model of round ``rounds`` saved, SVDInferTask pred with the ranker,
    and P@20.  ``rounds_call`` None trains through SVDTrainTask.run (one
    update_all a round, a save after each; ``also``: one more round whose
    pred and P@20 are kept); else the trainer's update_rounds(src, rounds)
    in one call (timed, synchronised), then one more call timed on the
    trained trainer (steady: no set-up)."""
    from svdfeature_tpu_torch.infer.task import SVDInferTask
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    conf = str(ROOT / "demo" / "pairwiseRank" / "pairwiseRank.conf")
    args = keys + [f"model_out_folder={d}/models_{tag}", "device=cuda", *extra]
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    steady = None
    if rounds_call is None:
        task = SVDTrainTask()
        t0 = time.perf_counter()
        task.run(conf, args + [f"num_round={rounds}"])
        launches = {kid: fn.launches for kid, fn in wrappers.items()}
        secs = task.round_seconds
        train_s = sum(secs[1:])
        rounds_timed = len(secs) - 1
    else:
        task = rank_task(d, args)
        tr = task.trainer
        t0 = time.perf_counter()
        tr.update_rounds(task.dataset, rounds)
        tr.synchronize()
        train_s = time.perf_counter() - t0
        launches = {kid: fn.launches for kid, fn in wrappers.items()}
        rounds_timed = rounds
        task.start_counter = rounds
        task.save_model()
    pred = d / f"pred_{tag}.txt"
    SVDInferTask().run(conf, args + [f"pred={rounds}", f"name_pred={pred}"])
    at = {}
    if also is not None:
        at["pred"] = d / f"pred_{tag}_{also}.txt"
        SVDInferTask().run(conf, args + [f"pred={also}", f"name_pred={at['pred']}"])
        at["p20"] = rank_p20(at["pred"])
    if rounds_call is not None:
        t1 = time.perf_counter()
        task.trainer.update_rounds(task.dataset, rounds)
        task.trainer.synchronize()
        steady = time.perf_counter() - t1
    pairs = int(task.dataset.pair_geometry()["jp"].shape[0])
    shutil.rmtree(d / f"models_{tag}")
    return dict(p20=rank_p20(pred), pred=pred, at=at, launches=launches, pairs=pairs,
                pps=pairs * rounds_timed / train_s, rounds_timed=rounds_timed,
                pps_steady=None if steady is None else pairs * rounds / steady,
                T=task.trainer._pair_sk["T"], seconds=time.perf_counter() - t0)


def phase_rank_slice(d, keys, card, failures):
    """pairwiseRank through the port's entry points: (kernel) SVDTrainTask
    40 rounds, one K2 launch a round on the round's fresh pairs, then
    SVDInferTask pred=40 with the ranker (and pred=RANK_PLAIN_ROUNDS);
    (plain) the same with use_pallas=0 for RANK_PLAIN_ROUNDS rounds;
    (multi) update_rounds(src, 40) on the multi-round host sampler, 5 K2
    launches (blocks of 8 rounds); (device) rank_device_sample=1, one K2
    launch for the 40 rounds.  Gates: P@20 after 40 rounds within
    RANK_P20_TOL of the golden, the kernel run within RANK_JAX_TOL of the
    JAX package's CPU figure, the plain run within RANK_JAX_TOL of the
    kernel run at round RANK_PLAIN_ROUNDS, exact launch counts."""
    from svdfeature_tpu_torch.solvers.svdpp import SVDPPFeatureTrainer

    golden = json.loads((ROOT / "golden" / "GOLDEN.json").read_text())["pairwiseRank"]
    ref_s = golden["train_seconds_40rounds_cpu"]
    blocks = -(-RANK_ROUNDS // SVDPPFeatureTrainer.PAIR_BLOCK_ROUNDS)
    runs = {  # tag: conf keys, trains through update_rounds, K2 launches wanted, how
        "kernel": ([], None, RANK_ROUNDS, f"{RANK_ROUNDS} rounds, one launch each"),
        "plain": (["use_pallas=0"], None, 0, "the plain rounds"),
        "multi": ([], True, blocks, f"{blocks} blocks of "
                  f"{SVDPPFeatureTrainer.PAIR_BLOCK_ROUNDS} rounds, one launch each"),
        "device": (["rank_device_sample=1"], True, 1, "all rounds in one launch"),
    }
    out, launches = {}, 0
    for tag, (extra, multi, want, how) in runs.items():
        plain = tag == "plain"
        r = rank_run(d, keys, tag, extra, multi, RANK_PLAIN_ROUNDS if plain else RANK_ROUNDS,
                     RANK_PLAIN_ROUNDS if tag == "kernel" else None)
        out[tag] = r
        launches += r["launches"]["K2"]
        want_all = {kid: 0 for kid in r["launches"]}
        want_all["K2"] = want
        ok = r["launches"] == want_all
        jax_line = ""
        if plain:
            ref = out["kernel"]["at"]["p20"]
            ok &= abs(r["p20"] - ref) < RANK_JAX_TOL
            vs = (f"P@20 {r['p20']:.4f} after {RANK_PLAIN_ROUNDS} rounds (minus the kernel run's "
                  f"at that round {r['p20'] - ref:+.6f}, tol {RANK_JAX_TOL:g})")
        else:
            ok &= abs(r["p20"] - golden["precision_at_20"]) < RANK_P20_TOL
            vs = f"P@20 {r['p20']:.4f} (golden {golden['precision_at_20']}, tol {RANK_P20_TOL:g}"
        if tag == "kernel":
            ok &= JAX_RANK_P20 is not None and abs(r["p20"] - JAX_RANK_P20) < RANK_JAX_TOL
            jax_line = (f"; minus JAX CPU {r['p20'] - JAX_RANK_P20:+.6f} (tol {RANK_JAX_TOL:g})"
                        if JAX_RANK_P20 is not None else "; no JAX CPU figure")
        if not ok:
            failures.append(f"pairwiseRank ({tag})")
        ref_pps = r["pairs"] * 40 / ref_s
        timed_how = (f"rounds 2-{r['rounds_timed'] + 1}, saves excluded" if multi is None else
                     f"the {RANK_ROUNDS}-round call with its set-up; {r['pps_steady']:,.0f} pairs/s "
                     f"for {RANK_ROUNDS} more rounds in one call")
        vs += "" if plain else f"{jax_line})"
        print(f"phase 13 {'ok' if ok else 'FAIL'}: pairwiseRank ({tag}) {vs}; launches "
              f"{r['launches']} (want K2 {want}: {how}; T={r['T']} steps a round); "
              f"{r['pairs']:,} pairs a round (examples/s of SVDTrainTask count the "
              f"{RANK_USERS}-user set's rows); {r['pps']:,.0f} pairs/s ({timed_how}; reference "
              f"binary {ref_pps:,.0f} pairs/s: 40 rounds in {ref_s} s); run "
              f"{r['seconds']:.1f} s; on {card}", flush=True)
    # the per-round path's host work a round: one epoch's sample placed on the
    # grid (PairSource.epoch_pairs, the producer thread's work)
    task = rank_task(d, keys + ["device=cuda"])
    task.trainer._apply_pair_layout()
    sk = task.trainer._pair_skeleton(task.dataset)
    samp = []
    for _ in range(5):
        t0 = time.perf_counter()
        task.trainer._pair_flats(task.dataset, sk)
        samp.append(time.perf_counter() - t0)
    print(f"phase 13: pairwiseRank host sampling of one epoch (epoch_pairs and the slot "
          f"placement, the per-round path's producer thread): {np.median(samp) * 1e3:.1f} ms "
          f"(median of 5, host clock); K2's round is {sk['T']} steps; on {card}", flush=True)
    del task, sk
    a = out["kernel"]["at"]["pred"].read_text().split()
    b = out["plain"]["pred"].read_text().split()
    differ = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    print(f"phase 13: pairwiseRank pred.txt of the kernel run against the plain run at round "
          f"{RANK_PLAIN_ROUNDS}: {differ} of {len(a)} rank positions differ (P@20 "
          f"{out['kernel']['at']['p20']:.4f} against {out['plain']['p20']:.4f})", flush=True)
    return launches


def phase_big_rank(torch, card, failures):
    """bigRank (bench.py's KDD-Cup-geometry rank workload, numpy only:
    1,000,000 users, 624,000 items, 624,000 feedback ids, k=64, 25,000
    users x 80 rows, 1.5M pairs a round) on the trainer at bench.py's
    conf (2048 users x 8 pairs a step): (a) update_all twice, the per-round
    path's entry-stream big epoch, K5; (b) update_rounds(src, 8), one
    block of the multi path, the user-carry body from the candidate
    plan, K5.  Gates: (a)'s probe accuracy and mean margin within
    BIG_RANK_JAX_TOL of the JAX package's CPU figures, (b)'s accuracy
    above BIG_RANK_MIN_ACC, K5's launch
    counts the plan's; K5 at each run's call shapes against its plain
    version, timed."""
    from svdfeature_tpu_torch.data import csr, rank, registry
    from svdfeature_tpu_torch.ops.svdpp_big import k5_launches
    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.svdpp import SVDPPFeatureTrainer

    t0 = time.perf_counter()
    arrays, dims = big_rank_arrays()
    full = plus_dataset(csr, arrays)
    n = dims["NU"] + dims["NI"] + dims["NF"] + 1
    print(f"phase 14: bigRank data ({dims['EX']:,} rows of {BIG_RANK['USERS']:,} users, table "
          f"{n:,} rows, k={dims['KF']}) made in {time.perf_counter() - t0:.1f} s", flush=True)
    ref_pps = json.loads((ROOT / "golden" / "GOLDEN.json").read_text())["bigRank"]["examples_per_sec_cpu"]
    head, pairs = big_rank_probe_set(csr, rank, registry, arrays)
    wrappers = kernel_wrappers()
    total_k5, timing = 0, {}
    for tag, run in BIG_RANK_RUNS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        tr = big_rank_trainer(SVDPPFeatureTrainer, SVDTypeParam, dims, [("device", "cuda")])
        src = rank.PairSource(full, registry.IteratorConfig(), seed=10)
        R = run["rounds"]
        for fn in wrappers.values():
            fn.launches = 0
        secs = []
        if run["path"] == "per-round":
            for _ in range(R):
                t1 = time.perf_counter()
                tr.update_all(src)
                tr.synchronize()
                secs.append(time.perf_counter() - t1)
        else:
            t1 = time.perf_counter()
            tr.update_rounds(src, R)
            tr.synchronize()
            secs.append(time.perf_counter() - t1)
        launches = {kid: fn.launches for kid, fn in wrappers.items()}
        sk = tr._pair_sk
        carry = "chunk_users" in sk["fb"]
        want = {kid: 0 for kid in launches}
        want["K5"] = R * k5_launches(sk["chunk_id"], carry)
        acc, margin = big_rank_probe(tr, head)
        peak = torch.cuda.max_memory_allocated()
        ok = (launches == want and tr.hp.big_table and carry == (tag == "b")
              and math.isfinite(acc))
        if tag == "a":
            jax = JAX_BIG_RANK or {}
            ok &= bool(jax) and all(abs(got - jax[key]) < BIG_RANK_JAX_TOL
                                    for key, got in (("acc", acc), ("margin", margin)))
            gate = (f"minus JAX CPU {acc - jax['acc']:+.6f}, margin minus JAX CPU "
                    f"{margin - jax['margin']:+.6f} (tol {BIG_RANK_JAX_TOL:g} on both)"
                    if jax else "no JAX CPU figure")
            pps = pairs * (R - 1) / sum(secs[1:])
            timed_how = f"rounds 2-{R}, each synchronised"
        else:
            ok &= acc > BIG_RANK_MIN_ACC
            gate = f"above {BIG_RANK_MIN_ACC} wanted"
            t1 = time.perf_counter()  # one more block: no skeleton or geometry to build
            tr.update_rounds(src, R)
            tr.synchronize()
            pps = pairs * R / (time.perf_counter() - t1)
            timed_how = (f"one more block of {R} rounds in one call; the first, with the "
                         f"skeleton and the geometry, {pairs * R / secs[0]:,.0f}")
        if not ok:
            failures.append(f"bigRank run ({tag})")
        total_k5 += launches["K5"]
        exits = int(np.count_nonzero(np.concatenate([[True], np.diff(sk["chunk_id"]) != 0])))
        print(f"phase 14 {'ok' if ok else 'FAIL'}: bigRank ({tag}) {run['path']} path, "
              f"{'user-carry' if carry else 'entry-stream'} big epoch, {R} rounds: probe order "
              f"accuracy {acc:.6f}, mean margin {margin:.6f} ({gate}); launches {launches} "
              f"(want K5 {want['K5']} = {R} "
              f"rounds x (T={len(sk['chunk_id'])} + {2 if carry else 1} x {exits} chunk exits)); "
              f"{pairs:,} pairs a round; {pps:,.0f} pairs/s ({timed_how}; reference binary "
              f"{ref_pps:,}/s); round seconds {[round(x, 3) for x in secs]}; peak device memory "
              f"{peak / 2**30:.2f} GiB; run {time.perf_counter() - t_run:.1f} s; on {card}",
              flush=True)
        # K5 at this run's call shapes: the first chunk's step writes, then
        # its exit's pool writeback (and with the carry the slab write)
        run0 = int(np.argmax(sk["chunk_id"] != sk["chunk_id"][0])) or len(sk["chunk_id"])
        names = {0: "step write" if not carry else "item write", run0: "pool writeback"}
        if carry:
            names[run0 + 1] = "slab write"
        epoch = (lambda: tr.update_all(src)) if tag == "a" else (lambda: tr.update_rounds(src, 1))
        shapes = k5_first_calls(torch, epoch, names)
        timing.update(time_k5_shapes(torch, 14, f"bigRank ({tag})", tr.state.w, shapes, card,
                                     failures))
        del tr, src, shapes
    return total_k5, timing


# ---- phases 15-16: the shared feedback space and the bilinear solver ---------------
# Test RMSE after each run's rounds (run d: the probe's), the JAX package on
# the CPU, same data and conf: scripts/refresh_jax_reference.py --run a|b and
# scripts/bilinear_jax_reference.py --run b|c|d.
JAX_REFRESH_RMSE = {"a": 1.001765, "b": 1.010718}
JAX_BILINEAR_RMSE = {"b": 0.999921, "c": 0.997885, "d": 0.167179}
REFRESH_JAX_TOL = 1e-4
BI_JAX_TOL = 1e-4
BI_GOLDEN_TOL = 0.01  # tests/test_golden_full.py:173-181, against golden/bilinear.rmse.tsv
BI_AB_TOL = 1e-6  # (a) against the port's plain SVD++ run, every round


# phase 18: out-of-core training (streaming=1).  Each run reads a buffer
# that an earlier phase wrote a chunk at a time through SVDTrainTask, and
# its test set a chunk at a time through SVDInferTask.  tag: the phase that
# wrote its data and its directory, conf keys beside its conf's, rounds,
# the test set's chunk.  (a) and (c) cut bigTable's 2^21 rows into chunks of
# whole batches (BIG_FILE_BATCH), so they follow phase 7's staged runs;
# (b), (d) and (e) sort within chunks or carry contexts across them; (g)'s
# chunks end at the ends of make_feature_buffer's blocks of 1000 rows, so
# its batches differ from phase 3's (gated on the GOLDEN band).
STREAM_RUNS = {
    "g": dict(phase=3, data="basicMF", rounds=ROUNDS, test_chunk=4096,
              keys=[f"batch_size={BATCH}", "stream_chunk=16384"]),
    "a": dict(phase=7, data="bigTable", rounds=BIG_ROUNDS, test_chunk=2048,
              keys=["batch_size=1048576", "stream_chunk=1048576"]),
    "c": dict(phase=7, data="bigTable", rounds=BIG_ROUNDS, test_chunk=2048,
              keys=["batch_size=4096", "stream_chunk=524288"]),
    "b": dict(phase=5, data="implicitFeedback", rounds=ROUNDS, test_chunk=256,
              keys=[*BAND_KEYS, "stream_chunk=256"]),
    "d": dict(phase=11, data="bigSvdpp", rounds=1, test_chunk=1024, keys=["stream_chunk=32768"]),
    "e": dict(phase=9, data="multiIMFBStacked", rounds=IMFB_ROUNDS, test_chunk=256,
              keys=["extend_type=2", "rows_per_user=8", "stream_chunk=512"]),
}
STREAM_PREFETCH = 2  # the depth of data/streaming.py's chunk queue (its default)
# the JAX package's streamed runs on the CPU, same data, conf and chunks
# (scripts/streaming_jax_reference.py --run b|d|e): the test RMSE after the
# last round ((b), (e)) and the probe's ((d))
JAX_STREAM_RMSE = {"b": 0.949836, "d": 0.172368, "e": 0.952257}
STREAM_JAX_TOL = 1e-4
STREAM_STAGED_TOL = 1e-5  # (a) against phase 7 (a)'s staged probe


def stream_task_args(tag, d):
    """(conf, arguments) of phase 18's run ``tag`` on the buffers in ``d``,
    the directory of the phase that wrote them."""
    run = STREAM_RUNS[tag]
    if run["data"] == "bigTable":
        conf, buffers = d / "bigTable.conf", []
    elif run["data"] == "basicMF":
        conf = ROOT / "demo" / "basicMF" / "basicMF.conf"
        buffers = [f"buffer_feature={d}/train.buffer", f"test:buffer_feature={d}/test.buffer"]
    elif run["data"] == "bigSvdpp":
        conf, buffers = d / "bigSvdpp.conf", [f"buffer_feature={d}/train.buffer"]
    else:
        conf = ROOT / "demo" / "implicitFeedback" / "implicitFeedback.conf"
        buffers = [f"buffer_feature={d}/train.buffer", f"test:buffer_feature={d}/test.buffer"]
    return conf, [*buffers, *run["keys"], "streaming=1", "test:streaming=1",
                  f"test:stream_chunk={run['test_chunk']}"]


def stream_evals(tag):
    """The SVDInferTask span of run ``tag``: rounds 0 and R for a probe
    (bigTable, bigSvdpp), the last round for a test set."""
    R = STREAM_RUNS[tag]["rounds"]
    return ["start=0", f"end={R + 1}", f"step={R}"] if tag in "acd" else [f"start={R}", f"end={R + 1}"]


# phase 17: GBRT.  (a) RegGBRT (extend_type=31) on the implicitFeedback
# workload at the reference binary's recorded tree parameters (the keys of
# tests/test_golden_full.py:191-220 beside implicitFeedback.conf, which holds
# its BASIC keys), GBRT_ROUNDS rounds (the golden's first: each host fit
# takes seconds), every round's test RMSE against
# golden/gbrt_reg.rmse.tsv; (b) the walk of that 2-tree model over the
# training set on the card and on the host; (c) APLambda (extend_type=30,
# the settings of tests/test_gbrt.py:193-205) on the pairwiseRank training
# set read as plain user-group data (input_type=0), 2 rounds, its scores of
# the implicitFeedback test set (the same users, items and feedback ids;
# the rank test file is the ranker's protocol, not rows) against the JAX
# package's CPU run.
GBRT_TREE_KEYS = ["num_spec_sparse=943", "learning_rate=0.3", "min_split_loss=1",
                  "min_split_instance=100", "min_child_instance=20", "min_child_weight=5",
                  "min_split_weight=10", "max_depth=5", "rt_loss_type=1"]
GBRT_REG_KEYS = ["extend_type=31", *GBRT_TREE_KEYS]
GBRT_GOLDEN_TOL = 5e-6  # tests/test_golden_full.py:220
GBRT_ROUNDS = 2  # of the golden's 6
GBRT_WALK_TOL = 1e-5  # the card's f32 sum over trees against the host's f64 one
GBRT_WALK_TURNS = 5
APLAMBDA_ROUNDS = 2
APLAMBDA_KEYS = ["input_type=0", "use_ranker=0", "extend_type=30", "active_type=3",
                 "lambda_ap_alpha=0.5", "lambda_ap_reject=1", *GBRT_TREE_KEYS]
APLAMBDA_STRIDE = 397  # the scores compared one by one: every 397th test row
APLAMBDA_JAX_TOL = 1e-5
# the JAX package on the CPU, same data and keys (scripts/gbrt_jax_reference.py):
# the test set's scores after APLAMBDA_ROUNDS rounds, their moments and every
# APLAMBDA_STRIDE-th one
JAX_APLAMBDA = {
    "n": 9430, "mean": -0.5162180118588682, "std": 0.5346481842269246,
    "min": -1.0511434078216553, "max": 0.6796727180480957,
    "sample": [
        -0.035242367535829544, -0.061057668179273605, -1.0128318071365356, -1.0191397666931152,
        0.3467128574848175, 0.40286707878112793, -1.018925428390503, -1.022909164428711,
        -0.4023544192314148, 0.4806911051273346, -0.7483452558517456, -0.39527618885040283,
        -1.0138139724731445, -1.0246533155441284, 0.4191383719444275, -1.0213751792907715,
        -0.9627816677093506, -1.0337953567504883, 0.5120158791542053, -1.0232833623886108,
        -0.9891818761825562, -1.0144000053405762, -1.0305792093276978, -1.0319039821624756,
    ]}


def score_summary(scores) -> dict:
    """What phase 17 (c) compares of a score vector: its count, mean,
    standard deviation, extremes (f64) and every APLAMBDA_STRIDE-th score."""
    s = np.asarray(scores, np.float64)
    return {"n": int(len(s)), "mean": float(s.mean()), "std": float(s.std()),
            "min": float(s.min()), "max": float(s.max()),
            "sample": [float(v) for v in s[::APLAMBDA_STRIDE]]}


def summary_diff(got, want) -> float:
    """The largest |d| between two score summaries (inf if the counts
    differ)."""
    if got["n"] != want["n"] or len(got["sample"]) != len(want["sample"]):
        return math.inf
    d = [abs(got[k] - want[k]) for k in ("mean", "std", "min", "max")]
    return max(d + [abs(a - b) for a, b in zip(got["sample"], want["sample"])])


def first_round_pack_s(log) -> float:
    """Seconds of the ``pack`` spans in the first line of a train task's
    ``log_jsonl`` written with ``trace=1`` (the port's tracer)."""
    line = json.loads(pathlib.Path(log).read_text().splitlines()[0])
    return line["span_self_ms"].get("pack", 0.0) / 1e3


def task_run(conf, d, tag, keys, rounds, evals, keep=None):
    """Train ``rounds`` rounds through SVDTrainTask on the card, every
    kernel's launch count set to 0 just before and read just after, then
    evaluate the checkpoints ``evals`` (SVDInferTask keys) -> (the trained
    task, {round: RMSE}, launches, examples/s of rounds 2.. (round 1 less
    its packing, by the tracer's ``pack`` spans, for a run of one round),
    round seconds).  ``keep``: the round whose checkpoint stays, as
    ``d / f"{tag}_{keep:04d}.model"``."""
    from svdfeature_tpu_torch.infer.task import SVDInferTask
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    common = [f"model_out_folder={d}/models_{tag}", "device=cuda", "silent=1", *keys]
    trace_log = d / f"trace_{tag}.jsonl"
    traced = ["trace=1", f"log_jsonl={trace_log}"] if rounds == 1 else []
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    task = SVDTrainTask()
    task.run(str(conf), common + traced + [f"num_round={rounds}"])
    launches = {kid: fn.launches for kid, fn in wrappers.items()}
    log = d / f"rmse_{tag}.tsv"
    SVDInferTask().run(str(conf), common + [*evals, f"log_eval={log}"])
    rmse = {int(r): float(v) for r, v in (line.split() for line in log.read_text().splitlines())}
    if keep is not None:
        shutil.copy(d / f"models_{tag}" / f"{keep:04d}.model", d / f"{tag}_{keep:04d}.model")
    shutil.rmtree(d / f"models_{tag}")
    secs = task.round_seconds
    train = secs[1:] if rounds > 1 else [secs[0] - first_round_pack_s(trace_log)]
    return task, rmse, launches, task.dataset_rows() * len(train) / sum(train), secs


def phase_refresh(work, card, failures, k2_eps):
    """The per-batch refresh epochs of a shared feedback space: phase 15's
    follow data (common_feedback_space=1) through SVDTrainTask /
    SVDInferTask, (a) SVD++ at the band setting, 5 rounds, (b) the depth-2
    stacked transform under extend_type=2, 2 rounds, use_pallas set.  Gates:
    no kernel launch (K1, K2 and K3 refuse the shared space), the route,
    the test RMSE within REFRESH_JAX_TOL of the JAX package's CPU figure."""
    from svdfeature_tpu_torch.data import csr
    from svdfeature_tpu_torch.data.buffer import write_plus_buffer
    from svdfeature_tpu_torch.data.text import load_plus_text

    d = work / "follow"
    d.mkdir()
    write_follow(d, load_plus_text, csr, write_plus_buffer)
    conf = ROOT / "demo" / "implicitFeedback" / "implicitFeedback.conf"
    for tag, run in REFRESH_RUNS.items():
        R = run["rounds"]
        task, rmse, launches, eps, secs = task_run(
            conf, d, f"refresh_{tag}", [f"buffer_feature={d}/{run['buffer']}",
                                        f"test:buffer_feature={d}/test.buffer", *run["keys"]],
            R, [f"start={R}", f"end={R + 1}"])
        tr = task.trainer
        entry = tr._pack_plus(task.dataset)
        stacked = type(entry).__name__ == "ImfbEntry"
        jax = JAX_REFRESH_RMSE[tag]
        ok = (not any(launches.values()) and tr.model.param.common_feedback_space == 1
              and not tr.hp.big_table and tr.use_pallas and stacked == (tag == "b")
              and (entry.fb_overlap is None or not stacked)
              and jax is not None and abs(rmse[R] - jax) < REFRESH_JAX_TOL)
        if not ok:
            failures.append(f"refresh run ({tag})")
        jax_txt = f"minus JAX CPU {rmse[R] - jax:+.6f}" if jax is not None else "no JAX CPU figure"
        print(f"phase 15 {'ok' if ok else 'FAIL'}: follow ({tag}) {' '.join(run['keys'])} "
              f"{type(tr).__name__} refresh epoch (T={len(entry.chunk_id)}) through "
              f"SVDTrainTask/SVDInferTask: test RMSE after {R} rounds {rmse[R]:.6f} ({jax_txt}, "
              f"tol {REFRESH_JAX_TOL:g}); launches {launches} (want all 0 with use_pallas=1); "
              f"training {eps:,.0f} examples/s rounds 2-{R} (phase 5's K2 run, disjoint space: "
              f"{k2_eps:,.0f}); round seconds {[round(x, 3) for x in secs]} on {card}", flush=True)
        del task, tr, entry


def phase_bilinear(torch, work, card, failures):
    """The bilinear solver (extend_type=15) through SVDTrainTask /
    SVDInferTask, use_pallas set: (a) no user properties at the
    implicitFeedback band setting, 3 rounds, every round against the port's
    plain SVD++ run on the same pack (file order) to BI_AB_TOL and against
    golden/bilinear.rmse.tsv to BI_GOLDEN_TOL; (b) the integrated
    neighbourhood model (W_bi 1682 x 1682), 2 rounds; (c) the follow data
    on the refresh route, 3 rounds; (d) big bilinear on bigSvdpp's geometry
    (BIG_BI_USERS users, W_bi 624,000 x 64), 2 rounds, K5 launches the
    plan's.  (b)-(d) within BI_JAX_TOL of the JAX package's CPU figure; K2
    and K3 never launch.  Then K5 bit for bit at (d)'s W_bi write, timed
    against index_copy_.  Returns (K5 launches, K5 timing, what phase 21
    is held to: (b)'s and (d)'s RMSE at round MESH_BI_RUNS' rounds, their
    steps a round, (b)'s checkpoint of that round, (d)'s first W_bi
    write)."""
    from svdfeature_tpu_torch.data import csr
    from svdfeature_tpu_torch.data.buffer import write_plus_buffer
    from svdfeature_tpu_torch.ops.svdpp_bilinear import k5_launches_bi

    golden = [float(line.split()[1]) for line in
              (ROOT / "golden" / "bilinear.rmse.tsv").read_text().splitlines()]
    implicit = ROOT / "demo" / "implicitFeedback" / "implicitFeedback.conf"
    d = work / "bigBilinear"
    d.mkdir()
    t0 = time.perf_counter()
    arrays, dims = big_plus_arrays()
    big_conf = write_big_bilinear(d, csr, write_plus_buffer, arrays, dims)
    del arrays
    print(f"phase 16: big bilinear data ({BIG_BI_USERS:,} users of bigSvdpp, {BIG_BI_PROPS} "
          f"property ids each, table {dims['NU'] + dims['NI'] + dims['NF'] + 1:,} rows, W_bi "
          f"{dims['NI']:,} x {BIG_BI_NBF}) written in {time.perf_counter() - t0:.1f} s", flush=True)
    k5, timing = 0, {}
    prior = dict(rmse={}, T={}, ckpt=None, wbi_call=None)
    for tag, run in BI_RUNS.items():
        R = run["rounds"]
        dd = work / run["data"]
        data = [f"buffer_feature={dd}/train.buffer"]
        if tag == "d":
            conf, evals = big_conf, ["start=0", f"end={R + 1}", f"step={R}"]
        else:
            conf, evals = implicit, ["start=1", f"end={R + 1}"]
            data.append(f"test:buffer_feature={dd}/test.buffer")
        torch.cuda.reset_peak_memory_stats()
        keep = MESH_BI_RUNS["a"]["rounds"] if tag == "b" else None
        task, rmse, launches, eps, secs = task_run(conf, dd, f"bi_{tag}", data + run["keys"], R,
                                                   evals, keep)
        tr = task.trainer
        entry = tr._pack_plus(task.dataset)
        cid = entry.chunk_id
        if tag in "bd":  # phase 21 (a) trains (b)'s data on a mesh, 21 (b) (d)'s
            mesh_tag = "a" if tag == "b" else "b"
            prior["rmse"][mesh_tag] = rmse[MESH_BI_RUNS[mesh_tag]["rounds"]]
            prior["T"][mesh_tag] = len(cid)
        if keep is not None:
            prior["ckpt"] = dd / f"bi_{tag}_{keep:04d}.model"
        want = {kid: 0 for kid in launches}
        want["K5"] = R * k5_launches_bi(cid, BIG_BI_NBF) if tag == "d" else 0
        k5 += launches["K5"]
        ok = (launches == want and type(tr).__name__ == "SVDBiLinearTrainer" and tr.use_pallas
              and tr.hp.big_table == (tag == "d") and math.isfinite(rmse[R]))
        route = ("refresh" if tr.model.param.common_feedback_space else
                 "big-table" if tr.hp.big_table else "carried")
        line = (f"{type(tr).__name__} {route} epoch (T={len(cid)}, W_bi "
                f"{tr.W_bi.shape[0] - 1:,} x {tr.W_bi.shape[1]}); launches {launches} "
                f"(want {want}); training {eps:,.0f} examples/s; round seconds "
                f"{[round(x, 3) for x in secs]}; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if tag == "a":
            # the port's plain SVD++ rounds on the pack the bilinear solver
            # trains (file order, 8 rows a user)
            _, plain, plain_l, plain_eps, _ = task_run(
                implicit, dd, "bi_a_svdpp", data + ["sort_blocks=0", "rows_per_user=8",
                                                    "use_pallas=0"], R, evals)
            ab = max(abs(rmse[r] - plain[r]) for r in range(1, R + 1))
            gold = max(abs(rmse[r] - golden[r - 1]) for r in range(1, R + 1))
            ok &= ab <= BI_AB_TOL and gold < BI_GOLDEN_TOL and not any(plain_l.values())
            print(f"phase 16 {'ok' if ok else 'FAIL'}: implicitFeedback ({tag}) "
                  f"{' '.join(run['keys'])}: test RMSE by round "
                  f"{' '.join(f'{rmse[r]:.6f}' for r in range(1, R + 1))}; max |d| to the plain "
                  f"SVD++ run (sort_blocks=0, use_pallas=0; {plain_eps:,.0f} examples/s) {ab:.2e} "
                  f"(tol {BI_AB_TOL:g}); max |d| to golden/bilinear.rmse.tsv {gold:.6f} (tol "
                  f"{BI_GOLDEN_TOL:g}); {line} on {card}", flush=True)
        else:
            jax = JAX_BILINEAR_RMSE[tag]
            ok &= jax is not None and abs(rmse[R] - jax) < BI_JAX_TOL
            if tag == "d":
                ok &= rmse[R] < rmse[0]
            what = "probe" if tag == "d" else "test"
            start = f"{rmse[0]:.6f} -> " if tag == "d" else ""
            jax_txt = f"minus JAX CPU {rmse[R] - jax:+.6f}" if jax is not None else "no JAX CPU figure"
            at = (f"; at round {MESH_BI_RUNS[mesh_tag]['rounds']} {prior['rmse'][mesh_tag]:.6f}"
                  if tag in "bd" else "")
            print(f"phase 16 {'ok' if ok else 'FAIL'}: {run['data']} ({tag}) "
                  f"{' '.join(run['keys'])}: {what} RMSE {start}{rmse[R]:.6f} after {R} rounds "
                  f"({jax_txt}, tol {BI_JAX_TOL:g}){at}; {line} on {card}", flush=True)
        if not ok:
            failures.append(f"bilinear run ({tag})")
        if tag == "d":
            shapes = k5_first_calls(torch, lambda: tr.update_all(task.dataset), {1: "W_bi write"})
            timing = time_k5_shapes(torch, 16, "big bilinear (d)", tr.W_bi, shapes, card, failures)
            prior["wbi_call"] = tuple(x.cpu() for x in shapes["W_bi write"])
            del shapes
        del task, tr, entry
        torch.cuda.empty_cache()
    return k5, timing, prior


def walk_pair(tr, ds):
    """A GBRT trainer's host walk (device_forward=0) and its card walk
    (-1: auto) of dataset ``ds`` -> (host, card) predictions."""
    out = []
    for mode in (0, -1):
        tr.device_forward = mode
        tr._fwd_cache.clear()
        out.append(tr.predict_all(ds))
    return out


def phase_gbrt(torch, work, rank_dir, rank_keys, card, failures):
    """GBRT on the card through SVDTrainTask / SVDInferTask (the trees are
    fitted on the host, as in the JAX package; the card walks the model in
    the evals): (a) RegGBRT on implicitFeedback at the golden's
    parameters, every round's test RMSE within GBRT_GOLDEN_TOL of
    golden/gbrt_reg.rmse.tsv, every eval of a model of more than one tree
    on the card's walk, the last model's card walk within GBRT_WALK_TOL of
    its host walk (device_forward=0); (b) the 2-tree model walked over the
    training set on the card and on the host, within GBRT_WALK_TOL, both
    timed; (c) APLambda on the pairwiseRank training set, its scores of
    (a)'s test set within APLAMBDA_JAX_TOL of the JAX package's CPU run."""
    from svdfeature_tpu_torch.cli import make_ugroup_buffer
    from svdfeature_tpu_torch.data.buffer import read_plus_buffer
    from svdfeature_tpu_torch.ops import gbrt_forward

    golden = [float(line.split()[1]) for line in
              (ROOT / "golden" / "gbrt_reg.rmse.tsv").read_text().splitlines()][:GBRT_ROUNDS]
    R = len(golden)
    d = work / "gbrt"
    d.mkdir()
    write_implicit(d, make_ugroup_buffer.main)
    test = read_plus_buffer(str(d / "test.buffer"))
    conf = ROOT / "demo" / "implicitFeedback" / "implicitFeedback.conf"
    data = [f"buffer_feature={d}/train.buffer", f"test:buffer_feature={d}/test.buffer"]
    gbrt_forward.forward_trees.walks = 0
    task, rmse, launches, eps, secs = task_run(conf, d, "reg", data + GBRT_REG_KEYS, R,
                                               ["start=1", f"end={R + 1}"])
    walks = gbrt_forward.forward_trees.walks
    gold = max(abs(rmse.get(r, math.inf) - golden[r - 1]) for r in range(1, R + 1))
    tr, ds = task.trainer, task.dataset
    host, card_pred = walk_pair(tr, test)  # the last model, the trainer that saved it
    last = float(np.max(np.abs(card_pred.astype(np.float64) - host)))
    ok = (type(tr).__name__ == "RegGBRTTrainer" and tr.device.type == "cuda"
          and not any(launches.values()) and gold < GBRT_GOLDEN_TOL and walks == R - 1
          and gbrt_forward.forward_trees.walks == walks + 1 and last < GBRT_WALK_TOL)
    if not ok:
        failures.append("GBRT (a)")
    nodes = [t.tree.num_nodes for t in tr.trees]
    print(f"phase 17 {'ok' if ok else 'FAIL'}: RegGBRT (a) implicitFeedback "
          f"{' '.join(GBRT_REG_KEYS)}: test RMSE by round "
          f"{' '.join(f'{rmse[r]:.6f}' for r in sorted(rmse))}; max |d| to "
          f"golden/gbrt_reg.rmse.tsv {gold:.2e} (tol {GBRT_GOLDEN_TOL:g}); card walks {walks} of "
          f"{R} evals (want {R - 1}: a 1-tree model walks on the host); the last model's card "
          f"walk against its host walk max |d| {last:.2e} (tol {GBRT_WALK_TOL:g}); trees of "
          f"{min(nodes)}-{max(nodes)} nodes; launches {launches} (want all 0); round seconds "
          f"{[round(x, 2) for x in secs]} ({ds.rows.num_row:,} rows, host fit; {eps:,.0f} "
          f"examples/s rounds 2-{R}) on {card}", flush=True)

    # (b) the walk at its real size: the 2-tree model over the training set
    entry = tr._assemble(ds)
    smat, n = entry["smat"], len(tr.trees)
    args = ([t.tree for t in tr.trees], smat, [tr._tree_gids(entry, ti) for ti in range(n)],
            [tr._tree_weights(entry, ti) for ti in range(n)], entry["base_pred"])
    staged = gbrt_forward.stage_rows(smat, tr.device)
    card_out = gbrt_forward.forward_trees(*args, tr.device, staged)
    # the whole call (stacking, copies, walk, copy back), then the walk
    # alone on the staged model
    model = gbrt_forward.stage_model(args[0], args[2], args[3], tr.device)
    base = torch.from_numpy(entry["base_pred"].astype(np.float32)).to(tr.device)
    card_ms, walk_ms = [], []
    for fn, times in ((lambda: gbrt_forward.forward_trees(*args, tr.device, staged), card_ms),
                      (lambda: gbrt_forward.walk(model, staged, base), walk_ms)):
        for _ in range(GBRT_WALK_TURNS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
    host_ms = []
    for _ in range(GBRT_WALK_TURNS):
        t0 = time.perf_counter()
        host_out = entry["base_pred"].copy()
        for ti in range(n):
            host_out = host_out + tr.trees[ti].tree.predict_rows(
                smat, tr._tree_gids(entry, ti)) * tr._tree_weights(entry, ti)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    walk_d = float(np.max(np.abs(card_out - host_out)))
    ok = walk_d < GBRT_WALK_TOL and len(card_out) == smat.num_row
    if not ok:
        failures.append("GBRT (b)")
    print(f"phase 17 {'ok' if ok else 'FAIL'}: GBRT walk (b) of the {n}-tree model over the "
          f"training set ({smat.num_row:,} rows, {len(smat.findex):,} entries, {smat.nfeat:,} "
          f"features, depth {model['depth']}): card walk (forward_trees, stacking and copies "
          f"included) median {float(np.median(card_ms)):.3f} ms of "
          f"{[round(x, 3) for x in card_ms]}, of which the walk on the staged model median "
          f"{float(np.median(walk_ms)):.3f} ms of {[round(x, 3) for x in walk_ms]}; host walk "
          f"median {float(np.median(host_ms)):.1f} ms of {[round(x, 1) for x in host_ms]}; max "
          f"|d| {walk_d:.2e} (tol {GBRT_WALK_TOL:g}) on {card}", flush=True)
    del task, tr, ds, entry, smat, args, staged, model, base
    torch.cuda.empty_cache()

    # (c) APLambda on the pairwiseRank training set, scored on (a)'s test set
    Ra = APLAMBDA_ROUNDS
    gbrt_forward.forward_trees.walks = 0
    task, _, launches, eps, secs = task_run(
        ROOT / "demo" / "pairwiseRank" / "pairwiseRank.conf", rank_dir, "aplambda",
        rank_keys + APLAMBDA_KEYS + [f"test:buffer_feature={d}/test.buffer"], Ra,
        [f"start={Ra}", f"end={Ra + 1}"])
    got = score_summary(task.trainer.predict_all(test))
    walks = gbrt_forward.forward_trees.walks
    diff = summary_diff(got, JAX_APLAMBDA)
    ok = (type(task.trainer).__name__ == "APLambdaGBRTTrainer" and walks == 2
          and not any(launches.values()) and diff < APLAMBDA_JAX_TOL)
    if not ok:
        failures.append("GBRT (c)")
    print(f"phase 17 {'ok' if ok else 'FAIL'}: APLambda (c) pairwiseRank training set "
          f"({task.dataset.rows.num_row:,} rows) {' '.join(APLAMBDA_KEYS)}, {Ra} rounds: "
          f"implicitFeedback test scores n={got['n']:,} mean {got['mean']:.6f} std "
          f"{got['std']:.6f} min {got['min']:.6f} max {got['max']:.6f}; max |d| to the JAX CPU "
          f"run (moments and every {APLAMBDA_STRIDE}th score) {diff:.2e} (tol "
          f"{APLAMBDA_JAX_TOL:g}); card walks {walks} (want 2: the eval, the scores); launches "
          f"{launches} (want all 0); round seconds {[round(x, 2) for x in secs]} "
          f"({eps:,.0f} examples/s rounds 2-{Ra}) on {card}", flush=True)
    shutil.rmtree(d)


# ---- phase 18: out-of-core training ---------------------------------------------------
def stream_run(work, tag):
    """One phase-18 run through SVDTrainTask + SVDInferTask, every kernel's
    launch count set to 0 just before training and read just after.  After
    each streamed round (at its checkpoint's save) it reads the trainer's
    stream hooks (the device memory held beyond the round's start at a
    chunk's entry, the largest chunk), the seconds the round waited for
    chunks and trained them (the tracer's ``stream.wait`` and
    ``stream.chunk`` spans) and how many of the round's chunk tensors a
    kernel wrapper's plan list still holds; it counts the launches each
    chunk's plan implies."""
    import dataclasses
    import weakref

    import torch

    from svdfeature_tpu_torch import tracing
    from svdfeature_tpu_torch.infer.task import SVDInferTask
    from svdfeature_tpu_torch.ops import _plans
    from svdfeature_tpu_torch.ops.svdpp_big import k5_launches
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    run = STREAM_RUNS[tag]
    R = run["rounds"]
    d = work / run["data"]
    conf, keys = stream_task_args(tag, d)
    args = [*keys, f"model_out_folder={d}/models_s{tag}", "device=cuda", "silent=1"]
    refs, rounds, chunks = [], [], []

    class Task(SVDTrainTask):
        def init(self):
            super().init()
            tr = self.trainer
            stage, train = tr.chunk_stream.stage, tr.train_chunk

            def staging(entry, device):
                staged = stage(entry, device)
                refs.extend(weakref.ref(t) for t in staged.tensors)
                return staged

            def training(staged):
                e = staged.entry
                cid = getattr(e, "chunk_id", None)
                steps = e["label"].shape[0] if cid is None else len(cid)
                k5 = 0 if cid is None else k5_launches(cid, "chunk_users" in e.fb)
                chunks.append(dict(steps=steps, k5=k5))
                train(staged)

            tr.chunk_stream.stage = staging
            tr.train_chunk = tr.train_chunk_plus = tr.train_chunk_imfb = training

        def save_model(self):
            stats = self.trainer.chunk_stream.stats
            spans, _ = tracing.drain()
            if stats.chunks:  # after a streamed round
                held = {id(t) for plans in _plans._LISTS for plan in plans for t in plan.tensors}
                rounds.append(dict(stats=dataclasses.replace(stats), held=sum(
                    1 for r in refs if r() is not None and id(r()) in held),
                    wait_s=tracing.total_s(spans, "stream.wait"),
                    train_s=tracing.total_s(spans, "stream.chunk")))
                refs.clear()
            super().save_model()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    task = Task()
    t0 = time.perf_counter()
    tracing.enable()
    try:
        task.run(str(conf), args + [f"num_round={R}"])
    finally:
        tracing.disable()
    launches = {kid: fn.launches for kid, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    tr = task.trainer
    state_bytes = sum(getattr(tr.state, f.name).nbytes for f in dataclasses.fields(tr.state))
    streamed = hasattr(task.dataset, "chunks")
    log = d / f"rmse_s{tag}.tsv"
    infer = SVDInferTask()
    infer.run(str(conf), args + [*stream_evals(tag), f"log_eval={log}"])
    rmse = [float(line.split()[1]) for line in log.read_text().splitlines()]
    shutil.rmtree(d / f"models_s{tag}")
    secs = task.round_seconds
    train = secs[1:] if R > 1 else secs  # one round: its packing, on the producer thread
    res = dict(rmse=rmse, launches=launches, rounds=rounds, chunks=chunks, R=R, peak=peak,
               state_bytes=state_bytes, secs=secs, rows=task.dataset_rows(),
               eps=task.dataset_rows() * len(train) / sum(train),
               streamed=streamed and hasattr(infer.dataset, "chunks"),
               trainer=type(tr).__name__, big=bool(tr.hp.big_table),
               sweep=bool(tr.hp.sweep_table), seconds=time.perf_counter() - t0)
    del task, tr, infer
    return res


def phase_stream(work, staged, card, failures):
    """Out-of-core training through the port's entry points, on the buffers
    of phases 5, 7, 9 and 11 read a chunk at a time (STREAM_RUNS): (a)
    bigTable's tile sweep (K4) and (c) its sorted dedup (K5) in chunks of
    whole batches, probes within STREAM_STAGED_TOL of phase 7 (a)'s staged
    one ((a)) and within 1e-4 of the JAX CPU figures; (b) implicitFeedback
    (K2, sorted within chunks) in its GOLDEN band; (d) bigSvdpp's user-carry
    epoch (K5); (e) the stacked set (K3, contexts carried across chunks);
    (b), (d), (e) within STREAM_JAX_TOL of the JAX package's streamed runs.
    Every launch count is the chunks' plans', no plan list keeps a chunk
    tensor after a round, and (f) in (a) the device memory held beyond a
    round's start stays within (STREAM_PREFETCH + 1) chunks.  Each run
    prints examples/s beside the staged run of its phase, the waiting and
    training seconds of a round, and its peak device memory."""
    golden = json.loads((ROOT / "golden" / "GOLDEN.json").read_text())["implicitFeedback"]
    golden_mf = json.loads((ROOT / "golden" / "GOLDEN.json").read_text())["basicMF"]
    kernel_of = {"g": "K1", "a": "K4", "c": "K5", "b": "K2", "d": "K5", "e": "K3"}
    totals = {}
    for tag in STREAM_RUNS:
        run = STREAM_RUNS[tag]
        r = stream_run(work, tag)
        kid = kernel_of[tag]
        n_chunks = len(r["chunks"])
        if kid in ("K4", "K5") and tag != "d":
            count, how = sum(c["steps"] for c in r["chunks"]), "one a step"
        elif tag == "d":
            count, how = sum(c["k5"] for c in r["chunks"]), "the big epochs' plans"
        else:
            count, how = n_chunks, "one a chunk"
        want = {k: 0 for k in r["launches"]}
        want[kid] = count
        final = r["rmse"][-1]
        checks = [r["launches"] == want, r["streamed"], math.isfinite(final),
                  n_chunks == r["R"] * (n_chunks // r["R"]) and n_chunks >= 2 * r["R"],
                  len(r["rounds"]) == r["R"], all(x["held"] == 0 for x in r["rounds"])]
        if tag in "acd":
            checks.append(final < r["rmse"][0])
        if tag in "ac":
            jax = JAX_BIG_RMSE[1 << 20 if tag == "a" else 4096]
            checks += [r["big"], r["sweep"] == (tag == "a")]
            vs = f"minus JAX CPU (staged) {final - jax:+.6f}, tol {BIG_JAX_TOL:g}"
            checks.append(abs(final - jax) < BIG_JAX_TOL)
            d_staged = final - staged[tag]["rmse"]
            vs += f"; minus phase 7 ({tag}) staged {d_staged:+.2e}"
            if tag == "a":
                vs += f", tol {STREAM_STAGED_TOL:g}"
                checks.append(abs(d_staged) < STREAM_STAGED_TOL)
        elif tag == "g":
            checks.append(abs(final - golden_mf["final_rmse"]) < golden_mf["rmse_band"])
            vs = f"golden {golden_mf['final_rmse']} band {golden_mf['rmse_band']}"
        else:
            jax = JAX_STREAM_RMSE[tag]
            checks.append(jax is not None and abs(final - jax) < STREAM_JAX_TOL)
            vs = (f"minus JAX CPU streamed {final - jax:+.6f}, tol {STREAM_JAX_TOL:g}"
                  if jax is not None else "no JAX CPU figure")
            if tag == "b":
                checks.append(abs(final - golden["final_rmse"]) < golden["rmse_band"])
                vs += f"; golden {golden['final_rmse']} band {golden['rmse_band']}"
        ok = all(checks)
        if not ok:
            failures.append(f"streamed run ({tag})")
        totals[kid] = totals.get(kid, 0) + r["launches"][kid]
        wait = [x["wait_s"] for x in r["rounds"]]
        train = [x["train_s"] for x in r["rounds"]]
        what = "probe" if tag in "acd" else "test"
        when = f"rounds 2-{r['R']}" if r["R"] > 1 else "round 1"
        print(f"phase 18 {'ok' if ok else 'FAIL'}: streamed ({tag}) {run['data']} "
              f"{' '.join(run['keys'])} {r['trainer']} through SVDTrainTask/SVDInferTask "
              f"(test set streamed in chunks of {run['test_chunk']}): {what} RMSE "
              f"{' -> '.join(f'{x:.6f}' for x in r['rmse'])} after {r['R']} rounds ({vs}); "
              f"launches {r['launches']} (want {kid} {count}: {how}; {n_chunks} chunks = "
              f"{r['R']} rounds x {n_chunks // r['R']}); training {r['eps']:,.0f} examples/s "
              f"{when} (phase {run['phase']}'s staged run {staged[tag]['eps']:,.0f}); "
              f"round seconds {[round(x, 3) for x in r['secs']]}; a round waited "
              f"{min(wait):.3f}-{max(wait):.3f} s for its chunks and spent {min(train):.3f}-"
              f"{max(train):.3f} s training them (the tracer's spans); peak device memory "
              f"{r['peak'] / 2**20:.1f} MiB; run {r['seconds']:.1f} s; on {card}", flush=True)
        if tag == "a":
            # (f) memory and overlap: the device memory held beyond a
            # round's start (which holds the trainer's state) at a chunk's
            # entry, against (prefetch + 1) chunks
            for i, x in enumerate(r["rounds"]):
                st = x["stats"]
                bound = (STREAM_PREFETCH + 1) * st.max_chunk_bytes
                ok_f = st.max_excess_bytes <= bound and x["held"] == 0
                if not ok_f:
                    failures.append(f"streamed memory (f) round {i + 1}")
                print(f"phase 18 {'ok' if ok_f else 'FAIL'}: (f) streamed (a) round {i + 1}: "
                      f"{x['held']} chunk tensors in the kernel plans after the round; device memory "
                      f"at a chunk's entry beyond the round's start at most "
                      f"{st.max_excess_bytes / 2**20:.1f} MiB (want <= {STREAM_PREFETCH + 1} x the "
                      f"largest staged chunk's {st.max_chunk_bytes / 2**20:.1f} MiB = "
                      f"{bound / 2**20:.1f} MiB); allocated at the round's start "
                      f"{st.base_bytes / 2**20:.1f} MiB, the trainer's state "
                      f"{r['state_bytes'] / 2**20:.1f} MiB; waited {x['wait_s']:.3f} s for "
                      f"{st.chunks} chunks, trained {x['train_s']:.3f} s", flush=True)
    return totals


# ---- phase 19: the base solver on a 2x2 mesh -------------------------------------
# One torchrun world of MESH_RANKS processes on this node (gloo on the CUDA
# tensors when they share a card, parallel/comm.py), launched once a run;
# each rank runs the train CLI, then the infer CLI (chip_smoke.py
# --mesh-rank): (a) basicMF on phase 3's buffers, 40 rounds, evaluated at
# rounds MESH_STREAM_ROUNDS and 40; (b) bigTable at batch 4096 on phase 7
# (c)'s buffers and settings, 3 rounds, mesh_big by its auto rule (a slab of
# 1,024,290 rows: K5 on every rank, one launch a step); (c) basicMF's train
# rows again in file blocks of BATCH rows, streamed in chunks of whole
# batches (so they follow (a)), MESH_STREAM_ROUNDS rounds.
MESH_RANKS = 4
MESH_KEYS = ["mesh_data=2", "mesh_model=2", "device=cuda", "silent=1"]
# (a) and (b) join the world by distributed=1, (c) and (d) by the mesh keys alone
MESH_JOIN = {"a": ["distributed=1"], "b": ["distributed=1"], "c": [], "d": []}
# each torchrun call of phases 19 and 20, the build excluded
MESH_TIMEOUT_S = 900  # the torchrun call of phases 19 and 20, the build excluded
MESH_TOL = 1e-4  # (a) against phase 3's test RMSE, (b) against phase 7 (c)'s probe
MESH_STREAM_ROUNDS = 5
MESH_STREAM_TOL = 1e-5  # (c) against (a) at the same round: the same batches
MESH_STREAM_CHUNK = 4 * BATCH
# (d): the lite example solver (extend_type 99, solvers/example.py) on (a)'s
# buffers, LITE_ROUNDS rounds at batch LITE_BATCH, which mesh_data=2 rounds
# up to LITE_BATCH + 1 as the JAX mesh does; every rank holds the whole
# table, and each names its own model folder and logs ("{rank}"): rank 0's
# alone may appear
LITE_BATCH = 4095
LITE_ROUNDS = 2
LITE_KEYS = ["extend_type=99", "format_type=0", f"batch_size={LITE_BATCH}"]
# the JAX lite trainer on its 2x2 CPU mesh, same data, keys and rounds
# (scripts/lite_mesh_jax_reference.py): the test RMSE after LITE_ROUNDS
# rounds and the mean |w| of that round's checkpoint
JAX_LITE_MESH = {"rmse": 1.010470, "mean_abs_w": 0.007983895}
LITE_JAX_TOL = 1e-5
LITE_SINGLE_TOL = 1e-6  # rank 0's checkpoint against the single card's, max abs


def lite_args(mf):
    """(train, infer) CLI arguments of phase 19 (d) on basicMF's buffers in
    ``mf``, the conf first; the mesh keys, model folder and logs are the
    caller's."""
    conf = ROOT / "demo" / "basicMF" / "basicMF.conf"
    return ([conf, f"buffer_feature={mf}/train.buffer", f"num_round={LITE_ROUNDS}", *LITE_KEYS],
            [conf, f"test:buffer_feature={mf}/test.buffer", f"start={LITE_ROUNDS}",
             f"end={LITE_ROUNDS + 1}"])


def count_mesh_steps():
    """A counter of the steps the user-group mesh bodies run on this rank:
    the rounds loop of parallel/svdpp_mesh.py, which the six mesh modules
    share, wrapped where each of them calls it."""
    from svdfeature_tpu_torch.parallel import (bilinear_mesh, bilinear_mesh_big, imfb_mesh,
                                               imfb_mesh_big, svdpp_mesh, svdpp_mesh_big)

    count, real = [0], svdpp_mesh._rounds

    def rounds(step_fn, state, stacked, chunk_id, fb, lrs, ph, extra=None):
        count[0] += len(chunk_id) * lrs.shape[0]
        return real(step_fn, state, stacked, chunk_id, fb, lrs, ph, extra)

    for mod in (svdpp_mesh, svdpp_mesh_big, imfb_mesh, imfb_mesh_big, bilinear_mesh,
                bilinear_mesh_big):
        mod._rounds = rounds
    return count


def mesh_rank(argv):
    """A rank of the torchrun world of phases 19-21: ``chip_smoke.py --mesh-rank
    OUT TRAIN ARGS -- INFER ARGS [--next TRAIN ARGS -- INFER ARGS ...]``
    under torchrun.  For each run, runs the train CLI with every kernel's
    launch count set to 0 just before and read just after, then the infer
    CLI, and writes what it measured, a record a run, to
    OUT.rank<r>.json."""
    import os

    import torch
    import torch.distributed as dist

    import svdfeature_tpu_torch.solvers.example  # noqa: F401  (registers extend_type 99)
    from svdfeature_tpu_torch.cli import svd_feature, svd_feature_infer

    out, rest = argv[0], [arg.replace("{rank}", os.environ["RANK"]) for arg in argv[1:]]
    local = os.environ["LOCAL_RANK"]
    pathlib.Path(f"{out}.pid{local}").write_text(str(os.getpid()))  # for the parent's cleanup
    wrappers = kernel_wrappers()
    steps = count_mesh_steps()
    groups, records = [[]], []
    for arg in rest:
        if arg == "--next":
            groups.append([])
        else:
            groups[-1].append(arg)
    for group in groups:
        cut = group.index("--")
        if records:  # the rank's card is set by the first run's world
            torch.cuda.reset_peak_memory_stats(torch.cuda.current_device())
        for fn in wrappers.values():
            fn.launches = 0
        steps[0] = 0
        t0 = time.perf_counter()
        svd_feature.main(group[:cut])
        launches = {kid: fn.launches for kid, fn in wrappers.items()}
        t1 = time.perf_counter()
        svd_feature_infer.main(group[cut + 1:])
        own = torch.cuda.current_device()
        # a tensor made before the rank set its card lands on card 0
        stray = sum(torch.cuda.max_memory_allocated(i)
                    for i in range(torch.cuda.device_count()) if i != own)
        records.append(dict(
            rank=dist.get_rank(), launches=launches, steps=steps[0], train_s=t1 - t0,
            infer_s=time.perf_counter() - t1, backend=str(dist.get_backend()), device=str(own),
            peak=torch.cuda.max_memory_allocated(own), stray=stray))
    pathlib.Path(f"{out}.rank{dist.get_rank()}.json").write_text(json.dumps(records))
    return 0


def mesh_run(work, tag, runs):
    """One torchrun call (``runs``: (train, infer) CLI arguments, the conf
    first, for each run; its files under ``work`` named by ``tag``): for
    every rank the list of its runs' records, and the call's output; or
    None and the output when it failed or ran out of MESH_TIMEOUT_S (then
    it and every rank it started are killed)."""
    import os
    import signal

    out = work / f"mesh_{tag}"
    args = []
    for train, infer in runs:
        args += [*(["--next"] if args else []), *map(str, train), "--", *map(str, infer)]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={MESH_RANKS}", str(ROOT / "chip_smoke.py"), "--mesh-rank", str(out),
           *args]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        log, _ = proc.communicate(timeout=MESH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.terminate()  # torchrun passes it on to its ranks
        try:
            log, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        for pid in work.glob(f"mesh_{tag}.pid*"):
            try:
                os.kill(int(pid.read_text()), signal.SIGKILL)
            except ProcessLookupError:
                pass
        return None, f"{log}\ntimed out after {MESH_TIMEOUT_S} s"
    if proc.returncode != 0:
        return None, log
    return [json.loads(pathlib.Path(f"{out}.rank{r}.json").read_text())
            for r in range(MESH_RANKS)], log


def mesh_k5(torch, dev, big, card, failures):
    """K5 at a mesh_big slab's shape: the slab of model position 0 of the
    2x2 bigTable mesh ([n_real + 1, W], the scratch row last) and the write
    of one batch-4096 step's gathered stream (its 8192 local ids in sorted
    order, each owned run's last entry to its row, the rest as zeros to the
    scratch row; parallel/mesh_big.py), bit for bit against its plain
    version and timed in turns with it and with index_copy_."""
    from svdfeature_tpu_torch.ops import big_embed, cuda_scatter
    from svdfeature_tpu_torch.parallel import mesh_big

    n = BIG_NU + BIG_NI + 1
    n_real, n_phys = mesh_big.big_layout(n, 2)
    W = big_embed.aug_width(BIG_K)
    ent = np.concatenate([big["index"][0:2 * BATCH:2].astype(np.int64),
                          BIG_NU + big["index"][1:2 * BATCH:2].astype(np.int64)])
    loc = np.sort(np.where(ent < n_real, ent, n_real))  # position 0 owns rows [0, n_real)
    last = np.append(loc[1:] != loc[:-1], True) & (loc != n_real)
    E, U = loc.size, int(last.sum()) + 1  # rows written, the scratch row included
    rng = np.random.default_rng(19)
    slab = torch.from_numpy(rng.standard_normal((n_phys, W), dtype=np.float32)).to(dev)
    slab[-1] = 0.0
    idx = torch.from_numpy(np.where(last, loc, n_real).astype(np.int32)).to(dev)
    vals = torch.from_numpy(np.where(last[:, None], rng.standard_normal((E, W), dtype=np.float32),
                                     0.0).astype(np.float32)).to(dev)
    idx_long = idx.long()
    ok = torch.equal(cuda_scatter.row_writer(slab.clone(), idx, vals),
                     cuda_scatter.row_writer_reference(slab.clone(), idx, vals))
    work = slab.clone()
    t = timed(torch, {"plain": lambda: cuda_scatter.row_writer_reference(work, idx, vals),
                      "kernel": lambda: cuda_scatter.row_writer(work, idx, vals),
                      "library": lambda: work.index_copy_(0, idx_long, vals)}, inner=200, turns=10)
    t["bound"], t["bound_by"] = bound(4 * (E + E * W + U * W), 0, 1)
    if not ok:
        failures.append("K5 vs plain at the mesh slab")
    print(f"phase 19 {'ok' if ok else 'FAIL'}: K5 at the 2x2 mesh_big slab [{n_phys} x {W}] "
          f"(model position 0), one step's gathered stream E={E} ({U} distinct targets, the "
          f"scratch row included) bit for bit against its plain version; ms per call kernel "
          f"{t['kernel']:.4f} plain {t['plain']:.4f} library (index_copy_) {t['library']:.4f} "
          f"bound {t['bound']:.6f} ({t['bound_by']}) on {card}", flush=True)
    return dict(t, err=0.0)


def mesh_call_all(torch, work):
    """The one torchrun call of phases 19-21: their runs (phase 19's first:
    its (c) joins the world by the mesh keys alone), their records, output
    and seconds (mesh_call)."""
    runs = {f"{ph}{tag}": run for ph, make in ((19, phase_mesh_runs), (20, phase_mesh_plus_runs),
                                               (21, phase_mesh_bi_runs))
            for tag, run in make(work).items()}
    torch.cuda.empty_cache()  # the ranks share the card with this process
    call = mesh_call(work, runs)
    print(f"phases 19-21: one torchrun call of {MESH_RANKS} ranks, runs {list(runs)}: "
          f"{'ok' if call[0] is not None else 'FAIL'} in {call[2]:.1f} s", flush=True)
    return call


def phase_mesh_runs(work):
    """Phase 19's runs, (c) first (it joins the world by the mesh keys
    alone, before any run with distributed=1): tag -> (train, infer) CLI
    arguments, the conf first, the mesh keys, model folder and logs
    included; writes (c)'s train buffer in file blocks of whole batches."""
    from svdfeature_tpu_torch.data.buffer import read_csr_buffer, write_csr_buffer

    mf, bt = work / "basicMF", work / "bigTable"
    mf_conf = ROOT / "demo" / "basicMF" / "basicMF.conf"
    ds, _ = read_csr_buffer(str(mf / "train.buffer"))
    write_csr_buffer(str(mf / f"train{BATCH}.buffer"), ds, BATCH)  # blocks of whole batches
    runs = {
        "c": ([mf_conf, f"buffer_feature={mf}/train{BATCH}.buffer",
               f"num_round={MESH_STREAM_ROUNDS}", f"batch_size={BATCH}", "streaming=1",
               f"stream_chunk={MESH_STREAM_CHUNK}"],
              [f"test:buffer_feature={mf}/test.buffer", "test:streaming=1",
               f"test:stream_chunk={BATCH}", f"start={MESH_STREAM_ROUNDS}",
               f"end={MESH_STREAM_ROUNDS + 1}"]),
        "a": ([mf_conf, f"buffer_feature={mf}/train.buffer", f"num_round={ROUNDS}",
               f"batch_size={BATCH}"],
              [f"test:buffer_feature={mf}/test.buffer", f"start={MESH_STREAM_ROUNDS}",
               f"end={ROUNDS + 1}", f"step={ROUNDS - MESH_STREAM_ROUNDS}"]),
        "b": ([bt / "bigTable.conf", f"num_round={BIG_ROUNDS}", "batch_size=4096"],
              [f"start={BIG_ROUNDS}", f"end={BIG_ROUNDS + 1}"]),
    }
    train, infer = lite_args(mf)
    runs["d"] = (train, infer[1:])
    out = {}
    for tag, (train, infer) in runs.items():
        own = "_r{rank}" if tag == "d" else ""  # (d): each rank its own files
        keys = [*MESH_JOIN[tag], *MESH_KEYS]
        models = f"model_out_folder={work}/mesh_models_{tag}"
        out[tag] = ([*train, *keys, f"{models}{own}", f"log_jsonl={work}/mesh_{tag}{own}.jsonl"],
                    [train[0], *keys, f"{models}{'_r0' if own else ''}", *infer,
                     f"log_eval={work}/mesh_{tag}{own}.tsv"])
    return out


def mesh_call(work, runs):
    """The one torchrun call of phases 19 and 20 (``runs``: name -> (train,
    infer)): (name -> the records of every rank, or None when the call
    failed; its output; its seconds; ``runs``)."""
    t0 = time.perf_counter()
    ranks, log = mesh_run(work, "mesh", list(runs.values()))
    secs = time.perf_counter() - t0
    records = None if ranks is None else {
        name: [r[i] for r in ranks] for i, name in enumerate(runs)}
    return records, log, secs, runs


def phase_mesh(torch, work, big, staged, card, failures, call=None):
    """The base solver on a 2x2 mesh through the train and infer CLIs under
    torchrun (MESH_RANKS ranks): (a) basicMF, in its GOLDEN band and within
    MESH_TOL of phase 3's RMSE; (b) bigTable at batch 4096 on mesh_big
    slabs, its probe within MESH_TOL of phase 7 (c)'s, K5 launched once a
    step on every rank and nothing else; (c) basicMF streamed in chunks of
    whole batches, within MESH_STREAM_TOL of (a) at the same round; (d) the
    lite example solver (mesh_lite); then K5 at the slab's shape.
    ``call``: the records, output and seconds of
    the torchrun call that ran phase_mesh_runs (mesh_call; None: make one).
    Returns the K5 launches of every rank, with the K5 timing."""
    golden = json.loads((ROOT / "golden" / "GOLDEN.json").read_text())["basicMF"]
    if call is None:
        torch.cuda.empty_cache()  # the ranks share the card with this process
        call = mesh_call(work, {f"19{tag}": run for tag, run in phase_mesh_runs(work).items()})
    records, out, secs, runs = call
    found = re.search(r"distributed: .*", out)
    backend = found.group(0) if found else "no backend line"
    rmse, k5 = {}, 0
    for tag in ("a", "b", "c"):
        train = [str(x) for x in runs[f"19{tag}"][0][1:]]
        log_json, log_eval = work / f"mesh_{tag}.jsonl", work / f"mesh_{tag}.tsv"
        if records is None:
            failures.append(f"mesh run ({tag})")
            print(f"phase 19 FAIL: mesh ({tag}): the torchrun call failed after {secs:.1f} s; "
                  f"its output ends:\n{out[-4000:]}", flush=True)
            continue
        ranks = records[f"19{tag}"]
        shutil.rmtree(work / f"mesh_models_{tag}", ignore_errors=True)
        rmse[tag] = dict(line.split() for line in log_eval.read_text().splitlines())
        round_s = [json.loads(x)["round_s"] for x in log_json.read_text().splitlines()]
        rows = 90570 if tag != "b" else BIG_EX
        eps = rows * (len(round_s) - 1) / sum(round_s[1:])
        launches = [r["launches"] for r in ranks]
        want = {kid: 0 for kid in launches[0]}
        if tag == "a":
            final, first = float(rmse[tag][str(ROUNDS)]), float(rmse[tag][str(MESH_STREAM_ROUNDS)])
            ref = staged["phase3"]
            checks = [abs(final - golden["final_rmse"]) < golden["rmse_band"],
                      abs(final - ref) < MESH_TOL]
            vs = (f"test RMSE {first:.6f} at round {MESH_STREAM_ROUNDS}, {final:.6f} at {ROUNDS} "
                  f"(golden {golden['final_rmse']} band {golden['rmse_band']}; minus phase 3's "
                  f"single-card run {final - ref:+.2e}, tol {MESH_TOL:g})")
        elif tag == "b":
            final = float(rmse[tag][str(BIG_ROUNDS)])
            ref = staged["c"]["rmse"]
            steps = BIG_ROUNDS * (BIG_EX // 4096)
            want["K5"] = steps
            k5 += sum(x["K5"] for x in launches)
            checks = [abs(final - ref) < MESH_TOL, abs(final - JAX_BIG_RMSE[4096]) < MESH_TOL]
            vs = (f"probe RMSE {final:.6f} after {BIG_ROUNDS} rounds (minus phase 7 (c) "
                  f"{final - ref:+.2e}, minus JAX CPU {final - JAX_BIG_RMSE[4096]:+.2e}, tol "
                  f"{MESH_TOL:g}); K5 one a step on every rank, {steps} steps")
        else:
            final = float(rmse[tag][str(MESH_STREAM_ROUNDS)])
            ref = float(rmse["a"][str(MESH_STREAM_ROUNDS)]) if "a" in rmse else math.nan
            checks = [abs(final - ref) < MESH_STREAM_TOL]
            vs = (f"streamed in chunks of {MESH_STREAM_CHUNK} (whole batches), test set in "
                  f"chunks of {BATCH}: test RMSE {final:.6f} at round {MESH_STREAM_ROUNDS} "
                  f"(minus (a) at that round {final - ref:+.2e}, tol {MESH_STREAM_TOL:g})")
        checks.append(all(x == want for x in launches))
        checks.append(not any(x["stray"] for x in ranks))
        ok = all(checks) and math.isfinite(final)
        if not ok:
            failures.append(f"mesh run ({tag})")
        shown = [x for x in train if not x.startswith(("model_out_folder=", "log_jsonl="))]
        print(f"phase 19 {'ok' if ok else 'FAIL'}: mesh ({tag}) {MESH_RANKS} ranks, "
              f"{' '.join(shown)}: {vs}; launches "
              f"on each rank {launches} (want {want}); ranks {[x['backend'] for x in ranks]} "
              f"on cuda:{[x['device'] for x in ranks]}, bytes on the other cards "
              f"{[x['stray'] for x in ranks]} (want 0), {backend}; training {eps:,.0f} "
              f"examples/s rounds 2-{len(round_s)} (round seconds "
              f"{[round(x, 3) for x in round_s]}); train CLI "
              f"{max(x['train_s'] for x in ranks):.1f} s, infer CLI "
              f"{max(x['infer_s'] for x in ranks):.1f} s, peak device memory a rank "
              f"{max(x['peak'] for x in ranks) / 2**30:.2f} GiB; on {card}", flush=True)
    mesh_lite(work, call, card, failures)
    timing = mesh_k5(torch, torch.device("cuda", 0), big, card, failures)
    return k5, timing


def lite_model(path):
    """w, b, g of a checkpoint, as numpy."""
    import torch

    from svdfeature_tpu_torch.model import SVDModel
    from svdfeature_tpu_torch.params import SVDTypeParam

    with open(path, "rb") as f:
        m = SVDModel.load(f, SVDTypeParam.from_bytes(f.read(4)), device=torch.device("cpu"))
    return {key: getattr(m, key).numpy() for key in ("w", "b", "g")}


def mesh_lite(work, call, card, failures):
    """Phase 19 (d), the lite example solver on the 2x2 world: no kernel
    (its step is plain torch), the batch rounded up to LITE_BATCH + 1, one
    file of each kind (rank 0's checkpoints, JSON lines and eval log; no
    other rank's), rank 0's last checkpoint within LITE_SINGLE_TOL of the
    single card's run at LITE_BATCH + 1 (trained here), its test RMSE and
    mean |w| within LITE_JAX_TOL of the JAX 2x2 CPU mesh's."""
    import svdfeature_tpu_torch.solvers.example  # noqa: F401  (registers extend_type 99)
    from svdfeature_tpu_torch.train.loop import SVDTrainTask

    records, out, secs, runs = call
    if records is None:
        failures.append("mesh run (d)")
        print(f"phase 19 FAIL: mesh (d): the torchrun call failed after {secs:.1f} s", flush=True)
        return
    ranks = records["19d"]
    train, _ = lite_args(work / "basicMF")
    single = work / "lite_single"
    t0 = time.perf_counter()
    task = SVDTrainTask()
    task.run(str(train[0]), [*map(str, train[1:]), "device=cuda", "silent=1",
                             f"batch_size={LITE_BATCH + 1}", f"model_out_folder={single}"])
    t_single = time.perf_counter() - t0
    last = f"{LITE_ROUNDS:04d}.model"
    got, want = lite_model(work / "mesh_models_d_r0" / last), lite_model(single / last)
    d_single = max(float(np.abs(got[key] - want[key]).max(initial=0.0)) for key in got)
    files = {kind: sorted(p.name for p in work.glob(pattern)) for kind, pattern in (
        ("models", "mesh_models_d_r*"), ("log_jsonl", "mesh_d_r*.jsonl"),
        ("log_eval", "mesh_d_r*.tsv"))}
    want_files = {"models": ["mesh_models_d_r0"], "log_jsonl": ["mesh_d_r0.jsonl"],
                  "log_eval": ["mesh_d_r0.tsv"]}
    checkpoints = sorted(p.name for p in (work / "mesh_models_d_r0").glob("*.model"))
    n_json = len((work / "mesh_d_r0.jsonl").read_text().splitlines())
    evals = (work / "mesh_d_r0.tsv").read_text().split()
    rmse, mean_w = float(evals[1]), float(np.abs(got["w"]).astype(np.float64).mean())
    launches = [r["launches"] for r in ranks]
    ok = (files == want_files and n_json == LITE_ROUNDS and len(evals) == 2
          and checkpoints == [f"{r:04d}.model" for r in range(LITE_ROUNDS + 1)]
          and d_single < LITE_SINGLE_TOL and abs(rmse - JAX_LITE_MESH["rmse"]) < LITE_JAX_TOL
          and abs(mean_w - JAX_LITE_MESH["mean_abs_w"]) < LITE_JAX_TOL
          and all(not any(x.values()) for x in launches) and not any(x["stray"] for x in ranks))
    if not ok:
        failures.append("mesh run (d), the lite solver")
    shutil.rmtree(single, ignore_errors=True)
    print(f"phase 19 {'ok' if ok else 'FAIL'}: mesh (d) the lite solver {' '.join(LITE_KEYS)} "
          f"{MESH_RANKS} ranks, {LITE_ROUNDS} rounds: test RMSE {rmse:.6f} (minus JAX 2x2 CPU "
          f"mesh {rmse - JAX_LITE_MESH['rmse']:+.2e}), mean |w| {mean_w:.9f} (minus JAX "
          f"{mean_w - JAX_LITE_MESH['mean_abs_w']:+.2e}; tol {LITE_JAX_TOL:g}); rank 0's "
          f"checkpoint minus the single card's at batch {LITE_BATCH + 1}: max |d| "
          f"{d_single:.2e} (tol {LITE_SINGLE_TOL:g}; single card {t_single:.1f} s); files "
          f"{files}, checkpoints {checkpoints}, {n_json} JSON lines, eval {evals}; launches on "
          f"each rank {launches} (want none); train CLI "
          f"{max(x['train_s'] for x in ranks):.1f} s, infer CLI "
          f"{max(x['infer_s'] for x in ranks):.1f} s; on {card}", flush=True)


# ---- phase 20: the user-group solvers on a 2x2 mesh --------------------------------
# Six runs of the SVD++ and multi-IMFB trainers through the train and infer
# CLIs on MESH_RANKS ranks (mesh_data=2 mesh_model=2), in one torchrun call
# of chip_smoke.py --mesh-rank, on the data earlier phases wrote: (a) implicitFeedback at its
# band setting (phase 5's buffers); (c) pairwiseRank (phase 13's), a fresh
# packed pair epoch a round, then the ranker on the same mesh keys; (d) the
# depth-2 stacked set (phase 9's); (b) bigSvdpp on mesh_big slabs by the auto
# rule (phase 11's, K5 twice a step on every rank); (e) big multi-IMFB (phase
# 11 (d)'s data); (f) (b) streamed in phase 18 (d)'s chunks.
MESH_PLUS_RUNS = {  # tag: its data (a phase's directory), keys beside its conf, rounds, slabs
    "a": dict(data="implicitFeedback", keys=BAND_KEYS, rounds=2, big=False),
    "c": dict(data="pairwiseRank", keys=[], rounds=2, big=False),
    "d": dict(data="multiIMFBStacked", keys=["extend_type=2", "rows_per_user=8"], rounds=1,
              big=False),
    "b": dict(data="bigSvdpp", keys=[], rounds=2, big=True),
    "e": dict(data="bigSvdpp", keys=["extend_type=2"], buffer="imfb.buffer", rounds=1, big=True),
    "f": dict(data="bigSvdpp", keys=["streaming=1", "stream_chunk=32768", "test:streaming=1",
                                     "test:stream_chunk=1024"], rounds=1, big=True),
}


def mesh_plus_args(tag, d, out):
    """(train, infer) CLI arguments, the conf first, of phase 20's run
    ``tag`` on the data in ``d`` (the directory of the phase that wrote it),
    its models, eval log or pred file under ``out``; the mesh keys are the
    caller's."""
    run = MESH_PLUS_RUNS[tag]
    R = run["rounds"]
    if run["data"] == "bigSvdpp":
        conf = d / "bigSvdpp.conf"
        data = [f"buffer_feature={d}/{run.get('buffer', 'train.buffer')}"]
    else:
        demo = "pairwiseRank" if tag == "c" else "implicitFeedback"
        conf = ROOT / "demo" / demo / f"{demo}.conf"
        data = [f"buffer_feature={d}/train.buffer", f"test:buffer_feature={d}/test.buffer"]
    common = [*data, *run["keys"], f"model_out_folder={out}/models", "silent=1"]
    infer = ([f"pred={R}", f"name_pred={out}/pred.txt"] if tag == "c" else
             [f"start={R}", f"end={R + 1}", f"log_eval={out}/eval.tsv"])
    return [conf, *common, f"num_round={R}"], [conf, *common, *infer]


# the JAX package's 2x2 mesh on 4 CPU devices, same data, conf and rounds
# (scripts/mesh_plus_jax_reference.py --run a|b|c|d|e|f): the test RMSE after
# the last round (a, d), the probe's (b, e, f), P@20 (c); (c)'s last-round w is
# scripts/mesh_plus_jax_rank_w.npy
JAX_MESH_PLUS = {"a": 1.059404, "b": 0.170734, "c": 0.085843, "d": 1.030643, "e": 0.172171,
                 "f": 0.172368}
MESH_PLUS_TOL = 1e-4  # every figure against JAX's; (b) against phase 11 (a) at round 2 too
MESH_PLUS_P20_TOL = RANK_JAX_TOL
MESH_PLUS_W_TOL = 1e-4  # (c)'s checkpoint, max abs over w, against JAX's


def mesh_plus_expected_steps(work, prior):
    """The steps each big run must take (K5 writes twice a step): (b) and
    (e) phase 11's T a round, (f) the stream's stable steps a chunk times
    its chunks (data/streaming.StreamingPlusBuffer.plan_caps)."""
    from svdfeature_tpu_torch.data.streaming import StreamingPlusBuffer

    src = StreamingPlusBuffer(str(work / "bigSvdpp" / "train.buffer"), blocks_per_chunk=32768)
    t_cap = src.plan_caps(4096, 4, sort_local=True)["t_cap"]  # bigSvdpp.conf's G, M, sort_blocks
    chunks = -(-src.num_block // src.blocks_per_chunk)
    return {"b": MESH_PLUS_RUNS["b"]["rounds"] * prior["T"]["b"],
            "e": MESH_PLUS_RUNS["e"]["rounds"] * prior["T"]["e"],
            "f": MESH_PLUS_RUNS["f"]["rounds"] * t_cap * chunks}


def phase5_single(work, rnd):
    """Phase 5's single-card test RMSE at round ``rnd``, from its kept
    checkpoint (None where it was not kept)."""
    d = work / "implicitFeedback"
    if not (d / "models_kernel" / f"{rnd:04d}.model").exists():
        return None
    return demo_rmse_at("implicitFeedback", d, "kernel", rnd)


def mesh_plus_k5(torch, dev, pool, card, failures):
    """K5 at the pool writeback of the 2x2 SVD++ mesh_big slab: the slab of
    model position 0 ([n_real + 1, W], the scratch row last), which holds
    the feedback rows (the first NF rows of the table), and one chunk's
    FULL pool (phase 11 (a)'s chunk 0) in its local ids, merged by
    ops/svdpp_big._fb_writeback_big (non-owned entries to the scratch row
    with zeros).  Bit for bit against the plain version, timed in turns
    with it and with index_copy_."""
    from svdfeature_tpu_torch.ops import big_embed, svdpp_big
    from svdfeature_tpu_torch.parallel import mesh_big, svdpp_mesh

    k = BIG_PLUS["KF"]
    n = BIG_PLUS["NU"] + BIG_PLUS["NI"] + BIG_PLUS["NF"] + 1
    n_real, n_phys = mesh_big.big_layout(n, 2)
    rng = np.random.default_rng(20)
    slab = torch.from_numpy(rng.standard_normal((n_phys, big_embed.aug_width(k)),
                                                dtype=np.float32)).to(dev)
    slab[-1] = 0.0
    cfb = svdpp_mesh.local_pool({name: x.to(dev) for name, x in pool.items()}, "fb_block",
                                0, n_real, n_real)
    G = int(pool["fb_block"].max())  # the pool's padding block
    delta = torch.from_numpy(rng.standard_normal((G + 1, k), dtype=np.float32)).to(dev)
    delta_b = torch.from_numpy(rng.standard_normal(G + 1, dtype=np.float32)).to(dev)
    name = "pool writeback (model position 0)"
    shapes = k5_first_calls(torch, lambda: svdpp_big._fb_writeback_big(
        slab.clone(), cfb, delta, delta_b, k, True), {0: name})
    timing = time_k5_shapes(torch, 20, "the 2x2 SVD++ mesh_big slab", slab, shapes, card, failures)
    return timing[f"the 2x2 SVD++ mesh_big slab {name}"]


def phase_mesh_plus_runs(work):
    """Phase 20's runs: tag -> (train, infer) CLI arguments, the conf
    first, the mesh keys and logs included (its output directories made)."""
    runs = {}
    for tag, run in MESH_PLUS_RUNS.items():
        out = work / f"mesh20_{tag}"
        out.mkdir()
        train, infer = mesh_plus_args(tag, work / run["data"], out)
        keys = ["distributed=1", *MESH_KEYS]
        runs[tag] = ([*train, *keys, f"log_jsonl={out}/train.jsonl"], [*infer, *keys])
    return runs


def phase_mesh_plus(torch, work, prior, card, failures, call):
    """The SVD++ and multi-IMFB trainers on a 2x2 mesh through the train
    and infer CLIs under torchrun (MESH_PLUS_RUNS, in ``call``: the records,
    output, seconds and runs of the torchrun call that ran
    phase_mesh_plus_runs, mesh_call): every figure within MESH_PLUS_TOL of
    the JAX package's 2x2 CPU mesh (P@20 within MESH_PLUS_P20_TOL, (c)'s
    checkpoint within MESH_PLUS_W_TOL of JAX's), (b) within MESH_PLUS_TOL of
    phase 11 (a) at round 2; no kernel on small slabs, K5 twice a mesh step
    on every rank on big ones (exact counts), the same steps on every rank
    and none on another card; then K5 at the mesh pool writeback's shape.
    ``prior``: phase 11's figures (mesh_plus_expected_steps, its round-2
    probe RMSE, its chunk-0 pool, or None: no K5 timing).  Returns the K5
    launches of every rank, with the K5 timing."""
    from svdfeature_tpu_torch.model import SVDModel
    from svdfeature_tpu_torch.params import SVDTypeParam

    expected = mesh_plus_expected_steps(work, prior)
    single = phase5_single(work, MESH_PLUS_RUNS["a"]["rounds"])
    k5 = 0
    records, _, secs, _ = call
    if records is None:
        failures.append("mesh call (phase 20)")
        print(f"phase 20 FAIL: the torchrun call failed after {secs:.1f} s", flush=True)
    else:
        tags = list(MESH_PLUS_RUNS)
        ranks = [[records[f"20{tag}"][r] for tag in tags] for r in range(MESH_RANKS)]
        print(f"phase 20: runs {tags} on {MESH_RANKS} ranks "
              f"{[r[0]['backend'] for r in ranks]} on cuda:{[r[0]['device'] for r in ranks]}",
              flush=True)
        for i, tag in enumerate(tags):
            recs = [r[i] for r in ranks]
            run, out = MESH_PLUS_RUNS[tag], work / f"mesh20_{tag}"
            R = run["rounds"]
            jax = JAX_MESH_PLUS[tag]
            lines = [json.loads(x) for x in (out / "train.jsonl").read_text().splitlines()]
            round_s = [x["round_s"] for x in lines]
            rows = lines[0]["examples"]
            steps = recs[0]["steps"]
            launches = [x["launches"] for x in recs]
            want = {kid: 0 for kid in launches[0]}
            if run["big"]:
                want["K5"] = 2 * steps
                k5 += sum(x["K5"] for x in launches)
            checks = [all(x == want for x in launches), steps > 0,
                      all(x["steps"] == steps for x in recs), not any(x["stray"] for x in recs),
                      steps == expected.get(tag, steps)]
            if tag == "c":
                final = rank_p20(out / "pred.txt")
                with open(out / "models" / f"{R:04d}.model", "rb") as f:
                    w = SVDModel.load(f, SVDTypeParam.from_bytes(f.read(4)),
                                      device=torch.device("cpu")).w.numpy()
                jw = np.load(ROOT / "scripts" / "mesh_plus_jax_rank_w.npy")
                dw = float(np.abs(w - jw).max()) if w.shape == jw.shape else math.inf
                checks += [abs(final - jax) < MESH_PLUS_P20_TOL, dw < MESH_PLUS_W_TOL]
                vs = (f"P@20 {final:.6f} after {R} rounds with the ranker on the same mesh keys "
                      f"(minus JAX CPU mesh {final - jax:+.6f}, tol {MESH_PLUS_P20_TOL:g}); "
                      f"round-{R} checkpoint w max |port - JAX CPU mesh| {dw:.2e} (tol "
                      f"{MESH_PLUS_W_TOL:g})")
            else:
                final = float((out / "eval.tsv").read_text().split()[-1])
                what = "probe" if run["big"] else "test"
                checks.append(abs(final - jax) < MESH_PLUS_TOL)
                vs = (f"{what} RMSE {final:.6f} after {R} rounds (minus JAX CPU mesh "
                      f"{final - jax:+.2e}, tol {MESH_PLUS_TOL:g})")
                if tag == "a":
                    vs += (f"; phase 5's single card at round {R} "
                           f"{'not kept' if single is None else f'{single:.6f}'}")
                if tag == "b":
                    ref = prior["rmse"][R]
                    checks.append(abs(final - ref) < MESH_PLUS_TOL)
                    vs += f"; minus phase 11 (a) at round {R} {final - ref:+.2e}"
            ok = all(checks) and math.isfinite(final)
            if not ok:
                failures.append(f"mesh run 20 ({tag})")
            train_s = round_s[1:] if R > 1 else round_s
            per_round = steps // R
            eps = rows * len(train_s) / sum(train_s)
            ms = 1e3 * sum(train_s) / (per_round * len(train_s))
            when = f"rounds 2-{R}" if R > 1 else "round 1, its packing included"
            print(f"phase 20 {'ok' if ok else 'FAIL'}: mesh ({tag}) "
                  f"{' '.join(run['keys']) or 'default'} {run['data']}: {vs}; {steps} mesh steps "
                  f"on each rank (want {expected.get(tag, 'the same on every rank')}); launches "
                  f"on each rank {launches} (want {want}); bytes on the other cards "
                  f"{[x['stray'] for x in recs]} (want 0); training {eps:,.0f} examples/s, "
                  f"{ms:.2f} ms a mesh step, {when} (round seconds {round_s}); train CLI "
                  f"{max(x['train_s'] for x in recs):.1f} s, infer CLI "
                  f"{max(x['infer_s'] for x in recs):.1f} s, peak device memory a rank "
                  f"{max(x['peak'] for x in recs) / 2**30:.2f} GiB; on {card}", flush=True)
            shutil.rmtree(out / "models", ignore_errors=True)
    timing = (None if prior["pool"] is None else  # scripts/mesh_check.py keeps no pool
              mesh_plus_k5(torch, torch.device("cuda", 0), prior["pool"], card, failures))
    return k5, timing


# ---- phase 21: the bilinear trainer on a 2x2 mesh -----------------------------------
# Two runs of phase 16's data through the train and infer CLIs, in the torchrun
# call of phases 19 and 20: (a) the item-item W_bi of phase 16 (b) on small
# slabs (W_bi 1682 x 1682 sharded over model), no kernel; (b) big bilinear on
# phase 16 (d)'s data on mesh_big slabs by the auto rule, K5 three times a
# mesh step on every rank (the table's merge, the pool writeback, the W_bi
# slab write).
MESH_BI_RUNS = {  # tag: its data (phase 16's directory), keys beside its conf, rounds, slabs
    "a": dict(data="implicitFeedback", keys=BI_RUNS["b"]["keys"], rounds=2, big=False),
    "b": dict(data="bigBilinear", keys=BI_RUNS["d"]["keys"], rounds=2, big=True),
}
# the JAX package's 2x2 mesh on 4 CPU devices, same data, conf and rounds
# (scripts/mesh_bi_jax_reference.py --run a|b): the test RMSE after the last
# round (a), the probe's (b); (a)'s last-round checkpoint's w and the rows
# MESH_BI_WBI_ROWS of its W_bi are scripts/mesh_bi_jax_a.npz
JAX_MESH_BI = {"a": 0.999921, "b": 0.167179}
MESH_BI_TOL = 1e-4  # the figures against JAX's and phase 16's, the checkpoint against JAX's


def mesh_bi_wbi_rows(num_item=1682, n_model=2, seed=21):
    """The rows of (a)'s W_bi pinned in the repo (the whole 1682 x 1682 is
    11 MB): 16 at each end of each model slab and 96 drawn by
    default_rng(seed)."""
    nb = -(-(num_item + 1) // n_model)  # parallel/bilinear_mesh.pad_bi_rows / n_model
    ends = [r for m in range(n_model) for r in (*range(m * nb, m * nb + 16),
                                                 *range((m + 1) * nb - 16, (m + 1) * nb))]
    drawn = np.random.default_rng(seed).choice(num_item, 96, replace=False)
    return np.unique(np.clip(np.concatenate([ends, drawn]), 0, num_item - 1))


def mesh_bi_args(tag, d, out):
    """(train, infer) CLI arguments, the conf first, of phase 21's run
    ``tag`` on the data in ``d`` (phase 16's directory of it), its models
    and eval log under ``out``; the mesh keys are the caller's."""
    run = MESH_BI_RUNS[tag]
    R = run["rounds"]
    data = [f"buffer_feature={d}/train.buffer"]
    if run["big"]:
        conf = d / "bigSvdpp.conf"  # tested on the probe (write_big_bilinear)
    else:
        conf = ROOT / "demo" / "implicitFeedback" / "implicitFeedback.conf"
        data.append(f"test:buffer_feature={d}/test.buffer")
    common = [*data, *run["keys"], f"model_out_folder={out}/models", "silent=1"]
    return ([conf, *common, f"num_round={R}"],
            [conf, *common, f"start={R}", f"end={R + 1}", f"log_eval={out}/eval.tsv"])


def read_bi_checkpoint(path):
    """(w, W_bi) of a bilinear checkpoint the train CLI wrote, read with the
    port on the CPU."""
    import torch

    from svdfeature_tpu_torch.model import SVDModel, _read_t2d
    from svdfeature_tpu_torch.params import SVDTypeParam
    from svdfeature_tpu_torch.solvers.bilinear import BParam

    with open(path, "rb") as f:
        m = SVDModel.load(f, SVDTypeParam.from_bytes(f.read(4)), device=torch.device("cpu"))
        BParam().load(f)
        return m.w.numpy(), _read_t2d(f)


def mesh_bi_k5(torch, dev, call, card, failures):
    """K5 at the W_bi slab write of the 2x2 bilinear mesh_big: the W_bi slab
    of model position 0 ([nb_real + 1, nbf], the scratch row last) and the
    write of one step's gathered entries, which are phase 16 (d)'s first
    single-card W_bi write (``call``: the same batch, the same targets)
    with the rows model position 0 does not own sent to the scratch row as
    zeros (parallel/bilinear_mesh_big._bi_update_big).  Bit for bit against
    the plain version, timed in turns with it and with index_copy_."""
    from svdfeature_tpu_torch.parallel import bilinear_mesh_big

    nb_real, nb_phys = bilinear_mesh_big.bi_big_layout(BIG_PLUS["NI"], 2)
    idx, vals = (x.to(dev) for x in call)
    own = idx < nb_real
    idx = torch.where(own, idx, nb_real).to(torch.int32)
    vals = torch.where(own[:, None], vals, 0.0)
    rng = np.random.default_rng(21)
    slab = torch.from_numpy(rng.standard_normal((nb_phys, BIG_BI_NBF), dtype=np.float32)).to(dev)
    slab[-1] = 0.0
    name = "W_bi slab write (model position 0)"
    timing = time_k5_shapes(torch, 21, "the 2x2 bilinear mesh_big", slab, {name: (idx, vals)}, card,
                            failures)
    return timing[f"the 2x2 bilinear mesh_big {name}"]


def phase_mesh_bi_runs(work):
    """Phase 21's runs: tag -> (train, infer) CLI arguments, the conf
    first, the mesh keys and logs included (its output directories made)."""
    runs = {}
    for tag, run in MESH_BI_RUNS.items():
        out = work / f"mesh21_{tag}"
        out.mkdir()
        train, infer = mesh_bi_args(tag, work / run["data"], out)
        keys = ["distributed=1", *MESH_KEYS]
        runs[tag] = ([*train, *keys, f"log_jsonl={out}/train.jsonl"], [*infer, *keys])
    return runs


def phase_mesh_bi(torch, work, prior, card, failures, call):
    """The bilinear trainer on a 2x2 mesh through the train and infer CLIs
    under torchrun (MESH_BI_RUNS, in ``call``: the records, output, seconds
    and runs of the torchrun call that ran phase_mesh_bi_runs, mesh_call):
    (a) W_bi 1682 x 1682 on small slabs, its test RMSE within MESH_BI_TOL of
    the JAX package's 2x2 CPU mesh and of phase 16 (b) at the same round,
    its checkpoint's w and pinned W_bi rows within MESH_BI_TOL of the JAX
    mesh's (scripts/mesh_bi_jax_a.npz) and its whole W_bi and w of phase
    16 (b)'s checkpoint of the round, no kernel; (b) big bilinear on
    mesh_big slabs, its probe within MESH_BI_TOL of the JAX mesh's and of
    phase 16 (d)'s, K5 three times a mesh step on every rank (the table's
    merge, the pool writeback, the W_bi slab write); the same steps on
    every rank, phase 16's steps a round, nothing on another card; then K5
    at (b)'s W_bi slab write.  ``prior``: phase 16's (phase_bilinear; a
    figure, the checkpoint or the W_bi write None where not measured: not
    compared, no K5 timing).  Returns the K5 launches of every rank, with
    the K5 timing."""
    k5 = 0
    records, _, secs, _ = call
    if records is None:
        failures.append("mesh call (phase 21)")
        print(f"phase 21 FAIL: the torchrun call failed after {secs:.1f} s", flush=True)
    else:
        for tag, run in MESH_BI_RUNS.items():
            recs = records[f"21{tag}"]
            out, R = work / f"mesh21_{tag}", run["rounds"]
            jax, single = JAX_MESH_BI[tag], prior["rmse"].get(tag)
            lines = [json.loads(x) for x in (out / "train.jsonl").read_text().splitlines()]
            round_s = [x["round_s"] for x in lines]
            steps = recs[0]["steps"]
            want_steps = R * prior["T"][tag] if tag in prior["T"] else steps
            launches = [x["launches"] for x in recs]
            want = {kid: 0 for kid in launches[0]}
            if run["big"]:
                want["K5"] = 3 * steps
                k5 += sum(x["K5"] for x in launches)
            final = float((out / "eval.tsv").read_text().split()[-1])
            checks = [all(x == want for x in launches), steps == want_steps > 0,
                      all(x["steps"] == steps for x in recs), not any(x["stray"] for x in recs),
                      math.isfinite(final), abs(final - jax) < MESH_BI_TOL]
            what = "probe" if run["big"] else "test"
            vs = (f"{what} RMSE {final:.6f} after {R} rounds (minus JAX CPU mesh "
                  f"{final - jax:+.2e}, tol {MESH_BI_TOL:g}); ")
            if single is None:
                vs += "phase 16 not run"
            else:
                checks.append(abs(final - single) < MESH_BI_TOL)
                vs += f"minus phase 16 ({'d' if run['big'] else 'b'}) at round {R} {final - single:+.2e}"
            if tag == "a":
                w, W = read_bi_checkpoint(out / "models" / f"{R:04d}.model")
                ref = np.load(ROOT / "scripts" / "mesh_bi_jax_a.npz")
                dw = float(np.abs(w - ref["w"]).max()) if w.shape == ref["w"].shape else math.inf
                dW = float(np.abs(W[ref["rows"]] - ref["W_bi"]).max())
                checks += [dw < MESH_BI_TOL, dW < MESH_BI_TOL]
                vs += (f"; round-{R} checkpoint max |port - JAX CPU mesh| w {dw:.2e}, W_bi's "
                       f"{len(ref['rows'])} pinned rows {dW:.2e} (tol {MESH_BI_TOL:g})")
                if prior["ckpt"] is not None:
                    sw, sW = read_bi_checkpoint(prior["ckpt"])
                    ds_w, ds_W = float(np.abs(w - sw).max()), float(np.abs(W - sW).max())
                    checks += [ds_w < MESH_BI_TOL, ds_W < MESH_BI_TOL]
                    vs += (f"; against phase 16 (b)'s round-{R} checkpoint w {ds_w:.2e}, the "
                           f"whole W_bi {W.shape[0]} x {W.shape[1]} {ds_W:.2e}")
            ok = all(checks)
            if not ok:
                failures.append(f"mesh run 21 ({tag})")
            rows = lines[0]["examples"]
            train_s = round_s[1:] if R > 1 else round_s
            ms = 1e3 * sum(train_s) / (steps // R * len(train_s))
            print(f"phase 21 {'ok' if ok else 'FAIL'}: mesh ({tag}) {' '.join(run['keys'])} "
                  f"{run['data']}: {vs}; {steps} mesh steps on each rank (want {want_steps}); "
                  f"launches on each rank {launches} (want {want}); ranks "
                  f"{[x['backend'] for x in recs]} on cuda:{[x['device'] for x in recs]}, bytes on "
                  f"the other cards {[x['stray'] for x in recs]} (want 0); training "
                  f"{rows * len(train_s) / sum(train_s):,.0f} examples/s, {ms:.2f} ms a mesh step, "
                  f"{f'rounds 2-{R}' if R > 1 else 'round 1, its packing included'} (round "
                  f"seconds {round_s}); train CLI "
                  f"{max(x['train_s'] for x in recs):.1f} s, infer CLI "
                  f"{max(x['infer_s'] for x in recs):.1f} s, peak device memory a rank "
                  f"{max(x['peak'] for x in recs) / 2**30:.2f} GiB; on {card}", flush=True)
            shutil.rmtree(out / "models", ignore_errors=True)
    timing = (None if prior["wbi_call"] is None else
              mesh_bi_k5(torch, torch.device("cuda", 0), prior["wbi_call"], card, failures))
    return k5, timing


def kernel_line(name, source, replaces, launches, max_err, timing):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err, "ms": timing["kernel"],
            "plain_ms": timing["plain"], "bound_ms": timing["bound"],
            "bound_by": timing["bound_by"], "library_ms": timing.get("library")}


def main() -> int:
    if sys.argv[1:2] == ["--mesh-rank"]:  # a rank of phase 19's or 20's torchrun world
        return mesh_rank(sys.argv[2:])
    start = time.perf_counter()
    card = card_line()
    print(f"phase 0: {card}", flush=True)
    import torch

    if not torch.cuda.is_available():
        print("phase 0 FAIL: torch.cuda.is_available() is false", flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # stated for the comparisons:
    torch.backends.cudnn.allow_tf32 = False        # full f32 on both sides
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from svdfeature_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"phase 1 ok: built {_build.BUILD_DIR / _build.LIB_NAME} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    failures = []
    kernel = None
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"phase 1 ptxas: {line.strip()}")
        if "Compiling entry" in line:
            kernel = line.split("'")[1]
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills and "sweep_wide_kernel" in (kernel or "") and spills.groups() != ("0", "0"):
            failures.append(f"phase 1: sweep_wide_kernel spills ({line.strip()})")
    if failures:
        print(f"phase 1 FAIL: {failures}", flush=True)

    clock = {"t": time.perf_counter()}

    def phase_time(name):
        now = time.perf_counter()
        print(f"{name} took {now - clock['t']:.1f} s", flush=True)
        clock["t"] = now

    k1_err, k1_timing = phase_kernel(torch, dev, card, failures)
    phase_time("phase 2")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        k1_launches, k1_eps, k1_rmse = phase_slice(pathlib.Path(work), card, failures)
        phase_time("phase 3")
        k2_err, k2_timing = phase_svdpp_kernel(torch, dev, card, failures)
        phase_time("phase 4")
        k2_launches, k2_eps = phase_svdpp_slice(pathlib.Path(work), card, failures)
        phase_time("phase 5")
        big = bigtable_arrays()
        big_timing = phase_big_kernels(torch, dev, big, card, failures)
        phase_time("phase 6")
        big_launches, big_staged = phase_bigtable(pathlib.Path(work), big, card, failures)
        phase_time("phase 7")
        k3_err, k3_timing = phase_imfb_kernel(torch, dev, card, failures)
        phase_time("phase 8")
        k3_launches, k3_eps = phase_imfb_slice(pathlib.Path(work), card, failures)
        phase_time("phase 9")
        phase_general(pathlib.Path(work), card, failures)
        phase_time("phase 10")
        k5_plus_launches, _, big_plus_eps, big_plus = phase_big_plus(pathlib.Path(work), card,
                                                                     failures)
        phase_time("phase 11")
        from svdfeature_tpu_torch.cli import make_ugroup_buffer

        rank_dir = pathlib.Path(work) / "pairwiseRank"
        rank_dir.mkdir()
        rank_keys = write_rank(rank_dir, make_ugroup_buffer.main)
        pair_err, _ = phase_pair_kernel(torch, rank_dir, rank_keys, card, failures)
        phase_time("phase 12")
        k2_rank_launches = phase_rank_slice(rank_dir, rank_keys, card, failures)
        phase_time("phase 13")
        k5_rank_launches, _ = phase_big_rank(torch, card, failures)
        phase_time("phase 14")
        phase_refresh(pathlib.Path(work), card, failures, k2_eps)
        phase_time("phase 15")
        k5_bi_launches, k5_bi_timing, bi_prior = phase_bilinear(torch, pathlib.Path(work), card,
                                                                failures)
        phase_time("phase 16")
        phase_gbrt(torch, pathlib.Path(work), rank_dir, rank_keys, card, failures)
        phase_time("phase 17")
        stream_launches = phase_stream(pathlib.Path(work), dict(
            big_staged, g=dict(eps=k1_eps), b=dict(eps=k2_eps), d=dict(eps=big_plus_eps),
            e=dict(eps=k3_eps)), card, failures)
        phase_time("phase 18")
        # phases 19-21 share one torchrun call of MESH_RANKS ranks
        call = mesh_call_all(torch, pathlib.Path(work))
        phase_time("phases 19-21's torchrun call")
        k5_mesh_launches, k5_mesh_timing = phase_mesh(
            torch, pathlib.Path(work), big, dict(big_staged, phase3=k1_rmse), card, failures,
            call)
        phase_time("phase 19's checks")
        k5_plus_mesh_launches, k5_plus_mesh_timing = phase_mesh_plus(
            torch, pathlib.Path(work), big_plus, card, failures, call)
        phase_time("phase 20's checks")
        k5_bi_mesh_launches, k5_bi_mesh_timing = phase_mesh_bi(
            torch, pathlib.Path(work), bi_prior, card, failures, call)
        phase_time("phase 21's checks")
    print(f"chip_smoke.py took {time.perf_counter() - start:.1f} s on {card}", flush=True)

    if failures:
        print(f"FAILED phases: {failures}", flush=True)
        return 1
    print(json.dumps({"kernels": [
        kernel_line("fused_embed (sgd_rounds, one cooperative launch a call)",
                    "svdfeature_tpu_torch/csrc/fused_embed.cu",
                    "svdfeature_tpu/ops/pallas_embed.py:75", k1_launches + stream_launches["K1"],
                    k1_err,
                    k1_timing["basicMF"]),
        kernel_line("fused_svdpp (svdpp_rounds, one cooperative launch a call)",
                    "svdfeature_tpu_torch/csrc/fused_svdpp.cu",
                    "svdfeature_tpu/ops/pallas_svdpp.py:110",
                    k2_launches + k2_rank_launches + stream_launches["K2"],
                    max(k2_err, pair_err), k2_timing),
        kernel_line("fused_imfb (imfb_rounds, one cooperative launch a call)",
                    "svdfeature_tpu_torch/csrc/fused_imfb.cu",
                    "svdfeature_tpu/ops/pallas_svdpp.py:110", k3_launches + stream_launches["K3"],
                    k3_err, k3_timing),
        kernel_line("tile_sweep (sweep_apply)", "svdfeature_tpu_torch/csrc/tile_sweep.cu",
                    "svdfeature_tpu/ops/tile_sweep.py:143", big_launches["K4"] + stream_launches["K4"],
                    big_timing["K4"]["err"], big_timing["K4"]),
        # K4 on rows of more than 256 factors (phase 6's wide cases, phase 7
        # (e)'s launches); its time at k=512 beside
        dict(kernel_line("tile_sweep (sweep_apply), rows of 300 factors (sweep_wide_kernel)",
                         "svdfeature_tpu_torch/csrc/tile_sweep.cu",
                         "svdfeature_tpu/ops/tile_sweep.py:143", big_launches["K4 wide"],
                         big_timing["K4 wide"][300]["err"], big_timing["K4 wide"][300]),
             k512={name: big_timing["K4 wide"][512][key] for name, key in (
                 ("ms", "kernel"), ("plain_ms", "plain"), ("bound_ms", "bound"),
                 ("bound_by", "bound_by"))}),
        kernel_line("row_writer (row_write)", "svdfeature_tpu_torch/csrc/row_scatter.cu",
                    "svdfeature_tpu/ops/pallas_scatter.py:43",
                    big_launches["K5"] + k5_plus_launches + k5_rank_launches
                    + stream_launches["K5"] + k5_mesh_launches + k5_plus_mesh_launches
                    + k5_bi_mesh_launches,
                    big_timing["K5"]["err"], big_timing["K5"]),
        # K5 on the 2x2 mesh_big path (phase 19 (b)): each rank's slab writes
        kernel_line("row_writer (row_write), slab writes of the 2x2 mesh_big, every rank",
                    "svdfeature_tpu_torch/csrc/row_scatter.cu",
                    "svdfeature_tpu/ops/pallas_scatter.py:43", k5_mesh_launches,
                    k5_mesh_timing["err"], k5_mesh_timing),
        # K5 on the 2x2 SVD++ / multi-IMFB mesh_big path (phase 20 (b), (e), (f)):
        # each rank's row writes and pool writebacks
        kernel_line("row_writer (row_write), row writes and pool writebacks of the 2x2 SVD++ "
                    "and multi-IMFB mesh_big, every rank",
                    "svdfeature_tpu_torch/csrc/row_scatter.cu",
                    "svdfeature_tpu/ops/pallas_scatter.py:43", k5_plus_mesh_launches,
                    k5_plus_mesh_timing["err"], k5_plus_mesh_timing),
        # K5 on the 2x2 bilinear mesh_big path (phase 21 (b)): each rank's
        # row writes, pool writebacks and W_bi slab writes
        kernel_line("row_writer (row_write), row writes, pool writebacks and W_bi slab writes of "
                    "the 2x2 bilinear mesh_big, every rank",
                    "svdfeature_tpu_torch/csrc/row_scatter.cu",
                    "svdfeature_tpu/ops/pallas_scatter.py:43", k5_bi_mesh_launches,
                    k5_bi_mesh_timing["err"], k5_bi_mesh_timing),
        # K5 on big bilinear's path (phase 16 (d)): its W_bi write
        kernel_line("row_writer (row_write), W_bi rows of big bilinear",
                    "svdfeature_tpu_torch/csrc/row_scatter.cu",
                    "svdfeature_tpu/ops/pallas_scatter.py:43", k5_bi_launches,
                    k5_bi_timing["big bilinear (d) W_bi write"]["err"],
                    k5_bi_timing["big bilinear (d) W_bi write"]),
        kernel_line("row_reader (row_read)", "svdfeature_tpu_torch/csrc/row_scatter.cu",
                    "svdfeature_tpu/ops/pallas_scatter.py:111", big_launches["K6"],
                    big_timing["K6"]["err"], big_timing["K6"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
