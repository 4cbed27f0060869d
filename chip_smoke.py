"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:
  1. device facts: nvidia-smi name and power limit, torch's device name,
     room in /dev/shm for the snapshot managers' buffers and room in the
     temp directory for the durable runs of phase 5;
  2. build every CUDA kernel from the sources (nvcc, sm_90a), timed, with
     ptxas's registers and spills of swa_flash's bf16 kernels, of the
     SSD kernels and of encode_bucket's two instances;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it, with CUDA-event times: encode_bucket
     bit-exact at ENCODE_CASES (and a tile wider than one cluster's
     refused), and its fused entry (encode_ranges, the
     leaf gather in the kernel) bit-exact against its plain version and
     against gather_bytes + encode_bucket at buckets of opt-125m's real
     FlatSpec (leaves filled with seeded random bytes; an own bucket 2
     bytes into its leaf, the one spanning the most leaves, a kind-2
     parity bucket with and without its CRC, the tail bucket), each
     timed fused and as gather + kernel (the kernels line's encode_bucket
     times are the fused own bucket's, the instance the paths run); the
     SSD scan's chunked forward and backward kernels
     against the plain chunked scan and its autograd in fp32 and in fp64
     (TF32 off), at mamba2-130m's shape with a zero and a random initial
     state and at SSD_EDGE_CASES (Q 250, ragged P and N, N 16 and 256, Q
     1), two launches bit-equal, timed beside the bound of the products
     they do (bf16x3) and the serial kernels' fp32 bound, and the
     forward alone at the serving path's calls (mamba2-130m's prefill,
     32 x 32768, and the decode check's, 128 x 24; jamba-v0.1-52b's, 128
     heads of state 16, 1 x 32768 and 36 x 24), the whole batch
     launched and each row held against the plain scan on that row in
     fp32 and in fp64, and both kernels at the hybrid train check's
     shape (1 x 4096, Jamba's heads) held and timed beside their bounds;
     the sliding-window flash
     attention's forward and backward kernels (the fp32 route's CUDA-core
     kernels, the bf16 route's tensor-core kernels, whose backward time
     includes its D pre-pass) against the plain flash attention and its
     autograd, in fp32 and in bf16, at starcoder2-3b's
     shape, at hubert-xlarge's (hd 80, non-causal, the hd-128 kernels on
     zero-filled columns) and at gemma3-4b's head shape (local and global
     window), the forward alone in bf16 at the serving path's prefill
     calls (S 32768: gemma3-4b's local and global layers at its 8 rows,
     starcoder2-3b's at its 12, phi-3-vision-4.2b's, hd 96, at its 4,
     dbrx-132b's, 8 KV heads of 6 query heads each, at its 1,
     jamba-v0.1-52b's, 8 KV heads of 4, at its 1; and Jamba's train
     shape, 1 x 4096, forward and backward),
     the whole batch launched and each row held against the
     plain version on that row, timed at the batch and at one row, with
     SDPA's memory-efficient attention timed beside them as a yardstick,
     every bf16 output also held row by row against the reference's own
     scale, then at small shapes at the contract's edges (ragged S,
     non-causal, window 1, B 2, hd 64 and 256, and the padded hd 80, 96
     and 112 ragged, windowed, non-causal and with G 8), row by row in
     both types;
     in every causal bf16 case, the first 64 rows' dq shown (no bound)
     against the fp64 gradient with the exact D and with D from the
     kernel's rounded O;
     the RAIM5 XOR parity kernel (xor_reduce) bit-exact at the opt-125m
     path's stripe, a 4 MiB bucket, an odd lane count (its 4-byte body),
     one row and eight rows, and the public entry point
     (xor_parity_encode / xor_parity_decode) byte for byte against the
     host codec raim5.xor_blocks at that stripe;
  4. the main paths at full width, each through `repro_torch.launch.train`
     with REFT, a software failure mid-flight (recovered from memory when
     every member's SMP held the restored step when the restore read,
     else by a RAIM5 decode, as when the failed member's flight was still
     in the air: each restore records the members' clean steps and each
     engine's own record of the flights that had landed) and a node
     failure (recovered by a RAIM5 decode), every restored state checked
     byte for byte: opt-125m (seq 256), mamba2-130m (seq 2048, the SSD
     kernels in every layer), then starcoder2-3b (2 of its 30 layers, seq
     16384, batch 1, the swa_flash kernels in every layer), then
     hubert-xlarge (24 of its 48 layers, seq 4096, batch 1, frame
     embeddings, non-causal swa_flash at hd 80 in every layer); the
     launch counts are set to 0 just before each run and read just after
     it, and the device memory allocated once the run returned (before
     any collection) is held within 1 GB of what it was before the run;
  5. the durable tiers at full width, one path (counts set to 0 before
     it, read after it), opt-125m (seq 256, an SG of 4, 12 steps, every
     restore checked byte for byte):
     - an objstore run, a persist every 4 steps: recovered from memory,
       then by a RAIM5 decode; persisted families uploaded to the object
       store with their manifests;
     - below RAM: a fresh objstore checkpointer over that directory (its
       managers hold nothing): restore from the .reft family (tier
       checkpoint), with the CRC the run recorded for that step; 4 bytes
       of a data block damaged in a .reft file and in a store object, one
       scrub of both tiers finds and repairs them, the original bytes
       back; every .reft deleted, restore from the store (tier objstore),
       same CRC; each restored state moved to the card;
     - the kernel entry point on that state and store: every stripe's
       parity through xor_parity_encode on the card, byte for byte
       against the parity blocks the managers persisted, and node 1's
       data blocks back through xor_parity_decode;
     - the disk baselines, `--backend sync_disk`, then `async_disk`, a
       software failure at step 6 recovered from disk (tier disk), with
       their median steps beside the REFT opt-125m path's of phase 4
       and the last save's d2h / serialize / persist seconds;
  6. the supervised fault drill at full width, one path: `python -m
     repro_torch.supervise.run` (in process) on opt-125m, seq 256, an SG
     of 4, 24 steps, `--auto-tune`, seven seeded scenarios of every kind
     (at least one mid-flight), the last a preempt that rebuilds the SG
     with 2 members; fails unless the run's own exit checks hold, every
     failure is recovered, every restore is byte-exact against the
     oracle ring, the 4 -> 2 rebuild restored, and the old SG's /dev/shm
     segments are gone once it did and none are left after the run;
     prints each event, the goodput fraction and its seconds by
     category, the cadence the tuner chose, and what the oracle ring
     (a copy of the state on the card every step) costs a step;
  7. delta flights and pipeline stages at full width: the trainer with
     `--delta` (the two failures of phase 4, each restore byte-exact; the
     dense per-bucket digest compare encodes every kind-2 bucket with
     its CRC, counted on their own), then a delta chain over opt-125m's
     state on the card through a dirty provider, its `.reft` / `.reftd`
     family restored byte-exact (one path); then the MoE delta run:
     `--delta` on reduced dbrx-132b at seq 2048 (the fp32 swa_flash
     kernels in every layer, the two failures, each restore byte-exact),
     each call of the touched-expert provider printed, every byte ruled
     dirty and no bucket clean (one path); then the hybrid delta run,
     the same on reduced jamba-v0.1-52b (an SSM layer with an MLP, then
     attention with the MoE: the SSD and the fp32 swa_flash kernels,
     forward and backward; one path); then `MultiStageGroup(2, 2)`
     over the state after a train step, one node lost in each stage,
     both stages recovered byte-exact, each stage's tier printed (one
     path);
  8. serving at full width, one path (counts set to 0 before it, read
     after it): gemma3-4b (34 layers), starcoder2-3b (30), mamba2-130m
     (24) and phi-3-vision-4.2b (32; its prompts 576 patch embeddings,
     then tokens) at full depth, dbrx-132b with its depth cut to 8 of 40
     layers and jamba-v0.1-52b with its depth cut to 16 of 32 (two
     periods of 8: 7 SSM layers and an attention layer, the MoE on every
     other layer; every cache position `pos0..pos7` walked) (each decode
     check on a 2-layer model of the model's widths at a drop-free
     capacity, Jamba's attention with an MLP then an SSM layer with the
     MoE; the share of routes its prefill and decode pick alike
     printed), weights from a seed on the card, each through
     `models.model`'s `logits_fn` (prefill_32k's 32768 positions, timed; its
     caches shaped as `init_cache`'s), a decode check (24 teacher-forced
     tokens through `decode_step` from an empty cache of the decode
     shape's length, the last logits and the caches decode wrote held
     against `logits_fn`'s: in fp32 on fp32 copies of the weights (the
     first rows that fit) at DECODE_FP32_TOL, then in bf16 at a bound
     scaled by the bf16 prefill's distance from the fp32 one), then decode
     steps timed at the full cache (gemma3-4b decode_32k, starcoder2-3b
     long_500k, mamba2-130m, phi-3-vision-4.2b and dbrx-132b decode_32k)
     beside their bound (weights and
     cache read once at the HBM rate), peak device memory; the prefills
     launch swa_flash and ssd_scan in every layer; then `python -m
     repro_torch.examples.serve --device cuda` and `python -m
     repro_torch.analyze --strict src/repro_torch` as subprocesses;
  9. distribution and the dry-run: (a) `repro_torch.launch.dryrun` on
     the production 16x16 mesh for DRY_PAIRS (one chip's sharded fake
     program: FLOPs, bytes, collectives, argument and peak bytes, all
     predictions), in a process of its own; (b) phase 8's five prefill
     calls dry-run on a (1, 1) mesh (dbrx-132b at its cut depth), each
     predicted peak held within
     PEAK_RATIO of the prefill's measured peak
     (torch.cuda.max_memory_allocated, reset just before it, less the
     bytes live before it other than its arguments), the roofline time
     printed beside the measured seconds; (c) on a real one-rank NCCL
     group, a (1, 1) DeviceMesh: DTENSOR_RUNS' forward and backward
     with the params as DTensors, the loss and every gradient bit-equal
     to the plain tensors' (counts set to 0 before each run: starcoder2's
     and dbrx-132b's swa_flash launches through its custom op's sharding
     rule; dbrx-132b at full width, one layer, S 4096: the MoE forward
     and backward, the GSPMD route on one rank); (e) the hybrid train
     check: one period of jamba-v0.1-52b at full width (8 layers, bf16,
     1 x 4096), forward and backward with the kernels and no optimizer,
     every gradient finite with a nonzero norm, the loss held against
     the same forward through the plain versions, the peak printed (one
     path, after (d)); (d)
     reshard-on-restore: full-width opt-125m's state snapshotted by an SG
     of 4, restored for each coordinate of a (data 2, model 2) mesh
     through `RestoreTarget(shardings=state_specs(...), mesh, coord)`,
     every byte of the coordinate's ranges equal to the saved byte and
     the loader's plan covering exactly those ranges;
 10. a `serving`, a `distribution` and a `kernels` JSON line, the card's
     name and power limit, and as the last line {"ok": true, "device":
     {...}}.

`python3 chip_smoke.py --step-time ROOT [ROOT ...]` instead times the
phase-4 paths' training steps with no checkpointing under each checkout
ROOT's trainer (`step_time`).

Exits non-zero without a result when no CUDA device is present, or when
run outside a checkout of the repository (it needs `src/repro_torch`).
The module body stays import-light: the snapshot managers start with
`spawn` and re-import this file.
"""
import bisect
import contextlib
import gc
import importlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

RUN_ARGS = ["--backend", "reft", "--sg-size", "4", "--steps", "12",
            "--snapshot-every", "2",
            "--inject", "6:software", "--inject", "10:node",
            "--device", "cuda", "--verify-restores"]
# (arch, seq, batch, layers (None: full depth), kernels that must launch
# on that path). starcoder2-3b's depth is cut to 2 of 30 layers: at full
# depth its REFT state (43.1 GB) would not fit three times on the card
# (snapshots in flight hold the old state while the step builds the new)
# nor four SMPs' buffers in /dev/shm; every width is kept. hubert-xlarge
# runs at full width (frame embeddings, hd 80 through the padded
# swa_flash kernels, non-causal, seq 4096) with 24 of its 48 layers and
# 1 row. Both cuts keep the script inside its time limit: with 4
# starcoder2-3b layers, hubert-xlarge at full depth and 2 rows, the
# script took 1380 s on an NVIDIA H100 80GB HBM3 at 700 W (the limit is
# 1200 s), their two paths 455 s of it, most of that in the flights and restores of their 8.4
# and 12.6 GB states (now 5.7 and 6.3 GB).
PATHS = [("opt-125m", 256, 2, None, ("encode_bucket",)),
         ("mamba2-130m", 2048, 2, None,
          ("encode_bucket", "ssd_scan", "ssd_scan_bwd")),
         ("starcoder2-3b", 16384, 1, 2,
          ("encode_bucket", "swa_flash", "swa_flash_bwd")),
         ("hubert-xlarge", 4096, 1, 24,
          ("encode_bucket", "swa_flash", "swa_flash_bwd"))]
SG = 4                             # SG members on every path
# the durable tiers' path (phase 5): opt-125m at full width under the
# objstore backend, then the paper's disk baselines
DURABLE_ARCH, DURABLE_SEQ, DURABLE_BATCH = "opt-125m", 256, 2
DURABLE_ARGS = ["--arch", DURABLE_ARCH, "--seq", str(DURABLE_SEQ), "--batch",
                str(DURABLE_BATCH), "--sg-size", str(SG), "--steps", "12",
                "--snapshot-every", "2", "--device", "cuda",
                "--verify-restores"]
KEEP = 3                           # CheckpointSpec.keep, the default
DURABLE = "durable tiers"          # the path's name in launches_by_path
# phase 6: the supervised drill (`repro_torch.supervise.run`) at full width,
# every fault kind, the last scenario a preempt that rebuilds the SG 4 -> 2
DRILL = "supervised drill"
DRILL_KINDS = ("software", "node", "smp", "laggard", "corrupt-stripe",
               "slow-persist", "preempt")
DRILL_ARGS = ["--arch", "opt-125m", "--seq", "256", "--batch", "2",
              "--sg-size", str(SG), "--snapshot-every", "2",
              "--ckpt-every", "8", "--steps", "24", "--seed", "0",
              "--auto-tune", "--scenarios", "7",
              "--kinds", ",".join(DRILL_KINDS), "--elastic-to", "2",
              "--device", "cuda"]
# phase 7: delta flights (the CLI's dense digest compare, then a chain
# through a dirty provider), and one SG per pipeline stage
DELTA = "delta run"
DELTA_ARGS = ["--arch", "opt-125m", "--seq", "256", "--batch", "2",
              "--delta", *RUN_ARGS]
# the MoE delta run (phase 7): reduced dbrx-132b (every layer MoE, fp32,
# hd 64: the fp32 swa_flash kernels at S 2048) under `--delta`, the
# router's touched-expert mask feeding the dirty provider
MOE_DELTA = "moe delta run"
MOE_DELTA_ARGS = ["--arch", "dbrx-132b", "--reduced", "--seq", "2048",
                  "--batch", "2", "--delta", *RUN_ARGS]
# the hybrid delta run (phase 7): reduced jamba-v0.1-52b (a period of two
# layers: an SSM layer with an MLP, then attention with the MoE; fp32, S
# 2048: the SSD kernels and the fp32 swa_flash kernels) under `--delta`
HYBRID_DELTA = "hybrid delta run"
HYBRID_DELTA_ARGS = ["--arch", "jamba-v0.1-52b", "--reduced", "--seq",
                     "2048", "--batch", "2", "--delta", *RUN_ARGS]
# (path, its arguments, the kernels that must launch on it)
MOE_RUNS = [(MOE_DELTA, MOE_DELTA_ARGS,
             ("encode_bucket", "swa_flash", "swa_flash_bwd")),
            (HYBRID_DELTA, HYBRID_DELTA_ARGS,
             ("encode_bucket", "ssd_scan", "ssd_scan_bwd", "swa_flash",
              "swa_flash_bwd"))]
DELTA_STEPS = 4                    # the chain: a keyframe, then 3 deltas
DELTA_TOUCHED = 4                  # leaves the chain's update touches
STAGES = "stage run"
N_PP, DP = 2, 2                    # MultiStageGroup(n_pp, dp)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989.4e12              # H100 SXM bf16 dense tensor cores
# phase 8: serving (prefill, then decode) at full width:
# (arch, prefill rows at prefill_32k, decode shape, decode batch, rows of
# the fp32 decode check, layers (None: full depth), layers of the decode
# check's own model (None: the served model itself)). The batches are
# cut from the shapes' (32
# prefill rows; decode_32k 128) only as far as the card's memory forces:
# the caches, their byte counts in PERF.md §4, beside the weights. The
# fp32 check's rows: its caches at the decode shape's length take twice
# the bf16 bytes beside the fp32 weights (gemma3-4b 9.1 GB a row beside
# 18.2 GB; starcoder2-3b 32.2 GB beside 17.3 GB; phi-3-vision-4.2b 25.8
# GB beside 15.3 GB). phi-3-vision's MHA caches take 12.9 GB a row at
# S 32768: 4 prefill rows and 5 decode rows fit beside its 7.6 GB of
# weights. Its prompts are its 576 patch embeddings, then tokens.
# dbrx-132b is served at full width with its depth cut to 8 of 40 layers
# (6.52 GB of weights a layer, the fp32 router included, and 2.47 GB of
# embedding and head: 54.6 GB; the dry-run's (1, 1) trace predicts the
# prefill of one 32768-token row at 70.2 GB): 1 prefill row (~15 GB of a
# layer's MoE transients at T 32768), 18 decode_32k rows (1.07 GB of
# cache a row, and ~0.28 GB of a layer's fp32 K and V at each step: 16
# rows peaked at 76.2 GB of 85.0 on an NVIDIA H100 80GB HBM3 at 700 W);
# its decode check runs on a 2-layer model of its widths
# (8 layers of fp32 weights would be 104 GB), at a capacity factor of
# its expert count (drop-free: capacity is per call, so at the published
# 1.25 a 24-token prefill may drop a token the B-token decode keeps);
# the timed prefill and decode run at the published 1.25.
# jamba-v0.1-52b is served at full width with its depth cut to 16 of 32
# layers, two periods of 8 (52.0 GB of weights; a full-width period with
# its embedding and head is 26.5 GB, so 32 layers do not fit): 1 prefill
# row and 36 decode_32k rows, as many as the dry-run's (1, 1) trace
# predicts below ~72 GB (a prefill row 63.2 GB, two 74.5 GB; 36 decode
# rows 71.8 GB, 40 rows 74.0 GB; PERF.md §4); its decode check on a 2-layer model of its
# widths (the fp32 period of 8 would be 53.1 GB beside its bf16 twin)
# with the published pairings, attention with an MLP, then an SSM layer
# with the MoE (CHECK_OVERRIDES), drop-free as dbrx-132b's.
SERVING = "serving"
SERVE_RUNS = [("gemma3-4b", 8, "decode_32k", 12, 2, None, None),
              ("starcoder2-3b", 12, "long_500k", 1, 1, None, None),
              ("mamba2-130m", 32, "decode_32k", 128, 128, None, None),
              ("phi-3-vision-4.2b", 4, "decode_32k", 5, 1, None, None),
              ("dbrx-132b", 1, "decode_32k", 18, 1, 8, 2),
              ("jamba-v0.1-52b", 1, "decode_32k", 36, 8, 16, 2)]
# the decode check's own model (`check_layers`): these fields replaced
CHECK_OVERRIDES = {"jamba-v0.1-52b": {"attn_period": 2, "attn_index": 0}}
SERVE_T = 24                       # teacher-forced tokens held vs logits_fn
SERVE_TIMED = 16                   # decode steps timed at the full Smax
# decode's bf16 bound: for the logits (each request's row) and each cache
# leaf, ||decode - prefill|| / ||prefill|| <= DECODE_BF16_K times the same
# distance of the bf16 prefill from an fp32 prefill of the same weights;
# from the CPU's spread of the reduced configs (decode departs at most
# 1.05x as far as bf16 from fp32 there: tests/test_torch_decode.py::
# test_bf16_decode_spread_is_within_the_chip_bound)
DECODE_BF16_K = 2.0
# decode's fp32 bound, by family: the same distances, fp32 weights,
# decode against the fp32 prefill. On the CPU (reduced widths, full
# depth) attention decodes exactly what its prefill computes (0) and
# Mamba2 departs by 3.1e-5, 9.1e-5 with the SSD inputs rounded as the
# kernel's bf16x3 products round them; the bounds are about ten times
# that (tests/test_torch_decode.py::test_fp32_decode_is_within_the_chip_bound);
# a VLM decodes tokens through the dense family's attention, a MoE through
# it and its experts, drop-free (tests/test_torch_decode.py: 0 on the CPU);
# a hybrid through both and an SSM layer, held at the SSM's bound
DECODE_FP32_TOL = {"dense": 1e-4, "vlm": 1e-4, "moe": 1e-4, "ssm": 1e-3,
                   "hybrid": 1e-3}
# phase 9: distribution and the dry-run. (a) the dry-run on the production
# 16x16 mesh for these pairs (one chip's sharded fake program, no device);
# (b) phase 8's prefill calls dry-run on a (1, 1) mesh, the predicted peak
# held to the measured one within PEAK_RATIO; (c) DTENSOR_RUNS forward and
# backward with the params as DTensors on a real one-rank NCCL group,
# bitwise against the plain tensors; (d) reshard-on-restore: opt-125m's
# state snapshotted by an SG of 4, restored for each coordinate of a
# RESHARD_MESH (data, model) mesh through its sharding
DIST = "distribution"
DRY_PAIRS = [("starcoder2-3b", "train_4k"), ("starcoder2-3b", "prefill_32k"),
             ("starcoder2-3b", "decode_32k"), ("starcoder2-3b", "long_500k"),
             ("gemma3-4b", "decode_32k"), ("mamba2-130m", "train_4k"),
             ("hubert-xlarge", "train_4k"),
             ("phi-3-vision-4.2b", "prefill_32k"), ("dbrx-132b", "train_4k"),
             ("jamba-v0.1-52b", "train_4k")]
PEAK_RATIO = (0.85, 1.15)
# (arch, seq, batch, layers): dbrx-132b at full width, one layer, train_4k's
# length (its MoE forward and backward; one rank: the GSPMD route)
DTENSOR_RUNS = [("opt-125m", 256, 2, None), ("starcoder2-3b", 16384, 1, 4),
                ("dbrx-132b", 4096, 1, 1)]
# the hybrid train check (phase 9): (arch, seq, batch, layers): one period
# of Jamba at full width (8 layers: 13.27e9 params, 26.5 GB in bf16, and
# as much again of gradients), train_4k's length, forward and backward
# with the kernels and no optimizer; its loss held against the same
# forward through the plain versions within HYBRID_LOSS_TOL of the loss
# (one bf16 ulp, 2**-8: the kernels and the plain versions differ in the
# order of their fp32 sums and where they round to bf16, each layer's
# output entering the bf16 residual stream at that ulp, and the loss
# averages 4096 tokens' cross-entropies)
HYBRID_TRAIN = ("jamba-v0.1-52b", 4096, 1, 8)
HYBRID_TRAIN_PATH = "hybrid train check"
HYBRID_LOSS_TOL = 2.0 ** -8
RESHARD_ARCH, RESHARD_MESH = "opt-125m", (2, 2)
DRY_RUN = (
    "import dataclasses, json, sys\n"
    "from repro_torch.configs import get_config\n"
    "from repro_torch.configs.base import INPUT_SHAPES, InputShape\n"
    "from repro_torch.launch import dryrun as DR\n"
    "from repro_torch.launch.mesh import make_mesh\n"
    "pairs, prefills = json.loads(sys.argv[1]), json.loads(sys.argv[2])\n"
    "out = {'production': [DR.run_pair(a, s, multi_pod=False)\n"
    "                      for a, s in pairs], 'prefill': []}\n"
    "mesh = make_mesh((1, 1), ('data', 'model'))\n"
    "for arch, rows, seq, layers in prefills:\n"
    "    name = f'serve_{rows}x{seq}'\n"
    "    INPUT_SHAPES[name] = InputShape(name, seq, rows, 'prefill')\n"
    "    cfg = None if layers is None else dataclasses.replace(\n"
    "        get_config(arch), num_layers=layers)\n"
    "    out['prefill'].append(DR.run_pair(arch, name, multi_pod=False,\n"
    "                                      mesh=mesh, cfg=cfg))\n"
    "print('DRYRUN_JSON ' + json.dumps(out))\n")
# the swa_flash shapes: (label, B, S, KV, G, hd, window, causal, on path:
# True for a training path's shape, fwd and bwd (the first row's times
# are the kernels line's own, the others go under its `train_cases`);
# SERVING for a layer kind of the serving path's prefill at S 32768,
# forward only: timed at B 1, held row by row at the prefill's batch,
# `_serve_batch`). hubert-xlarge (hd 80) and phi-3-vision-4.2b (hd 96)
# run the hd-128 kernels on zero-filled columns.
SWA_CASES = [("starcoder2-3b", 1, 16384, 2, 12, 128, 4096, True, True),
             ("hubert-xlarge", 1, 4096, 16, 1, 80, None, False, True),
             ("gemma3-4b local", 1, 8192, 4, 2, 256, 1024, True, False),
             ("gemma3-4b global", 1, 8192, 4, 2, 256, None, True, False),
             ("gemma3-4b prefill local", 1, 32768, 4, 2, 256, 1024, True,
              SERVING),
             ("gemma3-4b prefill global", 1, 32768, 4, 2, 256, None, True,
              SERVING),
             ("starcoder2-3b prefill", 1, 32768, 2, 12, 128, 4096, True,
              SERVING),
             ("phi-3-vision-4.2b prefill", 1, 32768, 32, 1, 96, None, True,
              SERVING),
             ("dbrx-132b prefill", 1, 32768, 8, 6, 128, None, True,
              SERVING),
             ("jamba-v0.1-52b train", 1, 4096, 8, 4, 128, None, True, True),
             ("jamba-v0.1-52b prefill", 1, 32768, 8, 4, 128, None, True,
              SERVING)]
# small shapes at the edges of the wrappers' contract: (label, B, S, KV, G,
# hd, window, causal)
SWA_EDGE_CASES = [("ragged S, hd 64", 1, 200, 2, 3, 64, 70, True),
                  ("non-causal, hd 64", 1, 150, 2, 2, 64, 50, False),
                  ("window 1", 1, 128, 2, 1, 64, 1, True),
                  ("B 2, full window", 2, 160, 1, 2, 128, None, True),
                  ("window 65, ragged", 1, 100, 2, 2, 128, 65, True),
                  ("hd 256, ragged", 1, 96, 1, 2, 256, 40, True),
                  ("hd 256, non-causal full", 1, 300, 1, 2, 256, None, False),
                  ("banded, 16 tiles", 1, 2048, 2, 3, 128, 512, True),
                  # the padded widths (the hd-128 kernels, zero-filled)
                  ("ragged S, hd 80", 1, 200, 2, 3, 80, None, True),
                  ("window 70, hd 80", 1, 300, 1, 2, 80, 70, True),
                  ("non-causal, hd 80", 1, 333, 2, 2, 80, None, False),
                  ("ragged S, hd 96", 1, 200, 2, 3, 96, None, True),
                  ("window 70, hd 96", 1, 300, 1, 2, 96, 70, True),
                  ("non-causal, hd 96", 1, 150, 2, 2, 96, 50, False),
                  ("ragged S, hd 112", 1, 200, 2, 3, 112, None, True),
                  ("window 70, hd 112", 1, 300, 1, 2, 112, 70, True),
                  ("non-causal, hd 112", 1, 150, 2, 2, 112, 50, False),
                  ("GQA 8, hd 112", 1, 384, 2, 8, 112, 256, True)]
# the row check's (rel, row, floor) by type (`_rows_held`, against an fp64
# yardstick): the floor is what the fp32 sums leave of a gradient that is
# exactly zero (window 1: dS = P (dP - D) = 0), far below the rows of any
# band; inputs are randn
SWA_ROW_TOL = {"bfloat16": (1e-2, 3e-2, 1e-4), "float32": (1e-4, 1e-3, 2e-5)}
# GPU sleep (cycles, ~10 ms) that outlasts the host's enqueue of one timing
# trial, so kernel times exclude the Python wrapper's per-call cost
HOLD_CYCLES = 20_000_000
MIB4 = 4 << 20
# (label, k, nbytes, want_crc on the main path)
ENCODE_CASES = [
    ("own bucket 4 MiB", 1, MIB4, True),
    ("parity bucket 4 MiB", 3, MIB4, False),
    ("own tail bucket", 1, 3_546_754, True),           # nbytes % 4 == 2
    ("tail bucket, nbytes % 4 == 3", 1, 3_546_755, True),
    ("single-digest bucket", 1, 262_141, True),        # 65,536 lanes
]


def phase(name):
    print(f"== {name}", flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _path_config(arch, layers):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def _state_bytes(arch, layers=None):
    """Train-state bytes: params in bf16 (Mamba2's A_log, dt_bias, D_skip
    in fp32) plus two fp32 moments; step, opt step, 2-word rng. The
    params are the config's count and, for embedding inputs (frames,
    patches), `proj_in` (D, D), which `param_count` leaves out."""
    cfg = _path_config(arch, layers)
    n_par = cfg.param_count() + (
        cfg.d_model ** 2 if not cfg.embed_inputs or cfg.num_patches else 0)
    f32 = 3 * cfg.ssm_heads * cfg.num_layers if cfg.family == "ssm" else 0
    return (n_par - f32) * 2 + f32 * 4 + n_par * 8 + 4 + 4 + 8


def device_facts(torch):
    from repro_torch.core import raim5
    from repro_torch.core.smp import NodeLayout
    smi = smi_line()
    print(f"nvidia-smi: {smi}")
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    # at the depth each path runs; the larger state counts
    sizes = {arch: _state_bytes(arch, layers)
             for arch, _, _, layers, _ in PATHS}
    state_bytes = max(sizes.values())
    print("state bytes: " + json.dumps(sizes))
    n = SG
    need = n * 3 * NodeLayout(n, state_bytes).buf_bytes + n * 8 * MIB4
    free = shutil.disk_usage("/dev/shm").free
    print(f"/dev/shm: free {free} B, need {need} B "
          f"(state {state_bytes} B, {n} SMPs x 3 buffers + rings)")
    if free < need:
        raise SystemExit(f"/dev/shm too small: free {free} B < need {need} B")
    # the durable runs (phase 5) write opt-125m's state to the temp dir:
    # objstore keeps KEEP REFT families (each n x n blocks: own + parity)
    # and writes one more, both as .reft files and as store objects; a
    # disk run writes one whole-state file a snapshot (6 in 12 steps) and
    # GCs only when the session closes, one more in flight
    opt = _state_bytes(DURABLE_ARCH)
    family = n * n * raim5.block_size(opt, n)
    need_tmp = max((KEEP + 1) * 2 * family, 7 * opt)
    tmp = tempfile.gettempdir()
    free_tmp = shutil.disk_usage(tmp).free
    print(f"{tmp}: free {free_tmp} B, need {need_tmp} B (REFT family "
          f"{family} B x {KEEP + 1} x 2 tiers; disk checkpoint {opt} B x 7)")
    if free_tmp < need_tmp:
        raise SystemExit(f"{tmp} too small: free {free_tmp} B < need "
                         f"{need_tmp} B")
    return smi, state_bytes


def build_kernels():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    dt = time.perf_counter() - t0
    for name, path in libs.items():
        print(f"built {name}: {os.path.relpath(path, HERE)}")
    print(f"kernel build: {dt:.3f} s ({len(libs)} sources, parallel nvcc)")
    # the tensor-core kernels of swa_flash's bf16 route: registers and
    # spills of each, as ptxas reported them
    for line in build.resource_report("swa_flash_bf16"):
        print(f"swa_flash_bf16 ptxas: {line}")
    # and of the SSD scan's chunked kernels, and of encode_bucket's
    for name in ("ssd_scan", "encode_bucket"):
        for line in build.resource_report(name):
            print(f"{name} ptxas: {line}")


def _cuda_ms(torch, fn, reps=20, trials=7, hold_cycles=0):
    """Median over trials of CUDA-event time per call (reps per trial).
    With `hold_cycles`, a GPU sleep holds the stream while the host
    enqueues the calls, so the events bracket back-to-back kernels (device
    time); without it they also take in the host's enqueue time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _host_ms(torch, fn, trials=3):
    times = []
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _host_u32(t):
    """A uint32 (or int32) tensor's values as host numpy uint32."""
    import torch
    return t.view(torch.int32).cpu().numpy().view("uint32")


def _encode_case(torch, stage, label, launch, plain, nbytes, want_crc,
                 also=()):
    """Run one encode case: the kernel's (lanes, digests) against the
    plain version's, bit for bit, and (when it CRCs) the folded digests
    against zlib over the plain lanes. `also`: further launches that must
    give the same lanes and digests. -> (max_abs_err, failure or None)."""
    import numpy as np
    out, crc = launch()
    pout, pcrc = plain()
    got = [(out, crc)] + [f() for f in also]
    torch.cuda.synchronize()
    want = _host_u32(pout), _host_u32(pcrc)
    err = 0
    for o, c in got:
        lanes, digests = _host_u32(o), _host_u32(c)
        if lanes.shape != want[0].shape or digests.shape != want[1].shape:
            return None, f"{label}: shapes {lanes.shape} {digests.shape}"
        err = max(err, int(np.max(np.abs(lanes.astype(np.int64)
                                          - want[0].astype(np.int64)))),
                  int(np.max(np.abs(digests.astype(np.int64)
                                    - want[1].astype(np.int64)))))
    if err:
        return err, f"{label}: max_abs_err={err}"
    if want_crc:
        z = zlib.crc32(want[0].view(np.uint8)[:nbytes].tobytes())
        folded = stage.bucket_crc(_host_u32(crc), nbytes)
        if folded != z:
            return err, f"{label}: crc {folded:#x} != zlib {z:#x}"
    return err, None


def fused_setup(torch):
    """The fused gather's inputs: opt-125m's train state at full width on
    the card (its real FlatSpec), each leaf in an allocation of its own
    as on the path but between 64 random bytes on either side (a kernel
    that reads past a slice shows), its bytes seeded random too; the path's
    bucket schedules for the SG's members (REFT's default bucket size,
    parity fused). -> (encoder, [(label, sources, nbytes, want_crc)]):
    an own bucket that starts 2 bytes into its leaf, the own bucket
    spanning the most leaves, a kind-2 parity bucket (without its CRC as
    on the path, and with it as on the delta path) and the tail bucket
    (the stream's last own bucket, zero pad past total_bytes)."""
    from repro_torch.core import raim5
    from repro_torch.core.pipeline import DeviceEncoder, build_schedule
    from repro_torch.core.smp import NodeLayout
    from repro_torch.core.snapshot import ReftConfig
    from repro_torch.core.treebytes import (leaf_arrays, make_flat_spec,
                                            tensor_u8)
    from repro_torch.train.steps import init_train_state
    state = init_train_state(_path_config(DURABLE_ARCH, None), 0,
                             device="cuda")
    spec = make_flat_spec(state)
    gen = torch.Generator(device="cuda").manual_seed(1)
    leaves = []
    for x in leaf_arrays(state):
        n = tensor_u8(x).numel()
        buf = torch.randint(0, 256, (n + 128,), generator=gen,
                            dtype=torch.uint8, device="cuda")
        leaves.append(buf[64:64 + n].view(x.dtype).reshape(x.shape))
    del state
    enc = DeviceEncoder(spec, leaves)
    lay = NodeLayout(SG, spec.total_bytes)
    tasks = []
    for node in range(SG):
        own = [(i * lay.bs, *ref.byte_range(lay.bs, SG)) for i, ref in
               enumerate(raim5.data_blocks_of_node(node, SG))]
        stripe = [ref.byte_range(lay.bs, SG)
                  for ref in raim5.parity_stripe_of_node(node, SG)]
        tasks += build_schedule(spec, own, stripe, ReftConfig().bucket_bytes,
                                fuse_parity=True)
    own = [t for t in tasks if t.kind == 0]
    parity = [t for t in tasks if t.kind == 2]

    def n_slices(t):
        return sum(len(enc.ranges(a, b))
                   for a, b in (t.sources or ((t.lo, t.hi),)))

    def off(t):
        i = bisect.bisect_right(enc.offsets, t.lo) - 1
        return (t.lo - spec.leaves[i].offset) % 4

    two_off = next(t for t in own if off(t) == 2)
    widest = max(own, key=n_slices)
    kind2 = max(parity, key=n_slices)
    tail = max(own, key=lambda t: t.hi)
    cases = [(f"own bucket 2 bytes off ({n_slices(two_off)} slices)",
              ((two_off.lo, two_off.hi),), False),
             (f"own bucket, most leaves ({n_slices(widest)} slices)",
              ((widest.lo, widest.hi),), False),
             (f"kind-2 parity bucket ({n_slices(kind2)} slices)",
              kind2.sources, False),
             ("kind-2 parity bucket, CRC (delta path)", kind2.sources, True),
             (f"tail bucket ({tail.hi - tail.lo} B, "
              f"{max(0, tail.hi - spec.total_bytes)} B past the state)",
              ((tail.lo, tail.hi),), False)]
    out = []
    for label, srcs, delta in cases:
        nb = srcs[0][1] - srcs[0][0]
        out.append((label, srcs, nb, len(srcs) == 1 or delta))
    return enc, out


def check_encode_bucket(torch, fused, strict=True, timed=True):
    """encode_bucket against encode_bucket_plain on the card at
    ENCODE_CASES, and the fused entry (encode_ranges) against its plain
    version and the unfused route at `fused_setup`'s buckets; each
    timed (device time) beside its byte bound, the fused ones also as
    gather_bytes + encode_bucket, the route they replace. -> (rows,
    fused rows, max_abs_err); with strict=False, the failures are
    listed in the rows instead of raised."""
    from repro_torch.kernels import stage
    rows, frows, max_err = [], [], 0

    def record(label, err, failure, table):
        nonlocal max_err
        if failure and strict:
            raise AssertionError(f"encode_bucket {failure}")
        max_err = max(max_err, err or 0)
        table.append({"case": label, "ok": failure is None,
                      "failure": failure})
        return failure is None

    for i, (label, k, nbytes, main_crc) in enumerate(ENCODE_CASES):
        n = -(-nbytes // stage.LANE_BYTES) * (stage.LANE_BYTES // 4)
        gen = torch.Generator(device="cuda").manual_seed(i)
        raw = torch.randint(0, 256, (k, 4 * n), generator=gen,
                            dtype=torch.uint8, device="cuda")
        raw[:, nbytes:] = 0
        blocks = raw.view(torch.uint32)
        err, failure = _encode_case(
            torch, stage, label,
            lambda: stage.encode_bucket(blocks, nbytes=nbytes),
            lambda: stage.encode_bucket_plain(blocks, nbytes=nbytes),
            nbytes, True)
        if not failure and not main_crc:   # the path's parity call: no CRC
            out2, crc2 = stage.encode_bucket(blocks, nbytes=nbytes,
                                             want_crc=False)
            torch.cuda.synchronize()
            if not torch.equal(out2, stage.encode_bucket_plain(
                    blocks, nbytes=nbytes)[0]) \
                    or crc2.view(torch.int32).any():
                failure = f"{label}: want_crc=False disagrees"
        if not record(label, err, failure, rows) or not timed:
            continue
        launch = lambda: stage.encode_bucket(             # noqa: E731
            blocks, nbytes=nbytes, want_crc=main_crc)
        ms = _cuda_ms(torch, launch, hold_cycles=HOLD_CYCLES)
        call_ms = _cuda_ms(torch, launch)
        plain_ms = _host_ms(torch, lambda: stage.encode_bucket_plain(
            blocks, nbytes=nbytes, want_crc=main_crc))
        moved = (k + 1) * 4 * n
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        tl = stage.resolve_tile_lanes(n) or n
        rows[-1].update({"k": k, "n_lanes": n, "nbytes": nbytes,
                         "tiles": -(-n // tl),
                         "blocks": -(-n // tl) * stage.ENC_CLUSTER,
                         "want_crc": main_crc, "ms": ms, "call_ms": call_ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bytes": moved})
        r = rows[-1]
        print(f"encode_bucket {label}: k={k} lanes={n} tiles={r['tiles']} "
              f"blocks={r['blocks']} crc={main_crc} ms={ms:.5f} "
              f"call_ms={call_ms:.5f} plain_ms={plain_ms:.3f} "
              f"bound_ms={bound_ms:.5f} ({ms / bound_ms:.1f}x bound) "
              f"bit-exact")

    # on the card a tile is one cluster's: a wider one is refused
    wide = torch.zeros((1, 2 * stage.MAX_CELL_LANES), dtype=torch.uint32,
                       device="cuda")
    try:
        stage.encode_bucket(wide, nbytes=4, tile_lanes=wide.shape[1])
        failure = "a tile wider than MAX_CELL_LANES was not refused"
    except ValueError:
        failure = None
    record("wide tile refused", 0, failure, rows)

    enc, cases = fused
    for label, srcs, nbytes, want_crc in cases:
        ranges = [enc.ranges(a, b) for a, b in srcs]

        def gathered(srcs=srcs):
            g = [enc.gather_bytes(a, b) for a, b in srcs]
            return (g[0][None] if len(g) == 1
                    else torch.stack(g)).view(torch.uint32)

        def unfused(srcs=srcs, nbytes=nbytes, want_crc=want_crc):
            return stage.encode_bucket(gathered(srcs), nbytes=nbytes,
                                       want_crc=want_crc)

        def fused_call(ranges=ranges, nbytes=nbytes, want_crc=want_crc):
            return stage.encode_ranges(ranges, nbytes=nbytes,
                                       want_crc=want_crc)

        err, failure = _encode_case(
            torch, stage, "fused " + label, fused_call,
            lambda: stage.encode_ranges_plain(ranges, nbytes=nbytes,
                                              want_crc=want_crc),
            nbytes, want_crc, also=(unfused,))
        if not record(label, err, failure, frows) or not timed:
            continue
        k = len(srcs)
        n = -(-nbytes // stage.LANE_BYTES) * (stage.LANE_BYTES // 4)
        moved = sum(min(b, enc.spec.total_bytes) - a
                    for a, b in srcs) + 4 * n
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        ms = _cuda_ms(torch, fused_call, hold_cycles=HOLD_CYCLES)
        unfused_ms = _cuda_ms(torch, unfused, hold_cycles=HOLD_CYCLES)
        call_ms = _cuda_ms(torch, fused_call)
        plain_ms = _host_ms(torch, lambda: stage.encode_ranges_plain(
            ranges, nbytes=nbytes, want_crc=want_crc))
        frows[-1].update({"k": k, "nbytes": nbytes, "n_lanes": n,
                          "slices": sum(len(r) for r in ranges),
                          "want_crc": want_crc, "ms": ms,
                          "gather_plus_kernel_ms": unfused_ms,
                          "call_ms": call_ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bytes": moved})
        print(f"encode_ranges {label}: k={k} nbytes={nbytes} slices="
              f"{frows[-1]['slices']} crc={want_crc} ms={ms:.5f} "
              f"gather+kernel ms={unfused_ms:.5f} call_ms={call_ms:.5f} "
              f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.5f} "
              f"({ms / bound_ms:.1f}x bound) bit-exact")
    return rows, frows, max_err


def _ssd_shape():
    """B, S, H, P, N, chunk of mamba2-130m's SSD core on its path."""
    seq, batch = {arch: (s, b) for arch, s, b, _, _ in PATHS}["mamba2-130m"]
    return (batch, seq, *_ssd_heads("mamba2-130m"))


def _ssd_heads(arch):
    """H, P, N, chunk of `arch`'s SSD core at full width."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssd_chunk


def _ssd_train_shape():
    """B, S, H, P, N, chunk of the hybrid train check's SSD calls."""
    arch, seq, batch, _ = HYBRID_TRAIN
    return (batch, seq, *_ssd_heads(arch))


def _ssd_inputs(torch, gen, shape, with_h0):
    """SSD inputs as ssm_block makes them, with Mamba2's initial ranges
    (A in [-16, -1], dt in [1e-3, 1e-1]; arXiv:2405.21060): a = dt A and
    u = x dt, dt log-uniform per head times lognormal noise per step; x,
    B, C, h0 and the cotangents standard normal."""
    B, S, H, P, N, _ = shape
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa
    un = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(  # noqa: E731
        *s, generator=gen, device="cuda")
    A = -un(1.0, 16.0, H)
    dt = torch.exp(un(math.log(1e-3), math.log(1e-1), H) + 0.5 * rn(B, S, H))
    return {"u": (rn(B, S, H, P) * dt[..., None]).contiguous(),
            "a": (dt * A).contiguous(), "Bm": rn(B, S, N), "Cm": rn(B, S, N),
            "h0": rn(B, H, P, N) if with_h0 else None,
            "dy": rn(B, S, H, P), "dhf": rn(B, H, P, N)}


def ssd_bytes(B, S, H, P, N, Q):
    """(forward, backward) bytes of the main path's call (no h0, no
    dh_final): each input read once, each output written once, fp32; hs is
    an output of the forward, an input of the backward."""
    nc = S // Q
    x, ah, bn, st, hs = (B * S * H * P, B * S * H, B * S * N, B * H * P * N,
                         B * H * nc * P * N)
    return 4 * (2 * x + ah + 2 * bn + st + hs), \
        4 * (3 * x + 2 * ah + 4 * bn + hs + st)


# the SSD contract's edge shapes: (label, B, S, H, P, N, chunk)
SSD_EDGE_CASES = [("S 2000, Q 250", 1, 2000, 4, 64, 128, 256),
                  ("ragged P, N; Q 12", 1, 60, 2, 24, 40, 12),
                  ("N 16", 1, 512, 4, 64, 16, 256),
                  ("N 256", 1, 512, 4, 64, 256, 256),
                  ("S 257 prime, Q 1", 1, 257, 2, 64, 128, 256)]


def _ssd_held(torch, K, label, x, Q, strict=True):
    """The kernels against the plain scan and its autograd in fp32 and in
    fp64: y and h_final allclose(atol 5e-4, rtol 1e-3)
    (tests/test_kernels.py's), each gradient max |diff| <= 1e-3 max |ref|,
    da finite. Each check's ratio to its bound (<= 1 holds; NaN counts as
    inf). -> (worst forward |diff|, worst gradient |diff|) against fp32,
    and the worst ratio; raises on a ratio above 1 when `strict`."""
    names = ["u", "a", "Bm", "Cm"] + (["h0"] if x["h0"] is not None else [])
    y, hf, hs = K.ssd_scan_fwd(x["u"], x["a"], x["Bm"], x["Cm"], x["h0"],
                               chunk=Q)
    grads = K.ssd_scan_bwd(x["dy"], x["dhf"], x["u"], x["a"], x["Bm"],
                           x["Cm"], hs, chunk=Q)
    torch.cuda.synchronize()
    fin = lambda r: r if math.isfinite(r) else math.inf  # noqa: E731
    err, worst = {"fwd": 0.0, "bwd": 0.0}, 0.0
    failed = []
    if not torch.isfinite(grads[1]).all():
        worst = math.inf
        failed.append("da is not finite")
    for dt in (torch.float32, torch.float64):
        tag = "fp32" if dt == torch.float32 else "fp64"
        leaves = [x[k].to(dt).requires_grad_(True) for k in names]
        h0 = leaves[4] if len(leaves) == 5 else None
        yp, hfp = K.ssd_scan_plain(*leaves[:4], h0, chunk=Q)
        gp = torch.autograd.grad((yp, hfp), leaves,
                                 (x["dy"].to(dt), x["dhf"].to(dt)))
        for got, want, what in ((y, yp.detach(), "y"),
                                (hf, hfp.detach(), "h_final")):
            got = got.to(dt)
            d = fin((got - want).abs().max().item())
            ratio = fin(((got - want).abs()
                         / (5e-4 + 1e-3 * want.abs())).max().item())
            if strict:
                print(f"ssd_scan {label} {what} vs {tag} plain: max|diff| "
                      f"{d:.3e} (max|ref| {want.abs().max().item():.3e}); "
                      f"allclose (atol 5e-4, rtol 1e-3) ratio {ratio:.3e}")
            if not ratio <= 1:
                failed.append(f"{what} vs the {tag} plain scan")
            worst = max(worst, ratio)
            if tag == "fp32":
                err["fwd"] = max(err["fwd"], d)
        for name, got, want in zip(names, grads, gp):
            d = fin((got.to(dt) - want).abs().max().item())
            top = want.abs().max().item()
            ratio = d / (1e-3 * top)
            if strict:
                print(f"ssd_scan_bwd {label} d{name} vs {tag} plain: "
                      f"max|diff| {d:.3e} (max|ref| {top:.3e}, ratio to "
                      f"1e-3 max|ref| {ratio:.3e})")
            if not ratio <= 1:
                failed.append(f"d{name} vs the {tag} plain scan")
            worst = max(worst, ratio)
            if tag == "fp32":
                err["bwd"] = max(err["bwd"], d)
        del leaves, yp, hfp, gp
    if strict and failed:
        raise AssertionError(f"ssd_scan {label}: " + "; ".join(failed))
    return err, worst


def _ssd_serving_cases():
    """(label, B, S, arch) of the serving path's calls of the SSD forward:
    the prefill of each served model with SSM layers (mamba2-130m,
    jamba-v0.1-52b; their prefill_32k rows) and its decode check's
    prefill (its decode batch, SERVE_T tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import INPUT_SHAPES
    out = []
    for arch, rows, _, decode_b, *_ in SERVE_RUNS:
        if get_config(arch).family in ("ssm", "hybrid"):
            out += [(f"{arch} prefill", rows,
                     INPUT_SHAPES["prefill_32k"].seq_len, arch),
                    (f"{arch} decode-check prefill", decode_b, SERVE_T,
                     arch)]
    return out


def _ssd_forward_case(torch, K, gen, label, B, S, arch):
    """A serving-path call of the SSD forward kernels (h0 None, as
    `ssm_block`'s prefill makes it) at the path's whole batch, `arch`'s
    heads: each row of y and h_final against the plain chunked scan on
    that row alone, in fp32 and in fp64, at `_ssd_held`'s forward
    tolerance (allclose atol 5e-4, rtol 1e-3); then the call timed
    beside its bound. -> its row."""
    H, P, N, chunk = _ssd_heads(arch)
    Q = K.chunk_len(S, chunk)
    x = _ssd_inputs(torch, gen, (B, S, H, P, N, Q), False)
    u, a, Bm, Cm = (x[k] for k in ("u", "a", "Bm", "Cm"))
    del x
    y, hf, _ = K.ssd_scan_fwd(u, a, Bm, Cm, chunk=Q)
    torch.cuda.synchronize()
    worst = {"fp32": (0.0, 0), "fp64": (0.0, 0)}
    err = 0.0
    for b in range(B):
        for dt, tag in ((torch.float32, "fp32"), (torch.float64, "fp64")):
            yp, hfp = K.ssd_scan_plain(*(t[b:b + 1].to(dt)
                                         for t in (u, a, Bm, Cm)), chunk=Q)
            for got, want in ((y[b:b + 1], yp), (hf[b:b + 1], hfp)):
                d = (got.to(dt) - want).abs()
                ratio = (d / (5e-4 + 1e-3 * want.abs())).max().item()
                if not ratio <= 1:
                    raise AssertionError(
                        f"ssd_scan {label}: row {b} of {B} disagrees with "
                        f"the {tag} plain scan (allclose ratio {ratio:.3e})")
                worst[tag] = max(worst[tag], (ratio, b))
                if tag == "fp32":
                    err = max(err, d.max().item())
            del yp, hfp
    print(f"ssd_scan {label} ({B}x{S}, Q {Q}): y and h_final, each of {B} "
          f"rows against the plain scan on the row: max|diff| vs fp32 "
          f"{err:.3e}; worst allclose (atol 5e-4, rtol 1e-3) ratio "
          + ", ".join(f"{t} {r:.3e} (row {b})"
                      for t, (r, b) in worst.items()))
    del y, hf
    torch.cuda.empty_cache()
    ms = _cuda_ms(torch, lambda: K.ssd_scan_fwd(u, a, Bm, Cm, chunk=Q),
                  reps=3, trials=5, hold_cycles=HOLD_CYCLES)
    plain_row_ms = _host_ms(torch, lambda: K.ssd_scan_plain(
        u[:1], a[:1], Bm[:1], Cm[:1], chunk=Q))
    flops = K.ssd_flops(B, S, H, P, N, Q)[0]
    ops_ms = 3 * flops / BF16_FLOPS * 1e3
    bytes_ms = ssd_bytes(B, S, H, P, N, Q)[0] / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"ssd_scan {label}: ms={ms:.4f} bound_ms={bound_ms:.5f} "
          f"({'operations' if ops_ms >= bytes_ms else 'bytes'}; "
          f"{ms / bound_ms:.1f}x bound); plain, one row: "
          f"{plain_row_ms:.3f} ms")
    del u, a, Bm, Cm
    torch.cuda.empty_cache()
    return {"label": label, "shape": [B, S, H, P, N, Q], "ms": ms,
            "bound_ms": bound_ms, "bound_by": "operations"
            if ops_ms >= bytes_ms else "bytes",
            "plain_ms_one_row": plain_row_ms, "max_abs_err": err,
            "worst_ratio": {t: r for t, (r, _) in worst.items()}}


def _ssd_bound(shape):
    """{name: (bound ms, bound_by, GFLOP, bytes)} of the forward's and the
    backward's calls at `shape` (no h0, no dh_final): the products as
    bf16x3 at the tensor-core peak, or the bytes at the HBM rate."""
    K = importlib.import_module("repro_torch.kernels.ssd_scan")
    out = {}
    for name, flops, nbytes in zip(("ssd_scan", "ssd_scan_bwd"),
                                   K.ssd_flops(*shape), ssd_bytes(*shape)):
        ops_ms = 3 * flops / BF16_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (max(ops_ms, bytes_ms), "operations"
                     if ops_ms >= bytes_ms else "bytes", flops / 1e9, nbytes)
    return out


def _ssd_times(torch, K, x, Q):
    """The forward and the backward at a training call (h0 None as
    `ssm_block` makes it, h_final unused: dh_final None, the states saved
    for the backward): ({name: kernel ms}, {name: plain ms})."""
    u, a, Bm, Cm, dy = (x[k] for k in ("u", "a", "Bm", "Cm", "dy"))
    _, _, hs = K.ssd_scan_fwd(u, a, Bm, Cm, chunk=Q)
    ms = {"ssd_scan": _cuda_ms(torch, lambda: K.ssd_scan_fwd(
              u, a, Bm, Cm, chunk=Q), hold_cycles=HOLD_CYCLES),
          "ssd_scan_bwd": _cuda_ms(torch, lambda: K.ssd_scan_bwd(
              dy, None, u, a, Bm, Cm, hs, chunk=Q), hold_cycles=HOLD_CYCLES)}
    leaves = [t.clone().requires_grad_(True) for t in (u, a, Bm, Cm)]
    plain = {"ssd_scan": _host_ms(torch, lambda: K.ssd_scan_plain(
        *(t.detach() for t in leaves), chunk=Q))}
    yp, _ = K.ssd_scan_plain(*leaves, chunk=Q)
    plain["ssd_scan_bwd"] = _host_ms(torch, lambda: torch.autograd.grad(
        yp, leaves, dy, retain_graph=True))
    return ms, plain


def _ssd_shape_case(torch, K, gen, label, shape):
    """One training call's shape: the kernels held against the plain scan
    and its autograd (`_ssd_held`, h0 None), then timed (`_ssd_times`)
    beside their bounds. -> {name: its row}."""
    x = _ssd_inputs(torch, gen, shape, False)
    err, _ = _ssd_held(torch, K, label, x, shape[5])
    ms, plain = _ssd_times(torch, K, x, shape[5])
    del x
    torch.cuda.empty_cache()
    rows = {}
    for name, (bound_ms, by, gflop, nbytes) in _ssd_bound(shape).items():
        rows[name] = {"label": label, "shape": list(shape), "ms": ms[name],
                      "plain_ms": plain[name], "bound_ms": bound_ms,
                      "bound_by": by, "library_ms": None,
                      "max_abs_err": err["fwd" if name == "ssd_scan"
                                         else "bwd"]}
        print(f"{name} {label} ({'x'.join(map(str, shape))}): "
              f"ms={ms[name]:.4f} plain_ms={plain[name]:.3f} "
              f"bound_ms={bound_ms:.5f} ({by}: 3 x {gflop:.3f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB; {ms[name] / bound_ms:.1f}x bound)")
    return rows


def check_ssd(torch):
    """The SSD forward and backward kernels against the plain chunked scan
    and its autograd, fp32 and fp64 (`_ssd_held`), at mamba2-130m's shapes
    (h0 zero and random) and at SSD_EDGE_CASES; two launches bit-equal;
    the forward at the serving path's calls, row by row
    (`_ssd_forward_case`); the hybrid train check's shape held and timed
    (`_ssd_shape_case`); then the main path's call timed beside its
    bound."""
    K = importlib.import_module("repro_torch.kernels.ssd_scan")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    main = _ssd_shape()
    B, S, H, P, N, Q = main
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"fwd": 0.0, "bwd": 0.0}
    for case in ("h0 zero", "h0 random"):
        x = _ssd_inputs(torch, gen, main, case == "h0 random")
        e, _ = _ssd_held(torch, K, f"main {case}", x, Q)
        err = {k: max(err[k], e[k]) for k in err}
    # the same inputs, launched again: bit-equal (no atomics, fixed order)
    outs = [K.ssd_scan_fwd(x["u"], x["a"], x["Bm"], x["Cm"], x["h0"],
                           chunk=Q) for _ in range(2)]
    grads = [K.ssd_scan_bwd(x["dy"], x["dhf"], x["u"], x["a"], x["Bm"],
                            x["Cm"], o[2], chunk=Q) for o in outs]
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip((*outs[0], *grads[0]),
                                                  (*outs[1], *grads[1]))):
        raise AssertionError("ssd_scan: two launches on the same inputs "
                             "differ")
    print("ssd_scan: two launches of each kernel bit-equal (y, h_final, hs, "
          "du, da, dBm, dCm, dh0)")
    del outs, grads, x
    for label, *shape in SSD_EDGE_CASES:
        x = _ssd_inputs(torch, gen, shape, True)
        _ssd_held(torch, K, label, x, K.chunk_len(shape[1], shape[5]))
    del x
    torch.cuda.empty_cache()
    serving = [_ssd_forward_case(torch, K, gen, *case)
               for case in _ssd_serving_cases()]
    # the hybrid train check's calls (Jamba: H 128, N 16), both kernels
    train = _ssd_shape_case(torch, K, gen, f"{HYBRID_TRAIN[0]} train",
                            _ssd_train_shape())

    # timing at the main path's call
    ms, plain = _ssd_times(torch, K, _ssd_inputs(torch, gen, main, False), Q)
    elems = B * S * H * P * N
    rows = {}
    for (name, (bound_ms, by, gflop, nbytes)), old_flops in zip(
            _ssd_bound(main).items(), (4 * elems, 11 * elems)):
        # the serial kernels' bound: the recurrence's fp32 FMAs
        old_bound_ms = max(old_flops / FP32_FLOPS * 1e3,
                           nbytes / HBM_BYTES_PER_S * 1e3)
        rows[name] = {"ms": ms[name], "plain_ms": plain[name],
                      "bound_ms": bound_ms, "bound_by": by,
                      "bound_route": "bf16x3 at 989.4 TFLOP/s",
                      "old_bound_ms": old_bound_ms,
                      "max_abs_err": err["fwd" if name == "ssd_scan"
                                         else "bwd"],
                      "train_cases": [train[name]]}
        if name == "ssd_scan":
            rows[name]["serving_cases"] = serving
        print(f"{name}: ms={ms[name]:.4f} plain_ms={plain[name]:.3f} "
              f"bound_ms={bound_ms:.5f} ({by}; bf16x3: 3 x {gflop:.3f} "
              f"GFLOP at 989.4 TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 TB/s;"
              f" {ms[name] / bound_ms:.1f}x bound); old fp32 bound "
              f"{old_bound_ms:.5f} ms ({old_flops / 1e9:.2f} GFLOP at 67 "
              f"TFLOP/s)")
    return rows


def _swa_inputs(torch, gen, B, S, KV, G, hd):
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa
    return {"q": rn(B, S, KV, G, hd), "k": rn(B, S, KV, hd),
            "v": rn(B, S, KV, hd), "do": rn(B, S, KV, G, hd)}


def _swa_plain(torch, K, x, dtype, window, causal):
    """The plain version and its autograd on x cast to dtype."""
    leaves = [x[n].detach().to(dtype).requires_grad_(True) for n in "qkv"]
    o = K.swa_flash_plain(*leaves, window=window, causal=causal)
    return o.detach(), torch.autograd.grad(o, leaves, x["do"].to(dtype))


def _swa_fp64(torch, x, window, causal):
    """The yardstick of the fp32 runs: the masked softmax and its autograd
    in fp64, one (batch, query head) at a time (the plain version computes
    in fp32 whatever its inputs' type)."""
    B, S, KV, G, hd = x["q"].shape
    pos = torch.arange(S, device="cuda")
    d = pos[:, None] - pos[None, :]
    ok = (d < (window or S)) & (-d < (window or S))
    if causal:
        ok &= d >= 0
    o = torch.empty(x["q"].shape, dtype=torch.float64, device="cuda")
    dq, dk, dv = (torch.zeros(x[n].shape, dtype=torch.float64,
                              device="cuda") for n in "qkv")
    for b in range(B):
        for h in range(KV):
            for g in range(G):
                qh = x["q"][b, :, h, g].double().requires_grad_(True)
                kh, vh = (x[n][b, :, h].double().requires_grad_(True)
                          for n in "kv")
                s = (qh @ kh.T) * hd ** -0.5
                oh = torch.softmax(s.masked_fill(~ok, -math.inf), -1) @ vh
                gq, gk, gv = torch.autograd.grad(
                    oh, (qh, kh, vh), x["do"][b, :, h, g].double())
                o[b, :, h, g] = oh.detach()
                dq[b, :, h, g] = gq
                dk[b, :, h] += gk
                dv[b, :, h] += gv
                del s, oh
    return o, (dq, dk, dv)


def _swa_fp64_given_o(torch, x, o_out, window, causal):
    """The yardstick of the bf16 rows: on x (the bf16 inputs' values), the
    masked softmax in fp64, and its gradient in fp64 with D = rowsum(dO o
    O) taken from `o_out`, the kernel's rounded output, as the bf16
    route's pre-pass takes it. Where a row's softmax is peaked (the first
    rows of a causal band), dP - D cancels, and D from a bf16 O moves dS
    by up to tens of percent (flash attention's backward does the same);
    with D from the same O, the yardstick leaves the kernel only its
    roundings: P and dS to bf16, and the outputs. One (batch, query head)
    at a time."""
    B, S, KV, G, hd = x["q"].shape
    pos = torch.arange(S, device="cuda")
    d = pos[:, None] - pos[None, :]
    ok = (d < (window or S)) & (-d < (window or S))
    if causal:
        ok &= d >= 0
    o = torch.empty(x["q"].shape, dtype=torch.float64, device="cuda")
    dq, dk, dv = (torch.zeros(x[n].shape, dtype=torch.float64,
                              device="cuda") for n in "qkv")
    scale = hd ** -0.5
    for b in range(B):
        for h in range(KV):
            kh, vh = (x[n][b, :, h].double() for n in "kv")
            for g in range(G):
                qh, doh = (x[n][b, :, h, g].double() for n in ("q", "do"))
                p = torch.softmax(((qh @ kh.T) * scale)
                                  .masked_fill(~ok, -math.inf), -1)
                o[b, :, h, g] = p @ vh
                dd = (doh * o_out[b, :, h, g].double()).sum(-1)
                ds = p * ((doh @ vh.T) - dd[:, None])
                dq[b, :, h, g] = (ds @ kh) * scale
                dk[b, :, h] += (ds.T @ qh) * scale
                dv[b, :, h] += p.T @ doh
                del p, ds
    return o, (dq, dk, dv)


def _dq_first_rows(torch, x, o_out, rows, window, causal):
    """fp64 dq of the first `rows` query rows (one (batch, query head) at a
    time), with D = rowsum(dO o O) from `o_out` (the kernel's rounded O),
    or from the fp64 O itself (the exact D) when `o_out` is None."""
    B, S, KV, G, hd = x["q"].shape
    pos = torch.arange(S, device="cuda")
    d = pos[:rows, None] - pos[None, :]
    ok = (d < (window or S)) & (-d < (window or S))
    if causal:
        ok &= d >= 0
    dq = torch.empty((B, rows, KV, G, hd), dtype=torch.float64,
                     device="cuda")
    scale = hd ** -0.5
    for b in range(B):
        for h in range(KV):
            kh, vh = (x[n][b, :, h].double() for n in "kv")
            for g in range(G):
                qh, doh = (x[n][b, :rows, h, g].double() for n in ("q", "do"))
                p = torch.softmax(((qh @ kh.T) * scale)
                                  .masked_fill(~ok, -math.inf), -1)
                o = p @ vh if o_out is None \
                    else o_out[b, :rows, h, g].double()
                dd = (doh * o).sum(-1)
                dq[b, :, h, g] = ((p * ((doh @ vh.T) - dd[:, None])) @ kh) \
                    * scale
    return dq


def _dq_exact_d_gap(torch, tag, xs, o, dq, window, causal, rows=64):
    """ROADMAP's open check, shown with no bound: in the first `rows` rows
    of a causal band (few keys, a peaked softmax, dP - D cancelling), how
    far the bf16 dq, which takes D from the rounded O, sits from the fp64
    gradient with the exact D, beside its distance from the fp64 gradient
    with D from the kernel's O (the yardstick the row check holds). Per
    row: max |diff| over hd / (rms of the yardstick's row + the bf16 row
    floor of SWA_ROW_TOL: row 0 of a band has one key, and its exact
    gradient is 0)."""
    rows = min(rows, xs["q"].shape[1])
    floor = SWA_ROW_TOL["bfloat16"][2]
    heads = xs["q"].shape[2] * xs["q"].shape[3]
    got = dq[:, :rows].double()
    out = {}
    for name, o_out in (("exact D", None), ("D from the kernel's O", o)):
        want = _dq_first_rows(torch, xs, o_out, rows, window, causal)
        w = want.reshape(-1, want.shape[-1])
        diff = (got.reshape(-1, got.shape[-1]) - w).abs().amax(-1)
        ratio = diff / (w.pow(2).mean(-1).sqrt() + floor)
        worst = int(ratio.argmax().item())
        out[name] = (ratio.median().item(), ratio[worst].item(),
                     worst // heads % rows, diff.max().item())
    print(f"{tag} dq, first {rows} rows of the causal band, max|diff| / "
          f"(rms(row) + {floor:g}) against fp64 (shown, no bound): "
          + "; ".join(f"with the {k}: median {m:.3e}, worst {w:.3e} (row "
                      f"{r}), max|diff| {d:.3e}"
                      for k, (m, w, r, d) in out.items()))


def _sdpa_yardstick(torch, x, window, causal, backward=True):
    """One PyTorch call for the same function, timed and never on the
    path: scaled_dot_product_attention forced to the memory-efficient
    backend, with the band as a boolean mask and K/V repeated to the H
    query heads. -> (backend or None, fwd ms, bwd ms (None without
    `backward`), why)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    B, S, KV, G, hd = x["q"].shape
    pos = torch.arange(S, device="cuda")
    d = pos[:, None] - pos[None, :]
    W = window or S
    mask = (d < W) & (-d < W)
    if causal:
        mask &= d >= 0
    q = x["q"].reshape(B, S, KV * G, hd).transpose(1, 2)
    k, v = (x[n][:, :, :, None].expand(B, S, KV, G, hd)
            .reshape(B, S, KV * G, hd).transpose(1, 2) for n in "kv")
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    do = x["do"].reshape(B, S, KV * G, hd).transpose(1, 2)
    backend = SDPBackend.EFFICIENT_ATTENTION
    try:
        with sdpa_kernel([backend]):
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            fwd = _cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), reps=3, trials=3,
                hold_cycles=HOLD_CYCLES)
            bwd = None if not backward else _cuda_ms(
                torch, lambda: torch.autograd.grad(
                    out, (q, k, v), do, retain_graph=True), reps=3,
                trials=3, hold_cycles=HOLD_CYCLES)
        return backend.name, fwd, bwd, None
    except (RuntimeError, torch.OutOfMemoryError) as e:
        return None, None, None, f"{type(e).__name__}: {e}"[:300]


def _rows_held(torch, got, want, dtype):
    """The row check of a swa_flash output against its fp64 yardstick, at
    SWA_ROW_TOL[dtype] = (rel, row, floor): over the tensor ||diff|| <= rel
    ||ref|| + floor sqrt(n); in each row (a query row of o and dq, a key
    row of dk and dv, over hd) max |diff| <= row rms(ref row) + floor.
    -> (tensor ratio, worst row ratio, that row's index): both <= 1 hold."""
    rel, row, floor = SWA_ROW_TOL[str(dtype)[6:]]
    w = want.reshape(-1, want.shape[-1]).double()
    d = got.reshape(-1, got.shape[-1]).double() - w
    tensor = d.norm().item() / (rel * w.norm().item()
                                + floor * math.sqrt(w.numel()))
    ratio = d.abs().amax(-1) / (row * w.pow(2).mean(-1).sqrt() + floor)
    worst = int(ratio.argmax().item())
    return tensor, ratio[worst].item(), worst


def _swa_check(torch, K, label, x, window, causal, main_case, err):
    """One shape, fp32 then bf16: the kernels on x cast to the type. At
    SWA_CASES (`main_case`), against the plain version and its autograd on
    the same inputs, at today's tolerances (fp32: forward allclose(atol
    2e-5, rtol 1e-4), the sweep tolerance of tests/test_kernels.py,
    backward max |diff| <= 1e-3 max |ref|; bf16: forward allclose(atol
    3e-2, rtol 3e-2), its bf16 case, backward max |diff| <= 3e-2 max
    |ref|). Then row by row (`_rows_held`) against an fp64 yardstick:
    bf16, `_swa_fp64_given_o` on the bf16 values, everywhere; fp32,
    `_swa_fp64`, held at SWA_EDGE_CASES, shown at SWA_CASES. Raises on a
    disagreement; `err` keeps the largest |diff| from the plain version
    at SWA_CASES."""
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        tol = 3e-2 if bf16 else None
        xs = {n: t.detach().to(dtype) for n, t in x.items()}
        o, lse = K.swa_flash_fwd(xs["q"], xs["k"], xs["v"], window=window,
                                 causal=causal)
        grads = K.swa_flash_bwd(xs["do"], xs["q"], xs["k"], xs["v"], o,
                                lse, window=window, causal=causal)
        torch.cuda.synchronize()
        plain = ((None, (None,) * 3) if not main_case else
                 _swa_plain(torch, K, x, dtype, window, causal))
        o64, g64 = (_swa_fp64_given_o(torch, xs, o, window, causal) if bf16
                    else _swa_fp64(torch, x, window, causal))
        tag = f"swa_flash {label} {str(dtype)[6:]}"
        if bf16 and causal:
            _dq_exact_d_gap(torch, tag, xs, o, grads[0], window, causal)
        enforce_rows = bf16 or not main_case
        for name, got, want, w64 in (("o", o, plain[0], o64),
                                     *zip(("dq", "dk", "dv"), grads,
                                          plain[1], g64)):
            line = f"{tag} {name}: "
            if main_case:
                d = (got.float() - want.float()).abs().max().item()
                top = want.float().abs().max().item()
                if name == "o":
                    ok = torch.allclose(got.float(), want.float(),
                                        atol=tol or 2e-5, rtol=tol or 1e-4)
                    line += (f"max|diff| {d:.3e} (max|ref| {top:.3e}); "
                             f"allclose (atol {tol or 2e-5}, rtol "
                             f"{tol or 1e-4}) {ok}; ")
                else:
                    ok = math.isfinite(d) and d <= (tol or 1e-3) * top
                    line += (f"max|diff| {d:.3e} (max|ref| {top:.3e}, "
                             f"ratio {d / top:.2e}); ")
                if not bf16:
                    line += (f"vs fp64: kernel "
                             f"{(got - w64).abs().max().item():.3e}, plain "
                             f"{(want - w64).abs().max().item():.3e}; ")
                if not ok:
                    print(line, flush=True)
                    raise AssertionError(f"{tag} {name} disagrees")
                key = ("fwd" if name == "o" else "bwd") + \
                    ("_bf16" if bf16 else "")
                err[key] = max(err[key], d)
            tensor, row, at = _rows_held(torch, got, w64, dtype)
            print(line + f"rows vs fp64: tensor {tensor:.3f}, worst row "
                  f"{row:.3f} (row {at}) of the bound"
                  + ("" if enforce_rows else " (shown)"))
            if enforce_rows and not (tensor <= 1 and row <= 1):
                raise AssertionError(f"{tag} {name} disagrees row by row")
        del o, lse, grads, plain, o64, g64, xs
        torch.cuda.empty_cache()


def _serve_batch(arch):
    """The prefill rows SERVE_RUNS gives `arch`."""
    return {a: b for a, b, *_ in SERVE_RUNS}[arch]


def _swa_bound(B, S, KV, G, hd, window, causal):
    """(bound ms, bound_by, GFLOP) of a bf16 forward call."""
    from repro_torch.kernels.swa_attention import band_pairs
    heads = B * KV * G
    flops = 4 * hd * band_pairs(S, S, window, causal) * heads
    nbytes = 2 * (2 * B * S * KV * G * hd + 2 * B * S * KV * hd) \
        + 4 * heads * S
    ops_ms = flops / BF16_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops / 1e9)


def _swa_forward_case(torch, K, gen, label, B1, S, KV, G, hd, window,
                      causal):
    """A layer kind of the serving path's prefill, forward only, in bf16
    (the path's type), at the prefill's whole batch (`_serve_batch` of
    the label's model, the shape the path gives the kernel): each row of
    the kernel's output against the plain flash attention on that row
    alone (the same bf16 values, computed in fp32), at the bf16 forward
    tolerance (allclose atol 3e-2, rtol 3e-2) and row by row
    (`_rows_held`); the whole-batch call timed beside its bound, then
    its first B1 rows alone timed beside the plain version and SDPA's
    forward. -> its row."""
    B = _serve_batch(label.split()[0])
    bf = lambda *s: torch.randn(*s, generator=gen,           # noqa: E731
                                device="cuda").bfloat16()
    q, k, v = bf(B, S, KV, G, hd), bf(B, S, KV, hd), bf(B, S, KV, hd)
    o, _ = K.swa_flash_fwd(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    tag = f"swa_flash {label} bf16 o (forward only)"
    d, top, worst = 0.0, 0.0, (0.0, 0.0, 0, 0)
    for b in range(B):
        want = K.swa_flash_plain(q[b:b + 1].float(), k[b:b + 1].float(),
                                 v[b:b + 1].float(), window=window,
                                 causal=causal)
        got = o[b:b + 1].float()
        db = (got - want).abs().max().item()
        ok = torch.allclose(got, want, atol=3e-2, rtol=3e-2)
        tensor, row, at = _rows_held(torch, o[b:b + 1], want, torch.bfloat16)
        if not (ok and tensor <= 1 and row <= 1):
            print(f"{tag}, row {b} of {B}: max|diff| {db:.3e}; allclose "
                  f"{ok}; rows: tensor {tensor:.3f}, worst row {row:.3f} "
                  f"(row {at}) of the bound", flush=True)
            raise AssertionError(f"{tag} disagrees in row {b} of {B}")
        d, top = max(d, db), max(top, want.abs().max().item())
        worst = max(worst, (row, tensor, b, at))
        del want, got
    print(f"{tag}, each of {B} rows against the plain version on the row: "
          f"max|diff| {d:.3e} (max|ref| {top:.3e}); allclose (atol 3e-2, "
          f"rtol 3e-2) True; worst row {worst[0]:.3f} of the bound "
          f"(batch row {worst[2]}, row {worst[3]}; its tensor "
          f"{worst[1]:.3f})")
    del o
    torch.cuda.empty_cache()
    batch_ms = _cuda_ms(torch, lambda: K.swa_flash_fwd(
        q, k, v, window=window, causal=causal), reps=3, trials=5,
        hold_cycles=HOLD_CYCLES)
    batch_bound, _, batch_gflop = _swa_bound(B, S, KV, G, hd, window,
                                             causal)
    torch.cuda.empty_cache()
    q, k, v = (t[:B1].contiguous() for t in (q, k, v))
    ms = _cuda_ms(torch, lambda: K.swa_flash_fwd(
        q, k, v, window=window, causal=causal), reps=5, trials=5,
        hold_cycles=HOLD_CYCLES)
    plain_ms = _host_ms(torch, lambda: K.swa_flash_plain(
        q, k, v, window=window, causal=causal))
    torch.cuda.empty_cache()
    backend, lib_ms, _, why = _sdpa_yardstick(
        torch, {"q": q, "k": k, "v": v, "do": q}, window, causal,
        backward=False)
    torch.cuda.empty_cache()
    bound_ms, bound_by, gflop = _swa_bound(B1, S, KV, G, hd, window, causal)
    print(f"swa_flash {label}: B={B} ms={batch_ms:.4f} bound_ms="
          f"{batch_bound:.5f} ({batch_gflop:.1f} GFLOP; "
          f"{batch_ms / batch_bound:.2f}x bound); B={B1} ms={ms:.4f} "
          f"plain_ms={plain_ms:.3f} library_ms={lib_ms} ({backend or why}) "
          f"bound_ms={bound_ms:.5f} ({gflop:.1f} GFLOP; "
          f"{ms / bound_ms:.2f}x bound)")
    return {"label": label, "shape": [B1, S, KV, G, hd],
            "window": window, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "max_abs_err_bf16": d, "path_batch": B,
            "path_batch_ms": batch_ms, "path_batch_bound_ms": batch_bound,
            "path_batch_worst_row": worst[0]}


def check_swa(torch):
    """The swa_flash forward and backward kernels against the plain flash
    attention and its autograd (`_swa_check`, both types), at
    starcoder2-3b's path shape and gemma3-4b's head shape (window 1024,
    then the full window), the forward alone at the serving prefill's
    rows (`_swa_forward_case`), then at SWA_EDGE_CASES, TF32 off. The plain
    version computes in fp32 whatever its inputs' type. Times in bf16 at
    SWA_CASES; the bound at the bf16 tensor-core peak or the HBM rate,
    whichever is larger."""
    K = importlib.import_module("repro_torch.kernels.swa_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"fwd": 0.0, "bwd": 0.0, "fwd_bf16": 0.0, "bwd_bf16": 0.0}
    rows, serving = {}, []
    for label, B, S, KV, G, hd, window, causal, on_path in SWA_CASES:
        if on_path == SERVING:
            serving.append(_swa_forward_case(torch, K, gen, label, B, S, KV,
                                             G, hd, window, causal))
            torch.cuda.empty_cache()
            continue
        x = _swa_inputs(torch, gen, B, S, KV, G, hd)
        _swa_check(torch, K, label, x, window, causal, True, err)

        # times in bf16, the path's type
        xb = {n: t.bfloat16() for n, t in x.items()}
        q, k, v, do = (xb[n] for n in ("q", "k", "v", "do"))
        o, lse = K.swa_flash_fwd(q, k, v, window=window, causal=causal)
        fwd_ms = _cuda_ms(torch, lambda: K.swa_flash_fwd(
            q, k, v, window=window, causal=causal), reps=5, trials=5,
            hold_cycles=HOLD_CYCLES)
        bwd_ms = _cuda_ms(torch, lambda: K.swa_flash_bwd(
            do, q, k, v, o, lse, window=window, causal=causal), reps=5,
            trials=5, hold_cycles=HOLD_CYCLES)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fwd_plain_ms = _host_ms(torch, lambda: K.swa_flash_plain(
            *(t.detach() for t in leaves), window=window, causal=causal))
        op = K.swa_flash_plain(*leaves, window=window, causal=causal)
        bwd_plain_ms = _host_ms(torch, lambda: torch.autograd.grad(
            op, leaves, do, retain_graph=True))
        del op, leaves
        torch.cuda.empty_cache()
        backend, lib_fwd, lib_bwd, why = _sdpa_yardstick(torch, xb, window,
                                                         causal)
        torch.cuda.empty_cache()
        print(f"swa_flash {label} library: "
              + (f"SDPA backend {backend}: fwd {lib_fwd:.4f} ms, bwd "
                 f"{lib_bwd:.4f} ms" if backend else
                 f"SDPA refused ({why}): none"))
        pairs = K.band_pairs(S, S, window, causal)
        heads = B * KV * G
        el = 2                                    # bf16 bytes
        n_q, n_kv = B * S * KV * G * hd, B * S * KV * hd
        io_fwd = el * (2 * n_q + 2 * n_kv) + 4 * heads * S
        io_bwd = el * (4 * n_q + 4 * n_kv) + 4 * heads * S
        for name, ms, plain_ms, lib_ms, flops, nbytes in (
                ("swa_flash", fwd_ms, fwd_plain_ms, lib_fwd,
                 4 * hd * pairs * heads, io_fwd),
                ("swa_flash_bwd", bwd_ms, bwd_plain_ms, lib_bwd,
                 10 * hd * pairs * heads, io_bwd)):
            ops_ms = flops / BF16_FLOPS * 1e3
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            print(f"{name} {label}: ms={ms:.4f} plain_ms={plain_ms:.3f} "
                  f"library_ms={lib_ms} bound_ms={bound_ms:.5f} ({pairs} "
                  f"pairs x {heads} heads, {flops / 1e9:.1f} GFLOP -> "
                  f"{ops_ms:.5f} ms, {nbytes / 1e6:.1f} MB -> "
                  f"{bytes_ms:.5f} ms; {ms / bound_ms:.1f}x bound)")
            if on_path:
                row = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "operations" if ops_ms >= bytes_ms
                    else "bytes", "library_ms": lib_ms,
                    "library_call": (f"scaled_dot_product_attention "
                                     f"({backend})" if backend else why)}
                if name in rows:          # a later training path's shape
                    rows[name]["train_cases"].append(
                        {"label": label, "shape": [B, S, KV, G, hd],
                         "window": window, "causal": causal, **row})
                else:
                    rows[name] = {**row, "train_cases": []}
        del x, xb, q, k, v, do, o, lse
        torch.cuda.empty_cache()
    edge = torch.Generator(device="cuda").manual_seed(1)
    for label, B, S, KV, G, hd, window, causal in SWA_EDGE_CASES:
        x = _swa_inputs(torch, edge, B, S, KV, G, hd)
        _swa_check(torch, K, label, x, window, causal, False, err)
        del x
    for name in rows:
        rows[name]["max_abs_err"] = err["fwd" if name == "swa_flash"
                                        else "bwd"]
        rows[name]["max_abs_err_bf16"] = err[
            "fwd_bf16" if name == "swa_flash" else "bwd_bf16"]
    rows["serving_cases"] = serving
    return rows


def _xor_cases():
    """(label, k, n lanes, the bound stated for it): (a) the RAIM5 stripe
    of the opt-125m path at an SG of 4 (k = n - 1 = 3 data blocks of
    block_size(state, 4) bytes, padded to 512 as xor_parity_encode pads
    them), (b) a 4 MiB bucket, (c) an odd lane count (the kernel's 4-byte
    body), (d) one row, (e) eight rows."""
    from repro_torch.core import raim5
    bs = raim5.block_size(_state_bytes(DURABLE_ARCH), SG)
    lanes = -(-bs // 512) * 128
    return bs, [("(a) opt-125m RAIM5 stripe", SG - 1, lanes),
                ("(b) 4 MiB bucket", 3, MIB4 // 4),
                ("(c) odd n", 3, 1_000_003),
                ("(d) k = 1", 1, MIB4 // 4),
                ("(e) k = 8", 8, MIB4 // 4)]


def check_xor(torch):
    """xor_reduce against xor_reduce_plain on the card, bit-exact, at the
    cases of `_xor_cases`; then the public entry point at case (a):
    xor_parity_encode and xor_parity_decode byte for byte against the
    host codec `core/raim5.py::xor_blocks`."""
    import numpy as np

    from repro_torch.core import raim5
    from repro_torch.kernels import xor_parity as X
    from repro_torch.kernels import xor_parity_decode, xor_parity_encode
    gen = torch.Generator(device="cuda").manual_seed(0)
    bs, cases = _xor_cases()
    rows = []
    for label, k, n in cases:
        blocks = torch.randint(-2 ** 31, 2 ** 31, (k, n), generator=gen,
                               dtype=torch.int32, device="cuda") \
            .view(torch.uint32)
        out = X.xor_reduce(blocks)
        plain = X.xor_reduce_plain(blocks)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), plain.view(torch.int32)):
            raise AssertionError(f"xor_reduce {label} disagrees")
        ms = _cuda_ms(torch, lambda: X.xor_reduce(blocks),
                      hold_cycles=HOLD_CYCLES)
        plain_ms = _host_ms(torch, lambda: X.xor_reduce_plain(blocks))
        moved = (k + 1) * 4 * n
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        n_vec = X.vector_count(n, blocks.data_ptr())
        rows.append({"case": label, "k": k, "n": n, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bytes": moved, "max_abs_err": 0})
        print(f"xor_reduce {label}: k={k} n={n} "
              f"{'vector' if n_vec else '4-byte'} body ms={ms:.5f} "
              f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.5f} ({moved} B;"
              f" {ms / bound_ms:.2f}x bound) bit-exact")
        del blocks, out, plain
    raw = torch.randint(0, 256, (SG - 1, bs), generator=gen,
                        dtype=torch.uint8, device="cuda")
    parity = xor_parity_encode(raw)
    lost = xor_parity_decode(raw[[0, 2]], parity)
    torch.cuda.synchronize()
    host = [raw[i].cpu().numpy() for i in range(SG - 1)]
    if not (np.array_equal(parity.cpu().numpy(), raim5.xor_blocks(host))
            and torch.equal(lost, raw[1])):
        raise AssertionError("xor_parity_encode/decode disagree with "
                             "raim5.xor_blocks")
    print(f"xor_parity_encode / xor_parity_decode, {SG - 1} x {bs} B: "
          f"byte-identical to raim5.xor_blocks")
    torch.cuda.empty_cache()
    return rows


def main_path(torch, arch, seq, batch, layers, must_launch):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    ckpt = tempfile.mkdtemp(prefix="reft-chip-smoke-")
    cut = [] if layers is None else ["--layers", str(layers)]
    # free whatever an earlier phase left for the collector
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = train.run(["--arch", arch, "--seq", str(seq), "--batch",
                         str(batch), *cut, *RUN_ARGS, "--ckpt-dir", ckpt])
        wall = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    # the run's last state must be gone as it returns, no collection
    # needed (a finished flight drops the leaves it pinned)
    after = torch.cuda.memory_allocated()
    print(f"{arch} path: device memory allocated {base} B before the run, "
          f"{after} B once it returned (before any collection): "
          f"{(after - base) / 1e9:+.3f} GB")
    if after - base > 1e9:
        raise AssertionError(f"{arch}: {after - base} B more allocated "
                             f"after the run than before it")
    want = _want_tiers(rep, arch)
    if _tiers(rep) != want:
        raise AssertionError(f"{arch}: recoveries {rep['recoveries']}: want "
                             f"{want}, all byte-exact")
    if not all(e.get("device_encode") for e in rep["engine_stats"]):
        raise AssertionError(f"{arch}: device encode was off on the path")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the {arch} path")
    steps = rep["step_seconds"]
    for fwd in ("swa_flash", "ssd_scan"):
        if fwd in must_launch:
            # every layer, every step taken: forward and its remat
            # recompute, then one backward
            n_layers = _path_config(arch, layers).num_layers
            want = {fwd: 2 * n_layers * len(steps),
                    fwd + "_bwd": n_layers * len(steps)}
            got = {k: launches[k] for k in want}
            if got != want:
                raise AssertionError(f"{arch}: {fwd} launches {got}, want "
                                     f"{want}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in rep["losses"]):
        raise AssertionError(f"{arch}: loss is not finite")
    st = rep["stats"]
    flights = st.get("engine_snapshots", 0)
    # steps some member snapshot (whole rounds, or partial ones that
    # members with a busy flight slot skipped)
    launched = len(rep["snapshot_crcs"])
    print(f"{arch} path ({batch}x{seq}, "
          f"{'full depth' if layers is None else f'{layers} layers'}): "
          f"peak device memory {peak:.3f} GB")
    print(f"{arch} path: wall {wall:.3f} s, {len(steps)} steps, "
          f"median step {statistics.median(steps):.4f} s, losses "
          f"{rep['losses'][0]:.4f} -> {rep['losses'][-1]:.4f}, step seconds "
          + json.dumps([round(x, 4) for x in steps]))
    for beside in (False, True):
        part = [t for t, f in zip(steps, rep["step_beside_flight"])
                if f == beside]
        print(f"{arch} path: {len(part)} steps "
              f"{'beside a flight' if beside else 'with no flight in the air'}"
              + (f": {min(part):.4f}-{max(part):.4f} s, median "
                 f"{statistics.median(part):.4f} s" if part else ""))
    print(f"snapshots: {launched} snapshot steps launched, {flights} "
          f"member flights completed, avg flight "
          f"{st.get('engine_seconds', 0.0) / max(flights, 1):.4f} s, "
          f"levels l1={st.get('engine_l1_seconds', 0.0):.3f} "
          f"l2={st.get('engine_l2_seconds', 0.0):.3f} "
          f"l3={st.get('engine_l3_seconds', 0.0):.3f} s")
    print(f"{arch} launches: {json.dumps(launches)} (encode_bucket "
          f"{launches['encode_bucket'] / max(launched, 1):.1f} per snapshot "
          f"step)")
    print("snapshot CRCs: " + json.dumps(
        {str(k): f"{v:#010x}" for k, v in rep["snapshot_crcs"].items()}))
    print(f"recoveries: {json.dumps(rep['recoveries'])}")
    return launches, statistics.median(steps)


def _train(args):
    from repro_torch.launch import train
    rep = train.run(args)
    if not all(math.isfinite(x) for x in rep["losses"]):
        raise AssertionError(f"{args}: loss is not finite")
    return rep


def _tiers(rep):
    return [(r["tier"], r["bit_exact"]) for r in rep["recoveries"]]


def _restore_tier(r, what):
    """The tier a REFT restore must take, from its record: each member's
    clean steps as the ladder read them from its SMP (`clean`), and each
    live member's flights as its own engine saw them when that read began
    (`flights`, in launch order). The engines' record is held against the
    SMPs' read:
      - each member's flight that its engine saw land last is among that
        member's clean steps (no snapshot an SMP acknowledged is lost);
      - the restored step is the newest that SG - 1 members held (with
        the rule above, no rollback past a step that landed on them);
      - from memory when all SG members held it; by a RAIM5 decode
        otherwise, and then only when every live member without it had
        not seen its flight of that step land (in the air, failed, or
        never launched: a member whose flight slot was busy).
    A restore without the record fails."""
    clean, flights = r.get("clean"), r.get("flights")
    if not clean or not flights:
        raise AssertionError(f"{what}: no record of the SMPs' read and the "
                             f"engines' flights in {r}")
    held = {}
    for m, steps in clean.items():
        for s in steps:
            held.setdefault(s, set()).add(m)
    for m, f in flights.items():
        if f["landed"] and f["landed"][-1] not in clean.get(m, ()):
            raise AssertionError(f"{what}: member {m}'s engine saw step "
                                 f"{f['landed'][-1]} land, its SMP holds "
                                 f"{clean.get(m)}: {r}")
    ok = [s for s, ms in held.items() if len(ms) >= SG - 1]
    if not ok:
        raise AssertionError(f"{what}: no step held by {SG - 1} of {SG} "
                             f"members: {r}")
    step = max(ok)
    if r["step"] != step:
        raise AssertionError(f"{what}: restored step {r['step']}, not "
                             f"{step}, the newest that {SG - 1} members "
                             f"held: {r}")
    if len(held[step]) == SG:
        return "in-memory"
    seen = [m for m, f in flights.items()
            if m not in held[step] and step in f["landed"]]
    if seen:
        raise AssertionError(f"{what}: members {seen} saw step {step} land "
                             f"but their SMPs lack it: {r}")
    return "raim5"


def _want_tiers(rep, what):
    """The tiers RUN_ARGS' two failures must recover through, both
    byte-exact: the software failure of node 0 as its restore's record
    says (`_restore_tier`: in-memory, or raim5 while node 0's flight of
    the newest step was in the air); the failure of node 1, whose SMP
    goes with it, raim5."""
    recs = rep["recoveries"]
    if len(recs) != 2:
        raise AssertionError(f"{what}: recoveries {recs}, want two")
    first = _restore_tier(recs[0], f"{what}, first recovery")
    second = _restore_tier(recs[1], f"{what}, second recovery")
    in_air = {m: f["in_air"] for m, f in recs[0]["flights"].items()
              if f["in_air"]}
    print(f"{what}: first restore, step {recs[0]['step']}, must be {first} "
          f"(flights in the air when it read: {in_air or 'none'}); second "
          f"must be raim5 (record: {second})")
    return [(first, True), ("raim5", True)]


def _persists_held(rep, fams, what):
    """A durable run's rounds against its store: some round persisted,
    the session's closing persist counted (the node failure fails the
    rounds in the air, and a cadence round after it finds no step clean
    on the respawned member until its first flight lands, which may be
    after the last step), some bytes were uploaded, and every family with
    a manifest in the store is a step the run's events report persisted."""
    persisted = rep["persisted_steps"]
    up = rep["stats"].get("persist_upload_bytes")
    stray = sorted(set(fams) - set(persisted))
    if not persisted or not up or not fams or stray:
        raise AssertionError(f"{what}: persisted steps {persisted}, uploads "
                             f"{up} B, families with a manifest "
                             f"{sorted(fams)} (not persisted: {stray})")


def _objstore_run(ckpt):
    """The objstore run: a persist every 4 steps, the two failures."""
    from repro_torch.store import LocalObjectStore, object_families
    rep = _train([*DURABLE_ARGS, "--backend", "objstore", "--ckpt-every", "4",
                  "--inject", "6:software", "--inject", "10:node",
                  "--ckpt-dir", ckpt])
    want = _want_tiers(rep, "objstore run")
    if _tiers(rep) != want:
        raise AssertionError(f"objstore run: recoveries {rep['recoveries']}:"
                             f" want {want}, all byte-exact")
    st = rep["stats"]
    fams = object_families(LocalObjectStore(os.path.join(ckpt, "objstore")),
                           "families")
    _persists_held(rep, fams, "objstore run")
    steps = rep["step_seconds"]
    print(f"objstore run: {len(steps)} steps, median step "
          f"{statistics.median(steps):.4f} s, persists "
          f"{st.get('persist', 0)} in the steps, "
          f"{len(rep['persisted_steps'])} with the closing one (steps "
          f"{rep['persisted_steps']}) "
          f"(persist_s {st.get('persist_seconds', 0.0):.3f}), "
          f"persist_overlap_s {st.get('persist_overlap_seconds', 0.0):.3f}, "
          f"uploads {st['persist_upload_bytes'] / 1e6:.1f} MB in "
          f"{st.get('persist_upload_seconds', 0.0):.3f} s (summed over "
          f"members), retries {st.get('persist_upload_retries', 0)}; "
          f"families in the store: {sorted(fams)}")
    print(f"objstore run: recoveries {json.dumps(rep['recoveries'])}")
    print("objstore run: step seconds "
          + json.dumps([round(x, 4) for x in steps]))
    return rep


def _flip(read, write, off, what):
    """Overwrite 4 bytes at `off` with their complement; -> the originals."""
    orig = bytes(read(off, off + 4))
    write(off, bytes(b ^ 0xFF for b in orig))
    print(f"damaged 4 bytes of {what}")
    return orig


def _on_card(torch, state, what):
    from repro_torch.core.treebytes import leaf_arrays
    from repro_torch.train.steps import state_to
    dev = state_to(state, "cuda")
    if not all(t.is_cuda for t in leaf_arrays(dev)):
        raise AssertionError(f"{what}: a restored leaf is not on the card")
    return dev


def _below_ram(torch, ckpt, crcs):
    """Below RAM: a fresh objstore checkpointer over the objstore run's
    directory (its
    SMPs hold no snapshot, so RAM and RAIM5 cannot serve): restore from
    the .reft family, damage a data block of a .reft file and of a store
    object, scrub both tiers, then delete every .reft and restore from the
    object store. -> (the state on the card, its step, the store)."""
    import glob
    import pickle

    from repro_torch.api import CheckpointSpec, create_checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core import raim5
    from repro_torch.core.treebytes import state_crc
    from repro_torch.store import load_manifest
    from repro_torch.train.steps import init_train_state
    template = init_train_state(get_config(DURABLE_ARCH), 0, device="cuda")
    spec = CheckpointSpec(backend="objstore", ckpt_dir=ckpt, sg_size=SG,
                          options={"scrub_every_s": 0.0})
    ck = create_checkpointer(spec, template)
    try:
        t0 = time.perf_counter()
        res = ck.restore()
        restore_s = time.perf_counter() - t0
        crc = state_crc(res.state)
        if res.tier != "checkpoint" or crc != crcs.get(res.step):
            raise AssertionError(f"restore below RAM: tier {res.tier} step "
                                 f"{res.step} crc {crc:#010x}, want "
                                 f"checkpoint and the objstore run's crc")
        _on_card(torch, res.state, "checkpoint restore")
        step = res.step
        print(f"restore tier=checkpoint step={step} seconds={restore_s:.3f} "
              f"read={res.load.bytes_read / 1e6:.1f}MB crc={crc:#010x} "
              f"(the objstore run's)")

        # damage: block 1 of node 1's .reft file, block 0 of node 2's object
        bs = raim5.block_size(ck.group.total_bytes, SG)
        path = os.path.join(ckpt, f"step-{step}-node-1.reft")
        with open(path, "rb") as f:
            pickle.load(f)
            off = f.tell()

        def fread(lo, hi):
            with open(path, "rb") as f:
                f.seek(lo)
                return f.read(hi - lo)

        def fwrite(lo, blob):
            with open(path, "r+b") as f:
                f.seek(lo)
                f.write(blob)

        file_off = off + bs + 12345
        file_orig = _flip(fread, fwrite, file_off,
                          f"{os.path.basename(path)} (data block 1)")
        store = ck.store
        ent = load_manifest(store, ck.store_prefix, step)["nodes"][2]
        obj_off = int(ent["data_off"]) + 54321
        obj_orig = _flip(lambda lo, hi: store.read_range(ent["key"], lo, hi),
                         lambda lo, blob: store.write_range(ent["key"], lo,
                                                            blob),
                         obj_off, f"object {ent['key']} (data block 0)")
        t0 = time.perf_counter()
        reports = ck.scrub()
        scrub_s = time.perf_counter() - t0
        found = {}
        for kind in ("file", "object"):
            reps = [r for r in reports if r.kind == kind]
            found[kind] = {"families": len(reps),
                           "segments": sum(r.segments for r in reps),
                           "bytes": sum(r.bytes_verified for r in reps),
                           "corrupt": sum(len(r.corrupt) for r in reps),
                           "repaired": sum(len(r.repaired) for r in reps),
                           "unrepairable": sum(len(r.unrepairable)
                                               for r in reps),
                           "errors": sum(len(r.errors) for r in reps),
                           "which": [(r.step, r.corrupt, r.repaired)
                                     for r in reps if r.corrupt]}
            if found[kind]["corrupt"] < 1 or found[kind]["repaired"] < 1:
                raise AssertionError(f"scrub of the {kind} tier: "
                                     f"{found[kind]}")
        if fread(file_off, file_off + 4) != file_orig or bytes(
                store.read_range(ent["key"], obj_off, obj_off + 4)) \
                != obj_orig:
            raise AssertionError("scrub: repaired bytes differ from the "
                                 "originals")
        print(f"scrub: {scrub_s:.3f} s, {json.dumps(found)}; repaired "
              f"bytes equal the originals")

        for p in glob.glob(os.path.join(ckpt, "*.reft")):
            os.unlink(p)
        t0 = time.perf_counter()
        res = ck.restore()
        restore2_s = time.perf_counter() - t0
        crc = state_crc(res.state)
        if res.tier != "objstore" or crc != crcs.get(res.step):
            raise AssertionError(f"restore after deleting the .reft files: "
                                 f"tier {res.tier} step {res.step} crc "
                                 f"{crc:#010x}, want objstore and the run's")
        dev = _on_card(torch, res.state, "objstore restore")
        print(f"restore tier=objstore step={res.step} seconds="
              f"{restore2_s:.3f} read={res.load.bytes_read / 1e6:.1f}MB "
              f"crc={crc:#010x} (the objstore run's)")
        return dev, res.step, store
    finally:
        ck.close()


def _parity_on_card(torch, state, step, store):
    """The public kernel entry point on the restored state: each
    stripe's parity with xor_parity_encode, byte for byte against the
    parity block the SMPs persisted (the objstore run's store objects),
    then node 1's data blocks back from xor_parity_decode."""
    from repro_torch.core import raim5
    from repro_torch.core.treebytes import leaf_arrays, tensor_u8
    from repro_torch.kernels import xor_parity_decode, xor_parity_encode
    from repro_torch.store import load_manifest
    flat = torch.cat([tensor_u8(t) for t in leaf_arrays(state)])
    n, total = SG, flat.numel()
    bs = raim5.block_size(total, n)
    padded = torch.zeros(n * (n - 1) * bs, dtype=torch.uint8, device="cuda")
    padded[:total] = flat
    del flat
    stripes = padded.view(n, n - 1, bs)
    man = load_manifest(store, "families", step)
    own = (n - 1) * bs
    parity = {}
    t0 = time.perf_counter()
    for s in range(n):
        got = xor_parity_encode(stripes[s])
        ent = man["nodes"][s]
        off = int(ent["data_off"]) + own
        saved = torch.from_numpy(store.read_range(ent["key"], off, off + bs)
                                 ).to("cuda")
        if not torch.equal(got, saved):
            raise AssertionError(f"stripe {s}: parity on the card differs "
                                 f"from the persisted parity")
        parity[s] = saved
    lost = 1
    for ref in raim5.data_blocks_of_node(lost, n):
        s, j = ref.stripe, ref.index
        surv = stripes[s, [i for i in range(n - 1) if i != j]]
        if not torch.equal(xor_parity_decode(surv, parity[s]),
                           stripes[s, j]):
            raise AssertionError(f"decode of node {lost}'s block ({s}, {j}) "
                                 f"differs")
    torch.cuda.synchronize()
    print(f"xor_parity_encode: {n} stripe parities of {bs} B on the card, "
          f"byte-identical to the persisted ones; xor_parity_decode: node "
          f"{lost}'s {n - 1} data blocks byte-identical "
          f"({time.perf_counter() - t0:.3f} s with the store reads)")


def _disk_run(backend, ckpt, reft_median):
    """A disk baseline run, a software failure at step 6."""
    rep = _train([*DURABLE_ARGS, "--backend", backend,
                  "--inject", "6:software", "--ckpt-dir", ckpt])
    if _tiers(rep) != [("disk", True)]:
        raise AssertionError(f"{backend} run: recoveries "
                             f"{rep['recoveries']}: want disk, byte-exact")
    st, steps = rep["stats"], rep["step_seconds"]
    snaps = st.get("snapshot", 0)
    med = statistics.median(steps)
    print(f"{backend} run: {len(steps)} steps, median step {med:.4f} s "
          f"(REFT opt-125m in phase 4: {reft_median:.4f} s), snapshots "
          f"{snaps}, snapshot_s {st.get('snapshot_seconds', 0.0):.3f} "
          f"({st.get('snapshot_seconds', 0.0) / max(snaps, 1):.3f} a "
          f"snapshot as the trainer saw it), last save "
          + json.dumps({k: round(v, 4) for k, v in rep["disk_times"].items()}))
    print(f"{backend} run: recoveries {json.dumps(rep['recoveries'])}")
    print(f"{backend} run: step seconds "
          + json.dumps([round(x, 4) for x in steps]))
    return med


def durable_path(torch, reft_median):
    """Phase 5, one path: the objstore run, the restores below RAM and the
    entry point in one directory, then the disk runs in fresh ones; the
    launch counts are set to 0 just before it and read just after."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    t0 = time.perf_counter()
    ckpt = tempfile.mkdtemp(prefix="reft-chip-objstore-")
    try:
        rep = _objstore_run(ckpt)
        state, step, store = _below_ram(torch, ckpt, rep["snapshot_crcs"])
        _parity_on_card(torch, state, step, store)
        del state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for backend in ("sync_disk", "async_disk"):
        ckpt = tempfile.mkdtemp(prefix=f"reft-chip-{backend}-")
        try:
            _disk_run(backend, ckpt, reft_median)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
    launches = launch_counts()
    print(f"{DURABLE} path: wall {time.perf_counter() - t0:.3f} s, launches "
          f"{json.dumps(launches)}")
    if launches["xor_reduce"] <= 0 or launches["encode_bucket"] <= 0:
        raise AssertionError(f"{DURABLE} path: launches {launches}")
    return launches


def _shm_runs():
    """Run ids that hold snapshot-manager segments in /dev/shm."""
    return {name.split("-")[1] for name in os.listdir("/dev/shm")
            if name.startswith("reft-")}


def _oracle_ring_ms(torch):
    """What the supervisor's oracle ring costs a step: one copy of
    opt-125m's train state on the card (`supervisor._copy_tree`, a
    `Tensor.clone()` a leaf), CUDA-event time, beside the copy's bound
    (the state read once and written once at the HBM rate)."""
    from repro_torch.configs import get_config
    from repro_torch.supervise.supervisor import _copy_tree
    from repro_torch.train.steps import init_train_state
    state = init_train_state(get_config("opt-125m"), 0, device="cuda")
    ms = _cuda_ms(torch, lambda: _copy_tree(state), reps=5, trials=5)
    bound = 2 * _state_bytes("opt-125m") / HBM_BYTES_PER_S * 1e3
    del state
    torch.cuda.empty_cache()
    return ms, bound


def drill_path(torch):
    """Phase 6: `repro_torch.supervise.run` at full width (DRILL_ARGS), the
    launch counts set to 0 just before it and read just after. Fails
    unless the run's own exit checks pass, every kind fired, one at least
    mid-flight, every failure recovered and every restore (the laggard's
    verification restore among them) byte-exact, the elastic 4 -> 2
    rebuild restored, and the old SG's /dev/shm segments were gone once
    the rebuild restored and none are left after the run."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.supervise import FAILURE_KINDS
    from repro_torch.supervise import run as drill
    ckpt = tempfile.mkdtemp(prefix="reft-chip-drill-")
    before = _shm_runs()
    at_rebuild = []

    def on_event(ev):
        if ev.get("elastic"):
            at_rebuild.append(sorted(_shm_runs() - before))

    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = drill.run([*DRILL_ARGS, "--ckpt-dir", ckpt], on_event=on_event)
        wall = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    left = sorted(_shm_runs() - before)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ring_ms, ring_bound_ms = _oracle_ring_ms(torch)
    events = out["events"]
    g = out["goodput"]
    keys = ("kind", "node", "fired_step", "graceful", "tier",
            "restored_step", "restore_s", "detect_s", "rolled_back",
            "bit_exact", "elastic", "evicted", "recovered")
    print(json.dumps({"drill": {
        "wall_s": wall, "peak_device_gb": peak,
        "scenarios": [[sc["step"], sc["kind"], sc["node"], sc["graceful"]]
                      for sc in out["config"]["scenarios"]],
        "events": [{k: e[k] for k in keys if k in e} for e in events],
        "goodput_frac": g["goodput_frac"], "wall_seconds": g["wall_seconds"],
        "seconds": g["seconds"], "accounting_error": g["accounting_error"],
        "cadence": out["cadence"], "mtbf_s": out["mtbf_s"],
        "shm_runs_at_rebuild": at_rebuild, "shm_runs_left": left,
        "oracle_ring_ms_a_step": ring_ms,
        "oracle_ring_bound_ms": ring_bound_ms,
        "launches": launches}}, default=str))
    bad = list(out["failed"])
    if out["kinds"] != sorted(DRILL_KINDS):
        bad.append(f"kinds fired {out['kinds']}")
    if all(sc["graceful"] for sc in out["config"]["scenarios"]):
        bad.append("no injection was mid-flight")
    for e in events:
        if e["kind"] in FAILURE_KINDS and not e.get("recovered"):
            bad.append(f"{e['kind']} not recovered")
        if (e["kind"] in FAILURE_KINDS or e["kind"] == "laggard") \
                and e.get("bit_exact") is not True:
            bad.append(f"{e['kind']}: bit_exact {e.get('bit_exact')}")
    elastic = [e for e in events if e.get("elastic")]
    if [e.get("elastic") for e in elastic] != [f"{SG}->2"] \
            or not elastic[0].get("recovered"):
        bad.append(f"elastic rebuild events {elastic}")
    if len(at_rebuild) != 1 or len(at_rebuild[0]) != 1:
        bad.append(f"SGs holding /dev/shm once the rebuild restored: "
                   f"{at_rebuild} (want the new SG's alone)")
    if left:
        bad.append(f"/dev/shm segments left after the run: {left}")
    if launches["encode_bucket"] <= 0:
        bad.append(f"launches {launches}")
    if bad:
        raise AssertionError(f"{DRILL}: " + "; ".join(map(str, bad)))
    print(f"{DRILL}: wall {wall:.3f} s, {len(events)} faults "
          f"({sum(e['kind'] in FAILURE_KINDS for e in events)} failures), "
          f"goodput {g['goodput_frac']:.4f}, accounting error "
          f"{g['accounting_error']:.2e}, cadence {out['cadence']}, "
          f"oracle ring a step {ring_ms:.4f} ms on the card (bound "
          f"{ring_bound_ms:.4f} ms), launches {json.dumps(launches)}")
    return launches


def _delta_chain(torch, ckpt):
    """A delta chain on the card over opt-125m's full state: an update that
    touches DELTA_TOUCHED leaves a step, reported by the dirty provider
    (`set_dirty_provider`), a snapshot and a persist round each step;
    the newest step and the first delta restored from the chain, byte
    for byte."""
    from repro_torch.api import CheckpointSession, CheckpointSpec
    from repro_torch.configs import get_config
    from repro_torch.core.recovery import restore_from_checkpoint
    from repro_torch.core.treebytes import (leaf_arrays, make_flat_spec,
                                            tree_unflatten)
    from repro_torch.supervise import trees_equal
    from repro_torch.train.steps import init_train_state
    state = init_train_state(get_config("opt-125m"), 0, device="cuda")
    fspec = make_flat_spec(state)
    # the smallest parameter leaves: the three norms' scales and one
    # attention projection (stacked over the layers)
    params = [i for i, ls in enumerate(fspec.leaves)
              if ls.path.startswith("['params']")]
    touched = sorted(params, key=lambda i: fspec.leaves[i].nbytes)[
        :DELTA_TOUCHED]
    ranges = [(fspec.leaves[i].offset,
               fspec.leaves[i].offset + fspec.leaves[i].nbytes)
              for i in touched]
    spec = CheckpointSpec(backend="reft", ckpt_dir=ckpt, sg_size=SG,
                          snapshot_every_steps=1,
                          checkpoint_every_steps=10 ** 9, resume=False,
                          options={"delta": True, "device_encode": "on"})
    states, dirty = {}, [None]
    t0 = time.perf_counter()
    with CheckpointSession(spec, state) as sess:
        sess.checkpointer.set_dirty_provider(lambda: dirty[0])
        for step in range(1, DELTA_STEPS + 1):
            if step > 1:
                leaves = leaf_arrays(state)
                for i in touched:
                    leaves[i] = leaves[i] + 1
                state = tree_unflatten(state, leaves)
                dirty[0] = ranges
            states[step] = state
            if not sess.snapshot(state, step, wait=True):
                raise AssertionError(f"{DELTA}: chain snapshot {step} "
                                     f"refused")
            sess.persist(step)
        st = sess.stats()
    files = sorted(os.listdir(ckpt))
    t1 = time.perf_counter()
    for step in (2, DELTA_STEPS):
        got, at, _ = restore_from_checkpoint(ckpt, SG, state, step=step)
        if at != step or not trees_equal(got, states[step]):
            raise AssertionError(f"{DELTA}: chain restore of step {step} "
                                 f"(got {at}) is not byte-exact")
    print(f"{DELTA}: chain of {DELTA_STEPS} snapshots over opt-125m's "
          f"state ({len(touched)} leaves touched a step, "
          f"{sum(b - a for a, b in ranges)} B), {t1 - t0:.3f} s with the "
          f"persists; delta_flights {st.get('delta_flights')} keyframes "
          f"{st.get('keyframe_flights')} skipped_buckets "
          f"{st.get('skipped_buckets')}; families "
          f"{sum(f.endswith('.reft') for f in files)} .reft "
          f"{sum(f.endswith('.reftd') for f in files)} .reftd; steps 2 and "
          f"{DELTA_STEPS} restored from the chain byte-exact in "
          f"{time.perf_counter() - t1:.3f} s")
    if not st.get("delta_flights") or not st.get("skipped_buckets"):
        raise AssertionError(f"{DELTA}: the chain took no delta flight: "
                             f"{st}")


def delta_path(torch):
    """Phase 7a, one path (counts set to 0 before it, read after it): the
    CLI with `--delta` at full width (RUN_ARGS' two failures, each restore
    byte-exact, the dense per-bucket digest compare: every kind-2 bucket
    encoded with its CRC), then `_delta_chain`."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.stage import encode_bucket
    reset_launch_counts()
    t0 = time.perf_counter()
    ckpt = tempfile.mkdtemp(prefix="reft-chip-delta-")
    try:
        rep = _train([*DELTA_ARGS, "--ckpt-dir", ckpt])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    want = _want_tiers(rep, DELTA)
    if _tiers(rep) != want:
        raise AssertionError(f"{DELTA}: recoveries {rep['recoveries']}: "
                             f"want {want}, all byte-exact")
    st = rep["stats"]
    cli_fold_crc = encode_bucket.fold_crc_launches
    print(f"{DELTA} (--delta, the dense digest compare): "
          f"{len(rep['step_seconds'])} steps, median step "
          f"{statistics.median(rep['step_seconds']):.4f} s, delta_flights "
          f"{st.get('delta_flights')} keyframes {st.get('keyframe_flights')} "
          f"skipped_buckets {st.get('skipped_buckets')} base_misses "
          f"{st.get('delta_base_misses')}; encode_bucket launches "
          f"{launch_counts()['encode_bucket']}, kind-2 with CRC "
          f"{cli_fold_crc}; recoveries {json.dumps(rep['recoveries'])}")
    if not st.get("delta_flights"):
        print(f"{DELTA}: the dense digest compare took no delta flight at "
              f"full width")
    if not cli_fold_crc:
        raise AssertionError(f"{DELTA}: no kind-2 bucket encoded with its "
                             f"CRC on the --delta run")
    ckpt = tempfile.mkdtemp(prefix="reft-chip-delta-chain-")
    try:
        _delta_chain(torch, ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    launches = launch_counts()
    fold_crc = encode_bucket.fold_crc_launches
    print(f"{DELTA} path: wall {time.perf_counter() - t0:.3f} s, launches "
          f"{json.dumps(launches)}, kind-2 with CRC {fold_crc}")
    return launches, fold_crc


def moe_delta_path(torch, path, args, must):
    """Phase 7b and 7c, one path each (counts set to 0 before it, read
    after it): the CLI with `--delta` on a reduced model with experts
    (MOE_RUNS: dbrx-132b, every layer MoE, the fp32 swa_flash kernels;
    jamba-v0.1-52b, an SSM layer with an MLP, then attention with the
    MoE, the SSD and the fp32 swa_flash kernels; seq 2048, RUN_ARGS' two
    failures, each restore byte-exact), `must`'s kernels launched, the
    router's touched-expert mask consumed by the dirty provider at each
    flight: each call's touched experts printed, a call for every flight
    the engines began, every byte ruled dirty (the expert leaves are
    stacked over the layers or periods) and so no bucket ruled clean."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    gc.collect()
    reset_launch_counts()
    t0 = time.perf_counter()
    ckpt = tempfile.mkdtemp(prefix="reft-chip-moe-delta-")
    try:
        rep = _train([*args, "--ckpt-dir", ckpt])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    launches = launch_counts()
    want = _want_tiers(rep, path)
    if _tiers(rep) != want:
        raise AssertionError(f"{path}: recoveries {rep['recoveries']}:"
                             f" want {want}, all byte-exact")
    for name in must:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the "
                                 f"{path} path")
    calls = rep["expert_flights"]
    clean = [e.get("provider_clean_buckets", 0) for e in rep["engine_stats"]]
    st = rep["stats"]
    flights = st.get("delta_flights", 0) + st.get("keyframe_flights", 0)
    print(f"{path}: {len(rep['step_seconds'])} steps, median step "
          f"{statistics.median(rep['step_seconds']):.4f} s, wall "
          f"{time.perf_counter() - t0:.3f} s; delta_flights "
          f"{st.get('delta_flights')} keyframes {st.get('keyframe_flights')}"
          f" skipped_buckets {st.get('skipped_buckets')}; the provider's "
          f"{len(calls)} calls (one a member flight), experts touched since "
          f"the last call: {[c['touched'] for c in calls]}; dirty bytes "
          f"{sorted({c['dirty_bytes'] for c in calls})} of "
          f"{calls[0]['total_bytes'] if calls else 0}; buckets the provider "
          f"ruled clean, by member: {clean}; launches "
          f"{json.dumps(launches)}; recoveries "
          f"{json.dumps(rep['recoveries'])}")
    if len(calls) < flights or not any(c["touched"] for c in calls) \
            or any(c["dirty_bytes"] != c["total_bytes"] for c in calls) \
            or any(clean):
        raise AssertionError(f"{path}: the provider's calls {calls} "
                             f"({flights} flights), clean buckets {clean}")
    return launches


def stage_path(torch):
    """Phase 7c, one path: `MultiStageGroup(N_PP, DP)` over opt-125m's full
    state after one train step, on the card; one node lost in each stage
    at the same step, both stages recovered (each stage's tier printed)
    and the joined state held byte for byte."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.multistage import MultiStageGroup
    from repro_torch.core.snapshot import ReftConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.supervise import trees_equal
    from repro_torch.train.steps import init_train_state, make_train_step
    cfg = get_config("opt-125m")
    state = init_train_state(cfg, 0, device="cuda")
    ds = SyntheticDataset(cfg, InputShape("smoke", 256, 2, "train"), seed=0,
                          device="cuda")
    state, _ = make_train_step(cfg)(state, next(ds))
    torch.cuda.synchronize()
    ckpt = tempfile.mkdtemp(prefix="reft-chip-stages-")
    reset_launch_counts()
    t0 = time.perf_counter()
    g = MultiStageGroup(N_PP, DP, state, ReftConfig(
        ckpt_dir=ckpt, checkpoint_every_snapshots=10 ** 6))
    try:
        bytes_ = [grp.total_bytes for grp in g.groups]
        t1 = time.perf_counter()
        ok = g.snapshot(state, 1)
        snap_s = time.perf_counter() - t1
        enc = [e.stats["device_encode"] for grp in g.groups
               for e in grp.engines]
        for stage in range(N_PP):
            g.inject_node_failure(stage, (stage + 1) % DP)
        t1 = time.perf_counter()
        rec, step, tier = g.recover()
        rec_s = time.perf_counter() - t1
        tiers = g.last_tiers
        exact = trees_equal(rec, state)
    finally:
        g.close()
        shutil.rmtree(ckpt, ignore_errors=True)
    launches = launch_counts()
    print(f"{STAGES}: {N_PP} stages x {DP} members, stage bytes {bytes_}, "
          f"snapshot {snap_s:.3f} s, one node lost in each stage, recovered "
          f"step {step} in {rec_s:.3f} s, stage tiers {tiers} (worst "
          f"{tier}), byte-exact {exact}, device encode {enc}, wall "
          f"{time.perf_counter() - t0:.3f} s, launches "
          f"{json.dumps(launches)}")
    if not (ok and step == 1 and exact and tiers == ["raim5"] * N_PP
            and all(enc) and launches["encode_bucket"] > 0):
        raise AssertionError(f"{STAGES}: snapshot {ok}, step {step}, tiers "
                             f"{tiers}, byte-exact {exact}, device encode "
                             f"{enc}, launches {launches}")
    return launches


def _rel(got, want, rows=False):
    """||got - want|| / ||want|| in fp64; with `rows`, the largest over
    the first axis (each request's logits)."""
    d = (got.double() - want.double()).flatten(1 if rows else 0)
    w = want.double().flatten(1 if rows else 0)
    return (d.norm(dim=-1) / w.norm(dim=-1)).max().item()


# what a PyTorch kernel's name says it does, first match wins
KERNEL_KINDS = [("direct_copy_kernel", "copy/cast"), ("addcmul", "addcmul"),
                ("MulFunctor", "mul"), ("softmax", "softmax"),
                ("where", "where"), ("reduce_kernel", "reduction"),
                ("index", "index"), ("gemm", "matmul"), ("gemv", "matmul"),
                ("nvjet", "matmul"), ("xmma", "matmul")]


def _kernel_kind(name):
    for part, kind in KERNEL_KINDS:
        if part in name:
            return kind
    return name[:48]


def _device_profile(torch, fn, n=2):
    """Device time of `n` calls of `fn` by kind of kernel (the CUDA
    kernels `torch.profiler` traced, named by KERNEL_KINDS). -> (device
    ms a call, [(kind, ms a call)] of the five largest), or (None, [])
    when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kinds = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kind = _kernel_kind(e.name)
            kinds[kind] = kinds.get(kind, 0.0) + \
                e.device_time_total / 1e3 / n
    total = sum(kinds.values())
    return (total or None), sorted(kinds.items(), key=lambda r: -r[1])[:5]


def _decode_leaves(lg, entries):
    """(name, key, what decode wrote, by rows): the last logits (each
    request's row; key None) and each position's cache leaves (key (pos,
    leaf); named "leaf", or "pos leaf" when the period has more than one
    position), k/v in their first SERVE_T slots."""
    many = len(entries) > 1
    return (("logits", None, lg, True),
            *((f"{pos} {n}" if many else n, (pos, n),
               ent[n][:, :, :SERVE_T] if n in ("k", "v") else ent[n], False)
              for pos, ent in sorted(entries.items()) for n in ent))


def _moe_layers(cfg):
    """How many of `cfg`'s layers route their tokens to experts."""
    return sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))


def _routes(fn):
    """fn() with every MoE router call's (T, k) expert ids recorded. ->
    (fn's result, [ids] in call order)."""
    moe = importlib.import_module("repro_torch.models.moe")
    seen, route = [], moe._route

    def recorded(router, cfg, xf):
        probs, w, sel = route(router, cfg, xf)
        seen.append(sel)
        return probs, w, sel

    moe._route = recorded
    try:
        return fn(), seen
    finally:
        moe._route = route


def _route_sets(torch, calls, B, L):
    """(L, B, SERVE_T, k) sorted expert ids from a prefill's router calls
    (a (B*T, k) call a MoE layer, L of them) or SERVE_T decode steps' (a
    (B, k) call a step and MoE layer)."""
    if len(calls) == L:
        ids = torch.stack([c.view(B, SERVE_T, -1) for c in calls])
    else:
        ids = torch.stack([torch.stack(
            [calls[t * L + i] for t in range(SERVE_T)], 1) for i in range(L)])
    return ids.sort(-1).values


def _routes_alike(torch, a, b):
    """-> (the share of (layer, request, token) routes `a` and `b` pick
    alike, (B,) whether each request's routes are all alike)."""
    same = (a == b).all(-1)
    return same.float().mean().item(), same.all(-1).all(0)


def _decode_check(torch, arch, cfg, params, toks, fp32_b, Smax):
    """SERVE_T teacher-forced tokens through `decode_step` from an empty
    `init_cache(B, Smax)`, the last logits and the caches decode wrote
    held against `logits_fn` over the same tokens: in fp32 (fp32 copies
    of the weights), the first fp32_b requests, at DECODE_FP32_TOL; in
    bf16, every request, at DECODE_BF16_K times the bf16 prefill's
    distance from the fp32 prefill. On a MoE model the share of (token,
    layer) routes the bf16 prefill and decode pick alike is printed.
    -> (rows held, the bf16 cache and last logits, the share or None)."""
    import dataclasses

    from repro_torch.core.treebytes import leaf_arrays, tree_unflatten
    from repro_torch.models import model as M
    dev = toks.device
    decode_b = toks.shape[0]
    # decode takes tokens alone, so a VLM's prefill here has no patches
    text = {"tokens": toks, **({"patches": torch.zeros(
        decode_b, 0, cfg.d_model, device=dev)} if cfg.num_patches else {})}
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    p32 = tree_unflatten(params, [t.float() for t in leaf_arrays(params)])
    (l32, c32), pre32 = _routes(lambda: M.logits_fn(cfg32, p32, text))
    tol32 = DECODE_FP32_TOL[cfg.family]
    cache = M.init_cache(cfg32, fp32_b, Smax, dev)
    for t in range(SERVE_T):
        lg, cache = M.decode_step(cfg32, p32, cache, toks[:fp32_b, t:t + 1])
    ent = cache["entries"]
    held = []
    for name, key, got, rows in _decode_leaves(lg, ent):
        want = (l32 if key is None else c32[key[0]][key[1]])[
            (slice(fp32_b),) if key is None else
            (slice(None), slice(fp32_b))]
        e = _rel(got, want, rows)
        ok = math.isfinite(e) and e <= tol32
        held.append({"leaf": name, "type": "float32", "rows": fp32_b,
                     "decode_vs_prefill": e, "bound": tol32, "held": ok})
        print(f"{arch} decode check fp32 {name} ({fp32_b} of {decode_b} "
              f"rows): ||decode - prefill|| / ||prefill|| {e:.3e} (bound "
              f"{tol32:g})")
    if int(cache["index"]) != SERVE_T:
        held.append({"leaf": "index", "held": False})
    # `got` views the fp32 cache: drop it too, or its last leaf stays
    del p32, cache, ent, lg, got, want
    torch.cuda.empty_cache()
    (l16, c16), pre = _routes(lambda: M.logits_fn(cfg, params, text))
    cache = M.init_cache(cfg, decode_b, Smax, dev)
    dec = []
    for t in range(SERVE_T):
        (lg, cache), seen = _routes(lambda: M.decode_step(
            cfg, params, cache, toks[:, t:t + 1]))
        dec += seen
    agree, keep = None, slice(None)
    if pre:
        # a MoE: a route that flips between two roundings of the same
        # bf16 values (experts k and k+1 nearly tied) moves that token's
        # output by a whole expert's share. Held as the other leaves are,
        # the routes' share alike against the bf16 prefill's own share
        # alike with the fp32 one; the values on the requests whose
        # routes all agree
        L = _moe_layers(cfg)
        p16 = _route_sets(torch, pre, decode_b, L)
        agree, keep = _routes_alike(torch, p16, _route_sets(
            torch, dec, decode_b, L))
        yard_agree, _ = _routes_alike(torch, p16, _route_sets(
            torch, pre32, decode_b, L))
        e, y = 1 - agree, 1 - yard_agree
        held.append({"leaf": "routes", "type": "bfloat16", "rows": decode_b,
                     "decode_vs_prefill": e, "bf16_vs_fp32": y,
                     "held": e <= DECODE_BF16_K * y})
        print(f"{arch} decode check bf16 routes: {agree:.6f} of the "
              f"{decode_b * SERVE_T * L} (layer, request, token) routes alike"
              f" in the prefill and the decode, {yard_agree:.6f} in the bf16 "
              f"and the fp32 prefills: {e / y if y else float(e > 0):.3f} of "
              f"the bf16 spread (bound {DECODE_BF16_K}); "
              f"{int(keep.sum())} of {decode_b} requests alike throughout")
    ent = cache["entries"]
    for name, key, got, rows in _decode_leaves(lg, ent):
        pre_t, yard = ((l16, l32) if key is None
                       else (c16[key[0]][key[1]], c32[key[0]][key[1]]))
        at = (keep,) if key is None else (slice(None), keep)
        got, pre_t, yard = got[at], pre_t[at], yard[at]
        e, y = _rel(got, pre_t, rows), _rel(pre_t, yard, rows)
        ok = math.isfinite(e) and e <= DECODE_BF16_K * y
        held.append({"leaf": name, "type": "bfloat16", "rows": decode_b,
                     "decode_vs_prefill": e, "bf16_vs_fp32": y, "held": ok})
        print(f"{arch} decode check bf16 {name}: ||decode - prefill|| / "
              f"||prefill|| {e:.3e}, bf16 prefill vs fp32 {y:.3e}: "
              + (f"{e / y:.3f}" if y else "-") + " of the bf16 spread "
              f"(bound {DECODE_BF16_K})")
    if not all(h["held"] for h in held) or int(cache["index"]) != SERVE_T:
        raise AssertionError(f"{arch}: decode departs from logits_fn: "
                             f"{held}, index {int(cache['index'])}")
    return held, cache, lg, agree


def _check_config(cfg, check_layers):
    """The decode check's own model: `check_layers` layers of `cfg`'s
    widths (CHECK_OVERRIDES' pattern), drop-free."""
    import dataclasses
    return dataclasses.replace(
        cfg, num_layers=check_layers, capacity_factor=float(cfg.num_experts),
        **CHECK_OVERRIDES.get(cfg.name, {}))


def _serve_run(torch, arch, prefill_b, decode_shape, decode_b, fp32_b,
               layers=None, check_layers=None):
    """One model at full width (and full depth unless `layers` cuts it),
    weights from a seed on the card: prefill (`logits_fn` over prefill_b
    prompts of prefill_32k's 32768 tokens, timed, its caches shaped as
    `init_cache`'s first 32768 slots), the decode check (`_decode_check`
    on the served weights, or, with `check_layers`, first, on a model of
    that many layers of the same widths, drop-free), then SERVE_TIMED
    greedy steps timed at the full Smax, beside the step's bound: the
    weights it reads (the embedding only in its looked-up rows when the
    head is untied), the cache read once, what it writes (one k/v slot a
    layer, or the whole SSM state), at the HBM rate. -> the run's
    numbers."""
    import dataclasses

    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.core.treebytes import leaf_arrays
    from repro_torch.models import model as M
    from repro_torch.models.attention import FLASH_THRESHOLD
    dev = torch.device("cuda")
    cfg = _path_config(arch, layers)
    V = cfg.vocab_size
    nbytes = lambda t: t.numel() * t.element_size()      # noqa: E731
    gc.collect()                 # an earlier run's tensors held in cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(dev).manual_seed(1)

    def tokens(b, s):
        return torch.randint(0, V, (b, s), generator=gen, device=dev,
                             dtype=torch.int32)

    Smax = INPUT_SHAPES[decode_shape].seq_len
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    weight_bytes = sum(nbytes(t) for t in leaf_arrays(params))

    def prompts(b, s, patches=cfg.num_patches):
        """s positions a row: a VLM's `patches` patch embeddings (seeded
        normals, as the data pipeline draws them), then tokens."""
        if cfg.family != "vlm":
            return {"tokens": tokens(b, s)}
        return {"patches": torch.randn(
            b, patches, cfg.d_model, generator=gen, device=dev).to(
                params["proj_in"].dtype), "tokens": tokens(b, s - patches)}

    # 1. prefill, after a warm-up at the flash threshold (the same kernels
    # and matmul routes, at 1/16 of the length)
    S = INPUT_SHAPES["prefill_32k"].seq_len
    M.logits_fn(cfg, params, prompts(1, FLASH_THRESHOLD))
    prompt = prompts(prefill_b, S)
    torch.cuda.synchronize()
    # the prefill's own peak (phase 9 holds the dry-run's prediction to
    # it): the live bytes other than its arguments (weights, prompt) are
    # taken off, and the run's peak so far is kept
    run_peak = torch.cuda.max_memory_allocated()
    other = torch.cuda.memory_allocated() - weight_bytes - sum(
        nbytes(t) for t in prompt.values())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = M.logits_fn(cfg, params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated() - other
    shapes = {(pos, n): (tuple(t.shape), t.dtype)
              for pos, ent in caches.items() for n, t in ent.items()}
    want = {(pos, n): (tuple(t.shape), t.dtype) for pos, ent in
            M.init_cache(cfg, prefill_b, S, "meta")["entries"].items()
            for n, t in ent.items()}
    prefill_cache = sum(nbytes(t) for ent in caches.values()
                        for t in ent.values())
    if shapes != want or tuple(logits.shape) != (prefill_b, 1, V) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} prefill: caches {shapes}, want "
                             f"{want}; logits {tuple(logits.shape)}")
    del logits, caches, prompt
    torch.cuda.empty_cache()

    # 2. the decode check on the served weights (with `check_layers`, on a
    # model of its own once the served one is gone: step 5)
    agree = None
    if check_layers:
        cache = M.init_cache(cfg, decode_b, Smax, dev)
        cache["index"] = torch.full((), SERVE_T, dtype=torch.int32,
                                    device=dev)
        tok = tokens(decode_b, 1)
    else:
        held, cache, lg, _ = _decode_check(
            torch, arch, cfg, params, tokens(decode_b, SERVE_T), fp32_b,
            Smax)
        tok = lg.argmax(-1).to(torch.int32)
    entries = cache["entries"]

    # 3. decode steps at the full Smax (each scores every slot)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_TIMED):
        lg, cache = M.decode_step(cfg, params, cache, tok)
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / SERVE_TIMED * 1e3
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"{arch}: decode logits are not finite")
    peak = max(run_peak, torch.cuda.max_memory_allocated())
    dev_ms, top = _device_profile(
        torch, lambda: M.decode_step(cfg, params, cache, tok))
    print(f"{arch} decode step on the device: "
          + ("not measured (no device time traced)" if dev_ms is None else
             f"{dev_ms:.3f} ms of kernels ({dev_ms / step_ms:.3f} of the "
             f"step's wall); largest: "
             + "; ".join(f"{k} {t:.3f} ms" for k, t in top)))

    # 4. the step's bound: what it writes, by position: one k/v slot a
    # layer, or the whole SSM state
    cache_bytes = sum(nbytes(t) for ent in entries.values()
                      for t in ent.values())
    el = params["embed"].element_size()
    read = weight_bytes + cache_bytes
    if "lm_head" in params:          # the table itself only in B rows
        read -= nbytes(params["embed"]) - decode_b * cfg.d_model * el
    written = decode_b * V * el + sum(
        sum(nbytes(t) for t in ent.values()) if "h" in ent else
        2 * ent["k"].shape[0] * decode_b * cfg.num_kv_heads * cfg.head_dim
        * el for ent in entries.values())
    bound_ms = (read + written) / HBM_BYTES_PER_S * 1e3
    run = {"arch": arch, "layers": cfg.num_layers,
           "check_layers": check_layers or cfg.num_layers,
           "weight_bytes": weight_bytes, "prefill_batch": prefill_b,
           "prefill_seq": S, "prefill_cache_bytes": prefill_cache,
           "prefill_s": prefill_s,
           "prefill_tokens_per_s": prefill_b * S / prefill_s,
           "prefill_peak_bytes": prefill_peak,
           "prefill_other_bytes": other,
           "decode_shape": decode_shape, "decode_batch": decode_b,
           "decode_smax": Smax, "decode_cache_bytes": cache_bytes,
           "decode_ms": step_ms,
           "decode_tokens_per_s": decode_b * 1e3 / step_ms,
           "decode_bound_ms": bound_ms,
           "decode_bound_bytes": read + written, "peak_bytes": peak,
           "decode_device_ms": dev_ms,
           "decode_top_kernels": [[k, t] for k, t in top],
           "decode_check": None, "decode_routes_alike": None}
    print(f"{arch} serving ({cfg.num_layers} layers, weights {weight_bytes}"
          f" B): prefill {prefill_b}x{S} {prefill_s:.3f} s, "
          f"{run['prefill_tokens_per_s']:.1f} tokens/s (caches "
          f"{prefill_cache} B); decode {decode_shape} B={decode_b} "
          f"Smax={Smax} (cache {cache_bytes} B): {step_ms:.3f} ms a step, "
          f"{run['decode_tokens_per_s']:.1f} tokens/s, bound "
          f"{bound_ms:.3f} ms ({read + written} B at 3.35 TB/s), "
          f"{step_ms / bound_ms:.2f}x bound; peak device memory "
          f"{peak / 1e9:.3f} GB")
    del params, cache, entries, lg, tok
    torch.cuda.empty_cache()

    # 5. a cut model's decode check: its own model of check_layers layers
    # of the same widths, drop-free
    if check_layers:
        ccfg = _check_config(cfg, check_layers)
        cparams = M.init_params(ccfg, torch.Generator(dev).manual_seed(0),
                                dev)
        held, cache, lg, agree = _decode_check(
            torch, arch, ccfg, cparams, tokens(decode_b, SERVE_T), fp32_b,
            Smax)
        del cparams, cache, lg
        torch.cuda.empty_cache()
    run.update(decode_check=held, decode_routes_alike=agree)
    return run


def _subprocess(cmd, check_out=None):
    """Run one of the port's entry points from the checkout; fail on a
    non-zero exit (or without `check_out` in its stderr)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
        os.path.join(HERE, "src"), os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", *cmd], cwd=HERE, env=env,
                       capture_output=True, text=True, timeout=600)
    print(f"$ python -m {' '.join(cmd)}: rc {r.returncode}, "
          f"{time.perf_counter() - t0:.1f} s")
    for line in (r.stdout + r.stderr).strip().splitlines()[-6:]:
        print(f"  {line}")
    if r.returncode != 0 or (check_out and check_out not in r.stderr):
        raise AssertionError(f"python -m {' '.join(cmd)} failed")


def serving_path(torch):
    """Phase 8: SERVE_RUNS (counts set to 0 before, read after: every
    layer's prefill launches swa_flash or ssd_scan, the decode none and no
    backward), then the serving example on the card and the strict
    analyzer over the port, as subprocesses. -> (launches, runs)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    runs = [_serve_run(torch, *r) for r in SERVE_RUNS]
    launches = launch_counts()
    # per layer: the warm-up and the prefill (swa_flash: S >= the flash
    # threshold; ssd_scan: every length), and per SSM layer of the decode
    # check's model ssd_scan in its fp32 and bf16 prefills of SERVE_T
    # tokens (its attention below the threshold: none)
    from repro_torch.configs.base import SSM
    want = dict.fromkeys(launches, 0)
    for arch, *_, layers, check_layers in SERVE_RUNS:
        cfg = _path_config(arch, layers)
        ccfg = _check_config(cfg, check_layers) if check_layers else cfg
        ssm = sum(cfg.layer_kind(i) == SSM for i in range(cfg.num_layers))
        want["ssd_scan"] += 2 * ssm + 2 * sum(
            ccfg.layer_kind(i) == SSM for i in range(ccfg.num_layers))
        want["swa_flash"] += 2 * (cfg.num_layers - ssm)
    print(f"{SERVING} launches: {json.dumps(launches)}")
    if launches != want:
        raise AssertionError(f"{SERVING}: launches {launches}, want {want}")
    _subprocess(["repro_torch.examples.serve", "--device", "cuda"])
    _subprocess(["repro_torch.analyze", "--strict", "src/repro_torch"],
                check_out="analyze: 0 findings")
    return launches, runs


def _prefill_seq():
    from repro_torch.configs.base import INPUT_SHAPES
    return INPUT_SHAPES["prefill_32k"].seq_len


def start_dry_runs():
    """9(a) and (b)'s dry-runs in one process of their own (its fake
    process group never meets phase 9(c)'s real one), started before
    phase 8: it traces on the CPU while the card serves, and phase 8's
    prefill calls it predicts are SERVE_RUNS' own. -> (process, start)."""
    prefills = [[arch, rows, _prefill_seq(), layers]
                for arch, rows, _, _, _, layers, _ in SERVE_RUNS]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
        os.path.join(HERE, "src"), os.environ.get("PYTHONPATH")])))
    return subprocess.Popen(
        [sys.executable, "-c", DRY_RUN, json.dumps(DRY_PAIRS),
         json.dumps(prefills)], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), time.perf_counter()


def _dry_runs(started, serving):
    """Waits for `start_dry_runs`' process; prints each pair's line. ->
    {"production": [record], "prefill": [record]}, the prefill records
    in phase 8's order."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print(f"dry-run process: rc {proc.returncode}, "
          f"{time.perf_counter() - t0:.1f} s since its start (beside "
          f"phase 8)")
    for line in out.splitlines():
        if line.startswith("[ok]"):
            print(f"  {line}")
    got = [l for l in out.splitlines() if l.startswith("DRYRUN_JSON ")]
    if proc.returncode != 0 or not got:
        raise AssertionError(f"dry-run failed:\n{err[-3000:]}")
    dry = json.loads(got[0].split(" ", 1)[1])
    if [(r["arch"], r["prefill_batch"], r["prefill_seq"]) for r in serving] \
            != [(a, b, _prefill_seq()) for a, b, *_ in SERVE_RUNS]:
        raise AssertionError("phase 8 served other prefills than the "
                             "dry-run traced")
    return dry


def _dry_run_checks(dry, serving):
    """9(a): every production pair a record with FLOPs and argument
    bytes; (b) each prefill's predicted peak within PEAK_RATIO of phase
    8's measured one, the roofline time printed beside the measured
    seconds (no bound). -> [9(b) rows]."""
    for rec in dry["production"]:
        mem = rec["memory"]
        if not (rec["hlo_flops_per_chip"] > 0 and mem["argument_bytes"] > 0
                and mem["peak_bytes"] >= mem["argument_bytes"]):
            raise AssertionError(f"dry-run {rec['arch']} x {rec['shape']}: "
                                 f"{rec}")
    rows = []
    for run, rec in zip(serving, dry["prefill"]):
        pred = rec["memory"]["peak_bytes"]
        meas = run["prefill_peak_bytes"]
        roof = max(rec["t_compute_s"], rec["t_memory_s"])
        row = {"arch": run["arch"], "rows": run["prefill_batch"],
               "seq": run["prefill_seq"], "predicted_peak_bytes": pred,
               "measured_peak_bytes": meas, "ratio": pred / meas,
               "other_live_bytes": run["prefill_other_bytes"],
               "roofline_s": roof, "t_compute_s": rec["t_compute_s"],
               "t_memory_s": rec["t_memory_s"],
               "measured_s": run["prefill_s"]}
        rows.append(row)
        print(f"{run['arch']} prefill {run['prefill_batch']}x"
              f"{run['prefill_seq']}: peak predicted {pred} B, measured "
              f"{meas} B (torch.cuda.max_memory_allocated less "
              f"{run['prefill_other_bytes']} B live before it), ratio "
              f"{pred / meas:.4f}; roofline {roof:.4f} s (compute "
              f"{rec['t_compute_s']:.4f}, memory {rec['t_memory_s']:.4f}) "
              f"beside {run['prefill_s']:.4f} s measured")
        lo, hi = PEAK_RATIO
        if not lo <= pred / meas <= hi:
            raise AssertionError(f"{run['arch']}: predicted peak {pred} B "
                                 f"is {pred / meas:.3f}x the measured "
                                 f"{meas} B, outside {PEAK_RATIO}")
    return rows


def _dtensor_run(torch, mesh, arch, seq, batch, layers):
    """One forward and backward with the params (and batch) as DTensors on
    `mesh`, against the same with plain tensors: the loss and every
    gradient bit for bit. -> the DTensor run's launch counts."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import InputShape
    from repro_torch.core.treebytes import leaf_arrays, tree_unflatten
    from repro_torch.data.pipeline import make_batch
    from repro_torch.dist import shardings as SH
    from repro_torch.dist.api import use_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    cfg = _path_config(arch, layers)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    batch_t = make_batch(cfg, InputShape("dtensor", seq, batch, "train"),
                         seed=0, device=dev)

    def grads_of(p, b):
        leaves = [t.detach().requires_grad_(True) for t in leaf_arrays(p)]
        loss, _ = M.forward(cfg, tree_unflatten(p, leaves), b)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    # deterministic kernels for both runs (the embedding's gradient
    # accumulates its rows in a fixed order; warn_only: cuBLAS warns)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss, grads = grads_of(params, batch_t)
        p_dt = SH.distribute(params, SH.named(SH.param_specs(cfg, params),
                                              params, mesh))
        b_dt = SH.distribute(batch_t, SH.named(
            SH.batch_specs(cfg, batch_t), batch_t, mesh))
        reset_launch_counts()
        with use_mesh(mesh), implicit_replication():
            loss_d, grads_d = grads_of(p_dt, b_dt)
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        torch.use_deterministic_algorithms(False)
    same = torch.equal(loss_d.to_local(), loss)
    diff = [i for i, (g, w) in enumerate(zip(grads_d, grads))
            if not torch.equal(g.to_local(), w)]
    print(f"{arch} ({'full depth' if layers is None else f'{layers} layers'}"
          f", {batch}x{seq}) on a DTensor (1, 1) mesh: loss {float(loss)!r}"
          f" {'==' if same else '!='} {float(loss_d.to_local())!r}; "
          f"{len(grads) - len(diff)} of {len(grads)} gradients bit-equal; "
          f"launches {json.dumps(launches)}")
    if not same or diff:
        raise AssertionError(f"{arch}: the DTensor run departs from the "
                             f"plain one (loss equal: {same}; gradients "
                             f"{diff} differ)")
    del params, grads, p_dt, grads_d
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _plain_kernels():
    """Within the block the model's layers call the plain versions of the
    attention and SSD cores (`swa_flash_plain`, `ssd_scan_plain`) where
    they call the kernels' entry points: a plain forward on the card for
    the kernels to be held against."""
    MA = importlib.import_module("repro_torch.models.attention")
    MS = importlib.import_module("repro_torch.models.ssm")
    KA = importlib.import_module("repro_torch.kernels.swa_attention")
    KS = importlib.import_module("repro_torch.kernels.ssd_scan")
    saved = MA.swa_flash, MS.ssd_scan
    MA.swa_flash = lambda q, k, v, *, window, causal=True: \
        KA.swa_flash_plain(q, k, v, window=KA._window(window), causal=causal)
    MS.ssd_scan = lambda u, a, Bm, Cm, h0=None, *, chunk: \
        KS.ssd_scan_plain(u, a, Bm, Cm, h0, chunk=chunk)
    try:
        yield
    finally:
        MA.swa_flash, MS.ssd_scan = saved


def hybrid_train_check(torch):
    """Phase 9(e), one path (counts set to 0 before it, read after it):
    HYBRID_TRAIN, one period of Jamba at full width (8 layers: 7 SSM
    layers, attention at position 4, the MoE at 1, 3, 5, 7), bf16 weights
    from a seed, one forward and backward with the kernels and no
    optimizer: ssd_scan, ssd_scan_bwd, swa_flash and swa_flash_bwd
    launched, every gradient leaf finite with a nonzero norm; the loss
    held against the same forward through the plain versions
    (`_plain_kernels`) within HYBRID_LOSS_TOL of it; the peak printed.
    -> (launches, record)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.treebytes import (leaf_arrays, tree_flatten_with_path,
                                            tree_unflatten)
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    arch, seq, batch, layers = HYBRID_TRAIN
    dev = torch.device("cuda")
    cfg = _path_config(arch, layers)
    gc.collect()
    torch.cuda.empty_cache()
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in leaf_arrays(params))
    b = make_batch(cfg, InputShape("hybrid", seq, batch, "train"), seed=0,
                   device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    leaves = [t.requires_grad_(True) for t in leaf_arrays(params)]
    loss, out = M.forward(cfg, tree_unflatten(params, leaves), b)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                         for g in grads]).tolist()
    paths = [p for p, _ in tree_flatten_with_path(params)]
    bad = [p for p, n in zip(paths, norms) if not (math.isfinite(n) and n > 0)]
    del grads, leaves
    for t in leaf_arrays(params):
        t.requires_grad_(False)
    torch.cuda.empty_cache()
    with torch.no_grad(), _plain_kernels():
        plain_loss, plain_out = M.forward(cfg, params, b)
    torch.cuda.synchronize()
    d = abs(loss.item() - plain_loss.item())
    bound = HYBRID_LOSS_TOL * abs(plain_loss.item())
    rec = {"arch": arch, "layers": cfg.num_layers, "seq": seq,
           "batch": batch, "params": n_params, "loss": loss.item(),
           "aux": out["aux"].item(), "plain_loss": plain_loss.item(),
           "plain_aux": plain_out["aux"].item(), "loss_diff": d,
           "loss_bound": bound, "fwd_bwd_s": seconds, "peak_bytes": peak,
           "grad_leaves": len(norms), "grad_leaves_bad": bad,
           "launches": launches}
    print(f"{HYBRID_TRAIN_PATH}: {arch}, {cfg.num_layers} layers at full "
          f"width ({n_params} params, bf16), {batch}x{seq}: loss "
          f"{loss.item()!r} (aux {out['aux'].item():.6f}), plain versions "
          f"{plain_loss.item()!r} (aux {plain_out['aux'].item():.6f}); "
          f"|diff| {d:.3e}, bound {bound:.3e} ({HYBRID_LOSS_TOL:g} of the "
          f"loss): {d / bound:.3f} of it; {len(norms) - len(bad)} of "
          f"{len(norms)} gradient leaves finite with a nonzero norm; "
          f"forward and backward {seconds:.3f} s; peak device memory "
          f"{peak / 1e9:.3f} GB; launches {json.dumps(launches)}")
    del params, b, loss, out, plain_loss, plain_out
    torch.cuda.empty_cache()
    for name in ("ssd_scan", "ssd_scan_bwd", "swa_flash", "swa_flash_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the "
                                 f"{HYBRID_TRAIN_PATH}")
    if bad or not d <= bound:
        raise AssertionError(f"{HYBRID_TRAIN_PATH}: {rec}")
    return launches, rec


def probe_allowance(need, total_bytes: int, n: int) -> int:
    """Bytes the loader's CRC probe reads for a partial plan over `need`
    (global ranges of the flat stream) on an SG of `n` whose snapshots
    carry per-stripe digests: one segment per RAIM5 block, each block
    holding a needed byte verified whole (`loader.probe_crc`), so
    block_size bytes for every data block the ranges touch (the stream's
    k-th block is one member's local block)."""
    from repro_torch.core import raim5
    bs = raim5.block_size(total_bytes, n)
    blocks = set()
    for a, b in need:
        blocks.update(range(a // bs, (b - 1) // bs + 1))
    return bs * len(blocks)


def _schedule_allowance(ld, total_bytes: int, n: int) -> int:
    """Bytes the adaptive read scheduler may read beyond a plan, from its
    own counters (`LoadStats`): for each byte rerouted through parity,
    the parity and the other n - 2 data blocks' bytes it decodes from,
    each parity region verified once when any is (at most n); each
    hedged read, one chunk read twice (a chunk packs pieces of at most
    chunk_bytes until it holds chunk_bytes, so under twice that)."""
    from repro_torch.core import raim5
    from repro_torch.core.readsched import SchedConfig
    rerouted = ld.parity_rerouted_bytes
    return (n - 2) * rerouted \
        + (n * raim5.block_size(total_bytes, n) if rerouted else 0) \
        + ld.hedged_reads * 2 * SchedConfig().chunk_bytes


def _reshard_run(torch, device="cuda", cfg=None):
    """9(d): RESHARD_ARCH's full-width state snapshotted by an SG of SG
    members, restored for each coordinate of a RESHARD_MESH mesh through
    `RestoreTarget(shardings=state_specs(...), mesh, coord)`: every byte
    of the coordinate's ranges equal to the saved byte, the plan's cover
    equal to those ranges (whole leaves where a leaf falls back), and the
    bytes read no more than those ranges plus the CRC probe's blocks
    (`probe_allowance`) plus the read scheduler's extra reads
    (`_schedule_allowance`); then one full restore, byte-exact, reading
    no more than the members' own regions plus that allowance, which
    each coordinate's bytes read are reported against. -> (rows a
    coordinate, the full restore's row)."""
    import types

    import numpy as np

    from repro_torch.api import CheckpointSpec, RestoreTarget
    from repro_torch.api.registry import create_checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core import loader
    from repro_torch.core import raim5
    from repro_torch.core.treebytes import (host_bytes, leaf_arrays,
                                            make_flat_spec)
    from repro_torch.dist import shardings as SH
    from repro_torch.train.steps import init_train_state
    cfg = cfg or get_config(RESHARD_ARCH)
    state = init_train_state(cfg, 0, device=device)
    fs = make_flat_spec(state)
    saved = np.concatenate([host_bytes(x) for x in leaf_arrays(state)])
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 axis_sizes=RESHARD_MESH)
    shardings = SH.state_specs(cfg, state)
    rows = []
    with tempfile.TemporaryDirectory(prefix="reshard-") as ckdir:
        spec = CheckpointSpec(backend="reft", ckpt_dir=ckdir, sg_size=SG)
        with create_checkpointer(spec, state) as ck:
            if not ck.snapshot(state, 1, wait=True):
                raise AssertionError("reshard: the snapshot was not taken")
            for d in range(RESHARD_MESH[0]):
                for m in range(RESHARD_MESH[1]):
                    coord = {"data": d, "model": m}
                    need = loader.normalize_ranges(loader.need_for_sharding(
                        fs, shardings, mesh, coord), fs.total_bytes)
                    t0 = time.perf_counter()
                    res = ck.restore(target=RestoreTarget(
                        shardings=shardings, mesh=mesh, coord=coord))
                    secs = time.perf_counter() - t0
                    got = np.concatenate([host_bytes(x) for x in
                                          leaf_arrays(res.state)])
                    bad = [(a, b) for a, b in need
                           if not np.array_equal(got[a:b], saved[a:b])]
                    n_need = sum(b - a for a, b in need)
                    ld = res.load
                    probe = probe_allowance(need, fs.total_bytes, SG) \
                        + _schedule_allowance(ld, fs.total_bytes, SG)
                    row = {"coord": coord, "tier": res.tier,
                           "ranges": len(need), "bytes_needed": n_need,
                           "plan_bytes": ld.bytes_needed,
                           "probe_allowance": probe,
                           "bytes_read": ld.bytes_read,
                           "decoded_bytes": ld.decoded_bytes,
                           "parity_rerouted_bytes":
                               ld.parity_rerouted_bytes,
                           "state_bytes": fs.total_bytes, "seconds": secs}
                    rows.append(row)
                    print(f"reshard {coord}: tier {res.tier}, {len(need)} "
                          f"ranges, {n_need} B of the state's "
                          f"{fs.total_bytes} B, read {ld.bytes_read} B "
                          f"of at most {n_need + probe} (plan "
                          f"{ld.bytes_needed} B + probe, reroutes and hedges "
                          f"{probe} B; decoded "
                          f"{ld.decoded_bytes} B, rerouted through parity "
                          f"{ld.parity_rerouted_bytes} B), {secs:.3f} s; "
                          f"byte-exact: {not bad}")
                    if bad or ld.bytes_needed != n_need \
                            or ld.bytes_read > n_need + probe:
                        raise AssertionError(
                            f"reshard {coord}: {len(bad)} ranges differ; "
                            f"plan {ld.bytes_needed} B, need {n_need} B; "
                            f"read {ld.bytes_read} B, bound "
                            f"{n_need + probe} B")
            t0 = time.perf_counter()
            res = ck.restore()
            secs = time.perf_counter() - t0
            got = np.concatenate([host_bytes(x) for x in
                                  leaf_arrays(res.state)])
            # each member's own region once (its CRC folded into the read)
            own = SG * (SG - 1) * raim5.block_size(fs.total_bytes, SG)
            full = {"tier": res.tier, "bytes_read": res.load.bytes_read,
                    "own_regions": own, "bound": own + _schedule_allowance(
                        res.load, fs.total_bytes, SG),
                    "state_bytes": fs.total_bytes, "seconds": secs}
            print(f"reshard full restore: tier {res.tier}, read "
                  f"{res.load.bytes_read} B of at most {full['bound']} "
                  f"(the own regions {own} B), {secs:.3f} s; byte-exact: "
                  f"{np.array_equal(got, saved)}; each coordinate read "
                  + ", ".join(f"{r['bytes_read'] / res.load.bytes_read:.4f}"
                              for r in rows) + " of it")
            if not np.array_equal(got, saved) \
                    or res.load.bytes_read > full["bound"]:
                raise AssertionError(
                    f"reshard: the full restore differs or read "
                    f"{res.load.bytes_read} B, bound {full['bound']} B")
    return rows, full


def dist_path(torch, serving, dry_started):
    """Phase 9: (a) + (b) the dry-runs, (c) the DTensor runs (counts set
    to 0 before each DTensor run, summed: swa_flash and its backward
    launch through their custom ops' sharding rules), (d) the reshard
    restores. -> (launches, record)."""
    import socket

    import torch.distributed as dist
    dry = _dry_runs(dry_started, serving)
    prefill = _dry_run_checks(dry, serving)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        launches = None
        for run in DTENSOR_RUNS:
            got = _dtensor_run(torch, mesh, *run)
            launches = got if launches is None else \
                {k: launches[k] + got[k] for k in got}
    finally:
        dist.destroy_process_group()
    # at S >= the flash threshold (starcoder2-3b's, dbrx-132b's runs) each
    # layer launches the forward (twice under remat: the backward runs it
    # again) and the backward once; opt-125m none
    from repro_torch.models.attention import FLASH_THRESHOLD
    want = {"swa_flash": 0, "swa_flash_bwd": 0}
    for arch, seq, _, layers in DTENSOR_RUNS:
        cfg = _path_config(arch, layers)
        if seq >= FLASH_THRESHOLD:
            want["swa_flash"] += cfg.num_layers * (2 if cfg.remat else 1)
            want["swa_flash_bwd"] += cfg.num_layers
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{DIST}: launches {launches}, want {want}")
    reshard, reshard_full = _reshard_run(torch)
    return launches, {"dry_run": dry["production"], "prefill_peak": prefill,
                      "reshard": reshard, "reshard_full": reshard_full}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    phase("1 device facts")
    smi, _ = device_facts(torch)
    phase("2 kernel build")
    build_kernels()
    phase("3 kernels against their plain versions")
    fused = fused_setup(torch)
    rows, frows, max_err = check_encode_bucket(torch, fused)
    del fused
    torch.cuda.empty_cache()
    ssd = check_ssd(torch)
    swa = check_swa(torch)
    xor = check_xor(torch)
    phase("4 main paths at full width")
    by_path, medians = {}, {}
    for arch, seq, batch, layers, must in PATHS:
        by_path[arch], medians[arch] = main_path(torch, arch, seq, batch,
                                                 layers, must)
    gc.collect()
    torch.cuda.empty_cache()
    phase("5 durable tiers at full width")
    by_path[DURABLE] = durable_path(torch, medians[DURABLE_ARCH])
    phase("6 supervised drill at full width")
    by_path[DRILL] = drill_path(torch)
    torch.cuda.empty_cache()
    phase("7 delta flights and pipeline stages at full width")
    by_path[DELTA], delta_fold_crc = delta_path(torch)
    torch.cuda.empty_cache()
    for path, args, must in MOE_RUNS:
        by_path[path] = moe_delta_path(torch, path, args, must)
        torch.cuda.empty_cache()
    by_path[STAGES] = stage_path(torch)
    torch.cuda.empty_cache()
    phase("8 serving at full width")
    dry_started = start_dry_runs()
    try:
        by_path[SERVING], serving = serving_path(torch)
        torch.cuda.empty_cache()
        phase("9 distribution and the dry-run")
        by_path[DIST], dist_rec = dist_path(torch, serving, dry_started)
        by_path[HYBRID_TRAIN_PATH], dist_rec["hybrid_train"] = \
            hybrid_train_check(torch)
    finally:
        if dry_started[0].poll() is None:
            dry_started[0].kill()
            dry_started[0].wait()
    phase("10 summary")
    own = frows[0]    # the path's instance: the fused own bucket
    ssd_src = "src/repro_torch/kernels/csrc/ssd_scan.cu"
    # bf16 (the path's type): tensor-core kernels; fp32: CUDA-core ones
    swa_src = "src/repro_torch/kernels/csrc/swa_flash_bf16.cu"
    swa_fp32 = "src/repro_torch/kernels/csrc/swa_flash.cu"
    kernels = [{"name": "encode_bucket", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/encode_bucket.cu",
                "replaces": "src/repro/kernels/stage.py:159",
                "max_abs_err": max_err, "ms": own["ms"],
                "plain_ms": own["plain_ms"], "bound_ms": own["bound_ms"],
                "bound_by": "bytes", "cases": rows, "fused_cases": frows,
                "kind2_crc_launches_by_path": {DELTA: delta_fold_crc}},
               {"name": "ssd_scan", "route": "cuda", "source": ssd_src,
                "replaces": "src/repro/kernels/ssd_scan.py:60",
                **ssd["ssd_scan"]},
               {"name": "ssd_scan_bwd", "route": "cuda", "source": ssd_src,
                "replaces": "src/repro/models/ssm.py:70 (the gradient XLA "
                            "derives from ssd_chunked; no Pallas kernel)",
                **ssd["ssd_scan_bwd"]},
               {"name": "swa_flash", "route": "cuda", "source": swa_src,
                "fp32_source": swa_fp32,
                "replaces": "src/repro/kernels/swa_attention.py:81",
                **swa["swa_flash"], "serving_cases": swa["serving_cases"]},
               {"name": "swa_flash_bwd", "route": "cuda", "source": swa_src,
                "fp32_source": swa_fp32,
                "replaces": "src/repro/models/flash.py:28 (the gradient "
                            "XLA derives from flash_attention; no Pallas "
                            "kernel)",
                **swa["swa_flash_bwd"]},
               {"name": "xor_reduce", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/xor_parity.cu",
                "replaces": "src/repro/kernels/xor_parity.py:36",
                "max_abs_err": max(r["max_abs_err"] for r in xor),
                "ms": xor[0]["ms"], "plain_ms": xor[0]["plain_ms"],
                "bound_ms": xor[0]["bound_ms"], "bound_by": "bytes",
                "cases": xor}]
    for k in kernels:
        k["launches_by_path"] = {arch: n[k["name"]]
                                 for arch, n in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        # no single PyTorch call computes encode_bucket, the SSD scan or
        # an XOR reduction along an axis
        k.setdefault("library_ms", None)
        k["ok"] = True
    print(json.dumps({"serving": serving}))
    print(json.dumps({"distribution": dist_rec}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


STEP_TIME_RUN = ("import json, sys\n"
                 "from repro_torch.launch import train\n"
                 "r = train.run(sys.argv[1:])\n"
                 "print('STEP_SECONDS ' + json.dumps(r['step_seconds']))\n")


def _step_seconds(root, arch, seq, batch, layers, steps):
    """One phase-4 path's step seconds under the trainer of the checkout
    at `root`, with no checkpointing (`--backend null`), in a new
    process on the card."""
    cut = [] if layers is None else ["--layers", str(layers)]
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    with tempfile.TemporaryDirectory(prefix="step-time-") as ckpt:
        r = subprocess.run(
            [sys.executable, "-c", STEP_TIME_RUN, "--arch", arch, "--seq",
             str(seq), "--batch", str(batch), *cut, "--steps", str(steps),
             "--backend", "null", "--device", "cuda", "--ckpt-dir", ckpt],
            cwd=root, env=env, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise SystemExit(f"{root} {arch}: rc {r.returncode}\n"
                         f"{r.stderr[-3000:]}")
    line = next(x for x in r.stdout.splitlines()
                if x.startswith("STEP_SECONDS "))
    return json.loads(line.split(" ", 1)[1])


def step_time(roots, steps=12):
    """`python3 chip_smoke.py --step-time ROOT [ROOT ...]`: the training
    step with no snapshot flight, to tell a change in the model code
    from the flights' interference. For each checkout ROOT in the order
    given (parent, change, change, parent shows drift on the card), each
    PATHS entry through that checkout's trainer (`_step_seconds`); prints
    the step seconds and their median past the first (the warm-up), then
    a JSON line of the medians and the card's name and power limit."""
    medians = []
    for root in roots:
        row = {}
        for arch, seq, batch, layers, _ in PATHS:
            s = _step_seconds(os.path.abspath(root), arch, seq, batch,
                              layers, steps)
            row[arch] = statistics.median(s[1:])
            print(f"{root} {arch} ({batch}x{seq}, "
                  f"{'full depth' if layers is None else f'{layers} layers'}"
                  f"): median step past the first {row[arch]:.4f} s; "
                  + json.dumps([round(x, 4) for x in s]), flush=True)
        medians.append({"root": root, "median_step_s": row})
    print(json.dumps({"train_step_medians": medians}))
    print(smi_line())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--step-time"]:
        sys.exit(step_time(sys.argv[2:]))
    sys.exit(main())
