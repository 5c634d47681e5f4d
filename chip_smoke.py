#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, then:

  0. expf, as the annealers' libraries compile it, over every float
     z <= 0: it must never decrease (their acceptance thresholds,
     csrc/anneal_step.cuh, are exact iff so).
  1. K1 (csrc/sa_sweep.cu) against its plain PyTorch version on dyadic
     fixtures at the BBO pool's shape, at the paper's BBO loop (phase 6: 25
     and 4 runs x 10 reads x 64 sweeps) and at the budget allocator's QUBO
     shape (6 problems x 8 reads x 96 sweeps) at n = 121, 237 (the
     shared-memory body's limit at 8 chains), 238, 512 and 1,024 (the
     global-memory body, each chain split over a block's warps, the launch's
     body counted): spins and energies must be bit-identical.  Timed at the
     first three shapes and the allocator's at n = 237, 512 and 1,024
     beside its bytes, operations and chain bounds (the longest dependent
     path at 4 cycles a step) and its threshold pass alone.
  2. The main path at full width: ``compress_model`` on qwen3-32b's
     published widths with depth cut to one layer, a policy that refines
     ``attn/w[kv]`` with BBO (tn=8, K=3: n=24 spins, 10,240 tiles in one
     lock-step batch) and compresses every other weight with alternating;
     the checkpoint and manifest are saved and restored.  K1's launches
     must equal bbo_iters x chunks, and no BBO tile may end worse than its
     alternating start.
  3. Serving: with the fused hook enabled, ``apply_compressed`` on every
     compressed tensor at T = 1, 16, 512 bf16 tokens and at phase 4's
     shapes (T = 4 for decode and the last-position head, T = 4096 for the
     prefill of every other weight); each output is held against
     x @ decompress(w), and K3 (csrc/bitlinear.cu) must have been launched
     once per call.  Then K3, at the schedule each call resolved (the
     default rule), is held against its plain version on the same inputs
     and timed beside its bound and a dense bf16 matmul.
  K3's variants: every schedule (grid at three (block_t, r_chunk), decode
     where its block fits shared memory, stream at r_chunk 1, 2, 4, 8) x bit
     algebra (unpack, bitplane) x activations (f32, bf16, int8) x C (f32,
     bf16) against the plain version on phase 3's tensors at T = 1, 16,
     512, 4, 4096, the BBO tensors (tn = 8, K = 3) and a ragged T = 37:
     int8 equal (on a dyadic C grid where every f32 sum is exact), f32
     within 1e-4 + 1e-4 |y|, bf16 within 2e-2 of max |y|.  Each schedule x
     bit algebra timed in bf16 over phase 4's distinct calls, and over
     phase 4's tensors at T = 1 ... 64 (the default rule's small-T cutoff);
     each also as device time alone (``device_ms``: the card kept busy while
     the host enqueues the call); each timed decode call's cluster size S
     and GB/s are printed (``decode_calls``).  Stream is timed apart at
     r_chunk 1, 2, 4, 8 on qwen's eight T = 4 calls and granite-moe's four
     K3 tensors (``stream_calls``: each call's S, the parts that went
     through a tensor map, as the library reports them and as
     ``bitlinear.stream_tensor_maps`` predicts, ``ms``, ``device_ms``,
     GB/s).
  K5 (csrc/flash_attention.cu) against its plain version at the prefill
     shapes of phases 4, 5 and 7 and on a sliding-window fixture, each in
     f32 and bf16; in bf16 also against f32 scores within K5's rounding
     bound.  Timed at the three bf16 prefill shapes beside its bound, the
     plain version and ``scaled_dot_product_attention``.
  4. Generation: ``serve_model`` restores phase 2's checkpoint through its
     manifest and generates 32 tokens for 4 prompts of 1024 tokens; K5
     must have been launched once (one layer, one prefill) and K3 once per
     compressed tensor per forward (prefill + 31 decode steps), per
     schedule as its resolutions (the default rule) picked, each decode
     launch at the cluster size the rule gives its shape.  Time to first
     token is the median of the serve's prefill and two more of the same
     prompts (all three and their spread are printed).  The prefill's
     logits are held against the plain path (kernels disabled), and the
     plain path's greedy tokens are compared (reported).
  4b. Tuned serving, this slice's main path: ``tune_artifact`` on phase 2's
     artifact at T = 4 and 4096 (each signature's winner and trials are
     printed), the table saved into the manifest, then phase 4's serve
     again from that checkpoint: the Engine installs the table, every
     resolution must come from it, K3's launches per schedule must be what
     it picked (the tuner's trial launches are counted apart), and the
     prefill logits must agree with the plain path.
  4c. Continuous batching with chunked prefill (serving/scheduler.py over a
     paged KV pool): 4 of phase 4's 1024-token prompts through a Scheduler
     of 4 slots and 16-token pages at ``prefill_chunk`` 16 (64 chunks each),
     32 new tokens.  K5 must launch once per request (its first chunk; later
     chunks attend to the cache through the plain path), K3 once per
     compressed tensor a forward; each request's first-token logits within
     5e-2 of max|logit| of the one-shot prefill through K5; the pool empty
     at the end; tokens against a batch-1 ``Engine.generate`` reported.
  K4 (the grouped form in csrc/bitlinear.cu) against its plain version at
     granite-moe-1b-a400m's three expert shapes (gate, up, down; tile
     32x128, K = 4) in f32 and bf16, at phase 5's decode and prefill T per
     expert (4 and 1,280), and on fixtures with ragged T, E = 1 and
     K in {3, 9}; timed in bf16 beside its bound, the plain version and a
     dense bf16 ``torch.bmm`` over the decompressed expert stacks.  Then
     K4's variants (grid, decode x bit algebra x activations x C) at the
     three expert stacks and both T, held and timed as K3's (small T per
     expert: 1 ... 64).
  5. MoE serving at full width and depth: ``compress_model`` on
     granite-moe-1b-a400m (24 layers, 32 experts top-8, random weights from
     seed 0) with the default policy (alternating, tile 32x128, K = 4) and
     the default ``max_pool_tiles="auto"``, which cuts the 313,344-tile pool
     below cuSOLVER's batched-eigh limit; then ``serve_model`` from that
     checkpoint generates 32 tokens for 4 prompts of 1024 tokens.  K4 must
     have been launched 3 x 24 x 32 times, K3 4 x 24 x 32 and K5 24.  The
     prefill logits of the kernels are held against the plain path on the
     checkpoint cast to f32; in bf16 (where rounding differences flip
     near-tied router choices and the flips cascade through the layers)
     their distance and, per layer, the tokens whose expert sets differ
     between the two paths are reported.  Launches per schedule must be
     what the resolutions picked.  Time to first token as phase 4's.
  5b. Tuned MoE serving: phase 4b on phase 5's checkpoint, so the tuner
     times K4 on the layer x expert stacks and the Engine resolves K3 and
     K4 from the table: every resolution from it, launches per kernel and
     schedule as it picked; bf16 prefill logits reported as phase 5's.

  K2 (csrc/sqa_sweep.cu) against its plain PyTorch version on dyadic
     fixtures at the paper's nBOCSqa solve (P, C, T, S, n) = (25, 10, 8, 64,
     24) and at edge shapes (T = 1, 2, 3, 13, 16; n = 5, 33, 40; C = 1,
     13; fewer wavefront groups than slices): spins and energies must be
     bit-identical.  Timed at the paper's shape as K1.
  6. The paper's experiment at the paper's size (configs/paper_vgg.py):
     the shrunk-VGG instance 0 (8 x 100, K = 3, n = 24 spins), its exact
     optimum by brute force over all 2^24 codes, then ``run_bbo_batch`` for
     nBOCSqa, nBOCS and nBOCSsq (25 runs) and RS (100 runs) at 24 initial
     points + 1,152 iterations, and gBOCS, vBOCS, FMQA08, FMQA12 (4 runs x
     1,152) and nBOCSa (4 runs x 400).  K2 must have been launched once per
     nBOCSqa iteration and K1 once per nBOCS / nBOCSsq iteration; no run may
     beat the brute-force optimum, every trajectory must be non-increasing
     and every best cost must be the objective of its spins; nBOCSqa's mean
     final residual error must lie below RS's.
  7. Hybrid SSM serving at full width and depth (run before phase 6):
     ``compress_model`` on zamba2-1.2b (38 layers: 6 groups of 5 Mamba2
     SSD blocks and one ``ssm_attn`` block, a remainder of 2 SSD blocks;
     the shared attention block's one parameter tree called 6 times; random
     weights from seed 0) with the default policy: 155,648 tiles of 32 x 131
     (every in_proj: 8,384 = 2^6 x 131 columns) and 94,208 of 32 x 128, no
     kernel launched.  Then K3 at those tiles (and mamba2-130m's in_proj
     tile, 32 x 419) in every schedule x bit algebra x activation x C dtype
     against the plain version, each launch on the path the rules predict
     (the bf16 grid on the tensor cores above T = 4 at td 131 and 419 as at
     128, td padded to 144-column chunks; stream maps the parts
     ``stream_tensor_maps`` admits), and in_proj and out_proj at T = 4 and
     4096 and mamba2's in_proj at 4 and 4096 timed (decode at T = 4 with C
     staged raw at td 131, ``decode_layout``).  Then ``serve_model`` from
     the checkpoint, as phase 4: K3 launched 118 x 32 times (each
     compressed layer slice, and each of the shared block's 7 weights 6
     times, per forward), per schedule as the resolutions picked, the
     prefill's 118 on the tensor cores, K5 6 times (window 4,096 >= S);
     bf16 prefill logits within 5e-2 of max|logit| of the plain path, with
     the distance of the two residual streams after every block reported.
  7c. zamba2-1.2b whole under the scheduler, from phase 7's checkpoint: 4
     slots, 16-token pages, max_len 1,056 (the shared block's KV paged),
     prompts of 512 and 1024 tokens from seed 1, each prefilled in one
     exact-length chunk, 32 greedy tokens.  8 requests on a full pool, then
     on a pool cut so that it evicts: identical tokens; K3 118 launches a
     forward (prefill forwards + decode ticks), K5 6 a prefill; the pool
     empty at the end; 4 requests' first-token logits within 5e-2 of
     max|logit| of a batch-1 prefill (their tokens against batch-1
     ``Engine.generate`` reported).  Then the serve CLI's ``load_curve``
     at 1, 4 and 16 queries per second, 16 requests each, all completed:
     goodput, latency and time-to-first-token percentiles, peak running,
     evictions, ticks and mean tick time per rate.
  8. zamba2-1.2b whole compressed to a byte budget (run after 7c): the
     default policy as the base of ``compress_model(budget_bytes=...)`` at
     phase 7's uniform bytes, calibrated, the QUBO allocator, K in {2, 4,
     6, 8}.  Calibration must launch neither K3 nor K5, probing no kernel,
     the allocation K1 once (the QUBO's spins printed) and its greedy
     cross-check none; the artifact within the budget and every stored
     tensor as allocated (a tensor left dense stored dense).  Reported: the
     cross-check's gap, the calibration-weighted distortion predicted,
     measured from ``tile_resid`` and of phase 7's uniform artifact, and
     the wall times of calibration, probing, the solve, execute and the
     serve.  Then served as phase 7: K3 as the manifest implies, K5 6 a
     prefill, bf16 prefill logits within 5e-2 of the plain path's.
  7b. mamba2-130m whole (24 SSD layers at published widths, random weights
     from seed 0): compressed with the default policy (4,608 tiles of 32 x
     419, 6,912 of 32 x 128) and served as phase 7 (K3 48 x 32 launches,
     the prefill's 48 on the tensor cores, no K5; bf16 prefill logits within
     5e-2 of the plain path's).
  8b. mamba2-130m whole compressed with ``objective="eval_loss"`` to 0.75 x
     the uniform default plan's bytes: the greedy allocator over eval-loss
     deltas (the int8 column and the exact-LP cross-check on), K in {2, 4,
     6, 8}.  The LP must be optimal and within its tolerance, the baseline
     loss finite, the artifact within the budget and stored as allocated;
     the eval harness scores it and the uniform plan of the most K that
     fits the same budget (reported), and it is served as phase 7b.
  9. Delta recompression of phase 2's artifact (run after 4c): (a) on the
     unchanged weights every drift ratio within 1e-4 of 1.0, no tile
     re-solved, no K1 launch, every stored tensor and manifest entry the
     parent's; (b) every fourth band of tile_n rows of attn/wk, attn/wv
     and mlp/down re-drawn with noise of the tensor's std (seed 2): exactly
     the noised tiles re-solve, every other tensor stays the parent's, K1
     launches 32 x the BBO pool's chunks, each warm (``init_state``), and
     the total squared ``tile_resid`` is no more than a cold
     ``execute_plan`` of the drifted weights'.  The delta and cold walls
     are printed; the delta checkpoint is served at 8 new tokens (K3 per
     forward as in phase 4, K5 once, prefill logits within 5e-2).
  10. zamba2-1.2b whole, streamed (after phase 8): phase 7's weights saved
     dense; ``run_compression_job`` from a ``CheckpointLeafSource`` at the
     default 1 GiB host budget in child processes: A killed by SIGKILL
     (``REPRO_STREAM_KILL_AFTER``) at half the leaves, B resuming it (no
     restart), C uninterrupted.  B's compressed leaves must equal phase 7's
     ``execute_plan`` leaves byte for byte and B's output C's; each child's
     wall, chunks and peak RSS are printed.  B is served as phase 7 at 8
     new tokens (K3 118 a forward, K5 6).
  10b. Planning from metadata alone, in a child process: llama3-405b as a
     ``meta`` template, ``streaming_autotune_plan`` (QUBO, K in {2, 4, 6,
     8}) to 0.75 x the uniform plan's bytes: within the budget, K1 once,
     the probe synthetic, ``execute_streaming`` refusing the source; wall
     and peak RSS printed.
  10c. The compress CLI on the whole mamba2-130m (after 8b): ``--streaming
     --ckpt-dir A --out-dir B``, every out_proj drifted as in 9 (b), then
     ``--delta-from B --ckpt-dir A2 --out-dir C`` (threshold 1.03: a
     streamed parent's drift baseline is estimated): ``key=value`` lines,
     the estimated baseline, 0 < fraction re-solved < 1; C served as 7b.

  11. Training, after every other phase: the whole granite-moe-1b-a400m
     (24 layers, 32 experts top-8, bf16, AdamW with f32 accumulation,
     remat) trained by ``launch.train.train_once`` under
     ``run_with_restarts``: 8 x 1,024 tokens a step from ``make_pipeline``
     (seed 0) in 2 microbatches, lr 1e-3 after 2 warm-up steps, 6 steps,
     checkpoints every 3 (keep 1), a crash injected at step 5 (11a): one
     restart, resumed from step 3, the recomputed losses within 1e-3 of the
     first attempt's, every loss finite, step 6's below step 1's; no kernel
     launched.  Each step's loss, grad norm and ms, tokens/s, peak device
     memory, checkpoint bytes, save and restore walls.  (11b) step 6
     restored byte-equal to the state saved, then ``CompressionCycle`` with
     phase 2's policy every 2 steps: cold at step 6 (K1), two more steps at
     lr 1e-3, a delta at step 8 at drift threshold 1.001 (K1, every solve
     warm, exactly the tiles past the threshold re-solved, untouched
     tensors the parent's bytes); the drift ratios per tensor, the fraction
     re-solved, both walls and both artifacts' ``tile_resid``.  (11c) step
     8's artifact served as phase 5 at 8 new tokens: K4 3 x 24, K3 4 x 24 a
     forward, K5 24, per schedule as resolved; f32 prefill logits within
     5e-2 of max|logit| of the plain path.
  12. The sharding of state and work, after 11c, on the card's one-device
     mesh: a one-rank NCCL group and the (1, 1) ("data", "model") mesh.
     (12a) the whole granite-moe-1b-a400m initialised on the mesh (DTensor
     state, each leaf cut to its shard as drawn), its pipeline on the mesh
     and the sharded train step (tensor-parallel along its one-rank
     ``model`` axis), 2 steps at 11a's seed, batch and schedule:
     losses and grad norms identical to 11a's first two; phase 2's policy on
     the first 2 layers' attention of those weights (chunks of up to 10,240
     tiles, as phase 2): ``execute_plan(mesh=)``
     byte-identical to the unsharded execute, K1 32 x the BBO chunks in
     each; 11c's serve again under the mesh's activation rules: the same
     tokens and launches.  (12b) four gloo CPU ranks on this box train a
     reduced granite-moe (f32) on (2, 2) for 3 steps and write a sharded
     checkpoint (one file per rank and leaf), then take a 4th step; the card
     restores the checkpoint whole onto its (1, 1) mesh and takes that step:
     its loss within 1e-4 of the CPU ranks'.  (12c) each rank's share of
     one full-width layer on ``model`` = 4 and 16, the ranks one after
     another (a ``TurnGroup`` stands in for the process group): qwen3-32b
     (bf16; 16 and 4 q heads a rank, kv boxes of 2 heads and of half a
     head), granite-moe-1b-a400m (bf16 and f32; 8 and 2 experts a
     rank), zamba2-1.2b's ssm_attn layer (bf16 and f32; 16 and 4 SSM heads
     a rank, then the shared block's 8 and 2) and mamba2-130m's ssm layer
     (bf16; 6 heads a rank, every head at 16), a 4 x 1,024 prefill with K5
     at the rank's heads where the layer has attention; the joined
     shares within LOGIT_TOL of the whole layer's update on the tokens
     whose router top-k is the whole layer's (the others counted, at most
     5%), a bf16 layer's and its shares' distance from the layer in f32, K5
     launched once a rank a pass;
     K5 at each rank shape held to its plain version (ATTN_TOL, and bf16
     to its rounding bound) and timed beside its bound and SDPA.
  13. Costing and the dry run (roofline.py, launch/cells.py, costing.py,
     dryrun.py; after 12, whose group is gone: each costing plays rank 0 of
     a fake process group on fake tensors).  (13a) phase 11a's train step
     costed on a fake (1, 1) mesh: its argument bytes within 1% of the
     device memory 11a's state held when built, its dot FLOPs equal to
     those counted over one real step of 11a's on the card; per-device
     total beside 11a's peak; then phase 7's compressed zamba2-1.2b
     prefill (4 x 1,024) and batch-4 decode step costed through the
     kernels' costing adapters; each with its roofline terms and the share
     bound / measured of 11a's median step and 7's TTFT and decode step.
     (13b) the dry run at full width: qwen3-32b x train_4k and x
     decode_32k on the fake 16 x 16 mesh (256 H100s), tensor-parallel
     along ``model``: per-device GiB against the card's memory, per-rank
     (dot) FLOPs, collective bytes by kind, roofline terms, walls; every
     count finite and positive, train_4k's dot FLOPs within 2% of a 16th
     of the step's, decode_32k's all-gather below 8.7 GB; zamba2-1.2b x
     decode_32k and x long_500k, each rank its SSM heads: dot FLOPs below
     a quarter and all-gather below half of the counts with every SSM
     weight made whole over ``model``, all-to-all bytes > 0; mamba2-130m
     x decode_32k (24 heads on 16 ranks: every head a rank, out_proj
     row-parallel): dot FLOPs below those counts, no all-to-all.  (13c) kernels/ops.py's
     seven entry points once each at their phases' shapes against their
     plain versions (annealers bit-identical on dyadic problems).

  14. The rest of the zoo and the examples, after 13.  (14a) on random
     weights from seed 0, each through init on the card, ``compress_model``
     with the default policy (no kernel launched; the tiles as the config
     gives them), the artifact and checkpoint restored through the manifest
     (``validate_params`` clean, every leaf equal to the compressed one), a
     4 x 1,024 prefill and 8 decode steps with the kernels on and off:
     musicgen-medium whole (48 layers, MHA 24 x 64, biases on every
     projection, redrawn from the seed after init; stub frame embeddings in
     and for each decode step), internvl2-2b whole (24 layers, GQA 16/8 x
     128, stub patch embeddings; its head skipped as indivisible, dense)
     and command-r-plus-104b at one layer of 64 (the parallel block, GQA
     96/8 x 128, d_ff 33,792, the tied 256,000 x 12,288 head; tokens from
     seed 1, and through ``Engine.generate``: 8 greedy tokens identical with
     the kernels on and off).  Logits within 5e-2 of max|logit| (every
     position for the first two, the last for command-r-plus), argmax
     mismatches reported; K3 once per compressed layer slice a forward, K5
     once per layer a prefill.  Each cell's K5 prefill shape and its MLP's
     up and down (K3 at T = 4,096 and 4) held to their plain versions and
     timed beside their bounds and SDPA / a dense matmul.  (14b) the four
     ``examples/torch_*.py`` through ``main(argv)`` on the card with small
     arguments, each returning 0; the quickstart's BBO no worse than greedy
     with K1 launched.

Prints JSON lines along the way (early on, the -Xptxas -v registers,
shared memory and spills of the tensor-core instantiations), the card's
``nvidia-smi`` name and power limit, a ``kernels`` line, and last
``{"ok": true, "device": ...}``.  Any
failure exits non-zero without that line.  Needs one card; exits non-zero
when CUDA is unavailable or when run outside the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the card's datasheet figures live in one place (outside the repository this
# import fails, and the script exits non-zero with no result)
from repro_torch.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.roofline import PEAK_F32_FLOPS as F32_FLOPS  # noqa: E402
from repro_torch.roofline import PEAK_FLOPS as BF16_FLOPS  # noqa: E402

SPIN_CYCLES = 200_000           # ~0.1 ms of the card's clock, longer than a call's host time
ADD_CYCLES = 4                  # latency of one dependent f32 add (the annealers' chain bound)

SEED = 0
BBO_ITERS = 32
SERVE_T = (1, 16, 512)
BF16_TOL = 2e-2                 # of max|y|: z is rounded to bf16 before z @ C
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 4, 1024, 32
# K5 against its plain version, as tests/test_kernels.py holds the Pallas
# kernel: |o - ref| <= tol + tol * |ref|
ATTN_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
BF16_U = 2.0 ** -8              # unit roundoff of bfloat16 (8 significant bits)


def load_example(path):
    """An example or tool of the repository as a module (they are scripts)."""
    import importlib.util

    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the zoo sweep: phase 14a runs its compress/restore and logits checks, and
# every phase holds kernels on vs off to its LOGIT_TOL of max|logit|
ZOO_SWEEP = load_example(os.path.join("tools", "torch_config_zoo_smoke.py"))
LOGIT_TOL = ZOO_SWEEP.LOGIT_TOL


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(torch, fn, reps: int, flush, warmup: bool = True, busy: bool = False) -> float:
    """Median time between CUDA events around ``fn`` over ``reps`` launches,
    each after the L2 cache was overwritten (a serving step finds its
    weights cold).  A call whose device work is shorter than the host's
    time in its Python wrapper (tens of µs) includes that host time.  With
    ``busy`` the card is kept busy (``torch.cuda._sleep``) while the host
    enqueues the call, so the events bracket device work alone (the
    ``device_ms`` fields)."""
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if busy:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


TENSOR_CORE_KERNELS = {"flash_attention": "flash_mma_kernel",
                       "bitlinear": "bitlinear_mma_kernel"}


def tensor_core_ptxas(build_log):
    """-Xptxas -v of the tensor-core instantiations, K5's bf16 body
    (flash_mma_kernel<hd, warps>) and the grid's bf16 x bf16 body
    (bitlinear_mma_kernel<k step, 16-column pairs, K padded, bitplane,
    td % 8 != 0>):
    {"source": {"kernel<args>": {registers, spills, static smem}}}.  Empty
    for a source whose library was cached (nothing compiled)."""
    out = {}
    for src, kernel in TENSOR_CORE_KERNELS.items():
        rows, cur = {}, None
        for ln in build_log(src).splitlines():
            if "Compiling entry function" in ln:
                m = re.search(kernel + r"I((?:L[ib]\d+E)+)E", ln)
                cur = (f"{kernel}<{','.join(re.findall(r'L[ib](\d+)E', m.group(1)))}>"
                       if m else None)
                if cur:
                    rows[cur] = {}
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                rows[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                rows[cur]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", ln)
                rows[cur]["static_smem"] = int(m.group(1)) if m else 0
        out[src] = rows
    return out


def dyadic_problems(torch, g, P, n, dev):
    """h, B on the grid k/64, |.| <= 4: every field and energy is an exact
    float32 sum, so any summation order gives the same bits."""
    h = torch.randint(-256, 257, (P, n), generator=g, device=dev) / 64.0
    B = torch.triu(torch.randint(-256, 257, (P, n, n), generator=g, device=dev) / 64.0, 1)
    return h.float().contiguous(), (B + B.transpose(1, 2)).float().contiguous()


def sm_clock_mhz() -> float:
    """The card's highest SM clock (MHz), as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])


def anneal_bounds(nbytes: int, ops: int, chain_steps: int) -> dict:
    """The least times of an annealing launch: its bytes over the card's
    memory rate, its operations over the f32 rate, and its chain (the
    longest path of its dependency graph, each step one dependent f32 add
    of 4 cycles at the highest SM clock).  ``bound_ms`` is the largest."""
    b = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / F32_FLOPS * 1e3,
         "chain_bound_ms": chain_steps * ADD_CYCLES / (sm_clock_mhz() * 1e3)}
    by = max(("bytes", "bytes_ms"), ("operations", "ops_ms"), ("chain", "chain_bound_ms"),
             key=lambda kv: b[kv[1]])
    return {**b, "bound_ms": b[by[1]], "bound_by": by[0], "bytes": nbytes, "operations": ops,
            "chain_steps": chain_steps}


def threshold_device_ms(torch, lib, u, temps, t, C, n, flush):
    """Device time of the threshold pass alone (csrc/anneal_step.cuh) on
    u's uniforms: a K1 launch's with temps (P, S), a K2's with t."""
    import ctypes

    fn = lib.anneal_thresholds_f32
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    theta = torch.empty_like(u)

    def run():
        err = fn(u.data_ptr(), temps.data_ptr() if temps is not None else None, t,
                 theta.data_ptr(), u.shape[0] * u.shape[1], u[0, 0].numel(), n, C, u.shape[2],
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"threshold pass: cudaError {err}")
    return cuda_ms(torch, run, 10, flush, busy=True)


def phase_expf(torch, dev):
    """The count of floats z <= 0 at which expf, as each annealer's library
    compiles it, decreases: 0 makes the acceptance thresholds exact."""
    from repro_torch.kernels import sa_sweep as sa

    out = {}
    for lib in ("sa_sweep", "sqa_sweep"):
        t = time.time()
        out[lib] = sa.expf_decreases(dev, lib)
        out[f"{lib}_s"] = time.time() - t
        check(out[lib] == 0, f"expf decreases at {out[lib]} floats z <= 0 ({lib})")
    out["floats_checked"] = 0xFF800000 - 0x80000000 + 2
    return out


# K1's fixtures (P, C, S, n, schedule): the BBO pool's solve (10,240 tiles x
# 4 reads x 24 sweeps at T = 0.1), a geometric schedule at n = 40 (two spins
# per lane at 32 lanes), and the paper's BBO loop (phase 6: 25 or 4 runs x
# 10 reads x 64 sweeps on ising's annealing schedule); all but the second
# are timed
K1_FIXTURES = {
    "sq_main_shape": (10240, 4, 24, 24, "const"),
    "sa_geometric": (512, 4, 32, 40, "geom"),
    "sa_phase6_25": (25, 10, 64, 24, "anneal"),
    "sa_phase6_4": (4, 10, 64, 24, "anneal"),
}


# K1 at the budget allocator's QUBO shape (compression/autotune/allocate.py:
# 6 penalty problems x 8 reads x 96 sweeps on ising's annealing schedule),
# n on both sides of the shared-memory body's limit (237 spins at 8 chains)
# up to the global-memory body's 1,024 (its 48 chains each split over a
# block's warps, sa_sweep.global_warps); n = 237, 512 and 1,024 timed
K1_ALLOC_SHAPE = (6, 8, 96)
K1_ALLOC_N = (121, 237, 238, 512, 1024)
K1_ALLOC_TIMED = (237, 512, 1024)


def k1_timing(torch, lib, h, B, x0, u, temps, flush, plain_ms=None):
    """A K1 launch's ms, device ms, plain ms (timed here unless given),
    threshold pass, ns per step and bounds (bytes, operations, chain) on
    these inputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sa_sweep import direct_acceptance, sa_sweep_many

    P, C, S, n = u.shape
    ms = cuda_ms(torch, lambda: sa_sweep_many(h, B, x0, u, temps), 10, flush)
    device_ms = cuda_ms(torch, lambda: sa_sweep_many(h, B, x0, u, temps), 10, flush, busy=True)
    if plain_ms is None:
        plain_ms = cuda_ms(torch, lambda: ref.sa_sweep_many_ref(h, B, x0, u, temps), 2, flush)
    nbytes = 4 * (P * n + P * n * n + P * C * n + P * C * S * n + P * S + P * C * n + P * C)
    # per spin step: field update (n mul-adds) + acceptance (~6 ops);
    # per chain: initial field and final energy (2 n^2 mul-adds each)
    ops = P * C * (S * n * (2 * n + 6) + 4 * 2 * n * n)
    return {
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        # the threshold pass alone (none runs where the steps decide directly)
        "threshold_device_ms": None if direct_acceptance(P, C) else threshold_device_ms(
            torch, lib, u, temps, 0.0, C, n, flush),
        "ns_per_step": device_ms * 1e6 / (S * n),
        **anneal_bounds(nbytes, ops, S * n),
    }


def phase_k1(torch, dev, flush):
    from repro_torch.core import ising
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels.sa_sweep import (
        direct_acceptance, global_warps, lanes_per_chain, sa_sweep_many, shared_body,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for label, (P, C, S, n, schedule) in K1_FIXTURES.items():
        h, B = dyadic_problems(torch, g, P, n, dev)
        x0 = (2.0 * torch.randint(0, 2, (P, C, n), generator=g, device=dev) - 1.0).contiguous()
        u = torch.rand((P, C, S, n), generator=g, device=dev)
        if schedule == "const":
            temps = torch.full((P, S), 0.1, device=dev)
        elif schedule == "geom":
            temps = torch.logspace(1.0, -1.5, S, device=dev).expand(P, S).contiguous()
        else:
            temps = ising._temperature_schedule(h, B, S).float().contiguous()
        xk, ek = sa_sweep_many(h, B, x0, u, temps)
        xr, er = ref.sa_sweep_many_ref(h, B, x0, u, temps)
        torch.cuda.synchronize()
        err = max(float((xk - xr).abs().max()), float((ek - er).abs().max()))
        check(torch.equal(xk, xr), f"K1 spins differ from the plain version ({label})")
        check(torch.equal(ek, er), f"K1 energies differ from the plain version ({label})")
        out[label] = {"P": P, "C": C, "S": S, "n": n, "identical": True, "max_abs_err": err,
                      "lanes_per_chain": lanes_per_chain(P, C, n),
                      "direct_acceptance": direct_acceptance(P, C),
                      "flipped": float((xk != x0).float().mean())}
        if label == "sa_geometric":
            continue
        timing = k1_timing(torch, _build.load("sa_sweep"), h, B, x0, u, temps, flush)
        if label == "sq_main_shape":
            out["timing"] = timing
        else:
            out.setdefault("timing_phase6", {})[label] = timing
    P, C, S = K1_ALLOC_SHAPE
    for n in K1_ALLOC_N:
        label = f"allocator_n{n}"
        h, B = dyadic_problems(torch, g, P, n, dev)
        x0 = (2.0 * torch.randint(0, 2, (P, C, n), generator=g, device=dev) - 1.0).contiguous()
        u = torch.rand((P, C, S, n), generator=g, device=dev)
        temps = ising._temperature_schedule(h, B, S).float().contiguous()
        before = dict(sa_sweep_many.by_body)
        xk, ek = sa_sweep_many(h, B, x0, u, temps)
        # the body the launch reports it ran: at 48 chains the shared one up
        # to 237 spins, above it each chain split over a block's warps, as
        # the rule's mirror says
        ran = [b for b, k in sa_sweep_many.by_body.items() if k != before[b]]
        body = "shared" if shared_body(n, C) else "global/split"
        warps = 0 if body == "shared" else global_warps(P * C, n, bl.device_sms(dev))
        check(ran == [body] and sa_sweep_many.by_body[body] == before[body] + 1
              and (warps > 1) == (body == "global/split"),
              f"K1 at {label}: the launch ran {ran}, want {body} ({warps} warps a chain)")
        # the plain version (seconds at these n) runs once: checked and timed
        res = {}
        plain_ms = cuda_ms(torch, lambda: res.update(zip("xe", ref.sa_sweep_many_ref(
            h, B, x0, u, temps))), 1, flush, warmup=False)
        xr, er = res["x"], res["e"]
        err = max(float((xk - xr).abs().max()), float((ek - er).abs().max()))
        check(torch.equal(xk, xr), f"K1 spins differ from the plain version ({label})")
        check(torch.equal(ek, er), f"K1 energies differ from the plain version ({label})")
        out[label] = {"P": P, "C": C, "S": S, "n": n, "identical": True, "max_abs_err": err,
                      "body": body, "warps_a_chain": warps,
                      "flipped": float((xk != x0).float().mean())}
        if n in K1_ALLOC_TIMED:
            out.setdefault("timing_allocator", {})[label] = k1_timing(
                torch, _build.load("sa_sweep"), h, B, x0, u, temps, flush, plain_ms=plain_ms)
    return out


# K2's fixtures (P, C, T, S, n): the paper's nBOCSqa solve (25 runs x 10
# reads, 8 replicas, 64 sweeps, 24 spins), then edge shapes: T = 1 (a
# replica is its own neighbour), T = 2 (both neighbours the same), T not a
# power of two, n > 32 (more spins per lane), C > 8 (a second row of
# blocks), C = 1, n < T, and more slices than the wavefront's groups
K2_FIXTURES = {
    "paper_shape": (25, 10, 8, 64, 24),
    "c1_t3_n40": (1, 1, 3, 5, 40),
    "c13_t1": (7, 13, 1, 4, 24),
    "c9_t2_n8": (2, 9, 2, 6, 8),
    "t16_n33": (3, 4, 16, 3, 33),
    "t13_n5": (2, 3, 13, 4, 5),       # n < T: skew 1
    "t8_n40": (2, 5, 8, 4, 40),       # fewer groups (4) than slices: fields pass between groups
}
SQA_TEMPERATURE, SQA_GAMMA0 = 0.05, 3.0
BF_TOPK = 1024


def phase_k2(torch, dev, flush):
    from repro_torch.core import ising
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.sqa_sweep import sqa_sweep_many, wavefront_schedule

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    out = {}
    for label, (P, C, T, S, n) in K2_FIXTURES.items():
        h, B = dyadic_problems(torch, g, P, n, dev)
        X0 = (2.0 * torch.randint(0, 2, (P, C, T, n), generator=g, device=dev) - 1.0).contiguous()
        u = torch.rand((P, C, S, T, n), generator=g, device=dev)
        jp = ising.sqa_jperps(S, T, SQA_TEMPERATURE, SQA_GAMMA0, dev).contiguous()
        before = sqa_sweep_many.launches
        Xk, Ek = sqa_sweep_many(h, B, X0, u, jp, SQA_TEMPERATURE)
        torch.cuda.synchronize()
        check(sqa_sweep_many.launches == before + 1, f"K2 {label}: not launched once")
        Xr, Er = ref.sqa_sweep_many_ref(h, B, X0, u, jp, SQA_TEMPERATURE)
        torch.cuda.synchronize()
        err = max(float((Xk - Xr).abs().max()), float((Ek - Er).abs().max()))
        check(torch.equal(Xk, Xr), f"K2 spins differ from the plain version ({label})")
        check(torch.equal(Ek, Er), f"K2 energies differ from the plain version ({label})")
        G, d = wavefront_schedule(T, n)
        out[label] = {"P": P, "C": C, "T": T, "S": S, "n": n, "identical": True,
                      "max_abs_err": err, "flipped": float((Xk != X0).float().mean()),
                      "groups": G, "skew": d}
        if label != "paper_shape":
            continue
        ms = cuda_ms(torch, lambda: sqa_sweep_many(h, B, X0, u, jp, SQA_TEMPERATURE), 10, flush)
        device_ms = cuda_ms(torch, lambda: sqa_sweep_many(h, B, X0, u, jp, SQA_TEMPERATURE), 10,
                            flush, busy=True)
        # the plain version is a Python loop of S*T*n = 12,288 steps, warm from the check
        plain_ms = cuda_ms(torch, lambda: ref.sqa_sweep_many_ref(h, B, X0, u, jp, SQA_TEMPERATURE),
                           1, flush, warmup=False)
        nbytes = 4 * (P * n + P * n * n + P * C * T * n + P * C * S * T * n + S
                      + P * C * T * n + P * C * T)
        # per spin step: field update (n mul-adds) + acceptance with the
        # replica coupling (~8 ops); per replica: initial field and final
        # energy (2 n^2 mul-adds each)
        ops = P * C * (S * T * n * (2 * n + 8) + T * 4 * 2 * n * n)
        wave = d * (S * T - 1) + n           # the wavefront's steps per chain
        out["timing"] = {
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "threshold_device_ms": threshold_device_ms(
                torch, _build.load("sqa_sweep"), u, None, SQA_TEMPERATURE, C, n, flush),
            # per step of the plain order, and per step of the wavefront
            "ns_per_step": device_ms * 1e6 / (S * T * n),
            "wavefront_steps": wave, "ns_per_wavefront_step": device_ms * 1e6 / wave,
            # the dependency graph's longest path: S*n spins plus T - 1 slices
            **anneal_bounds(nbytes, ops, S * n + T - 1),
        }
    return out


# Phase 6: the paper's algorithms, name -> (BBOConfig options, runs, iterations).
# Fig. 2 / Table 2 at the paper's budget; the five slower algorithms cut to 4
# runs, nBOCSa to the 400 iterations benchmarks/paper_experiments.py gives it.
def paper_algorithms(paper):
    full = paper.iters
    return {
        "nbocsqa": ({"algo": "nbocs", "solver": "qa"}, paper.num_runs, full),
        "nbocs": ({"algo": "nbocs", "solver": "sa"}, paper.num_runs, full),
        "nbocssq": ({"algo": "nbocs", "solver": "sq"}, paper.num_runs, full),
        "rs": ({"algo": "rs"}, paper.num_runs_rs, full),
        "gbocs": ({"algo": "gbocs", "beta": paper.beta_gbocs}, 4, full),
        "vbocs": ({"algo": "vbocs"}, 4, full),
        "fmqa08": ({"algo": "fmqa", "fm_rank": 8}, 4, full),
        "fmqa12": ({"algo": "fmqa", "fm_rank": 12}, 4, full),
        "nbocsa": ({"algo": "nbocs", "augment": True}, 4, min(full, 400)),
    }


def phase_paper(torch, dev, paper=None):
    from repro_torch.configs.paper_vgg import CONFIG
    from repro_torch.core import bbo, bruteforce, symmetry
    from repro_torch.core.decomposition import greedy_decompose, make_objective
    from repro_torch.core.instances import shrunk_vgg_instance
    from repro_torch.device import generator
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.kernels import sqa_sweep as sqa

    paper = paper or CONFIG
    N, K, n = paper.N, paper.K, paper.n
    algos = paper_algorithms(paper)
    emit({"paper_config": {
        "instance": f"shrunk_vgg_instance(0), {N} x {paper.D}, K = {K}, n = {n}",
        "init_points": paper.init_points, "iters": paper.iters, "num_reads": paper.num_reads,
        "reduced": ["instances 10 -> 1",
                    "runs 25 -> 4 for gbocs, vbocs, fmqa08, fmqa12, nbocsa",
                    "nbocsa iterations 1152 -> 400 (as benchmarks/paper_experiments.py)"]}})
    W = shrunk_vgg_instance(0, N=N, D=paper.D, device=dev)
    wnorm = float(torch.linalg.vector_norm(W))
    torch.cuda.synchronize()
    t = time.time()
    # topk beyond the default 64: instance 0's optimum is reached by four
    # orbits of codes spanning one column space (192 codes)
    bf = bruteforce.brute_force(W, K, chunk=min(1 << 14, 1 << n), topk=BF_TOPK)
    bf_s = time.time() - t
    sols = bruteforce.exact_solutions(bf)
    check(bf.second_cost > bf.best_cost,
          f"brute force: second cost {bf.second_cost} not above best {bf.best_cost} "
          f"({len(sols)} exact solutions in the top {BF_TOPK})")
    classes = symmetry.dedupe_exact(sols)
    have = {tuple(r) for r in sols.reshape(len(sols), -1).tolist()}
    for M in classes:
        orbit = symmetry.orbit_flat(torch.from_numpy(M.reshape(-1)), N, K)
        check(all(tuple(r) in have for r in orbit.tolist()),
              "brute force: the solution set is not closed under the symmetry orbit")
    check(len(sols) == len(classes) * symmetry.orbit_size(K),
          f"brute force: {len(sols)} exact solutions are not {len(classes)} whole orbits")
    greedy = greedy_decompose(W, K, generator(dev, SEED, 17))
    f = make_objective(W, K)
    out = {"brute_force": {"best_cost": bf.best_cost, "second_cost": bf.second_cost,
                           "exact_solutions": len(sols), "orbits": len(classes),
                           "orbit_size": symmetry.orbit_size(K), "seconds": bf_s},
           "residual_error": {"second": (bf.second_cost ** 0.5 - bf.best_norm) / wnorm,
                              "greedy": (float(greedy.cost) ** 0.5 - bf.best_norm) / wnorm},
           "algorithms": {}}
    for i, (name, (opts, runs, iters)) in enumerate(algos.items()):
        cfg = bbo.BBOConfig(n=n, N=N, K=K, iters=iters, init_points=paper.init_points,
                            num_reads=paper.num_reads, **opts)
        torch.cuda.synchronize()
        sa.sa_sweep_many.launches = 0
        sqa.sqa_sweep_many.launches = 0
        t = time.time()
        res = bbo.run_bbo_batch(cfg, f, runs, generator(dev, SEED, i))
        torch.cuda.synchronize()
        wall = time.time() - t
        launches = {"sa_sweep_many": sa.sa_sweep_many.launches,
                    "sqa_sweep_many": sqa.sqa_sweep_many.launches}
        want = {"sa_sweep_many": 0 if opts["algo"] == "rs" or opts.get("solver") == "qa" else iters,
                "sqa_sweep_many": iters if opts.get("solver") == "qa" else 0}
        check(launches == want, f"{name}: launches {launches}, want {want}")
        best_y = res.best_y.double().cpu()
        check(tuple(res.traj.shape) == (runs, iters) and bool(torch.isfinite(best_y).all()),
              f"{name}: trajectory {tuple(res.traj.shape)} or non-finite best costs")
        check(bool((best_y >= bf.best_cost * (1 - 1e-5)).all()),
              f"{name}: a run beat the exact optimum ({float(best_y.min())} < {bf.best_cost})")
        check(bool((res.traj[:, 1:] <= res.traj[:, :-1]).all()),
              f"{name}: a best-so-far trajectory increased")
        again = f(res.best_x).double().cpu()
        rel = float(((again - best_y).abs() / best_y.abs()).max())
        check(rel <= 1e-5, f"{name}: f(best_x) differs from best_y by {rel:.3g} relative")
        resid = (best_y.sqrt() - bf.best_norm) / wnorm
        out["algorithms"][name] = {
            "runs": runs, "iters": iters, "seconds_per_run": wall / runs, "wall_s": wall,
            "exact_found": int((best_y <= bf.best_cost * (1 + 1e-5)).sum()),
            "mean_residual_error": float(resid.mean()),
            "max_residual_error": float(resid.max()),
            "launches": launches, "max_rel_f_check": rel,
        }
    a = out["algorithms"]
    check(a["nbocsqa"]["mean_residual_error"] < a["rs"]["mean_residual_error"],
          f"nBOCSqa's mean residual error {a['nbocsqa']['mean_residual_error']:.4g} is not "
          f"below RS's {a['rs']['mean_residual_error']:.4g}")
    emit({"paper": out})
    return out


def full_width_config():
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-32b")
    return cfg, dataclasses.replace(cfg, num_layers=1)


def policy():
    from repro_torch.compression import CompressionPolicy, CompressionRule

    return CompressionPolicy(
        method="alternating", tile_n=32, tile_d=128, rank_ratio=0.125,
        rules=(CompressionRule(pattern=r"attn/w[kv]", method="bbo",
                               rank_ratio=0.375, bbo_iters=BBO_ITERS),),
    )


def leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# phase 2's int8 check: execute_plan(method="int8") on one full-width block
# tensor on the card and on the CPU, byte for byte
INT8_PATH = "groups/0/attn/wq/w"


def int8_card_vs_cpu(torch, dev, values):
    """``execute_plan`` with ``method="int8"`` on ``INT8_PATH`` of the
    full-width qwen3-32b block, on the card and on the CPU: every leaf of
    the two compressed trees (codes and scales) and their manifests'
    entries must be equal byte for byte (eager f32 products and divisions
    round to nearest on both)."""
    from repro_torch.compression import CompressionPolicy, execute_plan, plan_compression
    from repro_torch.compression.plan import tree_paths

    def tree(w):
        out = node = {}
        *dirs, last = INT8_PATH.split("/")
        for k in dirs:
            node[k] = {}
            node = node[k]
        node[last] = w
        return out

    w = leaf(values, INT8_PATH)
    pol = CompressionPolicy(method="int8", tile_d=32, min_size=4096)
    runs = {}
    for name, where, src in (("card", dev, tree(w)), ("cpu", "cpu", tree(w.cpu()))):
        torch.cuda.synchronize()
        t = time.time()
        cv, art = execute_plan(plan_compression(src, pol), src, seed=SEED, device=where,
                               verbose=False)
        torch.cuda.synchronize()
        runs[name] = ({p: v.cpu() for p, v in tree_paths(cv)}, art.manifest["tensors"],
                      time.time() - t)
    (card, card_m, card_s), (cpu, cpu_m, cpu_s) = runs["card"], runs["cpu"]
    check(list(card) == list(cpu) and any(p.endswith("/q") for p in card),
          f"int8: the trees' leaves {list(card)} and {list(cpu)}")
    differ = [p for p in card if card[p].dtype != cpu[p].dtype
              or card[p].shape != cpu[p].shape or not torch.equal(card[p], cpu[p])]
    check(not differ, f"int8: the card's leaves {differ} differ from the CPU's")
    keys = ("method", "num_tiles", "q", "scale", "new_bytes")
    check([{k: e.get(k) for k in keys} for e in card_m.values()]
          == [{k: e.get(k) for k in keys} for e in cpu_m.values()],
          "int8: the card's manifest entries differ from the CPU's")
    out = {"path": INT8_PATH, "shape": list(w.shape), "dtype": str(w.dtype).split(".")[-1],
           "leaves": {p: list(v.shape) for p, v in card.items()},
           "tiles": [e["num_tiles"] for e in card_m.values()], "bytes_equal": True,
           "card_s": card_s, "cpu_s": cpu_s}
    emit({"int8_card_vs_cpu": out})
    return out


def phase_compress(torch, dev, out_dir):
    from repro_torch.checkpoint import checkpointer
    from repro_torch.compression import CompressionArtifact
    from repro_torch.compression.execute import _tensor_signs, _tensor_tiles
    from repro_torch.compression.plan import plan_compression
    from repro_torch.core import decomposition as dec
    from repro_torch.core.compress import compress_tile_batch
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.launch.compress import compress_model
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    full, cfg = full_width_config()
    emit({"reduced": {"arch": cfg.name, "num_layers": [full.num_layers, cfg.num_layers],
                      "widths": "published (d_model 5120, 64x128 q heads, 8 kv heads, "
                                "d_ff 25600, vocab 151936, bf16)"}})
    pol = policy()
    values, _ = split(init_model(cfg, seed=SEED, device=dev))
    torch.cuda.synchronize()

    sa.sa_sweep_many.launches = 0
    bl.reset_counts()
    t0 = time.time()
    cvalues, artifact = compress_model(cfg, pol, out_dir, seed=SEED, device=dev,
                                       max_pool_tiles=10240, values=values)
    torch.cuda.synchronize()
    wall = time.time() - t0
    k1_launches = sa.sa_sweep_many.launches
    check(bl.bitlinear.launches == 0, "compression launched the serving kernel")

    bbo_pools = [p for p in artifact.manifest["pools"] if p["method"] == "bbo"]
    check(len(bbo_pools) == 1, f"expected one BBO pool, got {len(bbo_pools)}")
    pool = bbo_pools[0]
    check(pool["chunks"] == 1, f"BBO pool of {pool['num_tiles']} tiles in {pool['chunks']} chunks")
    check(k1_launches == pool["bbo_iters"] * pool["chunks"],
          f"K1 launched {k1_launches} times, want {pool['bbo_iters']} x {pool['chunks']}")

    # no BBO tile ends worse than its alternating start (same draws)
    plan = plan_compression(values, pol)
    worst, err_sums, n_tiles = 0.0, [0.0, 0.0], 0
    for t in plan.tensors:
        if t.method != "bbo":
            continue
        tiles = _tensor_tiles(leaf(values, t.path), t, dev).float()
        M_alt, _, err_alt = compress_tile_batch(tiles, _tensor_signs(SEED, t, dev), t.K,
                                                "alternating")
        w = leaf(cvalues, t.path)
        M = dec.unpack_bits(w["m_packed"].reshape(-1, t.tile_n, w["m_packed"].shape[-1]), t.K)
        err = torch.sqrt(torch.clamp_min(dec.objective(M, tiles), 0.0)) / \
            torch.linalg.vector_norm(tiles, dim=(-2, -1)).clamp_min(1e-30)
        worst = max(worst, float((err - err_alt).max()))
        err_sums[0] += float(err_alt.sum())
        err_sums[1] += float(err.sum())
        n_tiles += err.numel()
    check(worst <= 1e-5, f"a BBO tile ended {worst:.3g} above its alternating start")
    int8_card_vs_cpu(torch, dev, values)

    # the checkpoint and manifest restore to what was computed
    art = CompressionArtifact.load(out_dir)
    restored = checkpointer.restore(out_dir, 0, {"params": art.restore_template(values)},
                                    device=dev)["params"]
    check(art.validate_params(restored) == [], "restored params disagree with the manifest")
    for path in artifact.manifest["tensors"]:
        for k, v in leaf(cvalues, path).items():
            check(torch.equal(leaf(restored, path)[k], v), f"restored {path}/{k} differs")
    tensors = {
        p: {"method": e["method"], "tile": [e["tile_n"], e["tile_d"]], "K": e["K"],
            "tiles": e["num_tiles"], "rel_err": e["rel_err"],
            "ratio": e["orig_bytes"] / e["new_bytes"]}
        for p, e in artifact.manifest["tensors"].items()
    }
    emit({"compress": {"wall_s": wall, "k1_launches": k1_launches, "tensors": tensors,
                       "pools": [{k: p[k] for k in ("method", "tile_n", "tile_d", "K",
                                                    "num_tiles", "chunks", "solver_calls")}
                                 for p in artifact.manifest["pools"]],
                       "totals": artifact.manifest["totals"],
                       "bbo_tiles": {"n": n_tiles,
                                     "mean_rel_err_alternating": err_sums[0] / n_tiles,
                                     "mean_rel_err_bbo": err_sums[1] / n_tiles,
                                     "worst_increase": worst}}})
    return restored, artifact, k1_launches


def generate_shapes(path):
    """K3's token counts in phase 4: T = 4 in decode and for the head, which
    prefill runs on the last position only; T = 4096 for the prefill of
    every other weight."""
    return (GEN_BATCH,) if path == "head/w" else (GEN_BATCH, GEN_BATCH * GEN_PROMPT)


def phase_serve(torch, dev, params, artifact, flush):
    from repro_torch.core import quantized
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels import bitlinear as bl

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    weights = {}
    for path, e in artifact.manifest["tensors"].items():
        w = leaf(params, path)
        weights[path] = {k: v[0] if e["group_dims"] else v for k, v in w.items()}
    inputs = {
        (path, T): torch.randn((T, w["m_packed"].shape[0] * w["m_packed"].shape[2]),
                               generator=g, device=dev).to(torch.bfloat16)
        for path, w in weights.items() for T in SERVE_T + generate_shapes(path)
    }
    ops.enable_kernels()
    torch.cuda.synchronize()
    bl.reset_counts()
    t0 = time.time()
    outputs = {key: quantized.apply_compressed(x, weights[key[0]]) for key, x in inputs.items()}
    torch.cuda.synchronize()
    wall = time.time() - t0
    k3_launches = bl.bitlinear.launches
    ops.disable_kernels()
    check(k3_launches == len(inputs), f"K3 launched {k3_launches} times, want {len(inputs)}")

    rows = []
    # "serve_t": the calls at T = 1, 16, 512; "generate": the distinct
    # (tensor, T) calls of phase 4, each once
    totals = {part: {"calls": 0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0, "library_device_ms": 0.0, "bytes_ms": 0.0,
                     "ops_ms": 0.0}
              for part in ("serve_t", "generate")}
    max_err = 0.0
    for (path, T), x in inputs.items():
        w = weights[path]
        y = outputs[(path, T)]
        dense = quantized.decompress(w, torch.float32)
        want = x.float() @ dense
        scale = float(want.abs().max())
        err = float((y.float() - want).abs().max())
        check(torch.isfinite(y).all() and tuple(y.shape) == tuple(want.shape),
              f"{path} T={T}: bad output")
        check(err <= BF16_TOL * scale, f"{path} T={T}: |y - x@W_hat| {err:.3g} > tol")
        mp, C = w["m_packed"], w["C"]
        # the schedule the served call above resolved (no table: the default rule)
        sched = autotune.resolve_fused(x, mp, C)
        kw = sched.kwargs()
        yk = bl.bitlinear(x, mp, C, **kw)
        yp = ref.bitlinear_ref(x, mp, C, sched.math)
        kerr = float((yk.float() - yp.float()).abs().max())
        check(kerr <= BF16_TOL * float(yp.float().abs().max()),
              f"{path} T={T}: kernel vs plain {kerr:.3g}")
        max_err = max(max_err, kerr)
        w_dense = dense.to(torch.bfloat16)
        del dense
        n_r, n_c, tn, kb = mp.shape
        K, td = C.shape[2], C.shape[3]
        ms = cuda_ms(torch, lambda: bl.bitlinear(x, mp, C, **kw), 5, flush)
        device_ms = cuda_ms(torch, lambda: bl.bitlinear(x, mp, C, **kw), 5, flush, busy=True)
        plain_ms = cuda_ms(torch, lambda: ref.bitlinear_ref(x, mp, C, sched.math), 2, flush)
        library_ms = cuda_ms(torch, lambda: torch.matmul(x, w_dense), 5, flush)
        library_device_ms = cuda_ms(torch, lambda: torch.matmul(x, w_dense), 5, flush, busy=True)
        nbytes = mp.numel() + C.numel() * C.element_size() + x.numel() * 2 + y.numel() * 2
        ops_ = 2 * T * (n_r * tn * n_c * K + n_r * n_c * K * td)
        b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_ / BF16_FLOPS * 1e3
        rows.append({"tensor": path, "T": T, "shape": [n_r, n_c, tn, K, td],
                     "schedule": f"{sched.mode}/{sched.math}", "ms": ms, "device_ms": device_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_device_ms": library_device_ms,
                     "bound_ms": max(b_bytes, b_ops),
                     "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                     "max_abs_err": kerr})
        tot = totals["serve_t" if T in SERVE_T else "generate"]
        tot["calls"] += 1
        for k, v in (("ms", ms), ("device_ms", device_ms), ("plain_ms", plain_ms),
                     ("library_ms", library_ms), ("library_device_ms", library_device_ms),
                     ("bound_ms", max(b_bytes, b_ops)), ("bytes_ms", b_bytes),
                     ("ops_ms", b_ops)):
            tot[k] += v
        del w_dense
    emit({"serve": {"wall_s": wall, "k3_launches": k3_launches, "totals": totals,
                    "calls": rows}})
    return k3_launches, max_err, totals["generate"], weights, inputs


# K3 and K4 variants: schedule x bit algebra x activation dtype x C dtype,
# each held against its plain version on the same inputs
XDTYPES = ("float32", "bfloat16", "int8")
CDTYPES = ("float32", "bfloat16")
MATHS = ("unpack", "bitplane")
# each schedule also at other block_t / r_chunk (decode takes neither)
MODE_OPTIONS = {"grid": ({}, {"block_t": 64, "r_chunk": 4}, {"block_t": 256, "r_chunk": 2}),
                "decode": ({},), "stream": ({}, {"r_chunk": 2}, {"r_chunk": 4}, {"r_chunk": 8})}


def variant_inputs(torch, g, dev, x_shape, C, xd, cd, tn):
    """x (x_shape) and C in the variant's dtypes.  int8 activations take
    x in [-8, 8] and C rounded to the grid k/256, |k| <= q: z is an exact
    integer, every product z*C a multiple of 1/256 and every partial sum
    below 2^24/256, so the f32 sums are exact in any order and the
    truncated int8 output must be equal (kernel and plain version sum in
    different orders)."""
    if xd == "int8":
        n_r, K = C.shape[-4], C.shape[-2]
        q = min(16, (2 ** 24 - 1) // (n_r * K * 8 * tn))
        check(q >= 1, f"no dyadic C grid for n_r {n_r}, K {K}, tn {tn}")
        x = torch.randint(-8, 9, x_shape, generator=g, device=dev, dtype=torch.int8)
        return x, (torch.round(C.float() * 256).clamp(-q, q) / 256).to(getattr(torch, cd))
    x = torch.randn(x_shape, generator=g, device=dev).to(getattr(torch, xd))
    return x, C.to(getattr(torch, cd)).contiguous()


def variant_error(torch, yk, yp, xd, cd):
    """(max |y - plain|, within the limit).  int8: equal.  f32 x and C:
    within 1e-4 + 1e-4 |plain|.  Either in bf16 (z is rounded to bf16
    before z @ C): within 2e-2 of max |plain|."""
    if xd == "int8":
        return float((yk.int() - yp.int()).abs().max()), torch.equal(yk, yp)
    diff = (yk.float() - yp.float()).abs()
    err = float(diff.max())
    if xd == "float32" and cd == "float32":
        return err, bool((diff <= 1e-4 + 1e-4 * yp.float().abs()).all())
    return err, err <= BF16_TOL * float(yp.float().abs().max())


def hold_variants(torch, fn, plain, label, x, mp, C, xd, cd, modes, errs, paths=None):
    """Every mode x math x options of ``fn`` against ``plain`` on (x, mp,
    C).  A variant whose block needs more shared memory than the card has
    is skipped (decode keeps every row of x there); any other refusal or
    failure fails the run.  Each launch must have taken the path the rules
    predict, by the library's report: the grid's tensor-core body where
    ``bitlinear.grid_on_tensor_cores`` says so (else the FMA body), and stream's
    tensor maps for the parts ``bitlinear.stream_tensor_maps`` admits;
    ``paths`` (a dict) counts them ("tensor_cores", "fma", "stream_maps").
    Returns the variants held."""
    from repro_torch.kernels import bitlinear as bl

    T = x.shape[-2]
    n_r, tn, K, td = mp.shape[-4], mp.shape[-2], C.shape[-2], C.shape[-1]
    xs, cs = x.element_size(), C.element_size()
    budget = bl.device_smem_budget(x.device)
    paths = {} if paths is None else paths
    ran = 0
    for math in MATHS:
        yp = plain(x, mp, C, math)
        for mode in modes:
            for opts in MODE_OPTIONS[mode]:
                rc = bl.resolve_r_chunk(n_r, opts.get("r_chunk", 1))
                if bl.smem_bytes(mode, T=T, n_r=n_r, tn=tn, K=K, td=td,
                                 x_itemsize=xs, c_itemsize=cs, r_chunk=rc) > budget:
                    continue
                before = (fn.launches, fn.tensor_core_launches, dict(fn.stream_maps))
                yk = fn(x, mp, C, mode=mode, math=math, **opts)
                torch.cuda.synchronize()
                check(fn.launches == before[0] + 1, f"{label} {mode}/{math}: not launched once")
                on_mma = mode == "grid" and bl.grid_on_tensor_cores(T, tn, K, td, xs, cs)
                check(fn.tensor_core_launches == before[1] + on_mma,
                      f"{label} {xd} x, {cd} C, {mode}/{math} {opts}: the library's "
                      f"tensor-core report is not the rule's {on_mma}")
                if mode == "grid":
                    key = "tensor_cores" if on_mma else "fma"
                    paths[key] = paths.get(key, 0) + 1
                if mode == "stream":
                    maps = bl.stream_tensor_maps(T=T, tn=tn, K=K, td=td, x_itemsize=xs,
                                                 c_itemsize=cs, r_chunk=rc)
                    want = "+".join(k for k, v in maps.items() if v) or "none"
                    check(fn.stream_maps.get(want, 0) == before[2].get(want, 0) + 1,
                          f"{label} {xd} x, {cd} C, stream/{math} {opts}: the library mapped "
                          f"other parts than {want}")
                    sm = paths.setdefault("stream_maps", {})
                    sm[want] = sm.get(want, 0) + 1
                check(yk.dtype == x.dtype and yk.shape == yp.shape,
                      f"{label} {mode}/{math} {opts}: bad output {yk.dtype} {tuple(yk.shape)}")
                err, ok = variant_error(torch, yk, yp, xd, cd)
                check(ok, f"{label} {xd} x, {cd} C, {mode}/{math} {opts}: |y - plain| {err:.3g} "
                          "beyond its limit")
                key = f"{mode}/{math}"
                errs[key] = max(errs.get(key, 0.0), err)
                ran += 1
        del yp
    return ran


def k3_variant_fixtures():
    """(label, tensor, T): phase 3's T = 1, 16, 512 and phase 4's T = 4
    and 4096 on its tensors, the BBO tensors (tn = 8, K = 3) and ragged T."""
    return (("wq_T1", "attn/wq", 1), ("down_T16", "mlp/down", 16), ("wo_T512", "attn/wo", 512),
            ("up_T4", "mlp/up", 4), ("wq_T4096", "attn/wq", 4096),
            ("bbo_wk_T4", "attn/wk", 4), ("bbo_wv_T37", "attn/wv", 37),
            ("gate_T37", "mlp/gate", 37))


def k3_bound(mp, C, T, x_itemsize):
    """(bytes_ms, ops_ms) of one K3 call: each input read once and the
    output written once; 2 operations per multiply-add of x @ M and z @ C
    at the bf16 tensor-core rate."""
    n_r, n_c, tn, _ = mp.shape
    K, td = C.shape[2], C.shape[3]
    nbytes = mp.numel() + C.numel() * C.element_size() + T * n_r * tn * x_itemsize \
        + T * n_c * td * x_itemsize
    ops_ = 2 * T * (n_r * tn * n_c * K + n_r * n_c * K * td)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops_ / BF16_FLOPS * 1e3


def gbps(bytes_ms: float, ms: float) -> float:
    """GB/s of a call that moves the bytes HBM_BYTES_PER_S moves in
    ``bytes_ms`` milliseconds, in ``ms`` milliseconds."""
    return bytes_ms / ms * HBM_BYTES_PER_S / 1e9


def decode_call(bl, dev, mode, tensor, E, n_c, n_r, bytes_ms, device_ms):
    """For a timed decode call: its tensor, the cluster size S the rule gives
    it (what the launch ran) and the bytes it moved per second of device
    time (each input read once, the output written once), against the
    card's HBM_BYTES_PER_S."""
    if mode != "decode":
        return {}
    return {"tensor": tensor, "S": bl.decode_cluster_size(E * n_c, n_r, bl.device_sms(dev)),
            "GBps": gbps(bytes_ms, device_ms)}


# granite-moe-1b-a400m's K3 tensors (attention; d_in, d_out) at the default
# policy's tile 32 x 128, K = 4; stream's timed r_chunk values
GRANITE_K3 = {"attn/wq": (1024, 1024), "attn/wk": (1024, 512), "attn/wv": (1024, 512),
              "attn/wo": (1024, 1024)}
STREAM_TIMED_R_CHUNKS = (1, 2, 4, 8)


def stream_calls(torch, g, dev, weights, inputs, flush):
    """Stream (bf16, bitplane) at every r_chunk of STREAM_TIMED_R_CHUNKS on
    qwen's eight T = 4 calls (phase 4's weights and inputs) and on
    granite-moe's four K3 tensors (random weights at their shapes): per call
    the rule's S and the launch's (counted by the wrapper), the parts that
    went through a tensor map (the library's report, checked against
    ``stream_tensor_maps``), ``ms``, ``device_ms`` and GB/s of device time;
    and the sums per model and r_chunk."""
    from repro_torch.kernels import bitlinear as bl

    calls = [("qwen", path, weights[path]["m_packed"], weights[path]["C"], x)
             for (path, T), x in sorted(inputs.items()) if T == GEN_BATCH]
    for name, (d_in, d_out) in GRANITE_K3.items():
        n_r, n_c = d_in // 32, d_out // 128
        mp = torch.randint(0, 256, (n_r, n_c, 32, 1), generator=g, device=dev, dtype=torch.uint8)
        C = (torch.randn((n_r, n_c, 4, 128), generator=g, device=dev) * 0.2).to(torch.bfloat16)
        x = torch.randn((GEN_BATCH, d_in), generator=g, device=dev).to(torch.bfloat16)
        calls.append(("granite", name, mp, C, x))
    rows, sums = [], {}
    for model, name, mp, C, x in calls:
        n_r, n_c, tn, _ = mp.shape
        K, td = C.shape[2], C.shape[3]
        b_bytes, _ = k3_bound(mp, C, GEN_BATCH, 2)
        for rc in STREAM_TIMED_R_CHUNKS:
            rc = bl.resolve_r_chunk(n_r, rc)
            geo = bl.stream_geometry(T=GEN_BATCH, tn=tn, K=K, td=td, x_itemsize=2, c_itemsize=2,
                                     r_chunk=rc)
            smem = bl.smem_bytes("stream", T=GEN_BATCH, n_r=n_r, tn=tn, K=K, td=td,
                                 x_itemsize=2, c_itemsize=2, r_chunk=rc)
            check(smem == geo["smem"], f"stream {name} r_chunk {rc}: library layout {smem} "
                                       f"!= stream_geometry's {geo['smem']}")
            S = bl.stream_cluster_size(n_c * geo["col_chunks"] * geo["row_blocks"], n_r, rc,
                                       bl.device_sms(dev),
                                       bl.stream_blocks_per_sm(geo["bt"], smem,
                                                               bl.device_sm_smem(dev)))
            want = "+".join(k for k, v in geo["maps"].items() if v) or "none"
            before = (dict(bl.bitlinear.stream_clusters), dict(bl.bitlinear.stream_maps))
            bl.bitlinear(x, mp, C, mode="stream", math="bitplane", r_chunk=rc)
            torch.cuda.synchronize()
            check(bl.bitlinear.stream_clusters.get(S, 0) == before[0].get(S, 0) + 1,
                  f"stream {name} r_chunk {rc}: not launched at the rule's S = {S}")
            check(bl.bitlinear.stream_maps.get(want, 0) == before[1].get(want, 0) + 1,
                  f"stream {name} r_chunk {rc}: the library staged other parts than {want}")
            ms, device_ms = (cuda_ms(torch, lambda: bl.bitlinear(x, mp, C, mode="stream",
                                                                 math="bitplane", r_chunk=rc),
                                     10, flush, busy=busy) for busy in (False, True))
            rows.append({"model": model, "tensor": name, "T": GEN_BATCH, "r_chunk": rc, "S": S,
                         "blocks": n_c * geo["col_chunks"] * geo["row_blocks"] * S,
                         "stages": geo["stages"], "maps": want, "ms": ms,
                         "device_ms": device_ms, "GBps": gbps(b_bytes, device_ms)})
            tot = sums.setdefault(f"{model}/r_chunk={rc}",
                                  {"calls": 0, "ms": 0.0, "device_ms": 0.0, "bytes_ms": 0.0})
            tot["calls"] += 1
            tot["ms"] += ms
            tot["device_ms"] += device_ms
            tot["bytes_ms"] += b_bytes
    for tot in sums.values():
        tot["GBps"] = gbps(tot.pop("bytes_ms"), tot["device_ms"])
    return {"calls": rows, "sums": sums}


def decode_calls(timed):
    """The timed decode calls of a variants phase, per bit algebra."""
    return [{"math": key.split("/")[1],
             **{k: r[k] for k in ("tensor", "T", "S", "ms", "device_ms", "GBps")}}
            for key, rows in timed.items() if key.startswith("decode/") for r in rows]


def sum_variants(timed):
    """Per "mode/math": the sums of ms, device_ms, plain_ms, library_ms,
    library_device_ms and the bound over the calls it ran, with bound_by
    from the summed bytes and ops, and the kernel's ms summed per T."""
    out = {}
    for key, rows in timed.items():
        b = sum(r["bytes_ms"] for r in rows)
        o = sum(r["ops_ms"] for r in rows)
        Ts = sorted({r["T"] for r in rows})
        out[key] = {"calls": len(rows), "T": Ts,
                    **{k: sum(r[k] for r in rows)
                       for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                 "library_device_ms", "bound_ms")},
                    "bound_by": "bytes" if b >= o else "operations",
                    "ms_by_T": {T: sum(r["ms"] for r in rows if r["T"] == T) for T in Ts}}
    return out


# the default rule's small-T cutoff: each schedule timed at these T
SWEEP_T = (1, 2, 4, 8, 16, 32, 64)


def sweep_small_t(torch, g, dev, fn, operands, modes, Ts, flush):
    """Per T: ms summed over ``operands`` [(lead, mp, C)] per "mode/math",
    in bf16, each schedule at the default rule's options (grid at its
    block_t, stream at the tuner's first r_chunk), a schedule only where
    every operand's block fits; the same as device time alone ("device":
    {"mode/math": ms}); and the default rule's picks ("rule")."""
    from repro_torch.kernels import bitlinear as bl

    budget = bl.device_smem_budget(dev)
    opts = {"grid": {"block_t": bl.DEFAULT_GRID_BLOCK_T}, "decode": {},
            "stream": {"r_chunk": bl.STREAM_R_CHUNKS[0]}}
    out = {}
    for T in Ts:
        xs = [torch.randn(lead + (T, mp.shape[-4] * mp.shape[-2]), generator=g,
                          device=dev).to(torch.bfloat16) for lead, mp, _ in operands]

        def fits(mode):
            return all(bl.smem_bytes(mode, T=T, n_r=mp.shape[-4], tn=mp.shape[-2],
                                     K=C.shape[-2], td=C.shape[-1], x_itemsize=2, c_itemsize=2,
                                     r_chunk=bl.resolve_r_chunk(mp.shape[-4],
                                                                opts[mode].get("r_chunk", 1)))
                       <= budget for _, mp, C in operands)

        row = {"rule": sorted({"{mode}/{math}".format(**bl.default_schedule(
            T=T, n_r=mp.shape[-4], tn=mp.shape[-2], K=C.shape[-2], td=C.shape[-1], x_itemsize=2,
            budget=budget)) for _, mp, C in operands})}
        row["device"] = {}
        for mode in (m for m in modes if fits(m)):
            for math in MATHS:
                for busy, into in ((False, row), (True, row["device"])):
                    into[f"{mode}/{math}"] = sum(
                        cuda_ms(torch, lambda: fn(x, mp, C, mode=mode, math=math, **opts[mode]),
                                5, flush, busy=busy)
                        for x, (_, mp, C) in zip(xs, operands))
        out[T] = row
    return out


def phase_k3_variants(torch, dev, weights, inputs, flush):
    """K3's schedules, bit algebras and activation dtypes against the plain
    version on phase 3's tensors; then each mode x math timed in bf16 over
    phase 4's distinct (tensor, T) calls beside its bound, the plain
    version of the same math and a dense bf16 matmul."""
    from repro_torch.core import quantized
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    by_name = {p.split("/", 2)[-1] if p.startswith("groups/") else p: p for p in weights}
    errs, checks = {}, {}
    for label, name, T in k3_variant_fixtures():
        w = weights[by_name[name + "/w"]]
        mp = w["m_packed"]
        ran = 0
        for xd in XDTYPES:
            for cd in CDTYPES:
                x, C = variant_inputs(torch, g, dev, (T, mp.shape[0] * mp.shape[2]), w["C"],
                                      xd, cd, mp.shape[2])
                ran += hold_variants(torch, bl.bitlinear, ref.bitlinear_ref, label, x, mp, C,
                                     xd, cd, ("grid", "decode", "stream"), errs)
        checks[label] = {"tensor": name, "T": T, "shape": list(mp.shape[:3]) + list(
            w["C"].shape[2:]), "variants_held": ran}

    timed = {f"{m}/{a}": [] for m in ("grid", "decode", "stream") for a in MATHS}
    budget = bl.device_smem_budget(dev)
    for (path, T), x in inputs.items():
        if T not in generate_shapes(path):
            continue
        w = weights[path]
        mp, C = w["m_packed"], w["C"]
        n_r, _, tn, _ = mp.shape
        K, td = C.shape[2], C.shape[3]
        w_dense = quantized.decompress(w, torch.bfloat16)
        library_ms = cuda_ms(torch, lambda: torch.matmul(x, w_dense), 5, flush)
        library_device_ms = cuda_ms(torch, lambda: torch.matmul(x, w_dense), 5, flush, busy=True)
        del w_dense
        b_bytes, b_ops = k3_bound(mp, C, T, 2)
        for math in MATHS:
            plain_ms = cuda_ms(torch, lambda: ref.bitlinear_ref(x, mp, C, math), 2, flush)
            for mode in ("grid", "decode", "stream"):
                if mode == "decode" and not bl.decode_path_ok(T, n_r, tn, K, td, 2,
                                                               budget):
                    continue
                ms, device_ms = (cuda_ms(torch, lambda: bl.bitlinear(x, mp, C, mode=mode,
                                                                     math=math), 5, flush,
                                         busy=busy) for busy in (False, True))
                timed[f"{mode}/{math}"].append(
                    {"T": T, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "library_device_ms": library_device_ms,
                     "bound_ms": max(b_bytes, b_ops), "bytes_ms": b_bytes, "ops_ms": b_ops,
                     **decode_call(bl, dev, mode, path, 1, mp.shape[1], n_r, b_bytes,
                                   device_ms)})
    # the small-T cutoff of the default rule, over phase 4's tensors
    operands = [((), weights[p]["m_packed"], weights[p]["C"]) for p in sorted(weights)]
    sweep = sweep_small_t(torch, g, dev, bl.bitlinear, operands, ("grid", "decode", "stream"),
                          SWEEP_T, flush)
    out = {"checks": checks, "max_abs_err": errs, "timing": sum_variants(timed),
           "decode_calls": decode_calls(timed), "small_t_ms": sweep,
           "stream_calls": stream_calls(torch, g, dev, weights, inputs, flush)}
    emit({"k3_variants": out})
    return out


def attention_shapes(cfg):
    """K5's fixtures: the prefill shapes of phases 4, 5 and 7 in both dtypes
    (phase 7's zamba2 shared block: MHA, window 4,096 >= S), and the
    sliding-window shape of tests/test_kernels.py in both dtypes."""
    prefill = (GEN_BATCH, cfg.num_heads, cfg.num_kv_heads, GEN_PROMPT, cfg.resolved_head_dim, 0)
    m = moe_config()
    moe_prefill = (GEN_BATCH, m.num_heads, m.num_kv_heads, GEN_PROMPT, m.resolved_head_dim, 0)
    z = zamba_config()
    zamba_prefill = (GEN_BATCH, z.num_heads, z.num_kv_heads, GEN_PROMPT, z.resolved_head_dim,
                     z.sliding_window)
    return {
        "zamba2_prefill_f32": (*zamba_prefill, "float32"),
        "zamba2_prefill_bf16": (*zamba_prefill, "bfloat16"),
        "prefill_bf16": (*prefill, "bfloat16"),
        "prefill_f32": (*prefill, "float32"),
        "window_f32": (1, 8, 8, 256, 64, 64, "float32"),
        "window_bf16": (1, 8, 8, 256, 64, 64, "bfloat16"),
        "moe_prefill_f32": (*moe_prefill, "float32"),
        "moe_prefill_bf16": (*moe_prefill, "bfloat16"),
    }


def attention_f32_scores(torch, q, k, v, window):
    """The plain attention with K5's rounding: scores from the inputs in f32,
    p rounded to v's dtype before P.V, the product kept in f32.  Returns
    (o, p @ |v|), each (B, H, S, hd) f32."""
    B, H, S, hd = q.shape
    rep = H // k.shape[1]
    kr = k.float().repeat_interleave(rep, dim=1)
    vr = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) / hd ** 0.5
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= (pos[:, None] - pos[None, :]) < window
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1).to(v.dtype).float()
    return p @ vr, p @ vr.abs()


def k5_f32_scores_check(torch, q, k, v, o, win, label):
    """bf16 K5's output ``o`` held to attention from f32 scores, K5's own
    rounding: p and o are each rounded once to bf16 (relative error <=
    2^-8) in K5 and p once in the reference, so |o - o32| <= 2^-8 (|o32| +
    2 p@|v|) up to f32 noise.  Returns the error, its largest ratio to the
    bound and the largest bound."""
    o32, pv_abs = attention_f32_scores(torch, q, k, v, win)
    d32 = (o.float() - o32).abs()
    bound = BF16_U * (o32.abs() + 2.0 * pv_abs) + ATTN_TOL["float32"]
    ratio = float((d32 / bound).max())
    check(ratio <= 1.0, f"{label}: |o - o32| beyond 2^-8 (|o32| + 2 p@|v|), "
                        f"{ratio:.3g} x the bound")
    return {"max_abs_err": float(d32.max()), "max_err_over_bound": ratio,
            "max_bound": float(bound.max())}


# K5's timed fixtures (bf16, the prefill shapes of phases 4, 5 and 7) and
# the key each one's timing goes under
K5_TIMED = {"prefill_bf16": "timing", "moe_prefill_bf16": "timing_moe",
            "zamba2_prefill_bf16": "timing_zamba2"}


def k5_timing(torch, q, k, v, win, r, flush):
    """K5 on bf16 q, k, v (window ``win``; ``r`` its plain version's output)
    timed beside its bound, the plain version and
    ``scaled_dot_product_attention`` (causal, GQA), each also as device time
    alone."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, H, S, hd = q.shape
    ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, win), 10, flush)
    device_ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, win), 10, flush, busy=True)
    plain_ms = cuda_ms(torch, lambda: ref.flash_attention_ref(q, k, v, win), 3, flush)
    check(win == 0 or win >= S, f"K5 at {tuple(q.shape)}: SDPA's causal mask is not window {win}")
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,  # noqa: E731
                                                  enable_gqa=True)
    library_ms = cuda_ms(torch, sdpa, 10, flush)
    library_device_ms = cuda_ms(torch, sdpa, 10, flush, busy=True)
    lib_err = float((sdpa().float() - r.float()).abs().max())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()   # q, k, v and o
    # causal (query, key) pairs within the window (0: none)
    pairs = sum(min(i + 1, win) if win > 0 else i + 1 for i in range(S))
    ops_ = 4 * B * H * hd * pairs       # q.k and p.v, 2 operations per mul-add
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_ / BF16_FLOPS * 1e3
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "library_max_abs_err": lib_err, "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "bytes": nbytes, "operations": ops_}


def phase_k5(torch, dev, flush):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    _, cfg = full_width_config()
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    out = {}
    for label, (B, H, KV, S, hd, win, dt) in attention_shapes(cfg).items():
        dtype = getattr(torch, dt)
        q = torch.randn((B, H, S, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((B, KV, S, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((B, KV, S, hd), generator=g, device=dev).to(dtype)
        o = fa.flash_attention(q, k, v, win)
        r = ref.flash_attention_ref(q, k, v, win)
        torch.cuda.synchronize()
        diff = (o.float() - r.float()).abs()
        tol = ATTN_TOL[dt]
        check(bool(torch.isfinite(o).all()) and o.shape == r.shape, f"K5 {label}: bad output")
        check(bool((diff <= tol + tol * r.float().abs()).all()),
              f"K5 {label}: max |o - ref| {float(diff.max()):.3g} beyond tol {tol}")
        out[label] = {"shape": [B, H, KV, S, hd], "window": win, "dtype": dt,
                      "max_abs_err": float(diff.max()), "tol": tol}
        if dtype == torch.bfloat16:
            out[label]["f32_scores"] = k5_f32_scores_check(torch, q, k, v, o, win,
                                                           f"K5 {label}")
        if label not in K5_TIMED:
            continue
        out[K5_TIMED[label]] = k5_timing(torch, q, k, v, win, r, flush)
        del q, k, v, o, r
    return out


TTFT_REPEATS = 3


def ttft_repeats(eng, prompts, first_s):
    """Time to first token: ``ttft_s`` is the serve's own (``first_s``, the
    serve's first prefill, as in earlier versions of this script);
    ``ttft_median_s`` the median of it and TTFT_REPEATS - 1 more prefills
    and first picks of the same prompts (``Engine.generate`` with one step,
    host clock ending in a device sync), with every run and their spread."""
    runs = [first_s]
    for _ in range(TTFT_REPEATS - 1):
        eng.generate(prompts, 1)
        runs.append(eng.last_timing["prefill_s"])
    return {"ttft_s": first_s, "ttft_median_s": statistics.median(runs), "ttft_runs_s": runs,
            "ttft_spread_s": max(runs) - min(runs)}


def phase_generate(torch, dev, out_dir):
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import init_cache
    from repro_torch.serving import Engine, make_prefill

    full, cfg = full_width_config()
    emit({"reduced": {"arch": cfg.name, "num_layers": [full.num_layers, cfg.num_layers],
                      "serve": {"batch": GEN_BATCH, "prompt_len": GEN_PROMPT,
                                "steps": GEN_STEPS}}})
    eos = cfg.vocab_size                     # never emitted: launch counts are fixed
    torch.cuda.synchronize()
    sa.sa_sweep_many.launches = 0
    bl.reset_counts()
    fa.flash_attention.launches = 0
    autotune.clear_log()
    hooks = ops.kernel_hooks()
    res = serve_model(cfg, ckpt_dir=out_dir, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
                      steps=GEN_STEPS, eos_id=eos, seed=SEED, device=dev, verbose=False)
    torch.cuda.synchronize()
    # the Engine held its kernels to its own work
    check(ops.kernel_hooks() == hooks and res.engine.kernel_hooks != hooks,
          f"phase 4: the process's hooks {ops.kernel_hooks()} after the serve, "
          f"{hooks} before it")
    launches = {"flash_attention": fa.flash_attention.launches,
                "bitlinear": bl.bitlinear.launches, "sa_sweep_many": sa.sa_sweep_many.launches}
    by_schedule = served(bl.bitlinear)
    eng = res.engine
    tensor_cores, clusters = heuristic_launches(torch, dev, eng.artifact.manifest,
                                                {"bitlinear": by_schedule}, qwen_tokens,
                                                "phase 4")
    n_tensors = eng.compression["tensors"]
    check(launches["flash_attention"] == cfg.num_layers,
          f"K5 launched {launches['flash_attention']} times, want {cfg.num_layers}")
    check(launches["bitlinear"] == n_tensors * GEN_STEPS,
          f"K3 launched {launches['bitlinear']} times, want {n_tensors} x {GEN_STEPS}")
    check(launches["sa_sweep_many"] == 0, "serving launched the annealer")
    ttft = ttft_repeats(eng, res.prompts, res.timing["prefill_s"])
    toks = res.tokens
    check(tuple(toks.shape) == (GEN_BATCH, GEN_PROMPT + GEN_STEPS)
          and torch.equal(toks[:, :GEN_PROMPT], res.prompts)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"generated tokens {tuple(toks.shape)} out of shape or range")

    # prefill logits with the kernels against the plain path on the same prompts
    max_len = GEN_PROMPT + GEN_STEPS
    with torch.inference_mode():
        lk, _ = eng.prefill(eng.params, {"tokens": res.prompts},
                            init_cache(cfg, GEN_BATCH, max_len, device=dev))
        with ops.kernels_off():
            lp, _ = make_prefill(cfg)(eng.params, {"tokens": res.prompts},
                                      init_cache(cfg, GEN_BATCH, max_len, device=dev))
    lk, lp = lk.float(), lp.float()
    check(bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all()),
          "prefill logits are not finite")
    scale = float(lp.abs().max())
    err = float((lk - lp).abs().max())
    check(err <= LOGIT_TOL * scale,
          f"prefill logits kernels vs plain: {err:.3g} > {LOGIT_TOL} x {scale:.3g}")
    before = (fa.flash_attention.launches, bl.bitlinear.launches)
    plain = Engine(cfg, eng.params, max_len=max_len, batch=GEN_BATCH, eos_id=eos,
                   artifact=eng.artifact, use_fused_bitlinear=False)
    toks_plain = plain.generate(res.prompts, GEN_STEPS)
    check((fa.flash_attention.launches, bl.bitlinear.launches) == before,
          "the plain path launched a kernel")
    same = (toks[:, GEN_PROMPT:] == toks_plain[:, GEN_PROMPT:]).float()
    t = res.timing
    out = {
        "launches": launches,
        "bitlinear_by_schedule": by_schedule,
        "tensor_core_launches": tensor_cores,
        "decode_clusters": clusters,
        **ttft,
        "decode_ms_per_step": 1e3 * t["decode_s"] / t["decode_steps"],
        "decode_tokens_per_s": GEN_BATCH * t["decode_steps"] / t["decode_s"],
        "generate_wall_s": res.wall_s,
        "prefill_logits": {"max_abs_diff": err, "max_abs_logit": scale,
                           "tol": LOGIT_TOL * scale},
        "greedy_agreement": {"first_token": float(same[:, 0].mean()),
                             "all_tokens": float(same.mean())},
        "plain_timing": plain.last_timing,
        "compression": eng.compression,
    }
    emit({"generate": out})
    return out


# the tuned-serving phase: tune_artifact at phase 4's decode and prefill rows
TUNE_T = (GEN_BATCH, GEN_BATCH * GEN_PROMPT)
TUNE_REPEATS, TUNE_ITERS = 3, 3


def layer_slices(path, e):
    """How many times one forward calls a compressed tensor: once per layer
    of its stack (a remainder layer's or an unstacked tensor's once)."""
    return e["group_dims"][0] if e.get("group_dims") else 1


def implied_launches(manifest, schedules, dev, tokens, tensor_cores=False, clusters=False,
                     uses=layer_slices, steps=GEN_STEPS):
    """{kind: {"mode/math": n}}: the launches a serve of ``steps`` tokens
    makes when each call signature runs ``schedules[key]`` (a table's
    entries, or what a serve's resolution log says it resolved).  Per
    compressed tensor and each of its ``uses(path, entry)`` calls a
    forward: one prefill call and ``steps`` - 1 decode calls, at the T that
    ``tokens(path, kind)`` gives as (prefill, decode).  With
    ``tensor_cores``, {kind: n}: the grid launches that must run the grid's
    tensor-core body (``bitlinear.grid_on_tensor_cores``; the served tensors
    are bf16).  With ``clusters``, {kind: {S: n}}: the decode launches by the
    cluster size S the rule gives their shape."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import bitlinear as bl

    want = {}
    for path, e in manifest["tensors"].items():
        E, n_r, n_c, tn, _, K, td, dname = autotune._entry_geometry(e)
        kind = "bitlinear_grouped" if E else "bitlinear"
        layers = uses(path, e)
        for T, n in zip(tokens(path, kind), (1, steps - 1)):
            key = autotune.schedule_key(kind, n_r=n_r, n_c=n_c, tn=tn, K=K, td=td, T=T,
                                        dtype=dname, E=E, device=autotune.device_kind(dev),
                                        mode=autotune.pallas_mode(dev))
            s = schedules[key]
            if clusters:
                if s["mode"] == "decode":
                    S = bl.decode_cluster_size(max(E, 1) * n_c, n_r, bl.device_sms(dev))
                    counts = want.setdefault(kind, {})
                    counts[S] = counts.get(S, 0) + n * layers
                continue
            if tensor_cores:
                size = 2 if dname == "bfloat16" else 4
                on_mma = s["mode"] == "grid" and bl.grid_on_tensor_cores(T, tn, K, td, size,
                                                                         size)
                want[kind] = want.get(kind, 0) + n * layers * on_mma
                continue
            k = f"{s['mode']}/{s['math']}"
            counts = want.setdefault(kind, {})
            counts[k] = counts.get(k, 0) + n * layers
    return want


def qwen_tokens(path, kind):
    """phase 4's T per call: 4096 at prefill (the head runs on the last
    position, T = 4) and 4 at decode."""
    return (GEN_BATCH if path == "head/w" else GEN_BATCH * GEN_PROMPT, GEN_BATCH)


def served(fn):
    """A wrapper's non-zero launches per "mode/math"."""
    return {k: v for k, v in fn.by_schedule.items() if v}


def resolved_schedules():
    """key -> schedule of every resolution in the autotuner's log."""
    from repro_torch.kernels import autotune

    return {r["key"]: r["schedule"] for r in autotune.last_resolutions()}


def tuned_serve(torch, dev, out_dir, cfg, tokens):
    """``tune_artifact`` on the checkpoint's artifact at TUNE_T, the table
    saved into its manifest, then ``serve_model`` from that checkpoint, the
    Engine installing the table.  Every resolution must come from the
    table, and each kernel's launches per schedule must be what the table
    picked; the tuner's trial launches are counted apart."""
    from repro_torch.compression import CompressionArtifact
    from repro_torch.kernels import autotune
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve_model

    kinds = {"bitlinear": bl.bitlinear, "bitlinear_grouped": bl.bitlinear_grouped}
    eos = cfg.vocab_size                     # never emitted: launch counts are fixed
    art = CompressionArtifact.load(out_dir)
    autotune.clear_schedules()
    autotune.clear_log()
    torch.cuda.synchronize()
    bl.reset_counts()
    fa.flash_attention.launches = 0
    t = time.time()
    trials = {}
    table = autotune.tune_artifact(art, T_values=TUNE_T, repeats=TUNE_REPEATS,
                                   iters=TUNE_ITERS, device=dev, trials_out=trials)
    torch.cuda.synchronize()
    tune_s = time.time() - t
    tuning = {k: served(fn) for k, fn in kinds.items()}
    entries = table["entries"]
    check(entries and all(e["mode"] != "jnp" for e in entries.values()),
          f"tuned table {entries}")
    art.save(out_dir)
    autotune.clear_schedules()               # the Engine installs the table from the manifest
    autotune.clear_log()
    bl.reset_counts()
    res = serve_model(cfg, ckpt_dir=out_dir, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
                      steps=GEN_STEPS, eos_id=eos, seed=SEED, device=dev, verbose=False)
    torch.cuda.synchronize()
    serving = {k: served(fn) for k, fn in kinds.items() if fn.launches}
    eng = res.engine
    log = autotune.last_resolutions()
    check(eng.kernel_schedules == len(entries)
          and eng.compression.get("kernel_schedules") == len(entries),
          f"Engine installed {eng.kernel_schedules} schedules of {len(entries)}")
    check(log and all(r["source"] == "cache" for r in log),
          f"resolutions not from the cache: {[r for r in log if r['source'] != 'cache']}")
    check({r["key"] for r in log} <= set(entries), "a resolution's key is not in the table")
    want = implied_launches(art.manifest, entries, dev, tokens)
    check(serving == want, f"launches per schedule {serving}, the table implies {want}")
    tensor_core_launches(manifest=art.manifest, schedules=entries, dev=dev, tokens=tokens,
                         label="tuned serve")
    clusters = cluster_launches(art.manifest, entries, dev, tokens, "tuned serve")
    check(fa.flash_attention.launches == cfg.num_layers,
          f"K5 launched {fa.flash_attention.launches} times, want {cfg.num_layers}")
    toks = res.tokens
    check(tuple(toks.shape) == (GEN_BATCH, GEN_PROMPT + GEN_STEPS)
          and torch.equal(toks[:, :GEN_PROMPT], res.prompts)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"tuned generated tokens {tuple(toks.shape)} out of shape or range")
    t = res.timing
    out = {
        "tune_s": tune_s, "signatures": len(entries),
        "winners": {k: "{mode}/{math} bt={block_t} rc={r_chunk}".format(**e)
                    for k, e in entries.items()},
        "trials": {k: [[tr["schedule"]["mode"], tr["schedule"]["math"],
                        tr["schedule"]["block_t"], tr["schedule"]["r_chunk"],
                        round(tr["seconds"] * 1e6, 1), bool(tr.get("plain"))]
                       for tr in v if "seconds" in tr] for k, v in trials.items()},
        "launches_tuning": tuning, "launches_serving": serving, "resolutions": len(log),
        "decode_clusters": clusters,
        "ttft_s": t["prefill_s"],
        "decode_ms_per_step": 1e3 * t["decode_s"] / t["decode_steps"],
    }
    return res, out


def tensor_core_launches(manifest, schedules, dev, tokens, label, uses=layer_slices,
                         steps=GEN_STEPS):
    """Every grid launch of a serve that the rule puts on the tensor cores
    ran the tensor-core body, by the library's own report
    (``tensor_core_launches``), and no other launch did.  Returns {kind: n}."""
    from repro_torch.kernels import bitlinear as bl

    fns = {"bitlinear": bl.bitlinear, "bitlinear_grouped": bl.bitlinear_grouped}
    want = implied_launches(manifest, schedules, dev, tokens, tensor_cores=True, uses=uses,
                            steps=steps)
    got = {k: fns[k].tensor_core_launches for k in want}
    check(got == want and all(fn.tensor_core_launches == got.get(k, 0)
                              for k, fn in fns.items()),
          f"{label}: tensor-core launches {got}, the grid launches the rule puts on the "
          f"tensor cores number {want}")
    return got


def cluster_launches(manifest, schedules, dev, tokens, label, uses=layer_slices,
                     steps=GEN_STEPS):
    """Every decode launch of a serve ran with the cluster size S that the
    rule gives its shape, by the library's own report (``decode_clusters``).
    Returns {kind: {S: n}}."""
    from repro_torch.kernels import bitlinear as bl

    fns = {"bitlinear": bl.bitlinear, "bitlinear_grouped": bl.bitlinear_grouped}
    want = implied_launches(manifest, schedules, dev, tokens, clusters=True, uses=uses,
                            steps=steps)
    got = {k: dict(fn.decode_clusters) for k, fn in fns.items() if fn.decode_clusters}
    check(got == {k: v for k, v in want.items() if v},
          f"{label}: decode launches by cluster size {got}, the rule gives {want}")
    return got


def heuristic_launches(torch, dev, manifest, by_kind, tokens, label, uses=layer_slices,
                       steps=GEN_STEPS):
    """A serve without a table launched, per kernel and schedule, what its
    resolutions (the default rule) picked, its grid on the tensor cores
    where the rule puts it there and its decode at the rule's cluster
    sizes.  Returns the tensor-core launches per kernel and the decode
    launches per kernel and cluster size."""
    from repro_torch.kernels import autotune

    log = autotune.last_resolutions()
    check(log and all(r["source"] == "heuristic" for r in log),
          f"{label}: resolutions {[r['source'] for r in log]}, want the default rule")
    want = implied_launches(manifest, resolved_schedules(), dev, tokens, uses=uses, steps=steps)
    check(by_kind == want, f"{label}: launches per schedule {by_kind}, its resolutions imply "
                           f"{want}")
    return (tensor_core_launches(manifest, resolved_schedules(), dev, tokens, label, uses,
                                 steps),
            cluster_launches(manifest, resolved_schedules(), dev, tokens, label, uses, steps))


def phase_tuned_generate(torch, dev, out_dir, heuristic):
    """This slice's main path on qwen3-32b: phase 4's serve again, tuned
    (``tuned_serve``); its prefill logits must agree with the plain path."""
    from repro_torch.kernels import autotune, ops
    from repro_torch.models import init_cache
    from repro_torch.serving import make_prefill

    _, cfg = full_width_config()
    res, out = tuned_serve(torch, dev, out_dir, cfg, qwen_tokens)
    eng = res.engine
    max_len = GEN_PROMPT + GEN_STEPS
    with torch.inference_mode():
        lk, _ = eng.prefill(eng.params, {"tokens": res.prompts},
                            init_cache(cfg, GEN_BATCH, max_len, device=dev))
        with ops.kernels_off():
            lp, _ = make_prefill(cfg)(eng.params, {"tokens": res.prompts},
                                      init_cache(cfg, GEN_BATCH, max_len, device=dev))
    lk, lp = lk.float(), lp.float()
    check(bool(torch.isfinite(lk).all()), "tuned prefill logits are not finite")
    scale = float(lp.abs().max())
    err = float((lk - lp).abs().max())
    check(err <= LOGIT_TOL * scale,
          f"tuned prefill logits vs plain: {err:.3g} > {LOGIT_TOL} x {scale:.3g}")
    autotune.clear_schedules()
    autotune.clear_log()
    out.update({
        "ttft_s_heuristic": heuristic["ttft_s"],
        "decode_ms_per_step_heuristic": heuristic["decode_ms_per_step"],
        "heuristic_launches": heuristic["bitlinear_by_schedule"],
        "prefill_logits": {"max_abs_diff": err, "max_abs_logit": scale,
                           "tol": LOGIT_TOL * scale},
    })
    emit({"tuned_generate": out})
    return out


MOE_ARCH = "granite-moe-1b-a400m"


def moe_config():
    """granite-moe-1b-a400m at its published widths and depth, bf16."""
    from repro_torch.configs import get_config

    return get_config(MOE_ARCH)


def k4_tokens(cfg):
    """K4's T per expert in phase 5: decode routes each row's one token
    alone (capacity 1), prefill routes 1024-token blocks (capacity 320)."""
    from repro_torch.models.moe import ROUTE_BLOCK, moe_capacity

    return {"decode": GEN_BATCH * moe_capacity(cfg, 1),
            "prefill": GEN_BATCH * moe_capacity(cfg, min(GEN_PROMPT, ROUTE_BLOCK))}


def k4_fixtures(cfg):
    """label -> (E, n_r, n_c, tn, K, td, T, dtype).  The expert stacks at
    the default policy's tile 32x128, K = 4 at both T of phase 5 and in
    both dtypes; then ragged T, E = 1, K in {3, 9} and narrow td."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    stacks = {"gate": (d, ff), "up": (d, ff), "down": (ff, d)}
    out = {}
    for dt in ("bfloat16", "float32"):
        for phase, T in k4_tokens(cfg).items():
            for name, (d_in, d_out) in stacks.items():
                out[f"{name}_{phase}_{dt}"] = (E, d_in // 32, d_out // 128, 32, 4, 128, T, dt)
    out.update({
        "ragged_e1_k3_f32": (1, 4, 3, 32, 3, 128, 13, "float32"),
        "ragged_e1_k9_bf16": (1, 2, 2, 16, 9, 96, 13, "bfloat16"),
        "ragged_k9_td48_f32": (5, 3, 2, 16, 9, 48, 13, "float32"),
        "e3_k3_t1_bf16": (3, 4, 2, 32, 3, 128, 1, "bfloat16"),
    })
    return out


def phase_k4(torch, dev, flush):
    from repro_torch.core import quantized
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels import bitlinear as bl

    cfg = moe_config()
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    out, timed, max_err = {}, [], 0.0
    for label, (E, n_r, n_c, tn, K, td, T, dt) in k4_fixtures(cfg).items():
        dtype = getattr(torch, dt)
        mp = torch.randint(0, 256, (E, n_r, n_c, tn, (K + 7) // 8), generator=g, device=dev,
                           dtype=torch.uint8)
        C = (torch.randn((E, n_r, n_c, K, td), generator=g, device=dev) * 0.2).to(dtype)
        x = torch.randn((E, T, n_r * tn), generator=g, device=dev).to(dtype)
        # the schedule a served call of these shapes resolves (no table: the default rule)
        sched = autotune.resolve_grouped(x, mp, C)
        kw = sched.kwargs()
        before = bl.bitlinear_grouped.launches
        yk = bl.bitlinear_grouped(x, mp, C, **kw)
        torch.cuda.synchronize()
        check(bl.bitlinear_grouped.launches == before + 1, f"K4 {label}: not launched once")
        yp = ref.bitlinear_grouped_ref(x, mp, C, sched.math)
        check(bool(torch.isfinite(yk).all()) and yk.shape == yp.shape and yk.dtype == x.dtype,
              f"K4 {label}: bad output")
        diff = (yk.float() - yp.float()).abs()
        err, scale = float(diff.max()), float(yp.float().abs().max())
        if dtype == torch.bfloat16:
            tol = BF16_TOL * scale
            check(err <= tol, f"K4 {label}: |y - plain| {err:.3g} > {BF16_TOL} x {scale:.3g}")
        else:      # as tests/test_torch_bitlinear.py: rtol = atol = 1e-4
            tol = 1e-4
            check(bool((diff <= 1e-4 + 1e-4 * yp.float().abs()).all()),
                  f"K4 {label}: |y - plain| {err:.3g} beyond 1e-4 + 1e-4 |plain|")
        max_err = max(max_err, err)
        out[label] = {"shape": [E, n_r, n_c, tn, K, td], "T": T, "dtype": dt,
                      "schedule": f"{sched.mode}/{sched.math}", "max_abs_err": err, "tol": tol,
                      "max_abs_y": scale}
        if dt != "bfloat16" or label.split("_")[0] not in ("gate", "up", "down"):
            continue
        w_dense = quantized.decompress({"m_packed": mp, "C": C}, torch.bfloat16)
        ms = cuda_ms(torch, lambda: bl.bitlinear_grouped(x, mp, C, **kw), 10, flush)
        device_ms = cuda_ms(torch, lambda: bl.bitlinear_grouped(x, mp, C, **kw), 10, flush,
                            busy=True)
        plain_ms = cuda_ms(torch, lambda: ref.bitlinear_grouped_ref(x, mp, C, sched.math), 3,
                           flush)
        library_ms = cuda_ms(torch, lambda: torch.bmm(x, w_dense), 10, flush)
        library_device_ms = cuda_ms(torch, lambda: torch.bmm(x, w_dense), 10, flush, busy=True)
        nbytes = mp.numel() + C.numel() * C.element_size() + (x.numel() + yk.numel()) * 2
        ops_ = 2 * E * T * (n_r * tn * n_c * K + n_r * n_c * K * td)
        b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_ / BF16_FLOPS * 1e3
        row = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library_device_ms": library_device_ms, "bound_ms": max(b_bytes, b_ops),
               "bound_by": "bytes" if b_bytes >= b_ops else "operations",
               "bytes": nbytes, "operations": ops_}
        out[label].update(row)
        timed.append(row)
        del w_dense
    # the kernels line sums phase 5's six distinct (stack, T) calls, each once
    total = {k: sum(r[k] for r in timed) for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                                   "library_device_ms", "bound_ms")}
    b = sum(r["bytes"] for r in timed) / HBM_BYTES_PER_S
    o = sum(r["operations"] for r in timed) / BF16_FLOPS
    total.update({"calls": len(timed), "bound_by": "bytes" if b >= o else "operations",
                  "max_abs_err": max_err})
    out["timing"] = total
    return out


def phase_k4_variants(torch, dev, flush):
    """K4's schedules (grid, decode), bit algebras and activation dtypes
    against the plain version at granite-moe's expert stacks and phase 5's
    T per expert; then each mode x math timed in bf16 over phase 5's six
    distinct (stack, T) calls beside its bound, the plain version of the
    same math and a dense bf16 ``torch.bmm``."""
    from repro_torch.core import quantized
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import ref

    cfg = moe_config()
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    stacks = {"gate": (d, ff), "up": (d, ff), "down": (ff, d)}
    errs, checks = {}, {}
    timed = {f"{m}/{a}": [] for m in ("grid", "decode") for a in MATHS}
    budget = bl.device_smem_budget(dev)
    stacks_ops = []
    for name, (d_in, d_out) in stacks.items():
        n_r, n_c, tn, K, td = d_in // 32, d_out // 128, 32, 4, 128
        mp = torch.randint(0, 256, (E, n_r, n_c, tn, 1), generator=g, device=dev,
                           dtype=torch.uint8)
        C0 = torch.randn((E, n_r, n_c, K, td), generator=g, device=dev) * 0.2
        stacks_ops.append(((E,), mp, C0.to(torch.bfloat16)))
        for phase, T in k4_tokens(cfg).items():
            label = f"{name}_{phase}"
            ran = 0
            for xd in XDTYPES:
                for cd in CDTYPES:
                    x, C = variant_inputs(torch, g, dev, (E, T, d_in), C0, xd, cd, tn)
                    ran += hold_variants(torch, bl.bitlinear_grouped, ref.bitlinear_grouped_ref,
                                         label, x, mp, C, xd, cd, ("grid", "decode"), errs)
            checks[label] = {"shape": [E, n_r, n_c, tn, K, td], "T": T, "variants_held": ran}
            x = torch.randn((E, T, d_in), generator=g, device=dev).to(torch.bfloat16)
            C = C0.to(torch.bfloat16)
            w_dense = quantized.decompress({"m_packed": mp, "C": C}, torch.bfloat16)
            library_ms = cuda_ms(torch, lambda: torch.bmm(x, w_dense), 10, flush)
            library_device_ms = cuda_ms(torch, lambda: torch.bmm(x, w_dense), 10, flush,
                                        busy=True)
            del w_dense
            nbytes = mp.numel() + C.numel() * 2 + E * T * (d_in + d_out) * 2
            ops_ = 2 * E * T * (n_r * tn * n_c * K + n_r * n_c * K * td)
            b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_ / BF16_FLOPS * 1e3
            for math in MATHS:
                plain_ms = cuda_ms(torch, lambda: ref.bitlinear_grouped_ref(x, mp, C, math), 3,
                                   flush)
                for mode in ("grid", "decode"):
                    if mode == "decode" and not bl.decode_path_ok(T, n_r, tn, K, td, 2,
                                                                   budget):
                        continue
                    ms, device_ms = (cuda_ms(torch, lambda: bl.bitlinear_grouped(
                        x, mp, C, mode=mode, math=math), 10, flush, busy=busy)
                        for busy in (False, True))
                    timed[f"{mode}/{math}"].append(
                        {"T": T, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "library_device_ms": library_device_ms,
                         "bound_ms": max(b_bytes, b_ops), "bytes_ms": b_bytes, "ops_ms": b_ops,
                         **decode_call(bl, dev, mode, name, E, n_c, n_r, b_bytes, device_ms)})
    out = {"checks": checks, "max_abs_err": errs, "timing": sum_variants(timed),
           "decode_calls": decode_calls(timed),
           "small_t_ms": sweep_small_t(torch, g, dev, bl.bitlinear_grouped, stacks_ops,
                                       ("grid", "decode"), SWEEP_T, flush)}
    emit({"k4_variants": out})
    return out


def phase_moe_compress(torch, dev, out_dir):
    from repro_torch.compression import CompressionPolicy
    from repro_torch.compression.execute import EIGH_MAX_BATCH
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.launch.compress import compress_model
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    cfg = moe_config()
    emit({"moe_config": {"arch": cfg.name, "num_layers": cfg.num_layers,
                         "widths": "published (d_model 1024, 16x64 q heads, 8 kv heads, "
                                   "32 experts top-8 of d_ff 512, vocab 49155, tied, bf16)",
                         "reduced": []}})
    values, _ = split(init_model(cfg, seed=SEED, device=dev))
    torch.cuda.synchronize()
    sa.sa_sweep_many.launches = 0
    bl.reset_counts()
    t0 = time.time()
    _, artifact = compress_model(cfg, CompressionPolicy(), out_dir, seed=SEED, device=dev,
                                 values=values, verbose=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    check((sa.sa_sweep_many.launches, bl.bitlinear.launches,
           bl.bitlinear_grouped.launches) == (0, 0, 0), "compression launched a kernel")
    m = artifact.manifest
    L, E = cfg.num_layers, cfg.num_experts
    d, q, kv = cfg.d_model, cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    want_tiles = L * (2 * d * q + 2 * d * kv + 3 * E * d * cfg.d_ff) // (32 * 128)
    (pool,) = m["pools"]
    check(pool["num_tiles"] == want_tiles == 313344,
          f"pool of {pool['num_tiles']} tiles, want {want_tiles}")
    check(pool["chunk_policy"] == "auto" and max(pool["chunk_sizes"]) <= EIGH_MAX_BATCH
          and pool["chunks"] == -(-pool["num_tiles"] // EIGH_MAX_BATCH),
          f"auto chunking gave {pool['chunks']} chunks of at most "
          f"{max(pool['chunk_sizes'])} tiles (bound {EIGH_MAX_BATCH})")
    grouped = {p: e for p, e in m["tensors"].items() if "/moe/" in p}
    check(sorted(p.rsplit("/", 1)[1] for p in grouped) == ["down", "gate", "up"]
          and all(e["group_dims"] == [L, E] for e in grouped.values())
          and len(m["tensors"]) == 7, f"compressed tensors {sorted(m['tensors'])}")
    out = {"wall_s": wall, "pool": {k: pool[k] for k in ("num_tiles", "chunks", "tile_n",
                                                          "tile_d", "K", "method")},
           "max_chunk": max(pool["chunk_sizes"]), "eigh_max_batch": EIGH_MAX_BATCH,
           "tensors": {p: {"rel_err": e["rel_err"], "ratio": e["orig_bytes"] / e["new_bytes"],
                           "group_dims": e["group_dims"]} for p, e in m["tensors"].items()},
           "totals": m["totals"]}
    emit({"moe_compress": out})
    return out


def _expert_sets(torch, h, router, k):
    """Each token's top-k expert set (sorted indices) from the MoE input."""
    probs = torch.softmax(h.float() @ router.float(), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.sort(idx, dim=-1)[0]


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def _to_f64(tree):
    if isinstance(tree, dict):
        return {k: _to_f64(v) for k, v in tree.items()}
    return tree.double() if tree.is_floating_point() else tree


def moe_prefill(torch, cfg, params, prompts, dev, setup):
    """The last-position prefill logits (f32) after ``setup()`` chose the
    path (e.g. ``ops.enable_kernels``), each MoE block's per-token expert
    sets (read from its input by wrapping ``moe_block``), and the kernel
    launches the prefill made."""
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_cache, moe
    from repro_torch.serving.engine import make_prefill

    block, sets = moe.moe_block, []

    def tap(h, p, c):
        sets.append(_expert_sets(torch, h, p["router"], c.experts_per_token))
        return block(h, p, c)

    def counts():
        return {"bitlinear": bl.bitlinear.launches,
                "bitlinear_grouped": bl.bitlinear_grouped.launches,
                "flash_attention": fa.flash_attention.launches}

    setup()
    before = counts()
    moe.moe_block = tap
    try:
        with torch.inference_mode():
            logits, _ = make_prefill(cfg)(params, {"tokens": prompts},
                                          init_cache(cfg, prompts.shape[0], prompts.shape[1],
                                                     device=dev))
    finally:
        moe.moe_block = block
    check(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
    return logits.float(), sets, {k: v - before[k] for k, v in counts().items()}


def moe_prefill_pair(torch, cfg, params, prompts, dev):
    """Prefill with the kernels and on the plain path (kernels disabled):
    the logits' distance, the kernel prefill's launches and, per layer, the
    tokens whose expert set differs between the two."""
    from repro_torch.kernels import ops

    lk, sk, launched = moe_prefill(torch, cfg, params, prompts, dev, ops.enable_kernels)
    lp, sp, _ = moe_prefill(torch, cfg, params, prompts, dev, ops.disable_kernels)
    return {"max_abs_diff": float((lk - lp).abs().max()),
            "max_abs_logit": float(lp.abs().max()), "kernel_launches": launched,
            "expert_sets_differ": [int((a != b).any(-1).sum()) for a, b in zip(sk, sp)]}


def moe_tokens(path, kind):
    """phase 5's T per call: K3 at 4096 (prefill) and 4 (decode); K4 per
    expert at its capacities (k4_tokens)."""
    if kind == "bitlinear":
        return GEN_BATCH * GEN_PROMPT, GEN_BATCH
    t = k4_tokens(moe_config())
    return t["prefill"], t["decode"]


def phase_moe_generate(torch, dev, out_dir):
    from repro_torch.kernels import autotune
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.launch.serve import serve_model
    from repro_torch.serving import Engine

    cfg = moe_config()
    L, steps = cfg.num_layers, GEN_STEPS
    eos = cfg.vocab_size                     # never emitted: launch counts are fixed
    torch.cuda.synchronize()
    sa.sa_sweep_many.launches = 0
    bl.reset_counts()
    fa.flash_attention.launches = 0
    autotune.clear_log()
    res = serve_model(cfg, ckpt_dir=out_dir, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
                      steps=steps, eos_id=eos, seed=SEED, device=dev, verbose=False)
    torch.cuda.synchronize()
    launches = {"bitlinear_grouped": bl.bitlinear_grouped.launches,
                "bitlinear": bl.bitlinear.launches,
                "flash_attention": fa.flash_attention.launches,
                "sa_sweep_many": sa.sa_sweep_many.launches}
    by_schedule = {"bitlinear": served(bl.bitlinear),
                   "bitlinear_grouped": served(bl.bitlinear_grouped)}
    want = {"bitlinear_grouped": 3 * L * steps, "bitlinear": 4 * L * steps,
            "flash_attention": L, "sa_sweep_many": 0}
    check(launches == want, f"launches {launches}, want {want}")
    eng = res.engine
    tensor_cores, clusters = heuristic_launches(torch, dev, eng.artifact.manifest, by_schedule,
                                                moe_tokens, "phase 5")
    ttft = ttft_repeats(eng, res.prompts, res.timing["prefill_s"])
    check(eng.compression["grouped_tensors"] == 3, f"compression {eng.compression}")
    toks = res.tokens
    check(tuple(toks.shape) == (GEN_BATCH, GEN_PROMPT + steps)
          and torch.equal(toks[:, :GEN_PROMPT], res.prompts)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"generated tokens {tuple(toks.shape)} out of shape or range")

    # prefill logits with the kernels against the plain path.  In bf16 the
    # two differ in where they round, which flips near-tied router choices;
    # the flips cascade through 24 random layers (PERF.md, PR 13), so bf16 is
    # reported and the check is made on the same checkpoint cast to f32
    bf16 = moe_prefill_pair(torch, cfg, eng.params, res.prompts, dev)
    f32 = moe_prefill_pair(torch, dataclasses.replace(cfg, dtype="float32"),
                           _to_f32(eng.params), res.prompts, dev)
    want_prefill = {"bitlinear": 4 * L, "bitlinear_grouped": 3 * L, "flash_attention": L}
    for name, pair in (("bf16", bf16), ("f32", f32)):
        check(pair.pop("kernel_launches") == want_prefill,
              f"{name} prefill did not run every kernel once per layer")
    check(f32["max_abs_diff"] <= LOGIT_TOL * f32["max_abs_logit"],
          f"f32 prefill logits kernels vs plain: {f32['max_abs_diff']:.3g} > "
          f"{LOGIT_TOL} x {f32['max_abs_logit']:.3g}")

    before = (fa.flash_attention.launches, bl.bitlinear.launches,
              bl.bitlinear_grouped.launches)
    plain = Engine(cfg, eng.params, max_len=GEN_PROMPT + steps, batch=GEN_BATCH, eos_id=eos,
                   artifact=eng.artifact, use_fused_bitlinear=False)
    toks_plain = plain.generate(res.prompts, steps)
    check((fa.flash_attention.launches, bl.bitlinear.launches,
           bl.bitlinear_grouped.launches) == before, "the plain path launched a kernel")
    same = (toks[:, GEN_PROMPT:] == toks_plain[:, GEN_PROMPT:]).float()
    t = res.timing
    out = {
        "launches": launches,
        "by_schedule": by_schedule,
        "tensor_core_launches": tensor_cores,
        "decode_clusters": clusters,
        **ttft,
        "decode_ms_per_step": 1e3 * t["decode_s"] / t["decode_steps"],
        "decode_tokens_per_s": GEN_BATCH * t["decode_steps"] / t["decode_s"],
        "generate_wall_s": res.wall_s,
        "prefill_logits_f32": dict(f32, tol=LOGIT_TOL * f32["max_abs_logit"]),
        "prefill_logits_bf16": bf16,
        "first_layer_expert_sets_differ": {"tokens": bf16["expert_sets_differ"][0],
                                           "of": GEN_BATCH * GEN_PROMPT},
        "greedy_agreement": {"first_token": float(same[:, 0].mean()),
                             "all_tokens": float(same.mean())},
        "plain_timing": plain.last_timing,
        "compression": eng.compression,
    }
    emit({"moe_generate": out})
    return out


def phase_moe_tuned_generate(torch, dev, out_dir, heuristic):
    """The tuned path on granite-moe: phase 5's serve again, tuned
    (``tuned_serve``), so the tuner times K4's schedules on layer x expert
    stacks and the Engine resolves them from the table.  The bf16 prefill
    logits against the plain path are reported without a limit, as phase
    5's (routing flips cascade); every schedule at these stacks is held
    against its plain version in the K4 variant check."""
    from repro_torch.kernels import autotune

    cfg = moe_config()
    res, out = tuned_serve(torch, dev, out_dir, cfg, moe_tokens)
    check("bitlinear_grouped" in out["launches_tuning"]
          and any("|bitlinear_grouped|" in k for k in out["winners"]),
          "the tuner timed no grouped signature")
    bf16 = moe_prefill_pair(torch, cfg, res.engine.params, res.prompts, dev)
    check(bf16.pop("kernel_launches") == {"bitlinear": 4 * cfg.num_layers,
                                          "bitlinear_grouped": 3 * cfg.num_layers,
                                          "flash_attention": cfg.num_layers},
          "tuned prefill did not run every kernel once per layer")
    check(all(r["source"] == "cache" for r in autotune.last_resolutions()),
          "the tuned prefill resolved outside the table")
    autotune.clear_schedules()
    autotune.clear_log()
    out.update({
        "ttft_s_heuristic": heuristic["ttft_s"],
        "decode_ms_per_step_heuristic": heuristic["decode_ms_per_step"],
        "heuristic_launches": heuristic["by_schedule"],
        "prefill_logits_bf16": {"max_abs_diff": bf16["max_abs_diff"],
                                "max_abs_logit": bf16["max_abs_logit"]},
    })
    emit({"moe_tuned_generate": out})
    return out


# ---------------------------------------------------------------------------
# phase 7: zamba2-1.2b whole (SSM groups and the shared attention block)
# ---------------------------------------------------------------------------

ZAMBA_ARCH = "zamba2-1.2b"


def zamba_config():
    """zamba2-1.2b at its published widths and depth, bf16."""
    from repro_torch.configs import get_config

    return get_config(ZAMBA_ARCH)


def zamba_shared_calls(cfg):
    """The shared block's calls per forward: one per ``ssm_attn`` layer."""
    return sum(k == "ssm_attn"
               for k in cfg.block_pattern * cfg.num_groups + cfg.remainder_pattern)


def zamba_uses(cfg):
    """Calls per forward of a compressed tensor of zamba2: a layer stack's
    once per layer, the shared block's once per ``ssm_attn`` layer."""
    n = zamba_shared_calls(cfg)

    def uses(path, e):
        return n if path.startswith("shared/") else layer_slices(path, e)

    return uses


def zamba_tokens(path, kind):
    """phase 7's T per call: 4096 at prefill (the head is the tied
    embedding, not compressed) and 4 at decode."""
    return GEN_BATCH * GEN_PROMPT, GEN_BATCH


def zamba_pools(cfg):
    """{(tile_n, tile_d, K): tiles} that the default policy makes of
    zamba2: every in_proj at 32 x pick_tile(d_in_proj, 128) (8,384 = 2^6 x
    131 columns: td 131), every out_proj and the shared block's seven
    weights at 32 x 128; K = 4."""
    from repro_torch.core.compress import pick_tile

    d, di, L = cfg.d_model, cfg.d_inner, cfg.num_layers
    d_in_proj = 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state + cfg.ssm_nheads
    td = pick_tile(d_in_proj, 128)
    q, kv = cfg.num_heads * cfg.resolved_head_dim, cfg.num_kv_heads * cfg.resolved_head_dim
    shared = 2 * d * q + 2 * d * kv + 3 * d * cfg.d_ff
    return {(32, td, 4): L * d * d_in_proj // (32 * td),
            (32, 128, 4): (L * di * d + shared) // (32 * 128)}


def phase_zamba_compress(torch, dev, out_dir):
    """The whole zamba2-1.2b (published widths, nothing cut, random weights
    from seed 0) through ``compress_model`` with the default policy: the
    pools by tile shape must be what the config gives (155,648 tiles of 32 x
    131, 94,208 of 32 x 128), chunked below the eigh limit, and no kernel
    may launch.  Returns (the report, the compressed values)."""
    from repro_torch.compression import CompressionPolicy
    from repro_torch.compression.execute import EIGH_MAX_BATCH
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.launch.compress import compress_model
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    cfg = zamba_config()
    emit({"zamba2_config": {
        "arch": cfg.name, "num_layers": cfg.num_layers,
        "pattern": f"{cfg.num_groups} x {'+'.join(cfg.block_pattern)}, remainder "
                   f"{'+'.join(cfg.remainder_pattern)}",
        "widths": "published (d_model 2048, d_inner 4096, 64 SSM heads of 64, state 64, "
                  "1 group, conv 4, chunk 256; shared block 32x64 q heads, 32 kv heads, "
                  "d_ff 8192, window 4096; vocab 32000, tied, bf16)",
        "reduced": []}})
    values, _ = split(init_model(cfg, seed=SEED, device=dev))
    torch.cuda.synchronize()
    sa.sa_sweep_many.launches = 0
    bl.reset_counts()
    fa.flash_attention.launches = 0
    t0 = time.time()
    cvalues, artifact = compress_model(cfg, CompressionPolicy(), out_dir, seed=SEED, device=dev,
                                       values=values, verbose=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    del values
    check((sa.sa_sweep_many.launches, bl.bitlinear.launches, bl.bitlinear_grouped.launches,
           fa.flash_attention.launches) == (0, 0, 0, 0), "compression launched a kernel")
    m = artifact.manifest
    pools = {(p["tile_n"], p["tile_d"], p["K"]): p for p in m["pools"]}
    got = {k: p["num_tiles"] for k, p in pools.items()}
    want = zamba_pools(cfg)
    check(got == want == {(32, 131, 4): 155648, (32, 128, 4): 94208},
          f"pools {got}, the config gives {want}")
    for p in pools.values():
        check(p["chunk_policy"] == "auto" and max(p["chunk_sizes"]) <= EIGH_MAX_BATCH
              and p["chunks"] == -(-p["num_tiles"] // EIGH_MAX_BATCH),
              f"auto chunking gave {p['chunks']} chunks of at most {max(p['chunk_sizes'])} "
              f"tiles (bound {EIGH_MAX_BATCH})")
    n_blocks = len(cfg.block_pattern) + len(cfg.remainder_pattern)
    in_proj = [e for p, e in m["tensors"].items() if p.endswith("/in_proj/w")]
    check(len(m["tensors"]) == 2 * n_blocks + 7 and len(in_proj) == n_blocks
          and all(e["tile_d"] == 131 for e in in_proj),
          f"compressed tensors {sorted(m['tensors'])}")
    out = {"wall_s": wall,
           "pools": [{"tile": [tn, td], "K": K, "num_tiles": p["num_tiles"],
                      "chunks": p["chunks"], "max_chunk": max(p["chunk_sizes"]),
                      "method": p["method"]} for (tn, td, K), p in sorted(pools.items())],
           "eigh_max_batch": EIGH_MAX_BATCH,
           "tensors": {p: {"tile": [e["tile_n"], e["tile_d"]], "rel_err": e["rel_err"],
                           "ratio": e["orig_bytes"] / e["new_bytes"],
                           "group_dims": e["group_dims"]} for p, e in m["tensors"].items()},
           "totals": m["totals"]}
    emit({"zamba2_compress": out})
    return out, cvalues


# K3 at phase 7's tiles: (label, tensor, T).  zamba2's in_proj (64 x 64 tiles
# of 32 x 131, K = 4) and out_proj (128 x 16 of 32 x 128) from the
# checkpoint's layer 0 at decode and prefill T, and mamba2-130m's in_proj
# tile (24 x 8 of 32 x 419: the tensor-core grid's three 144-column chunks)
# at both
ZAMBA_K3 = (("in_proj_T4", "in_proj", GEN_BATCH),
            ("in_proj_T4096", "in_proj", GEN_BATCH * GEN_PROMPT),
            ("out_proj_T4", "out_proj", GEN_BATCH),
            ("out_proj_T4096", "out_proj", GEN_BATCH * GEN_PROMPT),
            ("mamba2_in_proj_T4", "mamba2_in_proj", GEN_BATCH),
            ("mamba2_in_proj_T4096", "mamba2_in_proj", GEN_BATCH * GEN_PROMPT))


def k3_timing(torch, x, w, flush):
    """K3 on bf16 x and a compressed weight ``w`` at the schedule the default
    rule resolves, held against its plain version (max|y - y_plain| /
    max|y_plain|) and timed beside its bound, the plain version and a dense
    bf16 ``torch.matmul`` on the decompressed weight, each also as device
    time alone."""
    from repro_torch.core import quantized
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels import bitlinear as bl

    mp, C = w["m_packed"], w["C"]
    T = x.shape[0]
    n_r, n_c, tn, _ = mp.shape
    K, td = C.shape[2], C.shape[3]
    sched = autotune.resolve_fused(x, mp, C)
    kw = sched.kwargs()
    y, yp = bl.bitlinear(x, mp, C, **kw).float(), ref.bitlinear_ref(x, mp, C, sched.math).float()
    rel = float((y - yp).abs().max() / yp.abs().max())
    del y, yp
    w_dense = quantized.decompress(w, torch.bfloat16)
    ms, device_ms = (cuda_ms(torch, lambda: bl.bitlinear(x, mp, C, **kw), 5, flush,
                             busy=busy) for busy in (False, True))
    plain_ms = cuda_ms(torch, lambda: ref.bitlinear_ref(x, mp, C, sched.math), 2, flush)
    library_ms, library_device_ms = (cuda_ms(torch, lambda: torch.matmul(x, w_dense), 5,
                                             flush, busy=busy) for busy in (False, True))
    del w_dense
    b_bytes, b_ops = k3_bound(mp, C, T, 2)
    on_mma = sched.mode == "grid" and bl.grid_on_tensor_cores(T, tn, K, td, 2, 2)
    return {
        "T": T, "shape": [n_r, n_c, tn, K, td],
        "schedule": f"{sched.mode}/{sched.math}", "tensor_cores": on_mma,
        # (columns, chunks) of the tensor-core body's column chunks
        **({"mma_chunk": list(bl.grid_mma_chunk(td))} if on_mma else {}),
        "max_err_over_max_y": rel,
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_device_ms": library_device_ms, "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations"}


def phase_zamba_k3(torch, dev, cvalues, flush):
    """K3 at phase 7's tiles before anything is served from them: every
    schedule x bit algebra x activation x C dtype against the plain version
    (phase 3's limits), each launch on the path the rules predict (the
    grid's tensor-core body for bf16 x and C above T = 4 at td 131 and 419
    as at 128, its FMA body otherwise; stream's maps by
    ``stream_tensor_maps``); then zamba2's in_proj and out_proj at T = 4 and
    4096 and mamba2-130m's in_proj at 4 and 4096 at the default rule's
    schedule, timed beside their bound, the plain version and a dense bf16
    matmul."""
    from repro_torch.configs import get_config
    from repro_torch.core.compress import pick_tile
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels import bitlinear as bl

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    ssm0 = cvalues["groups"]["0"]["ssm"]
    weights = {name: {k: v[0] for k, v in ssm0[name]["w"].items()}
               for name in ("in_proj", "out_proj")}
    m2 = get_config("mamba2-130m")
    d_in_proj = 2 * m2.d_inner + 2 * m2.ssm_ngroups * m2.ssm_state + m2.ssm_nheads
    td = pick_tile(d_in_proj, 128)
    n_r, n_c = m2.d_model // 32, d_in_proj // td
    weights["mamba2_in_proj"] = {
        "m_packed": torch.randint(0, 256, (n_r, n_c, 32, 1), generator=g, device=dev,
                                  dtype=torch.uint8),
        "C": (torch.randn((n_r, n_c, 4, td), generator=g, device=dev) * 0.2).to(torch.bfloat16)}
    check(tuple(weights["in_proj"]["C"].shape) == (64, 64, 4, 131)
          and tuple(weights["mamba2_in_proj"]["C"].shape) == (24, 8, 4, 419),
          f"in_proj tiles {tuple(weights['in_proj']['C'].shape)}, mamba2's "
          f"{tuple(weights['mamba2_in_proj']['C'].shape)}")
    errs, checks = {}, {}
    for label, name, T in ZAMBA_K3:
        w = weights[name]
        mp = w["m_packed"]
        ran, paths = 0, {}
        for xd in XDTYPES:
            for cd in CDTYPES:
                x, C = variant_inputs(torch, g, dev, (T, mp.shape[0] * mp.shape[2]), w["C"],
                                      xd, cd, mp.shape[2])
                ran += hold_variants(torch, bl.bitlinear, ref.bitlinear_ref, label, x, mp, C,
                                     xd, cd, ("grid", "decode", "stream"), errs, paths)
        # bf16 x and C: each bit algebra x grid option on the tensor cores
        # above T = 4 (odd td included), on the FMA body at T = 4
        want_mma = 2 * len(MODE_OPTIONS["grid"]) if T > bl.SMALL_T else 0
        check(paths.get("tensor_cores", 0) == want_mma,
              f"{label}: {paths.get('tensor_cores', 0)} grid launches on the tensor cores, "
              f"want {want_mma}")
        checks[label] = {"tensor": name, "T": T,
                         "shape": list(mp.shape[:3]) + list(w["C"].shape[2:]),
                         "variants_held": ran, "paths": paths}
    timing = {}
    for label, name, T in ZAMBA_K3:
        w = weights[name]
        mp = w["m_packed"]
        x = torch.randn((T, mp.shape[0] * mp.shape[2]), generator=g, device=dev).to(torch.bfloat16)
        timing[label] = k3_timing(torch, x, w, flush)
        check(timing[label]["tensor_cores"] == (T > bl.SMALL_T),
              f"{label}: tensor cores {timing[label]['tensor_cores']} at T = {T}")
        if T <= bl.SMALL_T:
            # decode: how its block stages C (whole tiles at td 128, raw at
            # 131, from device memory at 419)
            _, _, tn, _ = mp.shape
            K, td = w["C"].shape[2], w["C"].shape[3]
            kw = dict(T=T, tn=tn, K=K, td=td, x_itemsize=2, c_itemsize=2)
            layout = bl.built_decode_layout(**kw)
            want = "tiles" if td == 128 else "raw" if td <= 32 * bl.DECODE_RAW_COLS else "device"
            check(timing[label]["schedule"] == "decode/bitplane" and layout["c"] == want
                  and layout == bl.decode_layout(**kw),
                  f"{label}: decode at td {td}: {timing[label]['schedule']}, C {layout['c']} "
                  f"(the mirror: {bl.decode_layout(**kw)['c']})")
            timing[label]["decode_layout"] = layout
    autotune.clear_log()
    out = {"checks": checks, "max_abs_err": errs, "timing": timing}
    emit({"zamba2_k3": out})
    return out


def zamba_prefill(torch, cfg, eng, prompts, dev, setup):
    """A prefill of the engine's weights after ``setup()`` chose the path
    (``make_prefill``: the Engine's own prefill runs its own kernels):
    ((the last position's logits in f32, [(block kind, the residual stream
    after each block)]), the K3 and K5 launches it made).  The blocks'
    outputs are read by wrapping ``transformer._apply_block``."""
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_cache
    from repro_torch.models import transformer
    from repro_torch.serving.engine import make_prefill

    block, hs = transformer._apply_block, []

    def tap(h, p, kind, *a, **k):
        out = block(h, p, kind, *a, **k)
        hs.append((kind, out[0]))
        return out

    setup()
    before = (bl.bitlinear.launches, fa.flash_attention.launches)
    transformer._apply_block = tap
    try:
        with torch.inference_mode():
            logits, _ = make_prefill(cfg)(eng.params, {"tokens": prompts},
                                          init_cache(cfg, prompts.shape[0],
                                                     prompts.shape[1] + GEN_STEPS, device=dev))
        torch.cuda.synchronize()
    finally:
        transformer._apply_block = block
    return (logits.float(), hs), {"bitlinear": bl.bitlinear.launches - before[0],
                                  "flash_attention": fa.flash_attention.launches - before[1]}


def phase_zamba_generate(torch, dev, out_dir):
    """``serve_model`` from phase 7's checkpoint: 32 tokens for 4 prompts of
    1024 tokens.  K3 launches once per compressed layer slice and shared-block
    call per forward (118), per schedule as its resolutions picked, the
    prefill's 118 on the tensor cores (in_proj at td 131 too); K5 once
    per ``ssm_attn`` layer per prefill (6).  The bf16 prefill logits are held
    against the plain path within LOGIT_TOL of max|logit|."""
    cfg = zamba_config()
    n_shared = zamba_shared_calls(cfg)
    out = ssm_generate(torch, dev, cfg, out_dir, zamba_uses(cfg), n_shared,
                       2 * cfg.num_layers + 7 * n_shared, 118, "phase 7")
    emit({"zamba2_generate": out})
    return out


def ssm_generate(torch, dev, cfg, out_dir, uses, n_shared, per_forward_want, literal, label,
                 steps=GEN_STEPS):
    """Serve ``cfg`` from its checkpoint in ``out_dir`` (phase 7's serve:
    GEN_BATCH prompts of GEN_PROMPT tokens, ``steps`` new ones, an eos never
    emitted) and check it: K3 ``per_forward_want`` (= ``literal``) calls a
    forward, K5 ``n_shared`` a prefill, no other kernel; launches per
    schedule as the resolutions picked, every prefill call of K3 on the
    tensor cores and every decode call at the rule's cluster size (by the
    library's reports); tokens in range; the bf16 prefill logits with the
    kernels within LOGIT_TOL of max|logit| of the plain path's, with the
    residual streams' distance after every block.  Returns the report."""
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.launch.serve import serve_model
    from repro_torch.serving import Engine

    eos = cfg.vocab_size                     # never emitted: launch counts are fixed
    torch.cuda.synchronize()
    sa.sa_sweep_many.launches = 0
    bl.reset_counts()
    fa.flash_attention.launches = 0
    autotune.clear_log()
    res = serve_model(cfg, ckpt_dir=out_dir, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
                      steps=steps, eos_id=eos, seed=SEED, device=dev, verbose=False)
    torch.cuda.synchronize()
    launches = {"bitlinear": bl.bitlinear.launches,
                "bitlinear_grouped": bl.bitlinear_grouped.launches,
                "flash_attention": fa.flash_attention.launches,
                "sa_sweep_many": sa.sa_sweep_many.launches}
    eng = res.engine
    # the tensors K3 serves (an int8 one is served by apply_intquant)
    manifest = {**eng.artifact.manifest,
                "tensors": {p: e for p, e in eng.artifact.manifest["tensors"].items()
                            if e["method"] != "int8"}}
    per_forward = sum(uses(p, e) for p, e in manifest["tensors"].items())
    want = {"bitlinear": per_forward * steps, "bitlinear_grouped": 0,
            "flash_attention": n_shared, "sa_sweep_many": 0}
    check(per_forward == per_forward_want == literal and launches == want,
          f"{label}: launches {launches}, want {want} ({per_forward} K3 calls a forward)")
    by_schedule = served(bl.bitlinear)
    tensor_cores, clusters = heuristic_launches(torch, dev, manifest,
                                                {"bitlinear": by_schedule}, zamba_tokens,
                                                label, uses, steps)
    check(tensor_cores == {"bitlinear": per_forward},
          f"{label}: tensor-core launches {tensor_cores}, want the prefill's {per_forward}")
    ttft = ttft_repeats(eng, res.prompts, res.timing["prefill_s"])
    toks = res.tokens
    check(tuple(toks.shape) == (GEN_BATCH, GEN_PROMPT + steps)
          and torch.equal(toks[:, :GEN_PROMPT], res.prompts)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"{label}: generated tokens {tuple(toks.shape)} out of shape or range")

    # bf16 prefill logits with the kernels against the plain path, and where
    # along the layers the two residual streams part
    (lk, hk), launched = zamba_prefill(torch, cfg, eng, res.prompts, dev, ops.enable_kernels)
    (lp, hp), _ = zamba_prefill(torch, cfg, eng, res.prompts, dev, ops.disable_kernels)
    check(launched == {"bitlinear": per_forward, "flash_attention": n_shared},
          f"{label}: the kernel prefill launched {launched}")
    check(bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all()),
          f"{label}: prefill logits are not finite")
    scale = float(lp.abs().max())
    err = float((lk - lp).abs().max())
    layers = [{"kind": kind, "rel_diff": float((a.float() - b.float()).abs().max())
               / float(b.float().abs().max())} for (kind, a), (_, b) in zip(hk, hp)]
    del hk, hp
    check(err <= LOGIT_TOL * scale,
          f"{label}: {cfg.name} prefill logits kernels vs plain: {err:.3g} > {LOGIT_TOL} x "
          f"{scale:.3g}; per layer {layers}")
    before = (fa.flash_attention.launches, bl.bitlinear.launches)
    plain = Engine(cfg, eng.params, max_len=GEN_PROMPT + steps, batch=GEN_BATCH, eos_id=eos,
                   artifact=eng.artifact, use_fused_bitlinear=False)
    toks_plain = plain.generate(res.prompts, steps)
    check((fa.flash_attention.launches, bl.bitlinear.launches) == before,
          f"{label}: the plain path launched a kernel")
    same = (toks[:, GEN_PROMPT:] == toks_plain[:, GEN_PROMPT:]).float()
    t = res.timing
    return {
        "launches": launches,
        "bitlinear_by_schedule": by_schedule,
        "tensor_core_launches": tensor_cores,
        "decode_clusters": clusters,
        **ttft,
        "decode_ms_per_step": 1e3 * t["decode_s"] / t["decode_steps"],
        "decode_tokens_per_s": GEN_BATCH * t["decode_steps"] / t["decode_s"],
        "generate_wall_s": res.wall_s,
        "prefill_logits": {"max_abs_diff": err, "max_abs_logit": scale,
                           "tol": LOGIT_TOL * scale},
        # per layer: max|h - h_plain| / max|h_plain| of the residual stream
        # after the block (ssm_attn: after the shared block)
        "prefill_layers": layers,
        "greedy_agreement": {"first_token": float(same[:, 0].mean()),
                             "all_tokens": float(same.mean())},
        "plain_timing": plain.last_timing,
        "compression": eng.compression,
    }


# ---------------------------------------------------------------------------
# phases 7c and 4c: continuous batching (serving/scheduler.py, kv_pages.py,
# frontend.py, loadgen.py) on the checkpoints of phases 7 and 4
# ---------------------------------------------------------------------------

SCHED_SLOTS, SCHED_PAGE = 4, 16
SCHED_REQUESTS = 8                  # phase 7c's identity runs (a)
SCHED_LOGIT_REQUESTS = 4            # phase 7c's logits check (b), and phase 4c's requests
SCHED_QPS, SCHED_LOAD_REQUESTS = (1.0, 4.0, 16.0), 16
SCHED_CHUNK = 16                    # phase 4c's prefill chunk: 64 chunks of a 1024 prompt
# phase 7c's cut pool (99 usable pages of 16): with prompts of 512, 1024, ...
# (32 and 64 pages) and 32 new tokens on 4 slots, the scheduler's page rule
# (host-side, independent of the tokens while eos is never emitted) evicts
# three requests after 18, 31 and 18 decoded tokens and ends in 191 ticks
# (65 on a full pool).  Not every cut ends: the reference's victim rule (the
# most recently admitted *other* request) lets two growing requests evict each
# other forever, which it does here at 98 and 99 pages (ROADMAP Queue 3).
SCHED_CUT_PAGES = 100


def instrument(torch, sched):
    """Wrap a Scheduler's prefill and sampling: returns (calls, first), the
    prefill forwards it runs by ``attend`` (False: a request's first chunk,
    True: a later one) with their host time ``calls["s"]`` (each ended by a
    device synchronisation, as the tick's next host read would end it), and
    each request's first-token logits row (the prefill's last position), in
    f32, by request id."""
    calls, first = {False: 0, True: 0, "s": 0.0}, {}
    prefill_fn, sample = sched._prefill_fn, sched._sample

    def counted(attend):
        fn = prefill_fn(attend)

        def run(*a):
            calls[attend] += 1
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            calls["s"] += time.perf_counter() - t
            return out
        return run

    def keep(req, row, index):
        if index == 0:
            first[req.rid] = row.float().clone()
        return sample(req, row, index)

    sched._prefill_fn, sched._sample = counted, keep
    return calls, first


def scheduler_run(torch, dev, eng, prompts, max_tokens, per_forward, n_attn, label, **kw):
    """Submit ``prompts`` to a new Scheduler of SCHED_SLOTS slots and
    SCHED_PAGE-token pages (``kw``: its other arguments) and run it to the
    end, with the checks every such run meets: K3 launched ``per_forward``
    times a forward (prefill forwards + decode ticks), K5 ``n_attn`` times
    a first prefill chunk (later chunks attend to the cache through the
    plain path), no other kernel; every request complete, its tokens in
    range and its pages back in the pool.  Returns (tokens, report, the
    first-token logits rows by request id)."""
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.serving import Scheduler

    sched = Scheduler(eng, num_slots=SCHED_SLOTS, page_size=SCHED_PAGE, device=dev, **kw)
    calls, first = instrument(torch, sched)
    torch.cuda.synchronize()
    bl.reset_counts()
    fa.flash_attention.launches = 0
    sa.sa_sweep_many.launches = 0
    t = time.perf_counter()
    reqs = [sched.submit(p, max_tokens) for p in prompts]
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    st = sched.stats
    launches = {"bitlinear": bl.bitlinear.launches,
                "bitlinear_grouped": bl.bitlinear_grouped.launches,
                "flash_attention": fa.flash_attention.launches,
                "sa_sweep_many": sa.sa_sweep_many.launches}
    forwards = calls[False] + calls[True] + st.decode_steps
    want = {"bitlinear": per_forward * forwards, "bitlinear_grouped": 0,
            "flash_attention": n_attn * calls[False], "sa_sweep_many": 0}
    check(launches == want and calls[False] + calls[True] == st.prefill_chunks,
          f"{label}: launches {launches}, want {want} (prefill forwards {calls}, decode ticks "
          f"{st.decode_steps})")
    toks = [r.tokens for r in reqs]
    vocab = sched.cfg.vocab_size
    check(st.completed == len(prompts) and all(r.state == "done" for r in reqs)
          and all(len(x) == max_tokens and all(0 <= v < vocab for v in x) for x in toks)
          and sched.pool.pages_in_use == 0,
          f"{label}: {st.completed} of {len(prompts)} completed, "
          f"{sched.pool.pages_in_use} pages still in use")
    return toks, {
        "launches": launches,
        "prefill_forwards": {"first_chunk": calls[False], "later_chunk": calls[True]},
        "stats": dataclasses.asdict(st), "wall_s": wall,
        # host time in prefill forwards, and the rest of the run a decode tick
        # (the tick's admission, gather, forward, scatter, picks)
        "prefill_s": calls["s"],
        "decode_ms_per_tick": 1e3 * (wall - calls["s"]) / max(st.decode_steps, 1),
        "pool": {"num_pages": sched.pool.num_pages,
                 "high_water": sched.pool.pages_high_water,
                 "pages_in_use_at_end": sched.pool.pages_in_use},
        "evictions_by_request": [r.evictions for r in reqs],
    }, first


def first_logits_err(torch, dev, eng, cfg, prompts, first, max_len):
    """Per request: max|scheduler's first-token logits - a batch-1 one-shot
    prefill's| and that prefill's max|logit| (f32)."""
    from repro_torch.models import init_cache

    out = []
    with torch.inference_mode():
        for rid, p in enumerate(prompts):
            ref, _ = eng.prefill(eng.params, {"tokens": torch.as_tensor(p, device=dev)[None]},
                                 init_cache(cfg, 1, max_len, device=dev))
            ref = ref[0].float()
            out.append({"max_abs_diff": float((first[rid] - ref).abs().max()),
                        "max_abs_logit": float(ref.abs().max())})
    return out


def sched_prompts(vocab, lengths, seed=1):
    """numpy int32 prompts of ``lengths`` random tokens from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=L).astype(np.int32) for L in lengths]


def phase_zamba_sched(torch, dev, out_dir):
    """Phase 7c: the whole zamba2-1.2b from phase 7's checkpoint under the
    scheduler: SCHED_SLOTS slots, pages of SCHED_PAGE tokens, max_len =
    GEN_PROMPT + GEN_STEPS (66 pages; the shared block's KV is paged, as
    max_len is below its window), prompts of 512 and 1024 tokens (the SSD
    splits them into 2 and 4 chunks of 256; each prefilled in one
    exact-length chunk) from seed 1, GEN_STEPS greedy tokens each, an eos
    never emitted.  (a) SCHED_REQUESTS requests on a fully provisioned
    pool, then on one cut to SCHED_CUT_PAGES pages, which must evict: the
    tokens must be identical.  (b) the first SCHED_LOGIT_REQUESTS requests'
    first-token logits within LOGIT_TOL of max|logit| of a batch-1 one-shot
    prefill, and their tokens against a batch-1 ``Engine.generate``
    (reported).  (c) each run's K3 launches = 118 x forwards, K5 6 x
    prefill forwards, and an empty pool at the end.  Then ``load_curve``
    (the CLI's ``--load-curve``) at SCHED_QPS with SCHED_LOAD_REQUESTS
    requests a rate: every request completed."""
    from repro_torch.launch.serve import LOAD_CSV_HEADER, build_engine, load_curve

    cfg = zamba_config()
    max_len = GEN_PROMPT + GEN_STEPS
    eos = cfg.vocab_size                     # never emitted
    eng = build_engine(cfg, ckpt_dir=out_dir, batch=1, prompt_len=GEN_PROMPT, steps=GEN_STEPS,
                       eos_id=eos, seed=SEED, device=dev, verbose=False)
    uses = zamba_uses(cfg)
    per_forward = sum(uses(p, e) for p, e in eng.artifact.manifest["tensors"].items())
    n_shared = zamba_shared_calls(cfg)
    check(per_forward == 118 and n_shared == 6, f"phase 7c: {per_forward} K3 calls a forward")
    lens = [GEN_PROMPT // 2, GEN_PROMPT] * (SCHED_REQUESTS // 2)
    prompts = sched_prompts(cfg.vocab_size, lens)

    # (a) a full pool, then a cut one that must evict; (c) in each run
    full, rep_full, first = scheduler_run(torch, dev, eng, prompts, GEN_STEPS, per_forward, n_shared,
                                          "phase 7c full pool", max_len=max_len)
    cut, rep_cut, _ = scheduler_run(torch, dev, eng, prompts, GEN_STEPS, per_forward, n_shared,
                                    "phase 7c cut pool", max_len=max_len,
                                    num_pages=SCHED_CUT_PAGES)
    check(rep_cut["stats"]["evictions"] >= 1,
          f"phase 7c: the pool of {SCHED_CUT_PAGES} pages evicted nothing")
    same = [a == b for a, b in zip(full, cut)]
    check(all(same), f"phase 7c: tokens under eviction differ for requests "
                     f"{[i for i, x in enumerate(same) if not x]}")

    # (b) first-token logits and tokens against batch-1 serving
    n = SCHED_LOGIT_REQUESTS
    errs = first_logits_err(torch, dev, eng, cfg, prompts[:n], first, max_len)
    bad = [e for e in errs if not e["max_abs_diff"] <= LOGIT_TOL * e["max_abs_logit"]]
    check(not bad, f"phase 7c: first-token logits off by {bad}")
    agree = []
    for p, toks in zip(prompts[:n], full[:n]):
        ref = eng.generate(torch.as_tensor(p, device=dev)[None], GEN_STEPS)[0, len(p):]
        agree.append(sum(int(a) == b for a, b in zip(ref.tolist(), toks)))

    # the load curve, through the CLI's function
    csv = []
    t = time.perf_counter()
    curve = load_curve(eng, cfg, qps=SCHED_QPS, requests=SCHED_LOAD_REQUESTS,
                       num_slots=SCHED_SLOTS, page_size=SCHED_PAGE, prompt_len=GEN_PROMPT,
                       steps=GEN_STEPS, seed=1, device=dev, say=csv.append)
    curve_s = time.perf_counter() - t
    check(csv[0] == LOAD_CSV_HEADER and len(csv) == 1 + len(SCHED_QPS), f"load curve csv {csv}")
    check(all(r.completed == r.n_requests == SCHED_LOAD_REQUESTS for r in curve),
          f"load curve: completed {[r.completed for r in curve]}")
    out = {
        "config": {"arch": cfg.name, "slots": SCHED_SLOTS, "page_size": SCHED_PAGE,
                   "max_len": max_len, "prompt_lens": sorted(set(lens)),
                   "max_tokens": GEN_STEPS, "reduced": []},
        "full_pool": rep_full, "cut_pool": rep_cut,
        "tokens_identical_under_eviction": all(same),
        "first_token_logits": errs,
        "tokens_agreeing_with_batch1_generate": {"per_request": agree, "of": GEN_STEPS},
        "load_curve": {"csv": csv, "wall_s": curve_s,
                       "rows": [{k: v for k, v in r.to_row().items()} for r in curve]},
        "launches": {k: rep_full["launches"][k] + rep_cut["launches"][k]
                     for k in rep_full["launches"]},
    }
    emit({"zamba2_scheduler": out})
    return out


def phase_qwen_sched(torch, dev, out_dir):
    """Phase 4c: qwen3-32b's one layer from phase 4's checkpoint under the
    scheduler with pow2-chunked prefill: SCHED_LOGIT_REQUESTS requests of
    phase 4's GEN_PROMPT-token prompts (serve_model's, seed PROMPT_SEED) at
    ``prefill_chunk`` SCHED_CHUNK (64 chunks each), GEN_STEPS greedy tokens.
    K5 must launch once per request, on its first chunk (later chunks attend
    to the cache through the plain path), K3 once per compressed tensor a
    forward; each request's first-token logits (its last chunk's last
    position) within LOGIT_TOL of max|logit| of the one-shot prefill
    through K5; tokens against a batch-1 ``Engine.generate`` reported."""
    from repro_torch.device import generator as make_generator
    from repro_torch.kernels import autotune
    from repro_torch.launch.serve import PROMPT_SEED, build_engine

    _, cfg = full_width_config()
    max_len = GEN_PROMPT + GEN_STEPS
    eos = cfg.vocab_size
    eng = build_engine(cfg, ckpt_dir=out_dir, batch=1, prompt_len=GEN_PROMPT, steps=GEN_STEPS,
                       eos_id=eos, seed=SEED, device=dev, verbose=False)
    n = SCHED_LOGIT_REQUESTS
    prompts = torch.randint(0, cfg.vocab_size, (n, GEN_PROMPT),
                            generator=make_generator(dev, PROMPT_SEED), device=dev)
    prompts = list(prompts.cpu().numpy().astype("int32"))
    per_forward = eng.compression["tensors"]
    toks, rep, first = scheduler_run(torch, dev, eng, prompts, GEN_STEPS, per_forward, cfg.num_layers,
                                     "phase 4c", max_len=max_len, prefill_chunk=SCHED_CHUNK)
    chunks = -(-GEN_PROMPT // SCHED_CHUNK)
    check(rep["prefill_forwards"] == {"first_chunk": n, "later_chunk": n * (chunks - 1)}
          and rep["launches"]["flash_attention"] == n,
          f"phase 4c: prefill forwards {rep['prefill_forwards']}, K5 "
          f"{rep['launches']['flash_attention']}; want {n} first chunks, one K5 each")
    errs = first_logits_err(torch, dev, eng, cfg, prompts, first, max_len)
    bad = [e for e in errs if not e["max_abs_diff"] <= LOGIT_TOL * e["max_abs_logit"]]
    check(not bad, f"phase 4c: chunked prefill logits off the one-shot prefill's by {bad}")
    agree = []
    for p, t in zip(prompts, toks):
        ref = eng.generate(torch.as_tensor(p, device=dev)[None], GEN_STEPS)[0, len(p):]
        agree.append(sum(int(a) == b for a, b in zip(ref.tolist(), t)))
    autotune.clear_schedules()
    autotune.clear_log()
    out = {"config": {"arch": cfg.name, "num_layers": cfg.num_layers, "slots": SCHED_SLOTS,
                      "page_size": SCHED_PAGE, "prefill_chunk": SCHED_CHUNK,
                      "max_len": max_len, "requests": n, "prompt_len": GEN_PROMPT,
                      "max_tokens": GEN_STEPS},
           **rep, "first_token_logits": errs,
           "tokens_agreeing_with_batch1_generate": {"per_request": agree, "of": GEN_STEPS}}
    emit({"qwen_scheduler": out})
    return out


# ---------------------------------------------------------------------------
# phase 7b: mamba2-130m whole (attention-free: SSD blocks only)
# ---------------------------------------------------------------------------

MAMBA2_ARCH = "mamba2-130m"


def mamba2_config():
    """mamba2-130m at its published widths and depth, bf16."""
    from repro_torch.configs import get_config

    return get_config(MAMBA2_ARCH)


def phase_mamba2(torch, dev, out_dir):
    """The whole mamba2-130m (published widths, 24 layers, random weights
    from seed 0, bf16) compressed with the default policy (in_proj at 32 x
    419: 4,608 tiles; out_proj at 32 x 128: 6,912; no kernel launched) and
    served as phase 7 serves zamba2: K3 48 calls a forward, every prefill
    call on the tensor cores (in_proj in three 144-column chunks), no K5;
    the bf16 prefill logits within LOGIT_TOL of the plain path's."""
    from repro_torch.compression import CompressionPolicy
    from repro_torch.core.compress import pick_tile
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.launch.compress import compress_model
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    cfg = mamba2_config()
    values, _ = split(init_model(cfg, seed=SEED, device=dev))
    torch.cuda.synchronize()
    sa.sa_sweep_many.launches = 0
    bl.reset_counts()
    fa.flash_attention.launches = 0
    t0 = time.time()
    _, artifact = compress_model(cfg, CompressionPolicy(), out_dir, seed=SEED, device=dev,
                                 values=values, verbose=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    del values
    check((sa.sa_sweep_many.launches, bl.bitlinear.launches, bl.bitlinear_grouped.launches,
           fa.flash_attention.launches) == (0, 0, 0, 0), "phase 7b: compression launched a kernel")
    m = artifact.manifest
    d, di, L = cfg.d_model, cfg.d_inner, cfg.num_layers
    d_in_proj = 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state + cfg.ssm_nheads
    td = pick_tile(d_in_proj, 128)
    want = {(32, td, 4): L * d * d_in_proj // (32 * td), (32, 128, 4): L * di * d // (32 * 128)}
    got = {(p["tile_n"], p["tile_d"], p["K"]): p["num_tiles"] for p in m["pools"]}
    check(got == want == {(32, 419, 4): 4608, (32, 128, 4): 6912},
          f"phase 7b: pools {got}, the config gives {want}")
    gen = ssm_generate(torch, dev, cfg, out_dir, layer_slices, 0, 2 * L, 48, "phase 7b")
    out = {"config": {"arch": cfg.name, "num_layers": L,
                      "widths": "published (d_model 768, d_inner 1536, 24 SSM heads of 64, "
                                "state 128, 1 group, conv 4, chunk 256; vocab 50280, tied, "
                                "bf16)", "reduced": []},
           "compress_wall_s": wall, "pools": {f"{k[0]}x{k[1]}": v for k, v in got.items()},
           "totals": m["totals"], **gen}
    emit({"mamba2_generate": out})
    return out


# ---------------------------------------------------------------------------
# phases 8 and 8b: compress to a byte budget (compression/autotune, eval/)
# ---------------------------------------------------------------------------

# K over tile_n 32: {2, 4, 6, 8} (the default grid reaches K = 28, whose 2^K
# sign patterns alternating cannot enumerate)
AUTOTUNE_K_FRACTIONS = (1 / 16, 1 / 8, 3 / 16, 1 / 4)
MAMBA2_BUDGET_FRACTION = 0.75


def launch_counts():
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.kernels import sqa_sweep as sqa

    return {"sa_sweep_many": sa.sa_sweep_many.launches,
            "sqa_sweep_many": sqa.sqa_sweep_many.launches,
            "bitlinear": bl.bitlinear.launches,
            "bitlinear_grouped": bl.bitlinear_grouped.launches,
            "flash_attention": fa.flash_attention.launches}


def staged(torch, stages):
    """Wrap each (module, function name) of ``stages`` so that every call
    appends {"stage", "s" (wall, card synchronised), "launches" (the kernel
    launches it made), "engine" (allocate_budget's)} to the returned list.
    Returns (records, restore)."""
    records, saved = [], []
    for mod, name in stages:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def run(*a, _fn=fn, _name=name, **k):
            before = launch_counts()
            torch.cuda.synchronize()
            t = time.time()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            records.append({"stage": _name, "s": time.time() - t, "engine": k.get("engine"),
                            "launches": {key: v - before[key]
                                         for key, v in launch_counts().items()}})
            return out
        setattr(mod, name, run)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return records, restore


def budget_compress(torch, dev, cfg, values, out_dir, budget, stages, **autotune_kw):
    """``compress_model`` of ``values`` to ``budget`` bytes with the default
    policy, its autotuner's ``stages`` recorded (``staged``).  Returns
    (compressed values, artifact, the AutotuneResult, records, wall s,
    execute s)."""
    from repro_torch.compression import CompressionPolicy
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.launch.compress import compress_model

    torch.cuda.synchronize()
    sa.sa_sweep_many.launches = 0
    bl.reset_counts()
    fa.flash_attention.launches = 0
    records, restore = staged(torch, stages)
    try:
        t0 = time.time()
        cvalues, artifact = compress_model(cfg, CompressionPolicy(), out_dir, seed=SEED,
                                           device=dev, values=values, verbose=False,
                                           budget_bytes=budget, **autotune_kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        restore()
    result = compress_model.last_autotune
    check(result.allocation.total_bytes <= budget and artifact.total_bytes() <= budget,
          f"{cfg.name}: allocated {result.allocation.total_bytes}, stored "
          f"{artifact.total_bytes()} bytes over the budget of {budget}")
    tensors = artifact.manifest["tensors"]
    for path, pt in result.allocation.choices.items():
        if pt.dense:
            check(path not in tensors, f"{cfg.name}: {path} allocated dense, stored compressed")
            continue
        e = tensors.get(path)
        want = (pt.tile_n, pt.tile_d, pt.K, pt.method or "alternating")
        check(e is not None and (e["tile_n"], e["tile_d"], e["K"], e["method"]) == want,
              f"{cfg.name}: {path} stored as {e and (e['tile_n'], e['tile_d'], e['K'], e['method'])}"
              f", allocated {want}")
    check(set(tensors) <= set(result.allocation.choices),
          f"{cfg.name}: stored tensors the allocation did not choose")
    return cvalues, artifact, result, records, wall, compress_model.execute_s


def weighted_distortion(manifest, weights):
    """sum over stored tensors of weight x sum of squared tile residuals
    (the manifest's ``tile_resid``); a tensor kept dense adds 0."""
    return sum(weights.get(p, 1.0) * sum(v * v for v in e["tile_resid"])
               for p, e in manifest["tensors"].items())


def phase_zamba_autotune(torch, dev, uniform_dir, out_dir):
    """The whole zamba2-1.2b (published widths, seed 0) through
    ``compress_model`` to the byte budget of phase 7's uniform default plan:
    calibrated, the QUBO engine, K in {2, 4, 6, 8}.  Calibration launches
    neither K3 nor K5, probing no kernel, the allocation one K1 launch (its
    spins printed) and the greedy cross-check none; the artifact fits the
    budget and stores every tensor as allocated.  Its weighted distortion is
    reported predicted, measured (``tile_resid``) and against phase 7's
    uniform artifact at equal bytes.  Then served as phase 7 (K3 as the
    manifest implies, K5 6 a prefill, bf16 logits within LOGIT_TOL)."""
    from repro_torch.compression import CompressionArtifact, CompressionPolicy, plan_compression
    from repro_torch.compression.autotune import refine
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    cfg = zamba_config()
    values, _ = split(init_model(cfg, seed=SEED, device=dev))
    budget = plan_compression(values, CompressionPolicy()).total_bytes()
    uniform = CompressionArtifact.load(uniform_dir)
    _, artifact, result, records, wall, execute_s = budget_compress(
        torch, dev, cfg, values, out_dir, budget,
        ((refine, "calibration_weights"), (refine, "probe_tensors"),
         (refine, "allocate_budget")),
        engine="qubo", calibration=True, k_fractions=AUTOTUNE_K_FRACTIONS)
    del values
    k1_launches = sa.sa_sweep_many.launches
    by = {}
    for r in records:
        by.setdefault(r["stage"], []).append(r)
    zero = {k: 0 for k in launch_counts()}
    check([r["launches"] for r in by["calibration_weights"]] == [zero],
          f"phase 8: calibration launched {by['calibration_weights']}")
    check([r["launches"] for r in by["probe_tensors"]] == [zero],
          f"phase 8: probing launched {by['probe_tensors']}")
    alloc = {r["engine"]: r for r in by["allocate_budget"]}
    check(alloc["qubo"]["launches"] == {**zero, "sa_sweep_many": 1}
          and alloc["greedy"]["launches"] == zero and sa.sa_sweep_many.launches == 1,
          f"phase 8: the allocation launched {alloc}, K1 {sa.sa_sweep_many.launches} in all")
    n_spins = result.allocation.num_spins
    auto = artifact.manifest["autotune"]
    w = result.weights
    counts = {}
    for pt in result.allocation.choices.values():
        key = "dense" if pt.dense else f"K{pt.K}"
        counts[key] = counts.get(key, 0) + 1
    n_shared = zamba_shared_calls(cfg)
    uses = zamba_uses(cfg)
    per_forward = sum(uses(p, e) for p, e in artifact.manifest["tensors"].items())
    t = time.time()
    gen = ssm_generate(torch, dev, cfg, out_dir, uses, n_shared, per_forward, per_forward,
                       "phase 8")
    serve_s = time.time() - t
    out = {"budget_bytes": budget, "uniform_bytes": uniform.total_bytes(),
           "allocated_bytes": result.allocation.total_bytes,
           "stored_bytes": artifact.total_bytes(), "engine": "qubo", "calibrated": True,
           "k_fractions": list(AUTOTUNE_K_FRACTIONS), "qubo_spins": n_spins,
           "qubo_shape": {"P": 6, "reads": 8, "sweeps": 96, "n": n_spins,
                          "body": "shared" if sa.shared_body(n_spins, 8) else "global"},
           "k1_launches": k1_launches,
           "choices": counts, "tensors_stored": len(artifact.manifest["tensors"]),
           "cross_check": auto["cross_check"],
           "weighted_distortion": {
               "predicted": result.allocation.total_distortion,
               "measured": weighted_distortion(artifact.manifest, w),
               "uniform_measured": weighted_distortion(uniform.manifest, w)},
           "wall_s": {"compress_model": wall, "calibrate": by["calibration_weights"][0]["s"],
                      "probe": by["probe_tensors"][0]["s"],
                      "solve": result.allocation.solve_s,
                      "allocate_qubo": alloc["qubo"]["s"],
                      "cross_check_greedy": alloc["greedy"]["s"], "execute": execute_s,
                      "serve": serve_s},
           **gen}
    emit({"zamba2_autotune": out})
    return out


def phase_mamba2_autotune(torch, dev, out_dir):
    """The whole mamba2-130m (published widths, seed 0) through
    ``compress_model`` with ``objective="eval_loss"``: the greedy engine,
    the int8 column and the LP cross-check on, the budget
    MAMBA2_BUDGET_FRACTION of the uniform default plan's bytes, K in {2, 4,
    6, 8}.  The LP must be optimal and within tolerance, the baseline loss
    finite, the artifact within the budget and stored as allocated; the eval
    harness scores it against a uniform plan that fits the same budget.
    Then served as phase 7b."""
    import repro_torch.eval as ev
    from repro_torch.compression import CompressionPolicy, execute_plan, plan_compression
    from repro_torch.compression.autotune import refine
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    cfg = mamba2_config()
    values, _ = split(init_model(cfg, seed=SEED, device=dev))
    full = plan_compression(values, CompressionPolicy()).total_bytes()
    budget = int(MAMBA2_BUDGET_FRACTION * full)
    cvalues, artifact, result, records, wall, execute_s = budget_compress(
        torch, dev, cfg, values, out_dir, budget,
        ((refine, "calibration_weights"), (ev, "build_metric_table"),
         (refine, "allocate_budget")),
        engine="greedy", objective="eval_loss", k_fractions=AUTOTUNE_K_FRACTIONS)
    lp, table = result.lp_check, result.metric_table
    check(lp["status"] == "optimal" and lp["within_tolerance"],
          f"phase 8b: LP cross-check {lp}")
    check(math.isfinite(table.baseline.loss), f"phase 8b: baseline loss {table.baseline.loss}")
    # the uniform plan of the most K that fits the same budget
    for K in (3, 2, 1):
        uplan = plan_compression(values, CompressionPolicy(rank_ratio=K / 32))
        if uplan.total_bytes() <= budget:
            break
    t = time.time()
    uvalues, _ = execute_plan(uplan, values, seed=SEED, device=dev)
    harness = ev.EvalHarness(cfg, seed=SEED, device=dev)      # the autotuner's harness
    base = harness.baseline(values)
    auto_loss = harness.evaluate(cvalues).loss
    uniform_loss = harness.evaluate(uvalues).loss
    score_s = time.time() - t
    del values, uvalues, cvalues
    by = {r["stage"]: r for r in records}
    counts = {}
    for pt in result.allocation.choices.values():
        key = "dense" if pt.dense else ("int8" if pt.method == "int8" else f"K{pt.K}")
        counts[key] = counts.get(key, 0) + 1

    def uses(path, e):
        return 0 if e["method"] == "int8" else layer_slices(path, e)

    per_forward = sum(uses(p, e) for p, e in artifact.manifest["tensors"].items())
    t = time.time()
    gen = ssm_generate(torch, dev, cfg, out_dir, uses, 0, per_forward, per_forward,
                       "phase 8b")
    serve_s = time.time() - t
    out = {"budget_bytes": budget, "uniform_default_bytes": full,
           "allocated_bytes": result.allocation.total_bytes,
           "stored_bytes": artifact.total_bytes(), "engine": "greedy",
           "objective": "eval_loss", "k_fractions": list(AUTOTUNE_K_FRACTIONS),
           "choices": counts, "lp_check": lp,
           "table": {"baseline_loss": table.baseline.loss, "alpha": table.alpha,
                     "exact_paths": list(table.exact_paths),
                     "surrogate_skip_rate": table.surrogate_skip_rate,
                     "build_s": table.build_s,
                     "rows": {p: [{k: r[k] for k in ("K", "method", "bytes", "delta",
                                                     "sample_fraction")} for r in rows]
                              for p, rows in table.entries.items()}},
           "eval_loss": {"baseline": base.loss, "autotuned": auto_loss,
                         "autotuned_delta": auto_loss - base.loss,
                         "uniform_rank_ratio": f"{K}/32", "uniform_bytes": uplan.total_bytes(),
                         "uniform": uniform_loss, "uniform_delta": uniform_loss - base.loss,
                         "score_s": score_s},
           "wall_s": {"compress_model": wall, "calibrate": by["calibration_weights"]["s"],
                      "metric_table": by["build_metric_table"]["s"],
                      "solve": result.allocation.solve_s, "allocate": by["allocate_budget"]["s"],
                      "execute": execute_s, "serve": serve_s},
           **gen}
    emit({"mamba2_autotune": out})
    return out


# ---------------------------------------------------------------------------
# phases 9, 10, 10b and 10c: delta recompression (compression/delta.py) and
# streaming compression (compression/streaming.py, checkpoint leaf readers,
# distributed/fault_tolerance.py)
# ---------------------------------------------------------------------------

DELTA_NOISED = ("attn/wk", "attn/wv", "mlp/down")   # phase 9 (b)'s fine-tuned tensors
DELTA_SEED = 2
# the surrogate budget of a delta's BBO pool on the card: the re-solved
# wk/wv tiles in one lock-step chunk (the 64 MiB default sizes chunks for a
# CPU's cache: 64 tiles of 8 x 128 at K = 3)
DELTA_POOL_BUDGET = 4 << 30
NEW_PHASE_STEPS = 8                  # new tokens of the serves of phases 9, 10 and 10c
# phase 10c's threshold: a streamed parent has no tile_resid, so drift is
# held against rel_err x ||W_new||, which a ratio cannot pass 1 / rel_err
# (~1.11 at random weights' rel_err ~0.9): a tile whose rows were re-drawn
# at the tensor's std reads ~1.04-1.07, an untouched one ~0.98-1.02, and
# the default 1.25 re-solves nothing
CLI_DELTA_THRESHOLD = 1.03
CHILD_TIMEOUT_S = 600


def set_leaf(tree, path, value):
    """A copy of ``tree`` (dicts along ``path`` copied, every other leaf
    shared) with the leaf at ``path`` replaced."""
    head, *rest = path.split("/")
    out = dict(tree)
    out[head] = set_leaf(tree[head], "/".join(rest), value) if rest else value
    return out


def band_noise(torch, values, manifest, patterns, seed, dev):
    """``values`` with Gaussian noise of each tensor's own std added to every
    fourth band of tile_n rows of each manifested tensor whose path holds
    one of ``patterns`` (a fine-tune that rewrote a quarter of its rows).
    Returns (the drifted tree, {path: the noised tiles, a bool mask in
    execute's tile order})."""
    import numpy as np

    g = torch.Generator(device=dev).manual_seed(seed)
    out, masks = values, {}
    for path, e in manifest["tensors"].items():
        if not any(p in path for p in patterns):
            continue
        W = leaf(values, path)
        Wf = W.float()
        band = (torch.arange(W.shape[-2], device=dev) // e["tile_n"]) % 4 == 0
        noise = torch.randn(W.shape, generator=g, device=dev) * Wf.std()
        out = set_leaf(out, path, torch.where(band[:, None], Wf + noise, Wf).to(W.dtype))
        r, c = W.shape[-2] // e["tile_n"], W.shape[-1] // e["tile_d"]
        rows = np.arange(r) % 4 == 0
        masks[path] = np.tile(np.repeat(rows, c), e["groups"])
    return out, masks


def squared_resid(manifest):
    return sum(sum(v * v for v in e["tile_resid"]) for e in manifest["tensors"].values())


def counting_warm_solves():
    """Wrap ``ising.solve_many_from``: returns (calls, restore), calls a
    list of whether each call was given ``init_state``."""
    from repro_torch.core import ising

    calls, solve = [], ising.solve_many_from

    def run(*a, **k):
        calls.append(k.get("init_state") is not None)
        return solve(*a, **k)

    ising.solve_many_from = run

    def restore():
        ising.solve_many_from = solve
    return calls, restore


def qwen_serve_check(torch, dev, cfg, ckpt_dir, steps, label):
    """``serve_model`` from a qwen3-32b block's checkpoint (phase 4's serve at
    ``steps`` new tokens): K3 once per compressed tensor a forward, per
    schedule as the manifest's table (phase 4b's) implies, K5 once a
    prefill, no K1; tokens in range; the prefill logits with the kernels
    within LOGIT_TOL of max|logit| of the plain path."""
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import init_cache
    from repro_torch.serving import make_prefill

    eos = cfg.vocab_size
    autotune.clear_schedules()
    autotune.clear_log()
    torch.cuda.synchronize()
    sa.sa_sweep_many.launches = 0
    bl.reset_counts()
    fa.flash_attention.launches = 0
    res = serve_model(cfg, ckpt_dir=ckpt_dir, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
                      steps=steps, eos_id=eos, seed=SEED, device=dev, verbose=False)
    torch.cuda.synchronize()
    eng = res.engine
    launches = {"bitlinear": bl.bitlinear.launches, "flash_attention": fa.flash_attention.launches,
                "sa_sweep_many": sa.sa_sweep_many.launches}
    n = eng.compression["tensors"]
    check(launches == {"bitlinear": n * steps, "flash_attention": cfg.num_layers,
                       "sa_sweep_many": 0},
          f"{label}: launches {launches}, want K3 {n} x {steps}, K5 {cfg.num_layers}")
    table = (eng.artifact.manifest.get("kernel_schedules") or {}).get("entries")
    by_schedule = served(bl.bitlinear)
    if table:
        want = implied_launches(eng.artifact.manifest, table, dev, qwen_tokens, steps=steps)
        check(by_schedule == want.get("bitlinear"),
              f"{label}: launches per schedule {by_schedule}, the table implies {want}")
    toks = res.tokens
    check(tuple(toks.shape) == (GEN_BATCH, GEN_PROMPT + steps)
          and torch.equal(toks[:, :GEN_PROMPT], res.prompts)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"{label}: generated tokens {tuple(toks.shape)} out of shape or range")
    max_len = GEN_PROMPT + steps
    with torch.inference_mode():
        lk, _ = eng.prefill(eng.params, {"tokens": res.prompts},
                            init_cache(cfg, GEN_BATCH, max_len, device=dev))
        with ops.kernels_off():
            lp, _ = make_prefill(cfg)(eng.params, {"tokens": res.prompts},
                                      init_cache(cfg, GEN_BATCH, max_len, device=dev))
    lk, lp = lk.float(), lp.float()
    check(bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all()),
          f"{label}: prefill logits are not finite")
    scale = float(lp.abs().max())
    err = float((lk - lp).abs().max())
    check(err <= LOGIT_TOL * scale,
          f"{label}: prefill logits kernels vs plain: {err:.3g} > {LOGIT_TOL} x {scale:.3g}")
    t = res.timing
    return {"launches": launches, "bitlinear_by_schedule": by_schedule,
            "resolutions_from": sorted({r["source"] for r in autotune.last_resolutions()}),
            "steps": steps, "ttft_s": t["prefill_s"],
            "decode_ms_per_step": 1e3 * t["decode_s"] / t["decode_steps"],
            "prefill_logits": {"max_abs_diff": err, "max_abs_logit": scale,
                               "tol": LOGIT_TOL * scale},
            "compression": eng.compression}


def phase_delta(torch, dev, parent_dir, delta_dir):
    """Delta recompression of phase 2's artifact (a full-width qwen3-32b
    block: alternating at 32 x 128, K = 4; attn/w[kv] BBO at 8 x 128, K = 3,
    32 iterations; phase 4b's table in its manifest).

    (a) Unchanged weights: every drift ratio within 1e-4 of 1.0, no tile
    re-solved, K1 not launched, every stored tensor and manifest entry the
    parent's, the lineage naming the parent's fingerprint.
    (b) Every fourth band of tile_n rows of attn/wk, attn/wv and mlp/down
    re-drawn with noise of the tensor's std: exactly the noised tiles
    re-solve, every other tensor stays the parent's, K1 launches 32 x the
    BBO pool's chunks, every one warm (``init_state``), and the total
    squared ``tile_resid`` is no more than a cold ``execute_plan`` of the
    drifted weights' (x (1 + 1e-6); the cold execute chunks BBO as phase 2
    did, so the unchanged tiles come out as the parent's).  Then the delta
    checkpoint is served (``qwen_serve_check``)."""
    import numpy as np

    from repro_torch.checkpoint import checkpointer
    from repro_torch.compression import CompressionArtifact, delta_recompress, execute_plan
    from repro_torch.compression import plan_compression
    from repro_torch.compression.delta import DEFAULT_DRIFT_THRESHOLD, plan_delta
    from repro_torch.compression.execute import POOL_BUDGET_ENV
    from repro_torch.compression.plan import tree_paths
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    _, cfg = full_width_config()
    values, _ = split(init_model(cfg, seed=SEED, device=dev))
    parent = CompressionArtifact.load(parent_dir)
    prev = checkpointer.restore(parent_dir, 0, {"params": parent.restore_template(values)},
                                device=dev)["params"]
    tensors = parent.manifest["tensors"]
    fp = parent.fingerprint()

    # (a) unchanged weights
    dplan = plan_delta(parent, prev, values, device=dev)
    ratio_dev = max(float(np.abs(d.ratio - 1.0).max()) for d in dplan.drifts)
    check(all(d.recorded for d in dplan.drifts) and ratio_dev <= 1e-4,
          f"phase 9a: max |drift ratio - 1| {ratio_dev:.3g} on unchanged weights")
    torch.cuda.synchronize()
    sa.sa_sweep_many.launches = 0
    t0 = time.time()
    cv_a, art_a = delta_recompress(parent, prev, values, seed=SEED, device=dev)
    torch.cuda.synchronize()
    wall_a = time.time() - t0
    d = art_a.delta
    check(sa.sa_sweep_many.launches == 0 and d["tiles_resolved"] == 0
          and d["tensors_touched"] == 0 and d["parent_fingerprint"] == fp
          and d["generation"] == 1 and art_a.manifest["tensors"] == tensors,
          f"phase 9a: K1 {sa.sa_sweep_many.launches}, lineage {d}")
    flat_a, flat_prev, flat_v = (dict(tree_paths(t)) for t in (cv_a, prev, values))
    for p, v in flat_a.items():
        want = flat_prev[p] if p.rsplit("/", 1)[0] in tensors else flat_v[p]
        check(torch.equal(v, want), f"phase 9a: {p} differs from the parent")

    # (b) a quarter of three tensors' rows rewritten
    drifted, masks = band_noise(torch, values, parent.manifest, DELTA_NOISED, DELTA_SEED, dev)
    dplan_b = plan_delta(parent, prev, drifted, device=dev)
    for dr in dplan_b.drifts:
        want = masks.get(dr.path, np.zeros(dr.drift.size, bool))
        check(np.array_equal(dplan_b.masks[dr.path], want),
              f"phase 9b: {dr.path} re-solves {int(dplan_b.masks[dr.path].sum())} tiles, "
              f"{int(want.sum())} were noised")
    noised_ratio_min = min(float(dr.ratio[masks[dr.path]].min())
                           for dr in dplan_b.drifts if dr.path in masks)
    old_budget = os.environ.get(POOL_BUDGET_ENV)
    os.environ[POOL_BUDGET_ENV] = str(DELTA_POOL_BUDGET)
    calls, restore = counting_warm_solves()
    try:
        torch.cuda.synchronize()
        sa.sa_sweep_many.launches = 0
        t0 = time.time()
        cv_b, art_b = delta_recompress(parent, prev, drifted, seed=SEED, device=dev)
        torch.cuda.synchronize()
        delta_wall = time.time() - t0
        k1 = sa.sa_sweep_many.launches
    finally:
        restore()
        if old_budget is None:
            os.environ.pop(POOL_BUDGET_ENV, None)
        else:
            os.environ[POOL_BUDGET_ENV] = old_budget
    d = art_b.delta
    bbo = [p for p in art_b.manifest["pools"] if p["method"] == "bbo"]
    check(len(bbo) == 1 and k1 == BBO_ITERS * bbo[0]["chunks"] == len(calls) and all(calls),
          f"phase 9b: K1 launched {k1} times ({sum(calls)} of {len(calls)} solves warm), BBO "
          f"pools {bbo}")
    check(d["tiles_resolved"] == sum(int(m.sum()) for m in masks.values())
          and d["tensors_touched"] == len(masks) == len(DELTA_NOISED),
          f"phase 9b: lineage {d}")
    flat_b = dict(tree_paths(cv_b))
    for path, e in tensors.items():
        if path in masks:
            continue
        check(art_b.manifest["tensors"][path] == e
              and all(torch.equal(flat_b[f"{path}/{k}"], flat_prev[f"{path}/{k}"])
                      for k in ("m_packed", "C")), f"phase 9b: {path} changed")
    # the cold solve of the same drifted weights, chunked as phase 2 chunked
    plan = plan_compression(drifted, policy())
    torch.cuda.synchronize()
    t0 = time.time()
    _, art_cold = execute_plan(plan, drifted, seed=SEED, device=dev, max_pool_tiles=10240)
    torch.cuda.synchronize()
    cold_wall = time.time() - t0
    dist_delta, dist_cold = squared_resid(art_b.manifest), squared_resid(art_cold.manifest)
    check(dist_delta <= dist_cold * (1 + 1e-6),
          f"phase 9b: delta's squared residual {dist_delta:.8g} above the cold "
          f"execute's {dist_cold:.8g}")
    del values, prev, cv_a, drifted
    checkpointer.save(delta_dir, 0, {"params": cv_b})
    art_b.save(delta_dir)
    del cv_b
    serve = qwen_serve_check(torch, dev, cfg, delta_dir, NEW_PHASE_STEPS, "phase 9")
    out = {"parent_fingerprint": fp,
           "unchanged": {"max_abs_ratio_minus_1": ratio_dev, "wall_s": wall_a,
                         "tiles_resolved": 0, "k1_launches": 0},
           "drifted": {"noised": {p: int(m.sum()) for p, m in masks.items()},
                       "threshold": DEFAULT_DRIFT_THRESHOLD,
                       "min_ratio_noised": noised_ratio_min,
                       "tiles_resolved": d["tiles_resolved"], "tiles_total": d["tiles_total"],
                       "fraction_resolved": d["fraction_resolved"],
                       "pools": [{k: p[k] for k in ("method", "tile_n", "tile_d", "K",
                                                    "num_tiles", "chunks", "solver_calls")}
                                 for p in art_b.manifest["pools"]],
                       "k1_launches": k1, "warm_solves": sum(calls),
                       "delta_wall_s": delta_wall, "cold_wall_s": cold_wall,
                       "delta_over_cold": delta_wall / cold_wall,
                       "squared_resid": {"delta": dist_delta, "cold": dist_cold,
                                         "delta_over_cold": dist_delta / dist_cold}},
           "serve": serve}
    emit({"delta_qwen": out})
    return out


def run_child(torch, args, label, *, env=None, want_rc=0):
    """``python3 args...`` from the checkout's root with the port on its path
    and no fault injected unless ``env`` asks; it must exit with ``want_rc``.
    Returns (the completed process, wall s)."""
    from repro_torch.compression.streaming import KILL_AFTER_ENV, STREAM_BUDGET_ENV

    child_env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for k in (KILL_AFTER_ENV, STREAM_BUDGET_ENV):
        child_env.pop(k, None)
    child_env.update(env or {})
    torch.cuda.synchronize()
    t0 = time.time()
    r = subprocess.run([sys.executable, *args], cwd=ROOT, env=child_env, capture_output=True,
                       text=True, timeout=CHILD_TIMEOUT_S)
    wall = time.time() - t0
    check(r.returncode == want_rc,
          f"{label}: exit {r.returncode}, want {want_rc}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return r, wall


def child_json(r, tag, label):
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith(tag + " ")]
    check(len(lines) == 1, f"{label}: no {tag} line in\n{r.stdout[-2000:]}")
    return json.loads(lines[0][len(tag) + 1:])


def key_values(text):
    """The ``key=value`` lines of the compress CLI, as numbers."""
    out = {}
    for ln in text.splitlines():
        m = re.fullmatch(r"([a-z_]+)=([-+0-9.eE]+)", ln.strip())
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def dir_bytes(d):
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs)


def same_files(a, b):
    """Relative paths under ``a`` and ``b`` and whether every file's bytes
    agree."""
    import filecmp

    rel = sorted(os.path.relpath(os.path.join(r, f), a) for r, _, fs in os.walk(a) for f in fs)
    rel_b = sorted(os.path.relpath(os.path.join(r, f), b) for r, _, fs in os.walk(b) for f in fs)
    return rel == rel_b and all(filecmp.cmp(os.path.join(a, p), os.path.join(b, p),
                                            shallow=False) for p in rel)


# a streaming job as its own process: the kill and the peak RSS are per process
STREAM_CHILD = r"""
import json, sys, time
import torch
from repro_torch.compression import CheckpointLeafSource, CompressionPolicy, plan_compression
from repro_torch.compression.streaming import _status_bytes, run_compression_job
rss_imported = _status_bytes("VmRSS")
src = CheckpointLeafSource(sys.argv[1])
plan = plan_compression(src.template(), CompressionPolicy())
art, stats = run_compression_job(src, plan, sys.argv[2], seed=int(sys.argv[3]), device="cuda")
torch.cuda.synchronize()
print("STREAM_STATS " + json.dumps({**stats, "rss_after_import_bytes": rss_imported,
                                    "device": torch.cuda.get_device_name(0)}))
"""


def phase_zamba_stream(torch, dev, execute_dir, work_dir):
    """The whole zamba2-1.2b (phase 7's weights: seed 0, default policy)
    saved dense and compressed by ``run_compression_job`` from a
    ``CheckpointLeafSource`` at the default 1 GiB host budget, in child
    processes: A with ``REPRO_STREAM_KILL_AFTER`` at half the leaves must die
    by SIGKILL; B resumes A's job (its resumed leaves A's count, no
    restart); C runs uninterrupted.  Every compressed leaf of B must equal
    phase 7's ``execute_plan`` leaf byte for byte, and B's output directory
    C's.  Then B's checkpoint is served as phase 7 (``ssm_generate``)."""
    from repro_torch.checkpoint import checkpointer
    from repro_torch.compression.streaming import KILL_AFTER_ENV, STATE_NAME
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    cfg = zamba_config()
    dense = os.path.join(work_dir, "dense")
    values, _ = split(init_model(cfg, seed=SEED, device=dev))
    torch.cuda.synchronize()
    t0 = time.time()
    checkpointer.save(dense, 0, {"params": values})
    save_s = time.time() - t0
    del values
    torch.cuda.empty_cache()
    n_leaves = len(checkpointer.leaf_entries(dense, 0))
    kill_after = n_leaves // 2
    out_b, out_c = os.path.join(work_dir, "B"), os.path.join(work_dir, "C")
    prog = ["-c", STREAM_CHILD, dense]
    ra, wall_a = run_child(torch, [*prog, out_b, str(SEED)], "phase 10 child A",
                           env={KILL_AFTER_ENV: str(kill_after)}, want_rc=-9)
    state = checkpointer.load_aux(out_b, STATE_NAME)
    done_a = len(state["completed"]) + len(state["dense"])
    check(done_a == kill_after, f"phase 10: child A left {done_a} leaves, killed after "
                                f"{kill_after}")
    rb, wall_b = run_child(torch, [*prog, out_b, str(SEED)], "phase 10 child B")
    sb = child_json(rb, "STREAM_STATS", "phase 10 child B")
    check(sb["resumed_leaves"] == done_a and sb["restarts"] == 0
          and sb["leaves_done_this_run"] == n_leaves - done_a,
          f"phase 10: child B {sb}, A left {done_a} of {n_leaves} leaves")
    rc, wall_c = run_child(torch, [*prog, out_c, str(SEED)], "phase 10 child C")
    sc = child_json(rc, "STREAM_STATS", "phase 10 child C")
    check(sc["resumed_leaves"] == 0 and sc["restarts"] == 0
          and sc["leaves_done_this_run"] == n_leaves, f"phase 10: child C {sc}")
    check(same_files(out_b, out_c), "phase 10: the resumed output differs from the "
                                    "uninterrupted one")
    # every compressed leaf as phase 7's execute_plan stored it
    ents_b = checkpointer.leaf_entries(out_b, 0)
    ents_x = checkpointer.leaf_entries(execute_dir, 0)
    manifest = checkpointer.load_aux(out_b, "compression_manifest.json")
    differ, compared = [], 0
    for path in manifest["tensors"]:
        for k in ("m_packed", "C"):
            name = f"params/{path}/{k}"
            fb = os.path.join(checkpointer.step_dir(out_b, 0), ents_b[name]["shards"][0]["file"])
            fx = os.path.join(checkpointer.step_dir(execute_dir, 0),
                              ents_x[name]["shards"][0]["file"])
            with open(fb, "rb") as a, open(fx, "rb") as b:
                if a.read() != b.read():
                    differ.append(name)
            compared += 1
    check(not differ, f"phase 10: streamed leaves differ from phase 7's execute: {differ}")
    tiles = sum(e["num_tiles"] for e in manifest["tensors"].values())
    check(tiles == 249856, f"phase 10: {tiles} tiles streamed")
    n_shared = zamba_shared_calls(cfg)
    gen = ssm_generate(torch, dev, cfg, out_b, zamba_uses(cfg), n_shared,
                       2 * cfg.num_layers + 7 * n_shared, 118, "phase 10",
                       steps=NEW_PHASE_STEPS)

    def child(st, wall):
        return {"wall_s": wall, "job_wall_s": st.get("wall_s"), "chunks": st.get("chunks"),
                "peak_rss_bytes": st.get("peak_rss_bytes"),
                "rss_after_import_bytes": st.get("rss_after_import_bytes"),
                "resumed_leaves": st.get("resumed_leaves"),
                "leaves_this_run": st.get("leaves_done_this_run"),
                "restarts": st.get("restarts")}

    out = {"leaves": n_leaves, "kill_after": kill_after, "tiles": tiles,
           "checkpoint_bytes": dir_bytes(checkpointer.step_dir(dense, 0)),
           "compressed_bytes": dir_bytes(checkpointer.step_dir(out_b, 0)),
           "save_s": save_s, "budget_bytes": sb["budget_bytes"],
           "chunk_tiles": sorted({e["stream"]["chunk"] for e in manifest["tensors"].values()}),
           "A": {"wall_s": wall_a, "rc": ra.returncode, "leaves_done": done_a},
           "B": child(sb, wall_b), "C": child(sc, wall_c),
           "leaves_equal_to_execute": compared, "resumed_equals_uninterrupted": True,
           "serve": gen}
    emit({"zamba2_stream": out})
    return out


PLAN_405B_CHILD = r"""
import json, sys, time
import torch
from repro_torch.compression import CompressionPolicy, TreeLeafSource, execute_streaming
from repro_torch.compression import plan_compression
from repro_torch.compression.streaming import (
    RssSampler, _status_bytes, peak_rss_bytes, streaming_autotune_plan)
from repro_torch.configs import get_config
from repro_torch.kernels import sa_sweep as sa
from repro_torch.models import init_model
from repro_torch.models.params import split
rss_imported = _status_bytes("VmRSS")
t0 = time.time()
with RssSampler() as rss:
    cfg = get_config(sys.argv[1])
    src = TreeLeafSource(split(init_model(cfg, seed=0, device="meta"))[0])
    policy = CompressionPolicy()
    uniform = plan_compression(src.template(), policy)
    budget = int(float(sys.argv[3]) * uniform.total_bytes())
    sa.sa_sweep_many.launches = 0
    res = streaming_autotune_plan(src, policy, budget, seed=0, device="cuda", engine="qubo",
                                  k_fractions=tuple(json.loads(sys.argv[2])))
    torch.cuda.synchronize()
wall = time.time() - t0
try:
    execute_streaming(src, res.plan, sys.argv[4], device="cuda")
    refused = None
except ValueError as e:
    refused = str(e)
probe = res.plan.autotune["probe"]
print("PLAN_STATS " + json.dumps({
    "wall_s": wall, "probe_s": res.probe_s, "peak_rss_bytes": peak_rss_bytes(rss.peak),
    "rss_after_import_bytes": rss_imported,
    "tensors": len(uniform.tensors), "tiles": sum(t.num_tiles for t in uniform.tensors),
    "dense_bytes": uniform.total_orig_bytes, "uniform_bytes": uniform.total_bytes(),
    "budget_bytes": budget, "allocated_bytes": res.allocation.total_bytes,
    "planned_bytes": res.plan.total_bytes(), "k1_launches": sa.sa_sweep_many.launches,
    "qubo_spins": res.allocation.num_spins, "engine": res.allocation.engine,
    "source": probe["source"], "factors": probe["factors"], "refused": refused,
    "choices": {p: [pt.tile_n, pt.tile_d, pt.K] for p, pt in res.allocation.choices.items()},
    "device": torch.cuda.get_device_name(0)}))
"""
PLAN_405B_ARCH = "llama3-405b"
PLAN_405B_BUDGET_FRACTION = 0.75


def phase_plan_405b(torch, dev, work_dir):
    """Planning from metadata alone, in a child process: llama3-405b's
    published config as a ``meta`` template (no weight allocated),
    ``streaming_autotune_plan`` with the QUBO engine, K in {2, 4, 6, 8}, to
    0.75 x the uniform default plan's bytes.  The allocation must fit, K1
    launch once (the QUBO), the probe read as synthetic, and
    ``execute_streaming`` refuse the source."""
    out_dir = os.path.join(work_dir, "refused")
    r, wall = run_child(torch, ["-c", PLAN_405B_CHILD, PLAN_405B_ARCH,
                                json.dumps(list(AUTOTUNE_K_FRACTIONS)),
                                str(PLAN_405B_BUDGET_FRACTION), out_dir], "phase 10b")
    st = child_json(r, "PLAN_STATS", "phase 10b")
    check(st["allocated_bytes"] <= st["budget_bytes"] and st["planned_bytes"] <= st["budget_bytes"],
          f"phase 10b: allocated {st['allocated_bytes']}, planned {st['planned_bytes']}, "
          f"budget {st['budget_bytes']}")
    check(st["k1_launches"] == 1 and st["engine"] == "qubo",
          f"phase 10b: K1 launched {st['k1_launches']} times ({st['engine']})")
    check(st["source"] == "synthetic", f"phase 10b: probe source {st['source']}")
    check(st["refused"] is not None and "metadata-only" in st["refused"]
          and not os.path.exists(out_dir), f"phase 10b: execute_streaming {st['refused']!r}")
    out = {"arch": PLAN_405B_ARCH, "child_wall_s": wall, **st,
           "k_fractions": list(AUTOTUNE_K_FRACTIONS), "budget_fraction": PLAN_405B_BUDGET_FRACTION}
    emit({"plan_405b": out})
    return out


def phase_mamba2_cli(torch, dev, work_dir):
    """The compress CLI on the whole mamba2-130m: its dense weights saved (A),
    ``--streaming --ckpt-dir A --out-dir B``, every fourth band of tile_n
    rows of every out_proj re-drawn (A2, as phase 9 (b)), then
    ``--delta-from B --ckpt-dir A2 --out-dir C`` (at CLI_DELTA_THRESHOLD:
    B was streamed, so the drift baseline is estimated).  Each run's
    ``key=value`` lines must parse, the delta report its estimated baseline
    and re-solve a fraction strictly between 0 and 1, and C is served as
    phase 7b."""
    from repro_torch.checkpoint import checkpointer
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    cfg = mamba2_config()
    a, a2, b, c = (os.path.join(work_dir, x) for x in ("A", "A2", "B", "C"))
    values, _ = split(init_model(cfg, seed=SEED, device=dev))
    checkpointer.save(a, 0, {"params": values})
    cli = ["-m", "repro_torch.launch.compress", "--arch", MAMBA2_ARCH, "--seed", str(SEED)]
    rs, wall_s = run_child(torch, [*cli, "--streaming", "--ckpt-dir", a, "--out-dir", b],
                           "phase 10c streaming")
    kv_s = key_values(rs.stdout)
    check({"stream_wall_s", "peak_rss_bytes"} <= set(kv_s),
          f"phase 10c: streaming printed {kv_s}\n{rs.stdout[-2000:]}")
    manifest_b = checkpointer.load_aux(b, "compression_manifest.json")
    drifted, masks = band_noise(torch, values, manifest_b, ("out_proj",), DELTA_SEED, dev)
    check(len(masks) == 1, f"phase 10c: noised {sorted(masks)}")
    checkpointer.save(a2, 0, {"params": drifted})
    del values, drifted
    rd, wall_d = run_child(torch, [*cli, "--delta-from", b, "--ckpt-dir", a2, "--out-dir", c,
                                   "--delta-threshold", str(CLI_DELTA_THRESHOLD)],
                           "phase 10c delta")
    kv_d = key_values(rd.stdout)
    check({"delta_wall_s", "fraction_resolved"} <= set(kv_d),
          f"phase 10c: delta printed {kv_d}\n{rd.stdout[-2000:]}")
    check("(estimated baseline)" in rd.stdout, "phase 10c: the delta did not estimate its "
                                               "baseline against a streamed parent")
    frac = kv_d["fraction_resolved"]
    manifest_c = checkpointer.load_aux(c, "compression_manifest.json")
    per = manifest_c["delta"]["per_tensor"]
    noised = {p: int(m.sum()) for p, m in masks.items()}
    check(0 < frac < 1 and all(e["resolved"] == 0 for p, e in per.items() if p not in noised),
          f"phase 10c: fraction re-solved {frac}, per tensor {per}, noised {noised}")
    gen = ssm_generate(torch, dev, cfg, c, layer_slices, 0, 2 * cfg.num_layers, 48,
                       "phase 10c", steps=NEW_PHASE_STEPS)
    out = {"streaming": {"child_wall_s": wall_s, **kv_s},
           "delta": {"child_wall_s": wall_d, **kv_d, "threshold": CLI_DELTA_THRESHOLD,
                     "per_tensor": per, "noised": noised},
           "checkpoint_bytes": dir_bytes(checkpointer.step_dir(a, 0)), "serve": gen}
    emit({"mamba2_cli": out})
    return out


# phase 11: granite-moe-1b-a400m trained whole, killed and resumed, then
# through the compression cycle and served
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 6, 3, 5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 1024, 2
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
RESUME_TOL = 1e-3                    # attempt 1's recomputed losses against attempt 0's
CYCLE_EVERY, CYCLE_STEPS = 2, 2      # 11b: firings at steps 6 and 8
# 11b's drift threshold.  The default 1.25 is sized for a fine-tune that
# rewrites rows (phase 9): two AdamW steps at lr 1e-3 move a bf16 weight by
# ~2e-3 against a std of 1/32, which lifts a tile's residual by well under 1%
# (PERF.md, PR 25), so at 1.25 nothing would re-solve.  1.001 re-solves the
# tiles whose residual grew by more than 0.1%.
CYCLE_THRESHOLD = 1.001


def train_args(ckpt_dir):
    from repro_torch.launch import train as train_cli

    return train_cli.build_parser().parse_args([
        "--arch", MOE_ARCH, "--steps", str(TRAIN_STEPS), "--seq-len", str(TRAIN_SEQ),
        "--batch", str(TRAIN_BATCH), "--microbatches", str(TRAIN_MICRO), "--lr", str(TRAIN_LR),
        "--warmup", str(TRAIN_WARMUP), "--seed", str(SEED), "--ckpt-dir", ckpt_dir,
        "--ckpt-every", str(TRAIN_CKPT_EVERY), "--keep-last", "1", "--log-every", "1",
        "--fail-at-step", str(TRAIN_FAIL_AT), "--max-restarts", "1"])


def phase_granite_train(torch, dev, ckpt_dir):
    """11a: ``train_once`` under ``run_with_restarts`` on the whole
    granite-moe-1b-a400m (AdamW, f32 accumulation, remat), 8 x 1,024 tokens a
    step in 2 microbatches, 6 steps, checkpoints every 3 (keep 1), one crash
    injected at step 5.  One restart; attempt 1 resumes from step 3 and its
    losses at steps 4 and 5 are within RESUME_TOL of attempt 0's; every loss
    finite; step 6's below step 1's.  Returns (the report, a list holding the
    final state, which phase 11b takes out of it)."""
    from repro_torch.distributed.fault_tolerance import run_with_restarts
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.launch import train as train_cli

    args = train_args(ckpt_dir)
    events, finals, failures = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    def report(e):
        # the device memory the state holds, read as soon as it is built
        if e["event"] == "state":
            torch.cuda.synchronize()
            e = dict(e, memory_allocated=torch.cuda.memory_allocated() - base)
        events.append(e)

    sa.sa_sweep_many.launches = 0
    bl.reset_counts()
    fa.flash_attention.launches = 0
    t0 = time.time()
    restarts = run_with_restarts(
        lambda a: finals.append(train_cli.train_once(args, a, device=dev, report=report)),
        max_restarts=1, on_failure=lambda a, e: failures.append(f"attempt {a}: {e}"))
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = (sa.sa_sweep_many.launches, bl.bitlinear.launches,
                bl.bitlinear_grouped.launches, fa.flash_attention.launches)
    check(launched == (0, 0, 0, 0), f"phase 11a: training launched a kernel {launched}")
    check(restarts == 1 and len(finals) == 1 and failures == ["attempt 0: injected failure "
                                                              "(--fail-at-step)"],
          f"phase 11a: {restarts} restarts, failures {failures}")
    resumes = [e for e in events if e["event"] == "resume"]
    check([(e["attempt"], e["step"]) for e in resumes] == [(1, TRAIN_CKPT_EVERY)],
          f"phase 11a: resumes {resumes}")
    steps = {(e["attempt"], e["step"]): e for e in events if e["event"] == "step"}
    want = [(0, s) for s in range(1, TRAIN_FAIL_AT + 1)] + \
        [(1, s) for s in range(TRAIN_CKPT_EVERY + 1, TRAIN_STEPS + 1)]
    check(sorted(steps) == want, f"phase 11a: steps logged {sorted(steps)}, want {want}")
    check(all(math.isfinite(e["loss"]) and math.isfinite(e["grad_norm"])
              for e in steps.values()), "phase 11a: a loss or grad norm is not finite")
    gaps = {}
    for s in range(TRAIN_CKPT_EVERY + 1, TRAIN_FAIL_AT + 1):
        a0, a1 = steps[(0, s)]["loss"], steps[(1, s)]["loss"]
        gaps[s] = abs(a1 - a0) / abs(a0)
        check(gaps[s] <= RESUME_TOL, f"phase 11a: step {s} loss {a1} after the resume, "
                                     f"{a0} before ({gaps[s]:.3g} > {RESUME_TOL})")
    first, last = steps[(0, 1)]["loss"], steps[(1, TRAIN_STEPS)]["loss"]
    check(last < first, f"phase 11a: loss {last} at step {TRAIN_STEPS}, {first} at step 1")
    saves = [e for e in events if e["event"] == "save"]
    check([e["step"] for e in saves] == [TRAIN_CKPT_EVERY, TRAIN_STEPS],
          f"phase 11a: saves {saves}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    per_step = [{"attempt": a, "step": s, "loss": e["loss"], "grad_norm": e["grad_norm"],
                 "lr": e["lr"], "ms": 1e3 * e["s"], "tokens_per_s": tokens / e["s"]}
                for (a, s), e in sorted(steps.items())]
    steady = [r["ms"] for r in per_step if (r["attempt"], r["step"]) != (0, 1)]
    recomputed_s = sum(steps[(1, s)]["s"] for s in range(TRAIN_CKPT_EVERY + 1, TRAIN_FAIL_AT + 1))
    out = {"arch": MOE_ARCH, "optimizer": args.optimizer, "accum_dtype": "float32",
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
           "lr": TRAIN_LR, "warmup": TRAIN_WARMUP, "steps": per_step,
           "first_step_ms": per_step[0]["ms"], "median_ms": statistics.median(steady),
           "median_tokens_per_s": tokens / (statistics.median(steady) / 1e3),
           "resume_loss_rel_gap": gaps, "restarts": restarts,
           "peak_memory_allocated_bytes": peak,
           # attempt 0's state (weights, moments, step) right after it was built
           "state_memory_allocated_bytes": next(e["memory_allocated"] for e in events
                                                if e["event"] == "state" and e["attempt"] == 0),
           "checkpoint_bytes": dir_bytes(os.path.join(ckpt_dir, f"step_{TRAIN_STEPS:08d}")),
           "saves": [{k: e[k] for k in ("step", "host_copy_s", "write_s")} for e in saves],
           "restore_s": resumes[0]["restore_s"],
           # the time to recover: restore, then recompute the steps lost
           "recover_s": resumes[0]["restore_s"] + recomputed_s, "wall_s": wall}
    emit({"granite_train": out})
    return out, finals


def tile_resid_summary(manifest):
    return {p: {"mean": statistics.fmean(e["tile_resid"]), "max": max(e["tile_resid"])}
            for p, e in manifest["tensors"].items()}


def phase_granite_cycle(torch, dev, ckpt_dir, finals, serve_dir):
    """11b: step 6 restored (byte-equal to the run's final state), then
    ``CompressionCycle(policy(), every=2)``: cold at step 6, two more train
    steps (lr 1e-3), a delta at step 8 at CYCLE_THRESHOLD.  K1 launches in
    both firings, every delta solve warm (``init_state``), the re-solved
    tiles exactly those whose drift ratio passed the threshold, untouched
    tensors the parent's bytes.  Step 8's artifact is saved for 11c.
    ``finals`` holds 11a's final state, taken out (and freed) here."""
    import numpy as np

    from repro_torch.checkpoint import checkpointer
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.compression.delta import DEFAULT_DRIFT_THRESHOLD, plan_delta
    from repro_torch.compression.execute import POOL_BUDGET_ENV
    from repro_torch.compression.plan import tree_paths
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.optim import constant
    from repro_torch.optim.grad_compress import CompressionCycle
    from repro_torch.training import init_train_state, make_train_step

    args = train_args(ckpt_dir)
    cfg = moe_config()
    pcfg = ParallelConfig(mesh_shape=(1, 1), mesh_axes=("data", "model"),
                          microbatches=args.microbatches, optimizer=args.optimizer)
    final = finals.pop()
    torch.cuda.synchronize()
    t0 = time.time()
    step, state = CheckpointManager(ckpt_dir).restore_latest(
        init_train_state(SEED, cfg, pcfg, device="meta"), device=dev)
    torch.cuda.synchronize()
    restore_s = time.time() - t0
    check(step == TRAIN_STEPS, f"phase 11b: latest checkpoint {step}")
    got, want = tree_paths(state), tree_paths(final)
    check([p for p, _ in got] == [p for p, _ in want]
          and all(a.dtype == b.dtype and torch.equal(a, b) for (_, a), (_, b) in zip(got, want)),
          "phase 11b: the restored state differs from the one saved")
    del final, got, want

    old_budget = os.environ.get(POOL_BUDGET_ENV)
    os.environ[POOL_BUDGET_ENV] = str(DELTA_POOL_BUDGET)
    try:
        cycle = CompressionCycle(policy(), every=CYCLE_EVERY, seed=SEED, device=dev,
                                 threshold=CYCLE_THRESHOLD)
        torch.cuda.synchronize()
        sa.sa_sweep_many.launches = 0
        t0 = time.time()
        cold_cv, cold = cycle.maybe_recompress(TRAIN_STEPS, state.params)
        torch.cuda.synchronize()
        cold_wall, k1_cold = time.time() - t0, sa.sa_sweep_many.launches
        bbo = [p for p in cold.manifest["pools"] if p["method"] == "bbo"]
        check(cold.delta is None and len(bbo) == 1
              and k1_cold == BBO_ITERS * bbo[0]["chunks"] > 0,
              f"phase 11b: cold firing launched K1 {k1_cold} times, BBO pools {bbo}")

        step_fn = make_train_step(cfg, pcfg, constant(TRAIN_LR))
        pipe = make_pipeline(cfg, ShapeConfig("custom", "train", TRAIN_SEQ, TRAIN_BATCH),
                             seed=SEED, device=dev)
        losses = []
        for s in range(TRAIN_STEPS, TRAIN_STEPS + CYCLE_STEPS):
            state, m = step_fn(state, pipe.batch_at(s))
            losses.append(float(m["loss"]))
        check(all(math.isfinite(v) for v in losses), f"phase 11b: losses {losses}")
        new_step = int(state.step)
        check(cycle.maybe_recompress(new_step - 1, state.params) is None,
              "phase 11b: the cycle fired off its schedule")

        dplan = plan_delta(cold, cold_cv, state.params, CYCLE_THRESHOLD, device=dev)
        calls, restore = counting_warm_solves()
        try:
            torch.cuda.synchronize()
            sa.sa_sweep_many.launches = 0
            t0 = time.time()
            cv, art = cycle.maybe_recompress(new_step, state.params)
            torch.cuda.synchronize()
            delta_wall, k1_delta = time.time() - t0, sa.sa_sweep_many.launches
        finally:
            restore()
    finally:
        if old_budget is None:
            os.environ.pop(POOL_BUDGET_ENV, None)
        else:
            os.environ[POOL_BUDGET_ENV] = old_budget
    d = art.delta
    check(d is not None and d["parent_fingerprint"] == cold.fingerprint()
          and d["generation"] == 1, f"phase 11b: the second firing was not a delta: {d}")
    check(k1_delta > 0 and len(calls) > 0 and all(calls),
          f"phase 11b: delta launched K1 {k1_delta} times ({sum(calls)} of {len(calls)} "
          "solves warm)")
    masks = dplan.masks
    check(d["tiles_resolved"] == sum(int(m.sum()) for m in masks.values())
          and d["tensors_touched"] == sum(bool(m.any()) for m in masks.values()),
          f"phase 11b: lineage {d}, drift masks re-solve "
          f"{ {p: int(m.sum()) for p, m in masks.items()} }")
    flat_new, flat_old = dict(tree_paths(cv)), dict(tree_paths(cold_cv))
    for path, e in cold.manifest["tensors"].items():
        if masks[path].any():
            continue
        check(art.manifest["tensors"][path] == e
              and all(torch.equal(flat_new[f"{path}/{k}"], flat_old[f"{path}/{k}"])
                      for k in ("m_packed", "C")), f"phase 11b: untouched {path} changed")
    drift = {}
    for dr in dplan.drifts:
        r = dr.ratio
        drift[dr.path] = {"tiles": int(r.size), "resolved": int(masks[dr.path].sum()),
                          "fraction_resolved": float(masks[dr.path].mean()),
                          "fraction_over_default": float((r > DEFAULT_DRIFT_THRESHOLD).mean()),
                          "ratio_min": float(r.min()), "ratio_median": float(np.median(r)),
                          "ratio_p99": float(np.quantile(r, 0.99)), "ratio_max": float(r.max())}
    del state, step_fn, cold_cv
    torch.cuda.empty_cache()
    checkpointer.save(serve_dir, 0, {"params": cv})
    art.save(serve_dir)
    out = {"restore_s": restore_s, "threshold": CYCLE_THRESHOLD,
           "default_threshold": DEFAULT_DRIFT_THRESHOLD, "train_losses": losses,
           "cold": {"step": TRAIN_STEPS, "wall_s": cold_wall, "k1_launches": k1_cold,
                    "pools": [{k: p[k] for k in ("method", "tile_n", "tile_d", "K",
                                                 "num_tiles", "chunks")}
                              for p in cold.manifest["pools"]],
                    "squared_resid": squared_resid(cold.manifest),
                    "tile_resid": tile_resid_summary(cold.manifest)},
           "delta": {"step": new_step, "wall_s": delta_wall, "k1_launches": k1_delta,
                     "warm_solves": sum(calls), "tiles_resolved": d["tiles_resolved"],
                     "tiles_total": d["tiles_total"],
                     "fraction_resolved": d["fraction_resolved"],
                     "squared_resid": squared_resid(art.manifest),
                     "tile_resid": tile_resid_summary(art.manifest)},
           "drift": drift}
    emit({"granite_cycle": out})
    return out


def phase_granite_serve(torch, dev, serve_dir):
    """11c: ``serve_model`` from step 8's artifact, 4 x 1,024 prompts, 8 new
    tokens: K4 3 x 24, K3 4 x 24 a forward, K5 24, per schedule as the
    resolutions imply; prefill logits on the checkpoint cast to f32 within
    LOGIT_TOL of the plain path (bf16 reported, as phase 5)."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.launch.serve import serve_model

    cfg = moe_config()
    L, steps = cfg.num_layers, NEW_PHASE_STEPS
    torch.cuda.synchronize()
    sa.sa_sweep_many.launches = 0
    bl.reset_counts()
    fa.flash_attention.launches = 0
    autotune.clear_schedules()
    autotune.clear_log()
    res = serve_model(cfg, ckpt_dir=serve_dir, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
                      steps=steps, eos_id=cfg.vocab_size, seed=SEED, device=dev, verbose=False)
    torch.cuda.synchronize()
    launches = {"bitlinear_grouped": bl.bitlinear_grouped.launches,
                "bitlinear": bl.bitlinear.launches,
                "flash_attention": fa.flash_attention.launches,
                "sa_sweep_many": sa.sa_sweep_many.launches}
    want = {"bitlinear_grouped": 3 * L * steps, "bitlinear": 4 * L * steps,
            "flash_attention": L, "sa_sweep_many": 0}
    check(launches == want, f"phase 11c: launches {launches}, want {want}")
    eng = res.engine
    by_schedule = {"bitlinear": served(bl.bitlinear),
                   "bitlinear_grouped": served(bl.bitlinear_grouped)}
    tensor_cores, clusters = heuristic_launches(torch, dev, eng.artifact.manifest, by_schedule,
                                                moe_tokens, "phase 11c", steps=steps)
    toks = res.tokens
    check(tuple(toks.shape) == (GEN_BATCH, GEN_PROMPT + steps)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"phase 11c: generated tokens {tuple(toks.shape)} out of shape or range")
    bf16 = moe_prefill_pair(torch, cfg, eng.params, res.prompts, dev)
    f32 = moe_prefill_pair(torch, dataclasses.replace(cfg, dtype="float32"),
                           _to_f32(eng.params), res.prompts, dev)
    want_prefill = {"bitlinear": 4 * L, "bitlinear_grouped": 3 * L, "flash_attention": L}
    for name, pair in (("bf16", bf16), ("f32", f32)):
        check(pair.pop("kernel_launches") == want_prefill,
              f"phase 11c: {name} prefill did not run every kernel once per layer")
    check(f32["max_abs_diff"] <= LOGIT_TOL * f32["max_abs_logit"],
          f"phase 11c: f32 prefill logits kernels vs plain: {f32['max_abs_diff']:.3g} > "
          f"{LOGIT_TOL} x {f32['max_abs_logit']:.3g}")
    t = res.timing
    out = {"launches": launches, "by_schedule": by_schedule,
           "tensor_core_launches": tensor_cores, "decode_clusters": clusters,
           "ttft_s": t["prefill_s"], "decode_ms_per_step": 1e3 * t["decode_s"] / t["decode_steps"],
           "prefill_logits_f32": dict(f32, tol=LOGIT_TOL * f32["max_abs_logit"]),
           "prefill_logits_bf16": bf16, "compression": eng.compression}
    emit({"granite_serve": out})
    return dict(out, tokens=toks)


# phase 12: the sharding of state and work on the card's one-device mesh
MESH_TRAIN_STEPS = 2                 # 12a: phase 11a's first steps, on the mesh
MESH_CPU_STEPS = 3                   # 12b: the CPU ranks' steps before their checkpoint
MESH_CPU_SHAPE = (64, 8)             # 12b: seq, batch
MESH_CPU_THREADS = 2
MESH_RESTORE_TOL = 1e-4              # 12b: the card's step against the CPU ranks'
MESH_EXEC_LAYERS = 2                 # 12a: the trained layers phase 2's policy compresses


def mesh_group(torch):
    """A one-rank NCCL process group and the ("data", "model") (1, 1) mesh
    on this card (the card box has one GPU, so only this mesh runs)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    store = os.path.join(ROOT, "build", "chip_smoke_mesh_store")
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    return make_mesh((1, 1), ("data", "model"))


def mesh_pcfg(shape):
    from repro_torch.configs.base import ParallelConfig

    return ParallelConfig(mesh_shape=shape, mesh_axes=("data", "model"),
                          microbatches=TRAIN_MICRO)


def phase_mesh(torch, dev, mesh, train, serve_dir, served_tokens):
    """12a, on the (1, 1) mesh of a one-rank NCCL group: (i) the whole
    granite-moe-1b-a400m initialised on the mesh (DTensor state), its
    pipeline on the mesh and the sharded train step, 2 steps at phase 11a's
    seed, batch and schedule: the losses and grad norms identical to phase
    11a's first two; (ii) phase 2's policy on the first MESH_EXEC_LAYERS
    layers' attention of those weights: ``execute_plan(mesh=)`` byte-identical
    to the unsharded execute, K1 32 x the BBO chunks in each; (iii) step 8's
    artifact of phase 11 served under the mesh's activation rules: the
    tokens and launches of phase 11c."""
    import json as _json

    from repro_torch.compression import execute_plan, plan_compression
    from repro_torch.compression.plan import tree_paths
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import autotune
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.launch.serve import serve_model
    from repro_torch.optim import warmup_cosine
    from repro_torch.training import init_train_state, make_train_step

    cfg, pcfg = moe_config(), mesh_pcfg((1, 1))
    torch.cuda.synchronize()
    t0 = time.time()
    state = init_train_state(SEED, cfg, pcfg, mesh=mesh)
    check(all(shd.is_dtensor(x) for _, x in tree_paths(state)),
          "phase 12a: the state on the mesh is not all DTensors")
    init_s = time.time() - t0
    step_fn = make_train_step(cfg, pcfg, warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    pipe = make_pipeline(cfg, ShapeConfig("custom", "train", TRAIN_SEQ, TRAIN_BATCH), mesh,
                         seed=SEED)
    got, step_ms = {}, []
    for i in range(MESH_TRAIN_STEPS):
        t = time.time()
        state, m = step_fn(state, pipe.batch_at(i))
        got[i + 1] = (float(m["loss"]), float(m["grad_norm"]))
        step_ms.append(1e3 * (time.time() - t))
    want = {r["step"]: (r["loss"], r["grad_norm"]) for r in train["steps"]
            if r["attempt"] == 0 and r["step"] <= MESH_TRAIN_STEPS}
    check(got == want, f"phase 12a: losses and grad norms on the mesh {got}, phase 11a's {want}")
    params = {p: shd.full_value(x) for p, x in tree_paths(state.params)}
    del state, step_fn, pipe

    sub: dict = {}
    for p, x in params.items():
        if "/attn/w" in p:
            *head, last = p.split("/")
            node = sub
            for k in head:
                node = node.setdefault(k, {})
            node[last] = x[:MESH_EXEC_LAYERS].clone()
    del params
    plan = plan_compression(sub, policy())
    runs = {}
    for label, kw in (("plain", {"device": dev}), ("mesh", {"mesh": mesh})):
        sa.sa_sweep_many.launches = 0
        torch.cuda.synchronize()
        t = time.time()
        cv, art = execute_plan(plan, sub, seed=SEED, max_pool_tiles=10240, **kw)
        torch.cuda.synchronize()
        runs[label] = (dict(tree_paths(cv)), _json.dumps(art.manifest, sort_keys=True),
                       sa.sa_sweep_many.launches, time.time() - t, art.manifest)
    (a, ma, ka, wa, man), (b, mb, kb, wb, _) = runs["plain"], runs["mesh"]
    bbo = [p for p in man["pools"] if p["method"] == "bbo"]
    k1_want = sum(p["bbo_iters"] * p["chunks"] for p in bbo)
    check(bbo and ka == kb == k1_want, f"phase 12a: K1 launched {ka} / {kb}, want {k1_want}")
    check(sorted(a) == sorted(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                                         for k in a) and ma == mb,
          "phase 12a: execute_plan(mesh=) differs from the unsharded execute")
    del sub, runs, a, b

    lcfg = moe_config()
    L, steps = lcfg.num_layers, NEW_PHASE_STEPS
    torch.cuda.synchronize()
    sa.sa_sweep_many.launches = 0
    bl.reset_counts()
    fa.flash_attention.launches = 0
    autotune.clear_schedules()
    autotune.clear_log()
    with shd.activation_rules(pcfg, mesh):
        res = serve_model(lcfg, ckpt_dir=serve_dir, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
                          steps=steps, eos_id=lcfg.vocab_size, seed=SEED, device=dev,
                          verbose=False)
    torch.cuda.synchronize()
    launches = {"bitlinear_grouped": bl.bitlinear_grouped.launches,
                "bitlinear": bl.bitlinear.launches,
                "flash_attention": fa.flash_attention.launches,
                "sa_sweep_many": sa.sa_sweep_many.launches}
    want_l = {"bitlinear_grouped": 3 * L * steps, "bitlinear": 4 * L * steps,
              "flash_attention": L, "sa_sweep_many": 0}
    check(launches == want_l, f"phase 12a: mesh serve launches {launches}, want {want_l}")
    check(torch.equal(res.tokens.cpu(), served_tokens.cpu()),
          "phase 12a: the mesh serve's tokens differ from phase 11c's")
    out = {"mesh": "data=1xmodel=1", "backend": "nccl", "init_s": init_s,
           "train": {"steps": {s: {"loss": lg[0], "grad_norm": lg[1]} for s, lg in got.items()},
                     "ms": step_ms, "identical_to_11a": True},
           "execute": {"layers": MESH_EXEC_LAYERS, "k1_launches": kb, "plain_s": wa,
                       "mesh_s": wb, "tensors": len(man["tensors"]),
                       "pools": [{k: p[k] for k in ("method", "num_tiles", "chunks")}
                                 for p in man["pools"]], "byte_identical": True},
           "serve": {"launches": launches, "tokens_identical_to_11c": True,
                     "ttft_s": res.timing["prefill_s"]}}
    emit({"mesh_12a": out})
    return dict(out, launches=dict(launches, sa_sweep_many=kb))


def mesh_cpu_config():
    """12b's model: granite-moe reduced (4 layers, d_model 64), in float32
    so that the CPU and the card agree to rounding."""
    from repro_torch.configs import get_config, reduced_for_smoke

    return dataclasses.replace(reduced_for_smoke(get_config(MOE_ARCH)), dtype="float32")


def mesh_cpu_ranks(rank, world, ckpt_dir):
    """One of 12b's gloo CPU ranks on the (2, 2) mesh: MESH_CPU_STEPS steps,
    a sharded checkpoint, then one more step.  Returns the losses."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import warmup_cosine
    from repro_torch.training import init_train_state, make_train_step

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg, pcfg = mesh_cpu_config(), mesh_pcfg((2, 2))
    state = init_train_state(SEED, cfg, pcfg, mesh=mesh)
    step_fn = make_train_step(cfg, pcfg, warmup_cosine(TRAIN_LR, TRAIN_WARMUP,
                                                       MESH_CPU_STEPS + 1))
    pipe = make_pipeline(cfg, ShapeConfig("custom", "train", *MESH_CPU_SHAPE), mesh, seed=SEED)
    losses = []
    for i in range(MESH_CPU_STEPS):
        state, m = step_fn(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    mgr = CheckpointManager(ckpt_dir, keep_last=1)
    mgr.save(MESH_CPU_STEPS, state)
    mgr.wait()
    state, m = step_fn(state, pipe.batch_at(MESH_CPU_STEPS))
    return losses, float(m["loss"])


def phase_mesh_restore(torch, dev, mesh, work_dir):
    """12b: four gloo CPU ranks on this box train 12b's model on (2, 2)
    and write a sharded checkpoint; the card restores it whole onto its
    (1, 1) mesh and takes the next step, whose loss must be the CPU ranks'
    within MESH_RESTORE_TOL."""
    from repro_torch.checkpoint import checkpointer
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.local_ranks import run_ranks
    from repro_torch.optim import warmup_cosine
    from repro_torch.training import init_train_state, make_train_step, state_shardings

    ckpt_dir = os.path.join(work_dir, "ckpt")
    t0 = time.time()
    ranks = run_ranks(mesh_cpu_ranks, 4, os.path.join(work_dir, "ranks"), ckpt_dir,
                      threads=MESH_CPU_THREADS, timeout=600)
    ranks_s = time.time() - t0
    check(all(r == ranks[0] for r in ranks), f"phase 12b: the CPU ranks disagree {ranks}")
    entries = checkpointer.leaf_entries(ckpt_dir, MESH_CPU_STEPS)
    files = {sh["file"].rsplit("__shard", 1)[1] for e in entries.values() for sh in e["shards"]}
    check(files == {f"{r}_0.npy" for r in range(4)},
          f"phase 12b: shard files {sorted(files)}, want one per rank")
    cfg, pcfg = mesh_cpu_config(), mesh_pcfg((1, 1))
    t0 = time.time()
    step, state = CheckpointManager(ckpt_dir).restore_latest(
        init_train_state(SEED, cfg, pcfg, device="meta"), shardings=state_shardings(cfg, pcfg, mesh))
    restore_s = time.time() - t0
    check(step == MESH_CPU_STEPS and int(shd.local_value(state.step)) == MESH_CPU_STEPS,
          f"phase 12b: restored step {step}")
    step_fn = make_train_step(cfg, pcfg, warmup_cosine(TRAIN_LR, TRAIN_WARMUP,
                                                       MESH_CPU_STEPS + 1))
    pipe = make_pipeline(cfg, ShapeConfig("custom", "train", *MESH_CPU_SHAPE), mesh, seed=SEED)
    state, m = step_fn(state, pipe.batch_at(MESH_CPU_STEPS))
    loss, want = float(m["loss"]), ranks[0][1]
    rel = abs(loss - want) / abs(want)
    check(math.isfinite(loss) and rel <= MESH_RESTORE_TOL,
          f"phase 12b: the card's step {loss}, the CPU ranks' {want} ({rel:.3g})")
    out = {"cpu_mesh": "data=2xmodel=2", "cpu_backend": "gloo", "card_mesh": "data=1xmodel=1",
           "cpu_losses": ranks[0][0], "cpu_next_loss": want, "card_next_loss": loss,
           "rel": rel, "tol": MESH_RESTORE_TOL, "cpu_ranks_s": ranks_s, "restore_s": restore_s}
    emit({"mesh_12b": out})
    return out


# ---------------------------------------------------------------------------
# phase 12c: each rank's share of one full-width layer, one rank at a time
# ---------------------------------------------------------------------------

# (architecture, model-axis sizes, dtypes), each its config's last block
# kind: qwen3-32b's 64 q / 8 kv heads give 16 / 2 and 4 / 1 (a kv box of
# half a head at 16); granite-moe's 32 experts 8 and 2, in its own bf16 and
# in f32; zamba2's ssm_attn layer (its SSM, 64 heads: 16 and 4 a rank, then
# the shared attention block, 32 heads: 8 and 2) in bf16 and f32;
# mamba2-130m's ssm layer (24 heads: 6 a rank at 4, every head at 16, where
# the d_inner box is 1.5 heads).  A token whose router top-k differs between
# the whole layer and the joined shares (a near tie that the partial sums'
# rounding flips) takes other experts: such tokens are counted and the rest
# held to LOGIT_TOL
TP_SHARES = (("qwen3-32b", (4, 16), ("bfloat16",)),
             (MOE_ARCH, (4, 16), ("bfloat16", "float32")),
             (ZAMBA_ARCH, (4, 16), ("bfloat16", "float32")),
             (MAMBA2_ARCH, (4, 16), ("bfloat16",)))


def has_attention(cfg) -> bool:
    return cfg.block_pattern[-1] != "ssm"


def k5_rank_shape(cfg, m):
    """(B, H, KV, S, hd) of K5 in a rank's prefill share on ``model`` = m
    (None for a layer without attention)."""
    from repro_torch.models import attention

    if not has_attention(cfg):
        return None
    Hl = cfg.num_heads // m
    _, nkv, _ = attention._kv_heads(0, Hl, cfg.num_heads // cfg.num_kv_heads)
    return GEN_BATCH, Hl, nkv, GEN_PROMPT, cfg.resolved_head_dim


def phase_tp_shares(torch, dev, flush):
    """12c: one full-width layer of qwen3-32b (bf16), granite-moe-1b-a400m
    (bf16 and f32), zamba2-1.2b (ssm_attn, with the shared block: bf16 and
    f32) and mamba2-130m (ssm, bf16: TP_SHARES) on random weights from
    seed 0, a 4 x 1,024 prefill through K5, computed whole and as each
    rank's share for ``model`` = 4 and 16: the rank's boxes of the weights
    as the rules place them on a (1, m) mesh, its box of the carry, the TP
    block (``sharding.model_parallel``) with a ``TurnGroup``, the ranks one
    after another (``local_ranks.run_in_turns``).  The shares' carries,
    joined, hold the whole layer's update within LOGIT_TOL of its max on
    every token whose router top-k is the whole layer's (all tokens without
    experts; the others are counted); K5 ran at the rank's heads (not at
    all in mamba2's layer, which has no attention).  A bf16
    layer is also run whole in f32 (the same weights and input, cast): the
    whole bf16 layer's and the shares' distances from it say how much of
    their difference is bf16 rounding.  zamba2's f32 layer is also run whole
    in f64 on the plain path: the whole f32 layer's and the shares'
    distances from it (``whole_vs_f64``, ``shares_vs_f64``) say which of
    the two lies farther from the exact value.  Then K5 at each rank shape
    against its plain version at the K5 check's tolerances, bf16 timed
    beside its bound and SDPA."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.local_ranks import RankMesh, local_boxes, run_in_turns
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr
    from repro_torch.models.params import split

    out, k5_launches = {}, 0
    g = torch.Generator(device=dev).manual_seed(SEED)
    routes, moe_block = [], moe.moe_block

    def routed(h, p, cfg):
        routes.append(_expert_sets(torch, h, p["router"], cfg.experts_per_token))
        return moe_block(h, p, cfg)

    def err_of(a, b, keep, scale):
        return float(((a - b).float().abs().amax(-1) * keep).max()) / scale

    ops.enable_kernels()
    moe.moe_block = routed
    try:
        for arch, ms, dts in TP_SHARES:
            for dt in dts:
                cfg = dataclasses.replace(get_config(arch), dtype=dt)
                kind, dtype = cfg.block_pattern[-1], getattr(torch, dt)
                values, axes = split(tr._init_block(g, kind, cfg, dtype))
                shared = shared_axes = None
                if kind == "ssm_attn":
                    shared, shared_axes = split(tr._init_shared_attn(g, cfg, dtype))
                x = torch.randn((GEN_BATCH, GEN_PROMPT, cfg.d_model), generator=g,
                                device=dev).to(dtype)
                kw = dict(cache=None, pos_offset=0, window=cfg.sliding_window)
                with torch.no_grad():
                    torch.cuda.synchronize()
                    t = time.time()
                    routes.clear()
                    whole, _, aux = tr._apply_block(x, values, kind, cfg, shared, **kw)
                    torch.cuda.synchronize()
                    whole_s = time.time() - t
                    whole_route = routes[0] if routes else None
                    whole32 = route32 = whole64 = None
                    if kind == "ssm_attn" and dtype == torch.float32:
                        # the exact value to rounding: the plain path in f64
                        with ops.kernels_off():
                            whole64, _, _ = tr._apply_block(x.double(), _to_f64(values), kind,
                                                            cfg, _to_f64(shared), **kw)
                        scale64 = float((whole64 - x.double()).abs().max())
                    if dtype != torch.float32:
                        routes.clear()
                        whole32, _, _ = tr._apply_block(
                            x.float(), _to_f32(values), kind, cfg,
                            None if shared is None else _to_f32(shared), **kw)
                        route32 = routes[0] if routes else None
                    upd = (whole - x).float()
                    scale = float(upd.abs().max())
                    for m in ms:
                        d = cfg.d_model // m
                        rules = shd.make_rules(ParallelConfig(mesh_shape=(1, m),
                                                              mesh_axes=("data", "model")))
                        ranks = []
                        for r in range(m):
                            sh = {"block": shd.param_shardings(axes, values, rules,
                                                               RankMesh(m, r, "cuda"))}
                            local = {"block": local_boxes(values, sh["block"])}
                            if shared is not None:
                                sh["shared"] = shd.param_shardings(shared_axes, shared, rules,
                                                                   RankMesh(m, r, "cuda"))
                                local["shared"] = local_boxes(shared, sh["shared"])
                            ranks.append((local, sh))

                        def share(r, grp, ranks=ranks, m=m, d=d, cfg=cfg, dtype=dtype,
                                  kind=kind, kw=kw, x=x):
                            local, sh = ranks[r]
                            with shd.gathering(sh, None, (), dtype), \
                                    shd.model_parallel((grp, m, r)):
                                p = shd.gather_params(local["block"], "block")
                                sp = shd.gather_params(local["shared"], "shared") \
                                    if "shared" in local else None
                                y, _, a = tr._apply_block(x[..., r * d:(r + 1) * d], p, kind,
                                                          cfg, sp, **kw)
                            return y, float(a)

                        launched = fa.flash_attention.launches
                        routes.clear()
                        torch.cuda.synchronize()
                        t = time.time()
                        outs, passes, calls = run_in_turns(share, m)
                        torch.cuda.synchronize()
                        shares_s = time.time() - t
                        launches = fa.flash_attention.launches - launched
                        k5_launches += launches
                        joined = torch.cat([y for y, _ in outs], dim=-1)
                        aux_r = [a for _, a in outs]
                        # every token agrees unless the layer routes: then
                        # the last pass's routes (one a rank, all alike)
                        keep = torch.ones(x.shape[:-1], device=dev)
                        flips = 0
                        if whole_route is not None:
                            last = routes[-m:]
                            check(all(torch.equal(last[0], q) for q in last[1:]),
                                  f"12c: {arch} {dt} on model = {m}: the ranks route alike")
                            agree = (last[0] == whole_route).all(-1).reshape(x.shape[:-1])
                            flips = int((~agree).sum())
                            keep = agree.float()
                        err = err_of(joined - x, upd, keep, scale)
                        check(err <= LOGIT_TOL,
                              f"12c: {arch} {dt} on model = {m}: the joined shares' update "
                              f"{err:.3g} of max from the whole layer's on the {int(keep.sum())} "
                              f"tokens routed alike ({flips} flipped)")
                        # rounding flips near ties only; a fault upstream of
                        # the router would reroute most tokens
                        check(flips <= 0.05 * keep.numel(),
                              f"12c: {arch} {dt} on model = {m}: {flips} tokens routed "
                              "otherwise than the whole layer")
                        want = passes * m if has_attention(cfg) else 0
                        check(launches == want,
                              f"12c: {arch} {dt} on model = {m}: K5 launched {launches}, "
                              f"want {want}")
                        k5_shape = k5_rank_shape(cfg, m)
                        rec = {"dtype": dt, "err_of_max": err, "passes": passes,
                               "collectives_a_rank": calls, "tokens": keep.numel(),
                               "router_flips": flips if whole_route is not None else None,
                               "aux": aux_r[0] if kind == "attn_moe" else None,
                               "k5_launches": launches,
                               "k5_shape": None if k5_shape is None else list(k5_shape),
                               "whole_s": whole_s, "shares_s": shares_s}
                        if whole32 is not None:
                            # bf16 rounding: each's distance from the f32
                            # layer, on tokens all three route alike
                            k32 = keep if route32 is None else \
                                keep * (route32 == whole_route).all(-1).reshape(keep.shape)
                            rec.update(whole_vs_f32=err_of(whole, whole32, k32, scale),
                                       shares_vs_f32=err_of(joined, whole32, k32, scale))
                        if whole64 is not None:
                            # each f32 result's distance from the f64 layer, of
                            # max|update| in f64 (tools/torch_ssm_share_error.py)
                            rec.update(whole_vs_f64=float((whole - whole64).abs().max())
                                       / scale64,
                                       shares_vs_f64=float((joined - whole64).abs().max())
                                       / scale64)
                        if kind == "attn_moe":
                            # the router reads the carry after attention's
                            # sums over model: the same loss on every rank,
                            # the whole layer's to rounding
                            check(len(set(aux_r)) == 1 and
                                  abs(aux_r[0] - float(aux)) <= 1e-3 * abs(float(aux)),
                                  f"12c: {arch} {dt} on model = {m}: balance losses {aux_r} "
                                  f"against the whole layer's {float(aux)}")
                        out[f"{arch}/{dt}/model={m}"] = rec
                        del ranks, outs, joined, share
                del values, shared, x, whole, upd, whole32, whole64
    finally:
        moe.moe_block = moe_block
        ops.disable_kernels()

    k5 = {}
    for arch, ms, _ in TP_SHARES:
        cfg = get_config(arch)
        if not has_attention(cfg):
            continue
        for m in ms:
            B, H, KV, S, hd = k5_rank_shape(cfg, m)
            label = f"{arch}/model={m}"
            for dt in ("float32", "bfloat16"):
                dtype = getattr(torch, dt)
                q = torch.randn((B, H, S, hd), generator=g, device=dev).to(dtype)
                kk = torch.randn((B, KV, S, hd), generator=g, device=dev).to(dtype)
                v = torch.randn((B, KV, S, hd), generator=g, device=dev).to(dtype)
                o = fa.flash_attention(q, kk, v, 0)
                r = ref.flash_attention_ref(q, kk, v, 0)
                torch.cuda.synchronize()
                diff = (o.float() - r.float()).abs()
                tol = ATTN_TOL[dt]
                check(bool(torch.isfinite(o).all()) and bool((diff <= tol + tol * r.float().abs())
                                                             .all()),
                      f"12c: K5 at {label} {dt}: max |o - ref| {float(diff.max()):.3g} beyond "
                      f"tol {tol}")
                entry = k5.setdefault(label, {"shape": [B, H, KV, S, hd]})
                entry[f"max_abs_err_{dt}"] = float(diff.max())
                if dtype == torch.bfloat16:
                    entry["f32_scores"] = k5_f32_scores_check(torch, q, kk, v, o, 0,
                                                              f"12c: K5 at {label}")
                    entry["timing"] = k5_timing(torch, q, kk, v, 0, r, flush)
                del q, kk, v, o, r
    out["k5"] = k5
    emit({"tp_shares_12c": out})
    return dict(out, k5_launches=k5_launches)


# ---------------------------------------------------------------------------
# phase 13: costing and the dry run (roofline.py, launch/cells.py,
# launch/costing.py, launch/dryrun.py), and kernels/ops.py's entry points
# ---------------------------------------------------------------------------

COST_ARG_TOL = 0.01          # 13a: costed argument bytes against the state's memory
DRYRUN_ARCH, DRYRUN_SHAPES = "qwen3-32b", ("train_4k", "decode_32k")   # 13b, 16 x 16
# 13b's tensor-parallel step: train_4k's per-rank dot FLOPs are the whole
# step's / 16 (model = 16), that is a data-parallel step's along model,
# 1.848e16 on the same cell, / 16; decode_32k all-gathers the rank's model
# box of the weights over data, well below the whole bf16 model's 65.6 GB
DRYRUN_TRAIN_DOT_FLOPS, DRYRUN_DOT_TOL = 1.848e16 / 16, 0.02
DRYRUN_DECODE_ALL_GATHER_MAX = 8.7e9
# 13b's SSM cells, each rank its SSM heads (ssm_in over model): (arch,
# shape, the per-rank dot FLOPs and all-gather bytes of the same cell with
# every SSM weight gathered whole over model and every layer repeated on
# each model rank, and whether the cell moves in_proj's columns by
# all-to-all; the counts must be below a quarter and half of those);
# mamba2-130m's 24 heads on 16 ranks are all computed on every rank from
# its replicated in_proj (3,352 columns), and only out_proj and the norm
# divide: its dot FLOPs below those and its all-gather no more
DRYRUN_SSM_CELLS = (("zamba2-1.2b", "decode_32k", 1.630e10, 2.137e9, True),
                    ("zamba2-1.2b", "long_500k", 2.236e9, 2.302e9, True),
                    ("mamba2-130m", "decode_32k", 2.135e9, 0.262e9, False))


def roofline_share(rec, measured_s) -> dict:
    """A costed step's least time (its roofline terms) beside the time the
    card took for it: ``share`` = bound_s / measured."""
    return {"bound_s": rec["bound_s"], "dominant": rec["dominant"],
            "compute_s": rec["compute_s"], "memory_s": rec["memory_s"],
            "collective_s": rec["collective_s"], "measured_s": measured_s,
            "share": rec["bound_s"] / measured_s}


def phase_costing(torch, dev, train, zamba_gen, zamba_artifact):
    """13a, the card's own cells costed (``launch/dryrun.run_cell`` and
    ``launch/costing.cost_cell`` on a fake (1, 1) mesh) and held to the
    card: phase 11a's granite-moe train step (8 x 1,024, AdamW, remat,
    kernels off): its argument bytes within COST_ARG_TOL of the device
    memory 11a's state held when built, and its dot FLOPs equal to those
    counted over one real step of 11a's on the card; its per-device total
    beside 11a's peak.  Then phase 7's compressed zamba2-1.2b prefill (4 x
    1,024) and batch-4 decode step through the kernels' costing adapters.
    Each with its roofline terms and its share of the time the card took
    (11a's median step; 7's median time to first token and decode step)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch import costing, dryrun
    from repro_torch.optim import warmup_cosine
    from repro_torch.training import init_train_state, make_train_step

    one = {"data": 1, "model": 1}
    cfg, pcfg = moe_config(), mesh_pcfg((1, 1))
    overrides = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)}
    shape = ShapeConfig("custom", "train", TRAIN_SEQ, TRAIN_BATCH)
    t = time.time()
    rec = dryrun.run_cell(MOE_ARCH, shape, False, None, mesh=one, overrides=overrides)
    cost_s = time.time() - t
    mem = rec["memory"]
    measured = train["state_memory_allocated_bytes"]
    rel = abs(mem["argument_bytes"] - measured) / measured
    check(rel <= COST_ARG_TOL, f"13a: argument bytes {mem['argument_bytes']} against the "
                               f"state's {measured} on the card ({rel:.3g} > {COST_ARG_TOL})")

    # one real step of 11a's, counted by the same mode
    torch.cuda.synchronize()
    state = init_train_state(SEED, cfg, pcfg, device=dev)
    step_fn = make_train_step(cfg, pcfg, warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    batch = make_pipeline(cfg, shape, None, seed=SEED, device=dev).batch_at(0)
    t = time.time()
    with costing.counting() as c:
        state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    counted_s = time.time() - t
    real = c.record()
    check(math.isfinite(float(metrics["loss"])), "13a: the counted step's loss is not finite")
    check(real["dot_flops"] == rec["cost"]["dot_flops"],
          f"13a: costed dot FLOPs {rec['cost']['dot_flops']:.6e}, the real step's "
          f"{real['dot_flops']:.6e}")
    del state, step_fn, batch, metrics
    torch.cuda.empty_cache()
    out = {"granite_train": {
        "cell": f"{MOE_ARCH} x train {TRAIN_BATCH}x{TRAIN_SEQ}, micro {TRAIN_MICRO}",
        "mesh": rec["mesh"], "argument_bytes": mem["argument_bytes"],
        "state_memory_allocated_bytes": measured, "argument_rel_diff": rel,
        "per_device_total": mem["per_device_total"], "temp_bytes": mem["temp_bytes"],
        "peak_memory_allocated_bytes": train["peak_memory_allocated_bytes"],
        "dot_flops": rec["cost"]["dot_flops"], "real_step_dot_flops": real["dot_flops"],
        "flops": rec["cost"]["flops"], "bytes": rec["cost"]["bytes"],
        "real_step_flops": real["dot_flops"] + real["elementwise_flops"],
        "real_step_bytes": real["bytes"], "real_step_ops": real["ops"],
        "counted_step_s": counted_s, "cost_s": cost_s,
        **roofline_share(rec["roofline"], train["median_ms"] / 1e3)}}

    zover = {"mesh_shape": (1, 1), "mesh_axes": ("data", "model")}
    measured_s = {"prefill": zamba_gen["ttft_median_s"],
                  "decode": zamba_gen["decode_ms_per_step"] / 1e3}
    for kind, zshape in (("prefill", ShapeConfig("custom", "prefill", GEN_PROMPT, GEN_BATCH)),
                         ("decode", ShapeConfig("custom", "decode", GEN_PROMPT + GEN_STEPS,
                                                GEN_BATCH))):
        t = time.time()
        cc = costing.cost_cell(ZAMBA_ARCH, zshape, overrides=zover, mesh=one,
                               artifact=zamba_artifact)
        check(all(math.isfinite(cc[k]) and cc[k] > 0 for k in ("flops", "bytes", "bound_s")),
              f"13a: zamba2 {kind} costs {cc}")
        out[f"zamba2_{kind}"] = {"cell": f"{ZAMBA_ARCH} x {kind} {GEN_BATCH}x{zshape.seq_len}, "
                                         "compressed (phase 7's artifact)",
                                 "flops": cc["flops"], "dot_flops": cc["dot_flops"],
                                 "bytes": cc["bytes"], "temp_bytes": cc["temp_bytes"],
                                 "cost_s": time.time() - t,
                                 **roofline_share(cc, measured_s[kind])}
    emit({"costing_13a": out})
    return out


def phase_dryrun(torch):
    """13b, the dry run at full width: qwen3-32b x train_4k and x decode_32k
    on the fake 16 x 16 mesh (256 H100s), through ``run_cell`` (whose costs
    are ``cost_cell``'s composition), and ``cost_cell`` alone on the decode
    cell (the same dot FLOPs); then DRYRUN_SSM_CELLS against the counts
    with every SSM weight made whole.  Per-device GiB against HBM_BYTES, FLOPs, collective bytes by
    kind, roofline terms and walls; every count finite and positive."""
    from repro_torch import roofline
    from repro_torch.launch import costing, dryrun

    out = {"hbm_bytes": roofline.HBM_BYTES,
           "total_memory": torch.cuda.get_device_properties(0).total_memory}
    for shape in DRYRUN_SHAPES:
        t = time.time()
        rec = dryrun.run_cell(DRYRUN_ARCH, shape, False, None)
        wall = time.time() - t
        counts = [rec["memory"]["per_device_total"], rec["memory"]["argument_bytes"],
                  rec["cost"]["flops"], rec["cost"]["dot_flops"], rec["cost"]["bytes"],
                  rec["collectives"]["total"], rec["roofline"]["bound_s"]]
        check(all(math.isfinite(v) and v > 0 for v in counts),
              f"13b: {DRYRUN_ARCH} x {shape}: a count is not finite and positive {counts}")
        out[shape] = {"per_rank": {"dot_flops": rec["cost"]["dot_flops"],
                                   "collective_bytes": {k: v for k, v in
                                                        rec["collectives"].items()
                                                        if k != "counts"}},
                      "mesh": rec["mesh"], "microbatches": rec["pcfg"]["microbatches"],
                      "per_device_gib": rec["memory"]["per_device_total"] / 2 ** 30,
                      "hbm_gib": roofline.HBM_BYTES / 2 ** 30, "fits_hbm": rec["fits_hbm"],
                      "memory": rec["memory"], "cost": rec["cost"],
                      "collectives": rec["collectives"], "roofline": rec["roofline"],
                      "trace_s": rec["trace_s"], "wall_s": wall}
    dot = out["train_4k"]["cost"]["dot_flops"]
    check(abs(dot - DRYRUN_TRAIN_DOT_FLOPS) <= DRYRUN_DOT_TOL * DRYRUN_TRAIN_DOT_FLOPS,
          f"13b: train_4k's per-rank dot FLOPs {dot:.4g}, want {DRYRUN_TRAIN_DOT_FLOPS:.4g} "
          f"within {DRYRUN_DOT_TOL:.0%} (a rank's model share)")
    ag = out["decode_32k"]["collectives"]["all-gather"]
    check(ag < DRYRUN_DECODE_ALL_GATHER_MAX,
          f"13b: decode_32k all-gathers {ag:.4g} bytes a step, want below "
          f"{DRYRUN_DECODE_ALL_GATHER_MAX:.3g} (no weight gathered over model)")
    t = time.time()
    cc = costing.cost_cell(DRYRUN_ARCH, "decode_32k")
    check(cc["dot_flops"] == out["decode_32k"]["cost"]["dot_flops"],
          f"13b: cost_cell's dot FLOPs {cc['dot_flops']} against run_cell's "
          f"{out['decode_32k']['cost']['dot_flops']}")
    out["cost_cell_decode_32k"] = {k: cc[k] for k in ("flops", "dot_flops", "coll_bytes",
                                                      "bound_s", "dominant")}
    out["cost_cell_decode_32k"]["wall_s"] = time.time() - t
    for arch, shape, dot0, ag0, moves in DRYRUN_SSM_CELLS:
        t = time.time()
        rec = dryrun.run_cell(arch, shape, False, None)
        coll = {k: v for k, v in rec["collectives"].items() if k != "counts"}
        dot, ag, a2a = rec["cost"]["dot_flops"], coll["all-gather"], coll["all-to-all"]
        label = f"13b: {arch} x {shape}"
        check(all(math.isfinite(v) and v > 0 for v in
                  (rec["memory"]["per_device_total"], rec["cost"]["flops"], dot,
                   rec["cost"]["bytes"], coll["total"], rec["roofline"]["bound_s"])),
              f"{label}: a count is not finite and positive")
        if moves:
            check(dot < dot0 / 4 and ag < ag0 / 2 and a2a > 0,
                  f"{label}: dot FLOPs {dot:.4g} (want < {dot0 / 4:.4g}), all-gather "
                  f"{ag:.4g} (want < {ag0 / 2:.4g}), all-to-all {a2a:.4g} (want > 0)")
        else:
            check(dot < dot0 and ag <= ag0 and a2a == 0,
                  f"{label}: dot FLOPs {dot:.4g} (want < {dot0:.4g}), all-gather {ag:.4g} "
                  f"(want <= {ag0:.4g}), all-to-all {a2a:.4g} (want 0)")
        out[f"{arch}/{shape}"] = {
            "per_rank": {"dot_flops": dot, "collective_bytes": coll},
            "whole_ssm_weights": {"dot_flops": dot0, "all_gather": ag0},
            "per_device_gib": rec["memory"]["per_device_total"] / 2 ** 30,
            "cost": rec["cost"], "roofline": rec["roofline"], "trace_s": rec["trace_s"],
            "wall_s": time.time() - t}
    emit({"dryrun_13b": out})
    return out


def phase_entry_points(torch, dev):
    """13c, ``kernels/ops.py``'s seven entry points once each on the card
    at their phases' shapes, against the plain versions: K3 at qwen's wq
    (T = 4) and K4 at granite's gate stack (T = 4 per expert) in bf16
    within BF16_TOL of max|y|; K5 at phase 4's prefill in bf16 within
    ATTN_TOL; K1 (``sa_sweep``, ``sa_sweep_many``, ``sq_sweep_many``) at
    phase 6's shape and K2 (``sqa_sweep_many``) at its nBOCSqa shape on
    dyadic problems: identical bits."""
    from repro_torch.core import ising
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    out = {}

    def packed(lead, n_r, n_c, tn, K, td):
        mp = torch.randint(0, 1 << K, (*lead, n_r, n_c, tn, (K + 7) // 8), generator=g,
                           device=dev, dtype=torch.int32).to(torch.uint8)
        C = (0.05 * torch.randn((*lead, n_r, n_c, K, td), generator=g, device=dev))
        return mp, C.to(torch.bfloat16)

    _, qcfg = full_width_config()
    d, hq = qcfg.d_model, qcfg.num_heads * qcfg.resolved_head_dim
    mp, C = packed((), d // 32, hq // 128, 32, 4, 128)
    x = torch.randn((GEN_BATCH, d), generator=g, device=dev).to(torch.bfloat16)
    err, ok = variant_error(torch, ops.bitlinear(x, mp, C), ref.bitlinear_ref(x, mp, C, "unpack"),
                            "bfloat16", "bfloat16")
    check(ok, f"13c: ops.bitlinear differs from the plain version by {err:.3g}")
    out["bitlinear"] = {"shape": list(mp.shape), "T": GEN_BATCH, "max_abs_err": err}

    m = moe_config()
    mp, C = packed((m.num_experts,), m.d_model // 32, m.d_ff // 128, 32, 4, 128)
    x = torch.randn((m.num_experts, GEN_BATCH, m.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    err, ok = variant_error(torch, ops.bitlinear_grouped(x, mp, C),
                            ref.bitlinear_grouped_ref(x, mp, C, "unpack"), "bfloat16", "bfloat16")
    check(ok, f"13c: ops.bitlinear_grouped differs from the plain version by {err:.3g}")
    out["bitlinear_grouped"] = {"shape": list(mp.shape), "T": GEN_BATCH, "max_abs_err": err}

    B, H, KV, S, hd, win = (GEN_BATCH, qcfg.num_heads, qcfg.num_kv_heads, GEN_PROMPT,
                            qcfg.resolved_head_dim, 0)
    q, k, v = (torch.randn((B, h_, S, hd), generator=g, device=dev).to(torch.bfloat16)
               for h_ in (H, KV, KV))
    o, r = ops.flash_attention(q, k, v, win), ref.flash_attention_ref(q, k, v, win)
    tol = ATTN_TOL["bfloat16"]
    diff = (o.float() - r.float()).abs()
    check(bool((diff <= tol + tol * r.float().abs()).all()),
          f"13c: ops.flash_attention beyond {tol}: {float(diff.max()):.3g}")
    out["flash_attention"] = {"shape": [B, H, KV, S, hd], "max_abs_err": float(diff.max())}
    del q, k, v, o, r, diff

    P, Cc, Sw, n = K1_FIXTURES["sa_phase6_25"][:4]
    h, Bm = dyadic_problems(torch, g, P, n, dev)
    x0 = (2.0 * torch.randint(0, 2, (P, Cc, n), generator=g, device=dev) - 1.0).contiguous()
    u = torch.rand((P, Cc, Sw, n), generator=g, device=dev)
    temps = ising._temperature_schedule(h, Bm, Sw).float().contiguous()
    runs = {
        "sa_sweep_many": (ops.sa_sweep_many(h, Bm, x0, u, temps),
                          ref.sa_sweep_many_ref(h, Bm, x0, u, temps)),
        "sq_sweep_many": (ops.sq_sweep_many(h, Bm, x0, u, 0.1),
                          ref.sa_sweep_many_ref(h, Bm, x0, u, torch.full_like(temps, 0.1))),
        "sa_sweep": (ops.sa_sweep(h[0], Bm[0], x0[0], u[0], temps[0]),
                     tuple(t[0] for t in ref.sa_sweep_many_ref(h[:1], Bm[:1], x0[:1], u[:1],
                                                               temps[:1]))),
    }
    P2, C2, T2, S2, n2 = K2_FIXTURES["paper_shape"]
    h2, B2 = dyadic_problems(torch, g, P2, n2, dev)
    X0 = (2.0 * torch.randint(0, 2, (P2, C2, T2, n2), generator=g, device=dev) - 1.0)
    u2 = torch.rand((P2, C2, S2, T2, n2), generator=g, device=dev)
    jp = ising.sqa_jperps(S2, T2, SQA_TEMPERATURE, SQA_GAMMA0, dev).contiguous()
    runs["sqa_sweep_many"] = (ops.sqa_sweep_many(h2, B2, X0, u2, jp, SQA_TEMPERATURE),
                              ref.sqa_sweep_many_ref(h2, B2, X0.contiguous(), u2, jp,
                                                     SQA_TEMPERATURE))
    torch.cuda.synchronize()
    for name, ((xk, ek), (xr, er)) in runs.items():
        check(torch.equal(xk, xr) and torch.equal(ek, er),
              f"13c: ops.{name} differs from the plain version")
        out[name] = {"shape": list(xk.shape), "identical": True}
    emit({"entry_points_13c": out})
    return out


# ---------------------------------------------------------------------------
# phase 14: the rest of the zoo on the card (14a) and the examples (14b)
# ---------------------------------------------------------------------------

# (line, arch, config overrides, what was cut): musicgen-medium and
# internvl2-2b whole, command-r-plus-104b at one layer of its 64
ZOO_CELLS = (("zoo_musicgen", "musicgen-medium", {}, []),
             ("zoo_internvl2", "internvl2-2b", {}, []),
             ("zoo_command_r", "command-r-plus-104b", {"num_layers": 1},
              ["num_layers 64 -> 1 (as phase 2 cuts qwen3-32b)"]))
# the default policy's tiles (32 x 128, K = 4) of each: musicgen's 48 layers
# (442,368) and its untied head (768); internvl2's 24 layers (its head, 2,048
# x 92,553, is skipped as indivisible); command-r's one layer
ZOO_TILES = {"musicgen-medium": 443136, "internvl2-2b": 368640, "command-r-plus-104b": 384000}
ZOO_STEPS = 8                        # decode steps after the 4 x 1,024 prefill
ZOO_BIAS_SCALE = 0.1                 # biases drawn after init (the init's are zero)
ZOO_FULL_LOGITS = ("musicgen-medium", "internvl2-2b")   # every position compared


def zoo_bias_draw(torch, values, dev):
    """Every bias leaf of ``values`` redrawn from the seed: normal x
    ZOO_BIAS_SCALE in the leaf's dtype.  Returns their paths."""
    from repro_torch.compression.plan import tree_paths

    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    paths = []
    for path, leaf in tree_paths(values):
        if path.endswith("/b"):
            leaf.copy_((ZOO_BIAS_SCALE * torch.randn(leaf.shape, generator=g, device=dev))
                       .to(leaf.dtype))
            paths.append(path)
    return paths


def zoo_serve(torch, dev, cfg, params, prompt, steps_in, full, setup):
    """A 4 x 1,024 prefill (``make_prefill``, or ``make_prefill_chunk`` at
    position 0 without attending to the cache where every position is
    compared) then ``steps`` decode steps (``make_decode_step``) from that
    cache, after ``setup()`` chose the path.  ``steps_in``: the decode
    steps' inputs ((B, d) embeddings), or None to feed each step the
    previous logits' greedy tokens.  Returns (prefill logits, [step
    logits], the greedy tokens fed, launches of the prefill and of the
    decode steps, prefill s, decode s)."""
    from repro_torch.models import init_cache
    from repro_torch.serving import make_decode_step, make_prefill, make_prefill_chunk

    setup()
    B, P = GEN_BATCH, GEN_PROMPT
    cache = init_cache(cfg, B, P + ZOO_STEPS + 1, device=dev)
    decode = make_decode_step(cfg)
    torch.cuda.synchronize()
    c0 = launch_counts()
    t0 = time.time()
    with torch.inference_mode():
        if full:
            logits, cache = make_prefill_chunk(cfg, attend_cache=False)(params, prompt, cache, 0)
            last = logits[:, -1]
        else:
            last, cache = make_prefill(cfg)(params, prompt, cache)
            logits = last[:, None]
        torch.cuda.synchronize()
        t1 = time.time()
        c1 = launch_counts()
        steps, fed, cur = [], [], last
        for t in range(ZOO_STEPS):
            if steps_in is None:
                inp = cur.argmax(-1)
                fed.append(inp)
            else:
                inp = steps_in[t]
            cur, cache = decode(params, inp, cache, P + t)
            steps.append(cur)
        torch.cuda.synchronize()
    t2 = time.time()
    c2 = launch_counts()
    pre = {k: c1[k] - c0[k] for k in c0}
    dec = {k: c2[k] - c1[k] for k in c0}
    return logits, steps, fed, pre, dec, t1 - t0, t2 - t1


def zoo_kernel_shapes(torch, dev, cfg, params, flush, label):
    """K5 at the cell's prefill shape and K3 at its MLP's up (d_model ->
    d_ff) and down (d_ff -> d_model) at T = 4,096 and 4, each held to its
    plain version (K5 within ATTN_TOL and within its rounding bound of
    attention from f32 scores, K3 within BF16_TOL of max|y|) and timed
    beside its bound and the library call."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    B, H, KV, S, hd = GEN_BATCH, cfg.num_heads, cfg.num_kv_heads, GEN_PROMPT, cfg.resolved_head_dim
    q = torch.randn((B, H, S, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, KV, S, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, KV, S, hd), generator=g, device=dev).to(torch.bfloat16)
    o = fa.flash_attention(q, k, v, 0)
    r = ref.flash_attention_ref(q, k, v, 0)
    diff = (o.float() - r.float()).abs()
    tol = ATTN_TOL["bfloat16"]
    check(bool(torch.isfinite(o).all()) and bool((diff <= tol + tol * r.float().abs()).all()),
          f"{label}: K5 at {(B, H, KV, S, hd)}: max |o - ref| {float(diff.max()):.3g} "
          f"beyond tol {tol}")
    k5 = {"shape": [B, H, KV, S, hd], "group": H // KV, "max_abs_err": float(diff.max()),
          "tol": tol,
          "f32_scores": k5_f32_scores_check(torch, q, k, v, o, 0,
                                            f"{label}: K5 at {(B, H, KV, S, hd)}"),
          **k5_timing(torch, q, k, v, 0, r, flush)}
    del q, k, v, o, r, diff
    mlp = params["groups"]["0"]["mlp"]
    k3 = {}
    for name in ("up", "down"):
        w = {key: t[0] for key, t in mlp[name]["w"].items()}
        d_in = w["m_packed"].shape[0] * w["m_packed"].shape[2]
        for T in (GEN_BATCH * GEN_PROMPT, GEN_BATCH):
            x = torch.randn((T, d_in), generator=g, device=dev).to(torch.bfloat16)
            tm = k3_timing(torch, x, w, flush)
            check(tm["max_err_over_max_y"] <= BF16_TOL,
                  f"{label}: K3 {name} at T = {T}: {tm['max_err_over_max_y']:.3g} of max|y| "
                  f"beyond {BF16_TOL}")
            k3[f"{name}_T{T}"] = tm
            del x
    return k5, k3


def phase_zoo(torch, dev, flush, line, arch, overrides, reduced, work_dir):
    """One architecture of phase 14a on random weights from SEED: init on the
    card (biases redrawn from the seed where the config has them),
    ``compress_model`` with the default policy (no kernel may launch; the
    tiles as the config gives them), the artifact and checkpoint restored
    through the manifest (``validate_params`` clean, every leaf equal to the
    compressed one), then a 4 x 1,024 prefill and 8 decode steps, kernels
    on against the plain path (logits within LOGIT_TOL of max|logit|),
    with K3 once per compressed layer slice a forward and K5 once per
    layer a prefill; command-r-plus also through ``Engine.generate`` (8
    greedy tokens identical kernels on and off).  Then the cell's new K3
    and K5 shapes held and timed."""
    from repro_torch.compression import CompressionPolicy
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import PROMPT_SEED
    from repro_torch.models import init_model
    from repro_torch.models.frontends import needs_embeds, stub_embeddings
    from repro_torch.models.params import count, split
    from repro_torch.serving import Engine

    cfg = dataclasses.replace(get_config(arch), **overrides)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()        # by earlier phases, within the peak
    walls = {}
    t = time.time()
    values, _ = split(init_model(cfg, seed=SEED, device=dev))
    biases = zoo_bias_draw(torch, values, dev) if cfg.use_bias else []
    torch.cuda.synchronize()
    walls["init_s"] = time.time() - t
    check(cfg.use_bias == bool(biases), f"{line}: bias leaves {biases}")
    n_params = count(values)

    before = launch_counts()
    # raises AssertionError on a failed roundtrip check
    params, art, w = ZOO_SWEEP.compress_and_restore(cfg, CompressionPolicy(), values, work_dir,
                                                    seed=SEED, device=dev)
    walls.update(w)
    del values
    torch.cuda.empty_cache()
    check(launch_counts() == before, f"{line}: compression or restore launched a kernel")
    m = art.manifest
    tiles = sum(p["num_tiles"] for p in m["pools"])
    check(tiles == ZOO_TILES[arch], f"{line}: {tiles} tiles, the config gives "
                                    f"{ZOO_TILES[arch]}")
    if arch == "internvl2-2b":
        check(m["skipped"].get("head/w", "").startswith("indivisible dims"),
              f"{line}: the head was not skipped as indivisible: {m['skipped'].get('head/w')}")

    # the compressed tensors K3 serves a forward (each layer slice) and the
    # attention layers K5 serves a prefill
    per_forward = sum(math.prod(e["group_dims"]) if e["group_dims"] else 1
                      for e in art.manifest["tensors"].values())
    B, P = GEN_BATCH, GEN_PROMPT
    full = arch in ZOO_FULL_LOGITS
    if needs_embeds(cfg):
        emb = stub_embeddings(torch.Generator(device=dev).manual_seed(PROMPT_SEED), cfg, B,
                              P + ZOO_STEPS)
        prompt, steps_in = {"embeds": emb[:, :P]}, [emb[:, P + i] for i in range(ZOO_STEPS)]
    else:
        prompt = {"tokens": torch.randint(0, cfg.vocab_size, (B, P),
                                          generator=torch.Generator(device=dev)
                                          .manual_seed(PROMPT_SEED), device=dev)}
        steps_in = None
    lk, sk, fed, pre_k, dec_k, walls["prefill_s"], dec_s = zoo_serve(
        torch, dev, cfg, params, prompt, steps_in, full, ops.enable_kernels)
    walls["decode_ms_per_step"] = 1e3 * dec_s / ZOO_STEPS
    want_pre = {"sa_sweep_many": 0, "sqa_sweep_many": 0, "bitlinear": per_forward,
                "bitlinear_grouped": 0, "flash_attention": cfg.num_layers}
    want_dec = {**want_pre, "bitlinear": per_forward * ZOO_STEPS, "flash_attention": 0}
    check(pre_k == want_pre and dec_k == want_dec,
          f"{line}: launches prefill {pre_k} decode {dec_k}, want {want_pre}, {want_dec}")
    plain_in = steps_in if steps_in is not None else fed     # the same inputs, teacher-forced
    lp, sp, _, pre_p, dec_p, plain_prefill_s, plain_dec_s = zoo_serve(
        torch, dev, cfg, params, prompt, plain_in, full, ops.disable_kernels)
    check(sum(pre_p.values()) + sum(dec_p.values()) == 0, f"{line}: the plain path launched")
    check(tuple(lk.shape) == (B, P if full else 1, cfg.vocab_size)
          and all(tuple(x.shape) == (B, cfg.vocab_size) for x in sk),
          f"{line}: logits of shape {tuple(lk.shape)}, steps {tuple(sk[0].shape)}")
    # finite, within LOGIT_TOL of max|logit|, or AssertionError
    pre_err, pre_mis = ZOO_SWEEP.check_logits(f"{line} prefill", lp, lk, exact=False)
    dec = [ZOO_SWEEP.check_logits(f"{line} decode step {i}", b, a, exact=False)
           for i, (a, b) in enumerate(zip(sk, sp))]
    dec_err, dec_mis = max(e for e, _ in dec), sum(n for _, n in dec)
    del lk, lp, sk, sp
    out = {"arch": arch, "config": {
               "num_layers": cfg.num_layers, "d_model": cfg.d_model, "heads": cfg.num_heads,
               "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
               "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "use_bias": cfg.use_bias,
               "parallel_block": cfg.parallel_block, "tie_embeddings": cfg.tie_embeddings,
               "frontend": cfg.frontend, "dtype": cfg.dtype, "params": n_params},
           "reduced": reduced, "biases_drawn": len(biases),
           "walls": walls, "tiles": tiles, "tensors": len(m["tensors"]),
           "skipped": m["skipped"], "ratio": art.total_ratio,
           "logits_compared": "every position" if full else "last position (make_prefill)",
           "prefill_logits_rel_err": pre_err, "decode_logits_rel_err": dec_err,
           "argmax_mismatches": {"prefill": pre_mis, "decode": dec_mis},
           "launches": {"prefill": pre_k, "decode": dec_k},
           "plain_walls": {"prefill_s": plain_prefill_s,
                           "decode_ms_per_step": 1e3 * plain_dec_s / ZOO_STEPS}}

    if steps_in is None:
        # the serve CLI's path: Engine.generate, kernels on and off
        before = launch_counts()
        eng = Engine(cfg, params, max_len=P + ZOO_STEPS, batch=B, eos_id=cfg.vocab_size,
                     artifact=art)
        toks = eng.generate(prompt["tokens"], ZOO_STEPS)
        torch.cuda.synchronize()
        gen_launches = {k: v - before[k] for k, v in launch_counts().items()}
        plain = Engine(cfg, params, max_len=P + ZOO_STEPS, batch=B, eos_id=cfg.vocab_size,
                       artifact=art, use_fused_bitlinear=False)
        toks_plain = plain.generate(prompt["tokens"], ZOO_STEPS)
        check(launch_counts() == {k: before[k] + gen_launches[k] for k in before},
              f"{line}: the plain engine launched a kernel")
        check(gen_launches["bitlinear"] == per_forward * ZOO_STEPS
              and gen_launches["flash_attention"] == 1,
              f"{line}: Engine.generate launched {gen_launches}")
        check(torch.equal(toks, toks_plain),
              f"{line}: greedy tokens kernels on {toks[:, P:].tolist()} vs off "
              f"{toks_plain[:, P:].tolist()}")
        out["engine_generate"] = {
            "new_tokens": ZOO_STEPS, "identical_kernels_on_off": True,
            # the tokens the decode steps above were fed: the same picks
            "same_as_fed_greedy": bool(torch.equal(toks[:, P:], torch.stack(fed, 1))),
            "launches": gen_launches, "timing": eng.last_timing,
            "plain_timing": plain.last_timing}
        del eng, plain
    t = time.time()
    k5, k3 = zoo_kernel_shapes(torch, dev, cfg, params, flush, line)
    walls["kernel_shapes_s"] = time.time() - t
    torch.cuda.synchronize()
    out["k5"], out["k3"] = k5, k3
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["memory_held_before_bytes"] = held
    del params
    torch.cuda.empty_cache()
    emit({line: out})
    return out


def phase_examples(torch, work_dir):
    """Phase 14b: each example's ``main(argv)`` in this process on the card,
    with small arguments; each must return 0.  Their output is kept and
    the quickstart's costs read from it: BBO no worse than greedy (its
    rc says so too), with K1 launched."""
    import contextlib
    import io

    runs = (("quickstart", "examples/torch_quickstart.py", []),
            ("compress_then_serve", "examples/torch_compress_then_serve.py",
             ["--train-steps", "20"]),
            ("delta_recompress", "examples/torch_delta_recompress.py",
             ["--train-steps", "12", "--every", "6"]),
            ("train_small", "examples/torch_train_small.py",
             ["--steps", "20", "--ckpt-dir", os.path.join(work_dir, "train_small")]))
    out, texts = {}, {}
    for name, path, argv in runs:
        mod = load_example(path)
        buf = io.StringIO()
        torch.cuda.synchronize()
        before = launch_counts()
        t = time.time()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t
        texts[name] = buf.getvalue()
        lines = texts[name].splitlines()
        check(rc == 0, f"example {name} {argv} returned {rc}: {lines[-5:]}")
        out[name] = {"argv": argv, "rc": rc, "wall_s": wall,
                     "launches": {k: v - before[k] for k, v in launch_counts().items()},
                     "last_lines": lines[-3:]}
    costs = {key: float(re.search(pattern, texts["quickstart"]).group(1))
             for key, pattern in (("greedy", r"greedy\s+cost\s+=\s+([0-9.]+)"),
                                  ("bbo", r"nBOCS/SA cost\s+=\s+([0-9.]+)"))}
    k1 = out["quickstart"]["launches"]["sa_sweep_many"]
    check(costs["bbo"] <= costs["greedy"] and k1 > 0,
          f"quickstart: BBO {costs['bbo']} vs greedy {costs['greedy']}, K1 launched {k1}")
    out["quickstart"]["costs"] = costs
    emit({"examples_14b": out})
    return out


def kernel_launches(k3v, k4v, gen, tuned, moe_gen, moe_tuned):
    """{kind: {part: {"mode/math": n}}} for K3 and K4: the tuner's trial
    launches ("tuning"), the tuned serves' ("serving"; phases 4b, 5b),
    their sum ("main", the tuned path) and the untuned serves' ("untuned";
    phases 4, 5).  The tuned serves launched what their tables picked and
    the untuned ones what the default rule picked (both checked in their
    phases); here the tuner must have launched every schedule x bit
    algebra, each being a candidate."""
    def add(*counts):
        out = {}
        for c in counts:
            for k, v in c.items():
                out[k] = out.get(k, 0) + v
        return out

    launch = {}
    for kind, keys in (("bitlinear", k3v["timing"]), ("bitlinear_grouped", k4v["timing"])):
        parts = {
            "tuning": add(*(p["launches_tuning"].get(kind, {}) for p in (tuned, moe_tuned))),
            "serving": add(*(p["launches_serving"].get(kind, {}) for p in (tuned, moe_tuned))),
            "untuned": add(gen["bitlinear_by_schedule"] if kind == "bitlinear" else {},
                           moe_gen["by_schedule"][kind]),
        }
        parts["main"] = add(parts["tuning"], parts["serving"])
        missing = [k for k in keys if not parts["tuning"].get(k)]
        check(not missing, f"{kind}: the tuner launched no {missing}")
        launch[kind] = parts
    return launch


# an annealer's timing in the kernels line: its three least times apart
ANNEAL_KEYS = ("ms", "device_ms", "plain_ms", "threshold_device_ms", "ns_per_step",
               "bytes_ms", "ops_ms", "chain_bound_ms")


def contract_bound(tm) -> dict:
    """An annealer's least time in the kernels line: the larger of its bytes
    and operations bounds, as every kernel's, with its chain bound beside."""
    by = "bytes" if tm["bytes_ms"] >= tm["ops_ms"] else "operations"
    return {"bound_ms": max(tm["bytes_ms"], tm["ops_ms"]), "bound_by": by,
            "chain_bound_ms": tm["chain_bound_ms"],
            "threshold_device_ms": tm["threshold_device_ms"]}


def main_path_smem(torch):
    """Dynamic shared memory of one block of the tensor-core bodies at the
    main path's shapes: K5 (two stages of 64-row K and V tiles, rows padded
    by 8 bf16, as csrc/flash_attention.cu's mma_smem) at hd 128 and 64, and
    the grid (the built library's own layout) at qwen's prefill (T = 4096,
    tile 32 x 128, K = 4, 160 r tiles: wq), granite's expert prefill
    (T = 1,280 per expert, the same tile, 32 r tiles: gate/up) and the
    in_proj prefills of zamba2 (tile 32 x 131, 64 r tiles) and mamba2-130m
    (32 x 419, 24 r tiles)."""
    from repro_torch.kernels import bitlinear as bl

    T = GEN_BATCH * GEN_PROMPT
    return {
        "flash_mma_kernel": {hd: 2 * 2 * 64 * (hd + 8) * 2 for hd in (128, 64)},
        "bitlinear_mma_kernel": {
            f"T={T},n_r={n_r},td={td}": bl.smem_bytes("grid", T=T, n_r=n_r, tn=32, K=4, td=td,
                                                      x_itemsize=2, c_itemsize=2)
            for T, n_r, td in ((T, 160, 128), (1280, 32, 128), (T, 64, 131), (T, 24, 419))},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    phases = {}
    t = time.time()
    _build.build_all()
    phases["build_s"] = time.time() - t
    regs = {name: [ln.strip() for ln in _build.build_log(name).splitlines() if "registers" in ln]
            for name in _build.SOURCES}
    emit({"build": {"seconds": phases["build_s"], "ptxas": regs}})
    emit({"ptxas_tensor_core": tensor_core_ptxas(_build.build_log),
          "dynamic_smem_main_path": main_path_smem(torch)})

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    t = time.time()
    expf = phase_expf(torch, dev)
    phases["expf_check_s"] = time.time() - t
    emit({"expf_monotone": expf})
    t = time.time()
    k1 = phase_k1(torch, dev, flush)
    phases["k1_check_s"] = time.time() - t
    emit({"k1_check": k1})
    t = time.time()
    k2 = phase_k2(torch, dev, flush)
    phases["k2_check_s"] = time.time() - t
    emit({"k2_check": k2})

    out_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        t = time.time()
        params, artifact, k1_launches = phase_compress(torch, dev, out_dir)
        phases["compress_s"] = time.time() - t
        t = time.time()
        k3_layer_launches, k3_err, k3, weights, inputs = phase_serve(torch, dev, params,
                                                                     artifact, flush)
        phases["serve_s"] = time.time() - t
        t = time.time()
        k3v = phase_k3_variants(torch, dev, weights, inputs, flush)
        phases["k3_variants_s"] = time.time() - t
        del params, weights, inputs
        t = time.time()
        k5 = phase_k5(torch, dev, flush)
        phases["k5_check_s"] = time.time() - t
        emit({"k5_check": k5})
        t = time.time()
        gen = phase_generate(torch, dev, out_dir)
        phases["generate_s"] = time.time() - t
        t = time.time()
        tuned = phase_tuned_generate(torch, dev, out_dir, gen)
        phases["tuned_generate_s"] = time.time() - t
        t = time.time()
        sched4c = phase_qwen_sched(torch, dev, out_dir)
        phases["scheduler_4c_s"] = time.time() - t
        delta_dir = os.path.join(ROOT, "build", "chip_smoke_delta_ckpt")
        shutil.rmtree(delta_dir, ignore_errors=True)
        try:
            t = time.time()
            delta = phase_delta(torch, dev, out_dir, delta_dir)
            phases["delta_9_s"] = time.time() - t
        finally:
            shutil.rmtree(delta_dir, ignore_errors=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    t = time.time()
    k4 = phase_k4(torch, dev, flush)
    phases["k4_check_s"] = time.time() - t
    emit({"k4_check": k4})
    t = time.time()
    k4v = phase_k4_variants(torch, dev, flush)
    phases["k4_variants_s"] = time.time() - t
    moe_dir = os.path.join(ROOT, "build", "chip_smoke_moe_ckpt")
    shutil.rmtree(moe_dir, ignore_errors=True)
    try:
        t = time.time()
        phase_moe_compress(torch, dev, moe_dir)
        phases["moe_compress_s"] = time.time() - t
        t = time.time()
        moe_gen = phase_moe_generate(torch, dev, moe_dir)
        phases["moe_generate_s"] = time.time() - t
        t = time.time()
        moe_tuned = phase_moe_tuned_generate(torch, dev, moe_dir, moe_gen)
        phases["moe_tuned_generate_s"] = time.time() - t
    finally:
        shutil.rmtree(moe_dir, ignore_errors=True)
    zamba_dir = os.path.join(ROOT, "build", "chip_smoke_zamba2_ckpt")
    shutil.rmtree(zamba_dir, ignore_errors=True)
    try:
        t = time.time()
        _, cvalues = phase_zamba_compress(torch, dev, zamba_dir)
        phases["zamba2_compress_s"] = time.time() - t
        t = time.time()
        zamba_k3 = phase_zamba_k3(torch, dev, cvalues, flush)
        phases["zamba2_k3_s"] = time.time() - t
        del cvalues
        t = time.time()
        zamba_gen = phase_zamba_generate(torch, dev, zamba_dir)
        phases["zamba2_generate_s"] = time.time() - t
        from repro_torch.compression import CompressionArtifact

        zamba_artifact = CompressionArtifact.load(zamba_dir)     # costed in phase 13a
        t = time.time()
        sched7c = phase_zamba_sched(torch, dev, zamba_dir)
        phases["scheduler_7c_s"] = time.time() - t
        zamba_auto_dir = os.path.join(ROOT, "build", "chip_smoke_zamba2_autotune_ckpt")
        shutil.rmtree(zamba_auto_dir, ignore_errors=True)
        try:
            t = time.time()
            zamba_auto = phase_zamba_autotune(torch, dev, zamba_dir, zamba_auto_dir)
            phases["zamba2_autotune_8_s"] = time.time() - t
        finally:
            shutil.rmtree(zamba_auto_dir, ignore_errors=True)
        stream_dir = os.path.join(ROOT, "build", "chip_smoke_zamba2_stream")
        shutil.rmtree(stream_dir, ignore_errors=True)
        try:
            t = time.time()
            zamba_stream = phase_zamba_stream(torch, dev, zamba_dir, stream_dir)
            phases["zamba2_stream_10_s"] = time.time() - t
        finally:
            shutil.rmtree(stream_dir, ignore_errors=True)
    finally:
        shutil.rmtree(zamba_dir, ignore_errors=True)
    plan_dir = os.path.join(ROOT, "build", "chip_smoke_plan_405b")
    shutil.rmtree(plan_dir, ignore_errors=True)
    try:
        t = time.time()
        plan405 = phase_plan_405b(torch, dev, plan_dir)
        phases["plan_405b_10b_s"] = time.time() - t
    finally:
        shutil.rmtree(plan_dir, ignore_errors=True)
    mamba2_dir = os.path.join(ROOT, "build", "chip_smoke_mamba2_ckpt")
    shutil.rmtree(mamba2_dir, ignore_errors=True)
    try:
        t = time.time()
        mamba2_gen = phase_mamba2(torch, dev, mamba2_dir)
        phases["mamba2_s"] = time.time() - t
        shutil.rmtree(mamba2_dir, ignore_errors=True)
        t = time.time()
        mamba2_auto = phase_mamba2_autotune(torch, dev, mamba2_dir)
        phases["mamba2_autotune_8b_s"] = time.time() - t
    finally:
        shutil.rmtree(mamba2_dir, ignore_errors=True)
    cli_dir = os.path.join(ROOT, "build", "chip_smoke_mamba2_cli")
    shutil.rmtree(cli_dir, ignore_errors=True)
    try:
        t = time.time()
        mamba2_cli = phase_mamba2_cli(torch, dev, cli_dir)
        phases["mamba2_cli_10c_s"] = time.time() - t
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)
    t = time.time()
    paper = phase_paper(torch, dev)
    phases["paper_s"] = time.time() - t
    train_dir = os.path.join(ROOT, "build", "chip_smoke_train_ckpt")
    cycle_dir = os.path.join(ROOT, "build", "chip_smoke_granite_cycle")
    for d in (train_dir, cycle_dir):
        shutil.rmtree(d, ignore_errors=True)
    try:
        t = time.time()
        train, finals = phase_granite_train(torch, dev, train_dir)
        phases["granite_train_11a_s"] = time.time() - t
        t = time.time()
        cycle = phase_granite_cycle(torch, dev, train_dir, finals, cycle_dir)
        phases["granite_cycle_11b_s"] = time.time() - t
        t = time.time()
        granite_serve = phase_granite_serve(torch, dev, cycle_dir)
        phases["granite_serve_11c_s"] = time.time() - t
        import torch.distributed as dist

        mesh_dir = os.path.join(ROOT, "build", "chip_smoke_mesh")
        shutil.rmtree(mesh_dir, ignore_errors=True)
        mesh = mesh_group(torch)
        try:
            t = time.time()
            mesh12 = phase_mesh(torch, dev, mesh, train, cycle_dir, granite_serve["tokens"])
            phases["mesh_12a_s"] = time.time() - t
            t = time.time()
            phase_mesh_restore(torch, dev, mesh, mesh_dir)
            phases["mesh_restore_12b_s"] = time.time() - t
        finally:
            dist.destroy_process_group()
            shutil.rmtree(mesh_dir, ignore_errors=True)
    finally:
        for d in (train_dir, cycle_dir):
            shutil.rmtree(d, ignore_errors=True)
    t = time.time()
    tp_shares = phase_tp_shares(torch, dev, flush)
    phases["tp_shares_12c_s"] = time.time() - t
    t13 = time.time()
    phase_costing(torch, dev, train, zamba_gen, zamba_artifact)
    phases["costing_13a_s"] = time.time() - t13
    t = time.time()
    phase_dryrun(torch)
    phases["dryrun_13b_s"] = time.time() - t
    t = time.time()
    phase_entry_points(torch, dev)
    phases["entry_points_13c_s"] = time.time() - t
    phases["phase13_s"] = time.time() - t13
    t14 = time.time()
    zoo = {}
    zoo_dir = os.path.join(ROOT, "build", "chip_smoke_zoo")
    for line, arch, overrides, reduced in ZOO_CELLS:
        shutil.rmtree(zoo_dir, ignore_errors=True)
        try:
            t = time.time()
            zoo[line] = phase_zoo(torch, dev, flush, line, arch, overrides, reduced, zoo_dir)
            phases[f"{line}_14a_s"] = time.time() - t
        finally:
            shutil.rmtree(zoo_dir, ignore_errors=True)
    examples_dir = os.path.join(ROOT, "build", "chip_smoke_examples")
    shutil.rmtree(examples_dir, ignore_errors=True)
    try:
        t = time.time()
        examples = phase_examples(torch, examples_dir)
        phases["examples_14b_s"] = time.time() - t
    finally:
        shutil.rmtree(examples_dir, ignore_errors=True)
    phases["phase14_s"] = time.time() - t14
    emit({"phase_s": phases})

    def zoo_launches(kind):
        # phase 14a: each cell's prefill and 8 decode steps (and command-r's
        # Engine.generate) with the kernels on; 14b: each example's
        out = {line: {"prefill": z["launches"]["prefill"][kind],
                      "decode": z["launches"]["decode"][kind],
                      **({"engine_generate": z["engine_generate"]["launches"][kind]}
                         if "engine_generate" in z else {})} for line, z in zoo.items()}
        return out, {name: ex["launches"][kind] for name, ex in examples.items()}
    k5_err = max([v["max_abs_err"] for v in k5.values() if "max_abs_err" in v]
                 + [max(e["max_abs_err_float32"], e["max_abs_err_bfloat16"])
                    for e in tp_shares["k5"].values()])
    launch = kernel_launches(k3v, k4v, gen, tuned, moe_gen, moe_tuned)

    def variants(timing, errs, launches, replaces):
        # launches: the tuned path's (tuning trials + tuned serving), then
        # each part, and the untuned serves' (phases 4, 5)
        return [{"mode": key.split("/")[0], "math": key.split("/")[1],
                 "replaces": replaces[key.split("/")[0]],
                 "launches": launches["main"].get(key, 0),
                 **{f"launches_{part}": launches[part].get(key, 0)
                    for part in ("tuning", "serving", "untuned")},
                 "max_abs_err": errs[key],
                 "timed_calls": tm["calls"], "timed_T": tm["T"], "ms": tm["ms"],
                 "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                 "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
                 # the same without the host's time (the card kept busy)
                 "device_ms": tm["device_ms"], "library_device_ms": tm["library_device_ms"]}
                for key, tm in timing.items()]
    # each timed decode call's cluster size and achieved bytes per second
    emit({"decode_calls": {"bitlinear": k3v["decode_calls"],
                           "bitlinear_grouped": k4v["decode_calls"],
                           "GBps_card": HBM_BYTES_PER_S / 1e9}})
    # each timed stream call's cluster size, tensor-mapped parts and GB/s
    emit({"stream_calls": {**k3v["stream_calls"], "GBps_card": HBM_BYTES_PER_S / 1e9}})
    emit({"kernels": [
        {"name": "sa_sweep_many", "route": "cuda",
         "source": "src/repro_torch/csrc/sa_sweep.cu",
         "replaces": "src/repro/kernels/sa_sweep.py:114",
         "launches": k1_launches,
         "max_abs_err": max(v["max_abs_err"] for v in k1.values() if "max_abs_err" in v),
         "ms": k1["timing"]["ms"], "plain_ms": k1["timing"]["plain_ms"],
         **contract_bound(k1["timing"]),
         "library_ms": None, "device_ms": k1["timing"]["device_ms"], "library_device_ms": None,
         # the same at phase 6's shapes (25 and 4 runs x 10 reads x 64 sweeps)
         "phase6": {label: {k: tm[k] for k in ANNEAL_KEYS}
                    for label, tm in k1["timing_phase6"].items()},
         "launches_phase6": {k: v["launches"]["sa_sweep_many"]
                             for k, v in paper["algorithms"].items()},
         # phase 8: the budget allocator's QUBO solve (its spins), and K1 timed
         # at the allocator's shape (6 problems x 8 reads x 96 sweeps) at n =
         # 237 (the shared-memory body), 512 and 1,024 (the global-memory
         # body, each chain split over a block's warps)
         "launches_phase8": zamba_auto["k1_launches"],
         # phase 9: the delta's warm BBO re-solve (each launch with init_state);
         # phase 10b: the streaming autotuner's QUBO on llama3-405b's plan
         "launches_phase9": delta["drifted"]["k1_launches"],
         "launches_phase10b": plan405["k1_launches"],
         # phase 11b: the compression cycle's cold BBO and its warm delta
         "launches_phase11": {"cold": cycle["cold"]["k1_launches"],
                              "delta": cycle["delta"]["k1_launches"]},
         # phase 12a: execute_plan(mesh=) on the (1, 1) mesh
         "launches_phase12": mesh12["launches"]["sa_sweep_many"],
         # phase 14b: the examples (the quickstart's BBO on the paper's instance)
         "launches_phase14b": zoo_launches("sa_sweep_many")[1],
         "qubo_spins_phase10b": plan405["qubo_spins"],
         "qubo_shape_phase8": zamba_auto["qubo_shape"],
         "allocator": {label: {k: tm[k] for k in ANNEAL_KEYS}
                       for label, tm in k1["timing_allocator"].items()}},
        {"name": "bitlinear", "route": "cuda",
         "source": "src/repro_torch/csrc/bitlinear.cu",
         "replaces": "src/repro/kernels/bitlinear.py:438",
         "launches": gen["launches"]["bitlinear"], "launches_phase3": k3_layer_launches,
         "launches_phase5": moe_gen["launches"]["bitlinear"],
         "launches_phase7": zamba_gen["launches"]["bitlinear"],
         "launches_phase7b": mamba2_gen["launches"]["bitlinear"],
         # the autotuned serves: zamba2 to phase 7's bytes, mamba2-130m to 0.75 x
         "launches_phase8": zamba_auto["launches"]["bitlinear"],
         "launches_phase8b": mamba2_auto["launches"]["bitlinear"],
         # the scheduler's runs: phase 7c's (a), full and cut pool; phase 4c's
         "launches_phase7c": sched7c["launches"]["bitlinear"],
         "launches_phase4c": sched4c["launches"]["bitlinear"],
         # the serves of the delta checkpoint (9), the streamed zamba2 (10) and
         # the CLI's delta of the streamed mamba2-130m (10c), NEW_PHASE_STEPS each
         "launches_phase9": delta["serve"]["launches"]["bitlinear"],
         "launches_phase10": zamba_stream["serve"]["launches"]["bitlinear"],
         "launches_phase10c": mamba2_cli["serve"]["launches"]["bitlinear"],
         # phase 11c: the serve of the trained granite's delta artifact
         "launches_phase11": granite_serve["launches"]["bitlinear"],
         # phase 12a: the same serve under the (1, 1) mesh's activation rules
         "launches_phase12": mesh12["launches"]["bitlinear"],
         "max_abs_err": k3_err,
         # times summed over phase 4's distinct (tensor, T) calls, each once
         "timed_calls": k3["calls"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": "bytes" if k3["bytes_ms"] >= k3["ops_ms"] else "operations",
         "library_ms": k3["library_ms"],
         "device_ms": k3["device_ms"], "library_device_ms": k3["library_device_ms"],
         # per schedule x bit algebra (launches: see variants), times summed
         # in bf16 over phase 4's distinct calls that the schedule takes
         # (decode: the T = 4 ones)
         "sources": ["src/repro_torch/csrc/bitlinear.cu",
                     "src/repro_torch/csrc/bitlinear_decode.cu",
                     "src/repro_torch/csrc/bitlinear_stream.cu",
                     "src/repro_torch/csrc/bitlinear_stream.cuh",
                     "src/repro_torch/csrc/bitlinear_ring.cuh",
                     "src/repro_torch/csrc/bitlinear_common.cuh"],
         "variants": variants(k3v["timing"], k3v["max_abs_err"], launch["bitlinear"],
                              {"grid": "src/repro/kernels/bitlinear.py:417",
                               "decode": "src/repro/kernels/bitlinear.py:369",
                               "stream": "src/repro/kernels/bitlinear.py:388"}),
         # phase 7: zamba2's in_proj (tile 32 x 131) and out_proj at T = 4 and
         # 4096 and mamba2-130m's in_proj (32 x 419) at 4096, at the default
         # rule's schedule, and the worst error of every variant held at
         # phase 7's tiles
         "zamba2": {**zamba_k3["timing"], "max_abs_err": zamba_k3["max_abs_err"]},
         "launches_phase14a": zoo_launches("bitlinear")[0],
         "launches_phase14b": zoo_launches("bitlinear")[1],
         # phase 14a: each cell's MLP up and down at T = 4096 and 4, at the
         # default rule's schedule, held and timed
         "zoo": {line: z["k3"] for line, z in zoo.items()}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:79",
         "launches": gen["launches"]["flash_attention"],
         "launches_phase5": moe_gen["launches"]["flash_attention"],
         "launches_phase7": zamba_gen["launches"]["flash_attention"],
         "launches_phase8": zamba_auto["launches"]["flash_attention"],
         "launches_phase7c": sched7c["launches"]["flash_attention"],
         "launches_phase4c": sched4c["launches"]["flash_attention"],
         "launches_phase9": delta["serve"]["launches"]["flash_attention"],
         "launches_phase10": zamba_stream["serve"]["launches"]["flash_attention"],
         "launches_phase11": granite_serve["launches"]["flash_attention"],
         "launches_phase12": mesh12["launches"]["flash_attention"],
         # phase 12c: each rank's prefill share of a qwen3-32b, a
         # granite-moe and a zamba2 layer on model = 4 and 16, every pass
         # of the ranks
         "launches_phase12c": tp_shares["k5_launches"],
         "max_abs_err": k5_err,
         "ms": k5["timing"]["ms"], "plain_ms": k5["timing"]["plain_ms"],
         "bound_ms": k5["timing"]["bound_ms"], "bound_by": k5["timing"]["bound_by"],
         "library_ms": k5["timing"]["library_ms"], "device_ms": k5["timing"]["device_ms"],
         "library_device_ms": k5["timing"]["library_device_ms"],
         # the same at phase 5's prefill shape (4, 16, 8, 1024, 64)
         "moe_prefill": {k: k5["timing_moe"][k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
                          "library_device_ms")},
         # the same at phase 7's prefill shape (4, 32, 32, 1024, 64), window 4096
         "zamba2_prefill": {k: k5["timing_zamba2"][k] for k in
                            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                             "device_ms", "library_device_ms")},
         "launches_phase14a": zoo_launches("flash_attention")[0],
         "launches_phase14b": zoo_launches("flash_attention")[1],
         # phase 14a: each cell's prefill shape (MHA 24 x 64; GQA 16/8 x 128;
         # GQA 96/8 x 128), held and timed
         "zoo": {line: z["k5"] for line, z in zoo.items()},
         # phase 12c: a rank's prefill shape on model = 4 and 16 (qwen3-32b:
         # 16/2 and 4/1 heads x 128; granite-moe: 4/2 and 1/1 x 64; zamba2's
         # shared block: 8/8 and 2/2 x 64), held and timed
         "tp_shares": {label: {"shape": e["shape"],
                               "max_abs_err": max(e["max_abs_err_float32"],
                                                  e["max_abs_err_bfloat16"]),
                               **{k: e["timing"][k] for k in
                                  ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "device_ms", "library_device_ms")}}
                       for label, e in tp_shares["k5"].items()}},
        {"name": "bitlinear_grouped", "route": "cuda",
         "source": "src/repro_torch/csrc/bitlinear.cu",
         "replaces": "src/repro/kernels/bitlinear.py:583",
         "launches": moe_gen["launches"]["bitlinear_grouped"],
         "launches_phase11": granite_serve["launches"]["bitlinear_grouped"],
         "launches_phase12": mesh12["launches"]["bitlinear_grouped"],
         "max_abs_err": k4["timing"]["max_abs_err"],
         # times summed over phase 5's distinct (stack, T) calls, each once
         "timed_calls": k4["timing"]["calls"],
         "ms": k4["timing"]["ms"], "plain_ms": k4["timing"]["plain_ms"],
         "bound_ms": k4["timing"]["bound_ms"], "bound_by": k4["timing"]["bound_by"],
         "library_ms": k4["timing"]["library_ms"], "device_ms": k4["timing"]["device_ms"],
         "library_device_ms": k4["timing"]["library_device_ms"],
         # per schedule x bit algebra (launches: see variants), times summed
         # in bf16 over phase 5's distinct (stack, T) calls the schedule takes
         "sources": ["src/repro_torch/csrc/bitlinear.cu",
                     "src/repro_torch/csrc/bitlinear_decode.cu",
                     "src/repro_torch/csrc/bitlinear_ring.cuh",
                     "src/repro_torch/csrc/bitlinear_common.cuh"],
         "variants": variants(k4v["timing"], k4v["max_abs_err"], launch["bitlinear_grouped"],
                              {"grid": "src/repro/kernels/bitlinear.py:558",
                               "decode": "src/repro/kernels/bitlinear.py:536"})},
        {"name": "sqa_sweep_many", "route": "cuda",
         "source": "src/repro_torch/csrc/sqa_sweep.cu",
         "replaces": "src/repro/kernels/sqa_sweep.py:108",
         "launches": paper["algorithms"]["nbocsqa"]["launches"]["sqa_sweep_many"],
         "max_abs_err": max(v["max_abs_err"] for v in k2.values() if "max_abs_err" in v),
         "ms": k2["timing"]["ms"], "plain_ms": k2["timing"]["plain_ms"],
         **contract_bound(k2["timing"]),
         "library_ms": None, "device_ms": k2["timing"]["device_ms"], "library_device_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
