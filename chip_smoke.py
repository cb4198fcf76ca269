#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's four kernels with nvcc for sm_90a, one nvcc each, all
started together: B1, the Himeno Jacobi sweep (``csrc/himeno.cu``), B2,
RMSNorm (``csrc/rmsnorm.cu``), B3, flash attention
(``csrc/flash_attention.cu``: a tensor-core kernel for bf16, a scalar one
for f32, and its backward, tensor-core and scalar alike) and B4, the RWKV6 WKV recurrence (``csrc/wkv.cu``: a chunked
tensor-core kernel for prefill, a sequential one for decode, and its
backward). Holds every
kernel against its plain PyTorch version on the card at its main path's
shapes and at ragged ones, and B3's tensor-core kernel also against the
bound that rounding P and o to bf16 allows, timing each beside its bound,
its plain version and, where one exists, the PyTorch library call that
computes the same function; times each step of B2's and B4's launch paths
at the decode shape, and counts the cycles of each phase of B4's
tensor-core kernel. Then:

* slice 7d part three (c), ``flash_offset_check``: B3 with a query
  offset, at llama3.2-3b's query rows of 16 model ranks under prefill's
  ``seq_inner`` (2 x 2,048 rows of 24 heads against the whole 32,768
  keys of 8), bit for bit the same rows of one whole-sequence launch and
  within 3e-2 of its plain version (f32 on the scalar kernel within
  2e-5), timed beside its bound and SDPA's;
* slices 2 and 3a-3d, the six LM families the port runs: the dense LM
  at llama3.2-3b's full width (through B2 and B3 at head dim 128), the
  RWKV LM at rwkv6-1.6b's (B2 and B4: every forward WKV on B4's
  tensor-core kernel, every decode WKV on its sequential one), the hybrid
  LM at zamba2-7b's (B2 and B3 at head dim 112: Mamba2 blocks as PyTorch
  ops, a shared attention block heading each group of 6), the MoE LM at
  mixtral-8x7b's (B2 and B3 at head dim 128, GQA 4 and its window of 4096;
  8 experts, top-2, as PyTorch ops), the enc-dec LM at
  seamless-m4t-medium's (B2 and B3 at head dim 64: unmasked in the
  encoder over stubbed audio frames, causal in the decoder; its
  cross-attention as PyTorch ops) and the VLM at llava-next-mistral-7b's
  (B2, also on the patch embeddings, and B3 at head dim 128, GQA 4, over
  2,880 stubbed patch embeddings and 2,880 tokens a row): a float32 check
  of B3 (B4) inside a model 4 layers deep (zamba2: 7, one group and a tail
  of 1; mixtral: 2; seamless: 4 encoder and 4 decoder layers) against the
  plain attention (WKV), and of forward against teacher-forced decode
  (seamless on zero frames, where its memory is 0 as decode's is; none for
  llava, whose decode takes no patches), and a bfloat16 one of B3's
  tensor-core kernel (all but RWKV; the MoE checks route each compared run
  as the other did, ``HeldRouting``); then each main path at full width in
  bf16 (llama3.2-3b, rwkv6-1.6b, seamless-m4t-medium and
  llava-next-mistral-7b at full depth, zamba2-7b at 27 of its 81 layers to
  fit the run's budget, mixtral-8x7b at 24 of its 32 to fit the card) —
  ``launch.serve.serve`` (for a cut config, which ``serve`` cannot build,
  ``ServingEngine`` with ``serve``'s requests), a ragged run through
  ``ServingEngine`` (not for llava: its decode step is the dense block on
  tokens, which llama3.2-3b's ragged run drives; each over the first
  layers of its model, ``RAGGED_LAYERS``: 1 of llama3.2-3b's, of
  rwkv6-1.6b's, of mixtral-8x7b's and of seamless-m4t-medium's decoder
  layers, and zamba2-7b's first group and a tail layer, 7 layers, to fit
  the run's budget; 12 requests on 8 slots, so freed slots admit new
  prompts while others decode) and
  one forward of 2x2048
  tokens (seamless: over 2x2048 frames; llava: 2x5760 positions), each
  metered on the GPU's power counter, and then profiled windows of 2
  decode steps and of a forward. ``serve`` runs under the static placements the
  reference's ``serve()`` applies, and its line reports their modeled
  Watt·s (a TPU v5e model's, not the card's) beside the metered ones;
* slices 3e and 4a, on llama3.2-3b's and rwkv6-1.6b's full-width models:
  ``migration``, ``serve()``'s requests on two engines that share a
  view of the model's first layers (``MIGRATION_LAYERS``: 7 of llama's,
  8 of rwkv's), a live slot moved between them at admission, mid-decode and one
  token before its end (on llama also into an engine of half the cache),
  its tokens held to the never-migrated baseline's; and ``placement``,
  ``serve(..., adaptive=True)`` with its controller's planning time, and
  the metered GPU W·s a decode token fed back through ``note_metered``;
* slice 4b, the fleet, on llama3.2-3b at full width and depth through B2:
  ``launch.serve.serve_fleet`` on the mixed fleet (pod2_v5e, mxu_dense,
  hbm_lp; 2 slots each) with the energy policy, with ``adaptive=True``
  and with ``provision_budget_w`` (the capacity planner's fleet);
  ``FleetRouter.run(concurrent=True)`` on worker threads against one
  worker, token- and ledger-identical; and ``workload.simulate`` of a
  seeded bursty trace with autoscaling and live rebalancing, its moved
  requests' tokens held to a never-migrated run's. Each run's modeled
  ledger (no request has an eos, so it does not depend on tokens) must
  equal the same call's on the CPU at the reduced config, run here too;
* slices 6a + 7a, single-device training through B2 and B3 with their
  gradients (each a hand-written kernel: B2's in ``csrc/rmsnorm.cu``, B3's
  in ``csrc/flash_attention.cu``): ``train_grad_check``, B2's and B3's
  gradients at the training shapes in f32 and bf16 against autograd
  through their plain versions, timed beside it, beside the library's
  (``F.rms_norm``'s, as device time under the profiler; SDPA's) and beside
  the PyTorch ops each gradient kernel replaced;
  B3's forward timed with and without the log-sum-exp training asks of it; ``train_model_check``, llama3.2-3b at full width, 4 layers, f32:
  ``forward_loss`` and every parameter's gradient through the kernels
  against the same through the plain versions; ``train``,
  ``launch.train.train`` on llama3.2-3b at full width and depth in bf16
  (8 steps of 2 x 2048 tokens, remat full), metered on the GPU's power
  counter, its launches of B2, B3 and B3's backward held to the count the
  code gives,
  then one step profiled; ``train_bf16_check``, that bf16 step at 14
  layers through the kernels against the same step through the plain
  versions from one seeded state (step 1's gradient leaf by leaf against
  the f32 gradient, two steps' losses and grad norms), then 8 steps on
  one batch repeated, whose loss must fall;
  ``train_resume``, at full width over 1 layer, a checkpoint saved after
  step 2, restored and held bit for bit to the live state that was saved,
  and steps 3-4 resumed from it against an unbroken run's losses;
* slice 7b, the other five families train on one card, RWKV through B4's
  backward (``csrc/wkv.cu``: a chunked tensor-core kernel at head dim 64
  from S = 64, the sequential one below and at head dim 16):
  ``wkv_backward_check``, the backward against autograd through
  ``wkv_ref`` at the training shape, at S = 333, under weak and strong
  decay and at head dim 16, timed beside the sequential backward kernel
  and its bound;
  ``family_grad_check``, B2's and B3's gradients at the families' training
  shapes; then for rwkv6-1.6b, zamba2-7b (27 layers), mixtral-8x7b (2
  layers, 8 experts), seamless-m4t-medium and llava-next-mistral-7b (16
  layers, 5,760 positions): ``family_model_check`` (f32, 2 layers; zamba2
  7), every gradient leaf through the kernels against the plain versions;
  ``family_bf16_check``, one bf16 step's gradient (at the training depth;
  rwkv at 4 layers, zamba2 at 7, llava at 4), leaf by leaf against the
  f32 plain gradient beside plain bf16's (rwkv also in f32 at that depth,
  each leaf held within twice what a one-ulp nudge of the embedding moves
  the plain gradient); and
  ``family_train``, 2 steps of ``launch.train.train`` (the VLM, which
  ``train()`` refuses as the reference's fails, ``train_step`` on
  ``synthetic_batch``), metered, each kernel's launches held to the count
  the code gives and the first loss to what random init gives
  (``expected_first_loss``); rwkv and zamba2 also profiled a step;
* slice 7c, the mesh step builders on a 1x1 ("data", "model") mesh
  (``launch/mesh.py`` ``make_mesh_compat``, a process group of one rank):
  ``mesh_train_check``, llama3.2-3b at full width, 2 layers, f32,
  ``launch.steps.build_train_step`` at accum 4 over 8 x 2048 tokens
  through the kernels against the same through the plain versions, with
  AdamW, with int8 gradient compression and with Adafactor (the gradient,
  as AdamW's first moment, the error feedback, Adafactor's factored
  moments and every updated parameter, leaf by leaf), launches the code's
  count a microbatch x 4; ``mesh_train``,
  ``launch.train.train(..., mesh=...)`` at full width and depth in bf16
  at the config's own accum of 4 (3 steps of 8 x 2048 tokens), metered,
  its launches of B2, B3 and their gradient kernels held to the code's
  count x 4 a step, then 2 steps each of ``build_train_step`` with int8
  gradient compression and of the Adafactor config; in both, the layer
  gathers' calls a step held to the code's count (``mesh_gather_calls``)
  with no byte copied and no collective, every shard being the whole,
  and no collective of the model-parallel region (``MODEL``: a model axis
  of one rank splits nothing, neither the blocks nor the sequence, so no
  all-gather or reduce-scatter of it); ``mesh_prefill``,
  ``launch.steps.build_prefill_step`` on the same mesh at 4 layers in
  f32 over 2 x 2048 tokens, its logits bit for bit
  ``forward``'s, with no such collective; slice 7d's ``mesh_serve``,
  ``launch.steps.build_serve_step`` on the same mesh, llama3.2-3b at full
  width and depth in bf16, MESH_SERVE's slots, cache and steps from one
  seeded state (cache rows drawn, positions spread over the cache), held
  bit for bit to ``decode_step`` on a copy of that state (logits, greedy
  tokens, the state after), with no collective (the caches' sequence and
  the model axis of one rank split nothing), no byte gathered and B2's
  launches equal on both sides, ms a step on each side;
* slice 1, the paper's GA offload loop at the paper's L grid
  (512x256x256): ``himeno_run``, Fig. 5 through
  ``MeteredBackend.auto(HimenoMeasuredBackend(HimenoApp(L)))`` for the
  all-CPU placement and the paper's pattern, and ``search_himeno`` over
  that backend. Fig. 5's backend warms each placement up with one sweep
(``FIG5_WARMUP_ITERS``) before its runs of 62.

The kernels' launch counts are set to 0 just before each main path (the
migration and adaptive runs and each fleet run count as a path of their
own) and read just after; a kernel's ``launches`` in the kernels line add up the paths
it ran on (``launches_by_path`` keeps them apart). Every phase prints
one JSON line; then the kernels' line; the line before the last is the
card's name and power limit as ``nvidia-smi`` gives them, the last line is
``{"ok": true, "device": {...}}``. Any failed check, or a run over
``BUDGET_S``, exits non-zero without that line. Without CUDA, or without
the repo beside it, the script fails before it prints a result.
"""
from __future__ import annotations

import contextlib
import functools
import json
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): device memory rate and f32
# outside the tensor cores. The bound of a kernel is the larger of its bytes
# over the first and its operations over the second.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense, on the tensor cores
P_ATOL = 1e-5      # p_new and ss against the plain version, at most
SS_RTOL = 1e-3     # ... and at most this share of the largest |ss| compared
GOSA_RTOL = 1e-4   # gosa against the plain version, and across placements
OMEGA = 0.8        # the sweep's relaxation factor
REPLACES = "src/repro/kernels/himeno/kernel.py:21"
SOURCE = "src/repro_torch/csrc/himeno.cu"
ARGS = ("p", "a", "b", "c", "bnd", "wrk1")
REPS = 20          # kernel launches a timing averages over
SOLVER_ITERS = 10  # sweeps of the himeno_run phase
FIG5_ITERS = 62    # sweeps of each Fig. 5 run at L, as in the paper
FIG5_WARMUP_ITERS = 1  # sweeps of each placement's warm-up run
# Sweeps of each GA measurement at L. An all-CPU sweep costs about 2 s of
# NumPy, and the GA makes up to 24 measurements (population 6, 4
# generations), most of them with host units: at the paper's 62 sweeps the
# GA alone would take far longer than the smoke's limit of 1200 s. One
# sweep since training joined the run (at two the GA took 101 s of a run of
# 1,046 on a slow host).
GA_ITERS = 1
SMOKE_LIMIT_S = 1200
BUDGET_S = 900.0   # a run over this is reported as timed out and fails

# Slice 2: the dense LM path (llama3.2-3b) through kernels B2 and B3.
ARCH = "llama3.2-3b"
F32_ATOL = 2e-5    # f32 kernels against their plain versions
FLASH_BF16_ATOL = 3e-2  # bf16 attention (the JAX package's kernel tests)
# Forward against teacher-forced decode, as a share of max |logits|. The
# reference's own check (tests/test_arch_smoke.py) holds its reduced configs
# to 5e-3. Decode reads K/V from a bf16 cache where forward keeps them in
# f32, and at this check's size the reference itself exceeds 5e-3: on the
# same weights and tokens, llama3.2-3b in f32 at full width, 4 layers,
# 2 x 512 tokens, the JAX package gives 6.003e-3 and the port 6.010e-3 on
# a CPU (tests/test_torch_decode_gap.py, run as a script). So the limit
# here is 1e-2, and B3 is held inside the same model to MODEL_B3_RTOL
# against the plain attention, which has no cache.
DECODE_RTOL = 1e-2
MODEL_B3_RTOL = 1e-4
MODEL_B4_RTOL = 1e-4  # B4 against the plain WKV inside the f32 RWKV model
# RWKV's forward against teacher-forced decode, on shift_rwkv's weights
# (token-shift mixes, bonus and ln_wkv drawn, decays near 0.98), where
# decode's bf16 tm_x/cm_x reach the logits. The JAX package gives 7.271e-3
# and the port 7.242e-3 on its weights with the same shifted leaves
# (rwkv6-1.6b in f32 at full width, 4 layers, 2 x 512 tokens, on a CPU:
# tests/test_torch_decode_gap.py rwkv6-1.6b, run as a script); on this
# check's own weights the card reads 9.316e-3. The limit is 2e-2. A decode
# that zeroes one carried leaf (wkv, tm_x or cm_x) before each step is
# 0.07 or more off in the reduced model already
# (tests/test_torch_rwkv_model.py).
RWKV_DECODE_RTOL = 2e-2
CHECK_LAYERS = 4   # depth of the f32 full-width model checks
CHECK_SEQ = 512
RAGGED = dict(slots=8, max_len=1024, requests=12, prompt=(64, 512),
              max_new_tokens=64, seed=0)
# Depth of the ragged runs (a view of the path's model, sharing its
# weights), cut to fit the run's budget: a ragged step is host-bound and its
# time goes with the layers it launches. Once migration and placement
# joined, llama's ran over 14 of its 28 layers and mixtral's over 12 of its
# 24; once training joined, on a host where the five ragged runs took 229 s
# of a run of 1,046, over 7 (llama), 6 (mixtral), 8 of rwkv's 24 and 4 of
# seamless's 12 decoder layers; once the five families' training joined
# (a run of 853 s, the ragged runs 39 s of it), 12 requests, not 16, on
# the 8 slots (more requests than slots, so a freed slot admits a prompt
# while the others decode), over 2 (llama), 2 (mixtral), 2 (rwkv) and 2
# (seamless) layers; over 1 each once prefill's seq_inner check joined
# (the four took 25 s of a run of 890).
RAGGED_LAYERS = {"llama3.2-3b": 1, "mixtral-8x7b": 1, "rwkv6-1.6b": 1,
                 "seamless-m4t-medium": 1}
# zamba2-7b's ragged run over its first group of 6 and one tail layer (a
# view sharing the weights), cut to make room for the fleet: its 27 layers
# took ~42 s of the run.
HYBRID_RAGGED_LAYERS = 7
PREFILL = (2, 2048)  # batch x tokens of the main path's forward
# train_step's profiler spans (launch/train.py), left out of a profile's
# device time, which counts their kernels already
TRAIN_STEP_SPANS = frozenset({"forward", "backward", "optimizer"})
# decode steps a decode_profile window profiles (after two to warm up): 10
# took 95 s of the six paths' profiling in a run of 853 s, most of it the
# profiler's own processing of ~2,000-4,600 launches a step
DECODE_PROFILE_STEPS = 2
RMS_SHAPES = (((8, 1, 3072), "bfloat16"), ((2, 2048, 3072), "bfloat16"),
              ((8, 1, 3584), "bfloat16"), ((2, 2048, 3584), "bfloat16"),
              ((8, 1, 4096), "bfloat16"), ((2, 2048, 4096), "bfloat16"),
              # seamless-m4t-medium's width; llava's patch norm, and every
              # other norm of its forward, after the patches are prepended;
              # both paths' serve() batch of 4 slots
              ((8, 1, 1024), "bfloat16"), ((2, 2048, 1024), "bfloat16"),
              ((2, 2880, 4096), "bfloat16"), ((2, 5760, 4096), "bfloat16"),
              ((4, 1, 1024), "bfloat16"), ((4, 1, 4096), "bfloat16"),
              # rwkv6-1.6b's width; the serve() and migration batch of 4
              # slots of llama3.2-3b and rwkv6-1.6b
              ((8, 1, 2048), "bfloat16"), ((2, 2048, 2048), "bfloat16"),
              ((4, 1, 3072), "bfloat16"), ((4, 1, 2048), "bfloat16"),
              # the fleet's decode step of llama3.2-3b: 2 slots an engine
              ((2, 1, 3072), "bfloat16"),
              ((37, 5632), "float32"))
# B2 at rwkv6-1.6b's prefill width, the one shape where F.rms_norm read
# faster (0.0114 ms against 0.0127, timed once): timed with twice the reps
RMS_REMEASURE = ((2, 2048, 2048), "bfloat16")
# (B, H, K, S, D, dtype, causal, window); bf16 at D = 64 and 128 takes the
# tensor-core kernel, the rest the scalar one. The main path's shape also
# in f32, where F32_ATOL can catch a dropped or misplaced key tile that
# FLASH_BF16_ATOL, near the size of a typical |o| at S=2048, cannot; in
# bf16 the tensor-core kernel is held, element by element, to the bound
# that rounding P and o to bf16 allows against the f32 attention of the
# same bf16 values (``bf16_error_bound``), which such a tile breaks.
FLASH_SHAPES = ((2, 24, 8, 2048, 128, "bfloat16", True, 0),
                (2, 24, 8, 2048, 128, "float32", True, 0),
                # zamba2-7b's shared attention (head dim 112, no GQA)
                (2, 32, 32, 2048, 112, "bfloat16", True, 0),
                (2, 32, 32, 2048, 112, "float32", True, 0),
                (1, 4, 4, 333, 112, "bfloat16", True, 0),
                # mixtral-8x7b's attention (GQA 4, window 4096), and a
                # sequence its window cuts
                (2, 32, 8, 2048, 128, "bfloat16", True, 4096),
                (2, 32, 8, 2048, 128, "float32", True, 4096),
                (1, 32, 8, 6144, 128, "bfloat16", True, 4096),
                (1, 8, 2, 1000, 64, "bfloat16", True, 256),
                (1, 8, 2, 1000, 64, "float32", True, 256),
                (1, 4, 4, 333, 16, "float32", False, 0),
                # seamless-m4t-medium's encoder (unmasked) and decoder
                # (causal) self-attention, and a ragged unmasked one
                (2, 16, 16, 2048, 64, "bfloat16", False, 0),
                (2, 16, 16, 2048, 64, "float32", False, 0),
                (2, 16, 16, 2048, 64, "bfloat16", True, 0),
                (1, 16, 16, 333, 64, "bfloat16", False, 0),
                # llava-next-mistral-7b's prefill: 2,880 patches and 2,880
                # tokens a row, GQA 4
                (2, 32, 8, 5760, 128, "bfloat16", True, 0))
# B3 with a query offset (prefill's seq_inner): llama3.2-3b's query rows on
# the production mesh's 16 model ranks at prefill_32k, each rank's 2,048 of
# 32,768 rows (2 rows of 24 heads of 128) against the whole sequence's K/V
# (8 heads), causal, in bf16 at the ranks below (offset rank x 2,048, a
# multiple of both kernels' query tiles) and in f32 at the rank f32_rank
FLASH_OFFSET = dict(batch=2, heads=24, kv_heads=8, rows=2048, model=16,
                    head_dim=128, ranks=(0, 7, 15), f32_rank=7)
# B3 (tensor cores) inside the bf16 llama3.2-3b at full width, CHECK_LAYERS
# deep, against the plain attention, as a share of max |logits|: the bf16
# bound between the two packages' models on the CPU (PERF.md section 7)
MODEL_B3_BF16_RTOL = 2e-2
HOST_CALLS = 10_000  # calls each step of B2's and B4's launch paths is timed
# Slice 3e: mid-flight migration on llama3.2-3b's and rwkv6-1.6b's main
# paths: serve()'s requests on engines of 4 slots and max_len 1024; on
# llama also one move into an engine of max_len 512 (a resize), whose
# request must keep its tokens or part only at a bf16 near-tie, within
# NEAR_TIE_RTOL of max |logits| (tests/test_torch_serving.py's bf16 rule).
MIGRATION = dict(slots=4, max_len=1024, requests=8, max_new_tokens=32,
                 resize_len=512, resize_rid=2)
# The migration runs over a view of the path model's first layers
# (``first_layers``, sharing its weights): at full depth llama's took 19 s
# and rwkv's 8 of a run of 890.
MIGRATION_LAYERS = {"llama3.2-3b": 7, "rwkv6-1.6b": 8}
NEAR_TIE_RTOL = 2e-2

# Slice 4b: the fleet on llama3.2-3b's full-width model. serve_fleet's
# requests (3-token prompts, no eos) on the mixed fleet, 2 slots and
# max_len 64 an engine; PROVISION_W is the nameplate budget under which the
# capacity planner builds two destination types (mxu_dense and hbm_lp: 30
# kW builds one mxu_dense, 50 kW one of each). FLEET_REPLAY is a seeded
# bursty trace of 24 requests of serve's two tenants (chat with an SLO,
# batch) and the replay's options: autoscaling ticks, and a live rebalance
# every millisecond of the virtual clock off engines whose queue holds more
# than their slots, which moves admitted slots (2 on the CPU's run).
# 16 and 8 new tokens since training joined the run (32 and 16 before:
# the fleet's six runs took 75 s of a run of 1,046 on a slow host); 8
# requests on the fleet's 6 slots, so freed slots admit queued ones, at 8
# new tokens since the five families' training joined (at 16 the fleet
# took 59 s of a run of 777 on a slow host)
FLEET = dict(num_requests=8, max_new_tokens=8)
# the threaded executor's run: serve_fleet's requests at 4 new tokens
FLEET_THREADS = dict(num_requests=8, max_new_tokens=4)
PROVISION_W = 50_000.0
FLEET_REPLAY = dict(
    spec=dict(seed=0, duration_s=0.012, rate_rps=2400.0, max_len=64,
              arrival="bursty"),
    router=dict(slots=2, max_len=64, autoscale=True, saturation_factor=1.0),
    simulate=dict(autoscale_every_s=0.002, rebalance_every_s=0.001,
                  rebalance_live=True))
# ServingEngine and serve_fleet report fields that may differ between the
# card's run and the CPU's: wall-clock ones, the tokens and the device
FLEET_UNMODELED = frozenset({"wall_s", "tokens_per_s", "outputs", "device"})

# Slice 3b: the hybrid LM path (zamba2-7b) through kernels B2 and B3.
HYBRID_ARCH = "zamba2-7b"
# Depth of its model checks: one group of 6 Mamba layers under the shared
# attention and a tail of 1, so that both B3 and the tail run.
HYBRID_CHECK_LAYERS = 7
# Its forward against teacher-forced decode, as a share of max |logits|:
# decode reads the shared attention's K/V from the bf16 cache. The JAX
# package gives 9.962e-3 and the port 9.904e-3 on the same weights and
# tokens (zamba2-7b in f32 at full width, 7 layers, 2 x 512 tokens, on a
# CPU: tests/test_torch_decode_gap.py zamba2-7b, run as a script), at the
# dense check's 1e-2 already, so the limit is 2e-2, as RWKV's.
HYBRID_DECODE_RTOL = 2e-2
# B3 (tensor cores) inside the bf16 zamba2-7b at full width, 7 layers deep,
# against the plain attention, as a share of max |logits|. This model turns
# any bf16-sized change of its one attention block into 2-3% of its
# logits: the plain version itself, with its scores rounded to bf16 (as the
# reference's einsum does) or kept in f32 on the same bf16 operands, parts
# by 2.7e-2 and 2.9e-2 on two seeds on the card, and SDPA from either by
# 1.4e-2 to 3.0e-2, where the kernel lies 1.4e-2 to 1.6e-2 from SDPA. So
# the limit is 4e-2, and each run reports the plain version's own spread
# (``plain_bf16_vs_f32_over_max_logits``) beside the kernel's distance.
HYBRID_B3_BF16_RTOL = 4e-2
# In either bf16 model B3 must also move the logits at most this many times
# as far as the plain version's own spread does (the kernel reads 0.96 and
# 1.06 of it in zamba2-7b and llama3.2-3b on the card); a dropped or
# misplaced K/V tile would move them far more.
B3_BF16_SPREAD_FACTOR = 1.5
# Depth of zamba2-7b's main path: 4 groups of 6 and its tail of 3, so that
# B3 and the tail still run; its 81 layers' ragged run alone took 95 s of
# the run's budget.
HYBRID_LAYERS = 27

# Slice 3c: the MoE LM path (mixtral-8x7b) through kernels B2 and B3. Its
# 32 layers are 93.4 GB of bf16 weights, more than the card's 80 GB: the
# main path runs 24 (70.2 GB), at full width.
MOE_ARCH = "mixtral-8x7b"
MOE_LAYERS = 24
# Depth of its model checks at full width: the f32 model is ~12.7 GB.
MOE_CHECK_LAYERS = 2
# Its forward against teacher-forced decode at capacity factor E/k (no
# choice drops), as a share of max |logits|, with the routing held
# (``HeldRouting``): the JAX package gives 1.180e-2 and the port 1.212e-2
# on the same weights and tokens (mixtral-8x7b in f32 at full width, 2
# layers, 2 x 512 tokens, on a CPU: tests/test_torch_decode_gap.py
# mixtral-8x7b, run as a script), over the dense check's 1e-2, so the limit
# is 2e-2, as RWKV's and the hybrid's. The routing held, 10 (port) and 11
# (JAX package) decode tokens would have gone to other experts there.
MOE_DECODE_RTOL = 2e-2
# B3 (tensor cores) inside the bf16 mixtral-8x7b, routing held, as a share
# of max |logits|: like zamba2-7b's, this model turns a bf16-sized change of
# its attention into ~3% of its logits (the plain version with its scores
# in bf16 or in f32 parts by 3.1e-2 on the card), so the hybrid's 4e-2,
# beside B3_BF16_SPREAD_FACTOR.
MOE_B3_BF16_RTOL = 4e-2

# Slice 3d: the enc-dec LM path (seamless-m4t-medium: a 12-layer encoder
# over stubbed audio frames, 12 decoder layers with cross-attention) and the
# VLM path (llava-next-mistral-7b: the dense block of 32 layers behind 2,880
# stubbed patch embeddings), both through kernels B2 and B3, at full width
# and depth. B3 takes the encoder's unmasked self-attention and every causal
# one; cross-attention and decode attention are PyTorch ops.
ENCDEC_ARCH = "seamless-m4t-medium"
VLM_ARCH = "llava-next-mistral-7b"
# The enc-dec forward against teacher-forced decode runs on zero frames:
# decode attends to the state's cross_k/cross_v, which neither package ever
# fills (zeros), and on zero frames the forward's memory is exactly 0 too,
# so the check is exact in kind. The JAX package gives 5.008e-3 and the
# port 4.979e-3 on the same weights and tokens (seamless-m4t-medium in f32
# at full width, 4 encoder and 4 decoder layers, 2 x 512 tokens, on a CPU:
# tests/test_torch_decode_gap.py seamless-m4t-medium, run as a script),
# at the reference test's 5e-3 already, so the limit is the dense check's
# 1e-2.
ENCDEC_DECODE_RTOL = 1e-2
# B3 (tensor cores) inside the bf16 seamless-m4t-medium, CHECK_LAYERS
# encoder and decoder layers, against the plain attention, as a share of
# max |logits|: the dense check's limit, beside B3_BF16_SPREAD_FACTOR.
ENCDEC_B3_BF16_RTOL = 2e-2
# The same inside the bf16 llava-next-mistral-7b, CHECK_LAYERS deep: the
# plain version itself, with its scores rounded to bf16 or kept in f32 on
# the same bf16 operands, parts by 2.33e-2 on the card, over the dense
# check's 2e-2 (the kernel lay 2.43e-2 from plain, 1.04 of that spread),
# so the hybrid's 4e-2, beside B3_BF16_SPREAD_FACTOR.
VLM_B3_BF16_RTOL = 4e-2
# positions of llava's forward: its full anyres budget of 2,880 patch
# embeddings a row, and as many tokens
VLM_PREFILL = (2, 5760)

# Slice 3a: the RWKV LM path (rwkv6-1.6b) through kernels B2 and B4.
RWKV_ARCH = "rwkv6-1.6b"
# B4 against its plain version: out within WKV_RTOL of max |out|, the final
# state within WKV_RTOL of max |state|. The plain version in f32 lies within
# 1e-6 of a float64 scan at these shapes, weak and strong decays included.
WKV_RTOL = 1e-5
MODEL_LW = (-1.61, -0.64)  # log-decays of the random-init model (Motivation)
# (B, H, S, D), lw range, initial state, the model's (B,S,H,D) layout, label
WKV_CASES = (((2, 32, 2048, 64), MODEL_LW, False, True, "forward"),
             ((8, 32, 1, 64), MODEL_LW, True, True, "decode"),
             # serve()'s and the migration runs' batch of 4 slots
             ((4, 32, 1, 64), MODEL_LW, True, True, "serve_decode"),
             ((2, 32, 333, 64), MODEL_LW, True, True, "ragged"),
             ((1, 32, 2048, 64), (-0.01, 0.0), True, False, "weak"),
             ((2, 32, 512, 64), (-20.0, 0.0), True, False, "strong"))


# Slices 6a + 7a: single-device training of llama3.2-3b through B2 and B3,
# each gradient a hand-written kernel (csrc/rmsnorm.cu,
# csrc/flash_attention.cu).
# train_grad_check: B2 at the training shape in f32 and bf16, B3 at the
# training shape, causal, bf16 on the tensor-core kernel and f32 on the
# scalar one, against autograd through the plain versions. f32: dx and
# dscale within GRAD_RMS_RTOL of their max |.|, dq, dk, dv within
# GRAD_FLASH_RTOL; bf16: each gradient's distance from the f32 plain
# gradient at most GRAD_BF16_FACTOR times the bf16 plain gradient's own
# (or the f32 limit, where the plain one lands on the f32 result exactly).
GRAD_RMS_SHAPE = (2, 2048, 3072)
GRAD_FLASH_SHAPE = (2, 24, 8, 2048, 128)  # B, H, K, S, D
GRAD_RMS_RTOL = 1e-5
GRAD_FLASH_RTOL = 1e-4
GRAD_BF16_FACTOR = 1.5
# train_model_check: llama3.2-3b at full width, CHECK_LAYERS deep, f32,
# 2 x CHECK_SEQ tokens: forward_loss and every parameter's gradient
# through the kernels against the same through the plain versions
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3  # of each leaf's max |g|
# train_main_path: launch.train.train at full width and depth in bf16
TRAIN = dict(steps=8, global_batch=2, seq_len=2048)
# train_bf16_check: the same step at full width and depth in bf16 through
# the kernels and through the plain versions, from one seeded state and
# batches, for BF16_CHECK["steps"] steps at train()'s lr. Step 1's gradient
# leaf by leaf: its L2 distance from the f32 plain gradient at most
# GRAD_BF16_FACTOR times the bf16 plain gradient's (a zero, sign-flipped or
# mis-scaled gradient is 1 or more away); each step's loss and grad norm
# within BF16_LOSS_RTOL (the CPU end-to-end test's bf16 limit). Then TRAIN's
# steps on one batch repeated: the loss must fall by "repeat_drop" nats
# (at 14 of the 28 layers since prefill's seq_inner check joined: at 28 it
# took 13 s of a run of 890)
BF16_CHECK = dict(steps=2, lr=1e-3, repeat_drop=1.0, layers=14)
BF16_LOSS_RTOL = 1e-2
# resume: full width over 1 layer (~5 GB of state a checkpoint, most of it
# the embedding's; 2 layers and 5 steps took 51 s before the five families'
# training joined): an unbroken run of 4 steps, then 2 steps saved at their
# end, then a run that restores them and takes steps 3-4, whose losses must
# equal the unbroken run's within RESUME_RTOL
RESUME = dict(layers=1, steps=4, saved=2)
RESUME_RTOL = 1e-3
# Slice 7c: the mesh step builders on a 1x1 ("data", "model") mesh.
# mesh_train_check: llama3.2-3b at full width, MESH_CHECK_LAYERS deep, f32,
# build_train_step at MESH_ACCUM microbatches over MESH["global_batch"] rows
# of MESH["seq_len"], one step through the kernels and one through the
# plain versions from one seeded state, for each of MESH_CHECK_VARIANTS:
# the gradient (read as AdamW's first moment after the step, m = (1 - b1)
# clip g) and Adafactor's vr and vc within TRAIN_GRAD_RTOL of each leaf's
# max; each updated parameter, the error feedback ef (on its int8 grid's
# span) and the compressed and Adafactor runs' first moments too, but for a
# share of at most MESH_OUTLIERS of a leaf's elements, held within
# MESH_OUTLIER_RTOL: AdamW's and Adafactor's normalized first steps send a
# gradient element near zero, whose sign the two runs' rounding may set
# apart, to +-lr, and an int8 rounding flip moves a compressed gradient
# element and its ef by one grid step (MESH_FLIP_RTOL for the compressed
# run). mesh_train: launch.train.train
# at full width and depth in bf16 at the config's own accum (4) on the
# mesh, metered; then MESH_EXTRA_STEPS steps of build_train_step with
# compress_grads=True and of the same config with optimizer="adafactor"
# (state from init_factored_state); each first loss within FIRST_LOSS_NATS
# of expected_first_loss
MESH = dict(steps=3, global_batch=8, seq_len=2048)
MESH_ACCUM = 4
# mesh_train_check's depth (at CHECK_LAYERS, 4, it took 15 s of a run of
# 890)
MESH_CHECK_LAYERS = 2
MESH_CHECK_VARIANTS = ("adamw", "compress_grads", "adafactor")
MESH_EXTRA_STEPS = 2
MESH_OUTLIERS = 1e-3
MESH_OUTLIER_RTOL = 1e-2
# the compressed run's outliers: an int8 flip moves a decompressed gradient
# element one grid step (1/127 of its leaf's max; ef and m by as much), v
# by up to 2/127 of its max, and a parameter's first AdamW step between 0
# and +-lr (1.82e-2 of the leaf's max at lr 3e-4 on an NVIDIA H100 80GB HBM3)
MESH_FLIP_RTOL = 2.5e-2
FIRST_LOSS_NATS = 0.1
# Slice 7d: the mesh serve step on the 1x1 mesh (mesh_serve): llama3.2-3b
# at full width and depth in bf16, these slots, cache and greedy steps
MESH_SERVE = dict(slots=8, cache=1024, steps=8)
# mesh_prefill: build_prefill_step on the 1x1 mesh at mesh_train_check's
# depth in f32, over these rows of MESH["seq_len"] tokens
MESH_PREFILL_ROWS = 2
# Slice 7d's dry run (phase dryrun): the mesh_prefill cell on a fake world
# of one rank, its predicted peak above the arguments held within this
# share of the card's measured one
DRYRUN_PEAK_RTOL = 0.10
DRYRUN_TIMEOUT_S = 60
# the child's own seconds, imports included, reported against this limit
# (it runs beside mesh_train_check, and is stopped while mesh_prefill
# times its step)
DRYRUN_CHILD_S = 30
DRYRUN_CELL = {"arch": ARCH, "layers": CHECK_LAYERS, "dtype": "float32",
               "rows": MESH_PREFILL_ROWS, "seq_len": MESH["seq_len"]}
# the child: imports the port only, runs on the host's fake tensors, prints
# one JSON line
DRYRUN_CHILD = """
import dataclasses, json, sys, time, warnings
warnings.simplefilter("ignore")
t0 = time.perf_counter()
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch.dryrun import dry_run, run_cell
c = json.loads(sys.argv[1])
cfg = dataclasses.replace(get_config(c["arch"]), num_layers=c["layers"],
                          dtype=c["dtype"])
shape = ShapeSpec("mesh_prefill", "prefill", c["seq_len"], c["rows"])
t1 = time.perf_counter()
out = {"mesh_prefill": dry_run(cfg, shape, (1, 1))}
t2 = time.perf_counter()
rows = []
for over in (None, {"seq_inner": None}):
        r = run_cell(c["arch"], "prefill_32k", multi_pod=False,
                     skip_probes=True, overrides=over)
        rows.append({k: r.get(k) for k in (
            "status", "rank", "overrides", "mesh", "trace_s", "memory",
            "artifact_cost_analysis", "artifact_collectives", "kernels")})
out["production"] = rows
t3 = time.perf_counter()
out["seconds"] = t3 - t0
out["seconds_by_part"] = {"imports": t1 - t0, "mesh_prefill": t2 - t1,
                          "prefill_32k": t3 - t2}
print(json.dumps(out))
"""


# Slice 7b: single-device training of the other five families, B4's
# backward kernel (csrc/wkv.cu). wkv_backward_check: the kernel against
# autograd through wkv_ref, each of dr, dk, dv, dlw, du within
# WKV_GRAD_RTOL of its max |.|: (B, H, S, D), lw range, the model's
# (B, S, H, D) layout, label; the training shape first, then S not a
# multiple of 64, the forward's weak and strong decays, head dim 16
WKV_GRAD_RTOL = 1e-4
WKV_GRAD_CASES = (((2, 32, 2048, 64), MODEL_LW, True, "train"),
                  ((2, 32, 333, 64), MODEL_LW, True, "ragged"),
                  ((1, 32, 2048, 64), (-0.01, 0.0), False, "weak"),
                  ((2, 32, 512, 64), (-20.0, 0.0), False, "strong"),
                  ((2, 32, 512, 16), MODEL_LW, False, "head_dim_16"))
# family_grad_check: B2 and B3 at the shapes the families train at, bf16:
# (arch, kernel, shape ((B, S, d) or (B, H, K, S, D)), causal, window)
FAMILY_GRAD_SHAPES = (
    ("rwkv6-1.6b", "rms_norm", (2, 2048, 2048), None, None),
    ("zamba2-7b", "rms_norm", (2, 2048, 3584), None, None),
    ("mixtral-8x7b", "rms_norm", (2, 2048, 4096), None, None),
    ("seamless-m4t-medium", "rms_norm", (2, 2048, 1024), None, None),
    ("llava-next-mistral-7b", "rms_norm", (2, 5760, 4096), None, None),
    ("llava-next-mistral-7b", "rms_norm", (2, 2880, 4096), None, None),
    ("zamba2-7b", "flash_attention", (2, 32, 32, 2048, 112), True, 0),
    ("mixtral-8x7b", "flash_attention", (2, 32, 8, 2048, 128), True, 4096),
    ("seamless-m4t-medium", "flash_attention", (2, 16, 16, 2048, 64), False,
     0),
    ("seamless-m4t-medium", "flash_attention", (2, 16, 16, 2048, 64), True,
     0),
    ("llava-next-mistral-7b", "flash_attention", (2, 32, 8, 5760, 128), True,
     0))
# (arch, train depth (None: full), f32 check depth, bf16 check depth (None:
# the train depth), positions a row): the depths one 80 GB card holds at 12
# B a parameter (bf16 weights and gradients, f32 moments); zamba2 at its
# served 27 layers (4 groups and a tail of 3), its checks at one group and
# a tail layer; mixtral at 2 of 32 layers with all 8 experts (3 layers,
# 4.6B parameters, ~55 GB before activations, is too close); llava at 16 of
# 32 over 2,880 patches and 2,880 tokens a row; seamless's check at 2
# encoder and 2 decoder layers. The bf16 checks of rwkv (at its 24 layers,
# whose plain WKV runs three times, 64 s of a run of 890), zamba2 and llava
# at a cut depth since prefill's seq_inner check joined.
TRAIN_FAMILIES = (("rwkv6-1.6b", None, 2, 4, 2048),
                  ("zamba2-7b", 27, 7, 7, 2048),
                  ("mixtral-8x7b", 2, 2, None, 2048),
                  ("seamless-m4t-medium", None, 2, None, 2048),
                  ("llava-next-mistral-7b", 16, 2, 4, 5760))
# steps of each family's training run (3 until prefill's seq_inner check
# joined)
FAMILY_TRAIN = dict(steps=2)
# a family's first training loss against expected_first_loss, in nats: the
# first runs read 0.008-0.032 from it (0.20-0.83 above ln V)
FIRST_LOSS_ATOL = 0.1
FAMILY_PROFILED = ("rwkv6-1.6b", "zamba2-7b")
# family_model_check: every gradient leaf, kernels against plain versions
# in f32, within FAMILY_GRAD_RTOL of its max |g| (loss: TRAIN_LOSS_RTOL):
# 1e-5, but 3e-5 for RWKV and 5e-5 for zamba2, whose leaves read up to
# 1.5e-5 and 3.6e-5. For those two the check also reads how far each
# leaf's plain gradient moves when the embedding table moves by one f32 ulp
# (random signs, seeded): the leaf's own sensitivity to a change of
# rounding in the forward, which is what the kernels (and B4's 3xTF32
# products) make. Its first run read the two within 1.4x of each other on
# every family (zamba2's A_log leaves 3.6e-5 and 2.8e-5 against 2.7e-5 and
# 3.4e-5), so the excess is that sensitivity, not a kernel's error.
FAMILY_GRAD_RTOL = {"rwkv6-1.6b": 3e-5, "zamba2-7b": 5e-5}
FAMILY_GRAD_RTOL_DEFAULT = 1e-5
FAMILY_ULP_LOOK = ("rwkv6-1.6b", "zamba2-7b")
# family_bf16_check's f32 comparison at the training depth (see there)
FAMILY_F32_AT_DEPTH = ("rwkv6-1.6b",)
FAMILY_DEPTH_ULP_FACTOR = 2.0
# family_bf16_check: each leaf's L2 distance from the f32 plain gradient
# through the kernels at most FAMILY_BF16_RATIO times plain bf16's
FAMILY_BF16_RATIO = 1.1


def kernel_modules():
    """The wrapper modules of every kernel of the port."""
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.kernels.himeno import kernel as b1
    from repro_torch.kernels.rmsnorm import kernel as b2
    from repro_torch.kernels.wkv import kernel as b4
    return (b1, b2, b3, b4)


def lm_wrappers():
    """The wrappers of the LM paths' kernels, B2-B4, by name."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rms_norm_cuda
    from repro_torch.kernels.wkv import wkv_cuda
    return {"rms_norm": rms_norm_cuda, "flash_attention": flash_attention_cuda,
            "wkv": wkv_cuda}


def lm_launches() -> dict[str, int]:
    """Each LM kernel's launches, and the tensor-core kernels' of B3 and B4
    apart."""
    wrappers = lm_wrappers()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    counts["flash_attention_tc"] = wrappers["flash_attention"].launches_tc
    counts["wkv_tc"] = wrappers["wkv"].launches_tc
    return counts


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """Each LM kernel's launches since ``before`` (an ``lm_launches()``)."""
    return {k: n - before[k] for k, n in lm_launches().items()}


def backward_launches() -> dict[str, int]:
    """The gradient kernels' launches (B2's, B3's, B4's both and B4's
    chunked one apart), beside ``lm_launches()`` on the training paths."""
    from repro_torch.kernels.flash_attention import \
        flash_attention_backward_cuda
    from repro_torch.kernels.rmsnorm import rms_norm_backward_cuda
    from repro_torch.kernels.wkv.kernel import wkv_backward_cuda
    return {"rms_norm_backward": rms_norm_backward_cuda.launches,
            "wkv_backward": wkv_backward_cuda.launches,
            "wkv_backward_tc": wkv_backward_cuda.launches_tc,
            "flash_attention_backward":
                flash_attention_backward_cuda.launches}


def backward_since(before: dict[str, int]) -> dict[str, int]:
    return {k: n - before[k] for k, n in backward_launches().items()}


def flash_backward_launches() -> int:
    from repro_torch.kernels.flash_attention import \
        flash_attention_backward_cuda
    return flash_attention_backward_cuda.launches


def train_launches(cfg) -> dict[str, int]:
    """Each LM kernel's launches in one training step of ``cfg`` (remat
    full), as the code gives them: the forward, then each remat block again
    in the backward (a layer; a hybrid group, the shared attention and its
    Mamba layers, or a tail layer), B2's gradient once a norm of the
    forward, B4's backward once a layer (on its chunked kernel: head dim 64
    and at least 64 tokens), B3's backward once an attention. Outside the
    blocks: the final norm, an encoder's enc_norm, the VLM's patch norm. B3
    on the tensor cores in bf16."""
    from repro_torch.models.transformer import hybrid_groups

    n = cfg.num_layers
    out = dict(rms_norm=4 * n + 1, flash_attention=2 * n, wkv=0, wkv_tc=0,
               wkv_backward=0, wkv_backward_tc=0)
    outside = 1  # norms outside the remat blocks: the final norm
    if cfg.family == "ssm":
        out.update(flash_attention=0, wkv=2 * n, wkv_tc=2 * n,
                   wkv_backward=n, wkv_backward_tc=n)
    elif cfg.family == "hybrid":
        groups, tail = hybrid_groups(cfg)
        blocks = groups * (1 + cfg.attn_every) + tail
        out.update(rms_norm=2 * blocks + 1, flash_attention=2 * groups)
    elif cfg.is_encdec:
        e = cfg.encoder_layers
        out.update(rms_norm=2 * (2 * e + 3 * n) + 2,
                   flash_attention=2 * (e + n))
        outside = 2
    elif cfg.frontend == "vision":
        out["rms_norm"] += 1
        outside = 2
    out["rms_norm_backward"] = (out["rms_norm"] + outside) // 2
    out["flash_attention_tc"] = (out["flash_attention"]
                                 if cfg.dtype == "bfloat16" else 0)
    out["flash_attention_backward"] = out["flash_attention"] // 2
    return out


def expected_first_loss(cfg) -> float:
    """The cross-entropy a random-init LM starts at: ln V + sigma^2 / 2,
    where sigma^2 = d * std^2 is the variance of a logit over the vocabulary
    (the final norm gives each position an RMS of 1, its scale 1 at init;
    std is the unembedding's init scale, the embedding's if tied), and ln V
    + sigma^2 / 2 is E[logsumexp] of V such logits. 0.02 at d 4096 puts it
    0.82 above ln V."""
    import math

    from repro_torch.models.transformer import model_defs

    emb = model_defs(cfg)["embedding"]
    d = emb["embed" if cfg.tie_embeddings else "unembed"]
    std = d.scale if d.init == "normal" else d.shape[-2] ** -0.5
    return math.log(cfg.vocab_size) + cfg.d_model * std ** 2 / 2


def bound_of(flops: int, nbytes: int, peak: float) -> tuple[float, str]:
    """(ms, what binds): the larger of ``nbytes`` over the memory rate and
    ``flops`` over ``peak``."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def wkv_backward_bound_ms(b, h, s, d) -> tuple[float, str]:
    """B4's gradient at its own count (``kernels/wkv/kernel.py``
    ``backward_cost``), all f32."""
    from repro_torch.kernels.wkv.kernel import backward_cost

    return bound_of(*backward_cost(b, h, s, d), PEAK_F32_FLOPS)


def mesh_gather_calls(cfg) -> int:
    """The layer gathers (``parallel/sharding.py`` ``LayerShards.gather``)
    of one mesh train step of ``cfg``, as the code gives them: each of
    ``accum`` microbatches gathers the leaves outside the layer loops once,
    and each unit of the loops (a layer, an encoder layer, a hybrid group
    or tail layer) once in its forward and once more in remat's
    recompute. On a 1x1 mesh each is the state's own storage: no byte is
    copied and no collective runs."""
    from repro_torch.models.transformer import hybrid_groups

    units = (sum(hybrid_groups(cfg)) if cfg.family == "hybrid"
             else cfg.num_layers + (cfg.encoder_layers if cfg.is_encdec
                                    else 0))
    again = 1 if cfg.remat == "none" else 2
    return max(cfg.accum, 1) * (1 + again * units)


# the model-parallel region's collectives on a 1x1 mesh: none, and no
# all-gather or reduce-scatter of a sequence split (``parallel/sharding.py``
# ``MODEL``; a model axis of one rank opens no region and splits no
# sequence)
NO_REGION = {"all_reduces": 0, "bytes": 0, "all_gathers": 0,
             "gathered_bytes": 0, "reduce_scatters": 0, "scattered_bytes": 0}


def gather_held(counts: dict, cfg, steps: int) -> bool:
    """A 1x1 mesh's gathers over ``steps`` train steps: the code's calls,
    no byte copied, no collective."""
    return counts == {"calls": steps * mesh_gather_calls(cfg),
                      "bytes_copied": 0, "all_gathers": 0, "reductions": 0,
                      "reduce_scatters": 0, "all_reduces": 0}


def reset_all_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets ``t_s``, the seconds since
    the run started, so every stretch of the run is accounted for."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def smi(query: str) -> list[str]:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    out = subprocess.run([exe, f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def random_state(grid, seed, device):
    """Nontrivial coefficients from a numpy seed, as the reference's
    nontrivial-coefficient kernel test draws them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    arrs = dict(
        p=rng.uniform(size=grid), a=rng.uniform(size=(4,) + grid),
        b=rng.uniform(size=(3,) + grid) * 0.1, c=rng.uniform(size=(3,) + grid),
        bnd=(rng.uniform(size=grid) > 0.5), wrk1=rng.uniform(size=grid) * 0.01)
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for k, v in arrs.items()}


def atol(change, base=None) -> float:
    """Absolute tolerance for a result that the plain version computes as
    ``base + change`` (ss alone has no base): P_ATOL, tightened to SS_RTOL
    of the largest |change| plus 4 ulp of the largest |base|, the rounding of
    the sum. Under ``himeno_init`` every interior ss is 1/(3*255^2), about
    5e-6, so a kernel that wrote no ss, or wrote it at the wrong points,
    would pass a bare 1e-5."""
    import torch

    tol = SS_RTOL * float(change.abs().max())
    if base is not None:
        tol += 4 * torch.finfo(torch.float32).eps * float(base.abs().max())
    return min(P_ATOL, tol)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of ``fn`` a call: its kernels' own times summed under
    torch.profiler over ``reps`` calls after one warm-up call, so host gaps
    between its launches do not count (a library call driven through
    autograd is host-paced, and CUDA events around it time the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0)
                or getattr(e, "self_cuda_time_total", 0.0)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.key != "Command Buffer Full")
    return total / 1e3 / reps


def bound_ms(grid, entry: str) -> float:
    """Least time for one launch: 13 f32 arrays read once, one written once
    (p_new, or the interior ss), and 34 FLOP an interior point for the sweep
    (32 for the stencil, which skips the update)."""
    from repro_torch.kernels.himeno.ref import FLOPS_PER_POINT

    i, j, k = grid
    pts, interior = i * j * k, (i - 2) * (j - 2) * (k - 2)
    out = pts if entry == "himeno_sweep" else interior
    flops = (FLOPS_PER_POINT if entry == "himeno_sweep"
             else FLOPS_PER_POINT - 2) * interior
    nbytes = 4 * (13 * pts + out)
    return 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS)



def rms_bound_ms(shape, dtype_bytes: int) -> tuple[float, str]:
    """B2 at its own count (``kernels/rmsnorm/kernel.py`` ``cost``), f32
    operations."""
    from repro_torch.kernels.rmsnorm.kernel import cost

    return bound_of(*cost(shape, dtype_bytes), PEAK_F32_FLOPS)


def rms_grad_bound_ms(shape, dtype_bytes: int) -> tuple[float, str]:
    """B2's gradient at its own count (``backward_cost``)."""
    from repro_torch.kernels.rmsnorm.kernel import backward_cost

    return bound_of(*backward_cost(shape, dtype_bytes), PEAK_F32_FLOPS)


def flash_peak(dtype_bytes: int) -> float:
    return PEAK_BF16_FLOPS if dtype_bytes == 2 else PEAK_F32_FLOPS


def flash_bound_ms(b, h, kh, s, d, dtype_bytes, causal, window
                   ) -> tuple[float, str]:
    """B3 over S rows against S keys at its own count
    (``kernels/flash_attention/kernel.py`` ``cost``: the pairs the mask
    lets through) at the peak for the inputs' type."""
    from repro_torch.kernels.flash_attention.kernel import cost

    return bound_of(*cost(b, h, kh, s, s, d, dtype_bytes, causal, window),
                    flash_peak(dtype_bytes))


def flash_offset_bound_ms(b, h, kh, sq, sk, d, dtype_bytes, offset
                          ) -> tuple[float, str]:
    """B3 over q's Sq rows at ``offset`` against Sk keys, causal, at its
    own count (``cost``: query row i sees offset + i + 1 keys; of k and v
    the offset + Sq rows any query sees)."""
    from repro_torch.kernels.flash_attention.kernel import cost

    return bound_of(*cost(b, h, kh, sq, sk, d, dtype_bytes, True, 0,
                          offset), flash_peak(dtype_bytes))


def sdpa_backend(call, candidates) -> str:
    """The backend SDPA picks for ``call`` (no arguments; it runs
    ``F.scaled_dot_product_attention`` as the caller times it): the one of
    ``candidates`` (``SDPBackend`` members) whose output, run alone, equals
    the call's bit for bit, each forward being deterministic; "unknown"
    if none does. No profiler: its first start-up alone takes seconds."""
    from torch.nn.attention import sdpa_kernel

    want = call()
    for backend in candidates:
        try:
            with sdpa_kernel([backend]):
                got = call()
        except RuntimeError:  # this backend does not take the call
            continue
        if got.shape == want.shape and bool((got == want).all()):
            return backend.name.lower()
    return "unknown"


def flash_backward_bound_ms(b, h, kh, s, d, dtype_bytes, causal, window
                            ) -> tuple[float, str]:
    """B3's gradient at its own count (``backward_cost``: four products
    over the pairs the mask lets through)."""
    from repro_torch.kernels.flash_attention.kernel import backward_cost

    return bound_of(*backward_cost(b, h, kh, s, d, dtype_bytes, causal,
                                   window), flash_peak(dtype_bytes))


def wkv_bound_ms(b, h, s, d, state: bool) -> tuple[float, str]:
    """B4 at its own count (``kernels/wkv/kernel.py`` ``cost``), f32."""
    from repro_torch.kernels.wkv.kernel import cost

    return bound_of(*cost(b, h, s, d, state), PEAK_F32_FLOPS)


def shift_rwkv(cfg, model, seed: int = 7) -> None:
    """Weights under which every part of the RWKV state reaches the logits.
    Random init leaves the token-shift mixes and the bonus at 0 and the
    log-decays near -1, so the bf16 tm_x/cm_x carried by decode never
    count and the WKV state forgets within a few tokens. Draw mu, mu_c,
    bonus_u and ln_wkv from a numpy seed and move decay_base to about -4
    (decays near 0.98 a step), as tests/test_torch_rwkv_model.py does: the
    same draws over the stacked (L, ...) leaves, in the same order."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    tms = [layer["tm"] for layer in model.layers]
    draws = (("mu", lambda sh: rng.uniform(0, 1, sh)),
             ("mu_c", lambda sh: rng.uniform(0, 1, sh)),
             ("bonus_u", lambda sh: rng.standard_normal(sh) * 0.5),
             ("ln_wkv", lambda sh: rng.uniform(0.5, 1.5, sh)),
             ("decay_base", lambda sh: rng.uniform(-4.5, -3.5, sh)))
    with torch.no_grad():
        for name, draw in draws:
            stacked = draw((cfg.num_layers, *tms[0][name].shape))
            for tm, leaf in zip(tms, stacked.astype(np.float32)):
                tm[name].copy_(torch.from_numpy(leaf))


def bf16_ulp(y):
    """One bf16 ulp at |y| (8 significant bits)."""
    import torch

    mag = y.abs().float().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def leaf_errs(got, want) -> dict:
    """Each leaf's max |got - want| over its max |want|, by path; ``got``
    a list of leaves, ``want`` a ``flatten``ed tree in the same order."""
    return {"/".join(map(str, path)): float(
        (a.float() - b).abs().max() / b.abs().max().clamp_min(1e-30))
        for a, (path, b) in zip(got, want)}


def nudged_embedding(params):
    """A context in which ``params``' embedding table sits one f32 ulp
    away, up or down at random (seeded): an input change of the size of
    the rounding the kernels change."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def nudged():
        embed = params["embedding"]["embed"]
        kept = embed.clone()
        gen = torch.Generator(device=embed.device).manual_seed(0)
        up = torch.rand(embed.shape, generator=gen, device=embed.device) < 0.5
        with torch.no_grad():
            embed.copy_(torch.nextafter(embed, torch.where(
                up, torch.inf, -torch.inf).to(embed.dtype)))
        try:
            yield
        finally:
            with torch.no_grad():
                embed.copy_(kept)

    return nudged()


def timed_pair(kernel_fn, plain_fn, reps: int, library_fn=None,
               plain_reps=None, ops_fn=None) -> dict:
    """plain, ops, library, kernel, kernel, library, ops, plain: the better
    of two means each (the library call and ``ops_fn``, the PyTorch ops a
    kernel took the place of, only where given); the plain version and the
    ops over ``plain_reps`` calls (default a quarter of ``reps``, at least
    2)."""
    plain_reps = plain_reps or max(2, reps // 4)
    pl1 = time_ms(plain_fn, plain_reps)
    ops1 = time_ms(ops_fn, plain_reps) if ops_fn else None
    lib1 = time_ms(library_fn, reps) if library_fn else None
    k1 = time_ms(kernel_fn, reps)
    k2 = time_ms(kernel_fn, reps)
    lib2 = time_ms(library_fn, reps) if library_fn else None
    ops2 = time_ms(ops_fn, plain_reps) if ops_fn else None
    pl2 = time_ms(plain_fn, plain_reps)
    out = {"ms": min(k1, k2), "ms_runs": [k1, k2], "plain_ms": min(pl1, pl2),
           "plain_ms_runs": [pl1, pl2], "library_ms": None}
    if library_fn:
        out.update(library_ms=min(lib1, lib2), library_ms_runs=[lib1, lib2])
    if ops_fn:
        out.update(ops_ms=min(ops1, ops2), ops_ms_runs=[ops1, ops2])
    return out


def host_us(steps: dict) -> dict:
    """Each step's µs a call by ``time.perf_counter`` over HOST_CALLS calls
    after 100 to warm up, synchronised at the end, so a step that launches
    counts until its kernels ran."""
    import torch

    us = {}
    for name, step in steps.items():
        for _ in range(100):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            step()
        torch.cuda.synchronize()
        us[name] = 1e6 * (time.perf_counter() - t0) / HOST_CALLS
    return us


class HeldRouting:
    """Holds an MoE model's routing fixed between two runs, as teacher
    forcing holds the tokens. Inside ``with``, ``models.moe.route`` is
    patched: while recording, each call's expert ids and router
    probabilities are kept; after ``hold(forced)``, call i routes to the
    ids of ``forced(i)`` (a recorded (ids, probs) pair, or a slice of one)
    with weights from its own probabilities of those experts, normalised
    as ``route`` does. A random-init MoE at full width sends a token to
    another expert wherever its router sits at a near-tie that a bf16-sized
    change of its input crosses, and that token's logits then move by up
    to their whole size, so the two runs are compared on the same experts.
    ``stats`` counts the tokens whose own choice differed from the held one
    and the largest gap between the two runs' router probabilities."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.route = moe, moe.route
        self.record()

    def __enter__(self):
        self.moe.route = self._route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def record(self):
        self.recorded, self.forced = [], None

    def hold(self, forced):
        self.forced, self.calls = forced, 0
        self.flipped = self.tokens = 0
        self.prob_gap = 0.0

    def stats(self) -> dict:
        return {"held_calls": self.calls, "tokens_routed_otherwise":
                self.flipped, "tokens": self.tokens,
                "max_router_prob_gap": self.prob_gap}

    def _route(self, cfg, p, x):
        import torch

        w, ids, aux = self.route(cfg, p, x)
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        if self.forced is None:
            self.recorded.append((ids, probs))
            return w, ids, aux
        held, held_probs = self.forced(self.calls)
        self.calls += 1
        same = (ids.sort(-1).values == held.sort(-1).values).all(-1)
        self.flipped += int((~same).sum())
        self.tokens += same.numel()
        self.prob_gap = max(self.prob_gap,
                            float((probs - held_probs).abs().max()))
        w = probs.gather(-1, held)
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
        return w.to(x.dtype), held, aux


def held_routing(cfg):
    """A ``HeldRouting`` for an MoE config, a context that does nothing for
    the others (``routing`` is then None)."""
    import contextlib

    return HeldRouting() if cfg.num_experts else contextlib.nullcontext()


def check_batch(cfg):
    """The model checks' inputs, 2 x CHECK_SEQ positions from numpy seed 1:
    tokens alone, or with a frontend ``synthetic_batch``'s (enc-dec: as many
    frames as tokens; VLM: ``batch_structure``'s patches in front of the
    rest of the tokens), embeddings in bf16."""
    import numpy as np
    import torch
    from repro_torch import models as M
    from repro_torch.configs import ShapeSpec

    if cfg.frontend != "none":
        return M.synthetic_batch(cfg, ShapeSpec("check", "prefill", CHECK_SEQ,
                                                2), seed=1, device="cuda")
    return {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, CHECK_SEQ), dtype=np.int32)).cuda()}


def kernel_vs_plain(cfg, model, batch, module, attr, plain, baseline=None,
                    routing=None):
    """The forward's logits on ``batch`` through the kernel (or, if given,
    with ``module.attr`` patched to ``baseline``), and their distance from
    the same forward with ``module.attr`` patched to ``plain``, as a share
    of the plain forward's max |logits|. With ``routing`` (a
    ``HeldRouting``), the second forward routes as the first did."""
    from repro_torch import models as M

    kernel_fn = getattr(module, attr)
    setattr(module, attr, baseline or kernel_fn)
    try:
        if routing is not None:
            routing.record()
        full, _ = M.forward(cfg, model, batch)
        setattr(module, attr, plain)
        if routing is not None:
            routing.hold(routing.recorded.__getitem__)
        plain_logits, _ = M.forward(cfg, model, batch)
    finally:
        setattr(module, attr, kernel_fn)
    rel = float((full - plain_logits).abs().max() / plain_logits.abs().max())
    return full, rel


@functools.lru_cache(maxsize=None)
def plain_wkv_fn():
    """B4's plain versions as an ``autograd.Function``: ``wkv_ref`` forward,
    ``wkv_backward_ref`` backward (``wkv_backward_check`` holds the latter
    to autograd through the former on the card). Autograd through
    ``wkv_ref`` itself walks ~10 nodes a token, and took 148 s for the two
    plain runs of rwkv6-1.6b's bf16 check at 24 layers."""
    import torch
    from repro_torch.kernels.wkv import wkv_ref
    from repro_torch.kernels.wkv.ref import wkv_backward_ref

    class PlainWkvFn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, lw, u):
            ctx.set_materialize_grads(False)
            ctx.save_for_backward(r, k, v, lw, u)
            return wkv_ref(r, k, v, lw, u)

        @staticmethod
        def backward(ctx, dout, dfinal):
            if dfinal is not None:
                raise NotImplementedError("no gradient of the final state")
            return wkv_backward_ref(*ctx.saved_tensors, dout.float())

    return PlainWkvFn


def plain_training():
    """A context in which the LM's RMSNorm, attention and WKV run their
    plain versions (``rms_norm_ref``, ``attention_ref``, ``wkv_ref`` with
    ``wkv_backward_ref``), so that autograd differentiates them in place of
    the kernels' backwards."""
    import contextlib

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.rmsnorm import rms_norm_ref
    from repro_torch.models import attention as attn
    from repro_torch.models import layers
    from repro_torch.models import rwkv

    @contextlib.contextmanager
    def patched():
        rms, flash, wkv = layers._rms_norm_op, attn.flash_attention, rwkv.wkv
        layers._rms_norm_op = lambda x, scale, eps: rms_norm_ref(x, scale,
                                                                 eps)
        attn.flash_attention = \
            lambda q, k, v, causal, window, q_offset=0: attention_ref(
                q, k, v, causal=causal, window=window, q_offset=q_offset)
        rwkv.wkv = lambda r, k, v, lw, u, state=None, chunk=64: \
            plain_wkv_fn().apply(r, k, v, lw, u)
        try:
            yield
        finally:
            layers._rms_norm_op, attn.flash_attention, rwkv.wkv = \
                rms, flash, wkv

    return patched()


def attention_per_step(n: int) -> dict:
    """The dense and MoE paths' launches a decode step at n layers: ln1
    and ln2 a layer and the final norm; no B3, since decode attention is
    PyTorch ops."""
    return {"rms_norm": 2 * n + 1, "flash_attention": 0,
            "flash_attention_tc": 0, "wkv": 0, "wkv_tc": 0}


def rwkv_per_step(n: int) -> dict:
    """The RWKV path's launches a decode step at n layers: every WKV on
    the sequential kernel."""
    return {"rms_norm": 2 * n + 1, "flash_attention": 0,
            "flash_attention_tc": 0, "wkv": n, "wkv_tc": 0}


def first_layers(cfg, model, layers: int):
    """(config, model) of ``model``'s first ``layers`` layers: a shallow
    copy whose layer list is a slice of the model's, sharing every weight,
    so a cut run of a 70 GB model needs no second copy of it. A hybrid's
    cut keeps its first groups and the first layers of its tail, as many
    as ``hybrid_groups`` gives the cut config."""
    import copy
    import dataclasses

    from repro_torch.models.transformer import hybrid_groups

    cut = copy.copy(model)
    cut._modules = dict(model._modules)  # the copy's own module table
    cut.cfg = dataclasses.replace(cfg, num_layers=layers)
    if cfg.family == "hybrid":
        groups, tail = hybrid_groups(cut.cfg)
        cut.groups = model.groups[:groups]
        cut.tail = model.tail[:tail]
    else:
        cut.layers = model.layers[:layers]
    return cut.cfg, cut


def metered(fn):
    """Run ``fn`` under the port's EnergyMeter over the machine's counters;
    returns (result, seconds, GPU Watt·s, trace samples)."""
    import torch
    from repro_torch.telemetry import (CounterSampler, EnergyMeter,
                                       trapezoid_ws)

    meter = EnergyMeter(CounterSampler(), hz=20.0)
    with meter:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    trace = meter.reading.trace
    return out, seconds, trapezoid_ws(trace, domains=("gpu",)), len(trace)

class Smoke:
    def __init__(self):
        self.failures: list[str] = []
        self.card = ""
        self.kernels: dict[str, dict] = {}
        self.path_launches: dict[str, dict[str, int]] = {}  # path -> counts
        self.serve_out: dict[str, dict] = {}  # arch -> its serve phase

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)

    # -- phase 0 + 1 -----------------------------------------------------
    def card_and_build(self):
        import torch
        from repro_torch.kernels._build import BASE_FLAGS, build_all

        lines = smi("name,power.limit")
        self.card = lines[0] if lines else "not read"
        emit({"phase": "card", "card": self.card,
              "nvidia_smi_gpus": len(lines),
              "torch_device": torch.cuda.get_device_name(0),
              "torch_device_count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})
        # every kernel of the port, one nvcc each, all started together;
        # B4 also with its phase counters, for the wkv_cycles phase
        from repro_torch.kernels.wkv import cycles

        libraries = [mod.LIBRARY for mod in kernel_modules()] + [
            cycles.LIBRARY]
        t0 = time.perf_counter()
        seconds = build_all(libraries)
        for lib in libraries:
            lib.load()
        total = time.perf_counter() - t0
        # registers, shared and local memory of each kernel, from the binary
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        for lib in libraries:
            path = lib.path()
            usage = subprocess.run([cuobjdump, "--dump-resource-usage",
                                    str(path)], capture_output=True,
                                   text=True, timeout=60)
            emit({"phase": "build", "kernel": lib.prefix,
                  "flags": " ".join(lib.flags[len(BASE_FLAGS):]),
                  "seconds": seconds[path.name], "library": path.name,
                  "resource_usage": [ln.strip() for ln in
                                     usage.stdout.splitlines()
                                     if "REG:" in ln]})
        emit({"phase": "build_all", "seconds": total,
              "libraries": len(libraries)})

    # -- phase 2: kernels against their plain versions -------------------
    def compare(self, label, st, *, timed=False):
        import torch
        from repro_torch.kernels.himeno import (
            himeno_stencil, himeno_sweep, jacobi_ref, stencil_parts_ref)

        args = [st[k] for k in ARGS]
        grid = tuple(st["p"].shape)
        p_k, g_k = himeno_sweep(*args, omega=OMEGA)
        g_k2 = himeno_sweep(*args, omega=OMEGA)[1]
        p_r, g_r = jacobi_ref(*args, omega=OMEGA)
        ss_k, parts_k = himeno_stencil(*args)
        ss_r, parts_r = stencil_parts_ref(*args)
        torch.cuda.synchronize()
        tol = {"himeno_sweep": atol(OMEGA * ss_r, st["p"]),
               "himeno_stencil": atol(ss_r)}
        rel = lambda x, y: abs(float(x) - float(y)) / max(abs(float(y)),
                                                           1e-30)
        res = {
            "himeno_sweep": {"max_abs_err": float((p_k - p_r).abs().max()),
                             "gosa_rel_err": rel(g_k, g_r)},
            "himeno_stencil": {"max_abs_err": float((ss_k - ss_r).abs().max()),
                               "gosa_rel_err": rel(parts_k.sum(),
                                                   parts_r.sum())},
        }
        self.check(torch.equal(g_k, g_k2), f"{label}: gosa not repeatable")
        for name, r in res.items():
            self.check(r["max_abs_err"] <= tol[name],
                       f"{label} {name}: max_abs_err {r['max_abs_err']} > "
                       f"{tol[name]}")
            self.check(r["gosa_rel_err"] <= GOSA_RTOL,
                       f"{label} {name}: gosa_rel_err {r['gosa_rel_err']}")
        if timed:
            reps = REPS
            kern = {"himeno_sweep": lambda: himeno_sweep(*args),
                    "himeno_stencil": lambda: himeno_stencil(*args)}
            plain = {"himeno_sweep": lambda: jacobi_ref(*args),
                     "himeno_stencil": lambda: stencil_parts_ref(*args)}
            for name in res:
                # plain, kernel, kernel, plain: compare within one call
                pl1 = time_ms(plain[name], max(2, reps // 4))
                k1 = time_ms(kern[name], reps)
                k2 = time_ms(kern[name], reps)
                pl2 = time_ms(plain[name], max(2, reps // 4))
                res[name].update(ms=min(k1, k2), ms_runs=[k1, k2],
                                 plain_ms=min(pl1, pl2),
                                 plain_ms_runs=[pl1, pl2],
                                 bound_ms=bound_ms(grid, name))
        emit({"phase": "kernel", "grid": list(grid), "inputs": label,
              "tolerance": {"p_atol": tol["himeno_sweep"],
                            "ss_atol": tol["himeno_stencil"],
                            "gosa_rtol": GOSA_RTOL},
              "card": self.card, **res})
        return res

    def kernel_phase(self):
        import torch
        from repro_torch.configs.himeno import GRIDS
        from repro_torch.kernels.himeno import himeno_init

        errs = {"himeno_sweep": 0.0, "himeno_stencil": 0.0}
        # two ragged grids and the main path's L grid with numpy-seeded
        # coefficients (b, bnd and wrk1 all vary), then L as the main path
        # initialises it, which is also where the kernels are timed
        for grid, seed in (((7, 9, 17), 0), ((61, 83, 150), 1),
                           (GRIDS["L"], 2)):
            st = random_state(grid, seed, "cuda")
            res = self.compare(f"numpy seed {seed}", st)
            del st
            for name in errs:
                errs[name] = max(errs[name], res[name]["max_abs_err"])
        torch.cuda.empty_cache()
        st = himeno_init(GRIDS["L"], device="cuda")
        res = self.compare("himeno_init", st, timed=True)
        del st
        torch.cuda.empty_cache()
        for name, r in res.items():
            self.kernels[name] = {
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES, "launches": 0,
                "max_abs_err": max(errs[name], r["max_abs_err"]),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "shape": list(GRIDS["L"]),
                "card": self.card}

    # -- phase 8: the paper loop's main path -----------------------------
    def main_path(self):
        import torch
        from repro_torch.apps.himeno_app import (
            LOOP_UNITS, UNIT_NAMES, HimenoApp)
        from repro_torch.configs.himeno import GRIDS
        from repro_torch.core.ga import GAConfig
        from repro_torch.core.offload_search import search_himeno
        from repro_torch.core.verifier import HimenoMeasuredBackend
        from repro_torch.kernels.himeno import (
            himeno_init, himeno_run, himeno_stencil, kernel)
        from repro_torch.telemetry import MeteredBackend

        L = GRIDS["L"]
        all_cpu = tuple(0 for _ in UNIT_NAMES)
        paper = tuple(int(u in LOOP_UNITS) for u in UNIT_NAMES)

        reset_all_launches()
        # 1. the solver entry
        t0 = time.perf_counter()
        st = himeno_init(L, device="cuda")
        p_run, g_run = himeno_run(st, SOLVER_ITERS)
        torch.cuda.synchronize()
        solver_s = time.perf_counter() - t0

        # 2. Fig. 5 through the metered measured backend
        # The backend warms both placements up once when it is built (the
        # CUDA context, B1's library): one sweep each does that, where the
        # 62 of a run took 110-144 s of the smoke; the runs then sweep 62
        t0 = time.perf_counter()
        app = HimenoApp(grid=L, iters=FIG5_WARMUP_ITERS)
        fig5 = MeteredBackend.auto(HimenoMeasuredBackend(app,
                                                         budget_s=BUDGET_S))
        app.iters = FIG5_ITERS
        warm_s = time.perf_counter() - t0
        domains = fig5.sampler.domains() if fig5.sampler else ()
        runs = {}
        for label, bits in (("all_cpu", all_cpu), ("loop_units", paper)):
            before = himeno_stencil.launches
            m = fig5.measure_bits(bits)
            launched = himeno_stencil.launches - before
            runs[label] = m
            met = m.detail["metered"]
            emit({"phase": "fig5", "placement": label, "grid": list(L),
                  "iters": FIG5_ITERS, "time_s": m.time_s,
                  "t_device_s": m.detail["t_device"],
                  "modeled_ws": met["modeled_ws"],
                  "metered_ws": met["metered_ws"], "avg_watts": m.avg_watts,
                  "trace_source": met["trace_source"],
                  "trace_samples": met["trace_samples"],
                  "domains": list(domains), "timed_out": m.timed_out,
                  "gosa": m.detail.get("gosa"),
                  "final_residual": m.detail.get("final_residual"),
                  "stencil_launches": launched, "card": self.card})
            self.check(not m.timed_out, f"fig5 {label} truncated")
            # the card's placement goes through B1 once a sweep, and the
            # all-CPU placement never launches it
            self.check(launched == (FIG5_ITERS if label == "loop_units"
                                    else 0),
                       f"fig5 {label}: {launched} stencil launches")
        cpu, gpu = runs["all_cpu"], runs["loop_units"]
        if not (cpu.timed_out or gpu.timed_out):
            for key in ("gosa", "final_residual"):
                x, y = gpu.detail[key], cpu.detail[key]
                self.check(abs(x - y) <= GOSA_RTOL * abs(y),
                           f"fig5 {key}: {x} on the card vs {y} on the host")
        emit({"phase": "fig5_summary", "warmup_s": warm_s,
              "warmup_iters": FIG5_WARMUP_ITERS,
              "metered_ratio": (gpu.energy_ws / cpu.energy_ws
                                if cpu.energy_ws else None),
              "time_ratio": gpu.time_s / cpu.time_s,
              "smi_gpus_summed": len(smi("name")), "card": self.card})

        # 3. the GA over the metered measured backend, at L
        t0 = time.perf_counter()
        ga_backend = MeteredBackend.auto(HimenoMeasuredBackend(
            HimenoApp(grid=L, iters=GA_ITERS), budget_s=BUDGET_S))
        res = search_himeno(ga_backend, GAConfig(population=6, generations=4,
                                                 seed=0))
        ga_s = time.perf_counter() - t0
        # the all-CPU genome seeds the GA's first generation
        base = next(r.measurement for r in res.history[0]
                    if r.genome == all_cpu)
        best = res.best.measurement
        emit({"phase": "ga", "grid": list(L), "iters": GA_ITERS,
              "cut": f"{GA_ITERS} sweeps a measurement (Fig. 5 and the "
                     f"paper: {FIG5_ITERS}), so that up to 24 measurements, "
                     "all-CPU ones at about 2 s of NumPy a sweep, fit the "
                     f"smoke's limit of {SMOKE_LIMIT_S} s",
              "best_genome": list(res.best.genome),
              "best_units_on_card": [u for u, b in zip(UNIT_NAMES,
                                                       res.best.genome) if b],
              "best_time_s": best.time_s, "best_metered_ws": best.energy_ws,
              "all_cpu_time_s": base.time_s,
              "all_cpu_metered_ws": base.energy_ws,
              "evaluations": res.evaluations, "cache_hits": res.cache_hits,
              "seconds": ga_s, "card": self.card})
        self.check(res.evaluations > 0, "GA measured nothing")

        launches = {f.__name__: f.launches for f in kernel.WRAPPERS}
        for name, n in launches.items():
            self.kernels[name]["launches"] = n
            self.check(n > 0, f"{name} never launched on the main path")

        # the solver's result against the plain version, after the window
        p_ref, g_ref = himeno_run(st, SOLVER_ITERS, impl="ref")
        err = float((p_run - p_ref).abs().max())
        grel = abs(float(g_run) - float(g_ref)) / abs(float(g_ref))
        p_tol = atol(p_ref - st["p"], st["p"])
        self.check(err <= p_tol and grel <= GOSA_RTOL,
                   f"himeno_run: p err {err}, gosa rel err {grel}")
        self.check(bool(torch.isfinite(p_run).all()), "himeno_run not finite")
        emit({"phase": "solver", "grid": list(L), "iters": SOLVER_ITERS,
              "seconds": solver_s, "gosa": float(g_run),
              "max_abs_err": err, "p_atol": p_tol, "gosa_rel_err": grel,
              "card": self.card})


    # -- phase 4: B2 and B3 against their plain versions -----------------
    def dense_kernel_phase(self):
        import numpy as np
        import torch
        import torch.nn.functional as F
        from repro_torch.kernels.flash_attention import (
            attention_ref, flash_attention_cuda)
        from repro_torch.kernels.flash_attention.kernel import kernel_for
        from repro_torch.kernels.flash_attention.ref import bf16_error_bound
        from repro_torch.kernels.rmsnorm import rms_norm_cuda, rms_norm_ref

        dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
        rng = np.random.default_rng(0)
        rows = {}
        for shape, dt in RMS_SHAPES:
            x = torch.from_numpy((rng.standard_normal(shape) * 2).astype(
                np.float32)).to("cuda", dtypes[dt])
            scale = torch.from_numpy(rng.uniform(
                0.5, 1.5, shape[-1]).astype(np.float32)).cuda()
            y, ref = rms_norm_cuda(x, scale), rms_norm_ref(x, scale)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs()
            if dt == "float32":
                tol, ok = F32_ATOL, float(err.max()) <= F32_ATOL
            else:
                tol, ok = "one bf16 ulp of |y|", bool((err <= bf16_ulp(
                    ref)).all())
            label = f"rms_norm {list(shape)} {dt}"
            self.check(ok, f"{label}: max_abs_err {float(err.max())}")
            self.check(torch.equal(y, rms_norm_cuda(x, scale)),
                       f"{label}: not repeatable")
            row = {"shape": list(shape), "dtype": dt,
                   "max_abs_err": float(err.max()), "tolerance": tol}
            weight = scale.to(x.dtype)  # the library call takes one dtype
            row["reps"] = REPS * (2 if (shape, dt) == RMS_REMEASURE else 1)
            row.update(timed_pair(
                lambda: rms_norm_cuda(x, scale),
                lambda: rms_norm_ref(x, scale), row["reps"],
                lambda: F.rms_norm(x, (shape[-1],), weight, 1e-5)))
            row["bound_ms"], row["bound_by"] = rms_bound_ms(
                shape, x.element_size())
            emit({"phase": "kernel", "kernel": "rms_norm", **row,
                  "card": self.card})
            rows[("rms_norm", shape)] = row
        for b, h, kh, s, d, dt, causal, window in FLASH_SHAPES:
            def draw(heads):
                return torch.from_numpy(rng.standard_normal(
                    (b, heads, s, d)).astype(np.float32)).to("cuda",
                                                             dtypes[dt])
            q, k, v = draw(h), draw(kh), draw(kh)
            which = kernel_for(q.dtype, d)
            n_tc = flash_attention_cuda.launches_tc
            o = flash_attention_cuda(q, k, v, causal=causal, window=window)
            ref = attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = float((o.float() - ref.float()).abs().max())
            tol = F32_ATOL if dt == "float32" else FLASH_BF16_ATOL
            label = f"flash_attention {[b, h, kh, s, d]} {dt}"
            self.check(err <= tol, f"{label}: max_abs_err {err} > {tol}")
            self.check(flash_attention_cuda.launches_tc - n_tc
                       == (which == "tensor_core"),
                       f"{label}: not launched on the {which} kernel")
            self.check(torch.equal(o, flash_attention_cuda(
                q, k, v, causal=causal, window=window)),
                f"{label}: not repeatable")
            row = {"shape": [b, h, s, d], "kv_heads": kh, "dtype": dt,
                   "causal": causal, "window": window, "kernel": which,
                   "max_abs_err": err, "tolerance": tol}
            if dt == "bfloat16":
                # the tile-sensitive check: each element within the bound
                # that P's and o's rounding to bf16 allows
                o32, bound = bf16_error_bound(q, k, v, causal=causal,
                                              window=window)
                dev = (o.float() - o32).abs()
                share = float(dev.max() / o32.abs().max())
                worst = float((dev / bound).max())
                self.check(worst <= 1.0, f"{label}: |o - o32| reaches {worst} "
                                         "of its bf16 rounding bound")
                row.update(err_vs_f32_over_max=share,
                           err_vs_f32_over_bound=worst,
                           bound_over_max=float(bound.max()
                                                / o32.abs().max()))
                del o32, bound, dev
            del o, ref
            # the library call: causal, or with the window's mask where the
            # window cuts the sequence
            mask = None
            if window and window < s:
                i = torch.arange(s, device="cuda")
                mask = ((i[None, :] <= i[:, None])
                        & (i[None, :] > i[:, None] - window))
            sdpa = functools.partial(
                F.scaled_dot_product_attention, q, k, v, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
            row["library_call"] = (
                "SDPA, boolean window mask" if mask is not None
                else "SDPA, causal" if causal else "SDPA, unmasked")
            row.update(timed_pair(
                lambda: flash_attention_cuda(q, k, v, causal=causal,
                                             window=window),
                lambda: attention_ref(q, k, v, causal=causal, window=window),
                REPS, sdpa))
            row["bound_ms"], row["bound_by"] = flash_bound_ms(
                b, h, kh, s, d, q.element_size(), causal, window)
            if which == "tensor_core":
                # without and with the log-sum-exp that training asks of
                # the forward (FlashAttentionFn): without, with, with,
                # without
                runs = [time_ms(functools.partial(
                    flash_attention_cuda, q, k, v, causal=causal,
                    window=window, return_lse=lse), REPS)
                    for lse in (False, True, True, False)]
                row.update(ms_no_lse=min(runs[0], runs[3]),
                           ms_lse=min(runs[1], runs[2]), lse_runs=runs)
            emit({"phase": "kernel", "kernel": "flash_attention", **row,
                  "card": self.card})
            rows[("flash_attention", (b, h, kh, s, d, dt, causal,
                                      window))] = row
            del q, k, v, mask, sdpa
            torch.cuda.empty_cache()

        # the kernels line: the main path's shapes (prefill; decode beside)
        def entry(name, source, replaces, main, decode=None):
            errs = [r["max_abs_err"] for (n, _), r in rows.items()
                    if n == name]
            out = {"name": name, "route": "cuda", "source": source,
                   "replaces": replaces, "launches": 0,
                   "max_abs_err": max(errs), "ms": main["ms"],
                   "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                   "bound_by": main["bound_by"],
                   "library_ms": main["library_ms"], "shape": main["shape"],
                   "dtype": main["dtype"], "card": self.card}
            if decode is not None:
                out.update({f"decode_{k}": decode[k] for k in (
                    "shape", "ms", "plain_ms", "bound_ms", "library_ms")})
            return out

        keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        # B2 at llama3.2-3b's width (prefill; decode beside), and at
        # zamba2-7b's and mixtral-8x7b's
        self.kernels["rms_norm"] = entry(
            "rms_norm", "src/repro_torch/csrc/rmsnorm.cu",
            "src/repro/kernels/rmsnorm/kernel.py:17",
            rows[("rms_norm", (2, 2048, 3072))],
            rows[("rms_norm", (8, 1, 3072))])
        for width in (3584, 4096, 1024, 2048):
            self.kernels["rms_norm"][f"d{width}"] = {
                **{k: rows[("rms_norm", (2, 2048, width))][k] for k in keys},
                **{f"decode_{k}": rows[("rms_norm", (8, 1, width))][k]
                   for k in ("shape", "ms", "plain_ms", "bound_ms",
                             "library_ms")}}
        # llava-next-mistral-7b's patch norm and the rest of its forward's
        # norms; the serve() decode step of seamless-m4t-medium and llava
        self.kernels["rms_norm"]["patch_norm"] = {
            k: rows[("rms_norm", (2, 2880, 4096))][k] for k in keys}
        self.kernels["rms_norm"]["vlm_forward"] = {
            k: rows[("rms_norm", (2, 5760, 4096))][k] for k in keys}
        self.kernels["rms_norm"]["serve_decode"] = {
            k: rows[("rms_norm", (4, 1, 3072))][k] for k in keys}
        self.kernels["rms_norm"]["fleet_decode"] = {
            k: rows[("rms_norm", (2, 1, 3072))][k] for k in keys}
        for width in (1024, 4096, 2048):
            self.kernels["rms_norm"][f"d{width}"]["serve_decode"] = {
                k: rows[("rms_norm", (4, 1, width))][k] for k in keys}

        # B3: the tensor-core kernel at the dense path's shape, the scalar
        # kernel's time at the same shape in f32 beside it; then both at
        # the hybrid path's head dim 112 and the MoE path's shape, and the
        # tensor-core kernel where mixtral's window cuts the sequence
        def b3(b, h, kh, s, d, window, scalar=True, causal=True):
            tc = rows[("flash_attention",
                       (b, h, kh, s, d, "bfloat16", causal, window))]
            out = {**{k: tc[k] for k in keys + ("ms_no_lse", "ms_lse")},
                   "kv_heads": kh, "causal": causal, "window": window,
                   "kernel": "tensor_core", "max_abs_err": tc["max_abs_err"],
                   "err_vs_f32_over_bound": tc["err_vs_f32_over_bound"]}
            if scalar:
                f32 = rows[("flash_attention",
                            (b, h, kh, s, d, "float32", causal, window))]
                out["scalar_f32"] = {k: f32[k] for k in keys}
            return out

        self.kernels["flash_attention"] = entry(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:23",
            rows[("flash_attention",
                  (2, 24, 8, 2048, 128, "bfloat16", True, 0))])
        dense = b3(2, 24, 8, 2048, 128, 0)
        self.kernels["flash_attention"].update(
            kernel="tensor_core", scalar_f32=dense["scalar_f32"],
            ms_no_lse=dense["ms_no_lse"], ms_lse=dense["ms_lse"],
            d112=b3(2, 32, 32, 2048, 112, 0),
            mixtral=b3(2, 32, 8, 2048, 128, 4096),
            window_cuts=b3(1, 32, 8, 6144, 128, 4096, scalar=False),
            seamless_encoder=b3(2, 16, 16, 2048, 64, 0, causal=False),
            seamless_decoder=b3(2, 16, 16, 2048, 64, 0, scalar=False),
            ragged_unmasked=b3(1, 16, 16, 333, 64, 0, scalar=False,
                               causal=False),
            llava=b3(2, 32, 8, 5760, 128, 0, scalar=False))

    # -- phase 4a: B3 with a query offset (prefill's seq_inner) -----------
    def flash_offset_check(self):
        """B3 at llama3.2-3b's query rows under prefill's ``seq_inner`` on
        the production mesh (FLASH_OFFSET): model rank r's 2,048 rows of
        24 heads at offset r x 2,048 against the whole sequence's 32,768
        keys of 8 heads, causal. At each rank of FLASH_OFFSET the launch
        must equal bit for bit the same rows of one launch over the whole
        sequence (each block does the arithmetic of the whole launch's
        block over the same rows), its plain version within
        FLASH_BF16_ATOL, and every element within ``bf16_error_bound`` at
        the offset (the bound that P's and o's rounding to bf16 allows
        against the f32 attention of the same bf16 values, as
        ``dense_kernel_phase`` holds the whole launches: FLASH_BF16_ATOL
        lies above a typical |o| over 32,768 keys), each run a K/V head at
        a time (the f32 scores of every head at once would be 12.9 GB);
        the scalar kernel in f32 at
        FLASH_OFFSET's ``f32_rank`` within F32_ATOL. Times
        (``timed_pair``): ms a launch, its bound, the plain version's and
        SDPA's (an explicit boolean mask of the rows' causal frontier,
        ``enable_gqa``; the backend it picks named at the first rank,
        ``sdpa_backend``), for each rank and for the whole launch (SDPA
        causal, its math path left out: its scores would not fit). Added
        to the kernels line's B3 entry as ``seq_inner_rows``."""
        import torch
        import torch.nn.functional as F
        from torch.nn.attention import SDPBackend, sdpa_kernel
        from repro_torch.kernels.flash_attention import (
            attention_ref, flash_attention_cuda)
        from repro_torch.kernels.flash_attention.kernel import kernel_for
        from repro_torch.kernels.flash_attention.ref import bf16_error_bound

        fo = FLASH_OFFSET
        b, h, kh, n, d = (fo[k] for k in ("batch", "heads", "kv_heads",
                                          "rows", "head_dim"))
        s = n * fo["model"]
        gen = torch.Generator(device="cuda").manual_seed(0)

        def draw(heads):
            return torch.randn((b, heads, s, d), generator=gen,
                               device="cuda").to(torch.bfloat16)

        def plain(q, k, v, off):  # a K/V head (and its query heads) a call
            grp = h // kh
            return torch.cat([attention_ref(
                q[:, j * grp:(j + 1) * grp], k[:, j:j + 1], v[:, j:j + 1],
                causal=True, q_offset=off) for j in range(kh)], dim=1)

        def launch(q, k, v, off):
            return flash_attention_cuda(q, k, v, causal=True, q_offset=off)

        def over_bound(o, q, k, v, off):
            """The largest |o - o32| / bound over o's elements, a K/V head
            (and its query heads) a call, as ``plain``."""
            grp, worst = h // kh, 0.0
            for j in range(kh):
                hs = slice(j * grp, (j + 1) * grp)
                o32, bound = bf16_error_bound(
                    q[:, hs], k[:, j:j + 1], v[:, j:j + 1], causal=True,
                    q_offset=off)
                worst = max(worst, float(((o[:, hs].float() - o32).abs()
                                          / bound).max()))
                del o32, bound
            return worst

        q_all, k, v = draw(h), draw(kh), draw(kh)
        whole = flash_attention_cuda(q_all, k, v, causal=True)
        out = {"shape": [b, h, n, d], "kv_shape": [b, kh, s, d],
               "dtype": "bfloat16", "causal": True, "ranks": {}}
        backend = None  # SDPA's, named at the first rank
        for r in fo["ranks"]:
            off = r * n
            q = q_all[:, :, off:off + n].contiguous()
            n_tc = flash_attention_cuda.launches_tc
            o = launch(q, k, v, off)
            on_tc = flash_attention_cuda.launches_tc - n_tc == 1
            ref = plain(q, k, v, off)
            torch.cuda.synchronize()
            err = float((o.float() - ref.float()).abs().max())
            same = torch.equal(o, whole[:, :, off:off + n])
            # F32_SLACK counts the worst case of f32 sums over 2,048 keys;
            # over 32,768 the check leans on their roundings not all
            # falling one way (the ratio is recorded)
            worst = over_bound(o, q, k, v, off)
            label = f"flash_offset rank {r} (offset {off})"
            self.check(on_tc, f"{label}: not on the tensor-core kernel")
            self.check(err <= FLASH_BF16_ATOL,
                       f"{label}: max_abs_err {err} > {FLASH_BF16_ATOL}")
            self.check(worst <= 1.0, f"{label}: |o - o32| reaches {worst} "
                                     "of its bf16 rounding bound")
            self.check(same, f"{label}: not the whole launch's rows bit for "
                             f"bit")
            del o, ref
            pos = torch.arange(off, off + n, device="cuda")[:, None]
            mask = torch.arange(s, device="cuda")[None, :] <= pos
            sdpa = functools.partial(F.scaled_dot_product_attention, q, k,
                                     v, attn_mask=mask, enable_gqa=True)
            if backend is None:
                backend = sdpa_backend(sdpa, (
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH))
            row = {"rank": r, "offset": off, "kernel": "tensor_core",
                   "max_abs_err": err, "tolerance": FLASH_BF16_ATOL,
                   "err_vs_f32_over_bound": worst, "bit_equal_whole": same,
                   "library_call": f"SDPA, boolean mask, enable_gqa, "
                                   f"{backend}"}
            row.update(timed_pair(functools.partial(launch, q, k, v, off),
                                  functools.partial(plain, q, k, v, off),
                                  REPS, sdpa, plain_reps=2))
            row["bound_ms"], row["bound_by"] = flash_offset_bound_ms(
                b, h, kh, n, s, d, 2, off)
            if r == fo["f32_rank"]:
                q32, k32, v32 = q.float(), k.float(), v.float()
                n_tc = flash_attention_cuda.launches_tc
                o32 = launch(q32, k32, v32, off)
                ref32 = plain(q32, k32, v32, off)
                torch.cuda.synchronize()
                err32 = float((o32 - ref32).abs().max())
                self.check(kernel_for(torch.float32, d) == "scalar"
                           and flash_attention_cuda.launches_tc == n_tc,
                           f"{label} f32: not on the scalar kernel")
                self.check(err32 <= F32_ATOL, f"{label} f32: max_abs_err "
                                              f"{err32} > {F32_ATOL}")
                bound = flash_offset_bound_ms(b, h, kh, n, s, d, 4, off)
                row["scalar_f32"] = {
                    "max_abs_err": err32, "tolerance": F32_ATOL,
                    "ms": time_ms(functools.partial(launch, q32, k32, v32,
                                                    off), REPS // 4),
                    "bound_ms": bound[0], "bound_by": bound[1]}
                del q32, k32, v32, o32, ref32
            emit({"phase": "flash_offset", **row, "card": self.card})
            out["ranks"][r] = row
            del q, mask, sdpa
            torch.cuda.empty_cache()
        sdpa = functools.partial(F.scaled_dot_product_attention, q_all, k, v,
                                 is_causal=True, enable_gqa=True)
        fused = (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                 SDPBackend.EFFICIENT_ATTENTION)
        with sdpa_kernel(list(fused)):
            try:
                whole_backend = sdpa_backend(sdpa, fused)
                library = time_ms(sdpa, REPS // 4)
            except RuntimeError as e:
                whole_backend, library = f"none: {e}"[:200], None
        bound = flash_bound_ms(b, h, kh, s, d, 2, True, 0)
        out["whole"] = {
            "shape": [b, h, s, d], "ms": time_ms(functools.partial(
                flash_attention_cuda, q_all, k, v, causal=True), REPS // 4),
            "bound_ms": bound[0], "bound_by": bound[1], "plain_ms": None,
            "library_ms": library,
            "library_call": f"SDPA, causal, enable_gqa, {whole_backend}"}
        ends = out["ranks"][max(fo["ranks"])], out["ranks"][min(fo["ranks"])]
        out["imbalance"] = {"ms": ends[0]["ms"] / ends[1]["ms"],
                            "bound": ends[0]["bound_ms"] / ends[1]["bound_ms"]}
        emit({"phase": "flash_offset", "whole": out["whole"],
              "imbalance": out["imbalance"], "card": self.card})
        self.kernels["flash_attention"]["seq_inner_rows"] = out
        del q_all, k, v, whole
        torch.cuda.empty_cache()

    # -- phase 4b: where a B2 launch's host time goes at decode -----------
    def rms_host_path(self):
        """Each step of ``rms_norm_cuda``'s path at the decode shape (8,1,3072)
        bf16 on the card (``host_us``); beside them the whole wrapper and
        ``F.rms_norm``'s call."""
        import numpy as np
        import torch
        import torch.nn.functional as F
        from repro_torch.kernels.rmsnorm import kernel as b2

        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((8, 1, 3072)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, 3072).astype(
            np.float32)).cuda()
        weight = scale.to(x.dtype)
        y = torch.empty_like(x)
        dev = x.get_device()
        fn = b2.LIBRARY.load().rmsnorm_forward
        args = (x.data_ptr(), scale.data_ptr(), y.data_ptr(), 8, 3072, 1e-5,
                1)
        packed = b2._pack(*args)
        stream = torch._C._cuda_getCurrentRawStream(dev)
        steps = {
            # the path as it is, in its order
            "checks": lambda: b2._on_card(x, scale),
            "empty_like": lambda: torch.empty_like(x),
            "data_ptrs_and_alignment": lambda: (
                x.data_ptr() % 16, scale.data_ptr() % 16, y.data_ptr()),
            "device_compare": lambda: dev == torch._C._cuda_getDevice(),
            "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev),
            "pack_arguments": lambda: b2._pack(*args),
            "ctypes_call_and_launch": lambda: fn(packed, stream),
            "launcher": lambda: b2._forward(dev, packed),
            "wrapper": lambda: b2.rms_norm_cuda(x, scale),
            "F.rms_norm": lambda: F.rms_norm(x, (3072,), weight, 1e-5),
        }
        us = host_us(steps)
        self.check(torch.equal(y, b2.rms_norm_cuda(x, scale)),
                   "rms host path: the direct launches disagree")
        emit({"phase": "rms_host_path", "shape": [8, 1, 3072],
              "dtype": "bfloat16", "calls": HOST_CALLS, "us_per_call": us,
              "card": self.card})

    # -- phase 5: B4's two kernels against their plain version ------------
    def wkv_kernel_phase(self):
        """Both B4 kernels at every WKV_CASES entry (each takes head dim 64
        at any S), forced by ``kernel=``, against ``wkv_ref``: out and the
        final state within WKV_RTOL of their max, a given state updated in
        place, a repeat bit for bit; the dispatch's choice checked at each.
        Both timed at the forward's shape in this run, the dispatched
        (sequential) kernel at decode's two batches (8 and 4 slots)."""
        import numpy as np
        import torch
        from repro_torch.kernels.wkv import kernel as b4
        from repro_torch.kernels.wkv import wkv_cuda, wkv_ref

        rng = np.random.default_rng(0)
        rows = {}
        errs = {"sequential": 0.0, "tensor_core": 0.0}
        for shape, lw_range, with_state, model_layout, label in WKV_CASES:
            b, h, s, d = shape

            def seq(draw):
                # the model hands over views of (B, S, H, D) products
                if model_layout:
                    return torch.from_numpy(draw((b, s, h, d)).astype(
                        np.float32)).cuda().transpose(1, 2)
                return torch.from_numpy(draw(shape).astype(np.float32)).cuda()

            r, k, v = (seq(lambda sh: rng.standard_normal(sh) * 0.5)
                       for _ in range(3))
            lw = seq(lambda sh: rng.uniform(*lw_range, sh))
            u = torch.from_numpy((rng.standard_normal((h, d)) * 0.5).astype(
                np.float32)).cuda()
            st = (torch.from_numpy(rng.standard_normal((b, h, d, d)).astype(
                np.float32)).cuda() if with_state else None)
            ref, ref_final = wkv_ref(r, k, v, lw, u, st)
            torch.cuda.synchronize()
            row = {"shape": list(shape), "case": label, "state": with_state,
                   "model_layout": model_layout, "lw_range": list(lw_range),
                   "dispatch": b4.kernel_for(s, d), "tolerance": WKV_RTOL,
                   "max_abs_out": float(ref.abs().max()),
                   "max_abs_state": float(ref_final.abs().max())}
            for kernel in errs:
                def run(kernel=kernel):
                    # a copy, updated in place as in a decode step
                    buf = None if st is None else st.clone()
                    out, final = wkv_cuda(r, k, v, lw, u, buf, kernel=kernel)
                    return out, final, buf

                out, final, buf = run()
                again, again_final, _ = run()
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                rel = err / float(ref.abs().max())
                s_rel = float((final - ref_final).abs().max()) / float(
                    ref_final.abs().max())
                what = f"wkv {kernel} {label} {list(shape)}"
                self.check(rel <= WKV_RTOL and s_rel <= WKV_RTOL,
                           f"{what}: out {rel}, state {s_rel} of max, limit "
                           f"{WKV_RTOL}")
                self.check(torch.equal(out, again) and
                           torch.equal(final, again_final),
                           f"{what}: not repeatable")
                self.check(buf is None or final.data_ptr() == buf.data_ptr(),
                           f"{what}: the state not updated in place")
                row[kernel] = {"max_abs_err": err, "out_err_over_max": rel,
                               "state_err_over_max": s_rel}
                errs[kernel] = max(errs[kernel], err)
                del out, final, again, again_final
            n_tc = wkv_cuda.launches_tc
            wkv_cuda(r, k, v, lw, u, None if st is None else st.clone())
            self.check((wkv_cuda.launches_tc - n_tc == 1)
                       == (row["dispatch"] == "tensor_core") == (s >= 64),
                       f"wkv {label}: dispatched to the wrong kernel")
            if label in ("forward", "decode", "serve_decode"):  # main paths
                buf = None if st is None else st.clone()
                row.update(timed_pair(
                    lambda: wkv_cuda(r, k, v, lw, u, buf),
                    lambda: wkv_ref(r, k, v, lw, u, st), REPS))
                row["library_ms"] = None  # no PyTorch call computes WKV6
                row["bound_ms"], row["bound_by"] = wkv_bound_ms(
                    b, h, s, d, with_state)
            if label == "forward":  # the sequential kernel at the same shape
                seq_ms = [time_ms(lambda: wkv_cuda(
                    r, k, v, lw, u, kernel="sequential"), REPS)
                    for _ in range(2)]
                row["sequential_ms"] = min(seq_ms)
                row["sequential_ms_runs"] = seq_ms
                self.check(row["ms"] < row["sequential_ms"],
                           f"wkv forward: the tensor-core kernel "
                           f"({row['ms']} ms) is not faster than the "
                           f"sequential one ({row['sequential_ms']} ms)")
            emit({"phase": "kernel", "kernel": "wkv", **row,
                  "card": self.card})
            rows[label] = row
            del r, k, v, lw, ref, ref_final
            torch.cuda.empty_cache()
        fwd, dec = rows["forward"], rows["decode"]
        common = {"route": "cuda", "source": "src/repro_torch/csrc/wkv.cu",
                  "replaces": "src/repro/kernels/wkv/kernel.py:22",
                  "launches": 0, "library_ms": None, "dtype": "float32",
                  "card": self.card}
        # the sequential kernel: the decode path's (every decode WKV); its
        # time at the forward's shape beside it
        self.kernels["wkv"] = {
            "name": "wkv", **common, "kernel": "sequential",
            "max_abs_err": errs["sequential"], "ms": dec["ms"],
            "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"], "shape": dec["shape"],
            "forward_ms": fwd["sequential_ms"], "forward_shape": fwd["shape"],
            "serve_decode": {k: rows["serve_decode"][k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by")}}
        # the chunked kernel: the forward's (every prefill WKV)
        self.kernels["wkv_tc"] = {
            "name": "wkv_tc", **common, "kernel": "tensor_core",
            "max_abs_err": errs["tensor_core"], "ms": fwd["ms"],
            "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
            "bound_by": fwd["bound_by"], "shape": fwd["shape"]}

    # -- phase 5b: where a B4 launch's host time goes at decode -----------
    def wkv_host_path(self):
        """Each step of ``wkv_cuda``'s path at the decode shape (8,32,1,64),
        the state updated in place (``host_us``); then B4's own device time
        a launch in a profiler window over the wrapper's calls."""
        import numpy as np
        import torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.kernels.wkv import kernel as b4

        rng = np.random.default_rng(0)
        b, h, d = 8, 32, 64
        r, k, v = (torch.from_numpy((rng.standard_normal((b, 1, h, d)) * 0.5
                                     ).astype(np.float32)).cuda()
                   .transpose(1, 2) for _ in range(3))
        lw = torch.from_numpy(rng.uniform(*MODEL_LW, (b, 1, h, d)).astype(
            np.float32)).cuda().transpose(1, 2)
        u = torch.from_numpy((rng.standard_normal((h, d)) * 0.5).astype(
            np.float32)).cuda()
        state = torch.zeros((b, h, d, d), dtype=torch.float32, device="cuda")
        out = torch.empty_like(r)
        dev = r.get_device()
        fn = b4.LIBRARY.load().wkv_forward
        ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                u.data_ptr(), state.data_ptr(), state.data_ptr(),
                out.data_ptr())
        args = (*ptrs, b, h, 1, d, *r.stride()[:3], *out.stride()[:3])
        packed = b4._pack(*args)
        stream = torch._C._cuda_getCurrentRawStream(dev)
        launch = b4._LAUNCH["sequential"]
        steps = {
            # the path as it is, in its order
            "checks": lambda: b4._on_card(r, k, v, lw, u, state),
            "kernel_for": lambda: b4.kernel_for(1, d),
            "strides": lambda: (k.stride() != r.stride(),
                                v.stride() != r.stride(),
                                lw.stride() != r.stride(),
                                b4._readable(r.stride())),
            "empty_like": lambda: torch.empty_like(r),
            "data_ptrs_and_alignment": lambda: (
                r.data_ptr() | k.data_ptr() | v.data_ptr() | lw.data_ptr()
                | u.data_ptr() | state.data_ptr() | out.data_ptr()) % 16,
            "pack_arguments": lambda: b4._pack(*args),
            "device_compare": lambda: dev == torch._C._cuda_getDevice(),
            "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev),
            "ctypes_call_and_launch": lambda: fn(packed, stream),
            "launcher": lambda: launch(dev, packed),
            "wrapper": lambda: b4.wkv_cuda(r, k, v, lw, u, state),
        }
        us = host_us(steps)
        calls = 200
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                b4.wkv_cuda(r, k, v, lw, u, state)
            torch.cuda.synchronize()

        def device_us(e):
            return (getattr(e, "self_device_time_total", 0.0)
                    or getattr(e, "self_cuda_time_total", 0.0))

        kernel_us = sum(device_us(e) for e in prof.key_averages()
                        if "wkv_kernel" in e.key)
        self.check(bool(torch.isfinite(state).all()),
                   "wkv host path: the state is not finite")
        emit({"phase": "wkv_host_path", "shape": [b, h, 1, d],
              "dtype": "float32", "calls": HOST_CALLS, "us_per_call": us,
              "profiled_calls": calls,
              "device_us_per_launch": (kernel_us / calls if kernel_us
                                       else "not measured"),
              "card": self.card})

    # -- phase 5c: where the chunked B4 kernel's cycles go ----------------
    def wkv_cycles(self):
        """B4's tensor-core kernels built with their phase counters
        (``kernels/wkv/cycles.py``) at the forward's shape: the forward's
        cycles a chunk of each phase by warp; ``mma.sync`` and barrier
        microbenchmarks; the chunked backward's cycles a block of each
        phase by warp."""
        from repro_torch.kernels.wkv import cycles

        phases = cycles.phase_cycles()
        emit({"phase": "wkv_cycles", **phases,
              "microbenchmarks": cycles.microbenchmarks(),
              "backward": cycles.backward_phase_cycles(), "card": self.card})

    # -- phase 6: the LMs at full width, f32 -----------------------------
    def model_check(self, arch, module, attr, plain, kernel, kernel_rtol,
                    decode_rtol, prepare=None, layers=CHECK_LAYERS,
                    **changes):
        """The f32 model at full width, ``layers`` deep (``changes`` to the
        config beside), on ``check_batch``'s inputs: forward through
        ``kernel`` against the same forward with ``module.attr`` patched to
        its plain version, and forward against teacher-forced decode, as
        shares of max |logits| (no decode check where ``decode_rtol`` is
        None: a VLM's decode takes no patches). The enc-dec forward that
        decode is held to runs on zero frames, where its memory is exactly
        0, as the memory decode attends to. An MoE model holds its routing
        (``HeldRouting``): the plain forward and every decode step route as
        the kernel's forward did. ``prepare`` (if given) changes the random
        weights in place first."""
        import dataclasses

        import torch
        from repro_torch import models as M
        from repro_torch.configs import get_config

        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  num_layers=layers, **changes)
        t0 = time.perf_counter()
        generator = torch.Generator(device="cuda")
        generator.manual_seed(0)
        model = M.init_params(cfg, generator)
        if prepare is not None:
            prepare(cfg, model)
        batch = check_batch(cfg)
        tokens = batch["tokens"]
        held, rel = {}, None
        with held_routing(cfg) as routing:
            full, k_rel = kernel_vs_plain(cfg, model, batch, module, attr,
                                          plain, routing=routing)
            if decode_rtol is not None and cfg.is_encdec:
                full, _ = M.forward(cfg, model, dict(
                    batch, frames=torch.zeros_like(batch["frames"])))
            if routing is not None:
                held["plain"] = routing.stats()
                fwd = routing.recorded

                def as_forward(i):
                    # decode step t, layer l routes as the forward's token t
                    t = i // layers
                    return tuple(r[:, t:t + 1] for r in fwd[i % layers])

                routing.hold(as_forward)
            if decode_rtol is not None:
                st = M.init_decode_state(cfg, 2, tokens.shape[1],
                                         device="cuda")
                worst = torch.zeros((), device="cuda")
                for t in range(tokens.shape[1]):
                    logits, st = M.decode_step(cfg, model, st, tokens[:, t])
                    worst = torch.maximum(worst,
                                          (logits - full[:, t]).abs().max())
                rel = float(worst) / float(full.abs().max())
                del st
            if routing is not None:
                held["decode"] = routing.stats()
        finite = bool(torch.isfinite(full).all())
        self.check(finite, f"{arch} model check: forward logits not finite")
        self.check(k_rel <= kernel_rtol,
                   f"{arch} model check: {kernel} vs plain {k_rel}")
        self.check(decode_rtol is None or rel < decode_rtol,
                   f"{arch} model check: forward vs decode {rel} >= "
                   f"{decode_rtol}")
        emit({"phase": "model_check", "arch": arch, "dtype": "float32",
              "layers": layers, "d_model": cfg.d_model, "changes": changes,
              "batch": 2, "tokens": CHECK_SEQ,
              "inputs": {k: list(v.shape) for k, v in batch.items()},
              "decode_inputs": ("zero frames" if cfg.is_encdec else
                                "the forward's" if decode_rtol else None),
              "kernel": kernel,
              "kernel_vs_plain_over_max_logits": k_rel,
              "kernel_limit": kernel_rtol,
              "decode_vs_forward_over_max_logits": rel,
              "decode_limit": decode_rtol, "held_routing": held,
              "seconds": time.perf_counter() - t0, "card": self.card})
        del model, full, batch
        torch.cuda.empty_cache()

    def dense_model_check(self):
        from repro_torch.kernels.flash_attention import attention_ref
        from repro_torch.models import attention as attn_mod

        self.model_check(ARCH, attn_mod, "flash_attention",
                         lambda q, k, v, **kw: attention_ref(q, k, v, **kw),
                         "flash_attention", MODEL_B3_RTOL, DECODE_RTOL)

    def dense_bf16_model_check(self):
        self.bf16_model_check(ARCH, CHECK_LAYERS, CHECK_LAYERS,
                              MODEL_B3_BF16_RTOL)

    def bf16_model_check(self, arch, layers, attn_blocks, limit, **changes):
        """B3's tensor-core kernel inside ``arch`` in bf16 at full width,
        ``layers`` deep (``changes`` to the config beside; ``attn_blocks``
        attention calls a forward), on ``check_batch``'s inputs, against the
        same forward through the plain attention, to ``limit``; beside it,
        how far the plain attention moves the logits when it keeps its
        scores in f32 on the same bf16 operands, the model's own
        sensitivity to bf16 rounding there. An MoE model holds its routing
        in each pair (``HeldRouting``)."""
        import dataclasses

        import torch
        from repro_torch import models as M
        from repro_torch.configs import get_config
        from repro_torch.kernels.flash_attention import (
            attention_ref, flash_attention_cuda)
        from repro_torch.models import attention as attn_mod

        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  **changes)
        t0 = time.perf_counter()
        generator = torch.Generator(device="cuda")
        generator.manual_seed(0)
        model = M.init_params(cfg, generator)
        batch = check_batch(cfg)
        held = {}
        with held_routing(cfg) as routing:
            n_tc = flash_attention_cuda.launches_tc
            full, k_rel = kernel_vs_plain(
                cfg, model, batch, attn_mod, "flash_attention",
                lambda q, k, v, **kw: attention_ref(q, k, v, **kw),
                routing=routing)
            n_tc = flash_attention_cuda.launches_tc - n_tc
            if routing is not None:
                held["kernel_vs_plain"] = routing.stats()
            _, spread = kernel_vs_plain(
                cfg, model, batch, attn_mod, "flash_attention",
                lambda q, k, v, **kw: attention_ref(
                    q.float(), k.float(), v.float(), **kw).to(q.dtype),
                baseline=lambda q, k, v, **kw: attention_ref(q, k, v, **kw),
                routing=routing)
            if routing is not None:
                held["plain_bf16_vs_f32"] = routing.stats()
        self.check(bool(torch.isfinite(full).all()),
                   f"{arch} bf16 model check: logits not finite")
        self.check(n_tc == attn_blocks, f"{arch} bf16 model check: {n_tc} "
                                        "tensor-core B3 launches")
        self.check(k_rel <= limit,
                   f"{arch} bf16 model check: B3 vs plain {k_rel} > {limit}")
        self.check(k_rel <= B3_BF16_SPREAD_FACTOR * spread,
                   f"{arch} bf16 model check: B3 vs plain {k_rel} over "
                   f"{B3_BF16_SPREAD_FACTOR} x the plain version's spread "
                   f"{spread}")
        emit({"phase": "model_check", "arch": arch, "dtype": "bfloat16",
              "layers": layers, "d_model": cfg.d_model, "changes": changes,
              "batch": 2, "tokens": CHECK_SEQ,
              "inputs": {k: list(v.shape) for k, v in batch.items()},
              "kernel": "flash_attention (tensor cores)",
              "tensor_core_launches": n_tc,
              "kernel_vs_plain_over_max_logits": k_rel,
              "kernel_limit": limit,
              "plain_bf16_vs_f32_over_max_logits": spread,
              "held_routing": held,
              "seconds": time.perf_counter() - t0, "card": self.card})
        del model, full, batch
        torch.cuda.empty_cache()

    def rwkv_model_check(self):
        """B4 inside the f32 rwkv6-1.6b: the forward's WKVs (S = 512) on
        the tensor-core kernel, the decode steps' on the sequential one."""
        from repro_torch.kernels.wkv import wkv_cuda, wkv_ref
        from repro_torch.models import rwkv as rwkv_mod

        def plain(r, k, v, lw, u, *, state=None, chunk=64):
            out, final = wkv_ref(r, k, v, lw, u, state)
            return out, final if state is None else state.copy_(final)

        n, n_tc = wkv_cuda.launches, wkv_cuda.launches_tc
        self.model_check(RWKV_ARCH, rwkv_mod, "wkv", plain, "wkv",
                         MODEL_B4_RTOL, RWKV_DECODE_RTOL, shift_rwkv)
        n, n_tc = wkv_cuda.launches - n, wkv_cuda.launches_tc - n_tc
        # one forward through the kernels, then CHECK_SEQ decode steps
        self.check(n_tc == CHECK_LAYERS
                   and n == CHECK_LAYERS * (1 + CHECK_SEQ),
                   f"{RWKV_ARCH} model check: {n_tc} tensor-core B4 launches "
                   f"of {n}")

    def hybrid_model_check(self):
        """B3 (the scalar kernel, f32, head dim 112) inside the f32
        zamba2-7b at full width, HYBRID_CHECK_LAYERS deep: one group under
        the shared attention, so one B3 launch a forward, and a tail."""
        from repro_torch.kernels.flash_attention import (
            attention_ref, flash_attention_cuda)
        from repro_torch.models import attention as attn_mod

        n = flash_attention_cuda.launches
        n_tc = flash_attention_cuda.launches_tc
        self.model_check(HYBRID_ARCH, attn_mod, "flash_attention",
                         lambda q, k, v, **kw: attention_ref(q, k, v, **kw),
                         "flash_attention", MODEL_B3_RTOL, HYBRID_DECODE_RTOL,
                         layers=HYBRID_CHECK_LAYERS)
        n = flash_attention_cuda.launches - n
        n_tc = flash_attention_cuda.launches_tc - n_tc
        self.check(n == 1 and n_tc == 0, f"{HYBRID_ARCH} model check: {n} B3 "
                                         f"launches, {n_tc} on tensor cores")

    def hybrid_bf16_model_check(self):
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.models.transformer import hybrid_groups

        cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                                  num_layers=HYBRID_CHECK_LAYERS)
        self.bf16_model_check(HYBRID_ARCH, HYBRID_CHECK_LAYERS,
                              hybrid_groups(cfg)[0], HYBRID_B3_BF16_RTOL)

    def moe_model_check(self):
        """B3 (the scalar kernel, f32) inside the f32 mixtral-8x7b at full
        width, MOE_CHECK_LAYERS deep, and forward against teacher-forced
        decode at capacity factor E/k, where the forward drops no choice
        (decode never drops one)."""
        from repro_torch.configs import get_config
        from repro_torch.kernels.flash_attention import (
            attention_ref, flash_attention_cuda)
        from repro_torch.models import attention as attn_mod

        cfg = get_config(MOE_ARCH)
        n = flash_attention_cuda.launches
        n_tc = flash_attention_cuda.launches_tc
        self.model_check(MOE_ARCH, attn_mod, "flash_attention",
                         lambda q, k, v, **kw: attention_ref(q, k, v, **kw),
                         "flash_attention", MODEL_B3_RTOL, MOE_DECODE_RTOL,
                         layers=MOE_CHECK_LAYERS,
                         capacity_factor=cfg.num_experts
                         / cfg.experts_per_token)
        n = flash_attention_cuda.launches - n
        n_tc = flash_attention_cuda.launches_tc - n_tc
        self.check(n == MOE_CHECK_LAYERS and n_tc == 0,
                   f"{MOE_ARCH} model check: {n} B3 launches, {n_tc} on "
                   "tensor cores")

    def moe_bf16_model_check(self):
        self.bf16_model_check(MOE_ARCH, MOE_CHECK_LAYERS, MOE_CHECK_LAYERS,
                              MOE_B3_BF16_RTOL)

    def encdec_model_check(self):
        """B3 (the scalar kernel, f32, head dim 64) inside the f32
        seamless-m4t-medium at full width, CHECK_LAYERS encoder and decoder
        layers, on real frames: one unmasked B3 launch an encoder layer and
        one causal one a decoder layer, a forward; then forward on zero
        frames (B3 as many times again) against teacher-forced decode."""
        from repro_torch.kernels.flash_attention import (
            attention_ref, flash_attention_cuda)
        from repro_torch.models import attention as attn_mod

        n = flash_attention_cuda.launches
        n_tc = flash_attention_cuda.launches_tc
        self.model_check(ENCDEC_ARCH, attn_mod, "flash_attention",
                         lambda q, k, v, **kw: attention_ref(q, k, v, **kw),
                         "flash_attention", MODEL_B3_RTOL, ENCDEC_DECODE_RTOL,
                         encoder_layers=CHECK_LAYERS)
        n = flash_attention_cuda.launches - n
        n_tc = flash_attention_cuda.launches_tc - n_tc
        self.check(n == 2 * 2 * CHECK_LAYERS and n_tc == 0,
                   f"{ENCDEC_ARCH} model check: {n} B3 launches, {n_tc} on "
                   "tensor cores")

    def encdec_bf16_model_check(self):
        self.bf16_model_check(ENCDEC_ARCH, CHECK_LAYERS, 2 * CHECK_LAYERS,
                              ENCDEC_B3_BF16_RTOL, encoder_layers=CHECK_LAYERS)

    def vlm_model_check(self):
        """B3 (the scalar kernel, f32, head dim 128, GQA 4) inside the f32
        llava-next-mistral-7b at full width, CHECK_LAYERS deep, on 2 x 512
        positions of which ``batch_structure`` makes 256 patches. No decode
        check: decode takes no patches in either package, and its text path
        is the dense block that llama3.2-3b's check holds."""
        from repro_torch.kernels.flash_attention import (
            attention_ref, flash_attention_cuda)
        from repro_torch.models import attention as attn_mod

        n = flash_attention_cuda.launches
        n_tc = flash_attention_cuda.launches_tc
        self.model_check(VLM_ARCH, attn_mod, "flash_attention",
                         lambda q, k, v, **kw: attention_ref(q, k, v, **kw),
                         "flash_attention", MODEL_B3_RTOL, None)
        n = flash_attention_cuda.launches - n
        n_tc = flash_attention_cuda.launches_tc - n_tc
        self.check(n == CHECK_LAYERS and n_tc == 0,
                   f"{VLM_ARCH} model check: {n} B3 launches, {n_tc} on "
                   "tensor cores")

    def vlm_bf16_model_check(self):
        self.bf16_model_check(VLM_ARCH, CHECK_LAYERS, CHECK_LAYERS,
                              VLM_B3_BF16_RTOL)

    def profile_decode(self, cfg, model, steps: int = DECODE_PROFILE_STEPS):
        """Where a decode step's time goes: ``steps`` steps at the ragged
        run's batch, half way through its cache, under torch.profiler."""
        import torch
        from repro_torch import models as M

        st = M.init_decode_state(cfg, RAGGED["slots"], RAGGED["max_len"],
                                 device="cuda")
        st["pos"].fill_(RAGGED["max_len"] // 2)
        tokens = torch.zeros(RAGGED["slots"], dtype=torch.int32,
                             device="cuda")
        self.profiled("decode_profile", "step",
                      lambda: M.decode_step(cfg, model, st, tokens), steps,
                      arch=cfg.name, slots=RAGGED["slots"],
                      cache_len=RAGGED["max_len"])
        del st

    def profile_forward(self, cfg, model, batch):
        """Where the forward's time goes: one forward under torch.profiler."""
        from repro_torch import models as M

        self.profiled("forward_profile", "forward",
                      lambda: M.forward(cfg, model, batch), 1,
                      arch=cfg.name,
                      inputs={k: list(v.shape) for k, v in batch.items()})

    def profiled(self, phase, unit, run, count, **fields):
        """``run`` twice to warm up, then ``count`` times under
        torch.profiler. Device time is the sum of the kernels' own times
        (the events on the card; an operator's event carries its kernels'
        time again, as does a ``record_function`` span of ``train_step``,
        and CUPTI's "Command Buffer Full" marks a launch that waited for
        room in the card's queue, so all are left out of the sum); its
        share of the host's wall clock is the device's busy share. The top
        lists name operators and kernels, a ``unit`` each, and count the
        launches that waited (``queue_full``)."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for _ in range(2):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(count):
                run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()

        def device_us(e):
            return (getattr(e, "self_device_time_total", 0.0)
                    or getattr(e, "self_cuda_time_total", 0.0))

        full = [e for e in events if e.key == "Command Buffer Full"]
        # record_function spans (train_step's parts) carry their kernels'
        # device time again, as GPU annotations
        spans = [e for e in events if e.key in TRAIN_STEP_SPANS]
        total = sum(device_us(e) for e in events
                    if e.device_type == DeviceType.CUDA and e not in full
                    and e not in spans)
        top_device = sorted(events, key=device_us, reverse=True)[:8]
        top_host = sorted(events, key=lambda e: e.self_cpu_time_total,
                          reverse=True)[:10]
        emit({"phase": phase, **fields, f"{unit}s": count,
              f"profiled_ms_per_{unit}": 1e3 * wall / count,
              "queue_full": sum(e.count for e in full) // count,
              f"device_ms_per_{unit}": (total / 1e3 / count if total
                                        else "not measured"),
              "device_busy_share": (total / 1e6 / wall if total
                                    else "not measured"),
              f"top_device_us_per_{unit}": [
                  [e.key[:60], device_us(e) / count, e.count // count]
                  for e in top_device if device_us(e)],
              f"top_host_us_per_{unit}": [
                  [e.key[:60], e.self_cpu_time_total / count,
                   e.count // count] for e in top_host],
              "card": self.card})

    # -- phase 7: the LM main paths, full width and depth, bf16 ----------
    def lm_main_path(self, cfg, per_step: dict, per_forward: dict,
                     make_batch=None, ragged: bool = True, then=None):
        """``serve()``, the ragged run and one forward of ``cfg`` at full
        width, each metered; ``per_step`` and ``per_forward`` are the
        launches of each LM kernel a decode step and a forward. A config
        cut from its published one, which ``serve()`` cannot build, serves
        ``serve()``'s requests through ``ServingEngine`` on the path's
        model, under the static placements ``serve()`` applies. The modeled
        Watt·s of the placements (a TPU v5e model's, not the card's) must be
        the placements' per-token rates over the tokens served.
        ``make_batch()`` gives the forward's inputs (default: PREFILL
        tokens from the ragged run's numpy stream); the logits' shape is
        checked against them. ``ragged=False`` leaves the ragged run out
        (the caller says why in its own phase line); ``ragged=(layers,
        per_step)`` runs it over the model's first ``layers`` layers, with
        that step's launches. The counts are set to
        0 before the path and read after it; the path's peak device memory
        is read after the forward. ``then(cfg, model, per_step)`` runs a
        further path on the same model after that, with counts of its own.
        """
        import numpy as np
        import torch
        from repro_torch import models as M
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import DEFAULT_MESH, _requests, serve
        from repro_torch.runtime import ServingEngine, static_placements

        arch = cfg.name
        entry = "serve" if cfg == get_config(arch) else "engine"
        rates = static_placements(arch, DEFAULT_MESH)

        def engine_serve():
            # serve()'s engine, placements and requests, on this path's model
            engine = ServingEngine(cfg, model, slots=4, max_len=64)
            engine.reconfigure(rates)
            for r in _requests(8, 32):
                engine.submit(r)
            t0 = time.time()
            done = engine.run()
            torch.cuda.synchronize()
            wall, st = time.time() - t0, engine.stats
            return {"completed": len(done), "steps": st.steps,
                    "occupancy": st.occupancy,
                    "decode_tokens": st.decode_tokens,
                    "total_tokens": st.total_tokens, "wall_s": wall,
                    "tokens_per_s": st.decode_tokens / wall,
                    "energy_ws": st.energy_ws,
                    "ws_per_1k_tokens": st.energy_ws / st.total_tokens * 1e3,
                    "placements": {k: (p.destination, p.clock, p.source)
                                   for k, p in engine.placements.items()}}

        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        t0 = time.perf_counter()
        generator = torch.Generator(device="cuda")
        generator.manual_seed(0)
        model = M.init_params(cfg, generator)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        # 1. the serve entry point
        before = lm_launches()
        out, secs, ws, samples = metered(
            (lambda: serve(arch, use_reduced=False, num_requests=8, slots=4,
                           max_new_tokens=32)) if entry == "serve"
            else engine_serve)
        n = launches_since(before)
        emit({"phase": "serve", "arch": arch, "entry": entry,
              "layers": cfg.num_layers, "full": True, "init_s": init_s,
              "requests": 8, "slots": 4, "max_new_tokens": 32,
              "seconds": secs, "wall_s": out["wall_s"],
              "completed": out["completed"], "steps": out["steps"],
              "occupancy": out["occupancy"],
              "decode_tokens": out["decode_tokens"],
              "total_tokens": out["total_tokens"],
              "tokens_per_s": out["total_tokens"] / out["wall_s"],
              "decode_tokens_per_s": out["tokens_per_s"],
              "ms_per_step": 1e3 * out["wall_s"] / out["steps"],
              "metered_gpu_ws": ws, "trace_samples": samples,
              "j_per_token": ws / out["total_tokens"],
              "modeled_energy_ws": out["energy_ws"],
              "modeled_ws_per_1k_tokens": out["ws_per_1k_tokens"],
              "modeled_by": "TpuPowerModel (TPU v5e), static placements on "
                            f"{out['placements']['decode'][0]}",
              "launches": n, "card": self.card})
        self.serve_out[arch] = dict(out, metered_gpu_ws=ws)
        self.check(out["completed"] == 8, f"{arch} serve: not every request "
                                          "done")
        prefill = out["total_tokens"] - out["decode_tokens"]
        want_ws = (prefill * rates["prefill"].energy_per_token_ws
                   + out["decode_tokens"]
                   * rates["decode"].energy_per_token_ws)
        self.check(out["energy_ws"] > 0 and abs(out["energy_ws"] - want_ws)
                   <= 1e-9 * want_ws,
                   f"{arch} serve: modeled energy_ws {out['energy_ws']}, the "
                   f"static placements' rates give {want_ws}")
        self.check(n == {k: v * out["steps"] for k, v in per_step.items()},
                   f"{arch} serve: launches {n} over {out['steps']} steps, "
                   f"want {per_step} a step")

        # 2. a ragged run through the engine
        rng = np.random.default_rng(RAGGED["seed"])
        if ragged is True:
            self.ragged_run(cfg, model, rng, per_step)
        elif ragged:
            layers, cut_per_step = ragged
            self.ragged_run(*first_layers(cfg, model, layers), rng,
                            cut_per_step, cut_from=cfg.num_layers)

        # 3. one forward (prefill): PREFILL tokens, or make_batch()'s inputs
        batch = make_batch() if make_batch else {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, PREFILL, dtype=np.int32)).cuda()}
        before = lm_launches()
        (logits, aux), secs, ws, samples = metered(
            lambda: M.forward(cfg, model, batch))
        n = launches_since(before)
        b = batch["tokens"].shape[0]
        positions = batch["tokens"].shape[1] + (
            batch["patches"].shape[1] if "patches" in batch else 0)
        emit({"phase": "forward", "arch": arch, "layers": cfg.num_layers,
              "batch": b, "positions": positions,
              "inputs": {k: list(v.shape) for k, v in batch.items()},
              "seconds": secs, "tokens_per_s": b * positions / secs,
              "metered_gpu_ws": ws, "trace_samples": samples,
              "j_per_token": ws / (b * positions),
              "aux": float(aux), "launches": n,
              "path_max_memory_allocated_bytes":
                  torch.cuda.max_memory_allocated(),
              "card": self.card})
        self.check(tuple(logits.shape) == (b, positions, cfg.padded_vocab())
                   and bool(torch.isfinite(logits).all()),
                   f"{arch} forward: logits not finite or of the wrong shape")
        self.check(bool(torch.isfinite(aux)) and (float(aux) > 0)
                   == bool(cfg.num_experts),
                   f"{arch} forward: aux loss {float(aux)}")
        self.check(n == per_forward, f"{arch} forward: launches {n}, want "
                                     f"{per_forward}")

        # the path's launches: serve, the ragged run and the forward
        self.path_launches[arch] = lm_launches()
        del logits
        if then is not None:
            then(cfg, model, per_step)
        # where a decode step's and the forward's time go; after the counts
        # are read, since these runs are not the main path
        self.profile_decode(cfg, model)
        self.profile_forward(cfg, model, batch)
        del model, batch
        torch.cuda.empty_cache()

    def ragged_run(self, cfg, model, rng, per_step: dict,
                   cut_from=None):
        """RAGGED's requests, prompts drawn from ``rng``, through
        ``ServingEngine``, metered; every decode step's logits checked
        finite and its launches counted. ``cut_from``: the path's depth,
        where ``model`` is a view of its first ``cfg.num_layers``."""
        import torch
        from repro_torch.runtime import Request, ServingEngine

        arch = cfg.name
        lo, hi = RAGGED["prompt"]
        reqs = [Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab_size, int(n)).tolist(),
                    max_new_tokens=RAGGED["max_new_tokens"])
                for i, n in enumerate(rng.integers(lo, hi + 1,
                                                   RAGGED["requests"]))]
        engine = ServingEngine(cfg, model, slots=RAGGED["slots"],
                               max_len=RAGGED["max_len"])
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        step = engine._step

        def checked_step(model, state, tokens):
            logits, state = step(model, state, tokens)
            finite.logical_and_(torch.isfinite(logits).all())
            return logits, state

        engine._step = checked_step
        for r in reqs:
            engine.submit(r)
        before = lm_launches()
        done, secs, ws, samples = metered(engine.run)
        n = launches_since(before)
        st = engine.stats
        emit({"phase": "ragged", "arch": arch, "layers": cfg.num_layers,
              "cut_from_layers": cut_from,
              **RAGGED, "seconds": secs, "completed": len(done),
              "steps": st.steps, "occupancy": st.occupancy,
              "prefill_tokens": st.prefill_tokens,
              "decode_tokens": st.decode_tokens,
              "tokens_per_s": st.total_tokens / secs,
              "decode_tokens_per_s": st.decode_tokens / secs,
              "ms_per_step": 1e3 * secs / st.steps,
              "metered_gpu_ws": ws, "trace_samples": samples,
              "j_per_token": ws / st.total_tokens,
              "launches": n, "card": self.card})
        self.check(len(done) == RAGGED["requests"] and all(
            len(r.output) == RAGGED["max_new_tokens"] for r in done),
            f"{arch} ragged: not every request generated its tokens")
        self.check(bool(finite), f"{arch} ragged: decode logits not finite")
        want = {k: v * st.steps for k, v in per_step.items()}
        self.check(n == want, f"{arch} ragged: launches {n} over {st.steps} "
                              f"steps, want {per_step} a step")
        del engine

    def migration_run(self, cfg, model, per_step: dict,
                      resize: bool = False):
        """Mid-flight migration on the path's model: ``serve()``'s requests
        (8, 32 new tokens) on one engine of MIGRATION's slots and
        ``max_len`` (the baseline), then on engine A with rid 0 moved to an
        engine B of the same geometry right after its admission, back to A
        mid-decode (into the slot rid 1 leaves for B just before: A's
        queue refills a freed slot at its next step) and to B again one
        token before its end. At equal geometry each row's arithmetic is
        the same kernels on the same shapes: tokens and finish reasons must
        equal the baseline's exactly. With ``resize``, rid 2 also moves
        mid-decode into an engine C of MIGRATION's ``resize_len`` (its cache
        truncated): its tokens must equal the baseline's or part only at a
        bf16 near-tie (``near_tie``). The engines share the model; all
        serve under the static placements. The counts are set to 0 before
        the baseline and read after the migrated run."""
        import torch
        from repro_torch.launch.serve import DEFAULT_MESH, _requests
        from repro_torch.runtime import ServingEngine, static_placements

        arch = cfg.name
        slots, max_len = MIGRATION["slots"], MIGRATION["max_len"]
        new_tokens = MIGRATION["max_new_tokens"]
        rates = static_placements(arch, DEFAULT_MESH)
        watch = MIGRATION["resize_rid"] if resize else None

        def engine(name, length, log):
            eng = ServingEngine(cfg, model, slots=slots, max_len=length,
                                name=name)
            eng.reconfigure(rates)
            step = eng._step

            def logged(model, state, tokens):
                # the watched request's logits at each of its steps
                logits, state = step(model, state, tokens)
                for i, r in enumerate(eng._stream["slot_req"]):
                    if r is not None and r.rid == watch:
                        log.append(logits[i].float())
                return logits, state

            if watch is not None:
                eng._step = logged
            return eng

        def serve_on(engines, moves):
            """Steps every engine in turn until all are drained; before a
            round, ``moves`` (rid, from, to, when(request)) fire once."""
            reqs = _requests(MIGRATION["requests"], new_tokens)
            for r in reqs:
                engines[0].submit(r)
            for e in engines:
                e.stream_open()
            pending, done = list(moves), []
            for _ in range(100_000):
                for move in list(pending):
                    rid, src, dst, when = move
                    req = reqs[rid]
                    slot_req = engines[src]._stream["slot_req"]
                    if req in slot_req and when(req):
                        done.append(self.move(engines[src], engines[dst],
                                              slot_req.index(req)))
                        pending.remove(move)
                outs = [e.stream_step() for e in engines]
                if all(o is None for o in outs):
                    break
            for e in engines:
                e.stream_close()
            self.check(not pending, f"{arch} migration: moves {pending} "
                                    "never fired")
            return reqs, done

        reset_all_launches()
        before = lm_launches()
        base_log, moved_log = [], []
        t0 = time.perf_counter()
        base_engine = engine("baseline", max_len, base_log)
        base, _ = serve_on([base_engine], ())
        base_s = time.perf_counter() - t0
        engines = [engine("a", max_len, moved_log),
                   engine("b", max_len, moved_log)]
        half = new_tokens // 2
        # (rid, from, to, when): checked in order before each round
        moves = [(0, 0, 1, lambda r: True),  # the step after admission
                 (1, 0, 1, lambda r: len(r.output) == half),
                 (0, 1, 0, lambda r: len(r.output) == half),
                 (0, 0, 1, lambda r: len(r.output) == new_tokens - 1)]
        if resize:
            engines.append(engine("c", MIGRATION["resize_len"], moved_log))
            moves.append((watch, 0, 2, lambda r: len(r.output) == half // 2))
        (reqs, made), secs, ws, samples = metered(
            lambda: serve_on(engines, moves))
        n = launches_since(before)
        self.path_launches[f"{arch} migration"] = lm_launches()

        steps = base_engine.stats.steps + sum(e.stats.steps for e in engines)
        want = {k: v * steps for k, v in per_step.items()}
        self.check(n == want, f"{arch} migration: launches {n} over {steps} "
                              f"steps, want {per_step} a step")
        record = {r.rid: (r.output, r.finish_reason) for r in reqs}
        wanted = {r.rid: (r.output, r.finish_reason) for r in base}
        exact = [rid for rid in record if rid != watch]
        parted = [rid for rid in exact if record[rid] != wanted[rid]]
        self.check(not parted, f"{arch} migration: tokens of {parted} differ "
                               "from the baseline's at equal geometry")
        self.check(all(r.done for r in reqs) and all(
            len(r.output) == new_tokens for r in reqs),
            f"{arch} migration: not every request generated its tokens")
        resized = None
        if resize:
            resized = self.near_tie(reqs[watch], base[watch], base_log,
                                    moved_log)
            self.check(resized["ok"], f"{arch} migration: the resized move "
                                      f"parts from the baseline: {resized}")
        stats = [e.stats for e in engines]
        self.check(sum(s.migrations_in for s in stats) == len(made)
                   == sum(s.migrations_out for s in stats),
                   f"{arch} migration: {len(made)} moves, ledger "
                   f"{[(s.migrations_in, s.migrations_out) for s in stats]}")
        emit({"phase": "migration", "arch": arch, "layers": cfg.num_layers,
              "slots": slots, "max_len": max_len,
              "requests": MIGRATION["requests"], "max_new_tokens": new_tokens,
              "moves": made, "baseline_seconds": base_s,
              "baseline_steps": base_engine.stats.steps,
              "steps": sum(s.steps for s in stats), "seconds": secs,
              "metered_gpu_ws": ws, "trace_samples": samples,
              "exact_requests": len(exact), "resized": resized,
              "migration_ws": sum(s.migration_ws for s in stats),
              "modeled_energy_ws": sum(s.energy_ws for s in stats),
              "launches": n, "card": self.card})
        del engines, base_engine, base_log, moved_log
        torch.cuda.empty_cache()

    def move(self, src, dst, slot) -> dict:
        """One timed move: snapshot (the device-to-host copy), restore (the
        host-to-device writes, synchronised) and detach, the steps of
        ``migrate``; a move into an engine of another ``max_len`` goes
        through ``migrate`` itself, untimed by halves, its bytes read back
        from the transfer-cost ledger."""
        import torch
        from repro_torch.runtime import migrate, migration

        rid = src._stream["slot_req"][slot].rid
        rate = migration.DEFAULT_TRANSFER_WS_PER_MIB
        if src.max_len != dst.max_len:
            billed = dst.stats.migration_ws
            t0 = time.perf_counter()
            dst_slot = migrate(src, dst, slot)
            torch.cuda.synchronize()
            ws = dst.stats.migration_ws - billed
            return {"rid": rid, "from": src.name, "to": dst.name,
                    "slot": dst_slot, "nbytes": round(ws / rate * (1 << 20)),
                    "resized": [src.max_len, dst.max_len],
                    "migrate_ms": 1e3 * (time.perf_counter() - t0),
                    "migration_ws": ws}
        t0 = time.perf_counter()
        snap = src.snapshot_slot(slot)
        t1 = time.perf_counter()
        dst_slot = dst.restore_slot(snap)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        migration.detach_slot(src, slot)
        return {"rid": rid, "from": src.name, "to": dst.name,
                "slot": dst_slot, "pos": snap.pos, "cursor": snap.cursor,
                "nbytes": snap.nbytes, "snapshot_ms": 1e3 * (t1 - t0),
                "restore_ms": 1e3 * (t2 - t1),
                "migration_ws": snap.nbytes / (1 << 20) * rate}

    @staticmethod
    def near_tie(got, want, got_log, want_log) -> dict:
        """The rule of ``tests/test_torch_serving.py``'s bf16 greedy test:
        equal tokens, or a first parting after identical inputs where the
        two runs' logits lie within NEAR_TIE_RTOL of max |logits| and the
        baseline's own margin between the two choices lies within it too."""
        if (got.output, got.finish_reason) == (want.output,
                                                want.finish_reason):
            return {"ok": True, "parted": False}
        j = next((i for i, (a, b) in enumerate(zip(got.output, want.output))
                  if a != b), None)
        if j is None:
            return {"ok": False, "parted": True, "lengths":
                    [len(got.output), len(want.output)]}
        k = len(want.prompt) - 1 + j  # the request's step that emitted j
        a, b = want_log[k], got_log[k]
        scale = float(a.abs().max())
        diff = float((a - b).abs().max()) / scale
        margin = float(a[want.output[j]] - a[got.output[j]]) / scale
        return {"ok": diff <= NEAR_TIE_RTOL and margin <= NEAR_TIE_RTOL,
                "parted": True, "at_output": j, "logits_diff_over_max": diff,
                "baseline_margin_over_max": margin, "limit": NEAR_TIE_RTOL}

    def placement_phase(self):
        """serve() of llama3.2-3b at full width with ``adaptive=True`` (a
        cold measurement cache in a temporary directory), metered: its
        reconfigurations, new measurements, the host seconds its
        controller spent planning (``PlacementController.update``, timed
        here) against the call's wall time. Then the metered GPU W·s a
        decode token goes back through ``note_metered("decode", ...)``, and
        the drift it finds is reported. The static run is the llama serve
        phase's. The counts are set to 0 before the call and read after.
        The controller and its engine refer to each other, so the model
        that ``serve()`` built is freed by the garbage collector, run
        here before the next path measures its peak memory."""
        import gc
        import tempfile

        import torch
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import serve
        from repro_torch.runtime import placement

        cfg = get_config(ARCH)
        per_step = {"rms_norm": 2 * cfg.num_layers + 1, "flash_attention": 0,
                    "flash_attention_tc": 0, "wkv": 0, "wkv_tc": 0}
        planned = []
        update = placement.PlacementController.update

        def timed_update(ctl):
            t0 = time.perf_counter()
            report = update(ctl)
            planned.append((ctl, time.perf_counter() - t0))
            return report

        placement.PlacementController.update = timed_update
        reset_all_launches()
        before = lm_launches()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                out, secs, ws, samples = metered(lambda: serve(
                    ARCH, use_reduced=False, num_requests=8, slots=4,
                    max_new_tokens=32, adaptive=True,
                    cache_path=str(Path(tmp) / "eval_cache.jsonl")))
        finally:
            placement.PlacementController.update = update
        n = launches_since(before)
        self.path_launches[f"{ARCH} adaptive"] = lm_launches()
        self.check(n == {k: v * out["steps"] for k, v in per_step.items()},
                   f"{ARCH} adaptive serve: launches {n} over {out['steps']} "
                   f"steps, want {per_step} a step")
        self.check(out["completed"] == 8 and out["energy_ws"] > 0
                   and out["new_measurements"] > 0 and planned,
                   f"{ARCH} adaptive serve: {out['completed']} done, "
                   f"energy_ws {out['energy_ws']}, {out['new_measurements']} "
                   f"measurements, {len(planned)} plans")
        static = self.serve_out.get(ARCH, {})
        self.check(out["outputs"] == static.get("outputs"),
                   f"{ARCH} adaptive serve: tokens differ from the static "
                   "run's")
        ctl = planned[-1][0]
        modeled = ctl.engine.placements["decode"].energy_per_token_ws
        metered_rate = ws / out["decode_tokens"]
        resweep = ctl.note_metered("decode", metered_rate)
        self.check("decode" in ctl.drift, "note_metered found no drift")
        emit({"phase": "placement", "arch": ARCH, "full": True,
              "static": {k: static.get(k) for k in (
                  "energy_ws", "ws_per_1k_tokens", "placements", "steps",
                  "wall_s", "metered_gpu_ws")},
              "adaptive": {k: out[k] for k in (
                  "energy_ws", "ws_per_1k_tokens", "placements",
                  "reconfigurations", "new_measurements", "steps",
                  "wall_s")},
              "plans": len(planned),
              "planning_host_s": sum(t for _, t in planned),
              "planning_share_of_wall": sum(t for _, t in planned)
              / out["wall_s"],
              "seconds": secs, "metered_gpu_ws": ws, "trace_samples": samples,
              "modeled_decode_ws_per_token": modeled,
              "metered_gpu_ws_per_decode_token": metered_rate,
              "drift": ctl.drift["decode"], "resweep_triggered": resweep,
              "modeled_by": "TpuPowerModel (TPU v5e); metered: the card's "
                            "GPU power domain",
              "launches": n, "card": self.card})
        del ctl, planned
        gc.collect()
        torch.cuda.empty_cache()

    def fleet_main_path(self):
        """Slice 4b on llama3.2-3b at full width and depth: five runs of
        the fleet, each a path of its own (the counts set to 0 before it
        and read after), metered, its peak device memory read. Every engine
        of a fleet shares one model; caches lie in a temporary directory.

        1-3. ``serve_fleet`` (energy policy; ``adaptive=True``;
           ``provision_budget_w=PROVISION_W``), which builds its own model;
        4. ``FleetRouter.run(concurrent=True)`` on worker threads, one
           engine a thread, against ``max_workers=1`` on a second fleet of
           the same requests (round robin, so every engine has work):
           tokens, finish reasons and every ``EngineStats`` field equal;
        5. ``workload.simulate`` of FLEET_REPLAY's trace with autoscaling
           and live rebalancing; the moved requests' tokens must equal a
           never-migrated run's (one engine of the same geometry).

        No request has an eos, so the modeled ledger does not depend on
        token values: each run's report (wall clock, tokens and device
        aside), plans, routing and ledgers must equal the same call's on
        the CPU at the reduced config, run here with the port. One ledger
        line depends on the model's size: a move's ``migration_ws`` is its
        snapshot's bytes at ``transfer_ws_per_mib``, so on each device it
        must equal that rate over a slot of its own config's decode state,
        and everything else must be equal. B2 must launch 2n+1 times a
        step of every engine, threads or not."""
        import dataclasses
        import gc
        import tempfile
        from collections import Counter

        import torch
        from repro_torch import models as M
        from repro_torch.checkpoint import tree_paths
        from repro_torch.configs import get_config, mixed_fleet, reduced
        from repro_torch.launch.serve import TENANTS, _requests, serve_fleet
        from repro_torch.models.transformer import init_decode_state
        from repro_torch.runtime import (FleetRouter, Request, ServingEngine,
                                         migration)
        from repro_torch.workload import WorkloadSpec, generate, simulate

        cfg = get_config(ARCH)
        small = reduced(cfg)
        n = cfg.num_layers
        per_step = {"rms_norm": 2 * n + 1, "flash_attention": 0,
                    "flash_attention_tc": 0, "wkv": 0, "wkv_tc": 0}
        tmp = tempfile.TemporaryDirectory()

        def cache(name):
            return str(Path(tmp.name) / f"{name}.jsonl")

        def measured(label, fn):
            """``fn()`` metered as the path ``label``: (result, seconds,
            GPU W·s, samples, launches, peak bytes)."""
            torch.cuda.reset_peak_memory_stats()
            reset_all_launches()
            before = lm_launches()
            out, secs, ws, samples = metered(fn)
            launches = launches_since(before)
            self.path_launches[f"{ARCH} fleet {label}"] = lm_launches()
            return (out, secs, ws, samples, launches,
                    torch.cuda.max_memory_allocated())

        def check_launches(label, launches, steps):
            want = {k: v * steps for k, v in per_step.items()}
            self.check(steps > 0 and launches == want,
                       f"fleet {label}: launches {launches} over {steps} "
                       f"engine steps, want {per_step} a step")

        def line(label, *, steps, tokens, wall, energy_ws, occupancy, secs,
                 ws, samples, launches, peak, **extra):
            emit({"phase": "fleet", "run": label, "arch": ARCH, "layers": n,
                  "full": True, "steps": steps, "wall_s": wall,
                  "tokens_per_s": tokens / wall,
                  "ms_per_engine_step": 1e3 * wall / steps,
                  "occupancy": occupancy, "modeled_energy_ws": energy_ws,
                  "modeled_ws_per_1k_tokens": energy_ws / tokens * 1e3,
                  "modeled_by": "TpuPowerModel (TPU v5e) of each "
                                "destination, not the card's draw",
                  "seconds": secs, "metered_gpu_ws": ws,
                  "trace_samples": samples,
                  "max_memory_allocated_bytes": peak, "launches": launches,
                  **extra, "card": self.card})

        def modeled(report):
            return {k: v for k, v in report.items()
                    if k not in FLEET_UNMODELED}

        # 1-3. the serve_fleet entry point
        for label, kw in (("energy", {}), ("adaptive", {"adaptive": True}),
                          ("provisioned",
                           {"provision_budget_w": PROVISION_W})):
            want = serve_fleet(ARCH, use_reduced=True, device="cpu",
                               cache_path=cache(f"{label}-cpu"), **FLEET,
                               **kw)
            out, secs, ws, samples, launches, peak = measured(
                label, lambda: serve_fleet(
                    ARCH, use_reduced=False, device="cuda",
                    cache_path=cache(label), **FLEET, **kw))
            got = modeled(out)
            self.check(got == modeled(want),
                       f"fleet {label}: the modeled report differs from the "
                       "CPU's in " + str(sorted(
                           k for k in got if got[k] != want.get(k))))
            self.check(out["completed"] == FLEET["num_requests"] and all(
                len(o) == FLEET["max_new_tokens"]
                for o in out["outputs"].values()),
                f"fleet {label}: not every request generated its tokens")
            check_launches(label, launches, out["steps"])
            line(label, steps=out["steps"], tokens=out["total_tokens"],
                 wall=out["wall_s"], energy_ws=out["energy_ws"],
                 occupancy=out["occupancy"], secs=secs, ws=ws,
                 samples=samples, launches=launches, peak=peak,
                 entry="serve_fleet", policy="energy", engines=list(
                     out["engines"]),
                 served_by=dict(Counter(e for e, _ in
                                        out["served_by"].values())),
                 new_measurements=out["new_measurements"],
                 reconfigurations=out["reconfigurations"],
                 modeled_equals_cpu=got == modeled(want), **kw)
            del out
            gc.collect()
            torch.cuda.empty_cache()

        # one model for runs 4 and 5, shared by every engine
        generator = torch.Generator(device="cuda")
        generator.manual_seed(0)
        model = M.init_params(cfg, generator)
        cpu_generator = torch.Generator()
        cpu_generator.manual_seed(0)
        cpu_model = M.init_params(small, cpu_generator)

        def ledger(router):
            return {name: dataclasses.asdict(st)
                    for name, st in router.per_engine_stats().items()}

        def summed(router):
            fleet = dataclasses.asdict(router.fleet_stats())
            return all(fleet[f] == sum(s[f] for s in ledger(router).values())
                       for f in fleet)

        # 4. the lockstep executor: worker threads against one worker
        def fleet(c, m, device, name):
            router = FleetRouter(c, m, mixed_fleet(), arch=ARCH,
                                 policy="round_robin", slots=2, max_len=64,
                                 cache_path=cache(name), device=device)
            for r in _requests(**FLEET_THREADS):
                router.submit(r)
            return router

        def drain(router, workers):
            """The executor's drain: (finished, wall seconds)."""
            t0 = time.perf_counter()
            done = router.run(concurrent=True, max_workers=workers)
            torch.cuda.synchronize()
            return done, time.perf_counter() - t0

        def record(done):
            return [(r.rid, r.output, r.finish_reason, r.served_by)
                    for r in done]

        wide, one = fleet(cfg, model, "cuda", "wide"), fleet(cfg, model,
                                                              "cuda", "one")
        (done_w, wall_w), secs_w, ws_w, samples_w, n_w, peak_w = \
            measured("concurrent", lambda: drain(wide, None))
        (done_1, wall_1), secs_1, ws_1, samples_1, n_1, _ = \
            measured("single-worker", lambda: drain(one, 1))
        cpu = fleet(small, cpu_model, "cpu", "cpu")
        cpu.run(concurrent=True)
        self.check(record(done_w) == record(done_1),
                   "fleet concurrent: tokens or finish reasons differ from "
                   "the single-worker run's")
        same = ledger(wide) == ledger(one) == ledger(cpu)
        self.check(same and wide.assignments == cpu.assignments
                   and summed(wide),
                   "fleet concurrent: ledgers or routing differ between "
                   "the concurrent, single-worker and CPU runs")
        self.check(len(done_w) == FLEET_THREADS["num_requests"],
                   f"fleet concurrent: {len(done_w)} requests done")
        ws_stats = wide.fleet_stats()
        check_launches("concurrent", n_w, ws_stats.steps)
        check_launches("single-worker", n_1, one.fleet_stats().steps)
        line("concurrent", steps=ws_stats.steps,
             tokens=ws_stats.total_tokens, wall=wall_w,
             energy_ws=ws_stats.energy_ws, occupancy=ws_stats.occupancy,
             secs=secs_w, ws=ws_w, samples=samples_w, launches=n_w,
             peak=peak_w, entry="FleetRouter.run", policy="round_robin",
             requests=FLEET_THREADS["num_requests"],
             max_new_tokens=FLEET_THREADS["max_new_tokens"],
             engines={b.name: b.engine.stats.steps for b in wide.bindings},
             concurrent_wall_s=wall_w, sequential_wall_s=wall_1,
             sequential_over_concurrent=wall_1 / wall_w,
             sequential_metered_gpu_ws=ws_1,
             sequential_trace_samples=samples_1, sequential_launches=n_1,
             ledger_equals_single_worker_and_cpu=same)
        del wide, one, done_w, done_1

        # 5. the virtual-clock replay with live rebalancing
        def replay(c, m, device, name):
            trace = generate(WorkloadSpec(tenants=TENANTS,
                                          **FLEET_REPLAY["spec"]))
            router = FleetRouter(c, m, mixed_fleet(), arch=ARCH,
                                 cache_path=cache(name), device=device,
                                 **FLEET_REPLAY["router"])
            return trace, router, simulate(router, trace,
                                           **FLEET_REPLAY["simulate"])

        (trace, router, report), secs, ws, samples, n5, peak = measured(
            "replay", lambda: replay(cfg, model, "cuda", "replay"))
        moves = router.moves
        _, cpu_router, cpu_report = replay(small, cpu_model, "cpu",
                                           "replay-cpu")

        def transfer_ws(c, device, moved):
            """The transfer-cost ledger of ``moved`` moves of a slot of
            ``c``'s decode state (every leaf but ``pos``), summed as the
            engines bill it."""
            st = init_decode_state(c, 1, FLEET_REPLAY["router"]["max_len"],
                                   device=device)
            nbytes = sum(t.numel() * t.element_size() for path, t in
                         tree_paths({k: v for k, v in st.items()
                                     if k != "pos"}))
            total = 0.0
            for _ in range(moved):
                total += (nbytes / (1 << 20)
                          * migration.DEFAULT_TRANSFER_WS_PER_MIB)
            return total

        def sized(x):
            """``x`` (a SimReport or a ledger, as dicts) without the
            ledger line that depends on the model's size."""
            if isinstance(x, dict):
                return {k: sized(v) for k, v in x.items()
                        if k != "migration_ws"}
            return x

        diff = sorted(k for k, v in sized(dataclasses.asdict(
            report)).items() if v != sized(dataclasses.asdict(
                cpu_report))[k])
        same = (not diff and sized(ledger(router)) == sized(ledger(
            cpu_router)) and router.assignments == cpu_router.assignments)
        self.check(same, f"fleet replay: SimReport fields {diff}, ledgers "
                         "or routing differ from the CPU's")
        bills = {"cuda": (report.migration_ws,
                          transfer_ws(cfg, "cuda", report.migrations)),
                 "cpu": (cpu_report.migration_ws,
                         transfer_ws(small, "cpu", cpu_report.migrations))}
        self.check(all(abs(got - want) <= 1e-12 * want
                       for got, want in bills.values()),
                   f"fleet replay: migration_ws against slot bytes: {bills}")
        fs = router.fleet_stats()
        self.check(report.completed == report.submitted == len(trace)
                   and summed(router),
                   f"fleet replay: {report.completed} of {len(trace)} done")
        self.check(report.migrations >= 1 and len(moves) == report.migrations
                   == fs.migrations_in == fs.migrations_out,
                   f"fleet replay: {report.migrations} migrations, "
                   f"{len(moves)} moves, ledger {fs.migrations_in} in, "
                   f"{fs.migrations_out} out")
        check_launches("replay", n5, report.steps)
        # the never-migrated run: the moved requests on one engine of the
        # fleet's geometry, where each row's arithmetic is the same
        by_rid = {t.rid: t.request for t in trace}
        fresh = [Request(rid=rid, prompt=list(by_rid[rid].prompt),
                         max_new_tokens=by_rid[rid].max_new_tokens)
                 for rid in sorted({rid for rid, _, _ in moves})]
        solo = ServingEngine(cfg, model, slots=2,
                             max_len=FLEET_REPLAY["router"]["max_len"],
                             device="cuda")
        for r in fresh:
            solo.submit(r)
        solo.run()
        parted = [r.rid for r in fresh
                  if (r.output, r.finish_reason)
                  != (by_rid[r.rid].output, by_rid[r.rid].finish_reason)]
        self.check(not parted, f"fleet replay: the moved requests {parted} "
                               "part from their never-migrated tokens")
        line("replay", steps=report.steps, tokens=report.tokens, wall=secs,
             energy_ws=report.energy_ws, occupancy=fs.occupancy, secs=secs,
             ws=ws, samples=samples, launches=n5, peak=peak,
             entry="workload.simulate", policy="energy",
             engines={b.name: b.engine.stats.steps for b in router.bindings},
             requests=len(trace), completed=report.completed,
             migrations=report.migrations,
             moves=[{"rid": rid, "from": a, "to": b} for rid, a, b in moves],
             moved_tokens_equal_baseline=not parted,
             modeled_idle_ws=report.idle_ws,
             modeled_migration_ws=report.migration_ws,
             cpu_modeled_migration_ws=cpu_report.migration_ws,
             modeled_total_ws=report.total_ws,
             modeled_full_bill_ws_per_1k_tokens=report.ws_per_1k_tokens,
             simulated_s=report.duration_s,
             slo_violations=report.slo_violations,
             power_log=len(report.power_log),
             report_equals_cpu=same)
        del router, cpu_router, model, cpu_model, solo, trace
        tmp.cleanup()
        gc.collect()
        torch.cuda.empty_cache()

    def attention_main_path(self, cfg, then=None):
        """The dense and MoE paths: ln1 and ln2 a layer and the final norm;
        B3 once a layer in the forward, on the tensor cores, since decode
        attention is PyTorch ops. The ragged run at RAGGED_LAYERS' depth."""
        n, cut = cfg.num_layers, RAGGED_LAYERS[cfg.name]
        per = attention_per_step(n)
        self.lm_main_path(cfg, per, {**per, "flash_attention": n,
                                     "flash_attention_tc": n},
                          ragged=(cut, attention_per_step(cut)), then=then)

    def cut_migration(self, per_step, resize=False):
        """``migration_run`` over a view of the path model's first
        MIGRATION_LAYERS layers, for ``lm_main_path``'s ``then``;
        ``per_step(n)``: the path's launches a decode step at n layers."""
        def then(cfg, model, _):
            cut = MIGRATION_LAYERS[cfg.name]
            self.migration_run(*first_layers(cfg, model, cut), per_step(cut),
                               resize=resize)
        return then

    def dense_main_path(self):
        from repro_torch.configs import get_config

        self.attention_main_path(get_config(ARCH), then=self.cut_migration(
            attention_per_step, resize=True))

    def moe_main_path(self):
        import dataclasses

        from repro_torch.configs import get_config

        self.attention_main_path(dataclasses.replace(get_config(MOE_ARCH),
                                                     num_layers=MOE_LAYERS))

    def rwkv_main_path(self):
        from repro_torch.configs import get_config

        cfg = get_config(RWKV_ARCH)
        n, cut = cfg.num_layers, RAGGED_LAYERS[RWKV_ARCH]
        per = rwkv_per_step(n)
        # every one of the forward's WKVs on the tensor-core kernel
        self.lm_main_path(cfg, per, {**per, "wkv_tc": n},
                          ragged=(cut, rwkv_per_step(cut)),
                          then=self.cut_migration(rwkv_per_step))

    def hybrid_main_path(self):
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.models.transformer import hybrid_groups

        def per_step(n):
            # the shared attention's ln a group, each Mamba layer's ln and
            # the final norm
            groups, _ = hybrid_groups(dataclasses.replace(cfg, num_layers=n))
            return {"rms_norm": groups + n + 1, "flash_attention": 0,
                    "flash_attention_tc": 0, "wkv": 0, "wkv_tc": 0}

        cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                                  num_layers=HYBRID_LAYERS)
        groups, _ = hybrid_groups(cfg)
        per, cut = per_step(cfg.num_layers), HYBRID_RAGGED_LAYERS
        # B3 once a group in the forward, on the tensor cores, since decode
        # attention is PyTorch ops
        self.lm_main_path(cfg, per,
                          {**per, "flash_attention": groups,
                           "flash_attention_tc": groups},
                          ragged=(cut, per_step(cut)))

    def encdec_main_path(self):
        """seamless-m4t-medium at full width and depth. A decode step: ln1,
        ln_x and ln2 a decoder layer and the final norm on B2; self- and
        cross-attention against the state are PyTorch ops. The forward of
        2 x 2048 tokens over 2 x 2048 frames (numpy seed 0): also ln1 and
        ln2 an encoder layer and enc_norm on B2, and B3 once an encoder
        layer (unmasked) and once a decoder layer (causal), all on the
        tensor cores; cross-attention is PyTorch ops."""
        from repro_torch import models as M
        from repro_torch.configs import ShapeSpec, get_config

        def per_step(n):
            return {"rms_norm": 3 * n + 1, "flash_attention": 0,
                    "flash_attention_tc": 0, "wkv": 0, "wkv_tc": 0}

        cfg = get_config(ENCDEC_ARCH)
        n, e = cfg.num_layers, cfg.encoder_layers
        per, cut = per_step(n), RAGGED_LAYERS[ENCDEC_ARCH]
        self.lm_main_path(
            cfg, per, {**per, "rms_norm": 2 * e + 1 + 3 * n + 1,
                       "flash_attention": e + n, "flash_attention_tc": e + n},
            make_batch=lambda: M.synthetic_batch(
                cfg, ShapeSpec("prefill", "prefill", PREFILL[1], PREFILL[0]),
                seed=0, device="cuda"),
            ragged=(cut, per_step(cut)))

    def vlm_main_path(self):
        """llava-next-mistral-7b at full width and depth: the dense block,
        ln1 and ln2 a layer and the final norm on B2 in a decode step; the
        forward over VLM_PREFILL's positions, 2,880 patch embeddings and
        2,880 tokens a row (numpy seed 0), also the patch norm on B2 and B3
        once a layer on the tensor cores. No ragged run: its decode step is
        the dense block on tokens only, which llama3.2-3b's ragged run
        drives."""
        from repro_torch import models as M
        from repro_torch.configs import ShapeSpec, get_config

        cfg = get_config(VLM_ARCH)
        n = cfg.num_layers
        per = {"rms_norm": 2 * n + 1, "flash_attention": 0,
               "flash_attention_tc": 0, "wkv": 0, "wkv_tc": 0}
        self.lm_main_path(
            cfg, per, {**per, "rms_norm": 2 * n + 2, "flash_attention": n,
                       "flash_attention_tc": n},
            make_batch=lambda: M.synthetic_batch(
                cfg, ShapeSpec("prefill", "prefill", VLM_PREFILL[1],
                               VLM_PREFILL[0]), seed=0, device="cuda"),
            ragged=False)
        emit({"phase": "ragged", "arch": cfg.name, "layers": n,
              "skipped": "decode is the dense block on tokens only, which "
                         f"{ARCH}'s ragged run drives; a ragged run at 32 "
                         "layers waits for a CUDA graph of decode_step",
              "card": self.card})

    # -- slices 6a + 7a: training, B2 and B3 with their gradients ---------
    def flash_backward_timed(self, q, k, v, do, causal, window, label,
                             reps=REPS, plain_reps=2) -> dict:
        """B3's backward kernel on (q, k, v) and the cotangent ``do``: twice
        for the same bits (one launch counted a call), then timed beside
        the PyTorch ops it took the place of on the training path
        (``ops.flash_attention_backward`` without o and lse), the plain
        version's autograd backward and SDPA's (``torch.autograd.grad``
        through ``F.scaled_dot_product_attention``, which the port never
        calls; a boolean mask where the window cuts the sequence), with the
        bound of the gradient's own work."""
        import torch
        import torch.nn.functional as F
        from repro_torch.kernels.flash_attention import (
            attention_ref, flash_attention_backward_cuda,
            flash_attention_cuda)
        from repro_torch.kernels.flash_attention.kernel import kernel_for
        from repro_torch.kernels.flash_attention.ops import \
            flash_attention_backward

        b, h, s, d = q.shape
        kh = k.shape[1]
        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      return_lse=True)
        n = flash_attention_backward_cuda.launches
        kern = functools.partial(flash_attention_backward_cuda, q, k, v, o,
                                 lse, do, causal=causal, window=window)
        first, again = kern(), kern()
        torch.cuda.synchronize()
        self.check(flash_attention_backward_cuda.launches == n + 2,
                   f"{label}: backward launches "
                   f"{flash_attention_backward_cuda.launches - n} for 2 calls")
        self.check(all(torch.equal(a, b_) for a, b_ in zip(first, again)),
                   f"{label}: the backward is not repeatable")
        del first, again
        plain_leaves = [t.detach().clone().requires_grad_(True)
                        for t in (q, k, v)]
        y_plain = attention_ref(*plain_leaves, causal=causal, window=window)
        lib_leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
        mask = None
        if causal and window and window < s:
            i = torch.arange(s, device="cuda")
            mask = ((i[None, :] <= i[:, None])
                    & (i[None, :] > i[:, None] - window))
        y_lib = F.scaled_dot_product_attention(
            *lib_leaves, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        out = {"kernel": kernel_for(q.dtype, d),
               "library_call": "autograd through SDPA" + (
                   ", boolean window mask" if mask is not None
                   else ", causal" if causal else ", unmasked")}
        out.update(timed_pair(
            kern, lambda: torch.autograd.grad(y_plain, plain_leaves, do,
                                              retain_graph=True), reps,
            lambda: torch.autograd.grad(y_lib, lib_leaves, do,
                                        retain_graph=True),
            plain_reps=plain_reps,
            ops_fn=functools.partial(flash_attention_backward, q, k, v, do,
                                     causal=causal, window=window)))
        out["bound_ms"], out["bound_by"] = flash_backward_bound_ms(
            b, h, kh, s, d, q.element_size(), causal, window)
        del y_plain, y_lib, plain_leaves, lib_leaves, o, lse, mask
        torch.cuda.empty_cache()
        return out

    @staticmethod
    def rms_norm_library_grad(x, scale, g):
        """B2's library yardstick for its gradient: ``torch.autograd.grad``
        through ``F.rms_norm`` (scale cast to x's dtype: the call takes
        one), a graph kept for repeated calls."""
        import torch
        import torch.nn.functional as F

        xl = x.detach().clone().requires_grad_(True)
        wl = scale.to(x.dtype).requires_grad_(True)
        y = F.rms_norm(xl, (x.shape[-1],), wl, 1e-5)
        return lambda: torch.autograd.grad(y, (xl, wl), g, retain_graph=True)

    def rms_grad_timed(self, x, scale, g, label) -> dict:
        """B2's gradient kernel on (x, scale) and the cotangent g: twice for
        the same bits (one launch counted a call), then timed by CUDA
        events beside the PyTorch ops it took the place of
        (``rms_norm_backward_ref``), the plain version's autograd and
        ``F.rms_norm``'s autograd backward, with the bound. The library's
        time is its device time (``device_ms``: its kernels' times under
        the profiler; by CUDA events it is host-paced, kept as
        ``library_event_ms``), and the kernel's device time beside it."""
        import torch
        from repro_torch.kernels.rmsnorm import (rms_norm_backward_cuda,
                                                 rms_norm_backward_ref,
                                                 rms_norm_ref)

        n = rms_norm_backward_cuda.launches
        kern = functools.partial(rms_norm_backward_cuda, x, scale, g)
        first, again = kern(), kern()
        torch.cuda.synchronize()
        self.check(rms_norm_backward_cuda.launches == n + 2,
                   f"{label}: B2 gradient launches "
                   f"{rms_norm_backward_cuda.launches - n} for 2 calls")
        self.check(all(torch.equal(a, b) for a, b in zip(first, again)),
                   f"{label}: B2's gradient is not repeatable")
        del first, again
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, scale)]
        y = rms_norm_ref(*leaves)
        lib = self.rms_norm_library_grad(x, scale, g)
        out = timed_pair(
            kern, lambda: torch.autograd.grad(y, leaves, g,
                                              retain_graph=True), REPS, lib,
            ops_fn=functools.partial(rms_norm_backward_ref, x, scale, g,
                                     1e-5))
        out["library_event_ms"] = out["library_ms"]
        out["library_ms"] = device_ms(lib, REPS)
        out["device_ms"] = device_ms(kern, REPS)
        out["library_call"] = ("autograd through F.rms_norm, device time "
                               "under the profiler")
        out["bound_ms"], out["bound_by"] = rms_grad_bound_ms(
            tuple(x.shape), x.element_size())
        del y, leaves, lib
        return out

    def train_grad_check(self):
        """B2's and B3's gradients on the card at the training shapes, each
        through its ``autograd.Function`` (the kernel forward, then B3's
        backward kernel or B2's gradient kernel) against autograd through
        its plain version, with the backward's time beside the plain
        version's autograd backward and the library's (``F.rms_norm``'s,
        SDPA's); B3's also beside the PyTorch ops it replaced."""
        import numpy as np
        import torch
        from repro_torch.kernels.flash_attention import attention_ref
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.kernels.rmsnorm import rms_norm_ref
        from repro_torch.kernels.rmsnorm.ops import rms_norm

        rng = np.random.default_rng(3)
        dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}

        def draw(shape, dt, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale)
                                    .astype(np.float32)).to("cuda", dt)

        def grads(fn, inputs, g):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in inputs]
            fn(*leaves).backward(g)
            return [t.grad.float() for t in leaves]

        def held(name, dt, got, plain, f32, rtol, names):
            """Each gradient against the plain one: f32 within rtol of its
            max |.|; bf16 within GRAD_BF16_FACTOR of plain's own distance
            from the f32 plain gradient ``f32``."""
            out = {}
            for n, a, p, r in zip(names, got, plain, f32):
                limit = rtol * float(r.abs().max())
                err = float((a - r).abs().max())
                row = {"max_abs_err": err, "max_abs": float(r.abs().max())}
                if dt == "bfloat16":
                    own = float((p - r).abs().max())
                    limit = max(GRAD_BF16_FACTOR * own, limit)
                    row["plain_bf16_err"] = own
                row["limit"] = limit
                self.check(err <= limit, f"{name} {dt} d{n}: {err} > "
                                         f"{limit}")
                out[n] = row
            return out

        rows = {}
        for dt in ("float32", "bfloat16"):
            x = draw(GRAD_RMS_SHAPE, dtypes[dt], 2.0)
            g = draw(GRAD_RMS_SHAPE, dtypes[dt])
            scale = torch.from_numpy(rng.uniform(
                0.5, 1.5, GRAD_RMS_SHAPE[-1]).astype(np.float32)).cuda()
            got = grads(rms_norm, (x, scale), g)
            plain = grads(rms_norm_ref, (x, scale), g)
            f32 = grads(rms_norm_ref, (x.float(), scale), g.float())
            row = {"shape": list(GRAD_RMS_SHAPE), "dtype": dt,
                   "grads": held("rms_norm", dt, got, plain, f32,
                                 GRAD_RMS_RTOL, ("x", "scale"))}
            del got, plain, f32
            row.update(self.rms_grad_timed(x, scale, g,
                                           f"train_grad_check {dt}"))
            emit({"phase": "train_grad_check", "kernel": "rms_norm", **row,
                  "card": self.card})
            rows[("rms_norm", dt)] = row
            b, h, kh, s_, d = GRAD_FLASH_SHAPE
            q, k, v = (draw((b, n, s_, d), dtypes[dt]) for n in (h, kh, kh))
            do = draw((b, h, s_, d), dtypes[dt])
            got = grads(flash_attention, (q, k, v), do)
            plain = grads(attention_ref, (q, k, v), do)
            f32 = grads(attention_ref, (q.float(), k.float(), v.float()),
                        do.float())
            row = {"shape": [b, h, s_, d], "kv_heads": kh, "dtype": dt,
                   "causal": True,
                   "grads": held("flash_attention", dt, got, plain, f32,
                                 GRAD_FLASH_RTOL, ("q", "k", "v"))}
            del got, plain, f32
            torch.cuda.empty_cache()
            row.update(self.flash_backward_timed(
                q, k, v, do, True, 0, f"train_grad_check {dt}"))
            del q, k, v, do
            torch.cuda.empty_cache()
            emit({"phase": "train_grad_check", "kernel": "flash_attention",
                  **row, "card": self.card})
            rows[("flash_attention", dt)] = row

        keys = ("shape", "grads", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")
        self.kernels["rms_norm"]["gradient"] = {
            "route": "cuda, rms_norm_backward_cuda (the rms_norm_backward "
                     "entry)",
            **{dt: {k: rows[("rms_norm", dt)][k]
                    for k in keys + ("ops_ms", "device_ms")}
               for dt in ("float32", "bfloat16")}}
        main = rows[("rms_norm", "bfloat16")]
        self.kernels["rms_norm_backward"] = {
            "name": "rms_norm_backward", "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:17",
            "launches": 0,
            "max_abs_err": max(g["max_abs_err"] for dt in (
                "float32", "bfloat16") for g in rows[(
                    "rms_norm", dt)]["grads"].values()),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "library_event_ms",
                                    "device_ms", "ops_ms", "shape", "dtype")},
            "plain": "autograd through rms_norm_ref",
            "ops": "kernels/rmsnorm/ref.py rms_norm_backward_ref, the "
                   "PyTorch ops the kernel replaced",
            "library": main["library_call"], "card": self.card}
        self.kernels["flash_attention"]["gradient"] = {
            "route": "cuda, flash_attention_backward_cuda (the "
                     "flash_attention_backward entry)",
            **{dt: {k: rows[("flash_attention", dt)][k]
                    for k in keys + ("ops_ms", "kernel")}
               for dt in ("float32", "bfloat16")}}
        main = rows[("flash_attention", "bfloat16")]
        self.kernels["flash_attention_backward"] = {
            "name": "flash_attention_backward", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:23",
            "launches": 0,
            "max_abs_err": max(g["max_abs_err"] for dt in (
                "float32", "bfloat16") for g in rows[(
                    "flash_attention", dt)]["grads"].values()),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "ops_ms", "shape",
                                    "kv_heads", "dtype", "kernel")},
            "plain": "autograd through attention_ref",
            "ops": "kernels/flash_attention/ops.py flash_attention_backward, "
                   "the PyTorch ops the kernel replaced",
            "library": main["library_call"], "card": self.card}

    def train_model_check(self):
        """llama3.2-3b at full width, CHECK_LAYERS deep, in f32:
        ``forward_loss`` and every parameter's gradient through the kernels,
        then through the plain versions (``models.layers``' RMSNorm and
        ``models.attention``'s attention patched to them)."""
        import dataclasses

        import torch
        from repro_torch._tree import leaves
        from repro_torch.configs import ShapeSpec, get_config
        from repro_torch.data import SyntheticLMStream, device_put_batch
        from repro_torch.models import transformer as MT

        cfg = dataclasses.replace(get_config(ARCH), num_layers=CHECK_LAYERS,
                                  dtype="float32")
        params = MT.init_param_tree(cfg, device="cuda")
        model = MT.TransformerLM.from_stacked(cfg, params)
        grads = MT.bind_stacked_grads(model, params)
        batch = device_put_batch(SyntheticLMStream(cfg, ShapeSpec(
            "check", "train", CHECK_SEQ, 2)).batch_at(0), "cuda")

        def run():
            for g in leaves(grads):
                g.zero_()
            loss, _ = MT.forward_loss(cfg, model, batch)
            loss.backward()
            return float(loss), [g.clone() for g in leaves(grads)]

        before, nb = lm_launches(), backward_launches()
        loss, got = run()
        n = {**launches_since(before), **backward_since(nb)}
        with plain_training():
            plain_loss, want = run()
        worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(got, want))
        rel = abs(loss - plain_loss) / abs(plain_loss)
        layers_n = cfg.num_layers
        self.check(rel <= TRAIN_LOSS_RTOL, f"train_model_check: loss {loss} "
                                           f"vs plain {plain_loss}")
        self.check(worst <= TRAIN_GRAD_RTOL,
                   f"train_model_check: a gradient leaf {worst} of its max "
                   f"|g| from plain's")
        # remat full: the forward and the recompute, both through the
        # kernels; B2's gradient kernel a norm, B3's backward kernel (the
        # scalar one, in f32) a layer
        self.check(n["rms_norm"] == 4 * layers_n + 1
                   and n["rms_norm_backward"] == 2 * layers_n + 1
                   and n["flash_attention"] == 2 * layers_n
                   and n["flash_attention_backward"] == layers_n,
                   f"train_model_check launches {n}")
        emit({"phase": "train_model_check", "arch": ARCH, "dtype": "float32",
              "layers": layers_n, "tokens": [2, CHECK_SEQ],
              "remat": cfg.remat, "loss": loss, "plain_loss": plain_loss,
              "loss_rel_err": rel, "leaves": len(got),
              "worst_grad_err_over_leaf_max": worst,
              "limits": {"loss": TRAIN_LOSS_RTOL, "grad": TRAIN_GRAD_RTOL},
              "launches": n, "card": self.card})
        del params, model, grads, got, want
        torch.cuda.empty_cache()

    def train_main_path(self):
        """``launch.train.train`` on llama3.2-3b at full width and depth in
        bf16 (TRAIN's steps, batch and length), metered on the GPU's power
        counter; its launches of B2 and B3 held to the count the code gives
        (remat full: 2n+1 norms and n attentions in the forward, 2n and n
        again in the recompute); then one step profiled, split into
        forward, backward and optimizer by CUDA events."""
        import contextlib
        import gc
        import io
        import math
        import re

        import torch
        from repro_torch.configs import ShapeSpec, get_config
        from repro_torch.data import SyntheticLMStream, device_put_batch
        from repro_torch.launch.train import train

        cfg = get_config(ARCH)
        n, steps = cfg.num_layers, TRAIN["steps"]
        per_step = train_launches(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log = io.StringIO()
        reset_all_launches()
        before = lm_launches()
        with contextlib.redirect_stdout(log):
            out, seconds, ws, samples = metered(lambda: train(
                ARCH, use_reduced=False, log_every=1, **TRAIN))
        counts = {**launches_since(before), **backward_launches()}
        peak = torch.cuda.max_memory_allocated()
        self.path_launches[f"{ARCH} train"] = counts
        step_ms = [int(m) for m in re.findall(r"\((\d+) ms\)",
                                              log.getvalue())]
        losses = out["losses"]
        tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
        steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2] \
            if len(step_ms) > 1 else None
        self.check(counts == {k: v * steps for k, v in per_step.items()},
                   f"train: launches {counts}, the code gives "
                   f"{per_step} a step x {steps}")
        self.check(out["steps"] == steps and all(
            math.isfinite(x) for x in losses), f"train: losses {losses}")
        lnv = math.log(cfg.vocab_size)
        self.check(abs(losses[0] - lnv) < 0.5,
                   f"train: first loss {losses[0]}, ln V = {lnv}")
        emit({"phase": "train", "arch": ARCH, "layers": n, "dtype": cfg.dtype,
              "remat": cfg.remat, **TRAIN, "entry": "launch.train.train",
              "losses": losses, "ln_vocab": lnv, "step_ms": step_ms,
              "median_step_ms_after_first": steady,
              "tokens_per_s": (1e3 * tokens / steady if steady else None),
              "wall_s": out["wall_s"], "seconds_metered": seconds,
              "metered_gpu_ws": ws,
              "metered_gpu_ws_per_step": ws / steps if ws else ws,
              "trace_samples": samples,
              "max_memory_allocated_gb": peak / 1e9,
              "launches": counts, "launches_per_step": per_step,
              "card": self.card})
        del out
        gc.collect()
        torch.cuda.empty_cache()

        # one step profiled, on a state of its own
        self.train_profile(cfg, device_put_batch(SyntheticLMStream(
            cfg, ShapeSpec("train", "train", TRAIN["seq_len"],
                           TRAIN["global_batch"])).batch_at(0), "cuda"))

    def train_bf16_check(self):
        """The bf16 step of ``train_main_path`` (full width, BF16_CHECK's
        layers, remat full, TRAIN's batch) held to the same step through the plain
        versions. Both start from ``init_train_state``'s seeded state and
        take BF16_CHECK's steps of ``train_step`` on the same batches.
        Step 1's gradient, before any update, is held leaf by leaf to the
        f32 gradient of the plain versions at the same weights (cast up),
        as the bf16 kernel checks are held: its distance at most
        GRAD_BF16_FACTOR times the plain bf16 gradient's own. Each step's
        loss and grad norm must agree with plain's within BF16_LOSS_RTOL.
        Then TRAIN's steps through the kernels on one batch repeated, whose
        loss must fall by BF16_CHECK["repeat_drop"]."""
        import dataclasses
        import gc
        import math

        import torch
        from repro_torch._tree import flatten, tree_map
        from repro_torch.configs import ShapeSpec, get_config
        from repro_torch.data import SyntheticLMStream, device_put_batch
        from repro_torch.launch.steps import init_train_state
        from repro_torch.launch.train import train_step
        from repro_torch.models import transformer as MT
        from repro_torch.optim import AdamWConfig

        cfg = dataclasses.replace(get_config(ARCH),
                                  num_layers=BF16_CHECK["layers"])
        stream = SyntheticLMStream(cfg, ShapeSpec(
            "train", "train", TRAIN["seq_len"], TRAIN["global_batch"]))

        def batch(i):
            return device_put_batch(stream.batch_at(i), "cuda")

        def free():
            gc.collect()
            torch.cuda.empty_cache()

        # the f32 gradient at init_train_state's weights, through the plain
        # versions
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params = tree_map(lambda t: t.float(),
                          MT.init_param_tree(cfg, device="cuda"))
        model = MT.TransformerLM.from_stacked(cfg32, params)
        grads = MT.bind_stacked_grads(model, params)
        with plain_training():
            loss32, _ = MT.forward_loss(cfg32, model, batch(0))
            loss32.backward()
        f32 = [g for _, g in flatten(grads)]
        loss32 = float(loss32)
        del params, model, grads
        free()

        def run(steps, lr, on_grads=None, repeat=False):
            state = init_train_state(cfg)
            model = MT.TransformerLM.from_stacked(cfg, state["params"])
            grads = MT.bind_stacked_grads(model, state["params"])

            def mark(part):
                if part == "optimizer":
                    on_grads(flatten(grads))

            out = []
            for i in range(steps):
                m = train_step(cfg, model, state, grads,
                               batch(0 if repeat else i), AdamWConfig(lr=lr),
                               mark if i == 0 and on_grads else None)
                out.append((float(m["loss"]), float(m["grad_norm"])))
            del state, model, grads
            free()
            return out

        def distance(into):
            def measure(pairs):
                for ref, (path, g) in zip(f32, pairs):
                    into["/".join(map(str, path))] = float(
                        (g.float() - ref).norm() / ref.norm())
            return measure

        t0 = time.perf_counter()
        err, plain_err = {}, {}
        got = run(BF16_CHECK["steps"], BF16_CHECK["lr"], distance(err))
        with plain_training():
            want = run(BF16_CHECK["steps"], BF16_CHECK["lr"],
                       distance(plain_err))
        n_leaves = len(f32)
        del f32
        free()
        repeated = run(TRAIN["steps"], BF16_CHECK["lr"], repeat=True)
        seconds = time.perf_counter() - t0

        ratio = {k: err[k] / plain_err[k] for k in err}
        worst = max(ratio, key=ratio.get)
        self.check(len(err) == len(plain_err) == n_leaves > 0,
                   f"train_bf16_check: {len(err)}, {len(plain_err)} of "
                   f"{n_leaves} gradient leaves compared")
        self.check(all(e <= GRAD_BF16_FACTOR * plain_err[k]
                       for k, e in err.items()),
                   f"train_bf16_check: gradient leaf {worst} {err[worst]} "
                   f"from f32, plain bf16's {plain_err[worst]}")
        rel = [(abs(a - c) / abs(c), abs(b - d) / abs(d))
               for (a, b), (c, d) in zip(got, want)]
        self.check(all(math.isfinite(x) and x <= BF16_LOSS_RTOL
                       for pair in rel for x in pair),
                   f"train_bf16_check: (loss, grad norm) {got} vs plain "
                   f"{want}")
        losses = [x for x, _ in repeated]
        self.check(all(map(math.isfinite, losses)) and losses[-1] <=
                   losses[0] - BF16_CHECK["repeat_drop"],
                   f"train_bf16_check: one batch repeated, losses {losses}")
        emit({"phase": "train_bf16_check", "arch": ARCH,
              "layers": cfg.num_layers, "dtype": cfg.dtype,
              "remat": cfg.remat, **TRAIN, "lr": BF16_CHECK["lr"],
              "loss_grad_norm": got, "plain_loss_grad_norm": want,
              "f32_plain_loss": loss32, "rel_diff": rel,
              "leaves": n_leaves, "grad_rel_l2_from_f32": err,
              "plain_bf16_grad_rel_l2_from_f32": plain_err,
              "worst_leaf": worst, "worst_ratio": ratio[worst],
              "limits": {"grad_factor": GRAD_BF16_FACTOR,
                         "loss": BF16_LOSS_RTOL,
                         "repeat_drop": BF16_CHECK["repeat_drop"]},
              "repeated_batch_losses": losses,
              "repeated_batch_grad_norms": [x for _, x in repeated],
              "seconds": seconds, "card": self.card})

    def train_resume(self):
        """Resume on llama3.2-3b at full width over RESUME's 1 layer: an
        unbroken run of 4 steps; a run of 2 steps that saves its state at
        their end, with a host copy of each leaf taken as ``save`` is
        called; that checkpoint restored on the card, each leaf compared
        bit for bit with the copy of the live state; a run on the same
        directory that restores step 2 and takes steps 3-4, whose losses
        must equal the unbroken run's. In a temporary directory the phase
        removes."""
        import dataclasses
        import gc
        import os
        import tempfile

        import numpy as np
        import torch
        from repro_torch.checkpoint import Checkpointer
        from repro_torch.checkpoint.checkpointer import _host_array, \
            tree_paths
        from repro_torch.configs import get_config
        from repro_torch.launch import train as train_mod
        from repro_torch.launch.steps import init_train_state
        from repro_torch.launch.train import train

        cfg = dataclasses.replace(get_config(ARCH),
                                  num_layers=RESUME["layers"])
        live: dict = {}

        class SnapshotCheckpointer(Checkpointer):
            """Keeps a host copy of the live state each save is handed."""

            def save(self, step, tree, **kw):
                live[step] = {key: _host_array(leaf)
                              for key, leaf in tree_paths(tree)}
                return super().save(step, tree, **kw)

        kw = dict(use_reduced=False, log_every=0,
                  global_batch=TRAIN["global_batch"],
                  seq_len=TRAIN["seq_len"])
        tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
        try:
            t0 = time.perf_counter()
            whole = train(cfg, steps=RESUME["steps"], **kw)
            train_mod.Checkpointer = SnapshotCheckpointer
            try:
                first = train(cfg, steps=RESUME["saved"], checkpoint_dir=tmp,
                              checkpoint_every=0, **kw)
            finally:
                train_mod.Checkpointer = Checkpointer
            saved = live.pop(RESUME["saved"])
            saved_bytes = os.path.getsize(os.path.join(
                tmp, f"step_{RESUME['saved']}", "arrays.npz"))
            state = Checkpointer(tmp).restore(RESUME["saved"],
                                              init_train_state(cfg))

            def bits(arr):
                return arr.view(f"u{arr.itemsize}")

            restored = tree_paths(state)
            mismatched = [key for key, leaf in restored
                          if key not in saved or not np.array_equal(
                              bits(_host_array(leaf)), bits(saved.pop(key)))]
            mismatched += sorted(saved)  # saved leaves not restored
            leaves = len(restored)
            del state, restored
            gc.collect()
            torch.cuda.empty_cache()
            resumed = train(cfg, steps=RESUME["steps"], checkpoint_dir=tmp,
                            checkpoint_every=0, **kw)
            seconds = time.perf_counter() - t0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        want = whole["losses"][RESUME["saved"]:]
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"],
                                                      want))
        self.check(not mismatched, f"resume: {mismatched} not bit-identical")
        self.check(resumed["steps"] == len(want) and rel <= RESUME_RTOL,
                   f"resume: losses {resumed['losses']} vs {want}")
        self.check(first["losses"] == whole["losses"][:RESUME["saved"]]
                   or max(abs(a - b) / abs(b) for a, b in zip(
                       first["losses"], whole["losses"])) <= RESUME_RTOL,
                   f"resume: first steps {first['losses']} vs "
                   f"{whole['losses']}")
        emit({"phase": "train_resume", "arch": ARCH,
              "layers": RESUME["layers"], "steps": RESUME["steps"],
              "saved_after_step": RESUME["saved"],
              "checkpoint_gb": saved_bytes / 1e9, "leaves": leaves,
              "leaves_not_bit_identical": mismatched,
              "unbroken_losses": whole["losses"],
              "resumed_losses": resumed["losses"],
              "max_rel_diff": rel, "limit": RESUME_RTOL,
              "seconds": seconds, "card": self.card})
        gc.collect()
        torch.cuda.empty_cache()

    # -- slice 7b: the other five families train, B4 with its backward ----
    def wkv_backward_check(self):
        """B4's backward at every WKV_GRAD_CASES entry, on the kernel
        ``kernel_for`` picks (the chunked one at head dim 64, the sequential
        one at 16), against autograd through ``wkv_ref``: dr, dk, dv, dlw
        and du each within WKV_GRAD_RTOL of its max |.|, a repeat bit for
        bit; through ``WkvFn`` (B4's forward, then the backward) at the
        training shape too. Timed at the training shape beside the
        sequential backward kernel (forced through ``kernel=``), the plain
        version's autograd backward and the bound."""
        import numpy as np
        import torch
        from repro_torch.kernels.wkv import wkv_ref
        from repro_torch.kernels.wkv.kernel import kernel_for, \
            wkv_backward_cuda
        from repro_torch.kernels.wkv.ops import wkv
        from repro_torch.kernels.wkv.ref import wkv_backward_ref

        rng = np.random.default_rng(11)
        names = ("r", "k", "v", "lw", "u")
        worst = 0.0
        for shape, lw_range, model_layout, label in WKV_GRAD_CASES:
            b, h, s, d = shape

            def seq(draw):
                if model_layout:  # views of (B, S, H, D) products
                    return torch.from_numpy(draw((b, s, h, d)).astype(
                        np.float32)).cuda().transpose(1, 2)
                return torch.from_numpy(draw(shape).astype(np.float32)).cuda()

            r, k, v = (seq(lambda sh: rng.standard_normal(sh) * 0.5)
                       for _ in range(3))
            lw = seq(lambda sh: rng.uniform(*lw_range, sh))
            u = torch.from_numpy((rng.standard_normal((h, d)) * 0.5).astype(
                np.float32)).cuda()
            do = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda()
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (r, k, v, lw, u)]
            out, _ = wkv_ref(*leaves)
            want = torch.autograd.grad(out, leaves, do, retain_graph=True)
            kernel = kernel_for(s, d)
            n_tc = wkv_backward_cuda.launches_tc
            got = wkv_backward_cuda(r, k, v, lw, u, do)
            again = wkv_backward_cuda(r, k, v, lw, u, do)
            torch.cuda.synchronize()
            self.check(wkv_backward_cuda.launches_tc - n_tc
                       == 2 * (kernel == "tensor_core"),
                       f"wkv_backward {label}: not on kernel_for's {kernel}")
            row = {"shape": list(shape), "case": label, "kernel": kernel,
                   "model_layout": model_layout, "lw_range": list(lw_range),
                   "tolerance": WKV_GRAD_RTOL, "grads": {}}
            for name, a, a2, w in zip(names, got, again, want):
                err = float((a - w).abs().max())
                peak = float(w.abs().max())
                row["grads"][name] = {"max_abs_err": err, "max_abs": peak,
                                      "err_over_max": err / peak}
                worst = max(worst, err)
                self.check(err <= WKV_GRAD_RTOL * peak,
                           f"wkv_backward {label} d{name}: {err} > "
                           f"{WKV_GRAD_RTOL} x {peak}")
                self.check(torch.equal(a, a2),
                           f"wkv_backward {label} d{name}: not repeatable")
            if label == "train":
                through = [t.detach().clone().requires_grad_(True)
                           for t in (r, k, v, lw, u)]
                o, _ = wkv(*through)
                o.backward(do)
                row["through_wkv_fn"] = {
                    n: float((t.grad - w).abs().max() / w.abs().max())
                    for n, t, w in zip(names, through, want)}
                # the plain backward (the CPU's, wkv_backward_ref) too
                row["plain_backward"] = {
                    n: float((p - w).abs().max() / w.abs().max())
                    for n, p, w in zip(names, wkv_backward_ref(
                        r, k, v, lw, u, do), want)}
                self.check(all(e <= WKV_GRAD_RTOL for e in
                               row["through_wkv_fn"].values()),
                           f"WkvFn at {shape}: {row['through_wkv_fn']}")
                del through, o
                # plain, the sequential kernel, the chunked one twice, the
                # sequential one, plain (timed_pair's "ops" slot)
                row.update(timed_pair(
                    lambda: wkv_backward_cuda(r, k, v, lw, u, do),
                    lambda: torch.autograd.grad(out, leaves, do,
                                                retain_graph=True), REPS,
                    plain_reps=1, ops_fn=lambda: wkv_backward_cuda(
                        r, k, v, lw, u, do, kernel="sequential")))
                row["sequential_ms"] = row.pop("ops_ms")
                row["sequential_ms_runs"] = row.pop("ops_ms_runs")
                row["bound_ms"], row["bound_by"] = wkv_backward_bound_ms(
                    b, h, s, d)
                self.check(row["ms"] < row["sequential_ms"],
                           f"wkv_backward: the chunked kernel's {row['ms']} "
                           f"ms is not below the sequential kernel's "
                           f"{row['sequential_ms']}")
                self.kernels["wkv_backward"] = {
                    "name": "wkv_backward", "route": "cuda",
                    "source": "src/repro_torch/csrc/wkv.cu",
                    "replaces": "src/repro/kernels/wkv/kernel.py:22",
                    "launches": 0, "kernel": kernel, "ms": row["ms"],
                    "sequential_ms": row["sequential_ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": None,
                    "shape": list(shape), "dtype": "float32",
                    "plain": "autograd through wkv_ref", "card": self.card}
            emit({"phase": "wkv_backward_check", **row, "card": self.card})
            del r, k, v, lw, u, do, leaves, out, want, got, again
            torch.cuda.empty_cache()
        self.kernels["wkv_backward"]["max_abs_err"] = worst

    def family_grad_check(self):
        """B2's and B3's gradients at the shapes the five families train at
        (FAMILY_GRAD_SHAPES), in bf16: each through its ``autograd.Function``
        against the plain version's autograd in bf16 and in f32 (held as
        ``train_grad_check`` holds bf16: GRAD_BF16_FACTOR times plain bf16's
        own distance from the f32 gradient, for B2 at least GRAD_RMS_RTOL of
        its max), with the backward's ms beside the plain version's and the
        library's, as ``train_grad_check`` times them."""
        import numpy as np
        import torch
        from repro_torch.kernels.flash_attention import attention_ref
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.kernels.rmsnorm import rms_norm_ref
        from repro_torch.kernels.rmsnorm.ops import rms_norm

        rng = np.random.default_rng(12)
        bf16 = torch.bfloat16

        def draw(shape, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale)
                                    .astype(np.float32)).to("cuda", bf16)

        def grads(fn, inputs, g):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in inputs]
            fn(*leaves).backward(g)
            return [t.grad.float() for t in leaves]

        rows = {"rms_norm": [], "flash_attention": []}
        for arch, kind, shape, causal, window in FAMILY_GRAD_SHAPES:
            t0 = time.perf_counter()
            if kind == "rms_norm":
                x, g = draw(shape, 2.0), draw(shape)
                scale = torch.from_numpy(rng.uniform(0.5, 1.5, shape[-1])
                                         .astype(np.float32)).cuda()
                inputs, names = (x, scale), ("x", "scale")
                kern, plain = rms_norm, rms_norm_ref
            else:
                b, h, kh, s, d = shape
                q, k, v = (draw((b, n, s, d)) for n in (h, kh, kh))
                g = draw((b, h, s, d))
                inputs, names = (q, k, v), ("q", "k", "v")
                kern = functools.partial(flash_attention, causal=causal,
                                         window=window)
                plain = functools.partial(attention_ref, causal=causal,
                                          window=window)
            got = grads(kern, inputs, g)
            want = grads(plain, inputs, g)
            f32 = grads(plain, [t.float() for t in inputs], g.float())
            row = {"arch": arch, "kernel": kind, "shape": list(shape),
                   "dtype": "bfloat16", "causal": causal, "window": window,
                   "grads": {}}
            for n, a, p, r in zip(names, got, want, f32):
                err = float((a - r).abs().max())
                own = float((p - r).abs().max())
                limit = GRAD_BF16_FACTOR * own
                if kind == "rms_norm":
                    # as train_grad_check: at least the f32 limit, where
                    # the plain bf16 gradient lands on the f32 one (dscale
                    # is an f32 sum of bf16 products, exact in both)
                    limit = max(limit, GRAD_RMS_RTOL * float(r.abs().max()))
                row["grads"][n] = {"max_abs_err": err, "plain_bf16_err": own,
                                   "max_abs": float(r.abs().max()),
                                   "limit": limit}
                self.check(err <= limit, f"{kind} {arch} bf16 d{n}: {err} > "
                                         f"{limit}")
            del got, want, f32
            torch.cuda.empty_cache()
            if kind == "rms_norm":
                row.update(self.rms_grad_timed(
                    x, scale, g, f"family_grad_check {arch} {shape}"))
            else:
                row.update(self.flash_backward_timed(
                    q, k, v, g, causal, window,
                    f"family_grad_check {arch} {shape}"))
            row["seconds"] = time.perf_counter() - t0
            emit({"phase": "family_grad_check", **row, "card": self.card})
            rows[kind].append({k: row.get(k) for k in (
                "arch", "shape", "causal", "window", "grads", "ms",
                "plain_ms", "ops_ms", "library_ms", "library_event_ms",
                "device_ms", "bound_ms", "bound_by")})
            del inputs, g
            torch.cuda.empty_cache()
        for name, got in rows.items():
            self.kernels[name].setdefault("gradient", {})["families"] = got
        b2 = self.kernels["rms_norm_backward"]
        b2["families"] = rows["rms_norm"]
        b2["max_abs_err"] = max([b2["max_abs_err"]] + [
            e["max_abs_err"] for r in rows["rms_norm"]
            for e in r["grads"].values()])
        b3 = self.kernels["flash_attention_backward"]
        b3["families"] = rows["flash_attention"]
        b3["max_abs_err"] = max([b3["max_abs_err"]] + [
            e["max_abs_err"] for r in rows["flash_attention"]
            for e in r["grads"].values()])

    @staticmethod
    def family_config(arch, layers, dtype=None):
        """``arch``'s published config at ``layers`` layers (None: all of
        them; seamless's encoder cut alike) and, if given, ``dtype``."""
        import dataclasses

        from repro_torch.configs import get_config

        cfg = get_config(arch)
        changes = {} if dtype is None else {"dtype": dtype}
        if layers is not None:
            changes["num_layers"] = layers
            if cfg.is_encdec:
                changes["encoder_layers"] = min(layers, cfg.encoder_layers)
        return dataclasses.replace(cfg, **changes)

    @staticmethod
    def family_batch(cfg, seq):
        """The batch a family trains on, 2 x ``seq`` positions: the VLM's
        is ``synthetic_batch`` (train() refuses the VLM: the reference's
        own train() fails on its labels), every other one
        ``SyntheticLMStream``'s first, as ``train()`` draws it."""
        from repro_torch import models as M
        from repro_torch.configs import ShapeSpec
        from repro_torch.data import SyntheticLMStream, device_put_batch

        shape = ShapeSpec("train", "train", seq, 2)
        if cfg.frontend == "vision":
            return M.synthetic_batch(cfg, shape, seed=0, device="cuda")
        return device_put_batch(SyntheticLMStream(cfg, shape).batch_at(0),
                                "cuda")

    def gradient_of(self, cfg, params, batch, *, plain, rows=False,
                    remat=None):
        """The gradient tree of ``forward_loss`` at ``params`` (a stacked
        tree, which this call's model views), through the kernels or, with
        ``plain``, their plain versions. With ``rows``, accumulated a batch
        row at a time (the batch's rows hold equal numbers of counted
        targets, so the halves' mean is the whole batch's loss): the plain
        attention's f32 probabilities over 5,760 positions then fit beside
        the model.
        ``remat`` (None: the config's) changes memory, never values.
        Returns (loss, gradient tree)."""
        import contextlib

        from repro_torch.models import transformer as MT

        model = MT.TransformerLM.from_stacked(cfg, params)
        grads = MT.bind_stacked_grads(model, params)
        parts = ([{k: t[i:i + 1] for k, t in batch.items()}
                  for i in range(batch["tokens"].shape[0])] if rows
                 else [batch])
        loss = 0.0
        with (plain_training() if plain else contextlib.nullcontext()):
            for part in parts:
                lp, _ = MT.forward_loss(cfg, model, part, remat=remat)
                (lp / len(parts)).backward()
                loss += float(lp.detach()) / len(parts)
        return loss, grads

    def family_model_check(self, arch, layers):
        """``arch`` at full width, ``layers`` deep, in f32, 2 x CHECK_SEQ
        positions: ``forward_loss`` and every gradient leaf through the
        kernels against the same through the plain versions (a MoE's
        routing held to the kernels' run)."""
        import torch
        from repro_torch._tree import flatten, leaves
        from repro_torch.models import transformer as MT

        t0 = time.perf_counter()
        cfg = self.family_config(arch, layers, "float32")
        params = MT.init_param_tree(cfg, device="cuda")
        if cfg.family == "ssm":  # so that the shifts and the bonus count
            shift_rwkv(cfg, MT.TransformerLM.from_stacked(cfg, params))
        batch = self.family_batch(cfg, CHECK_SEQ)
        before, nb = lm_launches(), backward_launches()
        with held_routing(cfg) as routing:
            if routing is not None:
                routing.record()
            loss, got = self.gradient_of(cfg, params, batch, plain=False)
            n = {**launches_since(before), **backward_since(nb)}
            got = [g.clone() for g in leaves(got)]
            if routing is not None:
                routing.hold(routing.recorded.__getitem__)
            plain_loss, want = self.gradient_of(cfg, params, batch,
                                                plain=True)
        want = flatten(want)
        errs = leaf_errs(got, want)
        worst_leaf = max(errs, key=errs.get)
        worst = errs[worst_leaf]
        limit = FAMILY_GRAD_RTOL.get(arch, FAMILY_GRAD_RTOL_DEFAULT)
        ulp_spread = None
        if arch in FAMILY_ULP_LOOK:
            with nudged_embedding(params):  # remat changes no value
                _, moved = self.gradient_of(cfg, params, batch, plain=True,
                                            remat="none")
            ulp_spread = leaf_errs(leaves(moved), want)
            del moved
        rel = abs(loss - plain_loss) / abs(plain_loss)
        self.check(rel <= TRAIN_LOSS_RTOL, f"family_model_check {arch}: loss "
                                           f"{loss} vs plain {plain_loss}")
        self.check(worst <= limit,
                   f"family_model_check {arch}: a gradient leaf {worst} of "
                   f"its max |g| from plain's")
        self.check(all(float(b.abs().max()) > 0 for _, b in want),
                   f"family_model_check {arch}: a leaf without a gradient")
        self.check(n == train_launches(cfg), f"family_model_check {arch}: "
                                             f"launches {n}, the code gives "
                                             f"{train_launches(cfg)}")
        emit({"phase": "family_model_check", "arch": arch,
              "dtype": "float32", "layers": cfg.num_layers,
              "encoder_layers": cfg.encoder_layers, "tokens": [2, CHECK_SEQ],
              "remat": cfg.remat, "loss": loss, "plain_loss": plain_loss,
              "loss_rel_err": rel, "leaves": len(got),
              "worst_grad_err_over_leaf_max": worst, "worst_leaf": worst_leaf,
              "grad_err_over_leaf_max": errs,
              "limits": {"loss": TRAIN_LOSS_RTOL, "grad": limit},
              "plain_moved_by_an_embedding_ulp": ulp_spread,
              "launches": n,
              "routing": routing.stats() if routing is not None else None,
              "seconds": time.perf_counter() - t0, "card": self.card})
        del params, got, want
        torch.cuda.empty_cache()

    def family_bf16_check(self, arch, layers, seq):
        """One bf16 step's gradient of ``arch`` at full width, ``layers``
        deep (TRAIN_FAMILIES' bf16 check depth), 2 x ``seq`` positions,
        leaf by leaf:
        its L2 distance from the f32 gradient of the plain versions at the
        same weights (cast up), through the kernels and through the plain
        versions in bf16; the kernels' at most FAMILY_BF16_RATIO times
        plain's. A MoE runs under ``HeldRouting``, both bf16 runs routed
        as the f32 one: a random-init router's near-ties move bf16
        routing. The VLM's gradients are accumulated a row at a time. The
        RWKV model's plain runs keep every activation (remat none), so its
        2,048-token plain WKV runs once a layer, not twice. RWKV's weights
        are ``shift_rwkv``'s, as in its f32 check. At its 24 layers plain
        bf16's gradient is nearly as far from f32 as a zero gradient on
        most leaves, so the ratio can fail a wrong B4 backward only through
        the leaves it leaves informative (the decays'); for the archs of
        FAMILY_F32_AT_DEPTH the same weights also go through the kernels
        in f32, each leaf held to the plain f32 gradient within
        FAMILY_DEPTH_ULP_FACTOR times what a one-ulp nudge of the embedding
        moves that gradient (at least the arch's FAMILY_GRAD_RTOL)."""
        import gc

        import torch
        from repro_torch._tree import flatten, tree_map
        from repro_torch.models import transformer as MT

        t0 = time.perf_counter()
        cfg = self.family_config(arch, layers)
        cfg32 = self.family_config(arch, layers, "float32")
        batch = self.family_batch(cfg, seq)
        rows = cfg.frontend == "vision"

        def free():
            gc.collect()
            torch.cuda.empty_cache()

        def init():  # RWKV's on shift_rwkv's weights, as its f32 check
            params = MT.init_param_tree(cfg, device="cuda")
            if cfg.family == "ssm":
                shift_rwkv(cfg, MT.TransformerLM.from_stacked(cfg, params))
            return params

        err, plain_err = {}, {}
        with held_routing(cfg) as routing:
            if routing is not None:
                routing.record()
            params = tree_map(lambda t: t.float(), init())
            plain_remat = "none" if cfg.family == "ssm" else None
            loss32, f32 = self.gradient_of(cfg32, params, batch, plain=True,
                                           rows=rows, remat=plain_remat)
            depth32 = None
            if arch in FAMILY_F32_AT_DEPTH:
                depth32 = self.f32_at_depth(arch, cfg32, params, batch,
                                            flatten(f32), plain_remat)
            del params
            f32 = [g for _, g in flatten(f32)]
            free()
            losses = {}
            for plain, into in ((False, err), (True, plain_err)):
                if routing is not None:
                    routing.hold(routing.recorded.__getitem__)
                params = init()
                losses[plain], grads = self.gradient_of(
                    cfg, params, batch, plain=plain, rows=rows,
                    remat=plain_remat if plain else None)
                for ref, (path, g) in zip(f32, flatten(grads)):
                    into["/".join(map(str, path))] = float(
                        (g.float() - ref).norm() / ref.norm())
                del params, grads
                free()
            stats = routing.stats() if routing is not None else None
        del f32
        free()
        ratio = {k: err[k] / plain_err[k] for k in err}
        worst = max(ratio, key=ratio.get)
        if depth32 is not None:
            over = {k: e for k, e in depth32["grad_err_over_leaf_max"].items()
                    if e > depth32["limits"][k]}
            self.check(not over, f"family_bf16_check {arch}: f32 at depth, "
                                 f"leaves over their limits: {over}")
        self.check(len(err) == len(plain_err) > 0 and all(
            r <= FAMILY_BF16_RATIO for r in ratio.values()),
                   f"family_bf16_check {arch}: leaf {worst} {err[worst]} "
                   f"from f32, plain bf16's {plain_err[worst]}")
        emit({"phase": "family_bf16_check", "arch": arch,
              "layers": cfg.num_layers, "dtype": cfg.dtype,
              "remat": cfg.remat, "tokens": [2, seq],
              "rows_at_a_time": rows, "f32_plain_loss": loss32,
              "loss": losses[False], "plain_loss": losses[True],
              "leaves": len(err), "grad_rel_l2_from_f32": err,
              "plain_bf16_grad_rel_l2_from_f32": plain_err,
              "worst_leaf": worst, "worst_ratio": ratio[worst],
              "limit": FAMILY_BF16_RATIO, "routing": stats,
              "f32_at_depth": depth32,
              "seconds": time.perf_counter() - t0, "card": self.card})

    def f32_at_depth(self, arch, cfg32, params, batch, want, plain_remat):
        """``cfg32``'s gradient at ``params`` through the kernels, each leaf
        against ``want`` (the plain f32 gradient, ``flatten``ed), and the
        plain gradient again with the embedding nudged by one ulp: each
        leaf's limit is FAMILY_DEPTH_ULP_FACTOR times how far that moves
        it, at least the arch's FAMILY_GRAD_RTOL."""
        from repro_torch._tree import leaves

        loss, got = self.gradient_of(cfg32, params, batch, plain=False)
        errs = leaf_errs(leaves(got), want)
        del got
        with nudged_embedding(params):
            _, moved = self.gradient_of(cfg32, params, batch, plain=True,
                                        remat=plain_remat)
        spread = leaf_errs(leaves(moved), want)
        del moved
        floor = FAMILY_GRAD_RTOL.get(arch, FAMILY_GRAD_RTOL_DEFAULT)
        return {"loss": loss, "grad_err_over_leaf_max": errs,
                "plain_moved_by_an_embedding_ulp": spread,
                "limits": {k: max(floor, FAMILY_DEPTH_ULP_FACTOR * v)
                           for k, v in spread.items()}}

    def family_train(self, arch, layers, seq):
        """``arch`` trained at full width, ``layers`` deep (None: all), in
        bf16, remat full, AdamW at lr 1e-3, seeded 0: ``launch.train.train``
        for FAMILY_TRAIN's steps of 2 x ``seq`` tokens, or, for the VLM,
        which ``train()`` refuses, ``train_step`` on ``synthetic_batch``.
        Metered on the GPU's power counter; each kernel's launches a step
        held to the count the code gives (``train_launches``)."""
        import contextlib
        import gc
        import io
        import math
        import re

        import torch
        from repro_torch.launch.steps import init_train_state
        from repro_torch.launch.train import train, train_step
        from repro_torch.models import transformer as MT
        from repro_torch.optim import AdamWConfig

        t0 = time.perf_counter()
        cfg = self.family_config(arch, layers)
        steps = FAMILY_TRAIN["steps"]
        per_step = train_launches(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log = io.StringIO()

        def by_step():
            state = init_train_state(cfg)
            model = MT.TransformerLM.from_stacked(cfg, state["params"])
            grads = MT.bind_stacked_grads(model, state["params"])
            batch = self.family_batch(cfg, seq)
            losses, ms = [], []
            for _ in range(steps):
                t = time.perf_counter()
                m = train_step(cfg, model, state, grads, batch,
                               AdamWConfig(lr=1e-3))
                losses.append(float(m["loss"]))
                ms.append(round(1e3 * (time.perf_counter() - t)))
            print(" ".join(f"({x} ms)" for x in ms))
            return {"losses": losses, "steps": steps}

        reset_all_launches()
        before = lm_launches()
        with contextlib.redirect_stdout(log):
            out, seconds, ws, samples = metered(
                by_step if cfg.frontend == "vision" else lambda: train(
                    cfg, use_reduced=False, log_every=1, steps=steps,
                    global_batch=2, seq_len=seq))
        counts = {**launches_since(before), **backward_launches()}
        peak = torch.cuda.max_memory_allocated()
        self.path_launches[f"{arch} train"] = counts
        step_ms = [int(m) for m in re.findall(r"\((\d+) ms\)",
                                              log.getvalue())]
        losses = out["losses"]
        after = sorted(step_ms[1:])
        steady = after[len(after) // 2] if after else None
        self.check(counts == {k: v * steps for k, v in per_step.items()},
                   f"train {arch}: launches {counts}, the code gives "
                   f"{per_step} a step x {steps}")
        self.check(out["steps"] == steps and all(
            math.isfinite(x) for x in losses), f"train {arch}: losses "
                                               f"{losses}")
        lnv = math.log(cfg.vocab_size)
        first = expected_first_loss(cfg)
        self.check(abs(losses[0] - first) <= FIRST_LOSS_ATOL,
                   f"train {arch}: first loss {losses[0]}, random init "
                   f"gives {first}")
        tokens = 2 * seq
        emit({"phase": "family_train", "arch": arch, "layers": cfg.num_layers,
              "encoder_layers": cfg.encoder_layers, "dtype": cfg.dtype,
              "remat": cfg.remat, "steps": steps, "global_batch": 2,
              "seq_len": seq, "entry": ("train_step on synthetic_batch"
                                        if cfg.frontend == "vision"
                                        else "launch.train.train"),
              "losses": losses, "ln_vocab": lnv,
              "expected_first_loss": first,
              "first_loss_limit": FIRST_LOSS_ATOL, "step_ms": step_ms,
              "median_step_ms_after_first": steady,
              "tokens_per_s": 1e3 * tokens / steady if steady else None,
              "seconds_metered": seconds, "metered_gpu_ws": ws,
              "metered_gpu_ws_per_step": ws / steps if ws else ws,
              "trace_samples": samples,
              "max_memory_allocated_gb": peak / 1e9,
              "launches": counts, "launches_per_step": per_step,
              "seconds": time.perf_counter() - t0, "card": self.card})
        del out
        gc.collect()
        torch.cuda.empty_cache()
        if arch in FAMILY_PROFILED:
            self.train_profile(cfg, self.family_batch(cfg, seq))

    def train_profile(self, cfg, batch):
        """One train step of ``cfg`` on ``batch`` profiled (after two to
        warm up), on a state of its own, and split into forward, backward
        and optimizer by CUDA events at each part's start."""
        import gc

        import torch
        from repro_torch.launch.steps import init_train_state
        from repro_torch.launch.train import train_step
        from repro_torch.models import transformer as MT
        from repro_torch.optim import AdamWConfig

        state = init_train_state(cfg)
        model = MT.TransformerLM.from_stacked(cfg, state["params"])
        grads = MT.bind_stacked_grads(model, state["params"])
        events: dict = {}

        def mark(part):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[part] = ev

        run = functools.partial(train_step, cfg, model, state, grads, batch,
                                AdamWConfig(lr=1e-3), mark)
        nb = flash_backward_launches()
        self.profiled("train_profile", "step", run, 1, arch=cfg.name,
                      layers=cfg.num_layers, global_batch=2,
                      seq_len=batch["tokens"].shape[1])
        torch.cuda.synchronize()
        # two steps to warm up and the profiled one
        nb = flash_backward_launches() - nb
        want = 3 * train_launches(cfg)["flash_attention_backward"]
        self.check(nb == want, f"train_profile {cfg.name}: B3's backward "
                               f"launched {nb} times, the code gives {want}")
        parts = ("forward", "backward", "optimizer", "end")
        emit({"phase": "train_profile_split", "arch": cfg.name,
              "flash_attention_backward_launches": nb,
              "device_timeline_ms": {
                  a: events[a].elapsed_time(events[b])
                  for a, b in zip(parts, parts[1:])},
              "note": "CUDA events at each part's start, on the device's "
                      "timeline, gaps included; host time is the profiled "
                      "wall less the device time of train_profile",
              "card": self.card})
        del state, model, grads, batch, run, events
        gc.collect()
        torch.cuda.empty_cache()

    def families_train(self):
        """Slice 7b's paths and checks, family by family: the f32 model
        check, the bf16 gradient at depth, then the training run."""
        for arch, layers, check_layers, bf16_layers, seq in TRAIN_FAMILIES:
            self.family_model_check(arch, check_layers)
            self.family_bf16_check(arch, bf16_layers or layers, seq)
            self.family_train(arch, layers, seq)

    def mesh(self):
        """The 1x1 ("data", "model") mesh of slice 7c's phases, over a
        process group of one rank (NCCL), made once."""
        if getattr(self, "_mesh", None) is None:
            from repro_torch.launch.mesh import make_mesh_compat
            self._mesh = make_mesh_compat((1, 1), ("data", "model"))
        return self._mesh

    def mesh_train_check(self):
        """llama3.2-3b at full width, MESH_CHECK_LAYERS deep, f32, on the 1x1
        mesh: ``build_train_step`` at MESH_ACCUM microbatches over MESH's
        rows, one step from ``init_train_state``'s seeded state through the
        kernels and one through the plain versions, for each of
        MESH_CHECK_VARIANTS: AdamW, AdamW after int8 gradient compression,
        Adafactor (state from ``init_factored_state``). Held leaf by leaf:
        AdamW's gradient (its first moment after the step over 1 - b1) and
        Adafactor's row and column means ``vr``, ``vc`` within
        TRAIN_GRAD_RTOL of each leaf's max; each updated parameter, the
        compressed runs' first moment and error feedback ``ef`` (on 254
        times its max, its int8 grid's span) and Adafactor's bf16 first
        moment (beyond one bf16 ulp of each element) by the outlier rule
        (MESH_OUTLIERS within MESH_OUTLIER_RTOL, MESH_FLIP_RTOL for the
        compressed run); the loss and AdamW's grad
        norm; and the kernels' launches, the code's count for a step of
        one microbatch times MESH_ACCUM."""
        import dataclasses
        import gc

        self.start_dryrun_child()  # on the host, beside this phase's card

        import torch
        from repro_torch._tree import flatten
        from repro_torch.configs import ShapeSpec, get_config
        from repro_torch.data import SyntheticLMStream, device_put_batch
        from repro_torch.launch.steps import (build_train_step,
                                              init_train_state, place)
        from repro_torch.optim.adafactor import init_factored_state
        from repro_torch.parallel.layouts import rules_for
        from repro_torch.parallel.sharding import GATHER, MODEL, full, use_mesh

        mesh = self.mesh()
        base = dataclasses.replace(get_config(ARCH),
                                   num_layers=MESH_CHECK_LAYERS,
                                   dtype="float32", accum=MESH_ACCUM)
        shape = ShapeSpec("mesh", "train", MESH["seq_len"],
                          MESH["global_batch"])
        batch = device_put_batch(SyntheticLMStream(base, shape).batch_at(0),
                                 "cuda")
        layers_n = base.num_layers
        want_n = {"rms_norm": 4 * layers_n + 1,
                  "rms_norm_backward": 2 * layers_n + 1,
                  "flash_attention": 2 * layers_n,
                  "flash_attention_backward": layers_n}

        def run(cfg, compress):
            rules = rules_for(cfg, shape, mesh)
            prog = build_train_step(cfg, shape, mesh, rules,
                                    compress_grads=compress)
            state = init_train_state(cfg, device="cuda",
                                     compress_grads=compress)
            if cfg.optimizer == "adafactor":
                state["opt"] = init_factored_state(state["params"])
            state = place(state, prog.in_shardings[0])
            with use_mesh(mesh, rules):
                state, m = prog.jitted()(state, batch)
            torch.cuda.synchronize()
            leaves_of = {"params": state["params"], "ef": state.get("ef"),
                         **state["opt"]}
            out = {k: [full(v) for _, v in flatten(t)]
                   for k, t in leaves_of.items()
                   if t is not None and k != "count"}
            return out, {k: float(v) for k, v in m.items()}

        def errs(got, want, mul=1.0):
            """(worst error over a leaf's scale, the largest share of a
            leaf beyond TRAIN_GRAD_RTOL); the scale is ``mul`` times the
            leaf's max |plain value|, and a bf16 leaf's element within one
            bf16 ulp of its own counts no error."""
            worst, share = 0.0, 0.0
            for a, b in zip(got, want):
                if b.numel() == 0:  # a vector's vc placeholder
                    continue
                err = (a.float() - b.float()).abs()
                if b.dtype == torch.bfloat16:
                    err = torch.where(err <= b.float().abs() * 2.0 ** -7,
                                      torch.zeros_like(err), err)
                err = err / (mul * b.float().abs().max().clamp_min(1e-30))
                worst = max(worst, float(err.max()))
                share = max(share, float((err > TRAIN_GRAD_RTOL).float()
                                         .mean()))
            return worst, share

        for variant in MESH_CHECK_VARIANTS:
            compress = variant == "compress_grads"
            cfg = (dataclasses.replace(base, optimizer="adafactor")
                   if variant == "adafactor" else base)
            before, nb = lm_launches(), backward_launches()
            GATHER.reset()
            MODEL.reset()
            got, gm = run(cfg, compress)
            n = {**launches_since(before), **backward_since(nb)}
            gathers = GATHER.counts()
            region = MODEL.counts()
            with plain_training():
                want, wm = run(cfg, compress)
            # held within TRAIN_GRAD_RTOL of each leaf's max, or by the
            # outlier rule
            strict = {"adamw": ("m",), "compress_grads": (),
                      "adafactor": ("vr", "vc")}[variant]
            outlier_err = (MESH_FLIP_RTOL if compress
                           else MESH_OUTLIER_RTOL)
            read = {k: errs(got[k], want[k], 254.0 if k == "ef" else 1.0)
                    for k in sorted(got)}
            for k, (worst, share) in read.items():
                if k in strict:
                    self.check(worst <= TRAIN_GRAD_RTOL,
                               f"mesh_train_check {variant}: a {k} leaf "
                               f"{worst} of its max from plain's")
                else:
                    self.check(share <= MESH_OUTLIERS
                               and worst <= outlier_err,
                               f"mesh_train_check {variant}: {k}: {share} "
                               f"of a leaf beyond {TRAIN_GRAD_RTOL} of its "
                               f"max, the worst {worst}")
            rel = abs(gm["loss"] - wm["loss"]) / abs(wm["loss"])
            norm_rel = (abs(gm["grad_norm"] - wm["grad_norm"])
                        / wm["grad_norm"] if "grad_norm" in wm else 0.0)
            self.check(sorted(gm) == sorted(wm) and rel <= TRAIN_LOSS_RTOL
                       and norm_rel <= TRAIN_GRAD_RTOL,
                       f"mesh_train_check {variant}: metrics {gm} vs plain "
                       f"{wm}")
            self.check(all(n[k] == v * MESH_ACCUM
                           for k, v in want_n.items()),
                       f"mesh_train_check {variant} launches {n}, the code "
                       f"gives {want_n} a microbatch x {MESH_ACCUM}")
            self.check(gather_held(gathers, cfg, 1),
                       f"mesh_train_check {variant}: gathers {gathers}, the "
                       f"code gives {mesh_gather_calls(cfg)} calls a step "
                       f"and no copy on a 1x1 mesh")
            self.check(region == NO_REGION,
                       f"mesh_train_check {variant}: model collectives "
                       f"{region} on a 1x1 mesh")
            emit({"phase": "mesh_train_check", "arch": ARCH,
                  "variant": variant, "optimizer": cfg.optimizer,
                  "compress_grads": compress, "dtype": "float32",
                  "layers": layers_n, "mesh": {"data": 1, "model": 1},
                  "accum": MESH_ACCUM, "tokens": [MESH["global_batch"],
                                                  MESH["seq_len"]],
                  "remat": cfg.remat, "entry": "launch.steps.build_train_step",
                  "loss": gm["loss"], "plain_loss": wm["loss"],
                  "loss_rel_err": rel, "grad_norm": gm.get("grad_norm"),
                  "plain_grad_norm": wm.get("grad_norm"),
                  "worst_err_over_leaf_max": {k: v[0]
                                              for k, v in read.items()},
                  "share_beyond_grad_limit": {k: v[1]
                                              for k, v in read.items()},
                  "held_strictly": list(strict),
                  "limits": {"loss": TRAIN_LOSS_RTOL, "grad": TRAIN_GRAD_RTOL,
                             "outliers": MESH_OUTLIERS,
                             "outlier_err": outlier_err},
                  "launches": n, "launches_per_microbatch": want_n,
                  "gathers_per_step": gathers, "model_collectives": region,
                  "gather_calls_code": mesh_gather_calls(cfg),
                  "card": self.card})
            del got, want
            gc.collect()
            torch.cuda.empty_cache()

    def mesh_prefill(self):
        """``build_prefill_step`` on the 1x1 mesh: llama3.2-3b at full
        width, CHECK_LAYERS deep, f32, over MESH_PREFILL_ROWS rows of
        MESH's length, from ``init_param_tree``'s seeded parameters. On
        one rank it is ``forward`` on the state's own storage: its logits
        must equal ``forward``'s on the same parameters bit for bit, with
        no collective of the model region or its sequence split
        (``MODEL``)."""
        import dataclasses

        import torch
        from repro_torch.configs import ShapeSpec, get_config
        from repro_torch.launch.steps import build_prefill_step, place
        from repro_torch.models import synthetic_batch
        from repro_torch.models import transformer as T
        from repro_torch.parallel.layouts import rules_for
        from repro_torch.parallel.sharding import MODEL, full, local, \
            use_mesh

        mesh = self.mesh()
        cfg = dataclasses.replace(get_config(ARCH), num_layers=CHECK_LAYERS,
                                  dtype="float32")
        shape = ShapeSpec("mesh_prefill", "prefill", MESH["seq_len"],
                          MESH_PREFILL_ROWS)
        batch = synthetic_batch(cfg, shape, device="cuda")
        params = T.init_param_tree(cfg, device="cuda")
        rules = rules_for(cfg, shape, mesh)
        prog = build_prefill_step(cfg, shape, mesh, rules)
        placed = place(params, prog.in_shardings[0])
        MODEL.reset()
        torch.cuda.synchronize()
        # the step's peak above its arguments (parameters and batch) and
        # its output's bytes, as the dry run predicts them (phase dryrun);
        # the dry run's child, started by mesh_train_check, is stopped
        # while the step is timed
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with self.dryrun_child_stopped():
            t0 = time.perf_counter()
            with use_mesh(mesh, rules):
                out = prog.jitted()(placed, batch)
                logits = full(out)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        self.prefill_peak = torch.cuda.max_memory_allocated() - before
        self.prefill_out_bytes = local(out).numel() * out.element_size()
        del out
        region = MODEL.counts()
        want, _ = T.forward(cfg, T.TransformerLM.from_stacked(cfg, params),
                            batch)
        same = torch.equal(logits, want)
        self.check(same and bool(torch.isfinite(logits).all()),
                   f"mesh_prefill: the 1x1 prefill's logits are not "
                   f"forward's bit for bit (worst "
                   f"{float((logits - want).abs().max())})")
        self.check(region == NO_REGION,
                   f"mesh_prefill: model collectives {region} on a 1x1 "
                   f"mesh")
        emit({"phase": "mesh_prefill", "arch": ARCH, "layers": CHECK_LAYERS,
              "dtype": "float32", "mesh": {"data": 1, "model": 1},
              "tokens": [MESH_PREFILL_ROWS, MESH["seq_len"]],
              "entry": "launch.steps.build_prefill_step",
              "bit_equal_forward": same, "ms": ms,
              "peak_above_args_bytes": self.prefill_peak,
              "output_bytes": self.prefill_out_bytes,
              "model_collectives": region, "card": self.card})
        del logits, want, params, placed

    def start_dryrun_child(self):
        """Start the ``dryrun`` phase's child (DRYRUN_CHILD) on the host,
        where no phase waits for it: its fake world and fake tensors take
        no card, and its imports and first run take tens of seconds on the
        card's host."""
        import subprocess

        if getattr(self, "_dryrun_child", None) is None:
            env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                   "HOME": str(ROOT), "CUDA_VISIBLE_DEVICES": "",
                   "OMP_NUM_THREADS": "1"}
            self._dryrun_child = subprocess.Popen(
                [sys.executable, "-c", DRYRUN_CHILD,
                 json.dumps(DRYRUN_CELL)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env)
        return self._dryrun_child

    @contextlib.contextmanager
    def dryrun_child_stopped(self):
        """The dry run's child, if it still runs, stopped (SIGSTOP) within:
        a timed card step shares the host with nothing of this run."""
        import signal

        child = getattr(self, "_dryrun_child", None)
        running = child is not None and child.poll() is None
        if running:
            child.send_signal(signal.SIGSTOP)
        try:
            yield
        finally:
            if running:
                child.send_signal(signal.SIGCONT)

    def stop_children(self) -> None:
        child = getattr(self, "_dryrun_child", None)
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()

    def dryrun(self):
        """Slice 7d's dry run (``launch/dryrun.py``), in a child process on
        the host (a fake world is its process's one default group, never
        beside the mesh phases' NCCL group; it launches no kernel; started
        by ``mesh_train_check``, ``start_dryrun_child``): the
        ``mesh_prefill`` cell on a fake world of one rank, its predicted
        peak above the arguments (temporaries and outputs) held within
        DRYRUN_PEAK_RTOL of the peak ``mesh_prefill`` measured on the card,
        its temporaries alone within as much of that peak less the card's
        output bytes (the logits, most of the peak), its output's bytes
        equal and its collectives at 0, as the card's; then llama3.2-3b
        ``prefill_32k`` on the 16x16 world under ``rules_for``'s layout
        (``seq_inner`` on "model") and under ``sp``, rank 0 (under
        ``seq_inner`` the least causal work; ``python -m
        repro_torch.launch.dryrun --rank 15`` gives the most): its flops,
        bytes, collective wire bytes by kind and peak, counted on the
        host's fake world, no time."""
        child = self.start_dryrun_child()  # started by mesh_train_check
        stdout, stderr = child.communicate(timeout=DRYRUN_TIMEOUT_S)
        self.check(child.returncode == 0,
                   f"dryrun: the child failed: {stderr[-3000:]}")
        if child.returncode:
            return
        out = json.loads(stdout.strip().splitlines()[-1])
        cell = out["mesh_prefill"]
        mem = cell["memory"]
        predicted = mem["peak"] - mem["argument_size_in_bytes"]
        measured = getattr(self, "prefill_peak", None)
        ratio = predicted / measured if measured else None
        self.check(ratio is not None and abs(ratio - 1) <= DRYRUN_PEAK_RTOL,
                   f"dryrun: predicted peak above the arguments {predicted} "
                   f"B against mesh_prefill's measured {measured} B on the "
                   f"card")
        # the temporaries on their own: the logits, the output, are most of
        # the peak above the arguments
        out_bytes = getattr(self, "prefill_out_bytes", None)
        self.check(out_bytes == mem["output_size_in_bytes"],
                   f"dryrun: predicted output {mem['output_size_in_bytes']} "
                   f"B against the card's {out_bytes} B")
        temp = measured - out_bytes if measured and out_bytes else None
        temp_ratio = mem["temp_size_in_bytes"] / temp if temp else None
        self.check(temp_ratio is not None
                   and abs(temp_ratio - 1) <= DRYRUN_PEAK_RTOL,
                   f"dryrun: predicted temporaries "
                   f"{mem['temp_size_in_bytes']} B against the card's "
                   f"{temp} B (peak above the arguments less the output)")
        self.check(cell["collectives"]["count"] == 0,
                   f"dryrun: {cell['collectives']} collectives predicted on "
                   f"a 1x1 mesh, where the card issued none")
        self.check(all(r["status"] == "ok" for r in out["production"]),
                   f"dryrun: a production cell failed: {out['production']}")
        emit({"phase": "dryrun", "arch": ARCH,
              "entry": "launch.dryrun.dry_run, run_cell",
              "mesh_prefill": {
                  "mesh": cell["mesh"], "layers": CHECK_LAYERS,
                  "dtype": "float32",
                  "tokens": [MESH_PREFILL_ROWS, MESH["seq_len"]],
                  "predicted_peak_above_args_bytes": predicted,
                  "measured_peak_above_args_bytes": measured,
                  "ratio": ratio,
                  "predicted_temp_bytes": mem["temp_size_in_bytes"],
                  "measured_temp_bytes": temp, "temp_ratio": temp_ratio,
                  "limit_rtol": DRYRUN_PEAK_RTOL,
                  "memory": mem, "flops": cell["flops"],
                  "bytes": cell["bytes"], "kernels": cell["kernels"],
                  "collectives": cell["collectives"]},
              "prefill_32k_16x16": out["production"],
              "child_s": out["seconds"], "child_limit_s": DRYRUN_CHILD_S,
              "child_s_by_part": out["seconds_by_part"],
              "counted_on": "host, fake world",
              "card": self.card})

    def mesh_train(self):
        """``launch.train.train`` on llama3.2-3b at full width and depth in
        bf16 on the 1x1 mesh (MESH's steps, batch and length; the config's
        own accum, 4), metered on the GPU's power counter, its launches of
        B2, B3 and their gradient kernels held to the code's count a
        microbatch times 4 a step; then MESH_EXTRA_STEPS steps of
        ``build_train_step`` with int8 gradient compression, and of the
        Adafactor config (state from ``init_factored_state``), each timed
        by step, its peak memory read."""
        import contextlib
        import dataclasses
        import gc
        import io
        import math
        import re

        import torch
        from repro_torch.configs import ShapeSpec, get_config
        from repro_torch.data import SyntheticLMStream, device_put_batch
        from repro_torch.launch.steps import (build_train_step,
                                              init_train_state, place)
        from repro_torch.launch.train import train
        from repro_torch.optim.adafactor import init_factored_state
        from repro_torch.parallel.layouts import rules_for
        from repro_torch.parallel.sharding import GATHER, MODEL, use_mesh

        mesh = self.mesh()
        cfg = get_config(ARCH)
        accum, steps = cfg.accum, MESH["steps"]
        self.check(accum == MESH_ACCUM, f"mesh_train: {ARCH}'s accum {accum}")
        per_step = {k: v * accum for k, v in train_launches(cfg).items()}
        tokens = MESH["global_batch"] * MESH["seq_len"]
        first = expected_first_loss(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log = io.StringIO()
        reset_all_launches()
        GATHER.reset()
        MODEL.reset()
        before = lm_launches()
        with contextlib.redirect_stdout(log):
            out, seconds, ws, samples = metered(lambda: train(
                ARCH, use_reduced=False, mesh=mesh, log_every=1, **MESH))
        counts = {**launches_since(before), **backward_launches()}
        gathers = GATHER.counts()
        region = MODEL.counts()
        peak = torch.cuda.max_memory_allocated()
        self.path_launches[f"{ARCH} mesh train"] = counts
        step_ms = [int(m) for m in re.findall(r"\((\d+) ms\)",
                                              log.getvalue())]
        losses = out["losses"]
        steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2] \
            if len(step_ms) > 1 else None
        self.check(counts == {k: v * steps for k, v in per_step.items()},
                   f"mesh_train: launches {counts}, the code gives "
                   f"{per_step} a step x {steps}")
        self.check(out["steps"] == steps and all(
            math.isfinite(x) for x in losses)
            and abs(losses[0] - first) <= FIRST_LOSS_NATS,
            f"mesh_train: losses {losses}, the first expected near {first}")
        self.check(gather_held(gathers, cfg, steps),
                   f"mesh_train: gathers {gathers}, the code gives "
                   f"{mesh_gather_calls(cfg)} calls a step x {steps} and no "
                   f"copy on a 1x1 mesh")
        self.check(region == NO_REGION,
                   f"mesh_train: model collectives {region} on a 1x1 mesh")
        emit({"phase": "mesh_train", "arch": ARCH, "layers": cfg.num_layers,
              "dtype": cfg.dtype, "remat": cfg.remat, "accum": accum,
              "mesh": {"data": 1, "model": 1}, **MESH,
              "entry": "launch.train.train(mesh=...)", "losses": losses,
              "expected_first_loss": first, "step_ms": step_ms,
              "median_step_ms_after_first": steady,
              "tokens_per_s": (1e3 * tokens / steady if steady else None),
              "wall_s": out["wall_s"], "seconds_metered": seconds,
              "metered_gpu_ws": ws,
              "metered_gpu_ws_per_step": ws / steps if ws else ws,
              "trace_samples": samples,
              "max_memory_allocated_gb": peak / 1e9,
              "launches": counts, "launches_per_step": per_step,
              "gather_calls_per_step": gathers["calls"] / steps,
              "gather_bytes_copied_per_step": gathers["bytes_copied"] / steps,
              "gathers": gathers, "gather_calls_code": mesh_gather_calls(cfg),
              "model_collectives": region, "card": self.card})
        del out
        shape = ShapeSpec("train_cli", "train", MESH["seq_len"],
                          MESH["global_batch"])
        stream = SyntheticLMStream(cfg, shape)
        for variant in ("compress_grads", "adafactor"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            compress = variant == "compress_grads"
            vcfg = cfg if compress else dataclasses.replace(
                cfg, optimizer="adafactor")
            rules = rules_for(vcfg, shape, mesh)
            prog = build_train_step(vcfg, shape, mesh, rules,
                                    compress_grads=compress)
            state = init_train_state(vcfg, device="cuda",
                                     compress_grads=compress)
            if not compress:
                state["opt"] = init_factored_state(state["params"])
            state = place(state, prog.in_shardings[0])
            step = prog.jitted()
            vlosses, vms = [], []
            GATHER.reset()
            MODEL.reset()
            for i in range(MESH_EXTRA_STEPS):
                batch = device_put_batch(stream.batch_at(i), "cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with use_mesh(mesh, rules):
                    state, m = step(state, batch)
                vlosses.append(float(m["loss"]))
                vms.append(1e3 * (time.perf_counter() - t0))
            vpeak = torch.cuda.max_memory_allocated()
            vgathers = GATHER.counts()
            vregion = MODEL.counts()
            self.check(all(math.isfinite(x) for x in vlosses)
                       and abs(vlosses[0] - first) <= FIRST_LOSS_NATS,
                       f"mesh_train {variant}: losses {vlosses}, the first "
                       f"expected near {first}")
            self.check(gather_held(vgathers, vcfg, MESH_EXTRA_STEPS),
                       f"mesh_train {variant}: gathers {vgathers}, the code "
                       f"gives {mesh_gather_calls(vcfg)} calls a step and no "
                       f"copy on a 1x1 mesh")
            self.check(vregion == NO_REGION,
                       f"mesh_train {variant}: model collectives {vregion} "
                       f"on a 1x1 mesh")
            emit({"phase": "mesh_train", "arch": ARCH, "variant": variant,
                  "dtype": vcfg.dtype, "accum": vcfg.accum,
                  "optimizer": vcfg.optimizer, "compress_grads": compress,
                  "entry": "launch.steps.build_train_step", **MESH,
                  "steps": MESH_EXTRA_STEPS, "losses": vlosses,
                  "step_ms": vms, "max_memory_allocated_gb": vpeak / 1e9,
                  "gather_calls_per_step":
                      vgathers["calls"] / MESH_EXTRA_STEPS,
                  "gather_bytes_copied_per_step":
                      vgathers["bytes_copied"] / MESH_EXTRA_STEPS,
                  "model_collectives": vregion, "card": self.card})
            del prog, state, step
        gc.collect()
        torch.cuda.empty_cache()
        from repro_torch.launch.mesh import release_process_group
        release_process_group()
        self._mesh = None

    def mesh_serve(self):
        """``build_serve_step`` on llama3.2-3b at full width and depth in
        bf16 on the 1x1 mesh: MESH_SERVE's greedy steps from one seeded
        state (every cache row a seeded draw, the slots' positions spread
        over the cache) against ``decode_step`` on a copy of it, each side
        timed a step. On one rank the serve step is ``decode_step`` on the
        state's own storage: its logits, tokens and state must equal the
        single device's bit for bit, with no collective of the model
        region or the caches' sequence split (``MODEL``), no byte gathered
        (``GATHER``: the layer gather's 1 + 28 calls a step, each the
        state's own storage) and B2's launches (57 a step) the same on
        both sides."""
        import gc

        import torch
        from repro_torch._tree import flatten
        from repro_torch.configs import ShapeSpec, get_config
        from repro_torch.launch.mesh import release_process_group
        from repro_torch.launch.steps import build_serve_step, place
        from repro_torch.models import transformer as T
        from repro_torch.parallel.layouts import rules_for
        from repro_torch.parallel.sharding import GATHER, MODEL, use_mesh

        mesh = self.mesh()
        cfg = get_config(ARCH)
        slots, cache, steps = (MESH_SERVE[k] for k in
                               ("slots", "cache", "steps"))
        shape = ShapeSpec("mesh_serve", "decode", cache, slots)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = T.init_param_tree(cfg, gen, device="cuda")
        model = T.TransformerLM.from_stacked(cfg, params)
        state = T.init_decode_state(cfg, slots, cache, device="cuda")
        for leaf in state["kv"].values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                   device="cuda"))
        state["pos"].copy_(torch.arange(slots, device="cuda")
                           * ((cache - steps) // slots) + 7)
        other = {k: ({n: v.clone() for n, v in t.items()}
                     if isinstance(t, dict) else t.clone())
                 for k, t in state.items()}
        tokens = torch.randint(0, cfg.vocab_size, (slots,), generator=gen,
                               device="cuda", dtype=torch.int32)
        rules = rules_for(cfg, shape, mesh)
        prog = build_serve_step(cfg, shape, mesh, rules)
        step = prog.jitted()
        state = place(state, prog.in_shardings[1])
        sides = {}
        for side in ("serve_step", "decode_step"):
            tok, logits_seen, ms = tokens.clone(), [], []
            gc.collect()
            torch.cuda.empty_cache()
            GATHER.reset()
            MODEL.reset()
            before = lm_launches()
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if side == "serve_step":
                    with use_mesh(mesh, rules):
                        logits, state = step(params, state, tok)
                    logits = logits.to_local()
                else:
                    logits, other = T.decode_step(cfg, model, other, tok)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                logits_seen.append(logits.clone())
                tok = logits.argmax(-1).to(torch.int32)
            sides[side] = {"logits": logits_seen, "ms": ms,
                           "launches": launches_since(before),
                           "gathers": GATHER.counts(),
                           "region": MODEL.counts()}
        serve, single = sides["serve_step"], sides["decode_step"]
        self.path_launches[f"{ARCH} mesh serve"] = serve["launches"]
        equal_logits = all(torch.equal(a, b) for a, b in
                           zip(serve["logits"], single["logits"]))
        tokens_equal = all(torch.equal(a.argmax(-1), b.argmax(-1)) for a, b
                           in zip(serve["logits"], single["logits"]))
        state_equal = all(torch.equal(a.to_local(), b) for (_, a), (_, b) in
                          zip(flatten(state), flatten(other)))
        n = cfg.num_layers
        want_gathers = {"calls": steps * (1 + n), "bytes_copied": 0,
                        "all_gathers": 0, "reductions": 0,
                        "reduce_scatters": 0, "all_reduces": 0}
        self.check(equal_logits and tokens_equal and state_equal,
                   f"mesh_serve: the 1x1 serve step is not decode_step bit "
                   f"for bit (logits {equal_logits}, tokens {tokens_equal}, "
                   f"state {state_equal})")
        self.check(serve["region"] == NO_REGION,
                   f"mesh_serve: collectives {serve['region']} on a 1x1 mesh")
        self.check(serve["gathers"] == want_gathers,
                   f"mesh_serve: gathers {serve['gathers']}, the code gives "
                   f"{want_gathers}")
        self.check(serve["launches"]["rms_norm"]
                   == single["launches"]["rms_norm"] == steps * (2 * n + 1),
                   f"mesh_serve: B2 launched {serve['launches']} and "
                   f"{single['launches']}, the code gives {2 * n + 1} a step")
        med = {k: sorted(v["ms"][1:])[len(v["ms"][1:]) // 2]
               for k, v in sides.items()}
        emit({"phase": "mesh_serve", "arch": ARCH, "layers": n,
              "dtype": cfg.dtype, "mesh": {"data": 1, "model": 1},
              **MESH_SERVE, "entry": "launch.steps.build_serve_step",
              "bit_equal_logits": equal_logits,
              "greedy_tokens_equal": tokens_equal,
              "state_equal": state_equal,
              "step_ms": {k: v["ms"] for k, v in sides.items()},
              "median_step_ms_after_first": med,
              "launches": {k: v["launches"] for k, v in sides.items()},
              "gathers": serve["gathers"], "model_collectives":
              serve["region"], "card": self.card})
        del params, model, state, other, prog, step, sides
        gc.collect()
        torch.cuda.empty_cache()
        release_process_group()
        self._mesh = None

    def lm_kernel_launches(self):
        """Each LM kernel's launches in the kernels line: the sum over the
        main paths it ran on, kept apart in ``launches_by_path``. B4's two
        kernels are two entries: ``wkv`` counts the sequential kernel's
        launches (the wrapper's less the tensor-core kernel's), ``wkv_tc``
        the tensor-core kernel's; ``wkv_backward`` its backward's (both
        kernels; ``launches_tc`` the chunked one's),
        ``flash_attention_backward`` B3's and ``rms_norm_backward`` B2's
        gradient kernel's (the training paths')."""
        counted = {"rms_norm": lambda n: n["rms_norm"],
                   "rms_norm_backward":
                       lambda n: n.get("rms_norm_backward", 0),
                   "flash_attention": lambda n: n["flash_attention"],
                   "wkv": lambda n: n["wkv"] - n["wkv_tc"],
                   "wkv_tc": lambda n: n["wkv_tc"],
                   "wkv_backward": lambda n: n.get("wkv_backward", 0),
                   "flash_attention_backward":
                       lambda n: n.get("flash_attention_backward", 0)}
        for name, count in counted.items():
            by_path = {arch: count(n) for arch, n in self.path_launches.items()
                       if count(n)}
            self.kernels[name]["launches"] = sum(by_path.values())
            self.kernels[name]["launches_by_path"] = by_path
            self.check(bool(by_path), f"{name} never launched on a main path")
        # every B4 backward launch of the training paths went through the
        # chunked kernel
        b4 = self.kernels["wkv_backward"]
        b4["launches_tc"] = sum(n.get("wkv_backward_tc", 0)
                                for n in self.path_launches.values())
        self.check(b4["launches_tc"] == b4["launches"],
                   f"B4's backward: {b4['launches_tc']} of {b4['launches']} "
                   "main-path launches on the chunked kernel")
        # every B3 launch of the main paths went through the tensor cores
        b3 = self.kernels["flash_attention"]
        b3["launches_tc"] = sum(n["flash_attention_tc"]
                                for n in self.path_launches.values())
        self.check(b3["launches_tc"] == b3["launches"],
                   f"B3: {b3['launches_tc']} of {b3['launches']} main-path "
                   "launches on the tensor-core kernel")

    # -- slice 6b: the trace-based analysis on the card --------------------
    def analysis_phase(self):
        """(a) The kernel lint on the card (``kernel_lint.lint_card_cases``)
        at the shapes the main paths launch each kernel at: every launch
        captured through its real wrapper on fake CUDA tensors, linted, its
        library's ``<prefix>_plan`` held equal to the Python plan, and a
        line a launch with the kernel's registers, local bytes, static and
        dynamic shared memory and blocks an SM. (b) The three decode
        families at full width and the ragged runs' depths (llama3.2-3b and
        rwkv6-1.6b 1 layer, zamba2-7b its first group and a tail layer), 8
        slots, cache 1024: the walker's graph of ``decode_step`` on fake
        CUDA tensors of the same config, then one engine ``_step`` on the
        card under CUDA's sync debug mode: its synchronising calls (the
        warnings it raises) equal the walker's ``host-sync`` count, its
        kernel launches the walker's kernel nodes, and every state leaf but
        the position vector keeps its storage (``data_ptr``). Any error
        finding fails the run; nothing is caught."""
        import dataclasses
        import gc
        import warnings

        import torch
        from repro_torch._tree import flatten
        from repro_torch.analysis import graph_walk
        from repro_torch.analysis.kernel_lint import lint_card_cases
        from repro_torch.analysis.offload_lint import (
            _decode_shapes, fake_model, lint_graph_hazards)
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.runtime.serving import ServingEngine

        t0 = time.perf_counter()
        findings, rows = lint_card_cases()
        for row in rows:
            emit({"phase": "analysis_kernel", **row, "card": self.card})
        errors = [f.fid for f in findings if f.severity == "error"]
        self.check(not errors, f"analysis: error findings {errors}")
        emit({"phase": "analysis_kernels", "launches": len(rows),
              "findings": [f.fid for f in findings],
              "seconds": time.perf_counter() - t0, "card": self.card})

        slots, cache = 8, 1024
        for arch, layers in (("llama3.2-3b", RAGGED_LAYERS["llama3.2-3b"]),
                             ("rwkv6-1.6b", RAGGED_LAYERS["rwkv6-1.6b"]),
                             ("zamba2-7b", HYBRID_RAGGED_LAYERS)):
            t1 = time.perf_counter()
            cfg = dataclasses.replace(get_config(arch), num_layers=layers)
            mode = graph_walk.fake_mode()
            fstate, ftokens = _decode_shapes(cfg, slots, cache, mode)
            fake = fake_model(cfg, mode)
            report = graph_walk.trace_and_walk(
                lambda s, t: T.decode_step(cfg, fake, s, t), fstate,
                ftokens)
            walked = [f.fid for f in lint_graph_hazards(report, site=arch)
                      if f.rule == "host-sync"]
            nodes = {k: n for k, n in report.primitive_counts.items()
                     if graph_walk.classify_primitive(k) == "kernel"}
            walk_s = time.perf_counter() - t1
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            model = T.init_params(cfg, gen, device="cuda")
            engine = ServingEngine(cfg, model, slots=slots, max_len=cache,
                                   device="cuda")
            state = T.init_decode_state(cfg, slots, cache, device="cuda")
            tokens = torch.randint(0, cfg.vocab_size, (slots,),
                                   generator=gen, device="cuda",
                                   dtype=torch.int32)
            engine._step(model, state, tokens)  # warm
            torch.cuda.synchronize()
            before = {p: t.data_ptr() for p, t in flatten(state)}
            reset_all_launches()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    _, state = engine._step(model, state, tokens)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            launched = {k: n for k, n in lm_launches().items()
                        if n and not k.endswith("_tc")}
            # the mode's first use also warns that it is a prototype
            syncs = [str(w.message) for w in caught if "called a "
                     "synchronizing CUDA operation" in str(w.message)]
            moved = ["/".join(map(str, p)) for p, t in flatten(state)
                     if t.data_ptr() != before.get(p)]
            emit({"phase": "analysis_decode", "arch": arch,
                  "layers": layers, "slots": slots, "cache": cache,
                  "card_syncs": len(syncs), "syncs": syncs[:5],
                  "walker_host_syncs": len(walked),
                  "walker_flops": report.flops,
                  "walker_hbm_bytes": report.hbm_bytes,
                  "walker_nodes": report.eqn_count, "kernel_nodes": nodes,
                  "launches": launched, "state_leaves": len(before),
                  "moved": moved, "walk_s": walk_s,
                  "seconds": time.perf_counter() - t1, "card": self.card})
            self.check(len(syncs) == len(walked),
                       f"analysis {arch}: {len(syncs)} synchronising calls "
                       f"on the card, the walker's host-sync count "
                       f"{len(walked)}")
            self.check(launched == nodes,
                       f"analysis {arch}: launches {launched}, the walker's "
                       f"kernel nodes {nodes}")
            self.check(moved == ["pos"],
                       f"analysis {arch}: state leaves moved {moved}")
            del model, engine, state, tokens
            gc.collect()
            torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    smoke = Smoke()
    # f32 matmuls of the plain versions in full f32, as PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    for phase in (smoke.card_and_build, smoke.kernel_phase,
                  smoke.dense_kernel_phase, smoke.flash_offset_check,
                  smoke.rms_host_path,
                  smoke.wkv_kernel_phase, smoke.wkv_backward_check,
                  smoke.wkv_host_path, smoke.wkv_cycles,
                  smoke.dense_model_check,
                  smoke.dense_bf16_model_check, smoke.rwkv_model_check,
                  smoke.hybrid_model_check, smoke.hybrid_bf16_model_check,
                  smoke.moe_model_check, smoke.moe_bf16_model_check,
                  smoke.encdec_model_check, smoke.encdec_bf16_model_check,
                  smoke.vlm_model_check, smoke.vlm_bf16_model_check,
                  smoke.train_grad_check, smoke.family_grad_check,
                  smoke.train_model_check,
                  smoke.dense_main_path, smoke.placement_phase,
                  smoke.fleet_main_path, smoke.rwkv_main_path,
                  smoke.hybrid_main_path, smoke.moe_main_path,
                  smoke.encdec_main_path, smoke.vlm_main_path,
                  smoke.train_main_path, smoke.train_bf16_check,
                  smoke.families_train, smoke.train_resume,
                  smoke.mesh_train_check, smoke.mesh_prefill,
                  smoke.dryrun, smoke.mesh_train, smoke.mesh_serve,
                  smoke.lm_kernel_launches, smoke.analysis_phase,
                  smoke.main_path):
        t_phase = time.perf_counter()
        try:
            phase()
        except Exception:
            traceback.print_exc()
            smoke.failures.append(f"{phase.__name__} raised")
            break
        finally:
            emit({"phase": "phase_seconds", "name": phase.__name__,
                  "seconds": time.perf_counter() - t_phase})
    smoke.stop_children()
    seconds = time.perf_counter() - t_start
    smoke.check(seconds <= BUDGET_S, f"the run took {seconds} s, over its "
                                     f"budget of {BUDGET_S} s")
    emit({"phase": "done", "seconds": seconds, "failures": smoke.failures})
    if smoke.failures:
        return 1
    emit({"kernels": list(smoke.kernels.values())})
    print(smoke.card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
