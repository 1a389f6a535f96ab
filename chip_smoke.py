#!/usr/bin/env python3
"""Smoke check of the PyTorch port (osu_dreamer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout. It needs one CUDA card, ``nvcc`` for sm_90a and
nothing of JAX; without a card it exits nonzero and prints no result.

1. Builds the CUDA kernels from osu_dreamer_tpu_torch/csrc/ (one nvcc
   per source, in parallel; printing the build seconds: the twelve ported
   TPU kernels in eleven entries, the TP forms of K4, K6, K5, K2, K3, K11
   and K12, and the long attention backward)
   and holds each against its plain PyTorch version on the card (bf16; f32 for the
   resonator; TF32 off; the SwiGLU and film-layer forward kernels against
   the plain version in f32, within 1.1x mean / 1.5x max of the plain bf16
   path's error, and bit-identical on rerun), timing both with CUDA events
   (the flash attention, SwiGLU and film-layer forwards over replays of a
   CUDA graph of 20 calls, which leaves out the host's launch cost; every
   kernel's time beside its bound and achieved TFLOP/s, also at the widened
   widths: K4 at C 768, K2 at C 384, K6 at C 640, K3 at C 256 and 384,
   K11/K12 at C 640 and 1024, and at widths whose last 64-column box runs
   past C: K4 at C 96, K2 at C 32; the FFN and prologue backward kernels K3,
   K5, K6 and K12 and the fused attention K9/K10 also by graph replay, as
   their plain versions; the resonator K1 and the prologue forward K11 too,
   each also bit-identical on rerun) and, for the flash attention, torch's
   scaled_dot_product_attention as a yardstick: the
   inference kernels at the inference slice's shapes (the film layer also at
   latent training's B64 L1026; the flash attention also at B1 L2500, B4 L65
   and B1 L2049), the denoiser's training kernels (SwiGLU
   backward, fused attention forward and backward) at its training shape
   B128 L152 and at a ragged length (the fused attention also at the edges
   of one to four 64-row tiles, L 1, 63, 64, 65, 192, 193 and 256, its
   forward also without residuals, which must give the same output), the
   film-layer backward at latent
   training's four levels B64 L1026, L342, L114 and L38 (the top and bottom
   also with zero FiLM), the full SwiGLU backward (K5) at the width-384
   denoiser's B128 L152 C384 H1024, and the fused norm + FiLM + qkv prologue
   forward (K11) and backward (K12) at B128 L152 and B4 L759 (C 512, F 3072),
   ragged, and at C 384 (K11 also at L 1, 63, 64, 65 and 129, K12 at B3 L1
   C512, L129 C640 and L65 C1024, tiles straddling batch rows at every
   cluster width, and K11's y must equal K12's recomputed y bit for bit).
   The resonator at the request's S2 K20480, at S1 K1, S3 K63/64/65/129,
   S1 K20481 and at generate-data's S1 K10240 (one 60 s song) and S1
   K100352 (a 10-minute song), also within 1e-5 of an f64 doubling scan.
   The backward kernels' and K9's reruns must be bit-identical.
   Then K4 under five plans (output columns a CTA holds x hidden slices) at
   B4 L759 and B128 L152: graph-replay ms, the core kernel and the
   reduction of the split plans timed apart by torch.profiler. Then (1e)
   the seven TP forms (parallel/tp.py) on two slices of the hidden units
   (the prologue's on two slices of the heads):
   K4's and K6's at B128 L152 C512 (H 683 and 682), K5's at the width-384
   denoiser's B128 L152 C384 (H 512 and 512), K2's and K3's at the
   latent stage's four levels B64 L1026, L342, L114, L38 C128 (H 171 and
   170), K11's and K12's at B128 L152 C512 on 8 of 16 x 64 heads a slice
   (1536 qkv columns): each slice's first phase against its plain version in f32 (its
   f32 workspace, or dY partial and weight gradients, within GRAD_REL),
   the slices' sums through the second phase against the f32 plain
   one-rank function (the forwards within the f32 rule, beside the
   one-rank kernel too; the backwards within GRAD_REL), the ranks'
   finishes and every rerun bit-identical,
   one rank's form (both phases on its own partials) timed by graph replay
   beside its plain version and the bound of the slice's work. Then (1f)
   the attention kernels at head dims 32 and 128 (32 x 32 and 8 x 128
   heads, H D 1024 as shipped): K7/K8 at B4 L759, B4 L65 and B1 L2500, K9
   and K10 at B128 L152 and B2 L 1, 63, 64, 65, 192, 193 and 256; and the
   streamed kernels (csrc/attention_stream.cu) at head dims 12, 16, 40, 48,
   96, 192, 256 and 384: K7/K8 at eight heads of each at the same three
   shapes, K9 and K10 at 32 x 12, 8 x 16, 16 x 40, 8 x 48, 8 x 96, 2 x 192,
   2 x 256 and 2 x 384 heads at B2 L152, B2 L65 and B1 L1, at 8 x 64 heads
   at B2 L 257, 320 and 512 and 2 x 64 at B1 L2048, and at the slice's
   8 x 96 B64 L320 and 8 x 64 B64 L512; by the rules above (4 ulp,
   GRAD_REL, bit-identical reruns, the residual-free forward), timed by
   graph replay beside the plain version, the bound and (K7/K8) SDPA: every
   shape at head dims 32 and 128, each streamed head dim's first shape (and
   K8's B1 L2500) and each length. Then the streamed kernels' device ms by
   launch (prep, forward, dK/dV, dQ, post) under torch.profiler: K9 and K10
   at 8 x 96 B64 L320 and 8 x 64 B64 L512, K7 at 8 x 96 B4 L759. Then (1g)
   the long attention backward (the training counterpart of K7/K8 past the
   JAX gate; csrc/long_attention_bwd.cu's one pass to padded head dim 128,
   attention_stream.cu's launches past it) on the streamed forward's rows
   and lse: the shipped 16 x 64 heads at B64 L320 (phase 4f's step), then
   head dims 8, 12, 64, 96, 128, 256 and 384 at L 65, 320, 759 and 2500,
   each within GRAD_REL of the f32 autograd of the plain version and
   bit-identical on rerun; timed at L 320 (and D 64 at L 2500) by graph
   replay beside the plain version's autograd backward, the bound, torch's
   scaled_dot_product_attention backward and, to head dim 128, the
   two-launch design it replaced (its recorded times logged too), with both
   forward + backward sums logged; then both designs' device ms by launch
   at 16 x 64 B64 L320. Then (1h) the long route's q/k norm and RoPE
   (the streamed prep and post passes) at 16 x 64 heads, B40 L759 and B64 L320: the forward
   pass against the plain chain (4 ulp, v's copy exact), the backward pass
   from views of one packed gradient against the f32 autograd of the chain
   (GRAD_REL), both bit-identical on rerun, timed by graph replay beside the
   chain and its autograd backward.
2. Runs a small slice (2 short songs x 2 difficulties) through the kernels
   and through the plain versions in bf16, and holds both to the plain
   versions in f32. Its denoiser runs at L <= 256, so through the fused
   attention forward. Then once more through the kernels with
   OSU_DREAMER_FUSED_PROLOGUE=1 (K11 must launch), held to the same rule.
3. Runs the full-width slice (LDMArgs() defaults, seeded random weights,
   bf16): two synthetic 120 s songs x two difficulty rows, 32 denoiser
   steps, 16 style steps, once more with style guidance 2.0. The device part
   runs under torch.cuda.set_sync_debug_mode("error"), so a host sync inside
   the samplers fails the run; every inference kernel must launch (the flash
   attention and the SwiGLU 264 times a request, the film layer 48), the
   prologue kernels not. One more request runs under torch.profiler, which
   gives the device-busy, flash attention, SwiGLU and film-layer
   milliseconds of a request (and the resonator's: one launch a request).
   Then requests with OSU_DREAMER_FUSED_PROLOGUE=1: K11 must launch 264
   times a request; one under torch.profiler gives its device busy and K11's
   ms. Then an 8 x 64-head
   attention at L 300 (inside the JAX gate) answers through K9 and a 16 x
   64-head one (past it) through K7, each within the f32 rule; under
   autograd the second launches the streamed K7 with lse and the long
   attention backward once each.
3a. Runs ``predict`` (``cli.run_predict``) on phase 3's model from WAV files
   to .osz mapsets: two 120 s songs and one 30 s song written as 44.1 kHz
   stereo 16-bit WAV under build/smoke_predict/, rows 5 9 8 4 6 and
   3 7 6 3 5, 32 steps, --batch-songs 2 --serialize-workers 2 --seed 0,
   OSU_DREAMER_TIMING=1. The native library (slider fitter, WAV decoder,
   resampler) must load. The launches must be one resonator, 48 film
   layers and 264 SwiGLUs a batch and 264 of the attention kernel that
   attention_route names for each batch's latent length (K7 for the 120 s
   pair, K9 for the 30 s song); each .osz must hold its WAV and one .osu a
   row, each equal to decode_osu_entry run in this process on the chart
   run_predict fetched; a second run with the same seed must write the
   same texts; then one song with --snap-divisor 4 --serialize-workers 1.
   Prints the timing lines and the wall per map.
3c. Shards songs over two replicas of phase 3's model, on the one card
   (the replica list repeats it): ``predict --batch-songs 4`` on four 60 s
   songs (written at the model's rate) must print the JAX rule's
   ``[parallel]`` line and launch one resonator, 48 film layers and 264
   SwiGLUs and K7s a shard; then, at the sampler, the sharded charts must
   equal (within one quantization step) the one-device sampler's run on
   each shard's songs with the same noise and step-size mean, and the
   one-device sampler on the whole batch is logged beside both (its kernel
   plans and library products change with the rows a launch holds). Then
   ``serve`` over HTTP on one device and on the two replicas: /healthz
   ``devices`` 1 and 2, a warm-up burst, a timed burst of four unseeded
   two-row requests (launches one sampler run a shard, a dispatch split
   over both replicas) and one seeded request, whose .osu texts must be the
   same on both. Prints every wall beside the one-device wall.
4. Trains the denoiser at full width (the port's models/diffusion/config.yml:
   depth 8, width 512, 16 x 64 heads, batch 128 x 152, bf16 compute, f32
   parameters) through ``fit.run`` on a seeded synthetic cached-latent
   corpus written under build/: 2 warm-up steps and 20 timed steps, then EMA
   validation and the best/last checkpoints. Every loss must be finite and
   every training kernel must launch during the timed steps (the prologue
   kernels and K5 not); the last warm-up step runs under torch.profiler (it
   must launch what a timed step does), which gives the step's device-busy
   ms and the ms and launches of K6 (its two torch
   matmuls apart), K9 and K10. Then one step's loss and gradients through the
   kernels (bf16) and through the plain versions (bf16) are each held to a
   plain f32 step on the same batch, t and x0 (random full-strength weights).
4b. The same with ``backbone: {n_heads: 8, head_dim: 128}``: 2 warm-up and
   4 timed steps through ``fit.run`` on phase 4's corpus, exactly 8 K4, K6,
   K9 and K10 launches a step, no K7 and no plain attention on the card;
   then the one-step check at 8 x 128 and at 32 x 32 heads (8 K9 and 8
   K10 launches in the kernel step).
4c. ``predict`` with the denoiser at 8 x 128 heads (the shipped widths
   otherwise, init_random weights, the denoiser's randomized at full
   strength) on one 120 s song (K7, 264 launches) and one 30 s song (K9,
   264), no plain attention on the card.
4d. The same as 4b with ``backbone: {n_heads: 8, head_dim: 96}``,
   ``seq_len: 320`` and ``batch_size: 64`` (20,480 tokens a step): 2 warm-up
   and 4 timed steps through ``fit.run``, exactly 8 K4, K6, K9 and K10 (the
   streamed kernels) a step, no K7 and no plain attention on the card; then
   the one-step check at 8 x 96 B64 L320, 8 x 64 B32 L512 and 32 x 12 B128
   L152 (8 K9 and 8 K10 launches in each kernel step).
4e. ``predict`` as 4c at 8 x 96 heads: the 120 s song through K7 (the
   streamed kernel, 264 launches) and the 30 s one through K9 (264).
4f. The shipped denoiser (16 x 64 heads) at ``seq_len: 320`` and
   ``batch_size: 64`` (L H D 327,680, past the JAX gate): 2 warm-up and 4
   timed steps through ``fit.run``, exactly 8 K4, K6, K7 (the streamed
   forward with lse) and long attention backward launches a step, no K9,
   K10 or plain attention on the card, its ms/step logged beside 4d's;
   then the one-step check there (8 K7 and 8 long backward launches).
5. Trains the chart autoencoder at full width (the port's
   models/latent/config.yml: h_dim 128, 3 downs of stride 3, 8-layer stacks,
   16 x 64 style heads, batch 32 x 2052 split into 64 x 1026 halves, bf16
   compute, f32 parameters) through ``fit.run`` on a seeded synthetic
   chart-signal corpus written under build/: 2 warm-up steps and 20 timed
   steps, validation on two held-out mapsets and both checkpoints. Every
   loss must be finite and the film layer's forward and backward kernels
   must launch during the timed steps; the last warm-up step runs under
   torch.profiler (88 K2 and K3 launches, a timed step's: no validation
   pass in its window), which gives the step's device-busy ms and K3's row
   core and weight-product ms and launches. Then one step's loss terms and
   gradients through the kernels and through the plain versions (bf16) are
   each held to a plain f32 step on the same batch and draws, as in 4; and
   encode-latents runs on the card from the ``last`` checkpoint over the
   corpus, its h, z and s checked and read back by the latent pipeline.
   The stage's reconstruction figure (after validation, encoded and
   decoded on the card) must be logged once at the last step where
   matplotlib imports; the phase says which case it met and whether
   tensorboardX wrote it.
6. Trains the denoiser as in 4 on phase 4's corpus with
   OSU_DREAMER_FUSED_PROLOGUE=1, 2 warm-up and 10 timed steps, at the shipped
   width 512 (K11, K12, K4, K6, K9 and K10 must launch, K5 not) and at width
   384 (``backbone_dim: 384``; K5 instead of K6); at width 512 the last
   warm-up step runs under torch.profiler (device-busy ms, K12's and K11's ms and
   launches, as phase 4 gives K6's); each followed by the one-step check of
   4.
6b. Radius 0 (the JAX FFN without its depthwise conv, which the port runs
   on the FFN kernels with a unit tap): one step of the width-512 denoiser
   at ``radius: 0`` and one of the latent stage at ``stack.radius: 0``
   (its shipped B32 x L2052) through the kernels and through the plain versions, each
   held to the f32 plain step as in 4 and 5; the kernel steps must call K4
   and K6 8 times, K2 and K3 88 times, each with one tap.
7. Drives the training pipeline from audio through the functions the CLI
   commands call. build_library writes 12 synthetic mapsets of 60 s (3
   difficulties each) as 16,384 Hz WAV under build/; generate-data
   --songs-dir builds the dataset on the card (one K1 launch a mapset and no
   other kernel; one song's spec.npy within one uint8 step of make_spec on
   the CPU), and make_spec's ms a song is timed. fit-latent,
   encode-latents, fit-denoiser and fit-style then run at the widths of
   the shipped configs on the 27 training maps (3 mapsets held out), each
   batch cut to 8 and each stage to 6 steps (every loss finite, best and
   last written, the stage's training kernels launching, none for the
   style prior). export-inference runs in f32 and with --half, and
   load_inference on the card must give back the checkpoints' tensors (the
   latent stage's live, the others' EMA; their bf16 with --half) bit for
   bit. predict runs on the exported artifact over one song x 2 rows at 32
   steps with its launches counted; each .osu must parse with Beatmap or be
   refused only for a hold spanning the next onset, which the JAX
   serializer also writes from barely trained weights. Prints each step's
   wall.
8. Serves phase 3's model, written as a .odt under build/smoke_serve/,
   through ``serve``'s GeneratorService (device cuda, max_batch 4, 25 ms
   batch window, 2 decode workers) behind its HTTP front end on a socket:
   one warm-up request, then at once four unseeded requests with rows
   5 9 8 4 6 and 3 7 6 3 5 on two 60 s songs and one three-row request on
   a 60 s song, then one seeded request on a 30 s song (44.1 kHz stereo
   WAVs), 32 steps; /healthz, /stats, a bad diff (400) and an unknown path
   (404). Unless it already holds two, the burst's first dispatch holds the
   dispatcher until two two-row requests are queued behind it (their
   uploads' decoding spreads over the host's cores by more than a dispatch
   takes). Every 200 must be
   an .osz holding the WAV and one .osu a row; the two-row requests must
   share fewer dispatches than requests and the three-row one ride alone; /stats must count no error and no padded row;
   each dispatch must launch one resonator, 48 film layers, 264 SwiGLUs and
   264 of the attention kernel attention_route names (K7 for the 60 s
   songs, K9 for the 30 s one); the seeded request's .osu texts must equal
   decode_osu_entry of build_batch_sampler's chart on the service's model
   for the same wave, rows and seed. Prints each request's wall, their p50
   and max, maps a minute over the burst, and the batches and rows.
9. Trains on two ranks (``parallel/``): one card each where two are
   visible (NCCL), else both on card 0 over gloo, said before the phase.
   (a) ``fit-denoiser`` at the shipped config with ``parallel: {dp: 2}``
   through ``fit.run``, which spawns the ranks, 6 steps; (b) the same with
   ``parallel: {sp: 2}`` (76 frames a rank: ring attention, the SwiGLU
   kernel on 80-row halo'd shards), 6 steps; (c) ``fit-latent`` at its
   shipped config with ``dp: 2``, 4 steps; (b) and (c) in one spawn of the
   script's own ranks. Every step of every rank must launch exactly K4,
   K6, K9 and K10 8 times under DP, K4 and K6 8 times and no K9/K10 under
   SP, K2 and K3 88 times in the latent step, and nothing else; the ranks'
   losses must be equal, and each fit checks that its ranks end with the
   same parameters bit for bit. Then one step of each (dp 2, sp 2, latent
   dp 2) on random full-strength weights is held to the f32 plain
   one-process step on the same batch and draws: its loss terms and
   averaged gradients within PARALLEL_RATIO of the one-process kernel
   step's error. Prints ms/step per rank (host clock after 2 warm-ups), the
   gradient all-reduce's ms and, under SP, the ring's and the halos' ms a
   step (CUDA events). Phases 4-7 set ``parallel: {dp: 1}``.
10. Trains with tensor parallelism on two ranks, placed as in 9: (a)
   ``fit-denoiser`` at the shipped config with ``parallel: {tp: 2}``
   through ``fit.run`` (8 of the 16 heads and 683/682 of the 1365 hidden
   units a rank), 6 steps, rank 0's gathered checkpoint read back into a
   one-process state; (b) ``fit-latent`` at its shipped config with
   ``tp: 2`` (171/170 of 341), 4 steps, in one spawn of the script's own
   ranks with the one-step checks; (c) ``fit-denoiser`` at width 384 with
   ``tp: 2`` through ``fit.run`` (512 of 1024 hidden units a rank), 6
   steps; (d) ``fit-denoiser`` at the shipped config with ``tp: 2`` and
   OSU_DREAMER_FUSED_PROLOGUE=1 through ``fit.run``, 6 steps. Every step of
   every rank must launch exactly the K4 and K6 TP forms (at width 384
   K4's and K5's) and K9/K10 8 times each (no one-rank K4/K6), in (d) also
   the K11 and K12 TP forms 8 times each (no one-rank K11/K12, no torch
   prologue), the K2 and K3 TP forms 88 times in the latent step, and
   nothing else; the denoiser's one-step checks run at widths 512, 384
   and 144 (the plain TP backward on the card, the one-rank route there),
   each launching the SwiGLU TP forms its route names, and at 512 with the
   prologue on (K11's and K12's TP forms 8 each); the ranks' losses must be equal, each fit checks its
   replicas (the whole-model leaves on every rank, the slices across the
   data group), and one step of each on random full-strength weights is
   held to the f32 plain one-process step within PARALLEL_RATIO of the
   one-process kernel step's error. Prints ms/step per rank (host clock
   after 2 warm-ups) and the TP all-reduces' ms a step (CUDA events).

Prints the card's name and power limit, one JSON line of per-kernel results
(the attention kernels' entries also by head dim and length: 64 from phase
1, the others from phase 1f with the launches of their main paths in 4b to
4e, the streamed kernels' entries naming their source), and
last ``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import functools
import io
import json
import shutil
import subprocess
import sys
import tempfile
import time
import wave
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
SONG_SECONDS = 120.0
DIFFS = [(5.0, 9.0, 8.0, 4.0, 6.0), (3.0, 5.0, 5.0, 4.0, 4.0)]  # predict's default + one
STEPS = 32  # denoiser steps; the style prior takes the LDM's default of 16

# bf16 kernels are held to 4 ulp of the largest reference magnitude: they
# round wherever the plain version rounds, but their products accumulate in
# another order, so an intermediate bf16 rounding can flip and pass through
# the next projection. The f32 resonator: 1e-5 absolute (states are O(1)).
BF16_ULPS = 4
F32_ATOL = 1e-5
# The small slice (charts and labels) runs three times on the same weights
# and noise: bf16 through the kernels, bf16 through the plain versions, and
# f32 through the plain versions (the reference). With random full-strength
# gains the 48 film layers amplify bf16 rounding, so the two bf16 runs differ
# from each other by about as much as each differs from the reference; the
# kernel path must stay about as close to the reference as the plain path.
SLICE_MEAN_RATIO = 1.1
SLICE_MAX_RATIO = 1.5
# The training kernels' gradients are held to autograd of the plain version
# in f32 on the same (bf16-valued) inputs: the max abs error must stay within
# GRAD_REL of the largest magnitude of the f32 gradient. The kernels compute
# the gradient of the bf16 forward in f32, so they differ from the f32
# reference by the forward's bf16 rounding: about 0.5-1.6 % of the largest
# magnitude at B128 L152, as the plain bf16 autograd does; weight gradients
# summed over B*L = 19,456 rows are no exception.
GRAD_REL = 0.03
TRAIN_WARMUP = 2
TRAIN_TIMED = 20
# the one-step comparison's floor for the loss terms: 1e-3 of the f32 value
LOSS_FLOOR = 1e-3

# bound_ms: the larger of the operations over the card's peak for their type
# and the bytes in and out over its memory rate (NVIDIA H100 SXM data sheet,
# dense: bf16 tensor cores 989 TFLOP/s, f32 67 TFLOP/s, HBM3 3.35 TB/s)
BF16_PEAK, F32_PEAK, HBM_RATE = 989e12, 67e12, 3.35e12
# phase 6's timed steps at each width
PROLOGUE_TIMED = 10

KERNEL_META = {
    "resonator": ("osu_dreamer_tpu_torch/csrc/resonator.cu", "osu_dreamer_tpu/ops/resonator.py:115"),
    "film_layer": ("osu_dreamer_tpu_torch/csrc/film_layer.cu", "osu_dreamer_tpu/ops/film_layer.py:401"),
    "swiglu": ("osu_dreamer_tpu_torch/csrc/swiglu.cu", "osu_dreamer_tpu/ops/swiglu.py:135"),
    "flash_attention": ("osu_dreamer_tpu_torch/csrc/flash_attention.cu",
                        "osu_dreamer_tpu/ops/long_attention.py:274"),
    "swiglu_bwd": ("osu_dreamer_tpu_torch/csrc/swiglu_bwd.cu", "osu_dreamer_tpu/ops/swiglu.py:492"),
    "fused_attention_fwd": ("osu_dreamer_tpu_torch/csrc/fused_attention.cu",
                            "osu_dreamer_tpu/ops/fused_attention.py:345"),
    "fused_attention_bwd": ("osu_dreamer_tpu_torch/csrc/fused_attention.cu",
                            "osu_dreamer_tpu/ops/fused_attention.py:399"),
    "film_layer_bwd": ("osu_dreamer_tpu_torch/csrc/film_layer_bwd.cu",
                       "osu_dreamer_tpu/ops/film_layer.py:443"),
    "swiglu_bwd_full": ("osu_dreamer_tpu_torch/csrc/swiglu_bwd.cu",
                        "osu_dreamer_tpu/ops/swiglu.py:313"),
    "film_qkv_fwd": ("osu_dreamer_tpu_torch/csrc/film_qkv.cu", "osu_dreamer_tpu/ops/film_qkv.py:122"),
    "film_qkv_bwd": ("osu_dreamer_tpu_torch/csrc/film_qkv.cu", "osu_dreamer_tpu/ops/film_qkv.py:235"),
    "swiglu_tp": ("osu_dreamer_tpu_torch/csrc/swiglu.cu", "osu_dreamer_tpu/ops/swiglu.py:135"),
    "swiglu_bwd_tp": ("osu_dreamer_tpu_torch/csrc/swiglu_bwd.cu",
                      "osu_dreamer_tpu/ops/swiglu.py:492"),
    "film_layer_tp": ("osu_dreamer_tpu_torch/csrc/film_layer.cu",
                      "osu_dreamer_tpu/ops/film_layer.py:401"),
    "film_layer_bwd_tp": ("osu_dreamer_tpu_torch/csrc/film_layer_bwd.cu",
                          "osu_dreamer_tpu/ops/film_layer.py:443"),
    # the backward of the JAX long attention's custom_vjp (its XLA vjp of
    # _xla_reference; its forward is the Pallas kernel K7/K8 replaced)
    "long_attention_bwd": ("osu_dreamer_tpu_torch/csrc/long_attention_bwd.cu",
                           "osu_dreamer_tpu/ops/long_attention.py:316"),
    "swiglu_bwd_full_tp": ("osu_dreamer_tpu_torch/csrc/swiglu_bwd.cu",
                           "osu_dreamer_tpu/ops/swiglu.py:313"),
    "film_qkv_tp": ("osu_dreamer_tpu_torch/csrc/film_qkv.cu", "osu_dreamer_tpu/ops/film_qkv.py:122"),
    "film_qkv_bwd_tp": ("osu_dreamer_tpu_torch/csrc/film_qkv.cu",
                        "osu_dreamer_tpu/ops/film_qkv.py:235"),
    # the long route's q/k norm and RoPE, which XLA fuses in the JAX
    # package (no pallas_call): forward and backward
    "qk_prep": ("osu_dreamer_tpu_torch/csrc/attention_stream.cu",
                "osu_dreamer_tpu/nn/attention.py:225"),
    "qk_post": ("osu_dreamer_tpu_torch/csrc/attention_stream.cu",
                "osu_dreamer_tpu/nn/attention.py:225"),
}
INFERENCE_KERNELS = ("resonator", "film_layer", "swiglu", "flash_attention")
# kernels timed by CUDA-graph replay (device time) rather than by a loop of
# launches from Python, whose host cost exceeds their run time (the
# backward wrappers launch several kernels and torch ops a call)
GRAPH_TIMED = ("resonator", "flash_attention", "swiglu", "film_layer", "film_qkv_fwd",
               "swiglu_bwd", "swiglu_bwd_full", "film_layer_bwd", "film_qkv_bwd",
               "fused_attention_fwd", "fused_attention_bwd")
# forward kernels whose second launch must be bit-identical (fixed-order
# sums, no float atomics)
RERUN_EXACT = ("resonator", "film_qkv_fwd", "swiglu", "film_layer")
# the forward core's kernels (K4, K2) are held to the plain version in f32 on
# the same bf16 inputs: their error's mean within SLICE_MEAN_RATIO and max
# within SLICE_MAX_RATIO of the plain bf16 path's (they keep v, g and h in
# f32 and apply 1/rms(h) after the output product, where the plain version
# rounds each to bf16)
F32_RULED = ("swiglu", "film_layer")
# a request's SwiGLU (8 layers x 33 denoiser passes) and film-layer (48
# latent U-Net layers) launches
SWIGLU_PER_REQUEST = 8 * (STEPS + 1)
FILM_PER_REQUEST = 48
# one flash attention per backbone layer (8) per denoiser pass (33: the
# initial u estimate and 32 steps)
FLASH_PER_REQUEST = 8 * (STEPS + 1)
# with the fused prologue, one K11 per backbone layer per denoiser pass; one
# resonator launch a request
PROLOGUE_PER_REQUEST = 8 * (STEPS + 1)
RESONATOR_PER_REQUEST = 1
TRAINING_KERNELS = ("swiglu", "swiglu_bwd", "fused_attention_fwd", "fused_attention_bwd")
# phase 4f: the shipped denoiser past the JAX gate (L 320): the q/k norm
# and RoPE pass each way, the streamed forward with lse (counted as K7) and
# the long attention backward
LONG_TRAINING_KERNELS = ("swiglu", "swiglu_bwd", "flash_attention", "long_attention_bwd",
                         "qk_prep", "qk_post")
LATENT_KERNELS = ("film_layer", "film_layer_bwd")
PROLOGUE_KERNELS = ("film_qkv_fwd", "film_qkv_bwd")
# phase 6: the kernels that must launch and those that must not, per width
PROLOGUE_TRAINING = {
    512: (PROLOGUE_KERNELS + TRAINING_KERNELS, ("swiglu_bwd_full",)),
    384: (PROLOGUE_KERNELS + ("swiglu", "swiglu_bwd_full", "fused_attention_fwd",
                              "fused_attention_bwd"), ("swiglu_bwd",)),
}
# the latent phase's corpus: 32 mapsets x 2 maps x 12 windows of 2052
# frames; 2 mapsets held out, 30 x 2 x 12 = 720 training windows, 22 batches
LATENT_CORPUS = (32, 2, 2052 * 12)
# phase 3a: predict's songs (seconds; the 120 s pair is one batch, the 30 s
# song one of its own, whose latent length routes attention to K9), written
# as 44.1 kHz stereo 16-bit WAV so that the WAV parser and the resampler run
PREDICT_SONGS = (SONG_SECONDS, SONG_SECONDS, 30.0)
PREDICT_DIFFS = [(5.0, 9.0, 8.0, 4.0, 6.0), (3.0, 7.0, 6.0, 3.0, 5.0)]
WAV_RATE = 44100
# phase 7: build_library's mapsets (3 difficulties each) of 60 s, written
# as WAV at the model's 16,384 Hz; the configs' max_val_frac 0.3 holds out
# 3 mapsets, leaving 27 training maps of one window each (max_per_map 1).
# Each stage's batch is cut to PIPELINE_BATCH (3 batches an epoch) and its
# steps to TRAIN_WARMUP + PIPELINE_TIMED; the full batches stay timed in
# phases 4-6
PIPELINE_MAPSETS = 12
PIPELINE_SECONDS = 60.0
PIPELINE_BATCH = 8
PIPELINE_TIMED = 4


def spec_frames(seconds: float) -> int:
    """make_spec's frames for a song of ``seconds``: whole 6 s buckets of
    1024 frames"""
    return 1024 * -(-int(seconds * 16384) // (98 * 1024))


PIPELINE_SPEC_FRAMES = spec_frames(PIPELINE_SECONDS)
# phase 8: serve's songs (seconds), written as predict's are: two 60 s songs
# (latent L past K9's 256: K7) and a 30 s one (K9). The burst: four
# concurrent unseeded two-row requests on the 60 s songs beside one
# three-row request, then one seeded request on the 30 s song
SERVE_SONGS = (60.0, 60.0, 30.0)
SERVE_TWO_ROW = 4
SERVE_THREE_ROWS = [(5.0, 9.0, 8.0, 4.0, 6.0), (3.0, 7.0, 6.0, 3.0, 5.0),
                    (4.0, 8.0, 7.0, 4.0, 5.0)]
SERVE_SEED = 1234


def log(msg: str) -> None:
    print(msg, flush=True)


def moved_bytes(*tensors) -> int:
    """bytes of the tensors among ``tensors`` (each read or written once)"""
    return sum(t.numel() * t.element_size() for t in tensors if hasattr(t, "element_size"))


def bound(flops: float, nbytes: int, peak: float = BF16_PEAK) -> dict:
    """the least time the card could take for the work, in ms, and which of
    operations and bytes sets it"""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def device_busy(trace: Path, *kernels: str) -> tuple[float, float, int]:
    """from a torch.profiler Chrome trace: ms during which the device ran a
    kernel, copy or set (the union of their intervals), ms and count of the
    kernels whose name holds one of ``kernels``"""
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    busy, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: float(e["ts"])):
        start, stop = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    named = [float(e["dur"]) for e in events
             if e["cat"] == "kernel" and any(k in e["name"] for k in kernels)]
    return busy / 1e3, sum(named) / 1e3, len(named)


# the FFN backward's kernels in a profiled train step, by a regular
# expression on their names (this tree's and the parent's, which
# tools/step_profile.py reads too): K3's row core and weight products in
# the latent step, K6's core (its two torch matmuls apart) in the denoiser's
LATENT_FAMILIES = {
    "K3 row core": r"ffn_core_kernel<true, \d+, \d+, true>|bwd_mid_kernel<true|ffn_bwd_grad_kernel"
                   r"|bwd_finish_film_kernel|film_layer_bwd_kernel",
    "K3 GEMM": r"gemm_tn|splitk_reduce_kernel",
}
DENOISER_FAMILIES = {
    "K6 core": r"bwd_conv_kernel|bwd_mid_kernel<false|ffn_bwd_grad_kernel|bwd_finish_plain_kernel"
               r"|swiglu_bwd_kernel",
    "K9": r"fused_attention_fwd_kernel",
    "K10": r"fused_attention_bwd_kernel",
}
# the fused prologue's kernels in a profiled width-512 denoiser step with
# OSU_DREAMER_FUSED_PROLOGUE=1 (this tree's and the parent's names; there
# gemm_tn runs for K12 alone, K6 taking its weight products in torch)
PROLOGUE_FAMILIES = {
    "K11": r"film_qkv_fwd_kernel",
    "K12": r"film_qkv_bwd_kernel|fq_y_kernel|fq_film_reduce_kernel|fq_reduce_kernel|gemm_tn_kernel"
           r"|splitk_reduce_kernel",
}


def step_kernels(trace: Path, families: dict[str, str]) -> str:
    """a profiled step's device-busy ms and each family's kernel ms and
    count, as one line"""
    import re

    busy, _, _ = device_busy(trace)
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "kernel" and "dur" in e]
    parts = [f"device busy {busy:.3f} ms over {len(events)} kernels"]
    for name, pattern in families.items():
        durs = [float(e["dur"]) for e in events if re.search(pattern, e["name"])]
        parts.append(f"{name} {sum(durs) / 1e3:.3f} ms over {len(durs)} kernels")
    return ", ".join(parts)


def _replay_ms(graph, calls: int) -> float:
    """device ms per call of a captured graph of ``calls`` calls, over 5
    replays after one warm replay"""
    import torch

    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * calls)


def graph_ms(fn, args, reps: int = 20) -> float:
    """device ms per call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's launch cost drops out (the flash attention runs
    for about as long as its launch from Python takes); the first call, on a
    side stream outside the capture, warms caches such as the weight packs"""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn(*args)
    ms = _replay_ms(graph, reps)
    del graph
    return ms


def graph_grad_ms(fn, leaves, grad_out, reps: int = 20) -> float:
    """device ms of autograd's backward of ``fn`` (the plain version of a
    backward kernel) over a graph built once, timed as ``graph_ms`` times
    the kernel: ``reps`` backward passes captured in one CUDA graph and
    replayed. The forward runs on the capture's stream, so that its
    backward nodes run there too."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        leaves = [t.detach().requires_grad_() for t in leaves]
        y = fn(*leaves)
        torch.autograd.grad(y, leaves, grad_out, retain_graph=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            torch.autograd.grad(y, leaves, grad_out, retain_graph=True)
    ms = _replay_ms(graph, reps)
    del graph, y
    return ms


def ffn_flops(rows: int, C: int, H: int, K: int, products: int, convs: int) -> int:
    """a conv FFN's operations over ``rows`` positions: ``products`` C x H
    products (the forward 3: the (C, 2H) and (H, C) projections; the
    backward 8: the recomputed (C, 2H), the two data and the two weight
    products) and ``convs`` K-tap conv passes, two operations a
    multiply-add"""
    return rows * 2 * (products * C * H + convs * K * C)


def ffn_plans(swiglu, graph_ms, rnd, ffn, B: int, smi: str) -> None:
    """K4 under each (output columns a CTA holds, hidden slices) plan at the
    sampler's shape (B4 L759) and the training shape (B128 L152), C 512:
    graph-replay ms, and the core and the reduction apart (torch.profiler
    device time); each plan's largest difference from the chosen plan's
    output is printed (the f32 partials are summed in another order). ``swiglu.fwd_plan`` decides the plan
    in the port; it is replaced here for the sweep only."""
    import torch

    C, H = 512, 1365
    Hp = -(-H // 64) * 64
    sms = swiglu.device_sms(torch.device("cuda", 0))
    chosen = swiglu.fwd_plan
    for label, Bp, Lp in ((f"B{B} L759", B, 759), ("B128 L152", 128, 152)):
        args = (rnd(Bp, Lp, C), *ffn(C, H))
        ref = swiglu.swiglu_cuda(*args).float()
        pick = chosen(Bp * Lp, C, Hp, sms)
        for nc, S in ((256, 1), (256, 2), (256, 3), (128, 1), (128, 2)):
            swiglu.fwd_plan = lambda *_a, nc=nc, S=S, **_k: (nc, S)
            try:
                diff = (swiglu.swiglu_cuda(*args).float() - ref).abs().max().item()
                ms = graph_ms(swiglu.swiglu_cuda, args)
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        swiglu.swiglu_cuda(*args)
                    torch.cuda.synchronize()
            finally:
                swiglu.fwd_plan = chosen
            dev_us = {k: sum(e.device_time_total for e in prof.key_averages() if k in e.key) / 10
                      for k in ("ffn_core_kernel", "ffn_reduce_kernel")}
            groups, rows = -(-C // nc), Bp * Lp
            ctas = min(-(-rows // 128), max(1, sms // (groups * S))) * groups * S
            log(f"swiglu plan {label} C{C}: {nc} columns a CTA x {S} hidden slices"
                f"{' (chosen)' if (nc, S) == pick else ''}: {ctas} CTAs on {sms} SMs, "
                f"v|g computed {groups}x ({2 * groups + 1} C H multiply-adds a row, the least 3); "
                f"{ms:.4f} ms (graph replay); core {dev_us['ffn_core_kernel']:.1f} us, "
                f"reduction {dev_us['ffn_reduce_kernel']:.1f} us (profiler); max |diff| to the "
                f"chosen plan {diff:.3g} [{smi}]")
        del args, ref


@contextmanager
def fused_prologue():
    """OSU_DREAMER_FUSED_PROLOGUE=1 for the duration, os.environ restored"""
    import os

    saved = os.environ.get("OSU_DREAMER_FUSED_PROLOGUE")
    os.environ["OSU_DREAMER_FUSED_PROLOGUE"] = "1"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["OSU_DREAMER_FUSED_PROLOGUE"]
        else:
            os.environ["OSU_DREAMER_FUSED_PROLOGUE"] = saved


def synth_wave(seed: int, seconds: float, sr: int) -> np.ndarray:
    """clicks on a beat grid over a few decaying tones"""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n, dtype=np.float64) / sr
    wave = np.zeros(n)
    for f in rng.uniform(60.0, 2000.0, size=4):
        wave += 0.1 * np.sin(2 * np.pi * f * t) * (0.5 + 0.5 * np.sin(2 * np.pi * t / rng.uniform(3, 9)))
    beat = 60.0 / rng.uniform(90, 180)
    burst = rng.normal(size=400) * np.exp(-np.arange(400) / 60.0)
    for onset in np.arange(0.5, seconds - 0.1, beat / 2):
        i = int(onset * sr)
        wave[i : i + 400] += 0.6 * burst
    return wave.astype(np.float32)


def write_song(path: Path, seconds: float, seed: int, rate: int = WAV_RATE) -> Path:
    """``synth_wave`` as a stereo 16-bit WAV at ``rate`` (by default 44.1
    kHz; at the model's rate ``load_wave`` does not resample) (stdlib
    ``wave``)"""
    mono = synth_wave(seed, seconds, rate).astype(np.float64)
    stereo = np.stack([mono, 0.9 * mono], axis=1) / max(1.0, float(np.abs(mono).max()))
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.round(stereo * 32767).astype("<i2").tobytes())
    return path


def predict_phase(model, dev, smi: str) -> dict[str, int]:
    """phase 3a: ``run_predict`` from WAV files to .osz mapsets on the
    full-width model; -> the kernel launches of its first run"""
    import os
    import zipfile

    import torch

    from osu_dreamer_tpu_torch import native
    from osu_dreamer_tpu_torch.audio.constants import SR
    from osu_dreamer_tpu_torch.audio.spectrogram import prep_wave_for_model
    from osu_dreamer_tpu_torch.cli import run_predict
    from osu_dreamer_tpu_torch.models.inference.sampler import dequantize_chart
    from osu_dreamer_tpu_torch.ops import _build
    from osu_dreamer_tpu_torch.ops.fused_attention import attention_route
    from osu_dreamer_tpu_torch.signal.serialize import decode_osu_entry

    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("the native library (slider fitter, WAV decoder) is not available")
    log(f"native library {native.build('osudreamer_native.cpp').relative_to(ROOT)} ready in "
        f"{time.perf_counter() - t0:.1f} s; libav shim available: {native.av_available()}")
    workdir = ROOT / "build" / "smoke_predict"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    songs = [write_song(workdir / f"song{i}.wav", seconds, SEED + 10 + i)
             for i, seconds in enumerate(PREDICT_SONGS)]

    # each batch's launches: one resonator, the latent U-Net's film layers,
    # and per backbone layer and denoiser pass one SwiGLU and the attention
    # kernel attention_route names for the batch's latent length
    chunk = model.args.latent.chunk_size
    backbone = model.args.diffusion.backbone
    expected = dict.fromkeys(_build.KERNELS, 0)
    routes = []
    for batch in ([0, 1], [2]):
        out_frames = {prep_wave_for_model(np.zeros(-(-int(PREDICT_SONGS[i] * WAV_RATE) * SR
                                                      // WAV_RATE), np.float32), chunk)[3]
                      for i in batch}
        (L,) = {f // chunk for f in out_frames}
        route = attention_route(L, backbone.n_heads, backbone.head_dim)
        routes.append((L, route))
        expected["resonator"] += RESONATOR_PER_REQUEST
        expected["film_layer"] += FILM_PER_REQUEST
        expected["swiglu"] += SWIGLU_PER_REQUEST
        expected["fused_attention_fwd" if route == "fused" else "flash_attention"] += \
            FLASH_PER_REQUEST
        if route == "long":
            expected["qk_prep"] += FLASH_PER_REQUEST

    def run(files, **options):
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            t = time.perf_counter()
            done = run_predict(model, files, PREDICT_DIFFS, STEPS, seed=SEED, device=dev,
                               **options)
            return done, time.perf_counter() - t
        finally:
            os.chdir(cwd)

    def check(done, files, snap_divisor=0) -> list[dict[str, str]]:
        """one .osz a song holding its WAV and one .osu a difficulty row,
        each equal to decode_osu_entry run here on the fetched chart"""
        texts, objects = [], []
        if [d.audio_file for d in done] != list(files):
            raise RuntimeError(f"run_predict answered {[d.audio_file for d in done]}")
        for d in done:
            with zipfile.ZipFile(d.osz) as z:
                members = z.namelist()
                entries = {n: z.read(n).decode() for n in members if n.endswith(".osu")}
            if d.audio_file.name not in members or len(entries) != len(PREDICT_DIFFS):
                raise RuntimeError(f"{d.osz.name} holds {members}")
            chart = dequantize_chart(d.hit_u8, d.xy_i16)[:, : d.frames].transpose(0, 2, 1)
            for i, (row, sig) in enumerate(zip(d.labels, chart)):
                name, text = decode_osu_entry(d.title, d.artist, d.audio_file.name, i, row, sig,
                                              snap_divisor=snap_divisor)
                if entries.get(name) != text:
                    raise RuntimeError(f"{d.osz.name}: {name} differs from the in-process "
                                       "serialization of its fetched chart")
                missing = [s for s in ("[General]", "[Metadata]", "[Difficulty]",
                                       "[TimingPoints]", "[HitObjects]") if s not in text]
                if missing:
                    raise RuntimeError(f"{name} lacks {missing}")
                objects.append(len(text.split("[HitObjects]\n")[1].strip().splitlines()))
            texts.append(entries)
        log(f"hit objects per .osu: {objects}")
        return texts

    saved = os.environ.get("OSU_DREAMER_TIMING")
    os.environ["OSU_DREAMER_TIMING"] = "1"
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        done, wall = run(songs, serialize_workers=2, batch_songs=2)
        launched = dict(_build.launches)
        texts = check(done, songs)
        n_maps = len(songs) * len(PREDICT_DIFFS)
        log(f"predict: {len(songs)} songs ({' + '.join(f'{s:.0f} s' for s in PREDICT_SONGS)}) "
            f"x {len(PREDICT_DIFFS)} difficulties, {STEPS} steps, --batch-songs 2 "
            f"--serialize-workers 2: {wall:.2f} s wall, {wall / n_maps * 1e3:.0f} ms per map "
            f"[{smi}]")
        log(f"predict latent lengths and attention routes by batch: {routes}; launches "
            f"{launched}")
        if launched != expected:
            raise RuntimeError(f"predict launched {launched}, not {expected}")
        again, wall2 = run(songs, serialize_workers=2, batch_songs=2)
        if check(again, songs) != texts:
            raise RuntimeError("a second predict with the same seed wrote other .osu texts")
        log(f"predict with the same seed again: the same .osu texts; {wall2:.2f} s wall, "
            f"{wall2 / n_maps * 1e3:.0f} ms per map [{smi}]")
        snapped, wall3 = run(songs[2:], serialize_workers=1, snap_divisor=4)
        check(snapped, songs[2:], snap_divisor=4)
        log(f"predict --snap-divisor 4 --serialize-workers 1, one {PREDICT_SONGS[2]:.0f} s song: "
            f"{wall3:.2f} s wall [{smi}]")
    finally:
        if saved is None:
            del os.environ["OSU_DREAMER_TIMING"]
        else:
            os.environ["OSU_DREAMER_TIMING"] = saved
    shutil.rmtree(workdir, ignore_errors=True)
    return launched


@contextmanager
def plain_ops():
    """every kernel dispatch swapped for its plain version (the SwiGLU,
    attention and prologue backward then come from autograd of the plain
    ones)"""
    from osu_dreamer_tpu_torch.audio import spectrogram
    from osu_dreamer_tpu_torch.nn import attention, blocks
    from osu_dreamer_tpu_torch.ops import (
        film_layer, film_qkv, fused_attention, long_attention, norm_rope, resonator, swiglu,
    )

    saved = (blocks.film_layer, blocks.swiglu, attention.long_flash_attention,
             attention.norm_rope_qkv, attention.fused_norm_rope_attention, attention.film_qkv,
             spectrogram.resonate_frames)
    blocks.film_layer, blocks.swiglu = film_layer.film_layer_plain, swiglu.swiglu_plain
    attention.long_flash_attention = long_attention.attention_plain
    attention.norm_rope_qkv = norm_rope.norm_rope_qkv_plain
    attention.fused_norm_rope_attention = fused_attention.rope_attention_plain
    attention.film_qkv = film_qkv.film_qkv_plain
    spectrogram.resonate_frames = resonator.resonate_plain
    try:
        yield
    finally:
        (blocks.film_layer, blocks.swiglu, attention.long_flash_attention,
         attention.norm_rope_qkv, attention.fused_norm_rope_attention, attention.film_qkv,
         spectrogram.resonate_frames) = saved


@contextmanager
def tap_counts():
    """{(kernel, taps of its depthwise kernel): calls} of the FFN kernels'
    wrappers (K4, K6, K5, K2, K3) while the context is open"""
    from osu_dreamer_tpu_torch.ops import film_layer, swiglu

    seen: dict = {}
    wrapped = [(swiglu, name, 1) for name in ("swiglu_cuda", "swiglu_bwd_cuda",
                                              "swiglu_bwd_full_cuda")]
    wrapped += [(film_layer, name, 6) for name in ("film_layer_cuda", "film_layer_bwd_cuda")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in wrapped]
    for (mod, name, at), (_, _, fn) in zip(wrapped, saved):
        def counted(*args, _fn=fn, _name=name, _at=at):
            key = (_name, args[_at].shape[0])
            seen[key] = seen.get(key, 0) + 1
            return _fn(*args)
        setattr(mod, name, counted)
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def randomize_(model, gen) -> None:
    """random full-strength weights in place: fan-in scaled normal kernels,
    1 + 0.1 N gains, 0.1 N other vectors (flax's zero-initialised layers
    would leave most gradients exactly zero)"""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.randn(p.shape, generator=gen, device=p.device)
            if p.dim() >= 2:
                draw = draw / float(np.prod(p.shape[:-1])) ** 0.5
            elif name.endswith("gamma"):
                draw = 1.0 + 0.1 * draw
            else:
                draw = 0.1 * draw
            p.copy_(draw)


def check_step(what: str, names, ref, kernels, plain, pool_terms: bool = False,
               ratios: tuple[float, float] = (SLICE_MEAN_RATIO, SLICE_MAX_RATIO),
               labels: tuple[str, str] = ("kernels", "plain bf16"),
               gate_terms: bool = True) -> None:
    """one train step's (loss terms, flat gradients) through the kernels and
    through the plain versions (bf16), each held to the plain f32 step: the
    kernels' gradients within ``ratios`` (mean, max: by default
    SLICE_MEAN_RATIO / SLICE_MAX_RATIO) of the plain path's error; their loss
    terms each within the max ratio of the plain path's error or LOSS_FLOOR
    of the f32 value, or with ``pool_terms`` the terms' relative errors
    (floored at LOSS_FLOOR) pooled under the gradients' mean / max rule
    (``gate_terms`` False: the terms logged only). ``labels`` name the two
    paths in the log and the errors"""
    import torch

    mean_ratio, max_ratio = ratios
    ref_terms, ref_grads = ref
    (kt, kg), (pt, pg) = (((t - ref_terms).abs(), (g - ref_grads).abs()) for t, g in (kernels, plain))
    if pool_terms:
        kr, pr = ((e / ref_terms.abs()).clamp_min(LOSS_FLOOR) for e in (kt, pt))
        terms_ok = bool(kr.mean() <= mean_ratio * pr.mean() and kr.max() <= max_ratio * pr.max())
    else:
        terms_ok = bool((kt <= torch.maximum(max_ratio * pt, LOSS_FLOOR * ref_terms.abs())).all())
    a, b = labels
    log(f"{what}: one train step vs the f32 plain step: loss terms ({', '.join(names)}) f32 "
        f"{ref_terms.tolist()}, |err| {a} {kt.tolist()} {b} {pt.tolist()}; "
        f"gradients ({ref_grads.numel()} values, max |f32| {ref_grads.abs().max().item():.4g}) "
        f"{a} mean {kg.mean().item():.4g} max {kg.max().item():.4g}, {b} mean "
        f"{pg.mean().item():.4g} max {pg.max().item():.4g}")
    if gate_terms and not terms_ok:
        raise RuntimeError(f"{what}: the {a} path's loss is farther from the f32 step than "
                           f"the {b} path's")
    if not (kg.mean() <= mean_ratio * pg.mean() and kg.max() <= max_ratio * pg.max()):
        raise RuntimeError(f"{what}: the {a} path's gradients are farther from the f32 step "
                           f"than the {b} path's")


def fit_timed(what: str, run, cfg: dict, dev, smi: str, workdir: Path, shape: str,
              kernels: tuple[str, ...], loss_keys: tuple[str, ...],
              shown: tuple[str, ...], timed: int = TRAIN_TIMED,
              absent: tuple[str, ...] = (),
              families: dict[str, str] | None = None,
              per_step: dict[str, int] | None = None) -> tuple[dict[str, int], float, float]:
    """``run`` (a stage's ``fit.run``) on ``cfg`` for TRAIN_WARMUP +
    ``timed`` steps, checkpoints under ``workdir``; fails unless every step
    ran, each of ``kernels`` launched during the timed steps and none of
    ``absent`` in the whole run, every loss of ``loss_keys`` stayed finite and
    both checkpoints exist. Logs ms/step and peak memory over the timed steps
    and the ``shown`` losses per step; with ``families``, the last warm-up
    step runs under torch.profiler (a step inside the first epoch, so no
    validation pass falls in its window) and its device-busy and family ms
    are logged; with ``per_step``, each named kernel must launch exactly
    that often a timed step -> (the kernel launches of the whole run,
    ms/step, peak GiB)"""
    import torch

    from osu_dreamer_tpu_torch.ops import _build

    end = steps = TRAIN_WARMUP + timed
    profiled = TRAIN_WARMUP - 1  # the profiler runs from this step's end to the next's
    cfg["fit"].update(run_dir=str(workdir / "runs"), max_steps=steps, log_every=5)
    marks: dict[int, tuple[float, dict]] = {}
    step_metrics: list[dict] = []
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])

    def on_step(step: int, metrics: dict) -> None:
        step_metrics.append(metrics)
        if step in (profiled, TRAIN_WARMUP, end):
            torch.cuda.synchronize()
            if families and step == TRAIN_WARMUP:
                prof.stop()
            marks[step] = (time.perf_counter(), dict(_build.launches))
            if step == TRAIN_WARMUP:
                torch.cuda.reset_peak_memory_stats()
            if families and step == profiled:
                prof.start()

    _build.reset_launches()
    state = run(cfg, device=dev, on_step=on_step)
    launches = dict(_build.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"launches during {what}: {launches}")
    if state.step != steps or len(step_metrics) != steps:
        raise RuntimeError(f"{what} ran {state.step} steps, not {steps}")
    del state
    torch.cuda.empty_cache()
    (ta, la), (tb, lb) = marks[TRAIN_WARMUP], marks[end]
    in_timed = {k: lb[k] - la[k] for k in kernels}
    log(f"launches during the {timed} timed steps: {in_timed}")
    missing = [k for k, n in in_timed.items() if n == 0]
    if missing:
        raise RuntimeError(f"{what} never launched: {missing}")
    off = {k: lb[k] - la[k] for k, n in (per_step or {}).items() if lb[k] - la[k] != n * timed}
    if off:
        raise RuntimeError(f"{what}: {off} launches in {timed} steps, not {per_step} a step")
    stray = [k for k in absent if launches[k]]
    if stray:
        raise RuntimeError(f"{what} launched {stray}, which its path must not take")
    losses = {k: [float(m[k]) for m in step_metrics] for k in loss_keys}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise RuntimeError(f"{what}: non-finite training loss: {losses}")
    for ckpt in ("last", "best"):
        if not (workdir / "runs" / ckpt / "state.pt").exists():
            raise RuntimeError(f"{what} wrote no {ckpt} checkpoint")
    ms_step = (tb - ta) / timed * 1e3
    log(f"{what} ({shape}): {ms_step:.2f} ms/step, {1e3 / ms_step:.3f} steps/s over "
        f"{timed} steps after {TRAIN_WARMUP} warm-up; peak device memory "
        f"{peak_gib:.2f} GiB [{smi}]")
    if families:
        with tempfile.TemporaryDirectory(dir=workdir) as tmpdir:
            trace = Path(tmpdir) / "trace.json"
            prof.export_chrome_trace(str(trace))
            summary = step_kernels(trace, families)
        one = {k: marks[TRAIN_WARMUP][1][k] - marks[profiled][1][k] for k in _build.KERNELS}
        if any(one[k] * timed != in_timed[k] for k in kernels):
            raise RuntimeError(f"{what}: the profiled step launched {one}, not what a timed "
                               f"step does ({in_timed} in {timed})")
        log(f"{what}: one step under torch.profiler: {summary}; launches "
            f"{ {k: n for k, n in one.items() if n} } [{smi}]")
    log("losses per step: " + json.dumps({k: [round(x, 5) for x in losses[k]] for k in shown})
        + f" [{smi}]")
    return launches, ms_step, peak_gib


def latent_step(what: str, cfg: dict, dev, gate_terms: bool = True) -> None:
    """one latent step (``cfg``'s model, batch and window) through the
    kernels and through the plain versions (bf16), each against a plain f32
    step on the same random full-strength weights, batch and draws, the
    components normalised by themselves as on the first step (``gate_terms``
    False: the gradients held, the loss terms logged)"""
    import torch

    from osu_dreamer_tpu_torch.models.latent.model import LatentModel, LatentModelArgs
    from osu_dreamer_tpu_torch.models.latent.train import (
        LOSS_COMPONENTS, LOSS_WEIGHTS, Batch, LatentTrainArgs, draw_latent, latent_loss,
    )
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    model_args = dataclass_from_dict(LatentModelArgs, cfg["model"])
    train_args = dataclass_from_dict(LatentTrainArgs, cfg["train"])
    bf16_model = LatentModel(model_args, torch.bfloat16).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    randomize_(bf16_model, gen)
    f32_model = LatentModel(model_args, torch.float32).to(dev)
    f32_model.load_state_dict(bf16_model.state_dict())
    Bt, Lt = cfg["data"]["batch_size"], cfg["data"]["seq_len"]
    batch = Batch(audio=torch.rand(Bt, Lt, 72, generator=gen, device=dev),
                  chart=torch.rand(Bt, Lt, 9, generator=gen, device=dev),
                  labels=torch.rand(Bt, 5, generator=gen, device=dev) * 10)
    draws = draw_latent(2 * Bt, model_args.style_dim, Lt // 2 // model_args.chunk_size,
                        model_args.emb_dim, gen, dev)
    weights = torch.from_numpy(LOSS_WEIGHTS).to(dev)

    def loss_and_grads(model, plain: bool):
        with plain_ops() if plain else nullcontext():
            comps, _, s_reg = latent_loss(model, batch, train_args, draws=draws)
            total = (weights * comps / comps.detach().clamp_min(1e-8)).sum()
            total = total + train_args.s_reg_weight * s_reg
            grads = torch.autograd.grad(total, list(model.parameters()), materialize_grads=True)
        terms = torch.cat([comps.detach().float(), torch.stack([s_reg, total]).detach().float()])
        return terms, torch.cat([g.flatten().float() for g in grads])

    # 13 loss terms, each set by the forward alone (K2 here, the plain bf16
    # forward there) through 64 film layers of random full-strength weights:
    # each term's bf16 error is a draw of about 1 % of its value, so one
    # term compared with one term is chance; they are pooled
    check_step(what, (*LOSS_COMPONENTS, "s_reg", "loss"), loss_and_grads(f32_model, True),
               loss_and_grads(bf16_model, False), loss_and_grads(bf16_model, True),
               pool_terms=True, gate_terms=gate_terms)
    del bf16_model, f32_model
    torch.cuda.empty_cache()


def train_latent(dev, smi: str, plain_ops, cfg: dict, corpus: tuple[int, int, int],
                 workdir: Path) -> dict[str, int]:
    """phase 5: ``cfg`` (the fit-latent config) trained through ``fit.run``
    on a synthetic corpus of ``corpus`` = (mapsets, maps per set, frames)
    under ``workdir``, the one-step check against f32, and encode-latents on
    the card from the ``last`` checkpoint -> the kernel launches of the
    training and encoding runs"""
    import torch

    from osu_dreamer_tpu_torch.data.pipeline import hold_out_mapsets, latent_windows
    from osu_dreamer_tpu_torch.data.synth import write_signal_corpus
    from osu_dreamer_tpu_torch.models.latent import fit as latent_fit
    from osu_dreamer_tpu_torch.models.latent.encode import encode_latents
    from osu_dreamer_tpu_torch.models.latent.model import LatentModelArgs
    from osu_dreamer_tpu_torch.models.latent.train import LOSS_COMPONENTS
    from osu_dreamer_tpu_torch.ops import _build
    from osu_dreamer_tpu_torch.train.logging import MetricsLogger
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    shutil.rmtree(workdir, ignore_errors=True)
    n_sets, maps_per_set, length = corpus
    t0 = time.perf_counter()
    write_signal_corpus(workdir / "data", n_sets, maps_per_set, length, SEED)
    cfg["data"].update(data_dir=str(workdir / "data"), max_per_map=-1, max_val_count=2)
    log(f"synthetic chart-signal corpus ({n_sets} mapsets x {maps_per_set} maps x {length} "
        f"frames) written in {time.perf_counter() - t0:.1f} s")
    data, model = cfg["data"], cfg["model"]
    # the reconstruction figure the stage logs after validation: drawn where
    # matplotlib imports, written where tensorboardX does too
    figures = []
    draw = MetricsLogger.figure

    def record_figure(self, tag, fig, step):
        figures.append((tag, step, self._writer is not None))
        draw(self, tag, fig, step)

    MetricsLogger.figure = record_figure
    try:
        launches_train, _, _ = fit_timed(
            "fit-latent", latent_fit.run, cfg, dev, smi, workdir,
            f"h_dim {model['h_dim']}, {model['n_downs']} downs, {model['stack']['n_layers']}-layer "
            f"stacks, B{data['batch_size']} x L{data['seq_len']}, bf16",
            LATENT_KERNELS, ("loss", *LOSS_COMPONENTS, "s_reg"),
            ("loss", "hit/onset", "cursor/pos", "label", "s_reg"), families=LATENT_FAMILIES)
    finally:
        MetricsLogger.figure = draw
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        if figures:
            raise RuntimeError(f"fit-latent logged {figures} without matplotlib")
        log("phase 5: matplotlib cannot be imported on this machine, so fit-latent drew no "
            "reconstruction figure (its log says so after validation)")
    else:
        if [f[:2] for f in figures] != [("samples", TRAIN_WARMUP + TRAIN_TIMED)]:
            raise RuntimeError(f"fit-latent logged the figures {figures}, not one at its "
                               "last step")
        log(f"phase 5: fit-latent drew its reconstruction figure (the first val map's chart, "
            f"reconstruction, their difference and z, encoded and decoded on the card) at "
            f"step {figures[0][1]}; " + ("written to TensorBoard" if figures[0][2] else
                                         "not written: tensorboardX cannot be imported"))

    latent_step("fit-latent", cfg, dev)

    # encode-latents on the card, read back by the latent pipeline
    _build.reset_launches()
    t0 = time.perf_counter()
    n_maps = encode_latents(workdir / "runs" / "last", workdir / "data", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_encode = dict(_build.launches)
    log(f"encode-latents: {n_maps} maps in {wall:.2f} s; launches {launches_encode} [{smi}]")
    if n_maps != n_sets * maps_per_set or launches_encode["film_layer"] == 0:
        raise RuntimeError(f"encode-latents encoded {n_maps} maps, launches {launches_encode}")
    sets, _ = hold_out_mapsets(workdir / "data", "*.latent.npz", 0, 0.0)
    samples = list(latent_windows(sets, None))
    model_args = dataclass_from_dict(LatentModelArgs, model)
    n_latent = -(-length // model_args.chunk_size)
    want = {"h": (n_latent, model_args.h_dim), "z": (n_latent, model_args.emb_dim),
            "s": (model_args.style_dim,)}
    for sample in samples:
        for key, shape in want.items():
            value = getattr(sample, key)
            if value.shape != shape or not np.isfinite(value).all():
                raise RuntimeError(f"encode-latents: bad {key} {value.shape}")
        # z is RMS-normalised per frame (computed in bf16: within 1e-2)
        rms = np.sqrt(np.square(sample.z.astype(np.float64)).mean(-1))
        if np.abs(rms - 1).max() > 1e-2:
            raise RuntimeError(f"encode-latents: z RMS per frame off 1 by {np.abs(rms - 1).max()}")
    windows = sum(1 for _ in latent_windows(sets, 152, max_per_map=-1))
    if len(samples) != n_maps or windows == 0:
        raise RuntimeError(f"the latent pipeline read {len(samples)} maps, {windows} windows")
    log(f"the latent pipeline read {len(samples)} encoded maps, {windows} windows of 152 latents")
    shutil.rmtree(workdir, ignore_errors=True)
    return {k: launches_train[k] + launches_encode[k] for k in _build.KERNELS}


def pipeline_phase(dev, smi: str) -> dict[str, int]:
    """phase 7: the training pipeline from audio, through the functions the
    CLI commands call: build_library, generate-data on the card, fit-latent,
    encode-latents, fit-denoiser and fit-style at the shipped configs'
    widths, export-inference in f32 and bf16, and predict on the exported
    artifact -> the kernel launches of those runs"""
    import hashlib
    import io
    import os
    import zipfile

    import torch

    from osu_dreamer_tpu_torch.audio.decode import load_wave
    from osu_dreamer_tpu_torch.audio.io import write_spec
    from osu_dreamer_tpu_torch.audio.spectrogram import make_spec, prep_wave_for_model
    from osu_dreamer_tpu_torch.cli import generate_data, main as cli_main, run_predict
    from osu_dreamer_tpu_torch.data.synth import DIFFS_PER_MAPSET, build_library
    from osu_dreamer_tpu_torch.models.diffusion import fit as diffusion_fit
    from osu_dreamer_tpu_torch.models.inference.artifact import load_inference
    from osu_dreamer_tpu_torch.models.latent import fit as latent_fit
    from osu_dreamer_tpu_torch.models.latent.encode import encode_latents
    from osu_dreamer_tpu_torch.models.latent.train import LOSS_COMPONENTS
    from osu_dreamer_tpu_torch.models.style import fit as style_fit
    from osu_dreamer_tpu_torch.ops import _build
    from osu_dreamer_tpu_torch.ops.fused_attention import attention_route
    from osu_dreamer_tpu_torch.osu import Beatmap, BeatmapParseError
    from osu_dreamer_tpu_torch.train.checkpoint import load_train_checkpoint
    from osu_dreamer_tpu_torch.utils import load_yaml_config

    root = ROOT / "build" / "smoke_pipeline"
    shutil.rmtree(root, ignore_errors=True)
    songs, data = root / "Songs", root / "data"
    walls: dict[str, float] = {}
    launched = dict.fromkeys(_build.KERNELS, 0)

    def count(run: dict[str, int]) -> None:
        for k, n in run.items():
            launched[k] += n

    t0 = time.perf_counter()
    build_library(songs, PIPELINE_MAPSETS, PIPELINE_SECONDS, SEED)
    walls["build_library"] = time.perf_counter() - t0
    n_want = PIPELINE_MAPSETS * DIFFS_PER_MAPSET

    # generate-data: one resonator launch a mapset, nothing else on the card
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    n_maps = generate_data(data, num_workers=4, songs_dir=songs, device=dev)
    walls["generate-data"] = time.perf_counter() - t0
    gen = dict(_build.launches)
    count(gen)
    log(f"generate-data --songs-dir: {n_maps} maps of {PIPELINE_MAPSETS} mapsets in "
        f"{walls['generate-data']:.2f} s; launches {gen} [{smi}]")
    if (n_maps != n_want or gen["resonator"] != PIPELINE_MAPSETS
            or any(n for k, n in gen.items() if k != "resonator")):
        raise RuntimeError(f"generate-data wrote {n_maps} maps (want {n_want}) with launches "
                           f"{gen} (want one resonator a mapset)")
    # one song's spec.npy against the plain path on the CPU, both quantized
    song = sorted(songs.iterdir())[0] / "audio.wav"
    wave = load_wave(song)
    card = np.load(data / hashlib.md5(song.read_bytes()).hexdigest()[:16] / "spec.npy")
    buf = io.BytesIO()
    write_spec(buf, make_spec(wave, "cpu"))
    buf.seek(0)
    plain = np.load(buf)
    step = int(np.abs(card.astype(np.int16) - plain.astype(np.int16)).max())
    log(f"generate-data spec.npy {card.shape} vs make_spec on the CPU (plain scan), both "
        f"uint8: max |diff| {step} step(s), {int((card != plain).sum())} of {card.size} "
        "values differ (tolerance 1 step)")
    if card.shape != plain.shape or step > 1:
        raise RuntimeError("generate-data's spectrogram differs from the plain path's")
    make_spec(wave, dev)
    t0 = time.perf_counter()
    for _ in range(5):
        make_spec(wave, dev)
    spec_ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"make_spec of one {PIPELINE_SECONDS:.0f} s song ({PIPELINE_SPEC_FRAMES} frames, K1 "
        f"at S1 K{PIPELINE_SPEC_FRAMES}): {spec_ms:.2f} ms a song, host clock around 5 calls "
        f"(upload, K1, normalisation, download) [{smi}]")

    def stage_cfg(fit_module, **cuts) -> dict:
        cfg = load_yaml_config(fit_module.CONFIG)
        cfg["parallel"] = {"dp": 1}
        log(f"phase 7 cut of {fit_module.__name__.split('.')[-2]}: batch_size "
            f"{cfg['data']['batch_size']} -> {PIPELINE_BATCH}, steps -> "
            f"{TRAIN_WARMUP + PIPELINE_TIMED}" + "".join(f", {k} {v}" for k, v in cuts.items()))
        cfg["data"].update(data_dir=str(data), batch_size=PIPELINE_BATCH, **cuts)
        return cfg

    def fit_stage(name, fit_module, cfg, shape, kernels, loss_keys, absent) -> None:
        t0 = time.perf_counter()
        runs, _, _ = fit_timed(name, fit_module.run, cfg, dev, smi, root / name, shape, kernels,
                               loss_keys, loss_keys, timed=PIPELINE_TIMED, absent=absent)
        walls[name] = time.perf_counter() - t0
        count(runs)

    denoiser_losses = ("loss", "osl", "del", "u_mape")
    cfg = stage_cfg(latent_fit, max_per_map=1)
    fit_stage("fit-latent", latent_fit, cfg, f"B{PIPELINE_BATCH} x L{cfg['data']['seq_len']}, "
              "bf16", LATENT_KERNELS, ("loss", *LOSS_COMPONENTS, "s_reg"), ())
    _build.reset_launches()
    t0 = time.perf_counter()
    n_encoded = encode_latents(root / "fit-latent" / "runs" / "best", data, device=dev)
    torch.cuda.synchronize()
    walls["encode-latents"] = time.perf_counter() - t0
    count(_build.launches)
    if n_encoded != n_want or _build.launches["film_layer"] == 0:
        raise RuntimeError(f"encode-latents encoded {n_encoded} maps, launches {_build.launches}")
    cfg = stage_cfg(diffusion_fit, max_per_map=1)
    fit_stage("fit-denoiser", diffusion_fit, cfg, f"B{PIPELINE_BATCH} x L{cfg['data']['seq_len']}"
              ", bf16", TRAINING_KERNELS, denoiser_losses, PROLOGUE_KERNELS + ("swiglu_bwd_full",))
    fit_stage("fit-style", style_fit, stage_cfg(style_fit), f"B{PIPELINE_BATCH}, bf16", (),
              denoiser_losses, _build.KERNELS)

    # export-inference in f32 and bf16: load_inference on the card must give
    # back the latent stage's live tensors and the others' EMA tensors
    ckpts = [root / stage / "runs" / "best" for stage in ("fit-latent", "fit-denoiser", "fit-style")]
    states = [load_train_checkpoint(c)[0] for c in ckpts]
    want = {f"{part}.{k}": v for part, sd in (("latent", states[0]["params"]),
                                               ("diffusion", states[1]["ema_params"]),
                                               ("style", states[2]["ema_params"]))
            for k, v in sd.items()}
    artifacts = {}
    for half in (False, True):
        out = root / ("inference_bf16.odt" if half else "inference.odt")
        t0 = time.perf_counter()
        cli_main(["export-inference", "--latent-ckpt-path", str(ckpts[0]), "--denoiser-ckpt-path",
                  str(ckpts[1]), "--style-ckpt-path", str(ckpts[2]), "--output-path", str(out)]
                 + (["--half"] if half else []))
        walls["export-inference" + (" --half" if half else "")] = time.perf_counter() - t0
        got = load_inference(out, dev).state_dict()
        differ = [k for k, v in want.items()
                  if not torch.equal(got[k].cpu(), v.to(torch.bfloat16).float() if half else v)]
        log(f"export-inference{' --half' if half else ''}: {out.stat().st_size / 2**20:.1f} MiB; "
            f"load_inference on the card: {len(got)} tensors, {len(differ)} differ from the "
            f"checkpoints' ({'bf16 of ' if half else ''}latent live, denoiser and style EMA)")
        if set(got) != set(want) or differ:
            raise RuntimeError(f"the exported artifact does not reload the checkpoints: {differ[:5]}")
        artifacts[half] = out

    # predict on the exported artifact: one song, two rows, 32 steps
    model = load_inference(artifacts[False], dev)
    chunk = model.args.latent.chunk_size
    L = prep_wave_for_model(wave, chunk)[3] // chunk
    backbone = model.args.diffusion.backbone
    route = attention_route(L, backbone.n_heads, backbone.head_dim)
    expected = dict.fromkeys(_build.KERNELS, 0)
    expected.update(resonator=RESONATOR_PER_REQUEST, film_layer=FILM_PER_REQUEST,
                    swiglu=SWIGLU_PER_REQUEST)
    expected["fused_attention_fwd" if route == "fused" else "flash_attention"] = FLASH_PER_REQUEST
    if route == "long":
        expected["qk_prep"] = FLASH_PER_REQUEST
    workdir = root / "predict"
    workdir.mkdir()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        (done,) = run_predict(model, [song], PREDICT_DIFFS, STEPS, seed=SEED, serialize_workers=1,
                              device=dev)
        walls["predict"] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    pred = dict(_build.launches)
    count(pred)
    if pred != expected:
        raise RuntimeError(f"predict on the exported artifact launched {pred}, not {expected}")
    parsed, overlaps, objects = 0, 0, []
    with zipfile.ZipFile(done.osz) as z:
        texts = [z.read(n).decode() for n in z.namelist() if n.endswith(".osu")]
    if len(texts) != len(PREDICT_DIFFS):
        raise RuntimeError(f"{done.osz.name} holds {len(texts)} .osu files")
    for text in texts:
        objects.append(len(text.split("[HitObjects]\n")[1].strip().splitlines()))
        try:
            Beatmap(text)
            parsed += 1
        except BeatmapParseError as e:
            # weights a few steps from random can decode a hold spanning the
            # next onset, which the strict parser refuses; the JAX package's
            # serializer writes the same (tests/test_end_to_end.py:265-276)
            if "starts before previous hit object ends" not in str(e):
                raise
            overlaps += 1
    log(f"predict on the exported artifact: one {PIPELINE_SECONDS:.0f} s song x "
        f"{len(PREDICT_DIFFS)} rows, {STEPS} steps, latent L {L} ({route} attention): "
        f"{walls['predict']:.2f} s; launches {pred}; .osu files {len(texts)}, hit objects "
        f"{objects}, parsed by Beatmap {parsed}, refused for an overlapping hold {overlaps}")
    del model
    torch.cuda.empty_cache()
    log("phase 7 walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; make_spec {spec_ms:.2f} ms a song [{smi}]")
    shutil.rmtree(root, ignore_errors=True)
    return launched


def write_serve_artifact(model) -> Path:
    """phase 3's model as the ``.odt`` phase 8 serves (f32 parameters, as
    export-inference writes them)"""
    from osu_dreamer_tpu_torch.models.inference.artifact import (
        build_artifact_bytes, to_flax_params,
    )

    path = ROOT / "build" / "smoke_serve" / "model.odt"
    shutil.rmtree(path.parent, ignore_errors=True)
    path.parent.mkdir(parents=True)
    path.write_bytes(build_artifact_bytes(model.args, to_flax_params(model)))
    return path


def serve_phase(odt: Path, dev, smi: str) -> dict[str, int]:
    """phase 8: ``serve``'s service and HTTP front end on the card, driven
    over a socket by concurrent clients -> the kernel launches of the burst
    and the seeded request"""
    import threading
    import urllib.error
    import urllib.request
    import zipfile

    import torch

    from osu_dreamer_tpu_torch.audio.constants import HOP_LEN
    from osu_dreamer_tpu_torch.audio.decode import load_wave
    from osu_dreamer_tpu_torch.audio.spectrogram import prep_wave_for_model
    from osu_dreamer_tpu_torch.models.inference.sampler import (
        build_batch_sampler, dequantize_chart,
    )
    from osu_dreamer_tpu_torch.ops import _build
    from osu_dreamer_tpu_torch.ops.fused_attention import attention_route
    from osu_dreamer_tpu_torch.serve import GeneratorService, MapServer
    from osu_dreamer_tpu_torch.signal.serialize import decode_osu_entry

    workdir = odt.parent
    songs = [write_song(workdir / f"song{i}.wav", seconds, SEED + 20 + i)
             for i, seconds in enumerate(SERVE_SONGS)]
    t_phase = time.perf_counter()
    service = GeneratorService(odt, device=dev, max_batch=4, batch_window_ms=25,
                               serialize_workers=2)
    t_start = time.perf_counter() - t_phase
    # each dispatch's (S, D, out_frames), seen where the dispatcher calls the
    # sampler. Unless it already holds two two-row requests, the burst's first
    # dispatch holds the dispatcher until two of them are queued behind it:
    # the uploads' decoding spreads over the host's cores by seconds, more
    # than a dispatch takes, and co-batching is then the service's to show,
    # not the host's timing
    dispatches: list[tuple[int, int, int]] = []
    burst_gate = threading.Event()
    sample = service._sample

    def recorded(waves, real, labels, generator, n_frames, out_frames, *rest):
        if burst_gate.is_set():
            burst_gate.clear()
            paired = labels.shape[0] >= 2 and labels.shape[1] == 2
            deadline = time.monotonic() + (0.0 if paired else 120.0)
            while time.monotonic() < deadline:
                with service._cond:
                    if sum(len(r.labels) == 2 for r in service._pending) >= 2:
                        break
                time.sleep(0.002)
        dispatches.append((labels.shape[0], labels.shape[1], out_frames))
        return sample(waves, real, labels, generator, n_frames, out_frames, *rest)

    service._sample = recorded
    server = MapServer(service, port=0)
    server.start_background()
    host, port = server.address

    def call(path: str, body: bytes | None = None) -> tuple[int, bytes, float]:
        t = time.perf_counter()
        req = urllib.request.Request(f"http://{host}:{port}{path}", data=body,
                                     method="GET" if body is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, r.read(), time.perf_counter() - t
        except urllib.error.HTTPError as e:
            return e.code, e.read(), time.perf_counter() - t

    def generate(song: Path, rows, seed: int | None = None) -> tuple[bytes, float]:
        query = "&".join([f"sample_steps={STEPS}", f"name={song.name}"]
                         + ["diff=" + ",".join(f"{v:g}" for v in row) for row in rows]
                         + ([f"seed={seed}"] if seed is not None else []))
        code, body, wall = call(f"/generate?{query}", song.read_bytes())
        if code != 200:
            raise RuntimeError(f"{song.name} x {len(rows)} rows answered {code}: {body[:300]!r}")
        with zipfile.ZipFile(io.BytesIO(body)) as z:
            members = z.namelist()
        if song.name not in members or sum(n.endswith(".osu") for n in members) != len(rows):
            raise RuntimeError(f"{song.name} x {len(rows)} rows: the .osz holds {members}")
        return body, wall

    def stats() -> dict:
        code, body, _ = call("/stats")
        if code != 200:
            raise RuntimeError(f"/stats answered {code}")
        return json.loads(body)

    try:
        code, body, _ = call("/healthz")
        health = json.loads(body)
        backend = "gpu" if dev.type == "cuda" else "cpu"
        if code != 200 or not health["ok"] or health["backend"] != backend or health["devices"] != 1:
            raise RuntimeError(f"/healthz answered {code}: {health}")
        log(f"serve: service started in {t_start:.2f} s (load_inference of a "
            f"{odt.stat().st_size / 2**20:.1f} MiB .odt, kernel library, 2 decode workers); "
            f"/healthz {health}")
        _, wall = generate(songs[2], PREDICT_DIFFS)  # warm-up: the first dispatch
        log(f"serve warm-up request ({SERVE_SONGS[2]:.0f} s song x {len(PREDICT_DIFFS)} rows, "
            f"{STEPS} steps): {wall:.2f} s [{smi}]")

        before = stats()
        dispatches.clear()
        torch.cuda.synchronize()
        _build.reset_launches()
        burst_gate.set()
        jobs = [(songs[i % 2], PREDICT_DIFFS) for i in range(SERVE_TWO_ROW)]
        jobs.append((songs[0], SERVE_THREE_ROWS))
        walls: list[float] = [0.0] * len(jobs)
        failures: list[BaseException] = []
        start = threading.Barrier(len(jobs) + 1)

        def client(i: int) -> None:
            start.wait()
            try:
                walls[i] = generate(*jobs[i])[1]
            except BaseException as e:  # noqa: BLE001 — raised below
                failures.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(jobs))]
        for t in threads:
            t.start()
        start.wait()
        t_burst = time.perf_counter()
        for t in threads:
            t.join()
        burst = time.perf_counter() - t_burst
        if failures:
            raise failures[0]
        burst_dispatches = list(dispatches)

        seeded, seeded_wall = generate(songs[2], PREDICT_DIFFS, SERVE_SEED)
        torch.cuda.synchronize()
        launched = dict(_build.launches)
        after = stats()
        code_bad, body_bad, _ = call("/generate?diff=1,2", b"x" * 64)
        code_404, _, _ = call("/nope")
        if code_bad != 400 or b"diff" not in body_bad or code_404 != 404:
            raise RuntimeError(f"a bad diff answered {code_bad} {body_bad!r}, an unknown path "
                               f"{code_404}")

        n_maps = sum(len(rows) for _, rows in jobs)
        batches = after["batches"] - before["batches"]
        rows = after["batched_rows"] - before["batched_rows"]
        log(f"serve burst: {SERVE_TWO_ROW} unseeded 2-row requests on two "
            f"{SERVE_SONGS[0]:.0f} s songs + one 3-row request, {STEPS} steps, max_batch 4, "
            f"25 ms window: request walls " + ", ".join(f"{w:.2f}" for w in walls)
            + f" s (p50 {float(np.median(walls)):.2f}, max {max(walls):.2f}); burst "
            f"{burst:.2f} s, {n_maps} maps, {n_maps / burst * 60:.1f} maps/min; dispatches "
            f"(songs, rows, frames) {burst_dispatches} [{smi}]")
        log(f"serve seeded request ({SERVE_SONGS[2]:.0f} s song x {len(PREDICT_DIFFS)} rows): "
            f"{seeded_wall:.2f} s; /stats over the burst and it: {batches} batches, {rows} rows, "
            f"padded_rows {after['padded_rows']}, errors {after['errors']}; after: {after}")

        two_row = [(S, D) for S, D, _ in burst_dispatches if D == len(PREDICT_DIFFS)]
        three_row = [(S, D) for S, D, _ in burst_dispatches if D == len(SERVE_THREE_ROWS)]
        if (sum(S for S, _ in two_row) != SERVE_TWO_ROW or len(two_row) >= SERVE_TWO_ROW
                or three_row != [(1, len(SERVE_THREE_ROWS))]
                or len(two_row) + len(three_row) != len(burst_dispatches)):
            raise RuntimeError(f"the burst was dispatched as {burst_dispatches}: the two-row "
                               "requests must share dispatches, the three-row one ride alone")
        if (batches != len(burst_dispatches) + 1 or rows != len(jobs) + 1
                or after["errors"] or after["padded_rows"]):
            raise RuntimeError(f"/stats over the burst: {before} -> {after}")
        if after["requests"] - before["requests"] != len(jobs) + 1:
            raise RuntimeError("the stats count other requests than the burst's")

        # one resonator, 48 film layers, and per backbone layer and denoiser
        # pass one SwiGLU and one of the attention kernel attention_route
        # names for the dispatch's latent length
        chunk = service.model.args.latent.chunk_size
        backbone = service.model.args.diffusion.backbone
        expected = dict.fromkeys(_build.KERNELS, 0)
        routes = []
        for _, _, out_frames in burst_dispatches + [dispatches[-1]]:
            route = attention_route(out_frames // chunk, backbone.n_heads, backbone.head_dim)
            routes.append((out_frames // chunk, route))
            expected["resonator"] += RESONATOR_PER_REQUEST
            expected["film_layer"] += FILM_PER_REQUEST
            expected["swiglu"] += SWIGLU_PER_REQUEST
            expected["fused_attention_fwd" if route == "fused" else "flash_attention"] += \
                FLASH_PER_REQUEST
            if route == "long":
                expected["qk_prep"] += FLASH_PER_REQUEST
        log(f"serve launches over {len(routes)} dispatches (latent L, attention) {routes}: "
            f"{launched}")
        if launched != expected:
            raise RuntimeError(f"serve launched {launched}, not {expected}")
        if routes[-1][1] != "fused" or any(r != "long" for _, r in routes[:-1]):
            raise RuntimeError(f"serve's attention routes {routes}: K7 for the 60 s songs, K9 "
                               "for the 30 s one")

        # the seeded request against the sampler on the service's model, same
        # wave, rows and generator seed, serialized here
        t = time.perf_counter()
        wave = load_wave(songs[2])
        load_s = time.perf_counter() - t
        buf, real_frames, n_frames, out_frames = prep_wave_for_model(wave, chunk)
        hit, xy, lab = build_batch_sampler(service.model)(
            torch.from_numpy(buf)[None].to(dev), torch.tensor([real_frames], device=dev),
            torch.tensor([PREDICT_DIFFS], dtype=torch.float32, device=dev),
            torch.Generator(dev).manual_seed(SERVE_SEED), n_frames, out_frames, STEPS, 1.0)
        chart = dequantize_chart(hit.cpu().numpy(), xy.cpu().numpy())
        frames = max(1, -(-len(wave) // HOP_LEN))
        signals = chart[:, :frames].transpose(0, 2, 1)
        with zipfile.ZipFile(io.BytesIO(seeded)) as z:
            entries = {n: z.read(n).decode() for n in z.namelist() if n.endswith(".osu")}
        for i, (row, sig) in enumerate(zip(lab.float().cpu().numpy(), signals)):
            name, text = decode_osu_entry(songs[2].stem, "Unknown Artist", songs[2].name, i, row,
                                          sig)
            if entries.get(name) != text:
                raise RuntimeError(f"the seeded request's {name} differs from the sampler's chart "
                                   "on the service's model, serialized here")
        log(f"serve seeded request: its {len(entries)} .osu texts equal decode_osu_entry of "
            f"build_batch_sampler's chart for the same wave, rows and seed, bit for bit; "
            f"load_wave of its song here {load_s:.2f} s")
    finally:
        server.close()
    if service._pool is not None or service._dispatcher.is_alive():
        raise RuntimeError("the service did not stop its pool and dispatcher")
    log(f"phase 8 wall {time.perf_counter() - t_phase:.1f} s [{smi}]")
    shutil.rmtree(workdir, ignore_errors=True)
    return launched


# phase 9: data and sequence parallelism on two ranks, one card each where
# two are visible, else both on card 0 over gloo (NCCL refuses two ranks on
# one card). The denoiser at full width with dp 2 through fit.run (which
# spawns its ranks) and with sp 2, then the latent stage with dp 2; per rank
# and step each kernel must launch exactly as often as below (every other
# kernel not at all), and each parallel step must stay within PARALLEL_RATIO
# (mean and max) of the one-process kernel step's error against the f32
# plain step on the same weights, batch and draws
PARALLEL_STEPS = 6
PARALLEL_LATENT_STEPS = 4
PARALLEL_RATIO = 1.5
DP_DENOISER_LAUNCHES = {"swiglu": 8, "swiglu_bwd": 8, "fused_attention_fwd": 8,
                        "fused_attention_bwd": 8}
SP_DENOISER_LAUNCHES = {"swiglu": 8, "swiglu_bwd": 8}  # ring attention: no K9/K10
LATENT_STEP_LAUNCHES = {"film_layer": 88, "film_layer_bwd": 88}


def rank_probe(outdir: str, step: int, metrics: dict) -> None:
    """``on_step`` of a phase-9 rank: after the step's device work, the host
    clock, the rank's kernel launches so far, the loss, and the collectives'
    CUDA-event ms since the warm-up (timed from its end on), appended to
    ``outdir``/rank<r>.jsonl"""
    import torch
    import torch.distributed as dist

    from osu_dreamer_tpu_torch.ops import _build
    from osu_dreamer_tpu_torch.parallel.collectives import comm_timer

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    record = {"step": step, "t": time.perf_counter(), "launches": dict(_build.launches),
              "loss": float(metrics["loss"]), "comm": comm_timer.ms()}
    if step == TRAIN_WARMUP:
        comm_timer.reset()
        comm_timer.enabled = True
    Path(outdir).mkdir(parents=True, exist_ok=True)
    with open(Path(outdir) / f"rank{dist.get_rank()}.jsonl", "a") as f:
        f.write(json.dumps(record) + "\n")


def read_probe(outdir: Path, what: str, steps: int, want: dict[str, int], smi: str
               ) -> dict[str, int]:
    """the phase-9 records of a two-rank fit: every step's launches on every
    rank exactly ``want`` (other kernels 0), the losses finite and equal on
    the ranks; logs ms/step per rank over the steps after TRAIN_WARMUP and
    the collectives' ms a step -> the launches of both ranks"""
    from osu_dreamer_tpu_torch.ops import _build

    total = dict.fromkeys(_build.KERNELS, 0)
    losses = []
    timed = steps - TRAIN_WARMUP
    for rank in range(2):
        records = [json.loads(line) for line in open(outdir / f"rank{rank}.jsonl")]
        if [r["step"] for r in records] != list(range(1, steps + 1)):
            raise RuntimeError(f"{what}: rank {rank} ran steps {[r['step'] for r in records]}")
        before = dict.fromkeys(_build.KERNELS, 0)
        expected = {k: want.get(k, 0) for k in _build.KERNELS}
        for r in records:
            step_launches = {k: r["launches"][k] - before[k] for k in _build.KERNELS}
            if step_launches != expected:
                raise RuntimeError(f"{what}: rank {rank} step {r['step']} launched "
                                   f"{step_launches}, not {expected}")
            before = r["launches"]
        losses.append([r["loss"] for r in records])
        ms = (records[-1]["t"] - records[TRAIN_WARMUP - 1]["t"]) / timed * 1e3
        comm = ", ".join(f"{kind} {v[0] / timed:.2f} ms ({v[1] // timed} a step)"
                         for kind, v in sorted(records[-1]["comm"].items()))
        log(f"{what}, rank {rank}: {ms:.2f} ms/step over {timed} steps after {TRAIN_WARMUP} "
            f"warm-up (host clock); collectives a step (CUDA events): {comm} [{smi}]")
        for k in _build.KERNELS:
            total[k] += records[-1]["launches"][k]
    if not np.isfinite(losses).all() or losses[0] != losses[1]:
        raise RuntimeError(f"{what}: the ranks' losses {losses}")
    log(f"{what}: per rank and step {want} launches, every other kernel none; losses "
        f"{[round(x, 5) for x in losses[0]]} on both ranks")
    return total


def denoiser_parallel_check(cfg: dict, devices: list[str], smi: str) -> None:
    """phase 9's one-step check of the denoiser at full width (B128 L152):
    the dp 2 and the sp 2 step's loss terms and averaged gradients, each
    within PARALLEL_RATIO of the one-process kernel step's error against the
    f32 plain step on the same random full-strength weights, batch, t and x0
    (in each rank; rank 0 compares)"""
    import torch
    import torch.distributed as dist

    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel, DiffusionModelArgs
    from osu_dreamer_tpu_torch.models.diffusion.train import (
        DiffusionTrainArgs, LatentBatch, step_gradients,
    )
    from osu_dreamer_tpu_torch.parallel import ParallelArgs, build_parallelism
    from osu_dreamer_tpu_torch.train.state import stratified_logit_normal_t
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    dev = torch.device(devices[dist.get_rank()])
    md = cfg["model"]
    model_args = dataclass_from_dict(DiffusionModelArgs, md)
    train_args = dataclass_from_dict(DiffusionTrainArgs, cfg["train"])
    bf16_model = DiffusionModel(model_args, torch.bfloat16).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    randomize_(bf16_model, gen)
    Bt, Lt = cfg["data"]["batch_size"], cfg["data"]["seq_len"]
    z = torch.randn(Bt, Lt, md["emb_dim"], generator=gen, device=dev)
    batch = LatentBatch(h=torch.rand(Bt, Lt, md["a_dim"], generator=gen, device=dev),
                        z=z / z.square().mean(-1, keepdim=True).sqrt(),
                        s=torch.randn(Bt, md["style_dim"], generator=gen, device=dev),
                        labels=torch.rand(Bt, 5, generator=gen, device=dev) * 10)
    t_inj = stratified_logit_normal_t(Bt, gen, dev)
    x0_inj = torch.randn(batch.z.shape, generator=gen, device=dev)
    names = ("loss", "osl", "del", "u_mape")

    def flat(metrics, grads):
        return (torch.stack([metrics[k].float() for k in names]),
                torch.cat([g.flatten().float() for g in grads]))

    spread = {}
    for label, args in (("dp 2", {"dp": 2}), ("sp 2", {"sp": 2})):
        par = build_parallelism(ParallelArgs(**args), Bt, devices)
        local = par.shard_batch(batch, seq_fields=(0, 1))
        spread[label] = flat(*step_gradients(bf16_model, local, train_args, None, t_inj, x0_inj,
                                             par))
    if dist.get_rank() == 0:
        f32_model = DiffusionModel(model_args, torch.float32).to(dev)
        f32_model.load_state_dict(bf16_model.state_dict())
        with plain_ops():
            ref = flat(*step_gradients(f32_model, batch, train_args, None, t_inj, x0_inj))
        del f32_model
        one = flat(*step_gradients(bf16_model, batch, train_args, None, t_inj, x0_inj))
        for label, got in spread.items():
            check_step(f"phase 9 fit-denoiser {label}", names, ref, got, one,
                       ratios=(PARALLEL_RATIO, PARALLEL_RATIO),
                       labels=(f"{label} ranks", "one-process kernels"))
    del bf16_model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()


def latent_parallel_check(cfg: dict, devices: list[str]) -> None:
    """phase 9's one-step check of the latent stage at full width (B32
    L2052): the dp 2 step (the MMD over the gathered style codes) held as
    ``denoiser_parallel_check`` holds the denoiser's, its 13 terms pooled
    as in phase 5"""
    import torch
    import torch.distributed as dist

    from osu_dreamer_tpu_torch.models.latent.model import LatentModel, LatentModelArgs
    from osu_dreamer_tpu_torch.models.latent.train import (
        LOSS_COMPONENTS, LOSS_WEIGHTS, Batch, LatentTrainArgs, draw_latent, latent_loss,
    )
    from osu_dreamer_tpu_torch.parallel import ParallelArgs, build_parallelism
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    dev = torch.device(devices[dist.get_rank()])
    model_args = dataclass_from_dict(LatentModelArgs, cfg["model"])
    train_args = dataclass_from_dict(LatentTrainArgs, cfg["train"])
    bf16_model = LatentModel(model_args, torch.bfloat16).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    randomize_(bf16_model, gen)
    Bt, Lt = cfg["data"]["batch_size"], cfg["data"]["seq_len"]
    batch = Batch(audio=torch.rand(Bt, Lt, 72, generator=gen, device=dev),
                  chart=torch.rand(Bt, Lt, 9, generator=gen, device=dev),
                  labels=torch.rand(Bt, 5, generator=gen, device=dev) * 10)
    draws = draw_latent(2 * Bt, model_args.style_dim, Lt // 2 // model_args.chunk_size,
                        model_args.emb_dim, gen, dev)
    weights = torch.from_numpy(LOSS_WEIGHTS).to(dev)

    def terms_and_grads(model, batch, par=None):
        comps, _, s_reg = latent_loss(model, batch, train_args, draws=draws, par=par)
        total = (weights * comps / comps.detach().clamp_min(1e-8)).sum()
        total = total + train_args.s_reg_weight * s_reg
        grads = list(torch.autograd.grad(total, list(model.parameters()),
                                         materialize_grads=True))
        if par is not None:
            grads = par.average_gradients(grads)
        terms = torch.cat([comps.detach().float(), torch.stack([s_reg, total]).detach().float()])
        return terms, torch.cat([g.flatten().float() for g in grads])

    par = build_parallelism(ParallelArgs(dp=2), Bt, devices)
    spread = terms_and_grads(bf16_model, par.shard_batch(batch), par)
    if dist.get_rank() == 0:
        f32_model = LatentModel(model_args, torch.float32).to(dev)
        f32_model.load_state_dict(bf16_model.state_dict())
        with plain_ops():
            ref = terms_and_grads(f32_model, batch)
        del f32_model
        check_step("phase 9 fit-latent dp 2", (*LOSS_COMPONENTS, "s_reg", "loss"), ref, spread,
                   terms_and_grads(bf16_model, batch), pool_terms=True,
                   ratios=(PARALLEL_RATIO, PARALLEL_RATIO),
                   labels=("dp 2 ranks", "one-process kernels"))
    del bf16_model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()


def parallel_rank(workdir: str, sp_cfg: dict, latent_cfg: dict, denoiser_cfg: dict,
                  devices: list[str], smi: str) -> None:
    """phase 9 (b) and (c) and the one-step checks, in each of two ranks:
    the sp 2 denoiser and the dp 2 latent stage through their ``fit.run``
    (each finding the process group joined), then the checks"""
    import torch

    from osu_dreamer_tpu_torch.models.diffusion import fit as diffusion_fit
    from osu_dreamer_tpu_torch.models.latent import fit as latent_fit
    from osu_dreamer_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, fit_module, cfg in (("probe_sp", diffusion_fit, sp_cfg),
                                  ("probe_latent", latent_fit, latent_cfg)):
        _build.reset_launches()
        state = fit_module.run(cfg, device=devices[0], devices=devices,
                               on_step=functools.partial(rank_probe, str(Path(workdir) / name)))
        del state
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    denoiser_parallel_check(denoiser_cfg, devices, smi)
    latent_parallel_check(latent_cfg, devices)


def parallel_phase(dev, smi: str) -> dict[str, int]:
    """phase 9: parallel training on the card -> the kernel launches of the
    three parallel fits' ranks"""
    import torch

    from osu_dreamer_tpu_torch.data.synth import write_latent_corpus, write_signal_corpus
    from osu_dreamer_tpu_torch.models.diffusion import fit as diffusion_fit
    from osu_dreamer_tpu_torch.models.latent import fit as latent_fit
    from osu_dreamer_tpu_torch.parallel.distributed import backend_for, launch
    from osu_dreamer_tpu_torch.utils import load_yaml_config

    t_phase = time.perf_counter()
    devices = ["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2 else ["cuda:0", "cuda:0"]
    shared = backend_for([torch.device(d) for d in devices]) == "gloo"
    log(f"phase 9: two ranks on {devices}: " + (
        "they share one card and talk over gloo (CUDA tensors staged through the host for "
        "point-to-point sends)" if shared else "one card each, over NCCL"))
    workdir = ROOT / "build" / "smoke_parallel"
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()

    denoiser_cfg = load_yaml_config(diffusion_fit.CONFIG)
    md = denoiser_cfg["model"]
    write_latent_corpus(workdir / "latents", 64, 4, 152 * 12, md["a_dim"], md["emb_dim"],
                        md["style_dim"], SEED)
    denoiser_cfg["data"].update(data_dir=str(workdir / "latents"), max_per_map=-1,
                                max_val_count=2)
    latent_cfg = load_yaml_config(latent_fit.CONFIG)
    write_signal_corpus(workdir / "signals", *LATENT_CORPUS, SEED)
    latent_cfg["data"].update(data_dir=str(workdir / "signals"), max_per_map=-1,
                              max_val_count=2)
    latent_cfg["fit"].update(run_dir=str(workdir / "runs_latent"),
                             max_steps=PARALLEL_LATENT_STEPS, log_every=5)
    latent_cfg["parallel"] = {"dp": 2}

    def with_parallel(parallel: dict, run_dir: str) -> dict:
        cfg = json.loads(json.dumps(denoiser_cfg))
        cfg["fit"].update(run_dir=str(workdir / run_dir), max_steps=PARALLEL_STEPS, log_every=5)
        cfg["parallel"] = parallel
        return cfg

    # (a) dp 2 through fit.run, as a user runs it: run spawns the ranks
    t0 = time.perf_counter()
    state = diffusion_fit.run(with_parallel({"dp": 2}, "runs_dp"), device=dev, devices=devices,
                              on_step=functools.partial(rank_probe, str(workdir / "probe_dp")))
    if state.step != PARALLEL_STEPS:
        raise RuntimeError(f"fit-denoiser dp 2 ended at step {state.step}")
    del state
    torch.cuda.empty_cache()
    log(f"phase 9 (a) fit-denoiser dp 2 (width 512, 16 x 64 heads, B128 x L152, 64 rows a "
        f"rank, bf16): {PARALLEL_STEPS} steps, {time.perf_counter() - t0:.1f} s wall with the "
        f"spawn, validation and rank 0's state read back")
    launches = read_probe(workdir / "probe_dp", "fit-denoiser dp 2", PARALLEL_STEPS,
                          DP_DENOISER_LAUNCHES, smi)

    # (b) sp 2 and (c) the latent stage at dp 2, then the one-step checks,
    # in one spawn of two ranks
    t0 = time.perf_counter()
    launch(parallel_rank, (str(workdir), with_parallel({"sp": 2}, "runs_sp"), latent_cfg,
                           denoiser_cfg, devices, smi),
           devices, 2, deadline_s=900)
    log(f"phase 9 (b, c) and the one-step checks: {time.perf_counter() - t0:.1f} s wall")
    for name, what, steps, want in (
            ("probe_sp", "fit-denoiser sp 2 (76 frames a rank, K4/K6 on 80-row halo'd shards)",
             PARALLEL_STEPS, SP_DENOISER_LAUNCHES),
            ("probe_latent", "fit-latent dp 2 (B32 x L2052, 16 rows a rank)",
             PARALLEL_LATENT_STEPS, LATENT_STEP_LAUNCHES)):
        for k, n in read_probe(workdir / name, what, steps, want, smi).items():
            launches[k] += n
    for run_dir in ("runs_dp", "runs_sp", "runs_latent"):
        if not (workdir / run_dir / "last" / "state.pt").exists():
            raise RuntimeError(f"phase 9: rank 0 wrote no {run_dir}/last")
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 9 wall {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return launches


# phase 1e: the FFN kernels' TP forms (parallel/tp.py) on two slices of the
# hidden units, at the shapes of phase 10's main path: K4 and K6 at the
# denoiser's B128 L152 C512 (H 1365: 683 and 682 a rank), K5 at the
# width-384 denoiser's B128 L152 C384 (H 1024), K2 and K3 at the latent
# stage's four levels B64 L1026 / L342 / L114 / L38 C128 (H 341: 171 and
# 170). In one process: each slice's first phase against its plain
# version, the slices' sums through the second phase against the f32 plain
# one-rank function (and beside the one-rank kernel), reruns bit-identical,
# and one rank's form (both phases, its own partials unsummed) timed by
# graph replay
TP_FORMS = ("swiglu_tp", "swiglu_bwd_tp", "film_layer_tp", "film_layer_bwd_tp",
            "swiglu_bwd_full_tp", "film_qkv_tp", "film_qkv_bwd_tp")
TP_RANKS = 2
TP_DENOISER = (128, 152, 512, 1365)  # B, L, C, H
# the width-384 denoiser's, where the one-rank SwiGLU backward is K5 and so
# a slice's is K5's TP form (512 of the 1024 hidden units a rank)
TP_DENOISER_384 = (128, 152, 384, 1024)
# a forward's first phase leaves its workspace, one f32 plane (the kernel
# folds its hidden slices into it), held part by part to the forward cores'
# f32 rule: K4's from x; K2's from the y it stores, and that y from x. (From
# x, K2's sums of s^2 follow y's bf16 rounding, which the kernel and the
# plain bf16 path round at other points: a full run read 1.73x the plain
# path's max error there at 0.70x its mean, so the rule holds each stage.)
WORKSPACE = ("s W_out partial", "sums of s^2 partial")
TP_LATENT = (128, 341, ((64, 1026), (64, 342), (64, 114), (64, 38)))  # C, H, (B, L) a level
# the fused prologue's TP forms at the denoiser's training shape: B, L, C,
# heads, head dim (8 of the 16 heads a rank: 1536 of the 3072 qkv columns)
TP_PROLOGUE = (128, 152, 512, 16, 64)


def tp_slices(H: int, tp: int = TP_RANKS):
    """per rank the splits of (vg_kernel, vg_bias, out_kernel) of H units"""
    from osu_dreamer_tpu_torch.parallel.tp import Split, even_split

    out = []
    for r in range(tp):
        lo, hi = even_split(H, tp, r)
        out.append((Split(1, 2, 1, H, lo, hi), Split(0, 2, 1, H, lo, hi),
                    Split(0, 1, 1, H, lo, hi)))
    return out


def f32_rule(what: str, got, plain, ref, yardstick: str = "plain bf16",
             ratios: tuple[float, float] = (SLICE_MEAN_RATIO, SLICE_MAX_RATIO)) -> float:
    """the forward cores' rule: ``got``'s error against the f32 ``ref``
    within ``ratios`` (mean, max) of ``plain``'s -> got's max error"""
    import torch

    ek, ep = (got.float() - ref.float()).abs(), (plain.float() - ref.float()).abs()
    log(f"{what}: vs the plain f32 version kernel mean {ek.mean().item():.4g} max "
        f"{ek.max().item():.4g}, {yardstick} mean {ep.mean().item():.4g} max "
        f"{ep.max().item():.4g} (limits {ratios[0]}x / {ratios[1]}x)")
    if not (bool(torch.isfinite(got).all()) and ek.mean() <= ratios[0] * ep.mean()
            and ek.max() <= ratios[1] * ep.max()):
        raise RuntimeError(f"{what}: farther from the f32 version than the {yardstick}")
    return ek.max().item()


def workspace_rule(what: str, rows: int, C: int, got, plain, ref) -> None:
    """a TP form's first-phase workspace (flat: s W_out, then the row sums
    of s^2) by the forward cores' f32 rule, each part"""
    from osu_dreamer_tpu_torch.ops.swiglu import split_partials

    for name, *parts in zip(WORKSPACE, *(split_partials(b, rows, C) for b in (got, plain, ref))):
        f32_rule(f"{what} {name}", *parts)


def tp_forms_phase(rnd, ffn, film_args, check_grads, record, results: dict, smi: str) -> None:
    """phase 1e: the seven TP forms (see TP_FORMS above); fills ``results``
    with each form's first shape"""
    import torch

    from osu_dreamer_tpu_torch.ops import film_layer as fl
    from osu_dreamer_tpu_torch.ops import swiglu as sw

    def equal_all(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def same_finish(what: str, done: list, again) -> None:
        """the ranks' finishes on the same summed dY equal bit for bit, and
        a rerun of rank 0's (into fresh outputs) equals them"""
        rerun = tuple(t.clone() for t in again)
        for i, out in enumerate(done[1:] + [rerun]):
            diffs = [(a.float() - b.float()).abs().max().item() for a, b in zip(done[0], out)]
            if not equal_all(done[0], out):
                raise RuntimeError(f"{what}: {'a rerun' if i == len(done) - 1 else 'rank 1'} "
                                   f"differs from rank 0's finish: max |diff| {diffs}, finite "
                                   f"{[bool(torch.isfinite(t).all()) for t in out]}")

    def summed(parts):
        """the all-reduce of the ranks' dY partials, in place on each"""
        total = sum(parts)
        for t in parts:
            t.copy_(total)

    def cut(weights, sp):
        return (*weights[:2], *(s.take(t) for s, t in zip(sp, weights[2:5])), weights[5])

    def swiglu_bwd_tp_case(name, full, x, go, w32, splits, total, total32, H, label) -> None:
        """the K6 (``full`` False) or K5 TP form on each slice against its
        plain version, the sums through the finish against the f32
        one-rank backward (and beside the one-rank kernel), reruns
        bit-identical, one rank's form timed"""
        Bt, Lt, C = x.shape
        rows = Bt * Lt
        dys, grads, finishes = [], [], []
        for r, sp in enumerate(splits):
            ws32 = cut(w32, sp)
            dy, sg, fin = sw.swiglu_tp_bwd_cuda(x, *ws32[:5], go, total, H, TP_RANKS, full=full)
            dy32, sg32 = sw.swiglu_tp_bwd_plain(x.float(), *ws32[:5], go.float(), total32, H)[:2]
            dyp, sgp = sw.swiglu_tp_bwd_plain(x, *ws32[:5], go, total, H)[:2]
            check_grads(f"{name} {label} slice {r} first phase",
                        ("dY partial", "d_vg_kernel", "d_vg_bias", "d_out_kernel"),
                        (dy.sum(0), *sg), (dy32.sum(0), *sg32), (dyp.sum(0), *sgp))
            again = sw.swiglu_tp_bwd_cuda(x, *ws32[:5], go, total, H, TP_RANKS, full=full)
            if not (torch.equal(again[0], dy) and equal_all(again[1], sg)):
                raise RuntimeError(f"{name} slice {r}: two launches differ")
            dys.append(dy)
            grads.append(sg)
            finishes.append(fin)
        summed(dys)
        done = [tuple(t.clone() for t in fin()) for fin in finishes]
        same_finish(name, done, finishes[0]())
        full_grads = [torch.zeros_like(t) for t in w32[2:5]]
        for sp, sg in zip(splits, grads):
            for s, g, f in zip(sp, sg, full_grads):
                s.put(f, g)
        dx, ddw, ddwb, dbout = done[0]
        got = (dx, ddw, ddwb, *full_grads, dbout)
        names = ("dx", "d_dw_kernel", "d_dw_bias", "d_vg_kernel", "d_vg_bias", "d_out_kernel",
                 "d_out_bias")
        worst = check_grads(f"{name} {label}, summed and finished", names, got,
                            sw.swiglu_bwd_plain(x.float(), *w32[:5], go.float()),
                            sw.swiglu_bwd_plain(x, *w32[:5], go))
        one = (sw.swiglu_bwd_full_cuda if full else sw.swiglu_bwd_cuda)(x, *w32[:5], go)
        log(f"{name} {label}: max |diff| to the one-rank {'K5' if full else 'K6'} " + ", ".join(
            f"{n} {(a.float() - b.float()).abs().max().item():.4g}"
            for n, a, b in zip(names, got, one)))
        ws0 = cut(w32, splits[0])
        Hr = ws0[4].shape[0]

        def form(x, *ws):
            dy, sg, fin = sw.swiglu_tp_bwd_cuda(x, *ws[:5], ws[6], ws[7], H, TP_RANKS, full=full)
            return (*sg, *fin())

        def form_plain(x, *ws):
            dy, sg, fin = sw.swiglu_tp_bwd_plain(x, *ws[:5], ws[6], ws[7], H)
            return (*sg, *fin())

        record(name, f"{label} (one rank's form: slice H{Hr}, its own dY)", 0,
               graph_ms(form, (x, *ws0, go, total)), graph_ms(form_plain, (x, *ws0, go, total)),
               worst, ffn_flops(rows, C, Hr, 5, 8, 3),
               moved_bytes(x, *ws0, go, total, *got) + 2 * moved_bytes(dys[0]))

    # ---- K4 and K6 at the denoiser's training shape ----
    Bt, Lt, C, H = TP_DENOISER
    K = 5
    rows = Bt * Lt
    x, go = rnd(Bt, Lt, C), rnd(Bt, Lt, C)
    w = ffn(C, H)
    w32 = [t.float() for t in w]  # the f32 parameters of training
    splits = tp_slices(H)
    bufs, bufs32 = [], []
    for r, sp in enumerate(splits):
        ws, ws32 = cut(w, sp), cut(w32, sp)
        buf = sw.swiglu_tp_partial_cuda(x, *ws[:5], H, TP_RANKS)
        bufs.append(buf)
        bufs32.append(sw.swiglu_tp_partial_plain(x.float(), *ws32[:5]))
        workspace_rule(f"swiglu_tp B{Bt} L{Lt} C{C} slice {r} (H{ws[4].shape[0]}) first phase",
                       rows, C, buf, sw.swiglu_tp_partial_plain(x, *ws[:5]), bufs32[-1])
        if not torch.equal(sw.swiglu_tp_partial_cuda(x, *ws[:5], H, TP_RANKS), buf):
            raise RuntimeError(f"swiglu_tp slice {r}: two launches differ")
    total, total32 = bufs[0] + bufs[1], bufs32[0] + bufs32[1]
    out = sw.swiglu_tp_finish_cuda(total, x, w[5], H)
    if not torch.equal(sw.swiglu_tp_finish_cuda(total, x, w[5], H), out):
        raise RuntimeError("swiglu_tp finish: two launches differ")
    ref = sw.swiglu_plain(x.float(), *w32)
    one = sw.swiglu_cuda(x, *w)
    label = f"B{Bt} L{Lt} C{C} H{H} on 2 slices"
    err = f32_rule(f"swiglu_tp {label}, summed and finished", out, sw.swiglu_plain(x, *w), ref)
    f32_rule(f"swiglu_tp {label}, summed and finished", out, one, ref,
             yardstick="one-rank kernel K4")
    ws0 = cut(w, splits[0])

    def k4_tp(x, *ws):
        return sw.swiglu_tp_finish_cuda(sw.swiglu_tp_partial_cuda(x, *ws[:5], H, TP_RANKS), x,
                                        ws[5], H)

    def k4_tp_plain(x, *ws):
        return sw.tp_out_plain(sw.swiglu_tp_partial_plain(x, *ws[:5]), x.shape, ws[5], H, x.dtype)

    Hr = ws0[4].shape[0]
    record("swiglu_tp", f"{label} (one rank's form: slice H{Hr}, its own partials)", 0,
           graph_ms(k4_tp, (x, *ws0)), graph_ms(k4_tp_plain, (x, *ws0)), err,
           ffn_flops(rows, C, Hr, K, 3, 1), moved_bytes(x, *ws0, out) + 2 * moved_bytes(bufs[0]))

    swiglu_bwd_tp_case("swiglu_bwd_tp", False, x, go, w32, splits, total, total32, H, label)
    del x, go, w, w32, bufs, bufs32, total, total32, out, ref, one
    torch.cuda.empty_cache()

    # ---- K5's TP form at the width-384 denoiser's training shape, on the
    # forward's workspace from the K4 TP form ----
    Bt, Lt, C, H = TP_DENOISER_384
    x, go = rnd(Bt, Lt, C), rnd(Bt, Lt, C)
    w32 = [t.float() for t in ffn(C, H)]
    splits = tp_slices(H)
    total = sum(sw.swiglu_tp_partial_cuda(x, *cut(w32, sp)[:5], H, TP_RANKS) for sp in splits)
    total32 = sum(sw.swiglu_tp_partial_plain(x.float(), *cut(w32, sp)[:5]) for sp in splits)
    swiglu_bwd_tp_case("swiglu_bwd_full_tp", True, x, go, w32, splits, total, total32, H,
                       f"B{Bt} L{Lt} C{C} H{H} on 2 slices")
    del x, go, w32, total, total32
    torch.cuda.empty_cache()

    # ---- K2 and K3 at the latent stage's four levels ----
    C, H, levels = TP_LATENT
    splits = tp_slices(H)
    for i, (Bt, Lt) in enumerate(levels):
        args = film_args(Bt, Lt, False, C)
        x, scale, shift, gate, g1, g2, *w = args
        go = rnd(Bt, Lt, C)
        rows = Bt * Lt
        label = f"B{Bt} L{Lt} C{C} H{H} on 2 slices"
        f32args = [t.float() for t in args]
        bufs, bufs32, ys = [], [], []
        for r, sp in enumerate(splits):
            ws, ws32 = cut(w, sp), cut(f32args[6:], sp)
            buf, y = fl.film_layer_tp_partial_cuda(x, scale, shift, gate, g1, g2, *ws[:5], H,
                                                   TP_RANKS)
            bufs32.append(fl.film_layer_tp_partial_plain(*f32args[:3], f32args[4], *ws32[:5]))
            y_ref = sw.depthwise_conv(fl.film_in(*f32args[:3], f32args[4]), *f32args[6:8])
            y_plain = sw.depthwise_conv(fl.film_in(x, scale, shift, g1), *w[:2])
            f32_rule(f"film_layer_tp {label} slice {r} y", y, y_plain, y_ref)
            workspace_rule(f"film_layer_tp {label} slice {r} first phase from its y", rows, C,
                           buf, sw.tp_partial_plain(y, *ws[2:5]),
                           sw.tp_partial_plain(y.float(), *ws32[2:5]))
            again = fl.film_layer_tp_partial_cuda(x, scale, shift, gate, g1, g2, *ws[:5], H,
                                                  TP_RANKS)
            if not (torch.equal(again[0], buf) and torch.equal(again[1], y)):
                raise RuntimeError(f"film_layer_tp {label} slice {r}: two launches differ")
            bufs.append(buf)
            ys.append(y)
        total, total32 = bufs[0] + bufs[1], bufs32[0] + bufs32[1]
        out = fl.film_layer_tp_finish_cuda(total, x, gate, g2, w[5], H)
        ref = fl.film_layer_plain(*f32args)
        err = f32_rule(f"film_layer_tp {label}, summed and finished", out,
                       fl.film_layer_plain(*args), ref)
        f32_rule(f"film_layer_tp {label}, summed and finished", out, fl.film_layer_cuda(*args),
                 ref, yardstick="one-rank kernel K2")
        ws0 = cut(w, splits[0])
        Hr = ws0[4].shape[0]

        def k2_tp(x, scale, shift, gate, g1, g2, *ws):
            buf, _ = fl.film_layer_tp_partial_cuda(x, scale, shift, gate, g1, g2, *ws[:5], H,
                                                   TP_RANKS)
            return fl.film_layer_tp_finish_cuda(buf, x, gate, g2, ws[5], H)

        def k2_tp_plain(x, scale, shift, gate, g1, g2, *ws):
            buf = fl.film_layer_tp_partial_plain(x, scale, shift, g1, *ws[:5])
            return fl.film_tp_out_plain(buf, x, gate, g2, ws[5], H)

        f_args = (x, scale, shift, gate, g1, g2, *ws0)
        record("film_layer_tp", f"{label} (one rank's form: slice H{Hr}, its own partials)", i,
               graph_ms(k2_tp, f_args), graph_ms(k2_tp_plain, f_args), err,
               ffn_flops(rows, C, Hr, 5, 3, 1),
               moved_bytes(*f_args, out) + 2 * moved_bytes(bufs[0]) + moved_bytes(ys[0]))

        dys, grads, reps, finishes = [], [], [], []
        for r, sp in enumerate(splits):
            ws, ws32 = cut(w, sp), cut(f32args[6:], sp)
            dy, sg, rp, fin = fl.film_layer_tp_bwd_cuda(x, scale, shift, gate, g1, g2, *ws, go,
                                                        total, ys[r], H, TP_RANKS)
            dy32, sg32, rp32, _ = fl.film_layer_tp_bwd_plain(*f32args[:6], *ws32, go.float(),
                                                             total32, H)
            dyp, sgp, rpp, _ = fl.film_layer_tp_bwd_plain(x, scale, shift, gate, g1, g2, *ws, go,
                                                          total, H)
            check_grads(f"film_layer_bwd_tp {label} slice {r} first phase",
                        ("dY partial", "d_vg_kernel", "d_vg_bias", "d_out_kernel", "dgate", "dg2",
                         "d_out_bias"),
                        (dy.sum(0), *sg, *rp), (dy32.sum(0), *sg32, *rp32),
                        (dyp.sum(0), *sgp, *rpp))
            again = fl.film_layer_tp_bwd_cuda(x, scale, shift, gate, g1, g2, *ws, go, total, ys[r],
                                              H, TP_RANKS)
            if not (torch.equal(again[0], dy) and equal_all(again[1], sg)
                    and equal_all(again[2], rp)):
                raise RuntimeError(f"film_layer_bwd_tp {label} slice {r}: two launches differ")
            dys.append(dy)
            grads.append(sg)
            reps.append(rp)
            finishes.append(fin)
        summed(dys)
        done = [tuple(t.clone() for t in fin()) for fin in finishes]
        same_finish(f"film_layer_bwd_tp {label}", done, finishes[0]())
        full = [torch.zeros_like(t) for t in f32args[8:11]]
        for sp, sg in zip(splits, grads):
            for s, g, f in zip(sp, sg, full):
                s.put(f, g)
        dx, dscale, dshift, dg1, ddw, ddwb = done[0]
        dgate, dg2, dbout = reps[0]
        got = (dx, dscale, dshift, dgate, dg1, dg2, ddw, ddwb, *full, dbout)
        names = ("dx", "dscale", "dshift", "dgate", "dg1", "dg2", "d_dw_kernel", "d_dw_bias",
                 "d_vg_kernel", "d_vg_bias", "d_out_kernel", "d_out_bias")
        worst = check_grads(f"film_layer_bwd_tp {label}, summed and finished", names, got,
                            fl.film_layer_bwd_plain(*f32args, go.float()),
                            fl.film_layer_bwd_plain(*args, go))
        k3 = fl.film_layer_bwd_cuda(*args, go)
        log(f"film_layer_bwd_tp {label}: max |diff| to the one-rank K3 " + ", ".join(
            f"{n} {(a.float() - b.float()).abs().max().item():.4g}"
            for n, a, b in zip(names, got, k3)))

        def k3_tp(x, scale, shift, gate, g1, g2, *ws):
            dy, sg, rp, fin = fl.film_layer_tp_bwd_cuda(x, scale, shift, gate, g1, g2, *ws[:6],
                                                        ws[6], ws[7], ws[8], H, TP_RANKS)
            return (*sg, *rp, *fin())

        def k3_tp_plain(x, scale, shift, gate, g1, g2, *ws):
            dy, sg, rp, fin = fl.film_layer_tp_bwd_plain(x, scale, shift, gate, g1, g2, *ws[:6],
                                                         ws[6], ws[7], H)
            return (*sg, *rp, *fin())

        b_args = (x, scale, shift, gate, g1, g2, *ws0, go, total, ys[0])
        record("film_layer_bwd_tp", f"{label} (one rank's form: slice H{Hr}, its own dY)", i,
               graph_ms(k3_tp, b_args), graph_ms(k3_tp_plain, b_args), worst,
               ffn_flops(rows, C, Hr, 5, 9, 3),
               moved_bytes(*b_args, *got) + 2 * moved_bytes(dys[0]))
        del args, f32args, x, go, w, bufs, bufs32, ys, total, total32, out, ref, dys, got, k3
    torch.cuda.empty_cache()
    tp_prologue_forms(rnd, check_grads, record, equal_all, same_finish, summed)
    log(f"phase 1e: the seven TP forms checked [{smi}]")


def tp_prologue_forms(rnd, check_grads, record, equal_all, same_finish, summed) -> None:
    """phase 1e's K11 and K12 TP forms at TP_PROLOGUE, on both ranks'
    heads: K11's on each rank's columns within 4 ulp of its plain version,
    rerunning bit-identically; K12's phase 0 on each rank against its plain
    version (GRAD_REL of f32), the dy partials summed, every rank's phase 1
    the same bit for bit, the gradients put together within GRAD_REL of the
    f32 one-rank backward (and beside the one-rank K12); one rank's forms
    timed by graph replay"""
    import torch

    from osu_dreamer_tpu_torch.ops import film_qkv as fq
    from osu_dreamer_tpu_torch.parallel.tp import Split, even_split

    Bt, Lt, C, heads, D = TP_PROLOGUE
    F, rows = 3 * heads * D, Bt * Lt
    args = (rnd(Bt, Lt, C), rnd(Bt, C, scale=0.3), rnd(Bt, C, scale=0.3),
            rnd(Bt, Lt, C, scale=0.5), rnd(C, F, scale=C**-0.5).float(), rnd(F, scale=0.1).float())
    go = rnd(Bt, Lt, F)
    splits = []
    for r in range(TP_RANKS):
        lo, hi = even_split(heads, TP_RANKS, r)
        splits.append((Split(1, 3, D, heads, lo, hi), Split(0, 3, D, heads, lo, hi)))

    def rank_args(sk, sb):
        """a rank's inputs: the replicated x, scale, shift, add and its
        columns of the kernel, bias and output gradient"""
        return ((*args[:4], sk.take(args[4]), sb.take(args[5])),
                sk.take(go.reshape(rows, F)).reshape(Bt, Lt, -1))

    label = f"B{Bt} L{Lt} C{C} {heads} x {D} heads on 2 slices"
    outs, dys, parts, finishes, worst_fwd = [], [], [], [], 0.0
    for r, (sk, sb) in enumerate(splits):
        sargs, g_r = rank_args(sk, sb)
        out = fq.film_qkv_tp_fwd_cuda(*sargs)
        want = fq.film_qkv_plain(*sargs).float()
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
        log(f"film_qkv_tp {label} slice {r} (F{sargs[4].shape[1]}): max_abs_err {err:.3g} "
            f"(tolerance {tol:.3g})")
        if not (bool(torch.isfinite(out).all()) and err <= tol):
            raise RuntimeError(f"film_qkv_tp slice {r}: the form disagrees with its plain version")
        if not torch.equal(fq.film_qkv_tp_fwd_cuda(*sargs), out):
            raise RuntimeError(f"film_qkv_tp slice {r}: two launches differ")
        worst_fwd = max(worst_fwd, err)
        dy, sg, fin = fq.film_qkv_tp_bwd_cuda(*sargs, g_r)
        dy32, sg32, _ = fq.film_qkv_tp_bwd_plain(*(t.float() for t in sargs), g_r.float())
        dyp, sgp, _ = fq.film_qkv_tp_bwd_plain(*sargs, g_r)
        check_grads(f"film_qkv_bwd_tp {label} slice {r} first phase",
                    ("dy partial", "dkernel", "dbias"), (dy, *sg), (dy32, *sg32), (dyp, *sgp))
        again = fq.film_qkv_tp_bwd_cuda(*sargs, g_r)
        if not (torch.equal(again[0], dy) and equal_all(again[1], sg)):
            raise RuntimeError(f"film_qkv_bwd_tp slice {r}: two launches differ")
        outs.append(out)
        dys.append(dy)
        parts.append(sg)
        finishes.append(fin)
    summed(dys)
    done = [tuple(t.clone() for t in fin()) for fin in finishes]
    same_finish(f"film_qkv_bwd_tp {label}", done, finishes[0]())
    dw, db = torch.zeros_like(args[4]), torch.zeros_like(args[5])
    for (sk, sb), (dw_r, db_r) in zip(splits, parts):
        sk.put(dw, dw_r)
        sb.put(db, db_r)
    got = (*done[0], dw, db)
    names = ("dx", "dscale", "dshift", "dadd", "dkernel", "dbias")
    worst = check_grads(f"film_qkv_bwd_tp {label}, summed and finished", names, got,
                        fq.film_qkv_bwd_plain(*(t.float() for t in args), go.float()),
                        fq.film_qkv_bwd_plain(*args, go))
    one = fq.film_qkv_bwd_cuda(*args, go)
    log(f"film_qkv_bwd_tp {label}: max |diff| to the one-rank K12 " + ", ".join(
        f"{n} {(a.float() - b.float()).abs().max().item():.4g}"
        for n, a, b in zip(names, got, one)))
    sargs, g_0 = rank_args(*splits[0])
    Fr = sargs[4].shape[1]

    def k12_tp(*a):
        _, sg, fin = fq.film_qkv_tp_bwd_cuda(*a)
        return (*sg, *fin())

    def k12_tp_plain(*a):
        _, sg, fin = fq.film_qkv_tp_bwd_plain(*a)
        return (*sg, *fin())

    record("film_qkv_tp", f"{label} (one rank's form: slice F{Fr})", 0,
           graph_ms(fq.film_qkv_tp_fwd_cuda, sargs), graph_ms(fq.film_qkv_plain, sargs),
           worst_fwd, 2 * rows * C * Fr, moved_bytes(*sargs, outs[0]))
    record("film_qkv_bwd_tp", f"{label} (one rank's form: slice F{Fr}, its own dy)", 0,
           graph_ms(k12_tp, (*sargs, g_0)), graph_ms(k12_tp_plain, (*sargs, g_0)), worst,
           4 * rows * C * Fr,
           moved_bytes(*sargs, g_0, *done[0], *parts[0]) + 2 * moved_bytes(dys[0]))
    del args, go, outs, dys, parts, finishes, done, got, one
    torch.cuda.empty_cache()


# phase 10: tensor parallelism on two ranks, placed as phase 9's: (a)
# fit-denoiser at the shipped config with tp 2 through fit.run (which spawns
# its ranks), (b) fit-latent at its shipped config with tp 2 in one spawn of
# the script's own ranks, with the one-step checks. Per rank and step the
# kernels launch exactly as below (the TP forms, K9/K10 at 8 heads a rank,
# no one-rank K4/K6 or K2/K3); each TP step stays within PARALLEL_RATIO of
# the one-process kernel step's error against the f32 plain step
TP_STEPS = 6
TP_LATENT_STEPS = 4
TP_DENOISER_LAUNCHES = {"swiglu_tp": 8, "swiglu_bwd_tp": 8, "fused_attention_fwd": 8,
                        "fused_attention_bwd": 8}
# (c) the width-384 denoiser at tp 2 (512 of 1024 hidden units a rank): its
# one-rank SwiGLU backward is K5, so a slice's is K5's TP form
TP_DENOISER_384_LAUNCHES = {"swiglu_tp": 8, "swiglu_bwd_full_tp": 8, "fused_attention_fwd": 8,
                            "fused_attention_bwd": 8}
# (d) the shipped denoiser at tp 2 with OSU_DREAMER_FUSED_PROLOGUE=1: the
# prologue's TP forms in every layer (1536 qkv columns a rank), no one-rank
# K11/K12 and no torch prologue
TP_DENOISER_PROLOGUE_LAUNCHES = {**TP_DENOISER_LAUNCHES, "film_qkv_tp": 8, "film_qkv_bwd_tp": 8}
# the one-step checks' widths: the shipped 512 (K6's TP form), 384 (K5's)
# and 144, whose one-rank backward is the plain version (C % 32 != 0), so a
# slice's is the plain TP form on the card
TP_CHECK_WIDTHS = (512, 384, 144)
TP_LATENT_LAUNCHES = {"film_layer_tp": 88, "film_layer_bwd_tp": 88}


def tp_model(model, devices: list[str], batch_size: int):
    """a copy of the one-process ``model`` holding this rank's slices under
    ``parallel: {tp: 2}`` -> (the copy, the parallel context)"""
    import copy

    import torch.distributed as dist

    from osu_dreamer_tpu_torch.nn.blocks import shard_tensor_parallel
    from osu_dreamer_tpu_torch.parallel import ParallelArgs, build_parallelism

    par = build_parallelism(ParallelArgs(tp=2), batch_size, devices)
    sliced = copy.deepcopy(model)
    if shard_tensor_parallel(sliced, par) is None:
        raise RuntimeError("phase 10: nothing of the model was split")
    return sliced, par


def whole_grads(model, grads) -> list:
    """a tensor-parallel rank's gradients as the whole model's (gathered
    over the model group)"""
    from osu_dreamer_tpu_torch.parallel.tp import layout_of

    layout = layout_of(model)
    names = [n for n, _ in model.named_parameters()]
    return [layout.gather(n, g) for n, g in zip(names, grads)]


def denoiser_tp_check(cfg: dict, devices: list[str], prologue: bool = False) -> None:
    """phase 10's one-step check of the denoiser at ``cfg``'s width (B128
    L152): the tp 2 step launches the SwiGLU TP forms ``swiglu_tp_route``
    names (8 each; none for the plain backward) and, with ``prologue``
    (called under OSU_DREAMER_FUSED_PROLOGUE=1), K11's and K12's TP forms 8
    each (none otherwise), and its loss terms and gradients (gathered) stay
    within PARALLEL_RATIO of the one-process kernel step's error against
    the f32 plain step on the same random full-strength weights, batch, t
    and x0 (in each rank; rank 0 compares)"""
    import torch
    import torch.distributed as dist

    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel, DiffusionModelArgs
    from osu_dreamer_tpu_torch.models.diffusion.train import (
        DiffusionTrainArgs, LatentBatch, step_gradients,
    )
    from osu_dreamer_tpu_torch.ops import _build
    from osu_dreamer_tpu_torch.ops.swiglu import swiglu_tp_route
    from osu_dreamer_tpu_torch.train.state import stratified_logit_normal_t
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    dev = torch.device(devices[dist.get_rank()])
    md = cfg["model"]
    model_args = dataclass_from_dict(DiffusionModelArgs, md)
    train_args = dataclass_from_dict(DiffusionTrainArgs, cfg["train"])
    bf16_model = DiffusionModel(model_args, torch.bfloat16).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    randomize_(bf16_model, gen)
    Bt, Lt = cfg["data"]["batch_size"], cfg["data"]["seq_len"]
    z = torch.randn(Bt, Lt, md["emb_dim"], generator=gen, device=dev)
    batch = LatentBatch(h=torch.rand(Bt, Lt, md["a_dim"], generator=gen, device=dev),
                        z=z / z.square().mean(-1, keepdim=True).sqrt(),
                        s=torch.randn(Bt, md["style_dim"], generator=gen, device=dev),
                        labels=torch.rand(Bt, 5, generator=gen, device=dev) * 10)
    t_inj = stratified_logit_normal_t(Bt, gen, dev)
    x0_inj = torch.randn(batch.z.shape, generator=gen, device=dev)
    names = ("loss", "osl", "del", "u_mape")

    def flat(metrics, grads):
        return (torch.stack([metrics[k].float() for k in names]),
                torch.cat([g.flatten().float() for g in grads]))

    sliced, par = tp_model(bf16_model, devices, Bt)
    before = dict(_build.launches)
    metrics, grads = step_gradients(sliced, par.shard_batch(batch), train_args, None, t_inj,
                                    x0_inj, par)
    spread = flat(metrics, whole_grads(sliced, grads))
    launched = {k: n - before[k] for k, n in _build.launches.items() if n != before[k]}
    del sliced, grads
    width = md["backbone_dim"]
    what = f"phase 10 fit-denoiser tp 2, width {width}" + (", fused prologue" if prologue else "")
    hidden = int(width * md["backbone"]["expand"] * 2 / 3)
    route = swiglu_tp_route(width, 2 * md["backbone"]["radius"] + 1, hidden, 2, dev)
    want = {"full": "swiglu_bwd_full_tp", "partial": "swiglu_bwd_tp", "plain": None}[route[1]]
    bwd = {k: launched.get(k, 0) for k in ("swiglu_bwd_tp", "swiglu_bwd_full_tp")}
    forms = {k: launched.get(k, 0) for k in ("film_qkv_tp", "film_qkv_bwd_tp")}
    if route[0] != "kernel" or launched.get("swiglu_tp") != 8 or bwd != {
            k: 8 if k == want else 0 for k in bwd} or forms != dict.fromkeys(forms, 8 * prologue):
        raise RuntimeError(f"{what}: the TP step launched {launched} on the route {route}")
    if dist.get_rank() == 0:
        log(f"{what}: the TP step's SwiGLU route {route}, launches {launched}")
        f32_model = DiffusionModel(model_args, torch.float32).to(dev)
        f32_model.load_state_dict(bf16_model.state_dict())
        with plain_ops():
            ref = flat(*step_gradients(f32_model, batch, train_args, None, t_inj, x0_inj))
        del f32_model
        one = flat(*step_gradients(bf16_model, batch, train_args, None, t_inj, x0_inj))
        check_step(what, names, ref, spread, one,
                   ratios=(PARALLEL_RATIO, PARALLEL_RATIO),
                   labels=("tp 2 ranks", "one-process kernels"))
    del bf16_model
    torch.cuda.empty_cache()
    dist.barrier()


def latent_tp_check(cfg: dict, devices: list[str]) -> None:
    """phase 10's one-step check of the latent stage at full width (B32
    L2052), held as ``denoiser_tp_check`` holds the denoiser's, its 13 terms
    pooled as in phase 5"""
    import torch
    import torch.distributed as dist

    from osu_dreamer_tpu_torch.models.latent.model import LatentModel, LatentModelArgs
    from osu_dreamer_tpu_torch.models.latent.train import (
        LOSS_COMPONENTS, LOSS_WEIGHTS, Batch, LatentTrainArgs, draw_latent, latent_loss,
    )
    from osu_dreamer_tpu_torch.parallel.tp import layout_of
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    dev = torch.device(devices[dist.get_rank()])
    model_args = dataclass_from_dict(LatentModelArgs, cfg["model"])
    train_args = dataclass_from_dict(LatentTrainArgs, cfg["train"])
    bf16_model = LatentModel(model_args, torch.bfloat16).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    randomize_(bf16_model, gen)
    Bt, Lt = cfg["data"]["batch_size"], cfg["data"]["seq_len"]
    batch = Batch(audio=torch.rand(Bt, Lt, 72, generator=gen, device=dev),
                  chart=torch.rand(Bt, Lt, 9, generator=gen, device=dev),
                  labels=torch.rand(Bt, 5, generator=gen, device=dev) * 10)
    draws = draw_latent(2 * Bt, model_args.style_dim, Lt // 2 // model_args.chunk_size,
                        model_args.emb_dim, gen, dev)
    weights = torch.from_numpy(LOSS_WEIGHTS).to(dev)

    def terms_and_grads(model, batch, par=None):
        comps, _, s_reg = latent_loss(model, batch, train_args, draws=draws, par=par)
        total = (weights * comps / comps.detach().clamp_min(1e-8)).sum()
        total = total + train_args.s_reg_weight * s_reg
        grads = list(torch.autograd.grad(total, list(model.parameters()),
                                         materialize_grads=True))
        if par is not None:
            grads = whole_grads(model, par.average_gradients(grads, layout_of(model)))
        terms = torch.cat([comps.detach().float(), torch.stack([s_reg, total]).detach().float()])
        return terms, torch.cat([g.flatten().float() for g in grads])

    sliced, par = tp_model(bf16_model, devices, Bt)
    spread = terms_and_grads(sliced, par.shard_batch(batch), par)
    del sliced
    if dist.get_rank() == 0:
        f32_model = LatentModel(model_args, torch.float32).to(dev)
        f32_model.load_state_dict(bf16_model.state_dict())
        with plain_ops():
            ref = terms_and_grads(f32_model, batch)
        del f32_model
        check_step("phase 10 fit-latent tp 2", (*LOSS_COMPONENTS, "s_reg", "loss"), ref, spread,
                   terms_and_grads(bf16_model, batch), pool_terms=True,
                   ratios=(PARALLEL_RATIO, PARALLEL_RATIO),
                   labels=("tp 2 ranks", "one-process kernels"))
    del bf16_model
    torch.cuda.empty_cache()
    dist.barrier()


def reload_one_process(what: str, state, last: Path, steps: int) -> None:
    """a tensor-parallel fit's ``last`` checkpoint (rank 0's, gathered) read
    back into the one-process train ``state``: every tensor of its layout,
    finite"""
    import torch

    from osu_dreamer_tpu_torch.train.checkpoint import restore_train_state

    state = restore_train_state(last, state)
    params = list(state.model.parameters())
    if state.step != steps or not all(bool(torch.isfinite(p).all()) for p in params):
        raise RuntimeError(f"{what}: the gathered checkpoint did not reload into a one-process "
                           "state")
    log(f"{what}: rank 0's gathered last checkpoint reloads into a one-process state "
        f"({sum(p.numel() for p in params):,} parameters, step {state.step})")
    del state, params
    torch.cuda.empty_cache()


def tp_rank(workdir: str, latent_cfg: dict, denoiser_cfg: dict, devices: list[str]) -> None:
    """phase 10 (b) and the one-step checks, in each of two ranks: the tp 2
    latent stage through its ``fit.run`` (finding the process group joined),
    rank 0's checkpoint read back, then the checks (the denoiser at each of
    TP_CHECK_WIDTHS)"""
    import torch
    import torch.distributed as dist

    from osu_dreamer_tpu_torch.models.latent import fit as latent_fit
    from osu_dreamer_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.reset_launches()
    state = latent_fit.run(latent_cfg, device=devices[0], devices=devices,
                           on_step=functools.partial(rank_probe,
                                                     str(Path(workdir) / "probe_latent")))
    del state
    torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        reload_one_process("phase 10 fit-latent tp 2",
                           latent_state(latent_cfg, torch.device(devices[0])),
                           Path(latent_cfg["fit"]["run_dir"]) / "last",
                           latent_cfg["fit"]["max_steps"])
    dist.barrier()
    for width in TP_CHECK_WIDTHS:
        denoiser_tp_check({**denoiser_cfg, "model": {**denoiser_cfg["model"],
                                                     "backbone_dim": width}}, devices)
    with fused_prologue():
        denoiser_tp_check(denoiser_cfg, devices, prologue=True)
    latent_tp_check(latent_cfg, devices)


def latent_state(cfg: dict, dev):
    """a one-process latent train state for ``cfg`` (bf16 compute)"""
    import torch

    from osu_dreamer_tpu_torch.models.latent.model import LatentModelArgs
    from osu_dreamer_tpu_torch.models.latent.train import LatentTrainArgs, init_latent_training
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    return init_latent_training(dataclass_from_dict(LatentModelArgs, cfg["model"]),
                                dataclass_from_dict(LatentTrainArgs, cfg["train"]), 0, dev,
                                torch.bfloat16)[0]


def tp_phase(dev, smi: str) -> dict[str, int]:
    """phase 10: tensor-parallel training on the card -> the kernel launches
    of the two fits' ranks"""
    import torch

    from osu_dreamer_tpu_torch.data.synth import write_latent_corpus, write_signal_corpus
    from osu_dreamer_tpu_torch.models.diffusion import fit as diffusion_fit
    from osu_dreamer_tpu_torch.models.latent import fit as latent_fit
    from osu_dreamer_tpu_torch.parallel.distributed import backend_for, launch
    from osu_dreamer_tpu_torch.utils import load_yaml_config

    t_phase = time.perf_counter()
    devices = ["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2 else ["cuda:0", "cuda:0"]
    shared = backend_for([torch.device(d) for d in devices]) == "gloo"
    log(f"phase 10: two tensor-parallel ranks on {devices}: " + (
        "they share one card and talk over gloo (each all-reduce staged through the host)"
        if shared else "one card each, over NCCL"))
    workdir = ROOT / "build" / "smoke_tp"
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()

    denoiser_cfg = load_yaml_config(diffusion_fit.CONFIG)
    md = denoiser_cfg["model"]
    write_latent_corpus(workdir / "latents", 64, 4, 152 * 12, md["a_dim"], md["emb_dim"],
                        md["style_dim"], SEED)
    denoiser_cfg["data"].update(data_dir=str(workdir / "latents"), max_per_map=-1,
                                max_val_count=2)
    denoiser_cfg["fit"].update(run_dir=str(workdir / "runs_denoiser"), max_steps=TP_STEPS,
                               log_every=5)
    denoiser_cfg["parallel"] = {"tp": 2}
    latent_cfg = load_yaml_config(latent_fit.CONFIG)
    write_signal_corpus(workdir / "signals", *LATENT_CORPUS, SEED)
    latent_cfg["data"].update(data_dir=str(workdir / "signals"), max_per_map=-1,
                              max_val_count=2)
    latent_cfg["fit"].update(run_dir=str(workdir / "runs_latent"), max_steps=TP_LATENT_STEPS,
                             log_every=5)
    latent_cfg["parallel"] = {"tp": 2}

    # (a) tp 2 through fit.run, as a user runs it: run spawns the ranks and
    # returns rank 0's gathered checkpoint read back into a one-process state
    t0 = time.perf_counter()
    state = diffusion_fit.run(denoiser_cfg, device=dev, devices=devices,
                              on_step=functools.partial(rank_probe, str(workdir / "probe_denoiser")))
    params = list(state.model.parameters())
    if state.step != TP_STEPS or not all(bool(torch.isfinite(p).all()) for p in params):
        raise RuntimeError(f"fit-denoiser tp 2 ended at step {state.step} or not finite")
    log(f"phase 10 (a) fit-denoiser tp 2 (width 512, 8 of 16 x 64 heads and 683/682 of 1365 "
        f"hidden units a rank, B128 x L152, bf16): {TP_STEPS} steps, "
        f"{time.perf_counter() - t0:.1f} s wall with the spawn, validation and rank 0's "
        f"gathered checkpoint read back into a one-process state "
        f"({sum(p.numel() for p in params):,} parameters)")
    del state, params
    torch.cuda.empty_cache()
    launches = read_probe(workdir / "probe_denoiser", "fit-denoiser tp 2", TP_STEPS,
                          TP_DENOISER_LAUNCHES, smi)

    # (c) the width-384 denoiser at tp 2 through fit.run: K5's TP form
    t0 = time.perf_counter()
    cfg384 = {**denoiser_cfg, "model": {**denoiser_cfg["model"], "backbone_dim": 384},
              "fit": {**denoiser_cfg["fit"], "run_dir": str(workdir / "runs_denoiser_384")}}
    state = diffusion_fit.run(cfg384, device=dev, devices=devices,
                              on_step=functools.partial(rank_probe,
                                                        str(workdir / "probe_denoiser_384")))
    if state.step != TP_STEPS or not all(bool(torch.isfinite(p).all())
                                         for p in state.model.parameters()):
        raise RuntimeError(f"fit-denoiser tp 2 at width 384 ended at step {state.step} or not "
                           "finite")
    log(f"phase 10 (c) fit-denoiser tp 2 at width 384 (512 of 1024 hidden units a rank, K5's "
        f"TP form): {TP_STEPS} steps, {time.perf_counter() - t0:.1f} s wall with the spawn")
    del state
    torch.cuda.empty_cache()
    for k, n in read_probe(workdir / "probe_denoiser_384", "fit-denoiser tp 2, width 384",
                           TP_STEPS, TP_DENOISER_384_LAUNCHES, smi).items():
        launches[k] += n

    # (d) the shipped denoiser at tp 2 with the fused prologue through
    # fit.run: the TP forms of K11 and K12 in every layer
    t0 = time.perf_counter()
    cfg_on = {**denoiser_cfg, "fit": {**denoiser_cfg["fit"],
                                      "run_dir": str(workdir / "runs_denoiser_prologue")}}
    with fused_prologue():
        state = diffusion_fit.run(cfg_on, device=dev, devices=devices,
                                  on_step=functools.partial(
                                      rank_probe, str(workdir / "probe_denoiser_prologue")))
    if state.step != TP_STEPS or not all(bool(torch.isfinite(p).all())
                                         for p in state.model.parameters()):
        raise RuntimeError(f"fit-denoiser tp 2 with the fused prologue ended at step "
                           f"{state.step} or not finite")
    log(f"phase 10 (d) fit-denoiser tp 2, OSU_DREAMER_FUSED_PROLOGUE=1 (8 of 16 x 64 heads a "
        f"rank: K11's and K12's TP forms on 1536 of the 3072 qkv columns): {TP_STEPS} steps, "
        f"{time.perf_counter() - t0:.1f} s wall with the spawn")
    del state
    torch.cuda.empty_cache()
    for k, n in read_probe(workdir / "probe_denoiser_prologue",
                           "fit-denoiser tp 2, OSU_DREAMER_FUSED_PROLOGUE=1", TP_STEPS,
                           TP_DENOISER_PROLOGUE_LAUNCHES, smi).items():
        launches[k] += n

    # (b) the latent stage at tp 2, then the one-step checks, in one spawn
    t0 = time.perf_counter()
    launch(tp_rank, (str(workdir), latent_cfg, denoiser_cfg, devices), devices, 2, deadline_s=900)
    log(f"phase 10 (b) and the one-step checks: {time.perf_counter() - t0:.1f} s wall")
    for k, n in read_probe(workdir / "probe_latent",
                           "fit-latent tp 2 (B32 x L2052, 171/170 of 341 hidden units a rank)",
                           TP_LATENT_STEPS, TP_LATENT_LAUNCHES, smi).items():
        launches[k] += n
    for run_dir in ("runs_denoiser", "runs_denoiser_384", "runs_denoiser_prologue", "runs_latent"):
        if not (workdir / run_dir / "last" / "state.pt").exists():
            raise RuntimeError(f"phase 10: rank 0 wrote no {run_dir}/last")
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 10 wall {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return launches


@contextmanager
def no_plain_attention():
    """the plain attention versions raise on a CUDA tensor: a path run
    inside takes the kernels or fails"""
    from osu_dreamer_tpu_torch.ops import fused_attention, long_attention, norm_rope

    saved = (long_attention.attention_plain, fused_attention.rope_attention_plain,
             norm_rope.norm_rope_qkv_plain)

    def guarded(plain):
        def call(x, *rest):
            if x.is_cuda:
                raise RuntimeError(f"{plain.__name__} ran on the card")
            return plain(x, *rest)
        return call

    long_attention.attention_plain = guarded(saved[0])
    fused_attention.rope_attention_plain = guarded(saved[1])
    norm_rope.norm_rope_qkv_plain = guarded(saved[2])
    try:
        yield
    finally:
        (long_attention.attention_plain, fused_attention.rope_attention_plain,
         norm_rope.norm_rope_qkv_plain) = saved


def request_launches(model, out_frames: list[int], requests: list[int] | None = None) -> dict:
    """the launches of one sampler run a batch (or ``requests[i]`` runs of
    batch i: one a shard): one resonator, the latent U-Net's film layers,
    and per backbone layer and denoiser pass one SwiGLU and the attention
    kernel ``attention_route`` names for the batch's latent length"""
    from osu_dreamer_tpu_torch.ops import _build
    from osu_dreamer_tpu_torch.ops.fused_attention import attention_route

    chunk = model.args.latent.chunk_size
    backbone = model.args.diffusion.backbone
    expected = dict.fromkeys(_build.KERNELS, 0)
    for frames, n in zip(out_frames, requests or [1] * len(out_frames)):
        route = attention_route(frames // chunk, backbone.n_heads, backbone.head_dim)
        expected["resonator"] += RESONATOR_PER_REQUEST * n
        expected["film_layer"] += FILM_PER_REQUEST * n
        expected["swiglu"] += SWIGLU_PER_REQUEST * n
        expected["fused_attention_fwd" if route == "fused" else "flash_attention"] += \
            FLASH_PER_REQUEST * n
        if route == "long":
            expected["qk_prep"] += FLASH_PER_REQUEST * n
    return expected


def out_frames_of(model, seconds: float) -> int:
    """``prep_wave_for_model``'s padded length for a song of ``seconds``"""
    from osu_dreamer_tpu_torch.audio.constants import SR
    from osu_dreamer_tpu_torch.audio.spectrogram import prep_wave_for_model

    return prep_wave_for_model(np.zeros(int(seconds * SR), np.float32),
                               model.args.latent.chunk_size)[3]


# phase 3c: predict --batch-songs SHARD_SONGS over two replicas of phase 3's
# model on the one card (the replica list repeats it), songs written at the
# model's rate; serve's burst (SHARD_SONGS unseeded two-row requests) and
# one seeded request on a service over the same two replicas; each beside
# the one-device run
SHARD_SONGS = 4
SHARD_SECONDS = 60.0
SHARD_SEED = 4321


def chart_gap(got, want) -> str:
    """how far two quantized charts and their labels lie apart: the largest
    step on each grid, the share of values off by more than one step, the
    labels' largest gap beside one bf16 ulp of their largest magnitude"""
    (gh, gx, gl), (wh, wx, wl) = got, want
    dh = np.abs(gh.astype(np.int32) - wh.astype(np.int32))
    dx = np.abs(gx.astype(np.int32) - wx.astype(np.int32))
    dl, ulp = np.abs(gl - wl).max(), 2.0 ** (np.floor(np.log2(np.abs(wl).max())) - 7)
    return (f"hit channels within {dh.max()} step(s) ({(dh > 1).mean():.2%} past one), cursor "
            f"within {dx.max()} step(s) ({(dx > 1).mean():.2%} past one), labels within "
            f"{dl:.4g} (one bf16 ulp {ulp:.4g})")


def within_one_step(what: str, got, want) -> None:
    """quantized charts within one step of the grid, labels within one bf16
    ulp of their largest magnitude"""
    (gh, gx, gl), (wh, wx, wl) = got, want
    dh = np.abs(gh.astype(np.int32) - wh.astype(np.int32)).max()
    dx = np.abs(gx.astype(np.int32) - wx.astype(np.int32)).max()
    dl, tol = np.abs(gl - wl).max(), 2.0 ** (np.floor(np.log2(np.abs(wl).max())) - 7)
    log(f"{what}: {chart_gap(got, want)}")
    if dh > 1 or dx > 1 or dl > tol:
        raise RuntimeError(f"{what}: the charts are more than one quantization step apart")


def shard_reference(model, songs: list[Path], dev, replicas) -> None:
    """the sharded sampler against the one-device sampler at the shard's
    batch size: the same noise (drawn at the whole batch's shape in the
    one-device order, s0 then x0) and the same step-size mean over the whole
    batch, each half of the songs sampled on ``model`` itself (the default
    stream, no copy) in its own thread, the means met at a barrier. The
    two must agree within one quantization step; the one-device sampler on
    the whole batch at once, same noise, is logged beside both: the card's
    kernel plans and library products change with the rows a launch holds,
    and bf16 sampling carries that through its steps"""
    import threading

    import torch

    from osu_dreamer_tpu_torch.audio.decode import load_wave
    from osu_dreamer_tpu_torch.audio.spectrogram import prep_wave_for_model
    from osu_dreamer_tpu_torch.models.inference.sampler import (
        build_batch_sampler, build_sharded_sampler, gather_shards,
    )
    from osu_dreamer_tpu_torch.parallel.replicas import replicate, song_shards

    chunk = model.args.latent.chunk_size
    preps = [prep_wave_for_model(load_wave(s), chunk) for s in songs]
    waves = torch.from_numpy(np.stack([p[0] for p in preps]))
    real = torch.tensor([p[1] for p in preps])
    n_frames, out_frames = preps[0][2], preps[0][3]
    labels = torch.tensor(PREDICT_DIFFS, dtype=torch.float32)
    S, D = len(songs), len(PREDICT_DIFFS)
    sharded = build_sharded_sampler(replicate(model, replicas))
    try:
        got = gather_shards(sharded(waves, real, labels, SHARD_SEED, n_frames, out_frames, STEPS,
                                    1.0))
    finally:
        sharded.close()

    gen = torch.Generator(dev).manual_seed(SHARD_SEED)
    s0 = torch.randn(S * D, model.args.style.style_dim, generator=gen, device=dev)
    x0 = torch.randn(S * D, out_frames // chunk, model.args.diffusion.emb_dim, generator=gen,
                     device=dev)
    sample = build_batch_sampler(model)
    host = lambda out: (out[0].cpu().numpy(), out[1].cpu().numpy(),  # noqa: E731
                        out[2].float().cpu().numpy())
    whole = host(sample(waves.to(dev), real.to(dev), labels.to(dev), None, n_frames,
                        out_frames, STEPS, 1.0, s0=s0, x0=x0))
    parts = song_shards(S, len(replicas))
    barrier, sums, halves = threading.Barrier(len(parts)), [None] * len(parts), [None] * len(parts)
    errors: list[BaseException] = []

    def run(k: int, songs_k: slice) -> None:
        def mean(u):
            sums[k] = (float(u.double().sum()), u.numel())
            barrier.wait()
            m = sum(a for a, _ in sums) / sum(n for _, n in sums)
            barrier.wait()
            return torch.tensor(m, dtype=u.dtype, device=u.device)

        rows = slice(songs_k.start * D, songs_k.stop * D)
        try:
            with torch.cuda.device(dev):
                halves[k] = host(sample(waves[songs_k].to(dev), real[songs_k].to(dev),
                                        labels.to(dev), None, n_frames, out_frames, STEPS, 1.0,
                                        s0=s0[rows], x0=x0[rows], batch_mean=mean))
        except BaseException as e:  # noqa: BLE001 — raised below
            barrier.abort()
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k, p)) for k, p in enumerate(parts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    halves = tuple(np.concatenate([h[i] for h in halves]) for i in range(3))
    log(f"sampler, {S} songs x {D} rows, seed {SHARD_SEED}: one device on the whole batch vs "
        f"on halves (same noise and mean) {chart_gap(whole, halves)}; sharded vs one device on "
        f"the whole batch {chart_gap(got, whole)}")
    within_one_step(f"sampler, {S} songs over {len(replicas)} replicas vs one device at the "
                    "shard's batch size", got, halves)


def sharding_phase(model, odt: Path, dev, smi: str) -> dict[str, int]:
    """phase 3c: songs sharded over two replicas on one card -> the kernel
    launches of the sharded predict, the sharded burst and its seeded
    request"""
    import contextlib
    import os
    import threading
    import urllib.request
    import zipfile

    import torch

    from osu_dreamer_tpu_torch.audio.constants import SR
    from osu_dreamer_tpu_torch.cli import run_predict
    from osu_dreamer_tpu_torch.ops import _build
    from osu_dreamer_tpu_torch.serve import GeneratorService, MapServer

    t_phase = time.perf_counter()
    workdir = ROOT / "build" / "smoke_shard"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    songs = [write_song(workdir / f"shard{i}.wav", SHARD_SECONDS, SEED + 30 + i, rate=SR)
             for i in range(SHARD_SONGS)]
    replicas = [dev, dev]
    frames = out_frames_of(model, SHARD_SECONDS)
    launched: dict[str, int] = dict.fromkeys(_build.KERNELS, 0)

    def predict(devices):
        cwd, printed = os.getcwd(), io.StringIO()
        os.chdir(workdir)
        try:
            torch.cuda.synchronize()
            _build.reset_launches()
            t = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                done = run_predict(model, songs, PREDICT_DIFFS, STEPS, seed=SEED,
                                   serialize_workers=2, batch_songs=SHARD_SONGS, device=dev,
                                   devices=devices)
            return done, time.perf_counter() - t, dict(_build.launches), printed.getvalue()
        finally:
            os.chdir(cwd)

    one, one_wall, _, _ = predict([dev])
    sharded, wall, got, printed = predict(replicas)
    lines = [ln for ln in printed.splitlines() if ln.startswith("[parallel]")]
    want = request_launches(model, [frames], [2])
    log(f"predict --batch-songs {SHARD_SONGS} over {len(replicas)} replicas on one card: "
        f"{lines}; {SHARD_SONGS} songs x {SHARD_SECONDS:.0f} s x {len(PREDICT_DIFFS)} "
        f"difficulties, {STEPS} steps: {wall:.2f} s wall sharded, {one_wall:.2f} s on one "
        f"device [{smi}]; launches {got}")
    if lines != [f"[parallel] sharding {SHARD_SONGS}-song batches over 2 of 2 devices"]:
        raise RuntimeError(f"predict printed {lines}")
    if got != want:
        raise RuntimeError(f"the sharded predict launched {got}, not {want}")
    for a, b in zip(sharded, one):
        log(f"predict {a.audio_file.name}: sharded vs one device (4 songs a launch) "
            + chart_gap((a.hit_u8, a.xy_i16, a.labels), (b.hit_u8, b.xy_i16, b.labels)))
    for k, n in got.items():
        launched[k] += n
    shard_reference(model, songs, dev, replicas)

    def serve(replica_devices):
        service = GeneratorService(odt, device=dev, max_batch=SHARD_SONGS, batch_window_ms=400,
                                   serialize_workers=2, replica_devices=replica_devices)
        shard_runs: list[int] = []
        if service._sharded is not None:
            inner = service._sharded

            def recorded(*args):
                out = inner(*args)
                shard_runs.append(len(out))
                return out

            recorded.devices, recorded.close = inner.devices, inner.close
            service._sharded = recorded
        server = MapServer(service, port=0)
        server.start_background()
        host, port = server.address
        try:
            with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=60) as r:
                health = json.load(r)

            def post(song: Path, seed=None) -> tuple[bytes, float]:
                query = "&".join([f"sample_steps={STEPS}", f"name={song.name}"]
                                 + ["diff=" + ",".join(f"{v:g}" for v in row)
                                    for row in PREDICT_DIFFS]
                                 + ([f"seed={seed}"] if seed is not None else []))
                t = time.perf_counter()
                req = urllib.request.Request(f"http://{host}:{port}/generate?{query}",
                                             data=song.read_bytes(), method="POST")
                with urllib.request.urlopen(req, timeout=600) as r:
                    return r.read(), time.perf_counter() - t

            walls = [0.0] * SHARD_SONGS

            def burst() -> float:
                start = threading.Barrier(SHARD_SONGS + 1)

                def client(i):
                    start.wait()
                    walls[i] = post(songs[i])[1]

                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(SHARD_SONGS)]
                for t in threads:
                    t.start()
                start.wait()
                t0 = time.perf_counter()
                for t in threads:
                    t.join()
                return time.perf_counter() - t0

            burst()  # warm-up: every replica's first dispatch (weight packs, streams)
            torch.cuda.synchronize()
            _build.reset_launches()
            shard_runs.clear()
            burst = burst()
            seeded, seeded_wall = post(songs[1], SHARD_SEED)
            torch.cuda.synchronize()
            stats = service.snapshot_stats()
            return (health, burst, walls, seeded, seeded_wall, dict(_build.launches),
                    list(shard_runs), stats)
        finally:
            server.close()

    h1, burst1, walls1, seeded1, sw1, _, _, _ = serve(None)
    h2, burst2, walls2, seeded2, sw2, got, runs, stats = serve(replicas)
    log(f"serve /healthz: one device {h1}; two replicas {h2}")
    if h1["devices"] != 1 or h2["devices"] != 2 or h2["max_batch"] != SHARD_SONGS:
        raise RuntimeError(f"/healthz devices {h1['devices']} and {h2['devices']}, not 1 and 2")
    maps = SHARD_SONGS * len(PREDICT_DIFFS)
    log(f"serve burst of {SHARD_SONGS} unseeded {len(PREDICT_DIFFS)}-row requests on "
        f"{SHARD_SECONDS:.0f} s songs, max_batch {SHARD_SONGS}, 400 ms window: two replicas "
        f"{burst2:.2f} s ({maps / burst2 * 60:.1f} maps/min; request walls "
        + ", ".join(f"{w:.2f}" for w in walls2) + f"; shard runs a dispatch {runs}), one "
        f"device {burst1:.2f} s ({maps / burst1 * 60:.1f} maps/min; request walls "
        + ", ".join(f"{w:.2f}" for w in walls1) + f"); the seeded request {sw2:.2f} s on the "
        f"replicas, {sw1:.2f} s on one device [{smi}]; launches on the replicas {got}; "
        f"stats {stats}")
    # the burst's dispatches and the seeded solo one: one sampler run a shard
    want = request_launches(model, [frames] * len(runs), runs)
    if got != want or not any(n == 2 for n in runs) or runs[-1] != 1:
        raise RuntimeError(f"the sharded service launched {got} over shard runs {runs}, not "
                           f"{want}, or never split a dispatch")
    entries = [{n: z.read(n) for n in z.namelist() if n.endswith(".osu")}
               for z in (zipfile.ZipFile(io.BytesIO(b)) for b in (seeded1, seeded2))]
    if entries[0] != entries[1] or len(entries[0]) != len(PREDICT_DIFFS):
        raise RuntimeError("the seeded request on the replicas wrote other .osu texts than on "
                           "one device")
    log("serve seeded request: the same .osu texts on two replicas as on one device")
    for k, n in got.items():
        launched[k] += n
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 3c wall {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return launched


# phases 4c and 4e: predict with a denoiser of 8 x 128 and of 8 x 96 heads
# at full width, one 120 s song (latent L 759: K7) and one 30 s song (L ~
# 190, inside the JAX gate: K9)
HEADS_SONGS = (120.0, 30.0)
HEADS_TIMED = 4


def head_dim_predict(dev, smi: str, n_heads: int, head_dim: int) -> dict[str, int]:
    """phases 4c and 4e: ``run_predict`` on an LDM whose denoiser has
    ``n_heads`` x ``head_dim`` heads (the shipped widths otherwise;
    init_random weights, the denoiser's randomized at full strength), no
    plain attention on the card -> its kernel launches"""
    import dataclasses
    import os
    import zipfile

    import torch

    from osu_dreamer_tpu_torch.audio.constants import SR
    from osu_dreamer_tpu_torch.cli import run_predict
    from osu_dreamer_tpu_torch.models.inference.artifact import init_random
    from osu_dreamer_tpu_torch.models.inference.model import LDMArgs
    from osu_dreamer_tpu_torch.ops import _build

    args = LDMArgs()
    args.diffusion = dataclasses.replace(args.diffusion, backbone=dataclasses.replace(
        args.diffusion.backbone, n_heads=n_heads, head_dim=head_dim))
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    model = init_random(args, gen, dev)
    randomize_(model.diffusion, gen)
    workdir = ROOT / "build" / "smoke_heads"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    songs = [write_song(workdir / f"heads{i}.wav", seconds, SEED + 40 + i, rate=SR)
             for i, seconds in enumerate(HEADS_SONGS)]
    want = request_launches(model, [out_frames_of(model, s) for s in HEADS_SONGS])
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        with no_plain_attention():
            done = run_predict(model, songs, PREDICT_DIFFS, STEPS, seed=SEED,
                               serialize_workers=2, batch_songs=1, device=dev)
        wall = time.perf_counter() - t
        got = dict(_build.launches)
    finally:
        os.chdir(cwd)
    for d in done:
        with zipfile.ZipFile(d.osz) as z:
            osu = [n for n in z.namelist() if n.endswith(".osu")]
        if len(osu) != len(PREDICT_DIFFS) or d.hit_u8.max() == d.hit_u8.min():
            raise RuntimeError(f"{d.osz.name}: {osu}, hit channels constant")
    heads = f"{n_heads} x {head_dim} heads"
    log(f"predict at {heads}: one {HEADS_SONGS[0]:.0f} s and one {HEADS_SONGS[1]:.0f} s "
        f"song x {len(PREDICT_DIFFS)} difficulties, {STEPS} steps: {wall:.2f} s wall [{smi}]; "
        f"launches {got}")
    if got != want:
        raise RuntimeError(f"predict at {heads} launched {got}, not {want}")
    shutil.rmtree(workdir, ignore_errors=True)
    return got


# phase 1f: the attention kernels off the shipped 16 x 64 at L <= 256, by
# phase 1's rules (4 bf16 ulps, GRAD_REL, bit-identical reruns): the
# templated head dims 32 and 128 (H D = 1024: 32 x 32 and 8 x 128 heads) at
# phase 1's and 1b's shapes; the streamed kernels (csrc/attention_stream.cu)
# at the other head dims of the JAX gate's range (with H D a multiple of
# 128), at 8 x 64 and 2 x 64 heads past L 256, and at the slice's own shapes
WIDE_HEAD_DIMS = (32, 128)
FLASH_SHAPES = ((4, 759), (4, 65), (1, 2500))
FUSED_SHAPES = [("B128 L152", 128, 152)] + [(f"B2 L{n}", 2, n)
                                            for n in (1, 63, 64, 65, 192, 193, 256)]
STREAM_HEAD_DIMS = ((12, 32), (16, 8), (40, 16), (48, 8), (96, 8), (192, 2), (256, 2), (384, 2))
STREAM_FUSED_SHAPES = (("B2 L152", 2, 152), ("B2 L65", 2, 65), ("B1 L1", 1, 1))
# (heads, head dim 64, label, B, L): past the resident kernels' L 256, up to
# L H D = 262,144; then the slice's timed shapes (phase 4d's 8 x 96 B64 L320
# and 8 x 64 at L 512)
STREAM_LENGTHS = ((8, "B2 L257", 2, 257), (8, "B2 L320", 2, 320), (8, "B2 L512", 2, 512),
                  (2, "B1 L2048", 1, 2048))
STREAM_TIMED = ((8, 96, "B64 L320", 64, 320), (8, 64, "B64 L512", 64, 512))
STREAM_SOURCE = "osu_dreamer_tpu_torch/csrc/attention_stream.cu"
# the launches of the streamed kernels and the long backward by their names
# (this tree's and the parent's); "other" is every other kernel of the call
# (the wrapper's pads, its sum of the gamma partials, the two-launch long
# backward's cut and cast of dq and dk)
STREAM_LAUNCHES = {"prep": r"attention_prep_kernel", "delta": r"attention_delta_kernel",
                   "forward": r"attention_stream\w*_fwd_kernel",
                   "dK/dV": r"attention_stream\w*_bwd_kv_kernel",
                   "dQ": r"attention_stream\w*_bwd_q_kernel",
                   "post": r"attention_post_kernel",
                   "one pass": r"long_attention_bwd_kernel"}
SPLIT_REPS = 10


def launch_split(fn, args) -> dict:
    """device ms a call of ``fn(*args)`` by the streamed kernels' launches
    (STREAM_LAUNCHES) under torch.profiler, over SPLIT_REPS calls after a warm
    one"""
    import re

    import torch

    fn(*args)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmpdir:
        trace = Path(tmpdir) / "trace.json"
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(SPLIT_REPS):
                fn(*args)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("cat") == "kernel" and "dur" in e]
    split = dict.fromkeys([*STREAM_LAUNCHES, "other"], 0.0)
    for e in events:
        name = next((k for k, pat in STREAM_LAUNCHES.items() if re.search(pat, e["name"])),
                    "other")
        split[name] += float(e["dur"]) / 1e3 / SPLIT_REPS
    return {k: v for k, v in split.items() if v > 0}


def stream_split(gen, dev, smi: str) -> dict:
    """the streamed kernels' device ms by launch under torch.profiler: K9
    and K10 at each STREAM_TIMED shape (prep, forward; prep, dK/dV, dQ,
    post) and K7 at 8 x 96 B4 L759 (forward) -> {shape: {launch: ms a
    call}}"""
    import torch

    from osu_dreamer_tpu_torch.ops import fused_attention as fa
    from osu_dreamer_tpu_torch.ops import long_attention as la

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    out = {}
    cases = [("K7 8 x 96 B4 L759", la.attention_cuda, tuple(rnd(4, 759, 8, 96) for _ in range(3)))]
    for H, D, label, Bt, Lt in STREAM_TIMED:
        qkv = rnd(Bt, Lt, 3 * H * D, scale=0.7)
        qg, kg = (1 + rnd(D, scale=0.1, dtype=torch.float32) for _ in range(2))
        res = fa.fused_attention_fwd_cuda(qkv, qg, kg, H)
        cases += [(f"K9 {H} x {D} {label}", fa.fused_attention_fwd_cuda, (qkv, qg, kg, H)),
                  (f"K10 {H} x {D} {label}", fa.fused_attention_bwd_cuda,
                   (qkv, rnd(Bt, Lt, H * D), *res, qg, kg, H))]
    for what, fn, args in cases:
        out[what] = split = launch_split(fn, args)
        log(f"stream split {what}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
            + f" (device ms a call by launch, torch.profiler over {SPLIT_REPS} calls) [{smi}]")
    del cases
    torch.cuda.empty_cache()
    return out


def head_dim_kernels(gen, dev, smi: str) -> dict:
    """phase 1f: K7/K8, K9 and K10 at the head dims and lengths above
    against their plain versions, timed by graph replay beside the plain
    version, the bound and (K7/K8) SDPA -> {name: {key: numbers}}, the key
    a head dim (its first shape's numbers) or "D label" for K8, a length or
    a timed shape"""
    import torch

    from osu_dreamer_tpu_torch.ops import fused_attention as fa
    from osu_dreamer_tpu_torch.ops import long_attention as la

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def ulps_tol(want):
        return BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

    out: dict = {"flash_attention": {}, "fused_attention_fwd": {}, "fused_attention_bwd": {}}

    def keep(name, key, D, timed, ms, plain_ms, lib_ms, err, flops, nbytes, label):
        entry = out[name].setdefault(key, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if not timed:
            return
        b = bound(flops, nbytes)
        log(f"{name} D{D} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            + (f", torch scaled_dot_product_attention {lib_ms:.4f} ms" if lib_ms else "")
            + f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']}); kernel "
            f"{flops / ms / 1e9:.1f} TFLOP/s of {BF16_PEAK / 1e12:.0f} (CUDA-graph replays) "
            f"[{smi}]")
        if "ms" not in entry:  # the key's first timed shape gives its numbers
            entry.update(shape=label, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)
        if D not in WIDE_HEAD_DIMS:
            entry["source"] = STREAM_SOURCE

    def flash_case(D, H, Bt, Lt, key, timed):
        label = f"B{Bt} L{Lt} H{H}"
        args = tuple(rnd(Bt, Lt, H, D) for _ in range(3))
        got = la.attention_cuda(*args)
        want = la.attention_plain(*args).float()
        torch.cuda.synchronize()
        err, tol = (got.float() - want).abs().max().item(), ulps_tol(want)
        log(f"flash_attention D{D} {label}: max_abs_err {err:.3g} (tolerance {tol:.3g})")
        if not (bool(torch.isfinite(got).all()) and err <= tol):
            raise RuntimeError(f"flash_attention D{D} {label}: kernel disagrees with its "
                               "plain version")
        if not torch.equal(la.attention_cuda(*args), got):
            raise RuntimeError(f"flash_attention D{D} {label}: two launches differ")
        times = ((graph_ms(la.attention_cuda, args), graph_ms(la.attention_plain, args),
                  graph_ms(sdpa, args)) if timed else (None,) * 3)
        keep("flash_attention", key, D, timed, *times, err, 4 * Bt * H * Lt * Lt * D,
             moved_bytes(*args, got), label)

    def fused_case(D, H, label, Bt, Lt, key, timed):
        label = f"{label} H{H}"
        qkv = rnd(Bt, Lt, 3 * H * D, scale=0.7)
        qg, kg = (1 + rnd(D, scale=0.1, dtype=torch.float32) for _ in range(2))
        fwd_args = (qkv, qg, kg, H)
        res = fa.fused_attention_fwd_cuda(*fwd_args)
        want = fa.rope_attention_plain(*fwd_args).float()
        torch.cuda.synchronize()
        err, tol = (res[0].float() - want).abs().max().item(), ulps_tol(want)
        log(f"fused_attention_fwd D{D} {label}: max_abs_err {err:.3g} (tolerance {tol:.3g})")
        if not (bool(torch.isfinite(res[0]).all()) and err <= tol):
            raise RuntimeError(f"fused_attention_fwd D{D} {label}: kernel disagrees with its "
                               "plain version")
        again = fa.fused_attention_fwd_cuda(*fwd_args)
        bare, no_lse = fa.fused_attention_fwd_cuda(*fwd_args, residuals=False)
        if not (torch.equal(again[0], res[0]) and torch.equal(again[1], res[1])):
            raise RuntimeError(f"fused_attention_fwd D{D} {label}: two launches differ")
        if no_lse is not None or not torch.equal(bare, res[0]):
            raise RuntimeError(f"fused_attention_fwd D{D} {label}: the residual-free "
                               "forward differs")
        grad = rnd(Bt, Lt, H * D)
        bwd_args = (qkv, grad, *res, qg, kg, H)
        got = fa.fused_attention_bwd_cuda(*bwd_args)
        ref = fa.fused_attention_bwd_plain(qkv.float(), grad.float(), *res, qg, kg, H)
        plain = fa.fused_attention_bwd_plain(*bwd_args)
        worst = 0.0
        for gname, g, r, pl in zip(("dqkv", "dq_gamma", "dk_gamma"), got, ref, plain):
            g, r, pl = g.float(), r.float(), pl.float()
            e, scale = (g - r).abs().max().item(), r.abs().max().item()
            log(f"fused_attention_bwd D{D} {label} {gname}: max_abs_err {e:.4g} vs f32 "
                f"(plain bf16 {(pl - r).abs().max().item():.4g}; tolerance "
                f"{GRAD_REL * scale:.4g})")
            if not (bool(torch.isfinite(g).all()) and e <= GRAD_REL * scale):
                raise RuntimeError(f"fused_attention_bwd D{D} {label} {gname}: kernel "
                                   "gradient disagrees with the plain one")
            worst = max(worst, e)
        if not all(torch.equal(a, b) for a, b in zip(got, fa.fused_attention_bwd_cuda(*bwd_args))):
            raise RuntimeError(f"fused_attention_bwd D{D} {label}: two launches differ")
        del ref, plain, want
        flops = 4 * Bt * H * Lt * Lt * D
        fwd_times = ((graph_ms(fa.fused_attention_fwd_cuda, fwd_args),
                      graph_ms(fa.rope_attention_plain, fwd_args), None) if timed else (None,) * 3)
        keep("fused_attention_fwd", key, D, timed, *fwd_times, err, flops,
             moved_bytes(*fwd_args, *res), label)
        bwd_times = ((graph_ms(fa.fused_attention_bwd_cuda, bwd_args),
                      graph_grad_ms(lambda a, b, c: fa.rope_attention_plain(a, b, c, H),
                                    (qkv, qg, kg), grad), None) if timed else (None,) * 3)
        keep("fused_attention_bwd", key, D, timed, *bwd_times, worst, 2.5 * flops,
             moved_bytes(*bwd_args, *got), label)
        del qkv, res, grad, got
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    for D in WIDE_HEAD_DIMS:
        H = 1024 // D
        for Bt, Lt in FLASH_SHAPES:
            flash_case(D, H, Bt, Lt, str(D), True)
        for label, Bt, Lt in FUSED_SHAPES:
            fused_case(D, H, label, Bt, Lt, str(D), True)
    log(f"phase 1f: K7/K8, K9 and K10 at head dims {WIDE_HEAD_DIMS} checked in "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    t0 = time.perf_counter()
    for D, H in STREAM_HEAD_DIMS:
        # K7 at eight heads of each (8 x 96 at B4 L759 is the sampler's),
        # timed there and, as K8, at B1 L2500
        for i, (Bt, Lt) in enumerate(FLASH_SHAPES):
            key = f"{D} B{Bt} L{Lt} H8" if Lt > 2048 else str(D)
            flash_case(D, 8, Bt, Lt, key, i != 1)
        for i, (label, Bt, Lt) in enumerate(STREAM_FUSED_SHAPES):
            fused_case(D, H, label, Bt, Lt, str(D), i == 0)
    for H, label, Bt, Lt in STREAM_LENGTHS:
        fused_case(64, H, label, Bt, Lt, f"64 {label} H{H}", True)
    for H, D, label, Bt, Lt in STREAM_TIMED:
        fused_case(D, H, label, Bt, Lt, f"{D} {label} H{H}", True)
    log(f"phase 1f: the streamed K7/K8, K9 and K10 at head dims "
        f"{[d for d, _ in STREAM_HEAD_DIMS]}, lengths {[c[1] for c in STREAM_LENGTHS]} and "
        f"{[c[2] for c in STREAM_TIMED]} checked in {time.perf_counter() - t0:.1f} s [{smi}]")
    stream_split(gen, dev, smi)
    return out


# phase 1g: the long attention backward (the training counterpart of K7/K8
# past the JAX gate: csrc/long_attention_bwd.cu to padded head dim 128,
# csrc/attention_stream.cu odt_attention_stream_bwd past it) on the
# streamed forward's q, k, v and lse, by phase 1's rules (GRAD_REL against
# the f32 autograd of the plain version, bit-identical reruns): first the
# shipped 16 x 64 heads at B64 L320 (phase 4f's step), then each head dim
# at each length, timed at L 320 (and 64 at L 2500) beside the plain
# version's autograd backward, the bound, torch's
# scaled_dot_product_attention backward (its forward + backward logged too)
# and, to head dim 128, the two-launch design the one pass replaced
LONG_BWD_MAIN = (16, 64, 64, 320)  # H, D, B, L
LONG_BWD_HEADS = {8: 16, 12: 32, 64: 16, 96: 8, 128: 8, 256: 4, 384: 2}  # D: H
LONG_BWD_LENGTHS = {65: 8, 320: 8, 759: 2, 2500: 1}  # L: B
LONG_BWD_TIMED = ((64, 2500),)  # (D, L) timed besides L 320
# the two-launch design's graph-replay ms at each timed shape as PERF.md
# section 6 records them (NVIDIA H100 80GB HBM3, 700.00 W), logged beside
# this run's
LONG_BWD_RECORDED_MS = {"16 x 64 B64 L320": 0.6698, "16 x 8 B8 L320": 0.0580,
                    "32 x 12 B8 L320": 0.1337, "16 x 64 B8 L320": 0.0964,
                    "8 x 96 B8 L320": 0.0721, "8 x 128 B8 L320": 0.0840,
                    "4 x 256 B8 L320": 0.0961, "2 x 384 B8 L320": 0.1620,
                    "16 x 64 B1 L2500": 0.5054}


def two_launch_bwd(q, k, v, out, lse, grad, D: int):
    """the long backward's two-launch design at any head dim, timed
    beside the one pass in the same call: the delta pass, K10's streamed
    dK/dV and dQ launches (csrc/attention_stream.cu
    odt_attention_stream_bwd; not counted as a launch of the path), then
    torch's cut and cast of the f32 dq and dk; arguments as
    long_attention.attention_bwd_cuda's"""
    import torch

    from osu_dreamer_tpu_torch.ops import _build

    B, L, H, Dp = q.shape
    dev, De = q.device, D + D % 2
    delta = torch.empty(B, H, L, dtype=torch.float32, device=dev)
    rdo = None if Dp == D else torch.empty(B, L, H, Dp, dtype=torch.bfloat16, device=dev)
    dq, dk = (torch.empty(B, L, H, Dp, dtype=torch.float32, device=dev) for _ in range(2))
    dqkv = torch.empty(B, L, 3 * H * De, dtype=torch.bfloat16, device=dev)
    _build.run("odt_attention_stream_bwd", "long_attention_bwd", dev, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), grad.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               None if rdo is None else rdo.data_ptr(), dq.data_ptr(), dk.data_ptr(),
               dqkv.data_ptr(), B, L, H, D, Dp, D**-0.5, count=False)
    dv = dqkv[..., 2 * H * De:].view(B, L, H, De)[..., :D]
    return dq[..., :D].to(torch.bfloat16), dk[..., :D].to(torch.bfloat16), dv


def long_bwd_kernels(gen, dev, smi: str) -> tuple[dict, dict]:
    """phase 1g -> (the kernel's JSON numbers at LONG_BWD_MAIN, {head dim:
    its numbers at L 320})"""
    import torch

    from osu_dreamer_tpu_torch.ops import long_attention as la

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

    def case(H, D, B, L, timed: bool):
        label = f"{H} x {D} B{B} L{L}"
        q, k, v = (torch.randn(B, L, H, D, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        grad = torch.randn(B, L, H * D, generator=gen, device=dev).to(torch.bfloat16)
        out, lse, rows = la.attention_fwd_cuda(q, k, v)
        args = (*rows, out, lse, grad, D)
        got = la.attention_bwd_cuda(*args)
        worst = 0.0
        ref = la.attention_bwd_plain(q.float(), k.float(), v.float(), grad.float())
        plain = la.attention_bwd_plain(q, k, v, grad)
        for name, g, r, pl in zip(("dq", "dk", "dv"), got, ref, plain):
            g, r, pl = g.float(), r.float(), pl.float()
            err, scale = (g - r).abs().max().item(), r.abs().max().item()
            log(f"long_attention_bwd {label} {name}: max_abs_err {err:.4g} vs f32 (plain bf16 "
                f"{(pl - r).abs().max().item():.4g}; tolerance {GRAD_REL * scale:.4g})")
            if not (bool(torch.isfinite(g).all()) and err <= GRAD_REL * scale):
                raise RuntimeError(f"long_attention_bwd {label} {name}: kernel gradient "
                                   "disagrees with the plain one")
            worst = max(worst, err)
        if not all(torch.equal(a, b) for a, b in zip(got, la.attention_bwd_cuda(*args))):
            raise RuntimeError(f"long_attention_bwd {label}: two launches differ")
        del ref, plain
        numbers = {"max_abs_err": worst}
        if timed:
            flops = 10 * B * H * L * L * D
            b = bound(flops, moved_bytes(q, k, v, out, lse, grad, *got))
            go4 = grad.view(B, L, H, D).transpose(1, 2)
            ms = graph_ms(la.attention_bwd_cuda, args)
            plain_ms = graph_grad_ms(la.attention_plain, (q, k, v), grad)
            lib_ms = graph_grad_ms(sdpa, (q, k, v), go4)
            fwd_ms, lib_fwd_ms = graph_ms(la.attention_fwd_cuda, (q, k, v)), graph_ms(sdpa, (q, k, v))
            log(f"long_attention_bwd {label}: kernel {ms:.4f} ms, plain (autograd) "
                f"{plain_ms:.4f} ms, torch scaled_dot_product_attention backward {lib_ms:.4f} "
                f"ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}); kernel "
                f"{flops / ms / 1e9:.1f} TFLOP/s of {BF16_PEAK / 1e12:.0f}; forward + backward: "
                f"streamed K7 with lse {fwd_ms:.4f} + {ms:.4f} = {fwd_ms + ms:.4f} ms, SDPA "
                f"{lib_fwd_ms:.4f} + {lib_ms:.4f} = {lib_fwd_ms + lib_ms:.4f} ms (CUDA-graph "
                f"replays) [{smi}]")
            rec = LONG_BWD_RECORDED_MS.get(label)
            then = (f"; the two launches as recorded {rec:.4f} ms ({ms / rec:.3f}x, NVIDIA H100 "
                    "80GB HBM3, 700.00 W)" if rec else "")
            if rows[0].shape[-1] <= la.ONE_PASS_DIM:
                two_ms = graph_ms(two_launch_bwd, args)
                log(f"long_attention_bwd {label}: one pass {ms:.4f} ms, the two-launch design "
                    f"{two_ms:.4f} ms in this call ({ms / two_ms:.3f}x){then} (CUDA-graph "
                    f"replays) [{smi}]")
                numbers["two_launch_ms"] = two_ms
            elif then:
                log(f"long_attention_bwd {label}: {ms:.4f} ms (the two launches){then} [{smi}]")
            numbers.update(shape=label, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)
        del q, k, v, grad, out, lse, rows, args, got
        torch.cuda.empty_cache()
        return numbers

    t0 = time.perf_counter()
    first = case(*LONG_BWD_MAIN, True)
    H, D, B, L = LONG_BWD_MAIN
    q, k, v = (torch.randn(B, L, H, D, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    out, lse, rows = la.attention_fwd_cuda(q, k, v)
    grad = torch.randn(B, L, H * D, generator=gen, device=dev).to(torch.bfloat16)
    for what, fn in (("long_attention_bwd", la.attention_bwd_cuda),
                     ("long_attention_bwd, the two-launch design", two_launch_bwd)):
        split = launch_split(fn, (*rows, out, lse, grad, D))
        log(f"stream split {what} {H} x {D} B{B} L{L}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in split.items())
            + f" (device ms a call by launch, torch.profiler over {SPLIT_REPS} calls) [{smi}]")
    del q, k, v, out, lse, rows, grad
    by_dim: dict = {}
    for D, H in LONG_BWD_HEADS.items():
        for L, B in LONG_BWD_LENGTHS.items():
            numbers = case(H, D, B, L, L == 320 or (D, L) in LONG_BWD_TIMED)
            entry = by_dim.setdefault(str(D), {"max_abs_err": 0.0, "source": (
                KERNEL_META["long_attention_bwd"][0] if la.stream_dim(D) <= la.ONE_PASS_DIM
                else STREAM_SOURCE)})
            entry["max_abs_err"] = max(entry["max_abs_err"], numbers.pop("max_abs_err"))
            if L == 320:
                entry.update(numbers)
    first["max_abs_err"] = max([first["max_abs_err"]]
                               + [e["max_abs_err"] for e in by_dim.values()])
    log(f"phase 1g: the long attention backward at head dims {list(LONG_BWD_HEADS)} and lengths "
        f"{list(LONG_BWD_LENGTHS)} checked in {time.perf_counter() - t0:.1f} s [{smi}]")
    return first, by_dim


# phase 1h: the long route's q/k norm and RoPE (csrc/attention_stream.cu's
# prep and post passes, ``odt_qk_prep`` and ``odt_qk_post``), the
# forward pass against the plain chain (4 ulp on q and k, v exact) and the
# backward pass against the f32 autograd of the plain chain (GRAD_REL), from
# dq, dk and dv as views of one packed buffer (as the long attention
# backward hands them over), both bit-identical on rerun; timed by graph
# replay beside the plain chain forward and its autograd backward, at the
# sampler's B40 L759 and the l320 training step's B64 L320, 16 x 64 heads
QK_SHAPES = ((40, 759, 16, 64), (64, 320, 16, 64))  # B, L, H, D


def qk_norm_rope_kernels(gen, dev, smi: str) -> tuple[dict, dict]:
    """phase 1h -> (the forward pass's JSON numbers, the backward's), each
    at QK_SHAPES' first shape, the second's under its "B<n> L<n>" key"""
    import torch

    from osu_dreamer_tpu_torch.ops import norm_rope as nr

    t0 = time.perf_counter()
    out: tuple[dict, dict] = ({}, {})
    for B, L, H, D in QK_SHAPES:
        label = f"{H} x {D} B{B} L{L}"
        qkv = (torch.randn(B, L, 3 * H * D, generator=gen, device=dev) * 0.7).to(torch.bfloat16)
        qg, kg = (1 + 0.3 * torch.randn(D, generator=gen, device=dev) for _ in range(2))
        got = nr.qk_prep_cuda(qkv, qg, kg, H)
        want = nr.norm_rope_qkv_plain(qkv, qg, kg, H)
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got[:2], want[:2]))
        tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(max(w.float().abs().max().item()
                                                       for w in want[:2]))) - 7)
        if not err <= tol or not torch.equal(got[2], want[2]):
            raise RuntimeError(f"qk_prep {label}: max abs err {err:.4g} against the plain chain "
                               f"(tolerance {tol:.4g}), v copied exactly: "
                               f"{torch.equal(got[2], want[2])}")
        if not all(torch.equal(a, b) for a, b in zip(got, nr.qk_prep_cuda(qkv, qg, kg, H))):
            raise RuntimeError(f"qk_prep {label}: two launches differ")
        packed = torch.randn(B, L, 3, H, D, generator=gen, device=dev).to(torch.bfloat16)
        grads = packed.unbind(2)
        post = nr.qk_post_cuda(qkv, *grads, qg, kg, H)
        ref = nr.qk_post_plain(qkv.float(), *(g.float() for g in grads), qg, kg, H)
        plain = nr.qk_post_plain(qkv, *grads, qg, kg, H)
        worst = 0.0
        for name, g, r, pl in zip(("dqkv", "dq_gamma", "dk_gamma"), post, ref, plain):
            g, r, pl = g.float(), r.float(), pl.float()
            e, scale = (g - r).abs().max().item(), r.abs().max().item()
            log(f"qk_post {label} {name}: max_abs_err {e:.4g} vs f32 (plain bf16 "
                f"{(pl - r).abs().max().item():.4g}; tolerance {GRAD_REL * scale:.4g})")
            if not (bool(torch.isfinite(g).all()) and e <= GRAD_REL * scale):
                raise RuntimeError(f"qk_post {label} {name}: kernel gradient disagrees with the "
                                   "plain one")
            worst = max(worst, e)
        if not all(torch.equal(a, b) for a, b in zip(post, nr.qk_post_cuda(qkv, *grads, qg, kg,
                                                                            H))):
            raise RuntimeError(f"qk_post {label}: two launches differ")
        del ref, plain
        # bytes: q and k read and written, v's copy read and written, the
        # tables and gains; the backward reads q and k raw, dq, dk, dv and
        # writes dqkv (its f32 gain partials besides)
        n = B * L * H * D
        small = 2 * (2 * L * (D // 2) + 2 * D)
        prep_b = bound(0, 2 * 6 * n + small)
        post_b = bound(0, 2 * 8 * n + small + 4 * 2 * D * -(-B * L // nr.POST_CHUNK))
        prep_ms = graph_ms(nr.qk_prep_cuda, (qkv, qg, kg, H))
        plain_ms = graph_ms(nr.norm_rope_qkv_plain, (qkv, qg, kg, H))
        post_ms = graph_ms(nr.qk_post_cuda, (qkv, *grads, qg, kg, H))
        plain_grad_ms = graph_grad_ms(lambda *t: nr.norm_rope_qkv_plain(*t, H), (qkv, qg, kg),
                                      grads)
        log(f"qk_prep {label}: kernel {prep_ms:.4f} ms, plain chain {plain_ms:.4f} ms; bound "
            f"{prep_b['bound_ms']:.4f} ms ({prep_b['bound_by']}, v's copy counted) [{smi}]")
        log(f"qk_post {label}: kernel {post_ms:.4f} ms, plain chain's autograd backward "
            f"{plain_grad_ms:.4f} ms; bound {post_b['bound_ms']:.4f} ms ({post_b['bound_by']}); "
            f"forward + backward {prep_ms + post_ms:.4f} ms against {plain_ms + plain_grad_ms:.4f} "
            f"ms (CUDA-graph replays) [{smi}]")
        for numbers, ms, p_ms, b, e in ((out[0], prep_ms, plain_ms, prep_b, err),
                                        (out[1], post_ms, plain_grad_ms, post_b, worst)):
            entry = {"shape": label, "ms": ms, "plain_ms": p_ms, "library_ms": None, **b,
                     "max_abs_err": e}
            if numbers:
                numbers[f"B{B} L{L}"] = entry
            else:
                numbers.update(entry)
        del qkv, got, want, packed, grads, post
        torch.cuda.empty_cache()
    log(f"phase 1h: the q/k norm and RoPE passes checked in {time.perf_counter() - t0:.1f} s "
        f"[{smi}]")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from osu_dreamer_tpu_torch.audio import spectrogram
    from osu_dreamer_tpu_torch.audio.constants import N_BINS, SR
    from osu_dreamer_tpu_torch.audio.spectrogram import prep_wave_for_model
    from osu_dreamer_tpu_torch.models.inference.artifact import init_random
    from osu_dreamer_tpu_torch.models.inference.model import LDM, LDMArgs
    from osu_dreamer_tpu_torch.models.inference.sampler import build_batch_sampler
    from osu_dreamer_tpu_torch.nn import attention, blocks
    from osu_dreamer_tpu_torch.ops import (
        _build, film_layer, film_qkv, fused_attention, long_attention, resonator, swiglu,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout
    nvcc = next(line for line in nvcc.splitlines() if "release" in line).strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc {nvcc} "
        f"python {sys.version.split()[0]}")

    path, seconds = _build.build()
    log(f"kernels built in {seconds:.1f} s -> {path.relative_to(ROOT)}")
    _build.library()

    # ---- 1. each kernel against its plain version at the slice's shapes ----
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def ffn(C, H, K=5):
        return [rnd(K, C, scale=0.4), rnd(C, scale=0.1), rnd(C, 2 * H, scale=C**-0.5),
                rnd(2 * H, scale=0.1), rnd(H, C, scale=H**-0.5), rnd(C, scale=0.1)]

    def film_args(B, L, zero_film, C=128):
        film = [torch.zeros(B, C, dtype=torch.bfloat16, device=dev) if zero_film
                else rnd(B, C, scale=0.3) for _ in range(3)]
        return (rnd(B, L, C), *film, 1 + rnd(C, scale=0.1), 1 + rnd(C, scale=0.1),
                *ffn(C, int(C * 8 / 3)))

    def prologue_args(B, L, C, F=3072):
        """x, scale, shift, add bf16; the qkv kernel and bias f32 parameters
        holding bf16 values, as in training"""
        return (rnd(B, L, C), rnd(B, C, scale=0.3), rnd(B, C, scale=0.3), rnd(B, L, C, scale=0.5),
                rnd(C, F, scale=C**-0.5).float(), rnd(F, scale=0.1).float())

    def resonate_f64(frames):
        """the resonator states in f64: the contribution product, then a
        doubling scan with powers of A squared in f64"""
        alpha, b = spectrogram.resonator_poles()
        j = np.arange(98)
        w = torch.from_numpy(alpha[None, :] * b[None, :] ** (97 - j)[:, None]).to(dev)
        y = torch.complex(frames.double() @ w.real, frames.double() @ w.imag)
        a, d = torch.from_numpy(b**98).to(dev), 1
        while d < y.shape[1]:
            y = torch.cat([y[:, :d], y[:, d:] + a * y[:, :-d]], dim=1)
            a, d = a * a, 2 * d
        return torch.view_as_real(y)

    def sdpa(q, k, v):
        """the library yardstick of K7/K8: (B, L, H, D) in torch's (B, H, L, D)"""
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

    S, D = 2, len(DIFFS)
    B = S * D
    # name -> (kernel, plain, [(label, args)], the operations of a call and
    # the peak rate of their type); the first shape is the JSON line's
    cases = {
        # the request's two 2-minute songs; one frame; ragged and exact
        # 128-frame chunks; a 2-minute song and one frame; generate-data's
        # 60 s and 10-minute songs (make_spec: one song, its 6 s buckets)
        "resonator": (resonator.resonate_cuda, resonator.resonate_plain, [
            (f"S{n} K{k}", (rnd(n, k, 98, scale=0.3, dtype=torch.float32),))
            for n, k in ((S, 20480), (1, 1), (3, 63), (3, 64), (3, 65), (3, 129), (1, 20481),
                         (1, PIPELINE_SPEC_FRAMES), (1, spec_frames(600.0)))
        ], lambda a: (4 * a[0].numel() * N_BINS + 8 * a[0].shape[0] * a[0].shape[1] * N_BINS,
                      F32_PEAK)),
        "film_layer": (film_layer.film_layer_cuda, film_layer.film_layer_plain, [
            ("B4 L20493 FiLM", film_args(B, 20493, False)),
            ("B2 L20493 zero FiLM", film_args(S, 20493, True)),
            ("B4 L2277 FiLM", film_args(B, 2277, False)),
            ("B64 L1026 FiLM (latent training)", film_args(64, 1026, False)),
            ("B64 L38 FiLM (hidden split)", film_args(64, 38, False)),
            ("B8 L2277 C384 FiLM (widest JAX-fused width)", film_args(8, 2277, False, 384)),
            ("B16 L1026 C32 FiLM (narrow: the box runs past C)", film_args(16, 1026, False, 32)),
        ], lambda a: (ffn_flops(a[0].shape[0] * a[0].shape[1], a[0].shape[2], a[10].shape[0],
                                5, 3, 1), BF16_PEAK)),
        "swiglu": (swiglu.swiglu_cuda, swiglu.swiglu_plain, [
            ("B4 L759 C512", (rnd(B, 759, 512), *ffn(512, 1365))),
            ("B128 L152 C512 (training)", (rnd(128, 152, 512), *ffn(512, 1365))),
            ("B3 L77 C512 ragged", (rnd(3, 77, 512), *ffn(512, 1365))),
            ("B4 L759 C768 H2048 (one consumer warpgroup)", (rnd(B, 759, 768), *ffn(768, 2048))),
            ("B4 L759 C96 H256 (narrow: the box runs past C)", (rnd(B, 759, 96), *ffn(96, 256))),
        ], lambda a: (ffn_flops(a[0].shape[0] * a[0].shape[1], a[0].shape[2], a[5].shape[0], 5,
                                3, 1), BF16_PEAK)),
        # the sampler's shape, K8's range, and one key past a 64-key tile and
        # past the TPU's resident limit
        "flash_attention": (long_attention.attention_cuda, long_attention.attention_plain, [
            (f"B{b} L{n} H16", tuple(rnd(b, n, 16, 64) for _ in range(3)))
            for b, n in ((B, 759), (1, 2500), (B, 65), (1, 2049))
        ], lambda a: (4 * a[0].shape[0] * a[0].shape[2] * a[0].shape[1] ** 2 * 64, BF16_PEAK)),
        "film_qkv_fwd": (film_qkv.film_qkv_fwd_cuda, film_qkv.film_qkv_plain, [
            ("B128 L152 C512 F3072 (training)", prologue_args(128, 152, 512)),
            ("B4 L759 C512 F3072 (inference)", prologue_args(B, 759, 512)),
            ("B4 L77 C512 F3072", prologue_args(B, 77, 512)),
            ("B128 L152 C384 F3072", prologue_args(128, 152, 384)),
            ("B128 L152 C640 F3072 (widened)", prologue_args(128, 152, 640)),
            ("B4 L759 C1024 F1920 (widened)", prologue_args(B, 759, 1024, 1920)),
        ] + [(f"B4 L{n} C512 F3072 (tile edges)", prologue_args(B, n, 512))
             for n in (1, 63, 64, 65, 129)],
         lambda a: (2 * a[0].numel() * a[4].shape[1], BF16_PEAK)),
    }
    library = {"flash_attention": sdpa}

    def cuda_ms(fn, args, reps=20) -> float:
        fn(*args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    results = {}
    for name, (kernel, plain, shapes, work) in cases.items():
        worst = 0.0
        for i, (label, args) in enumerate(shapes):
            out = kernel(*args)
            got, want = out.float(), plain(*args).float()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"{name} {label}: non-finite kernel output")
            err = (got - want).abs().max().item()
            if name in F32_RULED:
                ref = plain(*(t.float() for t in args)).float()
                ek, ep = (got - ref).abs(), (want - ref).abs()
                log(f"{name} {label}: max_abs_err {err:.3g} vs plain bf16; vs the plain f32 "
                    f"version kernel mean {ek.mean().item():.4g} max {ek.max().item():.4g}, plain "
                    f"bf16 mean {ep.mean().item():.4g} max {ep.max().item():.4g} (limits "
                    f"{SLICE_MEAN_RATIO}x / {SLICE_MAX_RATIO}x)")
                if not (ek.mean() <= SLICE_MEAN_RATIO * ep.mean()
                        and ek.max() <= SLICE_MAX_RATIO * ep.max()):
                    raise RuntimeError(f"{name} {label}: kernel farther from the f32 version than "
                                       "the plain bf16 path")
                del ref, ek, ep
            else:
                tol = (F32_ATOL if name == "resonator"
                       else BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7))
                log(f"{name} {label}: max_abs_err {err:.3g} (tolerance {tol:.3g})")
                if not err <= tol:
                    raise RuntimeError(f"{name} {label}: kernel disagrees with its plain version")
            if name == "resonator":
                e64 = (got.double() - resonate_f64(args[0])).abs().max().item()
                log(f"{name} {label}: max_abs_err {e64:.3g} vs an f64 doubling scan (tolerance "
                    f"{F32_ATOL})")
                if not e64 <= F32_ATOL:
                    raise RuntimeError(f"{name} {label}: kernel disagrees with the f64 scan")
            if name in RERUN_EXACT and not torch.equal(kernel(*args), out):
                raise RuntimeError(f"{name} {label}: two launches differ")
            worst = max(worst, err)
            timer = graph_ms if name in GRAPH_TIMED else cuda_ms
            ms, plain_ms = timer(kernel, args), timer(plain, args)
            lib_ms = timer(library[name], args) if name in library else None
            flops, peak = work(args)
            work_bound = bound(flops, moved_bytes(*args, out), peak)
            log(f"{name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                + (f", torch scaled_dot_product_attention {lib_ms:.4f} ms" if lib_ms else "")
                + f"; bound {work_bound['bound_ms']:.4f} ms ({work_bound['bound_by']}); kernel "
                f"{flops / ms / 1e9:.1f} TFLOP/s of {peak / 1e12:.0f}"
                + (f"; CUDA-graph replays (launched from Python: kernel {cuda_ms(kernel, args):.4f}"
                   " ms)" if name in GRAPH_TIMED else "") + f" [{smi}]")
            if i == 0:
                results[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                 **work_bound}
            del out, got, want
        results[name]["max_abs_err"] = worst

    # the y K11 multiplies is the y K12's row pass recomputes, bit for bit
    args = prologue_args(B, 759, 512)
    y11, y12 = (torch.empty(B * 759, 512, dtype=torch.bfloat16, device=dev) for _ in range(2))
    film_qkv.film_qkv_fwd_cuda(*args, y_out=y11)
    film_qkv.film_qkv_bwd_cuda(*args, rnd(B, 759, 3072), y_out=y12)
    if not torch.equal(y11, y12):
        raise RuntimeError("film_qkv_fwd: its y differs from the backward's recomputed y")
    log("film_qkv_fwd B4 L759 C512: its y equals film_qkv_bwd's recomputed y bit for bit")
    del args, y11, y12

    # ---- 1a. K4's plans at the sampler's and the training shape ----
    ffn_plans(swiglu, graph_ms, rnd, ffn, B, smi)

    # ---- 1b. the training kernels at the denoiser's training shape ----
    def check_grads(label, names, got, ref, plain) -> float:
        """each kernel gradient within GRAD_REL of the largest magnitude of
        the f32 plain gradient -> the worst max abs error"""
        worst = 0.0
        for name, g, r, p in zip(names, got, ref, plain):
            g, r, p = g.float(), r.float(), p.float()
            if not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"{label} {name}: non-finite kernel gradient")
            err, scale = (g - r).abs().max().item(), r.abs().max().item()
            log(f"{label} {name}: max_abs_err {err:.4g} vs f32 (plain bf16 "
                f"{(p - r).abs().max().item():.4g}; tolerance {GRAD_REL * scale:.4g} = "
                f"{GRAD_REL} x max |f32| {scale:.4g})")
            if not err <= GRAD_REL * scale:
                raise RuntimeError(f"{label} {name}: kernel gradient disagrees with the plain one")
            worst = max(worst, err)
        return worst

    def backward_ms(name, fn, leaves, grad_out) -> float:
        """ms of autograd's backward over a graph built once, timed as the
        kernel ``name`` is: graph replays for GRAPH_TIMED, else CUDA events
        around launches from Python"""
        if name in GRAPH_TIMED:
            return graph_grad_ms(fn, leaves, grad_out)
        leaves = [t.detach().requires_grad_() for t in leaves]
        y = fn(*leaves)
        return cuda_ms(lambda: torch.autograd.grad(y, leaves, grad_out, retain_graph=True), ())

    def record(name, label, i, ms, plain_ms, err, flops, nbytes) -> None:
        """log a case's times beside its bound; the first case is the JSON line's"""
        work_bound = bound(flops, nbytes)
        how = " (CUDA-graph replays, as its plain version's)" if name in GRAPH_TIMED else ""
        log(f"{name} {label}: kernel {ms:.4f} ms{how}, plain {plain_ms:.4f} ms; bound "
            f"{work_bound['bound_ms']:.4f} ms ({work_bound['bound_by']}); kernel "
            f"{flops / ms / 1e9:.1f} TFLOP/s of {BF16_PEAK / 1e12:.0f} [{smi}]")
        if i == 0:
            results[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                             "max_abs_err": err, **work_bound}
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    def check_rerun(name, label, fn, args, got) -> None:
        """fixed-order sums, no float atomics: a second launch is bit-identical"""
        if not all(torch.equal(a, b) for a, b in zip(got, fn(*args))):
            raise RuntimeError(f"{name} {label}: two launches differ")

    H_ATT = 16
    # the training shape, a ragged L77, and the edges of one to four 64-row
    # tiles up to the kernels' longest
    attention_shapes = [("B128 L152 H16", 128, 152), ("B4 L77 H16", 4, 77)] + [
        (f"B2 L{n} H16", 2, n) for n in (1, 63, 64, 65, 192, 193, 256)]
    for i, (label, Bt, Lt) in enumerate(attention_shapes):
        qkv = rnd(Bt, Lt, 3 * H_ATT * 64, scale=0.7)
        qg, kg = (1 + rnd(64, scale=0.1, dtype=torch.float32) for _ in range(2))
        fwd_args = (qkv, qg, kg, H_ATT)
        res = fused_attention.fused_attention_fwd_cuda(*fwd_args)
        want = fused_attention.rope_attention_plain(*fwd_args).float()
        torch.cuda.synchronize()
        err = (res[0].float() - want).abs().max().item()
        tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
        log(f"fused_attention_fwd {label}: max_abs_err {err:.3g} (tolerance {tol:.3g})")
        if not (bool(torch.isfinite(res[0]).all()) and err <= tol):
            raise RuntimeError(f"fused_attention_fwd {label}: kernel disagrees with its plain version")
        check_rerun("fused_attention_fwd", label, fused_attention.fused_attention_fwd_cuda,
                    fwd_args, res)
        bare, no_lse = fused_attention.fused_attention_fwd_cuda(*fwd_args, residuals=False)
        if no_lse is not None or not torch.equal(bare, res[0]):
            raise RuntimeError(f"fused_attention_fwd {label}: the residual-free forward differs")
        grad = rnd(Bt, Lt, H_ATT * 64)
        bwd_args = (qkv, grad, *res, qg, kg, H_ATT)
        got = fused_attention.fused_attention_bwd_cuda(*bwd_args)
        worst_bwd = check_grads(
            f"fused_attention_bwd {label}", ("dqkv", "dq_gamma", "dk_gamma"), got,
            fused_attention.fused_attention_bwd_plain(qkv.float(), grad.float(), *res, qg, kg, H_ATT),
            fused_attention.fused_attention_bwd_plain(*bwd_args),
        )
        check_rerun("fused_attention_bwd", label, fused_attention.fused_attention_bwd_cuda,
                    bwd_args, got)
        attn_flops = 4 * Bt * H_ATT * Lt * Lt * 64
        record("fused_attention_fwd", label, i,
               graph_ms(fused_attention.fused_attention_fwd_cuda, fwd_args),
               graph_ms(fused_attention.rope_attention_plain, fwd_args), err, attn_flops,
               moved_bytes(*fwd_args, *res))
        record("fused_attention_bwd", label, i,
               graph_ms(fused_attention.fused_attention_bwd_cuda, bwd_args),
               backward_ms("fused_attention_bwd",
                           lambda a, b, c: fused_attention.rope_attention_plain(a, b, c, H_ATT),
                           (qkv, qg, kg), grad),
               worst_bwd, 2.5 * attn_flops, moved_bytes(*bwd_args, *got))

    swiglu_grads = ("dx", "d_dw_kernel", "d_dw_bias", "d_vg_kernel", "d_vg_bias", "d_out_kernel",
                    "d_out_bias")
    # K6 at the denoiser's width; K5 at the width-384 denoiser's and at C128
    # H341 (H padded to 352)
    for name, fn, shapes in (
            ("swiglu_bwd", swiglu.swiglu_bwd_cuda, (("B128 L152 C512 H1365", 128, 152, 512, 1365),
                                                    ("B4 L77 C512 H1365", 4, 77, 512, 1365),
                                                    ("B32 L152 C640 H1706 (48-row blocks)", 32, 152,
                                                     640, 1706))),
            ("swiglu_bwd_full", swiglu.swiglu_bwd_full_cuda,
             (("B128 L152 C384 H1024", 128, 152, 384, 1024), ("B4 L77 C384 H1024", 4, 77, 384, 1024),
              ("B8 L70 C128 H341", 8, 70, 128, 341)))):
        for i, (label, Bt, Lt, C, H) in enumerate(shapes):
            x = rnd(Bt, Lt, C)
            w = [t.float() for t in ffn(C, H)[:5]]  # f32 parameters, as in training
            go = rnd(Bt, Lt, C)
            got = fn(x, *w, go)
            worst_bwd = check_grads(
                f"{name} {label}", swiglu_grads, got,
                swiglu.swiglu_bwd_plain(x.float(), *w, go.float()), swiglu.swiglu_bwd_plain(x, *w, go),
            )
            check_rerun(name, label, fn, (x, *w, go), got)
            zero_bias = torch.zeros(C, device=dev)
            record(name, label, i, graph_ms(fn, (x, *w, go)),
                   backward_ms(name, lambda *a: swiglu.swiglu_plain(*a, zero_bias), (x, *w), go),
                   worst_bwd, ffn_flops(Bt * Lt, C, H, 5, 8, 3), moved_bytes(x, *w, go, *got))

    # ---- 1c. the film-layer backward at latent training's top and bottom levels ----
    film_grads = ("dx", "dscale", "dshift", "dgate", "dg1", "dg2", "d_dw_kernel", "d_dw_bias",
                  "d_vg_kernel", "d_vg_bias", "d_out_kernel", "d_out_bias")
    for i, (label, Bt, Lt, zero_film, C) in enumerate((
            ("B64 L1026 C128 H341 FiLM", 64, 1026, False, 128),
            ("B64 L1026 zero FiLM", 64, 1026, True, 128),
            ("B64 L342 FiLM", 64, 342, False, 128), ("B64 L114 FiLM", 64, 114, False, 128),
            ("B64 L38 FiLM", 64, 38, False, 128), ("B64 L38 zero FiLM", 64, 38, True, 128),
            ("B16 L342 C256 H682 FiLM (widened)", 16, 342, False, 256),
            ("B16 L342 C384 H1024 FiLM (widened)", 16, 342, False, 384))):
        args, go = film_args(Bt, Lt, zero_film, C), rnd(Bt, Lt, C)
        got = film_layer.film_layer_bwd_cuda(*args, go)
        worst_bwd = check_grads(
            f"film_layer_bwd {label}", film_grads, got,
            film_layer.film_layer_bwd_plain(*(t.float() for t in args), go.float()),
            film_layer.film_layer_bwd_plain(*args, go),
        )
        check_rerun("film_layer_bwd", label, film_layer.film_layer_bwd_cuda, (*args, go), got)
        record("film_layer_bwd", label, i, graph_ms(film_layer.film_layer_bwd_cuda, (*args, go)),
               backward_ms("film_layer_bwd", film_layer.film_layer_plain, args, go), worst_bwd,
               ffn_flops(Bt * Lt, C, int(C * 8 / 3), 5, 9, 3), moved_bytes(*args, go, *got))

    # ---- 1d. the prologue backward at the denoiser's training shape, a
    # ragged L77, C 384 and 640, then tiles straddling batch rows at every
    # cluster width (two CTAs a tile at C 512, three at 640, four at 1024) ----
    for i, (label, Bt, Lt, C) in enumerate((("B128 L152 C512 F3072", 128, 152, 512),
                                            ("B4 L77 C512 F3072", 4, 77, 512),
                                            ("B128 L152 C384 F3072", 128, 152, 384),
                                            ("B128 L152 C640 F3072 (widened)", 128, 152, 640),
                                            ("B3 L1 C512 F3072 (ragged)", 3, 1, 512),
                                            ("B3 L129 C640 F3072 (ragged)", 3, 129, 640),
                                            ("B3 L65 C1024 F3072 (ragged)", 3, 65, 1024))):
        args, go = prologue_args(Bt, Lt, C), rnd(Bt, Lt, 3072)
        got = film_qkv.film_qkv_bwd_cuda(*args, go)
        worst_bwd = check_grads(
            f"film_qkv_bwd {label}", ("dx", "dscale", "dshift", "dadd", "dkernel", "dbias"), got,
            film_qkv.film_qkv_bwd_plain(*(t.float() for t in args), go.float()),
            film_qkv.film_qkv_bwd_plain(*args, go),
        )
        check_rerun("film_qkv_bwd", label, film_qkv.film_qkv_bwd_cuda, (*args, go), got)
        record("film_qkv_bwd", label, i, graph_ms(film_qkv.film_qkv_bwd_cuda, (*args, go)),
               backward_ms("film_qkv_bwd", film_qkv.film_qkv_plain, args, go), worst_bwd,
               4 * Bt * Lt * C * 3072, moved_bytes(*args, go, *got))
    del args, go, got
    torch.cuda.empty_cache()

    # ---- 1e. the FFN kernels' TP forms on two slices of the hidden units ----
    tp_forms_phase(rnd, ffn, film_args, check_grads, record, results, smi)

    # ---- 1f. the attention kernels at head dims 32 and 128 ----
    head_dims = head_dim_kernels(gen, dev, smi)

    # ---- 1g. the long attention backward ----
    results["long_attention_bwd"], long_bwd_dims = long_bwd_kernels(gen, dev, smi)

    # ---- 1h. the long route's q/k norm and RoPE, each way ----
    results["qk_prep"], results["qk_post"] = qk_norm_rope_kernels(gen, dev, smi)

    # ---- 2. small slice: through the kernels vs through the plain versions ----
    args = LDMArgs()
    model = init_random(args, torch.Generator(device=dev).manual_seed(SEED), dev)
    assert model.dtype == torch.bfloat16
    sample = build_batch_sampler(model)
    chunk = args.latent.chunk_size
    labels = torch.tensor(DIFFS, dtype=torch.float32, device=dev)

    def upload(waves_np):
        preps = [prep_wave_for_model(w, chunk) for w in waves_np]
        if len({p[2] for p in preps}) != 1:
            raise ValueError("songs of one batch must share a wave bucket")
        waves = torch.from_numpy(np.stack([p[0] for p in preps])).to(dev)
        real = torch.tensor([p[1] for p in preps], device=dev)
        return waves, real, preps[0][2], preps[0][3]

    small = upload([synth_wave(SEED + 10 + i, 6.0, SR) for i in range(S)])
    reference = LDM(args, torch.float32).to(dev).eval()
    reference.load_state_dict(model.state_dict())
    charts = {}
    for name, ldm, use_plain, prologue in (
            ("kernels", model, False, False), ("plain", model, True, False),
            ("plain_f32", reference, True, False), ("kernels, fused prologue", model, False, True)):
        _build.reset_launches()
        with (torch.inference_mode(), plain_ops() if use_plain else nullcontext(),
              fused_prologue() if prologue else nullcontext()):
            spec = spectrogram.spec_for_model_batch(*small)
            chart, lab = ldm(spec, labels, 4, style_steps=4, style_guidance=2.0,
                             generator=torch.Generator(device=dev).manual_seed(SEED))
        charts[name] = torch.cat([chart.float().flatten(), lab.float().flatten()])
        if (_build.launches["film_qkv_fwd"] > 0) != prologue:
            raise RuntimeError(f"small slice ({name}): {_build.launches['film_qkv_fwd']} "
                               "launches of the prologue kernel")
    for name in ("kernels", "kernels, fused prologue"):
        if not bool(torch.isfinite(charts[name]).all()):
            raise RuntimeError(f"small slice ({name}): non-finite output")
    err = {k: (charts[k] - charts["plain_f32"]).abs() for k in charts if k != "plain_f32"}
    log("small slice (2 songs x 2 diffs, 6 s, 4 steps, CFG 2.0), distance from the f32 "
        "plain path: " + ", ".join(
            f"bf16 {k} max {e.max().item():.4g} mean {e.mean().item():.4g}" for k, e in err.items()))
    moved = (charts["kernels, fused prologue"] - charts["kernels"]).abs()
    log(f"small slice: the fused prologue moves the kernel path's output by max "
        f"{moved.max().item():.4g}, mean {moved.mean().item():.4g} ({int((moved > 0).sum())} of "
        f"{moved.numel()} values)")
    for name in ("kernels", "kernels, fused prologue"):
        if not (err[name].mean() <= SLICE_MEAN_RATIO * err["plain"].mean()
                and err[name].max() <= SLICE_MAX_RATIO * err["plain"].max()):
            raise RuntimeError(f"small slice: the {name} path is farther from the f32 reference "
                               "than the plain bf16 path")

    # ---- 3. the full-width slice ----
    waves_np = [synth_wave(SEED + i, SONG_SECONDS, SR) for i in range(S)]

    def request(guidance: float, seed: int):
        t0 = time.perf_counter()
        waves, real, n_frames, out_frames = upload(waves_np)
        generator = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            hit, xy, lab = sample(waves, real, labels, generator, n_frames, out_frames, STEPS,
                                  guidance)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        out = hit.cpu().numpy(), xy.cpu().numpy(), lab.float().cpu().numpy()
        return time.perf_counter() - t0, out_frames, out

    def check_request(what, guidance, wall, out_frames, outs) -> None:
        hit, xy, lab = outs
        if hit.shape != (B, out_frames, 7) or hit.dtype != np.uint8:
            raise RuntimeError(f"bad hit output {hit.shape} {hit.dtype}")
        if xy.shape != (B, out_frames, 2) or xy.dtype != np.int16:
            raise RuntimeError(f"bad xy output {xy.shape} {xy.dtype}")
        if lab.shape != (B, 5) or not np.isfinite(lab).all() or lab.min() < 0 or lab.max() > 10:
            raise RuntimeError(f"bad labels {lab}")
        if hit.max() == hit.min():
            raise RuntimeError("the hit channels are constant")
        log(f"{what} (S={S} songs x D={D} diffs, {SONG_SECONDS:.0f} s, {STEPS} steps, "
            f"guidance {guidance}): {wall * 1e3:.1f} ms wall, "
            f"{B / wall * 60:.1f} maps/min [{smi}]")

    request(1.0, SEED)  # warm-up
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    runs = [(g, *request(g, SEED + 1)) for g in (1.0, 1.0, 1.0, 2.0)]
    launches_infer = dict(_build.launches)
    log(f"launches during the full-width inference runs: {launches_infer}")
    missing = [k for k in INFERENCE_KERNELS if launches_infer[k] == 0]
    stray = [k for k in PROLOGUE_KERNELS if launches_infer[k]]
    if missing or stray:
        raise RuntimeError(f"the inference path never launched {missing} or launched {stray}")
    for name, per_request in (("flash_attention", FLASH_PER_REQUEST),
                              ("qk_prep", FLASH_PER_REQUEST),
                              ("swiglu", SWIGLU_PER_REQUEST), ("film_layer", FILM_PER_REQUEST),
                              ("resonator", RESONATOR_PER_REQUEST)):
        if launches_infer[name] != per_request * len(runs):
            raise RuntimeError(f"{launches_infer[name]} {name} launches in {len(runs)} requests, "
                               f"not {per_request} each")
    for guidance, wall, out_frames, outs in runs:
        check_request("request", guidance, wall, out_frames, outs)
    same = all(np.array_equal(a, b) for a, b in zip(runs[0][3], runs[1][3]))
    if not same:
        raise RuntimeError("two seeded runs of the same request differ")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # one more request under torch.profiler: device-busy and flash attention time
    _build.reset_launches()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmpdir:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            wall, out_frames, outs = request(1.0, SEED + 1)
        prof.export_chrome_trace(str(Path(tmpdir) / "trace.json"))
        trace = Path(tmpdir) / "trace.json"
        busy_ms, flash_ms, n_flash = device_busy(trace, "flash_attention_fwd_kernel")
        n_kernels = sum(e.get("cat") == "kernel" for e in json.loads(trace.read_text())["traceEvents"])
        # the core kernel (and, where a request's SwiGLU splits its hidden
        # dimension across CTAs, the reduction after it), by template flag
        _, swiglu_ms, n_swiglu = device_busy(trace, "ffn_core_kernel<false", "ffn_reduce_kernel<false")
        _, film_ms, n_film = device_busy(trace, "ffn_core_kernel<true", "ffn_reduce_kernel<true")
        _, res_ms, n_res = device_busy(trace, "resonate")
    check_request("request, under torch.profiler", 1.0, wall, out_frames, outs)
    log(f"that request on the device: busy {busy_ms:.2f} ms (kernels and copies, union) over "
        f"{n_kernels} kernels, resonator {res_ms:.4f} ms over {n_res} kernels, flash "
        f"attention {flash_ms:.2f} ms over {n_flash} kernels ({_build.launches['flash_attention']}"
        f" launches counted), SwiGLU {swiglu_ms:.2f} ms over {n_swiglu} kernels "
        f"({_build.launches['swiglu']} launches counted), film layer {film_ms:.2f} ms over "
        f"{n_film} kernels ({_build.launches['film_layer']} launches counted) [{smi}]")
    if (_build.launches["swiglu"] != SWIGLU_PER_REQUEST or n_swiglu < SWIGLU_PER_REQUEST
            or _build.launches["film_layer"] != FILM_PER_REQUEST or n_film < FILM_PER_REQUEST):
        raise RuntimeError("the profiled request did not run its SwiGLU and film layers through "
                           "the forward core")
    if n_flash != FLASH_PER_REQUEST or _build.launches["flash_attention"] != FLASH_PER_REQUEST:
        raise RuntimeError(f"the profiled request ran {n_flash} flash attention kernels, not "
                           f"{FLASH_PER_REQUEST}")

    # one request with the fused prologue (K11 in every backbone layer), then
    # one more under torch.profiler: device busy and K11's ms
    with fused_prologue():
        request(1.0, SEED)  # warm-up
        _build.reset_launches()
        wall, out_frames, outs = request(1.0, SEED + 1)
        launches_prologue = dict(_build.launches)
        check_request("request, OSU_DREAMER_FUSED_PROLOGUE=1", 1.0, wall, out_frames, outs)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmpdir:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                wall, out_frames, outs = request(1.0, SEED + 1)
            trace = Path(tmpdir) / "trace.json"
            prof.export_chrome_trace(str(trace))
            busy_ms, k11_ms, n_k11 = device_busy(trace, "film_qkv_fwd_kernel")
    check_request("request, OSU_DREAMER_FUSED_PROLOGUE=1, under torch.profiler", 1.0, wall,
                  out_frames, outs)
    log(f"launches during that request: {launches_prologue}; under torch.profiler: device busy "
        f"{busy_ms:.2f} ms, film_qkv_fwd {k11_ms:.2f} ms over {n_k11} kernels [{smi}]")
    if (launches_prologue["film_qkv_fwd"] != PROLOGUE_PER_REQUEST or n_k11 != PROLOGUE_PER_REQUEST
            or launches_prologue["film_qkv_bwd"]):
        raise RuntimeError(f"the prologue request ran {launches_prologue['film_qkv_fwd']} prologue "
                           f"forwards ({n_k11} profiled), not {PROLOGUE_PER_REQUEST}, or a backward")

    # ---- 3a. predict: WAV files -> .osz mapsets through run_predict ----
    launches_predict = predict_phase(model, dev, smi)
    serve_odt = write_serve_artifact(model)

    # ---- 3c. predict and serve with songs sharded over two replicas ----
    launches_sharded = sharding_phase(model, serve_odt, dev, smi)
    del model, reference, sample
    torch.cuda.empty_cache()

    # ---- 3b. 8 x 64 heads at L 300: inside the JAX gate, so K9 (the
    # streamed kernels past L 256) answers; 16 x 64 at L 300 is past it, so
    # inference normalises and rotates in torch and takes the flash
    # attention (K7), and under autograd the streamed forward and the long
    # attention backward ----
    from osu_dreamer_tpu_torch.nn.attention import RoPEAttention

    xa = rnd(2, 300, 512)
    for heads, kernels in ((8, {"fused_attention_fwd": 1}),
                           (16, {"flash_attention": 1, "qk_prep": 1})):
        attn = RoPEAttention(512, heads, 64, 512, torch.bfloat16).to(dev)
        randomize_(attn, torch.Generator(device=dev).manual_seed(SEED + 5))
        attn_f32 = RoPEAttention(512, heads, 64, 512, torch.float32).to(dev)
        attn_f32.load_state_dict(attn.state_dict())
        _build.reset_launches()
        with torch.inference_mode():
            got = attn(xa).float()
            launched = {k: n for k, n in _build.launches.items() if n}
            with plain_ops():
                plain_out, ref = attn(xa).float(), attn_f32(xa.float()).float()
        ek, ep = (got - ref).abs(), (plain_out - ref).abs()
        log(f"{heads} x 64 heads at B2 L300: launches {launched}; vs f32 kernel mean "
            f"{ek.mean().item():.4g} max {ek.max().item():.4g}, plain bf16 mean "
            f"{ep.mean().item():.4g} max {ep.max().item():.4g}")
        if (launched != kernels or not bool(torch.isfinite(got).all())
                or not ek.mean() <= SLICE_MEAN_RATIO * ep.mean()
                or not ek.max() <= SLICE_MAX_RATIO * ep.max()):
            raise RuntimeError(f"{heads} x 64 heads at L 300 did not answer through "
                               f"{list(kernels)} within tolerance")
        if heads == 16:
            # past the gate under autograd: both q/k passes, K7 with lse, the long backward
            _build.reset_launches()
            with no_plain_attention():
                grads = torch.autograd.grad(attn(xa).float().square().mean(),
                                            list(attn.parameters()))
            launched = {k: n for k, n in _build.launches.items() if n}
            log(f"16 x 64 heads at B2 L300 under autograd: launches {launched}")
            if (launched != {"flash_attention": 1, "long_attention_bwd": 1, "qk_prep": 1,
                             "qk_post": 1}
                    or not all(bool(torch.isfinite(g).all()) for g in grads)):
                raise RuntimeError("16 x 64 heads at L 300 did not train through K7 and the "
                                   "long attention backward")
            del grads
        del attn, attn_f32

    # ---- 4. full-width denoiser training through fit.run ----
    from osu_dreamer_tpu_torch.data.synth import write_latent_corpus
    from osu_dreamer_tpu_torch.models.diffusion import fit as diffusion_fit
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel, DiffusionModelArgs
    from osu_dreamer_tpu_torch.models.diffusion.train import (
        DiffusionTrainArgs, LatentBatch, diffusion_loss,
    )
    from osu_dreamer_tpu_torch.train.state import stratified_logit_normal_t
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict, load_yaml_config

    workdir = ROOT / "build" / "smoke_fit"

    def denoiser_config(width: int) -> dict:
        cfg = load_yaml_config(diffusion_fit.CONFIG)
        cfg["parallel"] = {"dp": 1}  # one card, however many are visible
        cfg["model"]["backbone_dim"] = width
        cfg["data"].update(data_dir=str(workdir / "data"), max_per_map=-1, max_val_count=2)
        return cfg

    cfg = denoiser_config(512)
    md = cfg["model"]
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    # 64 mapsets x 4 maps x 12 windows of 152; 2 mapsets held out for
    # validation, 62 x 48 = 2976 training windows >= 22 batches of 128
    write_latent_corpus(workdir / "data", 64, 4, 152 * 12, md["a_dim"], md["emb_dim"],
                        md["style_dim"], SEED)
    log(f"synthetic cached-latent corpus written in {time.perf_counter() - t0:.1f} s")
    denoiser_losses = ("loss", "osl", "del", "u_mape")
    launches_train, ms_off, peak_off = fit_timed(
        "fit-denoiser", diffusion_fit.run, cfg, dev, smi, workdir,
        "depth 8, width 512, 16 x 64 heads, B128 x L152, bf16", TRAINING_KERNELS,
        denoiser_losses, denoiser_losses, absent=PROLOGUE_KERNELS + ("swiglu_bwd_full",),
        families=DENOISER_FAMILIES)

    def denoiser_step(what: str, cfg: dict, Bt: int = 128, Lt: int = 152) -> None:
        """one step (batch Bt x Lt) through the kernels and through the plain
        versions (bf16), each against a plain f32 step on the same batch, t
        and x0; random full-strength weights (flax's zero-initialised layers
        would leave most gradients exactly zero)"""
        model_args = dataclass_from_dict(DiffusionModelArgs, cfg["model"])
        train_args = dataclass_from_dict(DiffusionTrainArgs, cfg["train"])
        bf16_model = DiffusionModel(model_args, torch.bfloat16).to(dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        randomize_(bf16_model, gen)
        f32_model = DiffusionModel(model_args, torch.float32).to(dev)
        f32_model.load_state_dict(bf16_model.state_dict())
        z = torch.randn(Bt, Lt, md["emb_dim"], generator=gen, device=dev)
        batch = LatentBatch(h=torch.rand(Bt, Lt, md["a_dim"], generator=gen, device=dev),
                            z=z / z.square().mean(-1, keepdim=True).sqrt(),
                            s=torch.randn(Bt, md["style_dim"], generator=gen, device=dev),
                            labels=torch.rand(Bt, 5, generator=gen, device=dev) * 10)
        t_inj = stratified_logit_normal_t(Bt, gen, dev)
        x0_inj = torch.randn(batch.z.shape, generator=gen, device=dev)

        def loss_and_grads(model, plain: bool):
            with plain_ops() if plain else nullcontext():
                loss, aux = diffusion_loss(model, batch, train_args, t=t_inj, x0=x0_inj)
                grads = torch.autograd.grad(loss, list(model.parameters()))
            terms = torch.stack([aux[k].detach().float() for k in denoiser_losses])
            return terms, torch.cat([g.flatten().float() for g in grads])

        check_step(what, denoiser_losses, loss_and_grads(f32_model, True),
                   loss_and_grads(bf16_model, False), loss_and_grads(bf16_model, True))
        del bf16_model, f32_model
        torch.cuda.empty_cache()

    denoiser_step("fit-denoiser", cfg)

    # ---- 4b. the denoiser at 8 x 128 heads through fit.run, one step each
    # at 8 x 128 and 32 x 32 against the f32 plain step ----
    launches_heads = dict.fromkeys(_build.KERNELS, 0)
    step_launches = {}
    for heads, head_dim in ((8, 128), (32, 32)):
        hcfg = denoiser_config(512)
        hcfg["model"]["backbone"].update(n_heads=heads, head_dim=head_dim)
        what = f"fit-denoiser, {heads} x {head_dim} heads"
        if head_dim == 128:
            shutil.rmtree(workdir / "runs", ignore_errors=True)
            with no_plain_attention():
                launched, ms_heads, _ = fit_timed(
                    what, diffusion_fit.run, hcfg, dev, smi, workdir,
                    f"depth 8, width 512, {heads} x {head_dim} heads, B128 x L152, bf16",
                    TRAINING_KERNELS, denoiser_losses, denoiser_losses, timed=HEADS_TIMED,
                    absent=PROLOGUE_KERNELS + ("swiglu_bwd_full", "flash_attention"),
                    per_step=dict.fromkeys(TRAINING_KERNELS, 8))
            for k, n in launched.items():
                launches_heads[k] += n
            log(f"denoiser train step (B128 x L152): 8 x 128 heads {ms_heads:.2f} ms/step, "
                f"16 x 64 heads {ms_off:.2f} ms/step [{smi}]")
        _build.reset_launches()
        denoiser_step(what, hcfg)
        step_launches[head_dim] = dict(_build.launches)
        for k in ("fused_attention_fwd", "fused_attention_bwd"):
            if step_launches[head_dim][k] != 8:
                raise RuntimeError(f"{what}: {step_launches[head_dim][k]} {k} launches in the "
                                   "kernel step, not 8")

    # ---- 4c. predict at 8 x 128 heads: a 120 s song (K7) and a 30 s one (K9) ----
    launches_heads_predict = head_dim_predict(dev, smi, 8, 128)

    # ---- 4d. the denoiser at 8 x 96 heads, seq_len 320, batch 64 through
    # fit.run (the streamed K9/K10), then the one-step checks at 8 x 96 L320,
    # 8 x 64 L512 and 32 x 12 L152 ----
    t_phase = time.perf_counter()
    hcfg = denoiser_config(512)
    hcfg["model"]["backbone"].update(n_heads=8, head_dim=96)
    hcfg["data"].update(seq_len=320, batch_size=64)
    shutil.rmtree(workdir / "runs", ignore_errors=True)
    with no_plain_attention():
        launches_96, ms_96, _ = fit_timed(
            "fit-denoiser, 8 x 96 heads, seq_len 320", diffusion_fit.run, hcfg, dev, smi,
            workdir, "depth 8, width 512, 8 x 96 heads, B64 x L320, bf16", TRAINING_KERNELS,
            denoiser_losses, denoiser_losses, timed=HEADS_TIMED,
            absent=PROLOGUE_KERNELS + ("swiglu_bwd_full", "flash_attention"),
            per_step=dict.fromkeys(TRAINING_KERNELS, 8))
    log(f"denoiser train step: 8 x 96 heads B64 x L320 {ms_96:.2f} ms/step (20,480 tokens), "
        f"16 x 64 heads B128 x L152 {ms_off:.2f} ms/step (19,456 tokens) [{smi}]")
    for heads, head_dim, Bt, Lt in ((8, 96, 64, 320), (8, 64, 32, 512), (32, 12, 128, 152)):
        scfg = denoiser_config(512)
        scfg["model"]["backbone"].update(n_heads=heads, head_dim=head_dim)
        what = f"fit-denoiser, {heads} x {head_dim} heads, B{Bt} x L{Lt}"
        _build.reset_launches()
        denoiser_step(what, scfg, Bt, Lt)
        step_launches[head_dim] = dict(_build.launches)
        for k in ("fused_attention_fwd", "fused_attention_bwd"):
            if step_launches[head_dim][k] != 8:
                raise RuntimeError(f"{what}: {step_launches[head_dim][k]} {k} launches in the "
                                   "kernel step, not 8")
    log(f"phase 4d wall {time.perf_counter() - t_phase:.1f} s [{smi}]")

    # ---- 4f. the shipped denoiser (16 x 64 heads) at seq_len 320, batch 64
    # through fit.run: past the JAX gate, so the streamed K7 with lse and
    # the long attention backward; then the one-step check there ----
    t_phase = time.perf_counter()
    lcfg = denoiser_config(512)
    lcfg["data"].update(seq_len=320, batch_size=64)
    shutil.rmtree(workdir / "runs", ignore_errors=True)
    with no_plain_attention():
        launches_long, ms_long, _ = fit_timed(
            "fit-denoiser, 16 x 64 heads, seq_len 320", diffusion_fit.run, lcfg, dev, smi,
            workdir, "depth 8, width 512, 16 x 64 heads, B64 x L320, bf16", LONG_TRAINING_KERNELS,
            denoiser_losses, denoiser_losses, timed=HEADS_TIMED,
            absent=PROLOGUE_KERNELS + ("swiglu_bwd_full", "fused_attention_fwd",
                                       "fused_attention_bwd"),
            per_step=dict.fromkeys(LONG_TRAINING_KERNELS, 8))
    log(f"denoiser train step (B64 x L320, 20,480 tokens): 16 x 64 heads (K7 + long attention "
        f"backward) {ms_long:.2f} ms/step, 8 x 96 heads (K9/K10, phase 4d) {ms_96:.2f} ms/step "
        f"[{smi}]")
    _build.reset_launches()
    denoiser_step("fit-denoiser, 16 x 64 heads, B64 x L320", lcfg, 64, 320)
    step_long = dict(_build.launches)
    if any(step_long[k] != 8 for k in ("flash_attention", "long_attention_bwd", "qk_prep",
                                       "qk_post")):
        raise RuntimeError(f"fit-denoiser at L 320: the kernel step launched {step_long}")
    log(f"phase 4f wall {time.perf_counter() - t_phase:.1f} s [{smi}]")

    # ---- 4e. predict at 8 x 96 heads: a 120 s song (K7) and a 30 s one (K9) ----
    launches_96_predict = head_dim_predict(dev, smi, 8, 96)

    # ---- 5. full-width latent training through fit.run, then encode-latents ----
    from osu_dreamer_tpu_torch.models.latent import fit as latent_fit

    launches_latent = train_latent(dev, smi, plain_ops,
                                   {**load_yaml_config(latent_fit.CONFIG), "parallel": {"dp": 1}},
                                   LATENT_CORPUS, ROOT / "build" / "smoke_latent")

    # ---- 6. denoiser training with the fused prologue, widths 512 and 384 ----
    launches_prologue_train = dict.fromkeys(_build.KERNELS, 0)
    steps_on = {}
    for width, (must, absent) in PROLOGUE_TRAINING.items():
        cfg = denoiser_config(width)
        shutil.rmtree(workdir / "runs", ignore_errors=True)
        with fused_prologue():
            launched, ms, peak = fit_timed(
                f"fit-denoiser, fused prologue, width {width}", diffusion_fit.run, cfg, dev, smi,
                workdir, f"depth 8, width {width}, 16 x 64 heads, B128 x L152, bf16, "
                "OSU_DREAMER_FUSED_PROLOGUE=1", must, denoiser_losses, denoiser_losses,
                timed=PROLOGUE_TIMED, absent=absent,
                families={**DENOISER_FAMILIES, **PROLOGUE_FAMILIES} if width == 512 else None)
            denoiser_step(f"fit-denoiser, fused prologue, width {width}", cfg)
        steps_on[width] = (ms, peak)
        for k, n in launched.items():
            launches_prologue_train[k] += n
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"denoiser train step (B128 x L152): width 512 prologue off {ms_off:.2f} ms/step, peak "
        f"{peak_off:.2f} GiB; " + "; ".join(
            f"width {w} prologue on {ms:.2f} ms/step, peak {peak:.2f} GiB"
            for w, (ms, peak) in steps_on.items()) + f" [{smi}]")

    # ---- 6b. radius 0 (the JAX FFN without its depthwise conv): one
    # denoiser step (width 512: K4 and K6) and one latent step (K2 and K3)
    # through the kernels with the unit tap, against the f32 plain step ----
    t_phase = time.perf_counter()
    r0cfg = denoiser_config(512)
    r0cfg["model"]["backbone"]["radius"] = 0
    latent_r0 = load_yaml_config(latent_fit.CONFIG)
    latent_r0["model"]["stack"]["radius"] = 0
    # K2 and K3 with the unit tap at the radius-0 latent stage's four levels
    # (B32, L 2052 / 3^k, C128 H341), by phase 1's rules
    unit_tap = [torch.ones(1, 128, dtype=torch.bfloat16, device=dev),
                torch.zeros(128, dtype=torch.bfloat16, device=dev)]
    for Lt in (2052, 684, 228, 76):
        args = film_args(32, Lt, False)
        args = (*args[:6], *unit_tap, *args[8:])
        label = f"film_layer unit tap B32 L{Lt} C128 H341"
        f32_rule(label, film_layer.film_layer_cuda(*args),
                 film_layer.film_layer_plain(*args),
                 film_layer.film_layer_plain(*(t.float() for t in args)))
        go = rnd(32, Lt, 128)
        check_grads(f"film_layer_bwd unit tap B32 L{Lt}", film_grads,
                    film_layer.film_layer_bwd_cuda(*args, go),
                    film_layer.film_layer_bwd_plain(*(t.float() for t in args), go.float()),
                    film_layer.film_layer_bwd_plain(*args, go))
        del args, go
    # the latent step's 13 loss terms are logged, not held: where the unit
    # tap leaves the kernels no conv to keep in f32, the kernel and plain
    # paths' term errors are draws of one size (tools/radius0_terms.py, 4
    # weight draws: 0.73-2.00x the plain path's mean at radius 0, 0.39-1.07x
    # at radius 2), while each layer's kernels stay closer to f32 than the
    # plain versions (held above) and so do the step's gradients (held)
    launches_radius0 = dict.fromkeys(_build.KERNELS, 0)
    for what, step, want in (
            ("fit-denoiser, radius 0", lambda: denoiser_step("fit-denoiser, radius 0", r0cfg),
             {("swiglu_cuda", 1): 8, ("swiglu_bwd_cuda", 1): 8}),
            ("fit-latent, radius 0", lambda: latent_step("fit-latent, radius 0", latent_r0, dev,
                                                          gate_terms=False),
             {("film_layer_cuda", 1): 88, ("film_layer_bwd_cuda", 1): 88})):
        _build.reset_launches()
        with tap_counts() as taps:
            step()
        log(f"{what}: the kernel step's FFN kernels by (wrapper, taps): {taps}; launches "
            f"{ {k: n for k, n in _build.launches.items() if n} }")
        if taps != want:
            raise RuntimeError(f"{what}: the FFN kernels ran {taps}, not {want}")
        for k, n in _build.launches.items():
            launches_radius0[k] += n
    log(f"phase 6b wall {time.perf_counter() - t_phase:.1f} s [{smi}]")

    # ---- 7. the training pipeline from audio to a .osz ----
    launches_pipeline = pipeline_phase(dev, smi)

    # ---- 8. serve: the resident service over HTTP, concurrent clients ----
    launches_serve = serve_phase(serve_odt, dev, smi)

    # ---- 9. parallel training: dp and sp ranks at full width ----
    launches_parallel = parallel_phase(dev, smi)

    # ---- 10. tensor-parallel training: tp 2 at full width ----
    launches_tp = tp_phase(dev, smi)

    paths = (launches_infer, launches_prologue, launches_predict, launches_sharded,
             launches_train, launches_heads, launches_heads_predict, launches_96,
             launches_96_predict, launches_long, launches_latent, launches_prologue_train,
             launches_radius0, launches_pipeline, launches_serve, launches_parallel, launches_tp)
    launches = {k: sum(path[k] for path in paths) for k in _build.KERNELS}
    never = [k for k, n in launches.items() if n == 0]
    if never:
        raise RuntimeError(f"kernels never launched on a main path: {never}")
    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_META[name][0],
         "replaces": KERNEL_META[name][1], "launches": launches[name], **results[name]}
        for name in _build.KERNELS
    ]
    # the attention kernels by head dim: 64 is the entry's own numbers (phase
    # 1); the others phase 1f's, with the launches of their main paths (8 x
    # 128: phases 4b and 4c; 32 x 32: the one-step check of 4b; 8 x 96:
    # phases 4d and 4e; 32 x 12: the one-step check of 4d; 8 x 64 at L 512:
    # the one-step check of 4d); a head dim or length no path runs shows 0
    path_launches = {
        "128": {k: launches_heads[k] + launches_heads_predict[k] for k in _build.KERNELS},
        "32": step_launches[32],
        "96": {k: launches_96[k] + launches_96_predict[k] for k in _build.KERNELS},
        "96 B64 L320 H8": launches_96, "12": step_launches[12],
        "64 B64 L512 H8": step_launches[64]}
    for entry in kernels:
        if entry["name"] in head_dims:
            entry["head_dims"] = {"64": {k: entry[k] for k in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}}
            for key, numbers in head_dims[entry["name"]].items():
                entry["head_dims"][key] = {
                    "launches": path_launches.get(key, {}).get(entry["name"], 0), **numbers}
    # the long attention backward by head dim at L 320 (its own numbers are
    # phase 4f's 16 x 64 B64 L320; only head dim 64 runs on a main path)
    for entry in kernels:
        if entry["name"] == "long_attention_bwd":
            entry["head_dims"] = {key: {"launches": entry["launches"] if key == "64" else 0,
                                        **numbers} for key, numbers in long_bwd_dims.items()}
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
