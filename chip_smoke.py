#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card.

Run from the root of the repository, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. the card's name and power limit (nvidia-smi); a CUDA card is required;
2. build the kernels from ``satflow_tpu_torch/csrc`` (one nvcc per source,
   run together): K1, the fused ConvLSTM step; K2, its backward's gate chain;
   K3, the LSTM gate tail; K4, the axial attention; K5, the int8 step; K6a and
   K6b, the channel-major step and 3x3 conv head (one source); K1h; T1, T2 and
   K1p; T3. ptxas' registers and spills of every kernel are printed, and the
   SASS of K1, K2, K1h, K4, K5, K6a, K6b, T1, T2, K1p and T3 is read with
   ``cuobjdump``: every bfloat16 instantiation of K1, K2, K1h (hidden 8 to
   256), K6a, T1, T2, K1p and T3 (8 to 128), K4's tensor-core kernel and
   K6b's must hold HMMA (bf16 tensor-core) instructions and no float32 one
   may, T2's as many as K1p's and T1's at each width (the whole contraction,
   though its epilogue reads half of it); every instantiation of K5 (hidden 8
   to 128, its step in both c types and its sums) must hold IMMA (int8
   tensor-core) instructions;
3. K1 against its plain PyTorch version at the serving shapes (B=8,
   256x256, Cx 12 and 64, Ch 64), in float32 and bfloat16, with the image's
   first and last rows and columns checked on their own;
4. K2 against its plain version at the same shapes, dh' and dc' random;
5. the six gradients of ``FusedConvLSTMStep`` (K1 forward, K2 backward)
   against torch autograd of the plain step, float32, same shapes; then
   phases 3-5 once more at Ch 8, 16, 32 and 128 with Cx 1, 12, 20 and Ch,
   and at Ch 192 (zero-padded to 256) and 256 with Cx 12 and 256, float32 and
   bfloat16, at B=2, 50x70 (a multiple of no tile), launches counted;
6. serving: the full-width ``EncoderDecoderConvLSTM`` (hidden 64, 12
   channels in and out, 24 forecast steps, weights from numpy seed 0 in the
   flax layout) behind ``NowcastServer`` answers 5 concurrent requests; the
   replies are checked, K1's launches counted, and one reply held against
   the same rollout through the plain step;
7. timings with CUDA events: K1 and K2 against their plain versions per
   call, with their TFLOP/s against the bf16 tensor cores' peak, and the b8
   forward through each step;
8. training: the same model trains 3 Adam steps through
   ``Trainer(precision="bf16").fit`` on fake b8 256x256 data with sqrt remat
   (``remat_chunk=6``); the losses are checked, the K1 and K2 launches of
   each step counted against the remat schedule, every parameter's
   gradient held nonzero and against the same step through the plain
   versions, the train step timed through the kernels and through the plain
   step, and one step profiled;
9. K3 against its plain version, float32 and bfloat16, each call counted on
   the kernel ``vector_path`` names: the vector kernel at MetNet's shape
   (49 152 rows x C=64) and the concat forward's (524 288 x 64), the
   per-element kernel at
   C = 1, 3, 65 (and 12 in bf16) and on a view one element into its storage;
   ``FusedLSTMGates``' two gradients against autograd of the plain version;
   K4 against its plain
   version at (24 576, 16, 8), (16 384, 64, 32), (4096, 64, 64), (2048, 128,
   64), (2048, 256, 64) and (256, 512, 256) and at the edges of each of its
   three kernels' regimes (L = 1, 17, 32, 33, 100, 512; D = 1, 8, 24, 32, 33,
   100, 256; N = 1 and an N that is no multiple of the rows per block),
   float32 and bfloat16, every call a counted launch, and ``AxialAttention``'s
   three gradients;
10. MetNet serving: the full-width ``LitMetNet`` (metnet.yaml: hidden 64, one
   axial-attention layer of 8 heads, kernel 3, 24 lead times, 12 channels;
   bf16 compute on f32 weights; weights from numpy seed 0 in the flax
   layout, converted by the bridge) behind ``NowcastServer`` answers 5
   concurrent requests of 7 x 256x256x12; 7 K3 and 2 K4 launches per
   forward, every K3 launch on its vector kernel, and one reply held against
   the same forward through the plain versions;
11. MetNet timings: K3 in bfloat16 and float32 at MetNet's and the concat
   forward's shapes: its device time (torch.profiler) and, in ten windows of
   200 calls back to back in turns, a bare launch, a launch through the op
   ``satflow::fused_lstm_gates``, the plain version and the one library
   call that computes the same function, ATen's ``_thnn_fused_lstm_cell`` on
   the gates permuted once to its i, f, g, o order (held to K3's plain
   version first): the windows' median and least, and the host's time for
   its loop; K3 at MetNet's bf16 shape per call as every kernel is timed
   (the kernels line); K4 per call against its plain version and SDPA; the
   b8 forward both ways, and one forward profiled;
12. MetNet training: 3 bf16 Adam steps under ``warmup_cosine`` through
   ``Trainer.fit`` on fake b8 256x256 data (23 input channels); losses
   finite, launches counted, every parameter's gradient nonzero and held
   against the same step through the plain versions, the step timed both
   ways and profiled;
13. K5 against its plain version at B=8, 256x256, Cx 12 and 64, c in bf16
   and f32: K5's own integer sums (its sums entry point, the same
   tensor-core contraction) equal to the exact ones bit for bit, the plain
   version's integer sums against int64 window products on the host, h'q
   within one int8 step on at most 0.1 % of elements, c' within one step of
   its dtype, edges on their own; K6a (Cx 64) and K6b (64 -> 12 channels)
   against their plain versions, float32 and bfloat16, K6b also at Cin 1, 12
   and 128, Cout 1 and 16 and on images whose height and width are multiples
   of no tile; K5 at hidden 8, 16, 24 (zero-padded to 32), 32, 64 and 128
   with Cx 1, 12 and 13 (zero-padded to 4, 12, 16 in the wrapper): its integer
   sums exact, the step against the plain step at the unpadded widths and
   bit-equal to K5 on operands padded beforehand;
14. int8 serving: the full-width ConvLSTM behind ``NowcastServer`` with
   ``quantize="int8"`` answers 5 concurrent requests and refuses a sixth,
   out-of-range one with 400, alone; 62 K5 and 0 K1 launches per forward;
   one reply held against the bf16 rollout and against the same int8
   rollout through K5's plain version;
15. channel-major serving: the same model with ``cell_impl="cmajor"``; 14 K1,
   48 K6a and 24 K6b launches per forward; one reply held against the fused
   rollout;
15b. both at hidden 32 (64x128 images, 7 in, 24 out): ``cell_impl="cmajor"``
   (K6a built for 32) and ``quantize="int8"`` (K5 built for 32: the session's
   cells stay at 32) each answer 5 concurrent requests, launches counted per
   forward, replies held against the fused rollout and against the int8
   rollout through K5's plain version;
16. timings: K5 (Cx 12 and 64 at hidden 64, and Cx = Ch = 32), K6a, K6b per
   call against their plain versions (K6b and K4 also against the one
   library call that computes the same function), the b8 forward through the
   fused, int8 and channel-major rollouts in turns, and one int8 and one
   channel-major forward profiled;
17. K1h, the halo-tensor variant of the step, against its plain version and
   against K1 at K1's shapes and tolerances, the image's first and last rows
   and the rows on either side of every row-block boundary on their own, and
   ``build_halo`` against slicing; T1 (tap-major step), T2 (no gate math)
   and their yardstick K1p (K1 in their W-padded layout) against their plain
   versions, the halo columns of h' exactly zero, T1 and K1p against K1 on
   the interior, T2 relative to max|plain|, and the o + g sums T2's epilogue
   does not read (its sums entry point) against the plain sums;
   T3 (the pad-row channel-major prototype) at block_h 4 (the bf16 kernel's
   8-row tiles straddle pad and image rows) and 8 against its plain version
   and, through the layout helpers, against K6a, its pad rows exactly zero
   and a 3-step chain equal to three K6a steps; then K1h (B=2, 48x70, against
   its plain version and K1) and K6a (B=2, 10x70) at Ch 8, 16, 24 (padded to
   32), 32, 64, 128 with Cx 1, 12, 64, T1, K1p, T2 at Cx = Ch = 8 and 32, and
   T3 at C 8, 16, 24, 32, 64, 128 with block_h 4 and 8, float32 and
   bfloat16;
18. the halo variant of the main path (``SATFLOW_STEP_VARIANT=halo``): the
   fused model answers 5 concurrent requests (62 K1h and 0 K1 launches per
   forward; reply held against the K1 rollout) and takes one Adam step with
   ``remat_chunk=6`` through ``Trainer.fit`` (124 K1h + 62 K2 launches;
   gradients held against the same step through the plain versions);
19. the two study entry points, ``tools.exp_tap9.main`` and
   ``tools.exp_cmajor.main``, in-process: each verifies, then times a chained
   rollout of K1, K1p, T1, T2 and of K6a, T3; launches counted; on the
   tensor cores K1p - T2 is the exact epilogue, K1p - T1 the order of the
   walk, K1p / K1 the W-padded I/O and the order together;
20. the remaining cell formulations: ``cell_impl`` ``concat``, ``split`` and
   ``hybrid`` each answer 5 concurrent requests (62 K3 launches per forward,
   all on its vector kernel; reply held against the same forward through K3's plain version), and
   ``split`` takes one Adam step with ``remat_chunk=6`` (124 K3 launches;
   gradients held against the plain version's);
21. timings: K1h, K1p, T1, T2 and T3 per call against their plain versions, with
   their TFLOP/s and the share of their bound reached, and the
   halo gathers on their own; the b8 forward under ``3pass`` and ``halo`` in
   turns; the b8 forward through ``concat``, ``split`` and ``hybrid``; the
   ``split`` train step; one ``halo`` forward profiled;
22. the default ``cell_impl="fused"`` model at hidden 16 in float32 (the
   Trainer's default ``precision: 32``) and at hidden 32 in bf16, 64x64 pixels,
   7 frames in and 24 out: each answers 5 concurrent requests (62 K1 launches
   per forward) and takes one Adam step with ``remat_chunk=6`` through
   ``Trainer.fit`` (124 K1 + 62 K2 launches), every cell step a launch;
   replies and gradients held against the same path through the plain
   versions;
22b. the same model at hidden widths K1 and K2 are not built for, hidden 24
   in bf16 and hidden 12 in float32: each width is zero-padded to the next one
   that is built (32, 16) inside the wrappers, so every cell step is still a
   counted K1 / K2 launch; replies and gradients held against the plain step
   at the unpadded width at phase 22's tolerances; K1, K2, K1h at hidden 264
   and K6a, K5 at hidden 136 raise and name the rule; K1 and K2 per call at
   hidden 24 beside hidden 32;
23. eval: ``evaluate_model`` on the full-width ConvLSTM (phase 6's weights,
   bf16, ``cell_impl="fused"``) over 2 batches of b8 advection
   (7 x 256x256x12 in, 24 out, MSE / SSIM / MS-SSIM per lead time), once
   through K1 (62 launches a batch, counted) and once through the plain step,
   the two sets of curves held together; the MS-SSIM of the two rollouts
   against each other per lead time; the forward and the metric computation
   timed apart;
24. SSIM-loss MetNet: ``metnet_ssim.yaml`` (metnet.yaml's widths, loss
   ``ssim``, built channel-aware, nonnegative, range-converted) trains 4 bf16
   Adam steps through ``Trainer.fit`` on one b8 256x256 advection batch (23
   channels in the fake schema) with one temporal-dropout mask: losses finite and decreasing, 7 K3 + 2 K4 launches
   per step, gradients held against the plain versions' at phase 12's
   tolerance; the train step timed under ssim beside mse;
25. the accuracy gate on the card, in float32 (the Trainer's default): (a)
   ``tests/test_accuracy.py``'s geometry (16x16, 1 channel, hidden 16, 6 lead
   times, 12 epochs, decay 0.8), the trained ConvLSTM's mean MSE below
   persistence and below both flow arms (Farneback as ``farneback_flow``
   resolves it, and Horn-Schunck), every cell step a counted K1 / K2 launch;
   (b) ``tools/accuracy_gate.py``'s baselines and ConvLSTM arm through
   ``satflow_tpu_torch.tools.accuracy_gate`` (hidden 32, 30 epochs), its
   per-lead curves printed beside the JAX study's means;
26. the ConvLSTM's lifecycle at full width (phase 8's model and data):
   ``experiments.train.train`` on the repo's default config
   (``callbacks=default``, ``trainer.device=cuda``, bf16, ``remat_chunk=6``)
   trains 4 steps with one validation and one test batch and writes
   ``checkpoints/best``, ``checkpoints/last`` and ``artifacts/final``; a second
   Trainer resumes from ``last`` for 2 more steps, its restored state equal
   to the saved one bit for bit, K1 and K2 launches counted per step, its
   weights equal bit for bit to those of an uninterrupted 6-step run from
   the same weights (cuDNN deterministic in this phase);
   ``create_model("local:...")`` behind ``NowcastServer`` with no weights
   answers 5 concurrent requests (62 K1 launches per forward), one reply
   bit-equal to a session on the trainer's in-memory weights;
   ``eval.evaluate.main --checkpoint`` scores one batch on the card; the
   checkpoint's bytes and its save and load times;
27. the full-width MetNet (metnet.yaml, ``warmup_cosine``): 3 steps, a
   checkpoint, a resume and 2 more, the restored state (BatchNorm running
   statistics included) equal to the saved one, the learning rate of each
   resumed step equal to the uninterrupted run's, 7 K3 and 2 K4 launches a
   step; then one fused ConvLSTM train step (phase 8's) under
   ``Trainer(profiler="pytorch")``, whose top device kernels ``op_breakdown``
   prints with the aten op that launched each;
28. at hidden 32 on 64x64 images: SIGTERM at step 2 (a callback sends it)
   leaves ``last`` at that step and the run resumes from it;
   ``scale_batch_size(max_trials=4)`` picks 16 and sets it on the shipped
   datamodule, whose train loader then gives batches of 16;
   ``tune`` returns a finite learning rate;
28a. the channels-stacked zoo at its shipped configs' width (``unet``,
   ``runet``, ``attention_unet``, ``attention_runet``, ``fcn_r50``,
   ``deeplabv3_r101`` and ``pixelcnn`` at its defaults; b8, 7 x 256x256x12
   in, 24 out, bf16 compute on f32 weights from numpy seed 0 in the flax
   layout, carried by the bridge): each b8 forward timed with CUDA events,
   with its peak memory, and one sample's float32 reply on the card held
   against the same forward on the CPU; ``unet`` behind ``NowcastServer``
   answers 5 concurrent requests;
28b. ``unet``, ``attention_runet``, ``deeplabv3_r101`` and ``pixelcnn``
   train 2 Adam steps through ``Trainer(precision="bf16").fit`` on fake b8
   256x256 data: losses finite, every BatchNorm statistic moved, every
   parameter's gradient finite and nonzero, the train step timed; then
   ``python -m satflow_tpu_torch.run experiment=unet_simple`` through the CLI;
28c. the full-width fused ConvLSTM, the same model under
   ``SATFLOW_STEP_VARIANT=halo``, the channel-major (``cell_impl="cmajor"``)
   ConvLSTM, MetNet and UNet exported at b8 (``serve/export.py``), each
   loaded in a fresh process that imports torch and ``satflow_tpu_torch.ops``
   only, with no step variant set: the reply held against the
   ``InferenceSession`` reply, the launches of a call (K1 62; K1h 62; K1 14,
   K6a 48 and K6b 24; K3 7 and K4 2 for MetNet), the artifact's bytes, its
   export and load times printed;
28d. ``examples/metnet_example.py`` on the card (7 K3 and 2 K4 launches a
   forward: the one that makes the lazy input width, and the example's);
28e. the Perceiver family at its shipped configs' widths, random
   weights from a seed, bf16 compute on f32 weights, b8 of the fake schema
   (7 history frames, 24 lead times): ``perceiver.yaml`` (64², depth 6, 256
   x 512 latents, 24 per-lead decodes under remat) forward timed with its
   peak memory and one sample's float32 reply held against the CPU's, then
   2 LAMB steps under ``warmup_cosine`` (``warmup_steps=0``) through
   ``Trainer.fit`` on one advection batch (losses finite, the last below
   the first),
   every gradient finite and nonzero, the train step timed; ``hf_perceiver.yaml``
   (not pretrained: depth 8, 512 latents) forward and one train step;
   ``perceiver_encoder`` (which raises at 12 channels, as in the JAX
   package, and runs at 1), ``perceiver_metnet`` and ``perceiver_single``
   one forward each; ``experiment=perceiver_simple`` through the CLI; the
   repo's kernels launched 0 times over the phase (the path has none);
28g. the parallel paths (``satflow_tpu_torch/parallel``): K1 and K2 on M = 2
   and 4 halo-extended blocks of rows (``spatial._cell_step``, halos cut from
   the whole tensors) stitched against the whole image's step at B=8, 256x256,
   Cx 12 and 64, float32 and bfloat16, forward and one backward, M launches of
   each; then, under a one-rank NCCL process group
   (``maybe_initialize_distributed`` on a free local port, shut down at the
   end), the full-width ConvLSTM trained 2 bf16 steps through ``Trainer.fit``
   with the gradients' all-reduce, with ``zero_sharding=True``, under
   ``ZeroRedundancyOptimizer`` itself and with ``spatial="1x1"`` (no remat:
   62 K1 + 62 K2 a step), each run's losses held to a plain fit's from the
   same weights, launches counted; one MetNet (metnet.yaml) step (7 K3 + 2 K4)
   held to the same step without a group; ``InferenceSession(mesh=
   ["cuda:0"])`` answering a b8 request equal to the session without a mesh;
28h. the quality studies' tools (``satflow_tpu_torch/tools``), each ``main``
   at a small budget with its JSON written under a temporary ``--out``:
   ``accuracy_256`` 1 epoch at full width (256x256, b8, hidden 64, 24 leads,
   bf16, ``remat_chunk=6``, its 4 history frames: 112 K1 + 56 K2 every
   step), the accuracy gate's
   ``metnet`` and ``metnet_stoch`` arms (4 K3 + 2 K4 a step), its
   ``perceiver`` and stacked arms (U-Net family, FCN, DeepLabV3, PixelCNN;
   no launch of K1-K4, as in the JAX package), ``gan_gate``'s
   three arms (CloudGAN's ConvLSTM generator 64 K1 + 32 K2 a round; DGMR
   with a 2-step fine-tune), ``gan_128`` at ``nowcasting_gan.yaml``'s widths,
   every ``horizon_gate`` arm (the 48-step ConvLSTM 208 K1 + 104 K2, MetNet
   4 K3 + 2 K4 a step; ``dgmr_stoch`` in a run of its own, as its card run
   goes, its fit validating no epoch), and ``gan_gate --arms dgmr --init``
   from the committed JAX initial variables (``dgmr_jax_init.npz``: every
   parameter and buffer held to the converter's output of the file
   (``gan_state_dict_from_flax``) as the fit starts, the
   ``@jax_init`` rows with its sha256); every step's launches held, each trained row's
   ``kernel_launches`` equal to the K1-K4 launches of its fit (``gan_128``'s
   fine-tuned row: of the rest of the run), every number finite, the
   rows and their keys those of the JAX study's ``docs/*.json``, each file
   naming the card;
28i. the bench tools (``satflow_tpu_torch/tools``), each ``main`` once at
   full width with 1-5 chained iterations: ``bench`` (b8, ``fused`` and
   ``cmajor``), ``bench_int8`` (b8, both arms), ``bench_axial`` (its six
   shapes), ``bench_zoo`` (its four models), ``bench_serve`` (16 clients x 2
   requests through the ``MicroBatcher``; every reply held against the
   session's single-request reply), ``bench_train`` (64 px b32; 256 px b8
   with ``remat_chunk=6``; ``--model metnet``, ``perceiver``, ``dgmr`` in
   both ``--gan-step`` modes; ``--from-store`` on a fake store read through
   the native ingest library, counted batch by batch, and
   ``--pipeline-only``) and ``exp_train_ceiling`` (its four rungs): every
   JSON line finite and naming the card, each line's ``kernel_launches`` an
   iteration equal to its path's (62 K1 a ConvLSTM forward, 124 K1 + 62 K2
   a remat train step, 62 + 62 without remat, 62 K5 an int8 rollout, 14 K1
   + 48 K6a + 24 K6b a ``cmajor`` forward, 7 K3 + 2 K4 a MetNet forward or
   step, one K4 an attention call, none for the Perceiver, DGMR, the U-Net
   and the pipeline);
29. a JSON line of the kernels with each one's bound on this card, and last
   a JSON line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import http.client
import io
import json
import keyword
import os
import re
import subprocess
import sys
import threading
import time
import types

import numpy as np

B, T, H, W, CIN, HIDDEN, COUT, STEPS = 8, 7, 256, 256, 12, 64, 12, 24
DEVICE = "cuda"
LAUNCHES_PER_FORWARD = 2 * T + 2 * STEPS  # one kernel launch per cell step
# Training with remat (per step or chunked, the JAX package's 256 px setting
# remat_chunk=6): every cell step runs forward once and once more when its
# checkpoint is recomputed in the backward (the chunked encoder and each
# decoder chunk are recomputed whole), and its backward once.
REMAT_CHUNK = 6
K1_PER_TRAIN_STEP = 2 * LAUNCHES_PER_FORWARD
K2_PER_TRAIN_STEP = LAUNCHES_PER_FORWARD
TRAIN_STEPS = 3

# Tolerances, |kernel - plain| <= atol + rtol * |plain|:
# - float32, TF32 off on both sides: both sum the same 9*(Cx+Ch) products in
#   f32, only in another order (and with another algorithm in cuDNN), so they
#   agree to a few f32 rounding steps of gates of size ~1.
TOL_F32 = dict(atol=1e-4, rtol=1e-5)
# - bfloat16: both store h' and c' in bf16, whose step is 2^-8 relative; the
#   plain version also rounds each conv's output to bf16 before the gate
#   math, while the kernel keeps the sums in f32. So they may differ by a few
#   bf16 steps of the gates and of c'.
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
# - the served rollout (bf16, sigmoid outputs in [0, 1]) against the same
#   rollout through the plain step: 31 recurrent steps of the per-step
#   difference above; outputs near 1 have a bf16 step of 2^-8, and a CPU
#   emulation of the two numerics at 64x64 differs by at most one step.
TOL_ROLLOUT = 2e-2
# - the step's six gradients (float32, TF32 off) through K1 + K2 against
#   torch autograd of the plain step: dgates agree to f32 rounding (K2 vs
#   autograd's gate chain); the linear grads are cuDNN convs on both sides,
#   merged over [x | h] here and separate there, so they sum in another
#   order: a weight-grad element sums B*H*W = 5e5 products, which puts its
#   rounding near 1e-5 x max|grad| (measured 3.8e-5, see PERF.md).
TOL_GRAD_F32 = 1e-4  # x max|grad| of each tensor
# - one bf16 train step's parameter gradients through K1 + K2 against the
#   same step through the plain versions: the plain step rounds each conv's
#   output to bf16 before the gate math, the kernels keep f32 sums; that
#   one-bf16-step difference per cell step compounds over the 62 steps of
#   the rollout and into sums over 8 x 256 x 256 pixels. A CPU emulation of
#   the two numerics at full depth on 32x32 images differs by at most
#   5.0e-3 x max|grad| per tensor, cosine > 0.99999 (see PERF.md).
TOL_TRAIN_GRAD = 5e-2  # x max|grad| of each tensor
MIN_TRAIN_GRAD_COS = 0.999

# MetNet (satflow_tpu/configs/model/metnet.yaml at the zoo's geometry: b8,
# 7 history frames of 256x256, 24 lead times, bf16 compute on f32 weights)
MN_HIDDEN, MN_HEADS, MN_F, MN_COUT, MN_CIN = 64, 8, 24, 12, 12
MN_TRAIN_CIN = 23  # the fake datamodule: 12 satellite + 1 topography + 10 NWP
MN_EH = H // 16  # 16: the temporal encoder's and the attention's grid
MN_ROWS = MN_F * B * MN_EH * MN_EH  # K3's rows per call: 49 152
MN_K3_PER_FORWARD = T  # one gate tail per history frame
# K3's checks (rows, C, layout): MetNet's and the concat forward's shapes (the
# vector kernel), odd widths on both sides of its rule (C % 8 in bf16, C % 4 in
# f32), a view one element into its storage (the per-element kernel), and
# gates that are a column slice of a wider tensor (not contiguous: the launch
# copies them, and its rule reads the aligned copy)
K3_CHECKS = ((MN_ROWS, MN_HIDDEN, ""), (B * H * W, HIDDEN, ""), (1001, 1, ""), (1001, 3, ""),
             (777, 12, ""), (513, 65, ""), (300, 256, ""), (4096, MN_HIDDEN, "offset"),
             (4096, MN_HIDDEN, "columns"))
K3_LAYOUTS = {"": "", "offset": " offset by one element", "columns": " gates a column slice"}
MN_K4_PER_FORWARD = 2  # one attention along H, one along W
K4_SHAPES = ((MN_F * B * MN_EH * MN_HEADS, MN_EH, MN_HIDDEN // MN_HEADS),  # MetNet's
             (16384, 64, 32), (4096, 64, 64),  # between the short-axis and the long-axis regime
             (2048, 128, 64), (2048, 256, 64), (256, 512, 256))  # the long-axis regime
# the edges of K4's three kernels (rows: L <= 32 and D <= 32; else mma in
# bfloat16, tile in float32): L = 1, 17, 32, 33, 100, 512; D = 1, 8, 24, 32, 33,
# 100, 256; N = 1 and N that are no multiple of the batch rows a block takes
K4_EDGES = ((1, 1, 1), (7, 17, 8), (33, 17, 24), (5, 32, 32), (3, 33, 32), (3, 32, 33),
            (3, 100, 100), (2, 512, 1), (1, 512, 256), (37, 16, 8), (4, 100, 24), (3, 130, 24),
            (1001, 1, 8), (2, 64, 256), (5, 65, 16))
# K6b's edges, (B, H, W, Cin, Cout): one and many channels in and out, images
# that are a multiple of no tile (8 x 32 in bfloat16, 16 x 32 in float32), a
# width that is no multiple of 8 (the staging by the element)
K6B_EDGES = ((2, 10, 18, 1, 1), (2, 10, 18, 12, 16), (1, 50, 72, 12, 1), (2, 33, 40, 128, 16),
             (1, 7, 5, 64, 12), (3, 16, 64, 20, 5))
# Tolerances, |kernel - plain| <= atol + rtol * |plain|:
# - K3 and K4, float32: the same f32 arithmetic (K4's online softmax sums the
#   keys in tiles, in another order): a few f32 rounding steps.
TOL_K34_F32 = dict(atol=1e-5, rtol=1e-5)
# - K3 and K4, bfloat16: both keep f32 inside and round only the stored
#   output; an f32 difference at a rounding boundary flips one bf16 step.
TOL_K34_BF16 = dict(atol=1e-2, rtol=2 ** -7)
# - the served MetNet reply (bf16 compute, f32 head) against the same forward
#   through the plain versions: one-step bf16 flips in h' and in the
#   attention output carried through the MLP and the head.
TOL_MN_REPLY = 5e-2  # x max|plain|
# MetNet's parameters whose gradient is zero in exact arithmetic (c0's bias
# is a per-channel shift that the max-pool passes on and the train-mode
# BatchNorm removes; a key bias shifts every score of a row alike, which the
# softmax removes): both sides are rounding noise, held to be small against
# the same layer's weight gradient instead.
MN_ZERO_GRAD = ("image_encoder.c0.bias", "axial0.attn0.k.bias", "axial0.attn1.k.bias")


# The int8 step (K5) against its plain version: the integer sums are exact on
# both sides, so only exp/tanh differ, by an ulp, between ATen and CUDA. h'q =
# rint(h' * 127) may then flip by one step at a rounding boundary, on at most
# 0.1 % of elements; c' may differ by one step of its dtype (bf16: spacing <=
# 2^-7 |c'|; f32: a few ulp).
INT8_MAX_FLIP_SHARE = 1e-3
TOL_INT8_C = {"bfloat16": dict(atol=2 ** -14, rtol=2 ** -7), "float32": dict(atol=1e-6, rtol=1e-6)}
# - the int8 reply against the bf16 reply, and against the same int8 rollout
#   through K5's plain version: the JAX package's own int8-vs-bf16 bar on the
#   sigmoid outputs (tests/test_int8.py).
TOL_INT8_REPLY = 2e-2
# - K6b's outputs (the head, before the sigmoid) are not range-bound: bf16 is
#   held to one bf16 step relative beyond K1's absolute slack.
TOL_HEAD_BF16 = dict(atol=2e-2, rtol=2e-2)
INT8_LAUNCHES_PER_FORWARD = LAUNCHES_PER_FORWARD      # every cell step is one K5 launch
CMAJOR_LAUNCHES_PER_FORWARD = (2 * T, 2 * STEPS, STEPS)  # K1 (encoder), K6a, K6b

# K1h, T1 and T3 compute K1's (K6a's) sums, in the same order per thread or
# another: against K1 / K6a they are held to a few f32 rounding steps, and in
# bf16 to one bf16 step of the stored outputs (h' in (-1, 1): 2^-8 relative
# below 1, so 2^-7 absolute covers a flip of h' and rtol 2^-7 one of c').
TOL_SAME_SUMS = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2 ** -7, rtol=2 ** -7)}
# - T2's outputs are unbounded sums (no sigmoid or tanh): held relative to
#   max|plain|; float32: f32 rounding of sums of 1152 products; bfloat16: two
#   bf16 steps (the stored c' and h' each round once, h' sums c').
TOL_NOGATE_REL = {"float32": 1e-5, "bfloat16": 2 ** -7}
HALO_BLOCK_H = 8   # rows per row block of K1h and block_h of T3's pad rows
STUDY_STEPS = {"tap9": 20, "cmajor": 24}  # the chained rollouts of the two study tools
K3_PER_FORWARD = LAUNCHES_PER_FORWARD     # concat/split/hybrid: one gate tail per cell step

# Phase 23: ``evaluate_model`` on the full-width ConvLSTM over EVAL_BATCHES
# batches of b8 advection, once through K1 and once through the plain step.
# Both are bf16 rollouts whose outputs differ by at most TOL_ROLLOUT; the
# curves average that over 8 x 256 x 256 pixels, so they are held to: MSE
# |K1 - plain| <= 5 % of plain + 1e-4, SSIM and MS-SSIM within 1e-2, and the
# MS-SSIM of the two rollouts against each other >= 0.99 at every lead time.
EVAL_BATCHES = 2
TOL_EVAL_MSE = dict(rtol=5e-2, atol=1e-4)
TOL_EVAL_SSIM = 1e-2
MIN_ROLLOUT_MS_SSIM = 0.99
# Phase 24: metnet_ssim.yaml trains SSIM_STEPS Adam steps on one batch of
# advection (a signal SSIM can learn; the fake datamodule's targets are white
# noise) with one temporal-dropout mask, so that each step's loss is the same
# function of the weights and must fall; warmup_steps=0 puts the config's lr
# (1e-3) on the first step (the default warmup of 1000 steps would hold it
# near 1e-8). On an H100 the loss fell 0.973 -> 0.455 over these 4 steps and
# monotonically for 7; on the noise targets it rose first (PERF.md §6).
SSIM_STEPS = 4
# Phase 25 (a): tests/test_accuracy.py's gate geometry (DecayDM of 8 batches
# a split, eval set of 2 at seed 300, 6 lead times, 12 epochs, hidden 16,
# lr 5e-3, the Trainer's default precision 32)
GATE_KW = dict(batch_size=8, width=16, height=16, number_sat_channels=1, history_minutes=15,
               forecast_minutes=30, velocity=(1, 1), decay=0.8, n_blobs=3)
GATE_STEPS, GATE_EPOCHS, GATE_LEN = 6, 12, 8
# (b): the JAX study's means over 12 lead times (docs/ACCURACY.md:20-33; model
# quality on the TPU rebuild's runs, printed beside the port's, not held)
JAX_STUDY = {"persistence": 0.02084, "optical_flow": 0.00867, "optical_flow_hs": 0.02590,
             "convlstm": 0.00657, "convlstm_ms_ssim": 0.2355}

# The card's published peaks (H100 SXM data sheet, dense): what a kernel's
# bound is computed from.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound_ms(tensors, ops: float, kind: str):
    """The least time the card could take: (ms, "bytes" or "operations"), the
    larger of every tensor in ``tensors`` (inputs and outputs) moved once at
    the HBM rate and ``ops`` operations at the peak rate of ``kind``."""
    by_bytes = sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S
    by_ops = ops / PEAK_OPS_PER_S[kind]
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def lecun_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """flax's lecun_normal for an HWIO kernel: a normal truncated at 2 sigma,
    rescaled to variance 1/fan_in."""
    z = rng.standard_normal(shape)
    while True:
        out = np.abs(z) > 2
        if not out.any():
            break
        z[out] = rng.standard_normal(int(out.sum()))
    fan_in = int(np.prod(shape[:-1]))
    return (z * np.sqrt(1.0 / fan_in) / 0.87962566103423978).astype(np.float32)


def flax_params(seed: int = 0, hidden: int = HIDDEN) -> dict:
    """Random weights in the JAX model's flax tree: lecun-normal kernels,
    zero biases."""
    rng = np.random.default_rng(seed)

    def cell(cx):
        return {
            "x_gates_kernel": lecun_normal(rng, (3, 3, cx, 4 * hidden)),
            "h_gates_kernel": lecun_normal(rng, (3, 3, hidden, 4 * hidden)),
            "bias": np.zeros(4 * hidden, np.float32),
        }

    return {"params": {
        "encoder": {"encoder_1": cell(CIN), "encoder_2": cell(hidden)},
        "decoder": {
            "decoder_1": cell(hidden), "decoder_2": cell(hidden),
            "head": {"kernel": lecun_normal(rng, (3, 3, hidden, COUT)),
                     "bias": np.zeros(COUT, np.float32)},
        },
    }}


def cuda_ms(torch, fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def within(torch, got, want, tol) -> bool:
    diff = (got.float() - want.float()).abs()
    return bool((diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all())


def step_inputs(torch, cx: int, dtype, seed: int, ch: int = HIDDEN, bhw=(B, H, W)):
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rand(*shape, scale=1.0, normal=False):
        f = torch.randn if normal else torch.rand
        return (f(*shape, generator=g, device=DEVICE) * scale).to(dtype)

    x = rand(*bhw, cx)                                  # frames in [0, 1]
    h = rand(*bhw, ch) * 2 - 1                          # h in (-1, 1)
    c = rand(*bhw, ch, normal=True)
    wx = rand(3, 3, cx, 4 * ch, normal=True, scale=(9 * cx) ** -0.5)
    wh = rand(3, 3, ch, 4 * ch, normal=True, scale=(9 * ch) ** -0.5)
    b = rand(4 * ch, normal=True, scale=0.1)
    return x, h, c, wx, wh, b


REGIONS = {
    "all": (slice(None),) * 3,
    "row0": (slice(None), 0), "rowH-1": (slice(None), -1),
    "col0": (slice(None), slice(None), 0),
    "colW-1": (slice(None), slice(None), -1),
}


def within_one_bf16_step(torch, got, exact_f32, what: str) -> str:
    """Holds a bf16 kernel's outputs against the plain version run in float32
    on the same bf16 values (f32 sums, the exact f32 gate math) and rounded to
    bf16 once: the kernel keeps f32 sums and exact gate math too, so the two
    differ by f32 rounding before the one rounding to bf16, at most one bf16
    step (TOL_SAME_SUMS), tighter than the bf16 plain version allows. Returns
    the text for the phase's line."""
    tol = TOL_SAME_SUMS["bfloat16"]
    worst = 0.0
    for g_, w_ in zip(got, exact_f32):
        w_ = w_.to(torch.bfloat16)
        worst = max(worst, (g_.float() - w_.float()).abs().max().item())
        if not within(torch, g_, w_, tol):
            fail(f"{what}: bf16 kernel vs the f32 plain version on the same values, rounded "
                 f"to bf16: max|diff| {worst:.3g} beyond one bf16 step {tol}")
    return f"; vs the f32 plain version rounded to bf16 max|diff| {worst:.3g} (one bf16 step)"


def check_kernel(torch, step, step_ref, card) -> float:
    """Phase 3; returns the largest bf16 |K1 - plain|."""
    worst_bf16 = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for cx in (CIN, HIDDEN):
            args = step_inputs(torch, cx, dtype, seed=cx)
            got = step(*args)
            want = step_ref(*args)
            torch.cuda.synchronize()
            errs = {}
            for name, idx in REGIONS.items():
                for out_name, g_, w_ in (("h", got[0], want[0]), ("c", got[1], want[1])):
                    errs[f"{out_name}.{name}"] = (g_[idx].float() - w_[idx].float()).abs().max().item()
                    if not within(torch, g_[idx], w_[idx], tol):
                        fail(f"kernel != plain: {dtype} Cx={cx} {out_name} {name} "
                             f"max|diff|={errs[f'{out_name}.{name}']:.3g} tol={tol}")
            max_err = max(errs.values())
            exact = ""
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, max_err)
                exact = within_one_bf16_step(torch, got, step_ref(*(a.float() for a in args)),
                                             f"K1 Cx={cx}")
            print(f"kernel vs plain: {str(dtype)[6:]} B={B} {H}x{W} Cx={cx} Ch={HIDDEN}: "
                  f"max|diff| {max_err:.3g} (edges: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items() if "all" not in k)
                  + f") tol {tol} ok{exact} [{card}]", flush=True)
    return worst_bf16


def cotangents(torch, dtype, seed: int, ch: int = HIDDEN, bhw=(B, H, W)):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return tuple(torch.randn(*bhw, ch, generator=g, device=DEVICE).to(dtype)
                 for _ in range(2))


def check_gate_bwd(torch, gate_bwd, gate_bwd_ref, card) -> float:
    """Phase 4; returns the largest bf16 |K2 - plain|."""
    worst_bf16 = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for cx in (CIN, HIDDEN):
            args = step_inputs(torch, cx, dtype, seed=cx) + cotangents(torch, dtype, seed=cx + 1)
            got = gate_bwd(*args)
            want = gate_bwd_ref(*args)
            torch.cuda.synchronize()
            errs = {}
            for name, idx in REGIONS.items():
                for out_name, g_, w_ in (("dgates", got[0], want[0]), ("dc_prev", got[1], want[1])):
                    key = f"{out_name}.{name}"
                    errs[key] = (g_[idx].float() - w_[idx].float()).abs().max().item()
                    if not within(torch, g_[idx], w_[idx], tol):
                        fail(f"K2 != plain: {dtype} Cx={cx} {key} max|diff|={errs[key]:.3g} tol={tol}")
            max_err = max(errs.values())
            exact = ""
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, max_err)
                exact = within_one_bf16_step(torch, got, gate_bwd_ref(*(a.float() for a in args)),
                                             f"K2 Cx={cx}")
            print(f"K2 vs plain: {str(dtype)[6:]} B={B} {H}x{W} Cx={cx} Ch={HIDDEN}: "
                  f"max|diff| {max_err:.3g} (edges: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items() if "all" not in k)
                  + f") tol {tol} ok{exact} [{card}]", flush=True)
    return worst_bf16


def check_function_grads(torch, step, step_ref, card) -> None:
    """Phase 5: dx, dh, dc, dWx, dWh, db through FusedConvLSTMStep (K1 + K2)
    against torch autograd of the plain step, float32."""
    for cx in (CIN, HIDDEN):
        args = step_inputs(torch, cx, torch.float32, seed=200 + cx)
        dh, dc = cotangents(torch, torch.float32, seed=300 + cx)

        def grads(fn):
            ts = [a.clone().requires_grad_() for a in args]
            h_next, c_next = fn(*ts)
            ((h_next * dh).sum() + (c_next * dc).sum()).backward()
            return [t.grad for t in ts], h_next

        got, h_next = grads(step)
        if type(h_next.grad_fn).__name__ != "FusedConvLSTMStepBackward":
            fail(f"the step under autograd is {h_next.grad_fn}, not FusedConvLSTMStep")
        want, _ = grads(step_ref)
        torch.cuda.synchronize()
        rel = {}
        for name, g_, w_ in zip(("dx", "dh", "dc", "dWx", "dWh", "db"), got, want):
            scale = w_.abs().max().item()
            rel[name] = (g_ - w_).abs().max().item() / scale
            if not rel[name] <= TOL_GRAD_F32:
                fail(f"step gradient {name} (Cx={cx}) through K1+K2 vs plain autograd: "
                     f"max|diff| / max|grad| {rel[name]:.3g} > {TOL_GRAD_F32}")
        print(f"step gradients through K1+K2 vs plain autograd, float32 B={B} {H}x{W} Cx={cx}: "
              "max|diff| / max|grad| " + ", ".join(f"{k} {v:.2g}" for k, v in rel.items())
              + f" <= {TOL_GRAD_F32} ok [{card}]", flush=True)


# Phases 3-5 once more at the other hidden widths K1 and K2 are built for, on
# an image that is a multiple of neither tile (8 x 16 pixels; 4 x 16 at Ch >=
# 128), as (Ch, the Cx it is held at): above 128 (two groups of 128 channels a
# pixel, 192 zero-padded to 256) at Cx 12 and at the widest input, 256.
WIDTHS = tuple((ch, (1, 12, 20, ch)) for ch in (8, 16, 32, 128)) + ((192, (12, 256)),
                                                                   (256, (12, 256)))
WIDTHS_BHW = (2, 50, 70)


def check_widths(torch, P, card) -> None:
    """K1, K2 and the six gradients of ``FusedConvLSTMStep`` against their
    plain versions at Ch 8, 16, 32, 128 with Cx 1, 12, 20 (padded to 32 in
    the staged window, its rows no whole 16-byte pieces) and Ch, and at Ch 192
    and 256 with Cx 12 and 256, float32 and bfloat16, the edge regions on
    their own, the launches counted. The gradients are held relative to
    max|grad|: float32 to TOL_GRAD_F32, bfloat16 to the bf16 train step's
    TOL_TRAIN_GRAD and cosine."""
    names = ("dx", "dh", "dc", "dWx", "dWh", "db")
    for ch, cxs in WIDTHS:
        for cx in cxs:
            for dtype, tol, grad_tol in ((torch.float32, TOL_F32, TOL_GRAD_F32),
                                         (torch.bfloat16, TOL_BF16, TOL_TRAIN_GRAD)):
                name = str(dtype)[6:]
                what = f"{name} Cx={cx} Ch={ch}"
                args = step_inputs(torch, cx, dtype, seed=1000 + ch + cx, ch=ch, bhw=WIDTHS_BHW)
                cots = cotangents(torch, dtype, seed=2000 + ch + cx, ch=ch, bhw=WIDTHS_BHW)
                before = P.fused_convlstm_step.launches, P.gate_bwd.launches
                got = P.fused_convlstm_step(*args) + P.gate_bwd(*args, *cots)
                torch.cuda.synchronize()
                if (P.fused_convlstm_step.launches, P.gate_bwd.launches) != (before[0] + 1,
                                                                            before[1] + 1):
                    fail(f"K1 or K2 did not launch at {what}")
                want = P.fused_convlstm_step_ref(*args) + P.gate_bwd_ref(*args, *cots)
                errs = {out: max(_max_err(torch, g_[idx], w_[idx], tol,
                                          f"{'K1' if i < 2 else 'K2'} vs plain {what} {out} {region}")
                                 for region, idx in REGIONS.items())
                        for i, (out, g_, w_) in enumerate(zip(("h", "c", "dgates", "dc_prev"),
                                                              got, want))}

                def grads(fn):
                    ts = [a.clone().requires_grad_() for a in args]
                    h_next, c_next = fn(*ts)
                    ((h_next * cots[0]).sum() + (c_next * cots[1]).sum()).backward()
                    return [t.grad.float() for t in ts]

                rel = {}
                for n, g_, w_ in zip(names, grads(P.fused_convlstm_step),
                                     grads(P.fused_convlstm_step_ref)):
                    rel[n] = (g_ - w_).abs().max().item() / w_.abs().max().item()
                    cos = torch.nn.functional.cosine_similarity(g_.flatten(), w_.flatten(),
                                                                dim=0).item()
                    if not (rel[n] <= grad_tol and cos >= MIN_TRAIN_GRAD_COS):
                        fail(f"step gradient {n} through K1+K2 vs plain autograd at {what}: "
                             f"max|diff| / max|grad| {rel[n]:.3g} > {grad_tol} or cosine "
                             f"{cos:.6f} < {MIN_TRAIN_GRAD_COS}")
                print(f"K1, K2 vs plain: {name} B={WIDTHS_BHW[0]} {WIDTHS_BHW[1]}x{WIDTHS_BHW[2]} "
                      f"Cx={cx} Ch={ch}: max|diff| (edges held on their own) "
                      + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" tol {tol}; "
                      "gradients max|diff| / max|grad| "
                      + ", ".join(f"{k} {v:.2g}" for k, v in rel.items())
                      + f" <= {grad_tol} ok [{card}]", flush=True)


def post(port: int, x: np.ndarray, out: list, i: int) -> None:
    buf = io.BytesIO()
    np.save(buf, x)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/predict", body=buf.getvalue(),
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        body = resp.read()
        out[i] = (resp.status, np.load(io.BytesIO(body)) if resp.status == 200 else body)
    except Exception as e:  # noqa: BLE001 - reported by the caller
        out[i] = (None, repr(e))
    finally:
        conn.close()


def drive_server(session, requests, counters):
    """Serve ``requests`` concurrently through ``NowcastServer(session)``; the
    counters' launches are set to 0 just before the requests and read just
    after. Returns (replies as (status, array or body), wall seconds,
    forwards, launches per counter)."""
    from satflow_tpu_torch.serve import NowcastServer

    server = NowcastServer(session, port=0, window_ms=200.0)
    server.start()
    replies = [None] * len(requests)
    try:
        for counter in counters:
            counter.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(server.port, x, replies, i))
                   for i, x in enumerate(requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = tuple(counter.launches for counter in counters)
        forwards = server.batcher.batches_run
    finally:
        server.close()
    if any(t.is_alive() for t in threads):
        fail("a request did not finish")
    return replies, wall, forwards, launches


def check_frames(requests, replies, what: str) -> None:
    """Every reply 200, of the ConvLSTM's shape, finite and in [0, 1]."""
    for x, (status, y) in zip(requests, replies):
        if status != 200:
            fail(f"{what}: request of shape {x.shape} answered {status}: {y!r}"[:500])
        want = x.shape[:-4] + (STEPS,) + x.shape[-3:-1] + (COUT,)
        if y.shape != want:
            fail(f"{what}: reply shape {y.shape}, expected {want}")
        if not np.isfinite(y).all() or y.min() < 0 or y.max() > 1:
            fail(f"{what}: reply not finite in [0, 1]: min {y.min()}, max {y.max()}")


def convlstm_requests(seed: int = 1, hw=(H, W)):
    """Four single samples and one micro-batch of two, in [0, 1]."""
    rng = np.random.default_rng(seed)
    requests = [rng.random((T, *hw, CIN), dtype=np.float32) for _ in range(4)]
    requests.append(rng.random((2, T, *hw, CIN), dtype=np.float32))
    return requests


def serve_slice(torch, card):
    """Phase 6; returns (launches, forwards, rollout max|diff|, model)."""
    from satflow_tpu_torch.interop.jax_weights import params_from_flax
    from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM
    from satflow_tpu_torch.ops.fused_convlstm_step import (
        fused_convlstm_step,
        fused_convlstm_step_ref,
    )
    from satflow_tpu_torch.serve import InferenceSession

    model = EncoderDecoderConvLSTM(hidden_dim=HIDDEN, input_channels=CIN,
                                   out_channels=COUT, forecast_steps=STEPS)
    session = InferenceSession(model, max_batch=B, state_dict=params_from_flax(flax_params(0)),
                               dtype=torch.bfloat16, device=DEVICE)
    requests = convlstm_requests()
    replies, wall, forwards, (launches,) = drive_server(session, requests,
                                                        [fused_convlstm_step])
    check_frames(requests, replies, "bf16 serving")
    if forwards < 1 or launches != LAUNCHES_PER_FORWARD * forwards:
        fail(f"kernel launches {launches} != {LAUNCHES_PER_FORWARD} x {forwards} forwards")
    print(f"served {len(requests)} requests (6 samples) in {forwards} forward(s) of b{B}, "
          f"{wall:.3f} s wall; kernel launches {launches} = {LAUNCHES_PER_FORWARD} x {forwards} "
          f"[{card}]", flush=True)

    with torch.inference_mode():
        x0 = torch.from_numpy(requests[0][None]).to(DEVICE, torch.bfloat16)
        ref = model(x0, step=fused_convlstm_step_ref).float().cpu().numpy()[0]
    diff = float(np.abs(ref - replies[0][1]).max())
    if not diff <= TOL_ROLLOUT:
        fail(f"served rollout vs plain-step rollout: max|diff| {diff:.3g} > {TOL_ROLLOUT}")
    print(f"served rollout vs plain-step rollout (bf16, {STEPS} steps): max|diff| {diff:.3g} "
          f"<= {TOL_ROLLOUT} ok [{card}]", flush=True)
    return launches, forwards, diff, model


def per_call_ms(torch, kernel, plain, args, library=None, n: int = 20) -> dict:
    """Mean ms per call of a kernel and its plain version, in turns; with
    ``library`` (one PyTorch call that computes the same function, a yardstick
    that the port never calls) its time too, under "library"."""
    fns = {"kernel": kernel, "plain": plain}
    if library is not None:
        fns["library"] = library
    with torch.no_grad():
        for fn in fns.values():
            cuda_ms(torch, lambda: fn(*args), 3)  # warm-up
        runs = {name: [] for name in fns}
        order = list(fns)[::-1]
        for name in order + order[::-1]:  # plain, kernel, kernel, plain
            runs[name].append(cuda_ms(torch, lambda: fns[name](*args), n))
    return {k: sum(v) / len(v) for k, v in runs.items()}


def timings(torch, step, step_ref, bwd, bwd_ref, model, card):
    """Phase 7: per-call times of K1 and K2 and per-forward times, kernel
    and plain in turns. Returns ({Cx: K1 times}, {Cx: K2 times})."""
    per_call, per_call_bwd = {}, {}
    for cx in (CIN, HIDDEN):
        args = step_inputs(torch, cx, torch.bfloat16, seed=100 + cx)
        flop = 2 * B * H * W * 4 * HIDDEN * 9 * (cx + HIDDEN)  # the gate contraction
        per_call[cx] = per_call_ms(torch, step, step_ref, args)
        cots = cotangents(torch, torch.bfloat16, seed=150 + cx)
        per_call_bwd[cx] = per_call_ms(torch, bwd, bwd_ref, args + cots)
        state = args[2]  # K1 writes h' and c'; K2 dgates (4Ch wide) and dc_prev
        per_call[cx]["bound"] = bound_ms(args + (state, state), flop, "bf16")
        per_call_bwd[cx]["bound"] = bound_ms(args + cots + (state,) * 5, flop, "bf16")
        for name, t in (("K1 (step)", per_call[cx]), ("K2 (gate backward)", per_call_bwd[cx])):
            print(f"time per {name} call, bf16 B={B} {H}x{W} Cx={cx} Ch={HIDDEN}: "
                  f"kernel {t['kernel']:.4f} ms ({flop / t['kernel'] / 1e9:.1f} TFLOP/s, "
                  f"{100 * flop / (t['kernel'] * 1e-3) / PEAK_OPS_PER_S['bf16']:.1f} % of the bf16 "
                  f"tensor cores' {PEAK_OPS_PER_S['bf16'] / 1e12:.0f}), "
                  f"plain {t['plain']:.4f} ms ({flop / t['plain'] / 1e9:.1f} TFLOP/s); bound "
                  f"{t['bound'][0]:.4f} ms by {t['bound'][1]} [{card}]", flush=True)

    # the float32 instantiations (f32 FMAs on the CUDA cores) and the other
    # hidden widths, Cx = Ch, at the same geometry
    for dtype, ch in ((torch.float32, HIDDEN), (torch.float32, 16), (torch.bfloat16, 16),
                      (torch.bfloat16, 32), (torch.bfloat16, 128)):
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        args = step_inputs(torch, ch, dtype, seed=170 + ch, ch=ch)
        cots = cotangents(torch, dtype, seed=180 + ch, ch=ch)
        flop = 2 * B * H * W * 4 * ch * 9 * (ch + ch)
        t1 = per_call_ms(torch, step, step_ref, args, n=10)
        t2 = per_call_ms(torch, bwd, bwd_ref, args + cots, n=10)
        bound = bound_ms(args + (args[2],) * 2, flop, kind)
        print(f"time per call, {str(dtype)[6:]} B={B} {H}x{W} Cx=Ch={ch}: K1 {t1['kernel']:.4f} ms "
              f"({flop / t1['kernel'] / 1e9:.1f} TFLOP/s, {100 * flop / (t1['kernel'] * 1e-3) / PEAK_OPS_PER_S[kind]:.1f} "
              f"% of the {kind} peak), plain {t1['plain']:.4f} ms; K2 {t2['kernel']:.4f} ms "
              f"({flop / t2['kernel'] / 1e9:.1f} TFLOP/s), plain {t2['plain']:.4f} ms; K1's bound "
              f"{bound[0]:.4f} ms by {bound[1]} [{card}]", flush=True)

    x = torch.from_numpy(np.random.default_rng(2).random((B, T, H, W, CIN), dtype=np.float32))
    x = x.to(DEVICE, torch.bfloat16)
    per_forward = {"plain": [], "kernel": []}
    with torch.inference_mode():
        for fn in (step, step_ref):
            model(x, step=fn)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        for name in ("kernel", "plain", "plain", "kernel"):
            fn = step if name == "kernel" else step_ref
            per_forward[name].append(cuda_ms(torch, lambda: model(x, step=fn), 2))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name, runs in per_forward.items():
        ms = sum(runs) / len(runs)
        print(f"b{B} forward ({T} in, {STEPS} out, {H}x{W}x{CIN}, bf16) through the {name} step: "
              f"{ms:.2f} ms, {B * STEPS / (ms / 1e3):.1f} frames/s (runs {', '.join(f'{r:.2f}' for r in runs)} ms); "
              f"peak device memory {peak_gib:.2f} GiB [{card}]", flush=True)
    with torch.inference_mode():
        print_profile(f"b{B} forward through the fused (K1, bf16) rollout",
                      device_time_by_class(torch, lambda: model(x), FORWARD_CLASSES), card)
    return per_call, per_call_bwd


class LaunchesPerStep:
    """Trainer callback: the launches of each train step, per counter."""

    def __init__(self, *counters):
        self.counters = counters
        self.per_step = []
        self._last = (0,) * len(counters)

    def on_train_start(self, engine) -> None:
        self._last = tuple(c.launches for c in self.counters)

    def on_train_batch_end(self, engine, metrics, step) -> None:
        now = tuple(c.launches for c in self.counters)
        self.per_step.append(tuple(n - l for n, l in zip(now, self._last)))
        self._last = now

    def on_validation_end(self, engine, metrics, epoch) -> None:
        self._last = tuple(c.launches for c in self.counters)

    def on_preemption(self, engine) -> None: ...

    def on_train_end(self, engine) -> None: ...


def timed_train_steps(torch, steps: dict, state, batch):
    """Host-clock ms of each train step in ``steps`` ({"kernel": fn, "plain":
    fn}), after one warm-up each, in turns (plain, kernel, kernel, plain);
    returns ({name: [ms, ms]}, {name: peak GiB})."""
    for fn in steps.values():
        fn(state, batch)  # warm-up
    runs = {"plain": [], "kernel": []}
    peaks = {"plain": 0.0, "kernel": 0.0}
    for name in ("plain", "kernel", "kernel", "plain"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        steps[name](state, batch)
        torch.cuda.synchronize()
        runs[name].append((time.perf_counter() - t0) * 1e3)
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated() / 2**30)
    return runs, peaks


def profile_step(torch, train_step, state, batch, card) -> None:
    """One train step through the kernels under torch.profiler: device time
    by kernel class, the device's idle share of the step's wall time, and
    the head's convs among the library convs."""
    result = device_time_by_class(torch, lambda: train_step(state, batch), CONVLSTM_CLASSES)
    # the head's convs (weight (COUT, HIDDEN, 3, 3)), from the device time of
    # the aten ops that launched them
    head = sum(evt.device_time_total / 1e3
               for evt in result[-1].key_averages(group_by_input_shape=True)
               if evt.key in ("aten::cudnn_convolution", "aten::convolution_backward")
               and [COUT, HIDDEN, 3, 3] in (evt.input_shapes or []))
    print_profile(f"train step (bf16 b{B} {H}x{W}, {T} in / {STEPS} out, remat_chunk "
                  f"{REMAT_CHUNK})", result, card,
                  f"; of the library convs, the head's {head:.2f} ms")


def train_slice(torch, card):
    """Phase 8; returns (K1 launches, K2 launches, max rel grad diff,
    train-step ms {"kernel", "plain"})."""
    from satflow_tpu_torch.data import SatFlowDataModule
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.interop.jax_weights import params_from_flax
    from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM
    from satflow_tpu_torch.ops.fused_convlstm_step import (
        fused_convlstm_step,
        fused_convlstm_step_ref,
        gate_bwd,
    )
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.steps import make_train_step

    model = EncoderDecoderConvLSTM(hidden_dim=HIDDEN, input_channels=CIN, out_channels=COUT,
                                   forecast_steps=STEPS, remat=True, remat_chunk=REMAT_CHUNK)
    model.module.load_state_dict(params_from_flax(flax_params(0)))
    # FakeDataset: TRAIN_STEPS train batches and one val batch of b8 256x256
    dm = SatFlowDataModule(fake_data=True, num_workers=0, n_train_data=TRAIN_STEPS,
                           n_val_data=1, history_minutes=5 * (T - 1),
                           forecast_minutes=5 * STEPS,  # 5-minute frames
                           fake_kwargs=dict(batch_size=B, width=W, height=H))
    counter = LaunchesPerStep(fused_convlstm_step, gate_bwd)
    trainer = Trainer(max_steps=TRAIN_STEPS, precision="bf16", log_every_n_steps=1,
                      device=DEVICE, callbacks=[counter])
    fused_convlstm_step.launches = gate_bwd.launches = 0
    t0 = time.perf_counter()
    trainer.fit(model, dm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = fused_convlstm_step.launches, gate_bwd.launches
    losses = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
    val_loss = trainer.callback_metrics.get("val/loss", float("nan"))
    if trainer.global_step != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        fail(f"fit took {trainer.global_step} steps and logged {len(losses)} losses, "
             f"not {TRAIN_STEPS}")
    if not all(np.isfinite(losses + [val_loss])):
        fail(f"non-finite losses: train {losses}, val {val_loss}")
    want_step = (K1_PER_TRAIN_STEP, K2_PER_TRAIN_STEP)
    if counter.per_step != [want_step] * TRAIN_STEPS:
        fail(f"(K1, K2) launches per train step {counter.per_step}, expected {want_step} "
             f"(forward + remat recompute, backward) x {TRAIN_STEPS}")
    # the epoch's validation batch is one forward
    if (k1, k2) != (TRAIN_STEPS * K1_PER_TRAIN_STEP + LAUNCHES_PER_FORWARD,
                    TRAIN_STEPS * K2_PER_TRAIN_STEP):
        fail(f"fit launched K1 {k1} and K2 {k2} times")
    print(f"trained {TRAIN_STEPS} steps (bf16, b{B} {H}x{W}, {T} in / {STEPS} out, remat_chunk "
          f"{REMAT_CHUNK}) in {wall:.2f} s wall with data generation: losses "
          + ", ".join(f"{v:.6f}" for v in losses) + f", val {val_loss:.6f}; launches per step "
          f"K1 {K1_PER_TRAIN_STEP} (forward + recompute) and K2 {K2_PER_TRAIN_STEP}; fit total "
          f"K1 {k1} (with one validation forward), K2 {k2} [{card}]", flush=True)

    batch = to_device(next(iter(dm.train_dataloader())), torch.device(DEVICE))

    worst = compare_step_grads(torch, model, batch, dict(step=fused_convlstm_step),
                               dict(step=fused_convlstm_step_ref), "K1+K2", card)

    state = trainer.state
    steps = {"kernel": make_train_step(model),
             "plain": make_train_step(model, step=fused_convlstm_step_ref)}
    runs, peaks = timed_train_steps(torch, steps, state, batch)
    step_ms = {k: sum(v) / len(v) for k, v in runs.items()}
    for name in ("kernel", "plain"):
        print(f"b{B} train step (bf16, {T} in / {STEPS} out, {H}x{W}x{CIN}, remat_chunk "
              f"{REMAT_CHUNK}, Adam) through the {name} step: {step_ms[name]:.2f} ms, "
              f"{B * STEPS / (step_ms[name] / 1e3):.1f} frames/s (runs "
              f"{', '.join(f'{r:.2f}' for r in runs[name])} ms); peak device memory "
              f"{peaks[name]:.2f} GiB [{card}]", flush=True)
    profile_step(torch, steps["kernel"], state, batch, card)
    return k1, k2, worst, step_ms


def _randn(torch, *shape, seed: int, scale: float = 1.0):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=DEVICE) * scale


def _max_err(torch, got, want, tol, what: str) -> float:
    err = (got.float() - want.float()).abs().max().item()
    if not within(torch, got, want, tol):
        fail(f"{what}: max|diff| {err:.3g} beyond tol {tol}")
    return err


def check_gate_tail(torch, card) -> float:
    """Phase 9a: both of K3's kernels vs the plain version, each call counted
    on the path ``vector_path`` names (the vector kernel at MetNet's and the
    concat forward's shapes and on gates that are not contiguous; the
    per-element one at odd widths and on views one element into their
    storage), and FusedLSTMGates' gradients; returns the largest bf16 |K3 - plain| at
    MetNet's shape."""
    from satflow_tpu_torch.ops import fused_lstm as G

    fn = G.fused_lstm_gates
    counts = lambda: (fn.launches, fn.vector_launches, fn.element_launches)  # noqa: E731
    worst = 0.0
    for rows, ch, layout in K3_CHECKS:
        for dtype, tol in ((torch.float32, TOL_K34_F32), (torch.bfloat16, TOL_K34_BF16)):
            offset = int(layout == "offset")
            flat_g = _randn(torch, rows * 4 * ch + 1, seed=rows, scale=2.0).to(dtype)
            flat_c = _randn(torch, rows * ch + 1, seed=rows + 1).to(dtype)
            gates = flat_g[offset:offset + rows * 4 * ch].view(rows, 4 * ch)
            c = flat_c[offset:offset + rows * ch].view(rows, ch)
            if layout == "columns":
                gates = torch.cat([gates, gates[:, :8]], dim=1)[:, :4 * ch]
            vector = offset == 0 and ch % G.VECTOR_WIDTH[dtype] == 0
            if G.vector_path(gates.contiguous(), c) != vector:
                fail(f"K3's rule at ({rows}, {4 * ch}) {dtype}, {layout or 'aligned'}: "
                     f"vector_path {not vector}, expected {vector}")
            before = counts()
            got, want = fn(gates, c), G.fused_lstm_gates_ref(gates, c)
            torch.cuda.synchronize()
            if counts() != (before[0] + 1, before[1] + vector, before[2] + (not vector)):
                fail(f"K3 ({rows}, {4 * ch}) {dtype}: counts {before} -> {counts()}")
            what = f"({rows}, {4 * ch}){K3_LAYOUTS[layout]}"
            err = max(_max_err(torch, g_, w_, tol, f"K3 {name} {str(dtype)[6:]} {what}")
                      for name, g_, w_ in zip(("h", "c"), got, want))
            if dtype == torch.bfloat16 and rows == MN_ROWS:
                worst = err
            print(f"K3 vs plain: {str(dtype)[6:]} gates {what}, the "
                  f"{'vector' if vector else 'per-element'} kernel: max|diff| {err:.3g} "
                  f"tol {tol} ok [{card}]", flush=True)
    gates, c = _randn(torch, 4096, 4 * MN_HIDDEN, seed=5, scale=2.0), _randn(torch, 4096, MN_HIDDEN, seed=6)
    dh, dc = _randn(torch, 4096, MN_HIDDEN, seed=7), _randn(torch, 4096, MN_HIDDEN, seed=8)

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (gates, c)]
        h, c_next = fn(*ts)
        ((h * dh).sum() + (c_next * dc).sum()).backward()
        return [t.grad for t in ts], h

    (got, h) = grads(G.fused_lstm_gates)
    if type(h.grad_fn).__name__ != "FusedLSTMGatesBackward":
        fail(f"the gate tail under autograd is {h.grad_fn}, not FusedLSTMGates")
    want, _ = grads(G.fused_lstm_gates_ref)
    errs = [_max_err(torch, g_, w_, TOL_K34_F32, f"FusedLSTMGates {n}")
            for n, g_, w_ in zip(("dgates", "dc"), got, want)]
    print(f"FusedLSTMGates gradients (K3 forward) vs plain autograd, float32 (4096, 256): "
          f"max|diff| dgates {errs[0]:.3g}, dc {errs[1]:.3g} tol {TOL_K34_F32} ok [{card}]",
          flush=True)
    return worst


def check_attention(torch, card) -> float:
    """Phase 9b: K4 vs its plain version at every listed shape and
    AxialAttention's gradients; returns the largest bf16 |K4 - plain| at
    MetNet's shape."""
    from satflow_tpu_torch.ops.axial_attention import (
        axial_attention,
        axial_attention_ref,
        regime,
    )

    worst = 0.0
    seen = set()
    for shape in K4_SHAPES + K4_EDGES:
        for dtype, tol in ((torch.float32, TOL_K34_F32), (torch.bfloat16, TOL_K34_BF16)):
            q, k, v = (_randn(torch, *shape, seed=shape[1] + i).to(dtype) for i in range(3))
            before = axial_attention.launches
            got = axial_attention(q, k, v)
            torch.cuda.synchronize()
            if axial_attention.launches != before + 1:
                fail(f"K4 did not launch at {shape}")
            err = _max_err(torch, got, axial_attention_ref(q, k, v), tol,
                           f"K4 {str(dtype)[6:]} {shape}")
            if dtype == torch.bfloat16 and shape == K4_SHAPES[0]:
                worst = err
            which = regime(shape[1], shape[2], dtype)
            seen.add(which)
            print(f"K4 vs plain: {str(dtype)[6:]} (N, L, d) {shape}, the {which} kernel: "
                  f"max|diff| {err:.3g} tol {tol} ok [{card}]", flush=True)
    if seen != {"rows", "mma", "tile"}:
        fail(f"the K4 shapes reached only the kernels {sorted(seen)}")
    q, k, v, g = (_randn(torch, *K4_SHAPES[0], seed=40 + i) for i in range(4))

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ts)
        (out * g).sum().backward()
        return [t.grad for t in ts], out

    got, out = grads(axial_attention)
    if type(out.grad_fn).__name__ != "AxialAttentionBackward":
        fail(f"the attention under autograd is {out.grad_fn}, not AxialAttention")
    want, _ = grads(axial_attention_ref)
    errs = [_max_err(torch, g_, w_, TOL_K34_F32, f"AxialAttention d{n}")
            for n, g_, w_ in zip("qkv", got, want)]
    print(f"AxialAttention gradients (K4 forward) vs plain autograd, float32 {K4_SHAPES[0]}: "
          "max|diff| " + ", ".join(f"d{n} {e:.3g}" for n, e in zip("qkv", errs))
          + f" tol {TOL_K34_F32} ok [{card}]", flush=True)
    return worst


def metnet_flax_variables(in_channels: int, seed: int = 0) -> dict:
    """Random weights in the JAX LitMetNet's flax tree, as flax initialises
    them: lecun-normal kernels, zero biases, unit scales, pos_emb normal(0.02),
    running statistics (0, 1)."""
    rng = np.random.default_rng(seed)
    h, heads = MN_HIDDEN, MN_HEADS

    def conv(k, cin, cout):
        return {"kernel": lecun_normal(rng, (k, k, cin, cout)), "bias": np.zeros(cout, np.float32)}

    def norm(c):
        return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}

    def dense_general(cout_shape, fan_in, shape):
        kernel = lecun_normal(rng, (fan_in, int(np.prod(shape)) // fan_in)).reshape(shape)
        return {"kernel": kernel, "bias": np.zeros(cout_shape, np.float32)}

    def attn():
        qkv = {n: dense_general((heads, h // heads), h, (h, heads, h // heads)) for n in "qkv"}
        return {"pos_emb": (rng.standard_normal((MN_EH, h)) * 0.02).astype(np.float32), **qkv,
                "out": dense_general((h,), h, (heads, h // heads, h))}

    params = {
        "image_encoder": {"c0": conv(3, in_channels, 160), "bn0": norm(160),
                          "c1": conv(3, 160, 256), "c2": conv(3, 256, 256), "bn1": norm(256),
                          "c3": conv(3, 256, 256)},
        "temporal_encoder": {"cell": {"gates": conv(3, 256 + h, 4 * h)}},
        "axial0": {"ln0": norm(h), "attn0": attn(), "ln1": norm(h), "attn1": attn(),
                   "ln_mlp": norm(h), "mlp_in": conv(1, h, 2 * h), "mlp_out": conv(1, 2 * h, h)},
        "head": conv(1, h, MN_COUT),
    }
    for name in ("mlp_in", "mlp_out"):  # Dense kernels are (in, out)
        params["axial0"][name]["kernel"] = params["axial0"][name]["kernel"][0, 0]
    stats = {"image_encoder": {f"bn{i}": {"mean": np.zeros(c, np.float32),
                                          "var": np.ones(c, np.float32)}
                               for i, c in ((0, 160), (1, 256))}}
    return {"params": params, "batch_stats": stats}


def _metnet(torch, loss: str = "mse", **kw):
    """metnet.yaml (``loss="ssim"``: metnet_ssim.yaml, which differs in the
    loss alone)."""
    from satflow_tpu_torch.models import create_model

    return create_model("litmetnet", image_encoder="downsampler", input_channels=MN_CIN,
                        sat_channels=12, input_size=64, output_channels=MN_COUT,
                        hidden_dim=MN_HIDDEN, kernel_size=3, num_layers=1, num_att_layers=1,
                        forecast_steps=MN_F, temporal_dropout=0.2, lr=1e-3, loss=loss, **kw)


def reset_k3_paths(fn) -> None:
    """Set the counts of K3's two kernels to 0, just before a path runs."""
    fn.vector_launches = fn.element_launches = 0


def check_k3_paths(fn, launches: int, what: str) -> None:
    """Every one of a path's ``launches`` K3 launches, counted since
    :func:`reset_k3_paths`, ran the vector kernel: the path's tensors are
    aligned and C = 64, so ``vector_path`` names it."""
    if (fn.vector_launches, fn.element_launches) != (launches, 0):
        fail(f"{what}: K3 launched its vector kernel {fn.vector_launches} and its per-element "
             f"kernel {fn.element_launches} times, expected {launches} and 0")


def metnet_serve_slice(torch, card):
    """Phase 10; returns (K3 launches, K4 launches, model)."""
    from satflow_tpu_torch.ops.axial_attention import axial_attention, axial_attention_ref
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates, fused_lstm_gates_ref
    from satflow_tpu_torch.serve import InferenceSession

    model = _metnet(torch)
    session = InferenceSession(model, max_batch=B, variables=metnet_flax_variables(4 * MN_CIN + MN_F),
                               dtype=torch.bfloat16, device=DEVICE)
    rng = np.random.default_rng(3)
    requests = [rng.random((T, H, W, MN_CIN), dtype=np.float32) for _ in range(4)]
    requests.append(rng.random((2, T, H, W, MN_CIN), dtype=np.float32))
    reset_k3_paths(fused_lstm_gates)
    replies, wall, forwards, (k3, k4) = drive_server(session, requests,
                                                     [fused_lstm_gates, axial_attention])
    check_k3_paths(fused_lstm_gates, k3, "MetNet serving")
    for x, (status, y) in zip(requests, replies):
        if status != 200:
            fail(f"MetNet request of shape {x.shape} answered {status}: {y!r}"[:500])
        want = (MN_F, MN_EH, MN_EH, MN_COUT)
        want = want if x.ndim == 4 else (x.shape[0],) + want
        if y.shape != want:
            fail(f"MetNet reply shape {y.shape}, expected {want}")
        if not np.isfinite(y).all():
            fail("MetNet reply not finite")
    if forwards < 1 or (k3, k4) != (MN_K3_PER_FORWARD * forwards, MN_K4_PER_FORWARD * forwards):
        fail(f"MetNet launches K3 {k3}, K4 {k4} != ({MN_K3_PER_FORWARD}, {MN_K4_PER_FORWARD}) "
             f"x {forwards} forwards")
    print(f"MetNet served {len(requests)} requests (6 samples) in {forwards} forward(s) of b{B}, "
          f"{wall:.3f} s wall; launches K3 {k3} = {MN_K3_PER_FORWARD} x {forwards} (all on its "
          f"vector kernel), K4 {k4} = "
          f"{MN_K4_PER_FORWARD} x {forwards} [{card}]", flush=True)

    with torch.inference_mode():
        x0 = torch.from_numpy(requests[0][None]).to(DEVICE, torch.bfloat16)
        ref = model(x0, gate_tail=fused_lstm_gates_ref,
                    attention=axial_attention_ref).float().cpu().numpy()[0]
    diff = float(np.abs(ref - replies[0][1]).max())
    scale = float(np.abs(ref).max())
    if not diff <= TOL_MN_REPLY * scale:
        fail(f"MetNet reply vs plain-version forward: max|diff| {diff:.3g} > "
             f"{TOL_MN_REPLY} x max|plain| {scale:.3g}")
    print(f"MetNet reply vs the plain versions' forward (bf16): max|diff| {diff:.3g} <= "
          f"{TOL_MN_REPLY} x max|plain| {scale:.3g} ok [{card}]", flush=True)
    return k3, k4, model


def device_time_by_class(torch, fn, classes):
    """Run ``fn()`` once under torch.profiler; returns (wall ms, {class: device
    ms}, busy ms, the 6 largest kernels of "other" as (name, ms), the
    profile), a kernel going to the first class one of whose name fragments
    it contains, else to "other"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {name: 0.0 for name in classes}
    out["other"] = 0.0
    others = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:  # a CPU op's row repeats its kernels' time
            continue
        key = evt.key.lower()
        name = next((n for n, frags in classes.items() if any(f in key for f in frags)), "other")
        ms = evt.self_device_time_total / 1e3
        out[name] += ms
        if name == "other":
            others.append((evt.key[:70], ms))
    return wall_ms, out, sum(out.values()), sorted(others, key=lambda e: -e[1])[:6], prof


# kernel classes of a profile, by name fragments (the first match wins)
LIBRARY_CONVS = ("conv", "cudnn", "xmma", "dgrad", "wgrad", "cutlass", "implicit", "sm90_")
OPTIMIZER = ("adam", "multi_tensor")
CONVLSTM_CLASSES = {"K1": ("fused_convlstm_step_kernel",), "K2": ("gate_bwd_kernel",),
                    "library convs": LIBRARY_CONVS, "optimizer": OPTIMIZER}
K4_KERNELS = ("axial_attention_rows_kernel", "axial_attention_mma_kernel",
              "axial_attention_tile_kernel")
K3_KERNELS = ("fused_lstm_gates_kernel", "fused_lstm_gates_vec_kernel")
MN_CLASSES = {"K3": K3_KERNELS, "K4": K4_KERNELS,
              "library convs": LIBRARY_CONVS, "optimizer": OPTIMIZER}


def print_profile(what, result, card, extra: str = "") -> None:
    """Print a :func:`device_time_by_class` result."""
    wall_ms, classes, busy, others, _ = result
    if busy <= 0:
        print(f"{what} profile: the profiler saw no device time; not measured [{card}]", flush=True)
        return
    print(f"{what} profile: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle "
          f"{100 * (1 - busy / wall_ms):.1f} %; "
          + ", ".join(f"{k} {v:.2f} ms ({100 * v / busy:.1f} %)" for k, v in classes.items())
          + "; largest of other: " + "; ".join(f"{n} {ms:.2f} ms" for n, ms in others)
          + f"{extra} [{card}]", flush=True)


def metnet_timings(torch, model, card):
    """Phase 11: K3 (both dtypes, MetNet's and the concat forward's shapes) and
    K4 per call against their plain versions at the path's shapes, the b8
    forward both ways, one forward profiled. Returns (K3 ms {"kernel",
    "plain", "library", "bound"} at MetNet's bf16 shape, {K4 shape: ms})."""
    from satflow_tpu_torch.ops import fused_lstm as G
    from satflow_tpu_torch.ops.axial_attention import attention_kernel, axial_attention_ref
    from satflow_tpu_torch.tools.time_redesign import K3_CALLS, k3_times

    for dtype in (torch.bfloat16, torch.float32):
        for rows in (MN_ROWS, B * H * W):
            gates = _randn(torch, rows, 4 * MN_HIDDEN, seed=50, scale=2.0).to(dtype)
            c = _randn(torch, rows, MN_HIDDEN, seed=51).to(dtype)
            # the library call: ATen's fused LSTM cell, its gate columns permuted
            # once outside the timing, its second gate input zero (it also
            # writes a (N, 4C) workspace), held to K3's plain version first
            aten = torch.ops.aten._thnn_fused_lstm_cell(
                G.to_aten_order(gates), torch.zeros_like(gates), c)[:2]
            tol = TOL_K34_BF16 if dtype == torch.bfloat16 else TOL_K34_F32
            err = max(_max_err(torch, a, b, tol, "aten._thnn_fused_lstm_cell")
                      for a, b in zip(aten, G.fused_lstm_gates_ref(gates, c)))
            # device time (profiler); back to back: the bare launch, the launch
            # through the op satflow::fused_lstm_gates that the path calls, ATen's
            # cell and the plain version, in turns (microseconds)
            t = k3_times(torch, G, gates, c, K3_CALLS, 5)
            # ~30 f32 operations per state element: three sigmoids, two tanh, the sums
            bound = bound_ms((gates, c, c, c), 30 * c.numel(), "f32")
            print(f"time per K3 call, {str(dtype)[6:]} ({rows}, {4 * MN_HIDDEN}): device "
                  f"{t['device']:.2f} us (profiler; {100 * bound[0] * 1e3 / t['device']:.1f} % of "
                  f"the {bound[0] * 1e3:.2f} us bound by {bound[1]}); {K3_CALLS} calls back to "
                  f"back, the median of 10 windows (the least, and the host's loop's median, in "
                  f"brackets): bare launch {t['kernel']:.2f} us ({t['kernel_min']:.2f}; "
                  f"{t['kernel_host']:.2f}), through the op {t['op']:.2f} us ({t['op_min']:.2f}; "
                  f"{t['op_host']:.2f}), aten._thnn_fused_lstm_cell {t['library']:.2f} us "
                  f"({t['library_min']:.2f}; {t['library_host']:.2f}; device "
                  f"{t['library_device']:.2f}; max|diff| vs plain {err:.3g}), plain "
                  f"{t['plain']:.2f} us; by the medians K3 through the op "
                  f"{'is no slower than' if t['op'] <= t['library'] else 'is SLOWER than'} "
                  f"ATen's cell [{card}]", flush=True)
            if dtype == torch.bfloat16 and rows == MN_ROWS:
                # the kernels line: per call as every kernel is timed, ATen's
                # cell on gates permuted once outside the timing
                aten_gates, zeros = G.to_aten_order(gates), torch.zeros_like(gates)
                k3 = per_call_ms(torch, G._launch, G.fused_lstm_gates_ref, (gates, c),
                                 library=lambda _, c_: torch.ops.aten._thnn_fused_lstm_cell(
                                     aten_gates, zeros, c_)[:2])
                k3["bound"] = bound
                print(f"time per K3 call, bf16 ({rows}, {4 * MN_HIDDEN}), the mean of four "
                      f"20-call windows: kernel {k3['kernel'] * 1e3:.2f} us, plain "
                      f"{k3['plain'] * 1e3:.2f} us, aten._thnn_fused_lstm_cell "
                      f"{k3['library'] * 1e3:.2f} us [{card}]", flush=True)
                del aten_gates, zeros
            del gates, c, aten

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(q[:, None], k[:, None],
                                                                v[:, None])[:, 0]

    k4 = {}
    for shape in K4_SHAPES:
        q, k, v = (_randn(torch, *shape, seed=60 + i).to(torch.bfloat16) for i in range(3))
        k4[shape] = per_call_ms(torch, attention_kernel, axial_attention_ref, (q, k, v),
                                library=sdpa)
        n, length, d = shape
        flop = 4 * n * length * length * d
        k4[shape]["bound"] = bound_ms((q, k, v, q), flop, "bf16")
        print(f"time per K4 call, bf16 (N, L, d) {shape}: kernel {k4[shape]['kernel'] * 1e3:.2f} us "
              f"({flop / k4[shape]['kernel'] / 1e9:.1f} TFLOP/s), plain "
              f"{k4[shape]['plain'] * 1e3:.2f} us ({flop / k4[shape]['plain'] / 1e9:.1f} TFLOP/s), "
              f"library (scaled_dot_product_attention on (N, 1, L, d)) "
              f"{k4[shape]['library'] * 1e3:.2f} us; bound {k4[shape]['bound'][0] * 1e3:.2f} us by "
              f"{k4[shape]['bound'][1]} [{card}]", flush=True)

    x = torch.from_numpy(np.random.default_rng(4).random((B, T, H, W, MN_CIN), dtype=np.float32))
    x = x.to(DEVICE, torch.bfloat16)
    plain = dict(gate_tail=G.fused_lstm_gates_ref, attention=axial_attention_ref)
    runs = {"plain": [], "kernel": []}
    with torch.inference_mode():
        for kw in ({}, plain):
            model(x, **kw)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        for name in ("kernel", "plain", "plain", "kernel"):
            kw = plain if name == "plain" else {}
            runs[name].append(cuda_ms(torch, lambda: model(x, **kw), 3))
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        for name, r in runs.items():
            ms = sum(r) / len(r)
            print(f"MetNet b{B} forward ({T} x {H}x{W}x{MN_CIN} in, {MN_F} lead times, bf16) "
                  f"through the {name} versions: {ms:.2f} ms, {B * MN_F / (ms / 1e3):.1f} "
                  f"forecast frames/s (runs {', '.join(f'{v:.2f}' for v in r)} ms); peak device "
                  f"memory {peak_gib:.2f} GiB [{card}]", flush=True)
        print_profile(f"MetNet b{B} forward",
                      device_time_by_class(torch, lambda: model(x), MN_CLASSES), card)
    return k3, k4


def compare_metnet_grads(torch, model, batch, gen, what: str, card, zero_tol: float = 1e-3):
    """Every MetNet parameter's gradient of one train-mode loss through K3 and
    K4 against the same loss through their plain versions (the same
    temporal-dropout mask both ways): within TOL_TRAIN_GRAD x max|grad| and
    cosine MIN_TRAIN_GRAD_COS; the ones zero in exact arithmetic within
    ``zero_tol`` x max|grad| of their layer's weight, both ways. Returns
    (worst relative difference, worst cosine)."""
    from satflow_tpu_torch.ops.axial_attention import axial_attention_ref
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates_ref

    def step_grads(**kw):
        model.train()
        model.zero_grad(set_to_none=True)
        gen.manual_seed(1)  # the same temporal-dropout mask both ways
        loss, _ = model.loss(batch, **kw)
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in model.module.named_parameters()}
        model.zero_grad(set_to_none=True)
        return grads

    got = step_grads()
    want = step_grads(gate_tail=fused_lstm_gates_ref, attention=axial_attention_ref)
    worst, worst_cos = 0.0, 1.0
    for name, g in got.items():
        w = want[name]
        if g is None or not bool(torch.isfinite(g).all()):
            fail(f"{what}: parameter {name} has no finite gradient through the kernels")
        if name in MN_ZERO_GRAD:
            scale = want[name.replace(".bias", ".weight")].abs().max().item()
            if not (g.abs().max().item() <= zero_tol * scale
                    and w.abs().max().item() <= zero_tol * scale):
                fail(f"{what} {name}: gradient not negligible against its layer's weight's: "
                     f"max|grad| {g.abs().max().item():.3g} through the kernels, "
                     f"{w.abs().max().item():.3g} plain, the weight's {scale:.3g}")
            continue
        if not g.abs().sum().item() > 0:
            fail(f"{what}: parameter {name} has a zero gradient through the kernels")
        rel = (g - w).abs().max().item() / w.abs().max().item()
        cos = torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0).item()
        worst, worst_cos = max(worst, rel), min(worst_cos, cos)
        if not (rel <= TOL_TRAIN_GRAD and cos >= MIN_TRAIN_GRAD_COS):
            fail(f"{what}: gradient of {name} through K3+K4 vs plain: max|diff| / max|grad| "
                 f"{rel:.3g} (tol {TOL_TRAIN_GRAD}), cosine {cos:.6f} (min {MIN_TRAIN_GRAD_COS})")
    print(f"{what}'s gradients through K3+K4 vs the plain versions (bf16): "
          f"{len(got) - len(MN_ZERO_GRAD)} parameters nonzero (and {len(MN_ZERO_GRAD)} zero in "
          f"exact arithmetic, negligible both ways); max|diff| / max|grad| {worst:.3g} <= "
          f"{TOL_TRAIN_GRAD}, cosine >= {worst_cos:.6f} ok [{card}]", flush=True)
    return worst, worst_cos


def metnet_train_slice(torch, card):
    """Phase 12; returns (K3 launches, K4 launches)."""
    from satflow_tpu_torch.data import SatFlowDataModule
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.ops.axial_attention import axial_attention, axial_attention_ref
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates, fused_lstm_gates_ref
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.steps import make_train_step

    gen = torch.Generator()
    model = _metnet(torch, generator=gen, warmup_steps=1000, total_steps=100_000)
    model.module.load_state_dict(model.state_dict_from_flax(
        metnet_flax_variables(4 * MN_TRAIN_CIN + MN_F, seed=1)))
    dm = SatFlowDataModule(fake_data=True, num_workers=0, n_train_data=TRAIN_STEPS, n_val_data=1,
                           history_minutes=5 * (T - 1), forecast_minutes=5 * MN_F,
                           fake_kwargs=dict(batch_size=B, width=W, height=H))
    counter = LaunchesPerStep(fused_lstm_gates, axial_attention)
    trainer = Trainer(max_steps=TRAIN_STEPS, precision="bf16", log_every_n_steps=1,
                      device=DEVICE, callbacks=[counter])
    gen.manual_seed(0)
    fused_lstm_gates.launches = axial_attention.launches = 0
    t0 = time.perf_counter()
    trainer.fit(model, dm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3, k4 = fused_lstm_gates.launches, axial_attention.launches
    losses = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
    lrs = [model.lr_schedule(i) for i in range(TRAIN_STEPS)]
    val_loss = trainer.callback_metrics.get("val/loss", float("nan"))
    if trainer.global_step != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        fail(f"MetNet fit took {trainer.global_step} steps and logged {len(losses)} losses")
    if not all(np.isfinite(losses + [val_loss])):
        fail(f"MetNet non-finite losses: train {losses}, val {val_loss}")
    want_step = (MN_K3_PER_FORWARD, MN_K4_PER_FORWARD)  # forward kernels; plain backward chains
    if counter.per_step != [want_step] * TRAIN_STEPS:
        fail(f"MetNet (K3, K4) launches per train step {counter.per_step}, expected {want_step}")
    if (k3, k4) != ((TRAIN_STEPS + 1) * MN_K3_PER_FORWARD, (TRAIN_STEPS + 1) * MN_K4_PER_FORWARD):
        fail(f"MetNet fit launched K3 {k3} and K4 {k4} times")
    if model.dtype != torch.bfloat16 or not model.module.image_encoder.bn0.mean.abs().sum() > 0:
        fail("MetNet did not train in bf16 with moving BatchNorm statistics")
    print(f"MetNet trained {TRAIN_STEPS} steps (bf16, b{B} {H}x{W}x{MN_TRAIN_CIN}, {T} in / {MN_F} "
          f"lead times) in {wall:.2f} s wall with data generation: losses "
          + ", ".join(f"{v:.6f}" for v in losses) + f", val {val_loss:.6f}; Adam learning rates "
          + ", ".join(f"{v:.3g}" for v in lrs) + f" (warmup_cosine); launches per step K3 "
          f"{want_step[0]}, K4 {want_step[1]}; fit total K3 {k3}, K4 {k4} (with one validation "
          f"forward) [{card}]", flush=True)

    batch = to_device(next(iter(dm.train_dataloader())), torch.device(DEVICE))
    plain = dict(gate_tail=fused_lstm_gates_ref, attention=axial_attention_ref)
    compare_metnet_grads(torch, model, batch, gen, "MetNet train step", card)

    state = trainer.state
    steps = {"kernel": make_train_step(model), "plain": make_train_step(model, **plain)}
    runs, peaks = timed_train_steps(torch, steps, state, batch)
    for name in ("kernel", "plain"):
        ms = sum(runs[name]) / len(runs[name])
        print(f"MetNet b{B} train step (bf16, {T} in / {MN_F} lead times, {H}x{W}x{MN_TRAIN_CIN}, "
              f"Adam) through the {name} versions: {ms:.2f} ms, {B * MN_F / (ms / 1e3):.1f} "
              f"frames/s (runs {', '.join(f'{r:.2f}' for r in runs[name])} ms); peak device "
              f"memory {peaks[name]:.2f} GiB [{card}]", flush=True)
    print_profile(f"MetNet b{B} train step",
                  device_time_by_class(torch, lambda: steps["kernel"](state, batch), MN_CLASSES),
                  card)
    return k3, k4


def int8_inputs(torch, cx: int, c_dtype, seed: int, ch: int = HIDDEN):
    """(xq, hq, c, w3q, dequant, b, w_packed) at the serving shape."""
    from satflow_tpu_torch.ops.fused_convlstm_int8 import (
        pack_weights,
        quantize_activations,
        quantize_weights,
    )

    x, h, c, wx, wh, b = step_inputs(torch, cx, torch.float32, seed, ch=ch)
    w3q, dequant, bias = quantize_weights(wx, wh, b)
    return (quantize_activations(x), quantize_activations(h), c.to(c_dtype), w3q, dequant,
            bias, pack_weights(w3q, cx))


def check_int8_kernel(torch, card) -> float:
    """Phase 13a: K5 vs its plain version; returns the largest |diff| of the
    bf16 run in state units (c', and h'q / 127)."""
    from satflow_tpu_torch.ops.fused_convlstm_int8 import (
        fused_convlstm_step_int8,
        fused_convlstm_step_int8_ref,
        int8_accumulate,
        int8_gate_sums,
    )

    worst = 0.0
    for cx in (CIN, HIDDEN):
        for c_dtype in (torch.bfloat16, torch.float32):
            name = str(c_dtype)[6:]
            args = int8_inputs(torch, cx, c_dtype, seed=400 + cx)
            before = fused_convlstm_step_int8.launches
            hq_k, c_k = fused_convlstm_step_int8(*args)
            torch.cuda.synchronize()
            if fused_convlstm_step_int8.launches != before + 1:
                fail(f"K5 did not launch at Cx={cx}")
            hq_p, c_p = fused_convlstm_step_int8_ref(*args)
            if c_dtype == torch.bfloat16:
                # the plain version's integer sums on the card (a float64 conv)
                # against an int32 conv on the CPU, on a corner of the image
                # against int64 window products on the host, on a corner of the image
                n = 24
                xq, hq, w3q = args[0][:1, :n, :n], args[1][:1, :n, :n], args[3]
                acc = int8_accumulate(xq, hq, w3q).cpu().numpy()
                xp, hp = (np.pad(a.cpu().numpy().astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
                          for a in (xq, hq))
                w3 = w3q.cpu().numpy().astype(np.int64)
                want = np.zeros(acc.shape, np.int64)
                for dy in range(3):
                    win = np.concatenate([a[:, dy:dy + n, dx:dx + n] for a in (xp, hp)
                                          for dx in range(3)], axis=-1)
                    want += win @ w3[dy]
                if not np.array_equal(acc, want):
                    fail(f"the plain int8 step's integer sums are not exact at Cx={cx}")
                # K5's own sums (its sums entry point: the same tensor-core
                # contraction) against the exact ones, every one of them
                before = int8_gate_sums.launches
                sums = int8_gate_sums(args[0], args[1], args[3], args[6])
                exact = int8_accumulate(args[0], args[1], args[3])
                if int8_gate_sums.launches != before + 1:
                    fail(f"K5's sums entry point did not launch at Cx={cx}")
                wrong = int((sums != exact).sum().item())
                if wrong:
                    fail(f"K5's integer sums differ from the exact ones at Cx={cx}: {wrong} of "
                         f"{sums.numel()}")
                print(f"K5's integer sums (tensor cores, IMMA) at B={B} {H}x{W} Cx={cx} Ch={HIDDEN}: "
                      f"all {sums.numel()} equal to the exact ones [{card}]", flush=True)
            flips, errs = {}, {}
            for region, idx in REGIONS.items():
                diff = (hq_k[idx].int() - hq_p[idx].int()).abs()
                flips[region] = diff.float().mean().item()
                if diff.max().item() > 1 or flips[region] > INT8_MAX_FLIP_SHARE:
                    fail(f"K5 != plain: c {name} Cx={cx} h'q {region}: max|diff| "
                         f"{diff.max().item()}, share differing {flips[region]:.3g}")
                errs[region] = _max_err(torch, c_k[idx], c_p[idx], TOL_INT8_C[name],
                                        f"K5 c' {name} Cx={cx} {region}")
            flipped = int((hq_k != hq_p).sum().item())
            if c_dtype == torch.bfloat16:
                worst = max(worst, errs["all"], (1 if flipped else 0) / 127)
            print(f"K5 vs plain: c {name} B={B} {H}x{W} Cx={cx} Ch={HIDDEN}: integer sums exact; "
                  f"h'q max|diff| {1 if flipped else 0} step on {flipped} of {hq_k.numel()} "
                  f"elements (share {flips['all']:.2g} <= {INT8_MAX_FLIP_SHARE}; edges: "
                  + ", ".join(f"{k} {v:.2g}" for k, v in flips.items() if k != "all")
                  + f"); c' max|diff| {errs['all']:.3g} (edges: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items() if k != "all")
                  + f") tol {TOL_INT8_C[name]} ok [{card}]", flush=True)
    return worst


def cmajor_inputs(torch, dtype, seed: int):
    """K6a's (x, h, c, wx, wh, b) and K6b's (w, b) at the decoder's shape."""
    from satflow_tpu_torch.ops.cmajor_convlstm import to_cmajor

    x, h, c, wx, wh, b = step_inputs(torch, HIDDEN, dtype, seed)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    head_w = (torch.randn(3, 3, HIDDEN, COUT, generator=g, device=DEVICE)
              * (9 * HIDDEN) ** -0.5).to(dtype)
    head_b = (torch.randn(COUT, generator=g, device=DEVICE) * 0.1).to(dtype)
    return (to_cmajor(x), to_cmajor(h), to_cmajor(c), wx, wh, b), (head_w, head_b)


def check_cmajor_kernels(torch, card):
    """Phase 13b: K6a and K6b vs their plain versions; returns their largest
    bf16 |kernel - plain|."""
    from satflow_tpu_torch.ops.cmajor_convlstm import (
        cmajor_conv3x3,
        cmajor_conv3x3_ref,
        cmajor_convlstm_step,
        cmajor_convlstm_step_ref,
        from_cmajor,
    )

    worst = {"K6a": 0.0, "K6b": 0.0}
    for dtype, tol, head_tol in ((torch.float32, TOL_F32, TOL_F32),
                                 (torch.bfloat16, TOL_BF16, TOL_HEAD_BF16)):
        cell, head = cmajor_inputs(torch, dtype, seed=500)
        before = cmajor_convlstm_step.launches, cmajor_conv3x3.launches
        got = cmajor_convlstm_step(*cell, H, W) + (cmajor_conv3x3(cell[1], *head, H, W),)
        torch.cuda.synchronize()
        if (cmajor_convlstm_step.launches, cmajor_conv3x3.launches) != (before[0] + 1,
                                                                        before[1] + 1):
            fail("K6a or K6b did not launch")
        want = cmajor_convlstm_step_ref(*cell, H, W) + (cmajor_conv3x3_ref(cell[1], *head, H, W),)
        for kernel, outs, t in (("K6a", (("h", 0), ("c", 1)), tol), ("K6b", (("out", 2),), head_tol)):
            errs = {}
            for out_name, i in outs:
                g_, w_ = from_cmajor(got[i], H, W), from_cmajor(want[i], H, W)
                for region, idx in REGIONS.items():
                    errs[f"{out_name}.{region}"] = _max_err(
                        torch, g_[idx], w_[idx], t, f"{kernel} {str(dtype)[6:]} {out_name} {region}")
            if dtype == torch.bfloat16:
                worst[kernel] = max(errs.values())
            cin = f"Cx={HIDDEN} Ch={HIDDEN}" if kernel == "K6a" else f"{HIDDEN} -> {COUT} channels"
            print(f"{kernel} vs plain: {str(dtype)[6:]} B={B} {H}x{W} {cin}: max|diff| "
                  f"{max(errs.values()):.3g} (edges: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items() if "all" not in k)
                  + f") tol {t} ok [{card}]", flush=True)
    for bsz, hgt, wdt, cin, cout in K6B_EDGES:
        for dtype, head_tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_HEAD_BF16)):
            x = _randn(torch, bsz, cin, hgt * wdt, seed=510 + cin).to(dtype)
            w = _randn(torch, 3, 3, cin, cout, seed=511 + cin, scale=(9 * cin) ** -0.5).to(dtype)
            b = _randn(torch, cout, seed=512 + cin, scale=0.1).to(dtype)
            before = cmajor_conv3x3.launches
            got = cmajor_conv3x3(x, w, b, hgt, wdt)
            torch.cuda.synchronize()
            if cmajor_conv3x3.launches != before + 1:
                fail(f"K6b did not launch at B={bsz} {hgt}x{wdt} {cin} -> {cout}")
            what = f"K6b {str(dtype)[6:]} B={bsz} {hgt}x{wdt} {cin} -> {cout}"
            g_ = from_cmajor(got, hgt, wdt)
            w_ = from_cmajor(cmajor_conv3x3_ref(x, w, b, hgt, wdt), hgt, wdt)
            err = max(_max_err(torch, g_[idx], w_[idx], head_tol, f"{what} {region}")
                      for region, idx in REGIONS.items())
            print(f"K6b vs plain: {what[4:]}: max|diff| {err:.3g} (edges held on their own) tol "
                  f"{head_tol} ok [{card}]", flush=True)
    return worst["K6a"], worst["K6b"]


def int8_serve_slice(torch, card):
    """Phase 14; returns (K5 launches, the int8 session's quantized params)."""
    from satflow_tpu_torch.interop.jax_weights import params_from_flax
    from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM
    from satflow_tpu_torch.ops.fused_convlstm_int8 import (
        fused_convlstm_step_int8,
        fused_convlstm_step_int8_ref,
        int8_rollout,
    )
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step
    from satflow_tpu_torch.serve import InferenceSession

    model = EncoderDecoderConvLSTM(hidden_dim=HIDDEN, input_channels=CIN,
                                   out_channels=COUT, forecast_steps=STEPS)
    session = InferenceSession(model, max_batch=B, state_dict=params_from_flax(flax_params(0)),
                               quantize="int8", device=DEVICE)
    requests = convlstm_requests()
    bad = requests[0] * 3.0  # standardized-radiance-like range: |x|max ~ 3
    replies, wall, forwards, (k5, k1) = drive_server(
        session, requests + [bad], [fused_convlstm_step_int8, fused_convlstm_step])
    check_frames(requests, replies[:-1], "int8 serving")
    status, body = replies[-1]
    if status != 400 or b"int8" not in body:
        fail(f"the out-of-range int8 request answered {status}: {body!r}"[:500])
    if forwards < 1 or (k5, k1) != (INT8_LAUNCHES_PER_FORWARD * forwards, 0):
        fail(f"int8 serving launched K5 {k5} and K1 {k1} times in {forwards} forwards, expected "
             f"{INT8_LAUNCHES_PER_FORWARD} x {forwards} and 0")
    print(f"int8 served {len(requests)} requests (6 samples) in {forwards} forward(s) of b{B}, "
          f"{wall:.3f} s wall, and answered an out-of-range request 400 alone; launches K5 {k5} = "
          f"{INT8_LAUNCHES_PER_FORWARD} x {forwards}, K1 {k1} [{card}]", flush=True)

    with torch.inference_mode():
        x0 = torch.from_numpy(requests[0][None]).to(DEVICE)
        model.set_compute_dtype(torch.bfloat16)
        bf16 = model(x0.to(torch.bfloat16)).float().cpu().numpy()[0]
        plain = int8_rollout(session.qparams, x0, STEPS, step=fused_convlstm_step_int8_ref)
        plain = plain.float().cpu().numpy()[0]
    for what, ref in (("the bf16 rollout through K1", bf16),
                      ("the int8 rollout through K5's plain version", plain)):
        diff = float(np.abs(ref - replies[0][1]).max())
        if not diff <= TOL_INT8_REPLY:
            fail(f"int8 reply vs {what}: max|diff| {diff:.3g} > {TOL_INT8_REPLY}")
        print(f"int8 reply vs {what} ({STEPS} steps): max|diff| {diff:.3g} <= {TOL_INT8_REPLY} "
              f"ok [{card}]", flush=True)
    return k5, session.qparams


def cmajor_serve_slice(torch, card, fused_model):
    """Phase 15; returns ((K1, K6a, K6b) launches, the channel-major model)."""
    from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM
    from satflow_tpu_torch.ops.cmajor_convlstm import cmajor_conv3x3, cmajor_convlstm_step
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step
    from satflow_tpu_torch.serve import InferenceSession

    model = EncoderDecoderConvLSTM(hidden_dim=HIDDEN, input_channels=CIN, out_channels=COUT,
                                   forecast_steps=STEPS, cell_impl="cmajor")
    session = InferenceSession(model, max_batch=B, state_dict=fused_model.module.state_dict(),
                               dtype=torch.bfloat16, device=DEVICE)
    requests = convlstm_requests()
    replies, wall, forwards, launches = drive_server(
        session, requests, [fused_convlstm_step, cmajor_convlstm_step, cmajor_conv3x3])
    check_frames(requests, replies, "channel-major serving")
    if forwards < 1 or launches != tuple(n * forwards for n in CMAJOR_LAUNCHES_PER_FORWARD):
        fail(f"channel-major serving launched (K1, K6a, K6b) {launches} times in {forwards} "
             f"forwards, expected {CMAJOR_LAUNCHES_PER_FORWARD} each")
    print(f"cmajor served {len(requests)} requests (6 samples) in {forwards} forward(s) of b{B}, "
          f"{wall:.3f} s wall; launches (K1, K6a, K6b) {launches} = "
          f"{CMAJOR_LAUNCHES_PER_FORWARD} x {forwards} [{card}]", flush=True)
    with torch.inference_mode():
        x0 = torch.from_numpy(requests[0][None]).to(DEVICE, torch.bfloat16)
        ref = fused_model(x0).float().cpu().numpy()[0]
    diff = float(np.abs(ref - replies[0][1]).max())
    if not diff <= TOL_ROLLOUT:
        fail(f"channel-major reply vs the fused rollout: max|diff| {diff:.3g} > {TOL_ROLLOUT}")
    print(f"cmajor reply vs the fused rollout (bf16, {STEPS} steps): max|diff| {diff:.3g} <= "
          f"{TOL_ROLLOUT} ok [{card}]", flush=True)
    return launches, model


FORWARD_CLASSES = {"K1": ("fused_convlstm_step_kernel",),
                   "K5": ("fused_convlstm_step_int8_kernel",),
                   "K6a": ("cmajor_cell_kernel",),
                   "K6b": ("cmajor_conv_mma_kernel", "cmajor_conv_kernel"),
                   "library convs": LIBRARY_CONVS}


def serving_timings(torch, fused_model, cmajor_model, qparams, card):
    """Phase 16: K5, K6a and K6b per call, the b8 forward through the three
    rollouts in turns, and the int8 and channel-major forwards profiled.
    Returns {kernel: times with "bound"}."""
    from satflow_tpu_torch.ops import cmajor_convlstm as CM
    from satflow_tpu_torch.ops.fused_convlstm_int8 import (
        fused_convlstm_step_int8,
        fused_convlstm_step_int8_ref,
        int8_rollout,
    )

    times = {}
    ops = 2 * B * H * W * 4 * HIDDEN * 9 * (HIDDEN + HIDDEN)  # the gate contraction, Cx=64
    # hidden 64 at the model's two input widths, and hidden 32 (the hparam
    # search's and accuracy_gate's width, a width K5 is built for) at Cx = Ch
    for cx, ch in ((CIN, HIDDEN), (HIDDEN, HIDDEN), (SMALL_HIDDEN, SMALL_HIDDEN)):
        args = int8_inputs(torch, cx, torch.bfloat16, seed=600 + cx, ch=ch)
        t = per_call_ms(torch, fused_convlstm_step_int8, fused_convlstm_step_int8_ref, args, n=5)
        cx_ops = 2 * B * H * W * 4 * ch * 9 * (cx + ch)
        # packed and unpacked weights are one tensor's worth of bytes; h'q, c' out
        t["bound"] = bound_ms(args[:6] + (args[1], args[2]), cx_ops, "int8")
        times[f"K5.{cx}" if ch == HIDDEN else f"K5.{cx}x{ch}"] = t
        print(f"time per K5 (int8 step) call, int8 x/h and bf16 c, B={B} {H}x{W} Cx={cx} "
              f"Ch={ch}: kernel {t['kernel']:.4f} ms ({cx_ops / t['kernel'] / 1e9:.1f} TOP/s, "
              f"{100 * t['bound'][0] / t['kernel']:.1f} % of the bound), plain (float64 conv) "
              f"{t['plain']:.4f} ms; bound {t['bound'][0]:.4f} ms by {t['bound'][1]} [{card}]",
              flush=True)
    cell, head = cmajor_inputs(torch, torch.bfloat16, seed=700)
    t = per_call_ms(torch, lambda *a: CM.cmajor_convlstm_step(*a, H, W),
                    lambda *a: CM.cmajor_convlstm_step_ref(*a, H, W), cell)
    t["bound"] = bound_ms(cell + (cell[1], cell[2]), ops, "bf16")
    times["K6a"] = t
    print(f"time per K6a (channel-major step) call, bf16 B={B} {H}x{W} Cx={HIDDEN} Ch={HIDDEN}: "
          f"kernel {t['kernel']:.4f} ms ({ops / t['kernel'] / 1e9:.1f} TFLOP/s), plain "
          f"{t['plain']:.4f} ms; bound {t['bound'][0]:.4f} ms by {t['bound'][1]} [{card}]",
          flush=True)

    def library_conv(x, w, b):  # one conv2d on views: the same function, same inputs
        return torch.nn.functional.conv2d(x.view(B, HIDDEN, H, W), w.permute(3, 2, 0, 1), b,
                                          padding=1).view(B, COUT, H * W)

    head_args = (cell[1],) + head
    t = per_call_ms(torch, lambda *a: CM.cmajor_conv3x3(*a, H, W),
                    lambda *a: CM.cmajor_conv3x3_ref(*a, H, W), head_args, library=library_conv)
    head_ops = 2 * B * H * W * COUT * 9 * HIDDEN
    out = torch.empty(B, COUT, H * W, dtype=torch.bfloat16, device=DEVICE)
    t["bound"] = bound_ms(head_args + (out,), head_ops, "bf16")
    times["K6b"] = t
    print(f"time per K6b (channel-major 3x3 head) call, bf16 B={B} {H}x{W} {HIDDEN} -> {COUT}: "
          f"kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, library (conv2d on the same "
          f"tensors) {t['library']:.4f} ms; bound {t['bound'][0]:.4f} ms by {t['bound'][1]} "
          f"[{card}]", flush=True)

    x = torch.from_numpy(np.random.default_rng(2).random((B, T, H, W, CIN), dtype=np.float32))
    x = x.to(DEVICE)
    x_bf16 = x.to(torch.bfloat16)
    forwards = {"fused (K1, bf16)": lambda: fused_model(x_bf16),
                "int8 (K5)": lambda: int8_rollout(qparams, x, STEPS),
                "cmajor (K1 + K6a + K6b, bf16)": lambda: cmajor_model(x_bf16)}
    runs = {name: [] for name in forwards}
    peaks = {}
    with torch.inference_mode():
        for name, fn in forwards.items():
            torch.cuda.reset_peak_memory_stats()
            fn()  # warm-up
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        order = list(forwards)
        for name in order + order[::-1]:
            runs[name].append(cuda_ms(torch, forwards[name], 2))
        for name, r in runs.items():
            ms = sum(r) / len(r)
            print(f"b{B} forward ({T} in, {STEPS} out, {H}x{W}x{CIN}) through the {name} rollout: "
                  f"{ms:.2f} ms, {B * STEPS / (ms / 1e3):.1f} frames/s (runs "
                  f"{', '.join(f'{v:.2f}' for v in r)} ms); peak device memory {peaks[name]:.2f} "
                  f"GiB [{card}]", flush=True)
        for name in ("int8 (K5)", "cmajor (K1 + K6a + K6b, bf16)"):
            print_profile(f"b{B} forward through the {name} rollout",
                          device_time_by_class(torch, forwards[name], FORWARD_CLASSES), card)
    return times


@contextlib.contextmanager
def step_variant(name: str):
    """``SATFLOW_STEP_VARIANT=name`` for the duration."""
    old = os.environ.get("SATFLOW_STEP_VARIANT")
    os.environ["SATFLOW_STEP_VARIANT"] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ["SATFLOW_STEP_VARIANT"]
        else:
            os.environ["SATFLOW_STEP_VARIANT"] = old


def boundary_rows(height: int, block_h: int):
    """The image's first and last rows and the rows on either side of every
    row-block boundary."""
    return sorted({0, height - 1} | {r for b in range(block_h, height, block_h)
                                     for r in (b - 1, b)})


def check_halo_kernel(torch, card) -> float:
    """Phase 17a: K1h vs its plain version and vs K1, and build_halo vs
    slicing; returns the largest bf16 |K1h - plain|."""
    from satflow_tpu_torch.ops import fused_convlstm_step as P

    rows = boundary_rows(H, HALO_BLOCK_H)
    worst_bf16 = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        name = str(dtype)[6:]
        for cx in (CIN, HIDDEN):
            args = step_inputs(torch, cx, dtype, seed=800 + cx)
            before = P.fused_convlstm_step_halo.launches, P.fused_convlstm_step.launches
            got = P.fused_convlstm_step_halo(*args)
            torch.cuda.synchronize()
            if (P.fused_convlstm_step_halo.launches, P.fused_convlstm_step.launches) != (
                    before[0] + 1, before[1]):
                fail(f"K1h did not launch alone at Cx={cx}")
            want = P.fused_convlstm_step_halo_ref(*args)
            k1 = P._step(*args)
            errs, errs_k1 = {}, {}
            regions = dict(REGIONS, **{"block rows": (slice(None), rows)})
            for region, idx in regions.items():
                for out, g_, w_, k_ in (("h", got[0], want[0], k1[0]), ("c", got[1], want[1], k1[1])):
                    errs[f"{out}.{region}"] = _max_err(torch, g_[idx], w_[idx], tol,
                                                       f"K1h vs plain {name} Cx={cx} {out} {region}")
                    errs_k1[f"{out}.{region}"] = _max_err(
                        torch, g_[idx], k_[idx], TOL_SAME_SUMS[name],
                        f"K1h vs K1 {name} Cx={cx} {out} {region}")
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, max(errs.values()))
            print(f"K1h vs plain: {name} B={B} {H}x{W} Cx={cx} Ch={HIDDEN}: max|diff| "
                  f"{max(errs.values()):.3g} (edges and the {len(rows)} rows at block boundaries: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items() if "all" not in k)
                  + f") tol {tol}; vs K1 max|diff| {max(errs_k1.values()):.3g} tol "
                  f"{TOL_SAME_SUMS[name]} ok [{card}]", flush=True)
    x = step_inputs(torch, CIN, torch.bfloat16, seed=812)[0]
    halo = P.build_halo(x, HALO_BLOCK_H)
    n = H // HALO_BLOCK_H
    if tuple(halo.shape) != (B, n, 2, W, CIN) or not halo.is_contiguous():
        fail(f"build_halo gave {tuple(halo.shape)}")
    zero = torch.zeros_like(x[:, 0])
    for r in range(n):
        top = x[:, r * HALO_BLOCK_H - 1] if r else zero
        bot = x[:, (r + 1) * HALO_BLOCK_H] if r + 1 < n else zero
        if not (torch.equal(halo[:, r, 0], top) and torch.equal(halo[:, r, 1], bot)):
            fail(f"build_halo != slicing at row block {r}")
    print(f"build_halo vs slicing: ({B}, {H}, {W}, {CIN}) -> {tuple(halo.shape)}, every row "
          f"block's two rows equal, zeros at the image's edges ok [{card}]", flush=True)
    return worst_bf16


def padded_inputs(torch, cx: int, dtype, seed: int):
    """step_inputs with x and h W-padded by one zero column on either side."""
    from satflow_tpu_torch.tools.exp_tap9 import pad_w

    x, h, c, wx, wh, b = step_inputs(torch, cx, dtype, seed)
    return pad_w(x).contiguous(), pad_w(h).contiguous(), c, wx, wh, b


def check_study_steps(torch, card):
    """Phase 17b: T1, K1p and T2 vs their plain versions in the padded layout;
    returns their largest bf16 |kernel - plain| (T2's relative to max|plain|)
    as (T1, T2, K1p)."""
    from satflow_tpu_torch.ops import fused_convlstm_step as P
    from satflow_tpu_torch.tools import exp_tap9 as XT

    worst = {"T1": 0.0, "T2": 0.0, "K1p": 0.0}
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        name = str(dtype)[6:]
        for cx in (CIN, HIDDEN):
            args = padded_inputs(torch, cx, dtype, seed=820 + cx)
            counters = (XT.step_tap9, XT.step_padded, XT.step_nogate)
            before = tuple(c_.launches for c_ in counters)
            h9, c9 = XT.step_tap9(*args)
            hk, ck = XT.step_padded(*args)
            hn, cn = XT.step_nogate(*args)
            torch.cuda.synchronize()
            if tuple(c_.launches for c_ in counters) != tuple(n + 1 for n in before):
                fail(f"T1, K1p or T2 did not launch at Cx={cx}")
            for what, hp in (("T1", h9), ("K1p", hk), ("T2", hn)):
                if tuple(hp.shape) != (B, H, W + 2, HIDDEN) or hp[:, :, (0, -1)].abs().max().item() != 0:
                    fail(f"{what} {name} Cx={cx}: the halo columns of h' are not exactly zero")
            k1 = P._step(args[0][:, :, 1:-1].contiguous(), args[1][:, :, 1:-1].contiguous(), *args[2:])
            hk_p, ck_p = XT.step_padded_ref(*args)
            errs_p, errs_pk1 = {}, {}
            for region, idx in REGIONS.items():
                for out, g_, w_, k_ in (("h", hk[:, :, 1:-1], hk_p[:, :, 1:-1], k1[0]),
                                        ("c", ck, ck_p, k1[1])):
                    errs_p[f"{out}.{region}"] = _max_err(
                        torch, g_[idx], w_[idx], tol, f"K1p vs plain {name} Cx={cx} {out} {region}")
                    errs_pk1[f"{out}.{region}"] = _max_err(
                        torch, g_[idx], k_[idx], TOL_SAME_SUMS[name],
                        f"K1p vs K1 {name} Cx={cx} {out} {region}")
            h9_p, c9_p = XT.step_tap9_ref(*args)
            errs, errs_k1 = {}, {}
            for region, idx in REGIONS.items():
                for out, g_, w_, k_ in (("h", h9[:, :, 1:-1], h9_p[:, :, 1:-1], k1[0]),
                                        ("c", c9, c9_p, k1[1])):
                    errs[f"{out}.{region}"] = _max_err(torch, g_[idx], w_[idx], tol,
                                                       f"T1 vs plain {name} Cx={cx} {out} {region}")
                    errs_k1[f"{out}.{region}"] = _max_err(
                        torch, g_[idx], k_[idx], TOL_SAME_SUMS[name],
                        f"T1 vs K1 {name} Cx={cx} {out} {region}")
            hn_p, cn_p = XT.step_nogate_ref(*args)
            rel = {}
            for out, g_, w_ in (("h", hn, hn_p), ("c", cn, cn_p)):
                scale = w_.float().abs().max().item()
                rel[out] = (g_.float() - w_.float()).abs().max().item() / scale
                if not rel[out] <= TOL_NOGATE_REL[name]:
                    fail(f"T2 vs plain {name} Cx={cx} {out}: max|diff| / max|plain| {rel[out]:.3g} "
                         f"> {TOL_NOGATE_REL[name]} (max|plain| {scale:.3g})")
            # the o + g slots T2's epilogue does not read, through its sums entry
            # point: f32 sums of the same products in another order
            og = XT.step_nogate_sums(*args)[2]
            og_p = XT.nogate_sums_ref(*args)
            og_scale = og_p.abs().max().item()
            rel["o+g"] = (og - og_p).abs().max().item() / og_scale
            if not rel["o+g"] <= TOL_NOGATE_REL["float32"]:
                fail(f"T2's o + g sums vs plain {name} Cx={cx}: max|diff| / max|plain| "
                     f"{rel['o+g']:.3g} > {TOL_NOGATE_REL['float32']}")
            if dtype == torch.bfloat16:
                worst["T1"] = max(worst["T1"], max(errs.values()))
                worst["T2"] = max(worst["T2"], rel["h"], rel["c"])
                worst["K1p"] = max(worst["K1p"], max(errs_p.values()))
            print(f"K1p vs plain: {name} B={B} {H}x{W}(+2) Cx={cx} Ch={HIDDEN}: max|diff| "
                  f"{max(errs_p.values()):.3g} tol {tol}; vs K1 on the interior "
                  f"{max(errs_pk1.values()):.3g} tol {TOL_SAME_SUMS[name]}; halo columns of h' "
                  f"zero ok [{card}]", flush=True)
            print(f"T1 vs plain: {name} B={B} {H}x{W}(+2) Cx={cx} Ch={HIDDEN}: max|diff| "
                  f"{max(errs.values()):.3g} (edges: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items() if "all" not in k)
                  + f") tol {tol}; vs K1 on the interior {max(errs_k1.values()):.3g} tol "
                  f"{TOL_SAME_SUMS[name]}; halo columns of h' zero ok [{card}]", flush=True)
            print(f"T2 vs plain: {name} B={B} {H}x{W}(+2) Cx={cx} Ch={HIDDEN}: max|diff| / max|plain| "
                  f"h {rel['h']:.3g}, c {rel['c']:.3g} <= {TOL_NOGATE_REL[name]}; o + g sums "
                  f"{rel['o+g']:.3g} <= {TOL_NOGATE_REL['float32']}; halo columns of h' zero ok "
                  f"[{card}]", flush=True)
    return worst["T1"], worst["T2"], worst["K1p"]


def exp_cmajor_inputs(torch, dtype, seed: int, block_h: int = HALO_BLOCK_H):
    """T3's (x, h, c, w9, b) in the pad-row layout and K6a's (x, h, c, wx,
    wh, b) from the same NHWC tensors."""
    from satflow_tpu_torch.ops import cmajor_convlstm as CM
    from satflow_tpu_torch.tools import exp_cmajor as XC

    x, h, c, wx, wh, b = step_inputs(torch, HIDDEN, dtype, seed)
    t3 = tuple(XC.to_cmajor(t, block_h) for t in (x, h, c)) + (
        XC.weights_cmajor(wx, wh), b.reshape(-1, 1).contiguous())
    k6a = tuple(CM.to_cmajor(t) for t in (x, h, c)) + (wx, wh, b)
    return t3, k6a


def check_exp_cmajor(torch, card) -> float:
    """Phase 17c: T3 vs its plain version and vs K6a, at block_h 4 (the bf16
    kernel's 8-row tiles straddle pad and image rows) and 8; returns the
    largest bf16 |T3 - plain|."""
    from satflow_tpu_torch.ops import cmajor_convlstm as CM
    from satflow_tpu_torch.tools import exp_cmajor as XC

    worst_bf16 = 0.0
    for (dtype, tol), bh in ((d, bh) for d in ((torch.float32, TOL_F32),
                                               (torch.bfloat16, TOL_BF16)) for bh in (4, 8)):
        name = str(dtype)[6:]
        t3, k6a = exp_cmajor_inputs(torch, dtype, seed=840 + bh, block_h=bh)
        before = XC.cmajor_step.launches
        got = XC.cmajor_step(*t3, bh, H, W)
        torch.cuda.synchronize()
        if XC.cmajor_step.launches != before + 1:
            fail("T3 did not launch")
        want = XC.cmajor_step_ref(*t3, bh, H, W)
        ref6 = CM.cmajor_convlstm_step(*k6a, H, W)
        errs, errs_k6 = {}, {}
        for out, g_, w_, k_ in (("h", got[0], want[0], ref6[0]), ("c", got[1], want[1], ref6[1])):
            pad = g_.reshape(B, HIDDEN, H + 2 * bh, W)
            if pad[:, :, :bh].abs().max().item() != 0 or pad[:, :, -bh:].abs().max().item() != 0:
                fail(f"T3 {name}: the pad rows of {out}' are not exactly zero")
            g_n, w_n = XC.from_cmajor(g_, H, W, bh), XC.from_cmajor(w_, H, W, bh)
            k_n = CM.from_cmajor(k_, H, W)
            for region, idx in REGIONS.items():
                errs[f"{out}.{region}"] = _max_err(torch, g_n[idx], w_n[idx], tol,
                                                   f"T3 vs plain {name} {out} {region}")
                errs_k6[f"{out}.{region}"] = _max_err(torch, g_n[idx], k_n[idx],
                                                      TOL_SAME_SUMS[name],
                                                      f"T3 vs K6a {name} {out} {region}")
        # a 3-step chain on its own outputs (x fed back from h') against three K6a steps
        w9, b2 = t3[3:]
        carry, carry6 = t3[:3], k6a[:3]
        for _ in range(3):
            h2, c2 = XC.cmajor_step(*carry, w9, b2, bh, H, W)
            carry = (h2, h2, c2)
            h6, c6 = CM.cmajor_convlstm_step(*carry6, *k6a[3:], H, W)
            carry6 = (h6, h6, c6)
        chain_tol = {k: 3 * v for k, v in TOL_SAME_SUMS[name].items()}
        chain = max(_max_err(torch, XC.from_cmajor(a, H, W, bh), CM.from_cmajor(b_, H, W), chain_tol,
                             f"T3 3-step chain vs K6a {name}")
                    for a, b_ in ((carry[1], carry6[1]), (carry[2], carry6[2])))
        if dtype == torch.bfloat16:
            worst_bf16 = max(worst_bf16, *errs.values())
        print(f"T3 vs plain: {name} B={B} {H}x{W} C={HIDDEN} block_h={bh}: max|diff| "
              f"{max(errs.values()):.3g} (edges: "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items() if "all" not in k)
              + f") tol {tol}; vs K6a {max(errs_k6.values()):.3g} tol {TOL_SAME_SUMS[name]}; pad "
              f"rows of h' and c' zero; 3-step chain vs three K6a steps {chain:.3g} ok [{card}]",
              flush=True)
    return worst_bf16


# K1h and K6a at every hidden width they are built for and at one they
# zero-pad (24, to 32), with a 1-channel, a 12-channel and a 64-channel input;
# K1h on B=2 48x70 (six row blocks of 8; 48 is a multiple of no tile height
# but 8's), K6a on its card test's B=2 10x70 (a multiple of no tile).
NEW_WIDTHS_CH = (8, 16, 24, 32, 64, 128)
NEW_WIDTHS_CX = (1, 12, 64)
HALO_WIDTHS_BHW = (2, 48, 70)
CMAJOR_WIDTHS_BHW = (2, 10, 70)


def check_halo_cmajor_widths(torch, card) -> dict:
    """Phase 17d: K1h against its plain version and against K1, and K6a
    against its plain version, at Ch 8, 16, 24, 32, 64, 128 with Cx 1, 12, 64,
    float32 and bfloat16, every call a counted launch, edges on their own.
    Returns {kernel: largest bf16 |kernel - plain|}."""
    from satflow_tpu_torch.ops import cmajor_convlstm as CM
    from satflow_tpu_torch.ops import fused_convlstm_step as P

    worst = {"K1h": 0.0, "K6a": 0.0}
    hb, hh, hw = HALO_WIDTHS_BHW
    cb, chh, cw = CMAJOR_WIDTHS_BHW
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        name = str(dtype)[6:]
        for ch in NEW_WIDTHS_CH:
            errs = {"K1h": 0.0, "K1h vs K1": 0.0, "K6a": 0.0}
            for cx in NEW_WIDTHS_CX:
                what = f"{name} Cx={cx} Ch={ch}"
                args = step_inputs(torch, cx, dtype, seed=3000 + ch + cx, ch=ch,
                                   bhw=HALO_WIDTHS_BHW)
                before = P.fused_convlstm_step_halo.launches, P.fused_convlstm_step.launches
                got = P.fused_convlstm_step_halo(*args)
                torch.cuda.synchronize()
                if (P.fused_convlstm_step_halo.launches, P.fused_convlstm_step.launches) != (
                        before[0] + 1, before[1]):
                    fail(f"K1h did not launch alone at {what}")
                want = P.fused_convlstm_step_halo_ref(*args)
                k1 = P._step(*args)
                regions = dict(REGIONS, **{"block rows": (slice(None), boundary_rows(hh, 8))})
                for region, idx in regions.items():
                    for i, out in enumerate(("h", "c")):
                        errs["K1h"] = max(errs["K1h"], _max_err(
                            torch, got[i][idx], want[i][idx], tol,
                            f"K1h vs plain {what} {out} {region}"))
                        errs["K1h vs K1"] = max(errs["K1h vs K1"], _max_err(
                            torch, got[i][idx], k1[i][idx], TOL_SAME_SUMS[name],
                            f"K1h vs K1 {what} {out} {region}"))
                cell = step_inputs(torch, cx, dtype, seed=4000 + ch + cx, ch=ch,
                                   bhw=CMAJOR_WIDTHS_BHW)
                cell = tuple(CM.to_cmajor(t) for t in cell[:3]) + cell[3:]
                before = CM.cmajor_convlstm_step.launches
                got = CM.cmajor_convlstm_step(*cell, chh, cw)
                torch.cuda.synchronize()
                if CM.cmajor_convlstm_step.launches != before + 1:
                    fail(f"K6a did not launch at {what}")
                want = CM.cmajor_convlstm_step_ref(*cell, chh, cw)
                for i, out in enumerate(("h", "c")):
                    g_, w_ = CM.from_cmajor(got[i], chh, cw), CM.from_cmajor(want[i], chh, cw)
                    if g_.shape != (cb, chh, cw, ch):
                        fail(f"K6a {what}: {out}' of shape {tuple(g_.shape)}")
                    for region, idx in REGIONS.items():
                        errs["K6a"] = max(errs["K6a"], _max_err(
                            torch, g_[idx], w_[idx], tol, f"K6a vs plain {what} {out} {region}"))
            if dtype == torch.bfloat16:
                worst["K1h"] = max(worst["K1h"], errs["K1h"])
                worst["K6a"] = max(worst["K6a"], errs["K6a"])
            print(f"K1h (B={hb} {hh}x{hw}) and K6a (B={cb} {chh}x{cw}) vs plain: {name} Ch={ch}"
                  f"{' (padded to 32)' if ch == 24 else ''}, Cx {NEW_WIDTHS_CX}: max|diff| K1h "
                  f"{errs['K1h']:.3g}, K6a {errs['K6a']:.3g} (edges and block-boundary rows held on "
                  f"their own) tol {tol}; K1h vs K1 {errs['K1h vs K1']:.3g} tol "
                  f"{TOL_SAME_SUMS[name]}; every call a launch ok [{card}]", flush=True)
    return worst


# K5 at every hidden width it is built for and at one it zero-pads (24, to
# 32), with input widths it pads (1 and 13, to 4 and 16) and one it does not
# (12), B=2 48x70.
INT8_WIDTHS = tuple((ch, cx) for ch in (8, 16, 24, 32, 64, 128) for cx in (1, 12, 13))


def check_int8_widths(torch, card) -> float:
    """Phase 13c: K5 at Ch 8, 16, 24, 32, 64, 128 with Cx 1, 12 and 13 (24, 1
    and 13 zero-padded in the wrapper): its integer sums equal to the exact
    ones; the step against the plain step at the unpadded widths (h'q within
    one int8 step on at most INT8_MAX_FLIP_SHARE of elements, c' within one
    step of its dtype), and bit-equal to K5 on operands padded beforehand (what
    the session does once); the padded channels exact zeros. Returns the
    largest |c' diff|."""
    from satflow_tpu_torch.ops import fused_convlstm_int8 as Q

    worst = 0.0
    bhw = (2, 48, 70)
    for ch, cx in INT8_WIDTHS:
        x, h, c, wx, wh, b = step_inputs(torch, cx, torch.float32, seed=5000 + ch + cx, ch=ch,
                                         bhw=bhw)
        w3q, dequant, bias = Q.quantize_weights(wx, wh, b)
        args = (Q.quantize_activations(x), Q.quantize_activations(h), c.to(torch.bfloat16),
                w3q, dequant, bias)
        before = Q.fused_convlstm_step_int8.launches
        hq_k, c_k = Q.fused_convlstm_step_int8(*args)
        torch.cuda.synchronize()
        if Q.fused_convlstm_step_int8.launches != before + 1:
            fail(f"K5 did not launch at Cx={cx} Ch={ch}")
        hq_p, c_p = Q.fused_convlstm_step_int8_ref(*args)
        sums = Q.int8_gate_sums(args[0], args[1], w3q)
        if not torch.equal(sums, Q.int8_accumulate(args[0], args[1], w3q)):
            fail(f"K5's integer sums differ from the exact ones at Cx={cx} Ch={ch}")
        diff = (hq_k.int() - hq_p.int()).abs()
        flips = diff.float().mean().item()
        if diff.max().item() > 1 or flips > INT8_MAX_FLIP_SHARE:
            fail(f"K5 != plain at Cx={cx} Ch={ch}: h'q max|diff| {diff.max().item()}, share {flips}")
        err = _max_err(torch, c_k, c_p, TOL_INT8_C["bfloat16"], f"K5 c' Cx={cx} Ch={ch}")
        worst = max(worst, err)
        cx_to, ch_to = Q.kernel_widths(cx, ch)
        w_pad = Q.pad_quantized(w3q, dequant, bias, cx, cx_to, ch_to)
        pre = Q.fused_convlstm_step_int8(
            Q.pad_channels(args[0], cx_to), Q.pad_channels(args[1], ch_to),
            Q.pad_channels(args[2], ch_to), *w_pad, Q.pack_weights(w_pad[0], cx_to))
        if not (torch.equal(pre[0][..., :ch], hq_k) and torch.equal(pre[1][..., :ch], c_k)):
            fail(f"K5 padded in the wrapper != K5 on operands padded beforehand at Cx={cx} Ch={ch}")
        if ch < ch_to and (pre[0][..., ch:].abs().max().item() != 0
                           or pre[1][..., ch:].abs().max().item() != 0):
            fail(f"K5's padded channels are not zeros at Cx={cx} Ch={ch}")
        flipped = int((diff != 0).sum().item())
        print(f"K5 vs plain: c bf16 B={bhw[0]} {bhw[1]}x{bhw[2]} Cx={cx} Ch={ch} (run at Cx={cx_to} "
              f"Ch={ch_to}): integer sums exact; h'q differs by one step on {flipped} of "
              f"{diff.numel()} elements (share {flips:.2g} <= {INT8_MAX_FLIP_SHARE}), c' max|diff| "
              f"{err:.3g} tol {TOL_INT8_C['bfloat16']}; bit-equal to K5 on operands padded "
              f"beforehand, padded channels zero ok [{card}]", flush=True)
    return worst


# T3 at every channel width it is built for and at one it zero-pads (24, to 32)
STUDY_T3_WIDTHS = (8, 16, 24, 32, 64, 128)


def check_study_widths(torch, card) -> None:
    """Phase 17e: T1, K1p and T2 at the JAX tools' width 8 and at 32 (Cx =
    Ch), and T3 at STUDY_T3_WIDTHS with block_h 4 and 8, float32 and bfloat16,
    against their plain versions, every call a counted launch, T3's pad rows
    exactly zero; T2 relative to max|plain|."""
    from satflow_tpu_torch.tools import exp_cmajor as XC
    from satflow_tpu_torch.tools import exp_tap9 as XT

    bsz, hgt, wdt = 2, 48, 70
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        name = str(dtype)[6:]
        for ch in (8, 32):
            x, h, c, wx, wh, b = step_inputs(torch, ch, dtype, seed=6000 + ch, ch=ch,
                                             bhw=(bsz, hgt, wdt))
            pargs = (XT.pad_w(x).contiguous(), XT.pad_w(h).contiguous(), c, wx, wh, b)
            errs = {}
            for what, fn, ref in (("T1", XT.step_tap9, XT.step_tap9_ref),
                                  ("K1p", XT.step_padded, XT.step_padded_ref),
                                  ("T2", XT.step_nogate, XT.step_nogate_ref)):
                before = fn.launches
                got = fn(*pargs)
                torch.cuda.synchronize()
                if fn.launches != before + 1:
                    fail(f"{what} did not launch at {name} Ch={ch}")
                want = ref(*pargs)
                for g_, w_ in zip(got, want):
                    if what == "T2":
                        scale = w_.float().abs().max().item()
                        e = (g_.float() - w_.float()).abs().max().item() / scale
                        if not e <= TOL_NOGATE_REL[name]:
                            fail(f"T2 vs plain {name} Ch={ch}: max|diff| / max|plain| {e:.3g}")
                    else:
                        e = _max_err(torch, g_, w_, tol, f"{what} vs plain {name} Ch={ch}")
                    errs[what] = max(errs.get(what, 0.0), e)
            print(f"T1, K1p, T2 (W-padded) vs plain: {name} B={bsz} {hgt}x{wdt} Cx=Ch={ch}: max|diff| "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + f" (T2 relative to max|plain|) tol {tol}; every call a launch ok [{card}]",
                  flush=True)
        for block_h in (4, 8):
            errs = {}
            for ch in STUDY_T3_WIDTHS:
                x, h, c, wx, wh, b = step_inputs(torch, ch, dtype, seed=6100 + ch + block_h,
                                                 ch=ch, bhw=(bsz, hgt, wdt))
                carry = [XC.to_cmajor(t, block_h) for t in (x, h, c)]
                t3 = (*carry, XC.weights_cmajor(wx, wh), b.reshape(-1, 1).contiguous())
                before = XC.cmajor_step.launches
                got = XC.cmajor_step(*t3, block_h, hgt, wdt)
                torch.cuda.synchronize()
                if XC.cmajor_step.launches != before + 1:
                    fail(f"T3 did not launch at {name} C={ch} block_h={block_h}")
                want = XC.cmajor_step_ref(*t3, block_h, hgt, wdt)
                for g_, w_ in zip(got, want):
                    pad = g_.reshape(bsz, ch, hgt + 2 * block_h, wdt)
                    if pad[:, :, :block_h].abs().max().item() != 0 or \
                            pad[:, :, -block_h:].abs().max().item() != 0:
                        fail(f"T3 {name} C={ch} block_h={block_h}: pad rows not exactly zero")
                    errs[ch] = max(errs.get(ch, 0.0), _max_err(
                        torch, g_, w_, tol, f"T3 vs plain {name} C={ch} block_h={block_h}"))
            print(f"T3 (pad rows) vs plain: {name} B={bsz} {hgt}x{wdt} block_h={block_h}: max|diff| "
                  + ", ".join(f"C={k}{' (padded to 32)' if k == 24 else ''} {v:.3g}"
                              for k, v in errs.items())
                  + f" tol {tol}; pad rows zero; every call a launch ok [{card}]", flush=True)


# The channel-major and int8 rollouts at hidden 32 (one of the hparam search's
# widths, and accuracy_gate's: K6a and K5 built for it): 64x128 images (W % 128
# == 0, the channel-major geometry gate), 7 frames in and 24 out, b8.
SMALL_HIDDEN = 32
SMALL_HW = (64, 128)


def small_width_paths(torch, card):
    """Phase 15b: ``cell_impl="cmajor"`` and ``quantize="int8"`` served at
    hidden 32 (5 concurrent requests each; K6a and K5 built for 32, the int8
    session's cells not padded), launches counted per forward, replies held
    against the fused rollout through K1 (cmajor) and against the int8
    rollout through K5's plain version. Returns ((K1, K6a, K6b) launches, K5
    launches)."""
    from satflow_tpu_torch.interop.jax_weights import params_from_flax
    from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM
    from satflow_tpu_torch.ops import cmajor_convlstm as CM
    from satflow_tpu_torch.ops import fused_convlstm_int8 as Q
    from satflow_tpu_torch.ops import fused_convlstm_step as P
    from satflow_tpu_torch.serve import InferenceSession

    weights = params_from_flax(flax_params(0, hidden=SMALL_HIDDEN))
    requests = convlstm_requests(seed=9, hw=SMALL_HW)
    what = f"hidden {SMALL_HIDDEN}, {SMALL_HW[0]}x{SMALL_HW[1]}"

    fused = EncoderDecoderConvLSTM(hidden_dim=SMALL_HIDDEN, input_channels=CIN,
                                   out_channels=COUT, forecast_steps=STEPS)
    fused.module.load_state_dict(weights)
    fused = fused.to(DEVICE).eval()
    fused.set_compute_dtype(torch.bfloat16)
    model = EncoderDecoderConvLSTM(hidden_dim=SMALL_HIDDEN, input_channels=CIN,
                                   out_channels=COUT, forecast_steps=STEPS, cell_impl="cmajor")
    session = InferenceSession(model, max_batch=B, state_dict=weights, dtype=torch.bfloat16,
                               device=DEVICE)
    replies, wall, forwards, cm = drive_server(
        session, requests, [P.fused_convlstm_step, CM.cmajor_convlstm_step, CM.cmajor_conv3x3])
    check_frames(requests, replies, f"cmajor serving at {what}")
    if forwards < 1 or cm != tuple(n * forwards for n in CMAJOR_LAUNCHES_PER_FORWARD):
        fail(f"cmajor serving at {what} launched (K1, K6a, K6b) {cm} times in {forwards} "
             f"forwards, expected {CMAJOR_LAUNCHES_PER_FORWARD} each")
    with torch.inference_mode():
        x0 = torch.from_numpy(requests[0][None]).to(DEVICE)
        ref = fused(x0.to(torch.bfloat16)).float().cpu().numpy()[0]
    diff = float(np.abs(ref - replies[0][1]).max())
    if not diff <= TOL_ROLLOUT:
        fail(f"cmajor reply at {what} vs the fused rollout: max|diff| {diff:.3g} > {TOL_ROLLOUT}")
    print(f"cmajor at {what}: served {len(requests)} requests (6 samples) in {forwards} "
          f"forward(s) of b{B}, {wall:.3f} s wall; launches (K1, K6a, K6b) {cm} = "
          f"{CMAJOR_LAUNCHES_PER_FORWARD} x {forwards}; reply vs the fused rollout max|diff| "
          f"{diff:.3g} <= {TOL_ROLLOUT} ok [{card}]", flush=True)
    del session, model

    model = EncoderDecoderConvLSTM(hidden_dim=SMALL_HIDDEN, input_channels=CIN,
                                   out_channels=COUT, forecast_steps=STEPS)
    session = InferenceSession(model, max_batch=B, state_dict=weights, quantize="int8",
                               device=DEVICE)
    widths = tuple(q.w3q.shape[-1] // 4 for n, q in session.qparams.items() if n != "head")
    if widths != (SMALL_HIDDEN,) * 4:
        fail(f"the int8 session at {what} runs its cells at {widths}, not at K5's built "
             f"{SMALL_HIDDEN}")
    replies, wall, forwards, (k5, k1) = drive_server(
        session, requests, [Q.fused_convlstm_step_int8, P.fused_convlstm_step])
    check_frames(requests, replies, f"int8 serving at {what}")
    if forwards < 1 or (k5, k1) != (INT8_LAUNCHES_PER_FORWARD * forwards, 0):
        fail(f"int8 serving at {what} launched K5 {k5} and K1 {k1} times in {forwards} forwards")
    with torch.inference_mode():
        plain = Q.int8_rollout(Q.quantize_convlstm_params(model.module, pad=False), x0, STEPS,
                               step=Q.fused_convlstm_step_int8_ref).float().cpu().numpy()[0]
    diffs = {name: float(np.abs(r - replies[0][1]).max())
             for name, r in (("the bf16 rollout through K1", ref),
                             ("the int8 rollout through K5's plain version", plain))}
    for name, d in diffs.items():
        if not d <= TOL_INT8_REPLY:
            fail(f"int8 reply at {what} vs {name}: max|diff| {d:.3g} > {TOL_INT8_REPLY}")
    print(f"int8 at {what} (K5 built for {SMALL_HIDDEN}, the cells unpadded): served {len(requests)} "
          f"requests (6 samples) in {forwards} forward(s) of b{B}, {wall:.3f} s wall; launches K5 "
          f"{k5} = {INT8_LAUNCHES_PER_FORWARD} x {forwards}, K1 {k1}; reply vs "
          + ", ".join(f"{n} {d:.3g}" for n, d in diffs.items())
          + f" <= {TOL_INT8_REPLY} ok [{card}]", flush=True)
    return cm, k5


def fit_one_step(torch, model, counters, want_per_step, what: str, card, hw=(H, W),
                 precision="bf16"):
    """One Adam step (and the epoch's one validation forward) through
    ``Trainer(precision=precision).fit`` on fake b8 data of ``hw`` pixels. The
    counters' launches are set to 0 just before ``fit`` and read just after;
    returns (launches per counter, trainer, the train batch on the card)."""
    from satflow_tpu_torch.data import SatFlowDataModule
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.train import Trainer

    dm = SatFlowDataModule(fake_data=True, num_workers=0, n_train_data=1, n_val_data=1,
                           history_minutes=5 * (T - 1), forecast_minutes=5 * STEPS,
                           fake_kwargs=dict(batch_size=B, width=hw[1], height=hw[0]))
    counter = LaunchesPerStep(*counters)
    trainer = Trainer(max_steps=1, precision=precision, log_every_n_steps=1, device=DEVICE,
                      callbacks=[counter])
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    trainer.fit(model, dm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tuple(c.launches for c in counters)
    losses = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
    val_loss = trainer.callback_metrics.get("val/loss", float("nan"))
    if trainer.global_step != 1 or len(losses) != 1 or not all(np.isfinite(losses + [val_loss])):
        fail(f"{what}: fit took {trainer.global_step} steps; losses {losses}, val {val_loss}")
    if counter.per_step != [tuple(want_per_step)]:
        fail(f"{what}: launches in the train step {counter.per_step}, expected "
             f"{tuple(want_per_step)}")
    print(f"{what}: trained 1 step (precision {precision}, b{B} {hw[0]}x{hw[1]}, {T} in / {STEPS} out, remat_chunk "
          f"{REMAT_CHUNK}) in {wall:.2f} s wall with data generation: loss {losses[0]:.6f}, val "
          f"{val_loss:.6f}; launches in the step {counter.per_step[0]}, fit total {launches} "
          f"(with one validation forward) [{card}]", flush=True)
    batch = to_device(next(iter(dm.train_dataloader())), torch.device(DEVICE))
    return launches, trainer, batch


def compare_step_grads(torch, model, batch, kernel_kw, plain_kw, what: str, card,
                       tol: float = TOL_TRAIN_GRAD) -> float:
    """Every parameter's gradient of one train step through the kernels
    against the same step through the plain versions, within ``tol`` x
    max|grad| of each tensor (the default is the bf16 step's)."""
    def step_grads(**kw):
        model.train()
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(batch, **kw)
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return grads

    got, want = step_grads(**kernel_kw), step_grads(**plain_kw)
    worst = 0.0
    for name, g in got.items():
        w = want[name]
        if g is None or not bool(torch.isfinite(g).all()) or not g.abs().sum().item() > 0:
            fail(f"{what}: parameter {name} has no finite nonzero gradient through the kernels")
        rel = (g - w).abs().max().item() / w.abs().max().item()
        cos = torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0).item()
        worst = max(worst, rel)
        if not (rel <= tol and cos >= MIN_TRAIN_GRAD_COS):
            fail(f"{what}: gradient of {name} vs plain: max|diff| / max|grad| {rel:.3g} (tol "
                 f"{tol}), cosine {cos:.6f} (min {MIN_TRAIN_GRAD_COS})")
    print(f"{what}: one train step's gradients through the kernels vs the plain versions: "
          f"all {len(got)} parameters nonzero; max|diff| / max|grad| {worst:.3g} <= "
          f"{tol}, cosine >= {MIN_TRAIN_GRAD_COS} ok [{card}]", flush=True)
    return worst


def halo_path(torch, card, fused_model):
    """Phase 18, the halo variant of the main path; returns (K1h launches
    serving, K1h launches training, K2 launches training)."""
    from satflow_tpu_torch.interop.jax_weights import params_from_flax
    from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM
    from satflow_tpu_torch.ops import fused_convlstm_step as P
    from satflow_tpu_torch.serve import InferenceSession

    requests = convlstm_requests()
    with torch.inference_mode():  # the K1 rollout (3pass) of the first request
        x0 = torch.from_numpy(requests[0][None]).to(DEVICE, torch.bfloat16)
        ref = fused_model(x0).float().cpu().numpy()[0]
    with step_variant("halo"):
        model = EncoderDecoderConvLSTM(hidden_dim=HIDDEN, input_channels=CIN,
                                       out_channels=COUT, forecast_steps=STEPS)
        session = InferenceSession(model, max_batch=B,
                                   state_dict=params_from_flax(flax_params(0)),
                                   dtype=torch.bfloat16, device=DEVICE)
        replies, wall, forwards, (k1h, k1) = drive_server(
            session, requests, [P.fused_convlstm_step_halo, P.fused_convlstm_step])
        check_frames(requests, replies, "halo serving")
        if forwards < 1 or (k1h, k1) != (LAUNCHES_PER_FORWARD * forwards, 0):
            fail(f"halo serving launched K1h {k1h} and K1 {k1} times in {forwards} forwards, "
                 f"expected {LAUNCHES_PER_FORWARD} x {forwards} and 0")
        diff = float(np.abs(ref - replies[0][1]).max())
        if not diff <= TOL_ROLLOUT:
            fail(f"halo reply vs the K1 rollout: max|diff| {diff:.3g} > {TOL_ROLLOUT}")
        print(f"halo variant served {len(requests)} requests (6 samples) in {forwards} forward(s) "
              f"of b{B}, {wall:.3f} s wall; launches K1h {k1h} = {LAUNCHES_PER_FORWARD} x "
              f"{forwards}, K1 {k1}; reply vs the K1 rollout max|diff| {diff:.3g} <= "
              f"{TOL_ROLLOUT} ok [{card}]", flush=True)
        del session, model

        train_model = EncoderDecoderConvLSTM(
            hidden_dim=HIDDEN, input_channels=CIN, out_channels=COUT, forecast_steps=STEPS,
            remat=True, remat_chunk=REMAT_CHUNK)
        train_model.module.load_state_dict(params_from_flax(flax_params(0)))
        (t_k1h, t_k1, t_k2), _, batch = fit_one_step(
            torch, train_model, [P.fused_convlstm_step_halo, P.fused_convlstm_step, P.gate_bwd],
            (K1_PER_TRAIN_STEP, 0, K2_PER_TRAIN_STEP), "halo variant", card)
        if (t_k1h, t_k1, t_k2) != (K1_PER_TRAIN_STEP + LAUNCHES_PER_FORWARD, 0,
                                   K2_PER_TRAIN_STEP):
            fail(f"halo fit launched (K1h, K1, K2) {(t_k1h, t_k1, t_k2)} times")
        compare_step_grads(torch, train_model, batch, {},
                           dict(step=P.fused_convlstm_step_ref), "halo variant", card)
    return k1h, t_k1h, t_k2


# The default (``cell_impl="fused"``) model at the hidden widths of the shipped
# experiments: hidden 16 at the Trainer's default ``precision: 32``, hidden 32
# in bf16; 64 x 64 pixels, 7 frames in, 24 out, b8.
WIDTH_PATHS = ((16, "32"), (32, "bf16"))
# Phase 22b: hidden widths K1 and K2 are not built for, zero-padded inside the
# wrappers to 32 and to 16 (12 is also a Ch % 8 != 0).
PADDED_PATHS = ((24, "bf16"), (12, "32"))
PATH_HW = (64, 64)
# - one float32 train step's parameter gradients through K1 + K2 against the
#   same step through the plain versions: f32 sums in another order (TOL_F32 a
#   cell step), carried through the 62 steps of the rollout and its backward.
TOL_TRAIN_GRAD_F32 = 1e-3  # x max|grad| of each tensor


def widths_path(torch, card, paths=WIDTH_PATHS):
    """Phases 22 and 22b, the main path at the (hidden, precision) of ``paths``,
    by default hidden 16 (float32) and hidden 32 (bf16): 5 concurrent
    requests through ``NowcastServer`` and one Adam step through
    ``Trainer.fit``, every cell step a counted launch (on the card the wrappers
    launch or raise; they have no plain route), replies and gradients held
    against the same path through the plain versions. Returns
    the (K1, K2) launches of both models together."""
    from satflow_tpu_torch.interop.jax_weights import params_from_flax
    from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM
    from satflow_tpu_torch.ops import fused_convlstm_step as P
    from satflow_tpu_torch.serve import InferenceSession

    total_k1 = total_k2 = 0
    requests = convlstm_requests(seed=5, hw=PATH_HW)
    for hidden, precision in paths:
        bf16 = precision == "bf16"
        what = f"hidden {hidden}, precision {precision}"
        weights = params_from_flax(flax_params(0, hidden=hidden))
        model = EncoderDecoderConvLSTM(hidden_dim=hidden, input_channels=CIN,
                                       out_channels=COUT, forecast_steps=STEPS)
        session = InferenceSession(model, max_batch=B, state_dict=weights,
                                   dtype=torch.bfloat16 if bf16 else None, device=DEVICE)
        train_model = EncoderDecoderConvLSTM(
            hidden_dim=hidden, input_channels=CIN, out_channels=COUT, forecast_steps=STEPS,
            remat=True, remat_chunk=REMAT_CHUNK)
        train_model.module.load_state_dict(weights)
        replies, wall, forwards, (k1,) = drive_server(session, requests,
                                                      [P.fused_convlstm_step])
        (t_k1, t_k2), _, batch = fit_one_step(
            torch, train_model, [P.fused_convlstm_step, P.gate_bwd],
            (K1_PER_TRAIN_STEP, K2_PER_TRAIN_STEP), what, card, hw=PATH_HW,
            precision=precision)
        check_frames(requests, replies, what)
        if forwards < 1 or k1 != LAUNCHES_PER_FORWARD * forwards:
            fail(f"{what}: K1 launches {k1} != {LAUNCHES_PER_FORWARD} x {forwards} forwards")
        if (t_k1, t_k2) != (K1_PER_TRAIN_STEP + LAUNCHES_PER_FORWARD, K2_PER_TRAIN_STEP):
            fail(f"{what}: fit launched (K1, K2) {(t_k1, t_k2)} times")
        with torch.inference_mode():
            x0 = torch.from_numpy(requests[0][None]).to(
                DEVICE, torch.bfloat16 if bf16 else torch.float32)
            ref = model(x0, step=P.fused_convlstm_step_ref).float().cpu().numpy()[0]
        diff = float(np.abs(ref - replies[0][1]).max())
        tol = TOL_ROLLOUT if bf16 else TOL_F32["atol"]
        if not diff <= tol:
            fail(f"{what}: served rollout vs plain-step rollout: max|diff| {diff:.3g} > {tol}")
        print(f"{what}: served {len(requests)} requests (6 samples) of {PATH_HW[0]}x{PATH_HW[1]} in "
              f"{forwards} forward(s) of b{B}, {wall:.3f} s wall; K1 launches {k1} = "
              f"{LAUNCHES_PER_FORWARD} x {forwards}, every cell step a launch; reply vs the plain-step "
              f"rollout max|diff| {diff:.3g} <= {tol} ok [{card}]", flush=True)
        compare_step_grads(torch, train_model, batch, {}, dict(step=P.fused_convlstm_step_ref),
                           what, card, tol=TOL_TRAIN_GRAD if bf16 else TOL_TRAIN_GRAD_F32)
        with torch.inference_mode():  # after the launches were read: these are not the path's
            xb = x0.expand(B, *x0.shape[1:]).contiguous()
            ms = {}
            for name in ("plain", "kernel", "kernel", "plain"):
                kw = dict(step=P.fused_convlstm_step_ref) if name == "plain" else {}
                model(xb, **kw)  # warm-up
                ms.setdefault(name, []).append(cuda_ms(torch, lambda: model(xb, **kw), 3))
        print(f"{what}: b{B} forward ({T} in, {STEPS} out, {PATH_HW[0]}x{PATH_HW[1]}x{CIN}) through "
              f"the kernel step {sum(ms['kernel']) / 2:.2f} ms, through the plain step "
              f"{sum(ms['plain']) / 2:.2f} ms [{card}]", flush=True)
        total_k1 += k1 + t_k1
        total_k2 += t_k2
    return total_k1, total_k2


def padded_widths(torch, card):
    """The rest of phase 22b: a hidden width above a kernel's widest (256 for
    K1, K2, K1h; 128 for K6a, K5) is refused on the card with the rule named,
    nothing launched; K1 and K2 per call at hidden 256 (Cx=12); and what the
    padding costs a call:
    K1 and K2 at hidden 24 (padded to 32 in the wrapper: two pad and two slice
    copies of the state) beside hidden 32, bf16, B=8, 256x256, Cx=12."""
    from satflow_tpu_torch.ops import fused_convlstm_step as P

    from satflow_tpu_torch.ops import cmajor_convlstm as CM
    from satflow_tpu_torch.ops import fused_convlstm_int8 as Q

    wide = step_inputs(torch, CIN, torch.float32, seed=77, ch=264, bhw=(1, 8, 16))
    cots = cotangents(torch, torch.float32, seed=78, ch=264, bhw=(1, 8, 16))
    x, h, c, wx, wh, b = step_inputs(torch, CIN, torch.float32, seed=76, ch=136, bhw=(1, 8, 16))
    cell = (CM.to_cmajor(x), CM.to_cmajor(h), CM.to_cmajor(c), wx, wh, b)
    q = (Q.quantize_activations(x), Q.quantize_activations(h), c,
         *Q.quantize_weights(wx, wh, b))
    counters = (P.fused_convlstm_step, P.gate_bwd, P.fused_convlstm_step_halo,
                CM.cmajor_convlstm_step, Q.fused_convlstm_step_int8)
    before = tuple(k.launches for k in counters)
    for name, rule, call in (
            ("K1 at hidden 264", "1 <= Ch <= 256", lambda: P.fused_convlstm_step(*wide)),
            ("K2 at hidden 264", "1 <= Ch <= 256", lambda: P.gate_bwd(*wide, *cots)),
            ("K1h at hidden 264", "1 <= Ch <= 256", lambda: P.fused_convlstm_step_halo(*wide)),
            ("K6a at hidden 136", "1 <= Ch <= 128", lambda: CM.cmajor_convlstm_step(*cell, 8, 16)),
            ("K5 at hidden 136", "1 <= Ch <= 128", lambda: Q.fused_convlstm_step_int8(*q))):
        try:
            call()
        except ValueError as e:
            if rule not in str(e):
                fail(f"{name} raised without naming the rule: {e}")
        else:
            fail(f"{name} did not raise")
    if tuple(k.launches for k in counters) != before:
        fail("a refused width was counted as a launch")
    print(f"K1, K2 and K1h at hidden 264 raise and name the rule (1 <= Ch <= 256), K6a and K5 at "
          f"hidden 136 (1 <= Ch <= 128); nothing launched [{card}]", flush=True)
    ms = {}
    for ch in (24, 32):
        args = step_inputs(torch, CIN, torch.bfloat16, seed=79 + ch, ch=ch)
        cots = cotangents(torch, torch.bfloat16, seed=80 + ch, ch=ch)
        ms[ch] = (per_call_ms(torch, P.fused_convlstm_step, P.fused_convlstm_step_ref, args, n=10),
                  per_call_ms(torch, P.gate_bwd, P.gate_bwd_ref, args + cots, n=10))
    print(f"time per call, bf16 B={B} {H}x{W} Cx={CIN}: hidden 24 (padded to 32 in the wrapper) K1 "
          f"{ms[24][0]['kernel']:.4f} ms (plain {ms[24][0]['plain']:.4f}), K2 "
          f"{ms[24][1]['kernel']:.4f} ms (plain {ms[24][1]['plain']:.4f}); hidden 32 K1 "
          f"{ms[32][0]['kernel']:.4f} ms, K2 {ms[32][1]['kernel']:.4f} ms: the padding costs "
          f"{ms[24][0]['kernel'] - ms[32][0]['kernel']:.4f} / "
          f"{ms[24][1]['kernel'] - ms[32][1]['kernel']:.4f} ms a call [{card}]", flush=True)
    # the widest hidden width, two groups of 128 channels a pixel
    ch = 256
    args = step_inputs(torch, CIN, torch.bfloat16, seed=81, ch=ch)
    cots = cotangents(torch, torch.bfloat16, seed=82, ch=ch)
    t1 = per_call_ms(torch, P.fused_convlstm_step, P.fused_convlstm_step_ref, args, n=3)
    t2 = per_call_ms(torch, P.gate_bwd, P.gate_bwd_ref, args + cots, n=3)
    flop = 2 * B * H * W * 4 * ch * 9 * (CIN + ch)
    # outputs: h', c' (K1); dgates (4 Ch) and dc_prev (Ch), five of h's size (K2)
    for name, t, extra in (("K1", t1, (args[1], args[2])), ("K2", t2, (args[1],) * 5)):
        b_ms, by = bound_ms(args + extra + (cots if name == "K2" else ()), flop, "bf16")
        print(f"time per {name} call, bf16 B={B} {H}x{W} Cx={CIN} Ch={ch}: kernel "
              f"{t['kernel']:.4f} ms ({flop / t['kernel'] / 1e9:.1f} TFLOP/s), plain "
              f"{t['plain']:.4f} ms; bound {b_ms:.4f} ms by {by} [{card}]", flush=True)


def study_tools(torch, card):
    """Phase 19: the two study entry points in-process. Returns ((K1, K1p, T1,
    T2, K6a, T3) launches, the tools' ms per step)."""
    from satflow_tpu_torch.ops import cmajor_convlstm as CM
    from satflow_tpu_torch.ops import fused_convlstm_step as P
    from satflow_tpu_torch.tools import exp_cmajor as XC
    from satflow_tpu_torch.tools import exp_tap9 as XT

    counters = [P.fused_convlstm_step, XT.step_padded, XT.step_tap9, XT.step_nogate,
                CM.cmajor_convlstm_step, XC.cmajor_step]
    for c in counters:
        c.launches = 0
    ms = XT.main(bsz=B, size=H, ch=HIDDEN, block_h=HALO_BLOCK_H, steps=STUDY_STEPS["tap9"])
    ms.update(XC.main(bsz=B, height=H, width=W, ch=HIDDEN, block_h=HALO_BLOCK_H,
                      steps=STUDY_STEPS["cmajor"]))
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    # each tool verifies first (K1p, T1, T2: one launch; T3: three), then runs
    # its chain once to warm up and three times under the clock
    n9, nc = 4 * STUDY_STEPS["tap9"], 4 * STUDY_STEPS["cmajor"]
    want = (n9, n9 + 1, n9 + 1, n9 + 1, nc, nc + 3)
    if launches != want:
        fail(f"the study tools launched (K1, K1p, T1, T2, K6a, T3) {launches} times, expected "
             f"{want}")
    if set(ms) != {"k1", "k1_padded", "tap9", "nogate", "k6a", "t3"} or not all(
            np.isfinite(v) and v > 0 for v in ms.values()):
        fail(f"the study tools returned {ms}")
    print(f"study tools (exp_tap9, exp_cmajor) at B={B} {H}x{W} C={HIDDEN} bf16, chained rollouts "
          f"of {STUDY_STEPS['tap9']} and {STUDY_STEPS['cmajor']} steps: ms per step "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; on the tensor cores, against K1p: the exact epilogue (K1p - T2) "
          f"{ms['k1_padded'] - ms['nogate']:.3f} ms, "
          f"{100 * (1 - ms['nogate'] / ms['k1_padded']):.1f} %; the walk's order, the JAX "
          f"main kernel's against tap by tap (K1p - T1) {ms['k1_padded'] - ms['tap9']:.3f} ms, "
          f"{100 * (1 - ms['tap9'] / ms['k1_padded']):.1f} %; the W-padded I/O and the order "
          f"(K1p / K1) {ms['k1_padded'] / ms['k1']:.3f}x; launches (K1, K1p, T1, T2, K6a, T3) "
          f"{launches} [{card}]", flush=True)
    return launches, ms


def cell_flax_params(cell_impl: str, seed: int = 0) -> dict:
    """Random weights in the JAX model's flax tree for ``cell_impl`` concat,
    split or hybrid: lecun-normal kernels, zero biases."""
    rng = np.random.default_rng(seed)
    split_enc, split_dec = cell_impl in ("split", "hybrid"), cell_impl == "split"

    def conv(cin, cout, bias=True):
        out = {"kernel": lecun_normal(rng, (3, 3, cin, cout))}
        if bias:
            out["bias"] = np.zeros(cout, np.float32)
        return out

    def cell(cx, split, x_gates=True):
        if not split:
            return {"gates": conv(cx + HIDDEN, 4 * HIDDEN)}
        out = {"h_gates": conv(HIDDEN, 4 * HIDDEN, bias=False)}
        if x_gates:
            out["x_gates"] = conv(cx, 4 * HIDDEN)
        return out

    params = {
        "encoder": {"encoder_1": cell(CIN, split_enc, x_gates=False),
                    "encoder_2": cell(HIDDEN, split_enc)},
        "decoder": {"decoder_1": cell(HIDDEN, split_dec), "decoder_2": cell(HIDDEN, split_dec),
                    "head": conv(HIDDEN, COUT)},
    }
    if split_enc:
        params["encoder_input_gates"] = {"x_gates": conv(CIN, 4 * HIDDEN)}
    return {"params": params}


def cells_path(torch, card):
    """Phase 20: concat, split and hybrid served, split trained. Returns ({
    cell_impl: K3 launches serving}, K3 launches training, {cell_impl: model},
    the split train model, its trainer and batch)."""
    from satflow_tpu_torch.interop.jax_weights import params_from_flax
    from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates, fused_lstm_gates_ref
    from satflow_tpu_torch.serve import InferenceSession

    served, models = {}, {}
    requests = convlstm_requests()
    for impl in ("concat", "split", "hybrid"):
        model = EncoderDecoderConvLSTM(hidden_dim=HIDDEN, input_channels=CIN, out_channels=COUT,
                                       forecast_steps=STEPS, cell_impl=impl)
        session = InferenceSession(model, max_batch=B, variables=cell_flax_params(impl),
                                   dtype=torch.bfloat16, device=DEVICE)
        reset_k3_paths(fused_lstm_gates)
        replies, wall, forwards, (k3, k1) = drive_server(session, requests,
                                                         [fused_lstm_gates, fused_convlstm_step])
        check_k3_paths(fused_lstm_gates, k3, f"{impl} serving")
        check_frames(requests, replies, f"{impl} serving")
        if forwards < 1 or (k3, k1) != (K3_PER_FORWARD * forwards, 0):
            fail(f"{impl} serving launched K3 {k3} and K1 {k1} times in {forwards} forwards, "
                 f"expected {K3_PER_FORWARD} x {forwards} and 0")
        with torch.inference_mode():
            x0 = torch.from_numpy(requests[0][None]).to(DEVICE, torch.bfloat16)
            ref = model(x0, gate_tail=fused_lstm_gates_ref).float().cpu().numpy()[0]
        diff = float(np.abs(ref - replies[0][1]).max())
        if not diff <= TOL_ROLLOUT:
            fail(f"{impl} reply vs the forward through K3's plain version: max|diff| {diff:.3g} "
                 f"> {TOL_ROLLOUT}")
        print(f"cell_impl={impl} served {len(requests)} requests (6 samples) in {forwards} "
              f"forward(s) of b{B}, {wall:.3f} s wall; launches K3 {k3} = {K3_PER_FORWARD} x "
              f"{forwards} (all on its vector kernel), K1 {k1}; reply vs the same forward through K3's plain version "
              f"max|diff| {diff:.3g} <= {TOL_ROLLOUT} ok [{card}]", flush=True)
        served[impl], models[impl] = k3, model
        del session

    train_model = EncoderDecoderConvLSTM(
        hidden_dim=HIDDEN, input_channels=CIN, out_channels=COUT, forecast_steps=STEPS,
        cell_impl="split", remat=True, remat_chunk=REMAT_CHUNK)
    train_model.module.load_state_dict(params_from_flax(cell_flax_params("split")))
    # forward + the remat recompute; the gate tail's backward is the f32 chain, no kernel
    (t_k3,), trainer, batch = fit_one_step(torch, train_model, [fused_lstm_gates],
                                           (2 * K3_PER_FORWARD,), "cell_impl=split", card)
    if t_k3 != 3 * K3_PER_FORWARD:
        fail(f"the split fit launched K3 {t_k3} times")
    compare_step_grads(torch, train_model, batch, {}, dict(gate_tail=fused_lstm_gates_ref),
                       "cell_impl=split", card)
    return served, t_k3, models, train_model, trainer, batch


CELL_CLASSES = {"K3": K3_KERNELS, "library convs": LIBRARY_CONVS,
                "optimizer": OPTIMIZER}
HALO_CLASSES = {"K1h": ("fused_convlstm_step_halo_kernel",),
                "halo gathers (cat / stack copies)": ("catarray",),
                "library convs": LIBRARY_CONVS}


def new_kernel_timings(torch, fused_model, cell_models, split_train, card):
    """Phase 21; returns {kernel: times with "bound"}."""
    from satflow_tpu_torch.ops import fused_convlstm_step as P
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates_ref
    from satflow_tpu_torch.tools import exp_cmajor as XC
    from satflow_tpu_torch.tools import exp_tap9 as XT
    from satflow_tpu_torch.train.steps import make_train_step

    times = {}
    ops = 2 * B * H * W * 4 * HIDDEN * 9 * (HIDDEN + HIDDEN)  # the gate contraction, Cx=64

    def report(name, what, t, flop, extra=""):
        print(f"time per {name} ({what}) call, bf16 B={B} {H}x{W} Cx={HIDDEN} Ch={HIDDEN}: kernel "
              f"{t['kernel']:.4f} ms ({flop / t['kernel'] / 1e9:.1f} TFLOP/s), plain "
              f"{t['plain']:.4f} ms; bound {t['bound'][0]:.4f} ms by {t['bound'][1]} "
              f"({100 * t['bound'][0] / t['kernel']:.1f} % reached){extra} [{card}]", flush=True)

    # K1h: the wrapper's call is the two gathers plus the kernel
    args = step_inputs(torch, HIDDEN, torch.bfloat16, seed=900)
    t = per_call_ms(torch, P.fused_convlstm_step_halo, P.fused_convlstm_step_halo_ref, args, n=10)
    with torch.no_grad():
        gathers = lambda: (P.build_halo(args[0], HALO_BLOCK_H),  # noqa: E731
                           P.build_halo(args[1], HALO_BLOCK_H))
        cuda_ms(torch, gathers, 3)
        t["gather"] = cuda_ms(torch, gathers, 20)
        halos = gathers()
    t["bound"] = bound_ms(args + halos + (args[2], args[2]), ops, "bf16")
    times["K1h"] = t
    report("K1h", "halo-tensor step, with its two gathers", t, ops,
           f"; the two build_halo gathers alone {t['gather']:.4f} ms")

    pargs = padded_inputs(torch, HIDDEN, torch.bfloat16, seed=901)
    for name, what, fn, ref in (("K1p", "the JAX main kernel's order, K1's epilogue", XT.step_padded,
                                 XT.step_padded_ref),
                                ("T1", "tap-major step, K1's order", XT.step_tap9, XT.step_tap9_ref),
                                ("T2", "step without gate math", XT.step_nogate,
                                 XT.step_nogate_ref)):
        t = per_call_ms(torch, fn, ref, pargs, n=5)
        # one weight tensor's worth of bytes (w9 or w3 is a re-laid copy of wx, wh)
        t["bound"] = bound_ms(pargs + (pargs[1], pargs[2]), ops, "bf16")
        times[name] = t
        report(name, what + ", W-padded I/O", t, ops)

    t3, _ = exp_cmajor_inputs(torch, torch.bfloat16, seed=902)
    t = per_call_ms(torch, lambda *a: XC.cmajor_step(*a, HALO_BLOCK_H, H, W),
                    lambda *a: XC.cmajor_step_ref(*a, HALO_BLOCK_H, H, W), t3, n=5)
    t["bound"] = bound_ms(t3 + (t3[1], t3[2]), ops, "bf16")  # the carries with their pad rows
    times["T3"] = t
    report("T3", f"pad-row channel-major step, block_h {HALO_BLOCK_H}", t, ops)

    x = torch.from_numpy(np.random.default_rng(2).random((B, T, H, W, CIN), dtype=np.float32))
    x = x.to(DEVICE, torch.bfloat16)

    def forward_under(variant):
        def run():
            with step_variant(variant):
                return fused_model(x)
        return run

    forwards = {"fused, 3pass (K1)": forward_under("3pass"),
                "fused, halo (K1h)": forward_under("halo")}
    for impl, model in cell_models.items():
        forwards[f"{impl} (K3)"] = lambda model=model: model(x)
        forwards[f"{impl} (K3's plain version)"] = (
            lambda model=model: model(x, gate_tail=fused_lstm_gates_ref))
    runs = {name: [] for name in forwards}
    peaks = {}
    with torch.inference_mode():
        for name, fn in forwards.items():
            torch.cuda.reset_peak_memory_stats()
            fn()  # warm-up
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        order = list(forwards)
        for name in order + order[::-1]:
            runs[name].append(cuda_ms(torch, forwards[name], 2))
        for name, r in runs.items():
            ms = sum(r) / len(r)
            print(f"b{B} forward ({T} in, {STEPS} out, {H}x{W}x{CIN}, bf16) through the {name} "
                  f"rollout: {ms:.2f} ms, {B * STEPS / (ms / 1e3):.1f} frames/s (runs "
                  f"{', '.join(f'{v:.2f}' for v in r)} ms); peak device memory {peaks[name]:.2f} "
                  f"GiB [{card}]", flush=True)
        print_profile(f"b{B} forward through the fused, halo (K1h) rollout",
                      device_time_by_class(torch, forwards["fused, halo (K1h)"], HALO_CLASSES),
                      card)
        for impl in ("concat", "split"):
            print_profile(f"b{B} forward through the {impl} (K3) rollout",
                          device_time_by_class(torch, forwards[f"{impl} (K3)"], CELL_CLASSES),
                          card)

    model, trainer, batch = split_train
    steps = {"kernel": make_train_step(model),
             "plain": make_train_step(model, gate_tail=fused_lstm_gates_ref)}
    step_runs, step_peaks = timed_train_steps(torch, steps, trainer.state, batch)
    for name, through in (("kernel", "K3"), ("plain", "K3's plain version")):
        ms = sum(step_runs[name]) / len(step_runs[name])
        print(f"b{B} train step, cell_impl=split (bf16, {T} in / {STEPS} out, {H}x{W}x{CIN}, "
              f"remat_chunk {REMAT_CHUNK}, Adam) through {through}: "
              f"{ms:.2f} ms, {B * STEPS / (ms / 1e3):.1f} frames/s (runs "
              f"{', '.join(f'{r:.2f}' for r in step_runs[name])} ms); peak device memory "
              f"{step_peaks[name]:.2f} GiB [{card}]", flush=True)
    print_profile(f"b{B} train step, cell_impl=split",
                  device_time_by_class(torch, lambda: steps["kernel"](trainer.state, batch),
                                       CELL_CLASSES), card)
    return times


# a kernel template's instantiation in a mangled name: (type, hidden width)
INSTANCE = re.compile(r"kernelI(13__nv_bfloat16|f)Li(\d+)E")


def sass_ops(_build, name: str, key) -> dict:
    """{key(header line): {op: count}} over the functions in library ``name``'s
    SASS (``cuobjdump``) whose ``Function :`` line ``key`` maps to something true."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", _build.load(name)._name],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass of {name} failed: {out.stderr.strip()[:500]}")
    per_function, function = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            function = key(line)
            if function:
                per_function[function] = {"HMMA": 0, "IMMA": 0, "LDSM": 0, "LDGSTS": 0,
                                          "FFMA": 0}
        elif function:
            for op in per_function[function]:
                if f" {op}" in line:
                    per_function[function][op] += 1
    return per_function


def check_sass(_build, card) -> dict:
    """Phase 2, the machine code of K1, K2, K1h (hidden 8 to 256) and K6a (8
    to 128): every bfloat16 instantiation contracts on the tensor cores (HMMA
    instructions in its SASS) and no float32 one does. Returns {(library,
    hidden width): HMMA count} of the bfloat16 kernels."""
    def instance(line):
        m = INSTANCE.search(line)
        return m and (m.group(1) != "f", int(m.group(2)))

    counts = {}
    for name, n in (("fused_convlstm_step", 12), ("fused_convlstm_step_bwd", 12),
                    ("fused_convlstm_step_halo", 12), ("cmajor_convlstm", 10)):
        per_function = sass_ops(_build, name, instance)
        if len(per_function) != n:
            fail(f"{name}: expected {n} instantiations in the SASS, found {sorted(per_function)}")
        for (bf16, ch), ops in sorted(per_function.items()):
            if bf16 != (ops["HMMA"] > 0):
                fail(f"{name} {'bf16' if bf16 else 'f32'} Ch={ch}: {ops['HMMA']} HMMA instructions")
            if bf16:
                counts[name, ch] = ops["HMMA"]
            print(f"  SASS {name} ({'bf16' if bf16 else 'f32'}, Ch={ch}): "
                  + ", ".join(f"{op} {n}" for op, n in ops.items()) + f" [{card}]", flush=True)
    return counts


def check_sass_redesign(_build, card) -> dict:
    """Phase 2, the machine code of K4 and K6b: the bfloat16 tensor-core
    kernels (``axial_attention_mma_kernel``, ``cmajor_conv_mma_kernel``) hold
    HMMA and LDSM instructions, and no other kernel of K4 or K6b (the rows and
    tile kernels, the float32 head) holds an HMMA. Returns {library: HMMA count}."""
    totals = {}
    for name, fragment in (("axial_attention", "axial_attention_"),
                           ("cmajor_convlstm", "cmajor_conv_")):
        def kernel_name(line):
            m = re.search(rf"\d+({fragment}\w*?kernel)(\w*)", line)
            return m and m.group(1) + " " + m.group(2)[:40]

        per_function = sass_ops(_build, name, kernel_name)
        mma = [f for f in per_function if "_mma_kernel" in f]
        if not mma:
            fail(f"{name}: no tensor-core kernel in the SASS: {sorted(per_function)}")
        for function, ops in sorted(per_function.items()):
            if ("_mma_kernel" in function) != (ops["HMMA"] > 0) or (
                    "_mma_kernel" in function and ops["LDSM"] == 0):
                fail(f"{name} {function}: {ops['HMMA']} HMMA and {ops['LDSM']} LDSM instructions")
            print(f"  SASS {name} {function}: "
                  + ", ".join(f"{op} {n}" for op, n in ops.items()) + f" [{card}]", flush=True)
        totals[name] = sum(per_function[f]["HMMA"] for f in mma)
    return totals


def check_sass_int8_t3(_build, card) -> dict:
    """Phase 2, the machine code of K5 and T3: every instantiation of K5 (its
    step with c in float32 and in bfloat16, and its sums, hidden 8 to 128)
    holds IMMA (int8 tensor-core) instructions and no HMMA; T3's bfloat16
    kernel holds HMMA at every width and its float32 kernel none. Returns
    {(kernel, kind, width): IMMA or HMMA count}."""
    def k5(line):
        m = re.search(r"(step_int8_kernelI(13__nv_bfloat16|f)|int8_sums_kernelI)Li(\d+)E", line)
        kind = m and ("sums" if "sums" in m.group(1) else "f32" if m.group(2) == "f" else "bf16")
        return m and (kind, int(m.group(3)))

    def t3(line):
        m = re.search(r"exp_cmajor_(mma|step)_kernelILi(\d+)E", line)
        return m and ("bf16" if m.group(1) == "mma" else "f32", int(m.group(2)))

    counts = {}
    for name, what, key, n in (("fused_convlstm_int8", "K5", k5, 15),
                               ("exp_cmajor", "T3", t3, 10)):
        per_function = sass_ops(_build, name, key)
        if len(per_function) != n:
            fail(f"{name}: expected {n} instantiations in the SASS, found {sorted(per_function)}")
        for (kind, ch), ops in sorted(per_function.items()):
            if what == "K5":
                ok = ops["IMMA"] > 0 and ops["HMMA"] == 0
            else:
                ok = (kind == "bf16") == (ops["HMMA"] > 0) and ops["IMMA"] == 0
            if not ok:
                fail(f"{what} {kind} Ch={ch}: {ops['IMMA']} IMMA and {ops['HMMA']} HMMA instructions")
            counts[what, kind, ch] = ops["IMMA"] + ops["HMMA"]
            print(f"  SASS {name} ({what} {kind}, Ch={ch}): "
                  + ", ".join(f"{op} {v}" for op, v in ops.items()) + f" [{card}]", flush=True)
    return counts


# a study kernel's instantiation: padded_mma_kernel<CH, row order, gates> (bf16)
# or padded_step_kernel<float, CH, tap-major, gates> (f32)
STUDY_INSTANCE = re.compile(r"padded_(mma|step)_kernelI(?:f)?Li(\d+)ELb([01])ELb([01])E")


def check_sass_tap9(_build, card) -> dict:
    """Phase 2, the machine code of T1, T2 and K1p: every bfloat16
    instantiation (hidden 8 to 128) holds HMMA instructions, T2's as many as
    K1p's and T1's at each width (its epilogue reads half of the sums, the
    contraction must stay whole), and no float32 one holds any. Returns
    {(kernel, width): HMMA count} of the bfloat16 kernels."""
    def study(line):
        m = STUDY_INSTANCE.search(line)
        if not m:
            return None
        bf16, flag, gates = m.group(1) == "mma", m.group(3) == "1", m.group(4) == "1"
        row_order = flag if bf16 else not flag  # the f32 kernel's flag is "tap-major"
        what = "T2" if not gates else "K1p" if row_order else "T1"
        return "bf16" if bf16 else "f32", what, int(m.group(2))

    per_function = sass_ops(_build, "exp_tap9", study)
    if len(per_function) != 30:
        fail(f"exp_tap9: expected 30 instantiations in the SASS, found {sorted(per_function)}")
    counts = {}
    for (kind, what, ch), ops in sorted(per_function.items()):
        if (kind == "bf16") != (ops["HMMA"] > 0):
            fail(f"{what} {kind} Ch={ch}: {ops['HMMA']} HMMA instructions")
        if kind == "bf16":
            counts[what, ch] = ops["HMMA"]
        print(f"  SASS exp_tap9 ({what} {kind}, Ch={ch}): "
              + ", ".join(f"{op} {n}" for op, n in ops.items()) + f" [{card}]", flush=True)
    for ch in (8, 16, 32, 64, 128):
        if not counts["T2", ch] == counts["K1p", ch] == counts["T1", ch]:
            fail(f"exp_tap9 Ch={ch}: HMMA counts T1 {counts['T1', ch]}, T2 {counts['T2', ch]}, "
                 f"K1p {counts['K1p', ch]} differ: a contraction lost some of its products")
    return counts


def eval_slice(torch, card):
    """Phase 23: ``evaluate_model`` on the full-width ConvLSTM (bf16,
    ``cell_impl="fused"``) through K1 and through the plain step; returns K1's
    launches in the counted run."""
    from satflow_tpu_torch.data import AdvectionDataset
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.eval.evaluate import batch_metrics, evaluate_model
    from satflow_tpu_torch.interop.jax_weights import params_from_flax
    from satflow_tpu_torch.models import EncoderDecoderConvLSTM
    from satflow_tpu_torch.ops.fused_convlstm_step import (
        fused_convlstm_step,
        fused_convlstm_step_ref,
    )
    from satflow_tpu_torch.ops.ssim import ms_ssim, ssim

    model = EncoderDecoderConvLSTM(hidden_dim=HIDDEN, input_channels=CIN, out_channels=COUT,
                                   forecast_steps=STEPS, cell_impl="fused")
    model.module.load_state_dict(params_from_flax(flax_params(0)))
    model.to(DEVICE)
    model.set_compute_dtype(torch.bfloat16)
    ds = AdvectionDataset(batch_size=B, width=W, height=H, number_sat_channels=CIN,
                          history_minutes=5 * (T - 1), forecast_minutes=5 * STEPS,
                          length=EVAL_BATCHES)
    batches = [to_device(ds[i], torch.device(DEVICE)) for i in range(EVAL_BATCHES)]
    torch.cuda.synchronize()

    fused_convlstm_step.launches = 0
    t0 = time.perf_counter()
    got = evaluate_model(model, batches, compute_ms_ssim=True)
    wall_kernel = time.perf_counter() - t0
    launches = fused_convlstm_step.launches
    t0 = time.perf_counter()
    want = evaluate_model(model, batches, compute_ms_ssim=True, step=fused_convlstm_step_ref)
    wall_plain = time.perf_counter() - t0
    if launches != LAUNCHES_PER_FORWARD * EVAL_BATCHES or fused_convlstm_step.launches != launches:
        fail(f"eval launched K1 {launches} times ({fused_convlstm_step.launches} after the plain "
             f"run), expected {LAUNCHES_PER_FORWARD} x {EVAL_BATCHES} batches and none plain")
    shapes = {"mse": (COUT, STEPS), "ssim": (STEPS,), "ms_ssim": (STEPS,)}
    for key, shape in shapes.items():
        for name, res in (("K1", got), ("plain", want)):
            if res[key].shape != shape or not np.isfinite(res[key]).all():
                fail(f"eval {key} through {name}: shape {res[key].shape}, expected {shape}, "
                     f"or not finite")
    mse_err = np.abs(got["mse"] - want["mse"])
    if not (mse_err <= TOL_EVAL_MSE["atol"] + TOL_EVAL_MSE["rtol"] * np.abs(want["mse"])).all():
        fail(f"eval MSE curves, K1 vs plain: max|diff| {mse_err.max():.3g} beyond {TOL_EVAL_MSE}")
    for key in ("ssim", "ms_ssim"):
        err = np.abs(got[key] - want[key]).max()
        if not err <= TOL_EVAL_SSIM:
            fail(f"eval {key} curves, K1 vs plain: max|diff| {err:.3g} > {TOL_EVAL_SSIM}")
    print(f"eval of the full-width ConvLSTM (b{B}, {T} x {H}x{W}x{CIN} in, {STEPS} out, bf16, "
          f"fused; {EVAL_BATCHES} advection batches): K1 launches {launches} = "
          f"{LAUNCHES_PER_FORWARD} x {EVAL_BATCHES}; mse_mean {got['mse_mean']:.6g} (plain "
          f"{want['mse_mean']:.6g}), ssim_mean {got['ssim_mean']:.6g} ({want['ssim_mean']:.6g}), "
          f"ms_ssim_mean {got['ms_ssim_mean']:.6g} ({want['ms_ssim_mean']:.6g}); curves within "
          f"MSE {TOL_EVAL_MSE}, SSIM / MS-SSIM {TOL_EVAL_SSIM} (max|diff| MSE {mse_err.max():.3g}, "
          f"SSIM {np.abs(got['ssim'] - want['ssim']).max():.3g}, MS-SSIM "
          f"{np.abs(got['ms_ssim'] - want['ms_ssim']).max():.3g}) ok; evaluate_model wall "
          f"{wall_kernel:.3f} s through K1, {wall_plain:.3f} s plain [{card}]", flush=True)
    print("eval per-lead MS-SSIM through K1: "
          + ", ".join(f"{v:.4f}" for v in got["ms_ssim"]) + f" [{card}]", flush=True)

    model.eval()
    with torch.no_grad():
        x, y = model.eval_batch(batches[0])
        y_kernel = model(x)
        y_plain = model(x, step=fused_convlstm_step_ref)
        between = [ms_ssim(y_kernel[:, i], y_plain[:, i]).item() for i in range(STEPS)]
        if not min(between) >= MIN_ROLLOUT_MS_SSIM:
            fail(f"MS-SSIM of the K1 rollout against the plain one: min {min(between):.4f} < "
                 f"{MIN_ROLLOUT_MS_SSIM}")
        print("MS-SSIM of the K1 rollout against the plain-step rollout, per lead time "
              f"(batch 0): " + ", ".join(f"{v:.5f}" for v in between) + f"; min "
              f"{min(between):.5f} >= {MIN_ROLLOUT_MS_SSIM} ok [{card}]", flush=True)
        def per_lead():  # the same curves by one ssim and one ms_ssim call a lead time
            return [(ssim(y_kernel[:, i], y[:, i]), ms_ssim(y_kernel[:, i], y[:, i]))
                    for i in range(STEPS)]

        fns = {"forward": lambda: model(x),
               "metrics": lambda: batch_metrics(y_kernel, y, True),
               "metrics without MS-SSIM": lambda: batch_metrics(y_kernel, y, False),
               "metrics a call per lead time": per_lead}
        runs = {name: [] for name in fns}
        for fn in fns.values():
            cuda_ms(torch, fn, 1)  # warm-up
        for name in list(fns) + list(fns)[::-1]:
            runs[name].append(cuda_ms(torch, fns[name], 2))
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    print(f"eval per batch (b{B}, {STEPS} lead times, {H}x{W}x{COUT}): forward through K1 "
          f"{ms['forward']:.2f} ms, metrics {ms['metrics']:.2f} ms (MSE, SSIM and MS-SSIM per "
          f"lead time, all lead times in one pass; {ms['metrics without MS-SSIM']:.2f} ms "
          f"without MS-SSIM; SSIM and MS-SSIM by a call per lead time "
          f"{ms['metrics a call per lead time']:.2f} ms), each the mean of 2 runs of 2 calls "
          f"[{card}]", flush=True)
    return launches, ms


class SameMask:
    """Trainer callback: reseeds MetNet's temporal-dropout generator before
    every train step, so that each step draws the first step's mask."""

    def __init__(self, gen, seed: int = 0):
        self.gen, self.seed = gen, seed

    def on_train_start(self, engine) -> None:
        self.gen.manual_seed(self.seed)

    def on_train_batch_end(self, engine, metrics, step) -> None:
        self.gen.manual_seed(self.seed)

    def on_validation_end(self, engine, metrics, epoch) -> None: ...

    def on_preemption(self, engine) -> None: ...

    def on_train_end(self, engine) -> None: ...


def metnet_ssim_slice(torch, card):
    """Phase 24: metnet_ssim.yaml trains through K3 and K4 on the SSIM loss;
    returns (K3 launches, K4 launches, {loss: step ms})."""
    from satflow_tpu_torch.data import AdvectionDataset, SatFlowDataModule
    from satflow_tpu_torch.nn.losses import get_loss
    from satflow_tpu_torch.ops.axial_attention import axial_attention
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.steps import make_train_step

    gen = torch.Generator()
    model = _metnet(torch, loss="ssim", generator=gen, warmup_steps=0, total_steps=100_000)
    if model.loss_name != "ssim":
        fail(f"metnet_ssim built the loss {model.loss_name!r}")
    model.module.load_state_dict(model.state_dict_from_flax(
        metnet_flax_variables(4 * MN_TRAIN_CIN + MN_F, seed=2)))

    class AdvectionDM(SatFlowDataModule):
        """b8 256x256 advection in the fake schema: 12 satellite channels,
        topography and 10 NWP fields (23 in), 24 future frames."""

        def _dataset(self, split, n):
            return AdvectionDataset(batch_size=B, width=W, height=H, number_sat_channels=MN_CIN,
                                    history_minutes=5 * (T - 1), forecast_minutes=5 * MN_F,
                                    length=1)

    dm = AdvectionDM(fake_data=True, num_workers=0)
    counter = LaunchesPerStep(fused_lstm_gates, axial_attention)
    # one batch, SSIM_STEPS epochs of one step and one validation forward each
    trainer = Trainer(max_epochs=SSIM_STEPS, overfit_batches=1, precision="bf16",
                      log_every_n_steps=1, device=DEVICE, callbacks=[counter, SameMask(gen)])
    fused_lstm_gates.launches = axial_attention.launches = 0
    t0 = time.perf_counter()
    trainer.fit(model, dm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3, k4 = fused_lstm_gates.launches, axial_attention.launches
    losses = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
    if trainer.global_step != SSIM_STEPS or len(losses) != SSIM_STEPS:
        fail(f"metnet_ssim fit took {trainer.global_step} steps and logged {len(losses)} losses")
    if not (all(np.isfinite(losses)) and all(b < a for a, b in zip(losses, losses[1:]))):
        fail(f"metnet_ssim losses not finite and decreasing: {losses}")
    want_step = (MN_K3_PER_FORWARD, MN_K4_PER_FORWARD)
    if counter.per_step != [want_step] * SSIM_STEPS:
        fail(f"metnet_ssim (K3, K4) launches per step {counter.per_step}, expected {want_step}")
    # every epoch: one train step and one validation forward
    if (k3, k4) != (2 * SSIM_STEPS * MN_K3_PER_FORWARD, 2 * SSIM_STEPS * MN_K4_PER_FORWARD):
        fail(f"metnet_ssim fit launched K3 {k3} and K4 {k4} times")
    print(f"metnet_ssim (metnet_ssim.yaml: hidden {MN_HIDDEN}, {MN_F} lead times, loss ssim, "
          f"channel-aware, nonnegative, range-converted) trained {SSIM_STEPS} bf16 Adam steps on "
          f"one b{B} {H}x{W}x{MN_TRAIN_CIN} advection batch in {wall:.2f} s wall: losses "
          + ", ".join(f"{v:.6f}" for v in losses) + f" (finite, decreasing); launches per step "
          f"K3 {want_step[0]}, K4 {want_step[1]}; fit total K3 {k3}, K4 {k4} (with {SSIM_STEPS} "
          f"validation forwards) [{card}]", flush=True)

    batch = trainer.last_batch
    # the key biases' zero gradients are bf16 rounding noise of 1.2-1.6e-3 x
    # their weight's under the SSIM loss (measured in bf16 on a CPU at 64 px, b2)
    compare_metnet_grads(torch, model, batch, gen, "metnet_ssim train step", card,
                         zero_tol=1e-2)

    # one train step under the SSIM criterion and under metnet.yaml's mse, in turns
    criteria = {"ssim": model.criterion, "mse": get_loss("mse")}
    step = make_train_step(model)
    runs = {"mse": [], "ssim": []}
    for name in ("mse", "ssim") + ("ssim", "mse", "mse", "ssim"):
        model.criterion = criteria[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(trainer.state, batch)
        torch.cuda.synchronize()
        runs[name].append((time.perf_counter() - t0) * 1e3)
    model.criterion = criteria["ssim"]
    step_ms = {k: sum(v[1:]) / len(v[1:]) for k, v in runs.items()}  # the first is a warm-up
    print(f"MetNet b{B} train step (bf16, K3 + K4, {H}x{W}x{MN_TRAIN_CIN}, {MN_F} lead times): "
          f"ssim loss {step_ms['ssim']:.2f} ms, mse loss {step_ms['mse']:.2f} ms (runs ssim "
          + ", ".join(f"{v:.2f}" for v in runs["ssim"][1:]) + "; mse "
          + ", ".join(f"{v:.2f}" for v in runs["mse"][1:]) + f" ms) [{card}]", flush=True)
    return k3, k4, step_ms


def _gate_counts(frames: int, steps: int, train_steps: int, forwards: int):
    """(K1, K2) launches of a ConvLSTM fit with per-step remat plus
    ``forwards`` forwards: every train step runs each cell step forward, once
    more in its recompute, and backward once."""
    per_forward = 2 * frames + 2 * steps
    return 2 * per_forward * train_steps + per_forward * forwards, per_forward * train_steps


def gate_slice(torch, card):
    """Phase 25: the accuracy gate on the card; returns (K1, K2) launches of
    (a) and (b) together and the gate's times."""
    from satflow_tpu_torch.baseline import run_baseline
    from satflow_tpu_torch.data.datamodule import SatFlowDataModule
    from satflow_tpu_torch.data.fake import DecayingAdvectionDataset
    from satflow_tpu_torch.eval import evaluate_model
    from satflow_tpu_torch.models import create_model
    from satflow_tpu_torch.ops.flow import farneback_backend
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step, gate_bwd
    from satflow_tpu_torch.tools import accuracy_gate
    from satflow_tpu_torch.train import Trainer

    solve = farneback_backend()
    print(f"farneback_flow resolves to: {solve} "
          f"({'OpenCV Farneback' if solve == 'opencv' else 'no cv2 here: Horn-Schunck'})",
          flush=True)

    # (a) tests/test_accuracy.py's geometry
    class DecayDM(SatFlowDataModule):
        def __init__(self):
            super().__init__(fake_data=True, num_workers=0, shard=False)

        def _dataset(self, split, n):
            return DecayingAdvectionDataset(length=GATE_LEN,
                                            seed=accuracy_gate.SPLIT_SEEDS[split], **GATE_KW)

    eval_ds = DecayingAdvectionDataset(length=2, seed=300, **GATE_KW)
    t0 = time.perf_counter()
    flows = {m: run_baseline(eval_ds, forecast_steps=GATE_STEPS, flow_method=m, max_batches=2,
                             device=DEVICE) for m in ("farneback", "horn_schunck")}
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    persist = float(np.mean(flows["farneback"]["baseline_loss"]))
    model = create_model("encoderdecoderconvlstm", input_channels=1, out_channels=1,
                         forecast_steps=GATE_STEPS, hidden_dim=16, lr=5e-3,
                         generator=torch.Generator().manual_seed(0))
    trainer = Trainer(max_epochs=GATE_EPOCHS, log_every_n_steps=50, device=DEVICE)
    fused_convlstm_step.launches = gate_bwd.launches = 0
    t0 = time.perf_counter()
    trainer.fit(model, DecayDM())
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    curves = evaluate_model(model, eval_ds, max_batches=2, compute_ms_ssim=False)
    k1, k2 = fused_convlstm_step.launches, gate_bwd.launches
    frames = GATE_KW["history_minutes"] // 5 + 1
    want = _gate_counts(frames, GATE_STEPS, GATE_EPOCHS * GATE_LEN,
                        GATE_EPOCHS * GATE_LEN + 2)
    if (k1, k2) != want:
        fail(f"gate (a) launched K1 {k1}, K2 {k2}; expected {want} (every cell step a launch)")
    mse = curves["mse_mean"]
    arms = {"persistence": persist, **{f"flow ({m})": res["flow_mean"]
                                       for m, res in flows.items()}}
    print(f"accuracy gate (a), tests/test_accuracy.py's geometry (16x16, 1 channel, hidden 16, "
          f"{GATE_STEPS} lead times, {GATE_EPOCHS} epochs, decay 0.8, float32): trained ConvLSTM "
          f"mean MSE {mse:.6g} vs " + ", ".join(f"{k} {v:.6g}" for k, v in arms.items())
          + f"; training {train_s:.2f} s wall, baselines {base_s:.2f} s; launches K1 {k1}, "
          f"K2 {k2} [{card}]", flush=True)
    if not (np.isfinite(mse) and all(mse < v for v in arms.values())):
        fail(f"the port-trained ConvLSTM ({mse:.6g}) does not beat {arms}")

    # (b) tools/accuracy_gate.py's baselines and ConvLSTM arm through the port's tool
    fused_convlstm_step.launches = gate_bwd.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # its JSON line is reprinted below
        res = accuracy_gate.main(["baselines", "convlstm"], device=DEVICE)
    gate_s = time.perf_counter() - t0
    k1b, k2b = fused_convlstm_step.launches, gate_bwd.launches
    epochs = accuracy_gate.CONVLSTM_EPOCHS
    batches = 12  # the tool's DecayDM: 12 batches a split
    want = _gate_counts(accuracy_gate.DS_KW["history_minutes"] // 5 + 1, accuracy_gate.STEPS,
                        epochs * batches, epochs * batches + 3)
    if (k1b, k2b) != want:
        fail(f"gate (b) launched K1 {k1b}, K2 {k2b}; expected {want}")
    rows = ("persistence", "optical_flow", "optical_flow_hs", "convlstm")
    for row in rows:
        if len(res[row]["mse_t"]) != accuracy_gate.STEPS or not np.isfinite(res[row]["mse_t"]).all():
            fail(f"gate (b) {row}: curve {res[row]['mse_t']}")
    print(f"accuracy gate (b), tools/accuracy_gate.py's ConvLSTM arm (32x32, 2 channels, hidden "
          f"32, lr 3e-3, {epochs} epochs, {accuracy_gate.STEPS} lead times, float32) through "
          f"satflow_tpu_torch.tools.accuracy_gate: {gate_s:.2f} s wall (training "
          f"{res['convlstm']['train_seconds']:.2f} s); launches K1 {k1b}, K2 {k2b} [{card}]",
          flush=True)
    print("  mean MSE (this run | the JAX study's, docs/ACCURACY.md): " + ", ".join(
        f"{row} {res[row]['mse']:.5f} | {JAX_STUDY[row]:.5f}" for row in rows)
        + f"; convlstm MS-SSIM {res['convlstm']['ms_ssim']:.4f} | "
        f"{JAX_STUDY['convlstm_ms_ssim']:.4f}; optical_flow solved by "
        f"{res['optical_flow']['solve']}", flush=True)
    for t in range(accuracy_gate.STEPS):
        print(f"  lead {t}: MSE " + ", ".join(f"{row} {res[row]['mse_t'][t]:.5f}" for row in rows)
              + f"; convlstm MS-SSIM {res['convlstm']['ms_ssim_t'][t]:.4f}", flush=True)
    return k1 + k1b, k2 + k2b, {"a_train_s": train_s, "b_s": gate_s}


# Phases 26-28: the lifecycle of a trained model (checkpoints, resume, the
# local: source, the profiler, preemption and the probes). Phase 26 runs the
# repo's default training config at full width: the ConvLSTM of phase 8
# (convlstm.yaml, bf16 on f32 weights, remat_chunk=6) on fake b8 256x256 data.
LIFE_STEPS, LIFE_RESUMED = 4, 2  # steps before the checkpoint, and after it
# The resumed run against the uninterrupted one from the same weights, on the
# same batches: cuDNN runs deterministic algorithms in this phase, so the
# weights must agree bit for bit.
MN_LIFE_STEPS, MN_LIFE_RESUMED = 3, 2
SMALL_LIFE_HIDDEN, SMALL_LIFE_HW = 32, (64, 64)
PROFILE_TOP = 14


class StateAtStart:
    """Trainer callback: a copy of the train state as fit starts (after a
    resume has filled it)."""

    def __init__(self):
        self.state = None

    def on_train_start(self, engine) -> None:
        self.state = _clone_tree(engine.state.state_dict())

    def on_train_batch_end(self, engine, metrics, step) -> None: ...

    def on_validation_end(self, engine, metrics, epoch) -> None: ...

    def on_preemption(self, engine) -> None: ...

    def on_train_end(self, engine) -> None: ...


class LrPerStep(StateAtStart):
    """Trainer callback: the learning rate each step's update ran at."""

    def __init__(self):
        super().__init__()
        self.lrs = []

    def on_train_batch_end(self, engine, metrics, step) -> None:
        self.lrs.append(engine.state.optimizer.param_groups[0]["lr"])


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.detach().clone() if hasattr(tree, "detach") else tree


def _same_tree(torch, got, want, where: str) -> None:
    """Fail unless two state trees are equal bit for bit."""
    if isinstance(want, dict):
        if set(got) != set(want):
            fail(f"{where}: keys differ: {sorted(set(got) ^ set(want))[:5]}")
        for k in want:
            _same_tree(torch, got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            fail(f"{where}: {len(got)} entries, saved {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(torch, g, w, f"{where}[{i}]")
    elif isinstance(want, torch.Tensor):
        if not torch.equal(got.to(want.device), want):
            fail(f"{where}: differs from the saved tensor")
    elif got != want:
        fail(f"{where}: {got!r}, saved {want!r}")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def _hold_resumed(torch, resumed, straight, what: str, card) -> None:
    """Fail unless the resumed run's weights equal the uninterrupted run's
    bit for bit."""
    want = dict(straight.model.named_parameters())
    for n, p in resumed.model.named_parameters():
        if not torch.equal(p, want[n]):
            worst = (p.detach() - want[n].detach()).abs().max().item()
            fail(f"{what}: {n} differs from the uninterrupted run's by up to {worst:.3g}")
    print(f"{what}: weights equal to the uninterrupted run's bit for bit [{card}]", flush=True)


def lifecycle_slice(torch, card):
    """Phase 26; returns (K1 launches, K2 launches)."""
    import tempfile

    from satflow_tpu_torch.core.config import compose, default_config_dir
    from satflow_tpu_torch.core.utils import extras, seed_everything
    from satflow_tpu_torch.eval import evaluate
    from satflow_tpu_torch.experiments.train import instantiate, train
    from satflow_tpu_torch.models import create_model
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step, gate_bwd
    from satflow_tpu_torch.serve import InferenceSession
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.callbacks import ModelCheckpoint
    from satflow_tpu_torch.train.checkpoint import (
        load_model_from_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_lifecycle_")
    config = extras(compose(default_config_dir(), "config.yaml", [
        "callbacks=default", f"trainer.device={DEVICE}", "trainer.precision=bf16",
        f"trainer.max_steps={LIFE_STEPS}", "trainer.max_epochs=1", "trainer.log_every_n_steps=1",
        f"model.remat_chunk={REMAT_CHUNK}", f"datamodule.n_train_data={LIFE_STEPS}",
        "datamodule.n_val_data=1", f"datamodule.history_minutes={5 * (T - 1)}",
        f"datamodule.fake_kwargs.batch_size={B}", f"datamodule.fake_kwargs.width={W}",
        f"datamodule.fake_kwargs.height={H}", "datamodule.num_workers=4", "work_dir=null",
        "print_config=false"]))
    m = config["model"]
    if (m["hidden_dim"], m["input_channels"], m["out_channels"], m["forecast_steps"]) != (
            HIDDEN, CIN, COUT, STEPS):
        fail(f"convlstm.yaml is no longer the full-width model: {m}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # 1. the normal entry point on the default config (callbacks=default)
        fused_convlstm_step.launches = gate_bwd.launches = 0
        t0 = time.perf_counter()
        with contextlib.chdir(root):
            val_loss = train(config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = fused_convlstm_step.launches, gate_bwd.launches
        # LIFE_STEPS train steps, then one validation and one test forward
        want = (LIFE_STEPS * K1_PER_TRAIN_STEP + 2 * LAUNCHES_PER_FORWARD,
                LIFE_STEPS * K2_PER_TRAIN_STEP)
        if (k1, k2) != want:
            fail(f"the default config's run launched K1 {k1} and K2 {k2} times, expected {want}")
        for sub in ("checkpoints/best", "checkpoints/last", "artifacts/final"):
            if not os.path.exists(os.path.join(root, sub, "state.pt")):
                fail(f"the default config's run wrote no {sub}")
        last = os.path.join(root, "checkpoints", "last")
        saved = restore_checkpoint(last, map_location=DEVICE)
        if saved["step"] != LIFE_STEPS or val_loss is None or not np.isfinite(val_loss):
            fail(f"checkpoints/last holds step {saved['step']}, val/loss {val_loss}")
        print(f"python -m satflow_tpu_torch.run's train() on the default config (callbacks=default, "
              f"convlstm.yaml: hidden {HIDDEN}, {CIN} channels, {T} in / {STEPS} out; bf16, "
              f"remat_chunk {REMAT_CHUNK}, fake b{B} {H}x{W}): {LIFE_STEPS} steps, a validation "
              f"and a test batch in {wall:.2f} s wall with data generation; val/loss "
              f"{val_loss:.6f}; K1 {k1}, K2 {k2} launches; wrote checkpoints/best, "
              f"checkpoints/last (step {saved['step']}) and artifacts/final [{card}]", flush=True)

        # 2. resume from `last` for LIFE_RESUMED more steps, against the run
        # that goes straight through from the same weights (the seed's)
        def build():
            return instantiate(config["datamodule"]), instantiate(config["model"])

        trainer_kw = dict(precision="bf16", device=DEVICE, log_every_n_steps=1)
        dm, model = build()
        start, counter = StateAtStart(), LaunchesPerStep(fused_convlstm_step, gate_bwd)
        resumed = Trainer(max_steps=LIFE_STEPS + LIFE_RESUMED, resume_from_checkpoint=last,
                          callbacks=[start, counter,
                                     ModelCheckpoint(dirpath=os.path.join(root, "resumed"))],
                          **trainer_kw)
        fused_convlstm_step.launches = gate_bwd.launches = 0
        resumed.fit(model, dm)
        r1, r2 = fused_convlstm_step.launches, gate_bwd.launches
        _same_tree(torch, start.state, saved, "the resumed state")
        want_step = (K1_PER_TRAIN_STEP, K2_PER_TRAIN_STEP)
        if resumed.global_step != LIFE_STEPS + LIFE_RESUMED or counter.per_step != (
                [want_step] * LIFE_RESUMED):
            fail(f"resume ran to step {resumed.global_step} with (K1, K2) launches per step "
                 f"{counter.per_step}, expected {want_step} x {LIFE_RESUMED}")
        if (r1, r2) != (LIFE_RESUMED * K1_PER_TRAIN_STEP + LAUNCHES_PER_FORWARD,
                        LIFE_RESUMED * K2_PER_TRAIN_STEP):
            fail(f"the resumed fit launched K1 {r1} and K2 {r2} times")
        seed_everything(config["seed"])
        dm0, model0 = build()
        # no validation: nothing reads it, and its batch costs a host generation
        straight = Trainer(max_epochs=2, max_steps=LIFE_STEPS + LIFE_RESUMED,
                           check_val_every_n_epoch=3, **trainer_kw)
        fused_convlstm_step.launches = gate_bwd.launches = 0
        straight.fit(model0, dm0)
        s1, s2 = fused_convlstm_step.launches, gate_bwd.launches
        print(f"resumed from checkpoints/last (step {LIFE_STEPS}): the restored state equals the "
              f"saved one bit for bit (weights, Adam's moments, step); {LIFE_RESUMED} more steps "
              f"at K1 {want_step[0]} and K2 {want_step[1]} launches each (remat schedule), fit "
              f"total K1 {r1}, K2 {r2} with one validation forward; the uninterrupted "
              f"{LIFE_STEPS + LIFE_RESUMED}-step run K1 {s1}, K2 {s2} [{card}]", flush=True)
        _hold_resumed(torch, resumed, straight, "resumed ConvLSTM (bf16, full width)", card)

        # 3. serve `local:` behind NowcastServer with no weights argument
        best = os.path.join(root, "resumed", "best")
        served = InferenceSession(create_model(f"local:{best}"), max_batch=B,
                                  dtype=torch.bfloat16, device=DEVICE)
        requests = convlstm_requests(seed=5)
        replies, swall, forwards, (served_k1,) = drive_server(served, requests,
                                                              [fused_convlstm_step])
        check_frames(requests, replies, "local: serving")
        if forwards < 1 or served_k1 != LAUNCHES_PER_FORWARD * forwards:
            fail(f"local: serving launched K1 {served_k1} times in {forwards} forwards")
        memory = InferenceSession(resumed.model, max_batch=B,
                                  state_dict=resumed.model.module.state_dict(),
                                  dtype=torch.bfloat16, device=DEVICE)
        fused_convlstm_step.launches = 0
        in_memory = memory.predict(requests[0])
        served_k1 += fused_convlstm_step.launches
        if not np.array_equal(in_memory, replies[0][1]):
            fail(f"local: reply differs from the in-memory weights' reply: max|diff| "
                 f"{np.abs(in_memory - replies[0][1]).max():.3g}")
        print(f"local:{os.path.relpath(best, root)} served {len(requests)} requests (6 samples) "
              f"in {forwards} forward(s) of b{B}, {swall:.3f} s wall, K1 launches "
              f"{LAUNCHES_PER_FORWARD} x {forwards}; one reply equal bit for bit to a session on "
              f"the trainer's in-memory weights [{card}]", flush=True)

        # 4. score the default run's best checkpoint with the eval CLI on the card
        fused_convlstm_step.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            evaluate.main(["--checkpoint", os.path.join(root, "checkpoints", "best"),
                           "--batches", "1", "--size", str(H), "--device", DEVICE,
                           "--history-minutes", str(5 * (T - 1)),
                           "--output", os.path.join(root, "eval")])
        ewall = time.perf_counter() - t0
        eval_k1 = fused_convlstm_step.launches
        summary = json.loads(out.getvalue().strip().splitlines()[-1])
        if eval_k1 != LAUNCHES_PER_FORWARD or not all(np.isfinite(list(summary.values()))):
            fail(f"eval --checkpoint: K1 {eval_k1} launches, summary {summary}")
        print(f"eval.evaluate.main --checkpoint checkpoints/best (float32, one b4 advection batch "
              f"of {H}x{W}x{CIN}): {summary} in {ewall:.2f} s wall, K1 launches {eval_k1} "
              f"[{card}]", flush=True)

        # 5. what a checkpoint costs
        torch.cuda.synchronize()
        timed = os.path.join(root, "timed")
        t0 = time.perf_counter()
        save_checkpoint(timed, resumed.state, resumed.model, {"val/loss": float(val_loss)})
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        restore_checkpoint(timed, map_location=DEVICE)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        load_model_from_checkpoint(timed)
        rebuild_ms = (time.perf_counter() - t0) * 1e3
        print(f"checkpoint of the full-width ConvLSTM train state: {_dir_bytes(timed)} bytes "
              f"(state.pt {os.path.getsize(os.path.join(timed, 'state.pt'))}, weights, Adam's "
              f"two moments, step); save {save_ms:.1f} ms from the card, load onto the card "
              f"{load_ms:.1f} ms, local: rebuild on the host {rebuild_ms:.1f} ms [{card}]",
              flush=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return k1 + r1 + s1 + served_k1 + eval_k1, k2 + r2 + s2


def metnet_resume_and_profile(torch, card):
    """Phase 27; returns (K1, K2, K3, K4 launches)."""
    import tempfile

    from satflow_tpu_torch.data import SatFlowDataModule
    from satflow_tpu_torch.interop.jax_weights import params_from_flax
    from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM
    from satflow_tpu_torch.ops.axial_attention import axial_attention
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step, gate_bwd
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.callbacks import ModelCheckpoint
    from satflow_tpu_torch.train.checkpoint import restore_checkpoint
    from satflow_tpu_torch.train.profiling import op_breakdown

    root = tempfile.mkdtemp(prefix="chip_smoke_metnet_")
    variables = metnet_flax_variables(4 * MN_TRAIN_CIN + MN_F, seed=1)

    def run(trainer):
        model = _metnet(torch, warmup_steps=1000, total_steps=100_000)
        model.module.load_state_dict(model.state_dict_from_flax(variables))
        dm = SatFlowDataModule(fake_data=True, num_workers=4, n_train_data=MN_LIFE_STEPS,
                               n_val_data=1, history_minutes=5 * (T - 1),
                               forecast_minutes=5 * MN_F,
                               fake_kwargs=dict(batch_size=B, width=W, height=H))
        trainer.fit(model, dm)
        return trainer

    kw = dict(precision="bf16", device=DEVICE, log_every_n_steps=1)
    fused_lstm_gates.launches = axial_attention.launches = 0
    run(Trainer(max_steps=MN_LIFE_STEPS, max_epochs=1,
                callbacks=[ModelCheckpoint(dirpath=os.path.join(root, "ck"))], **kw))
    last = os.path.join(root, "ck", "last")
    saved = restore_checkpoint(last, map_location=DEVICE)
    lrs, counter = LrPerStep(), LaunchesPerStep(fused_lstm_gates, axial_attention)
    total = MN_LIFE_STEPS + MN_LIFE_RESUMED
    # the resumed and the uninterrupted run validate nothing (nothing reads it)
    resumed = run(Trainer(max_steps=total, resume_from_checkpoint=last, callbacks=[lrs, counter],
                          check_val_every_n_epoch=2, **kw))
    _same_tree(torch, lrs.state, saved, "the resumed MetNet state")
    straight_lrs = LrPerStep()
    run(Trainer(max_epochs=2, max_steps=total, callbacks=[straight_lrs],
                check_val_every_n_epoch=3, **kw))
    k3, k4 = fused_lstm_gates.launches, axial_attention.launches
    want_step = (MN_K3_PER_FORWARD, MN_K4_PER_FORWARD)
    schedule = [resumed.model.lr_schedule(i) for i in range(MN_LIFE_STEPS, total)]
    if lrs.lrs != straight_lrs.lrs[MN_LIFE_STEPS:] or lrs.lrs != schedule:
        fail(f"resumed MetNet learning rates {lrs.lrs}, uninterrupted "
             f"{straight_lrs.lrs[MN_LIFE_STEPS:]}, schedule {schedule}")
    if counter.per_step != [want_step] * MN_LIFE_RESUMED:
        fail(f"resumed MetNet (K3, K4) launches per step {counter.per_step}, expected {want_step}")
    bn = [k for k in saved["model"] if ".bn" in k and k.endswith((".mean", ".var"))]
    print(f"MetNet (metnet.yaml, bf16, b{B} {H}x{W}x{MN_TRAIN_CIN}, warmup_cosine): "
          f"{MN_LIFE_STEPS} steps, checkpoint, resume, {MN_LIFE_RESUMED} more: the restored "
          f"state equals the saved one bit for bit ({len(bn)} BatchNorm running statistics "
          f"among it); learning rates of the resumed steps "
          + ", ".join(f"{v:.6g}" for v in lrs.lrs) + " = the uninterrupted run's = the "
          f"schedule at steps {MN_LIFE_STEPS}-{total - 1}; launches per resumed step K3 "
          f"{want_step[0]}, K4 {want_step[1]}; phase total K3 {k3}, K4 {k4} [{card}]", flush=True)

    # one fused ConvLSTM train step (phase 8's) under Trainer(profiler=...)
    model = EncoderDecoderConvLSTM(hidden_dim=HIDDEN, input_channels=CIN, out_channels=COUT,
                                   forecast_steps=STEPS, remat=True, remat_chunk=REMAT_CHUNK)
    model.module.load_state_dict(params_from_flax(flax_params(0, HIDDEN)))
    dm = SatFlowDataModule(fake_data=True, num_workers=0, n_train_data=1, n_val_data=1,
                           history_minutes=5 * (T - 1), forecast_minutes=5 * STEPS,
                           fake_kwargs=dict(batch_size=B, width=W, height=H))
    trainer = Trainer(max_steps=1, check_val_every_n_epoch=2, profiler="pytorch",
                      profile_dir=os.path.join(root, "profile"), **kw)
    fused_convlstm_step.launches = gate_bwd.launches = 0
    trainer.fit(model, dm)
    k1, k2 = fused_convlstm_step.launches, gate_bwd.launches
    if (k1, k2) != (K1_PER_TRAIN_STEP, K2_PER_TRAIN_STEP):
        fail(f"the profiled train step launched K1 {k1}, K2 {k2} times")
    rows = op_breakdown(trainer.profile_path, top_k=10_000)
    if not rows or rows[0]["device"] != "cuda":
        fail("the profiler saw no device kernel in the fused train step")
    device_ms = sum(r["us"] for r in rows) / 1e3
    print(f"fused ConvLSTM train step under Trainer(profiler='pytorch') (bf16, b{B} {H}x{W}, "
          f"{T} in / {STEPS} out, remat_chunk {REMAT_CHUNK}; K1 {k1}, K2 {k2} launches): device "
          f"time {device_ms:.2f} ms over {sum(r['calls'] for r in rows)} kernels; the top "
          f"{PROFILE_TOP} kernels by device time, with the aten op that launched each "
          f"[{card}]:", flush=True)
    for r in rows[:PROFILE_TOP]:
        print(f"  {r['us'] / 1e3:9.2f} ms {100 * r['share']:5.1f} % {r['calls']:5d} x  "
              f"{r['name'][:72]}  <- {r['op']} <- {r['caller']}", flush=True)
    by_op = {}
    for r in rows:
        if "elementwise" in r["name"] or "reduce" in r["name"] or "cat" in r["name"].lower():
            key = f"{r['op']} <- {r['caller']}"
            by_op[key] = by_op.get(key, 0.0) + r["us"] / 1e3
    print("glue kernels (elementwise, reduce, cat) by the aten op that launched them <- the op "
          "that called it: " + "; ".join(f"{op} {ms:.2f} ms" for op, ms in
                                         sorted(by_op.items(), key=lambda e: -e[1])[:12])
          + f" [{card}]", flush=True)
    return k1, k2, k3, k4


def preemption_and_tuning(torch, card):
    """Phase 28; returns (K1 launches, K2 launches)."""
    import signal
    import tempfile

    from satflow_tpu_torch.data import SatFlowDataModule
    from satflow_tpu_torch.models import create_model
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step, gate_bwd
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.callbacks import ModelCheckpoint
    from satflow_tpu_torch.train.checkpoint import restore_checkpoint

    root = tempfile.mkdtemp(prefix="chip_smoke_preempt_")
    hh, ww = SMALL_LIFE_HW

    def model():
        return create_model("encoderdecoderconvlstm", hidden_dim=SMALL_LIFE_HIDDEN,
                            input_channels=CIN, out_channels=COUT, forecast_steps=STEPS,
                            remat_chunk=REMAT_CHUNK, generator=torch.Generator().manual_seed(0))

    def dm():
        """Fake b4 data; its ``batch_size`` is what ``scale_batch_size`` sets."""
        return SatFlowDataModule(fake_data=True, num_workers=0, n_train_data=4, n_val_data=1,
                                 history_minutes=5 * (T - 1), forecast_minutes=5 * STEPS,
                                 fake_kwargs=dict(batch_size=4, width=ww, height=hh))

    class PreemptAtStep2(StateAtStart):
        def on_train_batch_end(self, engine, metrics, step) -> None:
            if step == 2:
                os.kill(os.getpid(), signal.SIGTERM)

    kw = dict(precision="bf16", device=DEVICE, log_every_n_steps=1)
    before = signal.getsignal(signal.SIGTERM)
    fused_convlstm_step.launches = gate_bwd.launches = 0
    preempted = Trainer(max_epochs=50, callbacks=[PreemptAtStep2(), ModelCheckpoint(
        dirpath=os.path.join(root, "ck"))], **kw)
    preempted.fit(model(), dm())
    last = os.path.join(root, "ck", "last")
    step = restore_checkpoint(last)["step"]
    if not preempted.preempted or preempted.global_step != 2 or step != 2:
        fail(f"SIGTERM at step 2: preempted {preempted.preempted}, stopped at step "
             f"{preempted.global_step}, last holds step {step}")
    if signal.getsignal(signal.SIGTERM) != before:
        fail("the Trainer left its SIGTERM handler installed")
    resumed = Trainer(max_steps=3, resume_from_checkpoint=last, **kw)
    resumed.fit(model(), dm())
    if resumed.global_step != 3 or resumed.state.step != 3:
        fail(f"the preempted run resumed to step {resumed.global_step}, not 3")
    print(f"SIGTERM at step 2 (hidden {SMALL_LIFE_HIDDEN}, b4 {hh}x{ww}, bf16): the step "
          f"finished, last holds step {step}, fit stopped, the SIGTERM handler was restored; "
          f"resumed from last to step {resumed.global_step} [{card}]", flush=True)

    data = dm()
    t0 = time.perf_counter()
    size = Trainer(**kw).scale_batch_size(model(), data, init_val=2, max_trials=4)
    scale_s = time.perf_counter() - t0
    loaded = next(iter(data.train_dataloader()))[0]["sat_data"].shape[0]
    if size != 16 or data.batch_size != 16 or loaded != 16:
        fail(f"scale_batch_size picked {size} (datamodule {data.batch_size}, its loader "
             f"{loaded}), expected 16: 2, 4, 8 and 16 fit in 80 GB at {hh}x{ww}")
    tuned = model()
    t0 = time.perf_counter()
    lr = Trainer(**kw).tune(tuned, dm(), num_steps=12)
    tune_s = time.perf_counter() - t0
    if not (np.isfinite(lr) and lr > 0 and tuned.lr == lr):
        fail(f"tune returned {lr}")
    print(f"scale_batch_size(max_trials=4): {size} (probes 2, 4, 8, 16, the real step with "
          f"Adam), set on the datamodule, whose train loader then gives b{loaded}, {scale_s:.2f} s; tune: suggested lr {lr:.3g} after a "
          f"12-step range test, {tune_s:.2f} s; phase K1 {fused_convlstm_step.launches}, K2 "
          f"{gate_bwd.launches} launches [{card}]", flush=True)
    return fused_convlstm_step.launches, gate_bwd.launches


# Phases 28a-28d: the channels-stacked zoo at its shipped configs' width (b8, 7
# x 256x256x12 in, 24 out, bf16 compute on f32 weights; pixelcnn, which ships
# no config, at its defaults: hidden 64, 5 blocks), served, trained and run
# through the CLI; the export of the ConvLSTM, MetNet and UNet reloaded in a
# fresh process; the MetNet example.
ZOO_SERVE = (("unet", "unet"), ("runet", "runet"), ("attentionunet", "attention_unet"),
             ("attentionrunet", "attention_runet"), ("fcn", "fcn_r50"),
             ("deeplabv3", "deeplabv3_r101"), ("pixelcnn", None))
ZOO_TRAIN = (("unet", "unet"), ("attentionrunet", "attention_runet"),
             ("deeplabv3", "deeplabv3_r101"), ("pixelcnn", None))
ZOO_TRAIN_STEPS = 2
# Tolerances:
# - one sample's float32 reply on the card (cuDNN, TF32 off) against the same
#   forward on the host's CPU: the same f32 convs summed in another order by
#   another library, through up to 104 BatchNorms (ResNet-101) and 27 convs a
#   pixel deep (R2AttU-Net); measured below 1e-5 x max|cpu| on the CPU against
#   the JAX package (tests/test_torch_zoo.py holds 1e-4 there).
TOL_ZOO_F32 = 1e-3  # x max|cpu|
# - the exported program's reply against the session's on the same input:
#   the same kernels and library calls on the same tensors, so bit-equal is
#   expected; held to one bf16 step of the largest reply.
TOL_EXPORT = 2 ** -8  # x max|session|


def zoo_model(torch, name: str, config):
    """The zoo model as its shipped ``configs/model/<config>.yaml`` builds it
    (through the experiment entry point's mapping), or, with no config, the
    registry's defaults at 12 channels and 24 lead times; its input width
    (7 x 12 stacked) made from a small batch on the host."""
    from satflow_tpu_torch.core import config as config_lib
    from satflow_tpu_torch.experiments.train import instantiate
    from satflow_tpu_torch.models import create_model

    if config is None:
        model = create_model(name, input_channels=CIN, forecast_steps=STEPS)
    else:
        cfg = config_lib.compose(config_lib.default_config_dir(), "config.yaml",
                                 [f"model={config}"])["model"]
        model = instantiate(cfg)
    if (model.input_channels, model.forecast_steps) != (CIN, STEPS):
        fail(f"{name}: config gives {model.input_channels} channels, {model.forecast_steps} "
             f"steps, not {CIN}, {STEPS}")
    small = torch.zeros(1, T, 32, 32, CIN)
    model.materialize((small, small))
    return model


def zoo_flax_variables(model, seed: int = 0) -> dict:
    """Random weights in the JAX model's flax tree, as flax initialises them
    (lecun-normal kernels, zero biases, unit scales, running statistics
    (0, 1)), from numpy seed ``seed``. The tree is read off the port's module
    names (the bridge's inverse): a (O, I, 1, k) weight is flax's 1-D (k, I, O)
    kernel of an int kernel size, any other (O, I, kh, kw) an HWIO one, and a
    module named ``<keyword>_`` is flax's ``<keyword>``."""
    rng = np.random.default_rng(seed)
    tree = {"params": {}, "batch_stats": {}}
    for key, t in model.module.state_dict().items():
        *mods, leaf = [m[:-1] if m.endswith("_") and keyword.iskeyword(m[:-1]) else m
                       for m in key.split(".")]
        shape = tuple(t.shape)
        if leaf == "weight":
            o, i, kh, kw = shape
            leaf, value = "kernel", lecun_normal(rng, (kw, i, o) if kh == 1 and kw > 1
                                                 else (kh, kw, i, o))
        elif leaf in ("bias", "mean"):
            value = np.zeros(shape, np.float32)
        elif leaf in ("scale", "var"):
            value = np.ones(shape, np.float32)
        else:
            fail(f"zoo_flax_variables: unexpected state_dict key {key}")
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value
    return tree


def zoo_serve_slice(torch, card):
    """Phase 28a; returns {model: (forward ms, peak GiB)}."""
    import copy

    from satflow_tpu_torch.serve import InferenceSession

    x = torch.from_numpy(np.random.default_rng(11).random((B, T, H, W, CIN),
                                                           dtype=np.float32)).to(DEVICE)
    rows = {}
    for name, config in ZOO_SERVE:
        model = zoo_model(torch, name, config)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # what earlier phases still hold
        session = InferenceSession(model, max_batch=B, variables=zoo_flax_variables(model, 0),
                                   dtype=torch.bfloat16, device=DEVICE)
        n_params = sum(p.numel() for p in model.parameters())
        y = session._forward(x)  # warm-up (cuDNN picks its algorithms)
        ms = cuda_ms(torch, lambda: session._forward(x), 5)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        if tuple(y.shape) != (B, STEPS, H, W, 1) or not bool(torch.isfinite(y).all()):
            fail(f"{name}: b{B} reply of shape {tuple(y.shape)}, finite "
                 f"{bool(torch.isfinite(y).all())}")
        # one sample in float32 on the card against the same forward on the CPU
        model.set_compute_dtype(None)
        with torch.inference_mode():
            got = model(x[:1]).cpu()
            want = copy.deepcopy(model).cpu()(x[:1].cpu())
        model.set_compute_dtype(torch.bfloat16)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        if not err <= TOL_ZOO_F32 * scale:
            fail(f"{name}: float32 reply on the card vs the CPU: max|diff| {err:.3g} > "
                 f"{TOL_ZOO_F32} x max|cpu| {scale:.3g}")
        rows[name] = (ms, peak)
        print(f"{name} ({config or 'registry defaults'}, {n_params} parameters): b{B} forward "
              f"(bf16, {T} x {H}x{W}x{CIN} in, {STEPS} out) {ms:.2f} ms, "
              f"{B * STEPS / (ms / 1e3):.1f} frames/s, peak device memory {peak:.2f} GiB (weights "
              f"and the forward, above what earlier phases hold); "
              f"float32 sample vs the CPU: max|diff| {err:.3g} <= {TOL_ZOO_F32} x max|cpu| "
              f"{scale:.3g} ok [{card}]", flush=True)
        if name == "unet":
            requests = convlstm_requests(seed=12)
            replies, wall, forwards, _ = drive_server(session, requests, [])
            for req, (status, reply) in zip(requests, replies):
                want_shape = req.shape[:-4] + (STEPS, H, W, 1)
                if status != 200 or reply.shape != want_shape or not np.isfinite(reply).all():
                    fail(f"unet served: status {status}, reply "
                         f"{getattr(reply, 'shape', reply)!r}"[:300])
            print(f"unet served {len(requests)} concurrent requests (6 samples) in {forwards} "
                  f"forward(s) of b{B}, {wall:.3f} s wall [{card}]", flush=True)
        del session, model
        torch.cuda.empty_cache()
    return rows


def zoo_train_slice(torch, card):
    """Phase 28b; returns {model: (train step ms, peak GiB)}."""
    from satflow_tpu_torch.data import SatFlowDataModule
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.interop.jax_weights import flax_tree_state_dict
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.steps import make_train_step

    dm = SatFlowDataModule(fake_data=True, num_workers=0, n_train_data=ZOO_TRAIN_STEPS,
                           n_val_data=1, history_minutes=5 * (T - 1),
                           forecast_minutes=5 * STEPS,
                           fake_kwargs=dict(batch_size=B, width=W, height=H))
    rows = {}
    for name, config in ZOO_TRAIN:
        model = zoo_model(torch, name, config)
        model.module.load_state_dict(flax_tree_state_dict(zoo_flax_variables(model, 0)))
        stats0 = {k: v.clone() for k, v in model.module.state_dict().items()
                  if k.endswith((".mean", ".var"))}
        trainer = Trainer(max_steps=ZOO_TRAIN_STEPS, precision="bf16", log_every_n_steps=1,
                          device=DEVICE)
        t0 = time.perf_counter()
        trainer.fit(model, dm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
        val_loss = trainer.callback_metrics.get("val/loss", float("nan"))
        if trainer.global_step != ZOO_TRAIN_STEPS or len(losses) != ZOO_TRAIN_STEPS \
                or not all(np.isfinite(losses + [val_loss])):
            fail(f"{name}: fit took {trainer.global_step} steps; losses {losses}, val {val_loss}")
        state = model.module.state_dict()
        still = [k for k, v in stats0.items() if torch.equal(state[k].cpu(), v)]
        if still:  # pixelcnn has no BatchNorm
            fail(f"{name}: BatchNorm statistics that did not move: {still[:5]} of {len(stats0)}")
        batch = to_device(next(iter(dm.train_dataloader())), torch.device(DEVICE))
        model.train()
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(batch)
        loss.backward()
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())
               or not bool((p.grad != 0).any())]
        if bad:
            fail(f"{name}: gradients missing, non-finite or all zero: {bad[:5]}")
        n_params = sum(1 for _ in model.parameters())
        step = make_train_step(model)
        step(trainer.state, batch)  # warm-up
        runs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() - sum(  # earlier phases' tensors, not this model's
            t.numel() * t.element_size() for t in (*model.parameters(), *model.buffers()))
        base -= sum(t.numel() * t.element_size() for s in trainer.state.optimizer.state.values()
                    for t in s.values() if torch.is_tensor(t))
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(trainer.state, batch)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t1) * 1e3)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        rows[name] = (sum(runs) / len(runs), peak)
        print(f"{name} ({config or 'registry defaults'}): trained {ZOO_TRAIN_STEPS} Adam steps "
              f"(bf16, b{B} {H}x{W}, {T} in / {STEPS} out) in {wall:.2f} s wall with data "
              f"generation: losses " + ", ".join(f"{v:.6f}" for v in losses)
              + f", val {val_loss:.6f}; {len(stats0)} BatchNorm statistics moved; all "
              f"{n_params} parameter gradients finite and nonzero; train step "
              f"{rows[name][0]:.2f} ms (runs {', '.join(f'{r:.2f}' for r in runs)}), "
              f"{B * STEPS / (rows[name][0] / 1e3):.1f} frames/s, peak device memory "
              f"{peak:.2f} GiB (weights, Adam's moments, the batch and the step, above what "
              f"earlier phases hold) [{card}]", flush=True)
        del trainer, model, step
        torch.cuda.empty_cache()

    # the shipped experiment through the CLI, as a user runs it, on the card
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "satflow_tpu_torch.run", "experiment=unet_simple",
             f"work_dir={work}/runs", "print_config=false"],
            capture_output=True, text=True, cwd=work, timeout=600,
            env={**os.environ, "PYTHONPATH": repo})
        wall = time.perf_counter() - t0
        csvs = [os.path.join(d, f) for d, _, fs in os.walk(work) for f in fs
                if f == "metrics.csv"]
        if out.returncode != 0 or len(csvs) != 1:
            fail(f"python -m satflow_tpu_torch.run experiment=unet_simple: exit "
                 f"{out.returncode}, {len(csvs)} metrics.csv; {out.stderr[-1500:]}")
        header = open(csvs[0]).read().splitlines()[0].split(",")
        if not {"train/loss", "val/loss", "test/loss"} <= set(header):
            fail(f"experiment=unet_simple: metrics.csv columns {header[:10]}")
    print(f"python -m satflow_tpu_torch.run experiment=unet_simple on the card: exit 0 in "
          f"{wall:.1f} s wall, train/val/test losses logged [{card}]", flush=True)
    return rows


EXPORT_LOADER = """
import io, json, struct, sys, time
import numpy as np
import torch
import satflow_tpu_torch.ops
from satflow_tpu_torch.ops.axial_attention import axial_attention
from satflow_tpu_torch.ops.cmajor_convlstm import cmajor_conv3x3, cmajor_convlstm_step
from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step, fused_convlstm_step_halo
from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates
path, x_path, y_path = sys.argv[1:4]
t0 = time.perf_counter()
with open(path, "rb") as f:
    assert f.read(8) == b"SFXP0001"
    (n,) = struct.unpack("<I", f.read(4))
    meta = json.loads(f.read(n).decode())
    fn = torch.export.load(io.BytesIO(f.read())).module()
load_s = time.perf_counter() - t0
x = torch.from_numpy(np.load(x_path)).to(meta["platforms"][0])
with torch.no_grad():
    counters = (fused_convlstm_step, fused_convlstm_step_halo, fused_lstm_gates, axial_attention,
                cmajor_convlstm_step, cmajor_conv3x3)
    for c in counters:
        c.launches = 0
    y = fn(x)
    launches = [c.launches for c in counters]
np.save(y_path, y.cpu().numpy())
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "satflow_tpu")
             or m.startswith(("satflow_tpu_torch.models", "satflow_tpu_torch.core",
                              "satflow_tpu_torch.serve", "satflow_tpu_torch.nn")))
print(json.dumps({"load_s": load_s, "launches": launches, "bad": bad}))
"""


def export_slice(torch, card):
    """Phase 28c; returns the (K1, K1h, K3, K4, K6a, K6b) launches of the
    phase (the sessions' forwards here and the exported programs' calls
    there). The halo model is served and exported under
    ``SATFLOW_STEP_VARIANT=halo`` and its program loaded without it."""
    import tempfile

    from satflow_tpu_torch.interop.jax_weights import params_from_flax
    from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM
    from satflow_tpu_torch.ops.axial_attention import axial_attention
    from satflow_tpu_torch.ops.cmajor_convlstm import cmajor_conv3x3, cmajor_convlstm_step
    from satflow_tpu_torch.ops.fused_convlstm_step import (
        fused_convlstm_step,
        fused_convlstm_step_halo,
    )
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates
    from satflow_tpu_torch.serve import InferenceSession
    from satflow_tpu_torch.serve.export import export_model

    counters = (fused_convlstm_step, fused_convlstm_step_halo, fused_lstm_gates, axial_attention,
                cmajor_convlstm_step, cmajor_conv3x3)

    def convlstm(**kw):
        return lambda: (EncoderDecoderConvLSTM(hidden_dim=HIDDEN, input_channels=CIN,
                                               out_channels=COUT, forecast_steps=STEPS, **kw),
                        dict(state_dict=params_from_flax(flax_params(0))))

    k1h_k6 = CMAJOR_LAUNCHES_PER_FORWARD
    # (name, model and weights, input channels, the launches of a call, the step variant)
    cases = (
        ("convlstm", convlstm(), CIN, (LAUNCHES_PER_FORWARD, 0, 0, 0, 0, 0), "3pass"),
        ("convlstm_halo", convlstm(), CIN, (0, LAUNCHES_PER_FORWARD, 0, 0, 0, 0), "halo"),
        ("convlstm_cmajor", convlstm(cell_impl="cmajor"), CIN,
         (k1h_k6[0], 0, 0, 0, k1h_k6[1], k1h_k6[2]), "3pass"),
        ("metnet", lambda: (_metnet(torch),
                            dict(variables=metnet_flax_variables(4 * MN_CIN + MN_F))),
         MN_CIN, (0, 0, MN_K3_PER_FORWARD, MN_K4_PER_FORWARD, 0, 0), "3pass"),
        ("unet", lambda: (lambda m: (m, dict(variables=zoo_flax_variables(m, 0))))(
            zoo_model(torch, "unet", "unet")), CIN, (0, 0, 0, 0, 0, 0), "3pass"),
    )
    repo = os.path.dirname(os.path.abspath(__file__))
    totals = [0] * len(counters)
    with tempfile.TemporaryDirectory() as tmp:
        exported = []
        for name, build, cin, want_launches, variant in cases:
            model, weights = build()
            session = InferenceSession(model, max_batch=B, dtype=torch.bfloat16, device=DEVICE,
                                       **weights)
            x = np.random.default_rng(13).random((B, T, H, W, cin), dtype=np.float32)
            for c in counters:
                c.launches = 0
            with step_variant(variant):
                want = session.predict(x)
                totals = [a + c.launches for a, c in zip(totals, counters)]
                path = os.path.join(tmp, f"{name}.pt2")
                x_path = os.path.join(tmp, f"{name}_x.npy")
                t0 = time.perf_counter()
                meta = export_model(session, None, path, batch=B, history=T, size=H,
                                    channels=cin)  # in the session's bf16
                export_s = time.perf_counter() - t0
            np.save(x_path, x)
            exported.append((name, path, x_path, want, meta, export_s, want_launches))
            del session, model
            torch.cuda.empty_cache()
        # each artifact loaded in a fresh process of its own, all at once, with
        # no step variant set
        env = {k: v for k, v in os.environ.items() if k != "SATFLOW_STEP_VARIANT"}
        procs = [subprocess.Popen([sys.executable, "-c", EXPORT_LOADER, path, x_path,
                                   os.path.join(tmp, f"{name}_y.npy")],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env={**env, "PYTHONPATH": repo})
                 for name, path, x_path, *_ in exported]
        outs = [proc.communicate(timeout=600) + (proc.returncode,) for proc in procs]
        for (name, path, _, want, meta, export_s, want_launches), (stdout, stderr, rc) in zip(
                exported, outs):
            if rc != 0:
                fail(f"loading the exported {name} in a fresh process: {stderr[-2000:]}")
            res = json.loads(stdout.strip().splitlines()[-1])
            got = np.load(os.path.join(tmp, f"{name}_y.npy"))
            totals = [a + b for a, b in zip(totals, res["launches"])]
            if res["bad"]:
                fail(f"loading the exported {name} imported {res['bad'][:8]}")
            if tuple(res["launches"]) != want_launches:
                fail(f"exported {name}: (K1, K1h, K3, K4, K6a, K6b) launches a call "
                     f"{res['launches']}, expected {want_launches}")
            if got.shape != want.shape or list(got.shape) != meta["out_shape"]:
                fail(f"exported {name}: reply {got.shape}, session {want.shape}, "
                     f"meta {meta['out_shape']}")
            err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
            if not err <= TOL_EXPORT * scale:
                fail(f"exported {name} vs the session: max|diff| {err:.3g} > {TOL_EXPORT} x "
                     f"{scale:.3g}")
            print(f"exported {name} (b{B}, bf16 on f32 weights): {os.path.getsize(path)} bytes, "
                  f"export {export_s:.2f} s; a fresh process importing torch and "
                  f"satflow_tpu_torch.ops only ({len(exported)} at once) loads it in "
                  f"{res['load_s']:.3f} s (torch.export's own imports included), and its call "
                  f"launches (K1, K1h, K3, K4, K6a, K6b) {tuple(res['launches'])}; reply vs the "
                  f"session: max|diff| {err:.3g} "
                  f"({'bit-equal' if err == 0 else f'<= {TOL_EXPORT} x {scale:.3g}'}) [{card}]",
                  flush=True)
    return tuple(totals)


def example_slice(torch, card):
    """Phase 28d; returns the (K3, K4) launches of the example."""
    from satflow_tpu_torch.examples import metnet_example
    from satflow_tpu_torch.ops.axial_attention import axial_attention
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates

    fused_lstm_gates.launches = axial_attention.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        y = metnet_example.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3, k4 = fused_lstm_gates.launches, axial_attention.launches
    if tuple(y.shape) != (1, STEPS, 16, 16, 1) or not bool(torch.isfinite(y).all()) \
            or y.device.type != "cuda":
        fail(f"metnet_example: {tuple(y.shape)} on {y.device}")
    # two forwards: the one sample that makes the input width, and the example's
    if (k3, k4) != (2 * T, 2 * 2):
        fail(f"metnet_example launched K3 {k3}, K4 {k4} times, expected {2 * T}, 4")
    print(f"examples/metnet_example.py on the card: {printed.getvalue().strip().splitlines()[-1]}"
          f"; {wall:.2f} s wall, K3 {k3} and K4 {k4} launches [{card}]", flush=True)
    return k3, k4


# Phase 28e: the Perceiver family (configs/model/perceiver*.yaml and
# hf_perceiver.yaml at their shipped widths, random weights from the port's
# seeded generator; b8, bf16 compute on f32 weights; the fake datamodule's 7
# history frames). Its attention is matmul and softmax, as in the JAX
# package: none of the repo's kernels is on this path, and the phase holds
# every kernel's launch count at 0 over it.
PC_TRAIN_STEPS = 2
PC_CONFIGS = ("perceiver_encoder", "perceiver_metnet", "perceiver_single")
# Tolerances:
# - one sample's float32 reply on the card (cuBLAS, TF32 off) against the
#   same forward on the host's CPU: the same f32 matmuls summed in another
#   order, through 24 lead steps of 8 blocks: TOL_ZOO_F32 x max|cpu|.


def pc_model(torch, config: str, **overrides):
    """The Perceiver of ``configs/model/<config>.yaml``, built through the
    experiment entry point's mapping, with ``overrides``; weights drawn from
    the port's seeded generator on the host."""
    from satflow_tpu_torch.core import config as config_lib
    from satflow_tpu_torch.experiments.train import _counterpart, _model_node

    cfg = _model_node(config_lib.compose(config_lib.default_config_dir(), "config.yaml",
                                         [f"model={config}"])["model"])
    kw = {k: v for k, v in cfg.items() if k != "_target_"}
    return _counterpart(cfg["_target_"])(**{**kw, **overrides},
                                         generator=torch.Generator().manual_seed(0))


def pc_batch(torch, px: int, channels=None):
    """One b8 batch of the fake schema at ``px``², on the card: 7 history
    frames, 24 targets, 12 channels unless ``channels``."""
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.data.fake import FakeDataset

    batch = FakeDataset(batch_size=B, width=px, height=px,
                        number_sat_channels=channels or CIN,
                        history_minutes=5 * (T - 1), forecast_minutes=5 * STEPS, length=1)[0]
    return to_device(batch, torch.device(DEVICE))


# kernel classes of a Perceiver profile (cuBLAS and CUTLASS matmuls under
# their kernel names' fragments)
PC_CLASSES = {"matmuls": ("gemm", "nvjet", "cutlass", "xmma", "sm90_"),
              "softmax": ("softmax",), "layer norm": ("layer_norm", "layernorm")}


def pc_forward(torch, model, batch, what: str, card, cpu_check: bool = False):
    """The b8 bf16 forward of ``model`` on ``batch``: CUDA-event ms over 3
    after a warm-up, the peak memory above what was held before, the reply
    checked; with ``cpu_check`` one sample's float32 reply against the CPU's
    and one forward profiled (device time by kernel class, the idle share,
    the kernel launches). Returns (ms, peak GiB)."""
    import copy

    model.to(DEVICE)
    model.materialize(batch)
    model.set_compute_dtype(torch.bfloat16)
    model.eval()
    x, y = model.prepare_batch(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        out = model(x)
        ms = cuda_ms(torch, lambda: model(x), 3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if tuple(out.shape) != tuple(y.shape) or not bool(torch.isfinite(out).all()):
        fail(f"{what}: b{B} reply of shape {tuple(out.shape)} for targets {tuple(y.shape)}, "
             f"finite {bool(torch.isfinite(out).all())}")
    n_params = sum(p.numel() for p in model.parameters())
    line = (f"{what} ({n_params} parameters): b{B} forward (bf16, "
            f"{tuple(x['sat_data'].shape[1:])} satellite in, {tuple(out.shape[1:])} out) "
            f"{ms:.2f} ms, {B * out.shape[1] / (ms / 1e3):.1f} frames/s, peak device memory "
            f"{peak:.2f} GiB above the weights")
    if cpu_check:
        from torch.autograd import DeviceType

        with torch.inference_mode():
            wall, by_class, busy, others, prof = device_time_by_class(
                torch, lambda: model(x), PC_CLASSES)
        n_kernels = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        print(f"{what}: one b{B} forward profiled: {wall:.2f} ms wall, device busy "
              f"{busy:.2f} ms (idle {100 * (1 - busy / wall):.1f} %), {n_kernels} kernel "
              f"launches; " + ", ".join(f"{k} {v:.2f} ms" for k, v in by_class.items())
              + "; largest other: " + ", ".join(f"{n} {v:.2f}" for n, v in others[:4])
              + f" [{card}]", flush=True)
        model.set_compute_dtype(None)
        one = {k: v[:1] for k, v in x.items()}
        t0 = time.perf_counter()
        with torch.inference_mode():
            got = model(one).cpu()
            want = copy.deepcopy(model).cpu()({k: v.cpu() for k, v in one.items()})
        model.set_compute_dtype(torch.bfloat16)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        if not err <= TOL_ZOO_F32 * scale:
            fail(f"{what}: float32 reply on the card vs the CPU: max|diff| {err:.3g} > "
                 f"{TOL_ZOO_F32} x max|cpu| {scale:.3g}")
        line += (f"; float32 sample vs the CPU: max|diff| {err:.3g} <= {TOL_ZOO_F32} x "
                 f"max|cpu| {scale:.3g} ok ({time.perf_counter() - t0:.1f} s)")
    print(line + f" [{card}]", flush=True)
    return ms, peak


def pc_train_step(torch, model, batch, what: str, card, n: int = 2):
    """Every parameter's gradient of one loss finite and nonzero, then the
    LAMB train step timed (host clock, synchronised) over ``n`` after a
    warm-up, with its peak memory above the weights and LAMB's moments.
    Returns (ms, peak GiB)."""
    from satflow_tpu_torch.train.state import TrainState
    from satflow_tpu_torch.train.steps import make_train_step

    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(batch)
    loss.backward()
    bad = [k for k, p in model.named_parameters() if p.grad is None
           or not bool(torch.isfinite(p.grad).all()) or not bool((p.grad != 0).any())]
    if bad or not bool(torch.isfinite(loss)):
        fail(f"{what}: loss {float(loss)}; gradients missing, non-finite or all zero: {bad[:5]}")
    model.zero_grad(set_to_none=True)
    state = TrainState(model, model.make_optimizer())
    step = make_train_step(model)
    step(state, batch)  # warm-up; LAMB's moments made
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    runs = []
    for _ in range(n):
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if not bool(metrics["finite"]):
        fail(f"{what}: train step not finite")
    ms = sum(runs) / len(runs)
    print(f"{what}: all {sum(1 for _ in model.parameters())} parameter gradients finite and "
          f"nonzero; LAMB train step (bf16, b{B}) {ms:.2f} ms (runs "
          f"{', '.join(f'{r:.2f}' for r in runs)}), peak device memory {peak:.2f} GiB above "
          f"the weights and LAMB's moments [{card}]", flush=True)
    return ms, peak


def perceiver_slice(torch, card):
    """Phase 28e; returns {what: (ms, peak GiB)} and the kernels' launches
    over the phase (all 0: the path runs none)."""
    import tempfile

    from satflow_tpu_torch.data import SatFlowDataModule
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.ops.axial_attention import axial_attention
    from satflow_tpu_torch.ops.cmajor_convlstm import cmajor_conv3x3, cmajor_convlstm_step
    from satflow_tpu_torch.ops.fused_convlstm_int8 import fused_convlstm_step_int8
    from satflow_tpu_torch.ops.fused_convlstm_step import (
        fused_convlstm_step,
        fused_convlstm_step_halo,
        gate_bwd,
    )
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.lamb import Lamb

    counters = (fused_convlstm_step, fused_convlstm_step_halo, gate_bwd, fused_lstm_gates,
                axial_attention, fused_convlstm_step_int8, cmajor_convlstm_step, cmajor_conv3x3)
    for c in counters:
        c.launches = 0
    rows = {}
    t_phase = time.perf_counter()

    # (a) perceiver.yaml at full width: 64², depth 6, 256 x 512 latents, 24
    # per-lead decodes, each a whole Perceiver IO under remat
    model = pc_model(torch, "perceiver")
    px = model.input_size
    rows["perceiver forward"] = pc_forward(torch, model, pc_batch(torch, px), "perceiver "
                                           "(perceiver.yaml)", card, cpu_check=True)
    # LAMB under warmup_cosine from step 0 (warmup_steps=0: the config's lr on
    # the first step) on one advection batch, a signal the model can learn
    model.warmup_steps = 0

    class OneBatch(SatFlowDataModule):
        def _dataset(self, split, n):
            from satflow_tpu_torch.data import AdvectionDataset

            return AdvectionDataset(batch_size=B, width=px, height=px, number_sat_channels=CIN,
                                    history_minutes=5 * (T - 1), forecast_minutes=5 * STEPS,
                                    length=1)

    trainer = Trainer(max_epochs=PC_TRAIN_STEPS, overfit_batches=1, precision="bf16",
                      log_every_n_steps=1, device=DEVICE)
    t0 = time.perf_counter()
    trainer.fit(model, OneBatch(fake_data=True, num_workers=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
    if trainer.global_step != PC_TRAIN_STEPS or len(losses) != PC_TRAIN_STEPS:
        fail(f"perceiver fit took {trainer.global_step} steps and logged {len(losses)} losses")
    # LAMB moves every tensor by lr x its norm: at the config's lr without
    # warm-up that changes a random model's loss by O(1) a step, so the loss
    # falls, then overshoots (f32 on a CPU at 16²: 2.35, 0.98, 1.04, 1.26)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"perceiver losses not finite or not below the first: {losses}")
    if not isinstance(trainer.state.optimizer, Lamb):
        fail(f"perceiver trained with {type(trainer.state.optimizer).__name__}, not LAMB")
    lrs = [trainer.state.optimizer.param_groups[0]["lr"], model.lr]
    print(f"perceiver (perceiver.yaml, warmup_steps=0) trained {PC_TRAIN_STEPS} bf16 LAMB steps "
          f"on one b{B} {px}x{px}x{CIN} advection batch in {wall:.2f} s wall: losses "
          + ", ".join(f"{v:.6f}" for v in losses) + f" (finite, the last below the first); "
          f"last lr {lrs[0]:.3g}"
          f" (config lr {lrs[1]:.3g}) [{card}]", flush=True)
    rows["perceiver train step"] = pc_train_step(torch, model, trainer.last_batch,
                                                 "perceiver (perceiver.yaml)", card)
    del trainer, model
    torch.cuda.empty_cache()

    # (b) hf_perceiver.yaml as shipped (pretrained: false): depth 8, 512 x 512
    # latents, the 2-channel flow head and the 1x1 channel change
    model = pc_model(torch, "hf_perceiver")
    if model.pretrained or (model.depth, model.num_latents) != (8, 512):
        fail(f"hf_perceiver: pretrained {model.pretrained}, depth {model.depth}, "
             f"latents {model.num_latents}")
    batch = pc_batch(torch, model.input_size)
    rows["hf_perceiver forward"] = pc_forward(torch, model, batch, "huggingfaceperceiver "
                                              "(hf_perceiver.yaml)", card)
    rows["hf_perceiver train step"] = pc_train_step(torch, model, batch, "huggingfaceperceiver "
                                                    "(hf_perceiver.yaml)", card, n=1)
    del model, batch
    torch.cuda.empty_cache()

    # (c) the other three configs, one b8 forward each at their shipped sizes;
    # perceiver_encoder's one conv preprocessor is made for the satellite's
    # channels and then meets the 1-channel topography: at 12 channels it
    # raises, as the JAX package does, and runs at 1
    for config in PC_CONFIGS:
        model = pc_model(torch, config)
        # the conv pre- and post-processors work at 1/4 of the data's size
        px = model.input_size * (4 if model.postprocessor_type == "conv" else 1)
        if config == "perceiver_encoder":
            try:
                model.to(DEVICE).materialize(pc_batch(torch, px))
            except ValueError as e:
                print(f"perceiver_encoder at its shipped 12 channels raises, as the JAX "
                      f"package does: {str(e)[:120]}", flush=True)
            else:
                fail("perceiver_encoder at 12 channels built: the JAX package raises")
            model = pc_model(torch, config, input_channels=1, sat_channels=1)
            batch = pc_batch(torch, px, channels=1)
        else:
            batch = pc_batch(torch, px)
        rows[f"{config} forward"] = pc_forward(torch, model, batch, f"perceiver ({config}.yaml)",
                                               card)
        del model, batch
        torch.cuda.empty_cache()

    # (d) the shipped experiment through the CLI, as a user runs it, on the card
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "satflow_tpu_torch.run", "experiment=perceiver_simple",
             "trainer.max_steps=2", "trainer.log_every_n_steps=1", f"work_dir={work}/runs",
             "print_config=false"],
            capture_output=True, text=True, cwd=work, timeout=600,
            env={**os.environ, "PYTHONPATH": repo})
        wall = time.perf_counter() - t0
        csvs = [os.path.join(d, f) for d, _, fs in os.walk(work) for f in fs
                if f == "metrics.csv"]
        if out.returncode != 0 or len(csvs) != 1:
            fail(f"python -m satflow_tpu_torch.run experiment=perceiver_simple: exit "
                 f"{out.returncode}, {len(csvs)} metrics.csv; {out.stderr[-1500:]}")
        header = open(csvs[0]).read().splitlines()[0].split(",")
        if not {"train/loss", "val/loss", "test/loss", "mem/peak_gb"} <= set(header):
            fail(f"experiment=perceiver_simple: metrics.csv columns {header[:10]}")
    print(f"python -m satflow_tpu_torch.run experiment=perceiver_simple on the card: exit 0 in "
          f"{wall:.1f} s wall, train/val/test losses and the card's memory logged [{card}]",
          flush=True)

    launches = {c.__name__: c.launches for c in counters}
    if any(launches.values()):
        fail(f"the Perceiver path launched the repo's kernels: {launches}")
    print(f"Perceiver phase: {time.perf_counter() - t_phase:.1f} s; launches of the repo's "
          f"kernels over it: {launches} (none on this path) [{card}]", flush=True)
    return rows


# Phase 28f: the GAN family (nowcasting_gan, cloudgan_convlstm, cloudgan_runet,
# pix2pix at their shipped configs' widths, random weights from seeds, the
# fake schema; CloudGAN's ConvLSTM generator through K1 and K2)
GAN_B = 4
DGMR_T = 4  # DGMR's context: 4 frames (15 minutes), as in Ravuri et al.
DGMR_HW = 128  # nowcasting_gan.yaml's output_shape
DGMR_ROUNDS = 1
PIX2PIX_HW = 128  # unet_128 takes 128² inputs
# Tolerances:
# - DGMR's float32 sample on the card (cuDNN, TF32 off) against the same
#   forward on the host's CPU on one fixed latent: 24 lead times of a
#   4-scale ConvGRU stack summed in another order by another library;
#   tests/test_torch_gan_models.py holds the port to JAX at 1e-5 on the CPU.
TOL_GAN_F32 = 1e-3  # x max|cpu|
# - CloudGAN's float32 ConvLSTM rollout through K1 against the same rollout
#   through the plain step (sigmoid outputs in [0, 1]): each of its 31
#   recurrent steps (7 encoder + 24 decoder) within TOL_F32's atol 1e-4; their
#   sum, 3.1e-3, bounds the drift where the recurrence does not amplify it.
TOL_GAN_ROLLOUT_F32 = 5e-3
# - the float32 generator step's gradients through K1 + K2 against the
#   plain step's, both backwards taking the round's cotangent at the
#   kernels' sample: one cell step's bound, TOL_GRAD_F32 (the weight-grad
#   sums' rounding). A weight's gradient sums its 31 recurrent steps' parts,
#   each within that rounding of its own size, and the forget gates damp
#   what the hidden state's gradient carries back. On an NVIDIA H100 80GB
#   HBM3 at 700 W the worst tensor read 2.2e-5 on the cotangent; on each
#   forward's own loss, where the L1 term's signs flip between the two
#   forwards, it read 1.07e-3 and 6.94e-4 (PERF.md §6).
TOL_GAN_GRAD_F32 = TOL_GRAD_F32  # x max|grad| of each tensor
MIN_GAN_GRAD_COS_F32 = 0.99999


def gan_config(name: str, **overrides):
    """The port's model of the shipped ``configs/model/<name>.yaml`` (through
    the experiment entry point's mapping); weights from the default
    generator, seeded by the caller."""
    from satflow_tpu_torch.core import config as config_lib
    from satflow_tpu_torch.experiments.train import instantiate

    cfg = config_lib.compose(config_lib.default_config_dir(), "config.yaml",
                             [f"model={name}"])["model"]
    return instantiate(cfg, **overrides)


def gan_dm(torch, hw: int, channels: int, frames: int, steps: int, b: int = GAN_B,
           n_train: int = 1):
    from satflow_tpu_torch.data import SatFlowDataModule

    return SatFlowDataModule(fake_data=True, num_workers=0, n_train_data=n_train, n_val_data=1,
                             history_minutes=5 * (frames - 1), forecast_minutes=5 * steps,
                             fake_kwargs=dict(batch_size=b, width=hw, height=hw,
                                              number_sat_channels=channels))


def gan_sample(torch, model, x, what: str, card):
    """A b4 sample through ``InferenceSession`` (the generator alone), its
    device time by CUDA events over 3 calls after a warm-up and its peak
    memory above what earlier phases hold; returns (reply, ms, peak GiB)."""
    from satflow_tpu_torch.serve import InferenceSession

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    session = InferenceSession(model, max_batch=GAN_B, state_dict=model.module.state_dict(),
                               device=DEVICE)
    reply = session._forward(x)
    ms = cuda_ms(torch, lambda: session._forward(x), 3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if not bool(torch.isfinite(reply).all()):
        fail(f"{what}: sample not finite")
    print(f"{what}: b{GAN_B} sample {tuple(reply.shape)} through InferenceSession "
          f"{ms:.2f} ms (CUDA events, mean of 3), peak device memory {peak:.2f} GiB [{card}]",
          flush=True)
    return reply, ms, peak


def gan_round(torch, model, dm, what: str, card, counters=(), want_per_step=None,
              rounds: int = 1, zero_ok=()):
    """``rounds`` GAN rounds through ``Trainer.fit`` (the counters set to 0
    just before, read just after), losses finite; then every generator and
    discriminator parameter's gradient of one G-loss and one D-loss finite
    and nonzero (but ``zero_ok``'s, finite); then one more round timed on the
    host clock (synchronised) with its peak memory above the weights and
    both Adams' moments. Returns (fit launches, round ms, peak GiB, trainer)."""
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.steps import make_gan_train_step

    counter = LaunchesPerStep(*counters)
    trainer = Trainer(max_steps=rounds, log_every_n_steps=1, device=DEVICE, callbacks=[counter])
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    trainer.fit(model, dm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tuple(c.launches for c in counters)
    g = [e["train/g_loss"] for e in trainer.history.history if "train/g_loss" in e]
    d = [e["train/d_loss"] for e in trainer.history.history if "train/d_loss" in e]
    if trainer.global_step != rounds or len(g) != rounds or not all(np.isfinite(g + d)):
        fail(f"{what}: fit took {trainer.global_step} rounds; g {g}, d {d}")
    if want_per_step is not None and counter.per_step != [tuple(want_per_step)] * rounds:
        fail(f"{what}: launches per round {counter.per_step}, expected {tuple(want_per_step)}")
    batch = to_device(next(iter(dm.train_dataloader())), torch.device(DEVICE))
    for half in ("generator_loss", "discriminator_loss"):
        model.zero_grad(set_to_none=True)
        loss, _ = getattr(model, half)(batch)
        loss.backward()
        net = model.module if half == "generator_loss" else model.disc_module
        bad = [k for k, p in net.named_parameters() if p.grad is None
               or not bool(torch.isfinite(p.grad).all())
               or (k not in zero_ok and not bool((p.grad != 0).any()))]
        if bad or not bool(torch.isfinite(loss)):
            fail(f"{what}: {half} {loss.item()}; gradients missing, non-finite or zero: "
                 f"{bad[:5]}")
    model.zero_grad(set_to_none=True)
    step = make_gan_train_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    metrics = step(trainer.state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if not bool(metrics["finite"]):
        fail(f"{what}: timed round not finite")
    print(f"{what}: {rounds} round(s) of {getattr(model, 'disc_steps', 1)} D + 1 G update through "
          f"Trainer.fit in {wall:.2f} s wall (g_loss {', '.join(f'{v:.4f}' for v in g)}, d_loss "
          f"{', '.join(f'{v:.4f}' for v in d)}), every parameter's gradient finite and nonzero; "
          f"launches per round {counter.per_step[:1]}, fit total {launches}; one more round "
          f"{ms:.1f} ms (host clock, synchronised), peak device memory {peak:.2f} GiB above the "
          f"weights and both Adams' moments [{card}]", flush=True)
    return launches, ms, peak, trainer


def gan_slice(torch, card):
    """Phase 28f; returns ({what: (ms, peak GiB)}, K1 launches, K2 launches)."""
    import copy
    import tempfile

    from satflow_tpu_torch.ops.axial_attention import axial_attention
    from satflow_tpu_torch.ops.cmajor_convlstm import cmajor_conv3x3, cmajor_convlstm_step
    from satflow_tpu_torch.ops.fused_convlstm_int8 import fused_convlstm_step_int8
    from satflow_tpu_torch.ops.fused_convlstm_step import (
        fused_convlstm_step,
        fused_convlstm_step_halo,
        fused_convlstm_step_ref,
        gate_bwd,
    )
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.nn.norm import frozen_state
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates
    from satflow_tpu_torch.train.probabilistic import crps_finetune

    others = (fused_convlstm_step_halo, fused_lstm_gates, axial_attention,
              fused_convlstm_step_int8, cmajor_convlstm_step, cmajor_conv3x3)
    everything = (fused_convlstm_step, gate_bwd) + others
    rows = {}
    k1 = k2 = 0
    t_phase = time.perf_counter()
    rng = np.random.default_rng(15)

    def no_launches(what):
        launches = {c.__name__: c.launches for c in everything}
        if any(launches.values()):
            fail(f"{what} launched the repo's kernels: {launches}")

    # (a) nowcasting_gan.yaml: 128², 24 leads, context 384, latent 768, 3
    # samples, 2 D updates a round, b4 on 4 context frames
    torch.manual_seed(0)
    for c in everything:
        c.launches = 0
    model = gan_config("nowcasting_gan")
    if (model.output_shape, model.forecast_steps, model.context_channels,
            model.latent_channels, model.num_samples, model.disc_steps) != (
            DGMR_HW, STEPS, 384, 768, 3, 2):
        fail(f"nowcasting_gan.yaml built {model.hparams()}")
    x = torch.from_numpy(rng.random((GAN_B, DGMR_T, DGMR_HW, DGMR_HW, 1),
                                    dtype=np.float32)).to(DEVICE)
    y = torch.from_numpy(rng.random((GAN_B, STEPS, DGMR_HW, DGMR_HW, 1),
                                    dtype=np.float32)).to(DEVICE)
    model.to(DEVICE).materialize((x, y))
    n_params = sum(p.numel() for p in model.parameters())
    reply, ms, peak = gan_sample(torch, model, x, f"nowcastinggan (nowcasting_gan.yaml, "
                                 f"{n_params} parameters)", card)
    if tuple(reply.shape) != (GAN_B, STEPS, DGMR_HW, DGMR_HW, 1):
        fail(f"nowcastinggan: sample of shape {tuple(reply.shape)}")
    rows["nowcastinggan sample"] = (ms, peak)
    z = torch.randn(1, DGMR_HW // 32, DGMR_HW // 32, 8, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got = model._sample(x[:1], None, False, 1, z=z.to(DEVICE))[0].cpu()
        want = copy.deepcopy(model).cpu()._sample(x[:1].cpu(), None, False, 1, z=z)[0]
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if not err <= TOL_GAN_F32 * scale:
        fail(f"nowcastinggan: float32 sample on the card vs the CPU: max|diff| {err:.3g} > "
             f"{TOL_GAN_F32} x max|cpu| {scale:.3g}")
    print(f"nowcastinggan: one float32 sample on a fixed latent vs the CPU: max|diff| {err:.3g} "
          f"<= {TOL_GAN_F32} x max|cpu| {scale:.3g} ok [{card}]", flush=True)
    _, ms, peak, _ = gan_round(torch, model, gan_dm(torch, DGMR_HW, 1, DGMR_T, STEPS,
                                                    n_train=DGMR_ROUNDS),
                               "nowcastinggan (nowcasting_gan.yaml)", card, rounds=DGMR_ROUNDS,
                               # the hinge gives a critic's output bias (#fakes - #reals inside
                               # the margin) / B: zero when every score is inside it
                               zero_ok=("spatial.out.bias", "temporal.out.bias"))
    rows["nowcastinggan round"] = (ms, peak)
    no_launches("nowcastinggan")
    del model, x, y, reply
    torch.cuda.empty_cache()

    # (b) cloudgan_convlstm.yaml: the ConvLSTM generator (hidden 64) on 12
    # channels at 256², 7 in / 24 out, b4; float32 as shipped and a bfloat16 build
    x = torch.from_numpy(rng.random((GAN_B, T, H, W, CIN), dtype=np.float32)).to(DEVICE)
    dm = gan_dm(torch, H, CIN, T, STEPS)
    batch = None
    for dtype in (None, torch.bfloat16):
        label = f"cloudgan (cloudgan_convlstm.yaml, {'bf16' if dtype else 'float32'})"
        torch.manual_seed(0)
        model = gan_config("cloudgan_convlstm", dtype=dtype).to(DEVICE)
        if (model.generator_model, model.num_filters, model.channels_per_timestep,
                model.forecast_steps, model.condition_time) != ("convlstm", HIDDEN, CIN,
                                                                STEPS, True):
            fail(f"cloudgan_convlstm.yaml built {model.hparams()}")
        model.materialize((x, x[:, :1].expand(-1, STEPS, -1, -1, -1)))
        for c in everything:
            c.launches = 0
        reply, ms, peak = gan_sample(torch, model, x, label, card)
        # the warm-up and 3 timed calls: 4 generator forwards
        if fused_convlstm_step.launches != 4 * LAUNCHES_PER_FORWARD or gate_bwd.launches:
            fail(f"{label}: K1 {fused_convlstm_step.launches}, K2 {gate_bwd.launches} launches "
                 f"in 4 samples, expected {4 * LAUNCHES_PER_FORWARD} and 0")
        k1 += fused_convlstm_step.launches
        no_launches_other = {c.__name__: c.launches for c in others}
        if any(no_launches_other.values()):
            fail(f"{label}: other kernels launched: {no_launches_other}")
        with torch.inference_mode():
            plain = model.generate(x, False, None, step=fused_convlstm_step_ref)
        err = float((reply.float() - plain.float()).abs().max())
        tol = TOL_ROLLOUT if dtype else TOL_GAN_ROLLOUT_F32
        if not err <= tol:
            fail(f"{label}: sample through K1 vs the plain step: max|diff| {err:.3g} > {tol}")
        rows[f"{label} sample"] = (ms, peak)
        print(f"{label}: {LAUNCHES_PER_FORWARD} K1 launches a generator forward (2T + 2F), the "
              f"sample vs the plain step max|diff| {err:.3g} <= {tol} ok [{card}]", flush=True)
        # one round: the D step's eval-mode sample and the G step's forward,
        # each 62 K1, and the G step's backward through K2 (62)
        want = (2 * LAUNCHES_PER_FORWARD, LAUNCHES_PER_FORWARD)
        _, ms, peak, trainer = gan_round(torch, model, dm, label, card,
                                         (fused_convlstm_step, gate_bwd), want)
        # set to 0 just before the fit: its rounds and validation, the
        # gradient checks and the timed round
        k1 += fused_convlstm_step.launches
        k2 += gate_bwd.launches
        rows[f"{label} round"] = (ms, peak)
        batch = trainer.last_batch

        # The generator step's gradients through K1 + K2 against the plain
        # step's. Its loss is the adversarial term through the frozen-state
        # discriminator plus lambda_l1 (100) x L1, whose gradient is the sign of
        # y_hat - y: a one-bf16-step difference between the two forwards flips
        # it wherever |y_hat - y| is below a bf16 step. So both backwards take
        # the cotangent of the round's loss at the kernels' sample, dL/dy_hat,
        # entering through the discriminator; the whole loss's gradients are
        # printed beside it.
        params = [p for _, p in model.module.named_parameters()]
        names = [n for n, _ in model.module.named_parameters()]
        model.zero_grad(set_to_none=True)
        x_b, y_b = model.prepare_batch(batch)
        y_hat = model.generate(x_b, True)
        with frozen_state(model.disc_module):
            score = model.discriminate(model.disc_input(x_b, y_hat), True)
        loss = model.adv_loss(score, True) + model.lambda_l1 * model.criterion(y_hat, y_b)
        (cot,) = torch.autograd.grad(loss, y_hat, retain_graph=True)
        before = fused_convlstm_step.launches, gate_bwd.launches
        got = dict(zip(names, torch.autograd.grad(y_hat, params, cot)))
        del y_hat, score, loss
        y_plain = model.generate(x_b, True, step=fused_convlstm_step_ref)
        want_g = dict(zip(names, torch.autograd.grad(y_plain, params, cot)))
        del y_plain
        full = {}
        for step_kw in ({}, {"step": fused_convlstm_step_ref}):
            model.zero_grad(set_to_none=True)
            model.generator_loss(batch, **step_kw)[0].backward()
            full[bool(step_kw)] = {n: p.grad.float() for n, p in model.module.named_parameters()}
        model.zero_grad(set_to_none=True)
        k1 += fused_convlstm_step.launches - before[0] + LAUNCHES_PER_FORWARD
        k2 += gate_bwd.launches - before[1]
        tol, min_cos = ((TOL_TRAIN_GRAD, MIN_TRAIN_GRAD_COS) if dtype
                        else (TOL_GAN_GRAD_F32, MIN_GAN_GRAD_COS_F32))

        def compare(a, b):
            rel = (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
            cos = torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(),
                                                        dim=0).item()
            return rel, cos

        worst, worst_cos = 0.0, 1.0
        for name, g in got.items():
            if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
                fail(f"{label}: generator gradient of {name} through the kernels not finite "
                     "or zero")
            rel, cos = compare(g, want_g[name])
            worst, worst_cos = max(worst, rel), min(worst_cos, cos)
            if not (rel <= tol and cos >= min_cos):
                fail(f"{label}: generator gradient of {name} vs the plain step: "
                     f"{rel:.3g} (tol {tol}), cosine {cos:.6f} (min {min_cos})")
        whole = [compare(full[False][n], full[True][n]) for n in names]
        print(f"{label}: the generator step's gradients through K1 + K2 vs the plain step on "
              f"the round's cotangent: max|diff| / max|grad| {worst:.3g} <= {tol}, cosine "
              f"{worst_cos:.6f} >= {min_cos} ok; on each forward's own loss (L1 signs flip): "
              f"{max(r for r, _ in whole):.3g}, cosine {min(c for _, c in whole):.6f} [{card}]",
              flush=True)
        del model, trainer, reply, plain
        torch.cuda.empty_cache()
    del x, dm, batch

    # (c) cloudgan_runet.yaml (256²) and pix2pix.yaml (unet_128, 128²): one
    # sample and one round each, none of the repo's kernels
    for config, hw in (("cloudgan_runet", H), ("pix2pix", PIX2PIX_HW)):
        for c in everything:
            c.launches = 0
        torch.manual_seed(0)
        model = gan_config(config).to(DEVICE)
        x = torch.from_numpy(rng.random((GAN_B, T, hw, hw, CIN), dtype=np.float32)).to(DEVICE)
        model.materialize((x, x[:, :1].expand(-1, STEPS, -1, -1, -1)))
        n_params = sum(p.numel() for p in model.parameters())
        reply, ms, peak = gan_sample(torch, model, x, f"{config}.yaml ({n_params} parameters)",
                                     card)
        if tuple(reply.shape) != (GAN_B, STEPS, hw, hw, CIN):
            fail(f"{config}: sample of shape {tuple(reply.shape)}")
        rows[f"{config} sample"] = (ms, peak)
        _, ms, peak, _ = gan_round(torch, model, gan_dm(torch, hw, CIN, T, STEPS),
                                   f"{config}.yaml", card)
        rows[f"{config} round"] = (ms, peak)
        no_launches(config)
        del model, x, reply
        torch.cuda.empty_cache()

    # (d) experiment=nowcasting_gan_simple through the CLI on the card (its
    # datamodule's 24 lead times against the model's 6 is a fault of the
    # config, ROADMAP §3: the forecast window is set to the model's 6), the
    # checkpoint monitored on val/g_loss, served through local:, and the
    # eval CLI's --ensemble 3 on it
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "satflow_tpu_torch.run", "experiment=nowcasting_gan_simple",
             "datamodule.forecast_minutes=30", "trainer.max_steps=2",
             "trainer.log_every_n_steps=1", f"work_dir={work}/runs", "print_config=false"],
            capture_output=True, text=True, cwd=work, timeout=600, env=env)
        wall = time.perf_counter() - t0
        bests = [d for d, _, fs in os.walk(work) if d.endswith(os.path.join("checkpoints", "best"))
                 and "state.pt" in fs]
        if out.returncode != 0 or len(bests) != 1:
            fail(f"experiment=nowcasting_gan_simple: exit {out.returncode}, {len(bests)} best "
                 f"checkpoints; {out.stderr[-1500:]}")
        meta = json.load(open(os.path.join(bests[0], "hparams.json")))
        if meta["hparams"]["class"] != "NowcastingGAN" or "val/g_loss" not in meta["metrics"]:
            fail(f"experiment=nowcasting_gan_simple: best checkpoint {meta}")
        from satflow_tpu_torch.serve import InferenceSession

        session = InferenceSession("local:" + bests[0], max_batch=2, device=DEVICE)
        frames = 30 // 5 + 1
        sample = session.predict(rng.random((2, frames, 32, 32, 1), dtype=np.float32))
        if sample.shape != (2, 6, 32, 32, 1) or not np.isfinite(sample).all():
            fail(f"nowcasting_gan_simple served from local: {sample.shape}")
        ev = subprocess.run(
            [sys.executable, "-m", "satflow_tpu_torch.eval.evaluate", "--checkpoint", bests[0],
             "--ensemble", "3", "--dataset", "fake", "--size", "32", "--channels", "1",
             "--history-minutes", "30", "--batches", "2", "--output", f"{work}/eval"],
            capture_output=True, text=True, cwd=work, timeout=600, env=env)
        if ev.returncode != 0:
            fail(f"eval --ensemble 3 on the GAN checkpoint: exit {ev.returncode}; "
                 f"{ev.stderr[-1500:]}")
        summary = json.loads(ev.stdout.strip().splitlines()[-1])
        if not (np.isfinite(summary["crps_mean"]) and summary["sample_std"] > 0):
            fail(f"eval --ensemble 3: {summary}")
    print(f"python -m satflow_tpu_torch.run experiment=nowcasting_gan_simple "
          f"datamodule.forecast_minutes=30 on the card: exit 0 in {wall:.1f} s wall, the best "
          f"checkpoint on val/g_loss {meta['metrics']['val/g_loss']:.4f}; served from local: "
          f"{sample.shape}; eval --ensemble 3: crps_mean {summary['crps_mean']:.4f}, sample_std "
          f"{summary['sample_std']:.4f} [{card}]", flush=True)

    # (e) crps_finetune at the experiment's size: 3 steps, finite fair CRPS
    model = gan_config("nowcasting_gan", forecast_steps=6, output_shape=32,
                       context_channels=64, latent_channels=128).to(DEVICE)
    dm = gan_dm(torch, 32, 1, 7, 6)
    batches = [to_device(next(iter(dm.train_dataloader())), torch.device(DEVICE))]
    model.materialize(batches[0])
    t0 = time.perf_counter()
    _, history = crps_finetune(model, batches, steps=3, num_samples=3, lr=2e-3, log_every=1)
    torch.cuda.synchronize()
    if not all(np.isfinite(history)):
        fail(f"crps_finetune: losses {history}")
    print(f"crps_finetune (nowcasting_gan_simple's size, 3 samples): 3 steps in "
          f"{time.perf_counter() - t0:.2f} s wall, fair CRPS "
          + ", ".join(f"{v:.5f}" for v in history) + f" [{card}]", flush=True)
    del model

    print(f"GAN phase: {time.perf_counter() - t_phase:.1f} s; K1 {k1} and K2 {k2} launches on "
          f"CloudGAN's ConvLSTM generator (samples, rounds, gradient checks) [{card}]", flush=True)
    return rows, k1, k2


# Phase 28g: the parallel paths (satflow_tpu_torch/parallel): K1 and K2 on
# halo-extended blocks of rows against the whole image, then, under a
# one-rank NCCL process group, data-parallel, ZeRO and spatial ("1x1") fits
# of the full-width ConvLSTM, a MetNet data-parallel step and the mesh
# session. NCCL refuses two ranks on one card, so multi-rank results are held
# on the CPU (tests/test_torch_parallel.py, tests/test_torch_spatial.py).
PAR_MS = (2, 4)  # blocks of rows, as an H-sharded rollout over M ranks cuts them
PAR_STEPS = 2
# Tolerances:
# - K1 on each block's halo-extended rows against K1 on the whole image: the
#   same kernel on the same windows (phase 3's tolerances); K2's block
#   backward and the data gradients likewise (TOL_GRAD_F32 x max|grad|, phase
#   5's). A weight gradient is a library weight-grad conv over B*H*W = 5e5
#   products on each side, split into M partial convs on one: each side lies
#   within phase 5's TOL_GRAD_F32 of the exact sum, so the two within twice
#   it (float32; first read 1.02e-4 x max|grad| for dWh at M=2, Cx=64, NVIDIA
#   H100 80GB HBM3, 700 W). In bfloat16 the M partial sums are each rounded
#   to bf16 before they are added (TOL_TRAIN_GRAD x max|grad|).
TOL_BLOCK_WGRAD_F32 = 2 * TOL_GRAD_F32
# - each fit's losses against the plain fit's from the same weights and data:
#   with one rank the all-reduces divide by one and ZeRO steps every
#   parameter, so they agree to the bf16 rounding of the step (phase 8's
#   gradient tolerance TOL_TRAIN_GRAD, relative); the spatial rollout runs K1
#   on rows with zero halos and keeps no remat, the same operations.


def check_halo_blocks(torch, card):
    """Phase 28g (a): ``spatial._cell_step`` on each of M blocks of rows, its
    halos cut from the whole tensors (``spatial.WholeHalos``), stitched,
    against the whole image's step, forward (K1, M launches a cell step) and
    one backward (K2, M launches); returns the largest |diff| of h'."""
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step, gate_bwd
    from satflow_tpu_torch.parallel.spatial import WholeHalos, _cell_step

    worst = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for cx in (CIN, HIDDEN):
            args = [a.requires_grad_() for a in step_inputs(torch, cx, dtype, seed=500 + cx)]
            x, h, c, wx, wh, b = args
            dh, dc = cotangents(torch, dtype, seed=600 + cx)
            want = fused_convlstm_step(*args)
            want_g = torch.autograd.grad(want, args, (dh, dc))
            # the three parameters _cell_step reads from a fused cell
            cell = types.SimpleNamespace(x_gates_kernel=wx, h_gates_kernel=wh, bias=b)
            for m in PAR_MS:
                hl = H // m
                fused_convlstm_step.launches = gate_bwd.launches = 0
                blocks = [_cell_step(x[:, i * hl:(i + 1) * hl], h[:, i * hl:(i + 1) * hl],
                                     c[:, i * hl:(i + 1) * hl], cell,
                                     WholeHalos([x, h], i, m), dtype) for i in range(m)]
                got = [torch.cat([blk[k] for blk in blocks], dim=1) for k in (0, 1)]
                k1 = fused_convlstm_step.launches
                got_g = torch.autograd.grad(got, args, (dh, dc))
                torch.cuda.synchronize()
                k2 = gate_bwd.launches
                if (k1, k2) != (m, m):
                    fail(f"halo blocks M={m}: K1 {k1} and K2 {k2} launches, expected {m} each")
                errs = {}
                for name, g_, w_ in (("h", got[0], want[0]), ("c", got[1], want[1])):
                    errs[name] = (g_.float() - w_.float()).abs().max().item()
                    if not within(torch, g_, w_, tol):
                        fail(f"halo blocks M={m} {dtype} Cx={cx}: {name}' vs the whole image "
                             f"max|diff| {errs[name]:.3g} tol {tol}")
                for name, g_, w_ in zip(("dx", "dh", "dc", "dWx", "dWh", "db"), got_g, want_g):
                    gtol = (TOL_TRAIN_GRAD if dtype == torch.bfloat16 else
                            TOL_BLOCK_WGRAD_F32 if name in ("dWx", "dWh", "db") else TOL_GRAD_F32)
                    rel = (g_.float() - w_.float()).abs().max().item() / w_.float().abs().max().item()
                    errs[name] = rel
                    if not rel <= gtol:
                        fail(f"halo blocks M={m} {dtype} Cx={cx}: {name} vs the whole image "
                             f"max|diff| / max|grad| {rel:.3g} > {gtol}")
                worst = max(worst, errs["h"])
                print(f"K1 / K2 on {m} halo-extended blocks of {hl}+2 rows vs the whole image, "
                      f"{str(dtype)[6:]} B={B} {H}x{W} Cx={cx} Ch={HIDDEN}: h' {errs['h']:.3g}, "
                      f"c' {errs['c']:.3g} (tol {tol}); gradients max|diff| / max|grad| "
                      + ", ".join(f"{k} {errs[k]:.2g}" for k in ("dx", "dh", "dc", "dWx", "dWh",
                                                                  "db"))
                      + f" (tol {TOL_GRAD_F32}, weights {TOL_BLOCK_WGRAD_F32} in float32; "
                      f"{TOL_TRAIN_GRAD} in bfloat16); launches K1 {k1}, K2 {k2} [{card}]",
                      flush=True)
    return worst


def _par_model(torch, **kw):
    from satflow_tpu_torch.interop.jax_weights import params_from_flax
    from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM

    model = EncoderDecoderConvLSTM(hidden_dim=HIDDEN, input_channels=CIN, out_channels=COUT,
                                   forecast_steps=STEPS, remat=True, remat_chunk=REMAT_CHUNK, **kw)
    model.module.load_state_dict(params_from_flax(flax_params(0)))
    return model


def _par_dm():
    from satflow_tpu_torch.data import SatFlowDataModule

    return SatFlowDataModule(fake_data=True, num_workers=0, n_train_data=PAR_STEPS, n_val_data=1,
                             history_minutes=5 * (T - 1), forecast_minutes=5 * STEPS,
                             fake_kwargs=dict(batch_size=B, width=W, height=H))


class _CachedData:
    """A data module's batches made once (the fake data's b8 256² batches
    take seconds each to generate) and served as lists: the Trainer puts
    each on the card itself (``shard_batch`` under a process group)."""

    def __init__(self, dm):
        self.train, self.val = list(dm.train_dataloader()), list(dm.val_dataloader())

    def train_dataloader(self):
        return self.train

    def val_dataloader(self):
        return self.val


def _par_fit(torch, model, dm, counters, what: str, card, **trainer_kw):
    """``Trainer(precision="bf16").fit`` for PAR_STEPS steps, the counters
    set to 0 just before and read just after; returns (losses, launches per
    step, fit launches, trainer)."""
    from satflow_tpu_torch.train import Trainer

    counter = LaunchesPerStep(*counters)
    trainer = Trainer(max_steps=PAR_STEPS, precision="bf16", log_every_n_steps=1, device=DEVICE,
                      callbacks=[counter], **trainer_kw)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    trainer.fit(model, dm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tuple(c.launches for c in counters)
    losses = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
    if trainer.global_step != PAR_STEPS or len(losses) != PAR_STEPS or not all(
            np.isfinite(losses)):
        fail(f"{what}: fit took {trainer.global_step} steps; losses {losses}")
    data = "on batches made beforehand" if isinstance(dm, _CachedData) else "with data generation"
    print(f"{what}: {PAR_STEPS} bf16 steps through Trainer.fit (b{B} {H}x{W}, {T} in / "
          f"{STEPS} out) in {wall:.2f} s wall {data}: losses "
          + ", ".join(f"{v:.6f}" for v in losses) + f"; launches per step {counter.per_step}, "
          f"fit total {launches} [{card}]", flush=True)
    return losses, counter.per_step, launches, trainer


def _hold_losses(losses, plain, what: str, card) -> None:
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    if not rel <= TOL_TRAIN_GRAD:
        fail(f"{what}: losses {losses} vs the plain fit's {plain}: relative {rel:.3g} > "
             f"{TOL_TRAIN_GRAD}")
    print(f"{what}: losses vs the plain fit's from the same weights: max relative diff "
          f"{rel:.3g} <= {TOL_TRAIN_GRAD} ok [{card}]", flush=True)


def _metnet_dp_step(torch, counters, what: str, card):
    """One bf16 MetNet (metnet.yaml) step through Trainer.fit on fake 23-channel
    data; returns (loss, launches per step, fit launches)."""
    from satflow_tpu_torch.data import SatFlowDataModule
    from satflow_tpu_torch.train import Trainer

    gen = torch.Generator()
    model = _metnet(torch, generator=gen, warmup_steps=1000, total_steps=100_000)
    model.module.load_state_dict(model.state_dict_from_flax(
        metnet_flax_variables(4 * MN_TRAIN_CIN + MN_F, seed=1)))
    dm = SatFlowDataModule(fake_data=True, num_workers=0, n_train_data=1, n_val_data=1,
                           history_minutes=5 * (T - 1), forecast_minutes=5 * MN_F,
                           fake_kwargs=dict(batch_size=B, width=W, height=H))
    counter = LaunchesPerStep(*counters)
    trainer = Trainer(max_steps=1, precision="bf16", log_every_n_steps=1, device=DEVICE,
                      callbacks=[counter])
    gen.manual_seed(0)
    for c in counters:
        c.launches = 0
    trainer.fit(model, dm)
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    losses = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
    if len(losses) != 1 or not np.isfinite(losses[0]):
        fail(f"{what}: losses {losses}")
    if counter.per_step != [(MN_K3_PER_FORWARD, MN_K4_PER_FORWARD)]:
        fail(f"{what}: (K3, K4) launches in the step {counter.per_step}")
    print(f"{what}: one bf16 step (b{B} {H}x{W}x{MN_TRAIN_CIN}): loss {losses[0]:.6f}; (K3, K4) "
          f"launches in the step {counter.per_step[0]}, fit total {launches} [{card}]", flush=True)
    return losses[0], counter.per_step[0], launches


def parallel_slice(torch, card):
    """Phase 28g; returns the launches {"K1", "K2", "K3", "K4"} of its main
    paths (the fits, the MetNet step, the mesh session)."""
    import socket

    from satflow_tpu_torch.ops.axial_attention import axial_attention
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step, gate_bwd
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates
    from satflow_tpu_torch.parallel.distributed import (
        is_distributed,
        maybe_initialize_distributed,
        shutdown_distributed,
    )
    from satflow_tpu_torch.parallel.zero import apply_zero_sharding
    from satflow_tpu_torch.serve import InferenceSession
    from satflow_tpu_torch.train.state import TrainState
    from satflow_tpu_torch.train.steps import make_train_step

    launches = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    k12 = (fused_convlstm_step, gate_bwd)
    remat_step = (K1_PER_TRAIN_STEP, K2_PER_TRAIN_STEP)

    def count(fit_launches, names=("K1", "K2")):
        for name, n in zip(names, fit_launches):
            launches[name] += n

    # the plain fits, without a process group
    data = _CachedData(_par_dm())
    plain, _, fit_l, _ = _par_fit(torch, _par_model(torch), data, k12,
                                  "ConvLSTM, no process group", card)
    count(fit_l)
    mn_plain, _, mn_l = _metnet_dp_step(torch, (fused_lstm_gates, axial_attention),
                                        "MetNet, no process group", card)
    count(mn_l, ("K3", "K4"))

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    multi = maybe_initialize_distributed(f"127.0.0.1:{port}", 1, 0, backend="cuda")
    if multi or not is_distributed() or torch.distributed.get_backend() != "nccl":
        fail("phase 28g: no one-rank NCCL process group")
    print(f"one-rank NCCL process group up in {time.perf_counter() - t0:.2f} s", flush=True)
    try:
        # data parallelism: the gradients' all-reduce, the broadcast from rank 0,
        # the data module's loaders cutting this rank's block
        losses, per_step, fit_l, _ = _par_fit(torch, _par_model(torch), _par_dm(), k12,
                                              "ConvLSTM DP (NCCL, 1 rank)", card)
        if per_step != [remat_step] * PAR_STEPS:
            fail(f"DP fit: (K1, K2) launches per step {per_step}, expected {remat_step}")
        _hold_losses(losses, plain, "ConvLSTM DP", card)
        count(fit_l)
        # ZeRO through the Trainer (a world of one keeps the state, as in JAX),
        # then ZeroRedundancyOptimizer itself on the same steps
        losses, per_step, fit_l, trainer = _par_fit(torch, _par_model(torch), data, k12,
                                                    "ConvLSTM zero_sharding=True", card,
                                                    zero_sharding=True)
        _hold_losses(losses, plain, "ConvLSTM zero_sharding=True", card)
        count(fit_l)
        model = _par_model(torch).to(DEVICE)
        model.set_compute_dtype(torch.bfloat16)
        state = apply_zero_sharding(TrainState(model, model.make_optimizer()))
        step = make_train_step(model)
        fused_convlstm_step.launches = gate_bwd.launches = 0
        from satflow_tpu_torch.data.datamodule import to_device

        zl = [float(step(state, to_device(batch, torch.device(DEVICE)))["loss"])
              for batch in data.train]
        count((fused_convlstm_step.launches, gate_bwd.launches))
        if (fused_convlstm_step.launches, gate_bwd.launches) != (PAR_STEPS * remat_step[0],
                                                                PAR_STEPS * remat_step[1]):
            fail(f"ZeRO steps launched K1 {fused_convlstm_step.launches}, K2 {gate_bwd.launches}")
        print(f"ConvLSTM under {type(state.optimizer).__name__} ({type(state.optimizer.optim).__name__}"
              f" inside): {PAR_STEPS} steps, losses " + ", ".join(f"{v:.6f}" for v in zl)
              + f" [{card}]", flush=True)
        _hold_losses(zl, plain, "ConvLSTM ZeroRedundancyOptimizer", card)
        # the spatial rollout, one block: K1 on zero-haloed rows, no remat
        model = _par_model(torch)
        losses, per_step, fit_l, trainer = _par_fit(torch, model, data, k12,
                                                    'ConvLSTM spatial="1x1"', card,
                                                    spatial="1x1")
        if model.spatial_mesh is None or per_step != [(LAUNCHES_PER_FORWARD,
                                                       LAUNCHES_PER_FORWARD)] * PAR_STEPS:
            fail(f"spatial fit: (K1, K2) launches per step {per_step}, expected "
                 f"{(LAUNCHES_PER_FORWARD, LAUNCHES_PER_FORWARD)} (no remat)")
        _hold_losses(losses, plain, 'ConvLSTM spatial="1x1"', card)
        count(fit_l)
        print(f'spatial="1x1" fit: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}'
              f" GiB [{card}]", flush=True)
        del trainer, model, state, data
        # MetNet under data parallelism
        mn_loss, _, mn_l = _metnet_dp_step(torch, (fused_lstm_gates, axial_attention),
                                           "MetNet DP (NCCL, 1 rank)", card)
        _hold_losses([mn_loss], [mn_plain], "MetNet DP", card)
        count(mn_l, ("K3", "K4"))
        # the mesh session: one replica a device of the mesh
        from satflow_tpu_torch.interop.jax_weights import params_from_flax
        from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM

        def session(**kw):
            model = EncoderDecoderConvLSTM(hidden_dim=HIDDEN, input_channels=CIN,
                                           out_channels=COUT, forecast_steps=STEPS)
            return InferenceSession(model, max_batch=B, dtype=torch.bfloat16,
                                    state_dict=params_from_flax(flax_params(0)), **kw)

        x = np.random.default_rng(9).random((B, T, H, W, CIN)).astype(np.float32)
        meshed, single = session(mesh=[DEVICE + ":0"]), session(device=DEVICE)
        fused_convlstm_step.launches = 0
        got = meshed.predict(x)
        k1 = fused_convlstm_step.launches
        want = single.predict(x)
        if k1 != LAUNCHES_PER_FORWARD or not np.array_equal(got, want):
            fail(f"mesh session: {k1} K1 launches, reply vs the session without a mesh "
                 f"max|diff| {float(np.abs(got - want).max()):.3g}")
        launches["K1"] += k1
        print(f'InferenceSession(mesh=["{DEVICE}:0"]): a b{B} request in one forward, '
              f"{k1} K1 launches, the reply equal to the session without a mesh [{card}]",
              flush=True)
    finally:
        shutdown_distributed()
    if is_distributed():
        fail("phase 28g: the process group outlived the phase")
    return launches


# Phase 28h: the quality studies' tools (satflow_tpu_torch/tools, the port's
# copies of the JAX package's tools/accuracy_gate.py, accuracy_256.py,
# gan_gate.py, gan_128.py and horizon_gate.py), each tool's main at a small
# budget through its entry point. Every train step's launches are counted
# (a LaunchesPerStep on every Trainer the tools build) and held to the
# rollout's cell steps; the results' row names and keys to the JAX study's
# artifact (docs/*.json) for the arms run; every number finite.
KERNEL_IDS = ("K1", "K2", "K3", "K4")  # the keys of a study row's kernel_launches
QT_BATCHES = {"accuracy_256": 4, "accuracy_gate": 4, "gan_gate": 4, "gan_128": 2,
              "horizon_gate": 2}  # batches (rounds) of the one epoch of each tool


def _finite_tree(tree, where: str) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _finite_tree(v, f"{where}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _finite_tree(v, f"{where}[{i}]")
    elif isinstance(tree, float) and not np.isfinite(tree):
        fail(f"phase 28h: {where} = {tree}")


def _same_rows(res: dict, artifact: str, rows=None) -> None:
    """``res`` has the JAX artifact's rows of the arms run (``rows``; all of
    them by default), each with at least the JAX row's keys (the port adds
    its training seconds)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs", artifact)) as f:
        jax_rows = json.load(f)
    rows = list(jax_rows) if rows is None else rows
    missing = [r for r in rows if r not in jax_rows]
    if missing:
        fail(f"phase 28h: {missing} are not rows of docs/{artifact}")
    if set(res) != set(rows):
        fail(f"phase 28h: {artifact} rows {sorted(res)}, expected {sorted(rows)}")
    for r in rows:
        if isinstance(jax_rows[r], dict) and not set(jax_rows[r]) <= set(res[r]):
            fail(f"phase 28h: {artifact} {r} lacks {set(jax_rows[r]) - set(res[r])}")


@contextlib.contextmanager
def _counted_trainers(torch, counters, before_fit=None):
    """Every Trainer the tools build inside gets a LaunchesPerStep of
    ``counters``, and every train step it makes is timed (synchronised,
    host clock; the batch's generation on the host left out); yields the
    lists of both and of each fit's launches (validation included), one
    entry a fit, and the trainers. ``before_fit(model)`` is called as each
    fit starts."""
    import satflow_tpu_torch.train as train_pkg
    from satflow_tpu_torch.train import engine

    base, fits, step_ms, fit_launches, trainers = train_pkg.Trainer, [], [], [], []
    makers = {name: getattr(engine, name) for name in ("make_train_step", "make_gan_train_step")}

    class Counted(base):
        def __init__(self, *args, callbacks=None, **kwargs):
            fits.append(LaunchesPerStep(*counters))
            trainers.append(self)
            super().__init__(*args, callbacks=list(callbacks or []) + [fits[-1]], **kwargs)

        def fit(self, *args, **kwargs):
            if before_fit is not None:
                before_fit(args[0])
            before = [c.launches for c in counters]
            try:
                return super().fit(*args, **kwargs)
            finally:
                fit_launches.append(tuple(c.launches - b for c, b in zip(counters, before)))

    def timed(make):
        def make_timed(*args, **kwargs):
            step, times = make(*args, **kwargs), []
            step_ms.append(times)

            def run(state, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
                return out
            return run
        return make_timed

    train_pkg.Trainer = Counted
    for name, make in makers.items():
        setattr(engine, name, timed(make))
    try:
        yield fits, step_ms, fit_launches, trainers
    finally:
        train_pkg.Trainer = base
        for name, make in makers.items():
            setattr(engine, name, make)


def quality_tools_slice(torch, card):
    """Phase 28h; returns the phase's (K1, K2, K3, K4) launches."""
    import tempfile

    from satflow_tpu_torch.ops.axial_attention import axial_attention
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step, gate_bwd
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates
    from satflow_tpu_torch.tools import accuracy_256, accuracy_gate, gan_128, gan_gate, horizon_gate

    counters = (fused_convlstm_step, gate_bwd, fused_lstm_gates, axial_attention)
    totals = [0, 0, 0, 0]
    t_phase = time.perf_counter()
    frames = 4  # every study's 15 history minutes
    metnet_step = (0, 0, frames, MN_K4_PER_FORWARD)  # a K3 a history frame; plain backward

    def run(what, want_steps, fn, *args, trained_rows=(), rest_row=None, before_fit=None,
            **kwargs):
        """``fn`` with its stdout kept (each tool prints its results), each
        fit's steps held to ``want_steps`` (one (K1, K2, K3, K4) a fit), the
        ``kernel_launches`` of ``trained_rows`` (one a fit, in order) to the
        launches the counters saw over that fit, and those of ``rest_row``
        to the tool's launches outside its fits; ``before_fit(model)`` as
        each fit starts. Returns the results, the step times and the
        trainers."""
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        with _counted_trainers(torch, counters, before_fit) as (
                fits, step_ms, fit_launches, trainers), contextlib.redirect_stdout(io.StringIO()):
            res = fn(*args, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = [c.launches for c in counters]
        for i, n in enumerate(got):
            totals[i] += n
        if len(fits) != len(want_steps):
            fail(f"phase 28h {what}: {len(fits)} fits, expected {len(want_steps)}")
        for fit, want in zip(fits, want_steps):
            if not fit.per_step or any(s != tuple(want) for s in fit.per_step):
                fail(f"phase 28h {what}: (K1, K2, K3, K4) launches per step {fit.per_step}, "
                     f"expected {tuple(want)} each")
        checks = list(zip(trained_rows, fit_launches))
        if rest_row:
            checks.append((rest_row, tuple(n - sum(f[i] for f in fit_launches)
                                           for i, n in enumerate(got))))
        for row, seen in checks:
            if res[row].get("kernel_launches") != dict(zip(KERNEL_IDS, seen)):
                fail(f"phase 28h {what}: {row} records kernel_launches "
                     f"{res[row].get('kernel_launches')}, the counters saw {seen} (K1-K4)")
        _finite_tree(res, what)
        print(f"{what}: {wall:.1f} s wall; " + "; ".join(
            f"{len(f.per_step)} steps of {f.per_step[0]} (median {np.median(ms):.1f} ms, "
            f"first {ms[0]:.1f})" for f, ms in zip(fits, step_ms))
              + f" (K1, K2, K3, K4); launches K1 {got[0]}, K2 {got[1]}, K3 {got[2]}, "
              f"K4 {got[3]} [{card}]", flush=True)
        return res, step_ms, trainers

    with tempfile.TemporaryDirectory(prefix="chip_smoke_quality_") as root:
        # accuracy_256 at full width: 256², b8, hidden 64, 24 leads, bf16,
        # remat chunk 6: the main path's train step on the study's 4 history
        # frames of 1 channel, 112 K1 + 56 K2 (124 + 62 with phase 8's 7)
        n = QT_BATCHES["accuracy_256"]
        per_forward = 2 * frames + 2 * accuracy_256.STEPS
        res, step_ms, _ = run("accuracy_256 (1 epoch)", [(2 * per_forward, per_forward, 0, 0)],
                  accuracy_256.main, 1, out=root, device=DEVICE, length=n)
        _same_rows(res, "accuracy_256.json", ("persistence@256px", "optical_flow@256px",
                                              "convlstm@256px"))
        row = res["convlstm@256px"]
        print(f"  convlstm@256px after {row['optimizer_steps']} steps: MSE {row['mse']:.5f}, "
              f"MS-SSIM {row['ms_ssim']:.4f}; train step median {np.median(step_ms[0][1:]):.1f} "
              f"ms after the first (phase 8's full-width step: 12 input channels), "
              f"{1e3 * row['train_seconds'] / n:.1f} ms a step with its data and validation "
              f"(persistence {res['persistence@256px']['mse']:.5f}, flow "
              f"{res['optical_flow@256px']['mse']:.5f})", flush=True)

        # the accuracy gate's MetNet arms: K3 / K4 on 64 px, float32
        res, _, _ = run("accuracy_gate metnet, metnet_stoch (1 epoch each)", [metnet_step] * 2,
                  accuracy_gate.main, ["metnet", "metnet_stoch"], out=root, device=DEVICE,
                  epochs={"metnet": 1, "metnet_stoch": 1}, length=QT_BATCHES["accuracy_gate"])
        metnet_rows = ("persistence@metnet_grid", "optical_flow@metnet_grid", "metnet",
                       "persistence@metnet_grid_stoch", "optical_flow@metnet_grid_stoch",
                       "metnet@stoch")
        _same_rows(res, "accuracy_results.json", metnet_rows)

        # the accuracy gate's Perceiver and stacked arms at full resolution:
        # no kernel of the repo, as in the JAX package (0 K1-K4 a step)
        new_arms = ("perceiver",) + tuple(accuracy_gate.STACKED_ARMS)
        res, _, _ = run(f"accuracy_gate {', '.join(new_arms)} (1 epoch each)",
                  [(0, 0, 0, 0)] * len(new_arms), accuracy_gate.main, list(new_arms), out=root,
                  device=DEVICE, epochs=dict.fromkeys(new_arms, 1),
                  length=QT_BATCHES["accuracy_gate"])
        _same_rows(res, "accuracy_results.json", metnet_rows + new_arms)
        print("  " + ", ".join(f"{a} {res[a]['train_seconds']:.1f} s (MSE {res[a]['mse']:.5f})"
                               for a in new_arms), flush=True)

        # gan_gate: CloudGAN's ConvLSTM generator (a round: the D step's
        # sample and the G step's forward through K1, its backward through K2)
        per_forward = 2 * frames + 2 * gan_gate.STEPS
        res, _, _ = run("gan_gate cloudgan, pix2pix, dgmr (1 epoch each, a 2-step fine-tune)",
                  [(2 * per_forward, per_forward, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0)],
                  gan_gate.main, None, out=root, device=DEVICE,
                  epochs={"cloudgan": 1, "pix2pix": 1, "dgmr": 1}, finetune_steps=2,
                  length=QT_BATCHES["gan_gate"])
        _same_rows(res, "gan_results.json")
        print("  " + ", ".join(f"{k} MSE {res[k]['mse']:.5f}" for k in (
            "persistence", "optical_flow", "cloudgan", "pix2pix", "dgmr")), flush=True)

        # gan_128: DGMR at nowcasting_gan.yaml's widths, 128², b4, split steps;
        # the trained row records its fit's launches, the fine-tuned row the rest
        res, _, _ = run("gan_128 (1 epoch, a 2-step fine-tune)", [(0, 0, 0, 0)], gan_128.main,
                  1, finetune_steps=2, finetune_every=2, out=root, device=DEVICE,
                  length=QT_BATCHES["gan_128"], trained_rows=["dgmr@128px"],
                  rest_row="dgmr_crps_finetuned@128px")
        _same_rows(res, "gan_128.json")
        if not os.path.exists(os.path.join(root, "gan128_state.pt")):
            fail("phase 28h: gan_128 wrote no state file")

        # horizon_gate, every arm: the 48-step ConvLSTM (K1 / K2, float32) and
        # MetNet (K3 / K4) among them; each trained row records its fit's launches
        per_forward = 2 * frames + 2 * horizon_gate.STEPS
        conv = (2 * per_forward, per_forward, 0, 0)
        none = (0, 0, 0, 0)
        arms = [a for a in horizon_gate.ALL_ARMS if a != "dgmr_stoch"]
        res, _, _ = run("horizon_gate, every arm but dgmr_stoch (1 epoch each)",
                  [conv, conv, none, none, metnet_step, metnet_step, none, none],
                  horizon_gate.main, arms, out=root, device=DEVICE, epochs=1,
                  length=QT_BATCHES["horizon_gate"], trained_rows=[
                      "convlstm", "convlstm@stoch", "unet", "unet@stoch", "metnet",
                      "metnet@stoch", "perceiver", "perceiver@stoch"])
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                               "horizon_results.json")) as f:
            _same_rows(res, "horizon_results.json", [r for r in json.load(f)
                                                     if r != "dgmr_mean@stoch"])
        # horizon_gate --arms dgmr_stoch, the arm alone as its card run goes: the
        # fit validates no epoch (no val/ metric logged), the row says so
        res, _, trainers = run("horizon_gate dgmr_stoch (1 epoch, no validation)", [none],
                               horizon_gate.main, ["dgmr_stoch"], out=root, device=DEVICE,
                               epochs=1, length=QT_BATCHES["horizon_gate"],
                               trained_rows=["dgmr_mean@stoch"])
        _same_rows(res, "horizon_results.json")
        logged = sorted(k for k in trainers[0].callback_metrics if k.startswith("val/"))
        if res["dgmr_mean@stoch"].get("validation") != "none" or logged:
            fail(f"phase 28h: dgmr_stoch validated ({logged}; the row says "
                 f"{res['dgmr_mean@stoch'].get('validation')!r})")
        written = sorted(os.listdir(root))
        want = sorted(["accuracy_256.json", "accuracy_256.md", "accuracy_results.json",
                       "accuracy_results.md", "gan_results.json", "gan_results.md",
                       "gan_128.json", "gan_128.md", "gan128_state.pt",
                       "horizon_results.json", "horizon_results.md"])
        if written != want:
            fail(f"phase 28h: the tools wrote {written} under --out, expected {want}")
        for name in written:
            if name.endswith(".json"):
                with open(os.path.join(root, name)) as f:
                    if json.load(f).get("card") != card:
                        fail(f"phase 28h: {name} does not name the card {card!r}")

    # gan_gate --arms dgmr --init: DGMR from the JAX Trainer's initial
    # variables (the committed .npz), every parameter and buffer held to the
    # converter's output of the file as the fit starts (the converter itself is
    # held to JAX by the CPU tests); the rows under @jax_init with its sha256
    from satflow_tpu_torch.interop.jax_weights import gan_state_dict_from_flax, read_gan_npz

    init = os.path.join(os.path.dirname(os.path.abspath(__file__)), "satflow_tpu_torch",
                        "tools", "results", "dgmr_jax_init.npz")
    want_sd = gan_state_dict_from_flax(*read_gan_npz(init))
    held = []

    def hold_init(model):
        got = model.state_dict()
        if set(got) != set(want_sd):
            fail(f"phase 28h: --init left {sorted(set(want_sd) ^ set(got))[:5]} unmatched")
        off = [k for k, v in got.items() if not torch.equal(v.detach().cpu(), want_sd[k])]
        if off:
            fail(f"phase 28h: --init: {len(off)} tensors differ from the converted file, {off[:5]}")
        held.append(len(got))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_init_") as root:
        res, _, _ = run("gan_gate dgmr --init (1 epoch, a 2-step fine-tune)", [(0, 0, 0, 0)],
                        gan_gate.main, ["dgmr"], out=root, device=DEVICE, epochs={"dgmr": 1},
                        finetune_steps=2, length=2, init=init, before_fit=hold_init)
    with open(init, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                           "gan_results.json")) as f:
        jax_rows = json.load(f)
    for row in ("dgmr", "dgmr_crps_selected", "dgmr_crps_finetuned"):
        got = res.get(row + "@jax_init")
        if got is None or got.get("init_sha256") != sha or not set(jax_rows[row]) <= set(got):
            fail(f"phase 28h: --init's {row}@jax_init row is {sorted(got or {})}")
        if row in res:
            fail(f"phase 28h: --init wrote the port-draw row {row}")
    if len(held) != 1:
        fail(f"phase 28h: --init's run made {len(held)} fits, expected 1")
    print(f"  --init: {held[0]} tensors equal to the converted file's as the fit started; rows "
          f"dgmr@jax_init MSE {res['dgmr@jax_init']['mse']:.5f}, fine-tuned fair CRPS "
          f"{res['dgmr_crps_finetuned@jax_init']['crps_fair_m8']:.5f} (sha256 {sha[:12]})",
          flush=True)

    print(f"quality tools phase: {time.perf_counter() - t_phase:.1f} s; launches K1 {totals[0]}, "
          f"K2 {totals[1]}, K3 {totals[2]}, K4 {totals[3]} [{card}]", flush=True)
    return tuple(totals)



# Phase 28i: the bench tools (satflow_tpu_torch/tools/{bench,bench_int8,
# bench_axial,bench_zoo,bench_serve,bench_train,exp_train_ceiling}.py), each
# main once at full width with few iterations. Each expected line: the
# kernels that must launch and how often an iteration (every other id 0).
BT_FORWARD = {"K1": LAUNCHES_PER_FORWARD}
BT_TRAIN = {"K1": LAUNCHES_PER_FORWARD, "K2": LAUNCHES_PER_FORWARD}  # no remat
BT_REMAT = {"K1": K1_PER_TRAIN_STEP, "K2": K2_PER_TRAIN_STEP}  # remat per step or by chunk
BT_METNET = {"K3": 7, "K4": MN_K4_PER_FORWARD}
BT_STORE_BATCHES = 3


def bench_tools_slice(torch, card):
    """Phase 28i; returns the phase's launches by kernel id (K1-K6b)."""
    import tempfile

    from satflow_tpu_torch.data import native_ingest
    from satflow_tpu_torch.serve import InferenceSession, MicroBatcher
    from satflow_tpu_torch.tools import (
        bench,
        bench_axial,
        bench_int8,
        bench_serve,
        bench_train,
        bench_zoo,
        benchkit,
        exp_train_ceiling,
    )

    counters = benchkit.counters()
    totals = dict.fromkeys(counters, 0)
    t_phase = time.perf_counter()

    def finite(v) -> bool:
        if isinstance(v, dict):
            return all(finite(u) for u in v.values())
        return not isinstance(v, float) or bool(np.isfinite(v))

    def run(what, tool, argv, want, env=None):
        """``tool.main(argv)`` under ``env``, its stdout kept; every JSON line
        finite and naming the card, its kernel_launches those of ``want`` (one
        dict a line; the ceiling's one per rung), every other kernel 0."""
        for c in counters.values():
            c.launches = 0
        old = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                tool.main(argv)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        wall = time.perf_counter() - t0
        for k, c in counters.items():
            totals[k] += c.launches
        lines = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
        if len(lines) != len(want):
            fail(f"phase 28i {what}: {len(lines)} JSON lines, expected {len(want)}")
        for rec, w in zip(lines, want):
            if rec.get("card") != card or not finite(rec):
                fail(f"phase 28i {what}: card {rec.get('card')!r} or a value not finite: {rec}")
            got = rec["kernel_launches"]
            # the ceiling's line has one count a rung
            per_rung = all(isinstance(v, dict) for v in got.values())
            for g, ww in ([(got[k], w[k]) for k in w] if per_rung else [(got, w)]):
                if g != {**dict.fromkeys(counters, 0), **ww}:
                    fail(f"phase 28i {what}: kernel_launches {g}, expected {ww} an iteration")
        shown = [{k: v for k, v in r.items() if k not in ("card", "kernel_launches")}
                 for r in lines]
        print(f"{what}: {wall:.1f} s wall; " + "; ".join(json.dumps(r) for r in shown)
              + f"; launches an iteration as expected [{card}]", flush=True)
        return lines

    run("bench (fused, b8, 2 chained rollouts)", bench, ["--iters", "2"], [BT_FORWARD],
        {"BENCH_BATCH": str(B)})
    run("bench (cmajor, b8, 2 chained rollouts)", bench, ["--iters", "2"],
        [{"K1": 2 * T, "K6a": 2 * STEPS, "K6b": STEPS}],
        {"BENCH_BATCH": str(B), "BENCH_CELL_IMPL": "cmajor"})
    run("bench_int8 (b8, 2 chained rollouts an arm)", bench_int8,
        ["--batch", str(B), "--iters", "2"], [BT_FORWARD, {"K5": LAUNCHES_PER_FORWARD}])
    run("bench_axial (the six shapes, 5 chained calls)", bench_axial, ["--iters", "5"],
        [{"K4": 1}] * len(bench_axial.SHAPES))
    run("bench_zoo (1 iteration a model)", bench_zoo, ["--iters", "1"], [BT_METNET, {}, {}, {}])

    # the batcher under 16 clients: one reply held against the session's
    # single-request reply of the same sample (the same padded b8 forward)
    replies = {"batcher": [], "session": []}
    submit, predict = MicroBatcher.submit, InferenceSession.predict

    def kept_submit(self, x, timeout=None):
        y = submit(self, x, timeout)
        replies["batcher"].append(y)
        return y

    def kept_predict(self, x):
        y = predict(self, x)
        if np.asarray(x).ndim == 4:
            replies["session"].append(y)
        return y

    MicroBatcher.submit, InferenceSession.predict = kept_submit, kept_predict
    try:
        run("bench_serve (16 clients x 2 requests)", bench_serve,
            ["--clients", "16", "--requests", "32"], [BT_FORWARD])
    finally:
        MicroBatcher.submit, InferenceSession.predict = submit, predict
    if len(replies["batcher"]) != 32 or not replies["session"]:
        fail(f"phase 28i bench_serve: {len(replies['batcher'])} batcher replies, "
             f"{len(replies['session'])} session replies")
    err = max(float(np.abs(r - replies["session"][0]).max()) for r in replies["batcher"])
    if not err <= TOL_ROLLOUT:
        fail(f"phase 28i bench_serve: a batcher reply vs the session's: max|diff| {err:.3g} > "
             f"{TOL_ROLLOUT}")
    print(f"  the 32 batcher replies vs the session's single-request reply: max|diff| "
          f"{err:.3g} <= {TOL_ROLLOUT} ok", flush=True)

    run("bench_train (64 px b32, 2 chained steps)", bench_train, ["--iters", "2"], [BT_TRAIN])
    run("bench_train (256 px b8, remat chunk 6, 1 chained step)", bench_train,
        ["--size", "256", "--batch", "8", "--remat", "--remat-chunk", "6", "--iters", "1"],
        [BT_REMAT])
    run("bench_train --model metnet (1 chained step)", bench_train,
        ["--model", "metnet", "--iters", "1"], [BT_METNET])
    run("bench_train --model perceiver (1 chained step)", bench_train,
        ["--model", "perceiver", "--iters", "1"], [{}])
    for mode in ("fused", "split"):
        run(f"bench_train --model dgmr --gan-step {mode} (1 chained round)", bench_train,
            ["--model", "dgmr", "--gan-step", mode, "--iters", "1"], [{}])

    # the store-fed step reads the store through the native ingest library
    # (built here with make -C native), counted batch by batch
    native = {"batches": 0}
    loader_iter = native_ingest.NativeSfbLoader.__iter__

    def counted_iter(self):
        for batch in loader_iter(self):
            native["batches"] += 1
            yield batch

    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as store:
        store_args = ["--from-store", store, "--batch", str(B), "--store-batches",
                      str(BT_STORE_BATCHES), "--workers", "2"]
        native_ingest.NativeSfbLoader.__iter__ = counted_iter
        try:
            run("bench_train --from-store (64 px b8, 3 epochs)", bench_train, store_args,
                [BT_TRAIN])
            fed = native["batches"]
            run("bench_train --from-store --pipeline-only (3 passes)", bench_train,
                store_args + ["--pipeline-only"], [{}])
        finally:
            native_ingest.NativeSfbLoader.__iter__ = loader_iter
    # at least: the store-fed run's warm batch and 3 epochs; the pipeline-only
    # run's warm pass and 3 more (a loader left after one batch reads ahead)
    n = BT_STORE_BATCHES
    if fed < 3 * n + 1 or native["batches"] - fed < 4 * n:
        fail(f"phase 28i: the native loader delivered {fed} and {native['batches'] - fed} "
             f"batches, expected at least {3 * n + 1} and {4 * n}")
    print(f"  the store-fed step read its {fed} batches through the native ingest library "
          f"(and the pipeline-only run its {native['batches'] - fed})", flush=True)

    run("exp_train_ceiling (64 px b32, 2 chained iterations a rung)", exp_train_ceiling,
        ["--iters", "2"], [{"fwd": BT_FORWARD, "fwd+bwd": BT_REMAT, "step": BT_REMAT,
                            "opt": {}}])
    print(f"bench tools phase: {time.perf_counter() - t_phase:.1f} s; launches "
          + ", ".join(f"{k} {v}" for k, v in totals.items()) + f" [{card}]", flush=True)
    return totals


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    try:
        from satflow_tpu_torch.ops import _build
        from satflow_tpu_torch.ops import fused_convlstm_step as P
        from satflow_tpu_torch.ops.fused_convlstm_step import (
            fused_convlstm_step,
            fused_convlstm_step_ref,
            gate_bwd,
            gate_bwd_ref,
        )
    except ImportError as e:
        fail(f"satflow_tpu_torch is not importable beside this script: {e}")

    t_start = time.perf_counter()

    def phase_done(name: str) -> None:
        """The run's wall seconds so far, after each phase: where its time goes."""
        print(f"[{time.perf_counter() - t_start:.1f} s] {name} done", flush=True)

    # phase 1
    card = card_line()
    print(f"card (name, power limit): {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 2
    t0 = time.perf_counter()
    _build.load_all(["fused_convlstm_step", "fused_convlstm_step_bwd", "fused_lstm_gates",
                     "axial_attention", "fused_convlstm_int8", "cmajor_convlstm",
                     "fused_convlstm_step_halo", "exp_tap9", "exp_cmajor"])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall, nvcc in parallel ("
          + ", ".join(f"{k} {v:.2f} s" for k, v in _build.build_seconds.items())
          + (")" if _build.build_seconds else "already built)"), flush=True)
    for name, log in _build.build_logs.items():
        dtype = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:  # the mangled name carries the type
                dtype = ("int8 sums" if "int8_sums" in line
                         else "bf16" if "bfloat16" in line or "_mma_kernel" in line else "f32")
                width = re.search(r"kernelI\w*?Li(\d+)E", line)  # and the hidden width
                dtype += f", Ch={width.group(1)}" if width else ""
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name} ({dtype}): {line.strip()}", flush=True)

    hmma = check_sass(_build, card)
    print("HMMA instructions in the bf16 instantiations: " + ", ".join(
        f"{what} {sum(n for (lib, _), n in hmma.items() if lib == name)} "
        f"({hmma[name, HIDDEN]} at Ch={HIDDEN})"
        for what, name in (("K1", "fused_convlstm_step"), ("K2", "fused_convlstm_step_bwd"),
                           ("K1h", "fused_convlstm_step_halo"), ("K6a", "cmajor_convlstm"))),
          flush=True)
    hmma_new = check_sass_redesign(_build, card)
    print(f"HMMA instructions in K4's tensor-core kernel (all D buckets): "
          f"{hmma_new['axial_attention']}, in the bf16 K6b: {hmma_new['cmajor_convlstm']}",
          flush=True)
    mma_k5_t3 = check_sass_int8_t3(_build, card)
    print(f"IMMA instructions in every K5 instantiation ({mma_k5_t3['K5', 'bf16', HIDDEN]} in the "
          f"bf16-c step at Ch={HIDDEN}); HMMA in T3's bf16 kernel "
          f"({mma_k5_t3['T3', 'bf16', HIDDEN]} at C={HIDDEN}) and none in its float32 one",
          flush=True)
    hmma_tap9 = check_sass_tap9(_build, card)
    print("HMMA instructions in the bf16 T1, T2 and K1p at Ch 8-128: "
          + ", ".join(f"{ch}: {hmma_tap9['T1', ch]}" for ch in (8, 16, 32, 64, 128))
          + " each (T2 = K1p = T1 at every width); none in their float32 kernels", flush=True)
    phase_done("phases 1-2 (build, SASS)")

    # phases 3-5: each kernel against its plain version
    k1_err = check_kernel(torch, fused_convlstm_step, fused_convlstm_step_ref, card)
    k2_err = check_gate_bwd(torch, gate_bwd, gate_bwd_ref, card)
    check_function_grads(torch, fused_convlstm_step, fused_convlstm_step_ref, card)
    check_widths(torch, P, card)
    phase_done("phases 3-5 (K1, K2 checks)")
    # phase 6: serving (counts set to 0 inside, just before the requests)
    serve_k1, _, _, model = serve_slice(torch, card)
    # phase 7
    per_call, per_call_bwd = timings(torch, fused_convlstm_step, fused_convlstm_step_ref,
                                     gate_bwd, gate_bwd_ref, model, card)
    # phase 8: training (counts set to 0 inside, just before fit)
    train_k1, train_k2, _, _ = train_slice(torch, card)
    phase_done("phases 6-8 (ConvLSTM serving, timings, training)")

    # phase 9: K3 and K4 against their plain versions
    k3_err = check_gate_tail(torch, card)
    k4_err = check_attention(torch, card)
    # phase 10: MetNet serving (counts set to 0 inside, just before the requests)
    serve_k3, serve_k4, mn_model = metnet_serve_slice(torch, card)
    # phase 11
    k3_ms, k4_ms = metnet_timings(torch, mn_model, card)
    del mn_model
    # phase 12: MetNet training (counts set to 0 inside, just before fit)
    train_k3, train_k4 = metnet_train_slice(torch, card)
    phase_done("phases 9-12 (K3, K4, MetNet)")

    # phase 13: K5, K6a and K6b against their plain versions
    k5_err = check_int8_kernel(torch, card)
    k5_err = max(k5_err, check_int8_widths(torch, card))
    k6a_err, k6b_err = check_cmajor_kernels(torch, card)
    # phases 14-15: int8 and channel-major serving (counts set to 0 just before the requests)
    serve_k5, qparams = int8_serve_slice(torch, card)
    (cm_k1, serve_k6a, serve_k6b), cmajor_model = cmajor_serve_slice(torch, card, model)
    # phase 15b: both at hidden 32 (counts set to 0 inside, just before the requests)
    (cm32_k1, cm32_k6a, cm32_k6b), int8_32_k5 = small_width_paths(torch, card)
    # phase 16
    serving = serving_timings(torch, model, cmajor_model, qparams, card)
    phase_done("phases 13-16 (K5, K6a, K6b, int8 and cmajor serving)")

    # phase 17: K1h, T1, T2 and T3 against their plain versions
    k1h_err = check_halo_kernel(torch, card)
    t1_err, t2_err, k1p_err = check_study_steps(torch, card)
    t3_err = check_exp_cmajor(torch, card)
    widths_err = check_halo_cmajor_widths(torch, card)
    k1h_err, k6a_err = max(k1h_err, widths_err["K1h"]), max(k6a_err, widths_err["K6a"])
    check_study_widths(torch, card)
    phase_done("phase 17 (K1h, T1-T3 checks, widths)")
    # phases 18-20 (counts set to 0 inside, just before each path is driven)
    halo_serve, halo_train_k1h, halo_train_k2 = halo_path(torch, card, model)
    (st_k1, st_k1p, st_t1, st_t2, st_k6a, st_t3), _ = study_tools(torch, card)
    cells_k3, cells_train_k3, cell_models, *split_train = cells_path(torch, card)
    # phase 21
    study = new_kernel_timings(torch, model, cell_models, split_train, card)
    phase_done("phases 18-21 (halo path, study tools, cells, timings)")

    # phase 22 (counts set to 0 inside, just before each path is driven)
    widths_k1, widths_k2 = widths_path(torch, card)
    # phase 22b: hidden widths that are zero-padded to a built one
    padded_k1, padded_k2 = widths_path(torch, card, PADDED_PATHS)
    padded_widths(torch, card)
    phase_done("phase 22 (hidden widths)")

    # phase 23: eval of the full-width ConvLSTM (counts set to 0 inside, just before it)
    eval_k1, _ = eval_slice(torch, card)
    phase_done("phase 23 (eval of the full-width ConvLSTM)")
    # phase 24: metnet_ssim training (counts set to 0 inside, just before fit)
    ssim_k3, ssim_k4, _ = metnet_ssim_slice(torch, card)
    phase_done("phase 24 (metnet_ssim training)")
    # phase 25: the accuracy gate (counts set to 0 inside, just before each arm)
    gate_k1, gate_k2, _ = gate_slice(torch, card)
    phase_done("phase 25 (accuracy gate)")
    # phases 26-28 (counts set to 0 inside, just before each path is driven)
    life_k1, life_k2 = lifecycle_slice(torch, card)
    phase_done("phase 26 (ConvLSTM lifecycle: default config, resume, local: serving, eval)")
    prof_k1, prof_k2, life_k3, life_k4 = metnet_resume_and_profile(torch, card)
    phase_done("phase 27 (MetNet resume, the profiler)")
    pre_k1, pre_k2 = preemption_and_tuning(torch, card)
    phase_done("phase 28 (preemption, scale_batch_size, tune)")
    # phases 28a-28d: the zoo, export, the example (counts set to 0 inside)
    zoo_serve_slice(torch, card)
    phase_done("phase 28a (the zoo served)")
    zoo_train_slice(torch, card)
    phase_done("phase 28b (the zoo trained, experiment=unet_simple)")
    exp_k1, exp_k1h, exp_k3, exp_k4, exp_k6a, exp_k6b = export_slice(torch, card)
    phase_done("phase 28c (export of the fused, halo and cmajor ConvLSTM, MetNet, UNet)")
    ex_k3, ex_k4 = example_slice(torch, card)
    phase_done("phase 28d (examples/metnet_example.py)")
    # phase 28e: the Perceiver family (counts set to 0 inside; it launches none)
    perceiver_slice(torch, card)
    phase_done("phase 28e (the Perceiver family)")
    # phase 28f: the GAN family (counts set to 0 inside, just before each path)
    _, gan_k1, gan_k2 = gan_slice(torch, card)
    phase_done("phase 28f (the GAN family)")
    # phase 28g: the parallel paths (counts set to 0 inside, just before each path)
    check_halo_blocks(torch, card)
    par = parallel_slice(torch, card)
    phase_done("phase 28g (the parallel paths)")
    # phase 28h: the quality studies' tools (counts set to 0 inside, just before each tool)
    qt_k1, qt_k2, qt_k3, qt_k4 = quality_tools_slice(torch, card)
    phase_done("phase 28h (the quality studies' tools)")
    # phase 28i: the bench tools (counts set to 0 inside, just before each tool)
    bt = bench_tools_slice(torch, card)
    phase_done("phase 28i (the bench tools)")
    life_k1 += prof_k1 + pre_k1
    life_k2 += prof_k2 + pre_k2

    # phase 29
    def kernel(name, source, replaces, launches, err, t, library=None):
        return {"name": name, "route": "cuda", "source": f"satflow_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": library}

    k4_t = k4_ms[K4_SHAPES[0]]
    print(json.dumps({"kernels": [
        # K1: bf16 serving + training + the channel-major rollout's encoder +
        # the yardstick of the tap9 study tool + the hidden 16, 32, 24 and 12
        # models + eval + the accuracy gate's training and eval + the
        # lifecycle phases (train, resume, local: serving, eval, profile,
        # preemption, probes) + CloudGAN's ConvLSTM generator (phase 28f) + the
        # parallel fits and the mesh session (phase 28g) + the study tools (28h)
        kernel("fused_convlstm_step", "fused_convlstm_step.cu",
               "satflow_tpu/ops/pallas/fused_convlstm_step.py:453",
               serve_k1 + train_k1 + cm_k1 + cm32_k1 + st_k1 + widths_k1 + padded_k1 + eval_k1
               + gate_k1 + life_k1 + exp_k1 + gan_k1 + par["K1"] + qt_k1 + bt["K1"], k1_err,
               per_call[HIDDEN]),
        # the TPU's unpadded sibling of K1: the port's K1 is that kernel (its
        # tensors are unpadded NHWC), so this row repeats K1's numbers
        kernel("fused_convlstm_step (unpadded NHWC)", "fused_convlstm_step.cu",
               "satflow_tpu/ops/pallas/fused_convlstm_step.py:380",
               serve_k1 + train_k1 + cm_k1 + cm32_k1 + st_k1 + widths_k1 + padded_k1 + eval_k1
               + gate_k1 + life_k1 + exp_k1 + gan_k1 + par["K1"] + qt_k1 + bt["K1"], k1_err,
               per_call[HIDDEN]),
        kernel("fused_convlstm_step_halo", "fused_convlstm_step_halo.cu",
               "satflow_tpu/ops/pallas/fused_convlstm_step.py:266",
               halo_serve + halo_train_k1h + exp_k1h + bt["K1h"], k1h_err, study["K1h"]),
        kernel("gate_bwd", "fused_convlstm_step_bwd.cu",
               "satflow_tpu/ops/pallas/fused_convlstm_step.py:833",
               train_k2 + halo_train_k2 + widths_k2 + padded_k2 + gate_k2 + life_k2 + gan_k2
               + par["K2"] + qt_k2 + bt["K2"],
               k2_err,
               per_call_bwd[HIDDEN]),
        kernel("fused_lstm_gates", "fused_lstm_gates.cu",
               "satflow_tpu/ops/pallas/fused_lstm.py:75",
               # MetNet serving + training (mse and ssim) + its resume, the
               # concat/split/hybrid cells
               serve_k3 + train_k3 + ssim_k3 + life_k3 + sum(cells_k3.values())
               + cells_train_k3 + exp_k3 + ex_k3 + par["K3"] + qt_k3 + bt["K3"], k3_err, k3_ms,
               library=k3_ms["library"]),
        kernel("axial_attention", "axial_attention.cu",
               "satflow_tpu/ops/pallas/axial_attention.py:60",
               serve_k4 + train_k4 + ssim_k4 + life_k4 + exp_k4 + ex_k4 + par["K4"] + qt_k4
               + bt["K4"], k4_err,
               k4_t,
               library=k4_t["library"]),
        kernel("fused_convlstm_step_int8", "fused_convlstm_int8.cu",
               "satflow_tpu/ops/pallas/fused_convlstm_int8.py:172",
               serve_k5 + int8_32_k5 + bt["K5"], k5_err, serving[f"K5.{HIDDEN}"]),
        kernel("cmajor_convlstm_step", "cmajor_convlstm.cu",
               "satflow_tpu/ops/pallas/cmajor_convlstm.py:232",
               # + the hidden-32 path and the cmajor study's yardstick
               serve_k6a + cm32_k6a + st_k6a + exp_k6a + bt["K6a"], k6a_err, serving["K6a"]),
        kernel("cmajor_conv3x3", "cmajor_convlstm.cu",
               "satflow_tpu/ops/pallas/cmajor_convlstm.py:257",
               serve_k6b + cm32_k6b + exp_k6b + bt["K6b"], k6b_err, serving["K6b"],
               library=serving["K6b"]["library"]),
        # K1 once more, in the W-padded layout of the TPU kernel it replaces: the
        # tap9 study tool's yardstick
        kernel("step_padded", "exp_tap9.cu",
               "satflow_tpu/ops/pallas/fused_convlstm_step.py:453", st_k1p, k1p_err,
               study["K1p"]),
        kernel("step_tap9", "exp_tap9.cu", "tools/exp_tap9.py:85", st_t1, t1_err, study["T1"]),
        # max_abs_err of T2 is relative to max|plain|: its outputs are unbounded sums
        kernel("step_nogate", "exp_tap9.cu", "tools/exp_tap9.py:260", st_t2, t2_err, study["T2"]),
        kernel("cmajor_step", "exp_cmajor.cu", "tools/exp_cmajor.py:154", st_t3, t3_err,
               study["T3"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
